"""Timing probes of the per-cell Gibbs chain on the card.

Counterparts of the JAX package's TPU probes ``benchmarks/vecflow_probe.py``
(``vecflow_probe``) and ``benchmarks/mosaic_while_probe.py``
(``while_probe``). Each module holds a CUDA kernel wrapper, its plain torch
twin and a ``main()`` that runs the probe on one CUDA device (``--device
cpu`` runs the twins only, and times nothing):

    python -m bnpc_tpu_torch.probes.vecflow_probe
    python -m bnpc_tpu_torch.probes.while_probe
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np


def parse_args(argv, doc: str) -> argparse.Namespace:
    """--device: cuda unless the caller asks for the CPU."""
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain twins, untimed)")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not args.device.startswith("cuda"):
        ap.error(f"--device {args.device}: expected cuda or cpu")
    return args


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of `fn` over `reps` runs, by CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))
