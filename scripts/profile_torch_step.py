#!/usr/bin/env python3
"""Where the time goes in the port's main path on one CUDA device.

    python3 scripts/profile_torch_step.py [--cell main|large] [--warmup 256]
                                          [--steps 256] [--profiled 64]

Runs one cell of chip_smoke.py: "main", the bench cell (5,000 x 200, k_max
256), or "large", the large-n cell (131,072 x 200, k_max 128, the
streaming sweep); learned errors, full move mixture, `--warmup` steps
first. Then prints:
  * per-step wall time by move kind (Gibbs / split / merge), each step
    ending in torch.cuda.synchronize();
  * a torch.profiler window: wall time, device self time and the device's
    busy share, each hand-written kernel's device time and share, and the
    top operators by device and by host time.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from bnpc_tpu_torch.data import pack_data  # noqa: E402
from bnpc_tpu_torch.draws import TorchDraws  # noqa: E402
from bnpc_tpu_torch.mcmc import MCMCRunner  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", choices=("main", "large"), default="main")
    ap.add_argument("--warmup", type=int, default=256)
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--profiled", type=int, default=64)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step: no CUDA device")
    dev = "cuda"
    print(chip_smoke.nvidia_smi())
    if args.cell == "main":
        data, _ = chip_smoke.make_data(chip_smoke.N, chip_smoke.M, 10, 0.1)
        cfg, mc = chip_smoke.bench_configs()
    else:
        data, _ = chip_smoke.make_data(chip_smoke.N_LARGE, chip_smoke.M, 20,
                                       0.1)
        cfg, mc = chip_smoke.bench_configs(chip_smoke.N_LARGE,
                                           chip_smoke.K_LARGE)
    print(f"cell {args.cell}: {cfg.n_cells} x {cfg.n_muts}, k_max "
          f"{cfg.k_max}")
    runner = MCMCRunner(cfg, mc, pack_data(data, dev), device=dev)
    state = runner.init_chains(TorchDraws(0, dev))[0]
    draws = TorchDraws(1, dev)
    state, _, draws = runner.run_block(state, draws, args.warmup)
    torch.cuda.synchronize()

    step = runner._step
    kinds = {"gibbs": [], "split": [], "merge": []}
    for _ in range(args.steps):
        t0 = time.perf_counter()
        state, row = step(state, draws)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        c = row.mh_counts.cpu().numpy()
        kinds["split" if c[1].sum() else
              "merge" if c[2].sum() else "gibbs"].append(ms)
    for kind, ms in kinds.items():
        if ms:
            print(f"{kind}: {len(ms)} steps, median {np.median(ms):.3f} ms, "
                  f"p90 {np.percentile(ms, 90):.3f} ms")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.profiled):
            state, _ = step(state, draws)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages()
    # Kernel events only: operator rows repeat their kernels' device time.
    dev_ms = sum(e.self_device_time_total for e in table
                 if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    print(f"profiled {args.profiled} steps: wall {wall_ms:.1f} ms, device "
          f"self time {dev_ms:.1f} ms, busy share {dev_ms / wall_ms:.4f}")
    # The hand-written kernels by name, however small their share.
    for e in sorted(table, key=lambda e: -e.self_device_time_total):
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.key.startswith("void (anonymous namespace)::")):
            ms = e.self_device_time_total / 1e3
            print(f"  {e.key.split('::')[1].split('(')[0]}: {ms:.3f} ms, "
                  f"{ms / dev_ms:.4%} of device time, {e.count} launches of "
                  f"{ms / e.count:.4f} ms")
    print(table.table(sort_by="self_device_time_total", row_limit=20))
    print(table.table(sort_by="self_cpu_time_total", row_limit=20))


if __name__ == "__main__":
    main()
