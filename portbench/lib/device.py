"""The card a run uses, and the guard against JAX in the process."""

from __future__ import annotations

import subprocess
import sys

# Top-level module names that may not be loaded by the end of a run: JAX
# and the JAX package the port was made from (compared as whole names:
# ``bnpc_tpu_torch`` is not ``bnpc_tpu``).
FORBIDDEN = ("jax", "jaxlib", "flax", "bnpc_tpu")


def forbidden_modules() -> list[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def require_cards(chips: int) -> None:
    """Exit with code 2, printing no result, unless CUDA sees `chips`
    cards. The benchmark never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is false; the benchmark "
              "runs on a CUDA card only", file=sys.stderr)
        sys.exit(2)
    if torch.cuda.device_count() < chips:
        print(f"portbench: the cell asks for {chips} cards, CUDA sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        sys.exit(2)


def power_limit_w() -> float | None:
    """The first card's power limit in watts, as nvidia-smi reports it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def describe(device, chips: int) -> dict:
    """The result line's ``device``: platform, kind, count, peak memory and
    the power limit."""
    import torch

    if str(device).startswith("cuda"):
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0)),
                "power_limit_w": power_limit_w()}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": 0, "power_limit_w": None}
