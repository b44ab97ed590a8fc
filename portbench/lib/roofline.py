"""Peaks of the card and the operations and bytes of the Gibbs kernels.

The counts are frozen copies of ``chip_smoke.py``'s (``bound`` and the byte
and operation counts beside kernel 1 in ``phase_lazy_segment``); the slot
width copies ``ops/cuda_gibbs.py``'s ``lazy_k_pad``. Peaks: NVIDIA's data sheet for the
H100 SXM at its full 700 W; the run's line states the card's power limit
beside every share.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Float operations the per-cell step spends on each slot: max(size, 0),
# log, subtract, add, the max reduction and the tie compare.
OPS_PER_SLOT = 6
SLOTS_PER_LANE = (1, 2, 4, 8, 16, 32)


def lazy_k_pad(k_max: int) -> int:
    """Kernel 1's slot width: 32 x a power of two >= k_max."""
    for spl in SLOTS_PER_LANE:
        if 32 * spl >= k_max:
            return 32 * spl
    raise ValueError(f"k_max={k_max} exceeds kernel 1's 1024 slots")


def least_seconds(bytes_moved: float, ops: float) -> float:
    """The least time the card could take: bytes over the HBM rate or
    float32 operations over the float32 peak, whichever is longer."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def lazy_segment_work(n: int, k_max: int, sweeps: int, launches: int):
    """(bytes, ops) of kernel 1 over `sweeps` exact sweeps in `launches`
    launches: every cell's Z row, aux, assign and perm entries in and its
    target out once a sweep; the sizes row in and out once a launch."""
    k_pad = lazy_k_pad(k_max)
    return (4 * sweeps * (n * k_pad + 4 * n) + 4 * launches * (2 * k_pad + 4),
            OPS_PER_SLOT * sweeps * n * k_pad)

