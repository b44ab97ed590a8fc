"""Mutation-axis sharding context (counterpart of bnpc_tpu/parallel/axis.py).

The mutation axis m appears in every likelihood term only inside sums that
are independent across mutations (libs/CRP.py:197-204), so a rank can hold
an m / M slice of the data planes and parameter columns: its partial sums
are combined with one all-reduce over the ranks of its mutation group, and
every scalar MCMC decision (categorical draws, MH accepts) is computed
identically on each rank from the replicated draws.

Every move takes a :class:`MutAxis` (default: unsharded, a no-op):

  * ``psum``      — all-reduce (SUM) over the mutation group of a value
                    already reduced over this rank's mutation slice;
  * ``fold_key``  — this rank's own per-mutation draws (proposal std-devs,
                    truncnorm proposals, Beta rows): ``draws.fold_axis``,
                    a stream of its own that leaves the replicated one
                    untouched, so scalar draws stay equal on every rank;
  * ``mask``      — zero-weights padded mutation columns (m padded up to a
                    multiple of the shard count) in prior sums, MH
                    transition probabilities and telemetry counts.

The module counts its all-reduces (``all_reduces``, ``all_reduce_bytes``);
with ``timed`` set it also sums their host seconds, synchronizing the
device before and after each one (``all_reduce_seconds``).
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

# All-reduces issued by MutAxis.psum since the last reset, their payload
# bytes, and, while `timed` is set, their seconds (device synchronized
# before and after each one).
all_reduces = 0
all_reduce_bytes = 0
all_reduce_seconds = 0.0
timed = False


def reset_counters() -> None:
    global all_reduces, all_reduce_bytes, all_reduce_seconds
    all_reduces, all_reduce_bytes, all_reduce_seconds = 0, 0, 0.0


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: the SUM of `x` over the ranks of `group` (gloo takes
    CUDA tensors as well as host ones)."""
    global all_reduces, all_reduce_bytes, all_reduce_seconds
    all_reduces += 1
    all_reduce_bytes += x.numel() * x.element_size()
    y = x.reshape(-1).clone()
    if timed and y.is_cuda:
        torch.cuda.synchronize(y.device)
    t0 = time.perf_counter()
    dist.all_reduce(y, group=group)
    if timed:
        if y.is_cuda:
            torch.cuda.synchronize(y.device)
        all_reduce_seconds += time.perf_counter() - t0
    return y.reshape(x.shape)


@dataclasses.dataclass(frozen=True, eq=False)
class MutAxis:
    group: object = None  # the mutation group (a ProcessGroup), or None
    index: int = 0        # this rank's index in the group
    size: int = 1         # ranks in the group
    mask: torch.Tensor | None = None  # [m_local] f32, 1 = real column

    def psum(self, x):
        if self.group is None:
            return x
        return all_reduce(x, self.group)

    def fold_key(self, draws):
        if self.group is None:
            return draws
        return draws.fold_axis(self.index)

    def apply_mask(self, x):
        if self.mask is None:
            return x
        return x * self.mask

    @property
    def sharded(self) -> bool:
        return self.group is not None
