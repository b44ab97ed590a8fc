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

A batch of chains (mcmc.py's ``chain_exec="vmap"``) takes a
:class:`ChainAxis` in its place: the chain axis beside the mutation axis
``mut`` of every chain, to which it hands ``psum``, ``fold_key`` and the
mask. Both axes share the float sums and products of a step (``sum``,
``rmul``): on one chain they are the plain torch calls; over a chain axis
they run chain by chain, each the very call of the one-chain step on that
chain's slice, so a batched chain gets its one-chain run's bits (a
reduction or a cuBLAS product over a [C, ...] tensor may order its
additions otherwise).

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


class _Sums:
    """The float sums and products of a step on one chain (see the module
    docstring)."""

    def sum(self, x, dim=None):
        """Sum of `x` (over `dim` when given, a negative dim)."""
        return torch.sum(x) if dim is None else x.sum(dim=dim)

    def rmul(self, w, x):
        """``w @ x`` for a shared `w` (the data)."""
        return w @ x


@dataclasses.dataclass(frozen=True, eq=False)
class MutAxis(_Sums):
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

    @property
    def mut(self) -> MutAxis:
        """The mutation axis of one chain: this axis itself."""
        return self


def _own(x: torch.Tensor) -> torch.Tensor:
    """`x`, or a copy where its address is not aligned as a fresh tensor's
    would be (16 bytes on CUDA, 64 on the CPU): a slice of a batch starts
    where its chain does, and a reduction or a BLAS product may take
    another path, and another order of additions, by the address."""
    return x.clone() if x.data_ptr() % (16 if x.is_cuda else 64) else x


@dataclasses.dataclass(frozen=True, eq=False)
class ChainAxis(_Sums):
    """The chain axis of a batched step: every tensor of the step's state
    has a leading axis of `chains` chains, each chain on the mutation axis
    `mut`. Its sums and products are taken chain by chain (module
    docstring)."""

    chains: int = 1
    mut: MutAxis = MutAxis()

    def psum(self, x):
        return self.mut.psum(x)

    def fold_key(self, draws):
        return self.mut.fold_key(draws)

    def apply_mask(self, x):
        return self.mut.apply_mask(x)

    @property
    def mask(self):
        return self.mut.mask

    @property
    def sharded(self) -> bool:
        return self.mut.sharded

    def sum(self, x, dim=None):
        return torch.stack([_Sums.sum(self, _own(x[c]), dim)
                            for c in range(self.chains)])

    def rmul(self, w, x):
        return torch.stack([w @ _own(x[c]) for c in range(self.chains)])
