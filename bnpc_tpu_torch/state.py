"""Sampler state: fixed-capacity padded cluster bookkeeping
(counterpart of bnpc_tpu/state.py).

A cluster is a slot in [0, k_max):

  assignment[n]       int32, slot id per cell
  params[k_max, m]    float32, one genotype-parameter row per slot
  cluster_size[k_max] int32, 0 == free slot (rows of free slots are stale)
  dp_alpha, fp, fn    0-d float32 tensors

A batch of chains (mcmc.py's chain_exec="vmap") is one CRPState whose
fields carry a leading chain axis: assignment [C, n], params [C, k_max, m],
cluster_size [C, k_max], dp_alpha / fp / fn [C] (stack_states). The
helpers below take either form.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from bnpc_tpu_torch.config import TMAX, TMIN, ModelConfig
from bnpc_tpu_torch.data import PackedData
from bnpc_tpu_torch.draws import Draws
from bnpc_tpu_torch.ops import cuda_beta, randomx


class CRPState(NamedTuple):
    assignment: torch.Tensor     # [n] int32
    params: torch.Tensor         # [k_max, m] float32
    cluster_size: torch.Tensor   # [k_max] int32
    dp_alpha: torch.Tensor       # [] float32
    fp: torch.Tensor             # [] float32
    fn: torch.Tensor             # [] float32

    @property
    def live(self) -> torch.Tensor:
        """[k_max] bool — occupied slots."""
        return self.cluster_size > 0

    @property
    def n_clusters(self) -> torch.Tensor:
        return self.live.sum(-1).to(torch.int32)


def stack_states(states) -> CRPState:
    """One batched state from a list of one-chain states."""
    return CRPState(*(torch.stack(f) for f in zip(*states)))


def unstack_states(state: CRPState) -> list[CRPState]:
    """The one-chain states of a batched state (copies, not views)."""
    return [CRPState(*(f[c].clone() for f in state))
            for c in range(state.assignment.shape[0])]


def take_states(state: CRPState, idx: torch.Tensor) -> CRPState:
    """The chains at device indices `idx` of a batched state."""
    return CRPState(*(f.index_select(0, idx) for f in state))


def put_states(state: CRPState, idx: torch.Tensor, sub: CRPState):
    """`state` with the chains at device indices `idx` replaced by `sub`."""
    return CRPState(*(f.index_copy(0, idx, g) for f, g in zip(state, sub)))


def by_chain_flag(state: CRPState, flags, flags_dev, fn, ax):
    """Run a move on each group of chains with one value of a per-chain
    host flag: fn(value, sub_state, sub_ax, take, idx) -> (sub_state,
    counts or None), where `take(k)` gives the group's draws of the
    provider k and `idx` its device indices (None: the whole state).

    One chain (`flags` a list of one) or a batch whose chains agree runs fn
    once on the whole state with `ax`; otherwise the chains that are True
    and those that are False run as two sub-batches (gathered, moved,
    scattered back), so each chain draws what its one-chain move draws.
    `flags_dev()` gives the flags on the device and is called only then:
    the indices come from it, so none is copied from the host. Returns
    (state, counts), [C, ...] counts zero where fn gave None, or None where
    every call gave None."""
    values = sorted(set(flags), reverse=True)
    if len(values) == 1:
        return fn(values[0], state, ax, lambda k: k, None)
    order = torch.argsort((~flags_dev()).to(torch.int8), stable=True)
    n_true = sum(flags)
    counts = None
    for value, idx in ((True, order[:n_true]), (False, order[n_true:])):
        host = [c for c, f in enumerate(flags) if f == value]
        sub, c = fn(value, take_states(state, idx),
                    dataclasses.replace(ax, chains=len(host)),
                    lambda k, host=host: k.take(host), idx)
        state = put_states(state, idx, sub)
        if c is not None:
            if counts is None:
                counts = c.new_zeros((len(flags),) + tuple(c.shape[1:]))
            counts = counts.index_copy(0, idx, c)
    return state, counts


def pick_at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[..., i] for a per-chain index i (0-d, or [C] beside x [C, k]),
    without a host read of i."""
    return torch.gather(x, -1, i[..., None].long())[..., 0]


def row_at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Row i of a per-chain matrix x ([k, m], or [C, k, m] with i [C])."""
    return torch.take_along_dim(x, i[..., None, None].long(), dim=-2)[
        ..., 0, :]


def first_free_slot(cluster_size: torch.Tensor) -> torch.Tensor:
    """Lowest slot id with size 0 (libs/CRP.py:297-299 analogue); 0 when
    every slot is taken, as jnp.argmax of an all-False mask."""
    return torch.argmax((cluster_size == 0).to(torch.int32),
                        dim=-1).to(torch.int32)


def cluster_stats(data: PackedData, assignment: torch.Tensor, k_max: int):
    """Per-slot sufficient statistics (N1, N0), each [k_max, m]: the number
    of cells in slot k with observed x==1 (x==0) at mutation j. Row
    scatter-adds; the counts are exact integers in float32, so the order of
    the additions does not matter. (F.one_hot would read the assignment's
    range on the host.) A [C, n] assignment gives [C, k_max, m] each."""
    if assignment.dim() == 2:
        shape = (assignment.shape[0],) + tuple(data.xm.shape)
        idx = assignment.long()[:, :, None].expand(shape)
        zeros = data.xm.new_zeros((shape[0], k_max, shape[2]))
        return (zeros.scatter_add(1, idx, data.xm.expand(shape)),
                zeros.scatter_add(1, idx, data.xm0.expand(shape)))
    idx = assignment.long()
    zeros = data.xm.new_zeros((k_max, data.xm.shape[1]))
    return (zeros.index_add(0, idx, data.xm),
            zeros.index_add(0, idx, data.xm0))


def sizes_of(assignment: torch.Tensor, k_max: int) -> torch.Tensor:
    return torch.bincount(assignment.long(), minlength=k_max).to(torch.int32)


def beta_posterior_params(draws: Draws, cfg: ModelConfig, n1, n0):
    """Rows from Beta(p + N1, q + N0), clipped to [TMIN, TMAX]
    (libs/CRP.py:155-188)."""
    return beta_posterior_rows((draws,), cfg, n1[..., None, :],
                               n0[..., None, :])[..., 0, :]


def beta_posterior_rows(keys, cfg: ModelConfig, n1, n0):
    """``beta_posterior_params(keys[g], cfg, n1[..., g, :], n0[..., g,
    :])`` for each group g of the [..., G, m] counts, drawn in that order,
    as one [..., G, m] tensor. On the CPU the torch composition below runs;
    a tensor on another device goes to kernel 8 (ops/cuda_beta.py), one
    launch for every row, on the same draws, or raises for a provider the
    kernel cannot replay."""
    if n1.device.type != "cpu":
        return cuda_beta.posterior(keys, n1, n0, cfg)
    return torch.stack([torch.clamp(k.beta_general(cfg.p + n1[..., g, :],
                                                   cfg.q + n0[..., g, :]),
                                    TMIN, TMAX).to(torch.float32)
                        for g, k in enumerate(keys)], dim=-2)


def beta_posterior_on(prims, cfg: ModelConfig, n1, n0):
    """beta_posterior_params' arithmetic on its drawn primitives (what
    ops/cuda_beta.py::primitives draws): kernel 8's plain twin for a row."""
    draw = randomx.beta_general_on(prims, cfg.p + n1, cfg.q + n0)
    return torch.clamp(draw, TMIN, TMAX).to(torch.float32)


def init_state(draws: Draws, cfg: ModelConfig, data: PackedData, device,
               mode: str = "random", assign=None) -> CRPState:
    """Initial state (reference: CRP.init, libs/CRP.py:119-152).

    Modes: 'random' (uniform slot per cell, uniform live rows), 'together'
    (all cells in slot 0), 'separate' (one slot per cell, needs
    k_max == n), or a fixed ``assign`` vector relabelled to compact slots.
    """
    n, m, k = cfg.n_cells, cfg.n_muts, cfg.k_max
    k_assign, k_params = draws.split(2)

    if assign is not None:
        _, compact = np.unique(np.asarray(assign), return_inverse=True)
        if compact.max() >= k:
            raise ValueError(f"fixed assignment uses {compact.max() + 1} "
                             f"clusters; k_max={k}")
        assignment = torch.from_numpy(compact.astype(np.int32)).to(device)
        n1, n0 = cluster_stats(data, assignment, k)
        params = beta_posterior_params(k_params, cfg, n1, n0)
    elif mode == "random":
        assignment = k_assign.randint((n,), 0, k)
        params = torch.clamp(k_params.uniform((k, m)), TMIN, TMAX)
    elif mode == "together":
        assignment = torch.zeros((n,), dtype=torch.int32, device=device)
        n1, n0 = cluster_stats(data, assignment, k)
        params = beta_posterior_params(k_params, cfg, n1, n0)
    elif mode == "separate":
        if k != n:
            raise ValueError("mode='separate' requires k_max == n_cells")
        assignment = torch.arange(n, dtype=torch.int32, device=device)
        n1, n0 = cluster_stats(data, assignment, k)
        params = beta_posterior_params(k_params, cfg, n1, n0)
    else:
        raise TypeError(f"Unsupported initialization: {mode}")

    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    return CRPState(
        assignment=assignment,
        params=params.to(torch.float32),
        cluster_size=sizes_of(assignment, k),
        dp_alpha=scalar(cfg.dp_a_init),
        fp=scalar(cfg.fp),
        fn=scalar(cfg.fn),
    )
