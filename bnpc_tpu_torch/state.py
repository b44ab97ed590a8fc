"""Sampler state: fixed-capacity padded cluster bookkeeping
(counterpart of bnpc_tpu/state.py).

A cluster is a slot in [0, k_max):

  assignment[n]       int32, slot id per cell
  params[k_max, m]    float32, one genotype-parameter row per slot
  cluster_size[k_max] int32, 0 == free slot (rows of free slots are stale)
  dp_alpha, fp, fn    0-d float32 tensors
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bnpc_tpu_torch.config import TMAX, TMIN, ModelConfig
from bnpc_tpu_torch.data import PackedData
from bnpc_tpu_torch.draws import Draws


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
        return self.live.sum().to(torch.int32)


def first_free_slot(cluster_size: torch.Tensor) -> torch.Tensor:
    """Lowest slot id with size 0 (libs/CRP.py:297-299 analogue); 0 when
    every slot is taken, as jnp.argmax of an all-False mask."""
    return torch.argmax((cluster_size == 0).to(torch.int32)).to(torch.int32)


def cluster_stats(data: PackedData, assignment: torch.Tensor, k_max: int):
    """Per-slot sufficient statistics (N1, N0), each [k_max, m]: the number
    of cells in slot k with observed x==1 (x==0) at mutation j. Row
    scatter-adds; the counts are exact integers in float32, so the order of
    the additions does not matter. (F.one_hot would read the assignment's
    range on the host.)"""
    idx = assignment.long()
    zeros = data.xm.new_zeros((k_max, data.xm.shape[1]))
    return (zeros.index_add(0, idx, data.xm),
            zeros.index_add(0, idx, data.xm0))


def sizes_of(assignment: torch.Tensor, k_max: int) -> torch.Tensor:
    return torch.bincount(assignment.long(), minlength=k_max).to(torch.int32)


def beta_posterior_params(draws: Draws, cfg: ModelConfig, n1, n0):
    """Rows from Beta(p + N1, q + N0), clipped to [TMIN, TMAX]
    (libs/CRP.py:155-188)."""
    draw = draws.beta_general(cfg.p + n1, cfg.q + n0)
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
