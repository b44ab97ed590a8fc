"""Device-side packed representation of the mutation matrix
(counterpart of bnpc_tpu/data.py).

The {0, 1, NaN} matrix is packed once into masked indicator planes, so every
likelihood evaluation is a matmul:

  xm[i, j]  = mask * x          (observed mutation present)
  xm0[i, j] = mask * (1 - x)    (observed mutation absent)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class PackedData(NamedTuple):
    xm: torch.Tensor    # [n, m] f32: 1 where x==1 and observed
    xm0: torch.Tensor   # [n, m] f32: 1 where x==0 and observed
    rs1: torch.Tensor   # [n] f32: per-cell count of observed 1s
    rs0: torch.Tensor   # [n] f32: per-cell count of observed 0s

    @property
    def n_cells(self) -> int:
        return self.xm.shape[0]

    @property
    def n_muts(self) -> int:
        return self.xm.shape[1]

    @property
    def mask(self) -> torch.Tensor:
        return self.xm + self.xm0

    @property
    def x(self) -> torch.Tensor:
        """Data with missing entries as 0 (use .mask to distinguish)."""
        return self.xm


def pack_data(data: np.ndarray, device) -> PackedData:
    """Pack an n x m matrix of {0, 1, NaN} into planes on `device`."""
    data = np.asarray(data, dtype=np.float64)
    mask = np.isfinite(data)
    x = np.where(mask, data, 0.0)
    xm = (x * mask).astype(np.float32)
    xm0 = ((1.0 - x) * mask).astype(np.float32)
    return PackedData(
        xm=torch.from_numpy(xm).to(device),
        xm0=torch.from_numpy(xm0).to(device),
        rs1=torch.from_numpy(xm.sum(axis=1)).to(device),
        rs0=torch.from_numpy(xm0.sum(axis=1)).to(device),
    )


def pad_muts(data: PackedData, shards: int) -> tuple[PackedData, int]:
    """Pad the mutation axis to a multiple of `shards` with unobserved
    (all-zero) columns (bnpc_tpu/parallel/sharded.py:51-65); returns
    (padded data, padded m). rs1 / rs0 are unchanged."""
    m = data.n_muts
    m_pad = -(-m // shards) * shards
    if m_pad == m:
        return data, m
    pad = (0, m_pad - m)
    return data._replace(xm=torch.nn.functional.pad(data.xm, pad),
                         xm0=torch.nn.functional.pad(data.xm0, pad)), m_pad


def local_cols(data: PackedData, index: int, shards: int) -> PackedData:
    """Mutation shard `index` of `shards` of (padded) data: its contiguous
    block of columns of xm and xm0. rs1 / rs0 stay the whole rows' counts,
    never recomputed from the shard's columns (bnpc_tpu likelihood.py:102
    reads them replicated)."""
    m_local = data.n_muts // shards
    cols = slice(index * m_local, (index + 1) * m_local)
    return data._replace(xm=data.xm[:, cols].contiguous(),
                         xm0=data.xm0[:, cols].contiguous())


def local_mut_mask(m_pad: int, m_real: int, index: int, shards: int,
                   device) -> torch.Tensor:
    """[m_local] f32 validity mask of shard `index`'s columns
    (bnpc_tpu/parallel/sharded.py:67-73): 1 for a real mutation column,
    0 for padding."""
    m_local = m_pad // shards
    cols = index * m_local + torch.arange(m_local, device=device)
    return (cols < m_real).to(torch.float32)
