"""Carry state and data across from numpy leaves.

``state_from_numpy`` and ``data_from_numpy`` turn the leaves of a
``bnpc_tpu`` CRPState / PackedData, given as numpy arrays (for example
``np.asarray(leaf)`` of each JAX array), into the port's tensors on a given
device, so both packages can start from the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from bnpc_tpu_torch.data import PackedData
from bnpc_tpu_torch.state import CRPState

_STATE_DTYPES = {
    "assignment": torch.int32,
    "params": torch.float32,
    "cluster_size": torch.int32,
    "dp_alpha": torch.float32,
    "fp": torch.float32,
    "fn": torch.float32,
}


def _tensor(x, dtype, device):
    return torch.from_numpy(np.array(x, copy=True)).to(device=device,
                                                       dtype=dtype)


def state_from_numpy(assignment, params, cluster_size, dp_alpha, fp, fn,
                     device) -> CRPState:
    """CRPState on `device` from numpy leaves (same field order)."""
    leaves = dict(assignment=assignment, params=params,
                  cluster_size=cluster_size, dp_alpha=dp_alpha, fp=fp, fn=fn)
    return CRPState(**{f: _tensor(leaves[f], dt, device)
                       for f, dt in _STATE_DTYPES.items()})


def data_from_numpy(xm, xm0, rs1, rs0, device) -> PackedData:
    """PackedData on `device` from numpy leaves (same field order)."""
    return PackedData(*(_tensor(x, torch.float32, device)
                        for x in (xm, xm0, rs1, rs0)))
