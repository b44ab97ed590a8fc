"""The streaming lazy Gibbs segment: CUDA kernel wrapper and its plain twin.

Counterpart of bnpc_tpu/ops/pallas_gibbs.py::pallas_lazy_segment_stream.
The kernel (csrc/lazy_stream.cu) is the segment of ops/cuda_gibbs.py with
every input in VISIT order: position i reads row ``zp[i]``, ``auxp[i]`` and
``assignp[i]``, with no permutation indirection, so the rows stream from
device memory in order. The birth comes back as a visit position; the caller
(models/gibbs.py::_segment_impl) maps it to a cell through perm.

Interface (both versions): zp [n, k_pad] f32 with k_pad a multiple of 32 (at
most ops/cuda_gibbs.py::SMEM_MAX_SLOTS); ``sizes`` [k_pad] f32 (-1 on padded
slots) is updated in place, ``tgt`` [n] i32 receives the chosen slot of
every position in [i0, i_next), and ``info`` [4] i32 receives
(i_next, birth_pos, birth_slot, cap_veto).

``lazy_segment_stream_chains`` runs a batch of chains' segments as one
launch on a grid of one block a chain, with the interface of
ops/cuda_gibbs.py::lazy_segment_chains (a leading chain axis on every
argument, start positions in the device tensor ``i0s``).

A CPU tensor goes to the plain twin; a CUDA tensor goes to the kernel or
the wrapper raises.
"""

from __future__ import annotations

import torch

from bnpc_tpu_torch.ops import _build
from bnpc_tpu_torch.ops.cuda_gibbs import (SMEM_MAX_SLOTS, lazy_segment_ref,
                                           segment_chains_ref)

# Kernel launches since the last reset (each wrapper adds one per launch):
# one-chain launches, and batched launches with their count per grid size.
launches = 0
chain_launches = 0
chain_grids: dict[int, int] = {}


def lazy_segment_stream_ref(zp, auxp, assignp, sizes, tgt, info, i0: int,
                            log_denom):
    """Plain torch twin of the kernel: the resident segment's loop on the
    identity permutation, where a birth's cell IS its visit position."""
    ident = torch.arange(zp.shape[0], dtype=torch.int32, device=zp.device)
    lazy_segment_ref(zp, auxp, assignp, ident, sizes, tgt, info, i0,
                     log_denom)


def lazy_segment_stream(zp, auxp, assignp, sizes, tgt, info, i0: int,
                        log_denom):
    """Run one birth-bounded segment in visit order (module docstring).

    zp [n, k_pad] f32; auxp [n] f32; assignp [n] i32; sizes [k_pad] f32;
    tgt [n] i32; info [4] i32; log_denom 0-d f32 tensor; i0 a host int.
    """
    if zp.device.type == "cpu":
        return lazy_segment_stream_ref(zp, auxp, assignp, sizes, tgt, info,
                                       i0, log_denom)
    if zp.device.type != "cuda":
        raise ValueError(f"lazy_segment_stream: unsupported device "
                         f"{zp.device}")
    n, k_pad = zp.shape
    if k_pad <= 0 or k_pad % 32 or k_pad > SMEM_MAX_SLOTS:
        raise ValueError(f"lazy_segment_stream: k_pad={k_pad} must be a "
                         f"multiple of 32 of at most {SMEM_MAX_SLOTS}")
    if not 0 <= i0 <= n:
        raise ValueError(f"lazy_segment_stream: i0={i0} outside [0, {n}]")
    dev = zp.device
    f32, i32 = torch.float32, torch.int32
    _build.check_tensor(zp, "zp", f32, (n, k_pad), dev)
    _build.check_tensor(auxp, "auxp", f32, (n,), dev)
    _build.check_tensor(assignp, "assignp", i32, (n,), dev)
    _build.check_tensor(sizes, "sizes", f32, (k_pad,), dev)
    _build.check_tensor(tgt, "tgt", i32, (n,), dev)
    _build.check_tensor(info, "info", i32, (4,), dev)
    _build.check_tensor(log_denom, "log_denom", f32, (), dev)
    lib = _build.load_library()
    global launches
    launches += 1
    rc = lib.bnpc_lazy_stream(
        zp.data_ptr(), auxp.data_ptr(), assignp.data_ptr(), sizes.data_ptr(),
        tgt.data_ptr(), info.data_ptr(), log_denom.data_ptr(), n, k_pad,
        int(i0), torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, "bnpc_lazy_stream")


def lazy_segment_stream_chains_ref(zp, auxp, assignp, sizes, tgt, info, i0s,
                                   log_denom):
    """Plain torch twin of the batched launch: lazy_segment_stream_ref
    chain by chain."""
    segment_chains_ref(lazy_segment_stream_ref, (zp, auxp, assignp), sizes,
                       tgt, info, i0s, log_denom)


def lazy_segment_stream_chains(zp, auxp, assignp, sizes, tgt, info, i0s,
                               log_denom):
    """One batched segment launch in visit order (module docstring).

    zp [C, n, k_pad] f32; auxp [C, n] f32; assignp [C, n] i32; sizes
    [C, k_pad] f32; tgt [C, n] i32; info [C, 4] i32; i0s [C] i32;
    log_denom [C] f32.
    """
    if zp.device.type == "cpu":
        return lazy_segment_stream_chains_ref(zp, auxp, assignp, sizes, tgt,
                                              info, i0s, log_denom)
    if zp.device.type != "cuda":
        raise ValueError(f"lazy_segment_stream_chains: unsupported device "
                         f"{zp.device}")
    c, n, k_pad = zp.shape
    if k_pad <= 0 or k_pad % 32 or k_pad > SMEM_MAX_SLOTS:
        raise ValueError(f"lazy_segment_stream_chains: k_pad={k_pad} must "
                         f"be a multiple of 32 of at most {SMEM_MAX_SLOTS}")
    dev = zp.device
    f32, i32 = torch.float32, torch.int32
    _build.check_tensor(zp, "zp", f32, (c, n, k_pad), dev)
    _build.check_tensor(auxp, "auxp", f32, (c, n), dev)
    _build.check_tensor(assignp, "assignp", i32, (c, n), dev)
    _build.check_tensor(sizes, "sizes", f32, (c, k_pad), dev)
    _build.check_tensor(tgt, "tgt", i32, (c, n), dev)
    _build.check_tensor(info, "info", i32, (c, 4), dev)
    _build.check_tensor(i0s, "i0s", i32, (c,), dev)
    _build.check_tensor(log_denom, "log_denom", f32, (c,), dev)
    lib = _build.load_library()
    global chain_launches
    chain_launches += 1
    chain_grids[c] = chain_grids.get(c, 0) + 1
    rc = lib.bnpc_lazy_stream_chains(
        zp.data_ptr(), auxp.data_ptr(), assignp.data_ptr(), sizes.data_ptr(),
        tgt.data_ptr(), info.data_ptr(), log_denom.data_ptr(),
        i0s.data_ptr(), c, n, k_pad,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, "bnpc_lazy_stream_chains")
