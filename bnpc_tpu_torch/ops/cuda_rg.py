"""The split-merge restricted scan: CUDA kernel wrapper and its plain twin.

Counterpart of bnpc_tpu/ops/pallas_rg.py::rg_scan. The kernel
(csrc/rg_scan.cu) runs, for every visit position i < s_count,

    s1 = count1 - lau[i];  side = dz[i] + dtab[s1] > 0;  count1 = s1 + side

and returns the [n] i32 sides by visit position, valid only below s_count
(the caller merges with ``where(pos < s_count, out, lau)``). ``s_count`` and
``count1`` are 0-d int32 DEVICE tensors that the kernel reads itself, so
launching the scan needs no host synchronization.

``rg_scan_chains`` runs a batch of chains' scans as one launch of the same
kernel on a grid of one block a chain: dz, lau [C, n], dtab [C, n + 2],
s_count and count1 [C] on the device, each chain with its own count.

A CPU tensor goes to the plain twin; a CUDA tensor goes to the kernel or
the wrapper raises.
"""

from __future__ import annotations

import torch

from bnpc_tpu_torch.ops import _build

# Kernel launches since the last reset (each wrapper adds one per launch):
# one-chain launches, and batched launches with their count per grid size.
launches = 0
chain_launches = 0
chain_grids: dict[int, int] = {}


def rg_scan_ref(dz_v, lau_v, dtab, s_count, count1):
    """Plain torch twin of the kernel: the same serial float32 loop."""
    n = dz_v.shape[0]
    out = torch.zeros((n,), dtype=torch.int32, device=dz_v.device)
    c1 = count1.clone()
    for i in range(min(int(s_count), n)):
        s1 = c1 - lau_v[i]
        side = (dz_v[i] + dtab[s1] > 0.0).to(torch.int32)
        out[i] = side
        c1 = s1 + side
    return out


def rg_scan(dz_v, lau_v, dtab, s_count, count1):
    """Run the restricted scan over visit-order streams.

    dz_v [n] f32; lau_v [n] i32; dtab [n+2] f32; s_count, count1 0-d i32.
    Returns [n] i32 sides by visit position (valid below s_count).
    """
    if dz_v.device.type == "cpu":
        return rg_scan_ref(dz_v, lau_v, dtab, s_count, count1)
    if dz_v.device.type != "cuda":
        raise ValueError(f"rg_scan: unsupported device {dz_v.device}")
    n, dev = dz_v.shape[0], dz_v.device
    f32, i32 = torch.float32, torch.int32
    _build.check_tensor(dz_v, "dz_v", f32, (n,), dev)
    _build.check_tensor(lau_v, "lau_v", i32, (n,), dev)
    _build.check_tensor(dtab, "dtab", f32, (n + 2,), dev)
    _build.check_tensor(s_count, "s_count", i32, (), dev)
    _build.check_tensor(count1, "count1", i32, (), dev)
    out = torch.empty((n,), dtype=i32, device=dev)
    lib = _build.load_library()
    global launches
    launches += 1
    rc = lib.bnpc_rg_scan(
        dz_v.data_ptr(), lau_v.data_ptr(), dtab.data_ptr(),
        s_count.data_ptr(), count1.data_ptr(), out.data_ptr(), n,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, "bnpc_rg_scan")
    return out


def rg_scan_chains_ref(dz_v, lau_v, dtab, s_count, count1):
    """Plain torch twin of the batched launch: rg_scan_ref chain by chain."""
    return torch.stack([rg_scan_ref(dz_v[c], lau_v[c], dtab[c], s_count[c],
                                    count1[c])
                        for c in range(dz_v.shape[0])])


def rg_scan_chains(dz_v, lau_v, dtab, s_count, count1):
    """Run a batch of chains' restricted scans as one launch.

    dz_v [C, n] f32; lau_v [C, n] i32; dtab [C, n+2] f32; s_count, count1
    [C] i32. Returns [C, n] i32 sides by visit position (row c valid below
    s_count[c]).
    """
    if dz_v.device.type == "cpu":
        return rg_scan_chains_ref(dz_v, lau_v, dtab, s_count, count1)
    if dz_v.device.type != "cuda":
        raise ValueError(f"rg_scan_chains: unsupported device {dz_v.device}")
    (c, n), dev = dz_v.shape, dz_v.device
    f32, i32 = torch.float32, torch.int32
    _build.check_tensor(dz_v, "dz_v", f32, (c, n), dev)
    _build.check_tensor(lau_v, "lau_v", i32, (c, n), dev)
    _build.check_tensor(dtab, "dtab", f32, (c, n + 2), dev)
    _build.check_tensor(s_count, "s_count", i32, (c,), dev)
    _build.check_tensor(count1, "count1", i32, (c,), dev)
    out = torch.empty((c, n), dtype=i32, device=dev)
    lib = _build.load_library()
    global chain_launches
    chain_launches += 1
    chain_grids[c] = chain_grids.get(c, 0) + 1
    rc = lib.bnpc_rg_scan_chains(
        dz_v.data_ptr(), lau_v.data_ptr(), dtab.data_ptr(),
        s_count.data_ptr(), count1.data_ptr(), out.data_ptr(), c, n,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, "bnpc_rg_scan_chains")
    return out
