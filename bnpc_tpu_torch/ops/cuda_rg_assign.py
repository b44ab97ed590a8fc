"""A split-merge launch scan's per-cell work: CUDA kernel wrapper and its
plain twin.

The kernel (csrc/rg_assign.cu, kernel 9) runs, in one launch, what
models/splitmerge.py::_rg_scan_assign computes between the likelihood
product ``ll2`` and the new launch sides: the Gumbel margins, the visit
order of the movable cells, the count log-table, kernel 2's scan
(csrc/rg_chain.cuh), the new sides in cell order, the two side masks, and
with ``trans_prob`` the replay's chosen log-probability of every visit
position (0 from s_count on). The draws, the log-prob tables, the
likelihood product (cuBLAS, all-reduced on a mesh) and the sum of the
chosen terms (``ax.sum``) stay torch's.

Interface: one chain's tensors, or a batch's with a leading chain axis C
(a grid of one block a chain): noise (the uniforms) and ll2 [..., n, 2]
f32, bits [...,
2, n] int64 (uint32 values), s_mask [..., n] bool, rg [..., n] int32,
anchor_i, anchor_j [...] int32, n_move, dp_alpha [...] f32. Returns
(rg_new [..., n] int32, sides [..., 2, n] f32, chosen [..., n] f32 or
None).

The draws: :func:`noise` draws what ``gumbel`` draws inside, the uniform,
so the generator's stream moves as the composition moves it. It takes a
TorchDraws, or a StackedDraws that runs the Gumbel transform once on
stacked uniforms, and raises for any other provider (``draws.replays``),
as ops/cuda_beta.py does for the Beta rows that every split-merge move
draws first.

The route (:func:`fits`) depends only on the device and n: a CUDA tensor
of at most MAX_CELLS cells goes to the kernel; a larger n and the CPU keep
the composition, which is the kernel's definition. The plain twin
:func:`rg_assign_ref` follows the kernel's own steps (S sorted alone by
(key, cell), block-style counts) on the CPU.
"""

from __future__ import annotations

import torch

from bnpc_tpu_torch.draws import gumbel_of, replays
from bnpc_tpu_torch.ops import _build
from bnpc_tpu_torch.ops.cuda_rg import rg_scan_ref

# csrc/rg_assign.cu's kMaxCells: 13 bytes a cell of n padded to a power of
# two in shared memory, beside the chain's buffers, within 227 KB.
MAX_CELLS = 16384

# Kernel launches since the last reset (each wrapper adds one per launch):
# one-chain launches, and batched launches with their count per grid size.
launches = 0
chain_launches = 0
chain_grids: dict[int, int] = {}


def fits(device, n: int) -> bool:
    """True where a launch scan of n cells on `device` runs the kernel."""
    return torch.device(device).type == "cuda" and 0 < n <= MAX_CELLS


def noise(draws, shape):
    """The uniforms ``draws.gumbel(shape)`` would transform. Raises for a
    provider whose Gumbel transform the kernel cannot replay
    (``draws.replays``), before any draw."""
    if not replays(draws, "gumbel"):
        raise ValueError(f"rg_assign: {type(draws).__name__} is not a "
                         "TorchDraws or a StackedDraws of them: the kernel "
                         "cannot replay its Gumbel noise")
    return draws.uniform(tuple(shape))


def _check(noise, bits, ll2, s_mask, rg, anchor_i, anchor_j, n_move,
           dp_alpha):
    """Raise unless the arguments are one launch's (module docstring);
    returns (lead shape, n)."""
    if s_mask.dim() not in (1, 2):
        raise ValueError(f"rg_assign: s_mask {tuple(s_mask.shape)} is "
                         "neither one chain's [n] nor a batch's [C, n]")
    lead, n = tuple(s_mask.shape[:-1]), s_mask.shape[-1]
    dev, f32, i32 = s_mask.device, torch.float32, torch.int32
    _build.check_tensor(s_mask, "s_mask", torch.bool, lead + (n,), dev)
    _build.check_tensor(noise, "noise", f32, lead + (n, 2), dev)
    _build.check_tensor(bits, "bits", torch.int64, lead + (2, n), dev)
    _build.check_tensor(ll2, "ll2", f32, lead + (n, 2), dev)
    _build.check_tensor(rg, "rg", i32, lead + (n,), dev)
    for name, t, dtype in (("anchor_i", anchor_i, i32),
                           ("anchor_j", anchor_j, i32),
                           ("n_move", n_move, f32),
                           ("dp_alpha", dp_alpha, f32)):
        _build.check_tensor(t, name, dtype, lead, dev)
    return lead, n


def rg_assign(noise, bits, ll2, s_mask, rg, anchor_i, anchor_j, n_move,
              dp_alpha, trans_prob: bool):
    """Run the kernel in one launch (module docstring). Raises for a wrong
    dtype, shape or device, or an n above MAX_CELLS, before any launch."""
    lead, n = _check(noise, bits, ll2, s_mask, rg, anchor_i, anchor_j,
                     n_move, dp_alpha)
    dev = s_mask.device
    if not 0 < n <= MAX_CELLS:
        raise ValueError(f"rg_assign: {n} cells, the kernel takes 1 to "
                         f"{MAX_CELLS}")
    if dev.type != "cuda":
        raise ValueError(f"rg_assign: unsupported device {dev}")
    chains = lead[0] if lead else 1
    rg_new = torch.empty(lead + (n,), dtype=torch.int32, device=dev)
    sides = torch.empty(lead + (2, n), dtype=torch.float32, device=dev)
    chosen = (torch.empty(lead + (n,), dtype=torch.float32, device=dev)
              if trans_prob else None)
    lib = _build.load_library()
    global launches, chain_launches
    if lead:
        chain_launches += 1
        chain_grids[chains] = chain_grids.get(chains, 0) + 1
    else:
        launches += 1
    rc = lib.bnpc_rg_assign(
        noise.data_ptr(), bits.data_ptr(), ll2.data_ptr(),
        s_mask.data_ptr(), rg.data_ptr(), anchor_i.data_ptr(),
        anchor_j.data_ptr(), n_move.data_ptr(), dp_alpha.data_ptr(),
        rg_new.data_ptr(), sides.data_ptr(),
        None if chosen is None else chosen.data_ptr(), chains, n,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, "bnpc_rg_assign")
    return rg_new, sides, chosen


def _s_order(bits, s_mask):
    """One chain's visit order as the kernel makes it: the movable cells
    sorted alone by (key, cell), then the other cells (their order is never
    read). The signed key (bits0 - 2^31) 2^32 + bits1 orders as the
    kernel's unsigned (bits0 << 32) | bits1."""
    cells = torch.nonzero(s_mask).flatten()
    key = (bits[0, cells] - 2**31) * 2**32 + bits[1, cells]
    s_cells = cells[torch.sort(key, stable=True).indices]
    return torch.cat([s_cells, torch.nonzero(~s_mask).flatten()])


def rg_assign_ref(noise, bits, ll2, s_mask, rg, anchor_i, anchor_j, n_move,
                  dp_alpha, trans_prob: bool):
    """Plain torch twin of the kernel, step by step (csrc/rg_assign.cu):
    its elementwise arithmetic runs on whole [..., n] tensors, as the
    composition's does, so that a CPU vector loop rounds each position
    alike."""
    lead, n = _check(noise, bits, ll2, s_mask, rg, anchor_i, anchor_j,
                     n_move, dp_alpha)
    dev = s_mask.device
    z = ll2 + gumbel_of(noise)
    dz = z[..., 1] - z[..., 0]
    flat = (lambda x: x[None]) if not lead else (lambda x: x)
    s_mask_c, rg_c, bits_c, dz_c = (flat(t) for t in (s_mask, rg, bits, dz))
    n_move_c = flat(n_move)
    order = torch.stack([_s_order(bits_c[c], s_mask_c[c])
                         for c in range(s_mask_c.shape[0])])
    s_count = s_mask_c.sum(-1)
    count1 = torch.where(s_mask_c, rg_c, 0).sum(-1)
    lau_v = torch.gather(rg_c, -1, order)
    s1r = torch.arange(n + 2, dtype=torch.float32, device=dev)
    dtab = torch.log(s1r + 1.0) - torch.log(torch.clamp(
        n_move_c[..., None] - s1r - 2.0, min=0.0))
    pos = torch.arange(n, device=dev)
    in_s = pos < s_count[..., None]
    out_v = torch.stack([
        rg_scan_ref(torch.gather(dz_c[c], -1, order[c]), lau_v[c],
                    dtab[c], s_count[c].to(torch.int32),
                    count1[c].to(torch.int32))
        for c in range(order.shape[0])])
    fin_v = torch.where(in_s, out_v, lau_v)
    rg_new_c = torch.empty_like(rg_c).scatter_(-1, order, fin_v)
    idx = torch.arange(n, device=dev)
    side0 = (s_mask_c & (rg_new_c == 0)) | (idx == flat(anchor_i)[..., None])
    side1 = (s_mask_c & (rg_new_c == 1)) | (idx == flat(anchor_j)[..., None])
    sides = torch.stack([side0, side1], dim=-2).to(torch.float32)
    unflat = (lambda x: x[0]) if not lead else (lambda x: x)
    if not trans_prob:
        return unflat(rg_new_c), unflat(sides), None
    # Final sides before each position, launch sides after it, as integer
    # counts (the kernel's block scans).
    fin_s = torch.where(in_s, fin_v, 0)
    lau_s = torch.where(in_s, lau_v, 0)
    before = torch.cumsum(fin_s, -1) - fin_s
    after = count1[..., None] - torch.cumsum(lau_s, -1)
    s1 = (before + after).to(torch.float32)
    ll2_c = flat(ll2)
    ll0_v = torch.gather(ll2_c[..., 0], -1, order)
    ll1_v = torch.gather(ll2_c[..., 1], -1, order)
    n_j = s1 + 1.0
    n_i = n_move_c[..., None] - s1 - 2.0
    log_denom = torch.log(n_move_c - 1.0 + flat(dp_alpha))[..., None]
    lp0 = ll0_v + torch.log(n_i) - log_denom
    lp1 = ll1_v + torch.log(n_j) - log_denom
    mx = torch.maximum(lp0, lp1)
    lse = mx + torch.log(torch.exp(lp0 - mx) + torch.exp(lp1 - mx))
    chosen = torch.where(in_s, torch.where(fin_v > 0, lp1, lp0) - lse, 0.0)
    return unflat(rg_new_c), unflat(sides), unflat(chosen)
