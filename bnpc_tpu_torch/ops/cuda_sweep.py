"""The eager whole Gibbs sweep: CUDA kernel wrapper and its plain twin.

Counterpart of bnpc_tpu/ops/pallas_gibbs.py::pallas_sweep. The kernel
(csrc/sweep.cu) runs every cell of the sweep in one launch, in absolute cell
order through ``perm``. Every newborn row is drawn up front (``fresh``
[n, m]) and the likelihood of every cell under every newborn row is one
product up front (``lf`` [n, n], lf[j, c] = ll(cell j | fresh[c])), so a
birth of cell c into slot f is patched inside the kernel:
z[:, f] = lf[:, c] + gum[:, f] and params[f] = fresh[c]. One launch per
sweep, no host read.

Interface (both versions): z and gum [n, k_pad] f32 with k_pad a multiple of
32 (at most ops/cuda_gibbs.py::SMEM_MAX_SLOTS), aux [n] f32, assign and perm
[n] i32, sizes [k_pad] f32 (-1 on padded slots), params [p, m] f32 with
p <= k_pad. Returns (assignment [n] i32 in cell order, sizes, params); the
inputs are not modified (the kernel patches working copies).

A CPU tensor goes to the plain twin; a CUDA tensor goes to the kernel or
the wrapper raises.
"""

from __future__ import annotations

import torch

from bnpc_tpu_torch.ops import _build
from bnpc_tpu_torch.ops.cuda_gibbs import SMEM_MAX_SLOTS, pick_ref

# Kernel launches since the last reset (the wrapper adds one per launch),
# and, as the batched kernels' wrappers keep them, batched launches with
# their count per grid size (none: kernel 4 has no chain grid).
launches = 0
chain_launches = 0
chain_grids: dict[int, int] = {}


def eager_sweep_ref(z, gum, lf, fresh, aux, assign, perm, sizes, params,
                    log_denom):
    """Plain torch twin of the kernel: the same per-cell step and the same
    in-loop birth patch, on copies."""
    z, sizes, params = z.clone(), sizes.clone(), params.clone()
    k_pad = z.shape[1]
    out = torch.empty_like(assign)
    assign_h = assign.tolist()
    for cell in perm.tolist():
        sizes[assign_h[cell]] -= 1.0
        cand, free, idx = pick_ref(z[cell], sizes, aux[cell], log_denom)
        is_new = bool(cand) and free < k_pad
        t = free if is_new else idx
        if is_new:
            z[:, t] = lf[:, cell] + gum[:, t]
            params[t] = fresh[cell]
        sizes[t] += 1.0
        out[cell] = t
    return out, sizes, params


def eager_sweep(z, gum, lf, fresh, aux, assign, perm, sizes, params,
                log_denom):
    """Run the whole sweep in one launch (module docstring).

    log_denom is a 0-d f32 tensor. Returns (assignment, sizes, params).
    """
    if z.device.type == "cpu":
        return eager_sweep_ref(z, gum, lf, fresh, aux, assign, perm, sizes,
                               params, log_denom)
    if z.device.type != "cuda":
        raise ValueError(f"eager_sweep: unsupported device {z.device}")
    n, k_pad = z.shape
    p_rows, m = params.shape
    if k_pad <= 0 or k_pad % 32 or k_pad > SMEM_MAX_SLOTS:
        raise ValueError(f"eager_sweep: k_pad={k_pad} must be a multiple "
                         f"of 32 of at most {SMEM_MAX_SLOTS}")
    if p_rows > k_pad:
        raise ValueError(f"eager_sweep: {p_rows} params rows > k_pad={k_pad}")
    dev = z.device
    f32, i32 = torch.float32, torch.int32
    _build.check_tensor(z, "z", f32, (n, k_pad), dev)
    _build.check_tensor(gum, "gum", f32, (n, k_pad), dev)
    _build.check_tensor(lf, "lf", f32, (n, n), dev)
    _build.check_tensor(fresh, "fresh", f32, (n, m), dev)
    _build.check_tensor(aux, "aux", f32, (n,), dev)
    _build.check_tensor(assign, "assign", i32, (n,), dev)
    _build.check_tensor(perm, "perm", i32, (n,), dev)
    _build.check_tensor(sizes, "sizes", f32, (k_pad,), dev)
    _build.check_tensor(params, "params", f32, (p_rows, m), dev)
    _build.check_tensor(log_denom, "log_denom", f32, (), dev)
    z, sizes, params = z.clone(), sizes.clone(), params.clone()
    out = torch.empty((n,), dtype=i32, device=dev)
    lib = _build.load_library()
    global launches
    launches += 1
    rc = lib.bnpc_eager_sweep(
        z.data_ptr(), gum.data_ptr(), lf.data_ptr(), fresh.data_ptr(),
        aux.data_ptr(), assign.data_ptr(), perm.data_ptr(), sizes.data_ptr(),
        params.data_ptr(), out.data_ptr(), log_denom.data_ptr(), n, k_pad, m,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, "bnpc_eager_sweep")
    return out, sizes, params
