"""The cluster-parameter MH sweep: CUDA kernel wrapper.

The kernel (csrc/mh_sweep.cu, kernel 7) runs ops/mh.py::mh_cluster_params
on a block of parameter rows in one launch: for every coordinate the std
from its index, the bounds, the inverse-CDF truncated-normal proposal, the
MH log-acceptance (both truncnorm log-densities, both likelihood tables,
the Beta prior terms when the prior is not uniform, the clip when the
transition sum is asked for), the decision and the new parameter; and per
row the declined count over real columns and the transition sum. Its
realized mode runs ops/mh.py::realized_trans_logprob's per-row sum.

Interface: rows are the flattened leading axes of the [..., m] inputs (1
for a merge row, 2 for a split pair, k_max for update_parameters, C times
those for a batch of C chains); fp and fn are 0-d (one chain) or [C], chain
c owning rows c * R / C up to (c + 1) * R / C; ``mask`` is the mutation
axis' [m] 0 / 1 column mask or None. The all-reduce over a sharded mutation
axis (``ax.psum``) runs after the kernel, on its per-row sums, in
ops/mh.py.

The draws stay torch's: :func:`primitives` draws the std index
(``k_std.randint``), the proposal's uniform (what ``truncnorm`` draws
inside) and the acceptance uniform (``k_u.uniform``) from the providers the
composition uses, in its order, so the generator's stream moves exactly as
before. It takes a TorchDraws, or a StackedDraws of them, and raises for
any other provider (a JaxDraws computes its own truncnorm, which the kernel
cannot replay).

ops/mh.py routes a tensor off the CPU here and keeps its composition for
the CPU, which is the kernel's plain twin (``mh.sweep_on`` on the
primitives, ``mh.realized_sum``).
"""

from __future__ import annotations

import torch

from bnpc_tpu_torch.config import ModelConfig
from bnpc_tpu_torch.draws import replays
from bnpc_tpu_torch.ops import _build

# Kernel launches since the last reset (each wrapper adds one per launch):
# one-chain launches (0-d fp), and batched launches (fp [C], the chains'
# rows in one grid) with their count per number of chains.
launches = 0
chain_launches = 0
chain_grids: dict[int, int] = {}


def takes(draws) -> bool:
    """True for the providers whose truncnorm the kernel replays
    (``draws.replays``)."""
    return replays(draws, "truncnorm")


def primitives(draws, shape, n_std: int):
    """The sweep's three primitives from `draws`, as ops/mh.py's
    composition draws them: the std index in [0, n_std) (int32), the
    proposal's uniform and the acceptance uniform, each of `shape`. Raises
    for a provider the kernel cannot replay (:func:`takes`), before any
    draw."""
    if not takes(draws):
        raise ValueError(f"mh_sweep: {type(draws).__name__} is not a "
                         "TorchDraws or a StackedDraws of them: the kernel "
                         "cannot replay its truncnorm")
    k_std, k_prop, k_u = draws.split(3)
    shape = tuple(shape)
    return (k_std.randint(shape, 0, n_std), k_prop.uniform(shape),
            k_u.uniform(shape))


def _layout(x, fp, fn, mask, name):
    """(rows, rows a chain, m) of a kernel call on rows `x`, after the
    checks of its per-chain and per-column arguments."""
    if x.dim() < 1:
        raise ValueError(f"{name}: rows must have a column axis")
    m = x.shape[-1]
    rows = x.numel() // m if m else 0
    if fp.dim() > 1 or (fp.dim() == 1 and (x.dim() < 2
                                           or x.shape[0] != fp.shape[0])):
        raise ValueError(f"{name}: fp {tuple(fp.shape)} is neither one "
                         f"chain's nor a chain each of {tuple(x.shape)}")
    _build.check_tensor(fp, "fp", torch.float32, tuple(fp.shape), x.device)
    _build.check_tensor(fn, "fn", torch.float32, tuple(fp.shape), x.device)
    if mask is not None:
        _build.check_tensor(mask, "mask", torch.float32, (m,), x.device)
    return rows, max(rows // fp.numel(), 1), m


def _launch(x, fp, name):
    """The kernel library, after the device check and the count of one
    launch on rows `x` (batched where `fp` is a chain each)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    lib = _build.load_library()
    global launches, chain_launches
    if fp.dim():
        chain_launches += 1
        chains = fp.shape[0]
        chain_grids[chains] = chain_grids.get(chains, 0) + 1
    else:
        launches += 1
    return lib


def mh_sweep(params, n1, n0, fp, fn, std_idx, u_prop, u, cfg: ModelConfig,
             trans_prob: bool, mask=None):
    """Run the sweep on given primitives in one launch. Returns (new
    params, per-row transition sums, per-row declined counts as int32), the
    sums before any all-reduce: ops/mh.py::MHParamsResult's fields."""
    rows, per_chain, m = _layout(params, fp, fn, mask, "mh_sweep")
    shape, f32, dev = tuple(params.shape), torch.float32, params.device
    for name, t in (("params", params), ("n1", n1), ("n0", n0),
                    ("u_prop", u_prop), ("u", u)):
        _build.check_tensor(t, name, f32, shape, dev)
    _build.check_tensor(std_idx, "std_idx", torch.int32, shape, dev)
    out = torch.empty_like(params)
    trans = torch.empty(shape[:-1], dtype=f32, device=dev)
    declined = torch.empty(shape[:-1], dtype=torch.int32, device=dev)
    lib = _launch(params, fp, "mh_sweep")
    rc = lib.bnpc_mh_sweep(
        params.data_ptr(), n1.data_ptr(), n0.data_ptr(), fp.data_ptr(),
        fn.data_ptr(), std_idx.data_ptr(), u_prop.data_ptr(), u.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        declined.data_ptr(), trans.data_ptr(), rows, per_chain, m,
        cfg.p - 1.0, cfg.q - 1.0, int(not cfg.beta_prior_uniform),
        int(trans_prob), torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, "bnpc_mh_sweep")
    return out, trans, declined


def realized(target, source, n1, n0, a, b, std, fp, fn, cfg: ModelConfig,
             mask=None):
    """Run the realized mode in one launch: the per-row sum of the clipped
    log-acceptance, before any all-reduce."""
    rows, per_chain, m = _layout(target, fp, fn, mask, "mh_realized")
    shape, dev = tuple(target.shape), target.device
    for name, t in (("target", target), ("source", source), ("n1", n1),
                    ("n0", n0), ("a", a), ("b", b), ("std", std)):
        _build.check_tensor(t, name, torch.float32, shape, dev)
    out = torch.empty(shape[:-1], dtype=torch.float32, device=dev)
    lib = _launch(target, fp, "mh_realized")
    rc = lib.bnpc_mh_realized(
        target.data_ptr(), source.data_ptr(), n1.data_ptr(), n0.data_ptr(),
        a.data_ptr(), b.data_ptr(), std.data_ptr(), fp.data_ptr(),
        fn.data_ptr(), None if mask is None else mask.data_ptr(),
        out.data_ptr(), rows, per_chain, m, cfg.p - 1.0, cfg.q - 1.0,
        int(not cfg.beta_prior_uniform),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, "bnpc_mh_realized")
    return out
