"""The split-merge move's acceptance and its application: kernel 12 on the
card, its plain twin on the CPU, behind one interface.

:func:`split` and :func:`merge` compute what models/splitmerge.py's
``_split_branch`` and ``_merge_branch`` do after their final scan: the
reverse proposal's std and bounds, the likelihood terms of the split and
merged rows, the Beta prior terms, for a merge the forced replay of the
original sides (_rg_get_split_prob, libs/CRP.py:777-820), the MH ratio,
the decision and the application (the assignment, sizes, parameter rows
and [2, 2] MH counts). They run in stages: two a split, three a merge.
Between the stages every float sum is a torch call (``ax.sum``,
``ax.psum``), the realized transition sums are
``mh.realized_trans_logprob`` (kernel 7 on the card), and a merge's replay
likelihood and the counts of its original sides are torch products, so a
sharded mutation axis all-reduces them. On the card the stages are
csrc/sm_accept.cu's launches (``KERNEL``); on the CPU they are the plain
twin (``TWIN``), torch ops that round each value as the kernel does, so
the kernel is held to the twin bit for bit on the card and the twin to
bnpc_tpu on the CPU.

Interface: one chain's move (0-d per-chain scalars, [n] cells) or a
batch's (a leading chain axis C), as ``_MoveCtx``, ``_RGState`` and
``CRPState`` hold them. The counts are the move's own: the final scan's
side counts (a split), the last launch scan's (a merge), the move's cells'
(``_rg_init``); only a merge's original sides are counted here.

The draws are the provider's: :func:`primitives` draws the reverse
proposal's std index, then the acceptance uniform. On the card it takes a
TorchDraws, or a StackedDraws of them, and raises for any other provider
before any draw (``draws.replays``).
"""

from __future__ import annotations

import ctypes
import functools
import types

import torch

from bnpc_tpu_torch.config import TMAX, TMIN, ModelConfig
from bnpc_tpu_torch.draws import replays
from bnpc_tpu_torch.ops import _build, mh
from bnpc_tpu_torch.ops import distributions as dist
from bnpc_tpu_torch.ops import likelihood as lk
from bnpc_tpu_torch.parallel.axis import MutAxis
from bnpc_tpu_torch.state import first_free_slot, pick_at, row_at

_NO_AXIS = MutAxis()

# Kernel launches since the last reset (each stage adds one): one-chain
# launches, and batched launches with their count per number of chains.
launches = 0
chain_launches = 0
chain_grids: dict[int, int] = {}

# csrc/sm_accept.cu's Args, in order: pointers, then numbers.
POINTERS = (
    "anchor_i", "anchor_j", "cl_a", "cl_b", "n_move", "ltrans",
    "inv_others", "alpha", "fp", "fn", "u", "s_mask", "rg", "assign",
    "params", "sizes", "ps", "pm", "n1s", "n0s", "n1c", "n0c", "n1o", "n0o",
    "ll2", "std_idx", "mask", "gs_fwd", "real0", "real1", "ll_split",
    "ll_all", "chosen_sum", "beta0_sum", "beta1_sum", "beta2_sum", "std",
    "a", "b", "target", "c1t", "c0t", "sides", "t0", "t1", "tm", "beta0",
    "beta1", "beta2", "chosen", "assign_out", "sizes_out", "params_out",
    "counts_out")


class Args(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_void_p) for name in POINTERS]
                + [(name, ctypes.c_int) for name in (
                    "n", "m", "k", "chains", "cell_blocks", "chunk")]
                + [(name, ctypes.c_float) for name in (
                    "pm1", "qm1", "log_norm")]
                + [("beta_prior", ctypes.c_int),
                   ("neg_log_n", ctypes.c_float)])


def fits(device) -> bool:
    """True where the kernel runs: every device but the CPU."""
    return torch.device(device).type != "cpu"


def primitives(k_std, k_accept, shape, lead, merge: bool, device):
    """The std index (int32, `shape`, the reverse proposal's rows) from
    `k_std` (a merge's first split of it), then the acceptance uniform
    (`lead`) from `k_accept`. On a device the kernel runs on (:func:`fits`)
    raises for a provider other than TorchDraws or a StackedDraws of them
    (``draws.replays``), before any split or draw."""
    for d in (k_std, k_accept):
        if fits(device) and not (replays(d, "randint")
                                 and replays(d, "uniform")):
            raise ValueError(f"sm_accept: {type(d).__name__} is not a "
                             "TorchDraws or a StackedDraws of them: the "
                             "kernel cannot replay its draws")
    if merge:
        k_std = k_std.split(2)[0]
    return (k_std.randint(tuple(shape), 0, len(mh.PARAM_PROPOSAL_SD)),
            k_accept.uniform(tuple(lead)))


@functools.lru_cache(maxsize=None)
def neg_log_n(n: int) -> float:
    """_merge_branch's -log(n), which torch computes on the host."""
    return (-torch.log(torch.tensor(float(n)))).item()


def _inputs(prims, ctx, rgs, state, split: bool) -> dict:
    """The move's tensors by their Args names, after the checks of their
    dtypes, shapes and device (a ValueError or TypeError before any
    launch)."""
    std_idx, u = prims
    lead = tuple(ctx.n_move.shape)
    if len(lead) > 1 or state.params.dim() != len(lead) + 2:
        raise ValueError(f"sm_accept: n_move {lead} is neither one chain's "
                         "nor a batch's")
    n = state.assignment.shape[-1]
    k, m = state.params.shape[-2:]
    dev = state.assignment.device
    f32, i32 = torch.float32, torch.int32
    rows = lead + (m,) if split else lead + (2, m)
    x = dict(anchor_i=ctx.anchor_i, anchor_j=ctx.anchor_j, cl_a=ctx.cl_a,
             cl_b=ctx.cl_b, n_move=ctx.n_move, ltrans=ctx.ltrans_size,
             inv_others=ctx.inv_sum_others, alpha=state.dp_alpha,
             fp=state.fp, fn=state.fn, u=u, s_mask=ctx.s_mask, rg=rgs.rg,
             assign=state.assignment, params=state.params,
             sizes=state.cluster_size, ps=rgs.params_split,
             pm=rgs.params_merge, n1s=rgs.n1_sides, n0s=rgs.n0_sides,
             n1c=rgs.n1_cells, n0c=rgs.n0_cells, std_idx=std_idx)
    # A shard's views (a sharded mutation axis) become dense rows.
    x = {name: t.contiguous() for name, t in x.items()}
    shapes = dict(s_mask=(torch.bool, lead + (n,)), rg=(i32, lead + (n,)),
                  assign=(i32, lead + (n,)), params=(f32, lead + (k, m)),
                  sizes=(i32, lead + (k,)), ps=(f32, lead + (2, m)),
                  pm=(f32, lead + (m,)), n1s=(f32, lead + (2, m)),
                  n0s=(f32, lead + (2, m)), n1c=(f32, lead + (m,)),
                  n0c=(f32, lead + (m,)), std_idx=(i32, rows))
    for name in ("anchor_i", "anchor_j", "cl_a", "cl_b"):
        shapes[name] = (i32, lead)
    for name in ("n_move", "ltrans", "inv_others", "alpha", "fp", "fn",
                 "u"):
        shapes[name] = (f32, lead)
    for name, (dtype, shape) in shapes.items():
        _build.check_tensor(x[name], name, dtype, shape, dev)
    return x


def _check_sum(s, like, name):
    _build.check_tensor(s, name, torch.float32, tuple(like.shape),
                        like.device)


def _stages(state):
    return KERNEL if fits(state.assignment.device) else TWIN


def _sum(ax, t):
    return ax.psum(ax.sum(t))


def split(prims, ctx, rgs, gs_split, state, cfg: ModelConfig,
          ax: MutAxis = _NO_AXIS, stages=None):
    """A split's acceptance and application after its final scan (`rgs`
    its state, `gs_split` its transition sum) on drawn primitives
    (:func:`primitives`), in `stages` (by default the kernel's on the card,
    the twin's on the CPU). Returns (state, counts [..., 2, 2])."""
    st = stages or _stages(state)
    x = _inputs(prims, ctx, rgs, state, True)
    _check_sum(gs_split, x["n_move"], "gs_fwd")
    p = st.split_terms(x, cfg, ax)
    real = mh.realized_trans_logprob(
        p["target"], x["pm"], x["n1c"], x["n0c"], p["a"], p["b"], p["std"],
        x["fp"], x["fn"], cfg, ax)
    s = dict(gs_fwd=gs_split, real0=real,
             ll_split=ax.psum(ax.sum(p["t0"]) + ax.sum(p["t1"])),
             ll_all=_sum(ax, p["tm"]))
    if not cfg.beta_prior_uniform:
        s.update(beta0_sum=_sum(ax, p["beta0"]),
                 beta1_sum=_sum(ax, p["beta1"]))
    for name, v in s.items():
        _check_sum(v, x["n_move"], name)
    out = st.split_apply(x, p, s, cfg)
    return state._replace(assignment=out["assign_out"],
                          params=out["params_out"],
                          cluster_size=out["sizes_out"]), out["counts_out"]


def merge(prims, ctx, rgs, gs_merge, state, data, cfg: ModelConfig,
          ax: MutAxis = _NO_AXIS, stages=None):
    """A merge's acceptance and application after its final merge scan
    (`rgs`, `gs_merge`) on drawn primitives, as :func:`split`. Returns
    (state, counts)."""
    st = stages or _stages(state)
    x = _inputs(prims, ctx, rgs, state, False)
    _check_sum(gs_merge, x["n_move"], "gs_fwd")
    p = st.merge_terms(x, cfg, ax)
    # The replay's likelihood of every cell under the original rows, and
    # the counts of the original sides (exact integers).
    ll2 = ax.psum(ax.rmul(data.xm, p["c1t"].mT)
                  + ax.rmul(data.xm0, p["c0t"].mT))
    n1o, n0o = p["sides"] @ data.xm, p["sides"] @ data.xm0
    real = [mh.realized_trans_logprob(
        p["target"][..., r, :], x["ps"][..., r, :], x["n1s"][..., r, :],
        x["n0s"][..., r, :], p["a"][..., r, :], p["b"][..., r, :],
        p["std"][..., r, :], x["fp"], x["fn"], cfg, ax) for r in (0, 1)]
    st.merge_cells(x, p, ll2.contiguous(), n1o, n0o, cfg)
    s = dict(gs_fwd=gs_merge, real0=real[0], real1=real[1],
             chosen_sum=ax.sum(p["chosen"]),
             ll_split=ax.psum(ax.sum(p["t0"]) + ax.sum(p["t1"])),
             ll_all=_sum(ax, p["tm"]))
    if not cfg.beta_prior_uniform:
        s.update({f"beta{i}_sum": _sum(ax, p[f"beta{i}"]) for i in range(3)})
    for name, v in s.items():
        _check_sum(v, x["n_move"], name)
    out = st.merge_apply(x, p, s, cfg)
    return state._replace(assignment=out["assign_out"],
                          params=out["params_out"],
                          cluster_size=out["sizes_out"]), out["counts_out"]


# ---------------------------------------------------------------------------
# The kernel's stages
# ---------------------------------------------------------------------------


def _empty(x, shape, dtype=torch.float32):
    return torch.empty(tuple(x["n_move"].shape) + tuple(shape), dtype=dtype,
                       device=x["n_move"].device)


def launch(stage, p):
    """Launch stage `stage` on the Args of the move's planes `p`."""
    if p["_dev"].type != "cuda":
        raise ValueError(f"sm_accept: unsupported device {p['_dev']}")
    global launches, chain_launches
    lead = p["_lead"]
    if lead:
        chain_launches += 1
        chain_grids[lead[0]] = chain_grids.get(lead[0], 0) + 1
    else:
        launches += 1
    lib = _build.load_library()
    args = p["_args"]
    rc = lib.bnpc_sm_accept(stage, ctypes.addressof(args),
                            torch.cuda.current_stream(p["_dev"]).cuda_stream)
    _build.check_launch(rc, f"bnpc_sm_accept stage {stage}")


def _point(args, tensors):
    for name, t in tensors.items():
        setattr(args, name, t.data_ptr())


def _prepare(x, p, cfg, ax):
    """The Args of a move: its inputs and planes `p`; the numbers."""
    n = x["assign"].shape[-1]
    k, m = x["params"].shape[-2:]
    lead = tuple(x["n_move"].shape)
    if ax.mask is not None:
        _build.check_tensor(ax.mask, "mask", torch.float32, (m,),
                            x["assign"].device)
    args = Args(n=n, m=m, k=k, chains=lead[0] if lead else 1,
                pm1=cfg.p - 1.0, qm1=cfg.q - 1.0,
                log_norm=cfg.log_beta_norm,
                beta_prior=int(not cfg.beta_prior_uniform),
                neg_log_n=neg_log_n(cfg.n_cells))
    _point(args, x)
    _point(args, p)
    if ax.mask is not None:
        args.mask = ax.mask.data_ptr()
    p.update(_args=args, _lead=lead, _dev=x["assign"].device)
    return p


def _apply(x, p, s, stage):
    """Stage 1 or 4 on the sums `s`: the new state."""
    out = dict(assign_out=torch.empty_like(x["assign"]),
               sizes_out=torch.empty_like(x["sizes"]),
               params_out=torch.empty_like(x["params"]),
               counts_out=_empty(x, (2, 2), torch.int32))
    _point(p["_args"], s)
    _point(p["_args"], out)
    launch(stage, p)
    return out


def _kernel_split_terms(x, cfg, ax):
    m = x["params"].shape[-1]
    p = {name: _empty(x, (m,)) for name in ("std", "a", "b", "target", "t0",
                                            "t1", "tm")}
    if not cfg.beta_prior_uniform:
        p.update(beta0=_empty(x, (2, m)), beta1=_empty(x, (m,)))
    launch(0, _prepare(x, p, cfg, ax))
    return p


def _kernel_merge_terms(x, cfg, ax):
    n = x["assign"].shape[-1]
    m = x["params"].shape[-1]
    p = {name: _empty(x, (2, m)) for name in ("std", "a", "b", "target",
                                              "c1t", "c0t")}
    p.update(sides=_empty(x, (2, n)), chosen=_empty(x, (n,)),
             **{name: _empty(x, (m,)) for name in ("t0", "t1", "tm")})
    if not cfg.beta_prior_uniform:
        p.update({f"beta{i}": _empty(x, (m,)) for i in range(3)})
    launch(2, _prepare(x, p, cfg, ax))
    return p


def _kernel_merge_cells(x, p, ll2, n1o, n0o, cfg):
    n = x["assign"].shape[-1]
    m = x["params"].shape[-1]
    lead = tuple(x["n_move"].shape)
    dev = x["assign"].device
    _build.check_tensor(ll2, "ll2", torch.float32, lead + (n, 2), dev)
    for name, t in (("n1o", n1o), ("n0o", n0o)):
        _build.check_tensor(t, name, torch.float32, lead + (2, m), dev)
    _point(p["_args"], dict(ll2=ll2, n1o=n1o, n0o=n0o))
    launch(3, p)


KERNEL = types.SimpleNamespace(
    split_terms=_kernel_split_terms,
    split_apply=lambda x, p, s, cfg: _apply(x, p, s, 1),
    merge_terms=_kernel_merge_terms, merge_cells=_kernel_merge_cells,
    merge_apply=lambda x, p, s, cfg: _apply(x, p, s, 4))


# ---------------------------------------------------------------------------
# The plain twin: the kernel's stages as torch ops, the CPU's route
# ---------------------------------------------------------------------------


def _beta(cfg, v, ax):
    return ax.apply_mask(dist.beta_logpdf(v, cfg.p, cfg.q,
                                          cfg.log_beta_norm))


def _terms(x, n1, n0):
    """The likelihood terms of sides 0 and 1 (counts `n1`, `n0` [..., 2,
    m]) under the split pair, and of the move's cells under the merged
    row."""
    c1s, c0s = lk.log_prob_tables(x["ps"], x["fp"], x["fn"])
    c1m, c0m = lk.log_prob_tables(x["pm"], x["fp"], x["fn"])
    return dict(
        t0=n1[..., 0, :] * c1s[..., 0, :] + n0[..., 0, :] * c0s[..., 0, :],
        t1=n1[..., 1, :] * c1s[..., 1, :] + n0[..., 1, :] * c0s[..., 1, :],
        tm=x["n1c"] * c1m + x["n0c"] * c0m)


def _counts(row, accept):
    acc = accept.to(torch.int32)
    pair = torch.stack([acc, 1 - acc], dim=-1)
    zero = torch.zeros_like(pair)
    return torch.stack([pair, zero] if row == 0 else [zero, pair], dim=-2)


def _twin_split_terms(x, cfg, ax):
    # Reverse: merge-launch -> the original single cluster (eq. 15).
    std = mh.choose(x["std_idx"], mh.PARAM_PROPOSAL_SD)
    target = row_at(x["params"], x["cl_a"])
    p = dict(std=std, a=(TMIN - x["pm"]) / std, b=(TMAX - x["pm"]) / std,
             target=target, **_terms(x, x["n1s"], x["n0s"]))
    if not cfg.beta_prior_uniform:
        p.update(beta0=_beta(cfg, x["ps"], ax), beta1=_beta(cfg, target, ax))
    return p


def _twin_split_apply(x, p, s, cfg):
    count = torch.where(x["s_mask"], x["rg"], 0).sum(-1)
    n_move = x["n_move"]
    n_j = count.to(torch.float32) + 1.0
    n_i = n_move - n_j
    # Eq. 7 prior ratio (libs/CRP.py:695-713).
    lprior = (torch.log(x["alpha"]) - torch.lgamma(n_move)
              + torch.lgamma(n_j) + torch.lgamma(n_i))
    if not cfg.beta_prior_uniform:
        lprior = lprior + s["beta0_sum"] - s["beta1_sum"]
    # Eq. 5 size-proposal ratio (libs/CRP.py:757-764).
    norm = x["inv_others"] + 1.0 / n_i + 1.0 / n_j
    rev = -torch.log(n_i * norm) - torch.log(n_j * norm)
    A = ((s["real0"] - s["gs_fwd"]) + lprior + (s["ll_split"] - s["ll_all"])
         + (rev - x["ltrans"]))
    # Degenerate launch: every movable cell on one side (libs/CRP.py:647-648).
    s_count = n_move - 2.0
    degenerate = (s_count > 0) & ((n_j - 1.0 == 0.0)
                                  | (n_j - 1.0 == s_count))
    accept = (~degenerate) & (torch.log(x["u"]) < A)

    # Apply: side 1 moves to a fresh slot (libs/CRP.py:466-481).
    n, (k, m) = x["assign"].shape[-1], x["params"].shape[-2:]
    dev = x["assign"].device
    new_slot = first_free_slot(x["sizes"])
    cell = torch.arange(n, device=dev)
    side1 = (x["s_mask"] & (x["rg"] == 1)) | (cell == x["anchor_j"][..., None])
    assign = torch.where(accept[..., None] & side1, new_slot[..., None],
                         x["assign"])
    moved = torch.where(accept, count + 1, 0)[..., None]
    slot = torch.arange(k, device=dev)
    sizes = (x["sizes"] - torch.where(slot == x["cl_a"][..., None], moved, 0)
             + torch.where(slot == new_slot[..., None], moved, 0))
    row = slot[:, None]
    take = accept[..., None, None]
    params = torch.where(take & (row == new_slot[..., None, None]),
                         x["ps"][..., 1:2, :], x["params"])
    params = torch.where(take & (row == x["cl_a"][..., None, None]),
                         x["ps"][..., 0:1, :], params)
    return dict(assign_out=assign, sizes_out=sizes.to(torch.int32),
                params_out=params, counts_out=_counts(0, accept))


def _twin_merge_terms(x, cfg, ax):
    std = mh.choose(x["std_idx"], mh.PARAM_PROPOSAL_SD)
    target = torch.stack([row_at(x["params"], x["cl_a"]),
                          row_at(x["params"], x["cl_b"])], dim=-2)
    c1t, c0t = lk.log_prob_tables(target, x["fp"], x["fn"])
    n = x["assign"].shape[-1]
    cell = torch.arange(n, device=x["assign"].device)
    orig1 = x["assign"] != x["cl_a"][..., None]
    in_s = x["s_mask"]
    sides = torch.stack(
        [(in_s & ~orig1) | (cell == x["anchor_i"][..., None]),
         (in_s & orig1) | (cell == x["anchor_j"][..., None])],
        dim=-2).to(torch.float32)
    # Bounds 0/1 here, not TMIN/TMAX: the reference's quirk (libs/CRP.py:
    # 779-780).
    p = dict(std=std, a=(0.0 - x["ps"]) / std, b=(1.0 - x["ps"]) / std,
             target=target, c1t=c1t, c0t=c0t, sides=sides)
    if not cfg.beta_prior_uniform:
        p.update(beta0=_beta(cfg, x["pm"], ax),
                 beta1=_beta(cfg, target[..., 0, :], ax),
                 beta2=_beta(cfg, target[..., 1, :], ax))
    return p


def _twin_merge_cells(x, p, ll2, n1o, n0o, cfg):
    in_s = x["s_mask"]
    orig1 = x["assign"] != x["cl_a"][..., None]
    # Side 1 among the other movable cells: original sides before a cell,
    # launch sides after it (integer counts, as the kernel's block scans).
    f1 = (in_s & orig1).to(torch.int64)
    f2 = (in_s & (x["rg"] == 1)).to(torch.int64)
    others = (torch.cumsum(f1, -1) - f1 + f2.sum(-1, keepdim=True)
              - torch.cumsum(f2, -1)).to(torch.float32)
    n_move = x["n_move"]
    n_j = others + 1.0
    n_i = n_move[..., None] - others - 2.0
    log_denom = torch.log(n_move - 1.0 + x["alpha"])
    logpost = ll2 + torch.log(torch.stack([n_i, n_j], dim=-1)) \
        - log_denom[..., None, None]
    # torch.logsumexp's composite.
    mx = logpost.amax(-1, keepdim=True)
    mx = torch.where(mx.abs() == float("inf"), 0.0, mx)
    lse = torch.log(torch.exp(logpost - mx).sum(-1, keepdim=True)) + mx
    chosen = torch.gather(logpost - lse, -1, orig1.long()[..., None])[..., 0]
    # where, not multiply: a forced side count can be 0 (chosen = -inf).
    p["chosen"] = torch.where(in_s, chosen, 0.0)
    p.update(_terms(x, n1o, n0o))


def _twin_merge_apply(x, p, s, cfg):
    sizes = x["sizes"]
    size_f = sizes.to(torch.float32)
    n_i, n_j = pick_at(size_f, x["cl_a"]), pick_at(size_f, x["cl_b"])
    n_move = x["n_move"]
    gs_split = s["real0"] + s["real1"] + s["chosen_sum"]
    # Eq. 8 prior ratio over the original clusters (libs/CRP.py:736-754).
    lprior = (torch.lgamma(n_move) - torch.log(x["alpha"])
              - torch.lgamma(n_i) - torch.lgamma(n_j))
    if not cfg.beta_prior_uniform:
        lprior = lprior + s["beta0_sum"] - s["beta1_sum"] - s["beta2_sum"]
    # Eq. 6 size ratio (libs/CRP.py:767-774); the log(|S| - 1) term is
    # dropped when |S| <= 1 (the reference's FloatingPointError fallback).
    s_count = n_move - 2.0
    rev = neg_log_n(cfg.n_cells) - torch.where(
        s_count - 1.0 > 0.0,
        torch.log(torch.clamp(s_count - 1.0, min=1e-30)), 0.0)
    A = ((gs_split - s["gs_fwd"]) + lprior + (s["ll_all"] - s["ll_split"])
         + (rev - x["ltrans"]))
    accept = torch.log(x["u"]) < A

    k = sizes.shape[-1]
    cl_a, cl_b = x["cl_a"][..., None], x["cl_b"][..., None]
    assign = torch.where(accept[..., None] & (x["assign"] == cl_b), cl_a,
                         x["assign"])
    size_b = pick_at(sizes, x["cl_b"])
    slot = torch.arange(k, device=sizes.device)
    out = torch.where(slot == cl_a, sizes + torch.where(
        accept, size_b, 0)[..., None], sizes)
    out = torch.where(slot == cl_b, torch.where(accept, 0, size_b)[..., None],
                      out)
    params = torch.where(accept[..., None, None]
                         & (slot[:, None] == cl_a[..., None]),
                         x["pm"][..., None, :], x["params"])
    return dict(assign_out=assign, sizes_out=out.to(torch.int32),
                params_out=params, counts_out=_counts(1, accept))


TWIN = types.SimpleNamespace(
    split_terms=_twin_split_terms, split_apply=_twin_split_apply,
    merge_terms=_twin_merge_terms, merge_cells=_twin_merge_cells,
    merge_apply=_twin_merge_apply)
