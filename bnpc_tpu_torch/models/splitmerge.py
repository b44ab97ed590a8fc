"""Non-conjugate Jain-Neal split-merge move with restricted Gibbs launch
scans (counterpart of bnpc_tpu/models/splitmerge.py; reference
libs/CRP.py:417-820).

The move is a function over fixed-shape masked tensors: the cells taking
part are a boolean mask over all n cells, the restricted 2-way assignment
``rg`` is an int vector over all n cells, and every likelihood term is a
masked matvec of sufficient statistics. The serial restricted scan runs in
the rg kernel (ops/cuda_rg.py); on the card a launch scan's per-cell work
around it (margins, visit order, counts, the scan, the new sides and their
masks, the replay's terms) is one launch of kernel 9
(ops/cuda_rg_assign.py) up to its cell cap. A branch's acceptance and its
application after the final scan are ops/cuda_sm_accept.py's stages
around torch's sums: kernel 12's launches on the card, their plain twin
on the CPU. The move counts each set of cells once: ``_rg_init``'s
product gives the move's cells and the first launch sides, each split
scan its new sides (``_RGState``); a merge alone counts its original
sides. Only the split-or-merge choice is read on the host (one
synchronization per move); the scan's s_count and count1 stay on the
device, and acceptance is applied on the device.

As in bnpc_tpu, the merge reverse path iterates the movable cells in
ascending cell-id order (a fixed order of the same restricted
conditionals; libs/CRP.py:806-818 uses its scratch-array order).

Under a sharded mutation axis (``ax``, parallel/axis.py) every sum over
mutations is all-reduced over the mutation group, the per-mutation draws
are the shard's own (``ax.fold_key``), and the prior and transition sums
skip padded columns; the rg kernel's inputs come from the all-reduced
[n, 2] launch log-likelihood, so every rank launches it on the same bits.

Every function here also takes a batch of chains (a state with a leading
chain axis, StackedDraws, ``ax`` a ChainAxis; mcmc.py's chain_exec="vmap"):
per-chain scalars become [C], cell vectors [C, n], and the restricted scans
run on kernel 9's or the rg kernel's chain grid
(ops/cuda_rg.py::rg_scan_chains), each
chain with its own s_count and count1 on the device. ``split_merge`` reads
every chain's split-or-merge choice in one [C] host read and runs the chains
that split and the chains that merge as two sub-batches, each on its own
branch (state.py::by_chain_flag); every chain draws exactly what its
one-chain move draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bnpc_tpu_torch import trace
from bnpc_tpu_torch.config import ModelConfig
from bnpc_tpu_torch.data import PackedData
from bnpc_tpu_torch.draws import Draws
from bnpc_tpu_torch.ops import likelihood as lk
from bnpc_tpu_torch.ops import cuda_rg_assign, cuda_sm_accept, mh
from bnpc_tpu_torch.ops.cuda_rg import rg_scan, rg_scan_chains
from bnpc_tpu_torch.parallel.axis import MutAxis
from bnpc_tpu_torch.state import (CRPState, beta_posterior_rows,
                                  by_chain_flag, pick_at)

NEG_INF = float("-inf")
_NO_AXIS = MutAxis()


class _MoveCtx(NamedTuple):
    """Everything fixed for the duration of one split-merge proposal."""

    is_split: bool
    cells: torch.Tensor        # [n] bool — cells taking part in the move
    s_mask: torch.Tensor       # [n] bool — cells minus the two anchors
    anchor_i: torch.Tensor     # 0-d int32 cell id (reference: cells[0])
    anchor_j: torch.Tensor     # 0-d int32 cell id (reference: cells[-1])
    cl_a: torch.Tensor         # 0-d int32 cluster of anchor_i
    cl_b: torch.Tensor         # 0-d int32 cluster of anchor_j (== cl_a split)
    n_move: torch.Tensor       # 0-d f32 |cells|
    ltrans_size: torch.Tensor  # 0-d f32 forward size-proposal log-prob term
    inv_sum_others: torch.Tensor  # 0-d f32 sum of 1/size over other clusters
    # (Under a chain axis each field gains a leading [C].)


class _RGState(NamedTuple):
    rg: torch.Tensor            # [n] int32 in {0, 1}
    params_split: torch.Tensor  # [2, m] f32
    params_merge: torch.Tensor  # [m] f32
    # Observed 1 / 0 counts (exact integers in float32) of the launch sides
    # of `rg` and of the move's cells, the latter fixed for the move.
    n1_sides: torch.Tensor      # [2, m] f32
    n0_sides: torch.Tensor      # [2, m] f32
    n1_cells: torch.Tensor      # [m] f32
    n0_cells: torch.Tensor      # [m] f32


def _data_row(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Row i of a data plane x [n, m] shared by every chain (i 0-d or
    [C])."""
    return x.index_select(0, i.reshape(-1).long()).reshape(
        tuple(i.shape) + tuple(x.shape[1:]))


def _gumbel_top2(draws: Draws, logits):
    z = logits + draws.gumbel(tuple(logits.shape))
    first = torch.argmax(z, dim=-1)
    second = torch.argmax(z.scatter(-1, first[..., None], NEG_INF), dim=-1)
    return first.to(torch.int32), second.to(torch.int32)


def _masked_counts(mask_f32, data: PackedData):
    """(n1, n0) each [..., m]: observed 1/0 counts over the cells in
    `mask` (exact integers in float32, so one product serves a batch)."""
    return mask_f32 @ data.xm, mask_f32 @ data.xm0


def _side_masks(ctx: _MoveCtx, rg):
    """f32 cell masks of launch side 0 (incl anchor i) and side 1 (incl j)."""
    idx = torch.arange(rg.shape[-1], device=rg.device)
    side0 = (ctx.s_mask & (rg == 0)) | (idx == ctx.anchor_i[..., None])
    side1 = (ctx.s_mask & (rg == 1)) | (idx == ctx.anchor_j[..., None])
    return side0.to(torch.float32), side1.to(torch.float32)


# ---------------------------------------------------------------------------
# Proposal setup (do_split_move / do_merge_move, libs/CRP.py:434-524)
# ---------------------------------------------------------------------------


def _setup(draws: Draws, state: CRPState, cfg: ModelConfig,
           is_split: bool, ax: MutAxis = _NO_AXIS) -> _MoveCtx:
    n = cfg.n_cells
    dev = state.assignment.device
    idx = torch.arange(n, device=dev)
    size_f = state.cluster_size.to(torch.float32)
    live = state.cluster_size > 0
    k_cl, k_anchor_i, k_anchor_j = draws.split(3)

    if is_split:
        # One size-weighted cluster with >= 2 cells (libs/CRP.py:441-445).
        split_logits = torch.where(state.cluster_size >= 2,
                                   torch.log(torch.clamp(size_f, min=1.0)),
                                   NEG_INF)
        cl = k_cl.categorical(split_logits)
        members = state.assignment == cl[..., None]
        anchor_i, anchor_j = _gumbel_top2(
            k_anchor_i, torch.where(members, 0.0, NEG_INF))
        size = pick_at(size_f, cl)
        # Eq. 3 second term (libs/CRP.py:453-456).
        ltrans = torch.log(size / n) - torch.log(size) - torch.log(size - 1.0)
        slot_idx = torch.arange(cfg.k_max, device=dev)
        inv_others = ax.sum(torch.where(
            live & (slot_idx != cl[..., None]),
            1.0 / torch.clamp(size_f, min=1.0), 0.0))
        cells, cl_a, cl_b = members, cl, cl
    else:
        # Two inverse-size-weighted clusters.
        inv = torch.where(live, 1.0 / torch.clamp(size_f, min=1.0), 0.0)
        inv_sum = ax.sum(inv)
        merge_logits = torch.where(
            live, torch.log(torch.clamp(inv, min=1e-30)), NEG_INF)
        cl_a, cl_b = _gumbel_top2(k_cl, merge_logits)
        members_a = state.assignment == cl_a[..., None]
        members_b = state.assignment == cl_b[..., None]
        anchor_i = k_anchor_i.categorical(
            torch.where(members_a, 0.0, NEG_INF))
        anchor_j = k_anchor_j.categorical(
            torch.where(members_b, 0.0, NEG_INF))
        # Eq. 6 second term (libs/CRP.py:505-507).
        ltrans = (torch.log(pick_at(inv, cl_a) / inv_sum)
                  + torch.log(pick_at(inv, cl_b) / inv_sum)
                  - torch.log(pick_at(size_f, cl_a))
                  - torch.log(pick_at(size_f, cl_b)))
        cells = members_a | members_b
        # read by splits only
        inv_others = torch.zeros(tuple(live.shape[:-1]), device=dev)

    s_mask = cells & (idx != anchor_i[..., None]) \
        & (idx != anchor_j[..., None])
    return _MoveCtx(
        is_split=is_split, cells=cells, s_mask=s_mask,
        anchor_i=anchor_i, anchor_j=anchor_j, cl_a=cl_a, cl_b=cl_b,
        n_move=cells.sum(-1).to(torch.float32), ltrans_size=ltrans,
        inv_sum_others=inv_others,
    )


# ---------------------------------------------------------------------------
# Launch state (run_rg_nc steps 3.x, libs/CRP.py:527-567)
# ---------------------------------------------------------------------------


def _rg_init(draws: Draws, ctx: _MoveCtx, state: CRPState, data: PackedData,
             cfg: ModelConfig, ax: MutAxis = _NO_AXIS) -> _RGState:
    k_i, k_j, k_m = ax.fold_key(draws).split(3)
    mix0, _ = cfg.beta_mix
    mask = data.mask

    # Likelihood-based initial split: score every cell against the anchors'
    # own (noise-imputed) genotypes (libs/CRP.py:547-561). The comparison
    # ll_j > ll_i is taken as ONE product over the table differences: where
    # the anchors' rows hold the same values in other columns, the two sums
    # are equal in exact arithmetic but round differently in any other
    # summation order, while the difference's terms cancel exactly. Sharded,
    # the one product is all-reduced and the reduced value compared.
    def anchor_tables(a):
        th = torch.where(_data_row(mask, a) > 0, _data_row(data.x, a), mix0)
        return lk.log_prob_tables(th, state.fp, state.fn)

    (c1i, c0i), (c1j, c0j) = (anchor_tables(ctx.anchor_i),
                              anchor_tables(ctx.anchor_j))
    rg = (ax.psum(ax.rmul(data.xm, c1j - c1i)
                  + ax.rmul(data.xm0, c0j - c0i)) > 0).to(torch.int32)

    # The split pair's rows and the merge row from their Beta posteriors:
    # the three rows' counts in one product, then their draws in the order
    # k_i, k_j, k_m (one launch of kernel 8 on the card). The move keeps the
    # counts: the cells' for every merge scan and both branches, the sides'
    # until a launch scan replaces them.
    side0, side1 = _side_masks(ctx, rg)
    n1, n0 = _masked_counts(torch.stack(
        [side0, side1, ctx.cells.to(torch.float32)], dim=-2), data)
    rows = beta_posterior_rows((k_i, k_j, k_m), cfg, n1, n0)
    return _RGState(rg, rows[..., :2, :], rows[..., 2, :], n1[..., :2, :],
                    n0[..., :2, :], n1[..., 2, :], n0[..., 2, :])


def _visit_order(k_perm: Draws, s_mask, rg_launch, ll2, dz):
    """Visit order for a restricted scan plus visit-order payloads: a
    uniform random permutation with the move's cells FIRST (their relative
    order uniform over S, libs/CRP.py:616), so "movable" in visit order is
    simply position < s_count. Sorted by (not-in-S, 64 random bits), stable,
    as bnpc_tpu's variadic lax.sort.

    Returns (order, lau_v, ll0_v, ll1_v, dz_v)."""
    bits = k_perm.bits(tuple(s_mask.shape[:-1]) + (2, s_mask.shape[-1]))
    # The two uint32 words as one order-preserving signed 64-bit key.
    key = (bits[..., 0, :] - 2**31) * 2**32 + bits[..., 1, :]
    order = torch.sort(key, stable=True).indices
    order = torch.gather(order, -1, torch.sort(
        (~torch.gather(s_mask, -1, order)).to(torch.int8),
        stable=True).indices)

    def visit(x):
        return torch.gather(x, -1, order)

    return (order.to(torch.int32), visit(rg_launch).to(torch.float32),
            visit(ll2[..., 0]), visit(ll2[..., 1]), visit(dz))


def _side1_others(final, launch):
    """Movable cells on side 1, other than the one at each position, when
    a scan reaches it: the final sides of the positions before it plus the
    launch sides of the positions after it (both [n] f32, 0 outside S)."""
    before = torch.cumsum(final, -1) - final
    after = torch.flip(torch.cumsum(torch.flip(launch, (-1,)), -1), (-1,)) \
        - launch
    return before + after


def _trans_prob_terms(ctx: _MoveCtx, lau_v, fin_v, ll0_v, ll1_v, s_count,
                      dp_alpha):
    """Chosen log-probability of each visit position of a completed
    restricted scan, 0 from s_count on. Given the launch and final sides
    the count evolution is deterministic, so the sequential accumulation of
    libs/CRP.py:622-630 is prefix/suffix sums in visit order."""
    n = lau_v.shape[-1]
    in_s = (torch.arange(n, device=lau_v.device) < s_count[..., None]).to(
        torch.float32)
    s1 = _side1_others(fin_v.to(torch.float32) * in_s, lau_v * in_s)
    n_j = s1 + 1.0
    n_i = ctx.n_move[..., None] - s1 - 2.0
    log_denom = torch.log(ctx.n_move - 1.0 + dp_alpha)[..., None]
    lp0 = ll0_v + torch.log(n_i) - log_denom
    lp1 = ll1_v + torch.log(n_j) - log_denom
    mx = torch.maximum(lp0, lp1)
    lse = mx + torch.log(torch.exp(lp0 - mx) + torch.exp(lp1 - mx))
    chosen = torch.where(fin_v > 0, lp1, lp0) - lse
    # where, not multiply: non-movable positions can hold nan/-inf rows.
    return torch.where(in_s > 0.0, chosen, 0.0)


def _assign_composed(ctx: _MoveCtx, rg, ll2, gumbel, k_perm: Draws,
                     dp_alpha, trans_prob: bool):
    """A launch scan after its Gumbel noise and likelihood product, as torch
    ops around kernel 2 (the definition of kernel 9, ops/cuda_rg_assign.py):
    the margins, the visit order (drawn from `k_perm`), the count
    log-table, the scan, the new sides. Returns (rg, (side0, side1) of rg,
    the replay's chosen terms by visit position or None unless
    `trans_prob`)."""
    n = ctx.s_mask.shape[-1]
    dev = ll2.device
    z = ll2 + gumbel
    dz = z[..., 1] - z[..., 0]
    order, lau_v, ll0_v, ll1_v, dz_v = _visit_order(
        k_perm, ctx.s_mask, rg, ll2, dz)

    s1r = torch.arange(n + 2, dtype=torch.float32, device=dev)
    dtab = torch.log(s1r + 1.0) - torch.log(torch.clamp(
        ctx.n_move[..., None] - s1r - 2.0, min=0.0))
    s_count = ctx.s_mask.sum(-1).to(torch.int32)
    count1 = torch.where(ctx.s_mask, rg, 0).sum(-1).to(torch.int32)
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    lau_i = lau_v.to(torch.int32)

    scan = rg_scan_chains if dz_v.dim() == 2 else rg_scan
    out_v = scan(dz_v.contiguous(), lau_i, dtab, s_count, count1)
    fin_v = torch.where(pos < s_count[..., None], out_v, lau_i)
    fin_cell = torch.empty_like(fin_v).scatter_(-1, order.long(), fin_v)
    rg_new = torch.where(ctx.s_mask, fin_cell, rg)
    chosen = (_trans_prob_terms(ctx, lau_v, fin_v, ll0_v, ll1_v, s_count,
                                dp_alpha) if trans_prob else None)
    return rg_new, _side_masks(ctx, rg_new), chosen


def _rg_scan_assign(draws: Draws, ctx: _MoveCtx, rg, params_split,
                    state: CRPState, data: PackedData, cfg: ModelConfig,
                    trans_prob: bool, ax: MutAxis = _NO_AXIS):
    """Sequential restricted 2-way Gibbs over the non-anchor cells
    (_rg_scan_assign, libs/CRP.py:609-632). Returns (rg, sum of chosen
    log-probabilities; 0 unless `trans_prob`, (side0, side1) of rg as
    _side_masks gives them).

    With hoisted Gumbel noise, side 1 wins iff dz + log(n_j) - log(n_i) > 0
    with dz = (ll2[:,1]+g1) - (ll2[:,0]+g0); the count logs are the table
    dtab[s1], +inf where side i would empty (the reference's
    lp0 = ll0 + log(0) = -inf, libs/CRP.py:622).

    On the card, up to cuda_rg_assign.MAX_CELLS cells, everything after
    the draws and the likelihood product, up to the sum of the chosen
    terms, is one launch of kernel 9 (ops/cuda_rg_assign.py); elsewhere
    its definition, _assign_composed, runs."""
    n = cfg.n_cells
    k_perm, k_gumbel = draws.split(2)
    shape = tuple(ctx.n_move.shape) + (n, 2)
    fused = cuda_rg_assign.fits(rg.device, n)
    if fused:
        noise = cuda_rg_assign.noise(k_gumbel, shape)
    else:
        gumbel = k_gumbel.gumbel(shape)
    c1, c0 = lk.log_prob_tables(params_split, state.fp, state.fn)  # [2, m]
    ll2 = ax.psum(ax.rmul(data.xm, c1.mT)
                  + ax.rmul(data.xm0, c0.mT))  # [n, 2]
    if fused:
        bits = k_perm.bits(tuple(ctx.s_mask.shape[:-1]) + (2, n))
        rg_new, sides, chosen = cuda_rg_assign.rg_assign(
            noise, bits, ll2.contiguous(), ctx.s_mask, rg,
            ctx.anchor_i, ctx.anchor_j, ctx.n_move, state.dp_alpha,
            trans_prob)
        sides = sides.unbind(-2)
    else:
        rg_new, sides, chosen = _assign_composed(
            ctx, rg, ll2, gumbel, k_perm, state.dp_alpha, trans_prob)
    prob = (ax.sum(chosen) if trans_prob
            else torch.zeros(tuple(ctx.n_move.shape), device=ll2.device))
    return rg_new, prob, sides


def _rg_scan_split(draws: Draws, ctx, rgs: _RGState, state, data, cfg,
                   trans_prob: bool, ax: MutAxis = _NO_AXIS):
    """One launch scan of the split configuration (libs/CRP.py:570-606).
    Returns (state, with the new sides and their counts; transition
    sum)."""
    k_assign, k_par = draws.split(2)
    rg, prob_cl, (side0, side1) = _rg_scan_assign(
        k_assign, ctx, rgs.rg, rgs.params_split, state, data, cfg,
        trans_prob, ax)
    n1 = torch.stack([side0 @ data.xm, side1 @ data.xm], dim=-2)
    n0 = torch.stack([side0 @ data.xm0, side1 @ data.xm0], dim=-2)
    res = mh.mh_cluster_params(k_par, rgs.params_split, n1, n0, state.fp,
                               state.fn, cfg, trans_prob=trans_prob, ax=ax)
    return rgs._replace(rg=rg, params_split=res.params, n1_sides=n1,
                        n0_sides=n0), prob_cl + ax.sum(res.trans_logprob)


def _rg_scan_merge(draws: Draws, ctx, rgs: _RGState, state, data, cfg,
                   trans_prob: bool, ax: MutAxis = _NO_AXIS):
    """One launch scan of the merge configuration (libs/CRP.py:581-587)."""
    res = mh.mh_cluster_params(draws, rgs.params_merge, rgs.n1_cells,
                               rgs.n0_cells, state.fp, state.fn, cfg,
                               trans_prob=trans_prob, ax=ax)
    return rgs._replace(params_merge=res.params), res.trans_logprob


# ---------------------------------------------------------------------------
# The branches (libs/CRP.py:641-820)
# ---------------------------------------------------------------------------


def _split_branch(k_f1, k_f2, k_accept, ctx, rgs, state, data, cfg, ax):
    """Split acceptance (libs/CRP.py:641-653) and its application."""
    # Final scan to the proposal state, with transition probabilities.
    rgs2, gs_split = _rg_scan_split(k_f1, ctx, rgs, state, data, cfg, True,
                                    ax)
    return _split_accept(k_f2, k_accept, ctx, rgs2, gs_split, state, cfg, ax)


def _split_accept(k_f2, k_accept, ctx, rgs2, gs_split, state, cfg, ax):
    """A split's acceptance and application after its final scan (`rgs2`,
    transition sum `gs_split`): ops/cuda_sm_accept.py, kernel 12 on the
    card and its plain twin on the CPU, on the reverse proposal's std
    index and the acceptance uniform."""
    prims = cuda_sm_accept.primitives(
        ax.fold_key(k_f2), k_accept, rgs2.params_merge.shape,
        ctx.n_move.shape, False, state.assignment.device)
    return cuda_sm_accept.split(prims, ctx, rgs2, gs_split, state, cfg, ax)


def _merge_branch(k_f1, k_f2, k_accept, ctx, rgs, state, data, cfg, ax):
    """Merge acceptance (libs/CRP.py:656-665) and its application."""
    # Forward: one more merge scan with transition probabilities (eq. 16).
    rgs2, gs_merge = _rg_scan_merge(k_f1, ctx, rgs, state, data, cfg, True,
                                    ax)
    return _merge_accept(k_f2, k_accept, ctx, rgs2, gs_merge, state, data,
                         cfg, ax)


def _merge_accept(k_f2, k_accept, ctx, rgs2, gs_merge, state, data, cfg,
                  ax):
    """A merge's acceptance and application after its final merge scan
    (`rgs2`, transition sum `gs_merge`), as :func:`_split_accept`; the
    reverse split's replay (_rg_get_split_prob, libs/CRP.py:777-820) is
    the wrapper's."""
    prims = cuda_sm_accept.primitives(
        ax.fold_key(k_f2), k_accept, rgs2.params_split.shape,
        ctx.n_move.shape, True, state.assignment.device)
    return cuda_sm_accept.merge(prims, ctx, rgs2, gs_merge, state, data, cfg,
                                ax)


def _move(is_split: bool, keys, state: CRPState, data: PackedData,
          cfg: ModelConfig, sm_steps: int, ax: MutAxis = _NO_AXIS):
    """The proposal, its launch scans and its branch, for chains that all
    split or all merge; keys = (k_setup, k_init, k_scans, k_final,
    k_accept)."""
    k_setup, k_init, k_scans, k_final, k_accept = keys
    ctx = _setup(k_setup, state, cfg, is_split, ax)
    rgs = _rg_init(k_init, ctx, state, data, cfg, ax)

    # Launch scans (libs/CRP.py:535-537): each refreshes both the split and
    # the merge configuration.
    for kk in k_scans.split(sm_steps):
        k1, k2 = kk.split(2)
        rgs, _ = _rg_scan_split(k1, ctx, rgs, state, data, cfg, False, ax)
        rgs, _ = _rg_scan_merge(k2, ctx, rgs, state, data, cfg, False, ax)

    k_f1, k_f2 = k_final.split(2)
    branch = _split_branch if is_split else _merge_branch
    return branch(k_f1, k_f2, k_accept, ctx, rgs, state, data, cfg, ax)


def sm_choice(k_move: Draws, state: CRPState, cfg: ModelConfig,
              sm_split_ratio: float) -> torch.Tensor:
    """Whether each chain splits ([] bool, [C] under a chain axis): a split
    with probability sm_split_ratio, forced at one cluster; a merge forced
    at k_max clusters."""
    n_clusters = state.n_clusters
    forced_split = n_clusters == 1
    # Reference forces a merge at K == n (libs/CRP.py:424); with a capacity
    # cap a split is likewise impossible at K == k_max.
    forced_merge = n_clusters >= cfg.k_max
    want_split = k_move.uniform(n_clusters.shape) < sm_split_ratio
    return forced_split | (want_split & ~forced_merge)


def split_merge(draws: Draws, state: CRPState, data: PackedData,
                cfg: ModelConfig, sm_split_ratio: float, sm_steps: int,
                ax: MutAxis = _NO_AXIS):
    """One split-merge proposal. Returns (state, counts[2, 2]) where
    counts[0] = (accepted, declined) split deltas and counts[1] the merge
    deltas (MH_counter rows 1/2, libs/MCMC.py:320-328). Under a chain axis
    every chain makes its own proposal and counts are [C, 2, 2]. mcmc.py's
    captured block runs ``sm_choice`` and ``_move`` as graphs around the
    same host read."""
    k_move, *keys = draws.split(6)
    split = sm_choice(k_move, state, cfg, sm_split_ratio)
    # The host sync: one read a move.
    flags = trace.read(split.reshape(-1), "split")
    if trace.on:
        trace.note_split(flags)

    def move(is_split, sub, sub_ax, take, idx):
        return _move(is_split, [take(k) for k in keys], sub, data, cfg,
                     sm_steps, sub_ax)

    return by_chain_flag(state, flags, lambda: split, move, ax)
