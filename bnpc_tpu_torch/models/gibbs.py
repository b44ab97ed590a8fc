"""Sequential per-cell Gibbs sweep (counterpart of bnpc_tpu/models/gibbs.py).

Reference: update_assignments_Gibbs (libs/CRP.py:254-288). The sweep is
sequential over a random permutation. Four implementations share the same
hoisted randomness (permutation, Gumbel noise folded into the likelihood
matrix Z, counter-based newborn rows drawn from ``fold_in(cell)``) and give
the same result:

  * ``lazy`` — the lazy-birth host loop around the resident segment kernel
    (ops/cuda_gibbs.py::lazy_segment): the kernel walks the cells and exits
    at a cluster birth; the loop draws that cell's newborn Beta row,
    patches one Z column and one params row, and relaunches. Launches per
    sweep = births + 1, and each launch costs one host read of its info.
    The default on CUDA while Z is at most 13 MiB and k_max <= 1024.
  * ``stream`` — the same loop around the streaming segment kernel
    (ops/cuda_stream.py::lazy_segment_stream), with Z, aux and the
    assignment gathered into visit order once per sweep, so rows stream
    from device memory in order. The default on CUDA above that size
    (ops/cuda_gibbs.py::resolve_stream, bnpc_tpu's rule).
  * ``eager`` — every newborn row drawn up front and the [n, n] likelihood
    of every cell under every newborn row computed as one product; one
    launch of the whole-sweep kernel (ops/cuda_sweep.py::eager_sweep)
    patches births in-kernel. No host read.
  * ``scan`` — a plain sequential loop with the semantics of bnpc_tpu's
    ``_scan_impl``. The default on the CPU.
  * ``blocked`` — the opt-in APPROXIMATE blocked sweep (bnpc_tpu's
    ``_blocked_impl``; ``MCMCConfig.gibbs_block``): cells decide in blocks
    against frozen cluster sizes, and a block that would birth a cluster
    is replayed exactly. Plain torch ops on every device, batched too.

On a CPU tensor ``lazy``, ``stream`` and ``eager`` run their kernels' plain
twins, so the CPU tests hold each path against its bnpc_tpu counterpart.

A batch of chains (a state with a leading chain axis, StackedDraws, ``ax``
a ChainAxis; mcmc.py's chain_exec="vmap") runs ``lazy`` and ``stream`` as
rounds of one launch of the kernel on a grid of one block a chain, in the
loop one chain runs on a grid of one (``_segment_impl``): after each round
one host read of info [C, 4], the rows and Z columns of that round's
births, and the next round. Chain c
draws and patches what its one-chain sweep does, in the same order, so it
gets its one-chain sweep's result; a batch takes max over c of
(births_c + 1) rounds. ``blocked`` runs its frozen passes on every chain at
once and replays every chain's birth block in one loop over its cells
(``_blocked_impl``). ``scan`` loops its one-chain sweep over the chains.
``eager`` has no batched form and raises.

Under a sharded mutation axis (``ax``, parallel/axis.py) Z and every birth
column are all-reduced before a kernel or a loop reads them, so each rank of
the mutation group runs the same sweep on the same bits; the newborn rows
are drawn from the shard's own stream on its own columns. ``lazy``,
``stream``, ``scan`` and ``blocked`` run sharded; ``eager`` is
unsharded-only, as in bnpc_tpu (gibbs.py:160-164).
"""

from __future__ import annotations

import functools

import torch

from bnpc_tpu_torch.config import TMAX, TMIN, ModelConfig
from bnpc_tpu_torch.data import PackedData
from bnpc_tpu_torch.draws import Draws
from bnpc_tpu_torch.ops import likelihood as lk
from bnpc_tpu_torch.ops.cuda_gibbs import (lazy_k_pad, lazy_segment,
                                           lazy_segment_chains,
                                           resolve_stream, stream_k_pad)
from bnpc_tpu_torch.ops.cuda_stream import (lazy_segment_stream,
                                            lazy_segment_stream_chains)
from bnpc_tpu_torch.ops.cuda_sweep import eager_sweep
from bnpc_tpu_torch.parallel.axis import MutAxis
from bnpc_tpu_torch.state import CRPState, stack_states, unstack_states

NEG_INF = float("-inf")
_NO_AXIS = MutAxis()


def _sweep_keys(draws: Draws, cfg: ModelConfig, ax: MutAxis = _NO_AXIS,
                lead=()):
    """The sweep's (perm, gumbel, k_beta) randomness (gibbs.py:_sweep_keys).
    Slot j's noise is gumbel[..., j]; the new-cluster option's is
    gumbel[..., k_max]. The newborn rows' draws are the shard's own.
    `lead` is the chain axis' shape ((C,) for a batch)."""
    k_perm, k_gumbel, k_beta = draws.split(3)
    perm = k_perm.permutation(cfg.n_cells)
    gumbel = k_gumbel.gumbel(tuple(lead) + (cfg.n_cells, cfg.k_max + 1))
    return perm, gumbel, ax.fold_key(k_beta)


def fresh_row(k_beta: Draws, cell: int, data: PackedData, cfg: ModelConfig):
    """Newborn parameter row for `cell` (libs/CRP.py:183-188, 291-294): an
    exact Beta(p + x, q + x0) draw, counter-keyed by the cell."""
    theta = k_beta.fold_in(cell).beta_binary(cfg.p, cfg.q, data.xm[cell],
                                             data.xm0[cell])
    return torch.clamp(theta, TMIN, TMAX).to(torch.float32)


def _birth_column(theta, slot: int, fp, fn, data, gumbel, ax):
    f1, f0 = lk.log_prob_tables(theta, fp, fn)
    return lk.ll_col(f1, f0, data.xm, data.xm0, ax) + gumbel[:, slot]


def _padded_sizes(state, k_pad: int):
    """[..., k_pad] f32 sizes rows with the kernels' -1 sentinel on padded
    slots."""
    size = state.cluster_size
    k_max = size.shape[-1]
    return torch.cat([
        size.to(torch.float32),
        torch.full(tuple(size.shape[:-1]) + (k_pad - k_max,), -1.0,
                   device=size.device),
    ], dim=-1)


def resolve_impl(impl: str, cfg: ModelConfig, on_cuda: bool) -> str:
    """"auto" as bnpc_tpu's "auto_single" resolves it: on CUDA the
    streaming kernel where resolve_stream(cfg), else the resident one; on
    the CPU the scan."""
    if impl != "auto":
        return impl
    if not on_cuda:
        return "scan"
    return "stream" if resolve_stream(cfg) else "lazy"


def gibbs_sweep(draws: Draws, state: CRPState, data: PackedData,
                cfg: ModelConfig, impl: str = "auto",
                block: int = 0, ax: MutAxis = _NO_AXIS) -> CRPState:
    """One full Gibbs sweep. impl: "auto" (see resolve_impl), "lazy",
    "stream", "eager", "scan" or "blocked" (``block`` cells a block,
    default 128). `data` and the params are this rank's mutation columns
    when `ax` is sharded."""
    impl = resolve_impl(impl, cfg, state.assignment.is_cuda)
    batched = state.assignment.dim() == 2
    if batched and impl == "eager":
        # bnpc_tpu falls back to its scan here with a warning
        # (bnpc_tpu/models/gibbs.py:201-212); the port does not switch
        # implementation quietly.
        raise ValueError("impl='eager' has no batched-chains form; under "
                         "chain_exec='vmap' the sweep runs 'lazy', 'stream', "
                         "'scan' or 'blocked' (use chain_exec='sequential')")
    if impl == "eager" and ax.sharded:
        # bnpc_tpu runs its eager kernel unsharded only (gibbs.py:160-164):
        # its [n, n] newborn product would need an all-reduce of n^2 floats
        # a sweep, and its explicit route sums shard-local columns.
        raise ValueError("impl='eager' cannot run under a sharded mutation "
                         "axis; use 'lazy', 'stream', 'scan' or 'blocked'")
    run = {"lazy": functools.partial(_segment_impl, stream=False),
           "stream": functools.partial(_segment_impl, stream=True),
           "eager": _eager_impl,
           "scan": _scan_chains if batched else _scan_impl,
           "blocked": functools.partial(_blocked_impl,
                                        block=block or 128)}.get(impl)
    if run is None:
        raise ValueError(f"unknown Gibbs impl {impl!r}")
    if impl == "eager":
        _check_eager_fits(cfg, state.assignment.device)
    n, k_max = cfg.n_cells, cfg.k_max
    alpha = state.dp_alpha
    log_denom = torch.log(n - 1.0 + alpha)
    new_post = lk.new_cluster_ll(data, cfg, state.fp, state.fn) \
        + torch.log(alpha)[..., None] - log_denom[..., None]

    perm, gumbel, k_beta = _sweep_keys(draws, cfg, ax, alpha.shape)
    # Z-formulation: the Gumbel noise is folded into the likelihood matrix
    # up front, so the categorical draw is a plain argmax.
    c1, c0 = lk.log_prob_tables(state.params, state.fp, state.fn)
    z = lk.ll_matrix(data, c1, c0, ax) + gumbel[..., :k_max]
    aux = new_post + gumbel[..., k_max]
    return run(state, data, cfg, perm, gumbel, k_beta, z, aux, log_denom,
               ax=ax)


def _check_eager_fits(cfg: ModelConfig, device) -> None:
    """The eager sweep's [n, n] product must fit in the free device memory;
    raise (never switch implementation) when it does not."""
    if device.type != "cuda":
        return
    need = 4 * cfg.n_cells * cfg.n_cells
    free, _ = torch.cuda.mem_get_info(device)
    if need > free:
        raise ValueError(
            f"impl='eager' needs the [{cfg.n_cells}, {cfg.n_cells}] newborn "
            f"likelihood product ({need / 2**30:.2f} GiB) but {device} has "
            f"{free / 2**30:.2f} GiB free; use impl='stream' or 'lazy'")


def _scan_impl(state, data, cfg, perm, gumbel, k_beta, z, aux, log_denom,
               ax=_NO_AXIS):
    """Plain sequential sweep (bnpc_tpu _scan_impl semantics)."""
    assignment = state.assignment.clone()
    params = state.params.clone()
    size = state.cluster_size.clone()
    z = z.clone()
    for cell in perm.tolist():
        # Remove the cell from its cluster (libs/CRP.py:262-266).
        size[assignment[cell]] -= 1
        live = size > 0
        prior = torch.log(torch.clamp(size, min=1).to(torch.float32)) \
            - log_denom
        post_old = torch.where(live, z[cell] + prior, NEG_INF)
        has_free = bool((~live).any())
        # First max, as jnp.argmax over [post_old, post_new].
        is_new = has_free and bool(aux[cell] > post_old.max())
        if is_new:
            target = int(torch.argmax((size == 0).to(torch.int32)))
            theta = fresh_row(k_beta, cell, data, cfg)
            params[target] = theta
            z[:, target] = _birth_column(theta, target, state.fp, state.fn,
                                         data, gumbel, ax)
        else:
            target = int(torch.argmax(post_old))
        size[target] += 1
        assignment[cell] = target
    return state._replace(assignment=assignment, params=params,
                          cluster_size=size)


def _segment_impl(state, data, cfg, perm, gumbel, k_beta, z, aux,
                  log_denom, ax=_NO_AXIS, *, stream: bool):
    """The birth-lazy host loop around the resident segment kernel (bnpc_tpu
    _pallas_lazy_impl) or, with `stream`, the streaming one (bnpc_tpu
    _pallas_stream_impl), for one chain or a batch of chains.

    The kernel reads only the PRE-SWEEP assignment of not-yet-visited cells
    and writes targets by visit position; one scatter at the end puts them
    back in cell order. The streaming kernel takes Z, aux and the pre-sweep
    assignment gathered into visit order once per sweep; a birth at visit
    position p is cell perm[p], and its Z column is computed in cell order
    and gathered into visit order, in bnpc_tpu's order of operations.

    One chain is run as a batch of one on the one-chain wrapper, whose
    start position is a host int; a batch launches the kernel on a grid of
    one block a chain, each chain's start position on the device (i0s), so a
    relaunch takes no host arguments. Each round is one launch and one host
    read of info [C, 4]; every birth of the round is then drawn from its
    chain's own draws and patched (``fresh_row``, ``_birth_column``) in
    chain order, as its one-chain sweep does."""
    one = state.assignment.dim() == 1
    if one:
        state = CRPState(*(f[None] for f in state))
        perm, gumbel, z, aux, log_denom = (
            x[None] for x in (perm, gumbel, z, aux, log_denom))
        k_betas, mut = [k_beta], ax
    else:
        k_betas, mut = k_beta.chains, ax.mut
    n, k_max = cfg.n_cells, cfg.k_max
    c_all, dev = z.shape[0], z.device
    order = perm.long()
    if stream:
        k_pad = stream_k_pad(k_max)
        zin = torch.nn.functional.pad(
            torch.take_along_dim(z, order[..., None], dim=-2),
            (0, k_pad - k_max)).contiguous()
        args = (zin, torch.gather(aux, -1, order).contiguous(),
                torch.gather(state.assignment, -1, order).contiguous())
        launch = lazy_segment_stream if one else lazy_segment_stream_chains
    else:
        k_pad = lazy_k_pad(k_max)
        zin = torch.nn.functional.pad(z, (0, k_pad - k_max)).contiguous()
        args = (zin, aux.contiguous(), state.assignment.contiguous(),
                perm.contiguous())
        launch = lazy_segment if one else lazy_segment_chains
    sizes = _padded_sizes(state, k_pad)
    log_denom = log_denom.to(torch.float32).contiguous()
    tgt_v = torch.empty((c_all, n), dtype=torch.int32, device=dev)
    info = torch.empty((c_all, 4), dtype=torch.int32, device=dev)
    i0s = None if one else torch.zeros((c_all,), dtype=torch.int32,
                                       device=dev)
    params = state.params.clone()
    rows, perm_h = [[0]], None
    while True:
        if one:
            launch(*(a[0] for a in args), sizes[0], tgt_v[0], info[0],
                   rows[0][0], log_denom[0])
        else:
            launch(*args, sizes, tgt_v, info, i0s, log_denom)
        rows = info.tolist()  # one host read a round
        for c, (_, b, slot, _) in enumerate(rows):
            if b < 0:
                continue
            if stream and perm_h is None:
                perm_h = perm.tolist()
            cell = perm_h[c][b] if stream else b
            theta = fresh_row(k_betas[c], cell, data, cfg)
            params[c, slot] = theta
            col = _birth_column(theta, slot, state.fp[c], state.fn[c], data,
                                gumbel[c], mut)
            zin[c, :, slot] = col[order[c]] if stream else col
        if all(r[0] >= n for r in rows):
            break
    assignment = torch.empty_like(tgt_v).scatter_(-1, order, tgt_v)
    state = state._replace(assignment=assignment, params=params,
                           cluster_size=sizes[..., :k_max].to(torch.int32))
    return CRPState(*(f[0] for f in state)) if one else state


def _scan_chains(state, data, cfg, perm, gumbel, k_beta, z, aux, log_denom,
                 ax=_NO_AXIS):
    """The batched ``scan``: each chain's one-chain scan in turn."""
    return stack_states([
        _scan_impl(st, data, cfg, perm[c], gumbel[c], k_beta.chains[c], z[c],
                   aux[c], log_denom[c], ax.mut)
        for c, st in enumerate(unstack_states(state))])


def _eager_impl(state, data, cfg, perm, gumbel, k_beta, z, aux, log_denom,
                ax=_NO_AXIS):
    """The whole-sweep kernel (bnpc_tpu _pallas_impl): every newborn row
    drawn up front, the [n, n] likelihood of every cell under every newborn
    row as one product (left to torch.matmul, as bnpc_tpu leaves it to
    XLA), and one launch that patches births in-kernel."""
    k_max = cfg.k_max
    k_pad = stream_k_pad(k_max)
    fresh = k_beta.fresh_rows(cfg.p, cfg.q, data.xm, data.xm0)
    f1, f0 = lk.log_prob_tables(fresh, state.fp, state.fn)
    lf = lk.ll_matrix(data, f1, f0).contiguous()  # [n, n]
    pad = (0, k_pad - k_max)
    zp = torch.nn.functional.pad(z, pad).contiguous()
    gum = torch.nn.functional.pad(gumbel[:, :k_max], pad).contiguous()
    assignment, sizes, params = eager_sweep(
        zp, gum, lf, fresh.contiguous(), aux.contiguous(),
        state.assignment.contiguous(), perm.contiguous(),
        _padded_sizes(state, k_pad), state.params.contiguous(),
        log_denom.to(torch.float32).contiguous())
    return state._replace(assignment=assignment, params=params,
                          cluster_size=sizes[:k_max].to(torch.int32))


def _blocked_impl(state, data, cfg, perm, gumbel, k_beta, z, aux, log_denom,
                  block, ax=_NO_AXIS):
    """Opt-in APPROXIMATE blocked sweep (bnpc_tpu _blocked_impl; no
    reference counterpart), for one chain or a batch of chains. Cells are
    visited in the permuted order in blocks of ``block``: every cell of a
    block decides against the cluster sizes frozen at block entry (minus
    its own membership), and the block's moves are applied at once. A
    block whose frozen pass holds a birth is replayed exactly, cell by
    cell, as ``_scan_impl`` does, with its newborn Z columns patched in for
    every later block. block=1 is the exact sweep.

    A frozen pass runs from a block to the end of the sweep as [C, block, k]
    tensor work per block with no host read; only each chain's first birth
    block comes back to the host, one [C] read a pass (bnpc_tpu's scan /
    while_loop structure). Every chain then replays its birth block in one
    loop over the block's cells, one host read a cell, each birth drawn
    from its chain's own draws and patched in chain order; the next pass
    starts each chain after its own replayed block. A chain whose sweep has
    ended stays as it is while the others go on, so chain c gets its
    one-chain sweep (bnpc_tpu's vmapped while_loop runs each chain to its
    own end). One chain runs as a batch of one. The approximation and its
    O(block / n) bias are bnpc_tpu's (tests/test_blocked.py); its veto
    channel is not ported."""
    one = state.assignment.dim() == 1
    if one:
        state = CRPState(*(f[None] for f in state))
        perm, gumbel, z, aux, log_denom = (
            x[None] for x in (perm, gumbel, z, aux, log_denom))
        k_betas, mut = [k_beta], ax
    else:
        k_betas, mut = k_beta.chains, ax.mut
    n, k_max = cfg.n_cells, cfg.k_max
    c_all, dev = z.shape[0], z.device
    B = max(1, int(block))
    G = -(-n // B)
    pad = G * B - n
    order = perm.long()
    # Visit-order staging, one gather a sweep; padded positions are
    # inactive (aux -inf, assignment 0, never applied).
    z3 = torch.nn.functional.pad(
        torch.take_along_dim(z, order[..., None], dim=1), (0, 0, 0, pad))
    aux3 = torch.nn.functional.pad(torch.gather(aux, 1, order), (0, pad),
                                   value=NEG_INF)
    old3 = torch.nn.functional.pad(
        torch.gather(state.assignment, 1, order).long(), (0, pad))
    act3 = (torch.arange(G * B, device=dev) < n).view(G, B)
    iota_k = torch.arange(k_max, device=dev)
    tgt3 = old3.clone()
    sizes = state.cluster_size.clone()
    params = state.params.clone()
    ld = log_denom.to(torch.float32)[:, None]
    z4, aux4, old4, tgt4 = (x.view((c_all, G, B) + x.shape[2:])
                            for x in (z3, aux3, old3, tgt3))
    perm_h = None

    def frozen_pass(g0, g_lo, sizes):
        """Apply each chain's blocks g0[c], g0[c] + 1, ... up to (not
        including) its first one whose frozen pass holds a birth; return
        the sizes and each chain's such block (G when none). A chain with
        g0[c] = G stays as it is."""
        stopped = torch.zeros((c_all,), dtype=torch.bool, device=dev)
        first = torch.full((c_all,), G, dtype=torch.long, device=dev)
        for g in range(g_lo, G):
            on = g0 <= g
            oldb = old4[:, g]
            actb = act3[g] & on[:, None]
            oh_old = ((oldb[..., None] == iota_k) & actb[..., None]).to(
                sizes.dtype)
            sizes_excl = sizes[:, None] - oh_old
            live = sizes_excl > 0
            prior = torch.log(torch.clamp(sizes_excl, min=1).to(
                torch.float32)) - ld[..., None]
            post_old = torch.where(live, z4[:, g] + prior, NEG_INF)
            best, choice = torch.max(post_old, dim=-1)
            has_free = (~live).any(dim=-1)
            birth = ((aux4[:, g] > best) & actb & has_free).any(dim=-1)
            apply = on & ~(stopped | birth)
            tgt = torch.where(actb, choice, oldb)
            oh_new = ((tgt[..., None] == iota_k) & actb[..., None]).to(
                sizes.dtype)
            # Exact integer counts: batched, in any order.
            d = oh_new.sum(1, dtype=sizes.dtype) \
                - oh_old.sum(1, dtype=sizes.dtype)
            sizes = torch.where(apply[:, None], sizes + d, sizes)
            tgt4[:, g] = torch.where(apply[:, None], tgt, tgt4[:, g])
            first = torch.where(birth & ~stopped, g, first)
            stopped = stopped | birth
        return sizes, first

    def exact_blocks(first, first_h, sizes):
        """The exact sequential replay (``_scan_impl``'s body) of block
        first[c] of each chain c that has one, every such chain in one loop
        over the block's cells, one host read a cell."""
        nonlocal perm_h
        rep = first < G
        base = torch.clamp(first, max=G - 1) * B
        for j in range(B):
            on_h = [f < G and f * B + j < n for f in first_h]
            if not any(on_h):
                break
            pos = (base + j)[:, None]
            on = (rep & (pos[:, 0] < n))[:, None].to(sizes.dtype)
            sizes = sizes.scatter_add(1, torch.gather(old3, 1, pos), -on)
            live = sizes > 0
            prior = torch.log(torch.clamp(sizes, min=1).to(torch.float32)) \
                - ld
            zrow = torch.take_along_dim(z3, pos[..., None], dim=1)[:, 0]
            post_old = torch.where(live, zrow + prior, NEG_INF)
            best, choice = torch.max(post_old, dim=-1)
            # First max, as jnp.argmax over [post_old, post_new].
            is_new = (~live).any(dim=-1) \
                & (torch.gather(aux3, 1, pos)[:, 0] > best)
            free = torch.argmax((sizes == 0).to(torch.int32), dim=-1)
            new_h, free_h = torch.stack([is_new.long(), free]).tolist()
            for c in range(c_all):  # births in chain order
                if not (on_h[c] and new_h[c]):
                    continue
                if perm_h is None:
                    perm_h = perm.tolist()
                slot = free_h[c]
                theta = fresh_row(k_betas[c], perm_h[c][first_h[c] * B + j],
                                  data, cfg)
                params[c, slot] = theta
                col = _birth_column(theta, slot, state.fp[c], state.fn[c],
                                    data, gumbel[c], mut)
                z3[c, :n, slot] = col[order[c]]
            target = torch.where(is_new, free, choice)[:, None]
            sizes = sizes.scatter_add(1, target, on)
            tgt3.scatter_(1, pos, torch.where(on > 0, target,
                                              torch.gather(tgt3, 1, pos)))
        return sizes

    g0 = torch.zeros((c_all,), dtype=torch.long, device=dev)
    g_lo = 0
    while True:
        sizes, first = frozen_pass(g0, g_lo, sizes)
        first_h = first.tolist()  # one host read a pass
        if min(first_h) >= G:
            break
        sizes = exact_blocks(first, first_h, sizes)
        g0 = torch.where(first < G, first + 1, G)
        g_lo = min(first_h) + 1
    assignment = torch.empty_like(state.assignment).scatter_(
        1, order, tgt3[:, :n].to(state.assignment.dtype))
    state = state._replace(assignment=assignment, params=params,
                           cluster_size=sizes)
    return CRPState(*(f[0] for f in state)) if one else state
