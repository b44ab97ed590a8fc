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
    is replayed exactly. Plain torch ops on every device.

On a CPU tensor ``lazy``, ``stream`` and ``eager`` run their kernels' plain
twins, so the CPU tests hold each path against its bnpc_tpu counterpart.
"""

from __future__ import annotations

import functools

import torch

from bnpc_tpu_torch.config import TMAX, TMIN, ModelConfig
from bnpc_tpu_torch.data import PackedData
from bnpc_tpu_torch.draws import Draws
from bnpc_tpu_torch.ops import likelihood as lk
from bnpc_tpu_torch.ops.cuda_gibbs import (lazy_k_pad, lazy_segment,
                                           resolve_stream, stream_k_pad)
from bnpc_tpu_torch.ops.cuda_stream import lazy_segment_stream
from bnpc_tpu_torch.ops.cuda_sweep import eager_sweep
from bnpc_tpu_torch.state import CRPState

NEG_INF = float("-inf")


def _sweep_keys(draws: Draws, cfg: ModelConfig):
    """The sweep's (perm, gumbel, k_beta) randomness (gibbs.py:_sweep_keys).
    Slot j's noise is gumbel[:, j]; the new-cluster option's is
    gumbel[:, k_max]."""
    k_perm, k_gumbel, k_beta = draws.split(3)
    perm = k_perm.permutation(cfg.n_cells)
    gumbel = k_gumbel.gumbel((cfg.n_cells, cfg.k_max + 1))
    return perm, gumbel, k_beta


def fresh_row(k_beta: Draws, cell: int, data: PackedData, cfg: ModelConfig):
    """Newborn parameter row for `cell` (libs/CRP.py:183-188, 291-294): an
    exact Beta(p + x, q + x0) draw, counter-keyed by the cell."""
    theta = k_beta.fold_in(cell).beta_binary(cfg.p, cfg.q, data.xm[cell],
                                             data.xm0[cell])
    return torch.clamp(theta, TMIN, TMAX).to(torch.float32)


def _birth_column(theta, slot: int, state, data, gumbel):
    f1, f0 = lk.log_prob_tables(theta, state.fp, state.fn)
    return lk.ll_col(f1, f0, data.xm, data.xm0) + gumbel[:, slot]


def _padded_sizes(state, k_pad: int):
    """[k_pad] f32 sizes row with the kernels' -1 sentinel on padded
    slots."""
    k_max = state.cluster_size.shape[0]
    return torch.cat([
        state.cluster_size.to(torch.float32),
        torch.full((k_pad - k_max,), -1.0, device=state.cluster_size.device),
    ])


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
                block: int = 0) -> CRPState:
    """One full Gibbs sweep. impl: "auto" (see resolve_impl), "lazy",
    "stream", "eager", "scan" or "blocked" (``block`` cells a block,
    default 128)."""
    impl = resolve_impl(impl, cfg, state.assignment.is_cuda)
    run = {"lazy": _lazy_impl, "stream": _stream_impl, "eager": _eager_impl,
           "scan": _scan_impl,
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
        + torch.log(alpha) - log_denom

    perm, gumbel, k_beta = _sweep_keys(draws, cfg)
    # Z-formulation: the Gumbel noise is folded into the likelihood matrix
    # up front, so the categorical draw is a plain argmax.
    c1, c0 = lk.log_prob_tables(state.params, state.fp, state.fn)
    z = lk.ll_matrix(data, c1, c0) + gumbel[:, :k_max]
    aux = new_post + gumbel[:, k_max]
    return run(state, data, cfg, perm, gumbel, k_beta, z, aux, log_denom)


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


def _scan_impl(state, data, cfg, perm, gumbel, k_beta, z, aux, log_denom):
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
            z[:, target] = _birth_column(theta, target, state, data, gumbel)
        else:
            target = int(torch.argmax(post_old))
        size[target] += 1
        assignment[cell] = target
    return state._replace(assignment=assignment, params=params,
                          cluster_size=size)


def _lazy_impl(state, data, cfg, perm, gumbel, k_beta, z, aux, log_denom):
    """Birth-lazy host loop around the segment kernel (bnpc_tpu
    _pallas_lazy_impl). The kernel reads only the PRE-SWEEP assignment of
    not-yet-visited cells, and writes targets by visit position; one
    scatter at the end puts them back in cell order."""
    n, k_max = cfg.n_cells, cfg.k_max
    dev = z.device
    k_pad = lazy_k_pad(k_max)
    z = torch.nn.functional.pad(z, (0, k_pad - k_max)).contiguous()
    sizes = _padded_sizes(state, k_pad)
    assign0 = state.assignment.contiguous()
    aux = aux.contiguous()
    log_denom = log_denom.to(torch.float32).contiguous()
    tgt_v = torch.empty((n,), dtype=torch.int32, device=dev)
    info = torch.empty((4,), dtype=torch.int32, device=dev)
    params = state.params.clone()
    i0 = 0
    while i0 < n:
        lazy_segment(z, aux, assign0, perm, sizes, tgt_v, info, i0,
                     log_denom)
        i_next, b_cell, b_slot, _ = info.tolist()  # host sync per launch
        if b_cell >= 0:
            theta = fresh_row(k_beta, b_cell, data, cfg)
            params[b_slot] = theta
            z[:, b_slot] = _birth_column(theta, b_slot, state, data, gumbel)
        i0 = i_next
    assignment = torch.empty_like(tgt_v)
    assignment[perm.long()] = tgt_v
    return state._replace(assignment=assignment, params=params,
                          cluster_size=sizes[:k_max].to(torch.int32))


def _stream_impl(state, data, cfg, perm, gumbel, k_beta, z, aux, log_denom):
    """The birth-lazy loop around the streaming kernel (bnpc_tpu
    _pallas_stream_impl): Z, aux and the pre-sweep assignment are gathered
    into visit order once per sweep; a birth at visit position p is cell
    perm[p], and its Z column is computed in cell order and gathered into
    visit order, in bnpc_tpu's order of operations."""
    n, k_max = cfg.n_cells, cfg.k_max
    dev = z.device
    k_pad = stream_k_pad(k_max)
    order = perm.long()
    zp = torch.nn.functional.pad(z[order], (0, k_pad - k_max)).contiguous()
    auxp = aux[order].contiguous()
    assignp = state.assignment[order].contiguous()
    sizes = _padded_sizes(state, k_pad)
    log_denom = log_denom.to(torch.float32).contiguous()
    tgt_v = torch.empty((n,), dtype=torch.int32, device=dev)
    info = torch.empty((4,), dtype=torch.int32, device=dev)
    params = state.params.clone()
    i0 = 0
    while i0 < n:
        lazy_segment_stream(zp, auxp, assignp, sizes, tgt_v, info, i0,
                            log_denom)
        i_next, b_pos, b_slot, _ = info.tolist()  # host sync per launch
        if b_pos >= 0:
            cell = int(perm[b_pos])
            theta = fresh_row(k_beta, cell, data, cfg)
            params[b_slot] = theta
            col = _birth_column(theta, b_slot, state, data, gumbel)
            zp[:, b_slot] = col[order]
        i0 = i_next
    assignment = torch.empty_like(tgt_v)
    assignment[order] = tgt_v
    return state._replace(assignment=assignment, params=params,
                          cluster_size=sizes[:k_max].to(torch.int32))


def _eager_impl(state, data, cfg, perm, gumbel, k_beta, z, aux, log_denom):
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
                  block):
    """Opt-in APPROXIMATE blocked sweep (bnpc_tpu _blocked_impl; no
    reference counterpart). Cells are visited in the permuted order in
    blocks of ``block``: every cell of a block decides against the cluster
    sizes frozen at block entry (minus its own membership), and the block's
    moves are applied at once. A block whose frozen pass holds a birth is
    replayed exactly, cell by cell, as ``_scan_impl`` does, with its newborn
    Z columns patched in for every later block. block=1 is the exact sweep.

    A frozen pass runs from a block to the end of the sweep as [block, k]
    tensor work per block with no host read; only its first birth block
    comes back to the host, once a pass (bnpc_tpu's scan / while_loop
    structure). The approximation and its O(block / n) bias are bnpc_tpu's
    (tests/test_blocked.py); its veto channel is not ported."""
    n, k_max = cfg.n_cells, cfg.k_max
    dev = z.device
    B = max(1, int(block))
    G = -(-n // B)
    pad = G * B - n
    order = perm.long()
    # Visit-order staging, one gather a sweep; padded positions are
    # inactive (aux -inf, assignment 0, never applied).
    z3 = torch.nn.functional.pad(z[order], (0, 0, 0, pad)).view(G, B, k_max)
    aux3 = torch.nn.functional.pad(aux[order], (0, pad),
                                   value=NEG_INF).view(G, B)
    old3 = torch.nn.functional.pad(state.assignment[order].long(),
                                   (0, pad)).view(G, B)
    act3 = (torch.arange(G * B, device=dev) < n).view(G, B)
    iota_k = torch.arange(k_max, device=dev)
    tgt3 = old3.clone()
    sizes = state.cluster_size.clone()
    params = state.params.clone()

    def frozen_pass(g0, sizes):
        """Apply blocks g0, g0+1, ... up to (not including) the first one
        whose frozen pass holds a birth; return the sizes and that block's
        index (G when none)."""
        stopped = torch.zeros((), dtype=torch.bool, device=dev)
        first = torch.full((), G, dtype=torch.long, device=dev)
        for g in range(g0, G):
            oldb, actb = old3[g], act3[g]
            oh_old = ((oldb[:, None] == iota_k) & actb[:, None]).to(
                sizes.dtype)
            sizes_excl = sizes - oh_old
            live = sizes_excl > 0
            prior = torch.log(torch.clamp(sizes_excl, min=1).to(
                torch.float32)) - log_denom
            post_old = torch.where(live, z3[g] + prior, NEG_INF)
            best, choice = torch.max(post_old, dim=1)
            has_free = (~live).any(dim=1)
            cand = (aux3[g] > best) & actb
            birth = (cand & has_free).any()
            apply = ~(stopped | birth)
            tgt = torch.where(actb, choice, oldb)
            oh_new = ((tgt[:, None] == iota_k) & actb[:, None]).to(
                sizes.dtype)
            d = oh_new.sum(0, dtype=sizes.dtype) \
                - oh_old.sum(0, dtype=sizes.dtype)
            sizes = torch.where(apply, sizes + d, sizes)
            tgt3[g] = torch.where(apply, tgt, tgt3[g])
            first = torch.where(birth & ~stopped, g, first)
            stopped = stopped | birth
        return sizes, int(first)  # one host read a pass

    def exact_block(g, sizes):
        """The exact sequential replay of block g (``_scan_impl``'s body,
        one host read a cell)."""
        olds = old3[g].tolist()
        for j in range(min(B, n - g * B)):
            sizes[olds[j]] -= 1
            live = sizes > 0
            prior = torch.log(torch.clamp(sizes, min=1).to(torch.float32)) \
                - log_denom
            post_old = torch.where(live, z3[g, j] + prior, NEG_INF)
            best, choice = torch.max(post_old, dim=0)
            # First max, as jnp.argmax over [post_old, post_new].
            is_new = (~live).any() & (aux3[g, j] > best)
            free = torch.argmax((sizes == 0).to(torch.int32))
            is_new, choice, free = torch.stack(
                [is_new.long(), choice, free]).tolist()
            target = free if is_new else choice
            if is_new:
                theta = fresh_row(k_beta, int(perm[g * B + j]), data, cfg)
                params[target] = theta
                col = _birth_column(theta, target, state, data, gumbel)
                z3.view(G * B, k_max)[:n, target] = col[order]
            sizes[target] += 1
            tgt3[g, j] = target
        return sizes

    sizes, g = frozen_pass(0, sizes)
    while g < G:
        sizes = exact_block(g, sizes)
        sizes, g = frozen_pass(g + 1, sizes)
    assignment = torch.empty_like(state.assignment)
    assignment[order] = tgt3.view(-1)[:n].to(assignment.dtype)
    return state._replace(assignment=assignment, params=params,
                          cluster_size=sizes)
