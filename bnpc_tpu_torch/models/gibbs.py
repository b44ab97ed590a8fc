"""Sequential per-cell Gibbs sweep (counterpart of bnpc_tpu/models/gibbs.py).

Reference: update_assignments_Gibbs (libs/CRP.py:254-288). The sweep is
sequential over a random permutation. Four implementations share the same
hoisted randomness (permutation, Gumbel noise folded into the likelihood
matrix Z, counter-based newborn rows drawn from ``fold_in(cell)``) and give
the same result:

  * ``lazy`` — the lazy-birth host loop around the resident segment kernel
    (ops/cuda_gibbs.py::lazy_segment_chains, on a grid of one block a
    chain): the kernel walks the cells and exits at a cluster birth; the
    loop draws that cell's newborn Beta row, patches one Z column and one
    params row, and relaunches. Launches per sweep = births + 1, and each
    launch costs one host read of its info. The default on CUDA while Z is
    at most 13 MiB and k_max <= 1024.
  * ``stream`` — the same loop around the streaming segment kernel
    (ops/cuda_stream.py::lazy_segment_stream_chains), with Z, aux and the
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

The ``lazy`` and ``stream`` loop is written as pieces that make no host
read (``segment_start``, ``segment_births``, ``segment_finish``, over the
device buffers of a ``SegmentWork``) between the loop's reads of each
round's info (``segment_rounds``). ``gibbs_sweep`` runs them in order;
mcmc.py's captured block runs the same pieces as CUDA graphs. So is the
``blocked`` sweep (``blocked_start``, ``blocked_pass``, ``blocked_cell``,
``blocked_births``, ``blocked_finish`` over a ``BlockedWork``, between
``blocked_rounds``' reads: one a frozen pass, one a replayed cell), and
the ``eager`` sweep is one such piece (``_eager_impl``).

A batch of chains (a state with a leading chain axis, StackedDraws, ``ax``
a ChainAxis; mcmc.py's chain_exec="vmap") runs ``lazy`` and ``stream`` as
rounds of one launch of the kernel on a grid of one block a chain, in the
loop one chain runs on a grid of one: after each round one host read of
[C, 6] (info, each birth's cell and kernel 1's full picks), the rows and
Z columns of that round's births, and the next round. Chain c draws and
patches what its one-chain sweep does, in the same order, so it gets its
one-chain sweep's result; a batch takes max over c of (births_c + 1)
rounds. ``blocked`` runs its frozen passes on every chain at once and
replays every chain's birth block in one loop over its cells
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

from typing import NamedTuple

import torch

from bnpc_tpu_torch import trace
from bnpc_tpu_torch.config import TMAX, TMIN, ModelConfig
from bnpc_tpu_torch.data import PackedData
from bnpc_tpu_torch.draws import Draws
from bnpc_tpu_torch.ops import likelihood as lk
from bnpc_tpu_torch.ops.cuda_gibbs import (lazy_k_pad, lazy_segment_chains,
                                           resolve_stream, stream_k_pad)
from bnpc_tpu_torch.ops.cuda_stream import lazy_segment_stream_chains
from bnpc_tpu_torch.ops.cuda_sweep import eager_sweep
from bnpc_tpu_torch.parallel.axis import MutAxis
from bnpc_tpu_torch.state import CRPState, stack_states, unstack_states

NEG_INF = float("-inf")
_NO_AXIS = MutAxis()


def _split_sweep_keys(draws: Draws, ax: MutAxis = _NO_AXIS):
    """The sweep's (k_perm, k_gumbel, k_beta) keys (gibbs.py:_sweep_keys's
    split); the newborn rows' key is the shard's own. No draw."""
    k_perm, k_gumbel, k_beta = draws.split(3)
    return k_perm, k_gumbel, ax.fold_key(k_beta)


def _sweep_keys(draws: Draws, cfg: ModelConfig, ax: MutAxis = _NO_AXIS,
                lead=()):
    """The sweep's (perm, gumbel, k_beta) randomness (gibbs.py:_sweep_keys).
    Slot j's noise is gumbel[..., j]; the new-cluster option's is
    gumbel[..., k_max]. The newborn rows' draws are the shard's own.
    `lead` is the chain axis' shape ((C,) for a batch)."""
    k_perm, k_gumbel, k_beta = _split_sweep_keys(draws, ax)
    perm = k_perm.permutation(cfg.n_cells)
    gumbel = k_gumbel.gumbel(tuple(lead) + (cfg.n_cells, cfg.k_max + 1))
    return perm, gumbel, k_beta


def fresh_row(k_beta: Draws, cell: int, data: PackedData, cfg: ModelConfig,
              at=None):
    """Newborn parameter row for `cell` (libs/CRP.py:183-188, 291-294): an
    exact Beta(p + x, q + x0) draw, counter-keyed by the cell. `at`, a [1]
    device index, takes the data row on the device instead of at the host
    int `cell`, which then only keys the draw (``fold_in``; a TorchDraws
    ignores it, so a captured birth may hold a stale one)."""
    if at is None:
        xm, xm0 = data.xm[cell], data.xm0[cell]
    else:
        xm, xm0 = data.xm.index_select(0, at)[0], \
            data.xm0.index_select(0, at)[0]
    theta = k_beta.fold_in(cell).beta_binary(cfg.p, cfg.q, xm, xm0)
    return torch.clamp(theta, TMIN, TMAX).to(torch.float32)


def _birth_column(theta, slot: int, fp, fn, data, gumbel, ax):
    """Slot `slot`'s newborn Z column."""
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
                cfg: ModelConfig, ax: MutAxis = _NO_AXIS,
                impl: str = "auto", block: int = 0) -> CRPState:
    """One full Gibbs sweep, bnpc_tpu's argument order (without its
    `interpret` and `return_veto`). impl: "auto" (see resolve_impl),
    "lazy", "stream", "eager", "scan" or "blocked" (``block`` cells a
    block, default 128). `data` and the params are this rank's mutation
    columns when `ax` is sharded."""
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
    if impl in ("lazy", "stream"):
        return _segment_impl(draws, state, data, cfg, ax,
                             stream=impl == "stream")
    if impl == "blocked":
        return _blocked_impl(draws, state, data, cfg, ax, block=block or 128)
    if impl == "eager":
        _check_eager_fits(cfg, state.assignment.device)
        return _eager_impl(draws, state, data, cfg)
    if impl != "scan":
        raise ValueError(f"unknown Gibbs impl {impl!r}")
    k_perm, k_gumbel, k_beta = _split_sweep_keys(draws, ax)
    perm, gumbel, z, aux, log_denom = _sweep_inputs(k_perm, k_gumbel, state,
                                                    data, cfg, ax)
    return (_scan_chains if batched else _scan_impl)(
        state, data, cfg, perm, gumbel, k_beta, z, aux, log_denom, ax=ax)


def _sweep_inputs(k_perm: Draws, k_gumbel: Draws, state: CRPState,
                  data: PackedData, cfg: ModelConfig, ax: MutAxis = _NO_AXIS):
    """The sweep's (perm, gumbel, z, aux, log_denom): its draws, and the
    likelihood matrix with the Gumbel noise folded in (Z-formulation: the
    categorical draw becomes a plain argmax)."""
    n, k_max = cfg.n_cells, cfg.k_max
    alpha = state.dp_alpha
    log_denom = torch.log(n - 1.0 + alpha)
    new_post = lk.new_cluster_ll(data, cfg, state.fp, state.fn) \
        + torch.log(alpha)[..., None] - log_denom[..., None]
    perm = k_perm.permutation(n)
    gumbel = k_gumbel.gumbel(tuple(alpha.shape) + (n, k_max + 1))
    c1, c0 = lk.log_prob_tables(state.params, state.fp, state.fn)
    z = lk.ll_matrix(data, c1, c0, ax) + gumbel[..., :k_max]
    aux = new_post + gumbel[..., k_max]
    return perm, gumbel, z, aux, log_denom


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
    for cell in trace.read(perm, "scan"):
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


class SegmentWork(NamedTuple):
    """The device buffers of a ``lazy`` or ``stream`` sweep of C chains
    (one chain: C = 1), written in place by ``segment_start``,
    ``segment_births`` and read by ``segment_finish``. The captured block
    (mcmc.py) keeps one for the whole run, so its graphs read and write
    the same memory at every replay."""

    zin: torch.Tensor        # [C, n, k_pad] f32 Z (stream: visit order)
    aux: torch.Tensor        # [C, n] f32 (stream: visit order)
    assign: torch.Tensor     # [C, n] i32 pre-sweep (stream: visit order)
    perm: torch.Tensor       # [C, n] i32 visit order
    gumbel: torch.Tensor     # [C, n, k_max + 1] f32
    sizes: torch.Tensor      # [C, k_pad] f32, -1 on padded slots
    log_denom: torch.Tensor  # [C] f32
    params: torch.Tensor     # [C, k_max, m] f32, births patched in
    tgt: torch.Tensor        # [C, n] i32 target by visit position
    info: torch.Tensor       # [C, 4] i32 the kernel's info rows
    i0s: torch.Tensor        # [C] i32 start positions
    read: torch.Tensor       # [C, 6] i32 info, the birth's cell, full picks
    bounds: torch.Tensor     # [C, 3, n] f32 kernel 1's bound scratch
    full: torch.Tensor       # [C] i32 kernel 1's full picks this sweep


def segment_work(state: CRPState, cfg: ModelConfig,
                 stream: bool) -> SegmentWork:
    """Empty buffers for a sweep of `state` (one chain or a batch)."""
    c = state.assignment.shape[0] if state.assignment.dim() == 2 else 1
    n, k_max, m = cfg.n_cells, cfg.k_max, state.params.shape[-1]
    k_pad = stream_k_pad(k_max) if stream else lazy_k_pad(k_max)
    dev = state.assignment.device

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    i32 = torch.int32
    return SegmentWork(
        zin=empty(c, n, k_pad), aux=empty(c, n), assign=empty(c, n, dtype=i32),
        perm=empty(c, n, dtype=i32), gumbel=empty(c, n, k_max + 1),
        sizes=empty(c, k_pad), log_denom=empty(c), params=empty(c, k_max, m),
        tgt=empty(c, n, dtype=i32), info=empty(c, 4, dtype=i32),
        i0s=empty(c, dtype=i32), read=empty(c, 6, dtype=i32),
        bounds=empty(c, 3, n), full=empty(c, dtype=i32))


def _launch(ws: SegmentWork, stream: bool) -> None:
    """One launch of the segment kernel on its chain grid from the device
    start positions ws.i0s, then ws.read: the info rows, each birth's cell
    (stream: perm at the birth's visit position) and the sweep's full picks
    so far (kernel 1's; 0 on stream)."""
    if stream:
        lazy_segment_stream_chains(ws.zin, ws.aux, ws.assign, ws.sizes,
                                   ws.tgt, ws.info, ws.i0s, ws.log_denom)
        cell = torch.gather(ws.perm, 1,
                            ws.info[:, 1:2].clamp(min=0).long())[:, 0]
    else:
        lazy_segment_chains(ws.zin, ws.aux, ws.assign, ws.perm, ws.sizes,
                            ws.tgt, ws.info, ws.i0s, ws.log_denom,
                            ws.bounds, ws.full)
        cell = ws.info[:, 1]
    ws.read[:, :4].copy_(ws.info)
    ws.read[:, 4].copy_(cell)
    ws.read[:, 5].copy_(ws.full)


def segment_start(ws: SegmentWork, k_perm: Draws, k_gumbel: Draws,
                  state: CRPState, data: PackedData, cfg: ModelConfig,
                  ax: MutAxis = _NO_AXIS, *, stream: bool) -> None:
    """A sweep's head: its draws and Z (``_sweep_inputs``), the staging
    into `ws` (stream: Z, aux and the assignment gathered into visit order
    once a sweep, so rows stream from device memory in order) and the
    first launch. No host read."""
    perm, gumbel, z, aux, log_denom = _sweep_inputs(k_perm, k_gumbel, state,
                                                    data, cfg, ax)
    if state.assignment.dim() == 1:
        state = CRPState(*(f[None] for f in state))
        perm, gumbel, z, aux, log_denom = (
            x[None] for x in (perm, gumbel, z, aux, log_denom))
    k_pad = ws.zin.shape[-1]
    pad = (0, k_pad - cfg.k_max)
    if stream:
        order = perm.long()
        ws.zin.copy_(torch.nn.functional.pad(
            torch.take_along_dim(z, order[..., None], dim=-2), pad))
        ws.aux.copy_(torch.gather(aux, -1, order))
        ws.assign.copy_(torch.gather(state.assignment, -1, order))
    else:
        ws.zin.copy_(torch.nn.functional.pad(z, pad))
        ws.aux.copy_(aux)
        ws.assign.copy_(state.assignment)
    ws.perm.copy_(perm)
    ws.gumbel.copy_(gumbel)
    ws.sizes.copy_(_padded_sizes(state, k_pad))
    ws.log_denom.copy_(log_denom)
    ws.params.copy_(state.params)
    ws.i0s.zero_()
    ws.full.zero_()
    _launch(ws, stream)


def count_full_picks(rows, n: int) -> None:
    """The tracer's counts of kernel 1's sweeps that ended with the read
    rows `rows`: full picks (column 5) and positions visited."""
    trace.count("lazy_full_picks", sum(r[5] for r in rows))
    trace.count("lazy_cells", n * len(rows))


def segment_rounds(ws: SegmentWork, n: int, births_fn, *,
                   stream: bool) -> None:
    """The sweep's host loop: one read of ws.read a round; each round with
    a birth calls births_fn(births, relaunch) with births [(chain, cell)]
    in chain order and relaunch False once every chain has reached n."""
    if trace.on:
        trace.count("sweeps", ws.read.shape[0])
    while True:
        rows = trace.read(ws.read, "round")  # one host read a round
        births = [(c, r[4]) for c, r in enumerate(rows) if r[1] >= 0]
        done = all(r[0] >= n for r in rows)
        if births:
            births_fn(births, not done)
        if done:
            if trace.on and not stream:
                count_full_picks(rows, n)
            return


def segment_births(ws: SegmentWork, births, k_betas, fp, fn,
                   data: PackedData, cfg: ModelConfig, ax: MutAxis = _NO_AXIS,
                   *, stream: bool, relaunch: bool) -> None:
    """One birth round: `births` [(chain, cell)] in chain order (the
    round's host read), the j-th newborn row drawn from ``k_betas[j]`` and
    patched into ws.params and Z, in chain order; then, unless every chain
    is done, the next launch. The born rows of `ws` are taken on the
    device, the first len(births) rows whose info holds a birth, and so
    are each one's slot and cell (the host cell only keys ``fresh_row``'s
    draw): a captured round depends on the number of births only. `fp`,
    `fn` hold each row's error rates; `ax` is the chains' mutation axis."""
    _, n, k_pad = ws.zin.shape
    k_max, m = ws.params.shape[1:]
    rows = torch.argsort((ws.read[:, 1] < 0).to(torch.int8), stable=True)
    cells = torch.arange(n, device=ws.zin.device)
    for j, ((_, cell), k_beta) in enumerate(zip(births, k_betas)):
        r = rows[j:j + 1]
        slot = ws.info.index_select(0, r)[0, 2:3].long()
        theta = fresh_row(k_beta, cell, data, cfg,
                          ws.read.index_select(0, r)[0, 4:5])
        ws.params.view(-1, m).index_copy_(0, r * k_max + slot, theta[None])
        f1, f0 = lk.log_prob_tables(theta, fp.index_select(0, r)[0],
                                    fn.index_select(0, r)[0])
        noise = torch.take(ws.gumbel, (r * n + cells) * (k_max + 1) + slot)
        col = lk.ll_col(f1, f0, data.xm, data.xm0, ax) + noise
        if stream:
            col = col[ws.perm.index_select(0, r)[0].long()]
        ws.zin.view(-1).index_copy_(0, (r * n + cells) * k_pad + slot, col)
    if relaunch:
        _launch(ws, stream)


def segment_finish(ws: SegmentWork, state: CRPState) -> CRPState:
    """The swept state: the targets put back in cell order, the sizes and
    the patched params."""
    one = state.assignment.dim() == 1
    k_max = state.cluster_size.shape[-1]
    assignment = torch.empty_like(ws.tgt).scatter_(-1, ws.perm.long(),
                                                   ws.tgt)
    sizes = ws.sizes[:, :k_max].to(torch.int32)
    if one:
        return state._replace(assignment=assignment[0], params=ws.params[0],
                              cluster_size=sizes[0])
    return state._replace(assignment=assignment, params=ws.params,
                          cluster_size=sizes)


def _segment_impl(draws, state, data, cfg, ax=_NO_AXIS, *, stream: bool):
    """The birth-lazy host loop around the resident segment kernel (bnpc_tpu
    _pallas_lazy_impl) or, with `stream`, the streaming one (bnpc_tpu
    _pallas_stream_impl), for one chain or a batch of chains.

    The kernel reads only the PRE-SWEEP assignment of not-yet-visited cells
    and writes targets by visit position; one scatter at the end puts them
    back in cell order. The streaming kernel takes Z, aux and the pre-sweep
    assignment gathered into visit order once per sweep; a birth at visit
    position p is cell perm[p], and its Z column is computed in cell order
    and gathered into visit order, in bnpc_tpu's order of operations.

    Every launch runs the kernel on a grid of one block a chain (one chain:
    a grid of one), each chain's start position on the device (i0s), so a
    relaunch takes no host arguments. Each round is one launch and one host
    read of ws.read [C, 6]; every birth of the round is then drawn from its
    chain's own draws and patched in chain order, as its one-chain sweep
    does. The pieces (``segment_start``, ``segment_births``,
    ``segment_finish``) are what mcmc.py's captured block runs as graphs."""
    one = state.assignment.dim() == 1
    k_perm, k_gumbel, k_beta = _split_sweep_keys(draws, ax)
    k_betas, mut = ([k_beta], ax) if one else (k_beta.chains, ax.mut)
    ws = segment_work(state, cfg, stream)
    segment_start(ws, k_perm, k_gumbel, state, data, cfg, ax, stream=stream)
    fp, fn = state.fp.reshape(-1), state.fn.reshape(-1)
    segment_rounds(ws, cfg.n_cells, lambda births, relaunch: segment_births(
        ws, births, [k_betas[c] for c, _ in births], fp, fn, data, cfg, mut,
        stream=stream, relaunch=relaunch), stream=stream)
    return segment_finish(ws, state)


def _scan_chains(state, data, cfg, perm, gumbel, k_beta, z, aux, log_denom,
                 ax=_NO_AXIS):
    """The batched ``scan``: each chain's one-chain scan in turn."""
    return stack_states([
        _scan_impl(st, data, cfg, perm[c], gumbel[c], k_beta.chains[c], z[c],
                   aux[c], log_denom[c], ax.mut)
        for c, st in enumerate(unstack_states(state))])


def _eager_impl(draws, state, data, cfg):
    """The whole-sweep kernel (bnpc_tpu _pallas_impl), one chain, no mesh:
    the sweep's draws and Z, every newborn row drawn up front, the [n, n]
    likelihood of every cell under every newborn row as one product (left
    to torch.matmul, as bnpc_tpu leaves it to XLA), and one launch that
    patches births in-kernel. No host read: mcmc.py's captured block runs
    it as one graph (the caller checks ``_check_eager_fits`` beforehand)."""
    k_perm, k_gumbel, k_beta = _split_sweep_keys(draws)
    perm, gumbel, z, aux, log_denom = _sweep_inputs(k_perm, k_gumbel, state,
                                                    data, cfg)
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


class BlockedWork(NamedTuple):
    """The device buffers of a ``blocked`` sweep of C chains (one chain:
    C = 1), G blocks of B cells in visit order, written in place by
    ``blocked_start``, ``blocked_pass``, ``blocked_cell`` and
    ``blocked_births`` and read by ``blocked_finish``. The captured block
    and batch (mcmc.py) keep one for the whole run, so their graphs read
    and write the same memory at every replay."""

    z3: torch.Tensor      # [C, G * B, k_max] f32 Z in visit order, padded
    aux3: torch.Tensor    # [C, G * B] f32 (padded positions -inf)
    old3: torch.Tensor    # [C, G * B] i64 pre-sweep assignment
    tgt3: torch.Tensor    # [C, G * B] i64 target by visit position
    order: torch.Tensor   # [C, n] i64 visit order
    gumbel: torch.Tensor  # [C, n, k_max + 1] f32
    sizes: torch.Tensor   # [C, k_max] cluster sizes (the state's dtype)
    params: torch.Tensor  # [C, k_max, m] f32, births patched in
    ld: torch.Tensor      # [C, 1] f32 log_denom
    first: torch.Tensor   # [C] i64 birth block of the last pass (G: none)
    free: torch.Tensor    # [C] i64 the replayed cell's free slot
    cell: torch.Tensor    # [C] i64 the replayed cell
    read: torch.Tensor    # [C, 2] i64 the host read: (first, -) after a
    #                       pass, (born, cell) after a replayed cell
    j: torch.Tensor       # [1] i64 the next replayed position in a block
    act3: torch.Tensor    # [G, B] bool visit positions below n


def blocked_work(state: CRPState, cfg: ModelConfig,
                 block: int) -> BlockedWork:
    """Empty buffers for a blocked sweep of `state` (one chain or a batch)
    in blocks of `block` cells."""
    c = state.assignment.shape[0] if state.assignment.dim() == 2 else 1
    n, k_max, m = cfg.n_cells, cfg.k_max, state.params.shape[-1]
    B = max(1, int(block))
    G = -(-n // B)
    dev = state.assignment.device

    def empty(*shape, dtype=torch.long):
        return torch.empty(shape, dtype=dtype, device=dev)

    f32 = torch.float32
    return BlockedWork(
        z3=empty(c, G * B, k_max, dtype=f32), aux3=empty(c, G * B, dtype=f32),
        old3=empty(c, G * B), tgt3=empty(c, G * B), order=empty(c, n),
        gumbel=empty(c, n, k_max + 1, dtype=f32),
        sizes=empty(c, k_max, dtype=state.cluster_size.dtype),
        params=empty(c, k_max, m, dtype=state.params.dtype),
        ld=empty(c, 1, dtype=f32), first=empty(c), free=empty(c),
        cell=empty(c), read=empty(c, 2), j=empty(1),
        act3=(torch.arange(G * B, device=dev) < n).view(G, B))


def blocked_rows(ws: BlockedWork, k: int) -> BlockedWork:
    """The first `k` chains' rows of `ws` (contiguous prefixes)."""
    return BlockedWork(*(f if name in ("j", "act3") else f[:k]
                         for name, f in zip(BlockedWork._fields, ws)))


def blocked_start(ws: BlockedWork, k_perm: Draws, k_gumbel: Draws,
                  state: CRPState, data: PackedData, cfg: ModelConfig,
                  ax: MutAxis = _NO_AXIS) -> None:
    """A blocked sweep's head: its draws and Z (``_sweep_inputs``) and the
    visit-order staging into `ws`, one gather a sweep; padded positions
    are inactive (aux -inf, assignment 0, never applied). Every chain then
    starts its first pass at block 0. No host read."""
    perm, gumbel, z, aux, log_denom = _sweep_inputs(k_perm, k_gumbel, state,
                                                    data, cfg, ax)
    if state.assignment.dim() == 1:
        state = CRPState(*(f[None] for f in state))
        perm, gumbel, z, aux, log_denom = (
            x[None] for x in (perm, gumbel, z, aux, log_denom))
    pad = ws.z3.shape[1] - cfg.n_cells
    order = perm.long()
    ws.z3.copy_(torch.nn.functional.pad(
        torch.take_along_dim(z, order[..., None], dim=1), (0, 0, 0, pad)))
    ws.aux3.copy_(torch.nn.functional.pad(torch.gather(aux, 1, order),
                                          (0, pad), value=NEG_INF))
    ws.old3.copy_(torch.nn.functional.pad(
        torch.gather(state.assignment, 1, order).long(), (0, pad)))
    ws.tgt3.copy_(ws.old3)
    ws.order.copy_(order)
    ws.gumbel.copy_(gumbel)
    ws.sizes.copy_(state.cluster_size)
    ws.params.copy_(state.params)
    ws.ld.copy_(log_denom.to(torch.float32)[:, None])
    ws.first.fill_(-1)


def blocked_pass(ws: BlockedWork, g_lo: int = 0) -> None:
    """One frozen pass: each chain c applies its blocks g0[c], g0[c] + 1,
    ... up to (not including) its first one whose frozen pass holds a
    birth, every block as [C, B, k] tensor work, and writes that block
    (G when none) into ws.first and ws.read. g0[c] is the block after
    chain c's last birth block (0 at the sweep's start), on the device; a
    chain whose sweep has ended (g0 = G) stays as it is. The blocks below
    g_lo (the host's lowest g0) change nothing, so any g_lo up to it gives
    the same bits. No host read."""
    c_all = ws.first.shape[0]
    G, B = ws.act3.shape
    k_max = ws.sizes.shape[1]
    dev = ws.first.device
    g0 = torch.where(ws.first < G, ws.first + 1, G)
    iota_k = torch.arange(k_max, device=dev)
    z4, aux4, old4, tgt4 = (x.view((c_all, G, B) + x.shape[2:])
                            for x in (ws.z3, ws.aux3, ws.old3, ws.tgt3))
    sizes = ws.sizes
    stopped = torch.zeros((c_all,), dtype=torch.bool, device=dev)
    first = torch.full((c_all,), G, dtype=torch.long, device=dev)
    for g in range(g_lo, G):
        on = g0 <= g
        oldb = old4[:, g]
        actb = ws.act3[g] & on[:, None]
        oh_old = ((oldb[..., None] == iota_k) & actb[..., None]).to(
            sizes.dtype)
        sizes_excl = sizes[:, None] - oh_old
        live = sizes_excl > 0
        prior = torch.log(torch.clamp(sizes_excl, min=1).to(
            torch.float32)) - ws.ld[..., None]
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
    ws.sizes.copy_(sizes)
    ws.first.copy_(first)
    ws.read[:, 0].copy_(first)
    ws.j.zero_()


def blocked_cell(ws: BlockedWork) -> None:
    """One cell of the exact sequential replay (``_scan_impl``'s body) of
    block first[c] of each chain c that has one, at position ws.j of the
    block (a device counter, moved on by one): the cell leaves its
    cluster, decides, and joins its target (a newborn's free slot). The
    newborn's row and Z column are ``blocked_births``', which needs only
    the slot, so it may come after. Writes (born, cell) of every chain
    into ws.read. No host read."""
    G, B = ws.act3.shape
    n = ws.order.shape[1]
    sizes = ws.sizes
    rep = ws.first < G
    pos = (torch.clamp(ws.first, max=G - 1) * B + ws.j)[:, None]
    on = (rep & (pos[:, 0] < n))[:, None].to(sizes.dtype)
    sizes.scatter_add_(1, torch.gather(ws.old3, 1, pos), -on)
    live = sizes > 0
    prior = torch.log(torch.clamp(sizes, min=1).to(torch.float32)) - ws.ld
    zrow = torch.take_along_dim(ws.z3, pos[..., None], dim=1)[:, 0]
    post_old = torch.where(live, zrow + prior, NEG_INF)
    best, choice = torch.max(post_old, dim=-1)
    # First max, as jnp.argmax over [post_old, post_new].
    is_new = (~live).any(dim=-1) \
        & (torch.gather(ws.aux3, 1, pos)[:, 0] > best)
    free = torch.argmax((sizes == 0).to(torch.int32), dim=-1)
    target = torch.where(is_new, free, choice)[:, None]
    sizes.scatter_add_(1, target, on)
    ws.tgt3.scatter_(1, pos, torch.where(on > 0, target,
                                         torch.gather(ws.tgt3, 1, pos)))
    ws.free.copy_(free)
    ws.cell.copy_(torch.gather(ws.order, 1, pos.clamp(max=n - 1))[:, 0])
    ws.read[:, 0].copy_(is_new & (on[:, 0] > 0))
    ws.read[:, 1].copy_(ws.cell)
    ws.j.add_(1)


def blocked_births(ws: BlockedWork, births, k_betas, fp, fn,
                   data: PackedData, cfg: ModelConfig,
                   ax: MutAxis = _NO_AXIS) -> None:
    """The births of one replayed cell: `births` [(chain, cell)] in chain
    order (the cell's host read), the j-th newborn row drawn from
    ``k_betas[j]`` into slot ws.free of its chain, and its Z column
    patched in, in visit order, for every later cell. The born rows of
    `ws` are taken on the device, the first len(births) rows whose read
    holds a birth, and so are each one's slot and cell (the host cell only
    keys ``fresh_row``'s draw): a captured birth depends on the number of
    births only. `fp`, `fn` hold each row's error rates; `ax` is the
    chains' mutation axis."""
    n = ws.order.shape[1]
    k_max, m = ws.params.shape[1:]
    gb = ws.z3.shape[1]
    rows = torch.argsort((ws.read[:, 0] == 0).to(torch.int8), stable=True)
    cells = torch.arange(n, device=ws.z3.device)
    for j, ((_, cell), k_beta) in enumerate(zip(births, k_betas)):
        r = rows[j:j + 1]
        slot = ws.free.index_select(0, r)
        theta = fresh_row(k_beta, cell, data, cfg, ws.cell.index_select(0, r))
        ws.params.view(-1, m).index_copy_(0, r * k_max + slot, theta[None])
        f1, f0 = lk.log_prob_tables(theta, fp.index_select(0, r)[0],
                                    fn.index_select(0, r)[0])
        noise = torch.take(ws.gumbel, (r * n + cells) * (k_max + 1) + slot)
        col = lk.ll_col(f1, f0, data.xm, data.xm0, ax) + noise
        col = col[ws.order.index_select(0, r)[0]]
        ws.z3.view(-1).index_copy_(0, (r * gb + cells) * k_max + slot, col)


def blocked_rounds(ws: BlockedWork, first_h, cell_fn, births_fn,
                   pass_fn) -> None:
    """The blocked sweep's host loop after its first pass. `first_h` is
    each chain's first birth block (that pass's host read); while some
    chain has one, every such chain replays it in one loop over the
    block's cells (cell_fn(); one host read of ws.read a cell;
    births_fn(births) with births [(chain, cell)] in chain order when the
    cell births in some chain), then pass_fn(g_lo) runs the next pass from
    block g_lo (the lowest block any chain starts at), and one host read
    of ws.read gives the next first blocks."""
    G, B = ws.act3.shape
    n = ws.order.shape[1]
    while min(first_h) < G:
        for j in range(B):
            if not any(f < G and f * B + j < n for f in first_h):
                break
            cell_fn()
            rows = trace.read(ws.read, "blocked_cell")  # one host read a cell
            births = [(c, r[1]) for c, r in enumerate(rows) if r[0]]
            if births:
                births_fn(births)
        pass_fn(min(first_h) + 1)
        # One host read a pass.
        first_h = [r[0] for r in trace.read(ws.read, "blocked_pass")]


def blocked_finish(ws: BlockedWork, state: CRPState) -> CRPState:
    """The swept state: the targets put back in cell order, the sizes and
    the patched params."""
    n = ws.order.shape[1]
    dtype = state.assignment.dtype
    assignment = torch.empty(ws.order.shape, dtype=dtype,
                             device=ws.order.device).scatter_(
        1, ws.order, ws.tgt3[:, :n].to(dtype))
    if state.assignment.dim() == 1:
        return state._replace(assignment=assignment[0], params=ws.params[0],
                              cluster_size=ws.sizes[0])
    return state._replace(assignment=assignment, params=ws.params,
                          cluster_size=ws.sizes)


def _blocked_impl(draws, state, data, cfg, ax=_NO_AXIS, *, block: int):
    """Opt-in APPROXIMATE blocked sweep (bnpc_tpu _blocked_impl; no
    reference counterpart), for one chain or a batch of chains. Cells are
    visited in the permuted order in blocks of ``block``: every cell of a
    block decides against the cluster sizes frozen at block entry (minus
    its own membership), and the block's moves are applied at once. A
    block whose frozen pass holds a birth is replayed exactly, cell by
    cell, as ``_scan_impl`` does, with its newborn Z columns patched in for
    every later block. block=1 is the exact sweep.

    A frozen pass (``blocked_pass``) runs from a block to the end of the
    sweep as [C, block, k] tensor work per block with no host read; only
    each chain's first birth block comes back to the host, one [C] read a
    pass (bnpc_tpu's scan / while_loop structure). Every chain then
    replays its birth block in one loop over the block's cells
    (``blocked_cell``), one host read a cell, each birth drawn from its
    chain's own draws and patched in chain order (``blocked_births``); the
    next pass starts each chain after its own replayed block. A chain
    whose sweep has ended stays as it is while the others go on, so chain
    c gets its one-chain sweep (bnpc_tpu's vmapped while_loop runs each
    chain to its own end). One chain runs as a batch of one. The pieces
    are what mcmc.py's captured block and batch run as graphs. The
    approximation and its O(block / n) bias are bnpc_tpu's
    (tests/test_blocked.py); its veto channel is not ported."""
    one = state.assignment.dim() == 1
    k_perm, k_gumbel, k_beta = _split_sweep_keys(draws, ax)
    k_betas, mut = ([k_beta], ax) if one else (k_beta.chains, ax.mut)
    ws = blocked_work(state, cfg, block)
    blocked_start(ws, k_perm, k_gumbel, state, data, cfg, ax)
    blocked_pass(ws)
    fp, fn = state.fp.reshape(-1), state.fn.reshape(-1)
    blocked_rounds(
        ws, [r[0] for r in trace.read(ws.read, "blocked_pass")],
        lambda: blocked_cell(ws),
        lambda births: blocked_births(ws, births, [k_betas[c] for c, _ in
                                                   births], fp, fn, data,
                                      cfg, mut),
        lambda g_lo: blocked_pass(ws, g_lo))
    return blocked_finish(ws, state)
