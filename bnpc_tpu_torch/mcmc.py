"""Chain orchestration: the per-step move mixture and the multi-chain
runner (counterpart of bnpc_tpu/mcmc.py; reference libs/MCMC.py).

One MCMC step (do_step, libs/MCMC.py:320-342) is a plain Python function
over tensors: the move selection reads its three uniforms on the host (one
synchronization per step), then runs either a Gibbs sweep or a split-merge
move, the alpha resample, the cluster-parameter MH and the error-rate MH,
and emits one trace row. The runner runs blocks of steps, copies each
block's rows to the host, and assembles the reference's per-chain results
in the three run modes of the reference (steps, runtime, lugsail PSRF),
with checkpoint / resume. Given a mesh of ranks (parallel/sharded.py), the
runner runs this rank's chains on its mutation columns and rank 0 gathers,
decides and writes (see MCMCRunner).

One place decides how a block of chains runs: ``_make_block`` (the runner's
one block, make_block_fn's and parallel/sharded.py's), by the table in
``_form``. Chains run one after another (bnpc_tpu's
chain_exec="sequential") or all together as one batch with a leading chain
axis (chain_exec="vmap": the same step on a batched state), and in either
form in lockstep with one shared move selection a step (coupled_moves). On
the card, outside a mesh, a chain's block runs captured (_CapturedBlock)
and so does a batch, exact, blocked or coupled (_CapturedBatch, its pieces
keyed by how many chains take each branch): the device-only pieces of each
step between the step's host reads replay as CUDA graphs (graphs.py), bit
for bit what the eager step gives, for the lazy, stream, eager and blocked
sweeps. The scan sweep, the CPU and the mesh run the eager step; coupled
chains one after another run it too. Every executor steps through one
loop, ``_block_loop``. Nothing turns the capture off; a capture fault
raises.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from datetime import datetime
from typing import NamedTuple

import numpy as np
import torch

from bnpc_tpu_torch import diagnostics, graphs, trace
from bnpc_tpu_torch.config import MCMCConfig, ModelConfig
from bnpc_tpu_torch.data import PackedData
from bnpc_tpu_torch.draws import Draws, StackedDraws, TorchDraws
from bnpc_tpu_torch.models.gibbs import (SegmentWork, _check_eager_fits,
                                          _eager_impl, _launch,
                                          _split_sweep_keys, blocked_births,
                                          blocked_cell, blocked_finish,
                                          blocked_pass, blocked_rounds,
                                          blocked_rows, blocked_start,
                                          blocked_work, count_full_picks,
                                          gibbs_sweep, resolve_impl,
                                          segment_births,
                                          segment_finish, segment_rounds,
                                          segment_start, segment_work)
from bnpc_tpu_torch.models.splitmerge import _move, sm_choice, split_merge
from bnpc_tpu_torch.models.updates import (
    update_dp_alpha,
    update_error_rates,
    update_parameters,
)
from bnpc_tpu_torch.ops import cuda_row
from bnpc_tpu_torch.ops import likelihood as lk
from bnpc_tpu_torch.parallel.axis import ChainAxis, MutAxis
from bnpc_tpu_torch.state import (CRPState, by_chain_flag, cluster_stats,
                                  init_state, stack_states, take_states,
                                  unstack_states)

_NO_AXIS = MutAxis()


class TraceRow(NamedTuple):
    ml: torch.Tensor          # [] f32 log-likelihood
    map_: torch.Tensor        # [] f32 log-posterior
    dp_alpha: torch.Tensor    # [] f32
    fp: torch.Tensor          # [] f32
    fn: torch.Tensor          # [] f32
    assignment: torch.Tensor  # [n] smallest unsigned int that holds k_max
    params: torch.Tensor      # [trace_k, m] f16
    mh_counts: torch.Tensor   # [5, 2] i32 (params, splits, merges, FP, FN)


def _trace_dtypes(cfg: ModelConfig):
    """(assignment, params) dtypes of trace rows (bnpc_tpu/mcmc.py:54-79):
    the assignment cast is lossless (slot ids < k_max); params are recorded
    in f16 (<= 2^-11 relative rounding of the RECORDED values only), or in
    f32 under BNPC_TPU_TRACE_F32=1."""
    if cfg.k_max <= 256:
        a = torch.uint8
    elif cfg.k_max <= 65536:
        a = torch.uint16
    else:
        a = torch.int32
    p = (torch.float32 if os.environ.get("BNPC_TPU_TRACE_F32") == "1"
         else torch.float16)
    return a, p


def resolve_trace_k(cfg: ModelConfig, mcmc_cfg: MCMCConfig) -> int:
    if mcmc_cfg.trace_k > 0:
        return min(mcmc_cfg.trace_k, cfg.k_max)
    return min(cfg.k_max, 128)


def _compact_params(state: CRPState, trace_k: int):
    """Rows of live slots in ascending slot order, zero-padded to trace_k
    (the reference stores parameters[sorted(live_ids)], libs/MCMC.py:261)."""
    live = state.cluster_size > 0
    order = torch.argsort((~live).to(torch.int8), dim=-1, stable=True)
    sel = order[..., :trace_k]
    return torch.take_along_dim(state.params, sel[..., None], dim=-2) \
        * torch.take_along_dim(live, sel, dim=-1)[..., None].to(
            state.params.dtype)


class StepStats(NamedTuple):
    """A step's sufficient statistics and, where its error move ran on
    every chain, that move's likelihood at the new rates: the row's ML (the
    same expression on the same values as summarize's, so the same
    bits)."""
    n1: torch.Tensor
    n0: torch.Tensor
    ml: torch.Tensor | None = None


def summarize(state: CRPState, data: PackedData, cfg: ModelConfig,
              trace_k: int, stats=None, ax: MutAxis = _NO_AXIS) -> TraceRow:
    """One trace row for the current state (libs/MCMC.py:242-282). `stats`
    reuses the step's (n1, n0) sufficient statistics, or a StepStats that
    also carries the row's ML. Under a sharded `ax` ML and MAP are
    all-reduced and the params are this rank's columns; under a chain axis
    every field leads with the chains.

    On the CPU the torch composition below runs; off it, ML and MAP come
    from the fused kernel (ops/cuda_row.py) around the same torch sums."""
    n1, n0, ml = StepStats(*(stats if stats is not None else cluster_stats(
        data, state.assignment, cfg.k_max)))
    if cuda_row.fits(state.params.device):
        ml, map_ = cuda_row.ml_map(cfg, state, n1, n0, ml, ax)
    else:
        if ml is None:
            c1, c0 = lk.log_prob_tables(state.params, state.fp, state.fn)
            ml = lk.ll_from_stats(n1, n0, c1, c0, ax)
        map_ = ml + lk.log_prior_full(cfg, state.cluster_size, state.params,
                                      state.dp_alpha, state.fp, state.fn,
                                      ax)
    a_dt, p_dt = _trace_dtypes(cfg)
    return TraceRow(
        ml=ml, map_=map_, dp_alpha=state.dp_alpha, fp=state.fp,
        fn=state.fn, assignment=state.assignment.to(a_dt),
        params=_compact_params(state, trace_k).to(p_dt),
        mh_counts=torch.zeros(tuple(ml.shape) + (5, 2), dtype=torch.int32,
                              device=state.assignment.device),
    )


def _make_finish(cfg: ModelConfig, mcmc_cfg: MCMCConfig, data: PackedData,
                 trace_k: int, ax: MutAxis = _NO_AXIS):
    """The rest of a step after its assignment move, for one chain or a
    batch: finish(state, flags, flags_dev, sm_counts, k_dpa, k_par, k_err)
    runs the alpha resample, the cluster statistics, the parameter MH, the
    error-rate MH and the trace row, and returns (state, row). `flags` and
    `flags_dev` are select's (``_make_moves``); `sm_counts` the split-merge
    move's [..., 2, 2] counts (None: no split-merge move)."""

    def finish(state: CRPState, flags, flags_dev, sm_counts, k_dpa, k_par,
               k_err):
        step_ax = (ax if state.assignment.dim() == 1
                   else ChainAxis(chains=len(flags), mut=ax))
        counts = torch.zeros(tuple(state.dp_alpha.shape) + (5, 2),
                             dtype=torch.int32,
                             device=state.assignment.device)
        if sm_counts is not None:
            counts[..., 1:3, :] += sm_counts

        def alpha_move(do_dpa, sub, sub_ax, take, idx):
            return (update_dp_alpha(take(k_dpa), sub, cfg) if do_dpa
                    else sub), None

        if not mcmc_cfg.fix_assign and mcmc_cfg.dpa_prob > 0.0:
            state, _ = by_chain_flag(state, [f[1] for f in flags],
                                     lambda: flags_dev(1), alpha_move,
                                     step_ax)

        n1, n0 = cluster_stats(data, state.assignment, cfg.k_max)
        state, par_dec, par_acc = update_parameters(k_par, state, n1, n0,
                                                    cfg, step_ax)
        counts[..., 0, :] += torch.stack([par_acc, par_dec], -1).to(
            torch.int32)

        ml = None

        def error_move(do_err, sub, sub_ax, take, idx):
            nonlocal ml
            if not do_err:
                return sub, None
            s1, s0 = (n1, n0) if idx is None else (n1[idx], n0[idx])
            sub, fp_acc, fn_acc, ll = update_error_rates(take(k_err), sub,
                                                         s1, s0, cfg, sub_ax)
            if idx is None:
                ml = ll  # every chain moved: the row's ML
            acc = torch.stack([fp_acc, fn_acc], -1).to(torch.int32)
            return sub, torch.stack([acc, 1 - acc], dim=-1)

        if cfg.learn_errors and mcmc_cfg.error_prob > 0.0:
            state, c = by_chain_flag(state, [f[2] for f in flags],
                                     lambda: flags_dev(2), error_move,
                                     step_ax)
            if c is not None:
                counts[..., 3:5, :] += c

        row = summarize(state, data, cfg, trace_k,
                        stats=StepStats(n1, n0, ml), ax=step_ax)
        return state, row._replace(mh_counts=counts)

    return finish


def _make_moves(cfg: ModelConfig, mcmc_cfg: MCMCConfig, data: PackedData,
                trace_k: int, gibbs_impl: str, gibbs_block: int,
                ax: MutAxis = _NO_AXIS):
    """(select, moves) of a step of one chain or of a batch of chains (a
    state with a leading chain axis and StackedDraws; chain_exec="vmap").

    select(k_sel, lead) reads the move uniforms of every chain, [*lead, 3]
    (the step's one planned host read), and returns (flags, flags_dev):
    each chain's (do_sm, do_dpa, do_err) on the host, a list of one for one
    chain, and flags_dev(j), flag j of every chain on the device.
    moves(state, flags, flags_dev, k_assign, k_dpa, k_par, k_err) runs the
    moves and returns (state, row): the assignment move, then
    ``_make_finish``'s. A move that only some chains of a batch take runs
    on their sub-batch (state.py::by_chain_flag), so each chain draws what
    its one-chain step draws. gibbs_block > 0 replaces the exact Gibbs move
    by the blocked sweep. Every move sums over the mutation axis `ax`, and
    a batch over a ChainAxis on it."""
    impl_g = "blocked" if gibbs_block > 0 else gibbs_impl
    select = _make_select(mcmc_cfg)
    finish = _make_finish(cfg, mcmc_cfg, data, trace_k, ax)

    def moves(state: CRPState, flags, flags_dev, k_assign, k_dpa, k_par,
              k_err):
        step_ax = (ax if state.assignment.dim() == 1
                   else ChainAxis(chains=len(flags), mut=ax))

        def assign_move(do_sm, sub, sub_ax, take, idx):
            if do_sm:
                return split_merge(take(k_assign), sub, data, cfg,
                                   mcmc_cfg.sm_split_ratio,
                                   mcmc_cfg.sm_steps, ax=sub_ax)
            return gibbs_sweep(take(k_assign), sub, data, cfg, impl=impl_g,
                               block=gibbs_block, ax=sub_ax), None

        sm_counts = None
        if not mcmc_cfg.fix_assign:
            state, sm_counts = by_chain_flag(
                state, [mcmc_cfg.sm_prob > 0.0 and f[0] for f in flags],
                lambda: flags_dev(0), assign_move, step_ax)
        return finish(state, flags, flags_dev, sm_counts, k_dpa, k_par,
                      k_err)

    return select, moves


def _thresholds(mcmc_cfg: MCMCConfig) -> list[float]:
    """The move thresholds (split-merge, alpha, errors) as float32 values:
    comparing the uniforms' exact float32 values against them on the host
    is JAX's float32 comparison, and on the device the same."""
    return [float(np.float32(p)) for p in (
        mcmc_cfg.sm_prob, mcmc_cfg.dpa_prob, mcmc_cfg.error_prob)]


def _make_select(mcmc_cfg: MCMCConfig):
    """select(k_sel, lead=()) of ``_make_moves``."""
    thresholds = _thresholds(mcmc_cfg)

    def select(k_sel: Draws, lead=()):
        u = k_sel.uniform(tuple(lead) + (3,))
        # The step's one planned host read.
        rows = trace.read(u.reshape(-1, 3), "select")
        flags = [[x < t for x, t in zip(row, thresholds)] for row in rows]
        if trace.on:
            trace.note_flags(flags)
        return flags, lambda j: u[..., j] < thresholds[j]

    return select


def make_step_fn(cfg: ModelConfig, mcmc_cfg: MCMCConfig, data: PackedData,
                 trace_k: int, ax: MutAxis = _NO_AXIS,
                 gibbs_impl: str = "auto"):
    """The single-step function (bnpc_tpu make_step_fn; do_step,
    libs/MCMC.py:320-342); draws are split exactly as in
    bnpc_tpu/mcmc.py:_make_step_body. ``gibbs_impl`` is
    the Gibbs sweep's impl (models/gibbs.py::gibbs_sweep);
    ``mcmc_cfg.gibbs_block`` > 0 routes the Gibbs move to the blocked
    sweep, as bnpc_tpu does. Under a sharded `ax`, `data` and the params
    are this rank's mutation columns.

    step(state, draws) -> (state, row). Given a batched state and a
    StackedDraws of the chains' step draws it is the batched step
    (bnpc_tpu's _pipe_vmap body, without vmap): every chain steps at once,
    each with its own move choice read in one [C, 3] host read, and chain c
    splits and draws exactly as its one-chain step does, so it gets its
    one-chain step's result; every row field leads with the chains."""
    select, moves = _make_moves(cfg, mcmc_cfg, data, trace_k, gibbs_impl,
                                mcmc_cfg.gibbs_block, ax)

    def step(state: CRPState, draws: Draws):
        k_sel, k_assign, k_dpa, k_par, k_err = draws.split(5)
        return moves(state, *select(k_sel, state.dp_alpha.shape), k_assign,
                     k_dpa, k_par, k_err)

    return step


def _check_chains_step(gibbs_impl: str) -> None:
    """Refuse what has no batched-chains form: the eager sweep (bnpc_tpu
    falls back to its scan there with a warning; the port does not switch
    implementation quietly)."""
    if gibbs_impl not in ("auto", "lazy", "stream", "scan", "blocked"):
        raise ValueError(f"chain_exec='vmap' has no batched Gibbs impl "
                         f"{gibbs_impl!r}: the batch runs 'lazy', 'stream', "
                         "'scan' or 'blocked'; use chain_exec='sequential'")


def _coupled_keys(draws: Draws, n: int, chain_draws=None):
    """(k_sel, per-chain (move, alpha, params, errors) draws) of a coupled
    step on the step provider `draws` (chain 0's): bnpc_tpu's key tree,
    split c of the step's keys for chain c; or, given `chain_draws` (each
    chain's own step provider), chain c's moves on its own stream."""
    k_sel, *ks = draws.split(5)
    if chain_draws is None:
        return k_sel, list(zip(*(k.split(n) for k in ks)))
    return k_sel, [tuple(d.split(5)[1:]) for d in chain_draws]


def make_coupled_step_fn(cfg: ModelConfig, mcmc_cfg: MCMCConfig,
                         data: PackedData, trace_k: int,
                         gibbs_impl: str = "auto"):
    """A step of every chain with one SHARED move-type selection
    (bnpc_tpu make_coupled_step_fn); the move, alpha, parameter and error
    draws as ``_coupled_keys`` gives them. Like bnpc_tpu's, it does not
    route ``gibbs_block`` and runs unsharded.

    step(states, draws, chain_draws=None): `states` a list of one-chain
    states, moved one after another -> (states, rows); or one batched state
    (chain_exec="vmap"), moved as one batch -> (state, row)."""
    select, moves = _make_moves(cfg, mcmc_cfg, data, trace_k, gibbs_impl, 0)

    def step(states, draws: Draws, chain_draws=None):
        batched = isinstance(states, CRPState)
        n = states.assignment.shape[0] if batched else len(states)
        k_sel, keys = _coupled_keys(draws, n, chain_draws)
        flags, _ = select(k_sel)
        if batched:
            return moves(states, flags * n, None,
                         *(StackedDraws(k) for k in zip(*keys)))
        out = [moves(st, flags, None, *k) for st, k in zip(states, keys)]
        return [o[0] for o in out], [o[1] for o in out]

    return step


def _own_streams(keys, t: int):
    """Each chain's step-t provider where the chains run on streams of their
    own (TorchDraws: a coupled step then moves chain c on chain c's stream,
    in any order of the chains), None for key trees (bnpc_tpu's coupled
    keys: the same in any order)."""
    if all(isinstance(k[t], TorchDraws) for k in keys):
        return [k[t] for k in keys]
    return None


@dataclasses.dataclass
class ChainResult:
    """Mirrors the per-chain results dict (libs/MCMC.py:231-258)."""

    ML: np.ndarray
    MAP: np.ndarray
    DP_alpha: np.ndarray
    FN: np.ndarray
    FP: np.ndarray
    assignments: np.ndarray   # [steps + 1, n] int32 (initial row first)
    params: np.ndarray        # [steps + 1 - burn_in, trace_k, m] f32
    burn_in: int
    mh_counts: np.ndarray     # [5, 2]
    PSRF: list = dataclasses.field(default_factory=list)
    PSRF_cutoff: float | None = None

    def as_dict(self) -> dict:
        """The reference's results dict (bnpc_tpu's ChainResult.as_dict)."""
        d = {
            "ML": self.ML, "MAP": self.MAP, "DP_alpha": self.DP_alpha,
            "FN": self.FN, "FP": self.FP, "assignments": self.assignments,
            "params": self.params, "burn_in": self.burn_in,
        }
        if self.PSRF:
            d["PSRF"] = self.PSRF
            d["PSRF_cutoff"] = self.PSRF_cutoff
        return d


def _rows_to_host(rows: list[TraceRow]) -> dict:
    """Stack a block's device rows and copy them to the host."""
    sp = trace.on and trace.begin("runner.flush", rows=len(rows))
    out = {f: torch.stack([getattr(r, f) for r in rows]).cpu().numpy()
           for f in TraceRow._fields}
    if sp:
        trace.end(sp)
    return out


def _flush_rows(bufs: TraceRow, k: int) -> dict:
    """The first `k` rows of a captured block's or batch's row buffers on
    the host (a copy on every device: .cpu() of a CPU tensor is the
    tensor)."""
    sp = trace.on and trace.begin("runner.flush", rows=k)
    out = {f: buf[:k].to("cpu", copy=True).numpy()
           for f, buf in zip(TraceRow._fields, bufs)}
    if sp:
        trace.end(sp)
    return out


def _block_loop(n_steps: int, keep: int | None, chains: int, step, end,
                before=None):
    """The block loop of every executor: one ``runner.block`` span (steps,
    chains) around the block's first `keep` steps (all `n_steps` without
    it), each step(t) in a ``runner.step`` span (step=t) and after
    before(t) where given, then end(), whose value it returns."""
    block = trace.on and trace.begin("runner.block", steps=n_steps,
                                     chains=chains)
    for t in range(n_steps if keep is None else keep):
        if before is not None:
            before(t)
        sp = trace.on and trace.begin("runner.step", step=t)
        step(t)
        if sp:
            trace.end(sp)
    out = end()
    if block:
        trace.end(block)
    return out


def _chain_block(step, state: CRPState, draws: Draws, n_steps: int,
                 keep: int | None = None):
    """One chain's block of `n_steps` steps of `step`, or its first `keep`
    steps (a partial final block takes the keys of a whole block, as
    bnpc_tpu does). Returns (state, rows, next_draws): rows is a dict of
    host arrays with a leading step axis, one entry per TraceRow field."""
    keys, rows = draws.split(n_steps + 1), []

    def one(t):
        nonlocal state
        state, row = step(state, keys[1 + t])
        rows.append(row)

    return _block_loop(n_steps, keep, 1, one,
                       lambda: (state, _rows_to_host(rows), keys[0]))


def _write(dst: CRPState, src: CRPState) -> None:
    """Copy `src` into the tensors of `dst` in place (a field that IS the
    destination tensor is left as it is)."""
    for d, x in zip(dst, src):
        if x is not d:
            d.copy_(x)


CAPTURED_IMPLS = ("lazy", "stream", "blocked", "eager")


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one ("cuda" is the current CUDA device)."""
    def index(d):
        if d.index is None and d.type == "cuda":
            return torch.cuda.current_device()
        return d.index

    return a.type == b.type and index(a) == index(b)


def _sweep_work(impl: str, state: CRPState, cfg: ModelConfig,
                mcmc_cfg: MCMCConfig):
    """The static buffers of a captured sweep of `state` (none for the
    eager sweep, one piece)."""
    if impl == "blocked":
        return blocked_work(state, cfg, mcmc_cfg.gibbs_block or 128)
    if impl == "eager":
        return ()
    return segment_work(state, cfg, impl == "stream")


# The pieces of the captured block and batch by what their device time is
# spent on, by a key's first item: the Gibbs sweep (the batch's head, which
# starts the sweep and draws the split-merge choice, among them), the
# split-merge move, and the rest of the step. The tracer's piece spans carry
# the family (graphs.Pieces).
PIECE_FAMILIES = {
    "sweep": ("sweep_head", "birth", "sweep_tail", "blocked_head",
              "blocked_cell", "blocked_birth", "blocked_pass",
              "blocked_tail", "eager_sweep", "head", "launch", "tail",
              "bcell", "bbirth", "bpass", "btail"),
    "split_merge": ("sm_head", "sm_move", "split", "merge"),
    "rest": ("rest", "alpha", "params", "errors"),
}
_PIECE_FAMILY = {k: fam for fam, keys in PIECE_FAMILIES.items()
                 for k in keys}


def piece_family(key: tuple) -> str:
    """The family of piece `key` in PIECE_FAMILIES; a key left out of the
    table raises."""
    try:
        return _PIECE_FAMILY[key[0]]
    except KeyError:
        raise KeyError(f"piece {key!r} has no family in "
                       f"PIECE_FAMILIES") from None


class _Captured:
    """What the captured block and batch share: the arguments, the copy-in
    (the draws checked; the static buffers made by the subclass's
    ``_setup`` at the first block and whenever the state's shape changes;
    the state copied in) and the block loop, whose steps write their rows
    into [rows_cap, ...] device buffers at the device step index ``t``
    (``_put_row``), copied to the host whenever the buffers are full and at
    the block's end, and joined there. `graph_cls` makes the graphs
    (graphs.Pieces); a capture fault raises."""

    NAME, IMPLS = "", ()

    def __init__(self, cfg: ModelConfig, mcmc_cfg: MCMCConfig,
                 data: PackedData, trace_k: int, impl: str, device,
                 rows_cap: int, graph_cls=graphs.CudaGraph):
        if impl not in self.IMPLS:
            raise ValueError(f"the captured {self.NAME} runs one of "
                             f"{self.IMPLS}, not {impl!r}")
        self.cfg, self.mcmc_cfg, self.data = cfg, mcmc_cfg, data
        self.trace_k, self.impl = trace_k, impl
        self.stream = impl == "stream"
        self.device = torch.device(device)
        self.rows_cap = max(1, int(rows_cap))
        self.graph_cls = graph_cls
        self.pieces: graphs.Pieces | None = None

    def _copy_in(self, draws: list[Draws], state: CRPState) -> None:
        for d in draws:
            if type(d) is not TorchDraws or not _same_device(d.gen.device,
                                                            self.device):
                raise ValueError(f"the captured {self.NAME} draws from "
                                 f"TorchDraws on {self.device}, not {d!r}")
        if self.pieces is None or (self.state.assignment.shape
                                   != state.assignment.shape):
            self._setup(state)
        _write(self.state, state)

    def _setup_rows(self, state: CRPState) -> None:
        """The end of a subclass's ``_setup``: `state` copied in, the device
        step index and the row buffers, shaped after its row."""
        _write(self.state, state)
        lead = state.assignment.shape[:-1]
        self.t = torch.zeros((1,), dtype=torch.long, device=self.device)
        row = summarize(self.state, self.data, self.cfg, self.trace_k,
                        ax=ChainAxis(chains=lead[0]) if lead else _NO_AXIS)
        self.rows = TraceRow(*(
            torch.zeros((self.rows_cap,) + tuple(f.shape), dtype=f.dtype,
                        device=self.device) for f in row))

    def _put_row(self, row: TraceRow) -> None:
        for buf, x in zip(self.rows, row):
            buf.index_copy_(0, self.t, x[None])
        self.t.add_(1)

    def _loop(self, n_steps: int, keep: int | None, chains: int, step,
              out):
        """_block_loop over step(t); out(rows) gives the block's result
        from the host rows, [steps, ...]."""
        n, host = n_steps if keep is None else keep, []
        self.t.zero_()

        def flush(t):
            if t and t % self.rows_cap == 0:
                host.append(_flush_rows(self.rows, self.rows_cap))
                self.t.zero_()

        def end():
            host.append(_flush_rows(self.rows,
                                    n - len(host) * self.rows_cap))
            return out(host[0] if len(host) == 1 else {
                f: np.concatenate([h[f] for h in host])
                for f in TraceRow._fields})

        return _block_loop(n_steps, keep, chains, step, end, flush)


class _CapturedBlock(_Captured):
    """One chain's block on the card, each step's device-only pieces
    replayed as CUDA graphs between the step's host reads (graphs.py; the
    counterpart of bnpc_tpu's compiled block, whose step is a ``lax.scan``
    body with the birth loop a ``lax.while_loop`` and split or merge a
    ``lax.cond``). For the Gibbs impls ``lazy``, ``stream``, ``eager`` and
    ``blocked`` (the blocked sweep, ``mcmc_cfg.gibbs_block`` cells a block;
    128 when that is 0, as gibbs_sweep takes it).

    A step makes the host reads of the eager step (``make_step_fn``) and
    no more: the move uniforms (select, eager: one draw), then the sweep's
    reads (lazy and stream: each round's info, models/gibbs.py::
    segment_rounds; blocked: one a frozen pass and one a replayed cell,
    ``blocked_rounds``; eager: none) or the split-or-merge choice. The
    pieces between them, each keyed by what the host knows at that point,
    are the eager step's own functions:

      * ("sweep_head",): segment_start, the sweep's draws, Z, the staging
        and the first launch;
      * ("birth", relaunch): segment_births, a birth's patch, with its slot
        and cell read on the device, and the relaunch unless the sweep has
        ended;
      * ("sweep_tail",): segment_finish into the state;
      * ("blocked_head",): blocked_start, the sweep's draws, Z and staging,
        and the first frozen pass;
      * ("blocked_cell",): blocked_cell, one cell of a birth block's exact
        replay, its position a device counter;
      * ("blocked_birth",): blocked_births, that cell's newborn row and Z
        column, with its slot and cell read on the device;
      * ("blocked_pass",): blocked_pass from block 0 (the blocks below the
        chain's start change nothing, so one graph serves every later
        pass, where the eager sweep starts at the host's block);
      * ("blocked_tail",): blocked_finish into the state;
      * ("eager_sweep",): the whole eager sweep (models/gibbs.py::
        _eager_impl: its draws, the fresh rows, the [n, n] product and
        kernel 4) into the state; ``_check_eager_fits`` runs once, at the
        block's setup, never inside a capture;
      * ("sm_head",): splitmerge.sm_choice into a device flag;
      * ("sm_move", is_split): splitmerge._move, the split or the merge;
      * ("rest", do_dpa, do_err): ``_make_finish``'s alpha resample, cluster
        statistics, parameter and error-rate MH and the trace row, written
        into a [rows_cap, ...] device buffer at a device step index.

    The chain's state, the sweep's buffers (models/gibbs.py::SegmentWork or
    BlockedWork), the split flag, the move's counts and the row buffers are
    static tensors made at the first run and read and written in place by
    every graph. A block copies the state in and its generator state into
    the block's own generator (the one every graph registers), runs its
    steps and hands back a copy of the state and the generator state. Each
    step gives bit for bit what ``_chain_block`` over the eager step gives
    on the same draws."""

    NAME, IMPLS = "block", CAPTURED_IMPLS

    def _setup(self, state: CRPState) -> None:
        """The block's generator, its graphs, its step's functions and the
        static buffers, shaped after `state`."""
        dev = self.device
        if self.impl == "eager":
            _check_eager_fits(self.cfg, dev)
        self._select = _make_select(self.mcmc_cfg)
        self._finish = _make_finish(self.cfg, self.mcmc_cfg, self.data,
                                    self.trace_k)
        self._gibbs = {"lazy": self._sweep, "stream": self._sweep,
                       "blocked": self._blocked,
                       "eager": self._eager}[self.impl]
        self.draws = TorchDraws(0, dev)
        self.pieces = graphs.Pieces(self.draws.gen, piece_family,
                                    self.graph_cls)
        self.state = CRPState(*(torch.empty_like(f, device=dev)
                                for f in state))
        self.work = _sweep_work(self.impl, self.state, self.cfg,
                                self.mcmc_cfg)
        self.split = torch.zeros((), dtype=torch.bool, device=dev)
        self.sm_counts = torch.zeros((2, 2), dtype=torch.int32, device=dev)
        self._setup_rows(state)

    def statics(self) -> list[torch.Tensor]:
        """Every static tensor the pieces read and write."""
        return [*self.state, *self.work, self.split, self.sm_counts, self.t,
                *self.rows]

    def run(self, state: CRPState, draws: Draws, n_steps: int,
            keep: int | None = None):
        """What ``_chain_block`` returns for the eager step: (state, rows,
        next_draws), `draws` a TorchDraws on the block's device (its
        generator's state moves on as the steps draw)."""
        self._copy_in([draws], state)
        gd = self.draws
        gd.gen.set_state(draws.gen.get_state())
        keys = gd.split(n_steps + 1)

        def out(rows):
            draws.gen.set_state(gd.gen.get_state())
            return CRPState(*(f.clone() for f in self.state)), rows, draws

        return self._loop(n_steps, keep, 1,
                          lambda t: self._step(keys[1 + t]), out)

    def _step(self, key: Draws) -> None:
        mc = self.mcmc_cfg
        k_sel, k_assign, k_dpa, k_par, k_err = key.split(5)
        flags, _ = self._select(k_sel)
        do_sm, do_dpa, do_err = flags[0]
        if not mc.fix_assign:
            if mc.sm_prob > 0.0 and do_sm:
                self._split_merge(k_assign)
            else:
                self._gibbs(k_assign)
        rest = ("rest", not mc.fix_assign and mc.dpa_prob > 0.0 and do_dpa,
                self.cfg.learn_errors and mc.error_prob > 0.0 and do_err)
        self.pieces.run(rest, lambda: self._rest(flags, k_dpa, k_par, k_err))

    def _sweep(self, k_assign: Draws) -> None:
        ws, st, data, cfg = self.work, self.state, self.data, self.cfg
        k_perm, k_gumbel, k_beta = _split_sweep_keys(k_assign)
        self.pieces.run(("sweep_head",), lambda: segment_start(
            ws, k_perm, k_gumbel, st, data, cfg, stream=self.stream))

        def births(born, relaunch):
            self.pieces.run(("birth", relaunch), lambda: segment_births(
                ws, born, [k_beta], st.fp.reshape(-1), st.fn.reshape(-1),
                data, cfg, stream=self.stream, relaunch=relaunch))

        segment_rounds(ws, cfg.n_cells, births, stream=self.stream)
        self.pieces.run(("sweep_tail",), functools.partial(
            self._tail, segment_finish))

    def _blocked(self, k_assign: Draws) -> None:
        ws, st, data, cfg = self.work, self.state, self.data, self.cfg
        k_perm, k_gumbel, k_beta = _split_sweep_keys(k_assign)

        def head():
            blocked_start(ws, k_perm, k_gumbel, st, data, cfg)
            blocked_pass(ws)

        self.pieces.run(("blocked_head",), head)
        fp, fn = st.fp.reshape(-1), st.fn.reshape(-1)
        blocked_rounds(
            ws, [r[0] for r in trace.read(ws.read, "blocked_pass")],
            lambda: self.pieces.run(("blocked_cell",),
                                    functools.partial(blocked_cell, ws)),
            lambda born: self.pieces.run(
                ("blocked_birth",), functools.partial(
                    blocked_births, ws, born, [k_beta], fp, fn, data, cfg)),
            lambda g_lo: self.pieces.run(
                ("blocked_pass",), functools.partial(blocked_pass, ws)))
        self.pieces.run(("blocked_tail",), functools.partial(
            self._tail, blocked_finish))

    def _tail(self, finish) -> None:
        _write(self.state, finish(self.work, self.state))
        self.sm_counts.zero_()

    def _eager(self, k_assign: Draws) -> None:
        def sweep():
            _write(self.state, _eager_impl(k_assign, self.state, self.data,
                                           self.cfg))
            self.sm_counts.zero_()

        self.pieces.run(("eager_sweep",), sweep)

    def _split_merge(self, k_assign: Draws) -> None:
        mc = self.mcmc_cfg
        k_move, *keys = k_assign.split(6)
        self.pieces.run(("sm_head",), lambda: self.split.copy_(sm_choice(
            k_move, self.state, self.cfg, mc.sm_split_ratio)))
        # The host read: one a move.
        is_split = bool(trace.read(self.split, "split"))
        if trace.on:
            trace.note_split([is_split])

        def move():
            state, counts = _move(is_split, keys, self.state, self.data,
                                  self.cfg, mc.sm_steps)
            _write(self.state, state)
            self.sm_counts.copy_(counts)

        self.pieces.run(("sm_move", is_split), move)

    def _rest(self, flags, k_dpa, k_par, k_err) -> None:
        sm_counts = None if self.mcmc_cfg.fix_assign else self.sm_counts
        state, row = self._finish(self.state, flags, None, sm_counts, k_dpa,
                                  k_par, k_err)
        _write(self.state, state)
        self._put_row(row)


def _batch_block(step, states: list[CRPState], draws: list[Draws],
                 n_steps: int, keep: int | None = None,
                 coupled: bool = False):
    """A block of every chain of `states` as one batch (chain_exec="vmap"):
    the chains stacked into one batched state, each step one batched step
    on a StackedDraws of the chains' step draws (coupled: the coupled step,
    chain 0's step draws driving the shared move choice), unstacked at the
    block's end. Returns what _make_block's block returns."""
    keys = [d.split(n_steps + 1) for d in draws]
    batch, rows = stack_states(states), []

    def one(t):
        nonlocal batch
        if coupled:
            batch, row = step(batch, keys[0][1 + t], _own_streams(keys, 1 + t))
        else:
            batch, row = step(batch, StackedDraws([k[1 + t] for k in keys]))
        rows.append(row)

    def end():
        host = _rows_to_host(rows)  # [steps, chains, ...]
        return unstack_states(batch), {
            f: np.ascontiguousarray(np.swapaxes(v, 0, 1))
            for f, v in host.items()}, [k[0] for k in keys]

    return _block_loop(n_steps, keep, len(states), one, end)


def _coupled_chains(step, states: list[CRPState], draws: list[Draws],
                    n_steps: int, keep: int | None = None):
    """A block of coupled chains one after another within each step
    (chain_exec="sequential"): make_coupled_step_fn's step on the list of
    states, chain 0's key stream driving the shared move choice (bnpc_tpu
    _pipe_coupled); every chain's key advances. Returns what _make_block's
    block returns."""
    keys = [d.split(n_steps + 1) for d in draws]
    rows = [[] for _ in states]

    def one(t):
        nonlocal states
        states, step_rows = step(states, keys[0][1 + t],
                                 _own_streams(keys, 1 + t))
        for chain_rows, row in zip(rows, step_rows):
            chain_rows.append(row)

    def end():
        blocks = [_rows_to_host(r) for r in rows]
        return states, {f: np.stack([b[f] for b in blocks])
                        for f in TraceRow._fields}, [k[0] for k in keys]

    return _block_loop(n_steps, keep, len(states), one, end)


class _CapturedBatch(_Captured):
    """A block of C > 1 chains as one batch on the card (chain_exec="vmap",
    exact or coupled), each step's device-only pieces replayed as CUDA
    graphs between the step's host reads (graphs.py; the counterpart of
    bnpc_tpu's compiled batch: ``_pipe_vmap``, jax.vmap of
    ``make_block_fn``'s scan, and ``_pipe_coupled``, a scan of
    ``make_coupled_step_fn``). For the Gibbs impls ``lazy``, ``stream`` and
    ``blocked`` (uncoupled: the coupled step runs the exact sweep, as
    bnpc_tpu's does).

    A step makes the eager batched step's host reads (``_batch_block``
    over ``make_step_fn`` or ``make_coupled_step_fn``) and no more: the
    move uniforms (select, eager: one draw a chain, or chain 0's draw of a
    coupled step), the split flags of the split-merge chains together with
    the sweep's first round, and each later round's info. A move that only
    some chains take runs on their sub-batch, as ``state.py::by_chain_flag``
    runs it; which chains those are is known on the host but never reaches
    a graph: every piece is keyed by how many chains take its branch, and
    takes the chains themselves as device indices, the stable argsort of
    the device flags (or of the round's births) that by_chain_flag orders
    them by. The pieces, the eager batch's own functions on the sub-batch:

      * ("head", ks): the ks split-merge chains' sm_choice and the other
        C - ks chains' segment_start (draws, Z, staging, first launch),
        their indices and the first host read's buffer;
      * ("split", ns), ("merge", nm): splitmerge._move on the chains that
        split, and on those that merge;
      * ("birth", nb): segment_births on the round's nb born chains;
        ("launch", kg): the relaunch of the kg-chain sweep;
        ("tail", kg): segment_finish into the state;
      * blocked: the head runs blocked_start and the first frozen pass on
        the kg chains; then ("bcell", kg): blocked_cell, one cell of every
        replaying chain's birth block; ("bbirth", nb): blocked_births on
        the cell's nb born chains; ("bpass", kg): the next frozen pass, from
        block 0 (each chain starts at its own g0 on the device);
        ("btail", kg): blocked_finish into the state;
      * ("alpha", ka): the alpha resample of the ka chains that take it;
      * ("params",): the cluster statistics and the parameter MH;
      * ("errors", ke): the error-rate MH of ke chains (none: ke = 0) and
        the trace row, written into [rows_cap, C, ...] device buffers at a
        device step index.

    Chain c must draw from its own stream, as it does in its sequential
    run, but a graph draws from the generators it registered at capture.
    So the block owns C slot generators; a piece of k chains draws from
    slots 0..k-1 (``_run``): slot j takes the state of the j-th chain's
    generator before the piece runs and gives it back after (host values,
    no sync). Everything that crosses pieces lives in static tensors made
    at the first run (per chain count): the batched state, one
    SegmentWork or BlockedWork of C rows (a sweep of k chains works on its
    first k rows, contiguous prefixes), the move uniforms, the index
    buffers, the statistics, counts and row buffers. Each step gives bit
    for bit what ``_batch_block`` over the eager batched step gives on the
    same draws."""

    NAME, IMPLS = "batch", ("lazy", "stream", "blocked")

    def _setup(self, batch: CRPState) -> None:
        """The slot generators, the graphs and the static buffers, shaped
        after the batched state `batch`."""
        dev, c = self.device, batch.assignment.shape[0]
        self.n_chains, self.thresholds = c, _thresholds(self.mcmc_cfg)
        self.slots = [TorchDraws(0, dev) for _ in range(c)]
        self.pieces = graphs.Pieces(None, piece_family, self.graph_cls)
        self.state = CRPState(*(torch.empty_like(f) for f in batch))
        self.work = _sweep_work(self.impl, self.state, self.cfg,
                                self.mcmc_cfg)

        def zeros(*shape, dtype=torch.long):
            return torch.zeros(shape, dtype=dtype, device=dev)

        i32, f32 = torch.int32, torch.float32
        self.u = zeros(c, 3, dtype=f32)
        # The sweep's chains and their error rates by SegmentWork row; the
        # chains that split and those that merge, each first.
        self.gidx, self.split_idx, self.merge_idx = (zeros(c), zeros(c),
                                                     zeros(c))
        self.gfp, self.gfn = zeros(c, dtype=f32), zeros(c, dtype=f32)
        # The head's host read: split flags, then the sweep's read rows
        # (blocked: [first birth block, -] a chain).
        self.hread = zeros(7 * c, dtype=i32)
        self.sm_counts = zeros(c, 2, 2, dtype=i32)
        self.par_counts = zeros(c, 2, dtype=i32)
        k, m = self.cfg.k_max, batch.params.shape[-1]
        self.n1, self.n0 = zeros(c, k, m, dtype=f32), zeros(c, k, m,
                                                           dtype=f32)
        self._setup_rows(batch)

    def statics(self) -> list[torch.Tensor]:
        """Every static tensor the pieces read and write."""
        return [*self.state, *self.work, self.u, self.gidx, self.split_idx,
                self.merge_idx, self.gfp, self.gfn, self.hread,
                self.sm_counts, self.par_counts, self.n1, self.n0, self.t,
                *self.rows]

    def run(self, states: list[CRPState], draws: list[Draws], n_steps: int,
            keep: int | None = None, coupled: bool = False):
        """What ``_batch_block`` returns for the eager batched step (the
        coupled one with `coupled`): (states, rows, next_draws), `draws`
        one TorchDraws a chain on the block's device (each generator's
        state moves on as its chain draws)."""
        if coupled and self.impl == "blocked":
            raise ValueError("the coupled step runs the exact sweep, not "
                             "the blocked one")
        self._copy_in(draws, stack_states(states))
        # A TorchDraws splits into itself: each chain's next draws are its
        # own, moved on.
        return self._loop(n_steps, keep, len(states),
                          lambda t: self._step(draws, coupled),
                          lambda rows: (unstack_states(self.state), {
                              f: np.ascontiguousarray(np.swapaxes(v, 0, 1))
                              for f, v in rows.items()}, list(draws)))

    def _run(self, key, draws, chains, fn) -> None:
        """Piece `fn` under `key`, slot j drawing for chain chains[j]."""
        slots = [self.slots[j].gen for j in range(len(chains))]
        for gen, c in zip(slots, chains):
            gen.set_state(draws[c].gen.get_state())
        self.pieces.run(key, fn, tuple(slots))
        for gen, c in zip(slots, chains):
            draws[c].gen.set_state(gen.get_state())

    def _flag(self, j: int) -> torch.Tensor:
        """Flag j of every chain on the device (select's flags_dev)."""
        return self.u[:, j] < self.thresholds[j]

    def _first(self, flag: torch.Tensor) -> torch.Tensor:
        """The chains where `flag` holds, then the others, each in chain
        order: by_chain_flag's order."""
        return torch.argsort((~flag).to(torch.int8), stable=True)

    def _step(self, draws: list[TorchDraws], coupled: bool) -> None:
        mc, c = self.mcmc_cfg, self.n_chains
        if coupled:
            # Chain 0's step draws drive the shared move choice.
            u0 = draws[0].uniform((3,))
            self.u.copy_(u0.expand(c, 3))
            # The step's first host read.
            rows = trace.read(u0[None], "select") * c
        else:
            torch.stack([d.uniform((3,)) for d in draws], out=self.u)
            rows = trace.read(self.u, "select")  # the step's first host read
        flags = [[x < t for x, t in zip(row, self.thresholds)]
                 for row in rows]
        if trace.on:
            trace.note_flags(flags)
        if not mc.fix_assign:
            sm = [i for i in range(c) if mc.sm_prob > 0.0 and flags[i][0]]
            self._assign(draws, sm, [i for i in range(c) if i not in sm])
        if not mc.fix_assign and mc.dpa_prob > 0.0:
            alpha = [i for i in range(c) if flags[i][1]]
            if alpha:
                self._run(("alpha", len(alpha)), draws, alpha,
                          functools.partial(self._alpha, len(alpha)))
        self._run(("params",), draws, range(c), self._params)
        errs = ([i for i in range(c) if flags[i][2]]
                if self.cfg.learn_errors and mc.error_prob > 0.0 else [])
        self._run(("errors", len(errs)), draws, errs,
                  functools.partial(self._errors, len(errs)))

    def _ws(self, k: int):
        """The first `k` rows of the sweep's buffers."""
        if self.impl == "blocked":
            return blocked_rows(self.work, k)
        return SegmentWork(*(f[:k] for f in self.work))

    def _assign(self, draws, sm: list[int], gibbs: list[int]) -> None:
        """The assignment move: split-merge on the chains `sm`, the sweep
        on the chains `gibbs`."""
        ks, kg, n = len(sm), len(gibbs), self.cfg.n_cells
        blocked = self.impl == "blocked"
        self._run(("head", ks), draws, sm + gibbs,
                  functools.partial(self._head, ks))
        # Split flags, then the sweep's first round or pass.
        width = 2 if blocked else self.work.read.shape[1]
        read = trace.read(self.hread[:ks + width * kg],
                          ("blocked_pass" if blocked else "round") if kg
                          else "split")
        if trace.on and kg and not blocked:
            trace.count("sweeps", kg)
        if ks:
            if trace.on:
                trace.note_split(read[:ks])
            split = [i for i, f in zip(sm, read[:ks]) if f]
            merge = [i for i, f in zip(sm, read[:ks]) if not f]
            if split:
                self._run(("split", len(split)), draws, split,
                          functools.partial(self._sm_move, True, len(split)))
            if merge:
                self._run(("merge", len(merge)), draws, merge,
                          functools.partial(self._sm_move, False,
                                            len(merge)))
        if not kg:
            return
        if blocked:
            self._blocked(draws, gibbs, read[ks::2])
            return
        rows = [read[ks + width * r:ks + width * (r + 1)]
                for r in range(kg)]
        while True:
            births = [(r, row[4]) for r, row in enumerate(rows)
                      if row[1] >= 0]
            done = all(row[0] >= n for row in rows)
            if births:
                self._run(("birth", len(births)), draws,
                          [gibbs[r] for r, _ in births], functools.partial(
                              segment_births, self.work, births, self.slots,
                              self.gfp, self.gfn, self.data, self.cfg,
                              stream=self.stream, relaunch=False))
                if not done:
                    self._run(("launch", kg), draws, [], functools.partial(
                        _launch, self._ws(kg), self.stream))
            if done:
                break
            rows = trace.read(self.work.read[:kg], "round")  # one a round
        if trace.on and not self.stream:
            count_full_picks(rows, n)
        self._run(("tail", kg), draws, [],
                  functools.partial(self._tail, segment_finish, kg))

    def _blocked(self, draws, gibbs: list[int], first: list[int]) -> None:
        """The blocked sweep's rounds on the chains `gibbs` after the head's
        first pass; `first` holds each one's first birth block."""
        kg = len(gibbs)
        ws = self._ws(kg)
        blocked_rounds(
            ws, first,
            lambda: self._run(("bcell", kg), draws, [],
                              functools.partial(blocked_cell, ws)),
            lambda births: self._run(
                ("bbirth", len(births)), draws,
                [gibbs[r] for r, _ in births], functools.partial(
                    blocked_births, self.work, births, self.slots, self.gfp,
                    self.gfn, self.data, self.cfg)),
            lambda g_lo: self._run(("bpass", kg), draws, [],
                                   functools.partial(blocked_pass, ws)))
        self._run(("btail", kg), draws, [],
                  functools.partial(self._tail, blocked_finish, kg))

    def _head(self, ks: int) -> None:
        c, cfg, st = self.n_chains, self.cfg, self.state
        kg = c - ks
        order = self._first(self._flag(0))
        if ks:
            idx = order[:ks]
            k_move = StackedDraws(self.slots[:ks]).split(6)[0]
            split = sm_choice(k_move, take_states(st, idx), cfg,
                              self.mcmc_cfg.sm_split_ratio)
            self.split_idx[:ks].copy_(idx[self._first(split)])
            self.merge_idx[:ks].copy_(idx[self._first(~split)])
            self.hread[:ks].copy_(split)
        if kg:
            idx = order[ks:]
            sub = take_states(st, idx)
            self.gidx[:kg].copy_(idx)
            self.gfp[:kg].copy_(sub.fp)
            self.gfn[:kg].copy_(sub.fn)
            ax = ChainAxis(chains=kg)
            k_perm, k_gumbel, _ = _split_sweep_keys(
                StackedDraws(self.slots[ks:]), ax)
            ws = self._ws(kg)
            if self.impl == "blocked":
                blocked_start(ws, k_perm, k_gumbel, sub, self.data, cfg, ax)
                blocked_pass(ws)
                # Rows past the sweep's hold no birth for blocked_births.
                self.work.read[kg:, 0].fill_(0)
            else:
                segment_start(ws, k_perm, k_gumbel, sub, self.data, cfg, ax,
                              stream=self.stream)
                # Rows past the sweep's hold no birth for segment_births.
                self.work.read[kg:, 1].fill_(-1)
            self.hread[ks:ks + ws.read.numel()].copy_(ws.read.reshape(-1))

    def _put(self, idx: torch.Tensor, sub: CRPState) -> None:
        for f, g in zip(self.state, sub):
            f.index_copy_(0, idx, g)

    def _sm_move(self, is_split: bool, k: int) -> None:
        idx = (self.split_idx if is_split else self.merge_idx)[:k]
        keys = StackedDraws(self.slots[:k]).split(6)[1:]
        sub, counts = _move(is_split, keys, take_states(self.state, idx),
                            self.data, self.cfg, self.mcmc_cfg.sm_steps,
                            ChainAxis(chains=k))
        self._put(idx, sub)
        self.sm_counts.index_copy_(0, idx, counts)

    def _tail(self, finish, kg: int) -> None:
        """`finish` (segment_finish or blocked_finish) on the sweep's first
        kg rows, into the sweep's chains."""
        idx = self.gidx[:kg]
        self._put(idx, finish(self._ws(kg), take_states(self.state, idx)))

    def _alpha(self, k: int) -> None:
        idx = self._first(self._flag(1))[:k]
        self._put(idx, update_dp_alpha(StackedDraws(self.slots[:k]),
                                       take_states(self.state, idx),
                                       self.cfg))

    def _params(self) -> None:
        st, c = self.state, self.n_chains
        n1, n0 = cluster_stats(self.data, st.assignment, self.cfg.k_max)
        self.n1.copy_(n1)
        self.n0.copy_(n0)
        new, dec, acc = update_parameters(StackedDraws(self.slots), st, n1,
                                          n0, self.cfg, ChainAxis(chains=c))
        st.params.copy_(new.params)
        self.par_counts.copy_(torch.stack([acc, dec], -1))

    def _errors(self, k: int) -> None:
        st, c = self.state, self.n_chains
        counts = torch.zeros((c, 5, 2), dtype=torch.int32, device=self.device)
        counts[:, 1:3, :] += self.sm_counts
        counts[:, 0, :] += self.par_counts
        ml = None
        if k:
            idx = self._first(self._flag(2))[:k]
            sub, fp_acc, fn_acc, ll = update_error_rates(
                StackedDraws(self.slots[:k]), take_states(st, idx),
                self.n1[idx], self.n0[idx], self.cfg, ChainAxis(chains=k))
            self._put(idx, sub)
            acc = torch.stack([fp_acc, fn_acc], -1).to(torch.int32)
            counts[:, 3:5, :] += torch.zeros_like(counts[:, 3:5, :]) \
                .index_copy(0, idx, torch.stack([acc, 1 - acc], -1))
            if k == c:  # every chain moved: the rows' ML
                ml = torch.empty_like(ll).index_copy_(0, idx, ll)
        row = summarize(st, self.data, self.cfg, self.trace_k,
                        stats=StepStats(self.n1, self.n0, ml),
                        ax=ChainAxis(chains=c))
        self._put_row(row._replace(mh_counts=counts))
        self.sm_counts.zero_()


def _form(cuda: bool, mesh: bool, sharded: bool, impl: str, exact: str,
          chain_exec: str, coupled: bool, n_chains: int):
    """The seam's table: the executor of a block of `n_chains` chains as
    (name, impl, coupled), `impl` None for the eager ones. Only on the card
    (`cuda`) outside a mesh (or a sharded axis) do CAPTURED_IMPLS run
    captured. Coupled moves bind more than one chain outside a sharded
    axis: within each step one after another under "sequential", as one
    batch on the exact sweep `exact` under "vmap"."""
    capture = cuda and not mesh
    coupled = coupled and not sharded and n_chains > 1
    if coupled and chain_exec == "sequential":
        return "_coupled_chains", None, True
    if chain_exec == "vmap" and n_chains > 1:
        impl = exact if coupled else impl
        if capture and impl in CAPTURED_IMPLS:
            return "_CapturedBatch", impl, coupled
        return "_batch_block", None, coupled
    if capture and impl in CAPTURED_IMPLS:
        return "_CapturedBlock", impl, False
    return "_chain_block", None, False


def _make_block(cfg: ModelConfig, mcmc_cfg: MCMCConfig, data: PackedData,
                trace_k: int, ax: MutAxis = _NO_AXIS,
                gibbs_impl: str = "auto", chain_exec: str = "auto",
                mesh=None, rows_cap: int = 256, graphs_for=None):
    """The one place that decides how a block of chains runs:
    block(states, draws, n_steps, keep=None) -> (states, rows, next_draws)
    runs every chain of `states` by the executor ``_form`` names; rows hold
    [chains, steps, ...] host arrays ({} without chains). `chain_exec` is
    resolved here, once. A captured executor is made at its first block
    and kept, its graphs with it. `graphs_for(executor)`, its graph class,
    stands in for the card: the captured forms then run on any device.
    Attributes: ``chain_exec``, the eager ``step`` and ``coupled_step``,
    their ``cfg``, ``data`` and ``ax``, and ``executors`` made so far."""
    device = data.xm.device
    chain_exec = resolve_chain_exec(chain_exec, device, mesh,
                                    mcmc_cfg.gibbs_block,
                                    mcmc_cfg.coupled_moves)
    if chain_exec == "vmap":
        _check_chains_step(gibbs_impl)
    on_cuda = device.type == "cuda"
    step = make_step_fn(cfg, mcmc_cfg, data, trace_k, ax, gibbs_impl)
    coupled_step = make_coupled_step_fn(cfg, mcmc_cfg, data, trace_k,
                                        gibbs_impl)
    exact = resolve_impl(gibbs_impl, cfg, on_cuda)
    table = functools.partial(
        _form, on_cuda or graphs_for is not None,
        mesh is not None or ax.sharded, ax.sharded,
        "blocked" if mcmc_cfg.gibbs_block > 0 else exact, exact, chain_exec,
        mcmc_cfg.coupled_moves)
    executors = {}

    def captured(cls, impl):
        if (cls, impl) not in executors:
            ex = cls(cfg, mcmc_cfg, data, trace_k, impl, device, rows_cap)
            if graphs_for is not None:
                ex.graph_cls = graphs_for(ex)
            executors[cls, impl] = ex
        return executors[cls, impl]

    def block(states, draws, n_steps: int, keep: int | None = None):
        if not states:
            return [], {}, []
        name, impl, coupled = table(len(states))
        if name == "_CapturedBatch":
            return captured(_CapturedBatch, impl).run(
                states, draws, n_steps, keep, coupled=coupled)
        if name == "_batch_block":
            return _batch_block(coupled_step if coupled else step, states,
                                draws, n_steps, keep, coupled)
        if name == "_coupled_chains":
            return _coupled_chains(coupled_step, states, draws, n_steps,
                                   keep)
        one = (captured(_CapturedBlock, impl).run
               if name == "_CapturedBlock"
               else functools.partial(_chain_block, step))
        out = [one(st, d, n_steps, keep) for st, d in zip(states, draws)]
        states, rows, draws = (list(x) for x in zip(*out))
        return states, {f: np.stack([r[f] for r in rows])
                        for f in TraceRow._fields}, draws

    block.chain_exec, block.step, block.coupled_step = (chain_exec, step,
                                                        coupled_step)
    block.cfg, block.data, block.ax = cfg, data, ax
    block.executors = executors
    return block


def _one_chain(block, state: CRPState, draws: Draws, n_steps: int,
               keep: int | None = None):
    """`block` (``_make_block``'s) on one chain: (state, rows, next_draws),
    rows with a leading step axis."""
    states, rows, nxt = block([state], [draws], n_steps, keep)
    return states[0], {f: v[0] for f, v in rows.items()}, nxt[0]


def make_block_fn(cfg: ModelConfig, mcmc_cfg: MCMCConfig, data: PackedData,
                  trace_k: int, ax: MutAxis = _NO_AXIS,
                  gibbs_impl: str = "auto"):
    """A block of make_step_fn's steps (bnpc_tpu make_block_fn, a
    ``lax.scan`` of the step): block(state, draws, n_steps, keep=None) ->
    (state, rows, next_draws), ``_chain_block``'s signature: one chain
    through ``_make_block``, captured on a CUDA device with an unsharded
    `ax` (rows reaching the host every 256 steps), else ``_chain_block``
    over the eager step (``scan`` reads the host a cell, and no graph
    holds a sharded `ax`'s gloo all-reduces). ``executors`` holds the
    captured block once it is made."""
    block = _make_block(cfg, mcmc_cfg, data, trace_k, ax, gibbs_impl,
                        "sequential")
    one = functools.partial(_one_chain, block)
    one.executors = block.executors
    return one


class _TraceBuffer:
    """Host trace blocks, one dict of [n_chains, block, ...] arrays a block
    (bnpc_tpu's _TraceBuffer without its relay workarounds: rows arrive on
    the host, trace_k columns wide).

    ``params_from`` bounds host memory for the big params field: params
    rows with a global row index (initial state = row 0, step s = row s)
    below it are dropped at append time, as the reference records params
    only after burn-in (libs/MCMC.py:260-282). Scalar and assignment traces
    are kept at full rate. A block appended with an already-trimmed params
    field (a checkpoint's trace) is recognized by its row count."""

    def __init__(self, n_chains: int, params_from: int = 0):
        self.rows: list[dict] = []
        self.n_chains = n_chains
        self.params_from = params_from
        self._next = 1  # global row index of the next appended step row

    def append(self, rows: dict):
        b = rows["ml"].shape[1]
        bp = rows["params"].shape[1]
        lo = max(0, min(b, self.params_from - self._next))
        self._next += b
        if bp == b:
            if lo:
                rows = {**rows, "params": rows["params"][:, lo:]}
        elif bp != b - lo:
            raise ValueError(
                f"block with {bp} params rows does not match either the "
                f"full ({b}) or the trimmed ({b - lo}) row count")
        self.rows.append(rows)

    def concat(self, fields=TraceRow._fields) -> dict:
        return {f: np.concatenate([r[f] for r in self.rows], axis=1)
                for f in fields}

    def trim_params(self, new_from: int):
        """Ratchet ``params_from`` upward, dropping retained params rows
        with a global index below ``new_from`` (lugsail's burn-in grows
        with the trace; the reference trims once at the end,
        libs/MCMC.py:173-177)."""
        if new_from <= self.params_from:
            return
        self.params_from = new_from
        start = 1  # global row index of block 0's first step row
        for i, r in enumerate(self.rows):
            b = r["ml"].shape[1]
            bp = r["params"].shape[1]
            p_start = start + (b - bp)  # earlier trims drop LEADING rows
            k = min(new_from - p_start, bp)
            if k > 0:
                # A slice is a view that pins its base: copy to free it.
                self.rows[i] = {**r, "params": r["params"][:, k:].copy()}
            start += b

    @property
    def n_steps(self) -> int:
        return sum(r["ml"].shape[1] for r in self.rows)


# Tag of the port's checkpoint files: they hold torch generator states, so
# no other sampler's checkpoint can resume this one.
CHECKPOINT_FORMAT = "bnpc_tpu_torch.mcmc/1"

CHAIN_EXECS = ("auto", "sequential", "vmap")

# What chain_exec="auto" takes on a CUDA device for more than one exact,
# uncoupled chain: "vmap" only where chip_smoke.py phase 12 measured the
# batch at or above the sequential chain-steps/s at both cells (main cell
# 4 x 128 and 16 x 64, large-n 2 x 16) in every call. With both forms
# captured the batch fell short (NVIDIA H100 80GB HBM3, 700.00 W, six
# calls, PERF.md §6): main 4 chains 0.511-1.357 x, 16 chains 0.996-1.446
# x, large-n 2 chains 0.939-1.033 x, a fresh runner a run (each run holds
# its captures). So "sequential". On the CPU "auto" takes "sequential".
AUTO_CUDA_CHAIN_EXEC = "sequential"
# Coupled chains (coupled_moves) take their own rule in its place: phase
# 12 (d), the captured coupled batch against the coupled chains one after
# another, 3.644-5.912 x in each of five calls, so "vmap". A blocked sweep
# (gibbs_block > 0) takes the exact or coupled rule (PERF.md §6 has its
# own measurements). A rank's local chains under a mesh take a rule beside
# those (phase 11 (e), two ranks sharing the card, NVIDIA H100 80GB HBM3,
# 700 W): 1 x 2 with 2 chains 1.093-1.212 x, but 2 x 1 with 2 chains a
# rank 0.557, 1.125 and 0.990 x, so "sequential".
AUTO_CUDA_COUPLED_CHAIN_EXEC = "vmap"
AUTO_CUDA_MESH_CHAIN_EXEC = "sequential"


def resolve_chain_exec(chain_exec: str, device, mesh=None,
                       gibbs_block: int = 0, coupled: bool = False) -> str:
    """"auto" -> "vmap" on CUDA where every rule that applies takes it
    (AUTO_CUDA_CHAIN_EXEC, or AUTO_CUDA_COUPLED_CHAIN_EXEC for coupled
    chains; AUTO_CUDA_MESH_CHAIN_EXEC under a mesh), "sequential" otherwise
    and on the CPU. `gibbs_block` adds no rule of its own."""
    if chain_exec not in CHAIN_EXECS:
        raise ValueError(f"chain_exec={chain_exec!r}; expected one of "
                         f"{CHAIN_EXECS}")
    if chain_exec != "auto":
        return chain_exec
    rules = [AUTO_CUDA_COUPLED_CHAIN_EXEC if coupled
             else AUTO_CUDA_CHAIN_EXEC] + (
        [] if mesh is None else [AUTO_CUDA_MESH_CHAIN_EXEC])
    batchable = (torch.device(device).type == "cuda"
                 and all(r == "vmap" for r in rules))
    return "vmap" if batchable else "sequential"


class MCMCRunner:
    """Multi-chain scheduler (reference MCMC class, libs/MCMC.py:26-193) on
    an explicit device.

    ``chain_exec`` says how several chains run (bnpc_tpu's names):

      * "sequential": one after another, each block of each chain on the
        device (the form bnpc_tpu takes on one device whenever its kernels
        run);
      * "vmap": every chain of the run steps at once as one batch with a
        leading chain axis (``make_step_fn``), the sampler kernels on
        a grid of one block a chain. This is the port's own chain-axis
        step, not ``torch.func.vmap``; unlike bnpc_tpu's vmapped scan it
        keeps the kernels. Chain c gets exactly what its sequential run
        gets on the same draws. The blocked sweep (gibbs_block > 0) runs
        batched too; the eager sweep is refused. Under a mesh a rank's
        local chains form the batch;
      * "auto": see ``resolve_chain_exec`` (PERF.md §6 has the
        measurements behind its rules); "sequential" on the CPU.

    ``_make_block`` makes the runner's one block and decides how it runs
    (the module docstring). With ``mcmc_cfg.coupled_moves`` and more than
    one chain the chains step in lockstep with one shared move selection a
    step, batched under "vmap" (bnpc_tpu's coupled pipe) and one after
    another within each step under "sequential" (bnpc_tpu honours it only
    on its vmapped path; the port honours it whenever n_chains > 1).
    Checkpoints hold one state a chain under either, so a run saved under
    one resumes under the other.
    ``checkpoint_dir`` saves the run every ``checkpoint_every`` blocks and
    resumes from it, in all three modes.

    With a ``mesh`` (parallel/sharded.py::make_mesh: one process per rank,
    ``C x M``) every rank constructs the runner with the whole data and
    runs ``run`` with the same arguments. Which rank runs what follows
    bnpc_tpu's precedence (mcmc.py:806-834):

      * M > 1: chain shard c runs chains c * n / C ... (c + 1) * n / C - 1,
        each rank of its mutation group on its columns
        (parallel/sharded.py::make_sharded_block), one after another or
        under "vmap" as one batch; ``coupled_moves`` is not honoured
        there, as bnpc_tpu's sharded block does not honour it;
      * else, several chains with ``coupled_moves``: the coupled step runs
        every chain on chain shard 0 (bnpc_tpu's coupled pipe, which it
        takes before its chain-sharded block); the other ranks hold none;
      * else: chain shard c runs its n / C chains, one after another or
        as one batch.

    Chain c starts from the seed or key it has in the one-process run, so
    under a ``C x 1`` mesh each chain is its one-process run. Rank 0
    gathers every rank's trace rows once a block (and holds the replicated
    fields of each mutation group against each other), decides the time
    and lugsail modes' stops and broadcasts them, writes and reads the
    checkpoint (every chain's state and every rank's generators) and
    returns the results; the other ranks return None. ``final_states``
    holds this rank's chain states after a run."""

    def __init__(self, cfg: ModelConfig, mcmc_cfg: MCMCConfig,
                 data: PackedData, device, block_size: int = 256,
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int = 4, mesh=None,
                 chain_exec: str = "auto"):
        self.cfg = cfg
        self.mcmc_cfg = mcmc_cfg
        self.data = data
        self.device = torch.device(device)
        self.block_size = block_size
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.trace_k = resolve_trace_k(cfg, mcmc_cfg)
        self.mesh = mesh
        self.m_pad = cfg.n_muts
        # How every block of this rank's chains runs (the seam, _make_block):
        # under a mesh on this rank's columns of the padded matrix.
        if mesh is None:
            self._block = _make_block(cfg, mcmc_cfg, data, self.trace_k,
                                      chain_exec=chain_exec,
                                      rows_cap=block_size)
        else:
            from bnpc_tpu_torch.data import pad_muts
            from bnpc_tpu_torch.parallel import sharded

            padded, self.m_pad = pad_muts(data, mesh.muts)
            self._block = sharded.make_sharded_block(mesh, cfg, mcmc_cfg,
                                                     padded, chain_exec)
        self.chain_exec, self.ax = self._block.chain_exec, self._block.ax
        # The seed of each chain of the last run() (args.txt's chain_seeds).
        self.seeds: np.ndarray | None = None
        self.final_states: list[CRPState] = []
        self._n_chains = 1
        self._local: list[int] = [0]
        # Injectable clock (deterministic time-mode tests stub this).
        self._now = datetime.now
        self._verbosity = 1

    @property
    def is_root(self) -> bool:
        return self.mesh is None or self.mesh.is_root

    # -- low level ---------------------------------------------------------

    def init_chains(self, draws: Draws, n_chains: int = 1,
                    assign=None) -> list[CRPState]:
        """Initial state of each chain, chain c from draws.split(n_chains)[c]
        as in bnpc_tpu: `assign` relabelled to compact slots, else random
        (init_state mode 'random'). Whole-matrix states."""
        return [init_state(d, self.cfg, self.data, self.device,
                           mode="random", assign=assign)
                for d in draws.split(n_chains)]

    def run_block(self, state: CRPState, draws: Draws, n_steps: int,
                  keep: int | None = None):
        """One chain's block of `n_steps` steps, or its first `keep` steps
        (a partial final block takes the keys of a whole block, as bnpc_tpu
        does), as run_chains runs it. Returns (state, rows, next_draws):
        rows is a dict of host arrays with a leading step axis, one entry
        per TraceRow field."""
        return _one_chain(self._block, state, draws, n_steps, keep)

    def run_chains(self, states: list[CRPState], draws: list[Draws],
                   n_steps: int, keep: int | None = None):
        """One block of every chain of this rank (see run_block), as
        ``_make_block`` decides: one after another or, under
        chain_exec="vmap", as one batch; coupled chains in lockstep (unless
        the mutation axis is sharded). Returns (states, rows, next_draws);
        rows hold [n_chains, steps, ...] host arrays (an empty dict on a
        rank without chains)."""
        if trace.on:
            trace.new_run()
        return self._block(states, draws, n_steps, keep)

    def _init_rows(self, states) -> dict | None:
        """Each chain's initial-state row, [n_chains, 1, ...] (on rank 0
        under a mesh, None elsewhere)."""
        rows = [_rows_to_host([summarize(st, self._block.data,
                                         self._block.cfg, self.trace_k,
                                         ax=self.ax)])
                for st in states]
        return self._gather({f: np.stack([r[f] for r in rows])
                             for f in TraceRow._fields} if rows else {})

    # -- the mesh ------------------------------------------------------------

    def _chains_of(self, n_chains: int, rank: int) -> list[int]:
        """The chains rank `rank` runs (the class docstring's precedence)."""
        mesh = self.mesh
        if mesh is None:
            return list(range(n_chains))
        if n_chains % mesh.chains:
            raise ValueError(f"{n_chains} chains not divisible by the mesh's "
                             f"chain axis ({mesh.chains})")
        c = rank // mesh.muts
        if mesh.muts == 1 and n_chains > 1 and self.mcmc_cfg.coupled_moves:
            return list(range(n_chains)) if c == 0 else []
        per = n_chains // mesh.chains
        return list(range(c * per, (c + 1) * per))

    def _shard_state(self, st: CRPState) -> CRPState:
        """This rank's columns of a whole-matrix state, the params padded
        to m_pad with 0.5 first (bnpc_tpu mcmc.py:868-876)."""
        if not self.ax.sharded:
            return st
        params = torch.nn.functional.pad(
            st.params, (0, self.m_pad - st.params.shape[1]), value=0.5)
        w = self.m_pad // self.mesh.muts
        mu = self.mesh.mut_index
        return st._replace(params=params[:, mu * w:(mu + 1) * w].contiguous())

    def _gather(self, rows: dict) -> dict | None:
        """Every chain's rows on rank 0 (None on the others); the identity
        without a mesh."""
        if self.mesh is None:
            return rows
        from bnpc_tpu_torch.parallel import sharded

        return sharded.gather_rows(self.mesh, rows, self._local,
                                   self.cfg.n_muts)

    def _agree(self, value):
        """Rank 0's `value` on every rank (the identity without a mesh)."""
        if self.mesh is None:
            return value
        from bnpc_tpu_torch.parallel import sharded

        return sharded.broadcast(self.mesh, value)

    # -- top-level run (libs/MCMC.py:79-123) -------------------------------

    def run(self, run_var, seed: int | None = None, n_chains: int = 1,
            assign=None, verbosity: int = 1, draws: Draws | None = None):
        """run_var: (steps: int, burn_in: int) | (end: datetime,
        burn_in_end: datetime) | (cutoff: float, 0). `assign` fixes the
        initial assignment (-fa); at verbosity 2 each block prints its MH
        acceptance rates. Returns [ChainResult], one per chain (None on
        a rank other than 0 of a mesh).

        Without `draws`, a seed below 0 (or None) draws one; one chain runs
        on the seed's TorchDraws stream, and n > 1 chains on streams of
        their own, seeds[c] drawn from the seed: chain c is the one-chain
        run with seed seeds[c]. `draws` is a root provider whose key tree
        is bnpc_tpu's: k_init, k_run = draws.split(2); chain c starts from
        k_init.split(n)[c] and runs on k_run.split(n)[c]."""
        self._verbosity = verbosity
        self._n_chains = n_chains
        local = self._local = self._chains_of(
            n_chains, 0 if self.mesh is None else self.mesh.rank)
        if draws is None:
            if seed is None or seed < 0:
                seed = self._agree(int(np.random.randint(0, 2**31 - 1)))
            seeds = ([seed] if n_chains == 1 else np.random.default_rng(
                seed).integers(0, 2**31 - 1, n_chains))
            chains = [TorchDraws(int(seeds[c]), self.device) for c in local]
            states = [self.init_chains(d, 1, assign)[0] for d in chains]
        else:
            k_init, k_run = draws.split(2)
            seeds = k_init.randint((n_chains,), 0, 2**31 - 1).cpu().numpy()
            # Every chain's initial state: a shared stream is consumed in
            # chain order on every rank.
            states = self.init_chains(k_init, n_chains, assign)
            runs = k_run.split(n_chains)
            states, chains = ([states[c] for c in local],
                              [runs[c] for c in local])
        self.seeds = np.asarray(seeds, dtype=np.int64)
        if self.checkpoint_dir and not all(isinstance(d, TorchDraws)
                                           for d in chains):
            raise ValueError("checkpoints hold torch generator states: "
                             "run() with draws=None to checkpoint")
        states = [self._shard_state(st) for st in states]

        if isinstance(run_var[0], (int, np.integer)):
            return self._run_steps(states, chains, int(run_var[0]),
                                   int(run_var[1]))
        if isinstance(run_var[0], float):
            return self._run_lugsail(states, chains, float(run_var[0]),
                                     verbosity)
        return self._run_time(states, chains, run_var[0], run_var[1])

    # -- checkpoint / resume -----------------------------------------------

    def _ckpt_path(self, name: str) -> str | None:
        return os.path.join(self.checkpoint_dir, name) \
            if self.checkpoint_dir else None

    def _mesh_shape(self) -> tuple[int, int]:
        return (1, 1) if self.mesh is None else (self.mesh.chains,
                                                 self.mesh.muts)

    def save_checkpoint(self, path, states, draws, buf: _TraceBuffer,
                        done: int, init_rows: dict,
                        extra: dict | None = None):
        """The chains' states, generator states, initial rows and trace so
        far, written to a temporary file and moved over `path`. Under a
        mesh every rank sends its chains' states and generators to rank 0,
        which writes the one file: the params at the padded width, each
        chain's generator, and each rank's shard generator."""
        part = {f"state_{f}": np.stack([getattr(st, f).cpu().numpy()
                                        for st in states])
                for f in CRPState._fields} if states else {}
        if states:
            part["generator_state"] = np.stack([d.gen.get_state().numpy()
                                                for d in draws])
            if self.ax.sharded:
                part["axis_generator_state"] = np.stack([
                    d.fold_axis(self.ax.index).gen.get_state().numpy()
                    for d in draws])
        if self.mesh is None:
            chains = part
        else:
            from bnpc_tpu_torch.parallel import sharded

            parts = sharded.gather(self.mesh, (self._local,
                                               self.mesh.mut_index, part))
            if not self.mesh.is_root:
                return
            chains = sharded.assemble(
                self.mesh, parts, None,
                sharded_fields=("state_params",),
                stacked_fields=("axis_generator_state",))
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = {
            "format": np.asarray(CHECKPOINT_FORMAT),
            "done": np.asarray(done),
            "generator_device": np.asarray(self.device.type),
            "mesh": np.asarray(self._mesh_shape()),
            **chains,
        }
        for k, v in (extra or {}).items():
            payload[f"extra_{k}"] = np.asarray(v)
        for f, v in init_rows.items():
            payload[f"init_{f}"] = v
        if buf.rows:
            for f, v in buf.concat().items():
                payload[f"trace_{f}"] = v
        tmp = path + ".tmp.npz"
        np.savez_compressed(tmp, **payload)
        os.replace(tmp, path)

    def _read_checkpoint(self, path) -> dict:
        """The checkpoint at `path` as a dict of arrays, after refusing a
        file without the port's format tag, from another device type,
        mesh shape or chain count."""
        with np.load(path) as z:
            tag = str(z["format"]) if "format" in z.files else None
            if tag != CHECKPOINT_FORMAT:
                raise ValueError(
                    f"{path}: not a checkpoint of bnpc_tpu_torch (format "
                    f"{tag!r}, expected {CHECKPOINT_FORMAT!r}); its random "
                    "state cannot resume this sampler: remove it or use "
                    "another checkpoint directory")
            dev = str(z["generator_device"])
            if dev != self.device.type:
                raise ValueError(
                    f"{path}: checkpoint of a {dev} run; this run samples "
                    f"on {self.device.type}, whose generator differs")
            saved = (tuple(int(x) for x in z["mesh"]) if "mesh" in z.files
                     else (1, 1))
            if saved != self._mesh_shape():
                raise ValueError(
                    f"{path}: checkpoint of a {saved[0]}x{saved[1]} mesh "
                    "(chains x mutation shards); this run's mesh is "
                    f"{self._mesh_shape()[0]}x{self._mesh_shape()[1]}: "
                    f"resume with --mesh {saved[0]},{saved[1]} or use "
                    "another checkpoint directory")
            n = z["generator_state"].shape[0]
            if n != self._n_chains:
                raise ValueError(f"{path}: checkpoint of {n} chains; this "
                                 f"run has {self._n_chains}")
            return {k: z[k] for k in z.files}

    def _rank_part(self, z: dict, rank: int) -> dict:
        """What rank `rank` resumes from: its chains' states (its columns
        of the params) and generator states."""
        ids = self._chains_of(self._n_chains, rank)
        part = {k: z[k][ids] for k in z if k.startswith("state_")
                or k == "generator_state"}
        if self.mesh is not None and self.mesh.muts > 1:
            mu, w = rank % self.mesh.muts, self.m_pad // self.mesh.muts
            part["state_params"] = part["state_params"][..., mu * w:
                                                        (mu + 1) * w]
            part["axis_generator_state"] = z["axis_generator_state"][ids, mu]
        return part

    def load_checkpoint(self, path, draws):
        """(states, rows, done, init_rows, extra) of the checkpoint at
        `path` for this rank's chains; sets each chain's generators in
        `draws` to their saved states. Under a mesh rank 0 reads the file
        and scatters each rank's part; rows and init_rows are rank 0's
        only (None elsewhere), and a refusal is raised on every rank."""
        z = parts = None
        if self.is_root:
            ranks = range(1 if self.mesh is None else self.mesh.size)
            try:
                z = self._read_checkpoint(path)
                common = {
                    "done": int(z["done"]),
                    "extra": {k[len("extra_"):]: z[k] for k in z
                              if k.startswith("extra_")}}
                parts = [(self._rank_part(z, r), common) for r in ranks]
            except ValueError as e:
                parts = [(e, None) for _ in ranks]
        if self.mesh is None:
            part, common = parts[0]
        else:
            from bnpc_tpu_torch.parallel import sharded

            part, common = sharded.scatter(self.mesh, parts)
        if isinstance(part, Exception):
            raise part
        for c, d in enumerate(draws):
            d.gen.set_state(torch.from_numpy(
                part["generator_state"][c].copy()))
            if "axis_generator_state" in part:
                d.fold_axis(self.ax.index).gen.set_state(torch.from_numpy(
                    part["axis_generator_state"][c].copy()))
        states = [CRPState(*(
            torch.from_numpy(np.array(part[f"state_{f}"][c])).to(self.device)
            for f in CRPState._fields)) for c in range(len(draws))]
        rows = init_rows = None
        if z is not None:
            rows = ({f: z[f"trace_{f}"] for f in TraceRow._fields}
                    if "trace_ml" in z else None)
            init_rows = {f: z[f"init_{f}"] for f in TraceRow._fields}
        return states, rows, common["done"], init_rows, common["extra"]

    def _resume(self, path, draws, buf: _TraceBuffer):
        """Load `path` into `draws` and `buf`: (states, done, init_rows,
        extra)."""
        states, rows, done, init_rows, extra = self.load_checkpoint(path,
                                                                     draws)
        if "params_from" in extra:
            # The saved rows carry a ratchet-trimmed params field; append()
            # recognizes it by its row count.
            buf.params_from = int(extra["params_from"])
        if rows is not None:
            buf.append(rows)
        return states, done, init_rows, extra

    def _exists(self, path) -> bool:
        return self._agree(os.path.exists(path))

    # -- results -------------------------------------------------------------

    def _collect(self, buf: _TraceBuffer, init_rows: dict, burn_in: int,
                 psrf=None, cutoff=None) -> list[ChainResult] | None:
        if not self.is_root:
            return None
        rows = buf.concat() if buf.rows else {
            f: v[:, :0] for f, v in init_rows.items()}
        # The initial-state row first (the reference records step 0 at
        # chain construction, libs/MCMC.py:349-358).
        full = {f: np.concatenate([init_rows[f], rows[f]], axis=1)
                for f in TraceRow._fields}
        results = []
        for c in range(buf.n_chains):
            if buf.params_from > 0:
                # Only rows with global index >= params_from were kept
                # (== burn_in in steps mode, <= it under lugsail's trim).
                params_c = rows["params"][c][max(0, burn_in
                                                 - buf.params_from):]
            else:
                params_c = full["params"][c][burn_in:]
            res = ChainResult(
                ML=full["ml"][c], MAP=full["map_"][c],
                DP_alpha=full["dp_alpha"][c], FN=full["fn"][c],
                FP=full["fp"][c],
                assignments=full["assignment"][c].astype(np.int32),
                params=params_c.astype(np.float32), burn_in=int(burn_in),
                mh_counts=full["mh_counts"][c].sum(axis=0),
            )
            if psrf is not None:
                res.PSRF = list(psrf)
                res.PSRF_cutoff = cutoff
            results.append(res)
        return results

    # -- the three modes -----------------------------------------------------

    def _run_steps(self, states, draws, steps: int, burn_in: int):
        init_rows = self._init_rows(states)
        buf = _TraceBuffer(self._n_chains, params_from=burn_in)
        done = 0
        ckpt = self._ckpt_path("mcmc_state.npz")
        if ckpt and self._exists(ckpt):
            states, done, init_rows, _ = self._resume(ckpt, draws, buf)
        since_ckpt = 0
        while done < steps:
            b = min(self.block_size, steps - done)
            if b < self.block_size and ckpt:
                # Checkpoint the last block-aligned state first: a resume
                # replays the partial block from there.
                self.save_checkpoint(ckpt, states, draws, buf, done,
                                     init_rows)
            states, rows, draws = self.run_chains(states, draws,
                                                  self.block_size, keep=b)
            rows = self._gather(rows)
            done += b
            if rows is not None:
                buf.append(rows)
                if self._verbosity > 1:
                    self._print_progress(done, steps, rows["mh_counts"])
            since_ckpt += 1
            if (ckpt and done % self.block_size == 0
                    and since_ckpt >= self.checkpoint_every):
                self.save_checkpoint(ckpt, states, draws, buf, done,
                                     init_rows)
                since_ckpt = 0
        if ckpt and steps % self.block_size == 0:
            self.save_checkpoint(ckpt, states, draws, buf, done, init_rows)
        self.final_states = states
        return self._collect(buf, init_rows, burn_in)

    def _run_time(self, states, draws, end_time: datetime,
                  burnin_time: datetime):
        """Rank 0's clock decides: whether a block runs, where the
        deadline and the end of burn-in cut the trace."""
        init_rows = self._init_rows(states)
        buf = _TraceBuffer(self._n_chains)
        burn_in = 0
        ckpt = self._ckpt_path("mcmc_state_time.npz")
        if ckpt and self._exists(ckpt):
            states, _, init_rows, extra = self._resume(ckpt, draws, buf)
            burn_in = int(extra.get("burn_in", 0))
        since_ckpt = 0
        while self._agree(self._now() < end_time):
            t_before = self._now()
            before_steps = buf.n_steps
            # The rows are on the host (_rows_to_host) before t_after.
            states, rows, draws = self.run_chains(states, draws,
                                                  self.block_size)
            rows = self._gather(rows)
            t_after = self._now()
            if rows is not None:
                # The reference checks the clock every step (libs/MCMC.py:
                # 413-430); the rows of the block past the deadline are cut
                # by wall-clock interpolation (the chain state runs past
                # them).
                if t_after >= end_time and t_before < end_time:
                    frac = (end_time - t_before) / (t_after - t_before)
                    keep = max(1, int(self.block_size * frac))
                    if keep < self.block_size:
                        rows = {f: v[:, :keep] for f, v in rows.items()}
                buf.append(rows)
                # The step where burn-in ended, interpolated the same way.
                if t_after < burnin_time:
                    burn_in = buf.n_steps
                elif t_before < burnin_time:
                    frac = (burnin_time - t_before) / (t_after - t_before)
                    burn_in = before_steps + int(self.block_size * frac)
            since_ckpt += 1
            if (ckpt and since_ckpt >= self.checkpoint_every
                    and self._agree(self._now() < end_time)):
                self.save_checkpoint(ckpt, states, draws, buf, buf.n_steps,
                                     init_rows, extra={"burn_in": burn_in})
                since_ckpt = 0
        self.final_states = states
        return self._collect(buf, init_rows, burn_in)

    def _run_lugsail(self, states, draws, cutoff: float, verbosity: int,
                     extension: int = 200):
        """Rank 0 evaluates the PSRF and decides the stop."""
        # Initial steps: max(10, 1/(cutoff^2 - 1)) (libs/MCMC.py:85-90).
        first = max(10, int(1.0 / (cutoff**2 - 1.0)))
        init_rows = self._init_rows(states)
        buf = _TraceBuffer(self._n_chains)
        ckpt = self._ckpt_path("mcmc_state_lugsail.npz")
        # PSRF evaluations of a run before its restart stay in the log
        # (the reference keeps the full list, libs/MCMC.py:147-156).
        psrf_log = []
        if ckpt and self._exists(ckpt):
            states, _, init_rows, extra = self._resume(ckpt, draws, buf)
            psrf_log = [(int(s), float(v)) for s, v in zip(
                extra.get("psrf_steps", ()), extra.get("psrf_vals", ()))]
        else:
            states, rows, draws = self.run_chains(states, draws, first)
            rows = self._gather(rows)
            if rows is not None:
                buf.append(rows)
        while True:
            stop = None
            if self.is_root:
                steps_run = buf.n_steps + 1  # with the initial row
                ml = np.concatenate([init_rows["ml"],
                                     buf.concat(("ml",))["ml"]], axis=1)
                psrf = diagnostics.lugsail_psrf(
                    [(ml[c], steps_run // 2) for c in range(ml.shape[0])])
                psrf_log.append((steps_run, psrf))
                if verbosity > 1:
                    print(f"\tPSRF at {steps_run}:\t{psrf:.5f}")
                # Burn-in only grows ((steps + 1) // 2 + 1): params rows
                # below the current one are never needed again.
                buf.trim_params((buf.n_steps + 1) // 2 + 1)
                stop = psrf <= cutoff
            if self._agree(stop):
                break
            states, rows, draws = self.run_chains(states, draws, extension)
            rows = self._gather(rows)
            if rows is not None:
                buf.append(rows)
            if ckpt:
                self.save_checkpoint(
                    ckpt, states, draws, buf, buf.n_steps, init_rows,
                    extra={"psrf_steps": [s for s, _ in psrf_log],
                           "psrf_vals": [v for _, v in psrf_log],
                           "params_from": buf.params_from})
        burn_in = (buf.n_steps + 1) // 2 + 1
        self.final_states = states
        return self._collect(buf, init_rows, burn_in, psrf=psrf_log,
                             cutoff=cutoff)

    def _print_progress(self, done, steps, mh_counts):
        """Per-block progress + mean MH acceptance (libs/MCMC.py:369-379);
        `mh_counts` [..., 5, 2] is summed over chains and steps."""
        from bnpc_tpu_torch import io

        counts = mh_counts.reshape(-1, 5, 2).sum(axis=0)
        print(f"\tstep:\t{done} / {steps}\n\t\tmean MH accept. ratio:")
        io.show_mh_acceptance(counts[0], "parameters", 1)
        if not self.mcmc_cfg.fix_assign:
            io.show_mh_acceptance(counts[1], "splits")
            io.show_mh_acceptance(counts[2], "merges")
        if self.cfg.learn_errors:
            io.show_mh_acceptance(counts[3], "FP")
            io.show_mh_acceptance(counts[4], "FN")
