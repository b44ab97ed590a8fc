"""Chain orchestration: the per-step move mixture and the multi-chain
runner (counterpart of bnpc_tpu/mcmc.py; reference libs/MCMC.py).

One MCMC step (do_step, libs/MCMC.py:320-342) is a plain Python function
over tensors: the move selection reads its three uniforms on the host (one
synchronization per step), then runs either a Gibbs sweep or a split-merge
move, the alpha resample, the cluster-parameter MH and the error-rate MH,
and emits one trace row. The runner loops over steps in Python, copies each
block's rows to the host, and assembles the reference's per-chain results
in the three run modes of the reference (steps, runtime, lugsail PSRF),
with checkpoint / resume. Chains run one after another on the device
(bnpc_tpu's chain_exec="sequential"), or all together as one batch with a
leading chain axis (chain_exec="vmap": the same step on a batched state),
and in either form in lockstep with one shared move selection a step
(coupled_moves).
Given a mesh of ranks (parallel/sharded.py), the runner runs this rank's
chains on its mutation columns and rank 0 gathers, decides and writes (see
MCMCRunner).
"""

from __future__ import annotations

import dataclasses
import os
from datetime import datetime
from typing import NamedTuple

import numpy as np
import torch

from bnpc_tpu_torch import diagnostics
from bnpc_tpu_torch.config import MCMCConfig, ModelConfig
from bnpc_tpu_torch.data import PackedData
from bnpc_tpu_torch.draws import Draws, StackedDraws, TorchDraws
from bnpc_tpu_torch.models.gibbs import gibbs_sweep
from bnpc_tpu_torch.models.splitmerge import split_merge
from bnpc_tpu_torch.models.updates import (
    update_dp_alpha,
    update_error_rates,
    update_parameters,
)
from bnpc_tpu_torch.ops import likelihood as lk
from bnpc_tpu_torch.parallel.axis import ChainAxis, MutAxis
from bnpc_tpu_torch.state import (CRPState, by_chain_flag, cluster_stats,
                                  init_state, stack_states, unstack_states)

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


def summarize(state: CRPState, data: PackedData, cfg: ModelConfig,
              trace_k: int, stats=None, ax: MutAxis = _NO_AXIS) -> TraceRow:
    """One trace row for the current state (libs/MCMC.py:242-282). `stats`
    reuses the step's (n1, n0) sufficient statistics. Under a sharded `ax`
    ML and MAP are all-reduced and the params are this rank's columns; under
    a chain axis every field leads with the chains."""
    n1, n0 = stats if stats is not None else cluster_stats(
        data, state.assignment, cfg.k_max)
    c1, c0 = lk.log_prob_tables(state.params, state.fp, state.fn)
    ml = lk.ll_from_stats(n1, n0, c1, c0, ax)
    lprior = lk.log_prior_full(cfg, state.cluster_size, state.params,
                               state.dp_alpha, state.fp, state.fn, ax)
    a_dt, p_dt = _trace_dtypes(cfg)
    return TraceRow(
        ml=ml, map_=ml + lprior, dp_alpha=state.dp_alpha, fp=state.fp,
        fn=state.fn, assignment=state.assignment.to(a_dt),
        params=_compact_params(state, trace_k).to(p_dt),
        mh_counts=torch.zeros(tuple(ml.shape) + (5, 2), dtype=torch.int32,
                              device=state.assignment.device),
    )


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
    moves and returns (state, row). A move that only some chains of a batch
    take runs on their sub-batch (state.py::by_chain_flag), so each chain
    draws what its one-chain step draws. gibbs_block > 0 replaces the exact
    Gibbs move by the blocked sweep. Every move sums over the mutation axis
    `ax`, and a batch over a ChainAxis on it."""
    # The move thresholds as float32 values: comparing the uniforms' exact
    # float32 values against them on the host is JAX's float32 comparison.
    thresholds = [float(np.float32(p)) for p in (
        mcmc_cfg.sm_prob, mcmc_cfg.dpa_prob, mcmc_cfg.error_prob)]
    impl_g = "blocked" if gibbs_block > 0 else gibbs_impl

    def select(k_sel: Draws, lead=()):
        u = k_sel.uniform(tuple(lead) + (3,))
        rows = u.reshape(-1, 3).tolist()  # the step's one planned host read
        return ([[x < t for x, t in zip(row, thresholds)] for row in rows],
                lambda j: u[..., j] < thresholds[j])

    def moves(state: CRPState, flags, flags_dev, k_assign, k_dpa, k_par,
              k_err):
        step_ax = (ax if state.assignment.dim() == 1
                   else ChainAxis(chains=len(flags), mut=ax))
        counts = torch.zeros(tuple(state.dp_alpha.shape) + (5, 2),
                             dtype=torch.int32,
                             device=state.assignment.device)

        def assign_move(do_sm, sub, sub_ax, take, idx):
            if do_sm:
                return split_merge(take(k_assign), sub, data, cfg,
                                   mcmc_cfg.sm_split_ratio,
                                   mcmc_cfg.sm_steps, ax=sub_ax)
            return gibbs_sweep(take(k_assign), sub, data, cfg, impl=impl_g,
                               block=gibbs_block, ax=sub_ax), None

        def alpha_move(do_dpa, sub, sub_ax, take, idx):
            return (update_dp_alpha(take(k_dpa), sub, cfg) if do_dpa
                    else sub), None

        def error_move(do_err, sub, sub_ax, take, idx):
            if not do_err:
                return sub, None
            s1, s0 = (n1, n0) if idx is None else (n1[idx], n0[idx])
            sub, fp_acc, fn_acc = update_error_rates(take(k_err), sub, s1,
                                                     s0, cfg, sub_ax)
            acc = torch.stack([fp_acc, fn_acc], -1).to(torch.int32)
            return sub, torch.stack([acc, 1 - acc], dim=-1)

        if not mcmc_cfg.fix_assign:
            state, c = by_chain_flag(
                state, [mcmc_cfg.sm_prob > 0.0 and f[0] for f in flags],
                lambda: flags_dev(0), assign_move, step_ax)
            if c is not None:
                counts[..., 1:3, :] += c
            if mcmc_cfg.dpa_prob > 0.0:
                state, _ = by_chain_flag(state, [f[1] for f in flags],
                                         lambda: flags_dev(1), alpha_move,
                                         step_ax)

        n1, n0 = cluster_stats(data, state.assignment, cfg.k_max)
        state, par_dec, par_acc = update_parameters(k_par, state, n1, n0,
                                                    cfg, step_ax)
        counts[..., 0, :] += torch.stack([par_acc, par_dec], -1).to(
            torch.int32)

        if cfg.learn_errors and mcmc_cfg.error_prob > 0.0:
            state, c = by_chain_flag(state, [f[2] for f in flags],
                                     lambda: flags_dev(2), error_move,
                                     step_ax)
            if c is not None:
                counts[..., 3:5, :] += c

        row = summarize(state, data, cfg, trace_k, stats=(n1, n0),
                        ax=step_ax)
        return state, row._replace(mh_counts=counts)

    return select, moves


def _make_step_body(cfg: ModelConfig, mcmc_cfg: MCMCConfig,
                    data: PackedData, trace_k: int, gibbs_impl: str = "auto",
                    ax: MutAxis = _NO_AXIS):
    """The single-step body (do_step, libs/MCMC.py:320-342); draws are
    split exactly as in bnpc_tpu/mcmc.py:_make_step_body. ``gibbs_impl`` is
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


def _make_coupled_step(cfg: ModelConfig, mcmc_cfg: MCMCConfig,
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
    return {f: torch.stack([getattr(r, f) for r in rows]).cpu().numpy()
            for f in TraceRow._fields}


def _chain_block(step, state: CRPState, draws: Draws, n_steps: int,
                 keep: int | None = None):
    """One chain's block of `n_steps` steps of `step`, or its first `keep`
    steps (a partial final block takes the keys of a whole block, as
    bnpc_tpu does). Returns (state, rows, next_draws): rows is a dict of
    host arrays with a leading step axis, one entry per TraceRow field."""
    keys = draws.split(n_steps + 1)
    rows = []
    for k in keys[1:1 + (n_steps if keep is None else keep)]:
        state, row = step(state, k)
        rows.append(row)
    return state, _rows_to_host(rows), keys[0]


def _batch_block(step, states: list[CRPState], draws: list[Draws],
                 n_steps: int, keep: int | None = None,
                 coupled: bool = False):
    """A block of every chain of `states` as one batch (chain_exec="vmap"):
    the chains stacked into one batched state, each step one batched step
    on a StackedDraws of the chains' step draws (coupled: the coupled step,
    chain 0's step draws driving the shared move choice), unstacked at the
    block's end. Returns what _make_block's block returns."""
    keys = [d.split(n_steps + 1) for d in draws]
    batch = stack_states(states)
    rows = []
    for t in range(1, 1 + (n_steps if keep is None else keep)):
        if coupled:
            batch, row = step(batch, keys[0][t], _own_streams(keys, t))
        else:
            batch, row = step(batch, StackedDraws([k[t] for k in keys]))
        rows.append(row)
    host = _rows_to_host(rows)  # [steps, chains, ...]
    return unstack_states(batch), {
        f: np.ascontiguousarray(np.swapaxes(v, 0, 1))
        for f, v in host.items()}, [k[0] for k in keys]


def _make_block(step, chain_exec: str):
    """(states, draws, n_steps, keep=None) -> (states, rows, next_draws): a
    block of `step` over a list of one-chain states and their draws, the
    chains one after another (_chain_block) or, under chain_exec="vmap"
    and more than one chain, as one batch (_batch_block). rows hold
    [chains, steps, ...] host arrays (an empty dict without chains)."""
    def block(states, draws, n_steps: int, keep: int | None = None):
        if not states:
            return [], {}, []
        if chain_exec == "vmap" and len(states) > 1:
            return _batch_block(step, states, draws, n_steps, keep)
        out = [_chain_block(step, st, d, n_steps, keep)
               for st, d in zip(states, draws)]
        states, rows, draws = (list(x) for x in zip(*out))
        return states, {f: np.stack([r[f] for r in rows])
                        for f in TraceRow._fields}, draws

    return block


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

# What chain_exec="auto" takes on a CUDA device for more than one chain:
# chip_smoke.py phase 12 measured the batch at or above the sequential
# chain-steps/s at both cells in each call (NVIDIA H100 80GB HBM3, 700 W,
# six calls: main cell 1.05-1.72 x at 4 chains, 2.47-3.47 x at 16;
# large-n 1.07-1.29 x at 2; PERF.md §6). On the CPU "auto" takes
# "sequential".
AUTO_CUDA_CHAIN_EXEC = "vmap"
# The same rule for a blocked sweep (gibbs_block > 0) and for a rank's
# local chains under a mesh: "vmap" only where the batch reached the
# sequential chain-steps/s in every call (NVIDIA H100 80GB HBM3, 700 W,
# three calls; PERF.md §6). Blocked (phase 12 (f)): main cell 4
# chains 1.270-1.966 x, large-n 2 chains 1.112-1.467 x, so "vmap". Mesh
# (phase 11 (e), two ranks sharing the card): 1 x 2 with 2 chains
# 1.093-1.212 x, but 2 x 1 with 2 chains a rank 0.557, 1.125 and 0.990 x,
# so "sequential".
AUTO_CUDA_BLOCKED_CHAIN_EXEC = "vmap"
AUTO_CUDA_MESH_CHAIN_EXEC = "sequential"


def resolve_chain_exec(chain_exec: str, device, mesh=None,
                       gibbs_block: int = 0) -> str:
    """"auto" -> "vmap" on CUDA where every rule that applies takes it
    (AUTO_CUDA_CHAIN_EXEC; AUTO_CUDA_BLOCKED_CHAIN_EXEC with a blocked
    sweep; AUTO_CUDA_MESH_CHAIN_EXEC under a mesh), "sequential"
    otherwise and on the CPU."""
    if chain_exec not in CHAIN_EXECS:
        raise ValueError(f"chain_exec={chain_exec!r}; expected one of "
                         f"{CHAIN_EXECS}")
    if chain_exec != "auto":
        return chain_exec
    rules = [AUTO_CUDA_CHAIN_EXEC]
    if mesh is not None:
        rules.append(AUTO_CUDA_MESH_CHAIN_EXEC)
    if gibbs_block > 0:
        rules.append(AUTO_CUDA_BLOCKED_CHAIN_EXEC)
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
        leading chain axis (``_make_step_body``), the sampler kernels on
        a grid of one block a chain. This is the port's own chain-axis
        step, not ``torch.func.vmap``; unlike bnpc_tpu's vmapped scan it
        keeps the kernels. Chain c gets exactly what its sequential run
        gets on the same draws. The blocked sweep (gibbs_block > 0) runs
        batched too; the eager sweep is refused. Under a mesh a rank's
        local chains form the batch;
      * "auto": see ``resolve_chain_exec`` (PERF.md §6 has the
        measurements behind its rules); "sequential" on the CPU.

    One chain always runs the one-chain step. With
    ``mcmc_cfg.coupled_moves`` and more than one chain the chains step in
    lockstep with one shared move selection a step, batched under "vmap"
    (bnpc_tpu's coupled pipe) and one after another within each step under
    "sequential" (bnpc_tpu honours it only on its vmapped path; the port
    honours it whenever n_chains > 1). Checkpoints hold one state a chain
    under either, so a run saved under one resumes under the other.
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
        self.chain_exec = resolve_chain_exec(chain_exec, device, mesh,
                                             mcmc_cfg.gibbs_block)
        self.cfg = cfg
        self.mcmc_cfg = mcmc_cfg
        self.data = data
        self.device = torch.device(device)
        self.block_size = block_size
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.trace_k = resolve_trace_k(cfg, mcmc_cfg)
        self.mesh = mesh
        self.ax = _NO_AXIS
        self.m_pad = cfg.n_muts
        # The step's config, data and axis: this rank's columns of the
        # padded matrix under mutation sharding, else the whole matrix.
        self._step_cfg, self._step_data = cfg, data
        if mesh is None:
            self._step = _make_step_body(cfg, mcmc_cfg, data, self.trace_k)
            self._block = _make_block(self._step, self.chain_exec)
        else:
            from bnpc_tpu_torch.data import pad_muts
            from bnpc_tpu_torch.parallel import sharded

            padded, self.m_pad = pad_muts(data, mesh.muts)
            self._block = sharded.make_sharded_block(
                mesh, cfg, mcmc_cfg, padded, chain_exec=self.chain_exec)
            self._step, self.ax = self._block.step, self._block.ax
            self._step_cfg = self._block.cfg
            self._step_data = self._block.data
        self._coupled_step = _make_coupled_step(cfg, mcmc_cfg, data,
                                                self.trace_k)
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
        does). Returns (state, rows, next_draws): rows is a dict of host
        arrays with a leading step axis, one entry per TraceRow field."""
        return _chain_block(self._step, state, draws, n_steps, keep)

    def run_chains(self, states: list[CRPState], draws: list[Draws],
                   n_steps: int, keep: int | None = None):
        """One block of every chain of this rank (see run_block): one after
        another or, under chain_exec="vmap", as one batch; coupled chains
        in lockstep (unless the mutation axis is sharded). Returns (states,
        rows, next_draws); rows hold [n_chains, steps, ...] host arrays (an
        empty dict on a rank without chains)."""
        if len(states) < 2 or not self.mcmc_cfg.coupled_moves \
                or self.ax.sharded:
            return self._block(states, draws, n_steps, keep)
        if self.chain_exec == "vmap":
            return _batch_block(self._coupled_step, states, draws, n_steps,
                                keep, coupled=True)
        # Chain 0's key stream drives the shared move choice (bnpc_tpu
        # _pipe_coupled); every chain's key advances.
        keys = [d.split(n_steps + 1) for d in draws]
        rows = [[] for _ in states]
        for t in range(1, 1 + (n_steps if keep is None else keep)):
            states, step_rows = self._coupled_step(
                states, keys[0][t], _own_streams(keys, t))
            for chain_rows, row in zip(rows, step_rows):
                chain_rows.append(row)
        blocks = [_rows_to_host(r) for r in rows]
        return states, {f: np.stack([b[f] for b in blocks])
                        for f in TraceRow._fields}, [k[0] for k in keys]

    def _init_rows(self, states) -> dict | None:
        """Each chain's initial-state row, [n_chains, 1, ...] (on rank 0
        under a mesh, None elsewhere)."""
        rows = [_rows_to_host([summarize(st, self._step_data, self._step_cfg,
                                         self.trace_k, ax=self.ax)])
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
