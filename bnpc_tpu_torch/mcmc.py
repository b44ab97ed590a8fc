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
(bnpc_tpu's chain_exec="sequential"), or in lockstep with one shared move
selection a step (coupled_moves).
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
from bnpc_tpu_torch.draws import Draws, TorchDraws
from bnpc_tpu_torch.models.gibbs import gibbs_sweep
from bnpc_tpu_torch.models.splitmerge import split_merge
from bnpc_tpu_torch.models.updates import (
    update_dp_alpha,
    update_error_rates,
    update_parameters,
)
from bnpc_tpu_torch.ops import likelihood as lk
from bnpc_tpu_torch.state import CRPState, cluster_stats, init_state


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
    order = torch.argsort((~live).to(torch.int8), stable=True)
    sel = order[:trace_k]
    return state.params[sel] * live[sel][:, None].to(state.params.dtype)


def summarize(state: CRPState, data: PackedData, cfg: ModelConfig,
              trace_k: int, stats=None) -> TraceRow:
    """One trace row for the current state (libs/MCMC.py:242-282). `stats`
    reuses the step's (n1, n0) sufficient statistics."""
    n1, n0 = stats if stats is not None else cluster_stats(
        data, state.assignment, cfg.k_max)
    c1, c0 = lk.log_prob_tables(state.params, state.fp, state.fn)
    ml = lk.ll_from_stats(n1, n0, c1, c0)
    lprior = lk.log_prior_full(cfg, state.cluster_size, state.params,
                               state.dp_alpha, state.fp, state.fn)
    a_dt, p_dt = _trace_dtypes(cfg)
    return TraceRow(
        ml=ml, map_=ml + lprior, dp_alpha=state.dp_alpha, fp=state.fp,
        fn=state.fn, assignment=state.assignment.to(a_dt),
        params=_compact_params(state, trace_k).to(p_dt),
        mh_counts=torch.zeros((5, 2), dtype=torch.int32,
                              device=state.assignment.device),
    )


def _make_moves(cfg: ModelConfig, mcmc_cfg: MCMCConfig, data: PackedData,
                trace_k: int, gibbs_impl: str, gibbs_block: int):
    """(select, moves) of one chain's step: select(k_sel) reads the move
    flags (the step's one planned host read); moves(state, flags, k_assign,
    k_dpa, k_par, k_err) runs the moves and returns (state, row).
    gibbs_block > 0 replaces the exact Gibbs move by the blocked sweep."""
    # The move thresholds as float32 values: comparing the uniforms' exact
    # float32 values against them on the host is JAX's float32 comparison.
    thresholds = [float(np.float32(p)) for p in (
        mcmc_cfg.sm_prob, mcmc_cfg.dpa_prob, mcmc_cfg.error_prob)]
    impl_g = "blocked" if gibbs_block > 0 else gibbs_impl

    def select(k_sel: Draws):
        u = k_sel.uniform((3,)).tolist()  # the step's one planned host read
        return [x < t for x, t in zip(u, thresholds)]

    def moves(state: CRPState, flags, k_assign, k_dpa, k_par, k_err):
        do_sm, do_dpa, do_err = flags
        dev = state.assignment.device
        counts = torch.zeros((5, 2), dtype=torch.int32, device=dev)

        if not mcmc_cfg.fix_assign:
            if mcmc_cfg.sm_prob > 0.0 and do_sm:
                state, sm_counts = split_merge(
                    k_assign, state, data, cfg, mcmc_cfg.sm_split_ratio,
                    mcmc_cfg.sm_steps)
                counts[1:3] += sm_counts
            else:
                state = gibbs_sweep(k_assign, state, data, cfg, impl=impl_g,
                                    block=gibbs_block)
            if mcmc_cfg.dpa_prob > 0.0 and do_dpa:
                state = update_dp_alpha(k_dpa, state, cfg)

        n1, n0 = cluster_stats(data, state.assignment, cfg.k_max)
        state, par_dec, par_acc = update_parameters(k_par, state, n1, n0,
                                                    cfg)
        counts[0] += torch.stack([par_acc, par_dec]).to(torch.int32)

        if cfg.learn_errors and mcmc_cfg.error_prob > 0.0 and do_err:
            state, fp_acc, fn_acc = update_error_rates(k_err, state, n1, n0,
                                                       cfg)
            acc = torch.stack([fp_acc, fn_acc]).to(torch.int32)
            counts[3:5] += torch.stack([acc, 1 - acc], dim=1)

        row = summarize(state, data, cfg, trace_k, stats=(n1, n0))
        return state, row._replace(mh_counts=counts)

    return select, moves


def _make_step_body(cfg: ModelConfig, mcmc_cfg: MCMCConfig,
                    data: PackedData, trace_k: int, gibbs_impl: str = "auto"):
    """The single-step body (do_step, libs/MCMC.py:320-342); draws are
    split exactly as in bnpc_tpu/mcmc.py:_make_step_body. ``gibbs_impl`` is
    the Gibbs sweep's impl (models/gibbs.py::gibbs_sweep);
    ``mcmc_cfg.gibbs_block`` > 0 routes the Gibbs move to the blocked
    sweep, as bnpc_tpu does."""
    select, moves = _make_moves(cfg, mcmc_cfg, data, trace_k, gibbs_impl,
                                mcmc_cfg.gibbs_block)

    def step(state: CRPState, draws: Draws):
        k_sel, k_assign, k_dpa, k_par, k_err = draws.split(5)
        return moves(state, select(k_sel), k_assign, k_dpa, k_par, k_err)

    return step


def _make_coupled_step(cfg: ModelConfig, mcmc_cfg: MCMCConfig,
                       data: PackedData, trace_k: int,
                       gibbs_impl: str = "auto"):
    """A step of every chain with one SHARED move-type selection
    (bnpc_tpu make_coupled_step_fn): the move, alpha, parameter and error
    draws of chain c are split c of the step's keys. Like bnpc_tpu's, it
    does not route ``gibbs_block``. step(states, draws) -> (states, rows)."""
    select, moves = _make_moves(cfg, mcmc_cfg, data, trace_k, gibbs_impl, 0)

    def step(states: list[CRPState], draws: Draws):
        n = len(states)
        k_sel, k_move, k_dpa, k_par, k_err = draws.split(5)
        flags = select(k_sel)
        out = [moves(st, flags, *keys) for st, keys in zip(
            states, zip(k_move.split(n), k_dpa.split(n), k_par.split(n),
                        k_err.split(n)))]
        return [o[0] for o in out], [o[1] for o in out]

    return step


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


class MCMCRunner:
    """Multi-chain scheduler (reference MCMC class, libs/MCMC.py:26-193) on
    an explicit device.

    Chains run one after another, each block of each chain on the device
    (bnpc_tpu's chain_exec="sequential", which bnpc_tpu itself takes on
    one device whenever its kernels run). With ``mcmc_cfg.coupled_moves``
    and more than one chain, the chains step in lockstep with one shared
    move selection a step (bnpc_tpu honours it only on its vmapped path;
    the port has no vmap and honours it whenever n_chains > 1).
    ``checkpoint_dir`` saves the run every ``checkpoint_every`` blocks and
    resumes from it, in all three modes."""

    def __init__(self, cfg: ModelConfig, mcmc_cfg: MCMCConfig,
                 data: PackedData, device, block_size: int = 256,
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int = 4):
        self.cfg = cfg
        self.mcmc_cfg = mcmc_cfg
        self.data = data
        self.device = torch.device(device)
        self.block_size = block_size
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.trace_k = resolve_trace_k(cfg, mcmc_cfg)
        self._step = _make_step_body(cfg, mcmc_cfg, data, self.trace_k)
        self._coupled_step = _make_coupled_step(cfg, mcmc_cfg, data,
                                                self.trace_k)
        # The seed of each chain of the last run() (args.txt's chain_seeds).
        self.seeds: np.ndarray | None = None
        # Injectable clock (deterministic time-mode tests stub this).
        self._now = datetime.now
        self._verbosity = 1

    # -- low level ---------------------------------------------------------

    def init_chains(self, draws: Draws, n_chains: int = 1,
                    assign=None) -> list[CRPState]:
        """Initial state of each chain, chain c from draws.split(n_chains)[c]
        as in bnpc_tpu: `assign` relabelled to compact slots, else random
        (init_state mode 'random')."""
        return [init_state(d, self.cfg, self.data, self.device,
                           mode="random", assign=assign)
                for d in draws.split(n_chains)]

    def run_block(self, state: CRPState, draws: Draws, n_steps: int,
                  keep: int | None = None):
        """One chain's block of `n_steps` steps, or its first `keep` steps
        (a partial final block takes the keys of a whole block, as bnpc_tpu
        does). Returns (state, rows, next_draws): rows is a dict of host
        arrays with a leading step axis, one entry per TraceRow field."""
        keys = draws.split(n_steps + 1)
        rows = []
        for k in keys[1:1 + (n_steps if keep is None else keep)]:
            state, row = self._step(state, k)
            rows.append(row)
        return state, _rows_to_host(rows), keys[0]

    def run_chains(self, states: list[CRPState], draws: list[Draws],
                   n_steps: int, keep: int | None = None):
        """One block of every chain (see run_block). Returns (states, rows,
        next_draws); rows hold [n_chains, steps, ...] host arrays."""
        if len(states) > 1 and self.mcmc_cfg.coupled_moves:
            # Chain 0's key stream drives every chain (bnpc_tpu
            # _pipe_coupled); every chain's key advances.
            keys = [d.split(n_steps + 1) for d in draws]
            rows = [[] for _ in states]
            for k in keys[0][1:1 + (n_steps if keep is None else keep)]:
                states, step_rows = self._coupled_step(states, k)
                for chain_rows, row in zip(rows, step_rows):
                    chain_rows.append(row)
            blocks = [_rows_to_host(r) for r in rows]
            draws = [k[0] for k in keys]
        else:
            out = [self.run_block(st, d, n_steps, keep)
                   for st, d in zip(states, draws)]
            states, blocks, draws = (list(x) for x in zip(*out))
        return states, {f: np.stack([b[f] for b in blocks])
                        for f in TraceRow._fields}, draws

    def _init_rows(self, states) -> dict:
        """Each chain's initial-state row, [n_chains, 1, ...]."""
        rows = [_rows_to_host([summarize(st, self.data, self.cfg,
                                         self.trace_k)]) for st in states]
        return {f: np.stack([r[f] for r in rows]) for f in TraceRow._fields}

    # -- top-level run (libs/MCMC.py:79-123) -------------------------------

    def run(self, run_var, seed: int | None = None, n_chains: int = 1,
            assign=None, verbosity: int = 1, draws: Draws | None = None):
        """run_var: (steps: int, burn_in: int) | (end: datetime,
        burn_in_end: datetime) | (cutoff: float, 0). `assign` fixes the
        initial assignment (-fa); at verbosity 2 each block prints its MH
        acceptance rates. Returns [ChainResult], one per chain.

        Without `draws`, a seed below 0 (or None) draws one; one chain runs
        on the seed's TorchDraws stream, and n > 1 chains on streams of
        their own, seeds[c] drawn from the seed: chain c is the one-chain
        run with seed seeds[c]. `draws` is a root provider whose key tree
        is bnpc_tpu's: k_init, k_run = draws.split(2); chain c starts from
        k_init.split(n)[c] and runs on k_run.split(n)[c]."""
        self._verbosity = verbosity
        if draws is None:
            if seed is None or seed < 0:
                seed = int(np.random.randint(0, 2**31 - 1))
            seeds = ([seed] if n_chains == 1 else np.random.default_rng(
                seed).integers(0, 2**31 - 1, n_chains))
            chains = [TorchDraws(int(s), self.device) for s in seeds]
            states = [self.init_chains(d, 1, assign)[0] for d in chains]
        else:
            k_init, k_run = draws.split(2)
            seeds = k_init.randint((n_chains,), 0, 2**31 - 1).cpu().numpy()
            states = self.init_chains(k_init, n_chains, assign)
            chains = k_run.split(n_chains)
        self.seeds = np.asarray(seeds, dtype=np.int64)
        if self.checkpoint_dir and not all(isinstance(d, TorchDraws)
                                           for d in chains):
            raise ValueError("checkpoints hold torch generator states: "
                             "run() with draws=None to checkpoint")

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

    def save_checkpoint(self, path, states, draws, buf: _TraceBuffer,
                        done: int, init_rows: dict,
                        extra: dict | None = None):
        """The chains' states, generator states, initial rows and trace so
        far, written to a temporary file and moved over `path`."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = {
            "format": np.asarray(CHECKPOINT_FORMAT),
            "done": np.asarray(done),
            "generator_device": np.asarray(self.device.type),
            "generator_state": np.stack([d.gen.get_state().numpy()
                                         for d in draws]),
        }
        for k, v in (extra or {}).items():
            payload[f"extra_{k}"] = np.asarray(v)
        for f in CRPState._fields:
            payload[f"state_{f}"] = np.stack([getattr(st, f).cpu().numpy()
                                              for st in states])
        for f, v in init_rows.items():
            payload[f"init_{f}"] = v
        if buf.rows:
            for f, v in buf.concat().items():
                payload[f"trace_{f}"] = v
        tmp = path + ".tmp.npz"
        np.savez_compressed(tmp, **payload)
        os.replace(tmp, path)

    def load_checkpoint(self, path, draws):
        """(states, rows, done, init_rows, extra) of the checkpoint at
        `path`; sets each chain's generator in `draws` to its saved state.
        Refuses a file without the port's format tag, from another device
        type or chain count."""
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
            gen = z["generator_state"]
            if gen.shape[0] != len(draws):
                raise ValueError(f"{path}: checkpoint of {gen.shape[0]} "
                                 f"chains; this run has {len(draws)}")
            for d, g in zip(draws, gen):
                d.gen.set_state(torch.from_numpy(g.copy()))
            states = [CRPState(*(
                torch.from_numpy(np.array(z[f"state_{f}"][c])).to(
                    self.device) for f in CRPState._fields))
                for c in range(gen.shape[0])]
            rows = ({f: z[f"trace_{f}"] for f in TraceRow._fields}
                    if "trace_ml" in z.files else None)
            init_rows = {f: z[f"init_{f}"] for f in TraceRow._fields}
            extra = {k[len("extra_"):]: z[k] for k in z.files
                     if k.startswith("extra_")}
            done = int(z["done"])
        return states, rows, done, init_rows, extra

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

    # -- results -------------------------------------------------------------

    def _collect(self, buf: _TraceBuffer, init_rows: dict, burn_in: int,
                 psrf=None, cutoff=None) -> list[ChainResult]:
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
        buf = _TraceBuffer(len(states), params_from=burn_in)
        done = 0
        ckpt = self._ckpt_path("mcmc_state.npz")
        if ckpt and os.path.exists(ckpt):
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
            buf.append(rows)
            done += b
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
        return self._collect(buf, init_rows, burn_in)

    def _run_time(self, states, draws, end_time: datetime,
                  burnin_time: datetime):
        init_rows = self._init_rows(states)
        buf = _TraceBuffer(len(states))
        burn_in = 0
        ckpt = self._ckpt_path("mcmc_state_time.npz")
        if ckpt and os.path.exists(ckpt):
            states, _, init_rows, extra = self._resume(ckpt, draws, buf)
            burn_in = int(extra.get("burn_in", 0))
        since_ckpt = 0
        while self._now() < end_time:
            t_before = self._now()
            before_steps = buf.n_steps
            # The rows are on the host (_rows_to_host) before t_after.
            states, rows, draws = self.run_chains(states, draws,
                                                  self.block_size)
            t_after = self._now()
            # The reference checks the clock every step (libs/MCMC.py:
            # 413-430); the rows of the block past the deadline are cut by
            # wall-clock interpolation (the chain state runs past them).
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
                    and self._now() < end_time):
                self.save_checkpoint(ckpt, states, draws, buf, buf.n_steps,
                                     init_rows, extra={"burn_in": burn_in})
                since_ckpt = 0
        return self._collect(buf, init_rows, burn_in)

    def _run_lugsail(self, states, draws, cutoff: float, verbosity: int,
                     extension: int = 200):
        # Initial steps: max(10, 1/(cutoff^2 - 1)) (libs/MCMC.py:85-90).
        first = max(10, int(1.0 / (cutoff**2 - 1.0)))
        init_rows = self._init_rows(states)
        buf = _TraceBuffer(len(states))
        ckpt = self._ckpt_path("mcmc_state_lugsail.npz")
        # PSRF evaluations of a run before its restart stay in the log
        # (the reference keeps the full list, libs/MCMC.py:147-156).
        psrf_log = []
        if ckpt and os.path.exists(ckpt):
            states, _, init_rows, extra = self._resume(ckpt, draws, buf)
            psrf_log = [(int(s), float(v)) for s, v in zip(
                extra.get("psrf_steps", ()), extra.get("psrf_vals", ()))]
        else:
            states, rows, draws = self.run_chains(states, draws, first)
            buf.append(rows)
        while True:
            steps_run = buf.n_steps + 1  # with the initial row
            ml = np.concatenate([init_rows["ml"], buf.concat(("ml",))["ml"]],
                                axis=1)
            psrf = diagnostics.lugsail_psrf(
                [(ml[c], steps_run // 2) for c in range(ml.shape[0])])
            psrf_log.append((steps_run, psrf))
            if verbosity > 1:
                print(f"\tPSRF at {steps_run}:\t{psrf:.5f}")
            # Burn-in only grows ((steps + 1) // 2 + 1): params rows below
            # the current one are never needed again.
            buf.trim_params((buf.n_steps + 1) // 2 + 1)
            if psrf <= cutoff:
                break
            states, rows, draws = self.run_chains(states, draws, extension)
            buf.append(rows)
            if ckpt:
                self.save_checkpoint(
                    ckpt, states, draws, buf, buf.n_steps, init_rows,
                    extra={"psrf_steps": [s for s, _ in psrf_log],
                           "psrf_vals": [v for _, v in psrf_log],
                           "params_from": buf.params_from})
        burn_in = (buf.n_steps + 1) // 2 + 1
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
