"""Chain orchestration: the per-step move mixture and the single-chain
runner (counterpart of bnpc_tpu/mcmc.py; reference libs/MCMC.py).

One MCMC step (do_step, libs/MCMC.py:320-342) is a plain Python function
over tensors: the move selection reads its three uniforms on the host (one
synchronization per step), then runs either a Gibbs sweep or a split-merge
move, the alpha resample, the cluster-parameter MH and the error-rate MH,
and emits one trace row. The runner loops over steps in Python, copies each
block's rows to the host, and assembles the reference's per-chain results.
Steps mode with one chain only; the time and lugsail modes, checkpoints and
multi-chain runs are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

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
    in f16 (<= 2^-11 relative rounding of the RECORDED values only)."""
    if cfg.k_max <= 256:
        a = torch.uint8
    elif cfg.k_max <= 65536:
        a = torch.uint16
    else:
        a = torch.int32
    return a, torch.float16


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


def _make_step_body(cfg: ModelConfig, mcmc_cfg: MCMCConfig,
                    data: PackedData, trace_k: int, gibbs_impl: str = "auto"):
    """The single-step body (do_step, libs/MCMC.py:320-342); draws are
    split exactly as in bnpc_tpu/mcmc.py:_make_step_body. ``gibbs_impl`` is
    the Gibbs sweep's impl (models/gibbs.py::gibbs_sweep)."""
    # The move thresholds as float32 values: comparing the uniforms' exact
    # float32 values against them on the host is JAX's float32 comparison.
    thresholds = [float(np.float32(p)) for p in (
        mcmc_cfg.sm_prob, mcmc_cfg.dpa_prob, mcmc_cfg.error_prob)]

    def step(state: CRPState, draws: Draws):
        k_sel, k_assign, k_dpa, k_par, k_err = draws.split(5)
        u = k_sel.uniform((3,)).tolist()  # the step's one planned host read
        do_sm, do_dpa, do_err = (x < t for x, t in zip(u, thresholds))
        dev = state.assignment.device
        counts = torch.zeros((5, 2), dtype=torch.int32, device=dev)

        if not mcmc_cfg.fix_assign:
            if mcmc_cfg.sm_prob > 0.0 and do_sm:
                state, sm_counts = split_merge(
                    k_assign, state, data, cfg, mcmc_cfg.sm_split_ratio,
                    mcmc_cfg.sm_steps)
                counts[1:3] += sm_counts
            else:
                state = gibbs_sweep(k_assign, state, data, cfg,
                                    impl=gibbs_impl)
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


def _rows_to_host(rows: list[TraceRow]) -> dict:
    """Stack a block's device rows and copy them to the host."""
    return {f: torch.stack([getattr(r, f) for r in rows]).cpu().numpy()
            for f in TraceRow._fields}


class MCMCRunner:
    """Single-chain steps-mode runner (reference MCMC class,
    libs/MCMC.py:26-193) on an explicit device."""

    def __init__(self, cfg: ModelConfig, mcmc_cfg: MCMCConfig,
                 data: PackedData, device, block_size: int = 256):
        self.cfg = cfg
        self.mcmc_cfg = mcmc_cfg
        self.data = data
        self.device = torch.device(device)
        self.block_size = block_size
        self.trace_k = resolve_trace_k(cfg, mcmc_cfg)
        self._step = _make_step_body(cfg, mcmc_cfg, data, self.trace_k)

    def init_chains(self, draws: Draws, n_chains: int = 1) -> CRPState:
        """Random initial state of the one chain (init_state mode
        'random'), from the first of `n_chains` keys as in bnpc_tpu."""
        if n_chains != 1:
            raise ValueError("the port runs one chain")
        return init_state(draws.split(n_chains)[0], self.cfg, self.data,
                          self.device, mode="random")

    def run_block(self, state: CRPState, draws: Draws, n_steps: int):
        """Run `n_steps` steps. Returns (state, rows, next_draws): rows is a
        dict of host arrays with a leading step axis, one entry per
        TraceRow field."""
        keys = draws.split(n_steps + 1)
        rows = []
        for k in keys[1:]:
            state, row = self._step(state, k)
            rows.append(row)
        return state, _rows_to_host(rows), keys[0]

    def run(self, run_var, seed: int, n_chains: int = 1):
        """run_var = (steps, burn_in). Returns [ChainResult]."""
        steps, burn_in = run_var
        if not isinstance(steps, (int, np.integer)) or n_chains != 1:
            raise ValueError("the port runs steps mode with one chain")
        steps, burn_in = int(steps), int(burn_in)
        root = TorchDraws(seed, self.device)
        k_init, k_run = root.split(2)
        state = self.init_chains(k_init, n_chains)
        draws = k_run.split(n_chains)[0]

        init = _rows_to_host([summarize(state, self.data, self.cfg,
                                        self.trace_k)])
        blocks = [init]
        done = 0
        while done < steps:
            b = min(self.block_size, steps - done)
            state, rows, draws = self.run_block(state, draws, b)
            # Keep the params trace from global row burn_in on (row 0 is
            # the initial state), as bnpc_tpu's trace buffer does.
            lo = max(0, min(b, burn_in - done - 1))
            rows["params"] = rows["params"][lo:]
            blocks.append(rows)
            done += b
        if burn_in > 0:
            blocks[0]["params"] = blocks[0]["params"][:0]
        full = {f: np.concatenate([blk[f] for blk in blocks])
                for f in TraceRow._fields}
        return [ChainResult(
            ML=full["ml"], MAP=full["map_"], DP_alpha=full["dp_alpha"],
            FN=full["fn"], FP=full["fp"],
            assignments=full["assignment"].astype(np.int32),
            params=full["params"].astype(np.float32), burn_in=burn_in,
            mh_counts=full["mh_counts"].sum(axis=0),
        )]
