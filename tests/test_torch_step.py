"""The slice as a whole: the port's MCMC step against bnpc_tpu's.

Each step starts BOTH packages from the JAX state after the previous step
(carried over by bnpc_tpu_torch.convert), so a float near-tie in one MH
decision cannot cascade; the port consumes the JAX draws (JaxDraws).
Assignment, sizes and MH counts must match exactly; alpha, FP, FN, params,
ML and MAP to rtol 1e-5 (float32 sums in another order than XLA's). Learned
errors and the full move mixture; the seeds' MH counts show Gibbs sweeps,
splits and merges.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from bnpc_tpu import mcmc as jmcmc
from bnpc_tpu.config import MCMCConfig as JMCMCConfig
from bnpc_tpu.data import pack_data
from bnpc_tpu.parallel.axis import MutAxis
from bnpc_tpu.state import init_state
from bnpc_tpu_torch import mcmc as tmcmc
from bnpc_tpu_torch.config import MCMCConfig as TMCMCConfig
from bnpc_tpu_torch.data import pack_data as tpack
from tests.torch_parity import (JaxDraws, assert_states_match, configs,
                                data_to_torch, make_problem, state_to_torch)

torch.set_num_threads(1)

N, M = 30, 12
MODEL = dict(p=0.25, q=0.25, fp=0.01, fn=0.2, learn_errors=True, fp_sd=0.01,
             fn_sd=0.1)
MIX = dict(sm_prob=0.33, dpa_prob=0.25, error_prob=0.25, sm_steps=3)


@functools.lru_cache(maxsize=None)
def _jax_step():
    jc, _ = configs(N, M, N, **MODEL)
    jm = JMCMCConfig(**MIX)
    trace_k = jmcmc.resolve_trace_k(jc, jm)
    return jax.jit(lambda s, k, d: jmcmc._make_step_body(
        jc, jm, d, trace_k, MutAxis(), "auto", False)(s, k)), trace_k


@pytest.mark.parametrize("seed", [0, 1])
def test_step_matches_jax(seed):
    jc, tc = configs(N, M, N, **MODEL)
    jstep, trace_k = _jax_step()
    data, _ = make_problem(n=N, m=M, k_clones=3, seed=seed)
    packed = pack_data(data)
    tstep = tmcmc.make_step_fn(tc, TMCMCConfig(**MIX),
                               data_to_torch(packed), trace_k)
    state = init_state(jax.random.key(seed), jc, packed, mode="random")
    gibbs = 0
    totals = np.zeros((5, 2), np.int64)
    for key in jax.random.split(jax.random.key(1000 + seed), 16):
        want, jrow = jstep(state, key, packed)
        got, trow = tstep(state_to_torch(state), JaxDraws(key))
        assert_states_match(want, got, rtol=1e-5)
        counts = np.asarray(jrow.mh_counts)
        np.testing.assert_array_equal(counts, trow.mh_counts.numpy())
        for f in ("ml", "map_", "dp_alpha", "fp", "fn"):
            np.testing.assert_allclose(np.asarray(getattr(jrow, f)),
                                       getattr(trow, f).numpy(), rtol=1e-5)
        np.testing.assert_array_equal(np.asarray(jrow.assignment),
                                      trow.assignment.numpy())
        np.testing.assert_array_equal(np.asarray(jrow.params),
                                      trow.params.numpy())
        gibbs += int(counts[1:3].sum() == 0)
        totals += counts
        state = want
    assert gibbs > 0 and totals[1].sum() > 0 and totals[2].sum() > 0, \
        "the seed must exercise Gibbs sweeps, splits and merges"


@pytest.mark.parametrize("burn_in", [10, 0])
def test_runner_result_shapes(burn_in):
    _, tc = configs(N, M, N, **MODEL)
    data, _ = make_problem(n=N, m=M, k_clones=3, seed=5)
    runner = tmcmc.MCMCRunner(tc, TMCMCConfig(**MIX), tpack(data, "cpu"),
                              device="cpu", block_size=16)
    (res,) = runner.run((30, burn_in), seed=3)
    trace_k = tmcmc.resolve_trace_k(tc, TMCMCConfig(**MIX))
    # bnpc_tpu's ChainResult contract: the initial row first, params kept
    # from row burn_in on, i32 assignments, f32 traces and params.
    for f in ("ML", "MAP", "DP_alpha", "FN", "FP"):
        v = getattr(res, f)
        assert v.shape == (31,) and v.dtype == np.float32, f
        assert np.isfinite(v).all(), f
    assert res.assignments.shape == (31, N)
    assert res.assignments.dtype == np.int32
    assert res.params.shape == (31 - burn_in, trace_k, M)
    assert res.params.dtype == np.float32
    assert res.burn_in == burn_in
    assert res.mh_counts.shape == (5, 2)
    assert res.mh_counts[0].sum() > 0
    last = res.assignments[-1]
    assert ((last >= 0) & (last < tc.k_max)).all()
