"""The port's opt-in blocked Gibbs sweep against bnpc_tpu's.

* gibbs_sweep(impl="blocked", block=B) fed the JAX draws (JaxDraws)
  against bnpc_tpu's gibbs_sweep(impl="blocked", block=B) for B in {1, 4,
  16}, from random initial states whose first block births: assignment
  and sizes exactly, live parameter rows to rtol 1e-6.
* block=1 gives the exact scan's partition (both on the port's own draws).
* MCMCConfig.gibbs_block routes the step's Gibbs move to the blocked sweep.
* make_block_fn (the CPU block) against bnpc_tpu.mcmc.make_block_fn
  under jax.jit, a block of steps on the same keys, with gibbs_block 4 and
  with the eager sweep (bnpc_tpu's scan_cond, which tests/test_torch_eager
  .py holds equal to its pallas_eager): assignments, sizes and MH counts
  exactly, live parameter rows to rtol 1e-6, ML and the log prior to the
  step tests' rtol 1e-5.
* (slow) the stationary partition distribution of the port's blocked
  sampler on the enumerable 5-cell problem against its exact sampler, at
  tests/test_blocked.py's tolerances.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from bnpc_tpu import mcmc as jmcmc
from bnpc_tpu.config import MCMCConfig as JMCMCConfig
from bnpc_tpu.data import pack_data
from bnpc_tpu.models import gibbs as jgibbs
from bnpc_tpu.parallel.axis import MutAxis
from bnpc_tpu.state import init_state
from bnpc_tpu_torch import mcmc as port_mcmc
from bnpc_tpu_torch.config import MCMCConfig, ModelConfig
from bnpc_tpu_torch.data import pack_data as port_pack
from bnpc_tpu_torch.draws import TorchDraws
from bnpc_tpu_torch.models import gibbs as port_gibbs
from bnpc_tpu_torch.state import init_state as port_init
from tests.torch_parity import (JaxDraws, assert_states_match, configs,
                                data_to_torch, make_problem, state_to_torch)

torch.set_num_threads(1)

N, M = 24, 12


@functools.lru_cache(maxsize=None)
def _jax_blocked(block):
    return jax.jit(functools.partial(jgibbs.gibbs_sweep, impl="blocked",
                                     block=block),
                   static_argnames=("cfg",))


def _problem(seed):
    data, _ = make_problem(n=N, m=M, k_clones=2, seed=seed)
    jc, tc = configs(N, M, N, p=0.25, q=0.25, fp=0.01, fn=0.1)
    packed = pack_data(data)
    state = init_state(jax.random.key(seed), jc, packed, mode="random")
    return jc, tc, packed, state


@pytest.mark.parametrize("block", [1, 4, 16])
def test_blocked_matches_jax(block, monkeypatch):
    born = []
    fresh = port_gibbs.fresh_row
    monkeypatch.setattr(port_gibbs, "fresh_row",
                        lambda k, cell, *a: born.append(cell) or
                        fresh(k, cell, *a))
    first_block_births = frozen_blocks = 0
    for seed in (0, 1):
        jc, tc, packed, state = _problem(seed)
        tdata, tstate = data_to_torch(packed), state_to_torch(state)
        for s in range(4):
            key = jax.random.key(100 * seed + s)
            want = _jax_blocked(block)(key, state, packed, cfg=jc)
            born.clear()
            got = port_gibbs.gibbs_sweep(JaxDraws(key), tstate, tdata, tc,
                                         impl="blocked", block=block)
            assert_states_match(want, got)
            # Visit positions of this sweep's births: one in the first
            # block, and fewer birth blocks than blocks (so at least one
            # block was decided against frozen sizes).
            perm = JaxDraws(key).split(3)[0].permutation(N).numpy()
            pos = {int(np.flatnonzero(perm == c)[0]) for c in born}
            first_block_births += any(p < block for p in pos)
            frozen_blocks += -(-N // block) - len({p // block for p in pos})
            state, tstate = want, state_to_torch(want)
    assert first_block_births > 0, "no birth in a first block"
    assert frozen_blocks > 0, "no block decided against frozen sizes"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block1_equals_scan(seed):
    """block=1 leaves the frozen pass nothing to freeze: the exact scan's
    partition, newborn rows and all, on the same draws."""
    data, _ = make_problem(n=N, m=M, k_clones=3, seed=seed)
    cfg = ModelConfig(n_cells=N, n_muts=M, k_max=N, p=0.25, q=0.25,
                      fp=0.01, fn=0.1)
    packed = port_pack(data, "cpu")
    state = port_init(TorchDraws(seed, "cpu"), cfg, packed, "cpu")
    for s in range(3):
        want = port_gibbs.gibbs_sweep(TorchDraws(50 + s, "cpu"), state,
                                      packed, cfg, impl="scan")
        got = port_gibbs.gibbs_sweep(TorchDraws(50 + s, "cpu"), state,
                                     packed, cfg, impl="blocked", block=1)
        for f in ("assignment", "cluster_size", "params"):
            torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                       rtol=0, atol=0)
        state = want


def test_gibbs_block_routes_through_step(monkeypatch):
    """With gibbs_block = 4 the step's Gibbs move is the blocked sweep on
    the move's draws; split-merge and the scalar moves are unchanged."""
    calls = []
    sweep = port_mcmc.gibbs_sweep

    def spy(*args, **kwargs):
        calls.append((kwargs.get("impl"), kwargs.get("block")))
        return sweep(*args, **kwargs)

    monkeypatch.setattr(port_mcmc, "gibbs_sweep", spy)
    jc, tc, packed, state = _problem(3)
    tdata, tstate = data_to_torch(packed), state_to_torch(state)
    mc = MCMCConfig(sm_prob=0.0, dpa_prob=0.0, error_prob=0.0, gibbs_block=4)
    step = port_mcmc.make_step_fn(tc, mc, tdata, 8)
    key = jax.random.key(7)
    got, _ = step(tstate, JaxDraws(key))
    assert calls == [("blocked", 4)]
    want = sweep(JaxDraws(key).split(5)[1], tstate, tdata, tc,
                 impl="blocked", block=4)
    for f in ("assignment", "cluster_size"):
        torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                   rtol=0, atol=0)


BLOCK_MODEL = dict(p=0.25, q=0.25, fp=0.01, fn=0.2, learn_errors=True,
                   fp_sd=0.01, fn_sd=0.1)
BLOCK_MIX = dict(sm_prob=0.33, dpa_prob=0.25, error_prob=0.25, sm_steps=3)
BLOCK_STEPS = 8


@functools.lru_cache(maxsize=None)
def _jax_block(gibbs_block, gibbs_impl):
    jc, _ = configs(N, M, N, **BLOCK_MODEL)
    jm = JMCMCConfig(**BLOCK_MIX, gibbs_block=gibbs_block)
    trace_k = jmcmc.resolve_trace_k(jc, jm)
    return jax.jit(lambda s, k, d: jmcmc.make_block_fn(
        jc, jm, d, trace_k, MutAxis(), gibbs_impl)(s, k)), trace_k


@pytest.mark.parametrize("case", ["blocked", "eager"])
def test_make_block_fn_matches_jax(case):
    """A block of BLOCK_STEPS steps of the port's make_block_fn (on the CPU,
    _chain_block over make_step_fn's step) on JaxDraws(key) against
    bnpc_tpu's make_block_fn on the same key's steps."""
    gibbs_block, jimpl, timpl = {"blocked": (4, "auto", "auto"),
                                 "eager": (0, "scan_cond", "eager")}[case]
    jc, tc = configs(N, M, N, **BLOCK_MODEL)
    jblock, trace_k = _jax_block(gibbs_block, jimpl)
    data, _ = make_problem(n=N, m=M, k_clones=3, seed=2)
    packed = pack_data(data)
    state = init_state(jax.random.key(2), jc, packed, mode="random")
    tblock = port_mcmc.make_block_fn(
        tc, MCMCConfig(**BLOCK_MIX, gibbs_block=gibbs_block),
        data_to_torch(packed), trace_k, gibbs_impl=timpl)
    key = jax.random.key(31)
    want, jrows = jblock(state, jax.random.split(key, BLOCK_STEPS + 1)[1:],
                         packed)
    got, trows, _ = tblock(state_to_torch(state), JaxDraws(key),
                           BLOCK_STEPS)
    np.testing.assert_array_equal(np.asarray(want.assignment),
                                  got.assignment.numpy())
    np.testing.assert_array_equal(np.asarray(want.cluster_size),
                                  got.cluster_size.numpy())
    live = np.asarray(want.cluster_size) > 0
    np.testing.assert_allclose(np.asarray(want.params)[live],
                               got.params.numpy()[live], rtol=1e-6)
    for f in ("assignment", "mh_counts"):
        np.testing.assert_array_equal(np.asarray(getattr(jrows, f)),
                                      trows[f], err_msg=f)
    jml, tml = np.asarray(jrows.ml), trows["ml"]
    np.testing.assert_allclose(jml, tml, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(jrows.map_) - jml,
                               trows["map_"] - tml, rtol=1e-5)
    for f in ("dp_alpha", "fp", "fn"):
        np.testing.assert_allclose(np.asarray(getattr(jrows, f)), trows[f],
                                   rtol=1e-5, err_msg=f)
    # The block held Gibbs sweeps with births, splits and merges.
    counts = trows["mh_counts"]
    assert (counts[:, 1:3].sum(axis=(1, 2)) == 0).any()
    assert counts[:, 1].sum() > 0 and counts[:, 2].sum() > 0


@pytest.mark.slow
def test_blocked_stationary_tv():
    """tests/test_blocked.py::test_blocked_stationary_tv on the port: the
    stationary partition distribution of the blocked sampler (block=2,
    the proportionally worst drift at n=5) against the exact one, 13,500
    retained samples each, the same TV and top-partition tolerances."""
    from collections import Counter

    geno = np.array([[1, 1, 0, 0], [0, 0, 1, 1]])
    data = geno[np.array([0, 0, 0, 1, 1])].astype(float)
    data[0, 1] = np.nan
    steps, burn = 15000, 1500
    n, m = data.shape
    cfg = ModelConfig(n_cells=n, n_muts=m, k_max=n, p=0.25, q=0.25,
                      fp=0.01, fn=0.1)

    def run(gibbs_block):
        mc = MCMCConfig(sm_prob=0.33, dpa_prob=0.0, error_prob=0.0,
                        sm_steps=3, gibbs_block=gibbs_block)
        runner = port_mcmc.MCMCRunner(cfg, mc, port_pack(data, "cpu"),
                                      device="cpu", block_size=5000)
        res = runner.run((steps, burn), seed=17, n_chains=1)[0]
        return res.assignments[burn:]

    def freqs(assigns):
        def canon(a):
            lab = {}
            return tuple(lab.setdefault(x, len(lab)) for x in a)

        c = Counter(canon(a) for a in assigns)
        tot = sum(c.values())
        return {k: v / tot for k, v in c.items()}

    fe, fb = freqs(run(0)), freqs(run(2))
    keys = set(fe) | set(fb)
    tv = 0.5 * sum(abs(fe.get(k, 0) - fb.get(k, 0)) for k in keys)
    assert tv < 0.055, f"TV distance {tv:.4f}"
    for k in sorted(keys, key=lambda k: -fe.get(k, 0))[:6]:
        assert abs(fe.get(k, 0) - fb.get(k, 0)) < 0.045, \
            (k, fe.get(k, 0), fb.get(k, 0))
