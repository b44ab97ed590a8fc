"""The port's streaming Gibbs path against bnpc_tpu.

* The streaming segment's plain twin (the CPU side of csrc/lazy_stream.cu)
  against pallas_lazy_segment_stream in interpret mode, zp chunked
  [G, C=8, k_pad] so that a segment crosses chunks: targets, sizes and info
  exactly.
* gibbs_sweep(impl="stream") fed the JAX draws against bnpc_tpu's
  impl="pallas_stream" (interpret mode, 8-row chunks) and impl="scan_cond":
  assignment and sizes exactly, live parameter rows to rtol 1e-6.
* The routing rule against bnpc_tpu's resolve_stream, and one step-body
  parity with gibbs_impl="stream" (tolerances of tests/test_torch_step.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bnpc_tpu.ops.pallas_gibbs as pg
from bnpc_tpu import mcmc as jmcmc
from bnpc_tpu.config import MCMCConfig as JMCMCConfig
from bnpc_tpu.data import pack_data
from bnpc_tpu.models import gibbs as jgibbs
from bnpc_tpu.parallel.axis import MutAxis
from bnpc_tpu.state import init_state
from bnpc_tpu_torch import mcmc as tmcmc
from bnpc_tpu_torch.config import MCMCConfig as TMCMCConfig
from bnpc_tpu_torch.models.gibbs import gibbs_sweep, resolve_impl
from bnpc_tpu_torch.ops import cuda_gibbs
from bnpc_tpu_torch.ops.cuda_stream import lazy_segment_stream
from tests.torch_parity import (JaxDraws, assert_states_match, configs,
                                data_to_torch, make_problem, state_to_torch)

torch.set_num_threads(1)

N, C, K_PAD, K_MAX = 40, 8, 128, 24


@pytest.fixture(autouse=True)
def small_chunks(monkeypatch):
    """8-row chunks in bnpc_tpu's streaming path (tests/test_pallas.py:216),
    and its kernel in interpret mode wherever a caller leaves it compiled
    (the step body does)."""
    orig = pg.pallas_lazy_segment_stream

    def interpreted(*args, interpret=False, **kw):
        return orig(*args, interpret=True, **kw)

    monkeypatch.setattr(pg, "stream_chunk_rows", lambda k, *a, **kw: C)
    monkeypatch.setattr(pg, "pallas_lazy_segment_stream", interpreted)


def _segment_inputs(case):
    rng = np.random.default_rng(
        {"plain": 0, "birth": 1, "veto": 2, "late_i0": 3}[case])
    zp = (rng.standard_normal((N, K_PAD)) * 3.0).astype(np.float32)
    auxp = np.full(N, -1e30, np.float32)
    k_max, i0 = K_MAX, 5
    if case == "veto":
        k_max = 16  # every slot live with >= 2 cells: no slot can free up
        assignp = (np.arange(N) % k_max).astype(np.int32)
        auxp[[2, 9, 17]] = 1e30
        i0 = 0
    else:
        assignp = rng.integers(0, 16, N).astype(np.int32)  # slots 16.. free
        if case == "birth":
            auxp[21] = 1e30  # a later chunk than i0's
        if case == "late_i0":
            i0 = 19  # inside the third chunk
            auxp[33] = 1e30
    sizes = np.bincount(assignp, minlength=K_PAD).astype(np.float32)
    sizes[k_max:] = -1.0
    log_denom = np.float32(np.log(N - 1.0 + 3.0))
    return zp, auxp, assignp, sizes, i0, log_denom


@pytest.mark.parametrize("case", ["plain", "birth", "veto", "late_i0"])
def test_stream_twin_matches_pallas(case):
    zp, auxp, assignp, sizes, i0, log_denom = _segment_inputs(case)
    tgt_j, sizes_j, info_j = pg.pallas_lazy_segment_stream(
        jnp.asarray(zp).reshape(N // C, C, K_PAD), jnp.asarray(auxp),
        jnp.asarray(assignp), jnp.asarray(sizes)[None], i0, log_denom,
        interpret=True, track_veto=True)

    t = torch.from_numpy
    sizes_t = t(sizes.copy())
    tgt_t = torch.full((N,), -7, dtype=torch.int32)
    info_t = torch.zeros((4,), dtype=torch.int32)
    lazy_segment_stream(t(zp), t(auxp), t(assignp), sizes_t, tgt_t, info_t,
                        i0, torch.tensor(log_denom))

    info = info_t.numpy()
    np.testing.assert_array_equal(np.asarray(info_j), info)
    np.testing.assert_array_equal(np.asarray(sizes_j)[0], sizes_t.numpy())
    i_next = int(info[0])
    np.testing.assert_array_equal(np.asarray(tgt_j)[i0:i_next],
                                  tgt_t.numpy()[i0:i_next])
    assert (tgt_t.numpy()[:i0] == -7).all()
    assert (tgt_t.numpy()[i_next:] == -7).all()
    expect = {"plain": (N, -1, 0), "birth": (22, 21, 0), "veto": (N, -1, 1),
              "late_i0": (34, 33, 0)}[case]
    assert (int(info[0]), int(info[1]), int(info[3])) == expect


@functools.lru_cache(maxsize=None)
def _jax_sweep(impl):
    return jax.jit(functools.partial(jgibbs.gibbs_sweep, impl=impl,
                                     interpret=impl == "pallas_stream"),
                   static_argnames=("cfg",))


@pytest.mark.parametrize("seed", [0, 1])
def test_stream_sweep_matches_jax(seed):
    n, m = 28, 12
    data, _ = make_problem(n=n, m=m, k_clones=2, seed=seed + 5)
    jc, tc = configs(n, m, n, p=0.25, q=0.25, fp=0.01, fn=0.1)
    packed = pack_data(data)
    state = init_state(jax.random.key(seed), jc, packed, mode="random")
    tdata = data_to_torch(packed)
    births = 0
    for s in range(3):
        key = jax.random.key(500 + 10 * seed + s)
        want = _jax_sweep("scan_cond")(key, state, packed, cfg=jc)
        want_st = _jax_sweep("pallas_stream")(key, state, packed, cfg=jc)
        got = gibbs_sweep(JaxDraws(key), state_to_torch(state), tdata, tc,
                          impl="stream")
        assert_states_match(want, got)
        assert_states_match(want_st, got)
        births += int(((np.asarray(state.cluster_size) == 0)
                       & (np.asarray(want.cluster_size) > 0)).sum())
        state = want
    assert births > 0, "no cluster birth exercised"


@pytest.mark.parametrize("n,k_max", [(5000, 256), (50000, 128),
                                     (131072, 128), (5000, 5000)])
def test_resolve_stream_matches_jax(n, k_max):
    jc, tc = configs(n, 50, k_max)
    assert cuda_gibbs.resolve_stream(tc) == jgibbs.resolve_stream(jc)


def test_auto_routing():
    _, small = configs(5000, 50, 256)
    _, wide = configs(5000, 50, 1056)   # Z 21 MB: stream by bnpc_tpu's rule
    _, slots = configs(1200, 50, 1100)  # Z 5.6 MB, but > 1024 slots
    assert resolve_impl("auto", small, on_cuda=True) == "lazy"
    assert resolve_impl("auto", wide, on_cuda=True) == "stream"
    assert not jgibbs.resolve_stream(configs(1200, 50, 1100)[0])
    assert resolve_impl("auto", slots, on_cuda=True) == "stream"
    assert resolve_impl("auto", slots, on_cuda=False) == "scan"
    assert resolve_impl("eager", small, on_cuda=True) == "eager"


def test_stream_k_pad():
    assert cuda_gibbs.stream_k_pad(128) == 128
    assert cuda_gibbs.stream_k_pad(200) == 224
    assert cuda_gibbs.stream_k_pad(5000) == 5024
    assert cuda_gibbs.stream_k_pad(cuda_gibbs.SMEM_MAX_SLOTS) \
        == cuda_gibbs.SMEM_MAX_SLOTS
    with pytest.raises(ValueError, match="58112 slots"):
        cuda_gibbs.stream_k_pad(cuda_gibbs.SMEM_MAX_SLOTS + 1)
    with pytest.raises(ValueError, match="1024 slots"):
        cuda_gibbs.lazy_k_pad(1100)


SN, SM = 30, 12
MODEL = dict(p=0.25, q=0.25, fp=0.01, fn=0.2, learn_errors=True, fp_sd=0.01,
             fn_sd=0.1)
MIX = dict(sm_prob=0.33, dpa_prob=0.25, error_prob=0.25, sm_steps=3)


def test_stream_step_matches_jax():
    jc, tc = configs(SN, SM, SN, **MODEL)
    jm = JMCMCConfig(**MIX)
    trace_k = jmcmc.resolve_trace_k(jc, jm)
    jstep = jax.jit(lambda s, k, d: jmcmc._make_step_body(
        jc, jm, d, trace_k, MutAxis(), "pallas_stream", False)(s, k))
    data, _ = make_problem(n=SN, m=SM, k_clones=3, seed=0)
    packed = pack_data(data)
    tstep = tmcmc.make_step_fn(tc, TMCMCConfig(**MIX),
                               data_to_torch(packed), trace_k,
                               gibbs_impl="stream")
    state = init_state(jax.random.key(0), jc, packed, mode="random")
    gibbs = 0
    for key in jax.random.split(jax.random.key(1000), 8):
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
        gibbs += int(counts[1:3].sum() == 0)
        state = want
    assert gibbs > 0, "the seed must exercise Gibbs sweeps"
