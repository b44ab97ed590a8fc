"""The port's eager Gibbs path against bnpc_tpu.

* The eager sweep's plain twin (the CPU side of csrc/sweep.cu) against
  pallas_sweep in interpret mode on identical inputs, with two births in a
  row, births the sweep finds itself, and a saturated capacity: assignment,
  sizes and params exactly.
* gibbs_sweep(impl="eager") fed the JAX draws against bnpc_tpu's
  impl="pallas_eager" (interpret mode) and impl="scan_cond": assignment and
  sizes exactly, live parameter rows to rtol 1e-6.
* The fresh_rows contract of the draw providers, and the eager path's
  refusal of an [n, n] product that does not fit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnpc_tpu.data import pack_data
from bnpc_tpu.models import gibbs as jgibbs
from bnpc_tpu.ops.pallas_gibbs import pallas_sweep
from bnpc_tpu.state import init_state
from bnpc_tpu_torch.config import TMAX, TMIN
from bnpc_tpu_torch.draws import TorchDraws
from bnpc_tpu_torch.models import gibbs as tgibbs
from bnpc_tpu_torch.ops.cuda_sweep import eager_sweep
from tests.test_torch_ops import _interior_ks
from tests.torch_parity import (JaxDraws, assert_states_match, configs,
                                data_to_torch, make_problem, state_to_torch)

torch.set_num_threads(1)

N, M, K_PAD = 40, 16, 128


def _sweep_inputs(case):
    rng = np.random.default_rng({"two_births": 0, "natural": 1,
                                 "saturated": 2}[case])
    z = (rng.standard_normal((N, K_PAD)) * 3.0).astype(np.float32)
    gum = rng.gumbel(size=(N, K_PAD)).astype(np.float32)
    lf = (rng.standard_normal((N, N)) * 3.0).astype(np.float32)
    fresh = rng.uniform(TMIN, TMAX, (N, M)).astype(np.float32)
    params = rng.uniform(TMIN, TMAX, (K_PAD, M)).astype(np.float32)
    perm = rng.permutation(N).astype(np.int32)
    k_max = 24
    if case == "saturated":
        # Every slot live with >= 3 cells: no slot is free for the first
        # two cells, whose new-cluster option wins.
        k_max = 12
        assign = (np.arange(N) % k_max).astype(np.int32)
        aux = np.full(N, -1e30, np.float32)
        aux[perm[[0, 1]]] = 1e30
    else:
        assign = rng.integers(0, 16, N).astype(np.int32)  # slots 16.. free
        if case == "two_births":
            aux = np.full(N, -1e30, np.float32)
            aux[perm[[10, 11]]] = 1e30  # back to back in visit order
        else:
            aux = (rng.standard_normal(N) * 3.0).astype(np.float32)
    sizes = np.bincount(assign, minlength=K_PAD).astype(np.float32)
    sizes[k_max:] = -1.0
    log_denom = np.float32(np.log(N - 1.0 + 3.0))
    return z, gum, lf, fresh, aux, assign, perm, sizes, params, log_denom


@pytest.mark.parametrize("case", ["two_births", "natural", "saturated"])
def test_eager_twin_matches_pallas(case):
    (z, gum, lf, fresh, aux, assign, perm, sizes, params,
     log_denom) = _sweep_inputs(case)
    m_pad = 128
    fresh3 = np.pad(fresh, [(0, 0), (0, m_pad - M)],
                    constant_values=0.5)[:, None, :]
    params3 = np.pad(params, [(0, 0), (0, m_pad - M)],
                     constant_values=0.5)[:, None, :]
    lf2 = np.pad(lf, [(0, 0), (0, 128 - N)])  # [n8, nb * 128]
    a_j, s_j, p_j = pallas_sweep(*map(jnp.asarray, (
        z, gum, lf2, fresh3, aux, assign, perm, sizes, params3)),
        log_denom, interpret=True)

    t = torch.from_numpy
    a_t, s_t, p_t = eager_sweep(*map(t, (z, gum, lf, fresh, aux, assign,
                                         perm, sizes, params)),
                                torch.tensor(log_denom))
    np.testing.assert_array_equal(np.asarray(a_j), a_t.numpy())
    np.testing.assert_array_equal(np.asarray(s_j), s_t.numpy())
    np.testing.assert_array_equal(np.asarray(p_j)[:, :M], p_t.numpy())
    born = (sizes == 0) & (s_t.numpy() > 0)
    if case == "two_births":
        # Each hot cell opened its own slot and carries its newborn row.
        b1, b2 = int(a_t[perm[10]]), int(a_t[perm[11]])
        assert b1 != b2
        np.testing.assert_array_equal(p_t[b1].numpy(), fresh[perm[10]])
        np.testing.assert_array_equal(p_t[b2].numpy(), fresh[perm[11]])
    if case == "natural":
        assert born.sum() >= 1, "no cluster birth exercised"
    if case == "saturated":
        # Both wins were vetoed: no slot was patched.
        np.testing.assert_array_equal(p_t.numpy(), params)


@functools.lru_cache(maxsize=None)
def _jax_sweep(impl):
    return jax.jit(functools.partial(jgibbs.gibbs_sweep, impl=impl,
                                     interpret=impl == "pallas_eager"),
                   static_argnames=("cfg",))


@pytest.mark.parametrize("seed", [0, 1])
def test_eager_sweep_matches_jax(seed):
    n, m = 24, 12
    data, _ = make_problem(n=n, m=m, k_clones=2, seed=seed)
    jc, tc = configs(n, m, n, p=0.25, q=0.25, fp=0.01, fn=0.1)
    packed = pack_data(data)
    state = init_state(jax.random.key(seed), jc, packed, mode="random")
    tdata = data_to_torch(packed)
    births = 0
    for s in range(3):
        key = jax.random.key(100 * seed + s)
        want = _jax_sweep("scan_cond")(key, state, packed, cfg=jc)
        want_eager = _jax_sweep("pallas_eager")(key, state, packed, cfg=jc)
        got = tgibbs.gibbs_sweep(JaxDraws(key), state_to_torch(state), tdata,
                                 tc, impl="eager")
        assert_states_match(want, got)
        assert_states_match(want_eager, got)
        births += int(((np.asarray(state.cluster_size) == 0)
                       & (np.asarray(want.cluster_size) > 0)).sum())
        state = want
    assert births > 0, "no cluster birth exercised"


def test_jax_fresh_rows_contract():
    """Row c of JaxDraws.fresh_rows is fold_in(c).beta_binary on cell c's
    planes, clipped (bnpc_tpu's counter-keyed newborn rows)."""
    data, _ = make_problem(n=12, m=10, seed=4)
    td = data_to_torch(pack_data(data))
    draws = JaxDraws(jax.random.key(7))
    rows = draws.fresh_rows(0.25, 0.25, td.xm, td.xm0)
    assert rows.shape == (12, 10) and rows.dtype == torch.float32
    for c in range(12):
        want = torch.clamp(draws.fold_in(c).beta_binary(
            0.25, 0.25, td.xm[c], td.xm0[c]), TMIN, TMAX)
        np.testing.assert_array_equal(rows[c].numpy(), want.numpy())


def test_torchdraws_fresh_rows_ks():
    p, q = 0.25, 0.25
    rng = np.random.default_rng(5)
    n, m = 300, 300
    xm = (rng.random((n, m)) < 0.4).astype(np.float32)
    xm0 = ((rng.random((n, m)) < 0.4) * (1 - xm)).astype(np.float32)
    rows = TorchDraws(6, "cpu").fresh_rows(p, q, torch.from_numpy(xm),
                                           torch.from_numpy(xm0))
    assert rows.dtype == torch.float32
    rows = rows.numpy()
    assert (rows >= TMIN).all() and (rows <= TMAX).all()
    for a, b, sel in [(p, q, (xm == 0) & (xm0 == 0)), (p + 1, q, xm == 1),
                      (p, q + 1, xm0 == 1)]:
        ks = _interior_ks(rows[sel][:30_000], a, b)
        assert ks.pvalue > 0.005, (a, b, ks)


def test_eager_refuses_what_does_not_fit(monkeypatch):
    _, tc = configs(131072, 200, 128)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (32 * 2**30, 80 * 2**30))
    with pytest.raises(ValueError, match=r"\[131072, 131072\]"):
        tgibbs._check_eager_fits(tc, torch.device("cuda"))
    _, small = configs(5000, 200, 256)
    tgibbs._check_eager_fits(small, torch.device("cuda"))
