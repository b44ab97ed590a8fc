"""The port's ops, data and state against bnpc_tpu on identical inputs, and
its own samplers in distribution (KS tests in the style of
tests/test_randomx.py)."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import beta as beta_dist
from scipy.stats import gamma as gamma_dist
from scipy.stats import kstest
from scipy.stats import truncnorm as truncnorm_dist

from bnpc_tpu import state as jstate
from bnpc_tpu.data import pack_data as jpack
from bnpc_tpu.ops import likelihood as jlk
from bnpc_tpu.ops import mh as jmh
from bnpc_tpu.ops import truncnorm as jtn
from bnpc_tpu_torch import state as tstate
from bnpc_tpu_torch.data import pack_data as tpack
from bnpc_tpu_torch.draws import TorchDraws
from bnpc_tpu_torch.ops import likelihood as tlk
from bnpc_tpu_torch.ops import mh as tmh
from bnpc_tpu_torch.ops import truncnorm as ttn
from tests.torch_parity import configs, make_problem

torch.set_num_threads(1)

RTOL = 1e-5  # float32 sums in another order than XLA's
# Where a result crosses zero by cancellation of O(10) terms, the relative
# error of a float32 difference is unbounded; ATOL is float32's resolution at
# the terms' scale.
ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _problem(seed, n=40, m=16, k=12, **kw):
    data, _ = make_problem(n=n, m=m, k_clones=3, seed=seed)
    jc, tc = configs(n, m, k, **kw)
    rng = np.random.default_rng(seed)
    params = rng.uniform(1e-5, 1 - 1e-5, (k, m)).astype(np.float32)
    assign = rng.integers(0, k, n).astype(np.int32)
    return data, jc, tc, params, assign


def test_pack_data_matches():
    data, *_ = _problem(0)
    for a, b in zip(jpack(data), tpack(data, "cpu")):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_cluster_stats_match(seed):
    data, jc, tc, _, assign = _problem(seed)
    jn1, jn0 = jstate.cluster_stats(jpack(data), jnp.asarray(assign),
                                    jc.k_max)
    tn1, tn0 = tstate.cluster_stats(tpack(data, "cpu"), _t(assign), tc.k_max)
    np.testing.assert_array_equal(np.asarray(jn1), tn1.numpy())
    np.testing.assert_array_equal(np.asarray(jn0), tn0.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_likelihood_matches(seed):
    data, jc, tc, params, assign = _problem(seed, p=0.25, q=0.25, fp=0.01,
                                            fn=0.2)
    jd, td = jpack(data), tpack(data, "cpu")
    fp, fn = np.float32(0.013), np.float32(0.17)
    jc1, jc0 = jlk.log_prob_tables(jnp.asarray(params), fp, fn)
    tc1, tc0 = tlk.log_prob_tables(_t(params), _t(fp), _t(fn))
    np.testing.assert_allclose(np.asarray(jc1), tc1.numpy(), rtol=RTOL)
    np.testing.assert_allclose(np.asarray(jc0), tc0.numpy(), rtol=RTOL)
    np.testing.assert_allclose(np.asarray(jlk.ll_matrix(jd, jc1, jc0)),
                               tlk.ll_matrix(td, tc1, tc0).numpy(), rtol=RTOL)
    np.testing.assert_allclose(
        np.asarray(jlk.ll_col(jc1[3], jc0[3], jd.xm, jd.xm0)),
        tlk.ll_col(tc1[3], tc0[3], td.xm, td.xm0).numpy(), rtol=RTOL)
    jn1, jn0 = jstate.cluster_stats(jd, jnp.asarray(assign), jc.k_max)
    tn1, tn0 = tstate.cluster_stats(td, _t(assign), tc.k_max)
    np.testing.assert_allclose(
        np.asarray(jlk.ll_from_stats(jn1, jn0, jc1, jc0)),
        tlk.ll_from_stats(tn1, tn0, tc1, tc0).numpy(), rtol=RTOL)
    np.testing.assert_allclose(
        np.asarray(jlk.new_cluster_ll(jd, jc, fp, fn)),
        tlk.new_cluster_ll(td, tc, _t(fp), _t(fn)).numpy(), rtol=RTOL)


@pytest.mark.parametrize("pq,learn", [((1.0, 1.0), False),
                                      ((0.25, 0.25), True)])
def test_log_prior_full_matches(pq, learn):
    data, jc, tc, params, assign = _problem(
        2, p=pq[0], q=pq[1], fp=0.01, fn=0.2, learn_errors=learn,
        fp_sd=0.01, fn_sd=0.1)
    sizes = np.bincount(assign, minlength=jc.k_max).astype(np.int32)
    sizes[:3] = 0
    alpha, fp, fn = (np.float32(v) for v in (8.3, 0.012, 0.18))
    want = jlk.log_prior_full(jc, jnp.asarray(sizes), jnp.asarray(params),
                              alpha, fp, fn)
    got = tlk.log_prior_full(tc, _t(sizes), _t(params), _t(alpha), _t(fp),
                             _t(fn))
    np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=RTOL)


@pytest.mark.parametrize("clip", [False, True])
def test_log_A_matches(clip):
    data, jc, tc, params, assign = _problem(3, p=0.25, q=0.25)
    rng = np.random.default_rng(3)
    std = rng.choice(np.array([0.1, 0.25, 0.5], np.float32), params.shape)
    new = np.clip(params + rng.normal(0, 0.1, params.shape),
                  2e-5, 1 - 2e-5).astype(np.float32)
    a = ((1e-5 - params) / std).astype(np.float32)
    b = ((1 - 1e-5 - params) / std).astype(np.float32)
    n1 = rng.integers(0, 9, params.shape).astype(np.float32)
    n0 = rng.integers(0, 9, params.shape).astype(np.float32)
    fp, fn = np.float32(0.01), np.float32(0.2)
    args = (new, params, n1, n0, a, b, std, fp, fn)
    want = jmh.log_A(*map(jnp.asarray, args), jc, clip)
    got = tmh.log_A(*map(_t, args), tc, clip)
    np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_truncnorm_logpdf_matches():
    rng = np.random.default_rng(4)
    loc = rng.uniform(0.01, 0.99, 500).astype(np.float32)
    scale = rng.choice(np.array([0.1, 0.25, 0.5], np.float32), 500)
    a = ((1e-5 - loc) / scale).astype(np.float32)
    b = ((1 - 1e-5 - loc) / scale).astype(np.float32)
    x = rng.uniform(1e-5, 1 - 1e-5, 500).astype(np.float32)
    args = (x, a, b, loc, scale)
    np.testing.assert_allclose(np.asarray(jtn.logpdf(*map(jnp.asarray,
                                                          args))),
                               ttn.logpdf(*map(_t, args)).numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("mode", ["random", "together", "separate",
                                  "assign"])
def test_init_state_invariants(mode):
    data, _, tc, _, _ = _problem(5, k=40, p=0.25, q=0.25)
    packed = tpack(data, "cpu")
    assign = [0, 1, 1, 2] * 10 if mode == "assign" else None
    st = tstate.init_state(TorchDraws(5, "cpu"), tc, packed, "cpu",
                           mode=mode, assign=assign)
    a, sizes = st.assignment.numpy(), st.cluster_size.numpy()
    assert st.assignment.dtype == torch.int32
    assert st.cluster_size.dtype == torch.int32
    assert ((a >= 0) & (a < tc.k_max)).all()
    np.testing.assert_array_equal(sizes, np.bincount(a, minlength=tc.k_max))
    p = st.params.numpy()
    assert st.params.dtype == torch.float32 and p.shape == (40, 16)
    assert (p >= 1e-5 - 1e-7).all() and (p <= 1 - 1e-5 + 1e-7).all()
    if mode == "assign":
        assert int(st.n_clusters) == 3


def _interior_ks(vals, a, b):
    """KS on the interior (f32 quantizes Beta tails with a, b < 1; see
    tests/test_randomx.py)."""
    lo, hi = 1e-3, 1 - 1e-3
    interior = vals[(vals > lo) & (vals < hi)].astype(np.float64)
    cdf = beta_dist(a, b).cdf
    u = (cdf(interior) - cdf(lo)) / (cdf(hi) - cdf(lo))
    return kstest(u, "uniform")


def test_torchdraws_beta_binary_ks():
    p, q = 0.25, 0.25
    rng = np.random.default_rng(3)
    n, m = 300, 300
    xm = (rng.random((n, m)) < 0.4).astype(np.float32)
    xm0 = ((rng.random((n, m)) < 0.4) * (1 - xm)).astype(np.float32)
    draws = TorchDraws(1, "cpu").beta_binary(p, q, _t(xm), _t(xm0)).numpy()
    for a, b, sel in [(p, q, (xm == 0) & (xm0 == 0)), (p + 1, q, xm == 1),
                      (p, q + 1, xm0 == 1)]:
        ks = _interior_ks(draws[sel][:30_000], a, b)
        assert ks.pvalue > 0.005, (a, b, ks)


@pytest.mark.parametrize("a,b", [(0.25, 3.25), (2.5, 7.0)])
def test_torchdraws_beta_general_ks(a, b):
    shape = (40_000,)
    draws = TorchDraws(2, "cpu").beta_general(
        torch.full(shape, a), torch.full(shape, b)).numpy()
    ks = _interior_ks(draws, a, b)
    assert ks.pvalue > 0.005, (a, b, ks)


@pytest.mark.parametrize("loc,scale", [(0.3, 0.25), (0.99, 0.1)])
def test_torchdraws_truncnorm_ks(loc, scale):
    a, b = (1e-5 - loc) / scale, (1 - 1e-5 - loc) / scale
    shape = (40_000,)
    x = TorchDraws(3, "cpu").truncnorm(
        torch.full(shape, a), torch.full(shape, b), torch.full(shape, loc),
        torch.full(shape, scale)).numpy().astype(np.float64)
    assert (x >= loc + a * scale - 1e-6).all()
    assert (x <= loc + b * scale + 1e-6).all()
    ks = kstest(x, truncnorm_dist(a, b, loc=loc, scale=scale).cdf)
    assert ks.pvalue > 0.005, ks


@pytest.mark.parametrize("shape_param", [1.25, 14.0])
def test_torchdraws_gamma_ks(shape_param):
    g = TorchDraws(4, "cpu").gamma(torch.full((40_000,), shape_param))
    ks = kstest(g.numpy().astype(np.float64), gamma_dist(shape_param).cdf)
    assert ks.pvalue > 0.005, ks


def test_import_keeps_jax_out():
    code = (
        "import sys\n"
        "import bnpc_tpu_torch, bnpc_tpu_torch.mcmc, bnpc_tpu_torch.convert\n"
        "import bnpc_tpu_torch.probes.vecflow_probe\n"
        "import bnpc_tpu_torch.probes.while_probe\n"
        "import bnpc_tpu_torch.parallel, bnpc_tpu_torch.parallel.axis\n"
        "import bnpc_tpu_torch.parallel.sharded\n"
        "import bnpc_tpu_torch.parallel.multihost\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'bnpc_tpu', 'benchmarks')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
