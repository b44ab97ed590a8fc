"""The port's diagnostics and estimators against bnpc_tpu's on the same inputs.

Diagnostics are a copy of numpy code: equal to rtol 1e-12. Estimators run
with device="cpu" (the same torch ops as on a GPU): consensus assignments
equal exactly on the exact and on the landmark MPEAR path, the similarity
block and the contingency tables bit for bit, genotypes and latent
estimates to rtol 1e-6. The port's own ARI / V-measure (numpy, no sklearn)
are held against sklearn's.
"""

import numpy as np
import pytest
import torch
from sklearn.metrics import adjusted_rand_score, v_measure_score

from bnpc_tpu import diagnostics as jax_diag
from bnpc_tpu import estimators as jax_est
from bnpc_tpu_torch import diagnostics as port_diag
from bnpc_tpu_torch import estimators as port_est
from tests.test_estimators import _make_trace

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# diagnostics: the cases of tests/test_diagnostics.py
# ---------------------------------------------------------------------------


def _ar1(n=4000, rho=0.95, seed=0):
    rng = np.random.default_rng(seed)
    x = np.empty(n)
    x[0] = 0.0
    for i in range(1, n):
        x[i] = rho * x[i - 1] + rng.normal()
    return x


_PSRF_CASES = {
    "oracle": lambda: [(np.random.default_rng(0).normal(size=500) + 0.1 * c,
                        50) for c in range(4)],
    "short_inf": lambda: [(np.arange(5.0), 0)],
    "nine_samples": lambda: [(np.random.default_rng(1).normal(size=9), 0)],
    "converged": lambda: [(x, 0) for x in
                          np.random.default_rng(2).normal(size=(4, 2000))],
}


@pytest.mark.parametrize("case", sorted(_PSRF_CASES))
def test_lugsail_psrf_matches_jax(case):
    chains = _PSRF_CASES[case]()
    got, want = port_diag.lugsail_psrf(chains), jax_diag.lugsail_psrf(chains)
    if np.isinf(want):
        assert got == want
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12)
    assert port_diag.lugsail_psrf(chains, steps=300) == pytest.approx(
        jax_diag.lugsail_psrf(chains, steps=300), rel=1e-12)


@pytest.mark.parametrize("e", [0.05, 0.1])
def test_lugsail_cutoff_matches_jax(e):
    np.testing.assert_allclose(port_diag.lugsail_cutoff(e),
                               jax_diag.lugsail_cutoff(e), rtol=1e-12)


@pytest.mark.parametrize("trace", ["iid", "ar1", "short", "constant"])
def test_effective_sample_size_matches_jax(trace):
    x = {"iid": lambda: np.random.default_rng(0).normal(size=4000),
         "ar1": _ar1, "short": lambda: np.arange(7.0),
         "constant": lambda: np.ones(50)}[trace]()
    np.testing.assert_allclose(port_diag.effective_sample_size(x),
                               jax_diag.effective_sample_size(x), rtol=1e-12)


# ---------------------------------------------------------------------------
# estimators
# ---------------------------------------------------------------------------


def _clear_consensus():
    """tests/test_diagnostics.py::test_mpear_recovers_clear_consensus."""
    rng = np.random.default_rng(3)
    true = np.array([0] * 8 + [1] * 8 + [2] * 8)
    samples = []
    for _ in range(60):
        s = rng.permutation(6)[:3][true]
        s[rng.integers(0, true.size, size=1)] = rng.integers(0, 6)
        samples.append(s)
    return np.array(samples)


def _separable(n=300, steps=40, k=5):
    """tests/test_estimators.py::test_mpear_landmark_path_matches_exact."""
    rng = np.random.default_rng(7)
    a = np.tile(np.repeat(np.arange(k), n // k), (steps, 1))
    flip = rng.random((steps, n)) < 0.03
    a[flip] = rng.integers(0, k, int(flip.sum()))
    return a


@pytest.mark.parametrize("case,max_exact", [
    ("clear", None), ("separable", 300), ("separable", 10)])
def test_mpear_assignment_matches_jax(case, max_exact, monkeypatch):
    a = _clear_consensus() if case == "clear" else _separable()
    if max_exact == 10:  # the landmark path, 90 landmarks
        monkeypatch.setenv("BNPC_TPU_MPEAR_LANDMARKS", "90")
    want = jax_est.mpear_assignment(a, max_exact=max_exact)
    got = port_est.mpear_assignment(a, max_exact=max_exact, device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port_est._cut_range(a, "cpu"),
                                  jax_est._cut_range(a))


def test_similarity_and_contingency_bitwise():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 6, (25, 50))
    cols = np.array([0, 7, 13, 49])
    got = port_est._sim_to_cols_device(a, cols, "cpu")
    assert got.dtype == torch.float32
    want = np.asarray(jax_est._sim_to_cols_device(a, cols))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(port_est.coclustering_similarity(a, "cpu"),
                                  jax_est.coclustering_similarity(a))
    labels = rng.integers(0, 4, 50)
    np.testing.assert_array_equal(
        port_est._contingency_device(a, labels, "cpu"),
        jax_est._contingency_device(a, labels))


def test_mpear_scores_match_reference_formula():
    """Both scorers against the reference's condensed formula
    (bnpc_tpu's _mpear_score); the port's terms are exact in float64."""
    from scipy.spatial.distance import squareform

    rng = np.random.default_rng(11)
    a = rng.integers(0, 5, (30, 40))
    labels = np.stack([rng.integers(0, k, 40) for k in (2, 3, 5, 8)], axis=1)
    cond = squareform(jax_est.coclustering_similarity(a), checks=False)
    want = np.array([jax_est._mpear_score(cond, labels[:, j])
                     for j in range(labels.shape[1])])
    batch = port_est._mpear_scores_batch(
        port_est._coclustering_device(a, "cpu"), labels)
    pairs = port_est._mpear_scores_pairs(a, labels, "cpu")
    np.testing.assert_allclose(batch, want, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(pairs, want, rtol=1e-6, atol=1e-9)


def _consensus_case(case):
    if case == "weighted":
        # tests/test_estimators.py::test_weighted_fallback_branch
        rng = np.random.default_rng(9)
        steps, n, m, capacity = 12, 10, 4, 10
        a = np.empty((steps, n), dtype=np.int64)
        for s in range(steps):
            a[s, :5] = rng.permutation([0, 0, 0, 1, 1])
            a[s, 5:] = rng.permutation([2, 2, 3, 3, 3])
        params = np.zeros((steps, capacity, m))
        for s in range(steps):
            params[s, :4] = rng.random((4, m))
        return a, params
    return _make_trace(case)


@pytest.mark.parametrize("case", [0, 1, 2, 3, "weighted"])
def test_consensus_genotypes_matches_jax(case):
    a, params = _consensus_case(case)
    want_assign, want = jax_est.consensus_genotypes(a, params)
    got_assign, got = port_est.consensus_genotypes(a, params, device="cpu")
    np.testing.assert_array_equal(got_assign, want_assign)
    assert list(got.columns) == list(want.columns)
    np.testing.assert_allclose(got.values, want.values, rtol=1e-6)


def test_consensus_capacity_guard():
    a, params = _make_trace(5, k_ids=9, capacity=12, n=30)
    a[0, :9] = np.arange(9)
    for mod, kw in ((jax_est, {}), (port_est, {"device": "cpu"})):
        with pytest.raises(ValueError, match="trace capacity"):
            mod.consensus_genotypes(a, params[:, :5], **kw)


def _chain_results(n_chains, burn_in=6, steps=24, n=18, m=6, seed=0):
    """Chain results dicts shaped as the runners return them: the initial
    row first, params kept from row burn_in on."""
    out = []
    for c in range(n_chains):
        a, params = _make_trace(seed + c, steps=steps + 1, n=n, m=m)
        rng = np.random.default_rng(100 + c)
        out.append({
            "ML": rng.normal(size=steps + 1),
            "MAP": rng.normal(size=steps + 1),
            "DP_alpha": rng.random(steps + 1), "FN": rng.random(steps + 1),
            "FP": rng.random(steps + 1) * 0.01, "assignments": a,
            "params": params[burn_in:], "burn_in": burn_in,
        })
    data = np.random.default_rng(seed).integers(0, 2, (n, m)).astype(float)
    data[0, 0] = np.nan
    return out, data


def _assert_latents_equal(got, want):
    assert got.keys() == want.keys()
    for key in want:
        if key == "genotypes":
            assert list(got[key].columns) == list(want[key].columns)
            np.testing.assert_allclose(got[key].values, want[key].values,
                                       rtol=1e-6)
        elif key == "assignment":
            np.testing.assert_array_equal(got[key], want[key])
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6)


@pytest.mark.parametrize("est", ["posterior", "ML", "MAP"])
@pytest.mark.parametrize("n_chains,single", [(1, False), (2, False),
                                             (2, True)])
def test_latents_match_jax(est, n_chains, single):
    results, data = _chain_results(n_chains)
    if est == "posterior":
        want = jax_est.latents_posterior(results, data, single)
        got = port_est.latents_posterior(results, data, single, device="cpu")
    else:
        want = jax_est.latents_point(results, est, data, single)
        got = port_est.latents_point(results, est, data, single)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_latents_equal(g, w)


@pytest.mark.parametrize("seed", range(4))
def test_ari_v_measure_match_sklearn(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 80))
    true = rng.integers(0, int(rng.integers(1, 7)), n)
    cases = [rng.integers(0, int(rng.integers(1, 9)), n), true.copy(),
             np.zeros(n, int), np.arange(n), true[::-1].copy()]
    for pred in cases:
        np.testing.assert_allclose(port_est.ari(pred, true),
                                   adjusted_rand_score(true, pred),
                                   rtol=1e-12)
        np.testing.assert_allclose(port_est.v_measure(pred, true),
                                   v_measure_score(true, pred),
                                   rtol=1e-12, atol=1e-15)


def test_hamming_dist_matches_jax():
    a = np.array([[1, 0, 1], [0, 1, 1]])
    sq = np.array([[1, 0], [0, 1]])
    rng = np.random.default_rng(1)
    cont = rng.random((3, 4))
    for pred, true in ((a, a), (a, 1 - a), (sq, sq.T), (a, a.T),
                       (cont, (cont > 0.5).astype(float))):
        assert (port_est.hamming_dist(pred, true)
                == jax_est.hamming_dist(pred, true))
