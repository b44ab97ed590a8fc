"""The port's log prior, term by term, and the public likelihood and
estimator helpers against bnpc_tpu's.

* log_prior_full and its four terms on 200 seeded states at 24 x 12
  (tests/test_torch_batched.py's model), bnpc_tpu's under jax.jit: the
  Gamma alpha, CRP size and truncated-normal terms (short sums whose parts
  can cancel) to 1e-6 of their parts' magnitudes; the Beta log-densities element by element within 4 float32 roundings of
  their parts' magnitudes, and their
  masked sum (up to 288 terms) within the float32 summation bound
  n_terms * eps * sum|terms| of a float64 sum of the same float32 terms,
  for both packages. The whole prior less its Beta sum agrees to 2e-6 of
  its terms' magnitudes, so what separates the two log priors is the
  order in which each sums the Beta terms, not a fault of either.
* ll_row, ll_per_mut_from_stats, crp_new_log_prior, check_beta_params and
  mean_hamming_condensed against their bnpc_tpu counterparts on the same
  inputs (jnp arrays for bnpc_tpu, CPU tensors for the port).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from scipy.special import gammaln

from bnpc_tpu import estimators as jest
from bnpc_tpu.ops import distributions as jdist
from bnpc_tpu.ops import likelihood as jlk
from bnpc_tpu_torch import estimators as port_est
from bnpc_tpu_torch.ops import distributions as tdist
from bnpc_tpu_torch.ops import likelihood as tlk
from tests.torch_parity import configs

torch.set_num_threads(1)

N, M = 24, 12
MODEL = dict(p=0.25, q=0.25, fp=0.01, fn=0.2, learn_errors=True, fp_sd=0.01,
             fn_sd=0.1)
JCFG, TCFG = configs(N, M, N, **MODEL)
EPS32 = float(np.finfo(np.float32).eps)


def _states(count=200, seed=0):
    """(sizes [k] i32, params [k, m] f32, alpha, fp, fn) of `count` random
    states: a few to all slots live, params over (0, 1)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        sizes = rng.integers(0, 6, N).astype(np.int32)
        sizes[rng.random(N) < rng.uniform(0, 0.8)] = 0
        params = rng.uniform(1e-5, 1 - 1e-5, (N, M)).astype(np.float32)
        # alpha above the Gamma prior's loc (1.0 here): in its support.
        alpha, fp, fn = (np.float32(x) for x in (
            JCFG.dp_a_loc + rng.uniform(0.05, 20), rng.uniform(1e-4, 0.05),
            rng.uniform(0.01, 0.5)))
        out.append((sizes, params, alpha, fp, fn))
    return out


def _jax_terms(sizes, params, alpha, fp, fn):
    """bnpc_tpu's log prior and its terms (log_prior_full's own body)."""
    live = sizes > 0
    lpdf = jdist.beta_logpdf(params, JCFG.p, JCFG.q, JCFG.log_beta_norm)
    return {
        "full": jlk.log_prior_full(JCFG, sizes, params, alpha, fp, fn),
        "gamma": jdist.gamma_logpdf_loc(alpha, JCFG.dp_a_shape,
                                        JCFG.dp_a_loc),
        "crp": jnp.sum(jnp.where(live, jlk.crp_size_log_prior(
            jnp.maximum(sizes, 1), float(N), alpha), 0.0)),
        "beta_terms": jnp.where(live[:, None], lpdf, 0.0),
        "beta": jnp.sum(jnp.where(live[:, None], lpdf, 0.0)),
        "truncnorm": jdist.truncnorm_prior_logpdf(fp, JCFG.fp, JCFG.fp_sd)
        + jdist.truncnorm_prior_logpdf(fn, JCFG.fn, JCFG.fn_sd),
    }


def _port_terms(sizes, params, alpha, fp, fn):
    live = sizes > 0
    lpdf = tdist.beta_logpdf(params, TCFG.p, TCFG.q, TCFG.log_beta_norm)
    return {
        "full": tlk.log_prior_full(TCFG, sizes, params, alpha, fp, fn),
        "gamma": tdist.gamma_logpdf_loc(alpha, TCFG.dp_a_shape,
                                        TCFG.dp_a_loc),
        "crp": torch.sum(torch.where(live, tlk.crp_size_log_prior(
            torch.clamp(sizes, min=1), float(N), alpha), 0.0)),
        "beta_terms": torch.where(live[:, None], lpdf, 0.0),
        "beta": torch.sum(torch.where(live[:, None], lpdf, 0.0)),
        "truncnorm": tdist.truncnorm_prior_logpdf(fp, TCFG.fp, TCFG.fp_sd)
        + tdist.truncnorm_prior_logpdf(fn, TCFG.fn, TCFG.fn_sd),
    }


def test_log_prior_terms_match_jax():
    jterms = jax.jit(_jax_terms)
    worst = {"jax": 0.0, "port": 0.0}
    for sizes, params, alpha, fp, fn in _states():
        j = {k: np.asarray(v) for k, v in jterms(
            jnp.asarray(sizes), jnp.asarray(params), jnp.float32(alpha),
            jnp.float32(fp), jnp.float32(fn)).items()}
        t = {k: v.numpy() for k, v in _port_terms(
            torch.from_numpy(sizes), torch.from_numpy(params),
            *(torch.tensor(x) for x in (alpha, fp, fn))).items()}
        # The Gamma, CRP and truncated-normal terms are short float32 sums
        # whose parts can cancel (a term near 0 from parts near 10): the
        # two packages to 1e-6 of the parts' magnitude (the truncated
        # normal's normalizer is below 1 in magnitude here).
        y = np.float64(alpha) - JCFG.dp_a_loc
        parts = {"gamma": [(JCFG.dp_a_shape - 1.0) * np.log(y), -y,
                           -gammaln(JCFG.dp_a_shape)],
                 "crp": [f(x) for x in sizes[sizes > 0] for f in (
                     np.log, lambda _: -np.log(N - 1.0 + np.float64(alpha)))],
                 "truncnorm": [f for x, mean, sd in (
                     (fp, JCFG.fp, JCFG.fp_sd), (fn, JCFG.fn, JCFG.fn_sd))
                     for f in (-0.5 * ((x - mean) / sd) ** 2, -np.log(sd),
                               -0.5 * np.log(2 * np.pi), 1.0)]}
        for k, part in parts.items():
            scale = np.abs(part).sum()
            assert abs(float(t[k]) - float(j[k])) <= 1e-6 * scale, k
        # Element by element within 4 float32 roundings of the magnitude
        # of each term's three parts (they cancel: a relative bar on the
        # term does not apply).
        x = params.astype(np.float64)
        part_scale = (abs(JCFG.p - 1.0) * np.abs(np.log(x))
                      + abs(JCFG.q - 1.0) * np.abs(np.log1p(-x))
                      + abs(JCFG.log_beta_norm))
        assert (np.abs(t["beta_terms"] - j["beta_terms"])
                <= 4 * EPS32 * part_scale).all()
        # The masked Beta sum: each package's float32 sum within the
        # summation bound of the float64 sum of the same float32 terms.
        terms = t["beta_terms"].astype(np.float64)
        exact = terms.sum()
        bound = np.count_nonzero(terms) * EPS32 * np.abs(terms).sum()
        for name, got in (("jax", j["beta"]), ("port", t["beta"])):
            err = abs(float(got) - exact)
            assert err <= bound, (name, err, bound)
            if bound:
                worst[name] = max(worst[name], err / bound)
        # What remains once the Beta sum is taken out agrees to rtol 1e-6.
        rest = sum(np.abs(part).sum() for part in parts.values())
        assert abs(float(t["full"] - t["beta"]) - float(j["full"]
                                                         - j["beta"])) \
            <= 2e-6 * rest
        assert abs(float(t["full"]) - float(j["full"])) <= bound + 2e-6 * rest
    # Both sums sit well inside the bound (the worst case assumes every
    # rounding error adds up).
    assert max(worst.values()) < 0.5, worst


def test_ll_row_matches_jax():
    rng = np.random.default_rng(3)
    xm = (rng.random((N, M)) < 0.4).astype(np.float32)
    xm0 = ((1 - xm) * (rng.random((N, M)) < 0.8)).astype(np.float32)
    theta = rng.uniform(1e-5, 1 - 1e-5, (7, M)).astype(np.float32)
    jc1, jc0 = jlk.log_prob_tables(jnp.asarray(theta), 0.01, 0.2)
    tc1, tc0 = tlk.log_prob_tables(torch.from_numpy(theta),
                                   torch.tensor(0.01), torch.tensor(0.2))
    row = jax.jit(jlk.ll_row)
    for i in (0, 5, N - 1):
        want = np.asarray(row(jnp.asarray(xm[i]), jnp.asarray(xm0[i]), jc1,
                              jc0))
        got = tlk.ll_row(torch.from_numpy(xm[i]), torch.from_numpy(xm0[i]),
                         tc1, tc0).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        n1, n0 = xm[i] * 3.0, xm0[i] * 2.0
        np.testing.assert_allclose(
            tlk.ll_per_mut_from_stats(torch.from_numpy(n1),
                                      torch.from_numpy(n0), tc1[2],
                                      tc0[2]).numpy(),
            np.asarray(jlk.ll_per_mut_from_stats(jnp.asarray(n1),
                                                 jnp.asarray(n0), jc1[2],
                                                 jc0[2])), rtol=1e-6)


def test_crp_new_log_prior_matches_jax():
    for n, alpha in ((24, 0.05), (5000, 1.0), (131072, 37.5)):
        np.testing.assert_allclose(
            tlk.crp_new_log_prior(float(n), torch.tensor(alpha)).numpy(),
            np.asarray(jax.jit(jlk.crp_new_log_prior, static_argnums=0)(
                float(n), jnp.float32(alpha))), rtol=1e-6)


def test_check_beta_params_matches_jax():
    for mean in np.linspace(0.0, 1.0, 11):
        for var in np.linspace(0.0, 0.25, 11):
            assert port_est.check_beta_params(mean, var) \
                == jest.check_beta_params(mean, var)


def test_mean_hamming_condensed_matches_jax():
    rng = np.random.default_rng(4)
    assignments = rng.integers(0, 4, (30, 9)).astype(np.int32)
    want = jest.mean_hamming_condensed(assignments)
    got = port_est.mean_hamming_condensed(assignments, device="cpu")
    assert got.shape == want.shape == (9 * 8 // 2,)
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)
