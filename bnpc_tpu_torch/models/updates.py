"""Non-assignment moves: parameter MH, alpha resampling, error-rate MH
(counterpart of bnpc_tpu/models/updates.py). All three run against the
per-cluster sufficient statistics, so they cost O(k_max * m).

Each also takes a batch of chains (a state with a leading chain axis,
StackedDraws, ``ax`` a ChainAxis): every chain draws what its one-chain
move draws and keeps its own accept flags and counts.
"""

from __future__ import annotations

import torch

from bnpc_tpu_torch.config import EPSILON, ModelConfig
from bnpc_tpu_torch.draws import Draws
from bnpc_tpu_torch.ops import cuda_error_mh
from bnpc_tpu_torch.ops import distributions as dist
from bnpc_tpu_torch.ops import likelihood as lk
from bnpc_tpu_torch.ops import mh
from bnpc_tpu_torch.ops import truncnorm
from bnpc_tpu_torch.parallel.axis import MutAxis
from bnpc_tpu_torch.state import CRPState

_NO_AXIS = MutAxis()


def update_parameters(draws: Draws, state: CRPState, n1, n0,
                      cfg: ModelConfig, ax: MutAxis = _NO_AXIS):
    """MH-update every live cluster's parameter row at once
    (update_parameters, libs/CRP.py:302-311). Returns (state, declined,
    accepted), counted over live slots and real mutation columns only."""
    live = state.cluster_size > 0
    res = mh.mh_cluster_params(draws, state.params, n1, n0, state.fp,
                               state.fn, cfg, ax=ax)
    params = torch.where(live[..., None], res.params, state.params)
    declined = torch.where(live, res.declined, 0).sum(-1)
    # Under padded sharding cfg.n_muts counts the padded columns: the real
    # ones are the psummed shard masks (bnpc_tpu updates.py:40-45).
    m_real = (ax.psum(ax.mask.sum()).to(torch.int32) if ax.mask is not None
              else cfg.n_muts)
    accepted = live.sum(-1) * m_real - declined
    return state._replace(params=params), declined, accepted


def update_dp_alpha(draws: Draws, state: CRPState,
                    cfg: ModelConfig) -> CRPState:
    """Escobar & West (1995) auxiliary-variable resampling of alpha
    (update_DP_alpha, libs/CRP.py:386-410), with both reference quirks: the
    Gamma draw treats ``b - log(eta)`` as the numpy SCALE parameter
    (libs/CRP.py:401-407), and the result is clamped to >= 1 + eps
    (libs/CRP.py:409)."""
    k_eta, k_pi, k_gamma = draws.split(3)
    n = float(cfg.n_cells)
    k = state.n_clusters.to(torch.float32)
    a_g, b_g = cfg.dp_a_shape, cfg.dp_a_loc

    eta = k_eta.beta(state.dp_alpha + 1.0, n)
    log_eta = torch.log(eta)
    w = (a_g + k - 1.0) / (n * (b_g - log_eta))
    pi_eta = w / (1.0 + w)

    use_high = k_pi.uniform(k.shape) < pi_eta
    shape = a_g + k - torch.where(use_high, 0.0, 1.0)
    new_alpha = k_gamma.gamma(shape) * (b_g - log_eta)
    alpha = torch.clamp(new_alpha, min=1.0 + EPSILON).to(torch.float32)
    return state._replace(dp_alpha=alpha)


def _full_ll_at_rates(params, n1, n0, fp, fn, ax: MutAxis = _NO_AXIS):
    c1, c0 = lk.log_prob_tables(params, fp, fn)
    return lk.ll_from_stats(n1, n0, c1, c0, ax)


def _mh_error_rate(draws: Draws, old, prior_mean: float, prior_sd: float,
                   ll_fn):
    """Single scalar truncated-normal MH step
    (libs/CRP_learning_errors.py:66-111). Returns (new rate, accepted, the
    likelihood at the new rate)."""
    k_std, k_prop, k_u = draws.split(3)
    std = mh.choose(k_std.randint(old.shape, 0, 3),
                    cuda_error_mh.proposal_sds(prior_sd))
    a = (0.0 - old) / std
    b = (1.0 - old) / std
    new = k_prop.truncnorm(a, b, old, std)
    return _mh_accept(old, new, a, b, std, k_u.uniform(old.shape),
                      ll_fn(new), ll_fn(old), prior_mean, prior_sd)


def _mh_accept(old, new, a, b, std, u, ll_new, ll_old, prior_mean: float,
               prior_sd: float):
    """The acceptance of :func:`_mh_error_rate` for a drawn proposal `new`
    (bounds `a`, `b`, `std`), its acceptance uniform `u` and the
    likelihoods at `new` and `old`."""
    new_p_target = truncnorm.logpdf(new, a, b, old, std)
    a_rev = (0.0 - new) / std
    b_rev = (1.0 - new) / std
    old_p_target = truncnorm.logpdf(old, a_rev, b_rev, new, std)

    A = (ll_new - ll_old
         + dist.truncnorm_prior_logpdf(new, prior_mean, prior_sd)
         - dist.truncnorm_prior_logpdf(old, prior_mean, prior_sd)
         + old_p_target - new_p_target)
    accept = torch.log(u) < A
    return (torch.where(accept, new, old).to(torch.float32), accept,
            torch.where(accept, ll_new, ll_old))


def update_error_rates(draws: Draws, state: CRPState, n1, n0,
                       cfg: ModelConfig, ax: MutAxis = _NO_AXIS):
    """MH on FP then FN (libs/CRP_learning_errors.py:52-55; FN's likelihood
    sees the freshly updated FP). Returns (state, fp_acc, fn_acc, ll), `ll`
    the log-likelihood at the new rates: the step's trace ML, the same
    expression on the same values as summarize's.

    On the CPU the torch composition below runs; a tensor on another device
    goes to the fused kernel (ops/cuda_error_mh.py) on the same six
    primitives, drawn in the same order, or raises where it cannot."""
    if cuda_error_mh.fits(state.fp.device):
        prims = cuda_error_mh.primitives(draws, state.fp.shape)
        fp, fn, fp_acc, fn_acc, ll = cuda_error_mh.error_mh(
            state.params.contiguous(), n1.contiguous(), n0.contiguous(),
            state.fp, state.fn, prims, cfg, ax)
        return state._replace(fp=fp, fn=fn), fp_acc, fn_acc, ll
    k_fp, k_fn = draws.split(2)
    fp, fp_acc, _ = _mh_error_rate(
        k_fp, state.fp, cfg.fp, cfg.fp_sd,
        lambda e: _full_ll_at_rates(state.params, n1, n0, e, state.fn, ax))
    fn, fn_acc, ll = _mh_error_rate(
        k_fn, state.fn, cfg.fn, cfg.fn_sd,
        lambda e: _full_ll_at_rates(state.params, n1, n0, fp, e, ax))
    return state._replace(fp=fp, fn=fn), fp_acc, fn_acc, ll


def _mh_on(idx, u_prop, u, old, prior_mean: float, prior_sd: float, ll_fn,
           ll_old=None):
    """:func:`_mh_error_rate` on its drawn primitives; `ll_old`, when
    given, is the likelihood at `old`."""
    std = mh.choose(idx, cuda_error_mh.proposal_sds(prior_sd))
    a = (0.0 - old) / std
    b = (1.0 - old) / std
    new = truncnorm.from_uniform(u_prop, a, b, old, std)
    return _mh_accept(old, new, a, b, std, u, ll_fn(new),
                      ll_fn(old) if ll_old is None else ll_old, prior_mean,
                      prior_sd)


def error_rates_on(params, n1, n0, fp, fn, prims, cfg: ModelConfig,
                   ax: MutAxis = _NO_AXIS):
    """:func:`update_error_rates`' composition on its six drawn primitives
    (``cuda_error_mh.primitives``), FN's old likelihood taken from FP's
    chosen one as the kernel takes it: the kernel's plain twin. Returns
    (fp, fn, fp_acc, fn_acc, ll), what ``cuda_error_mh.error_mh``
    returns."""
    fp_new, fp_acc, ll = _mh_on(
        *prims[:3], fp, cfg.fp, cfg.fp_sd,
        lambda e: _full_ll_at_rates(params, n1, n0, e, fn, ax))
    fn_new, fn_acc, ll = _mh_on(
        *prims[3:], fn, cfg.fn, cfg.fn_sd,
        lambda e: _full_ll_at_rates(params, n1, n0, fp_new, e, ax), ll)
    return fp_new, fn_new, fp_acc, fn_acc, ll
