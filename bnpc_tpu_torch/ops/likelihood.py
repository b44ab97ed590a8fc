"""Bernoulli-mixture likelihood as log-probability tables (counterpart of
bnpc_tpu/ops/likelihood.py).

Because x is binary, the per-(cluster, mutation) log term of the reference
(libs/CRP.py:197-213) takes two values,

    c1[k,j] = log(theta*(1-FN) + (1-theta)*FP)      # x == 1
    c0[k,j] = log(theta*FN     + (1-theta)*(1-FP))  # x == 0

so the cells x clusters log-likelihood is ``xm @ c1.T + xm0 @ c0.T`` and all
likelihood sums over cells reduce to the sufficient statistics (N1, N0).
The products are plain float32 torch matmuls (TF32 is off, see __init__).
Under mutation sharding every sum over mutations is all-reduced over the
mutation group (``ax``, parallel/axis.py); the per-cell counts rs1 / rs0 of
new_cluster_ll are whole-row counts, replicated on every rank, and take no
all-reduce.

Every function also takes a batch of chains (mcmc.py's chain_exec="vmap"):
params and sufficient statistics with a leading chain axis, FP / FN /
alpha of shape [C], and ``ax`` a ChainAxis, whose sums and products run
chain by chain with the one-chain calls (parallel/axis.py).
"""

from __future__ import annotations

import torch

from bnpc_tpu_torch.config import ModelConfig
from bnpc_tpu_torch.data import PackedData
from bnpc_tpu_torch.ops import distributions as dist
from bnpc_tpu_torch.parallel.axis import MutAxis

_NO_AXIS = MutAxis()


def per_row(x, like):
    """A per-chain value `x` ([C], or 0-d for one chain) shaped to
    broadcast against `like` ([C, ...]) — a view with trailing unit axes."""
    return x.reshape(tuple(x.shape) + (1,) * (like.dim() - x.dim()))


def log_prob_tables(params, fp, fn):
    """(c1, c0) tables for parameter array `params` (any shape; under a
    chain axis fp / fn are [C] and params lead with it)."""
    fp, fn = per_row(fp, params), per_row(fn, params)
    c1 = torch.log(params * (1.0 - fn) + (1.0 - params) * fp)
    c0 = torch.log(params * fn + (1.0 - params) * (1.0 - fp))
    return c1, c0


def ll_matrix(data: PackedData, c1, c0, ax: MutAxis = _NO_AXIS):
    """[n, k] log-likelihood of every cell under every row's tables: one
    product over the concatenated indicator planes."""
    xcat = torch.cat([data.xm, data.xm0], dim=1)
    ccat = torch.cat([c1, c0], dim=-1)
    return ax.psum(ax.rmul(xcat, ccat.mT))


def ll_col(c1_row, c0_row, xm, xm0, ax: MutAxis = _NO_AXIS):
    """[n] log-likelihood of every cell under one parameter row's tables."""
    return ax.psum(ax.rmul(xm, c1_row) + ax.rmul(xm0, c0_row))


def ll_from_stats(n1, n0, c1, c0, ax: MutAxis = _NO_AXIS):
    """Total log-likelihood from per-slot sufficient statistics
    (get_ll_full, libs/CRP.py:237-238); free slots have zero statistics."""
    return ax.psum(ax.sum(n1 * c1 + n0 * c0))


def new_cluster_ll(data: PackedData, cfg: ModelConfig, fp, fn):
    """[n] prior-predictive log-likelihood of each cell opening a new
    cluster (libs/CRP.py:230-234, without the CRP prior term)."""
    mix0, mix1 = cfg.beta_mix
    d1 = torch.log(mix1 * (1.0 - fn) + mix0 * fp)
    d0 = torch.log(mix1 * fn + mix0 * (1.0 - fp))
    return data.rs1 * d1[..., None] + data.rs0 * d0[..., None]


def crp_size_log_prior(size, n: float, alpha):
    """log CRP weight of joining a cluster of `size` (libs/CRP.py:83-85)."""
    return torch.log(size.to(torch.float32)) - torch.log(n - 1.0 + alpha)


def log_prior_full(cfg: ModelConfig, cluster_size, params, dp_alpha, fp, fn,
                   ax: MutAxis = _NO_AXIS):
    """Joint log-prior (get_lprior_full, libs/CRP.py:241-251, and the
    learning-model override libs/CRP_learning_errors.py:47-49)."""
    live = cluster_size > 0
    n = float(cfg.n_cells)
    lp = dist.gamma_logpdf_loc(dp_alpha, cfg.dp_a_shape, cfg.dp_a_loc)
    lp = lp + ax.sum(torch.where(
        live, crp_size_log_prior(torch.clamp(cluster_size, min=1), n,
                                 dp_alpha[..., None]), 0.0))
    if not cfg.beta_prior_uniform:
        lpdf = ax.apply_mask(
            dist.beta_logpdf(params, cfg.p, cfg.q, cfg.log_beta_norm))
        lp = lp + ax.psum(ax.sum(torch.where(live[..., None], lpdf, 0.0)))
    if cfg.learn_errors:
        lp = lp + dist.truncnorm_prior_logpdf(fp, cfg.fp, cfg.fp_sd)
        lp = lp + dist.truncnorm_prior_logpdf(fn, cfg.fn, cfg.fn_sd)
    return lp
