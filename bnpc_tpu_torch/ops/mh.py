"""Metropolis-Hastings machinery for cluster parameters (counterpart of
bnpc_tpu/ops/mh.py).

Vectorized over leading axes: clusters are conditionally independent given
the assignment, so every slot (or both split-merge launch rows) updates in
one shot; the math per coordinate is the reference's MH_cluster_params
(libs/CRP.py:302-383). Under a chain axis (``ax`` a ChainAxis) the leading
axis is the chains', FP / FN are [C], and the float sums over mutations run
chain by chain.

This torch composition runs on the CPU. On the card both entry points,
``mh_cluster_params`` and ``realized_trans_logprob``, go to one fused kernel
(ops/cuda_mh.py, csrc/mh_sweep.cu), whose plain twins are this composition
on the kernel's inputs: :func:`sweep_on` on the primitives that
``cuda_mh.primitives`` draws, and :func:`realized_sum`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bnpc_tpu_torch.config import TMAX, TMIN, ModelConfig
from bnpc_tpu_torch.ops import cuda_mh
from bnpc_tpu_torch.ops import distributions as dist
from bnpc_tpu_torch.ops import likelihood as lk
from bnpc_tpu_torch.ops import truncnorm
from bnpc_tpu_torch.parallel.axis import MutAxis

_NO_AXIS = MutAxis()

# MH proposal std-dev multiset (libs/CRP.py:65).
PARAM_PROPOSAL_SD = (0.1, 0.25, 0.5)


class MHParamsResult(NamedTuple):
    params: torch.Tensor         # same shape as input
    trans_logprob: torch.Tensor  # [...] sum over mutations (0 if not asked)
    declined: torch.Tensor       # [...] per-row count of declined coordinates


def log_A(new_params, old_params, n1, n0, a, b, std, fp, fn,
          cfg: ModelConfig, clip: bool):
    """MH log-acceptance per coordinate (libs/CRP.py:347-383); the
    likelihood ratio over member cells is n1 * c1(theta) + n0 * c0(theta)."""
    new_p_target = truncnorm.logpdf(new_params, a, b, old_params, std)
    a_rev = (TMIN - new_params) / std
    b_rev = (TMAX - new_params) / std
    old_p_target = truncnorm.logpdf(old_params, a_rev, b_rev, new_params, std)

    c1n, c0n = lk.log_prob_tables(new_params, fp, fn)
    c1o, c0o = lk.log_prob_tables(old_params, fp, fn)
    new_ll = n1 * c1n + n0 * c0n
    old_ll = n1 * c1o + n0 * c0o

    A = new_ll - old_ll + old_p_target - new_p_target
    if not cfg.beta_prior_uniform:
        A = A + dist.beta_logpdf(new_params, cfg.p, cfg.q, 0.0)
        A = A - dist.beta_logpdf(old_params, cfg.p, cfg.q, 0.0)
    if clip:
        A = torch.clamp(A, max=0.0)
    return A


def draw_proposal_std(draws, shape):
    """Per-coordinate std drawn from {0.1, 0.25, 0.5} (libs/CRP.py:328)."""
    return choose(draws.randint(shape, 0, len(PARAM_PROPOSAL_SD)),
                  PARAM_PROPOSAL_SD)


def choose(idx, values):
    """values[idx] for a small tuple of float32 constants, by selection (no
    device copy of the table)."""
    out = torch.full(idx.shape, float(values[-1]), dtype=torch.float32,
                     device=idx.device)
    for i in range(len(values) - 2, -1, -1):
        out = torch.where(idx == i, float(values[i]), out)
    return out


def mh_cluster_params(draws, params, n1, n0, fp, fn, cfg: ModelConfig,
                      trans_prob: bool = False,
                      ax: MutAxis = _NO_AXIS) -> MHParamsResult:
    """One truncated-normal random-walk MH sweep over every coordinate
    (MH_cluster_params, libs/CRP.py:314-344). With ``trans_prob`` also the
    summed log transition probability of the realized move: accepted
    coordinates contribute min(A, 0), declined ones log(1 - e^A). Under
    mutation sharding every draw is the shard's own, and the counts and
    sums are over the real columns of every shard.

    On the CPU the torch composition below runs; a tensor on another
    device goes to the fused kernel (ops/cuda_mh.py) on the same primitives,
    drawn in the same order, or raises where it cannot."""
    draws = ax.fold_key(draws)
    shape = tuple(params.shape)
    if params.device.type != "cpu":
        prims = cuda_mh.primitives(draws, shape, len(PARAM_PROPOSAL_SD))
        new_params, trans, declined = cuda_mh.mh_sweep(
            params.contiguous(), n1.contiguous(), n0.contiguous(), fp, fn,
            *prims, cfg, trans_prob, ax.mask)
        return MHParamsResult(new_params,
                              ax.psum(trans) if trans_prob else trans,
                              ax.psum(declined))
    k_std, k_prop, k_u = draws.split(3)
    std = draw_proposal_std(k_std, shape)
    a = (TMIN - params) / std
    b = (TMAX - params) / std
    proposal = k_prop.truncnorm(a, b, params, std).to(torch.float32)
    return mh_accept(params, proposal, a, b, std, k_u.uniform(shape), n1, n0,
                     fp, fn, cfg, trans_prob, ax)


def sweep_on(params, n1, n0, fp, fn, std_idx, u_prop, u, cfg: ModelConfig,
             trans_prob: bool, ax: MutAxis = _NO_AXIS) -> MHParamsResult:
    """:func:`mh_cluster_params`' composition on drawn primitives (the std
    index, the proposal's uniform, the acceptance uniform; what
    ``cuda_mh.primitives`` draws): the fused kernel's plain twin."""
    std = choose(std_idx, PARAM_PROPOSAL_SD)
    a = (TMIN - params) / std
    b = (TMAX - params) / std
    proposal = truncnorm.from_uniform(u_prop, a, b, params, std)
    return mh_accept(params, proposal, a, b, std, u, n1, n0, fp, fn, cfg,
                     trans_prob, ax)


def mh_accept(params, proposal, a, b, std, u, n1, n0, fp, fn,
              cfg: ModelConfig, trans_prob: bool,
              ax: MutAxis = _NO_AXIS) -> MHParamsResult:
    """The accept step of :func:`mh_cluster_params` for a drawn `proposal`
    (bounds `a`, `b`, `std`) and acceptance uniforms `u`."""
    A = log_A(proposal, params, n1, n0, a, b, std, fp, fn, cfg,
              clip=trans_prob)
    log_u = torch.log(u)
    decline = log_u >= A

    new_params = torch.where(decline, params, proposal)
    declined = ax.psum(ax.apply_mask(decline.to(torch.float32))
                       .sum(dim=-1)).to(torch.int32)

    if trans_prob:
        # The min(A, -1e-10) clamp (bnpc_tpu/ops/mh.py) keeps a declined
        # coordinate's log(1 - e^A) finite when A rounds to 0.
        contrib = torch.where(
            decline, torch.log(-torch.expm1(torch.clamp(A, max=-1e-10))), A)
        trans = ax.psum(ax.sum(ax.apply_mask(contrib), dim=-1))
    else:
        trans = torch.zeros(params.shape[:-1], dtype=params.dtype,
                            device=params.device)
    return MHParamsResult(new_params, trans, declined)


def realized_trans_logprob(target, source, n1, n0, a, b, std, fp, fn,
                           cfg: ModelConfig, ax: MutAxis = _NO_AXIS):
    """Summed log transition probability of an MH sweep moving `source` ->
    `target`, every coordinate treated as accepted (the split-merge reverse
    paths, libs/CRP.py:668-682, 777-797). Off the CPU, the fused kernel's
    realized mode (ops/cuda_mh.py)."""
    if target.device.type != "cpu":
        return ax.psum(cuda_mh.realized(
            *(t.contiguous() for t in (target, source, n1, n0, a, b, std)),
            fp, fn, cfg, ax.mask))
    return realized_sum(target, source, n1, n0, a, b, std, fp, fn, cfg, ax)


def realized_sum(target, source, n1, n0, a, b, std, fp, fn,
                 cfg: ModelConfig, ax: MutAxis = _NO_AXIS):
    """The torch composition of :func:`realized_trans_logprob`."""
    A = log_A(target, source, n1, n0, a, b, std, fp, fn, cfg, clip=True)
    return ax.psum(ax.sum(ax.apply_mask(A), dim=-1))
