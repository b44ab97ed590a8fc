"""Fixed-round exact samplers specialized to this model (counterpart of
bnpc_tpu/ops/randomx.py).

The model only ever needs Beta(p + x, q + x0) with BINARY x/x0, i.e. per
element one of three fixed parameter pairs, which admits a branch-free
sampler:

  * Gamma(k) for k = p+1, q+1 via Marsaglia-Tsang (2000), vectorized over a
    FIXED number of rejection rounds with first-accept semantics;
  * the small-shape boost Gamma(a) =d Gamma(a+1) * U^(1/a), applied only
    where the data bit is 0;
  * Beta(a, b) = Ga / (Ga + Gb).

A never-accepted element falls back to the mode scale d, with probability
<= 0.05^rounds per component (bnpc_tpu/ops/randomx.py bounds the effect).
Every draw comes from a :class:`bnpc_tpu_torch.draws.TorchDraws`, or, for a
batch of chains on the card, from a StackedDraws of them: the shapes then
lead with the chains, and the arithmetic is elementwise, so chain c's
slice is its one-chain draw.
"""

from __future__ import annotations

import torch

DEFAULT_ROUNDS = 4


def _mt_rounds(draws, d, c, shape, rounds: int):
    g = torch.broadcast_to(draws.full(d), shape).clone()
    accepted = torch.zeros(shape, dtype=torch.bool, device=draws.device)
    for _ in range(rounds):
        kx, ku, draws = draws.split(3)
        x = kx.normal(shape)
        v = (1.0 + c * x) ** 3
        u = ku.uniform(shape)
        ok = (v > 0.0) & (
            torch.log(u)
            < 0.5 * x * x + d - d * v
            + d * torch.log(torch.where(v > 0, v, torch.ones_like(v)))
        )
        g = torch.where(~accepted & ok, d * v, g)
        accepted |= ok
    return g


def mt_gamma(draws, shape_param: float, shape, rounds: int = DEFAULT_ROUNDS):
    """Gamma(shape_param) for a scalar shape_param > 1/3."""
    d = shape_param - 1.0 / 3.0
    c = 1.0 / (9.0 * d) ** 0.5
    return _mt_rounds(draws, d, c, tuple(shape), rounds)


def mt_gamma_boosted(draws, a, rounds: int = 6):
    """Gamma(a) for array-valued a > 0: Marsaglia-Tsang at shape a+1, then
    the boost Gamma(a) = Gamma(a+1) * U^(1/a)."""
    a = draws.full(a)
    d = a + 1.0 - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    k_boost, draws = draws.split(2)
    g = _mt_rounds(draws, d, c, a.shape, rounds)
    return g * k_boost.uniform(a.shape) ** (1.0 / a)


def beta_general(draws, a, b):
    """Exact Beta(a, b) for array-valued parameters via two boosted gammas."""
    k_a, k_b = draws.split(2)
    ga = mt_gamma_boosted(k_a, a)
    gb = mt_gamma_boosted(k_b, b)
    denom = ga + gb
    return torch.where(denom > 0.0, ga / denom, 0.5)


def beta_binary(draws, p: float, q: float, xm, xm0):
    """Exact Beta(p + xm, q + xm0) field for binary xm/xm0 planes (the
    reference's newborn row np.random.beta(p + x, q + x0),
    libs/CRP.py:183-188)."""
    k_a, k_b, k_ua, k_ub = draws.split(4)
    shape = tuple(xm.shape)
    ga1 = mt_gamma(k_a, p + 1.0, shape)
    gb1 = mt_gamma(k_b, q + 1.0, shape)
    ua = k_ua.uniform(shape)
    ub = k_ub.uniform(shape)
    ga = ga1 * torch.where(xm == 1.0, 1.0, ua ** (1.0 / p))
    gb = gb1 * torch.where(xm0 == 1.0, 1.0, ub ** (1.0 / q))
    denom = ga + gb
    return torch.where(denom > 0.0, ga / denom, 0.5)
