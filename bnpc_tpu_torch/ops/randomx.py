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

On the card, state.py::beta_posterior_params runs :func:`beta_general` as
one fused kernel (ops/cuda_beta.py, csrc/beta_post.cu) on the 26 primitive
draws that ``cuda_beta.primitives`` takes in this composition's order; its
plain twin is :func:`beta_general_on`, this arithmetic on those draws.
"""

from __future__ import annotations

import torch

DEFAULT_ROUNDS = 4
# mt_gamma_boosted's rounds; its primitive draws (a normal and a uniform a
# round, then the boost's uniform) and beta_general's (both gammas').
BOOST_ROUNDS = 6
GAMMA_PRIMITIVES = 2 * BOOST_ROUNDS + 1
BETA_PRIMITIVES = 2 * GAMMA_PRIMITIVES


def _mt_round(d, c, x, u, g, accepted):
    """One Marsaglia-Tsang round on a drawn normal `x` and uniform `u`: g
    takes d * v where this round is the first to accept. Returns (g,
    accepted)."""
    v = (1.0 + c * x) ** 3
    ok = (v > 0.0) & (
        torch.log(u)
        < 0.5 * x * x + d - d * v
        + d * torch.log(torch.where(v > 0, v, torch.ones_like(v)))
    )
    return torch.where(~accepted & ok, d * v, g), accepted | ok


def _mt_rounds(draws, d, c, shape, rounds: int):
    g = torch.broadcast_to(draws.full(d), shape).clone()
    accepted = torch.zeros(shape, dtype=torch.bool, device=draws.device)
    for _ in range(rounds):
        kx, ku, draws = draws.split(3)
        x = kx.normal(shape)
        u = ku.uniform(shape)
        g, accepted = _mt_round(d, c, x, u, g, accepted)
    return g


def mt_gamma(draws, shape_param: float, shape, rounds: int = DEFAULT_ROUNDS):
    """Gamma(shape_param) for a scalar shape_param > 1/3."""
    d = shape_param - 1.0 / 3.0
    c = 1.0 / (9.0 * d) ** 0.5
    return _mt_rounds(draws, d, c, tuple(shape), rounds)


def _boost_scale(a):
    """(d, c) of Marsaglia-Tsang at shape a + 1."""
    d = a + 1.0 - 1.0 / 3.0
    return d, 1.0 / torch.sqrt(9.0 * d)


def mt_gamma_boosted(draws, a, rounds: int = BOOST_ROUNDS):
    """Gamma(a) for array-valued a > 0: Marsaglia-Tsang at shape a+1, then
    the boost Gamma(a) = Gamma(a+1) * U^(1/a)."""
    a = draws.full(a)
    d, c = _boost_scale(a)
    k_boost, draws = draws.split(2)
    g = _mt_rounds(draws, d, c, a.shape, rounds)
    return g * k_boost.uniform(a.shape) ** (1.0 / a)


def _beta_of(ga, gb):
    denom = ga + gb
    return torch.where(denom > 0.0, ga / denom, 0.5)


def beta_general(draws, a, b):
    """Exact Beta(a, b) for array-valued parameters via two boosted gammas."""
    k_a, k_b = draws.split(2)
    ga = mt_gamma_boosted(k_a, a)
    gb = mt_gamma_boosted(k_b, b)
    return _beta_of(ga, gb)


def _boosted_on(a, prims):
    """mt_gamma_boosted's arithmetic on its GAMMA_PRIMITIVES drawn
    primitives: (normal, uniform) a round, then the boost's uniform."""
    d, c = _boost_scale(a)
    g, accepted = d, torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    for r in range(BOOST_ROUNDS):
        g, accepted = _mt_round(d, c, prims[2 * r], prims[2 * r + 1], g,
                                accepted)
    return g * prims[2 * BOOST_ROUNDS] ** (1.0 / a)


def beta_general_on(prims, a, b):
    """:func:`beta_general`'s arithmetic on its BETA_PRIMITIVES drawn
    primitives (what ops/cuda_beta.py::primitives draws, each of a's
    shape): the fused kernel's plain twin."""
    return _beta_of(_boosted_on(a, prims[:GAMMA_PRIMITIVES]),
                    _boosted_on(b, prims[GAMMA_PRIMITIVES:]))


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
    return _beta_of(ga, gb)
