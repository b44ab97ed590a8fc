"""Truncated-normal sampling and log-density (counterpart of
bnpc_tpu/ops/truncnorm.py).

Bounds ``a``/``b`` are in standardized units, as in scipy: the support is
[loc + a*scale, loc + b*scale]. Used by the random-walk proposals of cluster
parameters (libs/CRP.py:314-357) and error rates
(libs/CRP_learning_errors.py:66-91). Elementwise: a leading chain axis
(mcmc.py's chain_exec="vmap") passes through.
"""

from __future__ import annotations

import torch
from torch.special import log_ndtr, ndtr, ndtri

_HALF_LOG_2PI = 0.9189385332046727


def _log_gauss_mass(a, b):
    """log(Phi(b) - Phi(a)), numerically stable for either-sided intervals."""
    # Work in the left tail: if the interval lies in the right half, mirror it.
    flip = a > 0
    a_ = torch.where(flip, -b, a)
    b_ = torch.where(flip, -a, b)
    la, lb = log_ndtr(a_), log_ndtr(b_)
    # log(e^lb - e^la) = lb + log1p(-e^(la - lb))
    return lb + torch.log1p(-torch.exp(torch.clamp(la - lb, max=-1e-12)))


def logpdf(x, a, b, loc, scale):
    """Elementwise truncnorm.logpdf(x, a, b, loc, scale)."""
    scale = torch.as_tensor(scale, dtype=torch.float32)
    z = (x - loc) / scale
    return (-0.5 * z * z - _HALF_LOG_2PI - torch.log(scale)
            - _log_gauss_mass(a, b))


def rvs(draws, a, b, loc, scale):
    """Truncated-normal variates by inverse CDF (tensor arguments): one
    uniform an element from `draws`, then :func:`from_uniform`."""
    a, b, loc, scale = torch.broadcast_tensors(a, b, loc, scale)
    return from_uniform(draws.uniform(a.shape), a, b, loc, scale)


def from_uniform(u, a, b, loc, scale):
    """The inverse-CDF variates of uniforms `u` (every argument of one
    shape). Probabilities are clamped to [1e-12, 1 - 1e-12], whose upper
    end is 1.0 in float32: an ndtri of inf there ends at the interval's
    upper bound."""
    pa, pb = ndtr(a), ndtr(b)
    p = torch.clamp(pa + u * (pb - pa), 1e-12, 1.0 - 1e-12)
    x = loc + scale * ndtri(p)
    # Keep draws strictly inside the truncation interval.
    return torch.minimum(torch.maximum(x, loc + a * scale), loc + b * scale)
