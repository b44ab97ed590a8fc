"""Small log-density helpers shared by the samplers (counterpart of
bnpc_tpu/ops/distributions.py).

Constants enter as 0-d CPU tensors: torch reads them on the host as
scalars, where a CUDA tensor built from a Python number would be a blocking
host-to-device copy. Elementwise: a leading chain axis passes through.
"""

from __future__ import annotations

import torch

from bnpc_tpu_torch.ops import truncnorm


def gamma_logpdf_loc(x, shape: float, loc: float, scale: float = 1.0):
    """Density of ``loc + Gamma(shape, scale)``: the reference binds its
    alpha prior ``scipy.stats.gamma(a, b)`` with ``b`` as loc
    (libs/CRP.py:55). Reproduced exactly."""
    y = (x - loc) / scale
    lg = torch.lgamma(torch.tensor(shape, dtype=torch.float32))
    return torch.where(
        y > 0,
        (shape - 1.0) * torch.log(torch.clamp(y, min=1e-300)) - y - lg
        - torch.log(torch.tensor(scale, dtype=torch.float32)),
        -torch.inf,
    )


def beta_logpdf(x, p: float, q: float, log_beta_norm: float):
    return (p - 1.0) * torch.log(x) + (q - 1.0) * torch.log1p(-x) \
        - log_beta_norm


def truncnorm_prior_logpdf(x, mean: float, sd: float):
    """Truncated-normal prior on [0, 1] of the FP/FN rates
    (libs/CRP_learning_errors.py:22-32)."""
    a = torch.tensor((0.0 - mean) / sd, dtype=torch.float32)
    b = torch.tensor((1.0 - mean) / sd, dtype=torch.float32)
    return truncnorm.logpdf(x, a, b, mean, sd)
