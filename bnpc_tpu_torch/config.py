"""Static model / MCMC configuration (counterpart of bnpc_tpu/config.py).

Frozen dataclasses: everything the reference keeps as Python object state
(libs/CRP.py:27-65, libs/MCMC.py:27-50) that never changes during sampling.
The mutable sampler state lives in :class:`bnpc_tpu_torch.state.CRPState`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
from scipy.special import gammaln as _gammaln

# Numerical constants mirrored from the reference (libs/CRP.py:10-14).
EPSILON = float(np.finfo(np.float64).resolution)  # 1e-15
TMIN = 1e-5
TMAX = 1.0 - TMIN


def _log_beta_fn(p: float, q: float) -> float:
    return float(_gammaln(p) + _gammaln(q) - _gammaln(p + q))


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static description of the DPMM (see bnpc_tpu.config.ModelConfig).

    k_max is the cluster-slot capacity; slot-axis randomness is drawn at
    k_max (the JAX package's k_rng served only its retired k-bucket).
    dp_a_shape / dp_a_loc bind the reference's Gamma(a, loc=b) alpha prior
    quirk (libs/CRP.py:55).
    """

    n_cells: int
    n_muts: int
    k_max: int
    p: float = 1.0
    q: float = 1.0
    dp_a_shape: float = -1.0
    dp_a_loc: float = -1.0
    fp: float = EPSILON
    fn: float = EPSILON
    learn_errors: bool = False
    fp_sd: float = 0.0005
    fn_sd: float = 0.05

    def __post_init__(self):
        if self.dp_a_shape < 0 or self.dp_a_loc < 0:
            # Reference default: Gamma(sqrt(n), 1) (libs/CRP.py:51-52).
            object.__setattr__(self, "dp_a_shape", math.sqrt(self.n_cells))
            object.__setattr__(self, "dp_a_loc", 1.0)
        if not (0 < self.k_max <= self.n_cells):
            raise ValueError(
                f"k_max must be in (0, n_cells]; got {self.k_max} for "
                f"n={self.n_cells}"
            )

    @property
    def beta_prior_uniform(self) -> bool:
        # libs/CRP.py:37-40
        return self.p == 1.0 and self.q == 1.0

    @property
    def log_beta_norm(self) -> float:
        """log B(p, q), the Beta prior normalizer."""
        return _log_beta_fn(self.p, self.q)

    @property
    def beta_mix(self) -> tuple[float, float]:
        """Normalized (mix0, mix1) = (B(p, q+1), B(p+1, q)) / sum
        (libs/CRP.py:42-44)."""
        l0 = _log_beta_fn(self.p, self.q + 1.0)
        l1 = _log_beta_fn(self.p + 1.0, self.q)
        hi = max(l0, l1)
        e0, e1 = math.exp(l0 - hi), math.exp(l1 - hi)
        s = e0 + e1
        return (e0 / s, e1 / s)

    @property
    def dp_a_init(self) -> float:
        """Initial alpha = prior mean = shape + loc (libs/CRP.py:56)."""
        return self.dp_a_shape + self.dp_a_loc


@dataclasses.dataclass(frozen=True)
class MCMCConfig:
    """Move-mixture probabilities and split-merge settings
    (libs/MCMC.py:27-50 / run_BnpC.py:125-148 defaults)."""

    sm_prob: float = 0.33
    dpa_prob: float = 0.5
    error_prob: float = 0.1
    sm_split_ratio: float = 0.75
    sm_steps: int = 5
    fix_assign: bool = False
    # Cluster rows of the parameter trace kept per recorded step
    # (0 -> min(k_max, 128)).
    trace_k: int = 0
    # Opt-in APPROXIMATE blocked Gibbs sweep (models/gibbs._blocked_impl):
    # 0 = the exact sweep; N > 0 = N cells decide a block against frozen
    # sizes, birth blocks replayed exactly. Deviates from the reference.
    gibbs_block: int = 0
    # One move-type selection per step shared by every chain (the moves'
    # own randomness stays per chain); chains are then no longer
    # independent processes. Opt-in; honoured whenever n_chains > 1.
    coupled_moves: bool = False
