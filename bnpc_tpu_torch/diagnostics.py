"""Convergence diagnostics: lugsail batch-means PSRF (Vats & Knudson 2018)
(counterpart of bnpc_tpu/diagnostics.py; reference libs/utils.py:427-472).

Host-side numpy: the inputs are short scalar traces gathered from the
chains; there is nothing for the device to do here.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.special import gamma as _gamma
from scipy.stats import chi2


def _tau_lugsail(b: int, data: np.ndarray, chain_mean: float) -> float:
    """Batch-means variance estimate with batch size b (libs/utils.py:464-467)."""
    a = data.size // b
    batch_mean = np.mean(np.reshape(data[: a * b], (a, b)), axis=1)
    return (b / (a - 1)) * float(np.sum(np.square(batch_mean - chain_mean)))


def lugsail_psrf(data_in, steps=None) -> float:
    """Pooled lugsail PSRF over chains.

    Args:
      data_in: iterable of (trace, burn_in) pairs per chain.
      steps: optional truncation index applied after burn-in.

    Returns inf when any chain has fewer than 9 usable samples or the pooled
    variance degenerates (libs/utils.py:427-461).
    """
    t_il, s_i, n_i = [], [], []
    for trace, burn_in in data_in:
        data = np.asarray(trace)[int(burn_in):steps]
        if data.size < 9:  # b // 3 would be 0
            return np.inf
        n_ii = data.size
        b = int(n_ii ** 0.5)
        n_i.append(n_ii)
        chain_mean = float(np.mean(data))
        t_il.append(
            2.0 * _tau_lugsail(b, data, chain_mean)
            - _tau_lugsail(b // 3, data, chain_mean)
        )
        s_i.append(float(np.var(data, ddof=1)))

    t_l = float(np.mean(t_il))
    s = float(np.mean(s_i))
    n = float(np.round(np.mean(n_i)))
    sigma_l = ((n - 1.0) * s + t_l) / n
    if s <= 0 or sigma_l / s < 0:
        return np.inf
    return math.sqrt(sigma_l / s)


def lugsail_cutoff(e: float, a: float = 0.05) -> float:
    """epsilon -> PSRF cutoff via chi^2 (libs/utils.py:470-472)."""
    m = (4.0 * np.pi * chi2.ppf(1.0 - a, 1)) / (_gamma(0.5) ** 2 * e**2)
    return math.sqrt(1.0 + 1.0 / m)


def effective_sample_size(trace) -> float:
    """ESS via the initial-positive-sequence autocorrelation estimator
    (Geyer 1992). Not in the reference; complements the lugsail PSRF for
    throughput-normalized comparisons (ESS/sec)."""
    x = np.asarray(trace, dtype=float)
    n = x.size
    if n < 8:
        return float(n)
    x = x - x.mean()
    var = float(np.dot(x, x)) / n
    if var == 0:
        return float(n)
    # FFT autocorrelation.
    nfft = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(x, nfft)
    acf = np.fft.irfft(f * np.conj(f))[:n].real / (n * var)
    # Sum consecutive pairs until a pair goes non-positive.
    tau = 1.0
    for k in range(1, n // 2):
        pair = acf[2 * k - 1] + acf[2 * k]
        if pair <= 0:
            break
        tau += 2.0 * pair
    return float(n / max(tau, 1.0))
