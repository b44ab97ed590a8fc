"""Effective sample size, frozen.

A copy of ``bnpc_tpu_torch/diagnostics.py::effective_sample_size`` (Geyer
1992, the initial-positive-sequence estimator), the arithmetic that
``benchmarks/ess_bench.py::summarize`` applies to the log-likelihood trace.
"""

from __future__ import annotations

import numpy as np


def effective_sample_size(trace) -> float:
    """ESS of a scalar trace: n over the integrated autocorrelation time,
    the autocorrelations summed in consecutive pairs until a pair is not
    positive."""
    x = np.asarray(trace, dtype=float)
    n = x.size
    if n < 8:
        return float(n)
    x = x - x.mean()
    var = float(np.dot(x, x)) / n
    if var == 0:
        return float(n)
    nfft = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(x, nfft)
    acf = np.fft.irfft(f * np.conj(f))[:n].real / (n * var)
    tau = 1.0
    for k in range(1, n // 2):
        pair = acf[2 * k - 1] + acf[2 * k]
        if pair <= 0:
            break
        tau += 2.0 * pair
    return float(n / max(tau, 1.0))
