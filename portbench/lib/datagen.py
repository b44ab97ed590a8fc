"""The benchmark's input matrices, made from the run's seed.

``make_data`` is a frozen copy of the planted-clone generator of
``benchmarks/accuracy_bench.py::make_data`` and ``chip_smoke.py::make_data``
(the same draws in the same order; the error rates are arguments here with
those files' values as defaults). ``write_input`` is a frozen copy of
``chip_smoke.py::write_input``.
"""

from __future__ import annotations

import numpy as np


def make_data(n, m, k_clones, missing, seed=0, fp=0.001, fn=0.1):
    """(data [n, m] of 0 / 1 / NaN, planted assignment [n]): k_clones random
    binary genotypes, each cell a uniform clone, ones dropped with rate fn,
    zeros flipped with rate fp, then entries missing with rate `missing`."""
    rng = np.random.default_rng(seed)
    geno = rng.integers(0, 2, size=(k_clones, m))
    assign = rng.integers(0, k_clones, size=n)
    data = geno[assign].astype(float)
    data[(data == 1) & (rng.random((n, m)) < fn)] = 0
    data[(data == 0) & (rng.random((n, m)) < fp)] = 1
    data[rng.random((n, m)) < missing] = np.nan
    return data, assign


def write_input(path, data):
    """The reference's input file: mutations x cells, space-separated, 3
    for missing; every cell one digit, so the text is built as bytes."""
    x = np.where(np.isnan(data), 3, data).astype(np.uint8).T
    buf = np.full((x.shape[0], 2 * x.shape[1]), ord(" "), np.uint8)
    buf[:, 0::2] = x + ord("0")
    buf[:, -1] = ord("\n")
    buf.tofile(path)
