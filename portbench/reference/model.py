"""The BnpC model in plain NumPy / SciPy, float64 (Borgsmüller et al.,
Bioinformatics 2020; the upstream ``libs/CRP.py`` and
``libs/CRP_learning_errors.py``).

A cell i in cluster k with genotype parameters theta_k shows a 1 at locus j
with probability theta_kj (1 - FN) + (1 - theta_kj) FP and a 0 with
theta_kj FN + (1 - theta_kj)(1 - FP); missing entries say nothing. The
joint log prior: alpha ~ loc + Gamma(shape, 1) (shape = sqrt(n), loc = 1
unless the configuration sets them), the CRP weight log(size) - log(n - 1 +
alpha) of every live cluster, Beta(p, q) on every live cluster's
parameters, and truncated normals on [0, 1] for FP and FN when the errors
are learned. Everything is worked out again from the generated matrix; the
program's outputs are only judged.

``loglik_lower`` is the control: the same log-likelihood computed in
bfloat16, the precision below the configuration's float32.
"""

from __future__ import annotations

import math

import numpy as np
from scipy import stats


class Model:
    """The static settings of a configuration file's ``model`` group."""

    def __init__(self, config: dict):
        d, mdl = config["data"], config["model"]
        self.n, self.m = int(d["n_cells"]), int(d["n_muts"])
        self.k_max = int(mdl["k_max"])
        self.p, self.q = float(mdl["p"]), float(mdl["q"])
        self.learn_errors = bool(mdl["learn_errors"])
        self.fp_mean, self.fn_mean = float(mdl["fp"]), float(mdl["fn"])
        self.fp_sd, self.fn_sd = float(mdl["fp_sd"]), float(mdl["fn_sd"])
        shape = float(mdl.get("dp_a_shape", -1.0))
        loc = float(mdl.get("dp_a_loc", -1.0))
        if shape < 0 or loc < 0:
            shape, loc = math.sqrt(self.n), 1.0
        self.dp_shape, self.dp_loc = shape, loc


def planes(x: np.ndarray):
    """(ones, zeros) indicator planes of a 0 / 1 / NaN matrix, float64."""
    return (x == 1).astype(np.float64), (x == 0).astype(np.float64)


def cluster_counts(ones, zeros, assign, k: int):
    """(n1, n0) [k, m]: observed ones and zeros of each cluster's cells."""
    assign = np.asarray(assign, dtype=np.int64)
    order = np.argsort(assign, kind="stable")
    a = assign[order]
    n1 = np.zeros((k, ones.shape[1]))
    n0 = np.zeros((k, ones.shape[1]))
    if a.size:
        starts = np.flatnonzero(np.r_[True, a[1:] != a[:-1]])
        ids = a[starts]
        n1[ids] = np.add.reduceat(ones[order], starts, axis=0)
        n0[ids] = np.add.reduceat(zeros[order], starts, axis=0)
    return n1, n0


def tables(theta, fp, fn):
    """(log P(x=1), log P(x=0)) of every parameter."""
    theta = np.asarray(theta, dtype=np.float64)
    fp, fn = float(fp), float(fn)
    return (np.log(theta * (1.0 - fn) + (1.0 - theta) * fp),
            np.log(theta * fn + (1.0 - theta) * (1.0 - fp)))


def loglik(ones, zeros, assign, theta, fp, fn) -> float:
    """The data's log-likelihood under an assignment and cluster params."""
    k = theta.shape[0]
    n1, n0 = cluster_counts(ones, zeros, assign, k)
    c1, c0 = tables(theta, fp, fn)
    used = (n1 + n0).sum(axis=1) > 0
    return float((n1[used] * c1[used]).sum() + (n0[used] * c0[used]).sum())


def log_prior(model: Model, sizes, theta, alpha, fp, fn) -> float:
    """The joint log prior of a state (see the module docstring)."""
    sizes = np.asarray(sizes)
    live = sizes > 0
    alpha = float(alpha)
    lp = float(stats.gamma(model.dp_shape, loc=model.dp_loc).logpdf(alpha))
    lp += float(np.sum(np.log(sizes[live].astype(np.float64))
                       - math.log(model.n - 1.0 + alpha)))
    if not (model.p == 1.0 and model.q == 1.0):
        lp += float(stats.beta(model.p, model.q).logpdf(
            np.asarray(theta, dtype=np.float64)[live]).sum())
    if model.learn_errors:
        for x, mu, sd in ((fp, model.fp_mean, model.fp_sd),
                          (fn, model.fn_mean, model.fn_sd)):
            lp += float(stats.truncnorm((0.0 - mu) / sd, (1.0 - mu) / sd,
                                        loc=mu, scale=sd).logpdf(float(x)))
    return lp


def cell_gaps(ones, zeros, assign, theta, sizes, fp, fn, rows=16384):
    """[n] nats by which each cell's own cluster scores below its best
    live cluster, a cluster's score for a cell being log(size) plus the
    cell's log-likelihood under the cluster's parameters (0 where the own
    cluster is the best)."""
    sizes = np.asarray(sizes)
    live = np.flatnonzero(sizes > 0)
    c1, c0 = tables(np.asarray(theta)[live], fp, fn)
    prior = np.log(sizes[live].astype(np.float64))
    slot = np.full(sizes.shape[0], -1, dtype=np.int64)
    slot[live] = np.arange(live.size)
    assign = np.asarray(assign, dtype=np.int64)
    own = slot[assign]
    if (own < 0).any():
        raise ValueError("a cell is assigned to an empty cluster")
    gaps = np.empty(assign.size)
    for lo in range(0, assign.size, rows):
        hi = min(lo + rows, assign.size)
        score = ones[lo:hi] @ c1.T + zeros[lo:hi] @ c0.T + prior
        gaps[lo:hi] = score.max(axis=1) - score[np.arange(hi - lo),
                                                own[lo:hi]]
    return gaps


def loglik_lower(ones, zeros, assign, theta, fp, fn) -> float:
    """The control: ``loglik`` with the tables, the counts, the products
    and the sums in bfloat16 (plain torch on the CPU)."""
    import torch

    bf = torch.bfloat16
    k = theta.shape[0]
    n1, n0 = cluster_counts(ones, zeros, assign, k)
    th = torch.as_tensor(np.asarray(theta, dtype=np.float32)).to(bf)
    fp_t = torch.tensor(float(fp), dtype=bf)
    fn_t = torch.tensor(float(fn), dtype=bf)
    one = torch.tensor(1.0, dtype=bf)
    c1 = torch.log(th * (one - fn_t) + (one - th) * fp_t)
    c0 = torch.log(th * fn_t + (one - th) * (one - fp_t))
    used = torch.as_tensor((n1 + n0).sum(axis=1) > 0)
    t1 = torch.as_tensor(n1).to(bf)[used] * c1[used]
    t0 = torch.as_tensor(n0).to(bf)[used] * c0[used]
    return float((t1.sum(dtype=bf) + t0.sum(dtype=bf)).item())
