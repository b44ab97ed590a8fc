"""Posterior post-processing: MPEAR consensus, ML/MAP point estimates,
metrics (counterpart of bnpc_tpu/estimators.py; reference
libs/utils.py:49-282).

The co-clustering counts, the products of the MPEAR scores, the landmark
extension and the contingency tables run on ``device`` as torch ops; the
Ward tree (scipy), the landmark choice and the genotype averaging of the
paper's section 2.3 stay on the host. The functions that touch the device
take ``device`` ("cuda" unless the caller asks for the CPU).

Exactness, so that a GPU gives the CPU's result bit for bit:
  * the similarity is integer co-clustering counts over the steps, divided
    by the step count once in float32, as bnpc_tpu does, so the Ward tree
    sees the same float32 matrix;
  * the score and extension products read that float32 matrix in float64
    against 0/1 indicators: every value is a multiple of
    2^-(ceil(log2 steps) + 23) and every sum is at most n, so the sums are
    exact (n * steps < 2^30) and do not depend on the reduction order;
  * contingency tables are counted by float32 products of 0/1 indicators
    (integers below 2^24, exact) and squared and summed in int64.
bnpc_tpu accumulates the same terms in float32, so its scores can differ
from these in the last float32 digits; both pick the same cut unless two
cuts tie to that precision.
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd
import torch
from scipy.cluster.hierarchy import cut_tree, linkage
from scipy.spatial.distance import squareform
from scipy.special import binom

EPSILON = float(np.finfo(np.float64).resolution)


def check_beta_params(mean: float, var: float) -> bool:
    """Whether (mean, var) are attainable by a Beta distribution
    (reference: libs/utils.py:31-42)."""
    return mean > 0.5 * (1 - (1 - 4 * var) ** 0.5)


# ---------------------------------------------------------------------------
# Clustering metrics (libs/utils.py:49-72), numpy only
# ---------------------------------------------------------------------------


def _contingency(true, pred) -> np.ndarray:
    _, ti = np.unique(np.asarray(true), return_inverse=True)
    _, pi = np.unique(np.asarray(pred), return_inverse=True)
    table = np.zeros((ti.max(initial=-1) + 1, pi.max(initial=-1) + 1),
                     np.int64)
    np.add.at(table, (ti.ravel(), pi.ravel()), 1)
    return table


def _entropy(counts: np.ndarray) -> float:
    counts = counts[counts > 0].astype(np.float64)
    if counts.size <= 1:
        return 0.0
    total = counts.sum()
    return float(-np.sum((counts / total)
                         * (np.log(counts) - np.log(total))))


def _mutual_info(table: np.ndarray) -> float:
    n_true, n_pred = table.sum(1), table.sum(0)
    if n_true.size == 1 or n_pred.size == 1:
        return 0.0
    total = float(table.sum())
    rows, cols = np.nonzero(table)
    nij = table[rows, cols].astype(np.float64)
    frac = nij / total
    outer = n_true[rows].astype(np.int64) * n_pred[cols].astype(np.int64)
    log_outer = (-np.log(outer) + np.log(float(n_true.sum()))
                 + np.log(float(n_pred.sum())))
    mi = frac * (np.log(nij) - np.log(total)) + frac * log_outer
    mi = np.where(np.abs(mi) < np.finfo(mi.dtype).eps, 0.0, mi)
    return float(max(mi.sum(), 0.0))


def v_measure(pred, true) -> float:
    """V-measure (beta 1) of `pred` against `true`: the harmonic mean of
    homogeneity MI / H(true) and completeness MI / H(pred), natural logs,
    each 1 where its entropy is 0 (sklearn's v_measure_score(true, pred),
    in numpy)."""
    table = _contingency(true, pred)
    if table.sum() == 0:
        return 1.0
    h_true, h_pred = _entropy(table.sum(1)), _entropy(table.sum(0))
    mi = _mutual_info(table)
    homogeneity = mi / h_true if h_true else 1.0
    completeness = mi / h_pred if h_pred else 1.0
    if homogeneity + completeness == 0.0:
        return 0.0
    return float(2.0 * homogeneity * completeness
                 / (homogeneity + completeness))


def ari(pred, true) -> float:
    """Adjusted Rand index of `pred` against `true` from the pair
    confusion counts (sklearn's adjusted_rand_score(true, pred), in numpy);
    the products in Python integers, which do not overflow at 10^5
    cells."""
    table = _contingency(true, pred)
    n = int(table.sum())
    sum_sq = int((table * table).sum())
    n_true, n_pred = table.sum(1), table.sum(0)
    tp = sum_sq - n
    fp = int(table.dot(n_pred).sum()) - sum_sq
    fn = int(table.T.dot(n_true).sum()) - sum_sq
    tn = n * n - fp - fn - sum_sq
    if fn == 0 and fp == 0:
        return 1.0
    return 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn)
                                       + (tp + fp) * (fp + tn))


def hamming_dist(geno_pred, geno_true) -> int:
    """Genotype mismatch count with transpose disambiguation
    (libs/utils.py:63-72)."""
    pred = np.asarray(geno_pred)
    true = np.asarray(geno_true)
    if pred.shape != true.shape:
        return int(np.count_nonzero(pred.round() != true.T))
    score = int(np.count_nonzero(pred.round() != true))
    if pred.shape[0] == pred.shape[1]:
        # Catch N x N frames that got transposed (libs/utils.py:67-71).
        score_t = int(np.count_nonzero(pred.round() != true.T))
        score = min(score, score_t)
    return score


# ---------------------------------------------------------------------------
# Posterior co-clustering similarity (libs/utils.py:90-97)
# ---------------------------------------------------------------------------


def _to_device(assignments: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(assignments, dtype=np.int32)).to(device)


def _sim_to_cols_device(assignments: np.ndarray, cols: np.ndarray, device):
    """[n, L] float32 device tensor: the fraction of posterior samples that
    put cell i together with cell cols[l], without the [n, n] matrix.

    Counted as integers over step chunks whose [c, n, L] compare stays
    near 512 MB, then divided by the step count once in float32 (the
    float32 values of bnpc_tpu's _sim_to_cols_device)."""
    a = _to_device(assignments, device)
    cols_t = torch.from_numpy(np.asarray(cols, dtype=np.int64)).to(device)
    steps, n = a.shape
    ncol = cols_t.numel()
    c = max(1, int((512 << 20) // max(1, n * ncol)))
    counts = torch.zeros((n, ncol), dtype=torch.int32, device=a.device)
    for s in range(0, steps, c):
        blk = a[s:s + c]
        eq = blk[:, :, None] == blk[:, cols_t][:, None, :]
        counts += eq.sum(dim=0, dtype=torch.int32)
        del eq
    return counts.to(torch.float32) / steps


def _coclustering_device(assignments: np.ndarray, device):
    """[n, n] float32 device similarity: the cols = all-cells case of
    :func:`_sim_to_cols_device`."""
    a = np.asarray(assignments)
    return _sim_to_cols_device(a, np.arange(a.shape[1]), device)


def coclustering_similarity(assignments: np.ndarray,
                            device="cuda") -> np.ndarray:
    """[n, n] host float64 mean posterior co-clustering indicator
    (1 - get_dist, libs/utils.py:90-97)."""
    return _coclustering_device(assignments, device).cpu().numpy() \
        .astype(np.float64)


def mean_hamming_condensed(assignments: np.ndarray,
                           device="cuda") -> np.ndarray:
    """Condensed (pdist-style) mean pairwise Hamming distance of the
    cells' assignment vectors: 1 - the co-clustering similarity."""
    sim = coclustering_similarity(assignments, device)
    return squareform(1.0 - sim, checks=False)


# ---------------------------------------------------------------------------
# MPEAR consensus clustering (libs/utils.py:100-143)
# ---------------------------------------------------------------------------


def _onehot(labels: torch.Tensor, k: int, dtype) -> torch.Tensor:
    """[..., k] 0/1 indicators of integer `labels` (F.one_hot reads the
    labels' range on the host; k is known here)."""
    return (labels[..., None]
            == torch.arange(k, device=labels.device)).to(dtype)


def _score(quad: float, i_sum: float, pi_sum: float, n: int) -> float:
    """Fritsch & Ickstadt (2009) eq. 13 from its pair sums: quad is
    sum_c m_c^T PI m_c, i_sum the pairs a cut puts together, pi_sum the
    off-diagonal half-sum of PI."""
    index = (quad - n) / 2.0
    expected = (i_sum * pi_sum) / float(binom(n, 2))
    max_index = 0.5 * (i_sum + pi_sum)
    denom = max_index - expected
    return -np.inf if denom == 0 else (index - expected) / denom


def _mpear_scores_batch(sim: torch.Tensor, labels: np.ndarray) -> np.ndarray:
    """MPEAR score of every column of `labels` [n, n_k] against the
    [n, n] float32 device similarity `sim` (bnpc_tpu's
    _mpear_scores_batch): with M the one-hot membership of a cut,
    sum_c m_c^T PI m_c is the sum over cells of (PI M)[i, label_i]. One
    float64 product for all cuts (exact, see the module docstring); the
    per-cut sums run in float64 on the host."""
    n, n_k = labels.shape
    k_hi = int(labels.max()) + 1
    dev = sim.device
    labs = torch.from_numpy(labels.astype(np.int64)).to(dev)  # [n, n_k]
    memb = _onehot(labs, k_hi, torch.float64).reshape(n, n_k * k_hi)
    sim64 = sim.to(torch.float64)
    pim = sim64 @ memb                                  # [n, n_k * k_hi]
    col = labs + torch.arange(n_k, device=dev) * k_hi
    terms = torch.gather(pim, 1, col).T.cpu().numpy()   # [n_k, n]
    rowsum = sim64.sum(dim=1).cpu().numpy()
    del sim64, pim
    # pi_sum over i < j (condensed form): exclude the unit diagonal.
    pi_sum = (rowsum.sum() - n) / 2.0
    scores = np.empty(n_k)
    for j in range(n_k):
        sizes = np.bincount(labels[:, j])
        i_sum = float(((sizes.astype(np.float64) ** 2).sum() - n) / 2.0)
        scores[j] = _score(float(terms[j].sum()), i_sum, pi_sum, n)
    return scores


def _contingency_chunks(assignments: np.ndarray, labels: np.ndarray,
                        k_each: int, device):
    """Yield per-step-chunk device contingency tables
    N[s, j*k_each + c, v] = |{i : labels[i, j] = c and a[s, i] = v}| as
    [c, J*k_each, k_ids] int64 tensors (bnpc_tpu's _contingency_chunks):
    one [c, n, k_ids] x [n, J*k_each] float32 product of 0/1 indicators a
    chunk, whose one-hot stays near 256 MB."""
    a = _to_device(assignments, device)
    steps, n = a.shape
    labels = np.asarray(labels)
    if labels.ndim == 1:
        labels = labels[:, None]
    n_j = labels.shape[1]
    k_ids = int(np.asarray(assignments).max()) + 1
    labs = torch.from_numpy(labels.astype(np.int64)).to(a.device)
    memb = _onehot(labs, k_each, torch.float32).reshape(n, n_j * k_each)
    c = max(1, int((256 << 20) // max(1, 4 * n * k_ids)))
    for s in range(0, steps, c):
        onehot = _onehot(a[s:s + c], k_ids, torch.float32)   # [c, n, k_ids]
        yield torch.einsum("snv,nk->skv", onehot, memb).to(torch.int64)


def _contingency_device(assignments: np.ndarray, labels: np.ndarray,
                        device) -> np.ndarray:
    """Per-step contingency tables N[s, c, v] = |{i : labels[i] = c and
    assignments[s, i] = v}| as host int64 [steps, n_k, k_ids]."""
    n_k = int(np.asarray(labels).max()) + 1
    parts = [t.cpu().numpy()
             for t in _contingency_chunks(assignments, labels, n_k, device)]
    return np.concatenate(parts, axis=0)


def _pair_stats_device(assignments: np.ndarray, labels: np.ndarray, device):
    """(quad[j], pi_quad) = (sum_s sum_cv (N^(s,j)_cv)^2, sum_s sum_v
    n_sv^2), with N^(s,j) the contingency table of candidate cut j against
    posterior sample s and n_sv the sampled-cluster sizes; exact int64."""
    labels = np.asarray(labels)
    n_k = labels.shape[1]
    k_hi = int(labels.max()) + 1
    quad = torch.zeros((n_k,), dtype=torch.int64)
    pi_quad = torch.zeros((), dtype=torch.int64)
    for cont in _contingency_chunks(assignments, labels, k_hi, device):
        cont = cont.reshape(cont.shape[0], n_k, k_hi, -1)
        # Every cell lies in exactly one cluster of candidate 0, so its
        # contingency rows sum to the sampled-cluster sizes.
        sizes = cont[:, 0].sum(dim=1)
        quad += (cont * cont).sum(dim=(0, 2, 3)).cpu()
        pi_quad += (sizes * sizes).sum().cpu()
    return quad.numpy().astype(np.float64), float(pi_quad)


def _mpear_scores_pairs(assignments: np.ndarray, labels: np.ndarray,
                        device) -> np.ndarray:
    """Exact MPEAR scores from pair-counting contingency statistics, no
    [n, n] matrix (bnpc_tpu's _mpear_scores_pairs):
    sum_c m_c^T PI m_c = (1/S) sum_s sum_cv (N^(s,j)_cv)^2 and
    sum_ij PI_ij = (1/S) sum_s sum_v n_sv^2."""
    a = np.asarray(assignments)
    steps, n = a.shape
    labels = np.asarray(labels)
    n_k = labels.shape[1]
    k_hi = int(labels.max()) + 1
    quad, pi_quad = _pair_stats_device(a, labels, device)
    pi_sum = (pi_quad / steps - n) / 2.0
    scores = np.empty(n_k)
    for j in range(n_k):
        csz = np.bincount(labels[:, j], minlength=k_hi).astype(np.float64)
        i_sum = ((csz ** 2).sum() - n) / 2.0
        scores[j] = _score(quad[j] / steps, i_sum, pi_sum, n)
    return scores


def _cut_range(assignments: np.ndarray, device) -> np.ndarray:
    """Candidate cluster-count range for the MPEAR scan
    (libs/utils.py:115-120): [0.2, 2.5] x the average number of
    non-trivial (size > 2) clusters per posterior sample. Each sample row
    is sorted on the device and its runs of length >= 3 counted (a run
    has a third element iff xs[i] == xs[i + 2] at its start); the average
    is bnpc_tpu's float32 mean of the integer counts."""
    if assignments.shape[1] < 3:  # no cluster can exceed size 2
        return np.array([2])
    xs = torch.sort(_to_device(assignments, device), dim=1).values
    s = xs.shape[0]
    start = torch.cat([torch.ones((s, 1), dtype=torch.bool, device=xs.device),
                       xs[:, 1:] != xs[:, :-1]], dim=1)
    has3 = torch.cat([xs[:, 2:] == xs[:, :-2],
                      torch.zeros((s, 2), dtype=torch.bool,
                                  device=xs.device)], dim=1)
    total = int((start & has3).sum())
    avg = float(np.float32(total) / np.float32(s))
    lo = max(2, int(avg * 0.2))
    hi = int(min(avg * 2.5, assignments.shape[1]))
    n_range = np.arange(lo, hi, dtype=int)
    if n_range.size == 0:
        n_range = np.array([max(2, min(int(avg) or 2, assignments.shape[1]))])
    return n_range


def _stratified_landmarks(assignments: np.ndarray, n_landmarks: int):
    """Deterministic landmark cells for the scalable MPEAR path: stratified
    by the final posterior sample's clustering so every cluster (however
    small) contributes at least one landmark, the rest proportional."""
    last = assignments[-1]
    n = last.size
    rng = np.random.default_rng(n)  # deterministic per problem size
    ids, counts = np.unique(last, return_counts=True)
    quota = np.maximum(1, (counts * (n_landmarks / n)).astype(int))
    picks = []
    for cid, q in zip(ids, quota):
        members = np.nonzero(last == cid)[0]
        picks.append(rng.choice(members, size=min(q, members.size),
                                replace=False))
    picks = np.concatenate(picks)
    if picks.size < n_landmarks:
        rest = np.setdiff1d(np.arange(n), picks, assume_unique=False)
        extra = rng.choice(rest, size=min(n_landmarks - picks.size,
                                          rest.size), replace=False)
        picks = np.concatenate([picks, extra])
    return np.sort(picks[:n_landmarks])


def _fetch_for_tree(sim: torch.Tensor, quant_above: int) -> np.ndarray:
    """Host float64 copy of `sim` for the Ward tree; above `quant_above`
    bytes it is uint8-quantized first (<= 1/510 distance perturbation),
    as bnpc_tpu's fetch_for_tree: the tree must see what bnpc_tpu's sees.
    Only the tree reads the quantized copy."""
    if sim.numel() * sim.element_size() > quant_above:
        q = torch.round(sim * 255.0).to(torch.uint8)
        return q.cpu().numpy().astype(np.float64) / 255.0
    return sim.cpu().numpy().astype(np.float64)


def _ward_cuts(sim: np.ndarray, n_range: np.ndarray) -> np.ndarray:
    """[n, n_k] candidate partitions: the Ward tree of 1 - sim cut at every
    cluster count of `n_range` (host scipy)."""
    z = linkage(squareform(1.0 - sim, checks=False), method="ward")
    return cut_tree(z, n_clusters=n_range)


def _extend(sim_nl: torch.Tensor, lm: np.ndarray,
            labels_lm: np.ndarray) -> np.ndarray:
    """[n, n_k] extension of each landmark cut to every cell: the cut
    cluster with the highest mean similarity to the cell (first on a tie);
    landmarks keep their tree label (bnpc_tpu's `extend`). One float64
    product a row chunk for all cuts (exact, see the module docstring),
    the chunk's copy and product kept near 512 MB."""
    dev = sim_nl.device
    n, n_lm = sim_nl.shape
    n_k = labels_lm.shape[1]
    k_hi = int(labels_lm.max()) + 1
    labs = torch.from_numpy(labels_lm.astype(np.int64)).to(dev)  # [L, n_k]
    memb = _onehot(labs, k_hi, torch.float64)           # [L, n_k, k_hi]
    cnt = memb.sum(dim=0)                               # [n_k, k_hi]
    memb = memb.reshape(n_lm, n_k * k_hi)
    empty = torch.full_like(cnt, -np.inf)
    full = torch.empty((n, n_k), dtype=torch.int64, device=dev)
    rows = max(1, int((512 << 20) // (8 * (n_lm + n_k * k_hi))))
    for r in range(0, n, rows):
        tot = (sim_nl[r:r + rows].to(torch.float64) @ memb) \
            .reshape(-1, n_k, k_hi)
        mean = torch.where(cnt > 0, tot / cnt.clamp(min=1.0), empty)
        full[r:r + rows] = torch.argmax(mean, dim=2)
        del tot, mean
    full[torch.from_numpy(lm).to(dev)] = labs
    return full.cpu().numpy()


def mpear_assignment(assignments: np.ndarray, max_exact: int | None = None,
                     device="cuda") -> np.ndarray:
    """Consensus assignment maximizing MPEAR over a Ward-linkage scan
    (libs/utils.py:100-129; bnpc_tpu's mpear_assignment, same paths and
    knobs).

    Up to `max_exact` cells (BNPC_TPU_MPEAR_EXACT_MAX, default 4096) the
    tree is built from the full co-clustering matrix and every cut is
    scored against it. Beyond it the path is matrix-free: the tree is built
    from a stratified landmark subset (BNPC_TPU_MPEAR_LANDMARKS, default
    1536), each cut is extended to every cell through the [n, L] similarity
    block, and the extended cuts are scored exactly by pair counting.
    """
    if max_exact is None:
        max_exact = int(os.environ.get("BNPC_TPU_MPEAR_EXACT_MAX", "4096"))
    a = np.asarray(assignments)
    steps, n = a.shape
    n_range = _cut_range(a, device)

    n_landmarks = int(os.environ.get("BNPC_TPU_MPEAR_LANDMARKS", "1536"))
    if n <= max_exact or n_landmarks >= n:
        sim = _coclustering_device(a, device)
        labels = _ward_cuts(_fetch_for_tree(sim, 16 << 20), n_range)
        scores = _mpear_scores_batch(sim, labels)
        return labels[:, int(np.argmax(scores))]

    lm = _stratified_landmarks(a, n_landmarks)
    sub = _sim_to_cols_device(a[:, lm], np.arange(lm.size), device)
    labels_lm = _ward_cuts(_fetch_for_tree(sub, 4 << 20), n_range)
    del sub
    sim_nl = _sim_to_cols_device(a, lm, device)
    labels_full = _extend(sim_nl, lm, labels_lm)
    del sim_nl  # the [n, L] block is gone before the pair scoring
    scores = _mpear_scores_pairs(a, labels_full, device)
    return labels_full[:, int(np.argmax(scores))]


# ---------------------------------------------------------------------------
# Consensus genotypes (libs/utils.py:146-192; paper section 2.3)
# ---------------------------------------------------------------------------


def consensus_genotypes(assignments: np.ndarray, params_full: np.ndarray,
                        assign: np.ndarray | None = None, device="cuda"):
    """(assign, genotypes DataFrame [muts x cells]); bnpc_tpu's
    consensus_genotypes.

    For each consensus cluster, average the sampled parameter rows over the
    posterior samples in which (criterion 1) all its cells share one sampled
    cluster and, preferably, (criterion 2) no outside cell shares it; fall
    back to a membership-weighted average over all samples. One device
    contingency pass gives N[s, c, v] = |consensus cluster c and sampled
    cluster v at step s|; both criteria and the fallback's weights are
    host lookups in it.
    """
    steps, n_cells = assignments.shape
    a = np.asarray(assignments)
    if assign is None:
        assign = mpear_assignment(a, device=device)
    clusters, cinv = np.unique(assign, return_inverse=True)
    n_k = clusters.size

    srow = np.arange(steps)
    joint = _contingency_device(a, cinv, device)          # N[s, c, v]

    # tot[s, v]: sampled cluster sizes; rank[s, v]: row index of id v in
    # the compacted parameter trace (= # of smaller occupied ids).
    tot = joint.sum(axis=1)
    present = tot > 0
    rank = np.cumsum(present, axis=1) - 1

    capacity = params_full.shape[1]
    n_live_max = int(present.sum(axis=1).max())
    if n_live_max > capacity:
        raise ValueError(
            f"{n_live_max} live clusters in a posterior sample exceed the "
            f"parameter-trace capacity {capacity}; re-run with a larger "
            "--trace_clusters"
        )

    sizes = np.bincount(cinv, minlength=n_k)              # consensus sizes
    params = np.zeros((n_k, params_full.shape[2]))
    for ci in range(n_k):
        nc = joint[:, ci, :]                              # [steps, k_ids]
        # Majority sampled id of the member cells (ties -> lowest id, as
        # the reference's bincount argmax).
        cl_ids = nc.argmax(axis=1)
        nc_at = nc[srow, cl_ids]
        same_cluster = nc_at == sizes[ci]                 # criterion 1
        no_others = nc_at == tot[srow, cl_ids]            # criterion 2

        if same_cluster.any():
            use = same_cluster & no_others
            step_idx = np.nonzero(use if use.any() else same_cluster)[0]
            ranks = rank[step_idx, cl_ids[step_idx]]
            params[ci] = params_full[step_idx, ranks].mean(axis=0)
        else:
            # Membership-weighted average over ALL samples: each member
            # cell contributes its sampled cluster's parameter row, i.e.
            # row r of step s carries weight N[s, ci, v(r)].
            w = np.zeros((steps, capacity))
            s_p, v_p = np.nonzero(nc)
            w[s_p, rank[s_p, v_p]] = nc[s_p, v_p]
            params[ci] = np.einsum("sk,skm->m", w, params_full) \
                / (steps * sizes[ci])

    # Positional take, then label the columns (label-based selection of
    # duplicate column labels is slow in pandas at 10^4-10^5 cells).
    geno = pd.DataFrame(params.T[:, cinv], columns=assign)
    return assign, geno


# ---------------------------------------------------------------------------
# Latent-variable extraction (libs/utils.py:195-282)
# ---------------------------------------------------------------------------


def _posterior_avg(x):
    return float(np.mean(x)), float(np.std(x))


def _geno_errors(geno: pd.DataFrame, data: np.ndarray):
    """Data-vs-genotype FN/FP estimates (libs/utils.py:235-238)."""
    g = geno.T.values.round()
    fn_geno = (((g == 1) & (data == 0)).sum() + EPSILON) \
        / (geno.values.round().sum() + EPSILON)
    fp_geno = (((g == 0) & (data == 1)).sum() + EPSILON) \
        / ((1 - geno.values.round()).sum() + EPSILON)
    return float(fn_geno), float(fp_geno)


def _pool_chains(results: list[dict]) -> dict:
    """Concatenate post-burn-in traces of all chains
    (libs/utils.py:206-223)."""
    def cat(key):
        return np.concatenate([r[key][r["burn_in"]:] for r in results])

    params = [r["params"] for r in results]
    k_max = max(p.shape[1] for p in params)
    params = [
        np.pad(p, [(0, 0), (0, k_max - p.shape[1]), (0, 0)]) for p in params
    ]
    return {
        "assignments": cat("assignments"),
        "DP_alpha": cat("DP_alpha"),
        "ML": cat("ML"), "MAP": cat("MAP"),
        "FN": cat("FN"), "FP": cat("FP"),
        "params": np.concatenate(params),
        "burn_in": 0,
    }


def _posterior_chain(result: dict, data: np.ndarray, device) -> dict:
    bi = result["burn_in"]
    assigns = result["assignments"][bi:]
    # The parameter trace is already post-burn-in (recorded from row
    # burn_in on): align it to the assignment slice instead of re-slicing.
    params = result["params"]
    if params.shape[0] != assigns.shape[0]:
        params = params[-assigns.shape[0]:]
    assign, geno = consensus_genotypes(assigns, params, device=device)
    fn_geno, fp_geno = _geno_errors(geno, data)
    return {
        "a": _posterior_avg(result["DP_alpha"][bi:]),
        "assignment": assign,
        "genotypes": geno,
        "FN": _posterior_avg(result["FN"][bi:]),
        "FP": _posterior_avg(result["FP"][bi:]),
        "FN_geno": fn_geno,
        "FP_geno": fp_geno,
    }


def latents_posterior(results: list[dict], data: np.ndarray,
                      single_chains: bool = False,
                      device="cuda") -> list[dict]:
    if single_chains:
        return [_posterior_chain(r, data, device) for r in results]
    return [_posterior_chain(_pool_chains(results), data, device)]


def _point_chain(result: dict, est: str, data: np.ndarray) -> dict:
    bi = result["burn_in"]
    step_no_bi = int(np.argmax(result[est][bi:]))
    step = step_no_bi + bi

    assignment = result["assignments"][step].tolist()
    cl_names = np.unique(assignment)
    if cl_names.size > result["params"].shape[1]:
        raise ValueError(
            f"{cl_names.size} live clusters at the {est}-optimal step exceed "
            f"the parameter-trace capacity {result['params'].shape[1]}; "
            "re-run with a larger --trace_clusters"
        )
    geno_rows = result["params"][step_no_bi][np.arange(cl_names.size)]
    pos = np.searchsorted(cl_names, assignment)
    geno = pd.DataFrame(geno_rows.T[:, pos], columns=assignment)
    fn_geno, fp_geno = _geno_errors(geno, data)
    return {
        "step": step,
        "a": float(result["DP_alpha"][step]),
        "assignment": assignment,
        "genotypes": geno,
        "FN": float(result["FN"][step]),
        "FP": float(result["FP"][step]),
        "FN_geno": fn_geno,
        "FP_geno": fp_geno,
    }


def latents_point(results: list[dict], est: str, data: np.ndarray,
                  single_chains: bool = False) -> list[dict]:
    """ML or MAP point estimate: the trace's best post-burn-in step (host
    only: one row of the recorded traces)."""
    if single_chains:
        return [_point_chain(r, est, data) for r in results]
    scores = [np.max(r[est][r["burn_in"]:]) for r in results]
    best = results[int(np.argmax(scores))]
    return [_point_chain(best, est, data)]
