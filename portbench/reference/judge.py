"""The comparisons that decide ``correct``, each number beside its limit.

An answer is one block of one chain (its trace rows and the state it ends
in) or one CLI job (its parsed input, trace, final state and files). For
each answer the reference works out again what the program derived and
reads the program's outputs only to judge them:

  * ``mismatches``: exact relations that must hold (limit 0): the rows'
    assignment, FP, FN and alpha at a block's end against the state;
    cluster sizes against the assignment; the recorded parameter rows
    against the state's live rows; every step's parameter-move count
    against its live clusters; one split or merge at most a step, FP and FN
    moved together; parameters, FP and FN inside (0, 1), alpha above 0; a
    job's parsed matrix against the generated one; its files against each
    other, its point estimates against their trace step;
  * ``ml_rel_gap`` / ``map_rel_gap``: |program - reference| / |reference|
    of the log-likelihood and log-posterior at each state the window ends a
    block in (a job: its final state);
  * ``cell_gap_nats``: the widest gap by which a cell's cluster scores
    below its best cluster (model.cell_gaps) in those states, and for a
    job in each written estimate (its genotypes and error rates);
  * ``stuck_share``: the share of a block's steps whose row repeats the
    step before it (every field but the move counts);
  * ``err_data_gap``: a job's written FN_data / FP_data against the
    reference's from the written genotypes and the generated matrix, in
    units of the written rounding (4 and 8 decimals).

``control=True`` puts the reference's own log-likelihood in bfloat16
(model.loglik_lower) in the program's place for the two gaps: the reading
that a step down in precision gives.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import model as ref

# The fields of a trace row a step that moves nothing leaves as they were.
STUCK = ("ml", "map_", "dp_alpha", "fp", "fn", "assignment")
NUMBERS = ("mismatches", "ml_rel_gap", "map_rel_gap", "cell_gap_nats",
           "stuck_share", "err_data_gap")
EPSILON = float(np.finfo(np.float64).resolution)


class Verdict:
    """The widest reading of every number over the answers, and how many
    answers read over a limit."""

    def __init__(self, limits: dict):
        self.limits = {k: float(v) for k, v in limits.items()}
        self.worst = {}
        self.attempted = 0
        self.failed = 0

    def answer(self, numbers: dict) -> None:
        self.attempted += 1
        bad = False
        for name, value in numbers.items():
            value = float(value)
            old = self.worst.get(name)
            if old is None or not value <= old:
                self.worst[name] = value
            bad |= not value <= self.limits[name]
        self.failed += bad

    def checks(self) -> dict:
        return {name: {"value": self.worst[name], "limit": self.limits[name]}
                for name in NUMBERS if name in self.worst}

    @property
    def correct(self) -> bool:
        return self.attempted > 0 and self.failed == 0


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


def _lower(value: float) -> float:
    return float(torch.tensor(value, dtype=torch.bfloat16))


def state_numbers(mdl, ones, zeros, st: dict, row: dict, trace_k: int,
                  control: bool = False) -> dict:
    """The numbers of one state `st` (host arrays: assignment, params,
    cluster_size, dp_alpha, fp, fn) and the trace row written at it."""
    a = np.asarray(st["assignment"], dtype=np.int64)
    sizes = np.asarray(st["cluster_size"], dtype=np.int64)
    params = np.asarray(st["params"], dtype=np.float32)
    live = sizes > 0
    bad = int((np.asarray(row["assignment"], dtype=np.int64) != a).sum())
    bad += int((np.bincount(a, minlength=sizes.size) != sizes).sum())
    for f in ("dp_alpha", "fp", "fn"):
        bad += int(np.float32(row[f]) != np.float32(st[f]))
    compact = np.zeros((trace_k, params.shape[1]), dtype=np.float32)
    rows = params[live][:trace_k]
    compact[:rows.shape[0]] = rows
    bad += int((compact.astype(np.float16)
                != np.asarray(row["params"], dtype=np.float16)).sum())
    bad += int(((params[live] <= 0) | (params[live] >= 1)).sum())
    bad += int(not 0 < float(st["fp"]) < 1) + int(not 0 < float(st["fn"]) < 1)
    bad += int(not float(st["dp_alpha"]) > 0)

    ml = ref.loglik(ones, zeros, a, params, st["fp"], st["fn"])
    post = ml + ref.log_prior(mdl, sizes, params, st["dp_alpha"], st["fp"],
                              st["fn"])
    got_ml, got_map = float(row["ml"]), float(row["map_"])
    if control:
        got_ml = ref.loglik_lower(ones, zeros, a, params, st["fp"], st["fn"])
        got_map = _lower(got_ml + _lower(post - ml))
    gaps = ref.cell_gaps(ones, zeros, a, params, sizes, st["fp"], st["fn"])
    return {"mismatches": bad, "ml_rel_gap": _rel(got_ml, ml),
            "map_rel_gap": _rel(got_map, post),
            "cell_gap_nats": float(gaps.max())}


def rows_numbers(rows: dict, prev: dict | None, m: int) -> dict:
    """The numbers of one block's trace rows (host arrays with a leading
    step axis) of one chain; `prev` is the row before the block's first."""
    a = np.asarray(rows["assignment"])
    mh = np.asarray(rows["mh_counts"], dtype=np.int64)
    steps = a.shape[0]
    bad = 0
    for t in range(steps):
        n_live = int((np.bincount(a[t]) > 0).sum())
        bad += int(mh[t, 0].sum() != n_live * m)
    sm = mh[:, 1:3].sum(axis=(1, 2))
    fp_moves, fn_moves = mh[:, 3].sum(axis=1), mh[:, 4].sum(axis=1)
    bad += int((sm > 1).sum())
    bad += int(((fp_moves != fn_moves) | (fp_moves > 1)).sum())
    if prev is not None:
        rows = {f: np.concatenate([np.asarray(prev[f])[None],
                                   np.asarray(rows[f])]) for f in STUCK}
    return {"mismatches": bad, "stuck_share": rows_stuck(rows)}


def job_numbers(mdl, x, job: dict, control: bool = False) -> dict:
    """The numbers of one CLI job (drivers/cli_jobs.py::collect)."""
    ones, zeros = ref.planes(x)
    loaded = np.asarray(job["loaded"], dtype=np.float64)
    bad = 0
    if loaded.shape != x.shape:
        bad += 1
    else:
        bad += int((~((loaded == x) | (np.isnan(loaded) & np.isnan(x))))
                   .sum())
    res = job["results"]
    last = {"assignment": res["assignments"][-1], "ml": res["ML"][-1],
            "map_": res["MAP"][-1], "dp_alpha": res["DP_alpha"][-1],
            "fp": res["FP"][-1], "fn": res["FN"][-1],
            "params": job["last_params"]}
    nums = state_numbers(mdl, ones, zeros, job["state"], last,
                         job["trace_k"], control)
    bad += nums.pop("mismatches")
    stuck = rows_stuck({"ml": res["ML"], "map_": res["MAP"],
                        "dp_alpha": res["DP_alpha"], "fp": res["FP"],
                        "fn": res["FN"], "assignment": res["assignments"]})
    gap = nums.pop("cell_gap_nats")
    err_gap = 0.0
    n = x.shape[0]
    for est, out in job["estimates"].items():
        assign = np.asarray(out["assignment"], dtype=np.int64)
        geno, cont = out["geno"], out["cont"]
        if (geno is None or assign.size != n
                or geno.shape != (x.shape[1], n)):
            bad += 1
            continue
        if cont is not None:
            # Away from the rounding's tie: round(round(v, 4)) may differ
            # from round(v) within 5e-5 of x.5.
            clear = np.abs(cont - np.floor(cont) - 0.5) > 1e-4
            bad += int((np.round(cont) != geno)[clear].sum())
        theta_src = cont if cont is not None else geno
        labels, first, inv = np.unique(assign, return_index=True,
                                       return_inverse=True)
        theta = theta_src[:, first].T
        bad += int((theta_src != theta[inv].T).sum())
        if "step" in out:
            bad += int((np.asarray(res["assignments"][out["step"]])
                        != assign).sum())
        sizes = np.bincount(inv)
        gaps = ref.cell_gaps(ones, zeros, inv, theta, sizes, out["fp"],
                             out["fn"])
        gap = max(gap, float(gaps.max()))
        g = geno.T
        fn_ref = ((((g == 1) & (x == 0)).sum() + EPSILON)
                  / (geno.sum() + EPSILON))
        fp_ref = ((((g == 0) & (x == 1)).sum() + EPSILON)
                  / ((1 - geno).sum() + EPSILON))
        got_fn, got_fp = out["fn_data"], out["fp_data"]
        if control:
            got_fn, got_fp = _lower(fn_ref), _lower(fp_ref)
        err_gap = max(err_gap, abs(got_fn - fn_ref) / 5e-5,
                      abs(got_fp - fp_ref) / 5e-9)
    nums.update(mismatches=bad, cell_gap_nats=gap, stuck_share=stuck,
                err_data_gap=err_gap)
    return nums


def rows_stuck(rows: dict) -> float:
    """The share of steps of a trace (the first row excepted) whose fields
    in STUCK all repeat the row before."""
    steps = np.asarray(rows["ml"]).shape[0]
    same = np.ones(max(steps - 1, 0), dtype=bool)
    for f in STUCK:
        v = np.asarray(rows[f])
        same &= (v[1:] == v[:-1]).reshape(steps - 1, -1).all(axis=1)
    return float(same.sum()) / max(steps - 1, 1)
