#!/usr/bin/env python3
"""Readings that the limits of a cell's check are set from (PERF.md §2).

    python3 portbench/calibrate.py --workload <name> --seconds <s> \\
        --seeds <n> [<n> ...] [--out <file>]

For each seed, in one process, a run of the cell as run.py makes it (set-up,
a window of ``--seconds``, no trace), then every compared number read four
ways over what the window produced:

  * ``program``: the program's outputs, as run.py judges them;
  * ``control``: the reference in bfloat16 put in the program's place
    (judge.py, ``control=True``);
  * ``altered``: one cell of every answer moved to another cluster, its
    sizes and rows moved with it (chain cells), or one cell's label in the
    written posterior assignment set to another cluster's (job cells);
  * ``unchanged``: every step returning the state it was given (each
    block's rows all the first row; a job's trace all its first row);
  * ``half``: the log-likelihood taken over half of the cells and doubled.

The benchmark's own runs never run this. One JSON object a line, a seed a
line, then a summary line: per number, the largest program reading and the
smallest of each fault and of the control.
"""

import argparse
import copy
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "portbench":
    sys.path.pop(0)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.reference import judge, model as ref  # noqa: E402

OPEN = {name: float("inf") for name in judge.NUMBERS}
FAULTS = ("altered", "unchanged", "half")


def read(run, control=False) -> dict:
    verdict = judge.Verdict(OPEN)
    run.judge(verdict, control=control)
    return verdict.worst


def _move_cell(st: dict, row: dict, rng) -> None:
    """Move one cell of a host state (and its row) to another live
    cluster."""
    sizes = st["cluster_size"]
    live = np.flatnonzero(sizes > 0)
    if live.size < 2:
        return
    i = int(rng.integers(st["assignment"].size))
    old = int(st["assignment"][i])
    new = int(rng.choice(live[live != old]))
    st["assignment"] = st["assignment"].copy()
    st["assignment"][i] = new
    sizes = sizes.copy()
    sizes[old] -= 1
    sizes[new] += 1
    st["cluster_size"] = sizes
    row["assignment"][i] = new


def _half_ml(run, st: dict) -> float:
    ones, zeros = ref.planes(run.x)
    h = ones.shape[0] // 2
    return 2.0 * ref.loglik(ones[:h], zeros[:h], st["assignment"][:h],
                            st["params"], st["fp"], st["fn"])


def plant(run, fault: str, rng):
    """A copy of `run` whose outputs carry `fault`."""
    bad = copy.copy(run)
    if run.obs["kind"] == "chains":
        bad.blocks = []
        for states, rows in run.blocks:
            states = [dict(st) for st in states]
            rows = {f: v.copy() for f, v in rows.items()}
            for c, st in enumerate(states):
                if fault == "altered":
                    last = {"assignment": rows["assignment"][c, -1]}
                    _move_cell(st, last, rng)
                elif fault == "unchanged":
                    for v in rows.values():
                        v[c, :] = v[c, :1]
                else:
                    rows["ml"][c, -1] = _half_ml(run, st)
            bad.blocks.append((states, rows))
        return bad
    bad.jobs = []
    for job in run.jobs:
        job = copy.deepcopy(job)
        res = job["results"]
        if fault == "altered":
            out = job["estimates"]["posterior"]
            a = out["assignment"]
            labels = np.unique(a)
            if labels.size > 1:
                i = int(rng.integers(a.size))
                a[i] = int(rng.choice(labels[labels != a[i]]))
                # The cell's genotype columns follow its new cluster's.
                j = int(np.flatnonzero((a == a[i])
                                       & (np.arange(a.size) != i))[0])
                for g in (out["geno"], out["cont"]):
                    if g is not None:
                        g[:, i] = g[:, j]
        elif fault == "unchanged":
            for k in ("ML", "MAP", "DP_alpha", "FP", "FN", "assignments"):
                res[k] = np.repeat(res[k][:1], len(res[k]), axis=0)
        else:
            res["ML"] = res["ML"].copy()
            res["ML"][-1] = _half_ml(run, job["state"])
        bad.jobs.append(job)
    return bad


def main(argv=None, device=None, cell=None) -> int:
    """Readings of each seed. `device` None takes the CUDA card (and exits
    without one); the CPU tests pass "cpu" and a `cell` of their own at a
    small size, as run.main takes them."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    from portbench.lib import device as dev_lib
    from portbench.lib import registry

    if cell is None:
        cell = registry.cell(args.workload)
    if device is None:
        dev_lib.require_cards(cell["chips"])
        device = "cuda:0"
    kind = registry.driver(cell["traffic"]["kind"])
    lines = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = kind.make(cell, seed, device)
        run.setup()
        t_setup = time.perf_counter() - t0
        run.window(args.seconds)
        run.release()
        rng = np.random.default_rng(seed)
        line = {"seed": seed, "setup_s": t_setup,
                "window": {k: v for k, v in run.obs.items()
                           if isinstance(v, (int, float, str))},
                "program": read(run), "control": read(run, control=True)}
        for fault in FAULTS:
            line[fault] = read(plant(run, fault, rng))
        lines.append(line)
        print(json.dumps(line), flush=True)
        del run
    summary = {"workload": args.workload, "seeds": args.seeds,
               "program_max": {}, "min": {}}
    for name in judge.NUMBERS:
        vals = [ln["program"][name] for ln in lines if name in ln["program"]]
        if vals:
            summary["program_max"][name] = max(vals)
        for way in ("control",) + FAULTS:
            vals = [ln[way][name] for ln in lines if name in ln[way]]
            if vals:
                summary["min"].setdefault(way, {})[name] = min(vals)
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as fh:
            for ln in lines + [summary]:
                fh.write(json.dumps(ln) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
