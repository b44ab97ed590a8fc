#!/usr/bin/env python3
"""Readings of the program's own tracer (bnpc_tpu_torch/trace.py) in a
cell, and the tracer's cost.

    python3 portbench/program_trace.py --workload <name> --seed <n> [--cost]

Sets the cell up as run.py does, then runs two segments, each one whole
block of every chain (a ``chains`` cell) or one CLI job (a ``cli_jobs``
cell):

  (a) the tracer on with device spans and no profiler. In a chains cell
      the block runs twice from the same states and draws, the tracer off
      and then on, and the two must give the same bits (``same_bits``);
  (b) the tracer on with host spans only, under torch.profiler.

With ``--cost`` (chains cells) it then times windows of BENCHMARK.json's
``run_seconds`` as run.py times its window, with the tracer off, with host
spans and with device spans, ``COST_RUNS`` of each, interleaved. The
segments' blocks and jobs are checked as run.py checks a run
(``correct``); the cost windows run the code of segment (a) and are not. Prints one JSON line: ``readings`` (the
per-layer metrics segments (a) and (b) would feed, lib/progtrace.py), the
segments' reductions, the cost windows' chain-steps/s and the device.

The benchmark's runs never run this: run.py's window runs with the tracer
off, and its drivers have no segment with it on (PERF.md §7).
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "portbench":
    sys.path.pop(0)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

MODES = ("off", "host", "device")
COST_RUNS = 3


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--cost", action="store_true",
                    help="time the tracer's cost in run.py's window")
    return ap.parse_args(argv)


def _same_rows(a: dict, b: dict) -> bool:
    import numpy as np

    return all(np.array_equal(a[f], b[f]) for f in a)


def chain_segments(run, trace, progtrace, device) -> dict:
    """Segments (a) and (b) of a chains cell."""
    import torch

    states = [type(st)(*(f.clone() for f in st)) for st in run.states]
    draws = list(run.draws)
    gens = [d.gen.get_state() for d in draws]
    rows_off = run._block()
    states_off = run.states
    run.states, run.draws = states, draws
    for d, g in zip(draws, gens):
        d.gen.set_state(g)
    trace.enable(device_spans=str(device).startswith("cuda"))
    rows = run._block()
    taken = trace.take()
    trace.disable()
    same = _same_rows(rows_off, rows) and all(
        torch.equal(x, y) for a, b in zip(states_off, run.states)
        for x, y in zip(a, b))
    run.blocks.append((run.states, rows))
    steps = rows["ml"].shape[0] * rows["ml"].shape[1]
    program = progtrace.summarize(taken, steps)

    box = []
    trace.enable()
    prof = progtrace.profile(lambda: box.append(run._block()), device)
    taken = trace.take()
    trace.disable()
    run.blocks.append((run.states, box[0]))
    return {"program": program, "profiled": _joined(progtrace, taken, prof),
            "same_bits": same}


def job_segments(run, trace, progtrace, device) -> dict:
    """Segments (a) and (b) of a cli_jobs cell: one job each."""
    trace.enable(device_spans=str(device).startswith("cuda"))
    run._job()
    taken = trace.take()
    trace.disable()
    steps = int(run.tr["steps"]) * int(run.tr["chains"])
    program = progtrace.summarize(taken, steps)
    trace.enable()
    prof = progtrace.profile(run._job, device)
    taken = trace.take()
    trace.disable()
    return {"program": program, "profiled": _joined(progtrace, taken, prof)}


def _joined(progtrace, taken, prof) -> dict:
    out = progtrace.join(taken, prof)
    out["busy_s"], out["window_s"] = prof["busy_s"], prof["window_s"]
    return out


def cost(run, trace, seconds: float) -> dict:
    """Chain-steps/s of windows of `seconds` in each tracer mode, COST_RUNS
    a mode, the modes in turns (off, host, device, then backwards)."""
    rates = {m: [] for m in MODES}
    kept = len(run.blocks)
    for r in range(COST_RUNS):
        for mode in MODES if r % 2 == 0 else MODES[::-1]:
            if mode != "off":
                trace.enable(device_spans=mode == "device")
            run.window(seconds)
            rates[mode].append(run.obs["chain_steps"] / run.obs["window_s"])
            trace.disable()
            trace.take()
            del run.blocks[kept:]
    return rates


def main(argv=None, device=None, cell=None) -> int:
    """One set-up and its segments. `device` None takes the CUDA card;
    the CPU tests pass "cpu" and a small `cell` (registry.cell's form)."""
    args = parse_args(argv)
    from bnpc_tpu_torch import trace
    from portbench.lib import device as dev_lib
    from portbench.lib import progtrace, registry
    from portbench.reference import judge

    if cell is None:
        cell = registry.cell(args.workload)
    if device is None:
        dev_lib.require_cards(cell["chips"])
        device = "cuda:0"
    chains = cell["traffic"]["kind"] == "chains"
    run = registry.driver(cell["traffic"]["kind"]).make(
        cell, args.seed, device, True)
    run.setup()
    segments = chain_segments if chains else job_segments
    out = segments(run, trace, progtrace, device)
    out["readings"] = progtrace.readings(out["program"], out["profiled"])
    if args.cost and chains:
        out["cost"] = cost(run, trace,
                           float(registry.manifest()["run_seconds"]))
    out["device"] = dev_lib.describe(device, cell["chips"])
    run.release()
    verdict = judge.Verdict(cell["workload"]["limits"])
    run.judge(verdict)
    out.update(workload=cell["name"], seed=args.seed,
               correct=verdict.correct, checks=verdict.checks())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
