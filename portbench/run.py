#!/usr/bin/env python3
"""The benchmark of bnpc_tpu_torch, one cell a run.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Sets the cell up (data from the seed, the runner, the warm-up), measures
for ``--seconds``, checks what the window produced against the plain
reference, and prints one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; ``checks``, each compared number beside its limit, comes
last there and as the last lines of standard error. Without a CUDA card it
exits with code 2 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "portbench":
    sys.path.pop(0)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device=None, cell=None) -> int:
    """One run. `device` None takes the CUDA card (and exits without one);
    the CPU tests pass "cpu" and a `cell` of their own (registry.cell's
    form, at a small size) to drive the rest of a run."""
    args = parse_args(argv)
    from portbench.lib import device as dev_lib
    from portbench.lib import devtrace, registry
    from portbench.reference import judge

    if cell is None:
        cell = registry.cell(args.workload)
    if device is None:
        dev_lib.require_cards(cell["chips"])
        device = "cuda:0"
    import torch

    run = registry.driver(cell["traffic"]["kind"]).make(
        cell, args.seed, device, bool(args.trace))
    run.setup()
    obs = run.obs
    obs["setup_s"] = time.perf_counter() - T0
    run.window(args.seconds)
    if args.trace:
        run.traced()
    dev = dev_lib.describe(device, cell["chips"])
    run.release()
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()
    verdict = judge.Verdict(cell["workload"]["limits"])
    run.judge(verdict)

    obs["handwritten"] = devtrace.handwritten_kernels(ROOT)
    metrics = {}
    for m in cell["per_layer"] if args.trace else cell["end_to_end"]:
        value = registry.reader(m["name"]).read(obs)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    line = {"correct": verdict.correct, "attempted": verdict.attempted,
            "failed": verdict.failed, "metrics": metrics, "device": dev}
    if args.trace:
        prof = obs["profile"]
        dev.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        line["breakdown"] = {"device_ops": prof["device_ops"],
                             "idle_gaps": prof["idle_gaps"]}
    line["checks"] = verdict.checks()

    found = dev_lib.forbidden_modules()
    if found:
        print(f"portbench: modules loaded that the port may not use: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
