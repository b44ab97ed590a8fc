"""The program's own spans (bnpc_tpu_torch/trace.py) reduced to per-layer
readings, and joined by time with torch.profiler's device idle.

A segment is one whole block of every chain, or one CLI job:

  * segment (a), the tracer on with device spans and no profiler:
    ``summarize(taken, steps)`` gives the host milliseconds in reads and in
    steps outside their reads (and the steps' host milliseconds by move
    kind), the reads by reason, the sweep counter, the device milliseconds
    of the pieces by family (bnpc_tpu_torch/mcmc.py::PIECE_FAMILIES) and
    between pieces, and the seconds of the captures;
  * segment (b), the tracer on with host spans only, under the profiler
    (``profile``): ``join(taken, prof)`` gives each idle gap of the device
    to the innermost span that covers its midpoint, and sums the idle
    inside a step outside its reads (dispatch), inside reads, and inside
    ``cli.sample``. ``launch_cover`` is the share of the profiler's graph
    launches that lie inside a ``graphs.replay`` span: near 1 when the two
    clocks agree.

``readings`` names the results as the per-layer metrics that would read
them (PERF.md §3). The spans are trace.Span objects or anything with
their fields (``name``, ``start``, ``end``, ``parent``, ``attrs``).
"""

from __future__ import annotations

import bisect
import time

import numpy as np

from portbench.lib import devtrace

GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")
FAMILIES = ("sweep", "split_merge", "rest")


def _ancestor_names(spans, i):
    names = []
    while i >= 0:
        names.append(spans[i].name)
        i = spans[i].parent
    return names


def summarize(taken: dict, steps: int) -> dict:
    """Segment (a)'s readings over its `steps` chain-steps."""
    spans = taken["spans"]
    out = {"steps": steps, "step_ms": 0.0, "read_ms": 0.0,
           "step_read_ms": 0.0, "capture_s": 0.0, "pieces": 0,
           "gap_ms": 0.0, "device_ms": {f: 0.0 for f in FAMILIES},
           "by_move": {}, "reads": {}, "counts": dict(taken["counts"])}
    for s in spans:
        ms = (s.end - s.start) * 1e-6
        if s.name == "runner.step":
            out["step_ms"] += ms
            n_ms = out["by_move"].setdefault(s.attrs.get("move", "-"),
                                             [0, 0.0])
            n_ms[0] += 1
            n_ms[1] += ms
        elif s.name == "runner.read":
            out["read_ms"] += ms
            reason = s.attrs["reason"]
            out["reads"][reason] = out["reads"].get(reason, 0) + 1
            if "runner.step" in _ancestor_names(spans, s.parent):
                out["step_read_ms"] += ms
        elif s.name == "graphs.capture":
            out["capture_s"] += ms * 1e-3
        if "device_ms" in s.attrs:
            out["pieces"] += 1
            out["device_ms"][s.attrs["family"]] += s.attrs["device_ms"]
            out["gap_ms"] += s.attrs.get("gap_ms", 0.0)
    out["dispatch_ms"] = out["step_ms"] - out["step_read_ms"]
    return out


def profile(fn, device) -> dict:
    """fn() once under torch.profiler: lib/devtrace.py's readings, and the
    merged device busy intervals, the window's bounds and the graph
    launches' host intervals (nanoseconds, the profiler's clock)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    cuda = str(device).startswith("cuda")
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize(device)
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    events = prof.profiler.kineto_results.events()
    out = devtrace.reduce_events(events, wall)
    dev, host, launches = [], [], []
    for e in events:
        s = e.start_ns()
        iv = (s, s + e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            dev.append(iv)
        else:
            host.append(iv)
            if e.name() in GRAPH_LAUNCHES:
                launches.append(iv)
    out["busy"] = (devtrace._merge(np.asarray([d[0] for d in dev]),
                                   np.asarray([d[1] for d in dev]))
                   if dev else [])
    ends = [e for _, e in dev + host]
    out["t_lo"] = min((s for s, _ in host), default=0)
    out["t_hi"] = max(ends, default=0)
    out["graph_launches"] = launches
    return out


def idle_gaps(busy, t_lo: int, t_hi: int) -> list:
    """The intervals of [t_lo, t_hi] outside the merged busy intervals."""
    gaps, prev = [], t_lo
    for s, e in busy:
        if s > prev:
            gaps.append((prev, min(s, t_hi)))
        prev = max(prev, e)
    if t_hi > prev:
        gaps.append((prev, t_hi))
    return [(s, e) for s, e in gaps if e > s]


class _Cover:
    """The spans that cover an instant, innermost first. Spans nest (one
    thread), so the innermost span covering t is an ancestor of the latest
    span to start at or before t, or that span itself."""

    def __init__(self, spans):
        self.spans = spans
        self.order = sorted(range(len(spans)), key=lambda i: spans[i].start)
        self.starts = [spans[i].start for i in self.order]

    def names(self, t: int) -> list:
        j = bisect.bisect_right(self.starts, t) - 1
        i = self.order[j] if j >= 0 else -1
        while i >= 0 and not self.spans[i].end >= t:
            i = self.spans[i].parent
        return _ancestor_names(self.spans, i)


def join(taken: dict, prof: dict) -> dict:
    """Segment (b)'s device idle by the program span it fell in."""
    cover = _Cover(taken["spans"])
    out = {"idle_s": 0.0, "dispatch_s": 0.0, "read_s": 0.0,
           "sample_s": 0.0, "by_span": {}}
    for s, e in idle_gaps(prof["busy"], prof["t_lo"], prof["t_hi"]):
        sec = (e - s) * 1e-9
        names = cover.names((s + e) // 2)
        key = names[0] if names else "outside the program's spans"
        out["by_span"][key] = out["by_span"].get(key, 0.0) + sec
        out["idle_s"] += sec
        if "runner.read" in names:
            out["read_s"] += sec
        elif "runner.step" in names:
            out["dispatch_s"] += sec
        if "cli.sample" in names:
            out["sample_s"] += sec
    launches = prof["graph_launches"]
    out["launch_cover"] = (sum("graphs.replay" in cover.names((s + e) // 2)
                               for s, e in launches) / len(launches)
                           if launches else None)
    return out


def readings(program: dict | None, profiled: dict | None) -> dict:
    """The per-layer readings of segments (a) and (b) by metric name (None
    where a segment holds nothing to read)."""
    out = {}
    if program:
        steps, counts = program["steps"], program["counts"]
        timed = program["pieces"] > 0
        out["read_wait_ms_per_step"] = program["read_ms"] / steps
        out["dispatch_ms_per_step"] = program["dispatch_ms"] / steps
        out["round_reads_per_sweep"] = (
            program["reads"].get("round", 0) / counts["sweeps"]
            if counts.get("sweeps") else None)
        for fam in FAMILIES:
            out[f"device_ms_per_step.{fam}"] = (
                program["device_ms"][fam] / steps if timed else None)
        out["device_gap_ms_per_step"] = (program["gap_ms"] / steps
                                         if timed else None)
        out["capture_s.job"] = program["capture_s"]
    if profiled and profiled["idle_s"] > 0:
        share = 100.0 / profiled["idle_s"]
        out["idle_in_dispatch.sample"] = profiled["dispatch_s"] * share
        out["idle_in_sample.job"] = profiled["sample_s"] * share
    return out
