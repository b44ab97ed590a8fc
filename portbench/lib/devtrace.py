"""The traced run's readings from torch.profiler and torch's sync debug mode.

``profile(fn)`` runs fn once under torch.profiler (host and device
activity) and reduces the trace to what the per-layer metrics read:

  * ``busy_s``: the union of the device operations' intervals (kernels,
    copies, sets) inside the window; ``window_s``: the window's wall time;
  * ``kernels``: {name: [count, device seconds]} of every device operation;
  * ``host_launches``: the host-side launch calls among the runtime and
    driver events (kernel and graph launches), as PERF.md §5 counts them;
  * ``device_ops`` / ``idle_gaps``: the ten device operations that took most
    time, and the device's idle time inside the window summed by the
    innermost host operation that was running at each gap's middle.

``count_syncs(fn)`` counts the host synchronizations of fn by torch's sync
debug mode, as ``chip_smoke.py::syncs_per_step`` does.

The reduction walks the profiler's own event list (``kineto_results``), so
no trace file is written.
"""

from __future__ import annotations

import re
import time
import warnings
from pathlib import Path

import numpy as np

LAUNCH_EVENTS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")
# Idle gaps shorter than this are launch spacing, counted under one name.
GAP_MIN_NS = 5_000
TOP = 10


def handwritten_kernels(root: Path) -> list[str]:
    """The names of the port's hand-written kernels: every ``__global__``
    function in its ``csrc/*.cu``."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")
    names = set()
    for src in sorted((root / "bnpc_tpu_torch" / "csrc").glob("*.cu")):
        names.update(pat.findall(src.read_text()))
    return sorted(names)


def _top_level(name: str) -> str:
    """`name` without its parameter list and return type: the text before
    the first "(" and after the last space outside template brackets."""
    if "::" not in name and "<" not in name:
        return name.split(" (")[0].strip()    # a copy or set, e.g. Memcpy
    depth, start = 0, 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0 and ch == " " and name[i + 1:i + 2] != "(":
            start = i + 1
        elif depth == 0 and ch == "(":
            return name[start:i].strip()
    return name[start:].strip()


def short_name(name: str) -> str:
    """A device operation's name without its parameter list, return type
    and anonymous namespace, at most 120 characters (template arguments,
    which tell torch's elementwise kernels apart, are kept)."""
    return _top_level(name.replace("(anonymous namespace)::", ""))[:120]


def kernel_base(name: str) -> str:
    """A device operation's function name alone: no namespace, template
    arguments or parameters."""
    base = _top_level(name.replace("(anonymous namespace)::", ""))
    return base.split("<")[0].split("::")[-1]


def is_handwritten(name: str, handwritten) -> bool:
    return kernel_base(name) in handwritten


def _sync(device) -> None:
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize(device)


def profile(fn, device) -> dict:
    """Run fn() once under torch.profiler; the readings above."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CPU]
    if str(device).startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    _sync(device)
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(device)
        wall = time.perf_counter() - t0
    return reduce_events(prof.profiler.kineto_results.events(), wall)


def reduce_events(events, wall_s: float) -> dict:
    """The readings of a list of kineto events (see the module docstring)."""
    from torch.autograd import DeviceType

    dev_start, dev_end, dev_name = [], [], []
    host_start, host_end, host_name = [], [], []
    launches = 0
    for e in events:
        start = e.start_ns()
        end = start + e.duration_ns()
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            dev_start.append(start)
            dev_end.append(end)
            dev_name.append(name)
        else:
            if name in LAUNCH_EVENTS:
                launches += 1
            host_start.append(start)
            host_end.append(end)
            host_name.append(name)
    out = {"window_s": wall_s, "host_launches": launches, "kernels": {},
           "busy_s": 0.0, "device_ops": [], "idle_gaps": []}
    if not dev_start:
        return out
    ds, de = np.asarray(dev_start), np.asarray(dev_end)
    kernels = {}
    for name, s, e in zip(dev_name, dev_start, dev_end):
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (e - s) * 1e-9
    out["kernels"] = kernels
    ops = {}
    for n, v in kernels.items():
        key = short_name(n) or n
        ops[key] = ops.get(key, 0.0) + v[1]
    out["device_ops"] = [[n, v] for n, v in sorted(
        ops.items(), key=lambda kv: -kv[1])[:TOP]]
    # The window: from the first host event to the last event of either.
    t_lo = min(host_start) if host_start else int(ds.min())
    t_hi = max(int(de.max()), max(host_end) if host_end else 0)
    merged = _merge(ds, de)
    out["busy_s"] = float(sum(e - s for s, e in merged)) * 1e-9
    out["idle_gaps"] = _idle_gaps(merged, t_lo, t_hi, host_start, host_end,
                                  host_name)
    return out


def _merge(starts, ends):
    order = np.argsort(starts, kind="stable")
    merged = []
    for s, e in zip(starts[order], ends[order]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([int(s), int(e)])
    return merged


def _idle_gaps(merged, t_lo, t_hi, host_start, host_end, host_name):
    gaps = []
    prev = t_lo
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t_hi > prev:
        gaps.append((prev, t_hi))
    hs = np.asarray(host_start, dtype=np.int64)
    he = np.asarray(host_end, dtype=np.int64)
    order = np.argsort(hs, kind="stable")
    hs, he = hs[order], he[order]
    names = [host_name[i] for i in order]
    by = {}
    for s, e in gaps:
        if e - s < GAP_MIN_NS:
            key = "launch spacing (< 5 us)"
        else:
            key = _innermost(hs, he, names, (s + e) // 2)
        by[key] = by.get(key, 0.0) + (e - s) * 1e-9
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]


def _innermost(hs, he, names, t, reach=4096):
    """The host event with the latest start that still runs at time t."""
    j = int(np.searchsorted(hs, t, side="right")) - 1
    stop = max(-1, j - reach)
    while j > stop:
        if he[j] >= t:
            return names[j]
        j -= 1
    return "host Python (no profiled op)"


def count_syncs(fn, device) -> int | None:
    """Host synchronizations of fn(), by torch's sync debug mode; None off
    the card."""
    import torch

    if not str(device).startswith("cuda"):
        fn()
        return None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)
