"""The port's tracer: spans and counters recorded inside bnpc_tpu_torch.

    from bnpc_tpu_torch import trace

    trace.enable(device_spans=True)
    ...                          # blocks of a runner, or a CLI job
    taken = trace.take()         # {"spans": [Span, ...], "counts": {...}}
    trace.disable()

It is off by default. Off, an instrumented site costs the test of
``trace.on`` (a host read calls ``read``, whose first statement is that
test): no span, event or counter is made. On, spans and counts are kept in
memory until ``take`` returns and clears them; nothing is written during a
run. The CLI's ``--profile DIR`` turns it on for the job and merges the
spans into the profiler's ``DIR/trace.json`` (``merge_chrome_trace``).

A span (``Span``) has a name, a start and an end in nanoseconds, its parent
(the index in ``take()["spans"]`` of the span open when it began, -1 for
none), a run id (one a ``MCMCRunner.run_chains`` call or CLI job; see
``new_run``) and a few attributes. Its clock is ``time.perf_counter_ns()``
plus an offset fixed at ``enable``: Unix-epoch nanoseconds, the clock of
torch.profiler's kineto events, so spans and profiled operations lie on
one timeline.

The spans, where they are made:

  * ``runner.block`` (``steps``, ``chains``): one block of one chain, or of
    a batch, opened by mcmc.py's one block loop (``_block_loop``), which
    every executor of ``_make_block`` runs (``_chain_block``,
    ``_CapturedBlock``, ``_batch_block``, ``_CapturedBatch``,
    ``_coupled_chains``);
  * ``runner.step`` (``step``; ``move`` gibbs / split / merge and
    ``do_dpa``, ``do_err`` for one chain, counts of each for a batch): one
    step inside its block;
  * ``runner.read`` (``reason``): a host read of a step (``read``), the
    host's wait for the device included; reasons ``select`` (the move
    uniforms), ``round`` (a round of the segment sweep), ``split`` (the
    split-or-merge choice), ``blocked_pass`` and ``blocked_cell`` (the
    blocked sweep), ``scan`` (the scan sweep's visit order). A captured
    batch reads its split flags together with its sweep's first round, a
    read counted as ``round`` (``blocked_pass``) where some chain sweeps;
  * ``runner.flush`` (``rows``): trace rows copied to the host;
  * ``graphs.eager``, ``graphs.replay`` (``key``, ``family``): a piece's
    first, eager run and its replays (graphs.py; the family is
    mcmc.py::piece_family's); ``graphs.capture`` (``key``, ``family``): a
    capture, the one timer of ``Pieces.capture_seconds``;
  * ``cli.main`` and its stages ``cli.load``, ``cli.pack``, ``cli.runner``
    (construction), ``cli.sample`` (``runner.run``), ``cli.estimate``,
    ``cli.write``;
  * ``build``: the kernel library's build or load (ops/_build.py).

With ``device_spans`` every ``graphs.eager`` and ``graphs.replay`` span is
also bracketed on the device by two CUDA timing events on the current
stream. ``take`` synchronizes once and sets each such span's ``device_ms``
(start event to end event) and ``gap_ms`` (the previous piece's end event
to this one's start event: device time between pieces, idle where nothing
else was queued). Nothing synchronizes inside a step.

One counter: ``sweeps`` (the chains swept by a segment sweep, lazy or
stream: the sweeps that make ``round`` reads); the reads are counted by
their spans. The kernel launch counters stay in ops/cuda_*.py and
``Pieces`` keeps its own.
"""

from __future__ import annotations

import json
import os
import time

import torch

on = False
# The chrome trace thread id the spans take (1 is init's: no thread of this
# process has it).
SPAN_TID = 1
_device = False
_offset = 0
_run = 0
_spans: list = []
_stack: list = []
_counts: dict = {}
_events: list = []


class Span:
    __slots__ = ("name", "start", "end", "parent", "run", "attrs")

    def __init__(self, name, start, parent, run, attrs):
        self.name, self.start, self.end = name, start, None
        self.parent, self.run, self.attrs = parent, run, attrs

    def __repr__(self):
        return (f"Span({self.name!r}, {self.start}, {self.end}, "
                f"parent={self.parent}, run={self.run}, {self.attrs})")


def device_event():
    """A CUDA event that records time (the device spans' bracket)."""
    return torch.cuda.Event(enable_timing=True)


def enable(device_spans: bool = False) -> None:
    """Start recording into an empty store; with `device_spans` each piece
    run is also timed on the device (the pieces must run on a CUDA
    device)."""
    global on, _device, _offset
    _clear()
    _device = bool(device_spans)
    _offset = time.time_ns() - time.perf_counter_ns()
    on = True


def disable() -> None:
    """Stop recording; what was recorded waits for ``take``."""
    global on
    on = False


def _clear() -> None:
    global _spans, _stack, _counts, _events
    _spans, _stack, _counts, _events = [], [], {}, []


def take() -> dict:
    """{"spans": every span recorded since ``enable`` or the last take, in
    the order they began, "counts": the counters}, the device spans'
    times resolved; the store is cleared. Call it between runs, with no
    span open."""
    if _events:
        torch.cuda.synchronize()
        prev = None
        for sp, e0, e1 in _events:
            sp.attrs["device_ms"] = e0.elapsed_time(e1)
            if prev is not None:
                sp.attrs["gap_ms"] = prev.elapsed_time(e0)
            prev = e1
    out = {"spans": _spans, "counts": _counts}
    _clear()
    return out


def now() -> int:
    return time.perf_counter_ns() + _offset


def new_run() -> None:
    """Start a new run id, unless a span is open (a CLI job's runs keep
    the job's id)."""
    global _run
    if not _stack:
        _run += 1


def begin(name: str, **attrs) -> Span:
    """Open span `name` as a child of the innermost open span."""
    sp = Span(name, now(), _stack[-1] if _stack else -1, _run, attrs)
    _stack.append(len(_spans))
    _spans.append(sp)
    return sp


def end(sp: Span) -> None:
    """Close `sp` (and any span left open inside it)."""
    sp.end = now()
    while _stack and _spans[_stack.pop()] is not sp:
        pass


class _Open:
    __slots__ = ("sp",)

    def __init__(self, sp):
        self.sp = sp

    def __enter__(self):
        return self.sp

    def __exit__(self, *exc):
        end(self.sp)
        return False


class _Null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def span(name: str, **attrs):
    """``with trace.span(name, ...)``: a span around the block, nothing when
    off (for cold paths; hot sites test ``trace.on`` and call begin and
    end)."""
    return _Open(begin(name, **attrs)) if on else _NULL


def record(name: str, t0: int, t1: int, **attrs) -> None:
    """A finished span from two ``time.perf_counter_ns()`` readings, a
    child of the innermost open span."""
    sp = Span(name, t0 + _offset, _stack[-1] if _stack else -1, _run, attrs)
    sp.end = t1 + _offset
    _spans.append(sp)


def count(name: str, n: int = 1) -> None:
    _counts[name] = _counts.get(name, 0) + n


def read(t: torch.Tensor, reason: str) -> list:
    """``t.tolist()``, a host read of a step; on, inside a ``runner.read``
    span."""
    if not on:
        return t.tolist()
    sp = begin("runner.read", reason=reason)
    try:
        return t.tolist()
    finally:
        end(sp)


def piece(name: str, key: tuple, family: str, fn) -> None:
    """Run `fn` (a piece's eager run or its graph's replay) inside span
    `name`, bracketed by device events with device spans on."""
    sp = begin(name, key=key, family=family)
    try:
        if _device:
            e0, e1 = device_event(), device_event()
            e0.record()
            fn()
            e1.record()
            _events.append((sp, e0, e1))
        else:
            fn()
    finally:
        end(sp)


def _step_span() -> Span | None:
    for i in reversed(_stack):
        if _spans[i].name == "runner.step":
            return _spans[i]
    return None


def note_flags(flags) -> None:
    """The move flags of the open step (select's (do_sm, do_dpa, do_err) a
    chain): one chain's as they are, a batch's as counts."""
    sp = _step_span()
    if sp is None:
        return
    if len(flags) == 1:
        do_sm, do_dpa, do_err = flags[0]
        sp.attrs.update(move="split_merge" if do_sm else "gibbs",
                        do_dpa=bool(do_dpa), do_err=bool(do_err))
    else:
        sp.attrs.update(move="batch", chains=len(flags),
                        **{k: sum(bool(f[j]) for f in flags) for j, k in
                           enumerate(("split_merge", "do_dpa", "do_err"))})


def note_split(split) -> None:
    """The split-or-merge choice of the open step's split-merge chains."""
    sp = _step_span()
    if sp is None:
        return
    if sp.attrs.get("move") != "batch":
        sp.attrs["move"] = "split" if split[0] else "merge"
    else:
        sp.attrs.update(split=sum(map(bool, split)),
                        merge=sum(not s for s in split))


def merge_chrome_trace(path: str, spans) -> None:
    """Append `spans` to the chrome trace at `path` (torch.profiler's
    export) on its own time base, as complete events of one named thread
    of this process (``SPAN_TID``, no thread of the OS's)."""
    with open(path) as fh:
        doc = json.load(fh)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid, tid = os.getpid(), SPAN_TID
    events = doc.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                   "args": {"name": "bnpc_tpu_torch spans"}})
    for sp in spans:
        if sp.end is None:
            continue
        events.append({
            "ph": "X", "cat": "bnpc_tpu_torch", "name": sp.name, "pid": pid,
            "tid": tid, "ts": (sp.start - base) / 1e3,
            "dur": (sp.end - sp.start) / 1e3,
            "args": {"run": sp.run, **{k: v if isinstance(
                v, (bool, int, float, str)) else str(v)
                for k, v in sp.attrs.items()}}})
    with open(path, "w") as fh:
        json.dump(doc, fh)
