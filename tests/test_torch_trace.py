"""The tracer (bnpc_tpu_torch/trace.py) on the CPU.

The same runs as the captured-graph tests (tests/test_torch_graphs.py and
tests/test_torch_graphs_batched.py, their stand-ins for the CUDA graph)
with the tracer off and on: the eager one-chain block (``_chain_block``
over the eager step), the captured one-chain block and the captured batch
of three chains. Off, no span is made (the span constructor is patched to
fail); on, the runs give the same bits, and the spans nest and agree with
the counter, the trace rows and ``Pieces``; every captured form (stream,
blocked and eager sweeps too) names a family for each of its pieces. Device spans run here on stand-in events
that read the host clock. Torch only; nothing of bnpc_tpu.
"""

import importlib.util
import json
import time

import numpy as np
import pytest
import torch

from bnpc_tpu_torch import cli, trace
from bnpc_tpu_torch import mcmc as port_mcmc
from bnpc_tpu_torch.draws import TorchDraws
from tests import test_torch_graphs as one
from tests import test_torch_graphs_batched as batch
from tests import test_torch_graphs_blocked as blocked

torch.set_num_threads(1)

FORMS = ("eager", "captured", "batch")


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


def _form(name):
    """(run, made): run() gives a run's (states, rows, draws); made()
    the block object, if any, whose pieces the run used."""
    if name == "eager":
        step = one._eager_step("lazy")
        return (lambda: one._run(
            lambda *a: port_mcmc._chain_block(step, *a),
            TorchDraws(11, "cpu")), lambda: None)
    if name == "captured":
        block = one._captured("lazy")
        return lambda: one._run(block.run, TorchDraws(11, "cpu")), \
            lambda: block
    b = batch._captured("lazy")
    return lambda: batch._run(b.run, 3), lambda: b


class Refused(Exception):
    pass


def _refuse(*args, **kwargs):
    raise Refused("made while the tracer is off")


_RUNS = {}


def _runs(name):
    """The form's run with the tracer off (Span and the device event
    patched to fail), then on: (off, on, taken, block)."""
    if name not in _RUNS:
        run, _ = _form(name)
        saved = trace.Span, trace.device_event
        trace.Span = trace.device_event = _refuse
        try:
            off = run()
        finally:
            trace.Span, trace.device_event = saved
        assert trace.take() == {"spans": [], "counts": {}}
        run, made = _form(name)
        trace.enable()
        on = run()
        trace.disable()
        _RUNS[name] = (off, on, trace.take(), made())
    return _RUNS[name]


def _steps(blocks):
    return sum(n if keep is None else keep for n, keep in blocks)


def _same(a, b):
    (sa, ra, da), (sb, rb, db) = a, b
    for f in port_mcmc.TraceRow._fields:
        np.testing.assert_array_equal(ra[f], rb[f], err_msg=f)
    sa, sb = (sa, sb) if isinstance(sa, list) else ([sa], [sb])
    da, db = (da, db) if isinstance(da, list) else ([da], [db])
    for x, y in zip(sa, sb):
        for f, u, v in zip(port_mcmc.CRPState._fields, x, y):
            assert torch.equal(u, v), f
    for x, y in zip(da, db):
        assert torch.equal(x.gen.get_state(), y.gen.get_state())


def test_off_by_default_records_nothing():
    """A fresh copy of the module is off with an empty store."""
    spec = importlib.util.spec_from_file_location("fresh_trace",
                                                  trace.__file__)
    fresh = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fresh)
    assert fresh.on is False
    assert fresh.take() == {"spans": [], "counts": {}}


@pytest.mark.parametrize("name", FORMS)
def test_off_makes_no_span(name):
    """Off, a whole run makes no span and no device event: it ran with
    their constructors patched to raise (``_runs``)."""
    (_, rows, _), _, _, _ = _runs(name)
    assert rows["ml"].size >= 8


@pytest.mark.parametrize("name", FORMS)
def test_on_gives_the_same_bits(name):
    """Tracing on and off: the same rows, states and generator states."""
    off, on, taken, _ = _runs(name)
    _same(off, on)
    steps = [s for s in taken["spans"] if s.name == "runner.step"]
    assert len(steps) == _steps(batch.BLOCKS if name == "batch"
                                else one.BLOCKS)


@pytest.mark.parametrize("name", FORMS)
def test_spans_nest(name):
    """Every read lies inside a step, every step inside a block of the
    same run id, and every span inside its parent."""
    spans = _runs(name)[2]["spans"]

    def ancestors(s):
        while s.parent >= 0:
            s = spans[s.parent]
            yield s

    for s in spans:
        assert s.end is not None and s.end >= s.start, s
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start <= s.start and s.end <= p.end, (s, p)
            assert p.run == s.run
        if s.name == "runner.read":
            assert any(a.name == "runner.step" for a in ancestors(s)), s
        if s.name == "runner.step":
            assert spans[s.parent].name == "runner.block", s
    names = {s.name for s in spans}
    assert {"runner.block", "runner.step", "runner.read",
            "runner.flush"} <= names
    if name != "eager":
        assert {"graphs.eager", "graphs.capture", "graphs.replay"} <= names


@pytest.mark.parametrize("name", FORMS)
def test_reads_equal_their_counters(name):
    """The read spans by reason (the reads' one count) against what the
    run counts otherwise: a select read a step, a round read or more a
    one-chain sweep (the counter ``sweeps``), a split read a one-chain
    split-merge step. Kernel 1's counters: every position of every sweep
    (``lazy_cells``), and no full pick (``lazy_full_picks``), since the
    CPU runs the plain twin, which counts none."""
    taken = _runs(name)[2]
    by = {}
    for s in taken["spans"]:
        if s.name == "runner.read":
            by[s.attrs["reason"]] = by.get(s.attrs["reason"], 0) + 1
    steps = [s for s in taken["spans"] if s.name == "runner.step"]
    assert set(taken["counts"]) == {"sweeps", "lazy_cells",
                                    "lazy_full_picks"}
    assert taken["counts"]["lazy_cells"] == one.N * taken["counts"]["sweeps"]
    assert taken["counts"]["lazy_full_picks"] == 0
    assert by["select"] == len(steps)
    assert by["round"] > 0 and taken["counts"]["sweeps"] > 0
    if name != "batch":
        # A sweep of one chain reads at least one round.
        assert by["round"] >= taken["counts"]["sweeps"]
        assert by.get("split", 0) == sum(
            s.attrs["move"] in ("split", "merge") for s in steps)


@pytest.mark.parametrize("name", ["eager", "captured"])
def test_steps_carry_their_move(name):
    """A one-chain step's move kind and flags, against its trace row's
    move counts; a sweep a Gibbs step."""
    (_, rows, _), _, taken, _ = _runs(name)
    steps = [s for s in taken["spans"] if s.name == "runner.step"]
    assert len(steps) == len(rows["mh_counts"])
    for s, counts in zip(steps, rows["mh_counts"]):
        split, merge = counts[1].sum() > 0, counts[2].sum() > 0
        want = "split" if split else "merge" if merge else "gibbs"
        assert s.attrs["move"] == want
        assert s.attrs["do_err"] == bool(counts[3:5].sum() > 0)
    assert taken["counts"]["sweeps"] == sum(s.attrs["move"] == "gibbs"
                                            for s in steps)


def test_batch_steps_count_their_moves():
    (_, rows, _), _, taken, _ = _runs("batch")
    steps = [s for s in taken["spans"] if s.name == "runner.step"]
    counts = np.swapaxes(rows["mh_counts"], 0, 1)  # [steps, chains, 5, 2]
    for s, c in zip(steps, counts):
        assert s.attrs["move"] == "batch" and s.attrs["chains"] == 3
        split = int((c[:, 1].sum(-1) > 0).sum())
        merge = int((c[:, 2].sum(-1) > 0).sum())
        assert s.attrs["split_merge"] == split + merge
        assert s.attrs.get("split", 0) == split
        assert s.attrs.get("merge", 0) == merge


@pytest.mark.parametrize("name", ["captured", "batch"])
def test_capture_spans_sum_to_capture_seconds(name):
    _, _, taken, block = _runs(name)
    caps = [s for s in taken["spans"] if s.name == "graphs.capture"]
    assert len(caps) == len(block.pieces.graphs)
    assert sum(s.end - s.start for s in caps) * 1e-9 == pytest.approx(
        block.pieces.capture_seconds, rel=1e-9)
    assert {s.attrs["key"] for s in caps} == set(block.pieces.graphs)


def _family_run(name):
    """(taken, block) of a captured form run with the tracer on: the
    lazy forms of ``_runs``, and the stream, blocked and eager sweeps."""
    if name in FORMS:
        _, _, taken, block = _runs(name)
        return taken, block
    if name == "captured_stream":
        block = one._captured("stream")
        args = one._run, TorchDraws(11, "cpu")
    elif name == "captured_blocked":
        block, args = blocked._captured("blocked"), (blocked._run,)
    elif name == "captured_eager":
        block = blocked._captured("eager", mix=blocked.MIX)
        args = (blocked._run,)
    elif name == "batch_stream":
        block, args = batch._captured("stream"), (batch._run, 3)
    else:
        block, args = blocked._captured_batch(), (blocked._run, 3)
    trace.enable()
    args[0](block.run, *args[1:])
    trace.disable()
    return trace.take(), block


@pytest.mark.parametrize("name", [
    "captured", "batch", "captured_stream", "captured_blocked",
    "captured_eager", "batch_stream", "batch_blocked"])
def test_every_piece_has_a_family(name):
    """Each key a captured form runs is named in
    mcmc.py::PIECE_FAMILIES, and its spans carry that family."""
    taken, block = _family_run(name)
    listed = {k for keys in port_mcmc.PIECE_FAMILIES.values() for k in keys}
    assert block.pieces.seen and {k[0] for k in block.pieces.seen} <= listed
    spans = [s for s in taken["spans"] if s.name.startswith("graphs.")]
    assert {s.attrs["key"] for s in spans} == block.pieces.seen
    for s in spans:
        assert s.attrs["family"] == port_mcmc.piece_family(s.attrs["key"])
    families = {s.attrs["family"] for s in spans}
    assert {"sweep", "rest"} <= families


def test_piece_without_a_family_raises():
    """A key left out of PIECE_FAMILIES is an error, not "rest", once the
    tracer names its family."""
    with pytest.raises(KeyError, match="no family"):
        port_mcmc.piece_family(("unlisted", 1))
    pieces = port_mcmc.graphs.Pieces(None, port_mcmc.piece_family,
                                     graph_cls=None)
    pieces.run(("unlisted",), lambda: None)  # off: no family asked
    trace.enable()
    with pytest.raises(KeyError, match="no family"):
        pieces.run(("unlisted", 2), lambda: None)


def test_span_clock_is_unix_epoch():
    trace.enable()
    t0 = time.time_ns()
    with trace.span("probe"):
        pass
    t1 = time.time_ns()
    sp = trace.take()["spans"][0]
    assert t0 <= sp.start <= sp.end <= t1


class HostEvent:
    """A stand-in for torch.cuda.Event that reads the host clock."""

    def record(self):
        self.t = time.perf_counter_ns()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e-6


def test_device_spans_time_every_piece(monkeypatch):
    """Every eager run and replay gets its device ms and, after the
    first, the gap from the previous piece; pieces and gaps tile the
    time from the first start event to the last end event."""
    monkeypatch.setattr(trace, "device_event", HostEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    block = one._captured("lazy")
    trace.enable(device_spans=True)
    one._run(block.run, TorchDraws(11, "cpu"))
    taken = trace.take()
    timed = [s for s in taken["spans"]
             if s.name in ("graphs.eager", "graphs.replay")]
    assert len(timed) == block.pieces.replays + block.pieces.eager_runs
    assert "gap_ms" not in timed[0].attrs
    assert all(s.attrs["device_ms"] >= 0 for s in timed)
    assert all(s.attrs["gap_ms"] >= 0 for s in timed[1:])
    total = sum(s.attrs["device_ms"] + s.attrs.get("gap_ms", 0.0)
                for s in timed)
    assert total <= (timed[-1].end - timed[0].start) * 1e-6
    assert not any("device_ms" in s.attrs for s in taken["spans"]
                   if s.name == "graphs.capture")


def test_run_ids():
    """One run id a run_chains call; a CLI job's runs keep the job's."""
    runner = port_mcmc.MCMCRunner(one.CFG, one.MIX, one.DATA, "cpu",
                                  block_size=4)
    states = runner.init_chains(TorchDraws(2, "cpu"), 2)
    draws = [TorchDraws(5, "cpu"), TorchDraws(6, "cpu")]
    trace.enable()
    states, _, draws = runner.run_chains(states, draws, 4)
    runner.run_chains(states, draws, 4)
    spans = trace.take()["spans"]
    blocks = [s for s in spans if s.name == "runner.block"]
    assert len(blocks) == 4
    assert blocks[0].run == blocks[1].run != blocks[2].run == blocks[3].run


def test_profile_writes_program_spans(tmp_path):
    """--profile DIR on the CPU: DIR/trace.json holds the profiler's
    events and the job's spans, cli.sample over the sampling's events."""
    rng = np.random.default_rng(0)
    x = (rng.random((12, 6)) < 0.3).astype(int)
    data = tmp_path / "d.csv"
    np.savetxt(data, x, delimiter=",", fmt="%d")
    prof = tmp_path / "prof"
    cli.main(cli.parse_args([str(data), "--device", "cpu", "-s", "4", "-np",
                             "-o", str(tmp_path / "out"), "-v", "0",
                             "--profile", str(prof)]))
    assert not trace.on
    doc = json.loads((prof / "trace.json").read_text())
    ours = [e for e in doc["traceEvents"] if e.get("cat") == "bnpc_tpu_torch"]
    names = {e["name"] for e in ours}
    assert {"cli.main", "cli.load", "cli.pack", "cli.runner", "cli.sample",
            "cli.estimate", "cli.write", "runner.block", "runner.step",
            "runner.read"} <= names
    assert sum(e["name"] == "runner.step" for e in ours) == 4
    sample = next(e for e in ours if e["name"] == "cli.sample")
    ops = [e for e in doc["traceEvents"] if e.get("cat") == "cpu_op"]
    assert ops
    assert all(sample["ts"] <= e["ts"] and e["ts"] + e["dur"]
               <= sample["ts"] + sample["dur"] for e in ops)


def test_build_span_sets_build_seconds(monkeypatch, tmp_path):
    """The kernel library's build and load is the ``build`` span, and
    build_seconds its length (stand-ins for nvcc and the library here)."""
    from bnpc_tpu_torch.ops import _build

    class Fn:
        pass

    class Lib:
        def __getattr__(self, name):
            return Fn()

    built = []
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build_seconds", _build.build_seconds)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_build", lambda srcs, so: built.append(so))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: Lib())
    trace.enable()
    _build.load_library()
    spans = trace.take()["spans"]
    assert [s.name for s in spans] == ["build"] and built
    assert spans[0].attrs == {"built": True}
    assert _build.build_seconds == pytest.approx(
        (spans[0].end - spans[0].start) * 1e-9, rel=1e-9)

