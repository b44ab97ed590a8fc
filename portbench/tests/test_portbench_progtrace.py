"""lib/progtrace.py on synthetic spans and intervals, and
program_trace.py's segments on the CPU at a small size (on the card at each
chain cell's size with ``-m cuda``)."""

import json
from types import SimpleNamespace

import pytest

from portbench import program_trace
from portbench.lib import progtrace, registry
from portbench.tests.conftest import small_cell


def _span(name, start, end, parent=-1, **attrs):
    return SimpleNamespace(name=name, start=start, end=end, parent=parent,
                           attrs=attrs)


def _step_spans():
    """One block of two steps (times in ns):

        block 0-1000
          step 0-500: read 100-300, replay 300-350 (sweep, 0.2 ms on the
            device, first piece), capture 350-380
          step 500-1000: three round reads 600-700, 700-800, 800-900,
            eager 900-950 (rest, 0.1 ms, 0.05 ms after the replay's end
            event)
    """
    return [
        _span("runner.block", 0, 1000),
        _span("runner.step", 0, 500, 0, move="gibbs"),
        _span("runner.read", 100, 300, 1, reason="select"),
        _span("graphs.replay", 300, 350, 1, key=("sweep_head",),
              family="sweep", device_ms=0.2),
        _span("graphs.capture", 350, 380, 1, key=("rest", False, False),
              family="rest"),
        _span("runner.step", 500, 1000, 0, move="split"),
        _span("runner.read", 600, 700, 5, reason="round"),
        _span("runner.read", 700, 800, 5, reason="round"),
        _span("runner.read", 800, 900, 5, reason="round"),
        _span("graphs.eager", 900, 950, 5, key=("rest", True, False),
              family="rest", device_ms=0.1, gap_ms=0.05),
    ]


def test_summarize_on_synthetic_spans():
    taken = {"spans": _step_spans(),
             "counts": {"sweeps": 2}}
    got = progtrace.summarize(taken, steps=2)
    assert got["step_ms"] == pytest.approx(1000e-6)
    assert got["read_ms"] == pytest.approx(500e-6)
    assert got["dispatch_ms"] == pytest.approx(500e-6)
    assert got["capture_s"] == pytest.approx(30e-9)
    assert got["pieces"] == 2 and got["gap_ms"] == pytest.approx(0.05)
    assert got["reads"] == {"select": 1, "round": 3}
    assert got["by_move"] == {"gibbs": [1, pytest.approx(500e-6)],
                              "split": [1, pytest.approx(500e-6)]}
    assert got["device_ms"] == pytest.approx({"sweep": 0.2,
                                              "split_merge": 0.0,
                                              "rest": 0.1})
    r = progtrace.readings(got, None)
    assert r["read_wait_ms_per_step"] == pytest.approx(250e-6)
    assert r["dispatch_ms_per_step"] == pytest.approx(250e-6)
    assert r["round_reads_per_sweep"] == pytest.approx(1.5)
    assert r["device_ms_per_step.sweep"] == pytest.approx(0.1)
    assert r["device_ms_per_step.rest"] == pytest.approx(0.05)
    assert r["device_gap_ms_per_step"] == pytest.approx(0.025)
    assert "idle_in_dispatch.sample" not in r


def test_readings_leave_out_what_was_not_timed():
    spans = _step_spans()
    for s in spans:
        s.attrs.pop("device_ms", None)
    got = progtrace.summarize({"spans": spans, "counts": {}}, steps=2)
    r = progtrace.readings(got, None)
    assert r["device_ms_per_step.sweep"] is None
    assert r["device_gap_ms_per_step"] is None
    assert r["round_reads_per_sweep"] is None


def test_idle_gaps_of_merged_intervals():
    assert progtrace.idle_gaps([[10, 20], [30, 40]], 0, 50) == [
        (0, 10), (20, 30), (40, 50)]
    assert progtrace.idle_gaps([[0, 60]], 5, 50) == []
    assert progtrace.idle_gaps([], 5, 50) == [(5, 50)]


def test_join_gives_each_gap_to_its_innermost_span():
    """Gaps whose middles fall in a read, in a step outside its reads, in
    a block between steps and outside every span."""
    spans = _step_spans()
    # Busy: 0-150, 200-400 (gap mid 175: the read of step 0), 460-550 (gap
    # 400-460, mid 430: step 0 outside reads), 650-1040 (gap 550-650, mid
    # 600: step 1 at its read's start instant counts as the read), then
    # idle 1040-1100 outside every span.
    prof = {"busy": [[0, 150], [200, 400], [460, 550], [650, 1040]],
            "t_lo": 0, "t_hi": 1100,
            "graph_launches": [(310, 320), (960, 970)]}
    got = progtrace.join({"spans": spans, "counts": {}}, prof)
    assert got["idle_s"] == pytest.approx((50 + 60 + 100 + 60) * 1e-9)
    assert got["read_s"] == pytest.approx((50 + 100) * 1e-9)
    assert got["dispatch_s"] == pytest.approx(60 * 1e-9)
    assert got["by_span"] == pytest.approx({
        "runner.read": 150e-9, "runner.step": 60e-9,
        "outside the program's spans": 60e-9})
    # One of the two launches lies in a replay span.
    assert got["launch_cover"] == pytest.approx(0.5)
    r = progtrace.readings(None, got)
    assert r["idle_in_dispatch.sample"] == pytest.approx(100 * 60 / 270)
    assert r["idle_in_sample.job"] == 0.0


def test_join_counts_the_idle_inside_sampling():
    spans = [_span("cli.main", 0, 100), _span("cli.sample", 10, 60, 0),
             _span("runner.block", 20, 50, 1),
             _span("cli.estimate", 60, 90, 0)]
    prof = {"busy": [[0, 10], [30, 40], [70, 80]], "t_lo": 0, "t_hi": 100,
            "graph_launches": []}
    got = progtrace.join({"spans": spans, "counts": {}}, prof)
    # Gaps 10-30 (mid 20: block), 40-70 (mid 55: sample), 80-100 (mid 90:
    # main at the estimate's end instant counts as the estimate).
    assert got["sample_s"] == pytest.approx(50e-9)
    assert got["by_span"] == pytest.approx({
        "runner.block": 20e-9, "cli.sample": 30e-9, "cli.estimate": 20e-9})
    assert got["launch_cover"] is None
    assert progtrace.readings(None, got)["idle_in_sample.job"] == \
        pytest.approx(100 * 50 / 70)


@pytest.mark.parametrize("name", ["bnpc5k.chain1", "bnpc5k.job512"])
def test_segments_at_a_small_size(name, capsys):
    """Both segments run on the CPU and are correct; a chains cell's block
    gives the same bits with the tracer off and on."""
    program_trace.main(["--workload", name, "--seed", "2147483999"],
                       device="cpu", cell=small_cell(name))
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["correct"], got["checks"]
    r = got["readings"]
    assert r["read_wait_ms_per_step"] > 0 and r["dispatch_ms_per_step"] > 0
    # No device spans on the CPU.
    assert r["device_gap_ms_per_step"] is None
    if name == "bnpc5k.chain1":
        assert got["same_bits"] is True
        assert got["program"]["reads"]["select"] == 32
    else:
        assert got["program"]["reads"]["select"] == 48


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bnpc5k.chain1", "bnpc5k.chains4"])
def test_segments_at_the_cells_size(name, card, capsys):
    program_trace.main(["--workload", name, "--seed", "2147483998"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["correct"] and got["same_bits"]
    assert all(v is not None for v in got["readings"].values())
    assert got["profiled"]["launch_cover"] > 0.95
    assert registry.cell(name)["traffic"]["kind"] == "chains"
