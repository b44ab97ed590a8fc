"""The control of every cell's check comes out not correct: the reference
in bfloat16 put in the program's place. On the CPU at a small size; on the
card at each cell's own size and run length, three seeds."""

import json

import pytest

from portbench import calibrate
from portbench.lib import registry
from portbench.reference import judge
from portbench.tests.conftest import small_cell

CELLS = [w["name"] for w in registry.manifest()["workloads"]]


def _verdicts(cell, seed, device, seconds):
    run = registry.driver(cell["traffic"]["kind"]).make(cell, seed, device)
    run.setup()
    run.window(seconds)
    run.release()
    limits = cell["workload"]["limits"]
    sound, control = judge.Verdict(limits), judge.Verdict(limits)
    run.judge(sound)
    run.judge(control, control=True)
    return sound, control


@pytest.mark.parametrize("name", ["bnpc5k.chain1", "bnpc5k.job512"])
def test_control_fails_at_a_small_size(name):
    sound, control = _verdicts(small_cell(name), 2147483921, "cpu", 2)
    assert sound.correct, sound.checks()
    assert not control.correct
    assert control.worst["ml_rel_gap"] > control.limits["ml_rel_gap"]


@pytest.mark.parametrize("name", ["bnpc5k.chain1", "bnpc5k.job512"])
def test_calibrate_reads_control_and_faults_over_the_limits(name, tmp_path):
    out = tmp_path / "readings.jsonl"
    calibrate.main(["--workload", name, "--seconds", "2", "--seeds",
                    "2147483941", "--out", str(out)],
                   device="cpu", cell=small_cell(name))
    limits = registry.cell(name)["workload"]["limits"]
    got = json.loads(out.read_text().splitlines()[0])
    assert all(v <= limits[k] for k, v in got["program"].items())
    for way in ("control",) + calibrate.FAULTS:
        assert any(v > limits[k] for k, v in got[way].items()), way


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name, card, tmp_path):
    seconds = registry.manifest()["run_seconds"]
    out = tmp_path / "readings.jsonl"
    calibrate.main(["--workload", name, "--seconds", str(seconds),
                    "--seeds", "2147483931", "2147483932", "2147483933",
                    "--out", str(out)])
    limits = registry.cell(name)["workload"]["limits"]
    for line in out.read_text().splitlines()[:-1]:
        got = json.loads(line)
        assert all(v <= limits[k] for k, v in got["program"].items())
        assert any(v > limits[k] for k, v in got["control"].items())
        for fault in calibrate.FAULTS:
            assert any(v > limits[k] for k, v in got[fault].items()), fault
