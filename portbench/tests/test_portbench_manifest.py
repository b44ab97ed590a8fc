"""BENCHMARK.json against the benchmark's contract, and every cell found by
name: its workload, configuration, traffic, driver and metric files."""

import json
import re

import pytest

from portbench.lib import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                    r"projection|head|expansion|per_tok|n_muts")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def man():
    return registry.manifest()


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_top_level(man):
    assert set(man) == TOP
    assert (registry.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert man["paths"] == ["portbench"]
    assert 1 <= len(man["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in man["command"])
    assert isinstance(man["run_seconds"], int) and \
        1 <= man["run_seconds"] <= 51


def test_check_fits_with_24_cells(man):
    runs = 2 + 14 * 24
    total = runs * (man["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_and_units(man):
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in man[key]]
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads"):
        got = [x["name"] for x in man[key]]
        assert len(got) == len(set(got))
    metrics = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in man["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_entries_have_exactly_their_keys(man):
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTHS.search(k)
                   for k in c["reduced"])
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"])


def test_configs_are_used_and_their_files_agree(man):
    used = {w["config"] for w in man["workloads"]}
    files = set()
    for c in man["configs"]:
        assert c["name"] in used
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert c["file"] not in files
        files.add(c["file"])
        body = registry.config(c["name"])
        assert body["source"] == c["source"]
        assert body["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert key in body


def test_four_chip_cells_at_most_a_quarter(man):
    fours = sum(w["chips"] == 4 for w in man["workloads"])
    assert fours <= max(1, len(man["workloads"]) // 4)


def test_every_cell_reports_enough(man):
    for w in man["workloads"]:
        cell = registry.cell(w["name"])
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell["per_layer"]
        for m in cell["per_layer"]:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_setup_bound(man):
    setup = next(m for m in man["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25


@pytest.mark.parametrize("name", [w["name"] for w in
                                  registry.manifest()["workloads"]])
def test_cell_resolves_by_name(name):
    cell = registry.cell(name)
    wl = cell["workload"]
    assert set(wl["limits"]) >= {"mismatches", "ml_rel_gap", "map_rel_gap",
                                 "cell_gap_nats", "stuck_share"}
    assert wl["limits"]["mismatches"] == 0
    drv = registry.driver(cell["traffic"]["kind"])
    assert callable(drv.make)
    for m in cell["end_to_end"] + cell["per_layer"]:
        assert callable(registry.reader(m["name"]).read)


def test_every_metric_has_a_reader(man):
    for m in man["end_to_end"] + man["per_layer"]:
        assert callable(registry.reader(m["name"]).read)


def test_names_refuse_paths():
    for bad in ("../x", "a/b", " x", ""):
        with pytest.raises(ValueError):
            registry.check_name(bad)


def test_manifest_is_plain_json():
    text = (registry.ROOT / "BENCHMARK.json").read_text()
    assert json.loads(text) == registry.manifest()
