"""Finds the benchmark's parts by name.

``BENCHMARK.json`` at the checkout's root lists the cells and metrics. A
cell ``<name>`` is ``portbench/workloads/<name>.json``; it names its
configuration ``portbench/configs/<config>.json`` and its traffic mix
``portbench/traffic/<traffic>.json``, whose ``kind`` names the driver
``portbench/drivers/<kind>.py``. A metric ``<name>`` is read by
``portbench/metrics/<name>.py``. Adding any of them is adding files.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def manifest() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def config(name: str) -> dict:
    return _json(BENCH_DIR / "configs" / f"{check_name(name)}.json")


def traffic(name: str) -> dict:
    return _json(BENCH_DIR / "traffic" / f"{check_name(name)}.json")


def workload(name: str) -> dict:
    return _json(BENCH_DIR / "workloads" / f"{check_name(name)}.json")


def _module(path: Path, label: str):
    if not path.is_file():
        raise FileNotFoundError(f"{label}: no file {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{label}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str):
    """The traffic kind's driver module (``make(cell)`` -> a run)."""
    return _module(BENCH_DIR / "drivers" / f"{check_name(kind)}.py",
                   "driver")


def reader(metric: str):
    """The metric's reader module (``read(obs)`` -> a number or None)."""
    return _module(BENCH_DIR / "metrics" / f"{check_name(metric)}.py",
                   "metric")


def cell(name: str) -> dict:
    """Everything a run of cell `name` needs: its BENCHMARK.json entry,
    its workload file, its configuration and its traffic mix, and the
    metrics it reports with and without the trace."""
    man = manifest()
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    wl = workload(name)
    for key in ("config", "traffic"):
        if wl[key] != entry[key]:
            raise ValueError(f"{name}: {key} {wl[key]!r} in its workload "
                             f"file, {entry[key]!r} in BENCHMARK.json")

    def applies(metric):
        return name in metric.get("workloads", [name])

    return {
        "name": name,
        "chips": int(entry["chips"]),
        "workload": wl,
        "config": config(entry["config"]),
        "traffic": traffic(entry["traffic"]),
        "end_to_end": [m for m in man["end_to_end"] if applies(m)],
        "per_layer": [m for m in man["per_layer"] if applies(m)],
    }
