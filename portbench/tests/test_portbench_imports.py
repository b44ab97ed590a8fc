"""What the harness loads: never JAX or the JAX package, never the files
that measure the JAX package; and no result without a card."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BANNED = re.compile(r"^\s*(?:from|import)\s+(?:jax|jaxlib|flax|chip_smoke|"
                    r"benchmarks|bench|bnpc_tpu)(?:\s|\.|$)", re.M)

LOAD_ALL = """
import sys
sys.path.insert(0, {root!r})
from portbench import run, calibrate
from portbench.lib import device, registry
from portbench.lib import spans
import bnpc_tpu_torch.cli, bnpc_tpu_torch.mcmc
man = registry.manifest()
for w in man["workloads"]:
    registry.driver(registry.cell(w["name"])["traffic"]["kind"])
for m in man["end_to_end"] + man["per_layer"]:
    registry.reader(m["name"])
with spans.Spans("cpu", timed=False):
    pass
print(device.forbidden_modules())
"""


def test_harness_and_port_load_no_jax():
    out = subprocess.run([sys.executable, "-c",
                          LOAD_ALL.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_source_imports_what_the_port_may_not_use():
    for path in (ROOT / "portbench").rglob("*.py"):
        assert not BANNED.search(path.read_text()), path


def test_forbidden_names_compare_whole():
    from portbench.lib import device

    saved = dict(sys.modules)
    try:
        sys.modules["bnpc_tpu_torch_like"] = sys
        sys.modules["jaxish"] = sys
        assert "bnpc_tpu" not in device.forbidden_modules()
        assert "jax" not in device.forbidden_modules()
        sys.modules["bnpc_tpu.mcmc"] = sys
        assert "bnpc_tpu" in device.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def _run(cwd):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "bnpc5k.chain1",
         "--seed", "2147483901", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_no_result_without_a_card():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_no_result_from_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
