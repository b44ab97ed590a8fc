"""Shared helpers of the benchmark's tests.

Tests that need the card carry the ``cuda`` marker registered here and
decide inside the test, never at import, whether there is one. Run them on
the card with ``python3 -m pytest portbench/tests -m cuda``.
"""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs at its own size there")
    return "cuda:0"


def small_cell(name: str) -> dict:
    """Cell `name` as registry.cell gives it, at a size a CPU test holds:
    400 cells at the configuration's own 200 loci, 4 clones, 32 slots,
    32-step blocks."""
    from portbench.lib import registry

    cell = copy.deepcopy(registry.cell(name))
    cell["config"]["data"].update(n_cells=400, clones=4)
    cell["config"]["model"]["k_max"] = 32
    if cell["traffic"]["kind"] == "chains":
        cell["traffic"]["block"] = 32
        cell["workload"]["warmup_steps"] = 64
    else:
        cell["traffic"]["steps"] = 48
    return cell
