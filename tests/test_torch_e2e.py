"""tests/test_e2e.py's cases on the port's CLI.

Each case runs as written in tests/test_e2e.py with its ``cli`` module
swapped for the port's (tests/test_torch_cli.py's pattern), every argument
list given ``--device cpu``. The --debug case patches the port's
``bnpc_tpu_torch.mcmc.update_parameters`` where it names bnpc_tpu's. The
four cases tests/test_e2e.py marks slow stay slow; its --mesh 2,4 case runs
as eight gloo CPU ranks started by the port's CLI, one CPU thread each (as
tests/test_torch_cli.py::test_mesh_cli_writes_once).
"""

import inspect

import pytest

from bnpc_tpu_torch import cli as port_cli
from tests import test_e2e


class _PortCli:
    """The port's cli with --device cpu on every argument list."""

    @staticmethod
    def parse_args(argv):
        return port_cli.parse_args(list(argv) + ["--device", "cpu"])

    main = staticmethod(port_cli.main)


class _PortPatch:
    """A monkeypatch whose dotted targets in bnpc_tpu name the port's."""

    def __init__(self, monkeypatch):
        self._mp = monkeypatch

    def setattr(self, target, *args, **kwargs):
        if isinstance(target, str) and target.startswith("bnpc_tpu."):
            target = "bnpc_tpu_torch." + target[len("bnpc_tpu."):]
        return self._mp.setattr(target, *args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._mp, name)


SLOW = ("test_cli_end_to_end", "test_cli_learned_errors_and_plots",
        "test_cli_single_chains_posterior", "test_cli_mesh_lugsail")
CASES = ("test_cli_mesh_validation", "test_cli_debug_is_eager")


@pytest.mark.parametrize("case", list(CASES) + [
    pytest.param(name, marks=pytest.mark.slow) for name in SLOW])
def test_e2e_case_on_port(case, tmp_path, monkeypatch):
    monkeypatch.setattr(test_e2e, "cli", _PortCli)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    fn = getattr(test_e2e, case)
    kwargs = {"tmp_path": tmp_path, "monkeypatch": _PortPatch(monkeypatch)}
    fn(**{name: kwargs[name]
          for name in inspect.signature(fn).parameters})


def test_cases_cover_test_e2e():
    """Every case of tests/test_e2e.py runs here, slow as it is there."""
    names = {name for name in dir(test_e2e) if name.startswith("test_")}
    assert names == set(CASES) | set(SLOW)
    for name in names:
        marks = {m.name for m in getattr(getattr(test_e2e, name),
                                         "pytestmark", [])}
        assert ("slow" in marks) == (name in SLOW), name
