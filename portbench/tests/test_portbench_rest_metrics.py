"""The readers of error_mh_launches_per_step and trace_row_launches_per_step
on fake observations (every stage of a kernel counts), and the kernels'
names among the port's hand-written kernels (which small_kernel_ms_per_step
leaves out)."""

import pytest

from portbench.lib import devtrace, registry
from portbench.tests.conftest import ROOT

# The profiler's names of each kernel's stages and of two other kernels.
STAGES = {
    "error_mh_launches_per_step": [
        f"void (anonymous namespace)::error_mh_kernel<{s}>("
        "(anonymous namespace)::Args)" for s in range(3)],
    "trace_row_launches_per_step": [
        f"void (anonymous namespace)::trace_row_kernel<{s}>("
        "(anonymous namespace)::Args)" for s in range(2)],
}
MH = "void (anonymous namespace)::mh_sweep_kernel<false>(" \
     "(anonymous namespace)::Args)"
ELEMENTWISE = "void at::native::vectorized_elementwise_kernel<4, " \
              "at::native::CUDAFunctorOnSelf_add<float>>(int)"
NAMES = sorted(STAGES)


def _obs(kernels, steps=256):
    return {"trace_steps": steps, "profile": {"kernels": kernels}}


@pytest.mark.parametrize("name", NAMES)
def test_counts_every_stage_over_the_steps(name):
    read = registry.reader(name).read
    kernels = {MH: [900, 0.02], ELEMENTWISE: [5000, 0.01]}
    for i, stage in enumerate(STAGES[name]):
        kernels[stage] = [64 + i, 0.001]
    launched = sum(64 + i for i in range(len(STAGES[name])))
    assert read(_obs(kernels)) == launched / 256
    assert read(_obs(kernels, steps=1024)) == launched / 1024


@pytest.mark.parametrize("name", NAMES)
def test_none_without_the_kernel_or_the_steps(name):
    read = registry.reader(name).read
    other = STAGES[NAMES[1 - NAMES.index(name)]][0]
    assert read(_obs({MH: [90, 0.0004], other: [300, 0.02]})) is None
    assert read(_obs({})) is None
    assert read({"profile": {"kernels": {STAGES[name][0]: [3, 0.0]}}}) \
        is None
    assert read(_obs({STAGES[name][0]: [3, 0.0]}, steps=0)) is None


@pytest.mark.parametrize("name", NAMES)
def test_the_kernel_is_handwritten(name):
    names = devtrace.handwritten_kernels(ROOT)
    base = registry.reader(name).KERNEL
    assert base in names
    assert all(devtrace.is_handwritten(s, names) for s in STAGES[name])
    assert not devtrace.is_handwritten(ELEMENTWISE, names)
