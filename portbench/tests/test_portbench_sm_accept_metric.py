"""The reader of sm_accept_launches_per_step on fake observations (every
stage counts), and the kernel's name among the port's hand-written kernels
(which small_kernel_ms_per_step leaves out)."""

import pytest

from portbench.lib import devtrace, registry
from portbench.tests.conftest import ROOT

NAME = "sm_accept_launches_per_step"
# The profiler's names of the kernel's five stages and of two other
# kernels.
STAGES = [f"void (anonymous namespace)::sm_accept_kernel<{s}>("
          "(anonymous namespace)::Args)" for s in range(5)]
MH = "void (anonymous namespace)::mh_sweep_kernel<true>(" \
     "(anonymous namespace)::Args)"
ELEMENTWISE = "void at::native::vectorized_elementwise_kernel<4, " \
              "at::native::CUDAFunctorOnSelf_add<float>>(int)"


def _obs(kernels, steps=256):
    return {"trace_steps": steps, "profile": {"kernels": kernels}}


@pytest.mark.parametrize("steps", [256, 1024])
def test_counts_every_stage_over_the_steps(steps):
    read = registry.reader(NAME).read
    kernels = {MH: [900, 0.02], ELEMENTWISE: [5000, 0.01]}
    for i, stage in enumerate(STAGES):
        kernels[stage] = [40 + i, 0.001]
    assert read(_obs(kernels, steps)) == sum(40 + i for i in range(5)) \
        / steps


def test_none_without_the_kernel_or_the_steps():
    read = registry.reader(NAME).read
    assert read(_obs({MH: [90, 0.0004], ELEMENTWISE: [300, 0.02]})) is None
    assert read(_obs({})) is None
    assert read({"profile": {"kernels": {STAGES[0]: [3, 0.0]}}}) is None
    assert read(_obs({STAGES[1]: [3, 0.0]}, steps=0)) is None


def test_the_kernel_is_handwritten():
    names = devtrace.handwritten_kernels(ROOT)
    assert registry.reader(NAME).KERNEL in names
    assert all(devtrace.is_handwritten(s, names) for s in STAGES)
    assert not devtrace.is_handwritten(ELEMENTWISE, names)
