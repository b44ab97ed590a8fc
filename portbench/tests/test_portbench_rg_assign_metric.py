"""The reader of rg_assign_launches_per_step on fake observations, and the
kernel's name among the port's hand-written kernels (which
small_kernel_ms_per_step leaves out)."""

from portbench.lib import devtrace, registry
from portbench.tests.conftest import ROOT

NAME = "rg_assign_launches_per_step"
# The profiler's names of the kernel and of three other kernels.
ASSIGN = "void (anonymous namespace)::rg_assign_kernel<1024>(" \
         "(anonymous namespace)::Args)"
BETA = "void (anonymous namespace)::beta_post_kernel<6>(" \
       "(anonymous namespace)::Args)"
SCAN = "void (anonymous namespace)::rg_scan_kernel(float const*, " \
       "int const*, float const*, int const*, int const*, int*, int, int)"
ELEMENTWISE = "void at::native::vectorized_elementwise_kernel<4, " \
              "at::native::CUDAFunctorOnSelf_add<float>>(int)"


def _obs(kernels, steps=256):
    return {"trace_steps": steps, "profile": {"kernels": kernels}}


def test_counts_the_kernel_over_the_steps():
    read = registry.reader(NAME).read
    kernels = {ASSIGN: [320, 0.02], BETA: [90, 0.0004], SCAN: [7, 0.001],
               ELEMENTWISE: [5000, 0.01]}
    assert read(_obs(kernels)) == 320 / 256
    assert read(_obs(kernels, steps=1024)) == 320 / 1024


def test_none_without_the_kernel_or_the_steps():
    read = registry.reader(NAME).read
    assert read(_obs({BETA: [90, 0.0004], SCAN: [300, 0.02]})) is None
    assert read(_obs({})) is None
    assert read({"profile": {"kernels": {ASSIGN: [3, 0.0]}}}) is None
    assert read(_obs({ASSIGN: [3, 0.0]}, steps=0)) is None


def test_the_kernel_is_handwritten():
    names = devtrace.handwritten_kernels(ROOT)
    assert "rg_assign_kernel" in names
    assert devtrace.is_handwritten(ASSIGN, names)
    assert not devtrace.is_handwritten(ELEMENTWISE, names)
