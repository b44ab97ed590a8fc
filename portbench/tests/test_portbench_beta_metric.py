"""The reader of beta_post_launches_per_step on fake observations, and the
kernel's name among the port's hand-written kernels (which
small_kernel_ms_per_step leaves out)."""

from portbench.lib import devtrace, registry
from portbench.tests.conftest import ROOT

NAME = "beta_post_launches_per_step"
# The profiler's names of the kernel and of three other kernels.
BETA = "void (anonymous namespace)::beta_post_kernel<6>(" \
       "(anonymous namespace)::Args)"
SWEEP = "void (anonymous namespace)::mh_sweep_kernel<false>(" \
        "(anonymous namespace)::Args)"
LAZY = "lazy_segment_kernel(float const*, int)"
ELEMENTWISE = "void at::native::vectorized_elementwise_kernel<4, " \
              "at::native::CUDAFunctorOnSelf_add<float>>(int)"


def _obs(kernels, steps=256):
    return {"trace_steps": steps, "profile": {"kernels": kernels}}


def test_counts_the_kernel_over_the_steps():
    read = registry.reader(NAME).read
    kernels = {BETA: [90, 0.0004], SWEEP: [900, 0.004], LAZY: [170, 0.25],
               ELEMENTWISE: [5000, 0.01]}
    assert read(_obs(kernels)) == 90 / 256
    assert read(_obs(kernels, steps=480)) == 90 / 480


def test_none_without_the_kernel_or_the_steps():
    read = registry.reader(NAME).read
    assert read(_obs({SWEEP: [900, 0.004], LAZY: [170, 0.25]})) is None
    assert read(_obs({})) is None
    assert read({"profile": {"kernels": {BETA: [3, 0.0]}}}) is None
    assert read(_obs({BETA: [3, 0.0]}, steps=0)) is None


def test_the_kernel_is_handwritten():
    names = devtrace.handwritten_kernels(ROOT)
    assert "beta_post_kernel" in names
    assert devtrace.is_handwritten(BETA, names)
    assert not devtrace.is_handwritten(ELEMENTWISE, names)
