"""roofline.lazy_segment: kernel 1's least time for the profiled segment's
exact Gibbs sweeps (lib/roofline.py: bytes over 3.35 TB/s against float
operations over 67 TFLOP/s) over its device time there, in %."""

from portbench.lib import roofline
from portbench.lib.devtrace import kernel_base


def read(obs):
    if "trace_sweeps" not in obs:
        return None
    hits = [v for name, v in obs["profile"]["kernels"].items()
            if kernel_base(name) == "lazy_segment_kernel"]
    if not hits or not obs["trace_sweeps"]:
        return None
    launches = sum(v[0] for v in hits)
    seconds = sum(v[1] for v in hits)
    work = roofline.lazy_segment_work(obs["cells"], obs["k_max"],
                                      obs["trace_sweeps"], launches)
    return 100.0 * roofline.least_seconds(*work) / seconds
