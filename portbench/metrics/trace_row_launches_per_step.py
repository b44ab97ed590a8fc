"""trace_row_launches_per_step: launches of the fused trace row's ML and
MAP (bnpc_tpu_torch/csrc/trace_row.cu, its two stages) in the profiled
segment over that segment's chain-steps. None where the kernel does not run
(a port without it)."""

from portbench.lib.devtrace import kernel_base

KERNEL = "trace_row_kernel"


def read(obs):
    if not obs.get("trace_steps"):
        return None
    hits = [v[0] for name, v in obs["profile"]["kernels"].items()
            if kernel_base(name) == KERNEL]
    if not hits:
        return None
    return sum(hits) / obs["trace_steps"]
