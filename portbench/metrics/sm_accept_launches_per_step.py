"""sm_accept_launches_per_step: launches of the fused split-merge
acceptance (bnpc_tpu_torch/csrc/sm_accept.cu, its stages: two a split, three
a merge) in the profiled segment over that segment's chain-steps. None
where the kernel does not run (a port without it)."""

from portbench.lib.devtrace import kernel_base

KERNEL = "sm_accept_kernel"


def read(obs):
    if not obs.get("trace_steps"):
        return None
    hits = [v[0] for name, v in obs["profile"]["kernels"].items()
            if kernel_base(name) == KERNEL]
    if not hits:
        return None
    return sum(hits) / obs["trace_steps"]
