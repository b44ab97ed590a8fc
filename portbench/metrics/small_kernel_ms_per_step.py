"""small_kernel_ms_per_step: device milliseconds of every device operation
that is not one of the port's hand-written kernels (the __global__
functions of bnpc_tpu_torch/csrc, matched by name) over the chain-steps of
the profiled segment."""

from portbench.lib.devtrace import is_handwritten


def read(obs):
    if "trace_steps" not in obs:
        return None
    kernels = obs["profile"]["kernels"]
    if not kernels:
        return None
    seconds = sum(v[1] for name, v in kernels.items()
                  if not is_handwritten(name, obs["handwritten"]))
    return seconds * 1e3 / obs["trace_steps"]
