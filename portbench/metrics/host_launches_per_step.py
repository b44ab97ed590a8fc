"""host_launches_per_step: kernel and graph launch calls among the
profiler's runtime and driver events (lib/devtrace.py::LAUNCH_EVENTS) over
the chain-steps of the profiled segment."""


def read(obs):
    if "trace_steps" not in obs:
        return None
    return obs["profile"]["host_launches"] / obs["trace_steps"]
