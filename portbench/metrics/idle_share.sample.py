"""idle_share.sample: 100 x (1 - device busy / wall) of the profiled
sampling segment (lib/devtrace.py: the union of device operations)."""


def read(obs):
    if obs.get("busy_segment") != "sample":
        return None
    p = obs["profile"]
    if not p["kernels"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
