"""idle_share.job: 100 x (1 - device busy / wall) of the profiled CLI job
(lib/devtrace.py: the union of device operations)."""


def read(obs):
    if obs.get("busy_segment") != "job":
        return None
    p = obs["profile"]
    if not p["kernels"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
