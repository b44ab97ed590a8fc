"""job_s: the mean wall seconds of the whole CLI jobs that started in the
window, each from the call of cli.main to its return."""

import numpy as np


def read(obs):
    jobs = obs.get("job_seconds")
    if not jobs:
        return None
    return float(np.mean(jobs))
