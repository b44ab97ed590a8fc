"""estimate_s.job: seconds a job spends in io.infer_results
(lib/spans.py: each call ends in a device synchronization), the mean over
the traced run's jobs."""


def read(obs):
    stages = obs.get("stage_s")
    if stages is None:
        return None
    return stages["estimate"]
