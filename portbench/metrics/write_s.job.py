"""write_s.job: seconds a job spends in io.save_run
(lib/spans.py: each call ends in a device synchronization), the mean over
the traced run's jobs."""


def read(obs):
    stages = obs.get("stage_s")
    if stages is None:
        return None
    return stages["write"]
