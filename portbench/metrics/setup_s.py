"""setup_s: seconds from the harness's first statement to the first timed
step (imports, the kernel library, data, runner, warm-up and captures)."""


def read(obs):
    return obs.get("setup_s")
