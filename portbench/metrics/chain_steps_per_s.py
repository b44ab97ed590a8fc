"""chain_steps_per_s: every step of every chain completed in the window
over the seconds from its start to the end of its last block (the block's
trace rows on the host)."""


def read(obs):
    if "chain_steps" not in obs:
        return None
    return obs["chain_steps"] / obs["window_s"]
