"""host_syncs_per_step: host synchronizations that torch's sync debug mode
reports over the chain-steps of the sync-counted segment."""


def read(obs):
    if "syncs" not in obs:
        return None
    return obs["syncs"] / obs["sync_steps"]
