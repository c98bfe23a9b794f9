"""Host ms a training step spends blocked on the card: CUDA runtime
synchronizes and copies to the host, from the profiled steps' trace."""


def read(obs):
    if obs.kind != "train" or not obs.trace.runtime:
        return None
    return 1e3 * obs.trace.blocked_host_s() / obs.trace.units
