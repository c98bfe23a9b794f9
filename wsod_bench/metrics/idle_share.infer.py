"""Percent of the profiled images' wall time in which no operation
ran on the card."""


def read(obs):
    if obs.kind != "infer" or not obs.trace.device:
        return None
    return 100.0 * (1.0 - obs.trace.busy_s() / obs.trace.wall_s)
