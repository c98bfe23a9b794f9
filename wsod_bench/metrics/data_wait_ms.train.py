"""Mean ms a training step waits in ``next(data_iter)`` (the trainer's
``data_time``), over the steps of the traced run's measured window."""


def read(obs):
    if obs.kind != "train" or not obs.data_time:
        return None
    return 1e3 * sum(obs.data_time) / len(obs.data_time)
