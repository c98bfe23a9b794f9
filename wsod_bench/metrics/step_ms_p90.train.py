"""The 90th percentile of the time of every step in the traced run's
measured window: the interval between CUDA events recorded at consecutive
step ends (no synchronize added a step)."""

import numpy as np


def read(obs):
    if obs.kind != "train" or not obs.step_ms:
        return None
    return float(np.percentile(obs.step_ms, 90))
