"""Host ms a training step spends in the stage-1 model's and the trainer's
ranges (backbone, roi_pool, box_head, mining, losses, backward,
optimizer), nested time counted once, from the profiled steps' trace."""

RANGES = ("backbone", "roi_pool", "box_head", "mining", "losses", "backward", "optimizer")


def read(obs):
    if obs.kind != "train":
        return None
    s = obs.trace.covered_host_s(RANGES)
    return 1e3 * s / obs.trace.units if s > 0 else None
