"""Host ms an image spends in the inference driver's own ranges (``h2d``,
``rescale_eval``), from the profiled images' trace."""

RANGES = ("h2d", "rescale_eval")


def read(obs):
    if obs.kind != "infer":
        return None
    s = obs.trace.covered_host_s(RANGES)
    return 1e3 * s / obs.trace.units if s > 0 else None
