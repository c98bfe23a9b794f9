"""The model's FLOPs (``work/flops.py``: the published arithmetic at each
view's valid extent and the valid proposals) over the
traced run's measured window, as a percent of the cards' bf16 dense peak
over the same wall time."""

from wsod_bench.work import peaks


def read(obs):
    if obs.kind != "infer" or obs.window_s <= 0:
        return None
    return 100.0 * obs.window_flops / (obs.window_s * peaks.BF16_FLOPS * obs.chips)
