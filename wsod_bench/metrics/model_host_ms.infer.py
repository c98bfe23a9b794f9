"""Host ms an image spends in the models' predict ranges (stage 1:
backbone, roi_pool, box_head, nms_topk; stage 2: backbone, rpn,
roi_align, box_head, nms_topk), nested time counted once, from the
profiled images' trace."""

RANGES = ("backbone", "roi_pool", "rpn", "roi_align", "box_head", "nms_topk")


def read(obs):
    if obs.kind != "infer":
        return None
    s = obs.trace.covered_host_s(RANGES)
    return 1e3 * s / obs.trace.units if s > 0 else None
