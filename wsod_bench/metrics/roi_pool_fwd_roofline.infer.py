"""The ROIPool forward's share of its roofline over the profiled
images: the least time of the recorded calls (``work/roofline.py``: map,
boxes, flags and scales read once, out written once) over the
device time of the forward kernel."""

KERNELS = ("roi_pool_fwd_kernel",)


def read(obs):
    rows = obs.calls.get("roi_pool", [])
    t = obs.trace.kernel_s(KERNELS)
    if obs.kind != "infer" or not rows or t <= 0:
        return None
    return 100.0 * obs.family.roi_pool_bounds(rows, backward=False) / t
