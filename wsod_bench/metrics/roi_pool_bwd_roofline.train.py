"""The ROIPool backward's share of its roofline in the profiled training
steps: the least time of the backward of each recorded forward that kept
its argmax (``work/roofline.py``: cotangent, argmax and scales read once,
the map's gradient written once) over the device time of the backward
kernel, which autograd launches."""

KERNELS = ("roi_pool_bwd_kernel",)


def read(obs):
    rows = [r for r in obs.calls.get("roi_pool", []) if r["grad"]]
    t = obs.trace.kernel_s(KERNELS)
    if obs.kind != "train" or not rows or t <= 0:
        return None
    return 100.0 * obs.family.roi_pool_bounds(rows, backward=True) / t
