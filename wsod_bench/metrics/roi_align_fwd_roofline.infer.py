"""The multi-level ROIAlign forward's share of its roofline over the
profiled images: the least time of the recorded calls (``work/roofline.py``:
every level's map, the boxes and flags read once, out written once; 9 f32
operations a channel of each bilinear sample) over the device time of the
forward kernel."""

KERNELS = ("roi_align_fwd_kernel",)


def read(obs):
    rows = obs.calls.get("roi_align", [])
    t = obs.trace.kernel_s(KERNELS)
    if obs.kind != "infer" or not rows or t <= 0:
        return None
    return 100.0 * obs.family.roi_align_bounds(rows) / t
