"""UNION test-time augmentation (sos_wsod_torch/models/tta.py:
tta_union_detections) over the port's R50-FPN GeneralizedRCNN against the
JAX package's, on the CPU in float32, at the small config of
tests/test_torch_frcnn.py (pre/post-NMS top-k 64/32, fc 64, 16 detections)
with the same weights (its randomized JAX init, carried across by
engine/weights.py:state_dict_from_flax): 2 min sizes x flip = 4 views of a
60 x 80 image, all on a 64 x 64 canvas (one JAX compile).

Tolerance: tests/test_torch_frcnn.py's 1e-4 relative on the merged boxes
and scores, with the same kept classes; the host NMS is the same numpy on
both sides.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sos_wsod_torch.engine.weights import load_weights, state_dict_from_flax
from sos_wsod_torch.models import tta
from sos_wsod_torch.models.meta.rcnn import GeneralizedRCNN
from sos_wsod_torch.models.proposal_generator.rpn import RPN
from sos_wsod_torch.models.roi_heads.standard import StandardROIHeads
from sos_wsod_tpu.models import tta as jax_tta
from sos_wsod_tpu.models.meta.rcnn import GeneralizedRCNN as JaxGeneralizedRCNN
from test_torch_frcnn import _randomize
from test_torch_tta import VIEWS, _image


def test_tta_union_detections_matches_jax():
    """UNION over 4 views of tests/test_torch_frcnn.py's R50-FPN (pre/post
    top-k 64/32, fc 64, 16 detections), then the host NMS: the same kept
    classes, boxes and scores within 1e-4 relative."""
    jm = JaxGeneralizedRCNN(
        num_classes=20,
        rpn_kw=dict(pre_nms_topk_train=64, post_nms_topk_train=32, pre_nms_topk_test=64,
                    post_nms_topk_test=32),
        roi_kw=dict(batch_size_per_image=32, fc_dim=64, detections_per_image=16))
    rng = np.random.default_rng(0)
    image = _image(6)
    batch = {"image": jnp.zeros((64, 64, 3), jnp.float32), "image_hw": jnp.asarray([48.0, 64.0])}
    init = jax.jit(lambda b: jm.init(jax.random.PRNGKey(0), b, branch="inference"))
    params = _randomize(jax.device_get(init(batch))["params"], rng)
    infer = jax.jit(lambda p, b: jm.apply({"params": p}, b, branch="inference")[0])
    pm = GeneralizedRCNN(RPN(pre_nms_topk_test=64, post_nms_topk_test=32, device="meta"),
                         StandardROIHeads(fc_dim=64, detections_per_image=16, device="meta"),
                         device="meta")
    pm = load_weights(pm, state_dict_from_flax(params), "cpu")

    def jax_fn(b):
        det = infer(params, {k: jnp.asarray(b[k]) for k in ("image", "image_hw")})
        return jax.device_get((det.boxes, det.scores, det.classes, det.valid))

    def torch_fn(b):
        with torch.inference_mode():
            det = pm.predict({k: torch.from_numpy(b[k]) for k in ("image", "image_hw")})[0]
        return det.boxes.numpy(), det.scores.numpy(), det.classes.numpy(), det.valid.numpy()

    kw = dict(capacity=1, nms_thresh=0.5, topk=24, **VIEWS)
    none = (np.zeros((1, 4), np.float32), np.zeros(1, np.float32))
    want = jax_tta.tta_union_detections(jax_fn, image, *none, **kw)
    got = tta.tta_union_detections(torch_fn, image, *none, **kw)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-6)
    assert 0 < len(got[1]) <= 24
