"""The port's "val_loss" branch (sos_wsod_torch/models/meta/rcnn.py, the
supervised losses without the gt among the proposals, which LossEvalHook
runs) against the JAX package's (sos_wsod_tpu/models/meta/rcnn.py:100), on
the CPU in f32, the JAX side run eagerly, on one 64 x 64 image with JAX's
sampling draws fed in, in the port's order
(tests/test_torch_frcnn_train.py:image_draws, 32 ROIs: no gt appended).
Every loss within rtol 1e-5. The model is that file's cut R14-FPN (fixed 2
x 2 pooler grid), its JAX tree drawn from the parameter shapes and carried
across by ``state_dict_from_flax``; three of the image's gt boxes are
proposals moved by a pixel, so that proposals reach the foreground without
the gt appended.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_wsod_tpu.models.meta.rcnn import GeneralizedRCNN as JaxGeneralizedRCNN
from sos_wsod_torch.core import sampling
from sos_wsod_torch.engine.ubteacher import stack_samples
from test_torch_frcnn_train import JaxDraws, _cfgs, _port_model, _randomize, _sample, image_draws

N_ROIS = 32          # the RPN's post-NMS top-k in training, no gt appended


HEAD_STD = {"conv": 0.01, "objectness_logits": 0.01, "anchor_deltas": 0.01, "cls_score": 0.01,
            "bbox_pred": 0.001}   # detectron2's initializers of the RPN head and predictor


def _draw_params(shapes, rng):
    """Kernels normal: the RPN head's and the box predictor's at
    detectron2's std, the others over sqrt(fan-in / 2); the rest as drawn by
    ``_randomize`` from ones and zeros."""
    def draw(path, v):
        if path[-1].key == "kernel":
            head = path[0].key != "backbone" and path[-2].key in HEAD_STD
            std = HEAD_STD[path[-2].key] if head else np.sqrt(2.0 / np.prod(v.shape[:-1]))
            return (rng.normal(size=v.shape) * std).astype(np.float32)
        return np.ones(v.shape, np.float32) if path[-1].key in ("weight", "running_var") \
            else np.zeros(v.shape, np.float32)
    return _randomize(jax.tree_util.tree_map_with_path(draw, shapes), rng)


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(1)   # beside pytest-xdist's other processes
    cfg, jcfg = _cfgs()
    jm = JaxGeneralizedRCNN.from_cfg(jcfg)
    rng = np.random.default_rng(0)
    sample = _sample(rng)
    one = {k: jnp.asarray(v) for k, v in sample.items()}
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), one, jax.random.PRNGKey(1),
                                            branch="supervised"))["params"]
    params = jax.tree_util.tree_map(jnp.asarray, _draw_params(shapes, rng))
    # the gt: three of the RPN's proposals, moved by a pixel, so that
    # proposals reach the foreground without the gt appended
    model = _port_model(cfg, params)
    batch = stack_samples([sample], "cpu")
    with torch.no_grad():
        feats = model._features(batch["image"])
        (boxes, _, _), _ = model.proposal_generator.proposals(feats, batch["image_hw"][0],
                                                              train=True)
    sample["gt_boxes"][:3] = boxes[[0, 9, 18]].numpy() + rng.uniform(-1, 1, (3, 4))
    return cfg, jm, params, sample


def test_val_loss_branch_matches_jax(setup, monkeypatch):
    cfg, jm, params, sample = setup
    key = jax.random.PRNGKey(3)
    one = {k: jnp.asarray(v) for k, v in sample.items()}
    want = jm.apply({"params": params}, one, key, branch="val_loss")
    draws = JaxDraws(image_draws(key, N_ROIS))
    monkeypatch.setattr(sampling, "uniform", draws)
    with torch.no_grad():
        got = _port_model(cfg, params)(stack_samples([sample], "cpu"), branch="val_loss")
    assert not draws.arrays
    assert set(got) == set(want) == {"loss_cls", "loss_box_reg", "loss_rpn_cls", "loss_rpn_loc"}
    for k in sorted(want):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, err_msg=k)
        assert float(want[k]) > 0, k
