"""The port's single-view model (GeneralizedRCNNWSL) with the WS-ResNet
backbone and with the ROIAlign / ROIAlignV2 poolers against the JAX
package's, on the CPU in float32, at the sizes of
tests/test_torch_single_view.py: WS-ResNet (depth 14, the JAX tests' mini
depth, at the JAX defaults' widths, FrozenBN statistics random) with ROIPool
and the OICR head, and VGG16 with ROIAlignV2 (OICR) and ROIAlign (WSDDN):
the loss terms and every gradient against the JAX model's eager
``model.apply`` under ``jax.value_and_grad``, with the tolerances and helpers
of tests/test_torch_single_view_csc.py (loss terms rtol 1e-4 / atol 1e-5;
gradients rtol 1e-4 plus 1e-5 of the leaf's largest entry). The ties of
ROIPool and of the trunk's max pools are ReLU's zeros, whose gradient the
ReLU backward zeroes on both sides.
"""
from __future__ import annotations

import jax.numpy as jnp
import pytest

from sos_wsod_tpu.models.meta.rcnn_wsl_single import GeneralizedRCNNWSL as JaxGeneralizedRCNNWSL
from test_torch_single_view import KW, _sample, no_jax_dropout, one_thread  # noqa: F401
from test_torch_single_view_csc import _check_loss_and_grads, _init, _port


@pytest.mark.parametrize("backbone,pooler,head", [
    ("ws_resnet", "ROIPool", "OICR"), ("vgg16", "ROIAlignV2", "OICR"),
    ("vgg16", "ROIAlign", "WSDDN")])
def test_backbone_and_pooler_losses_and_gradients_match_jax(backbone, pooler, head):
    """WS-ResNet-14 (res5 2048 channels, stride 8, fc1 of 2048 x 49 inputs;
    the stem and res2 frozen) with ROIPool, and VGG16 with ROIAlign /
    ROIAlignV2 (its output scaled by objectness + 1 after the pool)."""
    sample = _sample(5)
    kw = dict(head=head, backbone_name=backbone, pooler_type=pooler)
    if backbone == "ws_resnet":
        kw["resnet_depth"] = 14
    jm = JaxGeneralizedRCNNWSL(dtype=jnp.float32, **kw, **KW)
    params = _init(jm, sample)
    tm = _port(params, **kw)
    if backbone == "ws_resnet":
        assert tm.roi_heads.dan.fc1.in_features == 2048 * 49 and tm.stride == 8
    _check_loss_and_grads(jm, params, tm, sample)
