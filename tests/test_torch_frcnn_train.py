"""The port's stage-2 training step against the JAX package's, on the CPU in
f32: GeneralizedRCNN.losses (sos_wsod_torch/models/meta/rcnn.py) with every
parameter's gradient against jax.value_and_grad of the JAX model's
"supervised" branch, and one step of BaselineTrainer
(sos_wsod_torch/engine/ubteacher.py) against make_supervised_step with the
JAX package's torch_sgd, on the same batch and the same start weights
(carried by engine/weights.py:state_dict_from_flax).

The models are cut as tests/test_ubteacher.py:119 cuts them (ResNet depth
14, FPN 32 channels, RPN top-k 64/32 in training, 32 sampled ROIs, fc 64)
on 64 x 64 images, with a fixed 2 x 2 pooler grid, which keeps XLA's compile
short (the adaptive grid's gradient is held against JAX in
tests/test_torch_roi_align_grad.py). FrozenBN statistics and biases are
drawn at random so that they matter. The port's sampling draws are JAX's,
made from the step's key in the JAX order (tests/test_torch_sampling.py).

Tolerances, two f32 implementations whose convolutions and GEMMs sum in
different orders: loss terms within rtol 1e-4 / atol 1e-6; gradients, which
pass back through 14 convolutions, within rtol 1e-3 / atol 1e-5 of the
leaf's largest entry (plus 1e-8); the step's parameter updates (lr 0.02, no
warm-up) within the gradients' tolerance.

Known difference (ROADMAP Queue 3): the JAX optimizer's frozen set names
"res2" and FrozenBN's statistics are parameters there, so JAX's weight decay
shrinks the frozen res2 weights and every FrozenBN statistic by lr x wd a
step (their gradients are 0). The port follows detectron2: res2 takes no
step and the statistics are buffers. The test holds both to what they do.
"""
from __future__ import annotations

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_wsod_tpu.config import get_cfg as jax_get_cfg
from sos_wsod_tpu.engine.ubteacher import make_supervised_step
from sos_wsod_tpu.models.meta.rcnn import GeneralizedRCNN as JaxGeneralizedRCNN
from sos_wsod_tpu.solver.build import build_optimizer as jax_build_optimizer
from sos_wsod_tpu.solver.build import d2_param_group_fns as jax_param_group_fns
from sos_wsod_torch.config import get_cfg
from sos_wsod_torch.core import sampling
from sos_wsod_torch.engine.ubteacher import BaselineTrainer, UBTeacherTrainer, stack_samples
from sos_wsod_torch.engine.weights import load_weights, state_dict_from_flax
from sos_wsod_torch.models.meta.rcnn import GeneralizedRCNN, TwoStagePseudoLabGeneralizedRCNN
from sos_wsod_torch.solver.build import build_optimizer, d2_param_group_fns

ROOT = pathlib.Path(__file__).resolve().parents[1]
BASELINE = str(ROOT / "configs" / "stage23" / "voc_baseline.yaml")
OPTS = ["TPU.COMPUTE_DTYPE", "float32", "MODEL.RESNETS.DEPTH", 14, "MODEL.FPN.OUT_CHANNELS", 32,
        "MODEL.ROI_BOX_HEAD.FC_DIM", 64, "MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO", 2,
        "MODEL.RPN.PRE_NMS_TOPK_TRAIN", 64, "MODEL.RPN.POST_NMS_TOPK_TRAIN", 32,
        "MODEL.RPN.PRE_NMS_TOPK_TEST", 64, "MODEL.RPN.POST_NMS_TOPK_TEST", 32,
        "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 32, "TEST.DETECTIONS_PER_IMAGE", 8,
        "SOLVER.WARMUP_ITERS", 0, "MODEL.DEVICE", "cpu"]
HW, G = 64, 8
N_ANCHORS = 3 * (16 * 16 + 8 * 8 + 4 * 4 + 2 * 2 + 1)   # p2-p6 of a 64 x 64 image
N_PROPOSALS = 32 + G                                    # post-NMS top-k + appended gt


def _cfgs(config=BASELINE, opts=OPTS):
    """The port's and the JAX package's config of ``config`` with ``opts``."""
    cfgs = []
    for make in (get_cfg, jax_get_cfg):
        cfg = make()
        cfg.merge_from_file(config)
        cfg.merge_from_list(list(opts))
        cfgs.append(cfg)
    return cfgs


def _sample(rng):
    gt_boxes = np.zeros((G, 4), np.float32)
    gt_classes = np.zeros((G,), np.int32)
    gt_valid = np.zeros((G,), bool)
    for i in range(3):
        side = rng.uniform(12, 40, 2)
        x1, y1 = rng.uniform(0, HW - side)
        gt_boxes[i] = [x1, y1, x1 + side[0], y1 + side[1]]
        gt_classes[i] = rng.integers(20)
        gt_valid[i] = True
    return {"image": rng.uniform(0, 255, (HW, HW, 3)).astype(np.float32),
            "image_hw": np.array([HW, HW], np.float32), "gt_boxes": gt_boxes,
            "gt_classes": gt_classes, "gt_valid": gt_valid}


def _randomize(params, rng):
    """FrozenBN statistics and biases at random, the stem scaled to the
    pixel range and each residual branch's last FrozenBN to about 0.3."""
    def walk(node, path):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            a = np.asarray(v, np.float32)
            if path[-1].endswith("_norm"):
                gain = 0.3 if path[-1] == "conv3_norm" and k == "weight" else 1.0
                a = (rng.uniform(0.5, 1.5, a.shape) * gain if k in ("weight", "running_var")
                     else rng.normal(0, 0.1, a.shape)).astype(np.float32)
            elif path[-2:] == ("stem", "conv1"):
                a = a / 64
            elif k == "bias":
                a = rng.normal(0, 0.05, a.shape).astype(np.float32)
            out[k] = a
        return out
    return walk(params, ())


def image_draws(key, n_rois=N_PROPOSALS, n_anchors=N_ANCHORS):
    """JAX's uniforms for one image's losses under ``key``, in the port's
    order: the RPN's positives and negatives, the ROI heads' positives and
    negatives, then the ROI heads' compaction noise."""
    k_rpn, k_roi = jax.random.split(key)
    out = []
    for kk, n in ((k_rpn, n_anchors), (k_roi, n_rois)):
        k_pos, k_neg = jax.random.split(kk)
        out += [jax.random.uniform(k_pos, (n,)), jax.random.uniform(k_neg, (n,))]
    out.append(jax.random.uniform(k_roi, (n_rois,)))
    return [np.asarray(a) for a in out]


def step_draws(key, b, n_rois=N_PROPOSALS):
    """JAX's uniforms for a supervised step of ``b`` images from ``key``
    (each image's key from split(key, b)), in the port's order."""
    return [a for k in jax.random.split(key, b) for a in image_draws(k, n_rois)]


def semisup_draws(key, b, n_unlabel_rois=N_PROPOSALS):
    """JAX's uniforms for a semi-supervised step of b + b labeled and b
    unlabeled images from ``key`` (make_semisup_step's k_l, k_u =
    split(key)): the 2b labeled images', then the unlabeled images', whose
    ROIs count the post-NMS proposals and the pseudo ground truth's slots."""
    k_l, k_u = jax.random.split(key)
    return step_draws(k_l, 2 * b) + step_draws(k_u, b, n_unlabel_rois)


class JaxDraws:
    def __init__(self, arrays):
        self.arrays = list(arrays)

    def __call__(self, shape, generator, device):
        a = self.arrays.pop(0)
        assert tuple(a.shape) == tuple(shape), (a.shape, shape)
        return torch.from_numpy(a.copy()).to(device)


@pytest.fixture(scope="module")
def setup():
    """Both configs, the JAX model and its randomized params, and two
    samples."""
    cfg, jcfg = _cfgs()
    jm = JaxGeneralizedRCNN.from_cfg(jcfg)
    rng = np.random.default_rng(0)
    samples = [_sample(rng), _sample(rng)]
    one = {k: jnp.asarray(v) for k, v in samples[0].items()}
    init = jax.jit(lambda b: jm.init(jax.random.PRNGKey(0), b, jax.random.PRNGKey(1),
                                     branch="supervised"))
    params = _randomize(jax.device_get(init(one))["params"], rng)
    return cfg, jcfg, jm, params, samples


def _port_model(cfg, params):
    return load_weights(GeneralizedRCNN.from_cfg(cfg, device="meta"), state_dict_from_flax(params),
                        "cpu").train()


def _flax_path(name):
    """A port state-dict name -> its flax path (FrozenBN's four statistics
    keep their names)."""
    *path, leaf = name.split(".")
    if path[-1].endswith("_norm"):
        return path + [leaf]
    return path + ["kernel" if leaf == "weight" else "bias"]


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


def _flax_layout(t):
    a = t.detach().numpy()
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T if a.ndim == 2 else a


def _frozen(name):
    return ".stem." in name or ".res2_block" in name


def _norm_leaves(tree, path=()):
    """(path, value) of every FrozenBN statistic of a flax tree."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _norm_leaves(v, path + (k,))
        elif path[-1].endswith("_norm"):
            yield path + (k,), np.asarray(v)


def test_losses_and_every_gradient_match_jax(setup, monkeypatch):
    """One image: loss_cls, loss_box_reg, loss_rpn_cls, loss_rpn_loc and the
    gradient of their sum for every parameter of the port; the frozen stem
    and res2 get none in the port and a zero one in JAX, as every FrozenBN
    statistic does in JAX."""
    cfg, _, jm, params, samples = setup
    key = jax.random.PRNGKey(5)
    one = {k: jnp.asarray(v) for k, v in samples[0].items()}

    def total(p):
        losses = jm.apply({"params": p}, one, key, branch="supervised")
        return sum(losses.values()), losses

    (_, want), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(params)

    pm = _port_model(cfg, params)
    k_rpn, k_roi = jax.random.split(key)
    draws = []
    for kk, n in ((k_rpn, N_ANCHORS), (k_roi, N_PROPOSALS)):
        k_pos, k_neg = jax.random.split(kk)
        draws += [jax.random.uniform(k_pos, (n,)), jax.random.uniform(k_neg, (n,))]
    d = JaxDraws([np.asarray(a) for a in draws + [jax.random.uniform(k_roi, (N_PROPOSALS,))]])
    monkeypatch.setattr(sampling, "uniform", d)
    losses = pm(stack_samples(samples[:1], "cpu"), branch="supervised")
    assert not d.arrays
    sum(losses.values()).backward()

    assert set(losses) == set(want) == {"loss_cls", "loss_box_reg", "loss_rpn_cls",
                                        "loss_rpn_loc"}
    for k in sorted(want):
        np.testing.assert_allclose(losses[k].item(), float(want[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
        assert float(want[k]) > 0, k
    n_leaves = 0
    for name, p in pm.named_parameters():
        g_jax = _leaf(grads, _flax_path(name))
        n_leaves += 1
        if _frozen(name):
            assert p.grad is None and not p.requires_grad and not g_jax.any(), name
            continue
        atol = 1e-5 * float(np.abs(g_jax).max()) + 1e-8
        np.testing.assert_allclose(_flax_layout(p.grad), g_jax, rtol=1e-3, atol=atol,
                                   err_msg=name)
    norms = list(_norm_leaves(grads))
    assert n_leaves + len(norms) == len(jax.tree_util.tree_leaves(grads))
    assert norms and all(not g.any() for _, g in norms)


def test_supervised_step_matches_jax(setup, monkeypatch):
    """BaselineTrainer.train(0, 1) on two images against
    make_supervised_step with the JAX package's torch_sgd (build_optimizer):
    the step's losses and total, and every parameter's update."""
    cfg, jcfg, jm, params, samples = setup
    tx = jax_build_optimizer(jcfg)
    step = make_supervised_step(jm, tx, donate=False)
    batch = {k: jnp.asarray(np.stack([s[k] for s in samples])) for k in samples[0]}
    state = {"params": jax.tree_util.tree_map(jnp.asarray, params), "opt_state": tx.init(params),
             "iter": jnp.zeros((), jnp.int32)}
    key = jax.random.PRNGKey(9)
    new_state, metrics = step(state, batch, key)
    new_params = jax.device_get(new_state["params"])

    pm = _port_model(cfg, params)
    monkeypatch.setattr(sampling, "uniform", JaxDraws(step_draws(key, 2)))
    trainer = BaselineTrainer(cfg, pm, iter([samples]))
    trainer.train(0, 1)
    hist = trainer.storage.histories()
    for k in ("loss_cls", "loss_box_reg", "loss_rpn_cls", "loss_rpn_loc", "total_loss"):
        np.testing.assert_allclose(hist[k].latest, float(metrics[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    lr, wd = jcfg.SOLVER.BASE_LR, jcfg.SOLVER.WEIGHT_DECAY
    for name, p in pm.named_parameters():
        path = _flax_path(name)
        p0, p1 = _leaf(params, path), _leaf(new_params, path)
        if _frozen(name):
            assert np.array_equal(_flax_layout(p), p0), name
            # JAX: no gradient, but weight decay unless the path names "stem"
            decay = 0.0 if ".stem." in name else lr * wd
            np.testing.assert_allclose(p1, p0 - np.float32(decay) * p0, rtol=1e-6, err_msg=name)
            continue
        want = p1 - p0
        np.testing.assert_allclose(_flax_layout(p) - p0, want, rtol=1e-3,
                                   atol=1e-5 * float(np.abs(want).max()) + 1e-8, err_msg=name)
        assert np.abs(want).max() > 0, name
    for path, v0 in _norm_leaves(params):
        v1 = _leaf(new_params, path)
        decay = 0.0 if "stem" in path else lr * wd
        np.testing.assert_allclose(v1, v0 - np.float32(decay) * v0, rtol=1e-6)


def test_param_groups_match_jax_on_r50_fpn_names(setup):
    """d2_param_group_fns gives every trained parameter of the R50-FPN model
    the JAX groups' lr scale and weight decay (bias factor, weight decay of
    biases); the frozen stem and res2 and the FrozenBN statistics are not in
    the optimizer."""
    cfg, jcfg, _, params, _ = setup
    cfg.defrost()
    cfg.SOLVER.BIAS_LR_FACTOR, cfg.SOLVER.WEIGHT_DECAY_BIAS = 2.0, 0.0
    jcfg.SOLVER.BIAS_LR_FACTOR, jcfg.SOLVER.WEIGHT_DECAY_BIAS = 2.0, 0.0
    try:
        lr_scale, weight_decay = d2_param_group_fns(cfg)
        jlr, jwd = jax_param_group_fns(jcfg)
        pm = _port_model(cfg, params)
        opt, _ = build_optimizer(cfg, pm)
        names = [g["name"] for g in opt.param_groups]
        assert names == [n for n, p in pm.named_parameters() if not _frozen(n)]
        for name in names:
            path = tuple(_flax_path(name))
            assert lr_scale(name) == jlr(path) and weight_decay(name) == jwd(path), name
        assert any(jlr(tuple(_flax_path(n))) == 2.0 for n in names)
    finally:
        for c in (cfg, jcfg):
            c.SOLVER.BIAS_LR_FACTOR, c.SOLVER.WEIGHT_DECAY_BIAS = 1.0, 0.0001


def test_trainer_raises_on_nan_loss_before_the_update(setup):
    cfg, _, _, params, samples = setup
    pm = _port_model(cfg, params)
    bad = dict(samples[0], image=np.full_like(samples[0]["image"], np.nan))
    before = {n: p.detach().clone() for n, p in pm.named_parameters()}
    with pytest.raises(FloatingPointError):
        BaselineTrainer(cfg, pm, iter([[bad]])).train(0, 1)
    assert all(torch.equal(before[n], p) for n, p in pm.named_parameters())


def test_ubteacher_burn_in_then_refuses_the_semisup_step(setup):
    """UBTeacherTrainer: the burn-in step trains on label_q + label_k (with
    BURN_UP_WITH_STRONG_AUG) and leaves the teacher the model as built; at
    BURN_UP_STEP the semi-supervised step, once refused, now runs: it first
    copies the student's weights from before its update into the teacher
    (keep 0), then trains the student on the supervised and the
    pseudo-supervised losses (held against the JAX step in
    tests/test_torch_ssod.py)."""
    cfg, _, _, params, samples = setup
    cfg.defrost()
    cfg.SEMISUPNET.BURN_UP_STEP = 1
    cfg.SEMISUPNET.BURN_UP_WITH_STRONG_AUG = True
    try:
        pm = _port_model(cfg, params)
        ml = [dict(s, multi_label_oh=np.ones(20, np.float32)) for s in samples]
        batch = {"label_q": ml[:1], "label_k": ml[1:], "unlabel_q": ml[:1], "unlabel_k": ml[1:]}
        trainer = UBTeacherTrainer(cfg, pm, iter([batch, batch]))
        start = {k: v.clone() for k, v in pm.state_dict().items()}
        trainer.train(0, 1)
        teacher = trainer.teacher.state_dict()
        assert all(torch.equal(teacher[k], v) for k, v in start.items())
        burnt = {k: v.clone() for k, v in pm.state_dict().items()}
        assert not torch.equal(burnt["roi_heads.box_head.fc1.weight"],
                               start["roi_heads.box_head.fc1.weight"])
        trainer.train(1, 2)
        assert trainer.iter == 2 and trainer.steps_done == 2
        teacher = trainer.teacher.state_dict()
        assert set(teacher) == set(burnt) and all(torch.equal(teacher[k], v)
                                                  for k, v in burnt.items())
        assert not torch.equal(pm.roi_heads.box_head.fc1.weight,
                               burnt["roi_heads.box_head.fc1.weight"])
        hist = trainer.storage.histories()
        for k in ("loss_cls", "loss_box_reg", "loss_rpn_cls", "loss_rpn_loc", "loss_cls_pseudo",
                  "loss_box_reg_pseudo", "loss_rpn_cls_pseudo", "loss_rpn_loc_pseudo",
                  "total_loss", "num_pseudo_boxes"):
            assert np.isfinite(hist[k].latest), k
        state = trainer.state_dict()
        assert set(state) == {"model", "teacher", "optimizer", "scheduler", "generator", "iter"}
        assert state["iter"] == 2
        assert trainer.eval_model() is pm    # voc_baseline: EVAL_TEACHER False
    finally:
        cfg.SEMISUPNET.BURN_UP_STEP = 12000
        cfg.SEMISUPNET.BURN_UP_WITH_STRONG_AUG = False


def test_branches_dispatch():
    assert TwoStagePseudoLabGeneralizedRCNN is GeneralizedRCNN
