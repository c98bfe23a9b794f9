"""The port's stage-3 semi-supervised step (sos_wsod_torch/engine/ubteacher.py:
UBTeacherTrainer.semisup_step) against the JAX package's make_semisup_step,
on the CPU in f32, on the same batches and the same start weights (carried
by engine/weights.py:state_dict_from_flax), with the keys of
configs/stage23/voc_ssod.yaml (HAS_MULTI_LABEL, FocalLoss, BURN_UP_STEP 1)
and TEACHER_UPDATE_ITER 2, at the widths of tests/test_torch_frcnn_train.py
(ResNet depth 14, FPN 32, RPN top-k 64/32, 32 sampled ROIs, fc 64, a fixed
2 x 2 pooler grid, 64 x 64 images, TEST.DETECTIONS_PER_IMAGE 8) and 2 + 2
labeled and 2 unlabeled images a step. The port's sampling draws are JAX's,
made from each step's key in the JAX order
(test_torch_frcnn_train.semisup_draws).

Three steps through UBTeacherTrainer.train from iteration BURN_UP_STEP: the
copy step (keep 0), a step that leaves the teacher as it is (keep 1) and an
EMA step (keep 0.9996). The carried weights raise the box predictor's
class-score bias of one class by 9 and of another by 8, so that the
teacher's detections of the first class score about 0.73: the first
unlabeled image lists that class in its multi-label and keeps them as
pseudo boxes, the second does not, so the multi-label filter removes them
and it keeps none (its pseudo-supervised losses run on an empty ground
truth). The teacher's scores stay more than 1e-4 from the 0.7 threshold, so
the masks compare exactly.

Tolerances: loss terms, pseudo terms and total_loss within rtol 1e-4 /
atol 1e-6; num_pseudo_boxes and the pseudo-valid masks exactly; the pseudo
boxes within tests/test_torch_frcnn.py's predict tolerance (rtol 1e-4 /
atol 1e-4); each step's update of each parameter within rtol 1e-3 / atol
1e-5 x its largest entry + 1e-8 (tests/test_torch_frcnn_train.py) plus one
f32 unit in the last place of the weight, since the new weight rounds to
f32 and most updates here are tens of those units; the teacher's change
over the EMA step within the same tolerance.

What each package does with frozen weights and FrozenBN statistics (ROADMAP
Queue 3): JAX's optimizer decays the res2 weights and the statistics, which
are parameters there, and its EMA follows them; in the port they stay
constant (buffers, or parameters without a gradient) and their teacher is
t x keep + s x (1 - keep) computed in f32 numpy, bit for bit.
"""
from __future__ import annotations

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_wsod_tpu.engine.ubteacher import ema_update as jax_ema_update
from sos_wsod_tpu.engine.ubteacher import make_semisup_step
from sos_wsod_tpu.engine.ubteacher import threshold_pseudo_boxes as jax_threshold_pseudo_boxes
from sos_wsod_tpu.models.meta.rcnn import GeneralizedRCNN as JaxGeneralizedRCNN
from sos_wsod_tpu.solver.build import build_optimizer as jax_build_optimizer
from sos_wsod_torch.core import sampling
from sos_wsod_torch.engine.ubteacher import UBTeacherTrainer, ema_update, threshold_pseudo_boxes
from sos_wsod_torch.engine.weights import state_dict_from_flax
from test_torch_frcnn_train import (
    JaxDraws, _cfgs, _flax_layout, _flax_path, _frozen, _leaf, _port_model, _randomize, _sample,
    semisup_draws)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SSOD = str(ROOT / "configs" / "stage23" / "voc_ssod.yaml")
OPTS = ["TPU.COMPUTE_DTYPE", "float32", "MODEL.RESNETS.DEPTH", 14, "MODEL.FPN.OUT_CHANNELS", 32,
        "MODEL.ROI_BOX_HEAD.FC_DIM", 64, "MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO", 2,
        "MODEL.RPN.PRE_NMS_TOPK_TRAIN", 64, "MODEL.RPN.POST_NMS_TOPK_TRAIN", 32,
        "MODEL.RPN.PRE_NMS_TOPK_TEST", 64, "MODEL.RPN.POST_NMS_TOPK_TEST", 32,
        "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 32, "TEST.DETECTIONS_PER_IMAGE", 8,
        "SEMISUPNET.TEACHER_UPDATE_ITER", 2, "MODEL.DEVICE", "cpu"]
B = 2                              # labeled images a stream, unlabeled images a step
KEPT, OTHER = 6, 13                # the raised classes: +9 and +8 on their score bias
STEPS = (("copy", 0.0), ("keep", 1.0), ("ema", 0.9996))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch's CPU ops in one thread: pytest-xdist runs several test
    processes on the same cores, where many small ops in many threads each
    run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32_ema(t, s, keep):
    keep = np.float32(keep)
    return (t * keep) + (s * (np.float32(1) - keep))


def _close_update(got, want, before, msg):
    """One step's change of a weight within rtol 1e-3 / atol 1e-5 x its
    largest entry + 1e-8, plus one f32 unit in the last place of the weight
    before the step: the new weight is rounded to f32, and a change a
    thousandth apart can round the other way (the res3 updates here are
    10-50 of those units)."""
    tol = 1e-3 * np.abs(want) + 1e-5 * np.abs(want).max() + 1e-8 + np.spacing(np.abs(before))
    bad = np.abs(got - want) > tol
    assert not bad.any(), (msg, int(bad.sum()), float(np.abs(got - want)[bad].max()))
    assert np.abs(want).max() > 0, msg


def _batch(rng):
    """2 + 2 labeled samples, 2 unlabeled pairs (strong, weak) with
    multi-labels: the first lists KEPT, the second lists OTHER only."""
    samples = [_sample(rng) for _ in range(3 * B)]
    ml = np.zeros((B, 20), np.float32)
    ml[0, [KEPT, 3]] = 1
    ml[1, OTHER] = 1
    for s in samples:
        s["multi_label_oh"] = np.ones(20, np.float32)
    weak = [dict(s, multi_label_oh=m) for s, m in zip(samples[2 * B:], ml)]
    strong = [dict(w, image=np.clip(w["image"] * 0.8 + 20, 0, 255).astype(np.float32))
              for w in weak]
    return {"label_q": samples[:B], "label_k": samples[B:2 * B], "unlabel_q": strong,
            "unlabel_k": weak}


def _stack(samples):
    return {k: jnp.asarray(np.stack([s[k] for s in samples])) for k in samples[0]}


@pytest.fixture(scope="module")
def run():
    """Three JAX semi-supervised steps from iteration BURN_UP_STEP, and the
    teacher's detections of each (its predict on the weak unlabeled images
    with the step's teacher, thresholded)."""
    cfg, jcfg = _cfgs(SSOD, OPTS)
    jm = JaxGeneralizedRCNN.from_cfg(jcfg)
    rng = np.random.default_rng(0)
    batches = [_batch(rng) for _ in STEPS]
    one = {k: jnp.asarray(v) for k, v in batches[0]["label_k"][0].items()}
    init = jax.jit(lambda b: jm.init(jax.random.PRNGKey(0), b, jax.random.PRNGKey(1),
                                     branch="supervised"))
    params = _randomize(jax.device_get(init(one))["params"], rng)
    bias = params["roi_heads"]["box_predictor"]["cls_score"]["bias"]
    bias[KEPT] += 9.0
    bias[OTHER] += 8.0
    teacher0 = jax.tree_util.tree_map(lambda a: a * np.float32(0.5), params)

    ss = jcfg.SEMISUPNET
    tx = jax_build_optimizer(jcfg)
    step = make_semisup_step(
        jm, tx, unsup_loss_weight=ss.UNSUP_LOSS_WEIGHT, ema_keep_rate=ss.EMA_KEEP_RATE,
        bbox_threshold=ss.BBOX_THRESHOLD, has_multi_label=ss.HAS_MULTI_LABEL,
        teacher_update_iter=ss.TEACHER_UPDATE_ITER, burn_up_step=ss.BURN_UP_STEP,
        pseudo_cap=jcfg.TEST.DETECTIONS_PER_IMAGE, donate=False)

    @jax.jit
    def teacher_pseudo(teacher, u_k):
        det = jax.vmap(lambda b: jm.apply({"params": teacher}, b, branch="unsup_data_weak")[0])(
            {k: v for k, v in u_k.items() if k != "multi_label_oh"})
        keep = jax.vmap(lambda b, s, c, v, ml: jax_threshold_pseudo_boxes(
            b, s, c, v, ml, ss.BBOX_THRESHOLD, ss.HAS_MULTI_LABEL))(
            det.boxes, det.scores, det.classes, det.valid, u_k["multi_label_oh"])
        return det, keep

    state = {"params": jax.tree_util.tree_map(jnp.asarray, params),
             "teacher_params": jax.tree_util.tree_map(jnp.asarray, teacher0),
             "opt_state": tx.init(params), "iter": jnp.asarray(ss.BURN_UP_STEP, jnp.int32)}
    keys = [jax.random.PRNGKey(20 + i) for i in range(len(STEPS))]
    states, metrics, pseudo = [jax.device_get(state)], [], []
    for batch, key in zip(batches, keys):
        jb = {k: _stack(v) for k, v in batch.items()}
        state, m = step(state, jb, key)
        det, keep = teacher_pseudo(state["teacher_params"], jb["unlabel_k"])
        states.append(jax.device_get(state))
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
        pseudo.append(jax.device_get((det.boxes, det.scores, det.classes, det.valid, keep)))
    return cfg, jcfg, params, teacher0, batches, keys, states, metrics, pseudo


def test_semisup_steps_match_jax(run, monkeypatch):
    """The copy, keep-1 and EMA steps: every loss and pseudo term,
    total_loss, num_pseudo_boxes, the pseudo boxes and masks, every
    parameter's change, and the teacher after each step."""
    cfg, jcfg, params, teacher0, batches, keys, states, metrics, pseudo = run
    pm = _port_model(cfg, params)
    trainer = UBTeacherTrainer(cfg, pm, iter(batches))
    trainer.teacher.load_state_dict(state_dict_from_flax(teacher0))
    seen = []
    pseudo_labels = trainer.pseudo_labels

    def record(unlabel_k):
        out = pseudo_labels(unlabel_k)
        seen.append(out)
        return out

    monkeypatch.setattr(trainer, "pseudo_labels", record)
    trained = {n for n, _ in pm.named_parameters() if not _frozen(n)}
    start = {k: v.clone() for k, v in pm.state_dict().items()}
    burn_up = cfg.SEMISUPNET.BURN_UP_STEP
    for i, ((kind, keep), key) in enumerate(zip(STEPS, keys)):
        student = {k: v.clone() for k, v in pm.state_dict().items()}
        teacher = {k: v.clone() for k, v in trainer.teacher.state_dict().items()}
        d = JaxDraws(semisup_draws(key, B, 32 + cfg.TEST.DETECTIONS_PER_IMAGE))
        monkeypatch.setattr(sampling, "uniform", d)
        trainer.iter = burn_up + i
        assert trainer.keep_rate() == keep
        trainer.train(burn_up + i, burn_up + i + 1)
        assert not d.arrays

        # the step's scalars
        hist = trainer.storage.histories()
        want = metrics[i]
        assert set(want) | {"data_time"} == set(hist)
        for k in sorted(want):
            if k == "num_pseudo_boxes":
                assert hist[k].latest == want[k], (kind, k)
            else:
                np.testing.assert_allclose(hist[k].latest, want[k], rtol=1e-4, atol=1e-6,
                                           err_msg=f"{kind} {k}")

        # the pseudo ground truth
        jboxes, jscores, jclasses, jvalid, jkeep = pseudo[i]
        got = seen[i]
        assert np.array_equal(got["gt_valid"].numpy(), jkeep), kind
        assert np.all(np.abs(jscores[jvalid] - 0.7) > 1e-4), (kind, jscores)
        assert np.array_equal(got["gt_classes"].numpy()[jvalid], jclasses[jvalid])
        np.testing.assert_allclose(got["gt_boxes"].numpy(), jboxes, rtol=1e-4, atol=1e-4)
        assert jkeep[0].any() and not jkeep[1].any(), (kind, jkeep)
        assert (jvalid[1] & (jscores[1] > 0.7)).any(), kind   # removed by the multi-label

        # the student: trained weights against JAX, frozen ones and the
        # statistics constant
        jp0, jp = states[i]["params"], states[i + 1]["params"]
        for name, v in pm.state_dict().items():
            path = _flax_path(name)
            if name in trained:
                s0 = _flax_layout(student[name])
                _close_update(_flax_layout(v) - s0, _leaf(jp, path) - _leaf(jp0, path), s0,
                              f"{kind} {name}")
            else:
                assert torch.equal(v, start[name]), name
                if ".stem." not in name:   # JAX decays them (lr x wd a step)
                    assert not np.array_equal(_leaf(jp, path), _leaf(params, path)), name

        # the teacher
        got_t = trainer.teacher.state_dict()
        if kind == "copy":
            assert all(torch.equal(got_t[k], student[k]) for k in student)
        elif kind == "keep":
            assert all(torch.equal(got_t[k], teacher[k]) for k in teacher)
        else:
            jt0, jt1 = states[i]["teacher_params"], states[i + 1]["teacher_params"]
            for name, v in got_t.items():
                path = _flax_path(name)
                want_t = _f32_ema(teacher[name].numpy(), student[name].numpy(), keep)
                assert np.array_equal(v.numpy(), want_t), name
                a0 = _leaf(jt0, path)
                np.testing.assert_allclose(_leaf(jt1, path), _f32_ema(a0, _leaf(jp0, path), keep),
                                           rtol=1e-6, atol=1e-9, err_msg=name)
                if name in trained:
                    _close_update(_flax_layout(v) - a0, _leaf(jt1, path) - a0, a0,
                                  f"teacher {name}")

@pytest.mark.parametrize("keep", [0.0, 1.0, 0.9996])
def test_ema_update_matches_jax(keep):
    """ema_update over a state dict (a weight, a FrozenBN statistic, an
    integer entry it leaves alone) against the JAX ema_update with an f32
    keep rate, as make_semisup_step computes it under jit: the port rounds
    each product and the sum (f32 numpy, bit for bit), XLA fuses the first
    product and the sum; within one unit in the last place."""
    rng = np.random.default_rng(1)
    t = {"w": rng.normal(0, 1, (5, 7)).astype(np.float32),
         "running_var": rng.uniform(0.5, 1.5, 7).astype(np.float32)}
    s = {k: (v + rng.normal(0, 0.1, v.shape)).astype(np.float32) for k, v in t.items()}
    want = jax.device_get(jax.jit(jax_ema_update)(t, s, jnp.float32(keep)))
    teacher = {k: torch.from_numpy(v.copy()) for k, v in t.items()}
    teacher["steps"] = torch.tensor(3)
    ema_update(teacher, {**{k: torch.from_numpy(v) for k, v in s.items()},
                         "steps": torch.tensor(9)}, keep)
    rest = np.float32(1) - np.float32(keep)
    for k in t:
        np.testing.assert_array_equal(teacher[k].numpy(), _f32_ema(t[k], s[k], keep), err_msg=k)
        # XLA on the CPU contracts t x keep and the sum into one fused
        # multiply-add: one rounding fewer, at most one unit apart
        fused = (t[k].astype(np.float64) * np.float32(keep)
                 + (s[k] * rest).astype(np.float64)).astype(np.float32)
        np.testing.assert_array_equal(want[k], fused, err_msg=k)
        np.testing.assert_array_max_ulp(teacher[k].numpy(), want[k], maxulp=1)
    assert int(teacher["steps"]) == 3
    if keep in (0.0, 1.0):
        src = s if keep == 0.0 else t
        assert all(np.array_equal(teacher[k].numpy(), src[k]) for k in t)


@pytest.mark.parametrize("multi_label", [True, False])
def test_threshold_pseudo_boxes_matches_jax(multi_label):
    """The score threshold and the multi-label filter, one image and a
    batch, with invalid slots above the threshold and (port only) a padded
    class out of range on an invalid slot."""
    scores = np.array([[0.9, 0.8, 0.6, 0.95, 0.71, 0.2], [0.75, 0.99, 0.3, 0.8, 0.7, 0.9]],
                      np.float32)
    classes = np.array([[2, 5, 2, 7, 5, 0], [1, 1, 4, 19, 0, 2]], np.int32)
    valid = np.array([[1, 1, 1, 0, 1, 1], [1, 0, 1, 1, 1, 0]], bool)
    ml = np.zeros((2, 20), np.float32)
    ml[0, [2, 7]] = 1
    ml[1, [1, 19]] = 1
    boxes = np.zeros((2, 6, 4), np.float32)
    for i in range(2):
        want = np.asarray(jax_threshold_pseudo_boxes(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), jnp.asarray(classes[i]),
            jnp.asarray(valid[i]), jnp.asarray(ml[i]), 0.7, multi_label))
        got = threshold_pseudo_boxes(*(torch.from_numpy(a[i]) for a in (boxes, scores, classes,
                                                                          valid, ml)),
                                     0.7, multi_label)
        assert got.tolist() == want.tolist(), i
    want = np.asarray(jax_threshold_pseudo_boxes(*map(jnp.asarray, (boxes, scores, classes,
                                                                    valid, ml)),
                                                 0.7, multi_label))
    got = threshold_pseudo_boxes(*map(torch.from_numpy, (boxes, scores, classes, valid, ml)),
                                 0.7, multi_label)
    assert got.tolist() == want.tolist()
    assert want.any() and not want.all()
    padded = torch.from_numpy(classes.astype(np.int64))
    padded[~torch.from_numpy(valid)] = 99
    got = threshold_pseudo_boxes(*map(torch.from_numpy, (boxes, scores)), padded,
                                 torch.from_numpy(valid), torch.from_numpy(ml), 0.7, multi_label)
    assert got.tolist() == want.tolist()
