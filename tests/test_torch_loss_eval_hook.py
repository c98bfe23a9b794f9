"""The port's LossEvalHook (sos_wsod_torch/engine/hooks.py) against the port
model's own "val_loss" totals, on the CPU in f32: every ``period`` steps the
mean over at most ``max_batches`` batches of the "val_loss" total (the
supervised losses without the gt among the proposals), batch i drawing from
``batch_generator(device, 0, i)``, put as ``val_total_loss_student`` and,
for a trainer with a teacher, ``val_total_loss_teacher``; equal to the same
computation done by hand. The model is tests/test_torch_frcnn_train.py's
cut R14-FPN with random weights from a seed; the branch itself is held
against the JAX package's in tests/test_torch_val_loss.py.
"""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from sos_wsod_torch.engine.hooks import LossEvalHook, batch_generator
from sos_wsod_torch.engine.synthetic import build_synthetic_frcnn
from sos_wsod_torch.engine.trainer import TrainerBase
from sos_wsod_torch.engine.ubteacher import stack_samples
from test_torch_frcnn_train import _cfgs, _sample


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(1)   # beside pytest-xdist's other processes
    cfg, _ = _cfgs()
    rng = np.random.default_rng(0)
    samples = [_sample(rng) for _ in range(5)]
    return cfg, samples


class _Trainer(TrainerBase):
    """A trainer whose steps do nothing, with an optional teacher."""

    def __init__(self, teacher=None):
        super().__init__()
        if teacher is not None:
            self.teacher = teacher

    def run_step(self):
        pass


def _by_hand(model, batches):
    with torch.no_grad():
        totals = [sum(v.float() for v in model(b, branch="val_loss",
                                               generator=batch_generator("cpu", 0, i)).values())
                  for i, b in enumerate(batches)]
    return float(torch.stack(totals).double().mean())


@pytest.mark.parametrize("with_teacher", [False, True])
def test_loss_eval_hook_logs_the_models_mean_val_loss(setup, with_teacher):
    cfg, samples = setup
    student = build_synthetic_frcnn(cfg, "cpu", 0)
    teacher = None
    if with_teacher:
        teacher = copy.deepcopy(student)
        with torch.no_grad():
            teacher.roi_heads.box_predictor.cls_score.bias[0] += 2.0
    batches = [stack_samples(samples[i:i + 2], "cpu") for i in (0, 2)] + \
        [stack_samples(samples[4:], "cpu")]
    served = []

    def val_iter():
        for b in batches:
            served.append(1)
            yield b

    trainer = _Trainer(teacher)
    trainer.register_hooks([LossEvalHook(2, student, val_iter, max_batches=2)])
    trainer.train(0, 4)
    hist = trainer.storage.histories()
    want = _by_hand(student, batches[:2])
    assert [it for _, it in hist["val_total_loss_student"].values()] == [1, 3]
    assert [v for v, _ in hist["val_total_loss_student"].values()] == [want, want]
    assert len(served) == 2 * 2 * (2 if with_teacher else 1)   # never the third batch
    if with_teacher:
        want_t = _by_hand(teacher, batches[:2])
        assert want_t != want
        assert [v for v, _ in hist["val_total_loss_teacher"].values()] == [want_t, want_t]
    else:
        assert "val_total_loss_teacher" not in hist


def test_loss_eval_hook_period_zero_and_batch_generators():
    trainer = _Trainer()
    trainer.register_hooks([LossEvalHook(0, None, lambda: iter(()))])
    trainer.train(0, 2)
    assert "val_total_loss_student" not in trainer.storage.histories()
    a = torch.rand(4, generator=batch_generator("cpu", 0, 1))
    assert torch.equal(a, torch.rand(4, generator=batch_generator("cpu", 0, 1)))
    assert not torch.equal(a, torch.rand(4, generator=batch_generator("cpu", 0, 2)))
    assert not torch.equal(a, torch.rand(4, generator=batch_generator("cpu", 1, 1)))
