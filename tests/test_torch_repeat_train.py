"""``sos_wsod_torch/tools/repeat_train.py`` on the CPU: two trainings from one
seed at a small size repeat bit for bit here, stages 1, 2 and 3 (the plain
ROIPool and ROIAlign backwards add in one order), and the tool refuses to
measure without a card."""
from __future__ import annotations

import pytest
import torch

from sos_wsod_torch.tools import repeat_train

SMALL = ["MODEL.ROI_BOX_HEAD.DAN_DIM", [16, 16], "TPU.COMPUTE_DTYPE", "float32",
         "INPUT.MIN_SIZE_TRAIN", (40, 48), "TPU.PROPOSAL_CAPACITY", 32,
         "TPU.PGT_SEED_CAPACITY", 16]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch's CPU ops in one thread: pytest-xdist runs several test
    processes on the same cores, where many small ops in many threads each
    run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_two_cpu_trainings_repeat():
    a, b = (repeat_train.train_once("cpu", 2, SMALL, (50, 70), 30) for _ in range(2))
    assert len(a["loss_cls"]) == 2 and a["loss_cls"] == b["loss_cls"]
    assert a["total_loss"] == b["total_loss"]
    assert set(a["weights"]) == set(repeat_train.WATCH)
    assert all(torch.equal(a["weights"][n], b["weights"][n]) for n in repeat_train.WATCH)


SMALL2 = ["MODEL.DEVICE", "cpu", "TPU.COMPUTE_DTYPE", "float32", "MODEL.RESNETS.DEPTH", 14,
          "MODEL.FPN.OUT_CHANNELS", 32, "MODEL.ROI_BOX_HEAD.FC_DIM", 64,
          "MODEL.RPN.PRE_NMS_TOPK_TRAIN", 64, "MODEL.RPN.POST_NMS_TOPK_TRAIN", 32,
          "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 32, "INPUT.MIN_SIZE_TRAIN", (40, 48),
          "INPUT.MAX_SIZE_TRAIN", 80, "TPU.PGT_CAPACITY", 8]


def test_two_cpu_stage2_trainings_repeat():
    a, b = (repeat_train.train_stage2_once("cpu", 2, SMALL2, (60, 80), 8) for _ in range(2))
    for k in repeat_train.STAGE2_LOSSES:
        assert len(a[k]) == 2 and a[k] == b[k], k
    assert set(a["weights"]) == set(repeat_train.STAGE2_WATCH)
    assert all(torch.equal(a["weights"][n], b["weights"][n]) for n in repeat_train.STAGE2_WATCH)


def test_two_cpu_stage3_trainings_repeat():
    """Phase 12's stage-3 path at the small width: the split tool's
    dataseed, one burn-in step, the copy step and an EMA step, twice from
    the seed: every loss, num_pseudo_boxes and the watched student and
    teacher weights bit for bit."""
    opts = SMALL2 + ["INPUT.MIN_SIZE_TEST", 48]
    a, b = (repeat_train.train_stage3_once("cpu", 3, opts, (60, 80), 8) for _ in range(2))
    for k in repeat_train.STAGE3_LOSSES:
        assert len(a[k]) == 3 and a[k] == b[k], k
        assert (a[k][0] is None) == k.endswith(("_pseudo", "num_pseudo_boxes")), k
    assert set(a["weights"]) == set(repeat_train.STAGE2_WATCH) | {
        f"teacher.{n}" for n in repeat_train.STAGE2_WATCH}
    assert all(torch.equal(a["weights"][n], b["weights"][n]) for n in a["weights"])
    assert not torch.equal(a["weights"]["teacher.roi_heads.box_head.fc1.weight"],
                           a["weights"]["roi_heads.box_head.fc1.weight"])


def test_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        repeat_train.main([])
