"""The single-view model's CSC head, WS-ResNet backbone and ROIAlign /
ROIAlignV2 poolers through the port's stage-1 CLI
(sos_wsod_torch/tools/train_net_stage1.py) on the CPU: 2 training steps on a
synthetic VOC tree, the JAX head's loss keys, finite losses, the checkpoint,
then --eval-only on it with the detection JSON, as
tests/test_torch_cli.py:test_cli_trains_and_evaluates_single_view_oicr does
for OICR with ROIPool on VGG16. Their parity with the JAX package is held in
tests/test_torch_single_view_csc.py, test_torch_csc.py and
test_torch_resnet_ws.py; this file imports no JAX.
"""
from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest
import torch

from sos_wsod_torch.engine.defaults import default_argument_parser
from sos_wsod_torch.engine.synthetic import write_synthetic_voc
from sos_wsod_torch.models.meta.rcnn_wsl_single import GeneralizedRCNNWSL
from sos_wsod_torch.tools import train_net_stage1 as cli

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "configs" / "stage1" / "voc07_oicr_plus.yaml")
TINY = ["MODEL.ROI_BOX_HEAD.DAN_DIM", "[16, 16]", "TPU.COMPUTE_DTYPE", "float32",
        "INPUT.MIN_SIZE_TRAIN", "(40, 48)", "INPUT.MIN_SIZE_TEST", "48",
        "TPU.PROPOSAL_CAPACITY", "32", "TPU.PGT_SEED_CAPACITY", "16",
        "SOLVER.IMS_PER_BATCH", "1", "DATALOADER.NUM_WORKERS", "0", "MODEL.DEVICE", "cpu",
        "MODEL.META_ARCHITECTURE", "GeneralizedRCNNWSL", "WSL.REFINE_NUM", "3",
        "WSL.REFINE_REG", "[False, False, False]"]
OICR_KEYS = {"loss_cls", "loss_cls_r0", "loss_cls_r1", "loss_cls_r2"}
CASES = {
    "csc": (["MODEL.ROI_HEADS.NAME", "CSCROIHeads"], {"loss_cls_pos", "loss_cls_neg"}),
    "ws_resnet": (["MODEL.ROI_HEADS.NAME", "OICRROIHeads", "MODEL.BACKBONE.NAME",
                   "build_ws_resnet_backbone", "MODEL.RESNETS.DEPTH", "14"], OICR_KEYS),
    "roialign_v2": (["MODEL.ROI_HEADS.NAME", "OICRROIHeads",
                     "MODEL.ROI_BOX_HEAD.POOLER_TYPE", "ROIAlignV2"], OICR_KEYS),
    "roialign": (["MODEL.ROI_HEADS.NAME", "WSDDNROIHeads",
                  "MODEL.ROI_BOX_HEAD.POOLER_TYPE", "ROIAlign"], {"loss_cls"}),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small multi-threaded ops slow down badly under the test
    workers; one thread is fast and gives the same numbers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    write_synthetic_voc(str(root), (("train", 2), ("test", 2)), (60, 80), 30, seed=0)
    return root


def _main(*flags, opts):
    return cli.main(default_argument_parser().parse_args(
        ["--config-file", CONFIG, *flags, *TINY, *opts]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_trains_and_evaluates(tree, monkeypatch, case):
    """2 steps, then --eval-only on the checkpoint; the model the CLI built
    has the configured backbone, pooler and head; CSC's trainer computed
    the CPG maps once a step, and its CSC_MAX_ITER is the config's."""
    monkeypatch.chdir(tree)
    extra, keys = CASES[case]
    opts = ["OUTPUT_DIR", case, "DATASETS.TRAIN", "('voc_2007_train',)",
            "DATASETS.PROPOSAL_FILES_TRAIN", "('datasets/proposals/mcg_voc_2007_train_d2.pkl',)",
            *extra]
    calls = []
    compute_cpgs = GeneralizedRCNNWSL.compute_cpgs
    monkeypatch.setattr(GeneralizedRCNNWSL, "compute_cpgs",
                        lambda self, *a: calls.append(1) or compute_cpgs(self, *a))
    trainer = _main(opts=[*opts, "SOLVER.MAX_ITER", "2"])
    assert len(calls) == (2 if case == "csc" else 0)
    model = trainer.model
    assert type(model).__name__ == "GeneralizedRCNNWSL" and trainer.iter == 2
    assert model.backbone_name == ("ws_resnet" if case == "ws_resnet" else "vgg16")
    assert model.pooler_type == {"roialign_v2": "ROIAlignV2", "roialign": "ROIAlign"}.get(
        case, "ROIPool")
    if case == "ws_resnet":
        assert model.roi_heads.dan.fc1.in_features == 2048 * 49
    if case == "csc":
        assert model.uses_cpgs and model.uses_iter and model.csc_max_iter == 35000
    hist = trainer.storage.histories()
    assert {k for k in hist if k.startswith("loss")} == keys
    assert np.isfinite([hist[k].latest for k in keys | {"total_loss"}]).all()
    assert (tree / case / "model_final.pth").exists()
    results = _main("--eval-only", opts=[*opts, "WSODEVAL.SAVE_DETECTION_RESULT", "True"])
    assert np.isfinite(results["voc_2007_test"]["bbox"]["AP50"])
    dets = json.loads((tree / case / "detection_results" / "oicr_plus_voc_2007_test.json")
                      .read_text())
    assert dets and all(np.isfinite([d["score"], *d["bbox"]]).all() for d in dets)
