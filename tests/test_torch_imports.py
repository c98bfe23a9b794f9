"""The port imports no JAX, and its CUDA build fails loudly without nvcc."""
from __future__ import annotations

import pathlib
import subprocess
import sys

import pytest

from sos_wsod_torch.kernels import build

ROOT = pathlib.Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, json, pkgutil, runpy, sys, tempfile
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["sos_wsod_tpu"] = None
sys.modules["sklearn"] = None
import sos_wsod_torch
import torch
torch.set_num_threads(1)   # beside pytest-xdist's other processes on the same cores
names = [m.name for m in pkgutil.walk_packages(sos_wsod_torch.__path__, "sos_wsod_torch.")]
for name in names:
    importlib.import_module(name)
smoke = runpy.run_path("chip_smoke.py", run_name="chip_smoke")
runpy.run_path("tools/profile_torch_inference.py", run_name="profile_torch_inference")

# the host path chip_smoke drives, at a small size on the CPU
from sos_wsod_torch.data.voc import CLASS_NAMES
from sos_wsod_torch.engine.defaults import run_stage1_inference
from sos_wsod_torch.engine.synthetic import build_synthetic_slice
from sos_wsod_torch.evaluation.voc_eval import PascalVOCDetectionEvaluator
opts = ["INPUT.MIN_SIZE_TEST", 48, "TPU.PROPOSAL_CAPACITY", 32,
        "MODEL.ROI_BOX_HEAD.DAN_DIM", [16, 16], "TPU.COMPUTE_DTYPE", "float32"]
_, model, samples, ann = build_synthetic_slice(
    str(smoke["CONFIG"]), "cpu", 2, (60, 80), 24, 0, opts)
assert samples[0]["image"].shape == (64, 64, 3), samples[0]["image"].shape
with tempfile.TemporaryDirectory() as tmp:
    ev = PascalVOCDetectionEvaluator("voc_2007_test", ann, CLASS_NAMES,
                                     save_detection_result=True, save_path=tmp + "/{}.json")
    run_stage1_inference(model, samples, ev, "cpu")
    dets = json.load(open(tmp + "/voc_2007_test.json"))
assert {d["image_id"] for d in dets} == {1000, 1001}, dets[:3]

# the training path chip_smoke drives: synthetic dicts -> mapper -> stream
# -> Stage1Trainer, one step at a small size on the CPU
from sos_wsod_torch.data.build import batched_stream
from sos_wsod_torch.data.mapper_multi import DatasetMapperMultiInput
from sos_wsod_torch.engine.synthetic import build_synthetic_model, load_config, synthetic_train_dicts
from sos_wsod_torch.engine.trainer import Stage1Trainer
cfg = load_config(str(smoke["CONFIG"]), opts + ["INPUT.MIN_SIZE_TRAIN", (40, 48),
                  "TPU.PGT_SEED_CAPACITY", 16, "SOLVER.IMS_PER_BATCH", 1])
stream = batched_stream(synthetic_train_dicts(2, (50, 70), 30, 20, 0),
                        DatasetMapperMultiInput.from_cfg(cfg), 1)
trainer = Stage1Trainer(cfg, build_synthetic_model(cfg, "cpu", 0), stream)
trainer.train(0, 1)
assert "loss_cls_r3" in trainer.storage.histories(), sorted(trainer.storage.histories())

# the stage-1 CLI on a synthetic VOC tree: one training step, then
# --eval-only writes the detection JSON; the gather tool imports
import os
from sos_wsod_torch.engine.defaults import default_argument_parser
from sos_wsod_torch.engine.synthetic import write_synthetic_voc
from sos_wsod_torch.tools import bench_gather, train_net_stage1
assert {"sos_wsod_torch.tools.bench_gather", "sos_wsod_torch.tools.train_net_stage1",
        "sos_wsod_torch.tools.train_net_unbias", "sos_wsod_torch.models.meta.rcnn",
        "sos_wsod_torch.kernels.nms", "sos_wsod_torch.kernels.roi_align",
        "sos_wsod_torch.ops.csc", "sos_wsod_torch.models.heads.csc",
        "sos_wsod_torch.models.backbones.resnet_ws",
        "sos_wsod_torch.tools.train_imagenet"} <= set(names)
cwd = os.getcwd()
with tempfile.TemporaryDirectory() as tmp:
    write_synthetic_voc(tmp, (("train", 1), ("test", 1)), (50, 70), 30, 0)
    os.chdir(tmp)
    cli_opts = ["MODEL.DEVICE", "cpu", "MODEL.ROI_BOX_HEAD.DAN_DIM", "[16, 16]",
                "TPU.COMPUTE_DTYPE", "float32", "INPUT.MIN_SIZE_TRAIN", "(40, 48)",
                "INPUT.MIN_SIZE_TEST", "48", "TPU.PROPOSAL_CAPACITY", "32",
                "TPU.PGT_SEED_CAPACITY", "16", "SOLVER.IMS_PER_BATCH", "1",
                "DATASETS.TRAIN", "('voc_2007_train',)", "DATASETS.PROPOSAL_FILES_TRAIN",
                "('datasets/proposals/mcg_voc_2007_train_d2.pkl',)", "SOLVER.MAX_ITER", "1",
                "OUTPUT_DIR", "out", "WSODEVAL.SAVE_DETECTION_RESULT", "True"]
    for flags in ([], ["--eval-only"]):
        train_net_stage1.main(default_argument_parser().parse_args(
            ["--config-file", str(smoke["CONFIG"]), *flags, *cli_opts]))
    dets = json.load(open("out/detection_results/oicr_plus_voc_2007_test.json"))
    assert dets and {d["image_id"] for d in dets} == {2}, dets[:3]

    # stage 2: one tiny predict, then the stage-2 CLI's --eval-only on a
    # stage-2 checkpoint
    import torch
    from sos_wsod_torch.engine.synthetic import (
        build_synthetic_frcnn, load_config, write_stage2_checkpoint)
    from sos_wsod_torch.tools import train_net_unbias
    s2 = str(smoke["STAGE2_CONFIG"])
    s2_opts = ["MODEL.DEVICE", "cpu", "TPU.COMPUTE_DTYPE", "float32", "MODEL.RESNETS.DEPTH", "14",
               "MODEL.FPN.OUT_CHANNELS", "16", "MODEL.ROI_BOX_HEAD.FC_DIM", "32",
               "MODEL.RPN.PRE_NMS_TOPK_TEST", "32", "MODEL.RPN.POST_NMS_TOPK_TEST", "16",
               "INPUT.MIN_SIZE_TEST", "48", "OUTPUT_DIR", "out2",
               "WSODEVAL.SAVE_DETECTION_RESULT", "True"]
    s2_cfg = load_config(s2, s2_opts)
    frcnn = build_synthetic_frcnn(s2_cfg, "cpu", 0)
    with torch.inference_mode():
        det, (pb, _, pv), _ = frcnn.predict({"image": torch.rand(64, 64, 3) * 255,
                                             "image_hw": torch.tensor([60.0, 64.0])})
    assert det.boxes.shape == (100, 4) and pb.shape == (16, 4) and bool(pv.any())
    write_stage2_checkpoint("out2", s2_cfg, 0)
    train_net_unbias.main(default_argument_parser().parse_args(
        ["--config-file", s2, "--eval-only", *s2_opts]))
    dets = json.load(open("out2/detection_results/frcnn_voc_2007_test.json"))
    assert {d["image_id"] for d in dets} <= {2}, dets[:3]

    assert {"sos_wsod_torch.engine.ubteacher", "sos_wsod_torch.data.mapper_twocrop",
            "sos_wsod_torch.core.sampling", "sos_wsod_torch.kernels.roi_align_bwd"} <= set(names)
    os.chdir(cwd)

# stage 3: the split tool's dataseed, a burn-in step and a semi-supervised
# step (the path of chip_smoke's phase 12), at a small size on the CPU
from sos_wsod_torch.tools import repeat_train
s3_opts = ["MODEL.DEVICE", "cpu", "TPU.COMPUTE_DTYPE", "float32", "MODEL.RESNETS.DEPTH", 14,
           "MODEL.FPN.OUT_CHANNELS", 16, "MODEL.ROI_BOX_HEAD.FC_DIM", 32,
           "MODEL.RPN.PRE_NMS_TOPK_TRAIN", 32, "MODEL.RPN.POST_NMS_TOPK_TRAIN", 16,
           "MODEL.RPN.PRE_NMS_TOPK_TEST", 32, "MODEL.RPN.POST_NMS_TOPK_TEST", 16,
           "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 16, "INPUT.MIN_SIZE_TRAIN", (40, 48),
           "INPUT.MAX_SIZE_TRAIN", 80, "INPUT.MIN_SIZE_TEST", 48, "TPU.PGT_CAPACITY", 8]
run3 = repeat_train.train_stage3_once("cpu", 2, s3_opts, (60, 80), 8)
assert run3["loss_cls_pseudo"][1] is not None and run3["num_pseudo_boxes"][1] is not None, run3
assert {"sos_wsod_torch.tools.splits", "sos_wsod_torch.tools.convert_checkpoints"} <= set(names)

# the hand-offs (the path of chip_smoke's phase 13): the stage-1 dump of
# train, val and test, PGF and the multi-label tool into the pseudo labels
# that the _wsl loader reads, then the stage-1 TTA on the same checkpoint
from sos_wsod_torch.data.catalog import DatasetCatalog
from sos_wsod_torch.engine.synthetic import write_stage1_checkpoint
from sos_wsod_torch.tools import add_multi_label, pgf, train_net_test_tta
assert {"sos_wsod_torch.data.datasets.coco", "sos_wsod_torch.data.datasets.builtin_extra",
        "sos_wsod_torch.evaluation.coco_eval", "sos_wsod_torch.models.tta",
        "sos_wsod_torch.tools.pgt_to_json", "sos_wsod_torch.tools.proposals_convert",
        "sos_wsod_torch.tools.filter_metrics", "sos_wsod_torch.tools.visualize"} <= set(names)
with tempfile.TemporaryDirectory() as tmp:
    ids = write_synthetic_voc(tmp, (("train", 2), ("val", 1), ("test", 1)), (50, 70), 30, 0)
    os.chdir(tmp)
    s1_opts = ["MODEL.DEVICE", "cpu", "MODEL.ROI_BOX_HEAD.DAN_DIM", "[16, 16]",
               "TPU.COMPUTE_DTYPE", "float32", "INPUT.MIN_SIZE_TEST", "48",
               "TPU.PROPOSAL_CAPACITY", "32", "TEST.AUG.MIN_SIZES", "(40, 48)"]
    s1_cfg = load_config(str(smoke["DETECTION_CONFIG"]), s1_opts)
    write_stage1_checkpoint("out_s1", s1_cfg, 0)
    train_net_stage1.main(default_argument_parser().parse_args(
        ["--config-file", str(smoke["DETECTION_CONFIG"]), "--eval-only", *s1_opts,
         "OUTPUT_DIR", "out_s1"]))
    pgf.main(["--det-path", "datasets/VOC2007/detection_results",
              "--save-path", "datasets/VOC2007/pseudo_labels"])
    add_multi_label.main([])
    for split in ("train", "val"):
        dicts = DatasetCatalog.get(f"voc_2007_{split}_wsl")
        assert [d["image_id"] for d in dicts] == ids[split], dicts
        assert all(d["annotations"] and "multi_label" in d for d in dicts), dicts
    res = train_net_test_tta.main(train_net_test_tta.argument_parser().parse_args(
        ["--config-file", str(smoke["CONFIG"]), "--ckpt", os.path.abspath("out_s1/model_final"),
         *s1_opts, "OUTPUT_DIR", "out_tta"]))
    assert "AP50" in res["voc_2007_test"]["bbox"], res
    os.chdir(cwd)

# data parallelism: the launcher, rank and world, and the checks of chip_smoke's
# phase 14; a world of one runs in this process, and two gloo ranks (fresh
# processes, where nothing blocks JAX) import none of it either
from sos_wsod_torch.engine.launch import launch
from sos_wsod_torch.parallel import comm
from sos_wsod_torch.tools import check_ddp
assert {"sos_wsod_torch.parallel.comm", "sos_wsod_torch.engine.launch",
        "sos_wsod_torch.tools.check_ddp"} <= set(names)
assert launch(comm.get_world_size, 1, device="cpu") == 1
with tempfile.TemporaryDirectory() as tmp:
    launch(check_ddp.loader_ids, 2, args=(tmp, 8, 2, 2, 2, 2), backend="gloo", device="cpu")
    for r in check_ddp.load_reports(tmp, 2):
        assert not r["foreign_modules"], r["foreign_modules"]

# the single-view family (the path of chip_smoke's phase 15): each head of
# GeneralizedRCNNWSL one step through the stage-1 CLI, PCL's clustering
# without scikit-learn, then --eval-only for ContextLocNet (ROILoopPool)
assert {"sos_wsod_torch.models.meta.rcnn_wsl_single", "sos_wsod_torch.models.heads.single_view",
        "sos_wsod_torch.models.heads.pcl", "sos_wsod_torch.models.heads.cmil",
        "sos_wsod_torch.models.heads.contextlocnet", "sos_wsod_torch.ops.pcl_loss",
        "sos_wsod_torch.ops.roi_merge", "sos_wsod_torch.ops.kmeans",
        "sos_wsod_torch.ops.roi_loop_pool", "sos_wsod_torch.kernels.roi_loop_pool",
        "sos_wsod_torch.tools.bench_roi_loop_pool", "sos_wsod_torch.models.heads.aspp",
        "sos_wsod_torch.models.heads.wsjds", "sos_wsod_torch.ops.dense_crf"} <= set(names)
with tempfile.TemporaryDirectory() as tmp:
    write_synthetic_voc(tmp, (("train", 1), ("test", 1)), (50, 70), 30, 0)
    os.chdir(tmp)
    for head in ("WSDDN", "OICR", "PCL", "CMIL", "ContextLocNet", "WSJDS"):
        sv_opts = [*cli_opts, "MODEL.META_ARCHITECTURE", "GeneralizedRCNNWSL",
                   "MODEL.ROI_HEADS.NAME", head + "ROIHeads", "WSL.REFINE_NUM", "3",
                   "WSL.REFINE_REG", "[False, False, False]", "OUTPUT_DIR", "sv_" + head]
        if head == "ContextLocNet":
            sv_opts += ["MODEL.ROI_BOX_HEAD.POOLER_TYPE", "ROILoopPool"]
        for flags in ([], ["--eval-only"]) if head in ("ContextLocNet", "WSJDS") else ([],):
            train_net_stage1.main(default_argument_parser().parse_args(
                ["--config-file", str(smoke["CONFIG"]), *flags, *sv_opts]))
    os.chdir(cwd)

# WSJDS's constraint: the dense CRF, built from the port's own C++ source
from sos_wsod_torch.kernels import build
from sos_wsod_torch.models.heads.aspp import crf_constraint
x_crf, w_crf = crf_constraint(torch.rand(24, 32, 3) * 255, torch.rand(2, 24, 32))
assert x_crf.shape == w_crf.shape == (2, 24, 32) and bool(torch.isfinite(x_crf).all())
assert build.build_host("dense_crf").parent == build.BUILD_DIR
assert build.NATIVE_DIR.parent.name == "sos_wsod_torch"

# the UWSOD family (chip_smoke's phase 18): a step of each model through its
# loss, then predict, from the seeded weights at a small size
assert {"sos_wsod_torch.models.backbones.mrrp", "sos_wsod_torch.models.heads.uwsod",
        "sos_wsod_torch.models.meta.rcnn_uwsod"} <= set(names)
from sos_wsod_torch.engine.synthetic import build_synthetic_uwsod
from sos_wsod_torch.models.meta import MRRPUWSODRCNN, UWSODRCNN
hw = torch.tensor([40, 48], dtype=torch.int32)
uw_batch = {"image": torch.rand(40, 48, 3) * 255, "valid_hw": hw, "image_hw": hw,
            "gt_classes_oh": torch.tensor([1.0, 0.0, 1.0])}
for cls in (UWSODRCNN, MRRPUWSODRCNN):
    uw = build_synthetic_uwsod(cls, "cpu", 0, num_classes=3, refine_k=2,
                               refine_reg=(True, True), dan_dims=(16, 16), pre_nms_topk=32,
                               post_nms_topk=16)
    uw_losses = uw.train().loss(uw_batch, torch.Generator().manual_seed(0))
    sum(uw_losses.values()).backward()
    assert {"loss_rpn_cls", "loss_box_reg_r1"} <= set(uw_losses), sorted(uw_losses)
    with torch.no_grad():
        assert uw.eval().predict(uw_batch)[1].shape == (16, 4)

# the modules no JAX entry point reaches (chip_smoke's phase 19): the
# cascade and mask heads, the deform block, ROILabel, the rotated ops and
# LossEvalHook, each once at a small size
new = {"sos_wsod_torch.models.roi_heads.mask_cascade", "sos_wsod_torch.ops.deform_conv",
       "sos_wsod_torch.ops.roi_label", "sos_wsod_torch.ops.rotated"}
assert new <= set(names), sorted(new - set(names))
from sos_wsod_torch.engine.hooks import LossEvalHook
from sos_wsod_torch.engine.ubteacher import stack_samples
from sos_wsod_torch.models.backbones.resnet_ws import DeformBottleneckBlock
from sos_wsod_torch.models.roi_heads.mask_cascade import CascadeROIHeads, MaskROIHeads
from sos_wsod_torch.ops.roi_label import roi_label
from sos_wsod_torch.ops.rotated import nms_rotated_mask
feats = {f"p{i}": torch.rand(64 >> i, 64 >> i, 8) for i in (2, 3, 4, 5)}
boxes = torch.tensor([[4.0, 4, 40, 30], [10, 8, 60, 50], [0, 0, 20, 20]])
on = torch.ones(3, dtype=torch.bool)
cls = torch.tensor([0, 1, 2])
cascade = CascadeROIHeads(in_channels=8, num_classes=3, batch_size_per_image=8, fc_dim=16)
cl = cascade.losses(feats, boxes, torch.zeros(3), on, boxes[:2], cls[:2], on[:2],
                    torch.Generator().manual_seed(0), torch.tensor([64, 64]))
mk = MaskROIHeads(in_channels=8, num_classes=3, num_conv=1, conv_dim=8, pooler_resolution=7)
ml = mk.losses(feats, boxes, on, cls, on, (torch.rand(2, 256, 256) > 0.5).float(),
               torch.tensor([0, 1, 0]))
sum(cl.values()).add(ml["loss_mask"]).backward()
assert mk.predict(feats, boxes, on, cls).shape == (3, 14, 14)
DeformBottleneckBlock(8, 8, 4, deform_modulated=True)(torch.rand(1, 8, 9, 9)).sum().backward()
assert nms_rotated_mask(torch.tensor([[5.0, 5, 4, 2, 0], [5, 5, 4, 2, 5], [30, 30, 4, 2, 9]]),
                        torch.tensor([0.9, 0.8, 0.7]), on, 0.5).tolist() == [True, False, True]
rl, rw = roi_label(torch.rand(3, 3), torch.eye(3), torch.ones(3), on, torch.Generator())
assert rl.shape == rw.shape == (3,)
from sos_wsod_torch.engine.synthetic import synthetic_mask_sample
val = [stack_samples([synthetic_mask_sample((64, 64), (60, 64), 2, 4, 20, 0)], "cpu")]
assert LossEvalHook(1, frcnn, lambda: iter(val)).compute(frcnn) > 0

# the entry points, tensor parallelism's rules and the weight readers
# (chip_smoke's phase 20): a one-rank dryrun in this process, a split DAN's
# names, and a caffe2 blob pickled and read into a state dict
assert {"sos_wsod_torch.entry", "sos_wsod_torch.parallel.tensor"} <= set(names)
import pickle
import numpy as np
from sos_wsod_torch.entry import dryrun_multichip
from sos_wsod_torch.engine.weights import load_pkl, state_dict_from_c2_resnet
from sos_wsod_torch.parallel import tensor
dryrun_multichip(1, device="cpu")
torch.set_num_threads(1)
assert tensor.split_dims({n: p.shape for n, p in frcnn.named_parameters()}, 2) == {}
with tempfile.TemporaryDirectory() as tmp:
    with open(tmp + "/r.pkl", "wb") as f:
        pickle.dump({"conv1_w": np.ones((4, 3, 7, 7), np.float32),
                     "res_conv1_bn_s": np.ones(4, np.float32),
                     "res_conv1_bn_b": np.zeros(4, np.float32)}, f)
    sd = state_dict_from_c2_resnet(load_pkl(tmp + "/r.pkl"))
assert sd["backbone.bottom_up.stem.conv1.weight"].shape == (4, 3, 7, 7), sorted(sd)

bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "sos_wsod_tpu", "sklearn")
             and sys.modules[m] is not None)
assert not bad, bad
print(len(names))
"""


def test_port_and_chip_smoke_import_without_jax():
    """Every sos_wsod_torch module (the gather tool and both CLIs among
    them), chip_smoke.py and the profile tool import with jax, flax and the
    JAX package blocked, and the host paths that chip_smoke drives run at a
    small size on the CPU: inference (config, synthetic samples, weights,
    the evaluator's JSON), one training step (synthetic dicts, the 4-view
    mapper, the batched stream, the trainer), the stage-1 CLI on a
    synthetic VOC tree (one step, then --eval-only's JSON), one stage-2
    predict and the stage-2 CLI's --eval-only on a stage-2 checkpoint, and
    stage 3: the split tool on a stage-2 checkpoint, then a burn-in step and
    a semi-supervised step on its dataseed; and the hand-offs: the stage-1
    dump of train, val and test, PGF and the multi-label tool, the _wsl
    loader on their output, and the stage-1 TTA CLI; and a step of each
    single-view head through the stage-1 CLI (WSJDS's --eval-only too),
    with scikit-learn blocked too; and WSJDS's host CRF round trip; and a
    step and a predict of each UWSOD model; and a step of the cascade and
    mask heads, of the deform block, rotated NMS and ROILabel; and a
    one-rank dryrun of the entry module, tensor parallelism's rules and a
    caffe2 blob through the weight readers."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 55


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    """No nvcc: the build raises a clear error and writes no library."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("roi_pool_fwd")
    assert not build.library_path("roi_pool_fwd").exists()
