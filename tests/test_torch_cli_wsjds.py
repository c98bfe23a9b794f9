"""The single-view model's WSJDS head through the port's stage-1 CLI
(sos_wsod_torch/tools/train_net_stage1.py) on the CPU, on a synthetic VOC
tree: 2 training steps (the CPG maps once a step, the JAX head's five loss
keys, finite; the two ``mask_`` ones are logged outside ``total_loss``,
whose sum takes the keys that start with "loss", as the JAX step's does),
the checkpoint, --eval-only on it; then the JAX model's
weights in a port checkpoint, whose --eval-only detections are held to the
JAX model's ``predict`` on the same test samples. The JAX CLI cannot
evaluate a WSJDS model: its ``run_stage1_inference`` unpacks three outputs
of ``predict``, which returns four for WSJDS, and raises; the port's
inference takes the detections and leaves the masks, which no evaluator
reads (ROADMAP Queue 3). The JAX side here runs its own ``do_test`` on the
model with ``predict``'s first three outputs.

Also: the port's ``get_cfg()`` holds MODEL.SEM_SEG_HEAD with the JAX
defaults, and every key the repo's configs set is either in it or named
below as one that no module of the port reads.

Tolerances: the detection JSON as in tests/test_torch_cli.py (the same
records, scores within 1e-3, boxes within 0.1 px).
"""
from __future__ import annotations

import glob
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sos_wsod_tpu.config import get_cfg as jax_get_cfg
from sos_wsod_tpu.models.meta.rcnn_wsl_single import GeneralizedRCNNWSL as JaxGeneralizedRCNNWSL
from sos_wsod_torch.config import get_cfg
from sos_wsod_torch.engine.checkpoint import Checkpointer
from sos_wsod_torch.engine.defaults import default_argument_parser
from sos_wsod_torch.engine.synthetic import write_synthetic_voc
from sos_wsod_torch.engine.weights import state_dict_from_flax
from sos_wsod_torch.models.meta.rcnn_wsl_single import GeneralizedRCNNWSL
from sos_wsod_torch.tools import train_net_stage1 as cli

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "configs" / "stage1" / "voc07_oicr_plus.yaml")
TINY = ["MODEL.ROI_BOX_HEAD.DAN_DIM", "[16, 16]", "TPU.COMPUTE_DTYPE", "float32",
        "INPUT.MIN_SIZE_TRAIN", "(40, 48)", "INPUT.MIN_SIZE_TEST", "48",
        "TPU.PROPOSAL_CAPACITY", "32", "TPU.PGT_SEED_CAPACITY", "16",
        "SOLVER.IMS_PER_BATCH", "1", "DATALOADER.NUM_WORKERS", "0",
        "MODEL.META_ARCHITECTURE", "GeneralizedRCNNWSL", "WSL.REFINE_NUM", "3",
        "WSL.REFINE_REG", "[False, False, False]", "MODEL.ROI_HEADS.NAME", "WSJDSROIHeads",
        "DATASETS.TRAIN", "('voc_2007_train',)",
        "DATASETS.PROPOSAL_FILES_TRAIN", "('datasets/proposals/mcg_voc_2007_train_d2.pkl',)"]
WSJDS_KEYS = {"loss_cls_pos", "loss_cls_neg", "loss_sem_seg", "mask_loss_cls_pos",
              "mask_loss_cls_neg"}
# keys the repo's configs set that no module of the port (nor of the JAX
# package) reads; get_cfg() holds them with the JAX defaults, so that they
# are type-checked when merged
UNREAD_KEYS = {"INPUT.FORMAT", "TEST.EVALUATOR", "DATASETS.CROSS_DATASET", "MODEL.MASK_ON",
               "MODEL.VGG.DEPTH", "OICRPLUS.PROPOSAL_NUM", "VERSION", "VIS_PERIOD"}


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
        ["--config-file", CONFIG, *flags, "MODEL.DEVICE", "cpu", *TINY, *opts]))


class _FirstThree:
    """The JAX model with ``predict``'s first three outputs, the ones the
    JAX ``run_stage1_inference`` unpacks."""

    def __init__(self, model):
        self.model = model

    def apply(self, variables, batch, train=False):
        return self.model.apply(variables, batch, train=train)[:3]


def test_cli_trains_and_evaluates_wsjds_like_jax_predict(tree, monkeypatch):
    """2 steps and --eval-only; the model the CLI built (VGG16, ROIPool,
    ASPP 1024/1024 over plain5's 512 channels, the constraint off: no
    config key reaches it); then the JAX model's own init evaluated by
    both packages."""
    from tools import train_net_stage1 as jax_cli

    monkeypatch.chdir(tree)
    calls = []
    compute_cpgs = GeneralizedRCNNWSL.compute_cpgs
    monkeypatch.setattr(GeneralizedRCNNWSL, "compute_cpgs",
                        lambda self, *a: calls.append(1) or compute_cpgs(self, *a))
    trainer = _main(opts=["OUTPUT_DIR", "wsjds", "SOLVER.MAX_ITER", "2"])
    model = trainer.model
    assert len(calls) == 2 and trainer.iter == 2 and model.head == "WSJDS"
    assert model.uses_cpgs and model.uses_iter and not model.roi_heads.constraint
    conv1 = model.roi_heads.sem_seg_head.dilation18.conv1
    assert (conv1.in_channels, conv1.out_channels, conv1.dilation) == (512, 1024, (18, 18))
    hist = trainer.storage.histories()
    assert {k for k in hist if "loss_" in k} == WSJDS_KEYS
    assert np.isfinite([hist[k].latest for k in WSJDS_KEYS | {"total_loss"}]).all()
    assert hist["loss_sem_seg"].latest > 0
    results = _main("--eval-only", opts=["OUTPUT_DIR", "wsjds"])
    assert np.isfinite(results["voc_2007_test"]["bbox"]["AP50"])

    jcfg = jax_get_cfg()
    jcfg.merge_from_file(CONFIG)
    jcfg.merge_from_list(TINY + ["WSODEVAL.SAVE_DETECTION_RESULT", "True",
                                 "WSODEVAL.SAVE_PATH", "jax/oicr_plus_{}.json"])
    jm = JaxGeneralizedRCNNWSL.from_cfg(jcfg, dtype=jnp.float32)
    batch = {"image": jnp.zeros((48, 64, 3)), "valid_hw": jnp.asarray([48, 64]),
             "boxes": jnp.tile(jnp.asarray([[0.0, 0.0, 20.0, 20.0]]), (32, 1)),
             "objectness": jnp.zeros(32), "prop_valid": jnp.ones(32, bool),
             "image_hw": jnp.asarray([48.0, 64.0])}
    params = jax.device_get(jax.jit(jm.init)({"params": jax.random.PRNGKey(0)}, batch))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    with pytest.raises(ValueError, match="too many values to unpack"):
        jax_cli.do_test(jcfg, jm, params)
    jax_cli.do_test(jcfg, _FirstThree(jm), params)
    Checkpointer("ported").save("model_final", {
        "model": state_dict_from_flax(params, dan_channels_last=False)})
    _main("--eval-only", opts=["OUTPUT_DIR", "ported", "WSODEVAL.SAVE_DETECTION_RESULT", "True"])
    want = json.loads((tree / "jax" / "oicr_plus_voc_2007_test.json").read_text())
    got = json.loads((tree / "ported" / "detection_results" / "oicr_plus_voc_2007_test.json")
                     .read_text())
    assert len(got) == len(want) > 0

    def key(d):
        return (d["image_id"], d["category_id"], -d["score"], d["bbox"])

    for g, w in zip(sorted(got, key=key), sorted(want, key=key)):
        assert (g["image_id"], g["category_id"]) == (w["image_id"], w["category_id"])
        assert abs(g["score"] - w["score"]) <= 1e-3 + 1e-9
        np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=0, atol=0.1 + 1e-9)


def test_sem_seg_head_defaults_match_jax():
    ours, theirs = get_cfg().MODEL.SEM_SEG_HEAD, jax_get_cfg().MODEL.SEM_SEG_HEAD
    assert set(ours) == set(theirs)
    for k in theirs:
        assert ours[k] == theirs[k] and type(ours[k]) is type(theirs[k]), k


def _leaves(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k


def test_every_config_key_is_in_get_cfg_or_named_unread():
    """``merge_from_file`` adds a key the defaults lack without a word (as
    the JAX package's does). So every key a YAML file under configs/ sets
    must be in the port's get_cfg(); the unread ones among them are named in
    UNREAD_KEYS, which must all be set by some config and be in the
    defaults."""
    known = set(_leaves(get_cfg().to_dict()))
    found, set_somewhere = {}, set()
    for path in sorted(glob.glob(str(ROOT / "configs" / "**" / "*.yaml"), recursive=True)):
        cfg = yaml.safe_load(open(path)) or {}
        cfg.pop("_BASE_", None)
        for key in _leaves(cfg):
            set_somewhere.add(key)
            if key not in known:
                found.setdefault(key, []).append(pathlib.Path(path).name)
    assert not found, found
    assert UNREAD_KEYS <= known & set_somewhere, UNREAD_KEYS - set_somewhere
