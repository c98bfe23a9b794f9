"""The port's stage-1 entry point against the JAX package, on a synthetic VOC
tree on disk (engine/synthetic.py:write_synthetic_voc): config defaults, VOC
and proposal loading, DatasetMapperTest, the evaluator's ground truth,
verify_results, checkpoints and resume, and the CLI
(sos_wsod_torch/tools/train_net_stage1.py) against tools/train_net_stage1.py.

Tolerances: the data path copies and transforms arrays with the same numpy
code, so it is held exactly. Checkpoint round trips and resume are exact (the
same CPU kernels on the same inputs in the same order). The CLI's
detection-result JSON is held to the JAX CLI's at the tolerance of
tests/test_torch_slice.py: the same records, scores within one rounding
step of the JSON (1e-3) and boxes within 0.1 px, since two f32
implementations sum their convolutions in different orders.
"""
from __future__ import annotations

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sos_wsod_tpu.config import get_cfg as jax_get_cfg
from sos_wsod_tpu.data import build as jax_build
from sos_wsod_tpu.data import proposals as jax_proposals
from sos_wsod_tpu.data.catalog import DatasetCatalog as JaxDatasetCatalog
from sos_wsod_tpu.data.datasets import voc as jax_voc
from sos_wsod_tpu.engine.defaults import auto_scale_workers as jax_auto_scale_workers
from sos_wsod_tpu.evaluation import testing as jax_testing
from sos_wsod_tpu.evaluation.voc_eval import (
    annotations_from_dataset_dicts as jax_annotations_from_dataset_dicts,
)
from sos_wsod_tpu.models.meta.rcnn_wsl import MultiInputRCNN as JaxMultiInputRCNN
from sos_wsod_torch.config import get_cfg
from sos_wsod_torch.data import build, proposals
from sos_wsod_torch.data.catalog import DatasetCatalog
from sos_wsod_torch.data.datasets import voc
from sos_wsod_torch.data.mapper_multi import DatasetMapperMultiInput
from sos_wsod_torch.engine.checkpoint import Checkpointer, PeriodicCheckpointer
from sos_wsod_torch.engine.defaults import auto_scale_workers
from sos_wsod_torch.engine.synthetic import build_synthetic_model, write_synthetic_voc
from sos_wsod_torch.engine.trainer import Stage1Trainer
from sos_wsod_torch.engine.weights import state_dict_from_flax
from sos_wsod_torch.evaluation import testing
from sos_wsod_torch.evaluation.voc_eval import annotations_from_dataset_dicts
from sos_wsod_torch.tools import train_net_stage1 as cli

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "configs" / "stage1" / "voc07_oicr_plus.yaml")
SPLITS = (("train", 4), ("val", 2), ("test", 2))
RAW_HW = (60, 80)
NUM_PROPOSALS = 30
TINY = ["MODEL.ROI_BOX_HEAD.DAN_DIM", "[16, 16]", "TPU.COMPUTE_DTYPE", "float32",
        "INPUT.MIN_SIZE_TRAIN", "(40, 48)", "INPUT.MIN_SIZE_TEST", "48",
        "TPU.PROPOSAL_CAPACITY", "32", "TPU.PGT_SEED_CAPACITY", "16",
        "SOLVER.IMS_PER_BATCH", "1", "DATALOADER.NUM_WORKERS", "0"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A tiny VOC tree with proposals, and a pseudo-label JSON for the
    ``_wsl`` loader."""
    root = tmp_path_factory.mktemp("voc")
    ids = write_synthetic_voc(str(root), SPLITS, RAW_HW, NUM_PROPOSALS, seed=0)
    pl = root / "datasets" / "VOC2007" / "pseudo_labels"
    pl.mkdir()
    pseudo = {str(int(i)): [{"category_id": k % 20, "bbox": [1.5, 2.0, 30.7, 40.2]}]
              for k, i in enumerate(ids["train"])}
    pseudo["multi_label"] = {str(int(i)): [3, 7] for i in ids["train"]}
    (pl / "oicr_plus_voc_2007_train.json").write_text(json.dumps(pseudo))
    return root


def _voc_dir(tree):
    return str(tree / "datasets" / "VOC2007")


def _proposal_file(tree, split):
    return str(tree / "datasets" / "proposals" / f"mcg_voc_2007_{split}_d2.pkl")


def _same(a, b):
    """Exact equality of nested dicts/lists of numbers, strings and arrays."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (sorted(a), sorted(b))
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b and type(a) is type(b), (a, b)


NEW_KEYS = ["OUTPUT_DIR", "MODEL.META_ARCHITECTURE", "MODEL.LOAD_PROPOSALS", "MODEL.WEIGHTS",
            "DATASETS.TRAIN", "DATASETS.TEST", "DATASETS.PROPOSAL_FILES_TRAIN",
            "DATASETS.PROPOSAL_FILES_TEST", "DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST",
            "DATALOADER.FILTER_EMPTY_ANNOTATIONS", "SOLVER.CHECKPOINT_PERIOD",
            "SOLVER.REFERENCE_WORLD_SIZE", "TEST.EVAL_PERIOD", "TEST.EXPECTED_RESULTS",
            "WSODEVAL.SAVE_DETECTION_RESULT", "WSODEVAL.SAVE_PATH"]


def _get(cfg, key):
    for part in key.split("."):
        cfg = cfg[part]
    return cfg


def test_config_defaults_freeze_clone_dump_match_jax():
    """The new defaults equal the JAX get_cfg() values (MODEL.DEVICE names a
    torch device instead: "cuda" against "tpu"); freeze, defrost, clone and
    dump behave alike, and overrides of the new keys merge alike."""
    ours, theirs = get_cfg(), jax_get_cfg()
    for key in NEW_KEYS:
        _same(_get(ours, key), _get(theirs, key))
    assert ours.MODEL.DEVICE == "cuda" and theirs.MODEL.DEVICE == "tpu"
    opts = ["DATASETS.TEST", "('voc_2007_val',)", "WSODEVAL.SAVE_DETECTION_RESULT", "True",
            "SOLVER.CHECKPOINT_PERIOD", "7", "TEST.EXPECTED_RESULTS", "[['bbox', 'AP50', 1, 2]]"]
    for cfg in (ours, theirs):
        cfg.merge_from_file(CONFIG)
        cfg.merge_from_list(list(opts))
        clone = cfg.clone()
        cfg.freeze()
        assert cfg.is_frozen() and cfg.SOLVER.is_frozen() and not clone.is_frozen()
        with pytest.raises(AttributeError):
            cfg.SOLVER.MAX_ITER = 1
        with pytest.raises((AttributeError, AssertionError)):
            cfg.merge_from_list(["SOLVER.MAX_ITER", "1"])
        cfg.defrost()
        cfg.SOLVER.MAX_ITER = 5
        assert clone.SOLVER.MAX_ITER == 50000
    for key in NEW_KEYS:
        _same(_get(ours, key), _get(theirs, key))
    dumped = yaml.safe_load(ours.dump())
    assert dumped["DATASETS"]["TEST"] == ["voc_2007_val"] and dumped["SOLVER"]["MAX_ITER"] == 5
    _same(dumped["WSODEVAL"], yaml.safe_load(theirs.dump())["WSODEVAL"])


def test_voc_and_proposal_loading_match_jax(tree):
    """load_voc_instances (difficult objects dropped, 0-based boxes),
    load_voc_instances_wsl, load_proposals_into_dataset (sorted by
    objectness) and get_detection_dataset_dicts over two registered
    splits, each equal to the JAX package's."""
    d = _voc_dir(tree)
    for split, _ in SPLITS:
        _same(voc.load_voc_instances(d, split), jax_voc.load_voc_instances(d, split))
    _same(voc.load_voc_instances_wsl(d, "train"), jax_voc.load_voc_instances_wsl(d, "train"))
    dicts = voc.load_voc_instances(d, "train")
    _same(proposals.load_proposals_into_dataset(dicts, _proposal_file(tree, "train")),
          jax_proposals.load_proposals_into_dataset(dicts, _proposal_file(tree, "train")))
    for split, _ in SPLITS:
        name = f"synthetic_voc_{split}"
        for catalog, register in ((DatasetCatalog, voc.register_pascal_voc),
                                  (JaxDatasetCatalog, jax_voc.register_pascal_voc)):
            if name not in catalog:
                register(name, d, split, "2007")
    names = ["synthetic_voc_train", "synthetic_voc_val"]
    files = [_proposal_file(tree, "train"), _proposal_file(tree, "val")]
    got = build.get_detection_dataset_dicts(names, True, files)
    _same(got, jax_build.get_detection_dataset_dicts(names, True, files))
    assert len(got) == 6 and all(len(x["proposal_boxes"]) == NUM_PROPOSALS for x in got)
    assert all(x["proposal_objectness_logits"][0] >= x["proposal_objectness_logits"][-1]
               for x in got)


def test_evaluator_ground_truth_matches_jax(tree):
    """From the XMLs (difficult objects kept and flagged) and, without a
    directory, from the dicts' 0-based annotations."""
    d = _voc_dir(tree)
    dicts = voc.load_voc_instances(d, "test") + voc.load_voc_instances(d, "train")
    for dirname in (d, None):
        got = annotations_from_dataset_dicts(dicts, dirname)
        _same(got, jax_annotations_from_dataset_dicts(dicts, dirname))
    assert sum(a["difficult"].sum() for a in annotations_from_dataset_dicts(dicts, d).values()) \
        == len(dicts)     # write_synthetic_voc marks one object an image difficult


@pytest.mark.parametrize("topk,buckets,n_valid", [(1000, (), 28), (12, (8, 16, 32), 12),
                                                  (30, (8, 16), 16)])
def test_dataset_mapper_test_matches_jax(tree, topk, buckets, n_valid):
    """Every array of the test mapper, exactly: resize, clip, duplicate
    and empty proposals dropped before the top-k (28 of 30 left), then the
    smallest bucket that holds them, else the largest; also an image
    without proposals."""
    d = _voc_dir(tree)
    dicts = proposals.load_proposals_into_dataset(voc.load_voc_instances(d, "test"),
                                                  _proposal_file(tree, "test"))
    dup = dict(dicts[0])
    boxes = dup["proposal_boxes"].copy()
    boxes[3] = boxes[1]                       # a duplicate
    boxes[5] = [10.0, 10.0, 10.0, 30.0]       # empty
    boxes[6] = [-20.0, -10.0, 300.0, 200.0]   # clipped to the image
    dup["proposal_boxes"] = boxes
    no_props = {k: v for k, v in dicts[1].items() if not k.startswith("proposal")}
    kw = dict(min_size_test=48, max_size_test=4000, proposal_topk=topk, proposal_capacity=32,
              proposal_buckets=buckets, size_divisibility=64)
    ours, theirs = build.DatasetMapperTest(**kw), jax_build.DatasetMapperTest(**kw)
    for x in dicts + [dup, no_props]:
        got, want = ours(x), theirs(x)
        _same(got, want)
    assert int(ours(dup)["prop_valid"].sum()) == n_valid


def test_flatten_and_verify_results_match_jax():
    results = {"voc_2007_test": {"bbox": {"AP": 10.0, "AP50": 30.5}, "corloc": {"CorLoc": 4.0}}}
    _same(testing.flatten_results_dict(results), jax_testing.flatten_results_dict(results))
    passing = [["voc_2007_test", "bbox/AP50", 30.0, 1.0]]
    failing = [["voc_2007_test", "bbox/AP50", 30.0, 0.4],
               ["voc_2007_test", "corloc/CorLoc", 4.0, 0.1]]
    for make, module in ((get_cfg, testing), (jax_get_cfg, jax_testing)):
        cfg = make()
        assert module.verify_results(cfg, results) is True       # nothing expected
        cfg.TEST.EXPECTED_RESULTS = passing
        assert module.verify_results(cfg, results) is True
        cfg.TEST.EXPECTED_RESULTS = failing
        with pytest.raises(AssertionError) as err:
            module.verify_results(cfg, results)
        failures = str(err.value).split("Full results")[0]
        assert "bbox/AP50" in failures and "CorLoc" not in failures


def test_auto_scale_workers_matches_jax():
    """REFERENCE_WORLD_SIZE 4 on 1 GPU: lr x 4 and ITER_SIZE x 4 on a copy
    that stays frozen; the original is left as it was."""
    for make, scale in ((get_cfg, auto_scale_workers), (jax_get_cfg, jax_auto_scale_workers)):
        cfg = make()
        cfg.SOLVER.REFERENCE_WORLD_SIZE = 4
        cfg.freeze()
        scaled = scale(cfg, 1)
        assert (scaled.SOLVER.BASE_LR, scaled.WSL.ITER_SIZE, scaled.is_frozen()) == \
            (0.004, 4, True)
        assert cfg.SOLVER.BASE_LR == 0.001 and scale(cfg, 4) is cfg


def _tiny_cfg(*opts):
    cfg = get_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.merge_from_list(TINY + ["SOLVER.WARMUP_ITERS", "10", "SOLVER.BASE_LR", "0.01", *opts])
    return cfg


def _fixed_stream(cfg, tree):
    """One mapped sample, the same at every step."""
    dicts = proposals.load_proposals_into_dataset(voc.load_voc_instances(_voc_dir(tree), "train"),
                                                  _proposal_file(tree, "train"))
    sample = DatasetMapperMultiInput.from_cfg(cfg)(dicts[0])
    while True:
        yield [sample]


def _trainer(cfg, tree):
    return Stage1Trainer(cfg, build_synthetic_model(cfg, "cpu", 0), _fixed_stream(cfg, tree))


def _flat_state(trainer):
    """Every tensor and number of the trainer's state, by a flat key."""
    out = {}

    def walk(prefix, x):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(f"{prefix}/{k}", v)
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(f"{prefix}/{i}", v)
        else:
            out[prefix] = x.clone() if torch.is_tensor(x) else x

    walk("", trainer.state_dict())
    out["lr"] = [g["lr"] for g in trainer.optimizer.param_groups]
    return out


def _assert_states_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if torch.is_tensor(a[k]):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_checkpoint_round_trip_is_exact(tree, tmp_path):
    """Model, optimizer momentum, LR schedule, dropout generator and iter,
    through Checkpointer.save and resume_or_load into a fresh trainer;
    PeriodicCheckpointer's file names and the last_checkpoint marker."""
    cfg = _tiny_cfg("SOLVER.MAX_ITER", "3")
    trainer = _trainer(cfg, tree)
    ckpt = Checkpointer(str(tmp_path))
    trainer.register_hooks([cli.CheckpointHook(PeriodicCheckpointer(ckpt, 2, 3))])
    trainer.train(0, 3)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "last_checkpoint", "model_0000001.pth", "model_final.pth"]
    assert ckpt.get_last_checkpoint() == "model_final.pth"
    fresh = _trainer(cfg, tree)
    assert Checkpointer(str(tmp_path / "none")).resume_or_load(fresh) == 0
    assert ckpt.resume_or_load(fresh, resume=False) == 0
    assert ckpt.resume_or_load(fresh) == 3
    _assert_states_equal(_flat_state(trainer), _flat_state(fresh))
    assert any(k.startswith("/optimizer/state/") for k in _flat_state(fresh))


@pytest.mark.parametrize("iter_size,first", [(1, 2), (2, 1)])
def test_resume_is_bit_identical(tree, tmp_path, iter_size, first):
    """4 straight steps against ``first`` steps + save + a fresh trainer +
    resume_or_load + the rest, dropout 0.5 drawing from the saved generator,
    f32: the same weights, momentum and learning rates bit for bit. With
    WSL.ITER_SIZE 2 the checkpoint falls between the two halves of an
    update, so the accumulated gradient must be restored too."""
    cfg = _tiny_cfg("WSL.ITER_SIZE", str(iter_size))
    straight = _trainer(cfg, tree)
    assert straight.model.roi_heads.dan.dropout_rate == 0.5
    straight.train(0, 4)
    split = _trainer(cfg, tree)
    split.train(0, first)
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(f"model_{first - 1:07d}", split.state_dict())
    resumed = _trainer(cfg, tree)
    start = ckpt.resume_or_load(resumed)
    assert start == first
    resumed.train(start, 4)
    _assert_states_equal(_flat_state(straight), _flat_state(resumed))
    moved = [not torch.equal(a, b) for a, b in zip(straight.model.parameters(),
                                                   _trainer(cfg, tree).model.parameters())]
    assert any(moved)


def _args(*flags, opts=()):
    return cli.default_argument_parser().parse_args(
        ["--config-file", CONFIG, *flags, *TINY, "MODEL.DEVICE", "cpu", *opts])


def _jax_params(jm):
    """The JAX model's own init, class scores spread so ranks are not
    near-ties, and WSDDN weights (predict never builds that layer)."""
    rng = np.random.RandomState(7)
    batch = {"image": np.zeros((64, 64, 3), np.float32), "valid_hw": np.array([48, 64], np.int32),
             "boxes": np.tile(np.array([[0, 0, 20, 20]], np.float32), (32, 1)),
             "objectness": np.zeros(32, np.float32), "prop_valid": np.ones(32, bool),
             "image_hw": np.array([48, 64], np.float32)}
    params = jax.device_get(jax.jit(jm.init)({"params": jax.random.PRNGKey(0)},
                                             {k: jnp.asarray(v) for k, v in batch.items()}))
    params = {k: dict(v) for k, v in params["params"].items()}
    heads = params["roi_heads"]
    for k in range(4):
        branch = heads[f"box_refinery_{k}"]
        branch["cls_score"] = {"kernel": np.asarray(branch["cls_score"]["kernel"]) * 100,
                               "bias": np.asarray(branch["cls_score"]["bias"])}
    heads["wsddn"] = {name: {"kernel": rng.randn(16, 20).astype(np.float32) * 0.01,
                             "bias": np.zeros(20, np.float32)} for name in ("cls", "det")}
    return params


def test_cli_trains_resumes_and_dumps_json_like_jax(tree, monkeypatch):
    """main trains 2 iterations (checkpoint every iteration, evals every
    iteration) and --eval-only dumps the detection JSON; then, with the JAX
    model's weights in a port checkpoint, --eval-only's JSON agrees with the
    one tools/train_net_stage1.do_test writes."""
    from tools import train_net_stage1 as jax_cli

    monkeypatch.chdir(tree)
    common = ["SOLVER.CHECKPOINT_PERIOD", "1", "TEST.EVAL_PERIOD", "1", "OUTPUT_DIR", "out"]
    trainer = cli.main(_args(opts=[*common, "SOLVER.MAX_ITER", "2"]))
    out = tree / "out"
    assert {"model_0000000.pth", "model_0000001.pth", "model_final.pth", "metrics.json",
            "config.yaml", "log.txt"} <= {p.name for p in out.iterdir()}
    ap = trainer.storage.histories()["voc_2007_test/bbox/AP50"].values()
    assert [it for _, it in ap] == [0, 2]      # eval after step 0, then after training
    assert [v for v, _ in trainer.storage.histories()["lr"].values()] == [0.001, 0.001]
    assert len((out / "metrics.json").read_text().splitlines()) >= 1
    resumed = cli.main(_args("--resume", opts=[*common, "SOLVER.MAX_ITER", "3"]))
    assert (resumed.start_iter, resumed.iter) == (2, 3)
    results = cli.main(_args("--eval-only", opts=[*common, "WSODEVAL.SAVE_DETECTION_RESULT",
                                                  "True"]))
    assert np.isfinite(results["voc_2007_test"]["bbox"]["AP50"])
    dets = json.loads((out / "detection_results" / "oicr_plus_voc_2007_test.json").read_text())
    assert dets and {d["image_id"] for d in dets} == {7, 8}
    assert all(1 <= d["category_id"] <= 20 and np.isfinite([d["score"], *d["bbox"]]).all()
               for d in dets)

    # the same weights through both CLIs' evaluation
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(CONFIG)
    jcfg.merge_from_list(TINY + ["WSODEVAL.SAVE_DETECTION_RESULT", "True",
                                 "WSODEVAL.SAVE_PATH", "jax/oicr_plus_{}.json"])
    jm = JaxMultiInputRCNN.from_cfg(jcfg, dtype=jnp.float32)
    params = _jax_params(jm)
    jax_cli.do_test(jcfg, jm, params)
    Checkpointer("ported").save("model_final", {"model": state_dict_from_flax(params)})
    cli.main(_args("--eval-only", opts=["OUTPUT_DIR", "ported", "WSODEVAL.SAVE_DETECTION_RESULT",
                                        "True"]))
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


SINGLE = ["MODEL.META_ARCHITECTURE", "GeneralizedRCNNWSL", "WSL.REFINE_NUM", "3",
          "WSL.REFINE_REG", "[False, False, False]"]


def test_cli_refuses_what_is_not_ported(tree, monkeypatch):
    """More than one GPU runs through engine.launch's process group: main
    called alone with --num-gpus 2 refuses it, before any training. (Every
    single-view head trains: below, tests/test_torch_cli_wsl_more.py and
    tests/test_torch_cli_wsjds.py.)"""
    monkeypatch.chdir(tree)
    with pytest.raises(RuntimeError, match="no process group"):
        cli.main(_args("--num-gpus", "2", opts=["OUTPUT_DIR", "refused"]))
    assert not (tree / "refused" / "model_final.pth").exists()


def test_cli_trains_and_evaluates_single_view_oicr(tree, monkeypatch):
    """The single-view OICR model (GeneralizedRCNNWSL) through the stage-1
    CLI: 2 steps on single-view samples, the checkpoint, then --eval-only
    over the test split with the detection JSON (the JAX package's
    tests/test_pipeline_integration.py:test_single_view_train_cli)."""
    monkeypatch.chdir(tree)
    opts = ["OUTPUT_DIR", "single", *SINGLE, "MODEL.ROI_HEADS.NAME", "OICRROIHeads"]
    trainer = cli.main(_args(opts=[*opts, "SOLVER.MAX_ITER", "2"]))
    assert type(trainer.model).__name__ == "GeneralizedRCNNWSL" and trainer.iter == 2
    hist = trainer.storage.histories()
    assert {"loss_cls", "loss_cls_r0", "loss_cls_r1", "loss_cls_r2", "total_loss"} <= set(hist)
    assert np.isfinite(hist["total_loss"].latest)
    assert (tree / "single" / "model_final.pth").exists()
    results = cli.main(_args("--eval-only", opts=[*opts, "WSODEVAL.SAVE_DETECTION_RESULT",
                                                  "True"]))
    assert np.isfinite(results["voc_2007_test"]["bbox"]["AP50"])
    dets = json.loads((tree / "single" / "detection_results" / "oicr_plus_voc_2007_test.json")
                      .read_text())
    assert dets and all(np.isfinite([d["score"], *d["bbox"]]).all() for d in dets)


@pytest.mark.parametrize("head,extra", [
    ("WSDDN", []), ("PCL", []), ("CMIL", ["WSL.SIZE_EPOCH", "1"]),
    ("ContextLocNet", ["MODEL.ROI_BOX_HEAD.POOLER_TYPE", "ROILoopPool"])])
def test_cli_trains_and_evaluates_each_single_view_head(tree, monkeypatch, head, extra):
    """Each other head through the CLI: a step, the JAX head's loss keys,
    finite losses, then --eval-only on the checkpoint."""
    monkeypatch.chdir(tree)
    opts = ["OUTPUT_DIR", f"single_{head}", *SINGLE, "MODEL.ROI_HEADS.NAME", f"{head}ROIHeads",
            *extra]
    trainer = cli.main(_args(opts=[*opts, "SOLVER.MAX_ITER", "1"]))
    keys = {"loss_cls"} | ({f"loss_cls_r{k}" for k in range(3)} if head in ("PCL", "CMIL")
                           else set())
    losses = {k for k in trainer.storage.histories() if k.startswith("loss")}
    assert losses == keys
    assert np.isfinite(trainer.storage.histories()["total_loss"].latest)
    results = cli.main(_args("--eval-only", opts=opts))
    assert np.isfinite(results["voc_2007_test"]["bbox"]["AP50"])


def test_single_view_cmil_resume_goes_on_from_the_step(tree, tmp_path):
    """CMIL's lambda reads the step: 3 straight steps against 1 step + save +
    a fresh trainer + resume + 2, with WSL.SIZE_EPOCH 1 so that lambda moves
    a lot from step to step: the same weights, momentum and generator bit for
    bit, so the resumed run fed its loss the steps 1 and 2."""
    cfg = _tiny_cfg(*SINGLE, "MODEL.ROI_HEADS.NAME", "CMILROIHeads", "WSL.SIZE_EPOCH", "1",
                    "SOLVER.MAX_ITER", "100")
    dicts = proposals.load_proposals_into_dataset(voc.load_voc_instances(_voc_dir(tree), "train"),
                                                  _proposal_file(tree, "train"))
    sample = build.DatasetMapperSingle.from_cfg(cfg)(dicts[0])

    def trainer():
        return Stage1Trainer(cfg, build_synthetic_model(cfg, "cpu", 0),
                             iter([[sample]] * 3))

    seen = []
    straight = trainer()
    loss = straight.model.loss
    straight.model.loss = lambda *a, **kw: seen.append(kw["cur_iter"]) or loss(*a, **kw)
    straight.train(0, 3)
    assert seen == [0, 1, 2]
    split = trainer()
    split.train(0, 1)
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save("model_0000000", split.state_dict())
    resumed = trainer()
    resumed.train(ckpt.resume_or_load(resumed), 3)
    _assert_states_equal(_flat_state(straight), _flat_state(resumed))
    cut = trainer()
    cut.train(0, 1)
    cut.train(0, 2)                       # the same steps with the step count restarted
    assert not torch.equal(cut.model.roi_heads.box_refinery_0.cls_score.weight,
                           straight.model.roi_heads.box_refinery_0.cls_score.weight)
