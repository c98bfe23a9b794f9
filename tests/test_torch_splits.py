"""The host tools between stage 2 and stage 3: the clean/noisy split
(sos_wsod_torch/tools/splits.py) against the JAX package's
(sos_wsod_tpu/tools/splits.py), and the teacher/student checkpoint surgery
(sos_wsod_torch/tools/convert_checkpoints.py).

score_dataset_losses runs the model of tests/test_torch_frcnn_train.py
(ResNet depth 14, FPN 32, RPN top-k 64/32, 32 sampled ROIs, fc 64, a fixed
2 x 2 pooler grid, f32) with configs/stage23/voc_split.yaml's keys on 64 x
64 images; the port's sampling draws are JAX's per-image draws from
fold_in(PRNGKey(0), i). Each image's loss is held within rtol 1e-4 / atol
1e-6. The host half (the bisections, the sort, the base split) is held
equal. main runs on the synthetic tree of tests/test_torch_cli.py with a
stage-2 checkpoint from the seeded initializer; its dataseed file is held
byte for byte to json.dump of the JAX split_by_losses on the port's image
ids and losses.
"""
from __future__ import annotations

import json
import logging
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_wsod_tpu.models.meta.rcnn import GeneralizedRCNN as JaxGeneralizedRCNN
from sos_wsod_tpu.tools import splits as jax_splits
from sos_wsod_torch.core import sampling
from sos_wsod_torch.data.build import get_detection_dataset_dicts
from sos_wsod_torch.data.mapper_twocrop import DatasetMapperTwoCropSeparate
from sos_wsod_torch.engine.checkpoint import Checkpointer
from sos_wsod_torch.engine.defaults import default_argument_parser
from sos_wsod_torch.engine.synthetic import (
    load_config, write_pseudo_labels, write_stage2_checkpoint, write_synthetic_voc)
from sos_wsod_torch.engine.weights import load_weights
from sos_wsod_torch.models.meta.rcnn import GeneralizedRCNN
from sos_wsod_torch.tools import convert_checkpoints, splits
from sos_wsod_torch.tools import train_net_unbias as cli
from test_torch_frcnn_train import (
    JaxDraws, _cfgs, _port_model, _randomize, _sample, image_draws)
from test_torch_unbias_cli import _Records

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPLIT = str(ROOT / "configs" / "stage23" / "voc_split.yaml")
SSOD = str(ROOT / "configs" / "stage23" / "voc_ssod.yaml")
OPTS = ["TPU.COMPUTE_DTYPE", "float32", "MODEL.RESNETS.DEPTH", "14", "MODEL.FPN.OUT_CHANNELS",
        "32", "MODEL.ROI_BOX_HEAD.FC_DIM", "64", "MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO", "2",
        "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "64", "MODEL.RPN.POST_NMS_TOPK_TRAIN", "32",
        "MODEL.RPN.PRE_NMS_TOPK_TEST", "64", "MODEL.RPN.POST_NMS_TOPK_TEST", "32",
        "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "32", "MODEL.DEVICE", "cpu"]
# main on the tree: the tree's 48-px test scale and 8 gt slots
TREE_OPTS = OPTS + ["INPUT.MIN_SIZE_TEST", "48", "TPU.PGT_CAPACITY", "8"]
SPLITS = (("train", 4), ("val", 2), ("test", 2))    # tests/test_torch_cli.py's tree


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch's CPU ops in one thread: pytest-xdist runs several test
    processes on the same cores, where many small ops in many threads each
    run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """tests/test_torch_cli.py's synthetic VOC tree, with the pseudo labels
    of its train and val splits and a stage-2 checkpoint under out/."""
    root = tmp_path_factory.mktemp("voc_split")
    write_synthetic_voc(str(root), SPLITS, (60, 80), 30, seed=0)
    write_pseudo_labels(str(root))
    write_stage2_checkpoint(str(root / "out"), load_config(SPLIT, TREE_OPTS), seed=0)
    return root


def test_score_dataset_losses_matches_jax(monkeypatch):
    """Each image's 4-term loss under fixed weights against the JAX
    score_dataset_losses, the port drawing JAX's per-image draws."""
    cfg, jcfg = _cfgs(SPLIT, OPTS)
    jm = JaxGeneralizedRCNN.from_cfg(jcfg)
    rng = np.random.default_rng(3)
    samples = [dict(_sample(rng), image_id=100 + i, multi_label_oh=np.ones(20, np.float32))
               for i in range(3)]
    one = {k: jnp.asarray(v) for k, v in samples[0].items() if k != "image_id"}
    init = jax.jit(lambda b: jm.init(jax.random.PRNGKey(0), b, jax.random.PRNGKey(1),
                                     branch="supervised"))
    params = _randomize(jax.device_get(init(one))["params"], rng)
    want_ids, want = jax_splits.score_dataset_losses(jm, params, [dict(s) for s in samples])

    draws = [a for i in range(len(samples))
             for a in image_draws(jax.random.fold_in(jax.random.PRNGKey(0), i))]
    d = JaxDraws(draws)
    monkeypatch.setattr(sampling, "uniform", d)
    ids, losses = splits.score_dataset_losses(_port_model(cfg, params), samples)
    assert not d.arrays
    assert ids == want_ids == [100, 101, 102]
    np.testing.assert_allclose(losses, want, rtol=1e-4, atol=1e-6)
    assert all(v > 0 for v in want)


@pytest.mark.parametrize("length,k", [(5011, 2000), (12, 6), (7, 1), (100, 99), (3, 0)])
def test_bisections_and_base_split_match_jax(length, k):
    assert splits.bisect_percent_for_k(length, k) == jax_splits.bisect_percent_for_k(length, k)
    assert (splits.bisect_percent_direct(length, k)
            == jax_splits.bisect_percent_direct(length, k))
    assert splits.generate_base_split(length) == jax_splits.generate_base_split(length)


def test_split_by_losses_matches_jax():
    """Ascending, stable on ties, positions in scoring order; and the
    percent's key lists exactly k positions when read back as
    divide_label_unlabel reads it."""
    rng = np.random.default_rng(5)
    ids = [int(i) for i in rng.permutation(np.arange(1000, 1040))]
    losses = rng.uniform(0, 3, 40).astype(np.float32)
    losses[[3, 17, 25]] = losses[8]
    for k in (0, 1, 13, 39, 40):
        got = splits.split_by_losses(ids, losses.tolist(), k)
        assert got == jax_splits.split_by_losses(ids, losses.tolist(), k)
        (percent, inner), = got[0].items()
        assert int(float(percent) / 100.0 * len(ids)) == k == len(inner["1"])


def test_main_writes_the_jax_dataseed(tree, monkeypatch):
    """main on the tree: the student ("model") of the checkpoint scores the
    weak view of each train+val image at MIN_SIZE_TEST without a flip; the
    dataseed file is byte-identical to json.dump of the JAX split_by_losses
    on those ids and losses; --base-only writes the JAX base split."""
    monkeypatch.chdir(tree)
    seen = []
    score = splits.score_dataset_losses

    def record(model, samples, *args, **kw):
        samples = list(samples)
        out = score(model, samples, *args, **kw)
        seen.append((model, samples, out))
        return out

    monkeypatch.setattr(splits, "score_dataset_losses", record)
    split, percent = splits.main(["--config", SPLIT, "--ckpt", "out/model_final", "--save-path",
                                  "dataseed/split.txt", "--k", "3", *TREE_OPTS])
    (model, samples, (ids, losses)), = seen
    assert len(ids) == 6 and len(set(ids)) == 6 and np.isfinite(losses).all()
    want, want_percent = jax_splits.split_by_losses(ids, losses, 3)
    assert (split, percent) == (want, want_percent)
    assert (tree / "dataseed" / "split.txt").read_text() == json.dumps(want)
    assert all(s["image"].shape == (64, 64, 3) and s["image_hw"].tolist() == [48.0, 64.0]
               for s in samples)

    # the student's weights, and the weak view of an unflipped mapping
    state = Checkpointer(str(tree / "out")).load("model_final")
    cfg = load_config(SPLIT, TREE_OPTS)
    student = load_weights(GeneralizedRCNN.from_cfg(cfg, device="meta"), state["model"], "cpu")
    assert all(torch.equal(v, state["model"][k]) for k, v in model.state_dict().items())
    assert score(student, samples) == (ids, losses)
    mapper = DatasetMapperTwoCropSeparate(
        min_size_train=[48], max_size_train=cfg.INPUT.MAX_SIZE_TEST, random_flip=False,
        gt_capacity=8, size_divisibility=cfg.TPU.IMAGE_SIZE_DIVISIBILITY)
    dicts = get_detection_dataset_dicts(cfg.DATASETS.TRAIN, filter_empty=False)
    for d, s in zip(dicts, samples):
        assert np.array_equal(mapper(d)[1]["image"], s["image"])

    base, none = splits.main(["--config", SPLIT, "--save-path", "dataseed/base.txt",
                              "--base-only", *TREE_OPTS])
    assert none is None and base == jax_splits.generate_base_split(6)
    assert (tree / "dataseed" / "base.txt").read_text() == json.dumps(base)


def test_main_refuses_more_than_one_process(tree, monkeypatch):
    """More than one process writing the dataseed: rank 1 of 2 scores its
    share (the images 1, 3 and 5), hands its (position, id, loss) triples to
    the gather, computes the split and writes nothing (rank 0 writes)."""
    from sos_wsod_torch.parallel import comm

    monkeypatch.chdir(tree)
    monkeypatch.setattr(comm, "get_rank", lambda: 1)
    monkeypatch.setattr(comm, "get_world_size", lambda: 2)
    monkeypatch.setattr(comm, "synchronize", lambda: None)
    gathered = []
    monkeypatch.setattr(comm, "process_gather", lambda objs: gathered.append(objs) or objs)
    split, _ = splits.main(["--config", SPLIT, "--ckpt", "out/model_final", "--save-path",
                            "dataseed/never.txt", "--k", "1", *TREE_OPTS])
    (triples,) = gathered
    assert [p for p, _, _ in triples] == [1, 3, 5]
    assert len(next(iter(split.values()))["1"]) == 1
    assert not (tree / "dataseed" / "never.txt").exists()


def _eval_only_loads(output_dir):
    """--eval-only of voc_ssod (EVAL_TEACHER) on ``output_dir``: the role
    it reports loading."""
    records = _Records()
    logging.getLogger(cli.__name__).addHandler(records)
    try:
        cli.main(default_argument_parser().parse_args(
            ["--config-file", SSOD, "--eval-only", *OPTS, "INPUT.MIN_SIZE_TEST", "48",
             "OUTPUT_DIR", output_dir]))
    finally:
        logging.getLogger(cli.__name__).removeHandler(records)
    (loaded,) = [m for m in records.messages if m.startswith("Loaded")]
    return loaded.split()[2]


def test_convert_checkpoints_round_trip(tree, monkeypatch):
    """convert2detectron2 takes the teacher (default) or the student into a
    plain {"model"}; convert2unbias duplicates a plain model into both
    roles. Each file loads strictly into GeneralizedRCNN, and --eval-only
    under EVAL_TEACHER reads the teacher where there is one."""
    monkeypatch.chdir(tree)
    ens = Checkpointer("out").load("model_final")
    cfg = load_config(SPLIT, TREE_OPTS)
    convert_checkpoints.main(["out/model_final", "plain_t/model_final"])
    convert_checkpoints.main(["convert2detectron2", "out/model_final", "plain_s/model_final",
                              "-m", "student"])
    convert_checkpoints.main(["convert2unbias", "plain_s/model_final", "ens2/model_final"])
    for name, want in (("plain_t", {"model": ens["teacher"]}),
                       ("plain_s", {"model": ens["model"]}),
                       ("ens2", {"model": ens["model"], "teacher": ens["model"]})):
        got = Checkpointer(name).load("model_final")
        assert set(got) == set(want), name
        for role, sd in want.items():
            model = load_weights(GeneralizedRCNN.from_cfg(cfg, device="meta"), got[role], "cpu")
            assert all(torch.equal(v, sd[k]) for k, v in model.state_dict().items()), name
    with pytest.raises(KeyError, match="teacher"):
        convert_checkpoints.convert2detectron2("plain_t/model_final", "never/model_final")
    assert _eval_only_loads("ens2") == "teacher"
    assert _eval_only_loads("plain_t") == "model"
