"""Config tree with YAML ``_BASE_`` inheritance and dotted overrides.

Reads the repo's released YAML configs (``configs/stage1/*.yaml`` and
``configs/stage23/*.yaml``) with the
merge rules of ``sos_wsod_tpu/config/cfg_node.py``: ``_BASE_`` resolves
relative to the child file, values are coerced to the type of the default,
and keys the defaults do not name are taken as they are. The defaults are
the JAX package's ``get_cfg()`` key for key, many of them read by no module
(as there), with two differences: MODEL.DEVICE names a torch device, and
the TPU-only knobs of ``TPU_ONLY_KEYS`` are left out; a YAML file or an
override that sets one of those raises. ``freeze``/``defrost``/``clone``/
``dump`` behave as the JAX package's.
"""
from __future__ import annotations

import ast
import copy
import os
from typing import Any, Dict, List

import yaml

_BASE_KEY = "_BASE_"
# the JAX package's XLA knobs (the lax.scan superstep, the Pallas-or-table
# pool switch and its row chunks, the TPU's hardware PRNG): the port has no
# such machinery, so a config that sets one is refused rather than ignored
TPU_ONLY_KEYS = ("TPU.SCAN_STEPS", "TPU.POOL_IMPL", "TPU.POOL_ROW_CHUNKS", "TPU.PRNG_IMPL")


def _refuse_tpu_only(key: str) -> None:
    if key in TPU_ONLY_KEYS:
        raise KeyError(f"{key} is a TPU-only knob of the JAX package (XLA scan steps, Pallas "
                       f"pool, hardware PRNG); the PyTorch port has no counterpart: drop it")


class CfgNode(dict):
    """A dict with attribute access, freezing and recursive merge."""

    def __init__(self, init: Dict[str, Any] | None = None):
        super().__init__()
        self.__dict__["_frozen"] = False
        for k, v in (init or {}).items():
            self[k] = v

    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"Config has no attribute '{name}'")

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        if self._frozen:
            raise AttributeError(f"config is frozen; cannot set {name}")
        if isinstance(value, dict) and not isinstance(value, CfgNode):
            value = CfgNode(value)
        super().__setitem__(name, value)

    def freeze(self) -> None:
        self._set_frozen(True)

    def defrost(self) -> None:
        self._set_frozen(False)

    def _set_frozen(self, frozen: bool) -> None:
        self.__dict__["_frozen"] = frozen
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_frozen(frozen)

    def is_frozen(self) -> bool:
        return self._frozen

    def clone(self) -> "CfgNode":
        """A deep copy, not frozen (as the JAX package's clone)."""
        return copy.deepcopy(self)

    def __deepcopy__(self, memo) -> "CfgNode":
        return CfgNode(copy.deepcopy(self.to_dict(), memo))

    def to_dict(self) -> Dict[str, Any]:
        return {k: v.to_dict() if isinstance(v, CfgNode) else v for k, v in self.items()}

    def dump(self) -> str:
        return yaml.safe_dump(self.to_dict(), default_flow_style=None, sort_keys=True)

    def merge_from_file(self, filename: str) -> None:
        _merge_a_into_b(_load_yaml_with_base(filename), self)

    def merge_from_list(self, opts: List[Any]) -> None:
        """``["MODEL.ROI_HEADS.NUM_CLASSES", "20", ...]``: existing keys only."""
        if len(opts) % 2:
            raise ValueError(f"override list has odd length: {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            _refuse_tpu_only(key)
            *parents, leaf = key.split(".")
            node = self
            for p in parents:
                node = node[p]
            if leaf not in node:
                raise KeyError(f"non-existent config key: {key}")
            node[leaf] = _coerce_value(value, node[leaf], key)


def _coerce_value(value: Any, old: Any, key: str) -> Any:
    """Parse a string value (python literal, else YAML) and check it against
    the type of the value it replaces."""
    if isinstance(value, str):
        try:
            value = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            try:
                value = yaml.safe_load(value)
            except yaml.YAMLError:
                pass
    if isinstance(value, (list, tuple)) and isinstance(old, (list, tuple)):
        return type(old)(value)
    if old is None or value is None:
        return value
    if isinstance(old, bool):
        if isinstance(value, bool):
            return value
    elif isinstance(old, float) and isinstance(value, int):
        return float(value)
    elif isinstance(value, type(old)):
        return value
    raise ValueError(f"type mismatch for {key}: {type(old).__name__} vs "
                     f"{type(value).__name__} ({value!r})")


def _merge_a_into_b(a: Dict[str, Any], b: CfgNode, prefix: str = "") -> None:
    for k, v in a.items():
        if k == _BASE_KEY:
            continue
        _refuse_tpu_only(prefix + k)
        if isinstance(b.get(k), CfgNode) and isinstance(v, dict):
            _merge_a_into_b(v, b[k], f"{prefix}{k}.")
        else:
            b[k] = _coerce_value(v, b[k], k) if k in b else v


def _load_yaml_with_base(filename: str) -> Dict[str, Any]:
    with open(filename) as f:
        cfg = yaml.safe_load(f) or {}
    base = cfg.pop(_BASE_KEY, None)
    if base is None:
        return cfg
    merged = CfgNode(_load_yaml_with_base(os.path.join(os.path.dirname(filename), base)))
    _merge_a_into_b(cfg, merged)
    return merged.to_dict()


def get_cfg() -> CfgNode:
    """The JAX package's ``get_cfg()`` with its values, but MODEL.DEVICE, a
    torch device ("cuda" as in detectron2, where the JAX package says
    "tpu"), and without ``TPU_ONLY_KEYS``. Keys that no module of the port
    reads (as none of the JAX package does) are kept so that the released
    configs and command lines merge: VERSION, VIS_PERIOD, CUDNN_BENCHMARK,
    MODEL.MASK_ON/KEYPOINT_ON/ROI_MASK_HEAD/MRRP, the VGG depth and
    features, INPUT.FORMAT and friends, SOLVER.AMP, the TEST evaluator and
    PRECISE_BN keys, TEST.VAL_LOSS, WSL.SAMPLING and the other WSL flags,
    EMAMODEL, and the TPU capacities and dtypes the port does not use."""
    return CfgNode({
        "VERSION": 2,
        "VIS_PERIOD": 0,
        "CUDNN_BENCHMARK": False,
        "OUTPUT_DIR": "./output",
        "MODEL": {
            "META_ARCHITECTURE": "GeneralizedRCNN",
            "DEVICE": "cuda",
            "WEIGHTS": "",
            "MASK_ON": False,
            "KEYPOINT_ON": False,
            "LOAD_PROPOSALS": False,
            "PIXEL_MEAN": [103.530, 116.280, 123.675],   # BGR
            "PIXEL_STD": [1.0, 1.0, 1.0],
            "BACKBONE": {"NAME": "build_resnet_backbone", "FREEZE_AT": 2},
            "VGG": {"DEPTH": 16, "OUT_FEATURES": ["plain5"], "CONV5_DILATION": 1},
            "RESNETS": {"DEPTH": 50, "OUT_FEATURES": ["res4"], "NUM_GROUPS": 1,
                        "NORM": "FrozenBN", "WIDTH_PER_GROUP": 64, "STRIDE_IN_1X1": True,
                        "RES5_DILATION": 1, "RES2_OUT_CHANNELS": 256,
                        "STEM_OUT_CHANNELS": 64,
                        "DEFORM_ON_PER_STAGE": [False, False, False, False]},
            "FPN": {"IN_FEATURES": [], "OUT_CHANNELS": 256, "NORM": "", "FUSE_TYPE": "sum"},
            "ANCHOR_GENERATOR": {"SIZES": [[32, 64, 128, 256, 512]],
                                 "ASPECT_RATIOS": [[0.5, 1.0, 2.0]],
                                 "ANGLES": [[-90, 0, 90]], "OFFSET": 0.0},
            "PROPOSAL_GENERATOR": {"NAME": "RPN", "MIN_SIZE": 0},
            "RPN": {"HEAD_NAME": "StandardRPNHead", "IN_FEATURES": ["res4"],
                    "BOUNDARY_THRESH": -1, "IOU_THRESHOLDS": [0.3, 0.7],
                    "IOU_LABELS": [0, -1, 1], "BATCH_SIZE_PER_IMAGE": 256,
                    "POSITIVE_FRACTION": 0.5, "BBOX_REG_WEIGHTS": (1.0, 1.0, 1.0, 1.0),
                    "BBOX_REG_LOSS_TYPE": "smooth_l1", "BBOX_REG_LOSS_WEIGHT": 1.0,
                    "SMOOTH_L1_BETA": 0.0, "LOSS_WEIGHT": 1.0, "PRE_NMS_TOPK_TRAIN": 12000,
                    "PRE_NMS_TOPK_TEST": 6000, "POST_NMS_TOPK_TRAIN": 2000,
                    "POST_NMS_TOPK_TEST": 1000, "NMS_THRESH": 0.7, "CONV_DIMS": [-1],
                    "UNSUP_LOSS_WEIGHT": 1.0, "LOSS": "CrossEntropy"},
            "ROI_HEADS": {"NAME": "Res5ROIHeads", "NUM_CLASSES": 80, "IN_FEATURES": ["res4"],
                          "IOU_THRESHOLDS": [0.5], "IOU_LABELS": [0, 1],
                          "BATCH_SIZE_PER_IMAGE": 512, "POSITIVE_FRACTION": 0.25,
                          "SCORE_THRESH_TEST": 0.05, "NMS_THRESH_TEST": 0.5,
                          "PROPOSAL_APPEND_GT": True, "LOSS": "CrossEntropy"},
            "ROI_BOX_HEAD": {"NAME": "", "BBOX_REG_LOSS_TYPE": "smooth_l1",
                             "BBOX_REG_LOSS_WEIGHT": 1.0,
                             "BBOX_REG_WEIGHTS": (10.0, 10.0, 5.0, 5.0), "SMOOTH_L1_BETA": 0.0,
                             "POOLER_RESOLUTION": 14, "POOLER_SAMPLING_RATIO": 0,
                             "POOLER_TYPE": "ROIAlignV2", "NUM_FC": 0, "FC_DIM": 1024,
                             "NUM_CONV": 0, "CONV_DIM": 256, "NORM": "",
                             "CLS_AGNOSTIC_BBOX_REG": False, "TRAIN_ON_PRED_BOXES": False,
                             "DAN_DIM": [4096, 4096]},
            "ROI_MASK_HEAD": {"NAME": "MaskRCNNConvUpsampleHead", "POOLER_RESOLUTION": 14,
                              "POOLER_SAMPLING_RATIO": 0, "NUM_CONV": 0, "CONV_DIM": 256,
                              "NORM": "", "CLS_AGNOSTIC_MASK": False,
                              "POOLER_TYPE": "ROIAlignV2"},
            # the WSJDS head's ASPP branch; no module reads these keys, as in
            # the JAX package, whose GeneralizedRCNNWSL.from_cfg does not either
            "SEM_SEG_HEAD": {"NAME": "SemSegFPNHead", "NUM_CLASSES": 54,
                             "ASSP_CONVS_DIM": [1024, 1024], "MASK_SOFTMAX": False,
                             "CONSTRAINT": False},
            "MRRP": {"MRRP_ON": False, "NUM_BRANCH": 3, "BRANCH_DILATIONS": [1, 2, 3],
                     "MRRP_STAGE": "res4", "TEST_BRANCH_IDX": 1},
        },
        "INPUT": {"MIN_SIZE_TRAIN": (800,), "MIN_SIZE_TRAIN_SAMPLING": "choice",
                  "MAX_SIZE_TRAIN": 1333, "MIN_SIZE_TEST": 800, "MAX_SIZE_TEST": 1333,
                  "RANDOM_FLIP": "horizontal",
                  "CROP": {"ENABLED": False, "TYPE": "relative_range", "SIZE": [0.9, 0.9]},
                  "FORMAT": "BGR", "MASK_FORMAT": "polygon"},
        "DATASETS": {"TRAIN": (), "TEST": (), "VAL": (), "PROPOSAL_FILES_TRAIN": (),
                     "PROPOSAL_FILES_TEST": (), "PROPOSAL_FILES_VAL": (),
                     "PRECOMPUTED_PROPOSAL_TOPK_TRAIN": 2000,
                     "PRECOMPUTED_PROPOSAL_TOPK_TEST": 1000, "CROSS_DATASET": False},
        "DATALOADER": {"NUM_WORKERS": 4, "ASPECT_RATIO_GROUPING": True,
                       "SAMPLER_TRAIN": "TrainingSampler", "REPEAT_THRESHOLD": 0.0,
                       "FILTER_EMPTY_ANNOTATIONS": True,
                       # stages 2-3: the labeled share of DATASETS.TRAIN, by a dataseed file
                       "SUP_PERCENT": 100.0, "RANDOM_DATA_SEED": 0,
                       "RANDOM_DATA_SEED_PATH": "dataseed/COCO_supervision.txt"},
        "SOLVER": {
            "LR_SCHEDULER_NAME": "WarmupMultiStepLR",
            "MAX_ITER": 40000,
            "BASE_LR": 0.001,
            "MOMENTUM": 0.9,
            "NESTEROV": False,
            "WEIGHT_DECAY": 0.0001,
            "WEIGHT_DECAY_NORM": 0.0,
            "GAMMA": 0.1,
            "STEPS": (30000,),
            "FACTOR_LIST": (1,),
            "WARMUP_FACTOR": 1.0 / 1000,
            "WARMUP_ITERS": 1000,
            "WARMUP_METHOD": "linear",
            "IMS_PER_BATCH": 16,
            "IMG_PER_BATCH_LABEL": 16,     # stages 2-3: labeled and unlabeled images a step
            "IMG_PER_BATCH_UNLABEL": 16,
            "CHECKPOINT_PERIOD": 5000,
            "REFERENCE_WORLD_SIZE": 0,
            "BIAS_LR_FACTOR": 1.0,
            "WEIGHT_DECAY_BIAS": 0.0001,
            "REFINE_LR_SCALE": 1.0,
            "REFINE_SCALE_ON": False,
            "AMP": False,
            "CLIP_GRADIENTS": {"ENABLED": False, "CLIP_TYPE": "value", "CLIP_VALUE": 1.0,
                               "NORM_TYPE": 2.0},
        },
        "TEST": {"EVAL_PERIOD": 0, "EVAL_TRAIN": True, "EXPECTED_RESULTS": [],
                 "DETECTIONS_PER_IMAGE": 100,
                 # test-time augmentation (tools/train_net_test_tta.py)
                 "AUG": {"ENABLED": False,
                         "MIN_SIZES": (400, 500, 600, 700, 800, 900, 1000, 1100, 1200),
                         "MAX_SIZE": 4000, "FLIP": True},
                 "PRECISE_BN": {"ENABLED": False, "NUM_ITER": 200},
                 "VAL_LOSS": True, "EVALUATOR": "COCOeval"},
        "WSL": {"VIS_TEST": False, "ITER_SIZE": 1, "MEAN_LOSS": True,
                "SIZE_EPOCH": 5000,   # CMIL's continuation schedule
                "CMIL": False, "USE_OBN": True,
                "CSC_MAX_ITER": 35000,   # the CSC head's constraints end after this step
                "REFINE_NUM": 3, "REFINE_REG": [False, False, False], "HAS_GAM": False,
                "REFINE_MIST": False, "MIST_P": 0.10, "MIST_THRE": 0.05, "MIST_TYPE": "nms",
                "CLS_AGNOSTIC_BBOX_KNOWN": False, "CASCADE_ON": False,
                "SAMPLING": {"SAMPLING_ON": False, "SAMPLING_TYPE": "high", "LB": 100,
                             "LAMBDA_MAX": 0.51,
                             "IOU_THRESHOLDS": [[0.5], [0.5], [0.5], [0.5]],
                             "IOU_LABELS": [[0, 1], [0, 1], [0, 1], [0, 1]],
                             "BATCH_SIZE_PER_IMAGE": [4096, 4096, 4096, 4096],
                             "POSITIVE_FRACTION": [1.0, 1.0, 1.0, 1.0]}},
        "OICRPLUS": {"BBOX_UPDATE": False, "PROPOSAL_NUM": 100000},
        "WSODEVAL": {"SAVE_DETECTION_RESULT": False, "SAVE_PATH": ""},
        # stages 2-3 (Unbiased Teacher)
        "SEMISUPNET": {"Trainer": "ubteacher", "BBOX_THRESHOLD": 0.7,
                       "PSEUDO_BBOX_SAMPLE": "thresholding", "TEACHER_UPDATE_ITER": 1,
                       "BURN_UP_STEP": 12000, "EMA_KEEP_RATE": 0.9996,
                       "UNSUP_LOSS_WEIGHT": 4.0, "SUP_LOSS_WEIGHT": 0.5,
                       "LOSS_WEIGHT_TYPE": "standard", "BURN_UP_WITH_STRONG_AUG": False,
                       "HAS_MULTI_LABEL": False, "EVAL_TEACHER": True},
        "EMAMODEL": {"SUP_CONSIST": True},
        # the config files' own namespace for padding and dtype knobs
        "TPU": {"PROPOSAL_CAPACITY": 4096, "PROPOSAL_BUCKETS": (), "PGT_SEED_CAPACITY": 1024,
                "PGT_CAPACITY": 128,   # ground-truth slots an image, stages 2-3
                "DETECTIONS_CAPACITY": 256, "IMAGE_SIZE_DIVISIBILITY": 64,
                "MAX_IMAGE_BUCKETS": 12, "COMPUTE_DTYPE": "bfloat16",
                "PARAM_DTYPE": "float32",
                # the JAX package's mesh: MESH_AXES and MESH_DEVICES have no
                # role here (the world is --num-gpus x --num-machines
                # processes); MODEL_AXIS_SIZE > 1 splits that world into
                # tensor-parallel groups of that size (parallel/tensor.py),
                # read by the stage-1 CLI alone, as in the JAX package
                "MESH_AXES": ("data",), "MESH_DEVICES": 0, "MODEL_AXIS_SIZE": 1,
                "REMAT_BACKBONE": False},
        "SEED": -1,
    })
