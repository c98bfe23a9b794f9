"""Random weights, synthetic test samples, synthetic training dataset dicts
and a synthetic VOC tree on disk, for runs without a checkpoint or a dataset
(the GPU smoke run, the inference profile, the CLIs and the tests): the
stage-1 VGG16 OICR+ model under d2-WSL names (and the UWSOD models on its
weights, ``build_synthetic_uwsod``), and the stage-2/3 R50-FPN
Faster R-CNN under detectron2's names, with a checkpoint writer for each, and
what stage-2 training reads besides the VOC tree: the pseudo-label JSON of
its splits (``write_pseudo_labels``) and the dataseed file
(``write_dataseed``); and one image with ground-truth boxes and instance
masks for the mask and cascade heads (``synthetic_mask_sample``).

Everything is made with numpy from a seed: the same seed gives the same
weights, images and proposals on any machine.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..config import get_cfg
from ..data import transforms as T
from ..data.datasets.voc import load_voc_instances
from ..data.proposals import save_proposals
from ..data.voc import CLASS_NAMES
from ..models.backbones.resnet import DEPTH_BLOCKS
from ..models.meta.rcnn import GeneralizedRCNN
from ..models.meta.rcnn_wsl_single import build_stage1_model
from .checkpoint import Checkpointer
from .weights import load_weights, state_dict_from_d2_frcnn, state_dict_from_d2_wsl


def random_d2_wsl_blobs(seed: int, num_classes: int, refine_k: int,
                        dan_dims: Sequence[int], fc1_in: int = 512 * 49
                        ) -> Dict[str, np.ndarray]:
    """Random VGG16 OICR+ weights under the d2-WSL checkpoint names:
    msra-scaled convs and the JAX package's head initializer scales; DAN fc1
    takes ``fc1_in`` inputs (the pooled ROIs of a wider backbone)."""
    rng = np.random.default_rng(seed)

    def normal(shape, std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    blobs = {}
    cin = 3
    for name, cout, n in (("plain1", 64, 2), ("plain2", 128, 2), ("plain3", 256, 3),
                          ("plain4", 512, 3), ("plain5", 512, 3)):
        for i in range(1, n + 1):
            blobs[f"backbone.{name}.conv{i}.weight"] = normal((cout, cin, 3, 3),
                                                              np.sqrt(2.0 / (9 * cout)))
            blobs[f"backbone.{name}.conv{i}.bias"] = normal((cout,), 0.01)
            cin = cout
    dims = [fc1_in, *dan_dims]
    for i in range(len(dan_dims)):
        blobs[f"roi_heads.box_head.fc{i + 1}.weight"] = normal((dims[i + 1], dims[i]), 0.005)
        blobs[f"roi_heads.box_head.fc{i + 1}.bias"] = np.full(dims[i + 1], 0.1, np.float32)
    f = dims[-1]
    for name in ("cls", "det"):
        blobs[f"roi_heads.box_predictor.{name}.weight"] = normal((num_classes, f),
                                                                 np.sqrt(2.0 / (f + num_classes)))
        blobs[f"roi_heads.box_predictor.{name}.bias"] = np.zeros(num_classes, np.float32)
    for k in range(refine_k):
        prefix = f"roi_heads.box_refinery_{k}"
        blobs[f"{prefix}.cls_score.weight"] = normal((num_classes + 1, f), 0.01)
        blobs[f"{prefix}.cls_score.bias"] = np.zeros(num_classes + 1, np.float32)
        blobs[f"{prefix}.bbox_pred.weight"] = normal((num_classes * 4, f), 0.001)
        blobs[f"{prefix}.bbox_pred.bias"] = np.zeros(num_classes * 4, np.float32)
    return blobs


_C2_BRANCH = {"shortcut": "branch1", "conv1": "branch2a", "conv2": "branch2b",
              "conv3": "branch2c"}


def random_c2_resnet_blobs(state_dict: Dict[str, torch.Tensor], seed: int,
                           prefix: str = "backbone.bottom_up.") -> Dict[str, np.ndarray]:
    """Random blobs under caffe2's ImageNet ResNet names (``conv1_w``,
    ``res_conv1_bn_{s,b}``, ``res{s}_{b}_branch{1,2a,2b,2c}_{w,bn_s,bn_b}``)
    for every conv and FrozenBN of ``state_dict``'s entries under
    ``prefix``, in their shapes, plus a classifier blob (``fc1000_w``) that
    no model reads: the input of ``engine/weights.py``'s caffe2 reader."""
    rng = np.random.default_rng(seed)
    blobs = {"fc1000_w": rng.standard_normal((10, 8), dtype=np.float32)}
    for name, t in state_dict.items():
        if not name.startswith(prefix) or "running_" in name:
            continue
        mod, conv, leaf = name[len(prefix):].split(".")
        base = "res_conv1" if mod == "stem" else \
            "{}_{}_{}".format(*mod.split("_block"), _C2_BRANCH[conv.removesuffix("_norm")])
        if conv.endswith("_norm"):
            key = f"{base}_bn_{'s' if leaf == 'weight' else 'b'}"
        else:
            key = "conv1_w" if mod == "stem" else f"{base}_w"
        blobs[key] = rng.standard_normal(tuple(t.shape), dtype=np.float32)
    return blobs


def synthetic_test_samples(cfg, n: int, raw_hw: Tuple[int, int], num_proposals: int,
                           seed: int) -> Tuple[List[dict], Dict[str, dict]]:
    """``n`` test samples with the keys of the JAX package's
    DatasetMapperTest, and evaluator annotations for them. Each sample is a
    random raw BGR image of ``raw_hw`` resized by ResizeShortestEdge(
    INPUT.MIN_SIZE_TEST, INPUT.MAX_SIZE_TEST) and padded to the
    TPU.IMAGE_SIZE_DIVISIBILITY canvas, with ``num_proposals`` random
    proposals transformed the same way and padded to TPU.PROPOSAL_CAPACITY."""
    rng = np.random.RandomState(seed)
    h, w = raw_hw
    div, cap = cfg.TPU.IMAGE_SIZE_DIVISIBILITY, cfg.TPU.PROPOSAL_CAPACITY
    t = T.resize_shortest_edge(h, w, cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST)
    ih, iw = t.output_size
    samples, annotations = [], {}
    for i in range(n):
        canvas = np.zeros((-(-ih // div) * div, -(-iw // div) * div, 3), np.float32)
        canvas[:ih, :iw] = t.apply_image(rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        x1 = rng.uniform(0, w - 8, num_proposals)
        y1 = rng.uniform(0, h - 8, num_proposals)
        raw = np.stack([x1, y1, np.minimum(x1 + rng.uniform(8, w / 2, num_proposals), w),
                        np.minimum(y1 + rng.uniform(8, h / 2, num_proposals), h)], 1)
        boxes = np.zeros((cap, 4), np.float32)
        boxes[:num_proposals] = T.clip_boxes(t.apply_box(raw), (ih, iw))
        objectness = np.zeros(cap, np.float32)
        objectness[:num_proposals] = rng.uniform(0, 1, num_proposals)
        image_id = 1000 + i
        samples.append({
            "image": canvas,
            "valid_hw": np.array([ih, iw], np.int32),
            "boxes": boxes,
            "objectness": objectness,
            "prop_valid": np.arange(cap) < num_proposals,
            "image_hw": np.array([ih, iw], np.float32),
            "image_id": image_id,
            "orig_hw": np.array([h, w], np.float32),
        })
        annotations[str(image_id)] = {"boxes": np.array([[50.0, 40.0, 300.0, 250.0]]),
                                      "classes": np.array([i % cfg.MODEL.ROI_HEADS.NUM_CLASSES]),
                                      "difficult": np.zeros(1, bool)}
    return samples, annotations


def synthetic_train_dicts(n: int, raw_hw: Tuple[int, int], num_proposals: int,
                          num_classes: int, seed: int) -> List[dict]:
    """``n`` training dataset dicts as the stage-1 loader reads them: a
    random (H, W, 3) uint8 BGR ``image`` of ``raw_hw``, ``num_proposals``
    random proposals of at least 8 px with objectness logits in [0, 1), and
    1-3 distinct image-level classes as annotations."""
    rng = np.random.RandomState(seed)
    h, w = raw_hw
    dicts = []
    for i in range(n):
        x1 = rng.uniform(0, w - 8, num_proposals)
        y1 = rng.uniform(0, h - 8, num_proposals)
        boxes = np.stack([x1, y1, np.minimum(x1 + rng.uniform(8, w / 2, num_proposals), w),
                          np.minimum(y1 + rng.uniform(8, h / 2, num_proposals), h)], 1)
        classes = rng.choice(num_classes, rng.randint(1, 4), replace=False)
        dicts.append({
            "image_id": 2000 + i,
            "image": rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
            "proposal_boxes": boxes.astype(np.float32),
            "proposal_objectness_logits": rng.uniform(0, 1, num_proposals).astype(np.float32),
            "annotations": [{"category_id": int(c), "bbox": [0.0, 0.0, float(w), float(h)],
                             "iscrowd": 0} for c in classes],
        })
    return dicts


def load_config(config_file: str, opts: Sequence = ()):
    """``config_file`` merged over the defaults, then the overrides ``opts``."""
    cfg = get_cfg()
    cfg.merge_from_file(config_file)
    cfg.merge_from_list(list(opts))
    return cfg


def random_ws_resnet_state_dict(depth: int, seed: int, prefix: str = "backbone."
                                ) -> Dict[str, np.ndarray]:
    """Random weights of a WS-ResNet trunk (``models/backbones/resnet_ws.py``
    at the JAX defaults' widths, 64 / 256 / 64) under the port's names:
    msra-scaled convs, the stem's first scaled down by the pixel range, and
    FrozenBN statistics near the identity with each block's last one at
    about 0.3, so that the features neither vanish nor grow through the
    blocks."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, cout, cin, k, gain=1.0):
        std = np.float32(gain * np.sqrt(2.0 / (cout * k * k)))
        sd[f"{prefix}{name}.weight"] = rng.standard_normal((cout, cin, k, k),
                                                           dtype=np.float32) * std

    def norm(name, c, gain=1.0):
        sd[f"{prefix}{name}.weight"] = rng.uniform(0.8 * gain, 1.2 * gain, c).astype(np.float32)
        sd[f"{prefix}{name}.bias"] = rng.standard_normal(c, dtype=np.float32) * np.float32(0.1)
        sd[f"{prefix}{name}.running_mean"] = rng.standard_normal(c, dtype=np.float32) * \
            np.float32(0.1)
        sd[f"{prefix}{name}.running_var"] = rng.uniform(0.8, 1.2, c).astype(np.float32)

    for i in (1, 2, 3):
        conv(f"stem.conv{i}", 64, 3 if i == 1 else 64, 3, gain=1.0 / 64 if i == 1 else 1.0)
        norm(f"stem.conv{i}_norm", 64)
    cin, cout, bott = 64, 256, 64
    for stage, n_blocks in enumerate(DEPTH_BLOCKS[depth], start=2):
        for b in range(n_blocks):
            pre = f"res{stage}_block{b}"
            block_in = cin if b == 0 else cout
            conv(f"{pre}.conv1", bott, block_in, 1)
            norm(f"{pre}.conv1_norm", bott)
            conv(f"{pre}.conv2", bott, bott, 3)
            norm(f"{pre}.conv2_norm", bott)
            conv(f"{pre}.conv3", cout, bott, 1)
            norm(f"{pre}.conv3_norm", cout, gain=0.3)
            if block_in != cout:
                conv(f"{pre}.shortcut", cout, block_in, 1)
                norm(f"{pre}.shortcut_norm", cout)
        cin, cout, bott = cout, cout * 2, bott * 2
    return sd


def random_conv_state_dict(shapes: Dict[str, Tuple[int, ...]], seed: int
                           ) -> Dict[str, np.ndarray]:
    """Random weights for convs with biases, by name and shape (``*.weight``
    (out, in, kh, kw), ``*.bias``): msra-scaled normals (std sqrt(2 /
    fan_in), the scale of the JAX package's he_normal) and zero biases, in
    sorted name order. For WSJDS's ASPP head."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name in sorted(shapes):
        shape = tuple(shapes[name])
        if name.endswith(".bias"):
            sd[name] = np.zeros(shape, np.float32)
        else:
            std = np.float32(np.sqrt(2.0 / int(np.prod(shape[1:]))))
            sd[name] = rng.standard_normal(shape, dtype=np.float32) * std
    return sd


def build_synthetic_model(cfg, device, seed: int):
    """The stage-1 model of ``cfg`` (``build_stage1_model``: MultiInputRCNN
    or GeneralizedRCNNWSL) with random weights from ``seed`` on ``device``,
    in eval mode. The blobs are drawn for the OICR+ model; the weights a
    model lacks (refinement branches of WSDDN, ContextLocNet, CSC and WSJDS,
    box regressors of branches without regression) are dropped. A WS-ResNet
    model takes its trunk from ``random_ws_resnet_state_dict`` and a DAN fc1
    as wide as its pooled ROIs; a WSJDS model its ASPP head from
    ``random_conv_state_dict``."""
    model = build_stage1_model(cfg, device="meta")
    fc1_in = model.roi_heads.dan.fc1.in_features
    blobs = random_d2_wsl_blobs(seed, cfg.MODEL.ROI_HEADS.NUM_CLASSES, cfg.WSL.REFINE_NUM,
                                cfg.MODEL.ROI_BOX_HEAD.DAN_DIM, fc1_in)
    vgg = getattr(model, "backbone_name", "vgg16") == "vgg16"
    if not vgg:
        blobs = {k: v for k, v in blobs.items() if not k.startswith("backbone.")}
    sd = state_dict_from_d2_wsl(blobs, keep=model.state_dict())
    if not vgg:
        sd.update((k, torch.from_numpy(v)) for k, v in
                  random_ws_resnet_state_dict(cfg.MODEL.RESNETS.DEPTH, seed).items())
    aspp = {k: tuple(v.shape) for k, v in model.state_dict().items()
            if k.startswith("roi_heads.sem_seg_head.")}
    sd.update((k, torch.from_numpy(v)) for k, v in random_conv_state_dict(aspp, seed).items())
    return load_weights(model, sd, device)


def build_synthetic_uwsod(cls, device, seed: int, **kwargs):
    """``cls(**kwargs)`` (``UWSODRCNN`` or ``MRRPUWSODRCNN``) with random
    weights from ``seed`` on ``device``, in eval mode: the VGG16 and the head
    of ``random_d2_wsl_blobs`` (MRRP's shared plain5 convs take plain5's
    names and shapes), the RPN head's convs normal(0.01) with zero biases
    (the JAX RPN head's initializer)."""
    model = cls(device="meta", **kwargs)
    head = model.roi_heads
    dan = [getattr(head.dan, f"fc{i + 1}") for i in range(head.dan.num_fc)]
    blobs = random_d2_wsl_blobs(seed, head.num_classes, head.refine_k,
                                [fc.out_features for fc in dan], dan[0].in_features)
    sd = state_dict_from_d2_wsl(blobs, keep=model.state_dict())
    rng = np.random.default_rng(seed + 1)
    for name, t in model.state_dict().items():
        if name.startswith("proposal_generator.head."):
            a = (np.zeros(tuple(t.shape), np.float32) if name.endswith(".bias") else
                 rng.standard_normal(tuple(t.shape), dtype=np.float32) * np.float32(0.01))
            sd[name] = torch.from_numpy(a)
    return load_weights(model, sd, device)


def write_stage1_checkpoint(output_dir: str, cfg, seed: int) -> str:
    """A stage-1 checkpoint ``model_final`` in ``output_dir`` (under "model",
    at "iter" 0; ``last_checkpoint`` names it) of the model of
    ``build_synthetic_model(cfg, _, seed)`` with each refinement branch's
    class rows of cls_score (all but the last, the background's) set to
    its first row. The classes then tie in each proposal, and each image's
    top detections cover every class: with independent random rows a few
    classes take all of them in every image, and PGF's class filter, which
    keeps only an image's labelled classes, is left with nothing to hand
    stage 2. Returns the file's path."""
    blobs = random_d2_wsl_blobs(seed, cfg.MODEL.ROI_HEADS.NUM_CLASSES, cfg.WSL.REFINE_NUM,
                                cfg.MODEL.ROI_BOX_HEAD.DAN_DIM)
    for k in range(cfg.WSL.REFINE_NUM):
        w = blobs[f"roi_heads.box_refinery_{k}.cls_score.weight"]
        w[:-1] = w[0]
    ckpt = Checkpointer(output_dir)
    ckpt.save("model_final", {"model": state_dict_from_d2_wsl(blobs), "iter": 0})
    return ckpt.path("model_final")


def build_synthetic_slice(config_file: str, device, num_images: int,
                          raw_hw: Tuple[int, int], num_proposals: int, seed: int,
                          opts: Sequence = ()):
    """The model of ``config_file`` (with the overrides ``opts``) with random
    weights from ``seed`` on ``device``, and ``num_images`` synthetic samples
    with their annotations. Returns (cfg, model, samples, annotations)."""
    cfg = load_config(config_file, opts)
    model = build_synthetic_model(cfg, device, seed)
    samples, annotations = synthetic_test_samples(cfg, num_images, raw_hw, num_proposals, seed)
    return cfg, model, samples, annotations


def _voc_xml(fileid: str, hw: Tuple[int, int], objects: List[tuple]) -> str:
    objs = "".join(
        f"  <object><name>{name}</name><difficult>{difficult}</difficult><bndbox>"
        f"<xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax>"
        f"</bndbox></object>\n" for name, difficult, (x1, y1, x2, y2) in objects)
    return (f"<annotation>\n  <filename>{fileid}.jpg</filename>\n  <size><width>{hw[1]}"
            f"</width><height>{hw[0]}</height><depth>3</depth></size>\n{objs}</annotation>\n")


def write_synthetic_voc(root: str,
                        splits: Sequence[Tuple[str, int]] = (("train", 8), ("val", 4), ("test", 4)),
                        raw_hw: Tuple[int, int] = (375, 500), num_proposals: int = 4000,
                        seed: int = 0) -> Dict[str, List[str]]:
    """A VOC-format dataset under ``root`` at the paths the stage-1 configs
    name: ``datasets/VOC2007/{JPEGImages,Annotations,ImageSets/Main}`` and
    ``datasets/proposals/mcg_voc_2007_{split}_d2.pkl``. Each image is a
    random ``raw_hw`` JPEG with one or two painted objects of random classes
    and one object marked difficult in its XML (1-based inclusive boxes);
    its ``num_proposals`` proposals (the first on the first object) carry
    objectness logits in [0, 1). Returns each split's image ids."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    h, w = raw_hw
    voc = os.path.join(root, "datasets", "VOC2007")
    for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(voc, sub), exist_ok=True)
    os.makedirs(os.path.join(root, "datasets", "proposals"), exist_ok=True)
    ids_per_split, n = {}, 0
    for split, count in splits:
        ids, boxes, logits = [], [], []
        for _ in range(count):
            n += 1
            fileid = f"{n:06d}"
            img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            objects = []
            n_easy = rng.randint(1, 3)
            for k in range(n_easy + 1):    # the last one is difficult
                bw, bh = rng.randint(w // 8, w // 2), rng.randint(h // 8, h // 2)
                x1, y1 = rng.randint(0, w - bw), rng.randint(0, h - bh)
                img[y1:y1 + bh, x1:x1 + bw] = rng.randint(0, 256, 3)
                objects.append((CLASS_NAMES[rng.randint(len(CLASS_NAMES))], int(k == n_easy),
                                (x1 + 1, y1 + 1, x1 + bw, y1 + bh)))
            Image.fromarray(img).save(os.path.join(voc, "JPEGImages", fileid + ".jpg"),
                                      quality=92)
            with open(os.path.join(voc, "Annotations", fileid + ".xml"), "w") as f:
                f.write(_voc_xml(fileid, raw_hw, objects))
            x0, y0 = rng.uniform(0, w - 8, num_proposals), rng.uniform(0, h - 8, num_proposals)
            b = np.stack([x0, y0, np.minimum(x0 + rng.uniform(8, w / 2, num_proposals), w),
                          np.minimum(y0 + rng.uniform(8, h / 2, num_proposals), h)], 1)
            gx1, gy1, gx2, gy2 = objects[0][2]
            b[0] = [gx1 - 1, gy1 - 1, gx2, gy2]
            ids.append(fileid)
            boxes.append(b.astype(np.float32))
            logits.append(rng.uniform(0, 1, num_proposals).astype(np.float32))
        with open(os.path.join(voc, "ImageSets", "Main", split + ".txt"), "w") as f:
            f.write("".join(i + "\n" for i in ids))
        save_proposals(os.path.join(root, "datasets", "proposals",
                                    f"mcg_voc_2007_{split}_d2.pkl"), ids, boxes, logits)
        ids_per_split[split] = ids
    return ids_per_split


def write_pseudo_labels(root: str, splits: Sequence[str] = ("train", "val")) -> None:
    """The pseudo labels stage 1 would hand stage 2 for the VOC tree under
    ``root``, ``datasets/VOC2007/pseudo_labels/oicr_plus_voc_2007_{split}.json``
    (read by ``data/datasets/voc.py:load_voc_instances_wsl``): each image's
    objects not marked difficult in its XML, {category_id, bbox [x1, y1,
    x2, y2]} in integers under its integer id, and its classes under
    "multi_label"."""
    voc = os.path.join(root, "datasets", "VOC2007")
    os.makedirs(os.path.join(voc, "pseudo_labels"), exist_ok=True)
    for split in splits:
        pseudo, multi_label = {}, {}
        for d in load_voc_instances(voc, split):
            key = str(int(d["image_id"]))
            pseudo[key] = [{"category_id": a["category_id"], "bbox": [int(v) for v in a["bbox"]]}
                           for a in d["annotations"]]
            multi_label[key] = sorted({a["category_id"] for a in d["annotations"]})
        with open(os.path.join(voc, "pseudo_labels", f"oicr_plus_voc_2007_{split}.json"),
                  "w") as f:
            json.dump({**pseudo, "multi_label": multi_label}, f)


def write_dataseed(root: str, cfg, num_images: int) -> str:
    """The dataseed file ``divide_label_unlabel`` reads for ``cfg``
    (DATALOADER.RANDOM_DATA_SEED_PATH, relative to ``root``):
    {SUP_PERCENT: {RANDOM_DATA_SEED: [index, ...]}}, int(SUP_PERCENT / 100 x
    ``num_images``) distinct indices of the training set, drawn from the
    seed. Returns the file's path."""
    dl = cfg.DATALOADER
    k = int(dl.SUP_PERCENT / 100.0 * num_images)
    idx = np.random.RandomState(dl.RANDOM_DATA_SEED).choice(num_images, k, replace=False)
    path = os.path.join(root, dl.RANDOM_DATA_SEED_PATH)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({str(dl.SUP_PERCENT): {str(dl.RANDOM_DATA_SEED): sorted(idx.tolist())}}, f)
    return path


def synthetic_mask_sample(canvas_hw: Tuple[int, int], image_hw: Tuple[int, int], num_gt: int,
                          slots: int, num_classes: int, seed: int) -> Dict[str, np.ndarray]:
    """One image of uniform noise (``image_hw`` on a zero ``canvas_hw``
    canvas, float32 BGR in [0, 255)) with ``num_gt`` ground-truth boxes in
    ``slots`` padded slots (each side 15-60% of the image's, classes at
    random) and their instance masks: a filled ellipse inscribed in each box,
    (slots, H, W) uint8 on the canvas, zero in the padding. Keys: image,
    image_hw (float32 (h, w)), gt_boxes, gt_classes, gt_valid, gt_masks."""
    rng = np.random.default_rng(seed)
    h, w = image_hw
    image = np.zeros(tuple(canvas_hw) + (3,), np.float32)
    image[:h, :w] = rng.uniform(0, 255, (h, w, 3))
    boxes = np.zeros((slots, 4), np.float32)
    masks = np.zeros((slots,) + tuple(canvas_hw), np.uint8)
    yy, xx = np.mgrid[:canvas_hw[0], :canvas_hw[1]] + 0.5
    for i in range(num_gt):
        bw, bh = rng.uniform(0.15, 0.6) * w, rng.uniform(0.15, 0.6) * h
        x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
        boxes[i] = [x1, y1, x1 + bw, y1 + bh]
        masks[i] = (((xx - x1 - bw / 2) / (bw / 2)) ** 2
                    + ((yy - y1 - bh / 2) / (bh / 2)) ** 2 <= 1)
    classes = np.zeros(slots, np.int32)
    classes[:num_gt] = rng.integers(0, num_classes, num_gt)
    return {"image": image, "image_hw": np.array(image_hw, np.float32), "gt_boxes": boxes,
            "gt_classes": classes, "gt_valid": np.arange(slots) < num_gt, "gt_masks": masks}


def random_d2_frcnn_state_dict(cfg, seed: int) -> Dict[str, np.ndarray]:
    """Random weights of the R50-FPN Faster R-CNN of ``cfg`` under
    detectron2's state-dict names, at the config's widths: msra-scaled convs
    (the stem's scaled down by the pixel range), FrozenBN statistics near the
    identity with the residual branch's last one at about 0.3, so that the
    features neither vanish nor grow through the 16 blocks, fan-in scaled
    FPN, RPN and box-head weights, class scores spread wide enough that
    detections pass the 0.05 score threshold."""
    rng = np.random.default_rng(seed)

    def normal(shape, std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    def uniform(shape, lo, hi):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    sd = {}

    def conv(name, cout, cin, k, gain=1.0, bias=False):
        sd[f"{name}.weight"] = normal((cout, cin, k, k), gain * np.sqrt(2.0 / (cout * k * k)))
        if bias:
            sd[f"{name}.bias"] = normal((cout,), 0.01)

    def norm(name, c, gain=1.0):
        sd[f"{name}.weight"] = uniform((c,), 0.8 * gain, 1.2 * gain)
        sd[f"{name}.bias"] = normal((c,), 0.1)
        sd[f"{name}.running_mean"] = normal((c,), 0.1)
        sd[f"{name}.running_var"] = uniform((c,), 0.8, 1.2)

    r = cfg.MODEL.RESNETS
    bu = "backbone.bottom_up"
    conv(f"{bu}.stem.conv1", r.STEM_OUT_CHANNELS, 3, 7, gain=1.0 / 64)
    norm(f"{bu}.stem.conv1.norm", r.STEM_OUT_CHANNELS)
    cin, cout, bott = r.STEM_OUT_CHANNELS, r.RES2_OUT_CHANNELS, r.WIDTH_PER_GROUP
    stage_channels = []
    for stage, n_blocks in enumerate(DEPTH_BLOCKS[r.DEPTH], start=2):
        for b in range(n_blocks):
            pre = f"{bu}.res{stage}.{b}"
            block_in = cin if b == 0 else cout
            conv(f"{pre}.conv1", bott, block_in, 1)
            norm(f"{pre}.conv1.norm", bott)
            conv(f"{pre}.conv2", bott, bott, 3)
            norm(f"{pre}.conv2.norm", bott)
            conv(f"{pre}.conv3", cout, bott, 1)
            norm(f"{pre}.conv3.norm", cout, gain=0.3)
            if b == 0:
                conv(f"{pre}.shortcut", cout, block_in, 1)
                norm(f"{pre}.shortcut.norm", cout)
        stage_channels.append(cout)
        cin, cout, bott = cout, cout * 2, bott * 2
    f = cfg.MODEL.FPN.OUT_CHANNELS
    for i, c in enumerate(stage_channels):
        sd[f"backbone.fpn_lateral{i + 2}.weight"] = normal((f, c, 1, 1), np.sqrt(1.0 / c))
        sd[f"backbone.fpn_lateral{i + 2}.bias"] = np.zeros(f, np.float32)
        sd[f"backbone.fpn_output{i + 2}.weight"] = normal((f, f, 3, 3), np.sqrt(1.0 / (9 * f)))
        sd[f"backbone.fpn_output{i + 2}.bias"] = np.zeros(f, np.float32)
    a = len(cfg.MODEL.ANCHOR_GENERATOR.SIZES[0]) * len(cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS[0])
    rpn = "proposal_generator.rpn_head"
    for name, cout_, k in (("conv", f, 3), ("objectness_logits", a, 1), ("anchor_deltas", 4 * a, 1)):
        sd[f"{rpn}.{name}.weight"] = normal((cout_, f, k, k), 0.01)
        sd[f"{rpn}.{name}.bias"] = np.zeros(cout_, np.float32)
    head = cfg.MODEL.ROI_BOX_HEAD
    if head.NUM_CONV:
        raise ValueError("random_d2_frcnn_state_dict: box-head convs are not made")
    d = f * head.POOLER_RESOLUTION ** 2
    for i in range(head.NUM_FC):
        sd[f"roi_heads.box_head.fc{i + 1}.weight"] = normal((head.FC_DIM, d), np.sqrt(1.0 / d))
        sd[f"roi_heads.box_head.fc{i + 1}.bias"] = np.zeros(head.FC_DIM, np.float32)
        d = head.FC_DIM
    k = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    nb = 1 if head.CLS_AGNOSTIC_BBOX_REG else k
    sd["roi_heads.box_predictor.cls_score.weight"] = normal((k + 1, d), 0.05)
    sd["roi_heads.box_predictor.cls_score.bias"] = np.zeros(k + 1, np.float32)
    sd["roi_heads.box_predictor.bbox_pred.weight"] = normal((4 * nb, d), 0.001)
    sd["roi_heads.box_predictor.bbox_pred.bias"] = np.zeros(4 * nb, np.float32)
    return sd


def build_synthetic_frcnn(cfg, device, seed: int) -> GeneralizedRCNN:
    """The stage-2/3 detector of ``cfg`` with random weights from ``seed``
    on ``device``, in eval mode."""
    sd = state_dict_from_d2_frcnn(random_d2_frcnn_state_dict(cfg, seed))
    return load_weights(GeneralizedRCNN.from_cfg(cfg, device="meta"), sd, device)


def write_stage2_checkpoint(output_dir: str, cfg, seed: int, iteration: int = 0,
                            name: str = "model_final") -> str:
    """A stage-2 checkpoint in ``output_dir`` in the stage-1 layout: the
    student's weights (seed ``seed``) under "model", the teacher's (seed
    ``seed + 1``) under "teacher", and "iter"; ``last_checkpoint`` names
    it. Returns the file's path."""
    student = state_dict_from_d2_frcnn(random_d2_frcnn_state_dict(cfg, seed))
    teacher = state_dict_from_d2_frcnn(random_d2_frcnn_state_dict(cfg, seed + 1))
    ckpt = Checkpointer(output_dir)
    ckpt.save(name, {"model": student, "teacher": teacher, "iter": iteration})
    return ckpt.path(name)
