"""Synthetic VOC-like images, proposals and labels from a seed.

A traffic mix fixes the number of images, the raw sizes and their shares,
the proposals an image and the labels an image; the seed draws the pixels,
the proposals, the classes and the order of the sizes, so every seed has
the same set of sizes. Proposals are MCG-like random boxes: a corner
uniform in the image, a width and a height uniform in [min, max share of
the side], cut at the border; objectness logits uniform in [0, 1). The
pixels are uniform noise (the model's work does not depend on them).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def dataset_dicts(mix: Dict, num_classes: int, seed: int) -> List[dict]:
    rng = np.random.default_rng([int(seed), 0x5EED])
    n = int(mix["images"])
    sizes = [tuple(s) for s in mix["raw_hw"]]
    counts = [int(round(n * share)) for share in mix["raw_share"]]
    counts[-1] = n - sum(counts[:-1])
    order = rng.permutation(np.repeat(np.arange(len(sizes)), counts))
    p, lo, hi = int(mix["proposals"]), float(mix["box_min"]), float(mix["box_max_share"])
    k_lo, k_hi = mix["labels"]
    dicts = []
    for i, s in enumerate(order):
        h, w = sizes[s]
        x1 = rng.uniform(0, w - lo, p)
        y1 = rng.uniform(0, h - lo, p)
        boxes = np.stack([x1, y1, np.minimum(x1 + rng.uniform(lo, w * hi, p), w),
                          np.minimum(y1 + rng.uniform(lo, h * hi, p), h)], 1)
        classes = rng.choice(num_classes, int(rng.integers(k_lo, k_hi + 1)), replace=False)
        dicts.append({
            "image_id": 100000 + i,
            "image": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
            "proposal_boxes": boxes.astype(np.float32),
            "proposal_objectness_logits": rng.uniform(0, 1, p).astype(np.float32),
            "annotations": [{"category_id": int(c), "bbox": [0.0, 0.0, float(w), float(h)],
                             "iscrowd": 0} for c in sorted(classes)],
        })
    return dicts
