"""Draw detections or dataset boxes onto images (host only, PIL).

Counterpart of ``sos_wsod_tpu/tools/visualize.py`` (the reference's WSL
visualize_json_results.py and visualize_data.py, with PIL in place of cv2):
a detection-result JSON (the stage-1 dump: [{image_id, category_id 1-based,
score, bbox XYXY}]) or a dataset's annotations, one colour a label.

    python -m sos_wsod_torch.tools.visualize --input dets.json \\
        --image-dir datasets/VOC2007/JPEGImages --output vis/ [--conf-threshold 0.5]
"""
from __future__ import annotations

import argparse
import colorsys
import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence


def _palette(n: int):
    return [tuple(int(c * 255) for c in colorsys.hsv_to_rgb(i / max(n, 1), 0.8, 1.0))
            for i in range(n)]


def draw_detections(image, boxes: Sequence[Sequence[float]], labels: Sequence[str],
                    scores: Optional[Sequence[float]] = None,
                    colors: Optional[Sequence] = None):
    """A copy of the PIL ``image`` in RGB with each XYXY box outlined and
    labelled (with its score when given)."""
    from PIL import ImageDraw

    img = image.convert("RGB")
    draw = ImageDraw.Draw(img)
    colors = colors or _palette(max(len(set(labels)), 1))
    cmap = {}
    scores = list(scores) if scores is not None else [None] * len(labels)
    for box, label, score in zip(boxes, labels, scores):
        if label not in cmap:
            cmap[label] = colors[len(cmap) % len(colors)]
        x1, y1, x2, y2 = [float(v) for v in box]
        draw.rectangle([x1, y1, x2, y2], outline=cmap[label], width=2)
        draw.text((x1 + 2, max(y1 - 10, 0)), label if score is None else f"{label} {score:.2f}",
                  fill=cmap[label])
    return img


def visualize_json_results(result_json: str, image_dir: str, out_dir: str,
                           class_names: Sequence[str], score_thresh: float = 0.5,
                           limit: int = 100) -> int:
    """Draw the detections with score >= ``score_thresh`` of up to ``limit``
    images (by sorted image id) into ``out_dir``; returns the count."""
    from PIL import Image

    with open(result_json) as f:
        results = json.load(f)
    by_img: Dict[str, List[dict]] = defaultdict(list)
    for r in results:
        if r.get("score", 1.0) >= score_thresh:
            by_img[str(r["image_id"])].append(r)
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for img_id, dets in sorted(by_img.items()):
        if n >= limit:
            break
        path = os.path.join(image_dir, f"{img_id}.jpg")
        if not os.path.exists(path):
            continue
        img = draw_detections(Image.open(path), [d["bbox"] for d in dets],
                              [class_names[d["category_id"] - 1] for d in dets],
                              [d.get("score", 1.0) for d in dets])
        img.save(os.path.join(out_dir, f"{img_id}.jpg"))
        n += 1
    return n


def visualize_dataset(dataset_dicts, out_dir: str, class_names, limit: int = 50,
                      draw_proposals: int = 0) -> int:
    """Draw the annotations (and the first ``draw_proposals`` precomputed
    proposals) of up to ``limit`` dataset dicts into ``out_dir``."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for record in dataset_dicts:
        if n >= limit:
            break
        if not os.path.exists(record.get("file_name", "")):
            continue
        anns = record.get("annotations", [])
        boxes = [ann["bbox"] for ann in anns]
        labels = [class_names[ann["category_id"]] for ann in anns]
        if draw_proposals and "proposal_boxes" in record:
            for b in record["proposal_boxes"][:draw_proposals]:
                boxes.append(b)
                labels.append("proposal")
        out = draw_detections(Image.open(record["file_name"]), boxes, labels)
        out.save(os.path.join(out_dir, os.path.basename(record["file_name"])))
        n += 1
    return n


def main(argv=None):
    from ..data.voc import CLASS_NAMES

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--input", required=True, help="detection result json")
    ap.add_argument("--image-dir", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--conf-threshold", type=float, default=0.5)
    ap.add_argument("--limit", type=int, default=100)
    args = ap.parse_args(argv)
    n = visualize_json_results(args.input, args.image_dir, args.output, CLASS_NAMES,
                               args.conf_threshold, args.limit)
    print(f"rendered {n} images -> {args.output}")


if __name__ == "__main__":
    main()
