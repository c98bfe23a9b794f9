"""The published arithmetic of the models, in floating-point operations
(a multiply-add is 2), at each view's valid (resized) extent and the valid
proposals, not the padded canvas or the padded proposal slots.

Stage 1 (VGG16 with dilated conv5, the DAN box head, WSDDN and K
refinement branches): convolutions 2 * cin * cout * 9 * h * w at each
layer's valid extent; fully connected layers 2 * rows * in * out. A
training step runs the forward and the backward from plain3 up (plain1 and
plain2 are frozen): each trained layer's weight gradient costs its forward
again, and its input gradient too, but for plain3's first conv, whose input
needs none.

Stage 2 (Faster R-CNN R50-FPN, inference): the ResNet-50 convs (the
stride in each stage's first 1x1 conv), the FPN's laterals and outputs,
the RPN head on p2..p6, and the box head on the proposals kept.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

VGG = (("plain1", 3, 64, 2, 1, 2), ("plain2", 64, 128, 2, 1, 2), ("plain3", 128, 256, 3, 1, 2),
       ("plain4", 256, 512, 3, 1, 1), ("plain5", 512, 512, 3, 2, 0))


def vgg16_layers(h: int, w: int) -> List[Tuple[str, float]]:
    """(stage, forward FLOPs) of each conv at an (h, w) valid input."""
    out = []
    for name, cin, cout, n, _, pool in VGG:
        for i in range(n):
            out.append((name, 2.0 * (cin if i == 0 else cout) * cout * 9 * h * w))
        if pool:
            h, w = max((h - 2) // pool + 1, 1), max((w - 2) // pool + 1, 1)
    return out


def head_fwd(rows: int, dan: Sequence[int], num_classes: int, refine_k: int,
             wsddn: bool) -> float:
    dims = [512 * 49, *dan]
    f = sum(2.0 * rows * a * b for a, b in zip(dims[:-1], dims[1:]))
    f += refine_k * 2.0 * rows * dims[-1] * (num_classes + 1 + 4 * num_classes)
    if wsddn:
        f += 2 * 2.0 * rows * dims[-1] * num_classes
    return f


def stage1_train_step(views_hw: Sequence[Tuple[int, int]], proposals: int, dan: Sequence[int],
                      num_classes: int, refine_k: int, frozen=("plain1", "plain2")) -> float:
    """One image of 4 views: forward and backward."""
    total = 0.0
    for h, w in views_hw:
        first = True
        for stage, f in vgg16_layers(h, w):
            total += f
            if stage in frozen:
                continue
            total += f if first else 2 * f
            first = False
    return total + 3 * head_fwd(len(views_hw) * proposals, dan, num_classes, refine_k, True)


def stage1_predict(hw: Tuple[int, int], proposals: int, dan: Sequence[int], num_classes: int,
                   refine_k: int) -> float:
    return sum(f for _, f in vgg16_layers(*hw)) + head_fwd(proposals, dan, num_classes,
                                                          refine_k, False)


def _down(n: int) -> int:
    return (n + 1) // 2


def r50_fpn_predict(h: int, w: int, proposals: int, fpn: int, fc: Sequence[int],
                    num_classes: int, blocks: Sequence[int] = (3, 4, 6, 3)) -> float:
    conv = lambda cin, cout, k, hh, ww: 2.0 * cin * cout * k * k * hh * ww  # noqa: E731
    hh, ww = _down(h), _down(w)
    total = conv(3, 64, 7, hh, ww)
    hh, ww = _down(hh), _down(ww)
    cin, cout, bott = 64, 256, 64
    sizes = []
    for stage, n in enumerate(blocks, start=2):
        for b in range(n):
            if b == 0 and stage > 2:
                hh, ww = _down(hh), _down(ww)
            i = cin if b == 0 else cout
            total += conv(i, bott, 1, hh, ww) + conv(bott, bott, 3, hh, ww) + \
                conv(bott, cout, 1, hh, ww)
            if b == 0:
                total += conv(i, cout, 1, hh, ww)
        sizes.append((cout, hh, ww))
        cin, cout, bott = cout, cout * 2, bott * 2
    for c, a, b in sizes:
        total += conv(c, fpn, 1, a, b) + conv(fpn, fpn, 3, a, b)
    levels = [(a, b) for _, a, b in sizes] + [(_down(sizes[-1][1]), _down(sizes[-1][2]))]
    for a, b in levels:
        total += conv(fpn, fpn, 3, a, b) + conv(fpn, 3, 1, a, b) + conv(fpn, 12, 1, a, b)
    dims = [fpn * 49, *fc]
    total += sum(2.0 * proposals * x * y for x, y in zip(dims[:-1], dims[1:]))
    return total + 2.0 * proposals * dims[-1] * (num_classes + 1 + 4 * num_classes)
