"""ImageNet classification pretraining of the WSOD backbones.

Counterpart of ``tools/train_imagenet.py`` (the reference's
uwsod/projects/WSL/tools/imagenet.py): a VGG16 (conv5 undilated, nothing
frozen) or WS-ResNet-50 (res5 undilated) trunk, a global average pool and a
linear classifier (weights drawn from normal(0.01), bias zero), trained with
softmax cross-entropy by SGD with momentum and weight decay: for each
parameter p with gradient g, the JAX tool's optax.chain(add_decayed_weights,
sgd) computes m = momentum * m + (g + wd * p), p = p - lr * m, which is
torch.optim.SGD's update. Batches are {"image": (B, H, W, 3) float,
mean-subtracted BGR, "label": (B,)}; as in the JAX tool, only ``--synthetic``
data (the same RandomState draws) are read.

    python -m sos_wsod_torch.tools.train_imagenet --synthetic [--arch vgg16|ws_resnet50]
        [--batch-size 32] [--image-size 224] [--max-iter 100] [--device cpu]

It runs on the card unless ``--device cpu`` is given, with bf16 autocast
unless ``--dtype float32``. WS-ResNet's FrozenBN statistics are buffers and
take no weight decay (the JAX tool's optimizer decays them as parameters).
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Iterator

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from ..models.backbones.resnet_ws import WSResNet
from ..models.backbones.vgg import VGG16


class Classifier(nn.Module):
    """Trunk -> global average pool -> linear; (B, H, W, 3) -> (B, classes)
    logits."""

    def __init__(self, arch: str, num_classes: int, device=None):
        super().__init__()
        if arch == "vgg16":
            self.backbone = VGG16(conv5_dilation=1, freeze_at=0, device=device)
        elif arch == "ws_resnet50":
            self.backbone = WSResNet(depth=50, freeze_at=0, res5_dilation=1,
                                     out_features=("res5",), device=device)
        else:
            raise ValueError(f"unknown arch {arch!r}")
        self.arch = arch
        self.linear = nn.Linear(self.backbone.out_channels, num_classes, device=device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2)      # NCHW in channels_last memory
        feats = self.backbone(x)
        if self.arch != "vgg16":
            feats = feats["res5"]
        return self.linear(feats.mean(dim=(2, 3)))


def build_model(arch: str, num_classes: int, device=None) -> Classifier:
    """The classifier with its initial weights drawn from seed 0: convs
    msra-filled (kaiming normal, fan out) with zero biases, the linear layer
    from normal(0.01) with a zero bias, as the JAX tool's initializers draw
    them (not the same values)."""
    model = Classifier(arch, num_classes, device=device)
    generator = torch.Generator(device=device or "cpu").manual_seed(0)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                std = (2.0 / (m.out_channels * m.kernel_size[0] * m.kernel_size[1])) ** 0.5
                m.weight.normal_(0.0, std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
        model.linear.weight.normal_(0.0, 0.01, generator=generator)
        model.linear.bias.zero_()
    return model.to(memory_format=torch.channels_last)


Batch = Dict[str, torch.Tensor]


def make_train_step(model: Classifier, optimizer: torch.optim.Optimizer,
                    bf16: bool = False) -> Callable[[Batch], Batch]:
    """One SGD step on a batch; returns {"loss": mean softmax CE of the f32
    logits, "acc": top-1 accuracy of the logits}, detached."""
    device = next(model.parameters()).device

    def step(batch: Batch) -> Batch:
        model.train()
        with torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16):
            logits = model(batch["image"])
        labels = batch["label"].long()
        loss = F.cross_entropy(logits.float(), labels)
        acc = (logits.argmax(dim=-1) == labels).float().mean()
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach(), "acc": acc}

    return step


def synthetic_batches(batch_size: int, image_size: int, num_classes: int,
                      seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """The JAX tool's synthetic batches, draw for draw."""
    rng = np.random.RandomState(seed)
    while True:
        yield {
            "image": rng.rand(batch_size, image_size, image_size, 3)
            .astype(np.float32) * 255 - 120,
            "label": rng.randint(0, num_classes, batch_size),
        }


def argument_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="vgg16", choices=["vgg16", "ws_resnet50"])
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--weight-decay", type=float, default=5e-4)
    ap.add_argument("--max-iter", type=int, default=100)
    ap.add_argument("--log-period", type=int, default=20)
    ap.add_argument("--synthetic", action="store_true", help="random data (smoke/benchmark run)")
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--device", default="cuda", help="torch device; the card unless 'cpu'")
    return ap


def main(argv=None) -> Dict[str, object]:
    """Trains ``--max-iter`` steps; returns {"model", "metrics": the last
    step's {"loss", "acc"} as floats, "img_per_s"}."""
    args = argument_parser().parse_args(argv)
    if not args.synthetic:
        raise SystemExit("train_imagenet reads synthetic data only (--synthetic), as the JAX "
                         "tool does")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_imagenet: no CUDA device; pass --device cpu to run on the CPU")
    model = build_model(args.arch, args.num_classes, device=device)
    optimizer = torch.optim.SGD(model.parameters(), lr=args.lr, momentum=args.momentum,
                                weight_decay=args.weight_decay)
    step = make_train_step(model, optimizer, bf16=args.dtype == "bfloat16")
    data = synthetic_batches(args.batch_size, args.image_size, args.num_classes)
    metrics, t0 = {}, time.perf_counter()
    for it in range(args.max_iter):
        batch = {k: torch.as_tensor(v, device=device) for k, v in next(data).items()}
        metrics = step(batch)
        if (it + 1) % args.log_period == 0 or it + 1 == args.max_iter:
            loss, acc = float(metrics["loss"]), float(metrics["acc"])   # waits for the step
            rate = (it + 1) * args.batch_size / (time.perf_counter() - t0)
            print(f"iter {it + 1}: loss={loss:.4f} acc={acc:.3f} ({rate:.1f} img/s)", flush=True)
    return {"model": model, "metrics": {k: float(v) for k, v in metrics.items()},
            "img_per_s": args.max_iter * args.batch_size / (time.perf_counter() - t0)}


if __name__ == "__main__":
    main()
