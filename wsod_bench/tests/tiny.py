"""A cell of BENCHMARK.json shrunk to run on the CPU in seconds: the same
harness, driver, system and reference, at tiny widths and images, float32."""
from __future__ import annotations

import copy
import json
import time

from wsod_bench import run, spec

CPU_OPTS = ["MODEL.DEVICE", "cpu", "TPU.COMPUTE_DTYPE", "float32",
            "MODEL.ROI_BOX_HEAD.DAN_DIM", "[16, 16]", "INPUT.MIN_SIZE_TRAIN", "(40, 48)",
            "INPUT.MAX_SIZE_TRAIN", 80, "INPUT.MIN_SIZE_TEST", 48, "INPUT.MAX_SIZE_TEST", 80,
            "TPU.PROPOSAL_CAPACITY", 32, "TPU.PGT_SEED_CAPACITY", 16,
            "DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN", 30,
            "DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST", 30, "DATALOADER.NUM_WORKERS", 2,
            "MODEL.RESNETS.DEPTH", 14, "MODEL.FPN.OUT_CHANNELS", 32,
            "MODEL.ROI_BOX_HEAD.FC_DIM", 64, "MODEL.RPN.PRE_NMS_TOPK_TEST", 64,
            "MODEL.RPN.POST_NMS_TOPK_TEST", 32]
MIX = {"images": 6, "raw_hw": [[60, 80], [80, 60], [53, 80]], "proposals": 30,
       "check_steps": 3, "warm_steps": 1, "trace_steps": 2, "check_images": 3,
       "trace_images": 2}


BENCH_CELLS = [w["name"] for w in json.loads((spec.ROOT / "BENCHMARK.json").read_text())
               ["workloads"]]


def tiny_cell(workload: str) -> spec.Cell:
    cell = spec.load(spec.ROOT / "BENCHMARK.json", workload)
    cell = copy.deepcopy(cell)
    cell.traffic.update(MIX)
    return cell


# the box heads at their published widths, on the tiny images
WIDE_OPTS = CPU_OPTS + ["MODEL.ROI_BOX_HEAD.DAN_DIM", "[4096, 4096]", "MODEL.ROI_BOX_HEAD.FC_DIM",
                        1024, "MODEL.FPN.OUT_CHANNELS", 256]


def run_tiny(workload: str, seed: int = 7, trace: bool = False, seconds: float = 0.5,
             opts=CPU_OPTS) -> dict:
    ctx = run.Context(tiny_cell(workload), seed, seconds, trace, "cpu", time.perf_counter(),
                      overrides=list(opts), log=lambda msg: None)
    return run.run_cell(ctx)
