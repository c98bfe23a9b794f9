"""The data-parallel try runs its ranks in one process group on the CPU
(gloo), at the tiny sizes: every rank reports, and the replicas agree."""
from __future__ import annotations

import json

from wsod_bench import dp_try
from wsod_bench.tests.tiny import CPU_OPTS


def test_two_ranks_agree(capsys):
    assert dp_try.main(["--workload", "oicr_plus.train", "--ranks", "2", "--seed", "3",
                        "--steps", "2", "--device", "cpu",
                        "--set", *[str(x) for x in CPU_OPTS]]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["rank"] for r in line["per_rank"]] == [0, 1]
    assert all(r["backend"] == "gloo" and r["replica_norm_spread"] == 0.0
               for r in line["per_rank"])
    assert line["train_img_per_s"] > 0
