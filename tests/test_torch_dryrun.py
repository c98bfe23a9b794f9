"""``sos_wsod_torch.entry.dryrun_multichip(4, device="cpu")``: 4 gloo ranks
on the CPU run the data-parallel stage-1 step and the dp1 x tp4 step from
the same state and batch (its loss within the JAX dryrun's bound,
5e-2 x max(1, |loss|), of the data-parallel one: with dropout off it is the
same math, summed in another order), print the JAX dryrun's OK lines, and
write each rank's losses and kernel launches; n = 1 runs in this process,
with no group and no tensor-parallel step, and prints the first line
only."""
from __future__ import annotations

import re

import numpy as np
import torch

from sos_wsod_torch.entry import DRYRUN_LOSS_RTOL, dryrun_multichip
from sos_wsod_torch.tools import check_ddp


def test_dryrun_multichip_four_ranks_on_the_cpu(tmp_path, capfd):
    dryrun_multichip(4, device="cpu", out_dir=str(tmp_path))
    out = capfd.readouterr().out
    assert re.search(r"^dryrun_multichip\(4\) OK: total_loss=[0-9.]+", out, re.M), out
    assert re.search(r"^dryrun_multichip dp1xtp4 OK: total_loss=[0-9.]+", out, re.M), out
    reports = check_ddp.load_reports(str(tmp_path), 4)
    totals = {r["dp"]["total_loss"] for r in reports}
    assert len(totals) == 1 and all(r["tp"] == 4 for r in reports)
    total, total_tp = reports[0]["dp"]["total_loss"], reports[0]["dp_tp"]["total_loss"]
    assert np.isfinite(total) and abs(total_tp - total) < DRYRUN_LOSS_RTOL * max(1.0, abs(total))
    # the same math: the split changes only the order of fc2's sum
    np.testing.assert_allclose(total_tp, total, rtol=1e-5)
    assert all(r["launches"] == reports[0]["launches"] for r in reports)


def test_dryrun_multichip_one_rank_runs_in_this_process(capfd):
    n = torch.get_num_threads()
    dryrun_multichip(1, device="cpu")
    torch.set_num_threads(n)
    out = capfd.readouterr().out
    assert "dryrun_multichip(1) OK" in out and "xtp" not in out
