"""Tensor parallelism of the DAN fc stack (sos_wsod_torch/parallel/tensor.py)
on the CPU over gloo.

  - the rules: which names split along which dimension (torch's (out, in)
    layout: fc1 by rows, fc2 by columns, fc2's bias whole), the replicated
    fallback when a width does not divide, the groups' layout (the model
    axis varies fastest) and the refusal of a world that tp does not
    divide;
  - the shard -> gather round trip of a state dict, and the DAN on each
    rank's shards against the one-process DAN, forward and backward;
  - (tests/test_torch_tensor_parallel_step.py: the training step.)
Each rank runs torch in one thread; tolerances f32, rtol 1e-6 / atol 1e-7
(fc2's partial products are summed in another order than one GEMM's).
"""
from __future__ import annotations

import pytest
import torch
import torch.distributed as dist

from sos_wsod_torch.engine import launch as launch_mod
from sos_wsod_torch.models.heads.dan import DAN
from sos_wsod_torch.parallel import comm, tensor
from sos_wsod_torch.tools import check_ddp


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_rules_split_fc1_rows_and_fc2_columns_and_fall_back_to_replicated():
    shapes = {"roi_heads.dan.fc1.weight": (4096, 25088), "roi_heads.dan.fc1.bias": (4096,),
              "roi_heads.dan.fc2.weight": (4096, 4096), "roi_heads.dan.fc2.bias": (4096,),
              "roi_heads.wsddn.cls.weight": (20, 4096), "backbone.plain5.conv3.weight":
              (512, 512, 3, 3)}
    assert tensor.split_dims(shapes, 2) == {"roi_heads.dan.fc1.weight": 0,
                                            "roi_heads.dan.fc1.bias": 0,
                                            "roi_heads.dan.fc2.weight": 1}
    assert tensor.split_dims(shapes, 1) == {}
    assert tensor.spec_for("roi_heads.dan.fc2.bias", (4096,), 2) is None
    assert tensor.spec_for("head.dan.fc1.weight", (4096, 10), 4) == 0
    assert tensor.spec_for("head.notdan.fc1.weight", (4096, 10), 4) is None
    # a width that does not divide: the whole DAN stays replicated
    odd = {k.replace("4096", "x"): v for k, v in shapes.items()}
    odd["roi_heads.dan.fc1.weight"], odd["roi_heads.dan.fc1.bias"] = (4098, 25088), (4098,)
    odd["roi_heads.dan.fc2.weight"] = (4096, 4098)
    assert tensor.spec_for("roi_heads.dan.fc1.weight", (4098, 25088), 4) is None
    assert tensor.split_dims(odd, 4) == {}
    # a DAN without fc2 stays replicated
    assert tensor.split_dims({"dan.fc1.weight": (8, 4), "dan.fc1.bias": (8,)}, 2) == {}


def test_shard_and_one_process_layout_round_trip():
    g = torch.Generator().manual_seed(0)
    sd = {"a.dan.fc1.weight": torch.randn(8, 6, generator=g),
          "a.dan.fc1.bias": torch.randn(8, generator=g),
          "a.dan.fc2.weight": torch.randn(5, 8, generator=g),
          "a.dan.fc2.bias": torch.randn(5, generator=g), "a.other": torch.randn(3, generator=g)}
    dims = tensor.split_dims({k: v.shape for k, v in sd.items()}, 4)
    parts = [tensor.shard_state_dict(sd, dims, r, 4) for r in range(4)]
    assert parts[1]["a.dan.fc1.weight"].shape == (2, 6)
    assert parts[3]["a.dan.fc2.weight"].shape == (5, 2)
    assert parts[2]["a.dan.fc2.bias"] is sd["a.dan.fc2.bias"]
    for k, v in sd.items():
        back = torch.cat([p[k] for p in parts], dims[k]) if k in dims else parts[0][k]
        assert torch.equal(back, v), k


def test_world_not_divisible_by_tp_raises(monkeypatch):
    monkeypatch.setattr(comm, "get_world_size", lambda: 6)
    with pytest.raises(ValueError, match="6 processes not divisible by MODEL_AXIS_SIZE=4"):
        tensor.init(4)
    monkeypatch.setattr(comm, "get_world_size", lambda: 1)
    tensor.init(4)   # one process: no split, as the JAX CLI on one chip
    assert tensor.size() == 1 and tensor.data_world_size() == 1


def _groups_and_dan(out_dir: str, tp: int) -> None:
    """Each rank: its groups' members, and its DAN shard's forward and input
    gradient on a shared input."""
    torch.set_num_threads(1)
    tensor.init(tp)
    world, rank = comm.get_world_size(), comm.get_rank()
    members = {"tp": dist.get_process_group_ranks(tensor.group()),
               "dp": dist.get_process_group_ranks(tensor.data_group()),
               "dp_rank": tensor.data_rank(), "dp_size": tensor.data_world_size()}
    torch.manual_seed(0)
    dan = DAN(2 * 2 * 3, (8, 6), dropout_rate=0.5).train()
    full = {k: v.clone() for k, v in dan.state_dict().items()}
    x = torch.randn(5, 2, 2, 3, requires_grad=True)

    class Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.dan = dan

    dims = tensor.shard_model(Holder())
    y = dan(x, torch.Generator().manual_seed(7))
    y.square().sum().backward()
    torch.save({"members": members, "world": world, "dims": dims, "full": full,
                "y": y.detach(), "gx": x.grad, "x": x.detach(),
                "grads": {n: p.grad for n, p in dan.named_parameters()}},
               f"{out_dir}/rank{rank}.pt")
    tensor.init(1)


def test_groups_and_the_dan_on_shards_match_one_process(tmp_path):
    """4 ranks as dp2 x tp2: the tensor-parallel groups are {0, 1} and
    {2, 3}, the data-parallel ones {0, 2} and {1, 3}; each rank's DAN
    (fc1 -> ReLU -> dropout -> fc2 -> ReLU -> dropout, the masks from one
    seeded generator) gives the one-process output and input gradient, and
    its shards' gradients are the one-process gradients' slices."""
    launch_mod.launch(_groups_and_dan, 4, args=(str(tmp_path), 2), backend="gloo",
                      device="cpu")
    reports = check_ddp.load_reports(str(tmp_path), 4)
    assert [r["members"]["tp"] for r in reports] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    assert [r["members"]["dp"] for r in reports] == [[0, 2], [1, 3], [0, 2], [1, 3]]
    assert [r["members"]["dp_rank"] for r in reports] == [0, 0, 1, 1]
    r0 = reports[0]
    torch.manual_seed(0)
    dan = DAN(12, (8, 6), dropout_rate=0.5).train()
    dan.load_state_dict(r0["full"])
    x = r0["x"].clone().requires_grad_(True)
    y = dan(x, torch.Generator().manual_seed(7))
    y.square().sum().backward()
    for r, rep in enumerate(reports):
        torch.testing.assert_close(rep["y"], y.detach(), rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(rep["gx"], x.grad, rtol=1e-6, atol=1e-7)
        for name, p in dan.named_parameters():
            want = p.grad
            key = f"dan.{name}"
            if key in rep["dims"]:
                want = tensor.shard(want, rep["dims"][key], r % 2, 2)
            torch.testing.assert_close(rep["grads"][name], want, rtol=1e-6, atol=1e-7,
                                       msg=f"rank {r} {name}")
