"""The port's ImageNet pretraining tool (sos_wsod_torch/tools/
train_imagenet.py) against the JAX tool (tools/train_imagenet.py) on the CPU
in float32: one step of each on the same ``synthetic_batches`` batch from the
same start weights (the JAX init, carried by ``state_dict_from_flax``), SGD
with lr 0.01, momentum 0.9 and weight decay 5e-4 (the JAX tool's
optax.chain(add_decayed_weights, sgd)): the loss, the accuracy, and every
conv and linear weight after the step; for vgg16 at 32 x 32 and ws_resnet50
at 32 x 32. WS-ResNet's FrozenBN statistics are buffers in the port and stay
as they were, where the JAX optimizer decays them as parameters: by lr x
weight decay, 5e-6 of their value, in this step (stated, not hidden).

Tolerances (two f32 implementations that sum their convolutions in
different orders): the loss within rtol 1e-5; the accuracy exact; each
leaf's update (weight after the step less weight before) within rtol 1e-3
and 1e-4 of the update's largest entry, since its gradient passes back
through up to 50 convolutions (the largest difference seen is 2.4e-5 of it).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sos_wsod_torch.engine.weights import state_dict_from_flax
from sos_wsod_torch.tools import train_imagenet as port
from tools import train_imagenet as jax_tool

LR, MOMENTUM, WD = 0.01, 0.9, 5e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    return {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ["vgg16", "ws_resnet50"])
def test_one_step_matches_the_jax_tool(arch):
    num_classes, batch_size, size = 10, 4, 32
    batch = next(jax_tool.synthetic_batches(batch_size, size, num_classes))
    ported = next(port.synthetic_batches(batch_size, size, num_classes))
    for k in batch:
        np.testing.assert_array_equal(ported[k], batch[k])

    jm = jax_tool.build_model(arch, num_classes, jnp.float32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(batch["image"]))["params"])
    tx = optax.chain(optax.add_decayed_weights(WD), optax.sgd(LR, momentum=MOMENTUM))
    state = {"params": params, "opt_state": tx.init(params)}
    state, metrics = jax_tool.make_train_step(jm, tx)(
        state, jax.tree_util.tree_map(jnp.asarray, batch))

    model = port.build_model(arch, num_classes, device="cpu")
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    optimizer = torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM, weight_decay=WD)
    got = port.make_train_step(model, optimizer)(
        {k: torch.from_numpy(v) for k, v in ported.items()})
    np.testing.assert_allclose(got["loss"].item(), float(metrics["loss"]), rtol=1e-5)
    assert got["acc"].item() == float(metrics["acc"])

    after = _flat(jax.device_get(state["params"]))
    before = _flat(params)
    sd = model.state_dict()
    n_stats = 0
    for path, want in after.items():
        name = path.replace(".kernel", ".weight")
        a = sd[name].numpy()
        a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T if a.ndim == 2 else a
        if "_norm." in name:        # FrozenBN: a buffer, not decayed here
            n_stats += 1
            np.testing.assert_array_equal(a, before[path], err_msg=name)
            np.testing.assert_allclose(want, before[path] * (1 - LR * WD), rtol=1e-6,
                                       err_msg=name)
            continue
        d, dw = a - before[path], want - before[path]
        np.testing.assert_allclose(d, dw, rtol=1e-3, atol=1e-4 * float(np.abs(dw).max()),
                                   err_msg=name)
        assert np.abs(d).max() > 0, name
    assert n_stats == (0 if arch == "vgg16" else 4 * 55)     # 3 stem, 48 block, 4 shortcut norms


def test_main_runs_on_the_cpu():
    out = port.main(["--synthetic", "--arch", "vgg16", "--device", "cpu", "--dtype", "float32",
                     "--num-classes", "5", "--batch-size", "2", "--image-size", "32",
                     "--max-iter", "2", "--log-period", "1"])
    assert np.isfinite(out["metrics"]["loss"]) and 0 <= out["metrics"]["acc"] <= 1
    with pytest.raises(SystemExit):
        port.main(["--device", "cpu"])
