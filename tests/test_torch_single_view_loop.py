"""The ContextLocNet head of the port's single-view model (ROILoopPool's
[box; frame; context] rows, kernel E's plain version on the CPU) against
the JAX package's, on the CPU in float32: every loss term and parameter
gradient against the JAX model's eager ``model.apply`` under
``jax.value_and_grad``, one SGD step and ``predict``, and the weights carried
from a JAX tree and from d2-WSL blobs. The checks, inputs and tolerances are
those of tests/test_torch_single_view.py (rtol 1e-4 / atol 1e-5 for losses
and gradients). JAX's ROILoopPool splits tied gradients and routes some
through maximum(o, 0); the ties here are ReLU's zeros, which its backward
zeroes on both sides.
"""
from __future__ import annotations

from test_torch_single_view import check_head, check_weights, no_jax_dropout, one_thread  # noqa: F401


def test_losses_gradients_step_and_predict_match_jax():
    check_head("ContextLocNet")


def test_weights_from_a_jax_tree_and_from_d2_wsl_blobs():
    check_weights("ContextLocNet")
