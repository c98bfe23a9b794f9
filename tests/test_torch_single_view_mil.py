"""The PCL and CMIL heads of the port's single-view model against the JAX
package's, on the CPU in float32: every loss term and parameter gradient
against the JAX model's eager ``model.apply`` under ``jax.value_and_grad``,
one SGD step and ``predict``, and the weights carried from a JAX tree and
from d2-WSL blobs. The checks, inputs and tolerances are those of
tests/test_torch_single_view.py (rtol 1e-4 / atol 1e-5 for losses and
gradients); the two files split the heads so that the test workers run them
side by side. PCL's host clustering runs the port's k-means on the port's
side and scikit-learn's on the JAX side; CMIL's lambda reads the step,
given to both as 20 with WSL.SIZE_EPOCH 50.
"""
from __future__ import annotations

import pytest

from test_torch_single_view import check_head, check_weights, no_jax_dropout, one_thread  # noqa: F401


@pytest.mark.parametrize("head", ["PCL", "CMIL"])
def test_losses_gradients_step_and_predict_match_jax(head):
    check_head(head)


@pytest.mark.parametrize("head", ["PCL", "CMIL"])
def test_weights_from_a_jax_tree_and_from_d2_wsl_blobs(head):
    check_weights(head)
