"""The port's PCL and CMIL host ops against the JAX package and the reference
goldens, on the CPU: ``pcl_loss`` and its custom gradient
(sos_wsod_torch/ops/pcl_loss.py), the k-means of PCL's top-ranking proposals
(ops/kmeans.py) against scikit-learn's ``KMeans``, PCL's targets
(models/heads/pcl.py:pcl_targets_np) against the JAX package's, which calls
scikit-learn, and ROIMerge (ops/roi_merge.py).

Tolerances: the reference golden's own bounds for ``pcl_loss`` (rtol 1e-5 on
the summed loss, rtol 1e-4 / atol 1e-5 on the gradient) and ROIMerge's means
(rtol 1e-5, atol 1e-5); against JAX the same f32 formulas, computed in
another order: rtol 1e-6 (loss and gradient of pcl_loss, the clique means
and their gradient). Cluster assignments, k-means members and PCL targets
are integers or copies of inputs and must be equal.
"""
from __future__ import annotations

import pathlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.cluster import KMeans
from threadpoolctl import threadpool_limits

from sos_wsod_tpu.models.heads.pcl import pcl_targets_np as jax_pcl_targets_np
from sos_wsod_tpu.ops.pcl_loss import pcl_loss as jax_pcl_loss
from sos_wsod_tpu.ops.roi_merge import roi_merge as jax_roi_merge
from sos_wsod_tpu.ops.roi_merge import roi_merge_assign as jax_roi_merge_assign
from sos_wsod_torch.models.heads.pcl import pcl_targets_np
from sos_wsod_torch.ops.kmeans import kmeans_1d
from sos_wsod_torch.ops.pcl_loss import pcl_loss
from sos_wsod_torch.ops.roi_merge import roi_merge, roi_merge_assign, score_order

GOLD = pathlib.Path(__file__).resolve().parent / "goldens"
PCL_KEYS = ("probs", "labels", "cls_loss_weights", "gt_assignment", "pc_labels", "pc_probs",
            "pc_count", "img_cls_loss_weights", "im_labels")


def _pcl_args(z):
    ints = ("labels", "gt_assignment", "pc_labels")
    return [torch.from_numpy(np.asarray(z[k])).long() if k in ints
            else torch.from_numpy(np.asarray(z[k], np.float32)) for k in PCL_KEYS]


def test_pcl_loss_matches_reference_golden():
    z = np.load(GOLD / "pcl_loss.npz")
    args = _pcl_args(z)
    probs = args[0].clone().requires_grad_(True)
    out = pcl_loss(probs, *args[1:])
    np.testing.assert_allclose(float(out.detach().sum()), float(z["out"].sum()), rtol=1e-5,
                               atol=1e-6)
    out.sum().backward()
    np.testing.assert_allclose(probs.grad.numpy(), z["grad_in"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pcl_loss_and_gradient_match_jax(seed):
    """Random clusters, an image label off, and a non-unit cotangent: the
    per-channel loss and the gradient (the kernel's rule, times the
    cotangent) equal the JAX custom VJP's."""
    rng = np.random.RandomState(seed)
    r, c, g = 40, 6, 7
    probs = rng.dirichlet(np.ones(c), r).astype(np.float32)
    probs[0, 0] = 1e-8                                     # below both eps
    labels = rng.randint(0, c, r)
    labels[:10] = 0
    assign = rng.randint(0, g, r)
    w = rng.uniform(0, 1, r).astype(np.float32)
    pc_labels = rng.randint(0, c, g)
    pc_probs = rng.uniform(0, 1, g).astype(np.float32)
    pc_probs[1] = 0.0
    pc_count = rng.randint(0, 5, g).astype(np.float32)
    img_w = rng.uniform(0, 2, g).astype(np.float32)
    im_labels = (rng.rand(c) > 0.3).astype(np.float32)
    im_labels[0] = 1.0
    ct = rng.randn(c).astype(np.float32)
    args = (probs, labels, w, assign, pc_labels, pc_probs, pc_count, img_w, im_labels)

    out_j, vjp = jax.vjp(lambda p: jax_pcl_loss(p, *[jnp.asarray(a) for a in args[1:]]),
                         jnp.asarray(probs))
    (grad_j,) = vjp(jnp.asarray(ct))
    p = torch.from_numpy(probs).requires_grad_(True)
    t = [torch.from_numpy(np.asarray(a)) for a in args[1:]]
    out = pcl_loss(p, *t)
    out.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(grad_j), rtol=1e-6, atol=1e-7)


SIZES = (1, 2, 3, 4, 5, 7, 16, 100, 255, 256, 257, 600, 1000, 2000, 4096)


def _vectors(kind: str, count: int):
    """``count`` float32 vectors of one kind, of the sizes above (4096 the
    largest, the proposal capacity)."""
    rng = np.random.RandomState(sorted(KINDS).index(kind))
    out = []
    for i in range(count):
        n = SIZES[i % len(SIZES)]
        x = {"uniform": lambda: rng.rand(n),
             "skewed": lambda: rng.beta(0.3, 3, n),
             "ties": lambda: np.round(rng.rand(n) * 5) / 5,
             "constant": lambda: np.full(n, rng.rand()),
             "duplicates": lambda: rng.choice(rng.rand(3), n),
             "clipped": lambda: np.clip(rng.exponential(0.01, n), 1e-9, 1 - 1e-9)}[kind]()
        out.append(x.astype(np.float32))
    return out


KINDS = ("uniform", "skewed", "ties", "constant", "duplicates", "clipped")


def _members(labels, centers):
    return np.where(labels == np.argmax(centers))[0]


@pytest.mark.parametrize("kind", KINDS)
def test_kmeans_members_equal_sklearn(kind):
    """35 vectors of each kind (210 in all), sizes 1-4096: the members of
    the highest-center cluster equal scikit-learn's ``KMeans(min(3, n),
    random_state=3, n_init=10)``, as PCL uses it."""
    for x in _vectors(kind, 35):
        k = min(3, x.shape[0])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # fewer distinct points than clusters
            km = KMeans(n_clusters=k, random_state=3, n_init=10).fit(x.reshape(-1, 1))
        labels, centers = kmeans_1d(x, k, 3)
        np.testing.assert_array_equal(_members(labels, centers),
                                      _members(km.labels_, km.cluster_centers_),
                                      err_msg=f"{kind} n={x.shape[0]}")


@pytest.mark.parametrize("kind", ["uniform", "ties", "duplicates"])
def test_kmeans_equals_sklearn_bit_for_bit_in_one_thread(kind):
    """With scikit-learn's OpenMP loops in one thread (above 256 samples it
    sums clusters and inertia per thread, in an order that follows the
    thread count), labels and centers equal the port's bit for bit."""
    with threadpool_limits(1), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for x in _vectors(kind, 15):
            k = min(3, x.shape[0])
            km = KMeans(n_clusters=k, random_state=3, n_init=10).fit(x.reshape(-1, 1))
            labels, centers = kmeans_1d(x, k, 3)
            np.testing.assert_array_equal(labels, km.labels_)
            np.testing.assert_array_equal(centers, km.cluster_centers_)


def _pcl_case(seed, r=48, c=4, first=False, flat=False):
    """Boxes, previous scores, labels, probabilities and validity of R
    proposals; ``flat`` gives every proposal the same previous scores (a
    collapsed branch), so that k-means keeps all of them and the graph
    centers run over the whole set."""
    rng = np.random.RandomState(seed)
    nvalid = r - 6
    xy = rng.uniform(0, 60, (r, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 40, (r, 2))], 1).astype(np.float32)
    boxes[nvalid:] = 0
    boxes[5] = boxes[4] + 0.5                   # near-duplicates join one cluster
    prev = (rng.dirichlet(np.ones(c), r) if first
            else rng.dirichlet(np.ones(c + 1), r)).astype(np.float32)
    if flat:
        prev[:] = prev[0]
    new = rng.dirichlet(np.ones(c + 1), r).astype(np.float32)
    im_labels = np.zeros(c, np.float32)
    im_labels[rng.choice(c, 2, replace=False)] = 1
    valid = np.arange(r) < nvalid
    return boxes, prev, im_labels, new, valid


@pytest.mark.parametrize("seed,first,r,flat", [(0, True, 48, False), (1, False, 48, False),
                                               (2, False, 48, False), (3, True, 48, False),
                                               (4, False, 400, True), (5, True, 600, False)])
def test_pcl_targets_match_jax(seed, first, r, flat):
    """The whole host clustering (k-means, graph centers, cluster
    assignment, padding to 5 x num_classes) against the JAX package's, which
    runs scikit-learn: every array equal, a collapsed branch (all 394
    proposals in the top cluster) included."""
    args = _pcl_case(seed, r=r, first=first, flat=flat)
    got = pcl_targets_np(*args, max_pc=20)
    want = jax_pcl_targets_np(*args, max_pc=20)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_pcl_targets_without_labels_or_proposals_are_padding():
    boxes, prev, im_labels, new, valid = _pcl_case(5)
    for a in (pcl_targets_np(boxes, prev, np.zeros_like(im_labels), new, valid, 20),
              pcl_targets_np(boxes, prev, im_labels, new, np.zeros_like(valid), 20)):
        assert not any(t.any() for t in a[:7])


@pytest.mark.parametrize("it", [0, 950, 1999])
def test_roi_merge_matches_reference_golden(it):
    z = np.load(GOLD / f"roi_merge_i{it}.npz")
    mc, md, ids, counts = roi_merge(
        torch.from_numpy(z["S"][:, 0]), torch.from_numpy(z["J"]), torch.from_numpy(z["C"]),
        torch.from_numpy(z["D"]), it, int(z["P"][3]), int(z["P"][4]))
    n = z["MC"].shape[0]
    np.testing.assert_array_equal(ids.numpy(), z["IJ"])
    assert int((counts > 0).sum()) == n
    np.testing.assert_allclose(mc.numpy()[:n], z["MC"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(md.numpy()[:n], z["MD"], rtol=1e-5, atol=1e-5)
    assert not mc[n:].any() and not md[n:].any()


def _merge_case(seed, r=260, k=5):
    """Scores with padded slots at -1e9 (IoU -1), an IoU matrix with
    structure; r > 200, so the top-200 window is cut."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 100, (r, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 60, (r, 2))], 1)
    x1 = np.maximum(boxes[:, None, 0], boxes[None, :, 0])
    y1 = np.maximum(boxes[:, None, 1], boxes[None, :, 1])
    x2 = np.minimum(boxes[:, None, 2], boxes[None, :, 2])
    y2 = np.minimum(boxes[:, None, 3], boxes[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    iou = (inter / (area[:, None] + area[None] - inter)).astype(np.float32)
    valid = np.arange(r) < r - 20
    s = np.where(valid, rng.rand(r), -1e9).astype(np.float32)
    s[3] = s[7]                                    # a tie, broken by index
    iou = np.where(valid[:, None] & valid[None], iou, -1).astype(np.float32)
    c = rng.randn(r, k).astype(np.float32)
    d = rng.randn(r, k).astype(np.float32)
    return s, iou, c, d


@pytest.mark.parametrize("seed,it", [(0, 10), (1, 2500), (2, 40000)])
def test_roi_merge_and_its_gradient_match_jax(seed, it):
    """Assignment, sizes, clique means and their uniform-split gradient
    against the JAX op, the assignment read from the top-200 block only."""
    s, iou, c, d = _merge_case(seed)
    max_epoch, size_epoch = 40, 5000
    (mc_j, md_j, ids_j, counts_j), vjp = jax.vjp(
        lambda cc, dd: jax_roi_merge(jnp.asarray(s), jnp.asarray(iou), cc, dd, it, max_epoch,
                                     size_epoch), jnp.asarray(c), jnp.asarray(d))
    rng = np.random.RandomState(seed + 100)
    gc, gd = rng.randn(*c.shape).astype(np.float32), rng.randn(*d.shape).astype(np.float32)
    want_c, want_d = vjp((jnp.asarray(gc), jnp.asarray(gd), np.zeros(len(s), jax.dtypes.float0),
                          np.zeros(len(s), jax.dtypes.float0)))
    ct = torch.from_numpy(c).requires_grad_(True)
    dt = torch.from_numpy(d).requires_grad_(True)
    mc, md, ids, counts = roi_merge(torch.from_numpy(s), torch.from_numpy(iou), ct, dt, it,
                                    max_epoch, size_epoch)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_j))
    np.testing.assert_allclose(mc.detach().numpy(), np.asarray(mc_j), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(md.detach().numpy(), np.asarray(md_j), rtol=1e-6, atol=1e-7)
    torch.autograd.backward([mc, md], [torch.from_numpy(gc), torch.from_numpy(gd)])
    np.testing.assert_allclose(ct.grad.numpy(), np.asarray(want_c), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(dt.grad.numpy(), np.asarray(want_d), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("r", [260, 120])
def test_roi_merge_assign_reads_only_the_top_block(r):
    """The (R, R) matrix and its top-min(R, 200) block in score order give
    the assignment of the JAX package's roi_merge_assign, above and below
    200 ROIs."""
    s, iou, _, _ = _merge_case(3, r=r)
    order = score_order(s)
    top = order[:200]
    want = jax_roi_merge_assign(s, iou, 900, 40, 5000)
    for got in (roi_merge_assign(s, iou, 900, 40, 5000),
                roi_merge_assign(s, iou[np.ix_(top, top)], 900, 40, 5000, order)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
