"""k-means of a 1-D float32 vector, step for step as scikit-learn's ``KMeans``.

PCL picks its top-ranking proposals with ``KMeans(n_clusters, random_state,
n_init=10).fit(probs.reshape(-1, 1))`` (the reference's third_party/pcl.py),
and the JAX package calls scikit-learn for it. The port depends on no
scikit-learn, and an exact 1-D optimum is not the same function (where none
of the 10 seeded starts reaches the global optimum the members differ), so
this module reruns scikit-learn's algorithm (its ``lloyd`` path at the
defaults: k-means++ seeding, ``max_iter`` 300, ``tol`` 1e-4) with the same
arithmetic:
  - the data are centered on their float32 mean; the tolerance is 1e-4 times
    the mean variance of the uncentered data;
  - k-means++: the first seed is ``RandomState.choice`` over the uniform
    weights, each later one the best of ``2 + int(log k)`` candidates drawn by
    ``uniform`` against the running potential; squared distances are
    computed in float64 and rounded to float32, as scikit-learn's
    float32-upcast Euclidean distances are;
  - Lloyd: labels by the first minimum of |c|^2 - 2 x c in float32; the new
    centers are float32 sums in sample order times float32(1 / weight), an
    emptied cluster takes the farthest sample (``argpartition``) and one still
    empty takes the heaviest cluster's center as the loop has left it; stop
    when the labels repeat, or when the squared center shifts sum to at most
    the tolerance (then one more labelling);
  - the run with the least inertia (float32, summed in sample order) wins,
    unless its labels are the best run's up to a permutation.
Scikit-learn sums each cluster and the inertia in OpenMP threads above 256
samples, in an order that varies with the thread count; this module sums in
one thread's order.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

MAX_ITER = 300
TOL = 1e-4


def _sq_dists(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(m, 1), (n, 1) float32 -> (m, n) float32 squared distances, from the
    float64 -2 a b + a^2 + b^2, clipped at 0."""
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    d = -2 * (a64 @ b64.T)
    d += np.einsum("ij,ij->i", a64, a64)[:, None]
    d += np.einsum("ij,ij->i", b64, b64)[None, :]
    return np.maximum(d.astype(np.float32), 0)


def kmeans_plusplus(x: np.ndarray, k: int, weight: np.ndarray,
                    rng: np.random.RandomState) -> np.ndarray:
    """k-means++ seeds of the centered (n, 1) float32 data: (k, 1)."""
    n = x.shape[0]
    centers = np.empty((k, 1), dtype=x.dtype)
    trials = 2 + int(np.log(k))
    centers[0] = x[rng.choice(n, p=weight / weight.sum())]
    closest = _sq_dists(centers[0, np.newaxis], x)
    pot = closest @ weight
    for c in range(1, k):
        picks = np.searchsorted(np.cumsum(weight * closest), rng.uniform(size=trials) * pot)
        np.clip(picks, None, closest.size - 1, out=picks)
        dist = _sq_dists(x[picks], x)
        np.minimum(closest, dist, out=dist)
        pots = dist @ weight.reshape(-1, 1)
        best = np.argmin(pots)
        pot, closest = pots[best], dist[best]
        centers[c] = x[picks[best]]
    return centers


def _labels(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
    norms = np.einsum("ij,ij->i", centers, centers)
    dist = norms[None, :] + -2.0 * (x[:, 0:1] * centers[None, :, 0])
    return np.argmin(dist, axis=1).astype(np.int32)


def _lloyd_step(x, weight, centers) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One labelling and update: (labels, new centers, center shifts)."""
    k = centers.shape[0]
    labels = _labels(x, centers)
    new = np.zeros_like(centers)
    mass = np.zeros(k, x.dtype)
    np.add.at(mass, labels, weight)
    np.add.at(new[:, 0], labels, x[:, 0] * weight)
    empty = np.where(np.equal(mass, 0))[0].astype(np.int32)
    if len(empty):
        far_d = ((x - centers[labels]) ** 2).sum(axis=1)
        far = np.argpartition(far_d, -len(empty))[:-len(empty) - 1:-1].astype(np.int32)
        if np.max(far_d) != 0:
            for new_id, i in zip(empty, far):
                old_id = labels[i]
                new[old_id] -= x[i] * weight[i]
                new[new_id] = x[i] * weight[i]
                mass[new_id] = weight[i]
                mass[old_id] -= weight[i]
    heaviest = np.argmax(mass)
    for j in range(k):   # in order: an empty j copies the heaviest as the loop left it
        if mass[j] > 0:
            new[j] *= np.float32(1.0 / float(mass[j]))
        else:
            new[j] = new[heaviest]
    shift = np.sqrt(((new - centers) ** 2)[:, 0])
    return labels, new, shift


def _lloyd(x, weight, centers, tol) -> Tuple[np.ndarray, np.float32, np.ndarray]:
    labels_old = np.full(x.shape[0], -1, np.int32)
    converged = False
    for _ in range(MAX_ITER):
        labels, centers, shift = _lloyd_step(x, weight, centers)
        if np.array_equal(labels, labels_old):
            converged = True
            break
        if (shift ** 2).sum() <= tol:
            break
        labels_old = labels
    if not converged:
        labels = _labels(x, centers)
    d = x[:, 0] - centers[labels, 0]
    inertia = np.cumsum(d * d * weight, dtype=np.float32)[-1]
    return labels, inertia, centers


def _same_clustering(a: np.ndarray, b: np.ndarray, k: int) -> bool:
    """Whether a and b are the same labels up to a permutation."""
    mapping = np.full(k, -1, np.int32)
    for i, j in zip(a, b):
        if mapping[i] == -1:
            mapping[i] = j
        elif mapping[i] != j:
            return False
    return True


def kmeans_1d(values: np.ndarray, k: int, seed: int, n_init: int = 10
              ) -> Tuple[np.ndarray, np.ndarray]:
    """``KMeans(k, random_state=seed, n_init=n_init).fit(values.reshape(-1,
    1))`` of a float32 vector: (labels_ (n,) int32, cluster_centers_ (k, 1)
    float32)."""
    x = np.array(values, dtype=np.float32).reshape(-1, 1)
    if x.shape[0] < k:
        raise ValueError(f"n_samples={x.shape[0]} should be >= n_clusters={k}")
    tol = np.mean(np.var(x, axis=0)) * TOL
    rng = np.random.RandomState(seed)
    weight = np.ones(x.shape[0], x.dtype)
    mean = x.mean(axis=0)
    x -= mean
    best = None
    for _ in range(n_init):
        labels, inertia, centers = _lloyd(x, weight, kmeans_plusplus(x, k, weight, rng), tol)
        if best is None or (inertia < best[1] and not _same_clustering(labels, best[0], k)):
            best = (labels, inertia, centers)
    return best[0], best[2] + mean
