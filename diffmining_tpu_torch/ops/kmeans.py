"""k-means with the distances as one matmul (counterpart of
diffmining_tpu/ops/kmeans.py): k-means++ seeding, Lloyd iterations, the
sklearn-like ``KMeans`` facade (n_init restarts, labels_,
cluster_centers_, inertia_) and the reference's re-seeding variants.

The arithmetic is the JAX package's in fp32: distances as x² − 2x·c + c²
(not ``torch.cdist``, so argmin ties fall the same way), the first index
winning a tie, empty clusters keeping their center. The random streams are
``torch.Generator``s, one per restart seeded from (random_state, restart)
as JAX folds the restart into its key, so the seeding draws differ from
JAX's while the Lloyd iterations from a given init are the same. Matmuls
run in full fp32 on the card (no TF32) inside ``fit``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Tuple

import numpy as np
import torch

from diffmining_tpu_torch.typicality.engine import derive_seed
from diffmining_tpu_torch.utils.device import resolve_device


@contextlib.contextmanager
def ieee_fp32_matmuls():
    """Float32 matmuls in full precision (no TF32) inside the block."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def pairwise_sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[N, D] x [K, D] -> [N, K] squared euclidean distances via one matmul."""
    x2 = (x * x).sum(dim=1, keepdim=True)
    c2 = (c * c).sum(dim=1)
    return torch.clamp_min(x2 - 2.0 * (x @ c.T) + c2[None, :], 0.0)


def kmeanspp_init(generator: torch.Generator, x: torch.Tensor, k: int) -> torch.Tensor:
    """k-means++ seeding (reference utils.py:303-359): the first center
    uniform, each next one drawn with probability proportional to the
    squared distance to the nearest center so far."""
    n = x.shape[0]
    first = x[int(torch.randint(0, n, (), generator=generator, device=generator.device))]
    centers = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    centers[0] = first
    min_d = ((x - first[None]) ** 2).sum(dim=1)
    for i in range(1, k):
        total = min_d.sum()
        # every point on a center already: draw uniformly
        probs = min_d / torch.clamp_min(total, 1e-12) if float(total) > 0 else torch.ones_like(min_d)
        idx = int(torch.multinomial(probs.to(generator.device), 1, generator=generator))
        centers[i] = x[idx]
        min_d = torch.minimum(min_d, ((x - x[idx][None]) ** 2).sum(dim=1))
    return centers


def _assign(x: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    d = pairwise_sq_dists(x, c)
    return torch.argmin(d, dim=1), d.min(dim=1).values.sum()


def lloyd(x: torch.Tensor, centers: torch.Tensor, k: int, max_iter: int = 300,
          tol: float = 1e-4) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Lloyd iterations until the squared center shift is <= tol (or
    max_iter): (centers, labels, inertia). Empty clusters keep their
    previous center."""
    c = centers
    shift, it = float("inf"), 0
    while shift > tol and it < max_iter:
        labels, _ = _assign(x, c)
        one_hot = torch.nn.functional.one_hot(labels, k).to(x.dtype)
        counts = one_hot.sum(dim=0)
        sums = one_hot.T @ x
        new_c = torch.where(counts[:, None] > 0, sums / torch.clamp_min(counts[:, None], 1), c)
        shift = float(((new_c - c) ** 2).sum())
        c, it = new_c, it + 1
    labels, inertia = _assign(x, c)
    return c, labels, inertia


@dataclasses.dataclass
class KMeans:
    """sklearn-like facade: fit(X) sets labels_, cluster_centers_ and
    inertia_ (numpy) from the best of n_init k-means++ restarts, on
    ``device``."""

    n_clusters: int
    random_state: int = 0
    n_init: int = 10
    max_iter: int = 300
    tol: float = 1e-4
    device: str = "cuda"

    def _x(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=resolve_device(self.device))

    def fit(self, x) -> "KMeans":
        x = self._x(x)
        best = None
        with ieee_fp32_matmuls():
            for i in range(self.n_init):
                g = torch.Generator(device=x.device)
                g.manual_seed(derive_seed(self.random_state, i))
                init = kmeanspp_init(g, x, self.n_clusters)
                c, labels, inertia = lloyd(x, init, self.n_clusters, self.max_iter, self.tol)
                inertia = float(inertia)
                if best is None or inertia < best[0]:
                    best = (inertia, c, labels)
        self.inertia_ = best[0]
        self.cluster_centers_ = best[1].cpu().numpy()
        self.labels_ = best[2].cpu().numpy()
        return self

    def fit_predict(self, x) -> np.ndarray:
        return self.fit(x).labels_


@dataclasses.dataclass
class KMeansSplitReassign(KMeans):
    """The reference's numpy ``KMeans(KMeansBase)`` with split_reassign
    (utils.py:617-684; part of the public surface, unused by the shipped
    pipeline), with its quirk: after Lloyd converges, clusters under
    k_min·N members are re-seeded ONCE at the biggest cluster's center plus
    N(0, 0.01·sigma) noise and the points re-assigned without another Lloyd
    pass. One random init from numpy's RandomState(random_state)."""

    k_min: float = 0.01
    n_init: int = 1

    def fit(self, x) -> "KMeansSplitReassign":
        x_np = np.asarray(x, dtype=np.float32)
        xt = self._x(x_np)
        n, k = x_np.shape[0], self.n_clusters
        rng = np.random.RandomState(self.random_state)
        init = xt[torch.as_tensor(rng.choice(n, k, replace=False), device=xt.device)]
        with ieee_fp32_matmuls():
            c, labels, inertia = lloyd(xt, init, k, self.max_iter, self.tol)
            centers, labels = c.cpu().numpy().copy(), labels.cpu().numpy()
            counts = np.bincount(labels, minlength=k)
            small = np.where(counts < self.k_min * n)[0]
            if len(small) > 0:
                big = int(np.argmax(counts))
                sigma = x_np[labels == big].std(axis=0)
                for i in small:
                    centers[i] = centers[big] + rng.normal(0.0, 0.01 * sigma, centers[big].shape)
                d = pairwise_sq_dists(xt, torch.as_tensor(centers, dtype=torch.float32, device=xt.device))
                labels = d.argmin(dim=1).cpu().numpy()
                inertia = d.min(dim=1).values.sum()
        self.cluster_centers_, self.labels_, self.inertia_ = centers, labels, float(inertia)
        return self


@dataclasses.dataclass
class KMeansRe(KMeans):
    """The reference's re-seeding ``KMeansRe`` (utils.py:458-540): after the
    fit, clusters under k_min_frac·N/K members are re-seeded at random
    points of the biggest cluster and Lloyd re-runs, up to reseed_rounds
    times."""

    k_min_frac: float = 0.25
    reseed_rounds: int = 3

    def fit(self, x) -> "KMeansRe":
        super().fit(x)
        xt = self._x(x)
        n, k = xt.shape[0], self.n_clusters
        min_size = max(1, int(self.k_min_frac * n / k))
        for r in range(self.reseed_rounds):
            counts = np.bincount(self.labels_, minlength=k)
            small = np.where(counts < min_size)[0]
            if len(small) == 0:
                break
            big = int(np.argmax(counts))
            big_points = np.where(self.labels_ == big)[0]
            centers = self.cluster_centers_.copy()
            for j, cl in enumerate(small):
                g = torch.Generator()
                g.manual_seed(derive_seed(self.random_state + 1, r * k + j))
                pick = int(torch.randint(0, len(big_points), (), generator=g))
                centers[cl] = xt[int(big_points[pick])].cpu().numpy()
            with ieee_fp32_matmuls():
                c, labels, inertia = lloyd(xt, torch.as_tensor(centers, device=xt.device), k, self.max_iter, self.tol)
            self.cluster_centers_, self.labels_, self.inertia_ = c.cpu().numpy(), labels.cpu().numpy(), float(inertia)
        return self
