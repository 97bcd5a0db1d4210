"""Linear SVM solver on the device (counterpart of diffmining_tpu/ops/svm.py).

The primal soft-margin problem of the Doersch baseline's detectors

    min_w,b  0.5·||w||² + C·Σ max(0, 1 − y(w·x + b))

by full-batch subgradient descent with Adam under a cosine-decayed learning
rate, as the JAX package solves it: one [N, D] x [D] (or, batched, [M, D] x
[D, J]) product a step, float32, on ``device`` (the card unless the caller
asks for the CPU). Adam is written out to optax's defaults (b1 0.9, b2
0.999, eps 1e-8, eps_root 0, the bias corrections in float32), and step k,
counted from 0, takes the learning rate of optax's
``cosine_decay_schedule(lr, steps)``: lr·0.5·(1 + cos(π·min(k, steps)/steps)).
The hinge is ``torch.maximum(m, 0)``, whose gradient at a tie is 0.5 as
``jax.grad`` of ``jnp.maximum`` gives (``relu`` and ``clamp`` give 0).

``duality_gap``, ``primal_objective`` and ``fit_svm_smo`` are float64 numpy
on the host, the port's own copy of the JAX package's: the weak-duality
certificate and the exact small-problem SMO oracle.
"""
from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from diffmining_tpu_torch.utils.device import resolve_device

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _adam_cosine(params: Sequence[torch.Tensor], loss_fn: Callable[[], torch.Tensor], steps: int, lr: float) -> None:
    """``steps`` Adam steps on ``params`` in place, to optax's
    ``adam(cosine_decay_schedule(lr, steps))``."""
    dev = params[0].device
    k = torch.arange(steps, dtype=torch.float32, device=dev)
    step_size = -(lr * (0.5 * (1 + torch.cos(math.pi * torch.minimum(k, torch.tensor(float(steps), device=dev))
                                             / float(steps)))))
    count = k + 1
    bc1 = 1 - torch.tensor(ADAM_B1, dtype=torch.float32, device=dev) ** count
    bc2 = 1 - torch.tensor(ADAM_B2, dtype=torch.float32, device=dev) ** count
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    for i in range(steps):
        for p in params:
            p.grad = None
        loss_fn().backward()
        with torch.no_grad():
            for p, m, v in zip(params, mu, nu):
                g = p.grad
                m.copy_((1 - ADAM_B1) * g + ADAM_B1 * m)
                v.copy_((1 - ADAM_B2) * (g * g) + ADAM_B2 * v)
                update = (m / bc1[i]) / (torch.sqrt(v / bc2[i]) + ADAM_EPS)
                p.add_(step_size[i] * update)
    for p in params:
        p.grad = None


def _hinge(margins: torch.Tensor) -> torch.Tensor:
    return torch.maximum(margins, torch.zeros((), dtype=margins.dtype, device=margins.device))


def _fit(X: torch.Tensor, y: torch.Tensor, sample_mask: torch.Tensor, C: float, steps: int, lr: float):
    w = torch.zeros(X.shape[1], dtype=torch.float32, device=X.device, requires_grad=True)
    b = torch.zeros((), dtype=torch.float32, device=X.device, requires_grad=True)

    def loss_fn():
        margins = 1.0 - y * (X @ w + b)
        return 0.5 * torch.sum(w * w) + C * torch.sum(_hinge(margins) * sample_mask)

    _adam_cosine([w, b], loss_fn, steps, lr)
    return w.detach(), b.detach()


def fit_linear_svm(
    X: np.ndarray, y: np.ndarray, C: float = 0.1, steps: int = 400, lr: float = 0.05,
    sample_mask: np.ndarray | None = None, device="cuda",
) -> Tuple[np.ndarray, float]:
    """X [N,D], y [N] in {-1,+1} -> (w [D], b). sample_mask excludes padding."""
    dev = resolve_device(device)
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    mask = np.ones(len(y), np.float32) if sample_mask is None else sample_mask
    w, b = _fit(as_t(X), as_t(y), as_t(mask), float(C), int(steps), float(lr))
    return w.cpu().numpy(), float(b)


def decision_function(X: np.ndarray, w: np.ndarray, b: float = 0.0) -> np.ndarray:
    return np.asarray(X, np.float32) @ np.asarray(w, np.float32) + b


def _fit_batch(P, Pm, HN, HNm, NEG, NEGm, C: float, steps: int, lr: float):
    J, _, D = P.shape
    W = torch.zeros((J, D), dtype=torch.float32, device=P.device, requires_grad=True)
    b = torch.zeros((J,), dtype=torch.float32, device=P.device, requires_grad=True)

    def loss_fn():
        mp = 1.0 - (torch.einsum("jpd,jd->jp", P, W) + b[:, None])  # positives (+1)
        mh = 1.0 + (torch.einsum("jhd,jd->jh", HN, W) + b[:, None])  # per-detector hard negatives (-1)
        mn = 1.0 + (NEG @ W.T + b[None, :])  # the shared negative pool (-1), [M, J]
        hinge = (torch.sum(_hinge(mp) * Pm) + torch.sum(_hinge(mh) * HNm) + torch.sum(_hinge(mn) * NEGm.T))
        return 0.5 * torch.sum(W * W) + C * hinge

    # the per-detector objectives are summed: Adam is elementwise and the
    # parameter blocks are disjoint, so each detector's solve is its own
    _adam_cosine([W, b], loss_fn, steps, lr)
    with torch.no_grad():
        return W.detach(), b.detach(), NEG @ W.T + b[None, :]


def fit_linear_svm_batch(
    P: np.ndarray, P_mask: np.ndarray,
    HN: np.ndarray, HN_mask: np.ndarray,
    NEG: np.ndarray, NEG_mask: np.ndarray,
    C: float = 0.1, steps: int = 400, lr: float = 0.05, device="cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """J independent soft-margin SVMs sharing one negative pool, solved
    together: P [J,p,D] padded positives (+1) with mask [J,p], HN [J,h,D]
    padded per-detector hard negatives (-1) with mask [J,h], NEG [M,D] the
    shared fold negative pool (-1) with per-detector row mask [J,M]. Returns
    (W [J,D], b [J], neg_scores [M,J]), the final decision scores over the
    pool for the caller's hard-negative mining. Equivalent to J calls of
    fit_linear_svm on the stacked rows."""
    dev = resolve_device(device)
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    W, b, scores = _fit_batch(as_t(P), as_t(P_mask), as_t(HN), as_t(HN_mask), as_t(NEG), as_t(NEG_mask),
                              float(C), int(steps), float(lr))
    return W.cpu().numpy(), b.cpu().numpy(), scores.cpu().numpy()


def duality_gap(
    X: np.ndarray, y: np.ndarray, w: np.ndarray, b: float, C: float
) -> Tuple[float, float, float, float]:
    """Optimality certificate for (w, b) with no exact-solver oracle: a
    dual-feasible α built from the primal margins (C on margin-violating
    points, 0 elsewhere, then shaved on the heavier side, least-violating
    first, until Σ α·y = 0) lower-bounds the optimum by weak duality, so
    gap = P(w, b) − D(α) ≥ P(w, b) − P*. Returns (gap, relative_gap,
    primal, dual)."""
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    w = np.asarray(w, np.float64)
    slack = 1.0 - y * (X @ w + b)
    alpha = np.where(slack > 0, C, 0.0)
    resid = float(alpha @ y)  # Σ α·y, to be shaved to 0
    side = np.sign(resid)
    if side:
        idx = np.where((alpha > 0) & (y == side))[0]
        idx = idx[np.argsort(slack[idx])]
        need = abs(resid)
        for i in idx:
            take = min(alpha[i], need)
            alpha[i] -= take
            need -= take
            if need <= 0:
                break
    w_alpha = (alpha * y) @ X
    dual = float(alpha.sum() - 0.5 * (w_alpha @ w_alpha))
    primal = primal_objective(X, y, w, b, C)
    gap = primal - dual
    return gap, gap / max(primal, 1e-12), primal, dual


def primal_objective(X: np.ndarray, y: np.ndarray, w: np.ndarray, b: float, C: float) -> float:
    """0.5·||w||² + C·Σ hinge — the quantity both solvers minimise."""
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    w = np.asarray(w, np.float64)
    hinge = np.maximum(0.0, 1.0 - y * (X @ w + b)).sum()
    return float(0.5 * (w @ w) + C * hinge)


def fit_svm_smo(
    X: np.ndarray, y: np.ndarray, C: float = 0.1, tol: float = 1e-5,
    max_passes: int = 50, seed: int = 0,
) -> Tuple[np.ndarray, float, np.ndarray]:
    """Exact small-problem reference solver: Platt's SMO on the soft-margin
    dual (the QP libsvm's SVC solves). O(n²) kernel matrix, for a few
    hundred points; returns (w, b, alpha)."""
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    n = len(y)
    K = X @ X.T
    alpha = np.zeros(n)
    b = 0.0
    if n < 2:
        # SMO updates pairs; with one point the dual optimum is the single
        # box-constrained coordinate
        if n == 1 and K[0, 0] > 0:
            alpha[0] = min(C, 1.0 / K[0, 0])
        w = (alpha * y) @ X
        return w, float(y[0]) * max(0.0, 1.0 - alpha[0] * K[0, 0]) if n else 0.0, alpha
    rng = np.random.RandomState(seed)
    passes = 0
    while passes < max_passes:
        changed = 0
        for i in range(n):
            Ei = float((alpha * y) @ K[:, i] + b - y[i])
            if not ((y[i] * Ei < -tol and alpha[i] < C) or (y[i] * Ei > tol and alpha[i] > 0)):
                continue
            j = rng.randint(n - 1)
            j = j + (j >= i)
            Ej = float((alpha * y) @ K[:, j] + b - y[j])
            ai, aj = alpha[i], alpha[j]
            if y[i] != y[j]:
                L, H = max(0.0, aj - ai), min(C, C + aj - ai)
            else:
                L, H = max(0.0, ai + aj - C), min(C, ai + aj)
            if L == H:
                continue
            eta = 2.0 * K[i, j] - K[i, i] - K[j, j]
            if eta >= 0:
                continue
            alpha[j] = float(np.clip(aj - y[j] * (Ei - Ej) / eta, L, H))
            if abs(alpha[j] - aj) < 1e-9:
                continue
            alpha[i] = ai + y[i] * y[j] * (aj - alpha[j])
            b1 = b - Ei - y[i] * (alpha[i] - ai) * K[i, i] - y[j] * (alpha[j] - aj) * K[i, j]
            b2 = b - Ej - y[i] * (alpha[i] - ai) * K[i, j] - y[j] * (alpha[j] - aj) * K[j, j]
            if 0 < alpha[i] < C:
                b = b1
            elif 0 < alpha[j] < C:
                b = b2
            else:
                b = (b1 + b2) / 2.0
            changed += 1
        passes = passes + 1 if changed == 0 else 0
    w = (alpha * y) @ X
    return w, float(b), alpha


def train_svm(X, split, max_samples, C: float = 0.1, device="cuda") -> Tuple[np.ndarray, List]:
    """The reference train_svm semantics: X = positives + hard negatives +
    negatives in order; returns (w, the new hard negatives: misclassified
    negatives sorted by score, capped)."""
    len_p, len_hn, len_n = split
    X = np.stack(X, axis=0).astype(np.float32)
    y = np.asarray([1.0] * len_p + [-1.0] * (len_hn + len_n), np.float32)
    w, b = fit_linear_svm(X, y, C=C, device=device)
    scores = decision_function(X[len_p + len_hn:], w, b)
    idx = np.where(scores > 0)[0]
    sorted_idx = np.argsort(-scores[idx])
    hard = X[idx[sorted_idx][:max_samples] + len_p + len_hn]
    return w, hard.tolist()
