"""The port's linear SVM (ops/svm.py) held to the JAX package's on the CPU.

The single fit against JAX's ``_fit`` (through ``fit_linear_svm``) at 60×33
and the batched fit against ``_fit_batch`` at J = 3: w, b and the pool
scores at rtol 1e-4, atol 1e-5, the primal objective at rtol 1e-5, and the
decision signs equal wherever a decision is clear of 0 by 1e-3. Both solve
in float32 with sums in other orders; 400 Adam steps carry those roundings
to about 1e-6 of w. (A class-balanced problem is avoided: there the bias
gradient of the first step is a sum of ±C that is exactly 0 in JAX and a
rounding residue in another order, which Adam's normalisation turns into a
full-size step.) Adam with the cosine schedule against optax itself at
rtol 1e-6; the hinge's gradient at a tie; the batched solve equal to the
per-detector solves (the JAX package's own bound, rtol 2e-4); and the
float64 host code (SMO, the duality gap, the objective, train_svm) equal to
JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffmining_tpu.ops import svm as jsvm

from diffmining_tpu_torch.ops import svm as psvm

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)


def _problem(seed, n_pos=24, n_neg=36, d=33):
    rng = np.random.RandomState(seed)
    X = np.concatenate([rng.randn(n_pos, d) + 0.5, rng.randn(n_neg, d) - 0.5]).astype(np.float32)
    y = np.asarray([1.0] * n_pos + [-1.0] * n_neg, np.float32)
    return X, y


def _signs_agree(a, b, clear=1e-3):
    keep = (np.abs(a) > clear) & (np.abs(b) > clear)
    return np.array_equal(np.sign(a[keep]), np.sign(b[keep]))


def test_adam_cosine_matches_optax():
    """A smooth quartic, 50 steps: the port's Adam and schedule against
    optax.adam(cosine_decay_schedule(lr, steps)) step for step."""
    rng = np.random.RandomState(0)
    target = rng.randn(7).astype(np.float32)
    steps, lr = 50, 0.05

    def jloss(p):
        return jnp.sum((p - target) ** 2) + 0.1 * jnp.sum(p**4)

    tx = optax.adam(optax.cosine_decay_schedule(lr, steps))
    p = jnp.zeros(7, jnp.float32)
    state = tx.init(p)
    for _ in range(steps):
        u, state = tx.update(jax.grad(jloss)(p), state)
        p = optax.apply_updates(p, u)
    t = torch.from_numpy(target)
    q = torch.zeros(7, requires_grad=True)
    psvm._adam_cosine([q], lambda: torch.sum((q - t) ** 2) + 0.1 * torch.sum(q**4), steps, lr)
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(p), rtol=1e-6, atol=1e-7)


def test_hinge_gradient_at_a_tie_is_half():
    m = torch.tensor([0.0, 1.0, -1.0], requires_grad=True)
    psvm._hinge(m).sum().backward()
    assert m.grad.tolist() == [0.5, 1.0, 0.0]
    jm = jax.grad(lambda x: jnp.sum(jnp.maximum(x, 0.0)))(jnp.asarray([0.0, 1.0, -1.0]))
    assert np.asarray(jm).tolist() == m.grad.tolist()


@pytest.mark.parametrize("seed", [0, 1])
def test_single_fit_matches_jax(seed):
    X, y = _problem(seed)
    w_j, b_j = jsvm.fit_linear_svm(X, y, C=0.1)
    w_p, b_p = psvm.fit_linear_svm(X, y, C=0.1, device="cpu")
    assert w_p.dtype == np.float32 and w_p.shape == (33,)
    np.testing.assert_allclose(w_p, w_j, **TOL)
    np.testing.assert_allclose(b_p, b_j, **TOL)
    np.testing.assert_allclose(psvm.primal_objective(X, y, w_p, b_p, 0.1),
                               jsvm.primal_objective(X, y, w_j, b_j, 0.1), rtol=1e-5)
    assert _signs_agree(psvm.decision_function(X, w_p, b_p), jsvm.decision_function(X, w_j, b_j))


def test_single_fit_with_a_sample_mask_matches_jax():
    X, y = _problem(2)
    mask = (np.arange(len(y)) % 5 != 0).astype(np.float32)
    w_j, b_j = jsvm.fit_linear_svm(X, y, sample_mask=mask, steps=200, lr=0.03)
    w_p, b_p = psvm.fit_linear_svm(X, y, sample_mask=mask, steps=200, lr=0.03, device="cpu")
    np.testing.assert_allclose(w_p, w_j, **TOL)
    np.testing.assert_allclose(b_p, b_j, **TOL)


def _batch_problem(seed=0, J=3, D=33, M=40):
    rng = np.random.RandomState(seed)
    NEG = rng.randn(M, D).astype(np.float32)
    p_counts, h_counts, m_counts = [3, 5, 1], [0, 2, 4], [40, 30, 35]
    P = np.zeros((J, 5, D), np.float32)
    Pm = np.zeros((J, 5), np.float32)
    HN = np.zeros((J, 4, D), np.float32)
    HNm = np.zeros((J, 4), np.float32)
    NEGm = np.zeros((J, M), np.float32)
    for j in range(J):
        P[j, : p_counts[j]] = rng.randn(p_counts[j], D) + 1.0
        Pm[j, : p_counts[j]] = 1.0
        HN[j, : h_counts[j]] = rng.randn(h_counts[j], D) - 1.0
        HNm[j, : h_counts[j]] = 1.0
        NEGm[j, : m_counts[j]] = 1.0
    return (P, Pm, HN, HNm, NEG, NEGm), (p_counts, h_counts, m_counts)


def test_batch_fit_matches_jax():
    args, _ = _batch_problem()
    W_j, b_j, s_j = jsvm.fit_linear_svm_batch(*args)
    W_p, b_p, s_p = psvm.fit_linear_svm_batch(*args, device="cpu")
    assert W_p.shape == (3, 33) and b_p.shape == (3,) and s_p.shape == (40, 3)
    np.testing.assert_allclose(W_p, W_j, **TOL)
    np.testing.assert_allclose(b_p, b_j, **TOL)
    np.testing.assert_allclose(s_p, s_j, **TOL)
    assert _signs_agree(s_p, s_j)


def test_batch_fit_equals_per_detector_fits():
    """The summed objective with elementwise Adam over disjoint blocks is the
    per-detector solve (the JAX package's bound)."""
    args, (p_counts, h_counts, m_counts) = _batch_problem(seed=3)
    P, _, HN, _, NEG, _ = args
    W, b, scores = psvm.fit_linear_svm_batch(*args, device="cpu")
    for j in range(3):
        X = np.concatenate([P[j, : p_counts[j]], HN[j, : h_counts[j]], NEG[: m_counts[j]]])
        y = np.asarray([1.0] * p_counts[j] + [-1.0] * (h_counts[j] + m_counts[j]), np.float32)
        w_ref, b_ref = psvm.fit_linear_svm(X, y, C=0.1, device="cpu")
        np.testing.assert_allclose(W[j], w_ref, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(b[j], b_ref, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(scores[:, j], psvm.decision_function(NEG, W[j], b[j]), rtol=1e-4, atol=1e-5)


def test_train_svm_matches_jax():
    rng = np.random.RandomState(1)
    pos = [rng.randn(8) + 2 for _ in range(5)]
    neg = [rng.randn(8) - 2 for _ in range(40)]
    tricky = [rng.randn(8) + 2.2 for _ in range(3)]
    X = pos + tricky + neg
    w_j, hard_j = jsvm.train_svm(X, (5, 0, 43), max_samples=10)
    w_p, hard_p = psvm.train_svm(X, (5, 0, 43), max_samples=10, device="cpu")
    np.testing.assert_allclose(w_p, w_j, **TOL)
    assert len(hard_p) == len(hard_j) >= 1
    np.testing.assert_array_equal(np.asarray(hard_p), np.asarray(hard_j))


def test_host_solvers_equal_jax():
    """SMO, the duality gap and the objective are the same float64 numpy."""
    rng = np.random.RandomState(0)
    X = np.concatenate([rng.randn(40, 6) + 1.0, rng.randn(50, 6) - 1.0])
    y = np.asarray([1.0] * 40 + [-1.0] * 50)
    for a, b in zip(psvm.fit_svm_smo(X, y, C=0.1), jsvm.fit_svm_smo(X, y, C=0.1)):
        np.testing.assert_array_equal(a, b)
    w, b0 = psvm.fit_linear_svm(X, y, device="cpu")
    assert psvm.duality_gap(X, y, w, b0, 0.1) == jsvm.duality_gap(X, y, w, b0, 0.1)
    gap, rel, primal, dual = psvm.duality_gap(X, y, w, b0, 0.1)
    assert gap >= 0 and dual <= primal and rel < 0.05
    for n in (0, 1):
        got = psvm.fit_svm_smo(np.full((n, 3), 2.0), np.ones(n))
        want = jsvm.fit_svm_smo(np.full((n, 3), 2.0), np.ones(n))
        assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_fit_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        psvm.fit_linear_svm(*_problem(0))


def test_a_few_positive_fold_is_solved_as_jax_solves_it():
    """A Doersch fold's solve: 5 positives (the rows furthest along a
    direction, as a dense search picks them) against 3,000 negatives, all
    L2-normalised non-negative 2112-d rows, as HOG+LAB features are. Both
    packages give the same solve; in 400 steps it does not reach the point
    w = 0, b = -1 (objective 1.0 here, 1.38 reached), and the certificate's
    dual point is zero, since only positives violate their margins: it
    reads 1.0 in both. (The production-shape certificate, with 1,250
    positives, is tests/test_doersch.py's.)"""
    rng = np.random.RandomState(0)
    X = np.abs(rng.randn(3005, 2112)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    order = np.argsort(-(X @ np.abs(rng.randn(2112))))
    pos, neg = X[order[:5]], X[order[5:]]
    args = (pos[None], np.ones((1, 5), np.float32), np.zeros((1, 1, 2112), np.float32), np.zeros((1, 1), np.float32),
            neg, np.ones((1, len(neg)), np.float32))
    W_j, b_j, _ = jsvm.fit_linear_svm_batch(*args)
    W_p, b_p, _ = psvm.fit_linear_svm_batch(*args, device="cpu")
    np.testing.assert_allclose(W_p, W_j, **TOL)
    np.testing.assert_allclose(b_p, b_j, **TOL)
    Xa = np.concatenate([pos, neg]).astype(np.float64)
    y = np.concatenate([np.ones(5), -np.ones(len(neg))])
    trivial = psvm.primal_objective(Xa, y, np.zeros(2112), -1.0, 0.1)
    assert trivial == pytest.approx(1.0)
    assert psvm.primal_objective(Xa, y, W_p[0], b_p[0], 0.1) > 1.3 * trivial
    assert psvm.duality_gap(Xa, y, W_p[0], b_p[0], 0.1)[1] == jsvm.duality_gap(Xa, y, W_j[0], b_j[0], 0.1)[1] == 1.0
