"""The port's training attention, held to the JAX package on the CPU: the
plain versions of K4 (flash forward with logsumexp), K5 (dq) and K6 (dk/dv)
against the Pallas kernels in interpret mode, as tests/test_flash_attention.py
runs them; the autograd Function's gradient against ``sdpa_xla``'s autodiff;
and the dispatch under grad. The CUDA kernels themselves run on a GPU only
(tests/test_torch_port_cuda.py).

Tolerances: in float32 the plain versions repeat the kernels' arithmetic and
differ only in summation order, so rtol 1e-5 / atol 2e-6 at outputs of order
0.1-1. Against the softmax reference (a different algorithm) the JAX tests'
own 2e-3 envelope holds.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import diffmining_tpu.ops.flash_attention as jfa
from diffmining_tpu.ops.attention import sdpa_xla

from diffmining_tpu_torch.ops import attention as pattn
from diffmining_tpu_torch.ops import flash_attention as pfa

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=2e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(b, h, lq, lk, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, lq, d).astype(np.float32)
    k = rng.randn(b, h, lk, d).astype(np.float32)
    v = rng.randn(b, h, lk, d).astype(np.float32)
    g = rng.randn(b, h, lq, d).astype(np.float32)
    return q, k, v, g


def _jax_forward(q, k, v, **blocks):
    with pltpu.force_tpu_interpret_mode():
        o, lse = jfa._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), return_lse=True, **blocks)
    return np.asarray(o), np.asarray(lse)


@pytest.mark.parametrize(
    "b,h,lq,lk,d,blocks",
    [
        (1, 2, 256, 256, 40, {}),  # one k block, head dim 40
        (1, 2, 130, 77, 80, {}),  # masked key tail inside the 128-key block
        (2, 1, 130, 130, 160, {}),  # D=160
        (1, 2, 256, 256, 40, dict(block_q=128, block_k=128)),  # running max over two k blocks
        (1, 1, 200, 200, 80, dict(block_q=128, block_k=128)),  # ...with a masked last block
    ],
)
def test_fwd_lse_plain_matches_jax_kernel(b, h, lq, lk, d, blocks):
    """K4's plain version at the TPU kernel's key block equals
    _flash_forward(..., return_lse=True) in interpret mode: o and the
    natural-log lse."""
    q, k, v, _ = _inputs(b, h, lq, lk, d, seed=d + lq)
    want_o, want_lse = _jax_forward(q, k, v, **blocks)
    got_o, got_lse = pfa.flash_fwd_lse_plain(_t(q), _t(k), _t(v), block_k=blocks.get("block_k"))
    np.testing.assert_allclose(got_o.numpy(), want_o, **TOL)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, **TOL)
    ref = np.asarray(sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(got_o.numpy(), ref, rtol=2e-3, atol=2e-3)
    logits = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k.astype(np.float64)) / math.sqrt(d)
    np.testing.assert_allclose(got_lse.numpy(), np.log(np.exp(logits).sum(-1)), rtol=1e-4, atol=1e-4)


def test_fwd_lse_plain_bf16_rounds_where_the_kernel_does():
    """bf16 inputs: the pre-scale in bf16 and p rounded to bf16 relative to
    the running max before PV, against the JAX kernel on the same bf16
    values and the same key blocks (two k blocks of 128)."""
    q, k, v, _ = _inputs(1, 2, 256, 256, 40, seed=5)
    qb, kb, vb = (_t(a).to(torch.bfloat16) for a in (q, k, v))
    got_o, got_lse = pfa.flash_fwd_lse_plain(qb, kb, vb, block_k=128)
    jb = lambda a: jnp.asarray(a.float().numpy(), jnp.bfloat16)  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        o, lse = jfa._flash_forward(jb(qb), jb(kb), jb(vb), block_q=128, block_k=128, return_lse=True)
    want = np.asarray(o.astype(jnp.float32))
    got = got_o.float().numpy()
    # one bf16 ulp (2^-8 relative) where fp32 summation order flips a rounding
    np.testing.assert_allclose(got, want, rtol=8e-3, atol=8e-3)
    assert np.mean(got == want) > 0.95
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "b,h,lq,lk,d,blocks",
    [
        (1, 2, 256, 256, 40, {}),
        (1, 1, 77, 77, 40, {}),  # q rows and keys padded to 128 and masked
        (1, 2, 200, 200, 80, dict(block_q=128, block_k=128)),  # several blocks, masked tails
        (2, 1, 130, 130, 160, {}),
        (1, 1, 77, 77, 160, {}),
    ],
)
def test_bwd_plain_matches_jax_kernels(b, h, lq, lk, d, blocks):
    """K5's and K6's plain versions equal _bwd_pallas (the dq and dk/dv
    Pallas kernels) in interpret mode, from the same forward residuals."""
    q, k, v, g = _inputs(b, h, lq, lk, d, seed=3 * d + lq)
    o, lse = _jax_forward(q, k, v)
    with pltpu.force_tpu_interpret_mode():
        jdq, jdk, jdv = jfa._bwd_pallas(
            None, tuple(jnp.asarray(a) for a in (q, k, v, o, lse)), jnp.asarray(g), **blocks)
    tq, tk, tv, tg, to_, tl = (_t(a) for a in (q, k, v, g, o, lse))
    delta = pfa.attention_delta(tg, to_)
    np.testing.assert_allclose(delta.numpy(), (g * o).sum(-1), rtol=1e-5, atol=1e-5)
    dq = pfa.flash_bwd_dq_plain(tq, tk, tv, tg, tl, delta)
    dk, dv = pfa.flash_bwd_dkv_plain(tq, tk, tv, tg, tl, delta)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("lq,lk,d", [(128, 128, 32), (130, 130, 40), (96, 77, 80)])
def test_flash_attention_gradient_matches_sdpa_xla(lq, lk, d):
    """The autograd Function (K4 forward, K5/K6 backward: their plain
    versions on the CPU) against JAX autodiff of sdpa_xla, in float32."""
    q, k, v, g = _inputs(1, 2, lq, lk, d, seed=11)

    def loss_xla(q, k, v):
        return jnp.sum(sdpa_xla(q, k, v) * jnp.asarray(g))

    want = jax.grad(loss_xla, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    out = pfa.flash_attention(tq, tk, tv)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    (out * _t(g)).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-4, atol=2e-5)


def test_dispatch_under_grad_picks_the_autograd_function(monkeypatch):
    """At a gated shape, grad enabled with an input that requires grad goes
    to flash_attention (K4 -> K5/K6); everything else to the forward-only
    flash_fwd_nomax. The gate is opened for CPU tensors here so the routing
    runs on the plain versions."""
    monkeypatch.setattr(pattn, "use_kernel", lambda *a: True)
    q, k, v, g = (_t(a) for a in _inputs(1, 2, 128, 128, 40, seed=2))
    counts = (pfa.flash_fwd_nomax.launches, pfa.flash_fwd_lse.launches)

    qr = q.clone().requires_grad_(True)
    out = pattn.sdpa(qr, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    (out * g).sum().backward()
    assert qr.grad is not None and float(qr.grad.abs().max()) > 0

    with torch.no_grad():
        nograd = pattn.sdpa(qr, k, v)
    assert nograd.grad_fn is None
    torch.testing.assert_close(nograd, pfa.flash_attention_nomax_plain(q, k, v), rtol=0, atol=0)
    plain = pattn.sdpa(q, k, v)  # grad enabled, nothing requires grad
    assert plain.grad_fn is None
    assert (pfa.flash_fwd_nomax.launches, pfa.flash_fwd_lse.launches) == counts  # CPU: no launches


def test_flash_fwd_nomax_raises_under_grad():
    """flash_fwd_nomax has no backward: under grad it raises instead of
    returning an output with no gradient."""
    q, k, v, _ = (_t(a) for a in _inputs(1, 1, 64, 64, 8, seed=1))
    with pytest.raises(RuntimeError, match="no backward"):
        pfa.flash_fwd_nomax(q.requires_grad_(True), k, v)
    with torch.no_grad():
        pfa.flash_fwd_nomax(q, k, v)


def _over_tolerance(got: torch.Tensor, want: torch.Tensor, rtol: float) -> float:
    """Worst ratio of |got - want| to chip_smoke.py's kernel-vs-plain bound,
    rtol |want| + 2^-7 rms(want): rtol is one bf16 ulp (2^-7) for K4 and two
    (2^-6) for K5/K6, plus one ulp at the output's own scale."""
    w = want.float()
    tol = rtol * w.abs() + 2.0**-7 * w.pow(2).mean().sqrt()
    return float(((got.float() - w).abs() / tol).max())


@pytest.mark.parametrize("l,d", [(1024, 40), (300, 80)])
def test_kernel_bound_catches_a_dropped_tile(l, d):
    """The bounds that hold each training kernel to its plain version (K4 at
    the kernel's own key tiles, ONLINE_BLOCK_K) are tight enough to see a
    kernel that skips one key tile of K4, one 64-key tile of dq or one
    64-row q tile of dk/dv: such an output is over 50x its bound, while
    K4's plain version at the TPU's key block (other rounding points of p)
    stays within a few ulps."""
    t = pfa.ONLINE_BLOCK_K
    q, k, v, g = (_t(a).to(torch.bfloat16) for a in _inputs(1, 2, l, l, d, seed=7))
    o_t, lse_t = pfa.flash_fwd_lse_plain(q, k, v, block_k=t)
    dropped, _ = pfa.flash_fwd_lse_plain(q, k[:, :, t:], v[:, :, t:], block_k=t)
    assert _over_tolerance(dropped, o_t, 2.0**-7) > 50
    other, _ = pfa.flash_fwd_lse_plain(q, k, v)
    assert _over_tolerance(other, o_t, 2.0**-7) < 4
    delta = pfa.attention_delta(g, o_t)
    dq = pfa.flash_bwd_dq_plain(q, k, v, g, lse_t, delta)
    dq_dropped = pfa.flash_bwd_dq_plain(q, k[:, :, 64:], v[:, :, 64:], g, lse_t, delta)
    assert _over_tolerance(dq_dropped, dq, 2.0**-6) > 50
    dk, dv = pfa.flash_bwd_dkv_plain(q, k, v, g, lse_t, delta)
    dk_dropped, dv_dropped = pfa.flash_bwd_dkv_plain(q[:, :, 64:], k, v, g[:, :, 64:], lse_t[:, :, 64:],
                                                     delta[:, :, 64:])
    assert _over_tolerance(dk_dropped, dk, 2.0**-6) > 50 and _over_tolerance(dv_dropped, dv, 2.0**-6) > 50
