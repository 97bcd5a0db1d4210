"""The port's schedule, attention dispatch and no-max flash attention, held
to the JAX package on the CPU.

The same numpy inputs (from a seed) go through the JAX function and its
port counterpart. The Pallas kernels run in interpret mode, as
tests/test_flash_attention.py runs them. The CUDA kernel itself runs only on
a GPU (tests/test_torch_port_cuda.py); here its plain PyTorch version stands
in, and the dispatch is checked to never hand a CPU tensor to
the CUDA wrapper.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import diffmining_tpu.ops.flash_attention as jfa
from diffmining_tpu.diffusion.schedule import add_noise as jadd_noise
from diffmining_tpu.diffusion.schedule import make_schedule as jmake_schedule
from diffmining_tpu.ops.attention import sdpa_xla

from diffmining_tpu_torch.diffusion.schedule import add_noise, make_schedule
from diffmining_tpu_torch.ops import attention as pattn
from diffmining_tpu_torch.ops import flash_attention as pfa

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("beta_schedule", ["scaled_linear", "linear", "squaredcos_cap_v2"])
def test_schedule_matches_jax(beta_schedule):
    js = jmake_schedule(beta_schedule=beta_schedule)
    ps = make_schedule(beta_schedule=beta_schedule)
    np.testing.assert_allclose(ps.betas.numpy(), np.asarray(js.betas), rtol=1e-6)
    np.testing.assert_allclose(ps.alphas_cumprod.numpy(), np.asarray(js.alphas_cumprod), rtol=1e-6)

    rng = np.random.RandomState(0)
    x0 = rng.randn(3, 4, 6, 5).astype(np.float32)
    noise = rng.randn(3, 4, 6, 5).astype(np.float32)
    t = rng.randint(0, 1000, (3,)).astype(np.int32)
    want = np.asarray(jadd_noise(js, jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t)))
    got = add_noise(ps, _t(x0), _t(noise), _t(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _qkv(b, h, lq, lk, d, seed, logit_scale=1.0):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, h, lq, d) * logit_scale).astype(np.float32)
    k = rng.randn(b, h, lk, d).astype(np.float32)
    v = rng.randn(b, h, lk, d).astype(np.float32)
    return q, k, v


def _jax_t(q, k, v, **kw):
    """_flash_forward_t on [B,H,D,L] operands, interpret mode, back to [B,H,L,D]."""
    tr = lambda a: jnp.asarray(a.transpose(0, 1, 3, 2))  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        o = jfa._flash_forward_t(tr(q), tr(k), tr(v), **kw)
    return np.asarray(o).transpose(0, 1, 3, 2)


@pytest.mark.parametrize(
    "b,h,lq,lk,d,kw",
    [
        # _flash_kernel_t_1shot: the whole key row in one block
        (1, 2, 256, 256, 40, dict(oneshot=True)),
        (1, 2, 256, 77, 80, dict(oneshot=True)),  # masked key pad in the block
        (2, 1, 130, 130, 160, dict(oneshot=True)),  # q pad, D=160
        # _flash_kernel_t_nomax: several k blocks (test_flash_attention.py:257-285 shapes)
        (1, 2, 512, 512, 40, dict(block_q=128, block_k=128, oneshot=False, nomax=True)),
        (1, 1, 512, 300, 80, dict(block_q=128, block_k=128, oneshot=False, nomax=True)),  # masked tail
        (2, 1, 260, 520, 160, dict(block_q=128, block_k=128, oneshot=False, nomax=True)),  # q pad + multi
    ],
)
def test_flash_plain_matches_jax_kernels(b, h, lq, lk, d, kw):
    """The plain version repeats the no-max kernels' arithmetic: equal to the
    Pallas kernels in fp32 up to summation order, and inside the JAX tests'
    envelope of the softmax reference."""
    q, k, v = _qkv(b, h, lq, lk, d, seed=d + lq)
    want = _jax_t(q, k, v, **kw)
    got = pfa.flash_attention_nomax_plain(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    ref = np.asarray(sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)


def test_flash_plain_adversarial_logits_match_softmax():
    """Natural logits of std ~12 (test_flash_attention.py's adversarial case):
    inside the no-max envelope the plain version is still the softmax."""
    q, k, v = _qkv(1, 1, 512, 512, 8, seed=9, logit_scale=12.0)
    got = pfa.flash_attention_nomax_plain(_t(q), _t(k), _t(v)).numpy()
    want = np.asarray(sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_flash_plain_underflow_edge():
    """Every natural logit −95: exp2 underflows (flushed as on the TPU), so
    the row is zeros where the softmax is the mean of v — the designed edge
    of test_oneshot_underflow_edge_is_designed_divergence, equal to the JAX
    one-shot kernel's output."""
    d, lq, lk = 8, 128, 256
    q = np.zeros((1, 1, lq, d), np.float32)
    k = np.zeros((1, 1, lk, d), np.float32)
    q[..., 0] = -95.0 * np.sqrt(d)
    k[..., 0] = 1.0
    v = np.random.RandomState(12).randn(1, 1, lk, d).astype(np.float32)
    got = pfa.flash_attention_nomax_plain(_t(q), _t(k), _t(v)).numpy()
    assert np.abs(got).max() == 0.0
    np.testing.assert_array_equal(got, _jax_t(q, k, v, oneshot=True))
    softmax = pattn.sdpa_plain(_t(q), _t(k), _t(v)).numpy()
    assert np.abs(softmax).max() > 1e-3


def test_flash_plain_bf16_rounds_where_the_kernel_does():
    """bf16 inputs: pre-scale in bf16, p rounded to bf16 before PV, the
    denominator the sum of the rounded p — against the JAX one-shot kernel
    on the same bf16 values (interpret mode)."""
    q, k, v = _qkv(1, 2, 256, 256, 40, seed=3)
    qb, kb, vb = (_t(a).to(torch.bfloat16) for a in (q, k, v))
    got = pfa.flash_attention_nomax_plain(qb, kb, vb).float().numpy()
    tr = lambda a: jnp.asarray(a.float().numpy(), jnp.bfloat16).transpose(0, 1, 3, 2)  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        o = jfa._flash_forward_t(tr(qb), tr(kb), tr(vb), oneshot=True)
    want = np.asarray(o.astype(jnp.float32)).transpose(0, 1, 3, 2)
    # one bf16 ulp (2^-8 relative) where fp32 summation order flips a rounding
    np.testing.assert_allclose(got, want, rtol=8e-3, atol=8e-3)
    assert np.mean(got == want) > 0.95


@pytest.mark.parametrize(
    "q_shape,k_shape,masked,device,want",
    [
        ((16, 8, 4096, 40), (16, 8, 4096, 40), False, "cuda", True),   # K1, L4096
        ((16, 8, 1024, 80), (16, 8, 1024, 80), False, "cuda", True),   # K1, L1024
        ((24, 8, 16384, 40), (24, 8, 16384, 40), False, "cuda", True),  # K2, native res
        ((16, 8, 4096, 40), (16, 8, 77, 40), False, "cuda", False),    # cross-attention
        ((16, 8, 256, 160), (16, 8, 256, 160), False, "cuda", False),  # short L
        ((8, 1, 4096, 512), (8, 1, 4096, 512), False, "cuda", False),  # VAE, D=512
        ((8, 12, 1024, 64), (8, 12, 1024, 64), True, "cuda", False),   # masked (CLIP)
        ((16, 8, 4096, 40), (16, 8, 4096, 40), False, "cpu", False),   # CPU tensor
        ((2, 8, 1100, 160), (2, 8, 1100, 160), False, "cuda", True),   # any dtype: the wrapper raises on non-bf16
    ],
)
def test_dispatch_gate(q_shape, k_shape, masked, device, want):
    assert pattn.use_kernel(q_shape, k_shape, masked, torch.device(device)) is want


def test_cpu_tensor_never_reaches_the_cuda_wrapper(monkeypatch):
    """A CPU tensor at a gated shape takes the plain path: building or
    loading the CUDA library would raise, and the launch count stays."""

    def no_library():
        raise AssertionError("CPU tensors must not reach the CUDA kernel")

    monkeypatch.setattr(pfa, "_library", no_library)
    monkeypatch.setattr(pfa, "build", no_library)
    before = pfa.flash_fwd_nomax.launches
    q, k, v = (_t(a).to(torch.bfloat16) for a in _qkv(1, 1, 1024, 1024, 8, seed=5))
    out = pattn.sdpa(q, k, v)
    direct = pfa.flash_fwd_nomax(q, k, v)
    assert pfa.flash_fwd_nomax.launches == before
    torch.testing.assert_close(out, pattn.sdpa_plain(q, k, v), atol=0, rtol=0)
    torch.testing.assert_close(direct, pfa.flash_attention_nomax_plain(q, k, v), atol=0, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_sdpa_plain_matches_sdpa_xla(masked):
    q, k, v = _qkv(2, 3, 77, 77, 16, seed=4)
    mask = np.tril(np.ones((77, 77), bool))[None, None] if masked else None
    want = np.asarray(sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               mask=None if mask is None else jnp.asarray(mask)))
    got = pattn.sdpa_plain(_t(q), _t(k), _t(v), mask=None if mask is None else _t(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
