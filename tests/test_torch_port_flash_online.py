"""The port's online-softmax forward (K3) and forward route gates, held to
the JAX package on the CPU.

``flash_fwd_online_plain`` (the CUDA kernel's arithmetic) against the
Pallas ``_flash_kernel_t`` through ``_flash_forward_t`` and the channel-major
``_flash_forward_cbl``, in interpret mode and fp32, at rtol 1e-5 (summation
order only): several k blocks, masked key tails, head dims 40/80/160. The
underflow edge, where the no-max kernels give zeros and K3 stays the
softmax. And the route table: for every setting of
DIFFMINING_FLASH_ONESHOT, DIFFMINING_FLASH_NOMAX and DIFFMINING_ATTN_TLAYOUT
and each gated shape, the port picks the counterpart of the Pallas kernel
that the JAX ``sdpa`` runs (seen by tracing it, with a spy on each kernel
as tests/test_flag_matrix.py does).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import diffmining_tpu.ops.attention as jattn
import diffmining_tpu.ops.flash_attention as jfa

from diffmining_tpu_torch.ops import attention as pattn
from diffmining_tpu_torch.ops import flash_attention as pfa

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _qkv(b, h, lq, lk, d, seed, logit_scale=1.0):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, h, lq, d) * logit_scale).astype(np.float32)
    k = rng.randn(b, h, lk, d).astype(np.float32)
    v = rng.randn(b, h, lk, d).astype(np.float32)
    return q, k, v


def _jax_t(q, k, v, **kw):
    tr = lambda a: jnp.asarray(a.transpose(0, 1, 3, 2))  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        o = jfa._flash_forward_t(tr(q), tr(k), tr(v), oneshot=False, nomax=False, **kw)
    return np.asarray(o).transpose(0, 1, 3, 2)


@pytest.mark.parametrize(
    "b,h,lq,lk,d,blocks",
    [
        (1, 2, 512, 512, 40, (128, 128)),   # four k blocks
        (1, 1, 512, 300, 80, (128, 128)),   # masked key tail in the last block
        (2, 1, 260, 520, 160, (128, 128)),  # q pad and several k blocks, D=160
        (1, 2, 256, 256, 40, (None, None)),  # the default block policy: one k block
    ],
)
def test_online_plain_matches_jax_t(b, h, lq, lk, d, blocks):
    q, k, v = _qkv(b, h, lq, lk, d, seed=lq + d)
    block_q, block_k = blocks
    want = _jax_t(q, k, v, block_q=block_q, block_k=block_k)
    got = pfa.flash_fwd_online_plain(_t(q), _t(k), _t(v), block_k=block_k).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_online_plain_matches_jax_cbl():
    """_flash_forward_cbl with one-shot off and several k blocks (nkb = 4)
    runs _flash_kernel_t with k_axis=3 on channel-major operands."""
    h, d, b, l = 2, 40, 2, 512
    q, k, v = _qkv(b, h, l, l, d, seed=11)
    cbl = lambda a: jnp.asarray(a.transpose(1, 3, 0, 2).reshape(h * d, b, l))  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        o = jfa._flash_forward_cbl(cbl(q), cbl(k), cbl(v), h, block_q=128, block_k=128, oneshot=False)
    want = np.asarray(o).reshape(h, d, b, l).transpose(2, 0, 3, 1)
    got = pfa.flash_fwd_online_plain(_t(q), _t(k), _t(v), block_k=128).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_online_plain_bf16_rounds_where_the_kernel_does():
    """bf16 operands against the Pallas K3 on the same bf16 values: one bf16
    ulp where fp32 summation order flips a rounding."""
    q, k, v = _qkv(1, 2, 512, 512, 80, seed=8)
    qb, kb, vb = (_t(a).to(torch.bfloat16) for a in (q, k, v))
    got = pfa.flash_fwd_online_plain(qb, kb, vb, block_k=128).float().numpy()
    tr = lambda a: jnp.asarray(a.float().numpy(), jnp.bfloat16).transpose(0, 1, 3, 2)  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        o = jfa._flash_forward_t(tr(qb), tr(kb), tr(vb), block_q=128, block_k=128, oneshot=False, nomax=False)
    want = np.asarray(o.astype(jnp.float32)).transpose(0, 1, 3, 2)
    np.testing.assert_allclose(got, want, rtol=8e-3, atol=8e-3)
    assert np.mean(got == want) > 0.95


def test_underflow_edge_stays_the_softmax():
    """Every natural logit −95: the no-max forward flushes the row to zeros
    (its designed edge); K3 keeps the running max, so it is the softmax (the
    mean of v here), as the Pallas K3 is."""
    d, lq, lk = 8, 128, 256
    q = np.zeros((1, 1, lq, d), np.float32)
    k = np.zeros((1, 1, lk, d), np.float32)
    q[..., 0] = -95.0 * np.sqrt(d)
    k[..., 0] = 1.0
    v = np.random.RandomState(12).randn(1, 1, lk, d).astype(np.float32)
    got = pfa.flash_fwd_online_plain(_t(q), _t(k), _t(v), block_k=128).numpy()
    softmax = pattn.sdpa_plain(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(got, softmax, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, _jax_t(q, k, v, block_q=128, block_k=128), rtol=1e-5, atol=1e-6)
    assert np.abs(got).max() > 1e-3
    assert np.abs(pfa.flash_attention_nomax_plain(_t(q), _t(k), _t(v)).numpy()).max() == 0.0


# --------------------------------------------------------------- route table

JAX_KERNELS = {  # the Pallas kernel -> the TPU kernel it is
    "_flash_kernel_t_1shot": "K1",
    "_flash_kernel_t_nomax": "K2",
    "_flash_kernel_t": "K3",
    "_flash_kernel": "K4",
}
GATED = [(1024, 80), (2048, 40), (4096, 40), (16384, 40)]


def _jax_route(monkeypatch, lq, d):
    """Which Pallas kernel the JAX sdpa traces for a gated self-attention
    forward (abstract evaluation: the kernels are traced, nothing runs)."""
    hits = []
    for name in JAX_KERNELS:
        orig = getattr(jfa, name)

        def spy(*a, _name=name, _orig=orig, **k):
            hits.append(_name)
            return _orig(*a, **k)

        monkeypatch.setattr(jfa, name, spy)
    monkeypatch.setattr(jattn, "_DEFAULT_BACKEND", "pallas")
    s = jax.ShapeDtypeStruct((1, 1, lq, d), jnp.bfloat16)
    # a fresh function each time: eval_shape caches the trace per function
    # and shapes, and the settings are not part of that key
    jax.eval_shape(lambda q, k, v: jattn.sdpa(q, k, v), s, s, s)
    assert len(set(hits)) == 1, hits
    return JAX_KERNELS[hits[0]]


@pytest.mark.parametrize("lq,d", GATED)
@pytest.mark.parametrize("tlayout", ["1", "0"])
@pytest.mark.parametrize("nomax", ["1", "0"])
@pytest.mark.parametrize("oneshot", ["all", "1", "0"])
def test_route_matches_jax(monkeypatch, oneshot, nomax, tlayout, lq, d):
    for mod in (jfa, pfa):
        monkeypatch.setattr(mod, "_ONESHOT", oneshot)
        monkeypatch.setattr(mod, "_NOMAX", nomax)
    monkeypatch.setenv("DIFFMINING_ATTN_TLAYOUT", tlayout)
    want = _jax_route(monkeypatch, lq, d)
    assert pfa.forward_route(lq, lq) == want


def test_default_routes_are_the_earlier_slices():
    """Under the default settings the 512px sweep's shapes run K1 (the no-max
    kernel) and 1024px native-res L=16384 runs K2, as in slices 1 and 2."""
    assert (pfa._ONESHOT, pfa._NOMAX) == ("all", "1")
    assert pfa.forward_route(4096, 4096) == pfa.forward_route(1024, 1024) == "K1"
    assert pfa.forward_route(16384, 16384) == "K2"
    assert pattn.FORWARD["K1"] is pattn.FORWARD["K2"] is pfa.flash_fwd_nomax
    assert pattn.FORWARD["K3"] is pfa.flash_fwd_online


def test_sdpa_takes_the_routed_wrapper(monkeypatch):
    """With the gate opened on CPU tensors, sdpa calls the wrapper of the
    routed kernel (whose CPU path is its plain version)."""
    monkeypatch.setattr(pattn, "use_kernel", lambda *a: True)
    called = []
    for key, fn in list(pattn.FORWARD.items()):
        monkeypatch.setitem(pattn.FORWARD, key, lambda *a, _k=key, _f=fn: called.append(_k) or _f(*a))
    q, k, v = (_t(a) for a in _qkv(1, 1, 1024, 1024, 8, seed=2))
    monkeypatch.setattr(pfa, "_ONESHOT", "0")
    monkeypatch.setattr(pfa, "_NOMAX", "0")
    got = pattn.sdpa(q, k, v)
    assert called == ["K3"]
    torch.testing.assert_close(got, pfa.flash_fwd_online_plain(q, k, v), rtol=0, atol=0)
    monkeypatch.setenv("DIFFMINING_ATTN_TLAYOUT", "0")
    pattn.sdpa(q, k, v)
    assert called == ["K3", "K4"]


def test_online_wrapper_raises_under_grad_and_keeps_cpu_off_the_kernel(monkeypatch):
    def no_library(*a, **k):
        raise AssertionError("CPU tensors must not reach the CUDA kernel")

    monkeypatch.setattr(pfa, "_library", no_library)
    monkeypatch.setattr(pfa, "build", no_library)
    q, k, v = (_t(a) for a in _qkv(1, 1, 128, 128, 8, seed=3))
    before = pfa.flash_fwd_online.launches
    torch.testing.assert_close(pfa.flash_fwd_online(q, k, v), pfa.flash_fwd_online_plain(q, k, v), rtol=0, atol=0)
    assert pfa.flash_fwd_online.launches == before
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        pfa.flash_fwd_online(q, k, v)
