"""The port's channel-major transformer world (DIFFMINING_TF_CMAJOR=1) held to
the JAX package on the CPU.

The channel-major plain versions (the arithmetic of the channel-major K1 and
K3 kernels, ``flash_fwd_nomax_cm_plain`` and ``flash_fwd_online_cm_plain``)
against the Pallas kernels that ``_flash_forward_cbl`` launches, in
interpret mode at float32, on operands viewed from both layouts ([B, H*D, L]
and the JAX package's [H*D, B, L]): the cases of the JAX package's own
test (tests/test_flash_attention.py:167-174) and head dims 40, 80 and 160.
The grad path (``flash_attention_cbl``) against JAX's custom VJP.
``sdpa_cbl_plain`` against ``sdpa_cbl_xla``, and the dispatch of
``sdpa_cbl`` to the routed wrapper. The UNet's channel-major world is held
to JAX in tests/test_torch_port_cmajor_unet.py.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import diffmining_tpu.ops.flash_attention as jfa
from diffmining_tpu.ops.attention import sdpa_cbl_xla

from diffmining_tpu_torch.ops import attention as pattn
from diffmining_tpu_torch.ops import flash_attention as pfa

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cbl(h, d, b, l, seed):
    """Three [H*D, B, L] float32 operands (the JAX layout)."""
    rng = np.random.RandomState(seed)
    return [rng.randn(h * d, b, l).astype(np.float32) for _ in range(3)]


def _views(a, h, layout):
    """A [H*D, B, L] numpy array as the port's [B, H, L, D] view with L
    stride 1: of a [B, H*D, L] tensor ("bcl") or of the [H*D, B, L] one
    ("cbl")."""
    hd, b, l = a.shape
    if layout == "bcl":
        return pattn.split_cm(_t(a.transpose(1, 0, 2)), h)
    return _t(a).view(h, hd // h, b, l).permute(2, 0, 3, 1)


def _to_cbl(o):
    """A port [B, H, L, D] result as JAX's [H*D, B, L]."""
    b, h, l, d = o.shape
    return o.permute(1, 3, 0, 2).reshape(h * d, b, l).numpy()


# the cases of tests/test_flash_attention.py:167-174, then head dims 40, 80
# and 160 at the one-shot (K1) and several-block (K3) routes
CASES = [
    (2, 2, 256, 256, 8, 128, 128, False),
    (2, 2, 256, 256, 8, 128, 256, True),
    (2, 2, 256, 200, 8, 128, 256, True),
    (2, 2, 250, 200, 8, 128, 128, False),
    (1, 2, 256, 256, 40, 128, 256, True),
    (1, 2, 300, 300, 40, 128, 128, False),
    (2, 1, 256, 200, 80, 128, 256, True),
    (1, 1, 260, 260, 160, 128, 128, False),
]


@pytest.mark.parametrize("layout", ["bcl", "cbl"])
@pytest.mark.parametrize("b,h,lq,lk,d,block_q,block_k,oneshot", CASES)
def test_cm_plain_matches_jax_cbl(b, h, lq, lk, d, block_q, block_k, oneshot, layout):
    """The channel-major plain version of the kernel _flash_forward_cbl
    launches (K1 when the padded key row is one block and one-shot is on,
    else K3 at its block) against the Pallas kernel in interpret mode: the
    same float32 arithmetic in other summation orders (rtol 1e-5)."""
    rng = np.random.RandomState(lq + d)
    q = rng.randn(h * d, b, lq).astype(np.float32)
    k, v = (rng.randn(h * d, b, lk).astype(np.float32) for _ in range(2))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfa._flash_forward_cbl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h,
                                                 block_q=block_q, block_k=block_k, oneshot=oneshot))
    qv, kv, vv = (_views(a, h, layout) for a in (q, k, v))
    one_block = -(-lk // block_k) == 1
    if one_block and oneshot:
        got = pfa.flash_fwd_nomax_cm_plain(qv, kv, vv)
    else:
        got = pfa.flash_fwd_online_cm_plain(qv, kv, vv, block_k=block_k)
    assert got.stride(2) == 1  # laid out as the kernel writes it
    np.testing.assert_allclose(_to_cbl(got), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(want, np.asarray(sdpa_cbl_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h)),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("d", [40, 80, 160])
def test_cm_wrappers_on_cpu_route_as_jax(monkeypatch, d):
    """At a gated length the wrappers' CPU path (their plain versions) on
    both layouts equals JAX's _flash_forward_cbl under the default block
    policy: L 1000 routes to K1 (one key block), L 1100 to K3 (two)."""
    h, b = 2, 1
    for l in (1000, 1100):
        q, k, v = _cbl(h, d, b, l, seed=l + d)
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jfa._flash_forward_cbl(*(jnp.asarray(a) for a in (q, k, v)), h))
        kind = pfa.forward_route_cbl(l, l)
        assert kind == ("K1" if l == 1000 else "K3")
        for layout in ("bcl", "cbl"):
            got = pfa.FORWARD_CM[kind](*(_views(a, h, layout) for a in (q, k, v)))
            np.testing.assert_allclose(_to_cbl(got), want, rtol=1e-5, atol=1e-6)


def test_cm_wrappers_keep_cpu_off_the_kernel(monkeypatch):
    """CPU tensors never reach the CUDA library, and a forward-only wrapper
    raises under grad."""
    def no_library(*a, **k):
        raise AssertionError("CPU tensors must not reach the CUDA kernel")

    monkeypatch.setattr(pfa, "_library", no_library)
    monkeypatch.setattr(pfa, "build", no_library)
    q, k, v = (_views(a, 2, "bcl") for a in _cbl(2, 8, 1, 128, seed=5))
    before = (pfa.flash_fwd_nomax_cm.launches, pfa.flash_fwd_online_cm.launches)
    torch.testing.assert_close(pfa.flash_fwd_nomax_cm(q, k, v), pfa.flash_attention_nomax_plain(q, k, v))
    torch.testing.assert_close(pfa.flash_fwd_online_cm(q, k, v), pfa.flash_fwd_online_plain(q, k, v))
    assert (pfa.flash_fwd_nomax_cm.launches, pfa.flash_fwd_online_cm.launches) == before
    q.requires_grad_(True)
    for fn in (pfa.flash_fwd_nomax_cm, pfa.flash_fwd_online_cm):
        with pytest.raises(RuntimeError, match="no backward"):
            fn(q, k, v)


def test_cm_in_place_rule():
    """The channel-major kernels read [B, H*D, L] and [H*D, B, L] views in
    place at L a multiple of 16 bytes; a misaligned length (L 1100 in bf16)
    or a head-dim-contiguous view is copied into a padded buffer, whose
    values equal the operand's."""
    for dtype, ok_l, bad_l in ((torch.bfloat16, 1024, 1100), (torch.float32, 1100, 1001)):
        x = torch.zeros(2, 16 * 40, ok_l, dtype=dtype)
        assert pfa.cm_in_place(pattn.split_cm(x, 16))
        assert pfa.cm_in_place(torch.zeros(16 * 40, 2, ok_l, dtype=dtype).view(16, 40, 2, ok_l).permute(2, 0, 3, 1))
        assert not pfa.cm_in_place(pattn.split_cm(torch.zeros(2, 640, bad_l, dtype=dtype), 16))
        assert not pfa.cm_in_place(torch.zeros(2, 16, ok_l, 40, dtype=dtype))
    t = pattn.split_cm(torch.randn(2, 80, 1100).to(torch.bfloat16), 2)
    before = pfa.flash_fwd_nomax_cm.copies
    (c,) = pfa._cm_operands(pfa.flash_fwd_nomax_cm, t)
    assert pfa.flash_fwd_nomax_cm.copies == before + 1
    assert c.stride(2) == 1 and c.stride(3) == 1104 and torch.equal(c, t)
    assert torch.count_nonzero(c.transpose(2, 3).reshape(2, 80, 1100)[..., 0]) > 0


def test_cbl_gradient_matches_jax():
    """Under grad flash_attention_cbl takes head-dim-contiguous copies through
    FlashAttention (its CPU path the plain K4/K5/K6), as JAX's _fwd_cbl/
    _bwd_cbl do; the gradients reach the channel-major operands, within
    JAX's own bound for its cbl gradient (2e-3) and 1e-4 here."""
    h, d, b, l = 2, 8, 2, 256
    q, k, v = _cbl(h, d, b, l, seed=4)

    def loss_flash(q, k, v):
        return jnp.sum(jnp.sin(jfa.flash_attention_cbl(q, k, v, h, None)))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss_flash, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [_t(a.transpose(1, 0, 2)).requires_grad_(True) for a in (q, k, v)]
    o = pfa.flash_attention_cbl(*(pattn.split_cm(t, h) for t in leaves))
    assert o.stride(2) == 1
    torch.sin(o).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy().transpose(1, 0, 2), np.asarray(w), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("lq,lk", [(256, 256), (256, 77)])
def test_sdpa_cbl_plain_matches_xla(lq, lk):
    """sdpa_cbl_plain (fp32 logits, weights in q's dtype) against
    sdpa_cbl_xla, at self- and cross-attention lengths."""
    h, d, b = 2, 40, 2
    rng = np.random.RandomState(lq + lk)
    q = rng.randn(h * d, b, lq).astype(np.float32)
    k, v = (rng.randn(h * d, b, lk).astype(np.float32) for _ in range(2))
    want = np.asarray(sdpa_cbl_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h))
    got = pattn.sdpa_cbl_plain(*(_t(a.transpose(1, 0, 2)) for a in (q, k, v)), h)
    np.testing.assert_allclose(got.numpy().transpose(1, 0, 2), want, rtol=1e-5, atol=1e-6)


def test_sdpa_cbl_takes_the_routed_wrapper(monkeypatch):
    """With the gate opened on CPU tensors, sdpa_cbl calls the channel-major
    wrapper of the routed kernel on views of its operands (no copy) and
    returns the same [B, H*D, L] as the plain path; under grad it takes
    flash_attention_cbl."""
    monkeypatch.setattr(pattn, "use_kernel", lambda *a: True)
    called = []
    for key, fn in list(pattn.FORWARD_CBL.items()):
        def spy(q, k, v, scale=None, _k=key, _f=fn):
            called.append((_k, q.stride(2)))
            return _f(q, k, v, scale)
        monkeypatch.setitem(pattn.FORWARD_CBL, key, spy)
    q, k, v = (_t(a.transpose(1, 0, 2)) for a in _cbl(2, 8, 2, 1024, seed=6))
    got = pattn.sdpa_cbl(q, k, v, 2)
    assert called == [("K1", 1)]
    np.testing.assert_allclose(got.numpy(), pattn.sdpa_cbl_plain(q, k, v, 2).numpy(), rtol=1e-5, atol=1e-6)
    monkeypatch.setattr(pfa, "_ONESHOT", "0")
    pattn.sdpa_cbl(q, k, v, 2)
    assert called[-1] == ("K3", 1)
    seen = []
    monkeypatch.setattr(pattn, "flash_attention_cbl", lambda *a: seen.append(1) or pfa.flash_attention_cbl(*a))
    q.requires_grad_(True)
    pattn.sdpa_cbl(q, k, v, 2).sum().backward()
    assert seen == [1] and q.grad is not None and len(called) == 2


# a C parameter's type as the ctypes argtype that passes it
_C_TYPES = {"void*": pfa._P, "long long*": pfa._P, "int": pfa._I, "float": pfa._F}


@pytest.mark.parametrize("name", sorted(pfa.ENTRY_SOURCE))
def test_cm_entry_points_live_in_their_twins_sources(name):
    """Each channel-major C entry point is in the source of its
    sequence-major twin (one nvcc a source, as before), takes what
    ``ARGTYPES`` passes, and is loaded from that source's library."""
    source = pfa.ENTRY_SOURCE[name]
    assert source in pfa.SOURCES and name not in pfa.SOURCES
    code = re.sub(r"//[^\n]*", "", (pfa.CSRC / f"{source}.cu").read_text())
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', code).group(1).split(",")
    types = [re.sub(r"\s*\*\s*", "*", re.sub(r"\s*\w+$", "", re.sub(r"\bconst\b", "", p).strip())).strip()
             for p in params]
    assert [_C_TYPES[t] for t in types] == pfa.ARGTYPES[name]
