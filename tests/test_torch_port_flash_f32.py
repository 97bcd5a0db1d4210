"""The float32 flash forwards of the CLIP vision towers, held to the JAX
package on the CPU.

The plain versions at float32 (``flash_fwd_online_plain``,
``flash_attention_nomax_plain``), which ``flash_fwd_f32``'s two modes repeat
and which chip_smoke.py holds the kernel to on the card, against the Pallas
``_flash_forward_t`` in interpret mode at head dim 64: the online mode (K3)
at L = 1025 (ViT-L/14 at a 448 px crop) with B·H = 2 under the default
block policy, and the no-max mode (K2) forced with 128-key blocks at L = 300,
whose last block has a masked tail. Both at rtol 1e-5, atol 1e-6: float32
throughout on both sides, so they differ by summation order only. The
routes: the JAX ``sdpa`` traces K3 at L = 1025 and K2 at L = 4097 for a
float32 tower's self-attention, and the port's ``forward_route`` picks the
same. A float32 tower on the CPU at crop 448 takes the plain attention (no
kernel, no library), and the wrappers keep CPU tensors off the kernel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import diffmining_tpu.ops.attention as jattn
import diffmining_tpu.ops.flash_attention as jfa

from diffmining_tpu_torch.models import clip as pclip
from diffmining_tpu_torch.ops import attention as pattn
from diffmining_tpu_torch.ops import flash_attention as pfa

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _qkv(b, h, lq, lk, d, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, h, n, d).astype(np.float32) for n in (lq, lk, lk))


def _jax_t(q, k, v, **kw):
    tr = lambda a: jnp.asarray(a.transpose(0, 1, 3, 2))  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        o = jfa._flash_forward_t(tr(q), tr(k), tr(v), **kw)
    return np.asarray(o).transpose(0, 1, 3, 2)


def test_online_f32_matches_jax_at_crop_448():
    """L = 1025, D = 64: the default block policy gives 1024-key blocks, a
    2048-wide padded key row, so JAX runs K3 over two blocks, the second
    with one open key."""
    q, k, v = _qkv(1, 2, 1025, 1025, 64, seed=0)
    assert pfa.forward_route(1025, 1025) == "K3"
    want = _jax_t(q, k, v)
    got = pfa.flash_fwd_online_plain(_t(q), _t(k), _t(v))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("block_k", [128, 64])
def test_online_f32_does_not_depend_on_the_key_tile(block_k):
    """The CUDA kernel keeps its running max per 64-key tile; in float32 the
    tile moves only roundings, so the plain version at any tile agrees with
    the TPU block's."""
    q, k, v = _qkv(1, 2, 1025, 1025, 64, seed=1)
    ref = pfa.flash_fwd_online_plain(_t(q), _t(k), _t(v)).numpy()
    got = pfa.flash_fwd_online_plain(_t(q), _t(k), _t(v), block_k=block_k).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_nomax_f32_matches_jax_with_a_masked_tail():
    """K2 forced at L = 300 with 128-key blocks: three blocks, the last with
    84 open keys of 128."""
    q, k, v = _qkv(1, 2, 300, 300, 64, seed=2)
    want = _jax_t(q, k, v, block_q=128, block_k=128, oneshot=False, nomax=True)
    got = pfa.flash_attention_nomax_plain(_t(q), _t(k), _t(v))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_nomax_f32_matches_jax_one_shot():
    """K1 (the key row in one block) is the same no-max arithmetic."""
    q, k, v = _qkv(2, 1, 200, 200, 64, seed=3)
    want = _jax_t(q, k, v, oneshot=True)
    np.testing.assert_allclose(pfa.flash_attention_nomax_plain(_t(q), _t(k), _t(v)).numpy(), want, **TOL)


JAX_KERNELS = {"_flash_kernel_t_1shot": "K1", "_flash_kernel_t_nomax": "K2", "_flash_kernel_t": "K3",
               "_flash_kernel": "K4"}


@pytest.mark.parametrize("crop,want", [(448, "K3"), (896, "K2")])
def test_tower_route_matches_jax(monkeypatch, crop, want):
    """ViT-L/14's self-attention at a crop: L = (crop/14)^2 + 1, D = 64,
    float32. The JAX sdpa (abstract evaluation, a spy on each Pallas
    kernel) and the port's route agree."""
    lq = (crop // 14) ** 2 + 1
    hits = []
    for name in JAX_KERNELS:
        orig = getattr(jfa, name)
        monkeypatch.setattr(jfa, name, lambda *a, _n=name, _o=orig, **kw: hits.append(_n) or _o(*a, **kw))
    monkeypatch.setattr(jattn, "_DEFAULT_BACKEND", "pallas")
    s = jax.ShapeDtypeStruct((1, 16, lq, 64), jnp.float32)
    jax.eval_shape(lambda q, k, v: jattn.sdpa(q, k, v), s, s, s)
    assert {JAX_KERNELS[h] for h in hits} == {want}
    assert pfa.forward_route(lq, lq) == want
    assert pattn.use_kernel((1, 16, lq, 64), (1, 16, lq, 64), False, torch.device("cuda"))
    assert pattn.FORWARD[want] is (pfa.flash_fwd_online if want == "K3" else pfa.flash_fwd_nomax)


def test_cpu_tower_at_crop_448_takes_the_plain_path(monkeypatch):
    """A float32 vision tower on the CPU at crop 448 (L = 1025, D = 64)
    computes every attention with sdpa_plain: no wrapper and no kernel."""

    def no_kernel(*a, **k):
        raise AssertionError("a CPU tower must not reach a flash wrapper")

    for key in list(pattn.FORWARD):
        monkeypatch.setitem(pattn.FORWARD, key, no_kernel)
    monkeypatch.setattr(pattn, "flash_attention", no_kernel)
    monkeypatch.setattr(pfa, "_library", no_kernel)
    calls = []
    plain = pattn.sdpa_plain
    monkeypatch.setattr(pattn, "sdpa_plain", lambda *a, **k: calls.append(a[0].shape) or plain(*a, **k))
    cfg = pclip.CLIPVisionConfig(image_size=224, patch_size=14, hidden_size=64, intermediate_size=64, num_layers=2,
                                 num_heads=1, projection_dim=16)
    torch.manual_seed(0)
    tower = pclip.CLIPVisionModel(cfg).eval()
    x = torch.from_numpy(np.random.RandomState(4).randn(1, 3, 448, 448).astype(np.float32))
    with torch.no_grad():
        pooled, tokens = tower(x)
    assert calls == [(1, 1, 1025, 64)] * 2
    assert torch.isfinite(pooled).all() and torch.isfinite(tokens).all()


def test_f32_wrappers_keep_cpu_tensors_off_the_kernel(monkeypatch):
    def no_library(*a, **k):
        raise AssertionError("CPU tensors must not reach the CUDA kernel")

    monkeypatch.setattr(pfa, "_library", no_library)
    q, k, v = (_t(a) for a in _qkv(1, 2, 300, 300, 64, seed=5))
    before = (pfa.flash_fwd_online_f32.launches, pfa.flash_fwd_nomax_f32.launches)
    torch.testing.assert_close(pfa.flash_fwd_online(q, k, v), pfa.flash_fwd_online_plain(q, k, v), rtol=0, atol=0)
    torch.testing.assert_close(pfa.flash_fwd_nomax(q, k, v), pfa.flash_attention_nomax_plain(q, k, v), rtol=0, atol=0)
    assert (pfa.flash_fwd_online_f32.launches, pfa.flash_fwd_nomax_f32.launches) == before
    assert 64 in pfa.F32_HEAD_DIMS and 64 not in pfa.HEAD_DIMS
    assert "flash_fwd_f32" in pfa.SOURCES and (pfa.CSRC / "flash_fwd_f32.cu").is_file()
