"""The port's CLIP vision tower and projected text tower (models/clip.py)
and its CLIP loaders (utils/weights.py) held to the JAX package on the CPU
in float32: ``CLIPVisionModel`` at its native grid and at interpolated
grids (as tests/test_clip_vision_parity.py), ``_torch_bicubic_matrix``
(rtol 1e-6) and torch's own bicubic interpolation, the text tower with its
EOS pooling and projection, and ``load_clip_dir`` on a tiny CLIPModel dir
read by both packages.

Tower outputs are held to rtol 1e-3, atol 2e-4, the UNet tests'
framework-to-framework bound (tests/test_torch_port_models.py).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffmining_tpu.models import clip as jclip
from diffmining_tpu.utils.weights import load_clip_dir as jload_clip_dir

from diffmining_tpu_torch.models import clip as pclip
from diffmining_tpu_torch.utils.weights import load_clip_dir, load_state, params_from_jax, write_safetensors

torch.set_num_threads(1)
TOL = dict(rtol=1e-3, atol=2e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def towers():
    vision = jclip.CLIPVisionModel(jclip.TINY_CLIP_VISION)
    vp = vision.init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)))
    text = jclip.CLIPTextModelWithProjection(jclip.TINY_CLIP_TEXT, projection_dim=16)
    tp = text.init(jax.random.PRNGKey(2), jnp.zeros((1, 77), jnp.int32))
    pv = pclip.CLIPVisionModel(pclip.TINY_CLIP_VISION).eval()
    load_state(pv, params_from_jax(_np(vp), "clip_vision"))
    pt = pclip.CLIPTextModelWithProjection(pclip.TINY_CLIP_TEXT, projection_dim=16).eval()
    load_state(pt, params_from_jax(_np(tp), "clip_text_projection"))
    return vision, vp, text, tp, pv, pt


def test_configs_match_jax():
    for name in ("CLIP_VIT_L_VISION_336", "TINY_CLIP_VISION"):
        assert dataclasses_equal(getattr(pclip, name), getattr(jclip, name))
    b32 = pclip.CLIP_VIT_B32_VISION
    assert (b32.image_size, b32.patch_size, b32.hidden_size, b32.num_layers, b32.num_heads, b32.projection_dim) == (
        224, 32, 768, 12, 12, 512)


def dataclasses_equal(a, b):
    import dataclasses

    return dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("n_in,n_out", [(8, 8), (8, 12), (24, 32), (7, 10), (8, 5)])
def test_bicubic_matrix_matches_jax_and_torch(n_in, n_out):
    got = pclip._torch_bicubic_matrix(n_in, n_out)
    np.testing.assert_allclose(got, np.asarray(jclip._torch_bicubic_matrix(n_in, n_out)), rtol=1e-6, atol=0)
    x = torch.randn(1, 3, n_in, n_in, generator=torch.Generator().manual_seed(n_in))
    want = F.interpolate(x, size=(n_out, n_out), mode="bicubic", align_corners=False)
    w = torch.from_numpy(got)
    torch.testing.assert_close(torch.einsum("ij,bcjk,lk->bcil", w, x, w), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h,w", [(64, 64), (96, 96), (48, 80)])
def test_vision_tower_matches_jax(towers, h, w):
    """(pooled, tokens) at the native 8x8 grid, a larger square grid and a
    non-square one (position embeddings interpolated)."""
    vision, vp, _, _, pv, _ = towers
    x = np.random.RandomState(h + w).randn(2, h, w, 3).astype(np.float32)
    want_pooled, want_tokens = vision.apply(vp, jnp.asarray(x))
    with torch.no_grad():
        pooled, tokens = pv(_t(x.transpose(0, 3, 1, 2)))
    assert tokens.shape == (2, (h // 8) * (w // 8), 16) and pooled.shape == (2, 16)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled), **TOL)
    np.testing.assert_allclose(tokens.numpy(), np.asarray(want_tokens), **TOL)


@pytest.mark.parametrize("eos", [None, 999])
def test_text_tower_with_projection_matches_jax(towers, eos):
    """The hidden states and the projected EOS-pooled embedding; with no EOS
    token in the ids both pool position 0."""
    _, _, text, tp, _, pt = towers
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 998, (3, 77)).astype(np.int32)
    kw = {}
    if eos is not None:
        for row, pos in enumerate((5, 30, 76)):
            ids[row, pos] = eos
            ids[row, pos + 1:] = eos if row == 1 else ids[row, pos + 1:]
        kw = {"eos_token_id": eos}
    want_hidden, want_pooled = text.apply(tp, jnp.asarray(ids), **kw)
    with torch.no_grad():
        hidden, pooled = pt(_t(ids).long(), **kw)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(want_hidden), **TOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled), **TOL)
    assert set(pt.state_dict()) >= {"text_projection.weight", "text_model.final_layer_norm.weight"}


def test_load_clip_dir_reads_what_jax_reads(towers, tmp_path):
    """A tiny CLIPModel dir (transformers keys, one safetensors file and a
    CLIPConfig json with a position_ids buffer as transformers writes it):
    the port's load_clip_dir and JAX's read the same towers."""
    vision, vp, text, tp, pv, pt = towers
    d = str(tmp_path / "clip")
    os.makedirs(d)
    tensors = {k: v.numpy() for k, v in {**pv.state_dict(), **pt.state_dict()}.items()}
    tensors["vision_model.embeddings.position_ids"] = np.arange(65, dtype=np.int64)[None]
    write_safetensors(os.path.join(d, "model.safetensors"), tensors)
    tv, tt = pclip.TINY_CLIP_VISION, pclip.TINY_CLIP_TEXT
    cfg = {"projection_dim": 16,
           "vision_config": {"image_size": tv.image_size, "patch_size": tv.patch_size, "hidden_size": tv.hidden_size,
                             "intermediate_size": tv.intermediate_size, "num_hidden_layers": tv.num_layers,
                             "num_attention_heads": tv.num_heads},
           "text_config": {"vocab_size": tt.vocab_size, "hidden_size": tt.hidden_size,
                           "intermediate_size": tt.intermediate_size, "num_hidden_layers": tt.num_layers,
                           "num_attention_heads": tt.num_heads}}
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)
    got, want = load_clip_dir(d), jload_clip_dir(d)
    assert got["vision"]["config"] == pclip.TINY_CLIP_VISION and got["text"]["projection_dim"] == 16
    assert got["tokenizer_dir"] == want["tokenizer_dir"] == d
    pv2 = pclip.CLIPVisionModel(got["vision"]["config"]).eval()
    load_state(pv2, got["vision"]["state_dict"])
    pt2 = pclip.CLIPTextModelWithProjection(got["text"]["config"], got["text"]["projection_dim"]).eval()
    load_state(pt2, got["text"]["state_dict"])
    jv = jclip.CLIPVisionModel(want["vision"]["config"])
    jt = jclip.CLIPTextModelWithProjection(want["text"]["config"], projection_dim=want["text"]["projection_dim"])
    x = np.random.RandomState(5).randn(1, 64, 64, 3).astype(np.float32)
    ids = np.random.RandomState(6).randint(0, 998, (2, 77)).astype(np.int32)
    with torch.no_grad():
        pooled, tokens = pv2(_t(x.transpose(0, 3, 1, 2)))
        _, tpooled = pt2(_t(ids).long())
    wp, wt = jv.apply({"params": want["vision"]["params"]}, jnp.asarray(x))
    _, wtp = jt.apply({"params": want["text"]["params"]}, jnp.asarray(ids))
    np.testing.assert_allclose(pooled.numpy(), np.asarray(wp), **TOL)
    np.testing.assert_allclose(tokens.numpy(), np.asarray(wt), **TOL)
    np.testing.assert_allclose(tpooled.numpy(), np.asarray(wtp), **TOL)
