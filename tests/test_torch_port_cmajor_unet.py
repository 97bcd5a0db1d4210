"""The port's UNet in the channel-major transformer world
(DIFFMINING_TF_CMAJOR=1) held to the JAX package on the CPU, in float32.

TINY_UNET's eps in the channel-major world against JAX's channel-major
world (rtol 1e-4, atol 1e-5, the bound of JAX tests/test_models.py:142-153)
and against the port's normal world; the switch read per call and the
fused norm winning over it; ``ctx_tile`` against up-front tiling; taps
collected in one world and injected in the other; a LoRA-attached UNet in
both worlds. The JAX UNet runs under jit (a fresh function for each world:
the switch is read while it traces).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmining_tpu.models.unet import TINY_UNET as J_TINY_UNET
from diffmining_tpu.models.unet import UNet2DCondition as JUNet

from diffmining_tpu_torch.finetuning import lora as plora
from diffmining_tpu_torch.models.unet import TINY_UNET, UNet2DCondition
from diffmining_tpu_torch.utils.weights import load_state, params_from_jax

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny_unet():
    junet = JUNet(J_TINY_UNET, dtype=jnp.float32)
    params = jax.jit(junet.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
                                 jnp.zeros((1, 7, 32)))
    punet = UNet2DCondition(TINY_UNET).eval()
    load_state(punet, params_from_jax(jax.tree_util.tree_map(np.asarray, params), "unet"))
    return junet, params, punet


def _inputs(seed, b=2, hw=(16, 16), n_ctx=None):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, 4, *hw).astype(np.float32)
    ctx = rng.randn(n_ctx or b, 77, 32).astype(np.float32)
    t = np.array([261, 700][:b], np.int32)
    return x, t, ctx


def _jax_eps(junet, params, x, t, ctx):
    apply = jax.jit(lambda p, x, t, c: junet.apply(p, x, t, c))  # traced now, in the current world
    return np.asarray(apply(params, jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(t),
                            jnp.asarray(ctx))).transpose(0, 3, 1, 2)


def _port_eps(punet, x, t, ctx, **kw):
    with torch.no_grad():
        return punet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), **kw)


def test_cmajor_unet_matches_jax_cmajor_and_the_normal_world(tiny_unet, monkeypatch):
    """TINY_UNET under DIFFMINING_TF_CMAJOR=1 against JAX's channel-major
    UNet (rtol 1e-4, atol 1e-5, JAX tests/test_models.py:142-153) and
    against the port's own normal world; no attention of the pass takes the
    normal world's sdpa. At 14 x 10 too (the upsampler sizes itself to the
    skip), against the normal world."""
    import diffmining_tpu_torch.models.unet as punet_mod

    junet, params, punet = tiny_unet
    x, t, ctx = _inputs(0)
    normal = _port_eps(punet, x, t, ctx).numpy()
    x2, t2, ctx2 = _inputs(7, hw=(14, 10))
    normal2 = _port_eps(punet, x2, t2, ctx2).numpy()
    monkeypatch.setenv("DIFFMINING_TF_CMAJOR", "1")
    want = _jax_eps(junet, params, x, t, ctx)
    calls = []
    monkeypatch.setattr(punet_mod, "sdpa", lambda *a, **k: calls.append("sdpa"))
    got = _port_eps(punet, x, t, ctx).numpy()
    got2 = _port_eps(punet, x2, t2, ctx2).numpy()
    assert not calls
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, normal, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got2, normal2, rtol=1e-4, atol=1e-5)


def test_cmajor_reads_the_switch_per_call_and_yields_to_the_fused_norm(tiny_unet, monkeypatch):
    """The switch is read at each Transformer2DModel call; the fused norm
    wins over it, as in JAX (unet.py:409)."""
    import diffmining_tpu_torch.models.unet as punet_mod

    _, _, punet = tiny_unet
    x, t, ctx = _inputs(1)
    hits = []
    orig = punet_mod.sdpa_cbl
    monkeypatch.setattr(punet_mod, "sdpa_cbl", lambda *a, **k: hits.append(1) or orig(*a, **k))
    monkeypatch.setenv("DIFFMINING_TF_CMAJOR", "1")
    _port_eps(punet, x, t, ctx)
    assert len(hits) == 2 * 4  # two attentions in each of TINY_UNET's four transformers
    monkeypatch.setenv("DIFFMINING_TF_CMAJOR", "0")
    _port_eps(punet, x, t, ctx)
    assert len(hits) == 8
    monkeypatch.setenv("DIFFMINING_TF_CMAJOR", "1")
    tf = punet.down_blocks[0].attentions[0]
    monkeypatch.setattr(punet_mod, "gn_act_proj", lambda *a, **k: (_ for _ in ()).throw(StopIteration("fused")))
    with pytest.raises(StopIteration, match="fused"):
        with torch.no_grad():
            tf(torch.zeros(1, 32, 4, 4), torch.zeros(1, 77, 32), fused_norm=True)
    assert len(hits) == 8


def test_cmajor_ctx_tile_matches_upfront_tiling(tiny_unet, monkeypatch):
    """The sweep's prefix dedup keeps its conditions-adjacent contract in the
    channel-major world (JAX tests/test_models.py:156-169)."""
    _, _, punet = tiny_unet
    x, t, ctx = _inputs(2, n_ctx=4)
    monkeypatch.setenv("DIFFMINING_TF_CMAJOR", "1")
    tiled = _port_eps(punet, x, t, ctx, ctx_tile=2).numpy()
    untiled = _port_eps(punet, np.repeat(x, 2, 0), np.repeat(t, 2), ctx).numpy()
    np.testing.assert_allclose(tiled, untiled, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("collect_in,inject_in", [("0", "1"), ("1", "0")])
def test_taps_cross_worlds(tiny_unet, monkeypatch, collect_in, inject_in):
    """Taps are collected in the canonical [B, H, L, D] in both worlds (equal
    to each other), and a tap collected in one world injects into the other
    as into its own (batch-1 values, gated and plain)."""
    _, _, punet = tiny_unet
    x, t, ctx = _inputs(3)
    src_x, src_t, src_ctx = _inputs(4, b=1)
    monkeypatch.setenv("DIFFMINING_TF_CMAJOR", collect_in)
    taps = _port_eps(punet, src_x, src_t, src_ctx, collect_injection=True)["taps"]
    monkeypatch.setenv("DIFFMINING_TF_CMAJOR", inject_in)
    other = _port_eps(punet, src_x, src_t, src_ctx, collect_injection=True)["taps"]
    assert set(taps) == set(other)
    for key in taps:
        assert taps[key].shape == other[key].shape
        np.testing.assert_allclose(taps[key].numpy(), other[key].numpy(), rtol=1e-4, atol=1e-5)
    attn = {k: v for k, v in taps.items() if ".attn1." in k}
    assert attn and all(v.ndim == 4 and v.shape[1] == 2 for v in attn.values())  # [B, H, L, D], H = 2
    inj = {**attn, "up.1.res.0": taps["up.1.res.0"]}
    inj_gated = {k: (v, torch.tensor(True)) for k, v in inj.items()}
    crossed = _port_eps(punet, x, t, ctx, injection=inj).numpy()
    crossed_gated = _port_eps(punet, x, t, ctx, injection=inj_gated).numpy()
    monkeypatch.setenv("DIFFMINING_TF_CMAJOR", collect_in)
    own = _port_eps(punet, x, t, ctx, injection=inj).numpy()
    np.testing.assert_allclose(crossed, own, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(crossed_gated, own, rtol=1e-4, atol=1e-5)
    assert np.abs(crossed - _port_eps(punet, x, t, ctx).numpy()).max() > 1e-3


def test_lora_unet_in_both_worlds(tiny_unet, monkeypatch):
    """LoRA factors merged in Attention's projections act alike in both
    worlds: eps and the factors' gradients agree."""
    _, _, base = tiny_unet
    punet = UNet2DCondition(TINY_UNET)
    punet.load_state_dict(base.state_dict())
    g = torch.Generator().manual_seed(0)
    factors = plora.init_lora_params(punet, 2, g)
    for f in factors.values():
        f["b"].normal_(0, 0.1, generator=g)  # b nonzero, so the factors move eps
        for p in f.values():
            p.requires_grad_(True)
    plora.attach(punet, factors)
    x, t, ctx = (torch.from_numpy(a) for a in _inputs(5))
    out = {}
    for world in ("0", "1"):
        monkeypatch.setenv("DIFFMINING_TF_CMAJOR", world)
        for f in factors.values():
            for p in f.values():
                p.grad = None
        eps = punet(x, t, ctx)
        eps.square().mean().backward()
        out[world] = (eps.detach().numpy(), {k: {n: p.grad.clone() for n, p in f.items()} for k, f in factors.items()})
    np.testing.assert_allclose(out["1"][0], out["0"][0], rtol=1e-4, atol=1e-5)
    for k in factors:
        for n in ("a", "b"):
            torch.testing.assert_close(out["1"][1][k][n], out["0"][1][k][n], rtol=1e-4, atol=1e-6)
    plora.attach(punet, {})
    monkeypatch.setenv("DIFFMINING_TF_CMAJOR", "1")
    with torch.no_grad():
        assert np.abs(punet(x, t, ctx).numpy() - out["1"][0]).max() > 1e-4
