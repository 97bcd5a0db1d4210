"""The port's fused GroupNorm → proj_in (K7) held to the JAX package on the
CPU: ``gn_act_proj_plain`` (the CUDA kernel's arithmetic) against the Pallas
``gn_act_proj`` in interpret mode and the reference chain
``gn_act_proj_xla``; the fused TINY UNet against JAX's fused TINY UNet; the
SD bundle's gate; the wrapper's refusals.

fp32 agrees to rtol 1e-5 (summation order only). In bf16 both round h to
bf16 at the same point and the product's fp32 sum to bf16, then add the
bias in bf16: a sum that lands on the other side of a rounding boundary
flips one bf16 ulp of the product, |jax - bias|, which the bias can cancel
down to a smaller result. The bound is chip_smoke.py's for K7, one ulp of
the product and one of the result, |port - jax| <= 2^-7 (|jax| + |jax -
bias|) + 2^-7 rms(jax); a kernel that skips one 32-channel chunk of the
input is far outside it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from diffmining_tpu.models.unet import TINY_UNET as J_TINY_UNET
from diffmining_tpu.models.unet import UNet2DCondition as JUNet
from diffmining_tpu.ops import fused_norm as jfn

from diffmining_tpu_torch.models.unet import TINY_UNET, UNet2DCondition
from diffmining_tpu_torch.ops import flash_attention as pfa
from diffmining_tpu_torch.ops import fused_norm as pfn
from diffmining_tpu_torch.typicality.compute import SD, fused_norm_gate
from diffmining_tpu_torch.utils.export import unet_config_to_json
from diffmining_tpu_torch.utils.weights import load_state, params_from_jax, unet_config_from_json

torch.set_num_threads(1)
ULP = 2.0**-7


def _over_bound(got, want, bias):
    w = np.asarray(want, np.float32)
    tol = ULP * (np.abs(w) + np.abs(w - np.asarray(bias, np.float32))) + ULP * np.sqrt(np.mean(w**2))
    return float(np.max(np.abs(np.asarray(got, np.float32) - w) / tol))


def _operands(b, hh, ww, c, cout, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, hh, ww, c) * 2.0 + 0.5).astype(np.float32)
    gamma = (1.0 + 0.3 * rng.randn(c)).astype(np.float32)
    beta = (0.3 * rng.randn(c)).astype(np.float32)
    w = (rng.randn(c, cout) / np.sqrt(c)).astype(np.float32)
    bias = (0.5 * rng.randn(cout)).astype(np.float32)
    return x, gamma, beta, w, bias


def _jax(fn, ops, groups, act, dtype=jnp.float32):
    with pltpu.force_tpu_interpret_mode():
        out = fn(*(jnp.asarray(a, dtype) for a in ops), groups, eps=1e-6, act=act)
    return np.asarray(out.astype(jnp.float32))


def _port(fn, ops, groups, act, dtype=torch.float32):
    out = fn(*(torch.from_numpy(a).to(dtype) for a in ops), groups, eps=1e-6, act=act)
    return out.float().numpy()


@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("groups", [8, 32])
def test_plain_matches_jax_fp32(act, groups):
    """N = 20x30 = 600 rows, not a multiple of the Pallas kernel's 512-row
    blocks (a padded tail); C 64 in 8 or 32 groups."""
    ops = _operands(2, 20, 30, 64, 96, seed=groups)
    got = _port(pfn.gn_act_proj_plain, ops, groups, act)
    want = _jax(jfn.gn_act_proj, ops, groups, act)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    chain = _jax(jfn.gn_act_proj_xla, ops, groups, act).reshape(got.shape)
    np.testing.assert_allclose(got, chain, rtol=1e-5, atol=1e-5)
    port_chain = _port(pfn.gn_act_proj_xla, ops, groups, act).reshape(got.shape)
    np.testing.assert_allclose(port_chain, chain, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", ["none", "silu"])
def test_plain_rounds_where_jax_does_bf16(act):
    """bf16 operands: h rounded to bf16 before the product, the product's
    fp32 sum rounded to bf16, the bias added in bf16, as the Pallas kernel
    and its caller do."""
    ops = _operands(2, 20, 30, 64, 96, seed=7)
    ops = tuple(np.asarray(torch.from_numpy(a).to(torch.bfloat16).float()) for a in ops)
    got = _port(pfn.gn_act_proj_plain, ops, 32, act, torch.bfloat16)
    want = _jax(jfn.gn_act_proj, ops, 32, act, jnp.bfloat16)
    assert _over_bound(got, want, ops[4]) <= 1.0
    assert np.mean(got == want) > 0.97


def test_bound_catches_a_skipped_chunk():
    """A kernel that skipped one 32-channel chunk of the input (of 320, the
    512px level-0 width) lands far outside the bound; so does one that left
    a 160-wide Cout tile of every block unwritten (the kernel's tiling,
    ``gn_act_proj_tiled``)."""
    ops = _operands(1, 16, 16, 320, 64, seed=3)
    ops = tuple(torch.from_numpy(a).to(torch.bfloat16) for a in ops)
    full = pfn.gn_act_proj_plain(*ops, 32)
    w_skip = ops[3].clone()
    w_skip[96:128] = 0
    skipped = pfn.gn_act_proj_plain(ops[0], ops[1], ops[2], w_skip, ops[4], 32)
    assert _over_bound(skipped.float().numpy(), full.float().numpy(), ops[4].float().numpy()) > 20.0
    ops = tuple(torch.from_numpy(a).to(torch.bfloat16) for a in _operands(1, 16, 16, 320, 320, seed=3))
    full = pfn.gn_act_proj_plain(*ops, 32)
    tiles = pfn.gn_act_proj_tiled(*ops, 32)
    assert _over_bound(tiles.float().numpy(), full.float().numpy(), ops[4].float().numpy()) <= 1.0
    skipped = pfn.gn_act_proj_tiled(*ops, 32, skip_tile=1)
    assert _over_bound(skipped.float().numpy(), full.float().numpy(), ops[4].float().numpy()) > 20.0


@pytest.fixture(scope="module")
def fused_unets():
    jcfg = dataclasses.replace(J_TINY_UNET, fused_norm=True)
    junet = JUNet(jcfg, dtype=jnp.float32)
    params = jax.jit(JUNet(J_TINY_UNET, dtype=jnp.float32).init)(
        jax.random.PRNGKey(4), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 7, 32))
    )
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params), "unet")
    punet = UNet2DCondition(dataclasses.replace(TINY_UNET, fused_norm=True)).eval()
    load_state(punet, state)
    return junet, params, punet, state


def test_fused_unet_matches_jax_fused_unet(fused_unets):
    """The fused TINY UNet (every transformer entry through gn_act_proj)
    against JAX's fused TINY UNet (Pallas in interpret mode), with the same
    state-dict keys as the module path; rtol 1e-3, atol 2e-4, the UNet
    tests' framework-to-framework bound."""
    junet, params, punet, state = fused_unets
    assert set(punet.state_dict()) == set(state) == set(UNet2DCondition(TINY_UNET).state_dict())
    rng = np.random.RandomState(5)
    x = rng.randn(2, 4, 16, 16).astype(np.float32)
    ctx = rng.randn(2, 77, 32).astype(np.float32)
    t = np.array([161, 700], np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(junet.apply(params, jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(t), jnp.asarray(ctx)))
    calls = []
    orig = pfn.gn_act_proj_plain

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    pfn.gn_act_proj_plain = counted
    try:
        with torch.no_grad():
            got = punet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx)).numpy()
    finally:
        pfn.gn_act_proj_plain = orig
    assert len(calls) == 4  # the TINY UNet's transformers: down 0, mid, up 1 (two)
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), rtol=1e-3, atol=2e-4)
    module = UNet2DCondition(TINY_UNET).eval()
    load_state(module, state)
    with torch.no_grad():
        base = module(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx)).numpy()
    np.testing.assert_allclose(got, base, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("env,device,want", [
    ("1", "cuda", True), ("0", "cuda", False), (None, "cuda", False), ("1", "cpu", False),
])
def test_sd_gate_is_cuda_only(monkeypatch, env, device, want):
    """DIFFMINING_FUSED_NORM other than "0" turns the fused entry on for a
    CUDA bundle only (the JAX bundle does so on the TPU only, default off)."""
    if env is None:
        monkeypatch.delenv("DIFFMINING_FUSED_NORM", raising=False)
    else:
        monkeypatch.setenv("DIFFMINING_FUSED_NORM", env)
    assert fused_norm_gate(torch.device(device)) is want


def test_cpu_bundle_keeps_the_module_path(monkeypatch):
    from diffmining_tpu_torch.models.clip import TINY_CLIP_TEXT
    from diffmining_tpu_torch.models.vae import TINY_VAE

    monkeypatch.setenv("DIFFMINING_FUSED_NORM", "1")
    sd = SD.init_random("ftt", ["1930"], TINY_UNET, TINY_VAE, TINY_CLIP_TEXT, dtype=torch.float32, device="cpu")
    assert sd.unet.config.fused_norm is False


def test_config_json_keeps_fused_norm_off():
    """The flag is a runtime mode, not part of a checkpoint: the JSON has no
    field for it and reads back off."""
    cfg = unet_config_from_json(unet_config_to_json(dataclasses.replace(TINY_UNET, fused_norm=True)))
    assert cfg.fused_norm is False and dataclasses.replace(cfg, fused_norm=False) == TINY_UNET


def test_wrapper_raises_under_grad(fused_unets):
    """K7 is forward only, as in JAX: the wrapper raises when grad mode is
    on and an input requires grad, and so does the fused UNet's forward."""
    ops = [torch.from_numpy(a) for a in _operands(1, 4, 4, 64, 64, seed=1)]
    ops[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        pfn.gn_act_proj(*ops, 32)
    with torch.no_grad():
        pfn.gn_act_proj(*ops, 32)
    _, _, punet, _ = fused_unets
    x = torch.zeros(1, 4, 8, 8)
    with pytest.raises(RuntimeError, match="no backward"):
        punet(x, torch.tensor([3]), torch.zeros(1, 7, 32))


def test_kernel_strides_take_both_unet_layouts():
    """The kernel reads x in place as NCHW viewed as NHWC (pixels
    contiguous) or channels-last (channels contiguous); anything else
    raises before a launch."""
    x = torch.zeros(2, 64, 5, 7)
    assert pfn.kernel_strides(x.permute(0, 2, 3, 1)) == (64 * 35, 1, 35)
    cl = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    assert pfn.kernel_strides(cl) == (64 * 35, 64, 1)
    with pytest.raises(ValueError, match="channels-last"):
        pfn.kernel_strides(x.permute(0, 3, 2, 1))  # W and H swapped: the pixels are no one axis
    with pytest.raises(ValueError, match="channels-last"):
        pfn.kernel_strides(torch.zeros(2, 5, 7, 128)[..., ::2])  # neither pixels nor channels contiguous


def test_fused_unet_hands_the_kernel_layouts_it_takes(fused_unets):
    """Every fused transformer entry of a UNet pass gets an x the kernel
    reads in place: the first NCHW, those after a transformer's proj_out
    channels-last."""
    _, _, punet, _ = fused_unets
    from diffmining_tpu_torch.models import unet as unet_mod

    seen = []
    orig = unet_mod.gn_act_proj

    def spy(x, *a, **k):
        seen.append(pfn.kernel_strides(x)[1:])
        return orig(x, *a, **k)

    unet_mod.gn_act_proj = spy
    try:
        with torch.no_grad():
            punet(torch.zeros(2, 4, 16, 16), torch.tensor([3, 3]), torch.zeros(2, 7, 32))
    finally:
        unet_mod.gn_act_proj = orig
    assert len(seen) == 4 and {sn == 1 for sn, _ in seen} == {True, False}


def test_cpu_tensor_never_reaches_the_kernel(monkeypatch):
    def no_library(*a, **k):
        raise AssertionError("CPU tensors must not reach the CUDA kernel")

    monkeypatch.setattr(pfa, "_library", no_library)
    monkeypatch.setattr(pfa, "build", no_library)
    before = pfn.gn_act_proj.launches
    ops = tuple(torch.from_numpy(a).to(torch.bfloat16) for a in _operands(1, 8, 8, 64, 64, seed=2))
    out = pfn.gn_act_proj(*ops, 32)
    assert pfn.gn_act_proj.launches == before
    torch.testing.assert_close(out, pfn.gn_act_proj_plain(*ops, 32), rtol=0, atol=0)
