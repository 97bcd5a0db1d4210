"""The port's UNet (eps path and the ctx_tile prefix dedup) on TINY_UNET,
held to the JAX package on the CPU in float32.

JAX parameters are initialised from a seed and carried into the port with
``params_from_jax``; the same numpy inputs go through both. Tolerance
rtol=1e-3, atol=2e-4 is the bound test_torch_transcription_parity.py uses for
the same framework-to-framework comparison (convolution and matmul
summation orders differ).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmining_tpu.models.unet import TINY_UNET as J_TINY_UNET
from diffmining_tpu.models.unet import UNet2DCondition as JUNet

from diffmining_tpu_torch.models.unet import TINY_UNET, UNet2DCondition
from diffmining_tpu_torch.utils.weights import load_state, params_from_jax

torch.set_num_threads(1)
TOL = dict(rtol=1e-3, atol=2e-4)


@pytest.fixture(scope="module")
def tiny_unet():
    junet = JUNet(J_TINY_UNET, dtype=jnp.float32)
    params = junet.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 7, 32))
    )
    punet = UNet2DCondition(TINY_UNET).eval()
    load_state(punet, params_from_jax(jax.tree_util.tree_map(np.asarray, params), "unet"))
    return junet, params, punet


@pytest.mark.parametrize("hw", [(16, 16), (14, 10)])
def test_unet_matches_jax(tiny_unet, hw):
    """Eps prediction at a power-of-two size and at one where the upsampler
    sizes itself to the skip (7x5 -> 14x10)."""
    junet, params, punet = tiny_unet
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, *hw).astype(np.float32)
    ctx = rng.randn(2, 77, 32).astype(np.float32)
    t = np.array([261, 700], np.int32)
    want = np.asarray(junet.apply(params, jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(t), jnp.asarray(ctx)))
    with torch.no_grad():
        got = punet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx)).numpy()
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), **TOL)


def test_unet_dedup_matches_jax_and_untiled(tiny_unet):
    """ctx_tile=2: the prefix runs at batch B and tiles at the first cross-
    attention — equal to the JAX dedup path, and to the untiled batch."""
    junet, params, punet = tiny_unet
    rng = np.random.RandomState(1)
    x = rng.randn(2, 4, 16, 16).astype(np.float32)
    ctx = rng.randn(4, 77, 32).astype(np.float32)
    t = np.array([100, 900], np.int32)
    want = np.asarray(junet.apply(params, jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(t),
                                  jnp.asarray(ctx), ctx_tile=2))
    with torch.no_grad():
        tiled = punet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), ctx_tile=2).numpy()
        untiled = punet(torch.from_numpy(np.repeat(x, 2, 0)), torch.from_numpy(np.repeat(t, 2)),
                        torch.from_numpy(ctx)).numpy()
    np.testing.assert_allclose(tiled, want.transpose(0, 3, 1, 2), **TOL)
    np.testing.assert_allclose(tiled, untiled, rtol=1e-5, atol=1e-5)


def test_params_from_jax_fill_every_port_parameter(tiny_unet):
    """The carried state dict covers exactly the port module's keys, with
    the module's shapes."""
    _, params, punet = tiny_unet
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params), "unet")
    own = punet.state_dict()
    assert set(state) == set(own)
    assert all(tuple(state[k].shape) == tuple(own[k].shape) for k in own)
