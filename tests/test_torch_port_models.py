"""The port's UNet at transformer depth 2, VAE encoder, CLIP text encoder
and tokenizer, held to the JAX package on the CPU in float32.

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

from diffmining_tpu.models.clip import TINY_CLIP_TEXT as J_TINY_CLIP
from diffmining_tpu.models.clip import CLIPTextModel as JCLIP
from diffmining_tpu.models.tokenizer import CLIPTokenizer as JTokenizer
from diffmining_tpu.models.tokenizer import bytes_to_unicode
from diffmining_tpu.models.tokenizer import tiny_tokenizer as j_tiny_tokenizer
from diffmining_tpu.models.unet import UNet2DCondition as JUNet
from diffmining_tpu.models.unet import UNetConfig as JUNetConfig
from diffmining_tpu.models.vae import TINY_VAE as J_TINY_VAE
from diffmining_tpu.models.vae import AutoencoderKL as JVAE

from diffmining_tpu_torch.models.clip import TINY_CLIP_TEXT, CLIPTextModel
from diffmining_tpu_torch.models.tokenizer import CLIPTokenizer, tiny_tokenizer
from diffmining_tpu_torch.models.unet import UNet2DCondition, UNetConfig
from diffmining_tpu_torch.models.vae import DECODER_PREFIXES, TINY_VAE, AutoencoderKL
from diffmining_tpu_torch.utils.weights import load_state, params_from_jax

torch.set_num_threads(1)
TOL = dict(rtol=1e-3, atol=2e-4)

DEPTH2 = dict(
    block_out_channels=(32, 64, 64), layers_per_block=2, cross_attention_dim=32,
    num_attention_heads=4, down_block_has_attn=(True, True, False), norm_num_groups=8,
    transformer_layers=2,
)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _unet_pair(jcfg, pcfg, seed):
    junet = JUNet(jcfg, dtype=jnp.float32)
    params = junet.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8, 8, jcfg.in_channels)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 7, jcfg.cross_attention_dim)),
    )
    punet = UNet2DCondition(pcfg).eval()
    load_state(punet, params_from_jax(_np_tree(params), "unet"))
    return junet, params, punet


def test_unet_depth2_transformer_matches_jax():
    """transformer_layers=2, three levels, four heads: the depth plumbing and
    the per-level head dims."""
    junet, params, punet = _unet_pair(JUNetConfig(**DEPTH2), UNetConfig(**DEPTH2), 2)
    rng = np.random.RandomState(7)
    x = rng.randn(1, 4, 16, 16).astype(np.float32)
    ctx = rng.randn(1, 77, 32).astype(np.float32)
    want = np.asarray(junet.apply(params, jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray([261], jnp.int32),
                                  jnp.asarray(ctx)))
    with torch.no_grad():
        got = punet(torch.from_numpy(x), torch.tensor([261]), torch.from_numpy(ctx)).numpy()
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), **TOL)


@pytest.mark.parametrize("hw", [(16, 16), (17, 15)])
def test_vae_encode_matches_jax(hw):
    """Posterior mean and clamped logvar on TINY_VAE, including an odd size
    (the asymmetric downsample pad); the decoder's tensors are set aside."""
    jvae = JVAE(J_TINY_VAE, dtype=jnp.float32)
    params = jvae.init(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3)), method=JVAE.encode_decode)
    state = params_from_jax(_np_tree(params), "vae")
    assert any(k.startswith(DECODER_PREFIXES) for k in state)
    pvae = AutoencoderKL(TINY_VAE).eval()
    load_state(pvae, state, ignore_prefixes=DECODER_PREFIXES)
    x = np.random.RandomState(3).randn(2, 3, *hw).astype(np.float32)
    mean, logvar = jvae.apply(params, jnp.asarray(x.transpose(0, 2, 3, 1)), method=JVAE.encode)
    with torch.no_grad():
        pm, plv = pvae.encode(torch.from_numpy(x))
    np.testing.assert_allclose(pm.numpy(), np.asarray(mean).transpose(0, 3, 1, 2), **TOL)
    np.testing.assert_allclose(plv.numpy(), np.asarray(logvar).transpose(0, 3, 1, 2), **TOL)


def test_clip_text_matches_jax():
    """last_hidden_state after the final LN, causal mask, on TINY_CLIP_TEXT."""
    jclip = JCLIP(J_TINY_CLIP, dtype=jnp.float32)
    params = jclip.init(jax.random.PRNGKey(2), jnp.zeros((1, 77), jnp.int32))
    pclip = CLIPTextModel(TINY_CLIP_TEXT).eval()
    load_state(pclip, params_from_jax(_np_tree(params), "clip_text"))
    ids = tiny_tokenizer(TINY_CLIP_TEXT.vocab_size)(["Portrait at the 1920's.", "Portrait."])
    want = np.asarray(jclip.apply(params, jnp.asarray(ids)))
    with torch.no_grad():
        got = pclip(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, **TOL)


PROMPTS = ["Portrait at the 1920's.", "A car at the 1960's.", "Image of  a  beach!", "", "naïve café 123"]


def test_tiny_tokenizer_ids_identical():
    want = j_tiny_tokenizer(1000)(PROMPTS)
    got = tiny_tokenizer(1000)(PROMPTS)
    np.testing.assert_array_equal(got, want)


def test_bpe_tokenizer_ids_identical():
    """A vocabulary with merges exercises the BPE loop on both copies."""
    vocab = {}
    for ch in bytes_to_unicode().values():
        vocab[ch] = len(vocab)
        vocab[ch + "</w>"] = len(vocab)
    merges = [("p", "o"), ("po", "r"), ("t", "r"), ("a", "i"), ("i", "t</w>"), ("a", "t</w>"), ("c", "a")]
    for a, b in merges:
        vocab[a + b] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    want = JTokenizer(dict(vocab), list(merges))(PROMPTS)
    got = CLIPTokenizer(dict(vocab), list(merges))(PROMPTS)
    np.testing.assert_array_equal(got, want)
