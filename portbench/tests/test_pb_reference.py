"""Each plain reference against the program at tiny widths, on the CPU, with
the same seeded weights (float32 on both sides)."""
import numpy as np
import pytest
import torch

from portbench import weights
from portbench.entries.common import port_module, ref_spec
from portbench.reference.clip import TextEncoder, VisionTower
from portbench.reference.common import materialize
from portbench.reference.unet import UNet
from portbench.reference.vae import VAEEncoder
from portbench.tests import tiny

CPU = torch.device("cpu")


def _pair(ref_build, port_build, stream, missing_ok=()):
    with torch.device("meta"):
        model = ref_build()
    state = weights.make(weights.spec(model), 5, stream, CPU)
    ref = materialize(model, state, CPU)
    port = port_module(port_build, weights.make(ref_spec(ref_build), 5, stream, CPU), CPU, missing_ok).eval()
    return ref, port


def _close(a, b, tol=2e-5):
    a, b = a.detach().double(), b.detach().double()
    assert float((a - b).norm() / b.norm()) < tol


def test_unet_matches_the_port():
    from diffmining_tpu_torch.models.unet import UNet2DCondition
    from diffmining_tpu_torch.utils.weights import unet_config_from_json

    cfg = tiny.SD["unet"]
    ref, port = _pair(lambda: UNet(cfg), lambda: UNet2DCondition(unet_config_from_json(cfg)), "unet")
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 4, 16, 16, generator=g)
    t = torch.tensor([10, 500, 999])
    ctx = torch.randn(3, 77, cfg["cross_attention_dim"], generator=g)
    with torch.no_grad():
        _close(port(x, t, ctx), ref(x, t, ctx))


def test_vae_encoder_matches_the_port():
    from diffmining_tpu_torch.models.vae import DECODER_PREFIXES, AutoencoderKL, sample_latent
    from diffmining_tpu_torch.utils.weights import vae_config_from_json

    cfg = tiny.SD["vae"]
    ref, port = _pair(lambda: VAEEncoder(cfg), lambda: AutoencoderKL(vae_config_from_json(cfg)), "vae",
                      DECODER_PREFIXES)
    g = torch.Generator().manual_seed(1)
    x = torch.rand(2, 3, 32, 32, generator=g) * 2 - 1
    eps = torch.randn(2, 4, 16, 16, generator=g)
    with torch.no_grad():
        mean, logvar = port.encode(x)
        _close(sample_latent(mean, logvar, eps, cfg["scaling_factor"]), ref.latent(x, eps))


@pytest.mark.parametrize("projection", [None, 16])
def test_text_encoder_matches_the_port(projection):
    from diffmining_tpu_torch.models.clip import CLIPTextModel, CLIPTextModelWithProjection
    from diffmining_tpu_torch.utils.weights import clip_config_from_json

    cfg = tiny.TEXT
    port_cls = (lambda: CLIPTextModel(clip_config_from_json(cfg))) if projection is None else (
        lambda: CLIPTextModelWithProjection(clip_config_from_json(cfg), projection))
    ref, port = _pair(lambda: TextEncoder(cfg, projection), port_cls, "text")
    ids = torch.randint(0, 49406, (2, 77), generator=torch.Generator().manual_seed(2))
    ids[:, 9:] = 49407
    with torch.no_grad():
        if projection is None:
            _close(port(ids), ref(ids))
        else:
            _close(port(ids)[1], ref.pooled(ids))


@pytest.mark.parametrize("size", [64, 96])
def test_vision_tower_matches_the_port(size):
    from diffmining_tpu_torch.models.clip import CLIPVisionModel
    from diffmining_tpu_torch.utils.weights import clip_vision_config_from_json

    cfg = tiny.CLIP
    ref, port = _pair(lambda: VisionTower(cfg["vision_config"], cfg["projection_dim"]),
                      lambda: CLIPVisionModel(clip_vision_config_from_json(cfg)), "vision")
    x = torch.randn(2, 3, size, size, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for a, b in zip(port(x), ref(x)):
            _close(a, b)


def test_weights_repeat_from_the_seed_and_differ_between_seeds():
    with torch.device("meta"):
        spec = weights.spec(UNet(tiny.SD["unet"]))
    a, b, c = (weights.make(spec, s, "unet", CPU) for s in (7, 7, 8))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv_in.weight"], c["conv_in.weight"])
    bias = np.array([float(v.std()) for k, v in a.items() if k.endswith("conv_in.weight")])
    assert abs(bias[0] - (4 * 9) ** -0.5) < 0.05
