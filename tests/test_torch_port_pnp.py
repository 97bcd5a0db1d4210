"""The port's PnP slice on the CPU at tiny widths in float32, held to the JAX
package: the UNet's injection and collection contract (keys, layouts,
(value, gate) tuples, ctx_tile), ``PNP`` inversion, translation and
reconstruction, ``Generator``'s file protocol and inversion cache, and the
``pnp`` command.

Tolerances. One UNet pass with taps or injection: rtol 1e-3 and atol 2e-4,
the UNet tests' bound. Chains (6 inversion steps, 4 translation steps, the
decode): rtol 2e-3 and atol 1e-4, the sweep pipeline's bound. Images the
JAX package hands back as uint8 (PIL): at most one level apart.
"""
import os
from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffmining_tpu.applications import pnp as jpnp
from diffmining_tpu.typicality.compute import SD as JSD
from diffmining_tpu.utils.export import save_pipeline_dir as jsave_pipeline_dir

from diffmining_tpu_torch.__main__ import main as port_cli
from diffmining_tpu_torch.applications import pnp as ppnp
from diffmining_tpu_torch.models import unet as unet_mod
from diffmining_tpu_torch.typicality.compute import SD

torch.set_num_threads(1)
TOL = dict(rtol=1e-3, atol=2e-4)
CHAIN = dict(rtol=2e-3, atol=1e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return np.asarray(t.detach()).transpose(0, 2, 3, 1)


def _to_port(key, value):
    """A JAX tap in the port's layout: residual branches NHWC -> NCHW; q/k
    are canonical [B, H, L, D] in both."""
    return nchw(value) if ".res." in key else torch.from_numpy(np.array(value))


def _pixels(a, b):
    return np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16)).max()


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """The JAX tiny geo bundle and the port's, loaded from its pipeline dir."""
    jsd = JSD.init_tiny("geo", ["France", "Japan"])
    pipe = str(tmp_path_factory.mktemp("pipe"))
    jsave_pipeline_dir(pipe, jsd.unet.config, _np(jsd.unet_params), jsd.vae.config, _np(jsd.vae_params),
                       jsd.clip.config, _np(jsd.clip_params), jsd.schedule)
    psd = SD.from_pipeline_dir("geo", pipe, [], dtype=torch.float32, device="cpu")
    return jsd, psd, pipe


@pytest.fixture(scope="module")
def unet_inputs():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 16, 16, 4).astype(np.float32)
    t = np.array([500, 80], np.int32)
    ctx = rng.randn(2, 77, 32).astype(np.float32)
    ctx_tiled = rng.randn(4, 77, 32).astype(np.float32)
    return x, t, ctx, ctx_tiled


@pytest.fixture(scope="module")
def jax_taps(bundles, unet_inputs):
    jsd, _, _ = bundles
    x, t, ctx, _ = unet_inputs
    out = jsd.unet.apply(jsd.unet_params, jnp.asarray(x[:1]), jnp.asarray(t[:1]), jnp.asarray(ctx[:1]),
                         collect_injection=True)
    return {k: np.asarray(v) for k, v in out["taps"].items()}


def test_collected_taps_match_jax(bundles, unet_inputs, jax_taps):
    _, psd, _ = bundles
    x, t, ctx, _ = unet_inputs
    with torch.no_grad():
        out = psd.unet(nchw(x[:1]), torch.from_numpy(t[:1]).long(), torch.from_numpy(ctx[:1]), collect_injection=True)
    assert set(out) == {"sample", "taps"}
    taps = out["taps"]
    assert set(taps) == set(jax_taps)
    assert {"up.1.res.1", "up.1.tf.1.0.attn1.q", "down.0.tf.0.0.attn1.k", "mid.tf.0.attn1.q"} <= set(taps)
    assert not any(k.startswith("down.") and ".res." in k for k in taps)  # JAX taps no down resnet
    for k, v in jax_taps.items():
        np.testing.assert_allclose(np.asarray(taps[k]), np.asarray(_to_port(k, v)), err_msg=k, **TOL)
    assert tuple(taps["up.1.tf.1.0.attn1.q"].shape) == (1, 2, 256, 16)  # [S, H, L, D]


GATES = {
    "value": lambda v: v,
    "gate-true": lambda v: (v, True),
    "gate-false": lambda v: (v, False),
    "gate-tensor": lambda v: (v, torch.tensor(True)),
}


@pytest.mark.parametrize("form", sorted(GATES))
@pytest.mark.parametrize("ctx_tile", [1, 2])
def test_injection_matches_jax(bundles, unet_inputs, jax_taps, form, ctx_tile):
    """The PnP sites of the tiny UNet (the resnet residual branch up.1.res.1
    and the attn1 q/k of up.1.tf.1), injected from a batch-1 source pass
    into a batch-2 pass, in each value form, with and without ctx_tile."""
    jsd, psd, _ = bundles
    x, t, ctx, ctx_tiled = unet_inputs
    keys = ["up.1.res.1", "up.1.tf.1.0.attn1.q", "up.1.tf.1.0.attn1.k"]
    jgate = {"value": None, "gate-true": True, "gate-false": False, "gate-tensor": True}[form]
    jinj = {k: jax_taps[k] if jgate is None else (jax_taps[k], jnp.asarray(jgate)) for k in keys}
    pinj = {k: GATES[form](_to_port(k, jax_taps[k])) for k in keys}
    c = ctx_tiled if ctx_tile == 2 else ctx
    want = jsd.unet.apply(jsd.unet_params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(c), injection=jinj,
                          ctx_tile=ctx_tile)
    with torch.no_grad():
        got = psd.unet(nchw(x), torch.from_numpy(t).long(), torch.from_numpy(c), injection=pinj, ctx_tile=ctx_tile)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)
    if form == "gate-false":
        with torch.no_grad():
            plain = psd.unet(nchw(x), torch.from_numpy(t).long(), torch.from_numpy(c), ctx_tile=ctx_tile)
        torch.testing.assert_close(got, plain, rtol=0, atol=0)


def test_injected_activations_are_forced_and_dense(bundles, unet_inputs, jax_taps, monkeypatch):
    """A collect-then-inject pass carries the injected values (the JAX
    test_unet_collect_then_inject), and the attention receives injected q/k
    as dense tensors: the batch-1 broadcast is materialised, never a
    stride-0 view."""
    _, psd, _ = bundles
    x, t, ctx, _ = unet_inputs
    keys = ["up.1.res.1", "up.1.tf.1.0.attn1.q", "up.1.tf.1.0.attn1.k"]
    inj = {k: _to_port(k, jax_taps[k]) for k in keys}
    seen = []
    real = unet_mod.sdpa

    def spy(q, k, v, *a, **kw):
        seen.append((q, k))
        return real(q, k, v, *a, **kw)

    monkeypatch.setattr(unet_mod, "sdpa", spy)
    with torch.no_grad():
        out = psd.unet(nchw(x), torch.from_numpy(t).long(), torch.from_numpy(ctx), injection=inj,
                       collect_injection=True)
    for k in keys:
        torch.testing.assert_close(out["taps"][k], inj[k].expand_as(out["taps"][k]), rtol=0, atol=0)
    injected = [(q, k) for q, k in seen if q.shape == (2,) + inj[keys[1]].shape[1:]
                and torch.equal(q, inj[keys[1]].expand_as(q))]
    assert len(injected) == 1
    q, k = injected[0]
    assert 0 not in q.stride() and 0 not in k.stride() and torch.equal(k, inj[keys[2]].expand_as(k))


def test_injection_contract_errors(bundles, unet_inputs, jax_taps):
    _, psd, _ = bundles
    x, t, _, ctx_tiled = unet_inputs
    args = (nchw(x), torch.from_numpy(t).long(), torch.from_numpy(ctx_tiled))
    with torch.no_grad(), pytest.raises(ValueError, match="collect with ctx_tile=1"):
        psd.unet(*args, ctx_tile=2, collect_injection=True)
    wide = {"up.1.res.1": _to_port("up.1.res.1", jax_taps["up.1.res.1"]).expand(2, -1, -1, -1)}
    with torch.no_grad(), pytest.raises(ValueError, match="only batch-1 values compose"):
        psd.unet(*args, ctx_tile=2, injection=wide)


@pytest.fixture(scope="module")
def inverted(bundles):
    """One 32 px source inverted over 6 steps by both packages (4 translation
    steps), as tests/test_pnp.py."""
    jsd, psd, _ = bundles
    img = np.random.RandomState(0).rand(32, 32, 3).astype(np.float32) * 2 - 1
    jp = jpnp.PNP(jsd, inversion_steps=6, n_timesteps=4)
    jp.invert(img)
    pp = ppnp.PNP(psd, inversion_steps=6, n_timesteps=4)
    pp.invert(img)
    return jp, pp, img


def test_inversion_matches_jax(inverted):
    jp, pp, _ = inverted
    assert tuple(pp._trajectory.shape) == (6, 1, 4, 16, 16)
    np.testing.assert_allclose(nhwc(pp._clean_latent), np.asarray(jp._clean_latent), **CHAIN)
    np.testing.assert_allclose(nhwc(pp._source_latent), np.asarray(jp._source_latent), **CHAIN)
    np.testing.assert_allclose(np.asarray(pp._trajectory).transpose(0, 1, 3, 4, 2), np.asarray(jp._trajectory),
                               **CHAIN)
    torch.testing.assert_close(pp._trajectory[-1], pp._source_latent, rtol=0, atol=0)


def _jax_translate(jp, targets, source=0):
    """JAX PNP.generate before its uint8 conversion: [B, H, W, 3] float32."""
    sd = jp.sd
    x0 = jnp.concatenate([jp._source_latent[source:source + 1]] * len(targets), axis=0).astype(sd.dtype)
    run = jp._translate_fn(len(targets))
    return np.asarray(run(sd.unet_params, sd.vae_params, x0, jp._trajectory[:, source:source + 1],
                          jp.embed(targets), jp.embed([""])))


@pytest.mark.parametrize("dedup", [False, True])
def test_translation_matches_jax(inverted, dedup):
    """4 steps of the source-tap pass and the CFG pass with the step gates
    (the residual gate on for 3 steps, the attention gate for 2), the
    DDIM update and the decode; in both CFG layouts."""
    jp, pp, _ = inverted
    targets = ["France", "Japan"]
    jd = jpnp.PNP(jp.sd, inversion_steps=6, n_timesteps=4, dedup_prefix=dedup)
    jd._trajectory, jd._source_latent = jp._trajectory, jp._source_latent
    pd = ppnp.PNP(pp.sd, inversion_steps=6, n_timesteps=4, dedup_prefix=dedup)
    pd._trajectory, pd._source_latent = pp._trajectory, pp._source_latent
    want = _jax_translate(jd, targets)
    got = pd.translate(targets)
    assert tuple(got.shape) == (2, 3, 32, 32)
    np.testing.assert_allclose(nhwc(got), want, **CHAIN)
    for a, b in zip(pd.generate(targets), jd.generate(targets)):
        assert a.size == (32, 32) and _pixels(a, b) <= 1


def test_injection_changes_the_translation(inverted):
    _, pp, _ = inverted
    off = ppnp.PNP(pp.sd, inversion_steps=6, n_timesteps=4, pnp_f_t=0.0, pnp_attn_t=0.0)
    off._trajectory, off._source_latent = pp._trajectory, pp._source_latent
    assert float((pp.translate(["France"]) - off.translate(["France"])).abs().max()) > 1e-4


def test_reconstruction_matches_jax(inverted):
    jp, pp, _ = inverted
    (a,), (b,) = pp.reconstruct_many(), jp.reconstruct_many()
    assert a.size == (32, 32) and _pixels(a, b) <= 1
    assert _pixels(pp.reconstruct(0), a) == 0
    with pytest.raises(IndexError):
        pp.reconstruct(1)


def _sources(root, n, seed):
    src = root / "base" / "France"
    os.makedirs(src)
    rng = np.random.RandomState(seed)
    paths = []
    for i in range(n):
        p = str(src / f"id_00{i}_0.png")
        Image.fromarray(rng.randint(0, 255, (32, 32, 3), dtype=np.uint8)).save(p)
        paths.append(p)
    return paths


def test_generator_file_protocol_and_cache(bundles, tmp_path, monkeypatch):
    """A same-shape group inverts as one batch and writes every source's
    gt--, inverted--, projected-- and target files; a second Generator
    over the cache loads the inversion instead of running it, exactly."""
    _, psd, _ = bundles
    paths = _sources(tmp_path, 2, 2)
    cache = str(tmp_path / "cache")
    g = ppnp.Generator(psd, paths, inversion_steps=4, n_timesteps=2, cache_dir=cache)
    assert g.pnp.num_sources() == 2 and len(os.listdir(cache)) == 2
    out = str(tmp_path / "out" / "France")
    g.plotum(out, ["France", "Japan"], batch_size=2)
    files = set(os.listdir(out))
    for i in range(2):
        assert {f"gt--France_00{i}_0.png", f"inverted--France_00{i}_0.png", f"projected--France_00{i}_0.png",
                f"Japan_00{i}_0.png"} <= files
    monkeypatch.setattr(ppnp.PNP, "invert", lambda *a, **k: (_ for _ in ()).throw(AssertionError("re-inverted")))
    g2 = ppnp.Generator(psd, paths, inversion_steps=4, n_timesteps=2, cache_dir=cache)
    torch.testing.assert_close(g2.pnp._trajectory, g.pnp._trajectory, rtol=0, atol=0)
    torch.testing.assert_close(g2.pnp._source_latent, g.pnp._source_latent, rtol=0, atol=0)
    # the batched inversion gives each source what its own inversion gives
    single = ppnp.PNP(psd, inversion_steps=4, n_timesteps=2)
    monkeypatch.undo()
    single.invert(np.asarray(Image.open(paths[1]).convert("RGB"), np.float32) / 255.0 * 2.0 - 1.0)
    torch.testing.assert_close(single._trajectory[:, 0], g.pnp._trajectory[:, 1], **CHAIN)


def test_pnp_cli_on_the_cpu(bundles, tmp_path):
    _, _, pipe = bundles
    base = tmp_path / "base" / "United States"
    os.makedirs(base)
    Image.fromarray(np.random.RandomState(4).randint(0, 255, (32, 32, 3), dtype=np.uint8)).save(
        base / "id_007_0.png")
    save = str(tmp_path / "parallel")
    port_cli(["pnp", "--model_path", pipe, "--base_path", str(tmp_path / "base"), "--save_dir", save,
              "--inversion_steps", "3", "--dtype", "fp32", "--device", "cpu"])
    files = set(os.listdir(join(save, "United States")))
    assert {"gt--United States_007_0.png", "inverted--United States_007_0.png",
            "projected--United States_007_0.png", "Japan_007_0.png", "India_007_0.png"} <= files
    assert len(files) == 2 + len(ppnp.COUNTRIES)
