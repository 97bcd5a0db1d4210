"""The port's trainer over dp and fsdp (parallel/mesh.py, finetuning/train.py)
on the CPU, gloo ranks at tiny widths in float32, held to the JAX package's
TrainStepBuilder over its own meshes:

  * ``Mesh`` with fsdp: ``host_local_batch_slice`` against the rows JAX's
    ``P("dp")`` puts on each device of a (dp, fsdp) mesh and against JAX's
    ``host_local_batch_slice`` with its process index monkeypatched to the
    dp index; ``make_mesh`` against JAX's (dp's default, the refusal of a
    mesh larger than the devices); ``FlatShards`` covering every element
    and every 8-bit block exactly once (hypothesis);
  * one step over dp 2 (two ranks, a global batch of 4) against JAX's step
    over ``make_mesh(dp=2, fsdp=1)`` on the same batch and draws: AdamW +
    EMA (also the loss and the all-reduced gradients) and 8-bit Adam.

The JAX steps take most of a file's time (a compile each), so the other
variants are in files of their own, which import this file's helpers:
accumulation into the bf16 accumulator and LoRA over dp 2
(tests/test_torch_port_mesh_train_accum_lora.py), dp 1 x fsdp 2
(tests/test_torch_port_mesh_train_fsdp.py), and ``finetune`` through the
CLI with checkpoints resumed across meshes
(tests/test_torch_port_mesh_train_cli.py).

Tolerances are tests/test_torch_port_finetune.py's: loss and gradients rtol
1e-3 with an atol of 1e-4 of the largest gradient (the loss rtol 1e-5);
parameters and EMA after an AdamW step within 2·lr everywhere (a flipped
sign of a near-zero gradient) and within 1e-3·lr for 99% of them.

A rank is a subprocess that imports the port and no JAX; the JAX package's
weights, images and global draws reach it through a ``torch.save`` file.
"""
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from diffmining_tpu.diffusion.schedule import add_noise as jadd_noise
from diffmining_tpu.finetuning.train import TrainStepBuilder as JTrainStepBuilder
from diffmining_tpu.finetuning.train import make_lr_schedule as jmake_lr_schedule
from diffmining_tpu.finetuning.train import make_optimizer as jmake_optimizer
from diffmining_tpu.parallel import mesh as jmesh
from diffmining_tpu.models.vae import sample_latent as jsample_latent
from diffmining_tpu.typicality.compute import SD as JSD

from diffmining_tpu_torch.ops.optim8bit import _n_blocks
from diffmining_tpu_torch.parallel import mesh as pmesh
from diffmining_tpu_torch.utils.weights import params_from_jax

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
BATCH, PX = 4, 32
RANK_TIMEOUT_S = 240

# One rank (or, with world 1, one process without a mesh): argv CONFIG, a
# JSON object. Runs each variant on the weights, images and draws of
# INPUTS, through TrainStepBuilder.build()'s step, and writes to OUT the
# losses, the whole parameters and EMA after the steps, the moments' element
# count it holds, and for "grads" the loss and the all-reduced gradients of
# the first batch before any step.
RANK = r"""
import json, sys
import torch
torch.set_num_threads(1)
from diffmining_tpu_torch.diffusion.schedule import make_schedule
from diffmining_tpu_torch.finetuning.train import AdamWState, TrainStepBuilder, make_lr_schedule, make_optimizer
from diffmining_tpu_torch.models.clip import TINY_CLIP_TEXT, CLIPTextModel
from diffmining_tpu_torch.models.unet import TINY_UNET, UNet2DCondition
from diffmining_tpu_torch.models.vae import DECODER_PREFIXES, TINY_VAE, AutoencoderKL
from diffmining_tpu_torch.parallel import mesh as pm
from diffmining_tpu_torch.utils.weights import load_state

cfg = json.loads(sys.argv[1])
inp = torch.load(cfg["inputs"], weights_only=False)
mesh = None
if cfg["world"] > 1:
    pm.initialize_distributed(cfg["address"], cfg["world"], cfg["rank"], device="cpu")
    mesh = pm.make_mesh(dp=cfg["dp"], fsdp=cfg["fsdp"])
out = {}
for v in cfg["variants"]:
    unet, vae, clip = UNet2DCondition(TINY_UNET), AutoencoderKL(TINY_VAE), CLIPTextModel(TINY_CLIP_TEXT)
    load_state(unet, inp["unet"])
    load_state(vae, inp["vae"], ignore_prefixes=DECODER_PREFIXES)
    load_state(clip, inp["clip"])
    opt = make_optimizer(make_lr_schedule("constant", cfg["lr"], 0), accum_steps=v["accum"],
                         accum_dtype=torch.bfloat16 if v["bf16_acc"] else None, use_8bit=v["use_8bit"])
    b = TrainStepBuilder(unet=unet, vae=vae, clip=clip, schedule=make_schedule(), optimizer=opt, use_ema=True,
                         lora_rank=v["lora"], mesh=mesh)
    state = b.init_state()
    if v["lora"]:
        with torch.no_grad():  # JAX's factors, b nonzero; the EMA piece by piece
            for i, (k, p) in enumerate(state.params.items()):
                p.copy_(inp["factors"][k])
                state.ema_params[k].view(-1).copy_(inp["factors"][k].reshape(-1)[b.shards.rows(i)])
    rows = slice(None) if mesh is None else pm.host_local_batch_slice(cfg["batch"], mesh)
    res = {}
    if v["grads"]:
        loss = b.loss(inp["images"][0][rows], inp["tokens"][0][rows], draws=inp["draws"][0])
        loss.backward()
        grads = [p.grad for p in state.params.values()]
        for p in state.params.values():
            p.grad = None
        loss = loss.detach()
        pm.all_reduce_mean_(grads, mesh)
        pm.all_reduce_mean_([loss], mesh)
        res.update(loss=float(loss), grads=dict(zip(state.params, grads)))
    step, losses = b.build(), []
    for images, tokens, draws in zip(inp["images"], inp["tokens"], inp["draws"][:v["accum"]]):
        state, loss = step(state, images[rows], tokens[rows], draws=draws)
        losses.append(float(loss))
    inner = state.opt_state.inner_state if v["accum"] > 1 else state.opt_state
    res.update(losses=losses, params={k: p.detach().clone() for k, p in state.params.items()},
               ema=b.whole_ema(state), moment_elems=sum(m.numel() for m in inner.mu) if isinstance(inner, AdamWState)
               else sum(q.numel() for q in inner.mu_q))
    out[v["name"]] = res
if mesh is not None:
    pm.destroy()
torch.save(out, cfg["out"])
"""

VARIANTS = {
    "adamw": dict(accum=1, bf16_acc=False, lora=None, use_8bit=False, grads=True),
    "accum_bf16": dict(accum=2, bf16_acc=True, lora=None, use_8bit=False, grads=False),
    "lora": dict(accum=1, bf16_acc=False, lora=2, use_8bit=False, grads=False),
    "8bit": dict(accum=1, bf16_acc=False, lora=None, use_8bit=True, grads=False),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _t(a):
    return torch.from_numpy(np.array(a))


def _nchw(a):
    return _t(np.asarray(a).transpose(0, 3, 1, 2))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(configs):
    """One process a config; wait for all within RANK_TIMEOUT_S, and kill the
    rest if one fails or hangs."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", RANK, json.dumps(c)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for c in configs]
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [torch.load(c["out"], weights_only=False) for c in configs]


def _mesh(dp, rank, fsdp=1):
    return pmesh.Mesh(dp=dp, rank=rank, world=dp * fsdp, fsdp=fsdp)


# ---------------------------------------------------------------------------
# the mesh with fsdp
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dp,fsdp", [(1, 2), (2, 2), (2, 1), (1, 4), (4, 2), (2, 4)])
def test_host_local_batch_slice_is_jax_dp_sharding(dp, fsdp, monkeypatch):
    """Each rank's rows are the rows JAX's ``P("dp")`` places on device
    ``rank`` of make_mesh(dp, fsdp) (fsdp peers the same), and JAX's
    host_local_batch_slice with the process count dp and the process index
    the rank's dp index."""
    m = jmesh.make_mesh(jax.devices()[: dp * fsdp], dp=dp, fsdp=fsdp)
    devices = list(m.devices.reshape(-1))
    monkeypatch.setattr(jax, "process_count", lambda: dp)
    for batch in (dp, 2 * dp, 3 * dp):
        rows = NamedSharding(m, P("dp")).devices_indices_map((batch,))
        for rank in range(dp * fsdp):
            got = pmesh.host_local_batch_slice(batch, _mesh(dp, rank, fsdp))
            want = rows[devices[rank]][0]
            assert (got.start, got.stop) == (want.start or 0, batch if want.stop is None else want.stop)
            monkeypatch.setattr(jax, "process_index", lambda r=rank: r // fsdp)
            assert got == jmesh.host_local_batch_slice(batch)
    assert pmesh.host_local_batch_slice(2 * dp, pmesh.Mesh(dp=dp, rank=dp * fsdp, world=dp * fsdp + 1, fsdp=fsdp)) \
        == slice(0, 0)


@pytest.mark.parametrize("world", [1, 2, 4, 6, 8])
def test_make_mesh_equals_jax(world, monkeypatch):
    """Over a group of ``world`` ranks: dp's default (world // fsdp), the
    axes, the mesh coordinates of each rank, and a mesh larger than the
    ranks refused, as JAX's make_mesh over that many devices."""
    monkeypatch.setattr(pmesh, "_group_up", lambda: True)
    monkeypatch.setattr(pmesh.dist, "get_world_size", lambda: world)
    for fsdp in (f for f in (1, 2, 3, 4) if f <= world):
        for dp in (None, 1, 2, 3):
            if dp is not None and dp * fsdp > world:
                with pytest.raises(AssertionError):
                    jmesh.make_mesh(jax.devices()[:world], dp=dp, fsdp=fsdp)
                with pytest.raises(ValueError, match=f"mesh {dp}x{fsdp} > {world}"):
                    pmesh.make_mesh(dp=dp, fsdp=fsdp)
                continue
            want = jmesh.make_mesh(jax.devices()[:world], dp=dp, fsdp=fsdp)
            grid = {d.id: (i, j) for (i, j), d in np.ndenumerate(want.devices)}
            for rank in range(world):
                monkeypatch.setattr(pmesh.dist, "get_rank", lambda r=rank: r)
                got = pmesh.make_mesh(dp=dp, fsdp=fsdp)
                assert (got.dp, got.fsdp, got.world) == (want.shape["dp"], want.shape["fsdp"], world)
                if rank < got.dp * got.fsdp:
                    assert (got.dp_rank, got.fsdp_rank) == grid[jax.devices()[rank].id] and not got.outside
                else:
                    assert got.outside


def test_mesh_without_a_group_refuses_fsdp():
    assert pmesh.make_mesh(dp=1, fsdp=1) == pmesh.Mesh(dp=1, rank=0, world=1)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2 .*--distributed"):
        pmesh.make_mesh(fsdp=2)


@settings(max_examples=80, deadline=None, database=None)
@given(st.lists(st.integers(0, 3000), min_size=1, max_size=6), st.integers(1, 5))
def test_flat_shards_cover_every_element_once(numels, fsdp):
    """Over the fsdp indices the pieces of each tensor (``shard_params``)
    cover its elements exactly once, in order, each piece starting on a
    256-element boundary;
    the block rows cover its 8-bit blocks exactly once and are the blocks of
    the element rows; the padded chunks are equal multiples of 256."""
    tensors = [torch.arange(n, dtype=torch.float32) for n in numels]
    pmesh_fsdp_group = pmesh.fsdp_group
    pmesh.fsdp_group = lambda mesh: None  # no process group: the layout alone
    try:
        layouts = [pmesh.FlatShards(_mesh(1, f, fsdp), numels) for f in range(fsdp)]
        pieces = [pmesh.shard_params(_mesh(1, f, fsdp), tensors) for f in range(fsdp)]
    finally:
        pmesh.fsdp_group = pmesh_fsdp_group
    for i, n in enumerate(numels):
        chunk = layouts[0].chunks[i]
        assert chunk % 256 == 0 and chunk * fsdp >= n and chunk * fsdp - n < 256 * fsdp
        elems = [lay.rows(i) for lay in layouts]
        blocks = [lay.rows(i, blocks=True) for lay in layouts]
        assert [x for r in elems for x in range(r.start, r.stop)] == list(range(n))
        assert [x for r in blocks for x in range(r.start, r.stop)] == list(range(_n_blocks(n)))
        assert torch.equal(torch.cat([p[i] for p in pieces]), tensors[i])  # shard_params: views of the pieces
        for e, b in zip(elems, blocks):
            if e.stop > e.start:
                assert e.start % 256 == 0 and b == slice(e.start // 256, e.start // 256 + _n_blocks(e.stop - e.start))
            else:
                assert b.stop == b.start


def test_all_reduce_mean_buckets():
    """The buckets are consecutive runs within the byte limit, a larger
    tensor alone."""
    assert pmesh._buckets([10, 20, 30, 100, 5, 5], limit=60) == [range(0, 3), range(3, 4), range(4, 6)]
    assert pmesh._buckets([], limit=60) == []


# ---------------------------------------------------------------------------
# one step over dp 2 and over fsdp 2 against JAX
# ---------------------------------------------------------------------------


def _nonzero_b(tree, seed):
    rng = np.random.RandomState(seed)

    def walk(node):
        if "a" in node and "b" in node:
            return {"a": np.asarray(node["a"]), "b": (0.1 * rng.randn(*node["b"].shape)).astype(np.float32)}
        return {k: walk(v) for k, v in node.items()}

    return walk(_np(tree))


def _jax_runs(tmp, runs, grads=False):
    """The JAX package's steps over its meshes, ``runs`` a list of ((dp,
    fsdp), variant names); with ``grads`` the loss and gradients of the
    first batch; and the inputs file the ranks read: the tiny stack's
    weights, two global batches of 4 images and tokens, and each step's
    global draws (train.py:277-283 with the step's keys) in the port's
    layout."""
    jsd = JSD.init_tiny("ftt", ["1930", "1990"])
    rng = np.random.RandomState(18)
    images = rng.uniform(-1, 1, (2, BATCH, PX, PX, 3)).astype(np.float32)
    tokens = rng.randint(0, 1000, (2, BATCH, 77)).astype(np.int32)
    key = jax.random.PRNGKey(7)
    T = jsd.schedule.num_train_timesteps
    draws = []
    for step in range(2):
        k_lat, k_noise, k_t = jax.random.split(jax.random.fold_in(key, step), 3)
        mean, logvar = jsd.vae.apply(jsd.vae_params, jnp.asarray(images[step]))
        draws.append((jax.random.normal(k_lat, mean.shape, dtype=jnp.float32),
                      jax.random.normal(k_noise, mean.shape, dtype=jnp.float32),
                      jax.random.randint(k_t, (BATCH,), 0, T, dtype=jnp.int32)))
        if step == 0:
            latents = jsample_latent(mean, logvar, k_lat, jsd.vae.config.scaling_factor)

    loss = grads_ = None
    if grads:
        # the loss and gradients of the first global batch (one program, no mesh)
        _, noise, t = draws[0]
        noisy = jadd_noise(jsd.schedule, latents, noise, t)
        ctx = jsd.clip.apply(jsd.clip_params, jnp.asarray(tokens[0]))

        def loss_fn(p):
            return jnp.mean((jsd.unet.apply(p, noisy, t, ctx).astype(jnp.float32) - noise) ** 2)

        loss, grads_ = jax.jit(jax.value_and_grad(loss_fn))(jsd.unet_params)

    carried = None
    results = {}
    for (dp, fsdp), names in runs:
        m = jmesh.make_mesh(dp=dp, fsdp=fsdp)
        for name in names:
            v = VARIANTS[name]
            builder = JTrainStepBuilder(
                unet=jsd.unet, vae=jsd.vae, clip=jsd.clip, schedule=jsd.schedule,
                optimizer=jmake_optimizer(jmake_lr_schedule("constant", LR, 0), accum_steps=v["accum"],
                                          use_8bit=v["use_8bit"],
                                          accum_dtype=jnp.bfloat16 if v["bf16_acc"] else None),
                vae_params=jsd.vae_params, clip_params=jsd.clip_params, use_ema=True, mesh=m,
                lora_rank=v["lora"], accum_steps=v["accum"],
            )
            unet_params = jmesh.shard_params(m, jsd.unet_params) if fsdp > 1 else jsd.unet_params
            state = builder.init_state(unet_params, jax.random.PRNGKey(0))
            if v["lora"]:
                carried = carried or {"params": _nonzero_b(state.params["params"], 11)}
                state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, carried),
                                      ema_params=jax.tree_util.tree_map(jnp.asarray, carried))
            step, losses = builder.build(), []
            for i in range(v["accum"]):
                state, step_loss = step(state, jnp.asarray(images[i]), jnp.asarray(tokens[i]), key)
                losses.append(float(step_loss))
            kind = "lora" if v["lora"] else "unet"
            results[(dp, fsdp, name)] = dict(losses=losses, params=params_from_jax(_np(state.params), kind),
                                             ema=params_from_jax(_np(state.ema_params), kind))

    inputs = str(tmp / "inputs.pt")
    torch.save(dict(unet=params_from_jax(_np(jsd.unet_params), "unet"), vae=params_from_jax(_np(jsd.vae_params), "vae"),
                    clip=params_from_jax(_np(jsd.clip_params), "clip_text"),
                    factors=None if carried is None else params_from_jax(carried, "lora"),
                    images=[_nchw(x) for x in images], tokens=[_t(x) for x in tokens],
                    draws=[(_nchw(e), _nchw(n), _t(np.asarray(tt))) for e, n, tt in draws]), inputs)
    return dict(inputs=inputs, results=results, loss=None if loss is None else float(loss),
                grads=None if grads_ is None else params_from_jax(_np(grads_), "unet"))


def _configs(tmp_path, jax_runs, world, dp, fsdp, names, tag):
    address = f"127.0.0.1:{_free_port()}"
    return [dict(inputs=jax_runs["inputs"], out=str(tmp_path / f"{tag}{r}.pt"), address=address, world=world,
                 rank=r, dp=dp, fsdp=fsdp, batch=BATCH, lr=LR, variants=[dict(name=n, **VARIANTS[n]) for n in names])
            for r in range(world)]


def _assert_step_close(got, want):
    """Within 2·lr everywhere, within 1e-3·lr for 99% of the elements."""
    assert set(got) == set(want)
    diffs = torch.cat([(got[k].detach().reshape(w.shape) - w.detach()).abs().flatten() for k, w in want.items()])
    assert float(diffs.max()) <= 2 * LR + 1e-6
    assert float((diffs <= 1e-3 * LR).float().mean()) >= 0.99


def _check_dp2_step(ranks, want):
    """Losses, parameters and EMA after the step(s) of two ranks over dp 2
    as JAX's over make_mesh(dp=2, fsdp=1) on the global batch; both ranks
    hold the same whole parameters and EMA."""
    r0, r1 = ranks
    np.testing.assert_allclose(r0["losses"], want["losses"], rtol=1e-5)
    assert r0["losses"] == r1["losses"]
    for a, b in ((r0["params"], r1["params"]), (r0["ema"], r1["ema"])):
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    _assert_step_close(r0["params"], want["params"])
    _assert_step_close(r0["ema"], want["ema"])


DP2_VARIANTS = ("adamw", "8bit")


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return _jax_runs(tmp_path_factory.mktemp("mesh_train"), [((2, 1), DP2_VARIANTS)], grads=True)


@pytest.fixture(scope="module")
def dp2(jax_runs, tmp_path_factory):
    """Two gloo ranks over dp 2."""
    return _run_ranks(_configs(tmp_path_factory.mktemp("dp2"), jax_runs, 2, 2, 1, DP2_VARIANTS, "rank"))


def test_dp2_loss_and_reduced_gradients_match_jax(dp2, jax_runs):
    """The dp mean of the ranks' losses and their all-reduced gradients are
    the JAX loss and gradients of the whole global batch, on both ranks."""
    want = jax_runs["grads"]
    scale = max(float(w.abs().max()) for w in want.values())
    for rank in dp2:
        got = rank["adamw"]
        np.testing.assert_allclose(got["loss"], jax_runs["loss"], rtol=1e-5)
        assert set(got["grads"]) == set(want)
        for k, w in want.items():
            torch.testing.assert_close(got["grads"][k], w, rtol=1e-3, atol=1e-4 * scale, msg=k)


@pytest.mark.parametrize("name", DP2_VARIANTS)
def test_dp2_step_matches_jax(dp2, jax_runs, name):
    """AdamW + EMA and 8-bit Adam over dp 2 against JAX's dp=2 step
    (accumulation and LoRA: tests/test_torch_port_mesh_train_accum_lora.py;
    fsdp: tests/test_torch_port_mesh_train_fsdp.py)."""
    _check_dp2_step([r[name] for r in dp2], jax_runs["results"][(2, 1, name)])
