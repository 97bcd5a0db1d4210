"""Typicality pipeline: model bundle, per-category sweeps, artifact store,
work-queue sharding, CLI (counterpart of diffmining_tpu/typicality/compute.py).

The artifact contract is the reference's: per-image ``.npy`` loss grids of
shape [N, n_cond, 4, h/8, w/8] fp16 under ``{typicality_path}/{category}/``,
submission shard files ``{i}.txt`` of "path,category" lines, and idempotent
``exists`` checks, so trees from the JAX package, the reference and the port
interoperate.

    python -m diffmining_tpu_torch.typicality.compute --which ftt -i DATA \\
        -c OUT -s SUBS -m PIPELINE_DIR --make_submission

``-m`` may also name a finetuning checkpoint (``checkpoint-N``), which is
exported to ``checkpoint-N-export`` first (finetuning/export.py).

Over several GPUs, one process each (``parallel/mesh.py``): every rank walks
the same shard file and forms the same groups, sweeps its contiguous rows of
each group (VAE encode included) and writes their artifacts; an image's
draws come from its uid, so its artifact does not depend on the rank.

    torchrun --nproc_per_node 4 -m diffmining_tpu_torch typicality ... --distributed
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import queue
import threading
import time
from collections import defaultdict
from os.path import join
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from diffmining_tpu_torch.diffusion.schedule import Schedule, make_schedule
from diffmining_tpu_torch.models.clip import CLIP_VIT_L_TEXT, CLIPTextConfig, CLIPTextModel
from diffmining_tpu_torch.models.tokenizer import CLIPTokenizer, tiny_tokenizer
from diffmining_tpu_torch.models.unet import SD15_UNET, UNet2DCondition, UNetConfig
from diffmining_tpu_torch.models.vae import SD15_VAE, AutoencoderKL, VAEConfig, sample_latent
from diffmining_tpu_torch.parallel.mesh import Mesh, cli_mesh, destroy, host_barrier, is_writer
from diffmining_tpu_torch.typicality.engine import SeededDraws, TypicalityEngine, losses_to_reference_layout
from diffmining_tpu_torch.typicality.templates import get_decade, typicality_prompts
from diffmining_tpu_torch.utils.artifacts import atomic_save_npy
from diffmining_tpu_torch.utils.device import resolve_device
from diffmining_tpu_torch.utils.images import image_uid, load_image
from diffmining_tpu_torch.utils.observability import Timer, annotate, trace
from diffmining_tpu_torch.utils.weights import load_pipeline_dir, load_state

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


class CategoryFeatures:
    """Tokenize + CLIP-encode the per-domain prompt templates
    (reference compute.py:27-54)."""

    def __init__(self, clip: CLIPTextModel, tokenizer: CLIPTokenizer, which: str, device: torch.device):
        self.clip = clip
        self.tokenizer = tokenizer
        self.which = which
        self.device = device

    @torch.inference_mode()
    def embed(self, categories: Sequence[str]) -> torch.Tensor:
        ids = torch.from_numpy(self.tokenizer(typicality_prompts(self.which, categories))).long()
        return self.clip(ids.to(self.device)).float()


def fused_norm_gate(device: torch.device) -> bool:
    """``DIFFMINING_FUSED_NORM`` other than "0" turns the fused GroupNorm →
    proj_in kernel on for the bundle's UNet, on CUDA only: the CPU keeps the
    module path, as the JAX package keeps it off the TPU (compute.py:84-97).
    Default off."""
    return device.type == "cuda" and os.environ.get("DIFFMINING_FUSED_NORM", "0") != "0"


def init_random_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights, flax's defaults: lecun-normal conv/dense
    kernels, zero biases, unit norm scales; embeddings N(0, 0.02²)."""
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, (nn.GroupNorm, nn.LayerNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, (nn.Linear, nn.Conv2d)):
                mod.weight.normal_(0.0, mod.weight[0].numel() ** -0.5, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, 0.02, generator=generator)


@dataclasses.dataclass
class SD:
    """Model bundle: UNet + VAE + CLIP text + schedule + tokenizer + the
    prompt embeddings of every category (and the null prompt).

    The modules are moved to ``device`` and cast to the compute ``dtype``
    ONCE here — one shared inference copy of the weights for every
    per-category engine, as the JAX package's ``SD.sweep_params`` keeps one
    cast tree (compute.py:179). ``fused_norm_gate`` may switch the UNet's
    transformer entries to the fused kernel (same weights); the trainer
    switches them back."""

    which: str
    unet: UNet2DCondition
    vae: AutoencoderKL
    clip: CLIPTextModel
    tokenizer: CLIPTokenizer
    schedule: Schedule
    categories: List[str] = dataclasses.field(default_factory=list)
    dtype: torch.dtype = torch.bfloat16
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if fused_norm_gate(self.device) and not self.unet.config.fused_norm:
            self.unet.config = dataclasses.replace(self.unet.config, fused_norm=True)
        for m in (self.unet, self.vae, self.clip):
            m.to(device=self.device, dtype=self.dtype).eval().requires_grad_(False)
        self.schedule = self.schedule.to(self.device)
        self.country_features = CategoryFeatures(self.clip, self.tokenizer, self.which, self.device)
        cats = [""] + sorted(self.categories)
        cf = self.country_features.embed(cats)
        self.country_embeds = {c: cf[i] for i, c in enumerate(cats)}

    @classmethod
    def from_pipeline_dir(cls, which: str, path: str, categories: Sequence[str], dtype=torch.bfloat16,
                          device="cuda") -> "SD":
        p = load_pipeline_dir(path)
        tok_dir = p["tokenizer_dir"]
        if os.path.isfile(join(tok_dir, "vocab.json")):
            tokenizer = CLIPTokenizer.from_pretrained_dir(tok_dir)
        else:
            tokenizer = tiny_tokenizer(p["text_encoder"]["config"].vocab_size)
        unet = UNet2DCondition(p["unet"]["config"])
        load_state(unet, p["unet"]["state_dict"])
        vae = AutoencoderKL(p["vae"]["config"])
        load_state(vae, p["vae"]["state_dict"])
        clip = CLIPTextModel(p["text_encoder"]["config"])
        load_state(clip, p["text_encoder"]["state_dict"])
        return cls(which, unet, vae, clip, tokenizer, p["schedule"], list(categories), dtype, device)

    @classmethod
    def init_random(
        cls,
        which: str,
        categories: Sequence[str],
        unet_config: UNetConfig = SD15_UNET,
        vae_config: VAEConfig = SD15_VAE,
        clip_config: CLIPTextConfig = CLIP_VIT_L_TEXT,
        seed: int = 0,
        dtype=torch.bfloat16,
        device="cuda",
    ) -> "SD":
        """Random weights at any config, drawn on ``device`` from a
        generator seeded with ``seed``."""
        device = resolve_device(device)
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        with device:
            unet, vae, clip = UNet2DCondition(unet_config), AutoencoderKL(vae_config), CLIPTextModel(clip_config)
        for m in (unet, vae, clip):
            init_random_(m, g)
        return cls(which, unet, vae, clip, tiny_tokenizer(clip_config.vocab_size), make_schedule(),
                   list(categories), dtype, device)

    @torch.inference_mode()
    def encode_moments(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, 3, H, W] in [-1, 1] -> the VAE posterior (mean, logvar)."""
        return self.vae.encode(images.to(device=self.device, dtype=self.dtype))


Loader = Callable[[str], np.ndarray]


def sweep_images(sd: SD, engine: TypicalityEngine, draws: Callable, images: torch.Tensor, uids: Sequence[int],
                 ctx: torch.Tensor) -> torch.Tensor:
    """One same-shape group through the sweep: encode ``images`` [B, 3, H,
    W] in [-1, 1], draw each image's posterior eps and (eps, t) pairs with
    ``draws(uid, latent_shape)``, sample the latents and sweep them against
    ``ctx`` ([B, n_cond, L, D] or [n_cond, L, D]): losses [B, N, n_cond, C,
    h, w] fp16 on the device."""
    mean, logvar = sd.encode_moments(images)
    drawn = [draws(u, tuple(mean.shape[1:])) for u in uids]
    posterior, noises, ts = (torch.stack([d[i] for d in drawn]).to(sd.device) for i in range(3))
    latents = sample_latent(mean, logvar, posterior, sd.vae.config.scaling_factor)
    return engine.compute(latents, ctx, noises, ts)


class D:
    """Per-category typicality computation + .npy artifact store
    (reference compute.py:105-202).

    ``draws(uid, latent_shape) -> (posterior_eps, noise, t)`` supplies the
    random stream (default ``SeededDraws``); tests pass the JAX package's
    draws through it. With a ``mesh`` this rank sweeps and writes only its
    rows of each group (``TypicalityEngine.shard``)."""

    def __init__(
        self,
        sd: Optional[SD],
        typicality_path: str,
        which: str,
        seed: int = 42,
        N: int = 100,
        t_min: float = 0.0,
        t_max: float = 1.0,
        # chunk=1 with batch_images=8: a UNet batch of 8·1·2 = 16 per step
        chunk: int = 1,
        batch_images: int = 8,
        bucket_size: Optional[int] = None,
        native_res: bool = False,
        draws: Optional[Callable] = None,
        mesh: Optional[Mesh] = None,
    ):
        self.sd = sd
        self.mesh = mesh
        self.typicality_path = typicality_path
        self.which = which
        self.seed = seed
        self.N = N
        self.t_min = t_min
        self.t_max = t_max
        self.chunk = chunk
        self.batch_images = batch_images
        self.bucket_size = bucket_size
        self.native_res = native_res
        self._draws = draws
        self._engine: Optional[TypicalityEngine] = None

    @property
    def engine(self) -> TypicalityEngine:
        if self._engine is None:
            if self.sd is None:
                raise RuntimeError("a model-free D can only read artifacts")
            self._engine = TypicalityEngine(
                unet=self.sd.unet, schedule=self.sd.schedule, n_samples=self.N, chunk=self.chunk, mesh=self.mesh
            )
        return self._engine

    @property
    def draws(self) -> Callable:
        if self._draws is None:
            self._draws = SeededDraws(
                self.seed, self.N, self.t_min, self.t_max, self.sd.schedule.num_train_timesteps, self.sd.device
            )
        return self._draws

    # --- artifact store (same protocol as the reference) ---

    def get_path(self, path: str) -> str:
        name = os.path.split(path)[1]
        for ext in (".jpg", ".png", ".jpeg", ".JPG"):
            name = name.replace(ext, ".npy")
        return join(self.typicality_path, name)

    def exists(self, path: str) -> bool:
        return os.path.isfile(self.get_path(path))

    def __call__(self, path: str) -> np.ndarray:
        return np.load(self.get_path(path))

    # --- compute ---

    def _ctx_pair(self, country: str) -> torch.Tensor:
        """[2, 77, D] stack of [cond, null] embeddings, cond first
        (reference compute.py:187-188)."""
        emb = self.sd.country_embeds
        return torch.stack([emb[country], emb[""]], dim=0)

    def _load(self, path: str) -> np.ndarray:
        return load_image(path, self.which, self.bucket_size, native=self.native_res)[0]

    def compute_batch(self, items: Sequence[Tuple[str, str]], progress=None, load: Optional[Loader] = None) -> None:
        """Compute + save the grids of (path, category) items, batching
        same-shape images. ``load(path) -> [H, W, 3] float32 in [-1, 1]``
        decodes an image (default: ``load_image`` with the domain rules) and
        runs in a producer thread that overlaps the device work.
        ``progress(n_done)`` is called after each group is saved."""
        load = load or self._load
        by_shape: Dict[Tuple[int, int], List[Tuple[str, str, np.ndarray]]] = defaultdict(list)
        q: "queue.Queue" = queue.Queue(maxsize=2 * max(self.batch_images, 1))

        def producer():
            for path, country in items:
                try:
                    q.put((path, country, load(path)))
                except Exception as ex:  # skip unreadable images, keep the sweep alive
                    print(f"error {ex} @path={path}")
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        # one-deep save pipeline: group N+1 is queued on the device before
        # group N's artifacts are written on the host
        pending = None

        def drain(nxt):
            nonlocal pending
            if pending is not None:
                n = self._save_group(*pending)
                if progress is not None:
                    progress(n)
            pending = nxt

        while True:
            item = q.get()
            if item is None:
                break
            group = by_shape[item[2].shape[:2]]
            group.append(item)
            if len(group) >= self.batch_images:
                drain(self._dispatch_group(group))
                group.clear()
        for group in by_shape.values():
            if group:
                drain(self._dispatch_group(group))
        drain(None)
        t.join()

    def _compute_group(self, group: Sequence[Tuple[str, str, np.ndarray]]) -> None:
        self._save_group(*self._dispatch_group(group))

    def _dispatch_group(self, group: Sequence[Tuple[str, str, np.ndarray]]):
        """Encode, draw and sweep this rank's rows of one same-shape group;
        the fetch to the host is queued behind the sweep and awaited in
        ``_save_group``. Returns the paths this rank writes (its real rows),
        the group's count of real images and the fetch."""
        n_real = len(group)
        # pad partial groups to the full batch by repeating the last item, so
        # every sweep runs the same batch and artifacts do not depend on how
        # the work queue grouped them (compute.py:364-373)
        if n_real < self.batch_images:
            group = list(group) + [group[-1]] * (self.batch_images - n_real)
        group, rows = self.engine.shard(group)
        local = group[rows]
        if not local:  # a rank outside the mesh
            return [], n_real, (None, None)
        # the real rows among this rank's: each real image is written once
        # across the ranks (the JAX package's multi-host rule, compute.py:405-416)
        mine = local[:max(0, n_real - rows.start)]
        paths = [g[0] for g in local]
        images = torch.from_numpy(np.stack([g[2] for g in local])).permute(0, 3, 1, 2)
        ctx = torch.stack([self._ctx_pair(g[1]) for g in local])
        with annotate("typicality group"):
            losses = sweep_images(self.sd, self.engine, self.draws, images, [image_uid(p) for p in paths], ctx)
        host = losses[:len(mine)].to("cpu", non_blocking=True)  # [b, N, 2, C, h, w]
        done = None
        if losses.is_cuda:
            done = torch.cuda.Event()
            done.record()
        return [g[0] for g in mine], n_real, (host, done)

    def _save_group(self, paths, n_real: int, fetched) -> int:
        """Wait for one dispatched group's fetch and write the artifacts of
        ``paths``; returns the group's count of real images."""
        host, done = fetched
        if done is not None:
            done.synchronize()
        os.makedirs(self.typicality_path, exist_ok=True)
        for b, path in enumerate(paths):
            atomic_save_npy(self.get_path(path), losses_to_reference_layout(host[b]))
        return n_real


class Typicality:
    """Dataset scanning + submission work queue + sweep driver
    (reference compute.py:210-341). ``mesh`` shards every group's sweep
    over the process group's ranks; every rank runs ``compute_submission``
    on the same shard file."""

    def __init__(
        self,
        which: str,
        model_path: Optional[str],
        dataset_path: str,
        typicality_path: str,
        t_min: float = 0.0,
        t_max: float = 1.0,
        sd: Optional[SD] = None,
        N: int = 100,
        batch_images: int = 8,
        chunk: int = 1,
        bucket_size: Optional[int] = None,
        native_res: bool = False,
        dtype=torch.bfloat16,
        device="cuda",
        draws: Optional[Callable] = None,
        mesh: Optional[Mesh] = None,
    ):
        self.which = which
        self.mesh = mesh
        self.native_res = native_res
        load = {
            "geo": self.load_paths_geo,
            "ftt": self.load_paths_ftt,
            "cars": self.load_paths_cars,
            "places": self.load_paths_places,
        }[which]
        load(dataset_path)
        if sd is None and model_path is not None:
            sd = SD.from_pipeline_dir(which, model_path, self.categories(), dtype=dtype, device=device)
        self.sd = sd
        self.D = {
            c: D(
                self.sd, join(typicality_path, c), which=which, t_min=t_min, t_max=t_max,
                N=N, batch_images=batch_images, chunk=chunk,
                bucket_size=bucket_size, native_res=native_res, draws=draws, mesh=mesh,
            )
            for c in self.categories()
        }

    # --- path loaders (the reference's directory protocols, compute.py:222-341) ---

    def load_paths_geo(self, dataset_path: str) -> None:
        """gt--{country}__{sid}.jpg / {country}__{sid}.jpg protocol."""
        self.parent: Dict[str, Dict[str, Any]] = {}
        self.country_path: Dict[str, List[Tuple[str, bool]]] = defaultdict(list)
        for country_parent in sorted(os.listdir(dataset_path)):
            seed_base, seeds = {}, defaultdict(list)
            output_dir = join(dataset_path, country_parent)
            if not os.path.isdir(output_dir):
                continue
            for seed in sorted(os.listdir(output_dir)):
                sid = "__".join(seed.replace(".jpg", "").split("__")[1:])
                country = seed.split("__")[0]
                if country.startswith("gt--"):
                    country = country.replace("gt--", "")
                    self.country_path[country].append((join(output_dir, seed), True))
                    seed_base[sid] = join(output_dir, seed)
                elif "--" not in country:
                    self.country_path[country].append((join(output_dir, seed), False))
                    seeds[sid].append(join(output_dir, seed))
            self.parent[country_parent] = {"base": seed_base, "neighbors": seeds}

        self.parallel: Dict[str, List[Any]] = defaultdict(list)
        for country, d in self.parent.items():
            for k, v in d["base"].items():
                data = [(v, country)] + [
                    (n, os.path.split(n)[1].split("_")[0]) for n in d["neighbors"][k]
                ]
                self.parallel[country].append(data)

    def load_paths_ftt(self, dataset_path: str) -> None:
        self.times: Dict[str, List[str]] = defaultdict(list)
        for t in sorted(os.listdir(dataset_path)):
            if not os.path.isdir(join(dataset_path, t)):
                continue
            for path in sorted(os.listdir(join(dataset_path, t))):
                self.times[t].append(join(dataset_path, t, path))

    def load_paths_cars(self, dataset_path: str) -> None:
        self.times = defaultdict(list)
        with open(dataset_path + ".json", "r") as f:
            self.metadata = json.load(f)
        for image in sorted(os.listdir(dataset_path)):
            self.times[get_decade(self.metadata[image]["year"])].append(join(dataset_path, image))

    def load_paths_places(self, dataset_path: str) -> None:
        self.parent = defaultdict(list)
        categories = {}
        with open(join(dataset_path, "categories_places365.txt"), "r") as f:
            for line in f.readlines():
                path, category_id = line.strip().split(" ")
                categories[category_id] = "_".join(path.split("/")[2:])
        with open(join(dataset_path, "places365_val.txt"), "r") as f:
            for line in f.readlines():
                path, category_id = line.strip().split(" ")
                self.parent[categories[category_id]].append(join(dataset_path, "images", path))

    def categories(self) -> List[str]:
        if self.which in ("geo", "places"):
            return sorted(self.parent.keys())
        return sorted(self.times.keys())

    def get_seeds_(self, c: str) -> List[str]:
        if self.which in ("ftt", "cars"):
            return list(self.times[c])
        if self.which == "places":
            return list(self.parent[c])
        return [p for p, is_gt in self.country_path[c] if is_gt]

    # --- work queue (reference compute.py:284-341) ---

    def compute_submission(self, path: str, load: Optional[Loader] = None) -> None:
        """Execute one shard file, batching per category; prints progress and
        throughput (rank 0 of a mesh only). ``load`` replaces image decoding
        (see D.compute_batch)."""
        with open(path, "r") as f:
            lines = [l.strip() for l in f.readlines() if l.strip()]
        by_cat: Dict[str, List[Tuple[str, str]]] = defaultdict(list)
        for line in lines:
            p, country = line.split(",")
            by_cat[country].append((p, country))
        todo = {c: [it for it in items if not self.D[c].exists(it[0])] for c, items in by_cat.items()}
        # every rank has read which artifacts exist before any writes one:
        # a late rank would otherwise skip images an early rank just wrote,
        # form other groups and wait at another barrier for good
        host_barrier("typicality_todo")
        total = sum(len(v) for v in todo.values())
        state = {"done": 0, "t0": time.perf_counter()}
        quiet = self.mesh is not None and self.mesh.rank != 0

        def progress(n):
            if quiet:
                return
            state["done"] += n
            dt = time.perf_counter() - state["t0"]
            rate = state["done"] / dt * 3600.0 if dt > 0 else 0.0
            print(f"typicality: {state['done']}/{total} images ({rate:,.0f} imgs/hr)", flush=True)

        for country, pending in todo.items():
            if pending:
                self.D[country].compute_batch(pending, progress=progress, load=load)

    def make_submission(self, target_path: str, submission_path: str, seed: int = 42, sub_split: int = 32) -> None:
        """Greedy least-done-category balancing, round-robin into shard files
        (reference compute.py:300-341; ``seed`` is accepted for CLI parity and
        never drawn from)."""
        full = {c: [] for c in self.categories()}
        state = {c: 0 for c in self.categories()}
        for c in self.categories():
            for path in self.get_seeds_(c):
                if self.D[c].exists(path):
                    state[c] += 1
                else:
                    full[c].append(path)

        subs = []
        while any(map(len, full.values())):
            category = min(state, key=state.get)
            try:
                path = full[category].pop(0)
            except IndexError:
                del full[category]
                del state[category]
                continue
            state[category] -= 1
            if not self.D[category].exists(path):
                a, b = os.path.split(path)
                if self.which == "cars":
                    path = join(target_path, b)
                else:
                    path = join(target_path, os.path.split(a)[1], b)
                subs.append((path, category))

        os.makedirs(submission_path, exist_ok=True)
        for i in range(sub_split):
            with open(join(submission_path, f"{i}.txt"), "w") as f:
                for path, country in subs[i::sub_split]:
                    f.write(f"{path},{country}\n")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Typicality sweep on the GPU (reference compute.py CLI)")
    parser.add_argument("-s", "--submission_path", required=True)
    parser.add_argument("-i", "--dataset_path", required=True)
    parser.add_argument("-t", "--target_path", default=None)
    parser.add_argument("-m", "--model_path", default=None)
    parser.add_argument("-c", "--typicality_path", required=True)
    parser.add_argument("--which", required=True, choices=["geo", "ftt", "cars", "places"])
    parser.add_argument("--make_submission", action="store_true")
    parser.add_argument("--sub_split", type=int, default=1)
    parser.add_argument("--split_id", type=int, default=0)
    parser.add_argument("--t_min", type=float, default=0.1)
    parser.add_argument("--t_max", type=float, default=0.9)
    parser.add_argument("--N", type=int, default=100)
    parser.add_argument("--batch_images", type=int, default=8)
    parser.add_argument("--chunk", type=int, default=1,
                        help="(image, sample) pairs per UNet call; UNet batch = batch_images*chunk*2")
    parser.add_argument("--bucket_size", type=int, default=None)
    parser.add_argument("--native_res", action="store_true",
                        help="sweep at the dataset's original resolution instead of the "
                        "reference's cars-256/places-512 downscale")
    parser.add_argument("--mesh_dp", type=int, default=None,
                        help="shard each group's sweep over this many ranks of the process group, one GPU "
                             "each (default under --distributed: every rank)")
    # several processes, one a GPU (or CPU processes over gloo): a process
    # group from torchrun's environment, or from an explicit address
    parser.add_argument("--distributed", action="store_true",
                        help="join a process group (torchrun's environment unless --coordinator_address)")
    parser.add_argument("--coordinator_address", type=str, default=None,
                        help="host:port of process 0 (implies --distributed)")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--dont_compute", action="store_false")
    parser.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help="write a torch.profiler trace of the sweep to DIR/trace_rank{r}.json "
                             "(Chrome trace format)")
    parser.add_argument("--dtype", type=str, default="bf16", choices=sorted(DTYPES),
                        help="compute dtype: bf16 (default), or fp32 for validation runs and "
                             "cross-topology comparisons (no TF32); both run on the GPU (float32 flash "
                             "kernels) and with --device cpu")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--countries", nargs="*", default=None)  # reference CLI parity; unused there too
    args = parser.parse_args(argv)
    try:
        _run(args)
    finally:
        destroy()


def _run(args) -> None:
    mesh = cli_mesh("typicality", args.mesh_dp, args.device, distributed=args.distributed,
                    coordinator_address=args.coordinator_address, num_processes=args.num_processes,
                    process_id=args.process_id)

    model_path = args.model_path
    if model_path is not None and not os.path.isfile(join(model_path, "model_index.json")):
        if not os.path.isfile(join(model_path, "state.pt")):
            raise SystemExit(
                f"--model_path {model_path} has no model_index.json and is not a finetuning "
                "checkpoint (checkpoint-N/state.pt)"
            )
        from diffmining_tpu_torch.finetuning.export import export_model

        if is_writer(mesh):  # one writer; the others read its export
            export_model(args.which, model_path, device=args.device)
        host_barrier("typicality_export")
        model_path = export_model(args.which, model_path, device=args.device)
    if args.target_path is None:
        args.target_path = args.dataset_path

    typ = Typicality(
        args.which, model_path, args.dataset_path, args.typicality_path,
        t_min=args.t_min, t_max=args.t_max, N=args.N,
        batch_images=args.batch_images, chunk=args.chunk,
        bucket_size=args.bucket_size, native_res=args.native_res,
        dtype=DTYPES[args.dtype], device=args.device, mesh=mesh,
    )
    if args.make_submission:
        # one writer for the shard files, then a barrier so no rank reads a
        # half-written one (compute.py:720-727)
        if is_writer(mesh):
            typ.make_submission(args.target_path, args.submission_path, sub_split=args.sub_split)
        host_barrier("typicality_submission")
    if args.dont_compute:
        if model_path is None:
            raise SystemExit("computing typicality needs --model_path")
        sub_file = join(args.submission_path, f"{args.split_id}.txt")
        if args.profile:
            with trace(args.profile), Timer("typicality sweep (traced)"):
                typ.compute_submission(sub_file)
        else:
            typ.compute_submission(sub_file)


if __name__ == "__main__":
    main()
