"""Plug-and-Play cross-label translation (counterpart of
diffmining_tpu/applications/pnp.py; reference diffmining/applications/
parallel-dataset/pnp.py).

  * DDIM inversion of the VAE posterior MEAN (x 0.18215) over 999 steps with
    the empty inversion prompt, keeping the whole latent trajectory
    (pnp.py:157-180);
  * 50-step DDIM sampling with CFG 7.5 in which the source image's
    activations are injected: the resnet residual branches of up block 1
    (``RBF``) for the first 80% of the steps, the self-attention q/k of up
    blocks 1-3 (``RBG``) for the first 50% (pnp.py:480-487, 560-569,
    628-631);
  * the gt--/inverted--/projected-- files per source image
    (pnp.py:605-627).

The source pass runs once a step at batch 1 with ``collect_injection``; the
[uncond; cond] pass takes its taps through the UNet's ``injection``
argument, each gated by the step (the UNet's (value, gate) form). A step
whose gates are both off skips the source pass: its taps would not be
used. ``DIFFMINING_PNP_DEDUP=1`` runs the CFG pass with the conditions
interleaved and ``ctx_tile=2`` (default off, as in the JAX package).
"""
from __future__ import annotations

import argparse
import os
from os.path import join
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from PIL import Image

from diffmining_tpu_torch.diffusion.sampling import ddim_inversion
from diffmining_tpu_torch.diffusion.schedule import ddim_step, ddim_timesteps
from diffmining_tpu_torch.typicality.compute import DTYPES, SD
from diffmining_tpu_torch.utils.artifacts import atomic_save_npz
from diffmining_tpu_torch.utils.images import array_from_uint8, tensor_to_images

# injection sites (reference pnp.py:628-631)
RBF = {1: [1]}  # resnet residual branches
RBG = {1: [1, 2], 2: [0, 1, 2], 3: [0, 1, 2]}  # self-attention q/k

CONF = dict(seed=1, guidance_scale=7.5, n_timesteps=50, pnp_attn_t=0.5, pnp_f_t=0.8)


def _res_keys() -> List[str]:
    return [f"up.{r}.res.{b}" for r, blocks in RBF.items() for b in blocks]


def _attn_keys() -> List[str]:
    out = []
    for r, blocks in RBG.items():
        for b in blocks:
            out += [f"up.{r}.tf.{b}.0.attn1.q", f"up.{r}.tf.{b}.0.attn1.k"]
    return out


class PNP:
    """Translator over inverted sources: ``invert`` once (one image or a
    same-shape stack), then ``generate(target_prompts, source=s)`` as often
    as needed (reference Generator/PNP classes)."""

    def __init__(self, sd: SD, inversion_steps: int = 999, n_timesteps: int = 50,
                 guidance_scale: float = 7.5, pnp_attn_t: float = 0.5, pnp_f_t: float = 0.8,
                 dedup_prefix: Optional[bool] = None):
        self.sd = sd
        self.inversion_steps = inversion_steps
        self.n_timesteps = n_timesteps
        self.guidance_scale = guidance_scale
        self.pnp_attn_t = pnp_attn_t
        self.pnp_f_t = pnp_f_t
        if dedup_prefix is None:
            dedup_prefix = os.environ.get("DIFFMINING_PNP_DEDUP", "0") == "1"
        self.dedup_prefix = bool(dedup_prefix)
        self._source_latent: Optional[torch.Tensor] = None  # [S, C, h, w] inverted endpoints
        self._trajectory: Optional[torch.Tensor] = None  # [T, S, C, h, w]; [i] is level i + 1
        self._clean_latent: Optional[torch.Tensor] = None  # [S, C, h, w] float32

    def _eps(self, x, t, ctx, **kw):
        dt = self.sd.dtype
        return self.sd.unet(x.to(dt), t, ctx.to(dt), **kw)

    @torch.inference_mode()
    def embed(self, prompts: Sequence[str]) -> torch.Tensor:
        ids = torch.from_numpy(self.sd.tokenizer(list(prompts))).long().to(self.sd.device)
        return self.sd.clip(ids).float()

    def encode_image_mean(self, img_array: np.ndarray) -> torch.Tensor:
        """VAE posterior MEAN x scaling, float32 (reference pnp.py:150-155:
        the mean, not a draw, so inversion is deterministic). Takes one image
        [H, W, 3] or a stack [S, H, W, 3] in [-1, 1]."""
        arr = torch.as_tensor(np.asarray(img_array, dtype=np.float32))
        if arr.ndim == 3:
            arr = arr[None]
        mean, _ = self.sd.encode_moments(arr.permute(0, 3, 1, 2))
        return mean.float() * self.sd.vae.config.scaling_factor

    def invert(self, img_array: np.ndarray, inversion_prompt: str = "") -> None:
        """The inversion of one image or a same-shape stack, as one batch of
        S rows (per-source math is unchanged; the reference inverts one
        image at a time)."""
        lat = self.encode_image_mean(img_array)
        ctx = self.embed([inversion_prompt]).expand(lat.shape[0], -1, -1)
        x_T, traj = ddim_inversion(self._eps, self.sd.schedule, lat.to(self.sd.dtype), ctx,
                                   num_steps=self.inversion_steps)
        self._source_latent, self._trajectory, self._clean_latent = x_T, traj, lat

    def num_sources(self) -> int:
        if self._source_latent is None:
            raise RuntimeError("call invert() first")
        return int(self._source_latent.shape[0])

    def _check_source(self, source: int) -> None:
        if not 0 <= source < self.num_sources():
            raise IndexError(f"source={source} out of range (have {self.num_sources()} inverted sources)")

    @torch.no_grad()
    def reconstruct_images(self, source_latent: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Every inverted source sampled back down all inversion steps with
        the empty prompt (no CFG), in one batch, and decoded: [S, 3, H, W]
        float32 (the reference's 'inverted--' image, pnp.py:214-216)."""
        x = self._source_latent if source_latent is None else source_latent
        if x is None:
            raise RuntimeError("call invert() first")
        S = x.shape[0]
        ctx = self.embed([""]).expand(S, -1, -1)
        ts = list(range(self.inversion_steps, 0, -1))
        for t, t_prev in zip(ts, ts[1:] + [-1]):
            eps = self._eps(x, torch.full((S,), t, dtype=torch.long, device=x.device), ctx)
            x = ddim_step(self.sd.schedule, x, eps, t, t_prev)
        return self.sd.vae.decode(x.to(self.sd.dtype)).float()

    def reconstruct_many(self, source_latent: Optional[torch.Tensor] = None) -> List[Image.Image]:
        return tensor_to_images(self.reconstruct_images(source_latent))

    def reconstruct(self, source: int = 0) -> Image.Image:
        self._check_source(source)
        return self.reconstruct_many(self._source_latent[source:source + 1])[0]

    @torch.no_grad()
    def translate(self, target_prompts: Sequence[str], uncond_prompt: str = "", source: int = 0) -> torch.Tensor:
        """Inverted source ``source`` translated to each target prompt, decoded:
        [B, 3, H, W] float32."""
        if self._trajectory is None:
            raise RuntimeError("call invert() first")
        self._check_source(source)
        sd, dt = self.sd, self.sd.dtype
        B = len(target_prompts)
        cond = self.embed(list(target_prompts))
        uncond1 = self.embed([uncond_prompt])
        traj = self._trajectory[:, source:source + 1]
        x = self._source_latent[source:source + 1].expand(B, -1, -1, -1).to(dt)
        n = self.n_timesteps
        ts = [int(t) for t in ddim_timesteps(n, sd.schedule.num_train_timesteps)]
        n_res, n_attn = int(n * self.pnp_f_t), int(n * self.pnp_attn_t)
        uncond_b = uncond1.expand_as(cond)
        if self.dedup_prefix:
            # entry i -> rows 2i (uncond) and 2i + 1 (cond): ctx_tile's layout
            ctx = torch.stack([uncond_b, cond], dim=1).reshape(2 * B, *cond.shape[1:])
        else:
            ctx = torch.cat([uncond_b, cond], dim=0)
        for step, (t, t_prev) in enumerate(zip(ts, ts[1:] + [-1])):
            rg, ag = step < n_res, step < n_attn
            inj = None
            if rg or ag:
                # the source at level t; a short inversion (fewer stored
                # levels than t) gives its highest level
                src = traj[min(t, traj.shape[0]) - 1]
                taps = self._eps(src, torch.full((1,), t, dtype=torch.long, device=x.device), uncond1,
                                 collect_injection=True)["taps"]
                # small configs have fewer blocks than the SD-scale tables name
                inj = {k: (taps[k], rg) for k in _res_keys() if k in taps}
                inj.update({k: (taps[k], ag) for k in _attn_keys() if k in taps})
            if self.dedup_prefix:
                eps = self._eps(x, torch.full((B,), t, dtype=torch.long, device=x.device), ctx, injection=inj,
                                ctx_tile=2).float()
                eps_u, eps_c = eps[0::2], eps[1::2]
            else:
                eps = self._eps(torch.cat([x, x]), torch.full((2 * B,), t, dtype=torch.long, device=x.device), ctx,
                                injection=inj).float()
                eps_u, eps_c = eps.chunk(2, dim=0)
            eps_g = eps_u + self.guidance_scale * (eps_c - eps_u)
            x = ddim_step(sd.schedule, x, eps_g.to(x.dtype), t, t_prev)
        return sd.vae.decode(x).float()

    def generate(self, target_prompts: Sequence[str], uncond_prompt: str = "", source: int = 0) -> List[Image.Image]:
        """Translate inverted source ``source`` to each target prompt."""
        return tensor_to_images(self.translate(target_prompts, uncond_prompt, source))


class Generator:
    """Filesystem protocol around PNP (reference Generator/plotum,
    pnp.py:580-627): writes the gt--, inverted--, projected--/{c}_ files.

    Takes one image path or a list of SAME-SHAPE paths: a group inverts and
    reconstructs as one batch; the translations run per source. With
    ``cache_dir``, each source's inversion is kept as a float32 .npz
    (reference pnp.py:263-267) and a later run with the same
    ``inversion_steps`` loads it instead of inverting."""

    def __init__(self, sd: SD, image_path, inversion_steps: int = 999, n_timesteps: int = 50,
                 cache_dir: Optional[str] = None):
        self.sd = sd
        paths = [image_path] if isinstance(image_path, str) else list(image_path)
        self.image_paths = paths
        self.countries_of = [os.path.split(os.path.split(p)[0])[1] for p in paths]
        self.pre_heads = ["_".join(os.path.split(p)[-1].split("_")[1:]) for p in paths]
        self.pils = [Image.open(p).convert("RGB") for p in paths]
        arrs = np.stack([array_from_uint8(np.asarray(pil)) for pil in self.pils])
        self.pnp = PNP(sd, inversion_steps=inversion_steps, n_timesteps=n_timesteps)
        cfiles = None
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
            cfiles = [join(cache_dir, f"{c}_{ph}.inv{inversion_steps}.npz")
                      for c, ph in zip(self.countries_of, self.pre_heads)]
        if cfiles and all(os.path.isfile(f) for f in cfiles):
            data = [np.load(f) for f in cfiles]
            dev, dt = sd.device, sd.dtype
            self.pnp._source_latent = torch.from_numpy(np.stack([d["x_T"] for d in data])).to(dev, dt)
            self.pnp._trajectory = torch.from_numpy(np.stack([d["traj"] for d in data], axis=1)).to(dev, dt)
            self.pnp._clean_latent = torch.from_numpy(np.stack([d["clean"] for d in data])).to(dev)
        else:
            self.pnp.invert(arrs, inversion_prompt="")
            for s, f in enumerate(cfiles or []):
                atomic_save_npz(
                    f,
                    x_T=self.pnp._source_latent[s].float().cpu().numpy(),
                    traj=self.pnp._trajectory[:, s].float().cpu().numpy(),
                    clean=self.pnp._clean_latent[s].float().cpu().numpy(),
                )

    def plotum(self, dir_path: str, countries: Sequence[str], batch_size: int = 10,
               format_text: Callable[[str], str] = "{}".format) -> None:
        os.makedirs(dir_path, exist_ok=True)
        inverted = self.pnp.reconstruct_many()  # one batch for the group
        for s, (country, pre_head) in enumerate(zip(self.countries_of, self.pre_heads)):
            self.pils[s].save(join(dir_path, f"gt--{country}_{pre_head}"))
            inverted[s].save(join(dir_path, f"inverted--{country}_{pre_head}"))
            for i in range(0, len(countries), batch_size):
                batch = list(countries[i:i + batch_size])
                images = self.pnp.generate([format_text(c) for c in batch], source=s)
                for c, image in zip(batch, images):
                    name = f"projected--{c}_{pre_head}" if c == country else f"{c}_{pre_head}"
                    image.save(join(dir_path, name))


COUNTRIES = [
    "United States", "Japan", "France", "Italy", "United Kingdom",
    "Brazil", "Russia", "Thailand", "Nigeria", "India",
]


def main(argv=None):
    p = argparse.ArgumentParser(description="PnP translation on the GPU (reference pnp.py CLI)")
    p.add_argument("--idx_start", type=int, default=0)
    p.add_argument("--k_start", type=int, default=0)
    p.add_argument("--k_end", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=10)
    p.add_argument("--save_dir", type=str, default="dataset/parallel")
    p.add_argument("--model_path", type=str, default="models/export")
    p.add_argument("--base_path", type=str, default="dataset/base")
    p.add_argument("--inversion_steps", type=int, default=999)
    p.add_argument("--batch_sources", type=int, default=4,
                   help="invert/reconstruct this many same-shape source images as one batch "
                        "(1 = the reference's one image at a time)")
    p.add_argument("--cache", type=str, default=None,
                   help="keep each source's inversion trajectory here (~65 MB float32 per 512px "
                        "source) so an interrupted job resumes without inverting again")
    p.add_argument("--dtype", type=str, default="bf16", choices=sorted(DTYPES),
                   help="compute dtype: bf16 on the GPU; fp32 for validation runs with --device cpu")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    sd = SD.from_pipeline_dir("geo", args.model_path, [], dtype=DTYPES[args.dtype], device=args.device)
    for country in COUNTRIES[args.idx_start:args.idx_start + 1]:
        path = join(args.base_path, country)
        dir_path = join(args.save_dir, country)
        pending = []
        for fname in sorted(os.listdir(path))[args.k_start:args.k_end]:
            pre_head = "_".join(fname.split("_")[1:])
            expected = [join(dir_path, f"inverted--{country}_{pre_head}"), join(dir_path, f"gt--{country}_{pre_head}")]
            expected += [join(dir_path, f"projected--{c}_{pre_head}" if c == country else f"{c}_{pre_head}")
                         for c in COUNTRIES]
            if all(os.path.isfile(pp) for pp in expected):
                continue  # an idempotent work queue (reference pnp.py:655-669)
            pending.append(join(path, fname))
        sizes = []
        for pth in pending:
            with Image.open(pth) as im:  # the header only
                sizes.append(im.size)
        i = 0
        while i < len(pending):
            # same-shape sources batch into one inversion
            group = [pending[i]]
            while (len(group) < max(args.batch_sources, 1) and i + len(group) < len(pending)
                   and sizes[i + len(group)] == sizes[i]):
                group.append(pending[i + len(group)])
            g = Generator(sd, group, inversion_steps=args.inversion_steps, cache_dir=args.cache)
            g.plotum(dir_path, COUNTRIES, batch_size=args.batch_size)
            i += len(group)


if __name__ == "__main__":
    main()
