"""DIFT featurizer: SD UNet up-block features as patch descriptors
(counterpart of diffmining_tpu/typicality/dift.py).

    feat = mean_{e<E}[ unet(add_noise(vae(x), eps_e, t), t, emb).up_ft[i] ]

One UNet pass at batch E per image, with the UNet's ``up_ft_indices`` taps.
Defaults match the reference: t=261 generic, t=161 in the mining pipeline
("dift-161"), up_ft_index=1, ensemble_size=8 (dift.py:214-219,
cluster.py:253). The random draws are arguments: ``draws(uid,
latent_shape, ensemble_size) -> (vae_eps [C,h,w], noise [E,C,h,w])``,
default ``DiftDraws`` (one ``torch.Generator`` per image and stream); the
tests pass the JAX package's draws through it.

With a mesh the E draws shard over dp, as JAX shards them (dift.py:30-104):
every rank draws all E and runs the UNet on its E/dp, and the ranks'
float32 sums of the taps meet in ``all_reduce_sum``; the VAE encode and the
CLIP context are computed on every rank, and the per-image cache is each
rank's own (every rank walks the same images in the same order).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from diffmining_tpu_torch.diffusion.schedule import add_noise
from diffmining_tpu_torch.models.vae import sample_latent
from diffmining_tpu_torch.parallel.mesh import Mesh, all_reduce_sum, collective_rows
from diffmining_tpu_torch.typicality.compute import SD
from diffmining_tpu_torch.typicality.engine import derive_seed


@dataclasses.dataclass
class DiftDraws:
    """Default random stream: for image ``uid``, the VAE posterior eps from
    a generator seeded (seed, 11, uid) and the E ensemble noises from one
    seeded (seed, 13, uid), the streams JAX folds in (dift.py:81-88)."""

    seed: int
    device: torch.device

    def __call__(self, uid: int, latent_shape: Tuple[int, ...], ensemble_size: int):
        g = torch.Generator(device=self.device)
        g.manual_seed(derive_seed(self.seed, 11, uid))
        vae_eps = torch.randn(latent_shape, generator=g, device=self.device)
        g.manual_seed(derive_seed(self.seed, 13, uid))
        noise = torch.randn((ensemble_size, *latent_shape), generator=g, device=self.device)
        return vae_eps, noise


class SDFeaturizer:
    """Prompt-conditioned one-step UNet feature extractor. ``n_passes``
    counts the UNet passes (one per image not in the cache)."""

    def __init__(self, sd: SD, seed: int = 42, image_cache_size: int = 8, mesh: Optional[Mesh] = None,
                 draws: Optional[Callable] = None):
        self.sd = sd
        self.seed = seed
        self.mesh = mesh
        self.draws = draws or DiftDraws(seed, sd.device)
        # per-image feature maps: the reference recomputes the whole image's
        # ensemble for every patch (cluster.py:291-299); the top patches of
        # one image share one map here
        self._image_cache: "dict[tuple, np.ndarray]" = {}
        self._image_cache_size = image_cache_size
        self.n_passes = 0

    @torch.inference_mode()
    def forward(self, img_array: np.ndarray, prompt: str, t: int = 261, up_ft_index: int = 1,
                ensemble_size: int = 8, uid: Optional[int] = None) -> np.ndarray:
        """img_array [H, W, 3] in [-1, 1] -> feature map [h_f, w_f, C_f] fp32."""
        sd = self.sd
        dp = 1 if self.mesh is None else self.mesh.dp
        if ensemble_size % dp:
            raise ValueError(f"ensemble_size={ensemble_size} must divide over dp={dp} (no unsharded fallback)")
        uid = 0 if uid is None else uid
        img = torch.as_tensor(np.asarray(img_array, np.float32)).permute(2, 0, 1)[None]
        mean, logvar = sd.encode_moments(img)
        vae_eps, noise = (d.to(sd.device) for d in self.draws(uid, tuple(mean.shape[1:]), ensemble_size))
        latent = sample_latent(mean, logvar, vae_eps[None], sd.vae.config.scaling_factor)[0]
        ids = torch.from_numpy(np.asarray(sd.tokenizer([prompt]))).long().to(sd.device)
        ctx = sd.clip(ids)[0].float()
        # every rank drew all E noises; it runs the UNet on its own E/dp
        noise = noise[collective_rows(ensemble_size, self.mesh)]
        ts = torch.full((noise.shape[0],), int(t), dtype=torch.long, device=sd.device)
        lat = latent[None].expand(noise.shape[0], *latent.shape)
        noisy = add_noise(sd.schedule, lat, noise, ts).to(sd.dtype)
        ctx_b = ctx[None].expand(noise.shape[0], *ctx.shape).to(sd.dtype)
        out = sd.unet(noisy, ts, ctx_b, up_ft_indices=(up_ft_index,))
        self.n_passes += 1
        taps = out["up_ft"][up_ft_index].float().sum(dim=0)  # [C_f, h_f, w_f]
        feat = all_reduce_sum(taps, self.mesh) / ensemble_size
        return feat.permute(1, 2, 0).cpu().numpy()

    def patch_feature(self, img_array: np.ndarray, prompt: str, box: Tuple[int, int, int, int], t: int = 261,
                      up_ft_index: int = 1, ensemble_size: int = 8, uid: Optional[int] = None) -> np.ndarray:
        """The whole image's feature map cropped to ``box`` in feature space,
        averaged over the crop and L2-normalised (reference cluster.py:
        291-299). box = (x_start, y_start, x_end, y_end) in image pixels, x
        the row."""
        cache_uid = uid if uid is not None else hash(img_array.tobytes())
        key = (cache_uid, prompt, t, up_ft_index, ensemble_size, img_array.shape)
        feat = self._image_cache.get(key)
        if feat is None:
            feat = self.forward(img_array, prompt, t, up_ft_index, ensemble_size, uid)
            if len(self._image_cache) >= self._image_cache_size:
                self._image_cache.pop(next(iter(self._image_cache)))
            self._image_cache[key] = feat
        H, W = img_array.shape[:2]
        h, w = feat.shape[:2]
        x0, y0, x1, y1 = box
        rx, ry = h / H, w / W
        fx0, fx1 = int(x0 * rx), max(int(x1 * rx), int(x0 * rx) + 1)
        fy0, fy1 = int(y0 * ry), max(int(y1 * ry), int(y0 * ry) + 1)
        emb = feat[fx0:fx1, fy0:fy1].mean(axis=(0, 1))
        return emb / max(np.linalg.norm(emb), 1e-12)
