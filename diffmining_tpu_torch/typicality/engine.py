"""The typicality engine: paired cond/null eps-prediction sweeps (counterpart
of diffmining_tpu/typicality/engine.py).

    losses[b, n, c] = (unet(add_noise(x_b, eps_{b,n}, t_{b,n}), t_{b,n}, emb_c)
                       − eps_{b,n})²      (elementwise, fp32, stored fp16)

A Python loop over sample chunks; within a chunk the UNet batch is
B·chunk·n_cond with the conditions of one (image, sample) adjacent, and the
condition-independent UNet prefix runs once per (image, sample) (the
``ctx_tile`` dedup, equal to tiling up front: tests/test_torch_port_unet.py);
``DIFFMINING_SWEEP_DEDUP=0`` (or ``TypicalityEngine(dedup_prefix=False)``)
tiles the noisy latents and timesteps up front instead, as the reference
does (JAX engine.py:103-126). The sweep takes its random draws as arguments; ``draw``
makes them from a ``torch.Generator`` (the counterpart of
``sample_noise_and_t``), and ``SeededDraws`` seeds one generator per image
from (seed, image uid), so an image's draws do not depend on its group.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from diffmining_tpu_torch.diffusion.schedule import Schedule, add_noise
from diffmining_tpu_torch.models.unet import UNet2DCondition
from diffmining_tpu_torch.parallel.mesh import Mesh, host_local_batch_slice, pad_to_multiple

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def derive_seed(*parts: int) -> int:
    """A 64-bit generator seed from integers (seed, stream, uid, ...)."""
    h = 0
    for p in parts:
        h = _splitmix64(h ^ (int(p) & _M64))
    return h


def draw(
    generator: torch.Generator,
    n_samples: int,
    latent_shape: Tuple[int, ...],
    t_min: float,
    t_max: float,
    num_train_timesteps: int = 1000,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """N (eps, t) pairs for one image: eps [N, C, h, w] fp32, t [N] int64
    uniform on {int(t_min*T) .. int(t_max*T)-1}, the reference's range
    (compute.py:118-120); on the generator's device."""
    lo = int(t_min * num_train_timesteps)
    hi = max(int(t_max * num_train_timesteps), lo + 1)
    dev = generator.device
    noise = torch.randn((n_samples, *latent_shape), generator=generator, device=dev, dtype=torch.float32)
    t = torch.randint(lo, hi, (n_samples,), generator=generator, device=dev)
    return noise, t


@dataclasses.dataclass
class SeededDraws:
    """Default random stream of the sweep: for image ``uid``, the VAE
    posterior eps from a generator seeded (seed, 7, uid) and the (eps, t)
    draws from one seeded (seed, uid). Callable as
    ``draws(uid, latent_shape) -> (posterior_eps [C,h,w], noise [N,C,h,w], t [N])``."""

    seed: int
    n_samples: int
    t_min: float
    t_max: float
    num_train_timesteps: int
    device: torch.device

    def __call__(self, uid: int, latent_shape: Tuple[int, ...]):
        g = torch.Generator(device=self.device)
        g.manual_seed(derive_seed(self.seed, 7, uid))
        posterior = torch.randn(latent_shape, generator=g, device=self.device, dtype=torch.float32)
        g.manual_seed(derive_seed(self.seed, uid))
        noise, t = draw(g, self.n_samples, latent_shape, self.t_min, self.t_max, self.num_train_timesteps)
        return posterior, noise, t


@torch.inference_mode()
def sweep_losses(
    unet: UNet2DCondition,
    schedule: Schedule,
    latents: torch.Tensor,  # [B, C, h, w] clean latents in the model dtype
    ctx: torch.Tensor,  # [B, n_cond, L, D] text embeddings per image
    noises: torch.Tensor,  # [B, N, C, h, w] fp32
    ts: torch.Tensor,  # [B, N] int
    chunk: int,
    dedup_prefix: bool = True,
) -> torch.Tensor:
    """Per-pixel losses [B, N, n_cond, C, h, w] in fp16. ``dedup_prefix``:
    the UNet takes the B·chunk unique rows and tiles them at its first
    cross-attention (``ctx_tile``); off, the rows are tiled over the
    conditions up front and the UNet runs at B·chunk·n_cond throughout."""
    B, C, h, w = latents.shape
    n_cond = ctx.shape[1]
    N = noises.shape[1]
    if N % chunk:
        raise ValueError(f"n_samples {N} must be divisible by chunk {chunk}")
    dtype = latents.dtype
    out = torch.empty((B, N, n_cond, C, h, w), dtype=torch.float16, device=latents.device)
    ctx_b = ctx[:, None].expand(B, chunk, *ctx.shape[1:]).reshape(B * chunk * n_cond, *ctx.shape[2:])
    for c0 in range(0, N, chunk):
        noise_c = noises[:, c0:c0 + chunk].float()  # [B, chunk, C, h, w]
        t_c = ts[:, c0:c0 + chunk]
        noisy = add_noise(schedule, latents[:, None].float(), noise_c, t_c)  # fp32
        if dedup_prefix:
            # cond/null share the noisy latent and t: feed the B·chunk unique
            # rows, the UNet tiles them at the first cross-attention (ctx_tile)
            pred = unet(noisy.reshape(B * chunk, C, h, w).to(dtype), t_c.reshape(-1), ctx_b, ctx_tile=n_cond)
        else:
            noisy_b = noisy[:, :, None].expand(B, chunk, n_cond, C, h, w).reshape(B * chunk * n_cond, C, h, w)
            t_b = t_c[:, :, None].expand(B, chunk, n_cond).reshape(-1)
            pred = unet(noisy_b.to(dtype), t_b, ctx_b)
        pred = pred.reshape(B, chunk, n_cond, C, h, w)
        # fp32 pred vs noise, elementwise MSE (reference compute.py:101)
        out[:, c0:c0 + chunk] = ((pred.float() - noise_c[:, :, None]) ** 2).half()
    return out


@dataclasses.dataclass
class TypicalityEngine:
    """The sweep over one latent-shape bucket. The UNet is already in its
    compute dtype (cast once by the SD bundle). With a ``mesh`` each rank
    sweeps its own rows of a group (``shard``). ``dedup_prefix`` None reads
    DIFFMINING_SWEEP_DEDUP (on unless "0"), as the JAX engine does."""

    unet: UNet2DCondition
    schedule: Schedule
    n_samples: int = 100
    chunk: int = 10
    mesh: Optional[Mesh] = None
    dedup_prefix: Optional[bool] = None
    _warned_pad: bool = dataclasses.field(default=False, init=False, repr=False)

    def __post_init__(self):
        if self.dedup_prefix is None:
            self.dedup_prefix = os.environ.get("DIFFMINING_SWEEP_DEDUP", "1") != "0"
        # the loop needs chunk | n_samples; snap to the largest divisor
        if self.n_samples % self.chunk != 0:
            c = min(self.chunk, self.n_samples)
            while self.n_samples % c != 0:
                c -= 1
            self.chunk = c

    def shard(self, group: Sequence) -> Tuple[List, slice]:
        """``group`` padded to a multiple of dp by repeating its last item,
        and the slice of it this rank sweeps (all of it without a mesh).
        Every rank forms the same groups, so the ranks' slices cover each
        row once (engine.py:190-206 of the JAX package pads the same way
        rather than run unsharded)."""
        group = list(group)
        if self.mesh is None:
            return group, slice(0, len(group))
        padded = pad_to_multiple(len(group), self.mesh.dp)
        if padded > len(group):
            if not self._warned_pad and self.mesh.rank == 0:
                print(
                    f"typicality: padding sweep batch {len(group)} -> {padded} to shard "
                    f"over dp={self.mesh.dp}; set batch_images to a multiple of dp to "
                    f"avoid the padded work"
                )
            self._warned_pad = True
            group += [group[-1]] * (padded - len(group))
        return group, host_local_batch_slice(len(group), self.mesh)

    def compute(self, latents: torch.Tensor, ctx: torch.Tensor, noises: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
        """latents [B,C,h,w], ctx [B,n_cond,L,D] (or [n_cond,L,D] shared),
        noises [B,N,C,h,w], ts [B,N] -> [B,N,n_cond,C,h,w] fp16."""
        if ctx.ndim == 3:
            ctx = ctx[None].expand(latents.shape[0], *ctx.shape)
        dtype = self.unet.conv_in.weight.dtype
        return sweep_losses(self.unet, self.schedule, latents.to(dtype), ctx, noises, ts, self.chunk,
                            self.dedup_prefix)


def losses_to_reference_layout(losses) -> np.ndarray:
    """One image's [N, n_cond, C, h, w] losses -> the reference .npy layout,
    a contiguous fp16 numpy array (compute.py:158-160). NCHW makes this a
    copy to the host, where the JAX package transposes from NHWC."""
    return np.ascontiguousarray(losses.detach().cpu().numpy(), dtype=np.float16)
