"""DDIM sampling with classifier-free guidance, and DDIM inversion
(counterpart of diffmining_tpu/diffusion/sampling.py).

Python loops over the steps where the JAX package scans them. ``eps_fn(x,
t, ctx) -> model output`` is the UNet call (eps- or v-parameterised; the
schedule's ``prediction_type`` says which); both functions run it without
grad, so the long self-attention takes the no-max forward kernel on the
card.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from diffmining_tpu_torch.diffusion.schedule import (
    Schedule,
    ddim_inverse_step,
    ddim_step,
    ddim_timesteps,
    eps_from_pred,
)

EpsFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


@torch.no_grad()
def sample_ddim(
    eps_fn: EpsFn,
    schedule: Schedule,
    latents: torch.Tensor,  # [B, C, h, w] N(0,1) start
    cond_ctx: torch.Tensor,  # [B, L, D]
    uncond_ctx: torch.Tensor,  # [B, L, D]
    num_inference_steps: int = 50,
    guidance_scale: float = 7.5,
    eta: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Denoised latents [B, C, h, w] in ``latents``' dtype.

    One UNet call a step on the batch [uncond; cond] (2B rows), guidance
    eps_u + s·(eps_c − eps_u) in float32, then the DDIM update. With
    ``eta > 0`` each step's noise comes from ``generator`` (one seeded 0 on
    the latents' device if none is given)."""
    B = latents.shape[0]
    ts = [int(t) for t in ddim_timesteps(num_inference_steps, schedule.num_train_timesteps)]
    ts_prev = ts[1:] + [-1]
    ctx = torch.cat([uncond_ctx, cond_ctx], dim=0)
    if eta > 0.0 and generator is None:
        generator = torch.Generator(device=latents.device)
        generator.manual_seed(0)
    x = latents
    for t, t_prev in zip(ts, ts_prev):
        xx = torch.cat([x, x], dim=0)
        tb = torch.full((2 * B,), t, dtype=torch.long, device=x.device)
        pred = eps_from_pred(schedule, eps_fn(xx, tb, ctx), xx, tb)
        eps_u, eps_c = pred.float().chunk(2, dim=0)
        eps = eps_u + guidance_scale * (eps_c - eps_u)
        noise = None
        if eta > 0.0:
            noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=torch.float32)
        x = ddim_step(schedule, x, eps, t, t_prev, eta=eta, noise=noise)
    return x


@torch.no_grad()
def ddim_inversion(
    eps_fn: EpsFn,
    schedule: Schedule,
    latents: torch.Tensor,  # [B, C, h, w] clean latents
    ctx: torch.Tensor,  # [B, L, D] the inversion prompt (no CFG)
    num_steps: Optional[int] = None,
    save_every: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """DDIM inversion over ``num_steps`` (default T − 1 = 999) unit steps:
    from level t − 1 to t with the eps evaluated at the target level t.
    Returns (x_T, trajectory [S, B, C, h, w]) with S = ceil(num_steps /
    save_every) latents from low t to high t: trajectory[i] is the level
    i·save_every + 1."""
    num_steps = num_steps or (schedule.num_train_timesteps - 1)
    B = latents.shape[0]
    x = latents
    traj = torch.empty(((num_steps + save_every - 1) // save_every, *x.shape), dtype=x.dtype, device=x.device)
    for i, t in enumerate(range(1, num_steps + 1)):
        tb = torch.full((B,), t, dtype=torch.long, device=x.device)
        eps = eps_from_pred(schedule, eps_fn(x, tb, ctx), x, tb)
        x = ddim_inverse_step(schedule, x, eps, t - 1, t)
        if i % save_every == 0:
            traj[i // save_every] = x
    return x, traj
