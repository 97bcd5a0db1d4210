"""Diffusion noise-schedule math as functions of ``alphas_cumprod``
(counterpart of diffmining_tpu/diffusion/schedule.py).

The betas come from the checkpoint's scheduler config (utils/weights.py
``schedule_from_json``), never from constants here. The DDIM/DDPM steps come
with the sampling slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Schedule:
    """betas / alphas_cumprod: [T] float32 tensors on one device."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    num_train_timesteps: int
    prediction_type: str

    def to(self, device) -> "Schedule":
        return dataclasses.replace(
            self, betas=self.betas.to(device), alphas_cumprod=self.alphas_cumprod.to(device)
        )


def make_schedule(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    beta_schedule: str = "scaled_linear",
    prediction_type: str = "epsilon",
) -> Schedule:
    # float64 on the host, rounded once to float32 — the JAX package's order
    if beta_schedule == "scaled_linear":
        betas = np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float64) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    elif beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2

        ts = np.arange(num_train_timesteps, dtype=np.float64)
        betas = np.minimum(
            1 - alpha_bar((ts + 1) / num_train_timesteps) / alpha_bar(ts / num_train_timesteps), 0.999
        )
    else:
        raise ValueError(f"unknown beta_schedule {beta_schedule!r}")
    alphas_cumprod = np.cumprod(1.0 - betas)
    return Schedule(
        betas=torch.from_numpy(betas.astype(np.float32)),
        alphas_cumprod=torch.from_numpy(alphas_cumprod.astype(np.float32)),
        num_train_timesteps=num_train_timesteps,
        prediction_type=prediction_type,
    )


def _gather_sqrt_coeffs(schedule: Schedule, timesteps: torch.Tensor, ndim: int):
    """sqrt(acp_t), sqrt(1-acp_t) in float32, broadcast to an ndim-rank tensor."""
    acp = schedule.alphas_cumprod.to(timesteps.device)[timesteps.long()]
    shape = tuple(timesteps.shape) + (1,) * (ndim - timesteps.ndim)
    return torch.sqrt(acp).reshape(shape), torch.sqrt(1.0 - acp).reshape(shape)


def add_noise(schedule: Schedule, x0: torch.Tensor, noise: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
    """q(x_t | x_0) = sqrt(acp_t) x0 + sqrt(1-acp_t) eps, coefficients and
    arithmetic in float32, result in x0's dtype. ``timesteps`` has the shape
    of x0's leading axes (or is a scalar)."""
    sqrt_acp, sqrt_om = _gather_sqrt_coeffs(schedule, timesteps, x0.ndim)
    return (sqrt_acp * x0.float() + sqrt_om * noise.float()).to(x0.dtype)
