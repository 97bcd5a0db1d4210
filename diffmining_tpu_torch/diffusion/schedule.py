"""Diffusion noise-schedule math as functions of ``alphas_cumprod``
(counterpart of diffmining_tpu/diffusion/schedule.py).

The betas come from the checkpoint's scheduler config (utils/weights.py
``schedule_from_json``), never from constants here. The DDIM/DDPM steps
take ``t`` as a Python int, a 0-d tensor or one timestep per batch row; all
arithmetic is float32 and the result comes back in ``x_t``'s dtype, in the
JAX package's order of operations (schedule.py:101-207).
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


def get_velocity(schedule: Schedule, x0: torch.Tensor, noise: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
    """v-prediction target sqrt(acp_t) eps - sqrt(1-acp_t) x0, in float32,
    result in x0's dtype."""
    sqrt_acp, sqrt_om = _gather_sqrt_coeffs(schedule, timesteps, x0.ndim)
    return (sqrt_acp * noise.float() - sqrt_om * x0.float()).to(x0.dtype)


def pred_x0_from_eps(schedule: Schedule, x_t: torch.Tensor, eps: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
    """x0 = (x_t - sqrt(1-acp_t) eps) / sqrt(acp_t), float32."""
    sqrt_acp, sqrt_om = _gather_sqrt_coeffs(schedule, timesteps, x_t.ndim)
    return (x_t.float() - sqrt_om * eps.float()) / sqrt_acp


def eps_from_pred(
    schedule: Schedule, model_out: torch.Tensor, x_t: torch.Tensor, timesteps: torch.Tensor
) -> torch.Tensor:
    """A model output (eps- or v-parameterised) as eps, in its dtype."""
    if schedule.prediction_type == "epsilon":
        return model_out
    sqrt_acp, sqrt_om = _gather_sqrt_coeffs(schedule, timesteps, x_t.ndim)
    return (sqrt_acp * model_out.float() + sqrt_om * x_t.float()).to(model_out.dtype)


def _acp(schedule: Schedule, t, ndim: int, device, clean_below: int) -> torch.Tensor:
    """alphas_cumprod at t as float32, broadcast to an ndim-rank tensor;
    t < clean_below reads 1.0 (the clean-image boundary). A Python int t is
    read by indexing, with no copy from the host (the samplers' loops)."""
    if isinstance(t, (int, np.integer)):
        acp = schedule.alphas_cumprod.to(device)
        acp = acp[int(t)] if t >= clean_below else torch.ones((), dtype=acp.dtype, device=device)
        return acp.reshape((1,) * ndim)
    t = torch.as_tensor(t, device=device)
    acp = schedule.alphas_cumprod.to(device)[t.long().clamp_min(0)]
    acp = torch.where(t >= clean_below, acp, torch.ones_like(acp))
    return acp.reshape(tuple(t.shape) + (1,) * (ndim - t.ndim))


def ddim_step(
    schedule: Schedule,
    x_t: torch.Tensor,
    eps: torch.Tensor,
    t,
    t_prev,
    eta: float = 0.0,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """One deterministic (eta=0) or stochastic DDIM update x_t -> x_{t_prev};
    ``t_prev < 0`` is the clean-image boundary (acp=1). eta > 0 needs the
    caller's standard-normal ``noise``."""
    acp_t = _acp(schedule, t, x_t.ndim, x_t.device, 0)
    acp_prev = _acp(schedule, t_prev, x_t.ndim, x_t.device, 0)
    x_t32, eps32 = x_t.float(), eps.float()
    x0 = (x_t32 - torch.sqrt(1.0 - acp_t) * eps32) / torch.sqrt(acp_t)
    if eta > 0.0:
        if noise is None:
            raise ValueError("eta > 0 requires noise")
        sigma = eta * torch.sqrt((1 - acp_prev) / (1 - acp_t)) * torch.sqrt(1 - acp_t / acp_prev)
        dir_xt = torch.sqrt(torch.clamp(1.0 - acp_prev - sigma**2, min=0.0)) * eps32
        x_prev = torch.sqrt(acp_prev) * x0 + dir_xt + sigma * noise.float()
    else:
        x_prev = torch.sqrt(acp_prev) * x0 + torch.sqrt(1.0 - acp_prev) * eps32
    return x_prev.to(x_t.dtype)


def ddim_inverse_step(schedule: Schedule, x_t: torch.Tensor, eps: torch.Tensor, t, t_next) -> torch.Tensor:
    """One DDIM inversion update x_t -> x_{t_next}, t_next > t: the x0
    estimate at t re-noised to t_next; ``t < 0`` is the clean boundary."""
    acp_t = _acp(schedule, t, x_t.ndim, x_t.device, 0)
    acp_next = _acp(schedule, t_next, x_t.ndim, x_t.device, 0)
    x_t32, eps32 = x_t.float(), eps.float()
    x0 = (x_t32 - torch.sqrt(1.0 - acp_t) * eps32) / torch.sqrt(acp_t)
    return (torch.sqrt(acp_next) * x0 + torch.sqrt(1.0 - acp_next) * eps32).to(x_t.dtype)


def ddpm_step(
    schedule: Schedule,
    x_t: torch.Tensor,
    eps: torch.Tensor,
    t,
    noise: torch.Tensor,
    clip_sample: bool = True,
) -> torch.Tensor:
    """One ancestral DDPM update x_t -> x_{t-1}, variance "fixed_small";
    SD-v1.5's scheduler clips the x0 estimate to [-1, 1]. No noise at t=0."""
    t = torch.as_tensor(t, device=x_t.device)
    acp_t = _acp(schedule, t, x_t.ndim, x_t.device, 0)
    acp_prev = _acp(schedule, t - 1, x_t.ndim, x_t.device, 0)
    beta_t = schedule.betas.to(x_t.device)[t.long()].reshape(acp_t.shape)
    alpha_t = 1.0 - beta_t
    x_t32, eps32 = x_t.float(), eps.float()
    x0 = (x_t32 - torch.sqrt(1.0 - acp_t) * eps32) / torch.sqrt(acp_t)
    if clip_sample:
        x0 = torch.clamp(x0, -1.0, 1.0)
    coef_x0 = torch.sqrt(acp_prev) * beta_t / (1.0 - acp_t)
    coef_xt = torch.sqrt(alpha_t) * (1.0 - acp_prev) / (1.0 - acp_t)
    mean = coef_x0 * x0 + coef_xt * x_t32
    var = torch.clamp(beta_t * (1.0 - acp_prev) / (1.0 - acp_t), min=1e-20)
    x_prev = torch.where(t.reshape(acp_t.shape) > 0, mean + torch.sqrt(var) * noise.float(), mean)
    return x_prev.to(x_t.dtype)


def ddim_timesteps(num_inference_steps: int, num_train_timesteps: int = 1000, steps_offset: int = 1) -> np.ndarray:
    """Descending inference timesteps, "leading" spacing + steps_offset (the
    DDIMScheduler config SD-v1.5 ships): for 50 steps [981, 961, ..., 21, 1]."""
    ratio = num_train_timesteps // num_inference_steps
    ts = (np.arange(num_inference_steps) * ratio).round()[::-1].astype(np.int64)
    ts = ts + steps_offset
    return np.clip(ts, 0, num_train_timesteps - 1).astype(np.int32)
