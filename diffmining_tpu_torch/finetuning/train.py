"""Training core: LR schedules, gradient clipping + AdamW, gradient
accumulation, EMA and the train step (counterpart of
diffmining_tpu/finetuning/train.py).

One step (reference finetuning/cars.py:257-300): the frozen VAE encodes the
images and CLIP the prompts, without grad; the UNet predicts the noise (or v)
and the MSE is differentiated. With ``mixed_precision`` the step runs under
bf16 autocast: the master weights stay float32 and the UNet's matmuls and
convolutions compute in bf16, so the gated self-attention reaches the flash
kernels in bf16 (flash_fwd_lse forward, flash_bwd_dq and flash_bwd_dkv
backward). The optimizer repeats optax's arithmetic: clip_by_global_norm,
then adamw (scale_by_adam, add_decayed_weights, scale_by_learning_rate),
applied in place. The schedules return numpy float32 values computed as
optax computes them.

The random draws of a step (posterior eps, noise, t; train.py:277-283) come
from a ``torch.Generator`` seeded from (seed, step), or the caller hands
them in (``draws=``), which is how the tests feed the port the JAX draws.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from diffmining_tpu_torch.diffusion.schedule import Schedule, add_noise, get_velocity
from diffmining_tpu_torch.models.clip import CLIPTextModel
from diffmining_tpu_torch.models.unet import UNet2DCondition
from diffmining_tpu_torch.models.vae import AutoencoderKL, sample_latent

LRSchedule = Callable[[int], np.float32]
F32 = np.float32


# ---------------------------------------------------------------------------
# learning-rate schedules (optax's formulas in float32)
# ---------------------------------------------------------------------------


def _polynomial(init: float, end: float, power: float, steps: int) -> LRSchedule:
    """optax.polynomial_schedule (transition_begin 0); a constant at
    ``init`` when ``steps`` <= 0."""
    if steps <= 0:
        return lambda count: F32(init)

    def schedule(count: int) -> np.float32:
        frac = F32(1) - F32(min(max(count, 0), steps)) / F32(steps)
        return F32(init - end) * frac ** F32(power) + F32(end)

    return schedule


def _linear(init: float, end: float, steps: int) -> LRSchedule:
    return _polynomial(init, end, 1, steps)


def _cosine(init: float, decay_steps: int, alpha: float = 0.0) -> LRSchedule:
    """optax.cosine_decay_schedule (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"the cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> np.float32:
        c = min(F32(count), F32(decay_steps))
        decay = F32(0.5) * (F32(1) + np.cos(F32(np.pi) * c / F32(decay_steps)))
        return F32(init) * (F32(1 - alpha) * decay + F32(alpha))

    return schedule


def _join(schedules: Sequence[LRSchedule], boundaries: Sequence[int]) -> LRSchedule:
    """optax.join_schedules: schedule i+1 counts from its boundary."""

    def schedule(step: int) -> np.float32:
        out = schedules[0](step)
        for boundary, s in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = s(step - boundary)
        return out

    return schedule


def make_lr_schedule(name: str, lr: float, warmup: int, total_steps: Optional[int] = None) -> LRSchedule:
    """The six schedules of train.py:40, equal to optax's at every step
    (lr 0 at step 0 under warmup)."""
    if name == "constant":
        return lambda count: F32(lr)
    if name == "constant_with_warmup":
        return _join([_linear(0.0, lr, warmup), lambda count: F32(lr)], [warmup])
    if name not in ("linear", "cosine", "cosine_with_restarts", "polynomial"):
        raise ValueError(name)
    if not total_steps:
        raise ValueError(f"lr_scheduler {name!r} needs total_steps")
    if name == "linear":
        return _join([_linear(0.0, lr, warmup), _linear(lr, 0.0, total_steps - warmup)], [warmup])
    if name == "cosine":
        return _join([_linear(0.0, lr, warmup), _cosine(lr, total_steps - warmup)], [warmup])
    if name == "cosine_with_restarts":
        n_cycles = 4
        period = max(1, (total_steps - warmup) // n_cycles)
        bounds = [warmup + period * (i + 1) for i in range(n_cycles - 1)]
        return _join([_linear(0.0, lr, warmup)] + [_cosine(lr, period)] * n_cycles, [warmup] + bounds)
    return _join([_linear(0.0, lr, warmup), _polynomial(lr, 0.0, 1.0, total_steps - warmup)], [warmup])


# ---------------------------------------------------------------------------
# optimizer: clip_by_global_norm, then optax.adamw, in place
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AdamWState:
    count: int  # updates made so far (scale_by_adam's count == the schedule's)
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


@dataclasses.dataclass
class AccumulateState:
    """accumulate_every's state (train.py:72): the micro-step in the window,
    the number of emitted updates, the inner state and the gradient sum."""

    mini_step: int
    gradient_step: int
    inner_state: AdamWState
    acc: List[torch.Tensor]


@dataclasses.dataclass
class Optimizer:
    """optax.chain(clip_by_global_norm(max_grad_norm), adamw(...)), wrapped
    in accumulate_every when ``accum_steps`` > 1 (train.py:166-185)."""

    lr_schedule: LRSchedule
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 1e-2
    eps: float = 1e-8
    max_grad_norm: float = 1.0
    accum_steps: int = 1
    accum_dtype: Optional[torch.dtype] = None  # default: the gradients' dtype

    def init(self, params: Sequence[torch.Tensor]):
        inner = AdamWState(0, [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params])
        if self.accum_steps <= 1:
            return inner
        acc = [torch.zeros_like(p, dtype=self.accum_dtype or p.dtype) for p in params]
        return AccumulateState(0, 0, inner, acc)

    def clip_(self, grads: List[torch.Tensor]) -> None:
        """optax.clip_by_global_norm: g / |g| * max_norm when |g| >= max_norm
        (one host read of the norm per update)."""
        norm = float(torch.stack([g.float().pow(2).sum() for g in grads]).sum().sqrt())
        if not norm < self.max_grad_norm:
            torch._foreach_div_(grads, norm)
            torch._foreach_mul_(grads, self.max_grad_norm)

    def apply_(self, params: List[torch.Tensor], grads: List[torch.Tensor], state: AdamWState) -> None:
        """One clipped AdamW update of ``params`` in place, in optax's order:
        mu, nu, bias corrections, mu_hat / (sqrt(nu_hat) + eps), + wd·p,
        × −lr(count); ``grads`` is consumed."""
        self.clip_(grads)
        lr = self.lr_schedule(state.count)
        state.count += 1
        b1, b2 = self.beta1, self.beta2
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - b2)
        bc1 = float(F32(1) - F32(b1) ** F32(state.count))
        bc2 = float(F32(1) - F32(b2) ** F32(state.count))
        denom = grads  # the gradients are spent: their buffers hold sqrt(nu_hat) + eps
        torch._foreach_copy_(denom, state.nu)
        torch._foreach_div_(denom, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(state.mu, bc1)
        torch._foreach_div_(upd, denom)
        del denom, grads
        torch._foreach_add_(upd, params, alpha=self.weight_decay)
        torch._foreach_mul_(upd, -float(lr))
        torch._foreach_add_(params, upd)


def make_optimizer(
    lr_schedule: LRSchedule,
    beta1: float = 0.9,
    beta2: float = 0.999,
    weight_decay: float = 1e-2,
    eps: float = 1e-8,
    max_grad_norm: float = 1.0,
    accum_steps: int = 1,
    accum_dtype: Optional[torch.dtype] = None,
) -> Optimizer:
    return Optimizer(lr_schedule, beta1, beta2, weight_decay, eps, max_grad_norm, accum_steps, accum_dtype)


def ema_decay_schedule(step: int, max_decay: float = 0.9999) -> float:
    """diffusers EMAModel default ramp: min(max_decay, (1+s)/(10+s)), f32."""
    s = F32(step)
    return float(min(F32(max_decay), (F32(1) + s) / (F32(10) + s)))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainState:
    step: int  # train_step calls (micro-steps)
    params: Dict[str, torch.Tensor]  # float32 master weights: the UNet's own parameters
    opt_state: object  # AdamWState, or AccumulateState when accumulating
    ema_params: Optional[Dict[str, torch.Tensor]] = None


Draws = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (posterior eps, noise, t)


@dataclasses.dataclass
class TrainStepBuilder:
    """The counterpart of train.py:194 TrainStepBuilder: ``init_state``,
    ``dense_params`` and ``build()``, which returns the step
    ``step(state, images, tokens, seed, draws=None, emit=None) -> (state,
    loss)``. ``images`` are [B, 3, H, W] float32 in [-1, 1], ``tokens``
    [B, 77] integer ids; the loss is a device scalar (no host sync).

    The state is updated in place: ``state.params`` are the UNet module's
    parameters. With the optimizer's ``accum_steps`` > 1 the micro-step
    index decides, on the host, whether a call only adds its gradients to
    the accumulator (skip) or also updates the parameters and the EMA
    (emit), as the JAX builder's static skip/emit programs do; ``emit``
    overrides it."""

    unet: UNet2DCondition
    vae: AutoencoderKL
    clip: CLIPTextModel
    schedule: Schedule
    optimizer: Optimizer
    use_ema: bool = False
    ema_max_decay: float = 0.9999
    mixed_precision: bool = False  # bf16 autocast around the towers and the UNet

    def init_state(self) -> TrainState:
        self.unet.requires_grad_(True)
        for m in (self.vae, self.clip):
            m.requires_grad_(False)
        params = dict(self.unet.named_parameters())
        ema = {k: p.detach().clone() for k, p in params.items()} if self.use_ema else None
        return TrainState(0, params, self.optimizer.init(list(params.values())), ema)

    def dense_params(self, state: TrainState, use_ema: bool = False) -> Dict[str, torch.Tensor]:
        """The UNet state dict to export: the EMA weights if asked and kept."""
        src = state.ema_params if (use_ema and state.ema_params is not None) else state.params
        return {k: v.detach() for k, v in src.items()}

    def _autocast(self, device: torch.device):
        return torch.autocast(device.type, dtype=torch.bfloat16, enabled=self.mixed_precision)

    def draw(self, seed: int, step: int, latent_shape, device: torch.device) -> Draws:
        """The step's own draws from a generator seeded with (seed, step)."""
        g = torch.Generator(device=device)
        g.manual_seed(seed * 1_000_003 + step)
        eps = torch.randn(latent_shape, generator=g, device=device)
        noise = torch.randn(latent_shape, generator=g, device=device)
        t = torch.randint(0, self.schedule.num_train_timesteps, (latent_shape[0],), generator=g, device=device)
        return eps, noise, t

    def loss(self, images: torch.Tensor, tokens: torch.Tensor, seed: int = 0, step: int = 0,
             draws: Optional[Draws] = None) -> torch.Tensor:
        """The MSE of the UNet's prediction against its target, with the
        UNet's graph attached (train.py:277-299)."""
        device = self.unet.conv_in.weight.device
        images = images.to(device)
        with torch.no_grad(), self._autocast(device):
            mean, logvar = self.vae.encode(images)
            eps, noise, t = draws if draws is not None else self.draw(seed, step, tuple(mean.shape), device)
            eps, noise, t = eps.to(device), noise.to(device), t.to(device)
            latents = sample_latent(mean, logvar, eps, self.vae.config.scaling_factor)
            noisy = add_noise(self.schedule, latents, noise, t)
            ctx = self.clip(tokens.to(device).long())
            target = noise if self.schedule.prediction_type == "epsilon" else get_velocity(
                self.schedule, latents, noise, t)
        with self._autocast(device):
            pred = self.unet(noisy, t, ctx)
        return torch.mean((pred.float() - target.float()) ** 2)

    def _apply_and_ema(self, state: TrainState, grads: List[torch.Tensor], inner: AdamWState) -> None:
        params = list(state.params.values())
        with torch.no_grad():
            self.optimizer.apply_(params, grads, inner)
            if state.ema_params is not None:
                d = ema_decay_schedule(state.step // self.optimizer.accum_steps, self.ema_max_decay)
                ema = list(state.ema_params.values())
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, params, alpha=1.0 - d)

    def build(self) -> Callable:
        accum = self.optimizer.accum_steps

        def step(state: TrainState, images, tokens, seed: int = 0, draws: Optional[Draws] = None,
                 emit: Optional[bool] = None):
            loss = self.loss(images, tokens, seed, state.step, draws)
            loss.backward()
            params = list(state.params.values())
            grads = [p.grad for p in params]
            for p in params:
                p.grad = None
            if accum <= 1:
                self._apply_and_ema(state, grads, state.opt_state)
            else:
                ost = state.opt_state
                with torch.no_grad():
                    for a, g in zip(ost.acc, grads):
                        a.add_(g.to(a.dtype))
                del grads
                e = (state.step % accum) == accum - 1 if emit is None else bool(emit)
                if e:
                    mean = [a.to(p.dtype) / accum for a, p in zip(ost.acc, params)]
                    self._apply_and_ema(state, mean, ost.inner_state)
                    for a in ost.acc:
                        a.zero_()
                    ost.gradient_step += 1
                ost.mini_step = (ost.mini_step + 1) % accum
            state.step += 1
            return state, loss.detach()

        return step

