"""8-bit AdamW: both Adam moments stored as int8 with one float32 absmax
scale per 256-element block (counterpart of diffmining_tpu/ops/optim8bit.py,
the reference's --use_8bit_adam).

The arithmetic is the JAX package's, step for step:

  * ``quantize``: a tensor flattened, its tail zero-padded to whole blocks
    (blocks never cross tensors), scale = max|block| / 127, q =
    round(block / scale) half to even, clipped to +-127; a zero block keeps
    scale 0 and divides by 1. Both divisions are true float32 divisions of
    tensors (never a multiply by a reciprocal), so ties fall as in JAX.
  * the update: dequantize, the float32 moment update
    mu = b1 mu + (1 - b1) g, nu = b2 nu + ((1 - b2) g) g, the bias-corrected
    step from the unquantized new moments, mu_hat / (sqrt(nu_hat) + eps),
    then requantize.

Memory is the point: 2 bytes of moments a parameter instead of 8 (plus 8
bytes of scale per 256 parameters). So the state is never dequantized
whole: the parameters are cut into groups of whole tensors of at most
``GROUP_ELEMS`` elements (a larger tensor is a group of its own), each group
keeps its moments in one flat int8 buffer and its scales in one float32
buffer, and the update runs group by group with float32 temporaries of one
group's size. A group is a handful of launches over its flat buffers plus
a multi-tensor copy in and out, so the launch count stays near the float32
foreach path's.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

_BLOCK = 256
GROUP_ELEMS = 1 << 25  # float32 temporaries of 128 MiB each per group


def _n_blocks(numel: int) -> int:
    return -(-numel // _BLOCK)


def quantize_blocks(blocks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[nb, 256] float32 -> (int8 [nb, 256], float32 scales [nb, 1])."""
    amax = blocks.abs().amax(dim=1, keepdim=True)
    scale = amax / torch.full_like(amax, 127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.round(blocks / safe).clamp_(-127, 127).to(torch.int8)
    return q, scale


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A tensor -> (int8 values [nb, 256], float32 block scales [nb, 1])."""
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % _BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return quantize_blocks(flat.view(-1, _BLOCK))


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    """(int8 [nb, 256], scales [nb, 1]) -> float32 tensor of ``shape``."""
    size = 1
    for s in shape:
        size *= s
    return (q.float() * scale).reshape(-1)[:size].reshape(shape)


@dataclasses.dataclass(frozen=True)
class Group:
    """Parameters [start, end) of the list; ``offsets[i]`` is the first block
    of parameter start + i in the group's buffers, ``offsets[-1]`` the
    group's block count."""

    start: int
    end: int
    offsets: Tuple[int, ...]


def plan_groups(numels: Sequence[int], group_elems: int = GROUP_ELEMS) -> List[Group]:
    """Consecutive whole tensors, at most ``group_elems`` padded elements a
    group unless one tensor alone is larger."""
    groups, start, offsets = [], 0, [0]
    for i, n in enumerate(numels):
        nb = _n_blocks(n)
        if i > start and (offsets[-1] + nb) * _BLOCK > group_elems:
            groups.append(Group(start, i, tuple(offsets)))
            start, offsets = i, [0]
        offsets.append(offsets[-1] + nb)
    if len(numels) > start:
        groups.append(Group(start, len(numels), tuple(offsets)))
    return groups


@dataclasses.dataclass
class Adam8bitState:
    """The JAX ``Adam8bitState`` (count, mu_q, mu_s, nu_q, nu_s), one flat
    buffer of each a group: int8 [nb, 256] values and float32 [nb, 1]
    scales."""

    count: int
    groups: List[Group]
    mu_q: List[torch.Tensor]
    mu_s: List[torch.Tensor]
    nu_q: List[torch.Tensor]
    nu_s: List[torch.Tensor]

    def tensor(self, i: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Parameter i's (mu_q, mu_s, nu_q, nu_s), views of its group's
        buffers: the per-tensor leaves of the JAX state."""
        for k, g in enumerate(self.groups):
            if g.start <= i < g.end:
                a, b = g.offsets[i - g.start], g.offsets[i - g.start + 1]
                return self.mu_q[k][a:b], self.mu_s[k][a:b], self.nu_q[k][a:b], self.nu_s[k][a:b]
        raise IndexError(i)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (*self.mu_q, *self.mu_s, *self.nu_q, *self.nu_s))


def init_state(params: Sequence[torch.Tensor], group_elems: int = GROUP_ELEMS) -> Adam8bitState:
    """Zero moments (the quantization of zeros: q 0, scale 0); mu and nu are
    separate buffers."""
    groups = plan_groups([p.numel() for p in params], group_elems)
    dev = params[0].device if len(params) else torch.device("cpu")

    def zeros(dtype, width):
        return [torch.zeros((g.offsets[-1], width), dtype=dtype, device=dev) for g in groups]

    return Adam8bitState(0, groups, zeros(torch.int8, _BLOCK), zeros(torch.float32, 1),
                         zeros(torch.int8, _BLOCK), zeros(torch.float32, 1))


def _views(flat: torch.Tensor, group: Group, numels: Sequence[int]) -> List[torch.Tensor]:
    return [flat[o * _BLOCK:o * _BLOCK + n] for o, n in zip(group.offsets, numels)]


def _group_step(state: Adam8bitState, k: int, g: torch.Tensor, b1: float, b2: float, eps: float,
                bc1: torch.Tensor, bc2: torch.Tensor) -> torch.Tensor:
    """Group k's moments updated by its gradient blocks ``g`` [nb, 256] and
    requantized in place; returns the step blocks [nb, 256]."""
    mu = state.mu_q[k].float().mul_(state.mu_s[k])
    mu.mul_(b1).add_(g * (1 - b1))
    nu = state.nu_q[k].float().mul_(state.nu_s[k])
    t = g * (1 - b2)
    nu.mul_(b2).add_(t.mul_(g))
    del t
    step = mu / bc1
    denom = (nu / bc2).sqrt_().add_(eps)
    step.div_(denom)
    del denom
    for q_buf, s_buf, m in ((state.mu_q[k], state.mu_s[k], mu), (state.nu_q[k], state.nu_s[k], nu)):
        q, s = quantize_blocks(m)
        q_buf.copy_(q)
        s_buf.copy_(s)
    return step


def _bias_corrections(count: int, b1: float, b2: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """1 - b**count in float32 (JAX's weak-typed power), as 0-d tensors so the
    divisions are true divisions on every device."""
    c = torch.tensor(float(count), dtype=torch.float32)
    bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** c
    bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** c
    return bc1.to(device), bc2.to(device)


def _gather(grads: List, group: Group, numels: Sequence[int], consume: bool) -> torch.Tensor:
    """The group's gradients in one zero-padded float32 [nb, 256] buffer; with
    ``consume`` each gradient's list entry is dropped once copied, so its
    memory goes back group by group."""
    src = [grads[i].reshape(-1) for i in range(group.start, group.end)]
    flat = torch.zeros(group.offsets[-1] * _BLOCK, dtype=torch.float32, device=src[0].device)
    torch._foreach_copy_(_views(flat, group, numels[group.start:group.end]), src)
    if consume:
        for i in range(group.start, group.end):
            grads[i] = None
    return flat.view(-1, _BLOCK)


def scale_by_adam_8bit_(grads: List[torch.Tensor], state: Adam8bitState, b1: float = 0.9, b2: float = 0.999,
                        eps: float = 1e-8) -> List[torch.Tensor]:
    """JAX ``scale_by_adam_8bit(b1, b2, eps).update``: the steps, one a
    tensor in float32, and the state advanced in place."""
    state.count += 1
    numels = [g.numel() for g in grads]
    bc1, bc2 = _bias_corrections(state.count, b1, b2, grads[0].device)
    out = []
    for k, group in enumerate(state.groups):
        step = _group_step(state, k, _gather(grads, group, numels, False), b1, b2, eps, bc1, bc2).reshape(-1)
        out += [v.view(grads[group.start + j].shape)
                for j, v in enumerate(_views(step, group, numels[group.start:group.end]))]
    return out


def adamw_8bit_(params: List[torch.Tensor], grads: List, state: Adam8bitState, lr: float, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 1e-2) -> None:
    """optax.chain(scale_by_adam_8bit, add_decayed_weights, scale_by_learning_rate)
    applied to ``params`` in place, group by group; ``grads`` is consumed
    (its entries are set to None as each group is read)."""
    state.count += 1
    numels = [p.numel() for p in params]
    bc1, bc2 = _bias_corrections(state.count, b1, b2, params[0].device)
    for k, group in enumerate(state.groups):
        g = _gather(grads, group, numels, True)
        step = _group_step(state, k, g, b1, b2, eps, bc1, bc2).reshape(-1)
        del g
        ps = params[group.start:group.end]
        upd = [v.view(p.shape) for v, p in zip(_views(step, group, numels[group.start:group.end]), ps)]
        torch._foreach_add_(upd, ps, alpha=weight_decay)
        torch._foreach_mul_(upd, -float(lr))
        torch._foreach_add_(ps, upd)
