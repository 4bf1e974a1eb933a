"""AdamW and its learning-rate schedules, in PyTorch.

Mirrors ``repro.train.optim`` operation for operation: clip by the global
norm, step + 1, the learning rate at that step, both moments, their bias
corrections, then ``delta + weight_decay * mask * p`` with the mask
``ndim >= 2`` (no decay on norm scales and biases).  Parameters, gradients
and moments are dicts of tensors keyed by parameter name (the model's
``named_parameters()``).  Unlike the reference, whose update returns new
pytrees, ``adamw_update`` updates parameters and moments in place, and
scales the gradients in place when it clips them: at full width each of
those trees holds ~2.4 G float32 values, and a second copy of three of
them would not fit beside the activations.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional

import torch

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    schedule: str = "cosine"       # cosine | linear | constant


class OptState(NamedTuple):
    step: torch.Tensor     # () int32
    mu: Tree               # first moments, float32, keyed like params
    nu: Tree               # second moments


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` as a float32 scalar, computed as the
    reference computes it (float32 arithmetic on the host)."""
    s = _f32(step)
    warm = s / max(cfg.warmup_steps, 1)
    if cfg.schedule == "constant":
        decay = _f32(1.0)
    else:
        t = torch.clamp((s - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1),
                        0.0, 1.0)
        if cfg.schedule == "cosine":
            decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
                1 + torch.cos(_f32(math.pi) * t))
        else:
            decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * (1 - t)
    return cfg.lr * torch.clamp(warm, max=1.0) * decay


def adamw_init(params: Tree) -> OptState:
    return OptState(
        step=torch.zeros((), dtype=torch.int32),
        mu={n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in params.items()},
        nu={n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in params.items()})


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, float32, on the leaves'
    device."""
    leaves = [t.float() for t in tree.values()]
    return torch.stack([torch.sum(torch.square(t)) for t in leaves]
                       ).sum().sqrt()


def clip_by_global_norm(grads: Tree, max_norm: float):
    """Scale the gradients, in place, so their global norm is at most
    ``max_norm``; returns (grads, the norm before clipping)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in grads.values():
        g.mul_(scale.to(g.dtype))
    return grads, gn


def _decay_mask(params: Tree) -> Dict[str, float]:
    """No weight decay on vectors (norm scales, biases): ndim < 2."""
    return {n: float(p.dim() >= 2) for n, p in params.items()}


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Tree, grads: Tree,
                 state: OptState, mask: Optional[Dict[str, float]] = None):
    """One AdamW step, in place.  Returns (params, new state, metrics
    {"lr", "grad_norm"} as float32 scalars).  ``mask`` (1.0 where weight
    decay applies) defaults to ``_decay_mask(params)``."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    s = _f32(step)
    c1 = float(1.0 - _f32(b1) ** s)
    c2 = float(1.0 - _f32(b2) ** s)
    lr_f = float(lr)
    mask = _decay_mask(params) if mask is None else mask
    for n, p in params.items():
        g, m, v = grads[n].float(), state.mu[n], state.nu[n]
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        delta = (m / c1).div_((v / c2).sqrt_().add_(cfg.eps))
        if mask[n]:
            delta.add_(p.float(), alpha=cfg.weight_decay)
        p.copy_(p.float() - lr_f * delta)
    return params, OptState(step, state.mu, state.nu), {
        "lr": lr, "grad_norm": gnorm}
