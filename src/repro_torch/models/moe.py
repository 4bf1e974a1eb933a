"""Mixture-of-Experts layer (granite-moe 32e/top-8, mixtral 8e/top-2), in
PyTorch.

Mirrors ``repro.models.moe``: softmax-then-top-k routing with
renormalised combine weights, GShard/Switch capacity-based dispatch as
dense products (tokens beyond an expert's capacity are dropped and
contribute zero), and the Switch load-balance auxiliary loss.  The
reference computes all of it as einsums outside any Pallas kernel, so
plain PyTorch products are its port; the expert dimension is not
sharded (one device).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .config import ModelConfig
from .initlib import dense_init
from .layers import gelu, param


class MoE(nn.Module):
    """``router`` (D, E); per expert ``wg`` (SwiGLU only) and ``wu``
    (E, D, F), ``wd`` (E, F, D)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        self.cfg = cfg
        E, D, F, g = cfg.n_experts, cfg.d_model, cfg.d_ff, generator
        self.router = param(dense_init((D, E), g, device))
        self.wg = None
        if cfg.act == "swiglu":
            self.wg = param(dense_init((E, D, F), g, device, fan_in=D))
        self.wu = param(dense_init((E, D, F), g, device, fan_in=D))
        self.wd = param(dense_init((E, F, D), g, device, fan_in=F))
        ew = ("experts", "embed", "expert_mlp")
        self.logical_axes = {"router": ("embed_tp", None), "wg": ew,
                             "wu": ew,
                             "wd": ("experts", "expert_mlp", "embed")}

    def forward(self, x: torch.Tensor):
        return apply_moe(self, self.cfg, x)


def capacity(cfg: ModelConfig, seq: int) -> int:
    """Queue slots per expert and batch row, as the reference computes
    them (in Python floats)."""
    return max(int(seq * cfg.top_k / cfg.n_experts * cfg.capacity_factor),
               1)


def router_probs(p: MoE, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) -> float32 routing probabilities (B, S, E)."""
    return torch.softmax(x.float() @ p.router.float(), dim=-1)


def _rounds(probs: torch.Tensor, top_k: int):
    """The reference's iterative top-k: each round yields every token's
    best remaining expert (B, S) (a tie goes to the first index, as
    ``jnp.argmax`` gives it), its gate and its one-hot, then masks it
    out by a multiply."""
    remaining = probs
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=-1)
        gate = torch.gather(remaining, -1, idx[..., None])[..., 0]
        onehot = nn.functional.one_hot(idx, probs.shape[-1]).to(probs.dtype)
        yield idx, gate, onehot
        remaining = remaining * (1.0 - onehot)


def topk_experts(probs: torch.Tensor, top_k: int) -> torch.Tensor:
    """The experts each token picks, (B, S, k) int64, in pick order."""
    return torch.stack([idx for idx, _, _ in _rounds(probs, top_k)], -1)


def _topk_dispatch(probs: torch.Tensor, top_k: int, cap: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """probs (B, S, E) -> dispatch (B, S, E, C) one-hot and combine
    (B, S, E, C) weights.  Each of the k rounds takes every token's best
    remaining expert; its queue position is the count of earlier tokens
    of the batch row routed there (this round's cumulative sum along S,
    plus every earlier round's ``fill``); positions at or past ``cap``
    are dropped.  The combine weights are renormalised by the kept
    gates' sum (at least 1e-9)."""
    B, S, E = probs.shape
    dt = probs.dtype
    dispatch = torch.zeros(B, S, E, cap, dtype=dt, device=probs.device)
    combine = torch.zeros_like(dispatch)
    fill = torch.zeros(B, E, dtype=torch.int32, device=probs.device)
    weight_sum = torch.zeros(B, S, dtype=dt, device=probs.device)
    slots = torch.arange(cap, device=probs.device)
    for _, gate, onehot in _rounds(probs, top_k):
        pos = torch.cumsum(onehot, dim=1) - onehot + fill[:, None, :].to(dt)
        in_cap = pos < cap
        # jax.nn.one_hot of a position past the capacity is all zeros
        slot = (pos.to(torch.int32)[..., None] == slots).to(dt)
        contrib = onehot[..., None] * slot * in_cap[..., None]
        dispatch = dispatch + contrib
        combine = combine + contrib * gate[..., None, None]
        weight_sum = weight_sum + gate * (onehot * in_cap).sum(-1)
        fill = fill + onehot.sum(dim=1).to(torch.int32)
    combine = combine / torch.clamp(weight_sum[..., None, None], min=1e-9)
    return dispatch, combine


def apply_moe(p: MoE, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y in x's type, float32 aux loss).  The router runs
    in float32, the expert products in the working type."""
    B, S, D = x.shape
    E = cfg.n_experts
    probs = router_probs(p, x)
    dispatch, combine = _topk_dispatch(probs, cfg.top_k, capacity(cfg, S))
    dt = x.dtype
    dispatch, combine = dispatch.to(dt), combine.to(dt)
    xe = torch.einsum("bsec,bsd->becd", dispatch, x)
    if cfg.act == "swiglu":
        h = nn.functional.silu(
            torch.einsum("becd,edf->becf", xe, p.wg.to(dt))) * \
            torch.einsum("becd,edf->becf", xe, p.wu.to(dt))
    else:
        h = gelu(torch.einsum("becd,edf->becf", xe, p.wu.to(dt)))
    ye = torch.einsum("becf,efd->becd", h, p.wd.to(dt))
    y = torch.einsum("bsec,becd->bsd", combine, ye)
    # Switch load-balance loss: E * sum_e f_e * p_e (first-choice shares)
    first = nn.functional.one_hot(torch.argmax(probs, -1), E).float()
    aux = E * torch.sum(first.mean(dim=(0, 1)) * probs.mean(dim=(0, 1))) \
        * cfg.router_aux_coef
    return y, aux
