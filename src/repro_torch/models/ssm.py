"""Mamba2 (SSD) mixer, the state-space block of zamba2, in PyTorch.

Mirrors ``repro.models.ssm``: the chunked state-space-dual algorithm for
a whole sequence, whose intra-chunk term runs through the SSD kernel
(``kernels.mamba2_scan.ops.ssd_intra_chunk``), the inter-chunk scan as a
Python loop over chunks carrying the (B, H, P, N) state, and a
single-token step for decode.

Shapes: d_inner I = expand * D, heads H = I / ssm_head_dim, state N, one
B/C group.  The causal conv of width ``ssm_conv`` runs over the
(I + 2N) x/B/C channels.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..kernels.mamba2_scan.ops import ssd_intra_chunk
from .config import ModelConfig
from .initlib import (a_log_init, dense_init, dt_bias_init, ones_init,
                      zeros_init)
from .layers import DTYPES, param

# SSD chunk length, as in the reference
CHUNK = 64


class SSMState(NamedTuple):
    h: torch.Tensor       # (B, H, P, N) float32 recurrent state
    conv: torch.Tensor    # (B, convw - 1, I + 2N) conv tail


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    I = cfg.ssm_expand * cfg.d_model
    H = I // cfg.ssm_head_dim
    return I, H, cfg.ssm_head_dim, cfg.ssm_state


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv along S, then SiLU.  xbc: (B, S, C), w: (K, C).
    Returns (out, the last K - 1 inputs as the next call's tail)."""
    K = w.shape[0]
    if tail is None:
        tail = xbc.new_zeros(xbc.shape[0], K - 1, xbc.shape[2])
    xp = torch.cat([tail.to(xbc.dtype), xbc], dim=1)
    S = xbc.shape[1]
    out = sum(xp[:, k:k + S] * w[k].to(xbc.dtype) for k in range(K))
    new_tail = xp[:, xp.shape[1] - (K - 1):]
    return F.silu(out + bias.to(xbc.dtype)), new_tail


def _gated_norm(y: torch.Tensor, z: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    yf = y.float() * F.silu(z.float())
    yf = yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + 1e-6)
    return (yf * scale.float()).to(y.dtype)


class Mamba2Mixer(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        self.cfg = cfg
        I, H, P, N = dims(cfg)
        D, g = cfg.d_model, generator
        conv_ch = I + 2 * N
        self.in_proj = param(dense_init((D, 2 * I + 2 * N + H), g, device))
        self.conv_w = param(dense_init((cfg.ssm_conv, conv_ch), g, device,
                                       fan_in=cfg.ssm_conv))
        self.conv_b = param(zeros_init((conv_ch,), device))
        self.A_log = param(a_log_init(H, device))
        self.dt_bias = param(dt_bias_init(H, g, device))
        self.D = param(ones_init((H,), device))
        self.norm_scale = param(ones_init((I,), device))
        self.out_proj = param(dense_init((I, D), g, device, fan_in=I))
        self.logical_axes = {
            "in_proj": ("embed", "ssm_inner"),
            "conv_w": ("conv", "ssm_inner"), "conv_b": ("ssm_inner",),
            "A_log": ("ssm_heads",), "dt_bias": ("ssm_heads",),
            "D": ("ssm_heads",), "norm_scale": ("ssm_inner",),
            "out_proj": ("ssm_inner", "embed")}

    def _in(self, x: torch.Tensor):
        """Input projection split into z, the conv channels and raw dt."""
        I, H, P, N = dims(self.cfg)
        zxbcdt = x @ self.in_proj.to(x.dtype)
        return torch.split(zxbcdt, [I, I + 2 * N, H], dim=-1)

    def forward(self, x: torch.Tensor, state: Optional[SSMState] = None
                ) -> Tuple[torch.Tensor, SSMState]:
        """Whole-sequence chunked SSD.  x: (B, S, D).  Returns (y, the
        state after the last position)."""
        B, S, _ = x.shape
        I, H, P, N = dims(self.cfg)
        dt_ = x.dtype
        z, xbc, dtraw = self._in(x)
        xbc, conv_tail = _causal_conv(
            xbc, self.conv_w, self.conv_b,
            state.conv if state is not None else None)
        xi, Bc, Cc = torch.split(xbc, [I, N, N], dim=-1)
        xh = xi.reshape(B, S, H, P)
        dt = F.softplus(dtraw.float() + self.dt_bias)          # (B, S, H)
        dA = dt * -torch.exp(self.A_log)                        # log-decay

        # pad to a chunk multiple
        L = CHUNK if S >= CHUNK else S
        pad = (-S) % L
        if pad:
            def zpad(t):
                return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
            xh, Bc, Cc, dt, dA = map(zpad, (xh, Bc, Cc, dt, dA))
        nc = xh.shape[1] // L
        xc = xh.reshape(B, nc, L, H, P).float()
        Bcc = Bc.reshape(B, nc, L, N).float()
        Ccc = Cc.reshape(B, nc, L, N).float()
        dtc = dt.reshape(B, nc, L, H)
        cum = torch.cumsum(dA.reshape(B, nc, L, H), dim=2)      # (B,nc,L,H)

        # intra-chunk: the SSD kernel over B * nc chunks
        y_intra = ssd_intra_chunk(
            xc.reshape(B * nc, L, H, P), dtc.reshape(B * nc, L, H),
            cum.reshape(B * nc, L, H), Bcc.reshape(B * nc, L, N),
            Ccc.reshape(B * nc, L, N)).reshape(B, nc, L, H, P)

        # chunk states, then the inter-chunk scan
        tail_decay = torch.exp(cum[:, :, -1:, :] - cum)         # (B,nc,L,H)
        sB = torch.einsum("bcjh,bcjn,bcjhp->bchnp", dtc * tail_decay, Bcc,
                          xc)
        chunk_decay = torch.exp(cum[:, :, -1])                  # (B,nc,H)
        h = (state.h.float() if state is not None
             else x.new_zeros(B, H, P, N, dtype=torch.float32))
        h_prevs = []
        for c in range(nc):                 # the state BEFORE each chunk
            h_prevs.append(h)
            h = (h * chunk_decay[:, c, :, None, None]
                 + sB[:, c].transpose(-1, -2))
        h_prev = torch.stack(h_prevs, dim=1)                    # (B,nc,H,P,N)
        y_inter = torch.einsum("bcin,bchpn,bcih->bcihp", Ccc, h_prev,
                               torch.exp(cum))
        y = (y_intra + y_inter).reshape(B, nc * L, H, P)[:, :S]
        y = y + xh[:, :S].float() * self.D[None, None, :, None]
        y = _gated_norm(y.reshape(B, S, I).to(dt_), z, self.norm_scale)
        out = y @ self.out_proj.to(dt_)
        return out, SSMState(h=h, conv=conv_tail)

    def decode(self, x: torch.Tensor, state: SSMState
               ) -> Tuple[torch.Tensor, SSMState]:
        """Single-token recurrent step.  x: (B, 1, D)."""
        B = x.shape[0]
        I, H, P, N = dims(self.cfg)
        dt_ = x.dtype
        z, xbc, dtraw = self._in(x)
        xbc, conv_tail = _causal_conv(xbc, self.conv_w, self.conv_b,
                                      state.conv)
        xi, Bc, Cc = torch.split(xbc, [I, N, N], dim=-1)
        xh = xi.reshape(B, H, P).float()
        dt = F.softplus(dtraw[:, 0].float() + self.dt_bias)     # (B, H)
        dec = torch.exp(dt * -torch.exp(self.A_log))            # (B, H)
        Bv, Cv = Bc[:, 0].float(), Cc[:, 0].float()             # (B, N)
        h = (state.h * dec[:, :, None, None]
             + torch.einsum("bh,bhp,bn->bhpn", dt, xh, Bv))
        y = torch.einsum("bhpn,bn->bhp", h, Cv) + xh * self.D[None, :, None]
        y = _gated_norm(y.reshape(B, 1, I).to(dt_), z, self.norm_scale)
        return y @ self.out_proj.to(dt_), SSMState(h=h, conv=conv_tail)


def init_ssm_state(cfg: ModelConfig, batch: int,
                   device: torch.device) -> SSMState:
    I, H, P, N = dims(cfg)
    return SSMState(
        h=torch.zeros(batch, H, P, N, dtype=torch.float32, device=device),
        conv=torch.zeros(batch, cfg.ssm_conv - 1, I + 2 * N,
                         dtype=DTYPES[cfg.dtype], device=device))
