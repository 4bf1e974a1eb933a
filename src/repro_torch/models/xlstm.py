"""xLSTM cells, in PyTorch: mLSTM (matrix memory) and sLSTM (scalar
memory).

Mirrors ``repro.models.xlstm``: exponential gating with the max
stabiliser, the matrix-memory update C_t = f C_{t-1} + i (v k^T), and the
scalar sLSTM with recurrent gate connections; no separate FFN (d_ff = 0).
The reference runs both cells as a ``lax.scan`` over time and has no
Pallas kernel for them; here each is a Python loop over the time steps,
with the reference's arithmetic: q and k both scaled by 1/sqrt(hd), the
gates in float32 with log-sigmoid forget gates, the q/k/v carried in the
working type only under ``cfg.bf16_elementwise``, the stabiliser starting
at -1e9, den = max(|q.n|, exp(-m)), and the sLSTM dividing by
max(n, 1e-6).  sLSTM's input product ``x @ wx`` is taken once over the
whole sequence; the recurrent ``h @ wh`` stays in the loop.  Decode is the
same function at S = 1, as in the reference.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from .config import ModelConfig
from .initlib import dense_init, zeros_init
from .layers import param

STAB_INIT = -1e9       # the stabiliser's starting value


class MLSTMState(NamedTuple):
    C: torch.Tensor    # (B, H, dk, dv) matrix memory
    n: torch.Tensor    # (B, H, dk) normaliser
    m: torch.Tensor    # (B, H) stabiliser


class SLSTMState(NamedTuple):
    c: torch.Tensor    # (B, D) cell
    n: torch.Tensor    # (B, D) normaliser
    m: torch.Tensor    # (B, D) stabiliser
    h: torch.Tensor    # (B, D) hidden (recurrent input)


def _hd(cfg: ModelConfig) -> Tuple[int, int]:
    return cfg.n_heads, cfg.d_model // cfg.n_heads


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """-softplus(-x), as the reference writes it."""
    return -F.softplus(-x)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    """``wq``/``wk``/``wv`` (D, H, hd), ``wif`` (D, H, 2) and ``bif``
    (H, 2) (input and forget gate; forget bias +3), ``wo`` (D, D) (output
    gate), ``wout`` (D, D)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        self.cfg = cfg
        D = cfg.d_model
        H, hd = _hd(cfg)
        g = generator
        self.wq = param(dense_init((D, H, hd), g, device))
        self.wk = param(dense_init((D, H, hd), g, device))
        self.wv = param(dense_init((D, H, hd), g, device))
        self.wif = param(dense_init((D, H, 2), g, device))
        bif = zeros_init((H, 2), device)
        bif[:, 1] = 3.0
        self.bif = param(bif)
        self.wo = param(dense_init((D, D), g, device))
        self.wout = param(dense_init((D, D), g, device))
        hx = ("embed", "heads", None)
        self.logical_axes = {"wq": hx, "wk": hx, "wv": hx, "wif": hx,
                             "bif": ("heads", None),
                             "wo": ("embed", "embed_tp"),
                             "wout": ("embed_tp", "embed")}

    def forward(self, x: torch.Tensor,
                state: Optional[MLSTMState] = None):
        return mlstm_forward(self, self.cfg, x, state)


def init_mlstm_state(cfg: ModelConfig, batch: int,
                     device: torch.device) -> MLSTMState:
    H, hd = _hd(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(C=torch.zeros(batch, H, hd, hd, **f32),
                      n=torch.zeros(batch, H, hd, **f32),
                      m=torch.full((batch, H), STAB_INIT, **f32))


def _mlstm_step(state: MLSTMState, q, k, v, logi, logf):
    """One time step: q/k/v (B, H, hd), logi/logf (B, H), all float32."""
    C, n, m = state
    m_new = torch.maximum(logf + m, logi)
    i_s = torch.exp(logi - m_new)[..., None]
    f_s = torch.exp(logf + m - m_new)[..., None]
    C = f_s[..., None] * C + i_s[..., None] * (k[..., :, None]
                                               * v[..., None, :])
    n = f_s * n + i_s * k
    num = torch.einsum("bhk,bhkv->bhv", q, C)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", q, n).abs(),
                        torch.exp(-m_new))[..., None]
    return MLSTMState(C, n, m_new), num / den


def mlstm_forward(p: MLSTM, cfg: ModelConfig, x: torch.Tensor,
                  state: Optional[MLSTMState] = None
                  ) -> Tuple[torch.Tensor, MLSTMState]:
    """x (B, S, D) -> (y (B, S, D), the state after the last step)."""
    B, S, D = x.shape
    H, hd = _hd(cfg)
    dt = x.dtype
    scale = 1.0 / math.sqrt(hd)

    def proj(w):
        return (x @ w.to(dt).reshape(D, H * hd)).unflatten(-1, (H, hd))

    # the reference scales by a numpy scalar, which promotes to float32
    qkv_dt = dt if cfg.bf16_elementwise else torch.float32
    q = (proj(p.wq).float() * scale).to(qkv_dt)
    k = (proj(p.wk).float() / math.sqrt(hd)).to(qkv_dt)
    v = proj(p.wv).to(qkv_dt)
    # the gate product has no batch dims: "dots" keeps it, as an mm
    g = (x.float() @ p.wif.float().reshape(D, 2 * H)).unflatten(
        -1, (H, 2)) + p.bif[None, None]
    logi, logf = g[..., 0], log_sigmoid(g[..., 1])
    st = state if state is not None else init_mlstm_state(cfg, B, x.device)
    hs = []
    for t in range(S):
        st, h = _mlstm_step(st, q[:, t].float(), k[:, t].float(),
                            v[:, t].float(), logi[:, t], logf[:, t])
        hs.append(h)
    h = torch.stack(hs, 1).reshape(B, S, D).to(dt)
    o = torch.sigmoid(x @ p.wo.to(dt))
    return (o * h) @ p.wout.to(dt), st


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTM(nn.Module):
    """``wx`` and ``wh`` (D, 4D): input and recurrent weights of the
    stacked (z, i, f, o) gates; ``b`` (4D,) (forget bias +3); ``wout``
    (D, D)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        self.cfg = cfg
        D, g = cfg.d_model, generator
        self.wx = param(dense_init((D, 4 * D), g, device))
        self.wh = param(dense_init((D, 4 * D), g, device))
        b = zeros_init((4 * D,), device)
        b[2 * D:3 * D] = 3.0
        self.b = param(b)
        self.wout = param(dense_init((D, D), g, device))
        self.logical_axes = {"wx": ("embed", "embed_tp"),
                             "wh": ("embed", "embed_tp"), "b": ("embed_tp",),
                             "wout": ("embed_tp", "embed")}

    def forward(self, x: torch.Tensor,
                state: Optional[SLSTMState] = None):
        return slstm_forward(self, self.cfg, x, state)


def init_slstm_state(cfg: ModelConfig, batch: int,
                     device: torch.device) -> SLSTMState:
    f32 = dict(dtype=torch.float32, device=device)
    D = cfg.d_model
    return SLSTMState(c=torch.zeros(batch, D, **f32),
                      n=torch.zeros(batch, D, **f32),
                      m=torch.full((batch, D), STAB_INIT, **f32),
                      h=torch.zeros(batch, D, **f32))


def _slstm_step(state: SLSTMState, xw: torch.Tensor, wh: torch.Tensor,
                b: torch.Tensor) -> SLSTMState:
    """One time step; ``xw``: the step's input product x_t @ wx (B, 4D),
    float32."""
    pre = xw + state.h @ wh + b[None]
    z, gi, gf, go = pre.chunk(4, dim=-1)
    z = torch.tanh(z)
    logf = log_sigmoid(gf)
    m_new = torch.maximum(logf + state.m, gi)
    i_s = torch.exp(gi - m_new)
    f_s = torch.exp(logf + state.m - m_new)
    c = f_s * state.c + i_s * z
    n = f_s * state.n + i_s
    h = torch.sigmoid(go) * c / torch.clamp(n, min=1e-6)
    return SLSTMState(c, n, m_new, h)


def slstm_forward(p: SLSTM, cfg: ModelConfig, x: torch.Tensor,
                  state: Optional[SLSTMState] = None
                  ) -> Tuple[torch.Tensor, SLSTMState]:
    """x (B, S, D) -> (y (B, S, D), the state after the last step)."""
    B, S, D = x.shape
    dt = x.dtype
    st = state if state is not None else init_slstm_state(cfg, B, x.device)
    xw = x.float() @ p.wx.float()
    wh, b = p.wh.float(), p.b.float()
    hs = []
    for t in range(S):
        st = _slstm_step(st, xw[:, t], wh, b)
        hs.append(st.h)
    h = torch.stack(hs, 1).to(dt)
    return h @ p.wout.to(dt), st
