"""xlstm-350m's language model (the ssm family), in PyTorch: alternating
mLSTM / sLSTM blocks.

Mirrors ``repro.models.xlstm_model``: ``n_layers // 2`` (mLSTM, sLSTM)
pairs with pre-norm residuals, no separate FFN.  The pairs are an
``nn.ModuleList`` (the reference stacks them and scans);
``repro_torch.convert`` maps ``pairs.<i>.<leaf>`` to its stacked leaves.
The decode state is the cells' recurrent state, O(1) in the sequence
length, stacked as the reference stacks it: ``XLSTMCaches`` leaves
(pairs, B, ...).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from . import layers as L
from . import xlstm as X
from .config import ModelConfig
from .transformer import remat_wrap


def pairs(cfg: ModelConfig) -> int:
    if cfg.n_layers % 2:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                         f"whole number of (mLSTM, sLSTM) pairs")
    return cfg.n_layers // 2


class Pair(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.ln_m = L.Norm(cfg, device)
        self.mlstm = X.MLSTM(cfg, generator, device)
        self.ln_s = L.Norm(cfg, device)
        self.slstm = X.SLSTM(cfg, generator, device)

    def forward(self, x: torch.Tensor,
                mstate: Optional[X.MLSTMState] = None,
                sstate: Optional[X.SLSTMState] = None):
        """(x after the pair, its mLSTM state, its sLSTM state)."""
        y, ms = self.mlstm(self.ln_m(x), mstate)
        x = x + y
        y, ss = self.slstm(self.ln_s(x), sstate)
        return x + y, ms, ss

    def train_forward(self, x: torch.Tensor) -> torch.Tensor:
        return self(x)[0]


class XLSTMCaches(NamedTuple):
    m: X.MLSTMState        # leaves (pairs, B, ...)
    s: X.SLSTMState


class XLSTMLM(nn.Module):
    """The xLSTM language model; its parameters are the reference's
    pytree under module names."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.embed = L.Embedding(cfg, generator, device)
        self.pairs = nn.ModuleList(Pair(cfg, generator, device)
                                   for _ in range(pairs(cfg)))
        self.ln_f = L.Norm(cfg, device)

    def forward(self, tokens: torch.Tensor):
        """tokens (B, S) -> (float32 logits of every position (B, S, Vp),
        aux loss 0)."""
        cfg = self.cfg
        x = L.embed_tokens(self.embed, cfg, tokens)
        for pair in self.pairs:
            x = remat_wrap(pair.train_forward, cfg)(x)
        x = self.ln_f(x)
        return (L.logits_from_hidden(self.embed, cfg, x),
                torch.zeros((), dtype=torch.float32, device=x.device))

    def prefill(self, tokens: torch.Tensor, *, context: int):
        """tokens (B, S) -> (logits of the last position (B, 1, Vp),
        XLSTMCaches after the prompt); ``context`` is unused: the state
        does not grow."""
        x = L.embed_tokens(self.embed, self.cfg, tokens)
        ms, ss = [], []
        for pair in self.pairs:
            x, m, s = pair(x)
            ms.append(m)
            ss.append(s)
        x = self.ln_f(x[:, -1:])
        return (L.logits_from_hidden(self.embed, self.cfg, x),
                XLSTMCaches(m=X.MLSTMState(*map(torch.stack, zip(*ms))),
                            s=X.SLSTMState(*map(torch.stack, zip(*ss)))))

    def decode_step(self, tokens: torch.Tensor, caches: XLSTMCaches,
                    index: int):
        """tokens (B, 1) -> (logits (B, 1, Vp), caches), the states
        updated in place; ``index`` is unused (no positions)."""
        x = L.embed_tokens(self.embed, self.cfg, tokens)
        for i, pair in enumerate(self.pairs):
            x, m, s = pair(x, X.MLSTMState(*(t[i] for t in caches.m)),
                           X.SLSTMState(*(t[i] for t in caches.s)))
            for full, new in zip(caches.m + caches.s, m + s):
                full[i] = new
        x = self.ln_f(x)
        return L.logits_from_hidden(self.embed, self.cfg, x), caches


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device) -> XLSTMLM:
    return XLSTMLM(cfg, generator, device)


def init_caches(cfg: ModelConfig, batch: int, context: int,
                device: torch.device,
                dtype: Optional[torch.dtype] = None) -> XLSTMCaches:
    """The cells' initial state for ``batch`` slots, stacked over the
    pairs; ``context`` and ``dtype`` are unused (the state is float32 and
    does not grow)."""
    n = pairs(cfg)

    def stack(one):
        return type(one)(*(t.expand((n,) + t.shape).clone() for t in one))

    return XLSTMCaches(m=stack(X.init_mlstm_state(cfg, batch, device)),
                       s=stack(X.init_slstm_state(cfg, batch, device)))
