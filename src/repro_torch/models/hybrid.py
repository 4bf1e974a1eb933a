"""zamba2-style hybrid: a Mamba2 backbone plus one *shared* attention
block, in PyTorch.

Mirrors ``repro.models.hybrid``: ``n_layers`` Mamba2 layers in groups of
``shared_attn_every``; after each group the one shared transformer block
(attention + MLP, a single parameter set reused by every group) is
applied.  Zamba2's per-application LoRA adapters are omitted, as in the
reference.  The layers are an ``nn.ModuleList`` (the reference stacks
them for ``lax.scan``); the loops over groups and layers are Python.

Decode state: one SSM state per Mamba2 layer and one KV cache per
shared-block application, stacked as the reference stacks them:
``ssm`` leaves (G, per, B, ...), ``kv`` leaves (G, B, ...).

Training runs ``HybridLM.forward`` (the reference's ``forward``): the
logits of every position, each Mamba2 layer and each shared-block
application wrapped by ``transformer.remat_wrap``, as the reference's
``remat_wrap`` wraps them (``cfg.remat``: "full" recomputes the wrapped
call in the backward pass, through ``torch.utils.checkpoint``; "none"
keeps its activations).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from . import layers as L
from .config import ModelConfig
from .ssm import Mamba2Mixer, SSMState, init_ssm_state
from .transformer import remat_wrap


def groups(cfg: ModelConfig) -> Tuple[int, int]:
    """(number of groups, Mamba2 layers per group)."""
    per = cfg.shared_attn_every
    if per < 1 or cfg.n_layers % per:
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} is not a "
                         f"multiple of shared_attn_every={per}")
    return cfg.n_layers // per, per


class HybridCaches(NamedTuple):
    ssm: SSMState        # leaves (G, per, B, ...)
    kv: L.KVCache        # leaves (G, B, ...)


class MambaLayer(nn.Module):
    def __init__(self, cfg, generator, device):
        super().__init__()
        self.ln = L.Norm(cfg, device)
        self.mix = Mamba2Mixer(cfg, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Training: x after the layer (its state is dropped)."""
        return x + self.mix(self.ln(x))[0]


class SharedBlock(nn.Module):
    def __init__(self, cfg, generator, device):
        super().__init__()
        self.ln1 = L.Norm(cfg, device)
        self.attn = L.Attention(cfg, generator, device)
        self.ln2 = L.Norm(cfg, device)
        self.mlp = L.MLP(cfg, generator, device)

    def forward(self, x: torch.Tensor):
        """Prefill: (x after the block, (k, v) of its attention)."""
        h, kv = self.attn(self.ln1(x), causal=True)
        x = x + h
        return x + self.mlp(self.ln2(x)), kv

    def train_forward(self, x: torch.Tensor) -> torch.Tensor:
        return self(x)[0]


class HybridLM(nn.Module):
    """The hybrid language model; its parameters are the reference's
    pytree under module names (``layers.{g * per + i}`` for mamba layer i
    of group g)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        self.cfg = cfg
        groups(cfg)
        self.embed = L.Embedding(cfg, generator, device)
        self.layers = nn.ModuleList(MambaLayer(cfg, generator, device)
                                    for _ in range(cfg.n_layers))
        self.shared = SharedBlock(cfg, generator, device)
        self.ln_f = L.Norm(cfg, device)

    def forward(self, tokens: torch.Tensor):
        """tokens (B, S) -> (float32 logits of every position (B, S, Vp),
        aux loss 0.0): the reference's ``hybrid.forward``."""
        cfg = self.cfg
        _, per = groups(cfg)
        mamba = [remat_wrap(layer, cfg) for layer in self.layers]
        shared = remat_wrap(self.shared.train_forward, cfg)
        x = L.embed_tokens(self.embed, cfg, tokens)
        for layer_i, body in enumerate(mamba):
            x = body(x)
            if (layer_i + 1) % per == 0:
                x = shared(x)
        x = self.ln_f(x)
        return (L.logits_from_hidden(self.embed, cfg, x),
                torch.zeros((), dtype=torch.float32, device=x.device))

    def prefill(self, tokens: torch.Tensor, *, context: int):
        """tokens (B, S) -> (logits of the last position (B, 1, Vp),
        HybridCaches for ``context`` positions)."""
        cfg = self.cfg
        G, per = groups(cfg)
        x = L.embed_tokens(self.embed, cfg, tokens)
        hs, convs, kvs = [], [], []
        for layer_i, layer in enumerate(self.layers):
            y, st = layer.mix(layer.ln(x))
            x = x + y
            hs.append(st.h)
            convs.append(st.conv)
            if (layer_i + 1) % per == 0:
                x, (k, v) = self.shared(x)
                kvs.append(L.cache_from_prefill(cfg, k, v, context))
        x = self.ln_f(x[:, -1:])
        logits = L.logits_from_hidden(self.embed, cfg, x)
        ssm = SSMState(h=torch.stack(hs).unflatten(0, (G, per)),
                       conv=torch.stack(convs).unflatten(0, (G, per)))
        kv = L.KVCache(*(torch.stack(t) for t in zip(*kvs)))
        return logits, HybridCaches(ssm=ssm, kv=kv)

    def decode_step(self, tokens: torch.Tensor, caches: HybridCaches,
                    index: int):
        """tokens (B, 1) at absolute position ``index`` -> (logits
        (B, 1, Vp), caches).  Updates ``caches`` in place and returns
        them (the reference returns new ones)."""
        cfg = self.cfg
        G, per = groups(cfg)
        x = L.embed_tokens(self.embed, cfg, tokens)
        sh = self.shared
        for g in range(G):
            for i in range(per):
                layer = self.layers[g * per + i]
                st = SSMState(caches.ssm.h[g, i], caches.ssm.conv[g, i])
                y, st = layer.mix.decode(layer.ln(x), st)
                x = x + y
                caches.ssm.h[g, i] = st.h
                caches.ssm.conv[g, i] = st.conv
            kv = L.KVCache(*(t[g] for t in caches.kv))
            h, _ = L.attention_decode(sh.attn, cfg, sh.ln1(x), kv, index)
            x = x + h
            x = x + sh.mlp(sh.ln2(x))
        x = self.ln_f(x)
        return L.logits_from_hidden(self.embed, cfg, x), caches


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device) -> HybridLM:
    return HybridLM(cfg, generator, device)


def init_caches(cfg: ModelConfig, batch: int, context: int,
                device: torch.device,
                dtype: Optional[torch.dtype] = None) -> HybridCaches:
    dtype = dtype or L.cdt(cfg)
    G, per = groups(cfg)
    one = init_ssm_state(cfg, batch, device)
    ssm = SSMState(*(t.expand((G, per) + t.shape).clone() for t in one))
    kv1 = L.init_kv_cache(cfg, batch, context, dtype, device)
    kv = L.KVCache(*(t.expand((G,) + t.shape).clone() for t in kv1))
    return HybridCaches(ssm=ssm, kv=kv)
