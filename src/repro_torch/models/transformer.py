"""Decoder-only transformer covering the dense, moe and vlm families, in
PyTorch.

Mirrors ``repro.models.transformer``.  The reference stacks the layers'
parameters and runs them with ``lax.scan`` (``scanning.maybe_scan``);
here they are an ``nn.ModuleList`` walked by a Python loop, which is
that helper's port.  MoE configs swap the MLP for the capacity-based
expert layer (``models/moe.py``); the vlm family adds M-RoPE positions
and (stub-frontend) patch embeddings written over the first
``n_patches`` positions.

Decode state: one KV cache per layer, stacked as the reference stacks
it (``DecoderCaches.kv`` leaves (L, B, ...)); sliding-window configs
keep a ring buffer of ``window`` rows.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import layers as L
from .config import ModelConfig
from .moe import MoE


# The ops whose outputs remat "dots" keeps: the reference's
# ``dots_with_no_batch_dims_saveable`` keeps every product without batch
# dimensions, and the port writes each of those as ``@`` against a 2-D
# view of the weight, which dispatches to ``aten.mm`` (``aten.addmm``
# with a bias).  Products with batch dimensions stay einsums or bmm
# (``aten.bmm``, an einsum's op even without batch dims) and are
# recomputed, as the reference recomputes them.  The flash kernel's
# products launch outside aten, so attention is recomputed too, as the
# reference's ``_attend`` (einsums with batch dims) is.
DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in DOTS_SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_wrap(fn, cfg: ModelConfig):
    """``fn`` (one tensor in) as the reference's ``remat_wrap`` wraps it:
    "none" as it is, "full" recomputed in the backward pass, "dots"
    recomputed but for the outputs of its products without batch
    dimensions (``DOTS_SAVED``).  Where no gradient is wanted
    (``torch.no_grad()``) there is nothing to keep, so every policy
    returns ``fn``."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"{cfg.name}: unknown remat {cfg.remat!r}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         dots_policy))
    return functools.partial(checkpoint, fn, use_reentrant=False)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.ln1 = L.Norm(cfg, device)
        self.attn = L.Attention(cfg, generator, device)
        self.ln2 = L.Norm(cfg, device)
        self.mlp = (MoE(cfg, generator, device) if cfg.family == "moe"
                    else L.MLP(cfg, generator, device))

    def ffn(self, z: torch.Tensor):
        """(the MLP's or the MoE's output, its float32 aux loss)."""
        if self.cfg.family == "moe":
            return self.mlp(z)
        return self.mlp(z), torch.zeros((), dtype=torch.float32,
                                        device=z.device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        """(x after the layer, aux loss, (k, v) of its attention)."""
        cfg = self.cfg
        h, kv = L.attention_forward(self.attn, cfg, self.ln1(x),
                                    positions=positions, causal=True,
                                    window=cfg.window)
        x = x + h
        y, aux = self.ffn(self.ln2(x))
        return x + y, aux, kv

    def train_forward(self, x: torch.Tensor, positions: torch.Tensor):
        x, aux, _ = self(x, positions)
        return x, aux


class DecoderCaches(NamedTuple):
    kv: L.KVCache          # leaves (L, B, ...)


class TransformerLM(nn.Module):
    """The decoder-only language model; its parameters are the
    reference's pytree under module names (``layers.<i>.<leaf>`` for the
    reference's stacked ``layers.<leaf>[i]``)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.embed = L.Embedding(cfg, generator, device)
        self.layers = nn.ModuleList(DecoderLayer(cfg, generator, device)
                                    for _ in range(cfg.n_layers))
        self.ln_f = L.Norm(cfg, device)

    def _inputs(self, tokens, positions, patch_embeds):
        """(embedded tokens with the patch embeds over the first
        positions, positions: 0..S-1 by default, repeated 3 times for
        M-RoPE)."""
        cfg = self.cfg
        x = L.embed_tokens(self.embed, cfg, tokens)
        if patch_embeds is not None:            # vlm stub frontend
            n = patch_embeds.shape[1]
            if n > x.shape[1]:
                raise ValueError(f"{cfg.name}: {n} patch embeds do not fit "
                                 f"a prompt of {x.shape[1]} tokens")
            x = torch.cat([patch_embeds.to(x.dtype), x[:, n:]], 1)
        if positions is None:
            B, S = tokens.shape
            positions = torch.arange(S, dtype=torch.int32,
                                     device=tokens.device).expand(B, S)
            if cfg.mrope:
                positions = positions[..., None].expand(B, S, 3)
        return x, positions

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                patch_embeds: Optional[torch.Tensor] = None):
        """tokens (B, S) -> (float32 logits of every position (B, S, Vp),
        the summed aux loss): the reference's ``transformer.forward``."""
        cfg = self.cfg
        x, positions = self._inputs(tokens, positions, patch_embeds)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in self.layers:
            body = remat_wrap(functools.partial(layer.train_forward,
                                                positions=positions), cfg)
            x, a = body(x)
            aux = aux + a
        x = self.ln_f(x)
        return L.logits_from_hidden(self.embed, cfg, x), aux

    def prefill(self, tokens: torch.Tensor, *, context: int,
                positions: Optional[torch.Tensor] = None,
                patch_embeds: Optional[torch.Tensor] = None):
        """tokens (B, S) -> (logits of the last position (B, 1, Vp),
        DecoderCaches for ``context`` positions)."""
        cfg = self.cfg
        x, positions = self._inputs(tokens, positions, patch_embeds)
        caches = []
        for layer in self.layers:
            x, _, (k, v) = layer(x, positions)
            caches.append(L.cache_from_prefill(cfg, k, v, context))
        x = self.ln_f(x[:, -1:])
        logits = L.logits_from_hidden(self.embed, cfg, x)
        kv = L.KVCache(*(torch.stack(t) for t in zip(*caches)))
        return logits, DecoderCaches(kv=kv)

    def decode_step(self, tokens: torch.Tensor, caches: DecoderCaches,
                    index: int):
        """tokens (B, 1) at absolute position ``index`` -> (logits
        (B, 1, Vp), caches).  Updates ``caches`` in place and returns
        them (the reference returns new ones)."""
        cfg = self.cfg
        x = L.embed_tokens(self.embed, cfg, tokens)
        for i, layer in enumerate(self.layers):
            kv = L.KVCache(*(t[i] for t in caches.kv))
            h, _ = L.attention_decode(layer.attn, cfg, layer.ln1(x), kv,
                                      index)
            x = x + h
            x = x + layer.ffn(layer.ln2(x))[0]
        x = self.ln_f(x)
        return L.logits_from_hidden(self.embed, cfg, x), caches


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device) -> TransformerLM:
    return TransformerLM(cfg, generator, device)


def init_caches(cfg: ModelConfig, batch: int, context: int,
                device: torch.device,
                dtype: Optional[torch.dtype] = None) -> DecoderCaches:
    dtype = dtype or L.cdt(cfg)
    one = L.init_kv_cache(cfg, batch, context, dtype, device)
    return DecoderCaches(kv=L.KVCache(
        *(t.expand((cfg.n_layers,) + t.shape).clone() for t in one)))
