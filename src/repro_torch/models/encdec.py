"""Whisper-style encoder-decoder (the encdec family), in PyTorch.

Mirrors ``repro.models.encdec``.  The audio frontend is a stub, as in the
reference: a request brings precomputed frame embeddings (B, enc_seq, D)
("frames").  Learned absolute position tables replace RoPE in both
stacks.  The encoder is non-causal self-attention over the frames; each
decoder layer has causal self-attention (cached for decode) and
cross-attention to the encoder's output, whose k/v are computed once at
prefill and stay static through decode.

Every full-sequence attention goes through the flash-attention kernel:
a prefill launches it ``n_enc_layers + 2 * n_layers`` times (the encoder,
then each decoder layer's self- and cross-attention).  The layers are
``nn.ModuleList``s walked by a Python loop (the reference stacks them and
scans); ``repro_torch.convert`` maps ``enc_layers.<i>.<leaf>`` and
``dec_layers.<i>.<leaf>`` to the reference's stacked leaves.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
from torch import nn

from . import layers as L
from .config import ModelConfig
from .initlib import dense_init
from .transformer import remat_wrap


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.ln1 = L.Norm(cfg, device)
        self.attn = L.Attention(cfg, generator, device)
        self.ln2 = L.Norm(cfg, device)
        self.mlp = L.MLP(cfg, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, _ = L.attention_forward(self.attn, self.cfg, self.ln1(x),
                                   causal=False, use_rope=False)
        x = x + h
        return x + self.mlp(self.ln2(x))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.ln1 = L.Norm(cfg, device)
        self.self_attn = L.Attention(cfg, generator, device)
        self.ln_x = L.Norm(cfg, device)
        self.cross_attn = L.Attention(cfg, generator, device)
        self.ln2 = L.Norm(cfg, device)
        self.mlp = L.MLP(cfg, generator, device)

    def forward(self, x: torch.Tensor, enc_out: torch.Tensor):
        """(x after the layer, (k, v) of its self-attention, (k, v) of
        its cross-attention over ``enc_out``)."""
        cfg = self.cfg
        h, kv = L.attention_forward(self.self_attn, cfg, self.ln1(x),
                                    causal=True, use_rope=False)
        x = x + h
        h, enc_kv = L.attention_forward(self.cross_attn, cfg, self.ln_x(x),
                                        causal=False, xkv=enc_out,
                                        use_rope=False)
        x = x + h
        return x + self.mlp(self.ln2(x)), kv, enc_kv

    def train_forward(self, x: torch.Tensor,
                      enc_out: torch.Tensor) -> torch.Tensor:
        return self(x, enc_out)[0]


class EncDecCaches(NamedTuple):
    kv: L.KVCache          # decoder self-attention, leaves (L_dec, B, ...)
    enc_k: torch.Tensor    # (L_dec, B, enc_seq, KV, hd)
    enc_v: torch.Tensor


class EncDecLM(nn.Module):
    """The encoder-decoder; its parameters are the reference's pytree
    under module names."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        self.cfg = cfg
        D, g = cfg.d_model, generator
        self.embed = L.Embedding(cfg, g, device)
        self.enc_pos = L.param(dense_init((cfg.enc_seq, D), g, device))
        self.dec_pos = L.param(dense_init((1 << 16, D), g, device))
        self.logical_axes = {"enc_pos": (None, "embed"),
                             "dec_pos": (None, "embed")}
        self.enc_layers = nn.ModuleList(EncoderLayer(cfg, g, device)
                                        for _ in range(cfg.n_enc_layers))
        self.ln_enc = L.Norm(cfg, device)
        self.dec_layers = nn.ModuleList(DecoderLayer(cfg, g, device)
                                        for _ in range(cfg.n_layers))
        self.ln_f = L.Norm(cfg, device)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, T, D) stub-frontend embeddings -> (B, T, D)."""
        cfg = self.cfg
        x = frames.to(L.cdt(cfg))
        x = x + self.enc_pos[None, :x.shape[1]].to(x.dtype)
        for layer in self.enc_layers:
            x = remat_wrap(layer, cfg)(x)
        return self.ln_enc(x)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = L.embed_tokens(self.embed, self.cfg, tokens)
        return x + self.dec_pos[None, :tokens.shape[1]].to(x.dtype)

    def forward(self, tokens: torch.Tensor, frames: torch.Tensor):
        """Teacher-forced forward: tokens (B, S), frames (B, T, D) ->
        (float32 logits of every position (B, S, Vp), aux loss 0)."""
        cfg = self.cfg
        enc_out = self.encode(frames)
        x = self._embed(tokens)
        for layer in self.dec_layers:
            x = remat_wrap(functools.partial(layer.train_forward,
                                             enc_out=enc_out), cfg)(x)
        x = self.ln_f(x)
        return (L.logits_from_hidden(self.embed, cfg, x),
                torch.zeros((), dtype=torch.float32, device=x.device))

    def prefill(self, tokens: torch.Tensor, frames: torch.Tensor, *,
                context: int):
        """tokens (B, S), frames (B, T, D) -> (logits of the last position
        (B, 1, Vp), EncDecCaches for ``context`` decoder positions)."""
        cfg = self.cfg
        enc_out = self.encode(frames)
        x = self._embed(tokens)
        kvs, eks, evs = [], [], []
        for layer in self.dec_layers:
            x, (k, v), (ek, ev) = layer(x, enc_out)
            kvs.append(L.cache_from_prefill(cfg, k, v, context))
            eks.append(ek)
            evs.append(ev)
        x = self.ln_f(x[:, -1:])
        logits = L.logits_from_hidden(self.embed, cfg, x)
        kv = L.KVCache(*(torch.stack(t) for t in zip(*kvs)))
        return logits, EncDecCaches(kv=kv, enc_k=torch.stack(eks),
                                    enc_v=torch.stack(evs))

    def decode_step(self, tokens: torch.Tensor, caches: EncDecCaches,
                    index: int):
        """tokens (B, 1) at absolute position ``index`` -> (logits
        (B, 1, Vp), caches).  Updates the self-attention caches in place
        and returns them; the encoder's k/v stay as prefill wrote them."""
        cfg = self.cfg
        x = L.embed_tokens(self.embed, cfg, tokens)
        x = x + self.dec_pos[index][None, None].to(x.dtype)
        for i, layer in enumerate(self.dec_layers):
            kv = L.KVCache(*(t[i] for t in caches.kv))
            h, _ = L.attention_decode(layer.self_attn, cfg, layer.ln1(x), kv,
                                      index, use_rope=False)
            x = x + h
            enc_kv = (caches.enc_k[i].to(x.dtype),
                      caches.enc_v[i].to(x.dtype))
            h, _ = L.attention_decode(layer.cross_attn, cfg, layer.ln_x(x),
                                      kv, index, enc_kv=enc_kv,
                                      use_rope=False)
            x = x + h
            x = x + layer.mlp(layer.ln2(x))
        x = self.ln_f(x)
        return L.logits_from_hidden(self.embed, cfg, x), caches


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device) -> EncDecLM:
    return EncDecLM(cfg, generator, device)


def init_caches(cfg: ModelConfig, batch: int, context: int,
                device: torch.device,
                dtype: Optional[torch.dtype] = None) -> EncDecCaches:
    dtype = dtype or L.cdt(cfg)
    one = L.init_kv_cache(cfg, batch, context, dtype, device)
    kv = L.KVCache(*(t.expand((cfg.n_layers,) + t.shape).clone()
                     for t in one))
    shape = (cfg.n_layers, batch, cfg.enc_seq, cfg.n_kv_heads, cfg.hd)
    return EncDecCaches(kv=kv,
                        enc_k=torch.zeros(shape, dtype=dtype, device=device),
                        enc_v=torch.zeros(shape, dtype=dtype, device=device))
