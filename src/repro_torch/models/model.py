"""The model API the server uses, in PyTorch.

Mirrors ``repro.models.model.Model`` and its ``lm_loss``:

  init(seed)                            -> params (an nn.Module)
  loss(params, batch)                   -> (loss, metrics)
  prefill(params, batch, context=)      -> (logits, caches)
  decode(params, tokens, caches, index) -> (logits, caches)
  init_caches(batch, context)
  splice_cache(caches, cache_one, slot)

Every family of the reference is ported: the hybrid (zamba2), the
decoder-only transformers (dense, moe, vlm), the encoder-decoder (encdec,
whisper) and the xLSTM (ssm).  The model lives on one device: CUDA unless
the caller names the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Union

import torch
from torch import nn
from torch.nn import functional as F

from ..device import DeviceLike, resolve_device
from . import encdec, hybrid
from . import transformer as tfm
from . import xlstm_model
from .config import ModelConfig
from .layers import KVCache
from .ssm import SSMState
from .xlstm import MLSTMState, SLSTMState

_FAMILY = {"dense": tfm, "moe": tfm, "vlm": tfm, "encdec": encdec,
           "hybrid": hybrid, "ssm": xlstm_model}


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, aux: torch.Tensor,
            z_coef: float = 1e-4, ce_impl: str = "gather"):
    """Token-mean cross entropy plus z-loss and aux, float32 throughout.
    The padded vocabulary columns carry -1e9 logits, so the log-sum-exp
    over them is exact; ``ce_impl="onehot"`` contracts the vocabulary
    against a one-hot instead of gathering it (the same number)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    if ce_impl == "onehot":
        oh = F.one_hot(labels.long(), logits.shape[-1]).float()
        ll = torch.einsum("bsv,bsv->bs", logits, oh)
    else:
        ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = torch.mean(lse - ll)
    zl = z_coef * torch.mean(torch.square(lse))
    loss = nll + zl + aux
    return loss, {"loss": loss, "nll": nll, "z_loss": zl, "aux": aux,
                  "ppl_proxy": torch.exp(torch.clamp(nll, max=20.0))}


def _leaves(tree) -> Iterator:
    if isinstance(tree, tuple):
        for t in tree:
            yield from _leaves(t)
    else:
        yield tree


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device

    @property
    def mod(self):
        return _FAMILY[self.cfg.family]

    def init(self, seed: Union[int, torch.Generator] = 0) -> nn.Module:
        """Fresh parameters on the model's device, drawn from ``seed`` (a
        ``torch.Generator`` on that device, or an integer seeding one):
        a ``TransformerLM``, ``HybridLM``, ``EncDecLM`` or ``XLSTMLM``."""
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=self.device).manual_seed(seed)
        return self.mod.init_params(self.cfg, gen, self.device)

    def loss(self, params: nn.Module, batch: Dict[str, torch.Tensor]):
        """(loss, metrics) of a batch {"tokens", "labels"} (B, S), and for
        the vlm family the optional "positions" (B, S, 3) and
        "patch_embeds" (B, n_patches, D), for the encdec family the
        "frames" (B, enc_seq, D)."""
        if self.cfg.family == "encdec":
            logits, aux = params(batch["tokens"], batch["frames"])
        elif self.cfg.family == "vlm":
            logits, aux = params(batch["tokens"],
                                 positions=batch.get("positions"),
                                 patch_embeds=batch.get("patch_embeds"))
        else:
            logits, aux = params(batch["tokens"])
        return lm_loss(logits, batch["labels"], aux,
                       ce_impl=self.cfg.ce_impl)

    @torch.no_grad()
    def prefill(self, params: nn.Module, batch: Dict[str, torch.Tensor], *,
                context: int = 0):
        """(last-position logits, caches); the vlm family takes the
        batch's optional "patch_embeds" and the encdec family its
        "frames", as the reference does.  Serving wants no gradient, so
        prefill and decode record none (and every remat policy, "dots"
        too, runs the plain function)."""
        context = context or batch["tokens"].shape[1]
        if self.cfg.family == "encdec":
            return params.prefill(batch["tokens"], batch["frames"],
                                  context=context)
        if self.cfg.family == "vlm":
            return params.prefill(batch["tokens"], context=context,
                                  patch_embeds=batch.get("patch_embeds"))
        return params.prefill(batch["tokens"], context=context)

    @torch.no_grad()
    def decode(self, params: nn.Module, tokens: torch.Tensor, caches,
               index: int):
        return params.decode_step(tokens, caches, index)

    def init_caches(self, batch: int, context: int):
        return self.mod.init_caches(self.cfg, batch, context, self.device)

    def cache_batch_axes(self):
        """The batch axis of every cache leaf (for slot splicing)."""
        kv1 = KVCache(k=1, v=1, pos=1)
        family = self.cfg.family
        if family == "hybrid":
            return hybrid.HybridCaches(ssm=SSMState(h=2, conv=2), kv=kv1)
        if family == "encdec":
            return encdec.EncDecCaches(kv=kv1, enc_k=1, enc_v=1)
        if family == "ssm":
            return xlstm_model.XLSTMCaches(
                m=MLSTMState(C=1, n=1, m=1),
                s=SLSTMState(c=1, n=1, m=1, h=1))
        return tfm.DecoderCaches(kv=kv1)

    def splice_cache(self, caches, cache_one, slot: int):
        """Write a batch-1 request cache into batch row ``slot`` of
        ``caches``, in place (the reference returns a new pytree)."""
        for full, new, ax in zip(_leaves(caches), _leaves(cache_one),
                                 _leaves(self.cache_batch_axes())):
            full.select(ax, slot).copy_(new.select(ax, 0))
        return caches


def make_model(cfg: ModelConfig, device: DeviceLike = None) -> Model:
    return Model(cfg.validate(), resolve_device(device))
