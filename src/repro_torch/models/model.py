"""The model API the server uses, in PyTorch.

Mirrors ``repro.models.model.Model`` and its ``lm_loss``:

  init(seed)                            -> params (an nn.Module)
  loss(params, batch)                   -> (loss, metrics)
  prefill(params, batch, context=)      -> (logits, caches)
  decode(params, tokens, caches, index) -> (logits, caches)
  init_caches(batch, context)
  splice_cache(caches, cache_one, slot)
  param_shapes()                        -> (meta state dict, axes)
  cache_axes(), input_specs(shape)      -> the dry-run's contract

``param_shapes``, ``cache_axes`` and ``input_specs`` are the dry-run's
contract: shapes, types and logical axes of every parameter and input,
as meta tensors (nothing allocated).

Every family of the reference is ported: the hybrid (zamba2), the
decoder-only transformers (dense, moe, vlm), the encoder-decoder (encdec,
whisper) and the xLSTM (ssm).  The model lives on one device: CUDA unless
the caller names the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Tuple, Union

import torch
from torch import nn
from torch.nn import functional as F

from ..device import DeviceLike, resolve_device
from . import encdec, hybrid
from . import transformer as tfm
from . import xlstm_model
from .config import ModelConfig, ShapeConfig
from .initlib import param_axes
from .layers import KVCache, cdt
from .ssm import SSMState
from .xlstm import MLSTMState, SLSTMState

_FAMILY = {"dense": tfm, "moe": tfm, "vlm": tfm, "encdec": encdec,
           "hybrid": hybrid, "ssm": xlstm_model}
META = torch.device("meta")


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
        a ``TransformerLM``, ``HybridLM``, ``EncDecLM`` or ``XLSTMLM``.
        On the meta device (shapes only) the generator is the host's:
        there is no meta generator, and nothing is drawn."""
        gen = seed
        if not isinstance(seed, torch.Generator):
            where = "cpu" if self.device.type == "meta" else self.device
            gen = torch.Generator(device=where).manual_seed(seed)
        return self.mod.init_params(self.cfg, gen, self.device)

    def param_shapes(self) -> Tuple[Dict[str, torch.Tensor],
                                    Dict[str, Tuple]]:
        """(state dict of meta tensors, {name: logical axes}) of the
        model's parameters, without allocating: the reference's
        ``param_shapes``, per layer (``convert.stacks`` restacks the
        names; a stacked leaf's axes gain leading Nones)."""
        params = Model(self.cfg, META).init(0)
        return dict(params.named_parameters()), param_axes(params)

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

    def cache_axes(self):
        """Logical axes of every cache leaf (the ``init_caches`` tree)."""
        kv_ax = KVCache(
            k=(None, "cache_batch", "cache_seq", "cache_heads", None),
            v=(None, "cache_batch", "cache_seq", "cache_heads", None),
            pos=(None, "cache_batch", "cache_seq"))
        family = self.cfg.family
        if family in ("dense", "moe", "vlm"):
            return tfm.DecoderCaches(kv=kv_ax)
        if family == "encdec":
            e = (None, "cache_batch", None, "cache_heads", None)
            return encdec.EncDecCaches(kv=kv_ax, enc_k=e, enc_v=e)
        if family == "hybrid":
            ssm_ax = SSMState(
                h=(None, None, "cache_batch", "ssm_heads", None, None),
                conv=(None, None, "cache_batch", None, "ssm_inner"))
            return hybrid.HybridCaches(ssm=ssm_ax, kv=kv_ax)
        m_ax = MLSTMState(C=(None, "cache_batch", "heads", None, None),
                          n=(None, "cache_batch", "heads", None),
                          m=(None, "cache_batch", "heads"))
        s_ax = SLSTMState(c=(None, "cache_batch", "embed_tp"),
                          n=(None, "cache_batch", "embed_tp"),
                          m=(None, "cache_batch", "embed_tp"),
                          h=(None, "cache_batch", "embed_tp"))
        return xlstm_model.XLSTMCaches(m=m_ax, s=s_ax)

    def input_specs(self, shape: ShapeConfig) -> Tuple[Dict[str, Any],
                                                       Dict[str, Any]]:
        """(meta stand-ins, logical axes) of every input of a (train,
        prefill or decode) step at ``shape``: tokens and labels, each
        family's extras, and for decode one token, the caches of a
        ``seq_len`` context and the position."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        act = cdt(cfg)

        def sds(dims, dtype=torch.int32):
            return torch.empty(dims, dtype=dtype, device=META)

        specs: Dict[str, Any] = {}
        axes: Dict[str, Any] = {}
        if shape.kind in ("train", "prefill"):
            specs["tokens"] = sds((B, S))
            axes["tokens"] = ("batch", None)
            if shape.kind == "train":
                specs["labels"] = sds((B, S))
                axes["labels"] = ("batch", None)
            if cfg.family == "encdec":
                specs["frames"] = sds((B, cfg.enc_seq, cfg.d_model), act)
                axes["frames"] = ("batch", None, None)
            if cfg.family == "vlm":
                specs["patch_embeds"] = sds((B, cfg.n_patches, cfg.d_model),
                                            act)
                axes["patch_embeds"] = ("batch", None, None)
                if shape.kind == "train":
                    specs["positions"] = sds((B, S, 3))
                    axes["positions"] = ("batch", None, None)
            return specs, axes
        specs["tokens"] = sds((B, 1))
        axes["tokens"] = ("batch", None)
        specs["caches"] = Model(cfg, META).init_caches(B, S)
        axes["caches"] = self.cache_axes()
        specs["index"] = sds(())
        axes["index"] = ()
        return specs, axes

    def splice_cache(self, caches, cache_one, slot: int):
        """Write a batch-1 request cache into batch row ``slot`` of
        ``caches``, in place (the reference returns a new pytree)."""
        for full, new, ax in zip(_leaves(caches), _leaves(cache_one),
                                 _leaves(self.cache_batch_axes())):
            full.select(ax, slot).copy_(new.select(ax, 0))
        return caches


def make_model(cfg: ModelConfig, device: DeviceLike = None) -> Model:
    return Model(cfg.validate(), resolve_device(device))
