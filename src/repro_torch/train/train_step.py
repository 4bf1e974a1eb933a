"""The training step: loss -> gradients -> (optional compression) ->
AdamW, with optional microbatch gradient accumulation.

Mirrors ``repro.train.train_step``.  ``make_train_step(model, opt_cfg,
...)`` returns ``step(state, batch) -> (state, metrics)`` with the
reference's metric keys (``loss nll z_loss aux ppl_proxy lr
grad_norm``).  The reference's step is a pure function for ``jax.jit``;
this one updates the state's parameters and moments in place (see
``optim.adamw_update``) and returns the state with the new step count.
Gradients come from torch's autograd through the model, whose two
kernels have backward kernels of their own.  The sharding axes of the
state (``state_axes``) wait for the LM sharding rules (ROADMAP.md).
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..models.hybrid import HybridLM
from ..models.model import Model
from . import compression as comp
from .optim import AdamWConfig, OptState, Tree, adamw_init, adamw_update

METRICS = ("loss", "nll", "z_loss", "aux", "ppl_proxy")


class TrainState(NamedTuple):
    params: HybridLM               # gradients on
    opt: OptState
    ef: Optional[comp.EFState]     # error feedback (None = off)


def param_tree(params: HybridLM) -> Tree:
    """The parameters as a dict keyed by name (the optimizer's trees)."""
    return dict(params.named_parameters())


def stacked_groups(params: HybridLM) -> List[List[str]]:
    """For each Mamba2 parameter, its name in every layer, in layer
    order: the reference's stacked (G, per, ...) leaf, row-major."""
    out: Dict[str, List[str]] = {}
    for n, _ in params.named_parameters():
        if n.startswith("layers."):
            out.setdefault(n.split(".", 2)[2], []).append(n)
    return list(out.values())


def decay_mask(params: HybridLM) -> Dict[str, float]:
    """The reference's weight-decay mask, ``ndim >= 2`` of its leaves:
    it stacks the Mamba2 layers' parameters (G, per, ...), so their norm
    scales, biases and per-head vectors are decayed too, and the port's
    ``layers.<k>.*`` count two more dimensions."""
    return {n: float(p.dim() + 2 * n.startswith("layers.") >= 2)
            for n, p in params.named_parameters()}


def train_state_init(model: Model, seed, opt_cfg: AdamWConfig,
                     compress: bool = False) -> TrainState:
    params = model.init(seed).requires_grad_(True)
    tree = param_tree(params)
    return TrainState(params=params, opt=adamw_init(tree),
                      ef=comp.ef_init(tree) if compress else None)


def make_train_step(model: Model, opt_cfg: AdamWConfig, *,
                    microbatch: Optional[int] = None,
                    compress_grads: bool = False
                    ) -> Callable[[TrainState, Dict],
                                  Tuple[TrainState, Dict]]:
    """microbatch: the number of slices of the batch whose gradients are
    summed in float32 and divided by their count (the per-slice batch is
    global_batch // microbatch)."""
    if model.cfg.family != "hybrid":
        # the decay mask and the stacked groups below are the hybrid's
        raise NotImplementedError(
            f"{model.cfg.name}: training the {model.cfg.family!r} family "
            f"is not ported yet (only 'hybrid' trains); ROADMAP.md queue 1 "
            f"lists it")

    def grads_of(params: HybridLM, tree: Tree, batch) -> Tuple[Tree, Dict]:
        loss, metrics = model.loss(params, batch)
        grads = torch.autograd.grad(loss, list(tree.values()))
        return dict(zip(tree, grads)), {k: metrics[k].detach()
                                        for k in METRICS}

    def accumulate(params: HybridLM, batch) -> Tuple[Tree, Dict]:
        tree = param_tree(params)
        if not microbatch or microbatch <= 1:
            return grads_of(params, tree, batch)
        B = batch["tokens"].shape[0]
        if B % microbatch:
            raise ValueError(f"batch {B} is not a multiple of microbatch "
                             f"{microbatch}")
        mb = B // microbatch
        grads = {n: torch.zeros_like(p, dtype=torch.float32)
                 for n, p in tree.items()}
        metrics = dict.fromkeys(METRICS, 0.0)
        for i in range(microbatch):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            g, m = grads_of(params, tree, part)
            for n in grads:
                grads[n].add_(g[n].float())
            metrics = {k: metrics[k] + m[k] for k in METRICS}
        inv = 1.0 / microbatch
        for g in grads.values():
            g.mul_(inv)
        return grads, {k: v * inv for k, v in metrics.items()}

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        grads, metrics = accumulate(state.params, batch)
        ef = state.ef
        if compress_grads and ef is not None:
            grads, ef = comp.ef_compress_grads(grads, ef,
                                               stacked_groups(state.params))
        _, opt, opt_metrics = adamw_update(opt_cfg, param_tree(state.params),
                                           grads, state.opt,
                                           decay_mask(state.params))
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return TrainState(params=state.params, opt=opt, ef=ef), metrics

    return step

