"""The training step: loss -> gradients -> (optional compression) ->
AdamW, with optional microbatch gradient accumulation.

Mirrors ``repro.train.train_step``.  ``make_train_step(model, opt_cfg,
...)`` returns ``step(state, batch) -> (state, metrics)`` with the
reference's metric keys (``loss nll z_loss aux ppl_proxy lr
grad_norm``).  The reference's step is a pure function for ``jax.jit``;
this one updates the state's parameters and moments in place (see
``optim.adamw_update``) and returns the state with the new step count.
Gradients come from torch's autograd through the model, whose two
kernels have backward kernels of their own.  ``state_axes`` gives the
state's logical axes for the sharding rules (``parallel.sharding``).
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, \
    Tuple

import torch
from torch import nn

from ..convert import stacks
from ..models.model import Model
from . import compression as comp
from .optim import AdamWConfig, OptState, Tree, adamw_init, adamw_update

METRICS = ("loss", "nll", "z_loss", "aux", "ppl_proxy")


class TrainState(NamedTuple):
    params: nn.Module              # gradients on
    opt: OptState
    ef: Optional[comp.EFState]     # error feedback (None = off)


def param_tree(params: nn.Module) -> Tree:
    """The parameters as a dict keyed by name (the optimizer's trees)."""
    return dict(params.named_parameters())


def _stacked(params: nn.Module) -> Iterator[Tuple[str, int, str]]:
    """(name, the reference's leading dims of its leaf, the leaf's name
    within a layer) of every parameter of a per-layer stack: the
    reference stacks those layers' leaves (``convert.stacks``), and the
    port names layer ``i`` of a stack ``<stack>.<i>.<leaf>``."""
    layout = stacks(params.cfg)
    for n, _ in params.named_parameters():
        for _, lead, port in layout:
            if n.startswith(port + "."):
                yield n, len(lead), f"{port}.{n.split('.', 2)[2]}"
                break


def stacked_groups(params: nn.Module) -> List[List[str]]:
    """For each per-layer parameter, its name in every layer of its
    stack, in layer order: the reference's stacked leaf, row-major."""
    out: Dict[str, List[str]] = {}
    for n, _, leaf in _stacked(params):
        out.setdefault(leaf, []).append(n)
    return list(out.values())


def decay_mask(params: nn.Module) -> Dict[str, float]:
    """The reference's weight-decay mask, ``ndim >= 2`` of its leaves: it
    stacks the layers' parameters ((L, ...); the hybrid's Mamba2 layers
    (G, per, ...)), so their norm scales, biases and per-head vectors are
    decayed too, and a port parameter of a stack counts its leading
    dims."""
    lead = {n: k for n, k, _ in _stacked(params)}
    return {n: float(p.dim() + lead.get(n, 0) >= 2)
            for n, p in params.named_parameters()}


def state_axes(param_axes, compress: bool = False) -> TrainState:
    """Logical axes of the whole TrainState: the moments (and the
    error-feedback residual, with compression) mirror the parameters,
    the step count is a scalar."""
    ef = comp.EFState(residual=param_axes) if compress else None
    return TrainState(params=param_axes,
                      opt=OptState(step=(), mu=param_axes, nu=param_axes),
                      ef=ef)


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
    def grads_of(params: nn.Module, tree: Tree, batch) -> Tuple[Tree, Dict]:
        loss, metrics = model.loss(params, batch)
        grads = torch.autograd.grad(loss, list(tree.values()))
        return dict(zip(tree, grads)), {k: metrics[k].detach()
                                        for k in METRICS}

    def accumulate(params: nn.Module, batch) -> Tuple[Tree, Dict]:
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

