"""Carry the reference's inputs across to the port.

For the CGRA estimator the state two runs must share is the
characterization profile, the programs and the hardware configurations;
for the model it is the weights, and for training also the optimizer's
moments, its step and the error-feedback residual.  Each function takes the
reference object's fields as plain numpy / Python values
(``dataclasses.asdict`` of a ``Profile`` or ``Program``,
``HwConfig.as_dict()``, the parameter pytree as numpy arrays) and builds
the port's object, so a test feeds both packages identical inputs
without this package importing the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .core.characterization import Profile
from .core.hwconfig import HwConfig
from .core.program import Program

_INT_FIELDS = ("lat", "t_mem")


def profile_from_numpy(fields: Dict[str, Any]) -> Profile:
    """Reference ``Profile`` fields -> the port's ``Profile`` (same values,
    same numpy dtypes)."""
    kw = {}
    for name, value in fields.items():
        if isinstance(value, np.ndarray):
            kw[name] = value.astype(np.int32 if name in _INT_FIELDS
                                    else np.float32)
        else:
            kw[name] = int(value) if name in _INT_FIELDS else float(value)
    return Profile(**kw)


def program_from_numpy(fields: Dict[str, Any]) -> Program:
    """Reference ``Program`` fields -> the port's validated ``Program``."""
    arrays = {k: np.asarray(fields[k], np.int32)
              for k in ("ops", "dest", "srcA", "srcB", "imm")}
    return Program(name=str(fields.get("name", "kernel")),
                   **arrays).validate()


def hwconfig_from_numpy(fields: Dict[str, Any]) -> HwConfig:
    """Reference ``HwConfig.as_dict()`` (scalars or stacked arrays) -> the
    port's ``HwConfig`` (int32 / float32 tensors of the same shape)."""
    return HwConfig(**{f: np.array(fields[f]) for f in HwConfig.FIELDS})


def _flat(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def stacks(cfg):
    """The reference's stacks of per-layer leaves, each (its name, the
    leaves' leading dims, the port's name): hybrid Mamba2 layers
    ``mamba.<leaf>`` (G, per, ...) as ``layers``, transformer layers
    ``layers.<leaf>`` (L, ...), the encoder-decoder's ``enc_layers`` and
    ``dec_layers``, the xLSTM's ``pairs``.  The port names layer ``i`` of
    a row-major stack ``<port name>.<i>``."""
    if cfg.family == "hybrid":
        from .models.hybrid import groups
        return [("mamba", groups(cfg), "layers")]
    if cfg.family == "encdec":
        return [("enc_layers", (cfg.n_enc_layers,), "enc_layers"),
                ("dec_layers", (cfg.n_layers,), "dec_layers")]
    if cfg.family == "ssm":
        from .models.xlstm_model import pairs
        return [("pairs", (pairs(cfg),), "pairs")]
    return [("layers", (cfg.n_layers,), "layers")]


def model_params_from_jax(cfg, params: Mapping,
                          into: Optional[torch.nn.Module] = None):
    """The reference's parameter pytree (nested dicts of numpy arrays,
    per-layer leaves stacked) -> the port's state dict (float32 CPU
    tensors), or, with ``into``, that model with the weights loaded (on
    its own device).  Names and shapes match one for one: the hybrid's
    ``mamba.<leaf>[g, i]`` becomes ``layers.<g * per + i>.<leaf>``, every
    other stack's ``<stack>.<leaf>[i]`` becomes ``<stack>.<i>.<leaf>``
    (MoE experts, biases and all); tied configs have no ``embed.head``."""
    layout = stacks(cfg)
    state: Dict[str, torch.Tensor] = {}
    for name, a in _flat(params):
        for stack, lead, port in layout:
            if name.startswith(stack + "."):
                if a.shape[:len(lead)] != tuple(lead):
                    raise ValueError(f"{name}: leading dims "
                                     f"{a.shape[:len(lead)]} are not {lead}")
                rows = a.reshape((-1,) + a.shape[len(lead):])
                for i, row in enumerate(rows):
                    state[f"{port}.{i}.{name[len(stack) + 1:]}"] = \
                        torch.from_numpy(np.array(row, np.float32))
                break
        else:
            state[name] = torch.from_numpy(np.array(a, np.float32))
    if into is None:
        return state
    into.load_state_dict(state, strict=True)
    return into


def model_params_to_jax(cfg, params: Mapping[str, torch.Tensor]) -> Dict:
    """The inverse of ``model_params_from_jax``: a state dict (tensors on
    any device) -> the reference's parameter pytree as nested dicts of
    float32 numpy arrays, per-layer leaves stacked."""
    layout = stacks(cfg)
    out: Dict[str, Any] = {}
    stacked: Dict[tuple, list] = {}
    for name, t in params.items():
        a = t.detach().to("cpu", copy=True).float().numpy()
        for s, (_, lead, port) in enumerate(layout):
            if name.startswith(port + "."):
                layer, leaf = name[len(port) + 1:].split(".", 1)
                stacked.setdefault((s, leaf), [None] * int(np.prod(lead)))[
                    int(layer)] = a
                break
        else:
            _put(out, name, a)
    for (s, leaf), arrays in stacked.items():
        stack, lead, _ = layout[s]
        _put(out, f"{stack}.{leaf}",
             np.stack(arrays).reshape(tuple(lead) + arrays[0].shape))
    return out


def _put(tree: Dict, dotted: str, value) -> None:
    *path, last = dotted.split(".")
    for k in path:
        tree = tree.setdefault(k, {})
    tree[last] = value


def train_state_to_jax(cfg, state):
    """A port ``TrainState`` -> the same named tuples (their fields are
    the reference's) holding the reference's nested numpy trees: what
    ``checkpoint.CheckpointManager`` saves, so that either package
    resumes from the other's training checkpoints."""
    from .train.compression import EFState
    from .train.optim import OptState
    from .train.train_step import TrainState, param_tree

    return TrainState(
        params=model_params_to_jax(cfg, param_tree(state.params)),
        opt=OptState(step=np.asarray(state.opt.step.cpu(), np.int32),
                     mu=model_params_to_jax(cfg, state.opt.mu),
                     nu=model_params_to_jax(cfg, state.opt.nu)),
        ef=(EFState(residual=model_params_to_jax(cfg, state.ef.residual))
            if state.ef is not None else None))


@torch.no_grad()
def train_state_from_jax(cfg, state, into=None):
    """The reference's ``TrainState`` (params, opt.step, opt.mu, opt.nu,
    ef.residual as numpy, nested as the reference nests them) -> a port
    ``TrainState``: written into ``into``'s tensors in place (on their
    device) when given, else a new state on the CPU."""
    from .models.model import make_model
    from .train import optim
    from .train.compression import EFState, ef_init
    from .train.train_step import TrainState, param_tree

    if into is None:
        params = make_model(cfg, device="cpu").init(0).requires_grad_(True)
        tree = param_tree(params)
        into = TrainState(params=params, opt=optim.adamw_init(tree),
                          ef=ef_init(tree) if state.ef is not None else None)
    if (state.ef is None) != (into.ef is None):
        raise ValueError("train_state_from_jax: error feedback is on in one "
                         "state and off in the other")
    pairs = [(param_tree(into.params), state.params),
             (into.opt.mu, state.opt.mu), (into.opt.nu, state.opt.nu)]
    if into.ef is not None:
        pairs.append((into.ef.residual, state.ef.residual))
    for dst, src in pairs:
        flat = model_params_from_jax(cfg, src)
        if set(flat) != set(dst):
            raise ValueError(f"train_state_from_jax: leaves differ: "
                             f"{sorted(set(flat) ^ set(dst))[:4]}")
        for name, t in dst.items():
            t.copy_(flat[name])
    opt = optim.OptState(step=torch.tensor(
        int(np.asarray(state.opt.step)), dtype=torch.int32), mu=into.opt.mu,
        nu=into.opt.nu)
    return TrainState(params=into.params, opt=opt,
                      ef=EFState(into.ef.residual) if into.ef else None)
