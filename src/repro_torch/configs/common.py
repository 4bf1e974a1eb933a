"""Architecture registry of the port.

``get_config(name)``: the full configuration.  ``get_smoke_config(name)``:
the reduced configuration of the same family for CPU tests.  Every
architecture of the reference is registered: the hybrid zamba2-2.7b, the
dense, MoE and VLM transformers, the encoder-decoder whisper-small and
the xLSTM xlstm-350m.
"""
from __future__ import annotations

from typing import Callable, Dict

from ..models.config import ModelConfig

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
_SMOKE: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str, full: Callable[[], ModelConfig],
             smoke: Callable[[], ModelConfig]):
    _REGISTRY[name] = full
    _SMOKE[name] = smoke


def _lookup(table: Dict[str, Callable[[], ModelConfig]],
            name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in table:
        raise KeyError(f"unknown architecture {name!r} (known: "
                       f"{', '.join(sorted(table))})")
    return table[name]().validate()


def get_config(name: str) -> ModelConfig:
    return _lookup(_REGISTRY, name)


def get_smoke_config(name: str) -> ModelConfig:
    return _lookup(_SMOKE, name)


def list_archs():
    """The names of the registered architectures, sorted."""
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    from . import (granite_moe_1b, llama3_2_1b, mixtral_8x22b,  # noqa: F401
                   olmo_1b, qwen2_vl_7b, smollm_360m, starcoder2_15b,
                   whisper_small, xlstm_350m, zamba2_2_7b)
