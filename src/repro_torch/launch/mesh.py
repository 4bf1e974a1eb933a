"""Mesh construction: sharded sweeps, pipelines, the production mesh.

Functions, not module constants: importing this module never touches
the CUDA runtime."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.sharding import Mesh


def _visible(n: Optional[int]) -> list:
    """The first ``n`` visible CUDA devices (all when ``n`` is None);
    never repeats one."""
    resolve_device(None)                     # raises without a GPU
    count = torch.cuda.device_count()
    n = count if n is None else n
    if not 1 <= n <= count:
        raise ValueError(f"{n} shards but {count} visible CUDA device(s); "
                         f"name a device to repeat it")
    return [torch.device("cuda", i) for i in range(n)]


def make_debug_mesh(n: Optional[int] = None, axes=("data",),
                    device=None) -> Mesh:
    """A 1-d mesh of ``n`` shards.  Without ``device``: the first ``n``
    visible CUDA devices (all of them when ``n`` is None).  With
    ``device``: ``n`` (default 1) shards that all run on it --
    ``device="cpu"`` gives host shards, ``device="cuda:0"`` several
    shards on one card."""
    if device is None:
        return Mesh(_visible(n), axes)
    return Mesh([resolve_device(device)] * (n or 1), axes)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices=None) -> Mesh:
    """A mesh of the given shape.  ``devices`` lists its entries in flat
    order (repeats allowed); without it, the first visible CUDA devices."""
    n = int(np.prod(shape))
    devs = _visible(n) if devices is None else \
        [resolve_device(d) for d in devices]
    if len(devs) != n:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} devices, got "
                         f"{len(devs)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(tuple(shape)), axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16x16 = 256 devices ("data", "model").  Multi-pod: 2
    pods = 512 devices ("pod", "data", "model"); DP rides ("pod",
    "data").  The mesh is abstract (every entry the meta device): shape
    and axis names for the sharding rules and the dry-run, and nothing
    to run on."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices=["meta"] * int(np.prod(shape)))
