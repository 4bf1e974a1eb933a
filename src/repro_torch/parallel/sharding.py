"""Flat-batch sharding of the DSE grid over a mesh of devices.

The (program x hw x data) grid of a sweep is one long lane axis.  A
``Mesh`` names the devices it is split over; ``flat_shards`` cuts a
padded lane axis into one contiguous slice per mesh entry, in the flat
order of the mesh's devices -- the reference's ``flat_batch_spec``, which
shards the batch over every mesh axis.  One process drives every device
of a mesh (single controller), so no process group is involved.

A mesh may repeat a device: ``Mesh([cuda:0] * 4)`` is four shards on one
card, each with its own lanes and launches, which is how a machine with
one card (or the host) runs a multi-shard sweep.  A mesh never mixes the
host and the card: its shards would run on two different engines.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device]


def _as_device(d: DeviceLike) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """An n-d array of ``torch.device`` entries with named axes.

    ``devices`` is a numpy object array, so ``mesh.devices.size`` and
    ``np.asarray(mesh.devices).flat`` read as they do for a jax mesh."""

    def __init__(self, devices, axis_names: Sequence[str] = ("data",)):
        raw = np.asarray(devices, dtype=object)
        types = {torch.device(d).type for d in raw.flat}
        if len(types) > 1:
            raise ValueError(f"Mesh: entries mix device types {sorted(types)}"
                             f"; every shard must run on the same engine")
        if not types or not types <= {"cuda", "cpu"}:
            raise ValueError(f"Mesh: need cuda or cpu entries, got "
                             f"{sorted(types)}")
        self.devices = np.empty(raw.shape, dtype=object)
        for i, d in np.ndenumerate(raw):
            self.devices[i] = _as_device(d)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"Mesh: {len(self.axis_names)} axis names for a "
                             f"{self.devices.ndim}-d device array")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type

    def flat(self) -> List[torch.device]:
        """Every entry, in flat order (repeats kept)."""
        return list(self.devices.flat)

    def distinct(self) -> List[torch.device]:
        """Each device once, in order of first appearance."""
        return list(dict.fromkeys(self.devices.flat))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.flat()]})"


def mesh_device(mesh: Mesh, device=None) -> torch.device:
    """The device a sharded sweep gathers its answer on (the mesh's
    first entry).  A ``device`` that names another engine, or a device
    outside the mesh, raises."""
    first = mesh.devices.flat[0]
    if device is None:
        return first
    d = torch.device(device)
    if d.type != first.type or (d.index is not None
                                and d not in mesh.distinct()):
        raise ValueError(f"device={d} disagrees with the mesh {mesh!r}")
    return first


def padded_len(n: int, n_devices: int) -> int:
    """Smallest multiple of ``n_devices`` >= n (flat-grid pad target)."""
    return -(-n // n_devices) * n_devices


def pad_batch(x, target: int, fill=None):
    """Pad a leading batch axis (tensor or numpy array) to ``target`` rows.

    The pad repeats row 0: lanes are independent, so a repeated lane is
    redundant work and callers slice outputs back to the true length.
    With ``fill`` the pad rows hold that constant instead (a reduced
    sweep pads ``lane_idx`` with -1, so pad lanes never become
    candidates)."""
    pad = target - x.shape[0]
    if pad <= 0:
        return x
    if isinstance(x, torch.Tensor):
        rows = (torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                           device=x.device) if fill is not None
                else x[:1].expand((pad,) + tuple(x.shape[1:])))
        return torch.cat([x, rows])
    x = np.asarray(x)
    rows = (np.full((pad,) + x.shape[1:], fill, x.dtype) if fill is not None
            else np.broadcast_to(x[:1], (pad,) + x.shape[1:]))
    return np.concatenate([x, rows])


def flat_shards(n_padded: int, mesh: Mesh
                ) -> List[Tuple[torch.device, int, int]]:
    """``[(device, lo, hi)]``: one contiguous slice of a padded lane axis
    per mesh entry, in the flat order of the mesh's devices."""
    n = mesh.devices.size
    if n_padded % n:
        raise ValueError(f"{n_padded} lanes do not split over {n} shards; "
                         f"pad to padded_len first")
    per = n_padded // n
    return [(d, i * per, (i + 1) * per) for i, d in enumerate(mesh.flat())]
