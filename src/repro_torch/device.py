"""Device selection shared by every entry point of the port."""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from . import spans

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA device.  The CPU is used only when the
    caller names it; with no GPU and no explicit device this raises
    rather than quietly running the plain version on the host."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch version on the host")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           f"available")
    return dev


def to_device(x, device: torch.device, dtype=None) -> torch.Tensor:
    """Tensor of ``x`` on ``device`` (no copy if it is one).  A copy from
    host memory to a CUDA device waits for the device's stream: it counts
    as a host sync (``spans``).  ``upload`` is the copy that does not."""
    if (isinstance(device, torch.device) and device.type == "cuda"
            and not (isinstance(x, torch.Tensor) and x.is_cuda)):
        spans.count("host_syncs")
    return torch.as_tensor(x, dtype=dtype, device=device)


def as_int32(x, device: torch.device) -> torch.Tensor:
    """Tensor view of ``x`` as int32 on ``device`` (no copy if it is one)."""
    return to_device(x, device, torch.int32)


def upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` by one copy the host does not wait for.

    On a CUDA device the array goes through pinned host memory and is
    copied with ``non_blocking=True``: not a host sync, so not counted.
    PyTorch's pinned allocator records the copy on the stream and keeps
    the buffer until the copy is done.  On the CPU the tensor shares
    ``x``'s memory."""
    host = torch.from_numpy(x)
    if device.type != "cuda":
        return host
    buf = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
    buf.numpy()[...] = x
    return buf.to(device, non_blocking=True)
