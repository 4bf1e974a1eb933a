"""Device selection shared by every entry point of the port."""
from __future__ import annotations

from typing import Union

import torch

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


def as_int32(x, device: torch.device) -> torch.Tensor:
    """Tensor view of ``x`` as int32 on ``device`` (no copy if it is one)."""
    return torch.as_tensor(x, dtype=torch.int32, device=device)
