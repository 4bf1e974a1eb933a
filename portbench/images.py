"""The benchmark's generator of memory images.

A configuration file lists, for each sweep call, the regions of a
``mem_size``-word image that hold data: ``{"at": word, "count": n,
"low": lo, "high": hi}`` draws ``n`` words uniformly from ``[lo, hi)``;
``"rows"``/``"cols"`` in place of ``count`` draw a row-major matrix, and
``"zero_diagonal": true`` clears its diagonal.  The rest of the image is
zero.  The layouts are those of ``reference/conv.py``
(``layer_data``/``_layer_mem``) and ``reference/mibench.py``.

Images are drawn on the device with a ``torch.Generator`` seeded from
the run's seed, the stream (warm-up or window), the campaign's index
and the call's index, so every campaign of a run sweeps images no
earlier campaign swept, and the same seed gives the same images on the
same kind of device.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

WARMUP, WINDOW = 0, 1


def generator_seed(seed: int, stream: int, campaign: int, call: int) -> int:
    words = [int(seed) % 2**64, stream, campaign, call]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def images(call: dict, mem_size: int, seed: int, stream: int,
           campaign: int, call_index: int, device) -> torch.Tensor:
    """The ``(call["images"], mem_size)`` int32 images of one call."""
    gen = torch.Generator(device=device)
    gen.manual_seed(generator_seed(seed, stream, campaign, call_index))
    D = int(call["images"])
    out = torch.zeros((D, mem_size), dtype=torch.int32, device=device)
    for region in call["regions"]:
        shape: Sequence[int] = ((region["rows"], region["cols"])
                                if "rows" in region else (region["count"],))
        vals = torch.randint(int(region["low"]), int(region["high"]),
                             (D, *shape), generator=gen, device=device,
                             dtype=torch.int64)
        if region.get("zero_diagonal"):
            vals.diagonal(dim1=1, dim2=2).zero_()
        n = int(np.prod(shape))
        at = int(region["at"])
        out[:, at:at + n] = vals.reshape(D, n).to(torch.int32)
    return out
