"""Shared container for CGRA application kernels."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from ..core.program import Program


@dataclasses.dataclass
class KernelCase:
    """A runnable CGRA kernel with its data and correctness oracle."""
    name: str
    program: Program
    mem_init: np.ndarray                       # (mem_size,) int32
    check: Callable[[np.ndarray], bool]        # final memory -> correct?
    expected: Optional[np.ndarray] = None      # reference output (debugging)
    max_steps: int = 2048
    notes: str = ""

    def run(self, hw=None, **kw):
        from ..core.cgra import run_program
        return run_program(self.program, self.mem_init, hw,
                           max_steps=self.max_steps, **kw)


MEM_SIZE = 4096


def fresh_mem() -> np.ndarray:
    return np.zeros(MEM_SIZE, np.int32)
