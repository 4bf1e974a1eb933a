"""Memory-subsystem timing model: bus / bank / DMA contention.

The CGRA shares its data memory with the rest of the MCU; memory
operations therefore have system-dependent latency (paper Table 1, case
(iii)).  The detailed reference simulator and the case-(iii)+ estimator
share this one formula.

Mechanics (pipelined issue):
  * every memory request occupies one issue slot on each resource it
    needs; a resource accepts one new request per cycle;
  * resources: the DMA engine it goes through (one per column in the
    baseline, one per PE for mod (d)) and the bus/bank port (single
    global port for 1-to-M; one port per bank for N-to-M);
  * requests arbitrate in ascending PE order (greedy list scheduler);
  * completion cycle = issue_slot + t_mem.

Every function here works on any leading lane shape: ``(P,)`` rows for
one design point (``core.cgra``) or ``(B, P)`` for a lane batch
(``kernels.cgra_sweep.ref``), with the ``HwConfig`` fields 0-d or
``(B,)`` to match.
"""
from __future__ import annotations

import torch

from .hwconfig import BUS_N_TO_M, HwConfig

# The reference's engines keep a bank table of a static width, so its
# sweep functions take a ``max_banks`` bound derived from the configs
# (``scoreboard_bound``).  The port's engines need no table width, but
# keep the same bound and the same loud failure for configs beyond it.
DEFAULT_MAX_BANKS = 16   # bound used when no configs are in scope yet
HARD_MAX_BANKS = 256     # absolute ceiling


def scoreboard_bound(n_banks_required: int) -> int:
    """Config-derived scoreboard size: next power of two >= the largest
    n_banks in the sweep.  Raises beyond HARD_MAX_BANKS."""
    n = int(n_banks_required)
    if not 1 <= n <= HARD_MAX_BANKS:
        raise AssertionError(
            f"n_banks={n} exceeds HARD_MAX_BANKS={HARD_MAX_BANKS}: the "
            f"bank scoreboard would need {n} slots per design point; "
            f"raise HARD_MAX_BANKS deliberately or reduce the configured "
            f"bank count")
    return 1 << (n - 1).bit_length()


def validate_bank_bound(n_banks, max_banks: int, where: str = "") -> None:
    """Raise if any configured n_banks exceeds the scoreboard bound."""
    nb = int(torch.as_tensor(n_banks).max())
    if nb > max_banks:
        raise AssertionError(
            f"{where or 'sweep'}: configured n_banks={nb} exceeds the "
            f"bank scoreboard bound max_banks={max_banks}. Pass "
            f"max_banks=scoreboard_bound({nb}) or use dse.sweep(), which "
            f"derives the bound from the configs")


def _lane(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Per-lane field -> broadcastable against ``(..., P)`` rows."""
    return torch.as_tensor(x, device=like.device).to(torch.int32)[..., None]


def bank_of(addr: torch.Tensor, hw: HwConfig, mem_size: int) -> torch.Tensor:
    """Bank index of each address under the configured mapping.  Floor
    division and modulo, as in the reference (``torch.remainder`` and
    ``div(rounding_mode='floor')``, never C-style truncation)."""
    n_banks = _lane(hw.n_banks, addr)
    nb = torch.clamp(n_banks, min=1)
    bank_words = torch.clamp(mem_size // nb, min=1)
    interleaved = torch.remainder(addr, nb)
    blocked = torch.minimum(
        torch.clamp(torch.div(addr, bank_words, rounding_mode="floor"),
                    min=0), n_banks - 1)
    bank = torch.where(_lane(hw.interleaved, addr) > 0, interleaved, blocked)
    # 1-to-M bus: a single global port == everything in "bank 0".
    return torch.where(_lane(hw.bus, addr) == BUS_N_TO_M, bank,
                       torch.zeros_like(bank))


def mem_completion_times(is_mem: torch.Tensor, addr: torch.Tensor,
                         hw: HwConfig, mem_size: int, cols: int
                         ) -> torch.Tensor:
    """Per-PE memory completion time (cc from instruction start).

    is_mem: (..., P) bool -- PE issues a memory request this instruction
    addr:   (..., P) int32 -- word address of the request
    Returns (..., P) int32; 0 where no request is made.

    The greedy in-order scheduler gives request p the slot
    ``max(bank_free[bank_p], dma_free[dma_p])``, and both free counters
    are one past the slot of the latest earlier request on that bank or
    DMA.  Slots grow along each resource, so p's slot is one more than
    the largest slot of ANY earlier request that shares its bank or its
    DMA (0 if none): the length of the longest chain of such requests
    ending at p.  That is computed for every PE at once as a max-plus
    closure of the (P, P) "shares a resource, issued earlier" relation,
    in ceil(log2(P - 1)) squarings -- the same slots as the serial
    P-step scan of the reference, without a P-step loop."""
    P = is_mem.shape[-1]
    dev = addr.device
    bank = bank_of(addr, hw, mem_size)
    pe = torch.arange(P, dtype=torch.int32, device=dev)
    dma = torch.where(_lane(hw.dma_per_pe, addr) > 0, pe, pe % cols)
    shares = ((bank.unsqueeze(-1) == bank.unsqueeze(-2))
              | (dma.unsqueeze(-1) == dma.unsqueeze(-2)))    # (..., P, P)
    earlier = torch.ones(P, P, dtype=torch.bool, device=dev).tril(-1)
    edge = (shares & earlier & is_mem.unsqueeze(-1)
            & is_mem.unsqueeze(-2))                         # q -> p
    # chain[p, q]: longest chain q -> p, -inf where there is none
    eye = torch.eye(P, dtype=torch.bool, device=dev)
    chain = torch.where(edge, 1.0, torch.where(eye, 0.0, -torch.inf))
    for _ in range(max(P - 2, 0).bit_length()):
        chain = (chain.unsqueeze(-1) + chain.unsqueeze(-3)).amax(-2)
    slot = chain.amax(-1).to(torch.int32)
    t_mem = _lane(hw.t_mem, addr)
    return torch.where(is_mem, slot + t_mem, 0)
