"""Deterministic, seed-driven fault injection for the sweep service.

Real DSE campaigns die to transient device errors, stuck backends, slow
hosts and plain SIGKILLs; none of those are reproducible in CI on real
hardware.  This module makes every recovery path of the resumable sweep
runner (``service/runner.py``) exercisable *deterministically*: each
injected fault is a pure function of ``(seed, unit, attempt)``, so a
chaos run replays bit-for-bit regardless of wall clock, retry timing or
execution order.

Fault classes covered (mirroring the failure model in
``docs/robustness.md``):

  * **transient unit failure** -- an attempt raises ``TransientFault``;
    the runner's retry/backoff policy must absorb it.  Capped per unit
    (``max_transient_per_unit``) so campaigns terminate by construction.
  * **persistent backend failure** -- every attempt on a listed backend
    stage raises ``BackendFault``; the runner must degrade through its
    backend chain (pallas -> pallas interpret -> xla).
  * **slow unit** -- synthetic extra seconds attributed to a unit's
    execution, feeding the straggler detector without real sleeping.
  * **process kill point** -- ``SIGKILL`` to our own pid right before a
    unit's checkpoint commit: the crash window where work is computed
    but not yet durable, so resume must recompute exactly that unit.
  * **dead node** -- a heartbeat node goes silent from a given unit on,
    driving the failure-detector -> elastic-replan path.

The HTTP transport (``service/transport.py``) extends the same model
across the wire with a **network stanza** (``net_*`` fields, applied by
``NetFaultInjector`` inside the server):

  * **dropped submit response** -- the request is admitted but the
    response never reaches the client, so the client must retry the
    POST; the idempotency key guarantees the retry maps to the same
    campaign instead of double-admitting.  Capped per key
    (``net_max_submit_drops``) so submission terminates.
  * **mid-stream disconnect** -- a result stream is cut after N records
    on a connection; the client reconnects with ``cursor=`` and resumes
    at its last-acked record.  N >= 1 guarantees per-connection
    progress, so streaming terminates.
  * **duplicate delivery** -- a record line is sent twice (same
    cursor); the client's fold must be idempotent
    (``analysis.pareto.merge_reduced`` dedupes by flat grid index).
  * **delivery delay** -- a record is held back a fixed number of
    seconds, exercising client read timeouts without real packet loss.

``FaultPlan`` serializes to JSON (``to_json``/``from_json``) and rides
the ``REPRO_FAULT_PLAN`` environment variable into subprocesses, so
kill-and-resume tests configure the child's faults without new flags.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import zlib
from typing import Dict, Optional, Tuple, Union

import numpy as np

FAULT_PLAN_ENV = "REPRO_FAULT_PLAN"


class TransientFault(RuntimeError):
    """Injected recoverable failure (retry should absorb it)."""


class BackendFault(RuntimeError):
    """Injected persistent backend failure (degrade, don't retry)."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Declarative fault schedule; see module docstring for semantics."""
    seed: int = 0
    transient_rate: float = 0.0            # P(attempt fails) per attempt
    max_transient_per_unit: int = 2        # termination guarantee
    broken_backends: Tuple[str, ...] = ()  # stage names, e.g. ("pallas",)
    slow_units: Tuple[int, ...] = ()
    slow_extra_s: float = 0.0
    kill_at_unit: Optional[int] = None     # SIGKILL before this commit
    dead_nodes: Tuple[Tuple[int, str], ...] = ()  # (from_unit, node)
    # -- network stanza (service/transport.py) --------------------------
    net_submit_drop_rate: float = 0.0      # P(POST response dropped)
    net_max_submit_drops: int = 3          # per idempotency key cap
    net_stream_disconnect_every: int = 0   # cut stream after N records
    net_duplicate_rate: float = 0.0        # P(record delivered twice)
    net_delay_rate: float = 0.0            # P(record delayed)
    net_delay_s: float = 0.0               # seconds per delayed record

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        d = json.loads(text)
        d["broken_backends"] = tuple(d.get("broken_backends", ()))
        d["slow_units"] = tuple(d.get("slow_units", ()))
        d["dead_nodes"] = tuple(
            (int(u), str(n)) for u, n in d.get("dead_nodes", ()))
        return cls(**d)

    @classmethod
    def from_env(cls, env: str = FAULT_PLAN_ENV) -> Optional["FaultPlan"]:
        text = os.environ.get(env, "")
        return cls.from_json(text) if text else None


class FaultInjector:
    """Stateful applier of a ``FaultPlan``.

    The only state is the per-unit transient counter (the cap); every
    fault decision itself is recomputed from ``(seed, unit, attempt)``.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._transients: Dict[int, int] = {}

    # -- execution faults ---------------------------------------------------
    def on_attempt(self, unit: int, attempt: int, backend: str):
        """Raise the injected fault for this (unit, attempt, backend), if
        any.  Called by the runner right before executing an attempt."""
        if backend in self.plan.broken_backends:
            raise BackendFault(
                f"injected persistent failure: backend {backend!r}, "
                f"unit {unit}")
        if (self.plan.transient_rate > 0.0
                and self._transients.get(unit, 0)
                < self.plan.max_transient_per_unit):
            rng = np.random.default_rng(
                [self.plan.seed, unit, attempt])
            if rng.random() < self.plan.transient_rate:
                self._transients[unit] = self._transients.get(unit, 0) + 1
                raise TransientFault(
                    f"injected transient failure: unit {unit}, "
                    f"attempt {attempt}")

    def extra_seconds(self, unit: int) -> float:
        """Synthetic slowness attributed to this unit's wall time."""
        return (self.plan.slow_extra_s
                if unit in self.plan.slow_units else 0.0)

    # -- crash point --------------------------------------------------------
    def on_commit(self, unit: int):
        """Kill point: fires right *before* the unit's checkpoint commit,
        the window where the work is computed but not yet durable."""
        if self.plan.kill_at_unit is not None \
                and unit == self.plan.kill_at_unit:
            os.kill(os.getpid(), signal.SIGKILL)

    # -- fleet faults -------------------------------------------------------
    def node_dead(self, node: str, unit: int) -> bool:
        """True once `node` has gone silent (stops heartbeating) as of
        this unit."""
        return any(unit >= u and node == n for u, n in self.plan.dead_nodes)


def _ident(s: Union[str, int]) -> int:
    """Stable small integer for a string identifier (seeding material)."""
    if isinstance(s, int):
        return s & 0xFFFFFFFF
    return zlib.crc32(s.encode())


class NetFaultInjector:
    """Deterministic network-fault decisions for the HTTP transport.

    Mirrors ``FaultInjector``: the only state is the per-key submit-drop
    counter (the termination cap) -- every decision is a pure function
    of ``(seed, identifier, counter)``, so a chaos run over the wire
    replays identically regardless of socket timing or thread
    interleaving.  The *applier* lives in ``service/transport.py``; this
    class only answers yes/no/how-long.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._submit_drops: Dict[str, int] = {}

    def _roll(self, *parts: Union[str, int]) -> float:
        rng = np.random.default_rng(
            [self.plan.seed] + [_ident(p) for p in parts])
        return float(rng.random())

    def drop_submit_response(self, key: str) -> bool:
        """Should the (already admitted) POST's response be dropped?
        Capped per idempotency key so a retrying client terminates."""
        n = self._submit_drops.get(key, 0)
        if (self.plan.net_submit_drop_rate <= 0.0
                or n >= self.plan.net_max_submit_drops):
            return False
        if self._roll("submit", key, n) < self.plan.net_submit_drop_rate:
            self._submit_drops[key] = n + 1
            return True
        return False

    def stream_disconnect_after(self) -> Optional[int]:
        """Records to deliver on one stream connection before an abrupt
        cut (None = never cut).  >= 1 by construction, so every
        connection makes progress and cursor-resume terminates."""
        n = self.plan.net_stream_disconnect_every
        return max(1, int(n)) if n else None

    def duplicate_record(self, campaign: str, cursor: int) -> bool:
        """Should this record line be delivered twice?"""
        if self.plan.net_duplicate_rate <= 0.0:
            return False
        return (self._roll("dup", campaign, cursor)
                < self.plan.net_duplicate_rate)

    def delay_record(self, campaign: str, cursor: int) -> float:
        """Synthetic delivery delay (seconds) for this record."""
        if self.plan.net_delay_rate <= 0.0 or self.plan.net_delay_s <= 0.0:
            return 0.0
        if self._roll("delay", campaign, cursor) < self.plan.net_delay_rate:
            return self.plan.net_delay_s
        return 0.0
