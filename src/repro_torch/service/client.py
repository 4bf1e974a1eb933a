"""Failure-first client for the sweep service's HTTP transport.

``SweepClient.sweep`` drives one campaign end to end and survives every
failure the transport models (``docs/service.md``):

  * **lost submit response** -- the POST is retried with exponential
    backoff + jitter; the idempotency key maps every retry onto the
    same server-side campaign, so at-most-one admission holds even
    though the client saw nothing.
  * **mid-stream disconnect** -- the result stream is re-opened at
    ``cursor=<last acked + 1>``; records already folded are never
    re-requested.
  * **duplicate delivery / replays** -- every received record is folded
    anyway: reduced records merge through
    ``analysis.pareto.merge_reduced`` (idempotent -- candidates dedupe
    by flat grid index), unreduced records overwrite their ``[lo, hi)``
    lane span with identical bytes.  At-least-once delivery therefore
    cannot change the answer, which is what makes the rest of the retry
    logic safe to write aggressively.
  * **server drain/restart** -- a ``drained`` sentinel (or a 404 from a
    restarted server that no longer knows the campaign) triggers a
    re-submission under the *same* idempotency key; the fold simply
    continues.  With a server-side checkpoint root the re-submitted
    campaign resumes its completed units instead of recomputing.
  * **backpressure** -- 429 honors ``Retry-After``; 503 (draining)
    backs off and retries, landing on the restarted server.

Everything is stdlib: ``http.client`` + JSON; arrays travel as base64
raw bytes, so the folded result is bit-exact against the in-process
service and ``dse.sweep``.
"""
from __future__ import annotations

import dataclasses
import http.client
import json
import random
import socket
import time
import uuid
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from ..analysis import pareto as _pareto
from .runner import RESULT_FIELDS, _RESULT_DTYPES
from .transport import WIRE_VERSION, sweep_to_wire


class TransportError(RuntimeError):
    """The campaign could not be completed within the retry budget."""


class _Disconnected(Exception):
    """Stream ended without a terminal record (retry from cursor)."""


class _CampaignGone(Exception):
    """Server no longer knows the campaign (drained or restarted):
    re-submit under the same idempotency key."""


@dataclasses.dataclass(frozen=True)
class ClientRetry:
    """Backoff policy for submits and stream reconnects."""
    max_attempts: int = 10           # per operation (submit / stream)
    max_resubmits: int = 5           # drained/404 re-submission budget
    backoff_s: float = 0.05
    backoff_mult: float = 2.0
    max_backoff_s: float = 2.0
    jitter: float = 0.25             # +/- fraction of each delay


@dataclasses.dataclass
class ClientStats:
    """What the chaos actually did to this campaign (test observability)."""
    submit_attempts: int = 0
    resubmits: int = 0
    reconnects: int = 0
    records_folded: int = 0
    duplicate_records: int = 0
    heartbeats: int = 0
    retries_429: int = 0


@dataclasses.dataclass
class ClientResult:
    """Folded campaign answer.  ``arrays`` matches the in-process
    ``RequestResult.arrays`` contract: request-local ``(n_lanes,)`` lane
    arrays, or the ``ReducedResult`` fields for a reduced campaign."""
    arrays: Dict[str, np.ndarray]
    expired: bool
    skipped_lanes: int
    degraded_units: Dict[str, str]
    stats: ClientStats

    def reduced(self) -> _pareto.ReducedResult:
        return _pareto.ReducedResult(
            **{f: self.arrays[f] for f in _pareto.REDUCED_FIELDS})


class SweepClient:
    """One server, many campaigns; every method is synchronous."""

    def __init__(self, host: str, port: int, *,
                 retry: Optional[ClientRetry] = None,
                 timeout_s: float = 30.0, seed: int = 0):
        self.host = host
        self.port = int(port)
        self.retry = retry or ClientRetry()
        self.timeout_s = timeout_s
        self._rng = random.Random(seed)

    # -- low-level ----------------------------------------------------------
    def _request(self, method: str, path: str,
                 body: Optional[dict] = None) -> Tuple[int, dict]:
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout_s)
        try:
            payload = json.dumps(body).encode() if body is not None else None
            conn.request(method, path, body=payload,
                         headers={"Content-Type": "application/json"}
                         if payload else {})
            r = conn.getresponse()
            raw = r.read()
            try:
                obj = json.loads(raw) if raw else {}
            except ValueError:
                obj = {}
            return r.status, obj
        finally:
            conn.close()

    def _sleep_backoff(self, attempt: int, floor_s: float = 0.0):
        r = self.retry
        delay = min(r.backoff_s * r.backoff_mult ** max(0, attempt - 1),
                    r.max_backoff_s)
        delay *= 1.0 + r.jitter * (2.0 * self._rng.random() - 1.0)
        time.sleep(max(delay, floor_s))

    def healthz(self) -> bool:
        try:
            return self._request("GET", "/healthz")[0] == 200
        except OSError:
            return False

    def readyz(self) -> bool:
        try:
            return self._request("GET", "/readyz")[0] == 200
        except OSError:
            return False

    # -- submission ---------------------------------------------------------
    def _submit(self, body: dict, stats: ClientStats) -> str:
        """POST with retry: connection errors, lost responses, 429 and
        503 all back off and re-send; the idempotency key in ``body``
        makes every re-send safe."""
        last = "no attempt made"
        for attempt in range(1, self.retry.max_attempts + 1):
            stats.submit_attempts += 1
            try:
                status, obj = self._request("POST", "/v1/sweeps", body)
            except (OSError, http.client.HTTPException) as e:
                # includes the chaos-dropped response (server closed the
                # socket after admitting): retry lands on the key
                last = f"submit connection error: {e!r}"
                self._sleep_backoff(attempt)
                continue
            if status in (200, 201):
                return str(obj["campaign"])
            if status == 429:
                stats.retries_429 += 1
                last = f"429: {obj.get('error', '')}"
                self._sleep_backoff(attempt, floor_s=0.05)
                continue
            if status == 503:
                last = f"503: {obj.get('error', 'draining')}"
                self._sleep_backoff(attempt)
                continue
            raise TransportError(
                f"submit rejected: HTTP {status} {obj.get('error', '')}")
        raise TransportError(
            f"submit failed after {self.retry.max_attempts} attempts "
            f"({last})")

    # -- streaming ----------------------------------------------------------
    def _stream_once(self, cid: str, cursor: int) -> Iterator[dict]:
        """Yield parsed records from one stream connection; raises
        ``_Disconnected`` on EOF-without-terminal and ``_CampaignGone``
        on 404."""
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout_s)
        try:
            conn.request("GET", f"/v1/sweeps/{cid}/stream?cursor={cursor}")
            r = conn.getresponse()
            if r.status == 404:
                raise _CampaignGone(cid)
            if r.status != 200:
                raise _Disconnected(f"stream HTTP {r.status}")
            terminal = False
            for raw in iter(r.readline, b""):
                line = raw.strip()
                if not line:
                    continue
                msg = json.loads(line)
                yield msg
                if "status" in msg:
                    terminal = True
                    return
            if not terminal:
                raise _Disconnected("stream cut before terminal record")
        finally:
            conn.close()

    # -- the campaign driver ------------------------------------------------
    def sweep(self, programs: Sequence, hw_configs: Sequence,
              mem_images: np.ndarray, *, reduce=None,
              deadline_s: Optional[float] = None,
              idempotency_key: Optional[str] = None) -> ClientResult:
        """Submit, stream, fold; survives drops, cuts, duplicates, and
        one-or-more server drain/restarts.  Returns the folded result
        (bit-exact vs the in-process service for the same unit size)."""
        key = idempotency_key or uuid.uuid4().hex
        stats = ClientStats()
        reduced = reduce is not None
        n_lanes = (len(list(programs)) * len(list(hw_configs))
                   * int(np.asarray(mem_images).shape[0]))
        body = {"v": WIRE_VERSION, "idempotency_key": key,
                "sweep": sweep_to_wire(programs, hw_configs, mem_images,
                                       deadline_s=deadline_s,
                                       reduce=reduce)}
        # accumulators: merge_reduced folds reduced records (idempotent
        # by construction); unreduced records overwrite their lane span
        acc: Optional[_pareto.ReducedResult] = None
        arrays = None if reduced else {
            f: np.zeros(n_lanes, _RESULT_DTYPES[f]) for f in RESULT_FIELDS}
        acked = 0                      # cursor high-water mark (this cid)
        cid = self._submit(body, stats)
        failures = 0
        while True:
            try:
                for msg in self._stream_once(cid, acked):
                    if "heartbeat" in msg:
                        stats.heartbeats += 1
                        continue
                    if "status" in msg:
                        if msg["status"] == "complete":
                            return self._finish(
                                msg, arrays, acc, reduced,
                                len(list(programs)), reduce, stats)
                        if msg["status"] == "drained":
                            raise _CampaignGone(cid)
                        raise TransportError(
                            f"unknown terminal status {msg['status']!r}")
                    cur = int(msg["cursor"])
                    if cur < acked:
                        stats.duplicate_records += 1
                    if reduced:
                        part = _pareto.reduced_from_wire(msg["arrays"])
                        acc = part if acc is None else \
                            _pareto.merge_reduced(reduce, [acc, part])
                    else:
                        lo, hi = int(msg["lo"]), int(msg["hi"])
                        for f in RESULT_FIELDS:
                            arrays[f][lo:hi] = \
                                _pareto.array_from_wire(msg["arrays"][f])
                    stats.records_folded += 1
                    acked = max(acked, cur + 1)
                    failures = 0       # progress resets the budget
            except _CampaignGone:
                # drained sentinel or restarted server: re-submit under
                # the SAME key and keep folding (idempotent by design)
                stats.resubmits += 1
                if stats.resubmits > self.retry.max_resubmits:
                    raise TransportError(
                        f"campaign {cid}: re-submission budget "
                        f"({self.retry.max_resubmits}) exhausted")
                failures += 1
                self._sleep_backoff(failures)
                cid = self._submit(body, stats)
                acked = 0              # fresh campaign, fresh cursors
            except (_Disconnected, OSError, socket.timeout,
                    http.client.HTTPException) as e:
                failures += 1
                stats.reconnects += 1
                if failures > self.retry.max_attempts:
                    raise TransportError(
                        f"campaign {cid}: stream failed "
                        f"{failures} consecutive times: {e!r}")
                self._sleep_backoff(failures)

    def _finish(self, terminal: dict, arrays, acc, reduced: bool,
                n_programs: int, spec, stats: ClientStats) -> ClientResult:
        if reduced:
            if acc is None:            # every unit skipped/expired
                acc = _pareto.ReducedResult(**_pareto.reduced_zeros(
                    n_programs, spec))
            out = {f: np.asarray(getattr(acc, f))
                   for f in _pareto.REDUCED_FIELDS}
        else:
            out = arrays
        return ClientResult(
            arrays=out,
            expired=bool(terminal.get("expired", False)),
            skipped_lanes=int(terminal.get("skipped_lanes", 0)),
            degraded_units=dict(terminal.get("degraded_units", {})),
            stats=stats)
