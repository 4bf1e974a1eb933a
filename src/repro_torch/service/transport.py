"""Chaos-hardened HTTP transport for the sweep service.

``SweepService`` batches strangers into shared compiled sweeps but only
speaks Python.  This module puts a dependency-free network front end on
it -- stdlib ``http.server`` only, JSON-lines streaming -- built
failure-first: every message may be lost, replayed, or cut mid-flight,
and the protocol is shaped so none of that can change the answer.

Wire protocol (version 1; see docs/service.md for the full contract):

  * ``POST /v1/sweeps`` -- submit a campaign.  The body carries a
    **client-supplied idempotency key**; replaying the POST (e.g. after
    a lost response) returns the *existing* campaign instead of
    double-admitting.  Queue-full maps to ``429`` + ``Retry-After``;
    a draining server answers ``503``.
  * ``GET /v1/sweeps/{id}/stream?cursor=N`` -- the campaign's results
    as JSON lines, one record per delivered work-unit slice, each with
    a **monotonic cursor**.  A reconnecting client passes the cursor of
    its last acked record and resumes exactly there.  The stream ends
    with a terminal status line: ``complete`` (with expiry/degradation
    metadata) or ``drained`` (retryable -- see below).  Idle streams
    carry heartbeat lines so clients can tell "slow unit" from "dead
    server".
  * ``GET /v1/sweeps/{id}`` -- campaign status snapshot.
  * ``GET /healthz`` (liveness) and ``GET /readyz`` (admission: 503
    while draining).

Graceful drain: on SIGTERM the server stops admitting (``readyz`` goes
503, POST answers 503), lets the unit in flight finish, waits for its
checkpoint to be durable (``ResumableSweepRunner`` machinery), then
closes every open stream with a ``drained`` sentinel.  Clients treat
``drained`` as retryable: they re-submit under the same idempotency key
once a server is back.  With ``--ckpt-root`` the restarted service
resumes the re-submitted campaign's completed units from its
fingerprint-keyed checkpoint directory instead of recomputing them.

Why at-least-once delivery is safe: records are folded idempotently on
the client -- reduced records merge through
``analysis.pareto.merge_reduced`` (dedupes candidates by flat grid
index), unreduced records overwrite their ``[lo, hi)`` lane span with
identical bytes.  Arrays travel as base64 raw bytes
(``pareto.array_to_wire``), so the fold is bit-exact, never a decimal
round trip.

Network chaos: a ``runtime.faults.FaultPlan`` network stanza (via
``REPRO_FAULT_PLAN``) injects seeded submit-response drops, mid-stream
disconnects, duplicate record delivery, and delivery delays *inside
this layer*, so the whole client/server recovery surface is exercised
deterministically in CI without real packet loss.

Threads: one worker thread owns the ``SweepService`` and alone submits
to it and steps it.  A POST hands its decoded submission to the worker
through an inbox and waits for the answer, which comes between two
steps.  The campaign registry has a lock of its own, held only for
lookups and inserts, and the worker marks a campaign ``running`` as soon
as its slot is admitted, before its first unit runs: a status or stream
GET never waits for a step.  (The reference's transport held one lock
through every step, so its status GET could wait out a whole campaign.)

Serve CLI::

  PYTHONPATH=src python -m repro_torch.service serve --port 0 \\
      --port-file /tmp/sweep.port --ckpt-root /tmp/ck [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import signal
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..analysis import pareto as _pareto
from ..core.hwconfig import HwConfig
from ..core.program import Program
from ..runtime.faults import FaultInjector, FaultPlan, NetFaultInjector
from .runner import RESULT_FIELDS
from .server import ServiceOverloaded, SweepRequest, SweepService

WIRE_VERSION = 1
_PROGRAM_FIELDS = ("ops", "dest", "srcA", "srcB", "imm")


# ---------------------------------------------------------------------------
# Wire codecs (shared with client.py)
# ---------------------------------------------------------------------------

def program_to_wire(p: Program) -> dict:
    return {"name": p.name,
            **{f: _pareto.array_to_wire(np.asarray(getattr(p, f)))
               for f in _PROGRAM_FIELDS}}


def program_from_wire(d: dict) -> Program:
    p = Program(**{f: _pareto.array_from_wire(d[f])
                   for f in _PROGRAM_FIELDS},
                name=str(d.get("name", "wire")))
    p.validate()
    return p


def hw_to_wire(c: HwConfig) -> dict:
    out = {}
    for f in HwConfig.FIELDS:
        v = np.asarray(getattr(c, f)).item()
        out[f] = v
    return out


def hw_from_wire(d: dict) -> HwConfig:
    return HwConfig(**{f: d[f] for f in HwConfig.FIELDS})


def sweep_to_wire(programs, hw_configs, mem_images, *,
                  deadline_s=None, reduce=None) -> dict:
    """The ``sweep`` body of a POST /v1/sweeps submission."""
    return {
        "programs": [program_to_wire(p) for p in programs],
        "hw_configs": [hw_to_wire(c) for c in hw_configs],
        "mem_images": _pareto.array_to_wire(
            np.asarray(mem_images, np.int32)),
        "deadline_s": deadline_s,
        "reduce": _pareto.spec_to_str(reduce) if reduce is not None
        else None,
    }


def sweep_from_wire(d: dict) -> dict:
    """Decode a submission body into SweepRequest constructor kwargs."""
    red = d.get("reduce")
    return dict(
        programs=[program_from_wire(p) for p in d["programs"]],
        hw_configs=[hw_from_wire(c) for c in d["hw_configs"]],
        mem_images=_pareto.array_from_wire(d["mem_images"]),
        deadline_s=d.get("deadline_s"),
        reduce=_pareto.spec_from_str(red) if red else None,
    )


# ---------------------------------------------------------------------------
# Campaign registry
# ---------------------------------------------------------------------------

class _Campaign:
    """Server-side state of one submitted sweep: the append-only record
    log (pre-encoded JSON lines, indexed by cursor) plus terminal
    status.  ``cond`` wakes blocked stream handlers on every append."""

    def __init__(self, cid: str, key: str, rid: int, reduced: bool):
        self.cid = cid
        self.key = key
        self.rid = rid
        self.reduced = reduced
        self.records: List[str] = []
        self.status = "queued"               # queued|running|complete|drained
        self.terminal: dict = {}
        self.cond = threading.Condition()

    def start(self):
        """The campaign's slot is admitted: it is running."""
        with self.cond:
            if self.status == "queued":
                self.status = "running"
                self.cond.notify_all()

    def push(self, lo: int, hi: int, arrays: Dict[str, np.ndarray]):
        fields = _pareto.REDUCED_FIELDS if self.reduced else RESULT_FIELDS
        with self.cond:
            rec = {"cursor": len(self.records), "lo": int(lo),
                   "hi": int(hi),
                   "arrays": {f: _pareto.array_to_wire(np.asarray(arrays[f]))
                              for f in fields}}
            self.records.append(json.dumps(rec))
            if self.status == "queued":
                self.status = "running"
            self.cond.notify_all()

    def finish(self, status: str, terminal: dict):
        with self.cond:
            if self.status in ("complete", "drained"):
                return
            self.status = status
            self.terminal = dict(terminal)
            self.cond.notify_all()


class _Draining(Exception):
    """The transport is draining: the submission was not admitted."""


class _Submission:
    """A decoded POST on its way to the worker, and the worker's answer:
    ``result`` ``(campaign id, created, http status)`` or ``error``."""

    def __init__(self, key: str, kw: dict):
        self.key = key
        self.kw = kw
        self.done = threading.Event()
        self.result: Optional[Tuple[str, bool, int]] = None
        self.error: Optional[Exception] = None


class SweepTransport:
    """HTTP front end over a service stepped by one worker thread.

    One worker thread owns every ``SweepService`` interaction (the
    service is single-threaded): it takes submissions from the inbox
    between steps and steps the service.  HTTP handler threads only do
    JSON/base64, registry lookups under ``_reg_lock`` and blocking waits
    on campaign conditions, so streams and status stay live (heartbeats
    included) while a unit computes.
    """

    def __init__(self, service: SweepService, host: str = "127.0.0.1",
                 port: int = 0, *,
                 injector: Optional[NetFaultInjector] = None,
                 campaign_cap: int = 256, poll_s: float = 0.02):
        self.service = service
        self.injector = injector
        # finished campaigns kept resumable for reconnecting clients,
        # evicted oldest-first past this cap (a stream for an evicted
        # campaign 404s; the client re-submits under its key)
        self.campaign_cap = max(1, int(campaign_cap))
        self.poll_s = poll_s
        self._reg_lock = threading.Lock()    # registry + inbox
        self._campaigns: "OrderedDict[str, _Campaign]" = OrderedDict()
        self._by_key: Dict[str, str] = {}
        self._by_rid: Dict[int, str] = {}
        self._inbox: List[_Submission] = []
        self._closed = False                 # inbox refuses (worker gone)
        self._queued = 0                     # queue depth, for readyz
        self._work = threading.Event()       # submitted -> wake worker
        self._drain_req = threading.Event()
        self._stopped = threading.Event()
        handler = type("_BoundHandler", (_Handler,), {"transport": self})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.host, self.port = self.httpd.server_address[:2]
        self._threads: List[threading.Thread] = []

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> Tuple[str, int]:
        for target in (self.httpd.serve_forever, self._run):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)
        return self.host, self.port

    def request_drain(self):
        """Signal-safe drain trigger (the SIGTERM handler calls this):
        admission stops immediately; the worker finishes the unit in
        flight, checkpoints, and closes streams with ``drained``."""
        self._drain_req.set()
        self._work.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the worker has fully stopped (drained)."""
        return self._stopped.wait(timeout)

    @property
    def draining(self) -> bool:
        return self._drain_req.is_set()

    @property
    def queued(self) -> int:
        """Requests waiting for a slot, as of the worker's last step."""
        return self._queued

    def close(self):
        """Drain, then release the port: the serve loop has exited (the
        worker shut it down) before the listening socket closes, so a new
        transport can bind the same port at once."""
        self.request_drain()
        self.wait(timeout=60)
        for t in self._threads:
            t.join(timeout=60)
        self.httpd.server_close()

    # -- worker loop --------------------------------------------------------
    def _run(self):
        try:
            while not self._drain_req.is_set():
                self._take_submissions()
                busy = self._step()
                if not busy:
                    self._work.wait(self.poll_s)
                    self._work.clear()
            self._do_drain()
        finally:
            with self._reg_lock:
                self._closed = True
                subs, self._inbox = self._inbox, []
            for sub in subs:
                sub.error = _Draining("draining")
                sub.done.set()
            self._stopped.set()
            threading.Thread(target=self.httpd.shutdown,
                             daemon=True).start()

    def _step(self) -> bool:
        """Admit, publish ``running`` for every admitted campaign, then
        advance the service by one unit a slot."""
        svc = self.service
        svc._admit()
        with self._reg_lock:
            camps = [self._campaigns.get(self._by_rid.get(r.rid, ""))
                     for slot in svc._slots if slot is not None
                     for r in slot.requests()]
        for camp in camps:
            if camp is not None:
                camp.start()
        busy = svc.step()
        self._sync_completed()
        self._queued = len(svc.queue)
        return busy

    def _sync_completed(self):
        """Move finished service results into campaign terminal state."""
        for rid in list(self.service.completed):
            with self._reg_lock:
                cid = self._by_rid.pop(rid, None)
                camp = self._campaigns.get(cid) if cid else None
            if cid is None:
                continue
            res = self.service.completed.pop(rid)
            if camp is not None:
                camp.finish("complete", {
                    "expired": bool(res.expired),
                    "skipped_lanes": int(res.skipped_lanes)})

    def _do_drain(self):
        """Stop admitting, make in-flight work durable, close streams.

        Runs at a unit boundary (the worker checks the drain flag between
        steps), so nothing is mid-computation here: queued requests are
        refused back to their clients as ``drained``, each active slot's
        checkpoints are flushed (async saves block until durable), and
        every unfinished campaign gets the ``drained`` sentinel."""
        self._sync_completed()
        self.service.queue.clear()
        for slot in self.service._slots:
            if slot is not None and slot.runner.mgr is not None:
                slot.runner.mgr.wait()
        with self._reg_lock:
            camps = list(self._campaigns.values())
        for camp in camps:
            camp.finish("drained", {})

    def _take_submissions(self):
        with self._reg_lock:
            subs, self._inbox = self._inbox, []
        for sub in subs:
            try:
                sub.result = self._admit_submission(sub)
            except Exception as e:  # noqa: BLE001 - raised in its handler
                sub.error = e
            sub.done.set()

    def _admit_submission(self, sub: _Submission) -> Tuple[str, bool, int]:
        """Admit a submission to the service (worker thread), or replay
        the campaign its idempotency key already names."""
        with self._reg_lock:
            cid = self._by_key.get(sub.key)
            if cid is not None and cid in self._campaigns:
                return cid, False, 200
        req = SweepRequest(**sub.kw)
        cid = f"c{self.service._next_rid}"
        camp = _Campaign(cid, sub.key, -1, sub.kw["reduce"] is not None)
        req.on_partial = \
            lambda rid, lo, hi, arrays: camp.push(lo, hi, arrays)
        camp.rid = self.service.submit(req)  # may raise ServiceOverloaded
        with self._reg_lock:
            self._campaigns[cid] = camp
            self._by_key[sub.key] = cid
            self._by_rid[camp.rid] = cid
            self._evict_finished()
        self._queued = len(self.service.queue)
        return cid, True, 201

    # -- submission (called from handler threads) ---------------------------
    def submit(self, body: dict) -> Tuple[str, bool, int]:
        """Admit (or replay) a submission; returns ``(campaign id,
        created, http status)``.  Raises ``ServiceOverloaded`` /
        ``ValueError`` / ``_Draining`` for the handler to map onto 429 /
        400 / 503.  Waits for the worker for at most the step in
        flight."""
        key = body.get("idempotency_key")
        if not isinstance(key, str) or not key:
            raise ValueError("submission needs a string idempotency_key")
        if int(body.get("v", 0)) != WIRE_VERSION:
            raise ValueError(
                f"wire version {body.get('v')!r} != {WIRE_VERSION}")
        with self._reg_lock:
            cid = self._by_key.get(key)
            if cid is not None and cid in self._campaigns:
                return cid, False, 200
        sub = _Submission(key, sweep_from_wire(body["sweep"]))
        with self._reg_lock:
            if self._closed or self.draining:
                raise _Draining("draining")
            self._inbox.append(sub)
        self._work.set()
        sub.done.wait()
        if sub.error is not None:
            raise sub.error
        return sub.result

    def _evict_finished(self):
        """Drop the oldest finished campaigns past the cap (caller holds
        ``_reg_lock``)."""
        done = [c for c in self._campaigns.values()
                if c.status in ("complete", "drained")]
        excess = len(self._campaigns) - self.campaign_cap
        for camp in done[:max(0, excess)]:
            self._campaigns.pop(camp.cid, None)
            if self._by_key.get(camp.key) == camp.cid:
                self._by_key.pop(camp.key, None)

    def campaign(self, cid: str) -> Optional[_Campaign]:
        with self._reg_lock:
            return self._campaigns.get(cid)


# ---------------------------------------------------------------------------
# HTTP handler
# ---------------------------------------------------------------------------

class _Handler(BaseHTTPRequestHandler):
    transport: SweepTransport = None     # bound via subclass in __init__
    # HTTP/1.0: responses are delimited by connection close, so the
    # stream needs no chunked framing and an injected "disconnect" is
    # indistinguishable from a real one
    protocol_version = "HTTP/1.0"

    def log_message(self, fmt, *args):   # noqa: A003 - quiet by default
        pass

    # -- helpers ------------------------------------------------------------
    def _json(self, status: int, obj: dict, headers: Dict[str, str] = ()):
        body = (json.dumps(obj) + "\n").encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in dict(headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _line(self, obj_or_raw):
        raw = obj_or_raw if isinstance(obj_or_raw, str) \
            else json.dumps(obj_or_raw)
        self.wfile.write(raw.encode() + b"\n")
        self.wfile.flush()

    # -- POST ---------------------------------------------------------------
    def do_POST(self):
        t = self.transport
        if urlparse(self.path).path != "/v1/sweeps":
            self._json(404, {"error": "not found"})
            return
        if t.draining:
            self._json(503, {"error": "draining"}, {"Retry-After": "1"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n))
            cid, created, status = t.submit(body)
        except ServiceOverloaded as e:
            self._json(429, {"error": str(e)}, {"Retry-After": "1"})
            return
        except _Draining:
            self._json(503, {"error": "draining"}, {"Retry-After": "1"})
            return
        except (ValueError, KeyError, TypeError) as e:
            self._json(400, {"error": str(e)})
            return
        inj = t.injector
        if inj is not None and inj.drop_submit_response(
                body["idempotency_key"]):
            # chaos: the campaign IS admitted but the response is lost;
            # the client's retry must land on the idempotency key
            self.close_connection = True
            return
        self._json(status, {"campaign": cid, "created": created,
                            "v": WIRE_VERSION})

    # -- GET ----------------------------------------------------------------
    def do_GET(self):
        t = self.transport
        url = urlparse(self.path)
        parts = [p for p in url.path.split("/") if p]
        try:
            if url.path == "/healthz":
                self._json(200, {"ok": True})
            elif url.path == "/readyz":
                if t.draining:
                    self._json(503, {"ready": False, "draining": True})
                else:
                    self._json(200, {"ready": True, "queued": t.queued})
            elif len(parts) == 3 and parts[:2] == ["v1", "sweeps"]:
                camp = t.campaign(parts[2])
                if camp is None:
                    self._json(404, {"error": "unknown campaign"})
                    return
                with camp.cond:
                    self._json(200, {"campaign": camp.cid,
                                     "status": camp.status,
                                     "records": len(camp.records)})
            elif (len(parts) == 4 and parts[:2] == ["v1", "sweeps"]
                  and parts[3] == "stream"):
                camp = t.campaign(parts[2])
                if camp is None:
                    self._json(404, {"error": "unknown campaign"})
                    return
                q = parse_qs(url.query)
                cursor = int(q.get("cursor", ["0"])[0])
                self._stream(camp, max(0, cursor))
            else:
                self._json(404, {"error": "not found"})
        except (BrokenPipeError, ConnectionError, OSError):
            self.close_connection = True

    def _stream(self, camp: _Campaign, cursor: int):
        """Send records[cursor:] as JSON lines, blocking for new ones,
        until terminal status; heartbeat while idle.  Chaos duplicates/
        delays/disconnects are applied here, per record."""
        inj = self.transport.injector
        budget = inj.stream_disconnect_after() if inj else None
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.end_headers()
        sent, sent_here = cursor, 0
        while True:
            with camp.cond:
                if len(camp.records) <= sent \
                        and camp.status in ("queued", "running"):
                    camp.cond.wait(0.25)
                recs = list(camp.records[sent:])
                status, terminal = camp.status, dict(camp.terminal)
            if not recs and status in ("queued", "running"):
                self._line({"heartbeat": True, "cursor": sent})
                continue
            for raw in recs:
                if inj is not None:
                    delay = inj.delay_record(camp.cid, sent)
                    if delay > 0:
                        time.sleep(delay)
                self._line(raw)
                if inj is not None and inj.duplicate_record(camp.cid, sent):
                    self._line(raw)          # at-least-once, made visible
                sent += 1
                sent_here += 1
                if budget is not None and sent_here >= budget:
                    # chaos: cut the connection without a terminal line;
                    # the client reconnects at cursor=sent
                    self.close_connection = True
                    return
            if status not in ("queued", "running"):
                self._line({"status": status, "cursor": sent, **terminal})
                return


# ---------------------------------------------------------------------------
# serve CLI (python -m repro.service serve ...)
# ---------------------------------------------------------------------------

def serve_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.service serve",
        description="HTTP front end for the sweep service")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = ephemeral (see --port-file)")
    ap.add_argument("--port-file", default=None,
                    help="write {host, port} JSON here once bound")
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--queue-max", type=int, default=16)
    ap.add_argument("--pack-max-lanes", type=int, default=256)
    ap.add_argument("--unit-size", type=int, default=8)
    ap.add_argument("--max-steps", type=int, default=2048)
    ap.add_argument("--mem-size", type=int, default=4096)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain version on the host; "
                         "default: the CUDA device")
    ap.add_argument("--ckpt-root", default=None,
                    help="checkpoint re-submitted campaigns across "
                         "restarts (fingerprint-keyed subdirectories)")
    args = ap.parse_args(argv)

    from ..core.characterization import default_profile

    plan = FaultPlan.from_env()
    net_inj = NetFaultInjector(plan) if plan is not None else None
    runner_kw = {}
    if plan is not None:
        # execution faults ride the same plan: the service's runners see
        # transients/broken backends while the transport sees the
        # network stanza -- one env var chaoses the whole stack
        runner_kw["injector"] = FaultInjector(plan)
    service = SweepService(
        default_profile(), slots=args.slots, queue_max=args.queue_max,
        pack_max_lanes=args.pack_max_lanes, unit_size=args.unit_size,
        max_steps=args.max_steps, mem_size=args.mem_size,
        device=args.device, runner_kw=runner_kw,
        ckpt_root=args.ckpt_root)
    transport = SweepTransport(service, args.host, args.port,
                               injector=net_inj)
    host, port = transport.start()
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"host": host, "port": port}, f)
        import os
        os.replace(tmp, args.port_file)

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: transport.request_drain())
    print(f"[sweep-serve] listening on {host}:{port} "
          f"(device={service.device}, slots={args.slots}, "
          f"chaos={'on' if plan is not None else 'off'})", flush=True)
    while not transport.wait(timeout=0.2):
        pass
    transport.close()
    print("[sweep-serve] drained, exiting", flush=True)
    return 0
