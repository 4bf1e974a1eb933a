"""Crash-safe DSE sweep service on the port.

``runner``  -- partitioned, checkpointed, retried sweep execution
               (``ResumableSweepRunner``): a killed campaign resumes from
               the last complete unit, bit-identical to an uninterrupted
               run.
``monitor`` -- wires the runtime scaffolding (heartbeats, failure
               detection, straggler policy) into the runner.
``server``  -- minimal sweep service: bounded admission queue with
               backpressure, same-shape request packing into shared
               lanes, per-request deadlines, streamed per-unit partials.
``transport`` -- chaos-hardened HTTP front end (idempotent submission,
               cursor-resumable JSON-lines result streams, graceful
               drain on SIGTERM); ``python -m repro_torch.service serve``.
``client``  -- ``SweepClient``: backoff + jitter, reconnect-and-resume
               from cursor, idempotent folding of replayed records.
"""
from .client import ClientResult, ClientRetry, ClientStats, SweepClient, \
    TransportError
from .monitor import FleetMonitor
from .runner import (BackendStage, CheckpointMismatch, ResumableSweepRunner,
                     RetryPolicy, RunnerReport, SweepUnitError, UnitRecord,
                     UnitTimeout, backend_chain)
from .server import (RequestResult, ServiceOverloaded, SweepRequest,
                     SweepService)
from .transport import SweepTransport, serve_main
