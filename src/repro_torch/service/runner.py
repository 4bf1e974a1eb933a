"""Fault-tolerant, resumable sweep runner.

A monolithic ``dse.sweep`` over a large (program x hw x data) grid is
all-or-nothing: one device error or SIGKILL loses the whole campaign.
This runner makes large sweeps crash-safe:

  * **Partitioned execution**: the flattened grid (``dse.plan_grid``) is
    split into fixed-size work units along the batch axis; every unit is
    padded to the same lane count and runs through one grid fn
    (``dse.make_grid_fn``), so every unit launches the sweep kernel with
    the same shape.
  * **Checkpointed progress**: each completed unit's ``SweepResult``
    slice is persisted atomically via ``CheckpointManager`` (tmp-rename,
    so a crash mid-save never corrupts completed units).  A killed
    process resumes from the last complete unit and the stitched result
    is bit-identical to an uninterrupted run: lanes are independent, so
    a lane's numbers do not depend on which process computed its unit.
    Checkpoints carry a campaign fingerprint (grid + config hash);
    resuming against a different campaign's directory is refused.
  * **Retry / deadline / backoff**: unit attempts are retried with
    exponential backoff.  The stage chain has one stage -- the CUDA
    kernel on the card, or the plain version when the caller named the
    CPU -- so no fallback ever hides the kernel: a persistent failure,
    or retries exhausted, raises ``SweepUnitError``.  A CUDA error is
    never retried: it can leave the context unusable, so it ends the
    process, and the checkpoints let a new process resume.
  * **Fleet wiring**: per-unit workers beat the ``HeartbeatBus``; a
    confirmed ``FailureDetector`` failure (or a persistent straggler's
    "replace" action) evicts the node and records a re-plan event --
    completed units stay checkpointed, nothing re-runs.  With a
    ``mesh`` every node is a mesh entry and the re-plan is elastic: the
    remaining units run on a smaller mesh of the survivors
    (``runtime.plan_downscale``), recorded in the report.
    ``StragglerDetector`` step times feed a unit-size rebalancing
    suggestion for the next campaign.
  * **Fault injection**: all of the above is exercised deterministically
    via ``runtime.faults`` (no real hardware faults needed).

CLI (the subprocess target of the kill-and-resume drills)::

  PYTHONPATH=src python -m repro_torch.service \\
      --kernels bitcnt,crc32 --ckpt-dir /tmp/sweep_ck --unit-size 4 \\
      --out /tmp/sweep.npz [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Set, Tuple, Union

import numpy as np
import torch

from ..analysis import pareto as _pareto
from ..checkpoint import CheckpointManager
from ..checkpoint.manager import load_tree
from ..core import dse
from ..core.autotune import AUTO, ShapeClass, default_cache
from ..core.characterization import Profile
from ..core.dse import GridPlan, SweepResult
from ..device import DeviceLike, resolve_device
from ..parallel.sharding import Mesh, mesh_device
from ..runtime import plan_downscale
from ..runtime.faults import BackendFault, FaultInjector
from .monitor import FleetMonitor

RESULT_FIELDS = tuple(SweepResult._fields)
_RESULT_DTYPES = {"latency_cc": np.int32, "energy_pj": np.float32,
                  "power_mw": np.float32, "checksum": np.int32,
                  "steps_executed": np.int32}


class SweepUnitError(RuntimeError):
    """A work unit failed on the stage chain (persistent fault or
    retries exhausted)."""


class UnitTimeout(RuntimeError):
    """A unit attempt exceeded the per-unit deadline (retried)."""


class CheckpointMismatch(ValueError):
    """Checkpoint directory belongs to a different campaign (grid or
    config fingerprint differs) -- refusing to stitch foreign units."""


@dataclasses.dataclass(frozen=True)
class BackendStage:
    """One stage of the chain: ``"cuda"`` (the kernel on the card) or
    ``"plain"`` (the plain PyTorch version on the host)."""
    name: str


def backend_chain(device: DeviceLike = None) -> Tuple[BackendStage, ...]:
    """The stage chain for ``device``: one stage.  The card runs the
    kernel and nothing else; the plain version runs only when the caller
    named the CPU."""
    dev = resolve_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported sweep device {dev}")
    return (BackendStage("cuda" if dev.type == "cuda" else "plain"),)


def _is_cuda_error(e: BaseException) -> bool:
    """An error of the CUDA runtime (a launch the kernel wrapper saw
    fail, or a fault PyTorch reported at a synchronise)."""
    accel = getattr(torch, "AcceleratorError", None)
    return (accel is not None and isinstance(e, accel)) \
        or (isinstance(e, RuntimeError) and "CUDA error" in str(e))


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Per-unit retry/deadline policy."""
    max_attempts: int = 3            # attempts per unit
    backoff_s: float = 0.05          # first retry delay
    backoff_mult: float = 2.0        # exponential growth
    unit_timeout_s: Optional[float] = None   # post-hoc deadline per attempt


@dataclasses.dataclass
class UnitRecord:
    unit: int
    lo: int
    hi: int
    backend: str          # stage name that produced the result
    attempts: int
    resumed: bool
    seconds: float
    node: str


@dataclasses.dataclass
class RunnerReport:
    """What happened to a campaign -- the service's observability."""
    units_total: int = 0
    units_run: int = 0
    units_resumed: int = 0
    units_skipped: int = 0
    attempts_total: int = 0
    replans: List[dict] = dataclasses.field(default_factory=list)
    straggler_actions: List[dict] = dataclasses.field(default_factory=list)
    suggested_unit_size: Optional[int] = None
    wall_s: float = 0.0
    records: List[UnitRecord] = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class ResumableSweepRunner:
    """Partitioned, checkpointed, retried execution of one grid.

    Construct from raw grid axes (``programs``/``hw_configs``/
    ``mem_images``) or from a prebuilt ``plan`` (the sweep server packs
    several requests into one plan); the grid runs where the plan's
    images are.  ``run()`` executes every pending unit and returns the
    stitched result plus a report; the server instead drives
    ``run_unit`` one unit at a time.

    With ``reduce`` (an ``analysis.pareto`` spec) every unit reduces on
    the device and checkpoints its compacted ``(G, K)`` candidate set,
    and ``stitch`` merges the unit fronts (``merge_reduced``) into the
    campaign's ``ReducedResult``.  The reduction spec is part of the
    campaign fingerprint.

    With ``mesh`` (a ``parallel.Mesh``) each unit's lanes split over the
    mesh's entries (``dse.make_grid_fn(mesh=)``), the plan lives on the
    mesh's first device, and a unit is padded up to a multiple of the
    mesh's initial entry count; checkpoints stay in real lane ranges.
    The monitor's nodes (default ``dev0..devN-1``) map to the mesh's
    entries in flat order."""

    def __init__(self, program=None, profile: Profile = None,
                 hw_configs=None, mem_images=None, *,
                 programs=None, mappings=None,
                 plan: Optional[GridPlan] = None,
                 ckpt_dir: Optional[str] = None, unit_size: int = 64,
                 max_steps: int = 2048, mem_size: int = 4096,
                 chunk_steps: Union[int, None, str] = AUTO,
                 blk_b: Union[int, str] = AUTO,
                 reduce: Optional[_pareto.Reduction] = None,
                 device: DeviceLike = None,
                 mesh: Optional[Mesh] = None,
                 retry: Optional[RetryPolicy] = None,
                 injector: Optional[FaultInjector] = None,
                 monitor: Optional[FleetMonitor] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 sleep: Callable[[float], None] = time.sleep,
                 on_unit=None, ckpt_async: bool = True):
        if mappings is not None:
            # a MappingSet is a program sequence plus a segment map:
            # units, checkpoints and the fingerprint work unchanged, and
            # ``stitch_folded`` collapses the answer to per-kernel rows
            if program is not None or programs is not None:
                raise TypeError(
                    "ResumableSweepRunner: pass mappings= OR "
                    "program(s)=, not both")
            programs = list(mappings.programs)
        self.mappings = mappings
        if plan is None:
            if mesh is not None:
                device = mesh_device(mesh, device)
            plan = dse.plan_grid(program, hw_configs, mem_images,
                                 programs=programs, device=device)
        elif device is not None:
            raise TypeError("ResumableSweepRunner: a plan runs where its "
                            "images are; pass plan= OR device=, not both")
        elif mesh is not None:
            mesh_device(mesh, plan.images.device)
        self.plan = plan
        self.device = plan.images.device
        self.profile = profile
        self.mesh = mesh
        self._initial_ndev = 1 if mesh is None else mesh.devices.size
        self.unit_size = max(1, unit_size)
        # the unit's lanes split evenly over the initial mesh; a re-plan
        # keeps a width that divides this
        self._padded_unit = -(-self.unit_size // self._initial_ndev) \
            * self._initial_ndev
        self.max_steps = max_steps
        self.mem_size = mem_size
        # AUTO knobs resolve through the autotune cache with the
        # service's lane-shape proxy (H = lanes per program, D = 1);
        # explicit values win.  Resolved HERE so the fingerprint hashes
        # concrete ints: a checkpoint stays resumable whatever the cache
        # holds later.
        G = plan.batch.n_programs
        lanes_per_prog = max(1, plan.n_lanes // max(G, 1))
        cfg = default_cache().resolve(
            ShapeClass(G=G, t_max=plan.batch.t_max, H=lanes_per_prog, D=1,
                       device=self.device.type,
                       n_devices=self._initial_ndev),
            blk_b=blk_b, chunk_steps=chunk_steps, max_buckets=1)
        self.chunk_steps = cfg.chunk_steps
        self.blk_b = cfg.blk_b
        self.tuned_source = cfg.source       # "explicit" | "cache" | "default"
        self.reduce = reduce
        self.G = G
        self.retry = retry or RetryPolicy()
        self.injector = injector
        self.clock = clock
        self.sleep = sleep
        self.on_unit = on_unit
        self.ckpt_async = ckpt_async

        self.B = plan.n_lanes
        self.n_units = -(-self.B // self.unit_size)
        self._chain = backend_chain(self.device)
        self._fn: Optional[Callable] = None     # for the current mesh
        self._results: Dict[int, Dict[str, np.ndarray]] = {}
        self._skipped: Set[int] = set()
        self._pending_replace: Set[str] = set()

        self.monitor = monitor or FleetMonitor(
            [f"dev{i}" for i in range(self._initial_ndev)])
        self._node_device = ({} if mesh is None else
                             dict(zip(self.monitor.nodes, mesh.flat())))
        self.report = RunnerReport(units_total=self.n_units)
        t0 = time.perf_counter()
        self.fingerprint = self._fingerprint()
        self.fingerprint_s = time.perf_counter() - t0
        self.mgr = None
        if ckpt_dir is not None:
            # keep_n=0: never expire unit checkpoints -- every unit is
            # needed to stitch the campaign
            self.mgr = CheckpointManager(ckpt_dir, keep_n=0)
            self._load_completed()

    @property
    def stage(self) -> BackendStage:
        return self._chain[0]

    # -- campaign identity --------------------------------------------------
    def _fingerprint(self) -> str:
        """sha256 of the programs, every lane's config, the images (read
        back from the device), the lane index rows and the knobs."""
        h = hashlib.sha256()
        b = self.plan.batch
        for a in (b.ops, b.dest, b.srcA, b.srcB, b.imm, b.n_instrs):
            h.update(np.ascontiguousarray(a).tobytes())
        for leaf in self.plan.hw_grid.as_dict().values():
            h.update(_numpy(leaf).tobytes())
        h.update(_numpy(self.plan.images).tobytes())
        h.update(np.ascontiguousarray(self.plan.img_idx).tobytes())
        h.update(np.ascontiguousarray(self.plan.prog_idx).tobytes())
        h.update(json.dumps([self.max_steps, self.mem_size, self.unit_size,
                             self.chunk_steps, self.stage.name, self.blk_b,
                             _pareto.spec_to_str(self.reduce)
                             if self.reduce is not None else None]).encode())
        return h.hexdigest()

    # -- resume -------------------------------------------------------------
    def _load_completed(self):
        for step in self.mgr.steps():
            path = self.mgr.path(step)
            extra = json.loads(
                (path / "manifest.json").read_text()).get("extra", {})
            if extra.get("fingerprint") != self.fingerprint:
                raise CheckpointMismatch(
                    f"{path}: checkpoint fingerprint "
                    f"{extra.get('fingerprint', '?')[:12]} does not match "
                    f"this campaign ({self.fingerprint[:12]}); refusing to "
                    f"resume -- clear the directory or fix the grid/config")
            lo, hi = self._unit_range(step)
            if (int(extra.get("lo", -1)), int(extra.get("hi", -1))) \
                    != (lo, hi):
                raise CheckpointMismatch(
                    f"{path}: unit lane range {extra.get('lo')}:"
                    f"{extra.get('hi')} != planned {lo}:{hi}")
            if self.reduce is not None:
                like = _pareto.reduced_zeros(self.G, self.reduce)
            else:
                like = {f: np.zeros(hi - lo, _RESULT_DTYPES[f])
                        for f in RESULT_FIELDS}
            self._results[step] = load_tree(like, path)
            stage = extra.get("backend", self.stage.name)
            self.report.units_resumed += 1
            self.report.records.append(UnitRecord(
                unit=step, lo=lo, hi=hi, backend=stage,
                attempts=int(extra.get("attempts", 0)), resumed=True,
                seconds=0.0, node=""))

    def attach_checkpoints(self, ckpt_dir: Union[str, Path]) -> None:
        """Late-bind a checkpoint directory and load its completed units.

        The sweep service packs requests into a plan before it knows the
        campaign fingerprint, so it constructs the runner bare and
        attaches ``<ckpt_root>/<fingerprint prefix>`` afterwards: a
        re-submitted campaign resumes its completed units across a
        service restart, like the ``ckpt_dir=`` constructor path."""
        if self._results or self._skipped:
            raise RuntimeError(
                "attach_checkpoints: campaign already has unit results; "
                "attach before the first run_unit call")
        self.mgr = CheckpointManager(str(ckpt_dir), keep_n=0)
        self._load_completed()

    # -- unit geometry ------------------------------------------------------
    def _unit_range(self, k: int) -> Tuple[int, int]:
        lo = k * self.unit_size
        return lo, min(self.B, lo + self.unit_size)

    def pending_units(self) -> List[int]:
        return [k for k in range(self.n_units)
                if k not in self._results and k not in self._skipped]

    def _unit_args(self, k: int):
        """Slice the plan for unit ``k``, padded to the common unit lane
        count with duplicates of the last real lane (independent lanes:
        redundant work, never wrong results).  Under ``reduce`` the lane
        row carries each lane's flat grid index, -1 on the pad lanes so
        the reducer masks them."""
        lo, hi = self._unit_range(k)
        sel = np.minimum(np.arange(lo, lo + self._padded_unit), self.B - 1)
        sel_d = torch.as_tensor(sel, device=self.device)
        hw = self.plan.hw_grid.map(lambda x: x[sel_d])
        lane = None
        if self.reduce is not None:
            n = np.arange(self._padded_unit)
            lane = np.where(n < hi - lo, lo + n, -1).astype(np.int32)
        return self.plan.img_idx[sel], hw, self.plan.prog_idx[sel], lane

    def _grid_fn(self) -> Callable:
        if self._fn is None:
            self._fn = dse.make_grid_fn(
                self.plan, self.profile, max_steps=self.max_steps,
                mem_size=self.mem_size, chunk_steps=self.chunk_steps,
                blk_b=self.blk_b, reduce=self.reduce, mesh=self.mesh)
        return self._fn

    def _synchronize(self) -> None:
        """Wait for every card the current mesh (or the plan) runs on."""
        if self.device.type == "cuda":
            for d in (self.mesh.distinct() if self.mesh is not None
                      else [self.device]):
                torch.cuda.synchronize(d)

    # -- fleet re-plan ------------------------------------------------------
    def _replan(self, k: int, failed: Set[str]):
        """Drop confirmed-failed workers and continue the remaining units;
        completed units stay checkpointed.  With a mesh the remaining
        units run on a mesh of the survivors: the widest power of two
        that ``plan_downscale`` allows and that divides the padded
        unit."""
        for n in sorted(failed):
            self.monitor.evict(n)
        self._pending_replace -= failed
        alive = self.monitor.nodes
        if not alive:
            raise SweepUnitError(
                f"unit {k}: every worker is confirmed failed; "
                f"cannot re-plan the campaign")
        event = {"unit": k, "dropped": sorted(failed),
                 "n_alive": len(alive)}
        if self.mesh is not None:
            plan = plan_downscale(len(alive), model=1,
                                  data=self._initial_ndev, pods=1)
            nd = 1
            while (nd * 2 <= plan.n_devices
                   and self._padded_unit % (nd * 2) == 0):
                nd *= 2
            devices = [self._node_device[n] for n in alive
                       if n in self._node_device][:nd]
            if len(devices) < nd:
                raise SweepUnitError(
                    f"unit {k}: {len(devices)} surviving nodes map to mesh "
                    f"entries; the re-plan needs {nd}")
            self.mesh = Mesh(devices, ("data",))
            self._fn = None               # built once for the new mesh
            event["elastic_plan"] = {
                "mesh_shape": list(plan.mesh_shape), "n_devices": nd,
                "grad_accum_factor": plan.grad_accum_factor}
        self.report.replans.append(event)

    # -- execution ----------------------------------------------------------
    def _execute(self, k: int):
        """One unit through retry.  Returns (attempts, seconds, result).

        The timed window ends with a device synchronise, so it holds the
        kernel's time and any fault the device reports."""
        idx, hw, gi, lane = self._unit_args(k)
        stage = self.stage
        errors: List[str] = []
        for attempt in range(1, self.retry.max_attempts + 1):
            self.report.attempts_total += 1
            try:
                if self.injector is not None:
                    self.injector.on_attempt(k, attempt, stage.name)
                t0 = self.clock()
                fn = self._grid_fn()
                res = fn(idx, hw, gi) if lane is None \
                    else fn(idx, hw, gi, lane)
                self._synchronize()
                secs = self.clock() - t0
                if self.injector is not None:
                    secs += self.injector.extra_seconds(k)
                if (self.retry.unit_timeout_s is not None
                        and secs > self.retry.unit_timeout_s):
                    raise UnitTimeout(
                        f"unit {k}: {secs:.3f}s exceeded the "
                        f"{self.retry.unit_timeout_s:.3f}s deadline")
                return attempt, secs, res
            except BackendFault as e:
                errors.append(f"{stage.name}: {e}")
                break                     # persistent: no retry
            except Exception as e:  # noqa: BLE001 - any attempt error
                if _is_cuda_error(e):
                    raise                 # the context may be unusable
                errors.append(f"{stage.name} attempt {attempt}: {e}")
                if attempt < self.retry.max_attempts:
                    self.sleep(self.retry.backoff_s
                               * self.retry.backoff_mult ** (attempt - 1))
        lo, hi = self._unit_range(k)
        raise SweepUnitError(
            f"unit {k} [{lo}:{hi}) failed on every backend of the chain "
            f"{[s.name for s in self._chain]}: " + "; ".join(errors))

    def run_unit(self, k: int) -> Tuple[UnitRecord, Dict[str, np.ndarray]]:
        """Execute (and commit) one pending unit."""
        lo, hi = self._unit_range(k)
        # every live worker beats; injected-dead nodes go silent from
        # their configured unit on
        for n in self.monitor.nodes:
            if self.injector is None or not self.injector.node_dead(n, k):
                self.monitor.beat(n)
        failed = set(self.monitor.confirmed_failed()) | self._pending_replace
        if failed:
            self._replan(k, failed)
        node = self.monitor.nodes[k % len(self.monitor.nodes)]

        attempts, secs, res = self._execute(k)
        if self.reduce is not None:
            # compacted (G, K) candidate set; pad lanes were masked
            res_np = {f: _numpy(getattr(res, f))
                      for f in _pareto.REDUCED_FIELDS}
        else:
            res_np = {f: _numpy(getattr(res, f))[:hi - lo]
                      for f in RESULT_FIELDS}
        rec = UnitRecord(unit=k, lo=lo, hi=hi, backend=self.stage.name,
                         attempts=attempts, resumed=False, seconds=secs,
                         node=node)
        self.report.units_run += 1
        self.report.records.append(rec)

        actions = self.monitor.observe_unit(node, secs)
        for n, act in actions.items():
            self.report.straggler_actions.append(
                {"unit": k, "node": n, "action": act})
            if (self.report.suggested_unit_size is None
                    and self.unit_size > 1):
                self.report.suggested_unit_size = max(self.unit_size // 2, 1)
            if act == "replace":
                self._pending_replace.add(n)

        self._results[k] = res_np
        if self.mgr is not None:
            # the previous unit's async save ends here (save() would join
            # it next), so the kill point below loses this unit alone
            self.mgr.wait()
            if self.injector is not None:
                self.injector.on_commit(k)     # kill point: pre-durability
            self.mgr.save(res_np, k, extra={
                "fingerprint": self.fingerprint, "lo": lo, "hi": hi,
                "backend": self.stage.name, "attempts": attempts,
            }, block=not self.ckpt_async)
        if self.on_unit is not None:
            self.on_unit(rec, res_np)
        return rec, res_np

    def mark_skipped(self, k: int):
        """Give up on a unit (deadline-expired request): its lanes stitch
        as zeros and the report counts it."""
        if k not in self._results and k not in self._skipped:
            self._skipped.add(k)
            self.report.units_skipped += 1

    # -- stitching ----------------------------------------------------------
    def stitch(self, *, require_complete: bool = True
               ) -> Union[SweepResult, _pareto.ReducedResult]:
        """Assemble the full-grid ``SweepResult`` (host tensors) from the
        unit results, checkpointed and freshly run.  Skipped units
        stitch as zeros.

        Under ``reduce`` the unit candidate sets merge into the
        campaign's host ``ReducedResult`` instead (skipped units
        contribute no candidates)."""
        missing = self.pending_units()
        if missing and require_complete:
            raise SweepUnitError(
                f"cannot stitch: units {missing} incomplete")
        if self.reduce is not None:
            parts = [_pareto.ReducedResult(
                **{f: res[f] for f in _pareto.REDUCED_FIELDS})
                for _, res in sorted(self._results.items())]
            if not parts:
                return _pareto.ReducedResult(
                    **_pareto.reduced_zeros(self.G, self.reduce))
            return _pareto.merge_reduced(self.reduce, parts)
        out = {f: np.zeros(self.B, _RESULT_DTYPES[f])
               for f in RESULT_FIELDS}
        for k, res in self._results.items():
            lo, hi = self._unit_range(k)
            for f in RESULT_FIELDS:
                out[f][lo:hi] = res[f]
        return SweepResult(**{f: torch.from_numpy(out[f])
                              for f in RESULT_FIELDS})

    def stitch_folded(self, *, require_complete: bool = True
                      ) -> _pareto.ReducedResult:
        """Stitch a reduced mapping campaign and fold the per-candidate
        rows to each kernel's best-mapping front
        (``analysis.pareto.fold_segments`` over the MappingSet's
        ``kernel_of``).  Candidate flat indices keep their candidate-lane
        coordinates, so the winning mapping id is
        ``mappings.mapping_of[idx // (H*D)]``."""
        if self.mappings is None or self.reduce is None:
            raise ValueError(
                "stitch_folded needs a mapping campaign (mappings=) "
                "with an on-device reduction (reduce=)")
        part = self.stitch(require_complete=require_complete)
        return _pareto.fold_segments(self.reduce, part,
                                     self.mappings.kernel_of,
                                     self.mappings.n_kernels)

    def run(self) -> Tuple[Union[SweepResult, _pareto.ReducedResult],
                           RunnerReport]:
        """Execute every pending unit (resuming from checkpoints), wait
        for the last async save, and stitch."""
        t0 = self.clock()
        for k in self.pending_units():
            self.run_unit(k)
        if self.mgr is not None:
            self.mgr.wait()
        self.report.wall_s = self.clock() - t0
        return self.stitch(require_complete=False), self.report


# -- CLI (subprocess target of kill-and-resume drills) -----------------------

def main(argv=None):
    ap = argparse.ArgumentParser(
        description="resumable checkpointed DSE sweep (service runner)")
    ap.add_argument("--kernels", default="bitcnt,crc32",
                    help="comma list: bitcnt,crc32,susan,sha (small sizes)")
    ap.add_argument("--topos", default="baseline,c_interleaved")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain version on the host; "
                         "default: the CUDA device")
    ap.add_argument("--unit-size", type=int, default=4)
    ap.add_argument("--max-steps", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--reduce", default=None,
                    help="on-device reduction spec, e.g. 'topk:energy_pj:4'"
                         " or 'pareto:latency_cc,energy_pj:8' (see "
                         "analysis.pareto.spec_from_str)")
    ap.add_argument("--out", default=None, help=".npz of the SweepResult")
    ap.add_argument("--report-out", default=None, help="report JSON path")
    args = ap.parse_args(argv)

    from ..apps import mibench
    from ..core.characterization import default_profile
    from ..core.hwconfig import TOPOLOGIES
    from ..runtime.faults import FaultPlan

    dev = resolve_device(args.device)
    small = {"bitcnt": lambda: mibench.bitcnt(n_words=16),
             "crc32": lambda: mibench.crc32(n_words=3),
             "susan": lambda: mibench.susan_thresh(n_pixels=16),
             "sha": lambda: mibench.sha_mix(rounds=8)}
    ks = [small[n.strip()]() for n in args.kernels.split(",")]
    hws = [TOPOLOGIES[t.strip()]() for t in args.topos.split(",")]
    mems = np.stack([k.mem_init for k in ks])

    fault_plan = FaultPlan.from_env()
    injector = FaultInjector(fault_plan) if fault_plan is not None else None
    red = _pareto.spec_from_str(args.reduce) if args.reduce else None
    runner = ResumableSweepRunner(
        programs=[k.program for k in ks], profile=default_profile(device=dev),
        hw_configs=hws, mem_images=mems, ckpt_dir=args.ckpt_dir,
        unit_size=args.unit_size, max_steps=args.max_steps, device=dev,
        injector=injector, reduce=red)
    res, report = runner.run()
    if args.out:
        fields = _pareto.REDUCED_FIELDS if red is not None \
            else RESULT_FIELDS
        np.savez(args.out, **{f: _numpy(getattr(res, f)) for f in fields})
    if args.report_out:
        Path(args.report_out).write_text(json.dumps(report.to_dict()))
    print(f"[sweep-runner] B={runner.B} lanes in {report.units_total} "
          f"units on {runner.stage.name}: run {report.units_run}, resumed "
          f"{report.units_resumed}, replans {len(report.replans)}, wall "
          f"{report.wall_s:.2f}s")
    return res, report


if __name__ == "__main__":
    main()
