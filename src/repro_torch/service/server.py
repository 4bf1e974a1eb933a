"""Minimal DSE-sweep service over the resumable runner.

The serving problem for sweeps mirrors the LLM one (``launch/serve.py``):
many small requests, one expensive compiled engine, so throughput comes
from batching strangers into shared device work.  The same slot-based
continuous-batching pattern applies:

  * **bounded admission queue with backpressure**: ``submit`` refuses
    (``ServiceOverloaded``) past ``queue_max`` instead of buffering
    unboundedly -- the caller sheds load, the service never OOMs.
  * **request packing**: queued requests with a compatible shape are
    packed into ONE merged grid (``pack_programs`` NOP-pads their
    kernels to a common table shape, images are concatenated and lanes
    gather by index), so one ``ResumableSweepRunner`` -- one compiled
    executable -- serves all of them.  Each request owns a contiguous
    lane span of the merged grid.
  * **length-bucketed packing**: a merged grid runs every lane to the
    convoy of its longest kernel, so a 3-instruction request packed
    with a 300-instruction one pays 100x padding waste.  ``_admit``
    therefore buckets the FIFO window by each request's longest kernel
    (``program.bucket_boundaries``, up to ``max_buckets`` groups) and
    packs only the oldest request's bucket into the slot; the other
    buckets stay queued (FIFO order preserved) and fill the next free
    slots.  Compiled engines grow by at most the bucket count.
  * **slots**: up to ``slots`` merged campaigns are in flight; ``step``
    advances each by one work unit (continuous batching at unit
    granularity).  A finished campaign frees its slot and the next
    queued pack is admitted.
  * **per-request deadlines**: an expired request's not-yet-run units
    are skipped (its lanes stitch as zeros, ``expired`` is flagged);
    units already computed are still delivered -- partial results beat
    no results for DSE.
  * **streamed partials**: every completed unit is pushed to the owning
    requests' ``on_partial`` callbacks in request-local lane
    coordinates, so a long campaign renders its Pareto front
    incrementally.
  * **reduced requests**: a request carrying ``reduce=`` (an
    ``analysis.pareto`` spec) gets its answer as compacted per-program
    candidate sets -- ``(G_r, K)`` rows with candidate indices remapped
    to request-local lane coordinates -- and every streamed partial is
    the owning unit's front for that request's programs: the client
    folds partials with ``merge_reduced`` and ends at exactly the
    monolithic answer.  Only same-``reduce`` requests pack into one
    slot (the merged campaign runs ONE fused reduction), and the
    device->host bytes per unit are O(G*K), not the unit's lane count.

  * **mapping-search campaigns**: a request carrying ``mappings=`` (a
    ``core.program.MappingSet``) has its K candidate schedules per
    kernel expanded onto the program axis at admission -- candidates
    pack, bucket, and record trip-count history exactly like ordinary
    kernels -- and a reduced mapping request's answer (and every
    streamed partial) is folded back to *per-kernel* winner rows in
    request-local coordinates (``analysis.pareto.fold_segments``), so
    a mapping search over the service ships back one front per kernel,
    not per candidate.

All fault-tolerance (checkpoint/resume, retry, fleet monitoring) is
inherited from the runner underneath.  Every slot runs on the service's
device: the CUDA kernel on the card, its plain version only when the
caller named the CPU.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..analysis import pareto as _pareto
from ..core.autotune import AUTO, DEFAULT_MAX_BUCKETS, is_auto
from ..core.characterization import Profile
from ..core.dse import GridPlan
from ..core.hwconfig import HwConfig, stack_configs
from ..core.memory import DEFAULT_MAX_BANKS, scoreboard_bound
from ..core.program import MappingSet, bucket_boundaries, pack_programs
from ..device import DeviceLike, as_int32, resolve_device
from .runner import (RESULT_FIELDS, ResumableSweepRunner, RetryPolicy,
                     _numpy)


class ServiceOverloaded(RuntimeError):
    """Admission queue is full -- shed load upstream and retry later."""


@dataclasses.dataclass
class SweepRequest:
    """One client's (programs x hw x images) sub-grid.

    A mapping-search campaign passes ``mappings=`` (a
    ``core.program.MappingSet``) instead of ``programs``: the candidate
    schedules are expanded onto the program axis at admission (each
    candidate is an ordinary lane segment of the merged grid -- packing,
    bucketing, and trip-count history all see plain programs), and a
    *reduced* mapping request's answer is folded back to per-kernel
    winners in request-local coordinates: ``arrays`` has one row per
    kernel, and a candidate index ``idx`` decodes as mapping
    ``mappings.mapping_of[idx // (H*D)]`` at hw/image ``divmod(idx %
    (H*D), D)``.  Streamed partials are folded the same way, so clients
    keep folding with ``merge_reduced`` exactly as before.  An
    *unreduced* mapping request gets the full per-candidate lane
    arrays (candidate-major)."""
    programs: Optional[Sequence] = None
    hw_configs: Sequence = ()
    mem_images: np.ndarray = None              # (D, mem_size) int32
    deadline_s: Optional[float] = None         # relative to submission
    on_partial: Optional[Callable] = None      # (rid, lo, hi, {field: arr})
    # on-device reduction spec: the request's answer (and each streamed
    # partial) is a compacted per-program candidate set instead of the
    # full lane arrays; candidate indices are request-local lane coords
    reduce: Optional[_pareto.Reduction] = None
    # candidate-mapping campaign: expanded to programs at construction
    mappings: Optional[MappingSet] = None
    # filled in by the service:
    rid: int = -1
    submitted_at: float = 0.0

    def __post_init__(self):
        if self.mappings is not None:
            if self.programs:
                raise ValueError(
                    "SweepRequest: pass mappings= OR programs=, not "
                    "both")
            self.programs = list(self.mappings.programs)
        elif not self.programs:
            raise ValueError(
                "SweepRequest: needs programs= or mappings=")

    @property
    def n_lanes(self) -> int:
        return (len(list(self.programs)) * len(self.hw_configs)
                * int(self.mem_images.shape[0]))


@dataclasses.dataclass
class RequestResult:
    """Final per-request answer: this request's lane span of the merged
    grid, stitched (skipped units are zero) plus delivery metadata."""
    rid: int
    # request-local (n_lanes,) lane arrays; for a reduced request, the
    # ReducedResult fields instead -- (G_r, K) candidates per program,
    # indices in request-local lane coordinates
    arrays: Dict[str, np.ndarray]
    expired: bool
    skipped_lanes: int


class _Slot:
    """One in-flight merged campaign: the runner plus the request
    boundary map needed to route unit results back to owners."""

    def __init__(self, runner: ResumableSweepRunner,
                 members: List[Tuple[SweepRequest, int, int]]):
        self.runner = runner
        self.members = members                 # (request, lane lo, lane hi)
        self.expired: set = set()              # rids past deadline
        # program-row spans per member: the merged plan concatenates
        # each request's programs in order, so request r owns segment
        # rows [plo, phi) of any reduced result
        self.prog_spans: List[Tuple[int, int]] = []
        off = 0
        for r, _, _ in members:
            g = len(list(r.programs))
            self.prog_spans.append((off, off + g))
            off += g

    def requests(self) -> List[SweepRequest]:
        return [r for r, _, _ in self.members]


def _merge_plans(requests: Sequence[SweepRequest],
                 device: torch.device) -> Tuple[
        GridPlan, List[Tuple[SweepRequest, int, int]]]:
    """Pack several requests' grids into one ``GridPlan`` on ``device``.

    Programs are NOP-padded to a common table shape, images concatenated
    and put on the device once; every lane gathers its image and program
    by index, so the merged grid is just concatenated index rows --
    request r's lanes are the contiguous span [lo_r, hi_r) and its
    numbers are bit-identical to a solo run (lanes are independent)."""
    all_programs = list(itertools.chain.from_iterable(
        list(r.programs) for r in requests))
    batch = pack_programs(all_programs)
    images = np.concatenate([np.asarray(r.mem_images) for r in requests])

    img_idx, prog_idx, hw_parts, members = [], [], [], []
    prog_off = img_off = lane_off = 0
    for r in requests:
        G = len(list(r.programs))
        H, D = len(r.hw_configs), int(r.mem_images.shape[0])
        img_idx.append(np.tile(np.arange(D, dtype=np.int32), G * H)
                       + img_off)
        prog_idx.append(np.repeat(np.arange(G, dtype=np.int32), H * D)
                        + prog_off)
        hw_parts.append(stack_configs(list(r.hw_configs)).map(
            lambda x: x.to(device).repeat_interleave(D).repeat(G)))
        n = G * H * D
        members.append((r, lane_off, lane_off + n))
        prog_off, img_off, lane_off = prog_off + G, img_off + D, \
            lane_off + n
    hw_grid = HwConfig(**{f: torch.cat([getattr(p, f) for p in hw_parts])
                          for f in HwConfig.FIELDS})
    n_banks_req = max(int(c.n_banks) for r in requests
                      for c in r.hw_configs)
    max_banks = scoreboard_bound(max(n_banks_req, DEFAULT_MAX_BANKS))
    plan = GridPlan(batch, as_int32(images, device),
                    np.concatenate(img_idx), np.concatenate(prog_idx),
                    hw_grid, max_banks)
    return plan, members


def _request_rows(arrays: Dict[str, np.ndarray], plo: int, phi: int,
                  lane_lo: int) -> Dict[str, np.ndarray]:
    """Slice one request's program rows out of a merged-grid reduced
    result and remap candidate indices from merged-plan flat lanes to
    request-local lane coordinates (a request's lanes are the
    contiguous span starting at ``lane_lo``, program-major -- the same
    layout a solo ``dse.sweep`` of that request would use)."""
    out = {f: np.asarray(arrays[f])[plo:phi].copy()
           for f in _pareto.REDUCED_FIELDS}
    idx = out["indices"]
    idx[idx >= 0] -= lane_lo
    return out


def _fold_request(spec: _pareto.Reduction,
                  req_arrays: Dict[str, np.ndarray],
                  mappings: MappingSet) -> Dict[str, np.ndarray]:
    """Fold a mapping request's per-candidate reduced rows (already in
    request-local coordinates) into per-kernel winner rows via the
    set's ``kernel_of`` segment map.  Indices keep their request-local
    candidate-lane values, so mapping/hw/image coordinates stay
    decodable (see ``SweepRequest``)."""
    part = _pareto.ReducedResult(
        **{f: req_arrays[f] for f in _pareto.REDUCED_FIELDS})
    folded = _pareto.fold_segments(spec, part, mappings.kernel_of,
                                   mappings.n_kernels)
    return {f: np.asarray(getattr(folded, f))
            for f in _pareto.REDUCED_FIELDS}


class SweepService:
    """Bounded-queue sweep server: pack, execute in units, stream."""

    def __init__(self, profile: Profile, *, slots: int = 2,
                 queue_max: int = 16, pack_max_lanes: int = 256,
                 unit_size: int = 8, max_steps: int = 2048,
                 mem_size: int = 4096, device: DeviceLike = None,
                 max_buckets=AUTO,
                 retry: Optional[RetryPolicy] = None,
                 clock: Callable[[], float] = time.monotonic,
                 runner_kw: Optional[dict] = None,
                 steps_history_max: int = 4096,
                 ckpt_root: Optional[str] = None):
        self.profile = profile
        self.slots = slots
        self.queue_max = queue_max
        self.pack_max_lanes = pack_max_lanes
        self.unit_size = unit_size
        self.max_steps = max_steps
        self.mem_size = mem_size
        self.device = resolve_device(device)
        # bucket count of length-bucketed admission; AUTO = the static
        # default (the admission window's length mix is not a stable
        # shape class, so no per-shape cache lookup here)
        self.max_buckets = DEFAULT_MAX_BUCKETS if is_auto(max_buckets) \
            else max(1, int(max_buckets))
        self.retry = retry
        self.clock = clock
        self.runner_kw = dict(runner_kw or {})
        self.queue: deque = deque()
        self._slots: List[Optional[_Slot]] = [None] * slots
        self.completed: Dict[int, RequestResult] = {}
        self._next_rid = 0
        # admission audit trail: one record per packed slot, for tests
        # and ops visibility ({rids, t_max, window_tmaxes, bucket_by},
        # and resumed_units with a ckpt_root)
        self.admission_log: List[dict] = []
        # per-kernel observed ``steps_executed`` maxima (keyed by program
        # name), updated as campaigns finish.  Static length is only a
        # proxy for convoy cost -- a data-dependent tight loop makes a
        # short kernel run long -- so once every kernel in an admission
        # window has history, ``_admit`` buckets by how long kernels
        # actually RAN (``bucket_programs(observed_steps=...)``) instead
        # of their instruction count.  LRU-bounded: mapping campaigns
        # mint fresh ``#m`` candidate names every search round, so an
        # unbounded history leaks in a long-lived service -- entries
        # past ``steps_history_max`` evict least-recently-touched first
        # (both reads in ``_admit`` and writes refresh recency).
        self.steps_history: "OrderedDict[str, int]" = OrderedDict()
        self.steps_history_max = max(1, int(steps_history_max))
        # when set, every admitted slot gets a checkpoint directory
        # keyed by its campaign fingerprint, so an identical
        # re-submission after a service restart resumes completed units
        # instead of recomputing them (transport drain/restart path)
        self.ckpt_root = ckpt_root

    # -- admission ----------------------------------------------------------
    def submit(self, request: SweepRequest) -> int:
        """Enqueue; raises ``ServiceOverloaded`` when the queue is full
        (backpressure -- the caller retries, the service stays bounded)."""
        if len(self.queue) >= self.queue_max:
            raise ServiceOverloaded(
                f"admission queue full ({self.queue_max} requests); "
                f"retry after draining")
        if int(request.mem_images.shape[1]) != self.mem_size:
            raise ValueError(
                f"request image width {request.mem_images.shape[1]} != "
                f"service mem_size {self.mem_size}")
        request.rid = self._next_rid
        self._next_rid += 1
        request.submitted_at = self.clock()
        self.queue.append(request)
        return request.rid

    def _admit(self):
        """Fill free slots: greedily pack queued requests (FIFO) into a
        merged grid up to ``pack_max_lanes`` lanes per slot, then keep
        only the oldest request's *length bucket* -- requests whose
        longest kernel would convoy (or be convoyed by) the rest go back
        to the queue front, FIFO order preserved, and fill later slots."""
        for si in range(self.slots):
            if self._slots[si] is not None or not self.queue:
                continue
            pack, lanes = [], 0
            while self.queue:
                n = self.queue[0].n_lanes
                if pack and lanes + n > self.pack_max_lanes:
                    break
                # a merged campaign runs ONE fused reduction: only
                # same-reduce requests share a slot (frozen dataclass
                # equality; differently-reduced/unreduced requests stay
                # queued, FIFO preserved, and fill the next free slot)
                if pack and self.queue[0].reduce != pack[0].reduce:
                    break
                pack.append(self.queue.popleft())
                lanes += n
            tmaxes = [max(p.n_instrs for p in list(r.programs))
                      for r in pack]
            # trip-count-aware bucketing: when every kernel in the window
            # has observed-steps history, group requests by how long they
            # actually run, not by static length (equal-length kernels
            # with divergent trip counts would otherwise convoy)
            hist = self.steps_history
            by_steps = all(p.name in hist
                           for r in pack for p in list(r.programs))
            keys = [max(hist[p.name] for p in list(r.programs))
                    for r in pack] if by_steps else tmaxes
            if by_steps:                      # reads refresh LRU recency
                for r in pack:
                    for p in list(r.programs):
                        hist.move_to_end(p.name)
            if len(pack) > 1 and self.max_buckets > 1:
                groups = bucket_boundaries(keys, self.max_buckets)
                keep = next(set(g) for g in groups if 0 in g)
                rest = [r for i, r in enumerate(pack) if i not in keep]
                pack = [r for i, r in enumerate(pack) if i in keep]
                for r in reversed(rest):
                    self.queue.appendleft(r)
            plan, members = _merge_plans(pack, self.device)
            self.admission_log.append({
                "rids": [r.rid for r in pack],
                "t_max": int(plan.batch.t_max),
                "window_tmaxes": [int(t) for t in tmaxes],
                "bucket_by": "observed_steps" if by_steps else "length"})
            runner = ResumableSweepRunner(
                plan=plan, profile=self.profile, unit_size=self.unit_size,
                max_steps=self.max_steps, mem_size=self.mem_size,
                retry=self.retry,
                reduce=pack[0].reduce, **self.runner_kw)
            slot = _Slot(runner, members)
            self._slots[si] = slot
            if self.ckpt_root:
                # fingerprint-keyed directory: an identical re-submission
                # (post-restart) resumes its completed units; a different
                # campaign lands in a different directory by construction
                runner.attach_checkpoints(os.path.join(
                    self.ckpt_root, runner.fingerprint[:24]))
                self.admission_log[-1]["resumed_units"] = \
                    runner.report.units_resumed
                # resumed units never pass through run_unit, so their
                # partials must be replayed here or a streaming client
                # would fold an incomplete set
                for k in sorted(runner._results):
                    self._deliver_partial(slot, *runner._unit_range(k),
                                          runner._results[k])

    # -- execution ----------------------------------------------------------
    def _expire(self, slot: _Slot):
        """Skip the remaining units of requests past their deadline --
        only units *wholly owned* by expired requests are skipped, so a
        shared boundary unit still serves its live co-tenants."""
        now = self.clock()
        for r, lo, hi in slot.members:
            if (r.deadline_s is not None and r.rid not in slot.expired
                    and now - r.submitted_at > r.deadline_s):
                slot.expired.add(r.rid)
        if not slot.expired:
            return
        spans = [(lo, hi) for r, lo, hi in slot.members
                 if r.rid in slot.expired]
        for k in slot.runner.pending_units():
            ulo, uhi = slot.runner._unit_range(k)
            if any(lo <= ulo and uhi <= hi for lo, hi in spans):
                slot.runner.mark_skipped(k)

    def _deliver_partial(self, slot: _Slot, ulo: int, uhi: int,
                         res_np: Dict[str, np.ndarray]):
        red = slot.runner.reduce
        for (r, lo, hi), (plo, phi) in zip(slot.members, slot.prog_spans):
            if r.on_partial is None:
                continue
            a, b = max(lo, ulo), min(hi, uhi)
            if a < b:
                if red is not None:
                    # the unit's compacted front, this request's
                    # program rows only, indices request-local: the
                    # client folds partials with ``merge_reduced``.
                    # Mapping campaigns fold candidates -> kernels
                    # first, so every partial already has per-kernel
                    # rows (merging folded parts stays exact for TopK)
                    part = _request_rows(res_np, plo, phi, lo)
                    if r.mappings is not None:
                        part = _fold_request(red, part, r.mappings)
                else:
                    part = {f: res_np[f][a - ulo:b - ulo]
                            for f in RESULT_FIELDS}
                r.on_partial(r.rid, a - lo, b - lo, part)

    def _record_steps(self, r: SweepRequest, req_arrays: Dict[str, np.ndarray],
                      *, reduced: bool):
        """Fold a finished request's observed ``steps_executed`` into the
        per-kernel history that drives trip-count-aware admission
        bucketing.  A request's lanes are program-major, so program ``j``
        owns ``n_lanes/G`` contiguous lanes; a reduced request only
        reports its candidates' step counts (a lower bound on the true
        per-kernel maximum -- still a far better convoy predictor than
        static length).  Skipped/expired lanes are zero and never shrink
        recorded history (max-fold, zero-guarded)."""
        progs = list(r.programs)
        st = np.asarray(req_arrays["steps_executed"])
        if reduced:
            per_prog = np.where(np.asarray(req_arrays["indices"]) >= 0,
                                st, 0).max(axis=1, initial=0)
        else:
            per_prog = st.reshape(len(progs), -1).max(axis=1, initial=0)
        for p, s in zip(progs, per_prog):
            if s > 0:
                self.steps_history[p.name] = max(
                    self.steps_history.get(p.name, 0), int(s))
                self.steps_history.move_to_end(p.name)
        while len(self.steps_history) > self.steps_history_max:
            self.steps_history.popitem(last=False)

    def _finish(self, si: int):
        slot = self._slots[si]
        red = slot.runner.reduce
        full = slot.runner.stitch(require_complete=False)
        fields = RESULT_FIELDS if red is None else _pareto.REDUCED_FIELDS
        arrays = {f: _numpy(getattr(full, f)) for f in fields}
        skipped = set(slot.runner._skipped)
        for (r, lo, hi), (plo, phi) in zip(slot.members, slot.prog_spans):
            sk = sum(max(0, min(hi, uhi) - max(lo, ulo))
                     for k in skipped
                     for ulo, uhi in [slot.runner._unit_range(k)])
            if red is not None:
                req_arrays = _request_rows(arrays, plo, phi, lo)
            else:
                req_arrays = {f: arrays[f][lo:hi] for f in RESULT_FIELDS}
            # trip-count history records per-CANDIDATE rows (aligned
            # with r.programs), so it must run before any mapping fold
            self._record_steps(r, req_arrays, reduced=red is not None)
            if red is not None and r.mappings is not None:
                req_arrays = _fold_request(red, req_arrays, r.mappings)
            self.completed[r.rid] = RequestResult(
                rid=r.rid, arrays=req_arrays,
                expired=r.rid in slot.expired, skipped_lanes=sk)
        self._slots[si] = None

    def step(self) -> bool:
        """Admit + advance every active slot by one work unit; returns
        True while anything is queued or in flight."""
        self._admit()
        busy = False
        for si in range(self.slots):
            slot = self._slots[si]
            if slot is None:
                continue
            self._expire(slot)
            pending = slot.runner.pending_units()
            if not pending:
                self._finish(si)
                continue
            busy = True
            k = pending[0]
            _, res_np = slot.runner.run_unit(k)
            self._deliver_partial(slot, *slot.runner._unit_range(k),
                                  res_np)
            if not slot.runner.pending_units():
                self._finish(si)
        return busy or bool(self.queue) \
            or any(s is not None for s in self._slots)

    def drain(self) -> Dict[int, RequestResult]:
        """Run to completion and return every request's result."""
        while self.step():
            pass
        return dict(self.completed)
