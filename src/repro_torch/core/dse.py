"""Design-space exploration: the (program x hardware x data) sweep.

The paper's value proposition is instantaneous comparative analysis of
(kernel mapping x hardware topology) points.  ``sweep`` flattens all
three axes to ``B = G*H*D`` design points ("lanes"), row
``(g*H + h)*D + d`` pairing program g with hardware config h and memory
image d, and runs every lane through the cycle-level simulator with the
fused case-(vi) energy estimate.  The lanes run on the fused sweep
engine (``kernels.cgra_sweep``): its CUDA kernel on the GPU, its plain
PyTorch version on the CPU.

Programs are packed to a common padded shape (``program.pack_programs``)
and each lane fetches its own kernel's rows from the fused row table at
``prog_idx * T_max + pc``.  With ``max_buckets > 1`` the kernels are
first split into length buckets (``program.bucket_programs``) so short
kernels stop running alongside the longest one; results are scattered
back to the canonical row order and equal the unbucketed sweep.

``sweep(reduce=...)`` reduces each bucket's lanes on the device
(``analysis.pareto``: top-k or Pareto front per program) and ships only
the ``(G, K)`` candidate sets to the host; ``sweep(mappings=...)``
sweeps a mapper's candidate set as the program axis; ``search_mappings``
closes the loop (sweep candidates, keep the best, mutate, re-sweep).

``sweep(mesh=...)``, ``make_bucketed_sweep_fn(mesh=...)`` and
``make_grid_fn(mesh=...)`` split the flat lane axis over the entries of a
``parallel.Mesh``: the grid is padded to a multiple of the entry count,
the plan is placed once on each distinct device, every shard's lanes run
on its device (``sweep_shards``: chunks in rounds across shards), and
the ``(B,)`` fields are gathered on the mesh's first device -- or, with
``reduce``, each shard reduces itself on its device and only the
shards' ``(G, K)`` candidate sets reach the host merge.  One process
drives every device; lanes are independent, so a sharded sweep equals
the unsharded one bit for bit.

``chunk_steps``, ``blk_b`` and ``max_buckets`` of ``sweep``,
``make_bucketed_sweep_fn`` and ``search_mappings`` default to
``autotune.AUTO``: they resolve through the per-shape-class autotune
cache (``core.autotune``), else the static defaults 64 / 32 / 4; none of
them changes a result.  The reference's ``backend=`` and ``interpret=``
have no counterpart: there is one engine, the CUDA kernel, or its plain
version on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from .. import spans
from ..analysis import pareto as _pareto
from ..device import DeviceLike, as_int32, resolve_device, to_device, upload
from ..kernels.cgra_sweep.ops import sweep_engine, sweep_shards
from ..kernels.cgra_sweep.ref import LaneState, SweepTables, init_lanes
from ..parallel.sharding import (Mesh, flat_shards, mesh_device, pad_batch,
                                 padded_len)
from .autotune import (AUTO, ShapeClass, TunedConfig, autotune_enabled,
                       default_cache, tune_sweep)
from .characterization import Profile
from .hwconfig import FLOAT_FIELDS, HwConfig, hw_table
from .memory import (DEFAULT_MAX_BANKS, scoreboard_bound,
                     validate_bank_bound)
from .program import (MappingSet, Program, ProgramBatch, as_program_batch,
                      batch_tables, bucket_programs, fused_rows)

Programs = Union[Program, ProgramBatch, Sequence[Program]]


class SweepResult(NamedTuple):
    latency_cc: torch.Tensor      # (B,) int32
    energy_pj: torch.Tensor       # (B,) float32
    power_mw: torch.Tensor        # (B,) float32
    checksum: torch.Tensor        # (B,) int32 (output-memory hash, validity)
    steps_executed: torch.Tensor  # (B,) int32 instructions actually run


def sweep_tables(batch: ProgramBatch, profile: Profile,
                 device: torch.device) -> SweepTables:
    """Device operands of a packed batch and its profile."""
    f32 = lambda x: to_device(np.asarray(x, np.float32), device)
    with spans.span("dse.plan.tables"):
        return SweepTables(
            tab=to_device(fused_rows(batch_tables(batch)), device),
            plen=as_int32(batch.n_instrs, device), t_max=batch.t_max,
            p_dec=f32(profile.p_dec), p_act=f32(profile.p_act),
            e_src=f32(profile.e_src), p_idle=float(profile.p_idle),
            e_sw_op=float(profile.e_sw_op),
            e_sw_mux=float(profile.e_sw_mux),
            mulzero=float(profile.mulzero))


def lane_results(st: LaneState, profile: Profile) -> SweepResult:
    """The five (B,) result fields of finished lanes (the engine's or
    its plain version's state)."""
    # the clock period comes from the characterization profile, as in
    # the reference (hw.t_clk_ns is not consulted)
    t_clk = float(np.float32(profile.t_clk_ns))
    lat = st.t_cc
    weights = torch.arange(st.mem.shape[1], dtype=torch.int64,
                           device=st.mem.device) | 1
    # int32 wraparound of the reference's sum, made explicit
    checksum = ((st.mem.to(torch.int64) * weights).sum(1)
                & 0xFFFFFFFF).to(torch.int32)
    return SweepResult(lat, st.e_acc * t_clk * 1e-3,
                       st.e_acc / lat.clamp(min=1) * 1e-3, checksum,
                       st.n_exec)


def _lanes_runner(batch: ProgramBatch, profile: Profile, *, rows: int,
                  cols: int, mem_size: int, max_steps: int,
                  chunk_steps: Optional[int], blk_b: int,
                  device: torch.device):
    """``run(mem (B, M) int32, hw (B,) fields, prog_idx (B,))``.

    ``mem`` is taken over: the engine updates the images in place, so a
    caller that built it (``make_grid_fn``) pays no copy."""
    if batch.n_pes != rows * cols:
        raise ValueError(
            f"program batch {batch.names!r}: n_pes={batch.n_pes} does not "
            f"match the {rows}x{cols} array")
    tables = sweep_tables(batch, profile, device)

    def run(mem: torch.Tensor, hw: HwConfig, prog_idx) -> SweepResult:
        if mem.dim() != 2 or mem.shape[1] != mem_size:
            raise ValueError(f"memory images must be (B, {mem_size}), got "
                             f"{tuple(mem.shape)}")
        B = mem.shape[0]
        hw = hw.map(lambda v: v.to(device).expand(B).contiguous())
        st = init_lanes(mem, batch.n_pes)
        sweep_engine(tables, hw, as_int32(prog_idx, device), st, rows=rows,
                     cols=cols, max_steps=max_steps, chunk_steps=chunk_steps,
                     blk_b=blk_b)
        return lane_results(st, profile)

    return run


def _with_reduce(fn, reduce: _pareto.Reduction, n_programs: int,
                 device: torch.device):
    """``fn(*args, prog_idx) -> SweepResult`` becomes ``fn(*args,
    prog_idx, lane_idx) -> ReducedResult``, reduced on ``device``."""
    red = _pareto.make_device_reducer(reduce, n_programs)

    def rfn(*args):
        *head, prog_idx, lane_idx = args
        res = fn(*head, prog_idx)
        with spans.span("reduce.device", device=device):
            return red(tuple(res), as_int32(prog_idx, device),
                       as_int32(lane_idx, device))

    return rfn


def make_sweep_fn(program: Programs, profile: Profile, *, rows: int = 4,
                  cols: int = 4, mem_size: int = 4096, max_steps: int = 2048,
                  chunk_steps: Optional[int] = 64, blk_b: int = 32,
                  max_banks: Optional[int] = None,
                  reduce: Optional[_pareto.Reduction] = None,
                  device: DeviceLike = None):
    """Build the fused simulate+estimate sweep function.

    program: a single ``Program`` -> ``fn(mem_init (B, M), hw) ->
    SweepResult``; a sequence of programs or a ``ProgramBatch`` ->
    ``fn(mem_init, hw, prog_idx (B,))``, each lane running its own
    program.  ``hw`` holds (B,) fields or one configuration for all lanes.
    The memory images are copied before the engine updates them.

    chunk_steps: instructions per engine chunk; the sweep stops issuing
    chunks once every lane is done (``None``: one chunk of max_steps).
    blk_b: lanes per CUDA block.  Neither changes a result.

    max_banks: bank-scoreboard bound (default 16); configs with more
    banks raise, as in the reference.  ``sweep()`` derives it from its
    configs.

    reduce: an ``analysis.pareto`` spec (``TopK`` / ``ParetoFront``).
    Batch API only; the signature becomes ``fn(mem_init, hw, prog_idx,
    lane_idx) -> ReducedResult`` of ``(G, K)`` tensors on the device,
    reduced per program where the lanes ran.  ``lane_idx`` carries each
    lane's flat grid index; ``-1`` marks a lane that must never become a
    candidate."""
    if reduce is not None and isinstance(program, Program):
        raise ValueError("reduce= needs the batch API; pass a sequence "
                         "of programs or a ProgramBatch")
    dev = resolve_device(device)
    max_banks = max_banks or DEFAULT_MAX_BANKS
    batch = as_program_batch(program)
    run = _lanes_runner(batch, profile, rows=rows, cols=cols,
                        mem_size=mem_size, max_steps=max_steps,
                        chunk_steps=chunk_steps, blk_b=blk_b, device=dev)

    def fn(mem_init, hw: HwConfig, prog_idx=None) -> SweepResult:
        validate_bank_bound(hw.n_banks, max_banks, where="dse.make_sweep_fn")
        mem = torch.as_tensor(mem_init, dtype=torch.int32, device=dev)
        if prog_idx is None:
            prog_idx = torch.zeros(mem.shape[0], dtype=torch.int32)
        return run(mem.clone(), hw, prog_idx)

    if isinstance(program, Program):
        return lambda mem_init, hw: fn(mem_init, hw)
    if reduce is not None:
        return _with_reduce(fn, reduce, batch.n_programs, dev)
    return lambda mem_init, hw, prog_idx: fn(mem_init, hw, prog_idx)


class GridPlan(NamedTuple):
    """The flattened (program x hardware x data) grid as data: packed
    program batch, the D distinct images on the device, and per-lane
    index / config rows (row ``(g*H + h)*D + d``)."""
    batch: ProgramBatch
    images: torch.Tensor       # (D, M) int32
    img_idx: np.ndarray        # (B,) int32 per-lane image row
    prog_idx: np.ndarray       # (B,) int32 per-lane program row
    hw_grid: HwConfig          # (B,) fields
    max_banks: int             # config-derived scoreboard bound

    @property
    def n_lanes(self) -> int:
        return int(self.img_idx.shape[0])


def plan_grid(program: Optional[Programs] = None,
              hw_configs: Sequence[HwConfig] = None,
              mem_images=None, *, programs: Optional[Sequence[Program]]
              = None, device: DeviceLike = None) -> GridPlan:
    """Flatten the grid to ``B = G*H*D`` index rows without tiling any
    image or table."""
    if programs is not None:
        if program is not None:
            raise TypeError("plan_grid(): pass either program or "
                            "programs=, not both")
        program = list(programs)
    return _plan_lanes(as_program_batch(program), hw_configs, mem_images,
                       resolve_device(device))[0]


def _plan_lanes(batch: ProgramBatch, hw_configs: Sequence[HwConfig],
                mem_images, dev: torch.device, group=None):
    """``(plan, lanes)``: the grid plan and the rows a grid fn takes for
    every lane, ``[img_idx, prog_idx]`` and with ``group`` (the batch's
    canonical program ids) ``lane_idx``, all int32 on ``dev``.

    The hardware table and ``group`` reach the device in one copy the
    host does not wait for (``device.upload``); every (B,) row of lane
    ``(g*H + h)*D + d`` is then built there: the fields by broadcasting
    the table over the (G, H, D) grid (config ``h = lane // D % H``),
    the index rows from ``arange(B)`` (``d = lane % D``, ``g = lane //
    (H*D)``, canonical index ``group[g]*H*D + lane % (H*D)``)."""
    G, H = batch.n_programs, len(hw_configs)
    images = as_int32(mem_images, dev)
    D = images.shape[0]
    B = G * H * D
    table = hw_table(hw_configs)
    n_banks_req = int(table[HwConfig.FIELDS.index("n_banks")].max())
    max_banks = scoreboard_bound(max(n_banks_req, DEFAULT_MAX_BANKS))
    host = table.ravel()
    if group is not None:
        host = np.concatenate([host, np.asarray(group, np.int32)])
    dtab = upload(host, dev)
    n = len(table)
    rows = dtab[:table.size].view(n, 1, H, 1).expand(n, G, H, D).reshape(
        n, B)
    hw_grid = HwConfig(**{f: rows[i].view(torch.float32)
                          if f in FLOAT_FIELDS else rows[i]
                          for i, f in enumerate(HwConfig.FIELDS)})
    img_idx = np.tile(np.arange(D, dtype=np.int32), G * H)
    prog_idx = np.repeat(np.arange(G, dtype=np.int32), H * D)
    plan = GridPlan(batch, images, img_idx, prog_idx, hw_grid, max_banks)
    lane = torch.arange(B, dtype=torch.int32, device=dev)
    lanes = [lane % D, lane // (H * D)]
    if group is not None:
        lanes.append(dtab[table.size:].index_select(0, lanes[1]) * (H * D)
                     + lane % (H * D))
    return plan, lanes


def make_grid_fn(plan: GridPlan, profile: Profile, *, max_steps: int = 2048,
                 mem_size: int = 4096, chunk_steps: Optional[int] = 64,
                 blk_b: int = 32,
                 reduce: Optional[_pareto.Reduction] = None,
                 mesh: Optional[Mesh] = None):
    """``fn(img_idx, hw_slice, prog_idx) -> SweepResult`` for any slice
    of the planned grid; lanes are independent, so a lane's result is the
    same in any slice.  Runs where the plan's images are.

    With ``reduce`` the signature gains a trailing ``lane_idx`` (flat grid
    index per lane, -1 for a padded lane) and the fn returns the slice's
    ``ReducedResult``, reduced on the device.

    With ``mesh`` the slice is split over the mesh's entries
    (``MeshGrid``): the plan is placed on each distinct device once,
    here, and each call pads the slice to a multiple of the entry count;
    the result is gathered on the mesh's first device, or, with
    ``reduce``, merged on the host from the shards' candidate sets."""
    if mesh is not None:
        return MeshGrid(plan, profile, mesh, max_steps=max_steps,
                        mem_size=mem_size, chunk_steps=chunk_steps,
                        blk_b=blk_b, reduce=reduce)
    dev = plan.images.device
    run = _lanes_runner(plan.batch, profile, rows=4, cols=4,
                        mem_size=mem_size, max_steps=max_steps,
                        chunk_steps=chunk_steps, blk_b=blk_b, device=dev)

    def grid_fn(idx, hw: HwConfig, gi) -> SweepResult:
        validate_bank_bound(hw.n_banks, plan.max_banks, where="dse.grid_fn")
        # the gathered images are a fresh tensor the engine may update
        return run(plan.images[as_int32(idx, dev).long()], hw, gi)

    if reduce is not None:
        return _with_reduce(grid_fn, reduce, plan.batch.n_programs, dev)
    return grid_fn


def _host_rows(x, dtype) -> np.ndarray:
    """A lane row (tensor or array) as host numpy of ``dtype``."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            spans.count("host_syncs")
        x = x.cpu().numpy()
    return np.asarray(x, dtype)


class MeshGrid:
    """A grid plan placed on every distinct device of a mesh.

    ``place(img_idx, hw, prog_idx[, lane_idx])`` pads a slice of the plan
    to a multiple of the mesh's entry count and puts each shard's rows on
    its device; ``run(placed)`` sweeps every shard (``sweep_shards``) and
    gathers the result.  Calling the object does both, so it is a grid fn
    with ``make_grid_fn``'s signature.  ``shard_launches`` counts the
    kernel launches of each shard across calls."""

    def __init__(self, plan: GridPlan, profile: Profile, mesh: Mesh, *,
                 max_steps: int, mem_size: int, chunk_steps: Optional[int],
                 blk_b: int, reduce: Optional[_pareto.Reduction] = None,
                 images: Optional[dict] = None):
        if plan.batch.n_pes != 16:
            raise ValueError(
                f"program batch {plan.batch.names!r}: n_pes="
                f"{plan.batch.n_pes} does not match the 4x4 array")
        if mesh.device_type != plan.images.device.type:
            raise ValueError(f"the plan's images lie on "
                             f"{plan.images.device}, the mesh on "
                             f"{mesh.device_type} devices")
        self.plan, self.profile, self.mesh = plan, profile, mesh
        self.first = mesh_device(mesh)
        self.reduce = reduce
        self.knobs = dict(rows=4, cols=4, max_steps=max_steps,
                          chunk_steps=chunk_steps, blk_b=blk_b)
        self.mem_size = mem_size
        self.images = images if images is not None else \
            {d: plan.images.to(d) for d in mesh.distinct()}
        self.tables = {d: sweep_tables(plan.batch, profile, d)
                       for d in mesh.distinct()}
        self.reducer = (None if reduce is None else
                        _pareto.make_device_reducer(reduce,
                                                    plan.batch.n_programs))
        self.shard_launches = [0] * mesh.devices.size

    def place(self, idx, hw: HwConfig, gi, lane=None):
        """The shards' operands on their devices: ``(n_lanes, [(device,
        img_idx, hw, prog_idx, lane_idx)])``."""
        validate_bank_bound(hw.n_banks, self.plan.max_banks,
                            where="dse.grid_fn")
        idx = _host_rows(idx, np.int64)
        B = len(idx)
        Bp = padded_len(B, self.mesh.devices.size)
        idx = pad_batch(idx, Bp)
        gi = pad_batch(_host_rows(gi, np.int32), Bp)
        hw = hw.map(lambda v: pad_batch(v.expand(B), Bp))
        if lane is not None:
            lane = pad_batch(_host_rows(lane, np.int32), Bp, fill=-1)
        shards = []
        for d, lo, hi in flat_shards(Bp, self.mesh):
            shards.append((d, to_device(idx[lo:hi], d),
                           hw.map(lambda v: to_device(v[lo:hi], d)
                                  .contiguous()),
                           as_int32(gi[lo:hi], d),
                           None if lane is None else as_int32(lane[lo:hi], d)))
        return B, shards

    def run(self, placed) -> Union[SweepResult, _pareto.ReducedResult]:
        B, shards = placed
        jobs = [(self.tables[d], hw, gi,
                 init_lanes(self.images[d][idx], self.plan.batch.n_pes))
                for d, idx, hw, gi, _ in shards]
        for job in jobs:
            if job[3].mem.shape[1] != self.mem_size:
                raise ValueError(f"memory images must be (B, "
                                 f"{self.mem_size}), got "
                                 f"{tuple(job[3].mem.shape)}")
        counts = sweep_shards(jobs, **self.knobs)
        self.shard_launches = [a + b for a, b in
                               zip(self.shard_launches, counts)]
        results = [lane_results(job[3], self.profile) for job in jobs]
        if self.reduce is not None:
            parts = []
            for res, (d, _, _, gi, lane) in zip(results, shards):
                with spans.span("reduce.device", device=d):
                    part = self.reducer(tuple(res), gi, lane)
                parts.append(_pareto._as_numpy(part))
            with spans.span("reduce.merge"):
                return _pareto.merge_reduced(self.reduce, parts)
        return SweepResult(*(
            torch.cat([f.to(self.first) for f in field])[:B]
            for field in zip(*results)))

    def __call__(self, idx, hw: HwConfig, gi, lane=None):
        if (lane is None) != (self.reduce is None):
            raise TypeError("a reduced grid fn takes lane_idx; an "
                            "unreduced one does not")
        return self.run(self.place(idx, hw, gi, lane))


def _scatter(parts, groups, block: int, n_programs: int,
             device: torch.device) -> SweepResult:
    """Per-bucket results back to the canonical row order: rows ``j *
    block`` of bucket ``bi`` belong to program ``groups[bi][j]``."""
    if len(parts) == 1:         # one bucket holds every program in order
        return parts[0]
    out = []
    for field in zip(*parts):
        full = torch.empty((n_programs * block,), dtype=field[0].dtype,
                           device=device)
        for group, part in zip(groups, field):
            for j, g in enumerate(group):
                full[g * block:(g + 1) * block] = \
                    part[j * block:(j + 1) * block]
        out.append(full)
    return SweepResult(*out)


def sweep(program: Optional[Programs] = None, profile: Profile = None,
          hw_configs: Sequence[HwConfig] = None, mem_images=None, *,
          programs: Optional[Sequence[Program]] = None,
          max_steps: int = 2048, mem_size: int = 4096,
          chunk_steps: Union[int, None, str] = AUTO,
          blk_b: Union[int, str] = AUTO,
          max_buckets: Union[int, str] = AUTO,
          autotune: Optional[bool] = None,
          reduce: Optional[_pareto.Reduction] = None,
          observed_steps: Optional[Sequence[int]] = None,
          mappings: Optional[MappingSet] = None,
          fold_mappings: bool = True, device: DeviceLike = None,
          mesh: Optional[Mesh] = None
          ) -> Union[SweepResult, _pareto.ReducedResult]:
    """Run the full (program x hw x data) grid.

    program/programs: a single ``Program``, a sequence of programs, or a
    ``ProgramBatch``.  mem_images: (D, mem_size).  Returns (B,) tensors
    on ``device`` in row order ``(g*H + h)*D + d``.

    chunk_steps / blk_b / max_buckets default to ``autotune.AUTO``: they
    resolve through the autotune cache for this sweep's shape class,
    else the static defaults (64 / 32 / 4); concrete values pin them
    (``chunk_steps=None`` is one chunk of max_steps).  With
    ``autotune=True`` (or ``REPRO_TORCH_AUTOTUNE=1``) an untuned
    multi-program shape is timed over the candidate grid first
    (``autotune.tune_sweep``) and the winner persisted.

    max_buckets > 1 splits a multi-kernel sweep into up to that many
    length buckets, each packed to its own ``t_max`` and run on its own;
    results are identical to the unbucketed sweep.  observed_steps:
    per-program observed ``steps_executed`` maxima from a prior run;
    when given, the buckets group kernels by trip count instead of
    static length (``program.bucket_programs``).  One call of a
    ``make_bucketed_sweep_fn`` plan.

    reduce: an ``analysis.pareto`` spec (``TopK(objective, k)`` /
    ``ParetoFront(axes, max_points)``).  Each bucket's lanes are reduced
    per program on the device and only the ``(G, K)`` candidate sets
    reach the host, where they merge (``merge_reduced``).  Returns a
    host numpy ``ReducedResult`` whose candidates carry their flat grid
    index ``(g*H + h)*D + d``, bit-identical to ``reduce_oracle`` over
    the unreduced sweep.

    mappings: a ``program.MappingSet`` -- the K candidate schedules per
    kernel flatten onto the program axis (B = K_total * H * D).  With
    ``reduce`` the per-candidate rows fold through the set's kernel map
    (``analysis.pareto.fold_segments``) into each kernel's best-mapping
    front; candidate flat indices stay in candidate-lane coordinates, so
    the winning mapping is ``mappings.mapping_of[idx // (H*D)]``.
    ``fold_mappings=False`` keeps the per-candidate rows.

    mesh: a ``parallel.Mesh``; the lanes split over its entries (see the
    module docstring) and the result is the unsharded one, on the mesh's
    first device.  ``device`` may then only name that engine.

    Runs on the CUDA device unless ``device`` (or ``mesh``) says
    otherwise."""
    if mappings is not None:
        if program is not None or programs is not None:
            raise TypeError(
                "sweep: pass mappings= OR program(s)=, not both")
        program = list(mappings.programs)
    elif programs is not None:
        if program is not None:
            raise TypeError("sweep(): pass either program or programs=, "
                            "not both")
        program = list(programs)
    res = make_bucketed_sweep_fn(
        program, profile, hw_configs, mem_images, max_steps=max_steps,
        mem_size=mem_size, chunk_steps=chunk_steps, blk_b=blk_b,
        max_buckets=max_buckets, autotune=autotune, reduce=reduce,
        observed_steps=observed_steps, device=device, mesh=mesh)()
    if mappings is not None and reduce is not None and fold_mappings:
        return _pareto.fold_segments(reduce, res, mappings.kernel_of,
                                     mappings.n_kernels)
    return res


def make_bucketed_sweep_fn(programs: Programs, profile: Profile,
                           hw_configs: Sequence[HwConfig], mem_images, *,
                           max_steps: int = 2048, mem_size: int = 4096,
                           chunk_steps: Union[int, None, str] = AUTO,
                           blk_b: Union[int, str] = AUTO,
                           max_buckets: Union[int, str] = AUTO,
                           autotune: Optional[bool] = None,
                           reduce: Optional[_pareto.Reduction] = None,
                           observed_steps: Optional[Sequence[int]] = None,
                           device: DeviceLike = None,
                           mesh: Optional[Mesh] = None):
    """Hold a bucketed packed plan: ``fn() -> SweepResult``.

    A loop that re-executes the same kernel set (a search round, a
    benchmark) builds the length buckets, their grid fns and the
    device-resident lane operands once here; each ``fn()`` runs the
    buckets and scatters lanes back to canonical ``(g*H + h)*D + d``
    order, as ``sweep()`` (one call of such a plan) returns them.
    ``fn.buckets`` exposes the length buckets, ``fn.cfg`` the
    resolved knobs (``autotune.TunedConfig``; ``cfg.source`` says where
    they came from) and ``fn.grids`` each bucket's ``MeshGrid`` (empty
    without a mesh).  The knobs resolve once, for the whole set's shape
    class, and every bucket runs with them: the combination
    ``tune_sweep`` timed.

    With ``reduce`` each bucket reduces itself on the device (its lane
    operands carry canonical flat indices, computed here once) and
    ``fn() -> ReducedResult`` merges the K-sized per-bucket candidate
    sets on the host.  ``observed_steps`` buckets by trip count instead
    of static length (see ``program.bucket_programs``).

    With ``mesh`` each bucket's lanes split over the mesh's entries, one
    bucket after another: the images are placed on each distinct device
    once and each bucket's shard operands once (``MeshGrid.place``)."""
    with spans.span("dse.plan"):
        dev = (resolve_device(device) if mesh is None
               else mesh_device(mesh, device))
        batch = as_program_batch(programs)
        images = as_int32(mem_images, dev)
        G, block = batch.n_programs, len(hw_configs) * images.shape[0]
        with spans.span("dse.plan.knobs"):
            cfg = _resolve_knobs(batch, hw_configs, images, dev,
                                 chunk_steps=chunk_steps, blk_b=blk_b,
                                 max_buckets=max_buckets, autotune=autotune,
                                 profile=profile, max_steps=max_steps,
                                 mem_size=mem_size, mesh=mesh)
        buckets = bucket_programs([batch.program(g) for g in range(G)],
                                  cfg.max_buckets if G > 1 else 1,
                                  observed_steps=observed_steps)
        placed_images = (None if mesh is None else
                         {d: images.to(d) for d in mesh.distinct()})
        bucket_fns, grids = [], []
        for group, b in zip(buckets.groups, buckets.batches):
            with spans.span("dse.plan.grid"):
                plan, lanes = _plan_lanes(
                    b, hw_configs, images, dev,
                    group=None if reduce is None or mesh else group)
                knobs = dict(max_steps=max_steps, mem_size=mem_size,
                             chunk_steps=cfg.chunk_steps, blk_b=cfg.blk_b,
                             reduce=reduce)
                if mesh is not None:
                    grid = MeshGrid(plan, profile, mesh,
                                    images=placed_images, **knobs)
                    grids.append(grid)
                    lane = None if reduce is None else np.concatenate(
                        [np.arange(g * block, (g + 1) * block,
                                   dtype=np.int32) for g in group])
                    placed = grid.place(plan.img_idx, plan.hw_grid,
                                        plan.prog_idx, lane)
                    bucket_fns.append((lambda grid=grid, placed=placed:
                                       grid.run(placed)))
                    continue
                img_idx, prog_idx, *lane = lanes
                f = make_grid_fn(plan, profile, **knobs)
                bucket_fns.append(lambda f=f, args=(img_idx, plan.hw_grid,
                                                    prog_idx, *lane):
                                  f(*args))

    if reduce is not None:
        def fn() -> _pareto.ReducedResult:
            with spans.span("dse.run"):
                parts = [_pareto._as_numpy(run()) for run in bucket_fns]
                with spans.span("reduce.merge"):
                    return _pareto.merge_reduced(reduce, [
                        _pareto.remap_segments(part, group,
                                               np.zeros(len(group)), G)
                        for group, part in zip(buckets.groups, parts)])
    else:
        def fn() -> SweepResult:
            with spans.span("dse.run"):
                return _scatter([run() for run in bucket_fns],
                                buckets.groups, block, G, dev)

    fn.buckets = buckets
    fn.cfg = cfg
    fn.grids = grids
    return fn


def _resolve_knobs(batch: ProgramBatch, hw_configs: Sequence[HwConfig],
                   images: torch.Tensor, device: torch.device, *,
                   chunk_steps, blk_b, max_buckets,
                   autotune: Optional[bool] = None, profile: Profile = None,
                   max_steps: int = 2048, mem_size: int = 4096,
                   mesh: Optional[Mesh] = None) -> TunedConfig:
    """The sweep's knobs for its shape class: explicit values win, AUTO
    ones come from the autotune cache, else the static defaults.  With
    tuning opted in (``autotune``, else ``REPRO_TORCH_AUTOTUNE``), an
    untuned multi-program shape is timed first and its winner used.  A
    sharded sweep's shape class counts the mesh's entries."""
    shape = ShapeClass(G=batch.n_programs, t_max=batch.t_max,
                       H=len(hw_configs), D=int(images.shape[0]),
                       device=device.type,
                       n_devices=1 if mesh is None else mesh.devices.size)
    cache = default_cache()
    cfg = cache.resolve(shape, blk_b=blk_b, chunk_steps=chunk_steps,
                        max_buckets=max_buckets)
    if (autotune_enabled(autotune) and cfg.source == "default"
            and batch.n_programs > 1):
        tune_sweep(batch, profile, hw_configs, images, max_steps=max_steps,
                   mem_size=mem_size, device=device, cache=cache, mesh=mesh)
        # the caller's pinned knobs still win over the timed winner
        cfg = dataclasses.replace(
            cache.resolve(shape, blk_b=blk_b, chunk_steps=chunk_steps,
                          max_buckets=max_buckets), source="tuned")
    return cfg


# ---------------------------------------------------------------------------
# Mapping search: the simulator as the inner loop of an optimizer
# ---------------------------------------------------------------------------

class MappingSearchResult(NamedTuple):
    """Outcome of ``search_mappings``.

    best / best_policy / best_score: per-kernel winner across every
    round (score is the search objective at the winner's best (hw,
    data) lane -- lower is better).  front: the final candidate set
    reduced per kernel on the device (each kernel's best-mapping front).
    mappings: the final-round ``MappingSet`` (front rows index into
    it).  history: one dict per round with per-kernel best/worst scores
    and the candidate counts actually scored.
    """
    best: list
    best_policy: list
    best_score: np.ndarray
    front: _pareto.ReducedResult
    mappings: MappingSet
    history: list


def _candidate_scores(objective: str,
                      red: _pareto.ReducedResult) -> np.ndarray:
    """(n_rows,) objective value of each row's best lane (top-1 rows)."""
    fields = [np.asarray(getattr(red, f))[:, 0]
              for f in _pareto.RESULT_FIELDS]
    vals = _pareto.objective_values(objective, fields)
    return np.where(np.asarray(red.count) > 0, vals, np.inf)


def search_mappings(dags: Sequence, profile: Profile,
                    hw_configs: Sequence[HwConfig], mem_images, *,
                    k: int = 8, keep: int = 2, rounds: int = 2,
                    seed: int = 0, objective: str = "edp",
                    names: Optional[Sequence[str]] = None,
                    rows: int = 4, cols: int = 4,
                    max_steps: int = 2048, mem_size: int = 4096,
                    chunk_steps: Union[int, None, str] = AUTO,
                    blk_b: Union[int, str] = AUTO,
                    max_buckets: Union[int, str] = AUTO,
                    autotune: Optional[bool] = None,
                    reduce: Optional[_pareto.Reduction] = None,
                    device: DeviceLike = None) -> MappingSearchResult:
    """Greedy mapping refinement: sweep K candidates -> keep top-M ->
    mutate -> re-sweep.

    Per round, every kernel's candidate set (``mapper.generate_
    candidates``: survivors' policies first, then seeded mutations of
    them, then fresh shuffled policies; all deduped and verified against
    ``DAG.evaluate`` on ``device``) is flattened into one ``MappingSet``
    and scored against the full (hw x data) grid by one held bucketed
    plan (``make_bucketed_sweep_fn`` with an on-device top-1 reduction
    per candidate): K·H·D design points per round.  The per-kernel
    ``keep`` best (by ``objective`` at each candidate's best lane)
    survive to seed the next round; the best candidate ever seen is
    tracked across rounds.

    Returns a :class:`MappingSearchResult`; ``front`` reduces the final
    candidate set per kernel on the device with ``reduce`` (default
    ``TopK(objective, keep)``), what ``sweep(mappings=...)`` ships back.
    """
    from .mapper import generate_candidates, mutate_policy

    if keep < 1 or k < keep:
        raise ValueError(f"need 1 <= keep <= k, got keep={keep} k={k}")
    names = (list(names) if names is not None
             else [f"kernel{g}" for g in range(len(dags))])
    if len(names) != len(dags):
        raise ValueError(f"{len(names)} names for {len(dags)} DAGs")
    dev = resolve_device(device)
    n_kernels = len(dags)
    top1 = _pareto.TopK(objective, k=1)
    knobs = dict(max_steps=max_steps, mem_size=mem_size,
                 chunk_steps=chunk_steps, blk_b=blk_b,
                 max_buckets=max_buckets, autotune=autotune, device=dev)

    survivors = [None] * n_kernels      # per kernel: list[MappingCandidate]
    best = [None] * n_kernels           # per kernel: (score, candidate)
    history = []
    mset = None
    for r in range(rounds):
        groups = []
        for g, dag in enumerate(dags):
            if r == 0:
                cands = generate_candidates(dag, k, seed=seed + 7 * g,
                                            rows=rows, cols=cols,
                                            name=names[g], device=dev)
            else:
                rng = np.random.default_rng(
                    (seed + 1) * 9176 + 131 * r + g)
                pols = [c.policy for c in survivors[g]]
                while len(pols) < 3 * k:
                    parent = survivors[g][
                        int(rng.integers(0, len(survivors[g])))]
                    pols.append(mutate_policy(parent.policy, rng))
                cands = generate_candidates(dag, k, seed=seed,
                                            rows=rows, cols=cols,
                                            name=names[g], policies=pols,
                                            device=dev)
            groups.append(cands)
        mset = MappingSet.from_candidates(
            [[c.program for c in grp] for grp in groups], names=names)
        plan_fn = make_bucketed_sweep_fn(
            list(mset.programs), profile, hw_configs, mem_images,
            reduce=top1, **knobs)
        scores = _candidate_scores(objective, plan_fn())
        row = {"round": r, "n_candidates": [len(g) for g in groups],
               "best": [], "worst": []}
        offset = 0
        for g, grp in enumerate(groups):
            s = scores[offset:offset + len(grp)]
            offset += len(grp)
            order = np.argsort(s, kind="stable")
            survivors[g] = [grp[i] for i in order[:keep]]
            row["best"].append(float(s[order[0]]))
            row["worst"].append(float(s[order[-1]]))
            if best[g] is None or float(s[order[0]]) < best[g][0]:
                best[g] = (float(s[order[0]]), grp[order[0]])
        history.append(row)

    front = sweep(mappings=mset, profile=profile, hw_configs=hw_configs,
                  mem_images=mem_images,
                  reduce=reduce or _pareto.TopK(objective, k=keep), **knobs)
    return MappingSearchResult(
        best=[b[1].program for b in best],
        best_policy=[b[1].policy for b in best],
        best_score=np.asarray([b[0] for b in best], np.float64),
        front=front, mappings=mset, history=history)
