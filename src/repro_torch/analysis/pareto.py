"""On-device top-k / Pareto-front reduction for sweep results.

A sweep produces ``(B,)`` latency/energy/power tensors with
``B = G*H*D`` lanes, yet DSE consumers only ever look at the winners.
This module defines *reduction specs* -- :class:`TopK` (best ``k`` lanes
per program by one objective) and :class:`ParetoFront` (the
non-dominated set per program over two objectives) -- together with

* a **segmented device implementation** in PyTorch (chained stable
  sorts for the lexsort, cumulative sums and minima for the segmented
  scans, keyed on the per-lane ``prog_idx``; padded / foreign lanes are
  masked with ``+inf`` sentinels and a ``lane_idx < 0`` validity
  convention) that runs where the sweep's tensors are, so the ``(B,)``
  grid never leaves the device,
* a **numpy oracle** (independent O(n^2) reference) the device path is
  bit-identical to, and
* an **associative host-side merge** (:func:`merge_reduced`) so
  per-bucket and per-work-unit candidate sets -- each only ``O(G*K)``
  numbers -- combine to exactly the monolithic answer.

Every candidate is tagged with its *original flat grid index* so clients
can recover ``(g, h, d)`` coordinates: ``g = idx // (H*D)``,
``h = (idx // D) % H``, ``d = idx % D``.

Exactness of the merge: top-k of a union of per-part top-k sets *is* the
global top-k, always.  A union of per-part Pareto fronts re-filtered for
dominance is the global front **provided no part overflowed
``max_points``** -- overflow is reported per segment via
``ReducedResult.clipped`` (always 0 for :class:`TopK`).  Size
``max_points`` above the largest per-program front you expect.

Objectives are compared as ``float32`` (matching on-device arithmetic);
``edp`` is the energy-delay product ``energy_pj * latency_cc`` in float32.
Ties (``-0.0`` and ``0.0`` included) are broken by ascending flat grid
index, so results are deterministic and reproducible across devices and
unit partitions.

The numpy parts (specs, ``ReducedResult``, the oracle, merges and wire
codecs) are those of the reference package; the device reducer is this
package's own.
"""
from __future__ import annotations

import base64
import dataclasses
import functools
from typing import NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch

from .. import spans

# Mirrors ``core.dse.SweepResult._fields`` (kept literal to avoid an
# import cycle: core.dse imports this module for the ``reduce=`` API).
RESULT_FIELDS: Tuple[str, ...] = (
    "latency_cc", "energy_pj", "power_mw", "checksum", "steps_executed")

#: Scalar objectives a reduction may rank by.  ``edp`` = energy-delay
#: product (latency_cc * energy_pj, float32).
OBJECTIVES: Tuple[str, ...] = (
    "latency_cc", "energy_pj", "power_mw", "edp")


@dataclasses.dataclass(frozen=True)
class TopK:
    """Keep the ``k`` lanes with the smallest ``objective`` per program."""

    objective: str = "energy_pj"
    k: int = 8

    def __post_init__(self):
        if self.objective not in OBJECTIVES:
            raise ValueError(
                f"objective must be one of {OBJECTIVES}, got "
                f"{self.objective!r}")
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")

    @property
    def k_out(self) -> int:
        return self.k


@dataclasses.dataclass(frozen=True)
class ParetoFront:
    """Keep the non-dominated set per program over two objectives.

    A lane ``p`` dominates ``q`` when ``p`` is <= on both axes and < on at
    least one, so exact duplicates of a front point stay on the front.
    The front is reported in ascending ``(axes[0], axes[1], index)`` order
    and truncated to ``max_points`` (truncation is flagged in
    ``ReducedResult.clipped`` — see the module docstring for what that
    means for merge exactness).
    """

    axes: Tuple[str, str] = ("latency_cc", "energy_pj")
    max_points: int = 32

    def __post_init__(self):
        axes = tuple(self.axes)
        object.__setattr__(self, "axes", axes)
        if len(axes) != 2 or len(set(axes)) != 2:
            raise ValueError(f"axes must name 2 distinct objectives: {axes}")
        for a in axes:
            if a not in OBJECTIVES:
                raise ValueError(
                    f"axis must be one of {OBJECTIVES}, got {a!r}")
        if self.max_points < 1:
            raise ValueError(f"max_points must be >= 1, got {self.max_points}")

    @property
    def k_out(self) -> int:
        return self.max_points


Reduction = Union[TopK, ParetoFront]


class ReducedResult(NamedTuple):
    """Per-program candidate sets: ``O(G*K)`` numbers instead of ``O(B)``.

    Row ``g`` holds up to ``K`` candidates for program ``g``; empty slots
    have ``indices == -1`` (metric fields are zero there).  ``count[g]``
    is the number of valid candidates; ``clipped[g]`` counts eligible
    candidates dropped by the ``K`` cap (Pareto only — nonzero means a
    later :func:`merge_reduced` is no longer guaranteed exact).
    """

    indices: np.ndarray         # (G, K) int32 flat grid index, -1 = empty
    latency_cc: np.ndarray      # (G, K) int32
    energy_pj: np.ndarray       # (G, K) float32
    power_mw: np.ndarray        # (G, K) float32
    checksum: np.ndarray        # (G, K) int32
    steps_executed: np.ndarray  # (G, K) int32
    count: np.ndarray           # (G,)   int32
    clipped: np.ndarray         # (G,)   int32


REDUCED_FIELDS: Tuple[str, ...] = ReducedResult._fields
#: (G, K)-shaped members of ReducedResult (the per-candidate columns).
CANDIDATE_FIELDS: Tuple[str, ...] = REDUCED_FIELDS[:6]

_OUT_DTYPES = {
    "indices": np.int32, "latency_cc": np.int32, "energy_pj": np.float32,
    "power_mw": np.float32, "checksum": np.int32, "steps_executed": np.int32,
    "count": np.int32, "clipped": np.int32,
}


def reduced_zeros(n_programs: int, spec: Reduction):
    """Empty per-field arrays of a ``ReducedResult`` (checkpoint ``like``
    templates, accumulators): candidates zeroed, ``indices`` all -1."""
    K = spec.k_out
    out = {f: np.zeros((n_programs, K) if f in CANDIDATE_FIELDS
                       else (n_programs,), _OUT_DTYPES[f])
           for f in REDUCED_FIELDS}
    out["indices"][:] = -1
    return out


def reduced_nbytes(n_programs: int, spec: Reduction) -> int:
    """Device->host bytes for one ReducedResult: O(G*K), independent of B."""
    k = spec.k_out
    return n_programs * (k * 4 * len(CANDIDATE_FIELDS) + 2 * 4)


def spec_to_str(spec: Reduction) -> str:
    """Compact, parseable form (CLI flags, checkpoint fingerprints)."""
    if isinstance(spec, TopK):
        return f"topk:{spec.objective}:{spec.k}"
    return f"pareto:{','.join(spec.axes)}:{spec.max_points}"


def spec_from_str(s: str) -> Reduction:
    """Inverse of :func:`spec_to_str` (e.g. ``topk:edp:4``)."""
    kind, _, rest = s.partition(":")
    body, _, k = rest.rpartition(":")
    if kind == "topk":
        return TopK(objective=body, k=int(k))
    if kind == "pareto":
        return ParetoFront(axes=tuple(body.split(",")), max_points=int(k))
    raise ValueError(f"unknown reduction spec {s!r}")


def _f32(x):
    return x.float() if isinstance(x, torch.Tensor) else x.astype("float32")


def objective_values(name: str, fields):
    """Objective as float32; works on numpy arrays and torch tensors."""
    lat, en, pw = fields[0], fields[1], fields[2]
    if name == "latency_cc":
        return _f32(lat)
    if name == "energy_pj":
        return _f32(en)
    if name == "power_mw":
        return _f32(pw)
    if name == "edp":
        return _f32(en) * _f32(lat)
    raise ValueError(f"unknown objective {name!r}")


# ---------------------------------------------------------------------------
# Numpy oracle
# ---------------------------------------------------------------------------

def reduce_oracle(spec: Reduction, fields, prog_idx, lane_idx,
                  n_programs: int) -> ReducedResult:
    """Reference reduction in plain numpy (independent of the device path).

    ``fields`` are the five sweep-result arrays in :data:`RESULT_FIELDS`
    order, each ``(B,)``; ``prog_idx`` maps each lane to its program
    segment and ``lane_idx`` carries the original flat grid index
    (``-1`` marks padded / invalid lanes, which are ignored).
    """
    arrs = [np.asarray(f) for f in fields]
    prog = np.asarray(prog_idx).astype(np.int64)
    lane = np.asarray(lane_idx).astype(np.int64)
    G, K = int(n_programs), spec.k_out
    out = {f: np.zeros((G, K), _OUT_DTYPES[f]) for f in CANDIDATE_FIELDS}
    out["indices"][:] = -1
    count = np.zeros((G,), np.int32)
    clipped = np.zeros((G,), np.int32)
    for g in range(G):
        cand = np.nonzero((prog == g) & (lane >= 0))[0]
        if cand.size == 0:
            continue
        if isinstance(spec, TopK):
            key = objective_values(spec.objective, arrs)[cand]
            eligible = cand[np.lexsort((lane[cand], key))]
        else:
            a = objective_values(spec.axes[0], arrs)[cand]
            b = objective_values(spec.axes[1], arrs)[cand]
            dom = ((a[None, :] <= a[:, None]) & (b[None, :] <= b[:, None])
                   & ((a[None, :] < a[:, None]) | (b[None, :] < b[:, None]))
                   ).any(axis=1)
            front = np.nonzero(~dom)[0]
            order = front[np.lexsort((lane[cand[front]], b[front], a[front]))]
            eligible = cand[order]
            clipped[g] = max(0, eligible.size - K)
        chosen = eligible[:K]
        count[g] = chosen.size
        out["indices"][g, :chosen.size] = lane[chosen]
        for i, f in enumerate(RESULT_FIELDS):
            out[f][g, :chosen.size] = arrs[i][chosen].astype(_OUT_DTYPES[f])
    return ReducedResult(count=count, clipped=clipped, **out)


# ---------------------------------------------------------------------------
# Host-side merge (associative)
# ---------------------------------------------------------------------------

def merge_reduced(spec: Reduction,
                  parts: Sequence[ReducedResult]) -> ReducedResult:
    """Merge candidate sets from buckets / devices / work units.

    Associative and idempotent: candidates are pooled per segment,
    deduplicated by flat grid index, and re-reduced with the numpy oracle
    (each part is only ``(G, K)``, so this is cheap).  Exact for
    :class:`TopK` always, and for :class:`ParetoFront` whenever no input
    part was clipped; residual ``clipped`` counts are carried through so
    callers can detect inexactness.
    """
    parts = [p for p in parts if p is not None]
    if not parts:
        raise ValueError("merge_reduced needs at least one part")
    if len(parts) == 1:
        return _as_numpy(parts[0])
    G = int(np.asarray(parts[0].count).shape[0])
    cat = {f: np.concatenate(
        [np.asarray(getattr(p, f)) for p in parts], axis=1)
        for f in CANDIDATE_FIELDS}
    n = cat["indices"].shape[1]
    lane = cat["indices"].astype(np.int64)
    # Dedupe repeated lanes (e.g. a re-delivered partial): keep first.
    for g in range(G):
        seen = set()
        for j in range(n):
            ix = lane[g, j]
            if ix < 0:
                continue
            if ix in seen:
                lane[g, j] = -1
            else:
                seen.add(ix)
    prog = np.repeat(np.arange(G), n)
    fields = tuple(cat[f].reshape(-1) for f in RESULT_FIELDS)
    red = reduce_oracle(spec, fields, prog, lane.reshape(-1), G)
    carried = np.sum([np.asarray(p.clipped) for p in parts], axis=0)
    return red._replace(
        clipped=(red.clipped + carried).astype(np.int32))


def remap_segments(part: ReducedResult, prog_map, index_offsets,
                   n_programs: int) -> ReducedResult:
    """Place a bucket-local result into the global segment space.

    Row ``j`` of ``part`` becomes row ``prog_map[j]`` of a ``(G, K)``
    result and its valid candidate indices are shifted by
    ``index_offsets[j]`` (buckets enumerate lanes program-locally; the
    offset restores the canonical ``(g*H + h)*D + d`` flat index).
    """
    rows = np.asarray(prog_map, dtype=np.int64)
    offs = np.asarray(index_offsets, dtype=np.int64)
    K = np.asarray(part.indices).shape[1]
    out = {f: np.zeros((n_programs, K), _OUT_DTYPES[f])
           for f in CANDIDATE_FIELDS}
    out["indices"][:] = -1
    count = np.zeros((n_programs,), np.int32)
    clipped = np.zeros((n_programs,), np.int32)
    src_idx = np.asarray(part.indices).astype(np.int64)
    shifted = np.where(src_idx >= 0, src_idx + offs[:, None], -1)
    out["indices"][rows] = shifted.astype(np.int32)
    for f in RESULT_FIELDS:
        out[f][rows] = np.asarray(getattr(part, f))
    count[rows] = np.asarray(part.count)
    clipped[rows] = np.asarray(part.clipped)
    return ReducedResult(count=count, clipped=clipped, **out)


def fold_segments(spec: Reduction, part: ReducedResult, seg_of,
                  n_out: int) -> ReducedResult:
    """Fold fine segments into coarse ones and re-reduce.

    Row ``j`` of ``part`` contributes its candidates to row
    ``seg_of[j]`` of an ``(n_out, K)`` result -- e.g. per-``(kernel,
    mapping)`` candidate rows fold into per-kernel rows, so a mapping
    sweep ships back each kernel's best-mapping front.  Unlike
    :func:`remap_segments` (a pure *relabeling*, rows must be distinct),
    folding POOLS every source row that maps to the same target and
    re-reduces with the numpy oracle, exactly like :func:`merge_reduced`.
    Candidate ``indices`` are NOT shifted: a candidate's flat grid index
    already encodes its fine-segment coordinate (``idx // (H*D)`` is the
    flat candidate row), so the winning mapping id stays recoverable
    after the fold.  Residual ``clipped`` counts are summed per target
    row (TopK folds are exact; a clipped ParetoFront may have lost
    points before the fold, same caveat as merging).
    """
    part = _as_numpy(part)
    seg = np.asarray(seg_of, dtype=np.int64)
    n_rows, K = part.indices.shape
    if seg.shape != (n_rows,):
        raise ValueError(
            f"fold_segments: seg_of has shape {seg.shape}, expected "
            f"({n_rows},) to match the {n_rows} reduced rows")
    if seg.size and not (0 <= seg.min() and seg.max() < n_out):
        raise ValueError(
            f"fold_segments: seg_of out of range [0, {n_out})")
    prog = np.repeat(seg, K)
    fields = tuple(getattr(part, f).reshape(-1) for f in RESULT_FIELDS)
    red = reduce_oracle(spec, fields, prog, part.indices.reshape(-1),
                        n_out)
    carried = np.zeros((n_out,), np.int64)
    np.add.at(carried, seg, part.clipped.astype(np.int64))
    return red._replace(
        clipped=(red.clipped + carried).astype(np.int32))


def _as_numpy(r: ReducedResult) -> ReducedResult:
    """Host numpy copy of a result whose fields may be tensors on any
    device."""
    if not any(isinstance(x, torch.Tensor) for x in r):
        return ReducedResult(*(np.asarray(x) for x in r))
    with spans.span("reduce.to_host"):
        spans.count("host_syncs", sum(isinstance(x, torch.Tensor)
                                      and x.is_cuda for x in r))
        return ReducedResult(*(x.cpu().numpy() if isinstance(x, torch.Tensor)
                               else np.asarray(x) for x in r))


# ---------------------------------------------------------------------------
# Wire serialization (JSON-safe, bit-exact)
# ---------------------------------------------------------------------------
#
# The sweep service's HTTP transport (``service/transport.py``) ships
# results as JSON lines.  Floats must survive the trip bit-for-bit (the
# transport's contract is that a folded stream equals the monolithic
# sweep EXACTLY), so arrays travel as base64 of their raw little-endian
# bytes, never as decimal literals.

def array_to_wire(a: np.ndarray) -> dict:
    """JSON-safe encoding of an array: dtype + shape + base64 raw bytes.
    Bit-exact round trip with :func:`array_from_wire`."""
    a = np.ascontiguousarray(a)
    if a.dtype.byteorder == ">":          # wire format is little-endian
        a = a.astype(a.dtype.newbyteorder("<"))
    return {"dtype": a.dtype.str, "shape": list(a.shape),
            "data": base64.b64encode(a.tobytes()).decode("ascii")}


def array_from_wire(d: dict) -> np.ndarray:
    """Inverse of :func:`array_to_wire`."""
    a = np.frombuffer(base64.b64decode(d["data"]),
                      dtype=np.dtype(d["dtype"]))
    return a.reshape(tuple(int(s) for s in d["shape"])).copy()


def reduced_to_wire(r: ReducedResult) -> dict:
    """JSON-safe ``ReducedResult`` (field name -> wire array)."""
    r = _as_numpy(r)
    return {f: array_to_wire(getattr(r, f)) for f in REDUCED_FIELDS}


def reduced_from_wire(d: dict) -> ReducedResult:
    """Inverse of :func:`reduced_to_wire` (canonical output dtypes)."""
    return ReducedResult(**{
        f: array_from_wire(d[f]).astype(_OUT_DTYPES[f], copy=False)
        for f in REDUCED_FIELDS})




# ---------------------------------------------------------------------------
# Segmented device implementation (PyTorch, on the fields' device)
# ---------------------------------------------------------------------------

def _ordered(x: torch.Tensor) -> torch.Tensor:
    """int32 keys in the order of the float32 values ``x``, with -0.0
    taken as 0.0: integer sorts are exact on every device, and a radix
    sort of the float bits would put -0.0 before 0.0."""
    bits = torch.where(x == 0, torch.zeros_like(x), x).view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def _lexsort(keys) -> torch.Tensor:
    """``np.lexsort`` of equal-length 1-D tensors (last key most
    significant): stable sorts chained from the least significant key."""
    order = torch.sort(keys[0], stable=True).indices
    for k in keys[1:]:
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def _run_starts(change: torch.Tensor) -> torch.Tensor:
    """Index of the first lane of each lane's run (``change`` marks the
    first lane of every run)."""
    i = torch.arange(change.shape[0], device=change.device)
    return torch.cummax(torch.where(change, i, 0), 0).values


@functools.lru_cache(maxsize=None)
def make_device_reducer(spec: Reduction, n_programs: int):
    """``(fields, prog_idx, lane_idx) -> ReducedResult`` reducer.

    ``fields`` is the 5-tuple of ``(B,)`` sweep-result tensors in
    :data:`RESULT_FIELDS` order.  Segments follow ``prog_idx``; lanes
    with ``lane_idx < 0`` are masked (+inf sentinel keys) so padded lanes
    never become candidates.  Runs on the fields' device and returns
    ``(G, K)`` tensors there; only those need cross to the host.

    Bit-identical to :func:`reduce_oracle`: both compare float32
    objectives and break ties by ascending flat grid index.
    """
    G, K = int(n_programs), spec.k_out
    is_topk = isinstance(spec, TopK)

    def reduce_fn(fields, prog_idx, lane_idx) -> ReducedResult:
        fields = tuple(torch.as_tensor(f) for f in fields)
        dev = fields[0].device
        fields = tuple(f.to(dev) for f in fields)
        B = fields[0].shape[0]
        lane32 = torch.as_tensor(lane_idx, device=dev).to(torch.int32)
        valid = lane32 >= 0
        seg = torch.where(valid, torch.as_tensor(prog_idx, device=dev)
                          .to(torch.int32), G)

        def key(name):
            return torch.where(valid, objective_values(name, fields),
                               float("inf"))

        if is_topk:
            order = _lexsort((lane32, _ordered(key(spec.objective)), seg))
            sseg = seg[order]
            eligible = valid[order]
        else:
            a, b = _ordered(key(spec.axes[0])), _ordered(key(spec.axes[1]))
            order = _lexsort((lane32, b, a, seg))
            sseg, sa, sb = seg[order], a[order], b[order]
            first = torch.ones(B, dtype=torch.bool, device=dev)
            prev_same_seg = torch.cat([~first[:1], sseg[1:] == sseg[:-1]])
            # min b among earlier same-segment lanes (exclusive): a
            # running minimum of b lifted by (G - seg) in the high word,
            # so no lane of an earlier segment can win it
            lifted = ((G - sseg).to(torch.int64) << 32) | (
                sb.to(torch.int64) + 2**31)
            incl = torch.cummin(lifted, 0).values
            never = 2**62                       # above every lifted key
            excl = torch.full_like(incl, never)
            excl[1:] = torch.where(prev_same_seg[1:], incl[:-1], never)
            # first index of this (segment, a) run
            run_start = _run_starts(~(prev_same_seg & torch.cat(
                [~first[:1], sa[1:] == sa[:-1]])))
            # dominated <=> a strictly-smaller-a lane has b <= mine, or the
            # min-b lane of my own a-run has b strictly below mine
            dominated = (excl[run_start] <= lifted) | (sb[run_start] < sb)
            eligible = valid[order] & ~dominated
        e64 = eligible.to(torch.int64)
        before = torch.cumsum(e64, 0) - e64        # exclusive count
        seg_start = _run_starts(torch.cat(
            [torch.ones(1, dtype=torch.bool, device=dev),
             sseg[1:] != sseg[:-1]]))
        rank = before - before[seg_start]
        take = eligible & (rank < K)
        # dropped writes land in one spare slot past the (G, K) table
        slot = torch.where(take, sseg.to(torch.int64) * K + rank, G * K)
        out_src = torch.full((G * K + 1,), B, dtype=torch.int64,
                             device=dev).scatter_(0, slot, order)
        out_src = out_src[:G * K].view(G, K)
        ok = out_src < B
        safe = out_src.clamp(max=max(B - 1, 0))

        def gather(x, dtype, fill):
            return torch.where(ok, x[safe].to(dtype), fill)

        # eligible lanes per segment (a scatter: bincount would wait for
        # the device to size its output)
        tot = torch.zeros(G + 1, dtype=torch.int64, device=dev).scatter_add_(
            0, sseg.to(torch.int64), e64)[:G]
        count = tot.clamp(max=K).to(torch.int32)
        clipped = (torch.zeros(G, dtype=torch.int32, device=dev) if is_topk
                   else (tot - K).clamp(min=0).to(torch.int32))
        return ReducedResult(
            indices=gather(lane32, torch.int32, -1),
            latency_cc=gather(fields[0], torch.int32, 0),
            energy_pj=gather(fields[1], torch.float32, 0.0),
            power_mw=gather(fields[2], torch.float32, 0.0),
            checksum=gather(fields[3], torch.int32, 0),
            steps_executed=gather(fields[4], torch.int32, 0),
            count=count, clipped=clipped)

    return reduce_fn


def reduce_on_device(spec: Reduction, result_fields, prog_idx, lane_idx,
                     n_programs: int) -> ReducedResult:
    """Convenience wrapper around :func:`make_device_reducer`."""
    fn = make_device_reducer(spec, int(n_programs))
    return fn(tuple(result_fields), prog_idx, lane_idx)
