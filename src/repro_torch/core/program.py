"""CGRA program container, program batching, and a small textual assembler.

A ``Program`` is the dense, array-form encoding of a kernel: for each of
``n_instrs`` CGRA instructions and each of ``n_pes`` processing elements it
stores (op, dest, srcA, srcB, imm).  The arrays are plain numpy on the
host; the simulator consumes them as *runtime operands* (``ProgramTables``,
see ``cgra.make_step_fn``), so swapping kernels never forces a retrace --
the program is data, not a compile-time constant.

``pack_programs`` stacks G kernels into one ``ProgramBatch``: every
program is NOP-padded to the common ``(T_max, P)`` shape, the true length
is kept per program (the simulator clips the PC to each program's own
last instruction, so padding is never executed and EXIT semantics are
preserved bit-for-bit), and the derived static tables (IS_LOAD /
IS_STORE / WRITES_ROUT masks, SRC_KIND operand classes) are precomputed
as stacked ``(G, T_max, P)`` arrays.  The batch is the program axis of
the (program x hardware x data) DSE grid (``dse.sweep``).

Two authoring layers:
  * programmatic: ``ProgramBuilder`` -- used by apps/ to generate
    parameterized kernels (loop bounds, addresses, ...);
  * textual: ``assemble`` -- one line per PE slot, used for readability in
    tests and for the verbatim Figure-4 loop.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .isa import (DEST, DEST_ROUT_ONLY, NOP_SLOT, OP, OPCODES, PEInstr, SRC)


@dataclasses.dataclass(frozen=True)
class Program:
    """Dense array form of a CGRA kernel."""
    ops: np.ndarray    # (T, P) int32
    dest: np.ndarray   # (T, P) int32
    srcA: np.ndarray   # (T, P) int32
    srcB: np.ndarray   # (T, P) int32
    imm: np.ndarray    # (T, P) int32
    name: str = "kernel"

    @property
    def n_instrs(self) -> int:
        return int(self.ops.shape[0])

    @property
    def n_pes(self) -> int:
        return int(self.ops.shape[1])

    def validate(self) -> "Program":
        # ValueError (never a bare assert): validation must survive
        # ``python -O``, and the message must name the program and the
        # offending field/range so a bad kernel in a G-program batch is
        # attributable.
        T, P = self.ops.shape
        fields = (("ops", self.ops, len(OPCODES)),
                  ("dest", self.dest, len(DEST)),
                  ("srcA", self.srcA, len(SRC)),
                  ("srcB", self.srcB, len(SRC)))
        for fname, arr, hi in fields:
            if arr.shape != (T, P):
                raise ValueError(
                    f"program {self.name!r}: field {fname!r} has shape "
                    f"{arr.shape}, expected {(T, P)}")
            if arr.size and not (arr.min() >= 0 and arr.max() < hi):
                raise ValueError(
                    f"program {self.name!r}: field {fname!r} out of range "
                    f"[0, {hi}) -- got min {int(arr.min())}, "
                    f"max {int(arr.max())}")
        # Branch targets must be within the program.
        from .isa import IS_BRANCH
        br = IS_BRANCH[self.ops]
        if br.any():
            tgt = self.imm[br]
            if not (tgt.min() >= 0 and tgt.max() < T):
                raise ValueError(
                    f"program {self.name!r}: branch target out of range "
                    f"[0, {T}) -- got min {int(tgt.min())}, "
                    f"max {int(tgt.max())}")
        return self

    def slot(self, t: int, p: int) -> PEInstr:
        return PEInstr(int(self.ops[t, p]), int(self.dest[t, p]),
                       int(self.srcA[t, p]), int(self.srcB[t, p]),
                       int(self.imm[t, p]))


# --------------------------------------------------------------------------
# Program-as-data: runtime table form and multi-kernel batches
# --------------------------------------------------------------------------


class ProgramTables(NamedTuple):
    """The program as a pytree of runtime operands for the simulator.

    Leaves are ``(T, P)`` (single program, ``program_tables``) or
    ``(G, T_max, P)`` stacked (``batch_tables``), with ``n_instrs``
    scalar / ``(G,)`` carrying each program's *true* length: the
    simulator clips the PC to ``n_instrs - 1`` per lane, so NOP padding
    beyond a program's end is never executed.  Because these are traced
    arguments (not closure constants), one compiled step/sweep
    executable serves every program of the same padded shape.
    """
    ops: np.ndarray          # int32 opcodes
    dest: np.ndarray         # int32 destination selectors
    srcA: np.ndarray         # int32 operand-A source selectors
    srcB: np.ndarray         # int32 operand-B source selectors
    imm: np.ndarray          # int32 immediates / branch targets
    is_load: np.ndarray      # bool  derived: op reads memory
    is_store: np.ndarray     # bool  derived: op writes memory
    writes_rout: np.ndarray  # bool  derived: op writes ROUT
    kindA: np.ndarray        # int32 derived: SRC_KIND of srcA (case vi)
    kindB: np.ndarray        # int32 derived: SRC_KIND of srcB (case vi)
    n_instrs: np.ndarray     # int32 true program length(s)


def _derived_tables(ops: np.ndarray, srcA: np.ndarray, srcB: np.ndarray):
    from . import isa
    return (isa.IS_LOAD[ops], isa.IS_STORE[ops], isa.WRITES_ROUT[ops],
            isa.SRC_KIND[srcA].astype(np.int32),
            isa.SRC_KIND[srcB].astype(np.int32))


def program_tables(program: "Program") -> ProgramTables:
    """Single-program ``(T, P)`` runtime tables (n_instrs scalar)."""
    isld, isst, wr, kA, kB = _derived_tables(program.ops, program.srcA,
                                             program.srcB)
    return ProgramTables(program.ops, program.dest, program.srcA,
                         program.srcB, program.imm, isld, isst, wr, kA, kB,
                         np.int32(program.n_instrs))


@dataclasses.dataclass(frozen=True)
class ProgramBatch:
    """G kernels packed to a common ``(T_max, P)`` shape (see
    ``pack_programs``).  Field arrays are ``(G, T_max, P)``; ``n_instrs``
    is ``(G,)`` with the true (pre-padding) lengths."""
    ops: np.ndarray
    dest: np.ndarray
    srcA: np.ndarray
    srcB: np.ndarray
    imm: np.ndarray
    n_instrs: np.ndarray          # (G,) int32 true lengths
    names: Tuple[str, ...]

    @property
    def n_programs(self) -> int:
        return int(self.ops.shape[0])

    @property
    def t_max(self) -> int:
        return int(self.ops.shape[1])

    @property
    def n_pes(self) -> int:
        return int(self.ops.shape[2])

    def program(self, g: int) -> Program:
        """Recover program ``g`` (padding stripped)."""
        t = int(self.n_instrs[g])
        return Program(self.ops[g, :t], self.dest[g, :t], self.srcA[g, :t],
                       self.srcB[g, :t], self.imm[g, :t],
                       name=self.names[g])

    def tables(self) -> ProgramTables:
        return batch_tables(self)


def batch_tables(batch: ProgramBatch) -> ProgramTables:
    """Stacked ``(G, T_max, P)`` runtime tables for a ProgramBatch."""
    isld, isst, wr, kA, kB = _derived_tables(batch.ops, batch.srcA,
                                             batch.srcB)
    return ProgramTables(batch.ops, batch.dest, batch.srcA, batch.srcB,
                         batch.imm, isld, isst, wr, kA, kB,
                         batch.n_instrs.astype(np.int32))


def pack_programs(programs: Sequence[Program],
                  pad_slot: PEInstr = NOP_SLOT) -> ProgramBatch:
    """Pack G kernels into one ProgramBatch.

    Every program is validated (ValueError on malformed fields or branch
    targets outside its own length -- revalidation here means a bad
    kernel is caught before it is baked into a padded batch where its
    branch targets would alias into padding), then NOP-padded to the
    longest program's length.  Padding never executes: the simulator
    clips each lane's PC to that program's true ``n_instrs - 1``,
    exactly as the unpadded simulator clips to its static ``T - 1``, so
    a packed program is bit-identical to the same program swept alone.
    """
    progs = list(programs)
    if not progs:
        raise ValueError("pack_programs: empty program sequence")
    for p in progs:
        if not isinstance(p, Program):
            raise ValueError(
                f"pack_programs: expected Program, got {type(p).__name__}")
        p.validate()
    P = progs[0].n_pes
    for p in progs:
        if p.n_pes != P:
            raise ValueError(
                f"pack_programs: program {p.name!r} has n_pes={p.n_pes}, "
                f"but {progs[0].name!r} has n_pes={P}; all programs of a "
                f"batch must target the same array")
    t_max = max(p.n_instrs for p in progs)

    def pad(arr: np.ndarray, fill: int) -> np.ndarray:
        out = np.full((t_max, P), fill, np.int32)
        out[:arr.shape[0]] = arr
        return out

    fields = {"op": "ops", "dest": "dest", "srcA": "srcA", "srcB": "srcB",
              "imm": "imm"}
    stacked = {attr: np.stack([pad(getattr(p, attr), getattr(pad_slot, f))
                               for p in progs])
               for f, attr in fields.items()}
    return ProgramBatch(n_instrs=np.array([p.n_instrs for p in progs],
                                          np.int32),
                        names=tuple(p.name for p in progs), **stacked)


def as_program_batch(program) -> ProgramBatch:
    """Coerce Program | Sequence[Program] | ProgramBatch -> ProgramBatch."""
    if isinstance(program, ProgramBatch):
        return program
    if isinstance(program, Program):
        return pack_programs([program])
    return pack_programs(program)


# --------------------------------------------------------------------------
# Mapping sets: K candidate schedules per kernel, flattened to one
# program axis
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MappingSet:
    """Candidate mappings as a first-class batched axis.

    ``programs`` is the *flattened* candidate list -- kernel 0's
    candidates first, then kernel 1's, and so on -- and the two segment
    maps tie each flat row back to its ``(kernel_id, mapping_id)``
    coordinate.  Because the flattening is just a program sequence,
    everything built for the program axis works unchanged: the set
    ``pack_programs`` into a ProgramBatch, length-bucketing sees each
    candidate as an ordinary program, and the service's trip-count
    history keys on the (unique) candidate names.  Only the *reduction*
    needs the segment map: fold the per-candidate rows of a reduced
    sweep through ``kernel_of`` to get each kernel's best-mapping front
    (``analysis.pareto.fold_segments``).
    """
    programs: Tuple[Program, ...]
    kernel_of: np.ndarray          # (n_total,) int32 kernel id per row
    mapping_of: np.ndarray         # (n_total,) int32 candidate id in kernel
    kernel_names: Tuple[str, ...]  # (n_kernels,)

    @property
    def n_kernels(self) -> int:
        return len(self.kernel_names)

    @property
    def n_total(self) -> int:
        return len(self.programs)

    @property
    def counts(self) -> np.ndarray:
        """(n_kernels,) candidates per kernel."""
        return np.bincount(self.kernel_of,
                           minlength=self.n_kernels).astype(np.int32)

    def candidates(self, g: int) -> Tuple[Program, ...]:
        """Kernel ``g``'s candidate programs, in mapping_id order."""
        return tuple(self.programs[i] for i in
                     np.flatnonzero(self.kernel_of == g))

    def pack(self, pad_slot: PEInstr = NOP_SLOT) -> ProgramBatch:
        return pack_programs(self.programs, pad_slot)

    @staticmethod
    def from_candidates(candidates: Sequence[Sequence[Program]],
                        names: Optional[Sequence[str]] = None,
                        ) -> "MappingSet":
        """Build from per-kernel candidate lists.

        Candidate names must be unique across the whole flattened set
        (bucketing and trip-count history key on them); duplicates are
        rejected rather than silently renamed."""
        cands = [tuple(group) for group in candidates]
        if not cands or any(not g for g in cands):
            raise ValueError(
                "MappingSet: every kernel needs at least one candidate")
        flat: List[Program] = []
        kernel_of: List[int] = []
        mapping_of: List[int] = []
        for g, group in enumerate(cands):
            for j, p in enumerate(group):
                if not isinstance(p, Program):
                    raise ValueError(
                        f"MappingSet: kernel {g} candidate {j} is "
                        f"{type(p).__name__}, expected Program")
                flat.append(p)
                kernel_of.append(g)
                mapping_of.append(j)
        seen: Dict[str, int] = {}
        for i, p in enumerate(flat):
            if p.name in seen:
                raise ValueError(
                    f"MappingSet: duplicate candidate name {p.name!r} "
                    f"(rows {seen[p.name]} and {i}); candidate names "
                    f"must be unique -- enumerate_mappings suffixes "
                    f"them '#m<j>'")
            seen[p.name] = i
        if names is None:
            names = tuple(group[0].name.split("#m")[0]
                          for group in cands)
        elif len(names) != len(cands):
            raise ValueError(
                f"MappingSet: {len(names)} names for {len(cands)} "
                f"kernels")
        return MappingSet(programs=tuple(flat),
                          kernel_of=np.asarray(kernel_of, np.int32),
                          mapping_of=np.asarray(mapping_of, np.int32),
                          kernel_names=tuple(names))


# --------------------------------------------------------------------------
# Fused instruction rows: one gather per executed step
# --------------------------------------------------------------------------

# Field order of the fused row table.  A row ``fused[g * T_max + pc]`` is
# the complete decoded instruction -- raw fields plus the derived masks and
# operand-source kinds -- so the hot loop fetches ONE (N_ROW_FIELDS, P)
# block per step instead of ten separate (P,) gathers.
ROW_FIELDS = ("ops", "dest", "srcA", "srcB", "imm", "is_load", "is_store",
              "writes_rout", "kindA", "kindB")
N_ROW_FIELDS = len(ROW_FIELDS)
ROW_IDX = {f: i for i, f in enumerate(ROW_FIELDS)}


def fused_rows(tables: ProgramTables) -> np.ndarray:
    """Fuse the per-instruction tables into one int32 row-major array.

    ``(T, P)`` leaves -> ``(T, N_ROW_FIELDS, P)``; stacked ``(G, T_max,
    P)`` leaves -> ``(G * T_max, N_ROW_FIELDS, P)``, flattened on the
    instruction axis so a single scalar-prefetch-style row index
    ``prog_idx * T_max + pc`` addresses the entire instruction.  Bool
    masks are stored as int32 0/1 (consumers compare ``> 0``)."""
    parts = [np.asarray(getattr(tables, f)).astype(np.int32)
             for f in ROW_FIELDS]
    fused = np.stack(parts, axis=-2)
    if fused.ndim == 4:                       # (G, T, NF, P) -> (G*T, NF, P)
        fused = fused.reshape(-1, N_ROW_FIELDS, fused.shape[-1])
    return np.ascontiguousarray(fused)


# --------------------------------------------------------------------------
# Length bucketing: stop short kernels paying the longest kernel's T_max
# --------------------------------------------------------------------------


class ProgramBuckets(NamedTuple):
    """A length-bucketed partition of G programs (see ``bucket_programs``).

    ``batches[b]`` packs the programs of bucket ``b`` to that bucket's own
    ``t_max``; ``groups[b]`` holds their indices into the original
    sequence (ascending), and ``assignment[g]`` is program g's bucket.
    """
    batches: Tuple[ProgramBatch, ...]
    groups: Tuple[Tuple[int, ...], ...]
    assignment: np.ndarray                     # (G,) int32

    @property
    def n_buckets(self) -> int:
        return len(self.batches)

    @property
    def padded_slots(self) -> int:
        """Total padded instruction slots, sum over buckets of
        ``len(bucket) * bucket_t_max`` -- the cost bucketing minimizes."""
        return sum(b.n_programs * b.t_max for b in self.batches)


def bucket_boundaries(lengths: Sequence[int],
                      max_buckets: int) -> List[List[int]]:
    """Partition items into <= max_buckets groups minimizing total padding.

    Items are grouped by ascending length; groups are contiguous runs of
    the sorted order (optimal: the padded cost of a group is
    ``len(group) * max(length)``, which only ever improves by splitting
    at sorted boundaries).  Exact O(n^2 * K) interval DP -- n is a kernel
    count, tiny.  Returns groups of *indices into the input sequence*,
    each ascending, ordered by ascending length."""
    n = len(lengths)
    if n == 0:
        return []
    k_max = max(1, min(int(max_buckets), n))
    order = sorted(range(n), key=lambda i: (lengths[i], i))
    ls = [int(lengths[i]) for i in order]
    # dp[k][j] = min padded cost of covering sorted items [0, j) with k
    # groups; a group [i, j) costs (j - i) * ls[j - 1] (sorted: max=last).
    inf = float("inf")
    dp = [[inf] * (n + 1) for _ in range(k_max + 1)]
    cut = [[0] * (n + 1) for _ in range(k_max + 1)]
    dp[0][0] = 0
    for k in range(1, k_max + 1):
        for j in range(1, n + 1):
            for i in range(k - 1, j):
                if dp[k - 1][i] == inf:
                    continue
                c = dp[k - 1][i] + (j - i) * ls[j - 1]
                if c < dp[k][j]:
                    dp[k][j], cut[k][j] = c, i
    best_k = min(range(1, k_max + 1), key=lambda k: dp[k][n])
    bounds = []
    j = n
    for k in range(best_k, 0, -1):
        i = cut[k][j]
        bounds.append((i, j))
        j = i
    bounds.reverse()
    return [sorted(order[i:j]) for i, j in bounds]


def bucket_programs(programs: Sequence[Program],
                    max_buckets: int,
                    observed_steps: Optional[Sequence[int]] = None
                    ) -> ProgramBuckets:
    """Group kernels by padded length into at most ``max_buckets`` packed
    batches, so short kernels stop paying the longest kernel's ``T_max``
    (and its convoy: a packed sweep runs every lane until the slowest
    kernel exits).  The partition minimizes total padded instruction
    slots; equal-length programs always share a bucket.  Scheduling one
    packed batch per bucket through the lru-cached sweep cores grows
    ``dse.TRACE_COUNTS`` by at most ``n_buckets``, never G.

    observed_steps: per-program observed ``steps_executed`` maxima from a
    prior run (or the sweep service's per-kernel history).  Static length
    is only a proxy for convoy cost -- a tight data-dependent loop makes
    a short kernel run long -- so when trip counts are known the DP
    partitions by them instead: kernels that *run* similarly long share
    a bucket, regardless of instruction count.  Packing within each
    bucket is unchanged (still padded to the bucket's ``T_max``)."""
    progs = list(programs)
    if not progs:
        raise ValueError("bucket_programs: empty program sequence")
    if max_buckets < 1:
        raise ValueError(f"bucket_programs: max_buckets={max_buckets} < 1")
    if observed_steps is not None:
        if len(observed_steps) != len(progs):
            raise ValueError(
                f"bucket_programs: observed_steps has {len(observed_steps)} "
                f"entries for {len(progs)} programs")
        keys = [int(s) for s in observed_steps]
    else:
        keys = [p.n_instrs for p in progs]
    groups = bucket_boundaries(keys, max_buckets)
    batches = tuple(pack_programs([progs[i] for i in g]) for g in groups)
    assignment = np.empty(len(progs), np.int32)
    for b, g in enumerate(groups):
        assignment[list(g)] = b
    return ProgramBuckets(batches, tuple(tuple(g) for g in groups),
                          assignment)


class ProgramBuilder:
    """Builds a Program one CGRA instruction at a time.

    >>> pb = ProgramBuilder(n_pes=16, name="demo")
    >>> i0 = pb.instr({0: asm("SADD", "R0", "R0", "IMM", imm=1)})
    >>> pb.instr({0: asm("BNE", a="R0", b="IMM", imm=i0), 1: ...})
    """

    def __init__(self, n_pes: int = 16, name: str = "kernel"):
        self.n_pes = n_pes
        self.name = name
        self._instrs: List[List[PEInstr]] = []
        self.labels: Dict[str, int] = {}

    def __len__(self) -> int:
        return len(self._instrs)

    def label(self, name: str) -> int:
        """Name the *next* instruction index; returns that index."""
        self.labels[name] = len(self._instrs)
        return self.labels[name]

    def instr(self, slots: Optional[Dict[int, PEInstr]] = None) -> int:
        """Append one CGRA instruction; unspecified PEs execute NOP.

        Returns the instruction index (usable as a branch target).
        """
        row = [NOP_SLOT] * self.n_pes
        for pe, s in (slots or {}).items():
            if not (0 <= pe < self.n_pes):
                raise ValueError(f"PE index {pe} out of range")
            row[pe] = s
        self._instrs.append(row)
        return len(self._instrs) - 1

    def exit(self, pe: int = 0) -> int:
        return self.instr({pe: PEInstr(op=OP["EXIT"])})

    def build(self) -> Program:
        T, P = len(self._instrs), self.n_pes
        f = lambda attr: np.array(
            [[getattr(s, attr) for s in row] for row in self._instrs],
            np.int32)
        return Program(f("op"), f("dest"), f("srcA"), f("srcB"), f("imm"),
                       name=self.name).validate()


# --------------------------------------------------------------------------
# Textual assembler
# --------------------------------------------------------------------------
#
# Syntax (one instruction block per "---" separator):
#
#   pe3: SADD R0, R1, RCL        ; comment
#   pe7: SMUL ROUT, R2, IMM #5
#   pe0: BEQ R0, ZERO @loop
#   label loop                   ; names the NEXT instruction block
#
# dest is optional for branches/stores (they write nothing).


def assemble(text: str, n_pes: int = 16, name: str = "kernel") -> Program:
    pb = ProgramBuilder(n_pes, name)
    blocks: List[Dict[int, Dict]] = []
    labels: Dict[str, int] = {}

    lines = [ln.split(";")[0].strip() for ln in text.strip().splitlines()]
    cur: Dict[int, Dict] = {}
    for ln in lines:
        if not ln:
            continue
        if ln == "---":
            blocks.append(cur)
            cur = {}
            continue
        if ln.startswith("label "):
            # Labels must precede the block they name; they resolve to the
            # index of the next appended instruction block.
            labels[ln.split()[1]] = len(blocks)
            continue
        pe_part, rest = ln.split(":", 1)
        pe = int(pe_part.strip()[2:])
        toks = rest.replace(",", " ").split()
        op = toks[0].upper()
        args = toks[1:]
        imm = 0
        immref: Optional[str] = None
        clean: List[str] = []
        for a in args:
            if a.startswith("#"):
                imm = int(a[1:], 0)
            elif a.startswith("@"):
                immref = a[1:]
            else:
                clean.append(a.upper())
        dest, a_src, b_src = "ROUT", "ZERO", "ZERO"
        if op in ("BEQ", "BNE", "BLT", "BGE"):
            a_src = clean[0] if clean else "ZERO"
            b_src = clean[1] if len(clean) > 1 else "ZERO"
        elif op in ("JUMP", "EXIT", "NOP"):
            pass
        elif op in ("SWD",):
            a_src = clean[0] if clean else "ZERO"
        elif op in ("SWI",):
            a_src = clean[0] if clean else "ZERO"
            b_src = clean[1] if len(clean) > 1 else "ZERO"
        elif op in ("LWD",):
            dest = clean[0] if clean else "ROUT"
        elif op in ("LWI", "MV"):
            dest = clean[0] if clean else "ROUT"
            a_src = clean[1] if len(clean) > 1 else "ZERO"
        else:  # 3-address ALU
            dest = clean[0] if clean else "ROUT"
            a_src = clean[1] if len(clean) > 1 else "ZERO"
            b_src = clean[2] if len(clean) > 2 else "ZERO"
        cur[pe] = dict(op=op, dest=dest, a=a_src, b=b_src, imm=imm,
                       immref=immref)
    if cur:
        blocks.append(cur)

    for block in blocks:
        slots = {}
        for pe, d in block.items():
            imm = labels[d["immref"]] if d["immref"] is not None else d["imm"]
            slots[pe] = PEInstr.make(d["op"], d["dest"], d["a"], d["b"], imm)
        pb.instr(slots)
    prog = pb.build()
    return dataclasses.replace(prog, name=name).validate()
