"""Automatic mapper: expression DAGs -> time-multiplexed CGRA programs,
as a *seeded candidate generator*.

The paper motivates its estimator with the difficulty of mapping kernels
"across a range of PEs and time" (Section 1: compilers "still fall short
of considering the effect of the whole system").  This module closes the
authoring loop for straight-line kernels: given a dataflow DAG it emits
Programs whose simulation equals the DAG's semantics, so the estimator
can score *machine-generated* mappings as well as hand-written ones.

Scheduling model (deliberately simple, documented limits):
  * list scheduling by topological level: every DAG node becomes one
    (instruction, PE) slot;
  * placement, PE scan order, and routing direction are *policy knobs*
    (``MappingPolicy``), so the same DAG yields many distinct-but-correct
    schedules -- the raw material for a mapping search;
  * a consumer placed on a different PE reads the producer's ROUT via a
    torus neighbour port if adjacent -- otherwise MV hop instructions are
    inserted along a torus route;
  * values needed more than one instruction after production are kept in
    the producer PE's register file (R0..R3); the register allocator
    fails loudly on pressure > 4 (no spilling -- kernels that need more
    should be tiled by the caller);
  * leaf nodes: constants (immediates) or memory loads (LWD);
    roots: stores (SWD).

``enumerate_mappings(dag, k, seed)`` walks a deterministic policy stream
(the canonical policy lattice first, then seeded shuffles), verifies
every candidate against ``DAG.evaluate``, dedups identical programs, and
returns up to ``k`` distinct correct schedules.  ``dse.sweep`` then
scores the whole candidate set against a hardware x data grid in one
sweep (see ``dse.search_mappings`` for the closed loop).

This is not SAT-modulo scheduling [10]; it is the minimal mapper that
makes the DSE story end-to-end: DAG -> map -> simulate -> estimate ->
pick hardware.
"""
from __future__ import annotations

import dataclasses
from typing import (Dict, List, NamedTuple, Optional, Sequence, Set,
                    Tuple)

import numpy as np

from . import isa
from .isa import OP, PEInstr, asm
from .program import Program, ProgramBuilder


# ---------------------------------------------------------------------------
# DAG definition
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Node:
    """One dataflow node.

    op:   "const" | "load" | "store" | an ALU opcode name (SADD, SMUL...)
    args: indices of operand nodes (ALU: 2; store: 1)
    imm:  constant value (const), or word address (load/store)
    """
    op: str
    args: Tuple[int, ...] = ()
    imm: int = 0


class DAG:
    def __init__(self):
        self.nodes: List[Node] = []

    def const(self, v: int) -> int:
        self.nodes.append(Node("const", (), int(v)))
        return len(self.nodes) - 1

    def load(self, addr: int) -> int:
        self.nodes.append(Node("load", (), int(addr)))
        return len(self.nodes) - 1

    def alu(self, op: str, a: int, b: int) -> int:
        assert op in OP and OP[op] in isa.ALU_OPS, op
        self.nodes.append(Node(op, (a, b)))
        return len(self.nodes) - 1

    def store(self, addr: int, v: int) -> int:
        self.nodes.append(Node("store", (v,), int(addr)))
        return len(self.nodes) - 1

    # -- reference semantics -------------------------------------------------
    def evaluate(self, mem: np.ndarray) -> np.ndarray:
        """numpy oracle: returns the memory image after all stores."""
        mem = mem.copy()
        val: Dict[int, int] = {}

        def w32(x):
            x &= 0xFFFFFFFF
            return x - (1 << 32) if x >= (1 << 31) else x

        for i, n in enumerate(self.nodes):
            if n.op == "const":
                val[i] = w32(n.imm)
            elif n.op == "load":
                val[i] = int(mem[n.imm])
            elif n.op == "store":
                mem[n.imm] = val[n.args[0]]
            else:
                a, b = val[n.args[0]], val[n.args[1]]
                sh = b & 31
                ua = a & 0xFFFFFFFF
                res = {
                    "SADD": a + b, "SSUB": a - b, "SMUL": a * b,
                    "SLL": ua << sh, "SRL": ua >> sh, "SRA": a >> sh,
                    "LAND": a & b, "LOR": a | b, "LXOR": a ^ b,
                    "SLT": int(a < b), "MV": a,
                }[n.op]
                val[i] = w32(res)
        return mem


# ---------------------------------------------------------------------------
# Scheduling policies
# ---------------------------------------------------------------------------

PE_ORDERS = ("row_major", "reversed", "shuffled")
PLACEMENTS = ("chain", "spread")
ROUTE_AXES = ("col_first", "row_first")


@dataclasses.dataclass(frozen=True)
class MappingPolicy:
    """One point in the mapper's scheduling-decision space.

    pe_order:   scan order used whenever the mapper picks "any free PE"
                ("row_major" | "reversed" | "shuffled"; "shuffled" is a
                seeded permutation, so distinct seeds give distinct
                placements).
    placement:  "chain" prefers the operand's own PE (same-PE register /
                ROUT reads, short programs); "spread" prefers a *fresh*
                PE adjacent to an operand (neighbour-port reads, more MV
                traffic but lower per-PE register pressure).
    route_axis: torus-route tie-breaking -- hop along columns first or
                rows first.
    seed:       permutation seed, only meaningful for pe_order
                "shuffled".

    Every policy yields a *correct* schedule (or a loud MappingError);
    they differ in instruction count, routing traffic, and register
    pressure -- i.e. in latency/energy once estimated, which is exactly
    what a mapping search sweeps over.
    """
    pe_order: str = "row_major"
    placement: str = "chain"
    route_axis: str = "col_first"
    seed: int = 0

    def __post_init__(self):
        if self.pe_order not in PE_ORDERS:
            raise ValueError(f"pe_order {self.pe_order!r} not in "
                             f"{PE_ORDERS}")
        if self.placement not in PLACEMENTS:
            raise ValueError(f"placement {self.placement!r} not in "
                             f"{PLACEMENTS}")
        if self.route_axis not in ROUTE_AXES:
            raise ValueError(f"route_axis {self.route_axis!r} not in "
                             f"{ROUTE_AXES}")

    def scan_order(self, n_pes: int) -> Tuple[int, ...]:
        if self.pe_order == "row_major":
            return tuple(range(n_pes))
        if self.pe_order == "reversed":
            return tuple(range(n_pes - 1, -1, -1))
        rng = np.random.default_rng(self.seed)
        return tuple(int(p) for p in rng.permutation(n_pes))


def canonical_policies() -> List[MappingPolicy]:
    """The 2x2x2 lattice of non-shuffled policies, deterministic order."""
    return [MappingPolicy(pe_order=po, placement=pl, route_axis=ra)
            for pl in PLACEMENTS
            for po in ("row_major", "reversed")
            for ra in ROUTE_AXES]


def policy_stream(seed: int = 0):
    """Infinite deterministic policy generator: the canonical lattice
    first, then seeded shuffles cycling placement x route_axis."""
    for p in canonical_policies():
        yield p
    rng = np.random.default_rng(seed)
    j = 0
    while True:
        yield MappingPolicy(pe_order="shuffled",
                            placement=PLACEMENTS[j % 2],
                            route_axis=ROUTE_AXES[(j // 2) % 2],
                            seed=int(rng.integers(0, 2**31 - 1)))
        j += 1


def mutate_policy(policy: MappingPolicy,
                  rng: np.random.Generator) -> MappingPolicy:
    """Flip one knob (or re-seed the shuffle) -- the search driver's
    neighbourhood move."""
    knob = int(rng.integers(0, 4))
    if knob == 0:
        choices = [o for o in PE_ORDERS if o != policy.pe_order]
        new = choices[int(rng.integers(0, len(choices)))]
        return dataclasses.replace(
            policy, pe_order=new,
            seed=int(rng.integers(0, 2**31 - 1)) if new == "shuffled"
            else policy.seed)
    if knob == 1:
        return dataclasses.replace(
            policy,
            placement=("spread" if policy.placement == "chain"
                       else "chain"))
    if knob == 2:
        return dataclasses.replace(
            policy,
            route_axis=("row_first" if policy.route_axis == "col_first"
                        else "col_first"))
    return dataclasses.replace(policy, pe_order="shuffled",
                               seed=int(rng.integers(0, 2**31 - 1)))


# ---------------------------------------------------------------------------
# Mapper
# ---------------------------------------------------------------------------

class MappingError(RuntimeError):
    pass


def _levels(dag: DAG) -> List[int]:
    lvl = [0] * len(dag.nodes)
    for i, n in enumerate(dag.nodes):
        lvl[i] = 1 + max((lvl[a] for a in n.args), default=-1)
    return lvl


def _node_desc(dag: DAG, node: int,
               levels: Optional[Sequence[int]] = None) -> str:
    """'node 7 (SMUL, level 3)' -- the context every MappingError
    carries so a failure inside a k-candidate enumeration is
    attributable without re-running the mapper under a debugger."""
    if not (0 <= node < len(dag.nodes)):
        return f"node {node}"
    op = dag.nodes[node].op
    lvl = (levels[node] if levels is not None
           else _levels(dag)[node])
    return f"node {node} ({op}, level {lvl})"


def _torus_step(pe: int, target: int, rows: int, cols: int,
                route_axis: str = "col_first") -> int:
    """One wrap-aware hop from `pe` toward `target`; the policy's
    route_axis breaks the tie between the two shortest-path families."""
    r, c = pe // cols, pe % cols
    tr, tc = target // cols, target % cols

    def col_hop():
        nonlocal c
        d = (tc - c) % cols
        c = (c + 1) % cols if d <= cols - d else (c - 1) % cols

    def row_hop():
        nonlocal r
        d = (tr - r) % rows
        r = (r + 1) % rows if d <= rows - d else (r - 1) % rows

    if route_axis == "row_first":
        if r != tr:
            row_hop()
        elif c != tc:
            col_hop()
    else:
        if c != tc:
            col_hop()
        elif r != tr:
            row_hop()
    return r * cols + c


def map_dag(dag: DAG, *, rows: int = 4, cols: int = 4,
            name: str = "mapped",
            policy: Optional[MappingPolicy] = None) -> Program:
    """Greedy level scheduler with torus routing, parameterised by a
    ``MappingPolicy``.

    Every produced value with downstream consumers is parked in a
    register on its producer PE; cross-PE reads go through ROUT (fresh
    value or register restore) plus inserted MV hop instructions along a
    wrap-aware torus route.  Returns a Program ending in EXIT."""
    policy = policy or MappingPolicy()
    P = rows * cols
    scan = policy.scan_order(P)
    nbr = isa.neighbour_index_maps(rows, cols)
    port_of: Dict[Tuple[int, int], str] = {}
    for pname, m in nbr.items():
        for p in range(P):
            port_of[(p, int(m[p]))] = pname

    levels = _levels(dag)
    by_level: Dict[int, List[int]] = {}
    for i, l in enumerate(levels):
        by_level.setdefault(l, []).append(i)
    n_levels = max(levels) + 1 if levels else 0

    def desc(i: int) -> str:
        return _node_desc(dag, i, levels)

    remaining_uses = [0] * len(dag.nodes)
    for n in dag.nodes:
        for a in n.args:
            remaining_uses[a] += 1

    pb = ProgramBuilder(P, name)
    reg_locs: Dict[int, List[Tuple[int, int]]] = {}   # node -> [(pe, reg)]
    regs_free: Dict[int, List[int]] = {p: [0, 1, 2, 3] for p in range(P)}
    rout_holder: Dict[int, Optional[int]] = {p: None for p in range(P)}
    place_pe: Dict[int, int] = {}
    temp_parked: List[Tuple[int, int, int]] = []      # (node, pe, reg)

    def reg_on(node: int, pe: int) -> Optional[int]:
        for (q, r) in reg_locs.get(node, ()):
            if q == pe:
                return r
        return None

    def readable(node: int, pe: int) -> Optional[Tuple[str, int]]:
        n = dag.nodes[node]
        if n.op == "const":
            return "IMM", n.imm
        r = reg_on(node, pe)
        if r is not None:
            return f"R{r}", 0
        if rout_holder.get(pe) == node:
            return "ROUT", 0
        for q in range(P):
            if rout_holder.get(q) == node and (pe, q) in port_of:
                return port_of[(pe, q)], 0
        return None

    def _alloc(pe: int, node: int) -> int:
        if not regs_free[pe]:
            raise MappingError(
                f"register pressure >4 on PE {pe} while parking "
                f"{desc(node)}: all of R0..R3 hold live values -- tile "
                f"the kernel or reduce fan-out")
        return regs_free[pe].pop(0)

    def route_to(node: int, pe: int):
        """Make `node` *clobber-proof* readable from `pe`: unless it is a
        const or already in a register there, hop its value onto `pe` and
        park it in a temp register (later routing cannot disturb it)."""
        n = dag.nodes[node]
        if n.op == "const" or reg_on(node, pe) is not None:
            return
        # locate the value in some ROUT or restore from its home register
        cur = None
        for q in range(P):
            if rout_holder.get(q) == node:
                cur = q
                break
        if cur is None:
            locs = reg_locs.get(node)
            if not locs:
                raise MappingError(
                    f"value of {desc(node)} lost while routing to PE "
                    f"{pe}: no register or ROUT holds it (mapper "
                    f"invariant violated)")
            rpe, r = locs[0]
            pb.instr({rpe: asm("MV", "ROUT", f"R{r}")})
            rout_holder[rpe] = node
            cur = rpe
        guard = 0
        while cur != pe:
            guard += 1
            if guard > 2 * (rows + cols):
                raise MappingError(
                    f"routing stuck for {desc(node)}: exceeded "
                    f"{2 * (rows + cols)} hops from PE {cur} toward PE "
                    f"{pe} on a {rows}x{cols} torus "
                    f"(route_axis={policy.route_axis!r})")
            hop = _torus_step(cur, pe, rows, cols, policy.route_axis)
            pb.instr({hop: asm("MV", "ROUT", port_of[(hop, cur)])})
            rout_holder[hop] = node
            cur = hop
        r = _alloc(pe, node)
        pb.instr({pe: asm("MV", f"R{r}", "ROUT")})
        rout_holder[pe] = node
        reg_locs.setdefault(node, []).append((pe, r))
        temp_parked.append((node, pe, r))

    def choose_pe(i: int, used: Set[int]) -> int:
        prefs = []
        for a in dag.nodes[i].args:
            if dag.nodes[a].op == "const":
                continue
            locs = reg_locs.get(a)
            if locs:
                prefs.append(locs[0][0])
            elif a in place_pe:
                prefs.append(place_pe[a])
        same_pe = [p for p in prefs if p not in used]
        adjacent = [q for p in prefs for q in scan
                    if q not in used and (q, p) in port_of]
        if policy.placement == "chain":
            ordered = same_pe + adjacent
        else:            # spread: neighbour-port reads before chaining
            ordered = adjacent + same_pe
        for q in ordered:
            return q
        for q in scan:
            if q not in used:
                return q
        raise MappingError(
            f"no free PE for {desc(i)}: all {P} PEs of the "
            f"{rows}x{cols} array are used in this group")

    # levels wider than the array are time-multiplexed: split into groups
    # of <= P nodes (same level => independent, and all cross-group values
    # are register-parked, so splitting is always safe)
    groups: List[List[int]] = []
    for lvl in range(n_levels):
        level_nodes = [i for i in by_level.get(lvl, [])
                       if dag.nodes[i].op != "const"]
        for g0 in range(0, len(level_nodes), P):
            groups.append(level_nodes[g0:g0 + P])

    for nodes in groups:
        if not nodes:
            continue
        used: Set[int] = set()
        placed: List[Tuple[int, int]] = []
        for i in nodes:
            pe = choose_pe(i, used)
            used.add(pe)
            place_pe[i] = pe
            placed.append((i, pe))
        # route every operand into clobber-proof reach on its consumer PE
        # -- EXCEPT same-PE fresh ROUT chains, which only hold if nothing
        # else routes afterwards; conservatively park those too.
        temp_parked.clear()
        for i, pe in placed:
            for a in dag.nodes[i].args:
                if dag.nodes[a].op != "const":
                    route_to(a, pe)
        # emit the compute instruction
        slots: Dict[int, PEInstr] = {}
        for i, pe in placed:
            n = dag.nodes[i]
            if n.op == "load":
                slots[pe] = asm("LWD", "ROUT", imm=n.imm)
            elif n.op == "store":
                src, _ = readable(n.args[0], pe)
                slots[pe] = asm("SWD", a=src, imm=n.imm)
            else:
                sa, ia = readable(n.args[0], pe)
                sb, ib = readable(n.args[1], pe)
                slots[pe] = PEInstr(OP[n.op], isa.DEST_ROUT_ONLY,
                                    isa.SRC[sa], isa.SRC[sb], ia or ib)
        # park produced values that have consumers
        for i, pe in placed:
            if dag.nodes[i].op == "store":
                continue
            if remaining_uses[i] > 0:
                r = _alloc(pe, i)
                reg_locs.setdefault(i, []).append((pe, r))
                s = slots[pe]
                slots[pe] = PEInstr(s.op, isa.DEST[f"R{r}"], s.srcA,
                                    s.srcB, s.imm)
        pb.instr(slots)
        for i, pe in placed:
            if dag.nodes[i].op != "store":
                rout_holder[pe] = i
        # free temp copies, consume operand uses, free dead home registers
        for (node, pe, r) in temp_parked:
            reg_locs[node].remove((pe, r))
            regs_free[pe].append(r)
        temp_parked.clear()
        for i, _ in placed:
            for a in dag.nodes[i].args:
                if dag.nodes[a].op == "const":
                    continue
                remaining_uses[a] -= 1
                if remaining_uses[a] == 0:
                    for (q, r) in reg_locs.pop(a, ()):
                        regs_free[q].append(r)
    pb.exit()
    return pb.build()


def map_and_verify(dag: DAG, mem_init: np.ndarray, *, hw=None,
                   device=None, **kw):
    """Map, simulate, and check against the DAG oracle.  Returns
    (program, final_mem, ok).  ``hw`` (an HwConfig) is forwarded to the
    simulator so functional equivalence can be asserted on every
    topology, not just the baseline.  The simulator runs on ``device``
    (the CUDA device unless the caller names another)."""
    from .cgra import run_program
    prog = map_dag(dag, **kw)
    final, _ = run_program(prog, mem_init, hw=hw,
                           max_steps=prog.n_instrs + 2, device=device)
    want = dag.evaluate(np.asarray(mem_init))
    got = final.mem.cpu().numpy()
    return prog, got, bool((got == want).all())


# ---------------------------------------------------------------------------
# Candidate enumeration
# ---------------------------------------------------------------------------

class MappingCandidate(NamedTuple):
    """A verified (program, policy) pair from the candidate generator."""
    program: Program
    policy: MappingPolicy


def _program_key(prog: Program) -> bytes:
    """Content hash for dedup: two policies that happen to emit the same
    instruction stream are ONE candidate."""
    return b"".join(np.ascontiguousarray(a).tobytes()
                    for a in (prog.ops, prog.dest, prog.srcA,
                              prog.srcB, prog.imm))


def _probe_mem(dag: DAG, mem_size: int = 4096,
               seed: int = 0) -> np.ndarray:
    """Deterministic verification image covering every load/store
    address with non-degenerate values."""
    hi = max((n.imm for n in dag.nodes if n.op in ("load", "store")),
             default=0)
    size = max(mem_size, hi + 1)
    rng = np.random.default_rng(seed ^ 0x5EED)
    return rng.integers(-100, 100, size=size, dtype=np.int32)


def generate_candidates(dag: DAG, k: int, seed: int = 0, *,
                        rows: int = 4, cols: int = 4,
                        name: str = "mapped",
                        policies: Optional[Sequence[MappingPolicy]] = None,
                        verify: bool = True,
                        mem_probe: Optional[np.ndarray] = None,
                        max_attempts: Optional[int] = None,
                        device=None,
                        ) -> List[MappingCandidate]:
    """Up to ``k`` distinct, individually verified schedules of ``dag``.

    Walks ``policies`` (default: the deterministic ``policy_stream``),
    maps under each, drops duplicates (by instruction-stream content) and
    policies that fail to map (register pressure etc. -- some corners of
    the policy space are legitimately infeasible), and, when ``verify``,
    simulates each survivor against ``DAG.evaluate`` on a seeded probe
    image, on ``device`` (the CUDA device unless the caller names
    another).  Candidate ``j`` is named ``f"{name}#m{j}"`` so a flattened
    candidate set has unique per-program names (the service's trip-count
    history is keyed by name).

    Raises MappingError if not even one candidate maps."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if policies is None:
        src = policy_stream(seed)
        budget = max_attempts if max_attempts is not None else 4 * k + 8
    else:
        src = iter(policies)
        budget = max_attempts if max_attempts is not None else len(policies)
    probe = (mem_probe if mem_probe is not None
             else (_probe_mem(dag, seed=seed) if verify else None))
    want = dag.evaluate(np.asarray(probe)) if verify else None

    out: List[MappingCandidate] = []
    seen: Set[bytes] = set()
    errors: List[str] = []
    attempts = 0
    for pol in src:
        if len(out) >= k or attempts >= budget:
            break
        attempts += 1
        try:
            prog = map_dag(dag, rows=rows, cols=cols,
                           name=f"{name}#m{len(out)}", policy=pol)
        except MappingError as e:
            errors.append(f"{pol}: {e}")
            continue
        key = _program_key(prog)
        if key in seen:
            continue
        if verify:
            from .cgra import run_program
            final, _ = run_program(prog, probe,
                                   max_steps=prog.n_instrs + 2,
                                   device=device)
            if not (final.mem.cpu().numpy() == want).all():
                raise MappingError(
                    f"candidate under {pol} diverges from DAG.evaluate "
                    f"-- mapper bug, not a search miss")
        seen.add(key)
        out.append(MappingCandidate(prog, pol))
    if not out:
        detail = f"; first failure: {errors[0]}" if errors else ""
        raise MappingError(
            f"no feasible mapping in {attempts} policy attempts for a "
            f"{len(dag.nodes)}-node DAG on a {rows}x{cols} array"
            f"{detail}")
    return out


def enumerate_mappings(dag: DAG, k: int, seed: int = 0,
                       **kw) -> List[Program]:
    """The tentpole entry point: up to ``k`` distinct verified Programs
    for ``dag`` (see ``generate_candidates`` for knobs and guarantees)."""
    return [c.program for c in generate_candidates(dag, k, seed, **kw)]
