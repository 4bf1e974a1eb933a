"""The port's mapper, mapping search and bitstream against the reference.

Seeded DAGs go through both packages' ``generate_candidates`` and must
give the same candidate instruction streams (``_program_key``), policies
and names; ``map_and_verify`` the same program and final memory;
``bitstream.encode`` the same bytes; and ``search_mappings`` the same
per-round candidate counts, survivors, winners and front, scores and
front energies within rtol=1e-5 (the bound the reference sets between
its two backends), everything else bit for bit.  The port verifies its
candidates with its own simulator on the CPU (``device="cpu"``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.apps import mibench as ref_mibench  # noqa: E402
from repro.core import bitstream as ref_bitstream  # noqa: E402
from repro.core import dse as ref_dse, hwconfig as ref_hw  # noqa: E402
from repro.core import mapper as ref_mapper  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.analysis import pareto  # noqa: E402
from repro_torch.apps import mibench  # noqa: E402
from repro_torch.core import bitstream, dse, hwconfig, mapper  # noqa: E402
from repro_torch.core.cgra import run_program  # noqa: E402

MEM = 128
MAX_STEPS = 128
KNOBS = dict(chunk_steps=64, blk_b=32, max_buckets=4)


def _axpy(mod, n):
    d = mod.DAG()
    w = d.const(3 + n)
    for j in range(4 + n):
        t = d.alu("SMUL", d.load(j), w)
        t = d.alu("SADD", t, d.load(16 + j))
        d.store(32 + j, d.alu("SRA", t, d.const(2)))
    return d


def _sad_tree(mod, n):
    """sum |a[j] - b[j]| via SLT-based abs and an add tree."""
    d = mod.DAG()
    terms = []
    for j in range(n):
        a, b = d.load(j), d.load(32 + j)
        diff = d.alu("SSUB", a, b)
        neg = d.alu("SSUB", d.const(0), diff)
        is_neg = d.alu("SLT", diff, d.const(0))
        keep = d.alu("SMUL", diff, d.alu("LXOR", is_neg, d.const(1)))
        flip = d.alu("SMUL", neg, is_neg)
        terms.append(d.alu("SADD", keep, flip))
    while len(terms) > 1:
        terms = [d.alu("SADD", terms[i], terms[i + 1])
                 for i in range(0, len(terms) - 1, 2)] + \
                (terms[-1:] if len(terms) % 2 else [])
    d.store(100, terms[0])
    return d


DAGS = {"axpy0": lambda m: _axpy(m, 0), "axpy2": lambda m: _axpy(m, 2),
        "sad3": lambda m: _sad_tree(m, 3)}


def _key(prog):
    return mapper._program_key(prog)


def _assert_same_candidates(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _key(g.program) == ref_mapper._program_key(w.program)
        assert g.program.name == w.program.name
        assert dataclasses.asdict(g.policy) == dataclasses.asdict(w.policy)


@pytest.mark.parametrize("name", sorted(DAGS))
def test_generate_candidates_matches_reference(name):
    want = ref_mapper.generate_candidates(DAGS[name](ref_mapper), 4, seed=3,
                                          name=name)
    got = mapper.generate_candidates(DAGS[name](mapper), 4, seed=3,
                                     name=name, device="cpu")
    assert len(got) >= 2
    _assert_same_candidates(got, want)
    # explicit policies, as search_mappings hands them over
    pols = [c.policy for c in want[::-1]]
    _assert_same_candidates(
        mapper.generate_candidates(DAGS[name](mapper), 3, name=name,
                                   policies=[mapper.MappingPolicy(
                                       **dataclasses.asdict(p))
                                       for p in pols], device="cpu"),
        ref_mapper.generate_candidates(DAGS[name](ref_mapper), 3,
                                       name=name, policies=pols))


def test_map_and_verify_and_bitstream_match_reference():
    rng = np.random.default_rng(1)
    mem = rng.integers(-100, 100, 4096).astype(np.int32)
    for name, build in DAGS.items():
        rp, rmem, rok = ref_mapper.map_and_verify(build(ref_mapper), mem)
        pp, pmem, pok = mapper.map_and_verify(build(mapper), mem,
                                              device="cpu")
        assert rok and pok, name
        assert _key(pp) == ref_mapper._program_key(rp), name
        np.testing.assert_array_equal(pmem, rmem, err_msg=name)
        blob = bitstream.encode(pp)
        assert blob == ref_bitstream.encode(rp), name
        assert _key(bitstream.decode(blob)) == _key(pp), name
    for rk, pk in zip(ref_mibench.all_kernels(), mibench.all_kernels()):
        assert bitstream.encode(pk.program) == ref_bitstream.encode(
            rk.program), pk.name


def test_verification_runs_on_the_card_unless_cpu_named():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mapper.generate_candidates(DAGS["axpy0"](mapper), 2)


@pytest.fixture(scope="module")
def search(profile):
    rng = np.random.default_rng(0)
    mems = rng.integers(-100, 100, (2, MEM)).astype(np.int32)
    kw = dict(k=4, keep=2, rounds=2, seed=0, objective="edp",
              names=["axpy", "sad"], max_steps=MAX_STEPS, mem_size=MEM,
              **KNOBS)
    want = ref_dse.search_mappings(
        [DAGS["axpy2"](ref_mapper), DAGS["sad3"](ref_mapper)], profile,
        [ref_hw.baseline(), ref_hw.TOPOLOGIES["d_dma_per_pe"]()], mems,
        backend="xla", **kw)
    got = dse.search_mappings(
        [DAGS["axpy2"](mapper), DAGS["sad3"](mapper)],
        convert.profile_from_numpy(dataclasses.asdict(profile)),
        [hwconfig.baseline(), hwconfig.TOPOLOGIES["d_dma_per_pe"]()], mems,
        device="cpu", **kw)
    return got, want, mems


def test_search_mappings_matches_reference(search):
    got, want, _ = search
    assert len(got.history) == len(want.history) == 2
    for g_row, w_row in zip(got.history, want.history):
        assert g_row["round"] == w_row["round"]
        assert g_row["n_candidates"] == w_row["n_candidates"]
        for f in ("best", "worst"):
            np.testing.assert_allclose(g_row[f], w_row[f], rtol=1e-5)
    for gp, wp in zip(got.best, want.best):
        assert _key(gp) == ref_mapper._program_key(wp)
        assert gp.name == wp.name
    assert [dataclasses.asdict(p) for p in got.best_policy] == \
        [dataclasses.asdict(p) for p in want.best_policy]
    np.testing.assert_allclose(got.best_score, want.best_score, rtol=1e-5)
    assert [_key(p) for p in got.mappings.programs] == \
        [ref_mapper._program_key(p) for p in want.mappings.programs]
    np.testing.assert_array_equal(got.mappings.kernel_of,
                                  want.mappings.kernel_of)
    for f in pareto.REDUCED_FIELDS:
        g, w = getattr(got.front, f), np.asarray(getattr(want.front, f))
        assert g.dtype == w.dtype, f
        if f in ("energy_pj", "power_mw"):
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)


def test_search_winners_are_verified_and_front_folds(search, profile):
    got, _, mems = search
    for g, build in enumerate((DAGS["axpy2"], DAGS["sad3"])):
        prog = got.best[g]
        final, _ = run_program(prog, mems[0], max_steps=prog.n_instrs + 2,
                               mem_size=MEM, device="cpu")
        np.testing.assert_array_equal(final.mem.numpy(),
                                      build(mapper).evaluate(mems[0]))
        per_round = [row["best"][g] for row in got.history]
        assert got.best_score[g] <= min(per_round) + 1e-6
    # the front is the fold of the unfolded per-candidate sweep
    spec = pareto.TopK("edp", 2)
    kw = dict(profile=convert.profile_from_numpy(dataclasses.asdict(profile)),
              hw_configs=[hwconfig.baseline(),
                          hwconfig.TOPOLOGIES["d_dma_per_pe"]()],
              mem_images=mems, max_steps=MAX_STEPS, mem_size=MEM,
              device="cpu", **KNOBS)
    unfolded = dse.sweep(mappings=got.mappings, reduce=spec,
                         fold_mappings=False, **kw)
    folded = pareto.fold_segments(spec, unfolded, got.mappings.kernel_of,
                                  got.mappings.n_kernels)
    for f in pareto.REDUCED_FIELDS:
        assert getattr(folded, f).tobytes() == \
            getattr(got.front, f).tobytes(), f
