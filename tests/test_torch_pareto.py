"""The port's on-device top-k / Pareto reduction against the reference.

``repro_torch.analysis.pareto.make_device_reducer`` (PyTorch, run here on
the CPU) must be bit-identical to the reference's numpy oracle
``repro.analysis.pareto.reduce_oracle`` and to the reference's jitted
device reducer: every field of the ``ReducedResult``, float bits
included.  The inputs carry heavy ties, exact duplicates, ``-0.0``
beside ``0.0``, masked lanes (``lane_idx = -1``), flat indices out of
lane order and empty segments; Pareto fronts overflow ``max_points``
(``clipped``).  The numpy parts of the module (merge, remap, fold, wire
codecs) must give the reference's answers.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.analysis import pareto as ref  # noqa: E402
from repro_torch.analysis import pareto  # noqa: E402

SPECS = [pareto.TopK("latency_cc", k=5), pareto.TopK("energy_pj", k=3),
         pareto.TopK("power_mw", k=2), pareto.TopK("edp", k=4),
         pareto.ParetoFront(axes=("latency_cc", "energy_pj"), max_points=8),
         pareto.ParetoFront(axes=("energy_pj", "power_mw"), max_points=5),
         pareto.ParetoFront(axes=("edp", "latency_cc"), max_points=2)]
IDS = [pareto.spec_to_str(s) for s in SPECS]


def _ref_spec(spec):
    return ref.spec_from_str(pareto.spec_to_str(spec))


def _rand_fields(rng, B):
    """Sweep-result quintet with heavy ties, duplicate points and -0.0."""
    energy = (rng.integers(-3, 10, B) * 0.5).astype(np.float32)
    energy[rng.random(B) < 0.2] = -0.0
    return (rng.integers(1, 12, B).astype(np.int32),          # latency_cc
            energy,                                           # energy_pj
            (rng.integers(1, 6, B) * 0.25).astype(np.float32),  # power_mw
            rng.integers(-5, 5, B).astype(np.int32),          # checksum
            rng.integers(1, 99, B).astype(np.int32))          # steps


def _rand_case(rng, B, G):
    fields = _rand_fields(rng, B)
    prog = rng.integers(0, G, B).astype(np.int32)
    prog[prog == G - 1] = 0                  # one empty segment sometimes
    lane = rng.permutation(B).astype(np.int32)
    lane[rng.random(B) < 0.2] = -1           # masked pad lanes
    return fields, prog, lane


def _port_reduce(spec, fields, prog, lane, G):
    got = pareto.reduce_on_device(spec, [torch.as_tensor(f) for f in fields],
                                  torch.as_tensor(prog),
                                  torch.as_tensor(lane), G)
    assert all(isinstance(x, torch.Tensor) for x in got)
    return pareto._as_numpy(got)


def _assert_bits_equal(got, want, msg=""):
    """Every field equal, dtype and float bits included (-0.0 != 0.0)."""
    for f in ref.REDUCED_FIELDS:
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, f"{msg}{f}"
        assert g.tobytes() == w.tobytes(), f"{msg}{f}: {g} != {w}"


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_device_reducer_matches_reference_oracle(spec):
    """Random grids of 1-90 lanes in 1-5 segments."""
    rng = np.random.default_rng(7)
    for trial in range(40):
        B, G = int(rng.integers(1, 90)), int(rng.integers(1, 6))
        fields, prog, lane = _rand_case(rng, B, G)
        want = ref.reduce_oracle(_ref_spec(spec), fields, prog, lane, G)
        _assert_bits_equal(_port_reduce(spec, fields, prog, lane, G), want,
                           f"trial {trial}: ")


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_device_reducer_matches_reference_device_reducer(spec):
    """One shape (one jit compile of the reference) over 8 seeded grids."""
    rng = np.random.default_rng(3)
    fn = ref.make_device_reducer(_ref_spec(spec), 3)
    for trial in range(8):
        fields, prog, lane = _rand_case(rng, 64, 3)
        want = fn(tuple(fields), prog, lane)
        _assert_bits_equal(_port_reduce(spec, fields, prog, lane, 3), want,
                           f"trial {trial}: ")


def test_pareto_overflow_is_clipped_like_reference():
    """A front of 6 points per segment under max_points=4."""
    spec = pareto.ParetoFront(axes=("latency_cc", "energy_pj"),
                              max_points=4)
    lat = np.tile(np.arange(1, 7, dtype=np.int32), 2)
    en = np.tile(np.arange(6, 0, -1).astype(np.float32), 2)
    fields = (lat, en, np.ones(12, np.float32), np.zeros(12, np.int32),
              np.ones(12, np.int32))
    prog = np.repeat(np.arange(2, dtype=np.int32), 6)
    lane = np.arange(12, dtype=np.int32)
    want = ref.reduce_oracle(_ref_spec(spec), fields, prog, lane, 2)
    got = _port_reduce(spec, fields, prog, lane, 2)
    _assert_bits_equal(got, want)
    np.testing.assert_array_equal(got.clipped, [2, 2])
    np.testing.assert_array_equal(got.count, [4, 4])


def test_duplicate_front_points_both_kept():
    """Exact duplicates of a Pareto point are not dominated -- both stay,
    ordered by ascending lane index; -0.0 and 0.0 tie the same way."""
    spec = pareto.ParetoFront(axes=("latency_cc", "energy_pj"),
                              max_points=8)
    lat = np.array([5, 5, 9, 9], np.int32)
    en = np.array([2.0, 2.0, -0.0, 0.0], np.float32)
    fields = (lat, en, np.zeros(4, np.float32), np.zeros(4, np.int32),
              np.zeros(4, np.int32))
    prog = np.zeros(4, np.int32)
    lane = np.array([3, 1, 2, 0], np.int32)
    want = ref.reduce_oracle(_ref_spec(spec), fields, prog, lane, 1)
    got = _port_reduce(spec, fields, prog, lane, 1)
    _assert_bits_equal(got, want)
    np.testing.assert_array_equal(got.indices[0, :4], [1, 3, 0, 2])
    top = pareto.TopK("energy_pj", k=2)
    _assert_bits_equal(_port_reduce(top, fields, prog, lane, 1),
                       ref.reduce_oracle(_ref_spec(top), fields, prog,
                                         lane, 1))


def test_port_oracle_and_specs_equal_reference():
    rng = np.random.default_rng(5)
    fields, prog, lane = _rand_case(rng, 50, 3)
    for spec in SPECS:
        assert pareto.reduced_nbytes(3, spec) == \
            ref.reduced_nbytes(3, _ref_spec(spec))
        assert pareto.spec_from_str(pareto.spec_to_str(spec)) == spec
        _assert_bits_equal(
            pareto.reduce_oracle(spec, fields, prog, lane, 3),
            ref.reduce_oracle(_ref_spec(spec), fields, prog, lane, 3))
    with pytest.raises(ValueError, match="objective"):
        pareto.TopK("watts", 3)
    with pytest.raises(ValueError, match="unknown reduction"):
        pareto.spec_from_str("median:edp:3")


@pytest.mark.parametrize("spec", [SPECS[3], SPECS[4]], ids=IDS[3:5])
def test_merge_is_associative_and_matches_reference(spec):
    rng = np.random.default_rng(11)
    B, G = 60, 3
    fields = _rand_fields(rng, B)
    prog = rng.integers(0, G, B).astype(np.int32)
    lane = np.arange(B, dtype=np.int32)
    mono = ref.reduce_oracle(_ref_spec(spec), fields, prog, lane, G)
    cuts = [0, 20, 45, B]
    parts = []
    for lo, hi in zip(cuts, cuts[1:]):
        sub = np.full(B, -1, np.int32)
        sub[lo:hi] = lane[lo:hi]
        parts.append(pareto.reduce_on_device(
            spec, [torch.as_tensor(f) for f in fields],
            torch.as_tensor(prog), torch.as_tensor(sub), G))
    host = [pareto._as_numpy(p) for p in parts]
    left = pareto.merge_reduced(
        spec, [pareto.merge_reduced(spec, host[:2]), host[2]])
    right = pareto.merge_reduced(
        spec, [host[0], pareto.merge_reduced(spec, host[1:])])
    flat = pareto.merge_reduced(spec, host)
    for got in (left, right, flat):
        _assert_bits_equal(got, ref.merge_reduced(
            _ref_spec(spec), [ref.ReducedResult(*p) for p in host]))
    if not int(mono.clipped.sum()):
        _assert_bits_equal(flat, mono)
    # idempotent: a re-delivered part changes nothing
    _assert_bits_equal(pareto.merge_reduced(spec, host + host[:1]), flat)


def test_remap_fold_and_wire_codecs_match_reference():
    rng = np.random.default_rng(2)
    spec = pareto.TopK("edp", 3)
    fields, prog, lane = _rand_case(rng, 40, 4)
    part = _port_reduce(spec, fields, prog, lane, 4)
    rpart = ref.ReducedResult(*part)
    _assert_bits_equal(
        pareto.remap_segments(part, [3, 0, 5, 1], [100, 0, 7, 9], 6),
        ref.remap_segments(rpart, [3, 0, 5, 1], [100, 0, 7, 9], 6))
    _assert_bits_equal(
        pareto.fold_segments(spec, part, [1, 0, 1, 0], 2),
        ref.fold_segments(ref.TopK("edp", 3), rpart, [1, 0, 1, 0], 2))
    wire = pareto.reduced_to_wire(part)
    assert wire == ref.reduced_to_wire(rpart)
    _assert_bits_equal(pareto.reduced_from_wire(wire), part)
    # a tensor result encodes like its host copy
    dev = pareto.reduce_on_device(spec, [torch.as_tensor(f) for f in fields],
                                  torch.as_tensor(prog),
                                  torch.as_tensor(lane), 4)
    assert pareto.reduced_to_wire(dev) == wire


def test_objective_values_on_tensors_and_arrays():
    rng = np.random.default_rng(4)
    fields = _rand_fields(rng, 30)
    tens = [torch.as_tensor(f) for f in fields]
    for name in pareto.OBJECTIVES:
        want = ref.objective_values(name, fields)
        got_np = pareto.objective_values(name, fields)
        got_t = pareto.objective_values(name, tens)
        assert got_t.dtype == torch.float32 and got_np.dtype == np.float32
        assert got_np.tobytes() == want.tobytes()
        assert got_t.numpy().tobytes() == want.tobytes()
