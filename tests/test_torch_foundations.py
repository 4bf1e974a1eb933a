"""Foundations of the PyTorch port against the JAX reference.

The framework-free modules are byte-identical copies of the reference's
(pinned here); the program tables, packing, bucket plans and hardware
topologies built by the port must equal the reference's for every
application kernel; the port and chip_smoke.py must not import jax or
the reference package; and the carry-across helpers (convert.py) must
reproduce the reference objects exactly.
"""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.apps import conv as ref_conv, mibench as ref_mibench  # noqa: E402
from repro.core import hwconfig as ref_hw, program as ref_program  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.apps import conv, mibench  # noqa: E402
from repro_torch.core import hwconfig, program  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
COPIES = ["core/isa.py", "core/program.py", "core/physical.py",
          "core/trace.py", "core/detailed.py", "apps/__init__.py",
          "apps/common.py", "apps/mibench.py", "apps/conv.py"]


def _kernel_pairs():
    ref = ref_mibench.all_kernels() + ref_conv.all_mappings()
    port = mibench.all_kernels() + conv.all_mappings()
    return list(zip(ref, port))


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_is_identical_to_reference(rel):
    ref = (ROOT / "src" / "repro" / rel).read_bytes()
    assert (PORT / rel).read_bytes() == ref, (
        f"{rel} drifted from the reference; re-copy it")


def test_kernel_programs_and_images_match():
    for rk, pk in _kernel_pairs():
        assert rk.name == pk.name and rk.max_steps == pk.max_steps
        for f in ("ops", "dest", "srcA", "srcB", "imm"):
            np.testing.assert_array_equal(getattr(rk.program, f),
                                          getattr(pk.program, f))
        np.testing.assert_array_equal(rk.mem_init, pk.mem_init)


def test_fused_rows_match_reference():
    for rk, pk in _kernel_pairs():
        want = ref_program.fused_rows(ref_program.program_tables(rk.program))
        got = program.fused_rows(program.program_tables(pk.program))
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_pack_programs_and_batch_tables_match():
    pairs = _kernel_pairs()
    rb = ref_program.pack_programs([r.program for r, _ in pairs])
    pb = program.pack_programs([p.program for _, p in pairs])
    assert rb.names == pb.names
    for f in ("ops", "dest", "srcA", "srcB", "imm", "n_instrs"):
        np.testing.assert_array_equal(getattr(pb, f), getattr(rb, f))
    np.testing.assert_array_equal(
        program.fused_rows(program.batch_tables(pb)),
        ref_program.fused_rows(ref_program.batch_tables(rb)))


@pytest.mark.parametrize("max_buckets", [1, 2, 3, 4, 9])
def test_bucket_plans_match(max_buckets):
    pairs = _kernel_pairs()
    rbk = ref_program.bucket_programs([r.program for r, _ in pairs],
                                      max_buckets)
    pbk = program.bucket_programs([p.program for _, p in pairs],
                                  max_buckets)
    assert pbk.groups == rbk.groups
    np.testing.assert_array_equal(pbk.assignment, rbk.assignment)
    assert [b.t_max for b in pbk.batches] == [b.t_max for b in rbk.batches]


@pytest.mark.parametrize("name", sorted(ref_hw.TOPOLOGIES))
def test_topologies_match(name):
    want = ref_hw.TOPOLOGIES[name]()
    got = hwconfig.TOPOLOGIES[name]()
    for f in ref_hw.HwConfig.FIELDS:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f)
        float_field = f in ("smul_power_scale", "t_clk_ns")
        assert g.dtype == (torch.float32 if float_field else torch.int32)
        assert g.item() == w.item(), f


def test_stack_configs_matches_reference_dtypes_and_values():
    names = sorted(ref_hw.TOPOLOGIES)
    want = ref_hw.stack_configs([ref_hw.TOPOLOGIES[n]() for n in names])
    got = hwconfig.stack_configs([hwconfig.TOPOLOGIES[n]() for n in names])
    for f in ref_hw.HwConfig.FIELDS:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w)


def test_hwconfig_replace_and_to():
    hw = hwconfig.baseline().replace(n_banks=8, smul_power_scale=2)
    assert hw.n_banks.dtype == torch.int32 and int(hw.n_banks) == 8
    assert hw.smul_power_scale.dtype == torch.float32
    moved = hw.to("cpu")
    assert moved.as_dict().keys() == hw.as_dict().keys()


def test_convert_profile_program_hwconfig(profile):
    prof = convert.profile_from_numpy(dataclasses.asdict(profile))
    for f in dataclasses.fields(profile):
        w, g = getattr(profile, f.name), getattr(prof, f.name)
        assert type(g) is type(w), f.name
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    rk = ref_mibench.all_kernels()[1]
    prog = convert.program_from_numpy(dataclasses.asdict(rk.program))
    np.testing.assert_array_equal(program.fused_rows(
        program.program_tables(prog)), ref_program.fused_rows(
        ref_program.program_tables(rk.program)))
    hws = ref_hw.stack_configs([f() for f in ref_hw.TOPOLOGIES.values()])
    got = convert.hwconfig_from_numpy(hws.as_dict())
    for f in ref_hw.HwConfig.FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(hws, f)))


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = [(str(p.relative_to(ROOT)), m) for p in files for m in _imports(p)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_entry_points_raise_without_cuda_unless_cpu_named():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from repro_torch.device import resolve_device
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
