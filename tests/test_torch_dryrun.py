"""The port's dry-run contract, dry-run and roofline against the
reference's.

``Model.cache_axes`` and ``Model.input_specs`` of every full-size
architecture at every shape agree with the reference's axes, shapes and
types (meta tensors against ShapeDtypeStructs).  The roofline's pure
parts (``collective_bytes``, ``active_matmul_params``, ``model_flops``,
``cell_roofline``, ``roofline_table``) equal the reference's on its own
test's HLO text and records, with the reference's ``HW_V5E`` passed in.
One ``run_cell`` of a smoke config writes a record the roofline reads:
FLOPs counted, the bytes it cannot measure null with their reason.
"""
import json

import jax
import pytest

from repro.analysis import roofline as rroof
from repro.configs import get_config as ref_config
from repro.launch.dryrun import collective_bytes as ref_collective_bytes
from repro.models import make_model as ref_make
from repro.models.config import SHAPES as REF_SHAPES
from repro_torch.analysis import roofline as proof
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.launch import dryrun
from repro_torch.models import make_model
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.parallel.sharding import is_axes

# the reference test's HLO text (tests/test_roofline.py)
HLO = """
ENTRY %main {
  %ar = f32[16,4096,2048]{2,1,0} all-reduce(%x), to_apply=%add.promoted
  %ag = bf16[256,1024]{1,0} all-gather(%y), dimensions={0}
  %rs = f32[64]{0} reduce-scatter(%z), to_apply=%add.2
  %a2a = (f32[8,8]{1,0}, f32[8,8]{1,0}) all-to-all(%p, %q)
  %cp = bf16[32]{0} collective-permute(%w)
  %dot = f32[128,128]{1,0} dot(%a, %b)
}
"""
# the reference test's records (tests/test_roofline.py), and a multi one
RECORDS = [
    {"arch": "olmo-1b", "shape": "train_4k", "mesh": "single",
     "status": "ok", "n_devices": 256, "flops_per_device": 197e12,
     "bytes_per_device": 819e9, "collective_bytes": {"all-reduce": 100e9},
     "collective_bytes_tpu": {"all-reduce": 50e9}},
    {"arch": "olmo-1b", "shape": "prefill_32k", "mesh": "single",
     "status": "ok", "n_devices": 256, "flops_per_device": 1e12,
     "bytes_per_device": 1e11, "collective_bytes": {"all-reduce": 1e9}},
    {"arch": "olmo-1b", "shape": "long_500k", "mesh": "single",
     "status": "skip", "reason": "skip(full-attn)"},
    {"arch": "mixtral-8x22b", "shape": "decode_32k", "mesh": "single",
     "status": "error", "error": "RuntimeError: " + "x" * 80},
    {"arch": "zamba2-2.7b", "shape": "decode_32k", "mesh": "multi",
     "status": "ok", "n_devices": 512, "flops_per_device": 3e9,
     "bytes_per_device": 2e9, "collective_bytes": {"all-gather": 4e8},
     "overrides": {"unroll_layers": False}},
]


def _dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _port_leaves(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in _port_leaves(t)]
    return [tree]


def _axes_leaves(tree):
    if is_axes(tree):
        return [tree]
    return [x for t in tree for x in _axes_leaves(t)]


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_and_cache_axes_equal_reference(arch, shape):
    specs, axes = make_model(get_config(arch), device="meta").input_specs(
        SHAPES[shape])
    rspecs, raxes = ref_make(ref_config(arch)).input_specs(REF_SHAPES[shape])
    assert list(specs) == list(rspecs) and list(axes) == list(raxes)
    for k in specs:
        if k == "caches":
            got = _port_leaves(specs[k])
            want = jax.tree.leaves(rspecs[k])
            got_ax = _axes_leaves(axes[k])
            want_ax = jax.tree.leaves(raxes[k], is_leaf=is_axes)
            assert type(specs[k]).__name__ == type(rspecs[k]).__name__
            assert type(axes[k]).__name__ == type(raxes[k]).__name__
        else:
            got, want = [specs[k]], [rspecs[k]]
            got_ax, want_ax = [axes[k]], [raxes[k]]
        assert got_ax == want_ax, k
        assert len(got) == len(want), k
        for g, w in zip(got, want):
            assert g.device.type == "meta"
            assert tuple(g.shape) == tuple(w.shape), k
            assert _dtype_name(g) == w.dtype.name, k


def test_collective_bytes_equals_reference():
    assert dryrun.collective_bytes(HLO) == ref_collective_bytes(HLO)
    out, counts, top, out_tpu = dryrun.collective_bytes(HLO)
    assert out["all-reduce"] == 16 * 4096 * 2048 * 4
    assert out_tpu["all-reduce"] == out["all-reduce"] // 2


@pytest.mark.parametrize("arch", list_archs())
def test_analytic_flops_equal_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    assert proof.active_matmul_params(cfg) == \
        rroof.active_matmul_params(rcfg)
    for name in SHAPES:
        assert proof.model_flops(cfg, SHAPES[name]) == \
            rroof.model_flops(rcfg, REF_SHAPES[name])


def test_cell_roofline_and_table_equal_reference_with_v5e():
    fields = ("arch", "shape", "mesh", "status", "compute_s", "memory_s",
              "collective_s", "model_flops", "hlo_flops_global", "reason")
    for rec in RECORDS:
        got = proof.cell_roofline(rec, hw=rroof.HW_V5E)
        want = rroof.cell_roofline(rec, rroof.HW_V5E)
        for f in fields:
            assert getattr(got, f) == getattr(want, f), (rec, f)
        for p in ("dominant", "step_s", "roofline_s", "useful_ratio",
                  "compute_fraction"):
            assert getattr(got, p) == getattr(want, p), (rec, p)
    for mesh in ("single", "multi"):
        assert proof.roofline_table(RECORDS, mesh=mesh,
                                    hw=rroof.HW_V5E) == \
            rroof.roofline_table(RECORDS, mesh=mesh)


def test_null_terms_are_unknown_not_zero():
    rec = {"arch": "llama3.2-1b", "shape": "train_4k", "mesh": "single",
           "status": "ok", "n_devices": 256, "flops_per_device": 989e12,
           "bytes_per_device": None, "collective_bytes": None}
    t = proof.cell_roofline(rec)
    assert t.compute_s == pytest.approx(1.0)       # one second at peak
    assert t.memory_s is None and t.collective_s is None
    assert t.dominant == "compute"
    assert t.step_s == t.roofline_s == t.compute_s
    assert not t.complete and t.compute_fraction is None   # bound unknown
    row = proof.roofline_table([rec]).splitlines()[-1]
    assert "| 1.0000 | - | - | compute (largest known term) |" in row
    assert row.endswith(" | - |")                  # no roofline fraction


@pytest.fixture
def smoke_configs(monkeypatch):
    monkeypatch.setattr(dryrun, "get_config", get_smoke_config)


def test_run_cell_writes_a_record_the_roofline_reads(tmp_path, smoke_configs,
                                                     capsys):
    rec = dryrun.run_cell("llama3.2-1b", "train_4k", "single",
                          out_dir=tmp_path)
    path = tmp_path / "llama3.2-1b_train_4k_single.json"
    assert json.loads(path.read_text()) == rec
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert rec["flops_per_device"] > 0
    assert rec["bytes_per_device"] is None and rec["collective_bytes"] is None
    assert set(rec["unavailable"]) == {"bytes_per_device",
                                       "collective_bytes"}
    assert "no XLA cost analysis" in rec["unavailable"]["bytes_per_device"]
    # arguments: the sharded f32 state (params, mu, nu, step) and the batch
    cfg = get_smoke_config("llama3.2-1b")
    model = make_model(cfg, device="meta")
    state, st_axes, specs, in_axes = dryrun.cell_inputs(model,
                                                        SHAPES["train_4k"])
    mesh = dryrun.make_production_mesh()
    want = (dryrun.bytes_per_device(st_axes, state, mesh)
            + dryrun.bytes_per_device(in_axes, specs, mesh))
    assert rec["memory"] == {"argument_size_in_bytes": want}
    assert want >= 2 * 256 * 4096 * 4 // 16          # tokens + labels
    # counted products: at least the 6ND convention's, as the reference's
    # HLO FLOPs are (remat recomputation and attention come on top)
    glob = rec["flops_per_device"] * 256
    assert glob >= proof.model_flops(cfg, SHAPES["train_4k"])
    # a second call reads the record back; a skipped cell is recorded
    assert dryrun.run_cell("llama3.2-1b", "train_4k", "single",
                           out_dir=tmp_path) == rec
    skip = dryrun.run_cell("llama3.2-1b", "long_500k", "single",
                           out_dir=tmp_path)
    assert skip["status"] == "skip" and "full-attn" in skip["reason"]
    proof.main(["--dir", str(tmp_path)])
    table = capsys.readouterr().out
    assert "| llama3.2-1b | long_500k | - | - | - | skip |" in table
    assert "| - | - | compute (largest known term) |" in table


@pytest.mark.parametrize("shape_name,remat", [
    ("train_4k", "none"), ("train_4k", "dots"), ("train_4k", "full"),
    ("prefill_32k", "none"), ("decode_32k", "none")])
def test_counted_flops_equal_a_hand_count(tmp_path, smoke_configs,
                                          shape_name, remat):
    """The record's FLOPs for the llama smoke config equal a count by
    hand of its products.  Per layer and token: q, k, v, o and the
    SwiGLU MLP; per token the tied logits (a prefill's of the last
    position only).  Attention: its two products (scores, then
    probabilities by values) over the whole masked S x T square, as the
    plain version computes them on the meta device.  A train step is the
    forward plus twice its products for the backward, except attention,
    whose plain backward recomputes its two forward products before its
    four own; remat "dots" also recomputes attention's forward (the
    saved products are not run again), "full" every forward product of
    the layer but its last, the MLP's down product (the recomputation
    stops once every tensor the backward reads is back, and none reads
    that product's output)."""
    cfg = get_smoke_config("llama3.2-1b").replace(remat=remat)
    shape = SHAPES[shape_name]
    B, S, L = shape.global_batch, shape.seq_len, cfg.n_layers
    D, H, KV, hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                       cfg.d_ff)
    layer = 2 * D * H * hd + 2 * 2 * D * KV * hd + 2 * H * hd * D \
        + 3 * 2 * D * F
    head = 2 * D * cfg.vocab_padded
    if shape.kind == "decode":       # one token against a seq_len cache
        want = B * (L * layer + head) + L * 2 * (2 * B * H * S * hd)
    else:
        att = 2 * (2 * B * H * S * S * hd)
        if shape.kind == "prefill":
            want = B * S * L * layer + B * head + L * att
        else:
            want = 3 * B * S * (L * layer + head) + L * (att + 3 * att)
            want += {"none": 0, "dots": L * att,
                     "full": L * (att + B * S * (layer - 2 * F * D))}[remat]
    rec = dryrun.run_cell("llama3.2-1b", shape_name, "single",
                          overrides={"remat": remat}, suffix=remat,
                          out_dir=tmp_path)
    assert rec["status"] == "ok", rec
    assert rec["flops_per_device"] * rec["n_devices"] == want


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_xlstm_count_is_affine_in_the_sequence(kind, monkeypatch):
    monkeypatch.setattr(dryrun, "FLOP_SEQ", (4, 8))
    model = make_model(get_smoke_config("xlstm-350m"), device="meta")
    f = [dryrun.count_flops(model, sh, model.input_specs(sh)[0])
         for sh in (ShapeConfig("x", s, 2, kind) for s in (4, 8, 20))]
    assert f[1] - f[0] == (f[2] - f[1]) / 3
    long = ShapeConfig("x", 20, 2, kind)
    assert dryrun.step_flops(model, long, model.input_specs(long)[0]) == \
        f[2]


def test_cli_runs_one_cell(tmp_path, smoke_configs):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "zamba2-2.7b", "--shape", "decode_32k",
                     "--mesh", "both", "--out-dir", str(tmp_path)])
    assert e.value.code == 0
    recs = proof.load_dryrun_records(tmp_path)
    assert sorted(r["mesh"] for r in recs) == ["multi", "single"]
    assert {r["n_devices"] for r in recs} == {256, 512}
    assert all(r["status"] == "ok" for r in recs)
