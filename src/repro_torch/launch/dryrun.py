"""Dry-run of every (architecture x input-shape x mesh) cell against the
production mesh, with meta-device stand-ins (nothing allocated).

Mirrors ``repro.launch.dryrun``, which lowers and compiles each cell's
step on 512 fake host devices and reads XLA's analyses.  Eager PyTorch
has no compiled artifact to read, so the port keeps the record format
and fills what it can count:

  * ``flops_per_device``: ``torch.utils.flop_counter.FlopCounterMode``
    over the full-size model's step on the meta device (a train cell's
    forward and backward, remat recomputation included), divided by the
    mesh's device count.  It counts matrix products and attention only
    (``mm``, ``bmm``, ``addmm``, ...), no elementwise work;
  * ``memory.argument_size_in_bytes``: each device's bytes of the
    sharded state (parameters; for train also both AdamW moments and
    the step) and inputs, from the logical-axis rules
    (``parallel.sharding.spec_tree``) and ``NamedSharding.shard_shape``;
  * ``bytes_per_device`` (HBM bytes accessed) and ``collective_bytes``:
    null, with the reason under ``unavailable``.

Records go to experiments/dryrun_torch/ (the reference's are under
experiments/dryrun/); ``python -m repro_torch.analysis.roofline`` reads
them.  ``collective_bytes`` parses the reference's post-partitioning HLO
text, so the port reads the reference's records too.

Usage:
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--force]
"""
from __future__ import annotations

import argparse
import json
import re
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..configs import get_config, list_archs
from ..models import make_model
from ..models.config import SHAPES, ShapeConfig, shape_applicable
from ..parallel.sharding import ShardingRules, spec_tree, tree_map_axes
from ..train.optim import OptState
from ..train.train_step import TrainState, state_axes
from .mesh import make_production_mesh

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"
UNAVAILABLE = ("eager PyTorch compiles no step: there is no XLA cost "
               "analysis (HBM bytes accessed) and no partitioned HLO "
               "(collective bytes) to read")
# The xLSTM's cells run a Python loop over the tokens.  Each product of
# the family is per token or per step (the sLSTM's recurrent product;
# a prefill's logits are the last token's), so its count is affine in
# the sequence length: past FLOP_SEQ it is counted at two lengths and
# extrapolated, exactly.
FLOP_SEQ = (16, 32)

_COLL_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\([^)]*\)|\S+)\s*"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)",
)
_SHAPE_RE = re.compile(r"(f64|f32|bf16|f16|f8\w*|s64|s32|s16|s8|u64|u32|u16"
                       r"|u8|pred)\[([\d,]*)\]")
_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "s32": 4,
          "s16": 2, "s8": 1, "u64": 8, "u32": 4, "u16": 2, "u8": 1,
          "pred": 1}


def collective_bytes(hlo_text: str):
    """Per-device payload bytes by collective kind, from the
    post-partitioning optimized HLO (shapes in SPMD modules are local).
    Also returns the top payload (kind, dtype[shape]) buckets -- the
    perf loop's profile."""
    out = {k: 0 for k in ("all-reduce", "all-gather", "reduce-scatter",
                          "all-to-all", "collective-permute")}
    out_tpu = dict(out)
    counts = dict.fromkeys(out, 0)
    buckets = {}
    for line in hlo_text.splitlines():
        m = _COLL_RE.match(line)
        if not m:
            continue
        shapes_part, kind = m.group(1), m.group(2)
        nbytes = 0
        key_shape = "?"
        for i, (dt, dims) in enumerate(_SHAPE_RE.findall(shapes_part)):
            n = 1
            if dims:
                for d in dims.split(","):
                    n *= int(d)
            nbytes += n * _BYTES.get(dt.split("e")[0] if dt.startswith("f8")
                                     else dt, 4)
            if i == 0:
                key_shape = f"{dt}[{dims}]"
        out[kind] += nbytes
        counts[kind] += 1
        # CPU float-normalization promotes bf16 collectives to f32
        # (reduction computation named ..._promoted); a device executes
        # them natively in bf16, so the wire estimate halves those payloads.
        tpu_bytes = nbytes // 2 if "promoted" in line else nbytes
        out_tpu[kind] += tpu_bytes
        bk = f"{kind} {key_shape}"
        b = buckets.setdefault(bk, [0, 0])
        b[0] += nbytes
        b[1] += 1
    top = sorted(buckets.items(), key=lambda kv: -kv[1][0])[:10]
    return (out, counts,
            {k: {"bytes": v[0], "n": v[1]} for k, v in top}, out_tpu)


def _mem_dict(mem) -> dict:
    keys = ("generated_code_size_in_bytes", "argument_size_in_bytes",
            "output_size_in_bytes", "temp_size_in_bytes",
            "alias_size_in_bytes", "peak_memory_in_bytes")
    d = {}
    for k in keys:
        v = getattr(mem, k, None)
        if v is not None:
            d[k] = int(v)
    return d


def bytes_per_device(axes_tree, tree, mesh, rules=None) -> int:
    """Each device's bytes of a tree of tensors sharded by its logical
    axes on ``mesh``."""
    shardings = spec_tree(axes_tree, tree, mesh, rules)
    total = []

    def one(_axes, t, sh):
        n = 1
        for d in sh.shard_shape(t.shape):
            n *= d
        total.append(n * t.element_size())

    tree_map_axes(one, axes_tree, tree, shardings)
    return sum(total)


def cell_inputs(model, shape: ShapeConfig):
    """(state or parameters, their axes, the step's inputs, their axes):
    meta tensors for a (train | prefill | decode) step."""
    pshapes, paxes = model.param_shapes()
    specs, in_axes = model.input_specs(shape)
    if shape.kind == "train":
        step = torch.empty((), dtype=torch.int32, device="meta")
        state = TrainState(params=pshapes,
                           opt=OptState(step=step, mu=pshapes, nu=pshapes),
                           ef=None)
        return state, state_axes(paxes), specs, in_axes
    return pshapes, paxes, specs, in_axes


def count_flops(model, shape: ShapeConfig, specs) -> float:
    """Products and attention FLOPs (global) of one step on meta
    tensors: forward and backward for train, a prefill of the whole
    sequence, one decode token against a ``seq_len`` cache."""
    params = type(model)(model.cfg, torch.device("meta")).init(0)
    if shape.kind == "train":
        params.requires_grad_(True)
    with FlopCounterMode(display=False) as fc:
        if shape.kind == "train":
            loss, _ = model.loss(params, specs)
            loss.backward()
        elif shape.kind == "prefill":
            model.prefill(params, specs, context=shape.seq_len)
        else:
            model.decode(params, specs["tokens"], specs["caches"],
                         shape.seq_len - 1)
    return float(fc.get_total_flops())


def step_flops(model, shape: ShapeConfig, specs) -> float:
    s1, s2 = FLOP_SEQ
    if model.cfg.family != "ssm" or shape.kind == "decode" \
            or shape.seq_len <= s2:
        return count_flops(model, shape, specs)
    f1, f2 = (count_flops(model, short, model.input_specs(short)[0])
              for short in (ShapeConfig(shape.name, s, shape.global_batch,
                                        shape.kind) for s in (s1, s2)))
    return f1 + (f2 - f1) * (shape.seq_len - s1) / (s2 - s1)


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             force: bool = False, overrides=None, suffix: str = "",
             out_dir: Path | None = None) -> dict:
    out_dir = Path(out_dir or OUT_DIR)
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{arch}_{shape_name}_{mesh_kind}".replace("/", "-")
    if suffix:
        tag += f"-{suffix}"
    path = out_dir / f"{tag}.json"
    if path.exists() and not force:
        return json.loads(path.read_text())

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": mesh_kind + (f"-{suffix}" if suffix else ""),
           "family": cfg.family, "status": None,
           "overrides": dict(overrides or {})}
    if not ok:
        rec.update(status="skip", reason=why)
        path.write_text(json.dumps(rec, indent=1))
        return rec

    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
        model = make_model(cfg.replace(**(overrides or {})), device="meta")
        state, st_axes, specs, in_axes = cell_inputs(model, shape)
        rules = ShardingRules()
        args = (bytes_per_device(st_axes, state, mesh, rules)
                + bytes_per_device(in_axes, specs, mesh, rules))
        t_shard = time.time() - t0
        n_dev = mesh.devices.size
        flops = step_flops(model, shape, specs)
        t_count = time.time() - t0 - t_shard
        rec.update(
            status="ok",
            n_devices=n_dev,
            shard_s=round(t_shard, 2), count_s=round(t_count, 2),
            flops_per_device=flops / n_dev,
            bytes_per_device=None,
            memory=_mem_dict(SimpleNamespace(argument_size_in_bytes=args)),
            collective_bytes=None,
            unavailable={"bytes_per_device": UNAVAILABLE,
                         "collective_bytes": UNAVAILABLE},
        )
        print(f"[dryrun] OK   {tag}: {t_count:.1f}s counting, "
              f"{rec['flops_per_device']:.3e} flops/dev, "
              f"{args / 1e9:.3f} GB of arguments/dev", flush=True)
    except Exception as e:  # noqa: BLE001 -- record the failure, keep going
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        print(f"[dryrun] FAIL {tag}: {type(e).__name__}: {e}", flush=True)
    path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=("single", "multi", "both"))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out-dir", type=Path, default=None,
                    help=f"where records go (default {OUT_DIR})")
    ap.add_argument("--suffix", default="",
                    help="tag suffix for optimized-variant records")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        if v in ("true", "false"):
            v = v == "true"
        elif v.lstrip("-").isdigit():
            v = int(v)
        overrides[k] = v

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    n_ok = n_skip = n_err = 0
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, mesh_kind, force=args.force,
                               overrides=overrides or None,
                               suffix=args.suffix, out_dir=args.out_dir)
                n_ok += rec["status"] == "ok"
                n_skip += rec["status"] == "skip"
                n_err += rec["status"] == "error"
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skip, {n_err} error")
    raise SystemExit(1 if n_err else 0)


if __name__ == "__main__":
    main()
