"""Three-term roofline of the dry-run's records, for the H100.

    compute    = FLOPs_per_device / peak_FLOPs
    memory     = bytes_per_device / HBM_bw
    collective = collective_bytes_per_device / link_bw

Mirrors ``repro.analysis.roofline``.  The reference reads XLA's cost
analysis and the partitioned HLO of a compiled step; the port's dry-run
(``launch/dryrun.py``) has no compiler artifact, so its records carry
the FLOPs (``torch.utils.flop_counter``) and leave the HBM bytes and the
collective bytes null.  A null term prints "-" and takes no part in
``dominant``, ``step_s`` or ``roofline_s``: it is unknown, not zero.
The table also reads the reference's own records (every term present).

MODEL_FLOPS is the napkin convention: 6*N_active*tokens for training,
2*N_active*tokens for forward-only (prefill/decode), with N_active the
matmul-participating parameters (MoE counts top_k/E of expert weights;
attention's quadratic term is excluded by the convention, so
counted/MODEL > 1 even without waste).

    python -m repro_torch.analysis.roofline [--mesh single|multi] [--dir D]
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional

from ..configs import get_config
from ..models.config import ModelConfig, SHAPES, ShapeConfig

# NVIDIA H100 SXM5 80GB HBM3, per card, at its 700 W limit (NVIDIA H100
# Tensor Core GPU data sheet): dense bf16 tensor-core peak (1,979 TFLOP/s
# is with sparsity), HBM3 bandwidth, and NVLink's 900 GB/s counted per
# direction.
HW_H100 = {
    "peak_flops": 989e12,       # bf16, dense
    "hbm_bw": 3.35e12,          # bytes/s
    "link_bw": 450e9,           # bytes/s, NVLink, one direction
}

DRYRUN_DIR = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"


# ---------------------------------------------------------------------------
# Analytic parameter / FLOP model
# ---------------------------------------------------------------------------

def active_matmul_params(cfg: ModelConfig) -> float:
    """Matmul-participating parameters touched per decoder token."""
    D, F, hd = cfg.d_model, cfg.d_ff, cfg.hd
    H, KV = cfg.n_heads, cfg.n_kv_heads
    attn = D * H * hd + 2 * D * KV * hd + H * hd * D
    mlp_dense = (3 if cfg.act == "swiglu" else 2) * D * F

    if cfg.family in ("dense", "vlm"):
        per_layer = attn + mlp_dense
        layers = cfg.n_layers * per_layer
    elif cfg.family == "moe":
        per_expert = (3 if cfg.act == "swiglu" else 2) * D * F
        per_layer = attn + D * cfg.n_experts \
            + cfg.top_k * per_expert
        layers = cfg.n_layers * per_layer
    elif cfg.family == "encdec":
        # decoder tokens pass self+cross+mlp; encoder accounted separately
        per_dec = 2 * attn + mlp_dense
        layers = cfg.n_layers * per_dec
    elif cfg.family == "hybrid":
        I = cfg.ssm_expand * D
        N = cfg.ssm_state
        Hs = I // cfg.ssm_head_dim
        mamba = D * (2 * I + 2 * N + Hs) + I * D
        G = cfg.n_layers // cfg.shared_attn_every
        layers = cfg.n_layers * mamba + G * (attn + mlp_dense)
    else:  # ssm / xlstm
        mlstm = 3 * D * D + 2 * D * D + D * H * 2      # q,k,v + o,out + gates
        slstm = 8 * D * D + D * D                      # wx, wh (4D each) + out
        layers = (cfg.n_layers // 2) * (mlstm + slstm)
    head = D * cfg.vocab_padded
    return float(layers + head)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """The 6ND / 2ND convention, global (all devices)."""
    n = active_matmul_params(cfg)
    if shape.kind == "train":
        tokens = shape.tokens
        mult = 6.0
    elif shape.kind == "prefill":
        tokens = shape.tokens
        mult = 2.0
    else:  # decode: one token per sequence
        tokens = shape.global_batch
        mult = 2.0
    flops = mult * n * tokens
    if cfg.family == "encdec" and shape.kind != "decode":
        # encoder side: enc_seq tokens through encoder layers
        D, F = cfg.d_model, cfg.d_ff
        attn = 4 * D * D
        enc_n = cfg.n_enc_layers * (attn + (3 if cfg.act == "swiglu"
                                            else 2) * D * F)
        flops += mult * enc_n * cfg.enc_seq * shape.global_batch
    return flops


# ---------------------------------------------------------------------------
# Roofline terms
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    status: str
    compute_s: Optional[float] = 0.0
    memory_s: Optional[float] = 0.0
    collective_s: Optional[float] = 0.0
    model_flops: float = 0.0
    hlo_flops_global: float = 0.0
    reason: str = ""
    n_devices: int = 0
    peak_flops: float = 0.0

    def _terms(self) -> Dict[str, float]:
        """The known terms (a null one is unknown, never 0 s)."""
        t = {"compute": self.compute_s, "memory": self.memory_s,
             "collective": self.collective_s}
        return {k: v for k, v in t.items() if v is not None}

    @property
    def complete(self) -> bool:
        """All three terms known (the reference's records; the port's
        leave memory and collectives null)."""
        return len(self._terms()) == 3

    @property
    def dominant(self) -> str:
        """The largest known term; only a bottleneck when ``complete``."""
        if self.status != "ok":
            return "-"
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """No-overlap serial estimate (upper bound on step time) of the
        known terms."""
        return sum(self._terms().values())

    @property
    def roofline_s(self) -> float:
        """Perfect-overlap estimate (lower bound): max of the known
        terms."""
        return max(self._terms().values(), default=0.0)

    @property
    def useful_ratio(self) -> float:
        if self.hlo_flops_global <= 0:
            return 0.0
        return self.model_flops / self.hlo_flops_global

    @property
    def compute_fraction(self) -> Optional[float]:
        """MODEL_FLOPS-based roofline fraction at the perfect-overlap
        bound: (model-useful compute time) / step lower bound, on the
        record's device count and the hardware's peak.  None where a
        term is unknown: the bound is then unknown too."""
        if self.status == "ok" and not self.complete:
            return None
        if self.status != "ok" or self.roofline_s <= 0:
            return 0.0
        useful_s = self.model_flops / (self.n_devices * self.peak_flops)
        return useful_s / self.roofline_s


def load_dryrun_records(dryrun_dir: Optional[Path] = None) -> List[Dict]:
    d = dryrun_dir or DRYRUN_DIR
    out = []
    for p in sorted(d.glob("*.json")):
        try:
            out.append(json.loads(p.read_text()))
        except (OSError, ValueError):
            pass
    return out


def cell_roofline(rec: Dict, hw: Dict = HW_H100) -> RooflineTerms:
    arch, shape_n, mesh = rec["arch"], rec["shape"], rec["mesh"]
    if (rec.get("overrides") or {}).get("unroll_layers") is False:
        # the reference's scan-over-layers fallback: XLA counted the
        # layer body once, so its costs are lower bounds (flagged)
        arch = arch + "†"
    t = RooflineTerms(arch=arch, shape=shape_n, mesh=mesh,
                      status=rec.get("status", "error"),
                      reason=rec.get("reason", rec.get("error", "")))
    if t.status != "ok":
        return t
    n_dev = rec.get("n_devices", 256)
    cfg = get_config(rec["arch"])
    shape = SHAPES[shape_n]
    t.n_devices, t.peak_flops = n_dev, hw["peak_flops"]
    t.compute_s = rec["flops_per_device"] / hw["peak_flops"]
    hbm = rec.get("bytes_per_device")
    t.memory_s = None if hbm is None else hbm / hw["hbm_bw"]
    # bf16 collectives at bf16 width where the record has that estimate
    # (the host compiler widens them to f32; the links carry bf16)
    coll = rec.get("collective_bytes_tpu", rec.get("collective_bytes"))
    t.collective_s = (None if coll is None
                      else sum(coll.values()) / hw["link_bw"])
    t.model_flops = model_flops(cfg, shape)
    t.hlo_flops_global = rec["flops_per_device"] * n_dev
    return t


def _s(x: Optional[float]) -> str:
    return "-" if x is None else f"{x:.4f}"


def roofline_table(records: Optional[List[Dict]] = None,
                   mesh: str = "single", hw: Dict = HW_H100) -> str:
    """Markdown table of the records of one mesh kind."""
    recs = records if records is not None else load_dryrun_records()
    rows = [cell_roofline(r, hw) for r in recs if r.get("mesh") == mesh]
    rows.sort(key=lambda t: (t.arch, t.shape))
    hdr = ("| arch | shape | compute s | memory s | collective s | "
           "dominant | MODEL_FLOPS | HLO/MODEL | roofline frac |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for t in rows:
        if t.status == "skip":
            lines.append(f"| {t.arch} | {t.shape} | - | - | - | "
                         f"skip | - | - | {t.reason} |")
        elif t.status != "ok":
            lines.append(f"| {t.arch} | {t.shape} | - | - | - | "
                         f"ERROR | - | - | {t.reason[:48]} |")
        else:
            inv = (1.0 / t.useful_ratio) if t.useful_ratio else 0.0
            # with a term unknown there is no bottleneck to name and no
            # bound to be a fraction of
            dom = f"**{t.dominant}**" if t.complete else \
                f"{t.dominant} (largest known term)"
            frac = "-" if t.compute_fraction is None else \
                f"{t.compute_fraction:.3f}"
            lines.append(
                f"| {t.arch} | {t.shape} | {_s(t.compute_s)} | "
                f"{_s(t.memory_s)} | {_s(t.collective_s)} | "
                f"{dom} | {t.model_flops:.3e} | {inv:.2f} | {frac} |")
    return hdr + "\n".join(lines)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--dir", type=Path, default=None,
                    help=f"records to read (default {DRYRUN_DIR})")
    args = ap.parse_args(argv)
    print(roofline_table(load_dryrun_records(args.dir), mesh=args.mesh))


if __name__ == "__main__":
    main()
