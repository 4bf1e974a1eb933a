"""How ``correct`` is decided: the program's answers against the plain
reference, recomputed after the window.

What is compared.  Of the window's campaigns, ``CHECKED`` are drawn from
the seed (all of them in a traced run).  In each, every (program, image)
pair of every call is checked once, under a hardware config drawn from
the seed: its five fields as the program answered them (``full``), or,
in a reduced cell, the program's front or top-k set against those lanes,
with every candidate of it recomputed.  The reference
(``reference/sweep.py``) runs those lanes on the same images, with the
profile it derives itself (``reference/profile.py``); it takes nothing
the program made.

The numbers, each against its limit (``LIMITS``):

- ``int_mismatch``: checked lanes and front points whose ``latency_cc``,
  ``checksum`` or ``steps_executed`` differ from the reference's
  (exact: limit 0), or whose flat index lies outside its program;
- ``energy_rel_err``: the largest relative gap of ``energy_pj`` and
  ``power_mw`` to the reference's, over the same lanes;
- ``front_missing``: checked lanes off their program's front that no
  front point covers (no worse latency, energy within
  ``energy_rel_err``'s limit, and not an exact duplicate, since the
  program keeps duplicates of a front point on the front);
- ``front_dominated``: front points that a checked lane beats by more
  than that limit in energy at no worse latency (or at a better latency
  and no worse energy);
- ``front_clipped``: front points the program dropped at its cap;
- ``topk_missing``, in a ``topk`` cell: checked lanes outside the
  program's top-k set whose energy-delay product beats the set's worst by
  more than ``energy_rel_err``'s limit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from . import images as _images
from .reference import profile as ref_profile
from .reference import sweep as ref_sweep

FIELDS = ref_sweep.RESULT_FIELDS
CHECKED = 2
LIMITS = {"int_mismatch": 0, "energy_rel_err": 1e-5, "front_missing": 0,
          "front_dominated": 0, "front_clipped": 0, "topk_missing": 0}
NUMBERS = {None: ("int_mismatch", "energy_rel_err"),
           "pareto": ("int_mismatch", "energy_rel_err", "front_missing",
                      "front_dominated", "front_clipped"),
           "topk": ("int_mismatch", "energy_rel_err", "topk_missing")}


@dataclasses.dataclass
class Inputs:
    """What the check needs to know of a configuration."""
    calls: list            # the configuration's calls
    programs: list         # per call: the reference Programs
    hw: list               # hardware configs (dicts)
    mem_size: int
    reduce: Optional[dict]  # the mix's reduction, or None
    rows: int = 4           # the configuration's array
    cols: int = 4


def sample(inp: Inputs, seed: int, campaign: int) -> List[np.ndarray]:
    """Per call, the flat lane indices checked: every (program, image)
    pair once, under a hardware config drawn from the seed."""
    rng = np.random.default_rng([int(seed) % 2**64, 11, campaign])
    H = len(inp.hw)
    out = []
    for call, progs in zip(inp.calls, inp.programs):
        G, D = len(progs), int(call["images"])
        h = rng.integers(0, H, (G, D))
        g, d = np.meshgrid(np.arange(G), np.arange(D), indexing="ij")
        out.append(((g * H + h) * D + d).reshape(-1).astype(np.int64))
    return out


def keep(inp: Inputs, answer: list, idx: List[np.ndarray]) -> list:
    """What a campaign's check reads of its answer: the checked lanes'
    fields, or the whole (small) reduced answer."""
    if inp.reduce is not None:
        return answer
    return [{f: np.asarray(part[f])[i] for f in FIELDS}
            for part, i in zip(answer, idx)]


def checked_campaigns(n: int, seed: int) -> List[int]:
    rng = np.random.default_rng([int(seed) % 2**64, 13, n])
    return sorted(rng.choice(n, size=min(CHECKED, n), replace=False)
                  .tolist())


def reference_answers(inp: Inputs, seed: int, wanted: Dict[int, list],
                      device, *, energy_dtype=torch.float32,
                      stream: int = _images.WINDOW) -> Dict[int, list]:
    """The reference's five fields of the lanes ``wanted[c][call]`` (flat
    indices) of campaign ``c``, in one batch on ``device``."""
    prof = ref_profile.characterize()
    H = len(inp.hw)
    flat = [p for progs in inp.programs for p in progs]
    offsets = np.cumsum([0] + [len(p) for p in inp.programs])
    rows, prog, hw, steps, where = [], [], [], [], []
    for c, per_call in sorted(wanted.items()):
        for i, (call, idx) in enumerate(zip(inp.calls, per_call)):
            D = int(call["images"])
            img = _images.images(call, inp.mem_size, seed, stream, c, i,
                                 device)
            idx = np.asarray(idx, np.int64)
            g, h, d = idx // (H * D), (idx // D) % H, idx % D
            rows.append(img[torch.as_tensor(d, device=device)])
            prog += (offsets[i] + g).tolist()
            hw += [inp.hw[k] for k in h]
            steps += [int(call["max_steps"])] * len(idx)
            where.append((c, i, len(idx)))
    res = ref_sweep.run_lanes(flat, prog, hw, torch.cat(rows), steps, prof,
                              rows=inp.rows, cols=inp.cols,
                              energy_dtype=energy_dtype)
    res = {f: v.float().cpu().numpy() if f in ("energy_pj", "power_mw")
           else v.cpu().numpy() for f, v in res.items()}
    out: Dict[int, list] = {}
    lo = 0
    for c, i, n in where:
        out.setdefault(c, []).append({f: v[lo:lo + n] for f, v in
                                      res.items()})
        lo += n
    return out


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.size == 0:
        return 0.0
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                        1e-30)))


def _mismatch(got: dict, want: dict) -> int:
    bad = np.zeros(len(want["latency_cc"]), bool)
    for f in ("latency_cc", "checksum", "steps_executed"):
        bad |= np.asarray(got[f]) != np.asarray(want[f])
    return int(bad.sum())


def _front_faults(ref_front: dict, ref_lanes: dict, idx, f_idx,
                  tol: float):
    """(missing, dominated) of a program's front against its checked
    lanes, all in the reference's values."""
    f_lat = ref_front["latency_cc"].astype(np.float32)
    f_e = ref_front["energy_pj"].astype(np.float32)
    x_lat = ref_lanes["latency_cc"].astype(np.float32)
    x_e = ref_lanes["energy_pj"].astype(np.float32)
    slack = np.float32(1 + tol)
    # an exact duplicate of a front point belongs on the front itself
    covered = ((f_lat[None, :] <= x_lat[:, None])
               & (f_e[None, :] <= x_e[:, None] * slack)
               & ~((f_lat[None, :] == x_lat[:, None])
                   & (f_e[None, :] == x_e[:, None]))).any(1)
    on_front = np.isin(idx, f_idx)
    missing = int((~covered & ~on_front).sum())
    xe = (x_e * slack)[:, None]
    beats = (((x_lat[:, None] <= f_lat[None, :]) & (xe < f_e[None, :]))
             | ((x_lat[:, None] < f_lat[None, :]) & (xe <= f_e[None, :])))
    return missing, int(beats.any(0).sum())


def _topk_missing(ref_set: dict, ref_lanes: dict, idx, f_idx,
                  tol: float) -> int:
    """Checked lanes outside the set that beat its worst member."""
    edp = lambda d: (d["energy_pj"].astype(np.float32)
                     * d["latency_cc"].astype(np.float32))
    worst = edp(ref_set).max() if len(f_idx) else np.float32(np.inf)
    beats = edp(ref_lanes) * np.float32(1 + tol) < worst
    return int((beats & ~np.isin(idx, f_idx)).sum())


def compare(inp: Inputs, kept: Dict[int, list], samples: Dict[int, list],
            seed: int, device, reference: Optional[Dict[int, list]] = None
            ) -> dict:
    """The numbers compared, and the reference's executed lane-steps of
    every checked campaign (``lane_steps``)."""
    H = len(inp.hw)
    kind = None if inp.reduce is None else inp.reduce["kind"]
    front = kind is not None
    wanted = {}
    for c in kept:
        per_call = []
        for i, (part, idx) in enumerate(zip(kept[c], samples[c])):
            extra = []
            if front:
                for g in range(len(inp.programs[i])):
                    extra += np.asarray(
                        part.indices[g, :int(part.count[g])]).tolist()
            per_call.append(np.concatenate([idx, np.asarray(extra,
                                                            np.int64)]))
        wanted[c] = per_call
    if reference is None:
        reference = reference_answers(inp, seed, wanted, device)
    tol = LIMITS["energy_rel_err"]
    nums = {k: 0 for k in NUMBERS[kind]}
    nums["energy_rel_err"] = 0.0
    lane_steps = {}
    checked = 0
    for c in sorted(kept):
        steps = 0
        for i, (part, idx, ref) in enumerate(zip(kept[c], samples[c],
                                                 reference[c])):
            D = int(inp.calls[i]["images"])
            n = len(idx)
            lanes = {f: v[:n] for f, v in ref.items()}
            steps += H * int(lanes["steps_executed"].astype(np.int64).sum())
            if not front:
                got = part
                nums["int_mismatch"] += _mismatch(got, lanes)
                nums["energy_rel_err"] = max(
                    nums["energy_rel_err"],
                    *(_rel(got[f], lanes[f]) for f in ("energy_pj",
                                                       "power_mw")))
                checked += n
                continue
            if kind == "pareto":
                nums["front_clipped"] += int(np.asarray(part.clipped).sum())
            lo = n
            for g in range(len(inp.programs[i])):
                k = int(part.count[g])
                f_idx = np.asarray(part.indices[g, :k], np.int64)
                ref_f = {f: v[lo:lo + k] for f, v in ref.items()}
                lo += k
                got = {f: np.asarray(getattr(part, f))[g, :k]
                       for f in FIELDS}
                outside = (f_idx // (H * D)) != g
                nums["int_mismatch"] += (_mismatch(got, ref_f)
                                         + int(outside.sum()))
                nums["energy_rel_err"] = max(
                    nums["energy_rel_err"],
                    *(_rel(got[f], ref_f[f]) for f in ("energy_pj",
                                                       "power_mw")))
                mine = (idx // (H * D)) == g
                own = {f: v[mine] for f, v in lanes.items()}
                if kind == "pareto":
                    miss, dom = _front_faults(ref_f, own, idx[mine], f_idx,
                                              tol)
                    nums["front_missing"] += miss
                    nums["front_dominated"] += dom
                else:
                    nums["topk_missing"] += _topk_missing(
                        ref_f, own, idx[mine], f_idx, tol)
                checked += int(mine.sum()) + k
        lane_steps[c] = steps
    return {"numbers": nums, "lane_steps": lane_steps, "lanes": checked}


def verdict(numbers: dict) -> bool:
    return all(v <= LIMITS[k] for k, v in numbers.items())
