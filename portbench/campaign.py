"""A campaign: every sweep call of a configuration, driven through the
program under test (``repro_torch.core.dse``), its answer on the host.

The programs are built once, by the benchmark's frozen generators
(``reference/``), and handed to the program as its own ``Program``
arrays; the hardware grid is the benchmark's.  ``run`` calls
``dse.sweep`` once a call, as a user does; ``run_split`` makes the same
calls through ``make_bucketed_sweep_fn`` and its ``fn()``, exactly as
``sweep`` does, so a traced run can time the plan apart.  Knobs stay
``AUTO``.

With ``chips`` > 1 every call runs over a mesh of the first ``chips``
visible cards (on the host: ``chips`` host shards), passed as ``mesh=``;
the images are drawn on the first card and the program copies them to
the others inside the call, as a user's call does.  With one chip no
``mesh`` is passed.

A configuration may name its array, ``"rows"`` and ``"cols"`` together;
without them it is the OpenEdgeCGRA's 4x4.  Every program has to have
``rows * cols`` PEs.  The shape is passed as ``rows=``/``cols=`` only
when it is not 4x4, so a 4x4 configuration makes the calls it made
before configurations named their array.
"""
from __future__ import annotations

import importlib
import time
from contextlib import nullcontext
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from . import images as _images
from .reference import hw as ref_hw
from .reference.isa import Program as RefProgram

RESULT_FIELDS = ("latency_cc", "energy_pj", "power_mw", "checksum",
                 "steps_executed")
ARRAY = (4, 4)     # the OpenEdgeCGRA's, the program's default


def array_shape(config: dict) -> Tuple[int, int]:
    """``(rows, cols)`` of the configuration's array: its ``rows`` and
    ``cols``, given together as positive integers, or ``ARRAY``."""
    given = [k for k in ("rows", "cols") if k in config]
    if not given:
        return ARRAY
    shape = tuple(config.get(k) for k in ("rows", "cols"))
    if len(given) == 1 or not all(
            type(v) is int and v > 0 for v in shape):
        raise ValueError(
            f"configuration {config.get('name')!r}: 'rows' and 'cols' are "
            f"given together as positive integers; got rows={shape[0]!r}, "
            f"cols={shape[1]!r}")
    return shape


def build_program(spec: dict) -> RefProgram:
    """The program a configuration names: ``reference/<module>.py``'s
    ``<kernel>(**args)``."""
    mod = importlib.import_module(f"portbench.reference.{spec['module']}")
    return getattr(mod, spec["kernel"])(**spec.get("args", {})).program


class Campaigns:
    """The calls of one configuration under one mix, set up once."""

    def __init__(self, config: dict, mix: dict, profile, device,
                 chips: int = 1):
        from repro_torch.analysis import pareto
        from repro_torch.core import dse, hwconfig
        from repro_torch.core.program import Program

        self.dse, self.pareto = dse, pareto
        self.device = torch.device(device)
        self.mesh = None
        if chips > 1:
            from repro_torch.launch.mesh import make_debug_mesh
            self.mesh = (make_debug_mesh(chips) if self.device.type == "cuda"
                         else make_debug_mesh(chips, device=self.device))
        self.profile = profile
        self.rows, self.cols = array_shape(config)
        self.mem_size = int(config["mem_size"])
        self.calls = config["calls"]
        self.ref_programs: List[List[RefProgram]] = [
            [build_program(p) for p in call["programs"]]
            for call in self.calls]
        for p in (p for progs in self.ref_programs for p in progs):
            if p.n_pes != self.rows * self.cols:
                raise ValueError(
                    f"configuration {config.get('name')!r}: program "
                    f"{p.name!r} has n_pes={p.n_pes}, not the "
                    f"{self.rows}x{self.cols} array's {self.rows * self.cols}")
        self.programs = [[Program(*(p.arrays()[f] for f in
                                    ("ops", "dest", "srcA", "srcB", "imm")),
                                  name=p.name) for p in progs]
                         for progs in self.ref_programs]
        self.hw = ref_hw.grid(config["hardware"])
        self.hw_configs = [hwconfig.HwConfig(**h) for h in self.hw]
        red = mix.get("reduce")
        if red is None:
            self.reduce = None
        elif red["kind"] == "pareto":
            self.reduce = pareto.ParetoFront(tuple(red["axes"]),
                                             int(red["max_points"]))
        else:
            self.reduce = pareto.TopK(red["objective"], int(red["k"]))
        self.lanes = [len(p) * len(self.hw) * int(c["images"])
                      for p, c in zip(self.programs, self.calls)]
        self.points = sum(self.lanes)

    def images(self, seed: int, stream: int, campaign: int
               ) -> List[torch.Tensor]:
        return [_images.images(call, self.mem_size, seed, stream, campaign,
                               i, self.device)
                for i, call in enumerate(self.calls)]

    def _kw(self, i: int) -> dict:
        kw = dict(max_steps=int(self.calls[i]["max_steps"]),
                  mem_size=self.mem_size, reduce=self.reduce,
                  device=self.device)
        if self.mesh is not None:
            kw["mesh"] = self.mesh
        if (self.rows, self.cols) != ARRAY:
            kw.update(rows=self.rows, cols=self.cols)
        return kw

    def _to_host(self, res):
        if self.reduce is not None:
            return res                     # sweep() answers on the host
        return {f: x.cpu().numpy() for f, x in zip(RESULT_FIELDS, res)}

    def run(self, imgs: List[torch.Tensor]) -> list:
        """One campaign through ``dse.sweep``; the answers on the host."""
        return [self._to_host(self.dse.sweep(
            programs=progs, profile=self.profile, hw_configs=self.hw_configs,
            mem_images=img, **self._kw(i)))
            for i, (progs, img) in enumerate(zip(self.programs, imgs))]

    def run_split(self, imgs: List[torch.Tensor],
                  span: Optional[Callable[[str], object]] = None,
                  plan_s: Optional[list] = None) -> list:
        """``run`` with each call's plan (``make_bucketed_sweep_fn``) and
        its ``fn()`` apart; the plan's host seconds go to ``plan_s``."""
        span = span or (lambda name: nullcontext())
        out = []
        for i, (progs, img) in enumerate(zip(self.programs, imgs)):
            t0 = time.perf_counter()
            with span("plan"):
                fn = self.dse.make_bucketed_sweep_fn(
                    progs, self.profile, self.hw_configs, img,
                    **self._kw(i))
            if plan_s is not None:
                plan_s.append(time.perf_counter() - t0)
            with span("sweep"):
                res = fn()
            with span("to_host"):
                out.append(self._to_host(res))
        return out

    @staticmethod
    def answer_bytes(answer: list) -> int:
        """Bytes of a campaign's answer on the host."""
        total = 0
        for part in answer:
            arrays = part.values() if isinstance(part, dict) else part
            total += sum(np.asarray(a).nbytes for a in arrays)
        return total

    def well_formed(self, answer: list) -> bool:
        """Shapes, finite energies, no clipped front, full top-k sets."""
        for part, n, progs in zip(answer, self.lanes, self.programs):
            if self.reduce is None:
                if (any(np.asarray(part[f]).shape != (n,)
                        for f in RESULT_FIELDS)
                        or not np.isfinite(part["energy_pj"]).all()
                        or not np.isfinite(part["power_mw"]).all()):
                    return False
                continue
            count = np.asarray(part.count)
            want = (min(self.reduce.k_out, n // len(progs))
                    if isinstance(self.reduce, self.pareto.TopK) else None)
            if (count.shape != (len(progs),) or (count < 1).any()
                    or np.asarray(part.clipped).sum() != 0
                    or (want is not None and (count != want).any())):
                return False
        return True
