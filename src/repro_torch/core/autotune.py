"""Per-shape autotune cache for the sweep engine.

``blk_b`` (lanes per CUDA block), ``chunk_steps`` (instructions per
engine chunk, after which the host checks whether every lane is done)
and ``max_buckets`` (length-bucket count of a packed multi-kernel sweep)
depend on the *shape class* of a sweep -- ``(G, t_max, H, D, device,
n_devices)`` -- not on the kernel contents.  None of them changes a
result.  This module gives the DSE stack one answer to "what config
should this shape run with":

  * ``AutotuneCache.resolve`` fills any ``AUTO`` knob from a persisted
    JSON cache of previously timed winners, falling back to the static
    defaults (32 / 64 / 4) on a miss -- so an untuned system behaves
    exactly as before;
  * ``tune_sweep`` times a small candidate grid on the actual sweep and
    persists the winner;
  * the cache file is schema-checked: a corrupt file, a stale version,
    or a malformed entry is *dropped*, never fatal -- the cache is an
    accelerator, not a dependency.

The shape class's device axis is the device type (``"cuda"`` or
``"cpu"``), so a timing taken on the host never feeds the card.  The
cache is the port's own: ``~/.cache/repro_torch/autotune.json``, moved
with ``REPRO_TORCH_AUTOTUNE_CACHE=/path/to/cache.json``; automatic
first-encounter tuning is opted into with ``REPRO_TORCH_AUTOTUNE=1`` (or
``dse.sweep(..., autotune=True)``).

Consulted by ``dse.sweep``, ``dse.make_bucketed_sweep_fn`` and
``dse.search_mappings`` (every knob defaults to ``AUTO``; a sharded
sweep's shape class counts its mesh's entries), by
``service.runner.ResumableSweepRunner`` (blk_b / chunk_steps) and by
``service.server.SweepService`` (bucket count of request packing).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Union

try:
    import fcntl
except ImportError:          # non-POSIX: saves fall back to atomic
    fcntl = None             # last-writer-wins

# The sentinel for "let the autotuner decide".  Not None:
# ``chunk_steps=None`` already means "one chunk of max_steps".
AUTO = "auto"

DEFAULT_BLK_B = 32
DEFAULT_CHUNK_STEPS = 64
DEFAULT_MAX_BUCKETS = 4
CACHE_VERSION = 1
DEVICES = ("cuda", "cpu")
# threads per block the sweep kernel may launch: blk_b lanes of P PEs
MAX_BLOCK_THREADS = 1024
_ENV_CACHE = "REPRO_TORCH_AUTOTUNE_CACHE"
_ENV_ENABLE = "REPRO_TORCH_AUTOTUNE"


def is_auto(*values) -> bool:
    """True if ANY of the values is the AUTO sentinel."""
    return any(isinstance(v, str) and v == AUTO for v in values)


def autotune_enabled(flag: Optional[bool] = None) -> bool:
    """Explicit flag wins; otherwise the REPRO_TORCH_AUTOTUNE opt-in."""
    if flag is not None:
        return bool(flag)
    return os.environ.get(_ENV_ENABLE, "") not in ("", "0", "false", "no")


@dataclasses.dataclass(frozen=True)
class ShapeClass:
    """The tuning key: what a sweep looks like to the engine.  H and D
    are the hardware/data grid extents for ``dse.sweep``; the service's
    merged plans use ``H = lanes per program, D = 1`` as the lane-shape
    proxy.  ``device`` is the device type the sweep runs on."""
    G: int
    t_max: int
    H: int
    D: int
    device: str
    n_devices: int = 1

    def __post_init__(self):
        if self.device not in DEVICES:
            raise ValueError(f"ShapeClass: device must be one of "
                             f"{DEVICES}, got {self.device!r}")

    @property
    def key(self) -> str:
        return (f"g{self.G}-t{self.t_max}-h{self.H}-d{self.D}-"
                f"{self.device}-dev{self.n_devices}")


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """A resolved knob set.  ``source`` records where it came from:
    ``"default"`` (static fallbacks), ``"cache"`` (persisted winner),
    ``"tuned"`` (just timed), ``"explicit"`` (caller pinned every
    knob)."""
    blk_b: int
    chunk_steps: Optional[int]
    max_buckets: int
    source: str = "default"
    points_per_s: Optional[float] = None


def _is_count(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool) and v >= 1


def _valid_entry(e) -> bool:
    """One cache entry against the schema; invalid entries are skipped."""
    if not isinstance(e, dict) or "chunk_steps" not in e:
        return False
    cs = e["chunk_steps"]
    if not (_is_count(e.get("blk_b")) and _is_count(e.get("max_buckets"))
            and (cs is None or _is_count(cs))):
        return False
    pps = e.get("points_per_s")
    if pps is not None and not (isinstance(pps, (int, float))
                                and not isinstance(pps, bool)):
        return False
    return e.get("device") in DEVICES


def _default_path() -> Path:
    env = os.environ.get(_ENV_CACHE, "")
    if env:
        return Path(env)
    return Path.home() / ".cache" / "repro_torch" / "autotune.json"


class AutotuneCache:
    """Schema-checked JSON store of per-shape winners.

    Load is tolerant: an unreadable file, invalid JSON, a wrong version
    or a malformed entry all degrade to "no cached winner" -- ``resolve``
    then falls back to the static defaults.  Saves are atomic (tmp +
    rename) and merge under an ``fcntl`` file lock: a save re-reads the
    on-disk entries and unions them with this process's (ours win per
    key), so concurrent workers keep each other's shape classes.  If the
    lock cannot be taken within ``lock_timeout_s`` (or the platform has
    no ``fcntl``), the save degrades to the plain atomic write."""

    def __init__(self, path: Optional[Union[str, Path]] = None, *,
                 lock_timeout_s: float = 1.0):
        self.path = Path(path) if path is not None else _default_path()
        self.lock_timeout_s = lock_timeout_s
        self.entries: Dict[str, dict] = self._read_entries()

    def _read_entries(self) -> Dict[str, dict]:
        """Current on-disk entries (schema-filtered); {} on any damage."""
        try:
            raw = json.loads(self.path.read_text())
        except (OSError, ValueError):
            return {}
        if not isinstance(raw, dict) \
                or raw.get("version") != CACHE_VERSION \
                or not isinstance(raw.get("entries"), dict):
            return {}                        # stale/foreign cache: ignore
        return {k: v for k, v in raw["entries"].items()
                if isinstance(k, str) and _valid_entry(v)}

    @contextlib.contextmanager
    def _locked(self):
        """Yield True holding an exclusive lock on ``<cache>.lock``,
        False when the lock is unavailable (timeout / no fcntl)."""
        if fcntl is None or self.lock_timeout_s <= 0:
            yield False
            return
        lock_path = self.path.with_name(self.path.name + ".lock")
        try:
            fd = os.open(str(lock_path), os.O_CREAT | os.O_RDWR, 0o644)
        except OSError:
            yield False
            return
        try:
            deadline = time.monotonic() + self.lock_timeout_s
            while True:
                try:
                    fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                    break
                except OSError:
                    if time.monotonic() >= deadline:
                        yield False
                        return
                    time.sleep(0.01)
            try:
                yield True
            finally:
                fcntl.flock(fd, fcntl.LOCK_UN)
        finally:
            os.close(fd)

    def save(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with self._locked() as held:
            if held:
                # read-merge-write: union the entries another worker
                # persisted since our load; our own keys win conflicts
                merged = self._read_entries()
                merged.update(self.entries)
                self.entries = merged
            payload = {"version": CACHE_VERSION, "entries": self.entries}
            fd, tmp = tempfile.mkstemp(dir=str(self.path.parent),
                                       prefix=self.path.name, suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(payload, f, indent=2, sort_keys=True)
                    f.write("\n")
                os.replace(tmp, self.path)
            except OSError:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass

    def lookup(self, shape: ShapeClass) -> Optional[TunedConfig]:
        e = self.entries.get(shape.key)
        if e is None:
            return None
        return TunedConfig(blk_b=e["blk_b"], chunk_steps=e["chunk_steps"],
                           max_buckets=e["max_buckets"], source="cache",
                           points_per_s=e.get("points_per_s"))

    def store(self, shape: ShapeClass, cfg: TunedConfig) -> None:
        self.entries[shape.key] = {
            "blk_b": int(cfg.blk_b),
            "chunk_steps": (None if cfg.chunk_steps is None
                            else int(cfg.chunk_steps)),
            "max_buckets": int(cfg.max_buckets),
            "points_per_s": cfg.points_per_s,
            "device": shape.device,
            "shape": dataclasses.asdict(shape),
        }
        self.save()

    def resolve(self, shape: ShapeClass, *,
                blk_b: Union[int, str] = AUTO,
                chunk_steps: Union[int, None, str] = AUTO,
                max_buckets: Union[int, str] = AUTO) -> TunedConfig:
        """Fill AUTO knobs from the cache, else the static defaults;
        explicit (non-AUTO) knobs always win."""
        auto = is_auto(blk_b, chunk_steps, max_buckets)
        cached = self.lookup(shape) if auto else None
        source = ("explicit" if not auto
                  else "cache" if cached is not None else "default")

        def pick(explicit, name, default):
            if not is_auto(explicit):
                return explicit
            return getattr(cached, name) if cached is not None else default

        return TunedConfig(
            blk_b=int(pick(blk_b, "blk_b", DEFAULT_BLK_B)),
            chunk_steps=pick(chunk_steps, "chunk_steps",
                             DEFAULT_CHUNK_STEPS),
            max_buckets=int(pick(max_buckets, "max_buckets",
                                 DEFAULT_MAX_BUCKETS)),
            source=source,
            points_per_s=cached.points_per_s if cached else None)


_caches: Dict[str, AutotuneCache] = {}


def default_cache() -> AutotuneCache:
    """Process-wide cache for the current REPRO_TORCH_AUTOTUNE_CACHE
    target (re-resolved per call so tests can repoint the env)."""
    key = str(_default_path())
    c = _caches.get(key)
    if c is None:
        c = _caches[key] = AutotuneCache()
    return c


def default_candidates(shape: ShapeClass, max_steps: int,
                       n_pes: int = 16) -> List[dict]:
    """The candidate grid: bucket counts that make sense for G, chunk
    sizes around the default and, on the card, three block widths within
    the kernel's thread limit.  The plain version on the host has no
    blocks, so it times one width."""
    buckets = sorted({b for b in (1, 2, 4, min(shape.G, 8))
                      if 1 <= b <= shape.G})
    chunks = sorted({c for c in (32, 64, 128) if c <= max(max_steps, 32)})
    blks = ((16, 32, 64) if shape.device == "cuda" else (DEFAULT_BLK_B,))
    blks = [k for k in blks if k * n_pes <= MAX_BLOCK_THREADS]
    return [dict(max_buckets=b, chunk_steps=c, blk_b=k)
            for b in buckets for c in chunks for k in blks]


def _timer(device, devices=()) -> Callable[[Callable[[], object]], float]:
    """Seconds of one call: CUDA events around it on the card (the
    device's own clock), ``time.perf_counter`` on the host.  A sweep over
    several cards (``devices``) is timed on the host, from a synchronise
    of every card to the next."""
    import torch

    if len(devices) > 1:
        def timed(run):
            for d in devices:
                torch.cuda.synchronize(d)
            t0 = time.perf_counter()
            run()
            for d in devices:
                torch.cuda.synchronize(d)
            return time.perf_counter() - t0
        return timed

    if device.type == "cuda":
        def timed(run):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) * 1e-3
        return timed

    def timed(run):
        t0 = time.perf_counter()
        run()
        return time.perf_counter() - t0
    return timed


def tune_sweep(programs, profile, hw_configs, mem_images, *,
               max_steps: int = 2048, mem_size: int = 4096,
               device=None, cache: Optional[AutotuneCache] = None,
               candidates: Optional[Sequence[dict]] = None,
               repeats: int = 2,
               log: Optional[Callable[[dict, float], None]] = None,
               mesh=None) -> TunedConfig:
    """Time the candidate grid on the actual sweep and persist the winner.

    Each candidate holds its bucketed plan (``make_bucketed_sweep_fn``),
    runs once to warm up, then is timed ``repeats`` times (the minimum
    kept).  The winner lands in the cache keyed by the sweep's shape
    class, so every later AUTO-knob sweep of that shape runs with it.
    ``log(candidate, seconds)`` sees each candidate's best time.  With
    ``mesh`` the candidates are timed sharded, and the shape class
    counts the mesh's entries (``n_devices``).

    Import of dse is deferred (dse imports this module)."""
    from ..device import as_int32, resolve_device
    from ..parallel.sharding import mesh_device
    from . import dse
    from .program import as_program_batch

    dev = resolve_device(device) if mesh is None \
        else mesh_device(mesh, device)
    batch = as_program_batch(programs)
    images = as_int32(mem_images, dev)         # on the device once
    G, H, D = batch.n_programs, len(hw_configs), int(images.shape[0])
    shape = ShapeClass(G=G, t_max=batch.t_max, H=H, D=D, device=dev.type,
                       n_devices=1 if mesh is None else mesh.devices.size)
    cands = list(candidates) if candidates is not None \
        else default_candidates(shape, max_steps, batch.n_pes)
    timed = _timer(dev, () if mesh is None or dev.type != "cuda"
                   else mesh.distinct())
    best = None                               # (seconds, candidate)
    for cand in cands:
        fn = dse.make_bucketed_sweep_fn(
            batch, profile, hw_configs, images, max_steps=max_steps,
            mem_size=mem_size, chunk_steps=cand["chunk_steps"],
            blk_b=cand["blk_b"], max_buckets=cand["max_buckets"],
            device=dev, mesh=mesh)
        fn()                                  # warm up
        secs = min(timed(fn) for _ in range(max(1, repeats)))
        if log is not None:
            log(cand, secs)
        if best is None or secs < best[0]:
            best = (secs, cand)
    secs, cand = best
    cfg = TunedConfig(blk_b=cand["blk_b"], chunk_steps=cand["chunk_steps"],
                      max_buckets=cand["max_buckets"], source="tuned",
                      points_per_s=G * H * D / max(secs, 1e-9))
    (cache or default_cache()).store(shape, cfg)
    return cfg
