"""Sharding over a mesh of devices: the DSE grid's flat lane axis, and
the language models' logical-axis rules.

The (program x hw x data) grid of a sweep is one long lane axis.  A
``Mesh`` names the devices it is split over; ``flat_shards`` cuts a
padded lane axis into one contiguous slice per mesh entry, in the flat
order of the mesh's devices -- the reference's ``flat_batch_spec``, which
shards the batch over every mesh axis.  One process drives every device
of a mesh (single controller), so no process group is involved.

A mesh may repeat a device: ``Mesh([cuda:0] * 4)`` is four shards on one
card, each with its own lanes and launches, which is how a machine with
one card (or the host) runs a multi-shard sweep.  A mesh never mixes the
host and the card: its shards would run on two different engines.  A
mesh of meta entries only is abstract: it has a shape and axis names but
no device to run on (``launch.mesh.make_production_mesh`` without
devices, for the dry-run).

The language models' parameters, caches and inputs are annotated with
*logical* dimension names ("vocab", "embed", "mlp", "heads", ...); a
``ShardingRules`` table maps each name to a preference list of mesh
axes, and ``logical_to_spec`` resolves a tensor's names on a mesh: the
first axis that divides the dimension and is not yet used by another of
its dimensions wins, else the dimension is replicated.  These are the
reference's rules (``repro.parallel.sharding``), spec for spec.  One
process keeps every tensor whole, so a ``NamedSharding`` here says how
a tensor would be split (``shard_shape``: each device's block, which the
dry-run counts) and ``constrain`` changes no value.

Production mesh axes: ("pod", "data", "model") multi-pod / ("data",
"model") single-pod.  DP/FSDP ride ("pod", "data"); TP/EP/SP ride
"model".
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device]


def _as_device(d: DeviceLike) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """An n-d array of ``torch.device`` entries with named axes.

    ``devices`` is a numpy object array, so ``mesh.devices.size`` and
    ``np.asarray(mesh.devices).flat`` read as they do for a jax mesh."""

    def __init__(self, devices, axis_names: Sequence[str] = ("data",)):
        raw = np.asarray(devices, dtype=object)
        types = {torch.device(d).type for d in raw.flat}
        if len(types) > 1:
            raise ValueError(f"Mesh: entries mix device types {sorted(types)}"
                             f"; every shard must run on the same engine")
        if not types or not types <= {"cuda", "cpu", "meta"}:
            raise ValueError(f"Mesh: need cuda, cpu or meta entries, got "
                             f"{sorted(types)}")
        self.devices = np.empty(raw.shape, dtype=object)
        for i, d in np.ndenumerate(raw):
            self.devices[i] = _as_device(d)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"Mesh: {len(self.axis_names)} axis names for a "
                             f"{self.devices.ndim}-d device array")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type

    def flat(self) -> List[torch.device]:
        """Every entry, in flat order (repeats kept)."""
        return list(self.devices.flat)

    def distinct(self) -> List[torch.device]:
        """Each device once, in order of first appearance."""
        return list(dict.fromkeys(self.devices.flat))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.flat()]})"


def mesh_device(mesh: Mesh, device=None) -> torch.device:
    """The device a sharded sweep gathers its answer on (the mesh's
    first entry).  A ``device`` that names another engine, or a device
    outside the mesh, raises."""
    first = mesh.devices.flat[0]
    if device is None:
        return first
    d = torch.device(device)
    if d.type != first.type or (d.index is not None
                                and d not in mesh.distinct()):
        raise ValueError(f"device={d} disagrees with the mesh {mesh!r}")
    return first


def padded_len(n: int, n_devices: int) -> int:
    """Smallest multiple of ``n_devices`` >= n (flat-grid pad target)."""
    return -(-n // n_devices) * n_devices


def pad_batch(x, target: int, fill=None):
    """Pad a leading batch axis (tensor or numpy array) to ``target`` rows.

    The pad repeats row 0: lanes are independent, so a repeated lane is
    redundant work and callers slice outputs back to the true length.
    With ``fill`` the pad rows hold that constant instead (a reduced
    sweep pads ``lane_idx`` with -1, so pad lanes never become
    candidates)."""
    pad = target - x.shape[0]
    if pad <= 0:
        return x
    if isinstance(x, torch.Tensor):
        rows = (torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                           device=x.device) if fill is not None
                else x[:1].expand((pad,) + tuple(x.shape[1:])))
        return torch.cat([x, rows])
    x = np.asarray(x)
    rows = (np.full((pad,) + x.shape[1:], fill, x.dtype) if fill is not None
            else np.broadcast_to(x[:1], (pad,) + x.shape[1:]))
    return np.concatenate([x, rows])


def flat_shards(n_padded: int, mesh: Mesh
                ) -> List[Tuple[torch.device, int, int]]:
    """``[(device, lo, hi)]``: one contiguous slice of a padded lane axis
    per mesh entry, in the flat order of the mesh's devices."""
    n = mesh.devices.size
    if n_padded % n:
        raise ValueError(f"{n_padded} lanes do not split over {n} shards; "
                         f"pad to padded_len first")
    per = n_padded // n
    return [(d, i * per, (i + 1) * per) for i, d in enumerate(mesh.flat())]


# ---------------------------------------------------------------------------
# The language models' logical-axis rules
# ---------------------------------------------------------------------------

Axes = Tuple[str, ...]

# Preference chains per logical dimension name.  Order matters: the first
# mesh axis whose size divides the dim (and is still free) is chosen.
DEFAULT_RULES: Dict[str, Axes] = {
    # --- parameters -------------------------------------------------------
    "vocab": ("model",),             # TP over the vocabulary (logit matmul)
    "embed": ("data", "pod"),        # FSDP: shard d_model rows over DP axes
    "embed_tp": ("model",),          # d_model when it is the TP dim
    "mlp": ("model",),               # FFN hidden (Megatron column/row)
    "heads": ("model",),             # query heads
    "kv_heads": ("model",),          # kv heads (replicated when < axis)
    "head_dim": (),                  # only sharded under attn_tp=head_dim
    "head_dim_tp": ("model",),
    "qkv": ("model",),               # flattened q/k/v output dim
    "experts": ("model", "data"),    # EP; falls back to DP-sharded experts
    "expert_mlp": ("model",),        # per-expert hidden when EP impossible
    "conv": (),                      # small conv kernels: replicated
    "ssm_inner": ("model",),         # mamba2 inner channels
    "ssm_heads": ("model",),
    "ssm_state": (),
    # --- activations ------------------------------------------------------
    "batch": ("pod", "data"),        # tried in order, combined below
    "seq": (),                       # SP off by default (opt-in per config)
    "seq_sp": ("model",),            # context/sequence parallelism
    "act_embed": (),                 # activations replicated over model by
    "act_mlp": ("model",),           #   default; mlp/heads TP-sharded
    "act_heads": ("model",),
    "act_kv": (),
    "cache_batch": ("data",),
    # decode caches shard their context dim over the TP axis
    "cache_seq": ("model",),
    "cache_heads": ("model",),
    # --- optimizer --------------------------------------------------------
    "none": (),
}

# Logical names whose preference list is *combined* (mesh axes tupled
# together) rather than tried in order, e.g. batch over pod AND data.
_COMBINE = {"batch": ("pod", "data"), "embed": ("data", "pod")}


class PartitionSpec(tuple):
    """One entry a tensor dimension: a mesh axis name, a tuple of names
    (the dimension split over their product) or None (replicated).  A
    tuple, so it compares equal to ``jax.sharding.PartitionSpec``'s
    entries."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class ShardingRules:
    def __init__(self, table: Optional[Dict[str, Axes]] = None,
                 combine: Optional[Dict[str, Axes]] = None):
        self.table = dict(DEFAULT_RULES)
        if table:
            self.table.update(table)
        self.combine = dict(_COMBINE)
        if combine is not None:
            self.combine = dict(combine)

    def with_overrides(self, **kw: Axes) -> "ShardingRules":
        r = ShardingRules(self.table, self.combine)
        r.table.update(kw)
        return r


def _axis_size(mesh, name: str) -> int:
    try:
        return mesh.shape[name]
    except (KeyError, TypeError):
        return 0


def logical_to_spec(logical: Sequence[Optional[str]], shape: Sequence[int],
                    mesh, rules: Optional[ShardingRules] = None
                    ) -> PartitionSpec:
    """Resolve logical dim names -> PartitionSpec for ``mesh`` (any object
    whose ``.shape`` is a dict of axis sizes).

    Combined names (e.g. "batch") may claim several axes at once if the
    product divides the dim; otherwise they degrade to the longest
    divisible prefix.  Every mesh axis is used at most once per tensor."""
    rules = rules or current_rules()
    used: set = set()
    out = []
    for dim, name in zip(shape, logical):
        if name is None or name not in rules.table and name not in \
                rules.combine:
            out.append(None)
            continue
        if name in rules.combine:
            cand = [a for a in rules.combine[name]
                    if _axis_size(mesh, a) > 0 and a not in used]
            chosen: list = []
            prod = 1
            for a in cand:
                if dim % (prod * _axis_size(mesh, a)) == 0:
                    chosen.append(a)
                    prod *= _axis_size(mesh, a)
            if chosen:
                used.update(chosen)
                out.append(tuple(chosen) if len(chosen) > 1 else chosen[0])
            else:
                out.append(None)
            continue
        for a in rules.table.get(name, ()):
            sz = _axis_size(mesh, a)
            if sz > 0 and a not in used and dim % sz == 0:
                used.add(a)
                out.append(a)
                break
        else:
            out.append(None)
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


class NamedSharding:
    """A spec on a mesh: how a tensor of a given global shape would be
    split over the mesh's devices."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, PartitionSpec(*spec)

    def shard_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        """Each device's block of a tensor of ``global_shape``; raises
        where a dimension does not divide over its axes."""
        out = list(global_shape)
        for i, names in enumerate(self.spec):
            if names is None:
                continue
            n = 1
            for a in (names if isinstance(names, tuple) else (names,)):
                n *= self.mesh.shape[a]
            if out[i] % n:
                raise ValueError(f"dimension {i} of {tuple(global_shape)} "
                                 f"does not split {n} ways ({self.spec})")
            out[i] //= n
        return tuple(out)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec!r})"


def is_axes(x) -> bool:
    """A leaf of an axes tree: a plain tuple of names and Nones (``()``
    for a scalar), not a named tuple of such."""
    return (type(x) is tuple
            and all(isinstance(e, (str, type(None))) for e in x))


def tree_map_axes(fn, axes_tree, *trees):
    """``fn(axes, *leaves)`` over an axes tree and trees of the same
    structure (dicts, named tuples, tuples, lists; None stays None)."""
    if is_axes(axes_tree):
        return fn(axes_tree, *trees)
    if axes_tree is None:
        return None
    if isinstance(axes_tree, dict):
        return {k: tree_map_axes(fn, a, *(t[k] for t in trees))
                for k, a in axes_tree.items()}
    if isinstance(axes_tree, (tuple, list)):
        parts = [tree_map_axes(fn, *xs) for xs in zip(axes_tree, *trees)]
        if hasattr(axes_tree, "_fields"):
            return type(axes_tree)(*parts)
        return type(axes_tree)(parts)
    raise TypeError(f"not an axes tree: {axes_tree!r}")


def spec_tree(axes_tree, shapes_tree, mesh,
              rules: Optional[ShardingRules] = None):
    """A tree of logical-axes tuples + the matching tensors (or shapes)
    -> NamedShardings."""
    def one(axes, shaped):
        shape = shaped.shape if hasattr(shaped, "shape") else shaped
        return NamedSharding(mesh, logical_to_spec(axes, shape, mesh, rules))
    return tree_map_axes(one, axes_tree, shapes_tree)


# ---------------------------------------------------------------------------
# Activation constraints: thread-local (mesh, rules) context so model code
# can annotate without plumbing the mesh through every call.
# ---------------------------------------------------------------------------

_CTX = threading.local()


@contextlib.contextmanager
def use_mesh_rules(mesh: Optional[Mesh], rules: Optional[ShardingRules]):
    prev = getattr(_CTX, "state", None)
    _CTX.state = (mesh, rules or ShardingRules())
    try:
        yield
    finally:
        _CTX.state = prev


def set_rules(mesh: Optional[Mesh], rules: Optional[ShardingRules] = None):
    _CTX.state = (mesh, rules or ShardingRules())


def current_rules() -> ShardingRules:
    st = getattr(_CTX, "state", None)
    return st[1] if st else ShardingRules()


def current_mesh() -> Optional[Mesh]:
    st = getattr(_CTX, "state", None)
    return st[0] if st else None


def constrain(x, *logical: Optional[str]):
    """The reference's ``with_sharding_constraint`` by logical names.
    ``x`` unchanged when no mesh is active or it has one entry; on a
    larger mesh the spec is resolved (raising where the reference's
    would) and ``x`` is returned unchanged: one process keeps the tensor
    whole, and a sharding constraint never changes values."""
    mesh = current_mesh()
    if mesh is None or np.asarray(mesh.devices).size <= 1:
        return x
    logical_to_spec(logical, x.shape, mesh, current_rules())
    return x


# ---------------------------------------------------------------------------
# The flat batch axis of a sweep over every axis of the mesh
# ---------------------------------------------------------------------------

def flat_batch_spec(mesh: Mesh) -> PartitionSpec:
    """PartitionSpec sharding a leading batch axis over all mesh axes."""
    return PartitionSpec(tuple(mesh.axis_names))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """NamedSharding for a flat batch axis over the whole mesh."""
    return NamedSharding(mesh, flat_batch_spec(mesh))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    """Fully-replicated NamedSharding on ``mesh``."""
    return NamedSharding(mesh, PartitionSpec())
