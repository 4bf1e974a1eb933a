"""The port's logical-axis sharding rules against the reference's.

Every case of tests/test_sharding_rules.py runs through both packages
and the specs are compared entry for entry; then every parameter of
every full-size architecture, on both production mesh shapes: the
port's axes (declared by each module at construction) equal the
reference's ``param_shapes()[1]`` once the port's per-layer names are
restacked by ``convert.stacks`` (a stacked leaf's axes have a leading
None per stacked dim), the resolved specs are equal, and so are the
per-device bytes of the float32 state (parameters and two moments).
Meshes are abstract: only ``.shape`` is read, no device is needed.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import make_model as ref_make
from repro.parallel import sharding as rsh
from repro.train.train_step import state_axes as ref_state_axes
from repro_torch import convert
from repro_torch.configs import get_config, list_archs
from repro_torch.launch.dryrun import bytes_per_device
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import make_model
from repro_torch.parallel import sharding as psh
from repro_torch.parallel.sharding import Mesh, NamedSharding, PartitionSpec
from repro_torch.train.optim import OptState
from repro_torch.train.train_step import TrainState, state_axes


class FakeMesh:
    """Duck-typed mesh: only .shape (dict) is consulted by the rules."""

    def __init__(self, **shape):
        self.shape = shape


MESH1 = FakeMesh(data=16, model=16)
MESH2 = FakeMesh(pod=2, data=16, model=16)
MESHES = {"single": MESH1, "multi": MESH2}

# (logical, shape, mesh, the reference test's expected spec)
CASES = [
    (("embed", "mlp"), (2048, 8192), "single", ("data", "model")),
    (("embed", "heads", None), (960, 15, 64), "single", ("data",)),
    (("batch", None), (256, 4096), "multi", (("pod", "data"),)),
    (("batch", None), (1, 1), "multi", ()),
    (("batch", None), (2, 128), "multi", ("pod",)),
    (("vocab", "embed_tp"), (32768, 6144), "single", ("model",)),
    (("experts", "embed", "expert_mlp"), (32, 1024, 512), "single",
     ("model", "data")),
    (("experts", "embed", "expert_mlp"), (8, 6144, 16384), "single",
     (None, "data", "model")),
    # beyond the reference test: heads fall back, head_dim stays, the
    # decode cache, an unknown name, a combined name on one pod
    (("embed", "kv_heads", "head_dim"), (2048, 8, 64), "single",
     ("data",)),
    ((None, "cache_batch", "cache_seq", "cache_heads", None),
     (16, 128, 32768, 8, 64), "single", (None, "data", "model")),
    (("no_such_name", "mlp"), (16, 64), "single", (None, "model")),
    (("embed", None), (2048, 3), "multi", (("data", "pod"),)),
]


@pytest.mark.parametrize("logical,shape,mesh,want", CASES)
def test_spec_equals_reference(logical, shape, mesh, want):
    m = MESHES[mesh]
    got = psh.logical_to_spec(logical, shape, m, psh.ShardingRules())
    ref = rsh.logical_to_spec(logical, shape, m, rsh.ShardingRules())
    assert isinstance(got, PartitionSpec)
    assert got == ref and ref == got
    assert tuple(got) == want


def test_overrides_and_combine_match_reference():
    for kw in ({"heads": ("data",)}, {"seq": ("model",)}):
        pr = psh.ShardingRules().with_overrides(**kw)
        rr = rsh.ShardingRules().with_overrides(**kw)
        assert pr.table == rr.table and pr.combine == rr.combine
    for logical, shape in ((("heads", "seq"), (32, 4096)),
                           (("batch", "seq"), (64, 4096))):
        assert psh.logical_to_spec(logical, shape, MESH2, pr) == \
            rsh.logical_to_spec(logical, shape, MESH2, rr)
    no_comb = (psh.ShardingRules(combine={}), rsh.ShardingRules(combine={}))
    assert psh.logical_to_spec(("batch",), (256,), MESH2, no_comb[0]) == \
        rsh.logical_to_spec(("batch",), (256,), MESH2, no_comb[1])
    assert psh.DEFAULT_RULES == rsh.DEFAULT_RULES
    assert psh._COMBINE == rsh._COMBINE


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _restack(cfg, port: dict) -> dict:
    """Port names (``layers.3.attn.wq``) -> the reference's stacked leaf
    names, each with its per-layer value (all layers must agree)."""
    out = {}
    for name, v in port.items():
        for stack, lead, pname in convert.stacks(cfg):
            if name.startswith(pname + "."):
                leaf = f"{stack}.{name.split('.', 2)[2]}"
                out.setdefault(leaf, (len(lead), []))[1].append(v)
                break
        else:
            out[name] = (0, [v])
    return out


def _shard_elems(spec, shape, mesh) -> int:
    n = int(np.prod(shape))
    for names in tuple(spec):
        if names is None:
            continue
        group = names if isinstance(names, tuple) else (names,)
        n //= int(np.prod([mesh.shape[a] for a in group]))
    return n


_REF = {}


def _ref_params(arch):
    if arch not in _REF:
        p, a = ref_make(ref_config(arch)).param_shapes()
        _REF[arch] = (dict(_flat(p)), dict(_flat(a)))
    return _REF[arch]


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", list_archs())
def test_param_axes_specs_and_bytes_equal_reference(arch, mesh):
    cfg = get_config(arch)
    pshapes, paxes = make_model(cfg, device="meta").param_shapes()
    rshapes, raxes = _ref_params(arch)
    m = MESHES[mesh]
    rules, rrules = psh.ShardingRules(), rsh.ShardingRules()
    assert list(pshapes) == list(paxes)
    stacked = _restack(cfg, paxes)
    assert set(stacked) == set(raxes), set(stacked) ^ set(raxes)
    port_bytes = ref_bytes = 0
    for leaf, (k, axes_list) in stacked.items():
        assert all(a == axes_list[0] for a in axes_list), leaf
        assert (None,) * k + axes_list[0] == raxes[leaf], leaf
    for name, t in pshapes.items():
        spec = psh.logical_to_spec(paxes[name], t.shape, m, rules)
        port_bytes += _shard_elems(spec, t.shape, m) * 4
        assert NamedSharding(m, spec).shard_shape(t.shape) is not None
    for leaf, sds in rshapes.items():
        rspec = rsh.logical_to_spec(raxes[leaf], sds.shape, m, rrules)
        ref_bytes += _shard_elems(rspec, sds.shape, m) * 4
        k, axes_list = stacked[leaf]
        per_layer = sds.shape[k:]
        spec = psh.logical_to_spec(axes_list[0], per_layer, m, rules)
        assert rspec == (((None,) * k + tuple(spec)) if spec else ()), leaf
    assert port_bytes == ref_bytes
    # the dry-run's count of the f32 state a device holds: parameters and
    # two moments (the reference test's sum), and the int32 step
    step = torch.empty((), dtype=torch.int32, device="meta")
    state = TrainState(params=pshapes, opt=OptState(step, pshapes, pshapes),
                       ef=None)
    assert bytes_per_device(state_axes(paxes), state, m) == \
        3 * ref_bytes + 4


@pytest.mark.parametrize("compress", [False, True])
def test_state_axes_equal_reference(compress):
    axes = {"embed.table": ("vocab", "embed"), "ln_f.scale": ("embed_tp",)}
    got, want = state_axes(axes, compress), ref_state_axes(axes, compress)
    assert got._fields == want._fields
    assert got.params == want.params and got.opt.step == want.opt.step == ()
    assert got.opt.mu == want.opt.mu and got.opt.nu == want.opt.nu
    if compress:
        assert got.ef.residual == want.ef.residual
    else:
        assert got.ef is None and want.ef is None


def test_spec_tree_resolves_a_train_state():
    cfg = get_config("llama3.2-1b")
    pshapes, paxes = make_model(cfg, device="meta").param_shapes()
    step = torch.empty((), dtype=torch.int32, device="meta")
    state = TrainState(params=pshapes, opt=OptState(step, pshapes, pshapes),
                       ef=None)
    mesh = make_production_mesh()
    tree = psh.spec_tree(state_axes(paxes), state, mesh)
    assert tree.ef is None and tree.opt.step.spec == ()
    assert tree.params["embed.table"].spec == ("model", "data")
    assert tree.opt.mu["layers.0.attn.wq"].spec == ("data", "model")
    assert tree.params["embed.table"].shard_shape((128256, 2048)) == \
        (128256 // 16, 2048 // 16)


def test_production_mesh_is_abstract_and_meshes_do_not_mix():
    single, multi = (make_production_mesh(),
                     make_production_mesh(multi_pod=True))
    assert single.shape == {"data": 16, "model": 16}
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.devices.size == 512 and multi.device_type == "meta"
    with pytest.raises(ValueError, match="mix"):
        Mesh(["meta", "cpu"], ("data",))
    cpu = make_mesh((16, 16), ("data", "model"), devices=["cpu"] * 256)
    assert cpu.device_type == "cpu" and cpu.shape == single.shape


def test_shard_shape_refuses_a_split_that_does_not_divide():
    sh = NamedSharding(MESH1, PartitionSpec("data", None))
    assert sh.shard_shape((32, 5)) == (2, 5)
    with pytest.raises(ValueError, match="split 16"):
        sh.shard_shape((15, 5))
    both = NamedSharding(MESH2, PartitionSpec(("pod", "data")))
    assert both.shard_shape((64,)) == (2,)


def test_constrain_and_mesh_context_follow_reference():
    x = torch.ones(8, 15)
    assert psh.current_mesh() is None
    assert psh.constrain(x, "batch", "heads") is x       # no mesh
    one = Mesh(["cpu"], ("data",))
    with psh.use_mesh_rules(one, None):
        assert psh.current_mesh() is one
        assert psh.constrain(x, "batch", "heads") is x
    big = make_mesh((16, 16), ("data", "model"), devices=["cpu"] * 256)
    rules = psh.ShardingRules().with_overrides(heads=("model",))
    with psh.use_mesh_rules(big, rules):
        assert psh.current_rules() is rules
        assert psh.constrain(x, "batch", "heads") is x    # resolved, kept
        # a name the rules cannot look up raises in both packages
        with pytest.raises(TypeError):
            rsh.logical_to_spec((["batch"], None), x.shape, big, rules)
        with pytest.raises(TypeError):
            psh.constrain(x, ["batch"], None)
    assert psh.current_mesh() is None
    psh.set_rules(None)
    assert psh.current_mesh() is None


@pytest.mark.parametrize("shape,axes", [((1,), ("data",)),
                                        ((1, 1), ("data", "model"))])
def test_flat_batch_and_replicated_specs_equal_reference(shape, axes):
    rmesh = jax.make_mesh(shape, axes)
    pmesh = Mesh(np.full(shape, "cpu", dtype=object), axes)
    assert psh.flat_batch_spec(pmesh) == rsh.flat_batch_spec(rmesh)
    assert psh.batch_sharding(pmesh).spec == rsh.batch_sharding(rmesh).spec
    assert psh.replicated_sharding(pmesh).spec == \
        rsh.replicated_sharding(rmesh).spec
