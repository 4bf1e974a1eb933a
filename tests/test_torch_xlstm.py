"""The port's xLSTM family (xlstm-350m) against the reference, on the CPU.

The smoke config (4 layers = 2 (mLSTM, sLSTM) pairs, d_model 64, 2
heads; float32) is built in both packages with the same perturbed
weights (``tests/torch_lm_pairs.py``).  The two cells alone, each run
twice with the state carried from the first call into the second, the
model's forward and ``Model.loss``, prefill (every recurrent state
compared) with 8 teacher-forced decode steps, and the continuous-batching
Server agree at rtol = atol = 1e-4 (TOL) or token for token; ``convert``
carries the weights across exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.launch.serve import Server as RefServer  # noqa: E402
from repro.models import xlstm as RX  # noqa: E402
from repro.models import xlstm_model as RXM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import xlstm as X  # noqa: E402

from .torch_lm_pairs import (TOL, close, make_pair,  # noqa: E402
                             prefill_and_decode)

ARCH = "xlstm-350m"
_PAIRS = {}


def pair(**overrides):
    key = tuple(sorted(overrides.items()))
    if key not in _PAIRS:
        _PAIRS[key] = make_pair(ARCH, **overrides)
    return _PAIRS[key]


def test_configs_match_reference():
    for mine, ref in ((get_config(ARCH), ref_get_config(ARCH)),
                      (get_smoke_config(ARCH), ref_smoke(ARCH))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.vocab) == \
        (24, 1024, 4, 50304)


def test_init_shapes_and_convert_round_trip():
    rm, rp, pm, pp = pair()
    cfg = pm.cfg
    want = convert.model_params_from_jax(cfg, jax.tree.map(np.asarray, rp))
    fresh = pm.init(7).state_dict()
    assert {k: tuple(v.shape) for k, v in fresh.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert {k.split(".")[1] for k in fresh if k.startswith("pairs.")} == \
        {str(i) for i in range(cfg.n_layers // 2)}
    # the biases start as the reference's: forget gates at +3
    H, D = cfg.n_heads, cfg.d_model
    assert torch.equal(fresh["pairs.0.mlstm.bif"],
                       torch.tensor([[0.0, 3.0]] * H))
    assert torch.equal(fresh["pairs.1.slstm.b"][2 * D:3 * D],
                       torch.full((D,), 3.0))
    back = convert.model_params_to_jax(cfg, pp.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(rp):
        mine = back
        for key in path:
            mine = mine[key.key]
        assert np.array_equal(mine, np.asarray(leaf))
    again = convert.model_params_from_jax(cfg, back)
    assert all(torch.equal(again[k], v) for k, v in pp.state_dict().items())


def _states_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        close(g, w, TOL)


@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_cell_forward_with_a_carried_state_matches(cell):
    """A 7-step call from the initial state, then a 5-step call and a
    1-step call (decode) from the state it left."""
    rm, rp, pm, pp = pair()
    cfg = pm.cfg
    ref_fn = {"mlstm": RX.mlstm_forward, "slstm": RX.slstm_forward}[cell]
    fn = {"mlstm": X.mlstm_forward, "slstm": X.slstm_forward}[cell]
    rpl = jax.tree.map(lambda a: a[1], rp["pairs"][cell])
    mod = getattr(pp.pairs[1], cell)
    rng = np.random.default_rng(3)
    rst = st = None
    for S in (7, 5, 1):
        x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
        ry, rst = jax.jit(lambda p, x, s: ref_fn(p, rm.cfg, x, s))(
            rpl, jnp.asarray(x), rst)
        with torch.no_grad():
            y, st = fn(mod, cfg, torch.as_tensor(x), st)
        close(y, ry, TOL)
        _states_close(st, rst)


def test_bf16_mlstm_follows_the_reference_scan_dtype():
    """bfloat16 input: q and k come out of the reference's scaling in
    float32, and ride the scan in bf16 only under bf16_elementwise; the
    output within bf16 rounding (5e-2), the state at 1e-2."""
    for bf16_elem in (False, True):
        rm, rp, pm, pp = pair(dtype="bfloat16", bf16_elementwise=bf16_elem)
        rpl = jax.tree.map(lambda a: a[0], rp["pairs"]["mlstm"])
        x = np.random.default_rng(4).standard_normal(
            (1, 6, pm.cfg.d_model)).astype(np.float32)
        ry, rst = jax.jit(lambda p, x: RX.mlstm_forward(p, rm.cfg, x))(
            rpl, jnp.asarray(x, jnp.bfloat16))
        with torch.no_grad():
            y, st = X.mlstm_forward(pp.pairs[0].mlstm, pm.cfg,
                                    torch.as_tensor(x).bfloat16())
        assert y.dtype == torch.bfloat16
        close(y.float(), np.asarray(ry, np.float32), 5e-2)
        for g, w in zip(st, rst):
            close(g, w, 1e-2)


def test_forward_and_loss_match():
    rm, rp, pm, pp = pair()
    cfg = pm.cfg
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (2, 16))
    labels = rng.integers(0, cfg.vocab, (2, 16))
    rlog, _ = jax.jit(lambda p, t: RXM.forward(p, rm.cfg, t))(
        rp, jnp.asarray(toks))
    rloss, rmet = jax.jit(rm.loss)(rp, {"tokens": jnp.asarray(toks),
                                        "labels": jnp.asarray(labels)})
    with torch.no_grad():
        plog, paux = pp(torch.as_tensor(toks))
        ploss, pmet = pm.loss(pp, {"tokens": torch.as_tensor(toks),
                                   "labels": torch.as_tensor(labels)})
    assert plog.shape == rlog.shape and float(paux) == 0.0
    close(plog, rlog, TOL)
    close(ploss, rloss, TOL)
    for key in ("nll", "z_loss"):
        close(pmet[key], rmet[key], TOL)


def test_prefill_and_teacher_forced_decode_match(monkeypatch):
    """Prefill (all seven state leaves of both pairs compared), then 8
    teacher-forced decode steps."""
    prefill_and_decode(monkeypatch, *pair(), S=13, steps=8, seed=6)


def _serve_all(srv, requests, gen=6):
    pending = list(requests)
    done = []
    for _ in range(200):
        for s in range(srv.slots):
            if not srv.active[s] and pending:
                srv.admit(s, pending.pop())
        if not srv.active.any():
            break
        srv.step()
        for s in range(srv.slots):
            if srv.active[s] and len(srv.outputs[s]) >= gen:
                done.append([int(t) for t in srv.outputs[s]])
                srv.active[s] = False
    return done


def test_continuous_batching_outputs_equal_reference():
    """5 requests of 8 tokens through 2 slots: a slot's state is
    replaced whole at each admit, and its neighbour's goes on."""
    rm, rp, pm, pp = pair()
    rng = np.random.default_rng(7)
    requests = [rng.integers(0, pm.cfg.vocab, 8) for _ in range(5)]
    want = _serve_all(RefServer(rm, rp, slots=2, context=32), requests)
    got = _serve_all(serve.Server(pm, pp, slots=2, context=32), requests)
    assert len(got) == 5 and all(len(d) >= 6 for d in got)
    assert got == want


def test_main_serves_xlstm_on_the_cpu(capsys):
    done = serve.main(["--arch", ARCH, "--smoke", "--requests", "3",
                       "--batch-slots", "2", "--prompt-len", "6", "--gen",
                       "3", "--context", "16", "--device", "cpu"])
    assert len(done) == 3 and all(len(d) >= 3 for d in done)
    assert "[serve] 3 requests" in capsys.readouterr().out
