"""The port's encoder-decoder family (whisper-small) against the
reference, on the CPU.

The smoke config (2 + 2 layers, d_model 64, 4 heads, 16 frames; float32)
is built in both packages with the same perturbed weights
(``tests/torch_lm_pairs.py``); frames are seeded numpy.  ``encode``, the
teacher-forced ``forward``, ``Model.loss``, prefill (its self-attention
caches and the encoder's k/v), 8 teacher-forced decode steps and the
continuous-batching Server (frames through ``admit(extras=)``) agree at
rtol = atol = 1e-4 (TOL) or token for token; ``convert`` carries the
weights across exactly.  Also here: the two command lines, since neither
makes frames (the reference's fails with a ``KeyError``, the port's
refuses with a ``ValueError``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import encdec as RE  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

from .torch_lm_pairs import (TOL, cache_leaves, close,  # noqa: E402
                             make_pair, prefill_and_decode)

ARCH = "whisper-small"
_PAIR = []


def pair():
    if not _PAIR:
        _PAIR.append(make_pair(ARCH))
    return _PAIR[0]


def _frames(cfg, B, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)


def test_init_shapes_and_convert_round_trip():
    rm, rp, pm, pp = pair()
    cfg = pm.cfg
    want = convert.model_params_from_jax(cfg, jax.tree.map(np.asarray, rp))
    got = pm.init(7).state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert got["enc_pos"].shape == (cfg.enc_seq, cfg.d_model)
    assert got["dec_pos"].shape == (1 << 16, cfg.d_model)
    assert "dec_layers.1.ln_x.bias" in got and "embed.head" not in got
    assert sum(k.startswith("enc_layers.") for k in got) == \
        cfg.n_enc_layers * sum(k.startswith("enc_layers.0.") for k in got)
    # both directions are exact, stack by stack
    back = convert.model_params_to_jax(cfg, pp.state_dict())
    flat = jax.tree_util.tree_leaves_with_path(rp)
    assert len(flat) == len(jax.tree.leaves(back))
    for path, leaf in flat:
        mine = back
        for key in path:
            mine = mine[key.key]
        assert np.array_equal(mine, np.asarray(leaf))
    again = convert.model_params_from_jax(cfg, back)
    assert all(torch.equal(again[k], v) for k, v in pp.state_dict().items())


def test_encode_matches():
    rm, rp, pm, pp = pair()
    frames = _frames(pm.cfg, 2, 0)
    want = jax.jit(lambda p, f: RE.encode(p, rm.cfg, f))(
        rp, jnp.asarray(frames))
    with torch.no_grad():
        got = pp.encode(torch.as_tensor(frames))
    assert got.shape == want.shape
    close(got, want, TOL)


def test_forward_and_loss_match():
    rm, rp, pm, pp = pair()
    cfg = pm.cfg
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (2, 12))
    labels = rng.integers(0, cfg.vocab, (2, 12))
    frames = _frames(cfg, 2, 2)
    rlog, _ = jax.jit(lambda p, t, f: RE.forward(p, rm.cfg, t, f))(
        rp, jnp.asarray(toks), jnp.asarray(frames))
    rloss, rmet = jax.jit(rm.loss)(rp, {
        "tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
        "frames": jnp.asarray(frames)})
    with torch.no_grad():
        plog, paux = pp(torch.as_tensor(toks), torch.as_tensor(frames))
        ploss, pmet = pm.loss(pp, {"tokens": torch.as_tensor(toks),
                                   "labels": torch.as_tensor(labels),
                                   "frames": torch.as_tensor(frames)})
    assert plog.shape == rlog.shape and float(paux) == 0.0
    close(plog, rlog, TOL)
    close(ploss, rloss, TOL)
    for key in ("nll", "z_loss"):
        close(pmet[key], rmet[key], TOL)


@pytest.mark.parametrize("S", [4, 11])
def test_prefill_and_teacher_forced_decode_match(monkeypatch, S):
    """Prefill (self-attention caches and the encoder's k/v compared
    leaf for leaf), then 8 teacher-forced decode steps; S = 4 is
    whisper's shortest prompt."""
    rm, rp, pm, pp = pair()
    prefill_and_decode(monkeypatch, rm, rp, pm, pp, S=S, steps=8, seed=S,
                        batch_extra={"frames": _frames(pm.cfg, 1, S)})


def test_bf16_prefill_and_decode_match(monkeypatch):
    """bfloat16 activations, as whisper-small serves: as for the other
    families (tests/test_torch_transformer.py), logits elementwise at
    5e-2 and the bf16 caches as whole tensors at 3e-2 relative norm."""
    rm, rp, pm, pp = make_pair(ARCH, dtype="bfloat16")

    def cache_close(got, want, tol):
        g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
        assert np.linalg.norm(g - w) <= 3e-2 * max(np.linalg.norm(w), 1.0)

    prefill_and_decode(monkeypatch, rm, rp, pm, pp, S=9, steps=2, tol=5e-2,
                        cache_close=cache_close, seed=3,
                        batch_extra={"frames": _frames(pm.cfg, 1, 3)})


def test_cross_attention_and_no_rope_layers_match():
    """The layers alone: full-sequence attention with ``xkv`` (RoPE on q
    only) and without RoPE, and cross-attention decode over a static
    memory, which leaves the self-attention cache untouched."""
    rm, rp, pm, pp = pair()
    cfg = pm.cfg
    ref_attn = jax.tree.map(lambda a: a[0], rp["dec_layers"]["cross_attn"])
    attn = pp.dec_layers[0].cross_attn
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    for rope in (True, False):
        ry, (rk, rv) = RL.attention_forward(
            ref_attn, rm.cfg, jnp.asarray(x), causal=False,
            xkv=jnp.asarray(mem), use_rope=rope)
        py, (pk, pv) = L.attention_forward(
            attn, cfg, torch.as_tensor(x), causal=False,
            xkv=torch.as_tensor(mem), use_rope=rope)
        for got, want in ((py, ry), (pk, rk), (pv, rv)):
            close(got, want, TOL)
    ry, _ = RL.attention_forward(ref_attn, rm.cfg, jnp.asarray(x),
                                 causal=True, use_rope=False)
    py, _ = L.attention_forward(attn, cfg, torch.as_tensor(x), causal=True,
                                use_rope=False)
    close(py, ry, TOL)
    # decode against the memory's k/v; the self-attention cache stays
    cache = L.init_kv_cache(cfg, 2, 8, torch.float32, torch.device("cpu"))
    before = [t.clone() for t in cache]
    ek = rng.standard_normal((2, 9, cfg.n_kv_heads, cfg.hd)).astype(
        np.float32)
    ev = rng.standard_normal(ek.shape).astype(np.float32)
    rc = RL.init_kv_cache(rm.cfg, 2, 8, jnp.float32)
    ry, _ = RL.attention_decode(ref_attn, rm.cfg, jnp.asarray(x[:, :1]), rc,
                                jnp.int32(3), enc_kv=(jnp.asarray(ek),
                                                      jnp.asarray(ev)),
                                use_rope=False)
    py, out = L.attention_decode(attn, cfg, torch.as_tensor(x[:, :1]), cache,
                                 3, enc_kv=(torch.as_tensor(ek),
                                            torch.as_tensor(ev)),
                                 use_rope=False)
    close(py, ry, TOL)
    assert out is cache
    assert all(torch.equal(a, b) for a, b in zip(before, cache))


def test_frames_change_the_answer():
    """admit(extras=) reaches the encoder: other frames, other logits."""
    _, _, pm, pp = pair()
    prompt = np.random.default_rng(5).integers(0, pm.cfg.vocab, 6)
    toks = torch.as_tensor(prompt[None])
    a, _ = pm.prefill(pp, {"tokens": toks, "frames": torch.as_tensor(
        _frames(pm.cfg, 1, 6))}, context=16)
    b, _ = pm.prefill(pp, {"tokens": toks, "frames": torch.as_tensor(
        _frames(pm.cfg, 1, 7))}, context=16)
    assert float((a - b).abs().max()) > 1e-3
    srv = serve.Server(pm, pp, slots=1, context=16)
    srv.admit(0, prompt, {"frames": _frames(pm.cfg, 1, 7)[0]})
    assert srv.outputs[0] == [int(b[0, -1].argmax())]


@pytest.mark.parametrize("arch", [ARCH, "xlstm-350m"])
def test_serving_records_no_gradient_under_remat_dots(arch):
    """The full configs' remat is "dots" (not ported: it raises where a
    gradient is wanted); serving wants none, so prefill and decode run
    without autograd even where the caller leaves it on."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import make_model
    cfg = get_smoke_config(arch).replace(remat="dots")
    model = make_model(cfg, device="cpu")
    params = model.init(0)
    params.requires_grad_(True)
    srv = serve.Server(model, params, slots=1, context=16)
    extras = ({"frames": _frames(cfg, 1, 9)[0]} if cfg.family == "encdec"
              else None)
    assert torch.is_grad_enabled()
    srv.admit(0, np.arange(5), extras)
    srv.step()
    assert len(srv.outputs[0]) == 2
    assert not any(t.requires_grad for t in cache_leaves(srv.caches))


def _serve_all(srv, requests, gen=6):
    pending = list(requests)
    done = []
    for _ in range(200):
        for s in range(srv.slots):
            if not srv.active[s] and pending:
                srv.admit(s, *pending.pop())
        if not srv.active.any():
            break
        srv.step()
        for s in range(srv.slots):
            if srv.active[s] and len(srv.outputs[s]) >= gen:
                done.append([int(t) for t in srv.outputs[s]])
                srv.active[s] = False
    return done


def test_continuous_batching_outputs_equal_reference():
    """5 requests of 4-9 tokens, each with its own frames, through 2
    slots at context 32: the same greedy tokens as the reference's
    Server."""
    rm, rp, pm, pp = pair()
    rng = np.random.default_rng(8)
    requests = [(rng.integers(0, pm.cfg.vocab, int(n)),
                 {"frames": _frames(pm.cfg, 1, 20 + i)[0]})
                for i, n in enumerate(rng.integers(4, 10, 5))]
    want = _serve_all(ref_serve.Server(rm, rp, slots=2, context=32),
                      requests)
    got = _serve_all(serve.Server(pm, pp, slots=2, context=32), requests)
    assert len(got) == 5 and all(len(d) >= 6 for d in got)
    assert got == want


def test_reference_cli_fails_without_frames():
    """The reference's command line builds frames (``extras()``) but
    admits each prompt without them, so whisper's prefill reads a batch
    with no "frames"."""
    with pytest.raises(KeyError, match="frames"):
        ref_serve.main(["--arch", ARCH, "--smoke", "--requests", "1",
                        "--batch-slots", "1", "--prompt-len", "4",
                        "--gen", "2", "--context", "16"])


def test_port_cli_refuses_encdec_and_names_the_route(monkeypatch):
    """The port's command line refuses before it builds any weights."""
    from repro_torch.models import model as M
    monkeypatch.setattr(M.Model, "init", lambda *a, **k: pytest.fail(
        "weights were built"))
    with pytest.raises(ValueError, match=r"admit\(.*extras=.*frames"):
        serve.main(["--arch", ARCH, "--smoke", "--requests", "1",
                    "--device", "cpu"])
