"""The port's decoder-only transformer families (dense, moe, vlm) against
the reference, on the CPU.

Each of the seven smoke configs (llama3.2-1b, granite-moe-1b-a400m,
qwen2-vl-7b, olmo-1b, smollm-360m, starcoder2-15b, mixtral-8x22b;
float32) is built in both packages with the same perturbed weights
(``tests/torch_lm_pairs.py``).  Prefill logits and caches, teacher-forced
decode logits (both sides fed the reference's greedy tokens), ``forward``
logits and aux, and ``Model.loss`` agree at rtol = atol = 1e-4 (TOL):
float32 sums over the same contractions in another order.  For the MoE
configs the experts every token chose are compared first, call by call.
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
from repro.models import transformer as RT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import layers as L, make_model  # noqa: E402
from repro_torch.models.transformer import remat_wrap  # noqa: E402

from .torch_lm_pairs import (CONTEXT, TOL,  # noqa: E402
                             TRANSFORMER_ARCHS, check_routing, close,
                             make_pair, prefill_and_decode,
                             record_moe_inputs)

_PAIRS = {}


def pair(arch):
    """The module's one smoke pair per config, built on first use."""
    if arch not in _PAIRS:
        _PAIRS[arch] = make_pair(arch)
    return _PAIRS[arch]


@pytest.mark.parametrize("arch", TRANSFORMER_ARCHS)
def test_configs_match_reference(arch):
    for mine, ref in ((get_config(arch), ref_get_config(arch)),
                      (get_smoke_config(arch), ref_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


@pytest.mark.parametrize("arch", TRANSFORMER_ARCHS)
def test_init_shapes_match_reference(arch):
    rm, rp, pm, _ = pair(arch)
    want = convert.model_params_from_jax(pm.cfg, jax.tree.map(np.asarray, rp))
    got = pm.init(7).state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    cfg = pm.cfg
    assert ("embed.head" in got) == (not cfg.tie_embeddings)
    assert ("layers.0.attn.bq" in got) == cfg.qkv_bias
    assert ("layers.0.mlp.wg" in got) == (cfg.act == "swiglu")
    assert ("layers.0.mlp.router" in got) == (cfg.family == "moe")
    assert ("ln_f.scale" in got) == (cfg.norm != "nonparam_ln")
    # the carry-across round trip is exact
    back = convert.model_params_to_jax(cfg, got)
    again = convert.model_params_from_jax(cfg, back)
    assert all(torch.equal(again[k], got[k].float()) for k in got)


@pytest.mark.parametrize("arch", TRANSFORMER_ARCHS)
def test_prefill_and_teacher_forced_decode_match(monkeypatch, arch):
    prefill_and_decode(monkeypatch, *pair(arch), S=20, steps=4)


@pytest.mark.parametrize("arch", ["starcoder2-15b", "mixtral-8x22b"])
def test_sliding_window_ring_cache_matches(monkeypatch, arch):
    """A 13-token prompt past the smoke window of 8, then 12 decode steps:
    the ring cache keeps the last 8 positions and decode overwrites it
    all the way round."""
    rm, rp, pm, pp = pair(arch)
    assert pm.cfg.window == 8
    prefill_and_decode(monkeypatch, rm, rp, pm, pp, S=13, steps=12, seed=1)


@pytest.mark.parametrize("arch", TRANSFORMER_ARCHS)
def test_forward_and_loss_match(monkeypatch, arch):
    rm, rp, pm, pp = pair(arch)
    cfg = pm.cfg
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (2, 24))
    labels = rng.integers(0, cfg.vocab, (2, 24))
    with record_moe_inputs(monkeypatch) as logs:
        rlog, raux = jax.jit(lambda p, t: RT.forward(p, rm.cfg, t))(
            rp, jnp.asarray(toks))
        rloss, rmet = jax.jit(lambda p, b: rm.loss(p, b))(
            rp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
        jax.effects_barrier()
        with torch.no_grad():
            plog, paux = pp(torch.as_tensor(toks))
            ploss, pmet = pm.loss(pp, {"tokens": torch.as_tensor(toks),
                                       "labels": torch.as_tensor(labels)})
    assert check_routing(*logs, rp, pp, cfg, f"{arch} forward") == \
        (2 * cfg.n_layers if cfg.family == "moe" else 0)
    assert plog.shape == rlog.shape
    close(plog, rlog, TOL)
    close(paux, raux, TOL)
    if cfg.family == "moe":
        assert float(paux) > 0.0
    close(ploss, rloss, TOL)
    for key in ("nll", "z_loss", "aux"):
        close(pmet[key], rmet[key], TOL)


def _mrope_inputs(cfg, B, S, seed):
    """Tokens, distinct (t, h, w) positions, patch embeds."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S))
    pos = rng.integers(0, 3 * S, (B, S, 3)).astype(np.int32)
    assert (pos[..., 0] != pos[..., 1]).any()
    patches = rng.standard_normal((B, cfg.n_patches, cfg.d_model)
                                  ).astype(np.float32)
    return toks, pos, patches


def test_mrope_positions_and_patch_embeds_match():
    """qwen2-vl: M-RoPE with distinct (t, h, w) components and the stub
    frontend's patch embeds, through forward, Model.loss and prefill."""
    rm, rp, pm, pp = pair("qwen2-vl-7b")
    cfg = pm.cfg
    assert cfg.mrope and cfg.mrope_sections == (4, 2, 2)
    toks, pos, patches = _mrope_inputs(cfg, 2, 16, 3)
    labels = np.roll(toks, -1, 1)
    rloss, (rlog, _) = jax.jit(lambda p, b: (
        rm.loss(p, b)[0], RT.forward(p, rm.cfg, b["tokens"],
                                     positions=b["positions"],
                                     patch_embeds=b["patch_embeds"])))(
        rp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
             "positions": jnp.asarray(pos),
             "patch_embeds": jnp.asarray(patches)})
    with torch.no_grad():
        plog, _ = pp(torch.as_tensor(toks), positions=torch.as_tensor(pos),
                     patch_embeds=torch.as_tensor(patches))
        ploss, _ = pm.loss(pp, {"tokens": torch.as_tensor(toks),
                                "labels": torch.as_tensor(labels),
                                "positions": torch.as_tensor(pos),
                                "patch_embeds": torch.as_tensor(patches)})
    close(plog, rlog, TOL)
    close(ploss, rloss, TOL)
    # the positions matter: 1-D positions give other logits
    with torch.no_grad():
        plain, _ = pp(torch.as_tensor(toks),
                      patch_embeds=torch.as_tensor(patches))
    assert float((plain - plog).abs().max()) > 1e-2
    # prefill with explicit positions, then with the default ones
    rl, _ = jax.jit(lambda p, t, pos, pe: RT.prefill(
        p, rm.cfg, t, context=CONTEXT, positions=pos, patch_embeds=pe))(
        rp, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(patches))
    pl, _ = pp.prefill(torch.as_tensor(toks), context=CONTEXT,
                       positions=torch.as_tensor(pos),
                       patch_embeds=torch.as_tensor(patches))
    close(pl, rl, TOL)


def test_vlm_prefill_with_patch_embeds_and_decode_match(monkeypatch):
    rm, rp, pm, pp = pair("qwen2-vl-7b")
    patches = np.random.default_rng(4).standard_normal(
        (1, pm.cfg.n_patches, pm.cfg.d_model)).astype(np.float32)
    prefill_and_decode(monkeypatch, rm, rp, pm, pp, S=12, steps=3, seed=4,
                        batch_extra={"patch_embeds": patches})


def test_mrope_cos_sin_match_reference_sections():
    """cos/sin at 1e-5: float32 cos and sin of angles up to 100 radians
    differ by a few ulps between XLA's and PyTorch's argument
    reduction."""
    from repro.models import layers as RL
    rng = np.random.default_rng(5)
    pos = rng.integers(0, 100, (2, 7, 3)).astype(np.int32)
    for sections in ((4, 2, 2), (16, 24, 24)):
        hd = 2 * sum(sections)
        rc, rs = RL.rope_cos_sin(jnp.asarray(pos), hd, 1e6, sections)
        pc, ps = L.rope_cos_sin(torch.as_tensor(pos), hd, 1e6, sections)
        close(pc, rc, 1e-5)
        close(ps, rs, 1e-5)
        # identical components are 1-D RoPE exactly
        same = np.repeat(pos[..., :1], 3, -1)
        c3, s3 = L.rope_cos_sin(torch.as_tensor(same), hd, 1e6, sections)
        c1, s1 = L.rope_cos_sin(torch.as_tensor(pos[..., 0]), hd, 1e6)
        assert torch.equal(c3, c1) and torch.equal(s3, s1)
    with pytest.raises(ValueError, match="mrope sections"):
        L.rope_cos_sin(torch.as_tensor(pos), 20, 1e6, (4, 2, 2))


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu defaults to the tanh approximation; PyTorch's default
    is the exact erf form, about 5e-4 away near |x| = 2."""
    x = np.linspace(-6, 6, 2001).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = L.gelu(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    erf = torch.nn.functional.gelu(torch.as_tensor(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4


def test_bf16_prefill_and_decode_match(monkeypatch):
    """bfloat16 activations, llama smoke.  As in tests/test_torch_models.py
    (zamba2): the two frameworks round to bf16 at other places, so the
    float32 logits agree elementwise at 5e-2, a few bf16 ulps of logits
    of size one, and the bf16 cache entries as whole tensors at 3e-2
    relative norm (four bf16 epsilons)."""
    rm, rp, pm, pp = make_pair("llama3.2-1b", dtype="bfloat16")

    def cache_close(got, want, tol):
        g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
        assert np.linalg.norm(g - w) <= 3e-2 * max(np.linalg.norm(w), 1.0)

    prefill_and_decode(monkeypatch, rm, rp, pm, pp, S=30, steps=2, tol=5e-2,
                        cache_close=cache_close, seed=6)


def test_remat_wrap_policies():
    cfg = get_smoke_config("llama3.2-1b")

    def fn(x):
        return x * 2

    for remat in ("none", "full", "dots"):
        with torch.no_grad():
            assert remat_wrap(fn, cfg.replace(remat=remat)) is fn
    assert remat_wrap(fn, cfg.replace(remat="none")) is fn
    with pytest.raises(ValueError, match="unknown remat"):
        remat_wrap(fn, cfg.replace(remat="some"))
    for remat in ("full", "dots"):
        x = torch.ones(3, requires_grad=True)
        y = remat_wrap(fn, cfg.replace(remat=remat))(x)
        y.sum().backward()
        assert torch.equal(x.grad, torch.full((3,), 2.0))


def test_full_remat_forward_keeps_gradients():
    """remat "full" under autograd: the same loss and gradients as "none"
    (llama smoke, the same weights in both)."""
    cfg = get_smoke_config("llama3.2-1b")
    state = make_model(cfg, device="cpu").init(3).state_dict()
    rng = np.random.default_rng(7)
    batch = {"tokens": torch.as_tensor(rng.integers(0, 512, (2, 12))),
             "labels": torch.as_tensor(rng.integers(0, 512, (2, 12)))}
    out = {}
    for remat in ("none", "full"):
        model = make_model(cfg.replace(remat=remat), device="cpu")
        params = model.init(0)
        params.load_state_dict(state)
        params.requires_grad_(True)
        loss, _ = model.loss(params, batch)
        out[remat] = (loss.detach(),
                      torch.autograd.grad(loss, list(params.parameters())))
    assert torch.allclose(out["none"][0], out["full"][0], rtol=1e-6)
    for a, b in zip(out["none"][1], out["full"][1]):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-1b-a400m",
                                  "whisper-small", "xlstm-350m", "olmo-1b",
                                  "smollm-360m", "qwen2-vl-7b",
                                  "starcoder2-15b", "mixtral-8x22b"])
def test_training_cli_runs(arch, tmp_path):
    """The trainer on the CPU, 2 steps of each family's smoke config with
    the batch's extras (patch embeds and positions, frames): the loss
    falls from step to step, and the first batch scores lower after the
    two steps than before them."""
    from repro_torch.data import make_stream
    from repro_torch.launch import train
    hist, state = train.main(
        ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
         "--batch", "4", "--seq", "32", "--lr", "3e-3", "--ckpt-dir",
         str(tmp_path), "--ckpt-every", "0", "--log-every", "100"],
        return_state=True)
    assert [h["step"] for h in hist] == [1, 2]
    assert all(np.isfinite(h[k]) for h in hist
               for k in ("loss", "nll", "grad_norm"))
    assert hist[1]["loss"] < hist[0]["loss"]
    cfg = get_smoke_config(arch)
    first = {k: torch.as_tensor(v) for k, v in
             make_stream(cfg, 32, 4, seed=0).batch_at(0).items()}
    with torch.no_grad():
        after, _ = make_model(cfg, device="cpu").loss(state.params, first)
    assert float(after) < hist[0]["loss"]
