"""GPipe over a stage mesh: the port's ``pipeline_apply`` against the
reference's, and the slice as a whole.

The reference's toy (tests/test_pipeline_parallel.py: 8 stages, 16
microbatches of 4 rows, D = 32, 16 ``tanh(h @ w)`` layers) runs in a
subprocess with 8 fake host devices, the port on a mesh of the host
repeated 8 times, on the same seeded numpy inputs: they agree at the
reference's 2e-5, and the port's pipeline equals its own sequential loop
bit for bit.  Then the llama smoke config's trunk pipelined over 2 host
stages, with the final norm and the logits, against the JAX model's
logits at 1e-4 (weights carried across by ``convert``).
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as ref_tfm
from repro.parallel import pipeline as ref_pipeline
from repro_torch.launch.mesh import make_debug_mesh, make_mesh
from repro_torch.models import layers as L
from repro_torch.parallel import Mesh
from repro_torch.parallel.pipeline import pipeline_apply, split_stages

from .torch_lm_pairs import close, make_pair

ROOT = Path(__file__).resolve().parents[1]
S, M, MB, D, LAYERS = 8, 16, 4, 32, 16


def _toy_inputs():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((LAYERS, D, D)) / np.sqrt(D)).astype(np.float32)
    x = rng.standard_normal((M, MB, D)).astype(np.float32)
    return w, x


def _reference_pipeline(tmp_path) -> np.ndarray:
    w, x = _toy_inputs()
    np.savez(tmp_path / "in.npz", w=w, x=x)
    prog = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import jax, jax.numpy as jnp, numpy as np
        from repro.parallel.pipeline import pipeline_apply, split_stages

        d = np.load({str(tmp_path / "in.npz")!r})
        w, x = jnp.asarray(d["w"]), jnp.asarray(d["x"])

        def stage_fn(params_s, h):
            for i in range(params_s.shape[0]):
                h = jnp.tanh(h @ params_s[i])
            return h

        mesh = jax.make_mesh(({S},), ("stage",))
        run = pipeline_apply(stage_fn, mesh, n_microbatches={M})
        np.save({str(tmp_path / "out.npy")!r},
                np.asarray(run(split_stages(w, {S}), x)))
        print("PIPELINE_OK")
    """)
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, cwd=ROOT, timeout=600,
                       env={"PYTHONPATH": str(ROOT / "src"),
                            "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert "PIPELINE_OK" in r.stdout, (r.stdout[-2000:], r.stderr[-2000:])
    return np.load(tmp_path / "out.npy")


def _toy_stage(params_s, h):
    for i in range(params_s["w"].shape[0]):
        h = torch.tanh(h @ params_s["w"][i])
    return h


def test_pipeline_matches_reference_and_sequential_8_stages(tmp_path):
    want = _reference_pipeline(tmp_path)
    w, x = _toy_inputs()
    mesh = make_debug_mesh(S, axes=("stage",), device="cpu")
    run = pipeline_apply(_toy_stage, mesh, n_microbatches=M)
    got = run(split_stages({"w": torch.from_numpy(w)}, S),
              torch.from_numpy(x))
    assert got.shape == (M, MB, D) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    seq = torch.from_numpy(x)
    for i in range(LAYERS):
        seq = torch.tanh(seq @ torch.from_numpy(w)[i])
    assert torch.equal(got, seq)
    # the reference's own sequential answer, at its tolerance
    ref = jnp.asarray(x)
    for i in range(LAYERS):
        ref = jnp.tanh(ref @ jnp.asarray(w)[i])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_schedule_is_gpipe():
    """Tick t runs microbatch t - s on stage s, over M + S - 1 ticks; each
    stage sees the microbatches in order, each microbatch the stages in
    order."""
    calls = []

    def stage_fn(s, h):
        calls.append((s, int(h[0, 0])))
        return h

    mesh = make_debug_mesh(3, axes=("stage",), device="cpu")
    x = torch.arange(5.0)[:, None, None].expand(5, 1, 2).clone()
    y = pipeline_apply(stage_fn, mesh, n_microbatches=5)([0, 1, 2], x)
    assert torch.equal(y, x)
    ticks = [(s, m) for t in range(5 + 3 - 1) for s in range(3)
             for m in [t - s] if 0 <= m < 5]
    assert calls == ticks


def test_split_stages_shapes_and_refusals():
    w = {"a": torch.zeros(8, 3), "b": torch.zeros(8, 2, 2)}
    s = split_stages(w, 4)
    assert len(s) == 4 and s[1]["a"].shape == (2, 3)
    assert s[3]["b"].shape == (2, 2, 2)
    ref = jax.tree.map(np.shape, ref_pipeline.split_stages(
        {"a": jnp.zeros((8, 3)), "b": jnp.zeros((8, 2, 2))}, 4))
    assert ref == {"a": (4, 2, 3), "b": (4, 2, 2, 2)}
    with pytest.raises(ValueError, match="multiple of 3"):
        split_stages(w, 3)
    mesh = make_debug_mesh(2, axes=("stage",), device="cpu")
    run = pipeline_apply(_toy_stage, mesh, n_microbatches=4)
    with pytest.raises(ValueError, match="3 stage parameter sets"):
        run([{}, {}, {}], torch.zeros(4, 1, 1))
    with pytest.raises(ValueError, match="microbatches"):
        run([{}, {}], torch.zeros(3, 1, 1))
    with pytest.raises(ValueError, match="1-d mesh"):
        pipeline_apply(_toy_stage, make_debug_mesh(2, device="cpu"),
                       n_microbatches=2)


def test_pipeline_on_cuda_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh((4,), ("stage",))
    cards = Mesh(["cuda:0"] * 4, ("stage",))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline_apply(_toy_stage, cards, n_microbatches=4)


def test_llama_trunk_pipelined_matches_reference_logits():
    """The smoke llama (4 layers) split into 2 host stages of 2 decoder
    layers, 4 microbatches of one 32-token row, then the final norm and
    the logits, against the reference's forward at 1e-4."""
    rm, rp, pm, pp = make_pair("llama3.2-1b", n_layers=4)
    cfg = pm.cfg
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32)
    want, _ = jax.jit(lambda p, t: ref_tfm.forward(p, rm.cfg, t))(
        rp, jnp.asarray(tokens))

    tok = torch.from_numpy(tokens)
    positions = torch.arange(32, dtype=torch.int32)[None]

    def stage_fn(layers, h):
        for layer in layers:
            h = layer(h, positions)[0]
        return h

    mesh = make_debug_mesh(2, axes=("stage",), device="cpu")
    stages = [list(pp.layers[:2]), list(pp.layers[2:])]
    with torch.no_grad():
        x = L.embed_tokens(pp.embed, cfg, tok)[:, None]       # (M, 1, S, D)
        y = pipeline_apply(stage_fn, mesh, n_microbatches=4)(stages, x)
        logits = L.logits_from_hidden(pp.embed, cfg, pp.ln_f(y[:, 0]))
        whole, _ = pp(tok)
    close(logits.numpy(), np.asarray(want), 1e-4)
    assert torch.equal(logits, whole)
