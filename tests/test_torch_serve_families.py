"""The port's continuous-batching Server against the reference's, for the
transformer families: llama3.2-1b (dense), granite-moe-1b-a400m (moe) and
qwen2-vl-7b (vlm, with seeded patch embeds through ``admit(extras=)``).

Both serve the smoke config (float32) with the same perturbed weights
(``tests/torch_lm_pairs.py``), greedy, and must emit the same tokens in
the setups of tests/test_torch_serve.py: 5 requests through 2 slots at
context 32, and a request whose slot neighbour is admitted midway.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.launch.serve import Server as RefServer  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

from .torch_lm_pairs import make_pair  # noqa: E402

ARCHS = ["llama3.2-1b", "granite-moe-1b-a400m", "qwen2-vl-7b"]
_PAIRS = {}


def pair(arch):
    if arch not in _PAIRS:
        _PAIRS[arch] = make_pair(arch)
    return _PAIRS[arch]


def _extras(cfg, rng):
    """The vlm family's patch embeds for one request, else nothing."""
    if cfg.family != "vlm":
        return None
    return {"patch_embeds": rng.standard_normal(
        (cfg.n_patches, cfg.d_model)).astype(np.float32)}


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


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_batching_outputs_equal_reference(arch):
    rm, rp, pm, pp = pair(arch)
    rng = np.random.default_rng(0)
    requests = [(rng.integers(0, pm.cfg.vocab, 8), _extras(pm.cfg, rng))
                for _ in range(5)]
    want = _serve_all(RefServer(rm, rp, slots=2, context=32), requests)
    got = _serve_all(serve.Server(pm, pp, slots=2, context=32), requests)
    assert len(got) == 5 and all(len(d) >= 6 for d in got)
    assert got == want


def _splice_run(server_cls, model, params, cfg, rng):
    prompt, extra = rng.integers(0, cfg.vocab, 8), _extras(cfg, rng)
    a = server_cls(model, params, slots=1, context=32)
    a.admit(0, prompt, extra)
    for _ in range(4):
        a.step()
    b = server_cls(model, params, slots=2, context=32)
    b.admit(0, prompt, extra)
    b.step()
    b.step()
    b.admit(1, rng.integers(0, cfg.vocab, 8), _extras(cfg, rng))
    b.step()
    b.step()
    return ([int(t) for t in a.outputs[0]],
            [[int(t) for t in o] for o in b.outputs])


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_splice_outputs_equal_reference(arch):
    rm, rp, pm, pp = pair(arch)
    solo_ref, shared_ref = _splice_run(RefServer, rm, rp, pm.cfg,
                                       np.random.default_rng(1))
    solo, shared = _splice_run(serve.Server, pm, pp, pm.cfg,
                               np.random.default_rng(1))
    assert solo[:5] == shared[0][:5]     # the neighbour does not disturb
    assert (solo, shared) == (solo_ref, shared_ref)


def test_patch_embeds_change_the_vlm_answer():
    """admit(extras=) reaches the model: other patch embeds, other first
    token logits (same prompt)."""
    _, _, pm, pp = pair("qwen2-vl-7b")
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, pm.cfg.vocab, 8)
    batch = {"tokens": torch.as_tensor(prompt[None])}
    plain, _ = pm.prefill(pp, batch, context=32)
    srv = serve.Server(pm, pp, slots=1, context=32)
    extra = _extras(pm.cfg, rng)
    srv.admit(0, prompt, extra)
    with_patches, _ = pm.prefill(
        pp, dict(batch, patch_embeds=torch.as_tensor(
            extra["patch_embeds"][None])), context=32)
    assert float((plain - with_patches).abs().max()) > 1e-3
    assert srv.outputs[0] == [int(with_patches[0, -1].argmax())]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x22b"])
def test_main_serves_the_family_on_the_cpu(arch, capsys):
    done = serve.main(["--arch", arch, "--smoke", "--requests", "3",
                       "--batch-slots", "2", "--prompt-len", "12", "--gen",
                       "3", "--context", "16", "--device", "cpu"])
    assert len(done) == 3 and all(len(d) >= 3 for d in done)
    assert "[serve] 3 requests" in capsys.readouterr().out
