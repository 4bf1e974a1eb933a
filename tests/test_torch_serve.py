"""The port's continuous-batching Server against the reference's.

Both serve the smoke ``zamba2-2.7b`` (float32) with the same weights
(carried across by ``repro_torch.convert``), greedy, and must emit the
same tokens, in the setups of tests/test_serving.py:
5 requests through 2 slots at context 32, and a request whose slot
neighbour is admitted midway.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.launch.serve import Server as RefServer  # noqa: E402
from repro.models import make_model as ref_make  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import make_model  # noqa: E402

ARCH = "zamba2-2.7b"


@pytest.fixture(scope="module")
def models():
    rm = ref_make(ref_smoke(ARCH))
    rp, _ = rm.init(jax.random.key(0))
    cfg = get_smoke_config(ARCH)
    pm = make_model(cfg, device="cpu")
    pp = convert.model_params_from_jax(cfg, jax.tree.map(np.asarray, rp),
                                       into=pm.init(0))
    return (rm, rp), (pm, pp)


def _serve_all(srv, prompts, gen=6):
    pending = list(prompts)
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


def test_continuous_batching_outputs_equal_reference(models):
    (rm, rp), (pm, pp) = models
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, pm.cfg.vocab, 8) for _ in range(5)]
    want = _serve_all(RefServer(rm, rp, slots=2, context=32), prompts)
    got = _serve_all(serve.Server(pm, pp, slots=2, context=32), prompts)
    assert len(got) == 5 and all(len(d) >= 6 for d in got)
    assert got == want


def _splice_run(server_cls, model, params, rng):
    prompt = rng.integers(0, 512, 8)
    a = server_cls(model, params, slots=1, context=32)
    a.admit(0, prompt)
    for _ in range(4):
        a.step()
    b = server_cls(model, params, slots=2, context=32)
    b.admit(0, prompt)
    b.step()
    b.step()
    b.admit(1, rng.integers(0, 512, 8))
    b.step()
    b.step()
    return ([int(t) for t in a.outputs[0]],
            [[int(t) for t in o] for o in b.outputs])


def test_slot_splice_outputs_equal_reference(models):
    (rm, rp), (pm, pp) = models
    solo_ref, shared_ref = _splice_run(RefServer, rm, rp,
                                       np.random.default_rng(1))
    solo, shared = _splice_run(serve.Server, pm, pp,
                               np.random.default_rng(1))
    assert solo[:5] == shared[0][:5]     # the neighbour does not disturb
    assert (solo, shared) == (solo_ref, shared_ref)


def test_step_is_a_noop_when_idle_and_main_serves(models, capsys):
    _, (pm, pp) = models
    srv = serve.Server(pm, pp, slots=2, context=32)
    srv.step()
    assert (srv.lengths == 0).all()
    done = serve.main(["--arch", ARCH, "--smoke", "--requests", "3",
                       "--batch-slots", "2", "--prompt-len", "5", "--gen",
                       "3", "--context", "16", "--device", "cpu",
                       "--temperature", "0.7"])
    assert len(done) == 3 and all(len(d) >= 3 for d in done)
    assert "[serve] 3 requests" in capsys.readouterr().out
