"""The float32 rounding bounds of scripts/stress_lm_kernels.py, on the
CPU: the plain versions, computed in float32, lie inside them, and a
result with one stale or missing term lies outside."""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro_torch.kernels.flash_attention.ops import attention  # noqa: E402
from repro_torch.kernels.mamba2_scan.ops import ssd_intra_chunk  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "stress_lm_kernels",
    Path(__file__).resolve().parents[1] / "scripts" / "stress_lm_kernels.py")
stress = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(stress)


def _ssd_args(seed, G=3, L=64, H=4, P=16, N=16):
    gen = torch.Generator().manual_seed(seed)
    return stress.ssd_inputs(gen, torch.device("cpu"), G, L, H, P, N)


@pytest.mark.parametrize("seed", [0, 1])
def test_ssd_bound_holds_for_plain_and_catches_a_stale_score(seed):
    x, dt, cum, Bm, Cm = _ssd_args(seed)
    want, err = stress.ssd_error_bound(x, dt, cum, Bm, Cm)
    y = ssd_intra_chunk(x, dt, cum, Bm, Cm)
    assert not stress.over_bound(y, want, err, torch.float32).any()
    assert stress.ratio(y, want, err) < 1
    # one score of row 40 from another head's dt: what a shared-memory
    # race between heads would leave behind, two steps off the diagonal
    i, j, h = 40, 38, 1
    stale = y.clone()
    cb = float(Cm[0, i] @ Bm[0, j])
    decay = float(torch.exp(cum[0, i, h] - cum[0, j, h]))
    stale[0, i, h] += cb * decay * (dt[0, j, 0] - dt[0, j, h]) * x[0, j, h]
    assert stress.over_bound(stale, want, err, torch.float32)[0, i, h].any()


@pytest.mark.parametrize("dtype,causal,window", [
    (torch.float32, True, None), (torch.float32, False, None),
    (torch.float32, True, 50), (torch.bfloat16, True, None)])
def test_flash_bound_holds_for_plain_and_catches_a_dropped_tile(
        dtype, causal, window):
    gen = torch.Generator().manual_seed(3)
    B, S, H, KV, hd = 1, 300, 4, 2, 40
    q, k, v = (torch.randn(B, S, h, hd, generator=gen).to(dtype)
               for h in (H, KV, KV))
    want, err = stress.flash_error_bound(q, k, v, causal, window)
    o = attention(q, k, v, causal=causal, window=window)
    assert not stress.over_bound(o, want, err, dtype).any()
    # the same attention with the keys of one 64-key tile left out
    qi, kj = torch.arange(S)[:, None], torch.arange(S)[None, :]
    allowed = (kj < 128) | (kj >= 192)
    if causal:
        allowed = allowed & (kj <= qi)
    if window is not None:
        allowed = allowed & (qi - kj < window)
    qh = q.double().transpose(1, 2)
    kh, vh = (t.double().transpose(1, 2).repeat_interleave(H // KV, dim=1)
              for t in (k, v))
    s = (qh @ kh.transpose(-1, -2) / hd ** 0.5).masked_fill(~allowed,
                                                            float("-inf"))
    dropped = (torch.softmax(s, -1) @ vh).transpose(1, 2).to(dtype)
    rows = slice(200, 240) if window is None else slice(170, 190)
    assert stress.over_bound(dropped, want, err, dtype)[:, rows].any()
