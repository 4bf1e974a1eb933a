"""The port's HTTP transport against the reference's wire and clients.

The wire codecs must encode the port's programs, configs and images as
the reference's do, so the reference's ``SweepClient`` talks to the
port's ``SweepTransport`` unchanged.  A campaign driven through either
client over a clean or faulty transport (dropped submit responses,
mid-stream disconnects, duplicate delivery, a SIGTERM drain and restart)
folds to the port's monolithic ``dse.sweep`` bit for bit and to the
reference's sweep within its contract (integers bit for bit, energy and
power at rtol 1e-5).

The port's transport repairs the reference's lock hold: a status GET
never waits for a step (the reference's worker held one lock through
every step, so its status GET could wait out a whole campaign).
"""
import dataclasses
import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.analysis import pareto as ref_pareto  # noqa: E402
from repro.apps import mibench as ref_mibench  # noqa: E402
from repro.core import dse as ref_dse, hwconfig as ref_hw  # noqa: E402
from repro.service import SweepClient as RefClient  # noqa: E402
from repro.service import transport as ref_transport  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.analysis import pareto  # noqa: E402
from repro_torch.apps import mibench  # noqa: E402
from repro_torch.core import dse, hwconfig  # noqa: E402
from repro_torch.core.hwconfig import HwConfig  # noqa: E402
from repro_torch.runtime.faults import (FAULT_PLAN_ENV,  # noqa: E402
                                        FaultPlan, NetFaultInjector)
from repro_torch.service import (ClientRetry, SweepClient,  # noqa: E402
                                 SweepService, SweepTransport)
from repro_torch.service.runner import (RESULT_FIELDS,  # noqa: E402
                                        _RESULT_DTYPES)
from repro_torch.service.transport import (hw_from_wire,  # noqa: E402
                                           hw_to_wire, program_from_wire,
                                           program_to_wire, sweep_to_wire)

ROOT = Path(__file__).resolve().parents[1]
MAX_STEPS = 256
TOPOS = ("baseline", "c_interleaved")
DISCRETE = ("latency_cc", "checksum", "steps_executed")


@pytest.fixture(scope="module", autouse=True)
def _autotune_cache(tmp_path_factory):
    """AUTO knobs resolve from an empty cache of this module's own."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                  str(tmp_path_factory.mktemp("autotune") / "cache.json"))
        yield


def _kernels(mod):
    return [mod.bitcnt(n_words=16), mod.crc32(n_words=3)]


@pytest.fixture(scope="module")
def grid(profile):
    rk, pk = _kernels(ref_mibench), _kernels(mibench)
    mems = np.stack([k.mem_init for k in rk])
    return dict(
        programs=[k.program for k in pk],
        profile=convert.profile_from_numpy(dataclasses.asdict(profile)),
        hw_configs=[hwconfig.TOPOLOGIES[t]() for t in TOPOS],
        mem_images=mems, max_steps=MAX_STEPS,
        ref_programs=[k.program for k in rk],
        ref_hw=[ref_hw.TOPOLOGIES[t]() for t in TOPOS], ref_profile=profile)


@pytest.fixture(scope="module")
def mono(grid):
    """The port's uninterrupted single-call sweep (B = 8), host numpy."""
    res = dse.sweep(programs=grid["programs"], profile=grid["profile"],
                    hw_configs=grid["hw_configs"],
                    mem_images=grid["mem_images"], max_steps=MAX_STEPS,
                    device="cpu")
    return {f: getattr(res, f).numpy() for f in RESULT_FIELDS}


@pytest.fixture(scope="module")
def ref_mono(grid):
    res = ref_dse.sweep(programs=grid["ref_programs"],
                        profile=grid["ref_profile"],
                        hw_configs=grid["ref_hw"],
                        mem_images=grid["mem_images"], max_steps=MAX_STEPS,
                        backend="xla", chunk_steps=64, blk_b=32,
                        max_buckets=1)
    return {f: np.asarray(getattr(res, f)) for f in RESULT_FIELDS}


def _service(grid, **kw):
    kw.setdefault("unit_size", 2)
    return SweepService(grid["profile"], max_steps=MAX_STEPS,
                        mem_size=int(grid["mem_images"].shape[1]),
                        device="cpu", **kw)


def _start(grid, injector=None, **kw):
    t = SweepTransport(_service(grid, **kw), injector=injector)
    t.start()
    return t


def _body(grid, key, **kw):
    return {"v": 1, "idempotency_key": key,
            "sweep": sweep_to_wire(grid["programs"], grid["hw_configs"],
                                   grid["mem_images"], **kw)}


def _assert_exact(want, arrays):
    for f in RESULT_FIELDS:
        assert arrays[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(arrays[f], want[f], err_msg=f)


def _assert_matches_ref(ref, arrays):
    for f in DISCRETE:
        np.testing.assert_array_equal(arrays[f], ref[f], err_msg=f)
    for f in ("energy_pj", "power_mw"):
        np.testing.assert_allclose(arrays[f], ref[f], rtol=1e-5, err_msg=f)


# ---------------------------------------------------------------------------
# Wire codecs: the reference's bytes
# ---------------------------------------------------------------------------

def test_wire_codecs_match_the_reference(grid):
    """The port encodes a submission exactly as the reference does, and
    every codec round-trips bit for bit through JSON text."""
    port = sweep_to_wire(grid["programs"], grid["hw_configs"],
                         grid["mem_images"], deadline_s=2.5,
                         reduce=pareto.TopK("edp", k=3))
    ref = ref_transport.sweep_to_wire(
        grid["ref_programs"], grid["ref_hw"], grid["mem_images"],
        deadline_s=2.5, reduce=ref_pareto.TopK("edp", k=3))
    assert json.dumps(port, sort_keys=True) == json.dumps(ref,
                                                          sort_keys=True)

    p = grid["programs"][1]
    q = program_from_wire(json.loads(json.dumps(program_to_wire(p))))
    assert q.name == p.name
    for f in ("ops", "dest", "srcA", "srcB", "imm"):
        np.testing.assert_array_equal(getattr(q, f), getattr(p, f))
    c = grid["hw_configs"][1]
    c2 = hw_from_wire(json.loads(json.dumps(hw_to_wire(c))))
    for f in HwConfig.FIELDS:
        assert getattr(c2, f).item() == getattr(c, f).item()
        assert getattr(c2, f).dtype == getattr(c, f).dtype
    kw = ref_transport.sweep_from_wire(json.loads(json.dumps(port)))
    assert [x.name for x in kw["programs"]] == [x.name for x in
                                                 grid["programs"]]


# ---------------------------------------------------------------------------
# Clean transport == monolithic, through both packages' clients
# ---------------------------------------------------------------------------

def test_transport_matches_monolithic(grid, mono, ref_mono):
    t = _start(grid)
    try:
        client = SweepClient(t.host, t.port, seed=1)
        assert client.healthz() and client.readyz()
        res = client.sweep(grid["programs"], grid["hw_configs"],
                           grid["mem_images"])
        assert not res.expired and res.skipped_lanes == 0
        assert res.stats.records_folded == 4          # 8 lanes / unit 2
        _assert_exact(mono, res.arrays)
        _assert_matches_ref(ref_mono, res.arrays)
    finally:
        t.close()


def test_reference_client_reads_the_port(grid, mono):
    """The reference's SweepClient, unchanged, drives the port's
    transport: unreduced and reduced campaigns fold to the port's
    answers bit for bit."""
    t = _start(grid)
    try:
        client = RefClient(t.host, t.port, seed=2)
        assert client.readyz()
        res = client.sweep(grid["ref_programs"], grid["ref_hw"],
                           grid["mem_images"])
        _assert_exact(mono, res.arrays)
        red = client.sweep(grid["ref_programs"], grid["ref_hw"],
                           grid["mem_images"],
                           reduce=ref_pareto.TopK("edp", k=3)).reduced()
        want = dse.sweep(programs=grid["programs"], profile=grid["profile"],
                         hw_configs=grid["hw_configs"],
                         mem_images=grid["mem_images"], max_steps=MAX_STEPS,
                         device="cpu", reduce=pareto.TopK("edp", k=3))
        for f in pareto.REDUCED_FIELDS:
            assert np.asarray(getattr(red, f)).tobytes() \
                == getattr(want, f).tobytes(), f
    finally:
        t.close()


def test_transport_reduced_matches_monolithic(grid):
    spec = pareto.TopK(objective="edp", k=4)
    solo = dse.sweep(programs=grid["programs"], profile=grid["profile"],
                     hw_configs=grid["hw_configs"],
                     mem_images=grid["mem_images"], max_steps=MAX_STEPS,
                     device="cpu", reduce=spec)
    t = _start(grid)
    try:
        res = SweepClient(t.host, t.port, seed=1).sweep(
            grid["programs"], grid["hw_configs"], grid["mem_images"],
            reduce=spec)
        red = res.reduced()
        for f in pareto.REDUCED_FIELDS:
            assert np.asarray(getattr(red, f)).tobytes() \
                == getattr(solo, f).tobytes(), f
    finally:
        t.close()


# ---------------------------------------------------------------------------
# Idempotent submission, error mapping, the lock repair, drain
# ---------------------------------------------------------------------------

def test_idempotent_submission_replays_campaign(grid):
    t = _start(grid)
    try:
        client = SweepClient(t.host, t.port)
        body = _body(grid, "k-replay")
        s1, o1 = client._request("POST", "/v1/sweeps", body)
        s2, o2 = client._request("POST", "/v1/sweeps", body)
        assert (s1, o1["created"]) == (201, True)
        assert (s2, o2["created"]) == (200, False)
        assert o1["campaign"] == o2["campaign"]
        # refused by the service on the worker thread: still a 400
        bad = _body(grid, "k-narrow")
        bad["sweep"]["mem_images"] = pareto.array_to_wire(
            grid["mem_images"][:, :16])
        assert client._request("POST", "/v1/sweeps", bad)[0] == 400
    finally:
        t.close()


def test_submission_error_mapping(grid):
    """Queue-full -> 429 + Retry-After; malformed body -> 400; unknown
    campaign -> 404 (status and stream alike)."""
    t = _start(grid, queue_max=0)
    try:
        client = SweepClient(t.host, t.port)
        conn = http.client.HTTPConnection(t.host, t.port, timeout=10)
        conn.request("POST", "/v1/sweeps",
                     json.dumps(_body(grid, "k-429")).encode())
        r = conn.getresponse()
        assert r.status == 429 and r.getheader("Retry-After")
        conn.close()
        assert client._request(
            "POST", "/v1/sweeps",
            {"v": 1, "idempotency_key": "x"})[0] == 400
        assert client._request(
            "POST", "/v1/sweeps", {"sweep": {}})[0] == 400
        assert client._request("GET", "/v1/sweeps/nope")[0] == 404
        assert client._request("GET", "/v1/sweeps/nope/stream")[0] == 404
    finally:
        t.close()


def test_status_get_never_waits_for_a_step(grid, mono):
    """While a step is held inside the service, the status GET answers
    at once and already reads ``running`` (the campaign's slot was
    admitted before the step began); readyz answers too.  The campaign
    then completes exactly."""
    t = SweepTransport(_service(grid))
    gate, entered = threading.Event(), threading.Event()
    real_step = t.service.step

    def held_step():
        if any(s is not None for s in t.service._slots):
            entered.set()
            assert gate.wait(30), "the test never opened the gate"
        return real_step()

    t.service.step = held_step
    t.start()
    try:
        client = SweepClient(t.host, t.port, timeout_s=5.0)
        s, o = client._request("POST", "/v1/sweeps", _body(grid, "k-held"))
        assert s == 201
        assert entered.wait(30), "the worker never stepped"
        t0 = time.monotonic()
        s, st = client._request("GET", f"/v1/sweeps/{o['campaign']}")
        waited = time.monotonic() - t0
        assert s == 200 and st["status"] == "running", st
        assert waited < 2.0, f"status GET waited {waited:.2f} s for a step"
        assert client._request("GET", "/readyz")[0] == 200
        gate.set()
        res = client.sweep(grid["programs"], grid["hw_configs"],
                           grid["mem_images"], idempotency_key="k-held")
        _assert_exact(mono, res.arrays)
    finally:
        gate.set()
        t.close()


def test_drain_refuses_new_work_and_closes_streams(grid):
    """Once a drain is requested, readyz and POST answer 503 at once
    (even while a step is in flight); after the step the open streams of
    unfinished campaigns end with the ``drained`` sentinel."""
    t = SweepTransport(_service(grid, slots=1, unit_size=1))
    armed, gate, entered = (threading.Event() for _ in range(3))
    real_step = t.service.step

    def held_step():
        if armed.is_set():
            entered.set()
            assert gate.wait(30), "the test never opened the gate"
        return real_step()

    t.service.step = held_step
    t.start()
    try:
        client = SweepClient(t.host, t.port, timeout_s=5.0)
        cids = [client._request("POST", "/v1/sweeps",
                                _body(grid, f"k-drain{i}"))[1]["campaign"]
                for i in range(2)]
        armed.set()                       # hold the next step
        assert entered.wait(30), "the worker never stepped"
        lasts = {}

        def stream(cid):
            lasts[cid] = list(client._stream_once(cid, 0))[-1]

        ths = [threading.Thread(target=stream, args=(c,)) for c in cids]
        for th in ths:
            th.start()
        t.request_drain()
        assert client._request("GET", "/readyz")[0] == 503
        assert client._request("POST", "/v1/sweeps",
                               _body(grid, "k-late"))[0] == 503
        gate.set()
        assert t.wait(30), "the transport never drained"
        for th in ths:
            th.join(timeout=30)
            assert not th.is_alive()
        assert {lasts[c]["status"] for c in cids} == {"drained"}
    finally:
        gate.set()
        t.close()


# ---------------------------------------------------------------------------
# Chaos over the wire: drop + disconnect + duplicate
# ---------------------------------------------------------------------------

def test_chaos_transport_folds_bit_identical(grid, mono):
    plan = FaultPlan(seed=7, net_submit_drop_rate=1.0,
                     net_max_submit_drops=2,
                     net_stream_disconnect_every=1,
                     net_duplicate_rate=0.5)
    t = _start(grid, injector=NetFaultInjector(plan))
    try:
        res = SweepClient(t.host, t.port, seed=3).sweep(
            grid["programs"], grid["hw_configs"], grid["mem_images"])
        _assert_exact(mono, res.arrays)
        st = res.stats
        assert st.submit_attempts >= 3
        assert st.reconnects >= 3
        assert st.duplicate_records >= 1
    finally:
        t.close()


def test_chaos_duplicate_delivery_reduced_idempotent(grid):
    spec = pareto.ParetoFront(axes=("latency_cc", "energy_pj"),
                              max_points=8)
    solo = dse.sweep(programs=grid["programs"], profile=grid["profile"],
                     hw_configs=grid["hw_configs"],
                     mem_images=grid["mem_images"], max_steps=MAX_STEPS,
                     device="cpu", reduce=spec)
    plan = FaultPlan(seed=11, net_stream_disconnect_every=2,
                     net_duplicate_rate=1.0)
    t = _start(grid, injector=NetFaultInjector(plan))
    try:
        res = SweepClient(t.host, t.port, seed=5).sweep(
            grid["programs"], grid["hw_configs"], grid["mem_images"],
            reduce=spec)
        assert res.stats.duplicate_records >= 1
        red = res.reduced()
        for f in pareto.REDUCED_FIELDS:
            assert np.asarray(getattr(red, f)).tobytes() \
                == getattr(solo, f).tobytes(), f
    finally:
        t.close()


def test_midstream_kill_resumes_from_cursor(grid, mono):
    t = _start(grid)
    try:
        client = SweepClient(t.host, t.port)
        s, obj = client._request("POST", "/v1/sweeps",
                                 _body(grid, "k-cursor"))
        assert s == 201
        cid = obj["campaign"]
        arrays = {f: np.zeros(8, _RESULT_DTYPES[f]) for f in RESULT_FIELDS}

        def fold(msg):
            lo, hi = msg["lo"], msg["hi"]
            for f in RESULT_FIELDS:
                arrays[f][lo:hi] = pareto.array_from_wire(msg["arrays"][f])

        first = []
        for msg in client._stream_once(cid, 0):
            if "arrays" in msg:
                first.append(msg["cursor"])
                fold(msg)
                if len(first) == 2:
                    break
        assert first == [0, 1]
        second = []
        for msg in client._stream_once(cid, 2):
            if "arrays" in msg:
                second.append(msg["cursor"])
                fold(msg)
        assert second == [2, 3]
        _assert_exact(mono, arrays)
    finally:
        t.close()


# ---------------------------------------------------------------------------
# The drill (subprocess): execution transients + network faults + one
# SIGTERM drain and restart; the folded answer is the monolithic sweep
# ---------------------------------------------------------------------------

DRILL_PLAN = FaultPlan(seed=13, transient_rate=0.6,
                       max_transient_per_unit=2,
                       net_submit_drop_rate=0.5, net_max_submit_drops=1,
                       net_stream_disconnect_every=2,
                       net_duplicate_rate=0.5)
DRILL_MEM = 4096
POLL_S = 30.0              # every wait of the drill fails loudly past it


def _serve(port_file, ckpt_root, port=0):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               # one intra-op thread: the test workers share the cores
               OMP_NUM_THREADS="1")
    env[FAULT_PLAN_ENV] = DRILL_PLAN.to_json()
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.service", "serve",
         "--device", "cpu", "--port", str(port),
         "--port-file", str(port_file), "--unit-size", "1",
         "--max-steps", str(MAX_STEPS), "--mem-size", str(DRILL_MEM),
         "--ckpt-root", str(ckpt_root)],
        cwd=str(ROOT), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _wait_port(port_file, proc):
    t0 = time.monotonic()
    while time.monotonic() - t0 < POLL_S:
        if port_file.exists():
            d = json.loads(port_file.read_text())
            return d["host"], d["port"]
        if proc.poll() is not None:
            raise AssertionError("server died before binding:\n"
                                 + proc.stdout.read().decode())
        time.sleep(0.05)
    proc.kill()
    raise AssertionError(f"server wrote no port file in {POLL_S} s")


def test_chaos_drain_restart_bit_identical(tmp_path, grid, mono, ref_mono):
    """A chaos server is SIGTERMed once the campaign has streamed a
    record; it drains (exit 0); the client rides the cut, re-submits to
    a restarted server on the same port and checkpoint root, which
    resumes the completed units, and the folded result is the monolithic
    sweep.  The status GETs that time the SIGTERM never wait for a step,
    so the drill does not depend on the machine's load."""
    port_file, ckpt_root = tmp_path / "port.json", tmp_path / "ck"
    srv = _serve(port_file, ckpt_root)
    srv2 = None
    try:
        host, port = _wait_port(port_file, srv)
        client = SweepClient(host, port, seed=17, timeout_s=POLL_S,
                             retry=ClientRetry(max_attempts=60,
                                               max_resubmits=8,
                                               max_backoff_s=1.0))
        result = {}

        def drive():
            try:
                result["res"] = client.sweep(
                    grid["programs"], grid["hw_configs"],
                    grid["mem_images"], idempotency_key="drill-1")
            except BaseException as e:        # surfaced after join
                result["err"] = e

        th = threading.Thread(target=drive)
        th.start()
        deadline, seen = time.monotonic() + POLL_S, None
        while time.monotonic() < deadline:
            try:
                s, o = client._request("GET", "/v1/sweeps/c0")
                seen = o
                if s == 200 and o.get("records", 0) >= 1 \
                        and o.get("status") == "running":
                    break
            except (OSError, http.client.HTTPException):
                pass
            time.sleep(0.02)
        else:
            raise AssertionError(f"c0 never streamed while running "
                                 f"within {POLL_S} s: {seen}")
        srv.send_signal(signal.SIGTERM)
        assert srv.wait(timeout=POLL_S) == 0
        assert "drained" in srv.stdout.read().decode()

        port_file.unlink()
        srv2 = _serve(port_file, ckpt_root, port=port)
        assert _wait_port(port_file, srv2) == (host, port)
        th.join(timeout=4 * POLL_S)
        assert not th.is_alive(), "client never completed after restart"
        if "err" in result:
            raise result["err"]
        res = result["res"]
        assert res.stats.resubmits >= 1
        _assert_exact(mono, res.arrays)
        _assert_matches_ref(ref_mono, res.arrays)
    finally:
        for p in (srv, srv2):
            if p is not None and p.poll() is None:
                p.send_signal(signal.SIGTERM)
                try:
                    p.wait(timeout=POLL_S)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
