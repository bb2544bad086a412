"""The port's LaunchServer (``repro_torch.serve``) against the JAX
reference's, over the reference's LaunchServer suite: continuous batching
of a heterogeneous FFT-64 + QRD-16 batch, deterministic virtual-time
accounting, priority-aware admission, backpressure under both admission
policies, solo dispatch of buffer-carrying requests, the threaded
batcher and its stop paths, and the host dispatch-latency cycle model.

Each scenario runs the same numpy-seeded requests through both servers
and holds every ``ServeResult`` to the reference's: arrival, dispatch and
finish cycles, cycles, wait and latency, batch id, size and occupancy,
queue depth, the launch's profile and the shared-memory words (QRD's
FP32 words within ``test_torch_step.FP_ATOL``, the INVSQR and FMA
departures of ROADMAP §C). Where the background thread decides the
batches, only the words and each result's own cycle identities are
compared. The serve benchmark's 24-request trace must reproduce the
reference's recorded percentiles (``BENCH_serve.json``).
"""
import dataclasses
import json
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import pytest

from repro.core import DeviceConfig as JDeviceConfig
from repro.core import SMConfig as JSMConfig
from repro.core import launch as j_launch
from repro.core.programs.fft import fft_kernel as j_fft_kernel
from repro.core.programs.qrd import qrd_kernel as j_qrd_kernel
from repro.serve import LaunchRequest as JLaunchRequest
from repro.serve import LaunchServer as JLaunchServer
from repro_torch.core import DeviceConfig, SMConfig, launch
from repro_torch.core.programs.fft import bitrev_indices, fft_kernel, fft_shmem
from repro_torch.core.programs.qrd import Q_BASE, R_BASE, qrd_kernel, qrd_shmem
from repro_torch.serve import LaunchRequest, LaunchServer, QueueFull
from test_torch_step import _QRD_FP, FP_ATOL

ROOT = Path(__file__).resolve().parents[1]

PORT = dict(DeviceConfig=DeviceConfig, SMConfig=SMConfig,
            LaunchRequest=LaunchRequest, LaunchServer=LaunchServer,
            fft=fft_kernel, qrd=qrd_kernel, backend="cpu", launch=launch)
REF = dict(DeviceConfig=JDeviceConfig, SMConfig=JSMConfig,
           LaunchRequest=JLaunchRequest, LaunchServer=JLaunchServer,
           fft=j_fft_kernel, qrd=j_qrd_kernel, backend="inline",
           launch=j_launch)


def _small_dcfg(side, **kw):
    """Tiny device for FFT-16 traffic (block of 8 threads)."""
    return side["DeviceConfig"](
        n_sms=2, global_mem_depth=128, backend=side["backend"],
        sm=side["SMConfig"](shmem_depth=64, max_steps=200_000), **kw)


def _request(side, kind, data, **kw):
    """A request of ``kind`` ("fft" with n points, "qrd") on ``data``."""
    if kind == "qrd":
        kern, img = side["qrd"](), qrd_shmem(data, 1024)
    else:
        n = data.shape[0]
        kern, img = side["fft"](n), fft_shmem(data, 1024 if n == 64 else 64)
    prio = kw.pop("priority", 0)
    if prio:
        kern = dataclasses.replace(kern, priority=prio)
    return side["LaunchRequest"](kernel=kern, shmem=img, **kw)


def _fft16(rng, n=1):
    return [(rng.standard_normal(16)
             + 1j * rng.standard_normal(16)).astype(np.complex64)
            for _ in range(n)]


def _fft_out(r, n):
    mem = r.shmem_f32()[0]
    mem = np.asarray(mem.numpy() if hasattr(mem, "numpy") else mem)
    out = np.empty(n, np.complex64)
    out[bitrev_indices(n)] = mem[0:2 * n:2] + 1j * mem[1:2 * n:2]
    return out


def _same_words(t, j, qrd=False):
    got = t.shmem.numpy().view(np.uint32)
    want = np.asarray(j.shmem)
    assert got.shape == want.shape
    if not qrd:
        assert np.array_equal(got, want)
        return
    fp = _QRD_FP[1]
    exact = np.ones(want.shape[1], bool)
    exact[fp] = False
    assert np.array_equal(got[:, exact], want[:, exact])
    np.testing.assert_allclose(got[:, fp].view(np.float32),
                               want[:, fp].view(np.float32), rtol=0,
                               atol=FP_ATOL)


def _same_result(t, j, qrd=False, timing=True):
    """Port ``ServeResult`` ``t`` == the reference's ``j``."""
    assert t.finish_reason == j.finish_reason
    assert np.array_equal(t.oob.numpy(), np.asarray(j.oob))
    _same_words(t, j, qrd)
    assert t.latency_cycles == t.wait_cycles + t.cycles
    assert t.finish_cycle == t.dispatch_cycle + t.cycles
    if not timing:
        return
    fields = ("rid", "arrival_cycle", "dispatch_cycle", "finish_cycle",
              "cycles", "wait_cycles", "latency_cycles", "batch_id",
              "batch_size", "batch_occupancy", "queue_depth",
              "buffer_offsets")
    assert [getattr(t, f) for f in fields] == [getattr(j, f) for f in fields]
    assert t.profile == j.profile


def _both(scenario, **kw):
    """Run ``scenario(side, **kw)`` for the port and the reference."""
    return scenario(PORT, **kw), scenario(REF, **kw)


# ---------------------------------------------------------------------------
# continuous batching, virtual time, admission
# ---------------------------------------------------------------------------

def _heterogeneous(side):
    dcfg = side["DeviceConfig"](
        n_sms=4, global_mem_depth=64, backend=side["backend"],
        sm=side["SMConfig"](shmem_depth=1024, imem_depth=1024,
                            max_steps=200_000))
    server = side["LaunchServer"](dcfg, max_batch=8)
    rng = np.random.default_rng(0)
    xs = [(rng.standard_normal(64)
           + 1j * rng.standard_normal(64)).astype(np.complex64)
          for _ in range(3)]
    As = [rng.standard_normal((16, 16)).astype(np.float32) for _ in range(2)]
    futs = [server.submit(_request(side, "fft", x)) for x in xs]
    futs += [server.submit(_request(side, "qrd", a)) for a in As]
    assert server.drain() == 5
    return [f.result() for f in futs], server.stats(), xs, As


def test_launch_server_merges_heterogeneous_batch():
    (got, stats, xs, As), (want, j_stats, _, _) = _both(_heterogeneous)
    assert all(r.batch_size == 5 and r.batch_id == 0 for r in got)
    for x, r in zip(xs, got[:3]):
        np.testing.assert_allclose(_fft_out(r, 64), np.fft.fft(x),
                                   atol=1e-4)
    for a, r in zip(As, got[3:]):
        mem = r.shmem_f32()[0].numpy()
        q = mem[Q_BASE:Q_BASE + 256].reshape(16, 16).T
        rr = mem[R_BASE:R_BASE + 256].reshape(16, 16)
        np.testing.assert_allclose(q @ rr, a, atol=1e-4)
    for i, (t, j) in enumerate(zip(got, want)):
        _same_result(t, j, qrd=i >= 3)
    assert stats == j_stats
    assert stats["batches"] == 1 and stats["completed"] == 5


def _serve_trace(side):
    """A fixed 6-request FFT-16 trace with arrivals and priorities."""
    server = side["LaunchServer"](_small_dcfg(side), max_batch=4,
                                  schedule="dynamic")
    rng = np.random.default_rng(7)
    futs = [server.submit(_request(side, "fft", x, arrival_cycle=arrival,
                                   priority=prio))
            for x, (arrival, prio) in zip(_fft16(rng, 6), (
                (0, 0), (100, 0), (5000, 2), (5100, 0), (5200, 0),
                (20000, 1)))]
    server.drain()
    return [f.result() for f in futs], server.stats()


def test_launch_server_determinism():
    (a, stats), (want, j_stats) = _both(_serve_trace)
    b, _ = _serve_trace(PORT)
    for ra, rb, rj in zip(a, b, want):
        _same_result(ra, rj)
        _same_result(rb, rj)
    assert all(r.dispatch_cycle >= r.arrival_cycle for r in a)
    assert stats == j_stats


def _priority(side):
    server = side["LaunchServer"](_small_dcfg(side), max_batch=2,
                                  schedule="dynamic")
    rng = np.random.default_rng(8)
    xs = _fft16(rng, 4)
    futs = [server.submit(_request(side, "fft", x, arrival_cycle=0))
            for x in xs[:3]]
    prio = server.submit(_request(side, "fft", xs[3], arrival_cycle=0,
                                  priority=5))
    server.drain()
    return [f.result() for f in futs] + [prio.result()], xs[3]


def test_priority_enters_earlier_batch():
    (got, x), (want, _) = _both(_priority)
    prio, normals = got[3], got[:3]
    assert prio.batch_id == 0
    assert sorted(r.batch_id for r in normals) == [0, 1, 1]
    assert prio.profile["priority_respected"] is True
    np.testing.assert_allclose(_fft_out(prio, 16), np.fft.fft(x), atol=1e-4)
    for t, j in zip(got, want):
        _same_result(t, j)


# ---------------------------------------------------------------------------
# backpressure and solo dispatch
# ---------------------------------------------------------------------------

def _reject(side):
    server = side["LaunchServer"](_small_dcfg(side), max_queue=2,
                                  admission="reject")
    rng = np.random.default_rng(9)
    xs = _fft16(rng, 3)
    futs = [server.submit(_request(side, "fft", x)) for x in xs[:2]]
    with pytest.raises(RuntimeError, match="admission queue full") as e:
        server.submit(_request(side, "fft", xs[2]))
    rejected = server.stats()["rejected"]
    assert server.drain() == 2
    return [f.result() for f in futs], rejected, e.value


def test_backpressure_reject():
    (got, rejected, exc), (want, j_rejected, _) = _both(_reject)
    assert isinstance(exc, QueueFull)
    assert rejected == j_rejected == 1
    for t, j in zip(got, want):
        _same_result(t, j)


def _inline(side):
    server = side["LaunchServer"](_small_dcfg(side), max_queue=2,
                                  admission="block", max_batch=2)
    rng = np.random.default_rng(10)
    futs = [server.submit(_request(side, "fft", x)) for x in _fft16(rng, 3)]
    # the third submit had to dispatch the first batch to find room
    assert futs[0].done() and futs[1].done()
    assert server.queue_depth == 1
    server.drain()
    assert server.stats()["rejected"] == 0
    return [f.result() for f in futs]


def test_backpressure_block_dispatches_inline():
    got, want = _both(_inline)
    assert not any(bool(r.oob.any()) for r in got)
    for t, j in zip(got, want):
        _same_result(t, j)


def _solo(side):
    server = side["LaunchServer"](_small_dcfg(side), max_batch=8)
    rng = np.random.default_rng(11)
    xs = _fft16(rng, 4)
    f_a = server.submit(_request(side, "fft", xs[0]))
    f_b = server.submit(_request(side, "fft", xs[1]))
    scratch = np.arange(16, dtype=np.uint32)
    f_solo = server.submit(_request(side, "fft", xs[2],
                                    buffers={"scratch": scratch}))
    f_d = server.submit(_request(side, "fft", xs[3]))
    server.drain()
    return [f.result() for f in (f_a, f_b, f_solo, f_d)], xs[2], scratch


def test_buffer_requests_dispatch_solo():
    (got, x, scratch), (want, _, _) = _both(_solo)
    solo = got[2]
    assert solo.batch_size == 1
    assert solo.gmem is not None and solo.buffer_offsets is not None
    off, n = solo.buffer_offsets["scratch"]
    assert np.array_equal(solo.gmem[off:off + n].numpy().view(np.uint32),
                          scratch)
    assert np.array_equal(solo.gmem.numpy().view(np.uint32),
                          np.asarray(want[2].gmem))
    np.testing.assert_allclose(_fft_out(solo, 16), np.fft.fft(x), atol=1e-4)
    assert got[0].batch_size == 2 and got[1].batch_size == 2
    assert got[3].batch_size == 1 and got[0].gmem is None
    for t, j in zip(got, want):
        _same_result(t, j)


# ---------------------------------------------------------------------------
# the background batcher
# ---------------------------------------------------------------------------

def _reference_words(xs, max_batch):
    """The reference's results for FFT-16 requests on ``xs``, served
    synchronously."""
    server = JLaunchServer(_small_dcfg(REF), max_batch=max_batch)
    futs = [server.submit(_request(REF, "fft", x)) for x in xs]
    server.drain()
    return [f.result() for f in futs]


def test_threaded_server_round_trip():
    server = LaunchServer(_small_dcfg(PORT), max_batch=4)
    server.start()
    try:
        xs = _fft16(np.random.default_rng(12), 4)
        futs = [server.submit(_request(PORT, "fft", x)) for x in xs]
        results = [f.result(timeout=120) for f in futs]
    finally:
        server.stop()
    for x, r, j in zip(xs, results, _reference_words(xs, 4)):
        np.testing.assert_allclose(_fft_out(r, 16), np.fft.fft(x),
                                   atol=1e-4)
        _same_result(r, j, timing=False)
    assert server.stats()["completed"] == 4 and server.queue_depth == 0
    assert all(r.finish_reason == "ok" for r in results)


def test_stop_without_drain_resolves_queued_futures_terminally():
    server = LaunchServer(_small_dcfg(PORT), max_batch=4)
    server.start()
    rng = np.random.default_rng(21)
    xs = _fft16(rng, 7)
    futs = [server.submit(_request(PORT, "fft", x)) for x in xs[:6]]
    server.stop(drain=False)
    want = _reference_words(xs[:6], 4)
    for f, j in zip(futs, want):
        r = f.result(timeout=60)            # terminal, never a hang
        assert r.finish_reason in ("ok", "unadmitted")
        if r.finish_reason == "ok":
            _same_result(r, j, timing=False)
        else:
            assert r.shmem.shape == (1, 64) and not r.shmem.any()
    st = server.stats()
    assert st["completed"] + st["unadmitted"] == 6
    assert server.queue_depth == 0
    late = server.submit(_request(PORT, "fft", xs[6]))
    assert late.done()
    assert late.result(timeout=1).finish_reason == "unadmitted"


def test_stop_with_drain_serves_every_queued_request():
    server = LaunchServer(_small_dcfg(PORT), max_batch=2)
    server.start()
    xs = _fft16(np.random.default_rng(22), 5)
    futs = [server.submit(_request(PORT, "fft", x)) for x in xs]
    server.stop()
    results = [f.result(timeout=60) for f in futs]
    assert all(r.finish_reason == "ok" for r in results)
    for x, r, j in zip(xs, results, _reference_words(xs, 2)):
        np.testing.assert_allclose(_fft_out(r, 16), np.fft.fft(x),
                                   atol=1e-4)
        _same_result(r, j, timing=False)
    assert server.stats()["completed"] == 5


def test_submitter_blocked_on_full_queue_survives_stop():
    server = LaunchServer(_small_dcfg(PORT), max_queue=1,
                          admission="block", max_batch=1)
    xs = _fft16(np.random.default_rng(23), 2)
    outcome: dict[str, object] = {}

    def blocked_submit():
        fut = server.submit(_request(PORT, "fft", xs[1]))
        outcome["result"] = fut.result(timeout=60)

    with server._lock:                  # hold the batcher off
        server.start()
        first = server.submit(_request(PORT, "fft", xs[0]))
        t = threading.Thread(target=blocked_submit, daemon=True)
        t.start()
        deadline = time.time() + 30
        while time.time() < deadline:
            server._lock.release()
            time.sleep(0.01)
            server._lock.acquire()
            if len(server._queue) >= server.max_queue and t.is_alive():
                break
    server.stop(drain=False)
    t.join(timeout=60)
    assert not t.is_alive()
    want = _reference_words(xs, 1)
    for r, j in ((first.result(timeout=60), want[0]),
                 (outcome["result"], want[1])):
        assert r.finish_reason in ("ok", "unadmitted")
        if r.finish_reason == "ok":
            _same_result(r, j, timing=False)


# ---------------------------------------------------------------------------
# host dispatch latency + static-priority visibility
# ---------------------------------------------------------------------------

def _one_fft16_launch(side, dcfg, *, queue_depth=0, schedule=None,
                      priority=0):
    x = _fft16(np.random.default_rng(13))[0]
    kern = side["fft"](16)
    if priority:
        kern = dataclasses.replace(kern, priority=priority)
    return side["launch"](dcfg, programs=[kern], grid_map=[0, 0],
                          shmem=[np.stack([fft_shmem(x, 64)] * 2)],
                          queue_depth=queue_depth, schedule=schedule)


def test_host_dispatch_latency_in_cycle_model():
    base = _one_fft16_launch(PORT, _small_dcfg(PORT))
    assert "host_dispatch" not in base.profile()
    for depth, extra in ((3, 130), (10, 200)):
        got, want = (_one_fft16_launch(
            side, _small_dcfg(side, dispatch_latency=100, queue_latency=10),
            queue_depth=depth) for side in (PORT, REF))
        assert got.profile()["host_dispatch"] == {
            "queue_depth": depth, "dispatch_cycles": 100,
            "queue_cycles": 10 * depth, "latency_cycles": extra}
        assert got.cycles == base.cycles + extra
        assert np.array_equal(got.timing.block_start,
                              base.timing.block_start + extra)
        assert np.array_equal(got.shmem.numpy(), base.shmem.numpy())
        assert got.profile() == want.profile()
        assert np.array_equal(got.shmem.numpy().view(np.uint32),
                              np.asarray(want.shmem))


def test_static_schedule_surfaces_priority_loss():
    from repro_torch.core import device as device_mod

    dcfg = _small_dcfg(PORT)
    device_mod._STATIC_PRIORITY_WARNED = False
    with pytest.warns(UserWarning, match="priority"):
        res = _one_fft16_launch(PORT, dcfg, schedule="static", priority=3)
    assert res.profile()["priority_respected"] is False
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res2 = _one_fft16_launch(PORT, dcfg, schedule="static", priority=3)
    assert res2.profile()["priority_respected"] is False
    assert _one_fft16_launch(PORT, dcfg, schedule="dynamic", priority=3
                             ).profile()["priority_respected"] is True
    assert _one_fft16_launch(PORT, dcfg, schedule="static"
                             ).profile()["priority_respected"] is True
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = _one_fft16_launch(REF, _small_dcfg(REF), schedule="static",
                                 priority=3)
    assert res.profile() == want.profile()


# ---------------------------------------------------------------------------
# the serve benchmark's trace
# ---------------------------------------------------------------------------

def _bench_trace(n_req, seed=0):
    """The open-loop trace of the reference's serve benchmark: 2:1
    FFT-64:QRD-16, exponential gaps of mean 600 cycles, ~1 in 6 at
    priority 2."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(scale=600.0, size=n_req)).astype(
        np.int64)
    trace = []
    for i in range(n_req):
        prio = 2 if rng.random() < 1 / 6 else 0
        if i % 3 == 2:
            trace.append(("qrd", rng.standard_normal((16, 16)).astype(
                np.float32), int(arrivals[i]), prio))
        else:
            trace.append(("fft", (rng.standard_normal(64)
                                  + 1j * rng.standard_normal(64)).astype(
                np.complex64), int(arrivals[i]), prio))
    return trace


@pytest.mark.parametrize("line,max_batch", [("serial", 1), ("batched", 8)])
def test_serve_bench_trace_reproduces_the_references_record(line,
                                                            max_batch):
    want = json.loads((ROOT / "BENCH_serve.json").read_text())
    trace = _bench_trace(want["n_requests"])
    dcfg = DeviceConfig(n_sms=4, global_mem_depth=1024, backend="cpu",
                        sm=SMConfig(shmem_depth=1024, imem_depth=1024,
                                    max_steps=200_000),
                        dispatch_latency=200, queue_latency=8)
    server = LaunchServer(dcfg, max_queue=len(trace) + 1,
                          max_batch=max_batch, schedule="dynamic")
    futs = [server.submit(_request(PORT, kind, data, arrival_cycle=arrival,
                                   priority=prio, tag=kind))
            for kind, data, arrival, prio in trace]
    server.drain()
    res = [f.result() for f in futs]
    lat = np.asarray(sorted(r.latency_cycles for r in res))
    got = {
        "p50_latency_cycles": int(np.percentile(lat, 50)),
        "p99_latency_cycles": int(np.percentile(lat, 99)),
        "mean_latency_cycles": int(lat.mean()),
        "makespan_cycles": int(max(r.finish_cycle for r in res)),
        "mean_batch_size": round(float(np.mean([r.batch_size
                                                for r in res])), 2),
        "batch_occupancy": round(float(np.mean([r.batch_occupancy
                                                for r in res])), 3),
    }
    assert got == {k: want["lines"][line][k] for k in got}
