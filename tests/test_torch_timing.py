"""The port's timing model against the JAX reference: static program traces,
wave packing and the block schedulers, and all 48 golden cycle entries
(the fleet's four included), reproduced by the port's own launches."""
import json
from pathlib import Path

import numpy as np
import pytest

from repro.core import cycles as j_cycles
from repro.core import packing as j_packing
from repro.core import scheduler as j_sched
from repro.core.programs import fft as j_fft
from repro.core.programs import qrd as j_qrd
from repro.core.programs import reduction as j_red
from repro.core.programs import saxpy as j_saxpy
from repro_torch.core import DeviceConfig, FleetConfig, SMConfig, launch_fleet
from repro_torch.core import cycles as t_cycles
from repro_torch.core import packing as t_packing
from repro_torch.core import scheduler as t_sched
from repro_torch.core.programs import (cholesky_imem_depth, fft_kernel,
                                       fft_shmem, launch_fft_qrd,
                                       launch_masked_reduction,
                                       launch_reduction, launch_saxpy,
                                       mixed_device, qrd_kernel, qrd_shmem,
                                       run_cholesky_batch, run_fft_batch,
                                       run_qrd_batch)
from repro_torch.core.programs.saxpy import saxpy_grid_program

GOLDEN = json.loads((Path(__file__).parent / "golden_cycles.json").read_text())

PROGRAMS = {
    "saxpy_grid256_b64": (lambda: j_saxpy.saxpy_grid_asm(256, 64), 64),
    "fft64": (lambda: j_fft.fft_asm(64), 32),
    "fft64_unrolled": (lambda: j_fft.fft_asm(64, unroll=True), 32),
    "qrd16": (lambda: j_qrd.qrd_asm(), 256),
    "qrd16_loop": (lambda: j_qrd.qrd_asm_loop(), 256),
    "reduction512": (lambda: j_red.reduction_asm(512), 512),
}


def _trace_view(tr, wave_n):
    return ([(int(t.op), t.klass, t.cycles, t.gmem, t.pc) for t in tr.instrs],
            tr.halted, tr.n_threads, tr.steps, tr.cycles, tr.gmem_cycles,
            tr.data_steps, tr.static_cycles(wave_n),
            list(tr.cycles_by_class(wave_n)))


def _traces(name):
    from repro.core.assembler import assemble

    text, n_threads = PROGRAMS[name]
    words = assemble(text()).words
    kw = dict(imem_depth=1024, max_steps=200_000)
    return (j_cycles.program_trace(words, n_threads, **kw),
            t_cycles.program_trace(words, n_threads, **kw))


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_trace_matches_reference(name):
    j, t = _traces(name)
    for wave_n in (1, 2, 4):
        assert _trace_view(t, wave_n) == _trace_view(j, wave_n)


@pytest.mark.parametrize("seed", range(6))
def test_pack_waves_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    lengths = rng.integers(0, 60, n).tolist()
    phases = np.sort(rng.integers(0, 3, n)).tolist()
    for policy in ("grid", "length", "auto"):
        for n_sms in (1, 3, 4):
            j = j_packing.pack_waves(lengths, n_sms, policy, phases)
            t = t_packing.pack_waves(lengths, n_sms, policy, phases)
            assert (t.policy, t.waves, t.wave_phase, t.lengths) \
                == (j.policy, j.waves, j.wave_phase, j.lengths)
            assert t.pad_steps() == j.pad_steps()
            assert t.occupancy == j.occupancy


def _schedule_view(s):
    return (s.mode, s.n_sms, s.makespan,
            *(np.asarray(a).tolist() for a in (
                s.block_sm, s.block_start, s.block_finish, s.block_busy,
                s.block_wait, s.block_gmem, s.wave_cycles, s.sm_idle)),
            s.port_busy, s.port_wait)


@pytest.mark.parametrize("mode", ["static", "dynamic"])
@pytest.mark.parametrize("seed", range(3))
def test_schedule_blocks_matches_reference(mode, seed):
    rng = np.random.default_rng(seed)
    pairs = [_traces(name) for name in
             ("saxpy_grid256_b64", "fft64", "qrd16_loop")]
    pick = rng.integers(0, len(pairs), int(rng.integers(1, 14)))
    phases = np.sort(rng.integers(0, 2, pick.size))
    prio = rng.integers(0, 3, pick.size)
    for n_sms in (1, 2, 4):
        args = dict(phase_of=phases.tolist(), priority_of=prio.tolist())
        j = j_sched.schedule_blocks([pairs[k][0] for k in pick], n_sms,
                                    mode, **args)
        t = t_sched.schedule_blocks([pairs[k][1] for k in pick], n_sms,
                                    mode, **args)
        assert _schedule_view(t) == _schedule_view(j)
        lengths = [pairs[k][1].data_steps for k in pick]
        jp = j_packing.pack_waves(lengths, n_sms, "length", phases)
        tp = t_packing.pack_waves(lengths, n_sms, "length", phases)
        j = j_sched.schedule_blocks([pairs[k][0] for k in pick], n_sms,
                                    mode, packing=jp, **args)
        t = t_sched.schedule_blocks([pairs[k][1] for k in pick], n_sms,
                                    mode, packing=tp, **args)
        assert _schedule_view(t) == _schedule_view(j)


def _record(res):
    # the golden suite's record: dynamic dispatch has no waves to list
    out = {"schedule": res.schedule, "cycles": int(res.cycles),
           "steps": int(res.steps),
           "static_cycles": int(res.static_cycles),
           "gmem": int(res.cycles_by_class[-1])}
    if res.n_waves:
        out["wave_cycles"] = [int(c) for c in res.wave_cycles]
    if res.fleet is not None:
        out["remote_gmem"] = int(res.fleet["remote_gmem_cycles"])
    return out


# the golden shapes, built as the golden suite builds them. SAXPY runs both
# on the megakernel and through "auto", which resolves so short a program
# to the step engine; the fused reduction and the mixed grids without a
# named engine go through "auto" as well, which runs them on the
# megakernel in merged waves; Cholesky and the masked reduction ask for
# the step engine (timing comes from the static traces on every engine)
def _saxpy(n_sms, engine="megakernel"):
    x = np.arange(256, dtype=np.float32)
    dev = DeviceConfig(n_sms=n_sms, global_mem_depth=1024, backend="cpu",
                       engine=engine, sm=SMConfig(max_steps=10_000))
    return launch_saxpy(2.0, x, np.ones_like(x), device=dev, block=64)[1]


def _fft(n_sms):
    dev = DeviceConfig(n_sms=n_sms, backend="cpu",
                       sm=SMConfig(shmem_depth=192, max_steps=200_000))
    return run_fft_batch(np.ones((5, 64), np.complex64), device=dev)[1]


def _qrd(n_sms):
    As = np.stack([np.eye(16, dtype=np.float32) + 0.1 * i for i in range(5)])
    dev = DeviceConfig(n_sms=n_sms, backend="cpu",
                       sm=SMConfig(shmem_depth=1024, imem_depth=1024,
                                   max_steps=200_000))
    return run_qrd_batch(As, device=dev)[2]


def _reduction_fused(n_sms):
    dev = DeviceConfig(n_sms=n_sms, global_mem_depth=2048, backend="cpu",
                       sm=SMConfig(max_steps=50_000))
    return launch_reduction(np.ones(1024, np.float32), device=dev,
                            block=256, fused=True)[1]


def _cholesky(n_sms):
    rng = np.random.default_rng(0)
    g = rng.standard_normal((16, 16)).astype(np.float32)
    As = np.stack([(g @ g.T + (16.0 + i) * np.eye(16)).astype(np.float32)
                   for i in range(5)])
    bs = np.stack([np.ones(16, np.float32) * (i + 1) for i in range(5)])
    dev = DeviceConfig(n_sms=n_sms, backend="cpu", engine="step",
                       sm=SMConfig(shmem_depth=1024,
                                   imem_depth=cholesky_imem_depth(True),
                                   max_steps=200_000))
    return run_cholesky_batch(As, bs, device=dev)[2]


def _masked_reduction(n_sms):
    x = np.linspace(-4.0, 4.0, 1024, dtype=np.float32)
    dev = DeviceConfig(n_sms=n_sms, global_mem_depth=2048, backend="cpu",
                       engine="step", sm=SMConfig(max_steps=50_000))
    return launch_masked_reduction(x, 0.5, clip=(-2.0, 2.0), device=dev,
                                   block=256)[2]


def _mixed(schedule, priorities=None, interleave=True, engine=None,
           n_sms=4, packing=None):
    xs = np.ones((6, 64), np.complex64)
    As = np.stack([np.eye(16, dtype=np.float32)] * 3)
    return launch_fft_qrd(xs, As, device=mixed_device(64, n_sms=n_sms,
                                                      backend="cpu"),
                          schedule=schedule, priorities=priorities,
                          interleave=interleave, engine=engine,
                          packing=packing)[3]


# test id -> (golden entry, launch, the engine it must have run on)
CASES = {}
for _n in (1, 2, 4):
    CASES[f"saxpy256_b64[{_n}sm]"] = (
        f"saxpy256_b64[{_n}sm]", lambda n=_n: _saxpy(n), "megakernel")
    CASES[f"fft64_batch5[{_n}sm]"] = (
        f"fft64_batch5[{_n}sm]", lambda n=_n: _fft(n), "megakernel")
    CASES[f"qrd16_batch5[{_n}sm]"] = (
        f"qrd16_batch5[{_n}sm]", lambda n=_n: _qrd(n), "megakernel")
    CASES[f"saxpy256_b64[{_n}sm,auto]"] = (
        f"saxpy256_b64[{_n}sm]", lambda n=_n: _saxpy(n, "auto"), "step")
    CASES[f"reduction1024_fused[{_n}sm]"] = (
        f"reduction1024_fused[{_n}sm]", lambda n=_n: _reduction_fused(n),
        "megakernel")
    for _name, _fn in (("cholesky16_solve_batch5", _cholesky),
                       ("masked_reduction1024", _masked_reduction)):
        CASES[f"{_name}[{_n}sm]"] = (
            f"{_name}[{_n}sm]", lambda n=_n, f=_fn: f(n), "step")
    for _s in ("dynamic", "static"):
        for _e in ("step", "trace", "megakernel"):
            _key = f"mixed_fft_qrd[{_n}sm,{_s},packed,{_e}-engine]"
            CASES[_key] = (_key, lambda n=_n, s=_s, e=_e: _mixed(
                s, interleave=False, engine=e, n_sms=n, packing="length"), _e)
for _s in ("dynamic", "static"):
    CASES[f"mixed_fft_qrd[4sm,{_s}]"] = (
        f"mixed_fft_qrd[4sm,{_s}]", lambda s=_s: _mixed(s), "megakernel")
    for _e in ("trace", "megakernel"):
        _key = f"mixed_fft_qrd[4sm,{_s},{_e}-engine]"
        CASES[_key] = (_key, lambda s=_s, e=_e: _mixed(s, engine=e), _e)
CASES["mixed_fft_qrd[4sm,dynamic,fifo-backloaded]"] = (
    "mixed_fft_qrd[4sm,dynamic,fifo-backloaded]",
    lambda: _mixed("dynamic", interleave=False), "megakernel")
CASES["mixed_fft_qrd[4sm,dynamic,qrd-first]"] = (
    "mixed_fft_qrd[4sm,dynamic,qrd-first]",
    lambda: _mixed("dynamic", priorities=(0, 1), interleave=False),
    "megakernel")


def _fleet_mixed(route="block"):
    dev = mixed_device(64, n_sms=2, backend="cpu")
    sh_f = np.stack([fft_shmem(x, dev.sm.shmem_depth)
                     for x in np.ones((6, 64), np.complex64)])
    sh_q = np.stack([qrd_shmem(A, dev.sm.shmem_depth)
                     for A in [np.eye(16, dtype=np.float32)] * 3])
    return launch_fleet(FleetConfig(n_devices=2, device=dev, route=route),
                        programs=[fft_kernel(64), qrd_kernel()],
                        grid_map=[0, 1, 0, 1, 0, 1, 0, 0, 0],
                        shmem=[sh_f, sh_q])


def _fleet_saxpy(lat):
    n, block = 256, 64
    buffers = {"x": np.arange(n, dtype=np.float32),
               "y": np.ones(n, np.float32), "z": np.zeros(n, np.float32),
               "alpha": np.asarray([2.0], np.float32)}
    dev = DeviceConfig(n_sms=2, global_mem_depth=1024, backend="cpu",
                       sm=SMConfig(max_steps=10_000))
    return launch_fleet(FleetConfig(n_devices=2, device=dev,
                                    remote_gmem_latency=lat),
                        saxpy_grid_program(n, block), grid=(n // block,),
                        block=block, buffers=buffers)


# the fleet: two devices of two SMs; "auto" runs the mixed grid's
# sub-launches on the megakernel and SAXPY's on the step engine
CASES["fleet_mixed_fft_qrd[2dev,2sm]"] = (
    "fleet_mixed_fft_qrd[2dev,2sm]", _fleet_mixed, "megakernel")
CASES["fleet_mixed_fft_qrd[2dev,2sm,kernel-route]"] = (
    "fleet_mixed_fft_qrd[2dev,2sm,kernel-route]",
    lambda: _fleet_mixed("kernel"), "megakernel")
for _lat in (0, 7):
    CASES[f"fleet_saxpy256_b64[2dev,numa{_lat}]"] = (
        f"fleet_saxpy256_b64[2dev,numa{_lat}]",
        lambda lat=_lat: _fleet_saxpy(lat), "step")
# every golden entry
assert set(GOLDEN) == {g for g, _, _ in CASES.values()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_golden_cycles_reproduced_by_port(name):
    golden_name, fn, engine = CASES[name]
    res = fn()
    assert res.engine == engine
    assert _record(res) == GOLDEN[golden_name]
