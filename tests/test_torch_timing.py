"""The port's timing model against the JAX reference: static program traces,
wave packing and the block schedulers, and the golden cycle entries of the
megakernel slice reproduced by the port's own launches."""
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
from repro_torch.core import DeviceConfig, SMConfig
from repro_torch.core import cycles as t_cycles
from repro_torch.core import packing as t_packing
from repro_torch.core import scheduler as t_sched
from repro_torch.core.programs import launch_saxpy, run_fft_batch, run_qrd_batch

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
    return {"schedule": res.schedule, "cycles": int(res.cycles),
            "steps": int(res.steps),
            "static_cycles": int(res.static_cycles),
            "gmem": int(res.cycles_by_class[-1]),
            "wave_cycles": [int(c) for c in res.wave_cycles]}


# the golden shapes, built as the golden suite builds them; SAXPY asks for
# the megakernel, which "auto" declines on so short a program
def _saxpy(n_sms):
    x = np.arange(256, dtype=np.float32)
    dev = DeviceConfig(n_sms=n_sms, global_mem_depth=1024, backend="cpu",
                       engine="megakernel", sm=SMConfig(max_steps=10_000))
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


CASES = {}
for _n in (1, 2, 4):
    CASES[f"saxpy256_b64[{_n}sm]"] = (lambda n=_n: _saxpy(n))
    CASES[f"fft64_batch5[{_n}sm]"] = (lambda n=_n: _fft(n))
    CASES[f"qrd16_batch5[{_n}sm]"] = (lambda n=_n: _qrd(n))


@pytest.mark.parametrize("name", sorted(CASES))
def test_golden_cycles_reproduced_by_port(name):
    res = CASES[name]()
    assert res.engine == "megakernel"
    assert _record(res) == GOLDEN[name]
