"""The step and trace engines end to end, and the merged waves of the
trace and megakernel engines: the port's launches (``backend="cpu"``, the
kernels' plain versions) against the JAX reference's same engine on its
inline backend, over the cases of ``tests/engine_conformance.py`` (the
heterogeneous ones under both wave packings), plus the single-SM shims
and a fuel-limited program.

Every case agrees on every word, flag, counter and profile field, except
that QRD and Cholesky FP32 words agree within ``FP_ATOL``: the reference
takes INVSQR from a refined hardware estimate, the port rounds it
correctly (ROADMAP §C). With the reference's ``rsqrt`` put in the port's
place, those two agree word for word as well.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import engine_conformance as jc
from repro.core import executor as j_executor
from repro.core import machine as j_machine
from repro.core.assembler import assemble as j_assemble
from repro.core.programs import cholesky as j_chol
from repro.core.programs import fft as j_fft
from repro.core.programs import qrd as j_qrd
from repro.core.programs import reduction as j_red
from repro.core.programs import saxpy as j_saxpy
from repro_torch.convert import (launch_result_to_numpy,
                                 machine_state_from_numpy,
                                 machine_state_to_numpy)
from repro_torch.core import (DeviceConfig, Kernel, SMConfig, assemble,
                              auto_nop, launch, profile, run, run_many)
from repro_torch.core.programs import (launch_fft_qrd, launch_masked_reduction,
                                       launch_reduction, launch_saxpy,
                                       mixed_device, run_cholesky,
                                       run_cholesky_batch, run_fft,
                                       run_fft_batch, run_qrd, run_qrd_batch,
                                       run_reduction, run_saxpy)
from repro_torch.kernels import ref

FP_ATOL = 2e-5


# ---------------------------------------------------------------------------
# the port's side of each conformance case (the reference's is
# engine_conformance.CASES[name].build)
# ---------------------------------------------------------------------------

def _saxpy(engine, schedule, n_sms):
    x = np.arange(64, dtype=np.float32)
    dev = DeviceConfig(n_sms=n_sms, global_mem_depth=512, engine=engine,
                       backend="cpu", sm=SMConfig(max_steps=10_000))
    return launch_saxpy(2.0, x, np.ones_like(x), device=dev, block=16,
                        schedule=schedule)[1]


def _reduction_fused(engine, schedule, n_sms, packing="grid"):
    dev = DeviceConfig(n_sms=n_sms, global_mem_depth=1024, engine=engine,
                       backend="cpu", packing=packing,
                       sm=SMConfig(max_steps=50_000))
    return launch_reduction(np.arange(256, dtype=np.float32), device=dev,
                            block=64, fused=True, schedule=schedule)[1]


def _fft_batch(engine, schedule, n_sms):
    xs = (np.linspace(-1, 1, 3 * 32).reshape(3, 32)
          + 0.5j * np.ones((3, 32))).astype(np.complex64)
    dev = DeviceConfig(n_sms=n_sms, engine=engine, backend="cpu",
                       sm=SMConfig(shmem_depth=128, max_steps=100_000))
    return run_fft_batch(xs, device=dev, schedule=schedule)[1]


def _qrd_batch(engine, schedule, n_sms):
    As = np.stack([np.eye(16, dtype=np.float32) + 0.1,
                   np.eye(16, dtype=np.float32) * 2.0])
    dev = DeviceConfig(n_sms=n_sms, engine=engine, backend="cpu",
                       sm=SMConfig(shmem_depth=1024, imem_depth=1024,
                                   max_steps=200_000))
    return run_qrd_batch(As, device=dev, schedule=schedule)[2]


def _mixed_fft_qrd(engine, schedule, n_sms, packing="grid", interleave=True,
                   priorities=None):
    dev = dataclasses.replace(mixed_device(32, n_sms=n_sms), engine=engine,
                              backend="cpu")
    xs = (np.ones((3, 32)) + 0.25j * np.arange(32)).astype(np.complex64)
    As = np.stack([np.eye(16, dtype=np.float32) + 0.05])
    return launch_fft_qrd(xs, As, device=dev, schedule=schedule,
                          interleave=interleave, priorities=priorities,
                          packing=packing)[3]


def _mixed_overrides(engine, schedule, n_sms, packing="grid"):
    words = assemble(auto_nop(jc._OVR_PROG, 32)).words
    other = assemble("TDX R1\nLOD R2, (R1)+0\nADD.INT32 R2, R2, R1\n"
                     "NOP\nNOP\nSTO R2, (R1)+0\nSTOP").words
    kerns = [Kernel(words, block=32, name="small", shmem_depth=24,
                    imem_depth=64),
             Kernel(other, block=48, name="full")]
    dev = DeviceConfig(n_sms=n_sms, global_mem_depth=256, engine=engine,
                       backend="cpu",
                       sm=SMConfig(shmem_depth=64, max_steps=5_000))
    return launch(dev, programs=kerns, grid_map=[0, 1, 1, 0, 1],
                  schedule=schedule, packing=packing)


def _predicated_mix(engine, schedule, n_sms, packing="grid"):
    a = assemble(auto_nop(jc._PRED_A, 16)).words
    b = assemble(auto_nop(jc._PRED_B, 16)).words
    kerns = [Kernel(a, block=16, name="pred"),
             Kernel(b, block=16, name="legacy")]
    dev = DeviceConfig(n_sms=n_sms, global_mem_depth=256, engine=engine,
                       backend="cpu",
                       sm=SMConfig(shmem_depth=64, max_steps=5_000))
    return launch(dev, programs=kerns, grid_map=[0, 1, 0, 1],
                  schedule=schedule, packing=packing)


def _cholesky_batch(engine, schedule, n_sms):
    rng = np.random.default_rng(7)
    g = rng.standard_normal((16, 16)).astype(np.float32)
    spd = (g @ g.T + 16 * np.eye(16)).astype(np.float32)
    psd = spd.copy()
    psd[5, :] = 0.0
    psd[:, 5] = 0.0
    dev = DeviceConfig(n_sms=n_sms, engine=engine, backend="cpu",
                       sm=SMConfig(shmem_depth=1024, imem_depth=1024,
                                   max_steps=200_000))
    return run_cholesky_batch(np.stack([spd, psd]), device=dev,
                              schedule=schedule, solve=False)[2]


def _masked_reduction(engine, schedule, n_sms, packing="grid"):
    dev = DeviceConfig(n_sms=n_sms, global_mem_depth=512, engine=engine,
                       backend="cpu", packing=packing,
                       sm=SMConfig(max_steps=50_000))
    return launch_masked_reduction(
        np.linspace(-2.0, 2.0, 120, dtype=np.float32), 0.25,
        clip=(-1.0, 1.0), device=dev, block=64, schedule=schedule)[2]


PORT_CASES = {
    "saxpy64_b16": _saxpy,
    "reduction256_fused": _reduction_fused,
    "fft32_batch3": _fft_batch,
    "qrd16_batch2": _qrd_batch,
    "mixed_fft_qrd": _mixed_fft_qrd,
    "mixed_backloaded_prio": lambda e, s, n, p="grid": _mixed_fft_qrd(
        e, s, n, p, interleave=False, priorities=(0, 1)),
    "mixed_overrides": _mixed_overrides,
    "predicated_mix": _predicated_mix,
    "cholesky16_batch2": _cholesky_batch,
    "masked_reduction120": _masked_reduction,
}
assert set(PORT_CASES) == set(jc.CASES)

# FP32 words of the INVSQR programs: the registers and shared-memory words
# that carry values derived from the norm reciprocal (QRD's in the mixed
# FFT + QRD grids; the FFT blocks' words there agree exactly)
_QRD_FP = ([2, 5, 6, 8, 9], slice(256, 785))
FP_WORDS = {
    "qrd16_batch2": _QRD_FP,
    "mixed_fft_qrd": _QRD_FP,
    "mixed_backloaded_prio": _QRD_FP,
    "cholesky16_batch2": ([2, 5, 6, 8, 9], slice(0, 560)),
}


def _cells():
    # the heterogeneous cases on all three engines (the step engine runs
    # them program-major, the other two in merged waves), and on the two
    # merged engines under "length" packing too
    for name, case in jc.CASES.items():
        engines = ("step", "trace", "megakernel") if case.heterogeneous \
            else ("step", "trace")
        for engine in engines:
            yield pytest.param(name, engine, "grid", id=f"{name}-{engine}")
        if case.heterogeneous:
            for engine in ("trace", "megakernel"):
                yield pytest.param(name, engine, "length",
                                   id=f"{name}-{engine}-length")


def _assert_counters_equal(j, t):
    for k in ("grid", "block", "n_waves", "halted", "steps", "cycles",
              "static_cycles", "buffer_offsets", "schedule", "packing",
              "engine", "engine_fallback", "program_names"):
        assert getattr(t, k) == getattr(j, k), k
    for k in ("wave_cycles", "cycles_by_class", "grid_map"):
        assert np.array_equal(getattr(t, k), getattr(j, k)), k
    assert t.profile() == j.profile()


def _assert_state_equal(j, t, fp_words=None):
    got = launch_result_to_numpy(t)
    for k in ("gmem", "oob"):
        assert np.array_equal(got[k], np.asarray(getattr(j, k))), k
    for k, fp in zip(("regs", "shmem"), fp_words or (None, None)):
        want = np.asarray(getattr(j, k))
        if fp is None:
            assert np.array_equal(got[k], want), k
            continue
        exact = np.ones(want.shape[1:], bool)
        exact[..., fp] = False
        assert np.array_equal(got[k][:, exact], want[:, exact]), k
        np.testing.assert_allclose(
            got[k][..., fp].view(np.float32), want[..., fp].view(np.float32),
            rtol=0, atol=FP_ATOL, err_msg=k)


@pytest.mark.parametrize("name,engine,packing", list(_cells()))
def test_engine_matches_reference(name, engine, packing):
    schedule = "dynamic" if jc.CASES[name].heterogeneous else "static"
    j = jc.CASES[name].build(engine, schedule, "inline", 2, packing)
    t = PORT_CASES[name](engine, schedule, 2, *(
        (packing,) if jc.CASES[name].heterogeneous else ()))
    assert t.engine == engine
    assert (t.trace_merge is not None) == (engine != "step"
                                           and jc.CASES[name].heterogeneous)
    _assert_counters_equal(j, t)
    _assert_state_equal(j, t, FP_WORDS.get(name))


def _reference_rsqrt(x):
    y = jax.jit(jax.lax.rsqrt)(x.numpy().view(np.float32))
    return torch.from_numpy(np.asarray(y).view(np.int32).copy())


@pytest.mark.parametrize("name", sorted(FP_WORDS))
def test_invsqr_is_the_only_departure(name, monkeypatch):
    # the reference's rsqrt in place of the port's correctly rounded
    # INVSQR: every word agrees
    monkeypatch.setattr(ref, "invsqr", _reference_rsqrt)
    j = jc.CASES[name].build("step", "dynamic", "inline", 2, "grid")
    t = PORT_CASES[name]("step", "dynamic", 2)
    _assert_state_equal(j, t)


@pytest.mark.parametrize("substitute", [False, True])
def test_qrd16_random_batch2_matches_reference_step(substitute, monkeypatch):
    # random matrices (seed 2): within FP_ATOL as the port stands, and
    # word for word with the reference's rsqrt in the port's INVSQR
    if substitute:
        monkeypatch.setattr(ref, "invsqr", _reference_rsqrt)
    As = np.random.default_rng(2).standard_normal((2, 16, 16)).astype(
        np.float32)
    sm = dict(shmem_depth=1024, imem_depth=1024, max_steps=200_000)
    _, _, j = j_qrd.run_qrd_batch(As, device=jc.DeviceConfig(
        n_sms=2, engine="step", backend="inline", sm=jc.SMConfig(**sm)))
    Qt, Rt, t = run_qrd_batch(As, device=DeviceConfig(
        n_sms=2, engine="step", backend="cpu", sm=SMConfig(**sm)))
    _assert_counters_equal(j, t)
    _assert_state_equal(j, t, None if substitute else _QRD_FP)
    for b in range(2):
        np.testing.assert_allclose(Qt[b] @ Rt[b], As[b], atol=5e-5)


@pytest.mark.parametrize("schedule", ["static", "dynamic"])
def test_step_engine_cells_over_sms_and_schedules(schedule):
    # saxpy and the fused reduction over the schedule x n_sms axes
    for n_sms in (1, 4):
        for name in ("saxpy64_b16", "reduction256_fused"):
            j = jc.CASES[name].build("step", schedule, "inline", n_sms,
                                     "grid")
            t = PORT_CASES[name]("step", schedule, n_sms)
            _assert_counters_equal(j, t)
            _assert_state_equal(j, t)


# ---------------------------------------------------------------------------
# single-SM shims
# ---------------------------------------------------------------------------

def _assert_machine_equal(j, t, fp_words=None):
    got = machine_state_to_numpy(t)
    for k, v in got.items():
        want = np.asarray(getattr(j, k))
        if k in ("regs", "shmem") and fp_words is not None:
            continue
        assert np.array_equal(v, want.astype(v.dtype)), k
    assert profile(t) == j_machine.profile(j)


def test_run_shims_match_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal(64).astype(np.float32)
    y = rng.standard_normal(64).astype(np.float32)
    zj, j = j_saxpy.run_saxpy(1.5, x, y)
    zt, t = run_saxpy(1.5, x, y, backend="cpu")
    _assert_machine_equal(j, t)
    assert np.array_equal(zt, zj)
    sj, j = j_red.run_reduction(x)
    st, t = run_reduction(x, backend="cpu")
    _assert_machine_equal(j, t)
    assert st == sj
    xs = (rng.standard_normal(32) + 1j * rng.standard_normal(32)).astype(
        np.complex64)
    Xj, j = j_fft.run_fft(xs)
    Xt, t = run_fft(xs, backend="cpu")
    _assert_machine_equal(j, t)
    assert np.array_equal(Xt, Xj)
    np.testing.assert_allclose(Xt, np.fft.fft(xs), atol=1e-4)


def test_run_shims_of_the_invsqr_programs():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((16, 16)).astype(np.float32)
    Qj, Rj, j = j_qrd.run_qrd(a)
    Qt, Rt, t = run_qrd(a, backend="cpu")
    _assert_machine_equal(j, t, fp_words=True)
    np.testing.assert_allclose(Qt, Qj, rtol=0, atol=FP_ATOL)
    np.testing.assert_allclose(Rt, Rj, rtol=0, atol=FP_ATOL)
    g = rng.standard_normal((16, 16)).astype(np.float32)
    spd = (g @ g.T + 16 * np.eye(16)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    Lj, yj, j = j_chol.run_cholesky(spd, b)
    Lt, yt, t = run_cholesky(spd, b, backend="cpu")
    _assert_machine_equal(j, t, fp_words=True)
    np.testing.assert_allclose(Lt, Lj, rtol=0, atol=FP_ATOL)
    np.testing.assert_allclose(yt, yj, rtol=0, atol=FP_ATOL)
    np.testing.assert_allclose(Lt @ Lt.T, spd, rtol=1e-5, atol=1e-3)


def test_run_many_and_state_carry_across():
    cfg = dict(n_threads=32, dim_x=32, shmem_depth=128, max_steps=10_000)
    words = j_fft.fft_program(64).words
    rng = np.random.default_rng(6)
    imgs = np.stack([j_fft.fft_shmem(
        (rng.standard_normal(64) + 1j * rng.standard_normal(64)), 192)
        for _ in range(3)])
    cfg["n_threads"], cfg["dim_x"], cfg["shmem_depth"] = 32, 32, 192
    j = j_executor.run_many(j_machine.SMConfig(**cfg), words, imgs)
    t = run_many(SMConfig(**cfg), words, imgs, backend="cpu")
    got = machine_state_to_numpy(t)
    for k, v in got.items():
        assert np.array_equal(v, np.asarray(getattr(j, k)).astype(v.dtype)), k
    # a reference state carries across and continues on the port
    prog = j_assemble("TDX R1\nLOD R2, #5\nSTOP\nADD.INT32 R3, R1, R2\n"
                      "NOP\nNOP\nSTO R3, (R1)+0\nSTOP")
    jcfg = j_machine.SMConfig(n_threads=16, dim_x=16, shmem_depth=64)
    j1 = j_executor.run(jcfg, prog.words)
    t1 = machine_state_from_numpy(
        {f.name: np.asarray(getattr(j1, f.name))
         for f in dataclasses.fields(j1)})
    # the first STOP halted both; clear it and run on from pc 3
    j2 = j_executor.run(jcfg, prog.words, state=j1.replace(
        halted=np.bool_(False)))
    t2 = run(SMConfig(n_threads=16, dim_x=16, shmem_depth=64), prog.words,
             state=t1.replace(halted=False), backend="cpu")
    _assert_machine_equal(j2, t2)


def test_fuel_limited_program_matches_reference():
    # a JMP loop never halts: "auto" resolves to the step engine, which
    # stops on its max_steps fuel with halted=False
    text = "TDX R1\nloop:\nADD.INT32 R2, R2, R1\nJMP loop\nSTOP"
    words = j_assemble(text).words
    jd = jc.DeviceConfig(n_sms=2, backend="inline",
                         sm=jc.SMConfig(max_steps=77))
    j = jc.launch(jd, words, grid=(3,), block=32)
    t = launch(DeviceConfig(n_sms=2, backend="cpu",
                            sm=SMConfig(max_steps=77)), words, grid=(3,),
               block=32)
    assert t.engine == "step" and t.engine_fallback == "fuel-limited-trace"
    assert not t.halted
    _assert_counters_equal(j, t)
    _assert_state_equal(j, t)


def test_engines_hand_the_kernels_what_they_take():
    # a host backend that checks every seam call as the CUDA wrappers do
    # (dtype, shape, device, contiguity, row fields) before its plain
    # version: the step and trace engines must pass all five row kernels'
    # checks, the megakernel engine the GLD and GST row kernels'
    from repro_torch.core.executor import (ExecBackend, _EXECUTE_BACKENDS,
                                           get_execute_backend,
                                           register_backend)
    from repro_torch.kernels import simt_alu as k_alu
    from repro_torch.kernels import simt_step as k_step

    cpu = get_execute_backend("cpu")
    seen = set()

    def checked(name, check, plain):
        def op(*args):
            seen.add(name)
            check(*args)
            return plain(*args)
        return op

    register_backend(ExecBackend(
        name="checked", device="cpu",
        alu_row=checked("alu_row", k_alu.check_alu_row_args, cpu.alu_row),
        lod_row=checked("lod_row", k_step.check_lod_row_args,
                        cpu.lod_row),
        sto_row=checked("sto_row", k_step.check_sto_row_args, cpu.sto_row),
        gld_row=checked("gld_row", k_step.check_gld_row_args, cpu.gld_row),
        gst_row=checked("gst_row", k_step.check_gst_row_args,
                        cpu.gst_row)))
    try:
        x = np.arange(64, dtype=np.float32)
        dev = DeviceConfig(n_sms=2, global_mem_depth=512,
                           engine="megakernel", backend="checked",
                           sm=SMConfig(max_steps=100_000))
        launch_saxpy(2.0, x, x, device=dev, block=16)
        assert seen == {"gld_row", "gst_row"}
        for engine in ("step", "trace"):
            dev = DeviceConfig(n_sms=2, global_mem_depth=512, engine=engine,
                               backend="checked",
                               sm=SMConfig(shmem_depth=128,
                                           max_steps=100_000))
            launch_saxpy(2.0, x, x, device=dev, block=16)
            run_fft_batch(np.ones((3, 32), np.complex64), device=dev)
        dev = DeviceConfig(n_sms=2, global_mem_depth=256, engine="step",
                           backend="checked",
                           sm=SMConfig(shmem_depth=64, max_steps=5_000))
        a = assemble(auto_nop(jc._PRED_A, 16)).words
        launch(dev, programs=[Kernel(a, block=16)], grid_map=[0, 0])
    finally:
        del _EXECUTE_BACKENDS["checked"]
    assert seen == {"alu_row", "lod_row", "sto_row", "gld_row", "gst_row"}
