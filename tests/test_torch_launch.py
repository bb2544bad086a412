"""The megakernel slice end to end: the port's launch (``backend="cpu"``,
the kernels' plain versions) against the JAX reference's megakernel launch
on its inline backend, at small size on 2 SMs.

FFT and SAXPY agree bit for bit. QRD agrees bit for bit on every integer
word, flag, counter and profile field; its FP32 words agree within
``QRD_ATOL``, because the reference's compiled segment contracts QRD's
``MUL.FP32`` / ``SUB.FP32`` projection pair into one fused multiply-add
and takes ``1/sqrt`` from a refined hardware estimate, while the port
rounds every instruction once and INVSQR correctly (ROADMAP §C).
"""
import numpy as np
import pytest
import torch

from repro.core import DeviceConfig as JDeviceConfig
from repro.core import SMConfig as JSMConfig
from repro.core.programs import fft as j_fft
from repro.core.programs import qrd as j_qrd
from repro.core.programs import saxpy as j_saxpy
from repro_torch.convert import (launch_result_to_numpy, state_from_numpy,
                                 state_to_numpy)
from repro_torch.core import DeviceConfig, Kernel, SMConfig, launch
from repro_torch.core.programs import (fft_program, launch_saxpy,
                                       run_fft_batch, run_qrd_batch)
from repro_torch.core.programs.saxpy import saxpy_grid_program

QRD_ATOL = 2e-5
# QRD's register map: R2 residual, R5 q, R6/R8/R9 products, norms and
# coefficients hold FP32 words; Q, R and the norm reciprocal live in shared
# memory words [256, 785)
QRD_FP_REGS = [2, 5, 6, 8, 9]
QRD_FP_SHMEM = slice(256, 785)


def _devices(**kw):
    sm = kw.pop("sm")
    return (JDeviceConfig(n_sms=2, engine="megakernel", backend="inline",
                          sm=JSMConfig(**sm), **kw),
            DeviceConfig(n_sms=2, engine="megakernel", backend="cpu",
                         sm=SMConfig(**sm), **kw))


def _assert_counters_equal(j, t):
    assert t.engine == j.engine == "megakernel"
    for k in ("grid", "block", "n_waves", "halted", "steps", "cycles",
              "static_cycles", "buffer_offsets", "schedule", "packing",
              "engine_fallback", "program_names"):
        assert getattr(t, k) == getattr(j, k), k
    for k in ("wave_cycles", "cycles_by_class", "grid_map"):
        assert np.array_equal(getattr(t, k), getattr(j, k)), k
    assert t.profile() == j.profile()


def _assert_state_equal(j, t, skip=()):
    got = launch_result_to_numpy(t)
    for k in ("regs", "shmem", "gmem", "oob"):
        if k not in skip:
            assert np.array_equal(got[k], np.asarray(getattr(j, k))), k


def test_fft16_batch3_matches_reference_bit_for_bit():
    rng = np.random.default_rng(0)
    xs = (rng.standard_normal((3, 16))
          + 1j * rng.standard_normal((3, 16))).astype(np.complex64)
    jd, td = _devices(sm=dict(shmem_depth=64, max_steps=200_000))
    Xj, j = j_fft.run_fft_batch(xs, device=jd)
    Xt, t = run_fft_batch(xs, device=td)
    _assert_state_equal(j, t)
    _assert_counters_equal(j, t)
    assert np.array_equal(Xt, Xj)


def test_saxpy256_b64_matches_reference_bit_for_bit():
    rng = np.random.default_rng(1)
    x = rng.standard_normal(256).astype(np.float32)
    y = rng.standard_normal(256).astype(np.float32)
    jd, td = _devices(global_mem_depth=1024, sm=dict(max_steps=10_000))
    zj, j = j_saxpy.launch_saxpy(-1.5, x, y, device=jd, block=64)
    zt, t = launch_saxpy(-1.5, x, y, device=td, block=64)
    _assert_state_equal(j, t)
    _assert_counters_equal(j, t)
    assert np.array_equal(zt, zj)
    np.testing.assert_allclose(zt, -1.5 * x + y, rtol=1e-6)


def test_qrd16_batch2_matches_reference():
    rng = np.random.default_rng(2)
    As = rng.standard_normal((2, 16, 16)).astype(np.float32)
    jd, td = _devices(sm=dict(shmem_depth=1024, imem_depth=1024,
                              max_steps=200_000))
    Qj, Rj, j = j_qrd.run_qrd_batch(As, device=jd)
    Qt, Rt, t = run_qrd_batch(As, device=td)
    _assert_state_equal(j, t, skip=("regs", "shmem"))
    _assert_counters_equal(j, t)
    got = launch_result_to_numpy(t)
    jregs, jsh = np.asarray(j.regs), np.asarray(j.shmem)
    int_regs = [r for r in range(16) if r not in QRD_FP_REGS]
    assert np.array_equal(got["regs"][:, :, int_regs], jregs[:, :, int_regs])
    fp = got["regs"][:, :, QRD_FP_REGS].view(np.float32)
    np.testing.assert_allclose(
        fp, jregs[:, :, QRD_FP_REGS].view(np.float32), rtol=0, atol=QRD_ATOL)
    outside = np.ones(jsh.shape[1], bool)
    outside[QRD_FP_SHMEM] = False
    assert np.array_equal(got["shmem"][:, outside], jsh[:, outside])
    np.testing.assert_allclose(
        got["shmem"][:, QRD_FP_SHMEM].view(np.float32),
        jsh[:, QRD_FP_SHMEM].view(np.float32), rtol=0, atol=QRD_ATOL)
    for b in range(2):
        np.testing.assert_allclose(Qt[b] @ Rt[b], As[b], atol=5e-5)
        np.testing.assert_allclose(Qt[b].T @ Qt[b], np.eye(16), atol=5e-5)


def test_state_carry_across_roundtrips():
    rng = np.random.default_rng(3)
    regs = rng.integers(0, 1 << 32, (2, 512, 16), dtype=np.uint64).astype(
        np.uint32)
    shmem = rng.integers(0, 1 << 32, (2, 64), dtype=np.uint64).astype(
        np.uint32)
    gmem = rng.integers(0, 1 << 32, (99,), dtype=np.uint64).astype(np.uint32)
    oob = np.array([True, False])
    st = state_from_numpy(regs, shmem, gmem, oob)
    assert st.regs.dtype == torch.int32 and st.oob.dtype == torch.bool
    back = state_to_numpy(st)
    for k, v in dict(regs=regs, shmem=shmem, gmem=gmem, oob=oob).items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v)


def test_cuda_backend_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.ones(64, np.float32)
    for engine in ("megakernel", "step", "trace"):
        dev = DeviceConfig(n_sms=2, global_mem_depth=256, engine=engine)
        with pytest.raises(RuntimeError, match="CUDA device"):
            launch_saxpy(1.0, x, x, device=dev, block=64)
    with pytest.raises(RuntimeError, match="CUDA device"):
        launch_saxpy(1.0, x, x)


def test_engines_outside_the_slice_raise():
    prog = saxpy_grid_program(256, 64)
    dev = DeviceConfig(n_sms=2, global_mem_depth=1024, backend="cpu")
    buffers = {"x": np.ones(256, np.float32), "y": np.ones(256, np.float32),
               "z": np.zeros(256, np.float32), "a": np.ones(1, np.float32)}
    # "auto" keeps the reference's ladder: saxpy is too short to fuse, so
    # it resolves to the step engine, which now runs it
    res = launch(dev, prog, grid=(4,), block=64, buffers=buffers)
    assert res.engine == "step"
    assert res.engine_fallback == "megakernel-too-small"
    assert np.array_equal(res.buffer("z").numpy(), np.full(256, 2.0,
                                                           np.float32))
    # the step engine runs a two-program grid, program-major
    mixed = [Kernel(prog, block=64), Kernel(fft_program(16), block=8)]
    res = launch(dev, programs=mixed, grid_map=[0, 1], buffers=buffers,
                 engine="step")
    assert res.engine == "step" and res.halted
    assert res.program_names == ("k0", "k1")
    # the compiled engines run it in merged waves, to the step engine's
    # state
    step = launch_result_to_numpy(res)
    for engine in ("trace", "megakernel"):
        got = launch(dev, programs=mixed, grid_map=[0, 1], buffers=buffers,
                     engine=engine)
        assert got.engine == engine and got.halted
        merge = got.profile()["trace_merge"]
        assert merge["n_waves"] == 1
        assert merge["per_wave"][0]["programs"] == ["k0", "k1"]
        assert ("fusion" in merge) == (engine == "megakernel")
        got = launch_result_to_numpy(got)
        for k in ("regs", "shmem", "gmem", "oob"):
            assert np.array_equal(got[k], step[k]), (engine, k)
