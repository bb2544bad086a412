"""The partial evaluator's residual executor
(``executor.apply_segment_residual``): on the ``"cpu"`` backend, which
folds, a launch runs each segment's residual and must equal the raw-row
launch word for word in state and profile; each residual op kind equals
the reference's ``apply_segment_residual`` (inline backend); waves not
known to start zeroed, and backends that do not fold, run the raw rows.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import test_torch_step as ts
import test_torch_timing as tt
from engine_conformance import CASES as J_CASES
from repro.core import executor as j_executor
from repro.core import trace_engine as j_te
from repro.core.machine import SMConfig as JSMConfig
from repro_torch.core import (DeviceConfig, SMConfig, assemble, executor,
                              trace_engine)
from repro_torch.core.device import init_device_state
from repro_torch.core.executor import (get_execute_backend,
                                       register_backend,
                                       register_execute_backend)
from repro_torch.core.programs import run_fft_batch
from repro_torch.core.programs.fft import fft_program, fft_shmem
from repro_torch.core.programs.qrd import qrd_program, qrd_shmem
from repro_torch.kernels import simt_alu
from test_torch_launch import QRD_ATOL, QRD_FP_REGS, QRD_FP_SHMEM


@contextlib.contextmanager
def raw_rows():
    """The ``"cpu"`` backend with folding turned off: every segment runs
    its raw rows."""
    cpu = get_execute_backend("cpu")
    register_backend(dataclasses.replace(cpu, fold_constants=False))
    try:
        yield
    finally:
        register_backend(cpu)


def _rows_run(fn):
    executor.reset_segment_rows()
    res = fn()
    return res, dict(executor.segment_rows)


def _same_launch(a, b):
    for k in ("regs", "shmem", "gmem", "oob"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    for k in ("cycles", "steps", "halted", "engine", "engine_fallback"):
        assert getattr(a, k) == getattr(b, k), k
    assert a.profile() == b.profile()


def _folded_against_raw(fn):
    """Run ``fn`` folding and with raw rows; the two launches must be
    equal, and every raw row is a folded row or a residual op."""
    folded, seen = _rows_run(fn)
    with raw_rows():
        raw, raw_seen = _rows_run(fn)
    _same_launch(folded, raw)
    assert seen["raw"] == 0 and raw_seen["residual"] == 0
    assert seen["residual"] + seen["folded"] == raw_seen["raw"]
    return folded, seen


def test_backends_fold_as_the_reference_does():
    assert get_execute_backend("cpu").fold_constants
    assert not get_execute_backend("cuda").fold_constants
    assert j_executor.get_execute_backend("inline").fold_constants
    assert not j_executor.get_execute_backend("pallas").fold_constants


MEGA_GOLDEN = sorted(k for k, (_, _, eng) in tt.CASES.items()
                     if eng == "megakernel")


@pytest.mark.parametrize("name", MEGA_GOLDEN)
def test_golden_launch_runs_the_residual_and_equals_raw_rows(name):
    _, fn, _ = tt.CASES[name]
    res, seen = _folded_against_raw(fn)
    assert res.engine == "megakernel"
    assert seen["residual"] > 0


NON_HET = sorted(k for k, c in J_CASES.items() if not c.heterogeneous)


# the conformance cases of one program, Cholesky's solve among them (the
# golden entries run it on the step engine)
@pytest.mark.parametrize("name", NON_HET)
def test_conformance_case_on_the_megakernel_equals_raw_rows(name):
    _, seen = _folded_against_raw(
        lambda: ts.PORT_CASES[name]("megakernel", "static", 2))
    assert seen["residual"] > 0


HET = sorted(k for k, c in J_CASES.items() if c.heterogeneous)


@pytest.mark.parametrize("packing", ("grid", "length"))
@pytest.mark.parametrize("name", HET)
def test_merged_megakernel_residual_equals_raw_rows(name, packing):
    res, seen = _folded_against_raw(
        lambda: ts.PORT_CASES[name]("megakernel", "dynamic", 2, packing))
    assert res.trace_merge is not None
    # the fold counts the profile reports are the rows folded in the run
    assert seen["folded"] == res.profile()["trace_merge"]["fusion"][
        "folded_rows"]


def test_fold_counts_are_unchanged():
    dev = DeviceConfig(n_sms=4, backend="cpu",
                       sm=SMConfig(shmem_depth=192, max_steps=200_000))
    res, seen = _folded_against_raw(
        lambda: run_fft_batch(np.ones((4, 64), np.complex64),
                              device=dev)[1])
    # FFT-64's plan folds 84 of its 204 rows; one wave of four blocks
    assert seen == {"raw": 0, "residual": 120, "folded": 84}
    plan = trace_engine.compile_megakernel(
        fft_program(64), SMConfig(n_threads=32, dim_x=32, shmem_depth=192,
                                  max_steps=200_000))
    assert plan.stats()["folded_rows"] == 84
    assert plan.stats()["fused_rows"] == 204


# ---------------------------------------------------------------------------
# each residual op kind against the reference's residual executor
# ---------------------------------------------------------------------------

# (program, n_threads, shared-memory depth, the residual op kinds it holds)
_OPS = {
    # static LOD, one quarter of the threads out of range: oob
    "lod-out-of-range": ("""
        TDX R1
        LOD R2, (R1)+40
        STOP
    """, 32, 64, {"lod"}),
    # static STO, four threads a target address: the last one wins
    "sto-colliding": ("""
        TDX R1
        LOD R3, #2
        LSR.INT32 R4, R1, R3
        LOD R5, #7
        MUL.INT32 R6, R1, R5
        STO R6, (R4)+3
        STO R1, (R4)+1 {w4,d1}
        STOP
    """, 32, 64, {"sto"}),
    # runtime rows over loaded words, with known operands as literals
    "exec": ("""
        TDX R1
        LOD R2, (R1)+0
        LOD.FP32 R3, #3
        MUL.FP32 R4, R2, R3
        ADD.INT32 R5, R2, R1
        SETP.GT.INT32 R6, R5, R1
        @R6 SELP R7, R4, R2
        @!R6 ADD.FP32 R7, R7, R3
        SUM.FP32 R8, R4, R0
        DOT.FP32 R9, R4, R2
        LOD R10, (R5)+0
        STO R7, (R2)+0
        STOP
    """, 64, 128, {"exec", "lod"}),
}


def _segment_pair(asm, n_threads, depth):
    cfg = SMConfig(n_threads=n_threads, dim_x=n_threads, shmem_depth=depth,
                   max_steps=1000)
    jcfg = JSMConfig(n_threads=n_threads, dim_x=n_threads, shmem_depth=depth,
                     max_steps=1000)
    words = assemble(asm).words
    rows = trace_engine.compile_program(words, cfg).rows
    jrows = j_te._fused_rows(j_te.compile_program(words, jcfg))
    zeros = [np.zeros(512, np.uint32)] * 16
    seg, _ = executor.eval_segment_rows(cfg, rows, zeros, depth)
    jseg, _ = j_executor.eval_segment_rows(jcfg, jrows, zeros, depth)
    return cfg, jcfg, seg, jseg


def _both(cfg, jcfg, seg, jseg, shmem, n_sms, depth):
    import jax.numpy as jnp

    regs = np.zeros((n_sms, 512, 16), np.uint32)
    oob = np.zeros(n_sms, bool)
    bidx = np.arange(n_sms, dtype=np.int32)
    pidx = np.zeros(n_sms, np.int32)
    t = executor.apply_segment_residual(
        cfg, get_execute_backend("cpu"), seg, torch.from_numpy(bidx),
        torch.from_numpy(pidx), torch.from_numpy(regs.view(np.int32)),
        torch.from_numpy(shmem.view(np.int32)), torch.from_numpy(oob),
        shmem_depth=depth)
    j = j_executor.apply_segment_residual(
        jcfg, j_executor.get_execute_backend("inline"), jseg,
        jnp.asarray(bidx), jnp.asarray(pidx), jnp.asarray(regs),
        jnp.asarray(shmem), jnp.asarray(oob), shmem_depth=depth)
    got = [x.numpy() for x in t]
    got[0], got[1] = got[0].view(np.uint32), got[1].view(np.uint32)
    return got, [np.asarray(x) for x in j]


@pytest.mark.parametrize("name", sorted(_OPS))
def test_residual_op_matches_reference(name):
    asm, n_threads, depth, kinds = _OPS[name]
    cfg, jcfg, seg, jseg = _segment_pair(asm, n_threads, depth)
    assert {op[0] for op in seg.residual} == kinds
    assert [(op[0], op[1].fields) for op in seg.residual] == [
        (op[0], executor.FusedRow.from_fields(
            [int(op[1].d[f]) if f in op[1].d else getattr(op[1], f)
             for f in executor.FIELDS]).fields) for op in jseg.residual]
    rng = np.random.default_rng(5)
    shmem = rng.integers(0, 64, (3, depth), dtype=np.int64).astype(np.uint32)
    if name == "exec":
        shmem[1] = np.float32(rng.standard_normal(depth)).view(np.uint32) \
            & np.uint32(0xFFFFFF00)
    got, want = _both(cfg, jcfg, seg, jseg, shmem, 3, depth)
    for g, w, what in zip(got, want, ("regs", "shmem", "oob")):
        assert np.array_equal(g, w), what
    if name == "lod-out-of-range":
        assert got[2].all()
    if name == "sto-colliding":
        # each address holds its last writer's word
        assert [int(v) for v in got[1][0, 3:11]] == [
            7 * (4 * a + 3) for a in range(8)]


@pytest.mark.parametrize("program", ("fft64", "qrd16"))
def test_whole_plan_segment_matches_reference(program):
    """The first segment of FFT-64's and QRD-16's plans on their shared-
    memory images: FFT-64 word for word; QRD-16's FP32 words within the
    reference's INVSQR departure (``QRD_ATOL``, as
    ``test_qrd16_batch2_matches_reference``), the rest word for word."""
    rng = np.random.default_rng(11)
    if program == "fft64":
        n_threads, depth = 32, 192
        words = fft_program(64).words
        shmem = np.stack([fft_shmem((rng.standard_normal(64)
                                     + 1j * rng.standard_normal(64))
                                    .astype(np.complex64), depth)
                          for _ in range(2)])
    else:
        n_threads, depth = 256, 1024
        words = qrd_program().words
        shmem = np.stack([qrd_shmem(rng.standard_normal((16, 16))
                                    .astype(np.float32), depth)
                          for _ in range(2)])
    cfg = SMConfig(n_threads=n_threads, dim_x=16 if program == "qrd16"
                   else n_threads, shmem_depth=depth, imem_depth=1024,
                   max_steps=200_000)
    jcfg = JSMConfig(n_threads=n_threads, dim_x=cfg.dim_x, shmem_depth=depth,
                     imem_depth=1024, max_steps=200_000)
    plan = trace_engine.compile_megakernel(words, cfg)
    jplan = j_te.compile_megakernel(words, jcfg)
    seg = plan.segments[0]
    jseg = next(p for k, _, p in jplan.items if k == "fused")
    assert (seg.n_folded, len(seg.residual)) == (jseg.n_folded,
                                                 len(jseg.residual))
    got, want = _both(cfg, jcfg, seg, jseg,
                      np.asarray(shmem).view(np.uint32), 2, depth)
    assert np.array_equal(got[2], want[2])
    if program == "fft64":
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
        return
    ints = [r for r in range(16) if r not in QRD_FP_REGS]
    assert np.array_equal(got[0][:, :, ints], want[0][:, :, ints])
    np.testing.assert_allclose(
        got[0][:, :, QRD_FP_REGS].view(np.float32),
        want[0][:, :, QRD_FP_REGS].view(np.float32), rtol=0, atol=QRD_ATOL)
    outside = np.ones(depth, bool)
    outside[QRD_FP_SHMEM] = False
    assert np.array_equal(got[1][:, outside], want[1][:, outside])
    np.testing.assert_allclose(
        got[1][:, QRD_FP_SHMEM].view(np.float32),
        want[1][:, QRD_FP_SHMEM].view(np.float32), rtol=0, atol=QRD_ATOL)


# ---------------------------------------------------------------------------
# where the raw rows still run
# ---------------------------------------------------------------------------

def test_wave_from_arbitrary_state_runs_the_raw_rows():
    cfg = SMConfig(n_threads=32, dim_x=32, shmem_depth=192,
                   max_steps=200_000)
    plan = trace_engine.compile_megakernel(fft_program(64), cfg)
    rng = np.random.default_rng(3)
    st = init_device_state(cfg, 2, device=torch.device("cpu"))
    st = dataclasses.replace(st, regs=torch.from_numpy(
        rng.integers(-2**31, 2**31, (2, 512, 16), dtype=np.int64)
        .astype(np.int32)))
    z = torch.zeros(2, dtype=torch.int32)
    cpu = get_execute_backend("cpu")
    fin, seen = _rows_run(lambda: trace_engine.run_wave_megakernel(
        cpu, plan, z, z, st))
    assert seen == {"raw": 204, "residual": 0, "folded": 0}
    # the raw rows on that state differ from what the residual would give,
    # which holds only for zeroed registers
    res, _ = _rows_run(lambda: trace_engine.run_wave_megakernel(
        cpu, plan, z, z, st, zeroed=True))
    assert not torch.equal(fin.regs, res.regs)


def test_custom_backend_without_fold_constants_runs_the_raw_rows():
    @register_execute_backend("cpu-alu-only", device="cpu")
    def alu(op, typ, a, b, mask, old):
        return simt_alu.simt_alu(op, typ, a, b, mask, old)

    be = get_execute_backend("cpu-alu-only")
    assert not be.fold_constants
    register_backend(dataclasses.replace(get_execute_backend("cpu"),
                                         name="cpu-own"))
    assert get_execute_backend("cpu-own").fold_constants
    dev = DeviceConfig(n_sms=2, backend="cpu-alu-only",
                       sm=SMConfig(shmem_depth=192, max_steps=200_000))
    xs = np.ones((2, 64), np.complex64)
    res, seen = _rows_run(lambda: run_fft_batch(xs, device=dev)[1])
    assert seen == {"raw": 204, "residual": 0, "folded": 0}
    want = run_fft_batch(xs, device=dataclasses.replace(dev,
                                                        backend="cpu"))[1]
    _same_launch(res, want)
