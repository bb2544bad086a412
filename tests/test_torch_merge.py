"""Heterogeneous ("merged") waves against the JAX reference's plans.

  * the merged trace schedules the port's launches build for every
    heterogeneous case of ``tests/engine_conformance.py`` (both wave
    packings): the scan segments ``(start, end, live slots)``, the length,
    the halt flag and the padding of every member set;
  * the merged megakernel plans of the same launches: each item's kind,
    slot and row range, and each fused item's partial evaluation (rows
    folded, the residual ops and their host-resolved addresses, the
    columns known at its end);
  * the plan-time partial evaluator on every golden program's own plan
    (FFT-64 folds 84 of its 204 rows) and ``stats()`` against the
    reference's ``_fusion_stats``;
  * a fuel-limited program merged with a halting one, on both engines;
  * the fused two-stage reduction under ``"auto"`` (the merged
    megakernel), whose total must be the reference's fused total bit for
    bit over ``default_rng(0..11)``: the segment kernel sums a wavefront
    lane by lane, so it differs from the two-launch total (the step
    engine's pairwise fold) on some seeds, in both.
"""
import dataclasses

import numpy as np
import pytest

import engine_conformance as jc
from repro.core import DeviceConfig as JDeviceConfig
from repro.core import Kernel as JKernel
from repro.core import SMConfig as JSMConfig
from repro.core import launch as j_launch
from repro.core import trace_engine as j_trace
from repro.core.programs import launch_reduction as j_launch_reduction
from repro_torch.convert import launch_result_to_numpy
from repro_torch.core import DeviceConfig, Kernel, SMConfig, assemble, launch
from repro_torch.core import trace_engine as t_trace
from repro_torch.core.programs import (cholesky_imem_depth, fft_program,
                                       launch_reduction, qrd_program)
from repro_torch.core.programs.cholesky import cholesky_program
from repro_torch.core.programs.masked_reduction import \
    masked_reduction_program
from repro_torch.core.programs.reduction import (reduction_grid_asm,
                                                 reduction_program)
from repro_torch.core.programs.saxpy import saxpy_grid_program
from test_torch_step import PORT_CASES

HETEROGENEOUS = sorted(name for name, case in jc.CASES.items()
                       if case.heterogeneous)


def _j_cfg(cfg: SMConfig) -> JSMConfig:
    return JSMConfig(**dataclasses.asdict(cfg))


def _merged_plans(name: str, engine: str) -> list:
    """The (programs, cfgs, port plan) of every merged plan the port's
    launches of case ``name`` build on ``engine``, under both packings."""
    compile_fn = "compile_merged_megakernel" if engine == "megakernel" \
        else "compile_merged"
    real = getattr(t_trace, compile_fn)
    seen = []

    def record(programs, cfgs):
        plan = real(programs, cfgs)
        seen.append((list(programs), list(cfgs), plan))
        return plan

    mp = pytest.MonkeyPatch()
    mp.setattr(t_trace, compile_fn, record)
    try:
        for packing in ("grid", "length"):
            res = PORT_CASES[name](engine, "dynamic", 2, packing)
            assert res.trace_merge is not None
    finally:
        mp.undo()
    assert seen
    return seen


@pytest.mark.parametrize("name", HETEROGENEOUS)
def test_merged_trace_schedules_match_reference(name):
    for programs, cfgs, t in _merged_plans(name, "trace"):
        j = j_trace.compile_merged(programs, [_j_cfg(c) for c in cfgs])
        assert t.segments == j.segments
        assert (t.n_steps, t.n_programs, t.halted) \
            == (j.n_steps, j.n_programs, j.halted)
        n = t.n_programs
        for slots in ([k] for k in range(n)):
            assert t.padded_steps(slots) == j.padded_steps(slots)
        both = list(range(n)) * 2
        assert t.padded_steps(both) == j.padded_steps(both)


def _reference_items(j_items) -> list:
    """The reference plan's items as ``(kind, slot, (start, stop))``: the
    rows of each slot's schedule that each item covers."""
    cursor: dict = {}
    out = []
    for kind, slot, payload in j_items:
        start = cursor.get(slot, 0)
        stop = start + (len(payload.rows) if kind == "fused" else 1)
        cursor[slot] = stop
        out.append((kind, slot, (start, stop)))
    return out


def _port_items(items) -> list:
    out = []
    for kind, slot, payload in items:
        rng = payload if kind == "fused" else None
        out.append((kind, slot, rng))
    return out


def _assert_segment_equal(t, j):
    """One fused item's partial evaluation, word for word."""
    assert len(t.rows) == len(j.rows)
    assert t.n_folded == j.n_folded
    assert [op[0] for op in t.residual] == [op[0] for op in j.residual]
    for (kind, _, td, tc), (_, _, jd, jc_) in zip(t.residual, j.residual):
        assert [r for r, _ in tc] == [r for r, _ in jc_]
        for (_, tv), (_, jv) in zip(tc, jc_):
            assert np.array_equal(tv, np.asarray(jv))
        if kind != "exec":
            for a, b in zip(td, jd):
                assert np.array_equal(np.asarray(a), np.asarray(b))
    assert [r for r, _ in t.final_consts] == [r for r, _ in j.final_consts]
    for (_, tv), (_, jv) in zip(t.final_consts, j.final_consts):
        assert np.array_equal(tv, np.asarray(jv))


@pytest.mark.parametrize("name", HETEROGENEOUS)
def test_merged_megakernel_plans_match_reference(name):
    for programs, cfgs, t in _merged_plans(name, "megakernel"):
        j = j_trace.compile_merged_megakernel(programs,
                                              [_j_cfg(c) for c in cfgs])
        want = _reference_items(j.items)
        got = _port_items(t.items)
        assert [g[:2] for g in got] == [w[:2] for w in want]
        for g, w in zip(got, want):
            if g[0] == "fused":
                assert g[2] == w[2]
        j_segs = [p for kind, _, p in j.items if kind == "fused"]
        assert len(t.segments) == len(j_segs)
        for ts, js in zip(t.segments, j_segs):
            _assert_segment_equal(ts, js)
        assert t.stats() == j.stats()
        assert (t.n_steps, t.halted) == (j.n_steps, j.halted)


def _golden_programs() -> dict:
    """Every program of the golden launches, with its block's SMConfig."""
    sm = dict(max_steps=200_000)
    return {
        "saxpy_grid256_b64": (saxpy_grid_program(256, 64),
                              SMConfig(n_threads=64, dim_x=64, **sm)),
        "fft64": (fft_program(64), SMConfig(n_threads=32, dim_x=32, **sm)),
        "fft64_unrolled": (fft_program(64, unroll=True),
                           SMConfig(n_threads=32, dim_x=32,
                                    imem_depth=1024, **sm)),
        "qrd16": (qrd_program(), SMConfig(n_threads=256, dim_x=16,
                                          shmem_depth=1024,
                                          imem_depth=1024, **sm)),
        "qrd16_loop": (qrd_program(loop=True),
                       SMConfig(n_threads=256, dim_x=16, shmem_depth=1024,
                                **sm)),
        "reduction512": (reduction_program(512),
                         SMConfig(n_threads=512, dim_x=512, **sm)),
        "reduction_grid256_stage1": (
            assemble(reduction_grid_asm(256, 0, 1024, True)),
            SMConfig(n_threads=256, dim_x=256, **sm)),
        "reduction_grid16_stage2": (
            assemble(reduction_grid_asm(16, 1024, 1040, False)),
            SMConfig(n_threads=16, dim_x=16, **sm)),
        "cholesky16_solve": (cholesky_program(True),
                             SMConfig(n_threads=256, dim_x=16,
                                      shmem_depth=1024,
                                      imem_depth=cholesky_imem_depth(True),
                                      **sm)),
        "masked_reduction256_stage1": (
            masked_reduction_program(256, 0, 1024, 1056, 1059, 16),
            SMConfig(n_threads=256, dim_x=256, **sm)),
    }


@pytest.mark.parametrize("name", sorted(_golden_programs()))
def test_fold_counts_match_reference(name):
    program, cfg = _golden_programs()[name]
    t = t_trace.compile_megakernel(program, cfg)
    j = j_trace.compile_megakernel(program.words, _j_cfg(cfg))
    assert t.stats() == j.stats() == j_trace._fusion_stats(j.items)
    j_segs = [p for kind, _, p in j.items if kind == "fused"]
    assert len(t.segments) == len(j_segs)
    for ts, js in zip(t.segments, j_segs):
        _assert_segment_equal(ts, js)


def test_fft64_plan_folds_84_of_its_204_rows():
    plan = t_trace.compile_megakernel(
        fft_program(64), SMConfig(n_threads=32, dim_x=32,
                                  max_steps=200_000))
    assert plan.stats() == {"segments": 1, "fused_rows": 204,
                            "folded_rows": 84, "gmem_rows": 0,
                            "max_fused_run": 204}
    empty = t_trace.compile_megakernel(assemble("STOP"), SMConfig())
    assert empty.stats() == {"segments": 0, "fused_rows": 0,
                             "folded_rows": 0, "gmem_rows": 0,
                             "max_fused_run": 0}


def test_merged_waves_run_a_fuel_limited_program_beside_a_halting_one():
    # a merged wave runs each member to its own schedule's end: a
    # fuel-limited trace must replay exactly beside a halting one
    runaway = assemble("top:\nTDX R1\nADD.INT32 R2, R1, R1\n"
                       "STO R2, (R1)+0\nJMP top").words
    short = assemble("TDX R3\nSTO R3, (R3)+32\nSTOP").words
    outs = {}
    for eng in ("step", "trace", "megakernel"):
        kw = dict(n_sms=2, global_mem_depth=64, engine=eng)
        j = j_launch(
            JDeviceConfig(**kw, sm=JSMConfig(shmem_depth=64, max_steps=37)),
            programs=[JKernel(runaway, block=16, name="runaway"),
                      JKernel(short, block=16, name="short")],
            grid_map=[0, 1])
        t = launch(
            DeviceConfig(**kw, backend="cpu",
                         sm=SMConfig(shmem_depth=64, max_steps=37)),
            programs=[Kernel(runaway, block=16, name="runaway"),
                      Kernel(short, block=16, name="short")],
            grid_map=[0, 1])
        assert t.engine == eng and not t.halted
        assert (t.trace_merge is None) == (eng == "step")
        assert t.profile() == j.profile()
        got = launch_result_to_numpy(t)
        for k in ("regs", "shmem", "gmem", "oob"):
            assert np.array_equal(got[k], np.asarray(getattr(j, k))), (eng, k)
        outs[eng] = got
    for eng in ("trace", "megakernel"):
        for k in ("regs", "shmem", "gmem", "oob"):
            assert np.array_equal(outs[eng][k], outs["step"][k]), (eng, k)


def _bits(v) -> int:
    return int(np.float32(v).view(np.uint32))


@pytest.mark.parametrize("seed", range(12))
def test_fused_reduction_total_is_the_references_fused_total(seed):
    x = np.random.default_rng(seed).standard_normal(4096).astype(np.float32)
    j_total, j = j_launch_reduction(x, block=512, fused=True)
    t_total, t = launch_reduction(x, block=512, fused=True, backend="cpu")
    assert t.engine == j.engine == "megakernel"
    assert t.profile()["trace_merge"] == j.profile()["trace_merge"]
    assert _bits(t_total) == _bits(j_total)
    if seed == 1:
        # the two-launch form (step engine, pairwise fold) gives another
        # total on this draw, in the reference and in the port alike
        two, _ = launch_reduction(x, block=512, backend="cpu")
        assert (t_total, two) == (float.fromhex("-0x1.97f1c4p+4"),
                                  float.fromhex("-0x1.97f1c6p+4"))
