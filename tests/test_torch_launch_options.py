"""The rest of the port's launch front door against the JAX reference:
the host dispatch latency (``DeviceConfig.dispatch_latency``/
``queue_latency``, ``launch(queue_depth=)``), ``launch(block_ids=)`` on
the step, trace and megakernel engines and in merged waves,
``scheduler.merge_schedules``, ``assembler.disassemble`` and
``executor.register_execute_backend``. Inputs come from numpy seeds;
every comparison is ``==``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import DeviceConfig as JDeviceConfig
from repro.core import SMConfig as JSMConfig
from repro.core import cycles as j_cycles
from repro.core import executor as j_executor
from repro.core import launch as j_launch
from repro.core import scheduler as j_sched
from repro.core.assembler import assemble as j_assemble
from repro.core.assembler import disassemble as j_disassemble
from repro.core.programs.fft import fft_kernel as j_fft_kernel
from repro.core.programs.qrd import qrd_kernel as j_qrd_kernel
from repro_torch.convert import launch_result_to_numpy
from repro_torch.core import (DeviceConfig, Kernel, SMConfig, assemble,
                              disassemble, launch, merge_schedules,
                              register_execute_backend, schedule_blocks)
from repro_torch.core import cycles as t_cycles
from repro_torch.core import scheduler as t_sched
from repro_torch.core.isa import Op
from repro_torch.core.machine import as_u32_image
from repro_torch.core.programs.fft import fft_kernel, fft_shmem
from repro_torch.core.programs.qrd import qrd_kernel, qrd_shmem
from repro_torch.core.programs.saxpy import saxpy_grid_program
from repro_torch.kernels.simt_alu import alu_plain


def _j_dcfg(dcfg: DeviceConfig, backend="inline") -> JDeviceConfig:
    """The reference's device of the same shape."""
    kw = dataclasses.asdict(dcfg)
    kw.update(sm=JSMConfig(**kw["sm"]), backend=backend)
    return JDeviceConfig(**kw)


def _j_kernel(k: Kernel):
    from repro.core import Kernel as JKernel

    return JKernel(**{f.name: getattr(k, f.name)
                      for f in dataclasses.fields(k)})


def _assert_same(t, j):
    """Port launch ``t`` == reference launch ``j``: state, counters,
    timeline and profile."""
    got = launch_result_to_numpy(t)
    for k in ("regs", "shmem", "gmem", "oob"):
        assert np.array_equal(got[k], np.asarray(getattr(j, k))), k
    for k in ("grid", "n_waves", "halted", "steps", "cycles",
              "static_cycles", "schedule", "engine", "host_dispatch"):
        assert getattr(t, k) == getattr(j, k), k
    for k in ("wave_cycles", "cycles_by_class"):
        assert np.array_equal(getattr(t, k), getattr(j, k)), k
    for k in ("block_sm", "block_start", "block_finish", "block_busy",
              "block_wait"):
        assert np.array_equal(getattr(t.timing, k),
                              np.asarray(getattr(j.timing, k))), k
    assert t.profile() == j.profile()


# ---------------------------------------------------------------------------
# host dispatch latency: launch(queue_depth=)
# ---------------------------------------------------------------------------

def _fft_mix(rng, n_fft, n_qrd):
    """FFT-16 x ``n_fft`` (and QRD-16 x ``n_qrd`` behind it): programs,
    grid map and shared-memory batches, one set for each package."""
    xs = (rng.standard_normal((n_fft, 16))
          + 1j * rng.standard_normal((n_fft, 16))).astype(np.complex64)
    As = np.stack([np.eye(16, dtype=np.float32)] * n_qrd) if n_qrd \
        else None
    sh = [np.stack([fft_shmem(x, 1024) for x in xs])]
    port, ref = [fft_kernel(16)], [j_fft_kernel(16)]
    if n_qrd:
        sh.append(np.stack([qrd_shmem(A, 1024) for A in As]))
        port.append(qrd_kernel())
        ref.append(j_qrd_kernel())
    gmap = [0] * n_fft + [1] * n_qrd
    return port, ref, gmap, sh


LAUNCHES = {
    # one program, static: the lockstep counters plus the charge
    "fft16x3_static": (3, 0, "static", "auto"),
    "fft16x3_dynamic": (3, 0, "dynamic", "auto"),
    # FFT + QRD in merged waves on the megakernel
    "fft16x3_qrd16x2_merged": (3, 2, "dynamic", "megakernel"),
    "fft16x3_qrd16x2_step": (3, 2, "static", "step"),
}


@pytest.mark.parametrize("latencies", [(0, 0), (100, 10)])
@pytest.mark.parametrize("name", sorted(LAUNCHES))
def test_queue_depth_matches_reference(name, latencies):
    n_fft, n_qrd, schedule, engine = LAUNCHES[name]
    port, ref, gmap, sh = _fft_mix(np.random.default_rng(13), n_fft, n_qrd)
    dcfg = DeviceConfig(n_sms=2, global_mem_depth=128, backend="cpu",
                        engine=engine, dispatch_latency=latencies[0],
                        queue_latency=latencies[1],
                        sm=SMConfig(shmem_depth=1024, imem_depth=1024,
                                    max_steps=200_000))
    t = launch(dcfg, programs=port, grid_map=gmap, shmem=sh, queue_depth=3,
               schedule=schedule)
    j = j_launch(_j_dcfg(dcfg), programs=ref, grid_map=gmap, shmem=sh,
                 queue_depth=3, schedule=schedule)
    _assert_same(t, j)
    if latencies == (0, 0):
        assert "host_dispatch" not in t.profile()
        return
    assert t.profile()["host_dispatch"] == {
        "queue_depth": 3, "dispatch_cycles": 100, "queue_cycles": 30,
        "latency_cycles": 130}
    base = launch(dataclasses.replace(dcfg, dispatch_latency=0,
                                      queue_latency=0), programs=port,
                  grid_map=gmap, shmem=sh, schedule=schedule)
    assert t.cycles == base.cycles + 130
    assert np.array_equal(t.timing.block_start, base.timing.block_start + 130)
    assert torch.equal(t.shmem, base.shmem)


def test_launch_option_validation_matches_reference():
    x = np.zeros(4, np.float32)
    prog = saxpy_grid_program(4, 4)
    for bad in (dict(dispatch_latency=-1), dict(queue_latency=-1)):
        with pytest.raises(ValueError, match="latency"):
            DeviceConfig(**bad)
        with pytest.raises(ValueError, match="latency"):
            JDeviceConfig(**bad)
    dcfg = DeviceConfig(n_sms=1, global_mem_depth=64, backend="cpu")
    buffers = {"x": x, "y": x, "z": x, "alpha": x[:1]}
    for kw, msg in ((dict(queue_depth=-1), "queue_depth"),
                    (dict(block_ids=[0, 1]), "block_ids has shape"),
                    (dict(block_ids=[-1]), "non-negative")):
        with pytest.raises(ValueError, match=msg):
            launch(dcfg, prog, grid=1, block=4, buffers=buffers, **kw)
        with pytest.raises(ValueError, match=msg):
            j_launch(_j_dcfg(dcfg), prog, grid=1, block=4, buffers=buffers,
                     **kw)


# ---------------------------------------------------------------------------
# launch(block_ids=)
# ---------------------------------------------------------------------------

def _saxpy_buffers(n, seed=3):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal(n).astype(np.float32),
            "y": rng.standard_normal(n).astype(np.float32),
            "z": np.zeros(n, np.float32),
            "alpha": np.asarray([1.5], np.float32)}


# BID 2 twice and 0 for block 2: the z slice of BID 1 is never written
SAXPY_BIDS = [2, 3, 0, 2]


@pytest.mark.parametrize("engine", ["step", "trace", "megakernel"])
def test_block_ids_match_reference(engine):
    buffers = _saxpy_buffers(256)
    dcfg = DeviceConfig(n_sms=2, global_mem_depth=1024, backend="cpu",
                        engine=engine, sm=SMConfig(max_steps=10_000))
    kw = dict(grid=4, block=64, buffers=buffers)
    prog = saxpy_grid_program(256, 64)
    t = launch(dcfg, prog, block_ids=SAXPY_BIDS, **kw)
    j = j_launch(_j_dcfg(dcfg), prog, block_ids=SAXPY_BIDS, **kw)
    assert t.engine == engine
    _assert_same(t, j)
    z = t.buffer("z").numpy()
    want = 1.5 * buffers["x"] + buffers["y"]
    for bid in (0, 2, 3):
        assert np.array_equal(z[64 * bid:64 * bid + 64],
                              want[64 * bid:64 * bid + 64])
    assert not z[64:128].any()


@pytest.mark.parametrize("engine", ["step", "trace", "megakernel"])
def test_block_ids_in_a_heterogeneous_grid_match_reference(engine):
    # two SAXPY programs (blocks of 64 and of 32 threads) over one image,
    # interleaved: on the trace and megakernel engines the grid runs in
    # merged waves, whose per-slot BIDs must be the caller's
    buffers = _saxpy_buffers(256, seed=5)
    dcfg = DeviceConfig(n_sms=2, global_mem_depth=1024, backend="cpu",
                        engine=engine, sm=SMConfig(max_steps=10_000))
    gmap = [0, 1, 1, 0, 1, 1]
    bids = [3, 6, 1, 0, 7, 2]
    kernels = [Kernel(saxpy_grid_program(256, 64), block=64),
               Kernel(saxpy_grid_program(256, 32), block=32)]
    kw = dict(grid_map=gmap, buffers=buffers, schedule="dynamic")
    t = launch(dcfg, programs=kernels, block_ids=bids, **kw)
    j = j_launch(_j_dcfg(dcfg), programs=[_j_kernel(k) for k in kernels],
                 block_ids=bids, **kw)
    assert t.engine == engine
    assert (t.trace_merge is not None) == (engine != "step")
    _assert_same(t, j)
    plain = launch(dcfg, programs=kernels, **kw)
    assert not torch.equal(plain.gmem, t.gmem)


# ---------------------------------------------------------------------------
# merge_schedules
# ---------------------------------------------------------------------------

def _schedule_view(s):
    return (s.mode, s.n_sms, s.makespan,
            *(np.asarray(a).tolist() for a in (
                s.block_sm, s.block_start, s.block_finish, s.block_busy,
                s.block_wait, s.block_gmem, s.wave_cycles, s.sm_idle)))


def _trace_pairs():
    progs = [(saxpy_grid_program(256, 64).words, 64),
             (fft_kernel(16).program.words, 8)]
    kw = dict(imem_depth=1024, max_steps=200_000)
    return [(j_cycles.program_trace(w, n, **kw),
             t_cycles.program_trace(w, n, **kw)) for w, n in progs]


@pytest.mark.parametrize("mode", ["static", "dynamic"])
@pytest.mark.parametrize("seed", range(3))
def test_merge_schedules_matches_reference(mode, seed):
    rng = np.random.default_rng(seed)
    pairs = _trace_pairs()
    n_dev, per_dev = int(rng.integers(2, 4)), int(rng.integers(1, 3))
    n_blocks = int(rng.integers(n_dev, 12))
    device_of = np.concatenate([np.arange(n_dev),
                                rng.integers(0, n_dev, n_blocks - n_dev)])
    rng.shuffle(device_of)
    pick = rng.integers(0, len(pairs), n_blocks)
    j_parts, t_parts = [], []
    for d in range(n_dev):
        bd = np.flatnonzero(device_of == d)
        start = int(rng.integers(0, 50))
        for side, parts in ((0, j_parts), (1, t_parts)):
            sched = (j_sched, t_sched)[side].schedule_blocks(
                [pairs[k][side] for k in pick[bd]], per_dev, mode,
                start_cycle=start)
            parts.append((sched, bd, d * per_dev))
    j = j_sched.merge_schedules(j_parts, n_dev * per_dev, n_blocks)
    t = merge_schedules(t_parts, n_dev * per_dev, n_blocks)
    assert _schedule_view(t) == _schedule_view(j)


def _merge_errors(sched_mod, parts_of):
    """The message of each of merge_schedules' five errors."""
    out = []
    for parts, n_blocks in parts_of(sched_mod):
        with pytest.raises(ValueError) as e:
            sched_mod.merge_schedules(parts, 4, n_blocks)
        out.append(str(e.value))
    return out


def test_merge_schedules_errors_match_reference():
    pairs = _trace_pairs()

    def parts_of(mod):
        side = 0 if mod is j_sched else 1
        two = [pairs[0][side], pairs[1][side]]
        st = mod.schedule_blocks(two, 2, "static")
        dy = mod.schedule_blocks(two, 2, "dynamic")
        return [([], 2),                                 # no parts
                ([(st, [0, 1], 0), (dy, [2, 3], 2)], 4),  # mixed modes
                ([(st, [0, 1, 2], 0)], 4),                # wrong length
                ([(st, [0, 1], 0), (st, [1, 2], 2)], 4),  # overlap
                ([(st, [0, 1], 0)], 4)]                   # unscheduled
    got = _merge_errors(t_sched, parts_of)
    assert got == _merge_errors(j_sched, parts_of)
    assert len(set(got)) == 5


# ---------------------------------------------------------------------------
# disassemble
# ---------------------------------------------------------------------------

# every opcode the assembler emits, in each operand form, with active-shape
# modifiers, snooped operands and predicates
DISASM_SOURCE = """
NOP
ADD.INT32 R1, R2, R3
SUB.UINT32 R4, R5, R6 {w8}
MUL.FP32 R7, R8, R9 {dhalf}
AND R1, R2, R3 {w4,dquarter}
OR R1, R2@1, R3@0
XOR R10, R11, R12 {w1,d1}
NOT R1, R2
LSL R1, R2, R3
LSR R1, R2, R3
LOD R2, (R1)+5
LOD R2, (R1)+0 {w8}
STO R2, (R3)+7
LOD R4, #-7
LOD.UINT32 R4, #16383
TDX R1
TDY R2 {dhalf}
DOT.FP32 R1, R2, R3
SUM.FP32 R1, R2, R3 {w8}
INVSQR.FP32 R5, R6
top:
INIT 4
LOOP top
JSR sub
JMP top
sub:
RTS
GLD R1, (R2)+3
GST R1, (R2)+9 {w4}
BID R3
PID R4
SETP.LT.INT32 R3, R1, R2
SETP.GE.FP32 R3, R1, R2
SETP.EQ.UINT32 R3, R1, R2
@R3 ADD.INT32 R4, R1, R1
@!R3 SELP R5, R1, R2
@R3 GST R4, (R1)+8
@!R2 LOD R4, (R1)+2
STOP
"""


def test_disassemble_matches_reference_over_every_opcode():
    prog = assemble(DISASM_SOURCE)
    assert np.array_equal(prog.words, j_assemble(DISASM_SOURCE).words)
    ops = {ins.op for ins in prog.instrs}
    assert ops == set(Op), set(Op) - ops
    texts = [disassemble(int(w)) for w in prog.words]
    assert texts == [j_disassemble(int(w)) for w in prog.words]
    # the data instructions' text re-assembles to the same words
    data = [i for i, ins in enumerate(prog.instrs)
            if ins.op not in (Op.JMP, Op.JSR, Op.LOOP)]
    again = assemble("\n".join(texts[i] for i in data))
    assert np.array_equal(again.words, prog.words[data])


# ---------------------------------------------------------------------------
# register_execute_backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["step", "trace"])
def test_register_execute_backend_matches_reference(engine):
    calls = []

    def per_op(*args):
        calls.append(args[0])
        return alu_plain(*args)

    name = f"per-op-alu-{engine}"
    assert register_execute_backend(name, device="cpu")(per_op) is per_op
    j_executor.register_execute_backend(name)(j_executor._inline_alu)
    port, ref, gmap, sh = _fft_mix(np.random.default_rng(21), 2, 1)
    dcfg = DeviceConfig(n_sms=2, global_mem_depth=128, backend=name,
                        engine=engine,
                        sm=SMConfig(shmem_depth=1024, imem_depth=1024,
                                    max_steps=200_000))
    t = launch(dcfg, programs=port, grid_map=gmap, shmem=sh)
    j = j_launch(_j_dcfg(dcfg, backend=name), programs=ref, grid_map=gmap,
                 shmem=sh)
    assert calls
    _assert_same(t, j)
    built_in = launch(dataclasses.replace(dcfg, backend="cpu"),
                      programs=port, grid_map=gmap, shmem=sh)
    for k in ("regs", "shmem", "gmem", "oob"):
        assert torch.equal(getattr(t, k), getattr(built_in, k)), k


# ---------------------------------------------------------------------------
# as_u32_image: a tensor stays on its device and is never aliased
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.int64])
@pytest.mark.parametrize("width", [8, 5])
def test_as_u32_image_never_aliases_its_input(dtype, width):
    src = torch.arange(2 * width, dtype=dtype).reshape(2, width)
    img = as_u32_image(src, 8)
    assert img.dtype == torch.int32 and img.shape == (2, 8)
    assert img.device == src.device
    assert img.untyped_storage().data_ptr() \
        != src.untyped_storage().data_ptr()
    want = as_u32_image(src.numpy(), 8)
    assert torch.equal(img, want)
    img.fill_(-1)
    assert torch.equal(src, torch.arange(2 * width, dtype=dtype).reshape(
        2, width))
    with pytest.raises(ValueError, match="exceeds depth"):
        as_u32_image(src, width - 1)
