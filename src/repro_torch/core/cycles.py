"""Sequencer cycle-cost model (paper §III.A / §III.C).

The eGPU sequencer issues one instruction to the SPs as a sequence of
wavefronts. Costs:

  * FP/INT operation .... one cycle per active wavefront (16 SPs issue one
    wavefront per clock).
  * LOD (indexed) ....... one clock per FOUR threads: the shared memory has
    4 read ports feeding 16 SPs in a 4-phase sequence.
  * STO (indexed) ....... one clock per thread: single write port, 16-phase
    writeback per wavefront. This is the bandwidth bottleneck the flexible
    ISA exists to mitigate.
  * LOD #imm ............ one cycle per active wavefront (broadcast through
    the SP write port).
  * DOT/SUM ............. one cycle per active wavefront (the dot-product
    unit consumes a full wavefront per clock, writing lane 0).
  * INVSQR .............. one cycle (single-lane SFU).
  * TDx/TDy ............. one cycle per active wavefront.
  * control ............. single cycle (zero-overhead loops: INIT and LOOP
    are one cycle each; JMP/JSR/RTS/STOP likewise).
  * NOP ................. one cycle.

The flexible Variable field scales "active": width w in {16,8,4,1} threads,
depth d in {full, half, quarter, single} wavefronts. Active wavefronts =
d(block), active threads = wavefronts * w. A full 512-thread block therefore
pays 32 cycles for an op, 128 for a load, 512 for a store — and a
{w1,d1}-masked store pays exactly 1 (paper: "the norm writeback only
requires a single clock cycle").

Multi-SM device extension (GLD/GST): the global-memory segment lives
outside the SMs, reached over the sector interconnect through a SINGLE
read port and a SINGLE write port shared by every SM in the packed sector
(the same single-port discipline as the shared-memory write path, but now
device-wide). A global access occupies the port for one cycle per active
thread. Under the *static wave* schedule SMs execute in lockstep, so every
SM's sequencer is held for the full serialized drain:
``n_sms * active_threads`` cycles (``instr_cycles(..., n_sms=...)``).
Under the *dynamic* schedule (``core.scheduler``) each SM's sequencer is
occupied only for its own ``active_threads`` access; queueing behind other
SMs shows up as per-SM port-wait time in the scheduler simulation instead
of an inflated instruction cost.

Predication (SIMT divergence)
-----------------------------
Predicated instructions (``@Rp``/``@!Rp``, plus SETP/SELP themselves)
change WHAT a lane writes, never WHEN the sequencer issues: a masked-off
lane still occupies its issue/drain slot as a bubble — the SP pipelines
and the shared/global port phase sequences are clocked by the sequencer
regardless of the per-lane write enable (the FPGA datapath has no
lane-skip). So ``instr_cycles`` is mask-independent, the instruction
stream stays static, and every trace/schedule/packing/NUMA number below
is exact for divergent programs too. SETP/SELP are wavefront-paced ALU
ops (the default arm).

Static program traces
---------------------
The eGPU ISA has no data-dependent control flow — JMP/JSR/LOOP/INIT/RTS
targets and trip counts are immediates, STOP is unconditional (predication
gates lane *writes*, not the sequencer: see above) — so the
sequence of instructions a sequencer issues (and hence the block's cycle
cost) is a *static* property of the program. ``program_trace`` walks a
program with a host-side sequencer (the same pc/loop-stack/return-stack
semantics as ``device._device_step``, pinned together by
``tests/test_device.py`` and ``tests/test_scheduler.py``) and returns the
issued-instruction trace with per-instruction cycle costs. The device
layer's block scheduler consumes these traces for per-SM timing.
"""
from __future__ import annotations

import dataclasses
import functools

from .isa import (
    Depth,
    Instr,
    NUM_CLASSES,
    Op,
    Width,
    WIDTH_THREADS,
    instr_class,
)
from .machine import LOOP_STACK_DEPTH, RET_STACK_DEPTH


def active_shape(width: Width, depth: Depth, n_threads: int) -> tuple[int, int]:
    """(active_wavefronts, active_threads_per_wavefront)."""
    n_waves = max(1, (n_threads + 15) // 16)
    waves = {Depth.FULL: n_waves,
             Depth.HALF: max(1, n_waves // 2),
             Depth.QUARTER: max(1, n_waves // 4),
             Depth.SINGLE: 1}[depth]
    return waves, WIDTH_THREADS[width]


def instr_cycles(ins: Instr, n_threads: int, n_sms: int = 1) -> int:
    """Sequencer occupancy of one instruction.

    ``n_sms`` models packed-sector contention: SMs executing in lockstep
    share the single global-memory port, so GLD/GST serialize across SMs.
    All other instruction classes use per-SM resources and are unaffected.

    This is the host-side statement of the cost model; the traced
    equivalent lives in ``device._device_step`` (it cannot call back into
    Python on decoded fields). ``tests/test_device.py`` pins the two
    together per instruction class.
    """
    waves, wthreads = active_shape(ins.width, ins.depth, n_threads)
    threads = waves * wthreads
    op = ins.op
    if op in (Op.NOP, Op.JMP, Op.JSR, Op.RTS, Op.LOOP, Op.INIT, Op.STOP,
              Op.INVSQR):
        return 1
    if op == Op.LOD:
        return max(1, (threads + 3) // 4)   # 4 read ports
    if op == Op.STO:
        return threads                       # 1 write port
    if op in (Op.GLD, Op.GST):
        return threads * max(1, n_sms)       # 1 global port, device-wide
    # everything else is wavefront-paced: ALU, LODI, TDx/TDy/BID/PID,
    # DOT, SUM
    return waves


# ---------------------------------------------------------------------------
# static program traces (the host-side per-SM sequencer)
# ---------------------------------------------------------------------------

# ops with NO architectural data effect (sequencer bookkeeping only);
# the complement is exactly the ops executor.DATA_SEL_OF_OP dispatches
# to a data handler — trace_engine._compile_cached asserts the two
# definitions agree on every lowered program
_SEQUENCER_ONLY = frozenset(
    (Op.NOP, Op.JMP, Op.JSR, Op.RTS, Op.LOOP, Op.INIT, Op.STOP))


@dataclasses.dataclass(frozen=True)
class TraceInstr:
    """One issued instruction in a block's static trace."""

    op: Op
    klass: int        # profile class (isa.CLASS_NAMES row)
    cycles: int       # sequencer occupancy, n_sms=1 (= port occupancy
                      # for GLD/GST: one word per cycle)
    gmem: bool        # goes through the device-wide global-memory port
    pc: int = 0       # I-MEM address issued from (lets the trace engine
                      # re-read the full 40-bit word at lowering time)


@dataclasses.dataclass(frozen=True)
class ProgramTrace:
    """The full issued-instruction trace of one thread block.

    Exact — not an approximation — because the ISA has no data-dependent
    control flow: every block running this program at this ``n_threads``
    issues exactly this sequence.
    """

    instrs: tuple[TraceInstr, ...]
    halted: bool                    # reached STOP (vs. fuel / pc runaway)
    n_threads: int

    @property
    def steps(self) -> int:
        return len(self.instrs)

    @functools.cached_property
    def cycles(self) -> int:
        """Busy cycles of the issuing sequencer (gmem at port occupancy)."""
        return sum(t.cycles for t in self.instrs)

    @functools.cached_property
    def gmem_cycles(self) -> int:
        """Cycles spent occupying the global-memory port."""
        return sum(t.cycles for t in self.instrs if t.gmem)

    @functools.cached_property
    def data_steps(self) -> int:
        """Issued instructions with an architectural data effect — the
        rows of the trace engine's pre-decoded schedule
        (``TraceSchedule.n_steps`` pins the two equal), and therefore
        the schedule length the wave packer bins on. NOP and control
        instructions are sequencer-only: the trace engine compiles them
        out, so they contribute no scan rows and no merge padding."""
        return sum(1 for t in self.instrs if t.op not in _SEQUENCER_ONLY)

    def static_cycles(self, wave_n: int) -> int:
        """Cycle cost in a HOMOGENEOUS lockstep wave: ``wave_n`` SMs issue
        each global access simultaneously and the single port serializes
        them, so every sequencer is held ``wave_n * threads`` per access.

        This is the special case of the general wave rule (every block's
        accesses drain behind every other wave member's:
        ``cycles + other_gmem``, see ``scheduler._schedule_static``) for
        ``wave_n`` identical traces.
        """
        return self.cycles + (wave_n - 1) * self.gmem_cycles

    def cycles_by_class(self, wave_n: int = 1) -> list[int]:
        """Per-class cycle totals (GMEM scaled by the wave width)."""
        by = [0] * NUM_CLASSES
        for t in self.instrs:
            by[t.klass] += t.cycles * (wave_n if t.gmem else 1)
        return by


def _trace_walk(words: tuple[int, ...], n_threads: int, imem_depth: int,
                max_steps: int) -> ProgramTrace:
    decoded = [Instr.decode(w) for w in words]
    stop = Instr(op=Op.STOP)                 # pack_imem pads I-MEM with STOP
    ret_stack = [0] * RET_STACK_DEPTH
    loop_ctr = [0] * LOOP_STACK_DEPTH
    ret_sp = loop_sp = 0
    pc = steps = 0
    halted = False
    out: list[TraceInstr] = []

    def clip(i: int, depth: int) -> int:
        return min(max(i, 0), depth - 1)

    while not halted and steps < max_steps and 0 <= pc < imem_depth:
        ins = decoded[pc] if pc < len(decoded) else stop
        out.append(TraceInstr(
            op=ins.op, klass=instr_class(ins.op, ins.typ),
            cycles=instr_cycles(ins, n_threads),
            gmem=ins.op in (Op.GLD, Op.GST), pc=pc))
        steps += 1
        op = ins.op
        # mirror device._device_step's h_ctl exactly (incl. index clipping)
        if op == Op.JMP:
            pc = ins.imm
        elif op == Op.JSR:
            ret_stack[clip(ret_sp, RET_STACK_DEPTH)] = pc + 1
            ret_sp += 1
            pc = ins.imm
        elif op == Op.RTS:
            pc = ret_stack[clip(ret_sp - 1, RET_STACK_DEPTH)]
            ret_sp -= 1
        elif op == Op.LOOP:
            lsp = clip(loop_sp - 1, LOOP_STACK_DEPTH)
            top = loop_ctr[lsp]
            loop_ctr[lsp] = top - 1
            if top > 1:
                pc = ins.imm
            else:
                pc += 1
                loop_sp -= 1
        elif op == Op.INIT:
            loop_ctr[clip(loop_sp, LOOP_STACK_DEPTH)] = ins.imm
            loop_sp += 1
            pc += 1
        elif op == Op.STOP:
            halted = True
            pc += 1
        else:
            pc += 1
    return ProgramTrace(instrs=tuple(out), halted=halted,
                        n_threads=n_threads)


def trace_to_plain(tr: ProgramTrace) -> tuple:
    """A trace as plain data for the compile cache: ``(halted, n_threads,
    instrs)``, ``instrs`` an (n, 5) int64 array of (op, klass, cycles,
    gmem, pc) rows."""
    import numpy as np

    rows = np.asarray([(int(t.op), t.klass, t.cycles, int(t.gmem), t.pc)
                       for t in tr.instrs], np.int64).reshape(-1, 5)
    return (bool(tr.halted), int(tr.n_threads), rows)


def trace_is_plain(v) -> bool:
    """Whether ``v`` has ``trace_to_plain``'s layout."""
    from . import compile_cache as cc

    return (cc.is_record(v, 3) and isinstance(v[0], bool)
            and isinstance(v[1], int) and cc.is_array(v[2], "int64", 2)
            and v[2].shape[1] == 5)


def trace_from_plain(v) -> ProgramTrace:
    halted, n_threads, rows = v
    return ProgramTrace(
        instrs=tuple(TraceInstr(op=Op(int(op)), klass=int(k), cycles=int(c),
                                gmem=bool(g), pc=int(pc))
                     for op, k, c, g, pc in rows.tolist()),
        halted=halted, n_threads=n_threads)


@functools.lru_cache(maxsize=256)
def _trace_cached(words: tuple[int, ...], n_threads: int, imem_depth: int,
                  max_steps: int) -> ProgramTrace:
    # the tier behind the in-process LRU: the opt-in persistent compile
    # cache (core.compile_cache), so a fresh process loads the walk instead
    # of re-sequencing the program; a bad entry loads as None (a miss) and
    # is rewritten below
    from . import compile_cache

    ckey = compile_cache.key_for(
        "trace", words, (n_threads, imem_depth, max_steps))
    hit = compile_cache.load(ckey, trace_is_plain)
    if hit is not None:
        return trace_from_plain(hit)
    tr = _trace_walk(words, n_threads, imem_depth, max_steps)
    compile_cache.store(ckey, trace_to_plain(tr))
    return tr


def program_trace(program, n_threads: int, *, imem_depth: int = 512,
                  max_steps: int = 100_000) -> ProgramTrace:
    """Statically trace one block's execution of ``program``.

    ``program`` is an assembled ``Program`` or an array of encoded 40-bit
    words. The walk reproduces the device sequencer (STOP-padded I-MEM,
    clipped loop/return stacks, fuel limit), so ``trace.cycles`` equals the
    cycles a 1-SM wave reports and ``trace.static_cycles(n)`` equals an
    ``n``-block lockstep wave's — ``tests/test_scheduler.py`` pins both.
    """
    words = program.words if hasattr(program, "words") else program
    key = tuple(int(w) for w in words)
    return _trace_cached(key, int(n_threads), int(imem_depth),
                         int(max_steps))
