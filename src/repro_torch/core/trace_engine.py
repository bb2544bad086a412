"""The trace and megakernel engines: a program lowered once, then run.

The eGPU ISA has no data-dependent control flow, so the sequence of
instructions a block issues is a static property of the program
(``cycles.program_trace``, exact). A program is lowered ONCE, on the
host, into a pre-decoded structure-of-arrays schedule: one row per
issued data instruction (NOP and control rows carry no data effect and
are compiled out; their cycle costs stay in the trace).

The trace engine (``compile_program`` / ``run_wave_trace``) runs that
schedule row by row through ``executor.make_data_handlers`` — the same
handlers the step engine dispatches into after its own decode, so the
two engines agree word for word — with no fetch, no decode and no
sequencer on the way.

The megakernel engine splits that schedule at the global-port rows
(GLD/GST serialize on the one device-wide port): each maximal run of
SM-local rows between them is a fused segment that runs as ONE launch of
the segment kernel with the wave's registers and shared memory resident
on chip; each global-port row runs by itself through the GLD/GST row
seam, one launch in place. The plan places each segment's barriers once
(``kernels.simt_step.segment_barriers``); its packed row table and the
barrier bits are uploaded to a device once and kept with the plan.

Cycle counters never come from execution: they are the static trace's
(``trace.static_cycles`` / ``cycles_by_class``), which the golden-cycle
suite pins.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .cycles import ProgramTrace, program_trace
from .executor import (
    DATA_SEL_OF_OP,
    FIELDS,
    FUSED_SELS,
    ExecBackend,
    FusedRow,
    _decode,
    exec_segment,
    make_data_handlers,
)
from .isa import NUM_CLASSES
from .machine import SMConfig
from ..kernels.simt_step import segment_barriers

ENGINES = ("step", "trace", "megakernel")

# the global port's data-switch branches (GLD/GST serialize on the one
# device-wide port)
_GLD_SEL, _GST_SEL = 8, 9

# "auto" only picks the megakernel engine for programs whose schedules it
# can unroll body-to-body; longer schedules fall back to the scanned trace
# engine (engine_fallback = "megakernel-unroll-cap"). An explicit
# engine="megakernel" ignores the cap.
MEGAKERNEL_UNROLL_CAP = 4096

# ...and only when there is enough fusible work: below this many
# residual (non-gmem) data rows in the LONGEST program of the launch,
# "auto" falls back to "step" (engine_fallback = "megakernel-too-small").
# Both thresholds are the reference's, kept for parity of engine choice.
MEGAKERNEL_MIN_FUSED_ROWS = 16


@dataclasses.dataclass(frozen=True)
class TraceSchedule:
    """One program lowered to a pre-decoded instruction schedule.

    ``cols[f]`` is the (n_steps,) int32 column for decoded field ``f`` —
    one row per *data* instruction of the issued trace. ``trace`` keeps
    the full issued trace for timing; ``by_class_base``/``by_class_gmem``
    pre-reduce its per-class cycle totals."""

    cfg: SMConfig
    trace: ProgramTrace
    cols: dict[str, np.ndarray]
    by_class_base: np.ndarray       # (NUM_CLASSES,) trace.cycles_by_class(1)
    by_class_gmem: np.ndarray       # (NUM_CLASSES,) gmem-only cycle rows
    rows: tuple                     # the rows as host-constant FusedRows

    @property
    def n_steps(self) -> int:
        return int(self.cols["sel"].shape[0])

    @property
    def halted(self) -> bool:
        return self.trace.halted

    @property
    def stores_gmem(self) -> bool:
        """Whether a row of the schedule is a GST, the one row that writes
        the global-memory image."""
        return bool((self.cols["sel"] == _GST_SEL).any())

    @property
    def table(self) -> np.ndarray:
        """(n_steps, len(FIELDS)) int32 row table."""
        return np.stack([self.cols[f] for f in FIELDS], axis=1)

    def cycles_by_class(self, wave_n: int) -> np.ndarray:
        """== ``trace.cycles_by_class(wave_n)`` (GMEM scaled by the wave
        width), from the precomputed reductions."""
        return self.by_class_base + (wave_n - 1) * self.by_class_gmem


@functools.lru_cache(maxsize=256)
def _compile_cached(words_key: tuple, cfg: SMConfig) -> TraceSchedule:
    trace = program_trace(np.asarray(words_key, np.int64), cfg.n_threads,
                          imem_depth=cfg.imem_depth, max_steps=cfg.max_steps)
    # data steps only: rows whose handler has an architectural data effect
    pcs = np.asarray([t.pc for t in trace.instrs
                      if DATA_SEL_OF_OP[int(t.op)] != 0], np.int64)
    # the wave packer bins on trace.data_steps; it must equal the rows
    # lowered here
    if pcs.size != trace.data_steps:
        raise AssertionError(
            "cycles.ProgramTrace.data_steps disagrees with DATA_SEL_OF_OP")
    # every data pc addresses a real program word (STOP padding is control)
    if pcs.size and pcs.max() >= len(words_key):
        raise AssertionError("data instruction issued from STOP-padded I-MEM")
    words = np.asarray(words_key, np.int64)[pcs] if pcs.size \
        else np.zeros((0,), np.int64)
    d = _decode(words & 0xFFFFFFFF, (words >> 32) & 0x3FFF)
    n_waves = cfg.n_waves
    depth_table = np.array(
        [n_waves, max(1, n_waves // 2), max(1, n_waves // 4), 1], np.int64)
    width_table = np.array([16, 8, 4, 1], np.int64)
    cols = dict(
        sel=DATA_SEL_OF_OP[d["opcode"]],
        opcode=d["opcode"], typ=d["typ"],
        rd=d["rd"], ra=d["ra"], rb=d["rb"],
        imm=d["imm"], x=d["x"], ext_a=d["ext_a"], ext_b=d["ext_b"],
        pen=d["pen"], preg=d["preg"], pneg=d["pneg"],
        act_waves=depth_table[d["depth"]],
        act_wthreads=width_table[d["width"]],
    )
    cols = {f: np.asarray(cols[f], np.int32) for f in FIELDS}
    by_base = np.asarray(trace.cycles_by_class(1), np.int64)
    by_gmem = np.zeros((NUM_CLASSES,), np.int64)
    for t in trace.instrs:
        if t.gmem:
            by_gmem[t.klass] += t.cycles
    table = np.stack([cols[f] for f in FIELDS], axis=1)
    return TraceSchedule(cfg=cfg, trace=trace, cols=cols,
                         by_class_base=by_base, by_class_gmem=by_gmem,
                         rows=tuple(FusedRow.from_fields(v) for v in table))


def compile_program(program, cfg: SMConfig) -> TraceSchedule:
    """Lower ``program`` (a Program or encoded word array) for ``cfg``;
    cached per ``(program words, SMConfig)``."""
    words = program.words if hasattr(program, "words") else program
    return _compile_cached(tuple(int(w) for w in words), cfg)


def _wave_index(x, device) -> torch.Tensor:
    """A wave's (n,) BID/PID vector as an int32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(x), dtype=torch.int32, device=device)


def _own(t: torch.Tensor) -> torch.Tensor:
    return t.clone(memory_format=torch.contiguous_format)


def owned_data(state, gmem: bool = True) -> tuple:
    """A wave's data state ``(regs, shmem, gmem, oob)`` for the step and
    trace engines: the tensors the row kernels write in place are copied
    once (contiguous), so a wave never writes a caller's tensors or the
    numpy arrays they may share. The image ``gmem`` is copied only where
    the wave's rows may store into it (``gmem=True``); a wave without a
    GST row reads the caller's image and passes it through."""
    image = _own(state.gmem) if gmem else state.gmem
    return _own(state.regs), _own(state.shmem), image, _own(state.oob)


def _static_counters(state, trace: ProgramTrace, by_class: np.ndarray):
    """The wave's counters from the static trace (the lockstep wave rule
    charges each member for the whole wave's port drain,
    ``trace.static_cycles``)."""
    n = state.regs.shape[0]
    return dict(halted=state.halted or trace.halted,
                steps=state.steps + trace.steps,
                cycles=state.cycles + trace.static_cycles(n),
                cycles_by_class=state.cycles_by_class + by_class)


def run_wave_trace(cfg: SMConfig, backend: ExecBackend,
                   sched: TraceSchedule, block_idx, prog_idx, state):
    """Run one homogeneous wave on the trace engine: every data row of the
    schedule through the shared execute stage, on the device the state
    lives on, over the wave's own copy of the data state (``state`` is not
    written). Counters come from the static trace, identical to the step
    engine's own count."""
    device = state.regs.device
    bidx = _wave_index(block_idx, device)
    pidx = _wave_index(prog_idx, device)
    s = owned_data(state, gmem=sched.stores_gmem)
    for row in sched.rows:
        s = make_data_handlers(cfg, backend, row, bidx, pidx)[row.sel](s)
    regs, shmem, gmem, oob = s
    n = state.regs.shape[0]
    return dataclasses.replace(
        state, regs=regs, shmem=shmem, gmem=gmem, oob=oob,
        **_static_counters(state, sched.trace, sched.cycles_by_class(n)))


# ---------------------------------------------------------------------------
# segment megakernels: fused runs between global-port accesses
# ---------------------------------------------------------------------------

_GMEM_SELS = (_GLD_SEL, _GST_SEL)


def _segment_items(rows) -> tuple:
    """Split a row sequence at global-port rows: ``("fused", (start,
    stop))`` is a run of schedule rows for one segment launch,
    ``("gmem", row)`` a serialized port row by itself."""
    items, start = [], None
    for i, r in enumerate(rows):
        if r.sel in _GMEM_SELS:
            if start is not None:
                items.append(("fused", (start, i)))
                start = None
            items.append(("gmem", r))
        else:
            if r.sel not in FUSED_SELS:
                raise AssertionError(f"row {i} has no data effect "
                                     f"(sel={r.sel})")
            if start is None:
                start = i
    if start is not None:
        items.append(("fused", (start, len(rows))))
    return tuple(items)


@dataclasses.dataclass(frozen=True)
class MegakernelPlan:
    """One program lowered to fused segments (megakernel engine unit).

    ``items`` is the ordered execution plan; ``sched`` keeps the
    underlying trace schedule, whose row table the fused items index, and
    the timing model's trace. ``barriers`` holds each fused item's
    ``segment_barriers`` bits at its rows of that table (0 at global-port
    rows). ``device_table`` and ``device_barriers`` upload the two to a
    device once and keep them with the plan."""

    key: tuple                 # program words
    cfg: SMConfig
    sched: TraceSchedule
    items: tuple
    barriers: np.ndarray       # (n_steps,) int32
    _tables: dict = dataclasses.field(default_factory=dict, compare=False,
                                      repr=False)

    @property
    def halted(self) -> bool:
        return self.sched.halted

    def _upload(self, name: str, host: np.ndarray, device) -> torch.Tensor:
        key = (name, str(device))
        if key not in self._tables:
            self._tables[key] = torch.from_numpy(
                np.ascontiguousarray(host)).to(device)
        return self._tables[key]

    def device_table(self, device: torch.device) -> torch.Tensor:
        return self._upload("table", self.sched.table, device)

    def device_barriers(self, device: torch.device) -> torch.Tensor:
        return self._upload("barriers", self.barriers, device)


@functools.lru_cache(maxsize=256)
def _megakernel_cached(words_key: tuple, cfg: SMConfig) -> MegakernelPlan:
    sched = _compile_cached(words_key, cfg)
    items = _segment_items(sched.rows)
    table = sched.table
    barriers = np.zeros((sched.n_steps,), np.int32)
    for kind, payload in items:
        if kind == "fused":
            start, stop = payload
            barriers[start:stop] = segment_barriers(table[start:stop])
    return MegakernelPlan(key=words_key, cfg=cfg, sched=sched, items=items,
                          barriers=barriers)


def compile_megakernel(program, cfg: SMConfig) -> MegakernelPlan:
    """Lower ``program`` to a fused-segment megakernel plan for ``cfg``
    (cached, sharing the schedule cache)."""
    words = program.words if hasattr(program, "words") else program
    return _megakernel_cached(tuple(int(w) for w in words), cfg)


def run_wave_megakernel(backend: ExecBackend, plan: MegakernelPlan,
                        block_idx, prog_idx, state):
    """Run one homogeneous wave: fused segments through the segment
    kernel, global-port rows through ``backend``'s GLD and GST row seam,
    on the device the state lives on. Counters come from the static
    trace.

    ``state`` is not written. A segment returns new tensors; a GLD row
    writes ``regs`` and ``oob`` in place and a GST row ``gmem`` and
    ``oob``, so the wave copies the image once if it holds a GST row, and
    ``regs`` and ``oob`` once if a global-port row comes before its first
    segment."""
    n = state.regs.shape[0]
    device = state.regs.device
    table = plan.device_table(device)
    barriers = plan.device_barriers(device)
    bidx = _wave_index(block_idx, device)
    pidx = _wave_index(prog_idx, device)
    regs, shmem, gmem, oob = state.regs, state.shmem, state.gmem, state.oob
    if plan.items and plan.items[0][0] == "gmem":
        regs, oob = _own(regs), _own(oob)
    if plan.sched.stores_gmem:
        gmem = _own(gmem)
    for kind, payload in plan.items:
        if kind == "fused":
            start, stop = payload
            regs, shmem, oob = exec_segment(
                plan.cfg, table[start:stop], bidx, pidx, regs, shmem, oob,
                barriers=barriers[start:stop])
        else:
            handler = make_data_handlers(plan.cfg, backend, payload, bidx,
                                         pidx)
            regs, shmem, gmem, oob = handler[payload.sel](
                (regs, shmem, gmem, oob))
    return dataclasses.replace(
        state, regs=regs, shmem=shmem, gmem=gmem, oob=oob,
        **_static_counters(state, plan.sched.trace,
                           plan.sched.cycles_by_class(n)))
