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

A heterogeneous grid (blocks of several programs) runs in merged waves
on both engines. ``compile_merged`` / ``run_wave_merged`` run each live
program slot's schedule row by row, slot by slot, on that slot's SMs,
split at each program's end so no padded row executes;
``compile_merged_megakernel`` / ``run_wave_merged_megakernel`` fuse each
slot's runs as its own plan does and order only the global-port rows,
by (schedule row, slot). ``merge_profile`` gives
``profile()["trace_merge"]``: the reference's padding counts and, on the
megakernel, the fold counts of the plan-time partial evaluator
(``executor.eval_segment_rows``).

Cycle counters never come from execution: they are the static trace's
(``trace.static_cycles`` / ``cycles_by_class``), which the golden-cycle
suite pins.

Schedules and plans are cached per process (``compile_cache_info`` /
``compile_cache_clear``) and, opt-in, on disk across processes
(``core.compile_cache``: the ``"lowering"`` and ``"megakernel"`` kinds).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import compile_cache, cycles
from .cycles import ProgramTrace, program_trace
from .executor import (
    DATA_SEL_OF_OP,
    FIELDS,
    FUSED_SELS,
    ExecBackend,
    FusedRow,
    FusedSegment,
    _decode,
    eval_segment_rows,
    exec_segment,
    make_data_handlers,
)
from .isa import NUM_CLASSES, Op
from .machine import MAX_THREADS, N_REGS, SMConfig
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


def _lower(words_key: tuple, cfg: SMConfig) -> tuple:
    """Walk and decode one program: its trace and the (n_steps,) int32
    column of each decoded field, one row per data instruction."""
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
    return trace, {f: np.asarray(cols[f], np.int32) for f in FIELDS}


def _lowering_is_plain(v) -> bool:
    """Whether a ``"lowering"`` entry has the current layout: the trace
    and every column of ``FIELDS``, int32, one row per data step."""
    if not (isinstance(v, dict) and set(v) == {"trace", "cols"}
            and cycles.trace_is_plain(v["trace"])
            and isinstance(v["cols"], dict)
            and set(FIELDS) <= set(v["cols"])):
        return False
    n = int((DATA_SEL_OF_OP[v["trace"][2][:, 0]] != 0).sum())
    return all(compile_cache.is_array(v["cols"][f], "int32", 1, n)
               for f in FIELDS)


@functools.lru_cache(maxsize=256)
def _compile_cached(words_key: tuple, cfg: SMConfig) -> TraceSchedule:
    # the tier behind the in-process LRU: the opt-in persistent compile
    # cache holds the trace and the decoded columns; the rows and the
    # per-class reductions are rebuilt from them
    ckey = compile_cache.key_for("lowering", words_key, cfg)
    payload = compile_cache.load(ckey, _lowering_is_plain)
    if payload is not None:
        trace = cycles.trace_from_plain(payload["trace"])
        cols = {f: payload["cols"][f] for f in FIELDS}
    else:
        trace, cols = _lower(words_key, cfg)
        compile_cache.store(ckey, {"trace": cycles.trace_to_plain(trace),
                                   "cols": cols})
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


def compile_cache_info():
    """The in-process schedule cache's ``lru_cache`` counters."""
    return _compile_cached.cache_info()


def compile_cache_clear() -> None:
    """Empty the in-process schedule, plan and merge caches (the
    persistent compile cache on disk is left as it is)."""
    _compile_cached.cache_clear()
    _merge_cached.cache_clear()
    _megakernel_cached.cache_clear()
    _merged_megakernel_cached.cache_clear()


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


def _partial_eval_items(items, rows, cfg: SMConfig, depth: int) -> tuple:
    """Run the plan-time partial evaluator over one program's item list:
    register-column constant state, from the zeroed registers every wave
    starts with, threaded through the items in execution order. Returns
    the ``executor.FusedSegment`` of each fused item, in order. A GLD row
    makes its destination runtime; GST only reads.

    The reference threads one such state per program slot through a
    merged plan; a slot's state sees only its own rows, so a merged plan
    takes each slot's segments from that program's own plan."""
    cols = [np.zeros(MAX_THREADS, np.uint32)] * N_REGS
    segments = []
    for kind, payload in items:
        if kind == "fused":
            start, stop = payload
            seg, cols = eval_segment_rows(cfg, rows[start:stop], cols, depth)
            segments.append(seg)
        elif payload.sel == _GLD_SEL:              # GLD: rd now runtime
            cols = list(cols)
            cols[payload.d["rd"]] = None
    return tuple(segments)


def _fusion_stats(items, segments) -> dict:
    """A plan's fusion counts, as ``profile()["trace_merge"]["fusion"]``
    reports them per wave."""
    return {
        "segments": len(segments),
        "fused_rows": sum(len(s.rows) for s in segments),
        "folded_rows": sum(s.n_folded for s in segments),
        "gmem_rows": sum(1 for it in items if it[0] == "gmem"),
        "max_fused_run": max((len(s.rows) for s in segments), default=0),
    }


@dataclasses.dataclass(frozen=True)
class MegakernelPlan:
    """One program lowered to fused segments (megakernel engine unit).

    ``items`` is the ordered execution plan; ``sched`` keeps the
    underlying trace schedule, whose row table the fused items index, and
    the timing model's trace. ``segments`` holds each fused item's
    partial evaluation (``executor.FusedSegment``), whose fold counts
    ``stats()`` reports. ``barriers`` holds each fused item's
    ``segment_barriers`` bits at its rows of that table (0 at global-port
    rows). ``device_table`` and ``device_barriers`` upload the two to a
    device once and keep them with the plan."""

    key: tuple                 # program words
    cfg: SMConfig
    sched: TraceSchedule
    items: tuple
    segments: tuple            # FusedSegment per fused item
    barriers: np.ndarray       # (n_steps,) int32
    _tables: dict = dataclasses.field(default_factory=dict, compare=False,
                                      repr=False)

    @property
    def halted(self) -> bool:
        return self.sched.halted

    def stats(self) -> dict:
        return _fusion_stats(self.items, self.segments)

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


def _plan_to_plain(sched: TraceSchedule, items, segments, barriers) -> tuple:
    """A plan's host parts as plain data for the compile cache: ``(spans,
    barriers, segments)``. ``spans`` is an (n_items, 3) int64 array of
    (0 fused / 1 global-port, start, stop) schedule rows; each segment is
    ``(residual, final_consts, n_folded)``, a residual op ``(kind, row,
    data, consts)`` naming its row by its index in the segment."""
    index = {id(r): i for i, r in enumerate(sched.rows)}
    spans = np.asarray([(0, *p) if kind == "fused"
                        else (1, index[id(p)], index[id(p)] + 1)
                        for kind, p in items], np.int64).reshape(-1, 3)
    segs = []
    for (kind, (start, _)), seg in zip(
            (it for it in items if it[0] == "fused"), segments):
        segs.append((tuple((k, index[id(row)] - start, data, consts)
                           for k, row, data, consts in seg.residual),
                     seg.final_consts, int(seg.n_folded)))
    return spans, barriers, tuple(segs)


def _consts_are_plain(consts) -> bool:
    return isinstance(consts, tuple) and all(
        compile_cache.is_record(c, 2) and isinstance(c[0], int)
        and 0 <= c[0] < N_REGS
        and compile_cache.is_array(c[1], "uint32", 1, MAX_THREADS)
        for c in consts)


def _residual_op_is_plain(op, n_rows: int) -> bool:
    is_array = compile_cache.is_array
    if not (compile_cache.is_record(op, 4) and isinstance(op[1], int)
            and 0 <= op[1] < n_rows and _consts_are_plain(op[3])):
        return False
    kind, data = op[0], op[2]
    if kind == "exec":
        return data is None
    if kind not in ("lod", "sto") or not compile_cache.is_record(data, 3) \
            or not isinstance(data[2], bool):
        return False
    if kind == "lod":
        return (is_array(data[0], "int32", 1, MAX_THREADS)
                and is_array(data[1], "bool", 1, MAX_THREADS))
    return (is_array(data[0], "int32", 1) and is_array(data[1], "int32", 1)
            and data[0].shape == data[1].shape)


def _plan_is_plain(v, n_steps: int) -> bool:
    """Whether a ``"megakernel"`` entry has the current layout for a
    schedule of ``n_steps`` rows."""
    is_array = compile_cache.is_array
    if not (compile_cache.is_record(v, 3) and is_array(v[0], "int64", 2)
            and v[0].shape[1] == 3 and is_array(v[1], "int32", 1, n_steps)
            and isinstance(v[2], tuple)):
        return False
    spans = v[0].tolist()
    fused = [(a, b) for k, a, b in spans if k == 0]
    if len(fused) != len(v[2]) or any(
            k not in (0, 1) or not 0 <= a < b <= n_steps for k, a, b in spans):
        return False
    return all(
        compile_cache.is_record(seg, 3) and isinstance(seg[0], tuple)
        and all(_residual_op_is_plain(op, b - a) for op in seg[0])
        and _consts_are_plain(seg[1]) and isinstance(seg[2], int)
        for (a, b), seg in zip(fused, v[2]))


def _plan_from_plain(v, sched: TraceSchedule) -> tuple:
    """``(items, segments, barriers)`` rebuilt over ``sched``'s rows."""
    spans, barriers, segs = v
    items = tuple(("fused", (a, b)) if k == 0 else ("gmem", sched.rows[a])
                  for k, a, b in spans.tolist())
    fused = [p for kind, p in items if kind == "fused"]
    segments = []
    for (a, b), (residual, final_consts, n_folded) in zip(fused, segs):
        rows = sched.rows[a:b]
        segments.append(FusedSegment(
            rows=rows,
            residual=tuple((kind, rows[i], data, consts)
                           for kind, i, data, consts in residual),
            final_consts=final_consts, n_folded=n_folded))
    return items, tuple(segments), barriers


@functools.lru_cache(maxsize=256)
def _megakernel_cached(words_key: tuple, cfg: SMConfig) -> MegakernelPlan:
    sched = _compile_cached(words_key, cfg)
    # the tier behind the in-process LRU: the plan's host parts (its
    # items, barriers and partial evaluation) in the persistent compile
    # cache; its device tables are uploaded anew in each process
    ckey = compile_cache.key_for("megakernel", words_key, cfg,
                                 engine="megakernel")
    payload = compile_cache.load(
        ckey, functools.partial(_plan_is_plain, n_steps=sched.n_steps))
    if payload is not None:
        items, segments, barriers = _plan_from_plain(payload, sched)
    else:
        items = _segment_items(sched.rows)
        table = sched.table
        barriers = np.zeros((sched.n_steps,), np.int32)
        for kind, payload in items:
            if kind == "fused":
                start, stop = payload
                barriers[start:stop] = segment_barriers(table[start:stop])
        segments = _partial_eval_items(items, sched.rows, cfg,
                                       cfg.shmem_depth)
        compile_cache.store(ckey, _plan_to_plain(sched, items, segments,
                                                 barriers))
    return MegakernelPlan(key=words_key, cfg=cfg, sched=sched, items=items,
                          segments=segments, barriers=barriers)


def compile_megakernel(program, cfg: SMConfig) -> MegakernelPlan:
    """Lower ``program`` to a fused-segment megakernel plan for ``cfg``
    (cached, sharing the schedule cache)."""
    words = program.words if hasattr(program, "words") else program
    return _megakernel_cached(tuple(int(w) for w in words), cfg)


def run_wave_megakernel(backend: ExecBackend, plan: MegakernelPlan,
                        block_idx, prog_idx, state, *, zeroed: bool = False):
    """Run one homogeneous wave: fused segments through the segment
    kernel, global-port rows through ``backend``'s GLD and GST row seam,
    on the device the state lives on. Counters come from the static
    trace.

    ``zeroed=True`` says the wave starts from ``init_device_state``'s
    zeroed registers (``device.launch`` says so for every wave it runs);
    then a backend that folds constants runs each segment's partial
    evaluation (``executor.apply_segment_residual``). Any other wave runs
    the raw rows.

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
    segments = iter(plan.segments)
    for kind, payload in plan.items:
        if kind == "fused":
            start, stop = payload
            seg = next(segments)
            regs, shmem, oob = exec_segment(
                plan.cfg, table[start:stop], bidx, pidx, regs, shmem, oob,
                barriers=barriers[start:stop], backend=backend,
                seg=seg if zeroed else None)
        else:
            handler = make_data_handlers(plan.cfg, backend, payload, bidx,
                                         pidx)
            regs, shmem, gmem, oob = handler[payload.sel](
                (regs, shmem, gmem, oob))
    return dataclasses.replace(
        state, regs=regs, shmem=shmem, gmem=gmem, oob=oob,
        **_static_counters(state, plan.sched.trace,
                           plan.sched.cycles_by_class(n)))


# ---------------------------------------------------------------------------
# heterogeneous waves: several programs' blocks in one wave
# ---------------------------------------------------------------------------
#
# A merged wave holds blocks of several programs, ordered slot-major:
# ``counts[k]`` consecutive SMs run program slot ``k``. At the start of a
# wave each slot's registers, shared memory and oob flags are copied once
# into tensors of its own (contiguous, at offset 0), the slots share the
# one global-memory image (copied once if a slot's rows store into it),
# and the slots are concatenated at the end of the wave. Every launch
# runs on one stream, in the order the plan gives: the rows of different
# slots touch disjoint per-SM state, and the global port's rows keep the
# reference's (schedule row, slot) order.

def _reads_wave_index(row: FusedRow) -> bool:
    """Whether the row reads the wave's BID/PID vectors (the one handler
    input that changes from wave to wave)."""
    return row.sel == 5 and row.d["opcode"] in (int(Op.BID), int(Op.PID))


def _slot_data(regs, shmem, oob, offs) -> list:
    """Each slot's own ``[regs, shmem, oob]``: copies of its rows of the
    wave's state."""
    return [[_own(t[lo:hi]) for t in (regs, shmem, oob)]
            for lo, hi in zip(offs[:-1], offs[1:])]


def _slot_index(block_idx, prog_idx, offs, device) -> list:
    """Each slot's own ``(bidx, pidx)``: copies of its SMs' BID/PID."""
    bidx = _wave_index(block_idx, device)
    pidx = _wave_index(prog_idx, device)
    return [(_own(bidx[lo:hi]), _own(pidx[lo:hi]))
            for lo, hi in zip(offs[:-1], offs[1:])]


def _join_slots(slots, gmem) -> tuple:
    """The wave's ``(regs, shmem, gmem, oob)`` from its slots' data."""
    regs, shmem, oob = (torch.cat([s[i] for s in slots]) for i in range(3))
    return regs, shmem, gmem, oob


def _slot_offsets(counts) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class MergedTraceSchedule:
    """Several programs' schedules merged for one heterogeneous wave.

    The reference stacks the schedules into one scan padded to the
    longest participant. Here each scan segment ``(start, end, live
    slots)`` runs rows ``start..end`` of every live slot, row by row and
    slot by slot; the schedule is split at each program's end, so the
    padded rows of a finished program are never executed."""

    cfgs: tuple[SMConfig, ...]          # per program slot
    parts: tuple[TraceSchedule, ...]    # the merged per-program schedules
    segments: tuple[tuple[int, int, tuple[int, ...]], ...]
    _handlers: dict = dataclasses.field(default_factory=dict, compare=False,
                                        repr=False)

    @property
    def n_steps(self) -> int:
        return max(p.n_steps for p in self.parts)

    @property
    def n_programs(self) -> int:
        return len(self.parts)

    @property
    def halted(self) -> bool:
        return all(p.halted for p in self.parts)

    @property
    def stores_gmem(self) -> bool:
        return any(p.stores_gmem for p in self.parts)

    def padded_steps(self, slot_idx) -> int:
        """Scan rows during which a wave member's program is already
        finished, for a wave running the slots in ``slot_idx``: the
        merge's padding overhead, as the reference counts it."""
        return sum(self.n_steps - self.parts[int(s)].n_steps
                   for s in slot_idx)

    def handlers(self, backend: ExecBackend, k: int) -> list:
        """Slot ``k``'s handler of each row, built once per backend (None
        for a BID/PID row, whose handler takes the wave's indices)."""
        key = (backend, k)
        if key not in self._handlers:
            cfg = self.cfgs[k]
            self._handlers[key] = [
                None if _reads_wave_index(r) else make_data_handlers(
                    cfg, backend, r, None, None,
                    shmem_depth=cfg.shmem_depth)[r.sel]
                for r in self.parts[k].rows]
        return self._handlers[key]


def merge_profile(per_wave: list, policy: str) -> dict:
    """Aggregate the per-wave merge records into the
    ``LaunchResult.profile()["trace_merge"]`` dict.

    ``per_wave`` entries carry each wave's ``scan_steps`` (merged
    schedule rows), ``width`` (members) and ``padded_steps`` (rows of
    members shorter than the wave's longest participant). ``policy`` is
    the resolved wave-packing policy. ``pad_overhead_total`` is the sum
    of the per-wave ``padded_steps``; ``pad_overhead`` that total as a
    fraction of all scheduled scan rows. Megakernel waves also carry
    fusion counts, summed (and their longest run taken) launch-wide."""
    scanned = sum(w["scan_steps"] * w["width"] for w in per_wave)
    padded = sum(w["padded_steps"] for w in per_wave)
    out = {
        "policy": policy,
        "n_waves": len(per_wave),
        "scan_steps": scanned,
        "pad_overhead_total": padded,
        "pad_overhead": (padded / scanned) if scanned else 0.0,
        "per_wave": per_wave,
    }
    fus = [w["fusion"] for w in per_wave if "fusion" in w]
    if fus:
        out["fusion"] = {
            "segments": sum(f["segments"] for f in fus),
            "fused_rows": sum(f["fused_rows"] for f in fus),
            "folded_rows": sum(f["folded_rows"] for f in fus),
            "gmem_rows": sum(f["gmem_rows"] for f in fus),
            "max_fused_run": max(f["max_fused_run"] for f in fus),
        }
    return out


def _program_keys(programs) -> tuple:
    return tuple(tuple(int(w) for w in (p.words if hasattr(p, "words")
                                        else p))
                 for p in programs)


@functools.lru_cache(maxsize=256)
def _merge_cached(keys: tuple, cfgs: tuple) -> MergedTraceSchedule:
    parts = tuple(_compile_cached(k, c) for k, c in zip(keys, cfgs))
    bounds = sorted({p.n_steps for p in parts} | {0})
    segments = tuple(
        (a, b, tuple(k for k, p in enumerate(parts) if p.n_steps >= b))
        for a, b in zip(bounds[:-1], bounds[1:]))
    return MergedTraceSchedule(cfgs=cfgs, parts=parts, segments=segments)


def compile_merged(programs, cfgs) -> MergedTraceSchedule:
    """Merge the schedules of ``programs`` (Programs or word arrays, one
    per ``SMConfig`` in ``cfgs``, in slot order) for heterogeneous waves;
    cached, sharing ``compile_program``'s schedules."""
    return _merge_cached(_program_keys(programs), tuple(cfgs))


def run_wave_merged(backend: ExecBackend, msched: MergedTraceSchedule,
                    counts, block_idx, prog_idx, regs, shmem, gmem, oob):
    """Run one heterogeneous wave on the trace engine. Wave members are
    ordered slot-major (``counts[k]`` SMs per slot); ``block_idx``/
    ``prog_idx`` carry each SM's program-local BID and its PID.
    ``shmem`` has the device's depth; each slot bounds its LOD/STO
    addresses at its own ``cfg.shmem_depth``. At each row of a scan
    segment every live slot dispatches its own row, in slot order, on its
    own SMs. The inputs are not written; returns the new ``(regs, shmem,
    gmem, oob)``."""
    offs = _slot_offsets(counts)
    slots = _slot_data(regs, shmem, oob, offs)
    index = _slot_index(block_idx, prog_idx, offs, regs.device)
    if msched.stores_gmem:
        gmem = _own(gmem)
    handlers = [msched.handlers(backend, k) for k in range(len(slots))]
    for a, b, live in msched.segments:
        for i in range(a, b):
            for k in live:
                h = handlers[k][i]
                if h is None:
                    cfg, row = msched.cfgs[k], msched.parts[k].rows[i]
                    h = make_data_handlers(
                        cfg, backend, row, *index[k],
                        shmem_depth=cfg.shmem_depth)[row.sel]
                r, s, o = slots[k]
                r, s, gmem, o = h((r, s, gmem, o))
                slots[k] = [r, s, o]
    return _join_slots(slots, gmem)


@dataclasses.dataclass(frozen=True)
class MergedMegakernelPlan:
    """A heterogeneous wave's fused-segment plan.

    There is no padding: each slot's rows fuse independently, exactly as
    that program's own ``MegakernelPlan`` fuses them (``plans``), and
    only the global-port rows take a global order: ``(schedule row,
    slot)``, the merged scan's dispatch order. ``items`` are
    ``("fused", k, (start, stop))`` (rows of slot ``k``'s table) and
    ``("gmem", k, row)``."""

    keys: tuple                # per-slot program words
    cfgs: tuple[SMConfig, ...]
    plans: tuple[MegakernelPlan, ...]
    items: tuple
    segments: tuple            # FusedSegment per fused item
    _handlers: dict = dataclasses.field(default_factory=dict, compare=False,
                                        repr=False)

    @property
    def halted(self) -> bool:
        return all(p.halted for p in self.plans)

    @property
    def n_steps(self) -> int:
        """The longest participant's schedule (the merged scan's row
        count, kept for the profile; no padded row executes)."""
        return max((p.sched.n_steps for p in self.plans), default=0)

    @property
    def stores_gmem(self) -> bool:
        return any(p.sched.stores_gmem for p in self.plans)

    def stats(self) -> dict:
        return _fusion_stats(self.items, self.segments)

    def gmem_handlers(self, backend: ExecBackend) -> list:
        """The handler of each global-port item (None at fused items),
        built once per backend."""
        if backend not in self._handlers:
            self._handlers[backend] = [
                make_data_handlers(
                    self.cfgs[k], backend, p, None, None,
                    shmem_depth=self.cfgs[k].shmem_depth)[p.sel]
                if kind == "gmem" else None
                for kind, k, p in self.items]
        return self._handlers[backend]


@functools.lru_cache(maxsize=256)
def _merged_megakernel_cached(keys: tuple, cfgs: tuple
                              ) -> MergedMegakernelPlan:
    plans = tuple(_megakernel_cached(k, c) for k, c in zip(keys, cfgs))
    rows = [p.sched.rows for p in plans]
    # the global-port rows drain in the merged scan's order, (schedule
    # row, slot); between them, different slots' rows touch disjoint
    # per-SM state and commute, so each slot's run fuses up to its next
    # global-port row, as in its own plan
    events = sorted((i, k) for k, rs in enumerate(rows)
                    for i, r in enumerate(rs) if r.sel in _GMEM_SELS)
    cursor = [0] * len(plans)
    items = []
    for i, k in events:
        if cursor[k] < i:
            items.append(("fused", k, (cursor[k], i)))
        items.append(("gmem", k, rows[k][i]))
        cursor[k] = i + 1
    for k, rs in enumerate(rows):
        if cursor[k] < len(rs):
            items.append(("fused", k, (cursor[k], len(rs))))
    seg_of = [dict(zip((p for kind, p in plan.items if kind == "fused"),
                       plan.segments)) for plan in plans]
    segments = tuple(seg_of[k][p] for kind, k, p in items if kind == "fused")
    return MergedMegakernelPlan(keys=keys, cfgs=cfgs, plans=plans,
                                items=tuple(items), segments=segments)


def compile_merged_megakernel(programs, cfgs) -> MergedMegakernelPlan:
    """Megakernel counterpart of ``compile_merged``: fuse each slot's
    segments, ordering only the global-port rows across slots."""
    return _merged_megakernel_cached(_program_keys(programs), tuple(cfgs))


def run_wave_merged_megakernel(backend: ExecBackend,
                               mplan: MergedMegakernelPlan, counts,
                               block_idx, prog_idx, regs, shmem, gmem, oob,
                               *, zeroed: bool = False):
    """Run one heterogeneous wave on the megakernel engine, with the
    member order of ``run_wave_merged``. A fused item of slot ``k`` is
    one segment launch on slot ``k``'s SMs, with its program's row table
    and barrier bits (uploaded once per device, kept with its plan); a
    global-port item runs the GLD or GST row seam on the same SMs.
    ``zeroed`` is ``run_wave_megakernel``'s: only a wave that starts from
    zeroed registers runs its segments' partial evaluation, on a backend
    that folds constants. The inputs are not written; returns the new
    ``(regs, shmem, gmem, oob)``."""
    device = regs.device
    offs = _slot_offsets(counts)
    slots = _slot_data(regs, shmem, oob, offs)
    index = _slot_index(block_idx, prog_idx, offs, device)
    tables = [(p.device_table(device), p.device_barriers(device))
              for p in mplan.plans]
    if mplan.stores_gmem:
        gmem = _own(gmem)
    handlers = mplan.gmem_handlers(backend)
    segments = iter(mplan.segments)
    for h, (kind, k, payload) in zip(handlers, mplan.items):
        r, s, o = slots[k]
        if kind == "fused":
            start, stop = payload
            table, barriers = tables[k]
            seg = next(segments)
            r, s, o = exec_segment(
                mplan.cfgs[k], table[start:stop], *index[k], r, s, o,
                shmem_depth=mplan.cfgs[k].shmem_depth,
                barriers=barriers[start:stop], backend=backend,
                seg=seg if zeroed else None)
        else:
            r, s, gmem, o = h((r, s, gmem, o))
        slots[k] = [r, s, o]
    return _join_slots(slots, gmem)
