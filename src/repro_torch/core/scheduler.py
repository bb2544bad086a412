"""Block schedulers for the multi-SM device: static waves vs dynamic queue.

The scalable eGPU follow-up (arXiv 2401.04261) makes dynamic block dispatch
across SMs its headline feature: instead of launching blocks in lockstep
waves, every SM runs its own sequencer and *pulls* the next ready block
from a device-level work queue the moment it retires its current one. This
module models both disciplines over the static per-block instruction
traces of ``cycles.program_trace`` (exact, because the ISA has no
data-dependent control flow):

``static``
    The lockstep wave schedule: blocks ``[w*n_sms, (w+1)*n_sms)`` issue in
    lockstep; a wave ends when its slowest block retires, and every global
    access holds all ``wave_n`` sequencers for the serialized port drain
    (``trace.static_cycles(wave_n)``). For a homogeneous launch this
    reproduces the lockstep device simulation cycle for cycle.

``dynamic``
    Work-queue dispatch with per-SM sequencers. Blocks are queued in grid
    order (or by descending ``Kernel.priority``, FIFO within a priority
    level); an SM pulls the head block when idle, executes its trace, and
    only stalls when the single device-wide global-memory port is busy.
    Port arbitration is FIFO by request time (ties broken by SM index), so
    the simulation is deterministic. Port queueing appears as per-SM
    *wait* time rather than an inflated instruction cost — the makespan of
    an imbalanced or mixed-program grid is therefore never worse than the
    wave schedule's, which idles every SM until the slowest block of each
    wave retires.

The scheduler decides *timing only*. Functional results are computed by
the lockstep batch machinery in ``device.launch`` in a canonical,
schedule-independent order (program-major, then block order), so a
launch's architectural state is invariant to the dispatch discipline —
``tests/test_scheduler.py`` property-tests this.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Sequence

import numpy as np

from .cycles import ProgramTrace
from .packing import WavePacking

SCHEDULES = ("static", "dynamic")


@dataclasses.dataclass
class Schedule:
    """Timing of one launch: who ran what, when, and what it cost."""

    mode: str                       # "static" | "dynamic"
    n_sms: int
    makespan: int                   # device cycles, launch start to last retire
    block_sm: np.ndarray            # (n_blocks,) SM that ran each block
    block_start: np.ndarray         # (n_blocks,) issue cycle
    block_finish: np.ndarray        # (n_blocks,) retire cycle
    block_busy: np.ndarray          # (n_blocks,) sequencer-busy cycles
    block_wait: np.ndarray          # (n_blocks,) gmem-port stall cycles
    block_gmem: np.ndarray          # (n_blocks,) gmem-port occupancy cycles
    wave_cycles: np.ndarray         # (n_waves,) static mode; empty for dynamic

    @property
    def n_blocks(self) -> int:
        return int(self.block_sm.shape[0])

    @property
    def sm_busy(self) -> np.ndarray:
        """(n_sms,) cycles each SM spent issuing instructions."""
        out = np.zeros(self.n_sms, np.int64)
        np.add.at(out, self.block_sm, self.block_busy)
        return out

    @property
    def sm_wait(self) -> np.ndarray:
        """(n_sms,) cycles each SM stalled on the global-memory port."""
        out = np.zeros(self.n_sms, np.int64)
        np.add.at(out, self.block_sm, self.block_wait)
        return out

    @property
    def sm_idle(self) -> np.ndarray:
        """(n_sms,) cycles each SM had no block to run."""
        return self.makespan - self.sm_busy - self.sm_wait

    @property
    def sm_blocks(self) -> np.ndarray:
        """(n_sms,) blocks retired per SM."""
        out = np.zeros(self.n_sms, np.int64)
        np.add.at(out, self.block_sm, 1)
        return out

    @property
    def port_busy(self) -> int:
        """Total cycles the device-wide global-memory port transferred."""
        return int(self.block_gmem.sum())

    @property
    def port_wait(self) -> int:
        """Total SM-cycles queued behind the port."""
        return int(self.block_wait.sum())


def schedule_blocks(traces: Sequence[ProgramTrace], n_sms: int,
                    mode: str,
                    phase_of: Sequence[int] | None = None,
                    priority_of: Sequence[int] | None = None,
                    packing: WavePacking | None = None,
                    start_cycle: int = 0) -> Schedule:
    """Schedule ``traces[b]`` (one per block, in grid order) onto ``n_sms``
    SMs under the given discipline.

    ``phase_of[b]`` (non-negative ints) expresses kernel dependencies: a
    block dispatches only after every block of all lower phases retired —
    a device-wide barrier between phases (the CUDA-stream semantic for
    dependent kernels, e.g. a two-level reduction fused into one launch).
    Within a phase, blocks keep their grid order. Default: one phase.

    ``priority_of[b]`` orders the DYNAMIC ready queue within a phase: an
    idle SM pulls the highest-priority ready block; ties keep FIFO grid
    order, so all-equal priorities (the default) reproduce the plain FIFO
    schedule exactly. The static wave schedule ignores priority — waves
    are grid order by definition.

    ``packing`` (a :class:`core.packing.WavePacking`) overrides the
    grid-order wave rule with an explicit membership decision: the
    static schedule runs exactly ``packing.waves`` (each wave's members
    lockstep, every member charged the whole wave's port drain), and the
    dynamic FIFO tiebreak becomes the packed dispatch order — BOTH
    disciplines must consume the same packing, or ``dynamic <= static``
    stops being a like-for-like comparison (list dispatch in order X
    never loses to serial waves chunked from order X, but it can lose to
    waves chunked from a different one). ``packing=None`` is grid order,
    bit-identical to the pre-packing scheduler.

    ``start_cycle`` (non-negative) delays the whole launch: no block
    issues before it. This is the host-dispatch model of the serving
    front door (arXiv 2401.04261 measures exactly this launch-queue
    latency): ``device.launch`` converts its launch-queue depth into a
    start offset, so the stall shows up as SM *idle* time at the head of
    the schedule and in the makespan — never as per-block busy or port
    cycles. ``start_cycle=0`` (the default) is bit-identical to the
    pre-serving scheduler.
    """
    if mode not in SCHEDULES:
        raise ValueError(f"schedule mode {mode!r} not in {SCHEDULES}")
    if n_sms < 1:
        raise ValueError(f"n_sms={n_sms} must be >= 1")
    if start_cycle < 0:
        raise ValueError(f"start_cycle={start_cycle} must be >= 0")
    n_blocks = len(traces)
    if priority_of is None:
        prio = np.zeros(n_blocks, np.int64)
    else:
        prio = np.asarray(list(priority_of), np.int64)
        if prio.shape != (n_blocks,):
            raise ValueError(f"priority_of has shape {prio.shape}, want "
                             f"({n_blocks},)")
    if phase_of is not None:
        phase = np.asarray(list(phase_of), np.int64)
        if phase.shape != (n_blocks,):
            raise ValueError(f"phase_of has shape {phase.shape}, want "
                             f"({n_blocks},)")
    if packing is not None:
        if packing.n_blocks != n_blocks:
            raise ValueError(f"packing covers {packing.n_blocks} blocks, "
                             f"schedule has {n_blocks}")
        if packing.n_sms != n_sms:
            raise ValueError(f"packing was built for {packing.n_sms} SMs, "
                             f"schedule has {n_sms}")
        if phase_of is not None:
            # the packing must respect THIS schedule's fences: a packed
            # wave that mixed phases (or ran out of phase order) would
            # let the packed static path model blocks from both sides of
            # a barrier as concurrent
            last_ph = None
            for wave in packing.waves:
                phs = {int(phase[b]) for b in wave}
                if len(phs) != 1:
                    raise ValueError(f"packed wave {wave} spans barrier "
                                     f"phases {sorted(phs)}")
                ph = phs.pop()
                if last_ph is not None and ph < last_ph:
                    raise ValueError("packed waves run out of barrier-"
                                     "phase order")
                last_ph = ph
        if mode == "static":
            # the packed wave rule: membership comes from the packing,
            # waves run back to back in packed (phase-major) order
            return _shift(_schedule_static(traces, n_sms,
                                           waves=packing.waves),
                          start_cycle)
        # dynamic: the packed order replaces grid order as the FIFO
        # tiebreak; rank[b] = b's position in the packed dispatch order
        rank = np.empty(n_blocks, np.int64)
        rank[packing.order] = np.arange(n_blocks)
    else:
        rank = np.arange(n_blocks, dtype=np.int64)
    if mode == "static":
        sim = lambda tr, n, _p, _r: _schedule_static(tr, n)  # noqa: E731
    else:
        sim = _schedule_dynamic
    if phase_of is None:
        return _shift(sim(traces, n_sms, prio, rank), start_cycle)
    parts = [np.flatnonzero(phase == p) for p in np.unique(phase)]
    sm = np.zeros(n_blocks, np.int64)
    start = np.zeros(n_blocks, np.int64)
    finish = np.zeros(n_blocks, np.int64)
    busy = np.zeros(n_blocks, np.int64)
    wait = np.zeros(n_blocks, np.int64)
    gmem = np.zeros(n_blocks, np.int64)
    waves: list[int] = []
    t0 = int(start_cycle)
    for idx in parts:
        s = sim([traces[i] for i in idx], n_sms, prio[idx], rank[idx])
        sm[idx] = s.block_sm
        start[idx] = s.block_start + t0
        finish[idx] = s.block_finish + t0
        busy[idx] = s.block_busy
        wait[idx] = s.block_wait
        gmem[idx] = s.block_gmem
        waves.extend(int(c) for c in s.wave_cycles)
        t0 += s.makespan
    return Schedule(mode=mode, n_sms=n_sms, makespan=t0,
                    block_sm=sm, block_start=start, block_finish=finish,
                    block_busy=busy, block_wait=wait, block_gmem=gmem,
                    wave_cycles=np.asarray(waves, np.int64))


def merge_schedules(parts: Sequence[tuple[Schedule, np.ndarray, int]],
                    n_sms: int, n_blocks: int) -> Schedule:
    """Union per-device schedules into one fleet-level :class:`Schedule`.

    ``parts`` is a sequence of ``(schedule, blocks, sm_offset)`` triples:
    ``schedule`` covers the fleet blocks listed in ``blocks`` (fleet
    block index per local block, in the schedule's local order) and its
    SM indices are shifted by ``sm_offset`` — device ``d`` of a fleet
    owns SMs ``[d * per_device, (d+1) * per_device)``. A fleet block may
    appear in exactly one part. The merged makespan is the latest retire
    over all parts (devices run concurrently; per-phase serialization is
    already baked into each part's ``start_cycle``), and ``wave_cycles``
    concatenates in part order (device-major). All parts must share one
    ``mode``.
    """
    if not parts:
        raise ValueError("merge_schedules needs at least one part")
    modes = {s.mode for s, _, _ in parts}
    if len(modes) != 1:
        raise ValueError(f"cannot merge schedules of mixed modes {modes}")
    sm = np.zeros(n_blocks, np.int64)
    start = np.zeros(n_blocks, np.int64)
    finish = np.zeros(n_blocks, np.int64)
    busy = np.zeros(n_blocks, np.int64)
    wait = np.zeros(n_blocks, np.int64)
    gmem = np.zeros(n_blocks, np.int64)
    seen = np.zeros(n_blocks, bool)
    waves: list[int] = []
    makespan = 0
    for s, blocks, sm_off in parts:
        idx = np.asarray(blocks, np.int64)
        if idx.shape != (s.n_blocks,):
            raise ValueError(f"part covers {s.n_blocks} blocks but maps "
                             f"{idx.shape[0]} fleet indices")
        if seen[idx].any():
            raise ValueError("parts overlap: a fleet block was scheduled "
                             "on two devices")
        seen[idx] = True
        sm[idx] = s.block_sm + int(sm_off)
        start[idx] = s.block_start
        finish[idx] = s.block_finish
        busy[idx] = s.block_busy
        wait[idx] = s.block_wait
        gmem[idx] = s.block_gmem
        waves.extend(int(c) for c in s.wave_cycles)
        makespan = max(makespan, s.makespan)
    if not seen.all():
        raise ValueError("parts leave fleet blocks unscheduled")
    return Schedule(mode=modes.pop(), n_sms=n_sms, makespan=makespan,
                    block_sm=sm, block_start=start, block_finish=finish,
                    block_busy=busy, block_wait=wait, block_gmem=gmem,
                    wave_cycles=np.asarray(waves, np.int64))


def _shift(s: Schedule, start_cycle: int) -> Schedule:
    """Delay a whole schedule by ``start_cycle`` host-dispatch cycles:
    every block's issue/retire moves right, the makespan absorbs the
    stall as leading SM idle time, and per-block busy/wait/gmem are
    untouched (the host, not the port, is what's slow)."""
    if not start_cycle:
        return s
    return dataclasses.replace(
        s, makespan=s.makespan + int(start_cycle),
        block_start=s.block_start + int(start_cycle),
        block_finish=s.block_finish + int(start_cycle))


def _schedule_static(traces: Sequence[ProgramTrace], n_sms: int,
                     waves: Sequence[tuple[int, ...]] | None = None
                     ) -> Schedule:
    """The lockstep wave schedule. ``waves`` (tuples of block indices,
    run back to back in order) overrides the default grid-order chunks —
    the packed static path; a packed wave never crosses a phase fence,
    so the sequential wave order preserves the barrier semantic."""
    n_blocks = len(traces)
    sm = np.zeros(n_blocks, np.int64)
    start = np.zeros(n_blocks, np.int64)
    finish = np.zeros(n_blocks, np.int64)
    busy = np.zeros(n_blocks, np.int64)
    wait = np.zeros(n_blocks, np.int64)
    gmem = np.asarray([t.gmem_cycles for t in traces], np.int64)
    if waves is None:
        waves = [tuple(range(w0, min(w0 + n_sms, n_blocks)))
                 for w0 in range(0, n_blocks, n_sms)]
    wave_cycles = []
    t0 = 0
    for wave in waves:
        wave_gmem = sum(int(gmem[b]) for b in wave)
        wave_c = 0
        for i, b in enumerate(wave):
            # lockstep wave rule: a block's sequencer is additionally held
            # while the port drains every OTHER wave member's accesses —
            # for a homogeneous wave of n this is the classic
            # (n-1) * gmem_cycles charge, bit-identical to the lockstep
            # device machine
            cost = traces[b].cycles + wave_gmem - int(gmem[b])
            sm[b] = i
            start[b] = t0
            finish[b] = t0 + cost
            busy[b] = traces[b].cycles
            wait[b] = cost - busy[b]
            wave_c = max(wave_c, cost)
        wave_cycles.append(wave_c)
        t0 += wave_c
    return Schedule(mode="static", n_sms=n_sms, makespan=t0,
                    block_sm=sm, block_start=start, block_finish=finish,
                    block_busy=busy, block_wait=wait, block_gmem=gmem,
                    wave_cycles=np.asarray(wave_cycles, np.int64))


def _segments(trace: ProgramTrace) -> list[tuple[int, int]]:
    """Split a trace into (compute_cycles, gmem_cycles) runs; the final
    segment has gmem_cycles == 0 (the tail after the last port access)."""
    segs: list[tuple[int, int]] = []
    comp = 0
    for t in trace.instrs:
        if t.gmem:
            segs.append((comp, t.cycles))
            comp = 0
        else:
            comp += t.cycles
    segs.append((comp, 0))
    return segs


_PULL, _PORT = 0, 1


def _schedule_dynamic(traces: Sequence[ProgramTrace], n_sms: int,
                      priority: np.ndarray | None = None,
                      rank: np.ndarray | None = None) -> Schedule:
    n_blocks = len(traces)
    sm = np.zeros(n_blocks, np.int64)
    start = np.zeros(n_blocks, np.int64)
    finish = np.zeros(n_blocks, np.int64)
    busy = np.asarray([t.cycles for t in traces], np.int64)
    wait = np.zeros(n_blocks, np.int64)

    if priority is None:
        priority = np.zeros(n_blocks, np.int64)
    if rank is None:
        rank = np.arange(n_blocks, dtype=np.int64)
    # ready queue ordered by (priority desc, dispatch order): the FIFO
    # tiebreak is the packed dispatch rank — grid order when no packing
    # is in play — so all-equal priorities pop exactly that order
    queue: list[tuple[int, int, int]] = [(-int(priority[b]), int(rank[b]),
                                          b) for b in range(n_blocks)]
    heapq.heapify(queue)
    segs_of = [_segments(t) for t in traces]
    # per-SM cursor: current block, its segments, next segment index
    cur_block = [-1] * n_sms
    cur_segs: list[list[tuple[int, int]]] = [[] for _ in range(n_sms)]
    cur_i = [0] * n_sms
    kind = [_PULL] * n_sms
    port_free = 0

    heap: list[tuple[int, int]] = [(0, s) for s in range(n_sms)]
    heapq.heapify(heap)

    def run_from(s: int, t: int) -> None:
        """Advance SM ``s`` from time ``t`` through its current compute
        segment, to either its next port request or block retirement
        (a pull event); both are arbitrated through the event heap."""
        comp, g = cur_segs[s][cur_i[s]]
        t += comp
        if g > 0:
            kind[s] = _PORT
        else:
            finish[cur_block[s]] = t
            kind[s] = _PULL
        heapq.heappush(heap, (t, s))

    while heap:
        t, s = heapq.heappop(heap)
        if kind[s] == _PULL:
            if not queue:
                continue                      # SM retires: queue drained
            _, _, b = heapq.heappop(queue)
            cur_block[s] = b
            cur_segs[s] = segs_of[b]
            cur_i[s] = 0
            sm[b] = s
            start[b] = t
            run_from(s, t)
        else:                                 # _PORT: request made at t
            g = cur_segs[s][cur_i[s]][1]
            grant = max(t, port_free)
            port_free = grant + g
            wait[cur_block[s]] += grant - t
            cur_i[s] += 1
            run_from(s, grant + g)

    makespan = int(finish.max()) if n_blocks else 0
    return Schedule(mode="dynamic", n_sms=n_sms, makespan=makespan,
                    block_sm=sm, block_start=start, block_finish=finish,
                    block_busy=busy, block_wait=wait,
                    block_gmem=np.asarray([t.gmem_cycles for t in traces],
                                          np.int64),
                    wave_cycles=np.zeros((0,), np.int64))
