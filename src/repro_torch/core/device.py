"""Multi-SM eGPU device layer: grid/block launches over a packed sector.

``DeviceConfig(n_sms, global_mem_depth, ...)`` wraps the single-SM
``SMConfig`` with the sector-level parameters (§III.E quad-packs four SMs
per sector), and ``launch(dcfg, program, grid=(n_blocks,), block=n,
...)`` is a CUDA-style launch onto it.

Timing comes from ``core.scheduler`` over the programs' static traces
(exact, because the ISA has no data-dependent control flow): static
lockstep waves of ``n_sms`` blocks, or dynamic work-queue dispatch. The
architectural results come from running each wave of one program as one
lockstep batch on a functional engine — the step engine (``run_wave``:
fetch, decode and sequence on the host, the data path on the state's
device), or the trace and megakernel engines of ``core.trace_engine`` —
in a canonical program-major, block order, so they do not depend on the
dispatch discipline. On the trace and megakernel engines a grid of
several programs runs in merged waves instead: the wave packing decides
which blocks share a wave, and each wave runs its programs side by side
(``trace_engine.run_wave_merged`` / ``run_wave_merged_megakernel``).

Global-memory semantics (the packed-sector memory model): reads (GLD) see
the segment as of the start of the row; writes (GST) drain through the
single port in (sm, thread) order, so on a collision the last writer wins;
waves run back to back, and a later wave sees every earlier wave's writes.

The state lives on the device the execute backend names: ``"cuda"``
(the default: tensors on the card, the hand-written kernels) or ``"cpu"``
(tensors on the host, the kernels' plain versions).
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from . import isa, trace_engine
from .cycles import ProgramTrace, program_trace
from .executor import (
    _CLASS_OF,
    _G_CTL,
    _G_GLD,
    _G_GST,
    _G_LOD,
    _G_NOP,
    _G_SFU,
    _G_STO,
    _GROUP_OF_OP,
    DATA_SEL_OF_OP,
    ExecBackend,
    FusedRow,
    _decode,
    backend_device,
    get_execute_backend,
    make_data_handlers,
    pack_imem,
)
from .isa import NUM_CLASSES, Op
from .machine import (
    LOOP_STACK_DEPTH,
    MAX_THREADS,
    N_REGS,
    RET_STACK_DEPTH,
    MachineState,
    SMConfig,
    as_u32_image,
)
from .packing import PACKINGS, WavePacking, pack_waves
from .scheduler import SCHEDULES, Schedule, schedule_blocks

# ---------------------------------------------------------------------------
# configuration + state
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeviceConfig:
    """Sector-level machine parameters wrapping the per-SM ``SMConfig``."""

    n_sms: int = 4                    # SMs packed in the sector (§III.E: 4)
    global_mem_depth: int = 4096      # words of the shared global segment
    sm: SMConfig = SMConfig()         # per-SM template (block size is set
                                      # per launch; imem/shmem depth are the
                                      # CEILING for per-Kernel overrides)
    backend: str = "cuda"             # execute backend: "cuda" | "cpu"
    schedule: str = "auto"            # "static" | "dynamic" | "auto"
                                      # (static iff one program)
    engine: str = "auto"              # "step" | "trace" | "megakernel" |
                                      # "auto" (the reference's ladder)
    packing: str = "grid"             # wave packing: "grid" | "length" |
                                      # "auto" (see core.packing)
    dispatch_latency: int = 0         # host cycles to dispatch one launch
                                      # (0: free)
    queue_latency: int = 0            # extra host cycles per launch queued
                                      # at dispatch (``launch(queue_depth=)``;
                                      # the LaunchServer sets it)

    def __post_init__(self):
        if self.n_sms < 1:
            raise ValueError(f"n_sms={self.n_sms} must be >= 1")
        if self.global_mem_depth < 1:
            raise ValueError("global_mem_depth must be >= 1")
        if self.dispatch_latency < 0 or self.queue_latency < 0:
            raise ValueError("dispatch_latency/queue_latency must be >= 0")
        if self.schedule not in SCHEDULES + ("auto",):
            raise ValueError(f"schedule={self.schedule!r} must be one of "
                             f"{SCHEDULES + ('auto',)}")
        if self.engine not in trace_engine.ENGINES + ("auto",):
            raise ValueError(f"engine={self.engine!r} must be one of "
                             f"{trace_engine.ENGINES + ('auto',)}")
        if self.packing not in PACKINGS:
            raise ValueError(f"packing={self.packing!r} must be one of "
                             f"{PACKINGS}")


@dataclasses.dataclass
class DeviceState:
    """One wave's batched machine state.

    Data state is per-SM (leading ``n_sms`` axis) on the backend's device;
    the one sequencer the lockstep wave shares (pc, the stacks, the halt
    flag) and the counters are host values."""

    regs: torch.Tensor     # (n_sms, MAX_THREADS, N_REGS) int32
    shmem: torch.Tensor    # (n_sms, shmem_depth) int32
    gmem: torch.Tensor     # (global_mem_depth,) int32 — SHARED
    oob: torch.Tensor      # (n_sms,) bool — per-SM out-of-range access
    pc: int = 0
    ret_stack: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((RET_STACK_DEPTH,), np.int64))
    ret_sp: int = 0
    loop_ctr: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((LOOP_STACK_DEPTH,), np.int64))
    loop_sp: int = 0
    halted: bool = False
    steps: int = 0
    cycles: int = 0        # wave cycles incl. gmem contention
    cycles_by_class: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((NUM_CLASSES,), np.int64))


def _image(x, depth: int, what: str, device) -> torch.Tensor:
    """A memory image on ``device``: int32 words pass through, anything
    else is coerced by ``as_u32_image``."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.int32 \
            and x.shape[-1] == depth:
        return x.to(device)
    return as_u32_image(x, depth, what, device)


def init_device_state(cfg: SMConfig, n_sms: int, gmem_depth: int = 64,
                      shmem: Any = None, gmem: Any = None,
                      device: torch.device | str = "cpu") -> DeviceState:
    """Fresh wave state. ``shmem`` may be None, one image (broadcast to all
    SMs), or an (n_sms, ...) batch of per-SM images."""
    if shmem is None:
        sh = torch.zeros((n_sms, cfg.shmem_depth), dtype=torch.int32,
                         device=device)
    else:
        sh = _image(shmem, cfg.shmem_depth, "shared-memory", device)
        if sh.ndim == 1:
            sh = sh.expand(n_sms, cfg.shmem_depth)
        elif sh.shape[0] != n_sms:
            raise ValueError(f"shared-memory batch of {sh.shape[0]} images "
                             f"!= n_sms={n_sms}")
        sh = sh.contiguous()
    gm = torch.zeros((gmem_depth,), dtype=torch.int32, device=device) \
        if gmem is None else _image(gmem, gmem_depth, "global-memory",
                                    device)
    return DeviceState(
        regs=torch.zeros((n_sms, MAX_THREADS, N_REGS), dtype=torch.int32,
                         device=device),
        shmem=sh, gmem=gm,
        oob=torch.zeros((n_sms,), dtype=torch.bool, device=device))


def lift_machine_state(state: MachineState, gmem_depth: int = 64,
                       device: torch.device | str | None = None
                       ) -> DeviceState:
    """Wrap a single-SM ``MachineState`` as a 1-SM wave (on ``device``,
    default the state's own)."""
    dev = state.regs.device if device is None else device
    return DeviceState(
        regs=state.regs[None].to(dev), shmem=state.shmem[None].to(dev),
        gmem=torch.zeros((gmem_depth,), dtype=torch.int32, device=dev),
        oob=state.oob.reshape(1).to(dev),
        pc=int(state.pc), ret_stack=np.array(state.ret_stack, np.int64),
        ret_sp=int(state.ret_sp),
        loop_ctr=np.array(state.loop_ctr, np.int64),
        loop_sp=int(state.loop_sp), halted=bool(state.halted),
        steps=int(state.steps), cycles=int(state.cycles),
        cycles_by_class=np.array(state.cycles_by_class, np.int64))


def squeeze_device_state(s: DeviceState) -> MachineState:
    """Project a 1-SM wave back to the single-SM ``MachineState`` view."""
    return MachineState(
        regs=s.regs[0], shmem=s.shmem[0], pc=s.pc,
        ret_stack=s.ret_stack.copy(), ret_sp=s.ret_sp,
        loop_ctr=s.loop_ctr.copy(), loop_sp=s.loop_sp,
        halted=s.halted, oob=s.oob[0], steps=s.steps, cycles=s.cycles,
        cycles_by_class=s.cycles_by_class.copy())


# ---------------------------------------------------------------------------
# the step engine: the sequencer on the host, the data path on the device
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Issue:
    """One I-MEM word as the step engine issues it, decoded once."""

    op: int
    imm_raw: int
    group: int
    klass: int
    row: FusedRow          # the data path's view (row.sel 0: none)


def _issue_table(cfg: SMConfig, imem_lo, imem_hi) -> list:
    """A lazily filled pc -> ``_Issue`` table over the packed I-MEM."""
    d = _decode(np.asarray(imem_lo), np.asarray(imem_hi))
    n_waves = cfg.n_waves
    depth_table = (n_waves, max(1, n_waves // 2), max(1, n_waves // 4), 1)
    width_table = (16, 8, 4, 1)
    table: list = [None] * len(d["opcode"])

    def issue(pc: int) -> _Issue:
        it = table[pc]
        if it is None:
            f = {k: int(v[pc]) for k, v in d.items()}
            op = f["opcode"]
            aw, awt = depth_table[f["depth"]], width_table[f["width"]]
            fields = {k: f[k] for k in ("opcode", "typ", "rd", "ra", "rb",
                                        "imm", "x", "ext_a", "ext_b", "pen",
                                        "preg", "pneg")}
            it = table[pc] = _Issue(
                op=op, imm_raw=f["imm_raw"], group=int(_GROUP_OF_OP[op]),
                # a 2-bit type field of 3 reads the last class column
                klass=int(_CLASS_OF[op, min(f["typ"], 2)]),
                row=FusedRow(sel=int(DATA_SEL_OF_OP[op]), d=fields,
                             act_waves=aw, act_wthreads=awt))
        return it

    return issue


def _stores_gmem(imem_lo, imem_hi) -> bool:
    """Whether the packed I-MEM holds a GST word, the one instruction that
    writes the global-memory image."""
    op = _decode(np.asarray(imem_lo), np.asarray(imem_hi))["opcode"]
    return bool((_GROUP_OF_OP[op] == _G_GST).any())


def _issue_cycles(it: _Issue, n_sms: int) -> int:
    """Sequencer cycles of one issue. Per-SM resources (ALU, shared
    memory, extension units) run concurrently across the lockstep batch;
    the single global-memory port serializes the batch, so GLD/GST pay
    ``n_sms * active_threads`` (``cycles.py``)."""
    act_threads = it.row.act_waves * it.row.act_wthreads
    if it.group == _G_LOD:
        return max(1, (act_threads + 3) // 4)
    if it.group == _G_STO:
        return act_threads
    if it.group in (_G_GLD, _G_GST):
        return act_threads * n_sms
    if it.group in (_G_NOP, _G_CTL, _G_SFU):
        return 1
    return it.row.act_waves


def run_wave(cfg: SMConfig, backend: ExecBackend, imem_lo, imem_hi,
             block_idx, prog_idx, state: DeviceState) -> DeviceState:
    """Run one wave of blocks to completion on the STEP engine: fetch,
    decode and dispatch per instruction.

    The ISA has no data-dependent control flow and the wave shares one
    pc, so the sequencer (fetch from the packed I-MEM, decode cached per
    word, JMP/JSR/RTS/LOOP/INIT/STOP with clipped stack indices, the
    ``max_steps`` fuel and the pc range test) runs on the host in Python
    integers, and each data instruction is dispatched into
    ``executor.make_data_handlers`` on the state's device. The host never
    reads the card inside the loop. The wave runs on its own copy of the
    data state (``trace_engine.owned_data``; the image only where the
    I-MEM holds a GST word): ``state`` is not written."""
    device = state.regs.device
    n_sms = state.regs.shape[0]
    bidx = trace_engine._wave_index(block_idx, device)
    pidx = trace_engine._wave_index(prog_idx, device)
    issue = _issue_table(cfg, imem_lo, imem_hi)
    handlers: dict[int, Any] = {}
    data = trace_engine.owned_data(
        state, gmem=_stores_gmem(imem_lo, imem_hi))
    pc, ret_sp, loop_sp = state.pc, state.ret_sp, state.loop_sp
    ret_stack = [int(v) for v in state.ret_stack]
    loop_ctr = [int(v) for v in state.loop_ctr]
    halted, steps, cycles = state.halted, state.steps, state.cycles
    by_class = np.array(state.cycles_by_class, np.int64)
    while not halted and steps < cfg.max_steps and 0 <= pc < cfg.imem_depth:
        it = issue(pc)
        if it.row.sel:
            if pc not in handlers:
                handlers[pc] = make_data_handlers(
                    cfg, backend, it.row, bidx, pidx)[it.row.sel]
            data = handlers[pc](data)
        # ---- sequencer (non-control opcodes fall through to pc + 1) ----
        op, imm, pc1 = it.op, it.imm_raw, pc + 1
        if op == Op.JMP:
            pc = imm
        elif op == Op.JSR:
            ret_stack[min(max(ret_sp, 0), RET_STACK_DEPTH - 1)] = pc1
            ret_sp += 1
            pc = imm
        elif op == Op.RTS:
            pc = ret_stack[min(max(ret_sp - 1, 0), RET_STACK_DEPTH - 1)]
            ret_sp -= 1
        elif op == Op.LOOP:
            # decrement the top counter; jump while > 1, pop at 1
            lsp = min(max(loop_sp - 1, 0), LOOP_STACK_DEPTH - 1)
            top = loop_ctr[lsp]
            loop_ctr[lsp] = top - 1
            if top > 1:
                pc = imm
            else:
                pc = pc1
                loop_sp -= 1
        elif op == Op.INIT:
            loop_ctr[min(max(loop_sp, 0), LOOP_STACK_DEPTH - 1)] = imm
            loop_sp += 1
            pc = pc1
        else:
            halted = op == Op.STOP
            pc = pc1
        cyc = _issue_cycles(it, n_sms)
        steps += 1
        cycles += cyc
        by_class[it.klass] += cyc
    regs, shmem, gmem, oob = data
    return dataclasses.replace(
        state, regs=regs, shmem=shmem, gmem=gmem, oob=oob, pc=pc,
        ret_stack=np.array(ret_stack, np.int64), ret_sp=ret_sp,
        loop_ctr=np.array(loop_ctr, np.int64), loop_sp=loop_sp,
        halted=halted, steps=steps, cycles=cycles, cycles_by_class=by_class)


# ---------------------------------------------------------------------------
# buffers: named global-memory segments
# ---------------------------------------------------------------------------

def buffer_layout(buffers: Mapping[str, Any]) -> dict[str, tuple[int, int]]:
    """Deterministic gmem layout: name -> (offset, length) in 32-bit words,
    packed in insertion order from offset 0. Program builders call this to
    derive addresses; ``launch`` uses the same layout to fill gmem."""
    layout: dict[str, tuple[int, int]] = {}
    off = 0
    for name, arr in buffers.items():
        n = int(np.asarray(arr).reshape(-1).shape[0])
        layout[name] = (off, n)
        off += n
    return layout


def pack_buffers(buffers: Mapping[str, Any], depth: int
                 ) -> tuple[torch.Tensor, dict[str, tuple[int, int]]]:
    """Pack named host arrays into one global-memory image of ``depth``
    (an int32 tensor on the host)."""
    layout = buffer_layout(buffers)
    used = sum(n for _, n in layout.values())
    if used > depth:
        raise ValueError(f"buffers need {used} words but global_mem_depth "
                         f"is {depth}")
    img = torch.zeros((depth,), dtype=torch.int32)
    for name, arr in buffers.items():
        off, n = layout[name]
        img[off:off + n] = as_u32_image(np.asarray(arr).reshape(-1), n, name)
    return img, layout


# ---------------------------------------------------------------------------
# the launch API
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Kernel:
    """One program of a launch.

    ``block`` is threads per block, ``dim_x`` the TDX/TDY x-extent
    (defaults to ``block``: flat 1-D indexing), ``name`` labels the program
    in ``LaunchResult.profile()``. ``barrier=True`` makes this program's
    blocks wait until every block of all earlier-listed programs retired.
    ``imem_depth``/``shmem_depth`` override the device-wide ``SMConfig``
    for THIS program only (validated against the device ceiling).
    ``priority`` orders the DYNAMIC dispatch queue; the static wave
    schedule ignores it.
    """

    program: Any                      # Program | encoded 40-bit word array
    block: int | None = None
    dim_x: int | None = None
    name: str | None = None
    barrier: bool = False
    imem_depth: int | None = None
    shmem_depth: int | None = None
    priority: int = 0


def as_kernel(p: Any) -> Kernel:
    return p if isinstance(p, Kernel) else Kernel(program=p)


@dataclasses.dataclass
class LaunchResult:
    """Per-block results + aggregate device profile of one launch.

    ``regs``/``shmem``/``gmem``/``oob`` are tensors on the backend's
    device; words are int32 (``shmem_f32``/``buffer`` bitcast them)."""

    grid: tuple[int, ...]
    block: int | tuple[int, ...]  # threads/block (per program if mixed)
    n_waves: int                # scheduling rounds (0 for dynamic dispatch)
    regs: torch.Tensor          # (n_blocks, MAX_THREADS, N_REGS) int32
    shmem: torch.Tensor         # (n_blocks, shmem_depth) int32
    gmem: torch.Tensor          # (global_mem_depth,) int32 — final
    oob: torch.Tensor           # (n_blocks,) bool
    halted: bool                # every block ran to STOP
    steps: int                  # instructions issued (per sequencer)
    cycles: int                 # modeled device cycles for the launch
    wave_cycles: np.ndarray     # (n_waves,) per-round cycles (static only)
    cycles_by_class: np.ndarray  # (NUM_CLASSES,) sequencer occupancy
    buffer_offsets: dict[str, tuple[int, int]] | None = None
    schedule: str = "static"            # "static" | "dynamic"
    engine: str = "megakernel"          # functional engine that ran
    engine_fallback: str | None = None  # why "auto" degraded
    program_names: tuple[str, ...] = ("k0",)
    grid_map: np.ndarray | None = None  # (n_blocks,) block -> program idx
    timing: Schedule | None = None      # per-SM / per-block timeline
    static_cycles: int | None = None    # wave-schedule baseline makespan
    trace_merge: dict[str, Any] | None = None  # merged-wave records
    packing: str = "grid"               # resolved wave-packing policy
    wave_packing: WavePacking | None = None  # the membership decision
    host_dispatch: dict[str, int] | None = None  # the launch-queue charge
                                        # (non-None exactly when the
                                        # device models one)
    priority_respected: bool = True     # False iff Kernel(priority=) was
                                        # requested but the static wave
                                        # schedule ignored it
    fleet: dict[str, Any] | None = None  # the fleet view of a
                                        # ``core.fleet.launch_fleet``:
                                        # routing, placement, per-device
                                        # occupancy, NUMA charge

    @property
    def n_blocks(self) -> int:
        return int(self.grid[0])

    def shmem_f32(self) -> torch.Tensor:
        return self.shmem.view(torch.float32)

    def gmem_f32(self) -> torch.Tensor:
        return self.gmem.view(torch.float32)

    def buffer(self, name: str, dtype=torch.float32) -> torch.Tensor:
        """Final contents of a named gmem buffer (bitcast to ``dtype``;
        ``torch.int32`` gives the raw words)."""
        if not self.buffer_offsets or name not in self.buffer_offsets:
            raise KeyError(f"no buffer {name!r} in this launch")
        off, n = self.buffer_offsets[name]
        return self.gmem[off:off + n].view(dtype)

    def profile(self) -> dict[str, Any]:
        """Aggregate cycle profile (Tables III/IV view + the GMEM row),
        extended with the scheduler's per-SM / per-program occupancy view
        and the single global port's utilization. ``trace_merge`` appears
        when a compiled engine ran merged waves: the packing policy, each
        wave's padding and, on the megakernel, its fusion counts;
        ``host_dispatch`` when the device charges a dispatch or queue
        latency, and ``fleet`` on a fleet launch."""
        by = np.asarray(self.cycles_by_class)
        total = int(by.sum())
        out: dict[str, Any] = {
            "total_cycles": int(self.cycles),
            "instructions": int(self.steps),
            "schedule": self.schedule,
            "engine": self.engine,
            "engine_fallback": self.engine_fallback,
            "packing": self.packing,
            "priority_respected": self.priority_respected,
            "n_waves": self.n_waves,
            "wave_cycles": [int(c) for c in self.wave_cycles],
            "by_class": {n: int(c) for n, c in zip(isa.CLASS_NAMES, by)},
            "pct_by_class": {n: (100.0 * int(c) / total if total else 0.0)
                             for n, c in zip(isa.CLASS_NAMES, by)},
        }
        if self.trace_merge is not None:
            out["trace_merge"] = self.trace_merge
        if self.host_dispatch is not None:
            out["host_dispatch"] = dict(self.host_dispatch)
        if self.fleet is not None:
            out["fleet"] = dict(self.fleet)
        t = self.timing
        if t is None:
            return out
        span = max(int(self.cycles), 1)
        busy, wait, idle = t.sm_busy, t.sm_wait, t.sm_idle
        out["per_sm"] = [
            {"busy": int(busy[i]), "wait": int(wait[i]),
             "idle": int(idle[i]), "blocks": int(t.sm_blocks[i]),
             "occupancy": int(busy[i]) / span}
            for i in range(t.n_sms)]
        gmap = np.asarray(self.grid_map)
        per_prog: dict[str, Any] = {}
        for k, name in enumerate(self.program_names):
            mine = gmap == k
            sm_busy_k = np.zeros(t.n_sms, np.int64)
            np.add.at(sm_busy_k, t.block_sm[mine], t.block_busy[mine])
            per_prog[name] = {
                "blocks": int(mine.sum()),
                "busy_cycles": int(t.block_busy[mine].sum()),
                "gmem_wait": int(t.block_wait[mine].sum()),
                "sm_busy": [int(c) for c in sm_busy_k],
                "sm_occupancy": [int(c) / span for c in sm_busy_k],
            }
        out["per_program"] = per_prog
        out["gmem_port"] = {
            "busy": t.port_busy,
            "wait": t.port_wait,
            "utilization": t.port_busy / span,
        }
        out["static_cycles"] = int(self.static_cycles) \
            if self.static_cycles is not None else int(self.cycles)
        return out


_STATIC_PRIORITY_WARNED = False


def _warn_static_priority() -> None:
    """Warn (once per process) that Kernel(priority=) was lost: the static
    wave schedule dispatches in grid order by definition."""
    global _STATIC_PRIORITY_WARNED
    if _STATIC_PRIORITY_WARNED:
        return
    _STATIC_PRIORITY_WARNED = True
    warnings.warn(
        "Kernel(priority=) is ignored under schedule='static': waves "
        "dispatch in grid order. Use schedule='dynamic' for priority-aware "
        "dispatch; see LaunchResult.profile()['priority_respected'].",
        UserWarning, stacklevel=3)


def _resolve_schedule(schedule: str | None, dcfg: DeviceConfig,
                      n_programs: int) -> str:
    mode = schedule if schedule is not None else dcfg.schedule
    if mode == "auto":
        return "static" if n_programs == 1 else "dynamic"
    if mode not in SCHEDULES:
        raise ValueError(f"schedule={mode!r} must be one of "
                         f"{SCHEDULES + ('auto',)}")
    return mode


def _kernel_shmem(sh: Any, depth: int, count: int, k: int):
    """Normalize one program's shared-memory init: None, one image
    (broadcast to the program's blocks), or a (count, ...) batch indexed by
    the program-local block index."""
    if sh is None:
        return None
    batch = as_u32_image(sh, depth, f"shared-memory (program {k})")
    if batch.ndim == 1:
        return batch.expand(count, depth)
    if batch.shape[0] != count:
        raise ValueError(f"shared-memory batch of {batch.shape[0]} images "
                         f"!= {count} blocks of program {k}")
    return batch


def _normalize_grid(dcfg: DeviceConfig, program, grid, block, dim_x,
                    programs, grid_map, shmem
                    ) -> tuple[list[Kernel], np.ndarray, list[Any]]:
    """Normalize the two launch forms to ``(kernels, gmap, shmems)``."""
    if programs is not None:
        if program is not None or grid is not None or block is not None \
                or dim_x is not None:
            raise ValueError("pass either program/grid/block/dim_x or "
                             "programs=/grid_map=, not both")
        if grid_map is None:
            raise ValueError("programs= requires grid_map=")
        kernels = [as_kernel(p) for p in programs]
        gmap = np.asarray(list(grid_map), np.int64)
        if gmap.ndim != 1 or gmap.shape[0] < 1:
            raise ValueError("grid_map must be a non-empty 1-D sequence")
        if gmap.min() < 0 or gmap.max() >= len(kernels):
            raise ValueError(f"grid_map references programs outside "
                             f"[0, {len(kernels)})")
        shmems = list(shmem) if shmem is not None else [None] * len(kernels)
        if len(shmems) != len(kernels):
            raise ValueError(f"shmem sequence of {len(shmems)} != "
                             f"{len(kernels)} programs")
    else:
        if program is None or grid is None:
            raise ValueError("launch needs program+grid or programs+grid_map")
        grid = (int(grid),) if isinstance(grid, int) \
            else tuple(map(int, grid))
        if len(grid) != 1 or grid[0] < 1:
            raise ValueError(f"grid={grid} must be a positive (n_blocks,)")
        kernels = [Kernel(program=program, block=block, dim_x=dim_x)]
        gmap = np.zeros((grid[0],), np.int64)
        shmems = [shmem]
    return kernels, gmap, shmems


def _lower_kernels(dcfg: DeviceConfig, kernels: Sequence[Kernel]
                   ) -> tuple[list[str], list[SMConfig],
                              list[tuple[np.ndarray, np.ndarray]],
                              list[ProgramTrace], list[np.ndarray]]:
    """Per-program static resources: unique names, per-kernel SMConfigs
    (with validated imem/shmem overrides), packed I-MEM images, exact
    static traces, and the raw word arrays."""
    names: list[str] = []
    cfgs: list[SMConfig] = []
    imems: list[tuple[np.ndarray, np.ndarray]] = []
    traces: list[ProgramTrace] = []
    word_arrays: list[np.ndarray] = []
    for k, kern in enumerate(kernels):
        blk = int(kern.block) if kern.block is not None \
            else dcfg.sm.n_threads
        overrides = {}
        for field, ceiling in (("imem_depth", dcfg.sm.imem_depth),
                               ("shmem_depth", dcfg.sm.shmem_depth)):
            val = getattr(kern, field)
            if val is None:
                continue
            val = int(val)
            if val < 1:
                raise ValueError(f"{field}={val} of program {k} must be "
                                 f">= 1")
            if val > ceiling:
                raise ValueError(
                    f"{field}={val} of program {k} exceeds the device "
                    f"ceiling {ceiling} (DeviceConfig.sm.{field})")
            overrides[field] = val
        cfg = dataclasses.replace(
            dcfg.sm, n_threads=blk,
            dim_x=kern.dim_x if kern.dim_x is not None else blk,
            **overrides)
        words = kern.program.words if hasattr(kern.program, "words") \
            else np.asarray(kern.program)
        imems.append(pack_imem(words, cfg.imem_depth))
        cfgs.append(cfg)
        word_arrays.append(np.asarray(words))
        traces.append(program_trace(words, blk, imem_depth=cfg.imem_depth,
                                    max_steps=cfg.max_steps))
        name = kern.name or f"k{k}"
        while name in names:
            name = f"{name}.{k}"
        names.append(name)
    return names, cfgs, imems, traces, word_arrays


def _resolve_engine(engine: str | None, dcfg: DeviceConfig,
                    traces: Sequence[ProgramTrace]
                    ) -> tuple[str, str | None]:
    """Resolve the functional engine; returns ``(engine, fallback)``.

    ``fallback`` is non-None exactly when ``"auto"`` degraded from its
    first choice. The auto ladder is megakernel -> trace (a schedule
    above the unroll cap) -> step (a fuel-limited trace, or every program
    too short for fusion to pay)."""
    mode = engine if engine is not None else dcfg.engine
    if mode == "auto":
        if not all(t.halted for t in traces):
            return "step", "fuel-limited-trace"
        if max(t.data_steps for t in traces) \
                > trace_engine.MEGAKERNEL_UNROLL_CAP:
            return "trace", "megakernel-unroll-cap"
        residual = max(t.data_steps
                       - sum(1 for i in t.instrs if i.gmem)
                       for t in traces)
        if residual < trace_engine.MEGAKERNEL_MIN_FUSED_ROWS:
            return "step", "megakernel-too-small"
        return "megakernel", None
    if mode not in trace_engine.ENGINES:
        raise ValueError(f"engine={mode!r} must be one of "
                         f"{trace_engine.ENGINES + ('auto',)}")
    return mode, None


def _host_dispatch(dcfg: DeviceConfig, queue_depth: int
                   ) -> tuple[int, dict[str, int] | None]:
    """The launch-queue model: the host cycles charged before a launch's
    first block issues, and its ``profile()["host_dispatch"]`` record
    (None when the device charges no latency)."""
    if queue_depth < 0:
        raise ValueError(f"queue_depth={queue_depth} must be >= 0")
    latency = dcfg.dispatch_latency + dcfg.queue_latency * queue_depth
    if not (dcfg.dispatch_latency or dcfg.queue_latency):
        return latency, None
    return latency, {"queue_depth": int(queue_depth),
                     "dispatch_cycles": int(dcfg.dispatch_latency),
                     "queue_cycles": int(dcfg.queue_latency * queue_depth),
                     "latency_cycles": int(latency)}


def launch(dcfg: DeviceConfig, program=None, grid=None,
           block: int | None = None, *,
           programs: Sequence[Any] | None = None,
           grid_map: Sequence[int] | None = None,
           buffers: Mapping[str, Any] | None = None,
           shmem: Any = None, gmem: Any = None,
           backend: str | None = None, dim_x: int | None = None,
           schedule: str | None = None,
           engine: str | None = None,
           packing: str | None = None,
           queue_depth: int = 0,
           block_ids: Sequence[int] | None = None) -> LaunchResult:
    """CUDA-style kernel launch on the multi-SM device.

    Args:
      dcfg: the device (sector) configuration.
      program: an assembled ``Program`` or encoded 40-bit word array.
      grid: number of thread blocks, as ``(n_blocks,)`` or an int.
      block: threads per block (<= 512); defaults to ``dcfg.sm.n_threads``.
      programs, grid_map: the multi-program form (``grid_map[b]`` names
        the program block ``b`` runs; BID is the block's index within its
        own program's grid, PID its program index). The step engine runs
        a heterogeneous grid program-major; the trace and megakernel
        engines run it in merged waves, the programs of each wave side by
        side (``profile()["trace_merge"]`` reports each wave).
      buffers: named host arrays packed into global memory from offset 0 in
        insertion order (layout via ``buffer_layout``); mutually exclusive
        with ``gmem``, a raw initial global-memory image.
      shmem: shared-memory initializer: one image broadcast to all blocks,
        or an ``(n_blocks, ...)`` batch.
      backend: execute backend, ``"cuda"`` or ``"cpu"``; default from dcfg.
      dim_x: the 2-D thread-space x extent (TDX/TDY); defaults to ``block``.
      schedule: "static", "dynamic" or "auto" (static for one program).
      engine: "step" (fetch/decode/dispatch per instruction, the
        sequencer on the host), "trace" (the pre-decoded schedule, row by
        row), "megakernel" (fused segments between global-port rows) or
        "auto", the reference's ladder: megakernel, degrading to "trace"
        above the unroll cap and to "step" for fuel-limited or too-short
        programs (``profile()["engine_fallback"]`` names the reason).
      packing: wave-packing policy ("grid" | "length" | "auto"), which
        shapes the timing model's waves.
      queue_depth: launches the host had queued when it dispatched this
        one (this one included). The launch is charged
        ``dcfg.dispatch_latency + dcfg.queue_latency * queue_depth`` host
        cycles before its first block issues, reported as
        ``profile()["host_dispatch"]`` when either latency is non-zero.
      block_ids: an ``(n_blocks,)`` override of each block's BID (default:
        its index within its own program's grid). A fleet sub-launch
        (``core.fleet``) runs a slice of the grid whose blocks keep their
        fleet-level BIDs.
    """
    kernels, gmap, shmems = _normalize_grid(dcfg, program, grid, block,
                                            dim_x, programs, grid_map,
                                            shmem)
    n_blocks = int(gmap.shape[0])
    bids = None
    if block_ids is not None:
        bids = np.asarray(list(block_ids), np.int64)
        if bids.shape != (n_blocks,):
            raise ValueError(f"block_ids has shape {bids.shape}, want "
                             f"({n_blocks},)")
        if (bids < 0).any():
            raise ValueError("block_ids must be non-negative")
    device = backend_device(backend or dcfg.backend)
    mode = _resolve_schedule(schedule, dcfg, len(kernels))

    host_latency, host_dispatch = _host_dispatch(dcfg, queue_depth)

    prioritized = any(k.priority for k in kernels)
    priority_respected = (mode == "dynamic") or not prioritized
    if prioritized and mode == "static":
        _warn_static_priority()

    # ---- per-program static resources -----------------------------------
    names, cfgs, imems, traces, word_arrays = _lower_kernels(dcfg, kernels)
    eng, eng_fallback = _resolve_engine(engine, dcfg, traces)
    present = [k for k in range(len(kernels)) if (gmap == k).any()]
    # the step engine runs a heterogeneous grid program-major, as the
    # reference does; the compiled engines merge such grids into shared
    # waves
    use_merged = eng in ("trace", "megakernel") and len(present) > 1
    if eng == "trace" and not use_merged:
        plans = {k: trace_engine.compile_program(word_arrays[k], cfgs[k])
                 for k in present}
    elif eng == "megakernel" and not use_merged:
        plans = {k: trace_engine.compile_megakernel(word_arrays[k], cfgs[k])
                 for k in present}
    be = get_execute_backend(backend or dcfg.backend)

    # ---- wave packing + the schedule (timing) ----------------------------
    phase_of_kernel = np.cumsum([int(k.barrier) for k in kernels])
    block_phase = phase_of_kernel[gmap]
    wp = pack_waves([traces[k].data_steps for k in gmap], dcfg.n_sms,
                    policy=packing if packing is not None
                    else dcfg.packing,
                    phase_of=block_phase)
    block_priority = np.asarray([kernels[k].priority for k in gmap],
                                np.int64)
    block_traces = [traces[k] for k in gmap]
    timing = schedule_blocks(block_traces, dcfg.n_sms, mode,
                             phase_of=block_phase,
                             priority_of=block_priority, packing=wp,
                             start_cycle=host_latency)
    if mode == "static":
        static_span = timing.makespan
    else:
        static_span = schedule_blocks(block_traces, dcfg.n_sms, "static",
                                      phase_of=block_phase, packing=wp,
                                      start_cycle=host_latency).makespan

    # ---- global-memory image --------------------------------------------
    # packed into a tensor of the launch's own (``pack_buffers`` and
    # ``as_u32_image`` copy), so no wave writes a tensor the caller passed;
    # each wave with a GST row copies it once more and the next wave
    # starts from that wave's image
    offsets = None
    if buffers is not None:
        if gmem is not None:
            raise ValueError("pass either buffers= or gmem=, not both")
        gm, offsets = pack_buffers(buffers, dcfg.global_mem_depth)
    elif gmem is not None:
        gm = as_u32_image(gmem, dcfg.global_mem_depth, "global-memory")
    else:
        gm = torch.zeros((dcfg.global_mem_depth,), dtype=torch.int32)
    gm = gm.to(device)

    # ---- functional execution: exact lockstep batches ---------------------
    regs_slots: list[Any] = [None] * n_blocks
    shmem_slots: list[Any] = [None] * n_blocks
    oob_slots: list[Any] = [None] * n_blocks
    wave_cycles, wave_steps = [], []
    machine_by = np.zeros((NUM_CLASSES,), np.int64)
    halted = True
    shmem_pad = dcfg.sm.shmem_depth
    merge_stats = None
    if use_merged:
        # each wave of the packing runs its programs side by side, members
        # ordered slot-major (grid order within a slot); the slots are the
        # wave's programs in index order, one merged plan per such set
        local_bid = np.zeros(n_blocks, np.int64)
        sh_batches: dict[int, Any] = {}
        engine_bid = bids if bids is not None else local_bid
        for k in present:
            pos = np.flatnonzero(gmap == k)
            local_bid[pos] = np.arange(pos.size)
            sh = _kernel_shmem(shmems[k], cfgs[k].shmem_depth, pos.size, k)
            sh_batches[k] = None if sh is None else sh.to(device)
        plan_of: dict[tuple[int, ...], Any] = {}
        # every wave starts from zeroed registers, so a backend that folds
        # may run the merged plan's partial evaluation
        run_merged = functools.partial(
            trace_engine.run_wave_merged_megakernel, zeroed=True) \
            if eng == "megakernel" else trace_engine.run_wave_merged
        per_wave: list[dict[str, Any]] = []
        for wave_ids in wp.waves:
            wave = np.asarray(wave_ids, np.int64)
            sig = tuple(sorted({int(gmap[b]) for b in wave}))
            if sig not in plan_of:
                progs = [word_arrays[k] for k in sig]
                cs = [cfgs[k] for k in sig]
                plan_of[sig] = \
                    trace_engine.compile_merged_megakernel(progs, cs) \
                    if eng == "megakernel" \
                    else trace_engine.compile_merged(progs, cs)
            plan = plan_of[sig]
            slot = np.asarray([sig.index(int(gmap[b])) for b in wave])
            order = np.argsort(slot, kind="stable")
            blocks, slot = wave[order], slot[order]
            counts = np.bincount(slot, minlength=len(sig))
            n = blocks.size
            # each slot's shared-memory init, padded to the device depth
            sh0, off = [], 0
            for j, k in enumerate(sig):
                c = int(counts[j])
                if sh_batches[k] is None:
                    sh0.append(torch.zeros((c, shmem_pad), dtype=torch.int32,
                                           device=device))
                else:
                    img = sh_batches[k][torch.as_tensor(
                        local_bid[blocks[off:off + c]], device=device)]
                    sh0.append(torch.nn.functional.pad(
                        img, (0, shmem_pad - img.shape[1])))
                off += c
            regs_f, sh_f, gm, oob_f = run_merged(
                be, plan, counts, engine_bid[blocks], gmap[blocks],
                torch.zeros((n, MAX_THREADS, N_REGS), dtype=torch.int32,
                            device=device),
                torch.cat(sh0), gm,
                torch.zeros((n,), dtype=torch.bool, device=device))
            for i, b in enumerate(blocks):
                regs_slots[b] = regs_f[i]
                shmem_slots[b] = sh_f[i]
                oob_slots[b] = oob_f[i]
            halted = halted and plan.halted
            rec = {"programs": [names[k] for k in sig], "width": int(n),
                   "scan_steps": int(plan.n_steps)}
            if eng == "megakernel":
                # no padded row executes: the merge's cost across slots is
                # the ordered global-port rows, reported as fusion counts
                rec.update(padded_steps=0, pad_overhead=0.0,
                           fusion=plan.stats())
            else:
                pad = int(plan.padded_steps(slot))
                rows = int(plan.n_steps) * n
                rec.update(padded_steps=pad,
                           pad_overhead=(pad / rows) if rows else 0.0)
            per_wave.append(rec)
        merge_stats = trace_engine.merge_profile(per_wave, wp.policy)
    else:
        # one program per wave, program-major
        for k in present:
            pos = np.flatnonzero(gmap == k)
            cfg = cfgs[k]
            sh_batch = _kernel_shmem(shmems[k], cfg.shmem_depth, pos.size, k)
            if sh_batch is not None:
                sh_batch = sh_batch.to(device)        # one upload per program
            for w0 in range(0, pos.size, dcfg.n_sms):
                w1 = min(w0 + dcfg.n_sms, pos.size)
                n = w1 - w0
                st = init_device_state(
                    cfg, n, gmem_depth=dcfg.global_mem_depth,
                    shmem=None if sh_batch is None else sh_batch[w0:w1],
                    gmem=gm, device=device)
                # program-local BID (or the caller's), PID = k
                bidx = torch.arange(w0, w1, dtype=torch.int32,
                                    device=device) if bids is None \
                    else torch.as_tensor(bids[pos[w0:w1]], dtype=torch.int32,
                                         device=device)
                pidx = torch.full((n,), k, dtype=torch.int32, device=device)
                if eng == "step":
                    fin = run_wave(cfg, be, *imems[k], bidx, pidx, st)
                elif eng == "trace":
                    fin = trace_engine.run_wave_trace(cfg, be, plans[k], bidx,
                                                      pidx, st)
                else:
                    # every launch wave starts from init_device_state's
                    # zeroed registers, so a backend that folds may run
                    # the plan's partial evaluation
                    fin = trace_engine.run_wave_megakernel(be, plans[k], bidx,
                                                           pidx, st,
                                                           zeroed=True)
                gm = fin.gmem               # batches run back to back
                fin_shmem = fin.shmem
                if cfg.shmem_depth < shmem_pad:
                    # per-Kernel shmem_depth override: pad back to the device
                    # depth so results still stack
                    fin_shmem = torch.nn.functional.pad(
                        fin_shmem, (0, shmem_pad - cfg.shmem_depth))
                for i, b in enumerate(pos[w0:w1]):
                    regs_slots[b] = fin.regs[i]
                    shmem_slots[b] = fin_shmem[i]
                    oob_slots[b] = fin.oob[i]
                wave_cycles.append(int(fin.cycles))
                wave_steps.append(int(fin.steps))
                machine_by += fin.cycles_by_class
                halted = halted and bool(fin.halted)

    # ---- aggregate counters ---------------------------------------------
    if mode == "static" and len(kernels) == 1:
        # the lockstep fast path: one program, shared sequencer per wave;
        # the host-dispatch charge precedes the first wave
        cycles = int(sum(wave_cycles)) + int(host_latency)
        steps = int(sum(wave_steps))
        by_class = machine_by
        waves_out = np.asarray(wave_cycles, np.int64)
    else:
        # per-SM sequencers: every block issues its own trace
        cycles = timing.makespan
        steps = sum(t.steps for t in block_traces)
        by_class = np.zeros((NUM_CLASSES,), np.int64)
        for t in block_traces:
            by_class += np.asarray(t.cycles_by_class(), np.int64)
        waves_out = timing.wave_cycles

    return LaunchResult(
        grid=(n_blocks,),
        block=cfgs[0].n_threads if len(kernels) == 1
        else tuple(c.n_threads for c in cfgs),
        n_waves=len(waves_out),
        regs=torch.stack(regs_slots, dim=0),
        shmem=torch.stack(shmem_slots, dim=0),
        gmem=gm,
        oob=torch.stack(oob_slots, dim=0),
        halted=halted,
        steps=steps,
        cycles=cycles,
        wave_cycles=np.asarray(waves_out, np.int64),
        cycles_by_class=by_class.astype(np.int64),
        buffer_offsets=offsets,
        schedule=mode,
        engine=eng,
        engine_fallback=eng_fallback,
        program_names=tuple(names),
        grid_map=gmap,
        timing=timing,
        static_cycles=static_span,
        trace_merge=merge_stats,
        packing=wp.policy,
        wave_packing=wp,
        host_dispatch=host_dispatch,
        priority_respected=priority_respected,
    )
