"""eGPU core: the paper's SM and multi-SM device, in PyTorch.

Public API:
    SMConfig                             — single-SM machine parameters
    DeviceConfig, launch, LaunchResult   — multi-SM device layer (grid/block
                                           launches, global memory)
    program_trace, schedule_blocks       — static block traces + the
                                           static-wave / dynamic-queue
                                           block schedulers
    merge_schedules                      — the fleet's union of per-device
                                           schedules
    WavePacking, pack_waves              — schedule-aware wave packing
    FleetConfig, launch_fleet            — N simulated eGPUs behind one
                                           launch front door (NUMA gmem tier;
                                           one card per eGPU when uniform)
    assemble, disassemble, auto_nop,     — assembler
    check_hazards
    MachineState, init_state, profile,   — single-SM state and the step-
    run, run_many                          engine shims
    TraceSchedule, compile_program       — the trace engine
    MegakernelPlan, compile_megakernel   — the megakernel engine
    MergedTraceSchedule, compile_merged, — heterogeneous waves on the
    MergedMegakernelPlan,                  trace and megakernel engines
    compile_merged_megakernel
    compile_cache                        — the opt-in persistent cache of
                                           host lowerings (EGPU_CACHE_DIR)
    ExecBackend, execute_backends,       — "cuda" (kernels on the card) and
    register_backend,                      "cpu" (plain versions on the host),
    register_execute_backend               and backends of one's own
    resources                            — Tables I/V + §III.E analytic model
"""
from .assembler import (AsmError, Program, assemble, auto_nop, check_hazards,
                        disassemble)
from .cycles import ProgramTrace, instr_cycles, program_trace
from .device import (
    DeviceConfig,
    DeviceState,
    Kernel,
    LaunchResult,
    buffer_layout,
    init_device_state,
    launch,
    pack_buffers,
)
from .executor import (
    ExecBackend,
    execute_backends,
    get_execute_backend,
    pack_imem,
    register_backend,
    register_execute_backend,
    run,
    run_many,
)
from .fleet import PLACEMENTS, ROUTES, FleetConfig, launch_fleet
from .isa import CLASS_NAMES, Cond, Depth, Instr, Op, Typ, Width
from .machine import (
    MachineState,
    SMConfig,
    init_state,
    profile,
    regs_f32,
    regs_i32,
    shmem_f32,
    shmem_i32,
)
from .packing import PACKINGS, WavePacking, pack_waves
from . import compile_cache, resources
from .scheduler import Schedule, merge_schedules, schedule_blocks
from .trace_engine import (
    ENGINES,
    MegakernelPlan,
    MergedMegakernelPlan,
    MergedTraceSchedule,
    TraceSchedule,
    compile_megakernel,
    compile_merged,
    compile_merged_megakernel,
    compile_program,
)

__all__ = [
    "AsmError", "Program", "assemble", "auto_nop", "check_hazards",
    "disassemble",
    "ProgramTrace", "instr_cycles", "program_trace",
    "DeviceConfig", "DeviceState", "Kernel", "LaunchResult", "buffer_layout",
    "init_device_state", "launch", "pack_buffers",
    "ExecBackend", "execute_backends", "get_execute_backend", "pack_imem",
    "register_backend", "register_execute_backend", "run", "run_many",
    "PLACEMENTS", "ROUTES", "FleetConfig", "launch_fleet",
    "CLASS_NAMES", "Cond", "Depth", "Instr", "Op", "Typ", "Width",
    "MachineState", "SMConfig", "init_state", "profile",
    "regs_f32", "regs_i32", "shmem_f32", "shmem_i32",
    "PACKINGS", "WavePacking", "pack_waves",
    "Schedule", "merge_schedules", "schedule_blocks",
    "ENGINES", "MegakernelPlan", "MergedMegakernelPlan",
    "MergedTraceSchedule", "TraceSchedule", "compile_megakernel",
    "compile_merged", "compile_merged_megakernel", "compile_program",
    "compile_cache", "resources",
]
