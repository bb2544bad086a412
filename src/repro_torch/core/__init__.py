"""eGPU core: the paper's SM and multi-SM device, in PyTorch.

Public API:
    SMConfig                             — single-SM machine parameters
    DeviceConfig, launch, LaunchResult   — multi-SM device layer (grid/block
                                           launches, global memory)
    program_trace, schedule_blocks       — static block traces + the
                                           static-wave / dynamic-queue
                                           block schedulers
    WavePacking, pack_waves              — schedule-aware wave packing
    assemble, auto_nop, check_hazards    — assembler
    MachineState, init_state, profile,   — single-SM state and the step-
    run, run_many                          engine shims
    TraceSchedule, compile_program       — the trace engine
    MegakernelPlan, compile_megakernel   — the megakernel engine
    ExecBackend, execute_backends        — "cuda" (kernels on the card) and
                                           "cpu" (plain versions on the host)
    resources                            — Tables I/V + §III.E analytic model
"""
from .assembler import AsmError, Program, assemble, auto_nop, check_hazards
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
    run,
    run_many,
)
from .isa import CLASS_NAMES, Cond, Depth, Instr, Op, Typ, Width
from .machine import MachineState, SMConfig, init_state, profile
from .packing import PACKINGS, WavePacking, pack_waves
from . import resources
from .scheduler import Schedule, schedule_blocks
from .trace_engine import (
    ENGINES,
    MegakernelPlan,
    TraceSchedule,
    compile_megakernel,
    compile_program,
)

__all__ = [
    "AsmError", "Program", "assemble", "auto_nop", "check_hazards",
    "ProgramTrace", "instr_cycles", "program_trace",
    "DeviceConfig", "DeviceState", "Kernel", "LaunchResult", "buffer_layout",
    "init_device_state", "launch", "pack_buffers",
    "ExecBackend", "execute_backends", "get_execute_backend", "run",
    "run_many",
    "CLASS_NAMES", "Cond", "Depth", "Instr", "Op", "Typ", "Width",
    "MachineState", "SMConfig", "init_state", "profile",
    "PACKINGS", "WavePacking", "pack_waves",
    "Schedule", "schedule_blocks",
    "ENGINES", "MegakernelPlan", "TraceSchedule", "compile_megakernel",
    "compile_program",
    "resources",
]
