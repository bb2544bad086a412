"""eGPU machine configuration.

One SM = 16 SPs, 512 threads max, 16 registers/thread (one M20K per two
registers: the 512x32 M20K geometry is what fixed these numbers in the
paper). Shared memory is quad-read-port / single-write-port; depth is
parameterizable (the §III.E sector-packing budget gives 3K words when four
SMs share one Agilex sector).

Architectural words are typeless 32-bit values. The port stores them as
``torch.int32`` and bitcasts with ``.view(torch.float32)`` where an
instruction reads them as FP32. A ``MachineState`` keeps its data words
on the device of the execute backend and its sequencer fields (pc, the
stacks, the halt flag and the counters) on the host: the ISA has no
data-dependent control flow, so the sequencer never needs to read the
card.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

N_SP = 16                # scalar processors per SM
MAX_THREADS = 512        # threads per SM
N_REGS = 16              # registers per thread
MAX_WAVES = MAX_THREADS // N_SP
RET_STACK_DEPTH = 8
LOOP_STACK_DEPTH = 4


@dataclasses.dataclass(frozen=True)
class SMConfig:
    """Static (plan-time) machine parameters."""

    n_threads: int = MAX_THREADS       # initialized threads (<= 512)
    dim_x: int = 16                    # 2D thread space: x dimension
    shmem_depth: int = 3072            # words (12 KiB: §III.E sector budget)
    imem_depth: int = 512              # one M20K of 512x40
    max_steps: int = 100_000           # sequencer fuel
    with_dot: bool = True              # dot-product extension unit
    with_sfu: bool = True              # inverse-sqrt SFU

    def __post_init__(self):
        if not 1 <= self.n_threads <= MAX_THREADS:
            raise ValueError(f"n_threads={self.n_threads} not in [1, {MAX_THREADS}]")
        if self.n_threads % self.dim_x:
            raise ValueError("n_threads must be divisible by dim_x")

    @property
    def dim_y(self) -> int:
        return self.n_threads // self.dim_x

    @property
    def n_waves(self) -> int:
        return max(1, (self.n_threads + N_SP - 1) // N_SP)


@dataclasses.dataclass
class MachineState:
    """Architectural + profiling state of one SM (of an SM batch, with a
    leading batch axis on every field, as ``executor.run_many`` returns).

    ``regs``/``shmem``/``oob`` are tensors on the backend's device; the
    sequencer fields and counters are host integers and numpy arrays."""

    regs: torch.Tensor          # (MAX_THREADS, N_REGS) int32
    shmem: torch.Tensor         # (shmem_depth,) int32
    pc: Any = 0                 # int
    ret_stack: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((RET_STACK_DEPTH,), np.int64))
    ret_sp: Any = 0
    loop_ctr: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((LOOP_STACK_DEPTH,), np.int64))
    loop_sp: Any = 0
    halted: Any = False
    oob: torch.Tensor | None = None   # () bool — any out-of-range access
    steps: Any = 0              # instructions executed
    cycles: Any = 0             # sequencer cycles (cost model)
    cycles_by_class: np.ndarray | None = None  # (NUM_CLASSES,) int64

    def replace(self, **kw) -> "MachineState":
        return dataclasses.replace(self, **kw)

    def replace_regs(self, regs) -> "MachineState":
        return dataclasses.replace(self, regs=regs)


def as_u32_image(arr, depth: int, what: str = "memory",
                 device: torch.device | str | None = None) -> torch.Tensor:
    """Coerce an array to a (..., depth) memory image of 32-bit words,
    stored as ``torch.int32`` on ``device`` (default: a tensor's own
    device, the host for anything else). The image never aliases ``arr``.

    float input is rounded to float32 and bitcast (the eGPU memory system
    is typeless 32-bit words); integer input keeps its low 32 bits;
    shorter images are zero-padded on the last axis. An int32 or float32
    tensor is copied and padded on its own device, so an image on the
    card never passes through the host.
    """
    if isinstance(arr, torch.Tensor):
        if device is None:
            device = arr.device
        if arr.dtype in (torch.int32, torch.float32):
            t = arr.detach().view(torch.int32)
            pad = depth - t.shape[-1]
            if pad < 0:
                raise ValueError(f"{what} image of {t.shape[-1]} words "
                                 f"exceeds depth {depth}")
            t = torch.nn.functional.pad(t, (0, pad)) if pad else t.clone()
            return t.contiguous().to(device)
        arr = arr.detach().cpu().numpy()
    a = np.asarray(arr)
    if a.dtype.kind == "f" and a.dtype.itemsize >= 4:
        a = a.astype(np.float32).view(np.uint32)
    else:
        a = a.astype(np.int64).astype(np.uint32)
    pad = depth - a.shape[-1]
    if pad < 0:
        raise ValueError(f"{what} image of {a.shape[-1]} words exceeds "
                         f"depth {depth}")
    if pad:
        a = np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)])
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(
        device or "cpu")


def init_state(cfg: SMConfig, shmem=None,
               device: torch.device | str = "cpu") -> MachineState:
    """Fresh single-SM state; ``shmem`` is None or one image."""
    from .isa import NUM_CLASSES

    if shmem is None:
        sh = torch.zeros((cfg.shmem_depth,), dtype=torch.int32, device=device)
    else:
        sh = as_u32_image(shmem, cfg.shmem_depth, "shared-memory", device)
    return MachineState(
        regs=torch.zeros((MAX_THREADS, N_REGS), dtype=torch.int32,
                         device=device),
        shmem=sh,
        oob=torch.zeros((), dtype=torch.bool, device=device),
        cycles_by_class=np.zeros((NUM_CLASSES,), np.int64))


def shmem_f32(state) -> torch.Tensor:
    return state.shmem.view(torch.float32)


def shmem_i32(state) -> torch.Tensor:
    return state.shmem


def regs_f32(state) -> torch.Tensor:
    return state.regs.view(torch.float32)


def regs_i32(state) -> torch.Tensor:
    return state.regs


def profile(state: MachineState) -> dict[str, Any]:
    """Cycle profile by instruction class — the Tables III/IV view."""
    from .isa import CLASS_NAMES

    by = np.asarray(state.cycles_by_class)
    total = int(by.sum())
    return {
        "total_cycles": total,
        "instructions": int(state.steps),
        "by_class": {n: int(c) for n, c in zip(CLASS_NAMES, by)},
        "pct_by_class": {n: (100.0 * int(c) / total if total else 0.0)
                         for n, c in zip(CLASS_NAMES, by)},
    }
