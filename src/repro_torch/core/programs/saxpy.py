"""SAXPY on the eGPU: z = alpha*x + y. The 'hello world' program.

Two variants:

``saxpy_asm``/``run_saxpy`` — the single-SM original. Layout: x at [0, n),
y at [n, 2n), z at [2n, 3n); alpha broadcast from shared memory slot 3n
(an FP32 immediate cannot be encoded in 15 bits).

``saxpy_grid_asm``/``launch_saxpy`` — the CUDA-style grid version on the
multi-SM device layer: data lives in GLOBAL memory, each thread computes
``gid = BID*block + TDX`` and processes one element via GLD/GST, and the
grid is scheduled onto the device's SMs in waves. This is the canonical
launch-API demo.
"""
from __future__ import annotations

import numpy as np

from ..assembler import Program, assemble, auto_nop
from ..device import DeviceConfig, Kernel, LaunchResult, launch
from ..executor import run
from ..machine import SMConfig, shmem_f32


def saxpy_asm(n: int) -> str:
    nops = lambda k: "\n".join(["    NOP"] * k)  # noqa: E731
    return f"""
    TDX R1
    LOD R4, (R0)+{3 * n}      // alpha (broadcast: every thread, same addr)
    LOD R2, (R1)+0            // x[tid]
    LOD R3, (R1)+{n}          // y[tid]
{nops(3)}
    MUL.FP32 R5, R2, R4
{nops(8)}
    ADD.FP32 R6, R5, R3
{nops(8)}
    STO R6, (R1)+{2 * n}
    STOP
"""


def saxpy_program(n: int) -> Program:
    return assemble(saxpy_asm(n))


def run_saxpy(alpha: float, x: np.ndarray, y: np.ndarray,
              backend: str = "cuda"):
    """Single-SM SAXPY on the step engine; returns (z, final_state)."""
    n = int(x.shape[0])
    if n % 16 or n > 512:
        raise ValueError("length must be a multiple of 16, <= 512")
    cfg = SMConfig(n_threads=n, dim_x=n, shmem_depth=3 * n + 16,
                   max_steps=10_000)
    img = np.zeros(cfg.shmem_depth, np.float32)
    img[:n] = x
    img[n:2 * n] = y
    img[3 * n] = alpha
    state = run(cfg, saxpy_program(n), img, backend=backend)
    z = shmem_f32(state)[2 * n:3 * n].cpu().numpy().copy()
    return z, state


# ---------------------------------------------------------------------------
# grid/block version on the device layer
# ---------------------------------------------------------------------------


def saxpy_grid_asm(n: int, block: int) -> str:
    """Grid SAXPY: one element per thread, ``n / block`` thread blocks.

    Global-memory layout (matches ``device.buffer_layout`` for the buffers
    dict built by ``launch_saxpy``): x at [0, n), y at [n, 2n), z at
    [2n, 3n), alpha at 3n. Offsets are GLD/GST immediates, so n <= 5461
    (3n must fit the signed 14-bit immediate).
    """
    text = f"""
    BID R7                    // block index within the launch grid
    TDX R1                    // thread index within the block
    LOD R8, #{block}
    MUL.INT32 R9, R7, R8      // bid * block
    ADD.INT32 R1, R9, R1      // gid
    GLD R4, (R0)+{3 * n}      // alpha (broadcast: every thread, same addr)
    GLD R2, (R1)+0            // x[gid]
    GLD R3, (R1)+{n}          // y[gid]
    MUL.FP32 R5, R2, R4
    ADD.FP32 R6, R5, R3
    GST R6, (R1)+{2 * n}      // z[gid]
    STOP
"""
    return auto_nop(text, n_threads=block)


def saxpy_grid_program(n: int, block: int) -> Program:
    return assemble(saxpy_grid_asm(n, block))


def saxpy_kernel(n: int, block: int = 512) -> Kernel:
    """Grid SAXPY as a ``Kernel`` for multi-program launches."""
    block = min(block, n)
    return Kernel(program=saxpy_grid_program(n, block), block=block,
                  name=f"saxpy{n}")


def launch_saxpy(alpha: float, x: np.ndarray, y: np.ndarray,
                 device: DeviceConfig | None = None,
                 block: int = 512, backend: str | None = None,
                 schedule: str | None = None
                 ) -> tuple[np.ndarray, LaunchResult]:
    """z = alpha*x + y over a launch grid; any n that is a multiple of 16.

    Blocks beyond ``device.n_sms`` queue and run in subsequent waves. With
    the device's default ``engine="auto"`` so short a program resolves to
    the step engine (``engine_fallback == "megakernel-too-small"``).
    """
    n = int(x.shape[0])
    if n % 16:
        raise ValueError("length must be a multiple of 16")
    block = min(block, n)
    if n % block:
        raise ValueError(f"n={n} must be a multiple of block={block}")
    if 3 * n >= 1 << 14:
        raise ValueError(f"n={n} too large for immediate addressing")
    if device is None:
        device = DeviceConfig(global_mem_depth=max(3 * n + 16, 64),
                              sm=SMConfig(max_steps=10_000))
    buffers = {
        "x": np.asarray(x, np.float32),
        "y": np.asarray(y, np.float32),
        "z": np.zeros(n, np.float32),
        "alpha": np.asarray([alpha], np.float32),
    }
    res = launch(device, saxpy_grid_program(n, block),
                 grid=(n // block,), block=block, buffers=buffers,
                 backend=backend, schedule=schedule)
    z = res.buffer("z").cpu().numpy().copy()
    return z, res
