"""Reduction benchmark (paper §III.D): sum 512 values without shared memory.

Stage 1: SUM per wavefront -> 32 partials in lane 0 (SP0's register file).
Stage 2: thread snooping — thread 0 reads every wavefront's lane-0 partial
directly ("without having to go through the shared memory") and folds them
with a NOP-padded accumulation tree that respects the 9-cycle RAW window.

``launch_reduction`` scales this past one SM on the device layer: a grid
of blocks each folds its 512-element chunk of GLOBAL memory and commits
its partial with a single-cycle ``GST {w1,d1}``; a second one-block launch
(reading the same global segment — waves and launches share it) folds the
partials to the final scalar. The classic two-level grid reduction.
"""
from __future__ import annotations

import numpy as np

from ..assembler import Program, assemble, auto_nop
from ..device import DeviceConfig, Kernel, LaunchResult, launch
from ..executor import run
from ..machine import SMConfig, shmem_f32


def reduction_asm(n_threads: int = 512) -> str:
    n_waves = max(1, n_threads // 16)
    lines = ["    TDX R1",
             "    LOD R2, (R1)+0            // x[tid]",
             "    SUM.FP32 R3, R2, R0       // wavefront partials -> lane0"]
    # fold pairs via snooping: R4..R9 hold independent accumulator chains
    # (6 chains keep dependent uses >= 9 cycles apart without NOPs).
    accs = [4, 5, 6, 7, 8, 9]
    n_chains = min(len(accs), max(1, n_waves // 2))
    for c in range(n_chains):
        w0, w1 = 2 * c, 2 * c + 1 if 2 * c + 1 < n_waves else 2 * c
        lines.append(f"    ADD.FP32 R{accs[c]}, R3@{w0}, R3@{w1} {{d1}}")
    for w in range(2 * n_chains, n_waves):
        c = w % n_chains
        lines.append(f"    ADD.FP32 R{accs[c]}, R{accs[c]}, R3@{w} {{d1}}")
        if n_chains < 6:
            lines.append("    NOP\n    NOP\n    NOP\n    NOP")
    # fold the chains (single thread; pad the RAW window)
    lines.append("    NOP\n    NOP\n    NOP\n    NOP\n    NOP\n    NOP\n"
                 "    NOP\n    NOP")
    live = accs[:n_chains]
    while len(live) > 1:
        nxt = []
        for i in range(0, len(live) - 1, 2):
            lines.append(f"    ADD.FP32 R{live[i]}, R{live[i]}, R{live[i+1]} {{w1,d1}}")
            nxt.append(live[i])
        if len(live) % 2:
            nxt.append(live[-1])
        live = nxt
        lines.append("    NOP\n    NOP\n    NOP\n    NOP\n    NOP\n    NOP\n"
                     "    NOP\n    NOP")
    lines.append(f"    STO R{live[0]}, (R0)+{n_threads} {{w1,d1}}  // result")
    lines.append("    STOP")
    return "\n".join(lines)


def reduction_program(n_threads: int = 512) -> Program:
    return assemble(reduction_asm(n_threads))


# ---------------------------------------------------------------------------
# grid version on the device layer
# ---------------------------------------------------------------------------

def reduction_grid_asm(n_threads: int, src_base: int, dst_base: int,
                       grid: bool) -> str:
    """One reduction block over global memory.

    Loads ``x[gid]`` from ``src_base`` (``gid = BID*n_threads + TDX`` when
    ``grid``, else just ``TDX``), folds via SUM + thread snooping exactly
    like ``reduction_asm``, and stores the block partial to
    ``dst_base + BID`` with the paper's single-cycle ``{w1,d1}`` store —
    through the GLOBAL port, so the next launch stage can read it.
    """
    n_waves = max(1, n_threads // 16)
    lines = ["    BID R10", "    TDX R1"]
    if grid:
        lines += [f"    LOD R11, #{n_threads}",
                  "    MUL.INT32 R12, R10, R11",
                  "    ADD.INT32 R1, R12, R1      // gid"]
    lines += [f"    GLD R2, (R1)+{src_base}      // x[gid]",
              "    SUM.FP32 R3, R2, R0          // wavefront partials -> lane0"]
    accs = [4, 5, 6, 7, 8, 9]
    n_chains = min(len(accs), max(1, n_waves // 2))
    for c in range(n_chains):
        w0 = 2 * c
        if 2 * c + 1 < n_waves:
            lines.append(f"    ADD.FP32 R{accs[c]}, R3@{w0}, R3@{2*c+1} {{d1}}")
        else:
            # odd tail / single wavefront: seed the chain with partial + 0
            # (R0 is never written, so R0@0 is 0.0)
            lines.append(f"    ADD.FP32 R{accs[c]}, R3@{w0}, R0@{w0} {{d1}}")
    for w in range(2 * n_chains, n_waves):
        c = w % n_chains
        lines.append(f"    ADD.FP32 R{accs[c]}, R{accs[c]}, R3@{w} {{d1}}")
    live = accs[:n_chains]
    while len(live) > 1:
        nxt = []
        for i in range(0, len(live) - 1, 2):
            lines.append(
                f"    ADD.FP32 R{live[i]}, R{live[i]}, R{live[i+1]} {{w1,d1}}")
            nxt.append(live[i])
        if len(live) % 2:
            nxt.append(live[-1])
        live = nxt
    lines.append(f"    GST R{live[0]}, (R10)+{dst_base} {{w1,d1}}  // partial")
    lines.append("    STOP")
    return auto_nop("\n".join(lines), n_threads)


def launch_reduction(x: np.ndarray, device: DeviceConfig | None = None,
                     block: int = 512, backend: str | None = None,
                     schedule: str | None = None, fused: bool = False
                     ) -> tuple[float, LaunchResult]:
    """Two-level grid reduction of x on the multi-SM device.

    Any length up to ~16K elements (every global-memory offset is a GLD/GST
    immediate, so the padded x + partials + result layout must fit the
    signed 14-bit immediate range). Returns (total, LaunchResult).

    ``fused=False``: two back-to-back launches — stage 1 writes one
    partial per block, stage 2 is a one-block launch over the
    carried-forward global memory that folds the partials. The result is
    the stage-2 LaunchResult.

    ``fused=True``: ONE multi-program launch — the stage-2 program rides
    in the same grid with ``barrier=True``, so its block dispatches only
    after every stage-1 block retired (the scheduler's dependency fence).
    The result is the whole launch's LaunchResult, so ``profile()`` shows
    both stages' per-SM occupancy.
    """
    x = np.asarray(x, np.float32).reshape(-1)
    n = x.shape[0]
    block = min(block, max(16, -(-n // 16) * 16))
    n_blocks = max(1, -(-n // block))
    if n_blocks * block + n_blocks + 32 >= 1 << 14:
        # every gmem offset is a GLD/GST immediate (signed 14-bit)
        raise ValueError(f"n={n} too large for immediate addressing "
                         f"(padded layout must stay below {1 << 14} words)")
    x_pad = np.zeros(n_blocks * block, np.float32)
    x_pad[:n] = x
    # stage-2 block must be a multiple of 16 threads; excess partials are 0
    n2 = -(-n_blocks // 16) * 16
    buffers = {
        "x": x_pad,
        "partials": np.zeros(n2, np.float32),
        "result": np.zeros(16, np.float32),
    }
    from ..device import buffer_layout

    layout = buffer_layout(buffers)
    src, par, res_off = (layout[k][0] for k in ("x", "partials", "result"))
    if device is None:
        depth = layout["result"][0] + layout["result"][1]
        device = DeviceConfig(global_mem_depth=max(depth, 64),
                              sm=SMConfig(max_steps=50_000))
    stage1 = assemble(reduction_grid_asm(block, src, par, True))
    stage2 = assemble(reduction_grid_asm(n2, par, res_off, False))
    if fused:
        res = launch(
            device,
            programs=[Kernel(stage1, block=block, name="reduce.stage1"),
                      Kernel(stage2, block=n2, name="reduce.stage2",
                             barrier=True)],
            grid_map=[0] * n_blocks + [1], buffers=buffers,
            backend=backend, schedule=schedule)
        total = float(res.buffer("result")[0])
        return total, res
    s1 = launch(device, stage1, grid=(n_blocks,), block=block,
                buffers=buffers, backend=backend, schedule=schedule)
    s2 = launch(device, stage2, grid=(1,), block=n2, gmem=s1.gmem,
                backend=backend, schedule=schedule)
    s2.buffer_offsets = layout  # stage 2 inherits the stage-1 layout
    total = float(s2.buffer("result")[0])
    return total, s2


def run_reduction(x: np.ndarray, backend: str = "cuda"):
    """Sum x (length <= 512) on one SM (step engine); returns (total,
    final_state)."""
    n = int(x.shape[0])
    if n % 16:
        raise ValueError("length must be a multiple of 16")
    cfg = SMConfig(n_threads=n, dim_x=n, shmem_depth=max(n + 16, 64),
                   max_steps=50_000)
    img = np.zeros(cfg.shmem_depth, np.float32)
    img[:n] = np.asarray(x, np.float32)
    state = run(cfg, reduction_program(n), img, backend=backend)
    total = float(shmem_f32(state)[n])
    return total, state
