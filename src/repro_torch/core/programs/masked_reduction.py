"""Clipped/masked grid reduction: predicated SIMT data selection.

The classic two-level reduction (``programs.reduction``) sums everything
it loads. Real streaming kernels rarely do: they clip outliers and sum
only the lanes matching a data-dependent filter. On the eGPU that filter
cannot branch (the instruction stream is static) — it runs as per-lane
predication:

  * clipping is two ``SETP``/``@P SELP`` pairs
    (``y = x < lo ? lo : x``, then ``y = y > hi ? hi : y``);
  * the filter ``y > t`` is a third ``SETP``, ANDed (predicates are
    ordinary 0/1 registers, so the combine is a plain bitwise ``AND``)
    with a ``gid < n`` validity predicate that masks the zero-padded
    grid tail;
  * the wavefront reduction itself runs under the guard
    (``@P SUM.FP32``): masked-off lanes contribute nothing, and a
    wavefront with no enabled lane leaves its partial at zero — no
    select-then-sum round trip;
  * the matching element count rides the same mask: ``@P SUM.FP32``
    over a register pinned to 1.0f.

Stage 1 blocks fold their chunk to a (sum, count) partial pair and
commit both with single-cycle ``GST {w1,d1}`` stores; the partial
arrays are laid out back-to-back, so stage 2 is the STOCK
``reduction.reduction_grid_asm`` program on a 2-block grid — block 0
folds the sums, block 1 the counts (``gid = BID * n2 + TDX`` walks
straight from one array into the next).

``launch_masked_reduction(x, threshold, clip=(lo, hi))`` returns
``(sum, count, LaunchResult)`` where
``sum = Σ { clip(x_i) : clip(x_i) > threshold }``.
"""
from __future__ import annotations

import numpy as np

from ..assembler import Program, assemble, auto_nop
from ..device import DeviceConfig, Kernel, LaunchResult, launch
from .reduction import reduction_grid_asm


def masked_reduction_asm(n_threads: int, src_base: int, par_base: int,
                         prm_base: int, meta_base: int, n2: int) -> str:
    """One stage-1 block: clip + filter + masked fold of its chunk.

    Loads ``x[gid]`` from ``src_base`` (``gid = BID*n_threads + TDX``),
    the fp32 params ``[t, lo, hi]`` from ``prm_base`` and the int32 valid
    length ``n`` from ``meta_base``, and GSTs the block's (sum, count)
    partials to ``par_base + BID`` / ``par_base + n2 + BID``.
    """
    n_waves = max(1, n_threads // 16)
    lines = [
        "    BID R10",
        "    TDX R1",
        f"    LOD R11, #{n_threads}",
        "    MUL.INT32 R12, R10, R11",
        "    ADD.INT32 R1, R12, R1            // gid",
        f"    GLD R2, (R1)+{src_base}          // x[gid]",
        f"    GLD R13, (R0)+{prm_base}         // t  (one address, all lanes)",
        f"    GLD R14, (R0)+{prm_base + 1}     // lo",
        f"    GLD R15, (R0)+{prm_base + 2}     // hi",
        f"    GLD R7, (R0)+{meta_base}         // n (valid length)",
        "    // ---- clip: y = min(max(x, lo), hi) via predicated selects ----",
        "    SETP.LT.FP32 R4, R2, R14",
        "    @R4 SELP R2, R14, R2             // y = x < lo ? lo : x",
        "    SETP.GT.FP32 R4, R2, R15",
        "    @R4 SELP R2, R15, R2             // y = y > hi ? hi : y",
        "    // ---- filter mask: (y > t) AND (gid < n) ----",
        "    SETP.GT.FP32 R4, R2, R13",
        "    SETP.LT.INT32 R6, R1, R7",
        "    AND R4, R4, R6                   // predicates are 0/1 registers",
        "    LOD.FP32 R5, #1                  // 1.0f per lane (count unit)",
        "    @R4 SUM.FP32 R3, R2, R0          // masked sum -> lane 0",
        # the destinations (R3, R9) are never written before the SUM, so
        # a fully-masked wavefront KEEPS its zero lane-0 partial — summing
        # into the 1.0f-pinned unit register would leak 1.0 per empty wave
        "    @R4 SUM.FP32 R9, R5, R0          // masked count -> lane 0",
    ]

    def fold(src: int, accs: list[int]) -> int:
        """Snooping fold of per-wavefront lane-0 partials in R``src``."""
        n_chains = min(len(accs), max(1, n_waves // 2))
        for c in range(n_chains):
            w0 = 2 * c
            if 2 * c + 1 < n_waves:
                lines.append(f"    ADD.FP32 R{accs[c]}, R{src}@{w0}, "
                             f"R{src}@{2 * c + 1} {{d1}}")
            else:
                lines.append(f"    ADD.FP32 R{accs[c]}, R{src}@{w0}, "
                             f"R0@{w0} {{d1}}")
        for w in range(2 * n_chains, n_waves):
            c = w % n_chains
            lines.append(f"    ADD.FP32 R{accs[c]}, R{accs[c]}, "
                         f"R{src}@{w} {{d1}}")
        live = accs[:n_chains]
        while len(live) > 1:
            nxt = []
            for i in range(0, len(live) - 1, 2):
                lines.append(f"    ADD.FP32 R{live[i]}, R{live[i]}, "
                             f"R{live[i + 1]} {{w1,d1}}")
                nxt.append(live[i])
            if len(live) % 2:
                nxt.append(live[-1])
            live = nxt
        return live[0]

    # R3 (sums) folds into R6/R7 chains, R9 (counts) into R8/R11 (the
    # n_threads constant is dead by now); the two folds interleave to
    # hide each other's RAW windows
    s = fold(3, [6, 7])
    c = fold(9, [8, 11])
    lines.append(f"    GST R{s}, (R10)+{par_base} {{w1,d1}}       // sum partial")
    lines.append(f"    GST R{c}, (R10)+{par_base + n2} {{w1,d1}}  // count partial")
    lines.append("    STOP")
    return auto_nop("\n".join(lines), n_threads)


def masked_reduction_program(n_threads: int, src_base: int, par_base: int,
                             prm_base: int, meta_base: int, n2: int
                             ) -> Program:
    return assemble(masked_reduction_asm(n_threads, src_base, par_base,
                                         prm_base, meta_base, n2))


def launch_masked_reduction(x: np.ndarray, threshold: float,
                            clip: tuple[float, float] = (-np.inf, np.inf),
                            device: DeviceConfig | None = None,
                            block: int = 256, backend: str | None = None,
                            schedule: str | None = None
                            ) -> tuple[float, int, LaunchResult]:
    """Sum-and-count the clipped elements of ``x`` above ``threshold``.

    One fused launch: a grid of stage-1 blocks (predicated clip + filter
    + masked fold) and one barrier-fenced stage-2 2-block grid reusing
    the stock reduction fold. Returns (sum, count, LaunchResult).
    """
    from ..device import buffer_layout
    from ..machine import SMConfig

    x = np.asarray(x, np.float32).reshape(-1)
    n = x.shape[0]
    block = min(block, max(16, -(-n // 16) * 16))
    n_blocks = max(1, -(-n // block))
    n2 = -(-n_blocks // 16) * 16         # stage-2 block (and array stride)
    x_pad = np.zeros(n_blocks * block, np.float32)
    x_pad[:n] = x
    lo, hi = float(clip[0]), float(clip[1])
    buffers = {
        "x": x_pad,
        "params": np.array([threshold, lo, hi], np.float32),
        "meta": np.array([n], np.int32),
        "partials": np.zeros(2 * n2, np.float32),
        "result": np.zeros(16, np.float32),
    }
    layout = buffer_layout(buffers)
    if layout["result"][0] + layout["result"][1] >= 1 << 14:
        raise ValueError(f"n={n} too large for immediate addressing")
    src, prm, meta, par, res_off = (
        layout[k][0] for k in ("x", "params", "meta", "partials", "result"))
    if device is None:
        depth = layout["result"][0] + layout["result"][1]
        device = DeviceConfig(global_mem_depth=max(depth, 64),
                              sm=SMConfig(max_steps=50_000))
    stage1 = masked_reduction_program(block, src, par, prm, meta, n2)
    # stage 2: the STOCK fold on a 2-block grid — BID 0 walks the sum
    # partials, BID 1 the count partials (gid = BID*n2 + TDX)
    stage2 = assemble(reduction_grid_asm(n2, par, res_off, True))
    res = launch(
        device,
        programs=[Kernel(stage1, block=block, name="masked.stage1"),
                  Kernel(stage2, block=n2, name="masked.stage2",
                         barrier=True)],
        grid_map=[0] * n_blocks + [1, 1], buffers=buffers,
        backend=backend, schedule=schedule)
    out = res.buffer("result").cpu().numpy()
    return float(out[0]), int(round(float(out[1]))), res
