#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port of the eGPU simulator.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
(``nvcc`` for sm_90a, one process per source, into
``build/repro_torch_kernels/``) and then:

  1. prints the card's name and power limit;
  2. holds each kernel against its plain PyTorch version on the card with
     ``==`` over seeded random inputs (address collisions, masked and
     out-of-range lanes, snooped operands, guarded rows, NaN/infinite/
     denormal FP32 words, FP32 MUL and DOT products around 2**-126,
     INVSQR, every ALU op and type, shared-memory depths 64, 1024 and
     3072; the segment kernel also over hazard-dense rows, in which one
     thread reads what another writes, and over the FFT-64, QRD-16 and
     SAXPY plans with the barriers each plan placed; the ALU, LOD, STO,
     GLD and GST row kernels over fuzzed rows, half of them snooped with
     the destination as their own source, GST's collisions across 16 SMs
     and its claims in device memory for a 2**20-word image; the kernel
     layer's dot over fuzzed words, FFT at N = 2...16384 in both orders,
     QRD at n = 5...32 over 64 and 37 matrices with non-finite input),
     and the flash kernel within 2e-5 in float32 and one bf16 ulp in
     bfloat16 at D = 1...128 with blocks of 16...256;
  3. drives the paths on ``DeviceConfig(n_sms=4)`` at the paper's full SM
     width, through the program entry points, each with the launch counts
     set to 0 just before it and read just after:
       * main-path, the megakernel engine: FFT-64 over 64 blocks, QRD-16
         over 16 blocks and the 4096-element SAXPY (grid 8 x 512);
       * step-path, the step engine: the same SAXPY through ``"auto"``
         (the README quickstart), FFT-64 over 64 blocks, QRD-16 over 16,
         the Cholesky-16 solve over 16 and the fused two-program
         reduction of 1024 elements;
       * trace-path, the trace engine: FFT-64 and QRD-16, which must equal
         the step path's runs word for word;
       * merged-path, heterogeneous grids in merged waves: FFT-64 x 64
         interleaved with QRD-16 x 16 (the paper's mixed deployment,
         ``launch_fft_qrd``) through "auto" (the megakernel), on the trace
         engine and under length packing, and the fused two-stage
         reduction of 1024 elements through "auto";
       * fleet-path, the device fleet (``launch_fleet``, devices of four
         SMs): that FFT-64 + QRD-16 grid on 2 and 4 devices under both
         routes and on 2 devices on the trace engine, each equal to its
         plain launch, SAXPY-4096 on 2 devices at remote latency 0 and 7,
         and the fleet benchmark's shapes, whose cycles must be
         BENCH_fleet.json's; each run's placement is printed;
       * serve-path, the LaunchServer: the serve benchmark's 24-request
         FFT-64:QRD-16 trace one request a launch and batched (through
         "auto", and batched on the trace engine), whose percentiles and
         makespan must be BENCH_serve.json's, the batched trace once more
         through the background batcher (equal to the synchronous run),
         and a SAXPY-4096 request with its own buffers, served solo;
       * kernel-path, the kernel layer's entry points (``kernels.ops``):
         the QRD solver of examples/qrd_solver.py over 4096 16x16 systems,
         QRD-32 x 1024 and QRD-8 x 4096; the spectral pipeline of
         examples/fft_pipeline.py over 4096 frames and FFT-1024 x 1024;
         ``dot`` at 16 x 512 and 4096 x 512; ``flash`` at (4, 256, 64) and
         (32, 1024, 128) causal and (4, 128, 64) non-causal; each held
         against its plain version on the same inputs, and QRD and FFT
         cross-checked against the simulated eGPU on the card.
     Each launch of these paths but the kernel layer's is repeated with
     the host's plain versions and must give equal state, counters and
     profile (a fleet's ``placement_reason``, which names the devices,
     aside); the
     numerics are checked against numpy; every kernel of a path must
     have launched in it, and ``alu``, ``gather``, ``scatter``,
     ``gather_shared`` and ``scatter_shared`` exactly once per ALU, LOD,
     STO, GLD and GST row the host executed (the megakernel's SAXPY, and
     the step, trace, merged, fleet and serve paths). One ALU, LOD, STO, GLD and GST row of the
     step and trace engines, and one GLD and GST row of the megakernel,
     must issue one launch, one CUDA kernel and no PyTorch operation (a
     TorchDispatchMode count and the profiler's count of CUDA kernels),
     beside the per-op composition of the same rows that the row seam
     replaced. The host's ``"cpu"`` backend runs the megakernel's fused
     segments of a launch as their plan-time partial evaluation
     (``executor.apply_segment_residual``) and the card's ``segment``
     kernel runs the raw rows, so the main, merged, fleet and serve paths
     hold the one against the other; each prints the rows the host ran
     folded and as residual ops, and the rows the card ran raw;
     coldstart: two fresh processes share one empty compile-cache
     directory (``EGPU_CACHE_DIR``, under ``build/``) and each makes the
     first launch of the merged FFT-64 x 64 + QRD-16 x 16 grid through
     "auto" on the card: the first stores its lowering, the second must
     find all of it (no miss, no error, hits on the trace, lowering and
     megakernel kinds); both must equal the host's launch by state and
     profile; their first-launch wall times are printed with the card;
     examples: ``examples/torch_{quickstart,fft_pipeline,qrd_solver}.py``
     each run on the card as a process of its own, which must exit 0 and
     print no False check, then ``examples/torch_serve_decode.py`` (8
     requests served by the slot decode Engine) and
     ``examples/torch_train_lm.py`` (its default run: ~100M parameters,
     300 steps at 8 x 256, async checkpoints under ``build/``, the loss
     must fall), which must exit 0 and print their summary line;
  4. reproduces the [4sm] golden entries and the fleet's four from
     tests/golden_cycles.json (the mixed FFT + QRD entries on the engine
     each names, "auto" where it names none);
  5. times each kernel at its path's shapes with CUDA events beside its
     plain version, its least possible time (its bound) and, where one
     PyTorch call computes the same function, that call (timed only);
     the kernel and that call are timed once more on the card alone
     (``device_ms``: queued behind a sleep kernel, so the host's cost
     per launch is hidden); ``dot`` is also timed cold (the calls rotate
     through input sets of twice the L2), at 16 x 512 beside its 4096 x
     512, and with a's lanes 12-15 zero and with every wavefront on its
     exact path; more rows time ``fft`` at FFT-4096 x 1024 (a CTA per row),
     ``qrd`` at QRD-8 x 4096 and QRD-32 x 1024 beside its QRD-16 x
     4096, ``flash`` in bfloat16, the tile forms of ``alu``, ``gather``,
     ``scatter``, ``gather_shared`` and ``scatter_shared``, ``segment``
     on one FFT-64 wave, and a whole ALU, LOD, STO, GLD and
     GST handler call beside the per-op composition of the same row, in
     turns;
  6. lm-serve, the LM stack's serving path (plain PyTorch: it launches
     none of the ten kernels), float32 with TF32 off: (a) the smoke
     configs of granite-3-2b, deepseek-moe-16b, mamba2-780m and
     recurrentgemma-2b served by the slot decode ``Engine`` through the
     launcher's ``build_engine``/``drive`` (8 requests, 4 slots, capacity
     128) on the card and on the host with the same weights: equal token
     streams, finish reasons and active widths, prefill logits within
     ``LM_ATOL``; (b) internvl2-76b and whisper-tiny (smoke), which the
     Engine cannot serve, model to model: a prefill and 4 decode steps,
     card against host; (c) every family at its published width
     (``LM_PUBLISHED``): mamba2-780m, recurrentgemma-2b and whisper-tiny
     whole, deepseek-moe-16b, internvl2-76b and Yi-6B cut in depth; the
     card's prefill and decode steps against its own full forward, and
     at a cut depth a prefill and 4 decode steps against the host; then
     mamba2-780m and recurrentgemma-2b whole through the Engine; (d) Yi-6B
     at full depth through the launcher's entry points (weights drawn on
     the card): a warm-up drive, a drive alone for tokens/s, a drive
     with each decode step's and prefill's wall time, one 4-slot step's
     event, card-alone and profiled kernel time beside its byte bound,
     the peak device memory and the card, printed as the ``lm_serve``
     line;
  7. lm-train, the LM stack's training path (plain PyTorch, float32, TF32
     off; none of the ten kernels): (a) one train step of the smoke config
     of each family (three for granite-3-2b) on the card and on the host
     with the same weights, loss, gradient norm and every weight after
     each step held together (``TRAIN_*`` bars), and one step run twice
     on the card (weights, moments, loss and gradient norm equal bit for
     bit); (b) the reference's crash test on
     the card (granite-3-2b smoke, 10 steps, checkpoints every 4 written
     asynchronously, a run that dies at step 7 resumes from step 4): its
     losses, weights and moments equal the uninterrupted run's bit for
     bit; a checkpoint written from the card restores on the host and one
     from the host on the card; (c) every family at its published width
     (``LM_TRAIN_PUBLISHED``): one step run twice on the card at 1024
     tokens or more (mamba2-780m, recurrentgemma-2b and whisper-tiny
     whole, granite-3-2b, deepseek-moe-16b and internvl2-76b cut in
     depth), equal bit for bit, and one step against the host at a cut
     depth (whisper-tiny whole); (d) granite-3-2b whole (2.53e9 parameters) through
     ``launch.train`` for 6 steps at batch 8 x 128: per-step wall times
     from its log, tokens/s, losses, peak device memory, a warm step
     timed and profiled, the peak memory of backward and of the optimizer
     apart, the optimizer timed, beside the step's bound; printed as the
     ``lm_train`` line;
  8. lm-mesh, the LM stack's multi-device layer (plain PyTorch and
     ``torch.distributed``; none of the ten kernels): (a) a world of one
     NCCL rank (a ``FileStore`` under ``build/``) and a (1, 1) ("data",
     "model") mesh: granite-3-2b whole at lm-train (d)'s batch 8 x 128, 4
     sharded steps with the state placed as DTensors by the sharding rules,
     equal bit for bit (loss, gradient norm, params, mu, nu) to 4 plain
     steps from the same weights, the warm steps of both timed; the placed state checkpointed and
     restored with ``shardings=``, every leaf equal bit for bit; (b) the
     int8-EF compressed data-parallel step on a (1,) "data" mesh there,
     same model and batch: loss within 1e-4 and every weight within 5e-3
     of the plain step's, 5 more steps on the same batch lowering the
     loss by more than 0.01, its peak memory and the compression pass
     timed alone; (c) 4 gloo ranks on the host in a subprocess
     (``tests/mesh_check.py``): the sharded step,
     decode, elastic restore, the compressed step and the pipeline at
     smoke width against the single-rank runs; printed as the ``lm_mesh``
     line;
  9. lm-dryrun, the dry run (``launch.dryrun``: the port's sharded steps
     run once on meta tensors over a world of fake ranks, counted per
     device; none of the ten kernels): (a) granite-3-2b ``train_4k`` on
     the 16x16 mesh through the dry run's command, in a process of its
     own, its row printed; (b) lm-mesh (a)'s step (granite-3-2b whole,
     float32, 8 x 128, a (1, 1) mesh) counted on meta tensors over a
     world of one fake rank, beside lm-mesh (a)'s own sharded steps on
     the card: its FLOPs must equal ``FlopCounterMode``'s count over one
     more sharded step after the bit checks, its peak must be within
     ``DRYRUN_PEAK_RTOL`` of ``torch.cuda.max_memory_allocated`` over the
     first (above what the process held before the sharded model was
     built), printed with ``HBM_PER_CHIP``
     beside the card's ``total_memory`` and the roofline bound (FP32
     peak) beside lm-mesh (a)'s warm sharded steps; the 16x16 row's
     collective calls and bytes by op printed beside it; printed as the
     ``lm_dryrun`` line;
 10. prints the barriers the FFT-64 and QRD-16 plans place in their
     segments, the ``kernels`` JSON line, the ``lm_serve``, ``lm_train``,
     ``lm_mesh`` and ``lm_dryrun`` lines, the device line and, last, the
     ``{"ok": true, ...}`` line.

Any failure raises, so the script exits non-zero and prints no result.
"""
from __future__ import annotations

import functools
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
# FP32 multiplies and adds that may not be fused into FMAs: one operation
# per lane per clock, half the FMA rate (the QRD kernel's bound)
PEAK_FP32_UNFUSED_OPS_PER_S = 33.5e12
PEAK_BF16_OPS_PER_S = 989e12

# the QRD timing rows, (name, batch, n): QRD-16 x 4096 (the solver's shape),
# QRD-8 x 4096 and QRD-32 x 1024 (the kernel path's random batches), lane
# groups of 16, 8 and 32; also timed in turns by tools/turns.py
QRD_SHAPES = (("qrd", 4096, 16), ("qrd8", 4096, 8), ("qrd32", 1024, 32))


def qrd_batch(rng, batch: int, n: int) -> np.ndarray:
    """The QRD timing rows' input: A + 4 I, A a seeded normal draw."""
    return (rng.standard_normal((batch, n, n)) + 4 * np.eye(n)).astype(
        np.float32)


def qrd_ops(batch: int, n: int) -> int:
    """The FP32 operations the QRD function needs on finite input. Column
    j of Q and all later ones are still zero when column j is projected,
    and their products add nothing (+0.0 plus a zero is +0.0, and a sum
    from +0.0 is never -0.0), so coeff and corr need j terms each; rrow
    and the update of the residual take all n columns (the finished
    columns' residuals are rounding noise, not zero, and reach R)."""
    per_matrix = sum(
        4 * n * j          # coeff[k] and corr[i] over the j columns of Q
        + n                # aj -= corr
        + j                # r[:, j] += coeff
        + 2 * n + 1        # nrm2, INVSQR
        + n                # qj = aj recip
        + 4 * n * n        # rrow and res -= qj rrow
        for j in range(n))
    return batch * per_matrix

REPLACES = {
    "segment": "src/repro/kernels/simt_step.py:146",
    "gather_shared": "src/repro/kernels/simt_step.py:124",
    "scatter_shared": "src/repro/kernels/simt_step.py:210",
    "alu": "src/repro/kernels/simt_alu.py:68",
    "gather": "src/repro/kernels/simt_step.py:53",
    "scatter": "src/repro/kernels/simt_step.py:93",
    "dot": "src/repro/kernels/wavefront_dot.py:33",
    "fft": "src/repro/kernels/fft_r2.py:68",
    "qrd": "src/repro/kernels/mgs_qrd.py:61",
    "flash": "src/repro/kernels/flash_attention.py:76",
}
SOURCES = {
    "segment": "src/repro_torch/kernels/csrc/segment.cu",
    "gather_shared": "src/repro_torch/kernels/csrc/gmem.cu",
    "scatter_shared": "src/repro_torch/kernels/csrc/gmem.cu",
    "alu": "src/repro_torch/kernels/csrc/alu.cu",
    "gather": "src/repro_torch/kernels/csrc/smem.cu",
    "scatter": "src/repro_torch/kernels/csrc/smem.cu",
    "dot": "src/repro_torch/kernels/csrc/dot.cu",
    "fft": "src/repro_torch/kernels/csrc/fft.cu",
    "qrd": "src/repro_torch/kernels/csrc/qrd.cu",
    "flash": "src/repro_torch/kernels/csrc/flash.cu",
}
# the kernels each path must launch
PATH_KERNELS = {
    "main-path": ("segment", "gather_shared", "scatter_shared"),
    "step-path": ("alu", "gather", "scatter", "gather_shared",
                  "scatter_shared"),
    "trace-path": ("alu", "gather", "scatter"),
    "merged-path": ("segment", "gather_shared", "scatter_shared", "alu",
                    "gather", "scatter"),
    "fleet-path": ("segment", "gather_shared", "scatter_shared", "alu",
                   "gather", "scatter"),
    "serve-path": ("segment",),
    "kernel-path": ("dot", "fft", "qrd", "flash"),
}
# the flash kernel against its plain version (float32: another summation
# order than the plain version's matmul; bfloat16: one ulp of the value)
FLASH_ATOL = 2e-5
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-5
# the QRD solver against numpy.linalg.solve in float64: a backward-stable
# solve in float32 is off by about eps * cond(A) * max|x| (eps = 2**-24),
# and some of 4096 random systems A + 4 I are nearly singular, so each
# system is held to SOLVE_K times that
SOLVE_K = 4.0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def words_equal(name: str, got, want) -> int:
    """Assert two word tensors are equal; return the largest absolute
    difference of the words (0)."""
    import torch

    g = got.to(torch.int64).cpu()
    w = want.to(torch.int64).cpu()
    diff = (g != w)
    if diff.any():
        idx = diff.nonzero()[:5].tolist()
        raise AssertionError(f"{name}: {int(diff.sum())} words differ from "
                             f"the plain version, first at {idx}")
    return int((g - w).abs().max()) if g.numel() else 0


def cuda_time_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over ``iters`` calls after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def cuda_device_ms(fn, iters: int = 50) -> float:
    """Mean milliseconds per call on the card alone: a sleep kernel holds
    the stream while the host queues the ``iters`` calls, so they run
    back to back and the host's cost between them is hidden. (A call that
    synchronises with the host is timed as ``cuda_time_ms`` times it.)"""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    queue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
    torch.cuda._sleep(int(2 * queue_ms * _sleep_cycles_per_ms()) + 100_000)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


@functools.lru_cache(maxsize=None)
def _sleep_cycles_per_ms() -> float:
    import torch

    start, stop = (torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
    start.record()
    torch.cuda._sleep(20_000_000)
    stop.record()
    torch.cuda.synchronize()
    return 20_000_000 / start.elapsed_time(stop)


class Phases:
    """Wall time per phase: the host clock around each, with the card
    synchronized before and after."""

    def __init__(self):
        self.ms: dict[str, float] = {}

    def run(self, name: str, fn):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        self.ms[name] = (time.perf_counter() - t0) * 1e3
        print(f"phase {name}: ok ({self.ms[name]:.1f} ms)", flush=True)
        return out


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_segment(rng, dev) -> int:
    import torch
    from repro_torch.core import SMConfig
    from repro_torch.core.executor import apply_segment_rows
    from repro_torch.kernels import fuzz
    from repro_torch.kernels.simt_step import segment_barriers, simt_segment

    worst = 0
    cases = [(SMConfig(), 4, 3072, None, 600),
             (SMConfig(n_threads=256, dim_x=16), 3, 1024, 1000, 400),
             (SMConfig(n_threads=96, dim_x=8), 2, 64, None, 400)]
    # FP32 MUL and DOT over products around 2**-126 (tininess after
    # rounding: lanes 0-3 of R3 hold 0x3F7FFFFF x 0x00800000 with each sign)
    tiny = np.array([[1, 3, 2, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 32, 16],
                     [6, 15, 2, 4, 1, 2, 0, 0, 0, 0, 0, 0, 0, 32, 16],
                     [6, 15, 2, 5, 1, 2, 0, 0, 0, 0, 1, 6, 0, 32, 16]],
                    np.int32)
    cases.append((SMConfig(), 3, 64, None, tiny))
    for cfg, n, depth, bound, n_rows in cases:
        if isinstance(n_rows, int):
            rows = fuzz.random_rows(rng, n_rows, n_threads=cfg.n_threads)
            regs, shmem = fuzz.random_state(rng, n, depth)
        else:
            rows = n_rows
            regs, shmem = fuzz.random_state(rng, n, depth)
            regs[:, :, 1], regs[:, :, 2] = fuzz.tiny_product_words(
                rng, (n, 512))
        args = [torch.from_numpy(a.view(np.int32)).to(dev)
                for a in (regs, shmem)]
        oob = torch.from_numpy(rng.random(n) < 0.2).to(dev)
        bidx = torch.from_numpy(rng.integers(0, 99, n).astype(np.int32)).to(dev)
        pidx = torch.from_numpy(rng.integers(0, 9, n).astype(np.int32)).to(dev)
        got = simt_segment(cfg, torch.from_numpy(rows).to(dev), bidx, pidx,
                           args[0], args[1], oob, shmem_depth=bound)
        want = apply_segment_rows(cfg, rows, bidx, pidx, args[0], args[1],
                                  oob, shmem_depth=bound)
        for name, g, w in zip(("regs", "shmem", "oob"), got, want):
            worst = max(worst, words_equal(f"segment {name}", g, w))
    # the tininess case itself: the exact products are 2**-126 - 2**-150
    if got[0][0, :4, 3].tolist() != [0, -2**31, -2**31, 0]:
        raise AssertionError(f"segment MUL.FP32 0x3F7FFFFF x 0x00800000: "
                             f"{got[0][0, :4, 3].tolist()}")
    # hazard-dense rows (snooped rd == ra, LOD right after STO, INVSQR
    # right after a write to its source, DOT over snooped operands) with
    # the bits segment_barriers places, the first in two chunks
    for cfg, n, depth, bound, n_rows in (
            (SMConfig(), 4, 3072, None, 700),
            (SMConfig(n_threads=96, dim_x=8), 2, 64, 40, 400)):
        rows = fuzz.random_rows(rng, n_rows, n_threads=cfg.n_threads,
                                hazards=True)
        bits = torch.from_numpy(segment_barriers(rows)).to(dev)
        worst = max(worst, hold_segment(
            rng, dev, "hazards", cfg, rows, torch.from_numpy(rows).to(dev),
            bits, n, depth, bound))
    # every fused item of the FFT-64, QRD-16 and SAXPY plans, with the
    # plan's own bits
    for name, plan in path_plans().items():
        table = plan.device_table(dev)
        bits = plan.device_barriers(dev)
        for start, stop in (p for k, p in plan.items if k == "fused"):
            worst = max(worst, hold_segment(
                rng, dev, name, plan.cfg, plan.sched.table[start:stop],
                table[start:stop], bits[start:stop], 4, 3072, None))
    return worst


def hold_segment(rng, dev, what, cfg, rows_np, rows, bits, n, depth,
                 bound) -> int:
    """The segment kernel with ``bits`` against its plain version on a
    random ``n``-SM wave; returns the largest word difference (0)."""
    import torch
    from repro_torch.core.executor import apply_segment_rows
    from repro_torch.kernels import fuzz
    from repro_torch.kernels.simt_step import simt_segment

    regs, shmem = (torch.from_numpy(a.view(np.int32)).to(dev)
                   for a in fuzz.random_state(rng, n, depth))
    oob = torch.from_numpy(rng.random(n) < 0.2).to(dev)
    bidx = torch.from_numpy(rng.integers(0, 99, n).astype(np.int32)).to(dev)
    pidx = torch.from_numpy(rng.integers(0, 9, n).astype(np.int32)).to(dev)
    got = simt_segment(cfg, rows, bidx, pidx, regs, shmem, oob,
                       shmem_depth=bound, barriers=bits)
    want = apply_segment_rows(cfg, rows_np, bidx, pidx, regs, shmem, oob,
                              shmem_depth=bound)
    return max(words_equal(f"segment {what} {name}", g, w)
               for name, g, w in zip(("regs", "shmem", "oob"), got, want))


def path_plans() -> dict:
    """The megakernel plans of the main path's three programs."""
    from repro_torch.core import SMConfig, compile_megakernel
    from repro_torch.core.programs import qrd_program
    from repro_torch.core.programs.fft import fft_program
    from repro_torch.core.programs.saxpy import saxpy_grid_program

    return {"fft64": compile_megakernel(fft_program(64), SMConfig(
                max_steps=200_000)),
            "qrd16": compile_megakernel(qrd_program(), SMConfig(
                imem_depth=1024, max_steps=200_000)),
            "saxpy4096": compile_megakernel(saxpy_grid_program(4096, 512),
                                            SMConfig(max_steps=10_000))}


def barrier_counts() -> dict:
    """Barriers per wave that the FFT-64 and QRD-16 plans place in their
    one segment (before a read phase, before a write phase), beside the
    two per row of a kernel that places them on every row."""
    from repro_torch.kernels.simt_step import (BARRIER_BEFORE_READ,
                                               BARRIER_BEFORE_WRITE)

    out = {}
    for name, plan in path_plans().items():
        if name == "saxpy4096":
            continue
        bits = plan.barriers
        out[name] = dict(
            rows=int(bits.shape[0]),
            before_read=int((bits & BARRIER_BEFORE_READ != 0).sum()),
            before_write=int((bits & BARRIER_BEFORE_WRITE != 0).sum()),
            every_row=2 * int(bits.shape[0]))
        out[name]["total"] = (out[name]["before_read"]
                              + out[name]["before_write"])
    return out


def check_gmem(rng, dev) -> tuple[int, int]:
    """GLD and GST against their plain versions: the tile forms over
    random lanes, then the row kernels (``check_gmem_rows``)."""
    import torch
    from repro_torch.kernels.simt_step import (
        gather_shared_plain, scatter_shared_plain, simt_gather_shared,
        simt_scatter_shared)

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    worst_g = worst_s = 0
    for n, gdepth, span in ((4, 12304, 12304), (4, 512, 37), (7, 4096, 3),
                            (4, 1 << 20, 1 << 20)):
        gmem = t(rng.integers(-2**31, 2**31, gdepth).astype(np.int32))
        addr = t(rng.integers(0, span, (n, 512)).astype(np.int32))
        mask = t(rng.random((n, 512)) < 0.7)
        vals = t(rng.integers(-2**31, 2**31, (n, 512)).astype(np.int32))
        worst_g = max(worst_g, words_equal(
            "gather_shared", simt_gather_shared(gmem, addr, mask, vals),
            gather_shared_plain(gmem, addr, mask, vals)))
        worst_s = max(worst_s, words_equal(
            "scatter_shared", simt_scatter_shared(gmem, addr, vals, mask),
            scatter_shared_plain(gmem, addr, vals, mask)))
    rows_g, rows_s = check_gmem_rows(rng, dev)
    return max(worst_g, rows_g), max(worst_s, rows_s)


def check_gmem_rows(rng, dev) -> tuple[int, int]:
    """The GLD and GST row kernels against their plain row versions on the
    same card state: fuzzed rows (guarded words, partial shapes,
    addresses in and out of the image), half of them snooped with the
    destination as their own address source, at the main path's wave (4
    SMs, the SAXPY-4096 image of 12304 words), at 16 SMs with addresses
    on 37 words (collisions across SMs), and at one SM over a 2**20-word
    image, whose GST claims live in device memory."""
    import torch
    from repro_torch.core import SMConfig
    from repro_torch.core.executor import FusedRow
    from repro_torch.kernels import fuzz
    from repro_torch.kernels.simt_step import (gld_row_plain, gst_row_plain,
                                               simt_gld_row, simt_gst_row)

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)  # noqa: E731
    worst = {8: 0, 9: 0}
    for n, gdepth, span, n_rows in ((4, 12304, None, 200), (16, 4096, 37, 60),
                                    (1, 1 << 20, None, 40)):
        image = t(fuzz.random_f32_words(rng, (gdepth,)))
        for fields in fuzz.random_rows(rng, n_rows, sels=(8, 9)):
            if rng.random() < 0.5:           # x = 1, ra = rd, an ext_a
                fields[7], fields[4] = 1, fields[3]
                fields[8] = rng.integers(0, 32)
            row = FusedRow.from_fields(fields)
            n_threads = int(rng.choice([512, 200]))
            cfg = SMConfig(n_threads=n_threads, dim_x=n_threads)
            regs, _ = fuzz.random_state(rng, n, min(gdepth, 12304))
            if gdepth > 12304:
                regs[:, :, 0] = rng.integers(-8, gdepth + 8, (n, 512))
            if span:
                regs[:, :, 1] = rng.integers(0, span, (n, 512))
            regs = t(regs)
            oob = torch.from_numpy(rng.random(n) < 0.3).to(dev)
            if row.sel == 8:
                got = simt_gld_row(cfg, row, regs.clone(), image,
                                   oob.clone())
                want = gld_row_plain(cfg, row, regs, image, oob)
                parts = ("regs", "oob")
            else:
                got = simt_gst_row(cfg, row, regs, image.clone(),
                                   oob.clone())
                want = gst_row_plain(cfg, row, regs, image, oob)
                parts = ("gmem", "oob")
            for what, g, w in zip(parts, got, want):
                worst[row.sel] = max(worst[row.sel], words_equal(
                    f"{'GLD' if row.sel == 8 else 'GST'} row {what} "
                    f"{fields.tolist()}", g, w))
    return worst[8], worst[9]


def check_per_op(rng, dev) -> dict[str, int]:
    """The step path's ALU, LOD and STO kernels against their plain
    versions: the tile forms over every op x type with NaN, infinite and
    denormal words, and collisions and wild disabled addresses at depths
    64, 1024, 3072; then the row kernels (``check_rows``)."""
    import torch
    from repro_torch.kernels import fuzz
    from repro_torch.kernels.simt_alu import alu_plain, simt_alu
    from repro_torch.kernels.simt_step import (
        gather_plain, scatter_plain, simt_gather, simt_scatter)

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    worst = {"alu": 0, "gather": 0, "scatter": 0}
    for n in (4, 3):
        a = fuzz.random_f32_words(rng, (n, 512))
        b = fuzz.random_f32_words(rng, (n, 512))
        raw = rng.random((n, 512)) < 0.2
        a[raw] = rng.integers(0, 1 << 32, int(raw.sum()), dtype=np.uint64)
        a, b = t(a.view(np.int32)), t(b.view(np.int32))
        mask = t(rng.random((n, 512)) < 0.7)
        old = t(rng.integers(-2**31, 2**31, (n, 512)).astype(np.int32))
        for op in range(1, 10):
            for typ in range(3):
                worst["alu"] = max(worst["alu"], words_equal(
                    f"alu op={op} typ={typ}",
                    simt_alu(op, typ, a, b, mask, old),
                    alu_plain(op, typ, a, b, mask, old)))
    # FP32 MUL around 2**-126 (x86 detects tininess after rounding)
    a, b = (t(x.view(np.int32)) for x in fuzz.tiny_product_words(rng, (4, 512)))
    mask = torch.ones((4, 512), dtype=torch.bool, device=dev)
    old = torch.zeros((4, 512), dtype=torch.int32, device=dev)
    got = simt_alu(3, 2, a, b, mask, old)
    worst["alu"] = max(worst["alu"], words_equal(
        "alu MUL.FP32 near 2**-126", got, alu_plain(3, 2, a, b, mask, old)))
    if got[0, :4].tolist() != [0, -2**31, -2**31, 0]:
        raise AssertionError(f"alu MUL.FP32 0x3F7FFFFF x 0x00800000: "
                             f"{got[0, :4].tolist()}")
    for depth in (64, 1024, 3072):
        for span in (depth, 37, 2):
            mem = t(rng.integers(-2**31, 2**31, (4, depth)).astype(np.int32))
            addr = t(rng.integers(0, span, (4, 512)).astype(np.int32))
            mask = t(rng.random((4, 512)) < 0.7)
            vals = t(rng.integers(-2**31, 2**31, (4, 512)).astype(np.int32))
            worst["gather"] = max(worst["gather"], words_equal(
                f"gather depth={depth}", simt_gather(mem, addr, mask, vals),
                gather_plain(mem, addr, mask, vals)))
            # disabled lanes carry addresses far outside the image
            wild = torch.where(mask, addr, t(rng.integers(
                -2**31, 2**31, (4, 512)).astype(np.int32)))
            worst["scatter"] = max(worst["scatter"], words_equal(
                f"scatter depth={depth}", simt_scatter(mem, wild, vals, mask),
                scatter_plain(mem, wild, vals, mask)))
    worst_rows = check_rows(rng, dev)
    return {k: max(worst[k], worst_rows.get(k, 0)) for k in worst}


def check_rows(rng, dev) -> dict[str, int]:
    """The ALU, LOD and STO row kernels against their plain row versions
    on the same card state: fuzzed rows (every ALU op and type, guarded
    words,
    partial shapes, addresses in and out of the bound), half of them
    snooped with the destination as their own source, at the step path's
    shape (512 threads, 3072 words) and at a partial block (96 threads,
    a 40-word bound on a 64-word image)."""
    import torch
    from repro_torch.core import SMConfig
    from repro_torch.core.executor import FusedRow
    from repro_torch.kernels import fuzz
    from repro_torch.kernels.simt_alu import alu_row_plain, simt_alu_row
    from repro_torch.kernels.simt_step import (lod_row_plain, simt_lod_row,
                                               simt_sto_row, sto_row_plain)

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)  # noqa: E731
    worst = {"alu": 0, "gather": 0, "scatter": 0}
    for n_threads, width, bound in ((512, 3072, None), (96, 64, 40)):
        cfg = SMConfig(n_threads=n_threads, dim_x=n_threads)
        depth = bound or width
        for sel, name in ((1, "alu"), (2, "gather"), (3, "scatter")):
            for fields in fuzz.random_rows(rng, 150, sels=(sel,),
                                           n_threads=n_threads):
                if rng.random() < 0.5:       # x = 1, ra = rd, an ext_a
                    fields[7], fields[4] = 1, fields[3]
                    fields[8] = rng.integers(0, 32)
                row = FusedRow.from_fields(fields)
                regs, shmem = (t(a) for a in fuzz.random_state(rng, 4, width))
                oob = torch.from_numpy(rng.random(4) < 0.3).to(dev)
                if sel == 1:
                    worst[name] = max(worst[name], words_equal(
                        f"alu row {fields.tolist()}",
                        simt_alu_row(cfg, row, regs.clone()),
                        alu_row_plain(cfg, row, regs)))
                    continue
                if sel == 2:
                    got = simt_lod_row(cfg, row, regs.clone(), shmem,
                                       oob.clone(), depth)
                    want = lod_row_plain(cfg, row, regs, shmem, oob, depth)
                    parts = ("regs", "oob")
                else:
                    got = simt_sto_row(cfg, row, regs, shmem.clone(),
                                       oob.clone(), depth)
                    want = sto_row_plain(cfg, row, regs, shmem, oob, depth)
                    parts = ("shmem", "oob")
                for what, g, w in zip(parts, got, want):
                    worst[name] = max(worst[name], words_equal(
                        f"{name} row {what} {fields.tolist()}", g, w))
    return worst


def check_kernel_layer(rng, dev) -> tuple[dict[str, float], float, float]:
    """The kernel layer's kernels against their plain versions: dot over
    fuzzed words and over products and sums around 2**-126, with random
    masks, in both modes at 1...4096 SMs, FFT at every N =
    2...16384 in both output orders over row counts that fill no whole
    CTA, QRD at n = 5, 8, 16, 31, 32 over 64 and 37 matrices, with
    non-finite input (all ``==``, NaNs as one word), and flash causal and
    not, float32 and bfloat16, at D = 1, 33, 64, 96, 128 with blocks from
    8 to 256 and S not a multiple of the kernel's 64-row tiles, on finite
    input and with NaNs and infinities in k and v (the same non-finite
    places, the rest within FLASH_ATOL and one bf16 ulp), and bfloat16
    flash at (32, 1024, 128) causal. Returns the largest error of each
    (float32 for flash), the largest bfloat16 flash error and that at
    (32, 1024, 128)."""
    import torch
    from repro_torch.kernels import fuzz
    from repro_torch.kernels.fft_r2 import fft_r2, fft_r2_plain
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.mgs_qrd import mgs_qrd, mgs_qrd_plain
    from repro_torch.kernels.wavefront_dot import (wavefront_dot,
                                                   wavefront_dot_plain)

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    words = lambda x: x.view(torch.int32)  # noqa: E731
    worst = {"dot": 0, "fft": 0, "qrd": 0, "flash": 0.0}
    # 1, 3 and 129 SMs leave the kernel's last CTA (4 SMs) partial; the
    # second draw puts DOT products and SUM sums around 2**-126
    for n_sm in (1, 3, 8, 24, 129, 4096):
        for mode in (0, 1):
            tiny = fuzz.tiny_product_words(rng, (2, n_sm, 512))
            for what, (a, b) in (
                    ("fuzzed", (fuzz.random_f32_words(rng, (n_sm, 512))
                                for _ in range(2))),
                    ("tiny", (tiny[0][0], tiny[1][0]) if mode == 0
                     else tiny[1])):
                a, b = (t(x.view(np.float32)) for x in (a, b))
                mask = rng.random((n_sm, 512)) < 0.6
                mask[:, 16:32] = False    # an all-off wavefront per SM
                mask = t(mask)
                worst["dot"] = max(worst["dot"], words_equal(
                    f"dot {what} n_sm={n_sm} mode={mode}",
                    words(wavefront_dot(a, b, mask, mode, block_sm=1)),
                    words(wavefront_dot_plain(a, b, mask, mode))))
    # a warp per tile of max(1, 256 / N) rows and eight tiles per CTA up
    # to N = 1024, a CTA per row above: 37 and 5 rows fill no whole CTA
    for log2n in range(1, 15):
        n = 1 << log2n
        rows = 37 if n <= 4096 else 5
        re, im = (t(rng.standard_normal((rows, n)).astype(np.float32))
                  for _ in range(2))
        for natural in (True, False):
            for g, w in zip(fft_r2(re, im, block_b=1, natural=natural),
                            fft_r2_plain(re, im, natural)):
                worst["fft"] = max(worst["fft"], words_equal(
                    f"fft N={n} natural={natural}", words(g), words(w)))
    # NaNs compare as one word: where the kernel and the plain version
    # both compute one, its payload is the arithmetic's
    one_nan = lambda x: torch.where(torch.isnan(x), float("nan"), x)  # noqa: E731
    # 37 matrices leave lane groups with no matrix in the last CTA
    for n in (5, 8, 16, 31, 32):
        for batch in (64, 37):
            a = rng.standard_normal((batch, n, n)).astype(np.float32)
            # matrices 1-4: an infinity, a NaN, a zero column (norm 0, so
            # q_j = 0 * inf) and a -inf: the reference's NaN masks
            a[1, 0, 0], a[2, n - 1, n // 2] = np.inf, np.nan
            a[4, 1, n - 1] = -np.inf
            a[3, :, n // 2] = 0.0
            a = t(a)
            for g, w in zip(mgs_qrd(a, block_b=1), mgs_qrd_plain(a)):
                worst["qrd"] = max(worst["qrd"], words_equal(
                    f"qrd n={n} x {batch}", words(one_nan(g)),
                    words(one_nan(w))))
    def flash_close(what, got, want, dtype):
        """NaN, +inf and -inf at the same places, the finite rest within
        FLASH_ATOL (float32) or one bf16 ulp; returns the largest error."""
        got, want = got.float(), want.float()
        for where in (torch.isnan, torch.isposinf, torch.isneginf):
            if not torch.equal(where(got), where(want)):
                raise AssertionError(f"{what}: {where.__name__} differs")
        fin = torch.isfinite(want)
        got, want = got[fin], want[fin]
        err = float((got - want).abs().max()) if fin.any() else 0.0
        if dtype == torch.float32:
            if not err <= FLASH_ATOL:
                raise AssertionError(f"{what}: {err} > {FLASH_ATOL}")
        else:
            torch.testing.assert_close(got, want, rtol=BF16_RTOL,
                                       atol=BF16_ATOL, msg=what)
        return err

    bf16 = 0.0
    for bh, S, D, blk_q, blk_k in ((3, 256, 64, 64, 32),
                                   (2, 512, 128, 128, 128),
                                   (4, 128, 64, 32, 64),
                                   (2, 96, 33, 16, 48),
                                   (2, 256, 1, 16, 256),
                                   (2, 320, 96, 64, 16),
                                   (1, 512, 128, 256, 256),
                                   (2, 80, 128, 16, 16),
                                   (2, 192, 64, 8, 24)):
        qkv = [rng.standard_normal((bh, S, D)).astype(np.float32)
               for _ in range(3)]
        # and with a NaN or an infinity in v at keys in some rows' future
        # (p = 0 times it where the row's live key blocks hold it, not read
        # past them) and in k (spoils the rows that see its key unmasked)
        for bad in (None, np.nan, np.inf, -np.inf):
            q, k, v = (x.copy() for x in qkv)
            if bad is not None:
                v[0, S // 2 + 3, 0], v[-1, 5, D - 1] = bad, bad
                v[-1, S - 1, D // 2], k[0, S // 3, 0] = bad, bad
            q, k, v = (t(x) for x in (q, k, v))
            for causal in (True, False):
                for dtype in (torch.float32, torch.bfloat16):
                    qc, kc, vc = (x.to(dtype) for x in (q, k, v))
                    err = flash_close(
                        f"flash {(bh, S, D)} blocks {blk_q} x {blk_k} "
                        f"causal={causal} {dtype} bad={bad}",
                        flash_attention(qc, kc, vc, causal=causal,
                                        blk_q=blk_q, blk_k=blk_k),
                        flash_attention_plain(qc, kc, vc, causal, blk_q,
                                              blk_k), dtype)
                    if dtype == torch.float32:
                        worst["flash"] = max(worst["flash"], err)
                    else:
                        bf16 = max(bf16, err)
    # bfloat16 at the timing row's shape, (32, 1024, 128) causal
    q, k, v = (t(rng.standard_normal((32, 1024, 128)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    bf16_timed = flash_close(
        "flash (32, 1024, 128) causal bfloat16",
        flash_attention(q, k, v), flash_attention_plain(q, k, v, True, 128,
                                                        128), torch.bfloat16)
    return worst, max(bf16, bf16_timed), bf16_timed


# ---------------------------------------------------------------------------
# phase 3: the paths
# ---------------------------------------------------------------------------

def same_state(name: str, got, want) -> None:
    """Two launches' architectural state is equal, word for word."""
    from repro_torch.convert import launch_result_to_numpy

    g, w = launch_result_to_numpy(got), launch_result_to_numpy(want)
    for k in ("regs", "shmem", "gmem", "oob"):
        if not np.array_equal(g[k], w[k]):
            raise AssertionError(f"{name}: {k} differs "
                                 f"({int((g[k] != w[k]).sum())} words)")


def on_card(fn):
    """Run ``fn`` on the card with the launch counts set to 0 just before
    and read just after; returns (its result, the counts + wall ms)."""
    import torch
    from repro_torch.kernels import build

    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(build.launches,
                     wall_ms=(time.perf_counter() - t0) * 1e3)


def check_path(name: str, per: dict) -> dict[str, int]:
    """Sum a path's launch counts over its workloads; fail if one of the
    path's kernels never launched in it."""
    counts = {k: sum(w["launches"][k] for w in per.values())
              for k in SOURCES}
    for k in PATH_KERNELS[name]:
        if counts[k] == 0:
            raise AssertionError(f"kernel {k} never launched on the {name}")
    return counts

def same_launch(name: str, gpu, cpu) -> None:
    same_state(f"{name} (card against the plain versions on the host)",
               gpu, cpu)
    for k in ("cycles", "steps", "halted", "engine", "engine_fallback"):
        if getattr(gpu, k) != getattr(cpu, k):
            raise AssertionError(f"{name}: {k} {getattr(gpu, k)} != "
                                 f"{getattr(cpu, k)}")
    for k in ("wave_cycles", "cycles_by_class"):
        if not np.array_equal(getattr(gpu, k), getattr(cpu, k)):
            raise AssertionError(f"{name}: {k} differs")
    if profile_without_reason(gpu) != profile_without_reason(cpu):
        raise AssertionError(f"{name}: profile() differs")


def profile_without_reason(res) -> dict:
    """``res.profile()`` without a fleet's ``placement_reason``, the one
    field that names the devices the launch saw."""
    p = res.profile()
    if "fleet" in p:
        p["fleet"] = {k: v for k, v in p["fleet"].items()
                      if k != "placement_reason"}
    return p


def main_path(rng):
    """FFT-64, QRD-16 and SAXPY-4096 on the megakernel engine, on the card
    and on the host; returns the launch counts of the card runs and the
    per-workload records."""
    from repro_torch.core import DeviceConfig, SMConfig
    from repro_torch.core.programs import (launch_saxpy, run_fft_batch,
                                           run_qrd_batch)

    per = {}

    # FFT-64 over 64 blocks (16 waves); "auto" resolves to the megakernel
    xs = (rng.standard_normal((64, 64))
          + 1j * rng.standard_normal((64, 64))).astype(np.complex64)
    dev = DeviceConfig(n_sms=4, sm=SMConfig(max_steps=200_000))
    (X, res), got = on_card(lambda: run_fft_batch(xs, device=dev))
    Xc, res_c = run_fft_batch(xs, device=DeviceConfig(
        n_sms=4, backend="cpu", sm=SMConfig(max_steps=200_000)))
    assert res.engine == "megakernel" and res.engine_fallback is None
    same_launch("fft64", res, res_c)
    ref = np.fft.fft(xs, axis=1)
    np.testing.assert_allclose(X, ref, rtol=0, atol=2e-5 * np.abs(ref).max())
    assert res.halted and not bool(res.oob.any())
    assert got["segment"] > 0, got
    per["fft64"] = dict(launches=got, cycles=res.cycles, waves=res.n_waves)

    # QRD-16 over 16 blocks (the unrolled program needs a 1024-word I-MEM)
    As = rng.standard_normal((16, 16, 16)).astype(np.float32)
    sm = SMConfig(imem_depth=1024, max_steps=200_000)
    (Q, R, res), got = on_card(lambda: run_qrd_batch(
        As, device=DeviceConfig(n_sms=4, sm=sm)))
    _, _, res_c = run_qrd_batch(As, device=DeviceConfig(
        n_sms=4, backend="cpu", sm=sm))
    assert res.engine == "megakernel" and res.engine_fallback is None
    same_launch("qrd16", res, res_c)
    check_qr(Q.astype(np.float64), R.astype(np.float64),
             As.astype(np.float64))
    assert res.halted and not bool(res.oob.any())
    assert got["segment"] > 0, got
    per["qrd16"] = dict(launches=got, cycles=res.cycles, waves=res.n_waves)

    # the 4096-element SAXPY through GLD/GST, on the megakernel by request
    # ("auto" takes the step engine on so short a program: step-path)
    n = 4096
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    kw = dict(n_sms=4, global_mem_depth=3 * n + 16, engine="megakernel",
              sm=SMConfig(max_steps=10_000))
    (z, res), got = on_card(lambda: launch_saxpy(
        2.5, x, y, device=DeviceConfig(**kw), block=512))
    host_rows = counted_host_backend()
    _, res_c = launch_saxpy(2.5, x, y, device=DeviceConfig(
        **kw, backend=COUNTED_HOST), block=512)
    same_launch("saxpy4096", res, res_c)
    np.testing.assert_allclose(z, 2.5 * x + y, rtol=1e-6)
    assert res.grid == (8,) and res.halted and not bool(res.oob.any())
    assert got["segment"] > 0, got
    # one GLD and GST launch per GLD and GST row the host executed
    for k in ("gather_shared", "scatter_shared"):
        if got[k] != host_rows[k] or not got[k]:
            raise AssertionError(f"saxpy4096: {got[k]} {k} launches on the "
                                 f"card for {host_rows[k]} rows")
    per["saxpy4096"] = dict(launches=got, rows=dict(host_rows),
                            cycles=res.cycles, waves=res.n_waves)
    return check_path("main-path", per), per


def check_qr(Q, R, As) -> None:
    """Q R reproduces A (MGS is backward stable); Q's loss of
    orthogonality grows with the condition number of A, as MGS's does
    (about eps * cond(A), eps = 2**-24)."""
    n = As.shape[-1]
    np.testing.assert_allclose(Q @ R, As, atol=5e-5)
    orth = np.abs(Q.transpose(0, 2, 1) @ Q - np.eye(n)).max(axis=(1, 2))
    tol = np.maximum(5e-5, 16 * 2.0**-24 * np.linalg.cond(As))
    if not (orth <= tol).all():
        b = int(np.argmax(orth - tol))
        raise AssertionError(f"QRD-{n}: Q^T Q of matrix {b} is {orth[b]} "
                             f"from I, above {tol[b]}")


def spd_batch(rng, count: int):
    """Symmetric positive-definite 16x16 matrices and right-hand sides."""
    g = rng.standard_normal((count, 16, 16)).astype(np.float32)
    As = (g @ g.transpose(0, 2, 1) + 16 * np.eye(16)).astype(np.float32)
    return As, rng.standard_normal((count, 16)).astype(np.float32)


def step_path(rng):
    """The step engine at full width: SAXPY-4096 through "auto", FFT-64 x
    64, QRD-16 x 16, the Cholesky-16 solve x 16 and the fused reduction of
    1024 elements, each on the card and on the host. Returns the path's
    launch counts, the per-workload records and the card's results of
    FFT-64 and QRD-16 (for the trace path)."""
    from repro_torch.core import DeviceConfig, SMConfig
    from repro_torch.core.programs import (
        cholesky_imem_depth, launch_reduction, launch_saxpy,
        run_cholesky_batch, run_fft_batch, run_qrd_batch)

    per, keep = {}, {}
    host_rows = counted_host_backend()

    def both(name, fn, **kw):
        """``fn(DeviceConfig)`` on the card and on the host; the card must
        launch ``alu``, ``gather``, ``scatter``, ``gather_shared`` and
        ``scatter_shared`` once per ALU, LOD, STO, GLD and GST row the
        host executed."""
        (out, res), got = on_card(lambda: fn(DeviceConfig(n_sms=4, **kw)))
        host_rows.update(dict.fromkeys(host_rows, 0))
        out_c, res_c = fn(DeviceConfig(n_sms=4, backend=COUNTED_HOST, **kw))
        same_launch(name, res, res_c)
        assert res.halted and not bool(res.oob.any()), name
        for k, n_rows in host_rows.items():
            if got[k] != n_rows:
                raise AssertionError(f"{name}: {got[k]} {k} launches on the "
                                     f"card for {n_rows} rows")
        per[name] = dict(launches=got, rows=dict(host_rows),
                         cycles=res.cycles, waves=res.n_waves,
                         steps=res.steps)
        return out, res

    # the README quickstart: SAXPY-4096, grid 8 x 512, engine "auto"
    n = 4096
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    z, res = both("saxpy4096", lambda d: launch_saxpy(2.5, x, y, device=d,
                                                       block=512),
                  global_mem_depth=3 * n + 16, sm=SMConfig(max_steps=10_000))
    assert res.engine == "step", res.engine
    assert res.engine_fallback == "megakernel-too-small", res.engine_fallback
    assert res.grid == (8,)
    np.testing.assert_allclose(z, 2.5 * x + y, rtol=1e-6)

    # FFT-64 over 64 blocks
    xs = (rng.standard_normal((64, 64))
          + 1j * rng.standard_normal((64, 64))).astype(np.complex64)
    X, res = both("fft64", lambda d: run_fft_batch(xs, device=d),
                  engine="step", sm=SMConfig(max_steps=200_000))
    ref = np.fft.fft(xs, axis=1)
    np.testing.assert_allclose(X, ref, rtol=0, atol=2e-5 * np.abs(ref).max())
    keep["fft64"] = (xs, res, per["fft64"]["rows"])

    # QRD-16 over 16 blocks
    As = rng.standard_normal((16, 16, 16)).astype(np.float32)
    QR, res = both("qrd16", lambda d: (lambda q, r, s: ((q, r), s))(
        *run_qrd_batch(As, device=d)), engine="step",
        sm=SMConfig(imem_depth=1024, max_steps=200_000))
    check_qr(*QR, As)
    keep["qrd16"] = (As, res, per["qrd16"]["rows"])

    # the predicated Cholesky-16 factor + forward solve over 16 blocks
    Ac, bc = spd_batch(rng, 16)
    Ly, res = both("cholesky16_solve", lambda d: (
        lambda el, y_, s: ((el, y_), s))(*run_cholesky_batch(
            Ac, bc, device=d)), engine="step",
        sm=SMConfig(imem_depth=cholesky_imem_depth(True), max_steps=200_000))
    L, yv = Ly
    for b in range(16):
        np.testing.assert_allclose(L[b] @ L[b].T, Ac[b], rtol=0,
                                   atol=1e-4 * np.abs(Ac[b]).max())
        np.testing.assert_allclose(L[b] @ yv[b], bc[b], rtol=0, atol=1e-4)

    # the fused reduction: two programs and a barrier in one launch
    xr = rng.standard_normal(1024).astype(np.float32)
    total, res = both("reduction1024_fused", lambda d: launch_reduction(
        xr, device=d, block=256, fused=True), engine="step",
        global_mem_depth=2048, sm=SMConfig(max_steps=50_000))
    np.testing.assert_allclose(total, xr.astype(np.float64).sum(), rtol=0,
                               atol=1e-4)
    return check_path("step-path", per), per, keep


# the host's plain versions, counting the ALU, LOD, STO, GLD and GST rows
# they execute
COUNTED_HOST = "cpu-counted"
# the row seam's entries and the kernels that run them on the card
SEAM_KERNELS = {"alu_row": "alu", "lod_row": "gather", "sto_row": "scatter",
                "gld_row": "gather_shared", "gst_row": "scatter_shared"}


def counted_host_backend() -> dict[str, int]:
    """Register ``COUNTED_HOST``: the ``"cpu"`` backend whose row seam
    counts its calls; returns the counts (kernel names as keys)."""
    import dataclasses

    from repro_torch.core.executor import (get_execute_backend,
                                           register_backend)

    cpu = get_execute_backend("cpu")
    rows = dict.fromkeys(SEAM_KERNELS.values(), 0)

    def counted(name, fn):
        def row(*args):
            rows[name] += 1
            return fn(*args)
        return row

    register_backend(dataclasses.replace(
        cpu, name=COUNTED_HOST,
        **{seam: counted(k, getattr(cpu, seam))
           for seam, k in SEAM_KERNELS.items()}))
    return rows


def composed_handler(cfg, row):
    """The per-op composition of an ALU, LOD, STO, GLD or GST row, the
    handler body the row seam replaced: the operand and destination
    columns, masks and address arithmetic in PyTorch around the
    tile-form kernel, and a copy of the register file for the ALU's, the
    LOD's and the GLD's result (the GST's tile form copies the image). The
    row seam's yardstick."""
    import torch
    from repro_torch.core.executor import row_eff, row_operand
    from repro_torch.kernels import ref
    from repro_torch.kernels.simt_alu import simt_alu
    from repro_torch.kernels.simt_step import (simt_gather,
                                               simt_gather_shared,
                                               simt_scatter,
                                               simt_scatter_shared)

    d = row.d

    def h_alu(s):
        regs, shmem, gmem, oob = s
        res = simt_alu(d["opcode"], d["typ"],
                       row_operand(row, regs, d["ra"], d["ext_a"]),
                       row_operand(row, regs, d["rb"], d["ext_b"]),
                       row_eff(cfg.n_threads, row, regs),
                       regs[:, :, d["rd"]].contiguous())
        out = regs.clone()
        out[:, :, d["rd"]] = res
        return out, shmem, gmem, oob

    def h_lod(s):
        regs, shmem, gmem, oob = s
        depth = shmem.shape[1]
        m = row_eff(cfg.n_threads, row, regs)
        addr = ref.wrap32(row_operand(row, regs, d["ra"], d["ext_a"])
                          .to(torch.int64) + d["imm"])
        bad = m & ((addr < 0) | (addr >= depth))
        vals = simt_gather(shmem, addr.clamp(0, depth - 1), m & ~bad,
                           regs[:, :, d["rd"]].contiguous())
        out = regs.clone()
        out[:, :, d["rd"]] = vals
        return out, shmem, gmem, oob | bad.any(dim=1)

    def h_sto(s):
        regs, shmem, gmem, oob = s
        depth = shmem.shape[1]
        m = row_eff(cfg.n_threads, row, regs)
        addr = ref.wrap32(row_operand(row, regs, d["ra"], d["ext_a"])
                          .to(torch.int64) + d["imm"])
        bad = m & ((addr < 0) | (addr >= depth))
        shmem = simt_scatter(shmem, addr, regs[:, :, d["rd"]].contiguous(),
                             m & ~bad)
        return regs, shmem, gmem, oob | bad.any(dim=1)

    def h_gld(s):
        regs, shmem, gmem, oob = s
        gdepth = gmem.shape[0]
        m = row_eff(cfg.n_threads, row, regs)
        addr = ref.wrap32(row_operand(row, regs, d["ra"], d["ext_a"])
                          .to(torch.int64) + d["imm"])
        bad = m & ((addr < 0) | (addr >= gdepth))
        vals = simt_gather_shared(gmem, addr.clamp(0, gdepth - 1),
                                  m & ~bad, regs[:, :, d["rd"]].contiguous())
        out = regs.clone()
        out[:, :, d["rd"]] = vals
        return out, shmem, gmem, oob | bad.any(dim=1)

    def h_gst(s):
        regs, shmem, gmem, oob = s
        gdepth = gmem.shape[0]
        m = row_eff(cfg.n_threads, row, regs)
        addr = ref.wrap32(row_operand(row, regs, d["ra"], d["ext_a"])
                          .to(torch.int64) + d["imm"])
        bad = m & ((addr < 0) | (addr >= gdepth))
        gmem = simt_scatter_shared(gmem, addr,
                                   regs[:, :, d["rd"]].contiguous(),
                                   m & ~bad)
        return regs, shmem, gmem, oob | bad.any(dim=1)

    return {1: h_alu, 2: h_lod, 3: h_sto, 8: h_gld, 9: h_gst}[row.sel]


def issue_counts(fn, top: int = 6) -> dict:
    """What one call of ``fn`` issues, after a warm-up call: the kernels
    our wrappers launched (their counts), the PyTorch operations
    dispatched (a TorchDispatchMode), the CUDA kernels and the device
    memory copies and sets the profiler saw, the kernels' summed time on
    the card, and the ``top`` kernels by that time (name, count, ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.kernels import build

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func))
            return func(*args, **(kwargs or {}))

    fn()
    torch.cuda.synchronize()
    before = sum(build.launches.values())
    ops = Ops()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with ops:
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t = by_name.setdefault(e.name, [0, 0.0])
            t[0] += 1
            t[1] += (e.time_range.end - e.time_range.start) / 1e3
    n_card = sum(n for n, _ in by_name.values())
    copies = sum(n for name, (n, _) in by_name.items()
                 if name.startswith(("Memcpy", "Memset")))
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return dict(wrapper_launches=sum(build.launches.values()) - before,
                torch_ops=len(ops.names), ops=sorted(set(ops.names)),
                cuda_kernels=n_card - copies, device_copies=copies,
                kernel_ms=sum(ms for _, ms in by_name.values()),
                top_kernels=[[name[:80], n, ms]
                             for name, (n, ms) in ranked[:top]])


def row_issue(engine: str) -> dict:
    """The first ALU, LOD and STO rows of FFT-64 and the first GLD and GST
    rows of SAXPY-4096 as ``engine`` ("step", "trace" or "megakernel",
    whose handlers run only its global-port rows) dispatches them,
    through the execute stage on the card over a wave of 4 SMs x 512
    threads with a 3072-word shared memory and SAXPY-4096's 12304-word
    global memory: what each row issues (``issue_counts``), and what the
    per-op composition of the same row issues (``composed``). The row
    seam must be one launch and no PyTorch operation."""
    import torch
    from repro_torch.core import (SMConfig, compile_megakernel,
                                  compile_program, device)
    from repro_torch.core.executor import (get_execute_backend,
                                           make_data_handlers, pack_imem)
    from repro_torch.core.programs.fft import fft_program
    from repro_torch.core.programs.saxpy import saxpy_grid_program

    def rows_of(words, cfg):
        if engine == "step":
            issue = device._issue_table(cfg, *pack_imem(words,
                                                        cfg.imem_depth))
            return [issue(pc).row for pc in range(len(words))]
        if engine == "trace":
            return list(compile_program(words, cfg).rows)
        return [r for kind, r in compile_megakernel(words, cfg).items
                if kind == "gmem"]

    fft_cfg = SMConfig(n_threads=32, dim_x=32, max_steps=200_000)
    saxpy_cfg = SMConfig(max_steps=10_000)
    fft_rows = rows_of(fft_program(64).words, fft_cfg)
    saxpy_rows = rows_of(saxpy_grid_program(4096, 512).words, saxpy_cfg)
    dev = torch.device("cuda")
    n = 4
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    state = (torch.zeros((n, 512, 16), dtype=torch.int32, device=dev),
             torch.zeros((n, 3072), dtype=torch.int32, device=dev),
             torch.zeros((3 * 4096 + 16,), dtype=torch.int32, device=dev),
             torch.zeros((n,), dtype=torch.bool, device=dev))
    out = {}
    for sel, name, cfg, rows in ((1, "alu", fft_cfg, fft_rows),
                                 (2, "lod", fft_cfg, fft_rows),
                                 (3, "sto", fft_cfg, fft_rows),
                                 (8, "gld", saxpy_cfg, saxpy_rows),
                                 (9, "gst", saxpy_cfg, saxpy_rows)):
        if engine == "megakernel" and sel < 8:
            continue
        row = next(r for r in rows if r.sel == sel)
        h = make_data_handlers(cfg, get_execute_backend("cuda"), row, idx,
                               idx)[sel]
        out[name] = issue_counts(lambda: h(state))
        out[name]["composed"] = issue_counts(
            lambda: composed_handler(cfg, row)(state))
        if out[name]["wrapper_launches"] != 1 or out[name]["torch_ops"] \
                or out[name]["cuda_kernels"] != 1:
            raise AssertionError(f"an {name} row on the {engine} engine "
                                 f"issued {out[name]}")
    return out


def trace_path(keep):
    """FFT-64 and QRD-16 on the trace engine: word for word the step
    path's runs on the card, counters included, with one ``alu``,
    ``gather`` and ``scatter`` launch per ALU, LOD and STO row the step
    path's host run counted."""
    from repro_torch.convert import launch_result_to_numpy
    from repro_torch.core import DeviceConfig, SMConfig
    from repro_torch.core.programs import run_fft_batch, run_qrd_batch

    per = {}
    runs = {
        "fft64": lambda a: run_fft_batch(a, device=DeviceConfig(
            n_sms=4, engine="trace", sm=SMConfig(max_steps=200_000)))[1],
        "qrd16": lambda a: run_qrd_batch(a, device=DeviceConfig(
            n_sms=4, engine="trace", sm=SMConfig(
                imem_depth=1024, max_steps=200_000)))[2],
    }
    for name, fn in runs.items():
        inputs, step_res, rows = keep[name]
        res, got = on_card(lambda: fn(inputs))
        for k, n_rows in rows.items():
            if got[k] != n_rows:
                raise AssertionError(f"{name}: {got[k]} {k} launches on the "
                                     f"trace engine for {n_rows} rows")
        assert res.engine == "trace"
        g, w = launch_result_to_numpy(res), launch_result_to_numpy(step_res)
        for k in ("regs", "shmem", "gmem", "oob"):
            if not np.array_equal(g[k], w[k]):
                raise AssertionError(f"{name}: trace {k} differs from the "
                                     f"step engine on the card")
        for k in ("cycles", "steps", "halted"):
            assert getattr(res, k) == getattr(step_res, k), (name, k)
        assert np.array_equal(res.cycles_by_class, step_res.cycles_by_class)
        per[name] = dict(launches=got, rows=rows, cycles=res.cycles,
                         waves=res.n_waves)
    return check_path("trace-path", per), per


def merged_path(rng):
    """Heterogeneous grids in merged waves at full width: FFT-64 x 64
    interleaved with QRD-16 x 16 through "auto" (the megakernel), on the
    trace engine and under "length" packing, and the fused reduction of
    1024 elements through "auto". Each runs on the card and on the host
    (``COUNTED_HOST``) and must give equal state, counters and profile,
    ``trace_merge`` included; the card must launch ``alu``, ``gather``,
    ``scatter``, ``gather_shared`` and ``scatter_shared`` once per ALU,
    LOD, STO, GLD and GST row the host executed, and a megakernel run
    its ``segment`` kernel."""
    import dataclasses

    from repro_torch.core import DeviceConfig, SMConfig
    from repro_torch.core.programs import (launch_fft_qrd, launch_reduction,
                                           mixed_device)

    per = {}
    host_rows = counted_host_backend()

    def both(name, fn, engine):
        outs = {}

        def run(backend):
            outs[backend], res = fn(backend)
            return res
        res, _ = counted_pair(name, run, host_rows, per)
        assert res.engine == engine, (name, res.engine)
        assert res.trace_merge is not None, name
        per[name].update(waves=res.n_waves, trace_merge={
            k: v for k, v in res.trace_merge.items() if k != "per_wave"})
        return outs[None], res

    xs = (rng.standard_normal((64, 64))
          + 1j * rng.standard_normal((64, 64))).astype(np.complex64)
    As = rng.standard_normal((16, 16, 16)).astype(np.float32)
    ref = np.fft.fft(xs, axis=1)
    for name, engine, kw in (
            ("fft64_qrd16", "megakernel", {}),
            ("fft64_qrd16_trace", "trace", {"engine": "trace"}),
            ("fft64_qrd16_length", "megakernel", {"packing": "length"})):
        def run(backend, kw=kw):
            dev = mixed_device(64, n_sms=4, backend=backend)
            if "engine" in kw:
                dev = dataclasses.replace(dev, engine=kw["engine"])
            X, Q, R, res = launch_fft_qrd(xs, As, device=dev,
                                          packing=kw.get("packing"))
            return (X, Q, R), res
        (X, Q, R), _ = both(name, run, engine)
        np.testing.assert_allclose(X, ref, rtol=0,
                                   atol=2e-5 * np.abs(ref).max())
        check_qr(Q.astype(np.float64), R.astype(np.float64),
                 As.astype(np.float64))

    xr = rng.standard_normal(1024).astype(np.float32)
    total, _ = both("reduction1024_fused", lambda backend: launch_reduction(
        xr, block=256, fused=True, device=DeviceConfig(
            n_sms=4, global_mem_depth=2048, sm=SMConfig(max_steps=50_000),
            **({"backend": backend} if backend else {}))), "megakernel")
    np.testing.assert_allclose(total, xr.astype(np.float64).sum(), rtol=0,
                               atol=1e-4)
    return check_path("merged-path", per), per


def fft_qrd_grid(xs, As, depth: int) -> dict:
    """``launch_fft_qrd``'s grid as launch keywords: FFT-n x len(xs)
    interleaved with QRD-16 x len(As), each block's shared-memory image of
    ``depth`` words."""
    from repro_torch.core.programs import (fft_kernel, fft_shmem, qrd_kernel,
                                           qrd_shmem)

    gmap: list[int] = []
    for i in range(max(len(xs), len(As))):
        gmap += [0] * (i < len(xs)) + [1] * (i < len(As))
    return dict(programs=[fft_kernel(xs.shape[1]), qrd_kernel()],
                grid_map=gmap,
                shmem=[np.stack([fft_shmem(x, depth) for x in xs]),
                       np.stack([qrd_shmem(a, depth) for a in As])])


def fft_qrd_outputs(res, n: int):
    """The spectra and the Q and R factors in a launch of that grid, as
    ``launch_fft_qrd`` unpacks them."""
    from repro_torch.core.programs.fft import bitrev_indices
    from repro_torch.core.programs.qrd import Q_BASE, R_BASE

    gmap = np.asarray(res.grid_map)
    mem = res.shmem_f32().cpu().numpy()
    f, q = mem[gmap == 0], mem[gmap == 1]
    X = np.empty((f.shape[0], n), np.complex64)
    X[:, bitrev_indices(n)] = f[:, 0:2 * n:2] + 1j * f[:, 1:2 * n:2]
    Q = q[:, Q_BASE:Q_BASE + 256].reshape(-1, 16, 16).transpose(0, 2, 1)
    R = q[:, R_BASE:R_BASE + 256].reshape(-1, 16, 16)
    return X, Q, R


def counted_pair(name: str, run, host_rows: dict, per: dict):
    """``run(backend)`` on the card (``None``: the default ``"cuda"``) and
    on ``COUNTED_HOST``: equal state, counters and profile; the card's
    ``alu``, ``gather``, ``scatter``, ``gather_shared`` and
    ``scatter_shared`` launches once per ALU, LOD, STO, GLD and GST row of
    the host run, and ``segment`` where the megakernel ran. Records the
    run in ``per[name]``; returns both results."""
    res, got = on_card(lambda: run(None))
    host_rows.update(dict.fromkeys(host_rows, 0))
    res_c = run(COUNTED_HOST)
    same_launch(name, res, res_c)
    assert res.halted and not bool(res.oob.any()), name
    for k, n_rows in host_rows.items():
        if got[k] != n_rows:
            raise AssertionError(f"{name}: {got[k]} {k} launches on the "
                                 f"card for {n_rows} rows")
    if res.engine == "megakernel" and not got["segment"]:
        raise AssertionError(f"{name}: no segment launch")
    per[name] = dict(launches=got, rows=dict(host_rows), cycles=res.cycles,
                     engine=res.engine)
    return res, res_c


def fleet_path(rng):
    """The device fleet (``launch_fleet``) at the paper's full sector width,
    4 SMs a device: FFT-64 x 64 interleaved with QRD-16 x 16 on 2 and 4
    devices under both routes (the megakernel's sub-launches) and on 2
    devices on the trace engine, SAXPY-4096 on 2 devices at remote latency
    0 and 7 (the step engine's), and the
    fleet benchmark's two shapes, whose cycles must be
    ``BENCH_fleet.json``'s. Each runs on the card and on the host
    (``counted_pair``), the profile's fleet view and ``host_dispatch``
    included; each grid's state must equal its plain ``launch`` on the
    card on the same engine. Prints each run's placement and its
    reason."""
    import dataclasses

    from repro_torch.core import (DeviceConfig, FleetConfig, SMConfig,
                                  launch, launch_fleet)
    from repro_torch.core.programs import mixed_device
    from repro_torch.core.programs.saxpy import saxpy_grid_program

    per = {}
    host_rows = counted_host_backend()

    def fleet(name, fcfg_of, **kw):
        res, _ = counted_pair(name, lambda b: launch_fleet(fcfg_of(b), **kw),
                              host_rows, per)
        f = res.profile()["fleet"]
        print(f"fleet-path {name}: placement {f['placement']} "
              f"({f['placement_reason']}), blocks per device "
              f"{[d['blocks'] for d in f['per_device']]}", flush=True)
        per[name].update(placement=f["placement"],
                         placement_reason=f["placement_reason"],
                         remote_gmem_cycles=f["remote_gmem_cycles"])
        return res

    def dev(backend, **kw):
        return DeviceConfig(**kw, **({"backend": backend} if backend else {}))

    # FFT-64 x 64 interleaved with QRD-16 x 16, devices of 4 SMs
    xs = (rng.standard_normal((64, 64))
          + 1j * rng.standard_normal((64, 64))).astype(np.complex64)
    As = rng.standard_normal((16, 16, 16)).astype(np.float32)
    grid = fft_qrd_grid(xs, As, 1024)
    plain = {}      # the plain launch of the grid on each engine
    ref = np.fft.fft(xs, axis=1)
    for n_dev, route, engine in ((2, "block", "auto"), (2, "kernel", "auto"),
                                 (4, "block", "auto"), (4, "kernel", "auto"),
                                 (2, "block", "trace")):
        name = f"fft64_qrd16_{n_dev}dev_{route}" \
            + ("_trace" if engine == "trace" else "")
        res = fleet(name, lambda b, n=n_dev, r=route, e=engine: FleetConfig(
            n_devices=n, route=r, device=dataclasses.replace(
                mixed_device(64, n_sms=4, backend=b), engine=e)), **grid)
        if engine not in plain:
            plain[engine] = launch(dataclasses.replace(
                mixed_device(64, n_sms=4), engine=engine), **grid)
        same_state(f"{name} (fleet against its plain launch)", res,
                   plain[engine])
        X, Q, R = fft_qrd_outputs(res, 64)
        np.testing.assert_allclose(X, ref, rtol=0,
                                   atol=2e-5 * np.abs(ref).max())
        check_qr(Q.astype(np.float64), R.astype(np.float64),
                 As.astype(np.float64))

    # SAXPY-4096 on 2 devices, at remote latency 0 and 7
    n = 4096
    x, y = rng.standard_normal((2, n)).astype(np.float32)
    saxpy = dict(program=saxpy_grid_program(n, 512), grid=(8,), block=512,
                 buffers={"x": x, "y": y, "z": np.zeros(n, np.float32),
                          "alpha": np.asarray([2.5], np.float32)})
    skw = dict(n_sms=4, global_mem_depth=3 * n + 16,
               sm=SMConfig(max_steps=10_000))
    plain_saxpy = launch(dev(None, **skw), **saxpy)
    cycles = {}
    for lat in (0, 7):
        name = f"saxpy4096_2dev_numa{lat}"
        res = fleet(name, lambda b, lat=lat: FleetConfig(
            n_devices=2, remote_gmem_latency=lat, device=dev(b, **skw)),
            **saxpy)
        same_state(f"{name} (fleet against its plain launch)", res,
                   plain_saxpy)
        np.testing.assert_allclose(res.buffer("z").cpu().numpy(),
                                   2.5 * x + y, rtol=1e-6)
        cycles[lat] = res.cycles
    assert cycles[7] > cycles[0], cycles

    # the fleet benchmark: FFT-64 x 8 + QRD-16 x 4 on 1-SM devices, and
    # SAXPY-512 on 2 devices of 2 SMs at latency 0 and 7
    want = json.loads((ROOT / "BENCH_fleet.json").read_text())["lines"]
    brng = np.random.default_rng(42)
    bxs = (brng.standard_normal((8, 64))
           + 1j * brng.standard_normal((8, 64))).astype(np.complex64)
    bAs = np.stack([np.eye(16, dtype=np.float32) + 0.05 * brng.standard_normal(
        (16, 16)).astype(np.float32) for _ in range(4)])
    bgrid = fft_qrd_grid(bxs, bAs, 1024)
    got = {}
    for n_dev in (1, 2, 4):
        name = f"bench_fft8_qrd4_{n_dev}dev"
        res = fleet(name, lambda b, n=n_dev: FleetConfig(
            n_devices=n, device=mixed_device(64, n_sms=1, backend=b)),
            **bgrid)
        got[f"fleet{n_dev}_mixed_fft8_qrd4"] = res.cycles
    srng = np.random.default_rng(7)
    sx, sy = (srng.standard_normal(512).astype(np.float32) for _ in range(2))
    sb = dict(program=saxpy_grid_program(512, 64), grid=(8,), block=64,
              buffers={"x": sx, "y": sy, "z": np.zeros(512, np.float32),
                       "alpha": np.asarray([1.5], np.float32)})
    numa = {}
    for lat in (0, 7):
        numa[lat] = fleet(f"bench_saxpy512_numa{lat}",
                          lambda b, lat=lat: FleetConfig(
                              n_devices=2, remote_gmem_latency=lat,
                              device=dev(b, n_sms=2,
                                         global_mem_depth=3 * 512 + 16,
                                         sm=SMConfig(max_steps=10_000))),
                          **sb)
    got["numa_saxpy512"] = {
        "remote_gmem_latency": 7,
        "remote_gmem_cycles": numa[7].fleet["remote_gmem_cycles"],
        "cycles_flat": numa[0].cycles, "cycles_numa": numa[7].cycles}
    for k, v in got.items():
        w = want[k]["cycles"] if k.startswith("fleet") else want[k]
        if v != w:
            raise AssertionError(f"fleet bench {k}: {v} != recorded {w}")
    return check_path("fleet-path", per), per


# the serve benchmark's device: 4 SMs, host dispatch 200 cycles + 8 a
# queued launch
SERVE_DEVICE = dict(n_sms=4, global_mem_depth=1024, dispatch_latency=200,
                    queue_latency=8)


def serve_trace(n_req: int, seed: int = 0) -> list:
    """The serve benchmark's open-loop trace: (kind, input, arrival,
    priority) per request, FFT-64:QRD-16 2:1, exponential gaps of mean
    600 cycles, about 1 in 6 at priority 2."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(scale=600.0, size=n_req)).astype(
        np.int64)
    trace = []
    for i in range(n_req):
        prio = 2 if rng.random() < 1 / 6 else 0
        if i % 3 == 2:
            trace.append(("qrd", rng.standard_normal((16, 16)).astype(
                np.float32), int(arrivals[i]), prio))
        else:
            trace.append(("fft", (rng.standard_normal(64)
                                  + 1j * rng.standard_normal(64)).astype(
                np.complex64), int(arrivals[i]), prio))
    return trace


def serve_run(trace, max_batch: int, backend=None, threaded=False,
              engine=None) -> list:
    """Serve ``trace`` on a ``LaunchServer`` over ``SERVE_DEVICE`` under
    dynamic dispatch (``engine``: the launches' engine, default "auto");
    returns the ``ServeResult`` of each request. With ``threaded`` the
    requests are queued, the background batcher started and, once it
    dispatched a batch, stopped with ``drain=True``."""
    import dataclasses

    from repro_torch.core import DeviceConfig, SMConfig
    from repro_torch.core.programs import (fft_kernel, fft_shmem, qrd_kernel,
                                           qrd_shmem)
    from repro_torch.serve import LaunchRequest, LaunchServer

    dcfg = DeviceConfig(**SERVE_DEVICE, sm=SMConfig(
        shmem_depth=1024, imem_depth=1024, max_steps=200_000),
        **({"backend": backend} if backend else {}))
    server = LaunchServer(dcfg, max_queue=len(trace) + 1,
                          max_batch=max_batch, schedule="dynamic",
                          engine=engine)
    kernels = {"fft": fft_kernel(64), "qrd": qrd_kernel()}
    images = {"fft": fft_shmem, "qrd": qrd_shmem}
    futs = []
    for kind, data, arrival, prio in trace:
        kern = kernels[kind] if not prio \
            else dataclasses.replace(kernels[kind], priority=prio)
        futs.append(server.submit(LaunchRequest(
            kernel=kern, shmem=images[kind](data, 1024),
            arrival_cycle=arrival, tag=kind)))
    if threaded:
        server.start()
        deadline = time.perf_counter() + 120
        while not server.stats()["batches"]:
            if time.perf_counter() > deadline:
                raise AssertionError("the batcher dispatched nothing")
            time.sleep(0.001)
        server.stop(drain=True)
    else:
        server.drain()
    return [f.result(timeout=120) for f in futs]


def serve_line(results) -> dict:
    """The serve benchmark's modeled numbers of one served trace."""
    lat = np.asarray(sorted(r.latency_cycles for r in results))
    return {"p50_latency_cycles": int(np.percentile(lat, 50)),
            "p99_latency_cycles": int(np.percentile(lat, 99)),
            "makespan_cycles": int(max(r.finish_cycle for r in results)),
            "mean_batch_size": round(float(np.mean(
                [r.batch_size for r in results])), 2),
            "batch_occupancy": round(float(np.mean(
                [r.batch_occupancy for r in results])), 3)}


def same_results(name: str, got, want) -> None:
    """Two servings of one trace agree for every request: state, cycles,
    batch and profile."""
    import torch

    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        for k in ("regs", "shmem", "oob"):
            if not torch.equal(getattr(g, k).cpu(), getattr(w, k).cpu()):
                raise AssertionError(f"{name}: request {i} {k} differs")
        for k in ("arrival_cycle", "dispatch_cycle", "finish_cycle",
                  "cycles", "wait_cycles", "latency_cycles", "batch_id",
                  "batch_size", "batch_occupancy", "queue_depth",
                  "finish_reason"):
            if getattr(g, k) != getattr(w, k):
                raise AssertionError(f"{name}: request {i} {k} "
                                     f"{getattr(g, k)} != {getattr(w, k)}")
        if g.profile != w.profile:
            raise AssertionError(f"{name}: request {i} profile differs")


def serve_path():
    """The LaunchServer on the serve benchmark's 24-request trace, served
    one request a launch (``max_batch=1``) and batched (``max_batch=8``)
    through "auto" (the megakernel), and batched on the trace engine; and
    a SAXPY-4096 request with its own buffers (solo, on the step engine)
    between two FFT-64 requests. Each runs on the card and on the host
    (``COUNTED_HOST``): equal state, cycles and profile for every request,
    the card's row kernels launched once per host row and ``segment``
    where the megakernel ran; each request's FFT, QR or SAXPY checked; the
    trace's percentiles and makespan must be ``BENCH_serve.json``'s. The
    batched trace runs once more through the background batcher
    (``start``/``stop(drain=True)``) and must equal the synchronous
    run."""
    import torch
    from repro_torch.core import DeviceConfig, Kernel, SMConfig
    from repro_torch.core.programs import fft_kernel, fft_shmem
    from repro_torch.core.programs.fft import bitrev_indices
    from repro_torch.core.programs.qrd import Q_BASE, R_BASE
    from repro_torch.core.programs.saxpy import saxpy_grid_program
    from repro_torch.serve import LaunchRequest, LaunchServer

    want = json.loads((ROOT / "BENCH_serve.json").read_text())["lines"]
    trace = serve_trace(24)
    host_rows = counted_host_backend()
    per = {}

    def served(name, run):
        got, launched = on_card(lambda: run(None))
        host_rows.update(dict.fromkeys(host_rows, 0))
        same_results(name, got, run(COUNTED_HOST))
        for k, n_rows in host_rows.items():
            if launched[k] != n_rows:
                raise AssertionError(f"serve {name}: {launched[k]} {k} "
                                     f"launches for {n_rows} rows")
        if any(r.profile["engine"] == "megakernel" for r in got) \
                and not launched["segment"]:
            raise AssertionError(f"serve {name}: no segment launch")
        per[name] = dict(launches=launched, rows=dict(host_rows))
        return got

    def check_outputs(results):
        for (kind, data, _, _), r in zip(trace, results):
            mem = r.shmem_f32()[0].cpu().numpy()
            if kind == "fft":
                X = np.empty(64, np.complex64)
                X[bitrev_indices(64)] = mem[0:128:2] + 1j * mem[1:128:2]
                spec = np.fft.fft(data)
                np.testing.assert_allclose(X, spec, rtol=0,
                                           atol=2e-5 * np.abs(spec).max())
            else:
                check_qr(mem[Q_BASE:Q_BASE + 256].reshape(1, 16, 16)
                         .transpose(0, 2, 1).astype(np.float64),
                         mem[R_BASE:R_BASE + 256].reshape(1, 16, 16)
                         .astype(np.float64), data[None].astype(np.float64))

    for name, line, max_batch, engine in (
            ("serial", "serial", 1, None), ("batched", "batched", 8, None),
            ("batched_trace", "batched", 8, "trace")):
        got = served(name, lambda b, m=max_batch, e=engine: serve_run(
            trace, m, b, engine=e))
        check_outputs(got)
        numbers = serve_line(got)
        for k, v in numbers.items():
            if v != want[line][k]:
                raise AssertionError(f"serve {name} {k}: {v} != recorded "
                                     f"{want[line][k]}")
        per[name].update(numbers)
        print(f"serve-path {name}: {numbers}, wall "
              f"{per[name]['launches']['wall_ms']:.1f} ms", flush=True)
        if name == "batched":
            threaded, launched = on_card(
                lambda: serve_run(trace, max_batch, threaded=True))
            same_results("batched, threaded", threaded, got)
            per["batched_threaded"] = dict(launches=launched,
                                           **serve_line(threaded))

    # a request with its own buffers dispatches solo, between two others
    n = 4096
    rng = np.random.default_rng(20261019)
    x, y = rng.standard_normal((2, n)).astype(np.float32)
    xs = (rng.standard_normal((2, 64))
          + 1j * rng.standard_normal((2, 64))).astype(np.complex64)

    def solo(backend):
        dcfg = DeviceConfig(n_sms=4, global_mem_depth=3 * n + 16,
                            sm=SMConfig(shmem_depth=1024, max_steps=200_000),
                            **({"backend": backend} if backend else {}))
        server = LaunchServer(dcfg, max_batch=8)
        reqs = [LaunchRequest(kernel=fft_kernel(64),
                              shmem=fft_shmem(xs[0], 1024)),
                LaunchRequest(kernel=Kernel(saxpy_grid_program(n, 512),
                                            block=512), grid=8,
                              buffers={"x": x, "y": y,
                                       "z": np.zeros(n, np.float32),
                                       "alpha": np.asarray([2.5],
                                                           np.float32)}),
                LaunchRequest(kernel=fft_kernel(64),
                              shmem=fft_shmem(xs[1], 1024))]
        futs = [server.submit(r) for r in reqs]
        server.drain()
        return [f.result() for f in futs]

    got = served("solo_saxpy4096", solo)
    if [r.batch_size for r in got] != [1, 1, 1] or got[1].gmem is None:
        raise AssertionError("serve solo_saxpy4096: the buffers request "
                             "did not dispatch solo")
    off, _ = got[1].buffer_offsets["z"]
    np.testing.assert_allclose(
        got[1].gmem[off:off + n].view(torch.float32).cpu().numpy(),
        2.5 * x + y, rtol=1e-6)
    return check_path("serve-path", per), per


def back_substitute(r, y):
    """Solve R x = y for upper-triangular R in float64: r (B, n, n), y
    (B, n) (examples/qrd_solver.py)."""
    n = r.shape[-1]
    r = np.asarray(r, np.float64)
    y = np.asarray(y, np.float64)
    x = np.zeros(y.shape, np.float64)
    for i in range(n - 1, -1, -1):
        x[:, i] = (y[:, i] - np.einsum("bj,bj->b", r[:, i, i + 1:],
                                       x[:, i + 1:])) / r[:, i, i]
    return x


def kernel_path(rng):
    """The kernel layer's entry points at card scale, through
    ``repro_torch.kernels.ops`` with numpy inputs (so on the card): the two
    example flows, random QRD and FFT batches, ``dot`` and ``flash``, each
    held against its plain version on the same card tensors (``==`` for
    dot, QRD and FFT, FLASH_ATOL for flash). Returns the path's launch
    counts, the per-workload records and the largest float32 error of
    flash against its plain version."""
    import torch
    from repro_torch.core.programs import run_fft, run_qrd
    from repro_torch.kernels import ops
    from repro_torch.kernels.fft_r2 import fft_r2_plain
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.mgs_qrd import mgs_qrd_plain
    from repro_torch.kernels.wavefront_dot import wavefront_dot_plain

    to_card = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731

    def same_as_plain(name, got, want):
        # the kernels' outputs word for word against their plain versions
        # on the same card tensors (launched outside on_card's counts)
        for g, w in zip(got, want):
            words_equal(name, g.view(torch.int32), w.view(torch.int32))

    per = {}

    # the QRD solver of examples/qrd_solver.py: 4096 systems of 16 x 16
    # (A += 4 I), Q^T b and back-substitution on the host in float64, and
    # matrix 0 on the simulated eGPU (the ISS) on the card
    A = (rng.standard_normal((4096, 16, 16))
         + 4 * np.eye(16)).astype(np.float32)
    b = rng.standard_normal((4096, 16)).astype(np.float32)
    ((q, r), (q0, r0, _)), got = on_card(lambda: (ops.qrd(A),
                                                  run_qrd(A[0])))
    same_as_plain("ops.qrd solver x 4096", (q, r), mgs_qrd_plain(to_card(A)))
    q, r = q.cpu().numpy(), r.cpu().numpy()
    x = back_substitute(r, np.einsum("bij,bi->bj", q.astype(np.float64), b))
    x_np = np.linalg.solve(A.astype(np.float64),
                           b.astype(np.float64)[..., None])[..., 0]
    err = np.abs(x - x_np).max(axis=1)
    ratio = err / (2.0**-24 * np.linalg.cond(A.astype(np.float64))
                   * np.abs(x_np).max(axis=1))
    if not (ratio <= SOLVE_K).all():
        worst = int(np.argmax(ratio))
        raise AssertionError(f"QRD solver: system {worst} is off by "
                             f"{err[worst]}, {ratio[worst]} eps cond |x|")
    np.testing.assert_allclose(q[0], q0, atol=2e-4)
    np.testing.assert_allclose(r[0], r0, atol=2e-4)
    per["qrd16_solve_x4096"] = dict(
        launches=got, max_abs_err_vs_numpy=float(err.max()),
        median_abs_err_vs_numpy=float(np.median(err)),
        max_err_over_eps_cond_x=float(ratio.max()))

    # random QRD-32 x 1024 and QRD-8 x 4096
    for n, batch in ((32, 1024), (8, 4096)):
        As = rng.standard_normal((batch, n, n)).astype(np.float32)
        (q, r), got = on_card(lambda: ops.qrd(As))
        same_as_plain(f"ops.qrd {n} x {batch}", (q, r),
                      mgs_qrd_plain(to_card(As)))
        check_qr(q.cpu().numpy().astype(np.float64),
                 r.cpu().numpy().astype(np.float64), As.astype(np.float64))
        per[f"qrd{n}_x{batch}"] = dict(launches=got)

    # the spectral pipeline of examples/fft_pipeline.py: 4096 frames of
    # the 256-sample two-tone signal, each with its own noise; frame 0 on
    # the simulated eGPU on the card
    n = 256
    t = np.arange(n) / n
    tones = np.sin(2 * np.pi * 17 * t) + 0.5 * np.sin(2 * np.pi * 49 * t)
    frames = (tones + 0.05 * rng.standard_normal((4096, n))).astype(
        np.float32)
    ((fr, fi), (x0, _)), got = on_card(lambda: (
        ops.fft(frames, np.zeros_like(frames)),
        run_fft(frames[0].astype(np.complex64))))
    same_as_plain("ops.fft pipeline x 4096", (fr, fi), fft_r2_plain(
        to_card(frames), torch.zeros_like(to_card(frames))))
    X = fr.cpu().numpy() + 1j * fi.cpu().numpy()
    peaks = np.sort(np.argsort(np.abs(X[:, :n // 2]), axis=1)[:, -2:], axis=1)
    if not (peaks == [17, 49]).all():
        bad = int(np.argmax((peaks != [17, 49]).any(axis=1)))
        raise AssertionError(f"frame {bad}: peaks at {peaks[bad]}")
    np.testing.assert_allclose(X[0], x0, rtol=0,
                               atol=1e-4 * np.abs(x0).max())
    per["fft256_pipeline_x4096"] = dict(launches=got)

    # random complex FFT-1024 x 1024 against torch.fft
    z = (rng.standard_normal((1024, 1024))
         + 1j * rng.standard_normal((1024, 1024))).astype(np.complex64)
    (zr, zi), got = on_card(lambda: ops.fft(z.real, z.imag))
    same_as_plain("ops.fft 1024 x 1024", (zr, zi),
                  fft_r2_plain(to_card(z.real), to_card(z.imag)))
    want = torch.fft.fft(torch.from_numpy(z).cuda(), dim=-1)
    scale = float(want.real.abs().max())
    torch.testing.assert_close(zr, want.real, rtol=0, atol=3e-5 * scale)
    torch.testing.assert_close(zi, want.imag, rtol=0, atol=3e-5 * scale)
    per["fft1024_x1024"] = dict(launches=got)

    # dot at the kernel bench's 16 x 512 and at 4096 x 512
    for n_sm in (16, 4096):
        a, bb = (rng.standard_normal((n_sm, 512)).astype(np.float32)
                 for _ in range(2))
        out, got = on_card(lambda: ops.dot(a, bb))
        at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(bb).cuda()
        words_equal(f"ops.dot {n_sm} x 512", out.view(torch.int32),
                    wavefront_dot_plain(at, bt, torch.ones_like(
                        at, dtype=torch.bool)).view(torch.int32))
        per[f"dot_{n_sm}x512"] = dict(launches=got)

    # flash at the kernel bench's shape, at Yi-6B's 32 heads of 128 over
    # 1024 tokens, and non-causal
    flash_err = 0.0
    for (bh, S, D), causal, blk in (((4, 256, 64), True, 64),
                                     ((32, 1024, 128), True, 128),
                                     ((4, 128, 64), False, 64)):
        q, k, v = (rng.standard_normal((bh, S, D)).astype(np.float32)
                   for _ in range(3))
        out, got = on_card(lambda: ops.flash(q, k, v, causal=causal,
                                             blk_q=blk, blk_k=blk))
        want = flash_attention_plain(*(torch.from_numpy(x).cuda()
                                       for x in (q, k, v)), causal, blk, blk)
        err = float((out - want).abs().max())
        if not err <= FLASH_ATOL:
            raise AssertionError(f"ops.flash {(bh, S, D)}: {err}")
        flash_err = max(flash_err, err)
        per[f"flash_{bh}x{S}x{D}_{'causal' if causal else 'full'}"] = dict(
            launches=got, max_abs_err_vs_plain=err)
    return check_path("kernel-path", per), per, flash_err


def golden_shapes():
    """The [4sm] golden entries and the fleet's four, run on the card."""
    from repro_torch.core import (DeviceConfig, FleetConfig, SMConfig,
                                  launch_fleet)
    from repro_torch.core.programs import (
        cholesky_imem_depth, launch_fft_qrd, launch_masked_reduction,
        launch_reduction, launch_saxpy, mixed_device, run_cholesky_batch,
        run_fft_batch, run_qrd_batch)
    from repro_torch.core.programs.saxpy import saxpy_grid_program

    golden = json.loads((ROOT / "tests" / "golden_cycles.json").read_text())
    x = np.arange(256, dtype=np.float32)

    def saxpy(engine):
        return launch_saxpy(2.0, x, np.ones_like(x), block=64,
                            device=DeviceConfig(
                                n_sms=4, global_mem_depth=1024, engine=engine,
                                sm=SMConfig(max_steps=10_000)))[1]

    def cholesky():
        g = np.random.default_rng(0).standard_normal((16, 16)).astype(
            np.float32)
        As = np.stack([(g @ g.T + (16.0 + i) * np.eye(16)).astype(np.float32)
                       for i in range(5)])
        bs = np.stack([np.ones(16, np.float32) * (i + 1) for i in range(5)])
        return run_cholesky_batch(As, bs, device=DeviceConfig(
            n_sms=4, engine="step", sm=SMConfig(
                shmem_depth=1024, imem_depth=cholesky_imem_depth(True),
                max_steps=200_000)))[2]

    def mixed(schedule, engine="step", packing="length", interleave=False,
              priorities=None):
        return launch_fft_qrd(
            np.ones((6, 64), np.complex64),
            np.stack([np.eye(16, dtype=np.float32)] * 3),
            device=mixed_device(64, n_sms=4), schedule=schedule,
            interleave=interleave, engine=engine, packing=packing,
            priorities=priorities)[3]

    runs = {
        "saxpy256_b64[4sm]": (lambda: saxpy("megakernel"), "megakernel"),
        "fft64_batch5[4sm]": (lambda: run_fft_batch(
            np.ones((5, 64), np.complex64), device=DeviceConfig(
                n_sms=4, sm=SMConfig(shmem_depth=192,
                                     max_steps=200_000)))[1], "megakernel"),
        "qrd16_batch5[4sm]": (lambda: run_qrd_batch(
            np.stack([np.eye(16, dtype=np.float32) + 0.1 * i
                      for i in range(5)]), device=DeviceConfig(
                n_sms=4, sm=SMConfig(shmem_depth=1024, imem_depth=1024,
                                     max_steps=200_000)))[2], "megakernel"),
        "saxpy256_b64[4sm] (auto)": (lambda: saxpy("auto"), "step"),
        "reduction1024_fused[4sm]": (lambda: launch_reduction(
            np.ones(1024, np.float32), block=256, fused=True,
            device=DeviceConfig(n_sms=4, global_mem_depth=2048,
                                engine="step",
                                sm=SMConfig(max_steps=50_000)))[1], "step"),
        "cholesky16_solve_batch5[4sm]": (cholesky, "step"),
        "masked_reduction1024[4sm]": (lambda: launch_masked_reduction(
            np.linspace(-4.0, 4.0, 1024, dtype=np.float32), 0.5,
            clip=(-2.0, 2.0), block=256, device=DeviceConfig(
                n_sms=4, global_mem_depth=2048, engine="step",
                sm=SMConfig(max_steps=50_000)))[2], "step"),
        "mixed_fft_qrd[4sm,static,packed,step-engine]": (
            lambda: mixed("static"), "step"),
        "mixed_fft_qrd[4sm,dynamic,packed,step-engine]": (
            lambda: mixed("dynamic"), "step"),
        # the merged waves: "auto" resolves to the megakernel
        "reduction1024_fused[4sm] (auto)": (lambda: launch_reduction(
            np.ones(1024, np.float32), block=256, fused=True,
            device=DeviceConfig(n_sms=4, global_mem_depth=2048,
                                sm=SMConfig(max_steps=50_000)))[1],
            "megakernel"),
        "mixed_fft_qrd[4sm,dynamic,fifo-backloaded]": (
            lambda: mixed("dynamic", None, None), "megakernel"),
        "mixed_fft_qrd[4sm,dynamic,qrd-first]": (
            lambda: mixed("dynamic", None, None, priorities=(0, 1)),
            "megakernel"),
    }
    def fleet_mixed(route):
        dev = mixed_device(64, n_sms=2)
        return launch_fleet(
            FleetConfig(n_devices=2, device=dev, route=route),
            **fft_qrd_grid(np.ones((6, 64), np.complex64),
                           np.stack([np.eye(16, dtype=np.float32)] * 3),
                           dev.sm.shmem_depth))

    def fleet_saxpy(lat):
        return launch_fleet(
            FleetConfig(n_devices=2, remote_gmem_latency=lat,
                        device=DeviceConfig(n_sms=2, global_mem_depth=1024,
                                            sm=SMConfig(max_steps=10_000))),
            saxpy_grid_program(256, 64), grid=(4,), block=64,
            buffers={"x": x, "y": np.ones_like(x), "z": np.zeros_like(x),
                     "alpha": np.asarray([2.0], np.float32)})

    runs["fleet_mixed_fft_qrd[2dev,2sm]"] = (
        lambda: fleet_mixed("block"), "megakernel")
    runs["fleet_mixed_fft_qrd[2dev,2sm,kernel-route]"] = (
        lambda: fleet_mixed("kernel"), "megakernel")
    for lat in (0, 7):
        runs[f"fleet_saxpy256_b64[2dev,numa{lat}]"] = (
            lambda lat=lat: fleet_saxpy(lat), "step")
    for sched in ("static", "dynamic"):
        runs[f"mixed_fft_qrd[4sm,{sched}]"] = (
            lambda s=sched: mixed(s, None, None, True), "megakernel")
        for eng in ("trace", "megakernel"):
            runs[f"mixed_fft_qrd[4sm,{sched},{eng}-engine]"] = (
                lambda s=sched, e=eng: mixed(s, e, None, True), eng)
            runs[f"mixed_fft_qrd[4sm,{sched},packed,{eng}-engine]"] = (
                lambda s=sched, e=eng: mixed(s, e), eng)
    for name, (fn, engine) in runs.items():
        res = fn()
        assert res.engine == engine, (name, res.engine)
        got = {"schedule": res.schedule, "cycles": int(res.cycles),
               "steps": int(res.steps),
               "static_cycles": int(res.static_cycles),
               "gmem": int(res.cycles_by_class[-1])}
        if res.n_waves:
            got["wave_cycles"] = [int(c) for c in res.wave_cycles]
        if res.fleet is not None:
            got["remote_gmem"] = int(res.fleet["remote_gmem_cycles"])
        want = golden[name.split(" ")[0]]
        if got != want:
            raise AssertionError(f"{name}: {got} != golden {want}")
    return len(runs)


# ---------------------------------------------------------------------------
# phase 5: timing at each path's shapes
# ---------------------------------------------------------------------------

def segment_wave(rng, dev, name: str):
    """One wave of four SMs of the main path's ``name`` ("qrd16" or
    "fft64") as the segment kernel takes it: the plan's one fused
    segment, its rows and barrier bits on the card, zero registers and the
    program's own shared-memory images of random inputs."""
    import torch
    from repro_torch.core import SMConfig, compile_megakernel
    from repro_torch.core.programs import fft_shmem, qrd_program, qrd_shmem
    from repro_torch.core.programs.fft import fft_program

    n = 4
    if name == "qrd16":
        cfg = SMConfig(n_threads=256, dim_x=16, imem_depth=1024,
                       max_steps=200_000)
        program = qrd_program()
        images = [qrd_shmem(rng.standard_normal((16, 16)), 3072)
                  for _ in range(n)]
    else:
        cfg = SMConfig(n_threads=32, dim_x=32, max_steps=200_000)
        program = fft_program(64)
        images = [fft_shmem((rng.standard_normal(64)
                             + 1j * rng.standard_normal(64)).astype(
                                 np.complex64), 3072) for _ in range(n)]
    plan = compile_megakernel(program, cfg)
    ((_, (start, stop)),) = plan.items
    state = (torch.arange(n, dtype=torch.int32, device=dev),
             torch.zeros(n, dtype=torch.int32, device=dev),
             torch.zeros((n, 512, 16), dtype=torch.int32, device=dev),
             torch.from_numpy(np.stack(images).view(np.int32)).to(dev),
             torch.zeros(n, dtype=torch.bool, device=dev))
    return (cfg, plan.sched.table[start:stop],
            plan.device_table(dev)[start:stop],
            plan.device_barriers(dev)[start:stop], state)


def time_segment(rng, dev, name: str, iters: int) -> dict:
    """The segment kernel on one main-path wave (``segment_wave``) with
    the plan's barriers, beside its plain version."""
    from repro_torch.core.executor import apply_segment_rows
    from repro_torch.kernels.simt_step import simt_segment

    cfg, rows_np, rows, bits, state = segment_wave(rng, dev, name)
    bidx, pidx, regs, shmem, oob = state
    n = regs.shape[0]
    kern = lambda: simt_segment(cfg, rows, *state, barriers=bits)  # noqa: E731
    plain = lambda: apply_segment_rows(cfg, rows_np, *state)  # noqa: E731
    words_equal(f"segment {name} wave", kern()[0], plain()[0])
    tid = np.arange(512)
    lanes = sum(int(((tid % 16 < r[14]) & (tid // 16 < r[13])
                     & (tid < cfg.n_threads)).sum()) for r in rows_np)
    # the state in and out, the rows and their bits, BID/PID
    seg_bytes = (2 * regs.numel() * 4 + 2 * shmem.numel() * 4 + 2 * n
                 + rows.numel() * 4 + bits.numel() * 4 + 2 * n * 4)
    program = {"qrd16": "QRD-16", "fft64": "FFT-64"}[name]
    return dict(ms=cuda_time_ms(kern, iters), device_ms=cuda_device_ms(kern),
                plain_ms=cuda_time_ms(plain, 3), bytes=seg_bytes,
                ops=lanes * n,
                shape=f"{program} wave: {n} SMs x {rows.shape[0]} rows, "
                      f"3072-word shared memory")


def time_kernels(rng, dev, iters: int = 200) -> dict[str, dict]:
    # segment: one QRD-16 wave, the main path's longest run, and one
    # FFT-64 wave
    out = {"segment": time_segment(rng, dev, "qrd16", iters),
           "segment_fft64": time_segment(rng, dev, "fft64", iters)}
    out.update(time_gmem_kernels(rng, dev, iters))
    out.update(time_step_kernels(rng, dev, iters))
    return out


def gmem_wave(rng, dev, n: int = 4) -> tuple:
    """One SAXPY-4096 wave as its GLD and GST rows take it: ``n`` (four)
    512-thread SMs with R1 the thread's element and random words
    elsewhere, the 12304-word image of random words, and the rows ``GLD
    R2, (R1)+0`` (x) and ``GST R6, (R1)+8192`` (z); at 16 SMs R1 runs past
    the image and the last lanes set oob. Returns ``(cfg, gld, gst,
    state)``, ``state`` the ``(regs, shmem, gmem, oob)`` tuple."""
    import torch
    from repro_torch.core import SMConfig
    from repro_torch.core.executor import FIELDS, FusedRow

    nel = 4096
    f32 = lambda shape: torch.from_numpy(rng.standard_normal(shape).astype(  # noqa: E731
        np.float32).view(np.int32)).to(dev)

    def row(sel, rd, imm):
        f = dict(sel=sel, opcode={8: 24, 9: 25}[sel], typ=0, rd=rd, ra=1,
                 rb=0, imm=imm, x=0, ext_a=0, ext_b=0, pen=0, preg=0,
                 pneg=0, act_waves=32, act_wthreads=16)
        return FusedRow.from_fields([f[k] for k in FIELDS])

    regs = f32((n, 512, 16))
    regs[:, :, 1] = torch.arange(n * 512, dtype=torch.int32,
                                 device=dev).view(n, 512)
    state = (regs, torch.zeros((n, 3072), dtype=torch.int32, device=dev),
             f32((3 * nel + 16,)), torch.zeros(n, dtype=torch.bool,
                                               device=dev))
    return SMConfig(), row(8, 2, 0), row(9, 6, 2 * nel), state


def time_gmem_kernels(rng, dev, iters: int) -> dict[str, dict]:
    """GLD and GST on one SAXPY-4096 wave (``gmem_wave``):
    ``gather_shared`` and ``scatter_shared`` are the row kernels every
    engine launches; ``gld_row`` and ``gst_row`` time a whole handler
    call of the execute stage beside the per-op composition of the same
    row (``composed_handler``), in turns; ``gather_shared_tile`` and
    ``scatter_shared_tile`` time the tile forms on the same lanes."""
    import torch
    from repro_torch.core.executor import (get_execute_backend,
                                           make_data_handlers)
    from repro_torch.kernels.simt_step import (
        gather_shared_plain, gld_row_plain, gst_row_plain,
        scatter_shared_plain, simt_gather_shared, simt_gld_row,
        simt_gst_row, simt_scatter_shared)

    cfg, gld, gst, state = gmem_wave(rng, dev)
    regs, _, gmem, oob = state
    n, gdepth = regs.shape[0], gmem.shape[0]
    lanes, nel = n * 512, 4096
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    # bytes: the address column read and the destination column written
    # (GLD) or the stored column read (GST), and one image word per lane
    row_bytes = lanes * (4 + 4) + 4 * lanes
    words_equal("gld row", simt_gld_row(cfg, gld, regs.clone(), gmem,
                                        oob.clone())[0],
                gld_row_plain(cfg, gld, regs, gmem, oob)[0])
    words_equal("gst row", simt_gst_row(cfg, gst, regs, gmem.clone(),
                                        oob.clone())[0],
                gst_row_plain(cfg, gst, regs, gmem, oob)[0])
    shape = f"{n} x 512 threads, a {gdepth}-word image"
    out = {}
    for name, op, kern, plain in (
            ("gather_shared", "GLD",
             lambda: simt_gld_row(cfg, gld, regs, gmem, oob),
             lambda: gld_row_plain(cfg, gld, regs, gmem, oob)),
            ("scatter_shared", "GST",
             lambda: simt_gst_row(cfg, gst, regs, gmem, oob),
             lambda: gst_row_plain(cfg, gst, regs, gmem, oob))):
        out[name] = dict(
            ms=cuda_time_ms(kern, iters), device_ms=cuda_device_ms(kern),
            plain_ms=cuda_time_ms(plain, iters), bytes=row_bytes, ops=0,
            shape=f"SAXPY-4096 {op} row in place: {shape}")
    # a whole handler call beside the per-op composition, in turns
    for name, r, k in (("gld_row", gld, "gather_shared"),
                       ("gst_row", gst, "scatter_shared")):
        h = make_data_handlers(cfg, get_execute_backend("cuda"), r, idx,
                               idx)[r.sel]
        p = composed_handler(cfg, r)
        out[name] = dict(
            ms=cuda_time_ms(lambda: h(state), iters),
            composed_ms=cuda_time_ms(lambda: p(state), iters),
            device_ms=cuda_device_ms(lambda: h(state)),
            composed_device_ms=cuda_device_ms(lambda: p(state)),
            ms_2=cuda_time_ms(lambda: h(state), iters),
            composed_ms_2=cuda_time_ms(lambda: p(state), iters),
            plain_ms=out[k]["plain_ms"], library_ms=None,
            bytes=row_bytes, ops=0,
            shape=f"a whole {name[:3].upper()} handler call, "
                  f"{out[k]['shape']}")
    # the tile forms, on the same lanes
    mask = torch.ones((n, 512), dtype=torch.bool, device=dev)
    old = torch.zeros((n, 512), dtype=torch.int32, device=dev)
    addr_y, addr_z = regs[:, :, 1] + nel, regs[:, :, 1] + 2 * nel
    vals = regs[:, :, 6].contiguous()
    out["gather_shared_tile"] = dict(
        ms=cuda_time_ms(lambda: simt_gather_shared(gmem, addr_y, mask, old),
                        iters),
        device_ms=cuda_device_ms(
            lambda: simt_gather_shared(gmem, addr_y, mask, old)),
        plain_ms=cuda_time_ms(
            lambda: gather_shared_plain(gmem, addr_y, mask, old), iters),
        library_ms=None, bytes=lanes * (4 + 1 + 4 + 4 + 4), ops=0,
        shape=f"tile GLD: {n} x 512 lanes, a {gdepth}-word image")
    out["scatter_shared_tile"] = dict(
        ms=cuda_time_ms(lambda: simt_scatter_shared(gmem, addr_z, vals, mask),
                        iters),
        device_ms=cuda_device_ms(
            lambda: simt_scatter_shared(gmem, addr_z, vals, mask)),
        plain_ms=cuda_time_ms(
            lambda: scatter_shared_plain(gmem, addr_z, vals, mask), iters),
        library_ms=None, bytes=2 * gdepth * 4 + lanes * (4 + 4 + 1), ops=0,
        shape=f"tile GST (the image copied): {n} x 512 lanes, a "
              f"{gdepth}-word image")
    return out


def with_bounds(timing: dict[str, dict]) -> dict[str, dict]:
    """Add each kernel's least possible time: the larger of its bytes at
    the card's memory rate and its operations at the float32 peak."""
    for v in timing.values():
        peak = v.get("peak_ops", PEAK_FP32_OPS_PER_S)
        v["bound_ms"] = max(v["bytes"] / PEAK_BYTES_PER_S,
                            v["ops"] / peak) * 1e3
        v["bound_by"] = "bytes" if v["bytes"] / PEAK_BYTES_PER_S \
            >= v["ops"] / peak else "operations"
    return timing


def time_step_kernels(rng, dev, iters: int) -> dict[str, dict]:
    """ALU, LOD and STO at the step path's shapes: one wave of four
    512-thread SMs with 16 registers and a 3072-word shared memory.
    ``alu``, ``gather`` and ``scatter`` are the row kernels the step and
    trace engines launch (one MUL.FP32 row; one LOD and one STO row at
    random addresses); ``alu_row``, ``lod_row`` and ``sto_row`` time a
    whole handler call of the execute stage beside the per-op composition
    of the same row (``composed_handler``), in turns; ``alu_tile``,
    ``gather_tile`` and ``scatter_tile`` time the tile forms at the
    per-op shapes."""
    import torch
    from repro_torch.core import SMConfig
    from repro_torch.core.executor import (FIELDS, FusedRow,
                                           get_execute_backend,
                                           make_data_handlers)
    from repro_torch.kernels.simt_alu import (alu_plain, alu_row_plain,
                                              simt_alu, simt_alu_row)
    from repro_torch.kernels.simt_step import (
        gather_plain, lod_row_plain, scatter_plain, simt_gather,
        simt_lod_row, simt_scatter, simt_sto_row, sto_row_plain)

    n, depth, lanes = 4, 3072, 4 * 512
    cfg = SMConfig()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    f32 = lambda shape: t(rng.standard_normal(shape).astype(  # noqa: E731
        np.float32).view(np.int32))

    def row(**f):
        base = dict(sel=1, opcode=3, typ=2, rd=3, ra=4, rb=5, imm=0, x=0,
                    ext_a=0, ext_b=0, pen=0, preg=0, pneg=0, act_waves=32,
                    act_wthreads=16)
        base.update(f)
        return FusedRow.from_fields([base[k] for k in FIELDS])

    addr_np = rng.integers(0, depth, (n, 512))
    touched = sum(np.unique(r).size for r in addr_np)
    regs = f32((n, 512, 16))
    regs[:, :, 1] = t(addr_np.astype(np.int32))
    shmem = f32((n, depth))
    oob = torch.zeros(n, dtype=torch.bool, device=dev)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    mul = row()                                # MUL.FP32 R3, R4, R5
    lod = row(sel=2, opcode=10, typ=0, rd=6, ra=1, rb=0)   # LOD R6, (R1)+0
    sto = row(sel=3, opcode=11, typ=0, rd=4, ra=1, rb=0)   # STO R4, (R1)+0
    state = (regs, shmem, torch.zeros(64, dtype=torch.int32, device=dev), oob)
    # bytes: the columns a row reads once and the words it reads or
    # writes once (an LOD: the address column, the image words loaded,
    # the destination column)
    alu_bytes, sto_bytes = lanes * (4 + 4 + 4), lanes * (4 + 4) + 4 * touched
    lod_bytes = sto_bytes
    out = {}
    out["alu"] = dict(
        ms=cuda_time_ms(lambda: simt_alu_row(cfg, mul, regs), iters),
        device_ms=cuda_device_ms(lambda: simt_alu_row(cfg, mul, regs)),
        plain_ms=cuda_time_ms(lambda: alu_row_plain(cfg, mul, regs), iters),
        bytes=alu_bytes, ops=lanes,
        shape=f"ALU row MUL.FP32 in place: {n} x 512 threads")
    words_equal("lod row", simt_lod_row(cfg, lod, regs.clone(), shmem,
                                        oob.clone(), depth)[0],
                lod_row_plain(cfg, lod, regs, shmem, oob, depth)[0])
    out["gather"] = dict(
        ms=cuda_time_ms(lambda: simt_lod_row(cfg, lod, regs, shmem, oob,
                                             depth), iters),
        device_ms=cuda_device_ms(lambda: simt_lod_row(cfg, lod, regs, shmem,
                                                      oob, depth)),
        plain_ms=cuda_time_ms(lambda: lod_row_plain(cfg, lod, regs, shmem,
                                                    oob, depth), iters),
        bytes=lod_bytes, ops=0,
        shape=f"LOD row in place: {n} x 512 threads, random addresses in a "
              f"{depth}-word image")
    out["scatter"] = dict(
        ms=cuda_time_ms(lambda: simt_sto_row(cfg, sto, regs, shmem, oob,
                                             depth), iters),
        device_ms=cuda_device_ms(lambda: simt_sto_row(cfg, sto, regs, shmem,
                                                      oob, depth)),
        plain_ms=cuda_time_ms(lambda: sto_row_plain(cfg, sto, regs, shmem,
                                                    oob, depth), iters),
        bytes=sto_bytes, ops=0,
        shape=f"STO row in place: {n} x 512 threads, random addresses in a "
              f"{depth}-word image")
    # a whole handler call (the step and trace engines' unit) beside the
    # per-op composition of the same row, in turns
    for name, r, k, nbytes, nops in (("alu_row", mul, "alu", alu_bytes, lanes),
                                     ("lod_row", lod, "gather", lod_bytes, 0),
                                     ("sto_row", sto, "scatter", sto_bytes,
                                      0)):
        h = make_data_handlers(cfg, get_execute_backend("cuda"), r, idx,
                               idx)[r.sel]
        p = composed_handler(cfg, r)
        out[name] = dict(
            ms=cuda_time_ms(lambda: h(state), iters),
            composed_ms=cuda_time_ms(lambda: p(state), iters),
            device_ms=cuda_device_ms(lambda: h(state)),
            composed_device_ms=cuda_device_ms(lambda: p(state)),
            ms_2=cuda_time_ms(lambda: h(state), iters),
            composed_ms_2=cuda_time_ms(lambda: p(state), iters),
            plain_ms=out[k]["plain_ms"], library_ms=None,
            bytes=nbytes, ops=nops,
            shape=f"a whole {name[:3].upper()} handler call, "
                  f"{out[k]['shape']}")
    # the tile forms (ops.alu and the tests)
    a, b, old = f32((n, 512)), f32((n, 512)), f32((n, 512))
    mask = torch.ones((n, 512), dtype=torch.bool, device=dev)
    out["alu_tile"] = dict(
        ms=cuda_time_ms(lambda: simt_alu(3, 2, a, b, mask, old), iters),
        device_ms=cuda_device_ms(lambda: simt_alu(3, 2, a, b, mask, old)),
        plain_ms=cuda_time_ms(lambda: alu_plain(3, 2, a, b, mask, old),
                              iters), library_ms=None,
        bytes=lanes * (4 + 4 + 1 + 4 + 4), ops=lanes,
        shape=f"tile MUL.FP32: {n} x 512 lanes")
    addr = t(addr_np.astype(np.int32))
    out["gather_tile"] = dict(
        ms=cuda_time_ms(lambda: simt_gather(shmem, addr, mask, old), iters),
        device_ms=cuda_device_ms(lambda: simt_gather(shmem, addr, mask,
                                                     old)),
        plain_ms=cuda_time_ms(lambda: gather_plain(shmem, addr, mask, old),
                              iters), library_ms=None,
        bytes=lanes * (4 + 1 + 4 + 4) + 4 * touched, ops=0,
        shape=f"tile LOD: {n} x 512 lanes, random addresses in a "
              f"{depth}-word image")
    out["scatter_tile"] = dict(
        ms=cuda_time_ms(lambda: simt_scatter(shmem, addr, a, mask), iters),
        device_ms=cuda_device_ms(lambda: simt_scatter(shmem, addr, a, mask)),
        plain_ms=cuda_time_ms(lambda: scatter_plain(shmem, addr, a, mask),
                              iters), library_ms=None,
        bytes=2 * n * depth * 4 + lanes * (4 + 4 + 1), ops=0,
        shape=f"tile STO (the image copied): {n} x 512 lanes, random "
              f"addresses in a {depth}-word image")
    return out


# the input sets a cold ``dot`` timing rotates through: twice the card's
# 50 MB L2 in all, so each call finds its inputs in device memory
COLD_BYTES = 100e6


# what ``time_dot``'s inputs hold besides normal draws: nothing; zeros in
# a quarter of a's lanes (lanes 12-15, as in a zero-padded vector); or one
# product a wavefront at 2**-140, flushed, so that every wavefront takes
# the kernel's exact path
DOT_FILLS = {"normal": "every lane a normal draw",
             "zeros": "a's lanes 12-15 zero",
             "exact": "lane 0's product 2**-140 (the exact path)"}


def time_dot(dev, n_sm: int, iters: int = 200, fill: str = "normal") -> dict:
    """``wavefront_dot`` (DOT, every lane) at n_sm x 512, held ``==`` its
    plain version first: warm (one input set, ``ms``/``device_ms``, as the
    other rows) and cold (the calls rotate through at least four input
    sets of COLD_BYTES in all: ``cold_ms``/``cold_device_ms``), beside the
    plain version. The inputs are seeded normal draws made on the card,
    with ``fill`` (DOT_FILLS) written over them."""
    import torch
    from repro_torch.kernels.wavefront_dot import (wavefront_dot,
                                                   wavefront_dot_plain)

    nbytes = n_sm * 512 * (4 + 4 + 1) + n_sm * 32 * 4
    n_sets = max(4, -int(-COLD_BYTES // nbytes))
    g = torch.Generator(device=dev).manual_seed(n_sm)
    a, b = (torch.randn((n_sets, n_sm, 32, 16), generator=g, device=dev)
            for _ in range(2))
    if fill == "zeros":
        a[..., 12:] = 0.0
    elif fill == "exact":
        a[..., 0] = b[..., 0] = 2.0 ** -70
    a, b = (x.view(n_sets, n_sm, 512) for x in (a, b))
    mask = torch.ones((n_sets, n_sm, 512), dtype=torch.bool, device=dev)
    sets = [(a[i], b[i], mask[i]) for i in range(n_sets)]
    words_equal(f"dot {n_sm} x 512 {fill}", wavefront_dot(*sets[0], 0).view(
        torch.int32), wavefront_dot_plain(*sets[0], 0).view(torch.int32))
    warm = lambda: wavefront_dot(*sets[0], 0)  # noqa: E731
    cycle = itertools.cycle(sets)
    cold = lambda: wavefront_dot(*next(cycle), 0)  # noqa: E731
    return dict(
        ms=cuda_time_ms(warm, iters), device_ms=cuda_device_ms(warm),
        cold_ms=cuda_time_ms(cold, iters), cold_device_ms=cuda_device_ms(cold),
        plain_ms=cuda_time_ms(lambda: wavefront_dot_plain(*sets[0], 0), 5),
        library_ms=None, bytes=nbytes, ops=n_sm * 32 * 31,
        shape=f"DOT: {n_sm} x 512 lanes, every lane, {DOT_FILLS[fill]} "
              f"(cold: {n_sets} input sets in turn)")


def time_kernel_layer(rng, dev, iters: int = 200) -> dict[str, dict]:
    """dot, FFT, QRD and flash at the kernel path's shapes, each beside
    its plain version and, where one exists, the one PyTorch call that
    computes the same function (timed here only; the port never calls
    it)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.fft_r2 import fft_r2, fft_r2_plain
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.mgs_qrd import mgs_qrd, mgs_qrd_plain

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    f32 = lambda shape: t(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    out = {"dot": time_dot(dev, 4096, iters), "dot16": time_dot(dev, 16, iters),
           "dot_zeros": time_dot(dev, 4096, iters, "zeros"),
           "dot_exact": time_dot(dev, 4096, iters, "exact")}

    rows, n = 4096, 256
    log2n = n.bit_length() - 1
    re, im = f32((rows, n)), f32((rows, n))
    z = torch.complex(re, im)
    out["fft"] = dict(
        ms=cuda_time_ms(lambda: fft_r2(re, im), iters),
        device_ms=cuda_device_ms(lambda: fft_r2(re, im)),
        plain_ms=cuda_time_ms(lambda: fft_r2_plain(re, im), 20),
        library_ms=cuda_time_ms(lambda: torch.fft.fft(z, dim=-1), iters),
        library_device_ms=cuda_device_ms(lambda: torch.fft.fft(z, dim=-1)),
        bytes=4 * rows * n * 4 + 2 * log2n * (n // 2) * 4,
        ops=rows * 5 * n * log2n,
        shape=f"FFT-{n} x {rows} rows, natural order "
              f"(library: torch.fft.fft, complex64)")
    # the CTA-per-row design: FFT-4096 x 1024
    rows, n = 1024, 4096
    log2n = n.bit_length() - 1
    re4, im4 = f32((rows, n)), f32((rows, n))
    z4 = torch.complex(re4, im4)
    out["fft4096"] = dict(
        ms=cuda_time_ms(lambda: fft_r2(re4, im4), iters),
        device_ms=cuda_device_ms(lambda: fft_r2(re4, im4)),
        plain_ms=cuda_time_ms(lambda: fft_r2_plain(re4, im4), 10),
        library_ms=cuda_time_ms(lambda: torch.fft.fft(z4, dim=-1), iters),
        library_device_ms=cuda_device_ms(lambda: torch.fft.fft(z4, dim=-1)),
        bytes=4 * rows * n * 4 + 2 * log2n * (n // 2) * 4,
        ops=rows * 5 * n * log2n,
        shape=f"FFT-{n} x {rows} rows, natural order, a CTA per row "
              f"(library: torch.fft.fft, complex64)")

    # the QRD rows' bound counts each FP32 multiply and add at the unfused
    # rate: the plain version's order forbids FMA (-fmad=false, one
    # rounding per operation), so the 67 TFLOP/s FMA rate is out of reach
    for name, batch, n in QRD_SHAPES:
        A = t(qrd_batch(rng, batch, n))
        lib_iters = 20 if n == 16 else 5
        out[name] = dict(
            ms=cuda_time_ms(lambda: mgs_qrd(A), iters),
            device_ms=cuda_device_ms(lambda: mgs_qrd(A)),
            plain_ms=cuda_time_ms(lambda: mgs_qrd_plain(A), 3),
            library_ms=cuda_time_ms(lambda: torch.linalg.qr(A), lib_iters),
            library_device_ms=cuda_device_ms(lambda: torch.linalg.qr(A),
                                             lib_iters),
            bytes=3 * batch * n * n * 4, ops=qrd_ops(batch, n),
            peak_ops=PEAK_FP32_UNFUSED_OPS_PER_S,
            shape=f"QRD-{n} x {batch} (A += 4 I; library: torch.linalg.qr, "
                  f"the same factorisation up to the signs of R's "
                  f"diagonal; bound at the unfused FP32 rate)")

    # the library call sees the heads as (1, BH, S, D): with (BH, S, D)
    # SDPA takes its math backend (three kernels, float32 scores in device
    # memory); with four dimensions its fused kernels (memory-efficient
    # attention in float32, cuDNN or flash attention in bfloat16). The
    # three-dimensional call is timed too (``library_3d_device_ms``).
    bh, S, D = 32, 1024, 128
    for name, dtype in (("flash", torch.float32),
                        ("flash_bf16", torch.bfloat16)):
        q, k, v = (f32((bh, S, D)).to(dtype) for _ in range(3))
        q4, k4, v4 = (x[None] for x in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q4, k4, v4, is_causal=True)
        sdpa3 = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=True)
        kern = lambda: flash_attention(q, k, v)  # noqa: E731
        size = 4 if dtype == torch.float32 else 2
        out[name] = dict(
            ms=cuda_time_ms(kern, iters), device_ms=cuda_device_ms(kern),
            plain_ms=cuda_time_ms(
                lambda: flash_attention_plain(q, k, v, True, 128, 128), 10),
            library_ms=cuda_time_ms(sdpa, iters),
            library_device_ms=cuda_device_ms(sdpa),
            library_3d_device_ms=cuda_device_ms(sdpa3, 10),
            bytes=4 * bh * S * D * size,
            ops=bh * (S * (S + 1) // 2) * 4 * D,
            peak_ops=PEAK_FP32_OPS_PER_S if size == 4 else PEAK_BF16_OPS_PER_S,
            shape=f"flash ({bh}, {S}, {D}) causal {str(dtype)[6:]}, blocks "
                  f"128 x 128 (library: scaled_dot_product_attention on "
                  f"(1, {bh}, {S}, {D}), {str(dtype)[6:]})")
    return out


# ---------------------------------------------------------------------------
# cold start through the persistent compile cache, and the examples
# ---------------------------------------------------------------------------

def coldstart_inputs():
    """The merged grid's inputs: FFT-64 x 64 and QRD-16 x 16, seeded."""
    rng = np.random.default_rng(20261019)
    xs = (rng.standard_normal((64, 64))
          + 1j * rng.standard_normal((64, 64))).astype(np.complex64)
    As = rng.standard_normal((16, 16, 16)).astype(np.float32)
    return xs, As


def coldstart_child(root: str, out: str) -> None:
    """One fresh process's first launch of the merged FFT-64 x 64 +
    QRD-16 x 16 grid (``launch_fft_qrd``, ``mixed_device(64, n_sms=4)``,
    through "auto") on the card, with the checkout at ``root`` and the
    compile cache ``EGPU_CACHE_DIR`` names (a checkout without the cache
    lowers as it always does). The kernels' libraries and the card's
    context are loaded before the clock starts, so the wall time is the
    launch with its host lowering. Writes the state, ``profile()``, the
    wall time, the cache's stats and the launch counts to ``out``
    (.npz)."""
    sys.path.insert(0, str(Path(root) / "src"))
    import torch
    from repro_torch.convert import launch_result_to_numpy
    from repro_torch.core.programs import launch_fft_qrd, mixed_device
    from repro_torch.kernels import build

    for fn in build._ENTRY_POINTS:
        build.entry_point(fn)
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    xs, As = coldstart_inputs()
    build.reset_launches()
    t0 = time.perf_counter()
    res = launch_fft_qrd(xs, As, device=mixed_device(64, n_sms=4))[3]
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    try:
        from repro_torch.core import compile_cache
        stats = compile_cache.stats()
    except ImportError:
        stats = None
    state = launch_result_to_numpy(res)
    np.savez(out, **{k: state[k] for k in ("regs", "shmem", "gmem", "oob")},
             profile=json.dumps(res.profile(), sort_keys=True),
             engine=res.engine, wall_ms=wall_ms, stats=json.dumps(stats),
             launches=json.dumps(dict(build.launches)))


def coldstart_pair(root: Path, scratch: Path) -> list[dict]:
    """Two fresh processes of ``coldstart_child`` on one empty cache
    directory: the first lowers and stores, the second finds its
    lowering there. Returns each one's record (its state in ``state``)."""
    import os

    cache = scratch / "cache"
    runs = []
    for turn in ("cold", "warm"):
        out = scratch / f"{turn}.npz"
        subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--coldstart-child",
             str(root), str(out)], check=True, timeout=600,
            env={**os.environ, "EGPU_CACHE_DIR": str(cache)})
        with np.load(out) as z:
            runs.append(dict(
                turn=turn, first_ms=float(z["wall_ms"]),
                engine=str(z["engine"]), stats=json.loads(str(z["stats"])),
                launches=json.loads(str(z["launches"])),
                profile=str(z["profile"]),
                state={k: z[k] for k in ("regs", "shmem", "gmem", "oob")}))
    return runs


def coldstart():
    """The first launch of the merged FFT-64 + QRD-16 grid in a fresh
    process, with an empty compile cache and then with the cache the first
    process filled: the warm one must lower nothing (no miss, no error,
    hits on all three kinds), and both must launch the megakernel's
    ``segment`` kernel and equal each other and the ``"cpu"`` backend's
    launch in this process, by state and profile."""
    import tempfile

    from repro_torch.convert import launch_result_to_numpy
    from repro_torch.core.programs import launch_fft_qrd, mixed_device

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        cold, warm = coldstart_pair(ROOT, Path(d))
    xs, As = coldstart_inputs()
    host = launch_fft_qrd(xs, As, device=mixed_device(64, n_sms=4,
                                                      backend="cpu"))[3]
    want = launch_result_to_numpy(host)
    want_profile = json.dumps(host.profile(), sort_keys=True)
    for run in (cold, warm):
        name = f"coldstart {run['turn']}"
        for k, v in run.pop("state").items():
            if not np.array_equal(v, want[k]):
                raise AssertionError(f"{name}: {k} differs from the host's")
        if run.pop("profile") != want_profile:
            raise AssertionError(f"{name}: profile() differs from the host's")
        if run["engine"] != "megakernel" or not run["launches"]["segment"]:
            raise AssertionError(f"{name}: no segment launch ({run})")
    cs, ws = cold["stats"], warm["stats"]
    if not cs["stores"] or cs["errors"]:
        raise AssertionError(f"coldstart: the cold process stored {cs}")
    if ws["misses"] or ws["errors"] or not all(
            ws["by_kind"].get(k, {}).get("hits") for k in
            ("trace", "lowering", "megakernel")):
        raise AssertionError(f"coldstart: the warm process missed: {ws}")
    card = card_line()
    for run in (cold, warm):
        print(f"coldstart {run['turn']}: first launch "
              f"{run['first_ms']} ms ({card}); cache {run['stats']}")
    return {r["turn"]: {k: r[k] for k in ("first_ms", "stats", "launches")}
            for r in (cold, warm)}


EXAMPLES = ("torch_quickstart", "torch_fft_pipeline", "torch_qrd_solver",
            "torch_serve_decode", "torch_train_lm")
# the LM examples' arguments beside the default run, and the line each must
# print (they print no True/False checks: the training example asserts
# that its loss fell, and exits 1 if it did not)
EXAMPLE_CKPT = ROOT / "build" / "examples" / "torch_train_lm"
EXAMPLE_ARGS = {"torch_train_lm": ["--fresh", "--ckpt-dir",
                                   str(EXAMPLE_CKPT)]}
EXAMPLE_LINES = {"torch_serve_decode": "served 8 requests in ",
                 "torch_train_lm": "arch=granite-100m steps=300 "
                                   "resumed_from=0"}


def port_env() -> dict:
    """This process's environment with ``src`` first on PYTHONPATH."""
    import os

    return {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p])}


def run_examples() -> dict[str, float]:
    """The port's examples on the card, each as a process of its own: each
    must exit 0; the core three must print no ``False`` check, the LM two
    their ``EXAMPLE_LINES`` line. Returns each one's wall ms."""
    import shutil

    walls = {}
    for name in EXAMPLES:
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, str(ROOT / "examples" / f"{name}.py"),
             *EXAMPLE_ARGS.get(name, [])],
            capture_output=True, text=True, timeout=600, cwd=ROOT,
            env=port_env())
        walls[name] = (time.perf_counter() - t0) * 1e3
        for line in out.stdout.splitlines():
            print(f"{name}: {line}")
        if out.returncode:
            raise AssertionError(f"{name} exited {out.returncode}:\n"
                                 f"{out.stderr[-4000:]}")
        if name in EXAMPLE_LINES:
            if not any(line.startswith(EXAMPLE_LINES[name])
                       for line in out.stdout.splitlines()):
                raise AssertionError(f"{name}: no line "
                                     f"{EXAMPLE_LINES[name]!r}")
            continue
        words = out.stdout.replace(",", " ").split()
        if "False" in words or "True" not in words:
            raise AssertionError(f"{name}: a check printed False")
    shutil.rmtree(EXAMPLE_CKPT.parent, ignore_errors=True)
    return walls


# ---------------------------------------------------------------------------
# lm-serve: the LM stack's serving path (configs, models, the slot decode
# Engine, launch.serve); plain PyTorch, none of the ten kernels
# ---------------------------------------------------------------------------

# the smoke configs the Engine serves, one per family, and the two it
# cannot (their prefill needs image embeddings or audio frames)
LM_ENGINE_ARCHS = ("granite-3-2b", "deepseek-moe-16b", "mamba2-780m",
                   "recurrentgemma-2b")
LM_MODEL_ARCHS = ("internvl2-76b", "whisper-tiny")
# float32 logits, the card against the host and a decode against its own
# full forward (TF32 off: the two differ in summation order only)
LM_ATOL = 1e-4


def host_copy(model):
    """The same model with its weights copied to the host."""
    import copy

    return copy.deepcopy(model).to("cpu")


def lm_close(name: str, got, want, atol: float = LM_ATOL) -> float:
    """Assert ``got`` (on the card) within ``atol`` of ``want``; return the
    largest difference."""
    err = float((got.float().cpu() - want.float().cpu()).abs().max())
    if not err <= atol:
        raise AssertionError(f"{name}: logits differ by {err} > {atol}")
    return err


def lm_batch(cfg, rng, dev, B: int = 2, S: int = 8) -> dict:
    import torch

    out = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S))).to(dev)}
    if cfg.family == "audio":
        out["frames"] = torch.from_numpy((0.1 * rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model))).astype(np.float32)).to(dev)
    if cfg.family == "vlm":
        out["image_embeds"] = torch.from_numpy((0.1 * rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model))).astype(
                np.float32)).to(dev)
    return out


def lm_engines(name: str) -> dict:
    """(a) ``name``'s smoke config served by the Engine on the card and on
    the host with the same weights, the launcher's trace (8 requests, 4
    slots, capacity 128, 4-16 prompt tokens): equal token streams, finish
    reasons and active widths, and each request's prefill logits within
    ``LM_ATOL``."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.serve import Engine

    cfg = get_arch(name, smoke=True)
    card = serve.build_engine(cfg, device="cuda")
    host = Engine(host_copy(card.model), max_slots=4, capacity=128)
    line = serve.drive(card, cfg)
    serve.drive(host, cfg)
    for rid, req in host.requests.items():
        got = card.requests[rid]
        if (got.out, got.finish_reason) != (req.out, req.finish_reason):
            raise AssertionError(f"{name}: request {rid} {got.out} "
                                 f"{got.finish_reason} on the card, "
                                 f"{req.out} {req.finish_reason} on the "
                                 "host")
    if card.active_history != host.active_history:
        raise AssertionError(f"{name}: active widths differ")
    err = 0.0
    with torch.inference_mode():
        for req in host.requests.values():
            toks = torch.from_numpy(np.asarray(req.prompt)[None])
            want, _ = host.model.prefill({"tokens": toks})
            got, _ = card.model.prefill({"tokens": toks.cuda()})
            err = max(err, lm_close(f"{name} prefill", got, want))
    return {"tokens": line["tokens"], "decode_steps": line["decode_steps"],
            "finish_reasons": sorted(set(card.finish_reasons().values())),
            "prefill_max_abs_err": err}


def grow_caches(caches: dict, n: int) -> dict:
    """A prefill's caches with room for ``n`` decode rows: every
    self-attention ``KVCache`` padded at the end of its row axis (the
    third from last). Recurrent states and Whisper's cross-attention
    cache keep their shapes."""
    import torch
    from repro_torch.models.attention import KVCache

    def pad(c):
        if not isinstance(c, KVCache):
            return c
        return KVCache(*(torch.nn.functional.pad(x, (0, 0, 0, 0, 0, n))
                         for x in c))

    out = dict(caches)
    for key in ("kv", "kv0"):
        if key in out:
            out[key] = pad(out[key])
    if "dec" in out:
        out["dec"] = (pad(out["dec"][0]), out["dec"][1])
    if "groups" in out:
        out["groups"] = {k: pad(c) for k, c in out["groups"].items()}
        out["tail"] = [pad(c) for c in out["tail"]]
    return out


def lm_decode(model, batch: dict, P: int, D: int):
    """Prefill ``model`` with ``batch``'s first ``P`` tokens, then decode
    its next ``D`` one at a time: (prefill logits, decode logits (B, D,
    V)), on the model's device."""
    import torch

    b = {k: v.to(model.device) for k, v in batch.items()}
    toks = b["tokens"]
    logits, caches = model.prefill({**b, "tokens": toks[:, :P]})
    caches = grow_caches(caches, D)
    steps = []
    for t in range(P, P + D):
        lg, caches = model.decode_step(caches, toks[:, t:t + 1])
        steps.append(lg[:, 0])
    out = (logits, torch.stack(steps, 1))
    for x in out:
        if not torch.isfinite(x).all():
            raise AssertionError(f"{model.cfg.name}: non-finite logits")
    return out


def lm_model_steps(name: str, rng, steps: int = 4) -> dict:
    """(b) ``name``'s smoke model (which the Engine cannot serve) model to
    model: a prefill of 8 tokens and ``steps`` decode steps on the card
    against the host, logits within ``LM_ATOL``."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    cfg = get_arch(name, smoke=True)
    card = build_model(cfg, device="cuda").requires_grad_(False)
    host = host_copy(card)
    batch = lm_batch(cfg, rng, "cuda", S=8 + steps)
    with torch.inference_mode():
        got = lm_decode(card, batch, 8, steps)
        want = lm_decode(host, batch, 8, steps)
    return {"steps": steps, "max_abs_err": max(
        lm_close(f"{name} {what}", g, w)
        for what, g, w in zip(("prefill", "decode"), got, want))}


# (c) each family at its published width: arch -> (depth on the card, depth
# held against the host (None: the published one), prompt tokens P, decode
# steps D, tokens of the card's full forward). Those that fit the card
# whole in float32 run whole there; deepseek-moe-16b (65.6 GB whole),
# internvl2-76b (~300 GB) and Yi-6B (whose whole run is (d)) are cut in
# depth. mamba2-780m's prompt is one SSD chunk (256) and its forward two,
# so the chunked scan carries a state across chunks.
LM_PUBLISHED = {
    "yi-6b": (2, 2, 16, 16, 32),
    "deepseek-moe-16b": (3, 3, 16, 16, 32),
    "internvl2-76b": (2, 2, 16, 16, 32),
    "mamba2-780m": (None, 2, 256, 16, 512),
    "recurrentgemma-2b": (None, 3, 16, 16, 32),
    "whisper-tiny": (None, None, 16, 16, 32),
}
# decode steps held against the host after its prefill
LM_HOST_STEPS = 4


def lm_published(name: str, rng) -> dict:
    """(c) ``name`` at its published width (``LM_PUBLISHED``): on the
    card, the prefill's and the decode steps' logits against the card's
    own full forward (the reference's decode-matches-full-forward check,
    a MoE dropless there as in the reference's test); then, at the host
    depth, the prefill and ``LM_HOST_STEPS`` decode steps on the card
    against the host with the same weights. Logits within ``LM_ATOL``."""
    import dataclasses

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    depth, host_depth, P, D, S = LM_PUBLISHED[name]
    cfg = get_arch(name)

    def at(n_layers):
        return cfg if n_layers is None else dataclasses.replace(
            cfg, n_layers=n_layers)

    card = build_model(at(depth), device="cuda").requires_grad_(False)
    n_params = sum(p.numel() for p in card.parameters())
    batch = lm_batch(cfg, rng, "cuda", S=S)
    errs = {}
    with torch.inference_mode():
        if cfg.n_experts:
            # capacity drops depend on the batch's token count, so the
            # forward and the decode agree only without them
            card.cfg = dataclasses.replace(
                card.cfg, capacity_factor=float(cfg.n_experts))
        full = card.forward(batch)
        pre, dec = lm_decode(card, batch, P, D)
        card.cfg = at(depth)
        off = full.shape[1] - S          # the image tokens before the text
        errs["prefill_vs_forward"] = lm_close(
            f"{name} prefill vs forward", pre, full[:, :off + P])
        errs["decode_vs_forward"] = lm_close(
            f"{name} decode vs forward", dec, full[:, off + P:off + P + D])
        del full, pre, dec
        if host_depth != depth:
            del card
            torch.cuda.empty_cache()
            card = build_model(at(host_depth),
                               device="cuda").requires_grad_(False)
        host = host_copy(card)
        got = lm_decode(card, batch, P, LM_HOST_STEPS)
        want = lm_decode(host, batch, P, LM_HOST_STEPS)
        errs["prefill"] = lm_close(f"{name} prefill", got[0], want[0])
        errs["decode"] = lm_close(f"{name} decode", got[1], want[1])
    del card, host, got, want
    torch.cuda.empty_cache()
    return {"n_layers": depth or cfg.n_layers,
            "host_n_layers": host_depth or cfg.n_layers, "params": n_params,
            "prompt": P, "decode_steps": D, "forward_tokens": S,
            **{f"{k}_max_abs_err": v for k, v in errs.items()}}


# the families the Engine serves whose published model fits the card whole
LM_ENGINE_PUBLISHED = ("mamba2-780m", "recurrentgemma-2b")


def lm_engine_published(name: str, smoke: dict) -> dict:
    """``name`` at its published config, whole, served by the Engine on
    the card through the launcher's ``build_engine``/``drive``: every
    request ends on its budget, and the trace's counts equal its smoke
    run's (``smoke``, from (a)): they depend on the trace alone."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve

    cfg = get_arch(name)
    eng = serve.build_engine(cfg, device="cuda")
    t = time.perf_counter()
    line = serve.drive(eng, cfg)
    wall = time.perf_counter() - t
    got = {k: line[k] for k in ("tokens", "decode_steps")}
    want = {k: smoke[k] for k in ("tokens", "decode_steps")}
    reasons = sorted(set(eng.finish_reasons().values()))
    if got != want or reasons != ["budget"]:
        raise AssertionError(f"{name}: {got} {reasons}, smoke {want}")
    del eng
    torch.cuda.empty_cache()
    return {**line, "wall_s": wall, "tok_per_s": line["tokens"] / wall}


def decode_step_bytes(model, positions) -> int:
    """The bytes one decode step of a dense LM at ``positions`` (one a
    slot) must move: every weight once but the input embedding table, of
    which each slot reads one row; each slot's cached K and V rows up to
    its position read and the new one written; the logits written."""
    cfg = model.cfg
    size = lambda p: p.numel() * p.element_size()  # noqa: E731
    table = model.embed.embedding
    n = sum(size(p) for p in model.parameters())
    if hasattr(model.embed, "unembed"):
        n -= size(table) - len(positions) * size(table[0])
    kv_row = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 4
    return (n + sum(int(p) + 1 for p in positions) * kv_row
            + len(positions) * cfg.padded_vocab * 4)


def lm_serve_full(card: str) -> dict:
    """(d) Yi-6B at full depth and width in float32 through the launcher's
    entry points on the card: 8 requests, 4 slots, capacity 128, max-new
    16. A first drive warms up (its first-use costs stay out of the
    numbers); a second, alone, gives the wall time and tokens/s (the 8
    prefills included); a third times each decode step and each prefill
    (host clock, the card synchronized after each). Then one 4-slot step
    alone: CUDA events, the card alone, and what it issues, beside its
    byte bound. Also the peak device memory and the card."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.serve import Engine

    cfg = get_arch("yi-6b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = serve.build_engine(cfg, slots=4, capacity=128, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    model = eng.model
    serve.drive(eng, cfg)
    eng = Engine(model, max_slots=4, capacity=128)
    t0 = time.perf_counter()
    line = serve.drive(eng, cfg)
    wall = time.perf_counter() - t0
    for req in eng.requests.values():
        if not req.done or len(req.out) != req.max_new_tokens:
            raise AssertionError(f"yi-6b: request {req.rid} ended "
                                 f"{req.finish_reason} with {len(req.out)} "
                                 f"of {req.max_new_tokens} tokens")
    if line["requests"] != 8 or not line["decode_steps"]:
        raise AssertionError(f"yi-6b: {line}")

    eng = Engine(model, max_slots=4, capacity=128)
    walls = {"_decode": [], "_prefill": []}

    def timed(name):
        fn = getattr(eng, name)

        def call(*args):
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t) * 1e3)
            return out
        return call

    for name in walls:
        setattr(eng, name, timed(name))
    if serve.drive(eng, cfg)["tokens"] != line["tokens"]:
        raise AssertionError("yi-6b: the timed drive emitted other tokens")
    dec = np.asarray(walls["_decode"])
    # one decode step of all four slots alone, at position 20
    toks = torch.zeros((4, 1), dtype=torch.int32, device=eng.device)
    pos = torch.full((4,), 20, dtype=torch.int32, device=eng.device)
    with torch.inference_mode():
        step = lambda: model.decode_step(eng.caches, toks, pos)  # noqa: E731
        step_ms = {"event_ms": cuda_time_ms(step, 10),
                   "device_ms": cuda_device_ms(step, 10),
                   **issue_counts(step)}
    step_ms.pop("ops")
    step_bytes = decode_step_bytes(model, [20] * 4)
    out = {**line, "wall_s": wall, "tok_per_s": line["tokens"] / wall,
           "params": sum(p.numel() for p in model.parameters()),
           "weight_bytes": sum(p.numel() * p.element_size()
                               for p in model.parameters()),
           "step": step_ms, "step_bytes": step_bytes,
           "step_bound_ms": step_bytes / PEAK_BYTES_PER_S * 1e3,
           "build_s": build_s,
           "decode_ms_median": float(np.median(dec)),
           "decode_ms_min": float(dec.min()),
           "decode_ms_max": float(dec.max()),
           "prefill_ms_median": float(np.median(walls["_prefill"])),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "card": card}
    del eng, model
    torch.cuda.empty_cache()
    return out


def lm_serve(card: str) -> dict:
    """The lm-serve phase, (a) to (d)."""
    rng = np.random.default_rng(20261019)
    out = {"engine": {n: lm_engines(n) for n in LM_ENGINE_ARCHS},
           "model_to_model": {n: lm_model_steps(n, rng)
                              for n in LM_MODEL_ARCHS},
           "published": {n: lm_published(n, rng) for n in LM_PUBLISHED}}
    out["engine_published"] = {
        n: lm_engine_published(n, out["engine"][n])
        for n in LM_ENGINE_PUBLISHED}
    for k, v in out.items():
        print(f"lm-serve {k}: {json.dumps(v)}", flush=True)
    out["yi-6b"] = lm_serve_full(card)
    return out


# ---------------------------------------------------------------------------
# lm-train: the LM stack's training path (optim, data, the train step and
# loop, checkpoints, launch.train); plain PyTorch, none of the ten kernels
# ---------------------------------------------------------------------------

# one smoke config per family; granite-3-2b takes three steps, the rest one
LM_TRAIN_ARCHS = {"granite-3-2b": 3, "deepseek-moe-16b": 1, "mamba2-780m": 1,
                  "recurrentgemma-2b": 1, "whisper-tiny": 1,
                  "internvl2-76b": 1}
# The card against the host, with the bars of the CPU tests against the
# reference (tests/test_torch_lm_train_parity.py): loss within 1e-5, the
# gradient norm within 1e-5 of itself. A step moves a weight by lr times
# (g / (|g| + 1e-8) + wd * w): where |g| is at the two devices' float32
# noise the signs of g may differ and the weight by up to 2 lr a step;
# that may happen to a few weights (at most TRAIN_FLIP_SHARE of them), the
# rest agree within TRAIN_P_ATOL a step.
TRAIN_LR = 1e-3
TRAIN_LOSS_ATOL = 1e-5
TRAIN_NORM_RTOL = 1e-5
TRAIN_P_ATOL = 1e-6
TRAIN_FLIP_SHARE = 1e-3


def train_rc():
    from repro_torch.configs import RunConfig

    return RunConfig(learning_rate=TRAIN_LR, warmup_steps=0,
                     weight_decay=0.1)


def train_batches(cfg, steps: int, B: int, S: int, seed: int = 0) -> list:
    """``steps`` pipeline batches of ``B`` x ``S`` on the host (a VLM's
    ``S`` holds its image tokens, as ``spec_for`` has it)."""
    from repro_torch.data import make_batch, spec_for

    spec = spec_for(cfg, None, seed, batch=B, seq=S)
    return [make_batch(cfg, spec, k, device="cpu") for k in range(steps)]


def train_against_host(name: str, card_model, batches: list, rc) -> dict:
    """The same steps of ``card_model`` and of its copy on the host, held
    together after each step (loss, gradient norm, every parameter)."""
    import torch
    from repro_torch.train import init_state, make_train_step

    host_model = host_copy(card_model)
    runs = {d: (m, init_state(m, rc), make_train_step(m, rc))
            for d, m in (("cuda", card_model), ("cpu", host_model))}
    out = {"loss_max_abs_err": 0.0, "grad_norm_max_rel_err": 0.0,
           "param_max_abs_err": 0.0, "param_beyond_share": 0.0}
    for k, b in enumerate(batches, 1):
        metrics = {}
        for dev, (m, state, step) in runs.items():
            state, metrics[dev] = step(state, {key: v.to(dev)
                                               for key, v in b.items()})
            runs[dev] = (m, state, step)
        loss_err = abs(float(metrics["cuda"]["loss"])
                       - float(metrics["cpu"]["loss"]))
        norm = float(metrics["cpu"]["grad_norm"])
        norm_err = abs(float(metrics["cuda"]["grad_norm"]) - norm) / norm
        if not (loss_err <= TRAIN_LOSS_ATOL and norm_err <= TRAIN_NORM_RTOL):
            raise AssertionError(f"{name} step {k}: loss differs by "
                                 f"{loss_err}, grad norm by {norm_err}")
        card_p, host_p = runs["cuda"][1].params, runs["cpu"][1].params
        worst, beyond, n = 0.0, 0, 0
        for key, hp in host_p.items():
            diff = (card_p[key].detach().cpu() - hp.detach()).abs()
            worst = max(worst, float(diff.max()))
            beyond += int((diff > TRAIN_P_ATOL * k).sum())
            n += diff.numel()
        if not (worst <= k * (2 * rc.learning_rate + TRAIN_P_ATOL)
                and beyond <= TRAIN_FLIP_SHARE * n):
            raise AssertionError(f"{name} step {k}: weights differ by up to "
                                 f"{worst}, {beyond} of {n} beyond "
                                 f"{TRAIN_P_ATOL * k}")
        out["loss_max_abs_err"] = max(out["loss_max_abs_err"], loss_err)
        out["grad_norm_max_rel_err"] = max(out["grad_norm_max_rel_err"],
                                           norm_err)
        out["param_max_abs_err"] = max(out["param_max_abs_err"], worst)
        out["param_beyond_share"] = max(out["param_beyond_share"],
                                        beyond / n)
    out.update(steps=len(batches), loss=float(metrics["cuda"]["loss"]))
    del runs, host_model
    torch.cuda.empty_cache()
    return out


def same_bits(name: str, got: dict, want: dict) -> None:
    """Assert two dicts of tensors are equal bit for bit, dtype and all."""
    import torch

    for key, w in want.items():
        g = got[key]
        if g.dtype != w.dtype or not torch.equal(g.cpu(), w.cpu()):
            raise AssertionError(f"{name}: {key} differs")


def step_twice_on_card(name: str, cfg, batch: dict, rc) -> None:
    """One train step of ``cfg``'s model (its seed's weights) on the card,
    run twice from the same weights on ``batch``: the loss, the gradient
    norm, the weights and both moments after it must be equal bit for bit
    (the loop's resume contract needs it). The first run's are kept on the
    host while the second runs."""
    import gc

    import torch
    from repro_torch.models import build_model
    from repro_torch.train import init_state, make_train_step

    runs = []
    for _ in range(2):
        model = build_model(cfg, device="cuda")
        state, m = make_train_step(model, rc)(
            init_state(model, rc), {k: v.cuda() for k, v in batch.items()})
        run = {"loss": m["loss"], "grad_norm": m["grad_norm"]}
        for what, tree in (("params", state.params), ("mu", state.opt.mu),
                           ("nu", state.opt.nu)):
            run.update({f"{what} {k}": t.detach() for k, t in tree.items()})
        if not runs:
            run = {k: t.cpu() for k, t in run.items()}
        runs.append(run)
        del model, state, m, run
        gc.collect()
        torch.cuda.empty_cache()
    same_bits(f"{name} twice on the card", runs[1], runs[0])
    del runs
    torch.cuda.empty_cache()


def lm_train_smoke(name: str, steps: int) -> dict:
    """(a) ``name``'s smoke config: ``steps`` train steps on the card and
    on the host with the same weights (batch 2 x 32); and one step run
    twice on the card from the same weights, equal bit for bit."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    cfg = get_arch(name, smoke=True)
    rc = train_rc()
    batches = train_batches(cfg, steps, 2, 32)
    out = train_against_host(name, build_model(cfg, device="cuda"),
                             batches, rc)
    step_twice_on_card(name, cfg, batches[0], rc)
    return {**out, "repeat_bit_equal": True}


def lm_train_restart() -> dict:
    """(b) the reference's crash test on the card at granite-3-2b smoke:
    10 steps with checkpoints every 4 written asynchronously; a second run
    dies at step 7 and resumes from step 4 with the model it crashed with;
    its losses and final weights and moments must equal the first run's
    bit for bit. Then a checkpoint written from the card restores on the
    host, and one written from the host on the card, leaves equal."""
    import shutil

    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.data import PipelineSpec
    from repro_torch.models import build_model
    from repro_torch.train import init_state, train_loop

    cfg = get_arch("granite-3-2b", smoke=True)
    root = ROOT / "build" / "lm_train_restart"
    shutil.rmtree(root, ignore_errors=True)

    def setup(sub: str, dev: str = "cuda"):
        model = build_model(cfg, device=dev, seed=1)
        rc = RunConfig(learning_rate=3e-3, warmup_steps=2,
                       ckpt_dir=str(root / sub), ckpt_every=4,
                       async_ckpt=True, seed=1)
        spec = PipelineSpec(vocab=cfg.vocab_size, seq_len=32,
                            global_batch=4, seed=1)
        return model, rc, spec

    model, rc, spec = setup("a")
    ref = train_loop(model, cfg, rc, spec, n_steps=10)
    model2, rc2, spec2 = setup("b")
    try:
        train_loop(model2, cfg, rc2, spec2, n_steps=10, fail_at_step=7)
        raise AssertionError("the injected failure did not fire")
    except RuntimeError as e:
        if "injected failure at step 7" not in str(e):
            raise
    res = train_loop(model2, cfg, rc2, spec2, n_steps=10)
    if res.resumed_from != 4 or res.losses != ref.losses[4:]:
        raise AssertionError(f"resumed from {res.resumed_from}: losses "
                             f"{res.losses} against {ref.losses[4:]}")
    for what in ("params", "mu", "nu"):
        pick = (lambda s: s.params) if what == "params" else (
            lambda s, w=what: getattr(s.opt, w))
        same_bits(f"resumed run's {what}", pick(res.state), pick(ref.state))

    # card -> host and host -> card
    ckpt.save(str(root / "c"), 10, ref.state, {"step": 10})
    host_model, host_rc, _ = setup("d", "cpu")
    got, _ = ckpt.restore(str(root / "c"), init_state(host_model, host_rc))
    if {t.device.type for t in got.params.values()} != {"cpu"}:
        raise AssertionError("a card checkpoint restored off the host")
    same_bits("card checkpoint on the host", got.params, ref.state.params)
    same_bits("card checkpoint on the host: mu", got.opt.mu,
              ref.state.opt.mu)
    host = train_loop(host_model, cfg, host_rc, spec, n_steps=4)
    back, _ = ckpt.restore(host_rc.ckpt_dir, init_state(
        build_model(cfg, device="cuda", seed=1), host_rc))
    if {t.device.type for t in back.params.values()} != {"cuda"}:
        raise AssertionError("a host checkpoint restored off the card")
    same_bits("host checkpoint on the card", back.params, host.state.params)
    same_bits("host checkpoint on the card: nu", back.opt.nu,
              host.state.opt.nu)
    del model, model2, ref, res, got, back
    torch.cuda.empty_cache()
    return {"steps": 10, "resumed_from": 4, "resumed_bit_equal": True,
            "checkpoints_crossed": ["card -> host", "host -> card"]}


# (c) every family at its published width: arch -> (depth held against the
# host, depth of the card's repeated step; None: the published one), the
# host's batch B x S, the card's (1024 tokens or more: a MoE's 64 experts
# then take many tokens each). The host's depth is cut so that its float32
# step (16 bytes a parameter of weights, gradients and moments) stays
# within the host's cores and memory. The card repeats the step whole where
# the training state leaves room for the activations (mamba2-780m 12.5 GB,
# recurrentgemma-2b 43 GB, whisper-tiny 0.6 GB), else cut in depth:
# deepseek-moe-16b to its dense layer 0 and two 64-expert layers,
# internvl2-76b to one layer (its 2.1e9 embedding and unembedding
# parameters alone are 34 GB of state, a layer 13.7 GB more) and
# granite-3-2b to 2 (its whole run is (d)). A VLM's S holds its 256 image
# tokens; mamba2-780m's 512 are two SSD chunks.
LM_TRAIN_PUBLISHED = {
    "granite-3-2b": (2, 2, (2, 128), (8, 128)),
    "deepseek-moe-16b": (3, 3, (2, 128), (8, 128)),
    "internvl2-76b": (1, 1, (1, 384), (4, 384)),
    "mamba2-780m": (2, None, (2, 512), (2, 512)),
    "recurrentgemma-2b": (3, None, (2, 128), (8, 128)),
    "whisper-tiny": (None, None, (2, 128), (8, 128)),
}


def lm_train_published(name: str) -> dict:
    """(c) ``name`` at its published width (``LM_TRAIN_PUBLISHED``): one
    step run twice on the card from the same weights, equal bit for bit;
    then, at the host's depth, one step on the card against the host
    (``TRAIN_*`` bars)."""
    import dataclasses
    import gc

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    host_depth, card_depth, (hb, hs), (cb, cs) = LM_TRAIN_PUBLISHED[name]
    cfg = get_arch(name)

    def at(n_layers):
        return cfg if n_layers is None else dataclasses.replace(
            cfg, n_layers=n_layers)

    rc = train_rc()
    t = time.perf_counter()
    step_twice_on_card(name, at(card_depth),
                       train_batches(cfg, 1, cb, cs)[0], rc)
    model = build_model(at(host_depth), device="cuda")
    n = sum(p.numel() for p in model.parameters())
    out = train_against_host(f"{name} published", model,
                             train_batches(cfg, 1, hb, hs), rc)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"n_layers": host_depth or cfg.n_layers, "params": n,
            "batch": [hb, hs], **out,
            "repeat_n_layers": card_depth or cfg.n_layers,
            "repeat_batch": [cb, cs], "repeat_bit_equal": True,
            "wall_s": time.perf_counter() - t}


def is_product(kernel: str) -> bool:
    """A matrix product's kernel (cuBLAS's and CUTLASS's names)."""
    return "gemm" in kernel.lower() or "gemv" in kernel.lower()


def lm_train_full(card: str, arch: str = "granite-3-2b", smoke: bool = False,
                  steps: int = 6) -> dict:
    """(d) ``arch`` whole through ``launch.train`` at the launcher's
    defaults (batch 8 x 128, lr 1e-3, warmup 10) for ``steps`` steps, no
    checkpoint, float32: the per-step wall times of its ``--log`` (step
    0, which warms up, left out of the median and min), tokens/s, first
    and last loss, the peak device memory; then one warm step timed
    alone and profiled, the peak memory of a forward and backward alone
    and of the optimizer (clip + AdamW, the step's decay set) alone, the
    optimizer timed, and the step's bound: forward and backward FLOPs at the FP32 rate plus the
    optimizer's bytes at the memory rate."""
    import gc
    import shutil

    import torch
    from repro_torch import convert
    from repro_torch.data import make_batch
    from repro_torch.launch import train as launch_train
    from repro_torch.optim import adamw, clip
    from repro_torch.train import make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    out_dir = ROOT / "build" / "lm_train_full"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    log = out_dir / "log.jsonl"
    args = launch_train.parser().parse_args(
        ["--arch", arch, *(["--smoke"] if smoke else []), "--steps",
         str(steps), "--ckpt-every", "0", "--ckpt-dir", str(out_dir / "ckpt"),
         "--log", str(log), "--device", "cuda"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, model, rc, spec, res = launch_train.run(args)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    line = launch_train.report(cfg, res)
    print(f"lm-train launch: {json.dumps(line)}", flush=True)
    if line["steps"] != steps or line["resumed_from"] != 0 or not all(
            np.isfinite([line["first_loss"], line["last_loss"]])):
        raise AssertionError(f"launch.train: {line}")
    dts = np.asarray([json.loads(x)["dt"] for x in
                      log.read_text().splitlines()])
    if len(dts) != steps:
        raise AssertionError(f"launch.train logged {len(dts)} steps")
    tokens = args.batch * args.seq
    warm_s = dts[1:]

    # one warm step alone, then profiled (issue_counts runs it twice)
    state = [res.state]
    step_fn = make_train_step(model, rc, args.steps)
    batch = make_batch(cfg, spec, steps, device="cuda")

    def one():
        state[0], _ = step_fn(state[0], batch)

    one()
    torch.cuda.synchronize()
    t = time.perf_counter()
    one()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3
    prof = issue_counts(one, top=10_000)
    kernels = prof.pop("top_kernels")
    products_ms = sum(ms for name, _, ms in kernels if is_product(name))
    prof.pop("ops")

    # the step's peak memory in its parts: a forward and backward from no
    # gradients, then the optimizer alone (with the step's own decay set)
    # on its gradients, timed
    params = state[0].params
    torch.cuda.reset_peak_memory_stats()
    loss, _ = model.loss(batch)
    loss.backward()
    torch.cuda.synchronize()
    peak_backward = torch.cuda.max_memory_allocated()
    grads = {k: p.grad for k, p in params.items()}
    decay = convert.lm_decay(cfg, params)

    def optimizer():
        clip.clip_by_global_norm(grads, rc.grad_clip)
        adamw.apply(rc, params, grads, state[0].opt, args.steps, decay=decay)

    torch.cuda.reset_peak_memory_stats()
    held_optimizer = torch.cuda.memory_allocated()
    opt_ms = cuda_time_ms(optimizer, 3)
    peak_optimizer = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in params.values())
    flops = (6 * n_params * tokens + 12 * cfg.n_layers * args.batch
             * args.seq ** 2 * cfg.n_heads * cfg.head_dim)
    # the norm reads g; one fused pass reads p, g, m, v and writes p, m, v
    opt_bytes = 32 * n_params
    out = {
        **line, "params": n_params, "batch": [args.batch, args.seq],
        "tokens_per_step": tokens, "run_s": run_s,
        "step_s_all": dts.tolist(),
        "step_s_median": float(np.median(warm_s)),
        "step_s_min": float(warm_s.min()),
        "tokens_per_s": tokens / float(np.median(warm_s)),
        "max_memory_allocated": peak, "memory_held_before": held,
        "max_memory_forward_backward": peak_backward,
        "memory_held_optimizer": held_optimizer,
        "max_memory_optimizer": peak_optimizer,
        "warm_step_ms": step_ms, "optimizer_ms": opt_ms,
        "profile": {**prof, "products_ms": products_ms,
                    "busy_share": prof["kernel_ms"] / step_ms,
                    "top_kernels": kernels[:8]},
        "flops": flops, "optimizer_bytes": opt_bytes,
        "bound_ms": (flops / PEAK_FP32_OPS_PER_S
                     + opt_bytes / PEAK_BYTES_PER_S) * 1e3,
        "card": card}
    for p in params.values():
        p.grad = None
    del model, res, state, grads, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_train(card: str) -> dict:
    """The lm-train phase, (a) to (d)."""
    out = {"smoke": {n: lm_train_smoke(n, k)
                     for n, k in LM_TRAIN_ARCHS.items()},
           "restart": lm_train_restart(),
           "published": {n: lm_train_published(n)
                         for n in LM_TRAIN_PUBLISHED}}
    for k, v in out.items():
        print(f"lm-train {k}: {json.dumps(v)}", flush=True)
    out["granite-3-2b"] = lm_train_full(card)
    return out


# lm-mesh: the bars of the reference's sharded cases
# (tests/mesh_check.py)
MESH_DP_LOSS_ATOL = 1e-4
MESH_DP_PARAM_ATOL = 5e-3
MESH_DP_DROP = 0.01
# (a)'s steps of each of the plain and the sharded step, one batch
MESH_STEPS = 4


def mesh_rc():
    from repro_torch.configs import RunConfig

    return RunConfig(learning_rate=TRAIN_LR, warmup_steps=0,
                     weight_decay=0.0)


def mesh_batch(cfg, B: int = 8, S: int = 128) -> dict:
    """lm-train (d)'s batch: the launcher's first, 8 x 128, on the card."""
    from repro_torch.data import PipelineSpec, make_batch

    spec = PipelineSpec(vocab=cfg.vocab_size, seq_len=S, global_batch=B,
                        seed=0)
    return make_batch(cfg, spec, 0, device="cuda")


def state_leaves(state):
    """(name, tensor) over a train state's params, mu and nu."""
    for kind, tree in (("params", state.params), ("mu", state.opt.mu),
                       ("nu", state.opt.nu)):
        for k, t in tree.items():
            yield f"{kind} {k}", t


def state_on_host(state) -> dict:
    """A train state's params, mu and nu as host tensors (global ones)."""
    from repro_torch.launch.shardings import full

    return {k: full(t).detach().cpu() for k, t in state_leaves(state)}


def same_state_bits(name: str, state, want: dict) -> None:
    """Every leaf of ``state`` (global tensors) equal bit for bit to the
    host tensors of ``want``, one leaf on the host at a time."""
    from repro_torch.launch.shardings import full

    for k, t in state_leaves(state):
        same_bits(name, {k: full(t).detach().cpu()}, {k: want[k]})


def free_card() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def lm_mesh_sharded(root: Path) -> dict:
    """(a) granite-3-2b whole on a (1, 1) mesh of the world of one:
    MESH_STEPS plain steps, then as many sharded steps from the same
    weights with the state placed by the rules (bit for bit after the
    last; every step timed, so that the warm ones of both compare in one
    process), then a checkpoint of the placed state restored with
    ``shardings=`` (bit for bit). The bytes the placed state holds and
    the first sharded step's peak (``max_memory_allocated``), both over
    what the process held before the sharded model was built, and the
    FLOPs of one more sharded step under ``FlopCounterMode`` (after the
    bit checks: the mode decomposes some ops, which rounds otherwise)
    are ``probe``, which lm-dryrun holds its prediction to."""
    import shutil

    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import full, place, state_shardings
    from repro_torch.models import build_model
    from repro_torch.train import (init_state, make_sharded_train_step,
                                   make_train_step)

    def steps(step, state, probe=None):
        """MESH_STEPS steps of ``step`` on the batch, each timed; with
        ``probe`` (a dict holding ``base_bytes``), the first step's peak
        put there."""
        ms = []
        for i in range(MESH_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            if probe is not None and i == 0:
                probe["peak_bytes"] = torch.cuda.max_memory_allocated() \
                    - probe["base_bytes"]
        return state, m, ms

    cfg, rc = get_arch("granite-3-2b"), mesh_rc()
    batch = mesh_batch(cfg)
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    model = build_model(cfg, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    state, m, plain_ms = steps(make_train_step(model, rc),
                               init_state(model, rc))
    want, want_m = state_on_host(state), {k: m[k].cpu()
                                          for k in ("loss", "grad_norm")}
    del model, state, m
    free_card()

    probe = {"base_bytes": torch.cuda.memory_allocated()}
    model = build_model(cfg, device="cuda")
    state = init_state(model, rc)
    shardings = state_shardings(mesh, state, cfg)
    torch.cuda.synchronize()
    t = time.perf_counter()
    state = place(state, shardings)
    torch.cuda.synchronize()
    place_ms = (time.perf_counter() - t) * 1e3
    free_card()
    probe["held_bytes"] = torch.cuda.memory_allocated() - probe["base_bytes"]
    torch.cuda.reset_peak_memory_stats()
    sharded = make_sharded_train_step(model, rc, mesh)
    state, m, sharded_ms = steps(sharded, state, probe)
    peak = torch.cuda.max_memory_allocated()
    same_bits(f"{MESH_STEPS} sharded steps (1, 1)",
              {k: m[k].cpu() for k in want_m}, want_m)
    same_state_bits(f"{MESH_STEPS} sharded steps (1, 1)", state, want)
    with FlopCounterMode(display=False) as fc:
        state, m = sharded(state, batch)
    torch.cuda.synchronize()
    probe["flops"] = float(fc.get_total_flops())
    del want, model
    free_card()

    d = root / "ckpt"
    t = time.perf_counter()
    ckpt.save(str(d), 1, state, {"step": 1})
    save_s = time.perf_counter() - t
    ckpt_bytes = sum(f.stat().st_size for f in d.rglob("*") if f.is_file())
    t = time.perf_counter()
    restored, extra = ckpt.restore(str(d), state, shardings=shardings)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    if extra != {"step": 1}:
        raise AssertionError(f"restored extra {extra}")
    got = dict(state_leaves(restored))
    for k, t_ in state_leaves(state):
        if type(got[k]) is not type(t_) or \
                got[k].placements != t_.placements:
            raise AssertionError(f"restored {k} is not placed as saved")
        if not torch.equal(full(got[k]), full(t_)):
            raise AssertionError(f"restored {k} differs")
    shutil.rmtree(d)
    del state, restored
    free_card()
    return {"arch": cfg.name, "params": n_params, "batch": [8, 128],
            "mesh": dict(mesh.shape), "steps": MESH_STEPS,
            "plain_step_ms": plain_ms, "sharded_step_ms": sharded_ms,
            # the warm steps (the first of each builds its caches)
            "plain_warm_median_ms": float(np.median(plain_ms[1:])),
            "sharded_warm_median_ms": float(np.median(sharded_ms[1:])),
            "place_ms": place_ms, "probe": probe,
            "max_memory_allocated": peak, "bit_equal": True,
            "ckpt_bytes": ckpt_bytes, "save_s": save_s,
            "restore_s": restore_s, "restored_bit_equal": True}


def lm_mesh_compressed() -> dict:
    """(b) the int8-EF compressed data-parallel step on granite-3-2b whole,
    a (1,) "data" mesh of the world of one, against the plain step from
    the same weights; 5 more steps on the same batch; the compression pass
    (``compressed_psum`` over the model's gradients) timed alone."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import compression
    from repro_torch.train import (init_state, make_compressed_dp_step,
                                   make_train_step)

    cfg, rc = get_arch("granite-3-2b"), mesh_rc()
    batch = mesh_batch(cfg)
    mesh = make_mesh((1,), ("data",), "cuda")
    model = build_model(cfg, device="cuda")
    state, m = make_train_step(model, rc)(init_state(model, rc), batch)
    want_loss = float(m["loss"])
    want = {k: p.detach().cpu() for k, p in state.params.items()}
    del model, state, m
    free_card()

    model = build_model(cfg, device="cuda")
    step = make_compressed_dp_step(model, rc, mesh)
    torch.cuda.reset_peak_memory_stats()
    state = init_state(model, rc)
    step_ms, losses = [], []
    for _ in range(6):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        step_ms.append((time.perf_counter() - t) * 1e3)
        if len(losses) == 1:
            loss_err = abs(losses[0] - want_loss)
            param_err = max(float((state.params[k].detach().cpu() - w)
                                  .abs().max()) for k, w in want.items())
            del want
    peak = torch.cuda.max_memory_allocated()
    if not (loss_err < MESH_DP_LOSS_ATOL and param_err < MESH_DP_PARAM_ATOL
            and losses[-1] < losses[0] - MESH_DP_DROP):
        raise AssertionError(f"compressed step: loss err {loss_err}, param "
                             f"err {param_err}, losses {losses}")

    # the compression pass alone, over a backward's gradients
    loss, _ = model.loss(batch)
    loss.backward()
    grads = {k: p.grad for k, p in state.params.items()}
    group = mesh.group("data")
    compress_ms = cuda_time_ms(
        lambda: compression.compressed_psum(grads, state.ef, group, 1), 3)
    grad_bytes = sum(g.numel() * 4 for g in grads.values())
    for p in state.params.values():
        p.grad = None
    del model, step, state, grads, loss
    free_card()
    return {"arch": cfg.name, "batch": [8, 128], "loss_err": loss_err,
            "param_err": param_err, "losses": losses, "step_ms": step_ms,
            "max_memory_allocated": peak, "compress_ms": compress_ms,
            # it reads g and e and writes the mean and e (f32) and the
            # int8 payload: ~17 bytes an element in the one pass
            "compress_bound_ms": 17 * grad_bytes / 4 / PEAK_BYTES_PER_S
            * 1e3}


def lm_mesh_host_ranks(root: Path, world: int = 4,
                       timeout: float = 300.0) -> dict:
    """(c) ``tests/mesh_check.py`` on ``world`` gloo ranks on the host
    (``mesh_check.run``, the multi-rank tests' runner: a session of its
    own, killed whole if it outlives ``timeout``); its results (each case
    raised on its ranks if it failed)."""
    sys.path.insert(0, str(ROOT / "tests"))
    import mesh_check

    out = root / "host_ranks"
    out.mkdir(parents=True)
    res = mesh_check.run(out, list(mesh_check.CASES), world, timeout)
    run = res.pop("_run")
    if run["rc"] != 0:
        raise AssertionError(f"mesh_check exited {run['rc']}:\n"
                             f"{run['stdout']}\n{run['stderr']}")
    for name in mesh_check.CASES:
        mesh_check.case(res, name)
    return res


def lm_mesh(card: str) -> dict:
    """The lm-mesh phase, (a) to (c)."""
    import shutil
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    root = ROOT / "build" / "lm_mesh"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{root / 'store'}",
                            rank=0, world_size=1,
                            timeout=timedelta(minutes=10))
    try:
        out = {"sharded": lm_mesh_sharded(root)}
        print(f"lm-mesh sharded: {json.dumps(out['sharded'])}", flush=True)
        out["compressed_dp"] = lm_mesh_compressed()
        print(f"lm-mesh compressed_dp: {json.dumps(out['compressed_dp'])}",
              flush=True)
    finally:
        dist.destroy_process_group()
    out["host_ranks"] = lm_mesh_host_ranks(root)
    out["card"] = card
    return out


# ---------------------------------------------------------------------------
# lm-dryrun: the dry run (launch.dryrun: the port's sharded steps counted on
# meta tensors over a world of fake ranks) and its prediction of lm-mesh
# (a)'s step, held to the card
# ---------------------------------------------------------------------------

# lm-mesh (a)'s step: granite-3-2b whole, float32, batch 8 x 128
MESH_SHAPE = ("lm_mesh_8x128", 128, 8, "train")
DRYRUN_PEAK_RTOL = 0.10


def lm_dryrun_row(root: Path) -> tuple[dict, dict]:
    """granite-3-2b train_4k on 16x16 through the dry run's command, in a
    process of its own; its row, and its collective calls and bytes by op
    (the command's ``collectives:`` line)."""
    out = root / "dryrun.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "granite-3-2b", "--shape", "train_4k", "--mesh", "sp", "--out",
         str(out)],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env=port_env())
    rows = [json.loads(line) for line in out.read_text().splitlines()] \
        if out.exists() else []
    if proc.returncode or len(rows) != 1 or rows[0]["status"] != "ok":
        raise AssertionError(f"dry run exited {proc.returncode}, rows "
                             f"{rows}:\n{proc.stderr[-4000:]}")
    tag = "   collectives: "
    coll = [json.loads(line[len(tag):]) for line in proc.stdout.splitlines()
            if line.startswith(tag)]
    if len(coll) != 1 or sum(v["bytes"] for v in coll[0].values()) \
            != rows[0]["collective_bytes"]:
        raise AssertionError(f"collectives by op {coll} do not sum to the "
                             f"row's {rows[0]['collective_bytes']}")
    return rows[0], coll[0]


def lm_dryrun_predict() -> dict:
    """The dry run's counts of lm-mesh (a)'s sharded step (``build_cell``
    on a (1, 1) mesh of a world of one fake rank, meta tensors) and its
    roofline at the card's FP32 peak."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.dryrun import build_cell, cell_costs, fake_world
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.roofline.analysis import PEAK_FLOPS_FP32, roofline_row

    with fake_world(1):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        cell = build_cell("granite-3-2b", ShapeConfig(*MESH_SHAPE), False,
                          mesh=mesh, dtype=torch.float32)
        costs = cell_costs(cell)
        costs.update(roofline_row(cell.cfg, cell.shape,
                                  {**costs, "n_chips": 1},
                                  peak_flops=PEAK_FLOPS_FP32))
        del cell
    return costs


def lm_dryrun(card: str, mesh_step: dict) -> dict:
    """The lm-dryrun phase: the granite-3-2b train_4k row on 16x16, then
    the prediction of lm-mesh (a)'s step beside the card's run of it
    (``mesh_step``, lm-mesh (a)'s result): FLOPs equal, peak within
    ``DRYRUN_PEAK_RTOL``."""
    import shutil

    import torch
    from repro_torch.roofline.analysis import HBM_PER_CHIP

    root = ROOT / "build" / "lm_dryrun"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    row, collectives = lm_dryrun_row(root)
    print(f"lm-dryrun row: {json.dumps(row)}", flush=True)
    print(f"lm-dryrun collectives: {json.dumps(collectives)}", flush=True)
    pred = lm_dryrun_predict()
    shutil.rmtree(root, ignore_errors=True)
    got = mesh_step["probe"]
    peak_err = abs(pred["peak_bytes_per_device"] - got["peak_bytes"]) \
        / got["peak_bytes"]
    out = {
        "granite_train_4k_16x16": row,
        "granite_train_4k_16x16_collectives": collectives,
        "mesh_step": {
            "shape": list(MESH_SHAPE),
            "flops": pred["flops"], "card_flops": got["flops"],
            "argument_bytes": pred["argument_bytes_per_device"],
            "card_held_bytes": got["held_bytes"],
            "peak_bytes": pred["peak_bytes_per_device"],
            "card_peak_bytes": got["peak_bytes"],
            "card_base_bytes": got["base_bytes"], "peak_rel_err": peak_err,
            "bytes_accessed": pred["bytes_accessed"],
            "collective_bytes": pred["collective_bytes"],
            "bound_ms": pred["step_time_lower_bound_s"] * 1e3,
            "bound_by": pred["dominant"],
            "warm_step_ms": mesh_step["sharded_step_ms"][1:],
            "count_s": pred["compile_s"]},
        "hbm_per_chip": HBM_PER_CHIP,
        "total_memory": torch.cuda.get_device_properties(0).total_memory,
        "card": card}
    print(f"lm-dryrun mesh step: {json.dumps(out['mesh_step'])}",
          flush=True)
    if pred["flops"] != got["flops"]:
        raise AssertionError(f"dry-run FLOPs {pred['flops']} != the "
                             f"card's {got['flops']}")
    if peak_err > DRYRUN_PEAK_RTOL:
        raise AssertionError(f"dry-run peak {pred['peak_bytes_per_device']}"
                             f" vs the card's {got['peak_bytes']}: "
                             f"{peak_err:.3f} > {DRYRUN_PEAK_RTOL}")
    return out


def with_segment_rows(fn):
    """``fn()`` and the fused-segment rows run meanwhile: the card's
    ``cuda`` backend runs raw rows, the host's folding backends the plan's
    residual ops, the rest folded at plan time."""
    from repro_torch.core import executor

    executor.reset_segment_rows()
    out = fn()
    rows = dict(executor.segment_rows)
    if not (rows["raw"] and rows["residual"] and rows["folded"]):
        raise AssertionError(f"segment rows: {rows}")
    return out, rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    # the plain versions' matmuls (flash) are the float32 yardstick
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    rng = np.random.default_rng(20260611)
    phases = Phases()
    libs = phases.run("build", build.build_all)
    for lib in libs.values():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if any(w in line for w in ("registers", "spill",
                                       "Compiling entry")):
                print("ptxas:", line.strip())
    seg_err = phases.run("segment-vs-plain", lambda: check_segment(rng, dev))
    g_err, s_err = phases.run("gmem-vs-plain", lambda: check_gmem(rng, dev))
    errs = phases.run("per-op-vs-plain", lambda: check_per_op(rng, dev))
    errs.update(segment=seg_err, gather_shared=g_err, scatter_shared=s_err)
    layer_err, flash_bf16_err, flash_bf16_timed_err = phases.run(
        "hand-kernels-vs-plain", lambda: check_kernel_layer(rng, dev))
    errs.update(layer_err)
    paths = {}
    # the rows of fused segments each megakernel path ran: raw on the card,
    # as residual ops or folded on the host it is held against
    seg_rows = {}
    paths["main-path"], seg_rows["main-path"] = phases.run(
        "main-path", lambda: with_segment_rows(lambda: main_path(rng)))
    counts, per, keep = phases.run("step-path", lambda: step_path(rng))
    paths["step-path"] = (counts, per)
    paths["trace-path"] = phases.run("trace-path", lambda: trace_path(keep))
    paths["merged-path"], seg_rows["merged-path"] = phases.run(
        "merged-path", lambda: with_segment_rows(
            lambda: merged_path(np.random.default_rng(20261017))))
    paths["fleet-path"], seg_rows["fleet-path"] = phases.run(
        "fleet-path", lambda: with_segment_rows(
            lambda: fleet_path(np.random.default_rng(20261018))))
    paths["serve-path"], seg_rows["serve-path"] = phases.run(
        "serve-path", lambda: with_segment_rows(serve_path))
    for name, r in seg_rows.items():
        print(f"residual {name}: the host ran {r['folded']} rows folded "
              f"and {r['residual']} residual ops; the card ran {r['raw']} "
              f"raw rows")
    cold = phases.run("coldstart", coldstart)
    example_ms = phases.run("examples", run_examples)
    per_row = phases.run("row-issue", lambda: {
        "main-path": row_issue("megakernel"),
        "step-path": row_issue("step"), "trace-path": row_issue("trace")})
    counts, per, path_flash_err = phases.run(
        "kernel-path", lambda: kernel_path(rng))
    paths["kernel-path"] = (counts, per)
    errs["flash"] = max(errs["flash"], path_flash_err)
    n_golden = phases.run("golden-cycles", golden_shapes)
    timing = phases.run("timing", lambda: with_bounds({
        **time_kernels(rng, dev), **time_kernel_layer(rng, dev)}))
    lm = phases.run("lm-serve", lambda: lm_serve(card))
    lm_tr = phases.run("lm-train", lambda: lm_train(card))
    lm_m = phases.run("lm-mesh", lambda: lm_mesh(card))
    lm_d = phases.run("lm-dryrun", lambda: lm_dryrun(card, lm_m["sharded"]))
    barriers = barrier_counts()
    for name, c in barriers.items():
        print(f"segment barriers per {name} wave: {c['total']} "
              f"({c['before_read']} before a read phase, "
              f"{c['before_write']} before a write phase) over {c['rows']} "
              f"rows; {c['every_row']} at two per row")

    # launches per kernel, summed over the paths (each path's counts were
    # set to 0 just before it and read just after)
    launches = {k: sum(c[k] for c, _ in paths.values()) for k in SOURCES}
    print(json.dumps({
        "paths": {name: {"launches": c, "per_workload": per,
                         **({"per_row": per_row[name]}
                            if name in per_row else {})}
                  for name, (c, per) in paths.items()},
        "golden_entries": n_golden,
        "segment_barriers": barriers,
        "flash_bf16_max_abs_err": flash_bf16_err,
        "flash_bf16_32x1024x128_max_abs_err": flash_bf16_timed_err,
        "timing_shapes": {k: v["shape"] for k, v in timing.items()},
        "device_ms": {k: v["device_ms"] for k, v in timing.items()},
        "cold_device_ms": {k: v["cold_device_ms"] for k, v in timing.items()
                           if "cold_device_ms" in v},
        "library_device_ms": {k: v["library_device_ms"]
                              for k, v in timing.items()
                              if "library_device_ms" in v},
        # timing rows beside the kernels line's (one kernel at a second
        # shape or type)
        "extra_rows": {k: {f: v[f] for f in (
            "ms", "device_ms", "cold_ms", "cold_device_ms", "plain_ms",
            "library_ms", "library_device_ms", "bound_ms", "bound_by", "composed_ms", "composed_device_ms", "ms_2",
            "composed_ms_2") if f in v} for k, v in timing.items()
            if k not in SOURCES},
        "library_3d_device_ms": {k: v["library_3d_device_ms"]
                                 for k, v in timing.items()
                                 if "library_3d_device_ms" in v},
        "segment_rows": seg_rows, "coldstart": cold,
        "example_ms": example_ms,
        "phase_ms": phases.ms, "card": card}))
    kernels = [{
        "name": k, "route": "cuda", "source": SOURCES[k],
        "replaces": REPLACES[k], "launches": launches[k],
        "max_abs_err": errs[k], "ms": timing[k]["ms"],
        "plain_ms": timing[k]["plain_ms"], "bound_ms": timing[k]["bound_ms"],
        "bound_by": timing[k]["bound_by"],
        "library_ms": timing[k].get("library_ms"),
    } for k in SOURCES]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"lm_serve": lm["yi-6b"]}))
    print(json.dumps({"lm_train": lm_tr["granite-3-2b"]}))
    print(json.dumps({"lm_mesh": {**lm_m,
                                  "phase_ms": phases.ms["lm-mesh"]}}))
    print(json.dumps({"lm_dryrun": {**lm_d,
                                    "phase_ms": phases.ms["lm-dryrun"]}}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--coldstart-child"] and len(sys.argv) == 4:
        coldstart_child(sys.argv[2], sys.argv[3])
        sys.exit(0)
    sys.exit(main())
