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
     denormal FP32 words, INVSQR, every ALU op and type, shared-memory
     depths 64, 1024 and 3072; the kernel layer's dot over fuzzed words,
     FFT at N = 2...4096, QRD at n = 5...32), and the flash kernel
     within 2e-5 in float32 and one bf16 ulp in bfloat16;
  3. drives three paths on ``DeviceConfig(n_sms=4)`` at the paper's full SM
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
       * kernel-path, the kernel layer's entry points (``kernels.ops``):
         the QRD solver of examples/qrd_solver.py over 4096 16x16 systems,
         QRD-32 x 1024 and QRD-8 x 4096; the spectral pipeline of
         examples/fft_pipeline.py over 4096 frames and FFT-1024 x 1024;
         ``dot`` at 16 x 512 and 4096 x 512; ``flash`` at (4, 256, 64) and
         (32, 1024, 128) causal and (4, 128, 64) non-causal; each held
         against its plain version on the same inputs, and QRD and FFT
         cross-checked against the simulated eGPU on the card.
     Each launch of the first three paths is repeated with
     ``backend="cpu"`` and must give equal state, counters and profile;
     the numerics are checked against numpy; every kernel of a path must
     have launched in it;
  4. reproduces the [4sm] golden entries the port reaches from
     tests/golden_cycles.json;
  5. times each kernel at its path's shapes with CUDA events beside its
     plain version, its least possible time (its bound) and, where one
     PyTorch call computes the same function, that call (timed only);
     the kernel and that call are timed once more on the card alone
     (``device_ms``: queued behind a sleep kernel, so the host's cost
     per launch is hidden);
  6. prints the ``kernels`` JSON line, the device line and, last, the
     ``{"ok": true, ...}`` line.

Any failure raises, so the script exits non-zero and prints no result.
"""
from __future__ import annotations

import functools
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
    from repro_torch.kernels.simt_step import simt_segment

    worst = 0
    cases = [(SMConfig(), 4, 3072, None, 600),
             (SMConfig(n_threads=256, dim_x=16), 3, 1024, 1000, 400),
             (SMConfig(n_threads=96, dim_x=8), 2, 64, None, 400)]
    for cfg, n, depth, bound, n_rows in cases:
        rows = fuzz.random_rows(rng, n_rows, n_threads=cfg.n_threads)
        regs, shmem = fuzz.random_state(rng, n, depth)
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
    return worst


def check_gmem(rng, dev) -> tuple[int, int]:
    import torch
    from repro_torch.kernels.simt_step import (
        gather_shared_plain, scatter_shared_plain, simt_gather_shared,
        simt_scatter_shared)

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    worst_g = worst_s = 0
    for n, gdepth, span in ((4, 12304, 12304), (4, 512, 37), (7, 4096, 3)):
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
    return worst_g, worst_s


def check_per_op(rng, dev) -> dict[str, int]:
    """The step path's ALU, LOD and STO kernels against their plain
    versions: every op x type over NaN, infinite and denormal words, and
    collisions and wild disabled addresses at depths 64, 1024, 3072."""
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
    return worst


def check_kernel_layer(rng, dev) -> tuple[dict[str, float], float]:
    """The kernel layer's kernels against their plain versions: dot over
    fuzzed words with random masks in both modes, FFT at every N = 2...4096
    in both output orders, QRD at n = 5, 8, 16, 31, 32 (all ``==``), and
    flash causal and not, float32 and bfloat16, with odd widths and
    blocks narrower than a CTA's rows (within FLASH_ATOL and one bf16
    ulp). Returns the largest error of each (float32 for flash) and the
    largest bfloat16 flash error."""
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
    for n_sm in (8, 24, 4096):
        for mode in (0, 1):
            a, b = (t(fuzz.random_f32_words(rng, (n_sm, 512)).view(
                np.float32)) for _ in range(2))
            mask = t(rng.random((n_sm, 512)) < 0.6)
            worst["dot"] = max(worst["dot"], words_equal(
                f"dot n_sm={n_sm} mode={mode}",
                words(wavefront_dot(a, b, mask, mode)),
                words(wavefront_dot_plain(a, b, mask, mode))))
    for log2n in range(1, 13):
        n = 1 << log2n
        re, im = (t(rng.standard_normal((8, n)).astype(np.float32))
                  for _ in range(2))
        for natural in (True, False):
            for g, w in zip(fft_r2(re, im, natural=natural),
                            fft_r2_plain(re, im, natural)):
                worst["fft"] = max(worst["fft"], words_equal(
                    f"fft N={n} natural={natural}", words(g), words(w)))
    for n in (5, 8, 16, 31, 32):
        a = t(rng.standard_normal((64, n, n)).astype(np.float32))
        for g, w in zip(mgs_qrd(a), mgs_qrd_plain(a)):
            worst["qrd"] = max(worst["qrd"], words_equal(
                f"qrd n={n}", words(g), words(w)))
    bf16 = 0.0
    for bh, S, D, blk_q, blk_k in ((3, 256, 64, 64, 32),
                                   (2, 512, 128, 128, 128),
                                   (4, 128, 64, 32, 64),
                                   (2, 96, 33, 16, 48)):
        qkv = [t(rng.standard_normal((bh, S, D)).astype(np.float32))
               for _ in range(3)]
        for causal in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = (x.to(dtype) for x in qkv)
                got = flash_attention(q, k, v, causal=causal, blk_q=blk_q,
                                      blk_k=blk_k).float()
                want = flash_attention_plain(q, k, v, causal, blk_q,
                                             blk_k).float()
                err = float((got - want).abs().max())
                what = f"flash {(bh, S, D)} causal={causal} {dtype}"
                if dtype == torch.float32:
                    if not err <= FLASH_ATOL:
                        raise AssertionError(f"{what}: {err} > {FLASH_ATOL}")
                    worst["flash"] = max(worst["flash"], err)
                else:
                    torch.testing.assert_close(got, want, rtol=BF16_RTOL,
                                               atol=BF16_ATOL, msg=what)
                    bf16 = max(bf16, err)
    return worst, bf16


# ---------------------------------------------------------------------------
# phase 3: the paths
# ---------------------------------------------------------------------------

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
    from repro_torch.convert import launch_result_to_numpy

    g, c = launch_result_to_numpy(gpu), launch_result_to_numpy(cpu)
    for k in ("regs", "shmem", "gmem", "oob"):
        if not np.array_equal(g[k], c[k]):
            raise AssertionError(f"{name}: {k} differs between the card and "
                                 f"the plain versions on the host "
                                 f"({int((g[k] != c[k]).sum())} words)")
    for k in ("cycles", "steps", "halted", "engine", "engine_fallback"):
        if getattr(gpu, k) != getattr(cpu, k):
            raise AssertionError(f"{name}: {k} {getattr(gpu, k)} != "
                                 f"{getattr(cpu, k)}")
    for k in ("wave_cycles", "cycles_by_class"):
        if not np.array_equal(getattr(gpu, k), getattr(cpu, k)):
            raise AssertionError(f"{name}: {k} differs")
    if gpu.profile() != cpu.profile():
        raise AssertionError(f"{name}: profile() differs")


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
    _, res_c = launch_saxpy(2.5, x, y, device=DeviceConfig(
        **kw, backend="cpu"), block=512)
    same_launch("saxpy4096", res, res_c)
    np.testing.assert_allclose(z, 2.5 * x + y, rtol=1e-6)
    assert res.grid == (8,) and res.halted and not bool(res.oob.any())
    assert got["segment"] > 0 and got["gather_shared"] > 0 \
        and got["scatter_shared"] > 0, got
    per["saxpy4096"] = dict(launches=got, cycles=res.cycles,
                            waves=res.n_waves)
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

    def both(name, fn, **kw):
        """``fn(DeviceConfig)`` on the card and on the host."""
        (out, res), got = on_card(lambda: fn(DeviceConfig(n_sms=4, **kw)))
        out_c, res_c = fn(DeviceConfig(n_sms=4, backend="cpu", **kw))
        same_launch(name, res, res_c)
        assert res.halted and not bool(res.oob.any()), name
        per[name] = dict(launches=got, cycles=res.cycles, waves=res.n_waves,
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
    keep["fft64"] = (xs, res)

    # QRD-16 over 16 blocks
    As = rng.standard_normal((16, 16, 16)).astype(np.float32)
    QR, res = both("qrd16", lambda d: (lambda q, r, s: ((q, r), s))(
        *run_qrd_batch(As, device=d)), engine="step",
        sm=SMConfig(imem_depth=1024, max_steps=200_000))
    check_qr(*QR, As)
    keep["qrd16"] = (As, res)

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


def trace_path(keep):
    """FFT-64 and QRD-16 on the trace engine: word for word the step
    path's runs on the card, counters included."""
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
        inputs, step_res = keep[name]
        res, got = on_card(lambda: fn(inputs))
        assert res.engine == "trace"
        g, w = launch_result_to_numpy(res), launch_result_to_numpy(step_res)
        for k in ("regs", "shmem", "gmem", "oob"):
            if not np.array_equal(g[k], w[k]):
                raise AssertionError(f"{name}: trace {k} differs from the "
                                     f"step engine on the card")
        for k in ("cycles", "steps", "halted"):
            assert getattr(res, k) == getattr(step_res, k), (name, k)
        assert np.array_equal(res.cycles_by_class, step_res.cycles_by_class)
        per[name] = dict(launches=got, cycles=res.cycles, waves=res.n_waves)
    return check_path("trace-path", per), per


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
    """The [4sm] golden entries the port reaches, run on the card."""
    from repro_torch.core import DeviceConfig, SMConfig
    from repro_torch.core.programs import (
        cholesky_imem_depth, launch_fft_qrd, launch_masked_reduction,
        launch_reduction, launch_saxpy, mixed_device, run_cholesky_batch,
        run_fft_batch, run_qrd_batch)

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

    def mixed(schedule):
        return launch_fft_qrd(
            np.ones((6, 64), np.complex64),
            np.stack([np.eye(16, dtype=np.float32)] * 3),
            device=mixed_device(64, n_sms=4), schedule=schedule,
            interleave=False, engine="step", packing="length")[3]

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
    }
    for name, (fn, engine) in runs.items():
        res = fn()
        assert res.engine == engine, (name, res.engine)
        got = {"schedule": res.schedule, "cycles": int(res.cycles),
               "steps": int(res.steps),
               "static_cycles": int(res.static_cycles),
               "gmem": int(res.cycles_by_class[-1])}
        if res.n_waves:
            got["wave_cycles"] = [int(c) for c in res.wave_cycles]
        want = golden[name.split(" ")[0]]
        if got != want:
            raise AssertionError(f"{name}: {got} != golden {want}")
    return len(runs)


# ---------------------------------------------------------------------------
# phase 5: timing at each path's shapes
# ---------------------------------------------------------------------------

def time_kernels(rng, dev, iters: int = 200) -> dict[str, dict]:
    import torch
    from repro_torch.core import SMConfig, compile_megakernel
    from repro_torch.core.executor import apply_segment_rows
    from repro_torch.core.programs import qrd_program, qrd_shmem
    from repro_torch.kernels.simt_step import (
        gather_shared_plain, scatter_shared_plain, simt_gather_shared,
        simt_scatter_shared, simt_segment)

    out = {}
    # segment: one QRD-16 wave of four SMs, the main path's longest run
    cfg = SMConfig(n_threads=256, dim_x=16, imem_depth=1024,
                   max_steps=200_000)
    plan = compile_megakernel(qrd_program(), cfg)
    ((_, (start, stop)),) = plan.items
    rows_np = plan.sched.table[start:stop]
    rows = plan.device_table(dev)[start:stop]
    n = 4
    regs = torch.zeros((n, 512, 16), dtype=torch.int32, device=dev)
    shmem = torch.from_numpy(np.stack([
        qrd_shmem(rng.standard_normal((16, 16)), 3072)
        for _ in range(n)]).view(np.int32)).to(dev)
    oob = torch.zeros(n, dtype=torch.bool, device=dev)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    zero = torch.zeros(n, dtype=torch.int32, device=dev)
    kern = lambda: simt_segment(cfg, rows, idx, zero, regs, shmem, oob)  # noqa: E731
    plain = lambda: apply_segment_rows(cfg, rows_np, idx, zero, regs, shmem, oob)  # noqa: E731
    tid = np.arange(512)
    lanes = sum(int(((tid % 16 < r[14]) & (tid // 16 < r[13])
                     & (tid < cfg.n_threads)).sum()) for r in rows_np)
    seg_bytes = (2 * regs.numel() * 4 + 2 * shmem.numel() * 4 + 2 * n
                 + rows.numel() * 4 + 2 * n * 4)
    out["segment"] = dict(ms=cuda_time_ms(kern, iters),
                          device_ms=cuda_device_ms(kern),
                          plain_ms=cuda_time_ms(plain, 3),
                          bytes=seg_bytes, ops=lanes * n,
                          shape=f"QRD-16 wave: {n} SMs x {stop - start} rows,"
                                f" 3072-word shared memory")

    # GLD/GST: one SAXPY-4096 wave of four 512-thread blocks
    nel = 4096
    gdepth = 3 * nel + 16
    gmem = torch.from_numpy(rng.standard_normal(gdepth).astype(
        np.float32).view(np.int32)).to(dev)
    gid = torch.arange(n * 512, dtype=torch.int32, device=dev).view(n, 512)
    mask = torch.ones((n, 512), dtype=torch.bool, device=dev)
    old = torch.zeros((n, 512), dtype=torch.int32, device=dev)
    addr_y = gid + nel
    out["gather_shared"] = dict(
        ms=cuda_time_ms(lambda: simt_gather_shared(gmem, addr_y, mask, old),
                        iters),
        device_ms=cuda_device_ms(
            lambda: simt_gather_shared(gmem, addr_y, mask, old)),
        plain_ms=cuda_time_ms(
            lambda: gather_shared_plain(gmem, addr_y, mask, old), iters),
        bytes=n * 512 * (4 + 1 + 4 + 4 + 4), ops=0,
        shape=f"SAXPY-4096 GLD: {n} x 512 lanes, {gdepth}-word image")
    addr_z = gid + 2 * nel
    vals = torch.from_numpy(rng.standard_normal((n, 512)).astype(
        np.float32).view(np.int32)).to(dev)
    out["scatter_shared"] = dict(
        ms=cuda_time_ms(lambda: simt_scatter_shared(gmem, addr_z, vals, mask),
                        iters),
        device_ms=cuda_device_ms(
            lambda: simt_scatter_shared(gmem, addr_z, vals, mask)),
        plain_ms=cuda_time_ms(
            lambda: scatter_shared_plain(gmem, addr_z, vals, mask), iters),
        bytes=2 * gdepth * 4 + n * 512 * (4 + 4 + 1), ops=0,
        shape=f"SAXPY-4096 GST: {n} x 512 lanes, {gdepth}-word image")
    out.update(time_step_kernels(rng, dev, iters))
    return out


def with_bounds(timing: dict[str, dict]) -> dict[str, dict]:
    """Add each kernel's least possible time: the larger of its bytes at
    the card's memory rate and its operations at the float32 peak."""
    for v in timing.values():
        v["bound_ms"] = max(v["bytes"] / PEAK_BYTES_PER_S,
                            v["ops"] / PEAK_FP32_OPS_PER_S) * 1e3
        v["bound_by"] = "bytes" if v["bytes"] / PEAK_BYTES_PER_S \
            >= v["ops"] / PEAK_FP32_OPS_PER_S else "operations"
    return timing


def time_step_kernels(rng, dev, iters: int) -> dict[str, dict]:
    """ALU, LOD and STO at the step path's shapes: one wave of four
    512-thread SMs over a 3072-word shared memory."""
    import torch
    from repro_torch.kernels.simt_alu import alu_plain, simt_alu
    from repro_torch.kernels.simt_step import (
        gather_plain, scatter_plain, simt_gather, simt_scatter)

    n, depth, lanes = 4, 3072, 4 * 512
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    f32 = lambda shape: t(rng.standard_normal(shape).astype(  # noqa: E731
        np.float32).view(np.int32))
    a, b, old = f32((n, 512)), f32((n, 512)), f32((n, 512))
    mask = torch.ones((n, 512), dtype=torch.bool, device=dev)
    out = {}
    # FP32 MUL, the FFT butterfly's and QRD projection's ALU row
    out["alu"] = dict(
        ms=cuda_time_ms(lambda: simt_alu(3, 2, a, b, mask, old), iters),
        device_ms=cuda_device_ms(lambda: simt_alu(3, 2, a, b, mask, old)),
        plain_ms=cuda_time_ms(lambda: alu_plain(3, 2, a, b, mask, old),
                              iters),
        bytes=lanes * (4 + 4 + 1 + 4 + 4), ops=lanes,
        shape=f"MUL.FP32: {n} x 512 lanes")
    mem = f32((n, depth))
    addr_np = rng.integers(0, depth, (n, 512))
    addr = t(addr_np.astype(np.int32))
    touched = sum(np.unique(row).size for row in addr_np)
    out["gather"] = dict(
        ms=cuda_time_ms(lambda: simt_gather(mem, addr, mask, old), iters),
        device_ms=cuda_device_ms(lambda: simt_gather(mem, addr, mask, old)),
        plain_ms=cuda_time_ms(lambda: gather_plain(mem, addr, mask, old),
                              iters),
        bytes=lanes * (4 + 1 + 4 + 4) + 4 * touched, ops=0,
        shape=f"LOD: {n} x 512 lanes, random addresses in a "
              f"{depth}-word image")
    out["scatter"] = dict(
        ms=cuda_time_ms(lambda: simt_scatter(mem, addr, a, mask), iters),
        device_ms=cuda_device_ms(lambda: simt_scatter(mem, addr, a, mask)),
        plain_ms=cuda_time_ms(lambda: scatter_plain(mem, addr, a, mask),
                              iters),
        bytes=2 * n * depth * 4 + lanes * (4 + 4 + 1), ops=0,
        shape=f"STO: {n} x 512 lanes, random addresses in a "
              f"{depth}-word image")
    return out


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
    from repro_torch.kernels.wavefront_dot import (wavefront_dot,
                                                   wavefront_dot_plain)

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    f32 = lambda shape: t(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    out = {}
    n_sm = 4096
    a, b = f32((n_sm, 512)), f32((n_sm, 512))
    mask = torch.ones((n_sm, 512), dtype=torch.bool, device=dev)
    out["dot"] = dict(
        ms=cuda_time_ms(lambda: wavefront_dot(a, b, mask, 0), iters),
        device_ms=cuda_device_ms(lambda: wavefront_dot(a, b, mask, 0)),
        plain_ms=cuda_time_ms(lambda: wavefront_dot_plain(a, b, mask, 0), 5),
        library_ms=None, bytes=n_sm * 512 * (4 + 4 + 1) + n_sm * 32 * 4,
        ops=n_sm * 32 * 31, shape=f"DOT: {n_sm} x 512 lanes, every lane")

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

    batch, n = 4096, 16
    A = t((rng.standard_normal((batch, n, n))
           + 4 * np.eye(n)).astype(np.float32))
    out["qrd"] = dict(
        ms=cuda_time_ms(lambda: mgs_qrd(A), iters),
        device_ms=cuda_device_ms(lambda: mgs_qrd(A)),
        plain_ms=cuda_time_ms(lambda: mgs_qrd_plain(A), 3),
        library_ms=cuda_time_ms(lambda: torch.linalg.qr(A), 20),
        library_device_ms=cuda_device_ms(lambda: torch.linalg.qr(A), 20),
        bytes=3 * batch * n * n * 4,
        ops=batch * n * (8 * n * n + 8 * n + 1),
        shape=f"QRD-{n} x {batch} (A += 4 I; library: torch.linalg.qr, "
              f"the same factorisation up to the signs of R's diagonal)")

    bh, S, D = 32, 1024, 128
    q, k, v = f32((bh, S, D)), f32((bh, S, D)), f32((bh, S, D))
    out["flash"] = dict(
        ms=cuda_time_ms(lambda: flash_attention(q, k, v), iters),
        device_ms=cuda_device_ms(lambda: flash_attention(q, k, v)),
        plain_ms=cuda_time_ms(
            lambda: flash_attention_plain(q, k, v, True, 128, 128), 10),
        library_ms=cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), iters),
        library_device_ms=cuda_device_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)),
        bytes=4 * bh * S * D * 4,
        ops=bh * (S * (S + 1) // 2) * 4 * D,
        shape=f"flash ({bh}, {S}, {D}) causal float32, blocks 128 x 128 "
              f"(library: scaled_dot_product_attention, float32)")
    return out


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
            if "registers" in line or "Compiling entry" in line:
                print("ptxas:", line.strip())
    seg_err = phases.run("segment-vs-plain", lambda: check_segment(rng, dev))
    g_err, s_err = phases.run("gmem-vs-plain", lambda: check_gmem(rng, dev))
    errs = phases.run("per-op-vs-plain", lambda: check_per_op(rng, dev))
    errs.update(segment=seg_err, gather_shared=g_err, scatter_shared=s_err)
    layer_err, flash_bf16_err = phases.run(
        "hand-kernels-vs-plain", lambda: check_kernel_layer(rng, dev))
    errs.update(layer_err)
    paths = {}
    paths["main-path"] = phases.run("main-path", lambda: main_path(rng))
    counts, per, keep = phases.run("step-path", lambda: step_path(rng))
    paths["step-path"] = (counts, per)
    paths["trace-path"] = phases.run("trace-path", lambda: trace_path(keep))
    counts, per, path_flash_err = phases.run(
        "kernel-path", lambda: kernel_path(rng))
    paths["kernel-path"] = (counts, per)
    errs["flash"] = max(errs["flash"], path_flash_err)
    n_golden = phases.run("golden-cycles", golden_shapes)
    timing = phases.run("timing", lambda: with_bounds({
        **time_kernels(rng, dev), **time_kernel_layer(rng, dev)}))

    # launches per kernel, summed over the paths (each path's counts were
    # set to 0 just before it and read just after)
    launches = {k: sum(c[k] for c, _ in paths.values()) for k in SOURCES}
    print(json.dumps({
        "paths": {name: {"launches": c, "per_workload": per}
                  for name, (c, per) in paths.items()},
        "golden_entries": n_golden,
        "flash_bf16_max_abs_err": flash_bf16_err,
        "timing_shapes": {k: v["shape"] for k, v in timing.items()},
        "device_ms": {k: v["device_ms"] for k, v in timing.items()},
        "library_device_ms": {k: v["library_device_ms"]
                              for k, v in timing.items()
                              if "library_device_ms" in v},
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
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
