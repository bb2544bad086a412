#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port of the eGPU simulator.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
(``nvcc`` for sm_90a, into ``build/repro_torch_kernels/``) and then:

  1. prints the card's name and power limit;
  2. holds each kernel against its plain PyTorch version on the card with
     ``==`` over seeded random inputs (address collisions, masked and
     out-of-range lanes, snooped operands, guarded rows, NaN/denormal FP32
     words, INVSQR);
  3. drives the main path, the megakernel launch on ``DeviceConfig(n_sms=4)``
     at the paper's full SM width, through the program entry points:
     FFT-64 over 64 blocks, QRD-16 over 16 blocks and the 4096-element
     SAXPY (grid 8 x 512, GLD/GST). Each launch is repeated with
     ``backend="cpu"`` and must give equal state, counters and profile; the
     numerics are checked against numpy; every kernel must have launched;
     the three [4sm] golden shapes must reproduce tests/golden_cycles.json;
  4. times each kernel at the main path's shapes with CUDA events beside
     its plain version and its least possible time (its bound);
  5. prints the ``kernels`` JSON line, the device line and, last, the
     ``{"ok": true, ...}`` line.

Any failure raises, so the script exits non-zero and prints no result.
"""
from __future__ import annotations

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
}
SOURCES = {
    "segment": "src/repro_torch/kernels/csrc/segment.cu",
    "gather_shared": "src/repro_torch/kernels/csrc/gmem.cu",
    "scatter_shared": "src/repro_torch/kernels/csrc/gmem.cu",
}


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


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

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
    """FFT-64, QRD-16 and SAXPY-4096 on the card and on the host; returns
    the launch counts of the card runs and the per-workload state."""
    from repro_torch.core import DeviceConfig, SMConfig
    from repro_torch.core.programs import (launch_saxpy, run_fft_batch,
                                           run_qrd_batch)
    from repro_torch.kernels import build

    counts = {k: 0 for k in build.launches}
    per = {}

    def on_card(fn):
        import torch

        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        got = dict(build.launches, wall_ms=(time.perf_counter() - t0) * 1e3)
        for k in counts:
            counts[k] += got[k]
        return out, got

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
    for b in range(16):
        np.testing.assert_allclose(Q[b] @ R[b], As[b], atol=5e-5)
        np.testing.assert_allclose(Q[b].T @ Q[b], np.eye(16), atol=5e-5)
    assert res.halted and not bool(res.oob.any())
    assert got["segment"] > 0, got
    per["qrd16"] = dict(launches=got, cycles=res.cycles, waves=res.n_waves)

    # the README quickstart SAXPY through GLD/GST; "auto" would take the
    # step engine on so short a program, so the megakernel is asked for
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
    for k, v in counts.items():
        if v == 0:
            raise AssertionError(f"kernel {k} never launched on the main path")
    return counts, per


def golden_shapes():
    """The three [4sm] golden entries of the slice, run on the card."""
    from repro_torch.core import DeviceConfig, SMConfig
    from repro_torch.core.programs import (launch_saxpy, run_fft_batch,
                                           run_qrd_batch)

    golden = json.loads((ROOT / "tests" / "golden_cycles.json").read_text())
    x = np.arange(256, dtype=np.float32)
    runs = {
        "saxpy256_b64[4sm]": lambda: launch_saxpy(
            2.0, x, np.ones_like(x), block=64, device=DeviceConfig(
                n_sms=4, global_mem_depth=1024, engine="megakernel",
                sm=SMConfig(max_steps=10_000)))[1],
        "fft64_batch5[4sm]": lambda: run_fft_batch(
            np.ones((5, 64), np.complex64), device=DeviceConfig(
                n_sms=4, sm=SMConfig(shmem_depth=192,
                                     max_steps=200_000)))[1],
        "qrd16_batch5[4sm]": lambda: run_qrd_batch(
            np.stack([np.eye(16, dtype=np.float32) + 0.1 * i
                      for i in range(5)]), device=DeviceConfig(
                n_sms=4, sm=SMConfig(shmem_depth=1024, imem_depth=1024,
                                     max_steps=200_000)))[2],
    }
    for name, fn in runs.items():
        res = fn()
        got = {"schedule": res.schedule, "cycles": int(res.cycles),
               "steps": int(res.steps),
               "static_cycles": int(res.static_cycles),
               "gmem": int(res.cycles_by_class[-1]),
               "wave_cycles": [int(c) for c in res.wave_cycles]}
        if got != golden[name]:
            raise AssertionError(f"{name}: {got} != golden {golden[name]}")


# ---------------------------------------------------------------------------
# phase 4: timing at the main path's shapes
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
        plain_ms=cuda_time_ms(
            lambda: scatter_shared_plain(gmem, addr_z, vals, mask), iters),
        bytes=2 * gdepth * 4 + n * 512 * (4 + 4 + 1), ops=0,
        shape=f"SAXPY-4096 GST: {n} x 512 lanes, {gdepth}-word image")
    for v in out.values():
        v["bound_ms"] = max(v["bytes"] / PEAK_BYTES_PER_S,
                            v["ops"] / PEAK_FP32_OPS_PER_S) * 1e3
        v["bound_by"] = "bytes" if v["bytes"] / PEAK_BYTES_PER_S \
            >= v["ops"] / PEAK_FP32_OPS_PER_S else "operations"
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    dev = torch.device("cuda")
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
    counts, per = phases.run("main-path", lambda: main_path(rng))
    phases.run("golden-cycles", golden_shapes)
    timing = phases.run("timing", lambda: time_kernels(rng, dev))
    errs = {"segment": seg_err, "gather_shared": g_err,
            "scatter_shared": s_err}

    print(json.dumps({"per_workload": per, "timing_shapes": {
        k: v["shape"] for k, v in timing.items()},
        "phase_ms": phases.ms, "card": card}))
    kernels = [{
        "name": k, "route": "cuda", "source": SOURCES[k],
        "replaces": REPLACES[k], "launches": counts[k],
        "max_abs_err": errs[k], "ms": timing[k]["ms"],
        "plain_ms": timing[k]["plain_ms"], "bound_ms": timing[k]["bound_ms"],
        "bound_by": timing[k]["bound_by"], "library_ms": None,
    } for k in ("segment", "gather_shared", "scatter_shared")]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
