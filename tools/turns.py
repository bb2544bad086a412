#!/usr/bin/env python3
"""Time one kernel, or the launch paths, of two or more checkouts in
turns, on one card.

    python3 tools/turns.py KERNEL ROOT_A ROOT_B [...]

KERNEL is ``segment``, ``qrd``, ``gmem``, ``dot``, ``paths`` or
``coldstart``. It runs the roots in order
and then in reverse (A, B, B, A for two), each turn one process on that
checkout's ``src``: the process builds the checkout's kernels in its own
``build/`` and times the kernel at fixed shapes, each held ``==`` to its
plain version first. ``ms`` is CUDA events over 200 launches with the
host's cost per launch, ``device_ms`` the card alone (50 launches queued
behind a sleep kernel). Each turn prints one JSON line after the card's
name and power limit.

- ``segment``: ``simt_segment`` on one wave of four SMs of QRD-16 and of
  FFT-64 (``chip_smoke.segment_wave``'s shapes: the plan's one fused
  segment, zero registers, the programs' own shared-memory images of
  seeded random inputs), held to ``apply_segment_rows``. A checkout whose
  plan places barriers (``MegakernelPlan.device_barriers``) hands them to
  its kernel.
- ``qrd``: ``mgs_qrd`` at ``chip_smoke.QRD_SHAPES`` on
  ``chip_smoke.qrd_batch``'s input, held to ``mgs_qrd_plain``.
- ``gmem``: a whole GLD and GST handler call of the execute stage
  (``executor.make_data_handlers`` on the ``"cuda"`` backend, whatever
  the checkout's handler runs) on one SAXPY-4096 wave
  (``chip_smoke.gmem_wave``: four 512-thread SMs, the 12304-word image),
  each first held ``==`` the ``"cpu"`` backend's handler on host copies
  of the same state; and the GST handler on the card alone at 1, 4 and
  16 SMs (``gst_device_ms_by_sms``), its cost per lane.
- ``dot``: ``wavefront_dot`` (DOT, every lane) at 16 x 512 and 4096 x
  512, and at 4096 x 512 with a's lanes 12-15 zero and with every
  wavefront on the exact path (``chip_smoke.time_dot``, its
  ``DOT_FILLS``: held ``==`` its plain version, then warm, one input
  set, and cold, the calls rotating through input sets of twice the
  card's 50 MB L2, each as ``ms`` and ``device_ms``), and the static
  SASS instructions of each kernel of the checkout's ``dot`` library
  (``cuobjdump -sass``, NOPs left out).
- ``paths``: not one kernel but the host's cost around them: a launch of
  QRD-16 x 16, of FFT-64 x 64 and of SAXPY-4096 (grid 8 x 512, its 8
  GLD/GST rows a wave) on four SMs through the megakernel, step and trace
  engines, and of two heterogeneous grids: FFT-64 x 64 interleaved with
  QRD-16 x 16 (``launch_fft_qrd``) and the fused reduction of 1024
  elements, which the megakernel and trace engines run in merged waves
  and the step engine program-major (a checkout without merged waves
  raises on those two engines; its turn records ``raises``), each timed
  on the host's clock to the end of ``torch.cuda.synchronize()`` six
  times (``first_ms`` the first, with its host lowering; ``median_ms``
  the median of the other five), then held to the same launch on the
  host (``chip_smoke.same_launch``). Then the same grid of FFT-64 + QRD-16
  on a fleet of two devices (``fleet2_fft64_qrd16``, through "auto") and
  the serve benchmark's 24-request trace on a LaunchServer one request a
  launch and batched (``serve24_serial``/``serve24_batched``,
  ``chip_smoke.serve_run``), each held to its host run (a checkout
  without the fleet or the server records ``raises``). A fresh process
  per turn keeps what else ran before out of the times.

- ``coldstart``: the first launch of the merged FFT-64 x 64 + QRD-16 x
  16 grid (``chip_smoke.coldstart_child``: ``launch_fft_qrd`` on
  ``mixed_device(64, n_sms=4)`` through "auto", the kernels' libraries and
  the card's context loaded before the clock) in a fresh process with an
  empty compile cache (``EGPU_CACHE_DIR``), then in another fresh process
  with the cache the first one filled, ``COLDSTART_PAIRS`` such pairs a
  turn: each run's ``first_ms`` and the cache's stats under ``cold`` and
  ``warm``, and their medians; every launch must be equal by state and
  profile. A checkout without the cache records its plain first launch
  in both places (its stats ``null``), so its cold-to-warm difference is
  what the order of the two processes alone gives.

    python3 tools/turns.py segment --rows ROOT

times one checkout's segment kernel (card alone) on the first k rows of
each wave, k = 1, a quarter, a half and all of them, with the plan's
barriers and with both barriers on every row: the slope is the cost per
row, the intercept the launch with its copies in and out, and the
difference between the two what the barriers the plan leaves out would
cost.
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def segment(cs, root: Path, prefixes: bool = False) -> dict:
    import numpy as np
    import torch
    from repro_torch.core import SMConfig, compile_megakernel
    from repro_torch.core.executor import apply_segment_rows
    from repro_torch.core.programs import fft_shmem, qrd_program, qrd_shmem
    from repro_torch.core.programs.fft import fft_program
    from repro_torch.kernels.simt_step import simt_segment

    dev = torch.device("cuda")
    rng = np.random.default_rng(20260611)
    waves = {
        "qrd16": (qrd_program(), SMConfig(n_threads=256, dim_x=16,
                                          imem_depth=1024,
                                          max_steps=200_000),
                  lambda: qrd_shmem(rng.standard_normal((16, 16)), 3072)),
        "fft64": (fft_program(64), SMConfig(n_threads=32, dim_x=32,
                                            max_steps=200_000),
                  lambda: fft_shmem((rng.standard_normal(64) + 1j
                                     * rng.standard_normal(64)).astype(
                                         np.complex64), 3072))}
    out = {}
    for name, (program, cfg, image) in waves.items():
        plan = compile_megakernel(program, cfg)
        ((_, (start, stop)),) = plan.items
        rows = plan.device_table(dev)[start:stop]
        kw = ({"barriers": plan.device_barriers(dev)[start:stop]}
              if hasattr(plan, "device_barriers") else {})
        state = (torch.arange(4, dtype=torch.int32, device=dev),
                 torch.zeros(4, dtype=torch.int32, device=dev),
                 torch.zeros((4, 512, 16), dtype=torch.int32, device=dev),
                 torch.from_numpy(np.stack([image() for _ in range(4)])
                                  .view(np.int32)).to(dev),
                 torch.zeros(4, dtype=torch.bool, device=dev))
        got = simt_segment(cfg, rows, *state, **kw)
        want = apply_segment_rows(cfg, plan.sched.table[start:stop], *state)
        for g, w in zip(got, want):
            cs.words_equal(f"segment {name}", g, w)
        kern = lambda: simt_segment(cfg, rows, *state, **kw)  # noqa: E731
        out[name] = dict(rows=stop - start, ms=cs.cuda_time_ms(kern, 200),
                         device_ms=cs.cuda_device_ms(kern))
        if prefixes:
            n = stop - start
            every = torch.full_like(kw["barriers"], 3)
            out[name]["prefix_device_ms"] = {
                k: [cs.cuda_device_ms(lambda: simt_segment(
                    cfg, rows[:k], *state, barriers=bits[:k]))
                    for bits in (kw["barriers"], every)]
                for k in (1, n // 4, n // 2, n)}
    return out


def qrd(cs, root: Path) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels.mgs_qrd import mgs_qrd, mgs_qrd_plain

    rng = np.random.default_rng(20260611)
    out = {}
    for name, batch, n in cs.QRD_SHAPES:
        a = torch.from_numpy(cs.qrd_batch(rng, batch, n)).cuda()
        for g, w in zip(mgs_qrd(a), mgs_qrd_plain(a)):
            cs.words_equal(f"{name} {root}", g.view(torch.int32),
                           w.view(torch.int32))
        kern = lambda: mgs_qrd(a)  # noqa: E731
        out[name] = dict(shape=f"QRD-{n} x {batch}",
                         ms=cs.cuda_time_ms(kern, 200),
                         device_ms=cs.cuda_device_ms(kern))
    return out


def gmem(cs, root: Path) -> dict:
    import numpy as np
    import torch
    from repro_torch.core.executor import (get_execute_backend,
                                           make_data_handlers)

    dev = torch.device("cuda")
    rng = np.random.default_rng(20260611)
    cfg, gld, gst, state = cs.gmem_wave(rng, dev)
    n = state[0].shape[0]
    out = {}
    for name, row in (("gld_row", gld), ("gst_row", gst)):
        host = tuple(x.cpu() for x in state)
        idx = torch.arange(n, dtype=torch.int32)
        want = make_data_handlers(cfg, get_execute_backend("cpu"), row, idx,
                                  idx)[row.sel](host)
        h = make_data_handlers(cfg, get_execute_backend("cuda"), row,
                               idx.to(dev), idx.to(dev))[row.sel]
        got = h(tuple(x.clone() for x in state))
        for what, g, w in zip(("regs", "shmem", "gmem", "oob"), got, want):
            cs.words_equal(f"{name} {what} {root}", g, w)
        out[name] = dict(ms=cs.cuda_time_ms(lambda: h(state), 200),
                         device_ms=cs.cuda_device_ms(lambda: h(state)))
    out["gst_device_ms_by_sms"] = {}
    for k in (1, 4, 16):
        cfg, _, gst, wave = cs.gmem_wave(rng, dev, k)
        idx = torch.arange(k, dtype=torch.int32, device=dev)
        h = make_data_handlers(cfg, get_execute_backend("cuda"), gst, idx,
                               idx)[gst.sel]
        out["gst_device_ms_by_sms"][k] = cs.cuda_device_ms(lambda: h(wave))
    return out


def sass_counts(lib: Path) -> dict:
    """Static SASS instructions of each kernel in a built library, NOPs
    left out (``cuobjdump -sass``)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    counts, name = {}, None
    for line in text.splitlines():
        fn = re.match(r"\s*Function : (\S+)", line)
        if fn:
            name = fn.group(1)
            counts[name] = 0
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(\S+)", line)
        if name and ins and not ins.group(1).startswith("NOP"):
            counts[name] += 1
    return counts


def dot(cs, root: Path) -> dict:
    import torch
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    out = {f"dot{n_sm}": cs.time_dot(dev, n_sm) for n_sm in (16, 4096)}
    for fill in ("zeros", "exact"):
        out[f"dot4096_{fill}"] = cs.time_dot(dev, 4096, fill=fill)
    out["sass"] = sass_counts(build.build_all()["dot"])
    return out


def paths(cs, root: Path) -> dict:
    import time

    import numpy as np
    import torch
    from repro_torch.core import DeviceConfig, SMConfig
    from repro_torch.core.programs import (launch_fft_qrd, launch_reduction,
                                           launch_saxpy, run_fft_batch,
                                           run_qrd_batch)

    rng = np.random.default_rng(20260611)
    As = rng.standard_normal((16, 16, 16)).astype(np.float32)
    xs = (rng.standard_normal((64, 64))
          + 1j * rng.standard_normal((64, 64))).astype(np.complex64)
    x, y = rng.standard_normal((2, 4096)).astype(np.float32)
    xr = rng.standard_normal(1024).astype(np.float32)
    work = {"qrd16": (lambda d: run_qrd_batch(As, device=d)[2],
                      dict(sm=SMConfig(imem_depth=1024, max_steps=200_000))),
            "fft64": (lambda d: run_fft_batch(xs, device=d)[1],
                      dict(sm=SMConfig(max_steps=200_000))),
            "saxpy4096": (lambda d: launch_saxpy(2.5, x, y, device=d,
                                                 block=512)[1],
                          dict(global_mem_depth=3 * 4096 + 16,
                               sm=SMConfig(max_steps=10_000))),
            # mixed_device(64)'s SMConfig
            "fft64_qrd16": (lambda d: launch_fft_qrd(xs, As, device=d)[3],
                            dict(sm=SMConfig(shmem_depth=1024,
                                             imem_depth=1024,
                                             max_steps=200_000))),
            "reduction1024_fused": (
                lambda d: launch_reduction(xr, block=256, fused=True,
                                           device=d)[1],
                dict(global_mem_depth=2048, sm=SMConfig(max_steps=50_000)))}
    def timed(run):
        """(first_ms, median_ms of five more, the last result)"""
        walls = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return dict(first_ms=walls[0],
                    median_ms=float(np.median(walls[1:]))), res

    out = {}
    for name, (run, kw) in work.items():
        for engine in ("megakernel", "step", "trace"):
            dev = DeviceConfig(n_sms=4, engine=engine, **kw)
            try:
                out[f"{name}_{engine}"], res = timed(lambda: run(dev))
            except NotImplementedError as e:
                out[f"{name}_{engine}"] = dict(raises=str(e))
                continue
            cs.same_launch(f"{name} {engine}", res, run(DeviceConfig(
                n_sms=4, engine=engine, backend="cpu", **kw)))

    # the fleet of two devices on the mixed grid (beside its plain launch,
    # fft64_qrd16_megakernel), and the serve benchmark's trace one request
    # a launch and batched; a checkout without them records ``raises``
    fleet_names = ("fleet2_fft64_qrd16", "serve24_serial", "serve24_batched")
    try:
        from repro_torch.core import FleetConfig, launch_fleet
        from repro_torch.core.programs import mixed_device
        from repro_torch.serve import LaunchServer  # noqa: F401
    except ImportError as e:
        out.update({k: dict(raises=str(e)) for k in fleet_names})
        return out
    grid = cs.fft_qrd_grid(xs, As, 1024)

    def fleet(backend=None):
        return launch_fleet(FleetConfig(n_devices=2, device=mixed_device(
            64, n_sms=4, backend=backend)), **grid)
    out["fleet2_fft64_qrd16"], res = timed(fleet)
    cs.same_launch("fleet2_fft64_qrd16", res, fleet("cpu"))
    trace = cs.serve_trace(24)
    for line, max_batch in (("serial", 1), ("batched", 8)):
        out[f"serve24_{line}"], got = timed(
            lambda: cs.serve_run(trace, max_batch))
        cs.same_results(f"serve24_{line}", got,
                        cs.serve_run(trace, max_batch, "cpu"))
        out[f"serve24_{line}"].update(cs.serve_line(got))
    return out


COLDSTART_PAIRS = 3


def coldstart(cs, root: Path) -> dict:
    import tempfile

    import numpy as np

    (HERE / "build").mkdir(exist_ok=True)
    out = {"cold": [], "warm": []}
    first = None
    for _ in range(COLDSTART_PAIRS):
        with tempfile.TemporaryDirectory(dir=HERE / "build") as d:
            pair = cs.coldstart_pair(root, Path(d))
        for run in pair:
            first = first or run
            for k, v in run["state"].items():
                if not np.array_equal(v, first["state"][k]):
                    raise AssertionError(f"coldstart: {k} differs")
            if run["profile"] != first["profile"]:
                raise AssertionError("coldstart: profile() differs")
            out[run["turn"]].append(
                {k: run[k] for k in ("first_ms", "engine", "stats")})
    for turn in ("cold", "warm"):
        out[f"{turn}_median_ms"] = float(np.median(
            [r["first_ms"] for r in out[turn]]))
    return out


KERNELS = {"segment": segment, "qrd": qrd, "gmem": gmem, "dot": dot,
           "paths": paths, "coldstart": coldstart}


def one(kernel: str, root: Path, prefixes: bool = False) -> dict:
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs                  # the timing helpers
    sys.path.insert(0, str(root / "src"))    # the checkout under test
    import repro_torch

    if not Path(repro_torch.__file__).is_relative_to(root):
        raise RuntimeError(f"repro_torch was not imported from {root}")
    kw = {"prefixes": True} if prefixes else {}
    return {"root": str(root), **KERNELS[kernel](cs, root, **kw)}


def main(argv: list[str]) -> int:
    if len(argv) < 3 or argv[0] not in KERNELS:
        print(__doc__, file=sys.stderr)
        return 2
    kernel, mode = argv[0], argv[1]
    if mode in ("--one", "--rows") and len(argv) == 3:
        if mode == "--rows" and kernel != "segment":
            print("--rows times the segment kernel only", file=sys.stderr)
            return 2
        print(json.dumps(one(kernel, Path(argv[2]).resolve(),
                             prefixes=mode == "--rows")), flush=True)
        return 0
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs

    print(cs.card_line(), flush=True)
    roots = [str(Path(r).resolve()) for r in argv[1:]]
    for root in roots + roots[::-1]:
        subprocess.run([sys.executable, __file__, kernel, "--one", root],
                       check=True, timeout=600)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
