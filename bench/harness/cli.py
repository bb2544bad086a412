"""The command: one run of one cell, its result as the last line of
standard output, the numbers of its output check as the last lines of
standard error."""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

from . import cells
from .record import Run

# top-level modules the process must not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    return sorted({k.split(".")[0] for k, v in sys.modules.items()
                   if v is not None and k.split(".")[0] in FORBIDDEN})


def set_cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = root / "build" / "bench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def drive(run: Run, t0: float, hooks=None) -> None:
    """Runs the cell with the module its traffic's kind names
    (``harness/train.py``)."""
    import importlib
    importlib.import_module(f"harness.{run.cell.traffic['kind']}").drive(
        run, t0, hooks)


def result_line(run: Run, device: dict) -> dict:
    metrics = {}
    for m in run.cell.metrics(run.trace):
        value = m.read(run)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    line = {"correct": run.correct, "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics, "device": device}
    if run.trace and run.profile is not None and run.profile.has_device:
        p = run.profile
        device["busy_s"] = p.busy_s()
        device["window_s"] = p.window_s()
        line["breakdown"] = {"device_ops": p.top_ops(),
                             "idle_gaps": p.idle_gaps()}
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in run.checks.items()}
    return line


def main(argv, root: Path, t0: float) -> int:
    ap = argparse.ArgumentParser(prog="bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs(root)
    cell = cells.load(root, args.workload)

    run = Run(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    import torch
    run.mark("import torch")
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.zeros(1, device="cuda")
    run.mark("CUDA context")
    drive(run, t0)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    line = result_line(run, device)
    last = t0
    for name, t in run.marks:
        print(f"setup {name} {t - last!r} s", file=sys.stderr)
        last = t
    for k, (v, lim) in run.checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0
