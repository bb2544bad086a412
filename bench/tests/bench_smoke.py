"""Helpers of the benchmark's CPU tests: the cells' own traffic and
models cut to a size a test run holds, and checkout roots with cells
added. (A module of its own name: the repository's ``tests/conftest.py``
is the one ``import conftest`` finds.)"""
from __future__ import annotations

import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SMOKE_MODEL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                   head_dim=16, d_ff=128, vocab_size=500, vocab_pad=64)
SMOKE_TRAFFIC = dict(batch=2, seq_len=24, profile_steps=1)


def root_with(entries: dict, tmp: Path) -> Path:
    """A checkout root at ``tmp``: this ``bench/`` and a BENCHMARK.json
    with ``entries`` added to its lists."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key, items in entries.items():
        spec[key] = spec[key] + items
    tmp.mkdir(parents=True, exist_ok=True)
    if not (tmp / "bench").exists():
        (tmp / "bench").symlink_to(BENCH)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


def smoke(cell):
    """``cell`` with its model and traffic cut to smoke sizes."""
    cell.config = dict(cell.config, model=dict(cell.model, **SMOKE_MODEL))
    cell.traffic = dict(cell.traffic, **SMOKE_TRAFFIC)
    return cell


def run_smoke(workload: str, seed: int = 1234567890123, trace=False,
              hooks=None, root=None, bench_dir=None):
    """One run of ``workload`` at smoke sizes on the CPU. Its window is
    ``--seconds 0``: exactly one timed step, whatever the load on the
    machine."""
    import time

    from harness import cells, cli
    from harness.record import Run

    cell = smoke(cells.load(root or ROOT, workload, bench_dir))
    run = Run(cell, seed, 0.0, trace, "cpu")
    cli.drive(run, time.perf_counter(), hooks)
    return run
