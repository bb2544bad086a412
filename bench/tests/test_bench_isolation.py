"""What the benchmark may load and read: nothing ``bench/run.py`` imports
has the top-level name ``jax``, ``jaxlib``, ``flax`` or ``repro``
(compared whole: the port is ``repro_torch``); the reference imports
nothing of the port; nothing reads the JAX package's ``benchmarks/``;
without a card the command prints no result and fails."""
from __future__ import annotations

import ast
import re
import subprocess
import sys

from bench_smoke import BENCH, ROOT

_PROBE = """
import sys
for name in ("jax", "jaxlib", "flax", "repro"):
    sys.modules[name] = None          # importing one raises
sys.path[:0] = [{bench!r}, {src!r}, {tests!r}]
import bench_smoke
from harness import cli
run = bench_smoke.run_smoke("granite-3-2b.train", trace=True)
assert run.correct, run.checks
for name in ("jax", "jaxlib", "flax", "repro"):
    del sys.modules[name]
assert cli.forbidden_modules() == [], cli.forbidden_modules()
assert "repro_torch" in sys.modules
sys.modules["repro"] = object()
assert cli.forbidden_modules() == ["repro"]
print("ok")
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(
            bench=str(BENCH), src=str(ROOT / "src"),
            tests=str(BENCH / "tests"))],
        capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def _imports(path):
    tree = ast.parse(path.read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    return {m.split(".")[0] for m in names}


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").glob("*.py")):
        assert _imports(path) <= {"__future__", "math", "numpy", "torch"}, \
            path.name


def test_nothing_reads_the_jax_packages_benchmarks():
    pat = re.compile(r"benchmarks/|BENCH_\w+\.json|\brepro\b(?!_torch)")
    hits = [f"{p.relative_to(ROOT)}:{i}"
            for p in sorted(BENCH.rglob("*.py"))
            if p.parent.name != "tests"
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pat.search(line) and "FORBIDDEN" not in line]
    assert not hits, hits


def test_without_a_card_the_command_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "granite-3-2b.train",
         "--seed", "5000000000", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
