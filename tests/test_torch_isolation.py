"""The port stands alone: it imports neither JAX nor the JAX package."""
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = """
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["repro"] = None
sys.path[:0] = [{src!r}, {root!r}]
import importlib, pkgutil
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke
assert not any(k == "jax" or k.startswith(("jax.", "repro."))
               for k, v in sys.modules.items() if v is not None)
print("ok")
"""


def test_port_and_chip_smoke_import_without_jax_or_the_reference():
    out = subprocess.run(
        [sys.executable, "-c",
         _PROBE.format(src=str(ROOT / "src"), root=str(ROOT))],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_no_port_source_names_the_reference_package():
    pat = re.compile(r"\b(?:repro(?!_torch)|jax)\b")
    hits = [f"{p.relative_to(ROOT)}:{i}: {line.strip()}"
            for p in sorted(PORT.rglob("*"))
            if p.suffix in (".py", ".cu", ".cuh")
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pat.search(line) and "src/repro/" not in line]
    assert not hits, "\n".join(hits)
