"""Finds a cell's files by the names in ``BENCHMARK.json``: its
configuration (``file``), its traffic mix (``<bench>/traffic/<traffic>.json``),
the limits of its output check (``<bench>/limits/<workload>.json``) and a
reader per metric (``<bench>/metrics/<metric>.py``, a ``read(run)`` that
returns a number or None). A cell added as files and entries alone runs
with no edit here."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent


@dataclass
class Metric:
    name: str
    unit: str
    reader: object = None       # the module of ``metrics/<name>.py``

    def read(self, run):
        return self.reader.read(run)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict                # the configuration's file
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    @property
    def model(self) -> dict:
        return self.config["model"]

    def metrics(self, trace: bool) -> list:
        return self.per_layer if trace else self.end_to_end


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reader(bench_dir: Path, name: str):
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load(root: Path, workload: str, bench_dir: Path | None = None) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``."""
    root = Path(root)
    bench_dir = Path(bench_dir) if bench_dir else BENCH_DIR
    spec = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"there are {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    cell = Cell(name=workload, chips=int(w["chips"]),
                config=_load_json(root / conf["file"]),
                traffic=_load_json(bench_dir / "traffic"
                                   / f"{w['traffic']}.json"),
                limits=_load_json(bench_dir / "limits" / f"{workload}.json"))
    cell.end_to_end = [Metric(m["name"], m["unit"]) for m in spec["end_to_end"]
                       if workload in m.get("workloads", [workload])]
    reported = {m.name for m in cell.end_to_end}
    # a per-layer metric without ``workloads`` belongs to every cell that
    # reports the end-to-end metric it moves
    cell.per_layer = [Metric(m["name"], m["unit"]) for m in spec["per_layer"]
                      if (workload in m["workloads"] if "workloads" in m
                          else m["moves"] in reported)]
    for m in cell.end_to_end + cell.per_layer:
        m.reader = _reader(bench_dir, m.name)
    return cell
