"""The benchmark's cell at smoke sizes on the CPU: the plain reference
against the port through the harness's own runs (training steps through
``make_train_step``), the planted faults that the output check must
fail, and a cell added as files alone."""
from __future__ import annotations

import json
import shutil

import pytest
from bench_smoke import BENCH, root_with, run_smoke

from harness import cli, faults

TRAIN = "granite-3-2b.train"


def test_port_agrees_with_the_reference():
    run = run_smoke(TRAIN)
    assert run.correct, run.checks
    assert run.attempted == 1 and run.failed == 0
    line = cli.result_line(run, {})
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {m.name for m in run.cell.end_to_end}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert [n for n, _ in run.marks] == [
        "import the program", "weights", "model, state", "step 0", "step 1",
        "step 2", "change norms"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_planted_fault_is_not_correct(fault):
    run = run_smoke(TRAIN, hooks=faults.FAULTS[fault])
    assert not run.correct, run.checks


def test_traced_run_reports_its_per_layer_metrics_that_need_no_card():
    run = run_smoke(TRAIN, trace=True)
    line = cli.result_line(run, {})
    assert run.correct
    # the card's metrics have nothing to read on the host
    assert set(line["metrics"]) == {"mfu.train"}
    assert 0 < line["metrics"]["mfu.train"]["value"]
    assert "breakdown" not in line


def test_a_cell_added_as_files_alone_runs(tmp_path):
    """A second training mix (8 x 256 tokens a step, two checked steps)
    with a metric of its own: a traffic file, a limits file, a reader and
    entries in ``BENCHMARK.json``, with the harness untouched."""
    bench = tmp_path / "bench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(BENCH / sub, bench / sub)
    traffic = json.loads((BENCH / "traffic" / "train.json").read_text())
    traffic.update(batch=8, seq_len=256, check_steps=2)
    (bench / "traffic" / "train-short.json").write_text(json.dumps(traffic))
    name = "granite-3-2b.train-short"
    shutil.copy(BENCH / "limits" / f"{TRAIN}.json",
                bench / "limits" / f"{name}.json")
    (bench / "metrics" / "steps_done.py").write_text(
        "def read(run):\n    return len(run.steps) or None\n")
    root = root_with({
        "workloads": [{"name": name, "config": "granite-3-2b",
                       "traffic": "train-short", "chips": 1,
                       "why": "short rows"}],
        "per_layer": [{"name": "steps_done", "unit": "steps",
                       "better": "higher", "source": "host_clock",
                       "layer": "whole training step",
                       "moves": "train_tokens_per_s", "workloads": [name]}],
    }, tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for m in spec["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    run = run_smoke(name, root=root, bench_dir=bench, trace=True)
    assert run.correct, run.checks
    assert run.cell.traffic["check_steps"] == 2
    assert [n for n, _ in run.marks][-3:] == ["step 0", "step 1",
                                              "change norms"]
    line = cli.result_line(run, {})
    assert line["metrics"]["steps_done"]["value"] == 1
    assert {m.name for m in run.cell.end_to_end} == \
        {"train_tokens_per_s", "setup_s"}
