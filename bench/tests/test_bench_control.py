"""The control on the card at a size a test run holds: the published
widths at four layers. The reference in TF32 put in the program's place
must read at least three times what the sound program reads on one of
the cell's numbers, and above the cell's limit; the program stays within
every limit. The cell's own size is measured by ``bench/calibrate.py``
(PERF.md)."""
from __future__ import annotations

import gc

import pytest
import torch
from bench_smoke import ROOT

from harness import cells, train
from harness.record import Run


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _separates(got: dict, ctl: dict, limits: dict):
    assert all(got[k] <= limits[k] for k in limits), got
    assert any(ctl[k] > limits[k] and ctl[k] >= 3 * got[k] for k in limits), \
        (got, ctl)


@pytest.mark.cuda
def test_tf32_control_fails_the_training_check_on_the_card():
    _card()
    cell = cells.load(ROOT, "granite-3-2b.train")
    cell.config = dict(cell.config, model=dict(cell.model, n_layers=4))
    cell.traffic = dict(cell.traffic, batch=2, seq_len=256)
    run = Run(cell, 5_123_456_789, 0.0, False, "cuda")
    prog = train.Program(run, 512)
    got = prog.first_steps(run, int(cell.traffic["check_steps"]))
    del prog
    gc.collect()
    ref = train.reference(run)
    ctl = train.reference(run, tf32=True)
    _separates(train.compare(got, ref), train.compare(ctl, ref), cell.limits)
