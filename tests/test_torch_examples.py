"""The port's core examples (``examples/torch_*.py``) on the host: every
check they print is True, and their modeled figures are the reference's
for the same launch (computed through ``repro.core.profile`` and the
reference's launch, not by running the reference's examples whole)."""
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from repro.core import DeviceConfig as JDeviceConfig
from repro.core import SMConfig as JSMConfig
from repro.core import assemble as j_assemble
from repro.core.assembler import auto_nop as j_auto_nop
from repro.core import cycles as j_cycles
from repro.core import launch as j_launch
from repro.core import profile as j_profile
from repro.core.programs import fft as j_fft
from repro.core.programs import launch_fft_qrd as j_launch_fft_qrd
from repro.core.programs import qrd as j_qrd
from repro_torch.core import profile

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(scope="module")
def examples():
    sys.path.insert(0, str(EXAMPLES))
    try:
        import torch_fft_pipeline
        import torch_qrd_solver
        import torch_quickstart
        yield types.SimpleNamespace(quickstart=torch_quickstart,
                                    fft=torch_fft_pipeline,
                                    qrd=torch_qrd_solver)
    finally:
        sys.path.remove(str(EXAMPLES))


def _checks(out: str) -> list[str]:
    """The printed checks: every ``True``/``False`` word."""
    words = out.replace(",", " ").split()
    assert "False" not in words, out
    return [w for w in words if w == "True"]


def _trace_profile(words, n_threads, **kw):
    """The reference's profile of a one-SM run of ``words``: the state
    counters of its static trace (what its step engine counts)."""
    tr = j_cycles.program_trace(words, n_threads, **kw)
    return j_profile(types.SimpleNamespace(
        cycles_by_class=np.asarray(tr.cycles_by_class(1)), steps=tr.steps))


def test_quickstart_single_program(examples, capsys):
    res = examples.quickstart.main("cpu")
    assert len(_checks(capsys.readouterr().out)) == 2
    q = examples.quickstart
    prog = j_assemble(j_auto_nop(q.ASM, n_threads=q.BLOCK))
    rng = np.random.default_rng(0)
    x = rng.standard_normal(q.N).astype(np.float32)
    y = rng.standard_normal(q.N).astype(np.float32)
    want = j_launch(
        JDeviceConfig(n_sms=q.N_SMS, global_mem_depth=4 * q.N,
                      sm=JSMConfig(max_steps=1000)),
        prog, grid=(q.N_BLOCKS,), block=q.BLOCK,
        buffers={"x": x, "y": y, "z": np.zeros(q.N, np.float32),
                 "partials": np.zeros(q.N_BLOCKS, np.float32)})
    assert res.profile() == want.profile()
    assert [int(c) for c in res.wave_cycles] \
        == [int(c) for c in want.wave_cycles]


def test_quickstart_mixed_launch(examples, capsys):
    res = examples.quickstart.main_mixed("cpu")
    assert len(_checks(capsys.readouterr().out)) == 2
    xs, As = examples.quickstart.mixed_inputs()
    # the modeled figures are the timing model's, whatever engine runs the
    # blocks: the reference's step engine is the quickest here
    want = j_launch_fft_qrd(xs, As, engine="step")[3].profile()
    got = res.profile()
    for k in ("total_cycles", "static_cycles", "instructions", "by_class",
              "per_program", "per_sm", "gmem_port", "schedule"):
        assert got[k] == want[k], k
    assert res.engine == "megakernel"


def test_fft_pipeline(examples, capsys):
    st = examples.fft.main("cpu")
    assert len(_checks(capsys.readouterr().out)) == 2
    want = _trace_profile(j_fft.fft_program(256).words, 128,
                          max_steps=200_000)
    assert profile(st) == want


def test_qrd_solver(examples, capsys):
    st = examples.qrd.main("cpu")
    assert len(_checks(capsys.readouterr().out)) == 2
    want = _trace_profile(j_qrd.qrd_program().words, 256, imem_depth=1024,
                          max_steps=200_000)
    assert profile(st) == want


def test_examples_raise_without_a_card_by_default(examples, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (examples.quickstart.main, examples.fft.main,
                examples.qrd.main):
        with pytest.raises(RuntimeError, match="CUDA device"):
            run()
