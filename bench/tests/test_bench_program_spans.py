"""The readers of the port's spans on a trace made by hand: each reads the
known card ms and share, an idle gap is put down to the innermost port
span open at the launch that ends it, and each reads None without a
card, where the program recorded no spans, or where the trace's stream
queries do not match the spans' boundaries one for one. The harness's
traced sub-window records the port's spans on the trace's clock by their
marks, and records nothing from a program without the recorder."""
from __future__ import annotations

import importlib.util
import sys
import time
from contextlib import contextmanager

import pytest
from bench_smoke import BENCH

from harness import program_spans
from harness.record import Run
from harness.trace import Spans, Trace

from repro_torch.spans import Record

STEPS = 2
NEW = ("attention_ms.train", "attention_scores_ms.train", "ffn_ms.train",
       "vocab_ms.train", "clip_ms.train", "adamw_ms.train",
       "adamw_hbm_share.train", "idle_in_program_ms.train")


def _host(us):
    """Host seconds of ``us`` microseconds after the marker's launch."""
    return 100.0 + us * 1e-6


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "r_" + name.replace(".", "_"), BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# (launched, start, length, name, cat), in us after the marker's launch
OPS = [(0, 2, 1, "marker", "kernel"),
       (15, 30, 10, "embedding_kernel", "kernel"),          # embed
       (25, 40, 20, "sm80_xmma_gemm_f32", "kernel"),        # attn
       (50, 70, 30, "softmax_kernel", "kernel"),            # attn.scores
       (150, 150, 100, "cutlass_80_simt_sgemm", "kernel"),  # ffn
       (210, 250, 30, "elementwise_kernel", "kernel"),      # head
       (450, 460, 10, "reduce_kernel", "kernel"),           # optim.clip
       (600, 600, 40, "elementwise_kernel", "kernel"),      # optim.adamw
       (650, 640, 60, "Memcpy HtoD", "gpu_memcpy"),         # optim.adamw
       (850, 860, 10, "reduce_kernel", "kernel")]           # no port span

# (name, start, end, counts) in us; ids in this order
SPANS = [("train.step", 10, 800, {}),
         ("train.forward", 11, 300, {}),
         ("embed", 12, 19, {}),
         ("attn", 20, 100, {}),
         ("attn.scores", 40, 80, {}),
         ("ffn", 100, 200, {}),
         ("head", 200, 290, {}),
         ("optim.clip", 400, 500, {}),
         ("optim.adamw", 500, 700, {"bytes": 28 * 10 ** 6})]


def _event(cat, ts, n, name, corr):
    return {"ph": "X", "cat": cat, "ts": 1000 + ts, "dur": n, "name": name,
            "args": {"correlation": corr}}


def _trace(marks=True, late_us=0.0, extra_mark=False):
    """A trace of ``OPS`` and the port's ``SPANS``, whose boundaries leave
    a stream query each in it where ``marks`` (and one more with
    ``extra_mark``); the records' host times lie ``late_us`` late, as the
    host clock's mapping may put them."""
    events = []
    for i, (launch, start, n, name, cat) in enumerate(OPS):
        events.append(_event("cuda_runtime", launch, 1, "cudaLaunchKernel",
                             i + 1))
        events.append(_event(cat, start, n, name, i + 1))
    crossed = sorted([(a, i, 0) for i, (_, a, _, _) in enumerate(SPANS)]
                     + [(b, i, 1) for i, (_, _, b, _) in enumerate(SPANS)])
    mark = {(i, end): k for k, (_, i, end) in enumerate(crossed)}
    if marks:
        events += [_event("cuda_runtime", t, 1, "cudaStreamQuery", 100 + k)
                   for k, (t, _, _) in enumerate(crossed)]
    if extra_mark:
        events.append(_event("cuda_runtime", 950, 1, "cudaStreamQuery", 99))
    window = (_host(0), _host(1000))
    trace = Trace(events, window, [(_host(5), _host(900), "step")])
    records = [Record(i, name, None, 0, _host(a + late_us), mark[i, 0],
                      _host(b + late_us), mark[i, 1], counts)
               for i, (name, a, b, counts) in enumerate(SPANS)]
    program_spans.attach(trace, records, events)
    return trace


def _run(trace):
    run = Run(cell=None, seed=0, seconds=1.0, trace=True, device="cuda")
    run.profile = trace
    run.counters["profile_steps"] = STEPS
    return run


@pytest.mark.parametrize("late_us", [0.0, 40.0])
def test_readers_read_the_known_card_ms_and_share(late_us):
    # placed by the boundaries' marks, whatever the host clock says
    trace = _trace(late_us=late_us)
    run = _run(trace)
    got = {name: _reader(name)(run) for name in NEW}
    want = {"attention_ms.train": (20 + 30) / 1e3,
            "attention_scores_ms.train": 30 / 1e3,
            "ffn_ms.train": 100 / 1e3,
            "vocab_ms.train": (10 + 30) / 1e3,
            "clip_ms.train": 10 / 1e3,
            "adamw_ms.train": (40 + 60) / 1e3,
            "idle_in_program_ms.train": (27 + 10 + 50 + 180 + 130) / 1e3}
    for name, ms in want.items():
        assert got[name] == pytest.approx(ms / STEPS), name
    assert got["adamw_hbm_share.train"] == pytest.approx(
        100 * 28e6 / (100e-6 * 3.35e12))


def test_a_gap_goes_to_the_innermost_span_open_at_its_ending_launch():
    run = _run(_trace())
    # the gap before the embedding kernel ends with a launch inside
    # embed, inside train.forward, inside train.step; the gaps ended by
    # the marker's launch and by the launch at 850 lie outside every port
    # span and are left out, and so is the gap after the last operation
    idle = program_spans.idle_by_span(run)
    assert idle == pytest.approx({"embed": 27e-6, "attn.scores": 10e-6,
                                  "ffn": 50e-6, "optim.clip": 180e-6,
                                  "optim.adamw": 130e-6})
    rows = program_spans.table(run)
    assert rows["attn"]["products"] == pytest.approx(20e-3 / STEPS)
    assert rows["attn"]["rest"] == pytest.approx(30e-3 / STEPS)
    assert rows["attn"]["self_rest"] == 0.0
    assert rows["attn.scores"]["self_rest"] == pytest.approx(30e-3 / STEPS)
    assert rows["train.step"]["rest"] == pytest.approx(
        (10 + 30 + 30 + 10 + 40 + 60) / 1e3 / STEPS)
    assert rows["(none)"]["self_rest"] == pytest.approx(
        (1 + 10) / 1e3 / STEPS)
    assert rows["(none)"]["idle"] == pytest.approx((2 + 160) / 1e3 / STEPS)


def _no_recorder():
    trace = _trace()
    del trace.program_spans
    return trace


@pytest.mark.parametrize("trace", [
    lambda: None,                             # no card
    _no_recorder,                             # a program without it
    lambda: _trace(marks=False),              # no stream query
    lambda: _trace(extra_mark=True)],         # one query too many
    ids=["no-card", "no-recorder", "no-marks", "unmatched-marks"])
def test_readers_read_none_without_a_card_or_without_spans(trace):
    run = _run(trace())
    assert all(_reader(name)(run) is None for name in NEW)


def _profiled(n_marks):
    """The harness's ``profiled`` on the host: a trace of one marker
    kernel, launched at the window's start, 5 ms into the trace's clock,
    and of ``n_marks`` stream queries 100 us apart after it."""
    from harness import trace as trace_mod

    @contextmanager
    def profiled(name, spans, out):
        a = time.perf_counter()
        spans.on = True
        yield
        spans.on = False
        events = [_event("cuda_runtime", 4000, 1, "cudaLaunchKernel", 1),
                  _event("kernel", 4002, 1, "marker", 1)]
        events += [_event("cuda_runtime", 4100 + 100 * k, 1,
                          "cudaStreamQuery", 10 + k) for k in range(n_marks)]
        out.append(trace_mod.Trace(events, (a, time.perf_counter()),
                                   list(spans.spans)))
    return profiled


def _steps(profiled):
    """One step of two spans through ``profiled`` wrapped by the harness;
    the trace it made."""
    from repro_torch import spans as port

    out = []
    with program_spans._recording_program_spans(profiled)(
            "cell", Spans(), out):
        with port.span("train.step"):
            with port.span("optim.clip"):
                pass
    assert port._recorder is None
    return out[0]


def test_the_traced_steps_record_the_programs_spans_on_the_trace_clock(
        monkeypatch):
    from harness import train

    program_spans.install()
    once = train.profiled
    program_spans.install()
    assert train.profiled is once and once.records_program_spans
    # four boundaries, four marks: each span placed at its own
    trace = _steps(_profiled(4))
    (a, b, step), (c, d, clip) = trace.program_spans
    assert (step.name, clip.name, clip.parent) == \
        ("train.step", "optim.clip", step.id)
    assert (a, c, d, b) == (5100.0, 5200.0, 5300.0, 5400.0)
    # marks that do not match the boundaries one for one: nothing kept
    assert not hasattr(_steps(_profiled(3)), "program_spans")
    assert not hasattr(_steps(_profiled(5)), "program_spans")
    # a program without the recorder: the steps run, nothing is kept
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    out = []
    with program_spans._recording_program_spans(_profiled(4))(
            "cell", Spans(), out):
        pass
    assert not hasattr(out[0], "program_spans")
