"""The port's own spans (``repro_torch.spans``) in the traced sub-window,
put on the device trace's clock, and the sums their readers take.

``install()`` wraps the training harness's ``profiled`` so that the
port's recorder is on for the traced steps alone (the timed window runs
with it off), and keeps the records on the ``Trace`` as
``program_spans``: (start, end, record), in microseconds of the trace's
clock. On a card the port marks each span boundary with a stream query,
whose runtime event in the trace places the boundary exactly, in order
with the launches of the thread that crossed it. Where the queries do
not match the boundaries one for one, no span is kept: the readers of
the port's spans then return None, as they do for a program without the
recorder. Each of those readers calls ``install()`` when it is loaded,
which the harness does before a run.

An operation belongs to a span when it was launched inside it; an idle
gap on the card belongs to the innermost span open at the launch of the
operation that ends it, since the card waits there on the host's next
launch.
"""
from __future__ import annotations

import bisect
import re
from contextlib import contextmanager

import numpy as np

# gemm_ms.train's patterns: cuBLAS's and CUTLASS's products, by name
PRODUCTS = re.compile(r"gemm|gemv|xmma|cutlass|sgemm|Kernel2", re.I)
MARK = "cudaStreamQuery"


def install() -> None:
    from harness import train
    if not getattr(train.profiled, "records_program_spans", False):
        train.profiled = _recording_program_spans(train.profiled)


def _recording_program_spans(profiled):
    from harness import trace as trace_mod
    from harness.program import patched

    @contextmanager
    def wrapped(name, spans, out):
        try:
            from repro_torch.spans import recording
        except ImportError:          # a program without the recorder
            recording = None
        records, seen = None, {}

        def keeping(make):
            def make_trace(events, window, bench_spans):
                seen["events"] = events
                return make(events, window, bench_spans)
            return make_trace

        with patched(trace_mod, "Trace", keeping):
            with profiled(name, spans, out):
                if recording is None:
                    yield
                else:
                    with recording() as records:
                        yield
        if out[-1] is not None and records is not None and seen:
            attach(out[-1], records, seen["events"])

    wrapped.records_program_spans = True
    return wrapped


def attach(trace, records, events) -> None:
    """Puts the port's closed ``records`` on ``trace``'s clock by their
    boundary marks among ``events``; keeps none where the marks do not
    match the boundaries one for one."""
    if not trace.has_device:
        return
    marks = sorted(float(e["ts"]) for e in events
                   if e.get("name") == MARK and e.get("ph") == "X"
                   and e.get("cat") in ("cuda_runtime", "cuda_driver"))
    n = 1 + max((max(r.start_mark, r.end_mark if r.end_mark is not None
                     else -1) for r in records), default=-1)
    if marks and len(marks) == n:
        trace.program_spans = [(marks[r.start_mark], marks[r.end_mark], r)
                               for r in records if r.end is not None]


def spans_of(run):
    """The port's spans of ``run``'s traced sub-window, or None without a
    card or without them."""
    p = run.profile
    if p is None or not p.has_device:
        return None
    return getattr(p, "program_spans", None) or None


def launched_in(trace, spans, names):
    """The operations launched inside a span named in ``names``."""
    merged = []
    for a, b in sorted((a, b) for a, b, r in spans if r.name in names):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    starts = [a for a, _ in merged]
    for op, t in zip(trace.ops, trace.launch_ts):
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < merged[i][1]:
            yield op


def card_ms(run, names) -> float | None:
    """Card ms a step of the operations launched inside the port's spans
    named in ``names``; None where no such span was recorded."""
    spans = spans_of(run)
    if spans is None or not any(r.name in names for *_, r in spans):
        return None
    ops = launched_in(run.profile, spans, names)
    return 1e3 * run.profile.device_s(ops) / run.counters["profile_steps"]


def innermost(spans, ts) -> list:
    """For each time of ``ts`` (None allowed), the record of the shortest
    port span holding it, or None."""
    a = np.array([s[0] for s in spans])
    b = np.array([s[1] for s in spans])
    length = b - a
    out = []
    for t in ts:
        inside = (a <= t) & (t < b) if t is not None else None
        if inside is None or not inside.any():
            out.append(None)
            continue
        i = np.flatnonzero(inside)
        out.append(spans[i[np.argmin(length[i])]][2])
    return out


def idle_gaps(trace) -> list:
    """The card's idle gaps in the window as (seconds, launch time of the
    operation that ends the gap); the gap after the last operation has
    none and is left out."""
    starts = [op[0] for op in trace.ops]
    out, prev = [], trace.window[0]
    for a, b in trace.busy():
        if a > prev:
            i = bisect.bisect_left(starts, a)
            out.append(((a - prev) * 1e-6, trace.launch_ts[i]))
        prev = b
    return out


def idle_by_span(run) -> dict | None:
    """Card-idle seconds of the window by the name of the port span each
    gap is put down to; gaps put down to no port span are left out."""
    spans = spans_of(run)
    if spans is None:
        return None
    gaps = idle_gaps(run.profile)
    out = {}
    for (s, _), r in zip(gaps, innermost(spans, [t for _, t in gaps])):
        if r is not None:
            out[r.name] = out.get(r.name, 0.0) + s
    return out


def table(run) -> dict | None:
    """Per port span name, a step's: card ms of the operations launched
    inside its spans (``products`` by ``gemm_ms.train``'s patterns and
    ``rest``), the same for those whose innermost port span it is
    (``self_products``, ``self_rest``), and the idle ms put down to it;
    ``(none)`` holds the window's operations and idle launched outside
    every port span."""
    spans = spans_of(run)
    if spans is None:
        return None
    p = run.profile
    n = run.counters["profile_steps"]
    names = sorted({r.name for *_, r in spans})
    rows = {k: dict.fromkeys(("products", "rest", "self_products",
                              "self_rest", "idle"), 0.0)
            for k in names + ["(none)"]}

    def kind(op):
        return "products" if PRODUCTS.search(op[2]) else "rest"

    for k in names:
        for op in launched_in(p, spans, {k}):
            rows[k][kind(op)] += 1e3 * (op[1] - op[0]) * 1e-6 / n
    lo, hi = p.window
    ops = [(op, t) for op, t in zip(p.ops, p.launch_ts) if lo <= op[0] < hi]
    for (op, _), r in zip(ops, innermost(spans, [t for _, t in ops])):
        rows[r.name if r else "(none)"]["self_" + kind(op)] += \
            1e3 * (op[1] - op[0]) * 1e-6 / n
    gaps = idle_gaps(p)
    for (s, _), r in zip(gaps, innermost(spans, [t for _, t in gaps])):
        rows[r.name if r else "(none)"]["idle"] += 1e3 * s / n
    return rows
