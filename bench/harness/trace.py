"""The traced sub-window: ``torch.profiler`` tracing the card over a few
steps, the benchmark's own host spans around the calls into each layer,
and the reduction of the trace to device time and idle gaps. The host spans and the window are taken on the host's clock and
put on the trace's by the launch of a marker kernel. The trace file is
written inside the checkout, read once and deleted."""
from __future__ import annotations

import bisect
import json
import os
import time
from contextlib import contextmanager
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "bench"


class Spans:
    """Host spans on the host's clock (``time.perf_counter``), kept only
    while a traced sub-window is on: the profiler traces the card alone,
    so that it adds next to nothing to the host's time."""

    def __init__(self):
        self.on = False
        self.spans: list[tuple[float, float, str]] = []   # seconds

    @contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        a = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((a, time.perf_counter(), name))


class Trace:
    def __init__(self, events: list[dict], window, spans):
        """``window`` (start, end) and ``spans`` (start, end, name) in
        seconds of the host's clock; the first operation on the card is
        the marker launched at ``window[0]``."""
        self.ops = []                 # (start, end, name, correlation, cat)
        launches = {}
        for e in events:
            cat, ts = e.get("cat"), e.get("ts")
            if ts is None or e.get("ph") != "X":
                continue
            ts, dur = float(ts), float(e.get("dur", 0.0))
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                self.ops.append((ts, ts + dur, e.get("name", ""), corr, cat))
            elif cat in LAUNCH_CATS and corr is not None:
                launches[corr] = ts
        self.ops.sort(key=lambda op: op[:2])
        self.launch_ts = [launches.get(op[3]) for op in self.ops]
        self.window, self.spans = None, []
        marker = launches.get(self.ops[0][3]) if self.ops else None
        if marker is not None:
            shift = marker - window[0] * 1e6
            self.window = (window[0] * 1e6 + shift, window[1] * 1e6 + shift)
            self.spans = [(a * 1e6 + shift, b * 1e6 + shift, n)
                          for a, b, n in spans]

    @property
    def has_device(self) -> bool:
        return bool(self.ops) and self.window is not None

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy(self) -> list[tuple[float, float]]:
        """The merged intervals in which a device operation ran, cut to
        the window."""
        lo, hi = self.window
        out = []
        for a, b, *_ in self.ops:
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-6

    def idle_share(self) -> float:
        """Percent of the window with no operation on the card."""
        return 100.0 * (1.0 - self.busy_s() / self.window_s())

    def _label(self, t: float) -> str:
        """The innermost benchmark span the host was in at ``t``."""
        best = None
        for a, b, name in self.spans:
            if a <= t < b and (best is None or b - a < best[1] - best[0]):
                best = (a, b, name)
        return best[2] if best else "other"

    def launched_in(self, name: str):
        """The device operations launched from inside a span ``name``."""
        spans = sorted((a, b) for a, b, n in self.spans if n == name)
        starts = [a for a, _ in spans]
        for op, t in zip(self.ops, self.launch_ts):
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t < spans[i][1]:
                yield op

    def device_s(self, ops) -> float:
        return sum(b - a for a, b, *_ in ops) * 1e-6

    def top_ops(self, n: int = 10) -> list:
        tot = {}
        lo, hi = self.window
        for a, b, name, *_ in self.ops:
            if lo <= a < hi:
                tot[name] = tot.get(name, 0.0) + (b - a) * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, n: int = 10) -> list:
        lo, hi = self.window
        busy = self.busy()
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._label(a), (b - a) * 1e-6] for a, b in gaps[:n]]


@contextmanager
def profiled(name: str, spans: Spans, out: list):
    """Traces the card over the body, with ``spans`` on, and appends the
    parsed ``Trace`` to ``out`` (None where there is no card)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        spans.on = True
        yield
        spans.on = False
        out.append(None)
        return
    torch.cuda.synchronize()
    spans.spans.clear()
    marker = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        a = time.perf_counter()
        marker.add_(1.0)
        spans.on = True
        yield
        torch.cuda.synchronize()
        b = time.perf_counter()
        spans.on = False
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / f"trace-{name}.json"
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out.append(Trace(events, (a, b), list(spans.spans)))
