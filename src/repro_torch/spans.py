"""Spans and counts recorded inside the port, at the layer boundaries
where the work happens: the training step, its forward and backward, the
model's sublayers, the clip and AdamW.

A span records its name, its start and end on ``time.perf_counter()``,
the id of the span open when it began (its parent), the step it belongs
to (the id of its root: a span that opens with none open is a root) and
a small dict of counts. A span marks *launch* time: the card time of the
operations it launched is found by matching their launch timestamps in a
device trace against its interval.

Each boundary, a span's start and its end, is numbered in the order the
boundaries were crossed (``start_mark``, ``end_mark``). On a card each
boundary also queries the current CUDA stream (``cudaStreamQuery``: no
kernel, no wait), whose runtime event puts the boundary on the device
trace's own clock, in order with the launches around it; the host's
clock maps onto the trace's only to some tens of microseconds.

Recording is off unless a caller turns it on with ``recording()``, which
yields the list the records go to. Off, ``span(name)`` returns one
shared object that does nothing and whose ``inputs``/``output`` hand
their tensors back untouched, so a step allocates, launches and waits
for nothing more; callers compute counts only when ``s.on``.

On, no kernel and no synchronisation is added either. A sublayer's
backward is bounded by two identity autograd nodes (``view_as``): one on
its output, whose backward opens the sublayer's backward span when the
gradient arrives, and one over its inputs, whose backward closes it when
the gradients leave. Autograd runs them on its own thread (the card's
device thread), so the records are kept under a lock, and a backward
span's parent is the span open then (``train.backward``, or the
enclosing sublayer's backward). Every tensor a sublayer reads from its
input must be read through ``inputs``: the sublayer's gradients then add
up in the identity node in the order they would add up without it, and
the numbers stay bit-equal whether recording is on or off.
"""
from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch


@dataclass(eq=False, slots=True)
class Record:
    id: int
    name: str
    parent: int | None
    step: int
    start: float                  # perf_counter seconds
    start_mark: int
    end: float | None = None      # None while open
    end_mark: int | None = None
    counts: dict = field(default_factory=dict)


class _Recorder:
    def __init__(self, mark):
        self.records: list[Record] = []
        self.open: list[Record] = []      # innermost last
        self.lock = threading.Lock()
        self.ids = itertools.count()
        self.marks = itertools.count()
        self.mark = mark                  # called at each boundary, or None

    def _boundary(self) -> int:
        if self.mark is not None:
            self.mark()
        return next(self.marks)

    def begin(self, name: str) -> Record:
        t = time.perf_counter()
        with self.lock:
            top = self.open[-1] if self.open else None
            i = next(self.ids)
            r = Record(i, name, top.id if top else None,
                       top.step if top else i, t, self._boundary())
            self.records.append(r)
            self.open.append(r)
        return r

    def end(self, r: Record) -> None:
        """Closes ``r``; a span still open inside it (a backward span whose
        inputs got no gradient) leaves the stack with it, unclosed."""
        t = time.perf_counter()
        with self.lock:
            r.end, r.end_mark = t, self._boundary()
            for i in range(len(self.open) - 1, -1, -1):
                if self.open[i] is r:
                    del self.open[i:]
                    break


class _Off:
    """The shared span of recording off."""
    on = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def inputs(self, *ts):
        return ts[0] if len(ts) == 1 else ts

    def output(self, t):
        return t


_OFF = _Off()
_recorder: _Recorder | None = None


class _Backward:
    """One sublayer call's backward span: opened when the gradient reaches
    its output, closed when the gradients leave its inputs."""
    __slots__ = ("rec", "name", "record")

    def __init__(self, rec: _Recorder, name: str):
        self.rec, self.name, self.record = rec, name, None

    def open(self) -> None:
        self.record = self.rec.begin(self.name)

    def close(self) -> None:
        if self.record is not None:
            self.rec.end(self.record)
            self.record = None


class _OpensBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, bw, t):
        ctx.bw = bw
        ctx.set_materialize_grads(False)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        ctx.bw.open()
        return None, grad


class _ClosesBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, bw, *ts):
        ctx.bw = bw
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        ctx.bw.close()
        return (None, *grads)


class _Span:
    on = True
    __slots__ = ("rec", "name", "record", "bw")

    def __init__(self, rec: _Recorder, name: str):
        self.rec, self.name, self.record, self.bw = rec, name, None, None

    def __enter__(self):
        self.record = self.rec.begin(self.name)
        return self

    def __exit__(self, *exc):
        self.rec.end(self.record)
        return False

    def count(self, **counts) -> None:
        self.record.counts.update(counts)

    def _backward(self) -> _Backward:
        if self.bw is None:
            self.bw = _Backward(self.rec, self.name)
        return self.bw

    def inputs(self, *ts):
        """``ts`` as the sublayer reads them: its backward span ends when
        their gradients are complete."""
        out = _ClosesBackward.apply(self._backward(), *ts)
        return out[0] if len(ts) == 1 else out

    def output(self, t):
        """``t`` as the sublayer's result: its backward span starts when
        its gradient arrives."""
        return _OpensBackward.apply(self._backward(), t)


def span(name: str):
    """A span named ``name`` around a ``with`` body (the shared no-op while
    recording is off)."""
    rec = _recorder
    return _OFF if rec is None else _Span(rec, name)


@contextmanager
def recording():
    """Turns recording on for the body and yields the list of its
    ``Record``s (a span still open has ``end`` None)."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("spans are being recorded already")
    rec = _Recorder(torch.cuda.current_stream().query
                    if torch.cuda.is_initialized() else None)
    _recorder = rec
    try:
        yield rec.records
    finally:
        _recorder = None
