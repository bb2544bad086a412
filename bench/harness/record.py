"""What one run measured: the host-clock record of its window, its
counters, its traced sub-window and the numbers of its output check. The
metric readers read this."""
from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass
class Run:
    cell: object
    seed: int
    seconds: float
    trace: bool
    device: str
    setup_s: float | None = None
    t_start: float | None = None
    t_end: float | None = None
    steps: list = field(default_factory=list)     # (start, end) a step
    tokens: int = 0                               # training tokens
    attempted: int = 0
    failed: int = 0
    counters: dict = field(default_factory=dict)
    profile: object = None                        # trace.Trace
    memory_peak_bytes: int = 0
    checks: dict = field(default_factory=dict)    # name -> (value, limit)
    marks: list = field(default_factory=list)     # (name, host clock)

    def mark(self, name: str) -> None:
        """Ends a named phase of set-up."""
        import time
        self.marks.append((name, time.perf_counter()))

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_start

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(v) and v <= lim for v, lim in self.checks.values())
