"""Serving: continuous batching at two levels.

``Engine``/``Request``: the slot-based LM decode engine (flexible active
mask over a fixed-capacity batch). ``LaunchServer``/``LaunchRequest``:
the device-level front door — asynchronous kernel-launch admission,
priority-aware continuous batching into merged heterogeneous waves, and
the launch-queue/dispatch-latency cycle model (``core.device.launch``'s
``queue_depth=``).
"""
from .engine import FINISH_REASONS, Engine, Request
from .launch_server import (
    ADMISSIONS,
    LaunchRequest,
    LaunchServer,
    QueueFull,
    ServeResult,
)

__all__ = [
    "Engine", "Request", "FINISH_REASONS",
    "LaunchServer", "LaunchRequest", "ServeResult", "QueueFull",
    "ADMISSIONS",
]
