"""Serving: the device-level front door.

``LaunchServer``/``LaunchRequest``: asynchronous kernel-launch admission,
priority-aware continuous batching into merged heterogeneous waves, and
the launch-queue/dispatch-latency cycle model (``core.device.launch``'s
``queue_depth=``).
"""
from .launch_server import (
    ADMISSIONS,
    LaunchRequest,
    LaunchServer,
    QueueFull,
    ServeResult,
)

__all__ = ["LaunchServer", "LaunchRequest", "ServeResult", "QueueFull",
           "ADMISSIONS"]
