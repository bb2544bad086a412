"""Mixed-program launches: independent kernels sharing one device.

The scalable eGPU follow-up (arXiv 2401.04261) motivates dynamic block
dispatch with exactly this deployment: a packed sector serving several
*different* small-DSP workloads at once. ``launch_fft_qrd`` runs a batch
of n-point FFTs and a batch of 16x16 MGS QRDs as ONE launch — the two
programs' blocks interleave in the grid and each SM pulls whichever block
is next the moment it retires its current one, so the short FFT blocks
backfill around the long QRD blocks instead of idling a lockstep wave.

This is the canonical heterogeneous-launch demo: the acceptance test and
the benchmark smoke both drive it, and ``LaunchResult.profile()`` shows
non-zero per-SM occupancy for both programs.

Functionally the launch runs in merged waves on the trace and megakernel
engines (``"auto"`` resolves to the megakernel): a wave holds blocks of
both programs, each program's rows running on its own SMs
(``profile()["trace_merge"]`` reports each wave). The step engine runs
it program-major. Timing comes from the static traces either way, so the
cycle counters are the same on every engine.
"""
from __future__ import annotations

import numpy as np

from ..device import DeviceConfig, LaunchResult, launch
from ..machine import SMConfig
from .fft import bitrev_indices, fft_kernel, fft_shmem
from .qrd import Q_BASE, R_BASE, qrd_kernel, qrd_shmem


def mixed_device(n_fft: int, n_sms: int = 4,
                 backend: str | None = None) -> DeviceConfig:
    """A device sized for an FFT-n + QRD-16 mix: shared memory covers both
    layouts, I-MEM the unrolled QRD program."""
    depth = max(3 * n_fft, 1024)
    return DeviceConfig(
        n_sms=n_sms,
        sm=SMConfig(shmem_depth=depth, imem_depth=1024, max_steps=200_000),
        **({"backend": backend} if backend else {}))


def launch_fft_qrd(xs: np.ndarray, As: np.ndarray,
                   device: DeviceConfig | None = None,
                   schedule: str | None = None, backend: str | None = None,
                   interleave: bool = True,
                   priorities: tuple[int, int] | None = None,
                   engine: str | None = None,
                   packing: str | None = None
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                              LaunchResult]:
    """Run ``xs`` (batch_f, n) complex FFTs and ``As`` (batch_q, 16, 16)
    QRDs in one multi-program launch. Returns (X, Q, R, LaunchResult).

    ``interleave=True`` round-robins the two programs' blocks in the
    dispatch order (the imbalanced-grid case dynamic scheduling exists
    for); ``False`` queues all FFT blocks first. ``priorities`` sets the
    (fft, qrd) ``Kernel.priority`` pair for the dynamic dispatch queue —
    e.g. ``(0, 1)`` drains the long QRD blocks first so they don't
    straggle behind a queue of short FFTs. ``engine`` forwards to
    ``launch`` ("step", "trace", "megakernel", or None for the device
    default), as does ``packing`` ("grid" | "length" | "auto"), which
    decides which blocks share a wave: the merged waves that run and the
    timing model's waves alike.
    """
    xs, As = np.asarray(xs), np.asarray(As)
    batch_f, n = int(xs.shape[0]), int(xs.shape[1])
    batch_q = int(As.shape[0])
    if device is None:
        device = mixed_device(n, backend=backend)
    fft_images = np.stack([fft_shmem(xs[b], device.sm.shmem_depth)
                           for b in range(batch_f)])
    qrd_images = np.stack([qrd_shmem(As[b], device.sm.shmem_depth)
                           for b in range(batch_q)])
    if interleave:
        grid_map: list[int] = []
        for i in range(max(batch_f, batch_q)):
            if i < batch_f:
                grid_map.append(0)
            if i < batch_q:
                grid_map.append(1)
    else:
        grid_map = [0] * batch_f + [1] * batch_q
    kernels = [fft_kernel(n), qrd_kernel()]
    if priorities is not None:
        import dataclasses

        kernels = [dataclasses.replace(k, priority=p)
                   for k, p in zip(kernels, priorities)]
    res = launch(device, programs=kernels,
                 grid_map=grid_map, shmem=[fft_images, qrd_images],
                 backend=backend, schedule=schedule, engine=engine,
                 packing=packing)

    # unpack per-program results: blocks are in grid_map order; program-
    # local order is preserved within it
    gmap = np.asarray(res.grid_map)
    mem = res.shmem_f32().cpu().numpy()
    fmem = mem[gmap == 0]
    out_br = fmem[:, 0:2 * n:2] + 1j * fmem[:, 1:2 * n:2]
    X = np.empty((batch_f, n), dtype=np.complex64)
    X[:, bitrev_indices(n)] = out_br
    qmem = mem[gmap == 1]
    Q = qmem[:, Q_BASE:Q_BASE + 256].reshape(batch_q, 16, 16) \
        .transpose(0, 2, 1)
    R = qmem[:, R_BASE:R_BASE + 256].reshape(batch_q, 16, 16)
    return X, Q, R, res
