"""LaunchServer: continuous batching of device kernel launches.

The front door of the multi-SM eGPU device (``core.device``) for many
clients. Clients submit :class:`LaunchRequest`\\ s (one ``Kernel`` each,
with its grid and per-block shared-memory images) into a bounded
admission queue and get a future back; the batching loop coalesces
compatible pending requests into ONE merged heterogeneous launch (merged
trace/megakernel waves and schedule-aware wave packing) and routes
per-request results and cycle counts back through the futures.

The launch-queue cost model of arXiv 2401.04261 (*A Statically and
Dynamically Scalable Soft GPGPU*) sits underneath: every dispatched batch
reports the queue depth it saw, and the device charges
``dispatch_latency + queue_latency * depth`` host cycles before the first
block issues (``launch(queue_depth=)`` -> ``profile()["host_dispatch"]``).

Design points:

* **Admission ordering is priority-aware end to end.** The queue orders
  pending requests by ``Kernel(priority=)`` (descending; FIFO within a
  level), so a high-priority tenant's request enters an earlier batch,
  and inside the merged launch the same priority rides the dynamic
  dispatch heap of ``core.scheduler``.
* **Backpressure.** The queue is bounded (``max_queue``);
  ``admission="reject"`` makes an over-full ``submit`` raise
  :class:`QueueFull`, ``admission="block"`` makes it wait: inline
  (dispatching a batch itself) in synchronous use, on a condition
  variable when the background batcher thread is running.
* **Coalescing contract.** Requests merged into one launch share the
  device as concurrently launched kernels do: one ``DeviceConfig``
  (per-``Kernel`` imem/shmem overrides are fine), no cross-request global
  memory races. Requests that carry ``buffers=`` (a private gmem image)
  or a ``barrier=True`` kernel (a multi-phase structure that would fence
  other tenants' blocks) are dispatched solo; everything else coalesces
  up to ``max_batch`` requests.
* **Deterministic virtual-time accounting.** The server keeps a virtual
  device clock in modeled cycles: a batch dispatches at
  ``max(clock, arrival)``, the clock advances by the launch's modeled
  ``cycles`` (host dispatch latency included), and each request's
  latency is ``finish - arrival`` with per-request finish read off the
  scheduler's per-block retire times. Same request trace, same
  per-request cycle counts, whatever the wall clock does.
* **Results on the card.** A batch's launch runs on the current stream
  of the thread that dispatches it (the background batcher's is the
  default stream); its futures are resolved only after that stream
  finished, and each request's slice is indexed on the result's device.
"""
from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import Future
from typing import Any, Mapping

import numpy as np
import torch

from ..core.device import DeviceConfig, Kernel, as_kernel, launch
from ..core.machine import MAX_THREADS, N_REGS

ADMISSIONS = ("block", "reject")


class QueueFull(RuntimeError):
    """Raised by ``submit`` under ``admission="reject"`` backpressure."""


@dataclasses.dataclass(frozen=True)
class LaunchRequest:
    """One client's kernel launch.

    ``kernel`` may be a :class:`core.device.Kernel`, an assembled
    ``Program``, or a raw word array (bare programs get device-default
    block size). ``grid`` is the number of thread blocks; ``shmem`` is
    None, one per-block image, or a ``(grid, depth)`` batch. ``buffers``
    gives the request a private global-memory image (named segments, as
    in ``launch(buffers=)``) — such requests dispatch solo, never merged
    with another tenant's. ``arrival_cycle`` places the request on the
    server's virtual device clock for latency accounting (None: "now",
    i.e. the clock at submit time).
    """

    kernel: Any
    grid: int = 1
    shmem: Any = None
    buffers: Mapping[str, Any] | None = None
    arrival_cycle: int | None = None
    tag: Any = None                   # opaque client cookie, echoed back

    def __post_init__(self):
        if int(self.grid) < 1:
            raise ValueError(f"grid={self.grid} must be >= 1")


@dataclasses.dataclass
class ServeResult:
    """Per-request slice of a dispatched batch, plus its cycle story."""

    rid: int
    tag: Any
    regs: torch.Tensor              # (grid, MAX_THREADS, N_REGS) int32
    shmem: torch.Tensor             # (grid, shmem_depth) int32
    oob: torch.Tensor               # (grid,) bool
    gmem: torch.Tensor | None       # final gmem (solo buffer requests)
    buffer_offsets: dict | None
    arrival_cycle: int              # virtual clock when the request arrived
    dispatch_cycle: int             # virtual clock when its batch launched
    finish_cycle: int               # virtual clock when its last block retired
    cycles: int                     # dispatch -> finish (host latency incl.)
    wait_cycles: int                # arrival -> dispatch (queueing)
    latency_cycles: int             # arrival -> finish (wait + cycles)
    batch_id: int
    batch_size: int                 # requests merged into the launch
    batch_occupancy: float          # mean wave fill of the merged launch
    queue_depth: int                # launch-queue depth the dispatch saw
    profile: dict[str, Any]         # the merged launch's profile()
    finish_reason: str = "ok"       # "ok" | "unadmitted" (server stopped)

    def shmem_f32(self) -> torch.Tensor:
        return self.shmem.view(torch.float32)


@dataclasses.dataclass
class _Entry:
    seq: int
    req: LaunchRequest
    kernel: Kernel                  # normalized (as_kernel applied)
    arrival: int
    future: Future

    @property
    def priority(self) -> int:
        return int(self.kernel.priority)

    @property
    def solo(self) -> bool:
        return self.req.buffers is not None or bool(self.kernel.barrier)


class LaunchServer:
    """Admission queue + continuous-batching dispatch loop over one device.

    Synchronous use (deterministic — what the tests and the modeled
    benchmark numbers use)::

        server = LaunchServer(dcfg, max_batch=8)
        futs = [server.submit(LaunchRequest(kernel=fft_kernel(64),
                                            shmem=img)) for img in imgs]
        server.drain()                      # dispatch until queue empty
        outs = [f.result() for f in futs]   # ServeResult each

    Threaded use (clients submit from anywhere; a background batcher
    coalesces whatever is pending each time the device frees up)::

        server.start()
        fut = server.submit(req)            # blocks/rejects when full
        res = fut.result(timeout=60)
        server.stop()
    """

    def __init__(self, dcfg: DeviceConfig, *,
                 max_queue: int = 64, admission: str = "block",
                 max_batch: int | None = None,
                 schedule: str | None = None, engine: str | None = None,
                 packing: str | None = None, backend: str | None = None):
        if admission not in ADMISSIONS:
            raise ValueError(f"admission={admission!r} must be one of "
                             f"{ADMISSIONS}")
        if max_queue < 1:
            raise ValueError(f"max_queue={max_queue} must be >= 1")
        self.dcfg = dcfg
        self.max_queue = int(max_queue)
        self.admission = admission
        # default batch width: two full waves of the device's SMs —
        # enough to amortize dispatch, small enough to bound tail latency
        self.max_batch = int(max_batch) if max_batch is not None \
            else max(2 * dcfg.n_sms, 2)
        if self.max_batch < 1:
            raise ValueError(f"max_batch={self.max_batch} must be >= 1")
        self._launch_kw = dict(schedule=schedule, engine=engine,
                               packing=packing, backend=backend)
        self.clock = 0                  # virtual device clock (cycles)
        self._queue: list[_Entry] = []
        self._seq = 0
        self._batch_id = 0
        self._lock = threading.RLock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self._thread: threading.Thread | None = None
        self._stopping = False
        self._stats = {
            "submitted": 0, "completed": 0, "rejected": 0,
            "unadmitted": 0, "batches": 0, "batched_requests": 0,
            "max_queue_depth": 0, "occupancy_sum": 0.0,
        }

    # ---- admission --------------------------------------------------------
    def submit(self, req: LaunchRequest) -> Future:
        """Enqueue one launch request; returns a future of ServeResult.

        Backpressure: with the queue at ``max_queue``, ``"reject"``
        raises :class:`QueueFull`; ``"block"`` waits for space — by
        dispatching a batch inline when no batcher thread is running
        (synchronous callers make their own progress), or by blocking on
        the batcher otherwise.

        A stopped server (``stop()`` called after ``start()``, no
        restart yet) never admits: the returned future is already
        resolved to a terminal :class:`ServeResult` with
        ``finish_reason="unadmitted"``. This covers the submitter that
        was blocked in the full-queue wait while ``stop()`` ran — it
        must not enqueue into a dead server and hang its client.
        """
        with self._lock:
            if self._stopping:
                return self._unadmitted_future_locked(req)
            while len(self._queue) >= self.max_queue:
                if self.admission == "reject":
                    self._stats["rejected"] += 1
                    raise QueueFull(
                        f"admission queue full ({self.max_queue} pending); "
                        f"retry later or use admission='block'")
                if self._thread is not None:
                    self._not_full.wait()
                    if self._stopping:
                        # woken by stop(): the batcher is gone, nothing
                        # will ever serve this request — terminal result,
                        # never a hang
                        return self._unadmitted_future_locked(req)
                else:
                    self._dispatch_next_locked()
            kern = as_kernel(req.kernel)
            arrival = int(req.arrival_cycle) \
                if req.arrival_cycle is not None else int(self.clock)
            fut: Future = Future()
            self._queue.append(_Entry(seq=self._seq, req=req, kernel=kern,
                                      arrival=arrival, future=fut))
            self._seq += 1
            self._stats["submitted"] += 1
            self._stats["max_queue_depth"] = max(
                self._stats["max_queue_depth"], len(self._queue))
            self._not_empty.notify()
        return fut

    def _unadmitted_result(self, rid: int, tag: Any, grid: int,
                           arrival: int) -> ServeResult:
        """Terminal result for a request the server will never run:
        zeroed state on the host, zero cycles,
        ``finish_reason="unadmitted"``."""
        depth = self.dcfg.sm.shmem_depth
        return ServeResult(
            rid=rid, tag=tag,
            regs=torch.zeros((grid, MAX_THREADS, N_REGS), dtype=torch.int32),
            shmem=torch.zeros((grid, depth), dtype=torch.int32),
            oob=torch.zeros((grid,), dtype=torch.bool),
            gmem=None, buffer_offsets=None,
            arrival_cycle=int(arrival), dispatch_cycle=int(self.clock),
            finish_cycle=int(self.clock), cycles=0,
            wait_cycles=max(0, int(self.clock) - int(arrival)),
            latency_cycles=max(0, int(self.clock) - int(arrival)),
            batch_id=-1, batch_size=0, batch_occupancy=0.0,
            queue_depth=len(self._queue), profile={},
            finish_reason="unadmitted")

    def _unadmitted_future_locked(self, req: LaunchRequest) -> Future:
        arrival = int(req.arrival_cycle) if req.arrival_cycle is not None \
            else int(self.clock)
        fut: Future = Future()
        fut.set_result(self._unadmitted_result(self._seq, req.tag,
                                               int(req.grid), arrival))
        self._seq += 1
        self._stats["unadmitted"] += 1
        return fut

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    # ---- dispatch ---------------------------------------------------------
    def pump(self) -> int:
        """Dispatch one batch if anything is pending; returns its size."""
        with self._lock:
            return self._dispatch_next_locked()

    def drain(self) -> int:
        """Dispatch until the queue is empty; returns requests served."""
        served = 0
        with self._lock:
            while self._queue:
                served += self._dispatch_next_locked()
        return served

    def _select_locked(self) -> tuple[list[_Entry], int]:
        """Pick the next batch: at the dispatch instant (device free, or
        first arrival if it is idle-waiting), take the highest-priority
        arrived requests in (priority desc, FIFO) order, stopping at a
        solo request's boundary or ``max_batch``."""
        now = self.clock
        arrived = [e for e in self._queue if e.arrival <= now]
        if not arrived:
            # device idles until the next request arrives
            now = min(e.arrival for e in self._queue)
            arrived = [e for e in self._queue if e.arrival <= now]
        arrived.sort(key=lambda e: (-e.priority, e.seq))
        batch: list[_Entry] = []
        for e in arrived:
            if e.solo:
                # a solo request dispatches alone, and never jumps the
                # priority order: it either heads this batch or ends it
                if not batch:
                    batch = [e]
                break
            batch.append(e)
            if len(batch) >= self.max_batch:
                break
        return batch, now

    def _dispatch_next_locked(self) -> int:
        if not self._queue:
            return 0
        batch, now = self._select_locked()
        depth = len(self._queue)        # queue depth this dispatch sees
        ids = {id(e) for e in batch}
        self._queue = [e for e in self._queue if id(e) not in ids]
        try:
            self._dispatch_batch(batch, now, depth)
        except Exception as exc:        # route the failure to the clients
            for e in batch:
                e.future.set_exception(exc)
            raise
        finally:
            self._not_full.notify_all()
        return len(batch)

    def _dispatch_batch(self, batch: list[_Entry], now: int,
                        depth: int) -> None:
        # ---- build one merged launch: dedup kernels, request-major grid --
        kernels: list[Kernel] = []
        kernel_of: dict[tuple, int] = {}
        blocks_of: list[list[int]] = [[] for _ in batch]
        gmap: list[int] = []
        shmem_rows: list[list[Any]] = []    # per kernel: per-block images
        any_shmem: list[bool] = []
        for i, e in enumerate(batch):
            kern = e.kernel
            words = kern.program.words if hasattr(kern.program, "words") \
                else np.asarray(kern.program)
            key = (np.asarray(words).tobytes(), kern.block, kern.dim_x,
                   kern.imem_depth, kern.shmem_depth, kern.priority,
                   kern.barrier)
            k = kernel_of.get(key)
            if k is None:
                k = len(kernels)
                kernel_of[key] = k
                kernels.append(kern)
                shmem_rows.append([])
                any_shmem.append(False)
            grid = int(e.req.grid)
            b0 = len(gmap)
            blocks_of[i] = list(range(b0, b0 + grid))
            gmap.extend([k] * grid)
            rows = self._request_images(e.req, grid)
            any_shmem[k] = any_shmem[k] or rows is not None
            shmem_rows[k].append((grid, rows))
        shmems: list[Any] = []
        for k in range(len(kernels)):
            if not any_shmem[k]:
                shmems.append(None)
                continue
            parts = []
            for grid, rows in shmem_rows[k]:
                if rows is None:
                    depth_k = kernels[k].shmem_depth \
                        or self.dcfg.sm.shmem_depth
                    rows = np.zeros((grid, depth_k), np.uint32)
                parts.append(np.asarray(rows))
            width = max(p.shape[1] for p in parts)
            parts = [np.pad(p, ((0, 0), (0, width - p.shape[1])))
                     if p.shape[1] < width else p for p in parts]
            shmems.append(np.concatenate(parts, axis=0))
        solo = batch[0].req.buffers if len(batch) == 1 else None

        res = launch(self.dcfg, programs=kernels, grid_map=gmap,
                     shmem=shmems, buffers=solo, queue_depth=depth,
                     **self._launch_kw)
        if res.regs.is_cuda:
            # the launches were queued on this thread's current stream:
            # a future resolves only to a finished result, whatever stream
            # its consumer reads it on
            torch.cuda.current_stream(res.regs.device).synchronize()

        # ---- route per-request slices + cycle counts back ----------------
        finish = np.asarray(res.timing.block_finish)
        bid = self._batch_id
        self._batch_id += 1
        occ = res.wave_packing.occupancy if res.wave_packing else 0.0
        profile = res.profile()
        start = int(now)
        for i, e in enumerate(batch):
            blocks = np.asarray(blocks_of[i])
            req_cycles = int(finish[blocks].max())
            idx = torch.as_tensor(blocks, device=res.regs.device)
            r = ServeResult(
                rid=e.seq, tag=e.req.tag,
                regs=res.regs[idx], shmem=res.shmem[idx],
                oob=res.oob[idx],
                gmem=res.gmem if solo is not None else None,
                buffer_offsets=res.buffer_offsets,
                arrival_cycle=int(e.arrival),
                dispatch_cycle=start,
                finish_cycle=start + req_cycles,
                cycles=req_cycles,
                wait_cycles=start - int(e.arrival),
                latency_cycles=start + req_cycles - int(e.arrival),
                batch_id=bid, batch_size=len(batch),
                batch_occupancy=occ, queue_depth=depth,
                profile=profile)
            e.future.set_result(r)
        self.clock = start + int(res.cycles)
        self._stats["completed"] += len(batch)
        self._stats["batches"] += 1
        self._stats["batched_requests"] += len(batch)
        self._stats["occupancy_sum"] += occ

    @staticmethod
    def _request_images(req: LaunchRequest, grid: int):
        """Normalize a request's shmem init to a (grid, depth) u32 batch
        (None stays None; float32 images are bitcast like the device
        memory system everywhere else)."""
        if req.shmem is None:
            return None
        a = np.asarray(req.shmem)
        if a.dtype == np.float32:
            a = a.view(np.uint32)
        elif a.dtype != np.uint32:
            a = a.astype(np.uint32)
        if a.ndim == 1:
            a = np.broadcast_to(a, (grid, a.shape[0]))
        if a.ndim != 2 or a.shape[0] != grid:
            raise ValueError(f"shmem batch of shape {a.shape} != "
                             f"({grid}, depth)")
        return a

    # ---- background batcher ----------------------------------------------
    def start(self) -> None:
        """Run the batching loop on a daemon thread: whenever requests
        are pending and the previous batch retired, dispatch the next."""
        with self._lock:
            if self._thread is not None:
                raise RuntimeError("LaunchServer already started")
            self._stopping = False
            self._thread = threading.Thread(target=self._serve_loop,
                                            name="launch-server",
                                            daemon=True)
            self._thread.start()

    def stop(self, drain: bool = True) -> None:
        """Stop the batcher thread. ``drain=True`` (default) dispatches
        every pending request first; ``drain=False`` resolves pending
        futures to terminal ``finish_reason="unadmitted"`` results. A
        queued ``Future`` never hangs its client either way, and
        ``_stopping`` stays set until the next ``start()`` so a
        submitter racing this call (including one blocked in the
        full-queue wait) gets an unadmitted result instead of enqueuing
        into a dead server."""
        with self._lock:
            if self._thread is None:
                return
            self._stopping = True
            self._not_empty.notify_all()
        self._thread.join()
        self._thread = None
        with self._lock:
            if drain:
                while self._queue:
                    self._dispatch_next_locked()
            else:
                for e in self._queue:
                    e.future.set_result(self._unadmitted_result(
                        e.seq, e.req.tag, int(e.req.grid), e.arrival))
                    self._stats["unadmitted"] += 1
                self._queue.clear()
            # wake any submitter still blocked in the full-queue wait;
            # it re-checks _stopping and resolves its client terminally
            self._not_full.notify_all()

    def _serve_loop(self) -> None:
        while True:
            with self._lock:
                while not self._queue and not self._stopping:
                    self._not_empty.wait()
                if self._stopping:
                    return
                try:
                    self._dispatch_next_locked()
                except Exception:
                    # the failure already reached the affected futures;
                    # keep serving other tenants
                    pass

    # ---- reporting --------------------------------------------------------
    def stats(self) -> dict[str, Any]:
        with self._lock:
            s = dict(self._stats)
            s["pending"] = len(self._queue)
            s["clock_cycles"] = int(self.clock)
            s["mean_batch_size"] = (s["batched_requests"] / s["batches"]
                                    if s["batches"] else 0.0)
            s["mean_batch_occupancy"] = (s["occupancy_sum"] / s["batches"]
                                         if s["batches"] else 0.0)
            del s["occupancy_sum"]
            return s
