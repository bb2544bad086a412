"""Device fleet: N simulated eGPUs behind the one ``launch()`` front door.

The eGPU paper closes on the claim that "multiple eGPUs can also be
tightly packed together into a single Agilex FPGA logic region, with
minimal speed penalty", and the scalable follow-up (arXiv 2401.04261)
makes the device count a scaling axis next to the SM count.
:class:`FleetConfig` describes ``n_devices`` identical eGPUs (each a full
``DeviceConfig`` sector: its own SMs, its own global-memory port), and
:func:`launch_fleet` routes one grid across them.

Contracts, in order of importance:

* **Bit-identical function.** A fleet launch computes exactly what
  ``device.launch`` computes on the same grid, for every ``n_devices``:
  blocks keep their fleet-level ``BID`` wherever they land
  (``launch(block_ids=)``), barrier phases stay fleet-wide fences (a phase
  retires on every device before the next issues anywhere), and the
  per-device global-memory images are diff-merged against the phase's
  base image in device order. Under the launch contract (blocks of one
  phase do not race through global memory) each device's sub-launch
  changes disjoint words, so the merge is exact. ``n_devices=1`` is the
  plain launch (delegation, not re-implementation).

* **A NUMA tier in the cycle model.** Blocks routed off
  ``FleetConfig(home_device=)`` pay ``remote_gmem_latency`` extra cycles
  per global access: their static traces are re-priced before
  scheduling, so the charge flows through the schedulers, the makespan
  and ``cycles_by_class`` like any other cycle.

* **Placement.** ``"host"`` runs the sub-launches one after another on
  the backend's device. ``"shard_map"`` (the reference's name, kept so
  the profiles compare equal) runs each simulated eGPU's sub-launch on
  its own card, ``cuda:d``, and merges the images on the home card; it
  needs a uniform workload (one program, one phase, a halting trace,
  equal per-device block counts, ``route="block"``) and at least
  ``n_devices`` cards. ``"auto"`` takes it when it can and records why
  not when it cannot (``profile()["fleet"]["placement_reason"]``); a
  forced ``"shard_map"`` raises instead. The ``"cpu"`` backend always
  resolves to ``"host"``.

Timing: the fleet schedule is the union of per-device schedules
(``scheduler.merge_schedules``): device ``d`` owns SMs
``[d*n_sms, (d+1)*n_sms)`` of the fleet view, each phase starts
everywhere at the previous phase's fleet-wide retire, and the makespan is
the last retire anywhere.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from .cycles import ProgramTrace
from .device import (
    DeviceConfig,
    LaunchResult,
    _host_dispatch,
    _kernel_shmem,
    _lower_kernels,
    _normalize_grid,
    _resolve_engine,
    _resolve_schedule,
    as_u32_image,
    launch,
    pack_buffers,
)
from .executor import backend_device
from .isa import NUM_CLASSES
from .packing import pack_waves
from .scheduler import merge_schedules, schedule_blocks

ROUTES = ("block", "kernel")
PLACEMENTS = ("auto", "host", "shard_map")


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """N identical simulated eGPUs sharing one launch front door.

    ``device`` is the per-device sector configuration. ``route`` picks the
    block router: ``"block"`` splits each barrier phase's blocks into
    ``n_devices`` contiguous grid-order ranges (balanced to within one
    block); ``"kernel"`` sends program ``k``'s blocks to device
    ``k % n_devices``. ``remote_gmem_latency`` is the NUMA tier: extra
    cycles per global access for blocks running off ``home_device``.
    ``placement`` picks where the sub-launches run (module docstring).
    """

    n_devices: int = 1
    device: DeviceConfig = dataclasses.field(default_factory=DeviceConfig)
    remote_gmem_latency: int = 0
    home_device: int = 0
    route: str = "block"
    placement: str = "auto"

    def __post_init__(self):
        if self.n_devices < 1:
            raise ValueError(f"n_devices={self.n_devices} must be >= 1")
        if self.remote_gmem_latency < 0:
            raise ValueError(f"remote_gmem_latency="
                             f"{self.remote_gmem_latency} must be >= 0")
        if not 0 <= self.home_device < self.n_devices:
            raise ValueError(f"home_device={self.home_device} outside "
                             f"[0, {self.n_devices})")
        if self.route not in ROUTES:
            raise ValueError(f"route={self.route!r} must be one of "
                             f"{ROUTES}")
        if self.placement not in PLACEMENTS:
            raise ValueError(f"placement={self.placement!r} must be one "
                             f"of {PLACEMENTS}")

    @property
    def n_sms(self) -> int:
        """Total SMs across the fleet."""
        return self.n_devices * self.device.n_sms


def _remote_trace(trace: ProgramTrace, lat: int) -> ProgramTrace:
    """Re-price a static trace for a non-home device: every global-port
    access costs ``lat`` extra cycles (the NUMA tier)."""
    if lat == 0:
        return trace
    instrs = tuple(dataclasses.replace(i, cycles=i.cycles + lat)
                   if i.gmem else i for i in trace.instrs)
    return dataclasses.replace(trace, instrs=instrs)


def _route_blocks(fcfg: FleetConfig, gmap: np.ndarray,
                  block_phase: np.ndarray) -> np.ndarray:
    """(n_blocks,) device index per block. Contiguous grid-order ranges
    per phase ("block"), or program-keyed ("kernel")."""
    n_blocks = gmap.shape[0]
    device_of = np.zeros(n_blocks, np.int64)
    if fcfg.route == "kernel":
        device_of[:] = gmap % fcfg.n_devices
        return device_of
    for p in np.unique(block_phase):
        idx = np.flatnonzero(block_phase == p)
        for d, chunk in enumerate(np.array_split(idx, fcfg.n_devices)):
            device_of[chunk] = d
    return device_of


def _resolve_placement(fcfg: FleetConfig, gmap, block_phase, traces,
                       backend: str, device: torch.device
                       ) -> tuple[str, str]:
    """Decide host vs one card per device; returns ``(placement,
    reason)``."""
    if fcfg.placement == "host":
        return "host", "requested"
    n = fcfg.n_devices
    reasons = []
    if len({int(k) for k in gmap}) != 1:
        reasons.append("mixed-program grid")
    if np.unique(block_phase).size != 1:
        reasons.append("multi-phase (barrier) launch")
    if not all(t.halted for t in traces):
        reasons.append("fuel-limited trace")
    if gmap.shape[0] % n != 0:
        reasons.append(f"{gmap.shape[0]} blocks not divisible by "
                       f"{n} devices")
    if fcfg.route != "block":
        reasons.append(f"route={fcfg.route!r} is not block-contiguous")
    if device.type != "cuda":
        reasons.append(f"backend={backend!r} keeps the state on the host")
    elif n > torch.cuda.device_count():
        reasons.append(f"torch exposes {torch.cuda.device_count()} CUDA "
                       f"device(s) < {n}")
    if not reasons:
        return "shard_map", "uniform single-program single-phase grid"
    reason = "; ".join(reasons)
    if fcfg.placement == "shard_map":
        raise ValueError(f"placement='shard_map' unavailable: {reason}")
    return "host", reason


def launch_fleet(fcfg: FleetConfig, program=None, grid=None,
                 block: int | None = None, *,
                 programs: Sequence[Any] | None = None,
                 grid_map: Sequence[int] | None = None,
                 buffers: Mapping[str, Any] | None = None,
                 shmem: Any = None, gmem: Any = None,
                 backend: str | None = None, dim_x: int | None = None,
                 schedule: str | None = None,
                 engine: str | None = None,
                 packing: str | None = None,
                 queue_depth: int = 0) -> LaunchResult:
    """CUDA-style launch across a fleet of simulated eGPUs.

    The grid forms, keywords and architectural results are
    :func:`core.device.launch`'s on one device; the fleet changes only
    where blocks run and what the cycle model charges. The result carries
    the fleet view in ``result.fleet`` / ``profile()["fleet"]``: the
    routing, the resolved placement and why, per-device occupancy and the
    NUMA charge.
    """
    dcfg = fcfg.device
    if fcfg.n_devices == 1:
        res = launch(dcfg, program, grid, block, programs=programs,
                     grid_map=grid_map, buffers=buffers, shmem=shmem,
                     gmem=gmem, backend=backend, dim_x=dim_x,
                     schedule=schedule, engine=engine, packing=packing,
                     queue_depth=queue_depth)
        t = res.timing
        res.fleet = {
            "n_devices": 1, "route": fcfg.route, "placement": "host",
            "placement_reason": "single-device fleet is the plain device",
            "remote_gmem_latency": int(fcfg.remote_gmem_latency),
            "remote_gmem_cycles": 0,
            "per_device": [{
                "device": 0, "home": fcfg.home_device == 0,
                "blocks": res.n_blocks,
                "busy": int(t.sm_busy.sum()) if t is not None else 0,
                "wait": int(t.sm_wait.sum()) if t is not None else 0,
                "idle": int(t.sm_idle.sum()) if t is not None else 0,
                "makespan": int(res.cycles),
            }],
        }
        return res

    # ---- normalize + lower exactly like the single device ---------------
    kernels, gmap, shmems = _normalize_grid(dcfg, program, grid, block,
                                            dim_x, programs, grid_map,
                                            shmem)
    n_blocks = int(gmap.shape[0])
    backend = backend or dcfg.backend
    home = backend_device(backend)
    mode = _resolve_schedule(schedule, dcfg, len(kernels))
    names, cfgs, _, traces, _ = _lower_kernels(dcfg, kernels)
    eng, eng_fallback = _resolve_engine(engine, dcfg, traces)

    host_latency, host_dispatch = _host_dispatch(dcfg, queue_depth)

    phase_of_kernel = np.cumsum([int(k.barrier) for k in kernels])
    block_phase = phase_of_kernel[gmap]
    device_of = _route_blocks(fcfg, gmap, block_phase)
    local_bid = np.zeros(n_blocks, np.int64)
    for k in range(len(kernels)):
        pos = np.flatnonzero(gmap == k)
        local_bid[pos] = np.arange(pos.size)
    placement, placement_reason = _resolve_placement(
        fcfg, gmap, block_phase, traces, backend, home)

    # ---- global-memory image, on the home device ---------------------------
    offsets = None
    if buffers is not None:
        if gmem is not None:
            raise ValueError("pass either buffers= or gmem=, not both")
        gm, offsets = pack_buffers(buffers, dcfg.global_mem_depth)
        gm = gm.to(home)
    elif gmem is not None:
        gm = as_u32_image(gmem, dcfg.global_mem_depth, "global-memory", home)
    else:
        gm = torch.zeros((dcfg.global_mem_depth,), dtype=torch.int32,
                         device=home)

    # fleet-level per-kernel shmem batches (program-local block order)
    counts = [int((gmap == k).sum()) for k in range(len(kernels))]
    sh_batches = [_kernel_shmem(shmems[k], cfgs[k].shmem_depth,
                                counts[k], k) if counts[k] else None
                  for k in range(len(kernels))]

    # ---- functional execution: phase by phase, one sub-launch per device
    # against the phase's base image, the images diff-merged in device
    # order on the home device. One card per device runs the trace engine
    # there, as the reference's mapped body does.
    regs_slots: list[Any] = [None] * n_blocks
    shmem_slots: list[Any] = [None] * n_blocks
    oob_slots: list[Any] = [None] * n_blocks
    halted = True
    sub_engine = eng
    if placement == "shard_map":
        sub_engine, eng_fallback = "trace", None
    for p in np.unique(block_phase):
        pblocks = np.flatnonzero(block_phase == p)
        base = merged = gm
        for d in range(fcfg.n_devices):
            bd = pblocks[device_of[pblocks] == d]
            if bd.size == 0:
                continue
            card, on_card = home, contextlib.nullcontext()
            if placement == "shard_map":
                card = torch.device("cuda", d)
                on_card = torch.cuda.device(card)
            with on_card:
                sub_shmems: list[Any] = []
                for k in range(len(kernels)):
                    batch = sh_batches[k]
                    mine = bd[gmap[bd] == k]
                    if batch is None or mine.size == 0:
                        sub_shmems.append(None)
                    else:
                        sub_shmems.append(batch[torch.as_tensor(
                            local_bid[mine], device=batch.device)].to(card))
                sub = launch(dcfg, programs=kernels, grid_map=gmap[bd],
                             shmem=sub_shmems, gmem=base.to(card),
                             backend=backend, schedule=mode,
                             engine=sub_engine, packing=packing,
                             block_ids=local_bid[bd])
            sub_gm = sub.gmem.to(home)
            merged = torch.where(sub_gm != base, sub_gm, merged)
            regs, sh, oob = (sub.regs.to(home), sub.shmem.to(home),
                             sub.oob.to(home))
            for i, b in enumerate(bd):
                regs_slots[b] = regs[i]
                shmem_slots[b] = sh[i]
                oob_slots[b] = oob[i]
            halted = halted and sub.halted
        gm = merged

    # ---- fleet timing: per-device schedules, merged ----------------------
    lat = int(fcfg.remote_gmem_latency)
    remote_traces = [_remote_trace(t, lat) for t in traces]

    def _trace_of(b: int, d: int) -> ProgramTrace:
        return (traces if d == fcfg.home_device
                else remote_traces)[int(gmap[b])]

    block_priority = np.asarray([kernels[k].priority for k in gmap],
                                np.int64)
    policy = packing if packing is not None else dcfg.packing
    resolved_packing = "grid"

    def _fleet_schedule(sched_mode: str):
        nonlocal resolved_packing
        parts = []
        t0 = int(host_latency)
        for p in np.unique(block_phase):
            pblocks = np.flatnonzero(block_phase == p)
            span = t0
            for d in range(fcfg.n_devices):
                bd = pblocks[device_of[pblocks] == d]
                if bd.size == 0:
                    continue
                trs = [_trace_of(b, d) for b in bd]
                wp = pack_waves([t.data_steps for t in trs],
                                dcfg.n_sms, policy=policy)
                if wp.policy == "length":
                    resolved_packing = "length"
                s = schedule_blocks(trs, dcfg.n_sms, sched_mode,
                                    priority_of=block_priority[bd],
                                    packing=wp, start_cycle=t0)
                parts.append((s, bd, d * dcfg.n_sms))
                span = max(span, s.makespan)
            t0 = span
        return merge_schedules(parts, fcfg.n_sms, n_blocks)

    timing = _fleet_schedule(mode)
    static_span = timing.makespan if mode == "static" \
        else _fleet_schedule("static").makespan

    # ---- aggregate counters ---------------------------------------------
    steps = 0
    by_class = np.zeros((NUM_CLASSES,), np.int64)
    remote_gmem_cycles = 0
    for b in range(n_blocks):
        t = _trace_of(b, int(device_of[b]))
        steps += t.steps
        by_class += np.asarray(t.cycles_by_class(), np.int64)
        if int(device_of[b]) != fcfg.home_device:
            remote_gmem_cycles += t.gmem_cycles \
                - traces[int(gmap[b])].gmem_cycles

    per_device = []
    for d in range(fcfg.n_devices):
        lo, hi = d * dcfg.n_sms, (d + 1) * dcfg.n_sms
        mine = device_of == d
        dev_finish = int(timing.block_finish[mine].max()) \
            if mine.any() else 0
        per_device.append({
            "device": int(d), "home": d == fcfg.home_device,
            "blocks": int(mine.sum()),
            "busy": int(timing.sm_busy[lo:hi].sum()),
            "wait": int(timing.sm_wait[lo:hi].sum()),
            "idle": int(timing.sm_idle[lo:hi].sum()),
            "makespan": dev_finish,
        })

    return LaunchResult(
        grid=(n_blocks,),
        block=cfgs[0].n_threads if len(kernels) == 1
        else tuple(c.n_threads for c in cfgs),
        n_waves=len(timing.wave_cycles),
        regs=torch.stack(regs_slots, dim=0),
        shmem=torch.stack(shmem_slots, dim=0),
        gmem=gm,
        oob=torch.stack(oob_slots, dim=0),
        halted=halted,
        steps=int(steps),
        cycles=int(timing.makespan),
        wave_cycles=np.asarray(timing.wave_cycles, np.int64),
        cycles_by_class=by_class.astype(np.int64),
        buffer_offsets=offsets,
        schedule=mode,
        engine=sub_engine,
        engine_fallback=eng_fallback,
        program_names=tuple(names),
        grid_map=gmap,
        timing=timing,
        static_cycles=int(static_span),
        trace_merge=None,
        packing=resolved_packing,
        wave_packing=None,
        host_dispatch=host_dispatch,
        priority_respected=(mode == "dynamic")
        or not any(k.priority for k in kernels),
        fleet={
            "n_devices": int(fcfg.n_devices),
            "route": fcfg.route,
            "placement": placement,
            "placement_reason": placement_reason,
            "remote_gmem_latency": lat,
            "remote_gmem_cycles": int(remote_gmem_cycles),
            "per_device": per_device,
        },
    )
