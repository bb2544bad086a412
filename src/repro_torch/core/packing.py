"""Schedule-aware wave packing: which blocks share a wave, and why.

The eGPU paper packs multiple SMs into one Agilex logic region and earns
its throughput by keeping every SP lane busy; the scalable follow-up
(arXiv 2401.04261) shows dispatch-order decisions dominate multi-SM
occupancy. Our merged-wave trace engine (``core.trace_engine``) executes
a heterogeneous wave as ONE scan padded to the wave's longest
participant, so wave *membership* is a first-class performance decision:
a long program padded next to a short one wastes a masked no-op scan row
per step of the difference, per member. Grid-order packing (the
original rule) routinely shows >30% pad overhead on adversarial mixed grids.

``pack_waves`` decides that membership once, and every layer consumes
the same decision:

  * the **functional** merged-trace path groups blocks into exactly
    these waves (``device.launch``);
  * the **static timing** model chunks its lockstep waves identically
    (``scheduler.schedule_blocks(packing=)``), so golden cycle totals
    stay an exact statement about the waves that actually ran;
  * the **dynamic** queue pops blocks in the packed order (FIFO ties),
    which is what keeps the fuzzed ``dynamic <= static`` bound holding
    against the *packed* wave baseline — list dispatch in order X never
    loses to serial waves chunked from the same order X, but it can lose
    to waves chunked from a different one.

Policies (``DeviceConfig.packing`` / ``launch(packing=)``):

``"grid"``
    Waves are consecutive chunks of ``n_sms`` blocks in grid order
    within each barrier phase — byte-identical to the unpacked behaviour,
    and the default: packing is opt-in, never a silent timing change.

``"length"``
    Within each phase, blocks are stably sorted by descending schedule
    length (ties keep grid order) and split into the same *number* of
    waves as grid packing, with wave boundaries chosen by a small DP
    that minimizes total padded scan steps (each wave may be narrower
    than ``n_sms`` — isolating one long straggler beats padding three
    short blocks to it). Sorting first is lossless: an exchange
    argument shows some contiguous-in-sorted-order split is optimal
    over ALL partitions into that many waves of width <= ``n_sms``, so
    length packing NEVER pads more than grid packing
    (``tests/test_packing.py`` property-tests this).

``"auto"``
    ``"length"`` when a phase mixes schedule lengths (a heterogeneous
    grid), ``"grid"`` otherwise — single-program grids resolve to grid,
    where the two policies coincide anyway.

Packing never changes observable state: functional results stay
canonical (the step machine's program-major order; merged waves under
the no-concurrent-gmem-races launch contract), it only changes which
blocks share a wave — and therefore the modeled timing and the merge
padding. A wave never crosses a ``Kernel(barrier=True)`` phase fence.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

PACKINGS = ("grid", "length", "auto")


@dataclasses.dataclass(frozen=True)
class WavePacking:
    """One launch's wave membership decision.

    ``waves[w]`` is the tuple of block indices sharing wave ``w``, in
    dispatch order (phase-major; within a phase, the policy's order).
    ``wave_phase[w]`` is the barrier phase every member of wave ``w``
    belongs to. ``lengths[b]`` is the per-block schedule length the
    policy packed on (the trace engine's data-step count).
    """

    policy: str                          # resolved: "grid" | "length"
    n_sms: int
    waves: tuple[tuple[int, ...], ...]
    wave_phase: tuple[int, ...]
    lengths: tuple[int, ...]

    @property
    def n_waves(self) -> int:
        return len(self.waves)

    @property
    def n_blocks(self) -> int:
        return len(self.lengths)

    @property
    def order(self) -> np.ndarray:
        """(n_blocks,) block dispatch order: the waves concatenated.

        This is the order the dynamic queue pops (FIFO ties) and the
        order whose consecutive chunks are the static waves — one order,
        consumed by every layer.
        """
        return np.asarray([b for wave in self.waves for b in wave],
                          np.int64)

    @property
    def wave_sizes(self) -> tuple[int, ...]:
        return tuple(len(w) for w in self.waves)

    @property
    def occupancy(self) -> float:
        """Mean wave fill fraction: members per wave over ``n_sms``,
        averaged across waves. 1.0 means every wave used every SM slot —
        the batch-occupancy figure the serving front door reports per
        dispatched batch (``serve.LaunchServer``)."""
        if not self.waves:
            return 0.0
        return sum(len(w) for w in self.waves) / (self.n_sms
                                                  * len(self.waves))

    def pad_steps(self) -> int:
        """Total padded scan steps: rows a member idles while its wave
        drains the longest participant, summed over waves — the metric
        the "length" policy minimizes."""
        return sum(sum(max(self.lengths[b] for b in wave)
                       - self.lengths[b] for b in wave)
                   for wave in self.waves)


def _grid_waves(idx: np.ndarray, n_sms: int) -> list[tuple[int, ...]]:
    return [tuple(int(b) for b in idx[w0:w0 + n_sms])
            for w0 in range(0, idx.size, n_sms)]


def _length_waves(idx: np.ndarray, lengths: np.ndarray,
                  n_sms: int) -> list[tuple[int, ...]]:
    """Pad-minimal waves for one phase: stable-desc sort, then a DP over
    contiguous wave boundaries.

    With blocks sorted by descending length, a wave's pad cost is
    ``first_member_length * size - sum(member lengths)``; the member-sum
    term is partition-invariant, so the DP minimizes
    ``sum(first * size)`` over exactly ``ceil(n / n_sms)`` contiguous
    groups of size 1..n_sms. Ties prefer wider waves, so all-equal
    lengths reproduce grid chunking exactly (single-program grids are
    packing-invariant by construction).
    """
    order = sorted((int(b) for b in idx),
                   key=lambda b: (-int(lengths[b]), b))
    n = len(order)
    m = n_sms
    n_waves = -(-n // m)
    inf = float("inf")
    # f[i][k]: min cost covering order[i:] with k waves; pick[i][k]: the
    # winning wave size at (i, k)
    f = [[inf] * (n_waves + 1) for _ in range(n + 1)]
    pick = [[0] * (n_waves + 1) for _ in range(n + 1)]
    f[n][0] = 0.0
    for i in range(n - 1, -1, -1):
        for k in range(1, n_waves + 1):
            rem = n - i
            if rem > k * m or rem < k:
                continue
            # widest-first: on equal pad cost keep the grid-shaped split
            for s in range(min(m, rem), 0, -1):
                c = int(lengths[order[i]]) * s + f[i + s][k - 1]
                if c < f[i][k]:
                    f[i][k] = c
                    pick[i][k] = s
    waves: list[tuple[int, ...]] = []
    i, k = 0, n_waves
    while i < n:
        s = pick[i][k]
        waves.append(tuple(order[i:i + s]))
        i, k = i + s, k - 1
    return waves


def pack_waves(lengths: Sequence[int], n_sms: int,
               policy: str = "grid",
               phase_of: Sequence[int] | None = None) -> WavePacking:
    """Group blocks into waves of at most ``n_sms``, per barrier phase.

    ``lengths[b]`` is block ``b``'s schedule length (for the merged
    trace engine: data-instruction scan steps — what the padding is
    measured in). ``phase_of[b]`` is its barrier phase; a wave never
    crosses a phase. Returns a :class:`WavePacking`; the waves cover
    every block exactly once, phases appear in ascending order, and both
    policies produce ``ceil(n_phase / n_sms)`` waves per phase.
    """
    if policy not in PACKINGS:
        raise ValueError(f"packing={policy!r} must be one of {PACKINGS}")
    if n_sms < 1:
        raise ValueError(f"n_sms={n_sms} must be >= 1")
    lens = np.asarray(list(lengths), np.int64)
    if lens.ndim != 1 or lens.shape[0] < 1:
        raise ValueError("lengths must be a non-empty 1-D sequence")
    if (lens < 0).any():
        raise ValueError("schedule lengths must be non-negative")
    n_blocks = int(lens.shape[0])
    if phase_of is None:
        phase = np.zeros(n_blocks, np.int64)
    else:
        phase = np.asarray(list(phase_of), np.int64)
        if phase.shape != (n_blocks,):
            raise ValueError(f"phase_of has shape {phase.shape}, want "
                             f"({n_blocks},)")
    parts = [(int(p), np.flatnonzero(phase == p))
             for p in np.unique(phase)]
    if policy == "auto":
        policy = "length" if any(np.unique(lens[idx]).size > 1
                                 for _, idx in parts) else "grid"
    waves: list[tuple[int, ...]] = []
    wave_phase: list[int] = []
    for p, idx in parts:
        ws = _grid_waves(idx, n_sms) if policy == "grid" \
            else _length_waves(idx, lens, n_sms)
        waves.extend(ws)
        wave_phase.extend([p] * len(ws))
    return WavePacking(policy=policy, n_sms=n_sms,
                       waves=tuple(waves), wave_phase=tuple(wave_phase),
                       lengths=tuple(int(x) for x in lens))
