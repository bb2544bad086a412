#!/usr/bin/env python3
"""Time the segment kernel of two or more checkouts in turns, on one card.

    python3 tools/segment_turns.py ROOT_A ROOT_B [...]

It runs the roots in order and then in reverse (A, B, B, A for two), each
turn one process on that checkout's ``src``: the process builds the
checkout's kernels in its own ``build/`` and times its ``simt_segment`` on
one wave of four SMs of QRD-16 and of FFT-64 (``chip_smoke.segment_wave``'s
shapes: the plan's one fused segment, zero registers, the programs' own
shared-memory images of seeded random inputs), each held ``==`` to
``apply_segment_rows`` first. ``ms`` is CUDA events over 200 launches with
the host's cost per launch, ``device_ms`` the card alone (50 launches
queued behind a sleep kernel). A checkout whose plan places barriers
(``MegakernelPlan.device_barriers``) hands them to its kernel. Each turn
prints one JSON line after the card's name and power limit.

    python3 tools/segment_turns.py --rows ROOT

times one checkout's kernel (card alone) on the first k rows of each
wave, k = 1, a quarter, a half and all of them, with the plan's barriers
and with both barriers on every row: the slope is the cost per row, the
intercept the launch with its copies in and out, and the difference
between the two what the barriers the plan leaves out would cost.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def one(root: Path, prefixes: bool = False) -> dict:
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs                  # the timing helpers
    sys.path.insert(0, str(root / "src"))    # the checkout under test
    import numpy as np
    import torch
    from repro_torch.core import SMConfig, compile_megakernel
    from repro_torch.core.executor import apply_segment_rows
    from repro_torch.core.programs import fft_shmem, qrd_program, qrd_shmem
    from repro_torch.core.programs.fft import fft_program
    from repro_torch.kernels.simt_step import simt_segment

    if not Path(sys.modules["repro_torch"].__file__).is_relative_to(root):
        raise RuntimeError(f"repro_torch was not imported from {root}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(20260611)
    waves = {
        "qrd16": (qrd_program(), SMConfig(n_threads=256, dim_x=16,
                                          imem_depth=1024,
                                          max_steps=200_000),
                  lambda: qrd_shmem(rng.standard_normal((16, 16)), 3072)),
        "fft64": (fft_program(64), SMConfig(n_threads=32, dim_x=32,
                                            max_steps=200_000),
                  lambda: fft_shmem((rng.standard_normal(64) + 1j
                                     * rng.standard_normal(64)).astype(
                                         np.complex64), 3072))}
    out = {"root": str(root)}
    for name, (program, cfg, image) in waves.items():
        plan = compile_megakernel(program, cfg)
        ((_, (start, stop)),) = plan.items
        rows = plan.device_table(dev)[start:stop]
        kw = ({"barriers": plan.device_barriers(dev)[start:stop]}
              if hasattr(plan, "device_barriers") else {})
        state = (torch.arange(4, dtype=torch.int32, device=dev),
                 torch.zeros(4, dtype=torch.int32, device=dev),
                 torch.zeros((4, 512, 16), dtype=torch.int32, device=dev),
                 torch.from_numpy(np.stack([image() for _ in range(4)])
                                  .view(np.int32)).to(dev),
                 torch.zeros(4, dtype=torch.bool, device=dev))
        got = simt_segment(cfg, rows, *state, **kw)
        want = apply_segment_rows(cfg, plan.sched.table[start:stop], *state)
        for g, w in zip(got, want):
            cs.words_equal(f"segment {name}", g, w)
        kern = lambda: simt_segment(cfg, rows, *state, **kw)  # noqa: E731
        out[name] = dict(rows=stop - start, ms=cs.cuda_time_ms(kern, 200),
                         device_ms=cs.cuda_device_ms(kern))
        if prefixes:
            n = stop - start
            every = torch.full_like(kw["barriers"], 3)
            out[name]["prefix_device_ms"] = {
                k: [cs.cuda_device_ms(lambda: simt_segment(
                    cfg, rows[:k], *state, barriers=bits[:k]))
                    for bits in (kw["barriers"], every)]
                for k in (1, n // 4, n // 2, n)}
    return out


def main(argv: list[str]) -> int:
    if len(argv) >= 2 and argv[0] in ("--one", "--rows"):
        print(json.dumps(one(Path(argv[1]).resolve(),
                             prefixes=argv[0] == "--rows")), flush=True)
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs

    print(cs.card_line(), flush=True)
    roots = [str(Path(r).resolve()) for r in argv]
    for root in roots + roots[::-1]:
        subprocess.run([sys.executable, __file__, "--one", root], check=True,
                       timeout=600)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
