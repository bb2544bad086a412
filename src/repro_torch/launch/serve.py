"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>
[--smoke] [--device cpu]``.

Builds the model on the card (its weights drawn there from a seeded
generator), spins up the continuous-batching engine, feeds it a synthetic
request trace with staggered arrivals and lengths, and prints one JSON
line: throughput and the active-mask history (the flexible-wavefront
telemetry)."""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..configs import get_arch
from ..models import build_model
from ..serve import Engine, Request



def build_engine(cfg, *, slots: int = 4, capacity: int = 128,
                 device=None) -> Engine:
    """The model of ``cfg`` in float32 (weights from seed 0) behind an
    engine of ``slots`` slots of ``capacity`` positions."""
    model = build_model(cfg, device=device).requires_grad_(False)
    return Engine(model, max_slots=slots, capacity=capacity)


def drive(eng: Engine, cfg, *, requests: int = 8, max_new: int = 16) -> dict:
    """Submit ``requests`` staggered requests (prompts of 4-16 tokens, one
    decode step after each submission), decode until all are done, and
    return the launcher's report."""
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for rid in range(requests):
        eng.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab_size, int(rng.integers(4, 17))),
            max_new_tokens=int(rng.integers(4, max_new + 1))))
        eng.step()
    outs = eng.run_until_done()
    dt = time.perf_counter() - t0
    toks = sum(len(v) for v in outs.values())
    return {
        "arch": cfg.name, "requests": len(outs), "tokens": toks,
        "wall_s": round(dt, 2), "tok_per_s": round(toks / dt, 1),
        "decode_steps": eng.steps_run,
        "active_width_histogram": {
            str(w): eng.active_history.count(w)
            for w in sorted(set(eng.active_history))},
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--capacity", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch, smoke=args.smoke)
    eng = build_engine(cfg, slots=args.slots, capacity=args.capacity,
                       device=args.device)
    print(json.dumps(drive(eng, cfg, requests=args.requests,
                           max_new=args.max_new)))


if __name__ == "__main__":
    main()
