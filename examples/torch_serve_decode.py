"""Serve a small LM with batched requests through the flexible-mask engine,
on the PyTorch/CUDA port.

    PYTHONPATH=src python examples/torch_serve_decode.py               # card
    PYTHONPATH=src python examples/torch_serve_decode.py --device cpu  # host

The flow of ``examples/serve_decode.py`` on ``repro_torch``'s ``Engine``:
granite-3-2b at smoke size with random weights (seed 0), 4 slots of 128
positions, 8 requests drawn from ``np.random.default_rng(0)``, one decode
step after each arrival, then decoding until every request is done.
Without a card the default raises; ``--device cpu`` runs on the host.
"""
import argparse

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.serve import Engine, Request


def serve(device: str = "cuda", seed: int = 0):
    """(engine, outputs): the 8 requests served to the end."""
    cfg = get_arch("granite-3-2b", smoke=True)
    model = build_model(cfg, device=device, seed=seed).requires_grad_(False)
    eng = Engine(model, max_slots=4, capacity=128)
    rng = np.random.default_rng(0)
    for rid in range(8):
        eng.submit(Request(rid=rid,
                           prompt=rng.integers(0, cfg.vocab_size,
                                               int(rng.integers(4, 20))),
                           max_new_tokens=int(rng.integers(4, 12))))
        eng.step()   # arrivals interleave with decoding
    return eng, eng.run_until_done()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    eng, outs = serve(args.device)
    print(f"served {len(outs)} requests in {eng.steps_run} decode steps")
    print("active-width history (the flexible-ISA analogue):",
          eng.active_history)
    for rid in sorted(outs)[:3]:
        print(f"  req {rid}: {outs[rid]}")
    return eng, outs


if __name__ == "__main__":
    main()
