"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--smoke] [--device cpu]``.

Builds the model on the card (its weights drawn there from the run's
seed) and runs the data pipeline -> train step -> checkpoints -> metrics
loop, then prints one JSON line. A checkpoint directory that holds a
complete checkpoint is resumed. One device only: a ``--mesh`` other than
``1x1`` needs the mesh layer, which the port does not have yet.
"""
from __future__ import annotations

import argparse
import json

from ..configs import RunConfig, get_arch
from ..data import PipelineSpec
from ..models import build_model
from ..train import train_loop


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-feasible)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="1x1",
                    help="dataxmodel; only 1x1 runs in the port so far")
    ap.add_argument("--log", default=None)
    ap.add_argument("--device", default="cuda")
    return ap


def run(args):
    """(cfg, model, rc, spec, LoopResult) of the run ``args`` describe."""
    d, m = (int(x) for x in args.mesh.split("x"))
    if d * m != 1:
        raise SystemExit(
            f"--mesh {args.mesh}: data and model parallelism need the mesh "
            "layer (launch/mesh.py, launch/shardings.py), a later slice of "
            "the port; only --mesh 1x1 runs")
    cfg = get_arch(args.arch, smoke=args.smoke)
    rc = RunConfig(learning_rate=args.lr, ckpt_dir=args.ckpt_dir,
                   ckpt_every=args.ckpt_every, warmup_steps=10,
                   async_ckpt=True)
    model = build_model(cfg, device=args.device, seed=rc.seed)
    spec = PipelineSpec(vocab=cfg.vocab_size, seq_len=args.seq,
                        global_batch=args.batch, seed=rc.seed)
    res = train_loop(model, cfg, rc, spec, args.steps, log_path=args.log)
    return cfg, model, rc, spec, res


def report(cfg, res) -> dict:
    return {
        "arch": cfg.name, "steps": len(res.losses),
        "resumed_from": res.resumed_from,
        "first_loss": res.losses[0] if res.losses else None,
        "last_loss": res.losses[-1] if res.losses else None,
        "stragglers": res.straggler_steps,
    }


def main(argv=None):
    cfg, _, _, _, res = run(parser().parse_args(argv))
    print(json.dumps(report(cfg, res)))


if __name__ == "__main__":
    main()
