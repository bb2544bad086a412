"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--smoke] [--device cpu] [--mesh DxM]``.

Builds the model on the card (its weights drawn there from the run's
seed) and runs the data pipeline -> train step -> checkpoints -> metrics
loop, then prints one JSON line. A checkpoint directory that holds a
complete checkpoint is resumed.

``--mesh DxM`` other than ``1x1`` trains on a ("data", "model") mesh of
D*M ranks (``train_loop(mesh=)``: the sharded step, rank 0 logs, writes
the checkpoints and prints the line). Under ``torchrun``'s environment
(``RANK``, ``WORLD_SIZE``, which must be D*M; ``LOCAL_RANK`` names the
rank's card on its node) the process joins that world. Otherwise it
starts the D*M ranks itself: gloo ranks on the host with ``--device
cpu``, one NCCL rank a card with ``--device cuda``, which needs D*M cards
and raises with fewer (it never falls back to the host).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch
import torch.distributed as dist

from ..configs import RunConfig, get_arch
from ..data import PipelineSpec
from ..models import build_model
from ..train import train_loop
from . import mesh as mesh_mod


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
                    help="dataxmodel, e.g. 2x1 (D*M ranks)")
    ap.add_argument("--log", default=None)
    ap.add_argument("--device", default="cuda")
    return ap


def mesh_shape(args) -> tuple[int, int]:
    d, m = (int(x) for x in args.mesh.split("x"))
    if d < 1 or m < 1:
        raise SystemExit(f"--mesh {args.mesh}: both sizes must be >= 1")
    return d, m


def run(args, mesh=None):
    """(cfg, model, rc, spec, LoopResult) of the run ``args`` describe, on
    ``mesh`` if given (every rank of its world calls this; only rank 0
    writes the log)."""
    cfg = get_arch(args.arch, smoke=args.smoke)
    rc = RunConfig(learning_rate=args.lr, ckpt_dir=args.ckpt_dir,
                   ckpt_every=args.ckpt_every, warmup_steps=10,
                   async_ckpt=True)
    device = args.device
    if mesh is not None and device == "cuda":
        device = f"cuda:{torch.cuda.current_device()}"
    model = build_model(cfg, device=device, seed=rc.seed)
    spec = PipelineSpec(vocab=cfg.vocab_size, seq_len=args.seq,
                        global_batch=args.batch, seed=rc.seed)
    log = args.log if mesh is None or dist.get_rank() == 0 else None
    res = train_loop(model, cfg, rc, spec, args.steps, log_path=log,
                     mesh=mesh)
    return cfg, model, rc, spec, res


def report(cfg, res) -> dict:
    return {
        "arch": cfg.name, "steps": len(res.losses),
        "resumed_from": res.resumed_from,
        "first_loss": res.losses[0] if res.losses else None,
        "last_loss": res.losses[-1] if res.losses else None,
        "stragglers": res.straggler_steps,
    }


def _mesh_rank(rank: int, args) -> None:
    """One rank of a ``--mesh`` run (in its process group already)."""
    mesh = mesh_mod.make_mesh(mesh_shape(args), ("data", "model"),
                              "cuda" if args.device == "cuda" else "cpu")
    cfg, _, _, _, res = run(args, mesh)
    if rank == 0:
        print(json.dumps(report(cfg, res)), flush=True)


def main(argv=None):
    args = parser().parse_args(argv)
    d, m = mesh_shape(args)
    n = d * m
    if n == 1:
        cfg, _, _, _, res = run(args)
        print(json.dumps(report(cfg, res)))
        return
    cuda = args.device == "cuda"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        # torchrun's world, which may span nodes: each rank needs its own
        # card on its node
        if int(os.environ["WORLD_SIZE"]) != n:
            raise SystemExit(
                f"--mesh {args.mesh} needs a world of {n} ranks; "
                f"WORLD_SIZE is {os.environ['WORLD_SIZE']}")
        if cuda:
            local = int(os.environ.get("LOCAL_RANK", 0))
            if local >= torch.cuda.device_count():
                raise SystemExit(
                    f"local rank {local} with --device cuda needs card "
                    f"{local}; torch sees {torch.cuda.device_count()} "
                    "CUDA devices on this node")
            torch.cuda.set_device(local)
        dist.init_process_group("nccl" if cuda else "gloo")
        try:
            _mesh_rank(dist.get_rank(), args)
        finally:
            dist.destroy_process_group()
        return
    if cuda and torch.cuda.device_count() < n:
        raise SystemExit(
            f"--mesh {args.mesh} with --device cuda needs {n} CUDA devices "
            f"(one rank a card); torch sees {torch.cuda.device_count()}")
    threads = max(1, (os.cpu_count() or 1) // n)
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as store:
        # by the module's own name: a spawned rank imports it (not
        # __main__)
        from . import train as me

        mesh_mod.run_world(me._mesh_rank, n, store, args,
                           backend="nccl" if cuda else "gloo",
                           timeout_s=600.0, threads=threads)


if __name__ == "__main__":
    main()
