"""End-to-end training run on the PyTorch/CUDA port: a ~100M-param GQA
LM for a few hundred steps.

    PYTHONPATH=src python examples/torch_train_lm.py               # card
    PYTHONPATH=src python examples/torch_train_lm.py --fast        # short run
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu  # host

The flow of ``examples/train_lm.py`` on ``repro_torch``: deterministic
pipeline -> train step (AdamW, clipping, schedule) -> atomic async
checkpoints -> resume (rerun the same command: it continues from the
latest checkpoint in ``--ckpt-dir``; ``--fresh`` starts over). Loss on
the synthetic Markov pipeline falls well below the uniform baseline
ln(V). Without a card the default raises; ``--device cpu`` runs on the
host.
"""
import argparse
import dataclasses
import shutil

import numpy as np

from repro_torch.configs import RunConfig, get_arch
from repro_torch.data import PipelineSpec
from repro_torch.models import build_model
from repro_torch.train import train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default="checkpoints/torch_train_lm")
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # ~100M params: granite family scaled down (12L x 768, GQA 12/4,
    # d_ff 3072, vocab 1024)
    cfg = dataclasses.replace(
        get_arch("granite-3-2b"),
        name="granite-100m", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=4, d_ff=3072, head_dim=64, vocab_size=1024,
        vocab_pad=256)
    if args.fast:
        cfg = get_arch("granite-3-2b", smoke=True)
    model = build_model(cfg, device=args.device, seed=0)

    steps = args.steps or (30 if args.fast else 300)
    if args.fresh:
        shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    rc = RunConfig(learning_rate=args.lr, warmup_steps=20,
                   ckpt_dir=args.ckpt_dir, ckpt_every=50, async_ckpt=True,
                   seed=0)
    spec = PipelineSpec(vocab=cfg.vocab_size,
                        seq_len=args.seq or (64 if args.fast else 256),
                        global_batch=args.batch or (4 if args.fast else 8),
                        seed=0)
    res = train_loop(model, cfg, rc, spec, steps,
                     log_path=args.ckpt_dir + ".jsonl")
    uniform = np.log(cfg.vocab_size)
    print(f"arch={cfg.name} steps={len(res.losses)} "
          f"resumed_from={res.resumed_from}")
    if res.losses:
        print(f"loss: first={res.losses[0]:.3f} last={res.losses[-1]:.3f} "
              f"uniform-baseline={uniform:.3f}")
        assert res.losses[-1] < res.losses[0], "training did not improve"
    if res.straggler_steps:
        print("straggler steps flagged:", res.straggler_steps)
    return res


if __name__ == "__main__":
    main()
