"""Deterministic sharded synthetic-token pipeline.

Design goals mirrored from production data stacks:
  * deterministic: batch content is a pure function of (seed, step) — a
    restart at step k reproduces exactly the batches a non-failing run saw
    (exactly-once sample accounting; the pipeline state in a checkpoint is
    just the step counter);
  * host-shardable: each data-parallel host materializes only its slice
    (``host_slice``), the global batch is never built on one host;
  * structured enough to learn: tokens follow a seeded Markov-ish pattern
    (next token = f(prev)) so training loss measurably drops in the
    end-to-end example — pure-noise pipelines can't show that.

The tokens are numpy, made on the host, and equal the reference's bit for
bit. The stub frontends (audio frames, image embeddings) are drawn from a
``torch.Generator`` seeded with the reference's key number: the same
shape, dtype and scale, other values (PyTorch cannot reproduce the
reference's random bits).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models.layers import target_device


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    n_rules: int = 8

    def _rules(self):
        """A small per-seed pool of affine next-token rules — few enough
        that a ~100M model can learn all transition tables, instead of
        having to infer a fresh rule in-context per row."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 991]))
        a = 1 + 2 * rng.integers(0, (self.vocab - 1) // 2, self.n_rules)
        b = rng.integers(0, self.vocab, self.n_rules)
        return a.astype(np.int64), b.astype(np.int64)

    def batch_at(self, step: int, lo: int = 0, hi: int | None = None):
        """Global batch rows [lo, hi) at `step` (numpy, host-side)."""
        hi = self.global_batch if hi is None else hi
        a_pool, b_pool = self._rules()
        rows = []
        for r in range(lo, hi):
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, r]))
            # seeded affine next-token process with noise: learnable structure
            rule = int(rng.integers(0, self.n_rules))
            a, b = int(a_pool[rule]), int(b_pool[rule])
            x = np.empty(self.seq_len, np.int32)
            x[0] = rng.integers(0, self.vocab)
            noise = rng.random(self.seq_len) < 0.05
            rnd = rng.integers(0, self.vocab, self.seq_len)
            for t in range(1, self.seq_len):
                x[t] = rnd[t] if noise[t] else (a * x[t - 1] + b) % self.vocab
            rows.append(x)
        return np.stack(rows)

    def host_slice(self, step: int, host_id: int, n_hosts: int):
        per = self.global_batch // n_hosts
        return self.batch_at(step, host_id * per, (host_id + 1) * per)


def make_batch(cfg: ModelConfig, spec: PipelineSpec, step: int,
               dtype: torch.dtype = torch.float32, device=None) -> dict:
    """Full train batch for a model family (tokens/labels + stub
    frontends) on ``device`` (the card unless given). The frontends are
    drawn on the host, so every device gets the same values."""
    dev = target_device(device)
    toks = torch.from_numpy(spec.batch_at(step)).to(dev)
    batch = {"tokens": toks, "labels": toks}
    gen = torch.Generator().manual_seed(hash((spec.seed, step)) & 0x7FFFFFFF)
    if cfg.family == "audio":
        shape = (spec.global_batch, cfg.encoder_seq, cfg.d_model)
    elif cfg.family == "vlm":
        shape = (spec.global_batch, cfg.num_image_tokens, cfg.d_model)
    else:
        return batch
    stub = 0.1 * torch.randn(shape, generator=gen, dtype=dtype)
    batch["frames" if cfg.family == "audio" else "image_embeds"] = \
        stub.to(dev)
    return batch


def spec_for(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
             batch: int | None = None, seq: int | None = None) -> PipelineSpec:
    seq_len = seq or shape.seq_len
    if cfg.family == "vlm":
        seq_len = seq_len - cfg.num_image_tokens
    return PipelineSpec(vocab=cfg.vocab_size, seq_len=seq_len,
                        global_batch=batch or shape.global_batch, seed=seed)
