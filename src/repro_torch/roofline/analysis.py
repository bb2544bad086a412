"""Roofline analysis of dry-run cells on the NVIDIA H100 SXM (80 GB).

Three terms per (arch x shape x mesh) cell, each per device:

    compute_s    = flops / PEAK_FLOPS
    memory_s     = bytes_accessed / HBM_BW
    collective_s = collective_bytes / (LINK_BW * LINKS)

The dry run (``launch.dryrun``) counts the three on one rank's run of the
step: ``flops`` by ``torch.utils.flop_counter.FlopCounterMode``,
``bytes_accessed`` by its byte counter and ``collective_bytes`` by
``collective_bytes`` below, the output bytes of every collective call.

MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE) measures how much of the
counted compute is "useful" (catches recomputation and redundancy: the
port's sharded steps run the whole model on every rank of a "model" line).
"""
from __future__ import annotations

import re

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# ---- H100 SXM 80 GB hardware constants (NVIDIA H100 datasheet) -------------
PEAK_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s per card
PEAK_FLOPS_FP32 = 67e12      # FP32 FLOP/s per card (the float32 runs)
HBM_BW = 3.35e12             # HBM3 bytes/s per card
HBM_PER_CHIP = 80 * 2**30    # the 80 GB card's memory
# A 16-rank axis of the production mesh spans two 8-GPU nodes, so its ring
# runs at the network's pace: one 400 Gb/s NIC per GPU, as in a DGX H100.
# (Inside a node NVLink 4 gives 450 GB/s per direction.)
LINK_BW = 50e9               # bytes/s per link
LINKS = 1                    # links per card a collective uses at once

# the ops of torch.distributed's two op namespaces that move data (not
# wait_tensor, _wrap_tensor_autograd or a barrier)
_COLLECTIVE_NS = ("c10d", "_c10d_functional", "_c10d_functional_autograd")
_MOVES = re.compile(r"all|reduce|gather|scatter|broadcast|send|recv")


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


class collective_bytes(TorchDispatchMode):
    """Counts, while active, the output bytes of every collective call
    (``c10d`` ops and ``funcol``'s functional ones) that moves data: the
    reference's convention. A gather's autograd wrapper and its wait are
    not calls that move data, so each gather counts once. ``total`` is
    the sum, ``calls`` the number of calls by op and ``by_op`` their
    bytes by op."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.calls: dict[str, int] = {}
        self.by_op: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.__name__.split(".")[0]
        if func.namespace in _COLLECTIVE_NS and _MOVES.search(name):
            n = _bytes(out)
            self.total += n
            self.calls[name] = self.calls.get(name, 0) + 1
            self.by_op[name] = self.by_op.get(name, 0) + n
        return out


# ---------------------------------------------------------------------------
# parameter counts for MODEL_FLOPS
# ---------------------------------------------------------------------------

def param_count(cfg) -> tuple[float, float]:
    """(total_params, active_params) — embedding excluded from the 6ND
    convention's N (we report both)."""
    d, L = cfg.d_model, cfg.n_layers
    V = cfg.padded_vocab
    emb = V * d * (1 if cfg.tie_embeddings else 2)

    def attn_params():
        return d * cfg.n_heads * cfg.head_dim + \
            2 * d * cfg.n_kv_heads * cfg.head_dim + \
            cfg.n_heads * cfg.head_dim * d

    def mlp_params(ff):
        mult = 3 if cfg.activation in ("swiglu", "geglu") else 2
        return mult * d * ff

    if cfg.family == "ssm":
        di, G, N, H = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
        per = d * (2 * di + 2 * G * N + H) + di * d
        total = L * per + emb
        return total, total
    if cfg.family == "hybrid":
        pat = cfg.block_pattern
        n_rec = sum(1 for i in range(L) if pat[i % len(pat)] == "rec")
        n_att = L - n_rec
        w = cfg.lru_width
        rec = 2 * d * w + 2 * w * w + w * d
        per_mlp = mlp_params(cfg.d_ff)
        total = n_rec * (rec + per_mlp) + n_att * (attn_params() + per_mlp) + emb
        return total, total
    if cfg.family == "moe":
        shared = mlp_params(cfg.d_ff * cfg.n_shared_experts) \
            if cfg.n_shared_experts else 0
        expert = mlp_params(cfg.d_ff)
        n_moe = L - int(cfg.first_layer_dense)
        total = n_moe * (attn_params() + cfg.n_experts * expert + shared
                         + d * cfg.n_experts) + emb
        active = n_moe * (attn_params() + cfg.top_k * expert + shared
                          + d * cfg.n_experts) + emb
        if cfg.first_layer_dense:
            dense = attn_params() + mlp_params(cfg.dense_d_ff)
            total += dense
            active += dense
        return total, active
    if cfg.family == "audio":
        enc = cfg.encoder_layers * (attn_params() + mlp_params(cfg.d_ff))
        dec = L * (2 * attn_params() + mlp_params(cfg.d_ff))
        total = enc + dec + emb
        return total, total
    # dense / vlm
    total = L * (attn_params() + mlp_params(cfg.d_ff)) + emb
    return total, total


def model_flops(cfg, shape) -> float:
    """6*N_active*D convention (D = tokens processed by the step)."""
    _, active = param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active * tokens        # forward only
    tokens = shape.global_batch              # one new token per sequence
    return 2.0 * active * tokens


def roofline_row(cfg, shape, row: dict, peak_flops: float | None = None
                 ) -> dict:
    """The three terms and the bottleneck of one dry-run row (its counts
    per device), at ``peak_flops`` (``PEAK_FLOPS``, bf16, unless given:
    ``PEAK_FLOPS_FP32`` for a float32 step)."""
    peak = PEAK_FLOPS if peak_flops is None else peak_flops
    chips = row["n_chips"]
    flops_dev = row["flops"]
    bytes_dev = row["bytes_accessed"]
    coll_dev = row["collective_bytes"]
    compute_s = flops_dev / peak
    memory_s = bytes_dev / HBM_BW
    collective_s = coll_dev / (LINK_BW * LINKS)
    mf = model_flops(cfg, shape)
    useful = mf / (flops_dev * chips) if flops_dev else 0.0
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    bound = max(compute_s, memory_s, collective_s)
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "model_flops": mf,
        "useful_flops_ratio": useful,
        "roofline_fraction": (mf / chips / peak) / bound if bound else 0.0,
        "step_time_lower_bound_s": bound,
    }
