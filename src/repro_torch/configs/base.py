"""Config system: architecture + shape + run configs.

Every assigned architecture gets a ``ModelConfig`` with its exact published
dimensions (one file per arch in this package); reduced smoke variants are
derived with ``.smoke()``. Input-shape cells come from ``SHAPES`` (the
assigned seq_len x global_batch grid).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]


def pad_vocab(v: int, multiple: int = 256) -> int:
    return ((v + multiple - 1) // multiple) * multiple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0                      # 0 => d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    activation: str = "swiglu"             # swiglu | geglu | gelu
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    first_layer_dense: bool = False        # deepseek-moe: layer 0 is dense
    dense_d_ff: int = 0                    # d_ff of that dense layer

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    d_inner: int = 0                       # 0 => 2 * d_model
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    conv_kernel: int = 4
    ssm_chunk: int = 256

    # hybrid (RG-LRU + local attention, RecurrentGemma / Griffin)
    block_pattern: tuple[str, ...] = ()    # e.g. ("rec", "rec", "attn")
    lru_width: int = 0
    window: int = 0                        # local-attention window
    logits_soft_cap: float = 0.0

    # encoder-decoder / modality frontend (STUBBED per the brief)
    encoder_layers: int = 0
    encoder_seq: int = 0                   # whisper: 1500 frames
    num_image_tokens: int = 0              # internvl: patch embeddings

    vocab_pad: int = 256
    # unroll depth scans (used by the dry-run's reduced-depth variants so
    # XLA cost_analysis sees straight-line layers; False for real runs)
    scan_unroll: bool = False
    # q-chunked (flash-style blocked) causal attention: 0 = paper-faithful
    # unblocked baseline; >0 = block size (a §Perf beyond-paper change)
    attn_q_chunk: int = 0
    # cast softmax weights to bf16 for the PV matmul (halves that tile's
    # traffic; logits/softmax stay f32)
    attn_w_bf16: bool = False
    # constrain SSD intermediates to shard on the head axis ("model") —
    # pairs with FSDP-only in_proj so the big (b,nc,Q,H,*) tensors split
    # across TP instead of replicating (a §Perf beyond-paper change)
    ssd_shard_heads: bool = False
    # bf16 SSD intra-chunk operands (decay math stays f32; einsums
    # accumulate in f32): halves the dominant (b,nc,H,Q,Q) tile traffic
    ssd_bf16: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.family == "ssm" and self.d_inner == 0:
            object.__setattr__(self, "d_inner", 2 * self.d_model)

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size, self.vocab_pad)

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.d_inner else 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Supports very long context with O(1)/O(window) decode state."""
        return self.family in ("ssm", "hybrid")

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        kw: dict = dict(
            n_layers=min(self.n_layers, 2 + (2 if self.block_pattern else 0)),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=256,
            head_dim=32,
            vocab_size=512,
            vocab_pad=64,
        )
        if self.n_experts:
            kw.update(n_experts=4, top_k=min(self.top_k, 2),
                      n_shared_experts=min(self.n_shared_experts, 1),
                      dense_d_ff=256 if self.first_layer_dense else 0)
        if self.family == "ssm":
            kw.update(d_inner=256, ssm_state=16, ssm_head_dim=32, ssm_chunk=32)
        if self.block_pattern:
            kw.update(n_layers=3, lru_width=128, window=64, head_dim=32,
                      n_heads=4, n_kv_heads=1)
        if self.encoder_layers:
            kw.update(encoder_layers=2, encoder_seq=64)
        if self.num_image_tokens:
            kw.update(num_image_tokens=16)
        return replace(self, name=self.name + "-smoke", **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """The brief's skip rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: 500k decode needs sub-quadratic attention (skip per brief; see DESIGN.md)"
    return True, ""


@dataclass(frozen=True)
class RunConfig:
    """Training/serving hyperparameters for the launchers."""
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    microbatch: int = 0               # 0 => no gradient accumulation
    remat: str = "block"              # none | block | full
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    grad_compression: str = "none"    # none | int8_ef
    seed: int = 0
    ckpt_dir: str = "checkpoints"     # relative to the working directory
    ckpt_every: int = 100
    async_ckpt: bool = True
