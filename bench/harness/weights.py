"""The benchmark's weights: made on the device from ``--seed``, a buffer
per group of leaves (the embedding, each layer, the head), each drawn by
one ``normal_`` call on a generator of the device and then scaled leaf by
leaf in place. The reference makes the same groups again from the seed,
one at a time; nothing here imports the program.

A leaf is named as the program's parameter of the same role
(``blocks.3.attn.wq``); its layout is ``(d_in, d_out)``, applied as
``x @ W``.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass

import torch

NORM_SCALE = 0.1      # a norm's offset: its weight is 1 + the offset
EMBED_SCALE = 0.02


def mix(seed: int, *salt) -> int:
    """A 63-bit seed made from ``seed`` and ``salt``, the same in every
    process (Python's ``hash`` of a string is not)."""
    text = ":".join(str(s) for s in (seed, *salt)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def padded_vocab(model: dict) -> int:
    pad = model.get("vocab_pad", 256)
    return -(-model["vocab_size"] // pad) * pad


@dataclass(frozen=True)
class Leaf:
    name: str
    shape: tuple[int, ...]
    scale: float

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


def _attn(prefix: str, m: dict) -> list[Leaf]:
    d, hd = m["d_model"], m["head_dim"]
    q, kv = m["n_heads"] * hd, m["n_kv_heads"] * hd
    s = 1.0 / math.sqrt(d)
    return [Leaf(f"{prefix}.ln_attn.scale", (d,), NORM_SCALE),
            Leaf(f"{prefix}.attn.wq", (d, q), s),
            Leaf(f"{prefix}.attn.wk", (d, kv), s),
            Leaf(f"{prefix}.attn.wv", (d, kv), s),
            Leaf(f"{prefix}.attn.wo", (q, d), 1.0 / math.sqrt(q)),
            Leaf(f"{prefix}.ln_mlp.scale", (d,), NORM_SCALE)]


def _mlp(prefix: str, d: int, ff: int) -> list[Leaf]:
    return [Leaf(f"{prefix}.w_gate", (d, ff), 1.0 / math.sqrt(d)),
            Leaf(f"{prefix}.w_up", (d, ff), 1.0 / math.sqrt(d)),
            Leaf(f"{prefix}.w_down", (ff, d), 1.0 / math.sqrt(ff))]


def groups(model: dict) -> list[tuple[str, list[Leaf]]]:
    """The groups of a dense decoder LM (gated SiLU MLPs) in the order its
    forward pass reads them."""
    if model["family"] != "dense" or \
            model.get("activation", "swiglu") != "swiglu":
        raise ValueError(f"no weights for family {model['family']!r}")
    d, V = model["d_model"], padded_vocab(model)
    out = [("embed", [Leaf("embed.embedding", (V, d), EMBED_SCALE)])]
    layers = [(f"blocks.{i}", _attn(f"blocks.{i}", model)
               + _mlp(f"blocks.{i}.mlp", d, model["d_ff"]))
              for i in range(model["n_layers"])]
    head = [Leaf("ln_f.scale", (d,), NORM_SCALE)]
    if not model.get("tie_embeddings"):
        head.append(Leaf("embed.unembed", (d, V), 1.0 / math.sqrt(d)))
    return out + layers + [("head", head)]


def make_group(leaves: list[Leaf], seed: int, index: int, device,
               dtype=torch.float32) -> dict[str, torch.Tensor]:
    """Group ``index``'s leaves: views of one buffer drawn by one call."""
    total = sum(leaf.numel for leaf in leaves)
    gen = torch.Generator(device=device).manual_seed(mix(seed, "weights",
                                                         index))
    buf = torch.empty(total, dtype=dtype, device=device)
    buf.normal_(0.0, 1.0, generator=gen)
    out, at = {}, 0
    for leaf in leaves:
        view = buf[at:at + leaf.numel].view(leaf.shape)
        view.mul_(leaf.scale)
        out[leaf.name] = view
        at += leaf.numel
    return out


def make_all(model: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every leaf of the model, name -> tensor."""
    out = {}
    for i, (_, leaves) in enumerate(groups(model)):
        out.update(make_group(leaves, seed, i, device))
    return out


def n_params(model: dict) -> int:
    return sum(leaf.numel for _, leaves in groups(model) for leaf in leaves)
