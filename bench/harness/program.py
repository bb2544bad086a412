"""The system under test: the port's model, built empty and given the
benchmark's weights (views of the buffers ``weights`` drew; nothing is
copied)."""
from __future__ import annotations

from contextlib import contextmanager


def build_lm(model: dict, leaves: dict, train: bool):
    from torch import nn

    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.registry import build_model

    lm = build_model(ModelConfig(**model), device="meta")
    names = {n for n, _ in lm.named_parameters()}
    if names != set(leaves):
        raise ValueError("the benchmark's leaves are not the model's: "
                         f"{sorted(names ^ set(leaves))[:8]}")
    for name, t in leaves.items():
        owner, _, attr = name.rpartition(".")
        lm.get_submodule(owner)._parameters[attr] = nn.Parameter(
            t, requires_grad=train)
    return lm


@contextmanager
def patched(obj, attr: str, make):
    """``obj.attr`` replaced by ``make(original)`` inside the body."""
    orig = getattr(obj, attr)
    setattr(obj, attr, make(orig))
    try:
        yield orig
    finally:
        setattr(obj, attr, orig)


def in_span(spans, name: str, fn):
    def call(*args, **kw):
        with spans(name):
            return fn(*args, **kw)
    return call
