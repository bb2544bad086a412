"""Global-norm gradient clipping."""
from __future__ import annotations

import torch

from ..spans import span


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    """The norm over every leaf, in float32, on the leaves' device. The
    per-leaf sums of squares are added in the dict's order, one leaf at a
    time: the reference sums its leaves in its own flattening order (over
    its stacked layer axes), so the two agree within a float32 tolerance,
    not bit for bit."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.values()))


def clip_by_global_norm(tree: dict[str, torch.Tensor], max_norm: float):
    """Scales every leaf by ``min(1, max_norm / (norm + 1e-6))`` in place
    and returns ``(tree, norm)``."""
    with span("optim.clip"):
        norm = global_norm(tree)
        limit = torch.tensor(max_norm, dtype=torch.float32,
                             device=norm.device)
        scale = torch.clamp(limit / (norm + 1e-6), max=1.0)
        with torch.no_grad():
            for g in tree.values():
                if g.dtype == torch.float32:
                    g.mul_(scale)
                else:
                    g.copy_(g.float() * scale)
    return tree, norm
