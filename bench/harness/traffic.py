"""The one generator of the traffic mixes, driven by the mix's data file.

``"kind": "train"``: a batch of ``batch`` x ``seq_len`` token ids a step,
drawn on the device from the seed and the step's number (every row of
every step differs). A mix of another kind needs its own driver,
``harness/<kind>.py``.
"""
from __future__ import annotations

import torch

from .weights import mix


class TrainFeed:
    def __init__(self, traffic: dict, model: dict, seed: int, device):
        self.B, self.S = int(traffic["batch"]), int(traffic["seq_len"])
        self.vocab = int(model["vocab_size"])
        self.seed, self.device = seed, device

    def batch(self, step: int) -> dict:
        gen = torch.Generator(device=self.device).manual_seed(
            mix(self.seed, "batch", step))
        toks = torch.randint(0, self.vocab, (self.B, self.S), generator=gen,
                             device=self.device)
        return {"tokens": toks, "labels": toks}
