"""Serving engine: continuous batching with a flexible active mask.

The serving analogue of the eGPU's flexible ISA: a fixed-capacity decode
batch whose active-slot mask varies per step. Requests enter and leave
slots while one ``decode_step`` over all slots runs every step; a
half-empty batch runs the same step with its inactive rows masked.

Slots: each request owns a batch row of every cache tensor. Prefill runs
at batch 1 and its caches are spliced into the slot row; decode advances
ALL slots every step (under ``torch.inference_mode``), sampling greedily
(argmax, the first of equal maxima) and masked by activity; finished
slots free immediately.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

FINISH_REASONS = ("eos", "budget", "capacity", "unadmitted")

# the batch axis of each top-level cache entry: the stacked ones carry a
# leading layer (or group) axis, the rest start with the batch
_UNSTACKED = ("kv0", "tail")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (S,) int
    max_new_tokens: int = 16         # budget for ALL emitted tokens,
                                     # including the prefill-sampled first
    eos_id: int = -1                 # -1: never
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    finish_reason: str | None = None  # one of FINISH_REASONS once done
                                      # ("unadmitted": never got a slot)

    def _finish(self, reason: str) -> None:
        self.done = True
        self.finish_reason = reason


def _splice_leaf(dst: torch.Tensor, src: torch.Tensor, axis: int,
                 slot: int) -> None:
    """Write ``src`` (batch 1 on ``axis``) into row ``slot`` of ``dst``,
    each other axis cut or zero-padded at its end to ``dst``'s length."""
    for ax in range(src.ndim):
        if ax == axis or src.shape[ax] == dst.shape[ax]:
            continue
        n = dst.shape[ax]
        if src.shape[ax] > n:
            src = src.narrow(ax, 0, n)
        else:
            pad = [0, 0] * (src.ndim - ax)
            pad[-1] = n - src.shape[ax]
            src = torch.nn.functional.pad(src, pad)
    dst.narrow(axis, slot, 1).copy_(src)


def _splice(dst, src, axis: int, slot: int) -> None:
    if isinstance(src, torch.Tensor):
        _splice_leaf(dst, src, axis, slot)
    elif isinstance(src, dict):
        for k in src:
            _splice(dst[k], src[k], axis, slot)
    elif isinstance(src, (list, tuple)):
        for d, s in zip(dst, src):
            _splice(d, s, axis, slot)
    # other leaves (an int position, a layer without a cache) stay


class Engine:
    def __init__(self, model, *, max_slots: int = 8, capacity: int = 256,
                 dtype: torch.dtype = torch.float32):
        self.model = model
        self.device = model.device
        self.max_slots = max_slots
        self.capacity = capacity
        with torch.inference_mode():
            self.caches = model.init_decode_caches(max_slots, capacity, dtype)
        self.active = np.zeros(max_slots, bool)
        self.positions = np.zeros(max_slots, np.int32)
        self.budget = np.zeros(max_slots, np.int32)
        self.eos = np.full(max_slots, -1, np.int32)
        self.requests: dict[int, Request] = {}
        self.slot_of: dict[int, int] = {}
        self.last_token = np.zeros(max_slots, np.int32)
        self.steps_run = 0
        self.active_history: list[int] = []
        self.pending: list[Request] = []

    # ---- the model calls --------------------------------------------------------
    @torch.inference_mode()
    def _prefill(self, tokens):
        logits, caches = self.model.prefill({"tokens": tokens})
        return logits[:, -1], caches

    @torch.inference_mode()
    def _decode(self, caches, tokens, positions, active):
        # per-slot positions: each slot decodes at its own point in its
        # sequence (decode_attention takes (B,) positions)
        logits, caches = self.model.decode_step(caches, tokens[:, None],
                                                positions)
        nxt = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
        return torch.where(active, nxt, 0), caches

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a.copy()).to(self.device)

    # ---- slot management ------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Admit a request; queues it if all slots are busy.

        The request is registered in ``self.requests`` immediately: a
        queued request that never gets a slot still appears in
        ``run_until_done``'s results (``finish_reason="unadmitted"``).
        """
        self.requests[req.rid] = req
        if req.max_new_tokens <= 0:
            req._finish("budget")        # zero budget: emit nothing
            return True
        free = np.flatnonzero(~self.active)
        if free.size == 0:
            self.pending.append(req)
            return False
        slot = int(free[0])
        # prefill at batch 1, splice caches into the slot row
        toks = self._to_device(np.asarray(req.prompt, np.int64)[None])
        last_logits, pf_caches = self._prefill(toks)
        with torch.inference_mode():
            for key, pf in pf_caches.items():
                _splice(self.caches[key], pf,
                        0 if key in _UNSTACKED else 1, slot)
        first = int(torch.argmax(last_logits[0]))
        req.out.append(first)
        # the prefill-sampled token spends budget too: a request emits at
        # most max_new_tokens tokens in all
        if first == req.eos_id:
            req._finish("eos")
            return True
        if req.max_new_tokens == 1:
            req._finish("budget")
            return True
        self.active[slot] = True
        self.positions[slot] = len(req.prompt)
        self.budget[slot] = req.max_new_tokens - 1
        self.eos[slot] = req.eos_id
        self.last_token[slot] = first
        self.slot_of[req.rid] = slot
        return True

    def step(self) -> int:
        """One decode step over all slots (flexible width = #active)."""
        while self.pending and not self.active.all():
            self.submit(self.pending.pop(0))
        if not self.active.any():
            return 0
        nxt, self.caches = self._decode(
            self.caches, self._to_device(self.last_token),
            self._to_device(self.positions), self._to_device(self.active))
        nxt = nxt.cpu().numpy()
        self.steps_run += 1
        self.active_history.append(int(self.active.sum()))
        n_active = 0
        for rid, slot in list(self.slot_of.items()):
            if not self.active[slot]:
                continue
            tok = int(nxt[slot])
            req = self.requests[rid]
            req.out.append(tok)
            self.positions[slot] += 1
            self.budget[slot] -= 1
            if tok == self.eos[slot]:
                reason = "eos"
            elif self.budget[slot] <= 0:
                reason = "budget"
            elif self.positions[slot] >= self.capacity - 1:
                reason = "capacity"      # cache rows exhausted: truncated
            else:
                reason = None
            if reason is not None:
                req._finish(reason)
                self.active[slot] = False
                del self.slot_of[rid]
            else:
                self.last_token[slot] = tok
                n_active += 1
        return n_active

    def run_until_done(self, max_steps: int = 10_000):
        """Decode until every request finishes (or ``max_steps`` runs
        out). Returns ``{rid: out_tokens}`` over EVERY submitted request:
        queued requests that never reached a slot are included with
        ``finish_reason="unadmitted"`` (requests still mid-decode when
        the step budget ran out keep ``done=False``)."""
        for _ in range(max_steps):
            self.step()
            if not self.active.any() and not self.pending:
                break
        for req in self.pending:
            if not req.done:
                req._finish("unadmitted")
        return {rid: r.out for rid, r in self.requests.items()}

    def finish_reasons(self) -> dict[int, str | None]:
        """Per-request termination cause (see ``FINISH_REASONS``)."""
        return {rid: r.finish_reason for rid, r in self.requests.items()}
