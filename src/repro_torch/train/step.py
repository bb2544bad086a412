"""Training step: loss -> grads -> clip -> AdamW, with
gradient-accumulation microbatching.

The step is eager PyTorch: ``loss.backward()`` where the reference takes
the gradient of its loss function, then clipping and AdamW in place on the model's
own parameters, one leaf at a time. ``RunConfig.remat`` and
``RunConfig.compute_dtype`` are read by nothing in the reference's step,
and by nothing here: there is no activation checkpointing. The
data-parallel step with compressed gradients waits for the port's mesh
layer.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..configs.base import RunConfig
from ..convert import lm_decay
from ..optim import adamw, clip


class TrainState(NamedTuple):
    params: Any               # the model's parameters: name -> nn.Parameter
    opt: adamw.AdamWState
    step: torch.Tensor        # 0-d int32 on the host
    ef: Any = None            # error-feedback state (compression)


def init_state(model, rc: RunConfig) -> TrainState:
    """The state of a run that starts from the weights ``model`` holds
    (``build_model(cfg, seed=rc.seed)`` makes a run a function of its
    ``RunConfig``, as the reference's ``init_state`` does)."""
    params = dict(model.named_parameters())
    return TrainState(params=params, opt=adamw.init(params),
                      step=torch.zeros((), dtype=torch.int32))


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    """``n`` batches of ``B // n`` rows each, split along axis 0."""
    return [{k: x.reshape(n, x.shape[0] // n, *x.shape[1:])[i]
             for k, x in batch.items()} for i in range(n)]


def _detached(metrics: dict) -> dict:
    return {k: v.detach() if isinstance(v, torch.Tensor) else v
            for k, v in metrics.items()}


def _grads(model, params: dict, batch: dict):
    """(loss, metrics, grads) of one batch; the grads are the parameters'
    ``.grad`` (zeros for a parameter the loss does not reach, as the
    reference's gradient of it is)."""
    for p in params.values():
        p.grad = None
    loss, metrics = model.loss(batch)
    loss.backward()
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in params.items()}
    return loss.detach(), _detached(metrics), grads


def _div_(xs, n: int) -> None:
    """Divide each tensor of ``xs`` (all on one device) by ``n`` in place,
    by a 0-d tensor there: the card would multiply by a scalar's
    reciprocal."""
    divisor = torch.tensor(float(n), device=xs[0].device)
    for x in xs:
        x.div_(divisor)


def make_train_step(model, rc: RunConfig, total_steps: int = 10_000):
    """Returns step_fn(state, batch) -> (state, metrics). ``state.params``
    must be ``model``'s parameters: the step updates them in place."""
    decay = lm_decay(model.cfg, model.named_parameters())

    def compute_grads(params, batch):
        n = rc.microbatch
        if not (n and n > 1):
            return _grads(model, params, batch)
        # accumulate in f32 in microbatch order, then divide by n; the loss
        # is the mean, the other metrics the last microbatch's
        acc, loss_sum = None, 0.0
        for micro in _split_microbatches(batch, n):
            loss, metrics, grads = _grads(model, params, micro)
            if acc is None:
                acc = {k: g.float() for k, g in grads.items()}
            else:
                for k, g in grads.items():
                    acc[k].add_(g.float())
            loss_sum = loss_sum + loss
        for p in params.values():
            p.grad = None
        _div_([loss_sum, *acc.values()], n)
        return loss_sum, metrics, acc

    def step_fn(state: TrainState, batch):
        loss, metrics, grads = compute_grads(state.params, batch)
        grads, gnorm = clip.clip_by_global_norm(grads, rc.grad_clip)
        params, opt = adamw.apply(rc, state.params, grads, state.opt,
                                  total_steps, decay=decay)
        del grads
        for p in params.values():
            p.grad = None
        out = TrainState(params=params, opt=opt, step=state.step + 1,
                         ef=state.ef)
        m = {"loss": loss, "grad_norm": gnorm,
             "lr": adamw.schedule(rc, state.step + 1, total_steps)}
        m.update(metrics)
        return out, m

    return step_fn
