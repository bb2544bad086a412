"""Training step: loss -> grads -> clip -> AdamW, with
gradient-accumulation microbatching.

The step is eager PyTorch: ``loss.backward()`` where the reference takes
the gradient of its loss function, then clipping and AdamW in place on the model's
own parameters, one leaf at a time. ``RunConfig.remat`` and
``RunConfig.compute_dtype`` are read by nothing in the reference's step,
and by nothing here: there is no activation checkpointing.

Two steps run on a mesh (``launch.mesh``):
  * ``make_sharded_train_step``: the state is stored as DTensors under the
    sharding rules (each rank holds its shards of params, mu and nu); the
    step gathers the parameters into the model, runs its forward and
    backward on the rank's rows of the batch, sums the gradients over the
    data axes, clips, and applies AdamW to the rank's shards. The model's
    own forward never sees a DTensor: tensor-parallel compute is not
    ported (the ranks of a "model" line compute the same thing).
  * ``make_compressed_dp_step``: replicated parameters, the batch sharded
    over "data", gradients all-reduced through the int8 error-feedback
    transform (``optim.compression.compressed_psum``).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from ..configs.base import RunConfig
from ..convert import lm_decay
from ..launch import shardings as sh
from ..models.transformer import AUX_LOSS_WEIGHT
from ..optim import adamw, clip, compression
from ..spans import span


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
    with span("train.forward"):
        loss, metrics = model.loss(batch)
    with span("train.backward"):
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
        with span("train.step"):
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


def _all_sum(t: torch.Tensor, groups) -> torch.Tensor:
    """``t`` summed in place over each group in turn."""
    for g in groups:
        dist.all_reduce(t, group=g)
    return t


def make_sharded_train_step(model, rc: RunConfig, mesh,
                            total_steps: int = 10_000):
    """Returns step_fn(state, batch) -> (state, metrics) for a state placed
    on ``mesh`` (``shardings.place(state, shardings.state_shardings(mesh,
    state, cfg))``); every rank passes the whole batch and the same
    ``state`` structure. ``model`` holds the gathered parameters during a
    step; its own tensors are not the state's.

    The global loss is the mean over every non-ignored label of the global
    batch: each rank weighs its mean cross-entropy by its share of those
    labels (a mean of per-rank means would be wrong where the shares
    differ), so the gradients summed over the data axes are the global
    batch's. A MoE's auxiliary loss is the mean of the ranks' own (their
    load statistics are not combined). On a mesh whose data axes are all
    1 the step is the unsharded step's arithmetic, bit for bit. Whole
    batches only: ``rc.microbatch`` > 1 is not ported to this step."""
    if rc.microbatch and rc.microbatch > 1:
        raise ValueError("the sharded step takes whole batches; "
                         "rc.microbatch > 1 runs only unsharded")
    own = dict(model.named_parameters())
    decay = lm_decay(model.cfg, own)

    def step_fn(state: TrainState, batch):
        with torch.no_grad():
            for k, p in own.items():
                p.copy_(sh.full(state.params[k]))
        bspec = sh.batch_spec(mesh, next(iter(batch.values())).shape[0])
        axes = sh.batch_axes(bspec)
        groups = [mesh.group(a) for a in axes if mesh.shape[a] > 1]
        n_ranks = math.prod(mesh.shape[a] for a in axes)
        local = {k: sh.local_slice(v, mesh, bspec) for k, v in batch.items()}
        count = (local["labels"][:, 1:] != -100).sum().float()
        share = count / _all_sum(count.clone(), groups).clamp_min(1)

        for p in own.values():
            p.grad = None
        _, metrics = model.loss(local)
        ce = metrics["ce"] * share
        aux = AUX_LOSS_WEIGHT * metrics["aux"] / n_ranks
        obj = ce + aux
        obj.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in own.items()}
        for g in grads.values():
            _all_sum(g, groups)
        grads, gnorm = clip.clip_by_global_norm(grads, rc.grad_clip)
        with torch.no_grad():
            mine = {k: sh.shard_of(g, state.params[k])
                    for k, g in grads.items()}
            local_state = adamw.AdamWState(
                step=state.opt.step,
                mu={k: t.to_local() for k, t in state.opt.mu.items()},
                nu={k: t.to_local() for k, t in state.opt.nu.items()})
            _, opt = adamw.apply(
                rc, {k: t.to_local() for k, t in state.params.items()},
                mine, local_state, total_steps, decay=decay)
        del grads, mine
        for p in own.values():
            p.grad = None
        out = TrainState(params=state.params,
                         opt=adamw.AdamWState(step=opt.step,
                                              mu=state.opt.mu,
                                              nu=state.opt.nu),
                         step=state.step + 1, ef=state.ef)
        aux_mean = metrics["aux"]   # 0.0 where the model has none
        if isinstance(aux_mean, torch.Tensor):
            aux_mean = _all_sum(aux_mean.detach().clone(), groups) / n_ranks
        return out, {"loss": _all_sum(obj.detach().clone(), groups),
                     "grad_norm": gnorm,
                     "lr": adamw.schedule(rc, state.step + 1, total_steps),
                     "ce": _all_sum(ce.detach().clone(), groups),
                     "aux": aux_mean}

    return step_fn


def make_compressed_dp_step(model, rc: RunConfig, mesh,
                            total_steps: int = 10_000):
    """Explicit data-parallel step with int8 error-feedback gradient
    all-reduce (the distributed-optimization trick; DP traffic shrinks
    4x). The parameters are replicated: ``state.params`` are each rank's
    model's own, kept equal on every rank by equal updates. The batch
    (every rank passes it whole) is sharded over the "data" axis; the loss
    is the mean of the ranks' losses. EF starts from zeros when the state
    has none, and each rank carries its own residual."""
    group = mesh.group("data")
    n_data = mesh.shape["data"]
    decay = lm_decay(model.cfg, model.named_parameters())
    rows = sh.P("data")

    def step_fn(state: TrainState, batch):
        ef = state.ef if state.ef is not None \
            else compression.init_ef(state.params)
        local = {k: sh.local_slice(v, mesh, rows) for k, v in batch.items()}
        loss, _, grads = _grads(model, state.params, local)
        mean, ef2 = compression.compressed_psum(grads, ef, group, n_data)
        del grads
        mean, gnorm = clip.clip_by_global_norm(mean, rc.grad_clip)
        params, opt = adamw.apply(rc, state.params, mean, state.opt,
                                  total_steps, decay=decay)
        del mean
        for p in params.values():
            p.grad = None
        dist.all_reduce(loss, group=group)
        loss = loss / torch.tensor(float(n_data), device=loss.device)
        return (TrainState(params=params, opt=opt, step=state.step + 1,
                           ef=ef2),
                {"loss": loss, "grad_norm": gnorm})

    return step_fn
