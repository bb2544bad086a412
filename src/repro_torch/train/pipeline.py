"""Pipeline parallelism: GPipe-style microbatch schedule over a "stage"
mesh axis, one stage a rank, activations passed down the ring with
point-to-point sends.

Schedule: M microbatches through S stages takes M + S - 1 ticks. Each tick
every stage runs its layer block on the activation it received, then
passes the result downstream (``ppermute``). Autograd differentiates
straight through: the backward of a pass downstream is the reverse pass
upstream, giving GPipe-style full-activation backward without bespoke
adjoint plumbing.

Every rank builds the same graph (stage 0's input is a ``where`` between
the microbatch and the received activation, the last stage's outputs are
masked and summed over the ring), so each rank's backward reaches the
same point-to-point passes in the same order and the sends and receives
pair up.

The stage function is built from the SAME per-layer block functions as
the sequential model: ``stack_stages`` stacks n_layers/S layers per
stage, so the pipeline's output equals ``sequential_apply``'s.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def stack_stages(layer_params: dict, n_stages: int) -> dict:
    """(L, ...) stacked layer params -> (S, L/S, ...) stage-major stacking."""
    def resh(x):
        L = x.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers do not split into {n_stages} "
                             "stages")
        return x.reshape(n_stages, L // n_stages, *x.shape[1:])
    return {k: resh(x) for k, x in layer_params.items()}


def _stage(stage_params: dict, s: int) -> dict:
    return {k: p[s] for k, p in stage_params.items()}


def _pass(x: torch.Tensor, group, n: int, shift: int) -> torch.Tensor:
    """``x`` sent ``shift`` ranks on along the ring of ``group``; what the
    rank ``shift`` behind sent is returned."""
    if n == 1:
        return x.clone()
    me = dist.get_rank(group)
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(),
                      dist.get_global_rank(group, (me + shift) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (me - shift) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _PPermute(torch.autograd.Function):
    """Stage i -> i + 1 (mod S); its backward is the reverse pass."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _pass(x, group, n, 1)

    @staticmethod
    def backward(ctx, g):
        return _pass(g, ctx.group, ctx.n, -1), None, None


class _SumToAll(torch.autograd.Function):
    """The sum over the ring, on every rank. The output is replicated and
    each rank's loss of it is the same loss, counted once: the gradient
    reaches each rank's term as it is."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def pipeline_apply(mesh, stage_fn: Callable, stage_params: dict,
                   x_mb: torch.Tensor, axis: str = "stage") -> torch.Tensor:
    """Run the pipeline. x_mb: (M, mb, ...) microbatched input (every rank
    passes it whole, as it does ``stage_params``, the stage-major stacked
    tree of ``stack_stages``: a rank reads its own stage's slice).

    stage_fn(params_for_stage, x) -> y, applied by every stage each tick.
    Returns (M, mb, ...) outputs (as produced by the LAST stage), on every
    rank.
    """
    n = mesh.shape[axis]
    group = mesh.group(axis)
    s = mesh.coordinate(axis)
    params = _stage(stage_params, s)
    M = x_mb.shape[0]
    ticks = M + n - 1
    first = torch.tensor(s == 0, device=x_mb.device)
    buf = torch.zeros_like(x_mb[0])      # activation arriving from upstream
    emitted = []
    for t in range(ticks):
        # stage 0 injects microbatch t (while available); others use buf
        inj = x_mb[t] if t < M else torch.zeros_like(buf)
        y = stage_fn(params, torch.where(first, inj, buf))
        # the last stage emits microbatch t - (S-1)
        if t >= n - 1:
            emitted.append(y)
        if t < ticks - 1:
            buf = _PPermute.apply(y, group, n)
    # only the last stage's outputs are real; the one-hot sum broadcasts
    # them to all stages
    sel = float(s == n - 1)
    return _SumToAll.apply(torch.stack(emitted) * sel, group)


def sequential_apply(stage_fn: Callable, stage_params: dict,
                     x_mb: torch.Tensor) -> torch.Tensor:
    """The same stages run one after another on one rank over all the
    microbatches at once: what ``pipeline_apply`` must equal."""
    S = next(iter(stage_params.values())).shape[0]
    M, mb = x_mb.shape[:2]
    h = x_mb.reshape(M * mb, *x_mb.shape[2:])
    for s in range(S):
        h = stage_fn(_stage(stage_params, s), h)
    return h.reshape(M, mb, *h.shape[1:])


def make_pp_loss(mesh, stage_fn, embed_fn, head_fn, n_stages: int):
    """Compose embed -> pipelined stages -> head into a loss whose
    ``backward`` is GPipe's (it falls out of autograd)."""

    def loss_fn(params, batch, labels_fn):
        stage_params, other = params
        x = embed_fn(other, batch)
        y = pipeline_apply(mesh, stage_fn, stage_params, x)
        return head_fn(other, y, batch, labels_fn)

    return loss_fn
