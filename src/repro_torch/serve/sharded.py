"""Decode (and prefill) on a mesh: one token step with the parameters and
caches placed as DTensors under the sharding rules.

The parameters are gathered into the model; each rank runs the model's
own ``decode_step`` on its rows of the batch (the caches' "model"-axis
shards gathered along that line, their data-axis shards kept) and gives
back the caches placed as they came. The logits are gathered over the
data axes, so every rank returns the whole batch's. The model's own
forward never sees a DTensor: tensor-parallel compute is not ported.
"""
from __future__ import annotations

import torch

from ..launch import shardings as sh


def _rows(dt, batch_axes) -> list:
    """``dt``'s placements with every axis but the batch's replicated: a
    rank's rows, whole along the "model" line."""
    from torch.distributed.tensor import Replicate

    return [pl if name in batch_axes else Replicate()
            for name, pl in zip(dt.device_mesh.mesh_dim_names,
                                dt.placements)]


def _rows_only(dt, batch_axes):
    """This rank's rows of a placed cache (a gather along "model")."""
    return dt.redistribute(dt.device_mesh, _rows(dt, batch_axes)).to_local()


def _placed_like(local, dt, batch_axes):
    """``local`` (this rank's rows, whole along "model") placed as ``dt``
    (a local cut along "model")."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, dt.device_mesh,
                              _rows(dt, batch_axes)).redistribute(
        dt.device_mesh, dt.placements)


def make_sharded_decode_step(model, mesh):
    """Returns step(params, caches, token, pos=None) -> (logits, caches):
    ``params`` the model's parameters placed by ``param_shardings``,
    ``caches`` placed by ``cache_shardings`` (``pos`` kept as it is),
    ``token`` (B, 1) whole on every rank. The logits are (B, 1, V) on
    every rank; the new caches are placed as the given ones, which are
    not written."""
    own = dict(model.named_parameters())

    def step(params, caches, token, pos=None):
        with torch.no_grad():
            for k, p in own.items():
                p.copy_(sh.full(params[k]))
        B = token.shape[0]
        bspec = sh.batch_spec(mesh, B)
        axes = sh.batch_axes(bspec)
        local_caches = sh.tree_map(lambda t: _rows_only(t, axes), caches)
        local_tok = sh.local_slice(token, mesh, bspec)
        if isinstance(pos, torch.Tensor) and pos.ndim == 1:
            pos = sh.local_slice(pos, mesh, bspec)
        with torch.no_grad():
            logits, new = model.decode_step(local_caches, local_tok, pos)
        logits = sh.full(_placed_rows(logits, mesh, bspec))
        placed = sh.tree_map2(lambda t, like: _placed_like(t, like, axes),
                              new, caches)
        return logits, placed

    return step


def make_sharded_prefill_step(model, mesh, last_only: bool = False):
    """Returns step(params, batch) -> logits: ``params`` placed by
    ``param_shardings``, ``batch`` whole on every rank. Each rank gathers
    the parameters into the model and runs its forward (``last_only``: the
    last position's logits only) on its rows of the batch; the logits are
    gathered over the data axes, so every rank returns the whole batch's."""
    own = dict(model.named_parameters())

    def step(params, batch):
        with torch.no_grad():
            for k, p in own.items():
                p.copy_(sh.full(params[k]))
        bspec = sh.batch_spec(mesh, next(iter(batch.values())).shape[0])
        local = {k: sh.local_slice(v, mesh, bspec) for k, v in batch.items()}
        with torch.no_grad():
            logits = model.forward(local, last_only=last_only)
        return sh.full(_placed_rows(logits, mesh, bspec))

    return step


def _placed_rows(local, mesh, bspec):
    """This rank's rows of a tensor whose dim 0 is the batch, as a DTensor
    sharded over the batch's data axes (the rules shard evenly)."""
    from torch.distributed.tensor import DTensor

    spec = sh.P(*bspec, *([None] * (local.ndim - len(bspec))))
    return DTensor.from_local(local, mesh.device_mesh,
                              list(sh.placements(mesh, spec)))
