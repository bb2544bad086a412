"""Sharding rules: param/batch/cache partition specs for any mesh, and
their placement as DTensors.

Discipline (DESIGN.md §6):
  * batch dims -> ("pod", "data") (pure DP across pods);
  * 2-D weight matrices -> P(fsdp_axis, "model"): tensor parallel on the
    output features, FSDP (ZeRO-3) on the input features;
  * embeddings -> vocab on "model" (padded % 256), d_model on FSDP axis;
  * MoE experts -> expert dim on "model" (EP), features FSDP;
  * every rule checks divisibility against the actual mesh and falls back
    (drop the FSDP axis first, then TP) — the "resource-ratio-driven
    design" discipline of the paper's §III.E applied to mesh resources:
    never force a shard the substrate can't honor.

A spec is a ``PartitionSpec``: one entry per leading tensor dim, each an
axis name, a tuple of names or None (trailing dims unnamed). The rules
read only ``mesh.shape`` (axis name -> size).

The stacked layer axis. The rules are written for a tree whose blocks are
stacked on a leading layer axis that is never sharded, with leaf paths
such as ``blocks/attn/wq``; the port's layers are tensors of their own
(``blocks.3.attn.wq``). ``param_shardings`` therefore evaluates the rule
on the stacked path and shape that ``convert.lm_reference_leaf`` gives
(the one mapping of names between the two layouts) and drops the leading
layer entry: re-deriving a rule at the per-layer rank would change what
``_matrix_spec`` and the ``ndim <= 1`` branch mean. A rule that put an
axis on the layer entry would lose it here (no per-layer equivalent is
invented); none of the configs' leaves gets one on any mesh tried
(``tests/test_torch_shardings.py``).

Placement. ``placements(mesh, spec)`` turns a spec into DTensor placements
(``Shard(d)``/``Replicate()`` per mesh dim); ``place`` puts a tree on its
mesh with ``distribute_tensor`` (the placed leaves are copies; a meta
tree gives meta DTensors of each rank's shard, as the dry run places its
state);
``local_slice`` cuts the rank's shard out of a full tensor the way
``distribute_tensor`` does, without communication.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
from typing import Any

import torch

from .mesh import data_axes

# leaf-name classification
_EMBED = {"embedding"}
_UNEMBED = {"unembed"}
_SCALARISH = {"scale", "bias", "b_a", "b_i", "lam", "a_log", "d_skip",
              "dt_bias", "conv_b", "bq", "bk", "bv"}
_CONV = {"conv_w"}
_EXPERT_PARENT = "experts"
# attention projections: TP only when the HEAD COUNT divides the model
# axis — a flat-feature shard that cuts inside head_dim puts the scores
# einsum's contraction on a sharded dim and all-reduces S^2 score tiles.
# Head-boundary-aware rules are the beyond-paper default; ``naive_tp=True``
# restores the naive baseline.
_ATTN_Q = {"wq"}
_ATTN_KV = {"wk", "wv"}
# second matmuls: row-parallel (contraction sharded, one activation psum)
# so their input sharding matches the first matmul's output sharding
_ROW_PARALLEL = {"wo", "w_down", "out_proj", "w_out"}


class PartitionSpec(tuple):
    """``P(None, "data", "model")``: a tuple of one entry per tensor dim."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the mesh's ``device_mesh`` places tensors)."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def _axis_ok(mesh, axis: str, dim: int) -> bool:
    return axis in mesh.shape and dim % mesh.shape[axis] == 0


def _fsdp_axis(mesh) -> str | None:
    return "data" if "data" in mesh.shape else None


def _matrix_spec(mesh, shape, prefix_none: int, *, under_experts: bool):
    """2D (d_in, d_out) weight (possibly stacked): TP on d_out, FSDP d_in."""
    d_in, d_out = shape[-2], shape[-1]
    fsdp = _fsdp_axis(mesh)
    tp_out = _axis_ok(mesh, "model", d_out) and not under_experts
    fs_in = fsdp is not None and _axis_ok(mesh, fsdp, d_in)
    spec_in = fsdp if fs_in else None
    spec_out = "model" if tp_out else None
    if not tp_out and fsdp is not None and _axis_ok(mesh, fsdp, d_out):
        # TP impossible: at least FSDP the larger dim
        if not fs_in:
            spec_out = fsdp
    return P(*([None] * prefix_none + [spec_in, spec_out]))


# perf-experiment hooks: leaf-name -> policy ("replicate" | "fsdp_in"),
# set for one cell at a time through ``param_overrides``
PARAM_OVERRIDES: dict[str, str] = {}


@contextlib.contextmanager
def param_overrides(overrides: dict[str, str] | None):
    """``PARAM_OVERRIDES`` updated with ``overrides`` inside the block and
    restored to what it held when the block ends."""
    saved = dict(PARAM_OVERRIDES)
    PARAM_OVERRIDES.update(overrides or {})
    try:
        yield
    finally:
        PARAM_OVERRIDES.clear()
        PARAM_OVERRIDES.update(saved)


def param_spec(mesh, path: str, shape, cfg=None,
               naive_tp: bool = False) -> PartitionSpec:
    """The spec of one parameter leaf of the stacked layout, addressed by
    its ``/``-joined tree path (``blocks/attn/wq``)."""
    parts = path.split("/")
    name = parts[-1]
    ndim = len(shape)
    under_experts = _EXPERT_PARENT in parts
    if name in PARAM_OVERRIDES:
        policy = PARAM_OVERRIDES[name]
        if policy == "replicate":
            return P()
        if policy == "fsdp_in" and ndim >= 2:
            fsdp = _fsdp_axis(mesh)
            ok = fsdp is not None and _axis_ok(mesh, fsdp, shape[-2])
            return P(*([None] * (ndim - 2) + [fsdp if ok else None, None]))
    if not naive_tp and cfg is not None and ndim >= 2 \
            and not under_experts \
            and name in (_ATTN_Q | _ATTN_KV | _ROW_PARALLEL):
        fsdp = _fsdp_axis(mesh)
        m = mesh.shape.get("model", 1)
        heads_ok = {"wq": cfg.n_heads % m == 0,
                    "wk": cfg.n_kv_heads % m == 0,
                    "wv": cfg.n_kv_heads % m == 0,
                    "wo": cfg.n_heads % m == 0,
                    "w_down": shape[-2] % m == 0,
                    "out_proj": shape[-2] % m == 0,
                    "w_out": shape[-2] % m == 0}[name]
        fs_in = fsdp is not None and _axis_ok(mesh, fsdp, shape[-2])
        fs_out = fsdp is not None and _axis_ok(mesh, fsdp, shape[-1])
        prefix = [None] * (ndim - 2)
        if name in _ROW_PARALLEL:
            # contraction sharded; one activation psum per layer
            return P(*(prefix + ["model" if heads_ok
                                 else (fsdp if fs_in else None),
                                 fsdp if (heads_ok and fs_out) else None]))
        return P(*(prefix + [fsdp if fs_in else None,
                             "model" if heads_ok else None]))
    if name in _SCALARISH or ndim <= 1:
        return P()
    if name in _CONV:
        return P()  # (K, C) small depthwise filters: replicate
    if name in _EMBED:
        # (V, D) -> vocab on model, d FSDP
        fsdp = _fsdp_axis(mesh)
        v_ok = _axis_ok(mesh, "model", shape[0])
        d_ok = fsdp is not None and _axis_ok(mesh, fsdp, shape[1])
        return P("model" if v_ok else None, fsdp if d_ok else None)
    if name in _UNEMBED:
        prefix = ndim - 2
        fsdp = _fsdp_axis(mesh)
        d_ok = fsdp is not None and _axis_ok(mesh, fsdp, shape[-2])
        v_ok = _axis_ok(mesh, "model", shape[-1])
        return P(*([None] * prefix
                   + [fsdp if d_ok else None, "model" if v_ok else None]))
    if under_experts and ndim >= 3:
        # (L, E, d_in, d_out) or (E, d_in, d_out): experts on model (EP)
        e_axis = ndim - 3
        e_ok = _axis_ok(mesh, "model", shape[e_axis])
        fsdp = _fsdp_axis(mesh)
        fs_in = fsdp is not None and _axis_ok(mesh, fsdp, shape[-2])
        spec = [None] * ndim
        if e_ok:
            spec[e_axis] = "model"
        if fs_in:
            spec[-2] = fsdp
        return P(*spec)
    if ndim >= 2:
        return _matrix_spec(mesh, shape, ndim - 2,
                            under_experts=under_experts)
    return P()


def fleet_spec(ndim: int = 1) -> PartitionSpec:
    """Spec of fleet-stacked device state (``core.fleet``): the leading
    axis is one simulated eGPU per mesh rank, everything under it (blocks,
    threads, registers, memory words) stays local."""
    if ndim < 1:
        raise ValueError(f"ndim={ndim} must be >= 1")
    return P(*(["fleet"] + [None] * (ndim - 1)))


def fleet_shardings(mesh, state_like) -> Any:
    """A ``NamedSharding`` per tensor of ``state_like`` (each leaf with a
    leading ``(n_devices, ...)`` fleet axis) putting that axis on
    ``"fleet"``."""
    return tree_map(lambda t: NamedSharding(mesh, fleet_spec(max(1, t.ndim))),
                    state_like)


def param_shardings(mesh, params_like: dict, cfg=None,
                    naive_tp: bool = False) -> dict:
    """A ``NamedSharding`` per parameter of the port's model of ``cfg``
    (name -> tensor): the rule on the stacked path and shape, its layer
    entry dropped (module docstring). Without ``cfg`` the names are taken
    as paths of their own (a plain dict of tensors)."""
    from ..convert import lm_reference_leaf

    out = {}
    for name, t in params_like.items():
        if cfg is None:
            path, shape, stacked = name.replace(".", "/"), tuple(t.shape), \
                False
        else:
            path, shape, stacked = lm_reference_leaf(cfg, name, t.shape)
        spec = param_spec(mesh, path, shape, cfg=cfg, naive_tp=naive_tp)
        out[name] = NamedSharding(mesh, P(*spec[1:]) if stacked else spec)
    return out


def batch_spec(mesh, batch_size: int) -> PartitionSpec:
    """Shard a leading batch dim over as many data axes as divide it."""
    use: list[str] = []
    div = 1
    for a in data_axes(mesh):
        if batch_size % (div * mesh.shape[a]) == 0:
            use.append(a)
            div *= mesh.shape[a]
    if not use:
        return P()
    return P(tuple(use) if len(use) > 1 else use[0])


def batch_shardings(mesh, batch_like: dict) -> dict:
    def one(t):
        if t.ndim == 0:
            return NamedSharding(mesh, P())
        bs = batch_spec(mesh, t.shape[0])
        return NamedSharding(mesh, P(*(list(bs)
                                       + [None] * (t.ndim - len(bs)))))
    return tree_map(one, batch_like)


def cache_spec(mesh, shape, batch_size: int,
               features: bool = True) -> PartitionSpec:
    """Spec for one decode-cache leaf: batch axis (exact size match in the
    first two axes — layer-stacked entries are (L, B, ...), plain ones
    (B, ...)) shards over the data axes. KV/state caches additionally shard
    a feature axis on "model": a 32k-context KV cache is hundreds of GB and
    MUST split beyond batch (heads if divisible, else the capacity axis)."""
    ndim = len(shape)
    spec: list = [None] * ndim
    bs = batch_spec(mesh, batch_size)
    batch_ax = None
    if ndim and len(bs):
        for ax in range(min(2, ndim)):
            if shape[ax] == batch_size:
                spec[ax] = bs[0] if len(bs) == 1 else tuple(bs)
                batch_ax = ax
                break
    if features and ndim >= 3 and "model" in mesh.shape:
        m = mesh.shape["model"]
        # candidate feature axes, preferred order: heads (-2), then
        # capacity/state (-3), then trailing feature (-1)
        for ax in (ndim - 2, ndim - 3, ndim - 1):
            if ax <= (batch_ax if batch_ax is not None else 0):
                continue
            if spec[ax] is None and shape[ax] % m == 0 and shape[ax] >= m:
                spec[ax] = "model"
                break
    return P(*spec)


def cache_shardings(mesh, cache_like, batch_size: int,
                    features: bool = True) -> Any:
    """A ``NamedSharding`` per tensor of the caches (``pos``, an int, is
    left as it is)."""
    return tree_map(lambda t: NamedSharding(
        mesh, cache_spec(mesh, t.shape, batch_size, features)), cache_like)


def state_shardings(mesh, state_like, cfg=None, naive_tp: bool = False):
    """TrainState: params/mu/nu (and the EF residual) share param specs;
    the counters stay on the host (None: not placed)."""
    from ..optim.adamw import AdamWState
    from ..train.step import TrainState

    def specs(tree):
        return param_shardings(mesh, tree, cfg, naive_tp)

    return TrainState(
        params=specs(state_like.params),
        opt=AdamWState(step=None, mu=specs(state_like.opt.mu),
                       nu=specs(state_like.opt.nu)),
        step=None,
        ef=None if state_like.ef is None else
        state_like.ef._replace(error=specs(state_like.ef.error)))


# ---------------------------------------------------------------------------
# placement as DTensors
# ---------------------------------------------------------------------------

def tree_map(fn, tree):
    """``tree`` with ``fn`` applied to each tensor leaf; dicts, lists,
    tuples and named tuples are walked, None and other leaves (a cache's
    ``pos``) kept."""
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def tree_map2(fn, tree, other):
    """``fn(leaf, other_leaf)`` over the tensor leaves of ``tree`` and the
    matching leaves of ``other`` (a tree of the same structure)."""
    if isinstance(tree, dict):
        return type(tree)((k, tree_map2(fn, v, other[k]))
                          for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map2(fn, v, o) for v, o in zip(tree, other)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map2(fn, v, o) for v, o in zip(tree, other))
    return fn(tree, other) if isinstance(tree, torch.Tensor) else tree


def placements(mesh, spec) -> tuple:
    """DTensor placements of ``spec``: per mesh dim, ``Shard(d)`` for the
    tensor dim ``d`` whose entry names that axis, else ``Replicate()``.
    Two axes on one dim (``("pod", "data")``) shard it in mesh order, as
    the spec's order has it."""
    from torch.distributed.tensor import Replicate, Shard

    where = {}
    for d, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                where[axis] = d
    unknown = set(where) - set(mesh.shape)
    if unknown:
        raise ValueError(f"spec {spec} names axes {sorted(unknown)} that "
                         f"the mesh {mesh.shape} lacks")
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in mesh.shape)


def place_tensor(t: torch.Tensor, sharding: NamedSharding):
    """A copy of ``t`` as a DTensor on ``sharding``'s mesh (every rank
    passes the same full ``t``). A meta ``t`` gives a meta DTensor whose
    local tensor has the shape of the rank's shard (no communication)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    dm = sharding.mesh.device_mesh
    pls = list(sharding.placements)
    if t.is_meta:
        local = _cut(t, dm, pls)
        return DTensor.from_local(
            torch.empty(local.shape, dtype=t.dtype, device="meta"), dm, pls,
            run_check=False, shape=t.shape, stride=t.stride())
    return distribute_tensor(t.detach().to(dm.device_type).clone(), dm, pls)


def place(tree, shardings):
    """``tree`` with each tensor that ``shardings`` (a tree of the same
    structure) gives a ``NamedSharding`` placed on it; a None there keeps
    its leaf as it is."""
    return tree_map2(lambda t, s: t if s is None else place_tensor(t, s),
                     tree, shardings)


def batch_axes(bspec) -> tuple[str, ...]:
    """The mesh axes a batch spec (``batch_spec``'s) shards dim 0 over."""
    if not bspec:
        return ()
    return bspec[0] if isinstance(bspec[0], tuple) else (bspec[0],)


def _cut(t: torch.Tensor, device_mesh, pls) -> torch.Tensor:
    from torch.distributed.tensor import Shard

    for i, pl in enumerate(pls):
        if isinstance(pl, Shard):
            t = t.chunk(device_mesh.size(i), dim=pl.dim)[
                device_mesh.get_local_rank(i)]
    return t


def local_slice(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's shard of the full tensor ``t`` under ``spec`` (a view):
    per mesh dim in order, the rank's chunk of the dim it shards, as
    ``distribute_tensor`` cuts it."""
    return _cut(t, mesh.device_mesh, placements(mesh, spec))


def shard_of(t: torch.Tensor, like) -> torch.Tensor:
    """This rank's shard of the full tensor ``t``, cut as the DTensor
    ``like`` is placed (a view)."""
    return _cut(t, like.device_mesh, like.placements)


def full(t):
    """The global tensor of a DTensor (gathered on every rank: a
    collective); any other leaf as it is. (No DTensor exists before its
    module is imported, which takes a second: it is not imported here.)"""
    dtensor = sys.modules.get("torch.distributed.tensor")
    if dtensor is not None and isinstance(t, dtensor.DTensor):
        return t.full_tensor()
    return t
