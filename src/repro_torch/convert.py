"""State carry-across between the JAX reference and the port.

The reference keeps architectural words as ``uint32`` and the per-SM
out-of-range flags as ``bool``; the port keeps words as ``torch.int32``
(the same bits) on the device of its backend. Program words are plain
``int64`` numpy arrays in both packages and cross over unchanged.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.device import DeviceState, LaunchResult
from .core.machine import MachineState

# the sequencer fields and counters of a MachineState, host values on both
# sides
_SEQ_FIELDS = ("pc", "ret_stack", "ret_sp", "loop_ctr", "loop_sp", "halted",
               "steps", "cycles", "cycles_by_class")


def _words(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a), dtype=np.uint32)
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().view(np.uint32)


def state_from_numpy(regs, shmem, gmem, oob,
                     device: torch.device | str = "cpu") -> DeviceState:
    """A port ``DeviceState`` from uint32 ``regs`` (n, 512, 16), ``shmem``
    (n, depth), ``gmem`` (gdepth,) and bool ``oob`` (n,)."""
    return DeviceState(
        regs=_words(regs, device), shmem=_words(shmem, device),
        gmem=_words(gmem, device),
        oob=torch.from_numpy(np.asarray(oob, bool).copy()).to(device))


def state_to_numpy(state: DeviceState) -> dict[str, np.ndarray]:
    """The data state of a port ``DeviceState`` as uint32/bool arrays."""
    return {"regs": _u32(state.regs), "shmem": _u32(state.shmem),
            "gmem": _u32(state.gmem),
            "oob": state.oob.detach().cpu().numpy().astype(bool)}


def launch_result_to_numpy(res: LaunchResult) -> dict[str, np.ndarray]:
    """A port ``LaunchResult``'s architectural state as uint32/bool arrays,
    comparable with ``==`` to ``np.asarray`` of the reference's fields."""
    return {"regs": _u32(res.regs), "shmem": _u32(res.shmem),
            "gmem": _u32(res.gmem),
            "oob": res.oob.detach().cpu().numpy().astype(bool)}


def machine_state_from_numpy(fields, device: torch.device | str = "cpu"
                             ) -> MachineState:
    """A port ``MachineState`` from a mapping of numpy views of a
    reference ``MachineState``'s fields (uint32 ``regs``/``shmem``, bool
    ``oob``, integer sequencer fields and counters)."""
    f = {k: np.asarray(fields[k]) for k in ("regs", "shmem", "oob")
         + _SEQ_FIELDS}
    scalar = lambda k: f[k].item()  # noqa: E731
    return MachineState(
        regs=_words(f["regs"], device), shmem=_words(f["shmem"], device),
        oob=torch.from_numpy(f["oob"].astype(bool).copy()).to(device),
        pc=int(scalar("pc")), ret_stack=f["ret_stack"].astype(np.int64),
        ret_sp=int(scalar("ret_sp")),
        loop_ctr=f["loop_ctr"].astype(np.int64),
        loop_sp=int(scalar("loop_sp")), halted=bool(scalar("halted")),
        steps=int(scalar("steps")), cycles=int(scalar("cycles")),
        cycles_by_class=f["cycles_by_class"].astype(np.int64))


def machine_state_to_numpy(state: MachineState) -> dict[str, np.ndarray]:
    """A port ``MachineState`` as numpy arrays: uint32 words, bool ``oob``
    and int64 sequencer fields and counters, comparable with ``==`` to
    ``np.asarray`` of the reference's fields."""
    out = {"regs": _u32(state.regs), "shmem": _u32(state.shmem),
           "oob": state.oob.detach().cpu().numpy().astype(bool)}
    for k in _SEQ_FIELDS:
        out[k] = np.asarray(getattr(state, k)).astype(
            bool if k == "halted" else np.int64)
    return out


# ---------------------------------------------------------------------------
# the LM stack: parameter trees and decode caches
# ---------------------------------------------------------------------------

def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)


def _leaves(tree, prefix: str):
    """(dotted name, array) over a nested dict/list of arrays."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _leaves(v, f"{prefix}.{k}" if prefix else str(k))


def _lm_lists(cfg) -> list[tuple[str, str, list[int], bool]]:
    """Where the port's per-layer ``ModuleList`` entries of ``cfg`` sit in
    the reference's parameter tree: (the dotted path of a group of layers
    there, the port's ``ModuleList``, its layers in the group's order,
    whether the reference's vmapped init stacks the group on a leading
    layer axis). Every other parameter has the same dotted name in both:
    deepseek's ``block0``, the embeddings, the final norms, ``img_proj``.
    This is the one mapping of names between the two trees."""
    if cfg.family == "audio":
        return [("enc_blocks", "enc_blocks", list(range(cfg.encoder_layers)),
                 True),
                ("dec_blocks", "dec_blocks", list(range(cfg.n_layers)), True)]
    if cfg.family == "hybrid":
        n_pat = len(cfg.block_pattern)
        n_grouped = cfg.n_layers // n_pat * n_pat
        return [(f"groups.{i}_{kind}", "blocks",
                 list(range(i, n_grouped, n_pat)), True)
                for i, kind in enumerate(cfg.block_pattern)] + [
                (f"tail.{j}", "blocks", [n_grouped + j], False)
                for j in range(cfg.n_layers - n_grouped)]
    return [("blocks", "blocks",
             list(range(cfg.n_layers - int(cfg.first_layer_dense))), True)]


def _reference_group(cfg, name: str) -> tuple[str, int | None, int]:
    """A port parameter's dotted path in the reference's tree, its index
    on the stacked layer axis there (None: not stacked) and the number of
    layers stacked on that axis (1 where none are)."""
    for path, mod, layers, stacked in _lm_lists(cfg):
        for i, layer in enumerate(layers):
            head = f"{mod}.{layer}."
            if name.startswith(head):
                return (f"{path}.{name[len(head):]}", i if stacked else None,
                        len(layers) if stacked else 1)
    return name, None, 1


def _reference_place(cfg, name: str) -> tuple[str, int | None]:
    """A port parameter's dotted path in the reference's tree, and its
    index on the stacked layer axis there (None: not stacked)."""
    return _reference_group(cfg, name)[:2]


def lm_reference_leaf(cfg, name: str, shape) -> tuple[str, tuple, bool]:
    """Where the port's parameter ``name`` of ``shape`` sits in the
    reference's tree, as its tree paths name leaves: the ``/``-joined
    path (a list item as ``[i]``: the hybrid's tail), the shape of the leaf
    there (the group's layer count in front where the group is stacked)
    and whether it is stacked."""
    dotted, index, n = _reference_group(cfg, name)
    parts = dotted.split(".")
    if parts[0] == "tail" and cfg.family == "hybrid":
        parts[1] = f"[{parts[1]}]"
    stacked = index is not None
    return "/".join(parts), (n, *shape) if stacked else tuple(shape), stacked


def lm_params_from_numpy(cfg, tree, device: torch.device | str = "cpu"
                         ) -> dict[str, torch.Tensor]:
    """The reference's parameter tree for ``cfg`` (numpy arrays, blocks
    stacked on a leading layer axis as its vmapped init makes them) as a
    ``state_dict`` of the port's ``LM``/``EncDec`` on ``device``: a copy,
    leaf for leaf (the weights keep their ``(d_in, d_out)`` layout)."""
    flat = dict(_leaves(tree, ""))
    named = {}
    for path, mod, layers, stacked in _lm_lists(cfg):
        for key in [k for k in flat if k.startswith(path + ".")]:
            a = np.asarray(flat.pop(key))
            rest = key[len(path) + 1:]
            for i, layer in enumerate(layers):
                named[f"{mod}.{layer}.{rest}"] = a[i] if stacked else a
    named.update(flat)
    return {name: _tensor(a, device) for name, a in named.items()}


def lm_params_to_numpy(cfg, state_dict) -> dict:
    """The inverse of ``lm_params_from_numpy``: the port's parameters of
    ``cfg`` (name -> tensor) as the reference's nested tree of numpy
    arrays, the stacked groups restacked on their layer axis and the
    hybrid's tail a list."""
    parts: dict[str, dict] = {}
    for name, t in state_dict.items():
        path, i = _reference_place(cfg, name)
        parts.setdefault(path, {})[i] = t.detach().cpu().numpy()
    tree: dict = {}
    for path, by_index in parts.items():
        a = by_index[None] if None in by_index else np.stack(
            [by_index[i] for i in range(len(by_index))])
        *head, last = path.split(".")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = a
    if cfg.family == "hybrid":
        tail = tree.get("tail", {})
        tree["tail"] = [tail[str(j)] for j in range(len(tail))]
    return tree


def lm_decay(cfg, params) -> dict[str, bool]:
    """Which of the port's parameters of ``cfg`` (name -> tensor) AdamW
    decays: the reference decays a leaf of rank 2 or more of its own tree,
    where a layer of a stacked group has one axis more than here (so its
    norm scales, biases, ``conv_b``, ``A_log``, ``D`` and ``dt_bias`` are
    decayed there, and so here)."""
    return {name: p.ndim + (_reference_place(cfg, name)[1] is not None) >= 2
            for name, p in dict(params).items()}


def lm_caches_from_numpy(tree, device: torch.device | str = "cpu"):
    """The reference's decode caches (numpy leaves, its nesting and keys,
    its named ``(k, v)`` tuples) as the port's: tensors on ``device``,
    ``pos`` as an int (or a tensor if it is a vector)."""
    from .models.attention import KVCache

    if isinstance(tree, dict):
        return {k: lm_caches_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [lm_caches_from_numpy(v, device) for v in tree]
    if isinstance(tree, tuple):
        xs = [lm_caches_from_numpy(v, device) for v in tree]
        return KVCache(*xs) if getattr(tree, "_fields", None) == ("k", "v") \
            else tuple(xs)
    a = np.asarray(tree)
    return int(a) if a.ndim == 0 else _tensor(a, device)


def lm_caches_to_numpy(caches):
    """The port's decode caches with numpy leaves, the nesting, keys and
    ``(k, v)`` tuples kept; ``pos`` as int32."""
    if isinstance(caches, dict):
        return {k: lm_caches_to_numpy(v) for k, v in caches.items()}
    if isinstance(caches, list):
        return [lm_caches_to_numpy(v) for v in caches]
    if isinstance(caches, tuple):
        xs = [lm_caches_to_numpy(v) for v in caches]
        return type(caches)(*xs) if hasattr(caches, "_fields") else tuple(xs)
    if isinstance(caches, torch.Tensor):
        return caches.detach().cpu().numpy()
    return np.int32(caches)
