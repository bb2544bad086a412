"""Multi-pod dry run of the port's own steps, counted on meta tensors.

    python -m repro_torch.launch.dryrun [--arch all] [--shape all] \\
        [--mesh sp|mp|both] [--out build/dryrun/dryrun.jsonl] [--force] \\
        [--policy baseline|optimized]

For every (architecture x input-shape x mesh) cell:
  * start a world of fake ranks (``torch.distributed``'s ``"fake"``
    backend: 256 for ``16x16``, 512 for ``2x16x16``; this process is rank
    0 and no collective moves data);
  * build the model on the meta device (shapes and dtypes, nothing
    allocated) and place its state as meta DTensors of rank 0's shards
    under the sharding rules (``shardings.place``);
  * build the port's own step: ``train.make_sharded_train_step`` for
    train shapes, ``serve.sharded.make_sharded_prefill_step`` for
    prefill, ``serve.sharded.make_sharded_decode_step`` for decode;
  * run it once under three counters and a tracker of live storage
    (``cell_costs``): its FLOPs, the bytes its ops move, its collective
    bytes and its peak bytes, all per device.

The counts are the port's, not the reference's: there XLA's GSPMD shards
the compute of each product, while the port's steps gather every
parameter whole and compute the whole model on every rank of a "model"
line. A step runs every layer, so no depth differencing is needed:
``*_scaled`` equals the count (``layer_variants`` stays, to show the count
is linear in depth).

Results stream to a JSONL file (resumable: done cells are skipped), in
the reference's row schema; each counted cell's collective calls and
bytes by op go to stdout, on a ``collectives:`` line of JSON.
Importing this module sets no environment variable and starts no process
group; each cell starts its fake world and destroys it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses as dc
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from ..configs import ARCHS, SHAPES, RunConfig, get_arch, shape_applicable
from ..configs.base import ShapeConfig
from ..models import build_model, input_specs
from ..models.layers import _freqs
from ..roofline.analysis import collective_bytes, roofline_row
from . import shardings as sh
from .mesh import make_production_mesh

COMPUTE_DTYPE = torch.bfloat16


def layer_variants(cfg):
    """Two reduced-depth clones (a, b) + the unit count n such that
    cost(full) = cost(a) + (n - units(a)) * (cost(b) - cost(a)) / (units(b)
    - units(a)). The port counts every layer of the full depth, so the dry
    run needs no differencing; the tests use these depths to show that
    its count is linear in depth."""
    # depths (2, 4) rather than (1, 2), as the reference has them
    if cfg.family == "hybrid":
        g = len(cfg.block_pattern)
        n_groups, rem = divmod(cfg.n_layers, g)
        a = dc.replace(cfg, n_layers=2 * g + rem, scan_unroll=True)
        b = dc.replace(cfg, n_layers=4 * g + rem, scan_unroll=True)
        return a, 2, b, 4, n_groups
    if cfg.family == "audio":
        a = dc.replace(cfg, n_layers=2, encoder_layers=2, scan_unroll=True)
        b = dc.replace(cfg, n_layers=4, encoder_layers=4, scan_unroll=True)
        return a, 2, b, 4, cfg.n_layers          # enc/dec scale together
    extra = int(cfg.first_layer_dense)
    a = dc.replace(cfg, n_layers=2 + extra, scan_unroll=True)
    b = dc.replace(cfg, n_layers=4 + extra, scan_unroll=True)
    return a, 2, b, 4, cfg.n_layers - extra


OPTIMIZED_QPAD = {"qwen2.5-32b": 48}   # zero-padded q heads (numerics-exact)


def apply_policy(cfg, shape, policy: str):
    """'baseline' = paper-faithful naive rules; 'optimized' = the §Perf
    winners applied globally (head-aware TP, blocked attention, serving
    prefill last-token logits, SSM in_proj FSDP-only)."""
    if policy != "optimized":
        return cfg, dict(naive_tp=True, last_only=False)
    # per-cell autotuning: cells where the global recipe measured worse
    # than baseline revert to baseline; the optimized recipe applies to
    # inference kinds only
    BASELINE_CELLS = {
        ("whisper-tiny", "prefill_32k"), ("whisper-tiny", "decode_32k"),
        ("recurrentgemma-2b", "long_500k"),
        ("mamba2-780m", "long_500k"),
    }
    if shape.kind == "train" or (cfg.name, shape.name) in BASELINE_CELLS:
        return cfg, dict(naive_tp=True, last_only=False)
    patch = {}
    if cfg.family != "ssm" and shape.seq_len >= 4096 \
            and shape.kind in ("train", "prefill"):
        patch["attn_q_chunk"] = 2048
    if cfg.name in OPTIMIZED_QPAD:
        patch["n_heads"] = OPTIMIZED_QPAD[cfg.name]
    if patch:
        cfg = dc.replace(cfg, **patch)
    opts = dict(naive_tp=False, last_only=(shape.kind == "prefill"))
    if cfg.family == "ssm":
        opts["overrides"] = {"in_proj": "fsdp_in"}
    if cfg.name == "qwen1.5-32b" and shape.kind == "decode":
        # MHA (kv=40) 32k cache: fp8 storage halves it (scores/softmax
        # stay f32 — reads upcast)
        opts["cache_dtype"] = torch.float8_e4m3fn
    return cfg, opts


# ---------------------------------------------------------------------------
# a world of fake ranks
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(n: int):
    """A process group of ``n`` fake ranks, this process rank 0, for the
    block (no world may exist already); destroyed when the block ends."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group exists already; the dry run "
                           "starts its own world of fake ranks")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

class Cell(NamedTuple):
    cfg: Any
    shape: ShapeConfig
    mesh: Any
    step: Callable
    args: tuple
    model: Any            # holds the gathered parameters during a step


def build_cell(arch_name: str, shape_name, multi_pod: bool, *, cfg=None,
               mesh=None, policy: str = "baseline", opts: dict | None = None,
               dtype: torch.dtype = COMPUTE_DTYPE,
               device: str = "meta") -> Cell:
    """The cell's step and its arguments, placed on meta tensors.

    ``shape_name`` names a ``SHAPES`` entry or is a ``ShapeConfig``;
    ``opts`` (``naive_tp``, ``last_only``, ``overrides``, ``cache_dtype``,
    ``cache_features``) replaces what ``policy`` gives; ``mesh`` is the
    production mesh of the running world unless given. The sharding
    overrides hold only while the state is placed. ``device="cpu"``
    builds the same cell on host tensors (random weights, zero inputs),
    to hold the meta counts to a real run."""
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    cfg, policy_opts = apply_policy(cfg or get_arch(arch_name), shape,
                                    policy)
    opts = policy_opts if opts is None else opts
    naive_tp = opts.get("naive_tp", True)
    mesh = mesh or make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
    model = build_model(cfg, device=device, dtype=dtype)
    params = {k: p.detach() for k, p in model.named_parameters()}
    batch = {k: torch.zeros(t.shape, dtype=t.dtype, device=device)
             for k, t in input_specs(cfg, shape, dtype).items()}

    with sh.param_overrides(opts.get("overrides")):
        if shape.kind == "train":
            from ..train.step import init_state, make_sharded_train_step

            rc = RunConfig()
            state = init_state(model, rc)
            state = sh.place(state, sh.state_shardings(mesh, state, cfg,
                                                       naive_tp))
            step = make_sharded_train_step(model, rc, mesh)
            args = (state, batch)
        elif shape.kind == "prefill":
            from ..serve.sharded import make_sharded_prefill_step

            placed = sh.place(params, sh.param_shardings(mesh, params, cfg,
                                                         naive_tp))
            step = make_sharded_prefill_step(
                model, mesh, last_only=opts.get("last_only", False))
            args = (placed, batch)
        else:  # decode
            from ..serve.sharded import make_sharded_decode_step

            placed = sh.place(params, sh.param_shardings(mesh, params, cfg,
                                                         naive_tp))
            caches = model.init_decode_caches(
                shape.global_batch, shape.seq_len,
                opts.get("cache_dtype", dtype))
            caches = sh.place(caches, sh.cache_shardings(
                mesh, caches, shape.global_batch,
                features=opts.get("cache_features", True)))
            decode = make_sharded_decode_step(model, mesh)

            def step(params, caches, batch):
                return decode(params, caches, batch["tokens"])

            args = (placed, caches, batch)
    return Cell(cfg, shape, mesh, step, args, model)


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

def _local_tensors(tree) -> list:
    return [t.to_local() if hasattr(t, "to_local") else t
            for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def local_bytes(tree) -> int:
    """The bytes this rank holds of ``tree``'s tensors (a DTensor's local
    shard, any other tensor whole)."""
    return sum(t.numel() * t.element_size() for t in _local_tensors(tree))


def _moves_nothing(func) -> bool:
    """A view (its output aliases an input and writes nothing) or an
    allocation that writes nothing."""
    if func._schema.name in ("aten::empty", "aten::empty_strided",
                             "aten::empty_like", "aten::new_empty",
                             "aten::new_empty_strided"):
        return True
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


class bytes_accessed(TorchDispatchMode):
    """Counts, while active, the bytes of each op's tensor inputs and
    outputs, as XLA's cost analysis counts "bytes accessed": every input
    read once and every output written once (an in-place op reads and
    writes its tensor). A view or an empty allocation moves nothing and
    counts 0."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not _moves_nothing(func):
            self.total += sum(
                t.numel() * t.element_size()
                for t in tree_flatten((args, kwargs, out))[0]
                if isinstance(t, torch.Tensor))
        return out


class live_bytes(TorchDispatchMode):
    """Tracks, while active, the bytes of the storages that ops create:
    each storage is counted when an op first returns it and uncounted
    when it is freed (a weakref finalizer). The storages of ``held``
    (a tree of tensors that exist already) are never counted, though a
    view of one is an op's output. ``peak`` is the most that was alive at
    once, ``live`` what is alive now."""

    def __init__(self, held=()):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()
        for t in _local_tensors(held):
            self._seen[t.untyped_storage()] = True

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and not hasattr(t, "to_local"):
                st = t.untyped_storage()
                if st not in self._seen:
                    n = st.nbytes()
                    self._seen[st] = True
                    self.live += n
                    weakref.finalize(st, self._free, n)
        self.peak = max(self.peak, self.live)
        return out


def cell_costs(cell: Cell, collectives: dict | None = None) -> dict:
    """Runs the cell's step once and counts, per device: ``flops``
    (``FlopCounterMode``), ``bytes_accessed`` (``bytes_accessed``),
    ``collective_bytes`` (``roofline.analysis.collective_bytes``), the
    bytes of the step's arguments and of the model's own parameters that
    the step holds (``argument_bytes_per_device``), of its outputs, and
    its peak: the arguments plus the most the step's own storages held at
    once (``live_bytes``). The step runs as it runs the first time in a
    process (the one-time copies it caches included). ``collectives``,
    where given, receives the collective calls and bytes by op
    (``{op: {"calls": n, "bytes": b}}``), which the row does not hold."""
    resident = (cell.args, list(cell.model.parameters()))
    held = local_bytes(resident)
    # every count includes the rotary frequencies' one-time copy to the
    # device (cached per device once made), so that no row depends on the
    # cells counted before it in the process
    _freqs.cache_clear()
    t0 = time.perf_counter()
    flops = FlopCounterMode(display=False)
    moved, coll = bytes_accessed(), collective_bytes()
    live = live_bytes(resident)
    with live, flops, moved, coll:
        out = cell.step(*cell.args)
    run_s = time.perf_counter() - t0
    if collectives is not None:
        collectives.update({op: {"calls": n, "bytes": coll.by_op[op]}
                            for op, n in sorted(coll.calls.items())})
    return {
        "compile_s": round(run_s, 1),
        "flops": float(flops.get_total_flops()),
        "bytes_accessed": float(moved.total),
        "collective_bytes": float(coll.total),
        "argument_bytes_per_device": int(held),
        "output_bytes_per_device": int(local_bytes(out)),
        "temp_bytes_total": int(live.peak),
        "peak_bytes_per_device": int(held + live.peak),
    }


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             hlo_dir: str | None = None, roofline: bool = True,
             policy: str = "baseline", collectives: dict | None = None
             ) -> dict:
    """One cell's row, counted in a world of fake ranks of its own.
    ``hlo_dir`` is the reference's option: the port compiles no HLO and
    writes nothing there. ``collectives`` as in ``cell_costs``."""
    del hlo_dir
    shape = SHAPES[shape_name]
    n_chips = 512 if multi_pod else 256
    with fake_world(n_chips):
        t0 = time.perf_counter()
        cell = build_cell(arch_name, shape_name, multi_pod, policy=policy)
        lower_s = time.perf_counter() - t0
        costs = cell_costs(cell, collectives)
        n_chips = math.prod(cell.mesh.shape.values())
        del cell
    row = {"arch": arch_name, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "kind": shape.kind, "n_chips": n_chips, "status": "ok",
           "lower_s": round(lower_s, 1)}
    row.update(costs)
    if roofline:
        cfg, _ = apply_policy(get_arch(arch_name), shape, policy)
        for k in ("flops", "bytes_accessed", "collective_bytes"):
            row[k + "_scaled"] = row[k]
        row.update(roofline_row(cfg, shape, row))
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Count the port's sharded steps on meta tensors over "
                    "a world of fake ranks, cell by cell.")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["sp", "mp", "both"])
    ap.add_argument("--out", default="build/dryrun/dryrun.jsonl")
    ap.add_argument("--hlo-dir", default=None,
                    help="accepted for the reference's command line; the "
                         "port compiles no HLO and writes nothing here")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--policy", default="baseline",
                    choices=["baseline", "optimized"])
    args = ap.parse_args(argv)

    archs = sorted(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"sp": [False], "mp": [True], "both": [False, True]}[args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = set()
    if os.path.exists(args.out) and not args.force:
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    if r.get("status") in ("ok", "skipped"):
                        done.add((r["arch"], r["shape"], r["mesh"]))
                except json.JSONDecodeError:
                    pass

    with open(args.out, "a") as out:
        for arch in archs:
            for shape_name in shapes:
                cfg = get_arch(arch)
                ok, why = shape_applicable(cfg, SHAPES[shape_name])
                for mp in meshes:
                    mesh_name = "2x16x16" if mp else "16x16"
                    if (arch, shape_name, mesh_name) in done:
                        continue
                    if not ok:
                        row = {"arch": arch, "shape": shape_name,
                               "mesh": mesh_name, "status": "skipped",
                               "reason": why}
                        print(f"[skip] {arch} {shape_name} {mesh_name}: {why}",
                              flush=True)
                    else:
                        print(f"[cell] {arch} {shape_name} {mesh_name} ...",
                              flush=True)
                        try:
                            # roofline terms: single-pod only; the
                            # multi-pod row proves pod-axis sharding
                            by_op = {}
                            row = run_cell(arch, shape_name, mp,
                                           hlo_dir=args.hlo_dir,
                                           roofline=not mp,
                                           policy=args.policy,
                                           collectives=by_op)
                            row["policy"] = args.policy
                            print(f"   ok: compile={row['compile_s']}s "
                                  f"flops={row['flops']:.3g} "
                                  f"coll={row['collective_bytes']:.3g}B "
                                  f"peak={row['peak_bytes_per_device']/2**30:.2f}GiB",
                                  flush=True)
                            print(f"   collectives: {json.dumps(by_op)}",
                                  flush=True)
                        except Exception as e:
                            traceback.print_exc()
                            row = {"arch": arch, "shape": shape_name,
                                   "mesh": mesh_name, "status": "error",
                                   "error": f"{type(e).__name__}: {e}"[:500]}
                    out.write(json.dumps(row) + "\n")
                    out.flush()


if __name__ == "__main__":
    main()
