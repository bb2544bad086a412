"""§Perf hillclimbing harness: run one (arch x shape) cell under a NAMED
VARIANT (config patch + build options + sharding overrides), record the
same roofline terms as the dry run, append to a JSONL file.

    python -m repro_torch.launch.perf [--arch A --shape S --variant V] \\
        [--out build/dryrun/perf.jsonl]

With no ``--arch``/``--shape``/``--variant`` (each ``all`` by default) it
runs every variant of ``VARIANTS``. A variant is built by the dry run's
``build_cell`` and counted by its ``cell_costs`` on the 16x16 mesh of a
world of 256 fake ranks, the port's own steps on meta tensors; the
sharding overrides hold for their cell only.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

from ..configs import get_arch
from ..roofline.analysis import roofline_row
from .dryrun import build_cell, cell_costs, fake_world


def build(arch, shape_name, *, cfg_patch=None, last_only=False,
          sharding_overrides=None, naive_tp=True, cache_batch_only=False):
    """The variant's cell (``dryrun.Cell``) on the single-pod mesh of the
    running world."""
    cfg = get_arch(arch)
    if cfg_patch:
        cfg = dataclasses.replace(cfg, **cfg_patch)
    opts = dict(naive_tp=naive_tp, last_only=last_only,
                overrides=sharding_overrides,
                cache_features=not cache_batch_only)
    return build_cell(arch, shape_name, False, cfg=cfg, opts=opts)


def compile_costs(arch, shape_name, **kw):
    """(cfg, shape, mesh, costs) of one variant, counted in a world of
    256 fake ranks of its own."""
    with fake_world(256):
        cell = build(arch, shape_name, **kw)
        costs = cell_costs(cell)
    return cell.cfg, cell.shape, cell.mesh, costs


def run_variant(arch, shape_name, variant_name, hlo_dir=None, **kw):
    """Full-depth roofline for one variant of one cell. ``hlo_dir`` is the
    reference's option: nothing is written there."""
    del hlo_dir
    cfg, shape, mesh, full = compile_costs(arch, shape_name, **kw)
    row = {"arch": arch, "shape": shape_name, "variant": variant_name,
           "mesh": "16x16", "kind": shape.kind, "n_chips": 256,
           "status": "ok"}
    row.update(full)
    for k in ("flops", "bytes_accessed", "collective_bytes"):
        row[k + "_scaled"] = row[k]
    row.update(roofline_row(cfg, shape, row))
    return row


# ---------------------------------------------------------------------------
# the named variants (the reference's §Perf iterations)
# ---------------------------------------------------------------------------

VARIANTS = {
    # ---- cell C: qwen2.5-32b x prefill_32k --------------------------------
    ("qwen2.5-32b", "prefill_32k"): {
        "baseline": {},
        "last_only": dict(last_only=True),
        "blocked_attn": dict(last_only=True,
                             cfg_patch=dict(attn_q_chunk=2048)),
        "blocked_attn_4k": dict(last_only=True,
                                cfg_patch=dict(attn_q_chunk=4096)),
        "tp_headfix": dict(last_only=True,
                           cfg_patch=dict(attn_q_chunk=2048),
                           naive_tp=False),
        # zero-pad q heads 40->48 (numerics-exact: padded heads hit zero
        # wo rows) so wq/wo TP-shard on head boundaries again
        "qpad48": dict(last_only=True,
                       cfg_patch=dict(attn_q_chunk=2048, n_heads=48),
                       naive_tp=False),
        "bf16_pv": dict(last_only=True,
                        cfg_patch=dict(attn_q_chunk=2048, n_heads=48,
                                       attn_w_bf16=True),
                        naive_tp=False),
    },
    # ---- cell A: mamba2-780m x train_4k ------------------------------------
    ("mamba2-780m", "train_4k"): {
        "baseline": {},
        "chunk128": dict(cfg_patch=dict(ssm_chunk=128)),
        "chunk512": dict(cfg_patch=dict(ssm_chunk=512)),
        "inproj_fsdp_only": dict(sharding_overrides={
            "in_proj": "fsdp_in"}),
        "chunk128_inproj": dict(cfg_patch=dict(ssm_chunk=128),
                                sharding_overrides={"in_proj": "fsdp_in"}),
        "tp_headfix": dict(naive_tp=False),
        "headfix_inproj": dict(naive_tp=False,
                               sharding_overrides={"in_proj": "fsdp_in"}),
        "headfix_inproj_c128": dict(naive_tp=False,
                                    cfg_patch=dict(ssm_chunk=128),
                                    sharding_overrides={"in_proj": "fsdp_in"}),
        "inproj_bf16ssd": dict(
            cfg_patch=dict(ssd_bf16=True),
            sharding_overrides={"in_proj": "fsdp_in"}),
        "headfix_inproj_ssdheads": dict(
            naive_tp=False,
            cfg_patch=dict(ssd_shard_heads=True),
            sharding_overrides={"in_proj": "fsdp_in"}),
    },
    # ---- cell B: recurrentgemma-2b x decode_32k ----------------------------
    ("recurrentgemma-2b", "decode_32k"): {
        "baseline": {},
        "replicate_attn": dict(sharding_overrides={
            "wq": "replicate", "wk": "replicate", "wv": "replicate",
            "wo": "replicate"}),
        "lru_fsdp_only": dict(sharding_overrides={
            "w_a": "fsdp_in", "w_i": "fsdp_in"}),
        "tp_headfix": dict(naive_tp=False),
        "headfix_repl_attn": dict(naive_tp=False, sharding_overrides={
            "wq": "replicate", "wk": "replicate", "wv": "replicate",
            "wo": "replicate"}),
        "headfix_cache_batch": dict(naive_tp=False, cache_batch_only=True),
    },
}


def selected(arch: str = "all", shape: str = "all",
             variant: str = "all") -> list[tuple[str, str, str]]:
    """The (arch, shape, variant) triples of ``VARIANTS`` that the
    arguments name (``all`` names every one)."""
    out = [(a, s, v) for (a, s), vs in VARIANTS.items() for v in vs
           if arch in ("all", a) and shape in ("all", s)
           and variant in ("all", v)]
    if not out:
        raise SystemExit(f"no variant {variant!r} of ({arch}, {shape}); "
                         f"cells: {sorted(VARIANTS)}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--variant", default="all")
    ap.add_argument("--out", default="build/dryrun/perf.jsonl")
    ap.add_argument("--hlo-dir", default=None,
                    help="accepted for the reference's command line; the "
                         "port compiles no HLO and writes nothing here")
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    for arch, shape, variant in selected(args.arch, args.shape,
                                         args.variant):
        spec = VARIANTS[(arch, shape)][variant]
        row = run_variant(arch, shape, variant, hlo_dir=args.hlo_dir, **spec)
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps({k: row[k] for k in
                          ("arch", "shape", "variant", "compute_s",
                           "memory_s", "collective_s", "dominant",
                           "roofline_fraction", "peak_bytes_per_device",
                           "compile_s")}), flush=True)


if __name__ == "__main__":
    main()
