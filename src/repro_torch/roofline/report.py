"""Render the dry run's tables from its JSONL rows.

    python -m repro_torch.roofline.report [build/dryrun/dryrun.jsonl]
"""
from __future__ import annotations

import json
import sys


def load(path: str):
    rows = {}
    with open(path) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            rows[(r["arch"], r["shape"], r["mesh"])] = r
    return rows


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.3g}us"
    if x < 1:
        return f"{x*1e3:.3g}ms"
    return f"{x:.3g}s"


def roofline_table(rows) -> str:
    out = ["| arch | shape | kind | compute | memory | collective | dominant "
           "| useful (6ND/HLO) | roofline frac | peak GiB/dev | what moves the dominant term |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    hints = {
        ("prefill", "memory"): "blocked/flash attention: stop materializing S^2 score tiles",
        ("train", "memory"): "fused attention + recomputation: cut activation traffic",
        ("decode", "memory"): "KV-cache layout/quantization; batch-major sharding",
        ("train", "collective"): "overlap DP all-reduce with backward; int8-EF compression",
        ("decode", "collective"): "batch-major (DPxDP) layout: drop per-layer TP gathers",
        ("prefill", "collective"): "sequence sharding; gather K/V once per layer",
        ("train", "compute"): "already tensor-core-bound: increase batch/seq",
        ("decode", "compute"): "n/a (bandwidth-bound by construction)",
        ("prefill", "compute"): "already tensor-core-bound",
    }
    for (arch, shape, mesh) in sorted(rows):
        r = rows[(arch, shape, mesh)]
        if mesh != "16x16":
            continue
        if r.get("status") == "skipped":
            out.append(f"| {arch} | {shape} | — | — | — | — | — | — | — | — | "
                       f"skipped: full attention at 500k |")
            continue
        if r.get("status") != "ok" or "compute_s" not in r:
            continue
        hint = hints.get((r["kind"], r["dominant"]), "")
        out.append(
            f"| {arch} | {shape} | {r['kind']} | {fmt_s(r['compute_s'])} "
            f"| {fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} "
            f"| **{r['dominant']}** | {r['useful_flops_ratio']:.2f} "
            f"| {r['roofline_fraction']:.2g} "
            f"| {r['peak_bytes_per_device']/2**30:.2f} | {hint} |")
    return "\n".join(out)


def dryrun_table(rows) -> str:
    out = ["| arch | shape | 16x16 compile | 2x16x16 compile | args GiB/dev "
           "| peak GiB/dev | collectives (bytes/dev/step) |",
           "|---|---|---|---|---|---|---|"]
    archs = sorted({a for (a, _, _) in rows})
    shapes = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
    for arch in archs:
        for shape in shapes:
            sp = rows.get((arch, shape, "16x16"))
            mp = rows.get((arch, shape, "2x16x16"))
            if sp is None:
                continue
            if sp.get("status") == "skipped":
                out.append(f"| {arch} | {shape} | skip | skip | — | — | — |")
                continue
            coll = sp.get("collective_bytes_scaled", sp.get("collective_bytes", 0))
            out.append(
                f"| {arch} | {shape} | {sp.get('compile_s', '?')}s "
                f"| {(mp or {}).get('compile_s', '?')}s "
                f"| {sp.get('argument_bytes_per_device', 0)/2**30:.2f} "
                f"| {sp.get('peak_bytes_per_device', 0)/2**30:.2f} "
                f"| {coll:.3g} |")
    return "\n".join(out)


if __name__ == "__main__":
    rows = load(sys.argv[1] if len(sys.argv) > 1
                else "build/dryrun/dryrun.jsonl")
    print("## Dry-run matrix\n")
    print(dryrun_table(rows))
    print("\n## Roofline (single-pod 16x16, 256 H100s)\n")
    print(roofline_table(rows))
