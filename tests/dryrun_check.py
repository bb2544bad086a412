"""Checks of the port's dry run (``repro_torch.launch.dryrun``) that need a
world of fake ranks, run as a command of their own so that the caller's
process never joins a process group:

    PYTHONPATH=src python tests/dryrun_check.py

prints one JSON object:
  * ``meta_vs_real``: per smoke cell (a train, a prefill and a decode
    step on a (1, 1) mesh of one fake rank, float32), the FLOPs that
    ``cell_costs`` counts on meta tensors and those ``FlopCounterMode``
    counts over the same cell built on host tensors;
  * ``depth``: per published config, the counts (FLOPs, bytes accessed,
    collective bytes) of ``layer_variants``' two depths and of the full
    depth, a train step at 2 x 32 tokens on a (1, 1) mesh;
  * ``scoped``: a smoke mamba2-780m decode cell on a (2, 2) mesh of 4
    fake ranks counted alone, after the "optimized" policy's cell (whose
    sharding override places ``in_proj`` FSDP-only), and that cell's own
    counts, with ``PARAM_OVERRIDES`` after it.
"""
from __future__ import annotations

import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.launch import shardings as sh
from repro_torch.launch.dryrun import (build_cell, cell_costs, fake_world,
                                       layer_variants)
from repro_torch.launch.mesh import make_mesh

COUNTS = ("flops", "bytes_accessed", "collective_bytes")
SMOKE_CELLS = {"granite-3-2b": ShapeConfig("t", 16, 4, "train"),
               "mamba2-780m": ShapeConfig("p", 16, 4, "prefill"),
               "whisper-tiny": ShapeConfig("d", 16, 4, "decode")}
DEPTH_ARCHS = ("deepseek-moe-16b",)


def _mesh(shape=(1, 1)):
    return make_mesh(shape, ("data", "model"), "cpu")


def meta_vs_real() -> dict:
    out = {}
    with fake_world(1):
        for arch, shape in SMOKE_CELLS.items():
            cfg = get_arch(arch, smoke=True)
            meta = cell_costs(build_cell(arch, shape, False, cfg=cfg,
                                         mesh=_mesh(), dtype=torch.float32))
            real = build_cell(arch, shape, False, cfg=cfg, mesh=_mesh(),
                              dtype=torch.float32, device="cpu")
            with FlopCounterMode(display=False) as fc:
                real.step(*real.args)
            out[arch] = {"meta": meta["flops"],
                         "real": float(fc.get_total_flops())}
    return out


def depth() -> dict:
    out = {}
    shape = ShapeConfig("t", 32, 2, "train")
    with fake_world(1):
        for arch in DEPTH_ARCHS:
            cfg = get_arch(arch)
            a, ua, b, ub, n = layer_variants(cfg)
            counts = {}
            for name, c in (("a", a), ("b", b), ("full", cfg)):
                costs = cell_costs(build_cell(arch, shape, False, cfg=c,
                                              mesh=_mesh()))
                counts[name] = {k: costs[k] for k in COUNTS}
            out[arch] = {"units": [ua, ub, n], **counts}
    return out


def scoped() -> dict:
    cfg = get_arch("mamba2-780m", smoke=True)
    shape = ShapeConfig("d", 64, 4, "decode")

    def row(policy):
        costs = cell_costs(build_cell("mamba2-780m", shape, False, cfg=cfg,
                                      mesh=_mesh((2, 2)), policy=policy))
        costs.pop("compile_s")
        return costs

    with fake_world(4):
        alone = row("baseline")
        optimized = row("optimized")
        after = row("baseline")
    return {"alone": alone, "optimized": optimized, "after": after,
            "overrides_after": dict(sh.PARAM_OVERRIDES)}


if __name__ == "__main__":
    print(json.dumps({"meta_vs_real": meta_vs_real(), "depth": depth(),
                      "scoped": scoped()}))
