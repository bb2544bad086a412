"""The port's device fleet (``core.fleet``) against the JAX reference's.

The reference's fleet cases (gmem-heavy SAXPY, the fused two-stage
reduction behind its barrier, the interleaved FFT-64 + QRD-16 grid with
per-block shared-memory batches) and a heterogeneous SAXPY grid whose
programs read their BIDs, run through both packages' ``launch_fleet`` on
the same numpy-seeded inputs:

  * ``fleet(1)`` is the plain launch, fleet view attached;
  * ``fleet(n)``, n = 2...4, under both routes: the state, counters,
    per-block timeline and profile equal the reference's (the fleet view
    whole under ``placement="host"``, all but ``placement_reason`` under
    ``"auto"``, whose reason names the port's own devices; the
    reference's fleet is placed on the host, see ``reference``), and
    every sub-launch's blocks equal the plain launch's same blocks;
  * the fleet-wide barrier fence, the NUMA charge, the home device, the
    placement ladder and ``FleetConfig``'s validation.

State is compared word for word, except that the QRD blocks' FP32 words
agree within ``test_torch_step.FP_ATOL`` (the INVSQR and FMA departures
of ROADMAP §C: the reference's own QRD words differ between its plain
launch and its kernel-routed fleet). The port's fleet equals the port's
plain launch word for word. The reference runs once per configuration
(a module-scoped cache).
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import DeviceConfig as JDeviceConfig
from repro.core import FleetConfig as JFleetConfig
from repro.core import Kernel as JKernel
from repro.core import SMConfig as JSMConfig
from repro.core import launch as j_launch
from repro.core import launch_fleet as j_launch_fleet
from repro_torch.core import (DeviceConfig, FleetConfig, Kernel, SMConfig,
                              assemble, buffer_layout, launch, launch_fleet)
from repro_torch.core import fleet as t_fleet
from repro_torch.core.programs.fft import fft_kernel, fft_shmem
from repro_torch.core.programs.mixed import mixed_device
from repro_torch.core.programs.qrd import qrd_kernel, qrd_shmem
from repro_torch.core.programs.reduction import reduction_grid_asm
from repro_torch.core.programs.saxpy import saxpy_grid_program
from test_torch_step import _QRD_FP, _assert_state_equal

ROOT = Path(__file__).resolve().parents[1]

# ---------------------------------------------------------------- cases
# each builds (port device, port launch kwargs, FP words of the case)


def _case_saxpy():
    n, block = 256, 64
    rng = np.random.default_rng(7)
    buffers = {"x": rng.standard_normal(n).astype(np.float32),
               "y": rng.standard_normal(n).astype(np.float32),
               "z": np.zeros(n, np.float32),
               "alpha": np.asarray([1.5], np.float32)}
    dcfg = DeviceConfig(n_sms=2, global_mem_depth=3 * n + 16, backend="cpu",
                        sm=SMConfig(max_steps=10_000))
    return dcfg, dict(program=saxpy_grid_program(n, block),
                      grid=(n // block,), block=block, buffers=buffers), None


def _case_reduction_fused():
    x = np.arange(256, dtype=np.float32)
    block, n_blocks, n2 = 64, 4, 16
    buffers = {"x": x, "partials": np.zeros(n2, np.float32),
               "result": np.zeros(16, np.float32)}
    layout = buffer_layout(buffers)
    src, par, res_off = (layout[k][0] for k in ("x", "partials", "result"))
    kernels = [Kernel(assemble(reduction_grid_asm(block, src, par, True)),
                      block=block, name="reduce.stage1"),
               Kernel(assemble(reduction_grid_asm(n2, par, res_off, False)),
                      block=n2, name="reduce.stage2", barrier=True)]
    dcfg = DeviceConfig(n_sms=2, global_mem_depth=512, backend="cpu",
                        sm=SMConfig(max_steps=50_000))
    return dcfg, dict(programs=kernels, grid_map=[0] * n_blocks + [1],
                      buffers=buffers), None


def _case_mixed_fft_qrd():
    dcfg = mixed_device(64, n_sms=2, backend="cpu")
    xs = (np.linspace(-1, 1, 6 * 64).reshape(6, 64)
          + 0.5j * np.ones((6, 64))).astype(np.complex64)
    As = np.stack([np.eye(16, dtype=np.float32) + 0.1 * b
                   for b in range(3)])
    sh_f = np.stack([fft_shmem(x, dcfg.sm.shmem_depth) for x in xs])
    sh_q = np.stack([qrd_shmem(A, dcfg.sm.shmem_depth) for A in As])
    return dcfg, dict(programs=[fft_kernel(64), qrd_kernel()],
                      grid_map=[0, 1, 0, 1, 0, 1, 0, 0, 0],
                      shmem=[sh_f, sh_q]), _QRD_FP


def _case_mixed_saxpy():
    """Two SAXPY programs (blocks of 64 and 32 threads) interleaved over
    one image: each block's BID picks its slice, so a sub-launch of this
    grid shows whether its merged waves carry the fleet-level BIDs."""
    n = 256
    rng = np.random.default_rng(11)
    buffers = {"x": rng.standard_normal(n).astype(np.float32),
               "y": rng.standard_normal(n).astype(np.float32),
               "z": np.zeros(n, np.float32),
               "alpha": np.asarray([-0.5], np.float32)}
    dcfg = DeviceConfig(n_sms=2, global_mem_depth=1024, backend="cpu",
                        sm=SMConfig(max_steps=10_000))
    kernels = [Kernel(saxpy_grid_program(n, 64), block=64),
               Kernel(saxpy_grid_program(n, 32), block=32)]
    return dcfg, dict(programs=kernels,
                      grid_map=[0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1],
                      buffers=buffers, schedule="dynamic"), None


CASES = {
    "saxpy256_g4": _case_saxpy,
    "reduction256_fused": _case_reduction_fused,
    "mixed_fft_qrd": _case_mixed_fft_qrd,
    "mixed_saxpy": _case_mixed_saxpy,
}


def _to_reference(dcfg, kw):
    """The reference's device and launch keywords of a port case."""
    d = dataclasses.asdict(dcfg)
    d.update(sm=JSMConfig(**d["sm"]), backend="inline")
    kw = dict(kw)
    if "programs" in kw:
        kw["programs"] = [JKernel(**{f.name: getattr(k, f.name)
                                     for f in dataclasses.fields(k)})
                          for k in kw["programs"]]
    return JDeviceConfig(**d), kw


@pytest.fixture(scope="module")
def reference():
    """``reference(name, n_devices, **fleet_kw)``: the reference's fleet
    launch of a case (``n_devices=None``: its plain launch), run once.

    The reference's fleet is placed on the host: under ``"auto"`` it would
    take ``shard_map`` wherever jax exposes enough host devices (a process
    that imported ``repro.launch.dryrun`` first exposes 512), which the
    port's host backend never does. Its placement is then "host", as the
    port's ``"auto"`` on the host; only the reason ("requested") differs."""
    runs = {}

    def run(name, n_devices=None, **fleet_kw):
        fleet_kw.setdefault("placement", "host")
        key = (name, n_devices, tuple(sorted(fleet_kw.items())))
        if key not in runs:
            dcfg, kw = _to_reference(*CASES[name]()[:2])
            runs[key] = j_launch(dcfg, **kw) if n_devices is None \
                else j_launch_fleet(JFleetConfig(
                    n_devices=n_devices, device=dcfg, **fleet_kw), **kw)
        return runs[key]
    return run


@pytest.fixture(scope="module")
def plain():
    """The port's plain launch of each case, run once."""
    runs = {}

    def run(name):
        if name not in runs:
            dcfg, kw, _ = CASES[name]()
            runs[name] = launch(dcfg, **kw)
        return runs[name]
    return run


def _fleet(name, n_devices, record=None, **fleet_kw):
    dcfg, kw, _ = CASES[name]()
    fcfg = FleetConfig(n_devices=n_devices, device=dcfg, **fleet_kw)
    if record is None:
        return launch_fleet(fcfg, **kw)
    with pytest.MonkeyPatch.context() as mp:
        real = t_fleet.launch

        def sub_launch(*args, **sub_kw):
            res = real(*args, **sub_kw)
            record.append((sub_kw.get("block_ids"), res))
            return res
        mp.setattr(t_fleet, "launch", sub_launch)
        return launch_fleet(fcfg, **kw)


def _arch_equal(a, b):
    for k in ("regs", "shmem", "gmem", "oob"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert a.halted == b.halted


def _assert_matches_reference(t, j, fp_words, drop_reason=True):
    _assert_state_equal(j, t, fp_words)
    for k in ("grid", "block", "n_waves", "halted", "steps", "cycles",
              "static_cycles", "buffer_offsets", "schedule", "packing",
              "engine", "engine_fallback", "program_names",
              "host_dispatch", "priority_respected"):
        assert getattr(t, k) == getattr(j, k), k
    for k in ("wave_cycles", "cycles_by_class", "grid_map"):
        assert np.array_equal(getattr(t, k), getattr(j, k)), k
    for k in ("block_sm", "block_start", "block_finish", "block_busy",
              "block_wait", "block_gmem", "wave_cycles"):
        assert np.array_equal(getattr(t.timing, k),
                              np.asarray(getattr(j.timing, k))), k
    pt, pj = t.profile(), j.profile()
    if drop_reason:
        assert pt["fleet"].pop("placement_reason")
        assert pj["fleet"].pop("placement_reason")
    assert pt == pj


# --------------------------------------------------- fleet(1) delegation

@pytest.mark.parametrize("name", sorted(CASES))
def test_fleet1_is_the_plain_launch(name, reference, plain):
    res = _fleet(name, 1)
    base = plain(name)
    _arch_equal(res, base)
    assert (res.cycles, res.steps, res.static_cycles) \
        == (base.cycles, base.steps, base.static_cycles)
    assert np.array_equal(res.wave_cycles, base.wave_cycles)
    fleet = res.profile()["fleet"]
    assert fleet["n_devices"] == 1 and fleet["remote_gmem_cycles"] == 0
    assert fleet["per_device"][0]["blocks"] == res.n_blocks
    assert fleet["per_device"][0]["makespan"] == res.cycles
    _assert_matches_reference(res, reference(name, 1), CASES[name]()[2],
                              drop_reason=False)


# ------------------------------------------------ fleet(n) vs reference

@pytest.mark.parametrize("route", ["block", "kernel"])
@pytest.mark.parametrize("n_devices", [2, 3, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_fleet_n_matches_reference(name, n_devices, route, reference,
                                   plain):
    subs = []
    res = _fleet(name, n_devices, record=subs, route=route)
    _assert_matches_reference(res, reference(name, n_devices, route=route),
                              CASES[name]()[2])
    base = plain(name)
    _arch_equal(res, base)
    fleet = res.profile()["fleet"]
    assert fleet["placement"] == "host"
    assert sum(d["blocks"] for d in fleet["per_device"]) == res.n_blocks
    assert max(d["makespan"] for d in fleet["per_device"]) == res.cycles
    # each sub-launch's blocks are the plain launch's same blocks, BIDs
    # included (the fleet-level BIDs of a program's blocks)
    assert sum(sub.n_blocks for _, sub in subs) == res.n_blocks
    gmap = np.asarray(res.grid_map)
    block_of = {}
    for k in np.unique(gmap):
        for bid, b in enumerate(np.flatnonzero(gmap == k)):
            block_of[int(k), bid] = int(b)
    for bids, sub in subs:
        blocks = [block_of[int(k), int(bid)]
                  for k, bid in zip(sub.grid_map, bids)]
        assert torch.equal(sub.regs, base.regs[blocks])
        assert torch.equal(sub.shmem, base.shmem[blocks])
        assert torch.equal(sub.oob, base.oob[blocks])


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_placement_profile_matches_reference(name, reference):
    res = _fleet(name, 2, placement="host")
    j = reference(name, 2, placement="host")
    assert res.profile()["fleet"]["placement_reason"] == "requested"
    _assert_matches_reference(res, j, CASES[name]()[2], drop_reason=False)


def test_kernel_route_keeps_programs_device_local(plain):
    res = _fleet("mixed_fft_qrd", 2, route="kernel")
    per = res.profile()["fleet"]["per_device"]
    # program k -> device k % 2: 6 FFT blocks home, 3 QRD blocks remote
    assert [d["blocks"] for d in per] == [6, 3]
    _arch_equal(res, plain("mixed_fft_qrd"))


# ------------------------------------------------------- barrier fence

@pytest.mark.parametrize("n_devices", [2, 3])
def test_barrier_fences_the_whole_fleet(n_devices):
    # stage 2 (block 4) issues nowhere before every stage-1 block retired
    # on every device
    res = _fleet("reduction256_fused", n_devices)
    t = res.timing
    assert int(t.block_start[4]) >= int(t.block_finish[:4].max())
    total = float(res.buffer("result")[0])
    assert total == float(np.arange(256, dtype=np.float32).sum())


# ------------------------------------------------------------ NUMA tier

def test_remote_gmem_latency_charges_off_home_blocks(reference):
    base = _fleet("saxpy256_g4", 2, remote_gmem_latency=0)
    numa = _fleet("saxpy256_g4", 2, remote_gmem_latency=7)
    _arch_equal(numa, base)
    f0, f7 = base.profile()["fleet"], numa.profile()["fleet"]
    assert f0["remote_gmem_cycles"] == 0
    assert f7["remote_gmem_cycles"] > 0
    assert f7["remote_gmem_cycles"] % 7 == 0
    assert numa.cycles > base.cycles
    # only the off-home device pays
    assert f7["per_device"][0]["makespan"] == f0["per_device"][0]["makespan"]
    assert f7["per_device"][1]["makespan"] > f0["per_device"][1]["makespan"]
    assert int(numa.cycles_by_class.sum()) \
        == int(base.cycles_by_class.sum()) + f7["remote_gmem_cycles"]
    _assert_matches_reference(
        numa, reference("saxpy256_g4", 2, remote_gmem_latency=7), None)


def test_home_device_moves_the_charge(reference):
    a = _fleet("saxpy256_g4", 2, remote_gmem_latency=5, home_device=0)
    b = _fleet("saxpy256_g4", 2, remote_gmem_latency=5, home_device=1)
    _arch_equal(a, b)
    fa, fb = a.profile()["fleet"], b.profile()["fleet"]
    assert fa["remote_gmem_cycles"] == fb["remote_gmem_cycles"] > 0
    assert [d["home"] for d in fa["per_device"]] == [True, False]
    assert [d["home"] for d in fb["per_device"]] == [False, True]
    _assert_matches_reference(b, reference(
        "saxpy256_g4", 2, remote_gmem_latency=5, home_device=1), None)


def test_fleet_makespan_improves_on_wide_grids():
    c = {n: _fleet("saxpy256_g4", n).cycles for n in (1, 2, 4)}
    assert c[2] <= c[1] and c[4] <= c[2]
    assert c[4] < c[1]


def test_fleet_leaves_the_callers_gmem_unchanged(plain):
    # the phase's base image is handed to every sub-launch and diffed
    # against: no sub-launch may write it, nor the caller's tensor
    dcfg, kw, _ = CASES["saxpy256_g4"]()
    gm, _ = t_fleet.pack_buffers(kw.pop("buffers"), dcfg.global_mem_depth)
    keep = gm.clone()
    res = launch_fleet(FleetConfig(n_devices=3, device=dcfg), gmem=gm, **kw)
    assert torch.equal(gm, keep)
    assert torch.equal(res.gmem, plain("saxpy256_g4").gmem)


# ------------------------------------------------------------ placement

def test_forced_shard_map_raises_on_mixed_grid():
    with pytest.raises(ValueError, match="shard_map.*mixed-program grid"):
        _fleet("mixed_fft_qrd", 2, placement="shard_map")


def test_auto_placement_records_why_not():
    fleet = _fleet("mixed_fft_qrd", 2).profile()["fleet"]
    assert fleet["placement"] == "host"
    assert "mixed-program grid" in fleet["placement_reason"]
    fleet = _fleet("saxpy256_g4", 3).profile()["fleet"]
    assert fleet["placement"] == "host"
    assert "not divisible" in fleet["placement_reason"]
    # a uniform grid: the host backend is the only reason
    fleet = _fleet("saxpy256_g4", 2).profile()["fleet"]
    assert fleet["placement"] == "host"
    assert fleet["placement_reason"] \
        == "backend='cpu' keeps the state on the host"
    with pytest.raises(ValueError, match="backend='cpu'"):
        _fleet("saxpy256_g4", 2, placement="shard_map")


def test_forced_host_always_works(plain):
    res = _fleet("saxpy256_g4", 2, placement="host")
    assert res.profile()["fleet"]["placement"] == "host"
    assert res.profile()["fleet"]["placement_reason"] == "requested"
    _arch_equal(res, plain("saxpy256_g4"))


@pytest.mark.parametrize("cards,want", [
    (4, ("shard_map", "uniform single-program single-phase grid")),
    (1, ("host", "torch exposes 1 CUDA device(s) < 2"))])
def test_placement_counts_the_cards(monkeypatch, cards, want):
    # the ladder on a card backend, with the card count stubbed
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    gmap = np.zeros(4, np.int64)
    traces = [dataclasses.make_dataclass("Trace", [("halted", bool)])(True)]
    got = t_fleet._resolve_placement(
        FleetConfig(n_devices=2), gmap, gmap, traces, "cuda",
        torch.device("cuda"))
    assert got == want


# -------------------------------------------------------------- config

def test_fleet_config_validation():
    for bad, field in ((dict(n_devices=0), "n_devices"),
                       (dict(remote_gmem_latency=-1), "remote_gmem_latency"),
                       (dict(n_devices=2, home_device=2), "home_device"),
                       (dict(route="hash"), "route"),
                       (dict(placement="tpu"), "placement")):
        with pytest.raises(ValueError, match=field) as got:
            FleetConfig(**bad)
        with pytest.raises(ValueError) as want:
            JFleetConfig(**bad)
        assert str(got.value) == str(want.value)
    assert FleetConfig(n_devices=3).n_sms == 3 * FleetConfig().device.n_sms


# ---------------------------------------------------------------- bench

def _bench_mixed(n_fft=8, n_qrd=4):
    """The fleet benchmark's grid: FFT-64 x 8 interleaved with QRD-16 x 4
    on devices of one SM."""
    dcfg = mixed_device(64, n_sms=1, backend="cpu")
    rng = np.random.default_rng(42)
    xs = (rng.standard_normal((n_fft, 64))
          + 1j * rng.standard_normal((n_fft, 64))).astype(np.complex64)
    As = np.stack([np.eye(16, dtype=np.float32)
                   + 0.05 * rng.standard_normal((16, 16)).astype(np.float32)
                   for _ in range(n_qrd)])
    gmap = []
    for i in range(max(n_fft, n_qrd)):
        gmap += [0] * (i < n_fft) + [1] * (i < n_qrd)
    return dcfg, dict(
        programs=[fft_kernel(64), qrd_kernel()], grid_map=gmap,
        shmem=[np.stack([fft_shmem(x, dcfg.sm.shmem_depth) for x in xs]),
               np.stack([qrd_shmem(A, dcfg.sm.shmem_depth) for A in As])])


def test_fleet_bench_reproduces_the_references_record():
    want = json.loads((ROOT / "BENCH_fleet.json").read_text())["lines"]
    dcfg, kw = _bench_mixed()
    base = None
    for n in (1, 2, 4):
        res = launch_fleet(FleetConfig(n_devices=n, device=dcfg), **kw)
        line = want[f"fleet{n}_mixed_fft8_qrd4"]
        fleet = res.profile()["fleet"]
        assert (res.n_blocks, res.cycles, fleet["placement"],
                [d["blocks"] for d in fleet["per_device"]]) \
            == (line["blocks"], line["cycles"], line["placement"],
                line["per_device_blocks"])
        base = base or res
        _arch_equal(res, base)
    n = 512
    rng = np.random.default_rng(7)
    buffers = {"x": rng.standard_normal(n).astype(np.float32),
               "y": rng.standard_normal(n).astype(np.float32),
               "z": np.zeros(n, np.float32),
               "alpha": np.asarray([1.5], np.float32)}
    sdcfg = DeviceConfig(n_sms=2, global_mem_depth=3 * n + 16, backend="cpu",
                         sm=SMConfig(max_steps=10_000))
    skw = dict(program=saxpy_grid_program(n, 64), grid=(n // 64,), block=64,
               buffers=buffers)
    flat = launch_fleet(FleetConfig(n_devices=2, device=sdcfg), **skw)
    numa = launch_fleet(FleetConfig(n_devices=2, device=sdcfg,
                                    remote_gmem_latency=7), **skw)
    _arch_equal(numa, flat)
    assert {"remote_gmem_latency": 7,
            "remote_gmem_cycles": numa.fleet["remote_gmem_cycles"],
            "cycles_flat": flat.cycles, "cycles_numa": numa.cycles} \
        == want["numa_saxpy512"]
