"""The port's dry run (``repro_torch.launch.dryrun``) and perf harness
(``repro_torch.launch.perf``).

Against the reference, ``==``: ``layer_variants`` and ``apply_policy`` for
every architecture, shape and policy (the fp8 cache named by its dtype's
name), the 8-cell skip matrix, the named variants and the row's keys.
The counts themselves are the port's (its steps compute the whole model
on every rank of a "model" line; XLA shards each product) and are held
to runs of the same steps instead: a smoke step's FLOPs on meta tensors
``==`` its FLOPs on host tensors, and the full-depth count linear in depth
between ``layer_variants``' two depths (``tests/dryrun_check.py``, in a
process of its own: this one joins no process group). One cell runs
through the command (whisper-tiny decode_32k on both meshes, as the
reference's test does), and a cell's row does not depend on the cells
counted before it. The fp8 cache of qwen1.5-32b's optimized decode is
held to the reference's decode on an fp8 cache.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_parity as P
from repro.configs import ARCHS, SHAPES, get_arch as ref_get_arch
from repro.configs import shape_applicable as ref_shape_applicable
from repro.launch import dryrun as ref_dryrun
from repro_torch.configs import get_arch, shape_applicable
from repro_torch.launch import dryrun
from repro_torch.launch import shardings as sh
from repro_torch.roofline.analysis import HBM_PER_CHIP

ROOT = Path(__file__).resolve().parents[1]
NAMES = sorted(ARCHS)
POLICIES = ("baseline", "optimized")
COUNTS = ("flops", "bytes_accessed", "collective_bytes")
# the keys of the reference's rows (src/repro/launch/dryrun.py: run_cell,
# _compile_costs without its mesh, roofline_row, main's policy)
ROW_KEYS = {"arch", "shape", "mesh", "kind", "n_chips", "status", "lower_s",
            "compile_s", "flops", "bytes_accessed", "collective_bytes",
            "argument_bytes_per_device", "output_bytes_per_device",
            "temp_bytes_total", "peak_bytes_per_device", "policy"}
ROOFLINE_KEYS = {"flops_scaled", "bytes_accessed_scaled",
                 "collective_bytes_scaled", "compute_s", "memory_s",
                 "collective_s", "dominant", "model_flops",
                 "useful_flops_ratio", "roofline_fraction",
                 "step_time_lower_bound_s"}


def _env() -> dict:
    return {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
           if p])}


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


def _opts(opts: dict) -> dict:
    """``opts`` with a cache dtype named by its name (the two packages'
    float8 types are each their own)."""
    out = dict(opts)
    d = out.get("cache_dtype")
    if d is not None:
        out["cache_dtype"] = str(d).rsplit(".", 1)[-1] \
            if isinstance(d, torch.dtype) else np.dtype(d).name
    return out


@pytest.mark.parametrize("name", NAMES)
def test_layer_variants_equal_the_reference(name):
    got, want = dryrun.layer_variants(get_arch(name)), \
        ref_dryrun.layer_variants(ref_get_arch(name))
    assert [_fields(x) if i in (0, 2) else x for i, x in enumerate(got)] == \
        [_fields(x) if i in (0, 2) else x for i, x in enumerate(want)]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("policy", POLICIES)
def test_apply_policy_equals_the_reference(name, policy):
    for shape in SHAPES.values():
        cfg, opts = dryrun.apply_policy(get_arch(name), shape, policy)
        ref_cfg, ref_opts = ref_dryrun.apply_policy(ref_get_arch(name),
                                                    shape, policy)
        assert _fields(cfg) == _fields(ref_cfg)
        assert _opts(opts) == _opts(ref_opts)
        if "cache_dtype" in opts:
            assert opts["cache_dtype"] is torch.float8_e4m3fn


def test_skip_matrix_equals_the_reference_and_has_eight_cells():
    skipped = [(a, s.name) for a in NAMES for s in SHAPES.values()
               if not shape_applicable(get_arch(a), s)[0]]
    assert skipped == [(a, s.name) for a in NAMES for s in SHAPES.values()
                       if not ref_shape_applicable(ref_get_arch(a), s)[0]]
    assert len(skipped) == 8 and all(s == "long_500k" for _, s in skipped)


def test_perf_variants_equal_the_references():
    from repro.launch import perf as ref_perf
    from repro_torch.launch import perf

    assert perf.VARIANTS == ref_perf.VARIANTS
    assert len(perf.selected()) == sum(map(len, perf.VARIANTS.values()))
    assert perf.selected("mamba2-780m", "train_4k", "chunk128") == [
        ("mamba2-780m", "train_4k", "chunk128")]


def test_import_sets_no_environment_variable_and_no_process_group():
    probe = ("import os; before = dict(os.environ); "
             "import repro_torch.launch.dryrun, repro_torch.launch.perf, "
             "repro_torch.roofline.report; "
             "import torch.distributed as dist; "
             "assert dict(os.environ) == before; "
             "assert not dist.is_initialized(); print('ok')")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120, cwd=ROOT, env=_env())
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"


def test_dryrun_cell_subprocess(tmp_path):
    out = tmp_path / "dryrun.jsonl"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", "whisper-tiny", "--shape", "decode_32k",
         "--mesh", "both", "--out", str(out), "--hlo-dir",
         str(tmp_path / "hlo")],
        capture_output=True, text=True, timeout=300, env=_env(), cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    rows = [json.loads(line) for line in open(out)]
    assert len(rows) == 2
    by_mesh = {row["mesh"]: row for row in rows}
    assert by_mesh["16x16"]["status"] == "ok"
    assert by_mesh["2x16x16"]["status"] == "ok"
    sp, mp = by_mesh["16x16"], by_mesh["2x16x16"]
    assert set(sp) == ROW_KEYS | ROOFLINE_KEYS
    assert set(mp) == ROW_KEYS
    assert (sp["n_chips"], mp["n_chips"]) == (256, 512)
    # roofline fields present and sane (single-pod only)
    assert sp["dominant"] in ("compute", "memory", "collective")
    assert sp["flops_scaled"] >= sp["flops"] > 0
    assert all(sp[k + "_scaled"] == sp[k] for k in COUNTS)
    assert 0 < sp["peak_bytes_per_device"] < HBM_PER_CHIP
    assert sp["peak_bytes_per_device"] == \
        sp["argument_bytes_per_device"] + sp["temp_bytes_total"]
    assert 0 < sp["roofline_fraction"] < 1
    # twice the ranks: each holds and gathers less of the batch
    assert mp["flops"] < sp["flops"]
    assert not (tmp_path / "hlo").exists()
    # resumable: a second run skips the done cells
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", "whisper-tiny", "--shape", "decode_32k", "--mesh", "sp",
         "--out", str(out)],
        capture_output=True, text=True, timeout=300, env=_env(), cwd=ROOT)
    assert r.returncode == 0 and "[cell]" not in r.stdout
    assert len(out.read_text().splitlines()) == 2


@pytest.fixture(scope="module")
def checks():
    out = subprocess.run([sys.executable, str(ROOT / "tests" /
                                              "dryrun_check.py")],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=_env(), start_new_session=True)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-780m",
                                  "whisper-tiny"])
def test_meta_flops_equal_the_flops_on_host_tensors(checks, arch):
    got = checks["meta_vs_real"][arch]
    assert got["meta"] == got["real"] > 0


@pytest.mark.parametrize("count", COUNTS)
def test_full_depth_count_is_linear_between_the_two_depths(checks, count):
    got = checks["depth"]["deepseek-moe-16b"]
    ua, ub, n = got["units"]
    a, b, full = (got[k][count] for k in ("a", "b", "full"))
    # cost(full) = cost(a) + (n - ua) * (cost(b) - cost(a)) / (ub - ua)
    assert full * (ub - ua) == a * (ub - ua) + (n - ua) * (b - a)
    if count != "collective_bytes":     # no collective on a (1, 1) mesh
        assert full > b > a > 0


def test_a_cells_row_does_not_depend_on_the_cells_before_it(checks):
    got = checks["scoped"]
    assert got["after"] == got["alone"]
    assert got["overrides_after"] == {}
    # the optimized cell's override did act on its own placement
    assert got["optimized"]["argument_bytes_per_device"] != \
        got["alone"]["argument_bytes_per_device"]


def test_param_overrides_are_restored_after_the_block():
    sh.PARAM_OVERRIDES.clear()
    with sh.param_overrides({"in_proj": "fsdp_in"}):
        assert sh.PARAM_OVERRIDES == {"in_proj": "fsdp_in"}
        with pytest.raises(KeyError):
            with sh.param_overrides({"wq": "replicate"}):
                assert sh.PARAM_OVERRIDES == {"in_proj": "fsdp_in",
                                              "wq": "replicate"}
                raise KeyError("inside")
        assert sh.PARAM_OVERRIDES == {"in_proj": "fsdp_in"}
    assert sh.PARAM_OVERRIDES == {}


def test_fp8_cache_decode_matches_the_reference():
    # qwen1.5-32b's optimized decode keeps its KV cache in float8_e4m3fn
    name = "qwen1.5-32b"
    cfg, ref, params, port = P.models(name)
    rng = np.random.default_rng(5)
    rc = ref.init_decode_caches(2, 32, jnp.float8_e4m3fn)
    pc = port.init_decode_caches(2, 32, torch.float8_e4m3fn)
    for pos in ([0, 3], [1, 4]):
        tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        pos = np.asarray(pos, np.int32)
        rl, rc = P.jitted(name, "decode_step")(params, rc, jnp.asarray(tok),
                                               jnp.asarray(pos))
        with torch.inference_mode():
            pl, pc = port.decode_step(pc, torch.from_numpy(tok),
                                      torch.from_numpy(pos))
        np.testing.assert_allclose(np.asarray(pl), np.asarray(rl),
                                   atol=P.LOGIT_ATOL, rtol=0)
    for g, w in zip(pc["kv"], rc["kv"]):
        assert g.dtype == torch.float8_e4m3fn
        assert np.array_equal(g.float().numpy(),
                              np.asarray(w).astype(np.float32))
