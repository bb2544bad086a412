"""The port's sharding rules and the registry's shape specs against the
reference's, with no ranks: the rules read only axis sizes, so both run
on a ``FakeMesh`` (``tests/test_shardings.py``'s idiom).

For every arch in ``ARCHS`` at its published shapes:
  * ``param_spec`` equals the reference's on every leaf of the reference's
    stacked tree, on meshes of 16x16, 2x16x16 (with "pod") and small ones
    that force the fallbacks, with and without ``naive_tp`` and under
    ``PARAM_OVERRIDES``;
  * ``param_shardings`` over the port's per-layer parameters equals the
    reference's spec of the stacked leaf each one sits in, its leading
    layer entry dropped; the reference never puts an axis on that entry;
  * ``cache_spec`` and ``batch_spec`` equal the reference's on every cache
    leaf and batch of every ``SHAPES`` cell the arch applies to;
  * ``input_specs``, ``cache_specs`` and ``param_specs`` (meta tensors)
    have the shapes and dtypes of the reference's ``ShapeDtypeStruct``s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.launch import mesh as ref_mesh
from repro.launch import shardings as ref_sh
from repro.models import registry as ref_registry
from repro_torch.configs import ARCHS, SHAPES, get_arch, shape_applicable
from repro_torch.convert import lm_reference_leaf
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import shardings as sh
from repro_torch.models import cache_specs, input_specs, param_specs


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 2, "model": 2}, {"data": 3, "model": 5},
          {"data": 4, "model": 1}, {"data": 1, "model": 4},
          {"data": 1, "model": 1}, {"data": 8}, {"model": 8}]
DTYPES = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.int32): torch.int32}


def spec_of(p) -> tuple:
    return tuple(p)


@pytest.fixture(scope="module")
def ref_params():
    """arch -> [(path, shape, dtype)] of the reference's stacked tree."""
    out = {}
    for name, cfg in REF_ARCHS.items():
        flat, _ = ref_sh._tree_paths(ref_registry.param_specs(cfg))
        out[name] = [(path, tuple(leaf.shape), leaf.dtype)
                     for path, leaf in flat]
    return out


@pytest.fixture(scope="module")
def port_params():
    return {name: param_specs(cfg) for name, cfg in ARCHS.items()}


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_rule_equals_the_references_on_its_tree(arch, ref_params):
    for shape in MESHES:
        mesh = FakeMesh(shape)
        for naive in (False, True):
            for path, leaf_shape, _ in ref_params[arch]:
                want = ref_sh.param_spec(mesh, path, leaf_shape,
                                         cfg=REF_ARCHS[arch], naive_tp=naive)
                got = sh.param_spec(mesh, path, leaf_shape, cfg=ARCHS[arch],
                                    naive_tp=naive)
                assert spec_of(got) == spec_of(want), (shape, naive, path)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_shardings_drop_the_stacked_layer_entry(arch, ref_params,
                                                      port_params):
    ref = {path: s for path, s, _ in ref_params[arch]}
    for shape in MESHES:
        mesh = FakeMesh(shape)
        got = sh.param_shardings(mesh, port_params[arch], ARCHS[arch])
        assert set(got) == set(port_params[arch])
        for name, t in port_params[arch].items():
            path, stacked_shape, stacked = lm_reference_leaf(
                ARCHS[arch], name, t.shape)
            assert ref[path] == stacked_shape, name
            want = spec_of(ref_sh.param_spec(mesh, path, stacked_shape,
                                             cfg=REF_ARCHS[arch]))
            if stacked:
                # the reference never shards its layer axis: nothing lost
                assert not want or want[0] is None, (shape, path, want)
                want = want[1:]
            assert spec_of(got[name].spec) == want, (shape, name)
            assert len(got[name].spec) <= t.ndim


@pytest.mark.parametrize("overrides", [
    {"w_up": "replicate", "wq": "fsdp_in"},
    {"embedding": "fsdp_in", "w_down": "replicate", "in_proj": "fsdp_in"}])
def test_param_overrides_act_alike(overrides, ref_params):
    saved_ref, saved = dict(ref_sh.PARAM_OVERRIDES), dict(sh.PARAM_OVERRIDES)
    try:
        ref_sh.PARAM_OVERRIDES.update(overrides)
        sh.PARAM_OVERRIDES.update(overrides)
        for arch in ("yi-6b", "mamba2-780m", "deepseek-moe-16b"):
            for shape in MESHES[:4]:
                mesh = FakeMesh(shape)
                for path, leaf_shape, _ in ref_params[arch]:
                    want = ref_sh.param_spec(mesh, path, leaf_shape,
                                             cfg=REF_ARCHS[arch])
                    got = sh.param_spec(mesh, path, leaf_shape,
                                        cfg=ARCHS[arch])
                    assert spec_of(got) == spec_of(want), (arch, path)
    finally:
        ref_sh.PARAM_OVERRIDES.clear()
        ref_sh.PARAM_OVERRIDES.update(saved_ref)
        sh.PARAM_OVERRIDES.clear()
        sh.PARAM_OVERRIDES.update(saved)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_are_the_references_shapes_and_dtypes(arch, ref_params,
                                                          port_params):
    groups: dict[str, list] = {}
    for name, t in port_params[arch].items():
        assert t.device.type == "meta"
        path, shape, stacked = lm_reference_leaf(ARCHS[arch], name, t.shape)
        groups.setdefault(path, []).append((shape, t.dtype, stacked))
    want = {path: (shape, DTYPES[jnp.dtype(dt)])
            for path, shape, dt in ref_params[arch]}
    assert set(groups) == set(want)
    for path, entries in groups.items():
        shape, dtype = want[path]
        assert {(s, d) for s, d, _ in entries} == {(shape, dtype)}, path
        # a stacked group's layers are its leaf's leading axis, one each
        assert len(entries) == (shape[0] if entries[0][2] else 1), path


# ---------------------------------------------------------------------------
# inputs, batches and caches, per SHAPES cell
# ---------------------------------------------------------------------------

def _cells(arch):
    return [s for s in SHAPES.values() if shape_applicable(ARCHS[arch], s)[0]]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_and_batch_specs_match(arch):
    for shape in _cells(arch):
        want = ref_registry.input_specs(REF_ARCHS[arch], shape)
        got = input_specs(ARCHS[arch], shape)
        assert list(got) == list(want)
        for k, w in want.items():
            assert tuple(got[k].shape) == tuple(w.shape), (shape.name, k)
            assert got[k].dtype == DTYPES[jnp.dtype(w.dtype)]
            assert got[k].device.type == "meta"
        for m in MESHES:
            mesh = FakeMesh(m)
            port_b = sh.batch_shardings(mesh, got)
            for k, w in want.items():
                # the reference's batch_shardings: its batch_spec, padded
                bs = list(ref_sh.batch_spec(mesh, w.shape[0]))
                assert spec_of(port_b[k].spec) == tuple(
                    bs + [None] * (len(w.shape) - len(bs)))


def _ref_cache_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), leaf) for p, leaf in flat]


def _port_cache_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _port_cache_leaves(tree[k], f"{prefix}['{k}']")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            yield from _port_cache_leaves(v, f"{prefix}.{f}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _port_cache_leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_and_cache_rules_match(arch):
    for shape in [s for s in _cells(arch) if s.kind == "decode"] or \
            [SHAPES["decode_32k"]]:
        want = _ref_cache_leaves(ref_registry.cache_specs(REF_ARCHS[arch],
                                                          shape))
        caches = cache_specs(ARCHS[arch], shape)
        got = list(_port_cache_leaves(caches))
        assert [k for k, _ in got] == [k for k, _ in want]
        for (k, g), (_, w) in zip(got, want):
            if isinstance(g, torch.Tensor):
                assert g.device.type == "meta"
                assert tuple(g.shape) == tuple(w.shape), k
                assert g.dtype == DTYPES[jnp.dtype(w.dtype)], k
            else:  # pos
                assert g == 0 and w.shape == ()
        for m in MESHES:
            mesh = FakeMesh(m)
            for features in (True, False):
                placed = dict(_port_cache_leaves(sh.cache_shardings(
                    mesh, caches, shape.global_batch, features)))
                for k, w in want:
                    ref = spec_of(ref_sh.cache_spec(
                        mesh, w.shape, shape.global_batch, features))
                    if isinstance(placed[k], sh.NamedSharding):
                        assert spec_of(placed[k].spec) == ref, (m, k)
                    else:  # pos stays an int on the host
                        assert ref == ()


# ---------------------------------------------------------------------------
# the reference's own rule tests, on the port
# ---------------------------------------------------------------------------

def test_matrix_rule_fsdp_plus_tp():
    mesh = FakeMesh({"data": 16, "model": 16})
    assert sh.param_spec(mesh, "blocks/mlp/w_up", (32, 4096, 11008)) == \
        sh.P(None, "data", "model")


def test_attention_head_rules():
    mesh = FakeMesh({"data": 16, "model": 16})
    yi = get_arch("yi-6b")
    assert sh.param_spec(mesh, "blocks/attn/wq", (32, 4096, 4096),
                         cfg=yi) == sh.P(None, "data", "model")
    assert sh.param_spec(mesh, "blocks/attn/wk", (32, 4096, 512),
                         cfg=yi) == sh.P(None, "data", None)
    assert sh.param_spec(mesh, "blocks/attn/wo", (32, 4096, 4096),
                         cfg=yi) == sh.P(None, "model", "data")
    assert sh.param_spec(mesh, "blocks/attn/wk", (32, 4096, 512), cfg=yi,
                         naive_tp=True) == sh.P(None, "data", "model")


def test_qwen_heads_not_divisible_fall_back():
    mesh = FakeMesh({"data": 16, "model": 16})
    qw = get_arch("qwen2.5-32b")
    assert sh.param_spec(mesh, "blocks/attn/wq", (64, 5120, 5120),
                         cfg=qw) == sh.P(None, "data", None)
    qw48 = dataclasses.replace(qw, n_heads=48)
    assert sh.param_spec(mesh, "blocks/attn/wq", (64, 5120, 6144),
                         cfg=qw48) == sh.P(None, "data", "model")


def test_embedding_expert_and_scalar_rules():
    mesh = FakeMesh({"data": 16, "model": 16})
    assert sh.param_spec(mesh, "embed/embedding", (152064, 5120)) == \
        sh.P("model", "data")
    assert sh.param_spec(mesh, "blocks/moe/experts/w_up",
                         (28, 64, 2048, 1408)) == sh.P(None, "model", "data",
                                                       None)
    assert sh.param_spec(mesh, "blocks/ln/scale", (32, 4096)) == sh.P()
    assert sh.param_spec(mesh, "blocks/ssm/a_log", (48,)) == sh.P()


def test_batch_spec_divisibility():
    m = FakeMesh({"pod": 2, "data": 16, "model": 16})
    assert sh.batch_spec(m, 256) == sh.P(("pod", "data"))
    assert sh.batch_spec(m, 16) == sh.P("pod")
    assert sh.batch_spec(m, 1) == sh.P()
    for b in (1, 2, 3, 8, 16, 24, 32, 48, 96, 128, 256, 512, 1000):
        for shape in MESHES:
            assert spec_of(sh.batch_spec(FakeMesh(shape), b)) == spec_of(
                ref_sh.batch_spec(FakeMesh(shape), b))


def test_cache_spec_finds_batch_axis():
    m = FakeMesh({"data": 16, "model": 16})
    spec = sh.cache_spec(m, (32, 128, 2048, 8, 128), 128)
    assert spec[1] == "data" and "model" in spec
    assert sh.cache_spec(m, (), 128) == sh.P()
    spec1 = sh.cache_spec(m, (48, 1, 48, 64, 128), 1)
    assert spec1[0] is None and spec1[1] is None and "model" in spec1


def test_fleet_shardings_put_the_leading_axis_on_the_fleet():
    mesh = FakeMesh({"fleet": 4})
    got = sh.fleet_shardings(mesh, {"regs": torch.zeros(4, 512, 16),
                                    "oob": torch.zeros(4, dtype=torch.bool),
                                    "pos": 3})
    assert got["regs"].spec == sh.P("fleet", None, None)
    assert got["oob"].spec == sh.P("fleet") and got["pos"] == 3


def test_fleet_spec_and_mesh_axis_helpers_match():
    for nd in (1, 2, 4):
        assert spec_of(sh.fleet_spec(nd)) == spec_of(ref_sh.fleet_spec(nd))
    with pytest.raises(ValueError):
        sh.fleet_spec(0)
    for shape in MESHES:
        m = FakeMesh(shape)
        assert port_mesh.data_axes(m) == ref_mesh.data_axes(m)
        assert port_mesh.batch_divisor(m) == ref_mesh.batch_divisor(m)


# ---------------------------------------------------------------------------
# placements (no ranks: the spec -> placement map only)
# ---------------------------------------------------------------------------

def test_placements_name_the_dim_each_axis_shards():
    from torch.distributed.tensor import Replicate, Shard

    m = FakeMesh({"data": 2, "model": 2})
    assert sh.placements(m, sh.P(None, "data", "model")) == (Shard(1),
                                                              Shard(2))
    assert sh.placements(m, sh.P("model", "data")) == (Shard(1), Shard(0))
    assert sh.placements(m, sh.P()) == (Replicate(), Replicate())
    pod = FakeMesh({"pod": 2, "data": 16, "model": 16})
    assert sh.placements(pod, sh.P(("pod", "data"), None)) == (
        Shard(0), Shard(0), Replicate())
    with pytest.raises(ValueError, match="lacks"):
        sh.placements(m, sh.P("stage"))


def test_mesh_constructors_refuse_what_the_world_cannot_hold():
    # no process group here: the world is this process alone
    with pytest.raises(ValueError, match="needs 256 ranks"):
        port_mesh.make_production_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="needs 512 ranks"):
        port_mesh.make_production_mesh(multi_pod=True, device_type="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        port_mesh.make_fleet_mesh(0, device_type="cpu")
    with pytest.raises(ValueError, match="world has 1"):
        port_mesh.make_fleet_mesh(2, device_type="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            port_mesh.make_mesh((1, 1), ("data", "model"))
    with pytest.raises(ValueError, match="differ in rank"):
        port_mesh.make_mesh((2, 2), ("data",), "cpu")


def test_meta_build_draws_nothing():
    from repro_torch.models import build_model

    model = build_model(get_arch("internvl2-76b"), device="meta")
    assert {p.device.type for p in model.parameters()} == {"meta"}
    assert sum(p.numel() for p in model.parameters()) > 7e10
