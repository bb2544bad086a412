"""The port's mesh layer on worlds of gloo ranks on the host: the sharded
train step, sharded decode, elastic checkpoints, the int8-EF compressed
data-parallel step and the pipeline, each held against the port's own
unsharded path (held to the reference by the LM parity tests) under the bars
of the reference's sharded cases (``tests/multidevice_cases.py``; most
of those are red on this jax). The bars are stated in
``tests/mesh_check.py``.

One world of 4 ranks runs every case, in a subprocess of its own session
(``mesh_check.run``): this process never joins a process group and
never forks. The pipeline's sequential function is also held to the
reference's on the same numpy inputs, here, with no ranks, and the
sharded prefill's gathered logits to the reference's ``forward`` on the
same weights (``convert.lm_params_to_numpy``), within the decode bar.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_check
from mesh_check import case
from repro.configs import get_arch as ref_get_arch
from repro.models import build_model as ref_build_model
from repro_torch import convert
from repro_torch.train.pipeline import sequential_apply, stack_stages

WORLD = 4


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    return {**mesh_check.run(out, list(mesh_check.CASES), WORLD),
            "_out": out}


@pytest.mark.parametrize("shape", ["1x4", "2x2", "4x1"])
def test_sharded_train_step_matches_the_unsharded_step(results, shape):
    got = case(results, "train_step")[shape]
    assert got["loss_err"] < mesh_check.LOSS_ATOL
    assert got["param_err"] < mesh_check.PARAM_ATOL
    # each rank holds only its shards where the mesh has more than one rank
    # along an axis a rule names
    assert got["held_share"] < 1.0
    if shape.startswith("1x"):
        # the case itself asserted bit equality of every leaf
        assert got["loss_err"] == 0.0 and got["param_err"] == 0.0


@pytest.mark.parametrize("shape", ["1x4", "2x2"])
def test_sharded_decode_matches_unsharded_decode(results, shape):
    err = case(results, "decode")[shape]["max_abs_err"]
    assert err <= mesh_check.DECODE_ATOL
    if shape.startswith("1x"):
        assert err == 0.0


@pytest.mark.parametrize("last", ["all", "last"])
@pytest.mark.parametrize("shape", ["2x2", "4x1"])
def test_sharded_prefill_matches_the_reference_forward(results, shape,
                                                       last):
    key = f"{shape}_{last}"
    assert case(results, "prefill")[key]["max_abs_err"] \
        <= mesh_check.DECODE_ATOL
    got = np.load(results["_out"] / f"prefill_{key}.npz")
    cfg = ref_get_arch("granite-3-2b", smoke=True)
    port = mesh_check._model(mesh_check._setup()[0])
    params = jax.tree_util.tree_map(jnp.asarray, convert.lm_params_to_numpy(
        port.cfg, port.state_dict()))
    want = ref_build_model(cfg).forward(
        params, {"tokens": jnp.asarray(got["tokens"])},
        last_only=last == "last")
    assert got["logits"].shape == want.shape
    np.testing.assert_allclose(got["logits"], np.asarray(want),
                               atol=mesh_check.DECODE_ATOL, rtol=0)


def test_elastic_restore_is_bit_identical_and_steps_alike(results):
    assert case(results, "elastic")["loss_err"] < mesh_check.LOSS_ATOL


def test_compressed_dp_step_within_its_bars(results):
    got = case(results, "compressed_dp")
    assert got["loss_err"] < mesh_check.DP_LOSS_ATOL
    assert got["param_err"] < mesh_check.DP_PARAM_ATOL
    assert got["losses"][-1] < got["losses"][0] - mesh_check.DP_DROP


def test_pipeline_matches_sequential_with_gradients(results):
    got = case(results, "pipeline")
    assert got["max_abs_err"] < mesh_check.PP_ATOL
    assert got["grad_max_abs_err"] < mesh_check.PP_GRAD_ATOL


def test_every_case_ran_in_one_world(results):
    assert results["_run"]["rc"] == 0, results["_run"]
    for name in mesh_check.CASES:
        assert f"PASS {name}" in results["_run"]["stdout"]


@pytest.mark.parametrize("stages", [1, 2, 4, 8])
def test_sequential_stages_match_the_references_scan(stages):
    layers, x = mesh_check.pipeline_inputs()
    M, B, D = x.shape

    def ref_seq(params, x):
        def body(h, lp):
            return jnp.tanh(h @ lp["w"] + lp["b"]), None
        h, _ = jax.lax.scan(body, x.reshape(M * B, D), params)
        return h.reshape(M, B, D)

    want = np.asarray(ref_seq({k: jnp.asarray(v) for k, v in layers.items()},
                              jnp.asarray(x)))
    staged = stack_stages({k: torch.from_numpy(v) for k, v in layers.items()},
                          stages)
    got = sequential_apply(mesh_check.stage_fn, staged, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_stack_stages_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="do not split"):
        stack_stages({"w": torch.zeros(6, 2)}, 4)
