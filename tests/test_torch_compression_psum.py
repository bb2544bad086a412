"""``optim.compression.compressed_psum`` against the reference's under
``jax.vmap(..., axis_name="data")`` on the same numpy-seeded gradients
and carried residuals (``mesh_check.psum_inputs``: 4 ranks, leaves whose
per-rank scales span 1e-3...1e2).

The port's runs on a world of 4 gloo ranks in a subprocess of its own
session (``mesh_check.run``), each rank writing its results; the
reference's runs here, in one process. Bars: the int32 payload sums and
the EF residuals ``==``; the mean gradients within 1 float32 ulp, since
the order in which the ranks' scales are summed may differ.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_check
from mesh_check import case
from repro.optim import compression as ref_compression
from repro_torch.optim import compression

WORLD = 4


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    out = tmp_path_factory.mktemp("psum")
    res = mesh_check.run(out, ["psum"], WORLD)
    case(res, "psum")
    return [dict(np.load(out / f"psum_{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def reference():
    grads, errs = mesh_check.psum_inputs(WORLD)
    g = {k: jnp.asarray(v) for k, v in grads.items()}
    e = {k: jnp.asarray(v) for k, v in errs.items()}

    def one(g, e):
        ef = ref_compression.EFState(error=e)
        mean, ef2 = ref_compression.compressed_psum(g, ef, "data", WORLD)
        qs, _, _ = ref_compression.compress(g, ef)
        sums = jax.tree_util.tree_map(
            lambda q: jax.lax.psum(q.astype(jnp.int32), "data"), qs)
        return sums, mean, ef2.error

    sums, mean, err = jax.vmap(one, axis_name="data")(g, e)
    return {"sum": sums, "mean": mean, "ef": err}


@pytest.mark.parametrize("rank", range(WORLD))
def test_payload_sums_equal_the_references(port, reference, rank):
    for k in mesh_check.PSUM_SHAPES:
        got = port[rank][f"sum/{k}"]
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, np.asarray(reference["sum"][k])[rank])


@pytest.mark.parametrize("rank", range(WORLD))
def test_residuals_equal_the_references(port, reference, rank):
    for k in mesh_check.PSUM_SHAPES:
        np.testing.assert_array_equal(port[rank][f"ef/{k}"],
                                      np.asarray(reference["ef"][k])[rank])


@pytest.mark.parametrize("rank", range(WORLD))
def test_mean_within_one_ulp_of_the_references(port, reference, rank):
    for k in mesh_check.PSUM_SHAPES:
        got = port[rank][f"mean/{k}"]
        assert got.dtype == np.float32
        np.testing.assert_array_max_ulp(
            got, np.asarray(reference["mean"][k])[rank], maxulp=1)


def test_every_rank_holds_the_same_mean(port):
    for k in mesh_check.PSUM_SHAPES:
        for r in range(1, WORLD):
            np.testing.assert_array_equal(port[r][f"mean/{k}"],
                                          port[0][f"mean/{k}"])


def test_compressed_psum_needs_a_process_group():
    # this process is in no world: the collective refuses, no fallback
    grads = {"a": torch.ones(3)}
    with pytest.raises((RuntimeError, ValueError)):
        compression.compressed_psum(grads, compression.init_ef(grads),
                                    None, 1)
