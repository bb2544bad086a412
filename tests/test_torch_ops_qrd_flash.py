"""The port's kernel layer against the reference's: ``ops.qrd`` and
``ops.flash`` (plain versions on the host) vs ``repro.kernels.ops`` and
``repro.kernels.flash_attention`` (Pallas in interpret mode), on the same
numpy-seeded inputs.

Bars: ``qrd`` within ``atol=2e-5`` (the reference's own bar between its
kernel and its oracle): the port sums each inner product index by index
and takes the correctly rounded INVSQR, where the reference's compiled
sums take another order and its ``rsqrt`` is within one ulp of that
(ROADMAP §C). ``flash`` in float32 within ``atol=2e-5``; in bfloat16
within one bf16 ulp of the value (``rtol=2**-7``) plus ``1e-5``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_attention import flash_attention_ref as j_flash_ref
from repro_torch.core.programs import run_qrd
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.mgs_qrd import mgs_qrd

# ---------------------------------------------------------------------------
# qrd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch,n", [(32, 16), (64, 16), (32, 8), (32, 32)])
def test_qrd_matches_reference(batch, n):
    # the reference sweep's cases and seeds
    rng = np.random.default_rng(1000 * batch + n)
    a = rng.standard_normal((batch, n, n)).astype(np.float32)
    wq, wr = jops.qrd(jnp.asarray(a), block_b=32)
    gq, gr = ops.qrd(a, block_b=32, device="cpu")
    np.testing.assert_allclose(gq.numpy(), np.asarray(wq), rtol=0, atol=2e-5)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), rtol=0, atol=2e-5)
    # the reference's oracle too
    oq, orr = jref.mgs_qrd_ref(jnp.asarray(a))
    np.testing.assert_allclose(gq.numpy(), np.asarray(oq), rtol=0, atol=2e-5)
    np.testing.assert_allclose(gr.numpy(), np.asarray(orr), rtol=0,
                               atol=2e-5)


def test_qrd_factorization_properties():
    rng = np.random.default_rng(42)
    a = rng.standard_normal((32, 16, 16)).astype(np.float32)
    q, r = (x.numpy() for x in ops.qrd(a, device="cpu"))
    np.testing.assert_allclose(np.einsum("bij,bjk->bik", q, r), a, atol=5e-5)
    for i in range(32):
        np.testing.assert_allclose(q[i].T @ q[i], np.eye(16), atol=5e-5)
        assert np.abs(np.tril(r[i], -1)).max() < 1e-5


def test_qrd_agrees_with_the_iss():
    """Cross-layer: the kernel layer's QRD vs the port's eGPU running the
    paper's assembly (step engine, plain versions)."""
    a = np.random.default_rng(7).standard_normal((16, 16)).astype(np.float32)
    q_iss, r_iss, _ = run_qrd(a, backend="cpu")
    q, r = ops.qrd(np.repeat(a[None], 32, 0), block_b=32, device="cpu")
    np.testing.assert_allclose(q.numpy()[0], q_iss, atol=2e-4)
    np.testing.assert_allclose(r.numpy()[0], r_iss, atol=2e-4)


def test_qrd_takes_the_column_by_index_where_the_reference_multiplies():
    # the reference selects column j as sum_k res[:, k] * onehot[k]: an
    # infinity anywhere in a row of the residual makes that row of column
    # j NaN (inf * 0). The port indexes column j, so it departs from the
    # reference exactly on non-finite inputs (ROADMAP §C).
    rng = np.random.default_rng(1)
    a = rng.standard_normal((2, 8, 8)).astype(np.float32)
    a[0, 3, 5] = np.inf
    wq, _ = jops.qrd(jnp.asarray(a))
    gq, _ = ops.qrd(a, device="cpu")
    wq, gq = np.asarray(wq), gq.numpy()
    assert np.isnan(wq[0, 3, 0])            # reference: NaN in column 0
    assert np.isfinite(gq[0, :, :5]).all()  # port: columns before 5 finite
    # the matrix without an infinity agrees
    np.testing.assert_allclose(gq[1], wq[1], rtol=0, atol=2e-5)


def test_qrd_checks_its_arguments():
    with pytest.raises(ValueError, match="square"):
        mgs_qrd(torch.zeros((4, 8, 6)))
    with pytest.raises(ValueError, match="block_b"):
        mgs_qrd(torch.zeros((48, 4, 4)), block_b=32)
    q, r = mgs_qrd(torch.eye(4).repeat(48, 1, 1), block_b=16)
    assert torch.equal(q, torch.eye(4).repeat(48, 1, 1))
    assert torch.equal(r, q)


# ---------------------------------------------------------------------------
# flash
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,d,blk,causal", [(256, 64, 64, True),
                                            (256, 64, 32, True),
                                            (128, 64, 64, False)])
def test_flash_matches_reference(s, d, blk, causal):
    rng = np.random.default_rng(s + blk + causal)
    bh = 2 if causal else 4
    q, k, v = (rng.standard_normal((bh, s, d)).astype(np.float32)
               for _ in range(3))
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, blk_q=blk, blk_k=blk)
    got = ops.flash(q, k, v, causal=causal, blk_q=blk, blk_k=blk,
                    device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)
    oracle = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                     causal=causal)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=0,
                               atol=2e-5)


def test_flash_unequal_blocks_match_the_oracle():
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 128, 32)).astype(
        np.float32)) for _ in range(3))
    for blk_q, blk_k in ((64, 32), (32, 64), (128, 16)):
        got = flash_attention(q, k, v, blk_q=blk_q, blk_k=blk_k)
        torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v),
                                   atol=2e-5, rtol=0)


def test_flash_oracle_matches_reference_oracle():
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 64, 16)).astype(np.float32)
               for _ in range(3))
    for causal in (True, False):
        want = j_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal)
        got = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                      causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2e-6)


def test_flash_bfloat16_matches_reference_oracle():
    # bf16 in, bf16 out, float32 inside: the port's blocked recurrence and
    # the reference's plain softmax differ by about 1e-6 before the final
    # rounding, so at most one bf16 ulp of the value after it
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 128, 64)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    got = ops.flash(q, k, v, blk_q=64, blk_k=32)
    assert got.dtype == torch.bfloat16
    want = j_flash_ref(*(jnp.asarray(x.float().numpy(), jnp.bfloat16)
                         for x in (q, k, v)))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2.0 ** -7, atol=1e-5)
    torch.testing.assert_close(
        got.float(), ref.flash_attention_ref(q, k, v).float(),
        rtol=2.0 ** -7, atol=1e-5)


def test_flash_on_float64_arrays_runs_in_float32():
    rng = np.random.default_rng(8)
    q = rng.standard_normal((1, 64, 16))
    got = ops.flash(q, q, q, blk_q=32, blk_k=32, device="cpu")
    assert got.dtype == torch.float32
    want = j_flash(*(jnp.asarray(q) for _ in range(3)), blk_q=32, blk_k=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


def test_flash_checks_its_arguments():
    x = torch.zeros((1, 96, 16))
    with pytest.raises(ValueError, match="multiple of blk_q/blk_k"):
        flash_attention(x, x, x, blk_q=64, blk_k=32)
    with pytest.raises(ValueError, match="multiple of blk_q/blk_k"):
        flash_attention(x, x, x, blk_q=32, blk_k=64)
    out = flash_attention(x, x, x, blk_q=32, blk_k=32)
    assert torch.equal(out, flash_attention_plain(x, x, x, True, 32, 32))
