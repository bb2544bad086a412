"""The port's kernel layer against the reference's: ``ops.dot`` and
``ops.fft`` (plain versions on the host) vs ``repro.kernels.ops`` (Pallas
in interpret mode), on the same numpy-seeded inputs.

Bars: ``dot`` is equal word for word (NaNs, infinities, denormals and
signed zeros included). ``fft`` is within ``3e-5 * max|X|`` of the
reference's kernel, the reference's own bar against ``numpy.fft``: the
port rounds every operation of the butterfly, where the reference's
compiled code contracts the twiddle rotation into fused multiply-adds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.programs import run_fft
from repro_torch.kernels import fuzz, ops, ref
from repro_torch.kernels.fft_r2 import _twiddle_table, fft_r2, fft_r2_plain
from repro_torch.kernels.wavefront_dot import wavefront_dot


def _u32(x) -> np.ndarray:
    return np.asarray(x).view(np.uint32)


# ---------------------------------------------------------------------------
# dot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("n_sm", [8, 24])
def test_dot_equals_reference_on_fuzzed_words(mode, n_sm):
    rng = np.random.default_rng(100 * n_sm + mode)
    for _ in range(3):
        a = fuzz.random_f32_words(rng, (n_sm, 512)).view(np.float32)
        b = fuzz.random_f32_words(rng, (n_sm, 512)).view(np.float32)
        m = rng.integers(0, 2, (n_sm, 512)).astype(np.float32)
        want = jops.dot(jnp.asarray(a), jnp.asarray(b), jnp.asarray(m),
                        mode=mode)
        got = ops.dot(a, b, m, mode, device="cpu")
        assert got.dtype == torch.float32 and got.shape == (n_sm, 32)
        np.testing.assert_array_equal(_u32(got.numpy()), _u32(want))


@pytest.mark.parametrize("mode", [0, 1])
def test_dot_without_a_mask_sums_every_lane(mode):
    rng = np.random.default_rng(mode)
    a, b = (rng.standard_normal((8, 512)).astype(np.float32)
            for _ in range(2))
    want = jops.dot(jnp.asarray(a), jnp.asarray(b), mode=mode)
    np.testing.assert_array_equal(
        _u32(ops.dot(a, b, mode=mode, device="cpu").numpy()), _u32(want))


def test_dot_flexible_width_mask():
    # quarter-width wavefronts: only lanes 0..3 contribute
    a = np.ones((8, 512), np.float32)
    lane = np.tile(np.arange(16), 32 * 8).reshape(8, 512)
    m = (lane < 4).astype(np.float32)
    got = ops.dot(a, a, m, 0, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.full((8, 32), 4.0))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.dot(jnp.asarray(a), jnp.asarray(a),
                                         jnp.asarray(m), mode=0)))


def test_dot_masked_nan_does_not_leak():
    a = np.ones((8, 512), np.float32)
    a[:, 5] = np.nan
    m = np.ones((8, 512), np.float32)
    m[:, 5] = 0
    got = ops.dot(a, a, m, 0, device="cpu").numpy()
    assert got[:, 0].tolist() == [15.0] * 8
    assert np.isfinite(got).all()


def test_dot_ref_matches_reference_ref_on_normal_values():
    rng = np.random.default_rng(11)
    a, b = (rng.standard_normal((3, 512)).astype(np.float32)
            for _ in range(2))
    m = rng.random((3, 512)) < 0.5
    want = jref.wavefront_dot_ref(jnp.asarray(a), jnp.asarray(b),
                                  jnp.asarray(m))
    got = ref.wavefront_dot_ref(torch.from_numpy(a), torch.from_numpy(b),
                                torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)


def test_dot_checks_its_arguments():
    x = torch.zeros((12, 512))
    m = torch.ones((12, 512), dtype=torch.bool)
    with pytest.raises(ValueError, match="block_sm"):
        wavefront_dot(x, x, m, 0, block_sm=8)
    with pytest.raises(ValueError, match="512"):
        wavefront_dot(torch.zeros((8, 256)), torch.zeros((8, 256)),
                      torch.ones((8, 256), dtype=torch.bool))
    assert wavefront_dot(x, x, m, 0, block_sm=4).shape == (12, 32)


# ---------------------------------------------------------------------------
# fft
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("natural", [True, False])
@pytest.mark.parametrize("n", [32, 64, 256, 1024])
def test_fft_matches_reference(n, natural):
    rng = np.random.default_rng(n + natural)
    re, im = (rng.standard_normal((8, n)).astype(np.float32)
              for _ in range(2))
    wr, wi = jops.fft(jnp.asarray(re), jnp.asarray(im), natural=natural)
    gr, gi = ops.fft(re, im, natural=natural, device="cpu")
    scale = np.abs(np.asarray(wr)).max()
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), rtol=0,
                               atol=3e-5 * scale)
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), rtol=0,
                               atol=3e-5 * scale)
    # and the numeric oracle, in the matching order
    oracle = ref.fft_r2_ref if natural else ref.fft_r2_ref_br
    orr, oi = oracle(torch.from_numpy(re), torch.from_numpy(im))
    np.testing.assert_allclose(gr.numpy(), orr.numpy(), rtol=0,
                               atol=3e-5 * scale)
    np.testing.assert_allclose(gi.numpy(), oi.numpy(), rtol=0,
                               atol=3e-5 * scale)


def test_fft_small_sizes_match_the_dft():
    rng = np.random.default_rng(3)
    for n in (1, 2, 4, 8, 16):
        x = (rng.standard_normal((3, n))
             + 1j * rng.standard_normal((3, n))).astype(np.complex64)
        gr, gi = ops.fft(x.real, x.imag, device="cpu")
        want = np.fft.fft(x.astype(np.complex128), axis=1)
        np.testing.assert_allclose(gr.numpy() + 1j * gi.numpy(), want,
                                   rtol=0, atol=3e-6 * np.abs(want).max())


def test_fft_twiddle_table_is_the_reference_table():
    from repro.kernels.fft_r2 import _twiddle_table as j_twiddle_table

    for n in (2, 64, 1024):
        np.testing.assert_array_equal(_twiddle_table(n), j_twiddle_table(n))
    np.testing.assert_array_equal(ref.bitrev(256).numpy(), jref.bitrev(256))


def test_fft_agrees_with_the_iss():
    """Cross-layer: the kernel layer's FFT vs the port's eGPU running the
    paper's assembly FFT (step engine, plain versions)."""
    rng = np.random.default_rng(9)
    x = (rng.standard_normal(256)
         + 1j * rng.standard_normal(256)).astype(np.complex64)
    x_iss, _ = run_fft(x, backend="cpu")
    gr, gi = ops.fft(np.real(x)[None], np.imag(x)[None], device="cpu")
    got = gr.numpy()[0] + 1j * gi.numpy()[0]
    np.testing.assert_allclose(got, x_iss, rtol=0,
                               atol=1e-4 * np.abs(x_iss).max())


def test_fft_checks_its_arguments():
    x = torch.zeros((8, 48))
    with pytest.raises(ValueError, match="power of two"):
        fft_r2(x, x)
    y = torch.zeros((12, 64))
    with pytest.raises(ValueError, match="block_b"):
        fft_r2(y, y, block_b=8)
    assert fft_r2(y, y, block_b=4)[0].shape == (12, 64)
    # the plain version is what the host wrapper returns
    for g, w in zip(fft_r2(y + 1, y, block_b=4), fft_r2_plain(y + 1, y)):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# the entry points' placement
# ---------------------------------------------------------------------------

def test_ops_on_arrays_go_to_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: arrays run there")
    x = np.ones((8, 512), np.float32)
    a = np.ones((2, 4, 4), np.float32)
    s = np.ones((1, 64, 16), np.float32)
    for call in (lambda: ops.dot(x, x), lambda: ops.fft(x, x),
                 lambda: ops.qrd(a), lambda: ops.flash(s, s, s, blk_q=64,
                                                       blk_k=64),
                 lambda: ops.alu(1, 0, x.view(np.uint32), x.view(np.uint32),
                                 x.view(np.uint32), x.view(np.uint32))):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            call()


def test_ops_tensors_run_where_they_lie():
    x = torch.ones((8, 512))
    out = ops.dot(x, x)
    assert out.device.type == "cpu" and out[0, 0].item() == 16.0
    r, i = ops.fft(torch.ones((2, 8)), torch.zeros((2, 8)))
    assert r.device.type == "cpu" and r[0, 0].item() == 8.0


def test_ops_alu_matches_reference_alu():
    from repro.kernels import ref as jref_alu

    rng = np.random.default_rng(21)
    a, b, old = (rng.integers(0, 2**32, (8, 512), dtype=np.uint32)
                 for _ in range(3))
    mask = rng.integers(0, 2, (8, 512), dtype=np.uint32)
    for op, typ in ((1, 0), (3, 1), (9, 0), (3, 2)):
        got = ops.alu(op, typ, a, b, mask, old, device="cpu")
        want = np.where(mask != 0, np.asarray(jref_alu.alu_ref(
            jnp.int32(op), jnp.int32(typ), jnp.asarray(a), jnp.asarray(b))),
            old)
        same = _u32(got.numpy()) == want
        nan = np.isnan(got.numpy().view(np.float32)) & np.isnan(
            want.view(np.float32))
        assert (same | nan).all(), (op, typ)
