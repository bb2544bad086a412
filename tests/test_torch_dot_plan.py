"""The plan of the ``wavefront_dot`` kernel (``csrc/dot.cu``), emulated in
PyTorch on the host and held to the plain version and to the reference.

The emulation follows the kernel step by step: CTAs of 128 threads, one
wavefront a thread (the last CTA's threads past n_sm * 32 return); a
thread's four 16-byte loads of its wavefront's a and of its b into
registers 4k..4k+3, and one of its 16 mask bytes; the lane terms and the
chain from +0.0, lane 0 to 15, with the card's FTZ multiply and add; and
the wavefront summed again with ``ref.fp_binop``/``fp_add`` where the
kernel does so. The card's FTZ ops are modelled both ways a product's
tininess could be judged (after or before rounding): the plan must equal
``wavefront_dot_ref`` and the reference's Pallas kernel (interpret mode)
word for word under either. Keep it in step with the kernel when either
changes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wavefront_dot import wavefront_dot as jax_wavefront_dot
from repro_torch.kernels import fuzz, ref

CTA = 128                  # a CTA's threads, one wavefront each
WARP = 32
LANES = 16
CHUNKS = LANES // 4        # 16-byte chunks of a wavefront's a or b
SECTOR = 32                # bytes
MIN_NORMAL = 0x00800000
CARD_NAN = 0x7FFFFFFF      # the card's NaN, whatever the operands


def op_ftz(op: int, a: torch.Tensor, b: torch.Tensor,
           tiny_before_rounding: bool) -> torch.Tensor:
    """A model of the card's ``mul.rn.ftz``/``add.rn.ftz`` on words:
    denormal operands read as signed zeros, one rounding, a denormal
    result (for a product also, where ``tiny_before_rounding``, one whose
    exact value lies below 2**-126) written as a signed zero, and one NaN
    for every NaN result."""
    fa, fb = ref.flush_denormal(a), ref.flush_denormal(b)
    x, y = fa.view(torch.float32), fb.view(torch.float32)
    r = (x + y if op == ref.ALU_ADD else x * y).view(torch.int32)
    tiny = (r & 0x7F800000) == 0
    if op != ref.ALU_ADD and tiny_before_rounding:
        exact = x.to(torch.float64) * y.to(torch.float64)
        tiny |= exact.abs() < 2.0 ** -126
    r = torch.where(tiny, r & ref._SIGN, r)
    return torch.where(ref.is_nan(r), CARD_NAN, r)


def tiny(op: int, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor
         ) -> torch.Tensor:
    """The kernel's test that an FTZ term of a and b may differ from
    ``fp_binop``'s word though it is not a NaN: a product at or below
    2**-126 in magnitude from operands whose exponent fields are not
    zero. A sum never does."""
    if op == ref.ALU_ADD:
        return torch.zeros(w.shape, dtype=torch.bool)
    normal = torch.minimum(a & 0x7F800000, b & 0x7F800000) != 0
    return ((w & 0x7FFFFFFF) <= MIN_NORMAL) & normal


def wavefront_sums(va, vb, on, op, tiny_before_rounding):
    """The kernel's ``wavefront_sum`` over rows of 16 lanes."""
    acc = torch.zeros(va.shape[0], dtype=torch.int32)
    fast = torch.ones(va.shape[0], dtype=torch.bool)
    for lane in range(LANES):
        x = op_ftz(op, va[:, lane], vb[:, lane], tiny_before_rounding)
        fast &= ~(on[:, lane] & tiny(op, x, va[:, lane], vb[:, lane]))
        acc = op_ftz(ref.ALU_ADD, acc, torch.where(on[:, lane], x, 0),
                     tiny_before_rounding)
    again = ~fast | ref.is_nan(acc)
    exact = torch.zeros_like(acc)
    terms = torch.where(on, ref.fp_binop(op, va, vb), 0)
    for lane in range(LANES):
        exact = ref.fp_add(exact, terms[:, lane])
    return torch.where(again, exact, acc), again


def loads(n_waves: int):
    """Per CTA, per thread that does not return: its wavefront, the four
    16-byte pieces of a (and of b) it loads and its mask piece."""
    for cta in range(-(-n_waves // CTA)):
        w = cta * CTA + torch.arange(CTA)
        w = w[w < n_waves]
        yield w, w[:, None] * CHUNKS + torch.arange(CHUNKS)[None, :], w


def emulate_dot_kernel(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor,
                       mode: int, tiny_before_rounding: bool = False
                       ) -> torch.Tensor:
    """``(n_sm, 512)`` int32 words ``a``, ``b`` and bool ``mask`` ->
    ``(n_sm, 32)`` int32 words, CTA by CTA as ``csrc/dot.cu`` runs."""
    n_sm = a.shape[0]
    n_waves = n_sm * 32
    ga, gb = a.reshape(-1, 4), b.reshape(-1, 4)        # 16-byte pieces
    gm = mask.to(torch.uint8).reshape(n_waves, LANES)  # a wavefront's piece
    op = ref.ALU_MUL if mode == 0 else ref.ALU_ADD
    out = torch.zeros(n_waves, dtype=torch.int32)
    done = torch.zeros(n_waves, dtype=torch.bool)
    for w, pieces, mpiece in loads(n_waves):
        va = ga[pieces].reshape(-1, LANES)             # registers 4k..4k+3
        vb = gb[pieces].reshape(-1, LANES)
        on = gm[mpiece] != 0
        out[w], _ = wavefront_sums(va, vb, on, op, tiny_before_rounding)
        assert not done[w].any()
        done[w] = True
    assert done.all()
    return out.reshape(n_sm, 32)


def _inputs(rng, n_sm: int, tiny: bool, mode: int):
    """Fuzzed words (NaNs, infinities, denormals, signed zeros), or DOT
    products and SUM sums around 2**-126, with a random mask, wavefront 1
    of each SM all off, and NaNs under the disabled lane 5 of every SM."""
    if not tiny:
        a = fuzz.random_f32_words(rng, (n_sm, 512))
        b = fuzz.random_f32_words(rng, (n_sm, 512))
    else:
        pa, pb = fuzz.tiny_product_words(rng, (2, n_sm, 512))
        a, b = (pa[0], pb[0]) if mode == 0 else (pb[0], pb[1])
    mask = rng.random((n_sm, 512)) < 0.6
    mask[:, 16:32] = False
    mask[:, 5] = False
    a[:, 5] = 0x7FC00001
    b[:, 5] = 0xFF800001
    return a, b, mask


def _torch_words(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


@pytest.mark.parametrize("tiny_before_rounding", [False, True])
@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("n_sm", [1, 3, 8, 24, 37])
def test_plan_equals_plain_version_and_reference(n_sm, mode, tiny,
                                                 tiny_before_rounding):
    rng = np.random.default_rng([n_sm, mode, tiny])
    a, b, mask = _inputs(rng, n_sm, tiny, mode)
    got = emulate_dot_kernel(_torch_words(a), _torch_words(b),
                             torch.from_numpy(mask), mode,
                             tiny_before_rounding=tiny_before_rounding)
    plain = ref.wavefront_dot_ref(_torch_words(a).view(torch.float32),
                                  _torch_words(b).view(torch.float32),
                                  torch.from_numpy(mask), mode)
    assert torch.equal(got, plain.view(torch.int32))
    # the reference's Pallas kernel, in interpret mode on the host
    jax_out = jax_wavefront_dot(
        jnp.asarray(a.view(np.float32)), jnp.asarray(b.view(np.float32)),
        jnp.asarray(mask.astype(np.float32)), jnp.int32(mode),
        block_sm=8 if n_sm % 8 == 0 else 1)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(jax_out).view(np.uint32))
    # an all-off wavefront sums to +0.0
    assert (got[:, 1] == 0).all()


@pytest.mark.parametrize("mode", [0, 1])
def test_plan_sums_normal_inputs_without_the_exact_path(mode):
    # the exact path is for NaNs and products at or below 2**-126: the
    # timing rows' normal inputs never take it
    rng = np.random.default_rng(mode)
    va, vb = (torch.from_numpy(rng.standard_normal((4096, LANES)).astype(
        np.float32)).view(torch.int32) for _ in range(2))
    on = torch.ones((4096, LANES), dtype=torch.bool)
    op = ref.ALU_MUL if mode == 0 else ref.ALU_ADD
    _, again = wavefront_sums(va, vb, on, op, False)
    assert not again.any()


@pytest.mark.parametrize("tiny_before_rounding", [False, True])
@pytest.mark.parametrize("op", [ref.ALU_MUL, ref.ALU_ADD])
def test_kept_ftz_terms_equal_fp_binop(op, tiny_before_rounding):
    # wherever the kernel keeps an FTZ term (not tiny) that is not a NaN,
    # it is fp_binop's word, under either model of the card's tininess; a
    # NaN term makes the FTZ sum a NaN, which the kernel sums again; and
    # it keeps most results of the fuzzed words (the first 8192), whose
    # products are seldom tiny
    rng = np.random.default_rng([op, tiny_before_rounding])
    pa, pb = fuzz.tiny_product_words(rng, (2, 4096))
    a = np.concatenate([fuzz.random_f32_words(rng, 8192), pa[0], pb[1]])
    b = np.concatenate([fuzz.random_f32_words(rng, 8192), pb[0], pb[0]])
    a, b = _torch_words(a), _torch_words(b)
    x = op_ftz(op, a, b, tiny_before_rounding)
    keep = ~tiny(op, x, a, b) & ~ref.is_nan(x)
    assert torch.equal(x[keep], ref.fp_binop(op, a, b)[keep])
    assert keep[:8192].float().mean() > 0.6
    assert torch.equal(ref.is_nan(x), ref.is_nan(ref.fp_binop(op, a, b)))


@pytest.mark.parametrize("zero", [0, 0x80000000, 0x00000001, 0x807FFFFF])
def test_plan_sums_zero_padded_inputs_without_the_exact_path(zero):
    # a zero, or a denormal read as one, in an enabled lane of a gives an
    # exact signed zero product: the exact path is not taken for it
    rng = np.random.default_rng(zero)
    va, vb = (torch.from_numpy(rng.standard_normal((4096, LANES)).astype(
        np.float32)).view(torch.int32) for _ in range(2))
    va[:, 12:] = torch.tensor(zero, dtype=torch.int64).to(torch.int32)
    va[::3, 0] = va[::3, 12]
    on = torch.ones((4096, LANES), dtype=torch.bool)
    got, again = wavefront_sums(va, vb, on, ref.ALU_MUL, False)
    assert not again.any()
    exact = torch.zeros_like(got)
    for lane in range(LANES):
        exact = ref.fp_add(exact, ref.fp_binop(ref.ALU_MUL, va[:, lane],
                                               vb[:, lane]))
    assert torch.equal(got, exact)


@pytest.mark.parametrize("n_sm", [1, 3, 4, 5, 37])
def test_loads_cover_every_piece_once_in_whole_sectors(n_sm):
    # every 16-byte piece of a (and of b) and every mask piece is loaded
    # by one thread, and a warp's four loads of a cover its contiguous
    # 2 KiB in whole 32-byte sectors (each fetched once, half from L1)
    n_waves = n_sm * 32
    seen = torch.zeros(n_waves * CHUNKS, dtype=torch.int64)
    seen_m = torch.zeros(n_waves, dtype=torch.int64)
    for w, pieces, mpiece in loads(n_waves):
        seen.index_add_(0, pieces.flatten(), torch.ones(pieces.numel(),
                                                        dtype=torch.int64))
        seen_m.index_add_(0, mpiece, torch.ones_like(mpiece))
        for q in range(0, w.numel(), WARP):
            warp = pieces[q:q + WARP]
            assert warp.numel() == WARP * CHUNKS       # whole warps only
            span = torch.arange(warp.min(), warp.min() + WARP * CHUNKS)
            assert torch.equal(warp.flatten().sort().values, span)
            sectors = (warp * 16) // SECTOR
            counts = torch.bincount(sectors.flatten() - sectors.min())
            assert (counts == SECTOR // 16).all()
            assert torch.equal(mpiece[q:q + WARP],
                               torch.arange(mpiece[q], mpiece[q] + WARP))
    assert (seen == 1).all() and (seen_m == 1).all()
