"""The execute stage's GLD and GST rows: the global port's row seam on the
CPU.

  * ``gld_row_plain`` / ``gst_row_plain`` (the ``"cpu"`` backend's
    ``gld_row``/``gst_row``, the plain versions the GLD and GST row
    kernels are held against on the card) equal the reference's
    ``make_data_handlers`` GLD and GST handlers on the same seeded state,
    word for word: plain, snooped (``rd`` its own address source) and
    predicated (``preg == rd``) rows; addresses below 0, at ``gdepth``
    and at +-2**31; collisions inside an SM and across SMs, where the
    later SM wins; images of 64 and 4096 words and one whose GST claims
    do not fit a CTA's shared memory, where the GST kernel keeps them in
    device memory (``gst_scratch``);
  * the wrappers take the plain versions on host tensors, and check their
    arguments.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SMConfig as JSMConfig
from repro.core.executor import get_execute_backend as j_get_backend
from repro.core.executor import make_data_handlers as j_make_data_handlers
from repro_torch.core import SMConfig
from repro_torch.core.executor import FIELDS, FusedRow, get_execute_backend
from repro_torch.core.isa import Op
from repro_torch.kernels import fuzz
from repro_torch.kernels.build import MAX_DYNAMIC_SMEM
from repro_torch.kernels.simt_step import (check_gld_row_args,
                                           check_gst_row_args,
                                           gld_row_plain, gst_row_plain,
                                           gst_scratch, gst_scratch_words,
                                           simt_gld_row, simt_gst_row)

N_SMS = 3
GLD, GST = int(Op.GLD), int(Op.GST)
# an image whose GST claims do not fit a CTA's shared memory
LARGE = 70_000


def _row(**f) -> FusedRow:
    base = dict(sel=8, opcode=GLD, typ=0, rd=0, ra=0, rb=0, imm=0, x=0,
                ext_a=0, ext_b=0, pen=0, preg=0, pneg=0, act_waves=32,
                act_wthreads=16)
    base.update(f)
    return FusedRow.from_fields([base[k] for k in FIELDS])


def _reference(row: FusedRow, n_threads, regs, gmem, oob):
    """The reference's GLD or GST handler for ``row`` on numpy state;
    returns numpy ``(regs, gmem, oob)``."""
    tid = np.arange(512)
    active = ((tid % 16 < row.act_wthreads) & (tid // 16 < row.act_waves)
              & (tid < n_threads))
    d = {k: jnp.int32(v) for k, v in row.d.items()}
    n = regs.shape[0]
    zero = jnp.zeros(n, jnp.int32)
    h = j_make_data_handlers(JSMConfig(n_threads=n_threads, dim_x=n_threads),
                             j_get_backend("inline"), d, jnp.asarray(active),
                             zero, zero)[row.sel]
    out = h((jnp.asarray(regs), jnp.zeros((n, 16), jnp.uint32),
             jnp.asarray(gmem), jnp.asarray(oob)))
    return np.asarray(out[0]), np.asarray(out[2]), np.asarray(out[3])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


def _state(rng, gdepth):
    """Registers 0-3 address the image: R0 around it, R1 on a few words
    (collisions inside and across SMs), R2 around its end, R3 anywhere
    in 32 bits, with 0, -1, gdepth - 1, gdepth and +-2**31 among them."""
    regs, _ = fuzz.random_state(rng, N_SMS, gdepth)
    regs[:, :, 1] = rng.integers(-3, 5, (N_SMS, 512))
    regs[:, :, 2] = rng.integers(gdepth - 8, gdepth + 8, (N_SMS, 512))
    regs[:, :, 3] = rng.integers(-2**31, 2**31, (N_SMS, 512))
    edges = np.array([0, -1, gdepth - 1, gdepth, -2**31, 2**31 - 1])
    regs[:, :6, 3] = edges.astype(np.int64).astype(np.uint32)
    gmem = fuzz.random_f32_words(rng, (gdepth,))
    return regs, gmem


def _rows(rng, sel, variant):
    """(row, n_threads) over every address register and immediates that
    wrap or step past an edge."""
    op = GLD if sel == 8 else GST
    for ra in (0, 1, 2, 3):
        for imm in (0, 1, -1, -16380):
            rd = int(rng.integers(4, 16))
            f = dict(sel=sel, opcode=op, ra=ra, imm=imm, rd=rd)
            if variant == "snoop":          # rd is its own address source
                f.update(x=1, rd=ra, ext_a=int(rng.integers(0, 32)),
                         act_waves=16)
            if variant == "pred":           # and the predicate is rd
                f.update(pen=1, preg=rd, pneg=int(imm < 0), act_wthreads=8)
            yield _row(**f), 200 if imm == -1 else 512


@pytest.mark.parametrize("gdepth", [64, 4096, LARGE])
@pytest.mark.parametrize("variant", ["plain", "snoop", "pred"])
def test_gld_row_plain_matches_reference_handler(gdepth, variant):
    assert 4 * gst_scratch_words(LARGE, 0) > MAX_DYNAMIC_SMEM
    rng = np.random.default_rng(gdepth + len(variant))
    regs, gmem = _state(rng, gdepth)
    oob = np.array([False, True, False])
    loaded = flagged = False
    for row, n_threads in _rows(rng, 8, variant):
        cfg = SMConfig(n_threads=n_threads, dim_x=n_threads)
        want = _reference(row, n_threads, regs, gmem, oob)
        got = gld_row_plain(cfg, row, _t(regs), _t(gmem),
                            torch.from_numpy(oob))
        assert np.array_equal(_u32(got[0]), want[0]), (row, "regs")
        assert np.array_equal(got[1].numpy(), want[2]), (row, "oob")
        # the wrapper takes the plain version on host tensors
        got = simt_gld_row(cfg, row, _t(regs), _t(gmem),
                           torch.from_numpy(oob))
        assert np.array_equal(_u32(got[0]), want[0]), (row, "regs")
        rd = row.d["rd"]
        loaded |= bool((want[0][:, :, rd] != regs[:, :, rd]).any())
        flagged |= bool(want[2][[0, 2]].any())
    # the fixture reaches both outcomes: loads and out-of-range lanes
    assert loaded and flagged


@pytest.mark.parametrize("gdepth", [64, 4096, LARGE])
@pytest.mark.parametrize("variant", ["plain", "snoop", "pred"])
def test_gst_row_plain_matches_reference_handler(gdepth, variant):
    rng = np.random.default_rng(2 * gdepth + len(variant))
    regs, gmem = _state(rng, gdepth)
    oob = np.array([False, True, False])
    stored = flagged = False
    for row, n_threads in _rows(rng, 9, variant):
        cfg = SMConfig(n_threads=n_threads, dim_x=n_threads)
        want = _reference(row, n_threads, regs, gmem, oob)
        got = gst_row_plain(cfg, row, _t(regs), _t(gmem),
                            torch.from_numpy(oob))
        assert np.array_equal(_u32(got[0]), want[1]), (row, "gmem")
        assert np.array_equal(got[1].numpy(), want[2]), (row, "oob")
        got = simt_gst_row(cfg, row, _t(regs), _t(gmem),
                           torch.from_numpy(oob))
        assert np.array_equal(_u32(got[0]), want[1]), (row, "gmem")
        stored |= bool((want[1] != gmem).any())
        flagged |= bool(want[2][[0, 2]].any())
    assert stored and flagged


@pytest.mark.parametrize("pred", [False, True])
def test_gst_row_last_sm_wins_a_collision(pred):
    # every thread of every SM stores its own word at one address; with a
    # predicate the highest enabled thread of the last SM wins
    gdepth = 64
    regs = np.zeros((N_SMS, 512, 16), np.uint32)
    regs[:, :, 1] = 5                                  # the address
    regs[:, :, 2] = (np.arange(N_SMS)[:, None] * 1000
                     + np.arange(512)[None]).astype(np.uint32)
    regs[:, :, 3] = np.arange(512) % 3 == 0            # the predicate
    regs[2, 300:, 3] = 0
    gmem = np.arange(gdepth, dtype=np.uint32)
    oob = np.zeros(N_SMS, bool)
    row = _row(sel=9, opcode=GST, rd=2, ra=1, pen=int(pred), preg=3)
    want = _reference(row, 512, regs, gmem, oob)
    got = gst_row_plain(SMConfig(), row, _t(regs), _t(gmem),
                        torch.from_numpy(oob))
    assert np.array_equal(_u32(got[0]), want[1])
    assert want[1][5] == (2000 + 297 if pred else 2000 + 511)
    assert np.array_equal(np.delete(want[1], 5), np.delete(gmem, 5))


def test_gld_row_reads_the_image_of_its_own_wave():
    # GLD of SM s at address s * 7 + t % 7: one image for every SM
    gdepth = 4096
    regs = np.zeros((N_SMS, 512, 16), np.uint32)
    regs[:, :, 1] = (np.arange(N_SMS)[:, None] * 7
                     + np.arange(512)[None] % 7).astype(np.uint32)
    gmem = (np.arange(gdepth, dtype=np.uint32) * 3 + 1)
    row = _row(sel=8, opcode=GLD, rd=4, ra=1, imm=100)
    got, flags = gld_row_plain(SMConfig(), row, _t(regs), _t(gmem),
                               torch.zeros(N_SMS, dtype=torch.bool))
    want = _reference(row, 512, regs, gmem, np.zeros(N_SMS, bool))
    assert np.array_equal(_u32(got), want[0]) and not flags.any()
    assert np.array_equal(_u32(got)[:, :, 4],
                          (regs[:, :, 1] + 100) * 3 + 1)


def test_gmem_row_wrappers_check_their_arguments():
    regs = torch.zeros((2, 512, 16), dtype=torch.int32)
    gmem = torch.zeros(64, dtype=torch.int32)
    oob = torch.zeros(2, dtype=torch.bool)
    cfg = SMConfig()
    gld = _row(sel=8, opcode=GLD, rd=4)
    gst = _row(sel=9, opcode=GST, rd=4)
    assert check_gld_row_args(cfg, gld, regs, gmem, oob) == gld.fields
    assert check_gst_row_args(cfg, gst, regs, gmem, oob) == gst.fields
    with pytest.raises(ValueError, match="not a GLD row"):
        check_gld_row_args(cfg, gst, regs, gmem, oob)
    with pytest.raises(ValueError, match="not a GST row"):
        check_gst_row_args(cfg, gld, regs, gmem, oob)
    with pytest.raises(TypeError, match="gmem must be torch.int32"):
        check_gst_row_args(cfg, gst, regs, gmem.float(), oob)
    with pytest.raises(ValueError, match="gmem has shape"):
        check_gld_row_args(cfg, gld, regs, gmem.view(2, 32), oob)
    with pytest.raises(ValueError, match="oob has shape"):
        check_gst_row_args(cfg, gst, regs, gmem, oob[:1])
    with pytest.raises(ValueError, match="gmem is on meta"):
        check_gld_row_args(cfg, gld, regs, gmem.to("meta"), oob)
    with pytest.raises(ValueError, match="contiguous"):
        check_gst_row_args(cfg, gst, regs, torch.zeros(128,
                                                       dtype=torch.int32)[::2],
                           oob)
    with pytest.raises(ValueError, match="empty"):
        check_gst_row_args(cfg, gst, regs, gmem[:0], oob)
    with pytest.raises(ValueError, match="shape"):
        check_gld_row_args(cfg, gld, regs[:, :, :8], gmem, oob)
    # on host tensors the wrappers take the plain versions, out of place
    got = simt_gst_row(cfg, gst, regs, gmem, oob)
    assert got[0] is not gmem and got[1] is not oob
    got = simt_gld_row(cfg, gld, regs, gmem, oob)
    assert got[0] is not regs and got[1] is not oob
    # the GST port's scratch: claims from an even word, 8 B a lane, in
    # shared memory (0) where it fits
    assert gst_scratch_words(12303, 2048) == 12304 + 4096
    assert gst_scratch(torch.zeros(12304, dtype=torch.int32), 2048) == 0
    assert 4 * gst_scratch_words(12304, 16 * 512) <= MAX_DYNAMIC_SMEM
    # and the "cpu" backend's row seam is theirs
    cpu = get_execute_backend("cpu")
    assert cpu.gld_row is gld_row_plain and cpu.gst_row is gst_row_plain
