"""The execute stage's ALU, LOD and STO rows: the row seam on the CPU
(GLD and GST rows: ``tests/test_torch_gmem_rows.py``).

  * ``alu_row_plain`` / ``lod_row_plain`` / ``sto_row_plain`` (the
    ``"cpu"`` backend's row seam, the plain versions the row kernels are
    held against on the card) equal the reference's
    ``make_data_handlers`` ALU, LOD and STO handlers on the same seeded
    state, word for word: every ALU op and type, snooped operands whose
    source is the row's own destination, predicated words (negated, and
    with ``preg == rd``), partial active shapes, and LOD/STO collisions
    and out-of-range addresses with a ``shmem_depth`` below the image's
    width;
  * an ALU, LOD, STO, GLD or GST row issues no PyTorch operation outside
    its one seam call;
  * a step-, trace- and megakernel-engine wave, ``executor.run(...,
    state=prev)`` and ``launch`` on every engine leave the caller's
    tensors and numpy arrays unchanged, the global-memory image among
    them, with a seam that writes the state it is given in place, as the
    row kernels do on the card;
  * the row wrappers' argument checks.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import SMConfig as JSMConfig
from repro.core.executor import get_execute_backend as j_get_backend
from repro.core.executor import make_data_handlers as j_make_data_handlers
from repro_torch.core import DeviceConfig, SMConfig, assemble, launch, run
from repro_torch.core import device as t_device
from repro_torch.core import trace_engine as t_trace
from repro_torch.core.executor import (_EXECUTE_BACKENDS, FIELDS,
                                       ExecBackend, FusedRow,
                                       get_execute_backend,
                                       make_data_handlers, pack_imem,
                                       register_backend)
from repro_torch.core.machine import init_state
from repro_torch.kernels import fuzz
from repro_torch.kernels.simt_alu import (alu_row_plain, check_alu_row_args,
                                          simt_alu_row)
from repro_torch.kernels.simt_step import (check_lod_row_args,
                                           check_sto_row_args,
                                           lod_row_plain, simt_lod_row,
                                           simt_sto_row, sto_row_plain)

N_SMS = 3


def _row(**f) -> FusedRow:
    base = dict(sel=1, opcode=1, typ=0, rd=0, ra=0, rb=0, imm=0, x=0,
                ext_a=0, ext_b=0, pen=0, preg=0, pneg=0, act_waves=32,
                act_wthreads=16)
    base.update(f)
    return FusedRow.from_fields([base[k] for k in FIELDS])


def _reference(row: FusedRow, n_threads, regs, shmem, oob, bound=None):
    """The reference's handler for ``row`` on numpy state; returns numpy
    ``(regs, shmem, oob)``."""
    tid = np.arange(512)
    active = ((tid % 16 < row.act_wthreads) & (tid // 16 < row.act_waves)
              & (tid < n_threads))
    d = {k: jnp.int32(v) for k, v in row.d.items()}
    zero = jnp.zeros(regs.shape[0], jnp.int32)
    h = j_make_data_handlers(JSMConfig(n_threads=n_threads, dim_x=n_threads),
                             j_get_backend("inline"), d, jnp.asarray(active),
                             zero, zero, shmem_depth=bound)[row.sel]
    out = h((jnp.asarray(regs), jnp.asarray(shmem),
             jnp.zeros((16,), jnp.uint32), jnp.asarray(oob)))
    return (np.asarray(out[0]), np.asarray(out[1]), np.asarray(out[3]))


def _cfg(n_threads):
    return SMConfig(n_threads=n_threads, dim_x=n_threads)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


def _alu_variants(rng, op, typ):
    """(row, n_threads): plain, snooped with rd its own source (both
    operands), predicated (negated, preg == rd), partial shapes."""
    e = lambda: int(rng.integers(0, 32))  # noqa: E731
    r = lambda: int(rng.integers(0, 16))  # noqa: E731
    rd = r()
    yield _row(opcode=op, typ=typ, rd=rd, ra=r(), rb=r()), 512
    yield _row(opcode=op, typ=typ, rd=rd, ra=rd, rb=r(), x=1, ext_a=e(),
               ext_b=e()), 512
    yield _row(opcode=op, typ=typ, rd=rd, ra=r(), rb=rd, x=1, ext_a=e(),
               ext_b=e(), pen=1, preg=rd, pneg=1, act_waves=16,
               act_wthreads=8), 512
    yield _row(opcode=op, typ=typ, rd=rd, ra=rd, rb=rd, pen=1, preg=r(),
               act_waves=8, act_wthreads=4), 200
    yield _row(opcode=op, typ=typ, rd=rd, ra=r(), rb=r(), x=1, ext_a=e(),
               ext_b=e(), pen=1, preg=r(), pneg=1, act_waves=1,
               act_wthreads=1), 96


@pytest.mark.parametrize("typ", range(4))
@pytest.mark.parametrize("op", range(1, 10))
def test_alu_row_plain_matches_reference_handler(op, typ):
    rng = np.random.default_rng(10 * op + typ)
    regs, shmem = fuzz.random_state(rng, N_SMS, 64)
    # FP32 words of every kind in the operands, small shift counts too
    regs[:, :, :8] = fuzz.random_f32_words(rng, (N_SMS, 512, 8))
    regs[:, :, 8] = rng.integers(0, 40, (N_SMS, 512))
    oob = np.zeros(N_SMS, bool)
    for row, n_threads in _alu_variants(rng, op, typ):
        want = _reference(row, n_threads, regs, shmem, oob)[0]
        got = alu_row_plain(_cfg(n_threads), row, _t(regs))
        assert np.array_equal(_u32(got), want), row
        # and the wrapper takes the plain version on host tensors
        got = simt_alu_row(_cfg(n_threads), row, _t(regs))
        assert np.array_equal(_u32(got), want), row


@pytest.mark.parametrize("width,bound", [(64, None), (64, 40), (1024, 1000),
                                         (3072, None)])
@pytest.mark.parametrize("variant", ["plain", "snoop", "pred"])
def test_sto_row_plain_matches_reference_handler(width, bound, variant):
    rng = np.random.default_rng(width + (bound or 0) + len(variant))
    regs, shmem = fuzz.random_state(rng, N_SMS, width)
    depth = bound or width
    # addresses: collisions on a few words, and lanes below 0 and past the
    # bound (including between the bound and the image's width)
    regs[:, :, 1] = rng.integers(-3, 3, (N_SMS, 512))
    regs[:, :, 2] = rng.integers(depth - 8, width + 8, (N_SMS, 512))
    regs[:, :, 3] = rng.integers(-2**31, 2**31, (N_SMS, 512))
    oob = np.array([False, True, False])
    f = dict(sel=3, opcode=11, rd=int(rng.integers(4, 16)), imm=2)
    if variant == "snoop":
        f.update(x=1, ext_a=int(rng.integers(0, 32)), act_waves=16)
    if variant == "pred":
        f.update(pen=1, preg=5, pneg=1, act_wthreads=8)
    stored = flagged = False
    for ra in (0, 1, 2, 3):
        for imm in (0, 2, -16380):
            row = _row(**{**f, "ra": ra, "imm": imm})
            want = _reference(row, 512, regs, shmem, oob, bound)
            got = sto_row_plain(SMConfig(), row, _t(regs), _t(shmem),
                                torch.from_numpy(oob), depth)
            assert np.array_equal(_u32(got[0]), want[1]), (row, "shmem")
            assert np.array_equal(got[1].numpy(), want[2]), (row, "oob")
            stored |= bool((want[1] != shmem).any())
            flagged |= bool(want[2][[0, 2]].any())
    # the fixture reaches both outcomes: stores and out-of-range lanes
    assert stored and flagged


@pytest.mark.parametrize("width,bound", [(64, None), (64, 40), (1024, 1000),
                                         (3072, None)])
@pytest.mark.parametrize("variant", ["plain", "snoop", "pred"])
def test_lod_row_plain_matches_reference_handler(width, bound, variant):
    rng = np.random.default_rng(2 * width + (bound or 0) + len(variant))
    regs, shmem = fuzz.random_state(rng, N_SMS, width)
    depth = bound or width
    # addresses: lanes below 0, past the bound (also between the bound and
    # the image's width) and far outside, beside in-range ones
    regs[:, :, 1] = rng.integers(-3, 3, (N_SMS, 512))
    regs[:, :, 2] = rng.integers(depth - 8, width + 8, (N_SMS, 512))
    regs[:, :, 3] = rng.integers(-2**31, 2**31, (N_SMS, 512))
    oob = np.array([False, True, False])
    f = dict(sel=2, opcode=10)
    if variant == "snoop":        # rd is its own (snooped) address source
        f.update(x=1, ext_a=int(rng.integers(0, 32)), act_waves=16)
    if variant == "pred":         # and preg == rd
        f.update(pen=1, pneg=1, act_wthreads=8)
    loaded = flagged = False
    for ra in (0, 1, 2, 3):
        for imm in (0, 2, -16380):
            rd = ra if variant == "snoop" else int(rng.integers(4, 16))
            row = _row(**{**f, "ra": ra, "imm": imm, "rd": rd,
                          "preg": rd if variant == "pred" else 0})
            want = _reference(row, 512, regs, shmem, oob, bound)
            got = lod_row_plain(SMConfig(), row, _t(regs), _t(shmem),
                                torch.from_numpy(oob), depth)
            assert np.array_equal(_u32(got[0]), want[0]), (row, "regs")
            assert np.array_equal(got[1].numpy(), want[2]), (row, "oob")
            # the wrapper takes the plain version on host tensors
            got = simt_lod_row(SMConfig(), row, _t(regs), _t(shmem),
                               torch.from_numpy(oob), depth)
            assert np.array_equal(_u32(got[0]), want[0]), (row, "regs")
            loaded |= bool((want[0][:, :, rd] != regs[:, :, rd]).any())
            flagged |= bool(want[2][[0, 2]].any())
    # the fixture reaches both outcomes: loads and out-of-range lanes
    assert loaded and flagged


# ---------------------------------------------------------------------------
# one seam call per row
# ---------------------------------------------------------------------------

class _OpCount(TorchDispatchMode):
    """Counts the PyTorch operations dispatched while it is active, except
    inside a seam call (``paused``)."""

    def __init__(self):
        super().__init__()
        self.ops = []
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused:
            self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


_SEAMS = {1: "alu_row", 2: "lod_row", 3: "sto_row", 8: "gld_row",
          9: "gst_row"}


@pytest.mark.parametrize("sel", [1, 2, 3, 8, 9],
                         ids=["ALU", "LOD", "STO", "GLD", "GST"])
def test_rows_issue_only_their_seam_call(sel):
    cpu = get_execute_backend("cpu")
    count = _OpCount()
    calls = []

    def seam(name, fn):
        def call(*args):
            calls.append(name)
            count.paused = True
            try:
                return fn(*args)
            finally:
                count.paused = False
        return call

    backend = dataclasses.replace(
        cpu, name="counting",
        **{name: seam(name, getattr(cpu, name)) for name in _SEAMS.values()})
    rng = np.random.default_rng(sel)
    regs, shmem = fuzz.random_state(rng, N_SMS, 64)
    row = _row(sel=sel, opcode={1: 3, 2: 10, 3: 11, 8: 24, 9: 25}[sel],
               typ=2, rd=4, ra=1, rb=5, x=1, ext_a=3, pen=1, preg=6)
    zero = torch.zeros(N_SMS, dtype=torch.int32)
    h = make_data_handlers(SMConfig(), backend, row, zero, zero,
                           shmem_depth=40)[row.sel]
    state = (_t(regs), _t(shmem), _t(shmem[0]),
             torch.zeros(N_SMS, dtype=torch.bool))
    with count:
        out = h(state)
    assert count.ops == [] and calls == [_SEAMS[sel]]
    want = make_data_handlers(SMConfig(), cpu, row, zero, zero,
                              shmem_depth=40)[row.sel](state)
    for g, w in zip(out, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# state ownership: the rows write in place, the engines copy once per wave
# ---------------------------------------------------------------------------

def _in_place(backend: ExecBackend) -> ExecBackend:
    """``backend`` with ALU, LOD, STO, GLD and GST rows that write the
    tensors they are given in place, as the row kernels do on the
    card."""
    def alu_row(cfg, row, regs):
        return regs.copy_(backend.alu_row(cfg, row, regs))

    def lod_row(cfg, row, regs, shmem, oob, depth):
        new_regs, new_oob = backend.lod_row(cfg, row, regs, shmem, oob,
                                            depth)
        return regs.copy_(new_regs), oob.copy_(new_oob)

    def sto_row(cfg, row, regs, shmem, oob, depth):
        new_shmem, new_oob = backend.sto_row(cfg, row, regs, shmem, oob,
                                             depth)
        return shmem.copy_(new_shmem), oob.copy_(new_oob)

    def gld_row(cfg, row, regs, gmem, oob):
        new_regs, new_oob = backend.gld_row(cfg, row, regs, gmem, oob)
        return regs.copy_(new_regs), oob.copy_(new_oob)

    def gst_row(cfg, row, regs, gmem, oob):
        new_gmem, new_oob = backend.gst_row(cfg, row, regs, gmem, oob)
        return gmem.copy_(new_gmem), oob.copy_(new_oob)

    return dataclasses.replace(backend, name="cpu-in-place",
                               alu_row=alu_row, lod_row=lod_row,
                               sto_row=sto_row, gld_row=gld_row,
                               gst_row=gst_row)


# a GLD before the first fused segment (at addresses mostly outside the
# image, so it sets oob), GSTs between segments, STO and LOD
_PROG = ("GLD R5, (R1)+3\nTDX R1\nGST R1, (R1)+0\nADD.INT32 R2, R1, R5\n"
         "NOP\nNOP\nSTO R2, (R1)+0\nLOD R3, (R1)+1\nGLD R6, (R1)+0\n"
         "MUL.INT32 R1, R2, R2\nNOP\nNOP\nSTO R1, (R2)+100\n"
         "STO R3, (R2)+101\nGST R6, (R2)+64\nSTOP")


@pytest.fixture
def in_place():
    register_backend(_in_place(get_execute_backend("cpu")))
    yield "cpu-in-place"
    del _EXECUTE_BACKENDS["cpu-in-place"]


@pytest.mark.parametrize("engine", ["step", "trace", "megakernel"])
def test_wave_leaves_the_callers_state_unchanged(engine, in_place):
    cfg = SMConfig(n_threads=64, dim_x=64, shmem_depth=128)
    rng = np.random.default_rng(3)
    regs_np = rng.integers(0, 1 << 32, (2, 512, 16),
                           dtype=np.uint64).astype(np.uint32)
    shmem_np = rng.integers(0, 1 << 32, (2, 128),
                            dtype=np.uint64).astype(np.uint32)
    gmem_np = rng.integers(0, 1 << 32, 256, dtype=np.uint64).astype(
        np.uint32)
    keep = regs_np.copy(), shmem_np.copy(), gmem_np.copy()
    st = t_device.init_device_state(cfg, 2)
    st.regs, st.shmem = _t(regs_np), _t(shmem_np)   # share the arrays
    st.gmem = _t(gmem_np)
    st.oob = torch.zeros(2, dtype=torch.bool)
    words = assemble(_PROG).words
    zero = torch.zeros(2, dtype=torch.int32)
    backend = get_execute_backend(in_place)
    if engine == "step":
        fin = t_device.run_wave(cfg, backend, *pack_imem(words, 1024),
                                zero, zero, st)
    elif engine == "trace":
        fin = t_trace.run_wave_trace(cfg, backend,
                                     t_trace.compile_program(words, cfg),
                                     zero, zero, st)
    else:
        plan = t_trace.compile_megakernel(words, cfg)
        assert plan.items[0][0] == "gmem"    # a GLD before any segment
        fin = t_trace.run_wave_megakernel(backend, plan, zero, zero, st)
    assert np.array_equal(regs_np, keep[0])
    assert np.array_equal(shmem_np, keep[1])
    assert np.array_equal(gmem_np, keep[2])
    assert not st.oob.any()
    # the wave's own state moved, and equals the out-of-place seam's
    assert not np.array_equal(_u32(fin.regs), keep[0])
    assert not np.array_equal(_u32(fin.gmem), keep[2])
    assert fin.oob.all()
    want = t_device.run_wave(cfg, get_execute_backend("cpu"),
                             *pack_imem(words, 1024), zero, zero, st)
    for k in ("regs", "shmem", "gmem", "oob"):
        assert torch.equal(getattr(fin, k), getattr(want, k)), k


def test_run_and_launch_leave_the_callers_state_unchanged(in_place):
    cfg = SMConfig(n_threads=64, dim_x=64, shmem_depth=128)
    words = assemble(_PROG).words
    prev = init_state(cfg)
    before = prev.regs.clone(), prev.shmem.clone()
    fin = run(cfg, words, state=prev, backend=in_place)
    assert torch.equal(prev.regs, before[0])
    assert torch.equal(prev.shmem, before[1])
    assert fin.halted and not torch.equal(fin.regs, before[0])
    # a launch's shared-memory images from a numpy batch
    images = np.arange(3 * 128, dtype=np.uint32).reshape(3, 128)
    keep = images.copy()
    res = launch(DeviceConfig(n_sms=2, backend=in_place, engine="step",
                              sm=SMConfig(shmem_depth=128)),
                 words, grid=(3,), block=64, shmem=images)
    assert np.array_equal(images, keep)
    assert not np.array_equal(res.shmem.numpy().view(np.uint32), keep)


@pytest.mark.parametrize("engine", ["step", "trace", "megakernel"])
def test_launch_leaves_the_callers_gmem_unchanged(engine, in_place):
    # the image as an int32 tensor of the launch's depth, as numpy words
    # and as named buffers; three blocks on two SMs chain two waves
    words = assemble(_PROG).words
    rng = np.random.default_rng(5)
    image = rng.integers(0, 1 << 32, 256, dtype=np.uint64).astype(np.uint32)
    dcfg = DeviceConfig(n_sms=2, global_mem_depth=256, backend=in_place,
                        engine=engine, sm=SMConfig(shmem_depth=128))
    want = launch(dataclasses.replace(dcfg, backend="cpu"), words,
                  grid=(3,), block=64, gmem=image)
    for given in (_t(image), image, {"a": image[:100], "b": image[100:]}):
        keep = image.copy()
        kw = {"buffers": given} if isinstance(given, dict) \
            else {"gmem": given}
        res = launch(dcfg, words, grid=(3,), block=64, **kw)
        assert np.array_equal(image, keep)
        assert res.n_waves == 2 and res.engine == engine
        assert torch.equal(res.gmem, want.gmem)
        assert torch.equal(res.regs, want.regs)
        assert torch.equal(res.oob, want.oob)
    assert not np.array_equal(want.gmem.numpy().view(np.uint32), image)


# ---------------------------------------------------------------------------
# the row wrappers' checks
# ---------------------------------------------------------------------------

def test_row_wrappers_check_their_arguments():
    regs = torch.zeros((2, 512, 16), dtype=torch.int32)
    shmem = torch.zeros((2, 64), dtype=torch.int32)
    oob = torch.zeros(2, dtype=torch.bool)
    cfg = SMConfig()
    alu = _row(opcode=3, rd=4)
    sto = _row(sel=3, opcode=11, rd=4)
    lod = _row(sel=2, opcode=10, rd=4)
    assert check_alu_row_args(cfg, alu, regs) == alu.fields
    assert check_sto_row_args(cfg, sto, regs, shmem, oob, 40) == sto.fields
    assert check_lod_row_args(cfg, lod, regs, shmem, oob, 40) == lod.fields
    with pytest.raises(ValueError, match="not an ALU opcode"):
        check_alu_row_args(cfg, _row(opcode=11), regs)
    with pytest.raises(ValueError, match="not an STO row"):
        check_sto_row_args(cfg, alu, regs, shmem, oob, 40)
    with pytest.raises(ValueError, match="shape"):
        check_alu_row_args(cfg, alu, regs[:, :256])
    with pytest.raises(ValueError, match="contiguous"):
        check_alu_row_args(cfg, alu, regs.transpose(1, 2).contiguous()
                           .transpose(1, 2))
    with pytest.raises(ValueError, match="shmem_depth"):
        check_sto_row_args(cfg, sto, regs, shmem, oob, 65)
    with pytest.raises(ValueError, match="oob has shape"):
        check_sto_row_args(cfg, sto, regs, shmem, oob[:1], 40)
    with pytest.raises(ValueError, match="rd=16"):
        _row(rd=16).fields
    with pytest.raises(ValueError, match="active shape"):
        _row(act_waves=0).fields
    # the LOD row: dtype, shape and device of regs, shmem and oob
    with pytest.raises(ValueError, match="not an LOD row"):
        check_lod_row_args(cfg, sto, regs, shmem, oob, 40)
    with pytest.raises(TypeError, match="regs must be torch.int32"):
        check_lod_row_args(cfg, lod, regs.to(torch.int64), shmem, oob, 40)
    with pytest.raises(TypeError, match="shmem must be torch.int32"):
        check_lod_row_args(cfg, lod, regs, shmem.float(), oob, 40)
    with pytest.raises(TypeError, match="oob must be torch.bool"):
        check_lod_row_args(cfg, lod, regs, shmem, oob.to(torch.uint8), 40)
    with pytest.raises(ValueError, match="shmem has shape"):
        check_lod_row_args(cfg, lod, regs, shmem[:1], oob, 40)
    with pytest.raises(ValueError, match="shape"):
        check_lod_row_args(cfg, lod, regs[:, :, :8], shmem, oob, 40)
    with pytest.raises(ValueError, match="shmem is on meta"):
        check_lod_row_args(cfg, lod, regs, shmem.to("meta"), oob, 40)
    with pytest.raises(ValueError, match="oob is on meta"):
        check_lod_row_args(cfg, lod, regs, shmem, oob.to("meta"), 40)
    with pytest.raises(ValueError, match="shmem_depth"):
        check_lod_row_args(cfg, lod, regs, shmem, oob, 0)
    # on host tensors the wrappers take the plain versions, out of place
    got = simt_sto_row(cfg, sto, regs, shmem, oob, 40)
    assert got[0] is not shmem and got[1] is not oob
    got = simt_lod_row(cfg, lod, regs, shmem, oob, 40)
    assert got[0] is not regs and got[1] is not oob
