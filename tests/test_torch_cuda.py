"""The port's CUDA kernels against their plain versions on the card.

Needs a CUDA device and skips without one. Imports neither JAX nor the
JAX package, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import SMConfig, assemble, run
from repro_torch.core.executor import FIELDS, FusedRow, apply_segment_rows
from repro_torch.core.machine import init_state
from repro_torch.kernels import build, fuzz, ops
from repro_torch.kernels.fft_r2 import fft_r2, fft_r2_plain
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.mgs_qrd import mgs_qrd, mgs_qrd_plain
from repro_torch.kernels.simt_alu import (alu_plain, alu_row_plain,
                                          simt_alu, simt_alu_row)
from repro_torch.kernels.wavefront_dot import (wavefront_dot,
                                               wavefront_dot_plain)
from repro_torch.kernels.simt_step import (
    SEGMENT_CHUNK_ROWS, gather_plain, gather_shared_plain, gld_row_plain,
    gst_row_plain, gst_scratch_words, lod_row_plain,
    scatter_plain, scatter_shared_plain, segment_barriers, simt_gather,
    simt_gather_shared, simt_gld_row, simt_gst_row, simt_lod_row,
    simt_scatter, simt_scatter_shared, simt_segment, simt_sto_row,
    sto_row_plain)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _words(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n_threads,depth,bound", [(512, 3072, None),
                                                   (96, 64, 40)])
def test_segment_kernel_matches_plain_version(dev, n_threads, depth, bound):
    rng = np.random.default_rng(n_threads)
    cfg = SMConfig(n_threads=n_threads, dim_x=16)
    rows = fuzz.random_rows(rng, 300, n_threads=n_threads)
    regs, shmem = fuzz.random_state(rng, 4, depth)
    args = (torch.arange(4, dtype=torch.int32, device=dev),
            torch.full((4,), 3, dtype=torch.int32, device=dev),
            _words(regs, dev), _words(shmem, dev),
            torch.tensor([False, True, False, False], device=dev))
    got = simt_segment(cfg, torch.from_numpy(rows).to(dev), *args,
                       shmem_depth=bound)
    want = apply_segment_rows(cfg, rows, *args, shmem_depth=bound)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n_threads,depth,bound,n_rows", [
    (512, 3072, None, 300), (96, 64, 40, 300),
    (512, 1024, 1000, 2 * SEGMENT_CHUNK_ROWS + 37)])
def test_segment_kernel_on_hazard_dense_rows(dev, n_threads, depth, bound,
                                             n_rows):
    # snooped rd == ra, LOD right after STO, INVSQR right after a write to
    # its source, DOT over snooped operands; the longest table in chunks
    rng = np.random.default_rng(n_rows + depth)
    cfg = SMConfig(n_threads=n_threads, dim_x=16)
    rows = fuzz.random_rows(rng, n_rows, n_threads=n_threads, hazards=True)
    regs, shmem = fuzz.random_state(rng, 4, depth)
    args = (torch.arange(4, dtype=torch.int32, device=dev),
            torch.full((4,), 3, dtype=torch.int32, device=dev),
            _words(regs, dev), _words(shmem, dev),
            torch.tensor([False, True, False, False], device=dev))
    bits = torch.from_numpy(segment_barriers(rows)).to(dev)
    want = apply_segment_rows(cfg, rows, *args, shmem_depth=bound)
    for barriers in (bits, None):
        got = simt_segment(cfg, torch.from_numpy(rows).to(dev), *args,
                           shmem_depth=bound, barriers=barriers)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fft64", "qrd16", "saxpy"])
def test_segment_kernel_on_plans_matches_plain_version(dev, name):
    # every fused item of the plan with the plan's own barrier bits, on a
    # random four-SM wave
    from repro_torch.core import compile_megakernel
    from repro_torch.core.programs import qrd_program
    from repro_torch.core.programs.fft import fft_program
    from repro_torch.core.programs.saxpy import saxpy_grid_program

    program, cfg = {
        "fft64": (fft_program(64), SMConfig(max_steps=200_000)),
        "qrd16": (qrd_program(), SMConfig(imem_depth=1024,
                                          max_steps=200_000)),
        "saxpy": (saxpy_grid_program(4096, 512),
                  SMConfig(max_steps=10_000))}[name]
    plan = compile_megakernel(program, cfg)
    rng = np.random.default_rng(len(name))
    regs, shmem = fuzz.random_state(rng, 4, 3072)
    args = (torch.arange(4, dtype=torch.int32, device=dev),
            torch.zeros(4, dtype=torch.int32, device=dev),
            _words(regs, dev), _words(shmem, dev),
            torch.zeros(4, dtype=torch.bool, device=dev))
    table, bits = plan.device_table(dev), plan.device_barriers(dev)
    fused = [p for kind, p in plan.items if kind == "fused"]
    assert fused
    for start, stop in fused:
        got = simt_segment(cfg, table[start:stop], *args,
                           barriers=bits[start:stop])
        want = apply_segment_rows(cfg, plan.sched.table[start:stop], *args)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("span", [300, 17, 2])
def test_gmem_kernels_match_plain_versions(dev, span):
    rng = np.random.default_rng(span)
    gmem = _words(rng.integers(0, 1 << 32, 300, dtype=np.uint64)
                  .astype(np.uint32), dev)
    addr = torch.from_numpy(rng.integers(0, span, (4, 512))
                            .astype(np.int32)).to(dev)
    mask = torch.from_numpy(rng.random((4, 512)) < 0.7).to(dev)
    vals = _words(rng.integers(0, 1 << 32, (4, 512), dtype=np.uint64)
                  .astype(np.uint32), dev)
    assert torch.equal(simt_gather_shared(gmem, addr, mask, vals),
                       gather_shared_plain(gmem, addr, mask, vals))
    assert torch.equal(simt_scatter_shared(gmem, addr, vals, mask),
                       scatter_shared_plain(gmem, addr, vals, mask))


@pytest.mark.cuda
def test_gst_tile_kernel_on_a_large_image(dev):
    # claims that do not fit a CTA's shared memory live in device memory
    rng = np.random.default_rng(7)
    gdepth = 1 << 20
    assert 4 * gst_scratch_words(gdepth, 0) > build.MAX_DYNAMIC_SMEM
    gmem = _words(fuzz.random_f32_words(rng, (gdepth,)), dev)
    addr = torch.from_numpy(np.where(
        rng.random((4, 512)) < 0.5, rng.integers(0, 9, (4, 512)),
        rng.integers(0, gdepth, (4, 512))).astype(np.int32)).to(dev)
    mask = torch.from_numpy(rng.random((4, 512)) < 0.7).to(dev)
    vals = _words(rng.integers(0, 1 << 32, (4, 512), dtype=np.uint64)
                  .astype(np.uint32), dev)
    for _ in range(2):       # the scratch is reused, never cleared
        assert torch.equal(simt_scatter_shared(gmem, addr, vals, mask),
                           scatter_shared_plain(gmem, addr, vals, mask))


@pytest.mark.cuda
@pytest.mark.parametrize("typ", [0, 1, 2])
def test_alu_kernel_matches_plain_version(dev, typ):
    rng = np.random.default_rng(typ)
    a, b = (_words(fuzz.random_f32_words(rng, (4, 512)), dev)
            for _ in range(2))
    mask = torch.from_numpy(rng.random((4, 512)) < 0.7).to(dev)
    old = _words(rng.integers(0, 1 << 32, (4, 512), dtype=np.uint64)
                 .astype(np.uint32), dev)
    for op in range(1, 10):
        assert torch.equal(simt_alu(op, typ, a, b, mask, old),
                           alu_plain(op, typ, a, b, mask, old))


@pytest.mark.cuda
def test_alu_kernel_flushes_tiny_products_as_x86(dev):
    # products around 2**-126: x86 detects tininess after rounding, so
    # 0x3F7FFFFF x 0x00800000 (lanes 0-3, each sign) is a signed zero
    a, b = (_words(x, dev) for x in fuzz.tiny_product_words(
        np.random.default_rng(3), (4, 512)))
    mask = torch.ones((4, 512), dtype=torch.bool, device=dev)
    old = torch.zeros((4, 512), dtype=torch.int32, device=dev)
    got = simt_alu(3, 2, a, b, mask, old)
    assert torch.equal(got, alu_plain(3, 2, a, b, mask, old))
    assert got[0, :4].tolist() == [0, -2**31, -2**31, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("depth,span", [(64, 64), (3072, 3072), (1024, 5)])
def test_smem_kernels_match_plain_versions(dev, depth, span):
    rng = np.random.default_rng(depth + span)
    mem = _words(rng.integers(0, 1 << 32, (4, depth), dtype=np.uint64)
                 .astype(np.uint32), dev)
    addr = torch.from_numpy(rng.integers(0, span, (4, 512))
                            .astype(np.int32)).to(dev)
    mask = torch.from_numpy(rng.random((4, 512)) < 0.7).to(dev)
    vals = _words(rng.integers(0, 1 << 32, (4, 512), dtype=np.uint64)
                  .astype(np.uint32), dev)
    assert torch.equal(simt_gather(mem, addr, mask, vals),
                       gather_plain(mem, addr, mask, vals))
    # disabled lanes carry out-of-range addresses the kernel must not read
    wild = torch.where(mask, addr, torch.full_like(addr, -(1 << 30)))
    assert torch.equal(simt_scatter(mem, wild, vals, mask),
                       scatter_plain(mem, wild, vals, mask))


# ---------------------------------------------------------------------------
# the row kernels: one ALU or STO row in place
# ---------------------------------------------------------------------------

def _field_row(**f):
    base = dict(sel=1, opcode=1, typ=0, rd=0, ra=0, rb=0, imm=0, x=0,
                ext_a=0, ext_b=0, pen=0, preg=0, pneg=0, act_waves=32,
                act_wthreads=16)
    base.update(f)
    return FusedRow.from_fields([base[k] for k in FIELDS])


@pytest.mark.cuda
@pytest.mark.parametrize("n_threads,width,bound", [(512, 3072, None),
                                                   (96, 64, 40),
                                                   (200, 1024, 1000)])
def test_row_kernels_match_plain_versions(dev, n_threads, width, bound):
    rng = np.random.default_rng(n_threads + width)
    cfg = SMConfig(n_threads=n_threads, dim_x=n_threads)
    depth = bound or width
    for sel in (1, 2, 3):
        for fields in fuzz.random_rows(rng, 120, sels=(sel,),
                                       n_threads=n_threads):
            row = FusedRow.from_fields(fields)
            regs, shmem = fuzz.random_state(rng, 4, width)
            if rng.random() < 0.5:            # snooped, rd its own source
                row = dataclasses.replace(row, d={
                    **row.d, "x": 1, "ra": row.d["rd"],
                    "ext_a": int(rng.integers(0, 32))})
            regs, shmem = _words(regs, dev), _words(shmem, dev)
            oob = torch.tensor([False, True, False, False], device=dev)
            if sel == 1:
                want = alu_row_plain(cfg, row, regs)
                got = simt_alu_row(cfg, row, regs.clone())
                assert torch.equal(got, want), row
            elif sel == 2:
                want = lod_row_plain(cfg, row, regs, shmem, oob, depth)
                got = simt_lod_row(cfg, row, regs.clone(), shmem,
                                   oob.clone(), depth)
                assert torch.equal(got[0], want[0]), row
                assert torch.equal(got[1], want[1]), row
            else:
                want = sto_row_plain(cfg, row, regs, shmem, oob, depth)
                got = simt_sto_row(cfg, row, regs, shmem.clone(),
                                   oob.clone(), depth)
                assert torch.equal(got[0], want[0]), row
                assert torch.equal(got[1], want[1]), row


@pytest.mark.cuda
@pytest.mark.parametrize("n_sms", [1, 4, 16])
@pytest.mark.parametrize("gdepth,span", [(4096, None), (64, None),
                                         (4096, 37), (1 << 20, None),
                                         (1 << 20, 37)])
def test_gmem_row_kernels_match_plain_versions(dev, n_sms, gdepth, span):
    # fuzzed GLD and GST rows, half of them snooped with rd their own
    # address source; addresses around the image (collisions inside and
    # across SMs), or on ``span`` words; the claims of a 2**20-word image
    # live in device memory
    rng = np.random.default_rng(n_sms * gdepth + (span or 0))
    image = _words(fuzz.random_f32_words(rng, (gdepth,)), dev)
    keep = image.clone()
    loaded = stored = flagged = 0
    for fields in fuzz.random_rows(rng, 40, sels=(8, 9)):
        row = FusedRow.from_fields(fields)
        if rng.random() < 0.5:
            row = dataclasses.replace(row, d={
                **row.d, "x": 1, "ra": row.d["rd"],
                "ext_a": int(rng.integers(0, 32))})
        n_threads = int(rng.choice([512, 200, 96]))
        cfg = SMConfig(n_threads=n_threads, dim_x=n_threads)
        regs, _ = fuzz.random_state(rng, n_sms, min(gdepth, 4096))
        if gdepth > 4096:
            regs[:, :, 0] = rng.integers(-8, gdepth + 8, (n_sms, 512))
        if span:
            regs[:, :, 1] = rng.integers(0, span, (n_sms, 512))
        regs = _words(regs, dev)
        oob = torch.from_numpy(rng.random(n_sms) < 0.3).to(dev)
        flags = oob.clone()
        if row.sel == 8:        # regs and oob in place
            want = gld_row_plain(cfg, row, regs, image, oob)
            got = simt_gld_row(cfg, row, regs.clone(), image, flags)
            loaded += int(not torch.equal(want[0], regs))
        else:                   # the image and oob in place
            want = gst_row_plain(cfg, row, regs, image, oob)
            got = simt_gst_row(cfg, row, regs, image.clone(), flags)
            stored += int(not torch.equal(want[0], image))
        assert got[1] is flags
        assert torch.equal(got[0], want[0]), row
        assert torch.equal(got[1], want[1]), row
        flagged += int(not torch.equal(want[1], oob))
    assert torch.equal(image, keep)
    assert loaded and stored and (flagged or span)


@pytest.mark.cuda
@pytest.mark.parametrize("gdepth", [64, 1 << 20])
def test_gst_row_last_sm_wins_a_collision_on_the_card(dev, gdepth):
    # every enabled thread of 16 SMs stores its own word at address 5;
    # on the last SM the threads past 300 are disabled by the predicate
    n = 16
    tid = torch.arange(512, dtype=torch.int32, device=dev)
    regs = torch.zeros((n, 512, 16), dtype=torch.int32, device=dev)
    regs[:, :, 1] = 5
    regs[:, :, 2] = torch.arange(n, dtype=torch.int32, device=dev)[:, None] \
        * 1000 + tid
    regs[:, :, 3] = 1
    regs[n - 1, 300:, 3] = 0
    image = torch.arange(gdepth, dtype=torch.int32, device=dev)
    oob = torch.zeros(n, dtype=torch.bool, device=dev)
    row = _field_row(sel=9, opcode=25, rd=2, ra=1, pen=1, preg=3)
    got = image.clone()
    simt_gst_row(SMConfig(), row, regs, got, oob)
    assert got[5] == (n - 1) * 1000 + 299
    assert torch.equal(got, gst_row_plain(SMConfig(), row, regs, image,
                                          oob)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("op,typ", [(1, 0), (3, 2), (8, 1)])
def test_snooped_alu_row_reads_before_it_writes(dev, op, typ):
    # rd = ra = rb = preg, every operand snooped from other threads' rd:
    # every thread must read the row's old state
    rng = np.random.default_rng(op)
    regs = _words(fuzz.random_state(rng, 4, 64)[0], dev)
    row = _field_row(opcode=op, typ=typ, rd=7, ra=7, rb=7, x=1, ext_a=31,
                     ext_b=5, pen=1, preg=7)
    want = alu_row_plain(SMConfig(), row, regs)
    got = regs.clone()
    assert simt_alu_row(SMConfig(), row, got) is got      # in place
    assert torch.equal(got, want)
    assert not torch.equal(got, regs)


@pytest.mark.cuda
def test_sto_row_out_of_bound_sets_oob_and_leaves_the_image(dev):
    # thread t stores t + 7 at regs[s, t, 1] (+ imm 0): SM 0 all at 0,
    # SM 1 at 38 + t (past the bound of 40 from thread 2), SM 2 below 0,
    # SM 3 far above the 64-word image
    tid = torch.arange(512, device=dev, dtype=torch.int32)
    regs = torch.zeros((4, 512, 16), dtype=torch.int32, device=dev)
    regs[:, :, 2] = tid + 7
    regs[1, :, 1] = tid + 38
    regs[2, :, 1] = -600
    regs[3, :, 1] = 1 << 30
    shmem = torch.arange(4 * 64, dtype=torch.int32, device=dev).view(4, 64)
    oob = torch.zeros(4, dtype=torch.bool, device=dev)
    row = _field_row(sel=3, opcode=11, rd=2, ra=1)
    want = sto_row_plain(SMConfig(), row, regs, shmem, oob, 40)
    img, flags = shmem.clone(), oob.clone()
    got = simt_sto_row(SMConfig(), row, regs, img, flags, 40)
    assert got[0] is img and got[1] is flags        # in place
    assert torch.equal(img, want[0]) and torch.equal(flags, want[1])
    assert flags.tolist() == [False, True, True, True]
    # in bound: SM 0 (all at address 0, highest thread wins), SM 1 at 38
    # and 39; nothing at or past the bound of 40, nothing on SMs 2 and 3
    assert img[0, 0] == 511 + 7 and torch.equal(img[0, 1:], shmem[0, 1:])
    assert img[1, 38:40].tolist() == [7, 8]
    assert torch.equal(img[1, 40:], shmem[1, 40:])
    assert torch.equal(img[2:], shmem[2:])


@pytest.mark.cuda
def test_lod_row_out_of_bound_sets_oob_and_keeps_the_register(dev):
    # thread t loads at regs[s, t, 1] + 1: SM 0 all from word 1, SM 1 from
    # 39 + t (past the bound of 40 from thread 1), SM 2 below 0, SM 3 far
    # above the 64-word image; R1 is also the destination, snooped from
    # wavefront 0 on SM 0
    tid = torch.arange(512, device=dev, dtype=torch.int32)
    regs = torch.zeros((4, 512, 16), dtype=torch.int32, device=dev)
    regs[:, :, 2] = tid + 7
    regs[1, :, 1] = tid + 38
    regs[2, :, 1] = -600
    regs[3, :, 1] = 1 << 30
    shmem = torch.arange(4 * 64, dtype=torch.int32, device=dev).view(4, 64)
    oob = torch.zeros(4, dtype=torch.bool, device=dev)
    row = _field_row(sel=2, opcode=10, rd=2, ra=1, imm=1)
    want = lod_row_plain(SMConfig(), row, regs, shmem, oob, 40)
    got_regs, flags = regs.clone(), oob.clone()
    got = simt_lod_row(SMConfig(), row, got_regs, shmem, flags, 40)
    assert got[0] is got_regs and got[1] is flags        # in place
    assert torch.equal(got_regs, want[0]) and torch.equal(flags, want[1])
    assert flags.tolist() == [False, True, True, True]
    assert torch.equal(got_regs[0, :, 2], torch.full_like(tid, 1))
    assert got_regs[1, :1, 2].tolist() == [64 + 39]
    assert torch.equal(got_regs[1, 1:, 2], tid[1:] + 7)
    assert torch.equal(got_regs[2:], regs[2:])
    snooped = _field_row(sel=2, opcode=10, rd=1, ra=1, x=1, ext_a=0)
    want = lod_row_plain(SMConfig(), snooped, regs, shmem, oob, 64)
    got_regs = regs.clone()
    simt_lod_row(SMConfig(), snooped, got_regs, shmem, oob.clone(), 64)
    assert torch.equal(got_regs, want[0])


@pytest.mark.cuda
def test_runs_on_the_card_leave_the_callers_state_unchanged(dev):
    cfg = SMConfig(n_threads=64, dim_x=64, shmem_depth=128)
    words = assemble("TDX R1\nADD.INT32 R2, R1, R1\nNOP\nNOP\n"
                     "STO R2, (R1)+0\nLOD R3, (R1)+1\nSTOP").words
    prev = init_state(cfg, device=dev)
    before = prev.regs.clone(), prev.shmem.clone()
    build.reset_launches()
    fin = run(cfg, words, state=prev)
    assert build.launches["alu"] == 1 and build.launches["scatter"] == 1
    assert build.launches["gather"] == 1
    assert torch.equal(prev.regs, before[0])
    assert torch.equal(prev.shmem, before[1])
    want = run(cfg, words, state=init_state(cfg), backend="cpu")
    assert torch.equal(fin.regs.cpu(), want.regs)
    assert torch.equal(fin.shmem.cpu(), want.shmem)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["step", "trace", "megakernel"])
def test_launches_on_the_card_leave_the_callers_gmem_unchanged(dev, engine):
    # SAXPY-1024 on four SMs (two waves), its image passed as a tensor on
    # the card: one GLD and GST launch per row, the caller's tensor kept
    from repro_torch.core import DeviceConfig, launch
    from repro_torch.core.programs.saxpy import saxpy_grid_program

    n = 1024
    rng = np.random.default_rng(11)
    image = np.zeros(3 * n + 16, np.float32)
    image[:2 * n] = rng.standard_normal(2 * n)
    image[3 * n] = 2.5
    given = torch.from_numpy(image.view(np.int32)).to(dev)
    keep = given.clone()
    words = saxpy_grid_program(n, 128)
    kw = dict(n_sms=4, global_mem_depth=3 * n + 16, engine=engine,
              sm=SMConfig(max_steps=10_000))
    build.reset_launches()
    res = launch(DeviceConfig(**kw), words, grid=(8,), block=128,
                 gmem=given)
    assert build.launches["gather_shared"] == 2 * 3
    assert build.launches["scatter_shared"] == 2 * 1
    assert torch.equal(given, keep)
    want = launch(DeviceConfig(**kw, backend="cpu"), words, grid=(8,),
                  block=128, gmem=image)
    assert torch.equal(res.gmem.cpu(), want.gmem)
    assert torch.equal(res.oob.cpu(), want.oob)
    z = res.gmem[2 * n:3 * n].view(torch.float32).cpu().numpy()
    np.testing.assert_allclose(z, 2.5 * image[:n] + image[n:2 * n],
                               rtol=1e-6)


def _merged_launches():
    """Heterogeneous grids for the merged engines: FFT-64 x 6 beside
    QRD-16 x 3 on four SMs (grid order and length packing), and the fused
    two-stage reduction of 1024 elements (one program per wave, merged
    all the same)."""
    from repro_torch.core import DeviceConfig
    from repro_torch.core.programs import (launch_fft_qrd,
                                           launch_reduction, mixed_device)

    rng = np.random.default_rng(21)
    xs = (rng.standard_normal((6, 64))
          + 1j * rng.standard_normal((6, 64))).astype(np.complex64)
    As = rng.standard_normal((3, 16, 16)).astype(np.float32)
    x = rng.standard_normal(1024).astype(np.float32)

    def mixed(packing):
        return lambda engine, backend: launch_fft_qrd(
            xs, As, device=dataclasses.replace(
                mixed_device(64, n_sms=4, backend=backend), engine=engine),
            packing=packing)[3]

    def fused(engine, backend):
        return launch_reduction(x, block=256, fused=True, device=DeviceConfig(
            n_sms=4, global_mem_depth=2048, engine=engine, backend=backend,
            sm=SMConfig(max_steps=50_000)))[1]

    return {"fft64_qrd16": mixed("grid"),
            "fft64_qrd16_length": mixed("length"),
            "reduction1024_fused": fused}


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["trace", "megakernel"])
@pytest.mark.parametrize("name", ["fft64_qrd16", "fft64_qrd16_length",
                                  "reduction1024_fused"])
def test_merged_waves_on_the_card_match_the_plain_versions(dev, engine,
                                                           name):
    from repro_torch.convert import launch_result_to_numpy

    run_launch = _merged_launches()[name]
    build.reset_launches()
    got = run_launch(engine, "cuda")
    torch.cuda.synchronize()
    launched = dict(build.launches)
    want = run_launch(engine, "cpu")
    assert got.engine == engine and got.trace_merge is not None
    g, w = launch_result_to_numpy(got), launch_result_to_numpy(want)
    for k in ("regs", "shmem", "gmem", "oob"):
        assert np.array_equal(g[k], w[k]), k
    assert got.profile() == want.profile()
    # FFT and QRD hold no global-port row; the reduction's stages load
    # their inputs and store their partials through it
    kernels = ("segment",) if engine == "megakernel" \
        else ("alu", "gather", "scatter")
    if name == "reduction1024_fused":
        kernels = ("gather_shared", "scatter_shared") + (
            ("segment",) if engine == "megakernel" else ("alu",))
    for k in kernels:
        assert launched[k] > 0, (k, launched)


# ---------------------------------------------------------------------------
# the kernel layer: wavefront_dot, fft_r2, mgs_qrd, flash_attention
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("draw", ["fuzzed", "tiny", "zeros"])
@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("n_sm", [1, 3, 24, 129, 4096])
def test_dot_kernel_matches_plain_version(dev, n_sm, mode, draw):
    # the kernel takes 4 SMs (128 wavefronts) a CTA: 1, 3 and 129 SMs
    # leave its last CTA partial, 1 and 3 its only one. ``tiny``: DOT
    # products and SUM sums around 2**-126 (denormal, flushed and normal
    # outcomes, and the products x86 flushes, tiny after rounding);
    # ``zeros``: normal draws with signed zeros and denormals in a's lanes
    # 12-15, the exact zero products the kernel keeps off its exact path
    rng = np.random.default_rng(40 + mode)
    if draw == "tiny":
        pa, pb = fuzz.tiny_product_words(rng, (2, n_sm, 512))
        words = (pa[0], pb[0]) if mode == 0 else pb
    elif draw == "zeros":
        words = [rng.standard_normal((n_sm, 512)).astype(np.float32).view(
            np.uint32) for _ in range(2)]
        pad = words[0].reshape(n_sm, 32, 16)[..., 12:]
        pad[...] = rng.choice(np.array([0, 0x80000000, 1, 0x807FFFFF],
                                       dtype=np.uint32), pad.shape)
    else:
        words = [fuzz.random_f32_words(rng, (n_sm, 512)) for _ in range(2)]
    a, b = (_words(x, dev).view(torch.float32) for x in words)
    mask = torch.from_numpy(rng.random((n_sm, 512)) < 0.6).to(dev)
    got = wavefront_dot(a, b, mask, mode, block_sm=1)
    want = wavefront_dot_plain(a, b, mask, mode)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, 1])
def test_dot_kernel_all_masked_gives_plus_zero(dev, mode):
    rng = np.random.default_rng(mode)
    words = fuzz.random_f32_words(rng, (9, 512))
    words[:, ::2] = 0x7FC00000                   # NaNs in every other lane
    a = _words(words, dev).view(torch.float32)
    got = wavefront_dot(a, a, torch.zeros((9, 512), dtype=torch.bool,
                                          device=dev), mode, block_sm=1)
    assert torch.equal(got.view(torch.int32),
                       torch.zeros((9, 32), dtype=torch.int32, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["a", "b", "mask"])
def test_dot_kernel_rejects_a_misaligned_view(dev, name):
    # a contiguous view 4 bytes past a 16-byte boundary: the kernel's
    # loads are 16 bytes wide
    args = {"a": torch.ones((8, 512), device=dev),
            "b": torch.ones((8, 512), device=dev),
            "mask": torch.ones((8, 512), dtype=torch.bool, device=dev)}
    t = args[name]
    skip = 4 // t.element_size()
    args[name] = torch.empty(t.numel() + skip, dtype=t.dtype,
                             device=dev)[skip:].view(8, 512).copy_(t)
    assert args[name].is_contiguous() and args[name].data_ptr() % 16
    with pytest.raises(ValueError, match=f"^{name} must start"):
        wavefront_dot(args["a"], args["b"], args["mask"], 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 64, 256, 1024, 4096, 16384])
@pytest.mark.parametrize("natural", [True, False])
def test_fft_kernel_matches_plain_version(dev, n, natural):
    # 37 and 5 rows fill no whole CTA (eight warp tiles up to N = 1024)
    rng = np.random.default_rng(n)
    rows = 37 if n <= 1024 else 5
    re, im = (torch.from_numpy(rng.standard_normal((rows, n)).astype(
        np.float32)).to(dev) for _ in range(2))
    for g, w in zip(fft_r2(re, im, block_b=1, natural=natural),
                    fft_r2_plain(re, im, natural)):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def _qrd_same_words(got, want):
    # word for word; NaNs compare as one word (where both compute one, its
    # payload is the arithmetic's)
    one_nan = lambda x: torch.where(torch.isnan(x), float("nan"), x)  # noqa: E731
    for g, w in zip(got, want):
        assert torch.equal(one_nan(g).view(torch.int32),
                           one_nan(w).view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 5, 8, 9, 15, 16, 17, 31, 32])
def test_qrd_kernel_matches_plain_version(dev, n):
    # lane groups of 8, 16 and 32, each full and with lanes past n
    rng = np.random.default_rng(n)
    a = torch.from_numpy(rng.standard_normal((64, n, n)).astype(
        np.float32)).to(dev)
    for g, w in zip(mgs_qrd(a), mgs_qrd_plain(a)):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 37, 4096])
def test_qrd_kernel_on_ragged_batches_matches_plain_version(dev, batch):
    # 8 matrices to a CTA at n = 16: 1 and 37 leave groups with no matrix
    rng = np.random.default_rng(batch)
    a = torch.from_numpy(rng.standard_normal((batch, 16, 16)).astype(
        np.float32)).to(dev)
    for g, w in zip(mgs_qrd(a, block_b=1), mgs_qrd_plain(a)):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 16, 32])
def test_qrd_kernel_on_non_finite_input_matches_plain_version(dev, n):
    # an infinity, a NaN, a zero column (q_j = 0 * inf) and a -inf: the
    # NaN masks the one-hot products of the reference leave. At n = 16
    # the non-finite 1 and 4 share their warps with the finite 0 and 5, in
    # the second and the first lane group; at n = 8 warp 0 holds 0-3, warp
    # 1 holds 4-7
    rng = np.random.default_rng(9 + n)
    a = rng.standard_normal((8, n, n)).astype(np.float32)
    a[1, 0, 0], a[2, n - 1, n // 2], a[4, 1, n - 1] = np.inf, np.nan, -np.inf
    a[3, :, n // 2] = 0.0
    a = torch.from_numpy(a).to(dev)
    q, r = mgs_qrd(a)
    _qrd_same_words((q, r), mgs_qrd_plain(a))
    assert torch.isfinite(q[0]).all() and torch.isnan(q[1]).any()
    # a finite matrix beside a non-finite one in the same warp gives what
    # it gives alone
    for m in (0, 5, 6, 7):
        assert torch.isfinite(q[m]).all() and torch.isfinite(r[m]).all()
        for g, w in zip((q[m], r[m]), mgs_qrd_plain(a[m:m + 1])):
            assert torch.equal(g.view(torch.int32), w[0].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("bad_slot", [0, 1])
def test_qrd_kernel_keeps_a_warp_neighbour_finite(dev, bad_slot):
    # two matrices of order 16 in one warp, the non-finite one in either
    # lane group
    rng = np.random.default_rng(20 + bad_slot)
    a = rng.standard_normal((2, 16, 16)).astype(np.float32)
    a[bad_slot, 8, 0], a[bad_slot, 0, 15] = np.nan, np.inf
    a = torch.from_numpy(a).to(dev)
    q, r = mgs_qrd(a)
    _qrd_same_words((q, r), mgs_qrd_plain(a))
    good = 1 - bad_slot
    assert torch.isnan(q[bad_slot]).any()
    for g, w in zip((q[good], r[good]), mgs_qrd_plain(a[good:good + 1])):
        assert torch.equal(g.view(torch.int32), w[0].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 16, 32])
def test_qrd_kernel_on_overflowing_norms_matches_plain_version(dev, n):
    # column scales whose norms overflow or underflow (recip 0 or inf), a
    # sprinkle of non-finite words, and a finite column whose products
    # overflow only in later columns: partial NaN masks
    rng = np.random.default_rng(30 + n)
    a = rng.standard_normal((64, n, n))
    scale = rng.choice([1.0, 1e20, 1e30, 1e-25, 1e-40, 3e38],
                       size=(64, 1, n), p=[.5, .1, .1, .1, .1, .1])
    with np.errstate(over="ignore"):
        a = (a * scale).astype(np.float32)
    hit = rng.random(a.shape) < 0.02
    a[hit] = rng.choice([np.inf, -np.inf, np.nan], size=int(hit.sum()))
    a[2] = rng.standard_normal((n, n))
    a[2, :, 0] = 2e38
    a = torch.from_numpy(a).to(dev)
    _qrd_same_words(mgs_qrd(a), mgs_qrd_plain(a))


@pytest.mark.cuda
def test_launches_take_the_stream_of_their_tensors_device(dev):
    # the handle a wrapper hands its kernel is the current stream of the
    # tensors' device, and the kernel runs there: queued on s behind a
    # sleep and the copy of its input, it factors the copied matrices (a
    # launch on any other stream would run at once, on the NaNs). One
    # launch first loads the library and the kernel, which would otherwise
    # take longer than the sleep
    src = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (37, 16, 16)).astype(np.float32)).to("cuda:0")
    mgs_qrd(src, block_b=1)
    a = torch.full_like(src, float("nan"))
    torch.cuda.synchronize()
    s = torch.cuda.Stream(device="cuda:0")
    with torch.cuda.stream(s):
        assert build.current_stream(torch.device("cuda:0")) == s.cuda_stream
        torch.cuda._sleep(100_000_000)
        a.copy_(src)
        got = mgs_qrd(a, block_b=1)
    s.synchronize()
    assert build.current_stream(torch.device("cuda:0")) != s.cuda_stream
    for g, w in zip(got, mgs_qrd_plain(src)):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape,blk_q,blk_k", [((3, 256, 64), 64, 32),
                                               ((2, 96, 33), 16, 48),
                                               ((2, 256, 1), 16, 256),
                                               ((2, 320, 96), 64, 16),
                                               ((1, 512, 128), 256, 128)])
def test_flash_kernel_matches_plain_version(dev, dtype, causal, shape,
                                            blk_q, blk_k):
    # fp32: the kernel and the plain version sum the products in another
    # order (atol 2e-5, the reference's own bar); bf16: one bf16 ulp
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(int(causal))
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev, dtype) for _ in range(3))
    got = flash_attention(q, k, v, causal=causal, blk_q=blk_q, blk_k=blk_k)
    want = flash_attention_plain(q, k, v, causal, blk_q, blk_k)
    assert got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=1e-5,
                                   rtol=2.0 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
@pytest.mark.parametrize("causal,shape,blk_q,blk_k", [
    (True, (2, 192, 64), 8, 24), (True, (2, 128, 32), 16, 16),
    (True, (1, 512, 128), 256, 128), (True, (2, 256, 64), 128, 128),
    (True, (2, 320, 96), 64, 16), (False, (2, 80, 33), 16, 16)])
def test_flash_kernel_on_non_finite_input_matches_plain_version(
        dev, dtype, bad, causal, shape, blk_q, blk_k):
    # a non-finite v enters a row as p = 0 or p > 0 times it where the
    # row's live key blocks hold it, and not at all past them; one in k
    # spoils the rows that see its key unmasked
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(13)
    bh, S, D = shape
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    v[0, S // 2 + 3, 1], v[-1, 5, D - 1], k[0, S // 3, 0] = bad, bad, bad
    v[-1, S - 1, D // 2] = bad
    q, k, v = (torch.from_numpy(x).to(dev, dtype) for x in (q, k, v))
    got = flash_attention(q, k, v, causal=causal, blk_q=blk_q,
                          blk_k=blk_k).float()
    want = flash_attention_plain(q, k, v, causal, blk_q, blk_k).float()
    for where in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(where(got), where(want))
    fin = torch.isfinite(want)
    assert fin.any() and not fin.all()
    if dtype == torch.float32:
        torch.testing.assert_close(got[fin], want[fin], atol=2e-5, rtol=0)
    else:
        torch.testing.assert_close(got[fin], want[fin], atol=1e-5,
                                   rtol=2.0 ** -7)


@pytest.mark.cuda
def test_each_ops_call_launches_its_kernel_once(dev):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 512)).astype(np.float32)
    a = rng.standard_normal((4, 16, 16)).astype(np.float32)
    s = rng.standard_normal((2, 128, 64)).astype(np.float32)
    calls = {"dot": lambda: ops.dot(x, x),
             "fft": lambda: ops.fft(x, x),
             "qrd": lambda: ops.qrd(a),
             "flash": lambda: ops.flash(s, s, s, blk_q=64, blk_k=64)}
    for name, call in calls.items():
        before = dict(build.launches)
        call()
        torch.cuda.synchronize()
        assert build.launches[name] == before[name] + 1, name
        assert all(build.launches[k] == before[k]
                   for k in before if k != name), name


# ---------------------------------------------------------------------------
# the fleet, the LaunchServer and global-memory images on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_as_u32_image_of_a_card_tensor_makes_no_host_copy(dev, dtype):
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.core.machine import as_u32_image

    class HostOps(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if isinstance(out, torch.Tensor) and not out.is_cuda:
                self.ops.append(str(func))
            return out

    src = torch.arange(100, device=dev).to(dtype)
    with HostOps() as mode:
        img = as_u32_image(src, 128)
    assert not mode.ops, mode.ops
    assert img.is_cuda and img.dtype == torch.int32 and img.shape == (128,)
    assert img.data_ptr() != src.data_ptr()
    assert torch.equal(img.cpu(), as_u32_image(src.cpu(), 128))


def _fleet_grids():
    """Fleet launches of two devices of four SMs for the card tests:
    FFT-64 x 6 interleaved with QRD-16 x 3 on the megakernel and on the
    trace engine, and SAXPY-4096 on the megakernel."""
    from repro_torch.core import DeviceConfig, FleetConfig, launch_fleet
    from repro_torch.core.programs import (fft_kernel, fft_shmem,
                                           mixed_device, qrd_kernel,
                                           qrd_shmem)
    from repro_torch.core.programs.saxpy import saxpy_grid_program

    rng = np.random.default_rng(31)
    xs = (rng.standard_normal((6, 64))
          + 1j * rng.standard_normal((6, 64))).astype(np.complex64)
    As = rng.standard_normal((3, 16, 16)).astype(np.float32)
    n = 4096
    buffers = {"x": rng.standard_normal(n).astype(np.float32),
               "y": rng.standard_normal(n).astype(np.float32),
               "z": np.zeros(n, np.float32),
               "alpha": np.asarray([2.5], np.float32)}

    def mixed(engine):
        def run(backend, route="block", placement="auto"):
            dcfg = dataclasses.replace(
                mixed_device(64, n_sms=4, backend=backend), engine=engine)
            sh = [np.stack([fft_shmem(x, 1024) for x in xs]),
                  np.stack([qrd_shmem(A, 1024) for A in As])]
            return launch_fleet(
                FleetConfig(n_devices=2, device=dcfg, route=route,
                            placement=placement),
                programs=[fft_kernel(64), qrd_kernel()],
                grid_map=[0, 1, 0, 1, 0, 1, 0, 0, 0], shmem=sh)
        return run

    def saxpy(backend, route="block", placement="auto"):
        dcfg = DeviceConfig(n_sms=4, global_mem_depth=3 * n + 16,
                            backend=backend, engine="megakernel",
                            sm=SMConfig(max_steps=10_000))
        return launch_fleet(
            FleetConfig(n_devices=2, device=dcfg, route=route,
                        placement=placement),
            saxpy_grid_program(n, 512), grid=(8,), block=512,
            buffers=buffers)

    return {"fft64_qrd16_megakernel": (mixed("megakernel"), ("segment",)),
            "fft64_qrd16_trace": (mixed("trace"),
                                  ("alu", "gather", "scatter")),
            "saxpy4096": (saxpy, ("segment", "gather_shared",
                                  "scatter_shared"))}


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["block", "kernel"])
@pytest.mark.parametrize("name", ["fft64_qrd16_megakernel",
                                  "fft64_qrd16_trace", "saxpy4096"])
def test_fleet_sub_launches_run_the_kernels_on_the_card(dev, name, route):
    from repro_torch.convert import launch_result_to_numpy

    run, kernels = _fleet_grids()[name]
    # one card: "auto" keeps the sub-launches on it, as the host run does
    cards = torch.cuda.device_count()
    placement = "auto" if cards < 2 else "host"
    build.reset_launches()
    got = run("cuda", route=route, placement=placement)
    torch.cuda.synchronize()
    launched = dict(build.launches)
    want = run("cpu", route=route, placement=placement)
    g, w = launch_result_to_numpy(got), launch_result_to_numpy(want)
    for k in ("regs", "shmem", "gmem", "oob"):
        assert np.array_equal(g[k], w[k]), k
    assert got.gmem.is_cuda
    pg, pw = got.profile(), want.profile()
    reason = pg["fleet"].pop("placement_reason")
    pw["fleet"].pop("placement_reason")
    if name == "saxpy4096" and route == "block" and cards < 2:
        assert reason == f"torch exposes {cards} CUDA device(s) < 2"
    assert pg == pw
    for k in kernels:
        assert launched[k] > 0, (k, launched)


@pytest.mark.cuda
def test_threaded_server_round_trip_on_the_card(dev):
    from repro_torch.core import DeviceConfig
    from repro_torch.core.programs import fft_kernel, fft_shmem
    from repro_torch.serve import LaunchRequest, LaunchServer

    rng = np.random.default_rng(12)
    xs = (rng.standard_normal((6, 16))
          + 1j * rng.standard_normal((6, 16))).astype(np.complex64)

    def server(backend):
        return LaunchServer(DeviceConfig(
            n_sms=2, global_mem_depth=128, backend=backend,
            sm=SMConfig(shmem_depth=64, max_steps=200_000)), max_batch=4)

    host = server("cpu")
    want = [host.submit(LaunchRequest(kernel=fft_kernel(16),
                                      shmem=fft_shmem(x, 64))) for x in xs]
    host.drain()
    card = server("cuda")
    card.start()
    try:
        futs = [card.submit(LaunchRequest(kernel=fft_kernel(16),
                                          shmem=fft_shmem(x, 64)))
                for x in xs]
        got = [f.result(timeout=120) for f in futs]
    finally:
        card.stop()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        # read on another stream than the batcher's: the futures hold
        # finished results
        words = [r.shmem.clone() for r in got]
    side.synchronize()
    for w, r, f in zip(words, got, want):
        assert r.shmem.is_cuda and r.finish_reason == "ok"
        assert torch.equal(w.cpu(), f.result().shmem)
        assert r.latency_cycles == r.wait_cycles + r.cycles
    assert card.stats()["completed"] == 6 and card.queue_depth == 0


@pytest.mark.cuda
@pytest.mark.skipif(torch.cuda.device_count() < 2,
                    reason="one card per simulated eGPU needs at least two "
                    f"CUDA devices; torch exposes {torch.cuda.device_count()}")
def test_shard_map_placement_runs_a_device_per_card(dev):
    run, _ = _fleet_grids()["saxpy4096"]
    got = run("cuda", placement="shard_map")
    want = run("cuda", placement="host")
    fleet = got.profile()["fleet"]
    assert fleet["placement"] == "shard_map" and got.engine == "trace"
    for k in ("regs", "shmem", "gmem", "oob"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert got.gmem.device == want.gmem.device
    assert run("cuda").profile()["fleet"]["placement"] == "shard_map"


def _fresh_lowering():
    from repro_torch.core import cycles, trace_engine

    trace_engine.compile_cache_clear()
    cycles._trace_cached.cache_clear()


@pytest.mark.cuda
def test_plan_loaded_from_disk_runs_on_the_card_as_a_fresh_one(
        dev, tmp_path, monkeypatch):
    from repro_torch.core import compile_cache
    from repro_torch.core.programs import launch_fft_qrd, mixed_device

    rng = np.random.default_rng(21)
    xs = (rng.standard_normal((8, 64))
          + 1j * rng.standard_normal((8, 64))).astype(np.complex64)
    As = rng.standard_normal((4, 16, 16)).astype(np.float32)

    def run():
        return launch_fft_qrd(xs, As, device=mixed_device(64, n_sms=4))[3]

    monkeypatch.setattr(compile_cache, "_resolved", True)
    monkeypatch.setattr(compile_cache, "_active", None)
    _fresh_lowering()
    fresh = run()                                   # no cache: lowered
    compile_cache.configure(str(tmp_path / "cache"))
    _fresh_lowering()
    run()                                           # lowered and stored
    _fresh_lowering()
    build.reset_launches()
    loaded = run()                                  # every plan from disk
    torch.cuda.synchronize()
    s = compile_cache.stats()
    monkeypatch.setattr(compile_cache, "_active", None)
    _fresh_lowering()
    assert s["errors"] == 0 and s["by_kind"]["megakernel"]["hits"] == 2, s
    assert loaded.engine == "megakernel" and build.launches["segment"] > 0
    for k in ("regs", "shmem", "gmem", "oob"):
        assert torch.equal(getattr(loaded, k), getattr(fresh, k)), k
    assert loaded.profile() == fresh.profile()


@pytest.mark.cuda
def test_entry_written_beside_the_card_loads_on_the_host_alone(
        dev, tmp_path, monkeypatch):
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.core import compile_cache, trace_engine
    from repro_torch.core.programs.fft import fft_program

    cfg = SMConfig(n_threads=32, dim_x=32, shmem_depth=192,
                   max_steps=200_000)
    monkeypatch.setattr(compile_cache, "_resolved", True)
    monkeypatch.setattr(compile_cache, "_active", None)
    compile_cache.configure(str(tmp_path / "cache"))
    _fresh_lowering()
    plan = trace_engine.compile_megakernel(fft_program(64), cfg)
    plan.device_table(dev)                           # a card-resident table
    plan.device_barriers(dev)
    stats = compile_cache.stats()
    monkeypatch.setattr(compile_cache, "_active", None)
    _fresh_lowering()
    assert stats["by_kind"]["megakernel"]["stores"] == 1
    root = Path(__file__).resolve().parents[1]
    code = (
        "import json\n"
        "from repro_torch.core import compile_cache, trace_engine, SMConfig\n"
        "from repro_torch.core.programs.fft import fft_program\n"
        "plan = trace_engine.compile_megakernel(fft_program(64), SMConfig(\n"
        "    n_threads=32, dim_x=32, shmem_depth=192, max_steps=200_000))\n"
        "print(json.dumps([compile_cache.stats(), plan.stats()]))\n")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, cwd=root,
        env={**os.environ, "PYTHONPATH": str(root / "src"),
             "CUDA_VISIBLE_DEVICES": "",
             "EGPU_CACHE_DIR": str(tmp_path / "cache")})
    assert out.returncode == 0, out.stderr[-3000:]
    import json

    got, plan_stats = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["misses"] == 0 and got["errors"] == 0, got
    assert got["by_kind"]["megakernel"]["hits"] == 1
    assert plan_stats == plan.stats()


# ---------------------------------------------------------------------------
# the LM serving path (plain PyTorch on the card)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_build_model_puts_its_weights_on_the_card(dev):
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    model = build_model(get_arch("granite-3-2b", smoke=True))
    assert {p.device.type for p in model.parameters()} == {"cuda"}
    assert model.device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["granite-3-2b", "recurrentgemma-2b"])
def test_smoke_engine_on_the_card_equals_the_host(dev, name):
    import copy

    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.serve import Engine

    cfg = get_arch(name, smoke=True)
    card = serve.build_engine(cfg, device="cuda")
    host = Engine(copy.deepcopy(card.model).to("cpu"), max_slots=4,
                  capacity=128)
    line = serve.drive(card, cfg)
    assert serve.drive(host, cfg)["tokens"] == line["tokens"]
    assert {r: q.out for r, q in card.requests.items()} == \
        {r: q.out for r, q in host.requests.items()}
    assert card.finish_reasons() == host.finish_reasons()
    assert card.active_history == host.active_history


# ---------------------------------------------------------------------------
# the LM stack's training path (plain PyTorch): the card against the host
# ---------------------------------------------------------------------------

def _train_step(model, batch, lr=1e-3):
    from repro_torch.configs import RunConfig
    from repro_torch.train import init_state as train_state
    from repro_torch.train import make_train_step

    rc = RunConfig(learning_rate=lr, warmup_steps=0, weight_decay=0.1)
    dev = model.device
    return make_train_step(model, rc)(train_state(model, rc),
                                      {k: v.to(dev) for k, v in
                                       batch.items()})


def _train_batch(cfg, B=2, S=32, step=0):
    from repro_torch.data import make_batch, spec_for

    return make_batch(cfg, spec_for(cfg, None, 3, batch=B, seq=S), step,
                      device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["granite-3-2b", "deepseek-moe-16b",
                                  "mamba2-780m", "recurrentgemma-2b",
                                  "whisper-tiny", "internvl2-76b"])
def test_train_step_on_the_card_equals_the_host(dev, name):
    # the bars of tests/test_torch_lm_train_parity.py: a weight whose
    # gradient is at float32 noise may take the other sign and move by up
    # to 2 lr; few do, the rest agree within 1e-6
    import copy

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    cfg = get_arch(name, smoke=True)
    card = build_model(cfg, device=dev)
    host = copy.deepcopy(card).to("cpu")
    b = _train_batch(cfg)
    sc, mc = _train_step(card, b)
    sh, mh = _train_step(host, b)
    assert abs(float(mc["loss"]) - float(mh["loss"])) <= 1e-5
    assert abs(float(mc["grad_norm"]) - float(mh["grad_norm"])) <= \
        1e-5 * float(mh["grad_norm"])
    beyond = n = 0
    for k, p in sh.params.items():
        diff = (sc.params[k].detach().cpu() - p.detach()).abs()
        assert float(diff.max()) <= 2e-3 + 1e-6, k
        beyond += int((diff > 1e-6).sum())
        n += diff.numel()
    assert beyond <= 1e-3 * n


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["granite-3-2b", "deepseek-moe-16b",
                                  "mamba2-780m", "recurrentgemma-2b",
                                  "whisper-tiny", "internvl2-76b"])
def test_two_identical_train_steps_on_the_card_are_bit_equal(dev, name):
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    cfg = get_arch(name, smoke=True)
    b = _train_batch(cfg)
    (s1, m1), (s2, m2) = (_train_step(build_model(cfg, device=dev), b)
                          for _ in range(2))
    assert torch.equal(m1["loss"], m2["loss"])
    assert torch.equal(m1["grad_norm"], m2["grad_norm"])
    for k, p in s1.params.items():
        assert torch.equal(p, s2.params[k]), k
        assert torch.equal(s1.opt.mu[k], s2.opt.mu[k]), k
        assert torch.equal(s1.opt.nu[k], s2.opt.nu[k]), k


@pytest.mark.cuda
def test_checkpoint_taken_on_the_card_restores_on_the_host(dev, tmp_path):
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.data import PipelineSpec
    from repro_torch.models import build_model
    from repro_torch.train import init_state as train_state
    from repro_torch.train import train_loop

    cfg = get_arch("granite-3-2b", smoke=True)
    rc = RunConfig(learning_rate=3e-3, warmup_steps=2, ckpt_dir=str(tmp_path),
                   ckpt_every=3, async_ckpt=True, seed=1)
    spec = PipelineSpec(cfg.vocab_size, 32, 4, seed=1)
    res = train_loop(build_model(cfg, device=dev, seed=1), cfg, rc, spec,
                     n_steps=3)
    host_like = train_state(build_model(cfg, device="cpu", seed=2), rc)
    got, extra = ckpt.restore(str(tmp_path), host_like)
    assert extra["step"] == 3 and int(got.step) == 3
    for k, p in res.state.params.items():
        for a, b in ((got.params[k], p), (got.opt.mu[k], res.state.opt.mu[k]),
                     (got.opt.nu[k], res.state.opt.nu[k])):
            assert a.device.type == "cpu" and a.dtype == b.dtype
            assert torch.equal(a, b.cpu()), k
