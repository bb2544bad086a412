"""The port's CUDA kernels against their plain versions on the card.

Needs a CUDA device and skips without one. Imports neither JAX nor the
JAX package, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import SMConfig
from repro_torch.core.executor import apply_segment_rows
from repro_torch.kernels import build, fuzz, ops
from repro_torch.kernels.fft_r2 import fft_r2, fft_r2_plain
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.mgs_qrd import mgs_qrd, mgs_qrd_plain
from repro_torch.kernels.simt_alu import alu_plain, simt_alu
from repro_torch.kernels.wavefront_dot import (wavefront_dot,
                                               wavefront_dot_plain)
from repro_torch.kernels.simt_step import (
    gather_plain, gather_shared_plain, scatter_plain, scatter_shared_plain,
    simt_gather, simt_gather_shared, simt_scatter, simt_scatter_shared,
    simt_segment)


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
# the kernel layer: wavefront_dot, fft_r2, mgs_qrd, flash_attention
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, 1])
def test_dot_kernel_matches_plain_version(dev, mode):
    rng = np.random.default_rng(40 + mode)
    a, b = (_words(fuzz.random_f32_words(rng, (24, 512)), dev)
            .view(torch.float32) for _ in range(2))
    mask = torch.from_numpy(rng.random((24, 512)) < 0.6).to(dev)
    got = wavefront_dot(a, b, mask, mode)
    want = wavefront_dot_plain(a, b, mask, mode)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 64, 4096])
@pytest.mark.parametrize("natural", [True, False])
def test_fft_kernel_matches_plain_version(dev, n, natural):
    rng = np.random.default_rng(n)
    re, im = (torch.from_numpy(rng.standard_normal((16, n)).astype(
        np.float32)).to(dev) for _ in range(2))
    for g, w in zip(fft_r2(re, im, natural=natural),
                    fft_r2_plain(re, im, natural)):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 16, 32])
def test_qrd_kernel_matches_plain_version(dev, n):
    rng = np.random.default_rng(n)
    a = torch.from_numpy(rng.standard_normal((64, n, n)).astype(
        np.float32)).to(dev)
    for g, w in zip(mgs_qrd(a), mgs_qrd_plain(a)):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape,blk_q,blk_k", [((3, 256, 64), 64, 32),
                                               ((2, 96, 33), 16, 48)])
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
