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
from repro_torch.kernels import fuzz
from repro_torch.kernels.simt_alu import alu_plain, simt_alu
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
