"""The memory kernels and the fused segment: wrappers and plain versions.

  * ``simt_gather``         — LOD on the step path: each SM's lanes gather
    from that SM's own shared-memory image (CUDA: ``csrc/smem.cu``);
  * ``simt_scatter``        — STO on the step path: the single write port,
    the highest enabled thread wins on an address collision (CUDA:
    ``csrc/smem.cu``);
  * ``simt_segment``        — a fused run of SM-local rows over an SM
    batch, registers and shared memory resident on chip for the whole run
    (CUDA: ``csrc/segment.cu``; plain: ``core.executor.apply_segment_rows``);
  * ``simt_gather_shared``  — GLD: every SM's lanes gather from the one
    device-wide global-memory image (CUDA: ``csrc/gmem.cu``);
  * ``simt_scatter_shared`` — GST: the single device-wide port drains in
    (sm, thread) order, the last enabled writer to an address wins
    (CUDA: ``csrc/gmem.cu``).

A wrapper takes the plain version only because the tensors it was given
lie on the host. For tensors on the card it launches its kernel (on the
current stream, without synchronising) or raises; it never falls back.
Words are ``torch.int32``; masks are ``torch.bool``.
"""
from __future__ import annotations

import torch

from . import build
from .build import MAX_DYNAMIC_SMEM, check_tensor, current_stream

N_FIELDS = 15


# ---------------------------------------------------------------------------
# fused segment
# ---------------------------------------------------------------------------

def segment_smem_bytes(depth: int) -> int:
    """Dynamic shared memory of one segment CTA: the register file, the
    shared-memory image and the store-port winner array."""
    # the core's executor imports this module: take its machine constants
    # at call time, so that either may be imported first
    from ..core.machine import MAX_THREADS, N_REGS

    return 4 * (MAX_THREADS * N_REGS + 2 * depth)


def simt_segment(cfg, rows: torch.Tensor, block_idx, prog_idx, regs, shmem,
                 oob, *, shmem_depth: int | None = None):
    """Run the fused rows ``rows`` ((n_rows, 15) int32, ``FIELDS`` order)
    over the SM batch ``regs`` (n, 512, 16), ``shmem`` (n, depth),
    ``oob`` (n,) bool with per-SM ``block_idx``/``prog_idx`` (n,) int32.
    Returns new ``(regs, shmem, oob)``; the inputs are not modified."""
    if not regs.is_cuda:
        from ..core.executor import apply_segment_rows

        return apply_segment_rows(cfg, rows, block_idx, prog_idx, regs,
                                  shmem, oob, shmem_depth=shmem_depth)
    from ..core.machine import MAX_THREADS, N_REGS

    n, depth = shmem.shape
    dev = regs.device
    check_tensor(rows, "rows", torch.int32, (rows.shape[0], N_FIELDS), dev)
    check_tensor(block_idx, "block_idx", torch.int32, (n,), dev)
    check_tensor(prog_idx, "prog_idx", torch.int32, (n,), dev)
    check_tensor(regs, "regs", torch.int32, (n, MAX_THREADS, N_REGS), dev)
    check_tensor(shmem, "shmem", torch.int32, (n, depth), dev)
    check_tensor(oob, "oob", torch.bool, (n,), dev)
    bound = depth if shmem_depth is None else int(shmem_depth)
    if not 1 <= bound <= depth:
        raise ValueError(f"shmem_depth={bound} outside [1, {depth}]")
    if segment_smem_bytes(depth) > MAX_DYNAMIC_SMEM:
        raise ValueError(f"a {depth}-word shared memory needs "
                         f"{segment_smem_bytes(depth)} bytes of shared "
                         f"memory per CTA, above {MAX_DYNAMIC_SMEM}")
    regs_o, shmem_o, oob_o = (torch.empty_like(regs),
                              torch.empty_like(shmem), torch.empty_like(oob))
    if n and rows.shape[0]:
        fn = build.entry_point("egpu_segment")
        build.check(fn(rows.data_ptr(), rows.shape[0], block_idx.data_ptr(),
                       prog_idx.data_ptr(), regs.data_ptr(),
                       shmem.data_ptr(), oob.data_ptr(), regs_o.data_ptr(),
                       shmem_o.data_ptr(), oob_o.data_ptr(), n, depth, bound,
                       cfg.n_threads, cfg.dim_x, current_stream()), "segment")
        build.launches["segment"] += 1
        return regs_o, shmem_o, oob_o
    return regs.clone(), shmem.clone(), oob.clone()


# ---------------------------------------------------------------------------
# the per-SM shared-memory port (LOD/STO rows of the step and trace engines)
# ---------------------------------------------------------------------------

def gather_plain(mem, addr, mask, old):
    """LOD: ``out[s, t] = mem[s, addr[s, t]]`` where ``mask``, else ``old``
    (``addr`` pre-clipped to the image)."""
    return torch.where(mask, torch.gather(mem, 1, addr.to(torch.int64)), old)


def scatter_plain(mem, addr, vals, do):
    """STO: per SM, among enabled writers to one address the highest
    thread wins; disabled lanes write nothing."""
    from ..core.executor import _last_writer_write

    return _last_writer_write(mem, addr, vals, do)


def scatter_smem_bytes(depth: int) -> int:
    """Dynamic shared memory of one scatter CTA: the winner array."""
    return 4 * depth


def check_gather_args(mem, addr, mask, old) -> None:
    """Raise unless the LOD kernel takes these tensors as they are."""
    n, depth = mem.shape
    dev = mem.device
    check_tensor(mem, "mem", torch.int32, (n, depth), dev)
    for t, name, dt in ((addr, "addr", torch.int32),
                        (mask, "mask", torch.bool), (old, "old", torch.int32)):
        check_tensor(t, name, dt, (n, old.shape[1]), dev)


def check_scatter_args(mem, addr, vals, do) -> None:
    """Raise unless the STO kernel takes these tensors as they are."""
    n, depth = mem.shape
    dev = mem.device
    check_tensor(mem, "mem", torch.int32, (n, depth), dev)
    k = vals.shape[1]
    for t, name, dt in ((addr, "addr", torch.int32),
                        (vals, "vals", torch.int32), (do, "do", torch.bool)):
        check_tensor(t, name, dt, (n, k), dev)
    if not 1 <= k <= 1024:
        raise ValueError(f"{k} lanes per SM do not fit one CTA")
    if scatter_smem_bytes(depth) > MAX_DYNAMIC_SMEM:
        raise ValueError(f"a {depth}-word shared memory needs "
                         f"{scatter_smem_bytes(depth)} bytes of shared "
                         f"memory per CTA, above {MAX_DYNAMIC_SMEM}")


def simt_gather(mem, addr, mask, old):
    """LOD gather. ``mem`` (n, depth) int32; ``addr`` (n, k) int32 within
    ``[0, depth)``; ``mask`` (n, k) bool; ``old`` (n, k) int32. Returns the
    new destination column."""
    if not mem.is_cuda:
        return gather_plain(mem, addr, mask, old)
    check_gather_args(mem, addr, mask, old)
    n, depth = mem.shape
    out = torch.empty_like(old)
    fn = build.entry_point("egpu_gather")
    build.check(fn(mem.data_ptr(), depth, addr.data_ptr(), mask.data_ptr(),
                   old.data_ptr(), out.data_ptr(), old.shape[1], old.numel(),
                   current_stream()), "gather")
    build.launches["gather"] += 1
    return out


def simt_scatter(mem, addr, vals, do):
    """STO scatter. ``mem`` (n, depth) int32; ``addr``/``vals`` (n, k)
    int32, ``addr`` within ``[0, depth)`` where ``do``; ``do`` (n, k) bool.
    Returns the new shared-memory images; ``mem`` is not modified."""
    if not mem.is_cuda:
        return scatter_plain(mem, addr, vals, do)
    check_scatter_args(mem, addr, vals, do)
    n, depth = mem.shape
    k = vals.shape[1]
    out = torch.empty_like(mem)
    fn = build.entry_point("egpu_scatter")
    build.check(fn(mem.data_ptr(), depth, addr.data_ptr(), vals.data_ptr(),
                   do.data_ptr(), out.data_ptr(), n, k,
                   current_stream()), "scatter")
    build.launches["scatter"] += 1
    return out


# ---------------------------------------------------------------------------
# the device-wide global-memory port
# ---------------------------------------------------------------------------

def gather_shared_plain(gmem, addr, mask, old):
    """GLD: ``out[s, t] = gmem[addr[s, t]]`` where ``mask``, else ``old``
    (``addr`` pre-clipped to the image)."""
    return torch.where(mask, gmem[addr.to(torch.int64)], old)


def scatter_shared_plain(gmem, addr, vals, do):
    """GST: over the flattened (sm, thread) lanes the last enabled writer
    to an address wins; disabled lanes write nothing."""
    from ..core.executor import _last_writer_write

    return _last_writer_write(gmem[None], addr.reshape(1, -1),
                              vals.reshape(1, -1), do.reshape(1, -1))[0]


def check_gather_shared_args(gmem, addr, mask, old) -> None:
    """Raise unless the GLD kernel takes these tensors as they are."""
    dev = gmem.device
    check_tensor(gmem, "gmem", torch.int32, (gmem.shape[0],), dev)
    for t, name, dt in ((addr, "addr", torch.int32),
                        (mask, "mask", torch.bool), (old, "old", torch.int32)):
        check_tensor(t, name, dt, old.shape, dev)


def check_scatter_shared_args(gmem, addr, vals, do) -> None:
    """Raise unless the GST kernel takes these tensors as they are."""
    dev = gmem.device
    check_tensor(gmem, "gmem", torch.int32, (gmem.shape[0],), dev)
    for t, name, dt in ((addr, "addr", torch.int32),
                        (vals, "vals", torch.int32), (do, "do", torch.bool)):
        check_tensor(t, name, dt, vals.shape, dev)


def simt_gather_shared(gmem, addr, mask, old):
    """GLD gather. ``gmem`` (gdepth,) int32; ``addr`` (n, 512) int32
    within ``[0, gdepth)``; ``mask`` (n, 512) bool; ``old`` (n, 512)
    int32. Returns the new destination column."""
    if not gmem.is_cuda:
        return gather_shared_plain(gmem, addr, mask, old)
    check_gather_shared_args(gmem, addr, mask, old)
    out = torch.empty_like(old)
    fn = build.entry_point("egpu_gather_shared")
    build.check(fn(gmem.data_ptr(), gmem.shape[0], addr.data_ptr(),
                   mask.data_ptr(), old.data_ptr(), out.data_ptr(),
                   old.numel(), current_stream()), "gather_shared")
    build.launches["gather_shared"] += 1
    return out


def simt_scatter_shared(gmem, addr, vals, do):
    """GST scatter. ``gmem`` (gdepth,) int32; ``addr``/``vals`` (n, 512)
    int32, ``addr`` within ``[0, gdepth)`` where ``do``; ``do`` (n, 512)
    bool. Returns the new global-memory image."""
    if not gmem.is_cuda:
        return scatter_shared_plain(gmem, addr, vals, do)
    check_scatter_shared_args(gmem, addr, vals, do)
    out = gmem.clone()
    winner = torch.full_like(gmem, -1)
    fn = build.entry_point("egpu_scatter_shared")
    build.check(fn(out.data_ptr(), gmem.shape[0], addr.data_ptr(),
                   vals.data_ptr(), do.data_ptr(), winner.data_ptr(),
                   vals.numel(), current_stream()), "scatter_shared")
    build.launches["scatter_shared"] += 1
    return out
