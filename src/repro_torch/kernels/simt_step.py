"""The memory kernels and the fused segment: wrappers and plain versions.

  * ``simt_lod_row``        — one LOD data row of the step and trace
    engines: each SM's lanes load from that SM's own shared-memory image
    at ``wrap32(operand + imm)``; the address and gate are read from the
    register file on the card, and the destination register and the oob
    flags are written in place, one launch per row (CUDA:
    ``csrc/smem.cu``; plain: ``lod_row_plain``, out of place);
  * ``simt_gather``         — the same read port over pre-computed
    addresses, enables and old words (tile form);
  * ``simt_sto_row``        — one STO data row of the step and trace
    engines: the single write port, the highest enabled thread wins on an
    address collision; the address, gate and stored word are read from
    the register file on the card, and the image and the oob flags are
    written in place, one launch per row (CUDA: ``csrc/smem.cu``; plain:
    ``sto_row_plain``, out of place);
  * ``simt_scatter``        — the same write port over pre-computed
    addresses, values and enables (tile form, on the same kernel body);
  * ``simt_segment``        — a fused run of SM-local rows over an SM
    batch, registers, shared memory and the row table resident on chip for
    the whole run, with barriers only where ``segment_barriers`` places
    them (CUDA: ``csrc/segment.cu``; plain:
    ``core.executor.apply_segment_rows``);
  * ``simt_gld_row``        — one GLD data row of the step, trace and
    megakernel engines: every SM's lanes load from the one device-wide
    global-memory image, as it was at the start of the row; the LOD row
    kernel with an SM stride of 0, ``rd`` and the oob flags written in
    place, one launch per row (CUDA: ``csrc/gmem.cu``; plain:
    ``gld_row_plain``, out of place);
  * ``simt_gather_shared``  — the same read port over pre-computed
    addresses, enables and old words (tile form);
  * ``simt_gst_row``        — one GST data row of every engine: the single
    device-wide port drains in (sm, thread) order, so across the whole
    wave the last enabled writer to an address wins; the stored word is
    the thread's own ``rd``; the image and the oob flags are written in
    place, one launch of one CTA per row (CUDA: ``csrc/gmem.cu``; plain:
    ``gst_row_plain``, out of place);
  * ``simt_scatter_shared`` — the same write port over pre-computed
    addresses, values and enables (tile form, on the same kernel body).

A wrapper takes the plain version only because the tensors it was given
lie on the host. For tensors on the card it launches its kernel (on the
current stream, without synchronising) or raises; it never falls back.
Words are ``torch.int32``; masks are ``torch.bool``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import build, ref
from .build import MAX_DYNAMIC_SMEM, check_tensor
from .simt_alu import check_regs

N_FIELDS = 15


# ---------------------------------------------------------------------------
# fused segment
# ---------------------------------------------------------------------------

# a row's barrier bits: before its read phase, between its read and write
# phases
BARRIER_BEFORE_READ, BARRIER_BEFORE_WRITE = 1, 2
# table rows the segment kernel holds in shared memory at once (16 words
# each: the 15 fields and the bits); a longer segment is copied in chunks
SEGMENT_CHUNK_ROWS = 512
_ROW_BYTES = 64

# columns of a FIELDS-ordered row table
(_SEL, _OPCODE, _TYP, _RD, _RA, _RB, _IMM, _X, _EXT_A, _EXT_B, _PEN, _PREG,
 _PNEG, _ACT_WAVES, _ACT_WTHREADS) = range(N_FIELDS)
# data-switch branches that read operand a / operand b with the row's
# snooping, and those that write their destination register
_READS_A = frozenset((1, 2, 3, 6, 10, 11))
_READS_B = frozenset((1, 6, 10, 11))
_WRITES_RD = frozenset((1, 2, 4, 5, 6, 7, 10, 11))


def segment_barriers(rows) -> np.ndarray:
    """The barriers a fused run of ``rows`` ((n_rows, 15) ``FIELDS``
    order) needs in the segment kernel, as (n_rows,) int32 bits:
    ``BARRIER_BEFORE_READ`` and ``BARRIER_BEFORE_WRITE``.

    A thread's read phase reads operands, its gate and the image, and its
    write phase writes its own register ``rd`` and stores into the image.
    Accesses of one thread are ordered by the thread itself; an access
    that may touch another thread's word is *cross*: a snooped operand
    (thread ``ext*16 + lane``), INVSQR's source when it is not thread 0,
    an LOD's load from the image, an STO's claim on the winner array, its
    check of the claim and its store. A barrier is placed, as late as
    possible, wherever a cross access would otherwise meet a conflicting
    access (one of the two a write) since the last barrier: RAW and WAR
    on each register and on the image and the winner array. So an STO row
    always has its claim -> store barrier, and a row that touches only its
    own thread's registers gets none. DOT/SUM's terms meet in their warp
    through shuffles and need no CTA barrier of their own. The kernel puts
    barriers of its own after the copy-in and before the copy-out."""
    rows = np.asarray(rows)
    bits = np.zeros((rows.shape[0],), np.int32)
    wrote: set = set()          # registers written since the last barrier
    read_x: set = set()         # registers read cross since the last barrier
    mem_r = mem_w = win_r = win_w = False
    for i, f in enumerate(rows):
        sel, snoop = int(f[_SEL]), int(f[_X]) == 1
        # read phase: cross reads of registers, the image, the winner array
        xr = set()
        if snoop and sel in _READS_A:
            xr.add(int(f[_RA]))
        if snoop and sel in _READS_B:
            xr.add(int(f[_RB]))
        if sel == 7 and snoop and int(f[_EXT_A]) != 0:
            xr.add(int(f[_RA]))          # thread 0 reads thread ext_a * 16
        if (xr & wrote) or (sel == 2 and mem_w) or (sel == 3 and win_r):
            bits[i] |= BARRIER_BEFORE_READ
            wrote, read_x = set(), set()
            mem_r = mem_w = win_r = win_w = False
        read_x |= xr
        mem_r |= sel == 2
        win_w |= sel == 3
        # write phase: the thread's own rd; an STO checks its claim and
        # stores into the image
        rd = int(f[_RD]) if sel in _WRITES_RD else None
        if (rd in read_x) or (sel == 3 and (mem_r or mem_w or win_w)):
            bits[i] |= BARRIER_BEFORE_WRITE
            wrote, read_x = set(), set()
            mem_r = mem_w = win_r = win_w = False
        if rd is not None:
            wrote.add(rd)
        mem_w |= sel == 3
        win_r |= sel == 3
    return bits


def segment_smem_bytes(depth: int, n_rows: int = 0) -> int:
    """Dynamic shared memory of one segment CTA: the register file, the
    shared-memory image, the store-port winner array and ``n_rows`` rows
    of the table."""
    # the core's executor imports this module: take its machine constants
    # at call time, so that either may be imported first
    from ..core.machine import MAX_THREADS, N_REGS

    return 4 * (MAX_THREADS * N_REGS + 2 * depth) + _ROW_BYTES * n_rows


def segment_chunk_rows(depth: int, n_rows: int) -> int:
    """Table rows the segment kernel holds at once beside a ``depth``-word
    image: ``SEGMENT_CHUNK_ROWS``, or fewer where shared memory is short
    (the kernel's static oob flag takes 16 bytes beside)."""
    room = (MAX_DYNAMIC_SMEM - 16 - segment_smem_bytes(depth)) // _ROW_BYTES
    chunk = min(max(n_rows, 1), SEGMENT_CHUNK_ROWS, room)
    if chunk < 1:
        raise ValueError(f"a {depth}-word shared memory needs "
                         f"{segment_smem_bytes(depth, 1)} bytes of shared "
                         f"memory per CTA, above {MAX_DYNAMIC_SMEM}")
    return chunk


def simt_segment(cfg, rows: torch.Tensor, block_idx, prog_idx, regs, shmem,
                 oob, *, shmem_depth: int | None = None,
                 barriers: torch.Tensor | None = None):
    """Run the fused rows ``rows`` ((n_rows, 15) int32, ``FIELDS`` order)
    over the SM batch ``regs`` (n, 512, 16), ``shmem`` (n, depth),
    ``oob`` (n,) bool with per-SM ``block_idx``/``prog_idx`` (n,) int32.
    ``barriers`` are the rows' ``segment_barriers`` bits ((n_rows,) int32
    beside ``rows``); without them the wrapper computes them on the host.
    Returns new ``(regs, shmem, oob)``; the inputs are not modified."""
    if not regs.is_cuda:
        from ..core.executor import apply_segment_rows

        return apply_segment_rows(cfg, rows, block_idx, prog_idx, regs,
                                  shmem, oob, shmem_depth=shmem_depth)
    from ..core.machine import MAX_THREADS, N_REGS

    n, depth = shmem.shape
    n_rows = rows.shape[0]
    dev = regs.device
    check_tensor(rows, "rows", torch.int32, (n_rows, N_FIELDS), dev)
    if barriers is None:
        barriers = torch.from_numpy(
            segment_barriers(rows.cpu().numpy())).to(dev)
    check_tensor(barriers, "barriers", torch.int32, (n_rows,), dev)
    check_tensor(block_idx, "block_idx", torch.int32, (n,), dev)
    check_tensor(prog_idx, "prog_idx", torch.int32, (n,), dev)
    check_tensor(regs, "regs", torch.int32, (n, MAX_THREADS, N_REGS), dev)
    check_tensor(shmem, "shmem", torch.int32, (n, depth), dev)
    check_tensor(oob, "oob", torch.bool, (n,), dev)
    bound = depth if shmem_depth is None else int(shmem_depth)
    if not 1 <= bound <= depth:
        raise ValueError(f"shmem_depth={bound} outside [1, {depth}]")
    chunk = segment_chunk_rows(depth, n_rows)
    regs_o, shmem_o, oob_o = (torch.empty_like(regs),
                              torch.empty_like(shmem), torch.empty_like(oob))
    if n and n_rows:
        build.launch("egpu_segment", "segment", dev, rows.data_ptr(),
                     barriers.data_ptr(), n_rows, chunk, block_idx.data_ptr(),
                     prog_idx.data_ptr(), regs.data_ptr(), shmem.data_ptr(),
                     oob.data_ptr(), regs_o.data_ptr(), shmem_o.data_ptr(),
                     oob_o.data_ptr(), n, depth, bound, cfg.n_threads,
                     cfg.dim_x)
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


def port_lanes(cfg, row, regs, depth: int):
    """The lanes of an LOD, STO, GLD or GST row (``row`` a
    ``core.executor.FusedRow``) over ``regs`` (n, 512, 16): each thread's
    address ``wrap32(operand + imm)`` (int32, operand ``ra`` snooped as
    the row's), the enabled threads whose address lies in ``[0, depth)``
    and the enabled ones outside it, which touch no word and set their
    SM's oob flag. Returns ``(addr, ok, bad)``."""
    from ..core.executor import row_eff, row_operand

    m = row_eff(cfg.n_threads, row, regs)
    addr = ref.wrap32(row_operand(row, regs, row.d["ra"], row.d["ext_a"])
                      .to(torch.int64) + row.d["imm"])
    bad = m & ((addr < 0) | (addr >= depth))
    return addr, m & ~bad, bad


def lod_row_plain(cfg, row, regs, shmem, oob, depth: int):
    """One LOD row (``row`` a ``core.executor.FusedRow``) over ``regs``
    (n, 512, 16), ``shmem`` (n, width) int32 and ``oob`` (n,) bool:
    enabled threads load ``shmem[s, wrap32(operand + imm)]`` into
    ``rd``; one outside ``[0, depth)`` keeps ``rd`` and sets its SM's
    ``oob``. Nothing is modified; returns the new ``(regs, oob)``."""
    rd = row.d["rd"]
    addr, ok, bad = port_lanes(cfg, row, regs, depth)
    out = regs.clone()
    out[:, :, rd] = gather_plain(shmem, addr.clamp(0, depth - 1), ok,
                                 regs[:, :, rd].contiguous())
    return out, oob | bad.any(dim=1)


def sto_row_plain(cfg, row, regs, shmem, oob, depth: int):
    """One STO row (``row`` a ``core.executor.FusedRow``) over ``regs``
    (n, 512, 16), ``shmem`` (n, width) int32 and ``oob`` (n,) bool:
    enabled threads store ``regs[s, t, rd]`` at ``wrap32(operand + imm)``;
    one outside ``[0, depth)`` stores nothing and sets its SM's ``oob``.
    Nothing is modified; returns the new ``(shmem, oob)``."""
    addr, ok, bad = port_lanes(cfg, row, regs, depth)
    return (scatter_plain(shmem, addr, regs[:, :, row.d["rd"]].contiguous(),
                          ok), oob | bad.any(dim=1))


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


def _check_port_row_args(row, sel: int, name: str, regs, shmem, oob,
                         depth: int) -> tuple:
    """Raise unless the ``name`` row kernel (data-switch branch ``sel``)
    takes these arguments as they are; returns the row's fields in
    ``FIELDS`` order."""
    fields = row.fields
    if row.sel != sel:
        raise ValueError(f"row sel={row.sel} is not an {name} row")
    check_regs(regs)
    n, width = shmem.shape
    check_tensor(shmem, "shmem", torch.int32, (regs.shape[0], width),
                 regs.device)
    check_tensor(oob, "oob", torch.bool, (n,), regs.device)
    if not 1 <= depth <= width:
        raise ValueError(f"shmem_depth={depth} outside [1, {width}]")
    return fields


def check_lod_row_args(cfg, row, regs, shmem, oob, depth: int) -> tuple:
    """Raise unless the LOD row kernel takes these arguments as they are;
    returns the row's fields in ``FIELDS`` order."""
    return _check_port_row_args(row, 2, "LOD", regs, shmem, oob, depth)


def check_sto_row_args(cfg, row, regs, shmem, oob, depth: int) -> tuple:
    """Raise unless the STO row kernel takes these arguments as they are;
    returns the row's fields in ``FIELDS`` order."""
    fields = _check_port_row_args(row, 3, "STO", regs, shmem, oob, depth)
    if scatter_smem_bytes(depth) > MAX_DYNAMIC_SMEM:
        raise ValueError(f"a {depth}-word shared memory needs "
                         f"{scatter_smem_bytes(depth)} bytes of shared "
                         f"memory per CTA, above {MAX_DYNAMIC_SMEM}")
    return fields


def simt_gather(mem, addr, mask, old):
    """LOD gather. ``mem`` (n, depth) int32; ``addr`` (n, k) int32 within
    ``[0, depth)``; ``mask`` (n, k) bool; ``old`` (n, k) int32. Returns the
    new destination column."""
    if not mem.is_cuda:
        return gather_plain(mem, addr, mask, old)
    check_gather_args(mem, addr, mask, old)
    n, depth = mem.shape
    out = torch.empty_like(old)
    build.launch("egpu_gather", "gather", mem.device, mem.data_ptr(), depth,
                 addr.data_ptr(), mask.data_ptr(), old.data_ptr(),
                 out.data_ptr(), old.shape[1], old.numel())
    return out


def simt_lod_row(cfg, row, regs, shmem, oob, depth: int):
    """One LOD row over a wave: ``regs`` (n, 512, 16) int32, ``shmem``
    (n, width) int32, ``oob`` (n,) bool, addresses bounded by ``depth``
    (<= width). On the card ``regs`` and ``oob`` are written in place
    (one launch) and returned as ``(regs, oob)``."""
    if not regs.is_cuda:
        return lod_row_plain(cfg, row, regs, shmem, oob, depth)
    fields = check_lod_row_args(cfg, row, regs, shmem, oob, depth)
    n, width = shmem.shape
    if n:
        build.launch("egpu_lod_row", "gather", regs.device, *fields,
                     cfg.n_threads, regs.data_ptr(), shmem.data_ptr(),
                     oob.data_ptr(), n, width, int(depth))
    return regs, oob


def simt_scatter(mem, addr, vals, do):
    """STO scatter. ``mem`` (n, depth) int32; ``addr``/``vals`` (n, k)
    int32, ``addr`` within ``[0, depth)`` where ``do``; ``do`` (n, k) bool.
    Returns the new shared-memory images (a copy of ``mem`` that the
    kernel stores into); ``mem`` is not modified."""
    if not mem.is_cuda:
        return scatter_plain(mem, addr, vals, do)
    check_scatter_args(mem, addr, vals, do)
    n, depth = mem.shape
    out = mem.clone()
    if n:
        build.launch("egpu_scatter", "scatter", mem.device, out.data_ptr(),
                     depth, addr.data_ptr(), vals.data_ptr(), do.data_ptr(), n,
                     vals.shape[1])
    return out


def simt_sto_row(cfg, row, regs, shmem, oob, depth: int):
    """One STO row over a wave: ``regs`` (n, 512, 16) int32, ``shmem``
    (n, width) int32, ``oob`` (n,) bool, addresses bounded by ``depth``
    (<= width). On the card ``shmem`` and ``oob`` are written in place
    (one launch) and returned as ``(shmem, oob)``."""
    if not regs.is_cuda:
        return sto_row_plain(cfg, row, regs, shmem, oob, depth)
    fields = check_sto_row_args(cfg, row, regs, shmem, oob, depth)
    n, width = shmem.shape
    if n:
        build.launch("egpu_sto_row", "scatter", regs.device, *fields,
                     cfg.n_threads, regs.data_ptr(), shmem.data_ptr(),
                     oob.data_ptr(), n, width, int(depth))
    return shmem, oob


# ---------------------------------------------------------------------------
# the device-wide global-memory port (GLD/GST rows of every engine)
# ---------------------------------------------------------------------------

# (device index, stream handle) -> the GST port's scratch in device memory
_gst_scratch: dict = {}


def gst_scratch_words(gdepth: int, lanes: int) -> int:
    """Words of the GST port's scratch: a claim per image word (from an
    even count) and an 8-byte record per lane (``csrc/gmem.cu``)."""
    return gdepth + gdepth % 2 + 2 * lanes


def gst_scratch(gmem, lanes: int) -> int:
    """The GST kernel's scratch argument for the image ``gmem`` and
    ``lanes`` lanes: 0 where the scratch fits one CTA's shared memory
    (``MAX_DYNAMIC_SMEM``), else the address of an int32 array of
    ``gst_scratch_words`` words on the image's device, kept per device
    and stream and grown, never cleared: the kernel clears each claim it
    takes before taking it and writes each lane record before reading
    it."""
    words = gst_scratch_words(gmem.shape[0], lanes)
    if 4 * words <= MAX_DYNAMIC_SMEM:
        return 0
    key = (gmem.device.index, build.current_stream(gmem.device))
    buf = _gst_scratch.get(key)
    if buf is None or buf.shape[0] < words:
        buf = _gst_scratch[key] = torch.empty(
            (words,), dtype=torch.int32, device=gmem.device)
    return buf.data_ptr()


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


def gld_row_plain(cfg, row, regs, gmem, oob):
    """One GLD row (``row`` a ``core.executor.FusedRow``) over ``regs``
    (n, 512, 16) int32, the image ``gmem`` (gdepth,) int32 and ``oob``
    (n,) bool: enabled threads load ``gmem[wrap32(operand + imm)]`` into
    ``rd``; one outside ``[0, gdepth)`` keeps ``rd`` and sets its SM's
    ``oob``. Nothing is modified; returns the new ``(regs, oob)``."""
    rd, gdepth = row.d["rd"], gmem.shape[0]
    addr, ok, bad = port_lanes(cfg, row, regs, gdepth)
    out = regs.clone()
    out[:, :, rd] = gather_shared_plain(gmem, addr.clamp(0, gdepth - 1), ok,
                                        regs[:, :, rd].contiguous())
    return out, oob | bad.any(dim=1)


def gst_row_plain(cfg, row, regs, gmem, oob):
    """One GST row (``row`` a ``core.executor.FusedRow``) over ``regs``
    (n, 512, 16) int32, the image ``gmem`` (gdepth,) int32 and ``oob``
    (n,) bool: enabled threads store ``regs[s, t, rd]`` at
    ``wrap32(operand + imm)``, the last in (sm, thread) order winning an
    address; one outside ``[0, gdepth)`` stores nothing and sets its SM's
    ``oob``. Nothing is modified; returns the new ``(gmem, oob)``."""
    addr, ok, bad = port_lanes(cfg, row, regs, gmem.shape[0])
    return (scatter_shared_plain(gmem, addr,
                                 regs[:, :, row.d["rd"]].contiguous(), ok),
            oob | bad.any(dim=1))


def check_gather_shared_args(gmem, addr, mask, old) -> None:
    """Raise unless the GLD tile kernel takes these tensors as they are."""
    dev = gmem.device
    check_tensor(gmem, "gmem", torch.int32, (gmem.shape[0],), dev)
    for t, name, dt in ((addr, "addr", torch.int32),
                        (mask, "mask", torch.bool), (old, "old", torch.int32)):
        check_tensor(t, name, dt, old.shape, dev)


def check_scatter_shared_args(gmem, addr, vals, do) -> None:
    """Raise unless the GST tile kernel takes these tensors as they are."""
    dev = gmem.device
    check_tensor(gmem, "gmem", torch.int32, (gmem.shape[0],), dev)
    for t, name, dt in ((addr, "addr", torch.int32),
                        (vals, "vals", torch.int32), (do, "do", torch.bool)):
        check_tensor(t, name, dt, vals.shape, dev)


def _check_gmem_row_args(row, sel: int, name: str, regs, gmem,
                         oob) -> tuple:
    """Raise unless the ``name`` row kernel (data-switch branch ``sel``)
    takes these arguments as they are; returns the row's fields in
    ``FIELDS`` order."""
    fields = row.fields
    if row.sel != sel:
        raise ValueError(f"row sel={row.sel} is not a {name} row")
    check_regs(regs)
    check_tensor(gmem, "gmem", torch.int32, (gmem.shape[0],), regs.device)
    check_tensor(oob, "oob", torch.bool, (regs.shape[0],), regs.device)
    if gmem.shape[0] < 1:
        raise ValueError("the global-memory image is empty")
    return fields


def check_gld_row_args(cfg, row, regs, gmem, oob) -> tuple:
    """Raise unless the GLD row kernel takes these arguments as they are;
    returns the row's fields in ``FIELDS`` order."""
    return _check_gmem_row_args(row, 8, "GLD", regs, gmem, oob)


def check_gst_row_args(cfg, row, regs, gmem, oob) -> tuple:
    """Raise unless the GST row kernel takes these arguments as they are;
    returns the row's fields in ``FIELDS`` order."""
    return _check_gmem_row_args(row, 9, "GST", regs, gmem, oob)


def simt_gather_shared(gmem, addr, mask, old):
    """GLD gather. ``gmem`` (gdepth,) int32; ``addr`` (n, 512) int32
    within ``[0, gdepth)``; ``mask`` (n, 512) bool; ``old`` (n, 512)
    int32. Returns the new destination column."""
    if not gmem.is_cuda:
        return gather_shared_plain(gmem, addr, mask, old)
    check_gather_shared_args(gmem, addr, mask, old)
    out = torch.empty_like(old)
    build.launch("egpu_gather_shared", "gather_shared", gmem.device,
                 gmem.data_ptr(), gmem.shape[0], addr.data_ptr(),
                 mask.data_ptr(), old.data_ptr(), out.data_ptr(), old.numel())
    return out


def simt_gld_row(cfg, row, regs, gmem, oob):
    """One GLD row over a wave: ``regs`` (n, 512, 16) int32, the image
    ``gmem`` (gdepth,) int32, ``oob`` (n,) bool. On the card ``regs`` and
    ``oob`` are written in place (one launch) and returned as
    ``(regs, oob)``."""
    if not regs.is_cuda:
        return gld_row_plain(cfg, row, regs, gmem, oob)
    fields = check_gld_row_args(cfg, row, regs, gmem, oob)
    n = regs.shape[0]
    if n:
        build.launch("egpu_gld_row", "gather_shared", regs.device, *fields,
                     cfg.n_threads, regs.data_ptr(), gmem.data_ptr(),
                     oob.data_ptr(), n, gmem.shape[0])
    return regs, oob


def simt_scatter_shared(gmem, addr, vals, do):
    """GST scatter. ``gmem`` (gdepth,) int32; ``addr``/``vals`` (n, 512)
    int32, ``addr`` within ``[0, gdepth)`` where ``do``; ``do`` (n, 512)
    bool. Returns the new global-memory image (a copy of ``gmem`` that
    the kernel stores into); ``gmem`` is not modified."""
    if not gmem.is_cuda:
        return scatter_shared_plain(gmem, addr, vals, do)
    check_scatter_shared_args(gmem, addr, vals, do)
    out = gmem.clone()
    if vals.numel():
        build.launch("egpu_scatter_shared", "scatter_shared", gmem.device,
                     out.data_ptr(), gmem.shape[0], addr.data_ptr(),
                     vals.data_ptr(), do.data_ptr(),
                     gst_scratch(out, vals.numel()), vals.numel())
    return out


def simt_gst_row(cfg, row, regs, gmem, oob):
    """One GST row over a wave: ``regs`` (n, 512, 16) int32, the image
    ``gmem`` (gdepth,) int32, ``oob`` (n,) bool. On the card ``gmem`` and
    ``oob`` are written in place (one launch) and returned as
    ``(gmem, oob)``."""
    if not regs.is_cuda:
        return gst_row_plain(cfg, row, regs, gmem, oob)
    fields = check_gst_row_args(cfg, row, regs, gmem, oob)
    n = regs.shape[0]
    if n:
        build.launch("egpu_gst_row", "scatter_shared", regs.device, *fields,
                     cfg.n_threads, regs.data_ptr(), gmem.data_ptr(),
                     oob.data_ptr(), n, gmem.shape[0],
                     gst_scratch(gmem, n * 512))
    return gmem, oob
