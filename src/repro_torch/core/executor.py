"""eGPU execute stage: decode tables, fused rows and the global-port rows.

Faithful to the paper's SM microarchitecture:

  * 16 SPs; thread ``t`` runs on SP ``t % 16`` (its *lane*), in wavefront
    ``t // 16``.
  * Flexible ISA: per-instruction WIDTH/DEPTH resize the active thread
    block with no flush — implemented as an active-thread mask.
  * Thread snooping (X=1): source operands read ``regs[ext*16 + lane]``.
  * DOT/SUM extension units reduce each active wavefront and write lane 0;
    INVSQR is a single-lane SFU on wavefront 0 / lane 0.
  * Shared memory: quad read port, single write port (writeback is
    sequential in thread order, so the *last* active thread wins on
    address collisions).

This module holds what the megakernel engine needs:

  * ``pack_imem`` / ``_decode`` — the 40-bit I-word field extraction, on
    the host in numpy;
  * the opcode -> handler-group, opcode -> profile-class and handler-group
    -> data-switch tables;
  * ``FusedRow`` and ``apply_segment_rows`` — one run of SM-local rows
    over an SM batch, in plain PyTorch. This is the plain version the
    ``segment`` CUDA kernel is held against, and the CPU path of
    ``kernels.simt_step.simt_segment``;
  * ``exec_segment`` — a fused run through the segment kernel;
  * ``make_data_handlers`` — the GLD/GST global-port rows, which split
    fused runs and go through the ``gather_shared``/``scatter_shared``
    kernels;
  * the ``ExecBackend`` registry: ``"cuda"`` (tensors on the card, the
    kernels) and ``"cpu"`` (tensors on the host, the plain versions).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import isa
from .isa import Op
from .machine import MAX_THREADS, MAX_WAVES, N_SP
from ..kernels import ref


def pack_imem(words: np.ndarray, depth: int) -> tuple[np.ndarray, np.ndarray]:
    """Split I-words into (lo32, hi) uint32 arrays of ``depth``.

    ``hi`` carries the architectural bits [39:32] plus the predication
    extension byte [45:40] (pen/preg/pneg — zero on every legacy word)."""
    w = np.asarray(words, dtype=np.int64)
    if w.shape[0] > depth:
        raise ValueError(f"program of {w.shape[0]} words exceeds I-MEM depth {depth}")
    lo = (w & 0xFFFFFFFF).astype(np.uint32)
    hi = ((w >> 32) & 0x3FFF).astype(np.uint32)
    pad = depth - w.shape[0]
    # pad with STOP so runaway PCs halt
    stop_word = isa.Instr(op=Op.STOP).encode()
    lo = np.concatenate([lo, np.full((pad,), stop_word & 0xFFFFFFFF, np.uint32)])
    hi = np.concatenate([hi, np.full((pad,), (stop_word >> 32) & 0x3FFF, np.uint32)])
    return lo, hi


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _decode(lo: np.ndarray, hi: np.ndarray) -> dict[str, np.ndarray]:
    lo = np.asarray(lo, np.uint32)
    hi = np.asarray(hi, np.uint32)
    imm_raw = (lo & 0x7FFF).astype(np.int32)
    imm_sext = np.where(imm_raw & 0x4000, imm_raw - (1 << 15), imm_raw)
    i32 = lambda v: np.asarray(v).astype(np.int32)  # noqa: E731
    return dict(
        imm_raw=imm_raw,
        imm=i32(imm_sext),
        x=i32((lo >> 15) & 1),
        rb=i32((lo >> 16) & 0xF),
        ra=i32((lo >> 20) & 0xF),
        rd=i32((lo >> 24) & 0xF),
        typ=i32((lo >> 28) & 0x3),
        opcode=i32(((lo >> 30) & 0x3) | ((hi & 0xF) << 2)),
        depth=i32((hi >> 4) & 0x3),
        width=i32((hi >> 6) & 0x3),
        ext_a=i32((lo >> 10) & 0x1F),
        ext_b=i32((lo >> 5) & 0x1F),
        # predication extension byte (word bits [45:40] = hi bits [13:8])
        preg=i32((hi >> 8) & 0xF),
        pen=i32((hi >> 12) & 0x1),
        pneg=i32((hi >> 13) & 0x1),
    )


# opcode -> handler group
(_G_NOP, _G_ALU, _G_LOD, _G_STO, _G_LODI, _G_TD, _G_RED, _G_SFU, _G_CTL,
 _G_GLD, _G_GST, _G_SETP, _G_SELP) = range(13)
_GROUP_OF_OP = np.zeros((64,), np.int32)
for _op, _g in {
    Op.NOP: _G_NOP,
    Op.ADD: _G_ALU, Op.SUB: _G_ALU, Op.MUL: _G_ALU, Op.AND: _G_ALU,
    Op.OR: _G_ALU, Op.XOR: _G_ALU, Op.NOT: _G_ALU, Op.LSL: _G_ALU,
    Op.LSR: _G_ALU,
    Op.LOD: _G_LOD, Op.STO: _G_STO, Op.LODI: _G_LODI,
    Op.TDX: _G_TD, Op.TDY: _G_TD, Op.BID: _G_TD, Op.PID: _G_TD,
    Op.DOT: _G_RED, Op.SUM: _G_RED, Op.INVSQR: _G_SFU,
    Op.JMP: _G_CTL, Op.JSR: _G_CTL, Op.RTS: _G_CTL, Op.LOOP: _G_CTL,
    Op.INIT: _G_CTL, Op.STOP: _G_CTL,
    Op.GLD: _G_GLD, Op.GST: _G_GST,
    Op.SETP: _G_SETP, Op.SELP: _G_SELP,
}.items():
    _GROUP_OF_OP[int(_op)] = _g

# opcode -> profile class, per operand type (rows of Tables III/IV + GMEM)
_CLASS_OF = np.zeros((64, 3), np.int32)
for _op in Op:
    for _t in isa.Typ:
        _CLASS_OF[int(_op), int(_t)] = isa.instr_class(_op, _t)

# handler-group -> data-switch branch (0 = no data effect: NOP and control)
DATA_SEL_OF_GROUP = np.zeros((13,), np.int32)
for _g, _sel in {_G_ALU: 1, _G_LOD: 2, _G_STO: 3, _G_LODI: 4, _G_TD: 5,
                 _G_RED: 6, _G_SFU: 7, _G_GLD: 8, _G_GST: 9,
                 _G_SETP: 10, _G_SELP: 11}.items():
    DATA_SEL_OF_GROUP[_g] = _sel

# opcode -> data-switch branch
DATA_SEL_OF_OP = DATA_SEL_OF_GROUP[_GROUP_OF_OP]

# the data-switch branches a fused run may hold (GLD/GST split runs)
FUSED_SELS = frozenset((1, 2, 3, 4, 5, 6, 7, 10, 11))

# decoded-field columns of a row table, in the order they are packed into
# the (n_rows, len(FIELDS)) int32 matrix the segment kernel reads
FIELDS = ("sel", "opcode", "typ", "rd", "ra", "rb", "imm", "x",
          "ext_a", "ext_b", "pen", "preg", "pneg",
          "act_waves", "act_wthreads")


# ---------------------------------------------------------------------------
# fused rows (the megakernel engine's unit of work)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FusedRow:
    """One pre-decoded data instruction, fully resolved on the host:
    ``sel`` the data-switch branch, ``d`` the decoded fields as Python
    ints, and the flexible-ISA active shape."""

    sel: int
    d: dict
    act_waves: int
    act_wthreads: int

    @staticmethod
    def from_fields(vals) -> "FusedRow":
        """Build a row from one line of a ``FIELDS``-ordered table."""
        f = dict(zip(FIELDS, (int(v) for v in vals)))
        return FusedRow(sel=f.pop("sel"), d=f,
                        act_waves=f.pop("act_waves"),
                        act_wthreads=f.pop("act_wthreads"))

    def active(self, n_threads: int, device) -> torch.Tensor:
        """The (512,) flexible-ISA thread mask."""
        tid = torch.arange(MAX_THREADS, device=device)
        return ((tid % N_SP < self.act_wthreads)
                & (tid // N_SP < self.act_waves) & (tid < n_threads))


def _apply_row_cols(cfg, row: FusedRow, cols, shmem, oob, block_idx,
                    prog_idx, shmem_depth: int | None):
    """One fused row over unpacked register columns.

    ``cols`` is the mutable list of 16 per-register (n_sms, 512) int32
    tiles. Every row computes from the whole old state and then writes,
    which is what the segment kernel's read phase / barrier / write phase
    reproduces."""
    d = row.d
    sel = row.sel
    op, typ = d["opcode"], d["typ"]
    rd, ra, rb = d["rd"], d["ra"], d["rb"]
    imm = d["imm"]
    snoop = d["x"] == 1
    n_sms = cols[0].shape[0]
    device = cols[0].device
    tid = torch.arange(MAX_THREADS, device=device)
    lane = tid % N_SP
    active = row.active(cfg.n_threads, device)

    # SIMT predication: ``eff`` replaces ``active`` in every write/port
    # mask; ``psel`` is the raw predicate (SELP's selector)
    if d["pen"]:
        psel = (cols[d["preg"]] & 1) != 0                  # (n_sms, 512)
        if d["pneg"]:
            psel = ~psel
        eff = active[None] & psel
    else:
        psel = None
        eff = active[None].expand(n_sms, MAX_THREADS)

    def read(r, ext):
        # snoop (X=1) gathers regs[ext*16 + lane]
        if snoop:
            return cols[r][:, ext * N_SP + lane]
        return cols[r]

    def addr_of():
        return ref.wrap32(read(ra, d["ext_a"]).to(torch.int64) + imm)

    def write(mask, vals):
        cols[rd] = torch.where(mask, vals, cols[rd])

    if sel == 1:                                           # ALU
        write(eff, ref.alu_ref(op, typ, read(ra, d["ext_a"]),
                               read(rb, d["ext_b"])))
    elif sel in (2, 3):                                    # LOD / STO
        depth = shmem_depth if shmem_depth is not None else shmem.shape[1]
        addr = addr_of()
        bad = eff & ((addr < 0) | (addr >= depth))
        oob = oob | bad.any(dim=1)
        if sel == 2:
            safe = addr.clamp(0, depth - 1).to(torch.int64)
            write(eff & ~bad, torch.gather(shmem, 1, safe))
        else:
            shmem = _last_writer_write(shmem, addr, cols[rd], eff & ~bad)
    elif sel == 4:                                         # LODI
        if typ == int(isa.Typ.FP32):
            val = int(np.float32(imm).view(np.int32))      # host bitcast
        else:
            val = imm
        write(eff, torch.full_like(cols[rd], val))
    elif sel == 5:                                         # TDX/TDY/BID/PID
        if op == int(Op.TDX):
            vals = (tid % cfg.dim_x).to(torch.int32)[None]
        elif op == int(Op.TDY):
            vals = (tid // cfg.dim_x).to(torch.int32)[None]
        elif op == int(Op.BID):
            vals = block_idx.to(torch.int32)[:, None]
        else:
            vals = prog_idx.to(torch.int32)[:, None]
        write(eff, vals.expand(n_sms, MAX_THREADS))
    elif sel == 6:                                         # DOT/SUM
        a_u, b_u = read(ra, d["ext_a"]), read(rb, d["ext_b"])
        terms = ref.fp_binop(ref.ALU_MUL if op == int(Op.DOT)
                             else ref.ALU_ADD, a_u, b_u)
        lane_eff = eff.reshape(n_sms, MAX_WAVES, N_SP)
        pairwise = bool(d["pen"]) and row.act_wthreads >= 8
        red = ref.wavefront_reduce(terms.reshape(n_sms, MAX_WAVES, N_SP),
                                   lane_eff, pairwise)
        cur = cols[rd][:, ::N_SP]
        new = torch.where(lane_eff.any(dim=2), red, cur)
        col = cols[rd].clone()
        col[:, ::N_SP] = new
        cols[rd] = col
    elif sel == 7:                                         # SFU (INVSQR)
        src = d["ext_a"] * N_SP if snoop else 0
        new = ref.invsqr(cols[ra][:, src])
        if psel is not None:
            # the SFU issues from thread 0: its predicate gates the write
            new = torch.where(psel[:, 0], new, cols[rd][:, 0])
        col = cols[rd].clone()
        col[:, 0] = new
        cols[rd] = col
    elif sel == 10:                                        # SETP
        res = ref.setp_compare(imm, typ, read(ra, d["ext_a"]),
                               read(rb, d["ext_b"]))
        write(eff, res.to(torch.int32))
    elif sel == 11:                                        # SELP
        a_u, b_u = read(ra, d["ext_a"]), read(rb, d["ext_b"])
        vals = torch.where(psel, a_u, b_u) if psel is not None else a_u
        write(active[None], vals)
    else:
        raise AssertionError(
            f"fused row with non-SM-local handler sel={sel}")
    return cols, shmem, oob


def apply_segment_rows(cfg, rows, block_idx, prog_idx, regs, shmem, oob, *,
                       shmem_depth: int | None = None):
    """Run one fused segment over an SM batch (plain PyTorch).

    ``rows`` is a ``FIELDS``-ordered (n_rows, 15) int32 table (numpy or a
    tensor) of SM-local data ops only. ``regs`` (n_sms, 512, 16),
    ``shmem`` (n_sms, depth) int32 words and ``oob`` (n_sms,) bool are not
    modified; the new ``(regs, shmem, oob)`` are returned.
    ``shmem_depth`` bounds LOD/STO addressing (default: the array's own
    depth)."""
    if isinstance(rows, torch.Tensor):
        rows = rows.cpu().numpy()
    cols = [regs[:, :, r] for r in range(regs.shape[2])]
    for vals in np.asarray(rows):
        cols, shmem, oob = _apply_row_cols(
            cfg, FusedRow.from_fields(vals), cols, shmem, oob, block_idx,
            prog_idx, shmem_depth)
    return torch.stack(cols, dim=2), shmem, oob


def exec_segment(cfg, rows: torch.Tensor, block_idx, prog_idx, regs, shmem,
                 oob, *, shmem_depth: int | None = None):
    """Run one fused segment through the segment kernel (the CUDA kernel
    for tensors on the card, its plain version for tensors on the host).
    ``rows`` is the segment's row table, already on the state's device."""
    from ..kernels.simt_step import simt_segment

    return simt_segment(cfg, rows, block_idx, prog_idx, regs, shmem, oob,
                        shmem_depth=shmem_depth)


def _last_writer_write(mem, addr, vals, do):
    """Serialized single-port store over a batch of memories: ``mem``
    (n, depth), ``addr``/``vals``/``do`` (n, k). Among enabled writers to
    one address, the one with the highest index along the last axis wins
    (thread order within an SM)."""
    n, depth = mem.shape
    k = addr.shape[1]
    order = torch.arange(k, device=mem.device).expand(n, k).contiguous()
    slot = torch.where(do, addr, depth).to(torch.int64)   # park masked writes
    winner = torch.full((n, depth + 1), -1, dtype=torch.int64,
                        device=mem.device)
    winner.scatter_reduce_(1, slot, order, reduce="amax")
    write = do & (torch.gather(winner, 1, slot) == order)
    out = torch.cat([mem, torch.zeros_like(mem[:, :1])], dim=1)
    out.scatter_(1, torch.where(write, slot, depth), vals)
    return out[:, :depth]


# ---------------------------------------------------------------------------
# execute backends: where the state lives, and so which path runs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ExecBackend:
    """One named execute backend. The kernels' wrappers dispatch on the
    device of the tensors they are given, so a backend is the device the
    launch keeps its state on."""

    name: str
    device: str


_EXECUTE_BACKENDS: dict[str, ExecBackend] = {}


def register_backend(backend: ExecBackend) -> ExecBackend:
    _EXECUTE_BACKENDS[backend.name] = backend
    return backend


def get_execute_backend(name: str) -> ExecBackend:
    try:
        return _EXECUTE_BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown execute backend {name!r}; "
            f"available: {sorted(_EXECUTE_BACKENDS)}") from None


def execute_backends() -> tuple[str, ...]:
    return tuple(sorted(_EXECUTE_BACKENDS))


def backend_device(name: str) -> torch.device:
    """The torch device of backend ``name``; the card must be present for
    ``"cuda"`` (there is no fallback to the host)."""
    dev = get_execute_backend(name).device
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "backend='cuda' needs a CUDA device and none is available; "
            "pass backend='cpu' to run the plain versions on the host")
    return torch.device(dev)


register_backend(ExecBackend(name="cuda", device="cuda"))
register_backend(ExecBackend(name="cpu", device="cpu"))


# ---------------------------------------------------------------------------
# the global-port rows (GLD/GST split fused runs)
# ---------------------------------------------------------------------------

def make_data_handlers(cfg, row: FusedRow):
    """The data-path handlers of one GLD/GST row over the state tuple
    ``(regs, shmem, gmem, oob)``, indexed by data-switch branch (8 = GLD,
    9 = GST). Masks, operands and addresses are computed here in PyTorch;
    the gather and the serialized store run in the ``gather_shared`` /
    ``scatter_shared`` kernels."""
    from ..kernels.simt_step import simt_gather_shared, simt_scatter_shared

    d = row.d

    def pgate(regs):
        if not d["pen"]:
            return torch.ones(regs.shape[:2], dtype=torch.bool,
                              device=regs.device)
        p = (regs[:, :, d["preg"]] & 1) != 0               # (n_sms, 512)
        return ~p if d["pneg"] else p

    def eff(regs):
        return row.active(cfg.n_threads, regs.device)[None] & pgate(regs)

    def operands(regs):
        tid = torch.arange(MAX_THREADS, device=regs.device)
        ra_tid = d["ext_a"] * N_SP + tid % N_SP if d["x"] == 1 else tid
        return regs[:, ra_tid, d["ra"]]                    # (n_sms, 512)

    def addr_of(regs):
        return ref.wrap32(operands(regs).to(torch.int64) + d["imm"])

    def h_gld(s):
        regs, shmem, gmem, oob = s
        gdepth = gmem.shape[0]
        m = eff(regs)
        addr = addr_of(regs)
        bad = m & ((addr < 0) | (addr >= gdepth))
        safe = addr.clamp(0, gdepth - 1)
        vals = simt_gather_shared(gmem, safe, m & ~bad,
                                  regs[:, :, d["rd"]].contiguous())
        regs = regs.clone()
        regs[:, :, d["rd"]] = vals
        return regs, shmem, gmem, oob | bad.any(dim=1)

    def h_gst(s):
        regs, shmem, gmem, oob = s
        gdepth = gmem.shape[0]
        m = eff(regs)
        addr = addr_of(regs)
        bad = m & ((addr < 0) | (addr >= gdepth))
        # the single device-wide port drains in (sm, thread) order
        gmem = simt_scatter_shared(gmem, addr,
                                   regs[:, :, d["rd"]].contiguous(),
                                   m & ~bad)
        return regs, shmem, gmem, oob | bad.any(dim=1)

    return {8: h_gld, 9: h_gst}
