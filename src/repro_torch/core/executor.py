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

This module holds the execute stage of every engine:

  * ``pack_imem`` / ``_decode`` — the 40-bit I-word field extraction, on
    the host in numpy;
  * the opcode -> handler-group, opcode -> profile-class and handler-group
    -> data-switch tables;
  * ``FusedRow`` and ``apply_segment_rows`` — one run of SM-local rows
    over an SM batch, in plain PyTorch. This is the plain version the
    ``segment`` CUDA kernel is held against, and the CPU path of
    ``kernels.simt_step.simt_segment``;
  * ``exec_segment`` — a fused run through the segment kernel, or
    through its partial evaluation;
  * ``FusedSegment`` / ``eval_segment_rows`` — the plan-time partial
    evaluator: which rows of a segment fold away on zeroed registers (the
    megakernel plans' fold counts) — and ``apply_segment_residual``, which
    runs what is left of a segment for a wave that starts zeroed;
  * the ``ExecBackend`` registry: ``"cuda"`` (tensors on the card, the
    kernels) and ``"cpu"`` (tensors on the host, their plain versions,
    and the residual of zeroed launch waves' segments),
    each with the row seam ``alu_row``/``lod_row``/``sto_row``/
    ``gld_row``/``gst_row`` (a whole row, on the card one launch in
    place);
  * ``make_data_handlers`` — the 12-way data path of one decoded
    instruction, which the step and trace engines run row by row and the
    megakernel runs for its global-port rows;
  * ``run`` / ``run_many`` — single-SM and SM-batch shims over the step
    engine.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from . import isa
from .isa import Op
from .machine import MAX_THREADS, MAX_WAVES, N_SP, MachineState, SMConfig
from ..kernels import ref, simt_alu, simt_step


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


# the I-word width of each field a kernel indexes or branches on
_FIELD_LIMITS = {"sel": 12, "opcode": 64, "typ": 4, "rd": 16, "ra": 16,
                 "rb": 16, "x": 2, "ext_a": 32, "ext_b": 32, "pen": 2,
                 "preg": 16, "pneg": 2}

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

    @functools.cached_property
    def fields(self) -> tuple:
        """The row as one line of a ``FIELDS``-ordered table, the order in
        which the row kernels take it by value. Raises if a field lies
        outside its I-word width, since the kernels index with them."""
        f = dict(self.d, sel=self.sel, act_waves=self.act_waves,
                 act_wthreads=self.act_wthreads)
        for name, hi in _FIELD_LIMITS.items():
            if not 0 <= f[name] < hi:
                raise ValueError(f"row field {name}={f[name]} outside "
                                 f"[0, {hi})")
        if not 1 <= f["act_waves"] <= MAX_WAVES \
                or not 1 <= f["act_wthreads"] <= N_SP:
            raise ValueError(f"active shape {f['act_waves']} x "
                             f"{f['act_wthreads']} outside {MAX_WAVES} x "
                             f"{N_SP}")
        if not -2**31 <= f["imm"] < 2**31:
            raise ValueError(f"imm={f['imm']} is not a 32-bit word")
        return tuple(f[name] for name in FIELDS)

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


# rows of fused segments run since the last ``reset_segment_rows()``:
# ``raw`` through the segment kernel (or its plain version), ``residual``
# as residual ops of ``apply_segment_residual`` and ``folded`` evaluated
# away at plan time
segment_rows = {"raw": 0, "residual": 0, "folded": 0}


def reset_segment_rows() -> None:
    for k in segment_rows:
        segment_rows[k] = 0


def exec_segment(cfg, rows: torch.Tensor, block_idx, prog_idx, regs, shmem,
                 oob, *, shmem_depth: int | None = None, barriers=None,
                 backend: "ExecBackend | None" = None,
                 seg: "FusedSegment | None" = None):
    """Run one fused segment: its partial evaluation
    (``apply_segment_residual``) when ``seg`` is given and ``backend``
    folds constants, else the raw rows through the segment kernel (the
    CUDA kernel for tensors on the card, its plain version for tensors on
    the host). ``rows`` is the segment's raw row table (``seg.rows``,
    packed) and ``barriers`` its ``segment_barriers`` bits, already on
    the state's device. Pass ``seg`` (and its wave's ``backend``) only
    for a wave that started from ``device.init_device_state``'s zeroed
    registers: the residual holds for no other."""
    if seg is not None and backend.fold_constants:
        segment_rows["residual"] += len(seg.residual)
        segment_rows["folded"] += seg.n_folded
        return apply_segment_residual(cfg, backend, seg, block_idx,
                                      prog_idx, regs, shmem, oob,
                                      shmem_depth=shmem_depth)
    segment_rows["raw"] += int(rows.shape[0])
    return simt_step.simt_segment(cfg, rows, block_idx, prog_idx, regs,
                                  shmem, oob, shmem_depth=shmem_depth,
                                  barriers=barriers)


# ---------------------------------------------------------------------------
# plan-time partial evaluation and the residual executor
# ---------------------------------------------------------------------------
#
# Every wave of a launch starts from zeroed registers
# (``device.init_device_state``) and the ISA has no data-dependent control
# flow, so at plan time, on the host, exact register-column values can be
# threaded through a segment's rows. A column stays known (a concrete
# (512,) value) until a memory load or a runtime operand makes it
# runtime. A row whose operands and destination are all known folds away:
# ``_fold_row`` evaluates it with the same ``_apply_row_cols`` body. A
# LOD or STO row with a known address column resolves its addresses on
# the host. The result is the reference's ``FusedSegment``: its fold
# count is what ``profile()["trace_merge"]["fusion"]`` reports, and its
# residual is what ``apply_segment_residual`` runs.
#
# The residual holds only for waves that start from zeroed registers.
# Backends opt in with ``ExecBackend.fold_constants`` ("cpu" does, as the
# reference's "inline" backend does), and the engines hand a segment's
# partial evaluation to ``exec_segment`` only for waves ``device.launch``
# started from ``init_device_state``; every other wave, and every backend
# that does not fold (the card's "cuda", whose segment kernel runs the
# raw rows, and backends registered without the flag), runs the raw rows.

@dataclasses.dataclass(frozen=True)
class FusedSegment:
    """One fused segment: the raw row run plus its partial evaluation.

    ``rows`` is what executes; ``residual`` the ops left after plan-time
    folding, each ``(kind, row, data, consts)`` with host-resolved
    addresses for static LOD/STO rows; ``final_consts`` the register
    columns fully known at segment end; ``n_folded`` the rows evaluated
    away entirely."""

    rows: tuple                # FusedRow run
    residual: tuple            # (kind, row, data, consts) residual ops
    final_consts: tuple        # ((reg, (512,) np.uint32), ...)
    n_folded: int              # rows evaluated away at plan time


# register indices each handler reads (operands + read-modify-write dest)
_ROW_READS = {1: ("ra", "rb", "rd"), 2: ("ra", "rd"), 3: ("ra", "rd"),
              4: ("rd",), 5: ("rd",), 6: ("ra", "rb", "rd"),
              7: ("ra", "rd"), 10: ("ra", "rb", "rd"),
              11: ("ra", "rb", "rd")}


def _row_mask(n_threads: int, row: FusedRow) -> np.ndarray:
    """The row's (512,) flexible-ISA thread mask, on the host."""
    tid = np.arange(MAX_THREADS)
    return ((tid % N_SP < row.act_wthreads) & (tid // N_SP < row.act_waves)
            & (tid < n_threads))


def _fold_row(cfg, row: FusedRow, const_cols, depth: int) -> np.ndarray:
    """Evaluate one fully known row on the host: the same
    ``_apply_row_cols`` body on (1, 512) tiles of the known columns (zeros
    for runtime ones); returns the new destination column. The port
    rounds every instruction, so a folded word is the word the raw row
    gives."""
    cols = [torch.from_numpy(c.view(np.int32).copy())[None]
            if c is not None
            else torch.zeros((1, MAX_THREADS), dtype=torch.int32)
            for c in const_cols]
    z = torch.zeros((1,), dtype=torch.int32)
    cols, _, _ = _apply_row_cols(
        cfg, row, cols, torch.zeros((1, 1), dtype=torch.int32),
        torch.zeros((1,), dtype=torch.bool), z, z, depth)
    return cols[row.d["rd"]][0].numpy().view(np.uint32).copy()


def _fold_addr(cfg, row: FusedRow, a_col: np.ndarray, depth: int):
    """Resolve a LOD/STO address column on the host: (clipped addresses,
    enabled-thread mask, any-trap flag), the runtime handlers' clip, trap
    and mask formulas on the known column."""
    a_u = np.asarray(a_col)
    if row.d["x"] == 1:                            # snoop gather
        lane = np.arange(MAX_THREADS) % N_SP
        a_u = a_u[row.d["ext_a"] * N_SP + lane]
    addr = a_u.astype(np.int32) + row.d["imm"]
    active = _row_mask(cfg.n_threads, row)
    bad = active & ((addr < 0) | (addr >= depth))
    safe = np.clip(addr, 0, depth - 1).astype(np.int32)
    return safe, (active & ~bad), bool(bad.any())


def eval_segment_rows(cfg, rows, const_cols, depth: int):
    """Partially evaluate one fused segment (host, plan time).

    ``const_cols`` is the per-register known-value state entering the
    segment (a list of (512,) np.uint32 columns, None for runtime).
    Returns ``(FusedSegment, const_cols_out)``; every residual op carries
    the known columns it reads that changed since segment entry."""
    const_cols = list(const_cols)
    dirty: set[int] = set()
    residual = []
    n_folded = 0

    def consts_for(regs):
        return tuple((r, const_cols[r]) for r in sorted(set(regs))
                     if const_cols[r] is not None and r in dirty)

    # every write mask includes ``tid < n_threads`` and registers start
    # zeroed, so lanes >= n_threads stay zero through the whole run: a
    # row whose mask covers all of [0, n_threads) determines its
    # destination even when the old column is runtime
    full_mask = np.arange(MAX_THREADS) < cfg.n_threads

    for row in rows:
        sel, d = row.sel, row.d
        rd, ra, rb = d["rd"], d["ra"], d["rb"]
        op, pen = d["opcode"], d["pen"]
        known = [c is not None for c in const_cols]
        w_all = known[rd] or np.array_equal(_row_mask(cfg.n_threads, row),
                                            full_mask)

        # a predicated row may write: which lanes commit depends on a
        # runtime register, so it never folds and its destination goes
        # runtime below
        foldable = not pen and (
            (sel == 1 and known[ra] and known[rb] and w_all)
            or (sel == 4 and w_all)
            or (sel == 5 and op in (int(Op.TDX), int(Op.TDY)) and w_all)
            or (sel == 6 and known[ra] and known[rb] and known[rd])
            or (sel == 7 and known[ra] and known[rd])
            or (sel in (10, 11) and known[ra] and known[rb] and w_all))
        if foldable:
            const_cols[rd] = _fold_row(cfg, row, const_cols, depth)
            dirty.add(rd)
            n_folded += 1
            continue

        if sel == 2 and known[ra] and not pen:     # static-address LOD
            safe, mask, bad_any = _fold_addr(cfg, row, const_cols[ra], depth)
            residual.append(("lod", row, (safe, mask, bad_any),
                             consts_for((rd,))))
            const_cols[rd] = None
            continue

        if sel == 3 and known[ra] and not pen:     # static-address STO
            safe, do, bad_any = _fold_addr(cfg, row, const_cols[ra], depth)
            # the single port's arbitration on the host: in thread order,
            # the last enabled writer of an address wins
            win: dict[int, int] = {}
            for t in np.flatnonzero(do):
                win[int(safe[t])] = int(t)
            targets = np.array(sorted(win), np.int32)
            winners = np.array([win[a] for a in sorted(win)], np.int32)
            residual.append(("sto", row, (targets, winners, bad_any),
                             consts_for((rd,))))
            continue

        # a runtime row (its known operands materialize as literals)
        reads = tuple({"ra": ra, "rb": rb, "rd": rd}[f]
                      for f in _ROW_READS[sel])
        if pen:
            reads = reads + (d["preg"],)           # the guard is a read
        residual.append(("exec", row, None, consts_for(reads)))
        if sel != 3:                               # STO writes no register
            const_cols[rd] = None

    final = tuple((r, const_cols[r]) for r in sorted(dirty)
                  if const_cols[r] is not None)
    return (FusedSegment(rows=tuple(rows), residual=tuple(residual),
                         final_consts=final, n_folded=n_folded),
            const_cols)


def apply_segment_residual(cfg, backend: "ExecBackend", seg: FusedSegment,
                           block_idx, prog_idx, regs, shmem, oob, *,
                           shmem_depth: int | None = None):
    """Run one partially evaluated segment over an SM batch (plain
    PyTorch on the state's device).

    ``"exec"`` ops run through ``_apply_row_cols`` over unpacked register
    columns, as ``apply_segment_rows`` runs every row; a static ``"lod"``
    is a gather at its host-resolved addresses under its mask; a static
    ``"sto"`` writes each target address its precomputed winning thread's
    value. Folded columns are materialised only where an op reads them
    and at the final repack. ``backend`` is the caller's (the row bodies
    are the plain versions whatever it is). Valid only for a wave that
    started from zeroed registers (see the comment above
    ``FusedSegment``); ``regs``, ``shmem`` and ``oob`` are not written."""
    n = regs.shape[0]
    device = regs.device
    cols = [regs[:, :, r] for r in range(regs.shape[2])]

    def host(v, dtype):
        return torch.tensor(np.asarray(v), dtype=dtype, device=device)

    def mat(v):
        return host(v.view(np.int32), torch.int32)[None].expand(
            n, MAX_THREADS)

    for kind, row, data, consts in seg.residual:
        for r, v in consts:
            cols[r] = mat(v)
        rd = row.d["rd"]
        if kind == "exec":
            cols, shmem, oob = _apply_row_cols(
                cfg, row, cols, shmem, oob, block_idx, prog_idx,
                shmem_depth)
        elif kind == "lod":
            safe, mask, bad_any = data
            vals = shmem[:, host(safe, torch.int64)]
            cols[rd] = torch.where(host(mask, torch.bool)[None], vals,
                                   cols[rd])
            if bad_any:
                oob = torch.ones_like(oob)
        else:                                      # static-address STO
            targets, winners, bad_any = data
            if len(targets):
                shmem = shmem.clone()
                shmem[:, host(targets, torch.int64)] = \
                    cols[rd][:, host(winners, torch.int64)]
            if bad_any:
                oob = torch.ones_like(oob)
    for r, v in seg.final_consts:
        cols[r] = mat(v)
    return torch.stack(cols, dim=2), shmem, oob


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
    return out[:, :depth].contiguous()        # the kernels' layout


# ---------------------------------------------------------------------------
# execute backends: where the state lives, and so which path runs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ExecBackend:
    """One named execute backend: the device the launch keeps its state
    on, and the row seam the engines dispatch into (the step and trace
    engines every ALU, LOD, STO, GLD and GST row; the megakernel its GLD
    and GST rows). Each row goes whole: ``alu_row(cfg, row, regs)``
    returns the new register file, ``lod_row(cfg, row, regs, shmem, oob,
    depth)`` and ``gld_row(cfg, row, regs, gmem, oob)`` the new ``(regs,
    oob)``, ``sto_row(cfg, row, regs, shmem, oob, depth)`` the new
    ``(shmem, oob)`` and ``gst_row(cfg, row, regs, gmem, oob)`` the new
    ``(gmem, oob)``. Each may write the tensors it is given in place, so
    the engines hand it state they own (``trace_engine.owned_data``)."""

    name: str
    device: str
    alu_row: Callable
    lod_row: Callable
    sto_row: Callable
    gld_row: Callable
    gst_row: Callable
    # run the megakernel's fused segments of zeroed launch waves as their
    # plan-time partial evaluation (``apply_segment_residual``): folded
    # rows never reach the segment kernel, so a backend that must run
    # every row leaves this False
    fold_constants: bool = False


_EXECUTE_BACKENDS: dict[str, ExecBackend] = {}


def register_backend(backend: ExecBackend) -> ExecBackend:
    _EXECUTE_BACKENDS[backend.name] = backend
    return backend


def register_execute_backend(name: str, device: str = "cuda"):
    """Decorator: register backend ``name`` whose ALU rows run the decorated
    per-op function ``fn(op, typ, a, b, mask, old)`` (``simt_alu``'s
    signature: the new destination column) on operand columns gathered
    from the register file. Its LOD, STO, GLD and GST rows are the
    built-in row seam's, which launch their kernels on card tensors and
    run their plain versions on host tensors; the state lives on
    ``device``."""
    def deco(fn):
        register_backend(ExecBackend(
            name=name, device=device,
            alu_row=functools.partial(simt_alu.alu_row_plain, alu=fn),
            lod_row=simt_step.simt_lod_row, sto_row=simt_step.simt_sto_row,
            gld_row=simt_step.simt_gld_row, gst_row=simt_step.simt_gst_row))
        return fn
    return deco


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


# the card: the five row kernels, in place, and the segment kernel over
# the raw rows; the host: their plain versions, out of place, and the
# segments' partial evaluation on zeroed launch waves
register_backend(ExecBackend(
    name="cuda", device="cuda", alu_row=simt_alu.simt_alu_row,
    lod_row=simt_step.simt_lod_row, sto_row=simt_step.simt_sto_row,
    gld_row=simt_step.simt_gld_row, gst_row=simt_step.simt_gst_row))
register_backend(ExecBackend(
    name="cpu", device="cpu", alu_row=simt_alu.alu_row_plain,
    lod_row=simt_step.lod_row_plain, sto_row=simt_step.sto_row_plain,
    gld_row=simt_step.gld_row_plain, gst_row=simt_step.gst_row_plain,
    fold_constants=True))


# ---------------------------------------------------------------------------
# the shared execute stage (step + trace engines dispatch into these
# handlers; the megakernel runs its global-port rows through them)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _lanes(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(tid, lane)`` index vectors of one SM on ``device``, made once."""
    tid = torch.arange(MAX_THREADS, device=device)
    return tid, tid % N_SP


@functools.lru_cache(maxsize=1024)
def _active(n_threads: int, act_waves: int, act_wthreads: int, n_sms: int,
            device: torch.device) -> torch.Tensor:
    """The flexible-ISA thread mask of an SM batch, (n_sms, 512) and
    contiguous as the kernels take it, made once per shape."""
    tid, lane = _lanes(device)
    one = ((lane < act_wthreads) & (tid // N_SP < act_waves)
           & (tid < n_threads))
    return one.expand(n_sms, MAX_THREADS).contiguous()


def row_pgate(row: FusedRow, regs: torch.Tensor) -> torch.Tensor | None:
    """The row's predicate gate over an SM batch, (n_sms, 512) bool: bit 0
    of each thread's ``preg``, negated by ``pneg``; None on a legacy PEN=0
    word."""
    d = row.d
    if not d["pen"]:
        return None
    p = (regs[:, :, d["preg"]] & 1) != 0
    return ~p if d["pneg"] else p


def row_active(n_threads: int, row: FusedRow, regs: torch.Tensor
               ) -> torch.Tensor:
    """The row's flexible-ISA thread mask over an SM batch."""
    return _active(n_threads, row.act_waves, row.act_wthreads,
                   regs.shape[0], regs.device)


def row_eff(n_threads: int, row: FusedRow, regs: torch.Tensor
            ) -> torch.Tensor:
    """The row's write and port mask: the active shape AND the predicate
    gate."""
    p = row_pgate(row, regs)
    act = row_active(n_threads, row, regs)
    return act if p is None else act & p


def row_operand(row: FusedRow, regs: torch.Tensor, r: int, ext: int
                ) -> torch.Tensor:
    """Source register ``r`` of every thread, (n_sms, 512) contiguous; with
    snooping (X=1) thread t reads ``regs[:, ext*16 + lane, r]``."""
    if row.d["x"] == 1:
        return regs[:, ext * N_SP + _lanes(regs.device)[1], r]
    return regs[:, :, r].contiguous()


def make_data_handlers(cfg, backend: ExecBackend, row: FusedRow, block_idx,
                       prog_idx, *, shmem_depth: int | None = None):
    """The 12-way data-path switch body of one decoded instruction.

    ``row`` holds the decoded fields as host integers (``row.d``) and the
    flexible-ISA active shape; ``block_idx``/``prog_idx`` are the wave's
    (n_sms,) int32 tensors. Returns a list of handlers over the data-state
    tuple ``(regs, shmem, gmem, oob)`` — index it with the row's
    data-switch branch ``row.sel`` (branch 0 is the identity for
    NOP/control). ALU, LOD, STO, GLD and GST run through ``backend``'s
    seam; LODI, TDX/TDY/BID/PID, DOT/SUM, INVSQR, SETP and SELP are
    PyTorch operations on the state's device. Nothing here reads the card
    back to the host.

    DOT/SUM adds each wavefront's lane-0 term to +0.0 and then folds the
    16 lane terms in halves (8, 4, 2, 1): the order the reference's step
    and trace engines take. The megakernel's fused segment keeps its own
    order (``ref.wavefront_reduce``'s ``pairwise`` argument, ROADMAP §C).

    An ALU, LOD, STO, GLD or GST row is one call into the backend's row
    seam and issues no PyTorch operation of its own; on the card that
    call is one launch that writes the state in place, so the state
    handed to these handlers must be the engine's own (``device.run_wave``
    and ``trace_engine.run_wave_trace`` copy it once per wave,
    ``gmem`` only where the wave's rows store into it, and
    ``trace_engine.run_wave_megakernel`` what its GLD and GST rows
    write).

    ``shmem_depth`` bounds LOD/STO addressing (default: the shared-memory
    array's own depth)."""
    d = row.d
    op, typ = d["opcode"], d["typ"]
    rd, ra, rb = d["rd"], d["ra"], d["rb"]
    imm = d["imm"]
    snoop = d["x"] == 1

    def pgate(regs):
        return row_pgate(row, regs)

    def active(regs):
        return row_active(cfg.n_threads, row, regs)

    def eff(regs):
        return row_eff(cfg.n_threads, row, regs)

    def col(regs, r):
        return regs[:, :, r].contiguous()                  # (n_sms, 512)

    def set_col(regs, r, vals):
        out = regs.clone()
        out[:, :, r] = vals
        return out

    def operands(regs):
        return (row_operand(row, regs, ra, d["ext_a"]),
                row_operand(row, regs, rb, d["ext_b"]))

    def h_identity(s):
        return s

    def h_alu(s):
        regs, shmem, gmem, oob = s
        return backend.alu_row(cfg, row, regs), shmem, gmem, oob

    def h_lod(s):
        regs, shmem, gmem, oob = s
        depth = shmem_depth if shmem_depth is not None else shmem.shape[1]
        regs, oob = backend.lod_row(cfg, row, regs, shmem, oob, depth)
        return regs, shmem, gmem, oob

    def h_sto(s):
        regs, shmem, gmem, oob = s
        depth = shmem_depth if shmem_depth is not None else shmem.shape[1]
        shmem, oob = backend.sto_row(cfg, row, regs, shmem, oob, depth)
        return regs, shmem, gmem, oob

    def h_lodi(s):
        regs, shmem, gmem, oob = s
        val = int(np.float32(imm).view(np.int32)) \
            if typ == int(isa.Typ.FP32) else imm           # host bitcast
        vals = torch.where(eff(regs), val, col(regs, rd))
        return set_col(regs, rd, vals), shmem, gmem, oob

    def h_td(s):
        regs, shmem, gmem, oob = s
        n_sms = regs.shape[0]
        tid = _lanes(regs.device)[0]
        if op == int(Op.TDX):
            vals = (tid % cfg.dim_x).to(torch.int32)[None]
        elif op == int(Op.TDY):
            vals = (tid // cfg.dim_x).to(torch.int32)[None]
        elif op == int(Op.BID):
            vals = block_idx.to(torch.int32)[:, None]
        else:
            vals = prog_idx.to(torch.int32)[:, None]
        vals = torch.where(eff(regs), vals.expand(n_sms, MAX_THREADS),
                           col(regs, rd))
        return set_col(regs, rd, vals), shmem, gmem, oob

    def h_red(s):
        # DOT/SUM: reduce each active wavefront across its enabled lanes
        # and write lane 0 of that wavefront; a wavefront with no enabled
        # lane keeps its old lane-0 value
        regs, shmem, gmem, oob = s
        n_sms = regs.shape[0]
        a_u, b_u = operands(regs)
        terms = ref.fp_binop(ref.ALU_MUL if op == int(Op.DOT)
                             else ref.ALU_ADD, a_u, b_u)
        lane_eff = eff(regs).reshape(n_sms, MAX_WAVES, N_SP)
        red = ref.wavefront_reduce(terms.reshape(n_sms, MAX_WAVES, N_SP),
                                   lane_eff, pairwise=True)
        out = regs.clone()
        out[:, ::N_SP, rd] = torch.where(lane_eff.any(dim=2), red,
                                         regs[:, ::N_SP, rd])
        return out, shmem, gmem, oob

    def h_sfu(s):
        # single-lane SFU: 1/sqrt of wavefront-0 lane-0 (snoopable source);
        # the issuing thread-0 predicate gates the write
        regs, shmem, gmem, oob = s
        src = d["ext_a"] * N_SP if snoop else 0
        new = ref.invsqr(regs[:, src, ra])
        p = pgate(regs)
        if p is not None:
            new = torch.where(p[:, 0], new, regs[:, 0, rd])
        out = regs.clone()
        out[:, 0, rd] = new
        return out, shmem, gmem, oob

    def h_gld(s):
        regs, shmem, gmem, oob = s
        regs, oob = backend.gld_row(cfg, row, regs, gmem, oob)
        return regs, shmem, gmem, oob

    def h_gst(s):
        # the single device-wide port drains in (sm, thread) order
        regs, shmem, gmem, oob = s
        gmem, oob = backend.gst_row(cfg, row, regs, gmem, oob)
        return regs, shmem, gmem, oob

    def h_setp(s):
        regs, shmem, gmem, oob = s
        a_u, b_u = operands(regs)
        res = ref.setp_compare(imm, typ, a_u, b_u).to(torch.int32)
        vals = torch.where(eff(regs), res, col(regs, rd))
        return set_col(regs, rd, vals), shmem, gmem, oob

    def h_selp(s):
        # Rd = P ? Ra : Rb — the @-guard is the SELECTOR here, not a write
        # gate: SELP writes on every active lane (PEN=0 selects Ra)
        regs, shmem, gmem, oob = s
        a_u, b_u = operands(regs)
        p = pgate(regs)
        vals = a_u if p is None else torch.where(p, a_u, b_u)
        vals = torch.where(active(regs), vals, col(regs, rd))
        return set_col(regs, rd, vals), shmem, gmem, oob

    return [h_identity, h_alu, h_lod, h_sto, h_lodi, h_td, h_red, h_sfu,
            h_gld, h_gst, h_setp, h_selp]


# ---------------------------------------------------------------------------
# public entry points (single-wave shims over the step engine)
# ---------------------------------------------------------------------------

def run(cfg: SMConfig, program, shmem=None, state: MachineState | None = None,
        *, backend: str = "cuda") -> MachineState:
    """Assemble-and-run convenience wrapper: ONE SM, one thread block, on
    the step engine.

    ``program`` is a Program or an ndarray of encoded 40-bit words; a
    given ``state`` continues from where it stopped. Use
    ``device.launch`` for grids, global memory and multi-SM runs."""
    from . import device

    words = program.words if hasattr(program, "words") else np.asarray(program)
    lo, hi = pack_imem(words, cfg.imem_depth)
    dev = backend_device(backend)
    if state is None:
        dstate = device.init_device_state(cfg, n_sms=1, shmem=shmem,
                                          device=dev)
    else:
        dstate = device.lift_machine_state(state, device=dev)
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    fin = device.run_wave(cfg, get_execute_backend(backend), lo, hi, zero,
                          zero, dstate)
    return device.squeeze_device_state(fin)


def run_many(cfg: SMConfig, program, shmem_batch, *,
             backend: str = "cuda") -> MachineState:
    """Multi-SM execution: one eGPU instance per shared-memory image, the
    same program as one step-engine wave. The returned ``MachineState``
    carries a leading batch axis on every field."""
    from . import device

    dev = backend_device(backend)
    n_sms = len(shmem_batch)
    words = program.words if hasattr(program, "words") else np.asarray(program)
    lo, hi = pack_imem(words, cfg.imem_depth)
    dstate = device.init_device_state(cfg, n_sms=n_sms, shmem=shmem_batch,
                                      device=dev)
    fin = device.run_wave(
        cfg, get_execute_backend(backend), lo, hi,
        torch.arange(n_sms, dtype=torch.int32, device=dev),
        torch.zeros((n_sms,), dtype=torch.int32, device=dev), dstate)

    def b(x):
        return np.broadcast_to(np.asarray(x), (n_sms,) + np.shape(x)).copy()

    return MachineState(
        regs=fin.regs, shmem=fin.shmem,
        pc=b(fin.pc), ret_stack=b(fin.ret_stack), ret_sp=b(fin.ret_sp),
        loop_ctr=b(fin.loop_ctr), loop_sp=b(fin.loop_sp),
        halted=b(fin.halted), oob=fin.oob,
        steps=b(fin.steps), cycles=b(fin.cycles),
        cycles_by_class=b(fin.cycles_by_class))
