"""Seeded random row tables and machine states that exercise every
SM-local handler: address collisions, masked and out-of-range lanes,
snooped operands, guarded rows, NaN, infinite and denormal FP32 words,
and INVSQR; and, where asked for by ``sels``, GLD and GST rows of the
global port. The CPU tests and the chip smoke both draw from here, so
the kernels and their plain versions are held against the same
inputs."""
from __future__ import annotations

import numpy as np

from ..core.executor import FIELDS
from ..core.isa import Op
from ..core.machine import MAX_THREADS, N_REGS

# registers 0-3 hold small ints (addresses around the memory), 4-9 FP32
# words (specials included), 10-15 arbitrary bits
_ADDR_REGS, _FP_REGS = range(0, 4), range(4, 10)

_SPECIAL_F32 = np.array(
    [0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000,
     0x7F800001, 0xFFC00000, 0x00000001, 0x807FFFFF, 0x00400000,
     0x00800000, 0x80800000, 0x3F800000, 0xBF800000],
    np.uint32)

_OPS_OF_SEL = {
    1: [int(o) for o in (Op.ADD, Op.SUB, Op.MUL, Op.AND, Op.OR, Op.XOR,
                         Op.NOT, Op.LSL, Op.LSR)],
    2: [int(Op.LOD)], 3: [int(Op.STO)], 4: [int(Op.LODI)],
    5: [int(o) for o in (Op.TDX, Op.TDY, Op.BID, Op.PID)],
    6: [int(Op.DOT), int(Op.SUM)], 7: [int(Op.INVSQR)],
    10: [int(Op.SETP)], 11: [int(Op.SELP)],
    8: [int(Op.GLD)], 9: [int(Op.GST)],
}
# the branches a fused segment may hold, the default draw: GLD (8) and
# GST (9) are drawn only where ``sels`` names them, since a segment's
# tables must stay SM-local
SM_LOCAL_SELS = (1, 2, 3, 4, 5, 6, 7, 10, 11)
# the load and store ports, whose address operand is one of the address
# registers
_PORT_SELS = (2, 3, 8, 9)


def random_f32_words(rng: np.random.Generator, shape) -> np.ndarray:
    """uint32 FP32 words: mostly normal values over a wide range, with
    signed zeros, infinities, NaNs and denormals mixed in."""
    x = (rng.standard_normal(shape)
         * np.exp2(rng.integers(-30, 30, shape))).astype(np.float32)
    w = x.view(np.uint32).copy()
    pick = rng.random(shape) < 0.15
    w[pick] = rng.choice(_SPECIAL_F32, size=int(pick.sum()))
    den = rng.random(shape) < 0.05
    w[den] = (rng.integers(1, 1 << 23, int(den.sum()))
              | (rng.integers(0, 2, int(den.sum())) << 31)).astype(np.uint32)
    return w


def tiny_product_words(rng: np.random.Generator, shape
                       ) -> tuple[np.ndarray, np.ndarray]:
    """uint32 FP32 operand pairs whose products lie around the smallest
    normal 2**-126, with random signs: ``a`` up to 16 ulps below 1 (three
    in four) or up to 15 above, ``b`` up to 7 ulps above 2**-126. They
    reach all three outcomes of an FP32 MUL there: a denormal (flushed
    either way), a normal, and an exact product just below 2**-126 that
    IEEE rounds up to 2**-126 and x86 flushes (tiny after rounding). The
    first four pairs are 0x3F7FFFFF x 0x00800000 with each sign."""
    size = int(np.prod(shape))
    a = np.where(rng.random(size) < 0.75,
                 0x3F800000 - rng.integers(1, 17, size),
                 0x3F800000 + rng.integers(0, 16, size))
    b = 0x00800000 + rng.integers(0, 8, size)
    a |= rng.integers(0, 2, size) << 31
    b |= rng.integers(0, 2, size) << 31
    a[:4] = [0x3F7FFFFF, 0xBF7FFFFF, 0x3F7FFFFF, 0xBF7FFFFF]
    b[:4] = [0x00800000, 0x00800000, 0x80800000, 0x80800000]
    return (a.astype(np.uint32).reshape(shape),
            b.astype(np.uint32).reshape(shape))


def random_state(rng: np.random.Generator, n_sms: int, depth: int):
    """``(regs, shmem)`` uint32 arrays for ``n_sms`` SMs with ``depth``
    shared-memory words, laid out as the register map above."""
    regs = rng.integers(0, 1 << 32, (n_sms, MAX_THREADS, N_REGS),
                        dtype=np.uint64).astype(np.uint32)
    for r in _ADDR_REGS:
        regs[:, :, r] = rng.integers(-8, depth + 8,
                                     (n_sms, MAX_THREADS)).astype(np.uint32)
    regs[:, :, _FP_REGS.start:_FP_REGS.stop] = random_f32_words(
        rng, (n_sms, MAX_THREADS, len(_FP_REGS)))
    shmem = random_f32_words(rng, (n_sms, depth))
    return regs, shmem


def _draw_row(rng: np.random.Generator, sels, depth_table) -> dict:
    """One SM-local row's fields, drawn from the data-switch branches
    ``sels``."""
    sel = int(rng.choice(sels))
    op = int(rng.choice(_OPS_OF_SEL[sel]))
    f = dict(sel=sel, opcode=op, typ=int(rng.integers(0, 4)),
             rd=int(rng.integers(0, N_REGS)),
             ra=int(rng.integers(0, N_REGS)),
             rb=int(rng.integers(0, N_REGS)),
             imm=0, x=0, ext_a=0, ext_b=0, pen=0, preg=0, pneg=0,
             act_waves=int(rng.choice(depth_table)),
             act_wthreads=int(rng.choice([16, 8, 4, 1])))
    if sel in _PORT_SELS:
        f["ra"] = int(rng.choice(list(_ADDR_REGS)))
        f["imm"] = int(rng.integers(-16, 17))
    elif sel == 4:
        f["imm"] = int(rng.integers(-(1 << 14), 1 << 14))
    elif sel == 6:
        f["typ"] = 2
        f["ra"], f["rb"] = (int(v) for v in rng.choice(list(_FP_REGS), 2))
    elif sel == 7:
        f["typ"] = 2
        f["ra"] = int(rng.choice(list(_FP_REGS)))
    elif sel == 10:
        f["imm"] = int(rng.integers(0, 8))
        f["typ"] = int(rng.integers(0, 3))
    elif sel == 1 and rng.random() < 0.5:
        f["typ"] = 2
        f["ra"], f["rb"] = (int(v) for v in rng.choice(list(_FP_REGS), 2))
    if sel != 10 and rng.random() < 0.25:
        _snoop(rng, f)
    if rng.random() < 0.3:
        f["pen"] = 1
        f["preg"] = int(rng.integers(0, N_REGS))
        f["pneg"] = int(rng.integers(0, 2))
    return f


def _snoop(rng: np.random.Generator, f: dict, n_waves: int = 32) -> None:
    """Snoop ``f``'s operands from wavefronts below ``n_waves``."""
    f["x"] = 1
    f["ext_a"], f["ext_b"] = (int(v) for v in rng.integers(0, n_waves, 2))
    f["imm"] = 0


def _hazards(rng: np.random.Generator, f: dict, sels, n_waves: int
             ) -> list[dict]:
    """``f``, or a short run of rows built around it in which one thread
    reads what another writes: a snooped row whose destination is one of
    its own sources, an LOD right after an STO to the same addresses, an INVSQR
    right after a write to its source, or a DOT/SUM over snooped
    operands. Snooped operands mostly come from the ``n_waves`` wavefronts
    a block has, and half of the rows run on all of them, so that the
    thread read is often one that writes."""
    if rng.random() < 0.5:
        f["act_waves"] = n_waves
    snoop_waves = n_waves if rng.random() < 0.75 else 32
    p = rng.random()
    if p < 0.2 and f["sel"] in (1, 2, 6, 11):
        _snoop(rng, f, snoop_waves)
        f["rd"] = f["rb"] if f["sel"] != 2 and rng.random() < 0.5 \
            else f["ra"]
        return [f]
    if p < 0.4 and {2, 3} <= set(sels):
        sto = dict(f, sel=3, opcode=int(_OPS_OF_SEL[3][0]),
                   ra=int(rng.choice(list(_ADDR_REGS))),
                   imm=int(rng.integers(-4, 5)),
                   rd=int(rng.integers(0, N_REGS)))
        if rng.random() < 0.5:
            _snoop(rng, sto, snoop_waves)
        lod = dict(sto, sel=2, opcode=int(_OPS_OF_SEL[2][0]),
                   rd=int(rng.integers(4, N_REGS)))
        return [sto, lod]
    if p < 0.6 and 7 in sels:
        k = int(rng.choice(list(_FP_REGS)))
        if rng.random() < 0.5:
            writer = dict(f, sel=1, opcode=int(rng.choice(_OPS_OF_SEL[1][:3])),
                          typ=2, rd=k, ra=int(rng.choice(list(_FP_REGS))),
                          rb=int(rng.choice(list(_FP_REGS))), x=0, ext_a=0,
                          ext_b=0, imm=0)
        else:
            writer = dict(f, sel=4, opcode=int(_OPS_OF_SEL[4][0]), typ=2,
                          rd=k, x=0, ext_a=0, ext_b=0,
                          imm=int(rng.integers(1, 1 << 14)))
        sfu = dict(writer, sel=7, opcode=int(_OPS_OF_SEL[7][0]), typ=2,
                   rd=int(rng.integers(0, N_REGS)), ra=k, imm=0, x=0,
                   ext_a=0, ext_b=0)
        if rng.random() < 0.6:
            _snoop(rng, sfu, snoop_waves)
        return [writer, sfu]
    if p < 0.8 and 6 in sels:
        dot = dict(f, sel=6, opcode=int(rng.choice(_OPS_OF_SEL[6])), typ=2,
                   ra=int(rng.choice(list(_FP_REGS))),
                   rb=int(rng.choice(list(_FP_REGS))))
        _snoop(rng, dot, snoop_waves)
        if rng.random() < 0.5:
            dot["rd"] = dot["ra"]
        return [dot]
    return [f]


def random_rows(rng: np.random.Generator, n_rows: int, *,
                sels=SM_LOCAL_SELS, n_threads: int = MAX_THREADS,
                hazards: bool = False) -> np.ndarray:
    """A (n_rows, 15) int32 table of rows in ``FIELDS`` order, drawn from
    the data-switch branches ``sels`` (the SM-local ones by default; GLD
    and GST rows only where ``sels`` holds 8 or 9). ``hazards`` makes the
    table dense in accesses of one thread to another's words (see
    ``_hazards``), the races the segment kernel's barriers must order."""
    n_waves = max(1, (n_threads + 15) // 16)
    depth_table = [n_waves, max(1, n_waves // 2), max(1, n_waves // 4), 1]
    rows: list[dict] = []
    while len(rows) < n_rows:
        f = _draw_row(rng, sels, depth_table)
        rows.extend(_hazards(rng, f, sels, n_waves) if hazards else [f])
    out = np.zeros((n_rows, len(FIELDS)), np.int32)
    for i, f in enumerate(rows[:n_rows]):
        out[i] = [f[k] for k in FIELDS]
    return out
