"""eGPU ISA: 40-bit I-word encoding (paper Fig. 3, Table II).

Bit layout (paper numbers bits [40:1]; we use 0-indexed positions [39:0]):

    [39:38] WIDTH    wavefront width:  0=full(16) 1=half(8) 2=quarter(4) 3=single(1)
    [37:36] DEPTH    block depth:      0=full     1=half    2=quarter    3=single wavefront
    [35:30] OPCODE   6 bits (64 possible; 23 implemented + NOP)
    [29:28] TYPE     0=INT32 1=UINT32 2=FP32
    [27:24] RD       destination register
    [23:20] RA       source register A (or address register for LOD/STO)
    [19:16] RB       source register B
    [15]    X        thread-snooping enable
    [14:0]  IMM      15-bit immediate (sign-extended), or when X=1 the two
                     5-bit register-address extensions: [14:10]=EXT_A, [9:5]=EXT_B

The WIDTH/DEPTH pair is the paper's "Variable" field ([40:37]): the flexible
ISA that resizes the thread block per instruction with no flush.

Predication extension (SIMT divergence): the architectural 40-bit word is
full, so the per-instruction predicate rides in an *extension byte* above
bit 40 (the same move the device extension made in opcode space for
GLD/GST/BID/PID):

    [45]    PNEG     predicate negate: guard on !P instead of P
    [44]    PEN      predicate enable (0 = legacy word, unconditional)
    [43:40] PREG     predicate register (a general register; LSB is the
                     predicate value, SETP writes exactly 0/1)

A lane executes a predicated instruction only when its effective mask —
flexible-ISA active shape AND (``regs[preg] & 1) ^ pneg`` — is set: masked
lanes write no register/shmem/gmem state and masked gmem lanes generate no
global-port traffic. Legacy encodings have zeros above bit 40, so PEN=0 and
every pre-existing program is bit-for-bit unchanged. Control-flow ops
(JMP/JSR/RTS/LOOP/INIT/STOP/NOP) cannot be predicated: the sequencer is
scalar and the issued instruction stream must stay static (that staticness
is what keeps every cycle count in this repo exact).
"""
from __future__ import annotations

import dataclasses
import enum

WORD_BITS = 40

# ---- field positions (lsb, nbits) ------------------------------------------
F_IMM = (0, 15)
F_X = (15, 1)
F_RB = (16, 4)
F_RA = (20, 4)
F_RD = (24, 4)
F_TYPE = (28, 2)
F_OPCODE = (30, 6)
F_DEPTH = (36, 2)
F_WIDTH = (38, 2)

# snoop sub-fields inside IMM
F_EXT_A = (10, 5)  # within the 40-bit word: bits [14:10]
F_EXT_B = (5, 5)   # bits [9:5]

# predication extension byte, above the architectural 40-bit word
F_PREG = (40, 4)
F_PEN = (44, 1)
F_PNEG = (45, 1)


class Op(enum.IntEnum):
    """Opcodes. 23 architectural instructions (Table II) + NOP, plus the
    multi-SM device extension (GLD/GST/BID): a global-memory segment shared
    by every SM in a packed sector, and the block index for CUDA-style
    grid/block addressing (the multi-eGPU packing of §III.E / the scalable
    follow-up paper)."""

    NOP = 0
    # Arithmetic (typed: INT32 / UINT32 / FP32)
    ADD = 1
    SUB = 2
    MUL = 3
    # Logic
    AND = 4
    OR = 5
    XOR = 6
    NOT = 7
    LSL = 8
    LSR = 9
    # Memory (shared)
    LOD = 10   # LOD Rd (Ra)+offset
    STO = 11   # STO Rd (Ra)+offset
    # Immediate
    LODI = 12  # LOD Rd #Imm
    # Thread
    TDX = 13
    TDY = 14
    # Extension units
    DOT = 15     # wavefront dot product -> lane 0 of each active wavefront
    SUM = 16     # wavefront reduction of (Ra + Rb) -> lane 0
    INVSQR = 17  # SFU: 1/sqrt, lane 0 of wavefront 0
    # Control
    JMP = 18
    JSR = 19
    RTS = 20
    LOOP = 21
    INIT = 22
    STOP = 23
    # Multi-SM device extension (not in the single-SM paper ISA)
    GLD = 24   # GLD Rd (Ra)+offset — global-memory load (shared across SMs)
    GST = 25   # GST Rd (Ra)+offset — global-memory store
    BID = 26   # BID Rd — thread-block index within the program's grid
    PID = 27   # PID Rd — program index within a multi-program launch
    # Predication extension (SIMT divergence; no data-dependent *control*
    # flow — divergence is per-lane masking, the instruction stream is
    # still static)
    SETP = 28  # SETP.cond.typ Rd, Ra, Rb — per-lane compare -> 0/1 in Rd
    SELP = 29  # SELP Rd, Ra, Rb — Rd = pred ? Ra : Rb (pred from @Rp)


class Cond(enum.IntEnum):
    """SETP compare conditions (carried in imm[2:0] — SETP cannot snoop)."""

    EQ = 0
    NE = 1
    LT = 2
    LE = 3
    GT = 4
    GE = 5


class Typ(enum.IntEnum):
    INT32 = 0
    UINT32 = 1
    FP32 = 2


class Width(enum.IntEnum):
    FULL = 0      # 16 threads / wavefront
    HALF = 1      # 8
    QUARTER = 2   # 4
    SINGLE = 3    # 1


class Depth(enum.IntEnum):
    FULL = 0      # all initialized wavefronts
    HALF = 1
    QUARTER = 2
    SINGLE = 3    # one wavefront ("single cycle")


WIDTH_THREADS = {Width.FULL: 16, Width.HALF: 8, Width.QUARTER: 4, Width.SINGLE: 1}

# instruction classes for the cycle profile (Tables III / IV rows)
CLASS_NAMES = (
    "NOP",        # 0
    "LOD_IMM",    # 1
    "LOGIC",      # 2
    "INT",        # 3  (INT32/UINT32 arith + TDx/TDy address generation)
    "LOD_IDX",    # 4
    "FP_ADDSUB",  # 5
    "FP_MUL",     # 6
    "FP_DOT",     # 7
    "FP_SFU",     # 8
    "STO_IDX",    # 9
    "CONTROL",    # 10 (JMP/JSR/RTS/LOOP/INIT/STOP)
    "GMEM",       # 11 (GLD/GST: single-port global memory, shared by SMs)
)
NUM_CLASSES = len(CLASS_NAMES)

# opcodes whose immediate is an unsigned I-MEM address (decode does not
# sign-extend these); everything else carries a signed 14-bit immediate
CONTROL_IMM_OPS = frozenset({Op.JMP, Op.JSR, Op.LOOP, Op.INIT})


def _check(val: int, nbits: int, name: str) -> int:
    if not 0 <= val < (1 << nbits):
        raise ValueError(f"{name}={val} does not fit in {nbits} bits")
    return val


def _put(word: int, field: tuple[int, int], val: int, name: str) -> int:
    lsb, nbits = field
    return word | (_check(val, nbits, name) << lsb)


def get(word: int, field: tuple[int, int]) -> int:
    lsb, nbits = field
    return (word >> lsb) & ((1 << nbits) - 1)


@dataclasses.dataclass(frozen=True)
class Instr:
    """Decoded instruction (assembler-side representation)."""

    op: Op
    typ: Typ = Typ.INT32
    rd: int = 0
    ra: int = 0
    rb: int = 0
    imm: int = 0          # signed, -(2**14) .. 2**14-1 (or unsigned address)
    x: int = 0            # snoop enable
    ext_a: int = 0        # snoop wavefront index for RA (0..31)
    ext_b: int = 0        # snoop wavefront index for RB
    width: Width = Width.FULL
    depth: Depth = Depth.FULL
    pen: int = 0          # predicate enable (0 = unconditional, legacy)
    preg: int = 0         # predicate register (LSB = predicate value)
    pneg: int = 0         # guard on !P instead of P

    def encode(self) -> int:
        word = 0
        if self.pen:
            if self.op in CONTROL_IMM_OPS or self.op in (
                    Op.RTS, Op.STOP, Op.NOP):
                raise ValueError(
                    f"{self.op.name} cannot be predicated: the sequencer "
                    f"is scalar and the instruction stream must stay static")
            word = _put(word, F_PEN, 1, "pen")
            word = _put(word, F_PREG, self.preg, "preg")
            word = _put(word, F_PNEG, self.pneg, "pneg")
        elif self.preg or self.pneg:
            raise ValueError("preg/pneg set without pen=1")
        if self.op == Op.SETP:
            if self.x:
                raise ValueError(
                    "SETP cannot snoop: the condition lives in imm[2:0]")
            Cond(self.imm)  # raises on an out-of-range condition
        word = _put(word, F_WIDTH, int(self.width), "width")
        word = _put(word, F_DEPTH, int(self.depth), "depth")
        word = _put(word, F_OPCODE, int(self.op), "opcode")
        word = _put(word, F_TYPE, int(self.typ), "type")
        word = _put(word, F_RD, self.rd, "rd")
        word = _put(word, F_RA, self.ra, "ra")
        word = _put(word, F_RB, self.rb, "rb")
        word = _put(word, F_X, self.x, "x")
        if self.x:
            if self.imm:
                raise ValueError("snooping (X=1) reuses the immediate field")
            word = _put(word, F_EXT_A, self.ext_a, "ext_a")
            word = _put(word, F_EXT_B, self.ext_b, "ext_b")
        else:
            imm = self.imm
            if self.op in CONTROL_IMM_OPS:
                # control-flow addresses: unsigned, full 15 bits
                if not 0 <= imm < (1 << 15):
                    raise ValueError(
                        f"control address {imm} out of range for 15 bits")
            elif not -(1 << 14) <= imm < (1 << 14):
                # signed immediates: decode sign-extends bit 14, so encode
                # must reject [2^14, 2^15) or the value round-trips negative
                raise ValueError(
                    f"immediate {imm} out of range for signed 15 bits")
            word = _put(word, F_IMM, imm & 0x7FFF, "imm")
        return word

    @staticmethod
    def decode(word: int) -> "Instr":
        x = get(word, F_X)
        raw_imm = get(word, F_IMM)
        imm = raw_imm - (1 << 15) if (raw_imm & (1 << 14)) else raw_imm
        op = Op(get(word, F_OPCODE))
        # control-flow addresses are unsigned
        if op in CONTROL_IMM_OPS:
            imm = raw_imm
        pen = get(word, F_PEN)
        return Instr(
            pen=pen,
            preg=get(word, F_PREG) if pen else 0,
            pneg=get(word, F_PNEG) if pen else 0,
            op=op,
            typ=Typ(get(word, F_TYPE)),
            rd=get(word, F_RD),
            ra=get(word, F_RA),
            rb=get(word, F_RB),
            imm=0 if x else imm,
            x=x,
            ext_a=get(word, F_EXT_A) if x else 0,
            ext_b=get(word, F_EXT_B) if x else 0,
            width=Width(get(word, F_WIDTH)),
            depth=Depth(get(word, F_DEPTH)),
        )


# opcode -> profile class (operand-type dependent ops resolved at decode time)
def instr_class(op: Op, typ: Typ) -> int:
    if op == Op.NOP:
        return 0
    if op == Op.LODI:
        return 1
    if op in (Op.AND, Op.OR, Op.XOR, Op.NOT, Op.LSL, Op.LSR):
        return 2
    if op in (Op.ADD, Op.SUB, Op.MUL):
        if typ == Typ.FP32:
            return 6 if op == Op.MUL else 5
        return 3
    if op in (Op.TDX, Op.TDY, Op.BID, Op.PID):
        return 3
    if op == Op.SETP:
        # the compare rides the arithmetic pipes: FP compare on the
        # FP add/sub unit, integer compare on the INT pipe
        return 5 if typ == Typ.FP32 else 3
    if op == Op.SELP:
        return 3  # a mux: INT-pipe occupancy regardless of operand type
    if op == Op.LOD:
        return 4
    if op == Op.STO:
        return 9
    if op in (Op.DOT, Op.SUM):
        return 7
    if op == Op.INVSQR:
        return 8
    if op in (Op.GLD, Op.GST):
        return 11
    return 10  # control


# latency (pipeline occupancy) of the result, in cycles, for hazard checking.
# Paper: 9-stage pipeline for both INT and FP operations; loads/stores have
# their own (sequencer-dominated) latencies.
RESULT_LATENCY = 9
