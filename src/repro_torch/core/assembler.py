"""Two-pass assembler for the eGPU ISA.

Syntax (one instruction per line, ``//`` or ``;`` comments, ``label:`` lines):

    ADD.INT32 R6, R1, R3          // typed 3-operand ALU op
    MUL.FP32  R2, R4, R5 {w1,d1}  // flexible-ISA: single thread
    AND       R7, R1, R4          // logic ops are untyped (bitwise)
    NOT       R3, R1
    LOD       R2, (R1)+5          // shared-memory indexed load
    STO       R2, (R3)+0          // shared-memory indexed store
    GLD       R2, (R1)+5          // GLOBAL-memory load (shared across SMs)
    GST       R2, (R3)+0          // GLOBAL-memory store
    BID       R7                  // block index within the program's grid
    PID       R6                  // program index (multi-program launch)
    LOD       R4, #128            // immediate load
    LOD.FP32  R4, #3              // immediate load, converted to 3.0f
    TDX       R1                  // thread id x -> R1
    DOT.FP32  R9, R2, R2 {d1}     // wavefront dot product -> lane 0
    INVSQR.FP32 R8, R9 {w1,d1}    // SFU
    ADD.FP32  R1, R2@3, R3@0      // thread snooping (X=1): wavefront exts
    INIT      8
    loop_top:
    LOOP      loop_top
    JSR       subroutine
    RTS
    JMP       end
    NOP
    STOP

Flexible-ISA modifiers ``{...}``: ``w16|w8|w4|w1`` (or wfull/whalf/wquarter/
wsingle) and ``d32|d16|d8|d1`` (or dfull/dhalf/dquarter/dsingle). ``d`` counts
are relative to a 32-wavefront (512-thread) full block; the encoding is the
2-bit code, so they mean full/half/quarter/single of the *initialized* block.
"""
from __future__ import annotations

import functools
import re
from dataclasses import dataclass, field

import numpy as np

from .isa import (
    RESULT_LATENCY,
    Cond,
    Depth,
    Instr,
    Op,
    Typ,
    Width,
    instr_class,
)

_WIDTH_ALIASES = {
    "w16": Width.FULL, "wfull": Width.FULL,
    "w8": Width.HALF, "whalf": Width.HALF,
    "w4": Width.QUARTER, "wquarter": Width.QUARTER,
    "w1": Width.SINGLE, "wsingle": Width.SINGLE,
}
_DEPTH_ALIASES = {
    "d32": Depth.FULL, "dfull": Depth.FULL,
    "d16": Depth.HALF, "dhalf": Depth.HALF,
    "d8": Depth.QUARTER, "dquarter": Depth.QUARTER,
    "d1": Depth.SINGLE, "dsingle": Depth.SINGLE,
}

_THREE_OP = {Op.ADD, Op.SUB, Op.MUL, Op.AND, Op.OR, Op.XOR, Op.LSL, Op.LSR,
             Op.DOT, Op.SUM, Op.SELP}
_TWO_OP = {Op.NOT, Op.INVSQR}
_REG = re.compile(r"^R(\d+)(?:@(\d+))?$", re.IGNORECASE)
_MEM = re.compile(r"^\(R(\d+)\)\+(-?\d+)$", re.IGNORECASE)
_LABEL = re.compile(r"^([A-Za-z_][A-Za-z0-9_]*):$")
_PRED = re.compile(r"^@(!?)R(\d+)$", re.IGNORECASE)
# ops the sequencer handles scalar-side: never predicable (the instruction
# stream must stay static — divergence is per-lane masking only)
_NO_PRED = {Op.JMP, Op.JSR, Op.RTS, Op.LOOP, Op.INIT, Op.STOP, Op.NOP}


class AsmError(ValueError):
    def __init__(self, msg: str, lineno: int | None = None, line: str = ""):
        self.lineno = lineno
        super().__init__(f"line {lineno}: {msg}  [{line.strip()}]"
                         if lineno is not None else msg)


@dataclass
class Program:
    """Assembled program: words + source map + static metadata."""

    words: np.ndarray                 # (n,) int64
    instrs: list[Instr]
    labels: dict[str, int]
    source: list[str] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.instrs)


def _parse_reg(tok: str, lineno: int, line: str) -> tuple[int, int | None]:
    m = _REG.match(tok)
    if not m:
        raise AsmError(f"expected register, got {tok!r}", lineno, line)
    r = int(m.group(1))
    if not 0 <= r < 16:
        raise AsmError(f"register R{r} out of range (16 regs/thread)", lineno, line)
    ext = int(m.group(2)) if m.group(2) is not None else None
    if ext is not None and not 0 <= ext < 32:
        raise AsmError(f"snoop wavefront @{ext} out of range (32)", lineno, line)
    return r, ext


def _parse_modifiers(mod: str, lineno: int, line: str) -> tuple[Width, Depth]:
    width, depth = Width.FULL, Depth.FULL
    for part in (p.strip().lower() for p in mod.split(",") if p.strip()):
        if part in _WIDTH_ALIASES:
            width = _WIDTH_ALIASES[part]
        elif part in _DEPTH_ALIASES:
            depth = _DEPTH_ALIASES[part]
        else:
            raise AsmError(f"unknown modifier {part!r}", lineno, line)
    return width, depth


def assemble_line(line: str, labels: dict[str, int], lineno: int = 0) -> Instr | None:
    """Assemble one source line (labels must already be resolved)."""
    code = line.split("//")[0].split(";")[0].strip()
    if not code or _LABEL.match(code):
        return None

    mod = ""
    if "{" in code:
        code, _, rest = code.partition("{")
        mod = rest.rstrip().rstrip("}")
        code = code.strip()

    pred: tuple[int, int] | None = None    # (preg, pneg)
    if code.startswith("@"):
        ptok, *prest = code.split(None, 1)
        m = _PRED.match(ptok)
        if not m:
            raise AsmError(f"expected @Rp or @!Rp predicate guard, got "
                           f"{ptok!r}", lineno, line)
        preg = int(m.group(2))
        if not 0 <= preg < 16:
            raise AsmError(f"predicate register R{preg} out of range",
                           lineno, line)
        if not prest:
            raise AsmError("predicate guard with no instruction",
                           lineno, line)
        pred = (preg, 1 if m.group(1) else 0)
        code = prest[0]

    head, *rest = code.split(None, 1)
    operands = [t.strip() for t in rest[0].split(",")] if rest else []

    mnemonic, _, typ_s = head.partition(".")
    mnemonic = mnemonic.upper()
    cond: Cond | None = None
    if mnemonic == "SETP":
        # SETP.cond[.typ]: the condition rides imm[2:0]
        cond_s, _, typ_s = typ_s.partition(".")
        try:
            cond = Cond[cond_s.upper()]
        except KeyError:
            raise AsmError(f"SETP needs a condition (SETP.LT.FP32 ...), got "
                           f"{cond_s!r}", lineno, line) from None
    try:
        op = Op[mnemonic]
    except KeyError:
        raise AsmError(f"unknown mnemonic {mnemonic!r}", lineno, line) from None
    typ = Typ[typ_s.upper()] if typ_s else Typ.INT32
    width, depth = _parse_modifiers(mod, lineno, line)

    kw: dict = dict(op=op, typ=typ, width=width, depth=depth)
    if pred is not None:
        if op in _NO_PRED:
            raise AsmError(f"{op.name} cannot be predicated (scalar "
                           f"sequencer op)", lineno, line)
        kw.update(pen=1, preg=pred[0], pneg=pred[1])

    if op == Op.SETP:
        if len(operands) != 3:
            raise AsmError("SETP.cond[.typ] Rd, Ra, Rb", lineno, line)
        rd, _ = _parse_reg(operands[0], lineno, line)
        ra, ea = _parse_reg(operands[1], lineno, line)
        rb, eb = _parse_reg(operands[2], lineno, line)
        if ea is not None or eb is not None:
            raise AsmError("SETP cannot snoop (cond lives in imm[2:0])",
                           lineno, line)
        kw.update(rd=rd, ra=ra, rb=rb, imm=int(cond))
    elif op in _THREE_OP:
        if len(operands) != 3:
            raise AsmError(f"{op.name} needs 3 operands", lineno, line)
        rd, _ = _parse_reg(operands[0], lineno, line)
        ra, ea = _parse_reg(operands[1], lineno, line)
        rb, eb = _parse_reg(operands[2], lineno, line)
        kw.update(rd=rd, ra=ra, rb=rb)
        if ea is not None or eb is not None:
            kw.update(x=1, ext_a=ea or 0, ext_b=eb or 0)
    elif op in _TWO_OP:
        if len(operands) != 2:
            raise AsmError(f"{op.name} needs 2 operands", lineno, line)
        rd, _ = _parse_reg(operands[0], lineno, line)
        ra, ea = _parse_reg(operands[1], lineno, line)
        kw.update(rd=rd, ra=ra)
        if ea is not None:
            kw.update(x=1, ext_a=ea)
    elif op in (Op.LOD, Op.STO, Op.GLD, Op.GST):
        if len(operands) != 2:
            raise AsmError(f"{op.name} needs 2 operands", lineno, line)
        rd, _ = _parse_reg(operands[0], lineno, line)
        kw.update(rd=rd)
        tgt = operands[1]
        if tgt.startswith("#"):
            if op != Op.LOD:
                raise AsmError(f"{op.name} has no immediate form", lineno, line)
            kw.update(op=Op.LODI, imm=int(tgt[1:], 0))
        else:
            m = _MEM.match(tgt)
            if not m:
                raise AsmError(f"expected (Ra)+off or #imm, got {tgt!r}", lineno, line)
            kw.update(ra=int(m.group(1)), imm=int(m.group(2)))
    elif op == Op.LODI:
        if len(operands) != 2 or not operands[1].startswith("#"):
            raise AsmError("LODI Rd, #imm", lineno, line)
        rd, _ = _parse_reg(operands[0], lineno, line)
        kw.update(rd=rd, imm=int(operands[1][1:], 0))
    elif op in (Op.TDX, Op.TDY, Op.BID, Op.PID):
        if len(operands) != 1:
            raise AsmError(f"{op.name} needs 1 operand", lineno, line)
        rd, _ = _parse_reg(operands[0], lineno, line)
        kw.update(rd=rd)
    elif op in (Op.JMP, Op.JSR, Op.LOOP):
        if len(operands) != 1:
            raise AsmError(f"{op.name} needs a target", lineno, line)
        tgt = operands[0]
        if tgt in labels:
            kw.update(imm=labels[tgt])
        else:
            try:
                kw.update(imm=int(tgt, 0))
            except ValueError:
                raise AsmError(f"undefined label {tgt!r}", lineno, line) from None
    elif op == Op.INIT:
        if len(operands) != 1:
            raise AsmError("INIT needs a loop count", lineno, line)
        kw.update(imm=int(operands[0], 0))
    elif op in (Op.RTS, Op.STOP, Op.NOP):
        if operands:
            raise AsmError(f"{op.name} takes no operands", lineno, line)
    else:  # pragma: no cover
        raise AsmError(f"unhandled opcode {op}", lineno, line)

    return Instr(**kw)


@functools.lru_cache(maxsize=512)
def assemble(text: str) -> Program:
    """Two-pass assemble of a full program.

    Memoized on the source text: assembly is pure, and the program
    builders (FFT/QRD/saxpy) re-emit identical source every launch —
    without the cache, re-assembly dominates warm launch time. Treat the
    returned ``Program`` (and its ``words``) as immutable.
    """
    lines = text.splitlines()
    # pass 1: label addresses
    labels: dict[str, int] = {}
    addr = 0
    for i, raw in enumerate(lines):
        code = raw.split("//")[0].split(";")[0].strip()
        if not code:
            continue
        m = _LABEL.match(code)
        if m:
            if m.group(1) in labels:
                raise AsmError(f"duplicate label {m.group(1)!r}", i + 1, raw)
            labels[m.group(1)] = addr
        else:
            addr += 1
    # pass 2: encode
    instrs: list[Instr] = []
    srcs: list[str] = []
    for i, raw in enumerate(lines):
        ins = assemble_line(raw, labels, i + 1)
        if ins is not None:
            instrs.append(ins)
            srcs.append(raw.strip())
    words = np.array([ins.encode() for ins in instrs], dtype=np.int64)
    return Program(words=words, instrs=instrs, labels=labels, source=srcs)


def disassemble(word: int) -> str:
    """One encoded 40-bit word as assembly text (the predicate prefix, the
    mnemonic with its type suffix, operands and active-shape modifiers)."""
    ins = Instr.decode(int(word))
    p = f"@{'!' if ins.pneg else ''}R{ins.preg} " if ins.pen else ""
    return p + _disasm_body(ins)


def _disasm_body(ins: Instr) -> str:
    op = ins.op
    t = f".{ins.typ.name}" if op in (Op.ADD, Op.SUB, Op.MUL, Op.DOT, Op.SUM,
                                     Op.INVSQR, Op.LODI, Op.SETP) else ""
    if op == Op.SETP:
        return (f"SETP.{Cond(ins.imm).name}{t} "
                f"R{ins.rd}, R{ins.ra}, R{ins.rb}")
    mods = []
    if ins.width != Width.FULL:
        mods.append(f"w{(16, 8, 4, 1)[int(ins.width)]}")
    if ins.depth != Depth.FULL:
        mods.append({1: "dhalf", 2: "dquarter", 3: "d1"}[int(ins.depth)])
    m = (" {" + ",".join(mods) + "}") if mods else ""

    def reg(r: int, ext: int) -> str:
        return f"R{r}@{ext}" if ins.x else f"R{r}"

    if op in _THREE_OP:
        return (f"{op.name}{t} R{ins.rd}, {reg(ins.ra, ins.ext_a)}, "
                f"{reg(ins.rb, ins.ext_b)}{m}")
    if op in _TWO_OP:
        return f"{op.name}{t} R{ins.rd}, {reg(ins.ra, ins.ext_a)}{m}"
    if op in (Op.LOD, Op.GLD):
        return f"{op.name}{t} R{ins.rd}, (R{ins.ra})+{ins.imm}{m}"
    if op in (Op.STO, Op.GST):
        return f"{op.name} R{ins.rd}, (R{ins.ra})+{ins.imm}{m}"
    if op == Op.LODI:
        return f"LOD{t} R{ins.rd}, #{ins.imm}{m}"
    if op in (Op.TDX, Op.TDY, Op.BID, Op.PID):
        return f"{op.name} R{ins.rd}{m}"
    if op in (Op.JMP, Op.JSR, Op.LOOP):
        return f"{op.name} {ins.imm}"
    if op == Op.INIT:
        return f"INIT {ins.imm}"
    return op.name


# ---------------------------------------------------------------------------
# Static hazard checker (paper §III: "Hazards have to be managed by the
# programmer; there are no hardware interlocks.")
# ---------------------------------------------------------------------------

def check_hazards(program: Program, n_threads: int = 512) -> list[str]:
    """RAW-hazard scan over straight-line code segments.

    The eGPU pipeline is 9 deep; an instruction's result is not readable
    until RESULT_LATENCY cycles after issue. An instruction occupies the
    sequencer for its class-dependent cycle count, so with enough active
    wavefronts hazards hide themselves (paper: "typically only exposed for
    small thread blocks"). Returns human-readable warnings; control-flow
    boundaries reset the window (conservative in the benign direction).
    """
    from .cycles import instr_cycles  # late import to avoid a cycle

    warnings: list[str] = []
    window: list[tuple[int, int, int]] = []  # (pc, rd, ready_cycle)
    mem_ready = 0                            # shared-mem store->load fence
    gmem_ready = 0                           # global-mem store->load fence
    now = 0
    for pc, ins in enumerate(program.instrs):
        if ins.op in (Op.JMP, Op.JSR, Op.RTS, Op.LOOP, Op.STOP):
            window.clear()
            now += 1
            continue
        reads = []
        if ins.op in _THREE_OP or ins.op == Op.SETP:
            reads = [ins.ra, ins.rb]
        elif ins.op in _TWO_OP or ins.op in (Op.LOD, Op.STO, Op.GLD, Op.GST):
            reads = [ins.ra]
            if ins.op in (Op.STO, Op.GST):
                reads.append(ins.rd)  # stores read the stored register
        if ins.pen:
            reads.append(ins.preg)  # the guard reads its predicate register
        src = program.source[pc] if pc < len(program.source) else ""
        for (wpc, wrd, ready) in window:
            if wrd in reads and now < ready:
                warnings.append(
                    f"pc={pc}: reads R{wrd} written at pc={wpc}, ready at "
                    f"cycle {ready} but issued at {now} "
                    f"(insert {ready - now} NOP-cycles)  [{src}]")
        if ins.op == Op.LOD and now < mem_ready:
            warnings.append(
                f"pc={pc}: LOD issued at {now} before a prior STO commits at "
                f"{mem_ready} (insert {mem_ready - now} NOP-cycles)  [{src}]")
        if ins.op == Op.GLD and now < gmem_ready:
            warnings.append(
                f"pc={pc}: GLD issued at {now} before a prior GST commits at "
                f"{gmem_ready} (insert {gmem_ready - now} NOP-cycles)  [{src}]")
        cyc = instr_cycles(ins, n_threads)
        if ins.op == Op.STO:
            mem_ready = max(mem_ready, now + RESULT_LATENCY)
        if ins.op == Op.GST:
            gmem_ready = max(gmem_ready, now + RESULT_LATENCY)
        if ins.op not in (Op.NOP, Op.STO, Op.GST):
            window.append((pc, ins.rd, now + RESULT_LATENCY))
        window = [w for w in window if w[2] > now]
        now += cyc
    return warnings


_WARN_PC = re.compile(r"pc=(\d+):.*insert (\d+) NOP-cycles")


@functools.lru_cache(maxsize=512)
def auto_nop(text: str, n_threads: int = 512, max_iter: int = 64) -> str:
    """Insert NOPs until ``check_hazards`` is clean (the programmer's job on
    real eGPU hardware — no interlocks). Returns the padded source.
    Memoized like ``assemble`` (pure text -> text)."""
    for _ in range(max_iter):
        prog = assemble(text)
        warns = check_hazards(prog, n_threads)
        if not warns:
            return text
        # collect every flagged pc; map instruction index -> source line
        need: dict[int, int] = {}
        for w in warns:
            m = _WARN_PC.search(w)
            if m:
                pc, n = int(m.group(1)), int(m.group(2))
                need[pc] = max(need.get(pc, 0), n)
        lines = text.splitlines()
        pc_to_line: dict[int, int] = {}
        idx = -1
        for ln, raw in enumerate(lines):
            code = raw.split("//")[0].split(";")[0].strip()
            if not code or _LABEL.match(code):
                continue
            idx += 1
            if idx in need:
                pc_to_line[idx] = ln
        if len(pc_to_line) != len(need):  # pragma: no cover
            raise AsmError("auto_nop: cannot locate flagged pcs")
        # patch bottom-up so earlier line indices stay valid
        for pc in sorted(need, reverse=True):
            ln = pc_to_line[pc]
            lines[ln:ln] = ["    NOP"] * need[pc]
        text = "\n".join(lines)
    raise AsmError("auto_nop: did not converge")
