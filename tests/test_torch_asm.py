"""The port's host layer against the JAX reference: ISA encode/decode and
the assembler (words, hazard warnings, auto-NOP padding), over the asm
text of every program builder of the reference."""
import numpy as np
import pytest

from repro.core import assembler as j_asm
from repro.core import isa as j_isa
from repro.core.programs import cholesky as j_chol
from repro.core.programs import fft as j_fft
from repro.core.programs import masked_reduction as j_mred
from repro.core.programs import qrd as j_qrd
from repro.core.programs import reduction as j_red
from repro.core.programs import saxpy as j_saxpy
from repro_torch.core import assembler as t_asm
from repro_torch.core import isa as t_isa
from repro_torch.core.programs import fft as t_fft
from repro_torch.core.programs import qrd as t_qrd
from repro_torch.core.programs import saxpy as t_saxpy

# every program builder of the reference, as asm text
BUILDERS = {
    "saxpy128": lambda: j_saxpy.saxpy_asm(128),
    "saxpy_grid4096_b512": lambda: j_saxpy.saxpy_grid_asm(4096, 512),
    "saxpy_grid256_b64": lambda: j_saxpy.saxpy_grid_asm(256, 64),
    "reduction512": lambda: j_red.reduction_asm(512),
    "reduction_grid256": lambda: j_red.reduction_grid_asm(256, 0, 1024, True),
    "reduction_grid256_final": lambda: j_red.reduction_grid_asm(256, 1024,
                                                                2048, False),
    "fft16": lambda: j_fft.fft_asm(16),
    "fft64": lambda: j_fft.fft_asm(64),
    "fft64_unrolled": lambda: j_fft.fft_asm(64, unroll=True),
    "fft64_unpadded": lambda: j_fft.fft_asm(64, pad_hazards=False),
    "qrd16": lambda: j_qrd.qrd_asm(),
    "qrd16_loop": lambda: j_qrd.qrd_asm_loop(),
    "qrd16_unpadded": lambda: j_qrd.qrd_asm(pad_hazards=False),
    "cholesky16_solve": lambda: j_chol.cholesky_asm(True),
    "cholesky16": lambda: j_chol.cholesky_asm(False),
    "masked_reduction256": lambda: j_mred.masked_reduction_asm(
        256, 0, 1024, 1100, 1200, 4),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_assembler_gives_identical_words(name):
    text = BUILDERS[name]()
    j, t = j_asm.assemble(text), t_asm.assemble(text)
    assert np.array_equal(j.words, t.words)
    assert j.labels == t.labels and j.source == t.source
    assert [repr(i) for i in j.instrs] == [repr(i) for i in t.instrs]
    assert j_asm.check_hazards(j) == t_asm.check_hazards(t)
    assert j_asm.auto_nop(text) == t_asm.auto_nop(text)


@pytest.mark.parametrize("builder", [
    lambda m: m.saxpy_grid_asm(4096, 512),
    lambda m: m.saxpy_grid_asm(256, 64),
])
def test_port_saxpy_builder_emits_reference_text(builder):
    assert builder(t_saxpy) == builder(j_saxpy)


@pytest.mark.parametrize("n,unroll", [(16, False), (64, False), (64, True)])
def test_port_fft_builder_emits_reference_text(n, unroll):
    assert t_fft.fft_asm(n, unroll) == j_fft.fft_asm(n, unroll)
    x = np.exp(1j * np.arange(n)).astype(np.complex64)
    assert np.array_equal(t_fft.fft_shmem(x, 3 * n), j_fft.fft_shmem(x, 3 * n))
    assert np.array_equal(t_fft.bitrev_indices(n), j_fft.bitrev_indices(n))


@pytest.mark.parametrize("loop", [False, True])
def test_port_qrd_builder_emits_reference_text(loop):
    build = (lambda m: m.qrd_asm_loop()) if loop else (lambda m: m.qrd_asm())
    assert build(t_qrd) == build(j_qrd)
    a = np.arange(256, dtype=np.float32).reshape(16, 16)
    assert np.array_equal(t_qrd.qrd_shmem(a), j_qrd.qrd_shmem(a))


def _random_instr(rng, m):
    """One random valid instruction of ISA module ``m`` (the port's or the
    reference's): SETP draws its immediate from ``Cond`` and never
    snoops; predicated ops exclude the scalar sequencer ops."""
    op = m.Op(int(rng.choice([int(o) for o in m.Op])))
    kw = dict(op=op, typ=m.Typ(int(rng.integers(0, 3))),
              rd=int(rng.integers(0, 16)), ra=int(rng.integers(0, 16)),
              rb=int(rng.integers(0, 16)),
              width=m.Width(int(rng.integers(0, 4))),
              depth=m.Depth(int(rng.integers(0, 4))))
    if op == m.Op.SETP:
        kw["imm"] = int(rng.choice([int(c) for c in m.Cond]))
    elif op in m.CONTROL_IMM_OPS:
        kw["imm"] = int(rng.integers(0, 1 << 15))
    elif rng.random() < 0.3:
        kw.update(x=1, ext_a=int(rng.integers(0, 32)),
                  ext_b=int(rng.integers(0, 32)))
    else:
        kw["imm"] = int(rng.integers(-(1 << 14), 1 << 14))
    if op not in m.CONTROL_IMM_OPS and op not in (m.Op.RTS, m.Op.STOP,
                                                  m.Op.NOP) \
            and rng.random() < 0.3:
        kw.update(pen=1, preg=int(rng.integers(0, 16)),
                  pneg=int(rng.integers(0, 2)))
    return m.Instr(**kw)


@pytest.mark.parametrize("seed", range(4))
def test_isa_roundtrip_matches_reference(seed):
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(500):
        ij, it = _random_instr(rj, j_isa), _random_instr(rt, t_isa)
        w = it.encode()
        assert w == ij.encode()
        assert t_isa.Instr.decode(w) == it
        assert repr(j_isa.Instr.decode(w)) == repr(t_isa.Instr.decode(w))
        assert t_isa.instr_class(it.op, it.typ) \
            == j_isa.instr_class(ij.op, ij.typ)
    assert t_isa.CLASS_NAMES == j_isa.CLASS_NAMES
