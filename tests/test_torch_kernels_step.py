"""The step path's three kernels' plain versions against the JAX reference.

On this CPU the wrappers run their plain versions, which are held here
against the reference's own kernels in Pallas interpret mode:

  * ``alu_plain`` against ``simt_alu`` over every op and operand type,
    with NaN, infinite and denormal words and partial masks;
  * ``gather_plain`` / ``scatter_plain`` against ``simt_gather`` /
    ``simt_scatter``, with address collisions and disabled lanes;
  * the step engine's DOT/SUM order against the reference's step engine
    (``repro.core.device.run_wave`` on its inline backend), at widths
    16/8/4/1, predicated and not, over signed zeros;
  * FP32 MUL tininess: products around 2**-126, where x86 (the
    reference's host) detects tininess after rounding, through ``alu_ref``
    and the step and trace engines.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SMConfig as JSMConfig
from repro.core import assemble as j_assemble
from repro.core import device as j_device
from repro.core.executor import pack_imem as j_pack_imem
from repro.core import trace_engine as j_trace
from repro.core.isa import Op
from repro.kernels.ref import alu_ref as j_alu_ref
from repro.kernels.simt_alu import simt_alu as j_simt_alu
from repro.kernels.simt_step import simt_gather as j_simt_gather
from repro.kernels.simt_step import simt_scatter as j_simt_scatter
from repro_torch.core import SMConfig
from repro_torch.core import device as t_device
from repro_torch.core import trace_engine as t_trace
from repro_torch.core.executor import get_execute_backend, pack_imem
from repro_torch.kernels import build, fuzz, ref
from repro_torch.kernels.simt_alu import alu_plain, simt_alu
from repro_torch.kernels.simt_step import (gather_plain, scatter_plain,
                                           simt_gather, simt_scatter)

N_SMS = 3


def _words(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


def _operands(seed):
    """FP32 words of every kind on both operands: normal, special (signed
    zeros, infinities, NaNs), denormal, and arbitrary bits."""
    rng = np.random.default_rng(seed)
    shape = (N_SMS, 512)
    a, b = (fuzz.random_f32_words(rng, shape) for _ in range(2))
    raw = rng.random(shape) < 0.2
    a[raw] = rng.integers(0, 1 << 32, int(raw.sum()), dtype=np.uint64)
    mask = rng.random(shape) < 0.7
    old = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    return a, b, mask, old


@pytest.mark.parametrize("typ", [0, 1, 2], ids=["INT32", "UINT32", "FP32"])
@pytest.mark.parametrize("op", range(1, 10))
def test_alu_plain_matches_reference(op, typ):
    a, b, mask, old = _operands(10 * op + typ)
    got = _u32(alu_plain(op, typ, _words(a), _words(b),
                         torch.from_numpy(mask), _words(old)))
    args = (jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask),
            jnp.asarray(old))
    interp = np.asarray(j_simt_alu(jnp.int32(op), jnp.int32(typ), *args,
                                   interpret=True))
    inline = np.asarray(jax.jit(lambda a_, b_, m, o: jnp.where(
        m, j_alu_ref(jnp.int32(op), jnp.int32(typ), a_, b_), o))(*args))
    # the port equals the reference's compiled ALU on every lane
    assert np.array_equal(got, inline)
    # and the Pallas kernel in interpret mode wherever that agrees with
    # its own compiled path: interpret mode computes FP32 SUB as a + (-b),
    # which flips the sign of a NaN subtrahend on those lanes
    split = interp != inline
    assert np.array_equal(got[~split], interp[~split])
    if split.any():
        assert (op, typ) == (2, 2)
        assert (ref.is_nan(_words(b)).numpy() | ~mask)[split].all()


@pytest.mark.parametrize("depth,span", [(64, 64), (3072, 3072), (1024, 5)])
def test_gather_scatter_plain_match_pallas_interpret(depth, span):
    # ``span`` addresses shared by 512 lanes per SM: collisions
    rng = np.random.default_rng(depth + span)
    mem = rng.integers(0, 1 << 32, (N_SMS, depth),
                       dtype=np.uint64).astype(np.uint32)
    addr = rng.integers(0, span, (N_SMS, 512)).astype(np.int32)
    mask = rng.random((N_SMS, 512)) < 0.7
    vals = rng.integers(0, 1 << 32, (N_SMS, 512),
                        dtype=np.uint64).astype(np.uint32)
    want_g = np.asarray(j_simt_gather(jnp.asarray(mem), jnp.asarray(addr),
                                      jnp.asarray(mask), jnp.asarray(vals),
                                      interpret=True))
    want_s = np.asarray(j_simt_scatter(jnp.asarray(mem), jnp.asarray(addr),
                                       jnp.asarray(vals), jnp.asarray(mask),
                                       interpret=True))
    got_g = gather_plain(_words(mem), torch.from_numpy(addr),
                         torch.from_numpy(mask), _words(vals))
    got_s = scatter_plain(_words(mem), torch.from_numpy(addr), _words(vals),
                          torch.from_numpy(mask))
    assert np.array_equal(_u32(got_g), want_g)
    assert np.array_equal(_u32(got_s), want_s)


def test_scatter_never_reads_disabled_addresses():
    # disabled lanes carry addresses far outside the image: they are
    # parked, never dereferenced, and the enabled writers still resolve
    mem = torch.arange(8, dtype=torch.int32).repeat(2, 1)
    addr = torch.tensor([[3, 3, -99, 1 << 30] * 2] * 2, dtype=torch.int32)
    vals = torch.arange(16, dtype=torch.int32).view(2, 8) + 100
    do = torch.tensor([[True, True, False, False] * 2] * 2)
    out = scatter_plain(mem, addr, vals, do)
    want = mem.clone()
    want[:, 3] = vals[:, 5]                 # the highest enabled thread
    assert torch.equal(out, want)


def test_wrappers_take_the_plain_versions_on_host_tensors():
    a, b, mask, old = _operands(1)
    args = (_words(a), _words(b), torch.from_numpy(mask), _words(old))
    mem = _words(np.arange(N_SMS * 64, dtype=np.uint32).reshape(N_SMS, 64))
    addr = torch.from_numpy((a % 64).astype(np.int32))
    build.reset_launches()
    assert torch.equal(simt_alu(3, 2, *args), alu_plain(3, 2, *args))
    assert torch.equal(simt_gather(mem, addr, args[2], args[3]),
                       gather_plain(mem, addr, args[2], args[3]))
    assert torch.equal(simt_scatter(mem, addr, args[3], args[2]),
                       scatter_plain(mem, addr, args[3], args[2]))
    assert build.launches["alu"] == build.launches["gather"] \
        == build.launches["scatter"] == 0


# ---------------------------------------------------------------------------
# the step engine's DOT/SUM order
# ---------------------------------------------------------------------------

def _red_program(op, pen, width):
    guard = "@R5 " if pen else ""
    return j_assemble(f"{guard}{op}.FP32 R3, R1, R2 {{{width},dfull}}\n"
                      "STOP").words


def _red_state(seed):
    """Normal FP32 operands (products and sums stay normal), one in four
    a signed zero, and a random predicate register."""
    rng = np.random.default_rng(seed)
    regs = np.zeros((N_SMS, 512, 16), np.uint32)
    fl = (rng.standard_normal((N_SMS, 512, 2))
          * np.exp2(rng.integers(-20, 20, (N_SMS, 512, 2)))).astype(np.float32)
    zero = rng.random((N_SMS, 512)) < 0.25
    fl[:, :, 0][zero] = np.where(rng.random(int(zero.sum())) < 0.5, -0.0, 0.0)
    # whole wavefronts of signed zeros: the fold's final +0.0 shows
    fl[:, :16, :] = -0.0
    fl[:, 16:32, 0] = -0.0
    regs[:, :, 1:3] = fl.view(np.uint32)
    regs[:, :, 5] = rng.integers(0, 2, (N_SMS, 512))
    regs[:, :, 3] = rng.integers(0, 1 << 32, (N_SMS, 512), dtype=np.uint64)
    return regs


def _reference_step(words, regs):
    cfg = JSMConfig()
    lo, hi = j_pack_imem(words, cfg.imem_depth)
    st = j_device.init_device_state(cfg, N_SMS).replace(
        regs=jnp.asarray(regs))
    fin = j_device.run_wave(cfg, "inline", jnp.asarray(lo), jnp.asarray(hi),
                            jnp.zeros(N_SMS, jnp.int32),
                            jnp.zeros(N_SMS, jnp.int32), st)
    return np.asarray(fin.regs)


def _port_step(words, regs):
    cfg = SMConfig()
    lo, hi = pack_imem(words, cfg.imem_depth)
    st = t_device.init_device_state(cfg, N_SMS)
    st.regs = _words(regs)
    zero = torch.zeros(N_SMS, dtype=torch.int32)
    fin = t_device.run_wave(cfg, get_execute_backend("cpu"), lo, hi, zero,
                            zero, st)
    return _u32(fin.regs)


@pytest.mark.parametrize("op", ["DOT", "SUM"])
@pytest.mark.parametrize("pen", [0, 1])
@pytest.mark.parametrize("width", ["w16", "w8", "w4", "w1"])
def test_step_engine_dot_sum_order_is_pinned_to_reference(op, pen, width):
    regs = _red_state(100 * len(op) + 10 * pen + int(width[1:]))
    words = _red_program(op, pen, width)
    assert np.array_equal(_port_step(words, regs),
                          _reference_step(words, regs))


@pytest.mark.parametrize("op", [Op.DOT, Op.SUM], ids=["DOT", "SUM"])
def test_step_order_pin_discriminates(op):
    # the lane-by-lane order (the megakernel's) disagrees with the
    # reference's step engine on full-width rows, so the pin above is a
    # real constraint, not a tie
    regs = _red_state(7)
    want = _reference_step(_red_program(op.name, 0, "w16"), regs)[:, ::16, 3]
    a, b = (_words(regs[:, :, k]) for k in (1, 2))
    terms = ref.fp_binop(ref.ALU_MUL if op == Op.DOT else ref.ALU_ADD, a, b)
    terms = terms.reshape(N_SMS, 32, 16)
    en = torch.ones_like(terms, dtype=torch.bool)
    pinned = ref.wavefront_reduce(terms, en, pairwise=True)
    other = ref.wavefront_reduce(terms, en, pairwise=False)
    assert np.array_equal(_u32(pinned), want)
    assert (_u32(other) != want).any()


# ---------------------------------------------------------------------------
# FP32 MUL tininess
# ---------------------------------------------------------------------------

def _tiny_regs(seed):
    """R1 x R2 products around 2**-126 (``fuzz.tiny_product_words``)."""
    regs = np.zeros((N_SMS, 512, 16), np.uint32)
    regs[:, :, 1], regs[:, :, 2] = fuzz.tiny_product_words(
        np.random.default_rng(seed), (N_SMS, 512))
    return regs


@pytest.mark.parametrize("seed", [0, 1])
def test_mul_tininess_alu_matches_reference(seed):
    # 0x3F7FFFFF x 0x00800000 is 2**-126 - 2**-150 exactly: IEEE rounds it
    # up to 2**-126, x86 calls it tiny after rounding and flushes it
    regs = _tiny_regs(seed)
    a, b = regs[:, :, 1], regs[:, :, 2]
    got = _u32(ref.alu_ref(ref.ALU_MUL, ref.TYP_FP32, _words(a), _words(b)))
    want = np.asarray(jax.jit(lambda x, y: j_alu_ref(
        jnp.int32(int(Op.MUL)), jnp.int32(2), x, y))(a, b)).view(np.uint32)
    assert np.array_equal(got, want)
    assert got[0, :4].tolist() == [0, 0x80000000, 0x80000000, 0]
    ieee = (a.view(np.float32) * b.view(np.float32)).view(np.uint32)
    rounded_up = (ieee & 0x7FFFFFFF) == 0x00800000
    assert (rounded_up & ((want & 0x7FFFFFFF) == 0)).sum() >= 8
    assert (rounded_up & (want == ieee)).any()


def _reference_trace(words, regs):
    cfg = JSMConfig()
    st = j_device.init_device_state(cfg, N_SMS).replace(
        regs=jnp.asarray(regs))
    fin = j_trace.run_wave_trace(cfg, "inline",
                                 j_trace.compile_program(words, cfg),
                                 jnp.zeros(N_SMS, jnp.int32),
                                 jnp.zeros(N_SMS, jnp.int32), st)
    return np.asarray(fin.regs)


def _port_trace(words, regs):
    cfg = SMConfig()
    st = t_device.init_device_state(cfg, N_SMS)
    st.regs = _words(regs)
    zero = torch.zeros(N_SMS, dtype=torch.int32)
    fin = t_trace.run_wave_trace(cfg, get_execute_backend("cpu"),
                                 t_trace.compile_program(words, cfg), zero,
                                 zero, st)
    return _u32(fin.regs)


@pytest.mark.parametrize("engine", ["step", "trace"])
@pytest.mark.parametrize("op", ["MUL", "DOT"])
def test_mul_tininess_on_the_engines_matches_reference(engine, op):
    regs = _tiny_regs(len(op) + len(engine))
    words = j_assemble(f"{op}.FP32 R3, R1, R2 {{w16,dfull}}\nSTOP").words
    run = {"step": (_port_step, _reference_step),
           "trace": (_port_trace, _reference_trace)}[engine]
    got, want = run[0](words, regs), run[1](words, regs)
    assert np.array_equal(got, want)
    if op == "MUL":
        assert got[0, :4, 3].tolist() == [0, 0x80000000, 0x80000000, 0]


def test_step_fold_adds_lane_zero_to_plus_zero_first():
    # lane 0 + lane 8 is a negative denormal, flushed to -0.0, and every
    # other term is -0.0: the reference adds +0.0 to lane 0 before the
    # fold, so its -0.0 survives (after the fold it would read +0.0)
    regs = np.zeros((N_SMS, 512, 16), np.uint32)
    regs[:, :, 1] = 0xBF800000                      # -1 x +0 = -0
    regs[:, 0::16, 1], regs[:, 0::16, 2] = 0xBF800001, 0x00800000
    regs[:, 8::16, 1], regs[:, 8::16, 2] = 0x3F800000, 0x00800000
    words = j_assemble("DOT.FP32 R3, R1, R2 {w16,dfull}\nSTOP").words
    want = _reference_step(words, regs)
    assert (want[:, ::16, 3] == 0x80000000).all()
    assert np.array_equal(_port_step(words, regs), want)
