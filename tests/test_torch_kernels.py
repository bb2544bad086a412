"""The port's three kernels' plain versions against the JAX reference.

On this CPU the wrappers run their plain versions, which are held here
against the reference's own paths:

  * the fused segment, handler by handler, against
    ``repro.core.executor.apply_segment_rows`` compiled as the megakernel
    compiles it (the inline backend under ``jax.jit``), with random
    operands, masks and guards, and against ``simt_segment`` in Pallas
    interpret mode;
  * the GLD/GST port against ``simt_gather_shared`` /
    ``simt_scatter_shared`` in interpret mode, with address collisions;
  * the pins: DOT/SUM summation order, INVSQR rounding, denormals, MUL
    tininess after rounding.

Each row is applied to the same starting state on its own: the reference
compiles a run of rows into one XLA computation, which contracts an FP32
MUL feeding an ADD/SUB into one fused multiply-add; the port rounds every
instruction (see ROADMAP §C), so rows are compared one at a time.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SMConfig as JSMConfig
from repro.core.executor import FusedRow as JFusedRow
from repro.core.executor import apply_segment_rows as j_apply_segment_rows
from repro.core.executor import get_execute_backend
from repro.core.trace_engine import _active_mask
from repro.kernels.simt_step import (simt_gather_shared, simt_scatter_shared,
                                     simt_segment as j_simt_segment)
from repro_torch.core import SMConfig
from repro_torch.core.executor import FIELDS
from repro_torch.kernels import fuzz, ref
from repro_torch.kernels.simt_step import (
    simt_gather_shared as t_gather, simt_scatter_shared as t_scatter,
    simt_segment as t_simt_segment)

N_SMS, DEPTH = 3, 64


def _jrow(vals, cfg):
    f = dict(zip(FIELDS, (int(v) for v in vals)))
    d = {k: np.int32(f[k]) for k in FIELDS
         if k not in ("sel", "act_waves", "act_wthreads")}
    return JFusedRow(sel=f["sel"], d=d,
                     active=_active_mask(cfg, f["act_waves"],
                                         f["act_wthreads"]),
                     act_waves=f["act_waves"],
                     act_wthreads=f["act_wthreads"])


def _words(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _state(seed, regs=None, shmem=None):
    rng = np.random.default_rng(seed)
    r, s = fuzz.random_state(rng, N_SMS, DEPTH)
    return dict(regs=r if regs is None else regs,
                shmem=s if shmem is None else shmem,
                oob=rng.random(N_SMS) < 0.3,
                bidx=rng.integers(0, 50, N_SMS).astype(np.int32),
                pidx=rng.integers(0, 5, N_SMS).astype(np.int32))


def _reference(rows, st, n_threads=512):
    """Each row applied on its own to ``st`` by the reference's compiled
    segment body; one jit for all rows."""
    cfg = JSMConfig(n_threads=n_threads, dim_x=16)
    jrows = [_jrow(r, cfg) for r in rows]
    inline = get_execute_backend("inline")
    f = jax.jit(lambda rg, sh, o, b, p: [
        j_apply_segment_rows(cfg, inline, (r,), b, p, rg, sh, o)
        for r in jrows])
    out = f(jnp.asarray(st["regs"]), jnp.asarray(st["shmem"]),
            jnp.asarray(st["oob"]), jnp.asarray(st["bidx"]),
            jnp.asarray(st["pidx"]))
    return [tuple(np.asarray(x) for x in o) for o in out]


def _port(rows, st, n_threads=512):
    cfg = SMConfig(n_threads=n_threads, dim_x=16)
    out = []
    for r in rows:
        regs, shmem, oob = t_simt_segment(
            cfg, torch.from_numpy(r[None]), _words(st["bidx"]),
            _words(st["pidx"]), _words(st["regs"]), _words(st["shmem"]),
            torch.from_numpy(st["oob"]))
        out.append((regs.numpy().view(np.uint32),
                    shmem.numpy().view(np.uint32), oob.numpy()))
    return out


def _assert_same(rows, want, got):
    for r, w, g in zip(rows, want, got):
        for name, a, b in zip(("regs", "shmem", "oob"), w, g):
            assert np.array_equal(a, b), (
                f"row {dict(zip(FIELDS, r.tolist()))}: {name} differs in "
                f"{int((a != b).sum())} words")


# ALU, LOD, STO, LODI, TDX/TDY/BID/PID, SETP, SELP over operands with NaN,
# infinite and denormal words, snooping, guards and partial masks
@pytest.mark.parametrize("sel", [1, 2, 3, 4, 5, 10, 11])
@pytest.mark.parametrize("n_threads", [512, 96])
def test_segment_handler_matches_reference(sel, n_threads):
    rng = np.random.default_rng(100 * sel + n_threads)
    rows = fuzz.random_rows(rng, 24, sels=(sel,), n_threads=n_threads)
    st = _state(sel)
    _assert_same(rows, _reference(rows, st, n_threads),
                 _port(rows, st, n_threads))


def _dot_rows(op, pen, width):
    return np.array([[6, op, 2, 3, 1, 2, 0, 0, 0, 0, pen, 5, pneg, 32,
                      width] for pneg in (0, 1)], np.int32)


def _finite_operands(seed):
    """Normal FP32 operands whose products and sums stay normal, with a
    random predicate register: DOT/SUM results that never underflow."""
    rng = np.random.default_rng(seed)
    regs = np.zeros((N_SMS, 512, 16), np.uint32)
    fl = (rng.standard_normal((N_SMS, 512, 2))
          * np.exp2(rng.integers(-20, 20, (N_SMS, 512, 2)))).astype(np.float32)
    regs[:, :, 1:3] = fl.view(np.uint32)
    regs[:, :, 5] = rng.integers(0, 2, (N_SMS, 512))
    regs[:, :, 3] = rng.integers(0, 1 << 32, (N_SMS, 512), dtype=np.uint64)
    return _state(seed, regs=regs)


@pytest.mark.parametrize("op", [15, 16], ids=["DOT", "SUM"])
@pytest.mark.parametrize("pen", [0, 1])
@pytest.mark.parametrize("width", [16, 8, 4, 1])
def test_dot_sum_order_is_pinned_to_reference(op, pen, width):
    rows = _dot_rows(op, pen, width)
    st = _finite_operands(10 * width + pen)
    _assert_same(rows, _reference(rows, st), _port(rows, st))


@pytest.mark.parametrize("pen", [0, 1])
def test_dot_order_pin_discriminates(pen):
    # the other order disagrees with the reference on full-width rows, so
    # the pin above is a real constraint, not a tie
    st = _finite_operands(7)
    want = _reference(_dot_rows(15, pen, 16), st)[0][0][:, ::16, 3]
    a, b = (_words(st["regs"][:, :, k]) for k in (1, 2))
    terms = ref.fp_binop(ref.ALU_MUL, a, b).reshape(N_SMS, 32, 16)
    en = torch.ones_like(terms, dtype=torch.bool)
    if pen:
        en = _words(st["regs"][:, :, 5]).reshape(N_SMS, 32, 16) != 0
    other = ref.wavefront_reduce(terms, en, pairwise=not pen)
    pinned = ref.wavefront_reduce(terms, en, pairwise=bool(pen))
    keep = en.any(-1).numpy()
    assert np.array_equal(pinned.numpy().view(np.uint32)[keep], want[keep])
    assert (other.numpy().view(np.uint32)[keep] != want[keep]).any()


def _ulps(a, b):
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def test_invsqr_is_correctly_rounded_and_within_one_ulp_of_reference():
    rng = np.random.default_rng(3)
    x = (np.abs(rng.standard_normal(200_000))
         * np.exp2(rng.integers(-120, 120, 200_000))).astype(np.float32)
    x = x[np.isfinite(x) & (x >= np.finfo(np.float32).tiny)]
    got = ref.invsqr(_words(x)).numpy().view(np.float32)
    # correctly rounded: no float32 neighbour is nearer to 1/sqrt(x)
    exact = 1 / np.sqrt(x.astype(np.longdouble))
    err = np.abs(got.astype(np.longdouble) - exact)
    for nb in (np.nextafter(got, np.inf), np.nextafter(got, 0)):
        assert (err <= np.abs(nb.astype(np.longdouble) - exact)).all()
    # the reference's rsqrt is a hardware estimate refined twice: within
    # one ulp of the correctly rounded value, equal on most inputs
    want = np.asarray(jax.jit(jax.lax.rsqrt)(x))
    d = _ulps(got, want)
    assert d.max() <= 1 and (d == 0).mean() > 0.8
    # exact squares and every special agree bit for bit
    special = np.array([0x00000000, 0x80000000, 0x7F800000, 0xFF800000,
                        0x7FC00000, 0x7F800001, 0xFFC00000, 0x00000001,
                        0x807FFFFF, 0xBF800000], np.uint32).view(np.float32)
    sq = np.exp2(np.arange(-126, 128, 2)).astype(np.float32)
    for v in (special, sq):
        got = ref.invsqr(_words(v)).numpy().view(np.uint32)
        assert np.array_equal(got, np.asarray(
            jax.jit(jax.lax.rsqrt)(v)).view(np.uint32))


def test_invsqr_row_matches_reference_within_one_ulp():
    rng = np.random.default_rng(17)
    rows = fuzz.random_rows(rng, 24, sels=(7,))
    st = _state(7)
    for r, w, g in zip(rows, _reference(rows, st), _port(rows, st)):
        rd = int(r[FIELDS.index("rd")])
        mask = np.zeros_like(w[0], bool)
        mask[:, 0, rd] = True
        assert np.array_equal(w[0][~mask], g[0][~mask])
        assert np.array_equal(w[1], g[1]) and np.array_equal(w[2], g[2])
        assert _ulps(w[0][mask], g[0][mask]).max() <= 1


@pytest.mark.parametrize("op", [1, 2, 3, 28], ids=["ADD", "SUB", "MUL", "SETP"])
def test_denormal_operands_follow_reference_mode(op):
    # operands are denormals, the smallest normals and small normals whose
    # products and differences underflow: the reference flushes both ways
    rng = np.random.default_rng(op)
    n = N_SMS * 512 * 2
    pool = np.concatenate([
        rng.integers(1, 1 << 23, n) | (rng.integers(0, 2, n) << 31),
        rng.integers(0x00800000, 0x01000000, n) | (rng.integers(0, 2, n) << 31),
        np.full(n, 0x3F800000), np.full(n, 0x1F800000)]).astype(np.uint32)
    regs = np.zeros((N_SMS, 512, 16), np.uint32)
    regs[:, :, 1:3] = rng.choice(pool, (N_SMS, 512, 2))
    st = _state(op, regs=regs)
    sel = 10 if op == 28 else 1
    rows = np.array([[sel, op, 2, 3, 1, 2, cond, 0, 0, 0, 0, 0, 0, 32, 16]
                     for cond in (range(6) if op == 28 else [0])], np.int32)
    _assert_same(rows, _reference(rows, st), _port(rows, st))


@pytest.mark.parametrize("op", [3, 15], ids=["MUL", "DOT"])
def test_mul_tininess_follows_reference_mode(op):
    # products around 2**-126: x86 flushes an exact product below
    # 2**-126 - 2**-151 that IEEE rounds up to 2**-126
    regs = np.zeros((N_SMS, 512, 16), np.uint32)
    regs[:, :, 1], regs[:, :, 2] = fuzz.tiny_product_words(
        np.random.default_rng(op), (N_SMS, 512))
    st = _state(op, regs=regs)
    rows = np.array([[1 if op == 3 else 6, op, 2, 3, 1, 2, 0, 0, 0, 0, 0, 0,
                      0, 32, 16]], np.int32)
    want, got = _reference(rows, st), _port(rows, st)
    _assert_same(rows, want, got)
    if op == 3:
        assert got[0][0][0, :4, 3].tolist() == [0, 0x80000000, 0x80000000, 0]


def test_pairwise_fold_adds_lane_zero_to_plus_zero_first():
    # a predicated 16-lane DOT whose lane 0 + lane 8 flushes to -0.0 and
    # whose other terms are -0.0: -0.0 in the reference's segment too
    regs = np.zeros((N_SMS, 512, 16), np.uint32)
    regs[:, :, 1] = 0xBF800000                      # -1 x +0 = -0
    regs[:, 0::16, 1], regs[:, 0::16, 2] = 0xBF800001, 0x00800000
    regs[:, 8::16, 1], regs[:, 8::16, 2] = 0x3F800000, 0x00800000
    regs[:, :, 5] = 1
    st = _state(15, regs=regs)
    rows = np.array([[6, 15, 2, 3, 1, 2, 0, 0, 0, 0, 1, 5, 0, 32, 16]],
                    np.int32)
    want = _reference(rows, st)
    assert (want[0][0][:, ::16, 3] == 0x80000000).all()
    _assert_same(rows, want, _port(rows, st))


@pytest.mark.parametrize("sel", [1, 2, 3, 4, 5, 6, 7, 10, 11])
def test_segment_matches_pallas_interpret(sel):
    # where the reference's Pallas kernel (interpret mode) and its inline
    # path agree on a row, the port agrees with both
    cfg = JSMConfig(n_threads=512, dim_x=16)
    rng = np.random.default_rng(sel)
    rows = fuzz.random_rows(rng, 2, sels=(sel,))
    st = _finite_operands(sel) if sel in (6, 7) else _state(sel)
    inline = _reference(rows, st)
    agreed = 0
    for r, w, g in zip(rows, inline, _port(rows, st)):
        out = j_simt_segment(cfg, (_jrow(r, cfg),), jnp.asarray(st["bidx"]),
                             jnp.asarray(st["pidx"]),
                             jnp.asarray(st["regs"]),
                             jnp.asarray(st["shmem"]),
                             jnp.asarray(st["oob"]), interpret=True)
        p = tuple(np.asarray(x) for x in out)
        if all(np.array_equal(a, b) for a, b in zip(p, w)):
            agreed += 1
            assert all(np.array_equal(a, b) for a, b in zip(p, g))
    assert agreed >= 1


@pytest.mark.parametrize("span", [300, 17, 2])
def test_gmem_port_matches_pallas_interpret(span):
    # collisions: ``span`` addresses shared by 2048 lanes
    rng = np.random.default_rng(span)
    gmem = rng.integers(0, 1 << 32, 300, dtype=np.uint64).astype(np.uint32)
    addr = rng.integers(0, span, (4, 512)).astype(np.int32)
    mask = rng.random((4, 512)) < 0.7
    vals = rng.integers(0, 1 << 32, (4, 512), dtype=np.uint64).astype(
        np.uint32)
    want_g = np.asarray(simt_gather_shared(
        jnp.asarray(gmem), jnp.asarray(addr), jnp.asarray(mask),
        jnp.asarray(vals), interpret=True))
    want_s = np.asarray(simt_scatter_shared(
        jnp.asarray(gmem), jnp.asarray(addr), jnp.asarray(vals),
        jnp.asarray(mask), interpret=True))
    args = (_words(gmem), torch.from_numpy(addr))
    got_g = t_gather(*args, torch.from_numpy(mask), _words(vals))
    got_s = t_scatter(*args, _words(vals), torch.from_numpy(mask))
    assert np.array_equal(got_g.numpy().view(np.uint32), want_g)
    assert np.array_equal(got_s.numpy().view(np.uint32), want_s)
