"""Plain PyTorch statements of the eGPU datapath arithmetic.

Every function takes and returns 32-bit architectural words stored as
``torch.int32`` tensors (any shape, any device). These are the plain
versions the CUDA kernels in ``csrc/`` are held against bit for bit, and
the CPU path of every wrapper.

FP32 follows the reference simulator's execution mode on the host CPU,
where compiled XLA code runs with denormals-are-zero and flush-to-zero
set:

  * a denormal operand reads as a zero of the same sign, and a denormal
    result is written as a zero of the same sign;
  * a NaN result is the first NaN operand made quiet, else the default
    NaN ``0xFFC00000`` (the x86 rule);
  * ADD/SUB/MUL round once each (no fused multiply-add);
  * INVSQR returns the correctly rounded ``1/sqrt(x)``.

The x86 unit detects tininess after rounding: a MUL whose exact product
lies below 2**-126 - 2**-151 is flushed even where IEEE gradual
underflow rounds it up to the smallest normal 2**-126. The flush of an
ADD or SUB needs no such test: their operands are zeros or normals after
the denormal read, so an exact sum is a multiple of 2**-149 and either
at least 2**-126 or already denormal.
"""
from __future__ import annotations

import math

import torch

# the causal mask's "minus infinity": finite, so exp(NEG_INF - m) is an
# exact 0 and a fully masked row never computes inf - inf
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

# opcode numbering shared with the kernels (subset of core.isa.Op that the
# SIMT ALU executes)
ALU_ADD, ALU_SUB, ALU_MUL = 1, 2, 3
ALU_AND, ALU_OR, ALU_XOR, ALU_NOT = 4, 5, 6, 7
ALU_LSL, ALU_LSR = 8, 9
TYP_INT32, TYP_UINT32, TYP_FP32 = 0, 1, 2

_SIGN = -(1 << 31)            # 0x80000000 as int32
_EXP = 0x7F800000
_QUIET = 0x00400000
DEFAULT_NAN = -4194304        # 0xFFC00000 as int32
_POS_INF = 0x7F800000
_NEG_INF = -8388608           # 0xFF800000 as int32
_SPLIT = 134217729.0          # 2**27 + 1: Veltkamp split of a float64
_MIN_NORMAL = 0x00800000      # 2**-126
# below this an exact product rounds, with an unbounded exponent, to a
# value under 2**-126: x86 calls it tiny and flushes it
_TINY_PRODUCT = 2.0 ** -126 - 2.0 ** -151


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an int64 tensor, as int32 (two's complement)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def u32(x: torch.Tensor) -> torch.Tensor:
    """Zero-extend int32 words to int64 (the unsigned view)."""
    return x.to(torch.int64) & 0xFFFFFFFF


def _sext16(x: torch.Tensor) -> torch.Tensor:
    low = x.to(torch.int64) & 0xFFFF
    return torch.where(low >= 0x8000, low - 0x10000, low)


def flush_denormal(x: torch.Tensor) -> torch.Tensor:
    """A word whose exponent field is zero reads as a signed zero."""
    return torch.where((x & _EXP) == 0, x & _SIGN, x)


def is_nan(x: torch.Tensor) -> torch.Tensor:
    return (x & 0x7FFFFFFF) > _EXP


def _nan_rule(a, b, r):
    return torch.where(is_nan(a), a | _QUIET,
                       torch.where(is_nan(b), b | _QUIET,
                                   torch.where(is_nan(r), DEFAULT_NAN, r)))


def _f(x):
    return x.view(torch.float32)


def fp_binop(op: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """FP32 ADD/SUB/MUL on words, in the reference's execution mode."""
    a, b = flush_denormal(a), flush_denormal(b)
    if op == ALU_ADD:
        r = _f(a) + _f(b)
    elif op == ALU_SUB:
        r = _f(a) - _f(b)
    else:
        r = _f(a) * _f(b)
    r = r.view(torch.int32)
    if op not in (ALU_ADD, ALU_SUB):
        # the product of two float32 values is exact in float64
        exact = _f(a).to(torch.float64) * _f(b).to(torch.float64)
        tiny = (r & 0x7FFFFFFF) == _MIN_NORMAL
        r = torch.where(tiny & (exact.abs() < _TINY_PRODUCT), r & _SIGN, r)
    return _nan_rule(a, b, flush_denormal(r))


def fp_add(a, b):
    return fp_binop(ALU_ADD, a, b)


def alu_ref(op: int, typ: int, a: torch.Tensor, b: torch.Tensor
            ) -> torch.Tensor:
    """eGPU SIMT ALU semantics on int32 words; ``op``/``typ`` are the
    row's host constants."""
    if typ == TYP_FP32 and op in (ALU_ADD, ALU_SUB, ALU_MUL):
        return fp_binop(op, a, b)
    if op == ALU_ADD:
        return wrap32(a.to(torch.int64) + b.to(torch.int64))
    if op == ALU_SUB:
        return wrap32(a.to(torch.int64) - b.to(torch.int64))
    if op == ALU_MUL:
        if typ == TYP_UINT32:
            return wrap32((u32(a) & 0xFFFF) * (u32(b) & 0xFFFF))
        return wrap32(_sext16(a) * _sext16(b))
    if op == ALU_AND:
        return a & b
    if op == ALU_OR:
        return a | b
    if op == ALU_XOR:
        return a ^ b
    if op == ALU_NOT:
        return ~a
    sh = u32(b) & 31
    if op == ALU_LSL:
        return wrap32(u32(a) << sh)
    return wrap32(u32(a) >> sh)                     # logical shift right


def setp_compare(cond: int, typ: int, a: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Per-lane SETP compare -> bool. FP32 compares read denormals as
    zero; ordered compares are false on NaN, so GT/GE are computed
    directly (never as ~LE/~LT); NE is ~EQ."""
    if typ == TYP_FP32:
        x, y = _f(flush_denormal(a)), _f(flush_denormal(b))
    elif typ == TYP_INT32:
        x, y = a, b
    else:
        x, y = u32(a), u32(b)
    if cond == 0:
        return x == y
    if cond == 1:
        return ~(x == y)
    if cond == 2:
        return x < y
    if cond == 3:
        return x <= y
    if cond == 4:
        return x > y
    return x >= y


def _rsqrt_vs(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Sign of ``x*m*m - 1`` computed exactly in float64 (x a float32
    value, m a 25-bit midpoint): negative means ``1/sqrt(x) > m``."""
    p = x * m                                   # exact: 24 + 25 bits
    c = p * _SPLIT
    ph = c - (c - p)
    pl = p - ph
    return (ph * m - 1.0) + pl * m              # each product exact


def invsqr(x: torch.Tensor) -> torch.Tensor:
    """INVSQR on words: the correctly rounded ``1/sqrt(x)``.

    A denormal reads as zero; ``1/sqrt(+-0) = +-inf``, a negative input
    gives the default NaN, a NaN input its quiet self, ``1/sqrt(inf) =
    +0``. A float64 estimate is moved to the correctly rounded float32
    by an exact test against the neighbouring midpoints."""
    x = flush_denormal(x)
    xd = _f(x).to(torch.float64)
    y = (1.0 / torch.sqrt(xd)).to(torch.float32)
    y = torch.where(torch.isfinite(y) & (y > 0), y, torch.ones_like(y))
    up = torch.nextafter(y, torch.full_like(y, float("inf")))
    dn = torch.nextafter(y, torch.zeros_like(y))
    yd, upd, dnd = (v.to(torch.float64) for v in (y, up, dn))
    y = torch.where(_rsqrt_vs(xd, 0.5 * (yd + upd)) < 0, up,
                    torch.where(_rsqrt_vs(xd, 0.5 * (dnd + yd)) > 0, dn, y))
    out = y.view(torch.int32)
    mag = x & 0x7FFFFFFF
    signed_inf = torch.where(x < 0, _NEG_INF, torch.full_like(x, _POS_INF))
    out = torch.where(x == _POS_INF, 0, out)
    out = torch.where((x < 0) & (mag != 0), DEFAULT_NAN, out)
    out = torch.where(mag == 0, signed_inf, out)
    return torch.where(is_nan(x), x | _QUIET, out)


def wavefront_reduce(terms: torch.Tensor, enabled: torch.Tensor,
                     pairwise: bool) -> torch.Tensor:
    """Sum each wavefront's 16 lane terms: ``(..., 32, 16)`` words ->
    ``(..., 32)``. Disabled lanes contribute +0.0.

    The order is pinned to the one the reference's compiled segment
    takes: lane by lane from +0.0 (lane 0 first), except that a
    predicated row at least 8 lanes wide (``pairwise``, and every row of
    the step engine) adds lane 0 to +0.0 and then folds the upper half
    onto the lower half (8, 4, 2, 1). Where the fold's last add flushes a
    negative denormal sum, that order keeps the -0.0."""
    v = torch.where(enabled, terms, torch.zeros_like(terms))
    acc = torch.zeros_like(v[..., 0])
    if pairwise:
        v = torch.cat([fp_add(acc, v[..., 0])[..., None], v[..., 1:]], -1)
        while v.shape[-1] > 1:
            h = v.shape[-1] // 2
            v = fp_add(v[..., :h], v[..., h:])
        return v[..., 0]
    for lane in range(v.shape[-1]):
        acc = fp_add(acc, v[..., lane])
    return acc


# ---------------------------------------------------------------------------
# the kernel layer: wavefront dot, FFT, QRD, attention
# ---------------------------------------------------------------------------

def wavefront_dot_ref(a: torch.Tensor, b: torch.Tensor, active: torch.Tensor,
                      mode: int = 0, n_sp: int = 16) -> torch.Tensor:
    """Per-wavefront reduction: ``(..., n_threads)`` float32 -> ``(...,
    n_threads // n_sp)`` float32.

    Mode 0 (DOT) sums ``a*b``, any other mode (SUM) ``a+b``, over the lanes
    where ``active`` (bool) holds; inactive lanes contribute +0.0, so a NaN
    there does not leak. Each term and each add rounds once in the
    reference's execution mode (denormals as zeros, the x86 NaN rule), and
    the lanes are summed one by one from +0.0, lane 0 first."""
    *lead, n = a.shape
    waves = n // n_sp
    words = lambda x: x.to(torch.float32).contiguous().view(torch.int32)  # noqa: E731
    terms = fp_binop(ALU_MUL if mode == 0 else ALU_ADD, words(a), words(b))
    out = wavefront_reduce(terms.reshape(*lead, waves, n_sp),
                           active.reshape(*lead, waves, n_sp), pairwise=False)
    return out.view(torch.float32)


def bitrev(n: int) -> torch.Tensor:
    """The bit-reversal permutation of ``range(n)``, n a power of two
    (int64)."""
    bits = n.bit_length() - 1
    idx = torch.arange(n)
    out = torch.zeros(n, dtype=torch.int64)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out


def fft_r2_ref(re: torch.Tensor, im: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched DFT, natural-order output, by ``torch.fft`` in complex64:
    the numeric oracle of the radix-2 kernel (tests only)."""
    y = torch.fft.fft(torch.complex(re.to(torch.float32),
                                    im.to(torch.float32)), dim=-1)
    return y.real.contiguous(), y.imag.contiguous()


def fft_r2_ref_br(re: torch.Tensor, im: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Same, in the radix-2 kernel's bit-reversed output order."""
    idx = bitrev(re.shape[-1]).to(re.device)
    rr, ri = fft_r2_ref(re, im)
    return rr[..., idx], ri[..., idx]


def mgs_qrd_ref(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched modified Gram-Schmidt QR: ``(B, n, n)`` float32 -> ``(Q,
    R)``, column by column, with one re-orthogonalisation pass.

    For column j: take it by index; project it once more on the Q columns
    found so far (``coeff``) and fold ``coeff`` into column j of R before
    the norm; normalise with INVSQR (correctly rounded, see ``invsqr``);
    then ``rrow = q_j^T res`` is row j of R and ``res -= q_j rrow``.
    Finished columns carry zero residuals, so every step is branch-free.

    Every inner product sums its products one by one from +0.0, index 0
    first, and every multiply and add rounds once: the QRD kernel keeps
    the same order, so the two are equal word for word.

    The reference selects and updates column j and row j by one-hot
    products (``x * onehot``). A non-finite factor times 0 is NaN, so
    where the factor is non-finite every entry it meets with a 0 becomes
    NaN; here a test of the factor stands for each such product: ``aj[i]``
    where row i of the residual holds a non-finite entry off column j;
    row i of the residual and of R off column j where ``corr[i]`` and
    ``coeff[i]`` are; row i of Q off column j where ``qj[i]`` is; column
    k of R off row j where ``rrow[k]`` is. Finite factors change nothing,
    as their products with 0 add nothing."""
    a = a.to(torch.float32)
    B, n, _ = a.shape
    res = a.clone()
    q = torch.zeros_like(a)
    r = torch.zeros_like(a)
    zeros = a.new_zeros((B, n))
    nan = float("nan")
    for j in range(n):
        off = torch.arange(n, device=a.device) != j
        aj = torch.where(_nonfinite(res[:, :, off]).any(-1), nan,
                         res[:, :, j])
        coeff = zeros                                   # coeff[k] = <q_k, aj>
        for i in range(n):
            coeff = coeff + q[:, i, :] * aj[:, i, None]
        corr = zeros                                    # corr = Q coeff
        for k in range(n):
            corr = corr + q[:, :, k] * coeff[:, k, None]
        aj = aj - corr
        res[:, :, j] = res[:, :, j] - corr
        res = torch.where(_nonfinite(corr)[:, :, None] & off, nan, res)
        r[:, :, j] = r[:, :, j] + coeff
        r = torch.where(_nonfinite(coeff)[:, :, None] & off, nan, r)
        nrm2 = zeros[:, 0]
        for i in range(n):
            nrm2 = nrm2 + aj[:, i] * aj[:, i]
        recip = invsqr(nrm2.contiguous().view(torch.int32)).view(torch.float32)
        qj = aj * recip[:, None]
        rrow = zeros                                    # rrow[k] = <q_j, res_k>
        for i in range(n):
            rrow = rrow + qj[:, i, None] * res[:, i, :]
        res = res - qj[:, :, None] * rrow[:, None, :]
        q[:, :, j] = q[:, :, j] + qj
        q = torch.where(_nonfinite(qj)[:, :, None] & off, nan, q)
        r[:, j, :] = r[:, j, :] + rrow
        r = torch.where(_nonfinite(rrow)[:, None, :] & off[:, None], nan, r)
    return q, r


def _nonfinite(x: torch.Tensor) -> torch.Tensor:
    return ~torch.isfinite(x)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Plain softmax attention on ``(BH, S, D)`` in float32, returned in
    q's dtype: the oracle of the flash kernel."""
    D = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(D)
    if causal:
        S = q.shape[1]
        i = torch.arange(S, device=q.device)
        s = torch.where(i[None, :] <= i[:, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", w,
                        v.to(torch.float32)).to(q.dtype)
