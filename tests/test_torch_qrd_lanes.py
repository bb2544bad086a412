"""The QRD kernel's lane plan (``csrc/qrd.cu``), emulated warp by warp in
PyTorch, against ``mgs_qrd_plain`` word for word.

The emulation runs the kernel's plan on the host, one tensor element per
lane: a group of NP lanes per matrix, 32 / NP matrices to a warp; lane k
holds column k of the residual, Q and R, and lane i also row i of Q;
operands reach the other lanes of a group by shuffles (``_shfl``); nrm2,
INVSQR and qj are computed on every lane alike; the NaN rules are
lane-local tests over the broadcast vectors and warp-wide votes cut to
the group (``_vote``). Lanes past n and groups past the batch take part in
every shuffle and vote and store nothing. Every FP32 operation is one
rounded PyTorch operation, as the kernel's ``__f*_rn``.

It must equal the plain version word for word (NaNs compared as one word)
on finite input, on input with inf, -inf and NaN, on a zero column and on
input whose column norms overflow or underflow, with a non-finite matrix
beside a finite one in the same warp.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.mgs_qrd import mgs_qrd_plain

NAN = float("nan")


def _np(n: int) -> int:
    """The kernel's lane-group size for order n."""
    return 8 if n <= 8 else 16 if n <= 16 else 32


class _Warps:
    """Lane bookkeeping of W warps of lane groups of NP lanes."""

    def __init__(self, batch: int, n: int, NP: int):
        self.NP = NP
        per_warp = 32 // NP
        self.W = -(-batch // per_warp)
        lane = torch.arange(32)
        self.g = lane % NP                                  # (32,)
        self.gbase = lane - self.g
        self.gmask = ((1 << NP) - 1) << self.gbase          # (32,) int64
        self.lane = lane
        self.mat = (torch.arange(self.W)[:, None] * per_warp
                    + lane // NP)                           # (W, 32)
        self.mine = (self.mat < batch) & (self.g < n)

    def shfl(self, v: torch.Tensor, src: int) -> torch.Tensor:
        """``__shfl_sync(kWarp, v, src, NP)``: lane src of each group."""
        return v[:, self.gbase + src]

    def vote(self, p: torch.Tensor) -> torch.Tensor:
        """``__ballot_sync`` over each warp, cut to each lane's group."""
        bits = (p.long() << self.lane).sum(1, keepdim=True)  # (W, 1)
        return (bits & self.gmask) >> self.gbase            # (W, 32)


def _bit(bits: torch.Tensor, i: int) -> torch.Tensor:
    return (bits >> i & 1).bool()


def lane_plan(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(B, n, n)`` float32 -> ``(Q, R)`` by the kernel's lane plan."""
    B, n, _ = a.shape
    NP = _np(n)
    w = _Warps(B, n, NP)
    W = w.W
    padded = a.new_zeros((W * (32 // NP), NP, NP))
    padded[:B, :n, :n] = a
    # lane (w, l) loads column g of matrix mat, row by row
    res = padded[w.mat[..., None], torch.arange(NP),
                 w.g[:, None]]                              # (W, 32, NP)
    res = torch.where(w.mine[..., None], res, 0.0)
    qc, rc, qr, aj = (torch.zeros_like(res) for _ in range(4))
    bad = ~torch.isfinite(res).all(-1)                      # (W, 32)
    res_bad = w.vote(w.mine & bad) != 0
    g = w.g
    for j in range(n):
        on_j = g == j
        # 1. aj = res[:, j], NaN where row i is non-finite off column j
        for i in range(n):
            aj[..., i] = w.shfl(res[..., i], j)
        if res_bad.any():
            for i in range(n):
                v = w.vote(w.mine & ~on_j & ~torch.isfinite(res[..., i]))
                aj[..., i] = torch.where(v != 0, NAN, aj[..., i])
        # 2. coeff[g] = <q[:, g], aj>
        coeff = torch.zeros_like(res[..., 0])
        for i in range(n):
            coeff = coeff + qc[..., i] * aj[..., i]
        # 3. corr[g] = <q[g, :], coeff>; r[:, j] += coeff on lane j
        corr = torch.zeros_like(coeff)
        for k in range(n):
            c = w.shfl(coeff, k)
            corr = corr + qr[..., k] * c
            rc[..., k] = torch.where(on_j, rc[..., k] + c, rc[..., k])
        coeff_bad = w.vote(w.mine & ~torch.isfinite(coeff))
        corr_bad = w.vote(w.mine & ~torch.isfinite(corr))
        # 4. aj -= corr on every lane; res[:, j] -= corr on lane j
        for i in range(n):
            c = w.shfl(corr, i)
            aj[..., i] = aj[..., i] - c
            res[..., i] = torch.where(on_j, res[..., i] - c, res[..., i])
        for i in range(NP):
            res[..., i] = torch.where(~on_j & _bit(corr_bad, i), NAN,
                                      res[..., i])
            rc[..., i] = torch.where(~on_j & _bit(coeff_bad, i), NAN,
                                     rc[..., i])
        # 5. nrm2, INVSQR and qj on every lane alike
        nrm2 = torch.zeros_like(coeff)
        for i in range(n):
            nrm2 = nrm2 + aj[..., i] * aj[..., i]
        recip = ref.invsqr(nrm2.contiguous().view(torch.int32)).view(
            torch.float32)
        qj_g = torch.zeros_like(coeff)
        for i in range(n):
            aj[..., i] = aj[..., i] * recip
            qj_g = torch.where(g == i, aj[..., i], qj_g)
        qj_bad = w.vote(w.mine & ~torch.isfinite(qj_g))
        # 6. rrow[g] = <qj, res[:, g]>; res[:, g] -= qj rrow[g]
        rrow = torch.zeros_like(coeff)
        for i in range(n):
            rrow = rrow + aj[..., i] * res[..., i]
        for i in range(n):
            res[..., i] = res[..., i] - aj[..., i] * rrow
            bad |= ~torch.isfinite(res[..., i])
        # 7. Q in both layouts, row j of R, and their NaN rules
        for i in range(n):
            qc[..., i] = torch.where(on_j, qc[..., i] + aj[..., i],
                                     qc[..., i])
        qr[..., j] = qr[..., j] + qj_g
        rc[..., j] = rc[..., j] + rrow
        for i in range(NP):
            qc[..., i] = torch.where(~on_j & _bit(qj_bad, i), NAN,
                                     qc[..., i])
            if i != j:
                qr[..., i] = torch.where(~torch.isfinite(qj_g), NAN,
                                         qr[..., i])
                rc[..., i] = torch.where(~torch.isfinite(rrow), NAN,
                                         rc[..., i])
        res_bad = w.vote(w.mine & bad) != 0
    # lanes holding a column store it, row by row
    q, r = torch.empty_like(a), torch.empty_like(a)
    wi, li = torch.nonzero(w.mine, as_tuple=True)
    q[w.mat[wi, li], :, g[li]] = qc[wi, li, :n]
    r[w.mat[wi, li], :, g[li]] = rc[wi, li, :n]
    return q, r


def _one_nan_words(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(x), NAN, x).view(torch.int32)


def _assert_same_words(got, want):
    for gt, wt in zip(got, want):
        assert torch.equal(_one_nan_words(gt), _one_nan_words(wt))


def _inputs(kind: str, n: int, rng) -> np.ndarray:
    """Matrices of one kind; where a matrix is non-finite, the matrix
    beside it (in the same warp when NP < 32) is finite."""
    a = rng.standard_normal((64 if kind == "wild" else 13, n, n)).astype(
        np.float32)
    if kind == "non_finite":
        # an infinity, a NaN and a -inf, in either lane group of a warp
        a[1, 0, 0] = np.inf
        a[2, n - 1, n // 2] = np.nan
        a[5, min(1, n - 1), n - 1] = -np.inf
    elif kind == "zero_column":
        a[3, :, n // 2] = 0.0           # norm 0, so q_j = 0 * inf
    elif kind == "wild":
        # column scales whose norms overflow or underflow (recip 0 or
        # inf), and a sprinkle of non-finite words: partial NaN masks
        scale = rng.choice([1.0, 1e20, 1e30, 1e-25, 1e-40, 3e38],
                           size=(len(a), 1, n), p=[.5, .1, .1, .1, .1, .1])
        with np.errstate(over="ignore"):
            a = (a * scale).astype(np.float32)
        hit = rng.random(a.shape) < 0.02
        a[hit] = rng.choice([np.inf, -np.inf, np.nan], size=int(hit.sum()))
        # a finite column whose products overflow only in later columns:
        # the rows of the residual turn non-finite off the column at hand
        a[2] = rng.standard_normal((n, n))
        a[2, :, 0] = 2e38
    return a


@pytest.mark.parametrize("kind", ["finite", "non_finite", "zero_column",
                                  "wild"])
@pytest.mark.parametrize("n", [1, 5, 8, 16, 31, 32])
def test_lane_plan_matches_plain_version(n, kind):
    rng = np.random.default_rng(100 * n + len(kind))
    a = torch.from_numpy(_inputs(kind, n, rng))
    _assert_same_words(lane_plan(a), mgs_qrd_plain(a))


@pytest.mark.parametrize("n", [5, 8, 16])
@pytest.mark.parametrize("bad_slot", [0, 1])
def test_non_finite_matrix_leaves_its_warp_neighbour(n, bad_slot):
    # two matrices in one warp (NP = 8 or 16): the non-finite one in
    # either lane group; the finite one must give its plain result alone
    rng = np.random.default_rng(n + 10 * bad_slot)
    a = rng.standard_normal((2, n, n)).astype(np.float32)
    a[bad_slot, n // 2, 0] = np.nan
    a[bad_slot, 0, n - 1] = np.inf
    a = torch.from_numpy(a)
    q, r = lane_plan(a)
    _assert_same_words((q, r), mgs_qrd_plain(a))
    good = 1 - bad_slot
    assert torch.isfinite(q[good]).all() and torch.isnan(q[bad_slot]).any()
    _assert_same_words((q[good:good + 1], r[good:good + 1]),
                       mgs_qrd_plain(a[good:good + 1]))


@pytest.mark.parametrize("batch,n", [(1, 16), (3, 16), (5, 8), (1, 31)])
def test_ragged_last_warp(batch, n):
    # groups past the batch shuffle and vote with the others, store nothing
    rng = np.random.default_rng(batch * n)
    a = torch.from_numpy(rng.standard_normal((batch, n, n)).astype(
        np.float32))
    _assert_same_words(lane_plan(a), mgs_qrd_plain(a))
