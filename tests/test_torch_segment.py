"""The segment kernel's barrier plan on the CPU
(``kernels.simt_step.segment_barriers``).

  * invariants over fuzzed row tables, plain and hazard-dense: every
    access of one thread that may touch another thread's word has a
    barrier between it and every conflicting access (one of the two a
    write), RAW and WAR, per register, for the image and for the store
    port's winner array; every barrier placed is the only one between some
    such pair; rows that touch only their own thread's registers get none;
  * the exact barrier counts of the FFT-64 and QRD-16 plans;
  * a skewed-order emulation of the kernel: each epoch between two
    barriers runs warp by warp (a warp is the unit, since DOT/SUM
    shuffles over one), in forward and in reverse warp order, and both
    must equal ``apply_segment_rows``; with no barriers it must not.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import SMConfig, compile_megakernel
from repro_torch.core.executor import FIELDS, apply_segment_rows
from repro_torch.core.isa import Op
from repro_torch.core.programs import qrd_program
from repro_torch.core.programs.saxpy import saxpy_grid_program
from repro_torch.core.programs.fft import fft_program
from repro_torch.kernels import fuzz, ref
from repro_torch.kernels.simt_step import (BARRIER_BEFORE_READ,
                                           BARRIER_BEFORE_WRITE,
                                           SEGMENT_CHUNK_ROWS,
                                           segment_barriers,
                                           segment_chunk_rows)

F = {name: i for i, name in enumerate(FIELDS)}


def _accesses(f):
    """The accesses a thread makes in one row of the segment kernel, as
    ``(phase, location, is_write, is_cross)``: phase 0 reads, phase 1
    writes; a cross access may touch another thread's word."""
    sel, snoop = int(f[F["sel"]]), int(f[F["x"]]) == 1
    rd, ra, rb = (("reg", int(f[F[k]])) for k in ("rd", "ra", "rb"))
    out = [(0, rd, False, False)]                     # the old destination
    if f[F["pen"]]:
        out.append((0, ("reg", int(f[F["preg"]])), False, False))
    if sel in (1, 2, 3, 6, 10, 11):
        out.append((0, ra, False, snoop))
    if sel in (1, 6, 10, 11):
        out.append((0, rb, False, snoop))
    if sel == 7:                                      # thread 0 reads
        out.append((0, ra, False, snoop and int(f[F["ext_a"]]) != 0))
    if sel == 2:
        out.append((0, "image", False, True))
    if sel == 3:                                      # claim, check, store
        out += [(0, "winner", True, True), (1, "winner", False, True),
                (1, "image", True, True)]
    if sel in (1, 2, 4, 5, 6, 7, 10, 11):
        out.append((1, rd, True, False))
    return out


def _unordered(rows, bits):
    """Conflicting access pairs of ``rows``, by the number of barriers
    between them: ``{0: [pairs with none], 1: [barrier positions that are
    the only one between some pair]}``."""
    at = np.zeros(2 * len(rows) + 1, np.int64)      # barrier before event
    for i, b in enumerate(bits):
        at[2 * i] = bool(b & BARRIER_BEFORE_READ)
        at[2 * i + 1] = bool(b & BARRIER_BEFORE_WRITE)
    cum = np.cumsum(at)
    by_loc: dict = {}
    for i, f in enumerate(rows):
        for ph, loc, w, x in _accesses(f):
            by_loc.setdefault(loc, []).append((2 * i + ph, w, x))
    out = {0: [], 1: set()}
    for events in by_loc.values():
        for j, (q, wq, xq) in enumerate(events):
            for p, wp, xp in events[:j]:
                if p == q or not (wp or wq) or not (xp or xq):
                    continue
                n = cum[q] - cum[p]                 # barriers in (p, q]
                if n == 0:
                    out[0].append((p, q))
                elif n == 1:
                    out[1].add(int(np.flatnonzero(at[p + 1:q + 1])[0]) + p + 1)
    return out


def _positions(bits):
    return {2 * i for i, b in enumerate(bits) if b & BARRIER_BEFORE_READ} \
        | {2 * i + 1 for i, b in enumerate(bits) if b & BARRIER_BEFORE_WRITE}


@pytest.mark.parametrize("hazards", [False, True], ids=["fuzz", "hazards"])
@pytest.mark.parametrize("seed", range(4))
def test_barriers_order_every_cross_thread_access(seed, hazards):
    rows = fuzz.random_rows(np.random.default_rng(seed), 300,
                            hazards=hazards)
    bits = segment_barriers(rows)
    got = _unordered(rows, bits)
    assert got[0] == [], got[0][:5]
    # as late as possible and no more: each barrier is the only one
    # between some conflicting pair
    assert got[1] == _positions(bits)
    assert bits.dtype == np.int32 and bits.shape == (300,)
    assert not (bits & ~(BARRIER_BEFORE_READ | BARRIER_BEFORE_WRITE)).any()
    if hazards:       # every STO row keeps its claim -> store barrier
        sto = rows[:, F["sel"]] == 3
        assert sto.any() and (bits[sto] & BARRIER_BEFORE_WRITE).all()


def test_thread_local_rows_get_no_barrier():
    rng = np.random.default_rng(7)
    rows = fuzz.random_rows(rng, 400, sels=(1, 4, 5, 6, 10, 11))
    rows[:, F["x"]] = 0                              # no snooping
    assert not segment_barriers(rows).any()
    alu = fuzz.random_rows(rng, 200, sels=(1,))
    alu[:, F["x"]] = 0
    assert not segment_barriers(alu).any()
    # one snooped read of a register written before it needs one barrier
    rows = alu[:2].copy()
    rows[1, F["x"]], rows[1, F["ra"]] = 1, rows[0, F["rd"]]
    assert segment_barriers(rows).tolist() == [0, BARRIER_BEFORE_READ]


def test_table_chunks_fit_shared_memory():
    # the whole table when it is short, chunks of SEGMENT_CHUNK_ROWS when
    # it is long, fewer rows where a deep image leaves little room, and
    # no launch where not one row fits
    assert segment_chunk_rows(3072, 214) == 214
    assert segment_chunk_rows(3072, 5000) == SEGMENT_CHUNK_ROWS
    assert segment_chunk_rows(64, 0) == 1
    assert segment_chunk_rows(24_000, 1000) == 119
    with pytest.raises(ValueError, match="bytes of shared memory"):
        segment_chunk_rows(25_000, 10)


def _plan(name):
    if name == "fft64":
        return compile_megakernel(fft_program(64), SMConfig(
            max_steps=200_000))
    if name == "qrd16":
        return compile_megakernel(qrd_program(), SMConfig(
            imem_depth=1024, max_steps=200_000))
    return compile_megakernel(saxpy_grid_program(4096, 512),
                              SMConfig(max_steps=10_000))


@pytest.mark.parametrize("name,n_rows,before_read,before_write", [
    ("fft64", 204, 23, 24), ("qrd16", 214, 64, 48)])
def test_plan_barrier_counts(name, n_rows, before_read, before_write):
    # one fused segment each; the kernel before this plan placed two
    # barriers per row (408 and 428)
    plan = _plan(name)
    ((kind, (start, stop)),) = plan.items
    assert kind == "fused" and stop - start == n_rows
    bits = plan.barriers[start:stop]
    assert int((bits & BARRIER_BEFORE_READ).astype(bool).sum()) == before_read
    assert int((bits & BARRIER_BEFORE_WRITE).astype(bool).sum()) \
        == before_write
    assert np.array_equal(bits, segment_barriers(plan.sched.table[start:stop]))
    assert plan.device_barriers("cpu") is plan.device_barriers("cpu")


def test_plan_barriers_per_fused_item():
    # SAXPY's fused items are split at its GLD/GST rows; each item's bits
    # are its own, and a global-port row has none
    plan = _plan("saxpy")
    fused = [p for k, p in plan.items if k == "fused"]
    assert len(fused) >= 2
    covered = np.zeros(len(plan.barriers), bool)
    for start, stop in fused:
        covered[start:stop] = True
        assert np.array_equal(plan.barriers[start:stop], segment_barriers(
            plan.sched.table[start:stop]))
    assert not plan.barriers[~covered].any()


# ---------------------------------------------------------------------------
# the kernel, emulated warp by warp between its barriers
# ---------------------------------------------------------------------------

class _Kernel:
    """The segment kernel's read and write phases over one wave, run by
    warp (32 threads, two wavefronts) on the CPU. State is shared as in
    the CTA: the register-major register file, the image, the winner
    array and the oob flags; what a thread computes in its read phase
    waits for its write phase in ``pending``."""

    def __init__(self, cfg, bidx, pidx, regs, shmem, oob, bound):
        self.cfg, self.bidx, self.pidx, self.bound = cfg, bidx, pidx, bound
        self.n = regs.shape[0]
        self.regs = regs.transpose(1, 2).clone()          # (n, 16, 512)
        self.depth = shmem.shape[1]
        self.mem = torch.cat([shmem, torch.zeros_like(shmem[:, :1])], 1)
        self.winner = torch.full((self.n, self.depth + 1), -1,
                                 dtype=torch.int64)
        self.oob = oob.clone()
        self.pending = {}

    def run(self, rows, bits, reverse: bool):
        epochs, cur = [], []
        for i, b in enumerate(bits):
            if b & BARRIER_BEFORE_READ:
                epochs.append(cur)
                cur = []
            cur.append((i, 0))
            if b & BARRIER_BEFORE_WRITE:
                epochs.append(cur)
                cur = []
            cur.append((i, 1))
        epochs.append(cur)
        warps = range(15, -1, -1) if reverse else range(16)
        for epoch in epochs:
            for w in warps:
                for i, phase in epoch:
                    if phase == 0:
                        self.pending[i, w] = self.read(i, rows[i], w)
                    else:
                        self.write(*self.pending.pop((i, w)), w)
        return (self.regs.transpose(1, 2).contiguous(),
                self.mem[:, :self.depth].contiguous(), self.oob)

    def read(self, i, f, w):
        (sel, op, typ, rd, ra, rb, imm, x, ext_a, ext_b, pen, preg, pneg,
         act_waves, act_wthreads) = (int(v) for v in f)
        n, R = self.n, self.regs
        t = torch.arange(32 * w, 32 * w + 32)
        lane = t % 16
        active = ((lane < act_wthreads) & (t // 16 < act_waves)
                  & (t < self.cfg.n_threads)).expand(n, 32)
        psel = ((R[:, preg, t] & 1) != 0) ^ bool(pneg) if pen \
            else torch.ones(n, 32, dtype=torch.bool)
        eff = active & psel
        ta = ext_a * 16 + lane if x == 1 else t
        tb = ext_b * 16 + lane if x == 1 else t
        old = R[:, rd, t]
        nv, wr, store = old.clone(), torch.ones(32, dtype=torch.bool), None
        if sel == 1:
            nv = torch.where(eff, ref.alu_ref(op, typ, R[:, ra, ta],
                                              R[:, rb, tb]), old)
        elif sel in (2, 3):
            addr = ref.wrap32(R[:, ra, ta].to(torch.int64) + imm)
            ok = eff & (addr >= 0) & (addr < self.bound)
            self.oob |= (eff & ~ok).any(dim=1)
            slot = torch.where(ok, addr, self.depth).to(torch.int64)
            if sel == 2:
                nv = torch.where(ok, self.mem.gather(1, slot), old)
            else:
                wr[:] = False
                key = (i * 512 + t).expand(n, 32)
                self.winner.scatter_reduce_(1, slot, key, reduce="amax")
                store = (ok, slot, key, old)
        elif sel == 4:
            val = int(np.float32(imm).view(np.int32)) if typ == 2 else imm
            nv = torch.where(eff, val, old)
        elif sel == 5:
            vals = {int(Op.TDX): (t % self.cfg.dim_x)[None],
                    int(Op.TDY): (t // self.cfg.dim_x)[None],
                    int(Op.BID): self.bidx[:, None]}.get(
                        op, self.pidx[:, None]).to(torch.int32)
            nv = torch.where(eff, vals.expand(n, 32), old)
        elif sel == 6:
            terms = ref.fp_binop(ref.ALU_MUL if op == int(Op.DOT)
                                 else ref.ALU_ADD, R[:, ra, ta], R[:, rb, tb])
            lane_eff = eff.reshape(n, 2, 16)
            red = ref.wavefront_reduce(terms.reshape(n, 2, 16), lane_eff,
                                       bool(pen) and act_wthreads >= 8)
            nv[:, ::16] = torch.where(lane_eff.any(dim=2), red, old[:, ::16])
            wr = lane == 0
        elif sel == 7:
            wr = t == 0
            if w == 0:
                src = ext_a * 16 if x == 1 else 0
                nv[:, 0] = torch.where(psel[:, 0], ref.invsqr(R[:, ra, src]),
                                       old[:, 0])
        elif sel == 10:
            res = ref.setp_compare(imm, typ, R[:, ra, ta], R[:, rb, tb])
            nv = torch.where(eff, res.to(torch.int32), old)
        elif sel == 11:
            a, b = R[:, ra, ta], R[:, rb, tb]
            nv = torch.where(active, torch.where(psel, a, b) if pen else a,
                             old)
        return rd, nv, wr, store

    def write(self, rd, nv, wr, store, w):
        t = torch.arange(32 * w, 32 * w + 32)
        self.regs[:, rd, t[wr]] = nv[:, wr]
        if store is not None:
            ok, slot, key, old = store
            won = ok & (self.winner.gather(1, slot) == key)
            self.mem.scatter_(1, torch.where(won, slot, self.depth), old)


def _state(rng, n, depth):
    regs, shmem = fuzz.random_state(rng, n, depth)
    return (torch.from_numpy(np.arange(n, dtype=np.int32) + 3),
            torch.from_numpy(rng.integers(0, 9, n).astype(np.int32)),
            torch.from_numpy(regs.view(np.int32)),
            torch.from_numpy(shmem.view(np.int32)),
            torch.tensor([False, True][:n]))


def _emulate(cfg, rows, bits, state, bound, reverse):
    return _Kernel(cfg, *state, bound).run(rows, bits, reverse)


@pytest.mark.parametrize("case", ["fuzz", "hazards", "fft64", "qrd16"])
def test_skewed_warp_order_matches_plain_version(case):
    rng = np.random.default_rng(11)
    cfg = SMConfig(n_threads=96, dim_x=8)
    depth, bound = 64, 60
    if case in ("fuzz", "hazards"):
        rows = fuzz.random_rows(rng, 200, n_threads=96,
                                hazards=case == "hazards")
    else:
        plan = _plan(case)
        ((_, (start, stop)),) = plan.items
        rows = plan.sched.table[start:stop]
        # the plans address up to a few thousand words
        depth = bound = 3072
    state = _state(rng, 2, depth)
    bits = segment_barriers(rows)
    want = apply_segment_rows(cfg, rows, *state, shmem_depth=bound)
    for reverse in (False, True):
        got = _emulate(cfg, rows, bits, state, bound, reverse)
        for name, g, w in zip(("regs", "shmem", "oob"), got, want):
            assert torch.equal(g, w), (name, reverse)
    if case == "hazards":
        # the emulation sees a missing barrier: with none, some order
        # differs from the plain version
        none = np.zeros_like(bits)
        assert any(not all(torch.equal(g, w) for g, w in zip(
            _emulate(cfg, rows, none, state, bound, reverse), want))
            for reverse in (False, True))
