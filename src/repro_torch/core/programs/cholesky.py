"""16x16 predicated Cholesky factorization + triangular solve.

The paper's motivating domain is small dense linear algebra for MIMO
receivers — least-squares solves over normal equations ``A = G^H G``.
Unlike QRD/FFT, a pivoted Cholesky is *branchy*: each step divides by the
current diagonal pivot, and a semi-definite input (rank-deficient
normal-equations matrix) must SKIP the column instead of dividing by
zero. On the eGPU that data-dependent decision cannot steer the scalar
sequencer (the instruction stream is static); it runs as SIMT
*predication* instead:

  * ``SETP.GT.FP32 {w1,d1}`` tests the pivot on thread 0, and the SFU
    reciprocal-sqrt runs under that guard (``@Rp INVSQR``) over a zeroed
    default — a skipped pivot yields ``inv = 0`` and the whole column
    folds to zero through ordinary arithmetic;
  * ``SETP.GE.INT32`` builds the *triangular* lane mask ``row >= j``, and
    the L-column writebacks are masked stores (``@Rp STO {w16,d1}``) —
    lanes above the diagonal never touch shared memory, which is what
    keeps L exactly lower-triangular without a second pass.

Thread mapping mirrors the QRD benchmark: 256 threads, thread t holds
residual element ``A[row, col]`` (row = t % 16 = lane, col = t // 16 =
wavefront) in R2 for the whole factorization. Per unrolled iteration j
(right-looking outer-product form):

  1. wave 0 snoops residual column j out of wavefront j's registers;
  2. the raw column is mask-stored to L (lanes >= j), landing the pivot
     ``d = A[j,j]`` where thread 0 can read it back;
  3. thread 0: ``inv = d > 0 ? 1/sqrt(d) : 0`` (predicated SFU), recorded
     to the recip table with the paper's single-cycle ``STO {w1,d1}``;
  4. wave 0 scales the column and mask-stores L[:,j] = a_j * inv;
  5. every thread rank-1-updates its residual:
     ``A[i,k] -= L[i,j] * L[k,j]`` (two shared-memory broadcasts, one
     indexed by lane, one by wavefront). Skipped columns make this a
     no-op, so the residual of a PSD input is left intact for inspection.

The optional solve stage forward-substitutes ``L y = b`` (the first
triangular solve of an LS solve; the back-substitution has the same
shape) reusing the recip table: ``y_j = b_res[j] * inv_j`` — a skipped
pivot contributes ``y_j = 0``, the minimum-norm convention.

Shared-memory layout:
    [0   .. 256)   A, column-major (A[i,k] at 16k+i)
    [256 .. 512)   L, column-major (zero-initialized; masked stores keep
                   the strict upper triangle zero)
    [512 .. 528)   b / residual b (solve stage)
    [528 .. 544)   y (solve stage)
    [544 .. 560)   recip table: inv_j = d_j > 0 ? 1/sqrt(d_j) : 0
"""
from __future__ import annotations

import numpy as np

from ..assembler import Program, assemble, auto_nop
from ..device import DeviceConfig, Kernel, LaunchResult, launch
from ..executor import run
from ..machine import SMConfig, shmem_f32

A_BASE, L_BASE, B_BASE, Y_BASE, RECIPS = 0, 256, 512, 528, 544


def cholesky_asm(solve: bool = True, pad_hazards: bool = True) -> str:
    """Unrolled predicated Cholesky (+ forward substitution)."""
    chunks = [f"""
    // ---- setup: R3=lane(row), R12=wave(col), R15=tid, R2=A element ----
    LOD R1, #4
    TDX R3
    TDY R12
    LSL.INT32 R15, R12, R1
    NOP
    NOP
    ADD.INT32 R15, R15, R3
    NOP
    NOP
    LOD R2, (R15)+{A_BASE}
"""]
    for j in range(16):
        col = L_BASE + 16 * j
        chunks.append(f"""
    // ======== Cholesky iteration j={j} ========
    LOD R13, #{j}
    ADD.FP32 R5, R2@{j}, R0@{j} {{d1}}      // wave 0: residual col {j}
    SETP.GE.INT32 R11, R3, R13              // triangular mask: row >= {j}
    @R11 STO R5, (R3)+{col} {{w16,d1}}      // stage col (masked: upper tri
                                            // lanes write NOTHING)
    LOD R6, (R0)+{col + j} {{w1,d1}}        // thread 0: pivot d = A[{j},{j}]
    LOD.FP32 R8, #0 {{w1,d1}}               // default inv = 0 (skip case)
    SETP.GT.FP32 R10, R6, R0 {{w1,d1}}      // pivot guard: d > 0 ?
    @R10 INVSQR.FP32 R8, R6 {{w1,d1}}       // predicated SFU
    STO R8, (R0)+{RECIPS + j} {{w1,d1}}     // single-cycle recip writeback
    LOD R8, (R0)+{RECIPS + j} {{w16,d1}}    // recip -> wave 0 lanes
    MUL.FP32 R5, R5, R8 {{d1}}              // L column {j} in wave 0
    @R11 STO R5, (R3)+{col} {{w16,d1}}      // masked L writeback
    LOD R5, (R3)+{col}                      // L[lane,{j}] everywhere
    LOD R9, (R12)+{col}                     // L[wave,{j}] everywhere
    MUL.FP32 R9, R9, R5                     // L[i,{j}] * L[k,{j}]
    SUB.FP32 R2, R2, R9                     // rank-1 residual update
""")
    if solve:
        for j in range(16):
            col = L_BASE + 16 * j
            chunks.append(f"""
    // ---- forward substitution step j={j}: y_{j} = b_res[{j}] * inv_{j} ----
    LOD R6, (R0)+{B_BASE + j} {{w1,d1}}
    LOD R8, (R0)+{RECIPS + j} {{w1,d1}}
    MUL.FP32 R6, R6, R8 {{w1,d1}}           // skipped pivot -> y_{j} = 0
    STO R6, (R0)+{Y_BASE + j} {{w1,d1}}
    LOD R7, (R0)+{Y_BASE + j} {{w16,d1}}    // broadcast y_{j} to wave 0
    LOD R5, (R3)+{col} {{w16,d1}}           // L[lane,{j}]
    MUL.FP32 R5, R5, R7 {{w16,d1}}
    LOD R9, (R3)+{B_BASE} {{w16,d1}}
    SUB.FP32 R9, R9, R5 {{w16,d1}}
    STO R9, (R3)+{B_BASE} {{w16,d1}}        // b_res -= L[:,{j}] * y_{j}
""")
    chunks.append("    STOP\n")
    text = "".join(chunks)
    if pad_hazards:
        text = auto_nop(text, n_threads=256)
    return text


def cholesky_program(solve: bool = True, **kw) -> Program:
    return assemble(cholesky_asm(solve, **kw))


def cholesky_imem_depth(solve: bool = True) -> int:
    """I-MEM depth the unrolled program needs: the factor stage fits the
    QRD-class 1024-word I-MEM (2 M20K); the solve stage's serial
    single-thread substitution chain NOP-pads past it (4 M20K)."""
    return 2048 if solve else 1024


def cholesky_kernel(solve: bool = True) -> Kernel:
    """Predicated Cholesky as a ``Kernel`` (256 threads, 16x16 thread
    space). Needs ``SMConfig(imem_depth=cholesky_imem_depth(solve),
    shmem_depth=1024)``."""
    return Kernel(program=cholesky_program(solve), block=256, dim_x=16,
                  name="cholesky16")


def cholesky_shmem(a: np.ndarray, b: np.ndarray | None = None,
                   depth: int = 1024) -> np.ndarray:
    if a.shape != (16, 16):
        raise ValueError("the kernel factors a 16x16 matrix")
    img = np.zeros(depth, dtype=np.float32)
    img[A_BASE:A_BASE + 256] = np.asarray(a, np.float32).T.reshape(-1)
    if b is not None:
        img[B_BASE:B_BASE + 16] = np.asarray(b, np.float32).reshape(16)
    return img


def _unpack(mem: np.ndarray):
    el = mem[L_BASE:L_BASE + 256].reshape(16, 16).T   # col-major -> (i,j)
    y = mem[Y_BASE:Y_BASE + 16]
    return el, y


def run_cholesky(a: np.ndarray, b: np.ndarray | None = None,
                 backend: str = "cuda", **kw):
    """Factor ``a`` (and forward-solve ``L y = b``) on one SM (step
    engine).

    Returns (L, y, final_state); ``y`` is zeros when ``b`` is None.
    Positive-definite ``a`` gives ``L @ L.T == a``; a PSD input with an
    exactly-singular leading structure (zero row/column) skips that pivot,
    zeroing the L column and leaving its residual untouched.
    """
    solve = kw.pop("solve", b is not None)
    cfg = SMConfig(n_threads=256, dim_x=16, shmem_depth=1024,
                   imem_depth=cholesky_imem_depth(solve),
                   max_steps=200_000)
    state = run(cfg, cholesky_program(solve=solve, **kw),
                cholesky_shmem(a, b, cfg.shmem_depth), backend=backend)
    el, y = _unpack(shmem_f32(state).cpu().numpy())
    return el, y, state


def run_cholesky_batch(As: np.ndarray, bs: np.ndarray | None = None,
                       device: DeviceConfig | None = None,
                       backend: str | None = None,
                       schedule: str | None = None,
                       **kw) -> tuple[np.ndarray, np.ndarray, LaunchResult]:
    """Batched predicated Cholesky/LS on the device layer: one matrix
    (and optional right-hand side) per block. Returns (L batch, y batch,
    LaunchResult)."""
    As = np.asarray(As)
    batch = int(As.shape[0])
    solve = kw.pop("solve", bs is not None)
    if device is None:
        device = DeviceConfig(sm=SMConfig(
            shmem_depth=1024, imem_depth=cholesky_imem_depth(solve),
            max_steps=200_000))
    images = np.stack([
        cholesky_shmem(As[i], None if bs is None else bs[i],
                       device.sm.shmem_depth)
        for i in range(batch)])
    res = launch(device, cholesky_program(solve=solve, **kw),
                 grid=(batch,), block=256, shmem=images, dim_x=16,
                 backend=backend, schedule=schedule)
    mem = res.shmem_f32().cpu().numpy()
    el = mem[:, L_BASE:L_BASE + 256].reshape(batch, 16, 16) \
        .transpose(0, 2, 1)
    y = mem[:, Y_BASE:Y_BASE + 16]
    return el, y, res
