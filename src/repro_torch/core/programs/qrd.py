"""16x16 Modified Gram-Schmidt QR decomposition for the eGPU (paper §IV.B).

Thread mapping: 256 threads; thread t holds element A[row, col] with
row = t % 16 (its lane) and col = t // 16 (its wavefront). Each thread
keeps its *residual* element in a register (R2) for the whole
factorization — column k lives in wavefront k.

Two variants:

``qrd_asm()`` — the paper-faithful choreography (§III.D walkthrough),
iterations unrolled so the thread-snooping wavefront index can be encoded
per iteration (the X-bit register-address extensions are immediate
fields). Per iteration j:

  1. wave 0 *snoops* column j's residual out of wavefront j's registers
     (``ADD.FP32 R5, R2@j, R4@j`` with R4 kept = 0.0 — a register move
     through the FP adder), avoiding any shared-memory traffic;
  2. ``DOT {d1}``: the norm on the isolated wavefront          [1 cycle]
  3. ``INVSQR {w1,d1}``: the SFU on a single thread            [1]
  4. ``STO {w1,d1}``: THE paper highlight — the norm reciprocal
     writeback costs a SINGLE cycle instead of 256             [1]
  5. recip to wave 0 ``{w16,d1}``                              [4]
  6. q_j = a_j * recip in wave 0, stored as Q column j         [1+16]
  7. q_j broadcast to all threads through shared memory        [64]
  8. full-depth DOT: r_jk = <q_j, a_k> for every wavefront     [16]
     (finished columns have zero residuals => r_jk = 0; column j itself
     yields r_jj = ||a_j|| and projects to zero — branch-free, no thread
     divergence: the paper's point)
  9. R row j stored from lane 0 ``{w1,dfull}``                 [16]
 10. r_jk broadcast + projection a_k -= r_jk q_j               [64+16+16]

Per-iteration totals: LOD = 4+64+64 = 132, STO = 1+16+16 = 33,
DOT = 1+16 = 17, SFU = 1 — Table IV's rows, reproduced exactly; the NOP
padding demanded by the 9-cycle RAW window lands at the paper's ~15%.

``qrd_asm_loop()`` — a compact zero-overhead-loop variant (the "40
instruction" scale the paper quotes for I-MEM sizing). A loop body cannot
vary the snoop immediates, so column j is re-broadcast from shared memory
instead, and residuals are written back each iteration (a full-depth
store) — correct true-MGS numerics, more store cycles. The cycle-profile
fidelity claims attach to the unrolled variant; the loop variant shows
program-size scaling.

Shared-memory layout:
    [0   .. 256)   A, column-major (A[i,k] at 16k+i)
    [256 .. 512)   Q, column-major
    [512 .. 768)   R, row-major    (R[j,k] at 512 + 16j + k)
    [768 .. 784)   dot scratch (loop variant)
    [784]          norm reciprocal
"""
from __future__ import annotations

import numpy as np

from ..assembler import Program, assemble, auto_nop
from ..device import DeviceConfig, Kernel, LaunchResult, launch
from ..executor import run
from ..machine import SMConfig, shmem_f32

A_BASE, Q_BASE, R_BASE, DOT_BASE, RECIP = 0, 256, 512, 768, 784


def qrd_asm(pad_hazards: bool = True) -> str:
    """Paper-faithful unrolled MGS QRD (snooping + flexible ISA)."""
    chunks = [f"""
    // ---- setup: R3=lane, R12=wave, R15=tid, R2=A element, R4=0.0 ----
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
        chunks.append(f"""
    // ======== MGS iteration j={j} ========
    ADD.FP32 R5, R2@{j}, R4@{j} {{d1}}        // snoop residual col {j} into wave 0
    DOT.FP32 R6, R5, R5 {{d1}}                // ||a_{j}||^2 -> thread 0
    INVSQR.FP32 R8, R6 {{w1,d1}}              // recip = 1/||a_{j}||
    STO R8, (R0)+{RECIP} {{w1,d1}}            // single-cycle norm writeback
    LOD R8, (R0)+{RECIP} {{w16,d1}}           // recip -> wave 0 lanes
    MUL.FP32 R5, R5, R8 {{d1}}                // q_{j} in wave 0
    STO R5, (R3)+{Q_BASE + 16 * j} {{w16,d1}} // Q column {j}
    LOD R5, (R3)+{Q_BASE + 16 * j}            // q_{j}[lane] everywhere
    DOT.FP32 R9, R5, R2                       // r_{j}k -> lane 0 of wave k
    STO R9, (R12)+{R_BASE + 16 * j} {{w1,dfull}}  // R row {j}
    LOD R9, (R12)+{R_BASE + 16 * j}           // r_{j}k everywhere
    MUL.FP32 R6, R9, R5                       // r_{j}k * q_{j}[lane]
    SUB.FP32 R2, R2, R6                       // project
""")
    chunks.append("    STOP\n")
    text = "".join(chunks)
    if pad_hazards:
        text = auto_nop(text, n_threads=256)
    return text


def qrd_asm_loop(pad_hazards: bool = True) -> str:
    """Compact loop variant with residual write-back (true MGS)."""
    text = f"""
    // ---- setup ----
    LOD R1, #4                 // shift constant
    LOD R11, #1
    LOD R13, #0                // j = 0
    TDX R3                     // row (lane)
    TDY R12                    // col (wavefront)
    LSL.INT32 R15, R12, R1
    NOP
    NOP
    ADD.INT32 R15, R15, R3     // tid
    NOP
    NOP
    LOD R2, (R15)+{A_BASE}     // residual element a[row,col]
    INIT 16
mgs_top:
    LSL.INT32 R6, R13, R1      // 16j
    NOP
    NOP
    ADD.INT32 R10, R6, R3      // 16j + lane
    ADD.INT32 R14, R6, R12     // 16j + wave
    NOP
    NOP
    LOD R5, (R10)+{A_BASE}     // residual a_j[lane] everywhere (written back)
    DOT.FP32 R6, R5, R2        // s_k = <a_j, a_k> -> lane0
    STO R6, (R12)+{DOT_BASE} {{w1,dfull}}
    LOD R7, (R13)+{DOT_BASE} {{w1,d1}}      // thread0: s_j = ||a_j||^2
    INVSQR.FP32 R8, R7 {{w1,d1}}
    STO R8, (R0)+{RECIP} {{w1,d1}}          // single-cycle norm writeback
    LOD R8, (R0)+{RECIP}       // recip everywhere
    LOD R9, (R12)+{DOT_BASE}   // s_k everywhere
    MUL.FP32 R4, R5, R8        // q_j[lane] everywhere
    MUL.FP32 R9, R9, R8        // r_jk
    STO R4, (R10)+{Q_BASE} {{w16,d1}}       // Q column j (wave 0 has q too)
    STO R9, (R14)+{R_BASE} {{w1,dfull}}     // R row j
    MUL.FP32 R6, R9, R4        // r_jk * q_j[lane]
    SUB.FP32 R2, R2, R6        // project
    STO R2, (R15)+{A_BASE}     // write residual back for next broadcast
    ADD.INT32 R13, R13, R11    // j++
    LOOP mgs_top
    STOP
"""
    if pad_hazards:
        text = auto_nop(text, n_threads=256)
    return text


def qrd_program(loop: bool = False, **kw) -> Program:
    return assemble(qrd_asm_loop(**kw) if loop else qrd_asm(**kw))


def qrd_kernel(loop: bool = False) -> Kernel:
    """16x16 MGS QRD as a ``Kernel`` (256 threads, 16x16 thread space) for
    multi-program launches; pair with per-block ``qrd_shmem`` images.

    Note the unrolled variant needs ``SMConfig(imem_depth=1024)`` on the
    device; the ``loop=True`` variant fits the default 512-word I-MEM.
    """
    return Kernel(program=qrd_program(loop), block=256, dim_x=16,
                  name="qrd16")


def qrd_shmem(a: np.ndarray, depth: int = 1024) -> np.ndarray:
    if a.shape != (16, 16):
        raise ValueError("the paper's benchmark is a 16x16 matrix")
    img = np.zeros(depth, dtype=np.float32)
    img[A_BASE:A_BASE + 256] = np.asarray(a, np.float32).T.reshape(-1)  # col-major
    return img


def run_qrd(a: np.ndarray, loop: bool = False, backend: str = "cuda", **kw):
    """Run the eGPU MGS QRD on one SM (step engine); returns (Q, R,
    final_state)."""
    cfg = SMConfig(n_threads=256, dim_x=16, shmem_depth=1024,
                   imem_depth=1024, max_steps=200_000)
    state = run(cfg, qrd_program(loop, **kw), qrd_shmem(a, cfg.shmem_depth),
                backend=backend)
    mem = shmem_f32(state).cpu().numpy()
    q = mem[Q_BASE:Q_BASE + 256].reshape(16, 16).T  # col-major -> (i,k)
    r = mem[R_BASE:R_BASE + 256].reshape(16, 16)    # row-major
    return q, r, state


def run_qrd_batch(As: np.ndarray, device: DeviceConfig | None = None,
                  loop: bool = False, backend: str | None = None,
                  schedule: str | None = None,
                  **kw) -> tuple[np.ndarray, np.ndarray, LaunchResult]:
    """Batched 16x16 MGS QRD on the device layer: one matrix per block.

    ``As`` is (batch, 16, 16); each factorization runs in its own block's
    private shared memory, scheduled onto the SMs in waves. Returns
    (Q batch, R batch, LaunchResult).
    """
    As = np.asarray(As)
    batch = int(As.shape[0])
    if device is None:
        device = DeviceConfig(sm=SMConfig(shmem_depth=1024, imem_depth=1024,
                                          max_steps=200_000))
    images = np.stack([qrd_shmem(As[b], device.sm.shmem_depth)
                       for b in range(batch)])
    res = launch(device, qrd_program(loop, **kw), grid=(batch,), block=256,
                 shmem=images, dim_x=16, backend=backend,
                 schedule=schedule)
    mem = res.shmem_f32().cpu().numpy()
    q = mem[:, Q_BASE:Q_BASE + 256].reshape(batch, 16, 16).transpose(0, 2, 1)
    r = mem[:, R_BASE:R_BASE + 256].reshape(batch, 16, 16)
    return q, r, res
