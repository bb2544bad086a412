"""Radix-2 decimation-in-frequency FFT for the eGPU (paper §IV.A).

One butterfly per thread (paper: "we map each butterfly to its own
thread"), so an N-point FFT uses N/2 threads: 16 (one wavefront) for N=32,
128 (eight wavefronts) for N=256.

Shared-memory layout (32-bit words):
    [0 .. 2N)      interleaved complex data (re, im per point)
    [2N .. 3N)     interleaved twiddles W_N^k = exp(-2*pi*i*k/N), k < N/2

Addressing reproduces the paper's listing: per pass with half-span H,
    upper = tid & maskhi        (block bits;   maskhi = ~(H-1))
    pos   = tid & masklo        (in-block pos; masklo =  H-1 )
    a     = pos + (upper << 1)  (first butterfly input index)
    addrA = 2*a                 (interleaved complex)
    addrB = addrA + 2*H
    twid  = pos << (pass+1)     (+ 2N base, via the LOD offset field)
The per-pass NOP in the address chain is the RAW hazard the paper calls
out ("we handle [it] by inserting a NOP"). DIF output is in bit-reversed
order; ``run_fft_batch`` undoes the permutation on the host.

Register map: R0=0, R1=tid, R2=addrA, R3=maskhi, R4=masklo, R5=1,
R9=twiddle shift, R10=2H, R11=addrB, R12=twiddle offset,
R6/R7/R8/R13/R14/R15 data & temps.
"""
from __future__ import annotations

import numpy as np

from ..assembler import Program, assemble
from ..device import DeviceConfig, Kernel, LaunchResult, launch
from ..executor import run
from ..machine import SMConfig, shmem_f32


def _butterfly_block(tw_base: int) -> str:
    return f"""
    // butterfly: u = a+b -> A;  v = (a-b)*W -> B
    LOD R6, (R2)+0            // a_re
    LOD R7, (R2)+1            // a_im
    LOD R13, (R11)+0          // b_re
    LOD R14, (R11)+1          // b_im
    ADD.FP32 R8, R6, R13      // u_re
    SUB.FP32 R6, R6, R13      // t_re
    STO R8, (R2)+0
    ADD.FP32 R8, R7, R14      // u_im
    SUB.FP32 R7, R7, R14      // t_im
    STO R8, (R2)+1
    LOD R13, (R12)+{tw_base}      // w_re
    LOD R14, (R12)+{tw_base + 1}  // w_im
    MUL.FP32 R8, R6, R13      // t_re*w_re
    MUL.FP32 R15, R7, R14     // t_im*w_im
    SUB.FP32 R8, R8, R15      // v_re
    STO R8, (R11)+0
    MUL.FP32 R8, R6, R14      // t_re*w_im
    MUL.FP32 R15, R7, R13     // t_im*w_re
    ADD.FP32 R8, R8, R15      // v_im
    STO R8, (R11)+1
"""


def _addr_block(nops_addr: int) -> str:
    nops = "\n".join(["    NOP"] * nops_addr)
    return f"""
    // per-thread butterfly addressing (paper's listing, generalized)
    AND.INT32 R6, R1, R3      // upper = tid & maskhi
    AND.INT32 R7, R1, R4      // pos   = tid & masklo
    LSL.INT32 R8, R6, R5      // upper << 1
{nops}
    ADD.INT32 R6, R7, R8      // a = pos + (upper<<1)
    NOP                        // the paper's RAW-hazard NOP
    ADD.INT32 R2, R6, R6      // addrA = 2a (interleaved complex)
    LSL.INT32 R12, R7, R9     // twiddle offset = pos << (pass+1)
    ADD.INT32 R11, R2, R10    // addrB = addrA + 2H
"""


def fft_asm(n: int, unroll: bool = False, pad_hazards: bool = True) -> str:
    """Generate eGPU assembly for an n-point radix-2 DIF FFT.

    ``unroll=False``: compact zero-overhead-loop version (~45 words) —
    per-pass constants derived with shifts/XOR.
    ``unroll=True``: the paper's style — eight unrolled passes, per-pass
    constants from immediate loads, the butterfly as a JSR subroutine
    (program size lands at the paper's "135 instructions" scale).
    """
    if n & (n - 1) or n < 4:
        raise ValueError("n must be a power of two >= 4")
    log2n = n.bit_length() - 1
    n_threads = n // 2
    tw_base = 2 * n
    setup = f"""
    // ---- setup ----
    TDX R1                    // tid (one butterfly per thread)
    LOD R3, #0                // maskhi (pass 0: single block)
    LOD R4, #{n // 2 - 1}     // masklo = H-1
    LOD R5, #1
    LOD R9, #1                // twiddle shift = pass+1
    LOD R10, #{n}             // 2H
"""
    body = _addr_block(1) + _butterfly_block(tw_base)
    if not unroll:
        update = """
    // ---- next pass constants ----
    LSR.INT32 R8, R4, R5      // masklo >> 1
    XOR.INT32 R7, R4, R8      // the bit that moved out
    OR.INT32  R3, R3, R7      // maskhi |= bit
    OR.INT32  R4, R8, R0      // masklo = shifted
    ADD.INT32 R9, R9, R5      // twiddle shift += 1
    LSR.INT32 R10, R10, R5    // 2H >>= 1
"""
        text = setup + f"    INIT {log2n}\npass_top:\n" + body + update \
            + "    LOOP pass_top\n    STOP\n"
    else:
        chunks = [setup]
        for p in range(log2n):
            h = n // 2 >> p
            maskhi = (~(h - 1)) & (n // 2 - 1)
            chunks.append(f"""
    // ---- pass {p} (H={h}) ----
    LOD R3, #{maskhi}
    LOD R4, #{h - 1}
    LOD R9, #{p + 1}
    LOD R10, #{2 * h}
""")
            chunks.append(_addr_block(1))
            chunks.append("    JSR butterfly\n")
        chunks.append("    STOP\nbutterfly:\n")
        chunks.append(_butterfly_block(tw_base))
        chunks.append("    RTS\n")
        text = "".join(chunks)
    if pad_hazards:
        from ..assembler import auto_nop

        text = auto_nop(text, n_threads)
    return text


def fft_program(n: int, unroll: bool = False, pad_hazards: bool = True) -> Program:
    return assemble(fft_asm(n, unroll, pad_hazards))


def fft_kernel(n: int, unroll: bool = False) -> Kernel:
    """n-point FFT as a ``Kernel`` (block of n/2 butterfly threads) for
    multi-program launches; pair with per-block ``fft_shmem`` images."""
    return Kernel(program=fft_program(n, unroll), block=n // 2,
                  name=f"fft{n}")


def bitrev_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    out = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out


def fft_shmem(x: np.ndarray, depth: int = 3072) -> np.ndarray:
    """Build the shared-memory image: interleaved data + twiddle table."""
    n = x.shape[0]
    img = np.zeros(depth, dtype=np.float32)
    img[0:2 * n:2] = np.real(x).astype(np.float32)
    img[1:2 * n:2] = np.imag(x).astype(np.float32)
    k = np.arange(n // 2)
    w = np.exp(-2j * np.pi * k / n)
    img[2 * n:3 * n:2] = np.real(w).astype(np.float32)
    img[2 * n + 1:3 * n:2] = np.imag(w).astype(np.float32)
    return img


def run_fft(x: np.ndarray, unroll: bool = False, pad_hazards: bool = True,
            backend: str = "cuda"):
    """Run the eGPU FFT on one SM (step engine); returns (X, final_state)."""
    n = int(x.shape[0])
    n_threads = n // 2
    cfg = SMConfig(n_threads=n_threads, dim_x=n_threads,
                   shmem_depth=max(3 * n, 64), max_steps=200_000)
    prog = fft_program(n, unroll, pad_hazards)
    state = run(cfg, prog, fft_shmem(x, cfg.shmem_depth), backend=backend)
    mem = shmem_f32(state).cpu().numpy()
    out_br = mem[0:2 * n:2] + 1j * mem[1:2 * n:2]
    out = np.empty(n, dtype=np.complex64)
    out[bitrev_indices(n)] = out_br  # undo DIF bit-reversal
    return out, state


def run_fft_batch(xs: np.ndarray, device: DeviceConfig | None = None,
                  unroll: bool = False, backend: str | None = None,
                  schedule: str | None = None
                  ) -> tuple[np.ndarray, LaunchResult]:
    """Batched FFT on the device layer: one n-point FFT per thread block.

    ``xs`` is (batch, n) complex; each signal becomes one block's private
    shared-memory image and the grid is scheduled onto the device's SMs in
    waves — the §III.E packed-sector deployment (four independent FFTs per
    sector) generalized to any batch. Returns (X batch, LaunchResult).
    """
    xs = np.asarray(xs)
    batch, n = int(xs.shape[0]), int(xs.shape[1])
    n_threads = n // 2
    if device is None:
        device = DeviceConfig(sm=SMConfig(shmem_depth=max(3 * n, 64),
                                          max_steps=200_000))
    prog = fft_program(n, unroll)
    images = np.stack([fft_shmem(xs[b], device.sm.shmem_depth)
                       for b in range(batch)])
    res = launch(device, prog, grid=(batch,), block=n_threads,
                 shmem=images, backend=backend, schedule=schedule)
    mem = res.shmem_f32().cpu().numpy()
    out_br = mem[:, 0:2 * n:2] + 1j * mem[:, 1:2 * n:2]
    out = np.empty((batch, n), dtype=np.complex64)
    out[:, bitrev_indices(n)] = out_br
    return out, res
