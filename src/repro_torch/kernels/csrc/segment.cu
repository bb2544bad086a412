// Fused segment of the megakernel engine: a run of SM-local eGPU rows
// over a wave of simulated SMs, with registers and shared memory resident
// on chip for the whole run.
//
// Replaces: src/repro/kernels/simt_step.py, simt_segment (a pallas_call
// per segment that stages executor.apply_segment_rows with the rows as
// trace-time constants).
//
// Layout: one CTA per simulated SM, 512 threads, one per eGPU thread.
// Lane is t % 16 and wavefront t / 16, so a wavefront is a half-warp.
// Dynamic shared memory holds the (16, 512) register file (register-major,
// so a row's operand reads are conflict-free), the shared-memory image and
// a store-port winner array: 32 KiB + 8 B per shared-memory word (56 KiB
// at the paper's 3072 words). Rows come from a packed (n_rows, 15) int32
// table in FIELDS order, so one compiled kernel serves every program.
//
// Per row: read phase, barrier, write phase, barrier. A snooped operand
// regs[ext*16 + lane] may be another thread's destination in the same
// row, and every row computes from the whole old state.
//
// Bound: the bytes are the state in and out once (under 1 MB for a
// four-SM wave), far below a microsecond at 3.35 TB/s, and the arithmetic
// is a few operations per thread per row. What bounds it is the serial
// chain of rows, each two block-wide barriers long (three for a store),
// on as many SMs as the wave has members. The design keeps the whole
// chain on chip: no row touches device memory except its row fields,
// which every thread reads from the same address.
#include <cstdint>
#include <cuda_runtime.h>

#include "egpu_fp32.cuh"

namespace {

constexpr int kThreads = 512, kSP = 16, kRegs = 16, kFields = 15;
enum {
  F_SEL, F_OPCODE, F_TYP, F_RD, F_RA, F_RB, F_IMM, F_X, F_EXT_A, F_EXT_B,
  F_PEN, F_PREG, F_PNEG, F_ACT_WAVES, F_ACT_WTHREADS
};
enum { OP_TDX = 13, OP_TDY = 14, OP_DOT = 15, OP_BID = 26 };

__global__ void __launch_bounds__(kThreads)
segment_kernel(const int32_t* __restrict__ rows, int n_rows,
               const int32_t* __restrict__ block_idx,
               const int32_t* __restrict__ prog_idx,
               const uint32_t* __restrict__ regs_in,
               const uint32_t* __restrict__ shmem_in,
               const uint8_t* __restrict__ oob_in,
               uint32_t* __restrict__ regs_out,
               uint32_t* __restrict__ shmem_out,
               uint8_t* __restrict__ oob_out,
               int depth, int bound, int n_threads, int dim_x) {
  extern __shared__ uint32_t smem[];
  uint32_t* regs = smem;                                  // [kRegs][kThreads]
  uint32_t* mem = smem + kRegs * kThreads;                // [depth]
  int* winner = reinterpret_cast<int*>(mem + depth);      // [depth]
  __shared__ int oob_flag;

  const int sm = blockIdx.x, t = threadIdx.x;
  const int lane = t % kSP, wave = t / kSP;
  const uint32_t* rin = regs_in + static_cast<size_t>(sm) * kThreads * kRegs;
  for (int i = t; i < kThreads * kRegs; i += kThreads)
    regs[(i % kRegs) * kThreads + i / kRegs] = rin[i];
  const uint32_t* shin = shmem_in + static_cast<size_t>(sm) * depth;
  for (int i = t; i < depth; i += kThreads) {
    mem[i] = shin[i];
    winner[i] = -1;
  }
  if (t == 0) oob_flag = oob_in[sm] ? 1 : 0;
  __syncthreads();

  for (int r = 0; r < n_rows; ++r) {
    const int32_t* f = rows + static_cast<size_t>(r) * kFields;
    const int sel = f[F_SEL], op = f[F_OPCODE], typ = f[F_TYP];
    const int rd = f[F_RD], ra = f[F_RA], rb = f[F_RB], imm = f[F_IMM];
    const bool snoop = f[F_X] == 1, pen = f[F_PEN] != 0;
    const bool active = lane < f[F_ACT_WTHREADS] && wave < f[F_ACT_WAVES]
                        && t < n_threads;
    bool psel = true;
    if (pen) psel = ((regs[f[F_PREG] * kThreads + t] & 1u) != 0u) != (f[F_PNEG] != 0);
    const bool eff = active && psel;
    const int ta = snoop ? f[F_EXT_A] * kSP + lane : t;
    const int tb = snoop ? f[F_EXT_B] * kSP + lane : t;
    const uint32_t a = regs[ra * kThreads + ta];
    const uint32_t b = regs[rb * kThreads + tb];
    const uint32_t old = regs[rd * kThreads + t];

    // ---- read phase: every value this thread will write ----
    uint32_t nv = old;
    bool wr = false;                  // this thread writes regs[rd][t]
    int st_addr = 0;
    bool st_do = false;
    switch (sel) {
      case 1:                                             // ALU
        wr = true;
        nv = eff ? egpu::alu(op, typ, a, b) : old;
        break;
      case 2:                                             // LOD
      case 3: {                                           // STO
        const int addr = static_cast<int>(a + static_cast<uint32_t>(imm));
        const bool bad = eff && (addr < 0 || addr >= bound);
        if (bad) oob_flag = 1;
        if (sel == 2) {
          wr = true;
          const int safe = addr < 0 ? 0 : (addr >= bound ? bound - 1 : addr);
          nv = (eff && !bad) ? mem[safe] : old;
        } else {
          st_do = eff && !bad;
          st_addr = addr;
          // the single write port: the highest enabled thread wins; the
          // row number keeps the winner array monotonic across rows
          if (st_do) atomicMax(&winner[addr], r * kThreads + t);
        }
        break;
      }
      case 4:                                             // LODI
        wr = true;
        if (eff) nv = typ == 2 ? __float_as_uint(static_cast<float>(imm))
                               : static_cast<uint32_t>(imm);
        break;
      case 5: {                                           // TDX/TDY/BID/PID
        wr = true;
        const uint32_t v = op == OP_TDX ? static_cast<uint32_t>(t % dim_x)
                         : op == OP_TDY ? static_cast<uint32_t>(t / dim_x)
                         : op == OP_BID ? static_cast<uint32_t>(block_idx[sm])
                                        : static_cast<uint32_t>(prog_idx[sm]);
        if (eff) nv = v;
        break;
      }
      case 6: {                                           // DOT/SUM
        const uint32_t term = egpu::fp_binop(op == OP_DOT ? 3 : 1, a, b);
        const uint32_t v = eff ? term : 0u;
        const int base = (t & 31) & ~(kSP - 1);           // half-warp's lane 0
        const unsigned en = (__ballot_sync(0xFFFFFFFFu, eff) >> base) & 0xFFFFu;
        uint32_t vals[kSP];
#pragma unroll
        for (int l = 0; l < kSP; ++l)
          vals[l] = __shfl_sync(0xFFFFFFFFu, v, base + l);
        if (lane == 0) {
          wr = true;
          uint32_t acc = 0u;          // +0.0
          if (pen && f[F_ACT_WTHREADS] >= 8) {  // lane 0 onto +0.0, then
            vals[0] = egpu::fp_add(acc, vals[0]);  // fold halves: 8, 4, 2, 1
#pragma unroll
            for (int h = kSP / 2; h >= 1; h /= 2)
#pragma unroll
              for (int l = 0; l < h; ++l) vals[l] = egpu::fp_add(vals[l], vals[l + h]);
            acc = vals[0];
          } else {                    // lane by lane from +0.0
#pragma unroll
            for (int l = 0; l < kSP; ++l) acc = egpu::fp_add(acc, vals[l]);
          }
          if (en) nv = acc;
        }
        break;
      }
      case 7:                                             // SFU (INVSQR)
        if (t == 0) {
          wr = true;
          const int src = snoop ? f[F_EXT_A] * kSP : 0;
          if (psel) nv = egpu::invsqr(regs[ra * kThreads + src]);
        }
        break;
      case 10:                                            // SETP
        wr = true;
        if (eff) nv = egpu::setp(imm, typ, a, b) ? 1u : 0u;
        break;
      case 11:                                            // SELP
        wr = true;
        if (active) nv = (!pen || psel) ? a : b;
        break;
      default:                                            // not SM-local
        break;
    }
    __syncthreads();

    // ---- write phase ----
    if (wr) regs[rd * kThreads + t] = nv;
    if (st_do && winner[st_addr] == r * kThreads + t)
      mem[st_addr] = old;                                 // old = regs[rd][t]
    __syncthreads();
  }

  uint32_t* rout = regs_out + static_cast<size_t>(sm) * kThreads * kRegs;
  for (int i = t; i < kThreads * kRegs; i += kThreads)
    rout[i] = regs[(i % kRegs) * kThreads + i / kRegs];
  uint32_t* mout = shmem_out + static_cast<size_t>(sm) * depth;
  for (int i = t; i < depth; i += kThreads) mout[i] = mem[i];
  if (t == 0) oob_out[sm] = static_cast<uint8_t>(oob_flag);
}

}  // namespace

extern "C" int egpu_segment(const int32_t* rows, int n_rows,
                            const int32_t* block_idx, const int32_t* prog_idx,
                            const int32_t* regs_in, const int32_t* shmem_in,
                            const uint8_t* oob_in, int32_t* regs_out,
                            int32_t* shmem_out, uint8_t* oob_out, int n_sms,
                            int depth, int bound, int n_threads, int dim_x,
                            void* stream) {
  const size_t smem = sizeof(uint32_t) * (kRegs * kThreads + 2 * static_cast<size_t>(depth));
  cudaError_t err = cudaFuncSetAttribute(
      segment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  segment_kernel<<<n_sms, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      rows, n_rows, block_idx, prog_idx,
      reinterpret_cast<const uint32_t*>(regs_in),
      reinterpret_cast<const uint32_t*>(shmem_in), oob_in,
      reinterpret_cast<uint32_t*>(regs_out),
      reinterpret_cast<uint32_t*>(shmem_out), oob_out, depth, bound,
      n_threads, dim_x);
  return static_cast<int>(cudaGetLastError());
}
