// Fused segment of the megakernel engine: a run of SM-local eGPU rows
// over a wave of simulated SMs, with registers, shared memory and the row
// table resident on chip for the whole run.
//
// Replaces: src/repro/kernels/simt_step.py, simt_segment (a pallas_call
// per segment that stages executor.apply_segment_rows with the rows as
// trace-time constants).
//
// Layout: one CTA per simulated SM, 512 threads, one per eGPU thread.
// Lane is t % 16 and wavefront t / 16, so a wavefront is a half-warp.
// Dynamic shared memory holds the row table (up to `chunk` rows of 16
// words: the 15 fields in FIELDS order, then the row's barrier bits), the
// (16, 512) register file (register-major, so a row's operand reads are
// conflict-free), the shared-memory image and a store-port winner array:
// 32 KiB + 8 B per shared-memory word + 64 B per table row (69.4 KiB for a
// 214-row QRD-16 segment at the paper's 3072 words). The table is copied
// in once (a longer segment chunk by chunk), so each row reads its fields
// from shared memory at one address for every thread, a broadcast.
//
// Per row: [barrier] read phase [barrier] write phase. The two barriers
// are the row's bits, placed at plan time (kernels/simt_step.py,
// segment_barriers): a barrier is there only where an access of one
// thread would race with an access of another since the last barrier. A
// snooped operand or INVSQR's source reads another thread's register, an
// LOD reads the image, an STO claims the winner array and stores into the
// image; every other access of a row is to the thread's own registers and
// needs no barrier. Every row computes from the whole old state, as
// executor.apply_segment_rows does. The copy-in, each chunk of the table
// and the copy-out have barriers of their own.
//
// DOT/SUM: the terms of a wavefront meet in its warp by shuffles, lane by
// lane from +0.0 on lane 0 (the megakernel's order), or, on a predicated
// row at least 8 lanes wide, lane 0 onto +0.0 and then the pairwise fold
// 8, 4, 2, 1, in which each lane l < h adds lane l + h.
//
// Bound: the bytes are the state in and out once (under 1 MB for a
// four-SM wave), far below a microsecond at 3.35 TB/s, and the arithmetic
// is a few operations per thread per row. What bounds it is the serial
// chain of rows on as many SMs as the wave has members: each row decodes
// its fields, branches to its handler, waits on its operands in shared
// memory and then on the barriers its bits ask for, one row after the
// other. The copies in and out move each thread's 16 registers as four
// 16-byte vectors into conflict-free register-major rows.
#include <cstdint>
#include <cuda_runtime.h>

#include "egpu_fp32.cuh"
#include "egpu_smem.cuh"

namespace {

constexpr int kThreads = 512, kSP = 16, kRegs = 16, kFields = 15;
constexpr int kRowWords = 16;          // the 15 fields and the barrier bits
constexpr unsigned kFull = 0xFFFFFFFFu;
enum { OP_TDX = 13, OP_TDY = 14, OP_DOT = 15, OP_BID = 26 };
enum { kBarrierBeforeRead = 1, kBarrierBeforeWrite = 2 };

// One row of the table in shared memory, in FIELDS order, and its bits.
struct Fields {
  int sel, op, typ, rd, ra, rb, imm, x, ext_a, ext_b, pen, preg, pneg,
      act_waves, act_wthreads, bits;
};

__device__ __forceinline__ Fields row_at(const int32_t* table, int r) {
  const int4* q = reinterpret_cast<const int4*>(table + r * kRowWords);
  const int4 a = q[0], b = q[1], c = q[2], d = q[3];
  return {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
          c.x, c.y, c.z, c.w, d.x, d.y, d.z, d.w};
}

__global__ void __launch_bounds__(kThreads)
segment_kernel(const int32_t* __restrict__ rows,
               const int32_t* __restrict__ bits, int n_rows, int chunk,
               const int32_t* __restrict__ block_idx,
               const int32_t* __restrict__ prog_idx,
               const uint32_t* __restrict__ regs_in,
               const uint32_t* __restrict__ shmem_in,
               const uint8_t* __restrict__ oob_in,
               uint32_t* __restrict__ regs_out,
               uint32_t* __restrict__ shmem_out,
               uint8_t* __restrict__ oob_out,
               int depth, int bound, int n_threads, int dim_x) {
  extern __shared__ __align__(16) uint32_t smem[];
  int32_t* table = reinterpret_cast<int32_t*>(smem);     // [chunk][16]
  uint32_t* regs = smem + chunk * kRowWords;             // [kRegs][kThreads]
  uint32_t* mem = regs + kRegs * kThreads;               // [depth]
  int* winner = reinterpret_cast<int*>(mem + depth);     // [depth]
  __shared__ int oob_flag;

  const int sm = blockIdx.x, t = threadIdx.x;
  const int lane = t % kSP, wave = t / kSP;
  // thread t's 16 registers: four 16-byte loads, conflict-free stores
  const uint4* rin = reinterpret_cast<const uint4*>(
      regs_in + (static_cast<size_t>(sm) * kThreads + t) * kRegs);
#pragma unroll
  for (int q = 0; q < kRegs / 4; ++q) {
    const uint4 v = rin[q];
    regs[(4 * q + 0) * kThreads + t] = v.x;
    regs[(4 * q + 1) * kThreads + t] = v.y;
    regs[(4 * q + 2) * kThreads + t] = v.z;
    regs[(4 * q + 3) * kThreads + t] = v.w;
  }
  const uint32_t* shin = shmem_in + static_cast<size_t>(sm) * depth;
  for (int i = t; i < depth; i += kThreads) {
    mem[i] = shin[i];
    winner[i] = -1;
  }
  if (t == 0) oob_flag = oob_in[sm] ? 1 : 0;

  for (int c0 = 0; c0 < n_rows; c0 += chunk) {
    const int len = min(chunk, n_rows - c0);
    if (c0) __syncthreads();               // every thread is past the chunk
    const int32_t* src = rows + static_cast<size_t>(c0) * kFields;
    for (int i = t; i < len * kRowWords; i += kThreads) {
      const int r = i / kRowWords, f = i % kRowWords;
      table[i] = f < kFields ? src[r * kFields + f] : bits[c0 + r];
    }
    __syncthreads();

    for (int r = 0; r < len; ++r) {
      const Fields f = row_at(table, r);
      // the single write port: the highest enabled thread wins; the row
      // number keeps the winner array monotonic across rows
      const int key = (c0 + r) * kThreads + t;
      if (f.bits & kBarrierBeforeRead) __syncthreads();

      // ---- read phase: every value this thread will write ----
      const bool snoop = f.x == 1;
      const bool active = lane < f.act_wthreads && wave < f.act_waves
                          && t < n_threads;
      bool psel = true;
      if (f.pen)
        psel = ((regs[f.preg * kThreads + t] & 1u) != 0u) != (f.pneg != 0);
      const bool eff = active && psel;
      const int ta = snoop ? f.ext_a * kSP + lane : t;
      const int tb = snoop ? f.ext_b * kSP + lane : t;
      const uint32_t old = regs[f.rd * kThreads + t];
      uint32_t nv = old;
      bool wr = false;                  // this thread writes regs[rd][t]
      int st_addr = 0;
      bool st_do = false;
      switch (f.sel) {
        case 1: {                                         // ALU
          const uint32_t a = regs[f.ra * kThreads + ta];
          const uint32_t b = regs[f.rb * kThreads + tb];
          wr = true;
          if (eff) nv = egpu::alu(f.op, f.typ, a, b);
          break;
        }
        case 2:                                           // LOD
        case 3: {                                         // STO
          const uint32_t a = regs[f.ra * kThreads + ta];
          const int addr = static_cast<int>(a + static_cast<uint32_t>(f.imm));
          const bool ok = eff && addr >= 0 && addr < bound;
          if (eff && !ok) oob_flag = 1;
          if (f.sel == 2) {
            wr = true;
            if (ok) nv = mem[addr];
          } else {
            st_do = ok;
            st_addr = addr;
            if (ok) atomicMax(&winner[addr], key);
          }
          break;
        }
        case 4:                                           // LODI
          wr = true;
          if (eff) nv = f.typ == 2
                            ? __float_as_uint(static_cast<float>(f.imm))
                            : static_cast<uint32_t>(f.imm);
          break;
        case 5: {                                         // TDX/TDY/BID/PID
          wr = true;
          const uint32_t v =
              f.op == OP_TDX ? static_cast<uint32_t>(t % dim_x)
            : f.op == OP_TDY ? static_cast<uint32_t>(t / dim_x)
            : f.op == OP_BID ? static_cast<uint32_t>(block_idx[sm])
                             : static_cast<uint32_t>(prog_idx[sm]);
          if (eff) nv = v;
          break;
        }
        case 6: {                                         // DOT/SUM
          const uint32_t a = regs[f.ra * kThreads + ta];
          const uint32_t b = regs[f.rb * kThreads + tb];
          const uint32_t term = egpu::fp_binop(f.op == OP_DOT ? 3 : 1, a, b);
          uint32_t v = eff ? term : 0u;
          const int base = (t & 31) & ~(kSP - 1);         // half-warp's lane 0
          const unsigned en = (__ballot_sync(kFull, eff) >> base) & 0xFFFFu;
          if (f.pen && f.act_wthreads >= 8) {
            // lane 0 onto +0.0, then fold halves: each lane l < h adds
            // lane l + h (the other lanes' sums are never read)
            if (lane == 0) v = egpu::fp_add(0u, v);
#pragma unroll
            for (int h = kSP / 2; h >= 1; h /= 2)
              v = egpu::fp_add(v, __shfl_down_sync(kFull, v, h, kSP));
          } else {                      // lane by lane from +0.0
            uint32_t acc = 0u;
#pragma unroll
            for (int l = 0; l < kSP; ++l)
              acc = egpu::fp_add(acc, __shfl_sync(kFull, v, l, kSP));
            v = acc;
          }
          if (lane == 0) {
            wr = true;
            if (en) nv = v;
          }
          break;
        }
        case 7:                                           // SFU (INVSQR)
          if (t == 0) {
            wr = true;
            const int src = snoop ? f.ext_a * kSP : 0;
            if (psel) nv = egpu::invsqr(regs[f.ra * kThreads + src]);
          }
          break;
        case 10: {                                        // SETP
          const uint32_t a = regs[f.ra * kThreads + ta];
          const uint32_t b = regs[f.rb * kThreads + tb];
          wr = true;
          if (eff) nv = egpu::setp(f.imm, f.typ, a, b) ? 1u : 0u;
          break;
        }
        case 11: {                                        // SELP
          const uint32_t a = regs[f.ra * kThreads + ta];
          const uint32_t b = regs[f.rb * kThreads + tb];
          wr = true;
          if (active) nv = (!f.pen || psel) ? a : b;
          break;
        }
        default:                                          // not SM-local
          break;
      }
      if (f.bits & kBarrierBeforeWrite) __syncthreads();

      // ---- write phase ----
      if (wr) regs[f.rd * kThreads + t] = nv;
      if (st_do && winner[st_addr] == key) mem[st_addr] = old;  // regs[rd][t]
    }
  }
  __syncthreads();

  uint4* rout = reinterpret_cast<uint4*>(
      regs_out + (static_cast<size_t>(sm) * kThreads + t) * kRegs);
#pragma unroll
  for (int q = 0; q < kRegs / 4; ++q)
    rout[q] = make_uint4(regs[(4 * q + 0) * kThreads + t],
                         regs[(4 * q + 1) * kThreads + t],
                         regs[(4 * q + 2) * kThreads + t],
                         regs[(4 * q + 3) * kThreads + t]);
  uint32_t* mout = shmem_out + static_cast<size_t>(sm) * depth;
  for (int i = t; i < depth; i += kThreads) mout[i] = mem[i];
  if (t == 0) oob_out[sm] = static_cast<uint8_t>(oob_flag);
}

}  // namespace

// rows: the segment's (n_rows, 15) int32 table in FIELDS order; bits: its
// (n_rows,) barrier bits; chunk: table rows held in shared memory at once.
// The wave's state is read from the *_in tensors and written to the
// *_out tensors.
extern "C" int egpu_segment(const int32_t* rows, const int32_t* bits,
                            int n_rows, int chunk, const int32_t* block_idx,
                            const int32_t* prog_idx, const int32_t* regs_in,
                            const int32_t* shmem_in, const uint8_t* oob_in,
                            int32_t* regs_out, int32_t* shmem_out,
                            uint8_t* oob_out, int n_sms, int depth, int bound,
                            int n_threads, int dim_x, void* stream) {
  static egpu::SmemLimit limit;
  const size_t smem = sizeof(uint32_t)
      * (static_cast<size_t>(chunk) * kRowWords + kRegs * kThreads
         + 2 * static_cast<size_t>(depth));
  const cudaError_t err = limit.allow(
      reinterpret_cast<const void*>(segment_kernel), static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  segment_kernel<<<n_sms, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      rows, bits, n_rows, chunk, block_idx, prog_idx,
      reinterpret_cast<const uint32_t*>(regs_in),
      reinterpret_cast<const uint32_t*>(shmem_in), oob_in,
      reinterpret_cast<uint32_t*>(regs_out),
      reinterpret_cast<uint32_t*>(shmem_out), oob_out, depth, bound,
      n_threads, dim_x);
  return static_cast<int>(cudaGetLastError());
}
