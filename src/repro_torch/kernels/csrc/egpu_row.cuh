// One data row of the step and trace engines, as a row kernel takes it.
//
// A row kernel runs one decoded instruction over a wave of simulated SMs:
// one CTA of 512 threads per SM, thread t the eGPU thread t (lane t % 16,
// wavefront t / 16). The register file is the (n_sm, 512, 16) int32
// tensor as it lies in device memory, regs[s][t][r], and the kernel reads
// and writes it in place. The row's decoded fields arrive by value, in the
// order of core/executor.py's FIELDS (the segment kernel's row encoding).
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace egpu {

constexpr int kRowThreads = 512, kSP = 16, kRegs = 16;

struct Row {
  int sel, opcode, typ, rd, ra, rb, imm, x, ext_a, ext_b, pen, preg, pneg,
      act_waves, act_wthreads;
};

// Thread t's write and port gate: the flexible-ISA active shape and, on a
// predicated word, bit 0 of its own predicate register (negated by pneg).
// A legacy PEN=0 word has no predicate gate. r is the thread's SM's
// register file.
__device__ __forceinline__ bool row_enabled(const Row& f, const uint32_t* r,
                                            int t, int n_threads) {
  const int lane = t % kSP, wave = t / kSP;
  bool en = lane < f.act_wthreads && wave < f.act_waves && t < n_threads;
  if (f.pen)
    en = en && (((r[t * kRegs + f.preg] & 1u) != 0u) != (f.pneg != 0));
  return en;
}

// The thread whose register a source operand reads: t itself, or with
// snooping (X=1) thread ext * 16 + lane, which may be another thread that
// writes its destination in the same row.
__device__ __forceinline__ int row_source(const Row& f, int ext, int t) {
  return f.x == 1 ? ext * kSP + t % kSP : t;
}

// Thread t's port address (LOD, STO, GLD, GST): the low 32 bits of its
// sign-extended address operand ra, snooped as the row's, plus imm
// (ref.wrap32).
__device__ __forceinline__ int row_address(const Row& f, const uint32_t* r,
                                           int t) {
  return static_cast<int>(r[row_source(f, f.ext_a, t) * kRegs + f.ra]
                          + static_cast<uint32_t>(f.imm));
}

}  // namespace egpu
