// The eGPU SIMT ALU, the execute stage of the step and trace engines.
//
// Replaces: src/repro/kernels/simt_alu.py, simt_alu (a pallas_call over
// (block_sm, 512) uint32 tiles with the op and operand type as scalars).
//
// One kernel body, two entry points:
//   * egpu_alu_row: one ALU data row over a wave of SMs, in place. One CTA
//     of 512 threads per SM; each thread forms its own gate (active shape,
//     predicate), reads its operands from the register file (snooped
//     operands from thread ext * 16 + lane), and after a barrier writes
//     regs[s][t][rd] where enabled. The barrier keeps every read of the
//     row before any write: with snooping, rd may be another thread's
//     source, and preg may equal rd. The row's fields come by value, so a
//     row is one launch and nothing else on the card.
//   * egpu_alu: the tile form, out = mask ? alu(a, b) : old over
//     pre-gathered (n, k) operands (ops.alu and the tests).
// op and typ are uniform over a launch, so the switch in egpu::alu never
// diverges. Words are computed as uint32_t, so the 16x16 multiply and LSL
// wrap instead of overflowing a signed int; FP32 comes from egpu_fp32.cuh
// (denormals read and written as zeros, the x86 NaN rule, one rounding per
// operation, tininess after rounding, built with -fmad=false).
//
// Bound: bytes. A row reads three or four words per thread and writes one:
// 33 KB for the step path's 4 x 512 threads, about 10 ns at 3.35 TB/s. A
// row costs what one launch costs; the design issues exactly one.
#include <cstdint>
#include <cuda_runtime.h>

#include "egpu_fp32.cuh"
#include "egpu_row.cuh"

namespace {

constexpr int kBlock = 256;

// The shared body: an I/O policy loads a lane's operands and gate, the
// ALU computes, the policy's barrier separates reads from writes, and the
// lane stores.
template <class Io>
__global__ void __launch_bounds__(egpu::kRowThreads)
alu_kernel(int op, int typ, Io io) {
  uint32_t a, b, old;
  bool en;
  const bool live = io.load(a, b, en, old);
  const uint32_t v = en ? egpu::alu(op, typ, a, b) : old;
  io.barrier();
  if (live) io.store(v);
}

// (n, k) tiles, one thread per lane of the flattened batch; every lane
// writes its own output word, so no barrier is needed.
struct TileIo {
  const uint32_t* a;
  const uint32_t* b;
  const uint8_t* mask;
  const uint32_t* old;
  uint32_t* out;
  int n;

  __device__ int index() const { return blockIdx.x * blockDim.x + threadIdx.x; }
  __device__ bool load(uint32_t& va, uint32_t& vb, bool& en,
                       uint32_t& vold) const {
    const int i = index();
    if (i >= n) {
      en = false;
      vold = 0u;
      return false;
    }
    va = a[i];
    vb = b[i];
    en = mask[i] != 0;
    vold = old[i];
    return true;
  }
  __device__ void barrier() const {}
  __device__ void store(uint32_t v) const { out[index()] = v; }
};

// One ALU row over a CTA per SM, in place: only enabled threads store.
struct RowIo {
  egpu::Row f;
  uint32_t* regs;
  int n_threads;

  __device__ uint32_t* sm_regs() const {
    return regs + static_cast<size_t>(blockIdx.x) * egpu::kRowThreads * egpu::kRegs;
  }
  __device__ bool load(uint32_t& va, uint32_t& vb, bool& en,
                       uint32_t& vold) const {
    const uint32_t* r = sm_regs();
    const int t = threadIdx.x;
    en = egpu::row_enabled(f, r, t, n_threads);
    va = r[egpu::row_source(f, f.ext_a, t) * egpu::kRegs + f.ra];
    vb = r[egpu::row_source(f, f.ext_b, t) * egpu::kRegs + f.rb];
    vold = r[t * egpu::kRegs + f.rd];
    return en;
  }
  __device__ void barrier() const { __syncthreads(); }
  __device__ void store(uint32_t v) const {
    sm_regs()[threadIdx.x * egpu::kRegs + f.rd] = v;
  }
};

}  // namespace

extern "C" int egpu_alu(int op, int typ, const int32_t* a, const int32_t* b,
                        const uint8_t* mask, const int32_t* old, int32_t* out,
                        int n, void* stream) {
  if (n == 0) return 0;
  const TileIo io{reinterpret_cast<const uint32_t*>(a),
                  reinterpret_cast<const uint32_t*>(b), mask,
                  reinterpret_cast<const uint32_t*>(old),
                  reinterpret_cast<uint32_t*>(out), n};
  alu_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
               static_cast<cudaStream_t>(stream)>>>(op, typ, io);
  return static_cast<int>(cudaGetLastError());
}

// The row's 15 fields in FIELDS order, then the wave: regs is the
// (n_sms, 512, 16) register file, written in place.
extern "C" int egpu_alu_row(int sel, int opcode, int typ, int rd, int ra,
                            int rb, int imm, int x, int ext_a, int ext_b,
                            int pen, int preg, int pneg, int act_waves,
                            int act_wthreads, int n_threads, int32_t* regs,
                            int n_sms, void* stream) {
  const RowIo io{{sel, opcode, typ, rd, ra, rb, imm, x, ext_a, ext_b, pen,
                  preg, pneg, act_waves, act_wthreads},
                 reinterpret_cast<uint32_t*>(regs), n_threads};
  alu_kernel<<<n_sms, egpu::kRowThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(opcode, typ, io);
  return static_cast<int>(cudaGetLastError());
}
