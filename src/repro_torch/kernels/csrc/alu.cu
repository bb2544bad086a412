// The eGPU SIMT ALU: one instruction over a batch of simulated SMs, the
// execute stage of the step and trace engines.
//
// Replaces: src/repro/kernels/simt_alu.py, simt_alu (a pallas_call over
// (block_sm, 512) uint32 tiles with the op and operand type as scalars).
//
// Layout: one thread per lane of the flattened (n_sm, 512) batch; op and
// typ are kernel arguments, uniform over the launch, so the switch in
// egpu::alu never diverges. Words are computed as uint32_t, so the 16x16
// multiply and LSL wrap instead of overflowing a signed int; FP32 comes
// from egpu_fp32.cuh (denormals read and written as zeros, the x86 NaN
// rule, one rounding per operation, built with -fmad=false).
//
// Bound: bytes. Each lane reads a, b, old (12 B) and the mask (1 B) and
// writes one word (4 B): 34 KB for the step path's 4 x 512 lanes, about
// 10 ns at 3.35 TB/s, with a few operations per lane. What the call costs
// is the launch itself; the design does nothing beyond coalesced loads.
#include <cstdint>
#include <cuda_runtime.h>

#include "egpu_fp32.cuh"

namespace {

constexpr int kBlock = 256;

__global__ void alu_kernel(int op, int typ, const uint32_t* __restrict__ a,
                           const uint32_t* __restrict__ b,
                           const uint8_t* __restrict__ mask,
                           const uint32_t* __restrict__ old,
                           uint32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = mask[i] ? egpu::alu(op, typ, a[i], b[i]) : old[i];
}

}  // namespace

extern "C" int egpu_alu(int op, int typ, const int32_t* a, const int32_t* b,
                        const uint8_t* mask, const int32_t* old, int32_t* out,
                        int n, void* stream) {
  if (n == 0) return 0;
  alu_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
               static_cast<cudaStream_t>(stream)>>>(
      op, typ, reinterpret_cast<const uint32_t*>(a),
      reinterpret_cast<const uint32_t*>(b), mask,
      reinterpret_cast<const uint32_t*>(old), reinterpret_cast<uint32_t*>(out),
      n);
  return static_cast<int>(cudaGetLastError());
}
