// The load port of a data row, shared by LOD (smem.cu, each SM's own
// shared-memory image) and GLD (gmem.cu, the one device-wide image).
#pragma once
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "egpu_row.cuh"

namespace {

// One LOD or GLD row over a wave: one CTA of 512 threads per SM, regs and
// oob written in place. SM s loads from mem + s * stride (stride 0: every
// SM reads the one global image); an enabled lane whose address lies
// outside [0, bound) keeps rd and sets its SM's oob flag. The loaded word
// is written after a barrier: with snooping the address is another
// thread's register, and rd may be that register or preg.
__global__ void __launch_bounds__(egpu::kRowThreads)
load_row_kernel(egpu::Row f, uint32_t* __restrict__ regs,
                const uint32_t* __restrict__ mem, uint8_t* __restrict__ oob,
                size_t stride, int bound, int n_threads) {
  uint32_t* r =
      regs + static_cast<size_t>(blockIdx.x) * egpu::kRowThreads * egpu::kRegs;
  const int t = threadIdx.x;
  uint32_t v = r[t * egpu::kRegs + f.rd];
  if (egpu::row_enabled(f, r, t, n_threads)) {
    const int a = egpu::row_address(f, r, t);
    if (a < 0 || a >= bound)
      oob[blockIdx.x] = 1;
    else
      v = mem[blockIdx.x * stride + a];
  }
  __syncthreads();
  r[t * egpu::kRegs + f.rd] = v;
}

// Launch one LOD or GLD row (the row's fields in FIELDS order).
inline cudaError_t launch_load_row(const egpu::Row& f, int n_threads,
                                   int32_t* regs, const int32_t* mem,
                                   uint8_t* oob, int n_sms, size_t stride,
                                   int bound, cudaStream_t stream) {
  load_row_kernel<<<n_sms, egpu::kRowThreads, 0, stream>>>(
      f, reinterpret_cast<uint32_t*>(regs),
      reinterpret_cast<const uint32_t*>(mem), oob, stride, bound, n_threads);
  return cudaGetLastError();
}

}  // namespace
