// The eGPU's wavefront dot-product / reduction unit.
//
// Replaces: src/repro/kernels/wavefront_dot.py, wavefront_dot (a
// pallas_call over (block_sm, 512) f32 tiles reshaped to (32 waves, 16
// lanes), reducing the lane axis of a*b or a+b where the mask is set).
//
// Layout: one thread per wavefront of the flattened (n_sm, 32) output.
// The thread sums its 16 lanes in order from +0.0 with the shared header's
// fp_binop/fp_add: each product or sum rounds once, denormals read and
// write as signed zeros, NaNs follow the x86 rule. A disabled lane adds
// +0.0, so a NaN there never reaches the sum. This is the order of the
// plain version (kernels/ref.py, wavefront_dot_ref), and of the
// reference's sum on the host CPU.
//
// Bound: bytes. A wavefront reads 16 x (4 + 4 + 1) bytes and writes 4 for
// 31 operations, far below the card's ratio of operations to bytes. The
// design does nothing about it beyond one pass over the inputs.
#include <cstdint>
#include <cuda_runtime.h>

#include "egpu_fp32.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kLanes = 16;

__global__ void dot_kernel(int op, const uint32_t* __restrict__ a,
                           const uint32_t* __restrict__ b,
                           const uint8_t* __restrict__ mask,
                           uint32_t* __restrict__ out, int n_waves) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= n_waves) return;
  const size_t base = static_cast<size_t>(w) * kLanes;
  uint32_t acc = 0u;
  for (int lane = 0; lane < kLanes; ++lane) {
    const size_t i = base + lane;
    const uint32_t term = mask[i] ? egpu::fp_binop(op, a[i], b[i]) : 0u;
    acc = egpu::fp_add(acc, term);
  }
  out[w] = acc;
}

}  // namespace

// mode 0 sums a*b (DOT), any other mode a+b (SUM); n_waves = n_sm * 32
extern "C" int egpu_wavefront_dot(int mode, const float* a, const float* b,
                                  const uint8_t* mask, float* out,
                                  int n_waves, void* stream) {
  if (n_waves == 0) return 0;
  dot_kernel<<<(n_waves + kBlock - 1) / kBlock, kBlock, 0,
               static_cast<cudaStream_t>(stream)>>>(
      mode == 0 ? 3 : 1, reinterpret_cast<const uint32_t*>(a),
      reinterpret_cast<const uint32_t*>(b), mask,
      reinterpret_cast<uint32_t*>(out), n_waves);
  return static_cast<int>(cudaGetLastError());
}
