// The eGPU's wavefront dot-product / reduction unit.
//
// Replaces: src/repro/kernels/wavefront_dot.py, wavefront_dot (a
// pallas_call over (block_sm, 512) f32 tiles reshaped to (32 waves, 16
// lanes), reducing the lane axis of a*b or a+b where the mask is set).
//
// Order: one thread per wavefront of the flattened (n_sm, 32) output sums
// its 16 lane terms one by one from +0.0, lane 0 first: a serial chain of
// 16 adds, so the sum stays in one thread (no tree, no shuffle fold). Each
// product or sum rounds once, denormals read and write as signed zeros,
// NaNs follow the x86 rule, and a disabled lane adds +0.0, so a NaN there
// never reaches the sum. This is the order of the plain version
// (kernels/ref.py, wavefront_dot_ref), and of the reference's sum on the
// host CPU.
//
// Bound: bytes. A wavefront reads 16 x (4 + 4 + 1) bytes and writes 4 for
// 31 operations; at 4096 x 512 that is 18.9 MB read, 5.79 us at 3.35 TB/s.
//
// Design:
// - The mode is a template parameter (DOT: the lane's term is a*b; SUM:
//   a+b), one instantiation each, so no lane branches on the op.
// - A CTA of 4 warps takes 128 consecutive wavefronts, one a thread. A
//   thread loads its wavefront's a and b with four 16-byte loads each and
//   its 16 mask bytes with one: no shared memory and no barrier. A warp's
//   four loads of a (or b) cover its 2 KiB of a in whole 32-byte sectors,
//   each fetched once (the second half of a sector comes from L1); its
//   mask load is one coalesced 512-byte piece. (Staging a warp's tile
//   through shared memory with cp.async, consecutive lanes on consecutive
//   pieces, was 6% slower warm and 1-2% faster cold on an H100: PERF.md.)
// - The sum takes the card's FTZ add and multiply (one rounding each,
//   denormal operands and results as signed zeros). Where that chain's
//   sum is not a NaN, its terms are the shared header's words word for
//   word (a NaN term would make the sum a NaN; a sum is exact where it is
//   denormal), except a product at or below 2^-126 in magnitude from two
//   operands that do not read as zero: when such a product is tiny is the
//   x86 rule's. (A zero from an operand that reads as zero is exact, its
//   sign the operands' XOR on either side.) A wavefront with such an
//   enabled product, or a NaN sum, is summed again with
//   egpu::fp_binop/fp_add (the x86 NaN rule, tininess after rounding).
// - n_waves is a multiple of 32 (n_sm * 32); the last CTA's threads past
//   it return at once.
// - a, b and mask start at 16-byte boundaries (the wrapper checks).
#include <cstdint>
#include <cuda_runtime.h>

#include "egpu_fp32.cuh"

namespace {

constexpr int kLanes = 16;
constexpr int kChunks = kLanes / 4;   // 16-byte chunks of a wavefront's a or b
constexpr int kThreads = 128;         // a CTA's wavefronts, one a thread

// a*b (Op 3) or a+b (Op 1) rounded once, never contracted into an FMA,
// with denormal operands and results flushed to signed zeros
template <int Op>
__device__ __forceinline__ uint32_t op_ftz(uint32_t a, uint32_t b) {
  float r;
  if constexpr (Op == 1)
    asm("add.rn.ftz.f32 %0, %1, %2;"
        : "=f"(r) : "f"(__uint_as_float(a)), "f"(__uint_as_float(b)));
  else
    asm("mul.rn.ftz.f32 %0, %1, %2;"
        : "=f"(r) : "f"(__uint_as_float(a)), "f"(__uint_as_float(b)));
  return __float_as_uint(r);
}

// whether op_ftz's product w of a and b may differ from egpu::fp_binop's
// word though it is not a NaN; a sum never does
template <int Op>
__device__ __forceinline__ bool tiny(uint32_t w, uint32_t a, uint32_t b) {
  if constexpr (Op == 1)
    return false;
  else
    return (w & 0x7FFFFFFFu) <= egpu::kMinNormal &&
           min(a & 0x7F800000u, b & 0x7F800000u) != 0u;
}

// the 16-lane sum of one wavefront with the shared header's statements
template <int Op>
__device__ __forceinline__ uint32_t exact_sum(const uint32_t (&a)[kLanes],
                                           const uint32_t (&b)[kLanes],
                                           const uint32_t (&mw)[kChunks]) {
  uint32_t acc = 0u;
#pragma unroll
  for (int lane = 0; lane < kLanes; ++lane) {
    const bool on = (mw[lane / 4] >> (8 * (lane % 4))) & 0xFFu;
    acc = egpu::fp_add(acc, on ? egpu::fp_binop(Op, a[lane], b[lane]) : 0u);
  }
  return acc;
}

// the same sum: the FTZ chain, or exact_sum where its words could differ
template <int Op>
__device__ __forceinline__ uint32_t wavefront_sum(const uint32_t (&a)[kLanes],
                                                  const uint32_t (&b)[kLanes],
                                                  const uint4 m) {
  const uint32_t mw[kChunks] = {m.x, m.y, m.z, m.w};
  uint32_t acc = 0u;
  bool fast = true;
#pragma unroll
  for (int lane = 0; lane < kLanes; ++lane) {
    const bool on = (mw[lane / 4] >> (8 * (lane % 4))) & 0xFFu;
    const uint32_t x = op_ftz<Op>(a[lane], b[lane]);
    fast &= !(on && tiny<Op>(x, a[lane], b[lane]));
    acc = op_ftz<1>(acc, on ? x : 0u);
  }
  if (!fast || egpu::is_nan(acc)) acc = exact_sum<Op>(a, b, mw);
  return acc;
}

template <int Op>
__global__ void __launch_bounds__(kThreads)
dot_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
           const uint4* __restrict__ mask, uint32_t* __restrict__ out,
           int n_waves) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= n_waves) return;
  const size_t p = static_cast<size_t>(w) * kChunks;
  uint32_t va[kLanes], vb[kLanes];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const uint4 x = __ldg(a + p + k), y = __ldg(b + p + k);
    va[4 * k] = x.x; va[4 * k + 1] = x.y; va[4 * k + 2] = x.z; va[4 * k + 3] = x.w;
    vb[4 * k] = y.x; vb[4 * k + 1] = y.y; vb[4 * k + 2] = y.z; vb[4 * k + 3] = y.w;
  }
  out[w] = wavefront_sum<Op>(va, vb, __ldg(mask + w));
}

}  // namespace

// mode 0 sums a*b (DOT), any other mode a+b (SUM); n_waves = n_sm * 32;
// a, b and mask 16-byte aligned
extern "C" int egpu_wavefront_dot(int mode, const float* a, const float* b,
                                  const uint8_t* mask, float* out,
                                  int n_waves, void* stream) {
  if (n_waves == 0) return 0;
  const dim3 grid((n_waves + kThreads - 1) / kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* a4 = reinterpret_cast<const uint4*>(a);
  const auto* b4 = reinterpret_cast<const uint4*>(b);
  const auto* m4 = reinterpret_cast<const uint4*>(mask);
  auto* o = reinterpret_cast<uint32_t*>(out);
  if (mode == 0)
    dot_kernel<3><<<grid, kThreads, 0, s>>>(a4, b4, m4, o, n_waves);
  else
    dot_kernel<1><<<grid, kThreads, 0, s>>>(a4, b4, m4, o, n_waves);
  return static_cast<int>(cudaGetLastError());
}
