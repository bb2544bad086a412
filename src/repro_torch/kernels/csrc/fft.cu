// Batched radix-2 decimation-in-frequency FFT.
//
// Replaces: src/repro/kernels/fft_r2.py, fft_r2 (a pallas_call that keeps a
// (block_b, N) block of re/im planes in fast memory for all log2 N passes,
// with a (2, log2 N, N/2) twiddle table shared by the grid).
//
// Layout: one CTA per signal row. The CTA copies the row's re and im planes
// into dynamic shared memory (8 N bytes) and runs every pass there: in pass
// p (h = N/2 >> p) butterfly t pairs a = (t / h) * 2h + t % h with b = a + h,
// and writes u = a + b back to a and v = (a - b) * w back to b, so each
// pass works in place, with a barrier between passes. A thread takes
// butterflies t, t + blockDim, ... . The twiddle table lives once in device
// memory (built on the host in float64 and rounded to float32, uploaded
// once per N and card) and is read through the cache by every CTA.
// natural != 0 stores output i at its natural index bitrev(i).
//
// Every operation is an __f*_rn intrinsic (built with -fmad=false), in the
// order of the plain version (kernels/fft_r2.py, fft_r2_plain), so the two
// are equal word for word.
//
// Bound: bytes for the batches of the kernel path (a row is read and
// written once: 16 bytes per point against 5 log2 N / 2 operations per
// point). The passes never touch device memory; the design spends nothing
// on the barriers and shared-memory bank conflicts of the larger strides.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void fft_kernel(const float* __restrict__ tw,
                           const float* __restrict__ re,
                           const float* __restrict__ im,
                           float* __restrict__ ore, float* __restrict__ oim,
                           int n, int log2n, int natural) {
  extern __shared__ float plane[];
  float* sre = plane;
  float* sim = plane + n;
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    sre[i] = re[row + i];
    sim[i] = im[row + i];
  }
  __syncthreads();
  const int half = n >> 1;
  for (int p = 0; p < log2n; ++p) {
    const int shift = log2n - 1 - p;          // h = 1 << shift
    const int h = 1 << shift;
    const float* wre = tw + static_cast<size_t>(p) * half;
    const float* wim = tw + static_cast<size_t>(log2n + p) * half;
    for (int t = threadIdx.x; t < half; t += blockDim.x) {
      const int pos = t & (h - 1);
      const int ia = ((t >> shift) << (shift + 1)) + pos;
      const int ib = ia + h;
      const float ar = sre[ia], ai = sim[ia], br = sre[ib], bi = sim[ib];
      const float wr = wre[pos], wi = wim[pos];
      const float dr = __fsub_rn(ar, br), di = __fsub_rn(ai, bi);
      sre[ia] = __fadd_rn(ar, br);
      sim[ia] = __fadd_rn(ai, bi);
      sre[ib] = __fsub_rn(__fmul_rn(dr, wr), __fmul_rn(di, wi));
      sim[ib] = __fadd_rn(__fmul_rn(dr, wi), __fmul_rn(di, wr));
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int dst = (natural && log2n > 0)
        ? static_cast<int>(__brev(static_cast<unsigned>(i)) >> (32 - log2n))
        : i;
    ore[row + dst] = sre[i];
    oim[row + dst] = sim[i];
  }
}

}  // namespace

// tw: the (2, log2n, n/2) twiddle table; re, im, ore, oim: (rows, n)
extern "C" int egpu_fft_r2(const float* tw, const float* re, const float* im,
                           float* ore, float* oim, int rows, int n, int log2n,
                           int natural, void* stream) {
  if (rows == 0) return 0;
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(n);
  cudaError_t err = cudaFuncSetAttribute(
      fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = n / 2;
  threads = threads < 32 ? 32 : (threads > 512 ? 512 : threads);
  fft_kernel<<<rows, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      tw, re, im, ore, oim, n, log2n, natural);
  return static_cast<int>(cudaGetLastError());
}
