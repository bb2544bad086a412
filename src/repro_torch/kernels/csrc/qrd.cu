// Batched modified Gram-Schmidt QR with one re-orthogonalisation pass.
//
// Replaces: src/repro/kernels/mgs_qrd.py, mgs_qrd (a pallas_call over
// (block_b, n, n) f32 blocks resident in fast memory for the whole
// factorisation; columns selected by a one-hot mask, norms by rsqrt).
//
// Layout: one CTA of one warp per matrix, n <= 32. The residual, Q and R
// (3 n^2 floats, 12 KiB at n = 32) stay in shared memory from the first
// load to the last store. For column j the warp runs six phases, each
// ended by a barrier:
//   1. aj = res[:, j]                       (thread i: row i; by index)
//   2. coeff[k] = sum_i q[i][k] aj[i]       (thread k)
//   3. corr[i] = sum_k q[i][k] coeff[k]; aj[i] -= corr[i];
//      res[i][j] -= corr[i]; r[i][j] += coeff[i]       (thread i)
//   4. nrm2 = sum_i aj[i]^2, recip = INVSQR(nrm2)      (thread 0)
//   5. qj[i] = aj[i] recip                  (thread i)
//   6. rrow[k] = sum_i qj[i] res[i][k]      (thread k), then
//      res[i][k] -= qj[i] rrow[k] for all i; q[k][j] += qj[k];
//      r[j][k] += rrow[k]                   (thread k)
// Every inner product is one thread's loop from +0.0, index 0 first, with
// one rounding per multiply and per add (__f*_rn, -fmad=false): the order
// of the plain version (kernels/ref.py, mgs_qrd_ref), which is therefore
// equal word for word. INVSQR is the shared header's correctly rounded
// 1/sqrt, as the simulated SM's.
//
// Bound: bytes at the kernel path's batches (n^2 floats in, 2 n^2 out
// against about 8 n^3 operations per matrix: 12 bytes against 10 n / 3
// operations per element). The serial inner products and the barriers
// between phases, not the bytes, are what the design pays for; one warp
// per matrix keeps the barriers cheap.
#include <cstdint>
#include <cuda_runtime.h>

#include "egpu_fp32.cuh"

namespace {

constexpr int kMaxN = 32;

__global__ void qrd_kernel(const float* __restrict__ a, float* __restrict__ qo,
                           float* __restrict__ ro, int n) {
  extern __shared__ float mats[];
  const int nn = n * n;
  float* res = mats;
  float* q = mats + nn;
  float* r = mats + 2 * nn;
  __shared__ float aj[kMaxN], coeff[kMaxN], qj[kMaxN];
  __shared__ float recip;
  const int t = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * nn;
  for (int e = t; e < nn; e += blockDim.x) {
    res[e] = a[base + e];
    q[e] = 0.0f;
    r[e] = 0.0f;
  }
  __syncthreads();
  for (int j = 0; j < n; ++j) {
    if (t < n) aj[t] = res[t * n + j];
    __syncthreads();
    if (t < n) {
      float acc = 0.0f;
      for (int i = 0; i < n; ++i)
        acc = __fadd_rn(acc, __fmul_rn(q[i * n + t], aj[i]));
      coeff[t] = acc;
    }
    __syncthreads();
    if (t < n) {
      float corr = 0.0f;
      for (int k = 0; k < n; ++k)
        corr = __fadd_rn(corr, __fmul_rn(q[t * n + k], coeff[k]));
      aj[t] = __fsub_rn(aj[t], corr);
      res[t * n + j] = __fsub_rn(res[t * n + j], corr);
      r[t * n + j] = __fadd_rn(r[t * n + j], coeff[t]);
    }
    __syncthreads();
    if (t == 0) {
      float nrm2 = 0.0f;
      for (int i = 0; i < n; ++i)
        nrm2 = __fadd_rn(nrm2, __fmul_rn(aj[i], aj[i]));
      recip = __uint_as_float(egpu::invsqr(__float_as_uint(nrm2)));
    }
    __syncthreads();
    if (t < n) qj[t] = __fmul_rn(aj[t], recip);
    __syncthreads();
    if (t < n) {
      float acc = 0.0f;
      for (int i = 0; i < n; ++i)
        acc = __fadd_rn(acc, __fmul_rn(qj[i], res[i * n + t]));
      for (int i = 0; i < n; ++i)
        res[i * n + t] = __fsub_rn(res[i * n + t], __fmul_rn(qj[i], acc));
      q[t * n + j] = __fadd_rn(q[t * n + j], qj[t]);
      r[j * n + t] = __fadd_rn(r[j * n + t], acc);
    }
    __syncthreads();
  }
  for (int e = t; e < nn; e += blockDim.x) {
    qo[base + e] = q[e];
    ro[base + e] = r[e];
  }
}

}  // namespace

// a, q, r: (batch, n, n) row-major float32; n <= 32
extern "C" int egpu_mgs_qrd(const float* a, float* q, float* r, int batch,
                            int n, void* stream) {
  if (batch == 0 || n == 0) return 0;
  if (n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 3 * sizeof(float) * static_cast<size_t>(n) * n;
  qrd_kernel<<<batch, kMaxN, smem, static_cast<cudaStream_t>(stream)>>>(
      a, q, r, n);
  return static_cast<int>(cudaGetLastError());
}
