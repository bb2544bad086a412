// Flash attention: causal or non-causal online-softmax attention.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention (a
// pallas_call over a (BH, S / blk_q) grid; each cell holds a (blk_q, D)
// query tile and runs the online-softmax recurrence over blk_k-row key and
// value blocks, skipping the blocks entirely in the future when causal).
//
// Layout: a CTA of 256 threads takes 32 query rows of one q-block of one
// (batch x head); a q-block of blk_q rows is ceil(blk_q / 32) CTAs. The
// CTA stages its query rows once and, per live key block, the K and V
// tiles (blk_k x D, converted to float32) in dynamic shared memory, then:
//   1. scores s = (q . k) * scale in a shared (32 x blk_k) tile, with
//      NEG_INF where the key lies in the query's future;
//   2. one warp per row: m' = max(m, max s), alpha = exp(m - m'),
//      p = exp(s - m') in place, l' = alpha l + sum p;
//   3. acc' = acc alpha + p V, each thread holding 16 of the 32 x D
//      accumulators in registers.
// The output is acc / max(l, 1e-30) in q's type. This is the recurrence,
// the scale, NEG_INF and the count of live key blocks (from the q-block's
// last row) of the reference; the products are summed in another order
// than the plain version's matmul, so the two agree within a tolerance.
// Everything accumulates in float32; the dot products use explicit fmaf.
//
// Bound: operations (4 D per live query-key pair, about 8.6 GFLOP at
// 32 x 1024 x 128 causal) over 67 TFLOP/s of float32 FMA. The design reads
// both operands of every FMA from shared memory, so it is held by
// shared-memory bandwidth well above that bound; register tiling and the
// tensor cores are a later step.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;                          // query rows per CTA
constexpr int kThreads = 256;
constexpr int kMaxD = 128;
constexpr int kAcc = kRows * kMaxD / kThreads;     // accumulators a thread
constexpr float kNegInf = static_cast<float>(-0.7 * 3.4028234663852886e38);

template <typename T> __device__ __forceinline__ float load(const T* p);
template <> __device__ __forceinline__ float load<float>(const float* p) {
  return *p;
}
template <> __device__ __forceinline__ float load<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T> __device__ __forceinline__ T cast(float x);
template <> __device__ __forceinline__ float cast<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 cast<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int S, int D,
             int blk_q, int blk_k, int causal, float scale) {
  extern __shared__ float smem[];
  const int dk = D | 1;           // odd row stride: K reads are conflict-free
  const int pk = blk_k + 1;
  float* qs = smem;                       // kRows x D
  float* ks = qs + kRows * D;             // blk_k x dk
  float* vs = ks + blk_k * dk;            // blk_k x D
  float* ps = vs + blk_k * D;             // kRows x pk: scores, then p
  float* m_s = ps + kRows * pk;
  float* l_s = m_s + kRows;
  float* a_s = l_s + kRows;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q_end = (blockIdx.y + 1) * blk_q;
  const int row0 = blockIdx.y * blk_q + blockIdx.x * kRows;
  const int rows = min(kRows, q_end - row0);
  const size_t head = static_cast<size_t>(blockIdx.z) * S * D;
  const size_t qo = head + static_cast<size_t>(row0) * D;

  for (int e = tid; e < kRows * D; e += kThreads)
    qs[e] = e / D < rows ? load(q + qo + e) : 0.0f;
  if (tid < kRows) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.0f;
  }
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;

  const int n_kb = S / blk_k;
  const int n_live = causal ? min((q_end - 1) / blk_k + 1, n_kb) : n_kb;
  for (int kb = 0; kb < n_live; ++kb) {
    __syncthreads();              // the previous block's tiles are done with
    const size_t kv = head + static_cast<size_t>(kb) * blk_k * D;
    for (int e = tid; e < blk_k * D; e += kThreads) {
      const int c = e / D;
      ks[c * dk + e - c * D] = load(k + kv + e);
      vs[e] = load(v + kv + e);
    }
    __syncthreads();
    for (int e = tid; e < kRows * blk_k; e += kThreads) {
      const int r = e / blk_k, c = e - r * blk_k;
      const float* qr = qs + r * D;
      const float* kc = ks + c * dk;
      float s = 0.0f;
      for (int d = 0; d < D; ++d) s = __fmaf_rn(qr[d], kc[d], s);
      s = __fmul_rn(s, scale);
      if (causal && kb * blk_k + c > row0 + r) s = kNegInf;
      ps[r * pk + c] = s;
    }
    __syncthreads();
    for (int r = warp; r < kRows; r += kThreads / 32) {
      float* pr = ps + r * pk;
      const float m_old = m_s[r];
      float mx = m_old;
      for (int c = lane; c < blk_k; c += 32) mx = fmaxf(mx, pr[c]);
      for (int off = 16; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.0f;
      for (int c = lane; c < blk_k; c += 32) {
        const float p = expf(pr[c] - mx);
        pr[c] = p;
        sum += p;
      }
      for (int off = 16; off; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - mx);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = mx;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int e = tid + i * kThreads;
      if (e < kRows * D) {
        const int r = e / D, d = e - r * D;
        const float* pr = ps + r * pk;
        float pv = 0.0f;
        for (int c = 0; c < blk_k; ++c) pv = __fmaf_rn(pr[c], vs[c * D + d], pv);
        acc[i] = acc[i] * a_s[r] + pv;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int e = tid + i * kThreads;
    if (e < kRows * D && e / D < rows)
      o[qo + e] = cast<T>(acc[i] / fmaxf(l_s[e / D], 1e-30f));
  }
}

// Dynamic shared memory of one CTA, in bytes; kernels/flash_attention.py
// checks the same sum against the 227 KiB a block may use.
size_t smem_bytes(int D, int blk_k) {
  return sizeof(float) * (static_cast<size_t>(kRows) * D
                          + static_cast<size_t>(blk_k) * (D | 1)
                          + static_cast<size_t>(blk_k) * D
                          + static_cast<size_t>(kRows) * (blk_k + 1)
                          + 3 * kRows);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int S, int D, int blk_q, int blk_k, int causal, size_t smem,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const dim3 grid((blk_q + kRows - 1) / kRows, S / blk_q, bh);
  flash_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, D, blk_q, blk_k,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: (bh, S, D) contiguous, float32 (dtype 0) or bfloat16 (1);
// D <= 128; S a multiple of blk_q and blk_k.
extern "C" int egpu_flash_attention(int dtype, const void* q, const void* k,
                                    const void* v, void* o, int bh, int S,
                                    int D, int blk_q, int blk_k, int causal,
                                    void* stream) {
  if (bh == 0 || S == 0) return 0;
  if (D < 1 || D > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(D, blk_k);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, bh, S, D, blk_q, blk_k, causal, smem, s);
  return launch<__nv_bfloat16>(q, k, v, o, bh, S, D, blk_q, blk_k, causal,
                               smem, s);
}
