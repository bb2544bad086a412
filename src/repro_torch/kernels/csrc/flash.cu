// Flash attention: causal or non-causal online-softmax attention.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention (a
// pallas_call over a (BH, S / blk_q) grid; each cell holds a (blk_q, D)
// query tile and runs the online-softmax recurrence over blk_k-row key and
// value blocks, skipping the blocks entirely in the future when causal).
//
// The recurrence, per query row and key tile: m' = max(m, max s), alpha =
// exp(m - m'), p = exp(s - m'), l' = alpha l + sum p, acc' = alpha acc +
// p V; out = acc / max(l, 1e-30) in q's type, with s = (q . k) * scale and
// NEG_INF where the key lies in the query's future. A CTA takes 128 query
// rows and walks 64-key tiles. Each row reads the keys the reference reads
// for it: those of its blk_q-row block's live blk_k-row key blocks, keys
// below lim = min(S, (last row of the q-block / blk_k + 1) blk_k) when
// causal, all S keys otherwise. A masked key below lim enters as the
// reference's does, p = 0 times its V row (so a NaN or an infinity there
// gives NaN, as there); a key at or past lim does not enter at all (its
// score reads as -inf, p = 0, and P V leaves it out). Beside that, blk_q
// and blk_k change only the order of the sums. Ragged tails (S not a
// multiple of the tiles) lie past lim and load as zero rows. The softmax
// works in base 2 (scores times scale log2 e, 2^x on the SFU), and only a
// tile that reaches past S or past a row's first key tests the masks.
//
// float32 (register tiles on the FMA units, products stay float32; TF32
// would keep about three digits): 256 threads as 16 x 16. Thread (ty, tx)
// holds the 8 x 4 scores of query rows ty + 16 i and keys tx + 16 j,
// accumulated as outer products of float4 loads (128 FMAs per twelve
// 16-byte shared loads), and the 8 x D/16 output accumulators of the same
// rows. Row reductions run over the 16 threads of a half-warp by shuffles.
// P goes to shared memory transposed, into the K buffer its tile no longer
// needs (D > 64), then P V is again an outer product per key; in a tile
// that reaches past a row's lim, each product tests its key against it.
// In a causal tile wholly in the future of the first half of each
// thread's rows, their scores are skipped (all masked), and so is their
// P V unless the tile's V holds a non-finite word or such a row's running
// max is low enough that exp(NEG_INF - m) is not 0: every p skipped is
// then an exact 0 times a finite V.
//
// bfloat16 (tensor cores): 8 warps, 16 query rows each. Q K^T runs as
// mma.sync m16n8k16 on bf16 operands (ldmatrix from shared memory) with
// float32 accumulators: the products are exact, only the order of the sums
// differs. P is float32 in [0, 1]; P V runs as two bf16 MMAs, P's bf16
// value and the bf16 value of its remainder (about 16 bits of P): P cut to
// bf16's 8 bits misses the one-ulp bar. The score fragments feed the P V
// operand fragments directly, in registers. A key past a row's lim has
// p = 0 there, an exact 0 times a finite V. A tile whose V holds an
// infinity or a NaN takes P V on the FMA units instead, float32 p times
// each V word (P's words come from the quad by shuffles), leaving out the
// keys past each row's lim: on the tensor cores the remainder's product
// would multiply an infinity by 0 or by either sign, where the reference
// has p > 0 times it.
//
// Both: K and V tiles are double-buffered with cp.async (16-byte copies
// where D and the pointers allow, plain loads otherwise): tile t + 1 loads,
// into the buffers tile t - 1 left, while tile t computes. The grid runs
// heads fastest, so the longest causal rows of every head start first.
//
// Bound: operations (4 D per live query-key pair: 8.6 GFLOP at
// (32, 1024, 128) causal) against 67 TFLOP/s of float32 FMA; in bfloat16
// the bytes (33.5 MB at 3.35 TB/s) against the tensor cores' 989 TFLOP/s.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_ptx.cuh"

namespace {

constexpr int kBK = 64;                   // keys per tile
constexpr int kMaxD = 128;
constexpr float kNegInf = static_cast<float>(-0.7 * 3.4028234663852886e38);

// the keys row reads lie below this: its q-block's live key blocks
__device__ __forceinline__ int key_limit(int row, int S, int causal, int blk_q,
                                         int blk_k) {
  if (!causal) return S;
  const int last = row / blk_q * blk_q + blk_q - 1;
  return min(S, (last / blk_k + 1) * blk_k);
}

// score x of key for row (key limit lim): -inf past lim (p = 0, and P V
// leaves the key out), NEG_INF where masked
__device__ __forceinline__ float mask_score(float x, int key, int row, int lim,
                                            int causal) {
  return key >= lim ? -INFINITY : causal && key > row ? kNegInf : x;
}

// ---------------------------------------------------------------------------
// float32
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;          // 16 x 16
constexpr int kRT = 8;                    // query rows per thread

template <int DMAX>
struct F32Tile {
  static constexpr int BQ = 16 * kRT;     // query rows per CTA
  static constexpr int QS = DMAX + 4;     // Q, K row stride: QS / 4 odd, so
                                          // 16-byte loads meet 32 banks
  static constexpr int VS = DMAX;
  static constexpr int PS = BQ + 4;       // row stride of the transposed P
  static constexpr int DT = DMAX / 16;    // output dims per thread
  static constexpr int VW = DT < 4 ? DT : 4;
  // P takes the K buffer of its own tile where it fits
  static constexpr bool kAlias = QS >= PS;
  static constexpr int kQ = 0;
  static constexpr int kK = BQ * QS;                   // two buffers
  static constexpr int kV = kK + 2 * kBK * QS;         // two buffers
  static constexpr int kP = kV + 2 * kBK * VS;
  static constexpr int kFloats = kAlias ? kP : kP + kBK * PS;
};

// Walks the (row, column) cells of a ROWS x cols tile, cell threadIdx.x +
// THREADS n for n = 0, 1, ...: one division per tile, none per cell.
template <int ROWS, int THREADS, typename F>
__device__ __forceinline__ void for_cells(int cols, F&& cell) {
  int r = static_cast<int>(threadIdx.x) / cols;
  int c = static_cast<int>(threadIdx.x) - r * cols;
  const int dr = THREADS / cols, dc = THREADS - dr * cols;
  while (r < ROWS) {
    cell(r, c);
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

// rows r0 .. r0 + ROWS - 1 of a (S, D) float32 matrix into shared memory
// at row stride STRIDE, columns 0 .. D-1 (0 .. dp4-1 on the plain-load
// path, zeros past D); rows past S are zeros
template <int ROWS, int STRIDE>
__device__ __forceinline__ void load_f32(float* dst, const float* src, int r0,
                                         int S, int D, int dp4, int vec) {
  if (vec) {
    for_cells<ROWS, kF32Threads>(D >> 2, [&](int r, int c) {
      float* d = dst + r * STRIDE + 4 * c;
      if (r0 + r < S)
        ptx::cp_async16(d, src + static_cast<size_t>(r0 + r) * D + 4 * c);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    });
  } else {
    for_cells<ROWS, kF32Threads>(dp4, [&](int r, int c) {
      dst[r * STRIDE + c] = r0 + r < S && c < D
          ? src[static_cast<size_t>(r0 + r) * D + c] : 0.0f;
    });
  }
}

// whether the cells this thread loaded with load_f32 (after it waited for
// its copies) hold an infinity or a NaN: an all-ones exponent field plus
// one carries into the sign bit
template <int ROWS, int STRIDE>
__device__ __forceinline__ bool own_nonfinite_f32(const float* buf, int D,
                                                  int dp4, int vec) {
  constexpr uint32_t kExp = 0x7f800000u, kOne = 0x00800000u;
  uint32_t carry = 0;
  if (vec) {
    for_cells<ROWS, kF32Threads>(D >> 2, [&](int r, int c) {
      const uint4 w = *reinterpret_cast<const uint4*>(buf + r * STRIDE + 4 * c);
      carry |= ((w.x & kExp) + kOne) | ((w.y & kExp) + kOne) |
               ((w.z & kExp) + kOne) | ((w.w & kExp) + kOne);
    });
  } else {
    for_cells<ROWS, kF32Threads>(dp4, [&](int r, int c) {
      carry |= (__float_as_uint(buf[r * STRIDE + c]) & kExp) + kOne;
    });
  }
  return (carry & 0x80000000u) != 0u;
}

template <int VW>
__device__ __forceinline__ void load_vec(float* dst, const float* src) {
  if constexpr (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
  } else if constexpr (VW == 2) {
    const float2 t = *reinterpret_cast<const float2*>(src);
    dst[0] = t.x; dst[1] = t.y;
  } else {
    dst[0] = src[0];
  }
}

// Scores of rows i >= I0 of the thread: s[i][j] = q_(ty + 16 i) . k_(tx +
// 16 j), as outer products of float4 loads
template <int I0, int QS>
__device__ __forceinline__ void score_rows(float (&s)[kRT][4], const float* qs,
                                           const float* kb, int ty, int tx,
                                           int dp4) {
#pragma unroll 2
  for (int d0 = 0; d0 < dp4; d0 += 4) {
    float4 a[kRT], b[4];
#pragma unroll
    for (int i = I0; i < kRT; ++i)
      a[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * QS + d0);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(kb + (tx + 16 * j) * QS + d0);
#pragma unroll
    for (int i = I0; i < kRT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = __fmaf_rn(a[i].x, b[j].x, s[i][j]);
        s[i][j] = __fmaf_rn(a[i].y, b[j].y, s[i][j]);
        s[i][j] = __fmaf_rn(a[i].z, b[j].z, s[i][j]);
        s[i][j] = __fmaf_rn(a[i].w, b[j].w, s[i][j]);
      }
  }
}

// acc[i] += sum_c P[i][c] V[c] for rows i >= I0, one outer product per key;
// GUARD: key key0 + c enters row i only below lim[i]
template <int DT, int VW, int I0, bool GUARD, int PS, int VS>
__device__ __forceinline__ void pv_rows(float (&acc)[kRT][DT], const float* pb,
                                        const float* vb, int ty, int tx,
                                        int key0, const int (&lim)[kRT]) {
#pragma unroll 4
  for (int c = 0; c < kBK; ++c) {
    float p[kRT], vv[DT];
#pragma unroll
    for (int i = I0; i < kRT; i += 4)
      load_vec<4>(p + i, pb + c * PS + kRT * ty + i);
#pragma unroll
    for (int u = 0; u < DT / VW; ++u)
      load_vec<VW>(vv + u * VW, vb + c * VS + u * 16 * VW + tx * VW);
#pragma unroll
    for (int i = I0; i < kRT; ++i) {
      const bool live = !GUARD || key0 + c < lim[i];
#pragma unroll
      for (int u = 0; u < DT; ++u) {
        const float a = __fmaf_rn(p[i], vv[u], acc[i][u]);
        acc[i][u] = live ? a : acc[i][u];
      }
    }
  }
}

// Thread (ty, tx) owns query rows ty + 16 i (i < kRT), so a warp's two ty
// read two neighbouring Q rows (distinct banks), and keys tx + 16 j.
// Transposed P stores a thread's rows contiguously: slot ty kRT + i. The
// softmax works in base 2 (scores times scale log2 e): p = 2^(s - m) is
// one subtraction and one SFU op.
template <int DMAX>
__global__ void __launch_bounds__(kF32Threads)
flash_f32(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, int S, int D,
          int causal, int blk_q, int blk_k, int vec, float scale_log2) {
  using T = F32Tile<DMAX>;
  constexpr int DT = T::DT, VW = T::VW, BQ = T::BQ;
  extern __shared__ float4 smem_f32[];
  float* sm = reinterpret_cast<float*>(smem_f32);
  const float* qs = sm + T::kQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n_qt = (S + BQ - 1) / BQ;
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.y)
                        : static_cast<int>(blockIdx.y);
  const int q0 = qt * BQ;
  // the tiles up to the largest lim of the CTA's rows, its last row's
  const int n_kt =
      (key_limit(min(q0 + BQ, S) - 1, S, causal, blk_q, blk_k) + kBK - 1) /
      kBK;
  const size_t head = static_cast<size_t>(blockIdx.x) * S * D;
  const int dp4 = (D + 3) & ~3;
  int lim[kRT];
#pragma unroll
  for (int i = 0; i < kRT; ++i)
    lim[i] = key_limit(q0 + ty + 16 * i, S, causal, blk_q, blk_k);

  // the V buffers' columns past D are never loaded: zeros
  for (int e = tid; e < 2 * kBK * T::VS; e += kF32Threads)
    if (e % T::VS >= D) sm[T::kV + e] = 0.0f;
  load_f32<BQ, T::QS>(sm + T::kQ, q + head, q0, S, D, dp4, vec);
  load_f32<kBK, T::QS>(sm + T::kK, k + head, 0, S, D, dp4, vec);
  load_f32<kBK, T::VS>(sm + T::kV, v + head, 0, S, D, dp4, vec);
  ptx::cp_async_commit();

  float acc[kRT][DT], m[kRT], l[kRT];
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int u = 0; u < DT; ++u) acc[i][u] = 0.0f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    float* kb = sm + T::kK + buf * kBK * T::QS;
    const float* vb = sm + T::kV + buf * kBK * T::VS;
    // rows ty + 16 i, i < kRT / 2, all lie before this tile's first key
    const bool half = causal && kt * kBK >= q0 + 8 * kRT;
    ptx::cp_async_wait<0>();
    // tile kt is in; tile kt - 1 done. A half tile also learns whether
    // its V holds a non-finite word.
    int v_bad = 0;
    if (half)
      v_bad = __syncthreads_or(
          own_nonfinite_f32<kBK, T::VS>(vb, D, dp4, vec));
    else
      __syncthreads();
    if (kt + 1 < n_kt) {                  // tile kt + 1 into kt - 1's buffers
      load_f32<kBK, T::QS>(sm + T::kK + (buf ^ 1) * kBK * T::QS, k + head,
                           (kt + 1) * kBK, S, D, dp4, vec);
      load_f32<kBK, T::VS>(sm + T::kV + (buf ^ 1) * kBK * T::VS, v + head,
                           (kt + 1) * kBK, S, D, dp4, vec);
      ptx::cp_async_commit();
    }
    // only a tile that reaches past S or past the CTA's first row masks
    const bool edge = (kt + 1) * kBK > S ||
                      (causal && (kt + 1) * kBK - 1 > q0);
    // a tile that reaches past one of the thread's lims (lim[0] the least)
    const bool guard = lim[0] < (kt + 1) * kBK;

    float s[kRT][4];
#pragma unroll
    for (int i = 0; i < kRT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    if (half) score_rows<kRT / 2, T::QS>(s, qs, kb, ty, tx, dp4);
    else score_rows<0, T::QS>(s, qs, kb, ty, tx, dp4);

#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = s[i][j] * scale_log2;
        s[i][j] = edge ? mask_score(x, kt * kBK + tx + 16 * j, row, lim[i],
                                    causal)
                       : x;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = ptx::exp2_approx(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = ptx::exp2_approx(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int u = 0; u < DT; ++u) acc[i][u] *= alpha;
    }
    float* pb = T::kAlias ? kb : sm + T::kP;
    if constexpr (T::kAlias) __syncthreads();  // every warp is done with K
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < kRT; i += 4)
        *reinterpret_cast<float4*>(pb + (tx + 16 * j) * T::PS + kRT * ty + i) =
            make_float4(s[i][j], s[i + 1][j], s[i + 2][j], s[i + 3][j]);
    __syncthreads();
    // the first half's p are all exact zeros (NEG_INF or -inf scores, a
    // running max above NEG_INF / 2); they may skip a finite V
    bool skip = half && !v_bad;
#pragma unroll
    for (int i = 0; i < kRT / 2; ++i) skip = skip && m[i] > 0.5f * kNegInf;
    const int key0 = kt * kBK;
    if (guard) {
      if (skip)
        pv_rows<DT, VW, kRT / 2, true, T::PS, T::VS>(acc, pb, vb, ty, tx,
                                                      key0, lim);
      else
        pv_rows<DT, VW, 0, true, T::PS, T::VS>(acc, pb, vb, ty, tx, key0,
                                               lim);
    } else {
      if (skip)
        pv_rows<DT, VW, kRT / 2, false, T::PS, T::VS>(acc, pb, vb, ty, tx,
                                                       key0, lim);
      else
        pv_rows<DT, VW, 0, false, T::PS, T::VS>(acc, pb, vb, ty, tx, key0,
                                                lim);
    }
  }

#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int u = 0; u < DT; ++u) {
      const int d = (u / VW) * 16 * VW + tx * VW + u % VW;
      if (d < D) o[head + static_cast<size_t>(row) * D + d] = acc[i][u] / den;
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16
// ---------------------------------------------------------------------------

constexpr int kB16Warps = 8;              // 16 query rows each

template <int DMAX>
struct B16Tile {
  static constexpr int BQ = 16 * kB16Warps;   // query rows per CTA
  static constexpr int kThreads = 32 * kB16Warps;
  static constexpr int RS = DMAX + 8;     // row stride in bf16: 16-byte rows
                                          // at an odd multiple of 16 bytes,
                                          // so ldmatrix meets 32 banks
  static constexpr int kQ = 0;
  static constexpr int kK = BQ * RS;                   // two buffers
  static constexpr int kV = kK + 2 * kBK * RS;         // two buffers
  static constexpr int kElems = kV + 2 * kBK * RS;
};

template <int ROWS, int RS, int THREADS>
__device__ __forceinline__ void load_b16(__nv_bfloat16* dst,
                                         const __nv_bfloat16* src, int r0,
                                         int S, int D, int vec) {
  if (vec) {
    for_cells<ROWS, THREADS>(D >> 3, [&](int r, int c) {
      __nv_bfloat16* d = dst + r * RS + 8 * c;
      if (r0 + r < S)
        ptx::cp_async16(d, src + static_cast<size_t>(r0 + r) * D + 8 * c);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    });
  } else {
    for_cells<ROWS, THREADS>(D, [&](int r, int c) {
      dst[r * RS + c] = r0 + r < S ? src[static_cast<size_t>(r0 + r) * D + c]
                                   : __float2bfloat16_rn(0.0f);
    });
  }
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16;
}

// P's two elements as bf16: their bf16 values (hi) and the bf16 values of
// what those leave (lo)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0);
  const __nv_bfloat16 h1 = __float2bfloat16_rn(x1);
  hi = pack_bf16(h0, h1);
  lo = pack_bf16(__float2bfloat16_rn(x0 - __bfloat162float(h0)),
                 __float2bfloat16_rn(x1 - __bfloat162float(h1)));
}

// whether the cells this thread loaded with load_b16 (after it waited for
// its copies) hold an infinity or a NaN: an all-ones exponent field plus
// one carries into the bf16's sign bit
template <int ROWS, int RS, int THREADS>
__device__ __forceinline__ bool own_nonfinite_b16(const __nv_bfloat16* buf,
                                                  int D, int vec) {
  constexpr uint32_t kExp = 0x7f807f80u, kOne = 0x00800080u;
  uint32_t carry = 0;
  if (vec) {
    for_cells<ROWS, THREADS>(D >> 3, [&](int r, int c) {
      const uint4 w = *reinterpret_cast<const uint4*>(buf + r * RS + 8 * c);
      carry |= ((w.x & kExp) + kOne) | ((w.y & kExp) + kOne) |
               ((w.z & kExp) + kOne) | ((w.w & kExp) + kOne);
    });
  } else {
    for_cells<ROWS, THREADS>(D, [&](int r, int c) {
      carry |= (__bfloat16_as_ushort(buf[r * RS + c]) & kExp) + kOne;
    });
  }
  return (carry & 0x80008000u) != 0u;
}

// oacc += P V over one 64-key tile on the tensor cores (P: the warp's
// score fragments s; V in shared memory at row stride RS)
template <int KD, int RS>
__device__ __forceinline__ void pv_mma(float (&oacc)[KD][4],
                                       const float (&s)[kBK / 8][4],
                                       const __nv_bfloat16* vb, int lane) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    uint32_t ah[4], al[4];
    split_bf16(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
    split_bf16(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
    split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], al[2]);
    split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
    for (int dp = 0; dp < KD / 2; ++dp) {
      uint32_t b[4];
      ptx::ldmatrix_x4_trans(
          b, vb + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                 16 * dp + (lane >> 4) * 8);
      ptx::mma_bf16_16816(oacc[2 * dp], ah, b[0], b[1]);
      ptx::mma_bf16_16816(oacc[2 * dp], al, b[0], b[1]);
      ptx::mma_bf16_16816(oacc[2 * dp + 1], ah, b[2], b[3]);
      ptx::mma_bf16_16816(oacc[2 * dp + 1], al, b[2], b[3]);
    }
  }
}

// The same on the FMA units, float32 p times each V word, for a tile whose
// V holds an infinity or a NaN; keys at or past a row's lim (lim0: row g,
// lim1: row g + 8) are left out. Key 8 n + j's p comes from lane tig =
// j / 2 of the quad.
template <int KD, int RS>
__device__ __forceinline__ void pv_fma(float (&oacc)[KD][4],
                                       const float (&s)[kBK / 8][4],
                                       const __nv_bfloat16* vb, int lane,
                                       int key0, int lim0, int lim1) {
  const int tig = lane & 3;
#pragma unroll
  for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll 1
    for (int j = 0; j < 8; ++j) {
      const int src = (lane & ~3) | (j >> 1);
      const float p0 = __shfl_sync(0xffffffffu, j & 1 ? s[n][1] : s[n][0], src);
      const float p1 = __shfl_sync(0xffffffffu, j & 1 ? s[n][3] : s[n][2], src);
      const int key = 8 * n + j;
      const bool live0 = key0 + key < lim0, live1 = key0 + key < lim1;
      const __nv_bfloat16* vrow = vb + key * RS + 2 * tig;
#pragma unroll
      for (int d = 0; d < KD; ++d) {
        const __nv_bfloat162 w =
            *reinterpret_cast<const __nv_bfloat162*>(vrow + 8 * d);
        const float v0 = __low2float(w), v1 = __high2float(w);
        const float a0 = __fmaf_rn(p0, v0, oacc[d][0]);
        const float a1 = __fmaf_rn(p0, v1, oacc[d][1]);
        const float a2 = __fmaf_rn(p1, v0, oacc[d][2]);
        const float a3 = __fmaf_rn(p1, v1, oacc[d][3]);
        oacc[d][0] = live0 ? a0 : oacc[d][0];
        oacc[d][1] = live0 ? a1 : oacc[d][1];
        oacc[d][2] = live1 ? a2 : oacc[d][2];
        oacc[d][3] = live1 ? a3 : oacc[d][3];
      }
    }
  }
}

// Scores are kept in base 2 (s * scale * log2 e) so that p = 2^(s - m)
// and alpha = 2^(m - m') are one subtraction and one SFU op each.
template <int DMAX>
__global__ void __launch_bounds__(32 * kB16Warps)
flash_b16(const __nv_bfloat16* __restrict__ q,
          const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
          int S, int D, int causal, int blk_q, int blk_k, int vec,
          float scale_log2) {
  using T = B16Tile<DMAX>;
  constexpr int RS = T::RS, BQ = T::BQ, NT = T::kThreads;
  constexpr int kSteps = DMAX / 16;       // k-steps of Q K^T
  constexpr int kDTiles = DMAX / 8;       // n-tiles of the output
  constexpr int kKTiles = kBK / 8;        // n-tiles of the scores
  extern __shared__ uint4 smem_b16[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_b16);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int n_qt = (S + BQ - 1) / BQ;
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.y)
                        : static_cast<int>(blockIdx.y);
  const int q0 = qt * BQ;
  // the tiles up to the largest lim of the CTA's rows, its last row's
  const int n_kt =
      (key_limit(min(q0 + BQ, S) - 1, S, causal, blk_q, blk_k) + kBK - 1) /
      kBK;
  const size_t head = static_cast<size_t>(blockIdx.x) * S * D;

  // columns past D are never loaded: zeros, in Q and both K and V buffers
  for (int e = tid; e < T::kElems / RS * DMAX; e += NT) {
    const int r = e / DMAX, c = e - r * DMAX;
    if (c >= D) sm[r * RS + c] = __float2bfloat16_rn(0.0f);
  }
  load_b16<BQ, RS, NT>(sm + T::kQ, q + head, q0, S, D, vec);
  load_b16<kBK, RS, NT>(sm + T::kK, k + head, 0, S, D, vec);
  load_b16<kBK, RS, NT>(sm + T::kV, v + head, 0, S, D, vec);
  ptx::cp_async_commit();

  uint32_t qa[kSteps][4];
  float oacc[kDTiles][4], m[2], l[2];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) oacc[n][c] = 0.0f;
  m[0] = m[1] = kNegInf;
  l[0] = l[1] = 0.0f;
  const int w0 = q0 + 16 * warp;                 // the warp's first row
  const int row_base = w0 + g;                   // rows row_base, +8
  const int lim[2] = {key_limit(row_base, S, causal, blk_q, blk_k),
                      key_limit(row_base + 8, S, causal, blk_q, blk_k)};

  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    const __nv_bfloat16* kb = sm + T::kK + buf * kBK * RS;
    const __nv_bfloat16* vb = sm + T::kV + buf * kBK * RS;
    ptx::cp_async_wait<0>();
    // tile kt is in, tile kt - 1 done, and whether V holds a non-finite
    // word
    const int v_bad =
        __syncthreads_or(own_nonfinite_b16<kBK, RS, NT>(vb, D, vec));
    if (kt + 1 < n_kt) {                  // tile kt + 1 into kt - 1's buffers
      load_b16<kBK, RS, NT>(sm + T::kK + (buf ^ 1) * kBK * RS, k + head,
                            (kt + 1) * kBK, S, D, vec);
      load_b16<kBK, RS, NT>(sm + T::kV + (buf ^ 1) * kBK * RS, v + head,
                            (kt + 1) * kBK, S, D, vec);
      ptx::cp_async_commit();
    }
    if (kt == 0) {
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks)
        ptx::ldmatrix_x4(qa[ks], sm + T::kQ + (16 * warp + (lane & 15)) * RS +
                                     16 * ks + (lane >> 4) * 8);
    }

    float s[kKTiles][4];
#pragma unroll
    for (int n = 0; n < kKTiles; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
      for (int np = 0; np < kKTiles / 2; ++np) {
        const int key = 16 * np + (lane & 7) + ((lane >> 4) << 3);
        uint32_t b[4];
        ptx::ldmatrix_x4(b, kb + key * RS + 16 * ks + ((lane >> 3) & 1) * 8);
        ptx::mma_bf16_16816(s[2 * np], qa[ks], b[0], b[1]);
        ptx::mma_bf16_16816(s[2 * np + 1], qa[ks], b[2], b[3]);
      }

    // s[n][c]: row row_base + 8 (c >> 1), key kt 64 + 8 n + 2 tig + (c & 1);
    // only a tile that reaches past S or past the warp's first row masks
    const bool edge = (kt + 1) * kBK > S ||
                      (causal && (kt + 1) * kBK - 1 > w0);
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_base + 8 * h;
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < kKTiles; ++n)
#pragma unroll
        for (int c = 2 * h; c < 2 * h + 2; ++c) {
          const float x = s[n][c] * scale_log2;
          s[n][c] = edge ? mask_score(x, kt * kBK + 8 * n + 2 * tig + (c & 1),
                                      row, lim[h], causal)
                         : x;
          mx = fmaxf(mx, s[n][c]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      alpha[h] = ptx::exp2_approx(m[h] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int n = 0; n < kKTiles; ++n)
#pragma unroll
        for (int c = 2 * h; c < 2 * h + 2; ++c) {
          s[n][c] = ptx::exp2_approx(s[n][c] - m_new);
          sum += s[n][c];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[h] = alpha[h] * l[h] + sum;
      m[h] = m_new;
    }
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }

    if (v_bad)
      pv_fma<kDTiles, RS>(oacc, s, vb, lane, kt * kBK, lim[0], lim[1]);
    else
      pv_mma<kDTiles, RS>(oacc, s, vb, lane);
  }

  const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = row_base + 8 * (c >> 1);
      const int d = 8 * n + 2 * tig + (c & 1);
      if (row < S && d < D)
        o[head + static_cast<size_t>(row) * D + d] =
            __float2bfloat16_rn(oacc[n][c] / den[c >> 1]);
    }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int DMAX>
constexpr size_t f32_smem() {
  return sizeof(float) * F32Tile<DMAX>::kFloats;
}
template <int DMAX>
constexpr size_t b16_smem() { return 2 * B16Tile<DMAX>::kElems; }

// the widest heads take the most; an H100 block may use 227 KiB
static_assert(f32_smem<kMaxD>() <= 232448 && b16_smem<kMaxD>() <= 232448,
              "a flash CTA needs more shared memory than a block may use");

int dmax_of(int D) { return D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : 128; }

template <int DMAX>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           int bh, int S, int D, int causal, int blk_q, int blk_k, int vec,
           cudaStream_t stream) {
  // the scores' scale 1/sqrt(D) times log2 e: the softmax works in base 2
  const float scale_log2 = static_cast<float>(
      1.4426950408889634 / std::sqrt(static_cast<double>(D)));
  if (dtype == 0) {
    constexpr int kRowsPerCta = F32Tile<DMAX>::BQ;
    // heads fastest: the longest causal rows of every head start first
    const dim3 grid(bh, (S + kRowsPerCta - 1) / kRowsPerCta);
    constexpr size_t smem = f32_smem<DMAX>();
    // raised once per instantiation, on its first launch
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_f32<DMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    flash_f32<DMAX><<<grid, kF32Threads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), S, D, causal,
        blk_q, blk_k, vec, scale_log2);
  } else {
    using T = B16Tile<DMAX>;
    const dim3 grid(bh, (S + T::BQ - 1) / T::BQ);
    constexpr size_t smem = b16_smem<DMAX>();
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_b16<DMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    flash_b16<DMAX><<<grid, T::kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), S, D, causal, blk_q, blk_k, vec,
        scale_log2);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: (bh, S, D) contiguous, float32 (dtype 0) or bfloat16 (1);
// 1 <= D <= 128; S a multiple of blk_q and blk_k; vec != 0: D a multiple
// of 16 bytes' elements (4 float32, 8 bfloat16) and every pointer 16-byte
// aligned, so rows load as 16-byte copies.
extern "C" int egpu_flash_attention(int dtype, const void* q, const void* k,
                                    const void* v, void* o, int bh, int S,
                                    int D, int causal, int blk_q, int blk_k,
                                    int vec, void* stream) {
  if (bh == 0 || S == 0) return 0;
  if (D < 1 || D > kMaxD || blk_q < 1 || blk_k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dmax_of(D)) {
    case 16:
      return launch<16>(dtype, q, k, v, o, bh, S, D, causal, blk_q, blk_k,
                        vec, s);
    case 32:
      return launch<32>(dtype, q, k, v, o, bh, S, D, causal, blk_q, blk_k,
                        vec, s);
    case 64:
      return launch<64>(dtype, q, k, v, o, bh, S, D, causal, blk_q, blk_k,
                        vec, s);
    default:
      return launch<128>(dtype, q, k, v, o, bh, S, D, causal, blk_q, blk_k,
                         vec, s);
  }
}
