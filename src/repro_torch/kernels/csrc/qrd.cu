// Batched modified Gram-Schmidt QR with one re-orthogonalisation pass.
//
// Replaces: src/repro/kernels/mgs_qrd.py:61, mgs_qrd (its pallas_call, at
// line 72, over (block_b, n, n) f32 blocks resident in fast memory for the
// whole factorisation; columns selected by a one-hot mask, norms by
// rsqrt).
//
// Bound on this card: neither bytes nor arithmetic. A matrix moves 12 n^2
// bytes against about 6 n^3 operations (the projection needs only the j
// finished columns of Q; the kernel also runs the zero ones, which add
// nothing), but every operation is a rounded FP32 multiply or add in a
// serial chain (each inner product is one lane's loop, in the plain
// version's order, with no FMA), so the kernel is bound by instruction
// issue and the latency of those chains. The design spends as few
// instructions as it can on anything but that arithmetic:
//
// Layout: a group of NP lanes per matrix (NP = 8, 16 or 32; n <= NP), so
// 32 / NP matrices to a warp and four warps to a CTA; one instantiation per
// order n = 1...32, so no guard on n is left at run time (with n a run-time
// value, QRD-16 and QRD-32 ran 1.8x and 2.6x slower on an H100). Nothing is
// kept in shared memory and there is no block barrier. Lane k holds column
// k of the residual, of Q and of R in registers; lane i also holds row i of
// Q, so that both inner products of the projection are one lane's serial
// sum. Operands reach the other lanes of a group by shuffles (width NP).
// For column j:
//   1. aj = res[:, j]: lane j's column, broadcast element by element
//   2. coeff[k] = sum_i q[i][k] aj[i]                  (lane k, its column)
//   3. corr[i] = sum_k q[i][k] coeff[k]                (lane i, its row;
//      coeff broadcast), and r[:, j] += coeff          (lane j)
//   4. aj -= corr on every lane, res[:, j] -= corr on lane j (corr
//      broadcast)
//   5. nrm2 = sum_i aj[i]^2, recip = INVSQR(nrm2), qj = aj recip: on every
//      lane alike, giving the same words on each, so no lane waits
//   6. rrow[k] = sum_i qj[i] res[i][k]; res[:, k] -= qj rrow[k]   (lane k)
//   7. q[:, j] += qj (lane j), q[i][j] += qj[i] (lane i, the row copy),
//      r[j][k] += rrow[k] (lane k)
// Every inner product is one lane's loop from +0.0, index 0 first, with one
// rounding per multiply and per add (__f*_rn, -fmad=false): the order of
// the plain version (kernels/ref.py, mgs_qrd_ref), which it equals word for
// word. INVSQR is the shared header's correctly rounded 1/sqrt. The column
// loop is not unrolled (the code of one column stays in the instruction
// cache: fully unrolled, QRD-16 and QRD-32 ran 1.2x and 1.9x slower on an
// H100); the loops over a column's elements are, so register arrays are
// indexed by constants. The element of row j (q[g][j], r[j][g]) is reached
// by a tree of uniform branches on j (add_at2), the lane's own qj[g] by a
// select per element. Loads and stores go by rows: for row i, lane k
// touches element [i][k], so neighbouring lanes touch neighbouring words.
// Lanes past n and groups past the batch take part in every shuffle and
// vote, count in no vote and store nothing.
//
// Non-finite factors: the reference selects and updates column j and row j
// by one-hot products, so a non-finite factor turns every entry it meets
// with a 0 into NaN. Lane-local tests over the broadcast vectors, and votes
// masked to the group, write those NaNs: aj[i] where row i of the residual
// holds a non-finite word off column j (one vote per row, taken only once a
// non-finite word has entered some group's residual, a sticky flag per
// group); rows of the residual and of R off column j where corr[i] and
// coeff[i] are non-finite; Q off column j, in both layouts, where qj[i] is;
// column k of R off row j where rrow[k] is. Finite input takes none of
// these branches and gives the same words as without them.
#include <cstdint>
#include <utility>
#include <cuda_runtime.h>

#include "egpu_fp32.cuh"

namespace {

constexpr int kMaxN = 32;
constexpr int kThreads = 128;            // four warps to a CTA
constexpr unsigned kWarp = 0xFFFFFFFFu;

// v[j] += x and w[j] += y for a j known only at run time and the same on
// every lane of the warp: a tree of uniform branches on j reaches a leaf
// whose indices are constants, so v and w stay in registers
template <int LO, int HI, int NP>
__device__ __forceinline__ void add_at2(float (&v)[NP], float x,
                                        float (&w)[NP], float y, int j) {
  if constexpr (HI - LO == 1) {
    v[LO] = __fadd_rn(v[LO], x);
    w[LO] = __fadd_rn(w[LO], y);
  } else {
    constexpr int kMid = (LO + HI) / 2;
    if (j < kMid)
      add_at2<LO, kMid>(v, x, w, y, j);
    else
      add_at2<kMid, HI>(v, x, w, y, j);
  }
}

// lanes to a matrix of order n
__host__ __device__ constexpr int group_size(int n) {
  return n <= 8 ? 8 : n <= 16 ? 16 : 32;
}

// one instantiation per order n, so every guard on n folds away
template <int n>
__global__ void __launch_bounds__(kThreads)
qrd_kernel(const float* __restrict__ a, float* __restrict__ qo,
           float* __restrict__ ro, int batch) {
  constexpr int NP = group_size(n);
  const int lane = threadIdx.x & 31;
  const int g = lane & (NP - 1);       // this lane's column, and row of Q
  const int gbase = lane - g;
  const unsigned gmask =
      NP == 32 ? kWarp : ((1u << (NP & 31)) - 1u) << gbase;
  const int mat = blockIdx.x * (kThreads / NP) + threadIdx.x / NP;
  const bool mine = mat < batch && g < n;  // a column of a matrix
  const float nan = __int_as_float(0x7FC00000);
  const size_t base = static_cast<size_t>(mat) * n * n;
  // a warp-wide vote, cut to this group's bits (bit i: lane i of the group)
  const auto vote = [&](bool p) {
    return (__ballot_sync(kWarp, p) & gmask) >> gbase;
  };

  float res[NP], qc[NP], rc[NP], qr[NP], aj[NP];
  bool bad = false;             // this lane's column has held a non-finite
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    res[i] = mine && i < n ? a[base + i * n + g] : 0.0f;
    bad |= !isfinite(res[i]);
    qc[i] = rc[i] = qr[i] = aj[i] = 0.0f;
  }
  // a non-finite word stays non-finite through every update, so the flag
  // only ever sets
  bool res_bad = vote(mine && bad) != 0u;
#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    const bool on_j = g == j;
    // 1. aj = res[:, j]; NaN where row i is non-finite off column j (a
    // group whose flag is clear has no such row)
#pragma unroll
    for (int i = 0; i < NP; ++i)
      if (i < n) aj[i] = __shfl_sync(kWarp, res[i], j, NP);
    if (__any_sync(kWarp, res_bad)) {
      unsigned bad_rows = 0u;
#pragma unroll
      for (int i = 0; i < NP; ++i)
        if (i < n && vote(mine && !on_j && !isfinite(res[i])))
          bad_rows |= 1u << i;
#pragma unroll
      for (int i = 0; i < NP; ++i)
        if (bad_rows >> i & 1u) aj[i] = nan;
    }
    // 2. coeff[g] = <q[:, g], aj>
    float coeff = 0.0f;
#pragma unroll
    for (int i = 0; i < NP; ++i)
      if (i < n)
        coeff = __fadd_rn(coeff, __fmul_rn(qc[i], aj[i]));
    // 3. corr[g] = <q[g, :], coeff>; r[:, j] += coeff
    float corr = 0.0f;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      if (k < n) {
        const float c = __shfl_sync(kWarp, coeff, k, NP);
        corr = __fadd_rn(corr, __fmul_rn(qr[k], c));
        if (on_j) rc[k] = __fadd_rn(rc[k], c);
      }
    }
    const unsigned coeff_bad = vote(mine && !isfinite(coeff));
    const unsigned corr_bad = vote(mine && !isfinite(corr));
    // 4. aj -= corr; res[:, j] -= corr
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      if (i < n) {
        const float c = __shfl_sync(kWarp, corr, i, NP);
        aj[i] = __fsub_rn(aj[i], c);
        if (on_j) res[i] = __fsub_rn(res[i], c);
      }
    }
    if ((coeff_bad | corr_bad) && !on_j) {
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        if (corr_bad >> i & 1u) res[i] = nan;
        if (coeff_bad >> i & 1u) rc[i] = nan;
      }
    }
    // 5. nrm2, recip and qj (kept in aj from here on) on every lane alike
    float nrm2 = 0.0f;
#pragma unroll
    for (int i = 0; i < NP; ++i)
      if (i < n) nrm2 = __fadd_rn(nrm2, __fmul_rn(aj[i], aj[i]));
    const float recip =
        __uint_as_float(egpu::invsqr(__float_as_uint(nrm2)));
    float qj_g = 0.0f;          // qj[g], for this lane's row of Q
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      if (i < n) {
        aj[i] = __fmul_rn(aj[i], recip);
        if (g == i) qj_g = aj[i];
      }
    }
    const unsigned qj_bad = vote(mine && !isfinite(qj_g));
    // 6. rrow[g] = <qj, res[:, g]>; res[:, g] -= qj rrow[g]
    float rrow = 0.0f;
#pragma unroll
    for (int i = 0; i < NP; ++i)
      if (i < n) rrow = __fadd_rn(rrow, __fmul_rn(aj[i], res[i]));
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      if (i < n) {
        res[i] = __fsub_rn(res[i], __fmul_rn(aj[i], rrow));
        bad |= !isfinite(res[i]);
      }
    }
    // 7. Q in both layouts; row j of R
    if (on_j) {
#pragma unroll
      for (int i = 0; i < NP; ++i)
        if (i < n) qc[i] = __fadd_rn(qc[i], aj[i]);
    }
    add_at2<0, n>(qr, qj_g, rc, rrow, j);
    if (qj_bad && !on_j) {
#pragma unroll
      for (int i = 0; i < NP; ++i)
        if (qj_bad >> i & 1u) qc[i] = nan;
    }
    if (!isfinite(qj_g)) {
#pragma unroll
      for (int k = 0; k < NP; ++k)
        if (k != j) qr[k] = nan;
    }
    if (!isfinite(rrow)) {
#pragma unroll
      for (int i = 0; i < NP; ++i)
        if (i != j) rc[i] = nan;
    }
    res_bad = vote(mine && bad) != 0u;
  }
  if (mine) {
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      if (i < n) {
        qo[base + i * n + g] = qc[i];
        ro[base + i * n + g] = rc[i];
      }
    }
  }
}

using Kernel = void (*)(const float*, float*, float*, int);

// qrd_kernel<n> for n = 1...kMaxN
template <int... I>
Kernel kernel_for(int n, std::integer_sequence<int, I...>) {
  static const Kernel kernels[] = {qrd_kernel<I + 1>...};
  return kernels[n - 1];
}

}  // namespace

// a, q, r: (batch, n, n) row-major float32; n <= 32
extern "C" int egpu_mgs_qrd(const float* a, float* q, float* r, int batch,
                            int n, void* stream) {
  if (batch == 0 || n == 0) return 0;
  if (n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const int per_cta = kThreads / group_size(n);
  const int grid = (batch + per_cta - 1) / per_cta;
  const Kernel kernel =
      kernel_for(n, std::make_integer_sequence<int, kMaxN>{});
  const auto s = static_cast<cudaStream_t>(stream);
  kernel<<<grid, kThreads, 0, s>>>(a, q, r, batch);
  return static_cast<int>(cudaGetLastError());
}
