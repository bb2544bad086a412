// Batched radix-2 decimation-in-frequency FFT.
//
// Replaces: src/repro/kernels/fft_r2.py, fft_r2 (a pallas_call that keeps a
// (block_b, N) block of re/im planes in fast memory for all log2 N passes,
// with a (2, log2 N, N/2) twiddle table shared by the grid).
//
// Arithmetic: pass p (h = N/2 >> p) pairs a = (t / h) * 2h + t % h with
// b = a + h and writes u = a + b to a and v = (a - b) * w to b, with
// w = tw[p][t % h]; v_re = d_re w_re - d_im w_im, v_im = d_re w_im +
// d_im w_re, every operation an __f*_rn intrinsic (built with -fmad=false)
// in the order of the plain version (kernels/fft_r2.py, fft_r2_plain), so
// the two are equal word for word. The passes leave the spectrum in
// bit-reversed order; natural != 0 stores output i at index bitrev(i).
//
// Layout: the row lives in registers. A tile of M = G * E points (one row,
// or for N < 256 several whole rows) belongs to G threads holding E points
// each. In a phase every thread holds the points whose index bits outside
// e = log2 E "register bits" spell its thread index; the phase runs, in
// registers and with no barrier, the up to e passes whose pair bits are
// its register bits (pass p pairs index bit log2 N - 1 - p). Between
// phases the tile goes once through shared memory into the next phase's
// layout, so each trip through shared memory carries e passes:
//   * N <= 1024: a warp per tile (G = 32, E = 8, 16, 32), eight tiles per
//     CTA; only __syncwarp between phases. FFT-256: three phases (3, 3, 2
//     passes), two exchanges.
//   * 2048 <= N <= 16384: a CTA per row (E = 16, or 32 from N = 8192;
//     G = N / E threads; 8 N bytes of shared memory), __syncthreads
//     between phases.
// Shared-memory addresses are XOR-swizzled (bank = low five index bits
// XOR a mask per higher index bit, checked at compile time) so
// that every warp access of every phase, and the bit-reversed read of the
// output, meets 32 distinct banks. The output goes through shared memory
// once more: the bit reversal is applied on that read, so each thread's
// global stores are four consecutive points, 16 bytes, and a warp's stores
// are contiguous. The warp path stages the twiddles once per CTA in shared
// memory, each pass's h distinct values as one segment (pass p's table row
// repeats with period h); the CTA path reads them through the read-only
// cache: there a CTA holds one row, so staging would copy the whole N-entry
// table once per row, half again the row's own bytes (measured slower at
// FFT-4096; PERF.md).
//
// Bound: bytes (a row is read and written once: 16 bytes per point against
// 5 log2 N / 2 operations per point).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerCta = 8;          // warp path: one tile per warp
constexpr int kMaxWarpLog2 = 10;         // N <= 1024: a warp holds the tile
constexpr int kMaxLog2 = 14;             // 8 N bytes per row must fit a CTA

// five 5-bit vectors independent over GF(2)
__host__ __device__ constexpr bool independent(const int* v) {
  int basis[5] = {0, 0, 0, 0, 0};          // basis[b]: leading bit b
  for (int i = 0; i < 5; ++i) {
    int x = v[i];
    for (int b = 4; b >= 0 && x; --b) {
      if (!(x >> b & 1)) continue;
      if (!basis[b]) {
        basis[b] = x;
        break;
      }
      x ^= basis[b];
    }
    if (!x) return false;
  }
  return true;
}

template <int L>
struct Geometry {
  static constexpr int N = 1 << L;
  static constexpr bool kWarp = L <= kMaxWarpLog2;
  static constexpr int e =                                      // log2 E
      L <= 8 ? 3 : kWarp ? L - 5 : L <= 12 ? 4 : 5;
  static constexpr int E = 1 << e;
  static constexpr int g = kWarp ? 5 : L - e;                   // log2 G
  static constexpr int G = 1 << g;
  static constexpr int mb = e + g;                               // log2 M
  static constexpr int M = 1 << mb;
  static constexpr int kPhases = L == 0 ? 1 : (L + e - 1) / e;
  // the phase's pair bits are hi(k) down to lo(k)
  __host__ __device__ static constexpr int hi(int k) { return L - 1 - k * e; }
  __host__ __device__ static constexpr int lo(int k) {
    return L - e - k * e < 0 ? 0 : L - e - k * e;
  }
  // index bit of slot bit r in phase k: the pair bits, slot bit e-1 first;
  // a last phase with fewer pair bits fills up with the highest index bits
  __host__ __device__ static constexpr int reg_bit(int k, int r) {
    return L - e - k * e + r >= 0 ? L - e - k * e + r : mb - 1 - r;
  }
  __host__ __device__ static constexpr uint32_t reg_mask(int k) {
    uint32_t m = 0;
    for (int r = 0; r < e; ++r) m |= 1u << reg_bit(k, r);
    return m;
  }
  // index bit of thread bit s in phase k: the other bits, in ascending order
  __host__ __device__ static constexpr int lane_bit(int k, int s) {
    const uint32_t regs = reg_mask(k);
    for (int b = 0; b < mb; ++b)
      if (!(regs >> b & 1) && s-- == 0) return b;
    return -1;
  }
  __host__ __device__ static constexpr uint32_t reg_part(int k, int j) {
    uint32_t m = 0;
    for (int r = 0; r < e; ++r)
      m |= static_cast<uint32_t>(j >> r & 1) << reg_bit(k, r);
    return m;
  }
  // output element o of the tile reads tile index src(o): bit reversal
  // within its row when natural (linear in the bits of o)
  __host__ __device__ static constexpr int src_bit(int q, bool natural) {
    return natural && q < L ? L - 1 - q : q;
  }
  // the index bits a warp's 32 lanes vary over in access pattern pat: the
  // layout of phase pat (pat < kPhases), then the output read in
  // bit-reversed and in natural order (the lanes are bits 2..6 of o)
  __host__ __device__ static constexpr int n_patterns() { return kPhases + 2; }
  __host__ __device__ static constexpr int pattern_bit(int pat, int s) {
    return pat < kPhases ? lane_bit(pat, s) : src_bit(2 + s, pat == kPhases);
  }
};

// The swizzle: address = m ^ xmask(m >> 5), xmask(h) the XOR of the masks
// x_b (5 bits each, x_5 in the lowest bits of kSwizzle[L]) of the set bits
// b of h. Under these masks the five index bits that a warp's lanes vary
// over in every access pattern map to five independent bank vectors, so
// each warp access meets 32 banks. They are the first fit of a
// depth-first search over 1..31 per mask; the static_assert checks them.
constexpr uint64_t kSwizzle[kMaxLog2 + 1] = {
    0x441, 0x441, 0x441, 0x4a2, 0x945, 0x1249, 0x3241, 0x60a3, 0x4145,
    0x820a3, 0x1041041, 0x21a3041, 0x428c1041, 0x843041041, 0x10883041041};

__host__ __device__ constexpr int bank_vec(uint64_t x, int b) {
  return b < 5 ? 1 << b : static_cast<int>(x >> (5 * (b - 5)) & 31);
}

template <int L>
__host__ __device__ constexpr bool swizzle_fits(uint64_t x) {
  using Q = Geometry<L>;
  for (int pat = 0; pat < Q::n_patterns(); ++pat) {
    int v[5] = {0, 0, 0, 0, 0};
    for (int s = 0; s < 5; ++s) v[s] = bank_vec(x, Q::pattern_bit(pat, s));
    if (!independent(v)) return false;
  }
  return true;
}

template <int L>
struct Plan : Geometry<L> {
  static constexpr uint64_t kX = kSwizzle[L];
  static_assert(swizzle_fits<L>(kX), "a warp access meets a bank twice");
  __host__ __device__ static constexpr uint32_t swz(uint32_t m) {
    uint32_t x = 0;
    for (int b = 5; b < Geometry<L>::mb; ++b)
      if (m >> b & 1) x ^= static_cast<uint32_t>(bank_vec(kX, b));
    return m ^ x;
  }
};

__device__ __forceinline__ void butterfly(float& ar, float& ai, float& br,
                                          float& bi, float wr, float wi) {
  const float dr = __fsub_rn(ar, br), di = __fsub_rn(ai, bi);
  ar = __fadd_rn(ar, br);
  ai = __fadd_rn(ai, bi);
  br = __fsub_rn(__fmul_rn(dr, wr), __fmul_rn(di, wi));
  bi = __fadd_rn(__fmul_rn(dr, wi), __fmul_rn(di, wr));
}

template <int L>
__device__ __forceinline__ void tile_sync() {
  if constexpr (Plan<L>::kWarp) __syncwarp();
  else __syncthreads();
}

// the thread's part of a phase-k index (its bits on the phase's lane bits)
template <int L>
__device__ __forceinline__ uint32_t lane_part(int k, uint32_t t) {
  using P = Plan<L>;
  uint32_t m = 0;
#pragma unroll
  for (int s = 0; s < P::g; ++s) m |= (t >> s & 1u) << P::lane_bit(k, s);
  return m;
}

template <int L>
__global__ void __launch_bounds__(Plan<L>::kWarp ? 32 * kWarpsPerCta
                                                 : Plan<L>::G)
fft_kernel(const float* __restrict__ tw, const float* __restrict__ re,
           const float* __restrict__ im, float* __restrict__ ore,
           float* __restrict__ oim, int rows, int natural) {
  using P = Plan<L>;
  constexpr int N = P::N, E = P::E, M = P::M;
  constexpr int kRowsPerTile = M / N;
  constexpr int half = N / 2;
  extern __shared__ float smem[];
  // warp path: twiddle segments (N float2, 16-byte aligned), then each
  // warp's two planes; CTA path: the row's two planes
  float2* twz = reinterpret_cast<float2*>(smem);
  const uint32_t t = P::kWarp ? threadIdx.x & 31 : threadIdx.x;
  const int tile = P::kWarp ? blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5)
                            : blockIdx.x;
  float* sre = smem + (P::kWarp ? 2 * N + (threadIdx.x >> 5) * 2 * M : 0);
  float* sim = sre + M;
  if constexpr (P::kWarp) {
    // segment of pass p (h = N/2 >> p) at N - 2h: i in it has N - i - 1 in
    // [h, 2h)
    for (int i = threadIdx.x; i < N - 1; i += blockDim.x) {
      const int h = 1 << (31 - __clz(N - i - 1));
      const int p = L - 1 - (31 - __clz(h));
      const int pos = i - (N - 2 * h);
      twz[i] = make_float2(tw[p * half + pos], tw[(L + p) * half + pos]);
    }
    __syncthreads();
    const int tiles = (rows + kRowsPerTile - 1) / kRowsPerTile;
    if (tile >= tiles) return;
  }
  const size_t base = static_cast<size_t>(tile) * M;
  const int row0 = tile * kRowsPerTile;
  float vr[E], vi[E];

  // phase 0's layout straight from device memory (lanes on the low bits)
  {
    const uint32_t lp = lane_part<L>(0, t);
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const uint32_t m = P::reg_part(0, j) | lp;
      const bool live =
          kRowsPerTile == 1 || row0 + static_cast<int>(m >> L) < rows;
      vr[j] = live ? re[base + m] : 0.0f;
      vi[j] = live ? im[base + m] : 0.0f;
    }
  }
#pragma unroll
  for (int k = 0; k < P::kPhases; ++k) {
    const uint32_t lp = lane_part<L>(k, t);
    const uint32_t ls = P::swz(lp);
    if (k > 0) {
      tile_sync<L>();                       // the previous layout is written
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const uint32_t a = P::swz(P::reg_part(k, j)) ^ ls;
        vr[j] = sre[a];
        vi[j] = sim[a];
      }
      tile_sync<L>();                       // and read before it is reused
    }
#pragma unroll
    for (int s = 0; s < P::e; ++s) {
      const int b = P::hi(k) - s;           // this pass's pair bit
      if (b < P::lo(k) || b < 0) continue;
      const int r = P::e - 1 - s;           // its slot bit
      const int h = 1 << b;
      const int p = L - 1 - b;
#pragma unroll
      for (int j = 0; j < E; ++j) {
        if (j >> r & 1) continue;
        const uint32_t pos = (P::reg_part(k, j) | lp) & (h - 1);
        float wr, wi;
        if constexpr (P::kWarp) {
          const float2 w = twz[N - 2 * h + pos];
          wr = w.x;
          wi = w.y;
        } else {
          wr = __ldg(tw + p * half + pos);
          wi = __ldg(tw + (L + p) * half + pos);
        }
        butterfly(vr[j], vi[j], vr[j | 1 << r], vi[j | 1 << r], wr, wi);
      }
    }
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const uint32_t a = P::swz(P::reg_part(k, j)) ^ ls;
      sre[a] = vr[j];
      sim[a] = vi[j];
    }
  }
  tile_sync<L>();

  // output element o = c * 4G + 4t + q reads src(o), linear in o's bits:
  // the thread's part once, the constant parts at compile time
  const bool nat = natural != 0;
  uint32_t tn = 0, ti = 0;
#pragma unroll
  for (int s = 0; s < P::g; ++s) {
    tn |= (t >> s & 1u) << P::src_bit(2 + s, true);
    ti |= (t >> s & 1u) << P::src_bit(2 + s, false);
  }
  const uint32_t ts = P::swz(nat ? tn : ti);
  constexpr int kChunks = M / (4 * P::G);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    float outr[4], outi[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t o = static_cast<uint32_t>(c * 4 * P::G + q);
      uint32_t cn = 0;
#pragma unroll
      for (int bit = 0; bit < P::mb; ++bit)
        if (o >> bit & 1u) cn |= 1u << P::src_bit(bit, true);
      const uint32_t a = (nat ? P::swz(cn) : P::swz(o)) ^ ts;
      outr[q] = sre[a];
      outi[q] = sim[a];
    }
    const uint32_t o = c * 4 * P::G + 4 * t;
    if constexpr (L >= 2) {
      if (kRowsPerTile > 1 && row0 + static_cast<int>(o >> L) >= rows) continue;
      *reinterpret_cast<float4*>(ore + base + o) =
          make_float4(outr[0], outr[1], outr[2], outr[3]);
      *reinterpret_cast<float4*>(oim + base + o) =
          make_float4(outi[0], outi[1], outi[2], outi[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (row0 + static_cast<int>((o + q) >> L) >= rows) continue;
        ore[base + o + q] = outr[q];
        oim[base + o + q] = outi[q];
      }
    }
  }
}

// dynamic shared memory of one CTA, in bytes
template <int L>
constexpr size_t smem_bytes() {
  using P = Plan<L>;
  return P::kWarp ? sizeof(float) * (2 * P::N + kWarpsPerCta * 2 * P::M)
                  : sizeof(float) * 2 * P::M;
}

template <int L>
int launch(const float* tw, const float* re, const float* im, float* ore,
           float* oim, int rows, int natural, cudaStream_t stream) {
  using P = Plan<L>;
  constexpr size_t smem = smem_bytes<L>();
  // raised once per instantiation, on its first launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      fft_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int grid, block;
  if constexpr (P::kWarp) {
    const int tiles = (rows + P::M / P::N - 1) / (P::M / P::N);
    grid = (tiles + kWarpsPerCta - 1) / kWarpsPerCta;
    block = 32 * kWarpsPerCta;
  } else {
    grid = rows;
    block = P::G;
  }
  fft_kernel<L><<<grid, block, smem, stream>>>(tw, re, im, ore, oim, rows,
                                               natural);
  return static_cast<int>(cudaGetLastError());
}

template <int L>
int dispatch(int log2n, const float* tw, const float* re, const float* im,
             float* ore, float* oim, int rows, int natural,
             cudaStream_t stream) {
  if constexpr (L > kMaxLog2) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (log2n == L)
      return launch<L>(tw, re, im, ore, oim, rows, natural, stream);
    return dispatch<L + 1>(log2n, tw, re, im, ore, oim, rows, natural,
                           stream);
  }
}

}  // namespace

// tw: the (2, log2n, n/2) twiddle table; re, im, ore, oim: (rows, n)
// contiguous, ore and oim 16-byte aligned; n = 2^log2n <= 16384
extern "C" int egpu_fft_r2(const float* tw, const float* re, const float* im,
                           float* ore, float* oim, int rows, int n, int log2n,
                           int natural, void* stream) {
  if (rows == 0) return 0;
  if (log2n < 0 || n != 1 << log2n)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<0>(log2n, tw, re, im, ore, oim, rows, natural,
                     static_cast<cudaStream_t>(stream));
}
