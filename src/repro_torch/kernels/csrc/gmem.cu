// The device-wide global-memory port of the eGPU sector: GLD and GST.
//
// gather_shared replaces src/repro/kernels/simt_step.py, simt_gather_shared
// (GLD: every SM's lanes gather from the one global image).
// scatter_shared replaces src/repro/kernels/simt_step.py,
// simt_scatter_shared (GST: the single port drains in (sm, thread) order,
// so on an address collision the last enabled writer wins).
//
// Both are row kernels: one GLD or GST data row of the step, trace and
// megakernel engines over a wave of SMs in one launch, in place. Each
// thread forms its gate (active shape, predicate) and, where enabled, its
// address wrap32(regs[src][ra] + imm), src snooped as the other rows'; an
// enabled lane outside [0, gdepth) touches no word and sets its SM's oob
// flag in place.
//   * egpu_gld_row: the LOD row kernel (egpu_load_row.cuh), one CTA of 512
//     threads per SM, over the one image (SM stride 0). GLD does not write
//     the image, so every lane reads it as it was at the start of the row.
//   * egpu_gst_row: the stored word is the thread's own regs[t][rd]. The
//     drain order spans the wave's SMs, so no CTA per SM can choose a
//     winner alone: one CTA of up to 1024 threads takes all n x 512 lanes,
//     lane i = sm * 512 + thread its place in the drain. Each lane forms
//     its enable, address and word once and keeps them as an 8-byte lane
//     record; each enabled lane clears its address's claim, then (after a
//     barrier) claims it with atomicMax of i, and after a second barrier
//     the lane holding the claim stores: the write-port rule of smem.cu's
//     STO row, across the wave. The claims (4 B per image word) and the
//     lane records (8 B per lane) live in dynamic shared memory (64 KiB
//     at the smoke's 12304-word image and 2048 lanes), or, where they
//     exceed the 227 KiB a CTA may hold, in a scratch array of device
//     memory that the wrapper keeps per device and stream. Either way only
//     claimed words are touched, so the cost grows with the lanes, not
//     with the image, and the image is never copied.
// The tile forms keep their tests and the kernel table's timing rows:
//   * egpu_gather_shared: one thread per lane over pre-computed addresses,
//     enables and old words;
//   * egpu_scatter_shared: the GST write port above over pre-computed
//     addresses, values and enables, into an image the wrapper has copied.
//
// Bound: bytes. A row reads one or two register words per thread and
// loads or stores at most one image word per thread: 24 KiB for a
// SAXPY-4096 row over 4 x 512 threads, 7 ns at 3.35 TB/s, so a row costs
// one launch (and GST's one CTA the issue of one SM).
#include <cstdint>
#include <cuda_runtime.h>

#include "egpu_load_row.cuh"
#include "egpu_row.cuh"
#include "egpu_smem.cuh"

namespace {

constexpr int kBlock = 256, kPortThreads = 1024;

__global__ void gather_kernel(const int32_t* __restrict__ gmem,
                              const int32_t* __restrict__ addr,
                              const uint8_t* __restrict__ mask,
                              const int32_t* __restrict__ old,
                              int32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = mask[i] ? gmem[addr[i]] : old[i];
}

// The words of the write port's scratch: the claims of a gdepth-word
// image, then 8-byte lane records from an even word.
__host__ __device__ constexpr int claim_words(int gdepth) {
  return gdepth + (gdepth & 1);
}

// The device-wide write port over the n flat lanes of a wave, one CTA.
// The policy gives lane i's address where it stores (setting its SM's
// oob flag where an enabled lane's lies outside the image) and its word.
// scratch points to claim_words(gdepth) + 2 n words of device memory, or
// is null for the same layout in dynamic shared memory.
template <class Io>
__global__ void __launch_bounds__(kPortThreads)
store_port_kernel(Io io, int n, int gdepth, int* scratch) {
  extern __shared__ int smem_scratch[];
  int* claim = scratch != nullptr ? scratch : smem_scratch;
  int2* lane = reinterpret_cast<int2*>(claim + claim_words(gdepth));
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int a = -1;
    uint32_t w = 0;
    if (io.address(i, a)) {
      w = io.word(i);
      claim[a] = -1;
    }
    lane[i] = make_int2(a, static_cast<int>(w));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int a = lane[i].x;
    if (a >= 0) atomicMax(&claim[a], i);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int2 r = lane[i];
    if (r.x >= 0 && claim[r.x] == i)
      io.image[r.x] = static_cast<uint32_t>(r.y);
  }
}

// flat lanes: addresses within [0, gdepth) where enabled
struct TileIo {
  const int32_t* addr;
  const uint32_t* vals;
  const uint8_t* do_;
  uint32_t* image;

  __device__ bool address(int i, int& a) const {
    if (!do_[i]) return false;
    a = addr[i];
    return true;
  }
  __device__ uint32_t word(int i) const { return vals[i]; }
};

// one GST row over a wave of n_sms SMs of 512 threads
struct RowIo {
  egpu::Row f;
  const uint32_t* regs;
  uint32_t* image;
  uint8_t* oob;
  int gdepth, n_threads;

  __device__ const uint32_t* sm(int i) const {
    return regs + static_cast<size_t>(i / egpu::kRowThreads)
                      * egpu::kRowThreads * egpu::kRegs;
  }
  __device__ bool address(int i, int& a) const {
    const uint32_t* r = sm(i);
    const int t = i % egpu::kRowThreads;
    if (!egpu::row_enabled(f, r, t, n_threads)) return false;
    const int b = egpu::row_address(f, r, t);
    if (b < 0 || b >= gdepth) {
      oob[i / egpu::kRowThreads] = 1;
      return false;
    }
    a = b;
    return true;
  }
  __device__ uint32_t word(int i) const {
    return sm(i)[(i % egpu::kRowThreads) * egpu::kRegs + f.rd];
  }
};

// Launch one write port over n lanes; a scratch in shared memory
// (scratch null) above 48 KB needs the kernel's limit raised, once per
// device and size.
template <class Io>
cudaError_t launch_store_port(const Io& io, int n, int gdepth, int* scratch,
                              cudaStream_t stream) {
  static egpu::SmemLimit limit;
  const int smem = scratch != nullptr ? 0
      : static_cast<int>(sizeof(int)) * (claim_words(gdepth) + 2 * n);
  const cudaError_t err =
      limit.allow(reinterpret_cast<const void*>(store_port_kernel<Io>), smem);
  if (err != cudaSuccess) return err;
  const int threads = n < kPortThreads ? n : kPortThreads;
  store_port_kernel<Io><<<1, threads, smem, stream>>>(io, n, gdepth, scratch);
  return cudaGetLastError();
}

}  // namespace

extern "C" int egpu_gather_shared(const int32_t* gmem, int gdepth,
                                  const int32_t* addr, const uint8_t* mask,
                                  const int32_t* old, int32_t* out, int n,
                                  void* stream) {
  (void)gdepth;
  if (n == 0) return 0;
  gather_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                  static_cast<cudaStream_t>(stream)>>>(gmem, addr, mask, old,
                                                       out, n);
  return static_cast<int>(cudaGetLastError());
}

// gmem is updated in place; scratch is null (shared memory) or
// claim_words(gdepth) + 2 n words of device memory.
extern "C" int egpu_scatter_shared(int32_t* gmem, int gdepth,
                                   const int32_t* addr, const int32_t* vals,
                                   const uint8_t* do_, int* scratch, int n,
                                   void* stream) {
  if (n == 0) return 0;
  const TileIo io{addr, reinterpret_cast<const uint32_t*>(vals), do_,
                  reinterpret_cast<uint32_t*>(gmem)};
  return static_cast<int>(launch_store_port(
      io, n, gdepth, scratch, static_cast<cudaStream_t>(stream)));
}

// The row's 15 fields in FIELDS order, then the wave: regs (n_sms, 512,
// 16) and oob (n_sms,) bytes, written in place, and gmem (gdepth,), read.
extern "C" int egpu_gld_row(int sel, int opcode, int typ, int rd, int ra,
                            int rb, int imm, int x, int ext_a, int ext_b,
                            int pen, int preg, int pneg, int act_waves,
                            int act_wthreads, int n_threads, int32_t* regs,
                            const int32_t* gmem, uint8_t* oob, int n_sms,
                            int gdepth, void* stream) {
  const egpu::Row f{sel, opcode, typ, rd, ra, rb, imm, x, ext_a, ext_b,
                    pen, preg, pneg, act_waves, act_wthreads};
  return static_cast<int>(launch_load_row(f, n_threads, regs, gmem, oob,
                                          n_sms, 0, gdepth,
                                          static_cast<cudaStream_t>(stream)));
}

// The row's 15 fields in FIELDS order, then the wave: regs (n_sms, 512,
// 16), read, and gmem (gdepth,) and oob (n_sms,) bytes, written in place;
// scratch is null (shared memory) or claim_words(gdepth) + 2 n_sms x 512
// words of device memory.
extern "C" int egpu_gst_row(int sel, int opcode, int typ, int rd, int ra,
                            int rb, int imm, int x, int ext_a, int ext_b,
                            int pen, int preg, int pneg, int act_waves,
                            int act_wthreads, int n_threads,
                            const int32_t* regs, int32_t* gmem, uint8_t* oob,
                            int n_sms, int gdepth, int* scratch,
                            void* stream) {
  const RowIo io{{sel, opcode, typ, rd, ra, rb, imm, x, ext_a, ext_b, pen,
                  preg, pneg, act_waves, act_wthreads},
                 reinterpret_cast<const uint32_t*>(regs),
                 reinterpret_cast<uint32_t*>(gmem), oob, gdepth, n_threads};
  return static_cast<int>(launch_store_port(
      io, n_sms * egpu::kRowThreads, gdepth, scratch,
      static_cast<cudaStream_t>(stream)));
}
