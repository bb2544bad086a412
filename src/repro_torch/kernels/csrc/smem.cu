// The per-SM shared-memory port of the step and trace engines: LOD and STO.
//
// gather replaces src/repro/kernels/simt_step.py, simt_gather (LOD, the
// quad read port: out[s, t] = mem[s, addr[s, t]] where masked, else old).
// scatter replaces src/repro/kernels/simt_step.py, simt_scatter (STO, the
// single write port: writeback is sequential in thread order, so among
// the enabled writers to one address the highest thread wins; disabled
// lanes write nothing and their addresses are never dereferenced).
//
// Both are row kernels: one CTA of 512 threads per simulated SM, one
// thread per eGPU thread, one data row over a wave of SMs in one launch.
// Each thread forms its gate (active shape, predicate) and, where
// enabled, its address wrap32(regs[src][ra] + imm), src snooped as the
// ALU row's; an enabled lane outside [0, bound) touches no word and sets
// its SM's oob flag in place.
//   * egpu_lod_row: the loaded word, or regs[t][rd] for a disabled or
//     out-of-range lane, is written to regs[s][t][rd] in place after a
//     barrier: with snooping the address is another thread's register,
//     and rd may be that register or preg (egpu_load_row.cuh, the kernel
//     GLD shares with a device-wide image).
//   * egpu_sto_row: the stored word is regs[t][rd]; shmem is written in
//     place.
// The tile forms keep their tests and the kernel table's timing rows:
//   * egpu_gather: one thread per lane of the flattened (n_sm, k) batch
//     over pre-computed addresses, enables and old words.
//   * egpu_scatter: the write port over pre-computed (n_sm, k) addresses,
//     values and enables, into an image the wrapper has copied.
// The write port: each enabled lane clears, then (after a barrier) claims
// its address with atomicMax of its thread index in a winner array in
// dynamic shared memory (4 B per word: 12 KiB at the paper's 3072 words),
// and after a second barrier the lane holding the claim stores into the
// image in device memory. Only claimed words of the winner array are
// touched, and the image is never copied. This is the write-port rule the
// segment kernel applies inside a fused run.
//
// Bound: bytes. A row reads one or two register words per thread, and an
// LOD row loads and an STO row stores at most one image word per thread:
// about 8 B x 2048 threads plus the image words for the step path's wave,
// a few nanoseconds at 3.35 TB/s, so a row costs one launch.
#include <cstdint>
#include <cuda_runtime.h>

#include "egpu_load_row.cuh"
#include "egpu_row.cuh"
#include "egpu_smem.cuh"

namespace {

constexpr int kBlock = 256;

__global__ void gather_kernel(const uint32_t* __restrict__ mem, int depth,
                              const int32_t* __restrict__ addr,
                              const uint8_t* __restrict__ mask,
                              const uint32_t* __restrict__ old,
                              uint32_t* __restrict__ out, int k, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t sm = static_cast<size_t>(i / k);
  out[i] = mask[i] ? mem[sm * depth + addr[i]] : old[i];
}

// The shared body: the policy loads thread t's enable, address and word;
// the write port resolves collisions in shared memory and stores in place.
template <class Io>
__global__ void scatter_kernel(Io io) {
  extern __shared__ int winner[];
  const int t = threadIdx.x;
  bool en;
  int a;
  uint32_t v;
  io.load(en, a, v);
  if (en) winner[a] = -1;
  __syncthreads();
  if (en) atomicMax(&winner[a], t);
  __syncthreads();
  if (en && winner[a] == t) io.image()[a] = v;
}

// (n_sm, k) tiles: addresses within [0, depth) where enabled.
struct TileIo {
  const int32_t* addr;
  const uint32_t* vals;
  const uint8_t* do_;
  uint32_t* mem;
  int depth, k;

  __device__ void load(bool& en, int& a, uint32_t& v) const {
    const size_t lane = static_cast<size_t>(blockIdx.x) * k + threadIdx.x;
    en = do_[lane] != 0;
    a = en ? addr[lane] : 0;
    v = vals[lane];
  }
  __device__ uint32_t* image() const {
    return mem + static_cast<size_t>(blockIdx.x) * depth;
  }
};

// One STO row, 512 threads per SM.
struct RowIo {
  egpu::Row f;
  const uint32_t* regs;
  uint32_t* shmem;
  uint8_t* oob;
  int depth, bound, n_threads;

  __device__ void load(bool& en, int& a, uint32_t& v) const {
    const uint32_t* r =
        regs + static_cast<size_t>(blockIdx.x) * egpu::kRowThreads * egpu::kRegs;
    const int t = threadIdx.x;
    en = egpu::row_enabled(f, r, t, n_threads);
    a = 0;
    if (en) {
      a = egpu::row_address(f, r, t);
      if (a < 0 || a >= bound) {
        oob[blockIdx.x] = 1;
        en = false;
      }
    }
    v = r[t * egpu::kRegs + f.rd];
  }
  __device__ uint32_t* image() const {
    return shmem + static_cast<size_t>(blockIdx.x) * depth;
  }
};

// Launch one scatter; a winner array above 48 KB needs the kernel's
// dynamic shared-memory limit raised, once per device and size.
template <class Io>
cudaError_t launch_scatter(const Io& io, int n_sm, int threads, int words,
                           cudaStream_t stream) {
  static egpu::SmemLimit limit;
  const int smem = static_cast<int>(sizeof(int)) * words;
  const cudaError_t err =
      limit.allow(reinterpret_cast<const void*>(scatter_kernel<Io>), smem);
  if (err != cudaSuccess) return err;
  scatter_kernel<Io><<<n_sm, threads, smem, stream>>>(io);
  return cudaGetLastError();
}

}  // namespace

extern "C" int egpu_gather(const int32_t* mem, int depth, const int32_t* addr,
                           const uint8_t* mask, const int32_t* old,
                           int32_t* out, int k, int n, void* stream) {
  if (n == 0) return 0;
  gather_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint32_t*>(mem), depth, addr, mask,
      reinterpret_cast<const uint32_t*>(old), reinterpret_cast<uint32_t*>(out),
      k, n);
  return static_cast<int>(cudaGetLastError());
}

// mem holds the n_sm images and is written in place; k lanes per SM,
// k <= 1024.
extern "C" int egpu_scatter(int32_t* mem, int depth, const int32_t* addr,
                            const int32_t* vals, const uint8_t* do_, int n_sm,
                            int k, void* stream) {
  if (n_sm == 0) return 0;
  const TileIo io{addr, reinterpret_cast<const uint32_t*>(vals), do_,
                  reinterpret_cast<uint32_t*>(mem), depth, k};
  return static_cast<int>(launch_scatter(io, n_sm, k, depth,
                                         static_cast<cudaStream_t>(stream)));
}

// The row's 15 fields in FIELDS order, then the wave: regs (n_sms, 512,
// 16), shmem (n_sms, depth) and oob (n_sms,) bytes; shmem and oob are
// written in place. Addresses are bounded by bound <= depth.
extern "C" int egpu_sto_row(int sel, int opcode, int typ, int rd, int ra,
                            int rb, int imm, int x, int ext_a, int ext_b,
                            int pen, int preg, int pneg, int act_waves,
                            int act_wthreads, int n_threads,
                            const int32_t* regs, int32_t* shmem, uint8_t* oob,
                            int n_sms, int depth, int bound, void* stream) {
  const RowIo io{{sel, opcode, typ, rd, ra, rb, imm, x, ext_a, ext_b, pen,
                  preg, pneg, act_waves, act_wthreads},
                 reinterpret_cast<const uint32_t*>(regs),
                 reinterpret_cast<uint32_t*>(shmem), oob, depth, bound,
                 n_threads};
  return static_cast<int>(launch_scatter(io, n_sms, egpu::kRowThreads, bound,
                                         static_cast<cudaStream_t>(stream)));
}

// The row's 15 fields in FIELDS order, then the wave: regs (n_sms, 512,
// 16) and oob (n_sms,) bytes, written in place, and shmem (n_sms, depth),
// read. Addresses are bounded by bound <= depth.
extern "C" int egpu_lod_row(int sel, int opcode, int typ, int rd, int ra,
                            int rb, int imm, int x, int ext_a, int ext_b,
                            int pen, int preg, int pneg, int act_waves,
                            int act_wthreads, int n_threads, int32_t* regs,
                            const int32_t* shmem, uint8_t* oob, int n_sms,
                            int depth, int bound, void* stream) {
  const egpu::Row f{sel, opcode, typ, rd, ra, rb, imm, x, ext_a, ext_b,
                    pen, preg, pneg, act_waves, act_wthreads};
  return static_cast<int>(launch_load_row(
      f, n_threads, regs, shmem, oob, n_sms, static_cast<size_t>(depth),
      bound, static_cast<cudaStream_t>(stream)));
}
