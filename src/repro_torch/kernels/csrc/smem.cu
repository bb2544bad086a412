// The per-SM shared-memory port of the step and trace engines: LOD and STO.
//
// gather replaces src/repro/kernels/simt_step.py, simt_gather (LOD, the
// quad read port: out[s, t] = mem[s, addr[s, t]] where masked, else old).
// scatter replaces src/repro/kernels/simt_step.py, simt_scatter (STO, the
// single write port: writeback is sequential in thread order, so among
// the enabled writers to one address the highest thread wins; disabled
// lanes write nothing and their addresses are never dereferenced).
//
// Layout: gather is one thread per lane of the flattened (n_sm, k) batch.
// scatter is one CTA per simulated SM with one thread per lane: the CTA
// copies the SM's image to the output and clears a winner array in dynamic
// shared memory (4 B per word, 12 KiB at the paper's 3072 words), each
// enabled lane claims its address with atomicMax of its thread index, and
// after a barrier the lane holding the claim stores. This is the
// write-port rule the segment kernel applies inside a fused run.
//
// Bound: bytes. A gather moves 13 B per lane plus one image word; a
// scatter reads and writes the image once (8 B per word) and reads 9 B
// per lane. At the step path's 4 x 512 lanes and 3072 words that is
// 34 KB and 135 KB: tens of nanoseconds at 3.35 TB/s, so both calls are
// launch-latency bound. The scatter's claims stay in shared memory, so
// it costs one launch where a device-wide winner array would cost two.
#include <cstdint>
#include <cuda_runtime.h>

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

__global__ void scatter_kernel(const uint32_t* __restrict__ mem, int depth,
                               const int32_t* __restrict__ addr,
                               const uint32_t* __restrict__ vals,
                               const uint8_t* __restrict__ do_,
                               uint32_t* __restrict__ out, int k) {
  extern __shared__ int winner[];
  const int t = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * depth;
  for (int i = t; i < depth; i += blockDim.x) {
    winner[i] = -1;
    out[base + i] = mem[base + i];
  }
  __syncthreads();
  const size_t lane = static_cast<size_t>(blockIdx.x) * k + t;
  const bool enabled = do_[lane] != 0;
  const int a = enabled ? addr[lane] : 0;
  if (enabled) atomicMax(&winner[a], t);
  __syncthreads();
  if (enabled && winner[a] == t) out[base + a] = vals[lane];
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

// out receives the n_sm new images; k lanes per SM, k <= 1024.
extern "C" int egpu_scatter(const int32_t* mem, int depth, const int32_t* addr,
                            const int32_t* vals, const uint8_t* do_,
                            int32_t* out, int n_sm, int k, void* stream) {
  if (n_sm == 0) return 0;
  const size_t smem = sizeof(int) * static_cast<size_t>(depth);
  cudaError_t err = cudaFuncSetAttribute(
      scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_kernel<<<n_sm, k, smem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint32_t*>(mem), depth, addr,
      reinterpret_cast<const uint32_t*>(vals), do_,
      reinterpret_cast<uint32_t*>(out), k);
  return static_cast<int>(cudaGetLastError());
}
