// The device-wide global-memory port of the eGPU sector: GLD and GST.
//
// gather_shared replaces src/repro/kernels/simt_step.py, simt_gather_shared
// (GLD: every SM's lanes gather from the one global image).
// scatter_shared replaces src/repro/kernels/simt_step.py,
// simt_scatter_shared (GST: the single port drains in (sm, thread) order,
// so on an address collision the last enabled writer wins).
//
// Bound: bytes. A GLD reads addr, mask and old and writes out once per
// lane, plus at most one image word per lane; a GST reads addr, vals and
// do per lane and copies the image once. At the main path's shapes that
// is tens of kilobytes, so both are launch-latency bound (a few
// microseconds) far before 3.35 TB/s. The design is one thread per lane,
// neighbouring lanes on neighbouring addresses; the store's grid-wide
// order comes from two launches on one stream: an atomicMax of the lane's
// flat (sm, thread) index into a winner array, then a store by the lane
// that holds it.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

__global__ void gather_kernel(const int32_t* __restrict__ gmem,
                              const int32_t* __restrict__ addr,
                              const uint8_t* __restrict__ mask,
                              const int32_t* __restrict__ old,
                              int32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = mask[i] ? gmem[addr[i]] : old[i];
}

__global__ void claim_kernel(const int32_t* __restrict__ addr,
                             const uint8_t* __restrict__ do_,
                             int* __restrict__ winner, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n && do_[i]) atomicMax(&winner[addr[i]], i);
}

__global__ void store_kernel(int32_t* __restrict__ gmem,
                             const int32_t* __restrict__ addr,
                             const int32_t* __restrict__ vals,
                             const uint8_t* __restrict__ do_,
                             const int* __restrict__ winner, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n && do_[i] && winner[addr[i]] == i) gmem[addr[i]] = vals[i];
}

int blocks(int n) { return (n + kBlock - 1) / kBlock; }

}  // namespace

extern "C" int egpu_gather_shared(const int32_t* gmem, int gdepth,
                                  const int32_t* addr, const uint8_t* mask,
                                  const int32_t* old, int32_t* out, int n,
                                  void* stream) {
  (void)gdepth;
  if (n == 0) return 0;
  gather_kernel<<<blocks(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      gmem, addr, mask, old, out, n);
  return static_cast<int>(cudaGetLastError());
}

// gmem is updated in place; winner holds gdepth words set to -1.
extern "C" int egpu_scatter_shared(int32_t* gmem, int gdepth,
                                   const int32_t* addr, const int32_t* vals,
                                   const uint8_t* do_, int* winner, int n,
                                   void* stream) {
  (void)gdepth;
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  claim_kernel<<<blocks(n), kBlock, 0, s>>>(addr, do_, winner, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  store_kernel<<<blocks(n), kBlock, 0, s>>>(gmem, addr, vals, do_, winner, n);
  return static_cast<int>(cudaGetLastError());
}
