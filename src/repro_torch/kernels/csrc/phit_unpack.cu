// HGum DES payload pass on Hopper (sm_90a): phit stream -> u32 token lanes.
//
// Three kernels, one thread per output word (row, lane).  Each replaces a
// Pallas body of the reference src/repro/kernels/phit_unpack.py:
//
//   hgum_unpack_run_aligned  <- _run_kernel_aligned (phit_unpack.py:48),
//                               called from unpack_run (:106)
//   hgum_unpack_run_general  <- _run_kernel_general (phit_unpack.py:57),
//                               called from unpack_run (:122)
//   hgum_unpack_gather       <- _gather_kernel      (phit_unpack.py:143),
//                               called from unpack_gather (:171)
//
// What they compute.  Row i of a leaf field starts at byte
//   off_i = base + i * stride        (uniform runs)
//   off_i = offsets[i]               (gather, ragged containers)
// and lane j of that row is the little-endian u32 at byte off_i + 4j, with
// the bytes past `nbytes` zeroed.  With w = off >> 2 and r = off & 3 the
// lane is __funnelshift_r(wire[w], wire[w + 1], 8 r): the funnel shift takes
// r == 0 without a shift by 32, which the TPU code had to avoid with a
// `% 32` and a select.  The aligned kernel is the case r == 0 for every row
// (base and stride multiples of 4) and needs no second load.
//
// Reads past the wire.  The Pallas wrappers pad the wire so that their
// overread tail is zeros.  These kernels never read past their tensor:
// any word index outside [0, wire_words) reads as 0, which is what the
// padded wire holds there.  The plain PyTorch versions in phit_unpack.py
// apply the same rule, so kernel and plain agree bit for bit everywhere.
//
// What bounds them.  No arithmetic to speak of: each output word costs one
// or two 4-byte loads and one 4-byte store, so the bound is memory traffic
// (the wire bytes the rows cover, the offsets for the gather, the output).
// Design for that: neighbouring threads own neighbouring output words, so
// stores are fully coalesced and loads of one row (and of neighbouring rows
// in a dense run) fall in the same 32-byte sectors; loads go through the
// read-only path (__ldg); the second word of an unaligned lane is the first
// word of the next lane and is served from L1.  Wider per-thread loads
// (16 bytes) and TMA are left for later work.
//
// Interface: plain C, pointers and the stream as void*, 64-bit sizes.  Each
// entry returns cudaGetLastError() after its launch; the launch is
// asynchronous on the given stream and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t lane_mask(int nbytes, int lane) {
  const int rem = nbytes - 4 * lane;
  if (rem >= 4) return 0xFFFFFFFFu;
  if (rem <= 0) return 0u;
  return (1u << (8 * rem)) - 1u;
}

__device__ __forceinline__ uint32_t load_word(const uint32_t* __restrict__ wire,
                                              int64_t wire_words, int64_t w) {
  return (w >= 0 && w < wire_words) ? __ldg(wire + w) : 0u;
}

// The u32 lane that starts at byte `off` of the wire.
__device__ __forceinline__ uint32_t load_lane(const uint32_t* __restrict__ wire,
                                              int64_t wire_words, int64_t off) {
  const int64_t w = off >> 2;
  const unsigned r = static_cast<unsigned>(off & 3);
  const uint32_t lo = load_word(wire, wire_words, w);
  const uint32_t hi = r ? load_word(wire, wire_words, w + 1) : 0u;
  return __funnelshift_r(lo, hi, 8u * r);
}

__global__ void run_aligned_kernel(const uint32_t* __restrict__ wire, int64_t wire_words,
                                   uint32_t* __restrict__ out, int64_t base_w,
                                   int64_t stride_w, int64_t total, int nlanes,
                                   int nbytes) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t row = i / nlanes;
  const int lane = static_cast<int>(i - row * nlanes);
  const uint32_t v = load_word(wire, wire_words, base_w + row * stride_w + lane);
  out[i] = v & lane_mask(nbytes, lane);
}

__global__ void run_general_kernel(const uint32_t* __restrict__ wire, int64_t wire_words,
                                   uint32_t* __restrict__ out, int64_t base,
                                   int64_t stride, int64_t total, int nlanes,
                                   int nbytes) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t row = i / nlanes;
  const int lane = static_cast<int>(i - row * nlanes);
  const int64_t off = base + row * stride + 4 * static_cast<int64_t>(lane);
  out[i] = load_lane(wire, wire_words, off) & lane_mask(nbytes, lane);
}

__global__ void gather_kernel(const uint32_t* __restrict__ wire, int64_t wire_words,
                              const long long* __restrict__ offsets,
                              uint32_t* __restrict__ out, int64_t total, int nlanes,
                              int nbytes) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t row = i / nlanes;
  const int lane = static_cast<int>(i - row * nlanes);
  const int64_t off = static_cast<int64_t>(__ldg(offsets + row)) + 4 * static_cast<int64_t>(lane);
  out[i] = load_lane(wire, wire_words, off) & lane_mask(nbytes, lane);
}

inline unsigned int n_blocks(int64_t total) {
  return static_cast<unsigned int>((total + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int hgum_unpack_run_aligned(const void* wire, long long wire_words, void* out,
                            long long base_w, long long stride_w, long long count,
                            int nlanes, int nbytes, void* stream) {
  const int64_t total = static_cast<int64_t>(count) * nlanes;
  run_aligned_kernel<<<n_blocks(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(wire), wire_words, static_cast<uint32_t*>(out), base_w,
      stride_w, total, nlanes, nbytes);
  return static_cast<int>(cudaGetLastError());
}

int hgum_unpack_run_general(const void* wire, long long wire_words, void* out,
                            long long base, long long stride, long long count, int nlanes,
                            int nbytes, void* stream) {
  const int64_t total = static_cast<int64_t>(count) * nlanes;
  run_general_kernel<<<n_blocks(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(wire), wire_words, static_cast<uint32_t*>(out), base,
      stride, total, nlanes, nbytes);
  return static_cast<int>(cudaGetLastError());
}

int hgum_unpack_gather(const void* wire, long long wire_words, const void* offsets,
                       void* out, long long n, int nlanes, int nbytes, void* stream) {
  const int64_t total = static_cast<int64_t>(n) * nlanes;
  gather_kernel<<<n_blocks(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(wire), wire_words, static_cast<const long long*>(offsets),
      static_cast<uint32_t*>(out), total, nlanes, nbytes);
  return static_cast<int>(cudaGetLastError());
}

const char* hgum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
