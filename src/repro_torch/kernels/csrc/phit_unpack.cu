// HGum DES payload pass on Hopper (sm_90a): phit stream -> u32 token lanes.
//
// Three entry points.  Each replaces a Pallas body of the reference
// src/repro/kernels/phit_unpack.py:
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
// `% 32` and a select.  The aligned entry is the case r == 0 for every row
// (base and stride multiples of 4) and needs no second load.
//
// Reads past the wire.  The Pallas wrappers pad the wire so that their
// overread tail is zeros.  These kernels never read past their tensor:
// any word index outside [0, wire_words) reads as 0, which is what the
// padded wire holds there.  The plain PyTorch versions in phit_unpack.py
// apply the same rule, so kernel and plain agree bit for bit everywhere.
//
// What bounds them.  No arithmetic to speak of, so the bound is memory
// traffic (the wire bytes the rows cover, the offsets for the gather, the
// output).  Stores are coalesced (neighbouring threads own neighbouring
// output words) and loads go through the read-only path (__ldg).
//
// The aligned run has two kernels, chosen by the entry from the run itself:
//   * dense (stride_w == nlanes: the rows abut, as in fixed-layout batch
//     leaves and 4-byte token runs): a masked contiguous copy in 16-byte
//     vectors, one output phit per thread.  The output is a fresh tensor, so
//     its phits are aligned; the wire side may not be (base_w, and the wire
//     may be a view), so its phase r in a 16-byte line is taken from the
//     POINTER.  With r != 0 a thread loads the two aligned phits that hold
//     its four words and picks them out (the second is its neighbour's
//     first, served from L1); a phit that reaches outside the wire, and the
//     output tail past the last whole phit, take the scalar path.  The lane
//     of word i is i mod nlanes.
//   * strided (the rows have gaps; the serve's req_id is one lane per row at
//     a pitch of row_bytes): one thread per (row, lane) word.
// Both use 32-bit index math whenever the output fits in 2**31 words, so no
// thread pays for an emulated 64-bit division (tens of instructions a word).
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

// Dense aligned run: out[i] = wire[base_w + i] & lane_mask(i mod nlanes).
// Thread j writes output phit j (words 4j .. 4j + 3); `phase` is the 16-byte
// phase of the word wire + base_w, from its address.
template <typename Idx>
__global__ void run_dense_kernel(const uint32_t* __restrict__ wire, int64_t wire_words,
                                 uint32_t* __restrict__ out, int64_t base_w, Idx total,
                                 int phase, int nlanes, int nbytes) {
  const Idx i0 = 4 * (static_cast<Idx>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (i0 >= total) return;
  const bool whole = total - i0 >= 4;
  // first word of the aligned phit that holds word base_w + i0
  const int64_t e = base_w + static_cast<int64_t>(i0) - phase;
  uint32_t v[4];
  if (whole && e >= 0 && e + (phase ? 8 : 4) <= wire_words) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(wire + e));
    uint4 b = a;
    if (phase) b = __ldg(reinterpret_cast<const uint4*>(wire + e + 4));
    switch (phase) {  // the same for every thread of the launch
      case 0: v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w; break;
      case 1: v[0] = a.y; v[1] = a.z; v[2] = a.w; v[3] = b.x; break;
      case 2: v[0] = a.z; v[1] = a.w; v[2] = b.x; v[3] = b.y; break;
      default: v[0] = a.w; v[1] = b.x; v[2] = b.y; v[3] = b.z; break;
    }
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      v[t] = i0 + t < total ? load_word(wire, wire_words, base_w + static_cast<int64_t>(i0) + t)
                            : 0u;
    }
  }
  int lane = nlanes == 1 ? 0 : static_cast<int>(i0 % static_cast<Idx>(nlanes));
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    v[t] &= lane_mask(nbytes, lane);
    lane = lane + 1 == nlanes ? 0 : lane + 1;
  }
  if (whole) {
    *reinterpret_cast<uint4*>(out + i0) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
    for (int t = 0; i0 + t < total; ++t) out[i0 + t] = v[t];
  }
}

// Strided aligned run: one thread per (row, lane) output word.
template <typename Idx>
__global__ void run_strided_kernel(const uint32_t* __restrict__ wire, int64_t wire_words,
                                   uint32_t* __restrict__ out, int64_t base_w,
                                   int64_t stride_w, Idx total, int nlanes, int nbytes) {
  const Idx i = static_cast<Idx>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const Idx row = nlanes == 1 ? i : i / static_cast<Idx>(nlanes);
  const int lane = static_cast<int>(i - row * static_cast<Idx>(nlanes));
  const int64_t w = base_w + static_cast<int64_t>(row) * stride_w + lane;
  out[i] = load_word(wire, wire_words, w) & lane_mask(nbytes, lane);
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
  if (total == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* w = static_cast<const uint32_t*>(wire);
  uint32_t* o = static_cast<uint32_t*>(out);
  const bool small = total <= INT32_MAX;  // 32-bit index math
  if (stride_w == nlanes) {
    const int phase =
        static_cast<int>((reinterpret_cast<uintptr_t>(w) / 4 + static_cast<uint64_t>(base_w)) & 3);
    const unsigned int blocks = n_blocks((total + 3) / 4);
    if (small) {
      run_dense_kernel<uint32_t><<<blocks, kThreads, 0, s>>>(
          w, wire_words, o, base_w, static_cast<uint32_t>(total), phase, nlanes, nbytes);
    } else {
      run_dense_kernel<int64_t><<<blocks, kThreads, 0, s>>>(w, wire_words, o, base_w, total,
                                                            phase, nlanes, nbytes);
    }
  } else if (small) {
    run_strided_kernel<uint32_t><<<n_blocks(total), kThreads, 0, s>>>(
        w, wire_words, o, base_w, stride_w, static_cast<uint32_t>(total), nlanes, nbytes);
  } else {
    run_strided_kernel<int64_t><<<n_blocks(total), kThreads, 0, s>>>(
        w, wire_words, o, base_w, stride_w, total, nlanes, nbytes);
  }
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
