// Variants of B6's split body (src/repro_torch/kernels/csrc/frame_pack.cu,
// split_kernel), for scripts/b6_variants.py only: the same layout with
// build-time knobs the shipped body fixes.  Each build exposes
// hgum_unpack_frames_batch with the shipped signature.
//   HGUM_SPLIT_UNROLL_PHITS, HGUM_SPLIT_UNROLL_WORDS: units in flight a
//     thread in the phit and the word form (shipped: 1 and 4);
//   HGUM_SPLIT_STREAMING: 1 loads with __ldcs and stores with __stcs
//     (evict first), 0 with __ldg and plain stores (shipped);
//   HGUM_SPLIT_BLOCKS_PER_SM: 0 gives a thread for every U units (shipped),
//     k caps the grid at k blocks per SM, whose threads then stride.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef HGUM_SPLIT_UNROLL_PHITS
#define HGUM_SPLIT_UNROLL_PHITS 1
#endif
#ifndef HGUM_SPLIT_UNROLL_WORDS
#define HGUM_SPLIT_UNROLL_WORDS 4
#endif
#ifndef HGUM_SPLIT_STREAMING
#define HGUM_SPLIT_STREAMING 0
#endif
#ifndef HGUM_SPLIT_BLOCKS_PER_SM
#define HGUM_SPLIT_BLOCKS_PER_SM 0
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kHdrWords = 4;

struct SplitArgs {
  const uint32_t* frames;
  uint32_t* hdr;
  uint32_t* pay;
  unsigned long long n;          // units of the frames
  unsigned long long pass;       // units a thread's round moves: U * the grid's threads
  unsigned long long step_rows;  // the grid's threads = step_rows * per_frame + step_cols
  uint32_t per_frame;
  uint32_t step_cols;
};

template <typename T>
__device__ __forceinline__ T load_unit(const T* p) {
#if HGUM_SPLIT_STREAMING
  return __ldcs(p);
#else
  return __ldg(p);
#endif
}

template <typename T>
__device__ __forceinline__ void store_unit(T* p, const T& v) {
#if HGUM_SPLIT_STREAMING
  __stcs(p, v);
#else
  *p = v;
#endif
}

template <typename T, typename Idx, int U>
__global__ void __launch_bounds__(kThreads) split_kernel(const SplitArgs a) {
  constexpr uint32_t H = kHdrWords * sizeof(uint32_t) / sizeof(T);
  const T* __restrict__ src = reinterpret_cast<const T*>(a.frames);
  T* __restrict__ hdr = reinterpret_cast<T*>(a.hdr);
  T* __restrict__ pay = reinterpret_cast<T*>(a.pay);
  const Idx n = static_cast<Idx>(a.n);
  const Idx stride = static_cast<Idx>(gridDim.x) * blockDim.x;
  Idx i = static_cast<Idx>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t w = a.per_frame;
  Idx r = i / w;
  uint32_t c = static_cast<uint32_t>(i - r * w);
  for (;;) {  // a second round only under a grid cap
    const Idx left = n - i;
    T v[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (k * stride < left) v[k] = load_unit(src + i + k * stride);
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (k * stride < left) {
        if (c < H) {
          store_unit(hdr + r * H + c, v[k]);
        } else {
          store_unit(pay + (i + k * stride - H * (r + 1)), v[k]);
        }
      }
      c += a.step_cols;
      r += static_cast<Idx>(a.step_rows);
      if (c >= w) {
        c -= w;
        ++r;
      }
    }
    if (left <= a.pass) return;  // compared in 64 bits: U * stride may not fit Idx
    i += static_cast<Idx>(a.pass);
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

template <typename T, typename Idx, int U>
int launch_split(SplitArgs a, cudaStream_t stream) {
  constexpr long long per_block = static_cast<long long>(U) * kThreads;
  long long blocks = (static_cast<long long>(a.n) + per_block - 1) / per_block;
  if (HGUM_SPLIT_BLOCKS_PER_SM > 0 && blocks > HGUM_SPLIT_BLOCKS_PER_SM * sm_count()) {
    blocks = HGUM_SPLIT_BLOCKS_PER_SM * sm_count();
  }
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  const unsigned long long stride = static_cast<unsigned long long>(blocks) * kThreads;
  a.pass = stride * U;
  a.step_rows = stride / a.per_frame;
  a.step_cols = static_cast<uint32_t>(stride % a.per_frame);
  split_kernel<T, Idx, U><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hgum_unpack_frames_batch(const void* frames, void* hdr, void* pay, long long rows,
                                        int frame_words, void* stream) {
  if (rows < 0 || frame_words < 0 || frame_words >= (1 << 30)) return cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(frames) |
                          reinterpret_cast<uintptr_t>(hdr) | reinterpret_cast<uintptr_t>(pay);
  const bool phits = frame_words % 4 == 0 && (bases & 15) == 0;
  const long long width = kHdrWords + frame_words;
  SplitArgs a = {};
  a.frames = static_cast<const uint32_t*>(frames);
  a.hdr = static_cast<uint32_t*>(hdr);
  a.pay = static_cast<uint32_t*>(pay);
  a.per_frame = static_cast<uint32_t>(phits ? width / 4 : width);
  a.n = static_cast<unsigned long long>(rows) * a.per_frame;
  const bool small = a.n < (1ULL << 32);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (phits) {
    if (!small) return cudaErrorInvalidValue;
    return launch_split<uint4, uint32_t, HGUM_SPLIT_UNROLL_PHITS>(a, s);
  }
  if (small) return launch_split<uint32_t, uint32_t, HGUM_SPLIT_UNROLL_WORDS>(a, s);
  return launch_split<uint32_t, unsigned long long, HGUM_SPLIT_UNROLL_WORDS>(a, s);
}
