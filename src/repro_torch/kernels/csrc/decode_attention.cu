// Decode attention on Hopper (sm_90a): append one token's K/V to the cache
// and attend over the cache, in one launch.
//
// Replaces no TPU kernel.  The reference computes decode attention in plain
// jnp (decode_attention, src/repro/models/common.py:242, called from
// attn_decode, src/repro/models/attention.py:84): float32 scores q.k,
// softcap, a masked softmax and p @ v in float32.  The port's plain torch
// version of the same function (models/common.py:decode_attention) casts
// the whole bf16 cache to float32 and multiplies the copies in two batched
// float32 GEMMs of G rows.  This kernel reads the cache once, in its own
// dtype, and makes no float32 copy of it.
//
// What it computes, for batch row b and kv head h (G query heads share h):
//   slot   = window ? pos[b] % T : pos[b]
//   if slot < T: cache[b, slot, h] = (k_new[b, h], v_new[b, h])  (else the
//            row keeps its old K/V, as the reference's mode="drop" scatter)
//   kv_len = min(pos[b] + 1, T)
//   s_gt   = softcap(scale * sum_d q[b,h,g,d] * k[b,t,h,d]),  t < kv_len
//   out    = sum_t softmax_t(s_gt) * v[b,t,h,:]
//
// Numbers.  Scores are float32: for a bf16 cache on the tensor cores (mma
// m16n8k16, bf16 operands, float32 accumulators), where each product of two
// bf16 values is exact and the sums are float32; for a float32 cache on the
// CUDA cores.  The softmax and p @ v are float32 on the CUDA cores, p kept
// in float32: nothing is rounded to bf16 or TF32 on the way.  Only the
// order of the float32 sums differs from the reference; `out` is rounded
// once to q's dtype.
//
// What bounds it.  Each key of a kv head brings 4 D bytes of bf16 K and V
// and costs 4 G D float32 operations, half of them (p @ v) on the CUDA
// cores: 67 TFLOP/s of float32 FMA over 3.35 TB/s is 20 flops a byte, so
// the bytes bound every registered model but MQA (granite-34b, G = 48), and
// at yi-6b's serve call (128 rows x 1152 keys x 4 kv heads x 128, G = 8)
// the cache's 302 MB take 0.090 ms.  What the design does about it:
//   * flash-decoding: one block of 2 warps per (row, kv head, group of up
//     to 8 query heads, key split); each warp walks 32-key tiles of its
//     split with its own online softmax, and the block merges its warps;
//   * a tile's K rows and V rows are two asynchronous 16-byte copies
//     (cp.async) into shared memory: V lands while the warp scores K, and
//     the next tile's K while it runs p @ v;
//   * scores on the tensor cores (bf16): q is the B operand, held in
//     registers for the whole launch, the tile's keys the A operand
//     (ldmatrix), so a score costs no shared-memory read of q;
//   * p @ v: a lane owns 8 head dims of every head of the group and half
//     of the tile's keys (the two halves of the warp add up at the end);
//     each p read from shared memory serves 8 FMAs a lane;
//   * tile rows are padded to an odd number of 16-byte phits, so 8 lanes'
//     rows (ldmatrix, cp.async) fall in distinct banks.
// Every block loads the key at `slot` from k_new/v_new, not from the cache,
// and only the block whose key range holds `slot` (and the first head
// group) writes it, so no block reads a cache row that another writes.
//
// Splits.  The host picks the number of key splits from the shape (rows x
// kv heads x head groups against the SMs, and T), never from kv_len, which
// stays on the device.  With one split the block writes `out`.  With more,
// each block writes its (max, sum, unnormalised p @ v) to float32 scratch,
// and the last block of its (row, head, group) to arrive (an atomic ticket)
// merges the splits in split order and writes `out`, then resets the ticket
// to 0 for the next launch.  One launch either way, reading pos and kv_len
// on the device and never synchronising, so a CUDA graph can capture it.
// The merge order is fixed, so results do not depend on which block is
// last: the kernel is deterministic.
//
// Interface: plain C; pointers and the stream as void*.  The entry returns
// cudaGetLastError() after its launch, or cudaErrorInvalidValue for a shape
// it does not take (head dim not a multiple of 16 or above 128, a head
// group above 8, or more shared memory than a block may have).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_common.cuh"

namespace {

using namespace hgum_attn;

constexpr int kWarps = 2;  // a block; 1, 3, 4 and 8 measured slower at the cells' calls
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;  // keys a warp tile holds
constexpr int kDimsPerLane = 8;  // head dims a lane owns in the p @ v pass
constexpr int kMaxGroup = 8;     // query heads a block holds
// p of a tile key for each head, padded so that the score pass's stores
// spread over the banks; 8-byte aligned for the p @ v pass's loads
constexpr int kPStride = kMaxGroup + 2;
constexpr int kMaxDim = 16 * kDimsPerLane;
constexpr int kMaxSmem = 232448 - 1024;  // 227 KB a Hopper block may use, less static
constexpr int kMaxDevices = 64;

struct Args {
  const void* q;      // (B, K, G, D)
  const void* k_new;  // (B, K, D)
  const void* v_new;  // (B, K, D)
  void* k_cache;      // (B, T, K, D), updated in place
  void* v_cache;
  const void* pos;    // (B,) int32 or int64
  void* out;          // (B, K, G, D)
  float* part_acc;    // (B K n_groups, n_splits, gc, D)
  float* part_ml;     // (B K n_groups, n_splits, gc, 2): running max, sum
  int* tickets;       // (B K n_groups), 0 between launches
  int T, K, G, D;
  int gc;             // query heads a group holds (the last group may hold fewer)
  int n_groups, n_splits, split_len;
  int pos64, window;
  float scale, cap;   // cap <= 0: no softcap
  int pitch;          // shared-memory bytes of one tile row
};

// Widening to float32: bf16 is the high half of a float32, so a shift.
template <typename T> struct Elem;

template <> struct Elem<__nv_bfloat16> {
  static constexpr int kPerPhit = 8;
  __device__ static __forceinline__ void phit(const uint4 w, float* f) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  __device__ static __forceinline__ void eight(const unsigned char* p, float* f) {
    phit(*reinterpret_cast<const uint4*>(p), f);
  }
  __device__ static __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
};

template <> struct Elem<float> {
  static constexpr int kPerPhit = 4;
  __device__ static __forceinline__ void phit(const uint4 w, float* f) {
    f[0] = __uint_as_float(w.x);
    f[1] = __uint_as_float(w.y);
    f[2] = __uint_as_float(w.z);
    f[3] = __uint_as_float(w.w);
  }
  __device__ static __forceinline__ void eight(const unsigned char* p, float* f) {
    phit(reinterpret_cast<const uint4*>(p)[0], f);
    phit(reinterpret_cast<const uint4*>(p)[1], f + 4);
  }
  __device__ static __forceinline__ float load(const float* p) { return *p; }
  __device__ static __forceinline__ void store(float* p, float x) { *p = x; }
};

// Copy rows [t0, t0 + n) of one head's keys (or values) into a tile, one
// 16-byte phit a lane: lane (row r, phit col) of each pass of `per_pass`
// rows (lanes past the last whole row idle); the row at `fresh_t` comes
// from `fresh`.
__device__ __forceinline__ void load_tile(unsigned char* tile, const unsigned char* rows,
                                          size_t row_stride, const unsigned char* fresh,
                                          long long fresh_t, int t0, int n, int r, int col,
                                          int per_pass, int pitch) {
  for (; r < n; r += per_pass) {
    const int t = t0 + r;
    const unsigned char* src = (t == fresh_t ? fresh : rows + static_cast<size_t>(t) * row_stride);
    cp_async16(tile + r * pitch + col * 16, src + col * 16);
  }
}

template <typename T, int GC>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_block;
  using E = Elem<T>;
  constexpr int kE = E::kPerPhit;

  const int split = blockIdx.x;
  const int h = blockIdx.y / a.n_groups;
  const int grp = blockIdx.y - h * a.n_groups;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = a.D;
  const int g0 = grp * a.gc;
  const int ng = min(a.gc, a.G - g0);
  const int phits = D * static_cast<int>(sizeof(T)) / 16;

  const long long p = a.pos64 ? static_cast<const long long*>(a.pos)[b]
                              : static_cast<long long>(static_cast<const int*>(a.pos)[b]);
  const long long slot = a.window ? p % a.T : p;
  const long long fresh_t = slot < a.T ? slot : -1;  // -1: the row keeps its old K/V
  const int kv_len = static_cast<int>(min(p + 1, static_cast<long long>(a.T)));
  const int k_begin = split * a.split_len;
  const int k_end = min(k_begin + a.split_len, kv_len);

  const size_t row_bytes = static_cast<size_t>(D) * sizeof(T);
  const size_t row_stride = static_cast<size_t>(a.K) * row_bytes;  // key t to key t + 1
  const size_t head_off = (static_cast<size_t>(b) * a.T * a.K + h) * row_bytes;
  unsigned char* kc = static_cast<unsigned char*>(a.k_cache) + head_off;
  unsigned char* vc = static_cast<unsigned char*>(a.v_cache) + head_off;
  const size_t new_off = (static_cast<size_t>(b) * a.K + h) * row_bytes;
  const unsigned char* kn = static_cast<const unsigned char*>(a.k_new) + new_off;
  const unsigned char* vn = static_cast<const unsigned char*>(a.v_new) + new_off;

  if (fresh_t >= k_begin && fresh_t < k_begin + a.split_len && grp == 0) {
    for (int i = tid; i < phits; i += kThreads) {
      reinterpret_cast<uint4*>(kc + fresh_t * row_stride)[i] = reinterpret_cast<const uint4*>(kn)[i];
      reinterpret_cast<uint4*>(vc + fresh_t * row_stride)[i] = reinterpret_cast<const uint4*>(vn)[i];
    }
  }

  // q of the group's heads: bf16 scores take it as the tensor cores' B
  // operand, in registers (lane (head n, t) holds dims 16 ks + 2 t, + 1 and
  // + 8, + 9); float32 ones from shared memory as float32 [GC][D]
  constexpr bool kTensorScores = std::is_same<T, __nv_bfloat16>::value;
  const T* qg = static_cast<const T*>(a.q) + ((static_cast<size_t>(b) * a.K + h) * a.G + g0) * D;
  float* q_s = reinterpret_cast<float*>(smem);
  uint32_t qb[kMaxDim / 16][2];
  if constexpr (kTensorScores) {
    const int n = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int ks = 0; ks < kMaxDim / 16; ++ks) {
      const bool in = n < ng && 16 * ks < D;
      const uint32_t* qw = reinterpret_cast<const uint32_t*>(qg + n * D + 16 * ks + 2 * tq);
      qb[ks][0] = in ? qw[0] : 0u;
      qb[ks][1] = in ? qw[4] : 0u;
    }
  } else {
    for (int i = tid; i < GC * D; i += kThreads) q_s[i] = i < ng * D ? E::load(qg + i) : 0.f;
    __syncthreads();
  }

  unsigned char* region = smem + (kTensorScores ? 0 : GC * D * sizeof(float));
  unsigned char* kbuf = region + warp * (2 * kTile * a.pitch + kTile * kPStride * sizeof(float));
  unsigned char* vbuf = kbuf + kTile * a.pitch;
  float* p_s = reinterpret_cast<float*>(vbuf + kTile * a.pitch);  // [kTile][kPStride]

  float m[GC], l[GC], acc[GC][kDimsPerLane];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kDimsPerLane; ++e) acc[g][e] = 0.f;
  }

  // The warp's tiles are warp, warp + kWarps, ...  Each is two cp.async
  // groups, its K rows then its V rows: V lands while the warp scores K,
  // and the next tile's K while it runs p @ v.
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kTile - 1) / kTile : 0;
  const int per_pass = 32 / phits;  // whole rows a pass of the warp copies
  const int lane_row = lane < per_pass * phits ? lane / phits : kTile;
  const int lane_col = lane - (lane / phits) * phits;
  // p @ v pass: lane (dim group, parity) owns head dims 8 dg .. 8 dg + 7 of
  // the tile's keys of its parity; the two parities add up at the end
  const int parity = lane >> 4;
  const int d0 = (lane & 15) * kDimsPerLane;
  if (warp < n_tiles) {
    const int t0 = k_begin + warp * kTile;
    const int n = min(kTile, k_end - t0);
    load_tile(kbuf, kc, row_stride, kn, fresh_t, t0, n, lane_row, lane_col, per_pass, a.pitch);
    cp_async_commit();
    load_tile(vbuf, vc, row_stride, vn, fresh_t, t0, n, lane_row, lane_col, per_pass, a.pitch);
    cp_async_commit();
  }
  for (int i = warp; i < n_tiles; i += kWarps) {
    const int t0 = k_begin + i * kTile;
    const int n = min(kTile, k_end - t0);
    const bool more = i + kWarps < n_tiles;
    const int t1 = t0 + kWarps * kTile;
    const int n1 = more ? min(kTile, k_end - t1) : 0;

    cp_async_wait<1>();
    __syncwarp();
    if constexpr (kTensorScores) {
      // scores on the tensor cores: the tile's 32 keys as two 16-key A
      // operands (ldmatrix from the K rows), q as B; lane (r, t) gets keys
      // r, r + 8, r + 16, r + 24 for heads 2 t and 2 t + 1
      float c[2][4] = {};
      const unsigned char* arow =
          kbuf + ((lane & 7) + 8 * ((lane >> 3) & 1)) * a.pitch + 16 * (lane >> 4);
#pragma unroll
      for (int ks = 0; ks < kMaxDim / 16; ++ks) {
        if (16 * ks < D) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            uint32_t af[4];
            ldmatrix_x4(af, arow + 16 * mt * a.pitch + 32 * ks);
            mma_bf16(c[mt], af, qb[ks]);
          }
        }
      }
      __syncwarp();
      if (more) {
        load_tile(kbuf, kc, row_stride, kn, fresh_t, t1, n1, lane_row, lane_col, per_pass, a.pitch);
        cp_async_commit();
      }
      const int r = lane >> 2, tq = lane & 3;
      float x[4][2], tm[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool valid = r + 8 * j < n;  // key r + 8 j: m-tile j / 2, row half j % 2
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = c[j >> 1][2 * (j & 1) + e] * a.scale;
          if (a.cap > 0.f) v = a.cap * tanhf(v / a.cap);
          x[j][e] = valid ? v : -INFINITY;
          tm[e] = fmaxf(tm[e], x[j][e]);
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) tm[e] = fmaxf(tm[e], __shfl_xor_sync(0xffffffffu, tm[e], o));
      }
      // every lane takes each head's tile max from lane head / 2
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        const float mn = fmaxf(m[g], __shfl_sync(0xffffffffu, tm[g & 1], g >> 1));
        const float corr = expf(m[g] - mn);
        l[g] *= corr;
#pragma unroll
        for (int e = 0; e < kDimsPerLane; ++e) acc[g][e] *= corr;
        m[g] = mn;
      }
      float mine[2], psum[2] = {0.f, 0.f};  // this lane's heads' new maxima
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mine[e] = -INFINITY;
#pragma unroll
        for (int g = e; g < GC; g += 2) mine[e] = g == 2 * tq + e ? m[g] : mine[e];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pj = r + 8 * j < n && 2 * tq + e < GC ? expf(x[j][e] - mine[e]) : 0.f;
          psum[e] += pj;
          if (2 * tq + e < GC) p_s[(r + 8 * j) * kPStride + 2 * tq + e] = pj;
        }
      }
      // l holds this lane's share of its two heads' sums; the rest add up later
#pragma unroll
      for (int g = 0; g < GC; ++g) l[g] += g == 2 * tq ? psum[0] : (g == 2 * tq + 1 ? psum[1] : 0.f);
    } else {
      // scores on the CUDA cores (a float32 cache): lane j scores key j for
      // every head of the group, q read from shared memory as broadcasts
      float s[GC] = {};
      const uint4* krow = reinterpret_cast<const uint4*>(kbuf + lane * a.pitch);
      for (int c = 0; c < phits; ++c) {
        float kf[kE];
        E::phit(krow[c], kf);
#pragma unroll
        for (int g = 0; g < GC; ++g) {
#pragma unroll
          for (int e = 0; e < kE; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(q_s + g * D + c * kE + e);
            s[g] = fmaf(qv.x, kf[e], s[g]);
            s[g] = fmaf(qv.y, kf[e + 1], s[g]);
            s[g] = fmaf(qv.z, kf[e + 2], s[g]);
            s[g] = fmaf(qv.w, kf[e + 3], s[g]);
          }
        }
      }
      __syncwarp();
      if (more) {
        load_tile(kbuf, kc, row_stride, kn, fresh_t, t1, n1, lane_row, lane_col, per_pass, a.pitch);
        cp_async_commit();
      }
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float x = s[g] * a.scale;
        if (a.cap > 0.f) x = a.cap * tanhf(x / a.cap);
        x = lane < n ? x : -INFINITY;
        const float mn = fmaxf(m[g], warp_max(x));
        const float corr = expf(m[g] - mn);
        const float pg = lane < n ? expf(x - mn) : 0.f;
        l[g] = l[g] * corr + pg;
#pragma unroll
        for (int e = 0; e < kDimsPerLane; ++e) acc[g][e] *= corr;
        m[g] = mn;
        p_s[lane * kPStride + g] = pg;
      }
    }
    if (more) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();

    // p @ v
    if (d0 < D) {
      const unsigned char* vcol = vbuf + d0 * sizeof(T);
      for (int t = parity; t < n; t += 2) {
        float vf[kDimsPerLane];
        E::eight(vcol + t * a.pitch, vf);
        float pt[GC];  // the same for each half-warp: broadcasts
        const float* prow = p_s + t * kPStride;
#pragma unroll
        for (int g = 0; g < GC; g += 2) {
          if (g + 1 < GC) {
            const float2 p2 = *reinterpret_cast<const float2*>(prow + g);
            pt[g] = p2.x;
            pt[g + 1] = p2.y;
          } else {
            pt[g] = prow[g];
          }
        }
#pragma unroll
        for (int g = 0; g < GC; ++g) {
#pragma unroll
          for (int e = 0; e < kDimsPerLane; ++e) acc[g][e] = fmaf(pt[g], vf[e], acc[g][e]);
        }
      }
    }
    __syncwarp();
    if (more) {
      load_tile(vbuf, vc, row_stride, vn, fresh_t, t1, n1, lane_row, lane_col, per_pass, a.pitch);
      cp_async_commit();
    }
  }
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    l[g] = warp_sum(l[g]);
#pragma unroll
    for (int e = 0; e < kDimsPerLane; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], 16);
  }

  // merge the block's warps (their tiles are free once every copy landed)
  cp_async_wait<0>();
  __syncthreads();
  float* cm = reinterpret_cast<float*>(region);  // [kWarps][GC]
  float* cl = cm + kWarps * GC;                  // [kWarps][GC]
  float* ca = cl + kWarps * GC;                  // [kWarps][GC][D]
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (lane == 0) {
      cm[warp * GC + g] = m[g];
      cl[warp * GC + g] = l[g];
    }
    if (!parity && d0 < D) {
#pragma unroll
      for (int e = 0; e < kDimsPerLane; ++e) ca[(warp * GC + g) * D + d0 + e] = acc[g][e];
    }
  }
  __syncthreads();

  const size_t bhg = (static_cast<size_t>(b) * a.K + h) * a.n_groups + grp;
  T* out = static_cast<T*>(a.out) + ((static_cast<size_t>(b) * a.K + h) * a.G + g0) * D;
  for (int idx = tid; idx < ng * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx - g * D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, cm[w * GC + g]);
    float sum = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = cm[w * GC + g];
      if (mw > -INFINITY) {
        const float f = expf(mw - mx);
        sum += cl[w * GC + g] * f;
        num += ca[(w * GC + g) * D + d] * f;
      }
    }
    if (a.n_splits == 1) {
      E::store(out + idx, num / sum);
    } else {
      const size_t part = (bhg * a.n_splits + split) * a.gc + g;
      a.part_acc[part * D + d] = num;
      if (d == 0) {
        a.part_ml[2 * part] = mx;
        a.part_ml[2 * part + 1] = sum;
      }
    }
  }
  if (a.n_splits == 1) return;

  // the last block of (row, head, group) to finish merges the splits
  __threadfence();
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(a.tickets + bhg, 1) == a.n_splits - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  for (int idx = tid; idx < ng * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx - g * D;
    const size_t first = bhg * a.n_splits * a.gc + g;
    float mx = -INFINITY;
    for (int sp = 0; sp < a.n_splits; ++sp) mx = fmaxf(mx, __ldcg(a.part_ml + 2 * (first + sp * a.gc)));
    float sum = 0.f, num = 0.f;
    for (int sp = 0; sp < a.n_splits; ++sp) {
      const size_t part = first + sp * a.gc;
      const float ms = __ldcg(a.part_ml + 2 * part);
      if (ms > -INFINITY) {
        const float f = expf(ms - mx);
        sum += __ldcg(a.part_ml + 2 * part + 1) * f;
        num += __ldcg(a.part_acc + part * D + d) * f;
      }
    }
    E::store(out + idx, num / sum);
  }
  if (tid == 0) a.tickets[bhg] = 0;
}

template <typename T, int GC>
int launch(Args a, int B, cudaStream_t stream) {
  const int phits = a.D * static_cast<int>(sizeof(T)) / 16;
  a.pitch = (phits % 2 ? phits : phits + 1) * 16;  // odd phits: conflict-free row reads
  const size_t tiles =
      static_cast<size_t>(kWarps) * (2 * kTile * a.pitch + kTile * kPStride * sizeof(float));
  const size_t merge = static_cast<size_t>(kWarps) * GC * (a.D + 2) * sizeof(float);
  const size_t q_bytes = std::is_same<T, float>::value ? GC * a.D * sizeof(float) : 0;
  const size_t smem = q_bytes + (tiles > merge ? tiles : merge);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  // above 48 KB a kernel needs the opt-in: raised as a device's launches need
  static size_t opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > opted_in[dev]) {
    e = cudaFuncSetAttribute(decode_attention_kernel<T, GC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in[dev] = smem;
  }
  const dim3 grid(a.n_splits, a.K * a.n_groups, B);
  decode_attention_kernel<T, GC><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_group(const Args& a, int B, int gc_max, cudaStream_t stream) {
  switch (gc_max) {
    case 1: return launch<T, 1>(a, B, stream);
    case 2: return launch<T, 2>(a, B, stream);
    case 4: return launch<T, 4>(a, B, stream);
    case 6: return launch<T, 6>(a, B, stream);
    case 8: return launch<T, 8>(a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 bfloat16, 1 float32 (q, k_new, v_new, the caches and out alike).
// gc_max: the register width of a head group (1, 2, 4, 6 or 8), >= gc.
int hgum_decode_attention(const void* q, const void* k_new, const void* v_new, void* k_cache,
                          void* v_cache, const void* pos, void* out, void* part_acc,
                          void* part_ml, void* tickets, int B, int T, int K, int G, int D,
                          int dtype, int pos64, int window, float scale, float cap, int gc,
                          int gc_max, int n_groups, int n_splits, int split_len, void* stream) {
  if (D % 16 != 0 || D > kMaxDim || gc < 1 || gc > gc_max || n_splits < 1 || split_len < 1 ||
      B < 1 || T < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.q = q;
  a.k_new = k_new;
  a.v_new = v_new;
  a.k_cache = k_cache;
  a.v_cache = v_cache;
  a.pos = pos;
  a.out = out;
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.tickets = static_cast<int*>(tickets);
  a.T = T;
  a.K = K;
  a.G = G;
  a.D = D;
  a.gc = gc;
  a.n_groups = n_groups;
  a.n_splits = n_splits;
  a.split_len = split_len;
  a.pos64 = pos64;
  a.window = window;
  a.scale = scale;
  a.cap = cap;
  a.pitch = 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_group<__nv_bfloat16>(a, B, gc_max, s);
  if (dtype == 1) return launch_group<float>(a, B, gc_max, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* hgum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
