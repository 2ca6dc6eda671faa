// Prefill attention on Hopper (sm_90a): S query positions over T keys, in
// one launch, with the masks of models.common.flash_attention.
//
// Replaces no TPU kernel.  The reference's blocked attention is plain jnp
// (flash_attention, src/repro/models/common.py, called from attn_forward
// and cross_attn_forward in src/repro/models/attention.py).  The port's
// plain torch version of the same function (models/common.py) casts q and
// K to float32, multiplies them in float32 GEMMs on the CUDA cores, scores
// every key of a 1024-key block before masking the causal half away, and
// writes each float32 score tile to device memory, then passes over it
// about five times.  This kernel keeps the scores in registers.
//
// What it computes, for batch row b, kv head h, query head g of h's group,
// query position s (its position q_offset + s = qp) and key t < T:
//   x    = softcap(scale * sum_d q[b,s,h,g,d] * k[b,t,h,d])
//   ok   = t < kv_len && (!causal || t <= qp) && (!window || qp - t < window)
//          && (no segments || segment_q[b,s] == segment_k[b,t])
//   out  = sum_t softmax_t(ok ? x : -inf) * v[b,t,h,:]
// A row with no key ok is the plain version's uniform average over all T
// keys (it adds -1e30 to every masked score, so they tie): out = mean_t v.
//
// Numbers.  For bf16 inputs the scores are float32 sums of exact bf16 x
// bf16 products on the tensor cores (mma m16n8k16, float32 accumulators).
// The softmax is float32 in registers.  p @ v keeps p in float32: p is
// carried to the tensor cores as three bf16 terms hi + mid + lo (each the
// bf16 rounding of what the terms before it left over, together p to
// within one float32 rounding), v is bf16 and so exact, and the three
// products accumulate in float32.  Nothing is rounded to TF32.  With
// p_bf16 only the hi term goes in, which is the plain version's cast of p.
// For float32 inputs everything runs on the CUDA cores in float32 (p_bf16
// rounds p and v to bf16 first).  Only the order of the float32 sums
// differs from the plain version; `out` is rounded once to q's dtype.
//
// What bounds it.  Causal attention over 1024 positions does about
// 4 S^2 D / 2 useful flops a head and reads each head's q, K and V once:
// 256 flops a byte and more at yi-6b's prefill (128 x 1024 tokens, 32
// heads of 128), so the tensor cores bound it; yi-6b's 32 layers need
// 3.5e13 flops a call, 36 ms at 989 TFLOP/s.  What the design does:
//   * a block holds 64 query rows of one kv head, its G query heads packed
//     with the positions (row r = s G + g), so every K/V tile in shared
//     memory serves all G heads; 4 warps of 16 rows each;
//   * K/V tiles of 64 keys, double-buffered with cp.async: the next tile
//     lands while the warps work on this one;
//   * under causal the loop ends at the block's last position and under a
//     window it starts at the first key its first position sees, so tiles
//     that every row masks are never loaded; only tiles that mask some
//     element of a warp's rows test each element (kv_len, causal, window,
//     segment ids), the others none;
//   * scores and p @ v on the tensor cores (mma.sync, the FlashAttention-2
//     layout): q in registers for the whole block, K and V through
//     ldmatrix (V transposed), p passed from the score accumulators to the
//     A operand in registers, the running max and sum per row in registers;
//   * the products that add into one accumulator lie far apart in the
//     instruction stream: the next 16 dims' K fragments load while these
//     multiply, and a 16-key step's V fragments load once, each of p's
//     three terms then running over every head dim before the next;
//   * tile rows padded to an odd number of 16-byte phits, so 8 rows of a
//     ldmatrix fall in distinct banks;
//   * the longest rows first: blocks run in order of their key ranges,
//     longest first, so the causal work spreads over the 132 SMs.
// The kernel writes `out` once, in q's dtype, and makes no float32 copy of
// q, K, V or the scores in device memory.
//
// Interface: plain C; pointers and the stream as void*.  The entry returns
// cudaGetLastError() after its launch, or cudaErrorInvalidValue for a shape
// it does not take (head dim not a multiple of 16 or above 128, more query
// rows or blocks than an int counts).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using namespace hgum_attn;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows (position, head) a bf16 block holds
constexpr int kKeys = 64;           // keys a bf16 K/V tile holds
constexpr int kMaxDim = 128;
constexpr int kRowsF = 4 * kWarps;  // float32 kernel: 4 rows a warp
constexpr int kKeysF = 32;          // and a key a lane
constexpr int kMaxSmem = 232448 - 1024;  // 227 KB a Hopper block may use, less static
constexpr int kMaxDevices = 64;

struct Args {
  const void* q;     // (B, S, K, G, D)
  const void* k;     // (B, T, K, D)
  const void* v;
  void* out;         // (B, S, K, G, D)
  const int* seg_q;  // (B, S), or null: no segments
  const int* seg_k;  // (B, T)
  int S, T, K, G, D;
  int kv_len;        // keys below it may be attended, 0 <= kv_len <= T
  int causal, has_window;
  long long window, q_offset;
  float scale, cap;  // cap <= 0: no softcap
  int p_bf16;
  int n_row_tiles;   // blocks a (row, kv head)
  int pitch;         // shared-memory bytes of one tile row
};

// The keys that the row at position s may attend, segment ids aside: an
// interval [lo, hi] of [0, T), empty where lo > hi.  The causal bound, the
// window and kv_len each cut one end.  Both ends rise with s.
struct Keys {
  int lo, hi;
};

__device__ __forceinline__ Keys row_keys(const Args& a, int s) {
  const long long qp = a.q_offset + s;
  long long lo = 0, hi = a.kv_len - 1;
  if (a.causal && qp < hi) hi = qp;
  if (a.has_window && qp - a.window + 1 > lo) lo = qp - a.window + 1;
  if (lo > a.T) lo = a.T;
  if (hi < -1) hi = -1;
  return {static_cast<int>(lo), static_cast<int>(hi)};
}

__device__ __forceinline__ bool in_keys(Keys k, int t) { return t >= k.lo && t <= k.hi; }

// Keys [begin, end) that some row of rows [r0, r1) may attend; empty when
// none may.
__device__ __forceinline__ void key_range(const Args& a, int r0, int r1, int* begin, int* end) {
  const int lo = row_keys(a, r0 / a.G).lo, hi = row_keys(a, (r1 - 1) / a.G).hi;
  *begin = lo;
  *end = hi + 1 > lo ? hi + 1 : lo;
}

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Element (row r, dim 0) of q or out, r = s G + g.
__device__ __forceinline__ size_t row_offset(const Args& a, int b, int h, int r) {
  const int s = r / a.G;
  return ((((static_cast<size_t>(b) * a.S + s) * a.K + h) * a.G) + (r - s * a.G)) * a.D;
}

// A row that no key may attend: the plain version's mean of v over [0, T),
// written at head dims d0, d0 + stride, ... of the row (vh: v of row b,
// head h, key 0).  Out of line: the kernels' loops stay small.
template <typename T>
__device__ __noinline__ void mean_v(const Args& a, const T* vh, T* orow, int d0, int stride) {
  const size_t step = static_cast<size_t>(a.K) * a.D;
  for (int d = d0; d < a.D; d += stride) {
    float sum = 0.f;
    for (int t = 0; t < a.T; ++t) sum += to_float(vh[t * step + d]);
    store(orow + d, sum / static_cast<float>(a.T));
  }
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) as three bf16 pairs hi + mid + lo: each the bf16 rounding of what
// the terms before it left over (each difference is exact in float32)
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float rx = x - __low2float(h), ry = y - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const __nv_bfloat162 l = __floats2bfloat162_rn(rx - __low2float(m), ry - __high2float(m));
  hi = bits(h);
  mid = bits(m);
  lo = bits(l);
}

// ---------------------------------------------------------------------------
// bf16: the tensor cores
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 2) prefill_attention_bf16(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int BK = gridDim.x / a.n_row_tiles;
  const int bh = blockIdx.x % BK;
  const int tile = a.n_row_tiles - 1 - blockIdx.x / BK;  // the longest rows first
  const int b = bh / a.K, h = bh - b * a.K;
  const int R = a.S * a.G;
  const int r0 = tile * kRows;
  const int r1 = min(r0 + kRows, R);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = a.D;
  const int phits = D / 8;  // 16-byte phits of a row
  int k_begin, k_end;
  key_range(a, r0, r1, &k_begin, &k_end);
  const int n_tiles = (k_end - k_begin + kKeys - 1) / kKeys;

  using bf16 = __nv_bfloat16;
  const size_t kv_step = static_cast<size_t>(a.K) * D;  // key t to key t + 1
  const bf16* kh = static_cast<const bf16*>(a.k) + (static_cast<size_t>(b) * a.T * a.K + h) * D;
  const bf16* vh = static_cast<const bf16*>(a.v) + (static_cast<size_t>(b) * a.T * a.K + h) * D;
  unsigned char* q_s = smem;                     // [kRows][pitch]
  unsigned char* k_s = q_s + kRows * a.pitch;    // [2][kKeys][pitch]
  unsigned char* v_s = k_s + 2 * kKeys * a.pitch;

  for (int i = tid; i < kRows * phits; i += kThreads) {
    const int row = i / phits, c = i - row * phits;
    unsigned char* dst = q_s + row * a.pitch + c * 16;
    if (r0 + row < R) {
      cp_async16(dst, static_cast<const bf16*>(a.q) + row_offset(a, b, h, r0 + row) + c * 8);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  // keys past k_end land as zeros: their scores are masked and their v,
  // times p = 0, adds nothing
  auto load_kv = [&](int stage, int t0) {
    unsigned char* kd = k_s + stage * kKeys * a.pitch;
    unsigned char* vd = v_s + stage * kKeys * a.pitch;
    for (int i = tid; i < kKeys * phits; i += kThreads) {
      const int row = i / phits, c = i - row * phits;
      const int t = t0 + row;
      const bool in = t < k_end;
      const size_t off = (in ? t : k_begin) * kv_step + c * 8;
      cp_async16_zfill(kd + row * a.pitch + c * 16, kh + off, in);
      cp_async16_zfill(vd + row * a.pitch + c * 16, vh + off, in);
    }
  };
  if (n_tiles > 0) load_kv(0, k_begin);
  cp_async_commit();
  if (n_tiles > 1) load_kv(1, k_begin + kKeys);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // a warp of rows past the last holds nothing and only keeps step
  const bool idle = r0 + warp * 16 >= R;
  // q as the A operand, in registers for the whole block
  uint32_t qf[kMaxDim / 16][4] = {};
  {
    const unsigned char* qrow =
        q_s + (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * a.pitch + 16 * (lane >> 4);
#pragma unroll
    for (int ks = 0; ks < kMaxDim / 16; ++ks) {
      if (16 * ks < D) ldmatrix_x4(qf[ks], qrow + 32 * ks);
    }
  }
  // this lane's rows: grp and grp + 8 of the warp's 16 (the mma's layout);
  // rows past the last compute on zeros and are not written
  const int grp = lane >> 2, tq = lane & 3;
  Keys keys[2];
  int sq[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = min(r0 + warp * 16 + grp + 8 * i, R - 1) / a.G;
    keys[i] = row_keys(a, s);
    sq[i] = a.seg_q ? a.seg_q[static_cast<size_t>(b) * a.S + s] : 0;
  }
  const int* sk = a.seg_q ? a.seg_k + static_cast<size_t>(b) * a.T : nullptr;
  // the keys every row of the warp may attend: from its last row's lo to
  // its first row's hi (both ends rise with the position)
  const int w_lo = row_keys(a, min(r0 + warp * 16 + 15, R - 1) / a.G).lo;
  const int w_hi = row_keys(a, min(r0 + warp * 16, R - 1) / a.G).hi;

  float o[kMaxDim / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const unsigned char* krow =
      k_s + ((lane & 7) + 8 * (lane >> 4)) * a.pitch + 16 * ((lane >> 3) & 1);
  const unsigned char* vrow =
      v_s + ((lane & 7) + 8 * ((lane >> 3) & 1)) * a.pitch + 16 * (lane >> 4);

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    const int t0 = k_begin + it * kKeys;
    if (!idle) {
      // scores: lane (grp, tq) holds c[j] = rows grp, grp + 8 at keys
      // t0 + 8 j + 2 tq, + 1
      float c[kKeys / 8][4] = {};
      const unsigned char* kb = krow + stage * kKeys * a.pitch;
      // (the next 16 dims' K fragments load while these multiply)
      {
        uint32_t kf[2][kKeys / 16][4];
#pragma unroll
        for (int np = 0; np < kKeys / 16; ++np) ldmatrix_x4(kf[0][np], kb + 16 * np * a.pitch);
#pragma unroll
        for (int ks = 0; ks < kMaxDim / 16; ++ks) {
          if (16 * ks < D) {
            if (16 * (ks + 1) < D) {
#pragma unroll
              for (int np = 0; np < kKeys / 16; ++np) {
                ldmatrix_x4(kf[(ks + 1) & 1][np], kb + 16 * np * a.pitch + 32 * (ks + 1));
              }
            }
#pragma unroll
            for (int np = 0; np < kKeys / 16; ++np) {
              mma_bf16(c[2 * np], qf[ks], kf[ks & 1][np]);
              mma_bf16(c[2 * np + 1], qf[ks], kf[ks & 1][np] + 2);
            }
          }
        }
      }
      // only a tile that reaches past the keys some row of the warp may
      // attend tests its elements
      const bool whole = sk == nullptr && t0 >= w_lo && t0 + kKeys - 1 <= w_hi;
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = c[j][e] * a.scale;
          if (a.cap > 0.f) x = a.cap * tanhf(x / a.cap);
          c[j][e] = x;
        }
      }
      if (!whole) {
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = t0 + 8 * j + 2 * tq + (e & 1);
            if (!in_keys(keys[e >> 1], t)) c[j][e] = -INFINITY;
          }
        }
        if (sk != nullptr) {
#pragma unroll
          for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int t = t0 + 8 * j + 2 * tq + u;
              const int st = t < a.T ? __ldg(sk + t) : -1;
              if (st != sq[0]) c[j][u] = -INFINITY;
              if (st != sq[1]) c[j][2 + u] = -INFINITY;
            }
          }
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], c[j][e]);
      }
      // online softmax: a row's four lanes share its max
      float base[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float mn = fmaxf(m[i], mx[i]);
        base[i] = mn == -INFINITY ? 0.f : mn;  // no key yet: exp(-inf - 0) = 0
        const float corr = expf(m[i] - base[i]);
        m[i] = mn;
        l[i] *= corr;
#pragma unroll
        for (int nt = 0; nt < kMaxDim / 8; ++nt) {
          o[nt][2 * i] *= corr;
          o[nt][2 * i + 1] *= corr;
        }
      }
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(c[j][e] - base[e >> 1]);
          l[e >> 1] += p;  // this lane's share; the four lanes add up at the end
          c[j][e] = p;
        }
      }
      // p @ v: p's 16 keys of a step as the A operand, straight from the
      // score accumulators, in three bf16 terms
      // (the 16-key step's V fragments are loaded first and each term runs
      // over every head dim before the next, so the products that add into
      // one accumulator lie 16 apart)
      const unsigned char* vb = vrow + stage * kKeys * a.pitch;
#pragma unroll
      for (int kc = 0; kc < kKeys / 16; ++kc) {
        uint32_t terms[3][4];  // lo, mid, hi
        split3(c[2 * kc][0], c[2 * kc][1], terms[2][0], terms[1][0], terms[0][0]);
        split3(c[2 * kc][2], c[2 * kc][3], terms[2][1], terms[1][1], terms[0][1]);
        split3(c[2 * kc + 1][0], c[2 * kc + 1][1], terms[2][2], terms[1][2], terms[0][2]);
        split3(c[2 * kc + 1][2], c[2 * kc + 1][3], terms[2][3], terms[1][3], terms[0][3]);
        uint32_t vf[kMaxDim / 16][4];
#pragma unroll
        for (int np = 0; np < kMaxDim / 16; ++np) {
          if (16 * np < D) ldmatrix_x4_trans(vf[np], vb + 16 * kc * a.pitch + 32 * np);
        }
#pragma unroll
        for (int term = 0; term < 3; ++term) {
          if (term == 2 || !a.p_bf16) {
#pragma unroll
            for (int np = 0; np < kMaxDim / 16; ++np) {
              if (16 * np < D) {
                mma_bf16(o[2 * np], terms[term], vf[np]);
                mma_bf16(o[2 * np + 1], terms[term], vf[np] + 2);
              }
            }
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
    if (it + 2 < n_tiles) load_kv(stage, t0 + 2 * kKeys);
    cp_async_commit();
    cp_async_wait<1>();  // the next tile has landed
    __syncthreads();
  }
  if (idle) return;

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + warp * 16 + grp + 8 * i;
    if (r >= R) continue;
    bf16* orow = static_cast<bf16*>(a.out) + row_offset(a, b, h, r);
    if (l[i] > 0.f) {
      const float inv = 1.f / l[i];
#pragma unroll
      for (int nt = 0; nt < kMaxDim / 8; ++nt) {
        const int d = 8 * nt + 2 * tq;
        if (d < D) {
          *reinterpret_cast<__nv_bfloat162*>(orow + d) =
              __floats2bfloat162_rn(o[nt][2 * i] * inv, o[nt][2 * i + 1] * inv);
        }
      }
    } else {
      mean_v(a, vh, orow, tq, 4);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: the CUDA cores (a lane scores one key of a 32-key tile for each
// of its warp's 4 rows; in p @ v it owns head dims lane, lane + 32, ...)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) prefill_attention_f32(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int BK = gridDim.x / a.n_row_tiles;
  const int bh = blockIdx.x % BK;
  const int tile = a.n_row_tiles - 1 - blockIdx.x / BK;
  const int b = bh / a.K, h = bh - b * a.K;
  const int R = a.S * a.G;
  const int r0 = tile * kRowsF;
  const int r1 = min(r0 + kRowsF, R);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = a.D, P = D + 1;  // an odd pitch: lane j's key row in its own bank
  int k_begin, k_end;
  key_range(a, r0, r1, &k_begin, &k_end);

  const size_t kv_step = static_cast<size_t>(a.K) * D;
  const float* kh = static_cast<const float*>(a.k) + (static_cast<size_t>(b) * a.T * a.K + h) * D;
  const float* vh = static_cast<const float*>(a.v) + (static_cast<size_t>(b) * a.T * a.K + h) * D;
  float* q_s = reinterpret_cast<float*>(smem);  // [kRowsF][D]
  float* k_s = q_s + kRowsF * D;                // [kKeysF][P]
  float* v_s = k_s + kKeysF * P;
  for (int i = tid; i < kRowsF * D; i += kThreads) {
    const int row = i / D, d = i - row * D;
    q_s[i] = r0 + row < R ? static_cast<const float*>(a.q)[row_offset(a, b, h, r0 + row) + d]
                          : 0.f;
  }

  constexpr int kPer = kRowsF / kWarps;  // rows a warp
  constexpr int kDims = kMaxDim / 32;    // head dims a lane
  Keys keys[kPer];
  int sq[kPer];
  float m[kPer], l[kPer], acc[kPer][kDims];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int s = min(r0 + warp * kPer + j, R - 1) / a.G;
    keys[j] = row_keys(a, s);
    sq[j] = a.seg_q ? a.seg_q[static_cast<size_t>(b) * a.S + s] : 0;
    m[j] = -INFINITY;
    l[j] = 0.f;
#pragma unroll
    for (int i = 0; i < kDims; ++i) acc[j][i] = 0.f;
  }
  for (int t0 = k_begin; t0 < k_end; t0 += kKeysF) {
    __syncthreads();  // the last tile is consumed (and q stored)
    for (int i = tid; i < kKeysF * D; i += kThreads) {
      const int row = i / D, d = i - row * D;
      const bool in = t0 + row < k_end;
      const size_t off = static_cast<size_t>(t0 + row) * kv_step + d;
      k_s[row * P + d] = in ? kh[off] : 0.f;
      v_s[row * P + d] = in ? vh[off] : 0.f;
    }
    __syncthreads();
    const int t = t0 + lane;
    const int st = a.seg_q && t < a.T ? a.seg_k[static_cast<size_t>(b) * a.T + t] : 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const float* qr = q_s + (warp * kPer + j) * D;
      const float* kr = k_s + lane * P;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      float x = s * a.scale;
      if (a.cap > 0.f) x = a.cap * tanhf(x / a.cap);
      if (!in_keys(keys[j], t) || (a.seg_q && st != sq[j])) x = -INFINITY;
      const float mn = fmaxf(m[j], warp_max(x));
      const float base = mn == -INFINITY ? 0.f : mn;
      const float corr = expf(m[j] - base);
      const float p = expf(x - base);
      m[j] = mn;
      l[j] = l[j] * corr + p;  // this lane's share
      const float pv = a.p_bf16 ? bf16_round(p) : p;
#pragma unroll
      for (int i = 0; i < kDims; ++i) acc[j][i] *= corr;
      for (int u = 0; u < kKeysF; ++u) {
        const float pu = __shfl_sync(0xffffffffu, pv, u);
#pragma unroll
        for (int i = 0; i < kDims; ++i) {
          const int d = lane + 32 * i;
          if (d < D) {
            const float vv = v_s[u * P + d];
            acc[j][i] = fmaf(pu, a.p_bf16 ? bf16_round(vv) : vv, acc[j][i]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const float lj = warp_sum(l[j]);
    const int r = r0 + warp * kPer + j;
    if (r >= R) continue;
    float* orow = static_cast<float*>(a.out) + row_offset(a, b, h, r);
    if (lj > 0.f) {
#pragma unroll
      for (int i = 0; i < kDims; ++i) {
        const int d = lane + 32 * i;
        if (d < D) orow[d] = acc[j][i] / lj;
      }
    } else {
      mean_v(a, vh, orow, lane, 32);
    }
  }
}

// Opt a kernel into the shared memory it asks for above 48 KB, once a
// device and size.
template <typename Kernel>
int opt_in(Kernel kernel, size_t smem, size_t* opted_in) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > opted_in[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in[dev] = smem;
  }
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 bfloat16, 1 float32 (q, k, v and out alike).  seg_q and seg_k:
// int32 (B, S) and (B, T), or both null.  kv_len in [0, T].
int hgum_prefill_attention(const void* q, const void* k, const void* v, void* out,
                           const void* seg_q, const void* seg_k, int B, int S, int T, int K,
                           int G, int D, int dtype, int kv_len, int causal, int has_window,
                           long long window, long long q_offset, float scale, float cap,
                           int p_bf16, void* stream) {
  if (D % 16 != 0 || D < 16 || D > kMaxDim || B < 1 || S < 1 || T < 1 || K < 1 || G < 1 ||
      kv_len < 0 || kv_len > T || (seg_q == nullptr) != (seg_k == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.seg_q = static_cast<const int*>(seg_q);
  a.seg_k = static_cast<const int*>(seg_k);
  a.S = S;
  a.T = T;
  a.K = K;
  a.G = G;
  a.D = D;
  a.kv_len = kv_len;
  a.causal = causal;
  a.has_window = has_window;
  a.window = window;
  a.q_offset = q_offset;
  a.scale = scale;
  a.cap = cap;
  a.p_bf16 = p_bf16;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long R = static_cast<long long>(S) * G;
  size_t smem;
  int rows;  // query rows a block holds
  if (dtype == 0) {
    const int phits = D / 8;
    a.pitch = (phits % 2 ? phits : phits + 1) * 16;  // odd phits: conflict-free ldmatrix
    rows = kRows;
    smem = static_cast<size_t>(kRows + 4 * kKeys) * a.pitch;
  } else if (dtype == 1) {
    a.pitch = 0;
    rows = kRowsF;
    smem = (static_cast<size_t>(kRowsF) * D + 2 * static_cast<size_t>(kKeysF) * (D + 1)) *
           sizeof(float);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = (R + rows - 1) / rows;
  const long long blocks = tiles * B * K;
  if (smem > static_cast<size_t>(kMaxSmem) || R > 0x7fffffffLL || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.n_row_tiles = static_cast<int>(tiles);
  static size_t opted_bf16[kMaxDevices] = {}, opted_f32[kMaxDevices] = {};
  int e;
  if (dtype == 0) {
    e = opt_in(prefill_attention_bf16, smem, opted_bf16);
    if (e != 0) return e;
    prefill_attention_bf16<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(a);
  } else {
    e = opt_in(prefill_attention_f32, smem, opted_f32);
    if (e != 0) return e;
    prefill_attention_f32<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* hgum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
