// Routed-fabric frame assembly, RX split, stream-fragment assembly, the SER
// payload run and HW-to-HW header stamping on Hopper (sm_90a).
//
// Seven entry points.  Each replaces a Pallas body of the reference
// src/repro/kernels/frame_pack.py:
//
//   hgum_pack_run             <- _pack_kernel_aligned (frame_pack.py:24),
//                                called from pack_run (:30)
//   hgum_stamp_headers        <- _header_kernel   (frame_pack.py:68),
//                                called from stamp_headers (:207)
//   hgum_pack_frames_batch    <- _assemble_kernel (frame_pack.py:82),
//                                called from pack_frames_batch (:88)
//   hgum_frame_batch          <- the same, with the structure pass that
//                                feeds it (src/repro/fabric/frames.py:233)
//                                built into the launch
//   hgum_unpack_frames_batch  <- _split_kernel    (frame_pack.py:168),
//                                called from unpack_frames_batch (:174)
//   hgum_pack_chunks_batch    <- _chunk_kernel    (frame_pack.py:118),
//                                called from pack_chunks_batch (:125), with
//                                the tail mask of the reference
//                                kernels/ops.py:encode_chunks_batch fused in
//   hgum_chunk_bursts         <- the same, each row trimmed to its live
//                                words at an offset, for many lanes at once
//
// Frame build and join (B5).  A frame is one row of `width = 4 +
// frame_words` u32 words: the header phit [size | level | crc32 | route]
// and then the payload.  frame_words is 4 * frame_phits, so a frame is
// 1 + frame_phits whole 16-byte phits, and every frame row starts on a phit
// (272 bytes = 17 phits at frame_phits = 16).  One kernel body, two
// instances (template parameter kBuild):
//   * hgum_frame_batch (kBuild): B streams of payload words -> (B, F, width)
//     frames, F = ceil(Wcap / frame_words) + 1 (the size-0 terminator
//     included), with the headers built in the same launch.  It replaces
//     the structure pass of the reference (src/repro/fabric/frames.py:233,
//     frame_parts_batch, under jit one fused XLA program) together with the
//     Pallas join.  For frame f of stream b:
//       size  = clamp(nbytes[b] - 4 f frame_words, 0, 4 frame_words)
//       level = levels[b]
//       route = adaptive << 31 | (src & 0x7F) << 24 | (dst & 0xFF) << 16
//               | ((seq0 + f) & 0xFFFF)
//       crc   = CRC-32 (zlib) of size | level | route | payload
//     and the payload words at or past ceil(nbytes / 4) (or past Wcap) are 0.
//   * hgum_pack_frames_batch (join): the Pallas _assemble_kernel's function,
//     given header rows (rows, 4) and payload rows (rows, frame_words).
//
// Layout.  A warp owns G consecutive frames (the build: 32 / kCrcLanes = 8;
// the join: 32).  Its lanes first copy the frames' payload phits (16-byte
// loads and stores, neighbouring lanes on neighbouring phits; the join
// copies the header phits too), then the build's kCrcLanes = 4 lanes per
// frame compute that frame's CRC and one of them stores its header phit.
// Index math is 32-bit (a division by frame_phits per phit, never a 64-bit
// division per word); blocks stride over the frames.
//
// The CRC.  Slicing-by-4 (one step per u32 word, four lookups of 256-entry
// tables) with the tables in shared memory: lanes look up different
// entries, which __constant__ memory would serialise.  The CRC input is
// read as phits: the header phit [0 | size | level | route] (a zero word in
// front of a zero-initialised CRC changes nothing) and then the payload
// phits, re-read through L1/L2 rather than staged.  The input is cut into
// kCrcLanes equal runs of S phits (zero phits in front pad it out, for the
// same reason), each lane takes the zero-initialised CRC of its run, and
// two shuffle steps join neighbours as zlib's crc32_combine does:
// crc(A B) = shift(crc(A), |B|) ^ crc(B), where the shift by a fixed
// length is linear and so is four lookups of a table made on the host.  The CRC with zlib's initial and final xor is then the
// zero-initialised one xor `crc_xor` = shift(~0, message bytes) ^ ~0.
//
// What bounds them.  The join moves bytes only: each input word read once,
// each output word written once.  The build adds the CRC: four shared
// lookups per word, a few per cent of the time that 2**20 frames take at
// the byte bound if the lookups did not conflict, but 32 random lookups
// meet on a bank about 3.5 deep, and the combine's lookups come on top;
// the lanes per frame trade that work against the length of each lane's
// dependent chain.  Four lanes measured fastest on an H100 at 2**20 frames,
// ahead of one (a chain of 68 steps) and of 32 (one warp per frame).
//
// RX split (B6).  unpack_frames_batch splits delivered frames (rows, width)
// back into headers (rows, 4) and payloads (rows, frame_words), the mirror
// of B5's join.  The frames are one flat run of units (a unit is a phit or
// a word), and so are the two outputs: unit j = r * per_frame + c of the
// frames, c the column in frame r, goes to hdr[r H + c] when c < H (the H
// units of a header) and to pay[j - H (r + 1)] otherwise.  One kernel body,
// two forms (template parameter T):
//   * whole phits (T = uint4, H = 1): frame_words % 4 == 0 and all three
//     base pointers 16-byte aligned, which every fabric call meets (the
//     wrapper's two outputs are views of one buffer, the payloads at
//     rows * 16 bytes).  A frame is 1 + P phits, each one 16-byte load and
//     one 16-byte store; index math is 32-bit (the host refuses rows (1 + P)
//     >= 2**32 phits);
//   * words (T = uint32, H = 4): any other width, or a frames tensor whose
//     base is not 16-byte aligned (a view at a storage offset); 32-bit index
//     math where the words fit in 32 bits, 64-bit past that.
// Layout: thread t takes units t, t + S, ..., t + (U - 1) S, S the grid's
// threads (neighbouring threads take neighbouring units: loads are
// coalesced, and stores too but where a warp crosses a frame edge), and
// loads all U before it stores any: one phit, or four words, so 16 bytes
// are in flight per thread in either form.  A thread divides once, for the
// frame and column of its first unit; the next units' follow by adding the
// grid stride in frames and units, which the host computes, with one
// carry.  The grid holds a thread for every U units.  On an H100 at 2**20
// frames these U were the fastest of 1, 2 and 4, grids that stride over the
// frames (4 to 32 blocks per SM) were slower in both forms, and __ldcs /
// __stcs changed nothing (PERF.md; scripts/b6_variants.py times those
// variants of this body).  Bound: bytes (the frames read once, headers and
// payloads written once).

// Stream fragments (B7).  The streaming plane serializes every decode
// tick's token and logprob fragments into bursts, one per lane.  A
// fragment is one row of `width = cap_w + 4` words:
//   [stream_id | step | flags | cap_w element words | count]
// with the element count AFTER the elements (paper section IV-B).  Word c
// of row r is meta[r, c] for c < 3, counts[r] for the last word, and
// tokens[r, c - 3] where c - 3 < live = counts[r] * elem_words (a u32
// product, as the reference computes it), else 0.  One kernel body, two
// instances (template parameter kTrim):
//   * hgum_pack_chunks_batch (padded): the reference's rows, width words
//     each at r * width; elem_words == 0 turns the mask off (the Pallas
//     body's concatenation of pre-masked tokens).  The TPU kernel padded
//     the rows to blocks of 8 and sliced them off again; nothing is padded
//     here.
//   * hgum_chunk_bursts (trimmed): row r is exactly [meta | live words |
//     count], live = min(counts[r] * elem_words[r], cap_w) with elem_words
//     given per row (1 for the token plan, 2 for the logprob plan), written
//     from word offsets[r] of one flat output.  The host computes the
//     offsets as an int64 prefix sum of the row lengths, so the rows of
//     every lane of a tick abut and each lane's burst is a slice; one
//     launch serves them all where one launch per lane served before.  No
//     word outside [0, n_words) is written whatever the offsets.
// Layout: a group of g = 2**group_shift lanes owns a row, so small rows
// share a warp; groups stride over the rows.  Index math inside a row is
// 32-bit and has no division: lane j of the group takes words j, j + g,
// ... and loads U of them before it stores any (loads in flight, coalesced
// along the row).  g is the smallest power of two with 2 U g >= width (at
// most 32): a full row takes two steps of U loads a lane.  U is 4 for the
// padded rows and 2 for the trimmed ones, whose live words are on average
// about half the width; of six layouts tried on an H100 at 2**20 rows of
// 64 words (g from 8 to 32, U from 2 to 8), these were the fastest for
// each form.  The count, elem_words and offset of the
// group's next row are loaded one row ahead, so a row's token loads do not
// wait on its count.  Rows start at any word, so stores are 4 bytes wide
// (coalesced; a 16-byte store would need the row start aligned).  Bound:
// bytes (meta, counts, per-row elem_words and offsets read, the live
// element words read, the rows written).

// SER payload run (B4).  N tokens of nlanes u32 lanes go into the wire at a
// pitch of stride_w words: for word c of row r,
//   out[r * stride_w + c] = c < nlanes ? tok[r, c] & lane_mask(c) : 0
// where lane_mask zeroes the bytes past nbytes.  The TPU kernel padded the
// tokens to the pitch and to blocks of 8 rows and then reshaped one VMEM tile;
// here the grid is flat over the output words, so neither pad is needed and
// the zero words are written, never read.  Bound: bytes (the token bytes
// read once, the wire written once).  Accesses are 4 bytes wide, coalesced
// on the output side.
//
// Header stamping (B8).  A copy of the wire with, for each of the H headers
// [word, size, list_level] in order, size at `word` and list_level at
// `word + 1`; slots outside [0, W) are dropped.  The Pallas body is one grid
// step with a serial loop over the headers, so where the slots of two
// headers meet (a repeated or an overlapping word) the LAST header wins.  A
// parallel stamp would race there.  One persistent cooperative launch
// (cudaLaunchCooperativeKernel, a grid that the card holds at once:
// cudaOccupancyMaxActiveBlocksPerMultiprocessor times the SMs, at most four
// blocks of 256 per SM) runs grid-stride phases with a grid sync between
// them:
//   1. copy the wire to the output, and look for two neighbouring headers
//      whose words are not increasing by at least 2;
//   2. (after two syncs, which publish that finding in a flag word) if
//      there are none, no two slots meet: every header writes its slots.
//      A framer writes its headers in stream order, so its tables take
//      this path;
//   otherwise an owner pass decides each slot:
//   2'. set owner[slot] = -1 for every slot that a header writes (a scratch
//      of W words from the caching allocator: only those slots are touched,
//      none is initialised);
//   3'. owner[slot] = atomicMax over the indices of the headers that write it;
//   4'. each header writes its two slots where it is the owner.
// Two slots of one header never meet, so the header index orders them fully.
// Three launches each cost the host a launch and lost to clone() +
// index_put_ at the framed stream; the owner pass alone at 2**21 scattered
// slots of a 256 MiB wire cost about as much as the copy (PERF.md), since
// every 4-byte scatter is a read-modify-write of a 32-byte sector, which
// is why ordered tables skip it.  The copy moves 16-byte vectors, four in
// flight per thread, where both wire and output are 16-byte aligned, and
// single words otherwise (a wire view); the later phases cost work in
// proportion to the 2H header writes, not to the wire, and are skipped,
// syncs included, when H = 0.  The owner pass was chosen over blocks that
// own slot ranges because those need the table sorted, or each block to
// scan all H headers.  Bound: bytes (the wire read once and written once,
// the header table read once).  A launch that the card refuses returns its
// error: there is no fallback to separate launches.

// Interface: plain C, pointers and the stream as void*, 64-bit sizes.  Each
// entry returns the launch's error (cudaGetLastError(), or the cooperative
// launch's return); launches are asynchronous on the given stream and
// allocate nothing (B8's owner scratch comes from the caller).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kHdrWords = 4;
constexpr int kChunkMetaWords = 3;  // stream_id, step, flags
constexpr int kSplitPhitsPerThread = 1;  // B6's U, whole phits
constexpr int kSplitWordsPerThread = 4;  // B6's U, words

constexpr int kCrcTableWords = 4 * 256;
// CRC lanes per frame of the build; the host makes log2(kCrcLanes) shift
// tables for it (kernels/frame_pack.py, crc_tables)
constexpr uint32_t kCrcLanes = 4;
constexpr int kCrcSteps = 2;  // log2(kCrcLanes)

// Everything a frame launch reads; unused pointers are null.
struct FrameArgs {
  const uint32_t* pay;        // payload rows (streams, row_words)
  const uint32_t* hdr;        // join: header rows (rows, 4)
  const long long* nbytes;    // build: (streams,)
  const long long* routes;    // build: (streams, 3) src, dst, seq0
  const long long* levels;    // build: (streams,)
  const uint32_t* tables;     // build: CRC tables, then kCrcSteps shift tables
  uint32_t* out;              // (n_frames, 4 + 4 * phits)
  uint32_t n_frames;          // streams * F
  uint32_t F;                 // frames per stream (join: 1)
  uint32_t row_words;         // words per payload row (join: 4 * phits)
  uint32_t phits;             // payload phits per frame
  uint32_t crc_xor;           // shift(~0, message bytes) ^ ~0
  uint32_t route_flag;        // the adaptive bit, or 0
  int vec_in;                 // input rows are 16-byte aligned
};

__device__ __forceinline__ uint4 load_phit(const uint32_t* __restrict__ row, uint32_t w0,
                                           uint32_t limit, bool vec) {
  if (w0 >= limit) return make_uint4(0u, 0u, 0u, 0u);
  if (vec && w0 + 4 <= limit) return __ldg(reinterpret_cast<const uint4*>(row + w0));
  uint32_t v[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) v[t] = w0 + t < limit ? __ldg(row + w0 + t) : 0u;
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// the table layout of fabric/frames.py: T3 for byte 0, T2, T1, T0 for byte 3
__device__ __forceinline__ uint32_t lookup4(const uint32_t* t, uint32_t x) {
  return t[x & 0xFFu] ^ t[256 + ((x >> 8) & 0xFFu)] ^ t[512 + ((x >> 16) & 0xFFu)] ^
         t[768 + (x >> 24)];
}

__device__ __forceinline__ uint32_t crc_phit(const uint32_t* t, uint32_t crc, uint4 v) {
  crc = lookup4(t, v.x ^ crc);
  crc = lookup4(t, v.y ^ crc);
  crc = lookup4(t, v.z ^ crc);
  return lookup4(t, v.w ^ crc);
}

// frames per warp
template <bool kBuild>
__host__ __device__ constexpr uint32_t frames_per_warp() {
  return kBuild ? 32 / kCrcLanes : 32;
}

template <bool kBuild>
__global__ void __launch_bounds__(kThreads) frame_kernel(const FrameArgs a) {
  constexpr uint32_t G = frames_per_warp<kBuild>();
  __shared__ uint32_t tab[kBuild ? kCrcTableWords * (1 + kCrcSteps) : 1];
  if (kBuild) {
    for (int i = threadIdx.x; i < kCrcTableWords * (1 + kCrcSteps); i += blockDim.x) {
      tab[i] = __ldg(a.tables + i);
    }
    __syncthreads();
  }
  const uint32_t lane = threadIdx.x & 31u;
  const uint32_t P = a.phits, fw = 4 * P, width = fw + 4;
  const uint32_t per_frame = kBuild ? P : P + 1;  // phits the copy writes
  const uint32_t warps = gridDim.x * (blockDim.x >> 5);
  for (uint32_t first = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * G;
       first < a.n_frames; first += warps * G) {
    const uint32_t n_here = min(G, a.n_frames - first);
    for (uint32_t k = lane; k < n_here * per_frame; k += 32) {
      const uint32_t g = k / per_frame, c = k - g * per_frame;
      const uint32_t fr = first + g;
      uint4 v;
      uint32_t* dst = a.out + static_cast<size_t>(fr) * width;
      if (kBuild) {
        const uint32_t s = fr / a.F, f = fr - s * a.F;
        const long long words = (__ldg(a.nbytes + s) + 3) >> 2;
        const uint32_t limit = static_cast<uint32_t>(
            words < 0 ? 0 : (words > a.row_words ? a.row_words : words));
        v = load_phit(a.pay + static_cast<size_t>(s) * a.row_words, f * fw + 4 * c, limit,
                      a.vec_in);
        dst += 4 + 4 * c;
      } else if (c == 0) {
        v = load_phit(a.hdr + static_cast<size_t>(fr) * 4, 0, 4, a.vec_in);
      } else {
        v = load_phit(a.pay + static_cast<size_t>(fr) * fw, 4 * (c - 1), fw, a.vec_in);
        dst += 4 * c;
      }
      *reinterpret_cast<uint4*>(dst) = v;
    }
    if (kBuild) {
      // lanes g * kCrcLanes .. + kCrcLanes - 1 take frame first + g; lanes
      // past the last frame repeat it and store nothing
      const uint32_t g = lane / kCrcLanes, l = lane % kCrcLanes;
      const uint32_t fr = first + min(g, n_here - 1);
      const uint32_t s = fr / a.F, f = fr - s * a.F;
      const long long nb = __ldg(a.nbytes + s);
      const long long words = (nb + 3) >> 2;
      const uint32_t limit = static_cast<uint32_t>(
          words < 0 ? 0 : (words > a.row_words ? a.row_words : words));
      const long long rem = nb - 4LL * fw * f;
      const uint32_t size = static_cast<uint32_t>(rem < 0 ? 0 : (rem > 4LL * fw ? 4LL * fw : rem));
      const uint32_t level = static_cast<uint32_t>(__ldg(a.levels + s));
      const long long* rt = a.routes + 3 * static_cast<size_t>(s);
      const uint32_t route = a.route_flag | (static_cast<uint32_t>(__ldg(rt) & 0x7F) << 24) |
                             (static_cast<uint32_t>(__ldg(rt + 1) & 0xFF) << 16) |
                             static_cast<uint32_t>((__ldg(rt + 2) + f) & 0xFFFF);
      const uint32_t* row = a.pay + static_cast<size_t>(s) * a.row_words;
      // the CRC input is 1 + P phits; lane l takes phits [l S, (l + 1) S)
      // of it padded in front to kCrcLanes * S phits
      const uint32_t S = (P + kCrcLanes) / kCrcLanes;
      const uint32_t pad = kCrcLanes * S - (P + 1);
      uint32_t crc = 0;
      for (uint32_t q = max(l * S, pad); q < (l + 1) * S; ++q) {
        const uint32_t ph = q - pad;
        const uint4 v = ph == 0 ? make_uint4(0u, size, level, route)
                                : load_phit(row, f * fw + 4 * (ph - 1), limit, a.vec_in);
        crc = crc_phit(tab, crc, v);
      }
#pragma unroll
      for (int k = 0; k < kCrcSteps; ++k) {
        // join the run of 2**k lanes to the right: shift by its 16 S 2**k bytes
        const uint32_t right = __shfl_down_sync(0xFFFFFFFFu, crc, 1 << k, kCrcLanes);
        crc = lookup4(tab + kCrcTableWords * (1 + k), crc) ^ right;
      }
      if (l == 0 && g < n_here) {
        *reinterpret_cast<uint4*>(a.out + static_cast<size_t>(fr) * width) =
            make_uint4(size, level, crc ^ a.crc_xor, route);
      }
    }
  }
}

// Everything a split launch reads.
struct SplitArgs {
  const uint32_t* frames;  // (rows, width)
  uint32_t* hdr;           // (rows, 4)
  uint32_t* pay;           // (rows, width - 4)
  unsigned long long n;          // units of the frames
  unsigned long long step_rows;  // the grid's threads = step_rows * per_frame + step_cols
  uint32_t per_frame;            // units of a frame
  uint32_t step_cols;
};

template <typename T, typename Idx, int U>
__global__ void __launch_bounds__(kThreads) split_kernel(const SplitArgs a) {
  constexpr uint32_t H = kHdrWords * sizeof(uint32_t) / sizeof(T);  // units of a header
  const T* __restrict__ src = reinterpret_cast<const T*>(a.frames);
  T* __restrict__ hdr = reinterpret_cast<T*>(a.hdr);
  T* __restrict__ pay = reinterpret_cast<T*>(a.pay);
  const Idx stride = static_cast<Idx>(gridDim.x) * blockDim.x;
  const Idx i = static_cast<Idx>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<Idx>(a.n)) return;
  const Idx left = static_cast<Idx>(a.n) - i;  // (U - 1) stride < n: no index wraps
  const uint32_t w = a.per_frame;
  Idx r = i / w;  // the thread's one division
  uint32_t c = static_cast<uint32_t>(i - r * w);
  T v[U];
#pragma unroll
  for (int k = 0; k < U; ++k) {
    if (k * stride < left) v[k] = __ldg(src + i + k * stride);
  }
#pragma unroll
  for (int k = 0; k < U; ++k) {
    if (k * stride < left) {
      if (c < H) {
        hdr[r * H + c] = v[k];
      } else {
        pay[i + k * stride - H * (r + 1)] = v[k];
      }
    }
    // unit i + (k + 1) stride: one grid stride on, with one carry
    c += a.step_cols;
    r += static_cast<Idx>(a.step_rows);
    if (c >= w) {
      c -= w;
      ++r;
    }
  }
}

// Everything a fragment launch reads; unused pointers are null.
struct ChunkArgs {
  const uint32_t* meta;        // (rows, 3)
  const uint32_t* tokens;      // (rows, cap_w)
  const uint32_t* counts;      // (rows,)
  const uint32_t* elem_words;  // trimmed: (rows,)
  const long long* offsets;    // trimmed: (rows,) first word of each row
  uint32_t* out;               // padded: (rows, cap_w + 4); trimmed: (n_words,)
  long long n_words;           // trimmed: words of out
  uint32_t rows;
  uint32_t cap_w;
  uint32_t mask_words;         // padded: the mask's elem_words (0: no mask)
  uint32_t group_shift;        // log2 of the lanes per row
};

constexpr int kChunkUnroll = 4;  // words a lane loads before it stores (copy, padded rows)
constexpr int kTrimUnroll = 2;   // the same, trimmed rows

template <bool kTrim>
__host__ __device__ constexpr int chunk_unroll() {
  return kTrim ? kTrimUnroll : kChunkUnroll;
}

template <bool kTrim>
__global__ void __launch_bounds__(kThreads) chunk_kernel(const ChunkArgs a) {
  const uint32_t g = 1u << a.group_shift;
  const uint32_t j = threadIdx.x & (g - 1);
  const size_t groups = (static_cast<size_t>(gridDim.x) * blockDim.x) >> a.group_shift;
  size_t r = (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> a.group_shift;
  // the row's count, elem_words and offset, loaded one row ahead
  uint32_t n_next = 0, ew_next = a.mask_words;
  long long off_next = 0;
  if (r < a.rows) {
    n_next = __ldg(a.counts + r);
    if (kTrim) {
      ew_next = __ldg(a.elem_words + r);
      off_next = __ldg(a.offsets + r);
    }
  }
  for (; r < a.rows; r += groups) {
    const uint32_t n = n_next, ew = ew_next;
    const long long off = off_next;
    if (r + groups < a.rows) {
      n_next = __ldg(a.counts + r + groups);
      if (kTrim) {
        ew_next = __ldg(a.elem_words + r + groups);
        off_next = __ldg(a.offsets + r + groups);
      }
    }
    const uint32_t live = (kTrim || ew != 0) ? min(n * ew, a.cap_w) : a.cap_w;
    const uint32_t len = (kTrim ? live : a.cap_w) + kChunkMetaWords + 1;
    const uint32_t* __restrict__ meta = a.meta + kChunkMetaWords * r;
    const uint32_t* __restrict__ src = a.tokens + a.cap_w * r;
    constexpr int U = chunk_unroll<kTrim>();
    for (uint32_t c0 = 0; c0 < len; c0 += U * g) {
      uint32_t v[U];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const uint32_t c = c0 + k * g + j;
        v[k] = 0u;
        if (c < kChunkMetaWords) {
          v[k] = __ldg(meta + c);
        } else if (c == len - 1) {
          v[k] = n;
        } else if (c < len && c - kChunkMetaWords < live) {
          v[k] = __ldg(src + (c - kChunkMetaWords));
        }
      }
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const uint32_t c = c0 + k * g + j;
        if (c >= len) break;
        if (kTrim) {
          const long long w = off + c;
          if (w >= 0 && w < a.n_words) a.out[w] = v[k];
        } else {
          a.out[(a.cap_w + kChunkMetaWords + 1) * r + c] = v[k];
        }
      }
    }
  }
}

__global__ void pack_run_kernel(const uint32_t* __restrict__ tok,
                                uint32_t* __restrict__ out, int64_t total, int nlanes,
                                int stride_w, int nbytes) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t row = i / stride_w;
  const int c = static_cast<int>(i - row * stride_w);
  uint32_t v = 0u;
  if (c < nlanes) {
    const int rem = nbytes - 4 * c;  // 1..3 on a partial last lane
    const uint32_t mask = rem >= 4 ? 0xFFFFFFFFu : (1u << (8 * rem)) - 1u;
    v = __ldg(tok + row * nlanes + c) & mask;
  }
  out[i] = v;
}

// slot that header write k (= 2 * header + {0: size, 1: level}) targets, or
// -1 where it falls outside the wire
__device__ __forceinline__ long long stamp_slot(const int32_t* __restrict__ hdr, long long k,
                                                long long n_words) {
  const long long s = static_cast<long long>(__ldg(hdr + 3 * (k >> 1))) + (k & 1);
  return (s >= 0 && s < n_words) ? s : -1;
}

struct StampArgs {
  const uint32_t* wire;  // (n_words,)
  const int32_t* hdr;    // (n_writes / 2, 3)
  int32_t* owner;        // (n_words + 1,) scratch, uninitialised; the last
                         // word is the flag "two headers' slots may meet"
  uint32_t* out;         // (n_words,)
  long long n_words;
  long long n_writes;    // 2 * headers
  int vec;               // wire and out are 16-byte aligned
};

// Copy n elements of T, grid-stride, kChunkUnroll loads in flight per thread.
template <typename T>
__device__ __forceinline__ void grid_copy(const T* __restrict__ src, T* __restrict__ dst,
                                          long long n, long long tid, long long stride) {
  long long i = tid;
  for (; i + (kChunkUnroll - 1) * stride < n; i += kChunkUnroll * stride) {
    T v[kChunkUnroll];
#pragma unroll
    for (int k = 0; k < kChunkUnroll; ++k) v[k] = __ldg(src + i + k * stride);
#pragma unroll
    for (int k = 0; k < kChunkUnroll; ++k) dst[i + k * stride] = v[k];
  }
  for (; i < n; i += stride) dst[i] = __ldg(src + i);
}

__global__ void __launch_bounds__(kThreads) stamp_kernel(const StampArgs a) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // phase 1: the copy, and neighbouring headers whose slots may meet
  if (a.vec) {
    const long long n_vec = a.n_words >> 2;
    grid_copy(reinterpret_cast<const uint4*>(a.wire), reinterpret_cast<uint4*>(a.out), n_vec,
              tid, stride);
    for (long long w = 4 * n_vec + tid; w < a.n_words; w += stride) a.out[w] = __ldg(a.wire + w);
  } else {
    grid_copy(a.wire, a.out, a.n_words, tid, stride);
  }
  if (a.n_writes == 0) return;  // the same for every thread: no sync is left waiting
  const long long n_headers = a.n_writes >> 1;
  bool meet = false;
  for (long long h = tid; h + 1 < n_headers; h += stride) {
    const long long w0 = __ldg(a.hdr + 3 * h), w1 = __ldg(a.hdr + 3 * (h + 1));
    meet |= w1 < w0 + 2;
  }
  int32_t* flag = a.owner + a.n_words;
  if (tid == 0) *flag = 0;
  cg::grid_group grid = cg::this_grid();
  grid.sync();
  if (meet) *flag = 1;
  grid.sync();
  if (__ldcg(flag) == 0) {
    // phase 2: every slot has one header at most
    for (long long k = tid; k < a.n_writes; k += stride) {
      const long long s = stamp_slot(a.hdr, k, a.n_words);
      if (s >= 0) a.out[s] = static_cast<uint32_t>(__ldg(a.hdr + 3 * (k >> 1) + 1 + (k & 1)));
    }
    return;
  }
  // phase 2': the owner of every slot a header writes reset
  for (long long k = tid; k < a.n_writes; k += stride) {
    const long long s = stamp_slot(a.hdr, k, a.n_words);
    if (s >= 0) a.owner[s] = -1;
  }
  grid.sync();
  // phase 3': the last header that writes a slot owns it
  for (long long k = tid; k < a.n_writes; k += stride) {
    const long long s = stamp_slot(a.hdr, k, a.n_words);
    if (s >= 0) atomicMax(a.owner + s, static_cast<int>(k >> 1));
  }
  grid.sync();
  // phase 4': each owner stamps its slot (the owner read bypasses L1)
  for (long long k = tid; k < a.n_writes; k += stride) {
    const long long s = stamp_slot(a.hdr, k, a.n_words);
    const long long h = k >> 1;
    if (s >= 0 && __ldcg(a.owner + s) == static_cast<int>(h)) {
      a.out[s] = static_cast<uint32_t>(__ldg(a.hdr + 3 * h + 1 + (k & 1)));
    }
  }
}

inline unsigned int n_blocks(int64_t total) {
  return static_cast<unsigned int>((total + kThreads - 1) / kThreads);
}

inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

// Blocks for a frame launch of `frames`, `per_warp` frames to a warp: one
// warp's share each, at most eight blocks per SM (the kernel strides).
inline unsigned int frame_blocks(int64_t frames, int per_warp) {
  const int64_t per_block = static_cast<int64_t>(per_warp) * (kThreads / 32);
  const int64_t need = (frames + per_block - 1) / per_block;
  return static_cast<unsigned int>(need < 8LL * sm_count() ? need : 8LL * sm_count());
}

// log2 of the lanes a fragment row of `width` words takes: the smallest
// power of two g with 2 * unroll * g >= width, at most a warp
inline uint32_t chunk_group_shift(int64_t width, int unroll) {
  uint32_t shift = 0;
  while (shift < 5 && (2LL * unroll << shift) < width) ++shift;
  return shift;
}

// One split launch of U units a thread: a grid of every unit's thread, the
// grid stride split into frames and units for the kernel.
template <typename T, typename Idx, int U>
int launch_split(SplitArgs a, cudaStream_t stream) {
  constexpr long long per_block = static_cast<long long>(U) * kThreads;
  const long long blocks = (static_cast<long long>(a.n) + per_block - 1) / per_block;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  const unsigned long long stride = static_cast<unsigned long long>(blocks) * kThreads;
  a.step_rows = stride / a.per_frame;
  a.step_cols = static_cast<uint32_t>(stride % a.per_frame);
  split_kernel<T, Idx, U><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTrim>
int launch_chunks(ChunkArgs a, void* stream) {
  a.group_shift = chunk_group_shift(a.cap_w + kChunkMetaWords + 1, chunk_unroll<kTrim>());
  chunk_kernel<kTrim><<<frame_blocks(a.rows, 32 >> a.group_shift), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int hgum_pack_frames_batch(const void* hdr, const void* pay, void* out, long long rows,
                           int frame_words, void* stream) {
  if (frame_words % 4 != 0 || rows >= (1LL << 32)) return cudaErrorInvalidValue;
  if (rows == 0) return 0;
  FrameArgs a = {};
  a.hdr = static_cast<const uint32_t*>(hdr);
  a.pay = static_cast<const uint32_t*>(pay);
  a.out = static_cast<uint32_t*>(out);
  a.n_frames = static_cast<uint32_t>(rows);
  a.F = 1;
  a.phits = static_cast<uint32_t>(frame_words / 4);
  a.row_words = static_cast<uint32_t>(frame_words);
  a.vec_in = ((reinterpret_cast<uintptr_t>(hdr) | reinterpret_cast<uintptr_t>(pay)) & 15) == 0;
  frame_kernel<false><<<frame_blocks(rows, frames_per_warp<false>()), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int hgum_frame_batch(const void* pay, const void* nbytes, const void* routes,
                     const void* levels, const void* tables, void* out, long long streams,
                     long long row_words, int frames_per_stream, int frame_phits,
                     unsigned int crc_xor, int adaptive, void* stream) {
  const long long n_frames = streams * frames_per_stream;
  if (n_frames >= (1LL << 32) || row_words + 4LL * frame_phits >= (1LL << 32)) {
    return cudaErrorInvalidValue;
  }
  if (n_frames == 0) return 0;
  FrameArgs a = {};
  a.pay = static_cast<const uint32_t*>(pay);
  a.nbytes = static_cast<const long long*>(nbytes);
  a.routes = static_cast<const long long*>(routes);
  a.levels = static_cast<const long long*>(levels);
  a.tables = static_cast<const uint32_t*>(tables);
  a.out = static_cast<uint32_t*>(out);
  a.n_frames = static_cast<uint32_t>(n_frames);
  a.F = static_cast<uint32_t>(frames_per_stream);
  a.row_words = static_cast<uint32_t>(row_words);
  a.phits = static_cast<uint32_t>(frame_phits);
  a.crc_xor = crc_xor;
  a.route_flag = adaptive ? 0x80000000u : 0u;
  a.vec_in = (reinterpret_cast<uintptr_t>(pay) & 15) == 0 && row_words % 4 == 0;
  frame_kernel<true><<<frame_blocks(n_frames, frames_per_warp<true>()), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int hgum_unpack_frames_batch(const void* frames, void* hdr, void* pay, long long rows,
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
  const bool small = a.n < (1ULL << 32);  // 32-bit index math
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (phits) {
    if (!small) return cudaErrorInvalidValue;
    return launch_split<uint4, uint32_t, kSplitPhitsPerThread>(a, s);
  }
  if (small) return launch_split<uint32_t, uint32_t, kSplitWordsPerThread>(a, s);
  return launch_split<uint32_t, unsigned long long, kSplitWordsPerThread>(a, s);
}

int hgum_pack_chunks_batch(const void* meta, const void* tokens, const void* counts,
                           void* out, long long rows, int cap_w, int elem_words,
                           void* stream) {
  if (rows >= (1LL << 32) || cap_w < 0 || cap_w >= (1 << 30) || elem_words < 0) {
    return cudaErrorInvalidValue;
  }
  if (rows == 0) return 0;
  ChunkArgs a = {};
  a.meta = static_cast<const uint32_t*>(meta);
  a.tokens = static_cast<const uint32_t*>(tokens);
  a.counts = static_cast<const uint32_t*>(counts);
  a.out = static_cast<uint32_t*>(out);
  a.rows = static_cast<uint32_t>(rows);
  a.cap_w = static_cast<uint32_t>(cap_w);
  a.mask_words = static_cast<uint32_t>(elem_words);
  return launch_chunks<false>(a, stream);
}

int hgum_chunk_bursts(const void* meta, const void* tokens, const void* counts,
                      const void* elem_words, const void* offsets, void* out, long long rows,
                      int cap_w, long long n_words, void* stream) {
  if (rows >= (1LL << 32) || cap_w < 0 || cap_w >= (1 << 30) || n_words < 0) {
    return cudaErrorInvalidValue;
  }
  if (rows == 0) return 0;
  ChunkArgs a = {};
  a.meta = static_cast<const uint32_t*>(meta);
  a.tokens = static_cast<const uint32_t*>(tokens);
  a.counts = static_cast<const uint32_t*>(counts);
  a.elem_words = static_cast<const uint32_t*>(elem_words);
  a.offsets = static_cast<const long long*>(offsets);
  a.out = static_cast<uint32_t*>(out);
  a.n_words = n_words;
  a.rows = static_cast<uint32_t>(rows);
  a.cap_w = static_cast<uint32_t>(cap_w);
  return launch_chunks<true>(a, stream);
}

int hgum_pack_run(const void* tok, void* out, long long rows, int nlanes, int stride_w,
                  int nbytes, void* stream) {
  const int64_t total = static_cast<int64_t>(rows) * stride_w;
  if (total == 0) return 0;
  pack_run_kernel<<<n_blocks(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tok), static_cast<uint32_t*>(out), total, nlanes,
      stride_w, nbytes);
  return static_cast<int>(cudaGetLastError());
}

int hgum_stamp_headers(const void* wire, const void* hdr, void* owner, void* out,
                       long long n_words, long long n_headers, void* stream) {
  if (n_words < 0 || n_headers < 0 || n_headers >= (1LL << 31)) return cudaErrorInvalidValue;
  if (n_words == 0) return 0;
  // the grid the card holds at once (a grid sync needs every block
  // resident), at most four blocks per SM and no more than the work needs
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stamp_kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm <= 0) return cudaErrorCooperativeLaunchTooLarge;
  }
  StampArgs a = {};
  a.wire = static_cast<const uint32_t*>(wire);
  a.hdr = static_cast<const int32_t*>(hdr);
  a.owner = static_cast<int32_t*>(owner);
  a.out = static_cast<uint32_t*>(out);
  a.n_words = n_words;
  a.n_writes = 2 * n_headers;
  a.vec = ((reinterpret_cast<uintptr_t>(wire) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long work = (a.vec ? n_words / 4 : n_words) > a.n_writes
                             ? (a.vec ? n_words / 4 : n_words) : a.n_writes;
  const long long need = (work + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(per_sm < 4 ? per_sm : 4) * sm_count();
  const unsigned int blocks = static_cast<unsigned int>(need < most ? (need > 0 ? need : 1)
                                                                     : most);
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      (void*)stamp_kernel, dim3(blocks), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream)));
}

const char* hgum_frame_pack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
