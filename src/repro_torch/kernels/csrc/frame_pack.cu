// Routed-fabric frame assembly, RX split and stream-fragment assembly on
// Hopper (sm_90a).
//
// Three kernels, one thread per word of the rows they write or read.  Each
// replaces a Pallas body of the reference src/repro/kernels/frame_pack.py:
//
//   hgum_pack_frames_batch    <- _assemble_kernel (frame_pack.py:82),
//                                called from pack_frames_batch (:88)
//   hgum_unpack_frames_batch  <- _split_kernel    (frame_pack.py:168),
//                                called from unpack_frames_batch (:174)
//   hgum_pack_chunks_batch    <- _chunk_kernel    (frame_pack.py:118),
//                                called from pack_chunks_batch (:125), with
//                                the tail mask of the reference
//                                kernels/ops.py:encode_chunks_batch fused in
//
// What they compute.  A frame is one row of `width = 4 + frame_words` u32
// words: the header phit [size | level | crc32 | route] and then the
// payload.  pack joins `rows` header rows (rows, 4) and payload rows
// (rows, frame_words) into the frames (rows, width); unpack is the mirror
// and splits delivered frames back into the two.  For word c of row r:
//   frame[r, c] = c < 4 ? hdr[r, c] : pay[r, c - 4]
// The TPU kernels did the same on whole VMEM tiles (one stream per grid
// step for pack, eight rows per step for unpack); on this card the grid is
// flat over the words, so any row count fills the SMs and needs no padding.
//
// What bounds them.  Pure data movement: every word is read once and
// written once, so the bound is (bytes read + bytes written) over the
// memory rate.  Design for that: neighbouring threads own neighbouring
// words of the framed side, so its accesses are fully coalesced; the split
// side is two contiguous arrays whose boundary moves by 4 words per row,
// so a warp touches at most a few 32-byte sectors of each.  A 68-word row
// (frame_phits = 16) is not a multiple of 16 bytes, so 16-byte vector
// accesses would need per-row alignment handling; simple 4-byte accesses
// are used here.  Vector loads of the payload or TMA are later work.
//
// Stream fragments (B7).  The streaming plane serializes every decode
// tick's token and logprob fragments of one lane into one burst.  A
// fragment is one row of `width = cap_w + 4` words:
//   [stream_id | step | flags | cap_w element words | count]
// with the element count AFTER the elements (paper section IV-B).  For word
// c of row r:
//   c < 3          -> meta[r, c]
//   c == width - 1 -> counts[r]
//   otherwise      -> tokens[r, c - 3] if (c - 3) < counts[r] * elem_words
//                     (u32 product, as the reference computes it), else 0
// elem_words == 0 turns the mask off: the row is then exactly the Pallas
// body's concatenation of pre-masked tokens.  The TPU kernel padded the
// rows to blocks of 8 and sliced them off again; here the grid is flat
// over the output words and needs no padding.  Bound: bytes, like B5 (the
// bound counts a masked word as not read; the kernel reads it anyway, see
// below).  Rows of cap_w + 4 words are rarely a
// multiple of 16 bytes, so the accesses are 4 bytes wide, coalesced on the
// output side.
//
// Interface: plain C, pointers and the stream as void*, 64-bit sizes.  Each
// entry returns cudaGetLastError() after its launch; the launch is
// asynchronous on the given stream and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHdrWords = 4;
constexpr int kChunkMetaWords = 3;  // stream_id, step, flags

__global__ void pack_frames_kernel(const uint32_t* __restrict__ hdr,
                                   const uint32_t* __restrict__ pay,
                                   uint32_t* __restrict__ out, int64_t total,
                                   int frame_words) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int width = kHdrWords + frame_words;
  const int64_t row = i / width;
  const int c = static_cast<int>(i - row * width);
  out[i] = c < kHdrWords ? __ldg(hdr + row * kHdrWords + c)
                         : __ldg(pay + row * frame_words + (c - kHdrWords));
}

__global__ void unpack_frames_kernel(const uint32_t* __restrict__ frames,
                                     uint32_t* __restrict__ hdr,
                                     uint32_t* __restrict__ pay, int64_t total,
                                     int frame_words) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int width = kHdrWords + frame_words;
  const int64_t row = i / width;
  const int c = static_cast<int>(i - row * width);
  const uint32_t v = __ldg(frames + i);
  if (c < kHdrWords) {
    hdr[row * kHdrWords + c] = v;
  } else {
    pay[row * frame_words + (c - kHdrWords)] = v;
  }
}

__global__ void pack_chunks_kernel(const uint32_t* __restrict__ meta,
                                   const uint32_t* __restrict__ tokens,
                                   const uint32_t* __restrict__ counts,
                                   uint32_t* __restrict__ out, int64_t total, int cap_w,
                                   uint32_t elem_words) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int width = cap_w + kChunkMetaWords + 1;
  const int64_t row = i / width;
  const int c = static_cast<int>(i - row * width);
  uint32_t v;
  if (c < kChunkMetaWords) {
    v = __ldg(meta + row * kChunkMetaWords + c);
  } else if (c == width - 1) {
    v = __ldg(counts + row);
  } else {
    // both loads are issued before the mask is known: a token load that
    // waits on the count load halves the loads in flight (measured on
    // H100 at 2**20 x 64: 0.38 ms dependent against 0.30 ms unmasked)
    const uint32_t e = static_cast<uint32_t>(c - kChunkMetaWords);
    const uint32_t n = __ldg(counts + row);
    const uint32_t t = __ldg(tokens + row * cap_w + e);
    v = (elem_words == 0 || e < n * elem_words) ? t : 0u;
  }
  out[i] = v;
}

inline unsigned int n_blocks(int64_t total) {
  return static_cast<unsigned int>((total + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int hgum_pack_frames_batch(const void* hdr, const void* pay, void* out, long long rows,
                           int frame_words, void* stream) {
  const int64_t total = static_cast<int64_t>(rows) * (kHdrWords + frame_words);
  pack_frames_kernel<<<n_blocks(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(hdr), static_cast<const uint32_t*>(pay),
      static_cast<uint32_t*>(out), total, frame_words);
  return static_cast<int>(cudaGetLastError());
}

int hgum_unpack_frames_batch(const void* frames, void* hdr, void* pay, long long rows,
                             int frame_words, void* stream) {
  const int64_t total = static_cast<int64_t>(rows) * (kHdrWords + frame_words);
  unpack_frames_kernel<<<n_blocks(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(frames), static_cast<uint32_t*>(hdr),
      static_cast<uint32_t*>(pay), total, frame_words);
  return static_cast<int>(cudaGetLastError());
}

int hgum_pack_chunks_batch(const void* meta, const void* tokens, const void* counts,
                           void* out, long long rows, int cap_w, int elem_words,
                           void* stream) {
  const int64_t total = static_cast<int64_t>(rows) * (cap_w + kChunkMetaWords + 1);
  if (total == 0) return 0;
  pack_chunks_kernel<<<n_blocks(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(meta), static_cast<const uint32_t*>(tokens),
      static_cast<const uint32_t*>(counts), static_cast<uint32_t*>(out), total, cap_w,
      static_cast<uint32_t>(elem_words));
  return static_cast<int>(cudaGetLastError());
}

const char* hgum_frame_pack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
