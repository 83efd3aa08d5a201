// Canny on Hopper: K1 (Sobel + NMS + double threshold) and K2 (hysteresis,
// on bit-packed masks in shared memory, in one block or across a cluster,
// and on byte masks in global memory).
//
// K1 `revo_canny_nms` replaces the Pallas kernel of
// revo_tpu/ops/pallas/canny_kernel.py (`_nms_core` run by `_nms_batched`)
// where K1 runs alone: images above the grid kernel's shared memory (~80
// Mpx on an H100).  It reads the unpadded gray, uint8 or float32, as the
// one-launch kernels do, so no padded float32 copy exists.  Bound on the
// H100: bytes, the gray read once (1 B a pixel for uint8) and the two byte
// masks written once; 37 operations a pixel sit below that.  So the design
// streams: persistent blocks, as many as the card holds at once, walk the
// 128x64 tiles in a fixed stride; a ring of two stages in shared memory
// holds this tile's gray and the next one's, whose copy (cp.async, 16-byte
// chunks, where rows are whole aligned chunks) is in flight while this one
// is classified.  Interior tiles are read with no bounds test; a tile
// within 2 px of an edge reads the chunks outside the image through
// ReflectGray (TMA would zero-fill, not reflect).  A warp streams down 8
// rows of the tile, a lane 4 columns: the Sobel runs once a pixel as
// smoothings that roll in registers, the neighbours' magnitudes come by
// warp shuffle, and each row leaves as one 4-byte store a lane and mask
// (128 contiguous bytes a warp).  What bounds it in practice is the
// instructions a pixel (PERF.md), not the bytes.
//
// Arithmetic is the Pallas kernel's float32 expressions: gray is
// uint8-valued, so Sobel and the squared magnitude are exact integers, and
// the sector tests are `ay < ax * 0.41421356f` and `ay > ax * 2.41421356f`
// (tan 22.5 + 2 folded in double, then rounded to float).  The products are
// written with __fmul_rn so the compiler cannot fuse them into an FMA.
//
// K2 `revo_canny_hysteresis` replaces revo_tpu/ops/pallas/hysteresis.py
// (`_fixpoint` run by `_run_batched`).  One 1024-thread block per image runs
// the whole fixpoint of synchronous (Jacobi) 3x3 dilation steps,
// dst = src | (cand & dilate3x3(src)), __syncthreads_or between steps.  It
// reproduces the JAX loop exactly, cap included: trips of 8 steps, stop
// after a trip that grew nothing or once `max_iters` (= H + W) steps have
// run.  A step that grows nothing ends its trip early; the remaining steps
// of that trip would change nothing.  Bound on the H100: latency of the
// serial step chain on one SM (one block per image, up to H+W dependent
// steps); the batch spreads images over SMs.  So the design makes a step
// cheap.  The TPU kernel keeps float masks in VMEM (Mosaic cannot rotate
// sub-32-bit data); here a mask is one bit a pixel: the block packs `cand`
// and `strong` from global memory into 32-pixel words in dynamic shared
// memory (bit j of word k of a row is pixel 32 k + j; rows padded to whole
// words with zero bits), runs every step there on words (a thread walks a
// short vertical run of one word column: OR of three horizontally dilated
// rows, the carry bits taken from the neighbouring words), and unpacks the
// result once.  A 640x480 mask is 38.4 KB, `cand` and the two state
// buffers 115 KB of the SM's 227 KB.
//
// `revo_canny_fused` is K1 and K2 in one launch, the counterpart of the
// single-image Pallas kernel `_full_kernel2d` (canny_kernel.py, run by
// `_canny_single`), for B images up to 1024x576.  It reads the unpadded gray
// image, float32 or uint8, and applies REFLECT_101 on the index, so no
// padded copy exists.  Bound on the H100: the fixpoint's serial chain of
// synchronous steps (H + W at most, tens at 640x480) on the one SM that
// holds an image's masks; bytes are the gray image read once and the bool
// edges written once.  So the design keeps both short.  K1: P blocks an
// image, P B of them one wave of the card (each block asks for the
// fixpoint's shared memory, so one 1024-thread block an SM), whose warps
// classify strips of 32 columns by 8 rows with K1's arithmetic in registers
// and shuffles (no shared memory, no tile staging): a lane a column, so two
// ballots a row give that row's word of `cand` and of `strong` in K2's
// layout, which lane 0 stores into a packed scratch in global memory (two
// bits a pixel leave the SM), and each lane writes its pixel's edge byte as
// strong alone.  Then
// each block fences and takes an atomic ticket for its image; the block
// that draws the last loads the image's packed masks from L2 into shared
// memory in 16-byte chunks and runs K2's steps on their frontier
// (`frontier_fixpoint`, 16 warps at a named barrier): a word can change at
// step t + 1 only if a word of its 3x3 word neighbourhood changed at step
// t, so a step lists only those words that still have a `cand` bit to
// reach or changed themselves (dirty and room bits a word, a 32-bit word a
// row up to 1024 pixels) and steps them a thread each; a step costs its
// frontier and two barriers, not the whole image.  It writes the edge
// bytes of the words that grew and resets the ticket, so launches need no
// memset between them.  With
// `stats` it reports the steps, the largest frontier, the frontier words of
// all steps and a timeline of the fixpoint's block.
//
// `revo_canny_fused_dense` is the first form of the same kernel, kept for
// comparison (no route takes it): 1024-thread blocks over 32x32 tiles
// staged in shared memory, every block asking for the fixpoint's shared
// memory, and the last block's fixpoint stepping every word of the image
// each step (`hysteresis_fixpoint`).
//
// `revo_canny_hysteresis_global` is the same loop over ping-pong byte masks
// in global memory (a 640x480 mask is 300 KB and stays in L2; where rows are
// whole 16-byte chunks a thread dilates 16 pixels per step with word-wide
// ORs and shifts).  It takes the images whose three packed masks exceed a
// block's shared memory; the caller chooses by shape before the launch.
//
// `revo_canny_cluster` is K1 and K2 in one launch for images whose three
// packed masks exceed one block's shared memory (above 1024x576): the
// counterpart of `_canny_single` at those sizes, and of `_nms_batched` +
// `_run_batched` (hysteresis.py) where JAX batches them.  It spreads one
// image over a thread-block cluster of R = 16 or 8 blocks on neighbouring
// SMs, whose shared memory the others can read (DSMEM): rank r owns a band
// of ceil(H / R) rows.  It classifies its band from the unpadded gray
// (REFLECT_101 on the index, K1's arithmetic in 256x16 tiles, 4 pixels a
// thread) and stores each warp's two ballots straight into its own packed
// `cand` and state words, so no mask leaves the cluster before the edges.
// Then it runs K2's synchronous steps on its band in ping-pong word
// buffers: each step reads the row above and the row below its band from
// the neighbouring ranks' source buffer, and one cluster barrier a step
// orders the step's writes before the next step's reads; whether any block
// grew is ORed into a slot of every rank, so each reads the verdict from its
// own shared memory.  Trips, early stop and cap are hysteresis_fixpoint's.
// Bound on the H100: as K2, the serial chain of steps, now of one cluster
// barrier and a 1/R band each; bytes are the gray image read once and the
// bool edges written once.  With R = 16 a band of 3840x2160 needs 196 KB of
// a block's 227 KB.
//
// `revo_canny_grid` is the same K1 + K2 for images above a cluster's shared
// memory (about 9.7 Mpx): the counterpart of `_canny_single` there, and of
// `_nms_batched` + `_run_batched` batched.  One cooperative launch spreads
// the image over every co-resident block of the card (132 on an H100, one
// 1024-thread block an SM; B images share them), block g owning a band of
// ceil(H / G) rows in its shared memory, classified from the unpadded gray
// as the cluster kernel's ranks do.  Blocks that are not in one cluster
// cannot read each other's shared memory, so a step publishes each band's
// first and last row to a halo array in global memory (a few KB, which
// stays in L2), passes one grid-wide barrier (cooperative groups'
// grid.sync), and the next step reads its neighbours' rows from there;
// "grew" goes by atomicOr into one of three slots in global memory in
// rotation (grid_fixpoint).  Bound on the H100: as K2, the serial chain of
// steps, now of one grid barrier and a 1/G band each; bytes are the gray
// image read once and the bool edges written once.  The bands of G = 132
// blocks hold about 80 Mpx (7680x4320 needs 98 KB a block).
//
// `revo_canny_hysteresis_grid` is K2 alone on byte masks over the same
// cooperative grid, the multi-SM form of the global K2: each block packs
// its band by ballots, steps it with grid_fixpoint and unpacks it; its
// packed state lives in shared memory where the bands fit, else in global
// memory (3 bits a pixel, in L2 up to about 130 Mpx), where every block
// reads its neighbours' rows in place.  `revo_canny_hysteresis_global`, the
// one-block form above, is kept for comparison only: no route takes it.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;
constexpr float TG22 = 0.41421356237309504880f;  // tan(pi/8) as float
constexpr float TG67 = 2.41421356237309504880f;  // tan(pi/8) + 2 as float

constexpr int GS_W = TX + 4;  // row of the staged gray tile
constexpr int MS_W = TX + 2;  // row of the staged magnitudes

// Gray at image coordinates (gy, gx), read from the unpadded (H, W) image
// with REFLECT_101 on the index (-1 -> 1, H -> H - 2); 0 further out, where
// the padded copy has nothing either.  H, W >= 2.
template <typename T>
struct ReflectGray {
  const T* img;
  int H, W;
  __device__ __forceinline__ T raw(int gy, int gx) const {
    if (gy < -1 || gy > H || gx < -1 || gx > W) return T(0);
    gy = gy < 0 ? -gy : (gy >= H ? 2 * H - 2 - gy : gy);
    gx = gx < 0 ? -gx : (gx >= W ? 2 * W - 2 - gx : gx);
    return img[(size_t)gy * W + gx];
  }
  __device__ __forceinline__ float operator()(int gy, int gx) const {
    return (float)raw(gy, gx);
  }
};

// K1's arithmetic, the one copy every Canny kernel calls.  Sobel of the 3x3
// window with rows (a0 a1 a2), (b0 . b2), (c0 c1 c2), in the plain
// version's order; on uint8-valued gray every value is an exact integer.
__device__ __forceinline__ void sobel(float a0, float a1, float a2, float b0, float b2,
                                      float c0, float c1, float c2, float& gx, float& gy) {
  gx = (a2 + 2.0f * b2 + c2) - (a0 + 2.0f * b0 + c0);
  gy = (c0 + 2.0f * c1 + c2) - (a0 + 2.0f * a1 + a2);
}

// The gradient's sector: 0 horizontal (compare left / right), 1 vertical
// (up / down), 2 the "\" diagonal, 3 the "/" one.
// All three tests run, so that the lanes of a warp do not diverge.
__device__ __forceinline__ int sector_of(float gx, float gy) {
  const float ax = fabsf(gx), ay = fabsf(gy);
  const bool horizontal = ay < __fmul_rn(ax, TG22);
  const bool vertical = ay > __fmul_rn(ax, TG67);
  const bool falling = __fmul_rn(gx, gy) >= 0.0f;
  return horizontal ? 0 : (vertical ? 1 : (falling ? 2 : 3));
}

// Offset, in a row-major magnitude array of rows of `mw`, from a pixel to
// the neighbour its NMS compares first (left, up, up-left, up-right); the
// second is the opposite neighbour.
__device__ __forceinline__ int nms_offset(int sector, int mw) {
  return sector == 0 ? 1 : (sector == 1 ? mw : (sector == 2 ? mw + 1 : mw - 1));
}

// OpenCV's asymmetry: `>` then `>=` along the axes, strict on the diagonals.
__device__ __forceinline__ bool nms_keep(int sector, float m, float first, float second) {
  return (m > first) & (sector <= 1 ? m >= second : m > second);
}

// K1's staging on one TXT x TYT tile at (y0, x0) by NT threads: the gray
// tile plus a 2-pixel halo in g_s ((TYT + 4) x (TXT + 4)), then the
// magnitudes of the tile plus a 1-pixel ring in m_s ((TYT + 2) x (TXT + 2)).
// Every thread of the block calls it; it ends on a barrier.
template <int TXT, int TYT, int NT, typename Gray>
__device__ __forceinline__ void stage_tile(float* g_s, float* m_s, const Gray& gray,
                                           int x0, int y0, int H, int W, int tid) {
  constexpr int gw = TXT + 4, mw = TXT + 2;
  // g_s[i][j] = gray(y0 - 2 + i, x0 - 2 + j); entries beyond the one-pixel
  // border only feed magnitudes outside the image, which are forced to 0.
  for (int k = tid; k < (TYT + 4) * gw; k += NT) {
    const int i = k / gw, j = k % gw;
    g_s[k] = gray(y0 - 2 + i, x0 - 2 + j);
  }
  __syncthreads();

#define G(i, j) g_s[(i) * gw + (j)]
  // m_s[i][j] = magnitude of image pixel (y0 - 1 + i, x0 - 1 + j), whose
  // Sobel window is g_s rows i..i+2, cols j..j+2.
  for (int k = tid; k < (TYT + 2) * mw; k += NT) {
    const int i = k / mw, j = k % mw;
    const int y = y0 - 1 + i, x = x0 - 1 + j;
    float m = 0.0f;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      float gxv, gyv;
      sobel(G(i, j), G(i, j + 1), G(i, j + 2), G(i + 1, j), G(i + 1, j + 2), G(i + 2, j),
            G(i + 2, j + 1), G(i + 2, j + 2), gxv, gyv);
      m = gxv * gxv + gyv * gyv;  // exact integer < 2^24
    }
    m_s[k] = m;
  }
#undef G
  __syncthreads();
}

// K1's classification of the staged pixel at m_s coordinates (i, j), i.e.
// tile row i - 1 and column j - 1 (the caller keeps it inside the image).
template <int TXT>
__device__ __forceinline__ void classify_pixel(const float* g_s, const float* m_s,
                                               int i, int j, float low_sq,
                                               float high_sq, bool& cand,
                                               bool& strong) {
  constexpr int gw = TXT + 4, mw = TXT + 2;
#define G(i, j) g_s[(i) * gw + (j)]
  // g_s window of this pixel: rows i..i+2, cols j..j+2.
  float gxv, gyv;
  sobel(G(i, j), G(i, j + 1), G(i, j + 2), G(i + 1, j), G(i + 1, j + 2), G(i + 2, j),
        G(i + 2, j + 1), G(i + 2, j + 2), gxv, gyv);
#undef G
  const int sector = sector_of(gxv, gyv);
  const float* mp = m_s + i * mw + j;
  const int d = nms_offset(sector, mw);
  const float m = *mp;
  cand = nms_keep(sector, m, mp[-d], mp[d]) && (m > low_sq);
  strong = cand && (m > high_sq);
}

// K1 on one TX x TYT tile at (y0, x0) by TX * TYT threads: stage it, then
// thread `tid` classifies pixel (y0 + tid / TX, x0 + tid % TX): false,
// false outside the image.
template <int TYT, typename Gray>
__device__ __forceinline__ void nms_tile(float* g_s, float* m_s, const Gray& gray,
                                         int x0, int y0, int H, int W,
                                         float low_sq, float high_sq, int tid,
                                         bool& cand, bool& strong) {
  stage_tile<TX, TYT, TX * TYT>(g_s, m_s, gray, x0, y0, H, W, tid);
  cand = strong = false;
  const int x = x0 + tid % TX, y = y0 + tid / TX;
  if (x >= W || y >= H) return;
  classify_pixel<TX>(g_s, m_s, tid / TX + 1, tid % TX + 1, low_sq, high_sq, cand, strong);
}

constexpr int HYST_THREADS = 1024;
constexpr int UNROLL = 8;

__device__ __forceinline__ uint4 or4(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}

// Byte of pixel p's column OR over rows y-1..y+1 (0 outside the image).
__device__ __forceinline__ uint32_t col_or(const uint8_t* src, int p, int y,
                                           int H, int W) {
  uint32_t v = src[p];
  if (y > 0) v |= src[p - W];
  if (y < H - 1) v |= src[p + W];
  return v;
}

// One synchronous dilation step src -> dst over the whole image,
// dst = src | (cand & dilate3x3(src)); returns whether this thread's pixels
// grew.  Masks are 0/1 bytes.  When rows are whole 16-byte chunks
// (W % 16 == 0, as at every pyramid level of a 640x480 frame) a thread
// dilates 16 pixels at once: OR of the chunks above and below, then byte
// shifts within the chunk, with the two edge bytes taken from the
// neighbouring chunks.
__device__ __forceinline__ bool dilate_step(const uint8_t* __restrict__ c,
                                            const uint8_t* src, uint8_t* dst,
                                            int H, int W, bool vec) {
  bool grew = false;
  if (vec) {
    const uint4* c4 = reinterpret_cast<const uint4*>(c);
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    const int wq = W / 16;
    for (int q = threadIdx.x; q < H * wq; q += HYST_THREADS) {
      const int y = q / wq, xq = q - y * wq;
      const uint4 sv = s4[q];
      uint4 v = sv;
      if (y > 0) v = or4(v, s4[q - wq]);
      if (y < H - 1) v = or4(v, s4[q + wq]);
      const uint32_t left = xq > 0 ? col_or(src, q * 16 - 1, y, H, W) : 0u;
      const uint32_t right = xq < wq - 1 ? col_or(src, q * 16 + 16, y, H, W) : 0u;
      // Little-endian: pixel 4k + j is byte j of word k.  (w << 8) moves
      // each byte onto its right neighbour, (w >> 8) onto its left.
      const uint32_t w0 = v.x, w1 = v.y, w2 = v.z, w3 = v.w;
      uint4 h;
      h.x = w0 | (w0 << 8) | left | (w0 >> 8) | (w1 << 24);
      h.y = w1 | (w1 << 8) | (w0 >> 24) | (w1 >> 8) | (w2 << 24);
      h.z = w2 | (w2 << 8) | (w1 >> 24) | (w2 >> 8) | (w3 << 24);
      h.w = w3 | (w3 << 8) | (w2 >> 24) | (w3 >> 8) | (right << 24);
      const uint4 cv = c4[q];
      const uint4 out = or4(sv, make_uint4(cv.x & h.x, cv.y & h.y,
                                           cv.z & h.z, cv.w & h.w));
      grew |= (out.x != sv.x) | (out.y != sv.y) | (out.z != sv.z) |
              (out.w != sv.w);
      d4[q] = out;
    }
    return grew;
  }
  for (int p = threadIdx.x; p < H * W; p += HYST_THREADS) {
    uint8_t r = src[p];
    if (!r && c[p]) {
      const int y = p / W, x = p - y * W;
      const int ylo = y > 0 ? y - 1 : 0, yhi = y < H - 1 ? y + 1 : H - 1;
      const int xlo = x > 0 ? x - 1 : 0, xhi = x < W - 1 ? x + 1 : W - 1;
      for (int yy = ylo; yy <= yhi && !r; ++yy)
        for (int xx = xlo; xx <= xhi; ++xx)
          if (src[yy * W + xx]) { r = 1; break; }
      grew |= (r != 0);
    }
    dst[p] = r;
  }
  return grew;
}

__device__ __forceinline__ void copy_mask(const uint8_t* src, uint8_t* dst,
                                          int n, bool vec) {
  if (vec) {
    for (int q = threadIdx.x; q < n / 16; q += HYST_THREADS)
      reinterpret_cast<uint4*>(dst)[q] = reinterpret_cast<const uint4*>(src)[q];
  } else {
    for (int p = threadIdx.x; p < n; p += HYST_THREADS) dst[p] = src[p];
  }
}

__global__ void __launch_bounds__(HYST_THREADS)
canny_hysteresis_global_kernel(const uint8_t* __restrict__ cand,
                               const uint8_t* __restrict__ strong,
                               uint8_t* out, uint8_t* tmp, int H, int W,
                               int max_iters) {
  const size_t off = (size_t)blockIdx.x * H * W;
  const uint8_t* c = cand + off;
  uint8_t* bufs[2] = {out + off, tmp + off};
  const uintptr_t addr = reinterpret_cast<uintptr_t>(c) |
                         reinterpret_cast<uintptr_t>(strong + off) |
                         reinterpret_cast<uintptr_t>(bufs[0]) |
                         reinterpret_cast<uintptr_t>(bufs[1]);
  const bool vec = (W % 16 == 0) && (addr % 16 == 0);
  copy_mask(strong + off, bufs[0], H * W, vec);  // bool bytes are 0/1
  __syncthreads();

  int cur = 0;
  int it = 0;
  bool trip_grew = true;
  while (trip_grew && it < max_iters) {
    trip_grew = false;
    for (int s = 0; s < UNROLL; ++s) {
      const bool grew = dilate_step(c, bufs[cur], bufs[cur ^ 1], H, W, vec);
      cur ^= 1;
      // Also orders this step's writes before the next step's reads.
      if (!__syncthreads_or(grew)) break;
      trip_grew = true;
    }
    it += UNROLL;
  }
  if (cur == 1) copy_mask(bufs[1], bufs[0], H * W, vec);
}

// -- K2 on bit-packed masks in shared memory ---------------------------------

// The 4 low bits of n spread to the low bits of 4 bytes, and back.  Both
// multiplies place every partial product on a distinct bit, so none carries.
__device__ __forceinline__ uint32_t nibble_to_bytes(uint32_t n) {
  return ((n & 0xFu) * 0x00204081u) & 0x01010101u;
}
__device__ __forceinline__ uint32_t bytes_to_nibble(uint32_t b) {
  return ((b & 0x01010101u) * 0x01020408u) >> 24 & 0xFu;
}

// Pack word k of row y (pixels 32 k .. 32 k + 31, zero beyond W) of a 0/1
// byte mask.  `vec`: rows are whole words and 16-byte aligned.
__device__ __forceinline__ uint32_t pack_word(const uint8_t* m, int y, int k,
                                              int W, bool vec) {
  uint32_t bits = 0;
  if (vec) {
    const uint4* src = reinterpret_cast<const uint4*>(m + (size_t)y * W + 32 * k);
    const uint4 lo = src[0], hi = src[1];
    bits = bytes_to_nibble(lo.x) | bytes_to_nibble(lo.y) << 4 |
           bytes_to_nibble(lo.z) << 8 | bytes_to_nibble(lo.w) << 12 |
           bytes_to_nibble(hi.x) << 16 | bytes_to_nibble(hi.y) << 20 |
           bytes_to_nibble(hi.z) << 24 | bytes_to_nibble(hi.w) << 28;
  } else {
    const int n = min(32, W - 32 * k);
    const uint8_t* src = m + (size_t)y * W + 32 * k;
    for (int j = 0; j < n; ++j) bits |= (uint32_t)(src[j] & 1u) << j;
  }
  return bits;
}

__device__ __forceinline__ void unpack_word(uint32_t bits, uint8_t* m, int y,
                                            int k, int W, bool vec) {
  if (vec) {
    uint4* dst = reinterpret_cast<uint4*>(m + (size_t)y * W + 32 * k);
    dst[0] = make_uint4(nibble_to_bytes(bits), nibble_to_bytes(bits >> 4),
                        nibble_to_bytes(bits >> 8), nibble_to_bytes(bits >> 12));
    dst[1] = make_uint4(nibble_to_bytes(bits >> 16), nibble_to_bytes(bits >> 20),
                        nibble_to_bytes(bits >> 24), nibble_to_bytes(bits >> 28));
  } else {
    const int n = min(32, W - 32 * k);
    uint8_t* dst = m + (size_t)y * W + 32 * k;
    for (int j = 0; j < n; ++j) dst[j] = (bits >> j) & 1u;
  }
}

// Word k of row y dilated along its row: each pixel ORed with its left and
// right neighbours.  Pixel x is bit x % 32, so `<< 1` brings the left
// neighbour and `>> 1` the right one; bit 31 of word k - 1 and bit 0 of
// word k + 1 carry across.  Column 0 and the last word have no outside
// neighbour, and padding bits are 0, so pixel W - 1 sees none either.
// A load of a packed word: from L2 with CG (state in global memory that
// other blocks write between grid barriers; L1 is not coherent), else plain.
template <bool CG>
__device__ __forceinline__ uint32_t ld_word(const uint32_t* p) {
  if constexpr (CG) return __ldcg(p);
  else return *p;
}

template <bool CG = false>
__device__ __forceinline__ uint32_t dilate_row(const uint32_t* s, int y, int k,
                                               int wpr, uint32_t centre) {
  const uint32_t* row = s + y * wpr;
  const uint32_t left = k > 0 ? ld_word<CG>(row + k - 1) >> 31 : 0u;
  const uint32_t right = k < wpr - 1 ? ld_word<CG>(row + k + 1) << 31 : 0u;
  return centre | centre << 1 | centre >> 1 | left | right;
}

// One synchronous step src -> dst on packed words of H rows.  A work item
// is `run` consecutive rows of one word column; items are numbered
// column-fastest, so a warp reads neighbouring words.  Rows -1 and H are 0;
// with HALO they are read from src instead (a band's neighbouring rows,
// which the caller has placed there).  CG: every load from L2 (ld_word).
// Returns whether this thread grew.
template <bool HALO, bool CG = false>
__device__ __forceinline__ bool dilate_step_bits(const uint32_t* c,
                                                 const uint32_t* src,
                                                 uint32_t* dst, int H, int wpr,
                                                 int run) {
  bool grew = false;
  const int items = ((H + run - 1) / run) * wpr;
  for (int item = threadIdx.x; item < items; item += HYST_THREADS) {
    const int k = item % wpr;
    const int y0 = (item / wpr) * run, y1 = min(y0 + run, H);
    uint32_t c_cur = ld_word<CG>(src + y0 * wpr + k);
    uint32_t h_prev =
        (HALO || y0 > 0)
            ? dilate_row<CG>(src, y0 - 1, k, wpr, ld_word<CG>(src + (y0 - 1) * wpr + k))
            : 0u;
    uint32_t h_cur = dilate_row<CG>(src, y0, k, wpr, c_cur);
    for (int y = y0; y < y1; ++y) {
      uint32_t c_next = 0u, h_next = 0u;
      if (HALO || y + 1 < H) {
        c_next = ld_word<CG>(src + (y + 1) * wpr + k);
        h_next = dilate_row<CG>(src, y + 1, k, wpr, c_next);
      }
      const uint32_t out =
          c_cur | (ld_word<CG>(c + y * wpr + k) & (h_prev | h_cur | h_next));
      grew |= out != c_cur;
      dst[y * wpr + k] = out;
      h_prev = h_cur; h_cur = h_next; c_cur = c_next;
    }
  }
  return grew;
}

// K2's fixpoint on packed masks in shared memory, by the HYST_THREADS
// threads of one block (all of them call it; the masks are complete and a
// barrier has passed).  `c` is cand, `buf0` holds strong; synchronous steps
// in trips of UNROLL, stopping after a trip that grew nothing or once
// `max_iters` steps have run.  Returns the buffer that holds the result.
__device__ __forceinline__ const uint32_t* hysteresis_fixpoint(
    const uint32_t* c, uint32_t* buf0, uint32_t* buf1, int H, int wpr,
    int max_iters) {
  uint32_t* bufs[2] = {buf0, buf1};
  const int n = H * wpr;
  const int run = (n + HYST_THREADS - 1) / HYST_THREADS;  // rows per work item
  int cur = 0;
  int it = 0;
  bool trip_grew = true;
  while (trip_grew && it < max_iters) {
    trip_grew = false;
    for (int s = 0; s < UNROLL; ++s) {
      const bool grew =
          dilate_step_bits<false>(c, bufs[cur], bufs[cur ^ 1], H, wpr, run);
      cur ^= 1;
      // Also orders this step's writes before the next step's reads.
      if (!__syncthreads_or(grew)) break;
      trip_grew = true;
    }
    it += UNROLL;
  }
  return bufs[cur];
}

__global__ void __launch_bounds__(HYST_THREADS)
canny_hysteresis_kernel(const uint8_t* __restrict__ cand,
                        const uint8_t* __restrict__ strong,
                        uint8_t* __restrict__ out, int H, int W, int max_iters) {
  extern __shared__ uint32_t hyst_smem[];
  const int wpr = (W + 31) / 32;
  const int n = H * wpr;
  uint32_t* c = hyst_smem;
  uint32_t* bufs[2] = {hyst_smem + n, hyst_smem + 2 * n};
  const size_t off = (size_t)blockIdx.x * H * W;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(cand + off) |
                         reinterpret_cast<uintptr_t>(strong + off) |
                         reinterpret_cast<uintptr_t>(out + off);
  const bool vec = (W % 32 == 0) && (addr % 16 == 0);
  for (int q = threadIdx.x; q < n; q += HYST_THREADS) {
    const int y = q / wpr, k = q - y * wpr;
    c[q] = pack_word(cand + off, y, k, W, vec);
    bufs[0][q] = pack_word(strong + off, y, k, W, vec);
  }
  __syncthreads();

  const uint32_t* reach = hysteresis_fixpoint(c, bufs[0], bufs[1], H, wpr, max_iters);
  for (int q = threadIdx.x; q < n; q += HYST_THREADS) {
    const int y = q / wpr, k = q - y * wpr;
    unpack_word(reach[q], out + off, y, k, W, vec);
  }
}

// -- K1 alone: persistent blocks over pipelined tiles ------------------------

// A warp owns the tile's 128 columns on a strip of NMS_ROWS rows, a lane 4
// adjacent columns; the strip's Sobel also covers one ring row above and
// below, and the two columns either side of the tile (a lane a row).
constexpr int NMS_WARPS = 8, NMS_ROWS = 8;
constexpr int NMS_THREADS = 32 * NMS_WARPS;
constexpr int NMS_TX = 128, NMS_TY = NMS_ROWS * NMS_WARPS;  // output tile
constexpr int NMS_STRIP = NMS_ROWS + 2;
static_assert(NMS_STRIP <= 32, "a lane a row of the outer columns");
enum NmsPath { NMS_BORDER = 0, NMS_VECTOR = 1, NMS_SCALAR = 2 };

// The staged gray of one tile, in the image's own type: rows y0 - 2 ..
// y0 + NMS_TY + 1 and columns x0 - A .. x0 + NMS_TX + A - 1, where A is one
// 16-byte chunk of elements, so an interior row is whole aligned chunks
// when W * sizeof(T) is a multiple of 16.
template <typename T>
struct NmsStage {
  static constexpr int A = 16 / (int)sizeof(T);
  static constexpr int SW = NMS_TX + 2 * A;
  static constexpr int ROWS = NMS_TY + 4;
  static constexpr int CHUNKS = SW * (int)sizeof(T) / 16;  // 16-byte chunks a row
  static constexpr size_t BYTES = 2 * (size_t)ROWS * SW * sizeof(T);  // the ring of two
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The staging path of the tile at (y0, x0) (the host-side model in
// tests/test_torch_canny_nms.py mirrors it): a tile whose staged rows and
// columns lie inside the image is interior and is read with no bounds
// test, by cp.async 16-byte chunks where `vec` (rows of whole aligned
// chunks), else by plain loads; any other tile is a border tile.
template <typename T>
__device__ __forceinline__ int nms_path(int y0, int x0, int H, int W, bool vec) {
  constexpr int A = NmsStage<T>::A;
  const bool interior = y0 >= 2 && y0 + NMS_TY + 2 <= H && x0 >= A && x0 + NMS_TX + A <= W;
  return interior ? (vec ? NMS_VECTOR : NMS_SCALAR) : NMS_BORDER;
}

// Start staging tile (y0, x0) of `img` into `st` by the block's threads,
// one 16-byte chunk of the staged window a work item.  Copies by cp.async
// are left in flight (the caller commits them as a group); the others store
// before returning, their loads unrolled so that they are in flight
// together.  Interior tiles test no bound; a border tile copies the chunks
// that lie inside the image by cp.async where `vec`, and reads the others
// element by element through ReflectGray.
template <typename T>
__device__ __forceinline__ void nms_stage(T* st, const T* __restrict__ img, int y0, int x0,
                                          int H, int W, int path, bool vec, int tid) {
  using S = NmsStage<T>;
  constexpr int per = 16 / (int)sizeof(T);
  const T* src = img + (size_t)(y0 - 2) * W + (x0 - S::A);
  const ReflectGray<T> gray{img, H, W};
  for (int k = tid; k < S::ROWS * S::CHUNKS; k += NMS_THREADS) {
    const int i = k / S::CHUNKS, c = k - i * S::CHUNKS;
    T* dst = st + i * S::SW + c * per;
    if (path == NMS_VECTOR) {
      cp_async16(dst, src + (size_t)i * W + c * per);
    } else if (path == NMS_SCALAR) {
      const T* from = src + (size_t)i * W + c * per;
#pragma unroll
      for (int e = 0; e < per; ++e) dst[e] = __ldg(from + e);
    } else {
      const int gy = y0 - 2 + i, gx = x0 - S::A + c * per;
      if (vec && gy >= 0 && gy < H && gx >= 0 && gx + per <= W) {
        cp_async16(dst, img + (size_t)gy * W + gx);
      } else {
        T v[per];
#pragma unroll
        for (int e = 0; e < per; ++e) v[e] = gray.raw(gy, gx + e);
#pragma unroll
        for (int e = 0; e < per; ++e) dst[e] = v[e];
      }
    }
  }
}

// A staged gray value as float: uint8 through the float's mantissa (exact,
// at the full FP32 rate where I2F runs at a quarter of it).
__device__ __forceinline__ float gray_float(uint8_t v) {
  return __uint_as_float(0x4B000000u | v) - 8388608.0f;
}
__device__ __forceinline__ float gray_float(float v) { return v; }

// Staged row `row` at the 6 columns a lane's window spans: its own 4 (from
// staged column 4 lane + A, one aligned 4- or 16-byte load) and one either
// side.
__device__ __forceinline__ void load_row6(const uint8_t* row, int lane, float (&p)[6]) {
  constexpr int A = NmsStage<uint8_t>::A;
  const uint32_t w = *reinterpret_cast<const uint32_t*>(row + 4 * lane + A);
  p[0] = gray_float(row[4 * lane + A - 1]);
#pragma unroll
  for (int k = 0; k < 4; ++k)  // byte k into the mantissa of 2^23
    p[1 + k] = __uint_as_float(__byte_perm(w, 0x4B00u, k | 0x5440)) - 8388608.0f;
  p[5] = gray_float(row[4 * lane + A + 4]);
}
__device__ __forceinline__ void load_row6(const float* row, int lane, float (&p)[6]) {
  constexpr int A = NmsStage<float>::A;
  const float4 v = *reinterpret_cast<const float4*>(row + 4 * lane + A);
  p[0] = row[4 * lane + A - 1];
  p[1] = v.x; p[2] = v.y; p[3] = v.z; p[4] = v.w;
  p[5] = row[4 * lane + A + 4];
}

// The two neighbours the NMS of a pixel of `sector` compares (nms_offset's
// first and second), from its 3x3 magnitudes held in registers.
__device__ __forceinline__ void nms_pick(int sector, float ul, float u, float ur, float l,
                                         float r, float dl, float d, float dr, float& first,
                                         float& second) {
  first = sector == 0 ? l : (sector == 1 ? u : (sector == 2 ? ul : ur));
  second = sector == 0 ? r : (sector == 1 ? d : (sector == 2 ? dr : dl));
}

// gray: (B, H, W) unpadded, H, W >= 2; cand, strong: (B, H, W) 0/1 bytes.
// A persistent grid: block g classifies tiles g, g + gridDim.x, ... of the
// B x ceil(H / NMS_TY) x ceil(W / NMS_TX) tiles (column fastest), staging
// the next tile while it classifies this one (a ring of two stages in
// dynamic shared memory).  Warp w streams down its strip of NMS_ROWS rows,
// lane l owning columns 4 l .. 4 l + 3: per row, one load of its 4 staged
// values and one either side, the Sobel as vertical and horizontal
// smoothings that roll in registers (sobel()'s operations in its order),
// the magnitudes (0 outside the image) and sectors; its neighbours'
// magnitudes come by warp shuffle (the columns either side of the tile from
// the first NMS_STRIP lanes, which run their Sobel first), and the row above
// is classified and stored as one 4-byte word a mask and lane (a warp: 128
// contiguous bytes), or byte by byte where `st4` is 0 (rows not whole
// words, or unaligned masks).  `vec`: the gray's rows are whole aligned
// 16-byte chunks.  __launch_bounds__ asks for 3 resident blocks an SM,
// which measured faster on an H100 than the registers the compiler picks
// unasked (2 blocks).
template <typename T>
__global__ void __launch_bounds__(NMS_THREADS, 3)
canny_nms_kernel(const T* __restrict__ gray, uint8_t* __restrict__ cand,
                 uint8_t* __restrict__ strong, int B, int H, int W, float low_sq,
                 float high_sq, int vec, int st4) {
  using S = NmsStage<T>;
  extern __shared__ __align__(16) unsigned char nms_smem[];
  T* const ring = reinterpret_cast<T*>(nms_smem);  // stage s at ring + s * ROWS * SW
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ntx = (W + NMS_TX - 1) / NMS_TX, nty = (H + NMS_TY - 1) / NMS_TY;
  const int per_img = ntx * nty, n = B * per_img;
  const int i0 = warp * NMS_ROWS;  // the strip's first ring row

  int t = blockIdx.x;
  int cur = 0;
  auto stage = [&](int tile, T* st) {
    const int b = tile / per_img, rem = tile - b * per_img, ty = rem / ntx;
    const int y0 = ty * NMS_TY, x0 = (rem - ty * ntx) * NMS_TX;
    nms_stage(st, gray + (size_t)b * H * W, y0, x0, H, W, nms_path<T>(y0, x0, H, W, vec != 0),
              vec != 0, tid);
  };
  if (t < n) stage(t, ring);
  cp_async_commit();
  for (; t < n; t += gridDim.x) {
    if (t + (int)gridDim.x < n) stage(t + gridDim.x, ring + (cur ^ 1) * S::ROWS * S::SW);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies have landed; the next tile's fly
    __syncthreads();

    const int b = t / per_img, rem = t - b * per_img, ty = rem / ntx;
    const int y0 = ty * NMS_TY, x0 = (rem - ty * ntx) * NMS_TX;
    const T* st = ring + cur * S::ROWS * S::SW;
    // Ring pixel (i, j) is image pixel (y0 - 1 + i, x0 - 1 + j); its window
    // is staged rows i..i+2, columns j + A - 2 .. j + A.  Lane l < NMS_STRIP
    // first takes ring row i0 + l of the columns either side of the tile,
    // j = 0 and NMS_TX + 1.
    float outer[2] = {0.0f, 0.0f};
    if (lane < NMS_STRIP) {
      const int i = i0 + lane, y = y0 - 1 + i;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = e ? NMS_TX + 1 : 0, xo = x0 - 1 + j;
        const T* w = st + i * S::SW + j + S::A - 2;
        float gxv, gyv;
        sobel(gray_float(w[0]), gray_float(w[1]), gray_float(w[2]), gray_float(w[S::SW]),
              gray_float(w[S::SW + 2]), gray_float(w[2 * S::SW]), gray_float(w[2 * S::SW + 1]),
              gray_float(w[2 * S::SW + 2]), gxv, gyv);
        outer[e] = (y >= 0 && y < H && xo >= 0 && xo < W) ? gxv * gxv + gyv * gyv : 0.0f;
      }
    }
    bool col_in[4];
    const int x = x0 + 4 * lane;  // this lane's first column
#pragma unroll
    for (int k = 0; k < 4; ++k) col_in[k] = x + k < W;
    const size_t img = (size_t)b * H * W;

    // The rolling state: staged rows a (top) and b (middle) of the window
    // at the lane's 6 columns, their horizontal smoothings, and the
    // magnitudes (with the neighbours') and sectors of the last two rows.
    float ra[6], rb[6], ha[4], hb[4], mu[6], mm[6];
    int sec_m = 0;
    load_row6(st + i0 * S::SW, lane, ra);
    load_row6(st + (i0 + 1) * S::SW, lane, rb);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ha[k] = ra[k] + 2.0f * ra[k + 1] + ra[k + 2];
      hb[k] = rb[k] + 2.0f * rb[k + 1] + rb[k + 2];
    }
#pragma unroll
    for (int r = 0; r < NMS_STRIP; ++r) {
      float rc[6];
      load_row6(st + (i0 + r + 2) * S::SW, lane, rc);
      float v[6], md[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) v[k] = ra[k] + 2.0f * rb[k] + rc[k];
      const int y = y0 - 1 + i0 + r;
      const bool row_in = y >= 0 && y < H;
      int sec = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float hc = rc[k] + 2.0f * rc[k + 1] + rc[k + 2];
        // sobel()'s gx and gy: (a2 + 2 b2 + c2) - (a0 + 2 b0 + c0) and
        // (c0 + 2 c1 + c2) - (a0 + 2 a1 + a2).
        const float gxv = v[k + 2] - v[k], gyv = hc - ha[k];
        md[k + 1] = row_in && col_in[k] ? gxv * gxv + gyv * gyv : 0.0f;  // exact integer < 2^24
        if (r >= 1 && r <= NMS_ROWS) sec |= sector_of(gxv, gyv) << (2 * k);
        ha[k] = hb[k];
        hb[k] = hc;
      }
      const float left = __shfl_up_sync(0xffffffffu, md[4], 1);
      const float right = __shfl_down_sync(0xffffffffu, md[1], 1);
      const float o_left = __shfl_sync(0xffffffffu, outer[0], r);
      const float o_right = __shfl_sync(0xffffffffu, outer[1], r);
      md[0] = lane == 0 ? o_left : left;
      md[5] = lane == 31 ? o_right : right;
      if (r >= 2) {  // classify ring row r - 1: image row y - 1
        const int yo = y - 1;
        uint32_t cw = 0, sw = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int sector = (sec_m >> (2 * k)) & 3;
          const float m = mm[k + 1];
          float first, second;
          nms_pick(sector, mu[k], mu[k + 1], mu[k + 2], mm[k], mm[k + 2], md[k], md[k + 1],
                   md[k + 2], first, second);
          const bool c = nms_keep(sector, m, first, second) & (m > low_sq);
          const bool s = c & (m > high_sq);
          cw |= (uint32_t)c << (8 * k);
          sw |= (uint32_t)s << (8 * k);
        }
        if (yo < H) {
          const size_t o = img + (size_t)yo * W + x;
          if (st4) {
            if (col_in[0]) {
              *reinterpret_cast<uint32_t*>(cand + o) = cw;
              *reinterpret_cast<uint32_t*>(strong + o) = sw;
            }
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (col_in[k]) {
                cand[o + k] = (cw >> (8 * k)) & 1u;
                strong[o + k] = (sw >> (8 * k)) & 1u;
              }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        ra[k] = rb[k];
        rb[k] = rc[k];
        mu[k] = mm[k];
        mm[k] = md[k];
      }
      sec_m = sec;
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
    cur ^= 1;
  }
  cp_async_wait<0>();
}

template <typename T>
static int launch_canny_nms(const T* gray, uint8_t* cand, uint8_t* strong, int B, int H,
                            int W, float low_sq, float high_sq, int blocks,
                            cudaStream_t stream) {
  const int vec = (W * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(gray) % 16 == 0;
  const uintptr_t out = reinterpret_cast<uintptr_t>(cand) | reinterpret_cast<uintptr_t>(strong);
  const int st4 = W % 4 == 0 && out % 4 == 0;
  const size_t smem = NmsStage<T>::BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      canny_nms_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  canny_nms_kernel<T><<<blocks, NMS_THREADS, smem, stream>>>(gray, cand, strong, B, H, W,
                                                             low_sq, high_sq, vec, st4);
  return (int)cudaGetLastError();
}

// Persistent blocks of K1 for B images of H x W: as many as the card holds
// at once (the occupancy query), at most one a tile; a CUDA error as its
// negative.
template <typename T>
static int nms_blocks(int B, int H, int W) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(canny_nms_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)NmsStage<T>::BYTES);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, canny_nms_kernel<T>,
                                                        NMS_THREADS, NmsStage<T>::BYTES);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -(int)err;
  }
  const long tiles = (long)B * ((H + NMS_TY - 1) / NMS_TY) * ((W + NMS_TX - 1) / NMS_TX);
  const long resident = (long)per_sm * sms;
  return (int)(tiles < resident ? tiles : resident);
}

// -- K1 + K2 in one launch, dense form (32x32 tiles, every word a step) ------

constexpr int TY_FUSED = HYST_THREADS / TX;  // 32 x 32 tiles, a warp a row
constexpr size_t FUSED_TILE_BYTES =
    ((TY_FUSED + 4) * GS_W + (TY_FUSED + 2) * MS_W) * sizeof(float);

// gray: (B, H, W) unpadded; words: per image cand then strong, H * wpr words
// each; tickets: one zeroed counter per image, left at 0; out: (B, H, W)
// 0/1 bytes.  Grid (wpr, ceil(H / 32), B), HYST_THREADS threads.
template <typename T>
__global__ void __launch_bounds__(HYST_THREADS)
canny_fused_dense_kernel(const T* __restrict__ gray, uint32_t* words, unsigned int* tickets,
                         uint8_t* __restrict__ out, int H, int W, float low_sq, float high_sq,
                         int max_iters) {
  extern __shared__ uint32_t fused_smem[];  // the tile, then the packed masks
  __shared__ bool last;
  const int b = blockIdx.z, tid = threadIdx.x;
  const int wpr = gridDim.x;
  const int n = H * wpr;
  float* g_s = reinterpret_cast<float*>(fused_smem);
  float* m_s = g_s + (TY_FUSED + 4) * GS_W;
  const ReflectGray<T> img{gray + (size_t)b * H * W, H, W};
  bool c, s;
  nms_tile<TY_FUSED>(g_s, m_s, img, blockIdx.x * TX, blockIdx.y * TY_FUSED, H, W,
                     low_sq, high_sq, tid, c, s);
  // Lane j of a warp is pixel 32 * blockIdx.x + j of one row: the ballots
  // are that row's words.  Threads past the right edge vote 0.
  const uint32_t cbits = __ballot_sync(0xffffffffu, c);
  const uint32_t sbits = __ballot_sync(0xffffffffu, s);
  uint32_t* cw = words + (size_t)b * 2 * n;
  uint32_t* sw = cw + n;
  const int y = blockIdx.y * TY_FUSED + (tid >> 5);
  if ((tid & 31) == 0 && y < H) {
    cw[y * wpr + blockIdx.x] = cbits;
    sw[y * wpr + blockIdx.x] = sbits;
  }
  __threadfence();  // the words are visible before the ticket is taken
  __syncthreads();  // and every thread is done with the tile in shared memory
  if (tid == 0) last = atomicAdd(tickets + b, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // Last block of image b: the fixpoint on the words the others wrote.
  uint32_t* cm = fused_smem;
  uint32_t* buf0 = fused_smem + n;
  uint32_t* buf1 = fused_smem + 2 * n;
  for (int q = tid; q < n; q += HYST_THREADS) {
    cm[q] = __ldcg(cw + q);
    buf0[q] = __ldcg(sw + q);
  }
  __syncthreads();
  const uint32_t* reach = hysteresis_fixpoint(cm, buf0, buf1, H, wpr, max_iters);
  uint8_t* o = out + (size_t)b * H * W;
  const bool vec = (W % 32 == 0) && (reinterpret_cast<uintptr_t>(o) % 16 == 0);
  for (int q = tid; q < n; q += HYST_THREADS) {
    const int yy = q / wpr, k = q - yy * wpr;
    unpack_word(reach[q], o, yy, k, W, vec);
  }
  if (tid == 0) tickets[b] = 0u;
}

template <typename T>
static int launch_canny_fused_dense(const T* gray, uint32_t* words, unsigned int* tickets,
                                    uint8_t* out, int B, int H, int W, float low_sq,
                                    float high_sq, int max_iters, size_t smem,
                                    cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        canny_fused_dense_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((W + TX - 1) / TX, (H + TY_FUSED - 1) / TY_FUSED, B);
  canny_fused_dense_kernel<T><<<grid, HYST_THREADS, smem, stream>>>(
      gray, words, tickets, out, H, W, low_sq, high_sq, max_iters);
  return (int)cudaGetLastError();
}

// -- K1 + K2 in one launch: warps over strips, the fixpoint on its frontier ---

constexpr int FS_ROWS = 8;            // output rows of a K1 strip
constexpr int FS_LOAD = FS_ROWS + 4;  // gray rows a strip reads
constexpr int FUSED_FLAG_WORDS = 8;   // "last" flag, four counters, padding
constexpr int FUSED_STATS = 9;        // 64-bit words of stats an image

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// K1 on one strip of the image, by one warp: the 32 columns of word k
// (x0 = 32 k, lane l owning column x0 + l) over output rows y0 ..
// y0 + FS_ROWS - 1.  A lane first loads its column of gray rows y0 - 2 ..
// y0 + FS_ROWS + 1, all loads in flight together; lanes 0, 1, 30 and 31
// also load columns x0 - 1, x0 - 2, x0 + 33 and x0 + 32, so that lane 0
// holds the column left of the strip and lane 31 the one right of it, each
// with its own outer neighbour by shuffle.  Then, down the rows, a lane
// forms the horizontal smoothing of its column; per magnitude row the
// vertical one, whose neighbours come by shuffle (sobel()'s operations in
// its order), the magnitude (0 outside the image) and the sector; the
// neighbours' magnitudes come by shuffle too, lanes 0 and 31 taking the
// outer columns'.  The row above is then classified: its two ballots are
// that row's word of `cand` and of `strong`, which lane 0 stores, and each
// lane inside the image writes its pixel's edge byte as strong alone, which
// the fixpoint's block overwrites in the words that grew.  Lanes past the
// right edge vote 0.  No shared memory.
template <typename T>
__device__ __forceinline__ void classify_strip(const ReflectGray<T>& img, int x0, int y0, int H,
                                               int W, int wpr, float low_sq, float high_sq,
                                               uint32_t* cw, uint32_t* sw, uint8_t* o, int lane) {
  const int x = x0 + lane;
  const bool has_e = lane <= 1 || lane >= 30;
  const int xe = lane == 0 ? x0 - 1 : (lane == 1 ? x0 - 2 : (lane == 30 ? x0 + 33 : x0 + 32));
  const int xo = lane == 0 ? x0 - 1 : x0 + 32;  // the outer column of lanes 0 and 31
  const bool col_in = x < W, outer_in = xo >= 0 && xo < W;
  const int k = x0 >> 5;
  float gs[FS_LOAD], es[FS_LOAD];
#pragma unroll
  for (int r = 0; r < FS_LOAD; ++r) {
    gs[r] = img(y0 - 2 + r, x);
    es[r] = has_e ? img(y0 - 2 + r, xe) : 0.0f;
  }
  // Rolling windows, index 0 the oldest row: gray of the own column (g),
  // of the outer column (e) and of the one beyond it (f); the horizontal
  // smoothings of the own and the outer column (h, ho); magnitudes of the
  // own column with their left and right neighbours (m, ml, mr) and sectors.
  float g[3] = {}, e[3] = {}, f[3] = {}, h[3] = {}, ho[3] = {};
  float m[3] = {}, ml[3] = {}, mr[3] = {};
  int sec[3] = {};
#pragma unroll
  for (int r = 0; r < FS_LOAD; ++r) {
    const float gn = gs[r], en = es[r];
    const float gl = __shfl_up_sync(0xffffffffu, gn, 1);
    const float gr = __shfl_down_sync(0xffffffffu, gn, 1);
    const float e_dn = __shfl_down_sync(0xffffffffu, en, 1);
    const float e_up = __shfl_up_sync(0xffffffffu, en, 1);
    const float fn = lane == 0 ? e_dn : e_up;  // x0 - 2 for lane 0, x0 + 33 for lane 31
    const float hn = (lane == 0 ? en : gl) + 2.0f * gn + (lane == 31 ? en : gr);
    const float hon = lane == 0 ? fn + 2.0f * en + gn : gn + 2.0f * en + fn;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      g[q] = g[q + 1]; e[q] = e[q + 1]; f[q] = f[q + 1]; h[q] = h[q + 1]; ho[q] = ho[q + 1];
    }
    g[2] = gn; e[2] = en; f[2] = fn; h[2] = hn; ho[2] = hon;
    if (r < 2) continue;
    // Magnitude row ym = y0 + r - 3 from gray rows ym - 1 .. ym + 1.
    const int ym = y0 + r - 3;
    const bool row_in = ym >= 0 && ym < H;
    const float v = g[0] + 2.0f * g[1] + g[2];
    const float vo = e[0] + 2.0f * e[1] + e[2];
    const float voo = f[0] + 2.0f * f[1] + f[2];
    const float vl = __shfl_up_sync(0xffffffffu, v, 1);
    const float vr = __shfl_down_sync(0xffffffffu, v, 1);
    const float gxv = (lane == 31 ? vo : vr) - (lane == 0 ? vo : vl);
    const float gyv = h[2] - h[0];
    const float mn = row_in && col_in ? gxv * gxv + gyv * gyv : 0.0f;  // exact integer < 2^24
    const float gxo = lane == 0 ? v - voo : voo - v;
    const float gyo = ho[2] - ho[0];
    const float mo = row_in && outer_in ? gxo * gxo + gyo * gyo : 0.0f;
    const float mln = __shfl_up_sync(0xffffffffu, mn, 1);
    const float mrn = __shfl_down_sync(0xffffffffu, mn, 1);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      m[q] = m[q + 1]; ml[q] = ml[q + 1]; mr[q] = mr[q + 1]; sec[q] = sec[q + 1];
    }
    m[2] = mn;
    ml[2] = lane == 0 ? mo : mln;
    mr[2] = lane == 31 ? mo : mrn;
    sec[2] = sector_of(gxv, gyv);
    if (r < 4) continue;
    // Classify image row ym - 1, the middle of the three magnitude rows.
    const int yc = ym - 1;
    float first, second;
    nms_pick(sec[1], ml[0], m[0], mr[0], ml[1], mr[1], ml[2], m[2], mr[2], first, second);
    const bool c = col_in && yc < H && nms_keep(sec[1], m[1], first, second) && m[1] > low_sq;
    const bool s = c && m[1] > high_sq;
    const uint32_t cbits = __ballot_sync(0xffffffffu, c);
    const uint32_t sbits = __ballot_sync(0xffffffffu, s);
    if (yc < H) {
      if (lane == 0) {
        cw[yc * wpr + k] = cbits;
        sw[yc * wpr + k] = sbits;
      }
      if (col_in) o[(size_t)yc * W + x] = s;
    }
  }
}

// The fixpoint's threads: the first FP_THREADS of the block, which meet at
// named barrier 1 (the others leave once the masks are in shared memory).
constexpr int FP_THREADS = 512;

__device__ __forceinline__ void fp_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(FP_THREADS) : "memory");
}
__device__ __forceinline__ bool fp_sync_or(bool v) {
  int r;
  asm volatile(
      "{\n\t.reg .pred p, q;\n\tsetp.ne.u32 p, %1, 0;\n\t"
      "bar.red.or.pred q, 1, %2, p;\n\tselp.s32 %0, 1, 0, q;\n\t}"
      : "=r"(r)
      : "r"((unsigned)v), "n"(FP_THREADS)
      : "memory");
  return r != 0;
}

// The words of row y that may change at the next step, as the bits of
// dirty word j (word 32 j + i of the row is bit i): those in the 3x3 word
// neighbourhood of a word that changed at this step, i.e. the changed bits
// `d` (rows of `dpr` words, H rows) ORed over rows y - 1 .. y + 1, then
// dilated by one bit, carries across dirty words.  Bits past the row's
// last word may be set; `room` has none there.
__device__ __forceinline__ uint32_t frontier_bits(const uint32_t* d, int y, int j, int H,
                                                  int dpr) {
  auto rows = [=](int jj) {
    uint32_t v = d[y * dpr + jj];
    if (y > 0) v |= d[(y - 1) * dpr + jj];
    if (y + 1 < H) v |= d[(y + 1) * dpr + jj];
    return v;
  };
  const uint32_t c = rows(j);
  uint32_t fr = c | c << 1 | c >> 1;
  if (j > 0) fr |= rows(j - 1) >> 31;
  if (j + 1 < dpr) fr |= rows(j + 1) << 31;
  return fr;
}

// One synchronous step of word w (row y) from `src` into `dst`: w ORed
// with `cand` under the 3x3 dilation of its neighbourhood.  Where it
// changes, its bit is set in `dnext` and in `grown`, and cleared from
// `room` once every `cand` bit of the word is reached.  Returns whether it
// changed.
__device__ __forceinline__ bool step_word(const uint32_t* c, const uint32_t* src, uint32_t* dst,
                                          uint32_t* dnext, uint32_t* room, uint32_t* grown, int y,
                                          int k, int H, int wpr, int dpr) {
  const int w = y * wpr + k;
  const uint32_t cand = c[w], old = src[w];
  uint32_t around = dilate_row(src, y, k, wpr, old);
  if (y > 0) around |= dilate_row(src, y - 1, k, wpr, src[w - wpr]);
  if (y + 1 < H) around |= dilate_row(src, y + 1, k, wpr, src[w + wpr]);
  const uint32_t now = old | (cand & around);
  dst[w] = now;
  if (now == old) return false;
  const uint32_t bit = 1u << (k & 31);
  atomicOr(dnext + y * dpr + (k >> 5), bit);
  atomicOr(grown + y * dpr + (k >> 5), bit);
  if (!(cand & ~now)) atomicAnd(room + y * dpr + (k >> 5), ~bit);
  return true;
}

// K2's fixpoint on packed masks in shared memory, stepping only the
// frontier, by the first FP_THREADS threads of the block (all of them call
// it; the masks are complete and a barrier has passed).  JAX's synchronous
// steps: trips of UNROLL, stop after a trip that grew nothing or once
// `max_iters` steps have run, a step that grows nothing ends its trip
// (hysteresis_fixpoint's loop).  A word can change at step t + 1 only if a
// word of its 3x3 word neighbourhood changed at step t, so a step
// evaluates only those words, and of them only the ones with a `cand` bit
// not yet reached or that changed themselves at step t, and writes them
// into the other buffer; every other word holds the same value in both
// buffers, so the result is JAX's, bit for bit, at every step, cap
// included.
//
// `c` is cand; `src` and `dst` both hold strong.  Bits a word (bit i of
// word j of a row is word 32 j + i; rows of dpr words): `dsrc` marks the
// words that changed at the step before (the strong words that are not 0
// at the start), `room` the words with a `cand` bit not yet reached.  A
// step has two parts, each ended by a barrier of the fixpoint's threads.
// First a thread a row lists the row's frontier words (frontier_bits &
// (room | dsrc)) as 16-bit word numbers, at a place in `list` that one
// shared counter add a warp reserves, and clears the row's bits in
// `dnext`.  Then the threads step the listed words (step_word), one a
// thread, marking in `grown` the words that change.  A step whose frontier
// exceeds the list's `cap` entries or a quarter of the image's words steps
// every word of the image instead (the same bits: a word off the frontier
// does not change), and so does every step of an image of at most two
// words a thread, without the list (one barrier a step).  The list's
// counter and overflow flag alternate between two slots; the step resets
// the slots the step before used.  counters: [0, 1] the list's counter
// slots, [2, 3] the overflow slots, all 0.  With `stats`, writes the steps
// run, the largest frontier, the frontier words of all steps and the steps
// that stepped every word to stats[0..2] and stats[8].  Returns the buffer
// that holds the result.
__device__ __noinline__ const uint32_t* frontier_fixpoint(
    const uint32_t* c, uint32_t* src, uint32_t* dst, uint32_t* dsrc, uint32_t* dnext,
    uint32_t* room, uint32_t* grown, uint16_t* list, int cap, unsigned int* counters, int H,
    int wpr, int max_iters, unsigned long long* stats) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int dpr = (wpr + 31) / 32, n = H * wpr;
  cap = min(cap, n / 4);  // a larger frontier costs more as a list than every word does
  // An image of at most two words a thread steps every word at every step:
  // no list, one barrier a step (the list is built only for `stats`).
  const bool small = n <= 2 * FP_THREADS, scan = !small || stats != nullptr;
  // w / wpr for a word number w < 2^16 as __umulhi(w, ceil(2^32 / wpr)).
  const uint32_t magic = 0xffffffffu / (uint32_t)wpr + 1u;
  auto row_of = [=](uint32_t w) { return wpr == 1 ? (int)w : (int)__umulhi(w, magic); };
  int it = 0, steps = 0;
  unsigned long long most = 0, total = 0, dense = 0;
  bool trip_grew = true;
  while (trip_grew && it < max_iters) {
    trip_grew = false;
    for (int s = 0; s < UNROLL; ++s) {
      const int slot = steps & 1;
      unsigned int* listed = counters + slot;
      unsigned int* overflow = counters + 2 + slot;
      for (int y0 = 0; scan && y0 < H; y0 += FP_THREADS) {  // whole warps, for the shuffles
        const int y = y0 + tid;
        uint32_t fr[2] = {0u, 0u};  // up to 64 words a row listed in one pass
        int n_words = 0;
        for (int j = 0; y < H && j < dpr; ++j) {
          const uint32_t bits = frontier_bits(dsrc, y, j, H, dpr) &
                                (room[y * dpr + j] | dsrc[y * dpr + j]);
          if (j < 2) fr[j] = bits;
          n_words += __popc(bits);
          dnext[y * dpr + j] = 0u;
        }
        if (!__any_sync(0xffffffffu, n_words != 0)) continue;
        // Warp-wide exclusive sum of n_words; lane 31 reserves the warp's run.
        int before = n_words;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, before, d);
          if (lane >= d) before += v;
        }
        unsigned int base = 0;
        if (lane == 31 && before) base = atomicAdd(listed, (unsigned int)before);
        base = __shfl_sync(0xffffffffu, base, 31) + (unsigned int)(before - n_words);
        if (base + n_words > (unsigned int)cap || dpr > 2) {  // step every word
          if (n_words) *overflow = 1u;
        } else {
          for (int j = 0; j < dpr; ++j)
            for (uint32_t bits = fr[j]; bits; bits &= bits - 1)
              list[base++] = (uint16_t)(y * wpr + 32 * j + __ffs(bits) - 1);
        }
      }
      if (scan) {
        if (tid == 0) counters[slot ^ 1] = counters[2 + (slot ^ 1)] = 0u;  // the step before's
        fp_sync();
      }
      const unsigned int n_listed = scan ? *listed : 0u;
      const bool every = small || *overflow;
      bool grew = false;
      if (every) {
        for (int w = tid; w < n; w += FP_THREADS) {
          const int y = row_of((uint32_t)w);
          grew |= step_word(c, src, dst, dnext, room, grown, y, w - y * wpr, H, wpr, dpr);
        }
      } else {
        for (int i = tid; i < (int)n_listed; i += FP_THREADS) {
          const uint32_t w = list[i];
          const int y = row_of(w);
          grew |= step_word(c, src, dst, dnext, room, grown, y, (int)w - y * wpr, H, wpr, dpr);
        }
      }
      if (stats && tid == 0) {
        most = n_listed > most ? n_listed : most;
        total += n_listed;
        dense += every;
      }
      uint32_t* t = src;
      src = dst;
      dst = t;
      t = dsrc;
      dsrc = dnext;
      dnext = t;
      // Also orders this step's writes before the next step's reads.
      const bool any = fp_sync_or(grew);
      ++steps;
      if (!any) break;
      trip_grew = true;
    }
    it += UNROLL;
  }
  if (stats && tid == 0) {
    stats[0] = steps;
    stats[1] = most;
    stats[2] = total;
    stats[8] = dense;
  }
  return src;
}

// Dynamic shared memory of canny_fused_kernel for one H x W image without
// its list: the flags, `cand` and the two state buffers of H * ceil(W / 32)
// words each, rounded up to whole 16-byte chunks, and four masks of one
// bit a word (two dirty, room, grown), rows of ceil(ceil(W / 32) / 32)
// words (ops/canny.py fused_smem_bytes is the wrapper's copy).  The launch adds
// the list of frontier words, 2 bytes a word, up to the whole image and
// the block's opt-in limit.
static size_t fused_smem_bytes(int H, int W) {
  const size_t wpr = (W + 31) / 32, n4 = ((size_t)H * wpr + 3) / 4 * 4, dpr = (wpr + 31) / 32;
  return (FUSED_FLAG_WORDS + 3 * n4 + 4 * H * dpr) * sizeof(uint32_t);
}

// The bytes a launch for an H x W image asks for, and the entries of its
// list of frontier words: a quarter of the image's words (a larger
// frontier steps every word), where the block's opt-in limit allows, else
// what the limit leaves.
static size_t fused_launch_bytes(int H, int W, int optin, int* cap) {
  const size_t base = fused_smem_bytes(H, W), words = (size_t)H * ((W + 31) / 32);
  size_t smem = base + (2 * ((words + 3) / 4) + 15) / 16 * 16;
  if (optin > 0 && smem > (size_t)optin) smem = base > (size_t)optin ? base : (size_t)optin;
  *cap = (int)((smem - base) / 2);
  return smem;
}

// gray: (B, H, W) unpadded; words: per image cand then strong, n4 = H *
// ceil(W / 32) rounded up to a multiple of 4 words each; tickets: one zeroed
// counter per image, left at 0; out: (B, H, W) 0/1 bytes; stats:
// FUSED_STATS 64-bit words per image, or null; cap: the entries of the
// fixpoint's list (fused_launch_bytes).  Grid (P, B): P blocks an image, all
// of one wave where P B blocks fit the card at once
// (revo_canny_fused_blocks), of HYST_THREADS threads.  Warp w of block x
// classifies strips x + P (w + 32 i) of its image (strip s: word column
// s % wpr, band s / wpr of FS_ROWS rows), stores their words and zeroes
// their edge bytes; then the block fences and takes a ticket, and the block
// that draws image b's last runs its fixpoint and writes the words of edges
// that are not 0.  Stats: steps, largest frontier, frontier words of all
// steps, then the global timer (ns) of that block at its start, after its
// ticket, before and after the fixpoint's steps and at its end, then the
// steps that stepped every word.
template <typename T>
__global__ void __launch_bounds__(HYST_THREADS)
canny_fused_kernel(const T* __restrict__ gray, uint32_t* words, unsigned int* tickets,
                   uint8_t* __restrict__ out, unsigned long long* stats, int H, int W,
                   float low_sq, float high_sq, int max_iters, int cap) {
  extern __shared__ __align__(16) uint32_t ff_smem[];
  const unsigned long long t_start = stats ? global_ns() : 0ull;
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = gridDim.x;
  const int wpr = (W + 31) / 32, n = H * wpr, n4 = (n + 3) / 4 * 4;
  uint32_t* cw = words + (size_t)b * 2 * n4;
  uint32_t* sw = cw + n4;
  uint8_t* o = out + (size_t)b * H * W;
  const ReflectGray<T> img{gray + (size_t)b * H * W, H, W};
  const int strips = wpr * ((H + FS_ROWS - 1) / FS_ROWS);
  for (int s = blockIdx.x + P * warp; s < strips; s += P * (HYST_THREADS / 32)) {
    const int band = s / wpr;
    classify_strip(img, 32 * (s - band * wpr), band * FS_ROWS, H, W, wpr, low_sq, high_sq, cw,
                   sw, o, lane);
  }
  volatile uint32_t* last = ff_smem;
  __syncthreads();  // every warp's words and edge bytes are written
  if (tid == 0) {
    __threadfence();  // they are visible (through the barrier) before the ticket
    const bool l = atomicAdd(tickets + b, 1u) == (unsigned int)P - 1;
    if (l) __threadfence();  // and the other blocks' before this block reads them
    *last = l;
  }
  __syncthreads();
  if (!*last) return;
  unsigned long long* st = stats ? stats + (size_t)FUSED_STATS * b : nullptr;
  if (st && tid == 0) {
    st[3] = t_start;
    st[4] = global_ns();
  }

  // Last block of image b: cand and strong from L2 in 16-byte chunks,
  // strong into both buffers; per row the strong words that are not 0 (the
  // first dirty bits), the words with a cand bit strong does not hold, and
  // no word grown yet.
  const int dpr = (wpr + 31) / 32, nd = H * dpr;
  unsigned int* counters = ff_smem + 1;  // [1, 4]
  uint32_t* cm = ff_smem + FUSED_FLAG_WORDS;
  uint32_t* buf0 = cm + n4;
  uint32_t* buf1 = cm + 2 * n4;
  uint32_t* dirty = cm + 3 * n4;  // two of nd words, then room and grown
  uint32_t* room = dirty + 2 * nd;
  uint32_t* grown = room + nd;
  uint16_t* list = reinterpret_cast<uint16_t*>(grown + nd);
  const uint4* from = reinterpret_cast<const uint4*>(cw);
  for (int q = tid; q < n4 / 2; q += HYST_THREADS) {  // cand, then strong
    const uint4 v = __ldcg(from + q);
    reinterpret_cast<uint4*>(cm)[q] = v;
    if (q >= n4 / 4) reinterpret_cast<uint4*>(buf1)[q - n4 / 4] = v;
  }
  if (tid < 4) counters[tid] = 0u;
  __syncthreads();
  for (int q = warp; q < nd; q += HYST_THREADS / 32) {
    const int y = q / dpr, k = 32 * (q - y * dpr) + lane;
    const uint32_t cand = k < wpr ? cm[y * wpr + k] : 0u, strong = k < wpr ? buf0[y * wpr + k] : 0u;
    const uint32_t seeds = __ballot_sync(0xffffffffu, strong != 0u);
    const uint32_t open = __ballot_sync(0xffffffffu, (cand & ~strong) != 0u);
    if (lane == 0) {
      dirty[q] = seeds;
      room[q] = open;
      grown[q] = 0u;
    }
  }
  __syncthreads();
  if (tid >= FP_THREADS) return;  // the fixpoint's threads go on alone
  if (st && tid == 0) st[5] = global_ns();
  const uint32_t* reach = frontier_fixpoint(cm, buf0, buf1, dirty, dirty + nd, room, grown, list,
                                            cap, counters, H, wpr, max_iters, st);
  if (st && tid == 0) st[6] = global_ns();
  // The edges of the words that grew (the others hold strong, which K1
  // wrote), a thread walking `run` rows of one word column.
  const bool vec = (W % 32 == 0) && (reinterpret_cast<uintptr_t>(o) % 16 == 0);
  const int run = (n + FP_THREADS - 1) / FP_THREADS, items = ((H + run - 1) / run) * wpr;
  for (int item = tid; item < items; item += FP_THREADS) {
    const int k = item % wpr, y0 = (item / wpr) * run, y1 = min(y0 + run, H);
    for (int y = y0; y < y1; ++y)
      if ((grown[y * dpr + (k >> 5)] >> (k & 31)) & 1u) unpack_word(reach[y * wpr + k], o, y, k, W, vec);
  }
  if (tid == 0) tickets[b] = 0u;
  if (st) {
    fp_sync();
    if (tid == 0) st[7] = global_ns();
  }
}

template <typename T>
static int launch_canny_fused(const T* gray, uint32_t* words, unsigned int* tickets, uint8_t* out,
                              unsigned long long* stats, int B, int H, int W, float low_sq,
                              float high_sq, int max_iters, int blocks, cudaStream_t stream) {
  int dev = 0, optin = 0, cap = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t smem = fused_launch_bytes(H, W, optin, &cap);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(canny_fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  canny_fused_kernel<T><<<dim3(blocks, B), HYST_THREADS, smem, stream>>>(
      gray, words, tickets, out, stats, H, W, low_sq, high_sq, max_iters, cap);
  return (int)cudaGetLastError();
}

// canny_fused_kernel<T> blocks with the shared memory of an H x W image's
// launch that one SM holds at once, or an error.
template <typename T>
static cudaError_t fused_per_sm(int H, int W, int optin, int* per_sm) {
  int cap = 0;
  const size_t smem = fused_launch_bytes(H, W, optin, &cap);
  cudaError_t err = cudaFuncSetAttribute(canny_fused_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, canny_fused_kernel<T>,
                                                        HYST_THREADS, smem);
  return err;
}

// -- K1 + K2 across a thread-block cluster ----------------------------------

namespace cg = cooperative_groups;

constexpr int CL_TX = 256, CL_TY = 16;  // K1 tile of the cluster kernel
constexpr int CL_PIX = CL_TX * CL_TY / HYST_THREADS;  // pixels a thread classifies per tile
constexpr size_t CLUSTER_TILE_BYTES =
    ((CL_TY + 4) * (CL_TX + 4) + (CL_TY + 2) * (CL_TX + 2)) * sizeof(float);
constexpr int MAX_CLUSTER = 16;  // Hopper's largest cluster (non-portable above 8)

// Dynamic shared memory of one block that owns a band of an H x W image
// split over R blocks: `cand` of its band (rb = ceil(H / R) rows of
// ceil(W / 32) words), state buffer 0 with a halo row above and below, and
// state buffer 1 likewise, which a K1 tile of `tile` bytes overlays while
// buffer 1 is not yet in use.
static size_t band_smem_bytes(int H, int W, int R, size_t tile) {
  const size_t wpr = (W + 31) / 32, rb = (H + R - 1) / R;
  const size_t buf = (rb + 2) * wpr * sizeof(uint32_t);
  return rb * wpr * sizeof(uint32_t) + buf + (buf > tile ? buf : tile);
}

static size_t cluster_smem_bytes(int H, int W, int R) {
  return band_smem_bytes(H, W, R, CLUSTER_TILE_BYTES);
}

// K1 on rows [y0, y1) of one image by the HYST_THREADS threads of a block:
// CL_TX x CL_TY tiles from row y0 over the whole width, CL_PIX pixels a
// thread, the tile staged in g_s / m_s (CLUSTER_TILE_BYTES).  A warp
// classifies 32 pixels of one row, so its two ballots are that row's words
// of cand and strong, stored at cw / sw [(y - y0) * wpr + k]; tile rows that
// run past the band store nothing, and threads past the right edge vote 0.
template <typename T>
__device__ __forceinline__ void classify_band(const ReflectGray<T>& img, int y0, int y1,
                                              int H, int W, int wpr, uint32_t* cw,
                                              uint32_t* sw, float* g_s, float* m_s,
                                              float low_sq, float high_sq, int tid) {
  for (int ty = y0; ty < y1; ty += CL_TY) {
    for (int tx = 0; tx < W; tx += CL_TX) {
      stage_tile<CL_TX, CL_TY, HYST_THREADS>(g_s, m_s, img, tx, ty, H, W, tid);
#pragma unroll
      for (int q = 0; q < CL_PIX; ++q) {
        const int p = tid + q * HYST_THREADS;
        const int i = p / CL_TX, j = p % CL_TX;
        const int y = ty + i, x = tx + j;
        bool c = false, s = false;
        if (y < H && x < W)
          classify_pixel<CL_TX>(g_s, m_s, i + 1, j + 1, low_sq, high_sq, c, s);
        const uint32_t cbits = __ballot_sync(0xffffffffu, c);
        const uint32_t sbits = __ballot_sync(0xffffffffu, s);
        const int k = (tx + j) >> 5;
        if ((tid & 31) == 0 && y < y1 && k < wpr) {
          cw[(y - y0) * wpr + k] = cbits;
          sw[(y - y0) * wpr + k] = sbits;
        }
      }
      __syncthreads();  // the tile is read before the next one is staged
    }
  }
}

// gray: (B, H, W) unpadded; out: (B, H, W) 0/1 bytes.  Grid (R, 1, B) in
// clusters of (R, 1, 1): one cluster an image, HYST_THREADS threads a
// block.  Rank r owns rows [r rb, min((r + 1) rb, H)) (empty for the last
// ranks when R rb > H + rb - 1).
template <typename T>
__global__ void __launch_bounds__(HYST_THREADS)
canny_cluster_kernel(const T* __restrict__ gray, uint8_t* __restrict__ out, int H,
                     int W, float low_sq, float high_sq, int max_iters) {
  extern __shared__ uint32_t cl_smem[];
  __shared__ uint32_t grew_slot[3];  // step s ORs into slot s % 3 of every rank
  cg::cluster_group cluster = cg::this_cluster();
  const int R = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  const int b = blockIdx.z, tid = threadIdx.x;
  const int wpr = (W + 31) / 32, rb = (H + R - 1) / R;
  const int y0 = min(r * rb, H), y1 = min(y0 + rb, H), n = y1 - y0;
  uint32_t* cw = cl_smem;  // cand, band row i at cw[i * wpr]
  // Band row i of buffer j at bufs[j][i * wpr], i = -1 and n the halo rows.
  uint32_t* bufs[2] = {cl_smem + (rb + 1) * wpr, cl_smem + (2 * rb + 3) * wpr};
  float* g_s = reinterpret_cast<float*>(bufs[1] - wpr);  // K1's tile, over buffer 1
  float* m_s = g_s + (CL_TY + 4) * (CL_TX + 4);

  classify_band(ReflectGray<T>{gray + (size_t)b * H * W, H, W}, y0, y1, H, W, wpr, cw,
                bufs[0], g_s, m_s, low_sq, high_sq, tid);
  // Halo rows start at 0: at the image's top and bottom edges they stay so.
  for (int k = tid; k < wpr; k += HYST_THREADS) {
    bufs[0][k - wpr] = bufs[1][k - wpr] = 0u;
    bufs[0][n * wpr + k] = bufs[1][n * wpr + k] = 0u;
  }
  if (tid < 3) grew_slot[tid] = 0u;
  // Every band is classified and every block of the cluster runs before any
  // reads another's shared memory.
  cluster.sync();

  // K2: JAX's synchronous steps, one band a rank.  A step first copies the
  // neighbours' edge rows of the source buffer into this band's halo rows
  // (DSMEM), dilates the band into the other buffer, ORs whether the block
  // grew into every rank's slot for this step, and passes one cluster
  // barrier, which orders this step's writes before the next step's reads.
  // Slot (step + 1) % 3 is reset during step `step`: its readers passed two
  // barriers ago and its writers wait for this one.  Trips and cap as
  // hysteresis_fixpoint.
  const bool above = n > 0 && r > 0, below = n > 0 && y1 < H;
  const int run = (n * wpr + HYST_THREADS - 1) / HYST_THREADS;  // rows per work item
  int cur = 0, step = 0, it = 0;
  bool trip_grew = true;
  while (trip_grew && it < max_iters) {
    trip_grew = false;
    for (int s = 0; s < UNROLL; ++s) {
      uint32_t* src = bufs[cur];
      for (int q = tid; q < 2 * wpr; q += HYST_THREADS) {
        const bool up = q < wpr;
        const int k = up ? q : q - wpr;
        if (up ? above : below) {
          const uint32_t* nb = cluster.map_shared_rank(src, r + (up ? -1 : 1));
          src[(up ? -1 : n) * wpr + k] = nb[(up ? rb - 1 : 0) * wpr + k];
        }
      }
      __syncthreads();
      const bool grew =
          n > 0 && dilate_step_bits<true>(cw, src, bufs[cur ^ 1], n, wpr, run);
      if (tid == 0) grew_slot[(step + 1) % 3] = 0u;
      if (__syncthreads_or(grew) && tid < R)
        atomicOr(cluster.map_shared_rank(&grew_slot[step % 3], tid), 1u);
      cluster.sync();
      const bool any = *reinterpret_cast<volatile uint32_t*>(&grew_slot[step % 3]) != 0u;
      ++step;
      cur ^= 1;
      if (!any) break;
      trip_grew = true;
    }
    it += UNROLL;
  }

  uint8_t* o = out + (size_t)b * H * W;
  const bool vec = (W % 32 == 0) && (reinterpret_cast<uintptr_t>(o) % 16 == 0);
  for (int q = tid; q < n * wpr; q += HYST_THREADS) {
    const int i = q / wpr, k = q - i * wpr;
    unpack_word(bufs[cur][i * wpr + k], o, y0 + i, k, W, vec);
  }
  // A block's shared memory must outlive every neighbour's reads of it.
  cluster.sync();
}

// Launch configuration of an R-block cluster per image, with the kernel's
// attributes set for `smem` bytes.
template <typename T>
static cudaError_t cluster_config(int R, int B, size_t smem, cudaStream_t stream,
                                  cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  cudaError_t err = cudaFuncSetAttribute(
      canny_cluster_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && R > 8)
    err = cudaFuncSetAttribute(canny_cluster_kernel<T>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(R, 1, B);
  cfg->blockDim = dim3(HYST_THREADS, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = R;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return err;
}

// Clusters of R blocks the device can hold at once (0: none), or an error.
template <typename T>
static cudaError_t max_clusters(int R, size_t smem, int* count) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<T>(R, 1, smem, 0, &cfg, &attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(count, canny_cluster_kernel<T>, &cfg);
}

template <typename T>
static int launch_canny_cluster(const T* gray, uint8_t* out, int B, int H, int W,
                                float low_sq, float high_sq, int max_iters, int R,
                                cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      cluster_config<T>(R, B, cluster_smem_bytes(H, W, R), stream, &cfg, &attr);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, canny_cluster_kernel<T>, gray, out, H, W, low_sq,
                             high_sq, max_iters);
  // Also clears a refusal, so that it is not reported again by the next
  // launch's cudaGetLastError.
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}


// -- K1 + K2 across the whole card: one cooperative launch ------------------

// Halo row e (0: the band's first row, 1: its last) of block g of image b,
// for steps of parity p, in the grid kernels' global halo array of
// 2 x B x G x 2 rows of wpr words.
__device__ __forceinline__ uint32_t* halo_row(uint32_t* halo, int p, int g, int e, int wpr) {
  return halo + ((((size_t)p * gridDim.z + blockIdx.z) * gridDim.x + g) * 2 + e) * wpr;
}

// K2's fixpoint over a cooperative grid of (G, 1, B) blocks, block g of
// image b stepping its band of n rows (n = 0 for the empty bands at the
// bottom).  Every block of the grid calls it after its band's `cw` and
// `bufs[0]` (strong) are complete, and it returns the buffer index that
// holds the result.  JAX's synchronous steps: a step reads the whole
// image's previous state, so one grid barrier a step orders its writes
// before the next step's reads.  "Grew" goes by atomicOr into slot
// step % 3 of the launch's three slots, and every block reads the slot
// after the barrier, so all stop at the same step: one verdict for the
// whole launch, because every block must reach every barrier.  For an
// image that has stopped growing, the extra steps change nothing, so the
// result is each image's own fixpoint.  Slot (step + 1) % 3 is reset by
// block (0, 0, 0) during step `step`: its readers passed the barrier before
// and its writers wait for this one.  Trips, early stop and cap as
// hysteresis_fixpoint.
//
// GSTATE false: `cw` and the buffers are in shared memory, each buffer with
// a halo row above and below its band.  A step copies the neighbours' edge
// rows of the source buffer from the global halo array (parity step & 1)
// into the halo rows, dilates, and publishes the band's own first and last
// row of the result at parity (step + 1) & 1, read after the barrier.  A
// parity is written again two steps later, after every reader's barrier.
// GSTATE true: `cw` and the buffers are the band's rows of whole-image
// arrays in global memory, whose rows -1 and H are zero, so a band reads its
// neighbours' rows where they lie; every load goes to L2 (ld_word<true>).
template <bool GSTATE>
__device__ int grid_fixpoint(const uint32_t* cw, uint32_t* const bufs[2], uint32_t* halo,
                             unsigned int* slots, int n, int wpr, bool above, bool below,
                             int max_iters) {
  cg::grid_group grid = cg::this_grid();
  const int g = blockIdx.x, tid = threadIdx.x;
  const bool lead = tid == 0 && blockIdx.x == 0 && blockIdx.z == 0;
  if constexpr (!GSTATE) {
    // Halo rows start at 0: at the image's top and bottom edges they stay so.
    for (int k = tid; k < wpr; k += HYST_THREADS) {
      bufs[0][k - wpr] = bufs[1][k - wpr] = 0u;
      bufs[0][n * wpr + k] = bufs[1][n * wpr + k] = 0u;
      if (n > 0) {
        __stcg(halo_row(halo, 0, g, 0, wpr) + k, bufs[0][k]);
        __stcg(halo_row(halo, 0, g, 1, wpr) + k, bufs[0][(n - 1) * wpr + k]);
      }
    }
  }
  if (lead) slots[0] = 0u;
  grid.sync();

  const int run = (n * wpr + HYST_THREADS - 1) / HYST_THREADS;  // rows per work item
  int cur = 0, step = 0, it = 0;
  bool trip_grew = true;
  while (trip_grew && it < max_iters) {
    trip_grew = false;
    for (int s = 0; s < UNROLL; ++s) {
      uint32_t* src = bufs[cur];
      uint32_t* dst = bufs[cur ^ 1];
      const int p = step & 1;
      if constexpr (!GSTATE) {
        for (int q = tid; q < 2 * wpr; q += HYST_THREADS) {
          const bool up = q < wpr;
          const int k = up ? q : q - wpr;
          if (up ? above : below)
            src[(up ? -1 : n) * wpr + k] =
                __ldcg(halo_row(halo, p, g + (up ? -1 : 1), up ? 1 : 0, wpr) + k);
        }
        __syncthreads();
      }
      const bool grew = n > 0 && dilate_step_bits<true, GSTATE>(cw, src, dst, n, wpr, run);
      const bool block_grew = __syncthreads_or(grew);  // also: dst is complete
      if constexpr (!GSTATE) {
        for (int q = tid; n > 0 && q < 2 * wpr; q += HYST_THREADS) {
          const int e = q < wpr ? 0 : 1, k = q - e * wpr;
          __stcg(halo_row(halo, p ^ 1, g, e, wpr) + k, dst[(e ? n - 1 : 0) * wpr + k]);
        }
      }
      if (lead) slots[(step + 1) % 3] = 0u;
      if (tid == 0 && block_grew) atomicOr(slots + step % 3, 1u);
      grid.sync();
      const bool any = __ldcg(slots + step % 3) != 0u;
      ++step;
      cur ^= 1;
      if (!any) break;
      trip_grew = true;
    }
    it += UNROLL;
  }
  return cur;
}

// gray: (B, H, W) unpadded; out: (B, H, W) 0/1 bytes; halo: 4 B G wpr
// words; slots: 3 words.  A cooperative grid of (G, 1, B) blocks of
// HYST_THREADS threads, all co-resident: block g of image b owns rows
// [g rb, min((g + 1) rb, H)), rb = ceil(H / G) (empty for the last blocks
// when G rb > H + rb - 1), classifies them from the unpadded gray as the
// cluster kernel's ranks do, steps them with grid_fixpoint<false> and
// writes their edges.  Shared memory as the cluster kernel's
// (band_smem_bytes with K1's tile over buffer 1).
template <typename T>
__global__ void __launch_bounds__(HYST_THREADS)
canny_grid_kernel(const T* __restrict__ gray, uint8_t* __restrict__ out, uint32_t* halo,
                  unsigned int* slots, int H, int W, float low_sq, float high_sq,
                  int max_iters) {
  extern __shared__ uint32_t gr_smem[];
  const int G = gridDim.x, g = blockIdx.x, b = blockIdx.z, tid = threadIdx.x;
  const int wpr = (W + 31) / 32, rb = (H + G - 1) / G;
  const int y0 = min(g * rb, H), y1 = min(y0 + rb, H), n = y1 - y0;
  uint32_t* cw = gr_smem;
  uint32_t* const bufs[2] = {gr_smem + (rb + 1) * wpr, gr_smem + (2 * rb + 3) * wpr};
  float* g_s = reinterpret_cast<float*>(bufs[1] - wpr);  // K1's tile, over buffer 1
  float* m_s = g_s + (CL_TY + 4) * (CL_TX + 4);
  classify_band(ReflectGray<T>{gray + (size_t)b * H * W, H, W}, y0, y1, H, W, wpr, cw,
                bufs[0], g_s, m_s, low_sq, high_sq, tid);
  __syncthreads();  // the tile is dead before grid_fixpoint zeroes buffer 1's halo
  const int cur = grid_fixpoint<false>(cw, bufs, halo, slots, n, wpr, n > 0 && g > 0,
                                       n > 0 && y1 < H, max_iters);
  uint8_t* o = out + (size_t)b * H * W;
  const bool vec = (W % 32 == 0) && (reinterpret_cast<uintptr_t>(o) % 16 == 0);
  for (int q = tid; q < n * wpr; q += HYST_THREADS) {
    const int i = q / wpr, k = q - i * wpr;
    unpack_word(bufs[cur][i * wpr + k], o, y0 + i, k, W, vec);
  }
}

// K2 alone over a cooperative grid, on (B, H, W) 0/1 byte masks: block g of
// image b packs its band of cand and strong by warp ballots (lane j votes
// pixel 32 k + j of a row), steps it with grid_fixpoint<GSTATE> and unpacks
// it.  GSTATE false: the band in shared memory (band_smem_bytes without a
// tile); `words` unused.  GSTATE true: per image, `words` holds cand (H rows
// of wpr words) and two state buffers of H + 2 rows whose first and last
// rows block 0 zeroes (3 H + 4 rows); no shared memory; `halo` unused.
template <bool GSTATE>
__global__ void __launch_bounds__(HYST_THREADS)
canny_hysteresis_grid_kernel(const uint8_t* __restrict__ cand,
                             const uint8_t* __restrict__ strong, uint8_t* __restrict__ out,
                             uint32_t* words, uint32_t* halo, unsigned int* slots, int H,
                             int W, int max_iters) {
  extern __shared__ uint32_t hg_smem[];
  const int G = gridDim.x, g = blockIdx.x, b = blockIdx.z, tid = threadIdx.x;
  const int wpr = (W + 31) / 32, rb = (H + G - 1) / G;
  const int y0 = min(g * rb, H), y1 = min(y0 + rb, H), n = y1 - y0;
  uint32_t* cw;
  uint32_t* bufs[2];
  if constexpr (GSTATE) {
    uint32_t* img = words + (size_t)b * (3 * H + 4) * wpr;
    cw = img + (size_t)y0 * wpr;
    bufs[0] = img + (size_t)(H + 1 + y0) * wpr;
    bufs[1] = img + (size_t)(2 * H + 3 + y0) * wpr;
    if (g == 0) {
      for (int k = tid; k < wpr; k += HYST_THREADS) {
        img[(size_t)H * wpr + k] = img[(size_t)(2 * H + 1) * wpr + k] = 0u;
        img[(size_t)(2 * H + 2) * wpr + k] = img[(size_t)(3 * H + 3) * wpr + k] = 0u;
      }
    }
  } else {
    cw = hg_smem;
    bufs[0] = hg_smem + (rb + 1) * wpr;
    bufs[1] = hg_smem + (2 * rb + 3) * wpr;
  }
  const size_t off = (size_t)b * H * W;
  const int lane = tid & 31;
  for (int q = tid >> 5; q < n * wpr; q += HYST_THREADS / 32) {
    const int i = q / wpr, k = q - i * wpr, x = 32 * k + lane;
    const size_t px = off + (size_t)(y0 + i) * W + x;
    const uint32_t cbits = __ballot_sync(0xffffffffu, x < W && cand[px]);
    const uint32_t sbits = __ballot_sync(0xffffffffu, x < W && strong[px]);
    if (lane == 0) {
      cw[q] = cbits;
      bufs[0][q] = sbits;
    }
  }
  __syncthreads();
  const int cur = grid_fixpoint<GSTATE>(cw, bufs, halo, slots, n, wpr, n > 0 && g > 0,
                                        n > 0 && y1 < H, max_iters);
  uint8_t* o = out + off;
  const bool vec = (W % 32 == 0) && (reinterpret_cast<uintptr_t>(o) % 16 == 0);
  for (int q = tid; q < n * wpr; q += HYST_THREADS)
    unpack_word(ld_word<GSTATE>(bufs[cur] + q), o, y0 + q / wpr, q % wpr, W, vec);
}

// One cooperative launch of `kernel` over (G, 1, B) blocks with `smem`
// bytes of dynamic shared memory.  A launch the device refuses (more blocks
// than can be co-resident, a band above a block's opt-in shared memory)
// returns its error, and the error is cleared so that the next launch's
// cudaGetLastError does not report it again.
template <typename... Params, typename... Args>
static int launch_cooperative(void (*kernel)(Params...), int G, int B, size_t smem,
                              cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err == cudaSuccess) {
    cudaLaunchConfig_t cfg{};
    cfg.gridDim = dim3(G, 1, B);
    cfg.blockDim = dim3(HYST_THREADS, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeCooperative;
    attr.val.cooperative = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, args...);
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// Blocks of `kernel` with `smem` bytes that the device holds at once, or an
// error.
template <typename... Params>
static cudaError_t resident_blocks(void (*kernel)(Params...), size_t smem, int sms,
                                   int* count) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, HYST_THREADS, smem);
  *count = per_sm * sms;
  return err;
}

// Blocks an image (G) of a cooperative launch over B images of H x W: the
// largest G whose band (band_smem_bytes with a `tile`-byte K1 tile; no
// shared memory at all with `no_smem`) fits a block's opt-in shared memory
// and with which all B G blocks of both kernels are co-resident; 0 if none;
// a CUDA error as its negative.
template <typename KA, typename KB>
static int grid_blocks(int H, int W, int B, size_t tile, bool no_smem, KA ka, KB kb) {
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  // A 1024-thread block leaves room for at most 2 an SM (2048 threads).
  for (int G = B >= 1 ? 2 * sms / B : 0; G >= 1; --G) {
    const size_t smem = no_smem ? 0 : band_smem_bytes(H, W, G, tile);
    if (smem > (size_t)optin) return 0;  // a smaller G has a larger band
    int na = 0, nb = 0;
    err = resident_blocks(ka, smem, sms, &na);
    if (err == cudaSuccess) err = resident_blocks(kb, smem, sms, &nb);
    if (err != cudaSuccess) {
      cudaGetLastError();  // not left for the next launch to report
      return -(int)err;
    }
    if ((long)G * B <= (long)(na < nb ? na : nb)) return G;
  }
  return 0;
}

}  // namespace

// K1 of B images of H x W (H, W >= 2), gray float32 or, with `gray_u8`,
// uint8, unpadded, over `blocks` persistent blocks (revo_canny_nms_blocks
// gives the card's count).
extern "C" int revo_canny_nms(const void* gray, int gray_u8, uint8_t* cand, uint8_t* strong,
                              int B, int H, int W, float low_sq, float high_sq, int blocks,
                              cudaStream_t stream) {
  if (blocks < 1 || H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  if (gray_u8)
    return launch_canny_nms(static_cast<const uint8_t*>(gray), cand, strong, B, H, W, low_sq,
                            high_sq, blocks, stream);
  return launch_canny_nms(static_cast<const float*>(gray), cand, strong, B, H, W, low_sq,
                          high_sq, blocks, stream);
}

extern "C" int revo_canny_nms_blocks(int B, int H, int W, int gray_u8, cudaStream_t) {
  return gray_u8 ? nms_blocks<uint8_t>(B, H, W) : nms_blocks<float>(B, H, W);
}

// K1's tile as (NMS_TY << 16) | NMS_TX: the wrapper's copy (ops/canny.py
// NMS_TILE) is held to it.
extern "C" int revo_canny_nms_tile(cudaStream_t) { return (NMS_TY << 16) | NMS_TX; }

// Shared memory the packed form needs for one H x W image: cand and two
// state buffers of H * ceil(W / 32) words.
static size_t hysteresis_smem_bytes(int H, int W) {
  return (size_t)3 * H * ((W + 31) / 32) * sizeof(uint32_t);
}

// Dynamic shared memory one block may opt in to on the current device
// (232448 bytes on an H100), or -1: what decides which form an image takes.
extern "C" int revo_canny_hysteresis_shared_limit(cudaStream_t) {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return bytes;
}

extern "C" int revo_canny_hysteresis(const uint8_t* cand, const uint8_t* strong,
                                     uint8_t* out, int B, int H, int W,
                                     int max_iters, cudaStream_t stream) {
  const size_t smem = hysteresis_smem_bytes(H, W);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        canny_hysteresis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  canny_hysteresis_kernel<<<B, HYST_THREADS, smem, stream>>>(cand, strong, out,
                                                             H, W, max_iters);
  return (int)cudaGetLastError();
}

// K1 + K2 of B images of H x W in one launch of `blocks` blocks an image
// (revo_canny_fused_blocks chooses them).  gray is float32, or uint8 with
// `gray_u8`; H, W >= 2, and the image must be one whose masks fit a block
// (fused_smem_bytes within revo_canny_hysteresis_shared_limit).  words: B
// times 2 n4 words (n4 = H ceil(W / 32) rounded up to a multiple of 4), no
// content needed; tickets: B zeroed words, left at 0; stats: 8 64-bit
// words an image (canny_fused_kernel's), or null.  A launch the
// device refuses returns its error.
extern "C" int revo_canny_fused(const void* gray, int gray_u8, uint32_t* words,
                                unsigned int* tickets, uint8_t* out, unsigned long long* stats,
                                int B, int H, int W, float low_sq, float high_sq, int max_iters,
                                int blocks, cudaStream_t stream) {
  if (blocks < 1 || H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  if (gray_u8)
    return launch_canny_fused(static_cast<const uint8_t*>(gray), words, tickets, out, stats, B,
                              H, W, low_sq, high_sq, max_iters, blocks, stream);
  return launch_canny_fused(static_cast<const float*>(gray), words, tickets, out, stats, B, H,
                            W, low_sq, high_sq, max_iters, blocks, stream);
}

// Blocks an image (P) of one canny_fused launch over B images of H x W on
// the current device: the card's resident blocks of the kernel (the
// occupancy query, for both gray types) shared by the B images, at least 1
// and at most one a K1 strip; 0 where a block cannot hold the image's
// masks; a CUDA error as its negative.
extern "C" int revo_canny_fused_blocks(int B, int H, int W, cudaStream_t) {
  int dev = 0, sms = 0, optin = 0, per_u8 = 0, per_f32 = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess && fused_smem_bytes(H, W) > (size_t)optin) return 0;
  if (err == cudaSuccess) err = fused_per_sm<uint8_t>(H, W, optin, &per_u8);
  if (err == cudaSuccess) err = fused_per_sm<float>(H, W, optin, &per_f32);
  if (err != cudaSuccess) {
    cudaGetLastError();  // not left for the next launch to report
    return -(int)err;
  }
  const int per_sm = per_u8 < per_f32 ? per_u8 : per_f32;
  if (per_sm < 1 || B < 1 || H < 2 || W < 2) return 0;
  const long strips = (long)((W + 31) / 32) * ((H + FS_ROWS - 1) / FS_ROWS);
  long p = (long)per_sm * sms / B;
  if (p < 1) p = 1;
  return (int)(p < strips ? p : strips);
}

// The dense form: gray is float32, or uint8 with `gray_u8`; H, W >= 2, and
// the image must be one the packed fixpoint fits
// (revo_canny_hysteresis_shared_limit).  words: 2 B H ceil(W / 32).
extern "C" int revo_canny_fused_dense(const void* gray, int gray_u8, uint32_t* words,
                                      unsigned int* tickets, uint8_t* out, int B, int H, int W,
                                      float low_sq, float high_sq, int max_iters,
                                      cudaStream_t stream) {
  size_t smem = hysteresis_smem_bytes(H, W);
  if (smem < FUSED_TILE_BYTES) smem = FUSED_TILE_BYTES;
  if (gray_u8)
    return launch_canny_fused_dense(static_cast<const uint8_t*>(gray), words, tickets, out, B, H,
                                    W, low_sq, high_sq, max_iters, smem, stream);
  return launch_canny_fused_dense(static_cast<const float*>(gray), words, tickets, out, B, H, W,
                                  low_sq, high_sq, max_iters, smem, stream);
}

extern "C" int revo_canny_hysteresis_global(const uint8_t* cand,
                                            const uint8_t* strong, uint8_t* out,
                                            uint8_t* tmp, int B, int H, int W,
                                            int max_iters, cudaStream_t stream) {
  canny_hysteresis_global_kernel<<<B, HYST_THREADS, 0, stream>>>(
      cand, strong, out, tmp, H, W, max_iters);
  return (int)cudaGetLastError();
}

// Blocks per image the cluster kernel takes for an H x W image on the
// current device: the largest of 16 and 8 whose band fits a block's opt-in
// shared memory and of which the device can hold a cluster at once, for
// both gray types; 0 if neither; a CUDA error as its negative.  What
// decides, with revo_canny_hysteresis_shared_limit, which kernels an image
// takes.
extern "C" int revo_canny_cluster_ranks(int H, int W, cudaStream_t) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -(int)err;
  const int choices[2] = {MAX_CLUSTER, 8};
  for (int R : choices) {
    const size_t smem = cluster_smem_bytes(H, W, R);
    if (smem > (size_t)optin) continue;
    int n_u8 = 0, n_f32 = 0;
    err = max_clusters<uint8_t>(R, smem, &n_u8);
    if (err == cudaSuccess) err = max_clusters<float>(R, smem, &n_f32);
    if (err != cudaSuccess) {
      cudaGetLastError();  // not left for the next launch to report
      return -(int)err;
    }
    if (n_u8 > 0 && n_f32 > 0) return R;
  }
  return 0;
}

// K1 + K2 of B images in one launch, an R-block cluster each
// (revo_canny_cluster_ranks chooses R).  gray is float32, or uint8 with
// `gray_u8`; H, W >= 2.  A launch the device refuses (a cluster above 16
// blocks, a band above a block's shared memory) returns its error.
extern "C" int revo_canny_cluster(const void* gray, int gray_u8, uint8_t* out, int B,
                                  int H, int W, float low_sq, float high_sq,
                                  int max_iters, int ranks, cudaStream_t stream) {
  if (ranks < 1) return (int)cudaErrorInvalidValue;
  if (gray_u8)
    return launch_canny_cluster(static_cast<const uint8_t*>(gray), out, B, H, W, low_sq,
                                high_sq, max_iters, ranks, stream);
  return launch_canny_cluster(static_cast<const float*>(gray), out, B, H, W, low_sq,
                              high_sq, max_iters, ranks, stream);
}

// Blocks an image (G) canny_grid takes for B images of H x W on the current
// device (grid_blocks, with K1's tile, for both gray types); 0 if none; a
// CUDA error as its negative.  What decides, beside
// revo_canny_cluster_ranks, which kernels an image takes, and how many
// images one launch takes.
extern "C" int revo_canny_grid_blocks(int H, int W, int B, cudaStream_t) {
  return grid_blocks(H, W, B, CLUSTER_TILE_BYTES, false, canny_grid_kernel<uint8_t>,
                     canny_grid_kernel<float>);
}

// K1 + K2 of B images in one cooperative launch of G blocks an image
// (revo_canny_grid_blocks chooses G).  gray is float32, or uint8 with
// `gray_u8`; H, W >= 2; halo: 4 B G ceil(W / 32) words and slots: 3 words,
// neither needing any content.  A launch the device refuses returns its
// error.
extern "C" int revo_canny_grid(const void* gray, int gray_u8, uint8_t* out, uint32_t* halo,
                               unsigned int* slots, int B, int H, int W, float low_sq,
                               float high_sq, int max_iters, int blocks,
                               cudaStream_t stream) {
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = band_smem_bytes(H, W, blocks, CLUSTER_TILE_BYTES);
  if (gray_u8)
    return launch_cooperative(canny_grid_kernel<uint8_t>, blocks, B, smem, stream,
                              static_cast<const uint8_t*>(gray), out, halo, slots, H, W,
                              low_sq, high_sq, max_iters);
  return launch_cooperative(canny_grid_kernel<float>, blocks, B, smem, stream,
                            static_cast<const float*>(gray), out, halo, slots, H, W, low_sq,
                            high_sq, max_iters);
}

// Blocks an image (G) K2's grid form takes for B images of H x W: with the
// packed state in shared memory (`state_global` 0) or in global memory (1).
extern "C" int revo_canny_hysteresis_grid_blocks(int H, int W, int B, int state_global,
                                                 cudaStream_t) {
  if (state_global)
    return grid_blocks(H, W, B, 0, true, canny_hysteresis_grid_kernel<true>,
                       canny_hysteresis_grid_kernel<true>);
  return grid_blocks(H, W, B, 0, false, canny_hysteresis_grid_kernel<false>,
                     canny_hysteresis_grid_kernel<false>);
}

// K2 of B images of 0/1 byte masks in one cooperative launch of G blocks an
// image.  state_global 0: halo holds 4 B G ceil(W / 32) words, `words` is
// unused; 1: words holds B (3 H + 4) ceil(W / 32) words, `halo` is unused.
// slots: 3 words.  None needs any content.
extern "C" int revo_canny_hysteresis_grid(const uint8_t* cand, const uint8_t* strong,
                                          uint8_t* out, uint32_t* words, uint32_t* halo,
                                          unsigned int* slots, int B, int H, int W,
                                          int max_iters, int blocks, int state_global,
                                          cudaStream_t stream) {
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  if (state_global)
    return launch_cooperative(canny_hysteresis_grid_kernel<true>, blocks, B, 0, stream, cand,
                              strong, out, words, halo, slots, H, W, max_iters);
  return launch_cooperative(canny_hysteresis_grid_kernel<false>, blocks, B,
                            band_smem_bytes(H, W, blocks, 0), stream, cand, strong, out, words,
                            halo, slots, H, W, max_iters);
}
