// Canny on Hopper: K1 (Sobel + NMS + double threshold) and K2 (hysteresis,
// on bit-packed masks in shared memory and on byte masks in global memory).
//
// K1 `revo_canny_nms` replaces the Pallas kernels of
// revo_tpu/ops/pallas/canny_kernel.py (`_nms_core` run by `_canny_single` /
// `_nms_batched`).  One thread per output pixel, 32x8 pixels per block.  The
// block stages its gray tile plus a 2-pixel halo in shared memory (NMS needs
// the magnitude of 8 neighbours, each of which needs its own 3x3 Sobel
// window), computes the magnitude of the tile plus a 1-pixel ring into
// shared memory, then each thread classifies its pixel.  Bound on the H100:
// memory traffic, 4 B of gray in and 2 B of masks out per pixel (~1.8 MB
// at 640x480, i.e. ~1 us of HBM time); at these sizes the launch dominates.
// The design keeps every intermediate (gx, gy, magnitude) in registers and
// shared memory, so the image is read once and written once.
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
// `revo_canny_hysteresis_global` is the same loop over ping-pong byte masks
// in global memory (a 640x480 mask is 300 KB and stays in L2; where rows are
// whole 16-byte chunks a thread dilates 16 pixels per step with word-wide
// ORs and shifts).  It takes the images whose three packed masks exceed a
// block's shared memory; the caller chooses by shape before the launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr float TG22 = 0.41421356237309504880f;  // tan(pi/8) as float
constexpr float TG67 = 2.41421356237309504880f;  // tan(pi/8) + 2 as float

// gp: (B, H+2, W+2) REFLECT_101-padded gray.  Output pixel (y, x) of image
// b has its Sobel window at gp rows y..y+2, cols x..x+2.
__global__ void canny_nms_kernel(const float* __restrict__ gp,
                                 uint8_t* __restrict__ cand,
                                 uint8_t* __restrict__ strong, int H, int W,
                                 float low_sq, float high_sq) {
  __shared__ float g_s[TY + 4][TX + 4];  // gp rows y0-1 .. y0+TY+2
  __shared__ float m_s[TY + 2][TX + 2];  // magnitude at y0-1 .. y0+TY
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const int Hp = H + 2, Wp = W + 2;
  const float* img = gp + (size_t)b * Hp * Wp;
  const int tid = threadIdx.y * TX + threadIdx.x;

  // g_s[i][j] = gp[y0 - 1 + i][x0 - 1 + j]; out-of-range entries only feed
  // magnitudes outside the image, which are forced to 0 below.
  for (int k = tid; k < (TY + 4) * (TX + 4); k += TX * TY) {
    const int i = k / (TX + 4), j = k % (TX + 4);
    const int gy = y0 - 1 + i, gx = x0 - 1 + j;
    g_s[i][j] = (gy >= 0 && gy < Hp && gx >= 0 && gx < Wp)
                    ? img[(size_t)gy * Wp + gx]
                    : 0.0f;
  }
  __syncthreads();

  // m_s[i][j] = magnitude of image pixel (y0 - 1 + i, x0 - 1 + j), whose
  // Sobel window is g_s rows i..i+2, cols j..j+2.
  for (int k = tid; k < (TY + 2) * (TX + 2); k += TX * TY) {
    const int i = k / (TX + 2), j = k % (TX + 2);
    const int y = y0 - 1 + i, x = x0 - 1 + j;
    float m = 0.0f;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const float gxv = (g_s[i][j + 2] + 2.0f * g_s[i + 1][j + 2] + g_s[i + 2][j + 2]) -
                        (g_s[i][j] + 2.0f * g_s[i + 1][j] + g_s[i + 2][j]);
      const float gyv = (g_s[i + 2][j] + 2.0f * g_s[i + 2][j + 1] + g_s[i + 2][j + 2]) -
                        (g_s[i][j] + 2.0f * g_s[i][j + 1] + g_s[i][j + 2]);
      m = gxv * gxv + gyv * gyv;  // exact integer < 2^24
    }
    m_s[i][j] = m;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const int i = threadIdx.y + 1, j = threadIdx.x + 1;  // m_s coordinates
  // g_s window of this pixel: rows i..i+2, cols j..j+2.
  const float gxv = (g_s[i][j + 2] + 2.0f * g_s[i + 1][j + 2] + g_s[i + 2][j + 2]) -
                    (g_s[i][j] + 2.0f * g_s[i + 1][j] + g_s[i + 2][j]);
  const float gyv = (g_s[i + 2][j] + 2.0f * g_s[i + 2][j + 1] + g_s[i + 2][j + 2]) -
                    (g_s[i][j] + 2.0f * g_s[i][j + 1] + g_s[i][j + 2]);
  const float m = m_s[i][j];
  const float ax = fabsf(gxv), ay = fabsf(gyv);
  bool keep;
  if (ay < __fmul_rn(ax, TG22)) {  // horizontal gradient: compare left/right
    keep = (m > m_s[i][j - 1]) && (m >= m_s[i][j + 1]);
  } else if (ay > __fmul_rn(ax, TG67)) {  // vertical: compare up/down
    keep = (m > m_s[i - 1][j]) && (m >= m_s[i + 1][j]);
  } else if (__fmul_rn(gxv, gyv) >= 0.0f) {  // "\" diagonal
    keep = (m > m_s[i - 1][j - 1]) && (m > m_s[i + 1][j + 1]);
  } else {  // "/" diagonal
    keep = (m > m_s[i - 1][j + 1]) && (m > m_s[i + 1][j - 1]);
  }
  const bool c = keep && (m > low_sq);
  const size_t o = (size_t)b * H * W + (size_t)y * W + x;
  cand[o] = c ? 1 : 0;
  strong[o] = (c && (m > high_sq)) ? 1 : 0;
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
__device__ __forceinline__ uint32_t dilate_row(const uint32_t* s, int y, int k,
                                               int wpr, uint32_t centre) {
  const uint32_t* row = s + y * wpr;
  const uint32_t left = k > 0 ? row[k - 1] >> 31 : 0u;
  const uint32_t right = k < wpr - 1 ? row[k + 1] << 31 : 0u;
  return centre | centre << 1 | centre >> 1 | left | right;
}

// One synchronous step src -> dst on packed words.  A work item is `run`
// consecutive rows of one word column; items are numbered column-fastest,
// so a warp reads neighbouring words.  Returns whether this thread grew.
__device__ __forceinline__ bool dilate_step_bits(const uint32_t* c,
                                                 const uint32_t* src,
                                                 uint32_t* dst, int H, int wpr,
                                                 int run) {
  bool grew = false;
  const int items = ((H + run - 1) / run) * wpr;
  for (int item = threadIdx.x; item < items; item += HYST_THREADS) {
    const int k = item % wpr;
    const int y0 = (item / wpr) * run, y1 = min(y0 + run, H);
    uint32_t c_cur = src[y0 * wpr + k];
    uint32_t h_prev = y0 > 0 ? dilate_row(src, y0 - 1, k, wpr, src[(y0 - 1) * wpr + k]) : 0u;
    uint32_t h_cur = dilate_row(src, y0, k, wpr, c_cur);
    for (int y = y0; y < y1; ++y) {
      uint32_t c_next = 0u, h_next = 0u;
      if (y + 1 < H) {
        c_next = src[(y + 1) * wpr + k];
        h_next = dilate_row(src, y + 1, k, wpr, c_next);
      }
      const uint32_t out = c_cur | (c[y * wpr + k] & (h_prev | h_cur | h_next));
      grew |= out != c_cur;
      dst[y * wpr + k] = out;
      h_prev = h_cur; h_cur = h_next; c_cur = c_next;
    }
  }
  return grew;
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

  const int run = (n + HYST_THREADS - 1) / HYST_THREADS;  // rows per work item
  int cur = 0;
  int it = 0;
  bool trip_grew = true;
  while (trip_grew && it < max_iters) {
    trip_grew = false;
    for (int s = 0; s < UNROLL; ++s) {
      const bool grew = dilate_step_bits(c, bufs[cur], bufs[cur ^ 1], H, wpr, run);
      cur ^= 1;
      // Also orders this step's writes before the next step's reads.
      if (!__syncthreads_or(grew)) break;
      trip_grew = true;
    }
    it += UNROLL;
  }
  for (int q = threadIdx.x; q < n; q += HYST_THREADS) {
    const int y = q / wpr, k = q - y * wpr;
    unpack_word(bufs[cur][q], out + off, y, k, W, vec);
  }
}

}  // namespace

extern "C" int revo_canny_nms(const float* gp, uint8_t* cand, uint8_t* strong,
                              int B, int H, int W, float low_sq, float high_sq,
                              cudaStream_t stream) {
  dim3 block(TX, TY);
  dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  canny_nms_kernel<<<grid, block, 0, stream>>>(gp, cand, strong, H, W, low_sq,
                                               high_sq);
  return (int)cudaGetLastError();
}

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

extern "C" int revo_canny_hysteresis_global(const uint8_t* cand,
                                            const uint8_t* strong, uint8_t* out,
                                            uint8_t* tmp, int B, int H, int W,
                                            int max_iters, cudaStream_t stream) {
  canny_hysteresis_global_kernel<<<B, HYST_THREADS, 0, stream>>>(
      cand, strong, out, tmp, H, W, max_iters);
  return (int)cudaGetLastError();
}
