// Canny on Hopper: K1 (Sobel + NMS + double threshold) and K2 (hysteresis).
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
// the whole fixpoint: synchronous (Jacobi) 3x3 dilation steps over ping-pong
// byte masks in global memory (a 640x480 mask is 300 KB and stays in L2),
// __syncthreads_or between steps; where rows are whole 16-byte chunks a
// thread dilates 16 pixels per step with word-wide ORs and shifts.  It reproduces the JAX loop exactly, cap
// included: trips of 8 steps, stop after a trip that grew nothing or once
// `max_iters` (= H + W) steps have run.  A step that grows nothing ends its
// trip early; the remaining steps of that trip would change nothing.
// Bound on the H100: latency of the serial step chain on one SM (one
// block per image, up to H+W dependent steps); the batch spreads images
// over SMs.  A connected-components or bit-packed form is later work.
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
canny_hysteresis_kernel(const uint8_t* __restrict__ cand,
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

extern "C" int revo_canny_hysteresis(const uint8_t* cand, const uint8_t* strong,
                                     uint8_t* out, uint8_t* tmp, int B, int H,
                                     int W, int max_iters,
                                     cudaStream_t stream) {
  canny_hysteresis_kernel<<<B, HYST_THREADS, 0, stream>>>(cand, strong, out,
                                                          tmp, H, W, max_iters);
  return (int)cudaGetLastError();
}
