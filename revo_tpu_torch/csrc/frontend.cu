// The front end's and the keyframe's hand kernels: the exact EDT with the
// structure and quad table (revo_edt_columns + revo_keyframe_rows), the edge
// cloud (revo_edge_cloud) and one pyramid step (revo_pyr_level).
//
// None of them replaces a pl.pallas_call: they are the device form of the
// two other jitted programs of the main path, revo_tpu/frontend.py's
// build_frame (:47-48, an XLA program) and make_keyframe (:219-228), whose
// EDT band loop is a device lax.while_loop (revo_tpu/ops/edt.py:99-137).
// The port ran both as eager torch ops: ~1,000-1,500 small launches and 3
// host reads (the band radius) a keyframe, ~306 launches a frame.  Each
// kernel here takes B lanes in one launch and is bit-equal to its plain
// version (ops/edt.py keyframe_tables_ref, ops/backproject.py
// backproject_edges_ref, ops/filters.py pyr_level_ref); every product and
// sum is written with __f*_rn, because NVCC_FLAGS let nvcc contract a * b + c
// into an FMA.
//
// Bounds (bytes over 3.35 TB/s; the integer work is small): the EDT pair
// reads the edges once and writes the structure and the quad table (640x480,
// dt4bf: 0.31 + 3.69 + 2.46 MB, ~1.9 us); the cloud reads edges and depth
// (1.5 MB) and writes the points; the pyramid step reads a level and writes
// the next.  All four are latency- and launch-bound at these sizes: the
// design keeps each a single pass (the cloud: two kernels in one call) with
// no host read, so a keyframe is 6 launches and a frame's pyramid 2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fe {

constexpr float BIG = 1e9f;  // the plain version's sentinel (ops/edt.py _BIG)

// ---------------------------------------------------------------------------
// 1. revo_edt_columns: g^2 of every pixel, g the vertical distance to the
// nearest edge of its column (BIG where the column has none), g^2 clamped to
// BIG: ops/edt.py edt_columns_ref (the log-doubling min-plus relaxations of
// _column_distances, a TPU form) as two sweeps.  A block is 32 columns x
// EDT_SEGMENTS segments of rows: each thread finds the first and last edge of
// its segment, the segments meet in shared memory, and each thread sweeps
// its segment down (distance to the edge above, kept as an int in the
// output) and up (the edge below) with the exact integer distance.
constexpr int EDT_COLS = 32;
constexpr int EDT_SEGMENTS = 8;

__global__ void __launch_bounds__(EDT_COLS * EDT_SEGMENTS)
edt_columns_kernel(const uint8_t* __restrict__ edges, float* __restrict__ g2, int H, int W) {
  __shared__ int first_edge[EDT_SEGMENTS][EDT_COLS];
  __shared__ int last_edge[EDT_SEGMENTS][EDT_COLS];
  const int cx = threadIdx.x % EDT_COLS, seg = threadIdx.x / EDT_COLS;
  const int x = blockIdx.x * EDT_COLS + cx;
  const size_t lane = (size_t)blockIdx.y * H * W;
  const int rows = (H + EDT_SEGMENTS - 1) / EDT_SEGMENTS;
  const int y0 = min(seg * rows, H), y1 = min(y0 + rows, H);
  const uint8_t* e = edges + lane + x;
  int* dn = reinterpret_cast<int*>(g2 + lane + x);
  int first = -1, last = -1;
  if (x < W) {
    for (int y = y0; y < y1; ++y)
      if (e[(size_t)y * W]) {
        if (first < 0) first = y;
        last = y;
      }
  }
  first_edge[seg][cx] = first;
  last_edge[seg][cx] = last;
  __syncthreads();
  if (x >= W) return;
  int above = -1, below = -1;  // nearest edge rows outside the segment
  for (int s = seg - 1; s >= 0 && above < 0; --s) above = last_edge[s][cx];
  for (int s = seg + 1; s < EDT_SEGMENTS && below < 0; ++s) below = first_edge[s][cx];
  // Down: the distance to the nearest edge at or above (-1: none).
  for (int y = y0; y < y1; ++y) {
    if (e[(size_t)y * W]) above = y;
    dn[(size_t)y * W] = above < 0 ? -1 : y - above;
  }
  // Up: the nearest edge at or below; the smaller of the two, squared.
  float* out = g2 + lane + x;
  for (int y = y1 - 1; y >= y0; --y) {
    if (e[(size_t)y * W]) below = y;
    int d = dn[(size_t)y * W];
    if (below >= 0 && (d < 0 || below - y < d)) d = below - y;
    float v = BIG;
    if (d >= 0) {
      const float g = (float)d;
      v = fminf(__fmul_rn(g, g), BIG);
    }
    out[(size_t)y * W] = v;
  }
}

// ---------------------------------------------------------------------------
// 2. revo_keyframe_rows: from g^2, the exact 1-D squared EDT of each row,
// D(x) = min_i (g^2(i) + (x - i)^2), its correctly rounded root (dt), the
// structure (gx, gy, dt) with clamped borders and the quad table of the
// config's form: ops/edt.py keyframe_rows_ref.
//
// No band radius: a pixel's search over offsets o = 1, 2, ... stops once
// o^2 >= its best so far, since every later candidate g^2 + o'^2 >= o'^2 >
// best.  Rounding is monotone, so any search that sees the minimum returns
// the same float32 value as the plain version's banded one; offsets past the
// row's ends (the plain version's BIG padding, >= BIG >= best) are skipped.
// A row whose g^2 is BIG everywhere (a lane with no edge) is BIG everywhere.
//
// A block owns a band of rows of one lane and recomputes dt for one halo
// row above and two below (gy of row y + 1 reads dt(y + 2), which the
// 12-component quad needs), so it writes the structure and the quad table
// from its own shared memory without a third pass.
constexpr int ROWS_THREADS = 256;

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(ROWS_THREADS)
keyframe_rows_kernel(const float* __restrict__ g2, float* __restrict__ structs,
                     void* __restrict__ quad, int H, int W, int width, int bf16, int band) {
  extern __shared__ float smem[];
  float* srow = smem;      // one row of g^2
  float* sdt = smem + W;   // dt of the window's rows
  const int b = blockIdx.y;
  const int y0 = blockIdx.x * band, y1 = min(y0 + band, H);
  const int lo = max(y0 - 1, 0), hi = min(y1 + 1, H - 1);  // the window, inclusive
  const float* lane_g2 = g2 + (size_t)b * H * W;
  for (int r = lo; r <= hi; ++r) {
    bool finite = false;
    for (int x = threadIdx.x; x < W; x += ROWS_THREADS) {
      const float v = lane_g2[(size_t)r * W + x];
      srow[x] = v;
      finite |= v < BIG;
    }
    const int any = __syncthreads_or(finite);
    float* out = sdt + (size_t)(r - lo) * W;
    for (int x = threadIdx.x; x < W; x += ROWS_THREADS) {
      float best = srow[x];
      if (any) {
        const int reach = max(x, W - 1 - x);
        for (int o = 1; o <= reach; ++o) {
          const float o2 = (float)(o * o);
          if (o2 >= best) break;
          if (x - o >= 0) best = fminf(best, __fadd_rn(srow[x - o], o2));
          if (x + o < W) best = fminf(best, __fadd_rn(srow[x + o], o2));
        }
      }
      out[x] = __fsqrt_rn(best);
    }
    __syncthreads();
  }
  auto dt = [&](int y, int x) {
    return sdt[(size_t)(clampi(y, 0, H - 1) - lo) * W + clampi(x, 0, W - 1)];
  };
  for (int i = threadIdx.x; i < (y1 - y0) * W; i += ROWS_THREADS) {
    const int y = y0 + i / W, x = i % W;
    const size_t px = ((size_t)b * H + y) * W + x;
    float s[4][3];  // taps (y, x), (y, x+1), (y+1, x), (y+1, x+1): (gx, gy, dt)
    for (int t = 0; t < 4; ++t) {
      const int ty = clampi(y + (t >> 1), 0, H - 1), tx = clampi(x + (t & 1), 0, W - 1);
      s[t][0] = __fmul_rn(0.5f, __fsub_rn(dt(ty, tx - 1), dt(ty, tx + 1)));
      s[t][1] = __fmul_rn(0.5f, __fsub_rn(dt(ty - 1, tx), dt(ty + 1, tx)));
      s[t][2] = dt(ty, tx);
    }
    structs[px * 3 + 0] = s[0][0];
    structs[px * 3 + 1] = s[0][1];
    structs[px * 3 + 2] = s[0][2];
    if (width == 4) {
      if (bf16) {
        reinterpret_cast<uint2*>(quad)[px] =
            make_uint2(bf16_bits(s[0][2]) | (bf16_bits(s[1][2]) << 16),
                       bf16_bits(s[2][2]) | (bf16_bits(s[3][2]) << 16));
      } else {
        reinterpret_cast<float4*>(quad)[px] = make_float4(s[0][2], s[1][2], s[2][2], s[3][2]);
      }
    } else {
      const float* v = &s[0][0];  // 12 values, tap-major, channel-minor
      if (bf16) {
        uint2* q = reinterpret_cast<uint2*>(quad) + px * 3;
        for (int k = 0; k < 3; ++k)
          q[k] = make_uint2(bf16_bits(v[4 * k]) | (bf16_bits(v[4 * k + 1]) << 16),
                            bf16_bits(v[4 * k + 2]) | (bf16_bits(v[4 * k + 3]) << 16));
      } else {
        float4* q = reinterpret_cast<float4*>(quad) + px * 3;
        for (int k = 0; k < 3; ++k)
          q[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
      }
    }
  }
}

// Shared memory of a band: one g^2 row and the window's dt rows.
static size_t rows_smem_bytes(int W, int band) { return (size_t)(band + 4) * W * sizeof(float); }

// Rows a block owns: about two blocks an SM over the B lanes (132 SMs), 4
// to 16, fewer where the window does not fit a block's shared memory; 0 when
// not even one row does.
static int rows_band(int B, int H, int W) {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return -1;
  int band = min(max((int)(((long long)H * B) / 264), 4), 16);
  while (band > 1 && rows_smem_bytes(W, band) > (size_t)limit) --band;
  return rows_smem_bytes(W, band) <= (size_t)limit ? band : 0;
}

// ---------------------------------------------------------------------------
// 3. revo_edge_cloud: ops/backproject.py backproject_edges_ref.  A pixel is
// valid where edges & isfinite(depth) & depth_min < depth < depth_max; its
// position pos is its rank among the valid pixels in row-major order; with
// count of them and capacity P, slot = pos, or floor(f32(pos) * f32(P /
// count)) when count > P (a uniform stride decimation), and the highest pos
// of a slot wins it (the plain version's scatter with max).  Since slot is
// monotone in pos, pos wins where slot(pos + 1) != slot(pos) or pos = count
// - 1: no atomics.  A slot nobody wins holds zeros: those from count on
// (count <= P), spread over the lane's blocks; and when count > P the gaps
// the float rounding leaves between two slots, and the slots after the last
// one, each filled by the pixel after the gap.
//
// Two kernels in one call: tile counts, then each block sums the counts of
// the tiles before its own, scans its tile and writes its winners.
constexpr int CLOUD_THREADS = 256;
constexpr int CLOUD_PER_THREAD = 16;
constexpr int CLOUD_TILE = CLOUD_THREADS * CLOUD_PER_THREAD;

struct CloudArgs {
  float inv_fx, inv_fy, cx, cy, dmin, dmax;
};

__device__ __forceinline__ bool valid_px(const uint8_t* e, const float* d, size_t p,
                                         const CloudArgs& a) {
  if (!e[p]) return false;
  const float z = d[p];
  return isfinite(z) && z > a.dmin && z < a.dmax;
}

// Valid pixels among a thread's CLOUD_PER_THREAD consecutive ones, as bits.
__device__ __forceinline__ uint32_t thread_bits(const uint8_t* e, const float* d, int n,
                                                int tile, const CloudArgs& a) {
  const int p0 = tile * CLOUD_TILE + threadIdx.x * CLOUD_PER_THREAD;
  uint32_t bits = 0;
  for (int k = 0; k < CLOUD_PER_THREAD; ++k)
    if (p0 + k < n && valid_px(e, d, p0 + k, a)) bits |= 1u << k;
  return bits;
}

// Block-wide sum of v (every thread gets it); red holds 32 ints.
__device__ __forceinline__ int block_sum(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int s = 0;
  for (int w = 0; w < CLOUD_THREADS / 32; ++w) s += red[w];
  return s;
}

__global__ void __launch_bounds__(CLOUD_THREADS)
cloud_count_kernel(const uint8_t* __restrict__ edges, const float* __restrict__ depth,
                   int* __restrict__ tile_counts, int n, CloudArgs a) {
  __shared__ int red[32];
  const size_t lane = (size_t)blockIdx.y * n;
  const int c = __popc(thread_bits(edges + lane, depth + lane, n, blockIdx.x, a));
  const int total = block_sum(c, red);
  if (threadIdx.x == 0) tile_counts[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = total;
}

__device__ __forceinline__ int slot_of(int pos, bool over, float scale) {
  return over ? (int)floorf(__fmul_rn((float)pos, scale)) : pos;
}

__device__ __forceinline__ void zero_slot(float* pts, uint8_t* valid, int j) {
  pts[(size_t)j * 3 + 0] = 0.0f;
  pts[(size_t)j * 3 + 1] = 0.0f;
  pts[(size_t)j * 3 + 2] = 0.0f;
  valid[j] = 0;
}

__global__ void __launch_bounds__(CLOUD_THREADS)
cloud_scatter_kernel(const uint8_t* __restrict__ edges, const float* __restrict__ depth,
                     const int* __restrict__ tile_counts, float* __restrict__ points,
                     uint8_t* __restrict__ valid, int* __restrict__ count_out, int W, int n,
                     int cap, CloudArgs a) {
  __shared__ int red[32];
  __shared__ int warp_sums[CLOUD_THREADS / 32];
  const int b = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
  const int* counts = tile_counts + (size_t)b * tiles;
  int before = 0, all = 0;
  for (int t = threadIdx.x; t < tiles; t += CLOUD_THREADS) {
    const int c = counts[t];
    all += c;
    if (t < tile) before += c;
  }
  before = block_sum(before, red);
  const int count = block_sum(all, red);
  const bool over = count > cap;
  const float scale = __fdiv_rn((float)cap, (float)max(count, cap));
  float* pts = points + (size_t)b * cap * 3;
  uint8_t* val = valid + (size_t)b * cap;
  if (tile == 0 && threadIdx.x == 0) count_out[b] = count;
  if (!over)  // the slots from count on hold zeros, spread over the lane's blocks
    for (int j = count + tile * CLOUD_THREADS + threadIdx.x; j < cap;
         j += tiles * CLOUD_THREADS)
      zero_slot(pts, val, j);
  // Exclusive scan of the threads' valid counts within the block.
  const size_t lane = (size_t)b * n;
  const uint32_t bits = thread_bits(edges + lane, depth + lane, n, tile, a);
  const int c = __popc(bits);
  int incl = c;
  const int wid = threadIdx.x / 32, ln = threadIdx.x % 32;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (ln >= o) incl += v;
  }
  if (ln == 31) warp_sums[wid] = incl;
  __syncthreads();
  int base = before + incl - c;
  for (int w = 0; w < wid; ++w) base += warp_sums[w];
  const int p0 = tile * CLOUD_TILE + threadIdx.x * CLOUD_PER_THREAD;
  for (int k = 0, pos = base; k < CLOUD_PER_THREAD; ++k) {
    if (!(bits >> k & 1u)) continue;
    const int p = p0 + k;
    const int s = slot_of(pos, over, scale);
    bool win = true;
    if (over) {
      win = s < cap && (pos == count - 1 || slot_of(pos + 1, over, scale) != s);
      const int prev = pos > 0 ? slot_of(pos - 1, over, scale) : -1;
      for (int j = prev + 1; j < min(s, cap); ++j) zero_slot(pts, val, j);  // a gap
      if (pos == count - 1)
        for (int j = s + 1; j < cap; ++j) zero_slot(pts, val, j);  // after the last slot
    }
    if (win) {
      const float z = depth[lane + p];
      const float xx = (float)(p % W), yy = (float)(p / W);
      pts[(size_t)s * 3 + 0] = __fmul_rn(__fmul_rn(z, __fsub_rn(xx, a.cx)), a.inv_fx);
      pts[(size_t)s * 3 + 1] = __fmul_rn(__fmul_rn(z, __fsub_rn(yy, a.cy)), a.inv_fy);
      pts[(size_t)s * 3 + 2] = z;
      val[s] = 1;
    }
    ++pos;
  }
}

// ---------------------------------------------------------------------------
// 4. revo_pyr_level: level l -> level l + 1 of gray and depth in one pass:
// ops/filters.py pyr_level_ref.  The gray: cv::pyrDown's 5-tap [1 4 6 4 1] /
// 16 blur with REFLECT_101 borders at even coordinates, the taps summed as
// the plain version sums them (each source row along x, then the rows along
// y), rounded half to even (rintf); ((H+1)/2, (W+1)/2).  The depth: the mean
// of the > 0 pixels of each 2x2 block, (tl + bl) + (tr + br) over the
// count, 0 where none is; (H/2, W/2), odd sizes drop the last row / column.
// Gray may be uint8 or float32, depth uint16 (times inv_scale, as the
// front end converts raw depth) or float32 metres.
constexpr int PYR_THREADS = 256;

__device__ __forceinline__ int reflect101(int j, int n) {
  return j < 0 ? -j : (j > n - 1 ? 2 * (n - 1) - j : j);
}

template <typename G>
__device__ __forceinline__ float gray_at(const G* g, size_t i) { return (float)g[i]; }

template <typename D>
__device__ __forceinline__ float depth_at(const D* d, size_t i, float inv_scale);
template <>
__device__ __forceinline__ float depth_at<float>(const float* d, size_t i, float) { return d[i]; }
template <>
__device__ __forceinline__ float depth_at<uint16_t>(const uint16_t* d, size_t i, float inv_scale) {
  return __fmul_rn((float)d[i], inv_scale);
}

template <typename G, typename D>
__global__ void __launch_bounds__(PYR_THREADS)
pyr_level_kernel(const G* __restrict__ gray, const D* __restrict__ depth, float inv_scale,
                 float* __restrict__ gray_out, float* __restrict__ depth_out, int H, int W) {
  const float k[5] = {1.0f / 16.0f, 4.0f / 16.0f, 6.0f / 16.0f, 4.0f / 16.0f, 1.0f / 16.0f};
  const int ho = (H + 1) / 2, wo = (W + 1) / 2, hd = H / 2, wd = W / 2;
  const int b = blockIdx.y;
  const int i = (blockIdx.x * PYR_THREADS + threadIdx.x) / wo;
  const int j = (blockIdx.x * PYR_THREADS + threadIdx.x) % wo;
  if (i >= ho) return;
  const size_t lane = (size_t)b * H * W;
  float acc = 0.0f;
  for (int t = 0; t < 5; ++t) {
    const size_t row = lane + (size_t)reflect101(2 * i + t - 2, H) * W;
    float r = __fmul_rn(gray_at(gray, row + reflect101(2 * j - 2, W)), k[0]);
    for (int u = 1; u < 5; ++u)
      r = __fadd_rn(r, __fmul_rn(gray_at(gray, row + reflect101(2 * j + u - 2, W)), k[u]));
    const float term = __fmul_rn(r, k[t]);
    acc = t == 0 ? term : __fadd_rn(acc, term);
  }
  gray_out[((size_t)b * ho + i) * wo + j] = rintf(acc);
  if (i < hd && j < wd) {
    const size_t top = lane + (size_t)(2 * i) * W + 2 * j, bot = top + W;
    const float tl = depth_at(depth, top, inv_scale), tr = depth_at(depth, top + 1, inv_scale);
    const float bl = depth_at(depth, bot, inv_scale), br = depth_at(depth, bot + 1, inv_scale);
    auto v = [](float x) { return x > 0.0f ? x : 0.0f; };
    auto c = [](float x) { return x > 0.0f ? 1.0f : 0.0f; };
    const float total = __fadd_rn(__fadd_rn(v(tl), v(bl)), __fadd_rn(v(tr), v(br)));
    const float cnt = __fadd_rn(__fadd_rn(c(tl), c(bl)), __fadd_rn(c(tr), c(br)));
    depth_out[((size_t)b * hd + i) * wd + j] = cnt > 0.0f ? __fdiv_rn(total, fmaxf(cnt, 1.0f)) : 0.0f;
  }
}

template <typename G, typename D>
static int launch_pyr(const void* gray, const void* depth, float inv_scale, float* gray_out,
                      float* depth_out, int B, int H, int W, cudaStream_t stream) {
  const long long outs = (long long)((H + 1) / 2) * ((W + 1) / 2);
  const dim3 grid((unsigned)((outs + PYR_THREADS - 1) / PYR_THREADS), B);
  pyr_level_kernel<G, D><<<grid, PYR_THREADS, 0, stream>>>(
      static_cast<const G*>(gray), static_cast<const D*>(depth), inv_scale, gray_out, depth_out,
      H, W);
  return (int)cudaGetLastError();
}

}  // namespace fe

extern "C" int revo_edt_columns(const uint8_t* edges, float* g2, int B, int H, int W,
                                cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + fe::EDT_COLS - 1) / fe::EDT_COLS, B);
  fe::edt_columns_kernel<<<grid, fe::EDT_COLS * fe::EDT_SEGMENTS, 0, stream>>>(edges, g2, H, W);
  return (int)cudaGetLastError();
}

extern "C" int revo_keyframe_rows(const float* g2, float* structs, void* quad, int B, int H, int W,
                                  int width, int bf16, cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || (width != 4 && width != 12)) return (int)cudaErrorInvalidValue;
  const int band = fe::rows_band(B, H, W);
  if (band <= 0) {
    cudaGetLastError();
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = fe::rows_smem_bytes(W, band);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fe::keyframe_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  const dim3 grid((H + band - 1) / band, B);
  fe::keyframe_rows_kernel<<<grid, fe::ROWS_THREADS, smem, stream>>>(g2, structs, quad, H, W,
                                                                     width, bf16, band);
  return (int)cudaGetLastError();
}

// tile_counts: B * ceil(H * W / CLOUD_TILE) ints of scratch.
extern "C" int revo_edge_cloud(const uint8_t* edges, const float* depth, int* tile_counts,
                               float* points, uint8_t* valid, int* count, int B, int H, int W,
                               float inv_fx, float inv_fy, float cx, float cy, float dmin,
                               float dmax, int cap, cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || cap < 1) return (int)cudaErrorInvalidValue;
  const int n = H * W;
  const fe::CloudArgs a{inv_fx, inv_fy, cx, cy, dmin, dmax};
  const dim3 grid((n + fe::CLOUD_TILE - 1) / fe::CLOUD_TILE, B);
  fe::cloud_count_kernel<<<grid, fe::CLOUD_THREADS, 0, stream>>>(edges, depth, tile_counts, n, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fe::cloud_scatter_kernel<<<grid, fe::CLOUD_THREADS, 0, stream>>>(
      edges, depth, tile_counts, points, valid, count, W, n, cap, a);
  return (int)cudaGetLastError();
}

extern "C" int revo_pyr_level(const void* gray, int gray_u8, const void* depth, int depth_u16,
                              float inv_scale, float* gray_out, float* depth_out, int B, int H,
                              int W, cudaStream_t stream) {
  if (B < 1 || H < 3 || W < 3) return (int)cudaErrorInvalidValue;
  if (gray_u8)
    return depth_u16 ? fe::launch_pyr<uint8_t, uint16_t>(gray, depth, inv_scale, gray_out,
                                                         depth_out, B, H, W, stream)
                     : fe::launch_pyr<uint8_t, float>(gray, depth, inv_scale, gray_out,
                                                      depth_out, B, H, W, stream);
  return depth_u16 ? fe::launch_pyr<float, uint16_t>(gray, depth, inv_scale, gray_out, depth_out,
                                                     B, H, W, stream)
                   : fe::launch_pyr<float, float>(gray, depth, inv_scale, gray_out, depth_out,
                                                  B, H, W, stream);
}
