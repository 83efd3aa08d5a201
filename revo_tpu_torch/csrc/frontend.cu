// The front end's and the keyframe's hand kernels: the exact EDT with the
// structure and quad table (revo_edt_columns_levels + revo_keyframe_rows),
// the edge cloud (revo_edge_cloud), the edge histogram and fill-in of every
// level (revo_fill_levels) and the pyramid (revo_pyramid).
//
// None of them replaces a pl.pallas_call: they are the device form of the
// two other jitted programs of the main path, revo_tpu/frontend.py's
// build_frame (:47-48, an XLA program) and make_keyframe (:219-228), whose
// EDT band loop is a device lax.while_loop (revo_tpu/ops/edt.py:99-137).
// The port ran both as eager torch ops: ~1,000-1,500 small launches and 3
// host reads (the band radius) a keyframe, ~306 launches a frame.  Each
// kernel here takes B lanes in one launch and is bit-equal to its plain
// version (ops/edt.py edt_columns_ref and keyframe_rows_ref,
// ops/backproject.py backproject_edges_ref, ops/edge_hist.py
// fill_in_levels_ref, ops/filters.py pyramid_ref);
// every product and sum is written with __f*_rn, because NVCC_FLAGS let nvcc
// contract a * b + c into an FMA.
//
// Bounds (bytes over 3.35 TB/s; the integer work is small): the EDT pair
// reads the edges once and writes the structure and the quad table (640x480,
// dt4bf: 0.31 + 3.69 + 2.46 MB, ~1.9 us); the cloud reads edges and depth
// (1.5 MB) and writes the points; the fill-in reads levels 1-2 and the
// parents' odd rows and writes levels 1-2 (~0.4 MB); the pyramid reads level
// 0 and writes the others.  All five are latency- and launch-bound at these
// sizes: the design keeps each a single launch with no host read, so a
// keyframe of 3 levels is 4 launches (the column pass of every level in one)
// and a frame's pyramid and fill-in 1 each.  The column pass, the cloud,
// the fill-in and the row pass run thread-block clusters: their blocks trade
// column ends, counts, bit maps and halo rows over DSMEM, not through global
// memory or a second launch.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace fe {

namespace cg = cooperative_groups;

constexpr float BIG = 1e9f;  // the plain version's sentinel (ops/edt.py _BIG)

// The split cluster barrier: arrive (relaxed: it orders no memory) and wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// 1. revo_edt_columns_levels: g^2 of every pixel of every level of a
// keyframe in one launch, g the vertical distance to the nearest edge of its
// column (BIG where the column has none), g^2 clamped to BIG:
// ops/edt.py edt_columns_ref (the log-doubling min-plus relaxations of
// _column_distances, a TPU form) level by level.
//
// A block takes a strip of EDT_STRIP columns of one (level, lane) and a
// chunk of its rows; the C blocks of a strip form a thread-block cluster,
// chunk k of ceil(H / C) rows in block k.  C is the largest of 8, 4, 2, 1
// whose blocks the card holds at once (edt_cluster: 8 at B = 1 at 640x480,
// 2 at B = 8, 1 from B = 16); the bits do not depend on it.  A block loads
// its chunk's edges once (16-byte loads where W % 16 == 0, bytes elsewhere)
// and packs them into column words in shared memory: word k of a column
// holds 32 rows, one __ballot_sync of the 32 threads that loaded them.
// Each block pushes every column's first edge row of its chunk into the
// shared memory of the blocks above it and the last into those below over
// DSMEM (once the cluster's arrival, made at entry, says every block has
// started); after one cluster barrier each reads the nearest edge above and
// below its chunk locally, and no block reads another's shared memory past
// it, so blocks leave as they finish.  Then a walk down and one up each
// column's words gives the nearest edge before and after each word, and
// each pixel's nearest edge above and below comes from its own word by
// __clz / __ffs, in registers: g^2 is written once, a thread a column and a
// run of EDT_RUN rows (a warp's stores a row are 128 contiguous bytes).  Bounds: the edges read and g^2 written once (640x480, 3 levels:
// 0.40 MB and 1.61 MB, ~0.6 us at 3.35 TB/s); the kernel is latency-bound:
// one round of loads, one cluster barrier, one round of stores.
//
// A chunk of more than EDT_WINDOW rows (lanes of more than C x 1024 rows) is
// walked in windows of EDT_WINDOW rows, its words loaded twice: the first
// pass writes each window's first edge row into the window's first g^2 row
// (as int bits), then the suffix of those (the first edge at or after each
// window), which the second pass reads before it overwrites them.
constexpr int EDT_STRIP = 64;      // columns a block
constexpr int EDT_CHUNKS = 8;      // blocks a cluster at most: a strip's chunks of rows
constexpr int EDT_THREADS = 256;
constexpr int EDT_WORDS = 32;      // column words a window: EDT_WINDOW rows
constexpr int EDT_WINDOW = 32 * EDT_WORDS;
constexpr int EDT_LOADS = 4;       // 16-byte loads a thread keeps in flight
constexpr int EDT_RUN = 16;        // rows a thread writes down a column: a word's half
constexpr int EDT_MAX_LEVELS = 8;  // levels a launch

struct EdtLevels {
  const uint8_t* edges[EDT_MAX_LEVELS];
  float* g2[EDT_MAX_LEVELS];
  int H[EDT_MAX_LEVELS], W[EDT_MAX_LEVELS];
  int first[EDT_MAX_LEVELS + 1];  // each level's first strip (lanes x strips); first[n] all
};

static_assert(EDT_THREADS == 4 * EDT_STRIP, "a block's warps load 2 x 32 rows of 4 x 16 columns");

// The window's rows [wy0, wy1) of columns [x0, x0 + EDT_STRIP) into column
// words: warp w loads 16 columns (w % 4) of 32 rows at a time, each thread one
// row; one ballot a column gives the word.
__device__ __forceinline__ void edt_load(const uint8_t* e, int W, int x0, int wy0, int wy1,
                                         bool vec, uint32_t (*mask)[EDT_STRIP]) {
  const int ln = threadIdx.x & 31, warp = threadIdx.x >> 5, grp = warp & 3;
  const int c = x0 + 16 * grp;
  const int words = (wy1 - wy0 + 31) / 32;
  for (int k0 = warp >> 2; k0 < words; k0 += 2 * EDT_LOADS) {
    uint4 v[EDT_LOADS];
#pragma unroll
    for (int i = 0; i < EDT_LOADS; ++i) {
      const int y = wy0 + 32 * (k0 + 2 * i) + ln;
      v[i] = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + 2 * i >= words || y >= wy1 || c >= W) continue;
      const uint8_t* row = e + (size_t)y * W + c;
      if (vec) {
        v[i] = __ldg(reinterpret_cast<const uint4*>(row));
      } else {
        uint32_t b[4] = {0u, 0u, 0u, 0u};
        for (int j = 0; j < 16 && c + j < W; ++j) b[j >> 2] |= (uint32_t)row[j] << (8 * (j & 3));
        v[i] = make_uint4(b[0], b[1], b[2], b[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < EDT_LOADS; ++i) {
      if (k0 + 2 * i >= words) break;  // warp-uniform
      const uint32_t b[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const uint32_t m = __ballot_sync(0xffffffffu, (b[j >> 2] >> (8 * (j & 3))) & 0xffu);
        if (ln == j) mask[k0 + 2 * i][16 * grp + j] = m;
      }
    }
  }
}

__global__ void __launch_bounds__(EDT_THREADS)
edt_levels_kernel(EdtLevels lv) {
  __shared__ uint32_t mask[EDT_WORDS][EDT_STRIP];  // column words of the window
  __shared__ int prev_e[EDT_WORDS][EDT_STRIP];     // the last edge row before each word, or -1
  __shared__ int next_e[EDT_WORDS][EDT_STRIP];     // the first edge row after each word, or -1
  // Each block's chunk ends, pushed over DSMEM: the first edge rows of the
  // blocks below this one, the last of those above (-1: none).
  __shared__ int ends_first[EDT_CHUNKS][EDT_STRIP], ends_last[EDT_CHUNKS][EDT_STRIP];
  cluster_arrive_relaxed();  // this block has started
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  const int strip = blockIdx.x / C;
  int l = 0;
  while (strip >= lv.first[l + 1]) ++l;
  const int H = lv.H[l], W = lv.W[l], strips = (W + EDT_STRIP - 1) / EDT_STRIP;
  const int b = (strip - lv.first[l]) / strips, x0 = (strip - lv.first[l]) % strips * EDT_STRIP;
  const uint8_t* e = lv.edges[l] + (size_t)b * H * W;
  float* g2 = lv.g2[l] + (size_t)b * H * W;
  int* slots = reinterpret_cast<int*>(g2);  // a window's first edge row, in its first row
  const bool vec_in = W % 16 == 0 && (reinterpret_cast<uintptr_t>(lv.edges[l]) & 15) == 0;
  const int rows = (H + C - 1) / C;
  const int y0 = min(rank * rows, H), y1 = min(y0 + rows, H);
  const int nwin = (y1 - y0 + EDT_WINDOW - 1) / EDT_WINDOW;
  const int t = threadIdx.x, c = t & (EDT_STRIP - 1), x = x0 + c;
  const bool up = t < EDT_STRIP, down = t >= EDT_STRIP && t < 2 * EDT_STRIP;  // column walkers
  // -- the columns' loads and chunk ends
  int chunk_end = -1;  // up: the chunk's first edge row; down: its last
  for (int w = 0; w < nwin; ++w) {
    const int wy0 = y0 + w * EDT_WINDOW, wy1 = min(wy0 + EDT_WINDOW, y1);
    const int words = (wy1 - wy0 + 31) / 32;
    if (w > 0) __syncthreads();  // the last window's words are read
    edt_load(e, W, x0, wy0, wy1, vec_in, mask);
    __syncthreads();
    if (up) {
      int f = -1;
      for (int k = 0; k < words && f < 0; ++k)
        if (mask[k][c]) f = wy0 + 32 * k + __ffs(mask[k][c]) - 1;
      if (nwin > 1 && x < W) slots[(size_t)wy0 * W + x] = f;
      if (chunk_end < 0) chunk_end = f;
    } else if (down) {
      for (int k = words - 1; k >= 0; --k)
        if (mask[k][c]) {
          chunk_end = wy0 + 32 * k + 31 - __clz(mask[k][c]);
          break;
        }
    }
  }
  if (nwin > 1 && up && x < W) {  // each slot: the first edge at or after its window
    int run = -1;
    for (int w = nwin - 1; w >= 0; --w) {
      int* slot = slots + (size_t)(y0 + w * EDT_WINDOW) * W + x;
      if (*slot >= 0) run = *slot;
      *slot = run;
    }
  }
  // -- the columns' ends over DSMEM
  cluster_wait();  // every block of the cluster has started: its shared memory exists
  if (up)  // the chunk's first edges, to the blocks above
    for (int q = 0; q < rank; ++q) *cluster.map_shared_rank(&ends_first[rank][c], q) = chunk_end;
  if (down)  // its last, to the blocks below
    for (int q = rank + 1; q < C; ++q) *cluster.map_shared_rank(&ends_last[rank][c], q) = chunk_end;
  // -- the columns' cluster barrier
  cluster.sync();  // every block's ends are in the shared memory of those that read them
  int near = -1;  // up: the nearest edge above the chunk; down: below it
  if (up)
    for (int q = 0; q < rank; ++q) near = ends_last[q][c] >= 0 ? ends_last[q][c] : near;
  if (down)
    for (int q = C - 1; q > rank; --q) near = ends_first[q][c] >= 0 ? ends_first[q][c] : near;
  // -- the columns' walks and stores
  for (int w = 0; w < nwin; ++w) {
    const int wy0 = y0 + w * EDT_WINDOW, wy1 = min(wy0 + EDT_WINDOW, y1);
    const int words = (wy1 - wy0 + 31) / 32;
    if (nwin > 1) {
      __syncthreads();  // the last window's words and walks are read
      edt_load(e, W, x0, wy0, wy1, vec_in, mask);
      __syncthreads();
    }
    if (up) {  // near: the last edge above the word, carried over the windows
      for (int k = 0; k < words; ++k) {
        prev_e[k][c] = near;
        if (mask[k][c]) near = wy0 + 32 * k + 31 - __clz(mask[k][c]);
      }
    } else if (down) {  // the first edge below the window, then below each word
      int run = near;
      if (w + 1 < nwin && x < W) {
        const int s = slots[(size_t)(wy0 + EDT_WINDOW) * W + x];
        run = s >= 0 ? s : near;
      }
      for (int k = words - 1; k >= 0; --k) {
        next_e[k][c] = run;
        if (mask[k][c]) run = wy0 + 32 * k + __ffs(mask[k][c]) - 1;
      }
    }
    __syncthreads();
    // A thread a column and a run of EDT_RUN rows (in one word): the edge
    // above carried down the run, the edge below from the word's bits.
    const int runs = (wy1 - wy0 + EDT_RUN - 1) / EDT_RUN;
    for (int i = t; i < runs * EDT_STRIP; i += EDT_THREADS) {
      const int cc = i % EDT_STRIP, r0 = i / EDT_STRIP * EDT_RUN, k = r0 >> 5;
      if (x0 + cc >= W) continue;
      const uint32_t m = mask[k][cc];
      const uint32_t before = m & ((1u << (r0 & 31)) - 1u);  // the word's rows above the run
      int above = before ? wy0 + 32 * k + 31 - __clz(before) : prev_e[k][cc];
      const int below_word = next_e[k][cc];
      float* out = g2 + (size_t)(wy0 + r0) * W + x0 + cc;
      for (int r = r0; r < min(r0 + EDT_RUN, wy1 - wy0); ++r, out += W) {
        const int y = wy0 + r;
        const uint32_t from = m >> (r & 31);  // the word's rows from y down
        if (from & 1u) above = y;
        const int below = from ? y + __ffs(from) - 1 : below_word;
        int d = above < 0 ? -1 : y - above;
        if (below >= 0 && (d < 0 || below - y < d)) d = below - y;
        const float g = (float)d;
        *out = d < 0 ? BIG : fminf(__fmul_rn(g, g), BIG);
      }
    }
  }  // the windows
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
// the same float32 value as the plain version's banded one.  The search
// takes ROWS_GROUP offsets at a time into independent minima and tests the
// stop rule once a group: the offsets past the stop point it adds give
// candidates >= o^2 >= the minimum, so the bits do not change.  A lane with
// no edge is BIG everywhere (a column with an edge is finite in every row),
// so one block-wide flag skips its search.  The search's time is the
// slowest block's: a pixel far from every edge (the frame's empty regions)
// visits ~dt offsets a side.
//
// A block owns a band of rows of one lane; a cluster of up to ROWS_CLUSTER
// blocks owns consecutive bands.  Each block copies its band's g^2 rows and
// the cluster's halo rows (one above it, two below: gy of row y + 1 reads
// dt(y + 2), which the 12-component quad needs) into shared memory at once
// (cp.async, 16-byte chunks where rows are aligned, every copy in flight),
// searches its band, then its slice of columns of each halo row (a thread a
// pixel, no barrier a row), so every block of the cluster does about the
// same work.  After one cluster barrier it copies its window's other dt rows
// over DSMEM: from the block that owns the band, or for a halo row of the
// cluster from every block's slice.  After a second cluster barrier (no
// block reads another's shared memory past it) each block writes the
// structure and the quad table of its band from its own window.  Band and
// cluster follow the lanes and the shape (rows_band); the bits do not
// depend on them.
//
// Shared memory (rows_smem_bytes): the window, band + 3 rows (row y at
// y - y0 + 1: the band's dt, the rows above and below it), whose three
// outer rows hold the cluster's halo g^2 until the first cluster barrier,
// then the window's dt; and the band's g^2 rows, whose room takes the halo
// slices' dt once the band is searched.  A lane has halo rows only where
// its bands take more than one cluster, so of ROWS_CLUSTER blocks.  At band
// 1 that is 5 rows: rows up to 11,622 floats wide fit the card's 227 KB.
constexpr int ROWS_THREADS = 256;
constexpr int ROWS_GROUP = 8;     // offsets a pixel's search takes between two stop tests
constexpr int ROWS_CLUSTER = 8;   // blocks a cluster, at most
constexpr int ROWS_BAND_MIN = 2;  // rows a block: ceil(H B / (ROWS_PER_SM 132)) in
constexpr int ROWS_BAND_MAX = 16; //   [ROWS_BAND_MIN, ROWS_BAND_MAX], fewer where
constexpr int ROWS_PER_SM = 8;    //   the window does not fit a block's shared memory

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// The exact squared EDT at x of one row of g^2 in shared memory: groups of
// ROWS_GROUP offsets from 1 while the group's first offset squared is below
// the best.  An offset u past the row's end reads the end pixel: its
// candidate g^2(end) + u^2 is no better than the end's own, which the same
// or an earlier group sees, so the bits do not change.  A candidate is
// round(min(l, r) + u^2), as min(round(l + u^2), round(r + u^2)) rounds
// (rounding is monotone), with u^2 exact: one fused multiply-add (fma) where
// u < 4096, else __fmul_rn then __fadd_rn (u^2 rounded as (float)(u * u)).
template <bool fma>
__device__ __forceinline__ float row_search(const float* row, int x, int W) {
  float best = row[x];
  const int reach = max(x, W - 1 - x);
  float of = 1.0f;  // o as a float, exact
  for (int o = 1; o <= reach; o += ROWS_GROUP, of += (float)ROWS_GROUP) {
    if (__fmul_rn(of, of) >= best) break;
    float c[ROWS_GROUP];
#pragma unroll
    for (int k = 0; k < ROWS_GROUP; ++k) {
      const float u = __fadd_rn(of, (float)k);
      const float m = fminf(row[max(x - o - k, 0)], row[min(x + o + k, W - 1)]);
      c[k] = fma ? __fmaf_rn(u, u, m) : __fadd_rn(m, __fmul_rn(u, u));
    }
#pragma unroll
    for (int w = ROWS_GROUP / 2; w > 0; w /= 2)  // a tree: log2(ROWS_GROUP) dependent steps
#pragma unroll
      for (int k = 0; k < w; ++k) c[k] = fminf(c[k], c[k + w]);
    best = fminf(best, c[0]);
  }
  return best;
}
static_assert((ROWS_GROUP & (ROWS_GROUP - 1)) == 0, "row_search's tree halves the group");
constexpr int ROWS_FMA_W = 4096;  // rows up to this wide: every offset squared is exact

// dt at x of a row of g^2: its root, searched where the lane has an edge
// (`any`; a lane with none is BIG everywhere).
__device__ __forceinline__ float row_dt(const float* row, int x, int W, bool any) {
  return __fsqrt_rn(!any ? row[x] : W <= ROWS_FMA_W ? row_search<true>(row, x, W)
                                                    : row_search<false>(row, x, W));
}

__device__ __forceinline__ bool below_big(float v) { return v < BIG; }
__device__ __forceinline__ bool below_big(float4 v) {
  return v.x < BIG || v.y < BIG || v.z < BIG || v.w < BIG;
}

__device__ __forceinline__ void cp_async(float4* smem, const float4* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem));
}

// Three segments of g^2 rows, n0, n1, n2 values (multiples of the floats a
// V holds), from global to shared memory by cp.async in chunks of V (float4
// or float), every copy of the thread in flight at once; once they land,
// returns whether any value the thread copied is below BIG.
template <typename V>
__device__ __forceinline__ bool load_rows(const float* s0, float* d0, int n0, const float* s1,
                                          float* d1, int n1, const float* s2, float* d2, int n2) {
  constexpr int F = sizeof(V) / sizeof(float);  // floats a chunk
  const int e0 = n0 / F, e1 = e0 + n1 / F, nv = e1 + n2 / F;
  auto off = [&](int i) { return i < e0 ? i : i < e1 ? i - e0 : i - e1; };  // in its segment
  auto dst = [&](int i) { return reinterpret_cast<V*>(i < e0 ? d0 : i < e1 ? d1 : d2) + off(i); };
  for (int i = threadIdx.x; i < nv; i += ROWS_THREADS)
    cp_async(dst(i), reinterpret_cast<const V*>(i < e0 ? s0 : i < e1 ? s1 : s2) + off(i));
  asm volatile("cp.async.wait_all;\n" ::: "memory");  // this thread's copies are visible to it
  bool finite = false;
  for (int i = threadIdx.x; i < nv; i += ROWS_THREADS) finite |= below_big(*dst(i));
  return finite;
}

__global__ void __launch_bounds__(ROWS_THREADS, 4)
keyframe_rows_kernel(const float* __restrict__ g2, float* __restrict__ structs,
                     void* __restrict__ quad, int H, int W, int width, int bf16, int band) {
  extern __shared__ float4 smem4[];
  float* win = reinterpret_cast<float*>(smem4);  // the window: row y at y - y0 + 1
  float* gown = win + (size_t)(band + 3) * W;     // the band's g^2, then the halo slices' dt
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  const int b = blockIdx.y;
  const int first = blockIdx.x - rank;  // the cluster's first block
  const int y0 = min((int)blockIdx.x * band, H), y1 = min(y0 + band, H);
  const int cy0 = min(first * band, H), cy1 = min((first + C) * band, H);  // the cluster's rows
  const bool live = y0 < y1;
  const int lo = max(y0 - 1, 0), hi = min(y1 + 1, H - 1);  // the window, inclusive
  // The cluster's halo rows (0: cy0 - 1, in window row 0; 1: cy1 and 2: cy1
  // + 1, in window rows band + 1 and band + 2; where they exist), a slice of
  // columns [hx0, hx0 + hw) of each searched here.
  const bool up = cy0 > 0 && cy0 < cy1;
  const int down = cy0 < cy1 ? min(H - cy1, 2) : 0;
  const int xs = (W + C - 1) / C, hx0 = min(rank * xs, W), hw = min(hx0 + xs, W) - hx0;
  // -- the rows' loads
  const float* lane_g2 = g2 + (size_t)b * H * W;
  const bool vec = W % 4 == 0 && (reinterpret_cast<uintptr_t>(g2) & 15) == 0;
  const int n_own = (y1 - y0) * W;
  const float *s0 = lane_g2 + (size_t)y0 * W, *s1 = lane_g2 + (size_t)(up ? cy0 - 1 : 0) * W,
              *s2 = lane_g2 + (size_t)(down ? cy1 : 0) * W;
  float *d0 = gown, *d1 = win, *d2 = win + (size_t)(band + 1) * W;
  const bool finite = vec ? load_rows<float4>(s0, d0, n_own, s1, d1, up ? W : 0, s2, d2, down * W)
                          : load_rows<float>(s0, d0, n_own, s1, d1, up ? W : 0, s2, d2, down * W);
  const bool any = __syncthreads_or(finite);
  // -- the rows' search
  for (int i = threadIdx.x; i < n_own; i += ROWS_THREADS) {
    const int r = i / W, x = i - r * W;
    win[(size_t)(r + 1) * W + x] = row_dt(gown + (size_t)r * W, x, W, any);
  }
  if ((up || down) && hw > 0) {
    __syncthreads();  // the band's g^2 is read: its room takes the slices
    for (int i = threadIdx.x; i < 3 * hw; i += ROWS_THREADS) {
      const int h = i / hw, x = hx0 + i - h * hw;  // halo row h
      if (h == 0 ? !up : h > down) continue;
      gown[(size_t)h * xs + x - hx0] = row_dt(win + (size_t)(h == 0 ? 0 : band + h) * W, x, W, any);
    }
  }
  // -- the rows' halo over DSMEM
  cluster.sync();  // every block's dt rows and slices are in its shared memory
  if (live)
    for (int r = lo; r <= hi; ++r) {
      if (r >= y0 && r < y1) continue;
      float* dst = win + (size_t)(r - y0 + 1) * W;
      if (r >= cy0 && r < cy1) {  // a band of this cluster
        const int owner = r / band;
        const float* src = cluster.map_shared_rank(win, owner - first) +
                           (size_t)(r - owner * band + 1) * W;
        for (int x = threadIdx.x; x < W; x += ROWS_THREADS) dst[x] = src[x];
      } else {  // a halo row of the cluster, from every block's slice
        const int h = r < cy0 ? 0 : 1 + (r - cy1);
        for (int x = threadIdx.x; x < W; x += ROWS_THREADS) {
          const int k = x / xs;
          dst[x] = cluster.map_shared_rank(gown, k)[(size_t)h * xs + x - k * xs];
        }
      }
    }
  cluster.sync();  // no block reads another's shared memory past here
  // -- the rows' tables
  if (!live) return;
  auto dt = [&](int y, int x) {
    return win[(size_t)(clampi(y, 0, H - 1) - y0 + 1) * W + clampi(x, 0, W - 1)];
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

// Shared memory of a band (floats): the window, band + 3 rows, and the
// larger of the band's g^2 rows and the 3 halo slices of a cluster of
// ROWS_CLUSTER blocks.
static size_t rows_smem_bytes(int W, int band) {
  const size_t slices = 3 * (size_t)((W + ROWS_CLUSTER - 1) / ROWS_CLUSTER);
  return ((size_t)(band + 3) * W + std::max((size_t)band * W, slices)) * sizeof(float);
}

// ---------------------------------------------------------------------------
// 3. revo_edge_cloud: ops/backproject.py backproject_edges_ref.  A pixel is
// valid where edges & isfinite(depth) & depth_min < depth < depth_max; its
// position pos is its rank among the valid pixels in row-major order; with
// count of them and capacity P, slot = pos, or floor(f32(pos) * f32(P /
// count)) when count > P (a uniform stride decimation), and the highest pos
// of a slot wins it (the plain version's scatter with max).  A slot nobody
// wins holds zeros: those from count on (count <= P), and when count > P the
// gaps the float rounding leaves and the slots after the last one.
//
// One launch, a thread-block cluster a lane (C blocks, from the lanes and
// the shape: cloud_cluster).  Block k takes the k-th of C contiguous ranges
// of the lane's pixels in steps of CLOUD_STEP; each warp of the block takes
// a contiguous run of the range's steps, and a lane 4 pixels of a step (one
// 4-byte load of edges, then one 16-byte load of depth where one of the 4
// is an edge: a warp's loads are coalesced, and the depth under no edge,
// most of it, is not read; byte loads where the lane is not 16-byte aligned
// or its end cuts the step).  Its time grows with the pixels a block takes,
// so the cluster is as large as the lanes let the card hold (16 blocks at
// most).  A round, each lane loads up to
// CLOUD_STEPS steps with every load in flight, the warp scans the steps'
// counts (one scan, packed), the block scans the warps' totals (one
// barrier a round), and
// each valid pixel's (index, depth) goes to its rank in the block in a list
// in shared memory: nothing goes to global memory and nothing is read
// twice.  Each block then writes its count into every block's shared memory
// over DSMEM, once the cluster's arrival (made at the kernel's start, so it
// costs nothing in the wait) says every block has started; after one cluster
// barrier each reads the C counts locally: the valid pixels before it and
// the lane's count (no DSMEM read, so no block waits for the others to
// leave).
//
// Writing: slot is monotone in pos, so the slots j whose last position
// top(j) (the highest pos with slot(pos) <= j) lies in the block form one
// range, [slot(first pos), slot(next block's first pos) - 1] (the last
// block's up to slot(count - 1)).  A thread a slot writes it, consecutive
// threads consecutive slots: the point of top(j) from the list where
// slot(top(j)) == j, else zeros (a gap of the rounding: none occurs below
// 2^24 positions, the rule is a guard).  The slots after the lane's last
// one are zeros, spread evenly over the cluster's blocks.  Every slot is
// written by exactly one thread, with no atomics.  A block with more valid
// pixels than the list holds walks its range again for each further
// CLOUD_LIST ranks (a lane of mostly edges at 1280x720): slower, the same
// bits.
constexpr int CLOUD_THREADS = 1024;
constexpr int CLOUD_WARPS = CLOUD_THREADS / 32;
constexpr int CLOUD_STEP = 128;          // pixels a warp a step: 4 a lane
constexpr int CLOUD_STEPS = 6;           // steps a lane keeps in flight a round (<= 8)
constexpr int CLOUD_LIST = 24576;        // (index, depth) pairs a block keeps: 192 KB
constexpr int CLOUD_CLUSTER_MAX = 16;    // blocks a cluster, at most (non-portable above 8)
constexpr int CLOUD_MIN_STEPS = 64;      // steps a block takes at least where C > 1

static_assert(CLOUD_STEPS <= 8, "a round's step counts are packed in two words");

struct CloudArgs {
  float inv_fx, inv_fy, cx, cy, dmin, dmax;
};

// The edge bytes of the 4 pixels from q (a multiple of 4 below n) of a lane.
__device__ __forceinline__ uint32_t load_edges(const uint8_t* e, int q, int n, bool vec) {
  if (vec && q + 4 <= n) return __ldg(reinterpret_cast<const uint32_t*>(e + q));
  uint32_t e4 = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (q + i < n) e4 |= (uint32_t)e[q + i] << (8 * i);
  return e4;
}

// Their depths, read only where an edge byte is set (0 elsewhere).
__device__ __forceinline__ float4 load_depth(const float* d, uint32_t e4, int q, int n, bool vec) {
  float4 d4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (!e4) return d4;
  if (vec && q + 4 <= n) return __ldg(reinterpret_cast<const float4*>(d + q));
  if (e4 & 0xffu) d4.x = d[q];
  if (e4 & 0xff00u) d4.y = d[q + 1];
  if (e4 & 0xff0000u) d4.z = d[q + 2];
  if (e4 & 0xff000000u) d4.w = d[q + 3];
  return d4;
}

__device__ __forceinline__ float depth_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Bit i: byte i of w is not 0 (the high bit of each byte, gathered by one
// product whose partial terms do not overlap).
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  const uint32_t hi = (((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u;
  return ((hi >> 7) * 0x01020408u) >> 24;
}

// Bit i: pixel i of the 4 is valid (the range test fails NaN and +-inf).
__device__ __forceinline__ uint32_t four_bits(uint32_t e4, const float4& d4, const CloudArgs& a) {
  const uint32_t in = (d4.x > a.dmin && d4.x < a.dmax ? 1u : 0u) |
                      (d4.y > a.dmin && d4.y < a.dmax ? 2u : 0u) |
                      (d4.z > a.dmin && d4.z < a.dmax ? 4u : 0u) |
                      (d4.w > a.dmin && d4.w < a.dmax ? 8u : 0u);
  return nonzero_bytes(e4) & in;
}

template <typename T>
__device__ __forceinline__ T warp_inclusive(T v) {
  const int ln = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T t = __shfl_up_sync(0xffffffffu, v, o);
    if (ln >= o) v += t;
  }
  return v;
}

// The block's walk over steps [s0, s1) of a lane: returns its valid pixels
// and puts the (index, depth) of those of rank r0 .. r0 + len - 1 in list.
// sums: 2 x 32 ints, a round's warp totals by the round's parity.
__device__ int cloud_walk(const uint8_t* e, const float* d, int n, bool vec, int s0, int s1,
                          int r0, int len, int2* list, int* sums, const CloudArgs& a) {
  const int ln = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int running = 0, round = 0;
  for (int rs = s0; rs < s1; rs += CLOUD_WARPS * CLOUD_STEPS, ++round) {
    const int re = min(rs + CLOUD_WARPS * CLOUD_STEPS, s1);
    const int per = (re - rs + CLOUD_WARPS - 1) / CLOUD_WARPS;  // steps a warp this round
    const int w0 = min(rs + warp * per, re), w1 = min(w0 + per, re);
    uint32_t e4[CLOUD_STEPS];  // the edges of every step first, then the depth under edges
    float4 d4[CLOUD_STEPS];
#pragma unroll
    for (int k = 0; k < CLOUD_STEPS; ++k)
      e4[k] = w0 + k < w1 ? load_edges(e, (w0 + k) * CLOUD_STEP + 4 * ln, n, vec) : 0u;
#pragma unroll
    for (int k = 0; k < CLOUD_STEPS; ++k)
      d4[k] = load_depth(d, e4[k], (w0 + k) * CLOUD_STEP + 4 * ln, n, vec);
    // Each step's count in an 8-bit field (at most 32 x 4 = 128 a warp), so
    // one scan of two words serves every step.
    uint32_t bits[CLOUD_STEPS], packed[2] = {0u, 0u};
#pragma unroll
    for (int k = 0; k < CLOUD_STEPS; ++k) {
      bits[k] = four_bits(e4[k], d4[k], a);
      packed[k / 4] += (uint32_t)__popc(bits[k]) << (8 * (k % 4));
    }
    uint32_t incl[2], whole[2];
#pragma unroll
    for (int h = 0; h < (CLOUD_STEPS + 3) / 4; ++h) {
      incl[h] = warp_inclusive(packed[h]);
      whole[h] = __shfl_sync(0xffffffffu, incl[h], 31);
    }
    int before[CLOUD_STEPS];  // the warp's valid pixels before this lane's in step k
    int total = 0;
#pragma unroll
    for (int k = 0; k < CLOUD_STEPS; ++k) {
      before[k] = total + (int)((incl[k / 4] - packed[k / 4]) >> (8 * (k % 4)) & 0xffu);
      total += (int)(whole[k / 4] >> (8 * (k % 4)) & 0xffu);
    }
    int* ws = sums + 32 * (round & 1);
    if (ln == 31) ws[warp] = total;
    __syncthreads();
    const int v = ln < CLOUD_WARPS ? ws[ln] : 0;  // each warp scans the warps' totals
    const int vincl = warp_inclusive(v);
    const int base = running + __shfl_sync(0xffffffffu, vincl - v, warp) - r0;
#pragma unroll
    for (int k = 0; k < CLOUD_STEPS; ++k) {
      const uint32_t m = bits[k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (m >> i & 1u) {
          const uint32_t r = base + before[k] + __popc(m & ((1u << i) - 1u));
          if (r < (uint32_t)len)
            list[r] = make_int2((w0 + k) * CLOUD_STEP + 4 * ln + i, __float_as_int(depth_of(d4[k], i)));
        }
    }
    running += __shfl_sync(0xffffffffu, vincl, 31);
  }
  return running;
}

__device__ __forceinline__ int slot_of(int pos, bool over, float scale) {
  return over ? (int)floorf(__fmul_rn((float)pos, scale)) : pos;
}

// The highest pos < count with slot(pos) <= j, when count > P.
__device__ __forceinline__ int top_of(int j, int count, float scale) {
  int q = (int)fmin((double)(count - 1), floor(((double)j + 1.0) / (double)scale));
  while (q + 1 < count && slot_of(q + 1, true, scale) <= j) ++q;
  while (q > 0 && slot_of(q, true, scale) > j) --q;
  return q;
}

__device__ __forceinline__ void zero_slot(float* pts, uint8_t* valid, int j) {
  pts[(size_t)j * 3 + 0] = 0.0f;
  pts[(size_t)j * 3 + 1] = 0.0f;
  pts[(size_t)j * 3 + 2] = 0.0f;
  valid[j] = 0;
}

__global__ void __launch_bounds__(CLOUD_THREADS, 1)
edge_cloud_kernel(const uint8_t* __restrict__ edges, const float* __restrict__ depth,
                  float* __restrict__ points, uint8_t* __restrict__ valid,
                  int* __restrict__ count_out, int W, int n, int cap, int len, CloudArgs a) {
  extern __shared__ int2 list[];  // len (index, depth) pairs
  __shared__ int sums[2 * 32];
  __shared__ int s_counts[CLOUD_CLUSTER_MAX];  // every block's count, pushed over DSMEM
  cluster_arrive_relaxed();  // this block has started
  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  const int b = blockIdx.y;
  const uint8_t* e = edges + (size_t)b * n;
  const float* d = depth + (size_t)b * n;
  const bool vec = ((reinterpret_cast<uintptr_t>(e) | reinterpret_cast<uintptr_t>(d)) & 15) == 0;
  const int steps = (n + CLOUD_STEP - 1) / CLOUD_STEP, per = (steps + C - 1) / C;
  const int s0 = min(k * per, steps), s1 = min(s0 + per, steps);
  // -- the cloud's loads, bits, scan and list
  const int mine = cloud_walk(e, d, n, vec, s0, s1, 0, len, list, sums, a);
  // -- the cloud's cluster barrier
  cluster_wait();  // every block of the cluster has started: its shared memory exists
  if ((int)threadIdx.x < C) cluster.map_shared_rank(s_counts, (int)threadIdx.x)[k] = mine;
  cluster.sync();  // every block's count is in every block's shared memory
  // -- the cloud's counts
  const int ln = threadIdx.x & 31;
  const int theirs = ln < C ? s_counts[ln] : 0;
  const int incl = warp_inclusive(theirs);  // every warp scans the C counts itself
  const int count = __shfl_sync(0xffffffffu, incl, 31);
  const int before = __shfl_sync(0xffffffffu, incl - theirs, k);
  if (k == 0 && threadIdx.x == 0) count_out[b] = count;
  const bool over = count > cap;
  const float scale = __fdiv_rn((float)cap, (float)max(count, cap));
  float* pts = points + (size_t)b * cap * 3;
  uint8_t* val = valid + (size_t)b * cap;
  // -- the cloud's slots
  for (int r0 = 0; r0 < mine; r0 += len) {
    if (r0 > 0) {  // the list's next window: walk the range again
      __syncthreads();
      cloud_walk(e, d, n, vec, s0, s1, r0, len, list, sums, a);
      __syncthreads();
    }
    const int q0 = before + r0, q1 = before + min(r0 + len, mine);  // positions [q0, q1)
    const int j0 = slot_of(q0, over, scale);
    const int j1 = min(q1 < count ? slot_of(q1, over, scale) - 1 : slot_of(count - 1, over, scale),
                       cap - 1);
    for (int j = j0 + threadIdx.x; j <= j1; j += CLOUD_THREADS) {
      const int q = over ? top_of(j, count, scale) : j;
      if (slot_of(q, over, scale) != j) {
        zero_slot(pts, val, j);
        continue;
      }
      const int2 v = list[q - q0];
      const float z = __int_as_float(v.y);
      const float xx = (float)(v.x % W), yy = (float)(v.x / W);
      pts[(size_t)j * 3 + 0] = __fmul_rn(__fmul_rn(z, __fsub_rn(xx, a.cx)), a.inv_fx);
      pts[(size_t)j * 3 + 1] = __fmul_rn(__fmul_rn(z, __fsub_rn(yy, a.cy)), a.inv_fy);
      pts[(size_t)j * 3 + 2] = z;
      val[j] = 1;
    }
  }
  // -- the cloud's tail
  const int t0 = count == 0 ? 0 : min(slot_of(count - 1, over, scale) + 1, cap);
  const int tper = (cap - t0 + C - 1) / C;
  for (int j = t0 + k * tper + threadIdx.x; j < min(t0 + (k + 1) * tper, cap); j += CLOUD_THREADS)
    zero_slot(pts, val, j);
}

// ---------------------------------------------------------------------------
// 4. revo_fill_levels: the BMVC17 edge histogram and fill-in of levels 1 ..
// n-1 of B lanes in one launch: ops/edge_hist.py fill_in_levels_ref
// (patch_histogram, fill_in_edges and the where on occupancy, level by
// level).  It replaces no pl.pallas_call: it is the fill-in of JAX's jitted
// build_frame (revo_tpu/frontend.py:99-110), which XLA fuses into that
// program; the port ran it as ~75 eager torch kernels a frame, level 0's
// unused histogram among them.  Level l counts Canny's edges of level l over
// whole patch[l] x patch[l] patches (the image truncated to whole patches)
// and takes the float32 share of patches holding an edge, rounded once;
// where that share is below npct, pixel (y, x) also takes parent pixel
// (2y+1, 2x+1) where it lies in the parent and count bin
// (min((2y+1) / patch[l-1], hc-1), min((2x+1) / patch[l-1], wc-1)) is below
// patch[l]^2 * 0.05 in float32.  Level 1's parent is Canny's level 0 (the
// table's entry 0), level l's the filled level l-1, so a lane's levels run
// in order inside the launch.
//
// Bound: bytes.  A lane at 640x480 reads levels 1-2's edges and the
// parents' odd rows and writes levels 1-2 (~0.4 MB; 51 MB at B = 128, ~15 us
// at 3.35 TB/s); the integer work is a few operations a pixel.  One launch,
// a thread-block cluster a lane (C blocks from the lanes and level 1's size:
// fill_cluster, as cloud_cluster picks the cloud's).  A level: block k
// counts the bins of rows [k hc / C, (k+1) hc / C) of the count grid into
// shared memory (the rows of its bins in 16-byte loads, a thread's run of
// one bin added with one shared atomic), in tiles of at most `counts` bins
// (whole bin rows, or 32-bin-aligned pieces of a row wider than a tile);
// a warp a word turns 32 counts into the bits "below the threshold" and
// "nonzero" by ballots, and pushes the word into the bit map of every block
// of the cluster over DSMEM (or stores it once in global memory, where two
// levels' maps do not fit FILL_BITS_SHARED).  Each block pushes its count
// of nonzero bins the same way; after one cluster barrier every block sums
// the C counts, so all take the same decision, and writes rows [k H / C,
// (k+1) H / C) of the level: a copy where the level is not filled, else
// each 16-byte chunk ORed with the parent's odd pixels of its row (two
// 16-byte loads where they line up, bytes elsewhere), looked up in the bit
// map only under a parent edge.  The next level's barrier makes the level's
// bytes visible to the blocks that read them as its parent (through L2:
// __ldcg).  Two bit maps alternate by level, so a block's pushes for level
// l+1 never meet a block still reading level l's.  No per-pixel scratch in
// device memory, no host read; the flags (occupancy < npct) of every lane
// and level go to `flags`.
constexpr int FILL_THREADS = 512;
constexpr int FILL_WARPS = FILL_THREADS / 32;
constexpr int FILL_MAX_LEVELS = 8;          // levels a launch, the parent (entry 0) included
constexpr int FILL_CLUSTER_MAX = 16;        // blocks a cluster, at most (non-portable above 8)
constexpr int FILL_MIN_PIXELS = 4096;       // level-1 pixels a block takes at least where C > 1
constexpr int FILL_COUNTS_MAX = 16384;      // count slots a block keeps at most (64 KB)
constexpr int FILL_BITS_SHARED = 163840;    // bytes of the two bit maps a block keeps at most
constexpr int FILL_UNROLL = 4;              // 16-byte chunks a thread keeps in flight

static_assert(FILL_BITS_SHARED + 4 * FILL_COUNTS_MAX + 4 * (2 * FILL_CLUSTER_MAX + 1) <= 232448,
              "two bit maps, the count slots and the static counts fit an H100 block");
static_assert(FILL_COUNTS_MAX % 32 == 0, "count tiles of part of a bin row are whole words");

struct FillLevels {
  const uint8_t* edges[FILL_MAX_LEVELS];  // Canny's edges of each level; entry 0: the parent
  uint8_t* out[FILL_MAX_LEVELS];          // level l >= 1 after fill-in
  int H[FILL_MAX_LEVELS], W[FILL_MAX_LEVELS], patch[FILL_MAX_LEVELS];
  int hc[FILL_MAX_LEVELS], wc[FILL_MAX_LEVELS];  // whole patches down and across
  float thresh[FILL_MAX_LEVELS];          // patch^2 * 0.05, rounded to float32
  int n;                                  // levels, entry 0 included
  int words;                              // words of a level's bit map, the most over the levels
  int counts;                             // count slots a block keeps (a multiple of 32)
  uint8_t* flags;                         // (B, flag_stride): level l at l - 1
  int flag_stride;
  uint32_t* gbits;                        // null: bit maps in shared memory; else (B, 2, words)
  float npct;
};

// m (< 16) bytes from p, packed as a 16-byte chunk.
__device__ __forceinline__ uint4 fill_bytes(const uint8_t* p, int m) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  for (int j = 0; j < m; ++j) w[j >> 2] |= (uint32_t)p[j] << (8 * (j & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// f(chunk, i, m) for the lane's bytes [i0, i1) of `base`: 16-byte loads of
// the aligned body, FILL_UNROLL of a thread's chunks in flight, consecutive
// threads on consecutive chunks; the unaligned head and tail as one short
// chunk each (threads 0 and 32).
template <class F>
__device__ __forceinline__ void fill_walk(const uint8_t* base, int i0, int i1, F&& f) {
  if (i1 <= i0) return;
  const int head =
      min((int)((16u - ((uint32_t)reinterpret_cast<uintptr_t>(base + i0) & 15u)) & 15u), i1 - i0);
  const int a0 = i0 + head, a1 = a0 + ((i1 - a0) & ~15);
  if (threadIdx.x == 0 && head > 0) f(fill_bytes(base + i0, head), i0, head);
  if (threadIdx.x == 32 && a1 < i1) f(fill_bytes(base + a1, i1 - a1), a1, i1 - a1);
  constexpr int STRIDE = 16 * FILL_THREADS;
  for (int c = a0 + 16 * (int)threadIdx.x; c < a1; c += STRIDE * FILL_UNROLL) {
    uint4 v[FILL_UNROLL];
#pragma unroll
    for (int u = 0; u < FILL_UNROLL; ++u) {
      const int cu = c + STRIDE * u;
      v[u] = cu < a1 ? __ldg(reinterpret_cast<const uint4*>(base + cu)) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < FILL_UNROLL; ++u)
      if (c + STRIDE * u < a1) f(v[u], c + STRIDE * u, 16);
  }
}

// Byte j of a 16-byte chunk.
__device__ __forceinline__ uint32_t chunk_byte(const uint4& v, int j) {
  const uint32_t w = j < 8 ? (j < 4 ? v.x : v.y) : (j < 12 ? v.z : v.w);
  return (w >> (8 * (j & 3))) & 0xffu;
}

__global__ void __launch_bounds__(FILL_THREADS)
fill_levels_kernel(FillLevels f) {
  extern __shared__ uint32_t fill_smem[];     // two bit maps (unless in global memory), the counts
  __shared__ int s_nnz[2][FILL_CLUSTER_MAX];  // every block's nonzero bins, pushed over DSMEM
  __shared__ int s_nz;
  cluster_arrive_relaxed();  // this block has started
  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool gmaps = f.gbits != nullptr;  // the bit maps in global memory
  uint32_t* maps = gmaps ? f.gbits + (size_t)b * 2 * f.words : fill_smem;
  int* counts = reinterpret_cast<int*>(fill_smem + (gmaps ? 0 : 2 * f.words));
  cluster_wait();  // every block of the cluster has started: its shared memory exists
  for (int l = 1; l < f.n; ++l) {
    const int parity = l & 1;
    const int H = f.H[l], W = f.W[l], p = f.patch[l], hc = f.hc[l], wc = f.wc[l];
    const int wcw = (wc + 31) >> 5;
    const float thresh = f.thresh[l];
    const uint8_t* e = f.edges[l] + (size_t)b * H * W;
    uint32_t* bits = maps + parity * f.words;
    if (tid == 0) s_nz = 0;
    // -- the level's counts: block k's bin rows, in tiles
    const int r0 = (int)((long long)hc * k / C), r1 = (int)((long long)hc * (k + 1) / C);
    const int tc = min(wc, f.counts);                              // bins across a tile
    const int tr = tc == wc ? max(f.counts / max(wc, 1), 1) : 1;  // bin rows a tile
    for (int t0 = r0; t0 < r1; t0 += tr) {
      const int t1 = min(t0 + tr, r1);
      for (int c0 = 0; c0 < wc; c0 += tc) {
        const int c1 = min(c0 + tc, wc), xa = c0 * p, xb = c1 * p;
        for (int i = tid; i < (t1 - t0) * tc; i += FILL_THREADS) counts[i] = 0;
        __syncthreads();
        fill_walk(e, t0 * p * W, t1 * p * W, [&](const uint4& v, int i, int m) {
          if ((v.x | v.y | v.z | v.w) == 0u) return;
          int y = i / W, x = i - y * W, slot = -1, run = 0;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            if (j < m && chunk_byte(v, j)) {
              const int s = x >= xa && x < xb ? (y / p - t0) * tc + x / p - c0 : -1;
              if (s != slot) {
                if (run) atomicAdd(&counts[slot], run);
                slot = s;
                run = 0;
              }
              run += s >= 0;
            }
            if (++x == W) {
              x = 0;
              ++y;
            }
          }
          if (run) atomicAdd(&counts[slot], run);
        });
        __syncthreads();
        // a warp a word of the bit map: 32 bins of one bin row
        const int w0 = c0 >> 5, nwr = ((c1 + 31) >> 5) - w0;
        for (int q = warp; q < (t1 - t0) * nwr; q += FILL_WARPS) {
          const int rr = q / nwr, bx = 32 * (w0 + q % nwr) + lane;
          const bool in = bx < c1;
          const int cnt = in ? counts[rr * tc + bx - c0] : 0;
          const uint32_t sparse = __ballot_sync(0xffffffffu, in && (float)cnt < thresh);
          const uint32_t nz = __ballot_sync(0xffffffffu, cnt > 0);
          const int at = (t0 + rr) * wcw + w0 + q % nwr;
          if (lane == 0) atomicAdd(&s_nz, __popc(nz));
          if (gmaps) {
            if (lane == 0) bits[at] = sparse;
          } else if (lane < C) {
            *cluster.map_shared_rank(bits + at, lane) = sparse;
          }
        }
        __syncthreads();  // the counts are the next tile's
      }
    }
    __syncthreads();
    if (tid < C) *cluster.map_shared_rank(&s_nnz[parity][k], tid) = s_nz;
    __threadfence();  // the maps in global memory and level l-1's bytes
    // -- the level's cluster barrier
    cluster.sync();  // every block's count and map words, and level l-1 whole
    int nnz = 0;
    for (int r = 0; r < C; ++r) nnz += s_nnz[parity][r];
    const bool fill = __fdiv_rn((float)nnz, (float)(hc * wc)) < f.npct;  // NaN: no whole patch
    if (k == 0 && tid == 0) f.flags[(size_t)b * f.flag_stride + l - 1] = fill;
    // -- the level's rows
    uint8_t* o = f.out[l] + (size_t)b * H * W;
    const int i0 = (int)((long long)H * k / C) * W, i1 = (int)((long long)H * (k + 1) / C) * W;
    const auto store = [&](const uint4& v, int i, int m) {
      if (m == 16 && (reinterpret_cast<uintptr_t>(o + i) & 15u) == 0) {
        *reinterpret_cast<uint4*>(o + i) = v;
      } else {
        for (int j = 0; j < m; ++j) o[i + j] = (uint8_t)chunk_byte(v, j);
      }
    };
    if (!fill) {
      fill_walk(e, i0, i1, store);
      continue;
    }
    const int PH = f.H[l - 1], PW = f.W[l - 1], pp = f.patch[l - 1];
    const uint8_t* par = (l == 1 ? f.edges[0] : f.out[l - 1]) + (size_t)b * PH * PW;
    fill_walk(e, i0, i1, [&](const uint4& v, int i, int m) {
      int y = i / W, x = i - y * W;
      const uint8_t* prow = par + (size_t)(2 * y + 1) * PW + 2 * x;
      const bool vec = m == 16 && x + 16 <= W && 2 * y + 1 < PH && 2 * x + 32 <= PW &&
                       (reinterpret_cast<uintptr_t>(prow) & 15u) == 0;
      uint4 q0 = make_uint4(0u, 0u, 0u, 0u), q1 = q0;
      if (vec) {
        q0 = __ldcg(reinterpret_cast<const uint4*>(prow));
        q1 = __ldcg(reinterpret_cast<const uint4*>(prow + 16));
      }
      uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (j < m) {
          const int py = 2 * y + 1, px = 2 * x + 1;
          if (py < PH && px < PW) {
            const uint32_t pb = vec ? chunk_byte(j < 8 ? q0 : q1, (2 * j + 1) & 15)
                                    : (uint32_t)__ldcg(par + (size_t)py * PW + px);
            if (pb) {
              const int by = min(py / pp, hc - 1), bx = min(px / pp, wc - 1);
              const uint32_t* word = bits + by * wcw + (bx >> 5);
              const uint32_t m32 = gmaps ? __ldcg(word) : *word;
              if ((m32 >> (bx & 31)) & 1u) w[j >> 2] |= 1u << (8 * (j & 3));
            }
          }
          if (++x == W) {
            x = 0;
            ++y;
          }
        }
      }
      store(make_uint4(w[0], w[1], w[2], w[3]), i, m);
    });
  }
}

// Per device, queried once: the opt-in shared memory of a block and the
// cloud's clusters of 1, 2, 4, 8, 16 blocks the card holds at once.
struct DeviceInfo {
  int ready;
  int smem_optin;
  int cloud_held[5];
  int edt_resident;  // column-pass blocks the card holds at once
  size_t fill_smem;  // the shared memory fill_held was counted at (0: not yet)
  int fill_held[5];  // fill clusters of 1, 2, 4, 8, 16 blocks the card holds at once
};
constexpr int MAX_DEVICES = 64;
static DeviceInfo g_devices[MAX_DEVICES];

static void cloud_config(int C, int B, size_t smem, cudaStream_t stream, cudaLaunchConfig_t* cfg,
                         cudaLaunchAttribute* attr) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(C, B, 1);
  cfg->blockDim = dim3(CLOUD_THREADS, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// This device's DeviceInfo, with the two kernels' attributes set, or null
// (err set).
static DeviceInfo* device_info(cudaError_t* err) {
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return nullptr;
  if (dev < 0 || dev >= MAX_DEVICES) {
    *err = cudaErrorInvalidDevice;
    return nullptr;
  }
  DeviceInfo* info = &g_devices[dev];
  if (info->ready) return info;
  *err = cudaDeviceGetAttribute(&info->smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (*err == cudaSuccess)
    *err = cudaFuncSetAttribute(keyframe_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                info->smem_optin);
  const size_t cloud_smem = (size_t)CLOUD_LIST * sizeof(int2);
  if (*err == cudaSuccess)
    *err = cudaFuncSetAttribute(edge_cloud_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)cloud_smem);
  if (*err == cudaSuccess)
    *err = cudaFuncSetAttribute(edge_cloud_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (*err == cudaSuccess)  // the most it takes, beside its static shared memory
    *err = cudaFuncSetAttribute(fill_levels_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                FILL_BITS_SHARED + 4 * FILL_COUNTS_MAX);
  if (*err == cudaSuccess)
    *err = cudaFuncSetAttribute(fill_levels_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  for (int i = 0; i < 5 && *err == cudaSuccess; ++i) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cloud_config(1 << i, 1, cloud_smem, 0, &cfg, &attr);
    *err = cudaOccupancyMaxActiveClusters(&info->cloud_held[i], edge_cloud_kernel, &cfg);
  }
  int per_sm = 0, sms = 0;
  if (*err == cudaSuccess)
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, edt_levels_kernel, EDT_THREADS, 0);
  if (*err == cudaSuccess) *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  info->edt_resident = per_sm * sms;
  if (*err != cudaSuccess) {
    cudaGetLastError();  // reported here, not by the next launch
    return nullptr;
  }
  info->ready = 1;
  return info;
}

// Rows a block of revo_keyframe_rows owns for B lanes of H x W; 0 where not
// even one row fits a block's shared memory.  A cluster takes ROWS_CLUSTER
// bands, or all of a lane's where it has fewer.
static int rows_band(const DeviceInfo* info, int B, int H, int W) {
  const long long want = ((long long)H * B + ROWS_PER_SM * 132 - 1) / (ROWS_PER_SM * 132);
  int band = (int)min(max(want, (long long)ROWS_BAND_MIN), (long long)ROWS_BAND_MAX);
  while (band > 1 && rows_smem_bytes(W, band) > (size_t)info->smem_optin) --band;
  return rows_smem_bytes(W, band) <= (size_t)info->smem_optin ? band : 0;
}

// Blocks a cluster of revo_edt_columns_levels for `strips` strips: the
// largest of EDT_CHUNKS, ..., 2 whose blocks the card holds at once, else 1.
static int edt_cluster(const DeviceInfo* info, long long strips) {
  int C = EDT_CHUNKS;
  while (C > 1 && strips * C > info->edt_resident) C /= 2;
  return C;
}

// Blocks a lane of revo_edge_cloud: the largest power of two up to
// CLOUD_CLUSTER_MAX that leaves every block CLOUD_MIN_STEPS steps and of
// which the card holds the B lanes' clusters at once; else 1.
static int cloud_cluster(const DeviceInfo* info, int B, int steps) {
  for (int i = 4; i > 0; --i)
    if ((1 << i) * CLOUD_MIN_STEPS <= steps && info->cloud_held[i] >= B) return 1 << i;
  return 1;
}

static void fill_config(int C, int B, size_t smem, cudaStream_t stream, cudaLaunchConfig_t* cfg,
                        cudaLaunchAttribute* attr) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(C, B, 1);
  cfg->blockDim = dim3(FILL_THREADS, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// Blocks a lane of revo_fill_levels: the largest power of two up to
// FILL_CLUSTER_MAX that leaves every block FILL_MIN_PIXELS of level 1 and of
// which the card holds the B lanes' clusters at once (counted with `smem`,
// the most a block takes; recounted when it changes); else 1.
static int fill_cluster(DeviceInfo* info, int B, long long pixels, size_t smem,
                        cudaError_t* err) {
  if (info->fill_smem != smem) {
    for (int i = 0; i < 5; ++i) {
      cudaLaunchConfig_t cfg;
      cudaLaunchAttribute attr;
      fill_config(1 << i, 1, smem, 0, &cfg, &attr);
      *err = cudaOccupancyMaxActiveClusters(&info->fill_held[i], fill_levels_kernel, &cfg);
      if (*err != cudaSuccess) {
        cudaGetLastError();
        info->fill_smem = 0;
        return 0;
      }
    }
    info->fill_smem = smem;
  }
  for (int i = 4; i > 0; --i)
    if (((long long)FILL_MIN_PIXELS << i) <= pixels && info->fill_held[i] >= B) return 1 << i;
  return 1;
}

// ---------------------------------------------------------------------------
// 5. revo_pyramid: a frame's pyramid, up to two steps a launch (level l ->
// l + 1 -> l + 2): ops/filters.py pyramid_ref, pyr_level_ref chained.  A
// step: the gray by cv::pyrDown's 5-tap [1 4 6 4 1] / 16 blur with
// REFLECT_101 borders at even coordinates, the taps summed as the plain
// version sums them (each source row along x, then the rows along y),
// rounded half to even (rintf), ((H+1)/2, (W+1)/2); the depth, the mean of
// the > 0 pixels of each 2x2 block, (tl + bl) + (tr + br) over the count, 0
// where none is, (H/2, W/2), odd sizes dropping the last row / column.  Gray
// may be uint8 or float32, depth uint16 (times inv_scale, as the front end
// converts raw depth) or float32 metres; from uint8 / uint16 the launch also
// writes the input level as float32 (gray.to(float32), depth.to(float32) *
// inv_scale), what the front end's level 0 is.
//
// A block takes a tile of PYR_TH x PYR_TW pixels of the second step's level
// (a one-step launch: the tile that level would have) and stages the input
// window its tile needs, REFLECT_101 halo included, in shared memory at once
// (16-byte float / 4-byte uint8 loads where W % 4 == 0).  It sums each
// staged row's 5 taps along x once for every column of the first step's
// tile, then the 5 rows along y into that tile, which it keeps with a 2-pixel
// halo of its own (each halo pixel from its reflected row and column at the
// first step's borders: the plain version's bits in its order), writes the
// tile's interior, and computes the second step from the tile; the depth's
// 2x2 means of the second step read the first's from the tile too.  Bounds:
// the input read and the levels written once (640x480 from uint8 / uint16,
// level 0's float32 written: ~4.1 MB, ~1.2 us at 3.35 TB/s; from float32
// ~3.2 MB); the taps are ~60 operations a first-step pixel.
constexpr int PYR_THREADS = 256;
constexpr int PYR_TH = 8, PYR_TW = 16;       // a block's tile of the second step's level
constexpr int PYR_ROWS0 = 4 * PYR_TH + 11;   // input rows staged: [4 Y - 6, 4 Y + 4 TH + 5)
constexpr int PYR_COLS0 = 4 * PYR_TW + 16;   // input columns staged: [4 X - 8, 4 X + 4 TW + 8)
constexpr int PYR_ROWS1 = 2 * PYR_TH + 3;    // the first step's tile with its halo:
constexpr int PYR_COLS1 = 2 * PYR_TW + 3;    //   rows [2 Y - 2, 2 Y + 2 TH], likewise columns
constexpr int PYR_CHUNKS = (PYR_ROWS0 * PYR_COLS0 / 4 + PYR_THREADS - 1) / PYR_THREADS;
constexpr int PYR_GROUPS = PYR_THREADS / PYR_COLS1;  // row groups of the tap sums: 7
static_assert(PYR_THREADS == 2 * PYR_TH * PYR_TW, "a thread takes 2 depth cells of the tile");

__device__ __forceinline__ int reflect101(int j, int n) {
  return j < 0 ? -j : (j > n - 1 ? 2 * (n - 1) - j : j);
}

// 4 values from column x (a multiple of 4, or any where not `vec`) of row
// `row` as float32, times `scale` for uint16 depth (0 outside [0, n)), by one
// load where `vec` (n % 4 == 0, the tensor aligned).
__device__ __forceinline__ float to_f(float v, float) { return v; }
__device__ __forceinline__ float to_f(uint8_t v, float) { return (float)v; }
__device__ __forceinline__ float to_f(uint16_t v, float scale) { return __fmul_rn((float)v, scale); }
template <typename T>
__device__ __forceinline__ float4 load4(const T* row, int x, int n, bool vec, float scale) {
  float o[4];
  if (vec && x >= 0 && x < n) {
    T e[4];
    if (sizeof(T) == 4) *reinterpret_cast<float4*>(e) = __ldg(reinterpret_cast<const float4*>(row + x));
    else if (sizeof(T) == 2) *reinterpret_cast<uint2*>(e) = __ldg(reinterpret_cast<const uint2*>(row + x));
    else *reinterpret_cast<uint32_t*>(e) = __ldg(reinterpret_cast<const uint32_t*>(row + x));
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = to_f(e[j], scale);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = x + j >= 0 && x + j < n ? to_f(row[x + j], scale) : 0.0f;
  }
  return make_float4(o[0], o[1], o[2], o[3]);
}

// 4 values to columns x .. x + 3 of `row`, those inside [0, n); one store
// where `vec` (x a multiple of 4, n % 4 == 0, the tensor aligned).
__device__ __forceinline__ void store4(float* row, int x, int n, float4 v, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(row + x) = v;
    return;
  }
  const float o[4] = {v.x, v.y, v.z, v.w};
  for (int j = 0; j < 4; ++j)
    if (x + j >= 0 && x + j < n) row[x + j] = o[j];
}

// The hole-aware mean of a 2x2 block, (tl + bl) + (tr + br) over its > 0 count.
__device__ __forceinline__ float hole_mean(float tl, float tr, float bl, float br) {
  auto v = [](float x) { return x > 0.0f ? x : 0.0f; };
  auto c = [](float x) { return x > 0.0f ? 1.0f : 0.0f; };
  const float total = __fadd_rn(__fadd_rn(v(tl), v(bl)), __fadd_rn(v(tr), v(br)));
  const float cnt = __fadd_rn(__fadd_rn(c(tl), c(bl)), __fadd_rn(c(tr), c(br)));
  return cnt > 0.0f ? __fdiv_rn(total, fmaxf(cnt, 1.0f)) : 0.0f;
}

// One pyrDown tap sum: 5 values at stride `s` from p, in the plain version's order.
__device__ __forceinline__ float taps5(const float* p, int s) {
  const float k[5] = {1.0f / 16.0f, 4.0f / 16.0f, 6.0f / 16.0f, 4.0f / 16.0f, 1.0f / 16.0f};
  float r = __fmul_rn(p[0], k[0]);
#pragma unroll
  for (int u = 1; u < 5; ++u) r = __fadd_rn(r, __fmul_rn(p[u * s], k[u]));
  return r;
}

struct PyrOut {
  float *g0, *d0;  // the input level as float32 (null: not written)
  float *g1, *d1, *g2, *d2;  // the steps' levels (g2, d2 null: one step)
};

template <typename G, typename D>
__global__ void __launch_bounds__(PYR_THREADS)
pyramid_kernel(const G* __restrict__ gray, const D* __restrict__ depth, float inv_scale,
               PyrOut out, int H, int W, int HD, int WD, int tiles_x) {
  __shared__ __align__(16) float g0s[PYR_ROWS0][PYR_COLS0];  // the input window
  __shared__ float hs[PYR_ROWS0][PYR_COLS1];   // its rows' tap sums along x
  __shared__ float g1s[PYR_ROWS1][PYR_COLS1];  // the first step's tile with its halo
  __shared__ float d1s[2 * PYR_TH][2 * PYR_TW];  // the first step's depth tile
  const float k[5] = {1.0f / 16.0f, 4.0f / 16.0f, 6.0f / 16.0f, 4.0f / 16.0f, 1.0f / 16.0f};
  const bool two = out.g2 != nullptr;
  const int H1 = (H + 1) / 2, W1 = (W + 1) / 2, hd1 = HD / 2, wd1 = WD / 2;
  const int H2 = (H1 + 1) / 2, W2 = (W1 + 1) / 2, hd2 = hd1 / 2, wd2 = wd1 / 2;
  const int b = blockIdx.y;
  const int Y = blockIdx.x / tiles_x * PYR_TH, X = blockIdx.x % tiles_x * PYR_TW;
  const int ys0 = 4 * Y - 6, xs0 = 4 * X - 8;  // the window's origin in the input
  const G* g = gray + (size_t)b * H * W;
  const D* d = depth + (size_t)b * HD * WD;
  const int t = threadIdx.x;
  // -- the pyramid's loads
  // Every load of the thread in flight at once: its chunks of 4 gray values
  // of the window, and its 2 x 4 depth values, the 2x2 cells (r, c), (r, c +
  // 1) of the first step: cells [2 Y, 2 Y + 2 TH) x [2 X, 2 X + 2 TW), a
  // thread 2 of a row.
  const bool vec_g = W % 4 == 0 && (reinterpret_cast<uintptr_t>(gray) & (sizeof(G) * 4 - 1)) == 0;
  const bool vec_d = WD % 4 == 0 && (reinterpret_cast<uintptr_t>(depth) & (sizeof(D) * 4 - 1)) == 0;
  float4 v[PYR_CHUNKS];
#pragma unroll
  for (int i = 0; i < PYR_CHUNKS; ++i) {
    const int q = t + i * PYR_THREADS, r = q / (PYR_COLS0 / 4), x = xs0 + 4 * (q % (PYR_COLS0 / 4));
    const int y = ys0 + r;
    v[i] = q < PYR_ROWS0 * PYR_COLS0 / 4 && y >= 0 && y < H
               ? load4(g + (size_t)y * W, x, W, vec_g, 1.0f) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  const int cr = 2 * Y + t / PYR_TW, cc = 2 * X + 2 * (t % PYR_TW);  // the thread's cells
  float4 dv[2];
#pragma unroll
  for (int dy = 0; dy < 2; ++dy)
    dv[dy] = 2 * cr + dy < HD ? load4(d + (size_t)(2 * cr + dy) * WD, 2 * cc, WD, vec_d, inv_scale)
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int i = 0; i < PYR_CHUNKS; ++i) {
    const int q = t + i * PYR_THREADS;
    if (q < PYR_ROWS0 * PYR_COLS0 / 4)
      *reinterpret_cast<float4*>(&g0s[q / (PYR_COLS0 / 4)][4 * (q % (PYR_COLS0 / 4))]) = v[i];
  }
  // The depth: the first step's cells.
  for (int j = 0; j < 2; ++j) {
    if (cr >= hd1 || cc + j >= wd1) continue;
    const float m = j == 0 ? hole_mean(dv[0].x, dv[0].y, dv[1].x, dv[1].y)
                           : hole_mean(dv[0].z, dv[0].w, dv[1].z, dv[1].w);
    out.d1[((size_t)b * hd1 + cr) * wd1 + cc + j] = m;
    d1s[cr - 2 * Y][cc + j - 2 * X] = m;
  }
  __syncthreads();
  // -- the pyramid's first step along x
  // The first step's rows and columns the block computes: its tile's (one
  // step), with the 2-pixel halo that the second step's valid pixels read.
  // A thread takes one column of the tile and every PYR_GROUPS-th row.
  const int own_r1 = min(2 * Y + 2 * PYR_TH, H1), own_c1 = min(2 * X + 2 * PYR_TW, W1);
  const int v_lo = two ? 2 * Y - 2 : 2 * Y, u_lo = two ? 2 * X - 2 : 2 * X;  // inclusive
  const int v_hi = two ? max(2 * min(Y + PYR_TH, H2), own_r1 - 1) : own_r1 - 1;
  const int u_hi = two ? max(2 * min(X + PYR_TW, W2), own_c1 - 1) : own_c1 - 1;
  const int cu = t % PYR_COLS1, rg = t / PYR_COLS1, u = 2 * X - 2 + cu;
  const bool col = rg < PYR_GROUPS && u >= u_lo && u <= u_hi;
  if (col) {
    const int c1 = reflect101(u, W1);
    int at[5];
#pragma unroll
    for (int s = 0; s < 5; ++s) at[s] = reflect101(2 * c1 + s - 2, W) - xs0;
    for (int r = rg; r < PYR_ROWS0; r += PYR_GROUPS) {
      if (ys0 + r < 0 || ys0 + r >= H) continue;
      float p[5];
#pragma unroll
      for (int s = 0; s < 5; ++s) p[s] = g0s[r][at[s]];
      hs[r][cu] = taps5(p, 1);
    }
  }
  __syncthreads();
  // -- the pyramid's first step along y
  if (col)
    for (int rv = rg; rv < PYR_ROWS1; rv += PYR_GROUPS) {
      const int vv = 2 * Y - 2 + rv;
      if (vv < v_lo || vv > v_hi) continue;
      const int r1 = reflect101(vv, H1);
      float p[5];
#pragma unroll
      for (int s = 0; s < 5; ++s) p[s] = hs[reflect101(2 * r1 + s - 2, H) - ys0][cu];
      const float val = rintf(taps5(p, 1));
      g1s[rv][cu] = val;
      if (vv >= 2 * Y && vv < own_r1 && u >= 2 * X && u < own_c1)
        out.g1[((size_t)b * H1 + vv) * W1 + u] = val;
    }
  // The input level's float32 where it is converted, the tile's own part:
  // written once the steps' loads are done, while their arithmetic runs.
  if (out.g0)
    for (int i = t; i < 4 * PYR_TH * PYR_TW; i += PYR_THREADS) {
      const int y = 4 * Y + i / PYR_TW, x = 4 * X + 4 * (i % PYR_TW);
      if (y < H && x < W)
        store4(out.g0 + ((size_t)b * H + y) * W, x, W,
               *reinterpret_cast<const float4*>(&g0s[y - ys0][x - xs0]),
               W % 4 == 0 && (reinterpret_cast<uintptr_t>(out.g0) & 15) == 0);
    }
  if (out.d0)
    for (int dy = 0; dy < 2; ++dy)
      if (2 * cr + dy < HD)
        store4(out.d0 + ((size_t)b * HD + 2 * cr + dy) * WD, 2 * cc, WD, dv[dy],
               WD % 4 == 0 && (reinterpret_cast<uintptr_t>(out.d0) & 15) == 0);
  if (!two) return;
  __syncthreads();
  // -- the pyramid's second step
  for (int i = t; i < PYR_TH * PYR_TW; i += PYR_THREADS) {
    const int gi = Y + i / PYR_TW, gj = X + i % PYR_TW;
    const int r2 = 2 * (gi - Y), c2 = 2 * (gj - X);  // tap (0, 0) in the tile: row 2 gi - 2
    if (gi < H2 && gj < W2) {
      float acc = 0.0f;
      for (int s = 0; s < 5; ++s) {
        const float term = __fmul_rn(taps5(&g1s[r2 + s][c2], 1), k[s]);
        acc = s == 0 ? term : __fadd_rn(acc, term);
      }
      out.g2[((size_t)b * H2 + gi) * W2 + gj] = rintf(acc);
    }
    if (gi < hd2 && gj < wd2) {
      const int r = 2 * (gi - Y), c = 2 * (gj - X);
      out.d2[((size_t)b * hd2 + gi) * wd2 + gj] =
          hole_mean(d1s[r][c], d1s[r][c + 1], d1s[r + 1][c], d1s[r + 1][c + 1]);
    }
  }
}

}  // namespace fe

// n levels of B lanes each, given as n x (edges pointer, g^2 pointer, H, W)
// in `levels` (host memory) -> g^2 of every level, one launch of clusters of
// edt_cluster's blocks.  Every shape is taken.
extern "C" int revo_edt_columns_levels(const long long* levels, int n, int B,
                                       cudaStream_t stream) {
  if (n < 1 || n > fe::EDT_MAX_LEVELS || B < 1) return (int)cudaErrorInvalidValue;
  fe::EdtLevels lv{};
  long long strips = 0;
  for (int l = 0; l < n; ++l) {
    const long long* a = levels + 4 * l;
    if (a[2] < 1 || a[3] < 1 || a[2] > INT32_MAX || a[3] > INT32_MAX)
      return (int)cudaErrorInvalidValue;
    lv.edges[l] = reinterpret_cast<const uint8_t*>(a[0]);
    lv.g2[l] = reinterpret_cast<float*>(a[1]);
    lv.H[l] = (int)a[2];
    lv.W[l] = (int)a[3];
    lv.first[l] = (int)strips;
    strips += (long long)B * ((a[3] + fe::EDT_STRIP - 1) / fe::EDT_STRIP);
    if (strips * fe::EDT_CHUNKS > INT32_MAX) return (int)cudaErrorInvalidValue;
  }
  lv.first[n] = (int)strips;
  cudaError_t err;
  const fe::DeviceInfo* info = fe::device_info(&err);
  if (!info) return (int)err;
  const int C = fe::edt_cluster(info, strips);
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3((unsigned)(strips * C), 1, 1);
  cfg.blockDim = dim3(fe::EDT_THREADS, 1, 1);
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fe::edt_levels_kernel, lv);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// B lanes of (H, W) g^2 -> structure (B, H, W, 3) float32 and the quad table
// (B, H W, width) of float32 or bfloat16 (bf16); bands of rows_band's rows, a
// cluster of ROWS_CLUSTER bands or all of a lane's.  A row too wide for a
// band of one row (W > 11,622), or a cluster the card cannot hold, is
// refused, and the status returned.
extern "C" int revo_keyframe_rows(const float* g2, float* structs, void* quad, int B, int H, int W,
                                  int width, int bf16, cudaStream_t stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || (width != 4 && width != 12))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  const fe::DeviceInfo* info = fe::device_info(&err);
  if (!info) return (int)err;
  const int bd = fe::rows_band(info, B, H, W);
  if (bd <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (H + bd - 1) / bd;
  const int C = min(fe::ROWS_CLUSTER, blocks);
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3((blocks + C - 1) / C * C, B, 1);
  cfg.blockDim = dim3(fe::ROWS_THREADS, 1, 1);
  cfg.dynamicSmemBytes = fe::rows_smem_bytes(W, bd);
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fe::keyframe_rows_kernel, g2, structs, quad, H, W, width, bf16,
                           bd);
  // Also clears a refusal, so that the next launch's check does not report it.
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// B lanes of (H, W) edges (0/1 bytes) and float32 depth -> points (B, cap,
// 3), valid (B, cap) bytes, count (B,) int32; cloud_cluster's blocks a lane.
// A cluster the card cannot hold is refused by the launch, whose status is
// returned.
extern "C" int revo_edge_cloud(const uint8_t* edges, const float* depth, float* points,
                               uint8_t* valid, int* count, int B, int H, int W, float inv_fx,
                               float inv_fy, float cx, float cy, float dmin, float dmax, int cap,
                               cudaStream_t stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || cap < 1 || (long long)H * W > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  const fe::DeviceInfo* info = fe::device_info(&err);
  if (!info) return (int)err;
  const int n = H * W, steps = (n + fe::CLOUD_STEP - 1) / fe::CLOUD_STEP;
  const int C = fe::cloud_cluster(info, B, steps);
  const int len = min(fe::CLOUD_LIST, (steps + C - 1) / C * fe::CLOUD_STEP);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  fe::cloud_config(C, B, (size_t)len * sizeof(int2), stream, &cfg, &attr);
  const fe::CloudArgs a{inv_fx, inv_fy, cx, cy, dmin, dmax};
  err = cudaLaunchKernelEx(&cfg, fe::edge_cloud_kernel, edges, depth, points, valid, count, W, n,
                           cap, len, a);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// B lanes of (H, W) gray (uint8 / float32) and (HD, WD) depth (uint16 /
// float32; HD <= H, WD <= W: a level's depth is its input's halved, rounded
// down, its gray rounded up) -> `steps` (1 or 2) pyramid levels: (B,
// (H+1)/2, (W+1)/2) gray and (B, HD/2, WD/2) depth, then the same of those;
// g0 / d0 (null: not written) take the input as float32.  A step's gray
// input below 3 x 3 is refused.
extern "C" int revo_pyramid(const void* gray, int gray_u8, const void* depth, int depth_u16,
                            float inv_scale, float* g0, float* d0, float* g1, float* d1,
                            float* g2, float* d2, int B, int H, int W, int HD, int WD, int steps,
                            cudaStream_t stream) {
  const int H1 = (H + 1) / 2, W1 = (W + 1) / 2;
  if (B < 1 || B > 65535 || H < 3 || W < 3 || HD < 0 || HD > H || WD < 0 || WD > W ||
      steps < 1 || steps > 2 || (steps == 2 && (H1 < 3 || W1 < 3 || !g2)))
    return (int)cudaErrorInvalidValue;
  const int tiles_x = ((W1 + 1) / 2 + fe::PYR_TW - 1) / fe::PYR_TW;
  const int tiles_y = ((H1 + 1) / 2 + fe::PYR_TH - 1) / fe::PYR_TH;
  const dim3 grid((unsigned)tiles_x * tiles_y, B);
  const fe::PyrOut out{g0, d0, g1, d1, steps == 2 ? g2 : nullptr, steps == 2 ? d2 : nullptr};
  if (gray_u8 && depth_u16)
    fe::pyramid_kernel<uint8_t, uint16_t><<<grid, fe::PYR_THREADS, 0, stream>>>(
        static_cast<const uint8_t*>(gray), static_cast<const uint16_t*>(depth), inv_scale, out, H,
        W, HD, WD, tiles_x);
  else if (gray_u8)
    fe::pyramid_kernel<uint8_t, float><<<grid, fe::PYR_THREADS, 0, stream>>>(
        static_cast<const uint8_t*>(gray), static_cast<const float*>(depth), inv_scale, out, H, W,
        HD, WD, tiles_x);
  else if (depth_u16)
    fe::pyramid_kernel<float, uint16_t><<<grid, fe::PYR_THREADS, 0, stream>>>(
        static_cast<const float*>(gray), static_cast<const uint16_t*>(depth), inv_scale, out, H,
        W, HD, WD, tiles_x);
  else
    fe::pyramid_kernel<float, float><<<grid, fe::PYR_THREADS, 0, stream>>>(
        static_cast<const float*>(gray), static_cast<const float*>(depth), inv_scale, out, H, W,
        HD, WD, tiles_x);
  return (int)cudaGetLastError();
}

// n levels of B lanes, given as n x (edges pointer, output pointer, H, W,
// patch) in `levels` (host memory; entry 0 the parent of level 1, its output
// pointer unread) -> levels 1 .. n-1 after the fill-in, and each lane's and
// level's flag (the occupancy below npct) at flags[b * flag_stride + l - 1];
// one launch of fill_cluster's blocks a lane.  gbits: null where two levels'
// bit maps fit FILL_BITS_SHARED (2 * words * 4 bytes, words the most of
// hc * ceil(wc / 32) over levels 1 ..), else B x 2 x words words of global
// memory.  Every shape is taken.
extern "C" int revo_fill_levels(const long long* levels, int n, int B, uint8_t* flags,
                                int flag_stride, float npct, uint32_t* gbits,
                                cudaStream_t stream) {
  if (n < 2 || n > fe::FILL_MAX_LEVELS || B < 1 || B > 65535 || !flags || flag_stride < n - 1)
    return (int)cudaErrorInvalidValue;
  fe::FillLevels f{};
  long long words = 0;
  for (int l = 0; l < n; ++l) {
    const long long* a = levels + 5 * l;
    if (!a[0] || (l > 0 && !a[1]) || a[2] < 1 || a[3] < 1 || a[4] < 1 ||
        a[2] * a[3] > (1LL << 30) || a[4] > (1 << 20))
      return (int)cudaErrorInvalidValue;
    f.edges[l] = reinterpret_cast<const uint8_t*>(a[0]);
    f.out[l] = reinterpret_cast<uint8_t*>(a[1]);
    f.H[l] = (int)a[2];
    f.W[l] = (int)a[3];
    f.patch[l] = (int)a[4];
    f.hc[l] = f.H[l] / f.patch[l];
    f.wc[l] = f.W[l] / f.patch[l];
    f.thresh[l] = (float)((double)a[4] * (double)a[4] * 0.05);
    if (l > 0) words = std::max(words, (long long)f.hc[l] * ((f.wc[l] + 31) / 32));
  }
  if (!gbits && 8 * words > fe::FILL_BITS_SHARED) return (int)cudaErrorInvalidValue;
  f.n = n;
  f.words = (int)words;
  f.flags = flags;
  f.flag_stride = flag_stride;
  f.gbits = gbits;
  f.npct = npct;
  cudaError_t err;
  fe::DeviceInfo* info = fe::device_info(&err);
  if (!info) return (int)err;
  // A block's count slots: its bin rows of the widest level, at most FILL_COUNTS_MAX.
  const auto slots = [&](int C) {
    long long most = 32;
    for (int l = 1; l < n; ++l)
      most = std::max(most, (long long)((f.hc[l] + C - 1) / C) * f.wc[l]);
    return (int)std::min((long long)fe::FILL_COUNTS_MAX, (most + 31) / 32 * 32);
  };
  const size_t bits_smem = gbits ? 0 : (size_t)8 * words;
  const int C = fe::fill_cluster(info, B, (long long)f.H[1] * f.W[1],
                                 bits_smem + (size_t)4 * slots(1), &err);
  if (C == 0) return (int)err;
  f.counts = slots(C);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  fe::fill_config(C, B, bits_smem + (size_t)4 * f.counts, stream, &cfg, &attr);
  err = cudaLaunchKernelEx(&cfg, fe::fill_levels_kernel, f);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
