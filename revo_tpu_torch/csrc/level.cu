// The solver's pyramid level in one launch: `revo_solve_level`.
//
// It replaces no Pallas kernel.  In the JAX package a level is one device
// program: lm's nested lax.while_loops (revo_tpu/solver.py:484, :495) and
// gn_fixed's while_loop (:603), vmapped over the lanes, whose bodies XLA
// fuses around each evaluation; the residual pass of an evaluation reaches
// the Pallas K3 (revo_tpu/ops/pallas/lgsx.py:103).  The port ran the same
// loop from the host as two launches an evaluation, `residual_lgsx` and
// `revo_solver_step` (lgsx.cu, solver.cu), and the host's launch rate set
// the pace: ~0.2 ms of Python and ctypes an evaluation against ~0.014 ms of
// device work.  Here the loop runs on the card, and each lane leaves at its
// own exit, as JAX's while_loop does.
//
// One thread-block cluster a lane (grid (C, B), clusters of C <= 8 blocks
// along x; lanes are independent, so nothing synchronises across clusters).
// A block is LV_GROUPS groups of 128 threads, and every block keeps the
// lane's whole LevelState in its shared memory for the level.  Per
// evaluation, one cluster barrier:
//   1. the residual pass in exactly `residual_lgsx`'s partition: virtual
//      block j holds points [128 j, 128 j + 128), and group g of rank r
//      takes j = r LV_GROUPS + g, then j + C LV_GROUPS, ...; each virtual
//      block forms its partial row with lgsx::group_row (block_row's
//      arithmetic at a named barrier of its group) in the lane's global
//      scratch, in the buffer of the evaluation's parity;
//   2. cluster.sync(), which orders those rows (release / acquire at cluster
//      scope; they are read past L1);
//   3. every block sums the rows in virtual-block order (lgsx::sum_rows, the
//      order of `residual_lgsx`'s last block) into the lane's 46 outputs;
//   4. warp 0 of every block runs step::step_lane_warp, `revo_solver_step`'s
//      arithmetic entry by entry over 32 lanes, on the block's copy of the
//      state; every block computes the same bits, so every block knows the
//      next candidate and whether the lane goes on without a second barrier;
//      the lane leaves once it stops or at the cap, max_iter * max_inner
//      evaluations after the start for lm, max_iter for gn_fixed.
// Two buffers of rows: a block may write evaluation k + 1's rows while a
// slower one still reads evaluation k's, and none can write k + 2's before
// every block has passed barrier k + 1.  The level's start is inside too:
// with an init-check block, the lane's cluster runs the tracker's init check
// first (initcheck.cuh, the code `revo_init_check` runs) and the level starts
// from its choice; lm evaluates the start and runs the step's start mode,
// gn_fixed runs the start mode alone.  At its exit rank 0 writes the state
// and the count of evaluations the lane ran (lm's start included) to device
// memory; a last cluster.sync() keeps every block until no block reads
// another's shared memory (the init check's partial sums).
//
// Bits.  The pass, the reduction order and the step are those of the
// two-launch loop, compiled from the same device code (residual.cuh,
// lgsx.cuh, solver.cuh's entries), and the steps that loop runs after a lane
// stopped change nothing, so every field of the final state equals the
// loop's.  The cluster size only moves virtual blocks between SMs: it
// changes no bit.
//
// Bound on the H100: latency.  An evaluation reads 13 B a point and one
// table row a point inside the image (~0.3 MB at P = 16384, ~0.1 us of HBM
// time, from L2 after the first), does ~166 operations a point and ~580 in
// the step; the dependent chain of pass, barrier, ordered sum and step sets
// its time; a second barrier, a sum in one block and a one-thread step on
// the state in device memory took ~9 us of an evaluation's 12-19 (PERF.md
// section 6), hence one barrier, the sum in every block and a warp's step
// on the state in shared memory.  Registers: a kernel's count is the
// largest over its code, so __launch_bounds__ caps a thread at 65536 /
// LV_THREADS.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "initcheck.cuh"
#include "lgsx.cuh"
#include "residual.cuh"
#include "solver.cuh"

namespace cg = cooperative_groups;

namespace {

using residual::NF;

constexpr int VB_POINTS = 128;  // points of a virtual block: one `residual_lgsx` block
constexpr int LV_GROUPS = 4;  // groups of 128 threads a block (512 beat 256 and 1024)
constexpr int LV_THREADS = VB_POINTS * LV_GROUPS;
constexpr int LV_CLUSTER_MAX = 8;  // the portable cluster size
static_assert(LV_GROUPS >= 1 && LV_GROUPS <= 8, "named barriers 1..LV_GROUPS");

struct Lanes {  // a level's pose-independent operands (ops/lgsx.py LaneOperands)
  const void* quad;
  int quad_stride;  // in rows of the layout's width
  const float* pts;
  int pts_stride;
  const uint8_t* valid;
  int valid_stride;
  const float* R0;
  int R0_stride;
  const float* t0;
  int t0_stride;
  float fx, fy, cx, cy;
  int W, H;
  float edge_distance, huber;
  int use_edge_filter, P;
  float* partial;  // two buffers of max(ceil(P / 128), 1) rows of lgsx::ROW floats a lane
  int* evals;      // (B,) evaluations each lane ran
};

// A lane's LevelState in one block's shared memory, for the whole level.
struct LaneSmem {
  float R[9], t[3], Rn[9], tn[3], inc[6], err, A[36], g[6], sum_w, sum_unw, lam;
  int good, bad, iteration, tries;
  uint8_t active;
};

__device__ __forceinline__ step::Lane lane_view(LaneSmem& s) {
  return {s.R,    s.t,    s.Rn,       s.tn,       s.inc,        &s.err,   s.A,      s.g,
          &s.good, &s.bad, &s.sum_w, &s.sum_unw, &s.lam, &s.iteration, &s.tries, &s.active};
}

// The lane's final state into its LevelState tensors, one word a thread.
__device__ __forceinline__ void store_lane(const LaneSmem& s, const step::State& st, int b,
                                           int tid) {
  if (tid < 36) st.A[36 * b + tid] = s.A[tid];
  if (tid < 9) st.R[9 * b + tid] = s.R[tid], st.Rn[9 * b + tid] = s.Rn[tid];
  if (tid < 6) st.inc[6 * b + tid] = s.inc[tid], st.g[6 * b + tid] = s.g[tid];
  if (tid < 3) st.t[3 * b + tid] = s.t[tid], st.tn[3 * b + tid] = s.tn[tid];
  if (tid == 0) {
    st.err[b] = s.err;
    st.good[b] = s.good;
    st.bad[b] = s.bad;
    st.sum_w[b] = s.sum_w;
    st.sum_unw[b] = s.sum_unw;
    st.lam[b] = s.lam;
    st.iteration[b] = s.iteration;
    st.tries[b] = s.tries;
    st.active[b] = s.active;
  }
}

template <int L>
__global__ void __launch_bounds__(LV_THREADS, 1)
solve_level_kernel(Lanes a, step::State st, const float* __restrict__ pows, step::Params p,
                   initcheck::Args ic) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  const int b = blockIdx.y;  // the lane
  const int tid = threadIdx.x, group = tid / VB_POINTS, gtid = tid % VB_POINTS;
  const int nb = max((a.P + VB_POINTS - 1) / VB_POINTS, 1);
  const float* pts = a.pts + (size_t)b * a.pts_stride;
  const uint8_t* valid = a.valid + (size_t)b * a.valid_stride;
  float* rows = a.partial + (size_t)b * 2 * nb * lgsx::ROW;  // buffer k: rows + k nb ROW
  const size_t row0 = (size_t)b * a.quad_stride;
  __shared__ float stage[lgsx::CHUNK * lgsx::ROW];
  __shared__ float sums[46];  // the evaluation's outputs
  __shared__ float start[12];  // R, t of the level's start
  __shared__ LaneSmem ls;
  __shared__ initcheck::Smem<LV_THREADS> ic_sm;
  const step::Lane lane = lane_view(ls);

  // One evaluation at (Rp, tp) (shared memory) into `sums`, the partial
  // rows in buffer k.
  auto evaluate = [&](const float* Rp, const float* tp, int k) {
    // -- the pass
    float R[9], t[3];
#pragma unroll
    for (int i = 0; i < 9; ++i) R[i] = Rp[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) t[i] = tp[i];
    float* buf = rows + (size_t)k * nb * lgsx::ROW;
    for (int j = rank * LV_GROUPS + group; j < nb; j += C * LV_GROUPS) {
      float acc[NF];
#pragma unroll
      for (int i = 0; i < NF; ++i) acc[i] = 0.0f;
      int n_good = 0, n_bad = 0;
      residual::point_pass<L>(a.quad, row0, pts, valid, j * VB_POINTS + gtid, a.P, R, t, a.fx,
                              a.fy, a.cx, a.cy, a.W, a.H, a.edge_distance, a.huber,
                              a.use_edge_filter, acc, n_good, n_bad);
      int cnt[2] = {n_good, n_bad};
      lgsx::group_row<VB_POINTS, NF, 2>(acc, cnt, stage + group * (VB_POINTS / 32) * lgsx::ROW,
                                        buf + (size_t)j * lgsx::ROW, gtid, 1 + group);
    }
    // -- the barrier
    cluster.sync();
    // -- the ordered sum
    float fs;
    int is;
    lgsx::sum_rows<LV_THREADS, NF, 2>(buf, nb, stage, fs, is);
    residual::store_outputs(sums, tid, fs, is);
    __syncthreads();
  };

  // The level's start: (R0, t0), or the init check's choice.
  const float* R0 = a.R0 + (size_t)b * a.R0_stride;
  const float* t0 = a.t0 + (size_t)b * a.t0_stride;
  if (ic.dt) {
    initcheck::lane_check<LV_THREADS>(ic, b, pts, valid, a.P, R0, t0, a.W, a.H, a.fx, a.fy,
                                      a.cx, a.cy, ic_sm, start);
  } else {
    if (tid < 9) start[tid] = R0[tid];
    else if (tid < 12) start[tid] = t0[tid - 9];
    __syncthreads();
  }
  int n = 0;  // evaluations
  if (!p.gn) {  // lm's start evaluates the start pose
    evaluate(start, start + 9, 0);
    n = 1;
  }
  if (tid < 32) step::step_lane_warp(lane, sums, pows, start, start + 9, 1, p);
  __syncthreads();
  const int cap = p.gn ? p.max_iter : p.max_iter * p.max_inner;
  for (int k = 0; k < cap && ls.active; ++k) {  // every block of the lane alike
    evaluate(ls.Rn, ls.tn, n & 1);
    ++n;
    // -- the step
    if (tid < 32) step::step_lane_warp(lane, sums, pows, nullptr, nullptr, 0, p);
    __syncthreads();
    // -- the step done
  }
  if (rank == 0) {
    store_lane(ls, st, b, tid);
    if (tid == 0) a.evals[b] = n;
  }
  cluster.sync();  // no block leaves while another may still read its shared memory
}

void level_config(int C, int B, cudaStream_t stream, cudaLaunchConfig_t* cfg,
                  cudaLaunchAttribute* attr) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(C, B, 1);
  cfg->blockDim = dim3(LV_THREADS, 1, 1);
  cfg->dynamicSmemBytes = 0;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

template <int L>
int max_clusters(int C) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  level_config(C, 1, 0, &cfg, &attr);
  int count = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&count, solve_level_kernel<L>, &cfg);
  cudaGetLastError();  // a refusal is reported here, not by the next launch
  return err == cudaSuccess ? count : -(int)err;
}

template <int L>
int attribute(int which) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, solve_level_kernel<L>);
  cudaGetLastError();
  if (err != cudaSuccess) return -(int)err;
  switch (which) {
    case 0: return fa.numRegs;
    case 1: return (int)fa.localSizeBytes;
    case 2: return (int)fa.sharedSizeBytes;
    case 3: return LV_THREADS;
    case 4: return fa.maxThreadsPerBlock;
    default: return -(int)cudaErrorInvalidValue;
  }
}

#define REVO_LEVEL_LAYOUTS(X) \
  X(residual::DT4) X(residual::DT4_BF16) X(residual::QUAD12) X(residual::QUAD12_BF16) \
  X(residual::STRUCT3)

}  // namespace

// B lanes of one level.  The level's operands as `revo_residual_lgsx`
// takes them (lane strides in elements, 0 for a shared operand; quad_stride
// in rows of the layout's width); R0 / t0 the start poses with lane
// strides; partial: 2 max(ceil(P / 128), 1) rows of 32 floats a lane; the
// State pointers: solver.py LevelState's tensors, contiguous, written with
// the level's final state (nothing read from them first); evals: (B,) int32;
// pows: n_pows float32 (solver.py `_fail_table`); ic_dt null, or the init
// check before the level's start (solver.py InitCheckBlock): the coarsest
// level's (H, W, 3) structure of each lane with its lane stride (channel 2
// is the DT), its edge distance, filter, normalisation and margin, and the
// outputs use_eye (B,) bytes and costs (B, 2); cluster: blocks a lane, 1 to
// 8.  Returns the launch's CUDA status (a cluster shape the card cannot hold
// is refused there); a layout or cluster out of range returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int revo_solve_level(
    const void* quad, int layout, int quad_stride, const float* pts, int pts_stride,
    const uint8_t* valid, int valid_stride, const float* R0, int R0_stride, const float* t0,
    int t0_stride, float fx, float fy, float cx, float cy, int W, int H, float edge_distance,
    float huber, int use_edge_filter, int P, int B, float* partial, float* R, float* t, float* Rn,
    float* tn, float* inc, float* err, float* A, float* g, int* good, int* bad, float* sum_w,
    float* sum_unw, float* lam, int* iteration, int* tries, uint8_t* active, int* evals,
    const float* pows, int n_pows, int gn, int max_iter, int max_inner, float conv_eps,
    float flat_below, float step_min, float success, float fail, float lam0, const float* ic_dt,
    int ic_dt_stride, float ic_edge_distance, int ic_use_edge_filter, int ic_normalized,
    float ic_margin, uint8_t* ic_use_eye, float* ic_costs, int cluster, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (B > 65535 || n_pows <= 0 || cluster < 1 || cluster > LV_CLUSTER_MAX || layout < 0 ||
      layout > residual::STRUCT3 || (ic_dt && (!ic_use_eye || !ic_costs)))
    return (int)cudaErrorInvalidValue;
  const Lanes a{quad, quad_stride, pts, pts_stride, valid, valid_stride, R0, R0_stride, t0,
                t0_stride, fx, fy, cx, cy, W, H, edge_distance, huber, use_edge_filter, P,
                partial, evals};
  const step::State st{R, t, Rn, tn, inc, err, A, g, good, bad, sum_w, sum_unw, lam, iteration,
                       tries, active};
  const step::Params p{gn, max_iter, max_inner, n_pows, conv_eps, flat_below, step_min, success,
                       fail, lam0};
  const initcheck::Args ic{ic_dt, ic_dt_stride, ic_edge_distance, ic_use_edge_filter,
                           ic_normalized, ic_margin, ic_use_eye, ic_costs};
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t status = cudaSuccess;
#define REVO_LEVEL_LAUNCH(L)                                                      \
  if (layout == L) {                                                              \
    level_config(cluster, B, stream, &cfg, &attr);                                \
    status = cudaLaunchKernelEx(&cfg, solve_level_kernel<L>, a, st, pows, p, ic); \
  }
  REVO_LEVEL_LAYOUTS(REVO_LEVEL_LAUNCH)
#undef REVO_LEVEL_LAUNCH
  // Also clears a refusal, so that the next launch's check does not report it.
  const cudaError_t last = cudaGetLastError();
  return (int)(status != cudaSuccess ? status : last);
}

// Clusters of `cluster` blocks of the level kernel in `layout` the card
// holds at once (0: none), or a negative CUDA error.
extern "C" int revo_solve_level_clusters(int layout, int cluster, cudaStream_t) {
  if (cluster < 1 || cluster > LV_CLUSTER_MAX) return -(int)cudaErrorInvalidValue;
#define REVO_LEVEL_CLUSTERS(L) \
  if (layout == L) return max_clusters<L>(cluster);
  REVO_LEVEL_LAYOUTS(REVO_LEVEL_CLUSTERS)
#undef REVO_LEVEL_CLUSTERS
  return -(int)cudaErrorInvalidValue;
}

// An attribute of the level kernel in `layout`: 0 registers a thread, 1
// local memory bytes a thread (spills included), 2 static shared memory
// bytes a block, 3 threads a block, 4 the most threads a block the build
// admits; or a negative CUDA error.
extern "C" int revo_solve_level_attr(int layout, int which, cudaStream_t) {
#define REVO_LEVEL_ATTR(L) \
  if (layout == L) return attribute<L>(which);
  REVO_LEVEL_LAYOUTS(REVO_LEVEL_ATTR)
#undef REVO_LEVEL_ATTR
  return -(int)cudaErrorInvalidValue;
}
