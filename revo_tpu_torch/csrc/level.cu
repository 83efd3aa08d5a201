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
// A block is LV_GROUPS groups of 128 threads.  Per evaluation:
//   1. the residual pass in exactly `residual_lgsx`'s partition: virtual
//      block j holds points [128 j, 128 j + 128), and group g of rank r
//      takes j = r LV_GROUPS + g, then j + C LV_GROUPS, ...; each virtual
//      block forms its partial row with lgsx::group_row (block_row's
//      arithmetic at a named barrier of its group) in the lane's global
//      scratch, the rows `residual_lgsx`'s blocks write;
//   2. cluster.sync(), which orders those rows (release / acquire at cluster
//      scope; rank 0 reads them past L1);
//   3. rank 0 sums the rows in virtual-block order (lgsx::sum_rows, the
//      order of `residual_lgsx`'s last block) into the lane's 46 outputs in
//      shared memory;
//   4. one thread of rank 0 runs step::step_lane, `revo_solver_step`'s code,
//      on the lane's state in device memory;
//   5. cluster.sync(), which orders the state's writes;
//   6. every block reads the lane's active byte and the next candidate (past
//      L1); the lane leaves once the byte is 0 or at the cap, max_iter *
//      max_inner evaluations after the start for lm, max_iter for gn_fixed.
// The level's start is inside too: lm evaluates (R0, t0) and runs the step's
// start mode; gn_fixed runs the start mode alone.  Each lane also gets the
// count of evaluations it ran (lm's start included).
//
// Bits.  The pass, the reduction order and the step are those of the
// two-launch loop, compiled from the same device code (residual.cuh,
// lgsx.cuh, solver.cuh), and the steps that loop runs after a lane stopped
// change nothing, so every field of the final state equals the loop's.  The
// cluster size only moves virtual blocks between SMs: it changes no bit.
//
// Bound on the H100: latency.  An evaluation reads 13 B a point and one
// table row a point inside the image (~0.3 MB at P = 16384, ~0.1 us of HBM
// time, from L2 after the first), does ~166 operations a point and ~580 in
// the step; the dependent chain of pass, barrier, ordered sum, one thread's
// step and barrier sets its time.  Registers: the step needs many and a
// kernel's count is the largest over its code, so __launch_bounds__ caps a
// thread at 65536 / LV_THREADS and the one step thread may spill.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  float* partial;  // max(ceil(P / 128), 1) rows of lgsx::ROW floats a lane
  int* evals;      // (B,) evaluations each lane ran
};

template <int L>
__global__ void __launch_bounds__(LV_THREADS, 1)
solve_level_kernel(Lanes a, step::State st, const float* __restrict__ pows, step::Params p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  const int b = blockIdx.y;  // the lane
  const int tid = threadIdx.x, group = tid / VB_POINTS, gtid = tid % VB_POINTS;
  const bool lead = rank == 0 && tid == 0;  // the thread that steps
  const int nb = max((a.P + VB_POINTS - 1) / VB_POINTS, 1);
  const float* pts = a.pts + (size_t)b * a.pts_stride;
  const uint8_t* valid = a.valid + (size_t)b * a.valid_stride;
  float* partial = a.partial + (size_t)b * nb * lgsx::ROW;
  const size_t row0 = (size_t)b * a.quad_stride;
  __shared__ float stage[lgsx::CHUNK * lgsx::ROW];
  __shared__ float pose[12];  // R, t of the evaluation
  __shared__ float sums[46];  // rank 0: the evaluation's outputs

  // One evaluation at `pose`, then the sums on rank 0 (steps 1-3).
  auto evaluate = [&]() {
    float R[9], t[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = pose[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = pose[9 + k];
    for (int j = rank * LV_GROUPS + group; j < nb; j += C * LV_GROUPS) {
      float acc[NF];
#pragma unroll
      for (int k = 0; k < NF; ++k) acc[k] = 0.0f;
      int n_good = 0, n_bad = 0;
      residual::point_pass<L>(a.quad, row0, pts, valid, j * VB_POINTS + gtid, a.P, R, t, a.fx,
                              a.fy, a.cx, a.cy, a.W, a.H, a.edge_distance, a.huber,
                              a.use_edge_filter, acc, n_good, n_bad);
      int cnt[2] = {n_good, n_bad};
      lgsx::group_row<VB_POINTS, NF, 2>(acc, cnt, stage + group * (VB_POINTS / 32) * lgsx::ROW,
                                        partial + (size_t)j * lgsx::ROW, gtid, 1 + group);
    }
    cluster.sync();
    if (rank == 0) {
      float fs;
      int is;
      lgsx::sum_rows<LV_THREADS, NF, 2>(partial, nb, stage, fs, is);
      residual::store_outputs(sums, tid, fs, is);
      __syncthreads();
    }
  };

  int n = 0;
  if (!p.gn) {  // lm's start evaluates (R0, t0)
    if (tid < 9) pose[tid] = a.R0[(size_t)b * a.R0_stride + tid];
    else if (tid < 12) pose[tid] = a.t0[(size_t)b * a.t0_stride + tid - 9];
    __syncthreads();
    evaluate();
    n = 1;
  }
  if (lead) step::step_lane(b, sums, st, pows, a.R0, a.R0_stride, a.t0, a.t0_stride, 1, p);
  cluster.sync();
  const int cap = p.gn ? p.max_iter : p.max_iter * p.max_inner;
  for (int k = 0; k < cap; ++k) {
    if (!*reinterpret_cast<volatile const uint8_t*>(st.active + b)) break;  // uniform
    if (tid < 9) pose[tid] = __ldcg(st.Rn + 9 * b + tid);
    else if (tid < 12) pose[tid] = __ldcg(st.tn + 3 * b + tid - 9);
    __syncthreads();
    evaluate();
    ++n;
    if (lead) step::step_lane(b, sums, st, pows, a.R0, a.R0_stride, a.t0, a.t0_stride, 0, p);
    cluster.sync();
  }
  if (lead) a.evals[b] = n;
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
// strides; partial: max(ceil(P / 128), 1) rows of 32 floats a lane; the
// State pointers: solver.py LevelState's tensors, contiguous, written with
// the level's final state (nothing read from them first); evals: (B,) int32;
// pows: n_pows float32 (solver.py `_fail_table`); cluster: blocks a lane, 1
// to 8.  Returns the launch's CUDA status (a cluster shape the card cannot
// hold is refused there); a layout or cluster out of range returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int revo_solve_level(
    const void* quad, int layout, int quad_stride, const float* pts, int pts_stride,
    const uint8_t* valid, int valid_stride, const float* R0, int R0_stride, const float* t0,
    int t0_stride, float fx, float fy, float cx, float cy, int W, int H, float edge_distance,
    float huber, int use_edge_filter, int P, int B, float* partial, float* R, float* t, float* Rn,
    float* tn, float* inc, float* err, float* A, float* g, int* good, int* bad, float* sum_w,
    float* sum_unw, float* lam, int* iteration, int* tries, uint8_t* active, int* evals,
    const float* pows, int n_pows, int gn, int max_iter, int max_inner, float conv_eps,
    float flat_below, float step_min, float success, float fail, float lam0, int cluster,
    cudaStream_t stream) {
  if (B <= 0) return 0;
  if (B > 65535 || n_pows <= 0 || cluster < 1 || cluster > LV_CLUSTER_MAX || layout < 0 ||
      layout > residual::STRUCT3)
    return (int)cudaErrorInvalidValue;
  const Lanes a{quad, quad_stride, pts, pts_stride, valid, valid_stride, R0, R0_stride, t0,
                t0_stride, fx, fy, cx, cy, W, H, edge_distance, huber, use_edge_filter, P,
                partial, evals};
  const step::State st{R, t, Rn, tn, inc, err, A, g, good, bad, sum_w, sum_unw, lam, iteration,
                       tries, active};
  const step::Params p{gn, max_iter, max_inner, n_pows, conv_eps, flat_below, step_min, success,
                       fail, lam0};
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t status = cudaSuccess;
#define REVO_LEVEL_LAUNCH(L)                                                    \
  if (layout == L) {                                                            \
    level_config(cluster, B, stream, &cfg, &attr);                              \
    status = cudaLaunchKernelEx(&cfg, solve_level_kernel<L>, a, st, pows, p);   \
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
