// The solver's level loop on Hopper: the LM / GN step and the tracker's
// init check, each one launch for all B lanes.
//
// Neither replaces a Pallas kernel.  In the JAX package a tracking step is
// one jitted program (revo_tpu/tracker.py:32): a level's LM schedule runs
// as nested lax.while_loops on the device (revo_tpu/solver.py `lm_level`,
// `_gn_level_fixed`), whose bodies XLA fuses around each evaluation, and
// the init check is two fused `eval_cost` passes.  These kernels are the
// port's counterparts of those fused bodies, so that the lane state stays
// in device memory and the host only queues work.
//
// `revo_solver_step` runs after each `residual_lgsx` launch (lgsx.cu) in the
// two-launch loop, which the level kernel (level.cu) replaced on the main
// path and which stays for comparisons; the level kernel runs the same
// arithmetic (solver.cuh's entries) spread over a warp of each block of a
// lane's cluster (`step::step_lane_warp`).  One thread a lane
// (`step::step_lane`), one block for all B lanes (a loop of blockDim-sized rounds
// past 256 lanes).  Per live lane it reads the lane's 46 K3 outputs and its
// state, normalizes the system, takes or keeps the candidate, applies the
// lambda schedule and the iteration / tries / exit rules of `lm` or
// `gn_fixed` (revo_tpu_torch/solver.py `solver_step_ref`), and for a lane
// still live solves the damped 6x6 system by LDL^T in registers, takes the
// SE(3) exponential and composes the next candidate into Rn, tn, the
// tensors `residual_lgsx` reads next, and writes the lane's `active` byte,
// which that kernel reads to skip the lane.  A lane whose byte is 0 on entry
// is left as it is.  The block counts the live lanes into `n_live`, the one
// number the host reads (lm, one chunk late).  `init` sets a level up:
// R, t from R0, t0 (lane strides, 0 for a shared pose), the system from
// the first evaluation (lm) or the zero system at err = inf (gn_fixed),
// lambda, iteration and tries, then the same tail.
//
// `revo_init_check` evaluates TrackerNew::evalCostFunction (tracker.cpp:
// 356-393) at the identity and at (R0, t0) over a lane's coarsest-level
// cloud: floor-sampled DT values of in-bounds points that pass the edge
// filter, summed in double (square roots of integers: the sum is exact in
// any order), divided by the count where asked; it keeps the identity where
// its cost is below margin times the other (tracker.cpp:277-282) and writes
// the lane's starting pose.  One cluster of IC_CLUSTER blocks of IC_THREADS
// a lane, running initcheck.cuh's `lane_check`, the device code the level
// kernel runs inside the coarsest level's launch on the main path; this
// launch is the other routes' ("linalg", the two-launch loop).
//
// Both are bound by launch latency on the H100: a step moves ~0.5 KB a lane
// and does ~520 float operations in its start mode (~580 in a later step,
// a sin or cos counted as 20); the init check reads 13 B a point and
// one DT value (P <= 16384 points a lane, under 0.1 us of HBM time).
//
// Bits.  Each op rounds as the plain PyTorch step rounds on the card, op by
// op: every float32 operation is a __f*_rn intrinsic (no FMA contraction;
// torch runs each op as its own kernel), PyTorch's division by a Python
// number is a product with the float32 reciprocal (div_true's CPU-scalar
// path), a comparison or product with a Python number takes it as float32,
// clamp keeps NaN, `lie.matmul_fma` is (float)((double)acc + (double)a *
// (double)b) with the first product rounded once, `ops.project.fma_f32` and
// `scale_shift` go through double the same way, and sin / cos are the CUDA
// math library's sinf / cosf, what torch.sin / torch.cos call.  fail ** k
// comes from a table PyTorch fills (solver.py `_fail_table`).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "initcheck.cuh"
#include "solver.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace step;

constexpr int STEP_THREADS_MAX = 256;  // 255 registers a thread; more lanes loop

__global__ void __launch_bounds__(STEP_THREADS_MAX)
solver_step_kernel(const float* __restrict__ sums, State st, const float* __restrict__ pows,
                   const float* __restrict__ R0, int R0_stride, const float* __restrict__ t0,
                   int t0_stride, int B, int init, Params p, int* n_live) {
  int count = 0;
  for (int base = 0; base < B; base += blockDim.x) {  // uniform over the block
    const int b = base + threadIdx.x;
    const bool live =
        b < B && step_lane(lane_of(st, b), sums == nullptr ? nullptr : sums + (size_t)46 * b,
                           pows, init ? R0 + (size_t)b * R0_stride : nullptr,
                           init ? t0 + (size_t)b * t0_stride : nullptr, init, p);
    count += __syncthreads_count(live);
  }
  if (threadIdx.x == 0 && n_live != nullptr) *n_live = count;
}

constexpr int IC_THREADS = 256, IC_CLUSTER = 8;  // a lane: one cluster of 8 blocks

// One lane a cluster (grid (IC_CLUSTER, B)): initcheck.cuh's check, then
// rank 0 writes the lane's start pose.
__global__ void __launch_bounds__(IC_THREADS)
init_check_kernel(initcheck::Args a, const float* __restrict__ pts, int pts_stride,
                  const uint8_t* __restrict__ valid, int valid_stride,
                  const float* __restrict__ R0, int R0_stride, const float* __restrict__ t0,
                  int t0_stride, int P, int W, int H, float fx, float fy, float cx, float cy,
                  float* __restrict__ R_out, float* __restrict__ t_out) {
  __shared__ initcheck::Smem<IC_THREADS> sm;
  __shared__ float start[12];
  const int b = blockIdx.y;
  initcheck::lane_check<IC_THREADS>(a, b, pts + (size_t)b * pts_stride,
                                    valid + (size_t)b * valid_stride, P,
                                    R0 + (size_t)b * R0_stride, t0 + (size_t)b * t0_stride, W, H,
                                    fx, fy, cx, cy, sm, start);
  if (cg::this_cluster().block_rank() == 0) {
    if (threadIdx.x < 9) R_out[9 * b + threadIdx.x] = start[threadIdx.x];
    else if (threadIdx.x < 12) t_out[3 * b + threadIdx.x - 9] = start[threadIdx.x];
  }
  cg::this_cluster().sync();  // no block leaves while another reads its part
}

}  // namespace

// B lanes.  sums: (B, 46) K3 output rows (unread for gn_fixed's start);
// the State pointers: solver.py LevelState's tensors, contiguous; n_live:
// one int32 or null; pows: n_pows float32; R0 / t0 (with lane strides in
// elements, 0 for a shared pose) only when init is 1.
extern "C" int revo_solver_step(const float* sums, float* R, float* t, float* Rn, float* tn,
                                float* inc, float* err, float* A, float* g, int* good, int* bad,
                                float* sum_w, float* sum_unw, float* lam, int* iteration,
                                int* tries, uint8_t* active, int* n_live, const float* pows,
                                int n_pows, const float* R0, int R0_stride, const float* t0,
                                int t0_stride, int B, int init, int gn, int max_iter,
                                int max_inner, float conv_eps, float flat_below, float step_min,
                                float success, float fail, float lam0, cudaStream_t stream) {
  if (B <= 0 || n_pows <= 0) return (int)cudaErrorInvalidValue;
  const State st{R, t, Rn, tn, inc, err, A, g, good, bad, sum_w, sum_unw, lam, iteration, tries,
                 active};
  const Params p{gn, max_iter, max_inner, n_pows, conv_eps, flat_below, step_min, success,
                 fail, lam0};
  const int threads = B < STEP_THREADS_MAX ? (B + 31) / 32 * 32 : STEP_THREADS_MAX;
  solver_step_kernel<<<1, threads, 0, stream>>>(sums, st, pows, R0, R0_stride, t0, t0_stride,
                                                B, init, p, n_live);
  return (int)cudaGetLastError();
}

// B lanes; dt: the coarsest level's (H, W, 3) structure of each lane (lane
// stride in elements, 0 for a shared one; channel 2 is the DT); pts (P, 3)
// and valid (P,) likewise; R0 / t0 with lane strides; outputs R (B, 3, 3),
// t (B, 3), use_eye (B,) bytes and costs (B, 2) (identity, pose).
extern "C" int revo_init_check(const float* dt, int dt_stride, const float* pts, int pts_stride,
                               const uint8_t* valid, int valid_stride, const float* R0,
                               int R0_stride, const float* t0, int t0_stride, int P, int B,
                               int W, int H, float fx, float fy, float cx, float cy,
                               float edge_distance, int use_edge_filter, int normalized,
                               float margin, float* R, float* t, uint8_t* use_eye, float* costs,
                               cudaStream_t stream) {
  if (B <= 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  const initcheck::Args a{dt, dt_stride, edge_distance, use_edge_filter, normalized, margin,
                          use_eye, costs};
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(IC_CLUSTER, B, 1);
  cfg.blockDim = dim3(IC_THREADS, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = IC_CLUSTER;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t status =
      cudaLaunchKernelEx(&cfg, init_check_kernel, a, pts, pts_stride, valid, valid_stride, R0,
                         R0_stride, t0, t0_stride, P, W, H, fx, fy, cx, cy, R, t);
  const cudaError_t last = cudaGetLastError();
  return (int)(status != cudaSuccess ? status : last);
}
