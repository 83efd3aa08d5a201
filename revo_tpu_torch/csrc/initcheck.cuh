// Device code of the tracker's init check, shared by `revo_init_check`
// (solver.cu) and the level kernel (level.cu), which runs it inside the
// coarsest level's launch: one design of the check, not two.
//
// TrackerNew::evalCostFunction (tracker.cpp:356-393) at the identity and at
// (R0, t0) over a lane's coarsest-level cloud: floor-sampled DT values of
// in-bounds points that pass the edge filter, summed in double, divided by
// the count where asked; the lane keeps the identity where its cost is
// below margin times the other (tracker.cpp:277-282).  The lane's C blocks
// of NT threads share its points (point p to thread p mod (C NT)); each
// block sums its threads' partials (shuffles, then the warps), and every
// block adds the C blocks' partials, read over DSMEM, so that every block
// knows the choice.  The DT values are square roots of integers below 2^10
// and P <= 2^14, so every partial sum is exact in double and no order of
// the reduction changes a bit (solver.py `eval_cost`).
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "solver.cuh"

namespace initcheck {

namespace cg = cooperative_groups;

struct Args {  // the check of B lanes (solver.py InitCheckBlock), DT channel of the structure
  const float* dt;  // (H, W, 3) a lane, lane stride dt_stride; null: no check
  int dt_stride;
  float edge_distance;
  int use_edge_filter, normalized;
  float margin;
  uint8_t* use_eye;  // (B,)
  float* costs;      // (B, 2): identity, (R0, t0)
};

// One point's floor-sampled cost at (R, t) (`solver.eval_cost`): whether it
// counts, and its DT value.
__device__ __forceinline__ bool point_cost(const float* R, const float* t, float x, float y,
                                           float z, const float* __restrict__ dt, int W, int H,
                                           float fx, float fy, float cx, float cy,
                                           float edge_distance, int use_edge_filter,
                                           float& res) {
  using step::add;
  using step::dvd;
  using step::mul;
  float w[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {  // ops.project.apply_rt_cols, fma_f32 through double
    float acc = mul(R[3 * r + 1], y);
    acc = (float)__dadd_rn(__dmul_rn((double)R[3 * r], (double)x), (double)acc);
    acc = (float)__dadd_rn(__dmul_rn((double)R[3 * r + 2], (double)z), (double)acc);
    w[r] = add(acc, t[r]);
  }
  const float pz = w[2] == 0.0f ? (float)1e-12 : w[2];
  const float u = (float)__dadd_rn(__dmul_rn((double)dvd(w[0], pz), (double)fx), (double)cx);
  const float v = (float)__dadd_rn(__dmul_rn((double)dvd(w[1], pz), (double)fy), (double)cy);
  const bool inb = u >= 0.0f && v >= 0.0f && u < (float)W && v < (float)H;
  float fu = floorf(u), fv = floorf(v);
  fu = fminf(fmaxf(isnan(fu) ? 0.0f : fu, 0.0f), (float)(W - 1));
  fv = fminf(fmaxf(isnan(fv) ? 0.0f : fv, 0.0f), (float)(H - 1));
  res = dt[((size_t)(int)fv * W + (int)fu) * 3 + 2];  // the structure's dt channel
  return inb && (!use_edge_filter || res <= edge_distance);
}

// Shared memory of one block's part.
template <int NT>
struct Smem {
  double warps[NT / 32][4];
  double part[4];  // this block's sums: cost and count at the identity, then at (R0, t0)
};

// Lane b's check over its cluster, in every block of it: returns whether
// the identity replaces (R0, t0) (lane pointers, 9 and 3 floats) and has
// threads < 12 of every block write the start pose, R then t, to `start`
// (shared memory); rank 0 writes the lane's use_eye and costs.  pts (P, 3)
// and valid (P,) are the lane's.  Ends with the block synchronised.
template <int NT>
__device__ bool lane_check(const Args& a, int b, const float* __restrict__ pts,
                           const uint8_t* __restrict__ valid, int P, const float* R0,
                           const float* t0, int W, int H, float fx, float fy, float cx, float cy,
                           Smem<NT>& sm, float* start) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const float* dt = a.dt + (size_t)b * a.dt_stride;
  float R[9], t[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = R0[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = t0[k];
  const float I[9] = {1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f};
  const float Z[3] = {0.0f, 0.0f, 0.0f};
  double s[4] = {0.0, 0.0, 0.0, 0.0};  // counts too: exact in double
  for (int p = rank * NT + tid; p < P; p += C * NT) {
    if (!valid[p]) continue;  // eval_cost's `inb & valid`: the point adds nothing
    const float x = pts[3 * p], y = pts[3 * p + 1], z = pts[3 * p + 2];
    float res;
    if (point_cost(I, Z, x, y, z, dt, W, H, fx, fy, cx, cy, a.edge_distance, a.use_edge_filter,
                   res)) {
      s[0] += (double)res;
      s[1] += 1.0;
    }
    if (point_cost(R, t, x, y, z, dt, W, H, fx, fy, cx, cy, a.edge_distance, a.use_edge_filter,
                   res)) {
      s[2] += (double)res;
      s[3] += 1.0;
    }
  }
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s[k] += __shfl_down_sync(0xffffffffu, s[k], o);
    if (lane == 0) sm.warps[warp][k] = s[k];
  }
  __syncthreads();
  if (tid < 4) {
    double v = 0.0;
    for (int w = 0; w < NT / 32; ++w) v += sm.warps[w][tid];
    sm.part[tid] = v;
  }
  cluster.sync();  // every block's part is written
  double tot[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) tot[k] = 0.0;
  for (int r = 0; r < C; ++r) {
    const double* part = cluster.map_shared_rank(sm.part, r);
#pragma unroll
    for (int k = 0; k < 4; ++k) tot[k] += part[k];
  }
  float c_eye = (float)tot[0], c_pose = (float)tot[2];
  if (a.normalized) {
    c_eye = step::dvd(c_eye, (float)fmax(tot[1], 1.0));
    c_pose = step::dvd(c_pose, (float)fmax(tot[3], 1.0));
  }
  const bool eye = c_eye < step::mul(a.margin, c_pose);
  if (tid < 9) start[tid] = eye ? I[tid] : R[tid];
  else if (tid < 12) start[tid] = eye ? 0.0f : t[tid - 9];
  if (rank == 0 && tid == 0) {
    a.use_eye[b] = eye ? 1 : 0;
    a.costs[2 * b] = c_eye;
    a.costs[2 * b + 1] = c_pose;
  }
  __syncthreads();
  return eye;
}

}  // namespace initcheck
