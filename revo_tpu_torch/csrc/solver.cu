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
// `revo_solver_step` runs after each `residual_lgsx` launch (lgsx.cu).  One
// thread a lane, one block for all B lanes (a loop of blockDim-sized rounds
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
// the lane's starting pose.  One block of IC_THREADS a lane.
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
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp(x, min=m): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float m) { return isnan(x) ? x : fmaxf(x, m); }

// One entry of `lie.matmul_fma`: the first product rounded to float32,
// then each further product added in double (exact) and the sum rounded
// to double, then to float32.
__device__ __forceinline__ float fma_chain3(float a0, float b0, float a1, float b1, float a2,
                                            float b2) {
  float acc = (float)__dmul_rn((double)a0, (double)b0);
  acc = (float)__dadd_rn((double)acc, __dmul_rn((double)a1, (double)b1));
  return (float)__dadd_rn((double)acc, __dmul_rn((double)a2, (double)b2));
}

// C = A B, 3x3 row-major, as `lie.matmul_fma`.
__device__ __forceinline__ void matmul3(const float* A, const float* B, float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = fma_chain3(A[3 * i], B[j], A[3 * i + 1], B[3 + j], A[3 * i + 2], B[6 + j]);
}

// A v as `lie.matvec`: (A_i2 v2 + A_i1 v1) + A_i0 v0, each op rounded.
__device__ __forceinline__ float matvec_row(const float* A, int i, const float* v) {
  return add(add(mul(A[3 * i + 2], v[2]), mul(A[3 * i + 1], v[1])), mul(A[3 * i], v[0]));
}

// `lie.exp_se3` of xi = [upsilon, omega]: R and t = V upsilon.
__device__ __forceinline__ void exp_se3(const float* xi, float* R, float* t) {
  const float w0 = xi[3], w1 = xi[4], w2 = xi[5];
  const float th2 = add(add(mul(w0, w0), mul(w1, w1)), mul(w2, w2));  // lie._sq_norm3
  const float th = __fsqrt_rn(th2);
  const bool small = th2 < (float)1e-8;
  const float ts = small ? 1.0f : th;
  const float sn = sinf(ts), cs = cosf(ts);
  // theta_sq / 6.0 etc.: PyTorch multiplies by the float32 reciprocal.
  const float a = small ? sub(1.0f, mul(th2, 1.0f / 6.0f)) : dvd(sn, ts);
  const float b = small ? sub(0.5f, mul(th2, 1.0f / 24.0f)) : dvd(sub(1.0f, cs), mul(ts, ts));
  const float c = small ? sub((float)(1.0 / 6.0), mul(th2, 1.0f / 120.0f))
                        : dvd(sub(ts, sn), mul(mul(ts, ts), ts));
  const float W[9] = {0.0f, -w2, w1, w2, 0.0f, -w0, -w1, w0, 0.0f};
  float W2[9];
  matmul3(W, W, W2);
  float V[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float eye = (k % 4 == 0) ? 1.0f : 0.0f;
    R[k] = add(add(eye, mul(a, W[k])), mul(b, W2[k]));
    V[k] = add(add(eye, mul(b, W[k])), mul(c, W2[k]));
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = matvec_row(V, i, xi);
}

// `solver.solve6_ldlt` of the damped system A + diag(diag(A) lambda)
// (`_damped_step`), then a non-finite increment to 0.
__device__ __forceinline__ void damped_solve(const float* A, const float* g, float lam,
                                             float* x) {
  float L[6][6], d[6], y[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = add(A[7 * j], mul(A[7 * j], lam));
#pragma unroll
    for (int k = 0; k < j; ++k) s = sub(s, mul(mul(L[j][k], L[j][k]), d[k]));
    d[j] = fabsf(s) < (float)1e-30 ? (float)1e-30 : s;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float t = add(A[6 * i + j], 0.0f);  // off the diagonal diag_embed adds +0
#pragma unroll
      for (int k = 0; k < j; ++k) t = sub(t, mul(mul(L[i][k], L[j][k]), d[k]));
      L[i][j] = dvd(t, d[j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float t = g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) t = sub(t, mul(L[i][k], y[k]));
    y[i] = t;
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float t = dvd(y[i], d[i]);
#pragma unroll
    for (int k = i + 1; k < 6; ++k) t = sub(t, mul(L[k][i], x[k]));
    x[i] = t;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) x[i] = isfinite(x[i]) ? x[i] : 0.0f;
}

// `solver.sq_norm6`: ((p0 + p4) + (p1 + p5)) + (p2 + p3).
__device__ __forceinline__ float sq_norm6(const float* v) {
  float p[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) p[k] = mul(v[k], v[k]);
  return add(add(add(p[0], p[4]), add(p[1], p[5])), add(p[2], p[3]));
}

// One lane's normalized system (`solver._normalize_sums`).
struct System {
  float err, A[36], g[6], sum_w, sum_unw;
  int good, bad;
};

__device__ __forceinline__ void normalize(const float* row, System& s) {
  const int good = reinterpret_cast<const int*>(row)[44];
  const float n = (float)max(good, 1);
  s.sum_w = row[42];
  s.sum_unw = row[43];
  s.good = good;
  s.bad = reinterpret_cast<const int*>(row)[45];
  s.err = dvd(s.sum_w, n);
#pragma unroll
  for (int k = 0; k < 36; ++k) s.A[k] = dvd(row[k], n);
#pragma unroll
  for (int k = 0; k < 6; ++k) s.g[k] = dvd(row[36 + k], n);
}

struct State {  // solver.py LevelState: one pointer a field, B lanes each
  float *R, *t, *Rn, *tn, *inc, *err, *A, *g;
  int *good, *bad;
  float *sum_w, *sum_unw, *lam;
  int *iteration, *tries;
  uint8_t* active;
};

struct Params {  // solver.py StepParams
  int gn, max_iter, max_inner, n_pows;
  float conv_eps, flat_below, step_min, success, fail, lam0;
};

__device__ __forceinline__ void load_system(const State& st, int b, System& s) {
  s.err = st.err[b];
#pragma unroll
  for (int k = 0; k < 36; ++k) s.A[k] = st.A[36 * b + k];
#pragma unroll
  for (int k = 0; k < 6; ++k) s.g[k] = st.g[6 * b + k];
  s.good = st.good[b];
  s.bad = st.bad[b];
  s.sum_w = st.sum_w[b];
  s.sum_unw = st.sum_unw[b];
}

__device__ __forceinline__ void store_system(const State& st, int b, const System& s) {
  st.err[b] = s.err;
#pragma unroll
  for (int k = 0; k < 36; ++k) st.A[36 * b + k] = s.A[k];
#pragma unroll
  for (int k = 0; k < 6; ++k) st.g[6 * b + k] = s.g[k];
  st.good[b] = s.good;
  st.bad[b] = s.bad;
  st.sum_w[b] = s.sum_w;
  st.sum_unw[b] = s.sum_unw;
}

// One lane's step (`solver_step_ref` / `solver_start_ref`); returns
// whether the lane evaluates a candidate next.
__device__ bool step_lane(int b, const float* __restrict__ sums, const State& st,
                          const float* __restrict__ pows, const float* __restrict__ R0,
                          int R0_stride, const float* __restrict__ t0, int t0_stride, int init,
                          const Params& p) {
  float R[9], t[3], Rn[9], tn[3], inc[6], lam;
  int it, tries;
  System sys;
  bool live;
  if (init) {
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = Rn[k] = R0[(size_t)b * R0_stride + k];
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = tn[k] = t0[(size_t)b * t0_stride + k];
#pragma unroll
    for (int k = 0; k < 6; ++k) inc[k] = 0.0f;
    if (p.gn) {  // the zero system at err = inf: iteration 0 evaluates (R0, t0)
      sys.err = INFINITY;
#pragma unroll
      for (int k = 0; k < 36; ++k) sys.A[k] = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k) sys.g[k] = 0.0f;
      sys.good = sys.bad = 0;
      sys.sum_w = sys.sum_unw = 0.0f;
    } else {
      normalize(sums + (size_t)46 * b, sys);
    }
    lam = p.lam0;
    it = tries = 0;
    live = it < p.max_iter;
  } else {
    if (!st.active[b]) return false;
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = st.R[9 * b + k], Rn[k] = st.Rn[9 * b + k];
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = st.t[3 * b + k], tn[k] = st.tn[3 * b + k];
#pragma unroll
    for (int k = 0; k < 6; ++k) inc[k] = st.inc[6 * b + k];
    load_system(st, b, sys);
    lam = st.lam[b];
    it = st.iteration[b];
    tries = st.tries[b];

    System sn;
    normalize(sums + (size_t)46 * b, sn);
    const float ratio = dvd(sn.err, clamp_min(sys.err, (float)1e-30));
    const bool accept = sn.err < sys.err;
    const bool small = !(sq_norm6(inc) > p.step_min);
    if (accept) {
#pragma unroll
      for (int k = 0; k < 9; ++k) R[k] = Rn[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) t[k] = tn[k];
      sys = sn;
    }
    if (p.gn) {
      tries = accept ? 0 : tries + 1;
      const float pw = pows[min(max(tries, 0), p.n_pows - 1)];
      bool done = false;
      if (it > 0) {  // iteration 0 evaluated the start pose: no lambda or exit rule
        lam = accept ? mul(lam, p.success)
                     : (lam < (float)0.2 ? clamp_min(mul(lam, p.fail), (float)0.2) : mul(lam, pw));
        done = accept ? ratio > p.conv_eps : (small || ratio < p.flat_below);
      }
      it += 1;
      live = !done && it < p.max_iter;
    } else {
      const float pw = pows[min(max(tries, 0), p.n_pows - 1)];
      lam = accept ? (lam <= (float)0.2 ? 0.0f : mul(lam, p.success))
                   : (lam == 0.0f ? (float)0.2 : mul(lam, pw));
      if ((accept && ratio > p.conv_eps) || (!accept && small)) it = p.max_iter;
      if (accept || small || tries >= p.max_inner) {
        it = min(it + 1, p.max_iter);
        tries = 0;
      }
      live = it < p.max_iter;
    }
  }
  if (live) {  // the next candidate: one more try, the damped solve, exp, compose
    if (!p.gn) tries += 1;
    damped_solve(sys.A, sys.g, lam, inc);
    float dR[9], dt[3];
    exp_se3(inc, dR, dt);
    matmul3(dR, R, Rn);
#pragma unroll
    for (int i = 0; i < 3; ++i) tn[i] = add(matvec_row(dR, i, t), dt[i]);
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) st.R[9 * b + k] = R[k], st.Rn[9 * b + k] = Rn[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) st.t[3 * b + k] = t[k], st.tn[3 * b + k] = tn[k];
#pragma unroll
  for (int k = 0; k < 6; ++k) st.inc[6 * b + k] = inc[k];
  store_system(st, b, sys);
  st.lam[b] = lam;
  st.iteration[b] = it;
  st.tries[b] = tries;
  st.active[b] = live ? 1 : 0;
  return live;
}

constexpr int STEP_THREADS_MAX = 256;  // 255 registers a thread; more lanes loop

__global__ void __launch_bounds__(STEP_THREADS_MAX)
solver_step_kernel(const float* __restrict__ sums, State st, const float* __restrict__ pows,
                   const float* __restrict__ R0, int R0_stride, const float* __restrict__ t0,
                   int t0_stride, int B, int init, Params p, int* n_live) {
  int count = 0;
  for (int base = 0; base < B; base += blockDim.x) {  // uniform over the block
    const int b = base + threadIdx.x;
    const bool live =
        b < B && step_lane(b, sums, st, pows, R0, R0_stride, t0, t0_stride, init, p);
    count += __syncthreads_count(live);
  }
  if (threadIdx.x == 0 && n_live != nullptr) *n_live = count;
}

constexpr int IC_THREADS = 256;

// One point's floor-sampled cost at (R, t) (`solver.eval_cost`): whether it
// counts, and its DT value.
__device__ __forceinline__ bool point_cost(const float* R, const float* t, float x, float y,
                                           float z, const float* __restrict__ dt, int W, int H,
                                           float fx, float fy, float cx, float cy,
                                           float edge_distance, int use_edge_filter,
                                           float& res) {
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

__device__ __forceinline__ double block_sum(double v, double* stage) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) stage[warp] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int k = 0; k < IC_THREADS / 32; ++k) s += stage[k];
  return s;  // thread 0's
}

__global__ void __launch_bounds__(IC_THREADS)
init_check_kernel(const float* __restrict__ dt, int dt_stride, const float* __restrict__ pts,
                  int pts_stride, const uint8_t* __restrict__ valid, int valid_stride,
                  const float* __restrict__ R0, int R0_stride, const float* __restrict__ t0,
                  int t0_stride, int P, int W, int H, float fx, float fy, float cx, float cy,
                  float edge_distance, int use_edge_filter, int normalized, float margin,
                  float* __restrict__ R_out, float* __restrict__ t_out,
                  uint8_t* __restrict__ use_eye, float* __restrict__ costs) {
  const size_t b = blockIdx.x;
  dt += b * dt_stride;
  pts += b * pts_stride;
  valid += b * valid_stride;
  float R[9], t[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = R0[b * R0_stride + k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = t0[b * t0_stride + k];
  const float I[9] = {1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f};
  const float Z[3] = {0.0f, 0.0f, 0.0f};
  double s_eye = 0.0, s_pose = 0.0;
  double n_eye = 0.0, n_pose = 0.0;  // counts, exact in double
  for (int p = threadIdx.x; p < P; p += IC_THREADS) {
    if (!valid[p]) continue;  // eval_cost's `inb & valid`: the point adds nothing
    const float x = pts[3 * p], y = pts[3 * p + 1], z = pts[3 * p + 2];
    float res;
    if (point_cost(I, Z, x, y, z, dt, W, H, fx, fy, cx, cy, edge_distance, use_edge_filter,
                   res)) {
      s_eye += (double)res;
      n_eye += 1.0;
    }
    if (point_cost(R, t, x, y, z, dt, W, H, fx, fy, cx, cy, edge_distance, use_edge_filter,
                   res)) {
      s_pose += (double)res;
      n_pose += 1.0;
    }
  }
  __shared__ double stage[IC_THREADS / 32];
  s_eye = block_sum(s_eye, stage);
  s_pose = block_sum(s_pose, stage);
  n_eye = block_sum(n_eye, stage);
  n_pose = block_sum(n_pose, stage);
  if (threadIdx.x != 0) return;
  float c_eye = (float)s_eye, c_pose = (float)s_pose;
  if (normalized) {
    c_eye = dvd(c_eye, (float)fmax(n_eye, 1.0));
    c_pose = dvd(c_pose, (float)fmax(n_pose, 1.0));
  }
  const bool eye = c_eye < mul(margin, c_pose);
#pragma unroll
  for (int k = 0; k < 9; ++k) R_out[9 * b + k] = eye ? I[k] : R[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t_out[3 * b + k] = eye ? 0.0f : t[k];
  use_eye[b] = eye ? 1 : 0;
  costs[2 * b] = c_eye;
  costs[2 * b + 1] = c_pose;
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
  init_check_kernel<<<B, IC_THREADS, 0, stream>>>(
      dt, dt_stride, pts, pts_stride, valid, valid_stride, R0, R0_stride, t0, t0_stride, P, W,
      H, fx, fy, cx, cy, edge_distance, use_edge_filter, normalized, margin, R, t, use_eye,
      costs);
  return (int)cudaGetLastError();
}
