// Device code of the solver's step, shared by `revo_solver_step`
// (solver.cu) and the level kernel (level.cu), so that both compile the same
// arithmetic: the lane state and schedule, the normalisation of a lane's K3
// outputs, the accept / lambda / exit rules of lm and gn_fixed, the damped
// LDL^T solve, exp and compose (solver.cu's note on the bits: every float32
// operation is a __f*_rn intrinsic, so inlining and register pressure do not
// move them).
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace step {

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

// One lane's step (`solver_step_ref` / `solver_start_ref`) from its 46 K3
// outputs `row` (unread in gn_fixed's start); returns whether the lane
// evaluates a candidate next.
__device__ inline bool step_lane(int b, const float* row, const State& st,
                                 const float* __restrict__ pows, const float* __restrict__ R0,
                                 int R0_stride, const float* __restrict__ t0, int t0_stride,
                                 int init, const Params& p) {
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
      normalize(row, sys);
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
    normalize(row, sn);
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

}  // namespace step
