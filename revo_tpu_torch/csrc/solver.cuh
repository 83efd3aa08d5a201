// Device code of the solver's step, shared by `revo_solver_step`
// (solver.cu) and the level kernel (level.cu), so that both compile the same
// arithmetic: the lane state and schedule, the normalisation of a lane's K3
// outputs, the accept / lambda / exit rules of lm and gn_fixed, the damped
// LDL^T solve, exp and compose (solver.cu's note on the bits: every float32
// operation is a __f*_rn intrinsic, so inlining and register pressure do not
// move them).
//
// The arithmetic is written entry by entry (`normalized_entry`,
// `ldlt_pivot`, `ldlt_entry`, `ldlt_solve`, `exp_coeffs`, `exp_entry`,
// `dot3r`, `fma_chain3`, `rules`), and two steps call the same entries:
// `step_lane`, one thread a lane (revo_solver_step), and `step_lane_warp`,
// the 32 lanes of one warp a lane (the level kernel), which gives each
// lane some of the entries and passes what another lane needs by shuffle.
// Each output sees the same operations in the same order in both, so both
// give the same bits.
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

// One row r of a 3x3 matrix times v as `lie.matvec`: (r2 v2 + r1 v1) + r0
// v0, each op rounded.
__device__ __forceinline__ float dot3r(const float* r, const float* v) {
  return add(add(mul(r[2], v[2]), mul(r[1], v[1])), mul(r[0], v[0]));
}

__device__ __forceinline__ float matvec_row(const float* A, int i, const float* v) {
  return dot3r(A + 3 * i, v);
}

// `lie.exp_se3`'s scalars at omega = xi[3..5]: R = I + a W + b W^2,
// V = I + b W + c W^2.
__device__ __forceinline__ void exp_coeffs(const float* xi, float& a, float& b, float& c) {
  const float w0 = xi[3], w1 = xi[4], w2 = xi[5];
  const float th2 = add(add(mul(w0, w0), mul(w1, w1)), mul(w2, w2));  // lie._sq_norm3
  const float th = __fsqrt_rn(th2);
  const bool small = th2 < (float)1e-8;
  const float ts = small ? 1.0f : th;
  const float sn = sinf(ts), cs = cosf(ts);
  // theta_sq / 6.0 etc.: PyTorch multiplies by the float32 reciprocal.
  a = small ? sub(1.0f, mul(th2, 1.0f / 6.0f)) : dvd(sn, ts);
  b = small ? sub(0.5f, mul(th2, 1.0f / 24.0f)) : dvd(sub(1.0f, cs), mul(ts, ts));
  c = small ? sub((float)(1.0 / 6.0), mul(th2, 1.0f / 120.0f))
            : dvd(sub(ts, sn), mul(mul(ts, ts), ts));
}

// W = hat(omega), row-major.
__device__ __forceinline__ void hat(const float* xi, float* W) {
  const float w0 = xi[3], w1 = xi[4], w2 = xi[5];
  W[0] = 0.0f, W[1] = -w2, W[2] = w1;
  W[3] = w2, W[4] = 0.0f, W[5] = -w0;
  W[6] = -w1, W[7] = w0, W[8] = 0.0f;
}

// Entry k of R and of V (W^2's entry k as `lie.matmul_fma`).
__device__ __forceinline__ void exp_entry(const float* W, int k, float a, float b, float c,
                                          float& Rk, float& Vk) {
  const int i = k / 3, j = k % 3;
  const float W2k = fma_chain3(W[3 * i], W[j], W[3 * i + 1], W[3 + j], W[3 * i + 2], W[6 + j]);
  const float eye = (k % 4 == 0) ? 1.0f : 0.0f;
  Rk = add(add(eye, mul(a, W[k])), mul(b, W2k));
  Vk = add(add(eye, mul(b, W[k])), mul(c, W2k));
}

// `lie.exp_se3` of xi = [upsilon, omega]: R and t = V upsilon.
__device__ __forceinline__ void exp_se3(const float* xi, float* R, float* t) {
  float a, b, c, W[9], V[9];
  exp_coeffs(xi, a, b, c);
  hat(xi, W);
#pragma unroll
  for (int k = 0; k < 9; ++k) exp_entry(W, k, a, b, c, R[k], V[k]);
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = matvec_row(V, i, xi);
}

// `solver.solve6_ldlt` of the damped system A + diag(diag(A) lambda)
// (`_damped_step`), entry by entry: the pivot d[j] from row j of L (k < j)
// and d, and L[i][j] (i > j) from rows i and j.
__device__ __forceinline__ float ldlt_pivot(float Ajj, float lam, const float* Lj, const float* d,
                                            int j) {
  float s = add(Ajj, mul(Ajj, lam));
#pragma unroll
  for (int k = 0; k < j; ++k) s = sub(s, mul(mul(Lj[k], Lj[k]), d[k]));
  return fabsf(s) < (float)1e-30 ? (float)1e-30 : s;
}

__device__ __forceinline__ float ldlt_entry(float Aij, const float* Li, const float* Lj,
                                            const float* d, int j) {
  float t = add(Aij, 0.0f);  // off the diagonal diag_embed adds +0
#pragma unroll
  for (int k = 0; k < j; ++k) t = sub(t, mul(mul(Li[k], Lj[k]), d[k]));
  return dvd(t, d[j]);
}

// The two triangular solves, then a non-finite increment to 0.
__device__ __forceinline__ void ldlt_solve(const float (*L)[6], const float* d, const float* g,
                                           float* x) {
  float y[6];
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

__device__ __forceinline__ void damped_solve(const float* A, const float* g, float lam,
                                             float* x) {
  float L[6][6], d[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    d[j] = ldlt_pivot(A[7 * j], lam, L[j], d, j);
#pragma unroll
    for (int i = j + 1; i < 6; ++i) L[i][j] = ldlt_entry(A[6 * i + j], L[i], L[j], d, j);
  }
  ldlt_solve(L, d, g, x);
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

// Entry k of the normalized system of K3 output row `row`: A (0..35), g
// (36..41) and err (42), each a sum over n = max(good, 1).
__device__ __forceinline__ float normalized_entry(const float* row, int k, float n) {
  return dvd(row[k], n);
}

__device__ __forceinline__ float good_count(const float* row) {
  return (float)max(reinterpret_cast<const int*>(row)[44], 1);
}

__device__ __forceinline__ void normalize(const float* row, System& s) {
  const float n = good_count(row);
  s.sum_w = row[42];
  s.sum_unw = row[43];
  s.good = reinterpret_cast<const int*>(row)[44];
  s.bad = reinterpret_cast<const int*>(row)[45];
  s.err = normalized_entry(row, 42, n);
#pragma unroll
  for (int k = 0; k < 36; ++k) s.A[k] = normalized_entry(row, k, n);
#pragma unroll
  for (int k = 0; k < 6; ++k) s.g[k] = normalized_entry(row, 36 + k, n);
}

struct State {  // solver.py LevelState: one pointer a field, B lanes each
  float *R, *t, *Rn, *tn, *inc, *err, *A, *g;
  int *good, *bad;
  float *sum_w, *sum_unw, *lam;
  int *iteration, *tries;
  uint8_t* active;
};

// One lane's fields of a LevelState, wherever they are held: `lane_of` in
// a State's device memory (revo_solver_step), or the level kernel's
// shared memory, where a lane's state stays for the whole level.
struct Lane {
  float *R, *t, *Rn, *tn, *inc, *err, *A, *g;
  int *good, *bad;
  float *sum_w, *sum_unw, *lam;
  int *iteration, *tries;
  uint8_t* active;
};

__device__ __forceinline__ Lane lane_of(const State& st, int b) {
  return {st.R + 9 * b,     st.t + 3 * b,       st.Rn + 9 * b,     st.tn + 3 * b,
          st.inc + 6 * b,   st.err + b,         st.A + 36 * b,     st.g + 6 * b,
          st.good + b,      st.bad + b,         st.sum_w + b,      st.sum_unw + b,
          st.lam + b,       st.iteration + b,   st.tries + b,      st.active + b};
}

struct Params {  // solver.py StepParams
  int gn, max_iter, max_inner, n_pows;
  float conv_eps, flat_below, step_min, success, fail, lam0;
};

__device__ __forceinline__ void load_system(const Lane& s, System& sys) {
  sys.err = *s.err;
#pragma unroll
  for (int k = 0; k < 36; ++k) sys.A[k] = s.A[k];
#pragma unroll
  for (int k = 0; k < 6; ++k) sys.g[k] = s.g[k];
  sys.good = *s.good;
  sys.bad = *s.bad;
  sys.sum_w = *s.sum_w;
  sys.sum_unw = *s.sum_unw;
}

__device__ __forceinline__ void store_system(const Lane& s, const System& sys) {
  *s.err = sys.err;
#pragma unroll
  for (int k = 0; k < 36; ++k) s.A[k] = sys.A[k];
#pragma unroll
  for (int k = 0; k < 6; ++k) s.g[k] = sys.g[k];
  *s.good = sys.good;
  *s.bad = sys.bad;
  *s.sum_w = sys.sum_w;
  *s.sum_unw = sys.sum_unw;
}

// The rules of a step after the start, for a live lane: the candidate's
// error err_n against the kept err, and inc, the increment that made the
// candidate.  Updates lam, it and tries; `accept`: the lane takes the
// candidate; returns whether the lane goes on.
__device__ __forceinline__ bool rules(float err_n, float err, const float* inc,
                                      const float* __restrict__ pows, const Params& p,
                                      float& lam, int& it, int& tries, bool& accept) {
  const float ratio = dvd(err_n, clamp_min(err, (float)1e-30));
  accept = err_n < err;
  const bool small = !(sq_norm6(inc) > p.step_min);
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
    return !done && it < p.max_iter;
  }
  const float pw = pows[min(max(tries, 0), p.n_pows - 1)];
  lam = accept ? (lam <= (float)0.2 ? 0.0f : mul(lam, p.success))
               : (lam == 0.0f ? (float)0.2 : mul(lam, pw));
  if ((accept && ratio > p.conv_eps) || (!accept && small)) it = p.max_iter;
  if (accept || small || tries >= p.max_inner) {
    it = min(it + 1, p.max_iter);
    tries = 0;
  }
  return it < p.max_iter;
}

// One lane's step (`solver_step_ref` / `solver_start_ref`) on the lane's
// state `s` from its 46 K3 outputs `row` (unread in gn_fixed's start), the
// start pose R0 (9 floats), t0 (3) read only when `init`; returns whether
// the lane evaluates a candidate next.  One thread.
__device__ inline bool step_lane(const Lane& s, const float* row, const float* __restrict__ pows,
                                 const float* R0, const float* t0, int init, const Params& p) {
  float R[9], t[3], Rn[9], tn[3], inc[6], lam;
  int it, tries;
  System sys;
  bool live;
  if (init) {
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = Rn[k] = R0[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = tn[k] = t0[k];
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
    if (!*s.active) return false;
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = s.R[k], Rn[k] = s.Rn[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = s.t[k], tn[k] = s.tn[k];
#pragma unroll
    for (int k = 0; k < 6; ++k) inc[k] = s.inc[k];
    load_system(s, sys);
    lam = *s.lam;
    it = *s.iteration;
    tries = *s.tries;
    System sn;
    normalize(row, sn);
    bool accept;
    live = rules(sn.err, sys.err, inc, pows, p, lam, it, tries, accept);
    if (accept) {
#pragma unroll
      for (int k = 0; k < 9; ++k) R[k] = Rn[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) t[k] = tn[k];
      sys = sn;
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
  for (int k = 0; k < 9; ++k) s.R[k] = R[k], s.Rn[k] = Rn[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) s.t[k] = t[k], s.tn[k] = tn[k];
#pragma unroll
  for (int k = 0; k < 6; ++k) s.inc[k] = inc[k];
  store_system(s, sys);
  *s.lam = lam;
  *s.iteration = it;
  *s.tries = tries;
  *s.active = live ? 1 : 0;
  return live;
}

// `step_lane` by the 32 lanes of one warp, every lane calling it with the
// same arguments, on a Lane in shared memory.  Every lane takes the rules
// (the same bits in each), warp lane k the entries k and k + 32 of the
// normalised system, lanes i < 6 row i of L (each pivot in every lane,
// row j of L from lane j by shuffle), every lane the triangular solves
// and exp's scalars, lanes k < 9 entry k of exp's R and V and of the
// composed rotation, lanes i < 3 entry i of exp's t and of the composed
// translation; rows of V and of exp's R come by shuffle.  Returns whether
// the lane evaluates a candidate next, in every warp lane.
__device__ inline bool step_lane_warp(const Lane& s, const float* row,
                                      const float* __restrict__ pows, const float* R0,
                                      const float* t0, int init, const Params& p) {
  constexpr unsigned FULL = 0xffffffffu;
  const int w = threadIdx.x & 31;
  float lam;
  int it, tries;
  bool live, take = false;  // take: the normalised `row` becomes the lane's system
  if (init) {
    if (w < 9) s.R[w] = s.Rn[w] = R0[w];
    else if (w < 12) s.t[w - 9] = s.tn[w - 9] = t0[w - 9];
    if (w < 6) s.inc[w] = 0.0f;
    if (p.gn) {  // the zero system at err = inf: iteration 0 evaluates (R0, t0)
      for (int k = w; k < 42; k += 32) {
        if (k < 36) s.A[k] = 0.0f;
        else s.g[k - 36] = 0.0f;
      }
      if (w == 0) {
        *s.err = INFINITY;
        *s.good = *s.bad = 0;
        *s.sum_w = *s.sum_unw = 0.0f;
      }
    }
    take = !p.gn;
    lam = p.lam0;
    it = tries = 0;
    live = it < p.max_iter;
  } else {
    if (!*s.active) return false;
    lam = *s.lam;
    it = *s.iteration;
    tries = *s.tries;
    bool accept;
    live = rules(normalized_entry(row, 42, good_count(row)), *s.err, s.inc, pows, p, lam, it,
                 tries, accept);
    __syncwarp();  // every lane has read the kept system
    if (accept) {
      if (w < 9) s.R[w] = s.Rn[w];
      else if (w < 12) s.t[w - 9] = s.tn[w - 9];
    }
    take = accept;
  }
  if (take) {
    const float n = good_count(row);
    for (int k = w; k < 43; k += 32) {
      const float v = normalized_entry(row, k, n);
      if (k < 36) s.A[k] = v;
      else if (k < 42) s.g[k - 36] = v;
      else *s.err = v;
    }
    if (w == 0) {
      *s.sum_w = row[42];
      *s.sum_unw = row[43];
      *s.good = reinterpret_cast<const int*>(row)[44];
      *s.bad = reinterpret_cast<const int*>(row)[45];
    }
  }
  __syncwarp();  // the kept pose and system are written
  if (live) {  // the next candidate: one more try, the damped solve, exp, compose
    if (!p.gn) tries += 1;
    const int i = w < 6 ? w : 0;  // row i of L (lanes from 6 on take row 0 and drop it)
    float Li[6] = {}, d[6], Lj[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
#pragma unroll
      for (int k = 0; k < j; ++k) Lj[k] = __shfl_sync(FULL, Li[k], j);
      d[j] = ldlt_pivot(s.A[7 * j], lam, Lj, d, j);
      if (w > j && w < 6) Li[j] = ldlt_entry(s.A[6 * i + j], Li, Lj, d, j);
    }
    float L[6][6], x[6];
#pragma unroll
    for (int r = 1; r < 6; ++r)
#pragma unroll
      for (int k = 0; k < r; ++k) L[r][k] = __shfl_sync(FULL, Li[k], r);
    float g[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) g[k] = s.g[k];
    ldlt_solve(L, d, g, x);
    float a, b, c, W[9], Rk = 0.0f, Vk = 0.0f;
    exp_coeffs(x, a, b, c);
    hat(x, W);
    if (w < 9) exp_entry(W, w, a, b, c, Rk, Vk);
    // Row w of V and of exp's R (lanes < 3), row w / 3 of exp's R (lanes < 9).
    float Vrow[3], dRrow[3], dRmine[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const int own = min(3 * w + m, 31), mine = min(3 * (w / 3) + m, 31);
      Vrow[m] = __shfl_sync(FULL, Vk, own);
      dRrow[m] = __shfl_sync(FULL, Rk, own);
      dRmine[m] = __shfl_sync(FULL, Rk, mine);
    }
    float R[9], t[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = s.R[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = s.t[k];
    __syncwarp();  // every lane has read the kept pose and system
    if (w < 9) {
      const int j = w % 3;
      s.Rn[w] = fma_chain3(dRmine[0], R[j], dRmine[1], R[3 + j], dRmine[2], R[6 + j]);
    }
    if (w < 3) s.tn[w] = add(dot3r(dRrow, t), dot3r(Vrow, x));
#pragma unroll
    for (int k = 0; k < 6; ++k)
      if (w == k) s.inc[k] = x[k];
  }
  if (w == 0) {
    *s.lam = lam;
    *s.iteration = it;
    *s.tries = tries;
    *s.active = live ? 1 : 0;
  }
  __syncwarp();
  return live;
}

}  // namespace step
