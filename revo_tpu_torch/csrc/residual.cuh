// Device code of the fused residual pass, shared by `residual_lgsx`
// (lgsx.cu) and the level kernel (level.cu), so that both compile the same
// arithmetic: the table layouts, the bf16 upcast, the bilinear formula and
// the samplers, and one point's pass (transform, project, bounds, sample,
// edge filter, Huber weight, its terms added to the running sums).  Every
// operation up to the residual rounds where the jitted JAX pass on the CPU
// rounds (lgsx.cu's note).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "lgsx.cuh"

namespace residual {

constexpr int NF = lgsx::NSUM + 1;  // float sums: the 28 of K3 and sum_unw; a row adds 2 int counts

// Row layouts of the keyframe table (ops/lgsx.py ``table_layout``): the
// dt-only quad table, the 12-component quad table (taps 00, 01, 10, 11 of
// (gx, gy, dt)), each in float32 or bfloat16, and the (gx, gy, dt)
// structure itself, whose four taps are rows base, base+1, base+W, base+W+1.
enum Layout : int { DT4 = 0, DT4_BF16 = 1, QUAD12 = 2, QUAD12_BF16 = 3, STRUCT3 = 4 };

// float32(q * scale + shift) rounded once: the double product of two
// floats is exact, so only the double sum and the final conversion round.
__device__ __forceinline__ float scale_shift(float q, float scale, float shift) {
  return (float)__dadd_rn(__dmul_rn((double)q, (double)scale), (double)shift);
}

// floor(u) as an index clamped to [0, hi]; NaN goes to 0 (interp.py ``_taps_at``).
__device__ __forceinline__ int clamp_index(float fu, int hi) {
  const float c = isnan(fu) ? 0.0f : fu;
  return (int)fminf(fmaxf(c, 0.0f), (float)hi);
}

// bf16 is the upper half of a float: the two of a little-endian word
// upcast by a shift and a mask.
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// The reference's 4-tap formula (optimizer.h:173-185) rounded as jitted XLA
// rounds the JAX sum (interp.py ``_bilinear``): the second product rounded,
// the other three fused onto it in order.
__device__ __forceinline__ float bilinear(float i00, float i01, float i10, float i11,
                                          float dx, float dy, float dxdy) {
  float acc = __fmul_rn(__fsub_rn(dy, dxdy), i10);
  acc = __fmaf_rn(dxdy, i11, acc);
  acc = __fmaf_rn(__fsub_rn(dx, dxdy), i01, acc);
  return __fmaf_rn(__fadd_rn(__fsub_rn(__fsub_rn(1.0f, dx), dy), dxdy), i00, acc);
}

// (gx, gy, dt) at fractions (dx, dy) of the pixel whose top-left tap is
// table row `row` (interp.py ``sample_table``).  DT4: dt and the negated
// analytic gradients of the bilinear dt surface (interp.py
// ``bilinear_sample_dtquad``); the others: each channel interpolated.
template <int L>
__device__ __forceinline__ void sample(const void* __restrict__ table, size_t row, int W,
                                       float dx, float dy, float& gx, float& gy, float& r) {
  const float dxdy = __fmul_rn(dx, dy);
  if (L == DT4 || L == DT4_BF16) {
    float i00, i01, i10, i11;
    if (L == DT4_BF16) {  // one 8-byte row
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(table) + row);
      i00 = bf16_lo(q.x); i01 = bf16_hi(q.x); i10 = bf16_lo(q.y); i11 = bf16_hi(q.y);
    } else {  // one 16-byte row
      const float4 q = __ldg(reinterpret_cast<const float4*>(table) + row);
      i00 = q.x; i01 = q.y; i10 = q.z; i11 = q.w;
    }
    r = bilinear(i00, i01, i10, i11, dx, dy, dxdy);
    gx = -__fmaf_rn(dy, __fsub_rn(i11, i10),
                    __fmul_rn(__fsub_rn(1.0f, dy), __fsub_rn(i01, i00)));
    gy = -__fmaf_rn(dx, __fsub_rn(i11, i01),
                    __fmul_rn(__fsub_rn(1.0f, dx), __fsub_rn(i10, i00)));
  } else {
    float s[12];  // taps 00, 01, 10, 11, three channels each
    if (L == QUAD12) {  // one 48-byte row as three 16-byte loads
      const float4* q = reinterpret_cast<const float4*>(table) + 3 * row;
      const float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
      s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
      s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
      s[8] = c.x; s[9] = c.y; s[10] = c.z; s[11] = c.w;
    } else if (L == QUAD12_BF16) {  // one 24-byte row as three 8-byte loads
      const uint2* q = reinterpret_cast<const uint2*>(table) + 3 * row;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const uint2 w = __ldg(q + k);
        s[4 * k] = bf16_lo(w.x); s[4 * k + 1] = bf16_hi(w.x);
        s[4 * k + 2] = bf16_lo(w.y); s[4 * k + 3] = bf16_hi(w.y);
      }
    } else {  // STRUCT3: four 12-byte taps
      const float* q = static_cast<const float*>(table);
      const size_t tap[4] = {row, row + 1, row + W, row + W + 1};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int c = 0; c < 3; ++c) s[3 * k + c] = __ldg(q + 3 * tap[k] + c);
      }
    }
    gx = bilinear(s[0], s[3], s[6], s[9], dx, dy, dxdy);
    gy = bilinear(s[1], s[4], s[7], s[10], dx, dy, dxdy);
    r = bilinear(s[2], s[5], s[8], s[11], dx, dy, dxdy);
  }
}

// One point's pass: point p (< P) of the lane, if valid, at pose (R, t)
// against the lane's table rows from `row0`: adds its terms to `acc` and
// counts it good or bad (both stay 0 for an invalid point or p >= P).
template <int L>
__device__ __forceinline__ void point_pass(const void* __restrict__ quad, size_t row0,
                                           const float* __restrict__ pts,
                                           const uint8_t* __restrict__ valid, int p, int P,
                                           const float (&R)[9], const float (&t)[3], float fx,
                                           float fy, float cx, float cy, int W, int H,
                                           float edge_distance, float huber, int use_edge_filter,
                                           float (&acc)[NF], int& n_good, int& n_bad) {
  if (!(p < P && valid[p])) return;
  const float x = pts[3 * p], y = pts[3 * p + 1], z = pts[3 * p + 2];
  // R p + t as jitted XLA rounds R0 x + R1 y + R2 z + t (project.py
  // ``apply_rt_cols``): the second product rounded, the first and third
  // fused onto it, then the translation added.
  float w3[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    w3[i] = __fadd_rn(__fmaf_rn(R[3 * i + 2], z, __fmaf_rn(R[3 * i], x, __fmul_rn(R[3 * i + 1], y))),
                      t[i]);
  const float px = w3[0], py = w3[1], pz = w3[2];
  const float pzs = (pz == 0.0f) ? 1e-12f : pz;
  const float u = scale_shift(__fdiv_rn(px, pzs), fx, cx);
  const float v = scale_shift(__fdiv_rn(py, pzs), fy, cy);
  // NaN-rejecting bounds test (optimizer.cpp:100).
  bool good = (u > 1.0f) && (v > 1.0f) && (u < (float)W - 2.0f) && (v < (float)H - 2.0f);
  if (good) {
    const float fu = floorf(u), fv = floorf(v);
    const float dx = __fsub_rn(u, fu), dy = __fsub_rn(v, fv);
    const int ix = clamp_index(fu, W - 2), iy = clamp_index(fv, H - 2);
    float gx, gy, r;
    sample<L>(quad, row0 + (size_t)iy * W + ix, W, dx, dy, gx, gy, r);
    if (use_edge_filter) good = r <= edge_distance;  // optimizer.cpp:108
    if (good) {
      // Huber weight (optimizer.h:156-160), a true division.
      const float r_safe = (r == 0.0f) ? 1.0f : r;
      const float w = (r <= huber) ? 1.0f : __fdiv_rn(huber, r_safe);
      lgsx::accumulate(acc, px, py, pz, __fmul_rn(fx, gx), __fmul_rn(fy, gy), r, w);
      acc[lgsx::NSUM] += r * r;
    }
  }
  n_good = good ? 1 : 0;
  n_bad = good ? 0 : 1;
}

// Thread tid's share of a lane's 46 outputs from its column sums (sum_rows
// of rows of NF floats and 2 ints): A (36, both triangles), g (6), sum_w,
// sum_unw, then n_good and n_bad as int32.
__device__ __forceinline__ void store_outputs(float* out, int tid, float fs, int is) {
  if (tid < lgsx::NSUM) {
    lgsx::store_sum(out, tid, fs);
  } else if (tid == lgsx::NSUM) {
    out[43] = fs;
  } else if (tid < NF + 2) {
    reinterpret_cast<int*>(out)[44 + tid - NF] = is;
  }
}

}  // namespace residual
