// K3 on Hopper: the LGSX normal-equation reduction, in two forms.
//
// `revo_lgsx_reduce` replaces the Pallas kernel revo_tpu/ops/pallas/lgsx.py
// (`lgsx_reduce`, `_kernel`) under that kernel's own contract.  From warped
// points p (P, 3), fx/fy-scaled DT gradients (P, 2), residuals r (P,) and
// weights w (P,) (0 on dead lanes) it forms the Jacobian row J (6) of every
// point (optimizer.cpp:216-228) and reduces
//   A = sum w J J^T (6x6),  g = sum w J r (6),  s = sum w r^2,
// unnormalized; the caller divides by the good count.  Bound on the H100:
// launch latency (0.46 MB at P = 16384 is ~0.14 us of HBM time), so the
// design spreads the points over the card as `revo_residual_lgsx` does:
// 128-thread blocks, two points a thread (faster than one or four on an
// H100), ceil(P / 256) blocks (64 at P = 16384); each block reduces its 28
// sums to one partial row, and the block that draws the last ticket sums
// the rows in block-index order (lgsx.cuh's block_row, last_block and
// sum_rows, which both kernels call).
//
// `revo_residual_lgsx` is the form the solver launches: the whole residual
// pass of one evaluation and its reduction in one kernel.  The TPU kernel
// reduces only what XLA prepared, because Mosaic could not gather inside a
// kernel (lgsx.py:8-11); on this card a thread gathers its own quad row.  Per
// point, one thread transforms and projects the point, bounds-checks it,
// loads the four dt taps of its pixel as one 8-byte (bf16) or 16-byte (f32)
// row, forms dt, the gradients, the edge filter, the Huber weight and the
// Jacobian row, and adds to 29 float sums and 2 int counts in registers.
// The grid covers P with 128-thread blocks (128 blocks at P = 16384, so
// level 0 spreads over the card's 132 SMs).  Inside a block: the fixed
// shuffle tree, then the 4 warp partials summed in warp order; each block
// writes one 32-word partial row to a scratch buffer, fences and takes an
// atomic ticket; the last block to arrive sums the rows in block-index
// order, writes the 46 outputs and resets the ticket, so no memset is
// needed between launches.
//
// blockIdx.y is the lane: B independent evaluations in one launch (the JAX
// package vmaps the solver over sequences, ring slots and loop pairs).
// Every operand has a lane stride, 0 where the lanes share it (one frame's
// cloud tracked against K ring keyframes).  Each lane has its own partial
// rows, ticket and 46 outputs, and reduces in the order a one-lane launch
// does, so each lane's bits equal its B = 1 launch.  A lane whose byte in
// `active` (device memory) is 0 returns at once and leaves its outputs as
// they were: the solver freezes lanes that have converged without a host
// round trip.  Bound at B lanes: B times one lane's bytes.
//
// Neither form uses float atomics: the summation order is fixed, so the
// same inputs give bit-identical sums run after run.  Bound on the H100:
// launch latency; the fused form moves 13 B per point plus one 32-byte
// sector per gathered row (~0.7 MB at P = 16384, ~0.2 us of HBM time).
//
// The fused form's arithmetic up to the residual is written with
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn so that it rounds where the
// plain PyTorch version (one op per rounding) does: floor(u), the bounds
// test and the edge filter decide the good and bad counts, which must be
// equal, not close.  u = q * fx + cx is rounded once, through double, like
// the plain version's `scale_shift`.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lgsx.cuh"

namespace {

using lgsx::NSUM;

constexpr int RD_THREADS = 128, RD_POINTS = 2;  // threads a block, points a thread
constexpr int RD_BLOCK_POINTS = RD_THREADS * RD_POINTS;

// partial: ceil(P / RD_BLOCK_POINTS) rows of lgsx::ROW floats; ticket: one
// zeroed uint32 that every launch leaves at 0; out: 43 floats.  Grid
// max(ceil(P / RD_BLOCK_POINTS), 1); point q RD_THREADS + threadIdx.x of a
// block's RD_BLOCK_POINTS is the thread's q-th.
__global__ void __launch_bounds__(RD_THREADS)
lgsx_reduce_kernel(const float* __restrict__ wxp, const float* __restrict__ grads,
                   const float* __restrict__ res, const float* __restrict__ wts,
                   float* __restrict__ out, int P, float* partial, unsigned int* ticket) {
  float acc[NSUM];
#pragma unroll
  for (int k = 0; k < NSUM; ++k) acc[k] = 0.0f;
#pragma unroll
  for (int q = 0; q < RD_POINTS; ++q) {
    const int p = blockIdx.x * RD_BLOCK_POINTS + q * RD_THREADS + threadIdx.x;
    if (p < P)
      lgsx::accumulate(acc, wxp[3 * p], wxp[3 * p + 1], wxp[3 * p + 2], grads[2 * p],
                       grads[2 * p + 1], res[p], wts[p]);
  }
  __shared__ float stage[lgsx::CHUNK * lgsx::ROW];
  lgsx::block_row<RD_THREADS, NSUM, 0>(acc, nullptr, stage,
                                       partial + (size_t)blockIdx.x * lgsx::ROW);
  if (!lgsx::last_block(ticket, gridDim.x)) return;
  float fs;
  int is;
  lgsx::sum_rows<RD_THREADS, NSUM, 0>(partial, gridDim.x, stage, fs, is);
  if (threadIdx.x < NSUM) lgsx::store_sum(out, threadIdx.x, fs);
  if (threadIdx.x == 0) *ticket = 0u;
}

constexpr int RL_THREADS = 128;
constexpr int NF = NSUM + 1;  // float sums: the 28 of K3 and sum_unw; a row adds 2 int counts

// float32(q * scale + shift) rounded once: the double product of two
// floats is exact, so only the double sum and the final conversion round.
__device__ __forceinline__ float scale_shift(float q, float scale, float shift) {
  return (float)__dadd_rn(__dmul_rn((double)q, (double)scale), (double)shift);
}

// floor(u) as an index clamped to [0, hi]; NaN goes to 0 (interp.py:29-30).
__device__ __forceinline__ int clamp_index(float fu, int hi) {
  const float c = isnan(fu) ? 0.0f : fu;
  return (int)fminf(fmaxf(c, 0.0f), (float)hi);
}

template <bool BF16>
__global__ void __launch_bounds__(RL_THREADS)
residual_lgsx_kernel(const void* __restrict__ quad, int quad_stride,
                     const float* __restrict__ pts, int pts_stride,
                     const uint8_t* __restrict__ valid, int valid_stride,
                     const float* __restrict__ Rp, int R_stride,
                     const float* __restrict__ tp, int t_stride,
                     const uint8_t* __restrict__ active,
                     float fx, float fy, float cx, float cy, int W, int H,
                     float edge_distance, float huber, int use_edge_filter,
                     int P, float* partial, unsigned int* ticket, float* out) {
  const size_t batch = blockIdx.y;  // the lane of the batch
  if (!active[batch]) return;  // uniform over the block
  pts += batch * pts_stride;
  valid += batch * valid_stride;
  Rp += batch * R_stride;
  tp += batch * t_stride;
  partial += batch * gridDim.x * lgsx::ROW;
  ticket += batch;
  out += batch * 46;
  // Quad rows of this lane (quad_stride counts rows of 4 taps).
  const size_t quad_row0 = batch * quad_stride;

  float acc[NF];
#pragma unroll
  for (int k = 0; k < NF; ++k) acc[k] = 0.0f;
  int n_good = 0, n_bad = 0;

  const int p = blockIdx.x * RL_THREADS + threadIdx.x;
  if (p < P && valid[p]) {
    const float x = pts[3 * p], y = pts[3 * p + 1], z = pts[3 * p + 2];
    // R p + t, nine products and sums, each rounded once, left to right.
    float w3[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float r0 = __ldg(Rp + 3 * i), r1 = __ldg(Rp + 3 * i + 1);
      const float r2 = __ldg(Rp + 3 * i + 2), ti = __ldg(tp + i);
      w3[i] = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(r0, x), __fmul_rn(r1, y)), __fmul_rn(r2, z)),
          ti);
    }
    const float px = w3[0], py = w3[1], pz = w3[2];
    const float pzs = (pz == 0.0f) ? 1e-12f : pz;
    const float u = scale_shift(__fdiv_rn(px, pzs), fx, cx);
    const float v = scale_shift(__fdiv_rn(py, pzs), fy, cy);
    // NaN-rejecting bounds test (optimizer.cpp:100).
    bool good = (u > 1.0f) && (v > 1.0f) && (u < (float)W - 2.0f) &&
                (v < (float)H - 2.0f);
    if (good) {
      const float fu = floorf(u), fv = floorf(v);
      const float dx = __fsub_rn(u, fu), dy = __fsub_rn(v, fv);
      const int ix = clamp_index(fu, W - 2), iy = clamp_index(fv, H - 2);
      const size_t row = quad_row0 + (size_t)iy * W + ix;
      float i00, i01, i10, i11;
      if (BF16) {  // bf16 is the upper half of a float: upcast by a shift
        const uint2 q = __ldg(reinterpret_cast<const uint2*>(quad) + row);
        i00 = __uint_as_float(q.x << 16);
        i01 = __uint_as_float(q.x & 0xffff0000u);
        i10 = __uint_as_float(q.y << 16);
        i11 = __uint_as_float(q.y & 0xffff0000u);
      } else {
        const float4 q = __ldg(reinterpret_cast<const float4*>(quad) + row);
        i00 = q.x; i01 = q.y; i10 = q.z; i11 = q.w;
      }
      // dt and the negated analytic gradients of the bilinear surface
      // (interp.py:35-43), one rounding per operation.
      const float dxdy = __fmul_rn(dx, dy);
      const float r = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(dxdy, i11),
                              __fmul_rn(__fsub_rn(dy, dxdy), i10)),
                    __fmul_rn(__fsub_rn(dx, dxdy), i01)),
          __fmul_rn(__fadd_rn(__fsub_rn(__fsub_rn(1.0f, dx), dy), dxdy), i00));
      const float gx = -__fadd_rn(__fmul_rn(dy, __fsub_rn(i11, i10)),
                                  __fmul_rn(__fsub_rn(1.0f, dy), __fsub_rn(i01, i00)));
      const float gy = -__fadd_rn(__fmul_rn(dx, __fsub_rn(i11, i01)),
                                  __fmul_rn(__fsub_rn(1.0f, dx), __fsub_rn(i10, i00)));
      if (use_edge_filter) good = r <= edge_distance;  // optimizer.cpp:108
      if (good) {
        // Huber weight (optimizer.h:156-160), as reciprocal times huber.
        const float r_safe = (r == 0.0f) ? 1.0f : r;
        const float w = (r <= huber) ? 1.0f : __fmul_rn(__frcp_rn(r_safe), huber);
        lgsx::accumulate(acc, px, py, pz, __fmul_rn(fx, gx),
                         __fmul_rn(fy, gy), r, w);
        acc[NSUM] += r * r;
      }
    }
    n_good = good ? 1 : 0;
    n_bad = good ? 0 : 1;
  }

  // Block reduction to one partial row, the ticket, and in the last block
  // the rows summed in block-index order (lgsx.cuh).
  int cnt[2] = {n_good, n_bad};
  __shared__ float stage[lgsx::CHUNK * lgsx::ROW];
  lgsx::block_row<RL_THREADS, NF, 2>(acc, cnt, stage, partial + (size_t)blockIdx.x * lgsx::ROW);
  if (!lgsx::last_block(ticket, gridDim.x)) return;
  float fs;
  int is;
  lgsx::sum_rows<RL_THREADS, NF, 2>(partial, gridDim.x, stage, fs, is);
  const int tid = threadIdx.x;
  // out: A (36), g (6), sum_w, sum_unw, then n_good and n_bad as int32.
  if (tid < NSUM) {
    lgsx::store_sum(out, tid, fs);
  } else if (tid == NSUM) {
    out[43] = fs;
  } else if (tid < NF + 2) {
    reinterpret_cast<int*>(out)[44 + tid - NF] = is;
  }
  if (tid == 0) *ticket = 0u;
}

}  // namespace

// partial: max(ceil(P / RD_BLOCK_POINTS), 1) rows of 32 floats; ticket:
// one zeroed uint32 that every launch leaves at 0.  P = 0 launches one
// block, which writes zeros.
extern "C" int revo_lgsx_reduce(const float* wxp, const float* grads, const float* r,
                                const float* w, float* out, int P, float* partial,
                                unsigned int* ticket, cudaStream_t stream) {
  const int blocks = P > 0 ? (P + RD_BLOCK_POINTS - 1) / RD_BLOCK_POINTS : 1;
  lgsx_reduce_kernel<<<blocks, RD_THREADS, 0, stream>>>(wxp, grads, r, w, out, P, partial,
                                                        ticket);
  return (int)cudaGetLastError();
}

// B lanes; per lane: partial, ceil(P / 128) rows of 32 floats; ticket, one
// zeroed uint32 that every launch leaves at 0; out, 46 floats.  Strides are
// in elements of each operand (rows of 4 taps for quad), 0 for a shared one.
extern "C" int revo_residual_lgsx(const void* quad, int quad_bf16, int quad_stride,
                                  const float* pts, int pts_stride,
                                  const uint8_t* valid, int valid_stride,
                                  const float* R, int R_stride, const float* t,
                                  int t_stride, const uint8_t* active, float fx,
                                  float fy, float cx, float cy, int W, int H,
                                  float edge_distance, float huber,
                                  int use_edge_filter, int P, int B, float* partial,
                                  unsigned int* ticket, float* out,
                                  cudaStream_t stream) {
  if (B <= 0) return 0;
  const dim3 grid(P > 0 ? (P + RL_THREADS - 1) / RL_THREADS : 1, B);
  if (quad_bf16) {
    residual_lgsx_kernel<true><<<grid, RL_THREADS, 0, stream>>>(
        quad, quad_stride, pts, pts_stride, valid, valid_stride, R, R_stride, t,
        t_stride, active, fx, fy, cx, cy, W, H, edge_distance, huber,
        use_edge_filter, P, partial, ticket, out);
  } else {
    residual_lgsx_kernel<false><<<grid, RL_THREADS, 0, stream>>>(
        quad, quad_stride, pts, pts_stride, valid, valid_stride, R, R_stride, t,
        t_stride, active, fx, fy, cx, cy, W, H, edge_distance, huber,
        use_edge_filter, P, partial, ticket, out);
  }
  return (int)cudaGetLastError();
}
