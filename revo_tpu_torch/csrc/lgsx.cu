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
// kernel (lgsx.py:8-11); on this card a thread gathers its own table row.
// Per point, one thread transforms and projects the point, bounds-checks
// it, gathers the keyframe table at its pixel in the layout the kernel is
// instantiated for (`Layout`: the dt-only quad row, 8 bytes in bf16 or 16
// in f32; the 12-component quad row of the reference-gradient forms, 24
// bytes in bf16 as three 8-byte loads or 48 in f32 as three 16-byte loads;
// or the (gx, gy, dt) structure's four 12-byte taps at base, base+1,
// base+W, base+W+1), forms dt and the gradients, the edge filter, the Huber
// weight and the Jacobian row, and adds to 29 float sums and 2 int counts
// in registers.  The grid covers P with 128-thread blocks (128 blocks at
// P = 16384, so level 0 spreads over the card's 132 SMs).  Inside a block:
// the fixed shuffle tree, then the 4 warp partials summed in warp order;
// each block writes one 32-word partial row to a scratch buffer, fences and
// takes an atomic ticket; the last block to arrive sums the rows in
// block-index order, writes the 46 outputs and resets the ticket, so no
// memset is needed between launches.
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
// launch latency; the fused form moves 13 B per point plus one table row
// (8-48 B) per point inside the image (~0.3-1.0 MB at P = 16384, under
// 0.3 us of HBM time).
//
// The fused form's arithmetic up to the residual rounds where the jitted
// JAX pass on the CPU rounds, which the plain PyTorch version reproduces:
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn for a single rounding and
// __fmaf_rn where XLA contracts a sum of products into fused multiply-adds
// (the point transform, the bilinear sums, the dt4 gradients).  floor(u),
// the bounds test and the edge filter decide the good and bad counts, which
// must be equal, not close, and the per-point terms (r, w, gradients) are
// the JAX package's bit for bit.  u = q * fx + cx is rounded once, through
// double, like the plain version's `scale_shift`.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lgsx.cuh"
#include "residual.cuh"

namespace {

using lgsx::NSUM;
using namespace residual;

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

template <int L>
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
  // Table rows of this lane (quad_stride counts rows of the layout's width).
  const size_t quad_row0 = batch * quad_stride;

  float acc[NF];
#pragma unroll
  for (int k = 0; k < NF; ++k) acc[k] = 0.0f;
  int n_good = 0, n_bad = 0;
  float R[9], t[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = __ldg(Rp + k);
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = __ldg(tp + k);
  residual::point_pass<L>(quad, quad_row0, pts, valid, blockIdx.x * RL_THREADS + threadIdx.x, P, R,
                          t, fx, fy, cx, cy, W, H, edge_distance, huber, use_edge_filter, acc,
                          n_good, n_bad);

  // Block reduction to one partial row, the ticket, and in the last block
  // the rows summed in block-index order (lgsx.cuh).
  int cnt[2] = {n_good, n_bad};
  __shared__ float stage[lgsx::CHUNK * lgsx::ROW];
  lgsx::block_row<RL_THREADS, NF, 2>(acc, cnt, stage, partial + (size_t)blockIdx.x * lgsx::ROW);
  if (!lgsx::last_block(ticket, gridDim.x)) return;
  float fs;
  int is;
  lgsx::sum_rows<RL_THREADS, NF, 2>(partial, gridDim.x, stage, fs, is);
  store_outputs(out, threadIdx.x, fs, is);
  if (threadIdx.x == 0) *ticket = 0u;
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
// in elements of each operand (rows of the layout's width for quad), 0 for
// a shared one.  layout: a `Layout`; any other value returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int revo_residual_lgsx(const void* quad, int layout, int quad_stride,
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
#define REVO_RESIDUAL_LGSX(L)                                                       \
  residual_lgsx_kernel<L><<<grid, RL_THREADS, 0, stream>>>(                         \
      quad, quad_stride, pts, pts_stride, valid, valid_stride, R, R_stride, t,      \
      t_stride, active, fx, fy, cx, cy, W, H, edge_distance, huber,                 \
      use_edge_filter, P, partial, ticket, out)
  switch (layout) {
    case DT4: REVO_RESIDUAL_LGSX(DT4); break;
    case DT4_BF16: REVO_RESIDUAL_LGSX(DT4_BF16); break;
    case QUAD12: REVO_RESIDUAL_LGSX(QUAD12); break;
    case QUAD12_BF16: REVO_RESIDUAL_LGSX(QUAD12_BF16); break;
    case STRUCT3: REVO_RESIDUAL_LGSX(STRUCT3); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef REVO_RESIDUAL_LGSX
  return (int)cudaGetLastError();
}
