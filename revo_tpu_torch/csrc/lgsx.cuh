// Device code shared by the two LGSX kernels of lgsx.cu: one point's
// contribution to the 28 running sums, the fixed warp-shuffle tree, the
// block reduction to one partial row, the ticket that elects the last block,
// its pass over the rows in block-index order, and the scatter of the 21
// upper-triangle sums into the 6x6 output.
#pragma once
#include <cuda_runtime.h>

namespace lgsx {

constexpr int NSUM = 28;  // 21 (upper A) + 6 (g) + 1 (s)

// acc[0..27] += one point: Jacobian row J (6) of the warped point (px, py, pz) with
// fx/fy-scaled DT gradients (gx, gy) (optimizer.cpp:216-228), then
// A += w J J^T (upper triangle, row-major), g += w r J, s += w r^2.
template <int N>
__device__ __forceinline__ void accumulate(float (&acc)[N], float px, float py,
                                           float pz, float gx, float gy, float r,
                                           float w) {
  static_assert(N >= NSUM, "acc holds the 28 sums first");
  const float pzs = (pz == 0.0f) ? 1e-12f : pz;
  const float iz = 1.0f / pzs;
  const float iz2 = iz * iz;
  float J[6];
  J[0] = iz * gx;
  J[1] = iz * gy;
  J[2] = (-px * iz2) * gx + (-py * iz2) * gy;
  J[3] = (-px * py * iz2) * gx - (1.0f + py * py * iz2) * gy;
  J[4] = (1.0f + px * px * iz2) * gx + (px * py * iz2) * gy;
  J[5] = (-py * iz) * gx + (px * iz) * gy;
  const float wr = w * r;
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float jw = J[i] * w;
#pragma unroll
    for (int j = i; j < 6; ++j) acc[k++] += jw * J[j];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[21 + i] += J[i] * wr;
  acc[27] += wr * r;
}

// Fixed-order sum over the warp's 32 lanes; lane 0 holds the result.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

constexpr int ROW = 32;    // words of a block's partial row
constexpr int CHUNK = 128; // partial rows the last block stages per pass

// The NT threads of a block reduce their NF float sums `acc` and NI int
// counts `cnt` to one partial row (NF floats, then NI ints) in global
// memory, in a fixed order: the shuffle tree in each warp, then the warp
// partials added in warp order.  stage: CHUNK * ROW words of shared memory.
template <int NT, int NF, int NI>
__device__ __forceinline__ void block_row(float* acc, int* cnt, float* stage, float* row) {
  static_assert(NF + NI <= ROW && NT / 32 <= CHUNK, "a partial row holds every sum");
#pragma unroll
  for (int k = 0; k < NF; ++k) acc[k] = warp_sum(acc[k]);
#pragma unroll
  for (int k = 0; k < NI; ++k) cnt[k] = __reduce_add_sync(0xffffffffu, cnt[k]);
  int* stage_i = reinterpret_cast<int*>(stage);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NF; ++k) stage[warp * ROW + k] = acc[k];
#pragma unroll
    for (int k = 0; k < NI; ++k) stage_i[warp * ROW + NF + k] = cnt[k];
  }
  __syncthreads();
  if (tid < NF) {
    float s = 0.0f;
    for (int wi = 0; wi < NT / 32; ++wi) s += stage[wi * ROW + tid];
    row[tid] = s;
  } else if (tid < NF + NI) {
    int s = 0;
    for (int wi = 0; wi < NT / 32; ++wi) s += stage_i[wi * ROW + tid];
    reinterpret_cast<int*>(row)[tid] = s;
  }
}

// After block_row: the row is fenced, then the block takes a ticket.  True,
// in every thread, in the block that draws the last of `nblocks` tickets;
// that block must reset the ticket to 0 once it has read the rows, so the
// next launch needs no memset.
__device__ __forceinline__ bool last_block(unsigned int* ticket, unsigned int nblocks) {
  __shared__ bool last;
  __threadfence();  // the row is visible before the ticket is taken
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == nblocks - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// In the last block: thread k (< NF + NI) sums column k of the nb partial
// rows in block-index order, into fs (floats) or is (ints).  All NT threads
// stage CHUNK rows at a time in shared memory (loads in flight together,
// past L1).  stage: CHUNK * ROW words of shared memory.
template <int NT, int NF, int NI>
__device__ __forceinline__ void sum_rows(const float* partial, int nb, float* stage, float& fs,
                                         int& is) {
  const int* stage_i = reinterpret_cast<const int*>(stage);
  const int tid = threadIdx.x;
  fs = 0.0f;
  is = 0;
  for (int base = 0; base < nb; base += CHUNK) {
    const int n = min(CHUNK, nb - base);
    __syncthreads();
    for (int i = tid; i < n * ROW; i += NT) stage[i] = __ldcg(partial + (size_t)base * ROW + i);
    __syncthreads();
    if (tid < NF) {
      for (int b = 0; b < n; ++b) fs += stage[b * ROW + tid];
    } else if (tid < NF + NI) {
      for (int b = 0; b < n; ++b) is += stage_i[b * ROW + tid];
    }
  }
}

// Store sum k (0..27) at its place in out: A (6x6 row-major, both
// triangles) at 0..35, g at 36..41, s at 42.
__device__ __forceinline__ void store_sum(float* out, int k, float s) {
  if (k < 21) {
    int i = 0, rem = k;
    while (rem >= 6 - i) { rem -= 6 - i; ++i; }
    const int j = i + rem;
    out[i * 6 + j] = s;
    out[j * 6 + i] = s;
  } else {
    out[36 + (k - 21)] = s;
  }
}

}  // namespace lgsx
