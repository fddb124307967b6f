// Shared by the two fused rigid KPConv kernels (kpconv_fwd.cu,
// kpconv_bwd.cu): the tile flags and part, the weighted neighbour sums of
// each query row,
//   part[q, p, :] = sum over q's real neighbours k of w[k, p] * x[nbr[q, k]]
// formed in slot order and written to scratch [tiles * kRows, Kp * C] in
// the compute type T (bf16 mode: w, each product w*x and part rounded to
// bf16, the sums f32).
#pragma once

#include "kpconv_common.cuh"

namespace dpcr {

constexpr int kRows = 64;        // query rows of a tile
constexpr int kGroupRows = 16;   // query rows of a part-kernel block
constexpr int kEdgeC = 32;       // channels of a part-kernel block

// dynamic shared memory of the part kernel: each slot's weights (kWS
// floats) and source row, the kernel points
__host__ __device__ inline size_t edge_smem(int K, int n_kp) {
  return (size_t)kGroupRows * K * (kPC + 4) * 4 + (size_t)kGroupRows * K * 4 +
         (size_t)n_kp * 3 * 4;
}

// flags[t] = 1 where tile t (rows t*kRows ..) has a real neighbour: one
// block a tile, one read of its nbr
__global__ void __launch_bounds__(kThreads)
kpconv_flags_kernel(const int32_t* __restrict__ nbr, int* __restrict__ flags,
                    long long M, int K, int Ns) {
  const long long t = blockIdx.x;
  const long long end = min(M, (t + 1) * kRows) * K;
  int any = 0;
  for (long long i = t * kRows * K + threadIdx.x; i < end; i += kThreads)
    any |= (unsigned)nbr[i] < (unsigned)Ns;
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) flags[t] = any;
}

// The weights of kernel points p0 .. p0 + kPC of the edge at relative
// position r (0 past n_kp), unrounded.
__device__ __forceinline__ void chunk_weights(const float r[3], const float* kp,
                                              int n_kp, int p0, float extent,
                                              int influence, int closest,
                                              float w[kPC]) {
  const float rr[3] = {r[0], r[1], r[2]};
  const int best = closest ? closest_point(rr[0], rr[1], rr[2], kp, n_kp) : -1;
#pragma unroll
  for (int j = 0; j < kPC; ++j)
    w[j] = p0 + j < n_kp ? edge_weight(rr, kp, p0 + j, best, extent, influence)
                         : 0.f;
}

// shared floats of one slot's weights (kPC, padded: 16-byte aligned, and
// the slots of one warp's edges spread over the banks)
constexpr int kWS = kPC + 4;

// Block (group of kGroupRows rows, chunk of kEdgeC channels); per chunk of
// kPC kernel points:
//   slots: one thread per (row, k) finds the source row and computes the
//     edge's weights once into shared memory;
//   part: one thread per (row, 4 channels, 1 to 4 kernel points: 256
//     threads or more) walks the row's slots in order, 8 at a time with
//     the neighbours' channels of x loaded first, and writes part (zeros
//     for rows past M).
template <typename T>
__global__ void __launch_bounds__(kThreads)
kpconv_part_kernel(const T* __restrict__ x, const int32_t* __restrict__ nbr,
                   const float* __restrict__ rel,
                   const float* __restrict__ kpts,
                   const int* __restrict__ flags, T* __restrict__ part,
                   long long M, int Nq, int Ns, int K, int C, int n_kp,
                   float extent, int influence, int closest) {
  extern __shared__ __align__(16) float smem[];
  const long long row0 = (long long)blockIdx.x * kGroupRows;
  if (!flags[row0 / kRows]) return;
  const int slots = kGroupRows * K;
  float* s_w = smem;                                        // [slots][kWS]
  int* s_src = reinterpret_cast<int*>(s_w + slots * kWS);   // [slots]
  float* s_kp = reinterpret_cast<float*>(s_src + slots);    // [n_kp][3]
  const int tid = threadIdx.x;
  const int cb = blockIdx.y * kEdgeC;                       // first channel
  const int cw = min(kEdgeC, C - cb);
  const int ng = (cw + 3) / 4;
  const long long KC = (long long)n_kp * C;
  const int nrows = (int)max(0LL, min((long long)kGroupRows, M - row0));
  for (int i = tid; i < n_kp * 3; i += kThreads) s_kp[i] = kpts[i];
  __syncthreads();

  for (int p0 = 0; p0 < n_kp; p0 += kPC) {
    for (int i = tid; i < slots; i += kThreads) {
      const int q = i / K;
      int src = -1;
      float rr[3];
      if (q < nrows) {   // nbr and rel read side by side
        const long long e = (row0 + q) * K + i - q * K;
        const int idx = nbr[e];
        rr[0] = rel[e * 3];
        rr[1] = rel[e * 3 + 1];
        rr[2] = rel[e * 3 + 2];
        if ((unsigned)idx < (unsigned)Ns)
          src = (int)((row0 + q) / Nq) * Ns + idx;
      }
      s_src[i] = src;
      if (src < 0) continue;
      float w[kPC];
      chunk_weights(rr, s_kp, n_kp, p0, extent, influence, closest, w);
      float4* sw = reinterpret_cast<float4*>(s_w + i * kWS);
#pragma unroll
      for (int v = 0; v < kPC / 4; ++v)
        sw[v] = make_float4(w[4 * v], w[4 * v + 1], w[4 * v + 2],
                            w[4 * v + 3]);
    }
    __syncthreads();

    // part[row][p][c] = sum_k w[p] * x[src][c], rounded as the forward;
    // an item takes kpi kernel points, so that a block has 256 or more
    const int kpi = ng >= 4 ? 4 : ng >= 2 ? 2 : 1;
    const int n_split = kPC / kpi;
    for (int it = tid; it < kGroupRows * ng * n_split; it += kThreads) {
      const int j0 = it % n_split * kpi;     // kernel points p0 + j0 ..
      const int qc = it / n_split;
      const int q = qc / ng, c0 = (qc - q * ng) * 4;
      const int nc = min(4, cw - c0);
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
      for (int k0 = 0; k0 < K && q < nrows; k0 += 8) {
        // the channels of 8 slots' neighbours, loaded before any is used
        int src[8];
        float xv[8][4];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          src[u] = k0 + u < K ? s_src[q * K + k0 + u] : -1;
          const T* xs = x + (long long)src[u] * C + cb + c0;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            xv[u][c] = src[u] >= 0 && c < nc ? to_float(xs[c]) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (src[u] < 0) continue;
          const float* w = s_w + (q * K + k0 + u) * kWS + j0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j >= kpi) break;
            const float wr = round_to<T>(w[j]);
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[j][c] += round_to<T>(wr * xv[u][c]);
          }
        }
      }
      T* prow = part + (row0 + q) * KC + (long long)(p0 + j0) * C + cb + c0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < kpi && p0 + j0 + j < n_kp)
          for (int c = 0; c < nc; ++c)
            prow[j * C + c] = from_float<T>(acc[j][c]);
    }
    __syncthreads();  // the slots are refilled for the next chunk
  }
}

}  // namespace dpcr
