// kpconv_fused_bwd: the backward of the fused rigid kernel-point
// convolution (kpconv_fwd.cu): dx and dW from the cotangent g; and the
// backward of the plain row gather by a neighbour list (gather_rows_bwd).
//
// Replaces: dpcr_agb_tpu/ops/pallas_kpconv.py _bwd_kernel (:121, called at
// :249) and the XLA scatter-add behind it (the transpose of the row gather,
// models/kpconv.py :59-72). Per query row q, with w and part as in the
// forward:
//   dpart[p] = g[q] @ W[p]^T                                   [Kp, C]
//   dx[nbr[q, k]] += sum_p w[k, p] * dpart[p]                  (no shadow)
//   dW[p]   += part[p]^T g[q]                                  [C, Cout]
// There is no gradient to rel. The TPU kernel returns dnx [M, K, C] for XLA
// to scatter and sums dW by revisiting one output block over its sequential
// grid. Here both sums run in a fixed order, so dx and dW are the same bit
// for bit from run to run: dx has one owner per source row that walks the
// row's incoming edges in the order of a reverse edge index (the stable
// sort of the flat neighbour list by source row, built once per list on
// the card: `ops.kpconv.reverse_edges`, the device form of
// dpcr_agb_tpu/ops/host_pyramid.py _edge_transpose), and dW is a split
// product whose partials are added in order.
//
// What bounds it on an H100. Bytes, at every KPCNN layer (bs16): x, nbr,
// rel, W, g and the reverse index read once, dx and dW written once,
// 0.03-0.06 ms; the products need 2 * Kp * C * Cout operations per row
// with a real neighbour twice, plus 2 * C per (real edge, kernel point)
// twice, under 0.03 ms on the f32 cores. The first version was ~100x off
// that bound: its dW kernel gathered every row of x and recomputed every
// influence once per kernel point and channel tile, and it worked every
// padding row (25% of level 0's rows, 92% of level 4's have no real
// neighbour). The second added dx with one f32 atomic per (edge, 4
// channels), in an order that changed from run to run.
//
// Design: rows in tiles of kRows = 64; six kernels, one after another.
//   flags: one read of a tile's nbr says whether any row of it has a real
//     neighbour; every later kernel skips a tile without one at once (no
//     host sync: the tile count never leaves the card);
//   dpart: dpart [rows, Kp*C] = g [rows, Cout] @ W^T, one 64 x 64 output
//     tile a block, W staged through shared memory, into scratch;
//   dx: a warp per source row walks its segment of the reverse index,
//     recomputes each edge's Kp influences (one kernel point a lane) and
//     adds sum_p w * dpart[q, p, :] (one channel a lane), skipping kernel
//     points of weight 0; rows of 16 channels or fewer take 2 to 8 edges
//     at a time, a group of lanes each; every row written, no atomics;
//   part (kpconv_part.cuh, shared with the forward): a block per 16 rows
//     and 32 channels computes each real edge's Kp influences once into
//     shared memory and forms part by walking each row's slots in order,
//     gathering the neighbours' channels of x once for all kernel points;
//     part [rows, Kp*C] goes to scratch in T;
//   dw: the split-K product part^T @ g: block (output tile, split s) sums
//     the active tiles s, s + S, s + 2S, ... into a register tile and writes
//     it to its own slice of a partials buffer;
//   reduce: dW = the partials summed over s in a fixed order.
// Both products are BlockGemm (gemm.cuh): in f32 on the f32 cores (4 x 4
// outputs a thread; no TF32), in bf16 mode on the tensor cores (mma.sync
// m16n8k16, bf16 operands, f32 sums).
// bf16 mode: x is bf16; g and W are rounded to bf16 in dpart and dW; w,
// each product w*x and part are rounded as in the forward for dW (products
// of bf16 values are exact in f32, so the tensor cores round nowhere else);
// w stays f32 for dx; every sum is f32; dx and dW are f32.
// gather_rows_bwd: dx[s] = the sum of the cotangent rows of the edges that
// name s, a warp a row over the same reverse index, in its order.
#include <algorithm>

#include "gemm.cuh"
#include "kpconv_part.cuh"

namespace dpcr {

constexpr int kOwnerWarps = 8;   // source rows of a dx (or gather) block

// dpart [tile rows, KC] = g [tile rows, Cout] @ W [KC, Cout]^T; block
// (tile, 64 columns)
template <typename T>
__global__ void __launch_bounds__(kThreads)
kpconv_bwd_dpart_kernel(const float* __restrict__ g,
                        const float* __restrict__ weights,
                        const int* __restrict__ flags,
                        float* __restrict__ dpart, long long M, int KC,
                        int Cout) {
  using Gm = BlockGemm<T, kRows, 64>;
  __shared__ __align__(16) unsigned char smem[Gm::kSmem];
  const long long t = blockIdx.x;
  if (!flags[t]) return;
  const long long row0 = t * kRows;
  const int n0 = blockIdx.y * 64;
  const int nrows = (int)min((long long)kRows, M - row0);
  const int ncols = min(64, KC - n0);
  Gm gm;
  gm.zero();
  for (int d0 = 0; d0 < Cout; d0 += Gm::BK) {
    const int nk = min(Gm::BK, Cout - d0);
    stage<T, Gm::BK, kRows, true>(
        g + row0 * Cout + d0, 1, Cout, nk, nrows,
        [&](int k, int i, float v) { Gm::put_a(smem, k, i, v); });
    stage<T, Gm::BK, 64, true>(
        weights + (long long)n0 * Cout + d0, 1, Cout, nk, ncols,
        [&](int k, int i, float v) { Gm::put_b(smem, k, i, v); });
    __syncthreads();
    gm.step(smem);
    __syncthreads();
  }
  float* out = dpart + row0 * KC + n0;
  gm.store([&](int m, int n, float v) {
    if (n < ncols) out[(long long)m * KC + n] = v;
  });
}

// The first kernel point at the least squared distance from r, over the
// warp: lane l holds kernel points l, l + 32, ... (strict <, so a tie keeps
// the lower index, as closest_point does).
__device__ __forceinline__ int warp_closest(const float r[3], const float* kp,
                                            int n_kp, int lane) {
  float m = 3.4e38f;
  int best = n_kp;
  for (int p = lane; p < n_kp; p += 32) {
    const float d2 = sq_dist(r[0], r[1], r[2], kp + 3 * p);
    if (d2 < m) {
      m = d2;
      best = p;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const int b2 = __shfl_xor_sync(0xffffffffu, best, o);
    if (m2 < m || (m2 == m && b2 < best)) {
      m = m2;
      best = b2;
    }
  }
  return best;
}

// dx, one owner per source row: warp s walks the edges that name row s in
// the order of the reverse index (perm sorted stably by source row, off
// the first position of each row's segment; a sample's shadow edges form a
// segment of their own and are never read). For each edge it recomputes
// the Kp influences (lane p holds kernel point p, f32 as in the plain
// version) and adds sum_p w_p * dpart[q, p, :] over the channels (lane c
// holds channels c, c + 32, ...), skipping kernel points with w_p = 0. The
// same order every run, so dx is the same bit for bit; every row of dx is
// written (0 where no edge names it).
template <int CPL>
__global__ void __launch_bounds__(kOwnerWarps * 32)
kpconv_bwd_dx_kernel(const int32_t* __restrict__ perm,
                     const int32_t* __restrict__ off,
                     const float* __restrict__ rel,
                     const float* __restrict__ kpts,
                     const float* __restrict__ dpart, float* __restrict__ dx,
                     long long rows, int Ns, int K, int C, int n_kp,
                     float extent, int influence, int closest) {
  extern __shared__ float s_kp[];                           // [n_kp][3]
  for (int i = threadIdx.x; i < n_kp * 3; i += blockDim.x) s_kp[i] = kpts[i];
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const long long s = (long long)blockIdx.x * kOwnerWarps + threadIdx.x / 32;
  if (s >= rows) return;
  const long long seg = s / Ns * (Ns + 1) + s % Ns;
  const int begin = off[seg], end = off[seg + 1];
  const long long KC = (long long)n_kp * C;
  for (int cb = 0; cb < C; cb += 32 * CPL) {
    float acc[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[j] = 0.f;
    for (int i = begin; i < end; ++i) {
      const long long e = perm[i];
      const float r[3] = {rel[e * 3], rel[e * 3 + 1], rel[e * 3 + 2]};
      const float* dp = dpart + e / K * KC;
      const int best = closest ? warp_closest(r, s_kp, n_kp, lane) : -1;
      for (int g0 = 0; g0 < n_kp; g0 += 32) {
        const int p = g0 + lane;
        const float w = p < n_kp ? edge_weight(r, s_kp, p, best, extent,
                                               influence)
                                 : 0.f;
        const int np = min(32, n_kp - g0);
        for (int j = 0; j < np; ++j) {
          const float wj = __shfl_sync(0xffffffffu, w, j);
          if (wj == 0.f) continue;             // the same for the whole warp
          const float* dpp = dp + (long long)(g0 + j) * C;
#pragma unroll
          for (int t = 0; t < CPL; ++t) {
            const int c = cb + lane + 32 * t;
            if (c < C) acc[t] += wj * dpp[c];
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int c = cb + lane + 32 * t;
      if (c < C) dx[s * C + c] = acc[t];
    }
  }
}

// dx for narrow rows (C <= LPE <= 16), where a lane a channel would leave
// most of a warp idle: warp s takes its segment EPB = 32 / LPE edges at a
// time, lane (j, c) adding edge j's sum_p w_p * dpart[q, p, c]; the batch's
// influences are computed by the whole warp into shared memory (one
// (edge, kernel point) a lane). Lane j sums the edges j, j + EPB, ... in
// order, and a butterfly of xor shuffles (a fixed tree) adds the EPB sums:
// the same bits every run. Every row of dx is written.
template <int LPE>
__global__ void __launch_bounds__(kOwnerWarps * 32)
kpconv_bwd_dx_narrow_kernel(const int32_t* __restrict__ perm,
                            const int32_t* __restrict__ off,
                            const float* __restrict__ rel,
                            const float* __restrict__ kpts,
                            const float* __restrict__ dpart,
                            float* __restrict__ dx, long long rows, int Ns,
                            int K, int C, int n_kp, float extent,
                            int influence, int closest) {
  constexpr int EPB = 32 / LPE;
  extern __shared__ float s_kp[];          // [n_kp][3], then the warps' s_w
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* s_w = s_kp + n_kp * 3 + warp * EPB * n_kp;              // [EPB][n_kp]
  int* s_best = reinterpret_cast<int*>(s_kp + n_kp * 3 +
                                       kOwnerWarps * EPB * n_kp) +
                warp * EPB;                                        // [EPB]
  for (int i = threadIdx.x; i < n_kp * 3; i += blockDim.x) s_kp[i] = kpts[i];
  __syncthreads();
  const long long s = (long long)blockIdx.x * kOwnerWarps + warp;
  if (s >= rows) return;
  const long long seg = s / Ns * (Ns + 1) + s % Ns;
  const int begin = off[seg], end = off[seg + 1];
  const long long KC = (long long)n_kp * C;
  const int j = lane / LPE, c = lane % LPE;
  float acc = 0.f;
  for (int i0 = begin; i0 < end; i0 += EPB) {
    if (closest && lane < EPB) {
      int best = 0;
      if (i0 + lane < end) {
        const long long e = perm[i0 + lane];
        best = closest_point(rel[e * 3], rel[e * 3 + 1], rel[e * 3 + 2], s_kp,
                             n_kp);
      }
      s_best[lane] = best;
    }
    __syncwarp();
    for (int t = lane; t < EPB * n_kp; t += 32) {
      const int jj = t / n_kp, p = t - jj * n_kp;
      float w = 0.f;
      if (i0 + jj < end) {
        const long long e = perm[i0 + jj];
        const float r[3] = {rel[e * 3], rel[e * 3 + 1], rel[e * 3 + 2]};
        w = edge_weight(r, s_kp, p, closest ? s_best[jj] : -1, extent,
                        influence);
      }
      s_w[t] = w;
    }
    __syncwarp();
    if (i0 + j < end && c < C) {
      const float* dp = dpart + (long long)perm[i0 + j] / K * KC + c;
      const float* w = s_w + j * n_kp;
      for (int p = 0; p < n_kp; ++p) {
        const float wp = w[p];
        if (wp != 0.f) acc += wp * dp[(long long)p * C];
      }
    }
    __syncwarp();   // s_w and s_best are refilled for the next batch
  }
#pragma unroll
  for (int o = LPE; o < 32; o <<= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (j == 0 && c < C) dx[s * C + c] = acc;
}

// kernel points the narrow dx kernel takes (its shared memory: 8 warps x
// 8 edges x Kp influences)
constexpr int kNarrowKp = 64;

// The backward of the row gather out[b, q, k] = x[b, nbr[b, q, k]]: dx of
// source row s = the sum of the cotangent rows g[e] of the edges that name
// it, in the order of the reverse index (as for kpconv_bwd_dx_kernel), f32
// sums, lane c holding channels c, c + 32, ... A warp a row; every row
// written.
template <typename T>
__global__ void __launch_bounds__(kOwnerWarps * 32)
gather_rows_bwd_kernel(const int32_t* __restrict__ perm,
                       const int32_t* __restrict__ off,
                       const T* __restrict__ g, T* __restrict__ dx,
                       long long rows, int Ns, int C) {
  const int lane = threadIdx.x % 32;
  const long long s = (long long)blockIdx.x * kOwnerWarps + threadIdx.x / 32;
  if (s >= rows) return;
  const long long seg = s / Ns * (Ns + 1) + s % Ns;
  const int begin = off[seg], end = off[seg + 1];
  for (int c = lane; c < C; c += 32) {
    float acc = 0.f;
    for (int i = begin; i < end; ++i)
      acc += to_float(g[(long long)perm[i] * C + c]);
    dx[s * C + c] = from_float<T>(acc);
  }
}

// partial[s] (BM x BN tile) = sum over the active tiles s, s + S, ... of
// part^T @ g; block (output tile, split s)
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
kpconv_bwd_dw_kernel(const T* __restrict__ part, const float* __restrict__ g,
                     const int* __restrict__ flags,
                     float* __restrict__ partial, long long M,
                     long long n_tiles, int KC, int Cout) {
  using Gm = BlockGemm<T, BM, BN>;
  __shared__ __align__(16) unsigned char smem[Gm::kSmem];
  const int tiles_n = (Cout + BN - 1) / BN;
  const int m0 = blockIdx.x / tiles_n * BM;
  const int n0 = blockIdx.x % tiles_n * BN;
  const int mm = min(BM, KC - m0), nn = min(BN, Cout - n0);
  Gm gm;
  gm.zero();
  for (long long t = blockIdx.y; t < n_tiles; t += gridDim.y) {
    if (!flags[t]) continue;
    const long long row0 = t * kRows;
    const int nrows = (int)min((long long)kRows, M - row0);
    for (int r0 = 0; r0 < nrows; r0 += Gm::BK) {
      const int nk = min(Gm::BK, nrows - r0);
      stage<T, Gm::BK, BM, false>(
          part + (row0 + r0) * KC + m0, KC, 1, nk, mm,
          [&](int k, int i, float v) { Gm::put_a(smem, k, i, v); });
      stage<T, Gm::BK, BN, false>(
          g + (row0 + r0) * Cout + n0, Cout, 1, nk, nn,
          [&](int k, int i, float v) { Gm::put_b(smem, k, i, v); });
      __syncthreads();
      gm.step(smem);
      __syncthreads();
    }
  }
  float* out = partial + ((long long)blockIdx.y * KC + m0) * Cout + n0;
  gm.store([&](int m, int n, float v) {
    if (m < mm && n < nn) out[(long long)m * Cout + n] = v;
  });
}

template <typename T, int BM, int BN>
static int launch_dw(const void* part, const float* g, const int* flags,
                     float* partial, long long M, long long n_tiles, int KC,
                     int Cout, int splits, cudaStream_t stream) {
  const unsigned tiles =
      (unsigned)((KC + BM - 1) / BM * ((Cout + BN - 1) / BN));
  kpconv_bwd_dw_kernel<T, BM, BN><<<dim3(tiles, (unsigned)splits), kThreads, 0,
                                    stream>>>(static_cast<const T*>(part), g,
                                              flags, partial, M, n_tiles, KC,
                                              Cout);
  return (int)cudaGetLastError();
}

template <int CPL>
static int launch_dx(const int32_t* perm, const int32_t* off, const float* rel,
                     const float* kpts, const float* dpart, float* dx,
                     long long rows, int Ns, int K, int C, int n_kp,
                     float extent, int influence, int closest,
                     cudaStream_t stream) {
  kpconv_bwd_dx_kernel<CPL>
      <<<(unsigned)((rows + kOwnerWarps - 1) / kOwnerWarps), kOwnerWarps * 32,
         (size_t)n_kp * 12, stream>>>(perm, off, rel, kpts, dpart, dx, rows,
                                      Ns, K, C, n_kp, extent, influence,
                                      closest);
  return (int)cudaGetLastError();
}

template <int LPE>
static int launch_dx_narrow(const int32_t* perm, const int32_t* off,
                            const float* rel, const float* kpts,
                            const float* dpart, float* dx, long long rows,
                            int Ns, int K, int C, int n_kp, float extent,
                            int influence, int closest, cudaStream_t stream) {
  constexpr int EPB = 32 / LPE;
  const size_t smem = (size_t)n_kp * 12 +
                      (size_t)kOwnerWarps * EPB * (n_kp + 1) * 4;
  kpconv_bwd_dx_narrow_kernel<LPE>
      <<<(unsigned)((rows + kOwnerWarps - 1) / kOwnerWarps), kOwnerWarps * 32,
         smem, stream>>>(perm, off, rel, kpts, dpart, dx, rows, Ns, K, C,
                         n_kp, extent, influence, closest);
  return (int)cudaGetLastError();
}

// dx by the narrow kernel for C <= 16 (and Kp <= kNarrowKp), else a lane a
// channel (CPL channels a lane)
static int launch_dx_any(const int32_t* perm, const int32_t* off,
                         const float* rel, const float* kpts,
                         const float* dpart, float* dx, long long rows, int Ns,
                         int K, int C, int n_kp, float extent, int influence,
                         int closest, cudaStream_t stream) {
  if (n_kp <= kNarrowKp && C <= 16)
    return C <= 4 ? launch_dx_narrow<4>(perm, off, rel, kpts, dpart, dx, rows,
                                        Ns, K, C, n_kp, extent, influence,
                                        closest, stream)
           : C <= 8 ? launch_dx_narrow<8>(perm, off, rel, kpts, dpart, dx,
                                          rows, Ns, K, C, n_kp, extent,
                                          influence, closest, stream)
                    : launch_dx_narrow<16>(perm, off, rel, kpts, dpart, dx,
                                           rows, Ns, K, C, n_kp, extent,
                                           influence, closest, stream);
  return C <= 32    ? launch_dx<1>(perm, off, rel, kpts, dpart, dx, rows, Ns,
                                   K, C, n_kp, extent, influence, closest,
                                   stream)
         : C <= 64  ? launch_dx<2>(perm, off, rel, kpts, dpart, dx, rows, Ns,
                                   K, C, n_kp, extent, influence, closest,
                                   stream)
         : C <= 128 ? launch_dx<4>(perm, off, rel, kpts, dpart, dx, rows, Ns,
                                   K, C, n_kp, extent, influence, closest,
                                   stream)
                    : launch_dx<8>(perm, off, rel, kpts, dpart, dx, rows, Ns,
                                   K, C, n_kp, extent, influence, closest,
                                   stream);
}

template <typename T>
static int launch(const void* x, const void* nbr, const void* rel,
                  const void* weights, const void* kpts, const void* g,
                  const void* perm, const void* off, void* flags, void* part,
                  void* dpart, void* partial, void* dx, void* dw, int B,
                  long long M, int Nq, int Ns, int K, int C, int Cout,
                  int n_kp, float extent, int influence, int closest,
                  int dw_cfg, int splits, cudaStream_t stream) {
  const int32_t* nbr_ = static_cast<const int32_t*>(nbr);
  const float* rel_ = static_cast<const float*>(rel);
  const float* kpts_ = static_cast<const float*>(kpts);
  const float* g_ = static_cast<const float*>(g);
  int* flags_ = static_cast<int*>(flags);
  float* dpart_ = static_cast<float*>(dpart);
  float* partial_ = static_cast<float*>(partial);
  const long long n_tiles = (M + kRows - 1) / kRows;
  const int KC = n_kp * C;
  kpconv_flags_kernel<<<(unsigned)n_tiles, kThreads, 0, stream>>>(
      nbr_, flags_, M, K, Ns);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kpconv_bwd_dpart_kernel<T><<<dim3((unsigned)n_tiles, (KC + 63) / 64),
                               kThreads, 0, stream>>>(
      g_, static_cast<const float*>(weights), flags_, dpart_, M, KC, Cout);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int32_t* perm_ = static_cast<const int32_t*>(perm);
  const int32_t* off_ = static_cast<const int32_t*>(off);
  float* dx_ = static_cast<float*>(dx);
  const long long rows = (long long)B * Ns;
  int rc = launch_dx_any(perm_, off_, rel_, kpts_, dpart_, dx_, rows, Ns, K,
                         C, n_kp, extent, influence, closest, stream);
  if (rc != 0) return rc;
  const size_t smem_edge = edge_smem(K, n_kp);
  e = cudaFuncSetAttribute(kpconv_part_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_edge);
  if (e != cudaSuccess) return (int)e;
  kpconv_part_kernel<T><<<dim3((unsigned)(n_tiles * (kRows / kGroupRows)),
                                   (unsigned)((C + kEdgeC - 1) / kEdgeC)),
                              kThreads, smem_edge, stream>>>(
      static_cast<const T*>(x), nbr_, rel_, kpts_, flags_,
      static_cast<T*>(part), M, Nq, Ns, K, C, n_kp, extent, influence,
      closest);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  switch (dw_cfg) {
    case 0: rc = launch_dw<T, 256, 16>(part, g_, flags_, partial_, M, n_tiles,
                                       KC, Cout, splits, stream); break;
    case 1: rc = launch_dw<T, 128, 32>(part, g_, flags_, partial_, M, n_tiles,
                                       KC, Cout, splits, stream); break;
    default: rc = launch_dw<T, 64, 64>(part, g_, flags_, partial_, M, n_tiles,
                                       KC, Cout, splits, stream); break;
  }
  if (rc != 0) return rc;
  return launch_split_reduce(partial_, static_cast<float*>(dw),
                             (long long)KC * Cout, splits, stream);
}

}  // namespace dpcr

// x [B,Ns,C] (float32 or bfloat16 by `dtype`), nbr [B,Nq,K] int32, rel
// [B,Nq,K,3], weights [Kp,C,Cout], kpts [Kp,3] and g [B,Nq,Cout] float32;
// the reverse edge index of nbr (`ops.kpconv.reverse_edges`): perm int32
// [B*Nq*K], the flat edges sorted stably by source row with each sample's
// shadow edges after its rows, off int32 [B*(Ns+1)+1], where edges
// perm[off[b*(Ns+1)+j] .. off[b*(Ns+1)+j+1]) name row j of sample b; dx
// [B,Ns,C] and dw [Kp,C,Cout] float32 (written); all contiguous. Scratch,
// as `kernels.kpconv_bwd_plan` sizes it, with tiles = ceil(B*Nq / 64):
// flags int32 [tiles]; part [tiles*64, Kp*C] of x's dtype; dpart float32
// [tiles*64, Kp*C]; partial float32 [splits, Kp*C, Cout]. dw_cfg picks the
// dW product's output tile (0: 256 x 16, 1: 128 x 32, 2: 64 x 64), splits
// its row splits (1 to 65535). Limits and codes as for kpconv_fused_launch,
// and Kp <= 4096, the edge kernel's shared memory within a block's.
// Returns 0 on success, a CUDA error code, or a negative dpcr::ArgError.
extern "C" int kpconv_fused_bwd_launch(
    int dtype, const void* x, const void* nbr, const void* rel,
    const void* weights, const void* kpts, const void* g, const void* perm,
    const void* off, void* flags, void* part, void* dpart, void* partial,
    void* dx, void* dw, int B, int Nq, int Ns, int K, int C, int Cout,
    int n_kp, float extent, int influence, int closest, int dw_cfg,
    int splits, void* stream) {
  if (B < 0 || Nq < 0 || Ns < 1 || K < 1 || C < 1 || Cout < 1 || Cout > 256 ||
      n_kp < 1 || n_kp > 4096 || influence < 0 || influence > 2 ||
      (long long)B * Ns > 0x7fffffffLL ||
      (long long)B * Nq * K * 3 > 0x7fffffffLL ||
      (long long)n_kp * C > 64LL * 65535 || C > 32 * 65535 || dw_cfg < 0 ||
      dw_cfg > 2 ||
      splits < 1 || splits > 65535 ||
      dpcr::edge_smem(K, n_kp) > 232448)
    return dpcr::kBadShape;
  const long long M = (long long)B * Nq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0) {   // no row: dx and dW are zero
    cudaError_t e = cudaMemsetAsync(dx, 0, (size_t)B * Ns * C * 4, s);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaMemsetAsync(dw, 0, (size_t)n_kp * C * Cout * 4, s);
  }
  if (dtype == dpcr::kFloat32)
    return dpcr::launch<float>(x, nbr, rel, weights, kpts, g, perm, off,
                               flags, part, dpart, partial, dx, dw, B, M, Nq,
                               Ns, K, C, Cout, n_kp, extent, influence,
                               closest, dw_cfg, splits, s);
  if (dtype == dpcr::kBFloat16)
    return dpcr::launch<__nv_bfloat16>(
        x, nbr, rel, weights, kpts, g, perm, off, flags, part, dpart, partial,
        dx, dw, B, M, Nq, Ns, K, C, Cout, n_kp, extent, influence, closest,
        dw_cfg, splits, s);
  return dpcr::kBadDType;
}

// The backward of a row gather by a neighbour list: g [B*Nq*K, C] (float32
// or bfloat16 by `dtype`), the list's reverse edge index perm, off as for
// kpconv_fused_bwd_launch, dx [B*Ns, C] of g's dtype (written: each row
// the f32 sum of the g rows of the edges that name it, in perm's order).
// Returns 0 on success, a CUDA error code, or a negative dpcr::ArgError.
extern "C" int gather_rows_bwd_launch(int dtype, const void* perm,
                                      const void* off, const void* g,
                                      void* dx, int B, int Ns, int C,
                                      void* stream) {
  if (B < 0 || Ns < 1 || C < 1 || (long long)B * Ns > 0x7fffffffLL)
    return dpcr::kBadShape;
  const long long rows = (long long)B * Ns;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks =
      (unsigned)((rows + dpcr::kOwnerWarps - 1) / dpcr::kOwnerWarps);
  const int32_t* perm_ = static_cast<const int32_t*>(perm);
  const int32_t* off_ = static_cast<const int32_t*>(off);
  if (dtype == dpcr::kFloat32)
    dpcr::gather_rows_bwd_kernel<float><<<blocks, dpcr::kOwnerWarps * 32, 0,
                                          s>>>(
        perm_, off_, static_cast<const float*>(g), static_cast<float*>(dx),
        rows, Ns, C);
  else if (dtype == dpcr::kBFloat16)
    dpcr::gather_rows_bwd_kernel<__nv_bfloat16>
        <<<blocks, dpcr::kOwnerWarps * 32, 0, s>>>(
            perm_, off_, static_cast<const __nv_bfloat16*>(g),
            static_cast<__nv_bfloat16*>(dx), rows, Ns, C);
  else
    return dpcr::kBadDType;
  return (int)cudaGetLastError();
}
