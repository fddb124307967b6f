// kpconv_fused_bwd: the backward of the fused rigid kernel-point
// convolution (kpconv_fwd.cu): dx and dW from the cotangent g.
//
// Replaces: dpcr_agb_tpu/ops/pallas_kpconv.py _bwd_kernel (:121, called at
// :249) and the XLA scatter-add behind it (the transpose of the row gather,
// models/kpconv.py :59-72). Per query row q, with w and part as in the
// forward:
//   dpart[p] = g[q] @ W[p]^T                                   [Kp, C]
//   dx[nbr[q, k]] += sum_p w[k, p] * dpart[p]                  (no shadow)
//   dW[p]   += part[p]^T g[q]                                  [C, Cout]
// There is no gradient to rel. The TPU kernel returns dnx [M, K, C] for XLA
// to scatter, and sums dW by revisiting one output block over its
// sequential grid. A CUDA grid has no order, so both sums are f32 atomics
// into outputs the caller has zeroed:
//   dx: a written dnx would be M*K*C values (1.3 GB at level 1 of a batch
//     of 16 plots) only to be read once by a scatter, so each block adds its
//     edges' shares straight into dx, 16 consecutive channels per atomic
//     request;
//   dW: a block keeps a [channel tile, Cout] tile of one kernel point in
//     registers over all the rows of its split, and adds it into dW once at
//     its end. A second reduction pass over per-split partials would make
//     the sum's order fixed; the atomics are simpler and the splits few.
// Atomics add in an order that varies from run to run, so dx and dW agree
// with the plain version to f32 rounding, not bit for bit.
//
// What bounds it on an H100: operations at the wide levels (twice the
// forward's products), the atomics' traffic at level 0. Three kernels run
// on the stream, one after another:
//   transpose: wt[p][d][c] = W[p][c][d] (rounded to T) into scratch, so
//     that the dx kernel reads W coalesced over c;
//   dx: a block of 256 threads takes 16 query rows and computes the edge
//     weights as the forward does (unrounded: the Pallas body keeps them
//     f32 here). For each chunk of 16 channels, thread (c, p) computes
//     dpart[row][p][c] for the 16 rows as a product over Cout with g in
//     shared memory; then one thread per (edge, c) sums w * dpart over the
//     kernel points and adds it to dx;
//   dW: block (p, channel tile, row split) walks its rows 16 at a time:
//     the edge weights of kernel point p, part[row][c] by the forward's
//     gather, then the outer product part x g into a 4x4 register tile per
//     thread.
// bf16 mode: x is bf16; g and W are rounded to bf16 in dpart and dW; w,
// each product w*x and part are rounded as in the forward for dW; w stays
// f32 for dx; every sum is f32; dx and dW are f32.
#include <algorithm>

#include "kpconv_common.cuh"

namespace dpcr {

constexpr int kDC = 16;  // channels of a chunk in the dx kernel

template <typename T>
__global__ void kpconv_wt_kernel(const float* __restrict__ weights,
                                 float* __restrict__ wt, int n_kp, int C,
                                 int Cout) {
  const long long n = (long long)n_kp * C * Cout;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    const long long pd = i / C;
    const int d = (int)(pd % Cout);
    const long long p = pd / Cout;
    wt[i] = round_to<T>(weights[(p * C + c) * Cout + d]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
kpconv_dx_kernel(const int32_t* __restrict__ nbr,
                 const float* __restrict__ rel, const float* __restrict__ wt,
                 const float* __restrict__ kpts, const float* __restrict__ g,
                 float* __restrict__ dx, long long M, int Nq, int Ns, int K,
                 int C, int Cout, int n_kp, float extent, int influence,
                 int closest) {
  extern __shared__ __align__(16) float smem[];
  const int ws = w_stride(K);
  float* s_w = smem;                           // [kTQ][K][kPC] (+4 a row)
  float* s_g = s_w + kTQ * ws;                 // [Cout][kTQ]
  float* s_dpart = s_g + Cout * kTQ;           // [kTQ][kPC][kDC]
  int* s_dst = reinterpret_cast<int*>(s_dpart + kTQ * kPC * kDC);  // [kTQ][K]
  float* s_kp = reinterpret_cast<float*>(s_dst + kTQ * K);         // [n_kp][3]

  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * kTQ;
  for (int i = tid; i < n_kp * 3; i += kThreads) s_kp[i] = kpts[i];
  for (int i = tid; i < kTQ * K; i += kThreads) {
    const int q = i / K;
    const long long row = row0 + q;
    s_dst[i] = row < M ? source_row(nbr, row, i - q * K, K, Nq, Ns) : -1;
  }
  for (int i = tid; i < kTQ * Cout; i += kThreads) {
    const int q = i / Cout;
    const int d = i - q * Cout;
    s_g[d * kTQ + q] =
        row0 + q < M ? round_to<T>(g[(row0 + q) * Cout + d]) : 0.f;
  }
  __syncthreads();

  const int cc = tid % kDC;   // this thread's channel of the chunk
  const int pj = tid / kDC;   // and its kernel point of the chunk
  for (int p0 = 0; p0 < n_kp; p0 += kPC) {
    const int np = min(kPC, n_kp - p0);
    for (int i = tid; i < kTQ * K; i += kThreads) {
      const int q = i / K;
      float* w = s_w + q * ws + (i - q * K) * kPC;
      if (s_dst[i] < 0) {
#pragma unroll
        for (int j = 0; j < kPC; ++j) w[j] = 0.f;
        continue;
      }
      const float* r = rel + ((row0 + q) * K + (i - q * K)) * 3;
      const float rr[3] = {r[0], r[1], r[2]};
      const int best =
          closest ? closest_point(rr[0], rr[1], rr[2], s_kp, n_kp) : -1;
#pragma unroll
      for (int j = 0; j < kPC; ++j)
        w[j] = j < np ? edge_weight(rr, s_kp, p0 + j, best, extent, influence)
                      : 0.f;
    }
    __syncthreads();

    for (int c0 = 0; c0 < C; c0 += kDC) {
      const int nc = min(kDC, C - c0);
      // dpart[row][p][c] = sum_d g[row][d] * W[p][c][d]
      float a[kTQ];
#pragma unroll
      for (int q = 0; q < kTQ; ++q) a[q] = 0.f;
      if (cc < nc && pj < np) {
        const float* wrow = wt + (size_t)(p0 + pj) * Cout * C + c0 + cc;
        for (int d = 0; d < Cout; ++d) {
          const float wv = wrow[(size_t)d * C];
          const float4* g4 = reinterpret_cast<const float4*>(s_g + d * kTQ);
#pragma unroll
          for (int v = 0; v < kTQ / 4; ++v) {
            const float4 gv = g4[v];
            a[4 * v + 0] += gv.x * wv;
            a[4 * v + 1] += gv.y * wv;
            a[4 * v + 2] += gv.z * wv;
            a[4 * v + 3] += gv.w * wv;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kTQ; ++q)
        s_dpart[(q * kPC + pj) * kDC + cc] = a[q];
      __syncthreads();

      // dx[dst][c] += sum_p w[edge][p] * dpart[row][p][c]
      for (int i = tid; i < kTQ * K * kDC; i += kThreads) {
        const int e = i / kDC;          // edge = row * K + k; i % kDC == cc
        const int dst = s_dst[e];
        if (dst < 0 || cc >= nc) continue;
        const int q = e / K;
        const float* w = s_w + q * ws + (e - q * K) * kPC;
        const float* dp = s_dpart + q * kPC * kDC + cc;
        float v = 0.f;
#pragma unroll
        for (int j = 0; j < kPC; ++j) v += w[j] * dp[j * kDC];
        atomicAdd(dx + (size_t)dst * C + c0 + cc, v);
      }
      __syncthreads();
    }
  }
}

// Block (blockIdx.x = p * n_ctiles + channel tile, blockIdx.y = row split).
// Thread (ty, tx) of a TY x TX layout owns dW[p][c0 + ty + TY*i][tx + TX*j],
// i, j < 4.
template <typename T>
__global__ void __launch_bounds__(kThreads)
kpconv_dw_kernel(const T* __restrict__ x, const int32_t* __restrict__ nbr,
                 const float* __restrict__ rel, const float* __restrict__ kpts,
                 const float* __restrict__ g, float* __restrict__ dw,
                 long long M, int Nq, int Ns, int K, int C, int Cout, int n_kp,
                 float extent, int influence, int closest, int ct, int TX,
                 long long rows_per_split) {
  extern __shared__ __align__(16) float smem[];
  float* s_w = smem;                                   // [kTQ][K]
  float* s_part = s_w + kTQ * K;                       // [kTQ][ct]
  float* s_g = s_part + kTQ * ct;                      // [kTQ][Cout]
  int* s_src = reinterpret_cast<int*>(s_g + kTQ * Cout);        // [kTQ][K]
  float* s_kp = reinterpret_cast<float*>(s_src + kTQ * K);      // [n_kp][3]

  const int tid = threadIdx.x;
  const int n_ctiles = (C + ct - 1) / ct;
  const int p = blockIdx.x / n_ctiles;
  const int c0 = (blockIdx.x - p * n_ctiles) * ct;
  const int nc = min(ct, C - c0);
  const int TY = kThreads / TX;
  const int tx = tid % TX, ty = tid / TX;
  const long long r_begin = (long long)blockIdx.y * rows_per_split;
  const long long r_end = min(M, r_begin + rows_per_split);

  for (int i = tid; i < n_kp * 3; i += kThreads) s_kp[i] = kpts[i];
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  __syncthreads();

  for (long long r0 = r_begin; r0 < r_end; r0 += kTQ) {
    // the edges' rows of x and their weights for kernel point p
    for (int i = tid; i < kTQ * K; i += kThreads) {
      const int q = i / K;
      const int k = i - q * K;
      const long long row = r0 + q;
      int src = -1;
      float w = 0.f;
      if (row < r_end) {
        src = source_row(nbr, row, k, K, Nq, Ns);
        if (src >= 0) {
          const float* r = rel + (row * K + k) * 3;
          const float rr[3] = {r[0], r[1], r[2]};
          const int best =
              closest ? closest_point(rr[0], rr[1], rr[2], s_kp, n_kp) : -1;
          w = round_to<T>(edge_weight(rr, s_kp, p, best, extent, influence));
        }
      }
      s_src[i] = src;
      s_w[i] = w;
    }
    for (int i = tid; i < kTQ * Cout; i += kThreads) {
      const long long row = r0 + i / Cout;
      s_g[i] = row < r_end ? round_to<T>(g[r0 * Cout + i]) : 0.f;
    }
    __syncthreads();

    // part[row][c] = sum_k w[row][k] * x[src[row][k]][c]
    for (int i = tid; i < kTQ * nc; i += kThreads) {
      const int q = i / nc;
      const int cc = i - q * nc;
      float a = 0.f;
      for (int k = 0; k < K; ++k) {
        const int src = s_src[q * K + k];
        if (src < 0) continue;
        a += round_to<T>(s_w[q * K + k] *
                         to_float(x[(size_t)src * C + c0 + cc]));
      }
      s_part[q * ct + cc] = round_to<T>(a);
    }
    __syncthreads();

    // dW tile += part^T g
    for (int q = 0; q < kTQ; ++q) {
      float pv[4], gv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int cc = ty + TY * i;
        pv[i] = cc < nc ? s_part[q * ct + cc] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = tx + TX * j;
        gv[j] = d < Cout ? s_g[q * Cout + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += pv[i] * gv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int cc = ty + TY * i;
    if (cc >= nc) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = tx + TX * j;
      if (d < Cout && acc[i][j] != 0.f)
        atomicAdd(dw + ((size_t)p * C + c0 + cc) * Cout + d, acc[i][j]);
    }
  }
}

template <typename T>
static int launch(const void* x, const void* nbr, const void* rel,
                  const void* weights, const void* kpts, const void* g,
                  void* wt, void* dx, void* dw, long long M, int Nq, int Ns,
                  int K, int C, int Cout, int n_kp, float extent,
                  int influence, int closest, cudaStream_t stream) {
  const int32_t* nbr_ = static_cast<const int32_t*>(nbr);
  const float* rel_ = static_cast<const float*>(rel);
  const float* kp_ = static_cast<const float*>(kpts);
  const float* g_ = static_cast<const float*>(g);
  // transpose, then dx
  const long long n = (long long)n_kp * C * Cout;
  const unsigned tb = (unsigned)std::min((n + 255) / 256, 4096LL);
  kpconv_wt_kernel<T><<<tb, 256, 0, stream>>>(
      static_cast<const float*>(weights), static_cast<float*>(wt), n_kp, C,
      Cout);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem_dx = (size_t)(kTQ * w_stride(K) + Cout * kTQ +
                                  kTQ * kPC * kDC + kTQ * K + n_kp * 3) * 4;
  if (smem_dx > 232448) return kBadShape;
  e = cudaFuncSetAttribute(kpconv_dx_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_dx);
  if (e != cudaSuccess) return (int)e;
  kpconv_dx_kernel<T><<<(unsigned)((M + kTQ - 1) / kTQ), kThreads, smem_dx,
                        stream>>>(nbr_, rel_, static_cast<const float*>(wt),
                                  kp_, g_, static_cast<float*>(dx), M, Nq, Ns,
                                  K, C, Cout, n_kp, extent, influence,
                                  closest);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  // dW: TX threads over Cout (4 channels each), TY over the channel tile
  int TX = 1;
  while (TX * 4 < Cout) TX *= 2;
  const int TY = kThreads / TX;
  const int ct = std::min(C, std::min(4 * TY, 64));
  const int n_ctiles = (C + ct - 1) / ct;
  // enough row splits to fill the card about eight blocks an SM
  const long long groups = (M + kTQ - 1) / kTQ;
  long long splits = 1056 / ((long long)n_kp * n_ctiles);
  splits = std::max(1LL, std::min(splits, std::min(groups, 65535LL)));
  const long long rows_per_split = (groups + splits - 1) / splits * kTQ;
  splits = (M + rows_per_split - 1) / rows_per_split;
  const size_t smem_dw =
      (size_t)(2 * kTQ * K + kTQ * ct + kTQ * Cout + n_kp * 3) * 4;
  if (smem_dw > 232448) return kBadShape;
  e = cudaFuncSetAttribute(kpconv_dw_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_dw);
  if (e != cudaSuccess) return (int)e;
  kpconv_dw_kernel<T><<<dim3((unsigned)(n_kp * n_ctiles), (unsigned)splits),
                        kThreads, smem_dw, stream>>>(
      static_cast<const T*>(x), nbr_, rel_, kp_, g_, static_cast<float*>(dw),
      M, Nq, Ns, K, C, Cout, n_kp, extent, influence, closest, ct, TX,
      rows_per_split);
  return (int)cudaGetLastError();
}

}  // namespace dpcr

// x [B,Ns,C] (float32 or bfloat16 by `dtype`), nbr [B,Nq,K] int32, rel
// [B,Nq,K,3], weights [Kp,C,Cout], kpts [Kp,3] and g [B,Nq,Cout] float32;
// wt: float32 scratch of Kp*Cout*C values; dx [B,Ns,C] and dw [Kp,C,Cout]
// float32, zeroed by the caller (the kernels add into them); all
// contiguous. Limits and codes as for kpconv_fused_launch.
// Returns 0 on success, a CUDA error code, or a negative dpcr::ArgError.
extern "C" int kpconv_fused_bwd_launch(int dtype, const void* x,
                                       const void* nbr, const void* rel,
                                       const void* weights, const void* kpts,
                                       const void* g, void* wt, void* dx,
                                       void* dw, int B, int Nq, int Ns, int K,
                                       int C, int Cout, int n_kp, float extent,
                                       int influence, int closest,
                                       void* stream) {
  if (B < 0 || Nq < 0 || Ns < 1 || K < 1 || C < 1 || Cout < 1 || Cout > 256 ||
      n_kp < 1 || n_kp > 4096 || influence < 0 || influence > 2 ||
      (long long)B * Ns > 0x7fffffffLL ||
      (long long)B * Nq * K * 3 > 0x7fffffffLL)
    return dpcr::kBadShape;
  const long long M = (long long)B * Nq;
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dpcr::kFloat32)
    return dpcr::launch<float>(x, nbr, rel, weights, kpts, g, wt, dx, dw, M,
                               Nq, Ns, K, C, Cout, n_kp, extent, influence,
                               closest, s);
  if (dtype == dpcr::kBFloat16)
    return dpcr::launch<__nv_bfloat16>(x, nbr, rel, weights, kpts, g, wt, dx,
                                       dw, M, Nq, Ns, K, C, Cout, n_kp, extent,
                                       influence, closest, s);
  return dpcr::kBadDType;
}
