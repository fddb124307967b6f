// kpconv_fused: the fused rigid kernel-point convolution, forward.
//
// Replaces: dpcr_agb_tpu/ops/pallas_kpconv.py _fwd_kernel (:101, called at
// :222) and the XLA row gather in front of it (models/kpconv.py :315-324).
// Per query row q with neighbours nbr[q, 0..K):
//   w[k, p]  = influence(|rel[q, k] - kp[p]|^2)       (closest: first argmin)
//   part[p]  = sum_k w[k, p] * x[nbr[q, k]]           [Kp, C]
//   out[q]   = sum_p part[p] @ W[p]                   [Cout], f32
// The TPU kernel is handed the gathered features nx [M, K, C] because
// Mosaic cannot gather rows; here the block gathers the rows of x itself,
// so neither nx nor the influences nor part ever reach device memory. A
// shadow neighbour (index Ns) is skipped, which is what its zero feature
// row would contribute, so the table needs no padding row.
//
// What bounds it on an H100: operations at the wide levels (per row with a
// neighbour 2*Kp*C*Cout for the products with W, and 2*C per edge and
// kernel point with a non-zero weight for the weighted sums), bytes at
// level 0 (C = 16), where x, nbr, rel and the output are all there is.
// This first version runs the products on the f32 cores, computes every
// weight of every slot, and re-reads W from L2 for every 16 rows; it is
// latency-bound, far from either bound.
//
// Design: a block of 256 threads takes kTQ = 16 query rows. For each chunk
// of 16 kernel points it computes the edge weights once into shared memory
// (one thread per edge). Then for each chunk of 64 input channels:
//   gather: one thread per (row, channel) walks the row's K neighbours,
//     reads x once and adds w[k, p] * x into 16 registers, one per kernel
//     point of the chunk (so x is gathered once, not once per kernel
//     point), and leaves part[p][c][row] in shared memory;
//   product: each thread owns output channel d of NJ rows (Cout = 16 NJ;
//     any other Cout <= 256 takes a generic mapping) and adds part * W
//     over the chunk; W is read from global memory, coalesced over d, and
//     part as broadcast reads from shared memory.
// W (3.9 MB at level 4) fits no block's shared memory; tiling over kernel
// points and channels keeps the block at ~110 KB, two blocks an SM.
// bf16 mode (T = __nv_bfloat16): x is bf16; w, each product w*x, part and W
// are rounded to bf16; every sum is f32; the output is f32.
#include "kpconv_common.cuh"

namespace dpcr {

constexpr int kCC = 64;                               // channels of a chunk
constexpr int kMaxAcc = kTQ * 256 / kThreads;         // outputs of a thread

// NJ > 0: Cout == 16 * NJ, thread owns channel tid % Cout of NJ rows;
// NJ == 0: any Cout <= 256, thread owns outputs tid + j * kThreads.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
kpconv_fwd_kernel(const T* __restrict__ x, const int32_t* __restrict__ nbr,
                  const float* __restrict__ rel,
                  const float* __restrict__ weights,
                  const float* __restrict__ kpts, float* __restrict__ out,
                  long long M, int Nq, int Ns, int K, int C, int Cout,
                  int n_kp, float extent, int influence, int closest) {
  extern __shared__ __align__(16) float smem[];
  const int ws = w_stride(K);
  float* s_w = smem;                          // [kTQ][K][kPC] (+4 a row)
  float* s_part = s_w + kTQ * ws;             // [kPC][kCC][kTQ]
  int* s_src = reinterpret_cast<int*>(s_part + kPC * kCC * kTQ);  // [kTQ][K]
  float* s_kp = reinterpret_cast<float*>(s_src + kTQ * K);        // [n_kp][3]

  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * kTQ;
  for (int i = tid; i < n_kp * 3; i += kThreads) s_kp[i] = kpts[i];
  for (int i = tid; i < kTQ * K; i += kThreads) {
    const int q = i / K;
    const long long row = row0 + q;
    s_src[i] = row < M ? source_row(nbr, row, i - q * K, K, Nq, Ns) : -1;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) acc[j] = 0.f;
  __syncthreads();

  for (int p0 = 0; p0 < n_kp; p0 += kPC) {
    const int np = min(kPC, n_kp - p0);
    // edge weights of this chunk of kernel points, rounded to T
    for (int i = tid; i < kTQ * K; i += kThreads) {
      const int q = i / K;
      float* w = s_w + q * ws + (i - q * K) * kPC;
      if (s_src[i] < 0) {
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
        w[j] = j < np ? round_to<T>(edge_weight(rr, s_kp, p0 + j, best,
                                                extent, influence))
                      : 0.f;
    }
    __syncthreads();

    for (int c0 = 0; c0 < C; c0 += kCC) {
      const int nc = min(kCC, C - c0);
      // gather: part[p][c][row] = sum_k w[row][k][p] * x[src[row][k]][c]
      for (int i = tid; i < kTQ * nc; i += kThreads) {
        const int q = i / nc;
        const int cc = i - q * nc;
        float part[kPC];
#pragma unroll
        for (int j = 0; j < kPC; ++j) part[j] = 0.f;
        for (int k = 0; k < K; ++k) {
          const int src = s_src[q * K + k];
          if (src < 0) continue;
          const float xv = to_float(x[(size_t)src * C + c0 + cc]);
          const float4* w4 =
              reinterpret_cast<const float4*>(s_w + q * ws + k * kPC);
#pragma unroll
          for (int v = 0; v < kPC / 4; ++v) {
            const float4 w = w4[v];
            part[4 * v + 0] += round_to<T>(w.x * xv);
            part[4 * v + 1] += round_to<T>(w.y * xv);
            part[4 * v + 2] += round_to<T>(w.z * xv);
            part[4 * v + 3] += round_to<T>(w.w * xv);
          }
        }
#pragma unroll
        for (int j = 0; j < kPC; ++j)
          s_part[(j * kCC + cc) * kTQ + q] = round_to<T>(part[j]);
      }
      __syncthreads();

      // product: out[row][d] += sum_{p, c} part[p][c][row] * W[p][c][d]
      if constexpr (NJ > 0) {
        const int d = tid % Cout;
        const int q0 = (tid / Cout) * NJ;
        for (int j = 0; j < np; ++j) {
          const float* wrow = weights + ((size_t)(p0 + j) * C + c0) * Cout + d;
          const float* prow = s_part + j * kCC * kTQ + q0;
          for (int cc = 0; cc < nc; ++cc) {
            const float wv = round_to<T>(wrow[(size_t)cc * Cout]);
            if constexpr (NJ >= 4) {
              const float4* p4 =
                  reinterpret_cast<const float4*>(prow + cc * kTQ);
#pragma unroll
              for (int v = 0; v < NJ / 4; ++v) {
                const float4 pv = p4[v];
                acc[4 * v + 0] += pv.x * wv;
                acc[4 * v + 1] += pv.y * wv;
                acc[4 * v + 2] += pv.z * wv;
                acc[4 * v + 3] += pv.w * wv;
              }
            } else {
#pragma unroll
              for (int jj = 0; jj < NJ; ++jj)
                acc[jj] += prow[cc * kTQ + jj] * wv;
            }
          }
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < kMaxAcc; ++jj) {
          const int i = tid + jj * kThreads;
          if (i < kTQ * Cout) {
            const int q = i / Cout;
            const int d = i - q * Cout;
            float a = acc[jj];
            for (int j = 0; j < np; ++j) {
              const float* wrow =
                  weights + ((size_t)(p0 + j) * C + c0) * Cout + d;
              const float* prow = s_part + j * kCC * kTQ + q;
              for (int cc = 0; cc < nc; ++cc)
                a += prow[cc * kTQ] * round_to<T>(wrow[(size_t)cc * Cout]);
            }
            acc[jj] = a;
          }
        }
      }
      __syncthreads();  // s_part (and after the last chunk s_w) is reused
    }
  }

  if constexpr (NJ > 0) {
    const int d = tid % Cout;
    const int q0 = (tid / Cout) * NJ;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
      if (row0 + q0 + jj < M) out[(row0 + q0 + jj) * Cout + d] = acc[jj];
  } else {
#pragma unroll
    for (int jj = 0; jj < kMaxAcc; ++jj) {
      const int i = tid + jj * kThreads;
      if (i < kTQ * Cout && row0 + i / Cout < M)
        out[row0 * Cout + i] = acc[jj];
    }
  }
}

template <typename T, int NJ>
static int launch_nj(const void* x, const void* nbr, const void* rel,
                     const void* weights, const void* kpts, void* out,
                     long long M, int Nq, int Ns, int K, int C, int Cout,
                     int n_kp, float extent, int influence, int closest,
                     cudaStream_t stream) {
  const size_t smem = (size_t)(kTQ * w_stride(K) + kPC * kCC * kTQ) * 4 +
                      (size_t)kTQ * K * 4 + (size_t)n_kp * 3 * 4;
  if (smem > 232448) return kBadShape;
  cudaError_t e = cudaFuncSetAttribute(
      kpconv_fwd_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (M + kTQ - 1) / kTQ;
  kpconv_fwd_kernel<T, NJ><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(nbr),
      static_cast<const float*>(rel), static_cast<const float*>(weights),
      static_cast<const float*>(kpts), static_cast<float*>(out), M, Nq, Ns, K,
      C, Cout, n_kp, extent, influence, closest);
  return (int)cudaGetLastError();
}

template <typename T, typename... Args>
static int launch(int Cout, Args... args) {
  switch (Cout) {
    case 16: return launch_nj<T, 1>(args...);
    case 32: return launch_nj<T, 2>(args...);
    case 64: return launch_nj<T, 4>(args...);
    case 128: return launch_nj<T, 8>(args...);
    case 256: return launch_nj<T, 16>(args...);
    default: return launch_nj<T, 0>(args...);
  }
}

}  // namespace dpcr

// x [B,Ns,C] (float32 or bfloat16 by `dtype`), nbr [B,Nq,K] int32, rel
// [B,Nq,K,3] float32, weights [Kp,C,Cout] float32, kpts [Kp,3] float32,
// out [B,Nq,Cout] float32; all contiguous. 1 <= Cout <= 256; B*Ns and
// B*Nq*K*3 below 2^31. influence: 0 linear, 1 gaussian, 2 constant;
// closest: 1 for aggregation 'closest'.
// Returns 0 on success, a CUDA error code, or a negative dpcr::ArgError.
extern "C" int kpconv_fused_launch(int dtype, const void* x, const void* nbr,
                                   const void* rel, const void* weights,
                                   const void* kpts, void* out, int B, int Nq,
                                   int Ns, int K, int C, int Cout, int n_kp,
                                   float extent, int influence, int closest,
                                   void* stream) {
  if (B < 0 || Nq < 0 || Ns < 1 || K < 1 || C < 1 || Cout < 1 || Cout > 256 ||
      n_kp < 1 || influence < 0 || influence > 2 ||
      (long long)B * Ns > 0x7fffffffLL ||
      (long long)B * Nq * K * 3 > 0x7fffffffLL)
    return dpcr::kBadShape;
  const long long M = (long long)B * Nq;
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dpcr::kFloat32)
    return dpcr::launch<float>(Cout, x, nbr, rel, weights, kpts, out, M, Nq,
                               Ns, K, C, Cout, n_kp, extent, influence,
                               closest, s);
  if (dtype == dpcr::kBFloat16)
    return dpcr::launch<__nv_bfloat16>(Cout, x, nbr, rel, weights, kpts, out,
                                       M, Nq, Ns, K, C, Cout, n_kp, extent,
                                       influence, closest, s);
  return dpcr::kBadDType;
}
