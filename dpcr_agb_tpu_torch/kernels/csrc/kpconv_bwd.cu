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
// to scatter and sums dW by revisiting one output block over its sequential
// grid. Here dx is summed by f32 atomics into a buffer the caller zeroed (a
// written dnx would be 1.3 GB at level 1 of a batch of 16 plots), so dx
// agrees with the plain version to f32 rounding, not bit for bit; dW is
// summed in a fixed order and is the same bit for bit from run to run.
//
// What bounds it on an H100. Bytes, at every KPCNN layer (bs16): x, nbr,
// rel, W and g read once, dx and dW written once, 0.03-0.06 ms; the
// products need 2 * Kp * C * Cout operations per row with a real neighbour
// twice, plus 2 * C per (real edge, kernel point) twice, under 0.03 ms on
// the f32 cores. The first version was ~100x off that bound (3.1 ms at
// level 0, 6.9 ms at level 4): its dW kernel gathered every row of x and
// recomputed every influence once per kernel point and channel tile (15x
// at level 0, 240x at level 4), and both kernels worked every padding row
// (25% of level 0's rows, 92% of level 4's have no real neighbour).
//
// Design: rows in tiles of kRows = 64; five kernels, one after another.
//   flags: one read of a tile's nbr says whether any row of it has a real
//     neighbour; every later kernel skips a tile without one at once (no
//     host sync: the tile count never leaves the card);
//   dpart: dpart [rows, Kp*C] = g [rows, Cout] @ W^T, one 64 x 64 output
//     tile a block, W staged through shared memory, into scratch;
//   edge: a block per 16 rows and 32 channels computes each real edge's
//     Kp influences once into shared memory, adds sum_p w * dpart into dx
//     by one 16-byte vector atomic (red.global.add.v4.f32, sm_90) per edge
//     and 4 channels where C is a multiple of 4, and forms part by walking
//     each row's slots in order (so part, and with it dW, is the same from
//     run to run), gathering the neighbours' channels of x once for all
//     kernel points; part [rows, Kp*C] goes to scratch in T;
//   dw: the split-K product part^T @ g: block (output tile, split s) sums
//     the active tiles s, s + S, s + 2S, ... into a register tile and writes
//     it to its own slice of a partials buffer;
//   reduce: dW = the partials summed over s in a fixed order.
// Both products are block-tiled through shared memory: in f32 on the f32
// cores (4 x 4 outputs a thread; no TF32), in bf16 mode on the tensor
// cores (mma.sync m16n8k16, bf16 operands, f32 sums; each warp a 32 x 16
// output tile).
// bf16 mode: x is bf16; g and W are rounded to bf16 in dpart and dW; w,
// each product w*x and part are rounded as in the forward for dW (products
// of bf16 values are exact in f32, so the tensor cores round nowhere else);
// w stays f32 for dx; every sum is f32; dx and dW are f32.
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): 0.4-0.6 ms of
// device time at the three KPCNN layers it is timed at, 10-20x the bound;
// the edge kernel takes two thirds of it at level 0 (dependent loads: a
// slot's source row, then its row of x), the two products most of it at
// level 4 (PERF.md, section 6).
#include <algorithm>

#include "kpconv_common.cuh"

namespace dpcr {

constexpr int kRows = 64;        // query rows of a tile
constexpr int kGroupRows = 16;   // query rows of an edge-kernel block
constexpr int kEdgeC = 32;       // channels of an edge-kernel block

// channels of the edge kernel's shared dpart rows: C rounded up to whole
// 16-byte groups, at most kEdgeC
__host__ __device__ inline int edge_channels(int C) {
  return C < kEdgeC ? (C + 3) / 4 * 4 : kEdgeC;
}

// dynamic shared memory of the edge kernel
__host__ __device__ inline size_t edge_smem(int K, int C, int n_kp) {
  return ((size_t)kGroupRows * K * (kPC + 4) +
          (size_t)kGroupRows * kPC * edge_channels(C)) * 4 +
         (size_t)kGroupRows * K * 2 * 4 + (size_t)n_kp * 3 * 4;
}

using bf16 = __nv_bfloat16;

__global__ void __launch_bounds__(kThreads)
kpconv_bwd_flags_kernel(const int32_t* __restrict__ nbr,
                        int* __restrict__ flags, long long M, int K, int Ns) {
  const long long t = blockIdx.x;
  const long long end = min(M, (t + 1) * kRows) * K;
  int any = 0;
  for (long long i = t * kRows * K + threadIdx.x; i < end; i += kThreads)
    any |= (unsigned)nbr[i] < (unsigned)Ns;
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) flags[t] = any;
}

// A BM x BN output tile of a block of kThreads threads, summed over chunks
// of BK: C[m][n] += sum_k A[k][m] * B[k][n], both operands staged in
// shared memory by put_a / put_b, values already rounded to T.
template <typename T, int BM, int BN> struct BlockGemm;

// f32: shared tiles [k][m] and [k][n]; thread (ty, tx) owns a 4 x 4 tile
template <int BM, int BN> struct BlockGemm<float, BM, BN> {
  static constexpr int BK = 16, LA = BM + 4, LB = BN + 4, TX = BN / 4;
  static_assert((BM / 4) * TX == kThreads, "one 4 x 4 tile a thread");
  static constexpr int kSmem = BK * (LA + LB) * 4;
  float acc[4][4];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  __device__ static float* a_tile(unsigned char* s) {
    return reinterpret_cast<float*>(s);
  }
  __device__ static float* b_tile(unsigned char* s) {
    return reinterpret_cast<float*>(s) + BK * LA;
  }
  __device__ static void put_a(unsigned char* s, int k, int i, float v) {
    a_tile(s)[k * LA + i] = v;
  }
  __device__ static void put_b(unsigned char* s, int k, int i, float v) {
    b_tile(s)[k * LB + i] = v;
  }
  __device__ void step(unsigned char* s) {
    const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
    const float* sa = a_tile(s) + ty * 4;
    const float* sb = b_tile(s) + tx * 4;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(sa + k * LA);
      const float4 b = *reinterpret_cast<const float4*>(sb + k * LB);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
  }
  template <typename F> __device__ void store(F f) const {
    const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) f(ty * 4 + i, tx * 4 + j, acc[i][j]);
  }
};

// bf16: shared tiles [m][k] and [n][k] (k contiguous, rows padded to 40
// values = 20 words, so the fragment loads of a warp hit 32 banks); 8 warps
// as WM x WN, each a 32 x 16 tile of 2 x 2 m16n8k16 products
template <int BM, int BN> struct BlockGemm<bf16, BM, BN> {
  static constexpr int BK = 32, LD = BK + 8, WM = BM / 32, WN = 8 / WM;
  static_assert(WM * WN == 8 && WN * 16 == BN, "8 warps of 32 x 16");
  static constexpr int kSmem = (BM + BN) * LD * 2;
  float acc[2][2][4];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
  }
  __device__ static bf16* a_tile(unsigned char* s) {
    return reinterpret_cast<bf16*>(s);
  }
  __device__ static bf16* b_tile(unsigned char* s) {
    return reinterpret_cast<bf16*>(s) + BM * LD;
  }
  __device__ static void put_a(unsigned char* s, int k, int i, float v) {
    a_tile(s)[i * LD + k] = __float2bfloat16_rn(v);
  }
  __device__ static void put_b(unsigned char* s, int k, int i, float v) {
    b_tile(s)[i * LD + k] = __float2bfloat16_rn(v);
  }
  __device__ static uint32_t ld2(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  __device__ void step(unsigned char* s) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / WN, wn = warp % WN, gq = lane / 4, tq = lane % 4;
    const bf16* sa = a_tile(s) + (wm * 32 + gq) * LD + 2 * tq;
    const bf16* sb = b_tile(s) + (wn * 16 + gq) * LD + 2 * tq;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t a[2][4], b[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const bf16* p = sa + mt * 16 * LD + ks;
        a[mt][0] = ld2(p);
        a[mt][1] = ld2(p + 8 * LD);
        a[mt][2] = ld2(p + 8);
        a[mt][3] = ld2(p + 8 * LD + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const bf16* p = sb + nt * 8 * LD + ks;
        b[nt][0] = ld2(p);
        b[nt][1] = ld2(p + 8);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          float* c = acc[mt][nt];
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
              : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
              : "r"(a[mt][0]), "r"(a[mt][1]), "r"(a[mt][2]), "r"(a[mt][3]),
                "r"(b[nt][0]), "r"(b[nt][1]));
        }
    }
  }
  template <typename F> __device__ void store(F f) const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / WN, wn = warp % WN, gq = lane / 4, tq = lane % 4;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int m = wm * 32 + mt * 16 + gq, n = wn * 16 + nt * 8 + 2 * tq;
        f(m, n, acc[mt][nt][0]);
        f(m, n + 1, acc[mt][nt][1]);
        f(m + 8, n, acc[mt][nt][2]);
        f(m + 8, n + 1, acc[mt][nt][3]);
      }
  }
};

// Stages a BK x W tile of an operand: element (k, i) read at
// src[k * ldk + i * ldi] where k < nk and i < ni (0 elsewhere), rounded to
// T, handed to put(k, i, v). K_FAST: the source is contiguous along k, so
// neighbouring threads take neighbouring k (else neighbouring i).
template <typename T, int BK, int W, bool K_FAST, typename G, typename Put>
__device__ __forceinline__ void stage(const G* __restrict__ src, long long ldk,
                                      long long ldi, int nk, int ni, Put put) {
  for (int e = threadIdx.x; e < BK * W; e += kThreads) {
    const int k = K_FAST ? e % BK : e / W;
    const int i = K_FAST ? e / BK : e % W;
    const float v = k < nk && i < ni
                        ? round_to<T>(to_float(src[k * ldk + i * ldi])) : 0.f;
    put(k, i, v);
  }
}

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

__device__ __forceinline__ void red_add4(float* d, const float v[4]) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(d),
               "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
               : "memory");
}

// shared floats of one slot's weights (kPC, padded: 16-byte aligned, and
// the slots of one warp's edges spread over the banks)
constexpr int kWS = kPC + 4;

// Block (group of kGroupRows rows, chunk of kEdgeC channels); per chunk of
// kPC kernel points:
//   slots: one thread per (row, k) finds the source row and computes the
//     edge's weights once into shared memory, and lists the real edges;
//   dpart of the rows, the kernel points and the channels into shared
//     memory (coalesced);
//   dx: one thread per (real edge, 4 channels) adds sum_p w * dpart to dx
//     (a 16-byte vector atomic where C is a multiple of 4);
//   part: one thread per (row, 4 channels, 1 to 4 kernel points: 256
//     threads or more) walks the row's slots in order, 8 at a time with
//     the neighbours' channels of x loaded first, and writes part (zeros
//     for rows past M).
template <typename T>
__global__ void __launch_bounds__(kThreads)
kpconv_bwd_edge_kernel(const T* __restrict__ x, const int32_t* __restrict__ nbr,
                       const float* __restrict__ rel,
                       const float* __restrict__ kpts,
                       const float* __restrict__ dpart,
                       const int* __restrict__ flags, T* __restrict__ part,
                       float* __restrict__ dx, long long M, int Nq, int Ns,
                       int K, int C, int n_kp, float extent, int influence,
                       int closest) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_n;
  const long long row0 = (long long)blockIdx.x * kGroupRows;
  if (!flags[row0 / kRows]) return;
  const int slots = kGroupRows * K;
  const int cs = edge_channels(C);          // channels of s_dp's rows
  float* s_w = smem;                                        // [slots][kWS]
  float* s_dp = s_w + slots * kWS;                          // [16][kPC][cs]
  int* s_src = reinterpret_cast<int*>(s_dp + kGroupRows * kPC * cs);
  int* s_list = s_src + slots;                              // [slots]
  float* s_kp = reinterpret_cast<float*>(s_list + slots);   // [n_kp][3]
  const int tid = threadIdx.x;
  const int cb = blockIdx.y * kEdgeC;                       // first channel
  const int cw = min(kEdgeC, C - cb);
  const int ng = (cw + 3) / 4;
  const long long KC = (long long)n_kp * C;
  const int nrows = (int)max(0LL, min((long long)kGroupRows, M - row0));
  const bool vec = C % 4 == 0;
  for (int i = tid; i < n_kp * 3; i += kThreads) s_kp[i] = kpts[i];

  for (int p0 = 0; p0 < n_kp; p0 += kPC) {
    if (tid == 0) s_n = 0;
    __syncthreads();
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
      s_list[atomicAdd(&s_n, 1)] = i;
    }
#pragma unroll 8
    for (int e = tid; e < kGroupRows * kPC * cw; e += kThreads) {
      const int qj = e / cw, c = e - qj * cw;
      const int q = qj / kPC, j = qj - q * kPC;
      s_dp[qj * cs + c] =
          q < nrows && p0 + j < n_kp
              ? dpart[(row0 + q) * KC + (long long)(p0 + j) * C + cb + c]
              : 0.f;
    }
    __syncthreads();

    // dx[src][c] += sum_p w[p] * dpart[row][p][c]
    const int n_edges = s_n;
    for (int it = tid; it < n_edges * ng; it += kThreads) {
      const int i = s_list[it / ng];
      const int c0 = (it % ng) * 4;
      const float* w = s_w + i * kWS;
      const float* dp = s_dp + (i / K) * kPC * cs + c0;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kPC; ++j) {
        const float wj = w[j];
        if (vec) {
          const float4 d = *reinterpret_cast<const float4*>(dp + j * cs);
          v[0] += wj * d.x;
          v[1] += wj * d.y;
          v[2] += wj * d.z;
          v[3] += wj * d.w;
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (c0 + c < cw) v[c] += wj * dp[j * cs + c];
        }
      }
      float* d = dx + (long long)s_src[i] * C + cb + c0;
      if (vec) {
        red_add4(d, v);
      } else {
        for (int c = 0; c < min(4, cw - c0); ++c) atomicAdd(d + c, v[c]);
      }
    }

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
    __syncthreads();  // the slots and s_dp are refilled for the next chunk
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

// dw[i] = sum over s of partial[s][i], s in order: thread (j, h) of a block
// sums the splits h, h + 8, ... of output j, then h = 0 adds the 8 sums
__global__ void __launch_bounds__(kThreads)
kpconv_bwd_reduce_kernel(const float* __restrict__ partial,
                         float* __restrict__ dw, long long n, int splits) {
  __shared__ float s_sum[8][32];
  const int j = threadIdx.x % 32, h = threadIdx.x / 32;
  const long long i = (long long)blockIdx.x * 32 + j;
  float a = 0.f;
  if (i < n)
    for (int s = h; s < splits; s += 8) a += partial[(long long)s * n + i];
  s_sum[h][j] = a;
  __syncthreads();
  if (h == 0 && i < n) {
    float total = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) total += s_sum[r][j];
    dw[i] = total;
  }
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

template <typename T>
static int launch(const void* x, const void* nbr, const void* rel,
                  const void* weights, const void* kpts, const void* g,
                  void* flags, void* part, void* dpart, void* partial,
                  void* dx, void* dw, long long M, int Nq, int Ns, int K,
                  int C, int Cout, int n_kp, float extent, int influence,
                  int closest, int dw_cfg, int splits,
                  cudaStream_t stream) {
  const int32_t* nbr_ = static_cast<const int32_t*>(nbr);
  const float* g_ = static_cast<const float*>(g);
  int* flags_ = static_cast<int*>(flags);
  float* dpart_ = static_cast<float*>(dpart);
  float* partial_ = static_cast<float*>(partial);
  const long long n_tiles = (M + kRows - 1) / kRows;
  const int KC = n_kp * C;
  kpconv_bwd_flags_kernel<<<(unsigned)n_tiles, kThreads, 0, stream>>>(
      nbr_, flags_, M, K, Ns);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kpconv_bwd_dpart_kernel<T><<<dim3((unsigned)n_tiles, (KC + 63) / 64),
                               kThreads, 0, stream>>>(
      g_, static_cast<const float*>(weights), flags_, dpart_, M, KC, Cout);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem_edge = edge_smem(K, C, n_kp);
  e = cudaFuncSetAttribute(kpconv_bwd_edge_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_edge);
  if (e != cudaSuccess) return (int)e;
  kpconv_bwd_edge_kernel<T><<<dim3((unsigned)(n_tiles * (kRows / kGroupRows)),
                                   (unsigned)((C + kEdgeC - 1) / kEdgeC)),
                              kThreads, smem_edge, stream>>>(
      static_cast<const T*>(x), nbr_, static_cast<const float*>(rel),
      static_cast<const float*>(kpts), dpart_, flags_, static_cast<T*>(part),
      static_cast<float*>(dx), M, Nq, Ns, K, C, n_kp, extent, influence,
      closest);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int rc;
  switch (dw_cfg) {
    case 0: rc = launch_dw<T, 256, 16>(part, g_, flags_, partial_, M, n_tiles,
                                       KC, Cout, splits, stream); break;
    case 1: rc = launch_dw<T, 128, 32>(part, g_, flags_, partial_, M, n_tiles,
                                       KC, Cout, splits, stream); break;
    default: rc = launch_dw<T, 64, 64>(part, g_, flags_, partial_, M, n_tiles,
                                       KC, Cout, splits, stream); break;
  }
  if (rc != 0) return rc;
  const long long n = (long long)KC * Cout;
  kpconv_bwd_reduce_kernel<<<(unsigned)((n + 31) / 32), kThreads, 0, stream>>>(
      partial_, static_cast<float*>(dw), n, splits);
  return (int)cudaGetLastError();
}

}  // namespace dpcr

// x [B,Ns,C] (float32 or bfloat16 by `dtype`), nbr [B,Nq,K] int32, rel
// [B,Nq,K,3], weights [Kp,C,Cout], kpts [Kp,3] and g [B,Nq,Cout] float32;
// dx [B,Ns,C] float32, zeroed by the caller (the kernels add into it); dw
// [Kp,C,Cout] float32 (written); all contiguous. Scratch, as
// `kernels.kpconv_bwd_plan` sizes it, with tiles = ceil(B*Nq / 64):
// flags int32 [tiles]; part [tiles*64, Kp*C] of x's dtype; dpart float32
// [tiles*64, Kp*C]; partial float32 [splits, Kp*C, Cout]. dw_cfg picks the
// dW product's output tile (0: 256 x 16, 1: 128 x 32, 2: 64 x 64), splits
// its row splits (1 to 65535). Limits and codes as for kpconv_fused_launch,
// and Kp <= 4096, the edge kernel's shared memory within a block's.
// Returns 0 on success, a CUDA error code, or a negative dpcr::ArgError.
extern "C" int kpconv_fused_bwd_launch(
    int dtype, const void* x, const void* nbr, const void* rel,
    const void* weights, const void* kpts, const void* g, void* flags,
    void* part, void* dpart, void* partial, void* dx, void* dw, int B, int Nq,
    int Ns, int K, int C, int Cout, int n_kp, float extent, int influence,
    int closest, int dw_cfg, int splits, void* stream) {
  if (B < 0 || Nq < 0 || Ns < 1 || K < 1 || C < 1 || Cout < 1 || Cout > 256 ||
      n_kp < 1 || n_kp > 4096 || influence < 0 || influence > 2 ||
      (long long)B * Ns > 0x7fffffffLL ||
      (long long)B * Nq * K * 3 > 0x7fffffffLL ||
      (long long)n_kp * C > 64LL * 65535 || C > 32 * 65535 || dw_cfg < 0 ||
      dw_cfg > 2 ||
      splits < 1 || splits > 65535 ||
      dpcr::edge_smem(K, C, n_kp) > 232448)
    return dpcr::kBadShape;
  const long long M = (long long)B * Nq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0)   // no row: dW is zero
    return (int)cudaMemsetAsync(dw, 0,
                                (size_t)n_kp * C * Cout * sizeof(float), s);
  if (dtype == dpcr::kFloat32)
    return dpcr::launch<float>(x, nbr, rel, weights, kpts, g, flags, part,
                               dpart, partial, dx, dw, M, Nq, Ns, K, C, Cout,
                               n_kp, extent, influence, closest, dw_cfg,
                               splits, s);
  if (dtype == dpcr::kBFloat16)
    return dpcr::launch<__nv_bfloat16>(
        x, nbr, rel, weights, kpts, g, flags, part, dpart, partial, dx, dw, M,
        Nq, Ns, K, C, Cout, n_kp, extent, influence, closest, dw_cfg, splits,
        s);
  return dpcr::kBadDType;
}
