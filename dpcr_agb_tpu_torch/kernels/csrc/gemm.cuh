// Shared by the kernels that run a block-tiled product (kpconv_fwd.cu,
// kpconv_bwd.cu, stem_dw.cu): a BM x BN output tile of one block of 256
// threads summed over chunks of BK staged in shared memory, on the f32
// cores in f32 and on the tensor cores in bf16, and the fixed-order sum of
// a split reduction's partials.
#pragma once

#include "common.cuh"

namespace dpcr {

constexpr int kGemmThreads = 256;  // threads of a block that runs BlockGemm

using bf16 = __nv_bfloat16;

// A BM x BN output tile of a block of kGemmThreads threads, summed over
// chunks of BK: C[m][n] += sum_k A[k][m] * B[k][n], both operands staged in
// shared memory by put_a / put_b, values already rounded to T.
template <typename T, int BM, int BN> struct BlockGemm;

// f32: shared tiles [k][m] and [k][n]; thread (ty, tx) owns a 4 x 4 tile;
// no TF32
template <int BM, int BN> struct BlockGemm<float, BM, BN> {
  static constexpr int BK = 16, LA = BM + 4, LB = BN + 4, TX = BN / 4;
  static_assert((BM / 4) * TX == kGemmThreads, "one 4 x 4 tile a thread");
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
// as WM x WN, each a 32 x 16 tile of 2 x 2 mma.sync m16n8k16 products (bf16
// operands, f32 sums)
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

struct AllLive {
  __device__ bool operator()(int) const { return true; }
};

// Stages a BK x W tile of an operand: element (k, i) read at
// src[k * ldk + i * ldi] where k < nk, i < ni and live(i) (0 elsewhere,
// without a read), rounded to T, handed to put(k, i, v). K_FAST: the
// source is contiguous along k, so neighbouring threads take neighbouring
// k (else neighbouring i).
template <typename T, int BK, int W, bool K_FAST, typename G, typename Put,
          typename Live = AllLive>
__device__ __forceinline__ void stage(const G* __restrict__ src, long long ldk,
                                      long long ldi, int nk, int ni, Put put,
                                      Live live = Live()) {
  for (int e = threadIdx.x; e < BK * W; e += kGemmThreads) {
    const int k = K_FAST ? e % BK : e / W;
    const int i = K_FAST ? e / BK : e % W;
    const float v = k < nk && i < ni && live(i)
                        ? to_float(from_float<T>(to_float(src[k * ldk + i * ldi])))
                        : 0.f;
    put(k, i, v);
  }
}

// out[i] = sum over s of partial[s][i], s in order: thread (j, h) of a block
// of 256 sums the splits h, h + 8, ... of output j, then h = 0 adds the 8
// sums in order. The same bits from run to run.
__global__ void __launch_bounds__(kGemmThreads)
split_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                    long long n, int splits) {
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
    out[i] = total;
  }
}

inline int launch_split_reduce(const float* partial, float* out, long long n,
                               int splits, cudaStream_t stream) {
  if (n == 0) return 0;
  split_reduce_kernel<<<(unsigned)((n + 31) / 32), kGemmThreads, 0, stream>>>(
      partial, out, n, splits);
  return (int)cudaGetLastError();
}

}  // namespace dpcr
