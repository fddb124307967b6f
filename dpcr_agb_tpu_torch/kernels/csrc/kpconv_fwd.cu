// kpconv_fused: the fused rigid kernel-point convolution, forward.
//
// Replaces: dpcr_agb_tpu/ops/pallas_kpconv.py _fwd_kernel (:101, called at
// :222) and the XLA row gather in front of it (models/kpconv.py :315-324).
// Per query row q with neighbours nbr[q, 0..K):
//   w[k, p]  = influence(|rel[q, k] - kp[p]|^2)       (closest: first argmin)
//   part[p]  = sum_k w[k, p] * x[nbr[q, k]]           [Kp, C]
//   out[q]   = sum_p part[p] @ W[p]                   [Cout], f32
// The TPU kernel is handed the gathered features nx [M, K, C] because
// Mosaic cannot gather rows; here the rows of x are gathered on the card
// from nbr, and neither nx nor the influences reach device memory. A
// shadow neighbour (index Ns) is skipped, which is what its zero feature
// row would contribute, so the table needs no padding row.
//
// What bounds it on an H100: bytes at the narrow levels (x's rows, nbr,
// rel and the output; 0.03 ms at level 0 of a bs16 batch), the products
// with W at the wide ones (2 * Kp * C * Cout per row with a neighbour: 2
// GFLOP at level 4, 0.03 ms on the f32 cores). part, the [rows, Kp*C]
// intermediate, costs 2 * 126 MB at level 0 in f32 when it goes through
// device memory, ~0.08 ms.
//
// What held the first version back (0.74 ms at level 0, 1.53 ms at level 4,
// 25-50x its bound): every block of 16 rows did all the work of every row,
// though 92% of level 4's rows and a quarter of level 0's have no
// neighbour; the product re-read W from L2 for every 16 rows (3.2 GB at
// level 4) on the f32 cores in both modes. A one-kernel redesign that kept
// part in shared memory (a 64- or 128-row tile, part formed for a product
// depth of 16 or 32 at a time) was 1.5x slower at level 0 and 7x slower at
// level 4 (10.9 ms f32): to fill so shallow a depth it read each
// neighbour's channels once per block of 4 kernel points and once per
// output tile of 64 channels, a chain of dependent loads 16x longer than
// the first version's (chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W;
// PERF.md section 6).
//
// Design: part goes through scratch, formed once and read once, so that the
// gather and the product each get the shape they need; three kernels, one
// after another, rows in tiles of kRows = 64 (kpconv_part.cuh):
//   flags: one read of a tile's nbr says whether any row of it has a real
//     neighbour (no host sync: the tile count never leaves the card);
//   part: a block per 16 rows of an active tile and 32 channels computes
//     each real edge's influences once into shared memory and walks each
//     row's slots in order, gathering the real neighbours' channels of x
//     once for all kernel points (a shadow slot costs one shared-memory
//     read: compacting each row's real slots into a list first made the
//     kernel 1.6x slower, chip_smoke.py on an NVIDIA H100 80GB HBM3 at
//     700 W); the backward's part kernel, the same code;
//   product: out = part @ W, a BlockGemm tile (gemm.cuh) of 256 x 16, 128 x
//     32 or 64 x 64 rows x output channels by Cout, W staged in shared
//     memory and reused over the tile's rows, 4 x 4 outputs a thread on the
//     f32 cores in f32 (no TF32), mma.sync m16n8k16 on the tensor cores in
//     bf16; a tile of inactive rows writes zeros without reading part. At
//     the wide levels, where few tiles are active (92% of level 4's rows
//     have no neighbour) and the depth Kp*C is 1,920-3,840, the depth is
//     cut into splits (a block each), added in order by split_reduce_kernel
//     (gemm.cuh).
// `kernels.kpconv_fwd_plan` sizes the grids, shared memory and scratch.
// bf16 mode (T = __nv_bfloat16): x is bf16; w, each product w*x, part and W
// are rounded to bf16; every sum is f32; the output is f32.
#include "gemm.cuh"
#include "kpconv_part.cuh"

namespace dpcr {

// The product's depth range [kbeg, kend) into gm: part rows staged where
// live(row) (zeros elsewhere, without a read), W's rows for the block's
// output columns.
template <typename T, int BM, int BN, typename Live>
__device__ __forceinline__ void product_range(
    BlockGemm<T, BM, BN>& gm, unsigned char* smem, const T* __restrict__ part,
    const float* __restrict__ weights, long long row0, int n0, int kbeg,
    int kend, int KC, int Cout, int nrows, int ncols, Live live) {
  using Gm = BlockGemm<T, BM, BN>;
  for (int k0 = kbeg; k0 < kend; k0 += Gm::BK) {
    const int nk = min(Gm::BK, kend - k0);
    stage<T, Gm::BK, BM, true>(
        part + row0 * KC + k0, 1, KC, nk, nrows,
        [&](int k, int i, float v) { Gm::put_a(smem, k, i, v); }, live);
    stage<T, Gm::BK, BN, false>(
        weights + (long long)k0 * Cout + n0, Cout, 1, nk, ncols,
        [&](int k, int i, float v) { Gm::put_b(smem, k, i, v); });
    __syncthreads();
    gm.step(smem);
    __syncthreads();
  }
}

// out [M, Cout] = part [M, KC] @ W [KC, Cout]; block (BM rows, BN columns,
// split z of the depth KC, in gridDim.z equal ranges). With one split the
// block writes out; with more, its slice of partial [splits, M, Cout],
// which split_reduce_kernel adds in order. Rows of a 64-row tile without a
// real neighbour are 0: the part kernel never wrote their part rows. A
// block with no active tile skips the product; one with active and
// inactive tiles stages the inactive rows as zeros without reading them;
// one whose tiles are all active (nearly every block that runs the
// product: BM 64 holds one tile, and with BM 128 or 256 only the blocks
// where a sample's points end mix the two) stages part with no test per
// row, which in the same code costs the product kernel up to 2x
// (chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md section 6).
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kGemmThreads)
kpconv_fwd_product_kernel(const T* __restrict__ part,
                          const float* __restrict__ weights,
                          const int* __restrict__ flags,
                          float* __restrict__ out, long long M, int KC,
                          int Cout) {
  using Gm = BlockGemm<T, BM, BN>;
  __shared__ __align__(16) unsigned char smem[Gm::kSmem];
  const long long row0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int ks = (KC + gridDim.z - 1) / gridDim.z;
  const int kbeg = blockIdx.z * ks, kend = min(KC, kbeg + ks);
  out += (long long)blockIdx.z * M * Cout;
  const int nrows = (int)min((long long)BM, M - row0);
  const int ncols = min(BN, Cout - n0);
  const int n_tiles = (nrows + kRows - 1) / kRows;
  int live = 0;  // bit t: the block's 64-row tile t has a real neighbour
  for (int t = 0; t < n_tiles; ++t)
    live |= (flags[row0 / kRows + t] != 0) << t;
  const auto row_live = [live](int m) { return (live >> (m / kRows)) & 1; };
  if (!live) {
    for (int e = threadIdx.x; e < BM * BN; e += kGemmThreads) {
      const int m = e / BN, n = e % BN;
      if (m < nrows && n < ncols) out[(row0 + m) * Cout + n0 + n] = 0.f;
    }
    return;
  }
  Gm gm;
  gm.zero();
  if (live == (1 << n_tiles) - 1)
    product_range(gm, smem, part, weights, row0, n0, kbeg, kend, KC, Cout,
                  nrows, ncols, AllLive());
  else
    product_range(gm, smem, part, weights, row0, n0, kbeg, kend, KC, Cout,
                  nrows, ncols, row_live);
  gm.store([&, row_live](int m, int n, float v) {
    if (m < nrows && n < ncols)
      out[(row0 + m) * Cout + n0 + n] = row_live(m) ? v : 0.f;
  });
}

template <typename T, int BM, int BN>
static int launch_product(const void* part, const float* weights,
                          const int* flags, float* out, float* partial,
                          long long M, int KC, int Cout, int splits,
                          cudaStream_t stream) {
  kpconv_fwd_product_kernel<T, BM, BN>
      <<<dim3((unsigned)((M + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN),
              (unsigned)splits),
         kGemmThreads, 0, stream>>>(static_cast<const T*>(part), weights,
                                    flags, splits > 1 ? partial : out, M, KC,
                                    Cout);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  return launch_split_reduce(partial, out, M * Cout, splits, stream);
}

template <typename T>
static int launch(const void* x, const void* nbr, const void* rel,
                  const void* weights, const void* kpts, void* flags,
                  void* part, void* partial, void* out, long long M, int Nq,
                  int Ns, int K, int C, int Cout, int n_kp, float extent,
                  int influence, int closest, int tile, int splits,
                  cudaStream_t stream) {
  const int32_t* nbr_ = static_cast<const int32_t*>(nbr);
  int* flags_ = static_cast<int*>(flags);
  const long long n_tiles = (M + kRows - 1) / kRows;
  kpconv_flags_kernel<<<(unsigned)n_tiles, kThreads, 0, stream>>>(
      nbr_, flags_, M, K, Ns);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = edge_smem(K, n_kp);
  e = cudaFuncSetAttribute(kpconv_part_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  kpconv_part_kernel<T><<<dim3((unsigned)(n_tiles * (kRows / kGroupRows)),
                               (unsigned)((C + kEdgeC - 1) / kEdgeC)),
                          kThreads, smem, stream>>>(
      static_cast<const T*>(x), nbr_, static_cast<const float*>(rel),
      static_cast<const float*>(kpts), flags_, static_cast<T*>(part), M, Nq,
      Ns, K, C, n_kp, extent, influence, closest);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const float* w = static_cast<const float*>(weights);
  float* out_ = static_cast<float*>(out);
  float* partial_ = static_cast<float*>(partial);
  const int KC = n_kp * C;
  switch (tile) {
    case 0: return launch_product<T, 256, 16>(part, w, flags_, out_,
                                              partial_, M, KC, Cout, splits,
                                              stream);
    case 1: return launch_product<T, 128, 32>(part, w, flags_, out_,
                                              partial_, M, KC, Cout, splits,
                                              stream);
    default: return launch_product<T, 64, 64>(part, w, flags_, out_,
                                              partial_, M, KC, Cout, splits,
                                              stream);
  }
}

}  // namespace dpcr

// x [B,Ns,C] (float32 or bfloat16 by `dtype`), nbr [B,Nq,K] int32, rel
// [B,Nq,K,3] float32, weights [Kp,C,Cout] float32, kpts [Kp,3] float32,
// out [B,Nq,Cout] float32 (written); all contiguous. Scratch, as
// `kernels.kpconv_fwd_plan` sizes it, with tiles = ceil(B*Nq / 64): flags
// int32 [tiles]; part [tiles*64, Kp*C] of x's dtype; partial float32
// [splits, B*Nq, Cout] where splits > 1 (else unused, may be null). tile
// picks the product's output tile (0: 256 x 16, 1: 128 x 32, 2: 64 x 64),
// splits the ranges its depth Kp*C is cut into (1 to 64). 1 <= Cout
// <= 256, Kp <= 4096, Kp*C below 2^31; B*Ns and B*Nq*K*3 below 2^31; the
// part kernel's shared memory within a block's. influence: 0 linear, 1
// gaussian, 2 constant; closest: 1 for aggregation 'closest'.
// Returns 0 on success, a CUDA error code, or a negative dpcr::ArgError.
extern "C" int kpconv_fused_launch(int dtype, const void* x, const void* nbr,
                                   const void* rel, const void* weights,
                                   const void* kpts, void* flags, void* part,
                                   void* partial, void* out, int B, int Nq,
                                   int Ns, int K, int C, int Cout, int n_kp,
                                   float extent, int influence, int closest,
                                   int tile, int splits, void* stream) {
  if (B < 0 || Nq < 0 || Ns < 1 || K < 1 || C < 1 || Cout < 1 || Cout > 256 ||
      n_kp < 1 || n_kp > 4096 || influence < 0 || influence > 2 ||
      tile < 0 || tile > 2 || splits < 1 || splits > 64 ||
      (long long)B * Ns > 0x7fffffffLL ||
      (long long)B * Nq * K * 3 > 0x7fffffffLL || C > 32 * 65535 ||
      (long long)n_kp * C > 0x7fffffffLL ||
      dpcr::edge_smem(K, n_kp) > 232448)
    return dpcr::kBadShape;
  const long long M = (long long)B * Nq;
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dpcr::kFloat32)
    return dpcr::launch<float>(x, nbr, rel, weights, kpts, flags, part,
                               partial, out, M, Nq, Ns, K, C, Cout, n_kp,
                               extent, influence, closest, tile, splits, s);
  if (dtype == dpcr::kBFloat16)
    return dpcr::launch<__nv_bfloat16>(x, nbr, rel, weights, kpts, flags,
                                       part, partial, out, M, Nq, Ns, K, C,
                                       Cout, n_kp, extent, influence, closest,
                                       tile, splits, s);
  return dpcr::kBadDType;
}
