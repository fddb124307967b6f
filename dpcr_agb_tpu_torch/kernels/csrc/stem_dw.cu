// stem_sites_dw: the weight gradient of the k=7 stem convolution evaluated
// at occupied voxel sites (the backward of stem_sites.cu).
//
// Replaces: no Pallas kernel (the Pallas stem is forward-only). The JAX
// package gets this gradient from XLA autodiff of the row stem's patch
// matmul, dpcr_agb_tpu/ops/sparse_stem.py _stem_conv_core (:413-433):
//   dW[o, ci, co] = sum over sites v with mask[v] of
//                   vol[b, c_v + o - 3, ci] * ct[b, v, co]
// with out-of-volume neighbours reading 0 and the site clipped into the
// volume as in the forward. A plain gather-and-matmul would build the
// [B*V, 343*Cin] patch matrix (1.08 GB f32 at bs16).
//
// What bounds it on an H100: operations. The product patch^T [343*Cin x
// sites] @ ct [sites x 64] needs 2*343*Cin*64 flops a masked site (15
// GFLOP at bs16, Cin 3: 0.23 ms on the f32 cores, 0.015 ms on the bf16
// tensor cores); the bytes (each volume cell in reach of a site once, ct
// and dW) take under 0.01 ms. Only ~16% of a site's neighbour values are
// non-zero, which the bound of chip_smoke.py counts, but a tiled product
// cannot skip them.
//
// What held the first version back (1.75 ms): one warp per site added
// value * ct into a shared dW plane with shared f32 atomics, and every
// block added its plane into the global dW with one f32 atomic per value
// (~15 M atomics on 65,856 values at bs16), so dW came out in another
// order, and with other bits, from run to run.
//
// Design: a split reduction in a fixed order, no atomics. Block (m, s) owns
// the 64 rows m*64 .. m*64+63 of dW viewed as [343*Cin, 64] and the sites
// of split s (a fixed range in row order; `kernels.stem_dw_plan` sets the
// number of splits from the card, ~4 blocks an SM, not from the batch). It
// compacts the masked sites of each window of 256 in order (ballots), then
// for each chunk of BK of them stages the patch tile (the tile's 64 rows of
// each site's neighbourhood, gathered from the volume, zero outside) and
// the sites' ct rows in shared memory, the next chunk's loads issued
// before this chunk's product runs, and runs BlockGemm (gemm.cuh): 4 x 4
// outputs a thread on the f32 cores in f32 (no TF32), mma.sync m16n8k16
// bf16 -> f32 on the tensor cores in bf16 (products of bf16 values are
// exact, so both modes round only in the f32 sums). Each block writes its
// partial tile to scratch; split_reduce_kernel adds the splits in order.
// dW is the same bit for bit from run to run.
#include "gemm.cuh"

namespace dpcr {

constexpr int kK = 7;              // kernel size
constexpr int kR = kK / 2;         // radius
constexpr int kTaps = kK * kK * kK;
constexpr int kCout = 64;          // output channels
constexpr int kTileRows = 64;      // rows of dW [343*cin, 64] of a block
constexpr int kWindow = kGemmThreads;  // sites compacted at a time

template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
stem_sites_dw_kernel(const T* __restrict__ vol,
                     const int32_t* __restrict__ coords,
                     const uint8_t* __restrict__ mask,
                     const T* __restrict__ ct, float* __restrict__ partial,
                     int B, int D, int H, int W, int V, int cin,
                     long long chunk) {
  using Gm = BlockGemm<T, kTileRows, kCout>;
  constexpr int BK = Gm::BK;
  __shared__ __align__(16) unsigned char smem[Gm::kSmem];
  __shared__ int s_site[kWindow];        // the window's masked sites, in order
  __shared__ int s_at[kWindow][4];       // their b and clipped x, y, z
  __shared__ int s_warp[kGemmThreads / 32];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_rows = kTaps * cin;
  const int m0 = blockIdx.x * kTileRows;
  const long long first = (long long)blockIdx.y * chunk;
  const long long end = min(first + chunk, (long long)B * V);

  // this thread's row of the tile for the patch staging (the same for every
  // element it stages: 256 is a multiple of the tile's 64 rows)
  const int my_i = tid % kTileRows;
  const int my_r = m0 + my_i;
  const int my_o = my_r / cin, my_ci = my_r - (my_r / cin) * cin;
  const int ox = my_o / (kK * kK) - kR, oy = my_o / kK % kK - kR,
            oz = my_o % kK - kR;
  const bool my_valid = my_r < n_rows;

  constexpr int kA = BK * kTileRows / kGemmThreads;  // patch values a thread
  constexpr int kB = BK * kCout / kGemmThreads;      // ct values a thread
  Gm gm;
  gm.zero();
  for (long long w0 = first; w0 < end; w0 += kWindow) {
    const long long site = w0 + tid;
    const bool on = site < end && mask[site];
    const unsigned ball = __ballot_sync(0xffffffffu, on);
    if (lane == 0) s_warp[warp] = __popc(ball);
    __syncthreads();
    int base = 0, n = 0;
    for (int w = 0; w < kGemmThreads / 32; ++w) {
      base += w < warp ? s_warp[w] : 0;
      n += s_warp[w];
    }
    if (on) {
      const int at = base + __popc(ball & ((1u << lane) - 1u));
      s_site[at] = (int)site;
      s_at[at][0] = (int)(site / V);
      s_at[at][1] = min(max(coords[site * 3 + 0], 0), D - 1);
      s_at[at][2] = min(max(coords[site * 3 + 1], 0), H - 1);
      s_at[at][3] = min(max(coords[site * 3 + 2], 0), W - 1);
    }
    __syncthreads();
    // chunk k0's patch tile, element (k, i) = vol at site k0 + k, row m0 +
    // i, and ct tile, element (k, c) = ct[site k0 + k][c], into registers:
    // the next chunk's loads are in flight while the product of this one
    // runs
    float va[kA], vb[kB];
    auto fetch = [&](int k0) {
#pragma unroll
      for (int j = 0; j < kA; ++j) {
        const int k = tid / kTileRows + j * (kGemmThreads / kTileRows);
        va[j] = 0.f;
        if (my_valid && k0 + k < n) {
          const int* a = s_at[k0 + k];
          const int x = a[1] + ox, y = a[2] + oy, z = a[3] + oz;
          if (x >= 0 && x < D && y >= 0 && y < H && z >= 0 && z < W)
            va[j] = to_float(vol[((((size_t)a[0] * D + x) * H + y) * W + z) *
                                     cin + my_ci]);
        }
      }
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        const int e = tid + j * kGemmThreads;
        const int k = e / kCout;
        vb[j] = k0 + k < n
                    ? to_float(ct[(size_t)s_site[k0 + k] * kCout + e % kCout])
                    : 0.f;
      }
    };
    if (n > 0) fetch(0);
    for (int k0 = 0; k0 < n; k0 += BK) {
#pragma unroll
      for (int j = 0; j < kA; ++j)
        Gm::put_a(smem, tid / kTileRows + j * (kGemmThreads / kTileRows),
                  my_i, va[j]);
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        const int e = tid + j * kGemmThreads;
        Gm::put_b(smem, e / kCout, e % kCout, vb[j]);
      }
      __syncthreads();
      if (k0 + BK < n) fetch(k0 + BK);
      gm.step(smem);
      __syncthreads();
    }
  }
  float* out = partial + ((size_t)blockIdx.y * n_rows + m0) * kCout;
  gm.store([&](int m, int c, float v) {
    if (m0 + m < n_rows) out[(size_t)m * kCout + c] = v;
  });
}

template <typename T>
static int launch(const void* vol, const void* coords, const void* mask,
                  const void* ct, void* partial, void* dw, int B, int D, int H,
                  int W, int V, int cin, int splits, cudaStream_t stream) {
  const long long sites = (long long)B * V;
  const long long n = (long long)kTaps * cin * kCout;
  if (sites == 0)
    return (int)cudaMemsetAsync(dw, 0, (size_t)n * sizeof(float), stream);
  const long long chunk = (sites + splits - 1) / splits;
  const unsigned m_tiles = (unsigned)((kTaps * cin + kTileRows - 1) /
                                      kTileRows);
  stem_sites_dw_kernel<T><<<dim3(m_tiles, (unsigned)splits), kGemmThreads, 0,
                            stream>>>(
      static_cast<const T*>(vol), static_cast<const int32_t*>(coords),
      static_cast<const uint8_t*>(mask), static_cast<const T*>(ct),
      static_cast<float*>(partial), B, D, H, W, V, cin, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_split_reduce(static_cast<const float*>(partial),
                             static_cast<float*>(dw), n, splits, stream);
}

}  // namespace dpcr

// vol [B,D,H,W,cin] and ct [B,V,64] of one dtype, coords [B,V,3] int32,
// mask [B,V] uint8, partial float32 [splits, 343*cin, 64] (scratch), dw
// [343,cin,64] float32 (written); all contiguous; 1 <= cin <= 18; splits
// as `kernels.stem_dw_plan` picks them (1 to 65535), B*V below 2^31.
// Returns 0 on success, a CUDA error code, or a negative dpcr::ArgError.
extern "C" int stem_sites_dw_launch(int dtype, const void* vol,
                                    const void* coords, const void* mask,
                                    const void* ct, void* partial, void* dw,
                                    int B, int D, int H, int W, int V, int cin,
                                    int splits, void* stream) {
  if (cin < 1 || cin > 18 || D < 1 || H < 1 || W < 1 || V < 0 || B < 0 ||
      splits < 1 || splits > 65535 || (long long)B * V > 0x7fffffffLL)
    return dpcr::kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dpcr::kFloat32)
    return dpcr::launch<float>(vol, coords, mask, ct, partial, dw, B, D, H, W,
                               V, cin, splits, s);
  if (dtype == dpcr::kBFloat16)
    return dpcr::launch<__nv_bfloat16>(vol, coords, mask, ct, partial, dw, B,
                                       D, H, W, V, cin, splits, s);
  return dpcr::kBadDType;
}
