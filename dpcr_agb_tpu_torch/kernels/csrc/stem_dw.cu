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
// What bounds it on an H100: as for the forward, neither rate. The level-0
// volume is ~2% occupied, so only ~16% of a site's 343*Cin neighbour values
// are non-zero, and the products the data needs (2*169*64 flops a site)
// take well under 0.1 ms at bs16; what is left is the latency of the
// neighbourhood gathers and the accumulation into dW from many sites.
//
// Design: the whole f32 dW (343*3*64*4 B = 263 KB) does not fit in a
// block's shared memory, so block (x, p) accumulates the 49*Cin*64 values
// of one dx-plane p (37.6 KB at Cin 3) over a chunk of kSitesPerBlock
// sites (four such blocks fill an SM's threads). Each warp takes a site,
// each lane 2 of the 64 output channels and
// their two ct values. The warp walks the plane's 49*Cin neighbour values
// 32 at a time, takes a ballot of the non-zero ones, and for each of them
// broadcasts the value and adds value * ct to its row of the plane in
// shared memory (shared f32 atomics: warps of a block may hit the same
// row; the 32 lanes of one add hit 64 consecutive values). At the end the
// block adds its plane into the global f32 dW with one atomic per non-zero
// value. The order of the additions varies from run to run, so the result
// agrees with the plain version to f32 rounding, not bit for bit.
#include "common.cuh"

namespace dpcr {

constexpr int kK = 7;              // kernel size
constexpr int kR = kK / 2;         // radius
constexpr int kPlaneTaps = kK * kK;
constexpr int kWarps = 16;         // warps of a block
constexpr int kCout = 64;          // output channels
constexpr int kCpl = kCout / 32;   // output channels per lane
// 32 sites per warp: a warp walks its sites one after another, so longer
// chains leave the card with too few warps in flight, and shorter ones
// add global atomics at the blocks' ends
constexpr int kSitesPerBlock = 512;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
stem_sites_dw_kernel(const T* __restrict__ vol,
                     const int32_t* __restrict__ coords,
                     const uint8_t* __restrict__ mask,
                     const T* __restrict__ ct, float* __restrict__ dw, int B,
                     int D, int H, int W, int V, int cin) {
  extern __shared__ float plane_acc[];      // [kPlaneTaps * cin, kCout]
  const int p = blockIdx.y;                 // dx of the plane
  const int n = kPlaneTaps * cin;           // neighbour values of a plane
  for (int i = threadIdx.x; i < n * kCout; i += blockDim.x) plane_acc[i] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long first = (long long)blockIdx.x * kSitesPerBlock;
  const long long end = min(first + kSitesPerBlock, (long long)B * V);
  for (long long site = first + (threadIdx.x >> 5); site < end;
       site += kWarps) {                    // uniform within the warp
    if (!mask[site]) continue;
    const int cx = min(max(coords[site * 3 + 0], 0), D - 1);
    const int x = cx + p - kR;
    if (x < 0 || x >= D) continue;          // the plane lies outside
    const int cy = min(max(coords[site * 3 + 1], 0), H - 1);
    const int cz = min(max(coords[site * 3 + 2], 0), W - 1);
    const long long b = site / V;
    const T* vp = vol + ((size_t)b * D + x) * H * W * cin;
    float g[kCpl];
#pragma unroll
    for (int j = 0; j < kCpl; ++j)
      g[j] = to_float(ct[site * kCout + lane * kCpl + j]);

    for (int r0 = 0; r0 < n; r0 += 32) {
      const int r = r0 + lane;
      float v = 0.f;
      if (r < n) {
        const int tap = r / cin;
        const int ci = r - tap * cin;
        const int dy = tap / kK;
        const int dz = tap - dy * kK;
        const int yy = cy + dy - kR, zz = cz + dz - kR;
        if (yy >= 0 && yy < H && zz >= 0 && zz < W)
          v = to_float(vp[((size_t)yy * W + zz) * cin + ci]);
      }
      unsigned nz = __ballot_sync(0xffffffffu, v != 0.f);
      while (nz) {
        const int src = __ffs(nz) - 1;
        nz &= nz - 1;
        const float pv = __shfl_sync(0xffffffffu, v, src);
        float* a = plane_acc + (r0 + src) * kCout + lane * kCpl;
#pragma unroll
        for (int j = 0; j < kCpl; ++j) atomicAdd(a + j, pv * g[j]);
      }
    }
  }
  __syncthreads();
  float* out = dw + (size_t)p * n * kCout;
  for (int i = threadIdx.x; i < n * kCout; i += blockDim.x) {
    const float a = plane_acc[i];
    if (a != 0.f) atomicAdd(out + i, a);
  }
}

template <typename T>
static int launch(const void* vol, const void* coords, const void* mask,
                  const void* ct, void* dw, int B, int D, int H, int W, int V,
                  int cin, cudaStream_t stream) {
  const long long chunks =
      ((long long)B * V + kSitesPerBlock - 1) / kSitesPerBlock;
  if (chunks == 0) return 0;
  if (chunks > 0x7fffffffLL) return kBadShape;
  const size_t smem = (size_t)kPlaneTaps * cin * kCout * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      stem_sites_dw_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  stem_sites_dw_kernel<T><<<dim3((unsigned)chunks, kK), kWarps * 32, smem,
                            stream>>>(
      static_cast<const T*>(vol), static_cast<const int32_t*>(coords),
      static_cast<const uint8_t*>(mask), static_cast<const T*>(ct),
      static_cast<float*>(dw), B, D, H, W, V, cin);
  return (int)cudaGetLastError();
}

}  // namespace dpcr

// vol [B,D,H,W,cin] and ct [B,V,64] of one dtype, coords [B,V,3] int32,
// mask [B,V] uint8, dw [343,cin,64] float32 zeroed by the caller (the
// kernel adds into it); all contiguous; 1 <= cin <= 18 (one plane of dW in
// a block's shared memory).
// Returns 0 on success, a CUDA error code, or a negative dpcr::ArgError.
extern "C" int stem_sites_dw_launch(int dtype, const void* vol,
                                    const void* coords, const void* mask,
                                    const void* ct, void* dw, int B, int D,
                                    int H, int W, int V, int cin,
                                    void* stream) {
  if (cin < 1 || cin > 18 || D < 1 || H < 1 || W < 1 || V < 0 || B < 0)
    return dpcr::kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dpcr::kFloat32)
    return dpcr::launch<float>(vol, coords, mask, ct, dw, B, D, H, W, V, cin,
                               s);
  if (dtype == dpcr::kBFloat16)
    return dpcr::launch<__nv_bfloat16>(vol, coords, mask, ct, dw, B, D, H, W,
                                       V, cin, s);
  return dpcr::kBadDType;
}
