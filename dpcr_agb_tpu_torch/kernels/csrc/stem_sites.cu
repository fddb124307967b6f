// stem_sites: the k=7 stem convolution evaluated only at occupied voxel sites.
//
// Replaces: the Pallas stem kernels of dpcr_agb_tpu/ops/pallas_stem.py
// (_fwd_kernel_x1, _fwd_kernel_xtile, _fwd_kernel_rev, _dma_kernel, all
// reached through fused_stem_conv_volume), which compute the same conv over
// the whole volume from a z+y-folded table, read at the sites by the caller.
// Here the output is the rows themselves:
//   y[b,v,:] = sum_{o in 7^3} vol[b, c_v + o - 3, :] @ W[o]     (+ bias)
// with out-of-volume neighbours reading 0 and masked rows written as 0.
//
// What bounds it on an H100: neither the card's memory rate nor its
// arithmetic rate. The level-0 volume is ~2% occupied, so of a site's
// 343*Cin neighbour values only ~16% are non-zero (169 of 1029 on the
// synthetic NFI batch), and the products that the data needs (2*169*64
// flops a site) take well under 0.1 ms at bs16. What is left is the latency
// of gathering each site's neighbourhood from the volume (which fits in the
// 50 MB L2) and of reading one weight row per non-zero value.
//
// Design: one warp per site, each lane owning 2 of the 64 output channels
// (Cout is SENet14's init_dim; other widths come with the models that need
// them). The warp walks the site's 343*Cin neighbour values 32 at a time
// (one per lane, z-contiguous runs in memory), takes a ballot of the non-zero
// ones, and for each of them broadcasts the value and reads its weight row
// (64 consecutive values, one coalesced load per warp), accumulating in f32
// in offset order. Empty cells cost one load and no arithmetic; masked
// rows cost nothing. No shared memory and no block barrier. The fold table
// of the TPU version is not rebuilt: it exists only because row gathers are
// costly there. A tensor-core (wgmma) version over compacted neighbour
// lists is later work.
#include "common.cuh"

namespace dpcr {

constexpr int kK = 7;         // kernel size
constexpr int kR = kK / 2;    // radius
constexpr int kTaps = kK * kK * kK;
constexpr int kWarps = 8;     // sites per block of 256 threads
constexpr int kCout = 64;     // output channels
constexpr int kCpl = kCout / 32;  // output channels per lane

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
stem_sites_kernel(const T* __restrict__ vol, const int32_t* __restrict__ coords,
                  const uint8_t* __restrict__ mask,
                  const T* __restrict__ weights, const T* __restrict__ bias,
                  T* __restrict__ out, int B, int D, int H, int W, int V,
                  int cin, int cout) {
  const int lane = threadIdx.x & 31;
  const long long site = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (site >= (long long)B * V) return;          // uniform within the warp
  T* o = out + site * cout + lane * kCpl;
  if (!mask[site]) {
#pragma unroll
    for (int j = 0; j < kCpl; ++j) o[j] = from_float<T>(0.f);
    return;
  }
  const long long b = site / V;
  // rows past the volume read at the clipped site, like the reference
  const int cx = min(max(coords[site * 3 + 0], 0), D - 1);
  const int cy = min(max(coords[site * 3 + 1], 0), H - 1);
  const int cz = min(max(coords[site * 3 + 2], 0), W - 1);
  const T* vb = vol + (size_t)b * D * H * W * cin;

  float acc[kCpl];
#pragma unroll
  for (int j = 0; j < kCpl; ++j) acc[j] = 0.f;

  const int kc = kTaps * cin;
  for (int r0 = 0; r0 < kc; r0 += 32) {
    const int r = r0 + lane;
    float v = 0.f;
    if (r < kc) {
      const int tap = r / cin;
      const int ci = r - tap * cin;
      const int dx = tap / (kK * kK);
      const int rem = tap - dx * (kK * kK);
      const int dy = rem / kK;
      const int dz = rem - dy * kK;
      const int x = cx + dx - kR, y = cy + dy - kR, z = cz + dz - kR;
      if (x >= 0 && x < D && y >= 0 && y < H && z >= 0 && z < W)
        v = to_float(vb[(((size_t)x * H + y) * W + z) * cin + ci]);
    }
    unsigned nz = __ballot_sync(0xffffffffu, v != 0.f);
    while (nz) {
      const int src = __ffs(nz) - 1;
      nz &= nz - 1;
      const float pv = __shfl_sync(0xffffffffu, v, src);
      const T* w = weights + (size_t)(r0 + src) * cout + lane * kCpl;
#pragma unroll
      for (int j = 0; j < kCpl; ++j) acc[j] = fmaf(pv, to_float(w[j]), acc[j]);
    }
  }

#pragma unroll
  for (int j = 0; j < kCpl; ++j) {
    // round to the output type first, then add the bias in that type:
    // the reference casts the f32 product and adds the bias afterwards
    T yv = from_float<T>(acc[j]);
    if (bias != nullptr)
      yv = from_float<T>(to_float(yv) + to_float(bias[lane * kCpl + j]));
    o[j] = yv;
  }
}

template <typename T>
static int launch(const void* vol, const void* coords, const void* mask,
                  const void* weights, const void* bias, void* out, int B,
                  int D, int H, int W, int V, int cin, int cout,
                  cudaStream_t stream) {
  const long long nsites = (long long)B * V;
  const long long blocks = (nsites + kWarps - 1) / kWarps;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return kBadShape;
  stem_sites_kernel<T><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(vol), static_cast<const int32_t*>(coords),
      static_cast<const uint8_t*>(mask), static_cast<const T*>(weights),
      static_cast<const T*>(bias), static_cast<T*>(out), B, D, H, W, V, cin,
      cout);
  return (int)cudaGetLastError();
}

}  // namespace dpcr

// vol [B,D,H,W,cin], coords [B,V,3] int32, mask [B,V] uint8,
// weights [343,cin,cout], bias [cout] or null, out [B,V,cout]; all
// contiguous, vol/weights/bias/out of one dtype; cout == 64.
// Returns 0 on success, a CUDA error code, or a negative dpcr::ArgError.
extern "C" int stem_sites_launch(int dtype, const void* vol,
                                 const void* coords, const void* mask,
                                 const void* weights, const void* bias,
                                 void* out, int B, int D, int H, int W, int V,
                                 int cin, int cout, void* stream) {
  if (cin < 1 || cout != dpcr::kCout || D < 1 || H < 1 || W < 1 || V < 0 ||
      B < 0)
    return dpcr::kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dpcr::kFloat32)
    return dpcr::launch<float>(vol, coords, mask, weights, bias, out, B, D, H,
                               W, V, cin, cout, s);
  if (dtype == dpcr::kBFloat16)
    return dpcr::launch<__nv_bfloat16>(vol, coords, mask, weights, bias, out,
                                       B, D, H, W, V, cin, cout, s);
  return dpcr::kBadDType;
}
