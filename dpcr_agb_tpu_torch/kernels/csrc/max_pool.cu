// max_pool_k3s2: the masked Minkowski MaxPool (kernel 3, stride 2) forward.
//
// Replaces: the Pallas forward kernel _fwd_kernel of
// dpcr_agb_tpu/ops/pallas_pool.py (called through _fwd_call and
// pallas_max_pool). Output cell u takes the max over the input window
// {2u-1, 2u, 2u+1} on each axis, where unoccupied and out-of-range inputs
// count as -inf; it is zeroed where the pooled occupancy is 0, i.e. where
// none of its 2^3 children {2u, 2u+1}^3 is occupied (the reference masks by
// occupancy_pool). An occupied output always has an occupied input in its
// window, so no -inf reaches the output.
//
// What bounds it on an H100: bytes. It does ~27 compares per output against
// one read of the C-channel input volume (1.6 GB in bf16 at the bs16 main
// path shape) and one write of an eighth of that, so the 3.35 TB/s memory
// rate is the limit.
//
// Design: one thread per output cell and 16-byte group of channels (8 bf16
// or 4 f32 values), groups innermost, so a warp reads whole 16-byte chunks
// of consecutive channels of one input cell (coalesced, 128-bit loads) and
// the ~3x overlap of neighbouring windows is served from L1/L2. A cell's
// occupancy is read once per channel group, and empty cells skip the value
// load. Child occupancy is tracked in the same loop, so the kernel needs no
// pooled occupancy volume. Each input is read from device memory about once.
#include <math.h>

#include "common.cuh"

namespace dpcr {

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void max_pool_k3s2_kernel(const T* __restrict__ x,
                                     const T* __restrict__ occ,
                                     T* __restrict__ y, int B, int D, int H,
                                     int W, int C, int D1, int H1, int W1) {
  using P = Pack<T, VEC>;
  const int groups = C / VEC;
  const long long total = (long long)B * D1 * H1 * W1 * groups;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += step) {
    const int g = (int)(idx % groups);
    long long t = idx / groups;
    const int k = (int)(t % W1);
    t /= W1;
    const int j = (int)(t % H1);
    t /= H1;
    const int i = (int)(t % D1);
    const long long b = t / D1;
    float m[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) m[e] = -INFINITY;
    bool child = false;
    for (int a = -1; a <= 1; ++a) {
      const int xi = 2 * i + a;
      if (xi < 0 || xi >= D) continue;
      for (int c = -1; c <= 1; ++c) {
        const int yi = 2 * j + c;
        if (yi < 0 || yi >= H) continue;
        for (int f = -1; f <= 1; ++f) {
          const int zi = 2 * k + f;
          if (zi < 0 || zi >= W) continue;
          const size_t cell = (((size_t)b * D + xi) * H + yi) * W + zi;
          if (!(to_float(occ[cell]) > 0.f)) continue;
          const P p = *reinterpret_cast<const P*>(x + cell * C + g * VEC);
#pragma unroll
          for (int e = 0; e < VEC; ++e) m[e] = fmaxf(m[e], to_float(p.v[e]));
          child = child || (a >= 0 && c >= 0 && f >= 0);
        }
      }
    }
    P out;
#pragma unroll
    for (int e = 0; e < VEC; ++e) out.v[e] = from_float<T>(child ? m[e] : 0.f);
    *reinterpret_cast<P*>(y + idx * VEC) = out;
  }
}

template <typename T>
static int launch(const void* x, const void* occ, void* y, int B, int D,
                  int H, int W, int C, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);  // 16-byte channel groups
  if (C % VEC != 0) return kBadShape;
  const int D1 = (D + 1) / 2, H1 = (H + 1) / 2, W1 = (W + 1) / 2;
  const long long total = (long long)B * D1 * H1 * W1 * (C / VEC);
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;  // grid-stride beyond this
  max_pool_k3s2_kernel<T, VEC><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(occ),
      static_cast<T*>(y), B, D, H, W, C, D1, H1, W1);
  return (int)cudaGetLastError();
}

}  // namespace dpcr

// x [B,D,H,W,C], occ [B,D,H,W] (>0 = occupied), y [B,ceil(D/2),ceil(H/2),
// ceil(W/2),C]; all contiguous and of one dtype, x and y 16-byte aligned,
// C a whole number of 16-byte groups (4 f32 or 8 bf16 values).
// Returns 0 on success, a CUDA error code, or a negative dpcr::ArgError.
extern "C" int max_pool_k3s2_launch(int dtype, const void* x, const void* occ,
                                    void* y, int B, int D, int H, int W, int C,
                                    void* stream) {
  if (B < 0 || D < 1 || H < 1 || W < 1 || C < 1) return dpcr::kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dpcr::kFloat32)
    return dpcr::launch<float>(x, occ, y, B, D, H, W, C, s);
  if (dtype == dpcr::kBFloat16)
    return dpcr::launch<__nv_bfloat16>(x, occ, y, B, D, H, W, C, s);
  return dpcr::kBadDType;
}
