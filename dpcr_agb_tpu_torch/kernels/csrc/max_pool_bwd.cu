// max_pool_k3s2_bwd: the equality-routed backward of the masked Minkowski
// MaxPool (kernel 3, stride 2), in row form.
//
// Replaces: the Pallas backward kernel _bwd_kernel of
// dpcr_agb_tpu/ops/pallas_pool.py (called through _bwd_call and the VJP of
// pallas_max_pool), in the row form the training path uses
// (dpcr_agb_tpu/ops/sparse_stem.py _pool_bwd_rows / _pooled_rows_bwd):
// the pool's input is the level-0 rows h [B,V,C], scattered to the
// full-resolution volume only inside the forward. Each row x lies in the
// window of the level-1 cells u with |x - 2u|_inf <= 1, i.e. u_d in
// {x_d/2, (x_d+1)/2} per axis: 1 to 8 distinct parents. For each row and
// channel,
//   dx[row, c] = sum over valid parents u with occ_l[u] > 0 and
//                y[u, c] == h[row, c]  of  ct[u, c]
// summed in f32 in parent-slot order (bit a of the slot picks the upper
// parent on axis a), written in the rows' dtype. Every maximizer of a
// window gets the full cotangent (the TPU kernel's tie rule). The pooled
// value y is zero at unoccupied level-1 cells, so their ct is skipped
// (the reference masks ct by occ_l; the kernel masks, the caller does not).
// Masked rows and rows outside the volume write 0.
//
// What bounds it on an H100: bytes. Per row it reads C values of h, and
// y and ct at up to 8 parent cells (served from L2 after the first
// reader: neighbouring rows share parents), and writes C values. The
// compares and adds are a few per byte.
//
// Design: one thread per (row, 16-byte channel group), groups innermost,
// so a warp reads whole 16-byte chunks of neighbouring channels with
// 128-bit loads. No atomics and no shared memory: each output value is
// owned by one thread, so the result equals the plain version exactly.
#include "common.cuh"

namespace dpcr {

template <typename T, int VEC>
__global__ void max_pool_k3s2_bwd_kernel(
    const int32_t* __restrict__ coords, const uint8_t* __restrict__ mask,
    const T* __restrict__ h, const T* __restrict__ y,
    const T* __restrict__ occ_l, const T* __restrict__ ct, T* __restrict__ dx,
    int B, int V, int D, int H, int W, int C) {
  using P = Pack<T, VEC>;
  const int D1 = (D + 1) / 2, H1 = (H + 1) / 2, W1 = (W + 1) / 2;
  const int groups = C / VEC;
  const long long total = (long long)B * V * groups;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += step) {
    const int g = (int)(idx % groups);
    const long long row = idx / groups;
    const long long b = row / V;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    const int cx = coords[row * 3 + 0], cy = coords[row * 3 + 1],
              cz = coords[row * 3 + 2];
    if (mask[row] && cx >= 0 && cx < D && cy >= 0 && cy < H && cz >= 0 &&
        cz < W) {
      const P hv = *reinterpret_cast<const P*>(h + row * C + g * VEC);
      const int lo[3] = {cx >> 1, cy >> 1, cz >> 1};
      const int hi[3] = {(cx + 1) >> 1, (cy + 1) >> 1, (cz + 1) >> 1};
      const int ext[3] = {D1, H1, W1};
#pragma unroll
      for (int bits = 0; bits < 8; ++bits) {
        int u[3];
        bool ok = true;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const bool up = (bits >> a) & 1;
          ok = ok && !(up && hi[a] == lo[a]) && (up ? hi[a] : lo[a]) < ext[a];
          u[a] = up ? hi[a] : lo[a];
        }
        if (!ok) continue;
        const size_t cell = (((size_t)b * D1 + u[0]) * H1 + u[1]) * W1 + u[2];
        if (!(to_float(occ_l[cell]) > 0.f)) continue;
        const P yv = *reinterpret_cast<const P*>(y + cell * C + g * VEC);
        const P cv = *reinterpret_cast<const P*>(ct + cell * C + g * VEC);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (to_float(yv.v[e]) == to_float(hv.v[e]))
            acc[e] += to_float(cv.v[e]);
      }
    }
    P out;
#pragma unroll
    for (int e = 0; e < VEC; ++e) out.v[e] = from_float<T>(acc[e]);
    *reinterpret_cast<P*>(dx + row * C + g * VEC) = out;
  }
}

template <typename T>
static int launch(const void* coords, const void* mask, const void* h,
                  const void* y, const void* occ_l, const void* ct, void* dx,
                  int B, int V, int D, int H, int W, int C,
                  cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);  // 16-byte channel groups
  if (C % VEC != 0) return kBadShape;
  const long long total = (long long)B * V * (C / VEC);
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;  // grid-stride beyond this
  max_pool_k3s2_bwd_kernel<T, VEC><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const int32_t*>(coords), static_cast<const uint8_t*>(mask),
      static_cast<const T*>(h), static_cast<const T*>(y),
      static_cast<const T*>(occ_l), static_cast<const T*>(ct),
      static_cast<T*>(dx), B, V, D, H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace dpcr

// coords [B,V,3] int32, mask [B,V] uint8, h [B,V,C], y and ct
// [B,ceil(D/2),ceil(H/2),ceil(W/2),C], occ_l [B,ceil(D/2),...,1], dx
// [B,V,C]; all contiguous, h/y/occ_l/ct/dx of one dtype, h/y/ct/dx 16-byte
// aligned, C a whole number of 16-byte groups (4 f32 or 8 bf16 values).
// Returns 0 on success, a CUDA error code, or a negative dpcr::ArgError.
extern "C" int max_pool_k3s2_bwd_launch(int dtype, const void* coords,
                                        const void* mask, const void* h,
                                        const void* y, const void* occ_l,
                                        const void* ct, void* dx, int B, int V,
                                        int D, int H, int W, int C,
                                        void* stream) {
  if (B < 0 || V < 0 || D < 1 || H < 1 || W < 1 || C < 1)
    return dpcr::kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dpcr::kFloat32)
    return dpcr::launch<float>(coords, mask, h, y, occ_l, ct, dx, B, V, D, H,
                               W, C, s);
  if (dtype == dpcr::kBFloat16)
    return dpcr::launch<__nv_bfloat16>(coords, mask, h, y, occ_l, ct, dx, B,
                                       V, D, H, W, C, s);
  return dpcr::kBadDType;
}
