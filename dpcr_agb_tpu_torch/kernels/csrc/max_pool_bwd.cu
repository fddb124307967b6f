// max_pool_k3s2_bwd and max_pool_k3s2_bwd_vol: the equality-routed backward
// of the masked Minkowski MaxPool (kernel 3, stride 2), in row form and in
// volume form. Both route alike: an input cell x lies in the window of the
// level-1 cells u with |x - 2u|_inf <= 1, and gets the full cotangent of
// each of them whose max it equals.
//
// ---- row form ----
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

// ---- volume form ----
//
// Replaces: the same Pallas kernel _bwd_kernel as it is called by the VJP
// of pallas_max_pool (dpcr_agb_tpu/ops/pallas_pool.py _pool_bwd): volume
// in, volume out. The dense level 0 pools the full-resolution activation
// x [B,D,H,W,C] under its occupancy; at first_stride 2 that occupancy is a
// pooled one with no row list, so the row form does not apply. For each
// input cell and channel,
//   dx[cell, c] = occ_in[cell] > 0 ?
//       sum over the covering outputs u with y[u, c] == x[cell, c] of
//       ct[u, c] : 0
// with u_a in {x_a/2, and (x_a+1)/2 when x_a is odd and inside the level-1
// extent}. The sum is taken in f32 in the TPU kernel's order (each first-
// axis parent's up to four terms summed alone, second axis outside the
// third, the lower parent first; then the two partial sums added), written
// in x's dtype. ct arrives masked by the output occupancy, as in the reference;
// the reference's dx * (occ_in > 0) is folded in here.
//
// What bounds it on an H100: bytes, and nearly all of them the write of dx
// (3.30 GB in f32 at [16,88,88,104,64]): about 1% of the level-0 cells are
// occupied, and only those read x, y and ct.
//
// What held the first version back (1.71 / 1.07 ms f32 / bf16 at that
// shape, 60% / 48% of the bound): a thread per (cell, 16-byte group) did
// 64-bit divisions by the group count and the three extents and read the
// cell's occupancy itself, so the 99% of cells that only store zeros paid
// that per 16 bytes written, and bf16 paid it over half the bytes.
//
// Design: two passes. The first writes dx's zeros with streaming 16-byte
// stores and reads nothing: it runs at the card's fill rate. The second
// writes the occupied cells over them. Its warps own tiles of 32
// consecutive cells, kVolTiles tiles each, with 32-bit indices: a lane
// reads one cell's occupancy of each of its warp's tiles up front, a
// ballot marks the tile's occupied cells, an empty tile costs nothing
// more. In a tile with occupied cells, the lane of each finds its lower
// parent and which axes have an upper one (one 32-bit division per
// occupied cell, none per item) and lists them in the warp's shared
// memory in tile order; the warp then takes the occupied cells' (cell,
// group of 4 values) items 32 at a time, so a tile with k occupied cells
// costs k * C / 128 steps. A lane reads x and the four loads of a
// first-axis parent's plane before it sums them. Groups of 4 values in
// both dtypes (8 bytes in bf16) halve the bf16 registers of 8-value
// groups, and this pass is bound by its loads' latency, not by bytes. A
// single pass that stores a tile's zeros around its occupied cells was
// 0.11 / 0.02 ms slower in f32 / bf16 at the main path's shape on an H100
// (PERF.md, section 6): its warps wait on the occupied cells' loads in a
// saturated write stream. No atomics: each output value is owned by one
// lane, so the result equals the plain version exactly.
constexpr int kVolWarps = 4;   // warps of a block of the second pass
constexpr int kVolTiles = 4;   // 32-cell tiles a warp
constexpr int kVolVec = 4;     // values of an item of the second pass
constexpr int kZeroWords = 8;  // 16-byte words a thread of the first pass

// the first pass: dx zeroed, a block per kZeroWords x 256 words
__global__ void __launch_bounds__(256)
zero_words_kernel(uint4* __restrict__ dst, size_t n_words) {
  const size_t base = (size_t)blockIdx.x * (kZeroWords * 256);
  const uint4 zero = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int u = 0; u < kZeroWords; ++u) {
    const size_t i = base + u * 256 + threadIdx.x;
    if (i < n_words) __stcs(dst + i, zero);
  }
}

// dx at occupied cell `cell`, group g of kVolVec values: u0 is its lower
// parent, bit a of `up` says whether axis a has an upper one, sx and sy
// are the level-1 strides of the first two axes
template <typename T>
__device__ __forceinline__ Pack<T, kVolVec> vol_cell_grad(
    const T* __restrict__ x, const T* __restrict__ y,
    const T* __restrict__ ct, unsigned cell, unsigned u0, int up,
    unsigned sx, unsigned sy, int C, int g) {
  using P = Pack<T, kVolVec>;
  const P xv =
      *reinterpret_cast<const P*>(x + (size_t)cell * C + g * kVolVec);
  float acc[kVolVec];
#pragma unroll
  for (int e = 0; e < kVolVec; ++e) acc[e] = 0.f;
#pragma unroll
  for (int tx = 0; tx < 2; ++tx) {
    if (tx && !(up & 1)) break;
    P yv[4], cv[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {     // t = 2 ty + tz
      if (((t >> 1) && !(up & 2)) || ((t & 1) && !(up & 4))) continue;
      const size_t u = (size_t)(u0 + tx * sx + (t >> 1) * sy + (t & 1)) * C
                       + g * kVolVec;
      yv[t] = *reinterpret_cast<const P*>(y + u);
      cv[t] = *reinterpret_cast<const P*>(ct + u);
    }
    float part[kVolVec];  // this first-axis parent's plane, summed alone
#pragma unroll
    for (int e = 0; e < kVolVec; ++e) part[e] = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (((t >> 1) && !(up & 2)) || ((t & 1) && !(up & 4))) continue;
#pragma unroll
      for (int e = 0; e < kVolVec; ++e)
        if (to_float(yv[t].v[e]) == to_float(xv.v[e]))
          part[e] += to_float(cv[t].v[e]);
    }
#pragma unroll
    for (int e = 0; e < kVolVec; ++e) acc[e] += part[e];
  }
  P out;
#pragma unroll
  for (int e = 0; e < kVolVec; ++e) out.v[e] = from_float<T>(acc[e]);
  return out;
}

// the second pass: the occupied cells of kVolTiles 32-cell tiles a warp
template <typename T>
__global__ void __launch_bounds__(kVolWarps * 32)
max_pool_k3s2_bwd_vol_kernel(const T* __restrict__ x,
                             const T* __restrict__ occ_in,
                             const T* __restrict__ y,
                             const T* __restrict__ ct, T* __restrict__ dx,
                             int D, int H, int W, int C, unsigned n_cells) {
  // the tile's occupied cells in order: lower parent; lane | up << 5
  __shared__ unsigned slot_u[kVolWarps][32];
  __shared__ int slot_c[kVolWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int D1 = (D + 1) / 2, H1 = (H + 1) / 2, W1 = (W + 1) / 2;
  const unsigned sy = W1, sx = (unsigned)H1 * W1;
  const int groups = C / kVolVec;
  // this lane's first item (occupied cell j of the tile, group g) and the
  // step of 32 items, so that the item loop divides nothing
  const int j0 = lane / groups, g0 = lane - j0 * groups;
  const int dq = 32 / groups, dr = 32 - dq * groups;
  const unsigned tile0 = blockIdx.x * (kVolWarps * kVolTiles) + warp;
  bool occ[kVolTiles];
#pragma unroll
  for (int k = 0; k < kVolTiles; ++k) {
    const unsigned cell = (tile0 + k * kVolWarps) * 32 + lane;
    occ[k] = cell < n_cells && to_float(occ_in[cell]) > 0.f;
  }
#pragma unroll
  for (int k = 0; k < kVolTiles; ++k) {
    const unsigned base = (tile0 + k * kVolWarps) * 32;
    const unsigned hit = __ballot_sync(0xffffffffu, occ[k]);
    if (hit == 0u) continue;                      // uniform within the warp
    if (occ[k]) {
      const unsigned cell = base + lane;
      const int cz = (int)(cell % W);
      unsigned t = cell / W;
      const int cy = (int)(t % H);
      t /= H;
      const int cx = (int)(t % D);
      const unsigned b = t / D;
      const int up = (int)((cx & 1) && ((cx + 1) >> 1) < D1) |
                     (int)((cy & 1) && ((cy + 1) >> 1) < H1) << 1 |
                     (int)((cz & 1) && ((cz + 1) >> 1) < W1) << 2;
      const int rank = __popc(hit & ((1u << lane) - 1u));
      slot_u[warp][rank] =
          ((b * D1 + (cx >> 1)) * H1 + (cy >> 1)) * W1 + (cz >> 1);
      slot_c[warp][rank] = lane | up << 5;
    }
    __syncwarp();
    int j = j0, g = g0;
    for (int it = lane; it < __popc(hit) * groups; it += 32) {
      const int cl = slot_c[warp][j] & 31;
      store_streaming<T, kVolVec>(
          dx + ((size_t)base + cl) * C + g * kVolVec,
          vol_cell_grad<T>(x, y, ct, base + cl, slot_u[warp][j],
                           slot_c[warp][j] >> 5, sx, sy, C, g));
      g += dr;
      j += dq;
      if (g >= groups) {
        g -= groups;
        ++j;
      }
    }
    __syncwarp();                  // the slots are the next tile's
  }
}

// the volume form's cell indices are 32-bit
static bool fits(long long B, long long D, long long H, long long W) {
  return B * D * H * W < 0x7fffffffLL;
}

template <typename T>
static int launch_vol(const void* x, const void* occ_in, const void* y,
                      const void* ct, void* dx, int B, int D, int H, int W,
                      int C, cudaStream_t stream) {
  if ((C * sizeof(T)) % 16 != 0) return kBadShape;  // 16-byte groups
  const unsigned n_cells = (unsigned)B * D * H * W;
  if (n_cells == 0) return 0;
  const size_t words = (size_t)n_cells * C * sizeof(T) / 16;
  zero_words_kernel<<<(unsigned)((words + kZeroWords * 256 - 1) /
                                 (kZeroWords * 256)),
                      256, 0, stream>>>(static_cast<uint4*>(dx), words);
  const unsigned tiles = (n_cells + 31) / 32;
  max_pool_k3s2_bwd_vol_kernel<T>
      <<<(tiles + kVolWarps * kVolTiles - 1) / (kVolWarps * kVolTiles),
         kVolWarps * 32, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(occ_in),
          static_cast<const T*>(y), static_cast<const T*>(ct),
          static_cast<T*>(dx), D, H, W, C, n_cells);
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

// x and dx [B,D,H,W,C], occ_in [B,D,H,W,1] (>0 = occupied), y and ct
// [B,ceil(D/2),ceil(H/2),ceil(W/2),C] with ct already zero at unoccupied
// outputs; all contiguous and of one dtype, x/y/ct/dx 16-byte aligned, C a
// whole number of 16-byte groups (4 f32 or 8 bf16 values), B*D*H*W < 2^31.
// Returns 0 on success, a CUDA error code, or a negative dpcr::ArgError.
extern "C" int max_pool_k3s2_bwd_vol_launch(int dtype, const void* x,
                                            const void* occ_in, const void* y,
                                            const void* ct, void* dx, int B,
                                            int D, int H, int W, int C,
                                            void* stream) {
  if (B < 0 || D < 1 || H < 1 || W < 1 || C < 1 || !dpcr::fits(B, D, H, W))
    return dpcr::kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dpcr::kFloat32)
    return dpcr::launch_vol<float>(x, occ_in, y, ct, dx, B, D, H, W, C, s);
  if (dtype == dpcr::kBFloat16)
    return dpcr::launch_vol<__nv_bfloat16>(x, occ_in, y, ct, dx, B, D, H, W,
                                           C, s);
  return dpcr::kBadDType;
}
