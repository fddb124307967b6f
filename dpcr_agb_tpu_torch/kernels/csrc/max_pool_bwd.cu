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
// What held the first version back (0.066 / 0.044 ms f32 / bf16 at the
// first SENet14 train batch on an H100, 58% / 44% of the bound): a thread
// per (row, 16-byte channel group) loaded its row's coordinates and mask,
// then walked the 8 parent slots, loading occ_l and only then y and ct at
// each occupied one. Each of those loads waited on the one before it,
// about 8 round trips to L2 before the row's one store; all 16 (8 in
// bf16) threads of a row repeated the small loads; each item paid 64-bit
// divisions; and bf16, at 8 threads a row, had half as many loads in
// flight over the same chain.
//
// Design: a group of G lanes a row (G a power of two from 8 to 32: the
// row's C / VEC items of VEC values, 16 bytes each in both dtypes; wider
// rows loop), so a warp takes 32 / G consecutive rows, which share most of
// their parents:
//   1. lanes 0-2 of the group load the row's coordinates and lane 3 its
//      mask; shuffles share them with the group (32-bit arithmetic from
//      here on: the C entry refuses shapes of 2^31 elements or more). A
//      masked or out-of-volume row stores its zeros at once;
//   2. a valid row's lanes 0-7 each load occ_l at one parent slot while
//      every lane loads its h items; a ballot gives the group the row's
//      mask of occupied parents;
//   3. each lane loads y and ct at the occupied parents, one parent at a
//      time in slot order, and adds.
// Steps 1 and 2 and the stores cost nothing beyond the write of dx: with
// step 3's loads taken out the kernel ran at torch.zero_'s rate on dx.
// What is left is step 3's gathers, bound by the rows in flight, so
// registers decide: loading every occupied parent before the first
// compare (up to 16 loads in flight, 93-104 registers) ran slower than the
// first version; one parent at a time in blocks of 4 warps, with the
// registers capped for 12 blocks an SM, ran fastest (PERF.md, section 6).
// The sum stays in the plain version's order: f32, parent slot 0 to 7
// (bit a of the slot picks the upper parent on axis a). Streaming stores:
// dx is written once. No atomics and no shared memory: each output value
// is owned by one lane, so the result equals the plain version exactly.
#include "common.cuh"

namespace dpcr {

constexpr int kRowWarps = 4;        // warps of a block
constexpr int kRowMinBlocks = 12;   // blocks an SM the registers leave room for

template <typename T, int VEC, int G>
__global__ void __launch_bounds__(kRowWarps * 32, kRowMinBlocks)
max_pool_k3s2_bwd_kernel(const int32_t* __restrict__ coords,
                         const uint8_t* __restrict__ mask,
                         const T* __restrict__ h, const T* __restrict__ y,
                         const T* __restrict__ occ_l,
                         const T* __restrict__ ct, T* __restrict__ dx,
                         unsigned rows, unsigned V, int D, int H, int W,
                         int C) {
  static_assert(G >= 8 && G <= 32 && (G & (G - 1)) == 0, "8 to 32 lanes");
  using P = Pack<T, VEC>;
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);           // this lane within its row's group
  const unsigned row = (blockIdx.x * (kRowWarps * 32u) + threadIdx.x) / G;
  const bool live = row < rows;
  // round trip 1: the row's coordinates and mask, shared by shuffles
  int v = 0;
  if (live && gl < 4) v = gl < 3 ? coords[row * 3 + gl] : (int)mask[row];
  const int cx = __shfl_sync(all, v, 0, G), cy = __shfl_sync(all, v, 1, G),
            cz = __shfl_sync(all, v, 2, G);
  const bool valid = __shfl_sync(all, v, 3, G) != 0 && cx >= 0 && cx < D &&
                     cy >= 0 && cy < H && cz >= 0 && cz < W;
  const int D1 = (D + 1) >> 1, H1 = (H + 1) >> 1, W1 = (W + 1) >> 1;
  // bit a of `up`: axis a has an upper parent (an odd coordinate whose
  // upper parent lies inside the level-1 extent)
  const int up = (int)((cx & 1) && (cx >> 1) + 1 < D1) |
                 (int)((cy & 1) && (cy >> 1) + 1 < H1) << 1 |
                 (int)((cz & 1) && (cz >> 1) + 1 < W1) << 2;
  // the lower parent's cell; slot s adds the strides of the axes in s
  const unsigned sy = (unsigned)W1, sx = (unsigned)H1 * W1;
  const unsigned lower =
      valid ? (((row / V) * D1 + (cx >> 1)) * H1 + (cy >> 1)) * W1 + (cz >> 1)
            : 0u;
  const int groups = C / VEC;
  const unsigned row_at = row * (unsigned)C;
  // round trip 2: occ_l at slot gl (lanes 0-7) beside the first h items
  P hv;
  if (valid && gl < groups)
    hv = *reinterpret_cast<const P*>(h + row_at + gl * VEC);
  bool occ = false;
  if (valid && gl < 8 && (gl & ~up) == 0) {
    const unsigned u = lower + (gl & 1) * sx + (gl >> 1 & 1) * sy + (gl >> 2);
    occ = to_float(occ_l[u]) > 0.f;
  }
  const unsigned occupied =
      (__ballot_sync(all, occ) >> (lane & ~(G - 1))) & 0xffu;
  if (!live) return;
  if (!valid) {
    P zero;
#pragma unroll
    for (int e = 0; e < VEC; ++e) zero.v[e] = from_float<T>(0.f);
    for (int g = gl; g < groups; g += G)
      store_streaming<T, VEC>(dx + row_at + g * VEC, zero);
    return;
  }
  for (int g = gl; g < groups; g += G) {
    if (g != gl) hv = *reinterpret_cast<const P*>(h + row_at + g * VEC);
    // round trip 3: y and ct at each occupied parent, in slot order
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    for (unsigned left = occupied; left; left &= left - 1u) {
      const int s = __ffs(left) - 1;
      const unsigned u =
          (lower + (s & 1) * sx + (s >> 1 & 1) * sy + (s >> 2)) * C + g * VEC;
      const P yv = *reinterpret_cast<const P*>(y + u);
      const P cv = *reinterpret_cast<const P*>(ct + u);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (to_float(yv.v[e]) == to_float(hv.v[e]))
          acc[e] += to_float(cv.v[e]);
    }
    P out;
#pragma unroll
    for (int e = 0; e < VEC; ++e) out.v[e] = from_float<T>(acc[e]);
    store_streaming<T, VEC>(dx + row_at + g * VEC, out);
  }
}

// the row form's element offsets are 32-bit
static bool fits_rows(long long B, long long V, long long D1, long long H1,
                      long long W1, long long C) {
  return B * V * C < 0x7fffffffLL && B * D1 * H1 * W1 * C < 0x7fffffffLL;
}

template <typename T, int VEC, int G>
static void launch_groups(const void* coords, const void* mask,
                          const void* h, const void* y, const void* occ_l,
                          const void* ct, void* dx, unsigned rows, int V,
                          int D, int H, int W, int C, cudaStream_t stream) {
  constexpr unsigned per_block = kRowWarps * 32 / G;   // rows a block
  max_pool_k3s2_bwd_kernel<T, VEC, G>
      <<<(rows + per_block - 1) / per_block, kRowWarps * 32, 0, stream>>>(
          static_cast<const int32_t*>(coords),
          static_cast<const uint8_t*>(mask), static_cast<const T*>(h),
          static_cast<const T*>(y), static_cast<const T*>(occ_l),
          static_cast<const T*>(ct), static_cast<T*>(dx), rows, (unsigned)V,
          D, H, W, C);
}

template <typename T>
static int launch(const void* coords, const void* mask, const void* h,
                  const void* y, const void* occ_l, const void* ct, void* dx,
                  int B, int V, int D, int H, int W, int C,
                  cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);   // a lane's 16-byte item
  if ((C * sizeof(T)) % 16 != 0 || C % VEC != 0) return kBadShape;
  const unsigned rows = (unsigned)B * V;
  if (rows == 0) return 0;
  const int groups = C / VEC;     // a row's items: a group of 8 to 32 lanes
  if (groups <= 8)
    launch_groups<T, VEC, 8>(coords, mask, h, y, occ_l, ct, dx, rows, V, D,
                             H, W, C, stream);
  else if (groups <= 16)
    launch_groups<T, VEC, 16>(coords, mask, h, y, occ_l, ct, dx, rows, V, D,
                              H, W, C, stream);
  else
    launch_groups<T, VEC, 32>(coords, mask, h, y, occ_l, ct, dx, rows, V, D,
                              H, W, C, stream);
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
// aligned, C a whole number of 16-byte groups (4 f32 or 8 bf16 values),
// B*V*C and B*ceil(D/2)*ceil(H/2)*ceil(W/2)*C below 2^31.
// Returns 0 on success, a CUDA error code, or a negative dpcr::ArgError.
extern "C" int max_pool_k3s2_bwd_launch(int dtype, const void* coords,
                                        const void* mask, const void* h,
                                        const void* y, const void* occ_l,
                                        const void* ct, void* dx, int B, int V,
                                        int D, int H, int W, int C,
                                        void* stream) {
  if (B < 0 || V < 0 || D < 1 || H < 1 || W < 1 || C < 1 ||
      !dpcr::fits_rows(B, V, (D + 1) / 2, (H + 1) / 2, (W + 1) / 2, C))
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
