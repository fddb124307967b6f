// max_pool_k3s2 and max_pool_k3s2_rows: the masked Minkowski MaxPool
// (kernel 3, stride 2) forward, of a volume and of the level-0 rows.
//
// Replaces: the Pallas forward kernel _fwd_kernel of
// dpcr_agb_tpu/ops/pallas_pool.py (called through _fwd_call and
// pallas_max_pool), and for the rows the composite that
// dpcr_agb_tpu/ops/sparse_stem.py pooled_rows_fused runs in its forward
// (scatter of the rows into a full-resolution volume, occupancy_pool, the
// window max). Output cell u takes the max over the input window
// {2u-1, 2u, 2u+1} on each axis, where unoccupied and out-of-range inputs
// count as -inf; it is zeroed where none of its 2^3 children {2u, 2u+1}^3 is
// occupied. An occupied child lies in the window, so no -inf reaches the
// output.
//
// What bounds it on an H100: bytes, and of those the output. The volume
// form reads the occupancy and the occupied inputs' values (~2% of the
// cells on the main path) and writes all of y ([16,44,44,40,64] at bs16:
// 317 MB f32). The row form reads the rows once, and an occupancy bitmap
// (1.2 MB at bs16) and an int32 cell -> row index volume (40 MB, read and
// written at the occupied cells only) in place of the C-wide volume (2.54
// GB f32) that the scatter route built, zeroed and read.
//
// What held the first version back (0.75 / 0.41 ms f32 / bf16 at bs16): a
// thread per (output cell, 16-byte channel group) read all 27 window
// cells' occupancy itself, so each output's window was read 16 (f32) or 8
// (bf16) times, and it walked the window of outputs that have no occupied
// child too.
//
// Volume form: window_mask. A warp owns 32 consecutive output cells; each
// lane reads its cell's 27 window cells once into a 27-bit mask, with a
// bit for "a child is occupied". The warp then writes the 32 cells'
// channels as (cell, 16-byte group) items, consecutive lanes on
// consecutive 16 bytes of y, each item taking its cell's mask by a
// shuffle: a cell without an occupied child writes zeros and reads
// nothing, the others read only the occupied inputs' 16-byte groups.
//
// Row form: each valid row sets its cell's bit in an occupancy bitmap (a
// bit a cell, 1.2 MB at bs16) and the row whose atomicOr sets it writes its
// index into an int32 cell -> row volume, which is never cleared (it is
// read only where a bit is set); a cell that two or more valid rows name
// (the scatter route summed them) gets a merge slot: one warp sums the
// cell's rows in row order, rounding to the storage type after each add as
// index_add_ on the CPU does, and counts them (occupancy_pool keeps the
// count). No host sync anywhere; with unique coordinates (every production
// batch) the merge kernel finds no slot and returns.
//
// What held the row form's first pool kernel at 48% / 37% of its bound
// (0.233 / 0.153 ms f32 / bf16 at the serving batch), read from a
// torch.profiler split of it on the card: the pool kernel was 0.20 / 0.12
// ms of that, against 0.10 / 0.05 ms for torch.zero_ of y. Each output
// cell probed all 27 window cells in the index volume (whose 40 MB memset
// took another 0.014 ms); half of the warps hold a cell with an occupied
// child (4.5 such cells on average), and each occupied window cell then
// cost two dependent loads (its index again, then its row) in a loop whose
// trip count differed between the lanes of one instruction, while the
// warp's block held its other warps' registers. Now (pool_rows_kernel) a
// lane reads its window from the bitmap, and the index volume only at the
// occupied window cells of a cell with an occupied child, listing them in
// the warp's slice of shared memory; the warp stores the other cells'
// zeros at once and packs the listed cells' items 32 at a time, each lane
// issuing up to kRowLoads row loads before its max (in bf16 two values at
// a time, __hmax2); blocks of 4 warps; y written with streaming stores.
#include <math.h>

#include "common.cuh"

namespace dpcr {

constexpr uint32_t kMerged = 0x80000000u;  // index volume: merge slot | id
constexpr uint32_t kClaimed = 0xfffffffeu; // a merge slot being taken
constexpr int kChildBit = 27;              // window mask: a child occupied
constexpr int kPoolWarps = 8;

// The 27-cell window {2u-1, 2u, 2u+1}^3 of the output cell whose all-lower
// child (2i, 2j, 2k) is input cell `c0`: bit 9(a+1) + 3(c+1) + (f+1) set
// where input (2i+a, 2j+c, 2k+f) lies in the volume and probe() says it is
// occupied, bit kChildBit where a child (a, c, f >= 0) is.
template <typename Probe>
__device__ __forceinline__ uint32_t window_mask(const Probe& probe, int c0,
                                                int i, int j, int k, int D,
                                                int H, int W) {
  uint32_t m = 0;
#pragma unroll
  for (int a = -1; a <= 1; ++a) {
    const int xi = 2 * i + a;
    if (xi < 0 || xi >= D) continue;
#pragma unroll
    for (int c = -1; c <= 1; ++c) {
      const int yi = 2 * j + c;
      if (yi < 0 || yi >= H) continue;
#pragma unroll
      for (int f = -1; f <= 1; ++f) {
        const int zi = 2 * k + f;
        if (zi < 0 || zi >= W) continue;
        if (probe(c0 + (a * H + c) * W + f)) {
          m |= 1u << (9 * (a + 1) + 3 * (c + 1) + (f + 1));
          if (a >= 0 && c >= 0 && f >= 0) m |= 1u << kChildBit;
        }
      }
    }
  }
  return m;
}

// volume form: occupancy > 0, values at x[cell]
template <typename T>
struct VolumeSource {
  const T* __restrict__ x;
  const T* __restrict__ occ;
  int C;
  __device__ bool operator()(int cell) const {
    return to_float(occ[cell]) > 0.f;
  }
  __device__ const T* values(int cell) const {
    return x + (size_t)cell * C;
  }
  // the values as they are (the plain version reads x itself)
  __device__ static float value(T v) { return to_float(v); }
};

template <typename T, int VEC, typename Source>
__global__ void __launch_bounds__(kPoolWarps * 32)
pool_k3s2_kernel(Source src, T* __restrict__ y, int B, int D, int H, int W,
                 int C, int D1, int H1, int W1) {
  using P = Pack<T, VEC>;
  const int lane = threadIdx.x & 31;
  const int total = B * D1 * H1 * W1;
  const int base = (blockIdx.x * kPoolWarps + (threadIdx.x >> 5)) * 32;
  if (base >= total) return;                      // uniform within the warp
  uint32_t m = 0;
  int c0 = 0;
  const int cell = base + lane;
  if (cell < total) {
    const int k = cell % W1;
    int t = cell / W1;
    const int j = t % H1;
    t /= H1;
    const int i = t % D1;
    const int b = t / D1;
    c0 = ((b * D + 2 * i) * H + 2 * j) * W + 2 * k;
    m = window_mask(src, c0, i, j, k, D, H, W);
  }
  const int groups = C / VEC;
  // the warp's 32 cells x groups items, 32 at a time (the same trip count
  // in every lane: the shuffles take all of them)
  for (int it = lane; it < 32 * groups; it += 32) {
    const int cl = it / groups, g = it - cl * groups;
    const uint32_t mc = __shfl_sync(0xffffffffu, m, cl);
    const int cc = __shfl_sync(0xffffffffu, c0, cl);
    if (base + cl >= total) continue;
    P out;
    if (mc >> kChildBit & 1u) {
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = -INFINITY;
      uint32_t bits = mc & ((1u << kChildBit) - 1u);
      while (bits) {
        const int t = __ffs(bits) - 1;
        bits &= bits - 1;
        const int a = t / 9 - 1, c = t / 3 % 3 - 1, f = t % 3 - 1;
        const P p = *reinterpret_cast<const P*>(
            src.values(cc + (a * H + c) * W + f) + g * VEC);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[e] = fmaxf(acc[e], Source::value(p.v[e]));
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) out.v[e] = from_float<T>(acc[e]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) out.v[e] = from_float<T>(0.f);
    }
    *reinterpret_cast<P*>(y + (size_t)(base + cl) * C + g * VEC) = out;
  }
}

template <typename T, typename Source>
static int launch_pool(const Source& src, void* y, int B, int D, int H, int W,
                       int C, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);  // 16-byte channel groups
  const int D1 = (D + 1) / 2, H1 = (H + 1) / 2, W1 = (W + 1) / 2;
  const long long total = (long long)B * D1 * H1 * W1;
  if (total == 0) return 0;
  const long long blocks = (total + kPoolWarps * 32 - 1) / (kPoolWarps * 32);
  pool_k3s2_kernel<T, VEC, Source><<<(unsigned)blocks, kPoolWarps * 32, 0,
                                     stream>>>(
      src, static_cast<T*>(y), B, D, H, W, C, D1, H1, W1);
  return (int)cudaGetLastError();
}

// ---- row form ----

constexpr int kRowWarps = 4;   // warps of a block of pool_rows_kernel
constexpr int kRowLoads = 8;   // row loads a lane issues before its max
// window bits (as in window_mask) of the 8 children (a, c, f >= 0)
constexpr uint32_t kChildMask =
    (1u << 13) | (1u << 14) | (1u << 16) | (1u << 17) | (1u << 22) |
    (1u << 23) | (1u << 25) | (1u << 26);

// the max of VEC values over a window's rows, each read as 0 + value (the
// scatter route's cell held 0 + row, so -0 reads as +0): max as they are,
// then + 0 once, which changes only a -0 result
template <typename T, int VEC>
struct RowMax {
  float acc[VEC];
  __device__ void init() {
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = -INFINITY;
  }
  __device__ void take(const Pack<T, VEC>& p) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = fmaxf(acc[e], to_float(p.v[e]));
  }
  __device__ Pack<T, VEC> result() const {
    Pack<T, VEC> o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) o.v[e] = from_float<T>(acc[e] + 0.f);
    return o;
  }
};

// bf16: the max of two values at a time in bf16 itself (exact, as a max
// is; __hmax2 ignores a NaN as fmaxf does), half the registers of floats
template <>
struct RowMax<__nv_bfloat16, 8> {
  __nv_bfloat162 acc[4];
  __device__ void init() {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = __float2bfloat162_rn(-INFINITY);
  }
  __device__ void take(const Pack<__nv_bfloat16, 8>& p) {
    const auto* q = reinterpret_cast<const __nv_bfloat162*>(p.v);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = __hmax2(acc[e], q[e]);
  }
  __device__ Pack<__nv_bfloat16, 8> result() const {
    Pack<__nv_bfloat16, 8> o;
    auto* q = reinterpret_cast<__nv_bfloat162*>(o.v);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      q[e] = __hadd2(acc[e], __float2bfloat162_rn(0.f));
    return o;
  }
};

// Row form's pool: a warp of 32 consecutive output cells. Each lane reads
// its cell's window from the occupancy bits (a word of a column holds its
// child pair and, but at the word's first bit, the cell below) and, only
// if a child is occupied, the occupied window cells' indices (a row, or
// kMerged | a merge slot), listed in window order in the warp's column of
// `win`; occ_l is the largest child count. The warp writes zeros for the
// cells without an occupied child, then the other cells' (cell, 16-byte
// group) items, packed 32 at a time, each item's lane reading its cell's
// list from shared memory and issuing up to kRowLoads row loads before it
// takes the max.
template <typename T, int VEC>
__global__ void __launch_bounds__(kRowWarps * 32)
pool_rows_kernel(const uint32_t* __restrict__ idx,
                 const uint32_t* __restrict__ bits, const T* __restrict__ rows,
                 const T* __restrict__ merged,
                 const int* __restrict__ counts, T* __restrict__ y,
                 T* __restrict__ occ_l, int D, int H, int W, int C, int D1,
                 int H1, int W1, int total) {
  using P = Pack<T, VEC>;
  __shared__ uint32_t win[kRowWarps][27][32];
  __shared__ int order[kRowWarps][32];  // lane | list length << 5
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int base = (blockIdx.x * kRowWarps + warp) * 32;
  if (base >= total) return;                      // uniform within the warp
  const int cell = base + lane;
  int n = 0;
  if (cell < total) {
    const int k = cell % W1;
    int t = cell / W1;
    const int j = t % H1;
    t /= H1;
    const int i = t % D1;
    const int b = t / D1;
    const int c0 = ((b * D + 2 * i) * H + 2 * j) * W + 2 * k;
    const int ww = (W + 31) >> 5, zw = (2 * k) >> 5, zb = (2 * k) & 31;
    uint32_t m = 0;           // bit 9(a+1) + 3(c+1) + (f+1): occupied
#pragma unroll
    for (int a = -1; a <= 1; ++a)
#pragma unroll
      for (int c = -1; c <= 1; ++c) {
        const int xi = 2 * i + a, yi = 2 * j + c;
        if (xi < 0 || xi >= D || yi < 0 || yi >= H) continue;
        const uint32_t* col = bits + ((b * D + xi) * H + yi) * ww;
        const uint32_t w0 = col[zw];
        const uint32_t lo = zb ? (w0 >> (zb - 1)) & 1u
                               : (zw ? col[zw - 1] >> 31 : 0u);
        m |= (lo | ((w0 >> zb) & 3u) << 1) << (9 * (a + 1) + 3 * (c + 1));
      }
    int most = 0;
    if (m & kChildMask) {
#pragma unroll
      for (int q = 0; q < 27; ++q) {
        if (!(m >> q & 1u)) continue;
        const int a = q / 9 - 1, c = q / 3 % 3 - 1, f = q % 3 - 1;
        const uint32_t r = idx[c0 + (a * H + c) * W + f];
        win[warp][n++][lane] = r;
        if (a >= 0 && c >= 0 && f >= 0)
          most = max(most, (r & kMerged) ? counts[r & ~kMerged] : 1);
      }
    }
    occ_l[cell] = from_float<T>((float)most);
  }
  const unsigned busy = __ballot_sync(0xffffffffu, n > 0);
  const int groups = C / VEC;
  const int here = min(32, total - base);
  uint4* out = reinterpret_cast<uint4*>(y + (size_t)base * C);
  const uint4 zero = make_uint4(0, 0, 0, 0);
  // this lane's first item (cell cl, group g) and the step of 32 items, so
  // that the item loops divide nothing
  const int cl0 = lane / groups, dq = 32 / groups;
  const int g0 = lane - cl0 * groups, dr = 32 - dq * groups;
  {  // the items of the cells without an occupied child: zeros
    int cl = cl0, g = g0;
    for (int it = lane; it < here * groups; it += 32) {
      if (!(busy >> cl & 1u)) __stcs(out + it, zero);
      g += dr;
      cl += dq;
      if (g >= groups) {
        g -= groups;
        ++cl;
      }
    }
  }
  if (busy == 0u) return;
  if (n > 0) order[warp][__popc(busy & ((1u << lane) - 1u))] = lane | n << 5;
  __syncwarp();
  // the other cells' items, packed: item j * groups + g is group g of the
  // warp's j-th cell with an occupied child
  int j = cl0, g = g0;
  for (int it = lane; it < __popc(busy) * groups; it += 32) {
    const int cl = order[warp][j] & 31, nc = order[warp][j] >> 5;
    RowMax<T, VEC> mx;
    mx.init();
    for (int q0 = 0; q0 < nc; q0 += kRowLoads) {
      P p[kRowLoads];
#pragma unroll
      for (int q = 0; q < kRowLoads; ++q) {
        if (q0 + q >= nc) break;
        const uint32_t r = win[warp][q0 + q][cl];
        const T* src = (r & kMerged) ? merged + (size_t)(r & ~kMerged) * C
                                     : rows + (size_t)r * C;
        p[q] = *reinterpret_cast<const P*>(src + g * VEC);
      }
#pragma unroll
      for (int q = 0; q < kRowLoads; ++q) {
        if (q0 + q >= nc) break;
        mx.take(p[q]);
      }
    }
    store_streaming<T, VEC>(reinterpret_cast<T*>(out + cl * groups + g),
                            mx.result());
    g += dr;
    j += dq;
    if (g >= groups) {
      g -= groups;
      ++j;
    }
  }
}

// the volume cell of valid row r (mask set, coordinates inside), or -1
__device__ __forceinline__ int row_cell(const int32_t* __restrict__ coords,
                                        const uint8_t* __restrict__ mask,
                                        int r, int V, int D, int H, int W) {
  if (!mask[r]) return -1;
  const int x = coords[3 * r], y = coords[3 * r + 1], z = coords[3 * r + 2];
  if (x < 0 || x >= D || y < 0 || y >= H || z < 0 || z >= W) return -1;
  return (((r / V) * D + x) * H + y) * W + z;
}

// each valid row sets its cell's occupancy bit; the row whose atomicOr
// sets it writes its index into the cell (the index volume is never
// cleared: it is read only where a bit is set)
__global__ void mark_rows_kernel(const int32_t* __restrict__ coords,
                                 const uint8_t* __restrict__ mask,
                                 uint32_t* __restrict__ bits,
                                 uint32_t* __restrict__ idx, int n, int V,
                                 int D, int H, int W) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int cell = row_cell(coords, mask, r, V, D, H, W);
  if (cell < 0) return;
  const int z = coords[3 * r + 2];
  const uint32_t bit = 1u << (z & 31);
  if (!(atomicOr(bits + (cell / W) * ((W + 31) >> 5) + (z >> 5), bit) & bit))
    idx[cell] = (uint32_t)r;
}

// a cell that more valid rows name: the first of the rows that did not
// write it to get there takes a merge slot for it and records the row that
// did (any of the cell's rows)
__global__ void claim_duplicates_kernel(const int32_t* __restrict__ coords,
                                        const uint8_t* __restrict__ mask,
                                        uint32_t* __restrict__ idx,
                                        uint32_t* __restrict__ n_slots,
                                        uint32_t* __restrict__ slot_row,
                                        int n, int V, int D, int H, int W) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int cell = row_cell(coords, mask, r, V, D, H, W);
  if (cell < 0) return;
  const uint32_t first = idx[cell];
  if (first == (uint32_t)r || (first & kMerged)) return;
  if (atomicCAS(idx + cell, first, kClaimed) != first) return;
  const uint32_t slot = atomicAdd(n_slots, 1u);
  slot_row[slot] = first;
  atomicExch(idx + cell, kMerged | slot);
}

// one warp a merge slot: the rows of the slot's cell, from its sample's
// first row on, summed in row order (from 0, rounding to T after each
// add) and counted
template <typename T>
__global__ void merge_duplicates_kernel(const int32_t* __restrict__ coords,
                                        const uint8_t* __restrict__ mask,
                                        const T* __restrict__ rows,
                                        const uint32_t* __restrict__ n_slots,
                                        const uint32_t* __restrict__ slot_row,
                                        T* __restrict__ merged,
                                        int* __restrict__ counts, int V,
                                        int D, int H, int W, int C) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x >> 5);
  const int slots = (int)*n_slots;
  for (int s = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
       s < slots; s += warps) {
    const int one = (int)slot_row[s];
    const int cell = row_cell(coords, mask, one, V, D, H, W);
    const int start = one / V * V, end = start + V;  // its sample's rows
    for (int c0 = 0; c0 < C; c0 += 128) {       // 4 channels a lane a pass
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      int count = 0;
      for (int r0 = start; r0 < end; r0 += 32) {
        const int r = r0 + lane;
        const bool same = r < end && row_cell(coords, mask, r, V, D, H,
                                              W) == cell;
        unsigned hit = __ballot_sync(0xffffffffu, same);
        count += __popc(hit);
        while (hit) {
          const int src = r0 + __ffs(hit) - 1;
          hit &= hit - 1;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int ch = c0 + q * 32 + lane;
            if (ch < C)
              acc[q] = to_float(from_float<T>(
                  acc[q] + to_float(rows[(size_t)src * C + ch])));
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ch = c0 + q * 32 + lane;
        if (ch < C) merged[(size_t)s * C + ch] = from_float<T>(acc[q]);
      }
      if (lane == 0) counts[s] = count;
    }
  }
}

template <typename T>
static int launch_rows(const void* coords, const void* mask, const void* rows,
                       void* scratch, void* merged, void* y, void* occ_l,
                       int B, int V, int D, int H, int W, int C, int slots,
                       cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);  // 16-byte channel groups
  const int n = B * V;
  const size_t words = (size_t)B * D * H * ((W + 31) / 32);
  uint32_t* idx = static_cast<uint32_t*>(scratch);
  uint32_t* bits = idx + (size_t)B * D * H * W;
  uint32_t* n_slots = bits + words;
  uint32_t* slot_row = n_slots + 1;
  int* counts = reinterpret_cast<int*>(slot_row + slots);
  // the occupancy bits and the slot count, cleared in one memset
  cudaError_t e = cudaMemsetAsync(bits, 0, (words + 1) * 4, stream);
  if (e != cudaSuccess) return (int)e;
  const auto* cp = static_cast<const int32_t*>(coords);
  const auto* mp = static_cast<const uint8_t*>(mask);
  if (n > 0) {
    const int blocks = (n + 255) / 256;
    mark_rows_kernel<<<blocks, 256, 0, stream>>>(cp, mp, bits, idx, n, V, D,
                                                 H, W);
    claim_duplicates_kernel<<<blocks, 256, 0, stream>>>(
        cp, mp, idx, n_slots, slot_row, n, V, D, H, W);
    merge_duplicates_kernel<T><<<132, 256, 0, stream>>>(
        cp, mp, static_cast<const T*>(rows), n_slots, slot_row,
        static_cast<T*>(merged), counts, V, D, H, W, C);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int D1 = (D + 1) / 2, H1 = (H + 1) / 2, W1 = (W + 1) / 2;
  const int total = B * D1 * H1 * W1;
  if (total == 0) return 0;
  const int blocks = (total + kRowWarps * 32 - 1) / (kRowWarps * 32);
  pool_rows_kernel<T, VEC><<<blocks, kRowWarps * 32, 0, stream>>>(
      idx, bits, static_cast<const T*>(rows), static_cast<const T*>(merged),
      counts, static_cast<T*>(y), static_cast<T*>(occ_l), D, H, W, C, D1, H1,
      W1, total);
  return (int)cudaGetLastError();
}

// the pool's cell indices are 32-bit
static bool fits(long long B, long long D, long long H, long long W) {
  return B * D * H * W < 0x7fffffffLL;
}

}  // namespace dpcr

// x [B,D,H,W,C], occ [B,D,H,W] (>0 = occupied), y [B,ceil(D/2),ceil(H/2),
// ceil(W/2),C]; all contiguous and of one dtype, x and y 16-byte aligned,
// C a whole number of 16-byte groups (4 f32 or 8 bf16 values).
// Returns 0 on success, a CUDA error code, or a negative dpcr::ArgError.
extern "C" int max_pool_k3s2_launch(int dtype, const void* x, const void* occ,
                                    void* y, int B, int D, int H, int W, int C,
                                    void* stream) {
  if (B < 0 || D < 1 || H < 1 || W < 1 || C < 1 || !dpcr::fits(B, D, H, W))
    return dpcr::kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dpcr::kFloat32) {
    if (C % 4) return dpcr::kBadShape;
    const dpcr::VolumeSource<float> src{static_cast<const float*>(x),
                                        static_cast<const float*>(occ), C};
    return dpcr::launch_pool<float>(src, y, B, D, H, W, C, s);
  }
  if (dtype == dpcr::kBFloat16) {
    if (C % 8) return dpcr::kBadShape;
    const dpcr::VolumeSource<__nv_bfloat16> src{
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(occ), C};
    return dpcr::launch_pool<__nv_bfloat16>(src, y, B, D, H, W, C, s);
  }
  return dpcr::kBadDType;
}

// coords [B,V,3] int32, mask [B,V] uint8, rows [B,V,C] -> y [B,ceil(D/2),
// ceil(H/2),ceil(W/2),C] and occ_l [B,ceil(D/2),ceil(H/2),ceil(W/2)] of the
// rows' dtype; scratch int32 [B*D*H*W + B*D*H*ceil(W/32) + 1 + 2*slots]
// (the index volume, the occupancy bits, the slot count, each slot's row
// and its count), merged [slots, C] of the rows' dtype, slots >= (B*V)/2
// (a slot sums two rows or more). rows, merged and y 16-byte aligned, C a
// whole number of 16-byte groups.
// Returns 0 on success, a CUDA error code, or a negative dpcr::ArgError.
extern "C" int max_pool_k3s2_rows_launch(int dtype, const void* coords,
                                         const void* mask, const void* rows,
                                         void* scratch, void* merged, void* y,
                                         void* occ_l, int B, int V, int D,
                                         int H, int W, int C, int slots,
                                         void* stream) {
  if (B < 0 || V < 0 || D < 1 || H < 1 || W < 1 || C < 1 ||
      !dpcr::fits(B, D, H, W) || (long long)B * V >= 0x40000000LL ||
      2LL * slots < (long long)B * V)
    return dpcr::kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dpcr::kFloat32) {
    if (C % 4) return dpcr::kBadShape;
    return dpcr::launch_rows<float>(coords, mask, rows, scratch, merged, y,
                                    occ_l, B, V, D, H, W, C, slots, s);
  }
  if (dtype == dpcr::kBFloat16) {
    if (C % 8) return dpcr::kBadShape;
    return dpcr::launch_rows<__nv_bfloat16>(coords, mask, rows, scratch,
                                            merged, y, occ_l, B, V, D, H, W,
                                            C, slots, s);
  }
  return dpcr::kBadDType;
}
