// stem_sites: the k=7 stem convolution evaluated only at occupied voxel sites.
//
// Replaces: the Pallas stem kernels of dpcr_agb_tpu/ops/pallas_stem.py
// (_fwd_kernel_x1, _fwd_kernel_xtile, _fwd_kernel_rev, _dma_kernel, all
// reached through fused_stem_conv_volume), which compute the same conv over
// the whole volume from a z+y-folded table, read at the sites by the caller.
// Here the output is the rows themselves:
//   y[b,v,:] = sum_{o in 7^3} vol[b, c_v + o - 3, :] @ W[o]     (+ bias)
// with out-of-volume neighbours reading 0, rows past the volume read at the
// clipped site, and masked rows written as 0.
//
// What bounds it on an H100: the products the data needs, and the shared
// memory that feeds them. The level-0 volume is ~2% occupied, so a site's
// 7^3 neighbourhood holds ~56 occupied cells (169 non-zero values of 1029
// at Cin 3 on the synthetic NFI batch), and each value meets a 64-wide row
// of W: 2*169*64 flops a site, 0.058 ms at bs16 on the f32 cores. Served
// from shared memory, those W rows are ~43 KB a site (7.7 GB at bs16 in
// f32, ~0.26 ms at the SMs' 128 bytes a cycle; half that in bf16), and the
// neighbours' values and taps have to reach every lane that multiplies.
//
// What held the first version back (1.42 / 1.50 ms f32 / bf16 at bs16): a
// warp per site walked all 1029 neighbour values 32 at a time, each pass a
// gather, three divisions a lane, a ballot and a serial loop over the
// non-zeros that read its W row from L1/L2, so a warp had about one load
// in flight, loaded ~84% zeros, and read 7.7 GB of W through L1/L2.
//
// Design:
// - occupancy_bits_kernel packs "a cell holds a non-zero value" along z,
//   one 32-bit word per 32 cells (1.5 MB at bs16), built once per call.
// - The stem kernel keeps its share of W in shared memory, 32 words a
//   (tap, input channel): f32 W (263 KB at Cin 3) does not fit a block, so
//   f32 runs two sets of blocks (blockIdx.y), each owning 32 of the 64
//   output channels; bf16 W (132 KB) fits whole, two channels a word.
// - Persistent blocks (one an SM), each warp on 4 consecutive sites at a
//   time, a quarter (8 lanes) a site, lane j covering W's words 4j .. 4j+3
//   (16-byte loads: a quarter reads one 128-byte W row a cycle; a lane
//   sums 4 f32 or 8 bf16 channels). The next sites' bits and the ones
//   after's coordinates are loaded while these are computed.
// - Lane j of a quarter holds the 7 z-bits of columns j, j + 8, ... of the
//   site's 49 (x, y) columns (one or two word loads each); scans within
//   the quarter list the occupied taps in tap order in shared memory. Then
//   32 neighbours at a time: each lane gathers 4 cells' Cin values (all
//   loads issued first) and stages (W offset, values) in 16 bytes of
//   shared memory each, and the quarter walks them in order, one staged
//   read and Cin W-row reads a neighbour. Empty cells cost one bit; masked
//   rows cost nothing.
// - Wider inputs (5 <= Cin <= 18: a plot's own columns and added features
//   on top of the presets' three) do not leave W's share room in shared
//   memory (220 KB at Cin 5). They run the kernel once per group of at
//   most 4 input channels (kWide): each launch stages its group's W, reads
//   its channels at their offset in the cell, and starts from and adds to
//   an f32 partial [B*V, 64] that the previous group left (the first
//   starts at 0, the last rounds and adds the bias as above). A site's sum
//   runs group by group, each in tap order with its channels inner: the
//   same bits from call to call. Cin 1..4 keep their one launch.
// - Each site is summed by one quarter in tap order, input channel inner,
//   as a plain matmul of the patches sums them: the same bits from call to
//   call (and, on the main path's batches, the plain version's bits). The
//   stem kernel alone at bs16 in f32 on an H100: 0.58 ms; 0.52 with one
//   site's neighbours split over the quarters, whose other sum order moved
//   the f32 train step past chip_smoke.STEP_TOL through near-ties in the
//   pool; 0.64 with a lane a W word and every lane reading every
//   neighbour. The bias is added after rounding to the output type, as the
//   reference casts the f32 product and adds the bias afterwards.
#include "common.cuh"

namespace dpcr {

constexpr int kK = 7;              // kernel size
constexpr int kR = kK / 2;         // radius
constexpr int kTaps = kK * kK * kK;
constexpr int kCols = kK * kK;     // (x, y) columns of a neighbourhood
constexpr int kCout = 64;          // output channels
constexpr int kMaxCin = 4;          // one launch (W whole in shared memory)
constexpr int kMaxCinWide = 18;     // a launch per group of <= kMaxCin
constexpr int kListCap = 344;      // a quarter's tap list (343, even)
constexpr int kStage = 32;         // neighbours a quarter stages at a time
constexpr int kMaxWarps = 20;      // a block's warps (registers: 102 each)
constexpr int kMaxWideWarps = 8;   // a group launch's (Cin 4's shared memory)

constexpr int kBitWords = 4;       // occupancy words a warp

// bits[(b*D + x)*H + y][w] bit t: cell (b, x, y, 32w + t) holds a non-zero
// value; a warp kBitWords words, their loads issued together (CIN 0: the
// cells' cin channels, a runtime count)
template <typename T, int CIN>
__global__ void occupancy_bits_kernel(const T* __restrict__ vol,
                                      uint32_t* __restrict__ bits,
                                      long long n_words, int W, int nw,
                                      int cin) {
  const int cs = CIN > 0 ? CIN : cin;
  const long long first =
      ((long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) *
      kBitWords;
  if (first >= n_words) return;                   // uniform within the warp
  const int lane = threadIdx.x & 31;
  bool nz[kBitWords];
#pragma unroll
  for (int q = 0; q < kBitWords; ++q) {
    const long long word = first + q;
    const long long column = word / nw;
    const int z = (int)(word - column * nw) * 32 + lane;
    nz[q] = false;
    if (word < n_words && z < W) {
      const T* p = vol + ((size_t)column * W + z) * cs;
#pragma unroll
      for (int ci = 0; ci < cs; ++ci) nz[q] = nz[q] || to_float(p[ci]) != 0.f;
    }
  }
#pragma unroll
  for (int q = 0; q < kBitWords; ++q) {
    const uint32_t m = __ballot_sync(0xffffffffu, nz[q]);
    if (lane == 0 && first + q < n_words) bits[first + q] = m;
  }
}

// the occupancy of cells z0 .. z0+6 of one column (bit dz: cell z0 + dz;
// cells outside the volume read 0; the words hold no bit at or past W)
__device__ __forceinline__ uint32_t run_bits(const uint32_t* __restrict__ w,
                                             int z0, int nw) {
  if (z0 < 0) return (w[0] << -z0) & 0x7fu;
  const int wi = z0 >> 5, sh = z0 & 31;
  uint64_t v = w[wi];
  if (sh > 32 - kK && wi + 1 < nw) v |= (uint64_t)w[wi + 1] << 32;
  return (uint32_t)(v >> sh) & 0x7fu;
}

// a site's mask and clipped coordinates (rows past the volume read at the
// clipped site, like the reference); nothing past the last site
struct Head {
  bool live;
  int b, cx, cy, cz;
};

__device__ __forceinline__ Head load_head(const int32_t* __restrict__ coords,
                                          const uint8_t* __restrict__ mask,
                                          long long site, long long nsites,
                                          int V, int D, int H, int W) {
  Head h{false, 0, 0, 0, 0};
  if (site < nsites) {
    h.live = mask[site] != 0;
    h.b = (int)(site / V);
    h.cx = min(max(coords[site * 3 + 0], 0), D - 1);
    h.cy = min(max(coords[site * 3 + 1], 0), H - 1);
    h.cz = min(max(coords[site * 3 + 2], 0), W - 1);
  }
  return h;
}

constexpr int kRuns = (kCols + 7) / 8;  // columns a lane of a quarter holds

// the z-runs of the site's columns j, j + 8, ... (column = 7 dx + dy)
__device__ __forceinline__ void load_runs(const uint32_t* __restrict__ bits,
                                          const Head& h, int j, int D, int H,
                                          int nw, uint32_t run[kRuns]) {
#pragma unroll
  for (int r = 0; r < kRuns; ++r) {
    const int col = j + 8 * r;
    const int x = h.cx + col / kK - kR, y = h.cy + col % kK - kR;
    run[r] = 0u;
    if (h.live && col < kCols && x >= 0 && x < D && y >= 0 && y < H)
      run[r] = run_bits(bits + (((size_t)h.b * D + x) * H + y) * nw,
                        h.cz - kR, nw);
  }
}

// one staged neighbour: the word offset of its tap's W rows in shared
// memory and its Cin values (16 bytes up to Cin 3, 32 at Cin 4)
template <int CIN>
struct Staged {
  static constexpr int kQuads = CIN <= 3 ? 1 : 2;
  float4 q[kQuads];
};

// CIN: the channels this launch sums; kWide: one group of a wider input,
// whose cells hold cstride channels (this group's from c0 on), starting
// from partial_in (null: from 0) and ending in partial_out (null: in out);
// the two may be one buffer (each site's lane reads its row, then writes it)
template <typename T, int CIN, bool kWide>
__global__ void __launch_bounds__((kWide ? kMaxWideWarps : kMaxWarps) * 32,
                                  1)
stem_sites_kernel(const T* __restrict__ vol, const uint32_t* __restrict__ bits,
                  const int32_t* __restrict__ coords,
                  const uint8_t* __restrict__ mask,
                  const T* __restrict__ weights, const T* __restrict__ bias,
                  T* __restrict__ out, int B, int D, int H, int W, int V,
                  int nw, int cstride, int c0,
                  const float* partial_in, float* partial_out) {
  const int cs = kWide ? cstride : CIN;
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kVals = 4 * Staged<CIN>::kQuads - 1;
  extern __shared__ float4 smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // a quarter of the warp a site; its lane j covers W words 4j .. 4j+3
  // (f32: channels 32 part + 4j .., bf16: channels 8j ..)
  const int quarter = lane >> 3, j = lane & 7;
  const int part = blockIdx.y;
  constexpr int kAcc = kF32 ? 4 : 8;
  uint32_t* ws = reinterpret_cast<uint32_t*>(smem);   // [343*CIN][32]
  Staged<CIN>* stage = reinterpret_cast<Staged<CIN>*>(ws + kTaps * CIN * 32)
                       + (warp * 4 + quarter) * kStage;
  uint16_t* list = reinterpret_cast<uint16_t*>(
      reinterpret_cast<Staged<CIN>*>(ws + kTaps * CIN * 32)
      + warps * 4 * kStage) + (warp * 4 + quarter) * kListCap;

  for (int i = threadIdx.x; i < kTaps * CIN * 32; i += blockDim.x) {
    const int l = i & 31;
    // W's row of (tap, channel c0 + ci) for shared row tap * CIN + ci
    const int row = kWide ? (i >> 5) / CIN * cs + c0 + (i >> 5) % CIN
                          : i >> 5;
    if constexpr (kF32) {
      ws[i] = __float_as_uint(
          to_float(weights[(size_t)row * kCout + part * 32 + l]));
    } else {
      const __nv_bfloat16 lo = weights[(size_t)row * kCout + 2 * l];
      const __nv_bfloat16 hi = weights[(size_t)row * kCout + 2 * l + 1];
      ws[i] = (uint32_t)__bfloat16_as_ushort(lo)
              | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
    }
  }
  __syncthreads();

  // the warp takes 4 consecutive sites at a time, a quarter each, a step
  // apart; the next sites' bit runs and the ones after's masks and
  // coordinates are loaded while these are computed
  const long long nsites = (long long)B * V;
  const long long step = (long long)gridDim.x * warps * 4;
  long long first = ((long long)blockIdx.x * warps + warp) * 4;
  Head cur = load_head(coords, mask, first + quarter, nsites, V, D, H, W);
  Head nxt = load_head(coords, mask, first + step + quarter, nsites, V, D,
                       H, W);
  uint32_t run[kRuns];
  load_runs(bits, cur, j, D, H, nw, run);
  for (; first < nsites; first += step) {
    const long long site = first + quarter;
    const Head far = load_head(coords, mask, site + 2 * step, nsites, V, D,
                               H, W);
    uint32_t run_next[kRuns];
    load_runs(bits, nxt, j, D, H, nw, run_next);

    // the site's occupied taps, listed in tap order: column by column
    // (round r holds columns 8r .. 8r+7, lane j column 8r + j), dz inner
    int n = 0;
#pragma unroll
    for (int r = 0; r < kRuns; ++r) {
      const int c = __popc(run[r]);
      int p = c;
#pragma unroll
      for (int d = 1; d < 8; d <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, p, d, 8);
        if (j >= d) p += t;
      }
      int pos = n + p - c;
      for (uint32_t m = run[r]; m; m &= m - 1)
        list[pos++] = (uint16_t)((j + 8 * r) * kK + __ffs(m) - 1);
      n += __shfl_sync(0xffffffffu, p, 7, 8);
    }
    int most = n;                                  // the warp's longest list
    most = max(most, __shfl_xor_sync(0xffffffffu, most, 8));
    most = max(most, __shfl_xor_sync(0xffffffffu, most, 16));
    __syncwarp();

    // a lane's output channels
    const int o = kF32 ? part * 32 + 4 * j : 8 * j;
    float acc[kAcc];
#pragma unroll
    for (int q = 0; q < kAcc; ++q) acc[q] = 0.f;
    if (kWide && partial_in != nullptr && site < nsites) {
      const float4* pi =
          reinterpret_cast<const float4*>(partial_in + site * kCout + o);
#pragma unroll
      for (int q = 0; q < kAcc / 4; ++q) {
        const float4 a = pi[q];
        acc[4 * q] = a.x;
        acc[4 * q + 1] = a.y;
        acc[4 * q + 2] = a.z;
        acc[4 * q + 3] = a.w;
      }
    }
    const T* vb = vol + (size_t)cur.b * D * H * W * cs + (kWide ? c0 : 0);
    for (int s = 0; s < most; s += kStage) {
      // the quarter gathers kStage of its neighbours, all loads first
      constexpr int kPer = kStage / 8;
      int tap[kPer];
      float v[kPer][kVals];
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int i = s + j + 8 * e;
        tap[e] = i < n ? list[i] : -1;
        const int col = tap[e] / kK, dz = tap[e] - col * kK;
        const int x = cur.cx + col / kK - kR, y = cur.cy + col % kK - kR;
        const T* p =
            vb + (((size_t)x * H + y) * W + cur.cz + dz - kR) * cs;
#pragma unroll
        for (int ci = 0; ci < kVals; ++ci)
          v[e][ci] = ci < CIN && tap[e] >= 0 ? to_float(p[ci]) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        if (tap[e] < 0) continue;
        Staged<CIN> st;
        st.q[0] = make_float4(__int_as_float(tap[e] * CIN * 32), v[e][0],
                              v[e][1], v[e][2]);
        if constexpr (Staged<CIN>::kQuads == 2)
          st.q[1] = make_float4(v[e][3], v[e][4], v[e][5], v[e][6]);
        stage[j + 8 * e] = st;
      }
      __syncwarp();
      // the site's sum in tap order, input channel inner
      const int m = min(kStage, n - s);
#pragma unroll 2
      for (int k = 0; k < m; ++k) {
        const float4 q0 = stage[k].q[0];
        const uint4* wr =
            reinterpret_cast<const uint4*>(ws + __float_as_int(q0.x)) + j;
        float val[4] = {q0.y, q0.z, q0.w, 0.f};
        if constexpr (Staged<CIN>::kQuads == 2) val[3] = stage[k].q[1].x;
#pragma unroll
        for (int ci = 0; ci < CIN; ++ci) {
          const uint4 w4 = wr[ci * 8];
          const uint32_t wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if constexpr (kF32) {
              acc[e] = fmaf(val[ci], __uint_as_float(wv[e]), acc[e]);
            } else {
              acc[2 * e] = fmaf(val[ci], __uint_as_float(wv[e] << 16),
                                acc[2 * e]);
              acc[2 * e + 1] = fmaf(
                  val[ci], __uint_as_float(wv[e] & 0xffff0000u),
                  acc[2 * e + 1]);
            }
          }
        }
      }
      __syncwarp();
    }

    if (kWide && partial_out != nullptr && site < nsites) {
      float4* po = reinterpret_cast<float4*>(partial_out + site * kCout + o);
#pragma unroll
      for (int q = 0; q < kAcc / 4; ++q)
        po[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                            acc[4 * q + 3]);
    } else if (site < nsites) {
      // round to the output type first, then add the bias in that type
      uint32_t y[kAcc];
#pragma unroll
      for (int q = 0; q < kAcc; ++q) {
        float yv = to_float(from_float<T>(acc[q]));
        if (cur.live && bias != nullptr) yv += to_float(bias[o + q]);
        if constexpr (kF32)
          y[q] = __float_as_uint(yv);
        else
          y[q] = __bfloat16_as_ushort(from_float<T>(yv));
      }
      // 16 bytes a lane, a quarter's 8 lanes on 128 consecutive bytes
      uint4 packed;
      if constexpr (kF32)
        packed = make_uint4(y[0], y[1], y[2], y[3]);
      else
        packed = make_uint4(y[0] | y[1] << 16, y[2] | y[3] << 16,
                            y[4] | y[5] << 16, y[6] | y[7] << 16);
      *reinterpret_cast<uint4*>(out + site * kCout + o) = packed;
    }
    cur = nxt;
    nxt = far;
#pragma unroll
    for (int r = 0; r < kRuns; ++r) run[r] = run_next[r];
  }
}

// shared memory of a block: W's share, then each warp's staged neighbours
// and tap list (kernels.stem_sites_plan computes the same)
template <int CIN>
static size_t smem_bytes(int warps) {
  return (size_t)kTaps * CIN * 32 * 4 +
         (size_t)warps * 4 * (kStage * sizeof(Staged<CIN>) + kListCap * 2);
}

// the occupancy bits of the cells' cin channels (CIN 0: a runtime count)
template <typename T, int CIN>
static int launch_bits(const void* vol, void* bits, int B, int D, int H,
                       int W, int cin, cudaStream_t stream) {
  const int nw = (W + 31) / 32;
  const long long n_words = (long long)B * D * H * nw;
  if (n_words > 0) {
    const long long wb = (n_words + 8 * kBitWords - 1) / (8 * kBitWords);
    if (wb > 0x7fffffffLL) return kBadShape;
    occupancy_bits_kernel<T, CIN><<<(unsigned)wb, 256, 0, stream>>>(
        static_cast<const T*>(vol), static_cast<uint32_t*>(bits), n_words, W,
        nw, cin);
  }
  return 0;
}

// one launch of the stem kernel (a group of a wide input when kWide)
template <typename T, int CIN, bool kWide>
static int launch_sites(const void* vol, const void* bits, const void* coords,
                        const void* mask, const void* weights,
                        const void* bias, void* out, int B, int D, int H,
                        int W, int V, int warps, int blocks, int cstride,
                        int c0, const float* partial_in, float* partial_out,
                        cudaStream_t stream) {
  const size_t smem = smem_bytes<CIN>(warps);
  cudaError_t e = cudaFuncSetAttribute(
      stem_sites_kernel<T, CIN, kWide>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(blocks, sizeof(T) == 4 ? 2 : 1);
  stem_sites_kernel<T, CIN, kWide><<<grid, warps * 32, smem, stream>>>(
      static_cast<const T*>(vol), static_cast<const uint32_t*>(bits),
      static_cast<const int32_t*>(coords), static_cast<const uint8_t*>(mask),
      static_cast<const T*>(weights), static_cast<const T*>(bias),
      static_cast<T*>(out), B, D, H, W, V, (W + 31) / 32, cstride, c0,
      partial_in, partial_out);
  return (int)cudaGetLastError();
}

template <typename T, int CIN>
static int launch(const void* vol, void* bits, const void* coords,
                  const void* mask, const void* weights, const void* bias,
                  void* out, int B, int D, int H, int W, int V, int warps,
                  int blocks, cudaStream_t stream) {
  const int rc = launch_bits<T, CIN>(vol, bits, B, D, H, W, CIN, stream);
  if (rc != 0) return rc;
  if ((long long)B * V == 0) return (int)cudaGetLastError();
  return launch_sites<T, CIN, false>(vol, bits, coords, mask, weights, bias,
                                     out, B, D, H, W, V, warps, blocks, CIN,
                                     0, nullptr, nullptr, stream);
}

// Cin 5..18: the bits of all channels once, then a launch per group of 4
// input channels (the last holds the rest), each adding to the f32 partial
template <typename T>
static int launch_wide(int cin, const void* vol, void* bits, float* partial,
                       const void* coords, const void* mask,
                       const void* weights, const void* bias, void* out,
                       int B, int D, int H, int W, int V, int warps,
                       int blocks, cudaStream_t s) {
  if (warps > kMaxWideWarps || partial == nullptr) return kBadShape;
  int rc = launch_bits<T, 0>(vol, bits, B, D, H, W, cin, s);
  if (rc != 0) return rc;
  if ((long long)B * V == 0) return (int)cudaGetLastError();
  for (int c0 = 0; c0 < cin && rc == 0; c0 += kMaxCin) {
    const int g = min(kMaxCin, cin - c0);
    const float* in = c0 == 0 ? nullptr : partial;
    float* po = c0 + g < cin ? partial : nullptr;
    switch (g) {
      case 1: rc = launch_sites<T, 1, true>(vol, bits, coords, mask, weights,
                                            bias, out, B, D, H, W, V, warps,
                                            blocks, cin, c0, in, po, s);
              break;
      case 2: rc = launch_sites<T, 2, true>(vol, bits, coords, mask, weights,
                                            bias, out, B, D, H, W, V, warps,
                                            blocks, cin, c0, in, po, s);
              break;
      case 3: rc = launch_sites<T, 3, true>(vol, bits, coords, mask, weights,
                                            bias, out, B, D, H, W, V, warps,
                                            blocks, cin, c0, in, po, s);
              break;
      default: rc = launch_sites<T, 4, true>(vol, bits, coords, mask,
                                             weights, bias, out, B, D, H, W,
                                             V, warps, blocks, cin, c0, in,
                                             po, s);
    }
  }
  return rc;
}

template <typename T>
static int launch_cin(int cin, const void* vol, void* bits, float* partial,
                      const void* coords, const void* mask,
                      const void* weights, const void* bias, void* out, int B,
                      int D, int H, int W, int V, int warps, int blocks,
                      cudaStream_t s) {
  switch (cin) {
    case 1: return launch<T, 1>(vol, bits, coords, mask, weights, bias, out,
                                B, D, H, W, V, warps, blocks, s);
    case 2: return launch<T, 2>(vol, bits, coords, mask, weights, bias, out,
                                B, D, H, W, V, warps, blocks, s);
    case 3: return launch<T, 3>(vol, bits, coords, mask, weights, bias, out,
                                B, D, H, W, V, warps, blocks, s);
    case 4: return launch<T, 4>(vol, bits, coords, mask, weights, bias, out,
                                B, D, H, W, V, warps, blocks, s);
  }
  return launch_wide<T>(cin, vol, bits, partial, coords, mask, weights, bias,
                        out, B, D, H, W, V, warps, blocks, s);
}

}  // namespace dpcr

// vol [B,D,H,W,cin], coords [B,V,3] int32, mask [B,V] uint8,
// weights [343,cin,64], bias [64] or null, out [B,V,64]; all contiguous,
// vol/weights/bias/out of one dtype; 1 <= cin <= 18; bits int32 scratch
// [B*D*H*ceil(W/32)]; partial f32 scratch [B*V,64] for cin > 4 (else
// null); `warps` a block and `blocks` blocks a channel part
// (kernels.stem_sites_plan; f32 runs 2 parts of 32 output channels).
// Returns 0 on success, a CUDA error code, or a negative dpcr::ArgError.
extern "C" int stem_sites_launch(int dtype, const void* vol, void* bits,
                                 void* partial,
                                 const void* coords, const void* mask,
                                 const void* weights, const void* bias,
                                 void* out, int B, int D, int H, int W, int V,
                                 int cin, int cout, int warps, int blocks,
                                 void* stream) {
  if (cin < 1 || cin > dpcr::kMaxCinWide || cout != dpcr::kCout || D < 1 ||
      H < 1 || W < 1 || V < 0 || B < 0 || warps < 1 ||
      warps > dpcr::kMaxWarps ||
      blocks < 1 || blocks > 65535)
    return dpcr::kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dpcr::kFloat32)
    return dpcr::launch_cin<float>(cin, vol, bits,
                                   static_cast<float*>(partial), coords, mask,
                                   weights, bias, out, B, D, H, W, V, warps,
                                   blocks, s);
  if (dtype == dpcr::kBFloat16)
    return dpcr::launch_cin<__nv_bfloat16>(
        cin, vol, bits, static_cast<float*>(partial), coords, mask, weights,
        bias, out, B, D, H, W, V, warps, blocks, s);
  return dpcr::kBadDType;
}
