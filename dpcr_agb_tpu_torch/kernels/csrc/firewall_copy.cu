// firewall_copy: the layout firewall's copy, a tensor of up to five
// dimensions with any strides written out contiguous in its logical order.
//
// Replaces: the Pallas identity copy _copy_kernel of
// dpcr_agb_tpu/ops/dense_stem.py (called through _pl_copy by
// layout_firewall, forward and on the cotangent). There the custom call
// stops the compiler from carrying the folded stem's layout into the
// neighbouring whole-volume ops. Here it stops whatever memory format the
// producer chose (a convolution may hand back NCDHW or channels-last
// strides behind an NDHWC view): the consumer gets a fresh buffer,
// contiguous in the logical order, with equal values. The TPU kernel's
// lane merging, sublane padding and block growth answer that compiler's
// tiling and have no counterpart here.
//
// What bounds it on an H100: bytes, one read and one write of the tensor
// (3.30 GB each way for the f32 stem output [16,88,88,104,64], 1.97 ms at
// 3.35 TB/s). The first version (one 16-byte word a thread and iteration
// on a capped grid, a separate tail kernel, one thread per element with
// five 64-bit divisions for any other layout) ran 8% behind
// `Tensor.clone` on a contiguous source and 43% behind it on a permuted
// one.
//
// Design. The entry point first merges logical axes that are contiguous
// with each other in the source (the output is contiguous in every axis),
// so an NCDHW buffer behind an NDHWC view becomes [B, D*H*W, C] with
// strides [C*DHW, 1, DHW]. Then one of three kernels, one launch:
//   contiguous, 16-byte aligned: a block per 32 KB; each thread issues its
//     eight 16-byte streaming loads (__ldcs: nothing reads the data again)
//     before its eight streaming stores (__stcs), with 32-bit offsets
//     inside the block; the last block also copies the elements after the
//     last whole 16-byte word. A grid sized to the card (8 blocks an SM
//     walking the chunks) and Hopper's bulk copies (cp.async.bulk through
//     a ring of shared buffers) both measured slower on the H100 than a
//     block per chunk;
//   permuted (the source's unit-stride axis is not the last one): a tiled
//     transpose through shared memory, 4096 elements a tile (1024 positions
//     x 4 channels for C up to 4, down to 64 x 64 for C from 33), 16 loads
//     in flight a thread, reads along the source's unit-stride axis, writes
//     along the output's channels;
//   anything else: one thread per output element through the strides, so
//     the writes stay coalesced whatever the reads are.
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): contiguous, the
// device time within 1% of `clone`'s and 1.11x the bound at the stem
// output (2.20 ms f32); the transpose ahead of `clone` at the stem output
// (PERF.md, section 6).
#include <algorithm>

#include "common.cuh"

namespace dpcr {

constexpr int kMaxDims = 5;
constexpr int kThreads = 256;
constexpr int kUnroll = 8;                    // 16-byte words a thread
constexpr int kChunk = kThreads * kUnroll;    // words of a block (32 KB)

struct Strided {
  long long size[kMaxDims];    // logical sizes, leading ones padded with 1
  long long stride[kMaxDims];  // source strides in elements
};

// block b copies the 16-byte words [b * kChunk, (b + 1) * kChunk): each
// thread's kUnroll loads, then its stores; the last block also copies the
// elements after the last whole word
template <typename E>
__global__ void __launch_bounds__(kThreads)
firewall_copy_vec_kernel(const uint4* __restrict__ src,
                         uint4* __restrict__ dst, long long n_vec,
                         const E* __restrict__ src_e, E* __restrict__ dst_e,
                         long long n) {
  const long long base = (long long)blockIdx.x * kChunk;
  const int left = (int)min((long long)kChunk, n_vec - base);
  const uint4* s = src + base;
  uint4* d = dst + base;
  uint4 v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = u * kThreads + threadIdx.x;
    if (i < left) v[u] = __ldcs(s + i);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = u * kThreads + threadIdx.x;
    if (i < left) __stcs(d + i, v[u]);
  }
  constexpr int per = 16 / sizeof(E);
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x < n - n_vec * per)
    dst_e[n_vec * per + threadIdx.x] = src_e[n_vec * per + threadIdx.x];
}

// Batched transpose: axis `a` of the source has stride 1, the last axis (C)
// does not. The other axes (up to three: sizes os, source strides ostr,
// output strides ostro) index `batch` transposes.
struct Transpose {
  long long na, nc, sc;          // size of a, size and source stride of C
  long long out_sa;              // output stride of a
  long long os[3], ostr[3], ostro[3];
  long long batch;               // product of os
  int n_other;
};

// the source and output offsets of transpose z
__device__ __forceinline__ void batch_base(const Transpose& t, unsigned z,
                                           long long& sbase,
                                           long long& obase) {
  sbase = obase = 0;
#pragma unroll
  for (int j = 2; j >= 0; --j) {   // static indices: t stays in registers
    if (j >= t.n_other) continue;
    const unsigned n = (unsigned)t.os[j];
    const unsigned q = z / n, i = z - q * n;
    sbase += i * t.ostr[j];
    obase += i * t.ostro[j];
    z = q;
  }
}

// Block (transpose z, TA positions of a, TC = kTile / TA channels), with
// blockIdx.x = z * a_tiles + the a tile: each thread's kTile / kThreads
// loads (warps read runs of consecutive positions of one channel), then the
// tile through shared memory (rows padded by one word: the column reads of
// a warp hit 32 banks), then its stores (warps write runs of consecutive
// channels of one position). TA is picked so that TC covers C up to 64
// channels. No loop around the tile: the offsets of its 16 loads and
// stores would be kept in registers across iterations.
constexpr int kTile = 4096;   // elements of a tile

template <typename E, int LOG_TA>
__global__ void __launch_bounds__(kThreads)
firewall_copy_transpose_kernel(const E* __restrict__ src, E* __restrict__ dst,
                               Transpose t, unsigned a_tiles) {
  constexpr int TA = 1 << LOG_TA, TC = kTile / TA, TS = TA + 1;
  constexpr int R = kTile / kThreads;
  __shared__ uint32_t tile[TC * TS];
  const unsigned z = blockIdx.x / a_tiles;
  const long long a0 = (long long)(blockIdx.x - z * a_tiles) * TA;
  const long long c0 = (long long)blockIdx.y * TC;
  const int na = (int)min((long long)TA, t.na - a0);
  const int nc = (int)min((long long)TC, t.nc - c0);
  long long sbase, obase;
  batch_base(t, z, sbase, obase);
  const E* s = src + sbase + a0 + c0 * t.sc;
  uint32_t v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int l = threadIdx.x + r * kThreads;
    const int c = l >> LOG_TA, a = l & (TA - 1);
    if (c < nc && a < na) v[r] = (uint32_t)s[c * t.sc + a];
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int l = threadIdx.x + r * kThreads;
    const int c = l >> LOG_TA, a = l & (TA - 1);
    if (c < nc && a < na) tile[c * TS + a] = v[r];
  }
  __syncthreads();
  E* d = dst + obase + a0 * t.out_sa + c0;
  const float inv_nc = 1.f / nc;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = threadIdx.x + r * kThreads;
    // e = a * nc + c; the float quotient is exact to well under 1/(2 nc)
    const int a = (int)((e + 0.5f) * inv_nc);
    const int c = e - a * nc;
    if (e < na * nc) d[a * t.out_sa + c] = (E)tile[c * TS + a];
  }
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
firewall_copy_strided_kernel(const E* __restrict__ src, E* __restrict__ dst,
                             Strided s, long long n) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    unsigned long long t = (unsigned long long)i;
    long long off = 0;
#pragma unroll
    for (int a = kMaxDims - 1; a > 0; --a) {
      const unsigned long long sz = (unsigned long long)s.size[a];
      const unsigned long long q = t / sz;
      off += (long long)(t - q * sz) * s.stride[a];
      t = q;
    }
    off += (long long)t * s.stride[0];
    dst[i] = src[off];
  }
}

// resident blocks of kThreads threads on the card: its SMs x 8
static unsigned card_blocks() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms < 1)
      sms = 132;
  }
  return (unsigned)sms * (2048 / kThreads);
}

static unsigned grid_for(long long items) {
  const long long cap = card_blocks();
  return (unsigned)(items < cap ? (items < 1 ? 1 : items) : cap);
}

template <typename E>
static int launch(const void* src, void* dst, const Strided& s, int nd,
                  long long n, cudaStream_t stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(src) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(dst) % 16 == 0);
  // after merging: nd axes, the last of which is s.size[kMaxDims - 1]
  const int last = kMaxDims - 1;
  if (nd == 1 && s.stride[last] == 1 && aligned) {
    constexpr long long per = 16 / sizeof(E);
    const long long n_vec = n / per;
    const long long blocks = (n_vec + kChunk - 1) / kChunk;
    firewall_copy_vec_kernel<E><<<(unsigned)(blocks > 0 ? blocks : 1),
                                  kThreads, 0, stream>>>(
        static_cast<const uint4*>(src), static_cast<uint4*>(dst), n_vec,
        static_cast<const E*>(src), static_cast<E*>(dst), n);
    return (int)cudaGetLastError();
  }
  int unit = -1;
  for (int a = kMaxDims - nd; a < last; ++a)
    if (s.stride[a] == 1) unit = a;
  if (nd > 1 && s.stride[last] != 1 && unit >= 0) {
    Transpose t{};
    t.na = s.size[unit];
    t.nc = s.size[last];
    t.sc = s.stride[last];
    t.batch = 1;
    long long out_stride = 1;
    long long ostro[kMaxDims];
    for (int a = last; a >= 0; --a) {
      ostro[a] = out_stride;
      out_stride *= s.size[a];
    }
    t.out_sa = ostro[unit];
    for (int a = kMaxDims - nd; a < last; ++a) {
      if (a == unit) continue;
      t.os[t.n_other] = s.size[a];
      t.ostr[t.n_other] = s.stride[a];
      t.ostro[t.n_other] = ostro[a];
      t.batch *= s.size[a];
      ++t.n_other;
    }
    // TA: 1024 positions for C up to 4, halving as C doubles, 64 from 33
    int log_ta = 10;
    while (log_ta > 6 && (kTile >> log_ta) < t.nc) --log_ta;
    const long long ta = 1LL << log_ta, tc = kTile / ta;
    const long long a_tiles = (t.na + ta - 1) / ta;
    if (a_tiles * t.batch < (1LL << 31) && (t.nc + tc - 1) / tc <= 65535) {
      const dim3 grid((unsigned)(a_tiles * t.batch),
                      (unsigned)((t.nc + tc - 1) / tc));
      const E* s_ = static_cast<const E*>(src);
      E* d_ = static_cast<E*>(dst);
      const unsigned at = (unsigned)a_tiles;
#define DPCR_TRANSPOSE(L)                                              \
  firewall_copy_transpose_kernel<E, L><<<grid, kThreads, 0, stream>>>( \
      s_, d_, t, at)
      switch (log_ta) {
        case 10: DPCR_TRANSPOSE(10); break;
        case 9: DPCR_TRANSPOSE(9); break;
        case 8: DPCR_TRANSPOSE(8); break;
        case 7: DPCR_TRANSPOSE(7); break;
        default: DPCR_TRANSPOSE(6);
      }
#undef DPCR_TRANSPOSE
      return (int)cudaGetLastError();
    }
  }
  firewall_copy_strided_kernel<E><<<grid_for((n + kThreads - 1) / kThreads),
                                    kThreads, 0, stream>>>(
      static_cast<const E*>(src), static_cast<E*>(dst), s, n);
  return (int)cudaGetLastError();
}

}  // namespace dpcr

// src: a tensor of logical sizes n0..n4 (leading dimensions padded with 1)
// and element strides s0..s4, of 2- or 4-byte elements; dst: n0*..*n4
// elements, contiguous. Both aligned to the element size.
// Returns 0 on success, a CUDA error code, or a negative dpcr::ArgError.
extern "C" int firewall_copy_launch(int elem_size, const void* src, void* dst,
                                    long long n0, long long n1, long long n2,
                                    long long n3, long long n4, long long s0,
                                    long long s1, long long s2, long long s3,
                                    long long s4, void* stream) {
  const long long size[dpcr::kMaxDims] = {n0, n1, n2, n3, n4};
  const long long stride[dpcr::kMaxDims] = {s0, s1, s2, s3, s4};
  long long n = 1;
  for (int a = 0; a < dpcr::kMaxDims; ++a) {
    if (size[a] < 1 || stride[a] < 0) return dpcr::kBadShape;
    n *= size[a];
  }
  // merge axis a into the one after it where the source holds them
  // contiguously (axes of size 1 drop out), right-aligned in the struct
  dpcr::Strided s;
  int nd = 0;
  for (int a = dpcr::kMaxDims - 1; a >= 0; --a) {
    if (size[a] == 1) continue;
    const int k = dpcr::kMaxDims - nd;   // the merged axis after a is k
    if (nd > 0 && stride[a] == s.size[k] * s.stride[k]) {
      s.size[k] *= size[a];
      continue;
    }
    ++nd;
    s.size[k - 1] = size[a];
    s.stride[k - 1] = stride[a];
  }
  if (nd == 0) {                          // one element
    nd = 1;
    s.size[dpcr::kMaxDims - 1] = 1;
    s.stride[dpcr::kMaxDims - 1] = 1;
  }
  for (int a = 0; a < dpcr::kMaxDims - nd; ++a) {
    s.size[a] = 1;
    s.stride[a] = 0;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_size == 4)
    return dpcr::launch<uint32_t>(src, dst, s, nd, n, st);
  if (elem_size == 2)
    return dpcr::launch<uint16_t>(src, dst, s, nd, n, st);
  return dpcr::kBadDType;
}
