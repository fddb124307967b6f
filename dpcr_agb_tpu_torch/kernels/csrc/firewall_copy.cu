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
// (3.30 GB each way for the f32 stem output [16,88,88,104,64]).
//
// Design: two kernels. A contiguous, 16-byte aligned source is moved as
// 16-byte words on a grid-stride loop (coalesced 128-bit loads and stores),
// with a scalar tail for the last elements. Any other source is read
// through its strides, one thread per output element, so the writes stay
// coalesced whatever the reads are. Offsets are 64-bit throughout (the stem
// output has 8.2e8 elements and, at twice the batch, more than 2^31), and
// the grid is capped and looped instead of sized from the element count.
#include "common.cuh"

namespace dpcr {

constexpr int kMaxDims = 5;

struct Strided {
  long long size[kMaxDims];    // logical sizes, leading ones padded with 1
  long long stride[kMaxDims];  // source strides in elements
};

__global__ void firewall_copy_vec_kernel(const uint4* __restrict__ src,
                                         uint4* __restrict__ dst,
                                         long long n_vec) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_vec; i += step)
    dst[i] = src[i];
}

// elements [first, n) of a contiguous source, one per thread
template <typename E>
__global__ void firewall_copy_tail_kernel(const E* __restrict__ src,
                                          E* __restrict__ dst,
                                          long long first, long long n) {
  const long long i = first + (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) dst[i] = src[i];
}

template <typename E>
__global__ void firewall_copy_strided_kernel(const E* __restrict__ src,
                                             E* __restrict__ dst, Strided s,
                                             long long n) {
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

static unsigned grid_for(long long items, int threads) {
  long long blocks = (items + threads - 1) / threads;
  // 132 SMs x 16 resident blocks of 256 threads x 8 waves: enough to fill
  // the card, far below gridDim.x's limit; the loops stride beyond it
  const long long cap = 132LL * 16 * 8;
  return (unsigned)(blocks < cap ? blocks : cap);
}

template <typename E>
static int launch(const void* src, void* dst, const Strided& s, long long n,
                  bool contiguous, cudaStream_t stream) {
  const int threads = 256;
  const bool aligned = (reinterpret_cast<uintptr_t>(src) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(dst) % 16 == 0);
  if (contiguous && aligned) {
    constexpr long long per = 16 / sizeof(E);
    const long long n_vec = n / per;
    if (n_vec > 0)
      firewall_copy_vec_kernel<<<grid_for(n_vec, threads), threads, 0,
                                 stream>>>(static_cast<const uint4*>(src),
                                           static_cast<uint4*>(dst), n_vec);
    if (n_vec * per < n)
      firewall_copy_tail_kernel<E><<<1, 32, 0, stream>>>(
          static_cast<const E*>(src), static_cast<E*>(dst), n_vec * per, n);
  } else {
    firewall_copy_strided_kernel<E><<<grid_for(n, threads), threads, 0,
                                     stream>>>(static_cast<const E*>(src),
                                               static_cast<E*>(dst), s, n);
  }
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
  dpcr::Strided s = {{n0, n1, n2, n3, n4}, {s0, s1, s2, s3, s4}};
  long long n = 1;
  bool contiguous = true;
  for (int a = dpcr::kMaxDims - 1; a >= 0; --a) {
    if (s.size[a] < 1 || s.stride[a] < 0) return dpcr::kBadShape;
    if (s.size[a] > 1 && s.stride[a] != n) contiguous = false;
    n *= s.size[a];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_size == 4)
    return dpcr::launch<uint32_t>(src, dst, s, n, contiguous, st);
  if (elem_size == 2)
    return dpcr::launch<uint16_t>(src, dst, s, n, contiguous, st);
  return dpcr::kBadDType;
}
