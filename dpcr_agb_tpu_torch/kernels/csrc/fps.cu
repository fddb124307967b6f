// fps: farthest point sampling, batched, one thread block a sample.
//
// Replaces: the farthest point sampling of dpcr_agb_tpu/ops/neighbors.py
// (`fps`, a lax.fori_loop that the JAX package leaves to XLA, vmapped over
// the batch by dpcr_agb_tpu/models/pointnext.py). No Pallas kernel stands
// behind it; the loop has n_samples - 1 strictly serial steps (8191 for
// PointNeXt's input sampling, 12000 -> 8192), and a plain PyTorch loop
// issues ~8 kernels a step.
//
// Semantics (those of ops/neighbors.fps_plain, exactly): the running
// distance starts at +inf on valid rows and -inf on masked ones; idx[0] =
// start; each step takes d = (dx*dx + dy*dy) + dz*dz to the last pick,
// the running minimum, and picks its argmax, the lowest index among equal
// maxima. The products and sums are written with __fmul_rn / __fadd_rn in
// the plain version's order: nvcc would contract a*b + c into one FMA,
// and one rounding of difference moves a near-tie, after which every later
// index differs. A masked row's -inf stays -inf under the minimum, so the
// step does not read the mask.
//
// Design. Block b owns sample b: its positions in shared memory as three
// arrays (x, y, z; 12 bytes a point, padded to threads * PER points with
// -inf distances), each thread's PER running distances in registers
// (points tid, tid + T, ...: conflict-free shared reads). A step: every
// thread updates its distances and keeps its best (value, index); a warp
// butterfly argmax; lane 0 of each warp writes its best to one of two
// shared slots (alternating by step, so a single __syncthreads a step
// orders the writes before the reads and the next step's writes after
// them); then every warp reduces the warps' bests with a second butterfly
// and holds the winner, whose position it reads from shared memory. Ties
// go to the lower index at every level. One launch a call, the grid over
// the batch.
//
// Registers bound the threads: PER up to 8 at 1024 threads (64 registers
// a thread), 16 at 768 (the first build held 16 at 1024 and spilled 232
// bytes a thread), 32 at 512. Limits: N <= 16384 (32 points a thread at
// 512 threads; 192 KB of shared memory). Larger N is refused with
// kBadShape; the wrapper names the shape. The latency of the block-wide reduction at each step,
// not the arithmetic, sets the time: one SM a sample, the other SMs idle
// when B < 132.
#include <math.h>

#include "common.cuh"

namespace dpcr {

constexpr int kFpsMaxThreads = 1024;
constexpr int kFpsMaxPer = 32;
constexpr int kFpsMaxWarps = kFpsMaxThreads / 32;

// the most threads a block of PER points a thread may have
constexpr int fps_max_threads(int per) {
  return per <= 8 ? 1024 : per == 16 ? 768 : 512;
}

struct Best {
  float v;
  int i;
};

// (v, i) beats (w, j): a larger value, or an equal one at a lower index
__device__ __forceinline__ bool beats(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

__device__ __forceinline__ Best warp_argmax(Best b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_xor_sync(0xffffffffu, b.v, off);
    const int i = __shfl_xor_sync(0xffffffffu, b.i, off);
    if (beats(v, i, b.v, b.i)) {
      b.v = v;
      b.i = i;
    }
  }
  return b;
}

template <int PER>
__global__ void __launch_bounds__(fps_max_threads(PER))
fps_kernel(const float* __restrict__ pos, const uint8_t* __restrict__ mask,
           long long* __restrict__ out, int n, int n_samples, int start) {
  extern __shared__ float smem[];
  __shared__ float red_v[2][kFpsMaxWarps];
  __shared__ int red_i[2][kFpsMaxWarps];
  const int t = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, warps = t >> 5;
  const int cap = t * PER;
  float* sx = smem;
  float* sy = smem + cap;
  float* sz = smem + 2 * cap;
  const float* p = pos + (long long)blockIdx.x * n * 3;
  const uint8_t* m = mask + (long long)blockIdx.x * n;
  long long* o = out + (long long)blockIdx.x * n_samples;

  float dist[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = k * t + tid;
    const bool in = i < n;
    sx[i] = in ? p[3 * i] : 0.f;
    sy[i] = in ? p[3 * i + 1] : 0.f;
    sz[i] = in ? p[3 * i + 2] : 0.f;
    dist[k] = (in && m[i]) ? INFINITY : -INFINITY;
  }
  if (tid == 0) o[0] = start;
  __syncthreads();

  int last = start;
  for (int s = 1; s < n_samples; ++s) {
    const float lx = sx[last], ly = sy[last], lz = sz[last];
    Best b{-INFINITY, 0x7fffffff};
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = k * t + tid;
      const float dx = __fsub_rn(sx[i], lx);
      const float dy = __fsub_rn(sy[i], ly);
      const float dz = __fsub_rn(sz[i], lz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                          __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      dist[k] = fminf(dist[k], d);
      if (beats(dist[k], i, b.v, b.i)) {
        b.v = dist[k];
        b.i = i;
      }
    }
    b = warp_argmax(b);
    const int slot = s & 1;
    if (lane == 0) {
      red_v[slot][warp] = b.v;
      red_i[slot][warp] = b.i;
    }
    __syncthreads();
    Best w{-INFINITY, 0x7fffffff};
    if (lane < warps) {
      w.v = red_v[slot][lane];
      w.i = red_i[slot][lane];
    }
    w = warp_argmax(w);
    last = w.i;
    if (tid == 0) o[s] = last;
  }
}

template <int PER>
static int launch(const float* pos, const uint8_t* mask, long long* out,
                  int b, int n, int n_samples, int start, int threads,
                  cudaStream_t stream) {
  const size_t smem = (size_t)3 * threads * PER * sizeof(float);
  if (smem > 48 * 1024) {   // past the default: opt in (on this device)
    const cudaError_t e = cudaFuncSetAttribute(
        fps_kernel<PER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fps_kernel<PER><<<b, threads, smem, stream>>>(pos, mask, out, n, n_samples,
                                                start);
  return (int)cudaGetLastError();
}

}  // namespace dpcr

// pos [b, n, 3] f32, mask [b, n] bool (one byte each), out [b, n_samples]
// int64, all contiguous; per (1, 2, 4, 8, 16 or 32) points a thread,
// threads a multiple of 32 up to fps_max_threads(per) with threads * per
// >= n (kernels.fps_plan).
// Returns 0 on success, a CUDA error code, or dpcr::kBadShape.
extern "C" int fps_launch(const void* pos, const void* mask, void* out, int b,
                          int n, int n_samples, int start, int per,
                          int threads, void* stream) {
  if (b < 1 || n < 1 || n_samples < 1 || start < 0 || start >= n ||
      threads < 32 || threads % 32 || per < 1 || per > dpcr::kFpsMaxPer ||
      threads > dpcr::fps_max_threads(per) || (long long)threads * per < n)
    return dpcr::kBadShape;
  const float* p = static_cast<const float*>(pos);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  long long* o = static_cast<long long*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (per) {
    case 1: return dpcr::launch<1>(p, m, o, b, n, n_samples, start, threads,
                                   st);
    case 2: return dpcr::launch<2>(p, m, o, b, n, n_samples, start, threads,
                                   st);
    case 4: return dpcr::launch<4>(p, m, o, b, n, n_samples, start, threads,
                                   st);
    case 8: return dpcr::launch<8>(p, m, o, b, n, n_samples, start, threads,
                                   st);
    case 16: return dpcr::launch<16>(p, m, o, b, n, n_samples, start,
                                     threads, st);
    case 32: return dpcr::launch<32>(p, m, o, b, n, n_samples, start,
                                     threads, st);
    default: return dpcr::kBadShape;
  }
}
