// fps: farthest point sampling, batched, one thread-block cluster a sample.
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
// maxima across the whole sample. The products and sums are written with
// __fmul_rn / __fadd_rn in the plain version's order: nvcc would contract
// a*b + c into one FMA, and one rounding of difference moves a near-tie,
// after which every later index differs. Positions are finite.
//
// What bounds it: the latency of the serial steps. The roofline's
// operations count (~10 f32 operations a point a step) is a few percent of
// any design's time. The first port, one block a sample, left 116 of 132
// SMs idle at bs16 and spent a step on three shared loads a point and a
// block-wide argmax behind a __syncthreads: 1.86 us a step on the input.
// Here a sample is spread over a cluster of up to 8 CTAs on up to 8 SMs
// (kernels.fps_plan: 8 on the 12000- and 8192-point samplings, 4 on 2048,
// one warp up to 512 points), and a step is the arithmetic of ~1500 points
// an SM plus one exchange through distributed shared memory:
//
// - Registers hold the points: thread t of CTA r holds points
//   r * T * PER + k * T + t (k < PER; index order within the thread): x,
//   y, z and the running distance as an ordered key, nothing in shared
//   memory. The key is the distance's bits as an int (d >= +0, so the
//   int order is the float order, +inf included) and -1 for a masked or
//   padding row, so the running minimum is an integer min and a masked
//   row stays -1 without reading the mask again.
// - A thread keeps its best (key, point) with a strict compare, so the
//   lowest index wins its ties; a warp takes the max key with
//   __reduce_max_sync and, among the lanes that hold it, the lowest index
//   with __reduce_min_sync. Two redux.sync were shorter on the card than a
//   five-level butterfly over a 64-bit (key + 1, ~index), and than one
//   redux plus a ballot that skips the second where one lane holds the
//   max; a tree over a thread's points instead of the compare chain was
//   slower too.
// - Lane r of each warp sends the warp's best ((key, index, x, y), then
//   z: 20 bytes) into slot (rank, warp) of CTA r with st.async, which
//   counts down the transaction bytes of CTA r's mbarrier for the step;
//   each CTA waits on its own mbarrier for the cluster's slots x 20 bytes
//   (thread 0 arms it each step). Two slot tables and two mbarriers,
//   chosen by the step's parity: a CTA is at most one step ahead of
//   another, so a table is written again only after every CTA's warps
//   read it. No __syncthreads and no cluster barrier in the loop: with
//   one barrier.cluster arrive.release / wait.acquire a step (this
//   design's first build) a step took 1.42 us on the input, with the
//   mbarrier 0.63 (chip_smoke.py, H100 80GB HBM3, 700 W). One lane
//   sending to the 8 CTAs in turn was slower than 8 lanes at once.
// - Every warp then reduces the cluster's slots (cluster x warps <= 128,
//   one to four a lane) from its own shared memory the same way and takes
//   the winner's position by shuffle: nothing is read from device memory
//   in the loop. Rank 0's warp 0 keeps the last 32 indices in its lanes
//   and writes them together.
// - ONE_WARP, a sample of one warp (PointNeXt's last two samplings): the
//   warp's best is the pick; no slot, mbarrier or barrier. Through the
//   slots it was slower than the first port's block.
//
// Registers (ptxas -v, sm_90a, CUDA 12.8), points a thread: cluster
// instance / ONE_WARP: 1: 56 / 32, 2: 58 / 40, 4: 64 / 48, 6: 72 / 62,
// 8: 80 / 78, 12: 114 / 116, 16: 150 / 152, 24: 225 / 219; no spill
// (chip_smoke.py's device line prints them and fails on a spill). Launch
// bounds: 512 threads up to 12 points a thread, 256 at 16 and 24, one
// block an SM (without it ptxas cut 8 points a thread to 64 registers to
// fit two blocks of 512, and spilled; 32 points a thread spilled at 255).
//
// Limits: cluster 1, 2, 4 or 8 (portable sizes), threads a multiple of 32
// up to fps_max_threads(PER), cluster x warps <= 128, cluster x threads x
// PER >= N (so N <= 8 x 128 x 24 = 24576 with the plan's threads). Other
// shapes return kBadShape; the wrapper names N. ONE_WARP is launched
// without the cluster attribute (the card refuses st.async, mapa and the
// cluster barrier in a CTA launched so: an illegal instruction).
#include <limits.h>

#include "common.cuh"

namespace dpcr {

constexpr int kFpsMaxCluster = 8;
constexpr int kFpsMaxSlots = 128;   // cluster x warps
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaskedKey = -1;      // below the key of any distance >= +0
constexpr int kInfKey = 0x7f800000; // +inf: a valid row before the first step

// the most threads a CTA of PER points a thread may have (ptxas spilled at
// 16 points and 512 threads)
constexpr int fps_max_threads(int per) { return per <= 12 ? 512 : 256; }

__device__ __forceinline__ unsigned cluster_ctarank() {
  unsigned r;
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_nctarank() {
  unsigned r;
  asm("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_id_x() {
  unsigned r;
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned sm_id() {
  unsigned r;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster (start-up and exit only)
__device__ __forceinline__ void cluster_sync() {
  __syncwarp();
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// the address `local` (this CTA's shared memory) in CTA `rank` of the cluster
__device__ __forceinline__ unsigned remote(unsigned local, unsigned rank) {
  unsigned out;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(local),
      "r"(rank));
  return out;
}

// 16 and 4 bytes into another CTA's shared memory; their arrival counts
// down the transaction bytes of that CTA's mbarrier `bar`
__device__ __forceinline__ void send(unsigned addr, unsigned bar, int a,
                                     int b, int c, int d) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(addr), "r"(a), "r"(b), "r"(c), "r"(d),
      "r"(bar) : "memory");
}

__device__ __forceinline__ void send(unsigned addr, unsigned bar, int a) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(addr), "r"(a), "r"(bar) : "memory");
}

__device__ __forceinline__ void bar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

// arrive on `bar` and add `bytes` to the transaction bytes its phase waits
// for
__device__ __forceinline__ void bar_expect(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes) : "memory");
}

// wait for the phase of `bar` of this parity to complete; what was stored
// to count it down is then seen
__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n\tselp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// (key, index) of the lane that wins the warp: the largest key, among
// equal keys the lowest index (lanes out of the running hold INT_MIN)
__device__ __forceinline__ void warp_best(int key, unsigned idx, int& wkey,
                                          unsigned& widx) {
  wkey = __reduce_max_sync(kFull, key);
  widx = __reduce_min_sync(kFull, key == wkey ? idx : 0xffffffffu);
}

// ONE_WARP: the sample is one warp (a cluster of one CTA of 32 threads,
// kernels.fps_plan's choice up to 512 points): the warp's best is the pick,
// with no slots, no mbarrier and no barrier at all
template <int PER, bool ONE_WARP>
__global__ void __launch_bounds__(ONE_WARP ? 32 : fps_max_threads(PER), 1)
fps_kernel(const float* __restrict__ pos, const uint8_t* __restrict__ mask,
           long long* __restrict__ out, int* __restrict__ smid, int n,
           int n_samples, int start) {
  // slot (rank, warp) of step s: (key, index, x, y) and z, in table s & 1
  __shared__ int4 slot4[ONE_WARP ? 1 : 2][kFpsMaxSlots];
  __shared__ float slotz[ONE_WARP ? 1 : 2][kFpsMaxSlots];
  __shared__ __align__(8) unsigned long long bars[2];
  const unsigned rank = cluster_ctarank(), ctas = cluster_nctarank();
  const unsigned sample = cluster_id_x();
  const int t = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, warps = t >> 5;
  const int slots = (int)ctas * warps;
  const unsigned base = rank * (unsigned)(t * PER) + tid;
  const float* p = pos + (long long)sample * n * 3;
  const uint8_t* m = mask + (long long)sample * n;
  long long* o = out + (long long)sample * n_samples;

  float x[PER], y[PER], z[PER];
  int key[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const unsigned i = base + k * t;
    const bool in = i < (unsigned)n;
    x[k] = in ? p[3 * i] : 0.f;
    y[k] = in ? p[3 * i + 1] : 0.f;
    z[k] = in ? p[3 * i + 2] : 0.f;
    key[k] = (in && m[i]) ? kInfKey : kMaskedKey;
  }
  float lx = p[3 * start], ly = p[3 * start + 1], lz = p[3 * start + 2];
  if (smid != nullptr && tid == 0) smid[blockIdx.x] = (int)sm_id();
  if constexpr (!ONE_WARP) {
    if (tid == 0) {
      bar_init(smem_addr(&bars[0]), 1);
      bar_init(smem_addr(&bars[1]), 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    // every CTA of the cluster runs, its mbarriers set, before a remote
    // store
    cluster_sync();
  }
  const unsigned bytes = (unsigned)slots * (sizeof(int4) + sizeof(float));
  const int my_slot = (int)rank * warps + warp;
  // rank 0's warp 0 writes the indices, 32 steps at a time: lane l holds
  // the index of step (s & ~31) + l
  const bool writer = rank == 0 && warp == 0;
  long long ring = start;

  for (int s = 1; s < n_samples; ++s) {
    const int tab = s & 1;
    const unsigned bar = smem_addr(&bars[tab]);
    if (!ONE_WARP && tid == 0) bar_expect(bar, bytes);
    int bkey = INT_MIN, bk = 0;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const float dx = __fsub_rn(x[k], lx);
      const float dy = __fsub_rn(y[k], ly);
      const float dz = __fsub_rn(z[k], lz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                          __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      key[k] = min(key[k], __float_as_int(d));
      if (key[k] > bkey) {
        bkey = key[k];
        bk = k;
      }
    }
    const unsigned bidx = base + bk * t;
    int wkey;
    unsigned widx;
    warp_best(bkey, bidx, wkey, widx);
    const int wlead =
        __ffs(__ballot_sync(kFull, bkey == wkey && bidx == widx)) - 1;
    float bx = x[0], by = y[0], bz = z[0];
#pragma unroll
    for (int k = 1; k < PER; ++k) {
      if (bk == k) {
        bx = x[k];
        by = y[k];
        bz = z[k];
      }
    }
    bx = __shfl_sync(kFull, bx, wlead);
    by = __shfl_sync(kFull, by, wlead);
    bz = __shfl_sync(kFull, bz, wlead);
    unsigned gidx = widx;
    if constexpr (ONE_WARP) {
      lx = bx;
      ly = by;
      lz = bz;
    } else {
      if (lane < (int)ctas) {   // lane r sends the warp's best to CTA r
        const unsigned rbar = remote(bar, lane);
        send(remote(smem_addr(&slot4[tab][my_slot]), lane), rbar, wkey,
             (int)widx, __float_as_int(bx), __float_as_int(by));
        send(remote(smem_addr(&slotz[tab][my_slot]), lane), rbar,
             __float_as_int(bz));
      }
      bar_wait(bar, (unsigned)((s - 1) >> 1) & 1u);
      int ckey = INT_MIN;
      unsigned cidx = 0xffffffffu;
      float cx = 0.f, cy = 0.f, cz = 0.f;
      for (int j = lane; j < slots; j += 32) {
        const int4 c = slot4[tab][j];
        if (c.x > ckey || (c.x == ckey && (unsigned)c.y < cidx)) {
          ckey = c.x;
          cidx = (unsigned)c.y;
          cx = __int_as_float(c.z);
          cy = __int_as_float(c.w);
          cz = slotz[tab][j];
        }
      }
      int gkey;
      warp_best(ckey, cidx, gkey, gidx);
      const int lead =
          __ffs(__ballot_sync(kFull, ckey == gkey && cidx == gidx)) - 1;
      lx = __shfl_sync(kFull, cx, lead);
      ly = __shfl_sync(kFull, cy, lead);
      lz = __shfl_sync(kFull, cz, lead);
    }
    if (writer) {
      if (lane == (s & 31)) ring = gidx;
      if ((s & 31) == 31 || s == n_samples - 1) {
        const int first = s & ~31;
        if (first + lane <= s) o[first + lane] = ring;
      }
    }
  }
  if (writer && n_samples == 1 && lane == 0) o[0] = start;
  // no CTA leaves while a store of the cluster may still reach it
  if constexpr (!ONE_WARP) cluster_sync();
}

static void configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                      int grid, int threads, int cluster,
                      cudaStream_t stream) {
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

template <int PER>
static int launch(const float* pos, const uint8_t* mask, long long* out,
                  int* smid, int b, int n, int n_samples, int start,
                  int cluster, int threads, cudaStream_t stream) {
  if (cluster == 1 && threads == 32) {   // ONE_WARP: a plain launch
    fps_kernel<PER, true><<<b, 32, 0, stream>>>(pos, mask, out, smid, n,
                                                 n_samples, start);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  configure(cfg, attr, b * cluster, threads, cluster, stream);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, fps_kernel<PER, false>, pos,
                                           mask, out, smid, n, n_samples,
                                           start);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

template <int PER>
static int active_clusters(int cluster, int threads) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  configure(cfg, attr, cluster, threads, cluster, nullptr);
  int count = 0;
  const void* fn = cluster == 1 && threads == 32
                       ? (const void*)fps_kernel<PER, true>
                       : (const void*)fps_kernel<PER, false>;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&count, fn, &cfg);
  if (e != cudaSuccess) {
    (void)cudaGetLastError();
    return -(int)e;
  }
  return count;
}

static bool fps_shape_ok(int n, int per, int cluster, int threads) {
  const bool width = per == 1 || per == 2 || per == 4 || per == 6 ||
                     per == 8 || per == 12 || per == 16 || per == 24;
  return width && (cluster == 1 || cluster == 2 || cluster == 4 ||
                   cluster == kFpsMaxCluster) &&
         threads >= 32 && threads % 32 == 0 &&
         threads <= fps_max_threads(per) &&
         cluster * (threads / 32) <= kFpsMaxSlots &&
         (long long)cluster * threads * per >= n;
}

}  // namespace dpcr

#define DPCR_FPS_WIDTHS(X) \
  X(1) X(2) X(4) X(6) X(8) X(12) X(16) X(24)

// pos [b, n, 3] f32, mask [b, n] bool (one byte each), out [b, n_samples]
// int64, all contiguous; smid null, or [b * cluster] int32 that takes the
// SM of each CTA; `cluster` CTAs of `threads` threads a sample, `per`
// points a thread (kernels.fps_plan).
// Returns 0 on success, a CUDA error code, or dpcr::kBadShape.
extern "C" int fps_launch(const void* pos, const void* mask, void* out,
                          void* smid, int b, int n, int n_samples, int start,
                          int cluster, int threads, int per, void* stream) {
  if (b < 1 || n < 1 || n_samples < 1 || start < 0 || start >= n ||
      !dpcr::fps_shape_ok(n, per, cluster, threads) ||
      (long long)b * cluster > INT_MAX)
    return dpcr::kBadShape;
  const float* p = static_cast<const float*>(pos);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  long long* o = static_cast<long long*>(out);
  int* sm = static_cast<int*>(smid);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (per) {
#define DPCR_FPS_CASE(P)                                                  \
  case P:                                                                 \
    return dpcr::launch<P>(p, m, o, sm, b, n, n_samples, start, cluster,  \
                           threads, st);
    DPCR_FPS_WIDTHS(DPCR_FPS_CASE)
#undef DPCR_FPS_CASE
    default: return dpcr::kBadShape;
  }
}

// How many clusters of `cluster` CTAs of `threads` threads at `per` points
// a thread the card holds at once (cudaOccupancyMaxActiveClusters), or
// minus a CUDA error code, or dpcr::kBadShape.
extern "C" int fps_max_active_clusters(int per, int threads, int cluster) {
  if (!dpcr::fps_shape_ok(1, per, cluster, threads)) return dpcr::kBadShape;
  switch (per) {
#define DPCR_FPS_CASE(P) \
  case P:                \
    return dpcr::active_clusters<P>(cluster, threads);
    DPCR_FPS_WIDTHS(DPCR_FPS_CASE)
#undef DPCR_FPS_CASE
    default: return dpcr::kBadShape;
  }
}
