// Shared by the fused rigid KPConv kernels (kpconv_fwd.cu, kpconv_bwd.cu):
// the influence of a kernel point on a neighbour and the weight of one
// edge (query row, neighbour) for a kernel point.
#pragma once

#include "common.cuh"

namespace dpcr {

constexpr int kPC = 16;        // kernel points of a chunk
constexpr int kThreads = 256;  // threads of a block

// influence codes passed from the Python wrappers
enum Influence : int { kLinear = 0, kGaussian = 1, kConstant = 2 };

// v rounded to the storage type T and back (identity for float): the
// rounding points of the bf16 compute mode
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_float<T>(from_float<T>(v));
}

__device__ __forceinline__ float sq_dist(float rx, float ry, float rz,
                                         const float* kp) {
  const float dx = rx - kp[0], dy = ry - kp[1], dz = rz - kp[2];
  return dx * dx + dy * dy + dz * dz;
}

// linear: clip(1 - sqrt(max(d2, 0)) / extent, 0); gaussian with sigma =
// 0.3 extent; constant 1. A shadow neighbour (~1e6 away) gets 0 from the
// first two: the clamp, and exp(-huge) = 0.
__device__ __forceinline__ float influence_of(float d2, float extent,
                                              int influence) {
  if (influence == kConstant) return 1.f;
  if (influence == kLinear)
    return fmaxf(1.f - sqrtf(fmaxf(d2, 0.f)) / extent, 0.f);
  const float sigma = extent * 0.3f;
  return expf(-d2 / (2.f * sigma * sigma + 1e-9f));
}

// The first kernel point at the least squared distance (strict <, so an
// exact tie keeps the earlier one, as a one-hot argmin does).
__device__ __forceinline__ int closest_point(float rx, float ry, float rz,
                                             const float* kp, int n_kp) {
  float m = sq_dist(rx, ry, rz, kp);
  int best = 0;
  for (int p = 1; p < n_kp; ++p) {
    const float d2 = sq_dist(rx, ry, rz, kp + 3 * p);
    if (d2 < m) {
      m = d2;
      best = p;
    }
  }
  return best;
}

// The weight of kernel point p on the edge with relative position r;
// `best` >= 0 (aggregation 'closest') zeroes every other kernel point.
__device__ __forceinline__ float edge_weight(const float* r, const float* kp,
                                             int p, int best, float extent,
                                             int influence) {
  if (best >= 0 && p != best) return 0.f;
  return influence_of(sq_dist(r[0], r[1], r[2], kp + 3 * p), extent,
                      influence);
}

}  // namespace dpcr
