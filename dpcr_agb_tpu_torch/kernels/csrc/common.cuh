// Shared helpers for the port's hand-written Hopper kernels: float <-> storage
// conversions for the two supported element types (float, __nv_bfloat16),
// and the runtime-version probe each library exports.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dpcr {

// dtype codes passed from the Python wrappers
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

// error codes for arguments the kernels do not take (CUDA's own codes are > 0)
enum ArgError : int { kBadDType = -1, kBadShape = -2 };

// VEC consecutive values moved as one aligned load or store (16 bytes for
// the 16-byte channel groups of the pool kernels)
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T> __device__ __forceinline__ float to_float(T v);
template <> __device__ __forceinline__ float to_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

}  // namespace dpcr

// The CUDA runtime version the library runs on (e.g. 12080 for 12.8), or a
// negative CUDA error code; the loader holds it against PyTorch's. Each
// library compiles exactly one source that includes this header.
extern "C" int dpcr_cuda_runtime_version() {
  int v = 0;
  const cudaError_t e = cudaRuntimeGetVersion(&v);
  return e == cudaSuccess ? v : -(int)e;
}
