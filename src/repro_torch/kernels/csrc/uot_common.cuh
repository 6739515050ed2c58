// Device helpers shared by every MAP-UOT kernel of the port: storage
// conversion (fp32 or bf16 in memory, fp32 arithmetic), 16-byte vector
// loads and stores, and the safe rescale factor. Included by each .cu file
// of kernels/csrc; everything lives in an anonymous namespace, so each
// translation unit keeps its own copy and nothing clashes at link time.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Raw storage of one vector: a 16-byte uint4, or one element.
template <typename T, int VEC> struct Raw { using type = uint4; };
template <typename T> struct Raw<T, 1> { using type = T; };

template <typename T, int VEC>
__device__ __forceinline__ typename Raw<T, VEC>::type load_raw(const T* p) {
  return *reinterpret_cast<const typename Raw<T, VEC>::type*>(p);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_raw(T* p,
                                          typename Raw<T, VEC>::type r) {
  *reinterpret_cast<typename Raw<T, VEC>::type*>(p) = r;
}

template <typename T, int VEC>
__device__ __forceinline__ void to_floats(typename Raw<T, VEC>::type r,
                                          float (&x)[VEC]) {
  if constexpr (VEC == 1) {
    x[0] = to_f(r);
  } else {
    static_assert(VEC * sizeof(T) == 16, "vector loads are 16 bytes");
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int k = 0; k < VEC; ++k) x[k] = to_f(e[k]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ typename Raw<T, VEC>::type from_floats(
    const float (&y)[VEC]) {
  typename Raw<T, VEC>::type r;
  if constexpr (VEC == 1) {
    r = from_f<T>(y[0]);
  } else {
    T* e = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int k = 0; k < VEC; ++k) e[k] = from_f<T>(y[k]);
  }
  return r;
}

// Store VEC floats as the output type O: 16-byte stores where the VEC
// values fill whole 16-byte words, one 8-byte store for four bf16, else one
// element. p must be aligned to VEC * sizeof(O) (at most 16 bytes).
template <typename O, int VEC>
__device__ __forceinline__ void store_floats(O* p, const float (&y)[VEC]) {
  constexpr int kBytes = VEC * (int)sizeof(O);
  if constexpr (VEC == 1) {
    *p = from_f<O>(y[0]);
  } else if constexpr (kBytes % 16 == 0) {
    constexpr int per = 16 / (int)sizeof(O);
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c) {
      uint4 r;
      O* e = reinterpret_cast<O*>(&r);
#pragma unroll
      for (int k = 0; k < per; ++k) e[k] = from_f<O>(y[c * per + k]);
      reinterpret_cast<uint4*>(p)[c] = r;
    }
  } else {
    static_assert(kBytes == 8, "four bf16 values: one 8-byte store");
    uint2 r;
    O* e = reinterpret_cast<O*>(&r);
#pragma unroll
    for (int k = 0; k < VEC; ++k) e[k] = from_f<O>(y[k]);
    *reinterpret_cast<uint2*>(p) = r;
  }
}

template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float (&x)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) x[k] = p[k];
}

// (target / sums) ** fi with 0-sums mapped to 1; matches uot_fused.py:47-53
// (a sum that is not > 0, NaN included, gives factor 1; fi == 1 skips pow).
__device__ __forceinline__ float safe_pow(float t, float s, float fi,
                                          int fi_one) {
  if (!(s > 0.f)) return 1.f;
  const float r = __fdiv_rn(t, s);
  return fi_one ? r : powf(r, fi);
}

}  // namespace
