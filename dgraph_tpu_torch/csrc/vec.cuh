// Helpers shared by the port's CUDA kernels (sm_90a): dtype conversion and
// the 16-byte vector loads and stores with which a lane moves its group of
// consecutive features (4 f32 or 8 bf16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dg {

enum DType : int { kF32 = 0, kBF16 = 1 };

// Features per lane: one 16-byte vector of the data dtype; a warp slice
// covers 32 lanes' worth of columns (128 f32 or 256 bf16).
template <typename T>
constexpr int kVec = 16 / sizeof(T);
template <typename T>
constexpr int kColsPerWarp = 32 * kVec<T>;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

// Each library links its own static CUDA runtime, whose current device (per
// host thread) starts at 0. Every entry point first makes it the card that
// holds p, so a launch on the stream of a rank on cuda:r is legal.
inline cudaError_t bind_device_of(const void* p) {
  cudaPointerAttributes a;
  cudaError_t e = cudaPointerGetAttributes(&a, p);
  if (e != cudaSuccess) return e;
  int cur = -1;
  e = cudaGetDevice(&cur);
  if (e != cudaSuccess || cur == a.device) return e;
  return cudaSetDevice(a.device);
}

// NaN-propagating relu (matches jnp.maximum(x, 0) and torch.relu)
__device__ __forceinline__ float relu(float x) { return x < 0.f ? 0.f : x; }

// VEC is chosen once per launch: the wrapper sets it only when every row
// starts 16-byte aligned and is a whole number of 16-byte vectors wide, so
// every lane group is full (n == W) or empty. A per-lane test of n between
// a vector and a scalar path tripled the time of a row gather.

// Load n (<= kVec<T>) consecutive features starting at p into v as f32
// (zeros past n). VEC: p is 16-byte aligned and n == W: one vector load.
template <typename T, bool VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, int n, float* v) {
  constexpr int W = kVec<T>;
  if constexpr (VEC) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        v[i] = __uint_as_float(w[i]);
      } else {
        // bf16 -> f32 is exact: the bf16 bits are the high half of the f32
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] = i < n ? to_f32(p[i]) : 0.f;
  }
}

// Store n (<= W) features of v at p in the dtype O. VEC: p is 16-byte
// aligned and n == W: W * sizeof(O) / 16 vector stores.
template <typename O, int W, bool VEC>
__device__ __forceinline__ void store_vec(O* __restrict__ p, int n, const float* v) {
  constexpr int P = 16 / sizeof(O);  // elements per 16-byte store
  static_assert(W % P == 0, "a lane's group must fill whole 16-byte vectors");
  if constexpr (VEC) {
#pragma unroll
    for (int j = 0; j < W / P; ++j) {
      const float* u = v + j * P;
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (sizeof(O) == 4)
          w[i] = __float_as_uint(u[i]);
        else
          w[i] = bf16_bits(u[2 * i]) | (bf16_bits(u[2 * i + 1]) << 16);
      }
      *reinterpret_cast<uint4*>(p + j * P) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i)
      if (i < n) p[i] = from_f32<O>(v[i]);
  }
}

// log2 of the lanes that cover one row's feature slice: the smallest power
// of two at least the slice's number of feature groups. The kernels map
// lanes to rows with shifts by it: a division by a runtime lane count in
// that map cost more than the memory traffic of a one-row-per-warp gather.
template <typename T>
inline int lanes_log2_for(int F) {
  const int groups = (min(F, kColsPerWarp<T>) + kVec<T> - 1) / kVec<T>;
  int s = 0;
  while ((1 << s) < groups) ++s;
  return s;
}

}  // namespace dg
