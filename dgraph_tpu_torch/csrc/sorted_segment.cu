// Sorted-segment reductions for Hopper (sm_90a): the CUDA counterparts of the
// two Pallas TPU kernels of dgraph_tpu/ops/pallas_segment.py.
//
//   dg_sorted_segment_sum            replaces _kernel            (pallas_segment.py:39)
//     out[v] = sum_{e: ids[e]=v} op(data[e]),  op in {identity, relu}
//   dg_sorted_segment_sum_bias_relu  replaces _kernel_bias_relu  (pallas_segment.py:259)
//     out[v] = sum_{e: ids[e]=v} w[e] * relu(data[e] + bias[v])
//
// The TPU form is a one-hot [block_e, block_n] MXU contraction over a
// (vertex block, edge chunk) grid with a VMEM-resident output: it exists
// because the TPU has no scatter atomics. Here the ids are sorted, so each
// output row's edges form one contiguous range row_ptr[v] .. row_ptr[v+1]
// (the wrapper computes row_ptr with a searchsorted, which also drops ids
// outside [0, N)). The kernels are a CSR segment reduction:
//
//   - one warp owns one output row and a slice of feature columns; a lane
//     holds one 16-byte vector of consecutive features (4 f32 or 8 bf16, so
//     a slice is 128 f32 or 256 bf16 columns; a scalar path for a ragged or
//     unaligned group);
//   - when the row is narrower than the slice the warp splits into
//     32 / L edge groups of L lanes, which take every (32/L)-th edge and are
//     summed with a fixed shuffle tree at the end (SAGE's degree count has
//     F = 1: all 32 lanes then walk edges);
//   - accumulation is in f32 registers, the row is written once, and there
//     are no atomics, so every run gives the same bits. Element offsets are
//     64-bit.
//
// Bound: device-memory bytes. Each edge row is read once (E*F*b), plus ids
// and weights (8*E) and the bias and output rows (2*N*F*b); the arithmetic is
// a few operations per element loaded.
//
// Rounding follows the TPU kernel exactly (pallas_segment.py:297-323): bias
// arrives already rounded to the data dtype; pre = f32(data) + f32(bias);
// relu in f32; times f32(w); the message is rounded to the data dtype; the
// sum is f32; the output is cast to the data dtype. For the plain sum with
// input_op=relu, relu applies to the data-dtype value before the f32 sum.
//
// Plain C interface, loaded with ctypes (dgraph_tpu_torch/ops/_build.py).
// Each entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

// Features per lane: kVecsPerLane 16-byte vectors (4 f32 or 8 bf16 each);
// a warp slice covers 32 lanes' worth of columns.
constexpr int kVecsPerLane = 1;
template <typename T>
constexpr int kPerVec = 16 / sizeof(T);
template <typename T>
constexpr int kVec = kVecsPerLane * kPerVec<T>;
template <typename T>
constexpr int kColsPerWarp = 32 * kVec<T>;

enum DType : int { kF32 = 0, kBF16 = 1 };

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

// NaN-propagating relu (matches jnp.maximum(x, 0) and torch.relu)
__device__ __forceinline__ float relu(float x) { return x < 0.f ? 0.f : x; }

// Load n (<= kVec) consecutive features starting at p into v (zeros past n).
// VEC: p is 16-byte aligned, so a full group is kVecsPerLane 16-byte loads.
template <typename T, bool VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, int n, float* v) {
  constexpr int W = kVec<T>;
  constexpr int P = kPerVec<T>;
  if (VEC && n == W) {
#pragma unroll
    for (int j = 0; j < kVecsPerLane; ++j) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p + j * P));
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (sizeof(T) == 4) {
          v[j * P + i] = __uint_as_float(w[i]);
        } else {
          // bf16 -> f32 is exact: the bf16 bits are the high half of the f32
          v[j * P + 2 * i] = __uint_as_float(w[i] << 16);
          v[j * P + 2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] = i < n ? to_f32(p[i]) : 0.f;
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p, int n, const float* v) {
  constexpr int W = kVec<T>;
  constexpr int P = kPerVec<T>;
  if (VEC && n == W) {
#pragma unroll
    for (int j = 0; j < kVecsPerLane; ++j) {
      const float* u = v + j * P;
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (sizeof(T) == 4)
          w[i] = __float_as_uint(u[i]);
        else
          w[i] = bf16_bits(u[2 * i]) | (bf16_bits(u[2 * i + 1]) << 16);
      }
      *reinterpret_cast<uint4*>(p + j * P) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i)
      if (i < n) p[i] = from_f32<T>(v[i]);
  }
}

// Where this lane works: the output row, its feature group and how many of
// those features are real, its edge group, and the number of edge groups.
struct LaneTile {
  int64_t row;
  int col;     // first feature column of this lane's group
  int ncols;   // real features in the group (0..kVec)
  int egroup;  // this lane's edge group
  int ngroups; // edge groups in the warp (32 / L)
};

template <typename T>
__device__ __forceinline__ LaneTile lane_tile(int F, int lanes_per_edge) {
  constexpr int W = kVec<T>;
  LaneTile t;
  const int lane = threadIdx.x & 31;
  t.row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int col0 = blockIdx.y * kColsPerWarp<T>;
  const int slice = min(kColsPerWarp<T>, F - col0);
  const int fg = lane & (lanes_per_edge - 1);
  t.col = col0 + W * fg;
  t.ncols = max(0, min(W, col0 + slice - t.col));
  t.egroup = lane / lanes_per_edge;
  t.ngroups = 32 / lanes_per_edge;
  return t;
}

// Sum the edge groups' partial sums (fixed tree: deterministic).
template <int W>
__device__ __forceinline__ void reduce_groups(float* acc, int lanes_per_edge) {
  for (int off = lanes_per_edge; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < W; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  }
}

template <typename T, bool VEC, bool RELU>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_sum_kernel(const T* __restrict__ data, int64_t data_stride,
                   const int64_t* __restrict__ row_ptr, T* __restrict__ out,
                   int64_t n_rows, int F, int lanes_per_edge) {
  constexpr int W = kVec<T>;
  const LaneTile t = lane_tile<T>(F, lanes_per_edge);
  if (t.row >= n_rows) return;  // whole warp leaves together
  float acc[W];
#pragma unroll
  for (int i = 0; i < W; ++i) acc[i] = 0.f;
  if (t.ncols > 0) {
    const int64_t end = row_ptr[t.row + 1];
#pragma unroll 8
    for (int64_t e = row_ptr[t.row] + t.egroup; e < end; e += t.ngroups) {
      float v[W];
      load_vec<T, VEC>(data + e * data_stride + t.col, t.ncols, v);
#pragma unroll
      for (int i = 0; i < W; ++i) acc[i] += RELU ? relu(v[i]) : v[i];
    }
  }
  reduce_groups<W>(acc, lanes_per_edge);
  if (t.egroup == 0 && t.ncols > 0)
    store_vec<T, VEC>(out + t.row * F + t.col, t.ncols, acc);
}

template <typename T, bool VEC, bool WEIGHTED>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_sum_bias_relu_kernel(const T* __restrict__ data, int64_t data_stride,
                             const T* __restrict__ bias, int64_t bias_stride,
                             const float* __restrict__ weight,
                             const int64_t* __restrict__ row_ptr, T* __restrict__ out,
                             int64_t n_rows, int F, int lanes_per_edge) {
  constexpr int W = kVec<T>;
  const LaneTile t = lane_tile<T>(F, lanes_per_edge);
  if (t.row >= n_rows) return;
  float acc[W];
#pragma unroll
  for (int i = 0; i < W; ++i) acc[i] = 0.f;
  if (t.ncols > 0) {
    // every edge of this row has owner id == row: its bias row is loaded once
    float b[W];
    load_vec<T, VEC>(bias + t.row * bias_stride + t.col, t.ncols, b);
    const int64_t end = row_ptr[t.row + 1];
#pragma unroll 8
    for (int64_t e = row_ptr[t.row] + t.egroup; e < end; e += t.ngroups) {
      float v[W];
      load_vec<T, VEC>(data + e * data_stride + t.col, t.ncols, v);
      const float w = WEIGHTED ? __ldg(weight + e) : 1.f;
#pragma unroll
      for (int i = 0; i < W; ++i) {
        float m = relu(v[i] + b[i]);
        if (WEIGHTED) m *= w;
        acc[i] += to_f32(from_f32<T>(m));  // message rounded to the data dtype
      }
    }
  }
  reduce_groups<W>(acc, lanes_per_edge);
  if (t.egroup == 0 && t.ncols > 0)
    store_vec<T, VEC>(out + t.row * F + t.col, t.ncols, acc);
}

template <typename T>
dim3 grid_for(int64_t n_rows, int F) {
  return dim3(static_cast<unsigned>((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock),
              static_cast<unsigned>((F + kColsPerWarp<T> - 1) / kColsPerWarp<T>));
}

// Lanes per edge group: the smallest power of two covering the slice's
// feature groups.
template <typename T>
int lanes_for(int F) {
  const int groups = (min(F, kColsPerWarp<T>) + kVec<T> - 1) / kVec<T>;
  int L = 1;
  while (L < groups) L <<= 1;
  return L;
}

template <typename T, bool VEC, bool RELU>
void launch_sum(const void* data, int64_t data_stride, const void* row_ptr, void* out,
                int64_t n_rows, int F, cudaStream_t stream) {
  segment_sum_kernel<T, VEC, RELU><<<grid_for<T>(n_rows, F), kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(data), data_stride, static_cast<const int64_t*>(row_ptr),
      static_cast<T*>(out), n_rows, F, lanes_for<T>(F));
}

template <typename T>
void dispatch_sum(const void* data, int64_t data_stride, const void* row_ptr, void* out,
                  int64_t n_rows, int F, int relu_op, int vec, cudaStream_t s) {
  if (vec) {
    if (relu_op) launch_sum<T, true, true>(data, data_stride, row_ptr, out, n_rows, F, s);
    else launch_sum<T, true, false>(data, data_stride, row_ptr, out, n_rows, F, s);
  } else {
    if (relu_op) launch_sum<T, false, true>(data, data_stride, row_ptr, out, n_rows, F, s);
    else launch_sum<T, false, false>(data, data_stride, row_ptr, out, n_rows, F, s);
  }
}

template <typename T, bool VEC, bool WEIGHTED>
void launch_bias_relu(const void* data, int64_t data_stride, const void* bias,
                      int64_t bias_stride, const void* weight, const void* row_ptr,
                      void* out, int64_t n_rows, int F, cudaStream_t stream) {
  segment_sum_bias_relu_kernel<T, VEC, WEIGHTED>
      <<<grid_for<T>(n_rows, F), kWarpsPerBlock * 32, 0, stream>>>(
          static_cast<const T*>(data), data_stride, static_cast<const T*>(bias), bias_stride,
          static_cast<const float*>(weight), static_cast<const int64_t*>(row_ptr),
          static_cast<T*>(out), n_rows, F, lanes_for<T>(F));
}

template <typename T>
void dispatch_bias_relu(const void* data, int64_t data_stride, const void* bias,
                        int64_t bias_stride, const void* weight, const void* row_ptr,
                        void* out, int64_t n_rows, int F, int vec, cudaStream_t s) {
  const bool weighted = weight != nullptr;
  if (vec) {
    if (weighted)
      launch_bias_relu<T, true, true>(data, data_stride, bias, bias_stride, weight, row_ptr,
                                      out, n_rows, F, s);
    else
      launch_bias_relu<T, true, false>(data, data_stride, bias, bias_stride, weight, row_ptr,
                                       out, n_rows, F, s);
  } else {
    if (weighted)
      launch_bias_relu<T, false, true>(data, data_stride, bias, bias_stride, weight, row_ptr,
                                       out, n_rows, F, s);
    else
      launch_bias_relu<T, false, false>(data, data_stride, bias, bias_stride, weight, row_ptr,
                                        out, n_rows, F, s);
  }
}

}  // namespace

extern "C" {

// out [n_rows, F] (contiguous) = sorted segment sum of data [E, F] (row
// stride data_stride elements, unit column stride) over the CSR offsets
// row_ptr [n_rows + 1] (int64). dtype: 0 = float32, 1 = bfloat16.
int dg_sorted_segment_sum(const void* data, long long data_stride, const void* row_ptr,
                          void* out, long long n_rows, int F, int dtype, int relu_op,
                          int vec, void* stream) {
  if (n_rows <= 0 || F <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    dispatch_sum<float>(data, data_stride, row_ptr, out, n_rows, F, relu_op, vec, s);
  else if (dtype == kBF16)
    dispatch_sum<__nv_bfloat16>(data, data_stride, row_ptr, out, n_rows, F, relu_op, vec, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// out [n_rows, F] (contiguous) = sum_e w[e] * relu(data[e] + bias[row]) over the
// CSR offsets row_ptr; bias [n_rows, F] in the data dtype (row stride
// bias_stride); weight [E] float32, or null for the unweighted form.
int dg_sorted_segment_sum_bias_relu(const void* data, long long data_stride,
                                    const void* bias, long long bias_stride,
                                    const void* weight, const void* row_ptr, void* out,
                                    long long n_rows, int F, int dtype, int vec,
                                    void* stream) {
  if (n_rows <= 0 || F <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    dispatch_bias_relu<float>(data, data_stride, bias, bias_stride, weight, row_ptr, out,
                              n_rows, F, vec, s);
  else if (dtype == kBF16)
    dispatch_bias_relu<__nv_bfloat16>(data, data_stride, bias, bias_stride, weight, row_ptr,
                                      out, n_rows, F, vec, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
