// Sorted-segment reductions for Hopper (sm_90a): the CUDA counterparts of the
// two Pallas TPU kernels of dgraph_tpu/ops/pallas_segment.py.
//
//   dg_sorted_segment_sum            replaces _kernel            (pallas_segment.py:39)
//     out[v] = sum_{e: ids[e]=v} op(data[e]),  op in {identity, relu}
//   dg_sorted_segment_sum_bias_relu  replaces _kernel_bias_relu  (pallas_segment.py:259)
//     out[v] = sum_{e: ids[e]=v} w[e] * relu(data[e] + bias[v])
//   dg_sorted_segment_sum_act        replaces its epilogue="act" form (:306-307, :384-388)
//     out[v] = sum_{e: ids[e]=v} w[e] * 1[data[e] + bias[v] > 0]   (f32 output)
//     the backward's d_bias reduction: d_bias = out * g, from one pass over data
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
//     a slice is 128 f32 or 256 bf16 columns; a scalar path, chosen per
//     launch, when a row is unaligned or not a whole number of vectors wide);
//   - when the row is narrower than the slice the warp splits into
//     32 / L edge groups of L lanes, which take every (32/L)-th edge and are
//     summed with a fixed shuffle tree at the end (SAGE's degree count has
//     F = 1: all 32 lanes then walk edges); L is a power of two, and lanes
//     map to groups by shifts;
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
// The act form decides the mask on the same f32 pre-activation as the
// forward (so the forward's and the backward's masks agree), rounds w*act to
// the data dtype like the message, and writes its f32 sum unrounded: a
// degree-sized count would saturate in bf16.
//
// Plain C interface, loaded with ctypes (dgraph_tpu_torch/ops/_build.py).
// Each entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include "vec.cuh"

namespace {

using namespace dg;

constexpr int kWarpsPerBlock = 8;

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
__device__ __forceinline__ LaneTile lane_tile(int F, int lanes_log2) {
  constexpr int W = kVec<T>;
  LaneTile t;
  const int lane = threadIdx.x & 31;
  t.row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int col0 = blockIdx.y * kColsPerWarp<T>;
  const int slice = min(kColsPerWarp<T>, F - col0);
  const int fg = lane & ((1 << lanes_log2) - 1);
  t.col = col0 + W * fg;
  t.ncols = max(0, min(W, col0 + slice - t.col));
  t.egroup = lane >> lanes_log2;
  t.ngroups = 32 >> lanes_log2;
  return t;
}

// Sum the edge groups' partial sums (fixed tree: deterministic).
template <int W>
__device__ __forceinline__ void reduce_groups(float* acc, int lanes_log2) {
  for (int off = 1 << lanes_log2; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < W; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  }
}

template <typename T, bool VEC, bool RELU>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_sum_kernel(const T* __restrict__ data, int64_t data_stride,
                   const int64_t* __restrict__ row_ptr, T* __restrict__ out,
                   int64_t n_rows, int F, int lanes_log2) {
  constexpr int W = kVec<T>;
  const LaneTile t = lane_tile<T>(F, lanes_log2);
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
  reduce_groups<W>(acc, lanes_log2);
  if (t.egroup == 0 && t.ncols > 0)
    store_vec<T, W, VEC>(out + t.row * F + t.col, t.ncols, acc);
}

// O is the data dtype T for the relu form and float for the act form.
template <typename T, typename O, bool VEC, bool WEIGHTED, bool ACT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_sum_bias_relu_kernel(const T* __restrict__ data, int64_t data_stride,
                             const T* __restrict__ bias, int64_t bias_stride,
                             const float* __restrict__ weight,
                             const int64_t* __restrict__ row_ptr, O* __restrict__ out,
                             int64_t n_rows, int F, int lanes_log2) {
  constexpr int W = kVec<T>;
  const LaneTile t = lane_tile<T>(F, lanes_log2);
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
        const float pre = v[i] + b[i];
        float m = ACT ? (pre > 0.f ? 1.f : 0.f) : relu(pre);
        if (WEIGHTED) m *= w;
        acc[i] += to_f32(from_f32<T>(m));  // message rounded to the data dtype
      }
    }
  }
  reduce_groups<W>(acc, lanes_log2);
  if (t.egroup == 0 && t.ncols > 0)
    store_vec<O, W, VEC>(out + t.row * F + t.col, t.ncols, acc);
}

template <typename T>
dim3 grid_for(int64_t n_rows, int F) {
  return dim3(static_cast<unsigned>((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock),
              static_cast<unsigned>((F + kColsPerWarp<T> - 1) / kColsPerWarp<T>));
}

template <typename T, bool VEC, bool RELU>
void launch_sum(const void* data, int64_t data_stride, const void* row_ptr, void* out,
                int64_t n_rows, int F, cudaStream_t stream) {
  segment_sum_kernel<T, VEC, RELU><<<grid_for<T>(n_rows, F), kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(data), data_stride, static_cast<const int64_t*>(row_ptr),
      static_cast<T*>(out), n_rows, F, lanes_log2_for<T>(F));
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

template <typename T, typename O, bool VEC, bool WEIGHTED, bool ACT>
void launch_bias_relu(const void* data, int64_t data_stride, const void* bias,
                      int64_t bias_stride, const void* weight, const void* row_ptr,
                      void* out, int64_t n_rows, int F, cudaStream_t stream) {
  segment_sum_bias_relu_kernel<T, O, VEC, WEIGHTED, ACT>
      <<<grid_for<T>(n_rows, F), kWarpsPerBlock * 32, 0, stream>>>(
          static_cast<const T*>(data), data_stride, static_cast<const T*>(bias), bias_stride,
          static_cast<const float*>(weight), static_cast<const int64_t*>(row_ptr),
          static_cast<O*>(out), n_rows, F, lanes_log2_for<T>(F));
}

template <typename T, typename O, bool ACT>
void dispatch_bias_relu(const void* data, int64_t data_stride, const void* bias,
                        int64_t bias_stride, const void* weight, const void* row_ptr,
                        void* out, int64_t n_rows, int F, int vec, cudaStream_t s) {
  const bool weighted = weight != nullptr;
  if (vec) {
    if (weighted)
      launch_bias_relu<T, O, true, true, ACT>(data, data_stride, bias, bias_stride, weight,
                                              row_ptr, out, n_rows, F, s);
    else
      launch_bias_relu<T, O, true, false, ACT>(data, data_stride, bias, bias_stride, weight,
                                               row_ptr, out, n_rows, F, s);
  } else {
    if (weighted)
      launch_bias_relu<T, O, false, true, ACT>(data, data_stride, bias, bias_stride, weight,
                                               row_ptr, out, n_rows, F, s);
    else
      launch_bias_relu<T, O, false, false, ACT>(data, data_stride, bias, bias_stride, weight,
                                                row_ptr, out, n_rows, F, s);
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
  if (cudaError_t e = bind_device_of(data)) return static_cast<int>(e);
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
  if (cudaError_t e = bind_device_of(data)) return static_cast<int>(e);
  if (dtype == kF32)
    dispatch_bias_relu<float, float, false>(data, data_stride, bias, bias_stride, weight,
                                            row_ptr, out, n_rows, F, vec, s);
  else if (dtype == kBF16)
    dispatch_bias_relu<__nv_bfloat16, __nv_bfloat16, false>(
        data, data_stride, bias, bias_stride, weight, row_ptr, out, n_rows, F, vec, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// out [n_rows, F] float32 (contiguous) = sum_e w[e] * 1[data[e] + bias[row] > 0]
// over the CSR offsets row_ptr; the other arguments as for
// dg_sorted_segment_sum_bias_relu.
int dg_sorted_segment_sum_act(const void* data, long long data_stride, const void* bias,
                              long long bias_stride, const void* weight, const void* row_ptr,
                              void* out, long long n_rows, int F, int dtype, int vec,
                              void* stream) {
  if (n_rows <= 0 || F <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cudaError_t e = bind_device_of(data)) return static_cast<int>(e);
  if (dtype == kF32)
    dispatch_bias_relu<float, float, true>(data, data_stride, bias, bias_stride, weight,
                                           row_ptr, out, n_rows, F, vec, s);
  else if (dtype == kBF16)
    dispatch_bias_relu<__nv_bfloat16, float, true>(data, data_stride, bias, bias_stride,
                                                   weight, row_ptr, out, n_rows, F, vec, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
