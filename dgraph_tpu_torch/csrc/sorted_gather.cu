// Row gathers by sorted ids for Hopper (sm_90a): the CUDA counterparts of two
// more Pallas TPU kernels of dgraph_tpu/ops/pallas_segment.py.
//
//   dg_sorted_row_gather  replaces _gather_kernel     (pallas_segment.py:595)
//     out[e] = x[ids[e]]
//   dg_fused_bwd_gd       replaces _fused_bwd_kernel  (pallas_segment.py:671)
//     gd[e] = g[ids[e]] * 1[data[e] + bias[ids[e]] > 0]
//
// Both write a zero row where ids[e] lies outside [0, N) (the plan's padded
// owner ids). gd is the fused scatter's data gradient; its d_bias partner is
// the act form of dg_sorted_segment_sum_bias_relu (sorted_segment.cu).
//
// The TPU forms are chunk-major one-hot MXU contractions: each edge chunk
// walks the vertex blocks its sorted ids span and selects rows by matmul,
// because the TPU has no per-row gather from a VMEM tile. On Hopper a row
// gather is direct: one group of L lanes owns one output edge row and a
// slice of its feature columns (L = 32 at 128 f32 or 256 bf16 columns; a
// narrow row packs 32 / L rows into one warp; L is a power of two and lanes
// map to rows by shifts). Each lane reads its ids[e],
// moves one 16-byte vector of features (4 f32 or 8 bf16; a scalar path when
// a row is unaligned or not a whole number of vectors wide) and writes the
// output row once. No atomics, no
// shared memory, no reduction: every run gives the same bits.
//
// Bound: device-memory bytes. Each output row is written once (E*F*b) and
// the ids read once (4*E); the vertex rows (N*F*b each for x, or g and bias)
// are read about E/N times, but the ids are sorted, so consecutive rows read
// the same vertex rows and L2 (50 MB) serves the repeats. fused_bwd_gd also
// streams data once (E*F*b). The arithmetic is one add, one compare and one
// multiply per element.
//
// Rounding (fused_bwd_gd) follows the TPU kernel (pallas_segment.py:723-728):
// g and bias arrive rounded to the data dtype, the mask is decided on
// f32(data) + f32(bias), and g * act is exact in the data dtype.
//
// Plain C interface, loaded with ctypes (dgraph_tpu_torch/ops/_build.py).
// Each entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError(). ids are int32.

#include "vec.cuh"

namespace {

using namespace dg;

constexpr int kWarpsPerBlock = 8;

// Where this lane works: its output edge row, its feature group and how
// many of those features are real (0 for an idle lane of a narrow row).
struct EdgeTile {
  int64_t row;
  int col;
  int ncols;
};

template <typename T>
__device__ __forceinline__ EdgeTile edge_tile(int F, int lanes_log2) {
  constexpr int W = kVec<T>;
  const int lane = threadIdx.x & 31;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  EdgeTile t;
  t.row = (warp << (5 - lanes_log2)) + (lane >> lanes_log2);
  const int col0 = blockIdx.y * kColsPerWarp<T>;
  const int slice_end = min(col0 + kColsPerWarp<T>, F);
  t.col = col0 + W * (lane & ((1 << lanes_log2) - 1));
  t.ncols = max(0, min(W, slice_end - t.col));
  return t;
}

// Both kernels load from a clamped, always valid row and select zeros
// afterwards for an out-of-range id, so no branch surrounds the loads.
// N >= 1 (the wrappers return zeros for an empty table).
__device__ __forceinline__ int64_t clamp_row(int64_t id, int64_t n_rows, bool* in_range) {
  *in_range = id >= 0 && id < n_rows;
  return *in_range ? id : 0;
}

// A pure copy: 16-byte vectors move the bits unchanged.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sorted_row_gather_kernel(const T* __restrict__ x, int64_t x_stride,
                         const int32_t* __restrict__ ids, T* __restrict__ out,
                         int64_t n_edges, int64_t n_rows, int F, int lanes_log2) {
  constexpr int W = kVec<T>;
  const EdgeTile t = edge_tile<T>(F, lanes_log2);
  if (t.row >= n_edges || t.ncols == 0) return;  // no shuffles: lanes may leave alone
  bool in_range;
  const T* src = x + clamp_row(ids[t.row], n_rows, &in_range) * x_stride + t.col;
  T* dst = out + t.row * F + t.col;
  if constexpr (VEC) {  // the group is full (see vec.cuh)
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(src));
    *reinterpret_cast<uint4*>(dst) = in_range ? q : make_uint4(0u, 0u, 0u, 0u);
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i)
      if (i < t.ncols) dst[i] = in_range ? src[i] : from_f32<T>(0.f);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_bwd_gd_kernel(const T* __restrict__ data, int64_t data_stride,
                    const T* __restrict__ g, int64_t g_stride,
                    const T* __restrict__ bias, int64_t bias_stride,
                    const int32_t* __restrict__ ids, T* __restrict__ out,
                    int64_t n_edges, int64_t n_rows, int F, int lanes_log2) {
  constexpr int W = kVec<T>;
  const EdgeTile t = edge_tile<T>(F, lanes_log2);
  if (t.row >= n_edges || t.ncols == 0) return;
  bool in_range;
  const int64_t id = clamp_row(ids[t.row], n_rows, &in_range);
  float d[W], gv[W], b[W], r[W];
  load_vec<T, VEC>(data + t.row * data_stride + t.col, t.ncols, d);
  load_vec<T, VEC>(g + id * g_stride + t.col, t.ncols, gv);
  load_vec<T, VEC>(bias + id * bias_stride + t.col, t.ncols, b);
#pragma unroll
  for (int i = 0; i < W; ++i)
    r[i] = in_range ? gv[i] * (d[i] + b[i] > 0.f ? 1.f : 0.f) : 0.f;
  store_vec<T, W, VEC>(out + t.row * F + t.col, t.ncols, r);
}

template <typename T>
dim3 edge_grid(int64_t n_edges, int F, int lanes_log2) {
  const int64_t rows_per_block = static_cast<int64_t>(kWarpsPerBlock) << (5 - lanes_log2);
  return dim3(static_cast<unsigned>((n_edges + rows_per_block - 1) / rows_per_block),
              static_cast<unsigned>((F + kColsPerWarp<T> - 1) / kColsPerWarp<T>));
}

template <typename T, bool VEC>
void launch_gather(const void* x, int64_t x_stride, const void* ids, void* out,
                   int64_t n_edges, int64_t n_rows, int F, cudaStream_t s) {
  const int lg = lanes_log2_for<T>(F);
  sorted_row_gather_kernel<T, VEC><<<edge_grid<T>(n_edges, F, lg), kWarpsPerBlock * 32, 0, s>>>(
      static_cast<const T*>(x), x_stride, static_cast<const int32_t*>(ids),
      static_cast<T*>(out), n_edges, n_rows, F, lg);
}

template <typename T, bool VEC>
void launch_gd(const void* data, int64_t data_stride, const void* g, int64_t g_stride,
               const void* bias, int64_t bias_stride, const void* ids, void* out,
               int64_t n_edges, int64_t n_rows, int F, cudaStream_t s) {
  const int lg = lanes_log2_for<T>(F);
  fused_bwd_gd_kernel<T, VEC><<<edge_grid<T>(n_edges, F, lg), kWarpsPerBlock * 32, 0, s>>>(
      static_cast<const T*>(data), data_stride, static_cast<const T*>(g), g_stride,
      static_cast<const T*>(bias), bias_stride, static_cast<const int32_t*>(ids),
      static_cast<T*>(out), n_edges, n_rows, F, lg);
}

}  // namespace

extern "C" {

// out [n_edges, F] (contiguous) = x[ids] for x [n_rows, F] (row stride
// x_stride elements, unit column stride); zero rows for ids outside
// [0, n_rows); n_rows >= 1. dtype: 0 = float32, 1 = bfloat16.
int dg_sorted_row_gather(const void* x, long long x_stride, const void* ids, void* out,
                         long long n_edges, long long n_rows, int F, int dtype, int vec,
                         void* stream) {
  if (n_edges <= 0 || n_rows <= 0 || F <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cudaError_t e = bind_device_of(x)) return static_cast<int>(e);
  if (dtype == kF32) {
    if (vec) launch_gather<float, true>(x, x_stride, ids, out, n_edges, n_rows, F, s);
    else launch_gather<float, false>(x, x_stride, ids, out, n_edges, n_rows, F, s);
  } else if (dtype == kBF16) {
    if (vec) launch_gather<__nv_bfloat16, true>(x, x_stride, ids, out, n_edges, n_rows, F, s);
    else launch_gather<__nv_bfloat16, false>(x, x_stride, ids, out, n_edges, n_rows, F, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// out [n_edges, F] (contiguous, data dtype) = g[ids] * 1[data + bias[ids] > 0]
// for data [n_edges, F], g and bias [n_rows, F] in the data dtype (each with
// its own row stride); zero rows for ids outside [0, n_rows); n_rows >= 1.
int dg_fused_bwd_gd(const void* data, long long data_stride, const void* g, long long g_stride,
                    const void* bias, long long bias_stride, const void* ids, void* out,
                    long long n_edges, long long n_rows, int F, int dtype, int vec,
                    void* stream) {
  if (n_edges <= 0 || n_rows <= 0 || F <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cudaError_t e = bind_device_of(data)) return static_cast<int>(e);
  if (dtype == kF32) {
    if (vec)
      launch_gd<float, true>(data, data_stride, g, g_stride, bias, bias_stride, ids, out,
                             n_edges, n_rows, F, s);
    else
      launch_gd<float, false>(data, data_stride, g, g_stride, bias, bias_stride, ids, out,
                              n_edges, n_rows, F, s);
  } else if (dtype == kBF16) {
    if (vec)
      launch_gd<__nv_bfloat16, true>(data, data_stride, g, g_stride, bias, bias_stride, ids,
                                     out, n_edges, n_rows, F, s);
    else
      launch_gd<__nv_bfloat16, false>(data, data_stride, g, g_stride, bias, bias_stride, ids,
                                      out, n_edges, n_rows, F, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
