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
// (the wrapper computes row_ptr with a searchsorted once per ids tensor,
// which also drops ids outside [0, N)). The kernels are a CSR segment
// reduction, by one of two paths.
//
// The wide path (all three entry points; dg_sorted_segment_sum above
// kNarrowMaxCols columns or on rows of another stride than F):
//
//   - one warp owns one output row and a slice of feature columns; a lane
//     holds one 16-byte vector of consecutive features (4 f32 or 8 bf16, so
//     a slice is 128 f32 or 256 bf16 columns; a scalar path, chosen per
//     launch, when a row is unaligned or not a whole number of vectors wide);
//   - when the row is narrower than the slice the warp splits into
//     32 / L edge groups of L lanes, which take every (32/L)-th edge and are
//     summed with a fixed shuffle tree at the end; L is a power of two, and
//     lanes map to groups by shifts;
//   - accumulation is in f32 registers, the row is written once, and there
//     are no atomics, so every run gives the same bits. Element offsets are
//     64-bit.
//
// The narrow path (dg_sorted_segment_sum on contiguous rows of F <=
// kNarrowMaxCols; the segment sum of kernel 2 only). At F = 1 (GAT's
// softmax denominator, SAGE's degree count) the wide path gives a warp to
// a row of about 14 edges: most lanes load nothing, a 5-step shuffle tree
// follows for one float, and N = 169,344 rows make about 20 waves of
// warps, each a chain of two dependent loads. It ran at 12 % of its bound,
// slower than one index_add_. The narrow path gives a row G threads of NC
// columns each instead of a warp (NC = F rounded up to a power of two, at
// most one 16-byte vector; G = 1 up to F = 4 f32 / 8 bf16), and a block of
// 256 threads a contiguous range of 256 / G rows. Because the ids are
// sorted, the block's edges are one contiguous range row_ptr[r0] ..
// row_ptr[r0 + 256/G]: the block stages it through shared memory in chunks
// of kStageFloats f32 values with coalesced 16-byte loads (relu applied on
// the way in), then each thread sums its own row's columns from shared
// memory in edge order. At the GAT shape the N rows fit in about one wave
// of 662 blocks, and a block is two dependent global round trips
// (row_ptr, then its edges). It was chosen over a thread per row that
// reads device memory directly: at F = 1 those loads are 4 bytes at a
// stride of a row's degree, 32 sectors a warp instruction, where the
// staged loads are 512 contiguous bytes. What the sweep taught: scalar
// staging loads and NC = 16 bytes at every F left F >= 8 slower than the
// wide path (load issue and 4-way shared-memory bank conflicts on scalar
// reads); 16-byte staging, NC sized to F and float4 reads of the stage
// made it faster at every F up to 64 f32 / 16 bf16. Asking ptxas for six
// blocks an SM at NC = 1 (to fit the 662 blocks in one wave) made it spill
// and run slower.
//
// Hubs: a row whose edges in one chunk exceed kLongSegment is summed by
// its whole warp (lanes ballot for such rows; for each, in lane order,
// 32 / G edge groups take every (32/G)-th edge and a fixed shuffle tree
// adds them), so a row of 10^4 edges costs a warp 10^4 / 32 steps a
// column group, not one lane 10^4. The order of every row's sum is fixed
// by row_ptr and F alone (chunk bounds, the long-segment test), so two
// launches give the same bits; no atomics; f32 accumulation; rows at any
// 16-byte alignment (scalar staging loads when the data does not start on
// a 16-byte boundary, chosen once a launch); 64-bit element offsets. Rows
// with another stride than F (a column of a wider tensor) take the wide
// path: staged, each element is a sector of its own, and the wide path
// read them faster (0.060 against 0.081 ms at F = 1, stride 128).
//
// The cut-over, kNarrowMaxCols: the widths at which the narrow path was the
// faster one in the width sweep (`python -m dgraph_tpu_torch.ops.kernel_ab`,
// kernel time, contiguous [E, F] rows, E = 2,332,672 uniform sorted ids over
// N = 169,344 rows; NVIDIA H100 80GB HBM3 at 700 W), wide -> narrow ms. The
// wide row is the tree before the narrow path; the narrow row a copy of this
// file with kNarrowMaxCols raised to a warp's slice (128 f32, 256 bf16),
// each given to kernel_ab as the other tree:
//   F     1       2       4       8       16      32      64      128
//   f32   0.0462  0.0462  0.0377  0.0436  0.0649  0.1127  0.2157  0.4254  wide
//         0.0059  0.0099  0.0179  0.0331  0.0591  0.1104  0.2131  0.4193  narrow
//   bf16  0.0483  0.0485  0.0489  0.0471  0.0492  0.0663  0.1140  0.2153  wide
//         0.0073  0.0096  0.0122  0.0291  0.0458  0.0725  0.1345  0.2561  narrow
// so F <= 64 in f32 and F <= 16 in bf16 (the stage holds f32, twice the
// bf16 rows' bytes, and the bf16 wide path reads 8 columns a lane). F = 128
// was timed after the cut-over was set; its 1.4 % in f32 is left to a
// dispatch by degree, which the wide path's hubs need (ROADMAP Queue B:
// on power-law ids the narrow path took 1.75 ms there, the wide 18.6).
//
// Bound: device-memory bytes. Each edge row is read once (E*F*b), plus the
// CSR offsets (8*(N+1)), the weights (4*E) and the bias and output rows
// (2*N*F*b); the arithmetic is a few operations per element loaded.
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

#include <type_traits>

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

// --- the narrow path -------------------------------------------------------

constexpr int kNarrowThreads = 256;
// f32 values of a block's shared-memory chunk (32 KB: 7 blocks an SM)
constexpr int kStageFloats = 8192;
// loads in flight a thread while a chunk is staged: 16-byte vectors, or
// scalars when the data is not 16-byte aligned
constexpr int kStageVectors = 4;
constexpr int kStageScalars = 16;
// in-chunk edges above which a row is summed by its whole warp: below it a
// lane's serial sum (about 4 cycles an edge) takes no longer than one
// cooperative pass (a few strided loads and a 5-step shuffle tree)
constexpr int kLongSegment = 64;

// Elements [s, s + n) of data (as f32, relu applied when asked) into
// stage[sh, sh + n), returning sh. VEC (data 16-byte aligned): whole
// 16-byte vectors from s rounded down to a vector, so sh = s % kVec<T> and
// up to a vector's worth of neighbours on each side is staged and never
// read (a 16-byte vector that holds one element of the tensor lies inside
// its allocation); else one scalar load an element and sh = 0. Each thread
// keeps a batch of loads in flight, held raw until they are stored.
template <typename T, bool VEC, bool RELU>
__device__ __forceinline__ int stage_chunk(const T* __restrict__ data, int64_t s, int n,
                                           float* stage) {
  constexpr int V = VEC ? kVec<T> : 1;  // elements a load
  constexpr int kStageBatch = VEC ? kStageVectors : kStageScalars;
  using Raw = std::conditional_t<VEC, uint4, T>;
  const int sh = static_cast<int>(s % V);
  const Raw* src = reinterpret_cast<const Raw*>(data + (s - sh));
  const int units = (sh + n + V - 1) / V;
  for (int base = 0; base < units; base += kNarrowThreads * kStageBatch) {
    Raw q[kStageBatch];
#pragma unroll
    for (int k = 0; k < kStageBatch; ++k) {
      const int u = base + k * kNarrowThreads + threadIdx.x;
      if (u < units) q[k] = __ldg(src + u);
    }
#pragma unroll
    for (int k = 0; k < kStageBatch; ++k) {
      const int u = base + k * kNarrowThreads + threadIdx.x;
      if (u >= units) continue;
      float v[V];
      if constexpr (VEC) {
        const uint32_t w[4] = {q[k].x, q[k].y, q[k].z, q[k].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (sizeof(T) == 4) {
            v[i] = __uint_as_float(w[i]);
          } else {  // bf16 -> f32 is exact: the bf16 bits are the high half
            v[2 * i] = __uint_as_float(w[i] << 16);
            v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
          }
        }
      } else {
        v[0] = to_f32(q[k]);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = RELU ? relu(v[j]) : v[j];
      float* dst = stage + u * V;
      if constexpr (VEC) {
#pragma unroll
        for (int j = 0; j < V; j += 4)
          *reinterpret_cast<float4*>(dst + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      } else {
        dst[0] = v[0];
      }
    }
  }
  return sh;
}

// acc[0, NC) += the first ncols floats at x. V4: ncols == NC, a multiple
// of 4, and x 16-byte aligned: NC / 4 vector reads of shared memory.
template <int NC>
__device__ __forceinline__ void add_cols(float* acc, const float* x, int ncols, bool v4) {
  if constexpr (NC % 4 == 0) {
    if (v4) {
#pragma unroll
      for (int j = 0; j < NC; j += 4) {
        const float4 q = *reinterpret_cast<const float4*>(x + j);
        acc[j] += q.x;
        acc[j + 1] += q.y;
        acc[j + 2] += q.z;
        acc[j + 3] += q.w;
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < NC; ++i)
    if (i < ncols) acc[i] += x[i];
}

// A block of kNarrowThreads threads owns rows [r0, r0 + R), R = 256 >> lanes_log2;
// thread t owns row r0 + (t >> lanes_log2) and its column group t & (G-1)
// (NC columns), G = 1 << lanes_log2. Rows are contiguous (row stride F).
template <typename T, int NC, bool VEC, bool RELU>
__global__ void __launch_bounds__(kNarrowThreads)
segment_sum_narrow_kernel(const T* __restrict__ data, const int64_t* __restrict__ row_ptr,
                          T* __restrict__ out, int64_t n_rows, int F, int lanes_log2) {
  // + 2 vectors: the staged neighbours of the chunk's first and last element
  __shared__ __align__(16) float stage[kStageFloats + 2 * kVec<T>];
  const int lane = threadIdx.x & 31;
  const int64_t rows = kNarrowThreads >> lanes_log2;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int64_t row = r0 + (threadIdx.x >> lanes_log2);
  const int g = threadIdx.x & ((1 << lanes_log2) - 1);
  const int col = g * NC;
  const int ncols = max(0, min(NC, F - col));
  // every group whole and 16-byte aligned in the stage (F % 4 == 0 makes
  // the chunk's start, and so sh, a multiple of 4 floats)
  const bool v4 = NC % 4 == 0 && F % NC == 0;
  const bool live = row < n_rows;
  const int64_t rs = live ? row_ptr[row] : 0;
  const int64_t re = live ? row_ptr[row + 1] : 0;
  const int64_t e0 = row_ptr[r0];
  const int64_t e1 = row_ptr[min(r0 + rows, n_rows)];
  const int chunk = kStageFloats / F;  // edges a chunk
  float acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) acc[i] = 0.f;
  for (int64_t c0 = e0; c0 < e1; c0 += chunk) {
    const int n_edges = static_cast<int>(min(static_cast<int64_t>(chunk), e1 - c0));
    __syncthreads();  // the previous chunk's readers are done
    const float* staged = stage + stage_chunk<T, VEC, RELU>(data, c0 * F, n_edges * F, stage);
    __syncthreads();
    // this row's edges within the chunk, as edge offsets into it
    const int a = static_cast<int>(min(max(rs - c0, int64_t{0}), static_cast<int64_t>(n_edges)));
    const int b = static_cast<int>(min(max(re - c0, int64_t{0}), static_cast<int64_t>(n_edges)));
    const bool is_long = b - a > kLongSegment;
    if (!is_long && ncols > 0) {
#pragma unroll 4
      for (int e = a; e < b; ++e) add_cols<NC>(acc, staged + e * F + col, ncols, v4);
    }
    // long rows, one at a time in lane order: every lane of column group g
    // takes every (32/G)-th edge of the row, then a fixed tree adds them
    unsigned todo = __ballot_sync(0xffffffffu, is_long && g == 0);
    while (todo) {
      const int src = __ffs(todo) - 1;  // the row's first lane (column group 0)
      todo &= todo - 1;
      const int sa = __shfl_sync(0xffffffffu, a, src);
      const int sb = __shfl_sync(0xffffffffu, b, src);
      float part[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) part[i] = 0.f;
      if (ncols > 0) {
#pragma unroll 4
        for (int e = sa + (lane >> lanes_log2); e < sb; e += 32 >> lanes_log2)
          add_cols<NC>(part, staged + e * F + col, ncols, v4);
      }
      reduce_groups<NC>(part, lanes_log2);
      if (lane == src + g) {
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[i] += part[i];
      }
    }
  }
  if (live && ncols > 0) {
#pragma unroll
    for (int i = 0; i < NC; ++i)
      if (i < ncols) out[row * F + col + i] = from_f32<T>(acc[i]);
  }
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

// The widest contiguous rows the narrow path takes in dg_sorted_segment_sum:
// the width sweep's times in the note at the top of this file.
template <typename T>
constexpr int kNarrowMaxCols = sizeof(T) == 4 ? 64 : 16;

// Columns a thread of the narrow path: F rounded up to a power of two, at
// most one 16-byte vector of the data dtype; G = F / NC rounded up to a
// power of two threads share a row.
template <typename T>
int narrow_cols(int F) {
  int nc = 1;
  while (nc < F && nc < kVec<T>) nc <<= 1;
  return nc;
}

template <typename T, int NC, bool VEC, bool RELU>
void launch_narrow(const void* data, const void* row_ptr, void* out, int64_t n_rows, int F,
                   cudaStream_t stream) {
  int lanes_log2 = 0;
  while ((NC << lanes_log2) < F) ++lanes_log2;
  const int64_t rows = kNarrowThreads >> lanes_log2;
  segment_sum_narrow_kernel<T, NC, VEC, RELU>
      <<<static_cast<unsigned>((n_rows + rows - 1) / rows), kNarrowThreads, 0, stream>>>(
          static_cast<const T*>(data), static_cast<const int64_t*>(row_ptr),
          static_cast<T*>(out), n_rows, F, lanes_log2);
}

template <typename T, int NC>
void dispatch_narrow_cols(const void* data, const void* row_ptr, void* out, int64_t n_rows,
                          int F, int relu_op, cudaStream_t s) {
  // the staging loads are 16-byte vectors when the data starts 16-byte
  // aligned (chosen once a launch), else scalars
  if (reinterpret_cast<uintptr_t>(data) % 16 == 0) {
    if (relu_op) launch_narrow<T, NC, true, true>(data, row_ptr, out, n_rows, F, s);
    else launch_narrow<T, NC, true, false>(data, row_ptr, out, n_rows, F, s);
  } else {
    if (relu_op) launch_narrow<T, NC, false, true>(data, row_ptr, out, n_rows, F, s);
    else launch_narrow<T, NC, false, false>(data, row_ptr, out, n_rows, F, s);
  }
}

template <typename T>
void dispatch_narrow(const void* data, const void* row_ptr, void* out, int64_t n_rows, int F,
                     int relu_op, cudaStream_t s) {
  switch (narrow_cols<T>(F)) {
    case 1: dispatch_narrow_cols<T, 1>(data, row_ptr, out, n_rows, F, relu_op, s); break;
    case 2: dispatch_narrow_cols<T, 2>(data, row_ptr, out, n_rows, F, relu_op, s); break;
    case 4: dispatch_narrow_cols<T, 4>(data, row_ptr, out, n_rows, F, relu_op, s); break;
    default: dispatch_narrow_cols<T, kVec<T>>(data, row_ptr, out, n_rows, F, relu_op, s);
  }
}

template <typename T>
void dispatch_wide(const void* data, int64_t data_stride, const void* row_ptr, void* out,
                   int64_t n_rows, int F, int relu_op, int vec, cudaStream_t s) {
  if (vec) {
    if (relu_op) launch_sum<T, true, true>(data, data_stride, row_ptr, out, n_rows, F, s);
    else launch_sum<T, true, false>(data, data_stride, row_ptr, out, n_rows, F, s);
  } else {
    if (relu_op) launch_sum<T, false, true>(data, data_stride, row_ptr, out, n_rows, F, s);
    else launch_sum<T, false, false>(data, data_stride, row_ptr, out, n_rows, F, s);
  }
}

// contiguous rows of F <= kNarrowMaxCols take the narrow path, every other
// call the wide one
template <typename T>
void dispatch_sum(const void* data, int64_t data_stride, const void* row_ptr, void* out,
                  int64_t n_rows, int F, int relu_op, int vec, cudaStream_t s) {
  if (data_stride == F && F <= kNarrowMaxCols<T>)
    dispatch_narrow<T>(data, row_ptr, out, n_rows, F, relu_op, s);
  else
    dispatch_wide<T>(data, data_stride, row_ptr, out, n_rows, F, relu_op, vec, s);
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
// row_ptr [n_rows + 1] (int64). dtype: 0 = float32, 1 = bfloat16. The
// narrow path on contiguous rows of F <= kNarrowMaxCols (vec unused there),
// the wide one otherwise.
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
