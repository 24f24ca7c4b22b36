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
// Long rows: a row whose edges in one chunk exceed kLongSegment is summed by
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
// was timed after the cut-over was set (narrow 1.4 % faster in f32); on
// power-law ids the narrow path took 1.75 ms there and the wide 18.6, which
// the hub route below answers instead.
//
// The hub route (all three entry points). A row of more than HUB_DEGREE
// edges (ops/segment.py) is a hub: on power-law ids a warp-per-row loop
// spends about 0.4 us an edge at F = 128 f32 (one warp's chain of loads), so
// a row of 45,850 edges held kernel 2 at 18.6 ms while index_add_ took 2.42,
// and a narrow block that staged such a row was the F = 1 tail. The wrapper
// computes a hub plan once per ids tensor beside the CSR offsets: each hub
// cut into chunks of at most HUB_CHUNK edges, each chunk's row and edge
// range, each hub's first chunk. Two passes, no atomics:
//
//   - partial: the first warps of the kernel's own grid (the wide kernels'
//     first n_chunks warps, the narrow kernel's first ceil(n_chunks / 8)
//     blocks) each sum one chunk with the entry point's per-edge op and the
//     lane map its path gives a row, into an f32 row of a [n_chunks, F]
//     workspace that the wrapper allocates. They run beside the row warps,
//     so a hub costs its bytes, not a serial chain;
//   - the row kernels leave hub rows alone: the wide kernels test the two
//     row_ptr values they load; a narrow block tests whether it holds more
//     edges than a hub can have and, only then, finds its hubs (a ballot)
//     and stages each chunk's pieces outside them at the offsets the whole
//     chunk would have had, so its other rows read the same in-chunk ranges
//     in the same order. A chunk inside one hub is skipped. Every kernel
//     has a form with the route and one without (HUBS, chosen per launch
//     by the plan), so a call without hubs runs the code it ran before:
//     in one kernel, the route's code cost the plain rows 3-16 % (its
//     registers and its call out of line), in the sweep below;
//   - combine (hub_combine_kernel, a second launch on the stream): a block
//     a (hub, column slice) adds the hub's partial rows, each lane group a
//     fixed stride of chunks in order with loads in flight, then a fixed
//     tree and the warps in order, and writes the row once, in the data
//     dtype (f32 for the act form).
//
// Every row of HUB_DEGREE edges or fewer keeps its path's code and bits; a
// hub's sum order is fixed by the plan, which depends on row_ptr and the two
// constants alone, so two launches give the same bits. The plan carries the
// degree to the kernels (it is an argument, not a second copy of the
// constant), and a call without hubs pays one comparison a row or block.
//
// HUB_DEGREE = HUB_CHUNK = 256, from the sweep (`python -m
// dgraph_tpu_torch.ops.kernel_ab <parent csrc> --hub-sweep`: every (degree,
// chunk) of kernel_ab.HUB_SWEEP on one library, since the plan carries both;
// kernel time, E = 2,332,672; NVIDIA H100 80GB HBM3 at 700 W), kernel 2 in
// f32 / bf16 ms, on power-law ids (kernel_ab.power_law_ids, N = 169,344, a
// row of 45,866 edges) and on the skewed arxiv graph's plan ids (largest row
// 15,001):
//   degree/chunk        64/64          128/128        256/256        512/512        1024/512       parent
//   F = 128 power-law   0.4636/0.2511  0.4737/0.2503  0.5103/0.2662  0.5763/0.3027  0.7648/0.3981  18.61/9.475
//   F = 128 graph       0.4324/0.2280  0.4294/0.2235  0.4279/0.2207  0.4897/0.2479  0.6838/0.3461  6.243/3.173
//   F = 16 power-law    0.1021/0.1238  0.0875/0.1021  0.0805/0.0900  0.0770/0.0829  0.0753/0.0792  0.2926/0.2436
//   F = 1 power-law     0.0352/0.0408  0.0233/0.0257  0.0196/0.0204  0.0168/0.0174  0.0161/0.0167  0.0223/0.0258
// The wide path wants a low degree: a row left to one warp costs about
// 0.4 us an edge at F = 128, so rows of 512-1024 edges become the tail. The
// narrow path wants a high one: its warp-wide long-row route already sums
// rows of a few hundred edges well, and each hub adds a chunk warp and
// combine work. 256/256 is the pair that serves both: level with the best
// on the graph at F = 128, where GCN's sums run, 8 % slower than 128/128 on
// the synthetic power-law ids' F = 128, and faster than the parent at F = 16
// and F = 1, where 128/128 was slower than the parent. It also leaves the
// SBM graph's plans alone where they pad little: a padded plan gives every
// padded edge src id 0, so src row 0 holds 199 edges in bench_gcn's plan
// (no hub at 256) and 836 in the CLI's one-rank SBM plan (a hub of four
// chunks of zero rows). A smaller chunk costs the combine pass more partial
// rows; a larger one makes each chunk warp a longer serial chain. Before the
// combine became a block of warps with loads in flight, it was the tail:
// 64-edge chunks cost 0.2 ms more than 256-edge ones at F = 128.
//
// Bound: device-memory bytes of the function, not of this route. Each edge
// row is read once (E*F*b), plus the CSR offsets (8*(N+1)), the weights
// (4*E) and the bias and output rows (2*N*F*b); the hub route's partial rows
// (2*n_chunks*F*4 bytes, written and read back) are this implementation's
// own traffic and stay out of it. The arithmetic is a few operations per
// element loaded.
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
// Each entry point launches on the caller's stream (the kernel, then the
// combine pass when the plan has hubs), allocates nothing and returns
// cudaGetLastError().

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

// --- the hub route ----------------------------------------------------------

// The hub plan (ops/segment.py `hub_plan`, once per ids tensor): the rows of
// more than `degree` edges, cut into chunks of at most HUB_CHUNK edges.
struct HubPlan {
  const int64_t* row;    // [n_chunks] each chunk's output row
  const int64_t* start;  // [n_chunks] its first edge
  const int64_t* end;    // [n_chunks] one past its last edge
  const int64_t* first;  // [n_hubs + 1] each hub's first chunk, then n_chunks
  float* ws;             // [n_chunks, F] each chunk's f32 partial row
  int64_t n_chunks;
  int64_t n_hubs;
  int64_t degree;  // a row of more edges is a hub; INT64_MAX when there are none
  int64_t blocks;  // narrow path: blocks of chunk warps ahead of the row blocks
};

// The per-edge ops of the entry points as the partial pass applies them, the
// same expressions as the row kernels': kernel 2's op(data[e]); kernels 1
// and 1a's w[e] * relu(pre) or w[e] * 1[pre > 0], pre = data[e] + bias[row],
// rounded to the data dtype.
template <int W, bool RELU>
struct SumOp {
  __device__ __forceinline__ void operator()(float* acc, const float* v, int64_t) const {
#pragma unroll
    for (int i = 0; i < W; ++i) acc[i] += RELU ? relu(v[i]) : v[i];
  }
};

template <typename T, bool WEIGHTED, bool ACT>
struct BiasOp {
  float b[kVec<T>];  // the chunk row's bias group
  const float* weight;
  __device__ __forceinline__ void operator()(float* acc, const float* v, int64_t e) const {
    const float w = WEIGHTED ? __ldg(weight + e) : 1.f;
#pragma unroll
    for (int i = 0; i < kVec<T>; ++i) {
      const float pre = v[i] + b[i];
      float m = ACT ? (pre > 0.f ? 1.f : 0.f) : relu(pre);
      if (WEIGHTED) m *= w;
      acc[i] += to_f32(from_f32<T>(m));  // message rounded to the data dtype
    }
  }
};

// The partial pass in the wide kernels: the warp that would own a row sums
// chunk c instead, with the row's lane map, loop and op, into workspace row c.
template <typename T, bool VEC, class Op>
__device__ __forceinline__ void chunk_partial(const T* __restrict__ data, int64_t data_stride,
                                              const LaneTile& t, int64_t c, const HubPlan& hub,
                                              int F, int lanes_log2, const Op& op) {
  constexpr int W = kVec<T>;
  float acc[W];
#pragma unroll
  for (int i = 0; i < W; ++i) acc[i] = 0.f;
  if (t.ncols > 0) {
    const int64_t end = hub.end[c];
#pragma unroll 8
    for (int64_t e = hub.start[c] + t.egroup; e < end; e += t.ngroups) {
      float v[W];
      load_vec<T, VEC>(data + e * data_stride + t.col, t.ncols, v);
      op(acc, v, e);
    }
  }
  reduce_groups<W>(acc, lanes_log2);
  if (t.egroup == 0 && t.ncols > 0)
    store_vec<float, W, VEC>(hub.ws + c * F + t.col, t.ncols, acc);
}

// The combine pass: a block of 8 warps a (hub, column slice), lanes over
// columns as lane_tile maps them. Lane group e of warp w adds chunks first +
// (w * G + e) + k * 8G (G groups a warp) in order, four loads in flight; a
// fixed tree adds a warp's groups, then warp 0 adds the warps' sums in warp
// order through shared memory and writes the row once in O (the data
// dtype, or f32 for the act form). VEC: the wrapper's vector flag, which
// makes every workspace and output row a whole number of 16-byte vectors.
template <typename O, bool VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
hub_combine_kernel(HubPlan hub, O* __restrict__ out, int F, int lanes_log2) {
  constexpr int W = kVec<O>;
  constexpr int kBatch = 4;
  __shared__ __align__(16) float part[kWarpsPerBlock][kColsPerWarp<O>];
  const LaneTile t = lane_tile<O>(F, lanes_log2);  // columns and lane groups
  const int warp = threadIdx.x >> 5;
  const int64_t h = blockIdx.x;
  const int64_t c0 = hub.first[h], c1 = hub.first[h + 1];
  const int groups = kWarpsPerBlock * t.ngroups;
  float acc[W];
#pragma unroll
  for (int i = 0; i < W; ++i) acc[i] = 0.f;
  if (t.ncols > 0) {
    for (int64_t c = c0 + warp * t.ngroups + t.egroup; c < c1; c += kBatch * groups) {
      float v[kBatch][W];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (c + k * groups >= c1) continue;
#pragma unroll
        for (int j = 0; j < W; j += 4)
          load_vec<float, VEC>(hub.ws + (c + k * groups) * F + t.col + j,
                               max(0, min(4, t.ncols - j)), v[k] + j);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (c + k * groups >= c1) continue;
#pragma unroll
        for (int i = 0; i < W; ++i) acc[i] += v[k][i];
      }
    }
  }
  reduce_groups<W>(acc, lanes_log2);
  const int lc = t.col - blockIdx.y * kColsPerWarp<O>;  // the group's column in the slice
  if (t.egroup == 0 && t.ncols > 0) {
#pragma unroll
    for (int i = 0; i < W; ++i) part[warp][lc + i] = acc[i];
  }
  __syncthreads();
  if (warp == 0 && t.egroup == 0 && t.ncols > 0) {
#pragma unroll
    for (int i = 0; i < W; ++i) acc[i] = part[0][lc + i];
    for (int w = 1; w < kWarpsPerBlock; ++w) {
#pragma unroll
      for (int i = 0; i < W; ++i) acc[i] += part[w][lc + i];
    }
    store_vec<O, W, VEC>(out + hub.row[c0] * F + t.col, t.ncols, acc);
  }
}

// HUBS (a plan with hubs, chosen at launch): the first n_chunks warps sum the
// hub chunks, and the row warps leave hub rows alone. Without it the kernel
// is the one it was before the hub route.
template <typename T, bool VEC, bool RELU, bool HUBS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_sum_kernel(const T* __restrict__ data, int64_t data_stride,
                   const int64_t* __restrict__ row_ptr, T* __restrict__ out,
                   int64_t n_rows, int F, int lanes_log2, HubPlan hub) {
  constexpr int W = kVec<T>;
  LaneTile t = lane_tile<T>(F, lanes_log2);
  if constexpr (HUBS) {
    if (t.row < hub.n_chunks) {  // warp-uniform
      chunk_partial<T, VEC>(data, data_stride, t, t.row, hub, F, lanes_log2, SumOp<W, RELU>{});
      return;
    }
    t.row -= hub.n_chunks;
  }
  if (t.row >= n_rows) return;  // whole warp leaves together
  if (HUBS && row_ptr[t.row + 1] - row_ptr[t.row] > hub.degree) return;  // its chunks sum it
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

// The partial pass in the narrow kernel: warp w of chunk block blockIdx.x
// sums chunk 8 blockIdx.x + w with the narrow kernel's lane map (G = 1 <<
// lanes_log2 lanes of NC columns, 32 / G edge groups), reading device memory
// directly, into workspace row c.
template <typename T, int NC, bool RELU>
__device__ __forceinline__ void narrow_chunk_partial(const T* __restrict__ data, int F,
                                                     int lanes_log2, const HubPlan& hub) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (c >= hub.n_chunks) return;  // whole warp
  const int lane = threadIdx.x & 31;
  const int col = (lane & ((1 << lanes_log2) - 1)) * NC;
  const int ncols = max(0, min(NC, F - col));
  float acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) acc[i] = 0.f;
  if (ncols > 0) {
    const int64_t end = hub.end[c];
#pragma unroll 4
    for (int64_t e = hub.start[c] + (lane >> lanes_log2); e < end; e += 32 >> lanes_log2) {
      float v[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) v[i] = i < ncols ? to_f32(data[e * F + col + i]) : 0.f;
      SumOp<NC, RELU>{}(acc, v, e);
    }
  }
  reduce_groups<NC>(acc, lanes_log2);
  if ((lane >> lanes_log2) == 0) {
#pragma unroll
    for (int i = 0; i < NC; ++i)
      if (i < ncols) hub.ws[c * F + col + i] = acc[i];
  }
}

// The hub rows of a narrow block, in row order: bit l of bits[w] is set when
// thread 32 w + l holds column group 0 of a hub row. Calls f(hs, he) with
// the edge range of each hub that ends after c0 and starts before c1, in
// order, until f returns false. Every thread walks the same hubs.
template <class Fn>
__device__ __forceinline__ void for_hubs(const uint32_t* bits, const int64_t* __restrict__ row_ptr,
                                         int64_t r0, int lanes_log2, int64_t c0, int64_t c1,
                                         Fn f) {
  for (int w = 0; w < kNarrowThreads / 32; ++w) {
    for (uint32_t m = bits[w]; m; m &= m - 1) {
      const int64_t row = r0 + ((w * 32 + __ffs(m) - 1) >> lanes_log2);
      const int64_t hs = row_ptr[row], he = row_ptr[row + 1];
      if (hs >= c1) return;
      if (he > c0 && !f(hs, he)) return;
    }
  }
}

// Stage chunk [c0, c1) as stage_chunk would, but only its pieces outside
// every hub row: each piece lands where the whole chunk would have put it
// (stage + sh(c0) + (edge - c0) * F), so the other rows read the same stage
// offsets, the same in-chunk ranges and the same sum order as without hubs.
// Returns the chunk's staged base. A piece's vectors that overhang into a
// hub's range write that range's true values, which no thread reads.
template <typename T, bool VEC, bool RELU>
__device__ __forceinline__ const float* stage_pieces(const T* __restrict__ data,
                                                     const int64_t* __restrict__ row_ptr,
                                                     const uint32_t* bits, int64_t r0,
                                                     int lanes_log2, int64_t c0, int64_t c1,
                                                     int F, float* stage) {
  constexpr int V = VEC ? kVec<T> : 1;
  float* staged = stage + (c0 * F) % V;
  auto piece = [&](int64_t p, int64_t q) {
    stage_chunk<T, VEC, RELU>(data, p * F, static_cast<int>((q - p) * F),
                              staged + (p - c0) * F - (p * F) % V);
  };
  int64_t p = c0;
  for_hubs(bits, row_ptr, r0, lanes_log2, c0, c1, [&](int64_t hs, int64_t he) {
    if (hs > p) piece(p, hs);
    p = max(p, he);
    return true;
  });
  if (p < c1) piece(p, c1);
  return staged;
}

// A block of kNarrowThreads threads owns rows [r0, r0 + R), R = 256 >> lanes_log2;
// thread t owns row r0 + (t >> lanes_log2) and its column group t & (G-1)
// (NC columns), G = 1 << lanes_log2. Rows are contiguous (row stride F).
// HUBS: the block holds hub rows (bits), whose edges stay out of the stage
// and whose outputs the combine pass writes; the other rows see the same
// chunks, in-chunk ranges and sum order as without them.
template <typename T, int NC, bool VEC, bool RELU, bool HUBS>
__device__ __forceinline__ void narrow_rows(const T* __restrict__ data,
                                            const int64_t* __restrict__ row_ptr,
                                            T* __restrict__ out, int64_t n_rows, int F,
                                            int lanes_log2, int64_t r0, int64_t degree,
                                            const uint32_t* bits, float* stage) {
  const int lane = threadIdx.x & 31;
  const int64_t rows = kNarrowThreads >> lanes_log2;
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
  const bool is_hub = HUBS && live && re - rs > degree;
  const int chunk = kStageFloats / F;  // edges a chunk
  float acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) acc[i] = 0.f;
  for (int64_t c0 = e0; c0 < e1; c0 += chunk) {
    const int n_edges = static_cast<int>(min(static_cast<int64_t>(chunk), e1 - c0));
    if constexpr (HUBS) {
      // a chunk inside one hub's range: on to the chunk that holds its end
      int64_t cover = -1;
      for_hubs(bits, row_ptr, r0, lanes_log2, c0, c0 + n_edges, [&](int64_t hs, int64_t he) {
        if (hs <= c0 && he >= c0 + n_edges) cover = he;
        return false;
      });
      if (cover >= 0) {
        c0 = max(c0, e0 + ((cover - e0) / chunk - 1) * chunk);
        continue;
      }
    }
    __syncthreads();  // the previous chunk's readers are done
    const float* staged;
    if constexpr (HUBS)
      staged = stage_pieces<T, VEC, RELU>(data, row_ptr, bits, r0, lanes_log2, c0, c0 + n_edges,
                                          F, stage);
    else
      staged = stage + stage_chunk<T, VEC, RELU>(data, c0 * F, n_edges * F, stage);
    __syncthreads();
    // this row's edges within the chunk, as edge offsets into it (none for a hub)
    const int a = static_cast<int>(min(max(rs - c0, int64_t{0}), static_cast<int64_t>(n_edges)));
    const int b = is_hub ? a
                         : static_cast<int>(min(max(re - c0, int64_t{0}),
                                                static_cast<int64_t>(n_edges)));
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
  if (live && !is_hub && ncols > 0) {
#pragma unroll
    for (int i = 0; i < NC; ++i)
      if (i < ncols) out[row * F + col + i] = from_f32<T>(acc[i]);
  }
}

// HUBS (a plan with hubs, chosen at launch): the first hub.blocks blocks sum
// the hub chunks, and a block whose rows hold a hub takes narrow_rows' hub
// form. Without it the kernel is the one it was before the hub route.
template <typename T, int NC, bool VEC, bool RELU, bool HUBS>
__global__ void __launch_bounds__(kNarrowThreads)
segment_sum_narrow_kernel(const T* __restrict__ data, const int64_t* __restrict__ row_ptr,
                          T* __restrict__ out, int64_t n_rows, int F, int lanes_log2,
                          HubPlan hub) {
  // + 2 vectors: the staged neighbours of the chunk's first and last element
  __shared__ __align__(16) float stage[kStageFloats + 2 * kVec<T>];
  __shared__ uint32_t hub_bits[HUBS ? kNarrowThreads / 32 : 1];
  const int64_t rows = kNarrowThreads >> lanes_log2;
  if constexpr (HUBS) {
    if (blockIdx.x < hub.blocks) {  // block-uniform
      narrow_chunk_partial<T, NC, RELU>(data, F, lanes_log2, hub);
      return;
    }
    const int64_t r0 = static_cast<int64_t>(blockIdx.x - hub.blocks) * rows;
    // only a block of more edges than a hub's can hold one (block-uniform)
    if (row_ptr[min(r0 + rows, n_rows)] - row_ptr[r0] > hub.degree) {
      const int64_t row = r0 + (threadIdx.x >> lanes_log2);
      const bool is_hub = row < n_rows && row_ptr[row + 1] - row_ptr[row] > hub.degree;
      if (__syncthreads_or(is_hub)) {
        const uint32_t b = __ballot_sync(
            0xffffffffu, is_hub && (threadIdx.x & ((1 << lanes_log2) - 1)) == 0);
        if ((threadIdx.x & 31) == 0) hub_bits[threadIdx.x >> 5] = b;
        __syncthreads();
        narrow_rows<T, NC, VEC, RELU, true>(data, row_ptr, out, n_rows, F, lanes_log2, r0,
                                            hub.degree, hub_bits, stage);
        return;
      }
    }
    narrow_rows<T, NC, VEC, RELU, false>(data, row_ptr, out, n_rows, F, lanes_log2, r0,
                                         hub.degree, hub_bits, stage);
  } else {
    narrow_rows<T, NC, VEC, RELU, false>(data, row_ptr, out, n_rows, F, lanes_log2,
                                         static_cast<int64_t>(blockIdx.x) * rows, hub.degree,
                                         hub_bits, stage);
  }
}

// O is the data dtype T for the relu form and float for the act form.
// HUBS as for segment_sum_kernel.
template <typename T, typename O, bool VEC, bool WEIGHTED, bool ACT, bool HUBS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_sum_bias_relu_kernel(const T* __restrict__ data, int64_t data_stride,
                             const T* __restrict__ bias, int64_t bias_stride,
                             const float* __restrict__ weight,
                             const int64_t* __restrict__ row_ptr, O* __restrict__ out,
                             int64_t n_rows, int F, int lanes_log2, HubPlan hub) {
  constexpr int W = kVec<T>;
  LaneTile t = lane_tile<T>(F, lanes_log2);
  if constexpr (HUBS) {
    if (t.row < hub.n_chunks) {  // warp-uniform
      BiasOp<T, WEIGHTED, ACT> op;
      op.weight = weight;
#pragma unroll
      for (int i = 0; i < W; ++i) op.b[i] = 0.f;
      if (t.ncols > 0)
        load_vec<T, VEC>(bias + hub.row[t.row] * bias_stride + t.col, t.ncols, op.b);
      chunk_partial<T, VEC>(data, data_stride, t, t.row, hub, F, lanes_log2, op);
      return;
    }
    t.row -= hub.n_chunks;
  }
  if (t.row >= n_rows) return;
  if (HUBS && row_ptr[t.row + 1] - row_ptr[t.row] > hub.degree) return;  // its chunks sum it
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

// The wide kernels' warps: the hub chunks' first, then one a row.
template <typename T, bool VEC, bool RELU>
void launch_sum(const void* data, int64_t data_stride, const void* row_ptr, void* out,
                int64_t n_rows, int F, const HubPlan& hub, cudaStream_t stream) {
  auto kernel = hub.n_chunks ? segment_sum_kernel<T, VEC, RELU, true>
                             : segment_sum_kernel<T, VEC, RELU, false>;
  kernel<<<grid_for<T>(hub.n_chunks + n_rows, F), kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(data), data_stride, static_cast<const int64_t*>(row_ptr),
      static_cast<T*>(out), n_rows, F, lanes_log2_for<T>(F), hub);
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
                   const HubPlan& hub, cudaStream_t stream) {
  int lanes_log2 = 0;
  while ((NC << lanes_log2) < F) ++lanes_log2;
  const int64_t rows = kNarrowThreads >> lanes_log2;
  auto kernel = hub.n_chunks ? segment_sum_narrow_kernel<T, NC, VEC, RELU, true>
                             : segment_sum_narrow_kernel<T, NC, VEC, RELU, false>;
  kernel<<<static_cast<unsigned>(hub.blocks + (n_rows + rows - 1) / rows), kNarrowThreads, 0,
           stream>>>(static_cast<const T*>(data), static_cast<const int64_t*>(row_ptr),
                     static_cast<T*>(out), n_rows, F, lanes_log2, hub);
}

template <typename T, int NC>
void dispatch_narrow_cols(const void* data, const void* row_ptr, void* out, int64_t n_rows,
                          int F, int relu_op, const HubPlan& hub, cudaStream_t s) {
  // the staging loads are 16-byte vectors when the data starts 16-byte
  // aligned (chosen once a launch), else scalars
  if (reinterpret_cast<uintptr_t>(data) % 16 == 0) {
    if (relu_op) launch_narrow<T, NC, true, true>(data, row_ptr, out, n_rows, F, hub, s);
    else launch_narrow<T, NC, true, false>(data, row_ptr, out, n_rows, F, hub, s);
  } else {
    if (relu_op) launch_narrow<T, NC, false, true>(data, row_ptr, out, n_rows, F, hub, s);
    else launch_narrow<T, NC, false, false>(data, row_ptr, out, n_rows, F, hub, s);
  }
}

template <typename T>
void dispatch_narrow(const void* data, const void* row_ptr, void* out, int64_t n_rows, int F,
                     int relu_op, const HubPlan& hub, cudaStream_t s) {
  switch (narrow_cols<T>(F)) {
    case 1: dispatch_narrow_cols<T, 1>(data, row_ptr, out, n_rows, F, relu_op, hub, s); break;
    case 2: dispatch_narrow_cols<T, 2>(data, row_ptr, out, n_rows, F, relu_op, hub, s); break;
    case 4: dispatch_narrow_cols<T, 4>(data, row_ptr, out, n_rows, F, relu_op, hub, s); break;
    default: dispatch_narrow_cols<T, kVec<T>>(data, row_ptr, out, n_rows, F, relu_op, hub, s);
  }
}

template <typename T>
void dispatch_wide(const void* data, int64_t data_stride, const void* row_ptr, void* out,
                   int64_t n_rows, int F, int relu_op, int vec, const HubPlan& hub,
                   cudaStream_t s) {
  if (vec) {
    if (relu_op) launch_sum<T, true, true>(data, data_stride, row_ptr, out, n_rows, F, hub, s);
    else launch_sum<T, true, false>(data, data_stride, row_ptr, out, n_rows, F, hub, s);
  } else {
    if (relu_op) launch_sum<T, false, true>(data, data_stride, row_ptr, out, n_rows, F, hub, s);
    else launch_sum<T, false, false>(data, data_stride, row_ptr, out, n_rows, F, hub, s);
  }
}

// The combine pass after the kernel that wrote the partial rows (same
// stream); nothing when the plan has no hubs.
template <typename O>
void launch_combine(const HubPlan& hub, void* out, int F, int vec, cudaStream_t s) {
  if (hub.n_hubs == 0) return;
  const dim3 grid(static_cast<unsigned>(hub.n_hubs),
                  static_cast<unsigned>((F + kColsPerWarp<O> - 1) / kColsPerWarp<O>));
  if (vec)
    hub_combine_kernel<O, true><<<grid, kWarpsPerBlock * 32, 0, s>>>(
        hub, static_cast<O*>(out), F, lanes_log2_for<O>(F));
  else
    hub_combine_kernel<O, false><<<grid, kWarpsPerBlock * 32, 0, s>>>(
        hub, static_cast<O*>(out), F, lanes_log2_for<O>(F));
}

// contiguous rows of F <= kNarrowMaxCols take the narrow path, every other
// call the wide one; then the hubs' combine pass
template <typename T>
void dispatch_sum(const void* data, int64_t data_stride, const void* row_ptr, void* out,
                  int64_t n_rows, int F, int relu_op, int vec, const HubPlan& hub,
                  cudaStream_t s) {
  if (data_stride == F && F <= kNarrowMaxCols<T>)
    dispatch_narrow<T>(data, row_ptr, out, n_rows, F, relu_op, hub, s);
  else
    dispatch_wide<T>(data, data_stride, row_ptr, out, n_rows, F, relu_op, vec, hub, s);
  launch_combine<T>(hub, out, F, vec, s);
}

template <typename T, typename O, bool VEC, bool WEIGHTED, bool ACT>
void launch_bias_relu(const void* data, int64_t data_stride, const void* bias,
                      int64_t bias_stride, const void* weight, const void* row_ptr,
                      void* out, int64_t n_rows, int F, const HubPlan& hub,
                      cudaStream_t stream) {
  auto kernel = hub.n_chunks ? segment_sum_bias_relu_kernel<T, O, VEC, WEIGHTED, ACT, true>
                             : segment_sum_bias_relu_kernel<T, O, VEC, WEIGHTED, ACT, false>;
  kernel<<<grid_for<T>(hub.n_chunks + n_rows, F), kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(data), data_stride, static_cast<const T*>(bias), bias_stride,
      static_cast<const float*>(weight), static_cast<const int64_t*>(row_ptr),
      static_cast<O*>(out), n_rows, F, lanes_log2_for<T>(F), hub);
}

template <typename T, typename O, bool ACT>
void dispatch_bias_relu(const void* data, int64_t data_stride, const void* bias,
                        int64_t bias_stride, const void* weight, const void* row_ptr,
                        void* out, int64_t n_rows, int F, int vec, const HubPlan& hub,
                        cudaStream_t s) {
  const bool weighted = weight != nullptr;
  if (vec) {
    if (weighted)
      launch_bias_relu<T, O, true, true, ACT>(data, data_stride, bias, bias_stride, weight,
                                              row_ptr, out, n_rows, F, hub, s);
    else
      launch_bias_relu<T, O, true, false, ACT>(data, data_stride, bias, bias_stride, weight,
                                               row_ptr, out, n_rows, F, hub, s);
  } else {
    if (weighted)
      launch_bias_relu<T, O, false, true, ACT>(data, data_stride, bias, bias_stride, weight,
                                               row_ptr, out, n_rows, F, hub, s);
    else
      launch_bias_relu<T, O, false, false, ACT>(data, data_stride, bias, bias_stride, weight,
                                                row_ptr, out, n_rows, F, hub, s);
  }
  launch_combine<O>(hub, out, F, vec, s);
}

// The entry points' trailing hub arguments as the kernels take them. No
// chunks (a plan without hubs, or none given): no row is a hub.
cudaError_t make_hub_plan(const void* chunks, const void* first, long long n_chunks,
                          long long n_hubs, long long degree, void* ws, HubPlan* h) {
  *h = HubPlan{};
  h->degree = INT64_MAX;
  if (n_chunks == 0) return cudaSuccess;
  if (n_chunks < 0 || n_hubs <= 0 || n_hubs > n_chunks || degree < 0 || !chunks || !first ||
      !ws)
    return cudaErrorInvalidValue;
  const int64_t* c = static_cast<const int64_t*>(chunks);
  h->row = c;
  h->start = c + n_chunks;
  h->end = c + 2 * n_chunks;
  h->first = static_cast<const int64_t*>(first);
  h->ws = static_cast<float*>(ws);
  h->n_chunks = n_chunks;
  h->n_hubs = n_hubs;
  h->degree = degree;
  h->blocks = (n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The hub arguments that follow the stream in the three entry points:
// hub_chunks [3, n_chunks] int64 (each chunk's row, first edge, end edge),
// hub_first [n_hubs + 1] int64 (each hub's first chunk, then n_chunks), the
// degree above which a row is a hub, and workspace [n_chunks, F] float32,
// which the caller allocates. n_chunks = 0 (null pointers): no hubs.

// out [n_rows, F] (contiguous) = sorted segment sum of data [E, F] (row
// stride data_stride elements, unit column stride) over the CSR offsets
// row_ptr [n_rows + 1] (int64). dtype: 0 = float32, 1 = bfloat16. The
// narrow path on contiguous rows of F <= kNarrowMaxCols, the wide one
// otherwise; vec (the wrapper's 16-byte flag) picks the wide path's and the
// combine pass's vector loads.
int dg_sorted_segment_sum(const void* data, long long data_stride, const void* row_ptr,
                          void* out, long long n_rows, int F, int dtype, int relu_op,
                          int vec, void* stream, const void* hub_chunks, const void* hub_first,
                          long long n_chunks, long long n_hubs, long long hub_degree,
                          void* workspace) {
  if (n_rows <= 0 || F <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  HubPlan hub;
  if (cudaError_t e = make_hub_plan(hub_chunks, hub_first, n_chunks, n_hubs, hub_degree,
                                    workspace, &hub))
    return static_cast<int>(e);
  if (cudaError_t e = bind_device_of(data)) return static_cast<int>(e);
  if (dtype == kF32)
    dispatch_sum<float>(data, data_stride, row_ptr, out, n_rows, F, relu_op, vec, hub, s);
  else if (dtype == kBF16)
    dispatch_sum<__nv_bfloat16>(data, data_stride, row_ptr, out, n_rows, F, relu_op, vec, hub,
                                s);
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
                                    void* stream, const void* hub_chunks,
                                    const void* hub_first, long long n_chunks,
                                    long long n_hubs, long long hub_degree, void* workspace) {
  if (n_rows <= 0 || F <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  HubPlan hub;
  if (cudaError_t e = make_hub_plan(hub_chunks, hub_first, n_chunks, n_hubs, hub_degree,
                                    workspace, &hub))
    return static_cast<int>(e);
  if (cudaError_t e = bind_device_of(data)) return static_cast<int>(e);
  if (dtype == kF32)
    dispatch_bias_relu<float, float, false>(data, data_stride, bias, bias_stride, weight,
                                            row_ptr, out, n_rows, F, vec, hub, s);
  else if (dtype == kBF16)
    dispatch_bias_relu<__nv_bfloat16, __nv_bfloat16, false>(
        data, data_stride, bias, bias_stride, weight, row_ptr, out, n_rows, F, vec, hub, s);
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
                              void* stream, const void* hub_chunks, const void* hub_first,
                              long long n_chunks, long long n_hubs, long long hub_degree,
                              void* workspace) {
  if (n_rows <= 0 || F <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  HubPlan hub;
  if (cudaError_t e = make_hub_plan(hub_chunks, hub_first, n_chunks, n_hubs, hub_degree,
                                    workspace, &hub))
    return static_cast<int>(e);
  if (cudaError_t e = bind_device_of(data)) return static_cast<int>(e);
  if (dtype == kF32)
    dispatch_bias_relu<float, float, true>(data, data_stride, bias, bias_stride, weight,
                                           row_ptr, out, n_rows, F, vec, hub, s);
  else if (dtype == kBF16)
    dispatch_bias_relu<__nv_bfloat16, float, true>(data, data_stride, bias, bias_stride,
                                                   weight, row_ptr, out, n_rows, F, vec, hub,
                                                   s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
