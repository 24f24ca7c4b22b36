// One-sided halo transport for Hopper (sm_90a): the CUDA counterpart of the
// Pallas TPU kernel dgraph_tpu/ops/pallas_p2p.py:102 (_transport_kernel,
// pallas_call at :177, public p2p_transport at :217).
//
//   dg_p2p_transport   tile k of blocks [n, S, F], each row multiplied by
//                      mask[k, row] (when a mask is given), is stored straight
//                      into peer (me + sign * delta_k) % W's [W*S, F] landing
//                      buffer at rows [me*S, (me+1)*S)
//   dg_p2p_transport_mutant
//                      kernel 6, the counterpart of the fault-seeded copy of
//                      the TPU kernel in dgraph_tpu/analysis/kernel.py:569
//                      (_mutant_jaxpr :506): the same puts with the
//                      destinations computed in the kernel from the peers'
//                      base pointers, me, W, S, sign and the deltas (as the
//                      TPU kernel reads its meta operand, :526-528), and one
//                      compile-time fault: None (kernel 5, bit for bit),
//                      BadDstRow (the source rank's slot, the reference's
//                      bad_dst_row) or Oversize (S + 1 rows a tile, the put
//                      leaving its slot: the counterpart of
//                      oversize_staging, since there is no VMEM staging
//                      here). The DMA-discipline verifier
//                      (dgraph_tpu_torch/analysis/kernel.py) launches it in
//                      its landing check, which must see each fault.
//
// The TPU kernel issues one remote DMA per tile from inside the kernel and
// waits on DMA semaphores and a barrier semaphore. Here every rank holds a
// symmetric landing buffer allocated with cudaMalloc (dg_p2p_malloc; never
// PyTorch's caching allocator, whose blocks share one IPC allocation) and
// maps its peers' buffers once through CUDA IPC (dg_p2p_ipc_handle /
// dg_p2p_ipc_open, with lazy peer access, so ranks on separate cards store
// over NVLink and ranks on one card store into the same device memory). The
// kernel's stores ARE the puts. The ready barrier and the receive waits
// become host barriers in the wrapper (dgraph_tpu_torch/ops/p2p.py): zero
// the own buffer, barrier, launch, synchronise, barrier. No kernel waits on
// another process's writes: ranks that share one card time-slice it, and a
// spinning kernel could hold the card from the writer it waits for.
//
// The mask is applied in flight as a multiply in the data dtype, never a
// select: x * 0 is -0.0 for negative x and NaN for NaN, as in the
// all_to_all lowering's masked send stack. bf16 products round as
// PyTorch's CUDA multiply does (__float2bfloat16_rn of the f32 product).
// With no mask the kernel moves bytes. The TPU's VMEM staging and its 4 MiB
// budget (pallas_p2p.py:58, :210-214) have no counterpart.
//
// Byte tiles (dtype 2, uint8, mask null only): the encoded halo payloads of
// the wire codecs (dgraph_tpu_torch/wire/codec.py; fp8 rows of F + 4 bytes,
// the f32 scale in the last 4), which the reference's dtype-generic kernel
// moves pre-masked as pure data (collectives.py:336-343). With no mask a
// tile and its destination rows are each one contiguous run of S*(F+4)
// bytes, so the copy goes in 16-byte vectors whenever the run length and
// both bases are 16-byte aligned (the wrapper decides once per launch),
// else one byte a thread. No arithmetic touches the bytes: the scale lanes
// and the payload keep their bits.
//
// Layout: a tile and its destination rows are each one contiguous S*F run,
// so the grid is (chunks of the run, tile). The vector path (16-byte loads
// and stores, 4 f32 or 8 bf16 of one row) is chosen once per launch by the
// wrapper: every row a whole number of 16-byte vectors and the blocks
// 16-byte aligned (the landing buffers are 256-byte aligned); else one
// element a thread. Element offsets are 64-bit.
//
// Bound: device-memory bytes. Each tile element is read once and written
// once (into the peer's memory: the same HBM on a shared card, NVLink across
// cards), plus 4 bytes of mask a row. Kernel 6 moves the same bytes (S + 1
// rows a tile for Oversize); its destination arithmetic is a few integer
// operations a block.
//
// Plain C interface, loaded with ctypes (dgraph_tpu_torch/ops/_build.py).
// Each entry point returns a cudaError_t as int (0 = success).

#include <cstdint>
#include <cstring>

#include "vec.cuh"

namespace {

using namespace dg;

constexpr int kThreads = 256;
constexpr int kMaxTiles = 64;
constexpr int kMaxChunks = 2048;
constexpr int kU8 = 2;  // byte tiles (kernel 5 only, no mask)

// the destination of every tile, passed by value
struct Dests {
  void* p[kMaxTiles];
};

// kernel 6's operands, passed by value: every rank's landing buffer and
// the live deltas (the TPU kernel's meta operand)
struct Peers {
  void* base[kMaxTiles];
  int delta[kMaxTiles];
};

// kernel 6's seeded faults (ops/p2p.py MUTATIONS)
enum Mutation : int { kNone = 0, kBadDstRow = 1, kOversize = 2 };

// The tile loop of kernels 5 and 6: `rows` rows of the [S, F] tile `in`
// (times m[row] when MASK) stored at `out`. Row i reads row i % S (WRAP),
// which differs from i only for kernel 6's Oversize (rows = S + 1): its
// extra row repeats row 0, so every read stays inside the tile and only the
// store leaves the slot. Kernel 5 and kernel 6 None instantiate the same
// code (WRAP false, rows = S).
template <typename T, bool VEC, bool MASK, bool WRAP>
__device__ __forceinline__ void put_tile(const T* __restrict__ in, const float* __restrict__ m,
                                         T* out, int64_t S, int F, int64_t rows) {
  const int64_t run = S * F;
  const int64_t total = rows * F;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if constexpr (VEC) {
    constexpr int V = kVec<T>;
    const int64_t per_row = F / V;
    const int64_t units = total / V;
    for (int64_t i = first; i < units; i += stride) {
      const int64_t si = WRAP ? i % (run / V) : i;
      const T* src = in + si * V;
      T* d = out + i * V;
      if constexpr (MASK) {
        float v[V];
        load_vec<T, true>(src, V, v);
        // the mask rounded to the data dtype, then the product in f32
        // rounded once: PyTorch's blocks * mask.to(dtype)
        const float mk = to_f32(from_f32<T>(m[si / per_row]));
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] *= mk;
        store_vec<T, V, true>(d, V, v);
      } else {
        *reinterpret_cast<uint4*>(d) = __ldg(reinterpret_cast<const uint4*>(src));
      }
    }
  } else {
    for (int64_t i = first; i < total; i += stride) {
      const int64_t si = WRAP ? i % run : i;
      if constexpr (MASK) {
        const float mk = to_f32(from_f32<T>(m[si / F]));
        out[i] = from_f32<T>(to_f32(in[si]) * mk);
      } else {
        out[i] = in[si];
      }
    }
  }
}

// kernel 5: tile k to the destination the wrapper computed
template <typename T, bool VEC, bool MASK>
__global__ void __launch_bounds__(kThreads)
p2p_put_kernel(const T* __restrict__ blocks, const float* __restrict__ mask, Dests dst,
               int64_t S, int F) {
  const int k = blockIdx.y;
  put_tile<T, VEC, MASK, false>(blocks + k * S * F, MASK ? mask + k * S : nullptr,
                                static_cast<T*>(dst.p[k]), S, F, S);
}

// kernel 6: tile k to peer (me + sign * delta_k) % W at the slot of `me`
// (the TPU kernel's meta[3n] = me*S), or of the source rank
// (me - sign * delta_k) % W under BadDstRow (the reference's dst_idx =
// 2n); Oversize stores S + 1 rows.
template <typename T, bool VEC, bool MASK, Mutation M>
__global__ void __launch_bounds__(kThreads)
p2p_put_mutant_kernel(const T* __restrict__ blocks, const float* __restrict__ mask, Peers peers,
                      int me, int W, int sign, int64_t S, int F) {
  const int k = blockIdx.y;
  const int d = peers.delta[k];
  const int target = ((me + sign * d) % W + W) % W;
  const int slot = M == kBadDstRow ? ((me - sign * d) % W + W) % W : me;
  T* out = static_cast<T*>(peers.base[target]) + static_cast<int64_t>(slot) * S * F;
  put_tile<T, VEC, MASK, M == kOversize>(blocks + k * S * F, MASK ? mask + k * S : nullptr, out,
                                         S, F, M == kOversize ? S + 1 : S);
}

// kernel 5 on byte tiles: tile k's `run` bytes to dst[k], 16 bytes a
// thread (VEC) or one
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
p2p_put_bytes_kernel(const uint8_t* __restrict__ blocks, Dests dst, int64_t run) {
  const int k = blockIdx.y;
  const uint8_t* in = blocks + k * run;
  uint8_t* out = static_cast<uint8_t*>(dst.p[k]);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if constexpr (VEC) {
    const int64_t units = run / 16;
    for (int64_t i = first; i < units; i += stride)
      reinterpret_cast<uint4*>(out)[i] = __ldg(reinterpret_cast<const uint4*>(in) + i);
  } else {
    for (int64_t i = first; i < run; i += stride) out[i] = in[i];
  }
}

dim3 put_grid(int n, int64_t units) {
  const int64_t chunks = (units + kThreads - 1) / kThreads;
  return dim3(static_cast<unsigned>(chunks < kMaxChunks ? chunks : kMaxChunks), n);
}

template <typename T, bool VEC>
void launch(const void* blocks, const float* mask, const Dests& dst, int n, int64_t S, int F,
            cudaStream_t s) {
  const dim3 grid = put_grid(n, VEC ? S * F / kVec<T> : S * F);
  const T* b = static_cast<const T*>(blocks);
  if (mask)
    p2p_put_kernel<T, VEC, true><<<grid, kThreads, 0, s>>>(b, mask, dst, S, F);
  else
    p2p_put_kernel<T, VEC, false><<<grid, kThreads, 0, s>>>(b, nullptr, dst, S, F);
}

template <typename T, bool VEC, Mutation M>
void launch_mutant(const void* blocks, const float* mask, const Peers& peers, int n, int me,
                   int W, int sign, int64_t S, int F, cudaStream_t s) {
  const int64_t rows = M == kOversize ? S + 1 : S;
  const dim3 grid = put_grid(n, VEC ? rows * F / kVec<T> : rows * F);
  const T* b = static_cast<const T*>(blocks);
  if (mask)
    p2p_put_mutant_kernel<T, VEC, true, M><<<grid, kThreads, 0, s>>>(b, mask, peers, me, W, sign,
                                                                     S, F);
  else
    p2p_put_mutant_kernel<T, VEC, false, M><<<grid, kThreads, 0, s>>>(b, nullptr, peers, me, W,
                                                                      sign, S, F);
}

template <typename T, bool VEC>
cudaError_t dispatch_mutation(int mutation, const void* blocks, const float* mask,
                              const Peers& peers, int n, int me, int W, int sign, int64_t S,
                              int F, cudaStream_t s) {
  switch (mutation) {
    case kNone: launch_mutant<T, VEC, kNone>(blocks, mask, peers, n, me, W, sign, S, F, s); break;
    case kBadDstRow:
      launch_mutant<T, VEC, kBadDstRow>(blocks, mask, peers, n, me, W, sign, S, F, s);
      break;
    case kOversize:
      launch_mutant<T, VEC, kOversize>(blocks, mask, peers, n, me, W, sign, S, F, s);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// *out = a fresh cudaMalloc allocation of `bytes` on `device` (the landing
// buffer: its IPC handle covers exactly this allocation).
int dg_p2p_malloc(int device, long long bytes, void** out) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaMalloc(out, static_cast<size_t>(bytes));
  return static_cast<int>(e);
}

// handle (sizeof(cudaIpcMemHandle_t) = 64 bytes) of the allocation at p
int dg_p2p_ipc_handle(int device, void* p, void* handle) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), p);
  return static_cast<int>(e);
}

// *out = this process's mapping of a peer's allocation; a process cannot
// open its own handle (it uses its own pointer)
int dg_p2p_ipc_open(int device, const void* handle, void** out) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) {
    cudaIpcMemHandle_t h;
    memcpy(&h, handle, sizeof(h));
    e = cudaIpcOpenMemHandle(out, h, cudaIpcMemLazyEnablePeerAccess);
  }
  return static_cast<int>(e);
}

// Store tile k of blocks [n, S, F] (contiguous), times mask[k, row] when
// mask [n, S] (f32, contiguous) is not null, at dst[k] (S*F elements,
// contiguous: the peer's landing rows). dst is a host array of n device
// pointers. dtype: 0 = float32, 1 = bfloat16, 2 = uint8 (bytes, mask null
// only; vec: the run S*F and every base 16-byte aligned). Launches on
// `stream` of the card that holds `blocks`.
int dg_p2p_transport(int device, const void* blocks, const float* mask, void* const* dst,
                     int n, long long S, int F, int dtype, int vec, void* stream) {
  if (n <= 0 || n > kMaxTiles || S <= 0 || F <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  Dests d;
  for (int k = 0; k < n; ++k) d.p[k] = dst[k];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    if (vec) launch<float, true>(blocks, mask, d, n, S, F, s);
    else launch<float, false>(blocks, mask, d, n, S, F, s);
  } else if (dtype == kBF16) {
    if (vec) launch<__nv_bfloat16, true>(blocks, mask, d, n, S, F, s);
    else launch<__nv_bfloat16, false>(blocks, mask, d, n, S, F, s);
  } else if (dtype == kU8 && mask == nullptr) {
    const int64_t run = S * F;
    const uint8_t* b = static_cast<const uint8_t*>(blocks);
    if (vec) p2p_put_bytes_kernel<true><<<put_grid(n, run / 16), kThreads, 0, s>>>(b, d, run);
    else p2p_put_bytes_kernel<false><<<put_grid(n, run), kThreads, 0, s>>>(b, d, run);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel 6: tile k of blocks [n, S, F] (times mask[k, row] when mask is not
// null) into the landing buffer of peer (me + sign * delta[k]) % W, whose
// base is bases[that peer] (a host array of W device pointers), at rows
// [me*S, (me+1)*S) (mutation 0), at the rows of the source rank (1,
// BadDstRow), or S + 1 rows from me*S (2, Oversize: the buffers need a
// guard slot of S rows). deltas: a host array of n ints. Launches on
// `stream` of the card that holds `blocks`.
int dg_p2p_transport_mutant(const void* blocks, const float* mask, void* const* bases,
                            const int* deltas, int n, int me, int W, long long S, int F,
                            int sign, int dtype, int vec, int mutation, void* stream) {
  if (n <= 0 || n > kMaxTiles || W <= 0 || W > kMaxTiles || me < 0 || me >= W || S <= 0 ||
      F <= 0 || (sign != 1 && sign != -1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = bind_device_of(blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  Peers p;
  for (int r = 0; r < W; ++r) p.base[r] = bases[r];
  for (int k = 0; k < n; ++k) p.delta[k] = deltas[k];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    e = vec ? dispatch_mutation<float, true>(mutation, blocks, mask, p, n, me, W, sign, S, F, s)
            : dispatch_mutation<float, false>(mutation, blocks, mask, p, n, me, W, sign, S, F, s);
  else if (dtype == kBF16)
    e = vec ? dispatch_mutation<__nv_bfloat16, true>(mutation, blocks, mask, p, n, me, W, sign, S,
                                                     F, s)
            : dispatch_mutation<__nv_bfloat16, false>(mutation, blocks, mask, p, n, me, W, sign,
                                                      S, F, s);
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
