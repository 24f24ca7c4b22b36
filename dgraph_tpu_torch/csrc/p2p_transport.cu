// One-sided halo transport for Hopper (sm_90a): the CUDA counterpart of the
// Pallas TPU kernel dgraph_tpu/ops/pallas_p2p.py:102 (_transport_kernel,
// pallas_call at :177, public p2p_transport at :217).
//
//   dg_p2p_transport   tile k of blocks [n, S, F], each row multiplied by
//                      mask[k, row] (when a mask is given), is stored straight
//                      into peer (me + sign * delta_k) % W's [W*S, F] landing
//                      buffer at rows [me*S, (me+1)*S)
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
// Layout: a tile and its destination rows are each one contiguous S*F run,
// so the grid is (chunks of the run, tile). The vector path (16-byte loads
// and stores, 4 f32 or 8 bf16 of one row) is chosen once per launch by the
// wrapper: every row a whole number of 16-byte vectors and the blocks
// 16-byte aligned (the landing buffers are 256-byte aligned); else one
// element a thread. Element offsets are 64-bit.
//
// Bound: device-memory bytes. Each tile element is read once and written
// once (into the peer's memory: the same HBM on a shared card, NVLink across
// cards), plus 4 bytes of mask a row.
//
// Plain C interface, loaded with ctypes (dgraph_tpu_torch/ops/_build.py).
// Each entry point returns a cudaError_t as int (0 = success).

#include <cstring>

#include "vec.cuh"

namespace {

using namespace dg;

constexpr int kThreads = 256;
constexpr int kMaxTiles = 64;
constexpr int kMaxChunks = 2048;

// the destination of every tile, passed by value
struct Dests {
  void* p[kMaxTiles];
};

template <typename T, bool VEC, bool MASK>
__global__ void __launch_bounds__(kThreads)
p2p_put_kernel(const T* __restrict__ blocks, const float* __restrict__ mask, Dests dst,
               int64_t S, int F) {
  const int k = blockIdx.y;
  const int64_t run = S * F;
  const T* in = blocks + k * run;
  T* out = static_cast<T*>(dst.p[k]);
  const float* m = MASK ? mask + k * S : nullptr;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if constexpr (VEC) {
    constexpr int V = kVec<T>;
    const int64_t per_row = F / V;
    const int64_t units = run / V;
    for (int64_t i = first; i < units; i += stride) {
      const T* src = in + i * V;
      T* d = out + i * V;
      if constexpr (MASK) {
        float v[V];
        load_vec<T, true>(src, V, v);
        // the mask rounded to the data dtype, then the product in f32
        // rounded once: PyTorch's blocks * mask.to(dtype)
        const float mk = to_f32(from_f32<T>(m[i / per_row]));
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] *= mk;
        store_vec<T, V, true>(d, V, v);
      } else {
        *reinterpret_cast<uint4*>(d) = __ldg(reinterpret_cast<const uint4*>(src));
      }
    }
  } else {
    for (int64_t i = first; i < run; i += stride) {
      if constexpr (MASK) {
        const float mk = to_f32(from_f32<T>(m[i / F]));
        out[i] = from_f32<T>(to_f32(in[i]) * mk);
      } else {
        out[i] = in[i];
      }
    }
  }
}

template <typename T, bool VEC>
void launch(const void* blocks, const float* mask, const Dests& dst, int n, int64_t S, int F,
            cudaStream_t s) {
  const int64_t units = VEC ? S * F / kVec<T> : S * F;
  const int64_t chunks = (units + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(chunks < kMaxChunks ? chunks : kMaxChunks), n);
  const T* b = static_cast<const T*>(blocks);
  if (mask)
    p2p_put_kernel<T, VEC, true><<<grid, kThreads, 0, s>>>(b, mask, dst, S, F);
  else
    p2p_put_kernel<T, VEC, false><<<grid, kThreads, 0, s>>>(b, nullptr, dst, S, F);
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
// pointers. dtype: 0 = float32, 1 = bfloat16. Launches on `stream` of the
// card that holds `blocks`.
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
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
