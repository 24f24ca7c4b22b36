// Flash attention for Hopper (sm_90a): the CUDA counterparts of the three
// Pallas TPU kernels of jax/experimental/pallas/ops/tpu/flash_attention.py,
// which dgraph_tpu reaches from parallel/sequence.py:284-310 (_flash_dense).
//
//   dg_flash_attention_fwd      replaces _flash_attention_kernel      (:331)
//     O = softmax(scale * Q K^T + mask) V and the row logsumexp
//     lse = m + log(l), the residual the two backward kernels read
//   dg_flash_attention_bwd_dkv  replaces _flash_attention_dkv_kernel  (:796)
//     P = exp(scale * Q K^T - lse), dS = P * (dO V^T - di) * scale,
//     dV = P^T dO, dK = dS^T Q
//   dg_flash_attention_bwd_dq   replaces _flash_attention_dq_kernel   (:1146)
//     dQ = dS K
//
// di = rowsum(O * dO) is computed by the caller (a plain pass, as in the
// reference, flash_attention.py:273-275).
//
// Layout: q, k, v and dO are [T, H, D] with unit stride over D and any row
// and head strides (multiples of 4 elements, rows 16-byte aligned in f32 and
// 8-byte in bf16): the LM's q, k and v are column slices of one [T, 3L] qkv
// tensor and reach the kernels without a copy. O, dQ, dK and dV are
// contiguous [T, H, D] in the input dtype; lse and di are [H, T] f32. The
// optional mask is [T] int32 (nonzero = a real position); it masks keys and
// queries alike, so a padded query row is an empty row: O = 0 there, and it
// contributes nothing to any gradient (the dense oracle zeroes those rows,
// parallel/sequence.py:161-166). The mask as a whole is
//   allowed(i, j) = i < T && j < T && mask[i] && mask[j] && (!causal || j <= i).
// A row with no allowed key gets O = 0 and lse = 0 (its P is zero by the
// mask, never by the value of lse).
//
// Design. One block of 256 threads (16 x 16) per (64-row tile, head). A
// block stages f32 tiles of 64 rows in shared memory (bf16 is widened on
// the way in), each with a row pitch of D + 4 floats so that the 16-byte
// reads of 16 different rows fall in different banks. Thread (tx, ty) owns
// the 4 x 4 scores of rows ty + 16r and columns tx + 16c: a score tile is
// 4 x 4 outer products of 16-byte row slices, and a row's max and sum are
// shuffles across the 16 lanes that share ty. The output accumulators (O,
// dK, dV or dQ rows) stay in registers, D / 16 columns a row a thread.
//   fwd: loops over key tiles with the online softmax (running m, l in f32
//        registers); the probabilities overwrite the key tile in shared
//        memory for the P V product. Under a causal mask it stops at the
//        diagonal tile. 101 KB of shared memory at D = 128: two blocks an SM.
//   dkv: one block per key tile keeps K and V, loops over the query tiles
//        at or below the diagonal, recomputes P from lse and writes P and dS
//        to shared memory for the two transposed products. 171 KB: one
//        block an SM.
//   dq:  one block per query tile keeps Q and dO, loops over key tiles up to
//        the diagonal; dS overwrites the value tile for dS K. 136 KB.
// Every sum is taken by one thread in a fixed order: no atomics, the same
// bits on every launch. The blocks with the most tiles under a causal mask
// are numbered first so that they start first.
//
// Bound: operations. At T = 8192, H = 4, D = 128 (causal) a forward is
// 4 * D * H * T(T+1)/2 = 6.9e10 FLOP (two products), dK/dV 1.4e11 (four),
// dQ 1.0e11 (three): 1.0, 2.1 and 1.5 ms at the card's 67 TFLOP/s of f32
// outside the tensor cores, against about 0.03 ms for the bytes (each input
// read once). The math is f32 FMAs on the CUDA cores, as the f32 inputs and
// the 1e-4 parity with the f32 plain version demand. The design feeds them
// from shared memory at 8 16-byte reads per 64 FMAs; tensor cores (wgmma on
// bf16, with TMA staging) are the next step and a later change. Measured by
// chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power limit: 3.31,
// 4.47 and 3.60 ms in f32 (31, 46 and 43 % of that peak).
//
// Plain C interface, loaded with ctypes (dgraph_tpu_torch/ops/_build.py).
// Each entry point launches on the caller's stream, allocates nothing and
// returns the first CUDA error (cudaFuncSetAttribute's or the launch's).

#include <math.h>

#include "vec.cuh"

namespace {

using namespace dg;

constexpr int kTile = 64;            // rows of a query or key tile
constexpr int kThreads = 256;        // 16 x 16
constexpr int kPPitch = kTile + 4;   // row pitch of a [64][64] P or dS tile

template <int D>
__host__ __device__ constexpr int pitch() { return D + 4; }

// floats of a region that holds a [64][D] operand tile and later a [64][64]
// P or dS tile
template <int D>
__host__ __device__ constexpr int region() {
  return kTile * (pitch<D>() > kPPitch ? pitch<D>() : kPPitch);
}

template <typename T>
__device__ __forceinline__ float4 load4(const T* p);
template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(const __nv_bfloat16* p) {
  // bf16 -> f32 is exact: the bf16 bits are the high half of the f32
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// rows [r0, r0 + 64) of head h of a strided [T, H, D] operand into
// s[64][D + 4] as f32; rows at or past T are zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* __restrict__ s, const T* __restrict__ g,
                                          int64_t rs, int64_t hs, int h, int r0, int T_len) {
  constexpr int G = D / 4;
  const T* base = g + h * hs;
  for (int idx = threadIdx.x; idx < kTile * G; idx += kThreads) {
    const int r = idx / G, c = (idx % G) * 4;
    const int t = r0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < T_len) v = load4<T>(base + t * rs + c);
    *reinterpret_cast<float4*>(s + r * pitch<D>() + c) = v;
  }
}

// ok[r] = 1 when row r0 + r exists and is a real position
__device__ __forceinline__ void load_valid(int* ok, const int32_t* __restrict__ mask, int r0,
                                           int T_len) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int t = r0 + r;
    ok[r] = t < T_len && (mask == nullptr || mask[t] != 0);
  }
}

// x[r] = row r0 + r of the [H, T] f32 array a at head h (0 past T)
__device__ __forceinline__ void load_rows(float* x, const float* __restrict__ a, int h, int r0,
                                          int T_len) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int t = r0 + r;
    x[r] = t < T_len ? a[static_cast<int64_t>(h) * T_len + t] : 0.f;
  }
}

// acc[r][c] = sum_d A[ty + 16r][d] * B[tx + 16c][d]: A and B are [64][D + 4]
template <int D>
__device__ __forceinline__ void tile_dot(const float* __restrict__ A, const float* __restrict__ B,
                                         int tx, int ty, float acc[4][4]) {
  constexpr int P = pitch<D>();
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = *reinterpret_cast<const float4*>(A + (ty + 16 * r) * P + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = *reinterpret_cast<const float4*>(B + (tx + 16 * c) * P + d);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float s = acc[r][c];
        s = fmaf(a[r].x, b[c].x, s);
        s = fmaf(a[r].y, b[c].y, s);
        s = fmaf(a[r].z, b[c].z, s);
        s = fmaf(a[r].w, b[c].w, s);
        acc[r][c] = s;
      }
  }
}

// The D / 16 columns of a [64][D] output row that thread tx owns: groups of
// VW consecutive columns, 16 * VW apart (so a warp's reads of one row are
// contiguous): column(k) for k = g * VW + e is g * 16 * VW + tx * VW + e.
template <int D>
struct Cols {
  static constexpr int VW = D >= 64 ? 4 : 2;
  static constexpr int N = D / 16;
  static constexpr int NG = N / VW;
  static __device__ __forceinline__ int col(int tx, int k) {
    return (k / VW) * 16 * VW + tx * VW + (k % VW);
  }
};

// the thread's D / 16 columns of row x (a [.][D + 4] tile row)
template <int D>
__device__ __forceinline__ void load_cols(const float* __restrict__ x, int tx, float* out) {
  using C = Cols<D>;
#pragma unroll
  for (int g = 0; g < C::NG; ++g) {
    const float* p = x + g * 16 * C::VW + tx * C::VW;
    if constexpr (C::VW == 4) {
      const float4 u = *reinterpret_cast<const float4*>(p);
      out[g * 4] = u.x;
      out[g * 4 + 1] = u.y;
      out[g * 4 + 2] = u.z;
      out[g * 4 + 3] = u.w;
    } else {
      const float2 u = *reinterpret_cast<const float2*>(p);
      out[g * 2] = u.x;
      out[g * 2 + 1] = u.y;
    }
  }
}

// out[r][k] += sum_j W[ty + 16r][j] * X[j][col(k)]: W is [64][kPPitch], X [64][D + 4]
template <int D>
__device__ __forceinline__ void tile_wx(const float* __restrict__ W, const float* __restrict__ X,
                                        int tx, int ty, float out[4][D / 16]) {
  constexpr int N = D / 16;
#pragma unroll 2
  for (int j = 0; j < kTile; j += 4) {
    float w[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 u = *reinterpret_cast<const float4*>(W + (ty + 16 * r) * kPPitch + j);
      w[r][0] = u.x;
      w[r][1] = u.y;
      w[r][2] = u.z;
      w[r][3] = u.w;
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float x[N];
      load_cols<D>(X + (j + jj) * pitch<D>(), tx, x);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < N; ++k) out[r][k] = fmaf(w[r][jj], x[k], out[r][k]);
    }
  }
}

// out[r][k] += sum_i W[i][ty + 16r] * X[i][col(k)]: the transposed product,
// W is [64][kPPitch], X [64][D + 4]
template <int D>
__device__ __forceinline__ void tile_wtx(const float* __restrict__ W, const float* __restrict__ X,
                                         int tx, int ty, float out[4][D / 16]) {
  constexpr int N = D / 16;
#pragma unroll 4
  for (int i = 0; i < kTile; ++i) {
    float w[4], x[N];
#pragma unroll
    for (int r = 0; r < 4; ++r) w[r] = W[i * kPPitch + ty + 16 * r];
    load_cols<D>(X + i * pitch<D>(), tx, x);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < N; ++k) out[r][k] = fmaf(w[r], x[k], out[r][k]);
  }
}

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows ty + 16r of a [64][D] accumulator to rows r0 + ty + 16r of the
// contiguous [T, H, D] output at head h, times mul[r]
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* __restrict__ out, float acc[4][D / 16],
                                           const float mul[4], int tx, int ty, int h, int H,
                                           int r0, int T_len) {
  using C = Cols<D>;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = r0 + ty + 16 * r;
    if (t >= T_len) continue;
    T* o = out + (static_cast<int64_t>(t) * H + h) * D;
#pragma unroll
    for (int k = 0; k < C::N; ++k) o[C::col(tx, k)] = from_f32<T>(acc[r][k] * mul[r]);
  }
}

// --- forward -----------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, int64_t q_rs, int64_t q_hs,
                 const T* __restrict__ k, int64_t k_rs, int64_t k_hs,
                 const T* __restrict__ v, int64_t v_rs, int64_t v_hs,
                 const int32_t* __restrict__ mask, T* __restrict__ out,
                 float* __restrict__ lse, int T_len, int H, float scale, int causal) {
  constexpr int P = pitch<D>(), N = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // [64][P]
  float* Ks = Qs + kTile * P;        // [64][P], then P [64][kPPitch]
  float* Vs = Ks + region<D>();      // [64][P]
  int* q_ok = reinterpret_cast<int*>(Vs + kTile * P);
  int* k_ok = q_ok + kTile;

  const int n_tiles = (T_len + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y;
  const int q0 = qt * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, D>(Qs, q, q_rs, q_hs, h, q0, T_len);
  load_valid(q_ok, mask, q0, T_len);

  float m[4], l[4], acc[4][N];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < N; ++c) acc[r][c] = 0.f;
  }

  const int kt_end = causal ? qt + 1 : n_tiles;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's P and V are consumed
    load_tile<T, D>(Ks, k, k_rs, k_hs, h, k0, T_len);
    load_tile<T, D>(Vs, v, v_rs, v_hs, h, k0, T_len);
    load_valid(k_ok, mask, k0, T_len);
    __syncthreads();

    float s[4][4];
    tile_dot<D>(Qs, Ks, tx, ty, s);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ty + 16 * r;
      const bool row_ok = q_ok[ty + 16 * r];
      bool ok[4];
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tx + 16 * c;
        ok[c] = row_ok && k_ok[tx + 16 * c] && (!causal || j <= i);
        s[r][c] *= scale;
        if (ok[c]) mx = fmaxf(mx, s[r][c]);
      }
      mx = max16(mx);
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = ok[c] ? expf(s[r][c] - m_new) : 0.f;
        sum += s[r][c];
      }
      sum = sum16(sum);
      // m[r] = -inf: nothing accumulated yet (l and acc are 0)
      const float alpha = m[r] == -INFINITY ? 0.f : expf(m[r] - m_new);
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int c = 0; c < N; ++c) acc[r][c] *= alpha;
      m[r] = m_new;
    }
    __syncthreads();  // every thread is done reading K
    float* Ps = Ks;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) Ps[(ty + 16 * r) * kPPitch + tx + 16 * c] = s[r][c];
    __syncthreads();
    tile_wx<D>(Ps, Vs, tx, ty, acc);
  }

  float inv[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    const int i = q0 + ty + 16 * r;
    if (tx == 0 && i < T_len)
      lse[static_cast<int64_t>(h) * T_len + i] = l[r] > 0.f ? m[r] + logf(l[r]) : 0.f;
  }
  store_rows<T, D>(out, acc, inv, tx, ty, h, H, q0, T_len);
}

// --- backward: dK and dV -------------------------------------------------------

// p[r][c] = P and ds[r][c] = dS of the 4 x 4 scores a thread owns, from the
// raw products s = Q K^T and dp = dO V^T of query tile q0 and key tile k0
__device__ __forceinline__ void probs_and_ds(float s[4][4], float dp[4][4], const int* q_ok,
                                             const int* k_ok, const float* lse_s,
                                             const float* di_s, int q0, int k0, int tx, int ty,
                                             float scale, int causal) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty + 16 * r;
    const bool row_ok = q_ok[ty + 16 * r];
    const float L = lse_s[ty + 16 * r], Di = di_s[ty + 16 * r];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = k0 + tx + 16 * c;
      const bool ok = row_ok && k_ok[tx + 16 * c] && (!causal || j <= i);
      const float p = ok ? expf(s[r][c] * scale - L) : 0.f;
      s[r][c] = p;
      dp[r][c] = (dp[r][c] - Di) * p * scale;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, int64_t q_rs, int64_t q_hs,
                     const T* __restrict__ k, int64_t k_rs, int64_t k_hs,
                     const T* __restrict__ v, int64_t v_rs, int64_t v_hs,
                     const T* __restrict__ dO, int64_t do_rs, int64_t do_hs,
                     const float* __restrict__ lse, const float* __restrict__ di,
                     const int32_t* __restrict__ mask, T* __restrict__ dk, T* __restrict__ dv,
                     int T_len, int H, float scale, int causal) {
  constexpr int P = pitch<D>(), N = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                  // [64][P], resident
  float* Vs = Ks + kTile * P;        // [64][P], resident
  float* Qs = Vs + kTile * P;        // [64][P]
  float* dOs = Qs + kTile * P;       // [64][P]
  float* Ps = dOs + kTile * P;       // [64][kPPitch]
  float* dSs = Ps + kTile * kPPitch; // [64][kPPitch]
  int* k_ok = reinterpret_cast<int*>(dSs + kTile * kPPitch);
  int* q_ok = k_ok + kTile;
  float* lse_s = reinterpret_cast<float*>(q_ok + kTile);
  float* di_s = lse_s + kTile;

  const int n_tiles = (T_len + kTile - 1) / kTile;
  const int kt = blockIdx.x;  // key tile 0 sees the most query tiles: it starts first
  const int h = blockIdx.y;
  const int k0 = kt * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, D>(Ks, k, k_rs, k_hs, h, k0, T_len);
  load_tile<T, D>(Vs, v, v_rs, v_hs, h, k0, T_len);
  load_valid(k_ok, mask, k0, T_len);

  float acc_dk[4][N], acc_dv[4][N];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < N; ++c) acc_dk[r][c] = acc_dv[r][c] = 0.f;

  for (int qt = causal ? kt : 0; qt < n_tiles; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the previous query tile is consumed
    load_tile<T, D>(Qs, q, q_rs, q_hs, h, q0, T_len);
    load_tile<T, D>(dOs, dO, do_rs, do_hs, h, q0, T_len);
    load_valid(q_ok, mask, q0, T_len);
    load_rows(lse_s, lse, h, q0, T_len);
    load_rows(di_s, di, h, q0, T_len);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<D>(Qs, Ks, tx, ty, s);
    tile_dot<D>(dOs, Vs, tx, ty, dp);
    probs_and_ds(s, dp, q_ok, k_ok, lse_s, di_s, q0, k0, tx, ty, scale, causal);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        Ps[(ty + 16 * r) * kPPitch + tx + 16 * c] = s[r][c];
        dSs[(ty + 16 * r) * kPPitch + tx + 16 * c] = dp[r][c];
      }
    __syncthreads();
    // key rows ty + 16r: dV += P^T dO, dK += dS^T Q
    tile_wtx<D>(Ps, dOs, tx, ty, acc_dv);
    tile_wtx<D>(dSs, Qs, tx, ty, acc_dk);
  }

  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<T, D>(dk, acc_dk, one, tx, ty, h, H, k0, T_len);
  store_rows<T, D>(dv, acc_dv, one, tx, ty, h, H, k0, T_len);
}

// --- backward: dQ --------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, int64_t q_rs, int64_t q_hs,
                    const T* __restrict__ k, int64_t k_rs, int64_t k_hs,
                    const T* __restrict__ v, int64_t v_rs, int64_t v_hs,
                    const T* __restrict__ dO, int64_t do_rs, int64_t do_hs,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    const int32_t* __restrict__ mask, T* __restrict__ dq,
                    int T_len, int H, float scale, int causal) {
  constexpr int P = pitch<D>(), N = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // [64][P], resident
  float* dOs = Qs + kTile * P;       // [64][P], resident
  float* Ks = dOs + kTile * P;       // [64][P]
  float* Vs = Ks + kTile * P;        // [64][P], then dS [64][kPPitch]
  int* q_ok = reinterpret_cast<int*>(Vs + region<D>());
  int* k_ok = q_ok + kTile;
  float* lse_s = reinterpret_cast<float*>(k_ok + kTile);
  float* di_s = lse_s + kTile;

  const int n_tiles = (T_len + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y;
  const int q0 = qt * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, D>(Qs, q, q_rs, q_hs, h, q0, T_len);
  load_tile<T, D>(dOs, dO, do_rs, do_hs, h, q0, T_len);
  load_valid(q_ok, mask, q0, T_len);
  load_rows(lse_s, lse, h, q0, T_len);
  load_rows(di_s, di, h, q0, T_len);

  float acc[4][N];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < N; ++c) acc[r][c] = 0.f;

  const int kt_end = causal ? qt + 1 : n_tiles;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous dS and K are consumed
    load_tile<T, D>(Ks, k, k_rs, k_hs, h, k0, T_len);
    load_tile<T, D>(Vs, v, v_rs, v_hs, h, k0, T_len);
    load_valid(k_ok, mask, k0, T_len);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<D>(Qs, Ks, tx, ty, s);
    tile_dot<D>(dOs, Vs, tx, ty, dp);
    probs_and_ds(s, dp, q_ok, k_ok, lse_s, di_s, q0, k0, tx, ty, scale, causal);
    __syncthreads();  // every thread is done reading V
    float* dSs = Vs;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) dSs[(ty + 16 * r) * kPPitch + tx + 16 * c] = dp[r][c];
    __syncthreads();
    tile_wx<D>(dSs, Ks, tx, ty, acc);
  }

  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<T, D>(dq, acc, one, tx, ty, h, H, q0, T_len);
}

// --- launchers -------------------------------------------------------------------

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * kTile * pitch<D>() + region<D>()) + 2 * kTile * sizeof(int);
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * kTile * pitch<D>() + 2 * kTile * kPPitch) + 4 * kTile * 4;
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (3 * kTile * pitch<D>() + region<D>()) + 4 * kTile * 4;
}

struct Operand {
  const void* p;
  long long rs, hs;
};

template <typename T>
const T* ptr(const Operand& o) { return static_cast<const T*>(o.p); }

template <typename T, int D>
cudaError_t launch_fwd(Operand q, Operand k, Operand v, const void* mask, void* out, void* lse,
                       int T_len, int H, float scale, int causal, cudaStream_t s) {
  constexpr size_t smem = fwd_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((T_len + kTile - 1) / kTile, H);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, s>>>(
      ptr<T>(q), q.rs, q.hs, ptr<T>(k), k.rs, k.hs, ptr<T>(v), v.rs, v.hs,
      static_cast<const int32_t*>(mask), static_cast<T*>(out), static_cast<float*>(lse), T_len,
      H, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(Operand q, Operand k, Operand v, Operand dO, const void* lse,
                       const void* di, const void* mask, void* dk, void* dv, int T_len, int H,
                       float scale, int causal, cudaStream_t s) {
  constexpr size_t smem = dkv_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((T_len + kTile - 1) / kTile, H);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, s>>>(
      ptr<T>(q), q.rs, q.hs, ptr<T>(k), k.rs, k.hs, ptr<T>(v), v.rs, v.hs, ptr<T>(dO), dO.rs,
      dO.hs, static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<const int32_t*>(mask), static_cast<T*>(dk), static_cast<T*>(dv), T_len, H,
      scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(Operand q, Operand k, Operand v, Operand dO, const void* lse,
                      const void* di, const void* mask, void* dq, int T_len, int H, float scale,
                      int causal, cudaStream_t s) {
  constexpr size_t smem = dq_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((T_len + kTile - 1) / kTile, H);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, s>>>(
      ptr<T>(q), q.rs, q.hs, ptr<T>(k), k.rs, k.hs, ptr<T>(v), v.rs, v.hs, ptr<T>(dO), dO.rs,
      dO.hs, static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<const int32_t*>(mask), static_cast<T*>(dq), T_len, H, scale, causal);
  return cudaGetLastError();
}

// Calls LAUNCH<T, D>(args...) for the runtime dtype and head width; an
// unsupported pair is cudaErrorInvalidValue.
#define DG_DISPATCH(LAUNCH, dtype, D, ...)                                        \
  do {                                                                           \
    if (dtype == kF32) {                                                         \
      if (D == 32) return static_cast<int>(LAUNCH<float, 32>(__VA_ARGS__));      \
      if (D == 64) return static_cast<int>(LAUNCH<float, 64>(__VA_ARGS__));      \
      if (D == 128) return static_cast<int>(LAUNCH<float, 128>(__VA_ARGS__));    \
    } else if (dtype == kBF16) {                                                 \
      if (D == 32) return static_cast<int>(LAUNCH<__nv_bfloat16, 32>(__VA_ARGS__));   \
      if (D == 64) return static_cast<int>(LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__));   \
      if (D == 128) return static_cast<int>(LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__)); \
    }                                                                            \
    return static_cast<int>(cudaErrorInvalidValue);                              \
  } while (0)

}  // namespace

extern "C" {

// out [T, H, D] (contiguous, input dtype) and lse [H, T] (f32) from q, k, v
// [T, H, D] (each with its row and head strides in elements, unit stride
// over D); mask [T] int32 or null; D in {32, 64, 128}; dtype 0 = float32,
// 1 = bfloat16.
int dg_flash_attention_fwd(const void* q, long long q_rs, long long q_hs, const void* k,
                           long long k_rs, long long k_hs, const void* v, long long v_rs,
                           long long v_hs, const void* mask, void* out, void* lse, int T, int H,
                           int D, float scale, int causal, int dtype, void* stream) {
  if (T <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cudaError_t e = bind_device_of(q)) return static_cast<int>(e);
  DG_DISPATCH(launch_fwd, dtype, D, Operand{q, q_rs, q_hs}, Operand{k, k_rs, k_hs},
              Operand{v, v_rs, v_hs}, mask, out, lse, T, H, scale, causal, s);
}

// dk, dv [T, H, D] (contiguous, input dtype) from q, k, v, do [T, H, D]
// (strided as above), lse and di [H, T] f32 and the mask of the forward.
int dg_flash_attention_bwd_dkv(const void* q, long long q_rs, long long q_hs, const void* k,
                               long long k_rs, long long k_hs, const void* v, long long v_rs,
                               long long v_hs, const void* dO, long long do_rs,
                               long long do_hs, const void* lse, const void* di,
                               const void* mask, void* dk, void* dv, int T, int H, int D,
                               float scale, int causal, int dtype, void* stream) {
  if (T <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cudaError_t e = bind_device_of(q)) return static_cast<int>(e);
  DG_DISPATCH(launch_dkv, dtype, D, Operand{q, q_rs, q_hs}, Operand{k, k_rs, k_hs},
              Operand{v, v_rs, v_hs}, Operand{dO, do_rs, do_hs}, lse, di, mask, dk, dv, T, H,
              scale, causal, s);
}

// dq [T, H, D] (contiguous, input dtype) from the same operands.
int dg_flash_attention_bwd_dq(const void* q, long long q_rs, long long q_hs, const void* k,
                              long long k_rs, long long k_hs, const void* v, long long v_rs,
                              long long v_hs, const void* dO, long long do_rs, long long do_hs,
                              const void* lse, const void* di, const void* mask, void* dq,
                              int T, int H, int D, float scale, int causal, int dtype,
                              void* stream) {
  if (T <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cudaError_t e = bind_device_of(q)) return static_cast<int>(e);
  DG_DISPATCH(launch_dq, dtype, D, Operand{q, q_rs, q_hs}, Operand{k, k_rs, k_hs},
              Operand{v, v_rs, v_hs}, Operand{dO, do_rs, do_hs}, lse, di, mask, dq, T, H,
              scale, causal, s);
}

}  // extern "C"
