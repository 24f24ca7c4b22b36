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
// and head strides (f32: multiples of 4 elements, rows 16-byte aligned, for
// the CUDA cores' 16-byte loads; bf16: multiples of 8 elements, base 16-byte
// aligned, as TMA needs): the
// LM's q, k and v are column slices of one [T, 3L] qkv tensor and reach the
// kernels without a copy. O, dQ, dK and dV are contiguous [T, H, D] in the
// input dtype; lse and di are [H, T] f32. The optional mask is [T] int32
// (nonzero = a real position); it masks keys and queries alike, so a padded
// query row is an empty row: O = 0 there, and it contributes nothing to any
// gradient (the dense oracle zeroes those rows, parallel/sequence.py:161-166).
// The mask as a whole is
//   allowed(i, j) = i < T && j < T && mask[i] && mask[j] && (!causal || j <= i).
// A row with no allowed key gets O = 0 and lse = 0 (its P is zero by the
// mask, never by the value of lse).
//
// Three designs (DG_DISPATCH picks by dtype):
//
// f32 dK/dV and dQ: the CUDA cores. One block of 256 threads (16 x 16) per
// (64-row tile, head). A block stages f32 tiles of 64 rows in shared memory,
// each with a row pitch of D + 4 floats so that the 16-byte reads of 16
// different rows fall in different banks. Thread (tx, ty) owns the 4 x 4
// scores of rows ty + 16r and columns tx + 16c: a score tile is 4 x 4 outer
// products of 16-byte row slices. The output accumulators (dK, dV or dQ
// rows) stay in registers, D / 16 columns a row a thread.
//   dkv: one block per key tile keeps K and V, loops over the query tiles
//        at or below the diagonal, recomputes P from lse and writes P and dS
//        to shared memory for the two transposed products. 171 KB: one
//        block an SM.
//   dq:  one block per query tile keeps Q and dO, loops over key tiles up to
//        the diagonal; dS overwrites the value tile for dS K. 136 KB.
// Every sum is taken by one thread in a fixed order: no atomics, the same
// bits on every launch. The blocks with the most tiles under a causal mask
// are numbered first so that they start first.
// Bound: operations. At T = 8192, H = 4, D = 128 (causal) dK/dV is 4 * 2 *
// D * H * T(T+1)/2 = 1.4e11 FLOP (four products), dQ 1.0e11 (three): 2.1
// and 1.5 ms at the card's 67 TFLOP/s of f32 outside the tensor cores,
// against about 0.03 ms for the bytes.
//
// bf16, every kernel: the tensor cores (sm90.cuh). At the same shape the
// forward's 6.9e10 FLOP, dK/dV's 1.4e11 and dQ's 1.0e11 are 0.07, 0.14 and
// 0.10 ms at the bf16 rate of 989 TFLOP/s, still far above the bytes
// (0.01-0.02 ms): the bound is the tensor cores, and f32 FMAs on the CUDA
// cores (a sixteenth of that rate, fed from shared memory) were 37-52x
// short of it. So every product is a wgmma (m64nNk16, bf16 in, f32
// accumulators in registers), its operands staged by TMA, and nothing but
// the products' fragments touches registers:
//   - A block is two warpgroups (256 threads), each with its own 64-row
//     share of the tile. Warp 0 also feeds a TMA ring (2 stages in the
//     forward, 3 in dK/dV and dQ) guarded by full / empty mbarriers: its
//     lanes wait for a stage to be empty and write the stage's per-row terms
//     (the key bias, or lse and di), and lane 0 issues the
//     cp.async.bulk.tensor loads ahead of the warpgroups. There is no
//     producer warpgroup: with one (384 threads, setmaxnreg 40 / 232) the
//     block launches at 168 registers a thread, and ptxas bounded the wgmma
//     pipeline by that count, serialized every wgmma of the D = 128 kernels
//     and spilled (80 and 304 bytes); at 256 threads a thread may hold 255,
//     and no kernel spills.
//   - Tensor maps are 3-D over [T, H, D] with the caller's strides, boxes of
//     64 columns with the 128-byte swizzle (D = 128 is two boxes) or of 32
//     with the 64-byte one (D = 32), so the LM's column slices load in place
//     and rows past T arrive as zeros.
//   - fwd: a block per (128 query rows, head), heaviest causal tiles first;
//     each warpgroup owns 64 rows (wgmma's M). Q stays; K and V stream in
//     128-key tiles. S = Q K^T reads both from shared memory (K-major); the
//     online softmax runs on the accumulator fragments (a row is the 4
//     lanes of a quad: two shuffles); P is rounded to bf16 in registers, as
//     the Pallas kernel rounds it before P V (flash_attention.py:471), and
//     is the A operand of O += P V, whose B is the V tile read MN-major
//     (the transpose bit; no copy). Masks apply only where they can bite:
//     the key bias on a masked or tail tile, the causal test on the
//     diagonal tile, where the loop ends. 160 KB of shared memory at D = 128.
//   - dkv: a block per (128 keys, head); each warpgroup owns 64 keys and
//     keeps its dK and dV accumulators in registers to the end, over Q and
//     dO tiles of 64 queries streamed from the diagonal. Per tile: S^T = K
//     Q^T and dP^T = V dO^T from shared memory; P^T and dS^T in registers;
//     dV += P^T dO and dK += dS^T Q with P^T and dS^T rounded to bf16 as A
//     from registers (flash_attention.py:900, :918) and dO, Q read
//     MN-major. The tile's elementwise work leaves the tensor cores idle
//     unless the other warpgroup uses them, so the two take their
//     tensor-core sections in turns (named barriers 1 and 2): one section
//     issues tile t - 1's dV, dK and tile t's S^T, dP^T products. 160 KB at
//     D = 128.
//   - dq: 7a with the roles swapped: a block per (128 query rows, head),
//     heaviest causal tiles first; each warpgroup keeps its 64 rows' dQ in
//     registers over K and V tiles of 64 keys streamed up to the diagonal.
//     Q and dO stay; a row's lse and di are read once into registers (a
//     masked row's lse is +inf: its P is 0). Per tile: S = Q K^T and dP =
//     dO V^T from shared memory; dS = P (dP - di) scale in registers,
//     rounded to bf16 (flash_attention.py:1258) as the A operand of dQ +=
//     dS K, whose B is the same K tile read MN-major. The two warpgroups take
//     their sections in turns as in dK/dV. Under a causal mask warpgroup 0
//     runs the diagonal's second key tile too, whose keys are above all its
//     rows (P = 0 there): a branch on the warpgroup would make ptxas
//     serialize the wgmma (C7520). 160 KB at D = 128.
//
// f32 forward: the tensor cores in split TF32 (3xTF32). TF32 alone keeps 11
// bits of each operand, too few for the parity with the f32 plain version
// (chip_smoke.py reads that control); x = hi + lo with hi and lo in
// TF32, and a product as lo hi + hi lo + hi hi, small terms first, keeps
// about 2^-21 of it, near f32. Three TF32 products are 3 x 6.9e10 FLOP at
// 495 TFLOP/s, 0.42 ms at lm_flash, against 1.0 ms for f32 on the CUDA
// cores. TF32 wgmma reads shared-memory operands K-major only (the transpose
// bit is bf16's), so V, whose reduction index (keys) runs down its rows, is
// no direct B operand of O += P V:
//   - split_kv_tf32_kernel first writes K hi and lo as [H, T_pad, D] and V^T
//     hi and lo as [H, D, T_pad] into the caller's scratch. P comes from an
//     accumulator, whose thread holds columns 2c, 2c + 1 of an 8-key slice
//     where a TF32 A fragment holds c, c + 4 (sm90.cuh, tf32_frag): the V^T
//     keys are stored in that order within each 8, so P needs no shuffle.
//   - The kernel is the bf16 forward's block (128 query rows, two
//     warpgroups, warp 0 feeding a 2-stage TMA ring) with 32-key tiles: a
//     stage holds K hi, K lo, V^T hi and V^T lo, 64 KB at D = 128, and two
//     stages and Q take 192 KB. Q is read once into shared memory as each
//     thread's A fragments and split in registers at each use, four 8-column
//     slices at a time into a double buffer, so that the registers of a batch
//     are rewritten only after its wgmma have been waited for. S = Q K^T and
//     O += P V are m64n32k8 and m64nDk8 wgmma with A from registers; the
//     online softmax is the bf16 kernel's in f32 with expf.
//   - The tensor cores add to an accumulator at about f32's precision,
//     rounding toward zero, so no accumulator takes a long chain: S keeps
//     its small terms and its hi hi terms apart (the latter in two
//     accumulators, by batch), and a tile's P V gets an accumulator of its
//     own, added to O in f32 (O = O alpha + P V).
// Each kernel writes each output element once: no atomics, the same bits on
// every launch.
//
// Plain C interface, loaded with ctypes (dgraph_tpu_torch/ops/_build.py).
// Each entry point launches on the caller's stream, allocates nothing and
// returns the first CUDA error (cudaFuncSetAttribute's or the launch's).

#include <limits.h>
#include <math.h>

#include <type_traits>

#include "sm90.cuh"
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

// --- the tensor cores (sm_90a): bf16 -----------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kThreadsTC = 256;  // two warpgroups of 128 threads
constexpr int kStages = 2;       // depth of the forward's TMA ring
constexpr int kDkvStages = 3;    // and of dK/dV's, which holds two tiles at a time
constexpr int kBlockRows = 128;  // fwd, dq: queries; dkv: keys of a block (64 a warpgroup)
constexpr int kFwdKeys = 128;    // fwd: keys of a streamed tile
constexpr int kDkvRows = 64;     // dkv: queries of a streamed tile
constexpr int kDqKeys = 64;      // dq: keys of a streamed tile
constexpr int kDqStages = 3;     // dq's ring, which holds two tiles at a time as dK/dV's does
constexpr int kTfKeys = 32;      // f32 forward: keys of a streamed tile (split TF32)
constexpr int kTfStages = 2;
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = sm90::smem_addr(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// 2^x on the special-function unit (flushes results below 2^-126 to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The ring's protocol. Tile t sits in stage t % STAGES; its full barrier
// completes when the loads land (one arrival with the byte count), its
// empty barrier when the lane 0 of each of the 8 warps has arrived after
// the warp's last wgmma on it. Warp 0 refills a stage: its lanes wait for
// the stage to be empty, write the stage's per-row terms, and lane 0 issues
// the loads.
template <int STAGES>
__device__ __forceinline__ void wait_empty(uint64_t* empty, int t) {
  if (t >= STAGES) sm90::mbar_wait(&empty[t % STAGES], ((t / STAGES) - 1) & 1);
}
template <int STAGES>
__device__ __forceinline__ void wait_full(uint64_t* full, int t) {
  sm90::mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
}

// Named barriers 1 and 2 take the two warpgroups' tensor-core sections in
// turns: a warpgroup waits on its own barrier before it issues, and arrives
// on the other's once it has issued.
__device__ __forceinline__ void turn_wait(int wgi) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + wgi), "n"(kThreadsTC) : "memory");
}
__device__ __forceinline__ void turn_pass(int wgi) {
  asm volatile("bar.arrive %0, %1;" ::"r"(2 - wgi), "n"(kThreadsTC) : "memory");
}

// rows row_a and row_a + 8 of a [64][D] accumulator fragment to the
// contiguous [T, H, D] bf16 output at head h, times mul_a / mul_b
template <int D>
__device__ __forceinline__ void store_frag(bf16* __restrict__ out, const float (&acc)[D / 2],
                                           int row_a, float mul_a, float mul_b, int c, int h,
                                           int H, int T_len) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = row_a + 8 * half;
    if (t >= T_len) continue;
    const float mul = half ? mul_b : mul_a;
    uint32_t* o = reinterpret_cast<uint32_t*>(out + (static_cast<int64_t>(t) * H + h) * D);
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      o[4 * i + c] = sm90::pack_bf16(acc[4 * i + 2 * half] * mul, acc[4 * i + 2 * half + 1] * mul);
  }
}

// Forward. Shared memory (offsets from a 1024-aligned base): the Q tile,
// the K and V rings, each stage's key bias (0, or -inf for a masked or
// absent key) and the barriers.
template <int D>
struct FwdSmem {
  static constexpr int KT = kFwdKeys * D * 2;  // a K or V stage; Q is as tall
  static constexpr int Q = 0;
  static constexpr int K = kBlockRows * D * 2;
  static constexpr int V = K + kStages * KT;
  static constexpr int KBIAS = V + kStages * KT;
  static constexpr int BAR = KBIAS + kStages * kFwdKeys * 4;  // q_full, full[S], empty[S]
  static constexpr int BYTES = BAR + (1 + 2 * kStages) * 8 + 1024;
};

// warp 0 of the bf16 forward and of dQ: key tile t (its keys' bias, K and
// V) into its stage of a ring of STAGES tiles of KEYS keys (offsets S)
template <int D, int KEYS, int STAGES, typename S>
__device__ __forceinline__ void kv_load(uint8_t* smem, const CUtensorMap* k_map,
                                        const CUtensorMap* v_map, const int32_t* mask,
                                        uint64_t* full, uint64_t* empty, int t, int h, int T_len,
                                        int lane) {
  using Tl = sm90::Tile<D>;
  const int s = t % STAGES, k0 = t * KEYS;
  wait_empty<STAGES>(empty, t);
  float* kbias = reinterpret_cast<float*>(smem + S::KBIAS) + s * KEYS;
  for (int r = lane; r < KEYS; r += 32) {
    const int j = k0 + r;
    kbias[r] = j < T_len && (mask == nullptr || mask[j] != 0) ? 0.f : -INFINITY;
  }
  __syncwarp();
  if (lane == 0) {
    sm90::mbar_arrive_expect_tx(&full[s], 2 * Tl::template bytes<KEYS>());
    for (int b = 0; b < Tl::NBOX; ++b) {
      sm90::tma_load_3d(smem + S::K + s * S::KT + b * KEYS * Tl::RB, k_map, &full[s],
                        b * Tl::COLS, h, k0);
      sm90::tma_load_3d(smem + S::V + s * S::KT + b * KEYS * Tl::RB, v_map, &full[s],
                        b * Tl::COLS, h, k0);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsTC, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map, const int32_t* __restrict__ mask,
                    bf16* __restrict__ out, float* __restrict__ lse, int T_len, int H,
                    float scale, int causal) {
  using S = FwdSmem<D>;
  using Tl = sm90::Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t sbase = sm90::smem_addr(smem);
  const float* kbias = reinterpret_cast<const float*>(smem + S::KBIAS);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int n_tiles = (T_len + kBlockRows - 1) / kBlockRows;
  const int qt = n_tiles - 1 - static_cast<int>(blockIdx.x);  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int q0 = qt * kBlockRows;
  const int n_kv = causal ? qt + 1 : n_tiles;  // key tiles are as tall as query tiles
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kThreadsTC / 32);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (warp == 0) {
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(q_full, Tl::template bytes<kBlockRows>());
      for (int b = 0; b < Tl::NBOX; ++b)
        sm90::tma_load_3d(smem + S::Q + b * kBlockRows * Tl::RB, &q_map, q_full, b * Tl::COLS, h,
                          q0);
    }
    for (int t = 0; t < kStages && t < n_kv; ++t)
      kv_load<D, kFwdKeys, kStages, S>(smem, &k_map, &v_map, mask, full, empty, t, h,
                                        T_len, lane);
  }

  // warpgroup wgi owns query rows q0 + 64 wgi .. + 63
  const int wgi = warp / 4, g = lane / 4, c = lane % 4;
  const int row_a = q0 + 64 * wgi + 16 * (warp % 4) + g, row_b = row_a + 8;
  const float sl2 = scale * kLog2e;  // logits in log2 units
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  sm90::mbar_wait(q_full, 0);
  for (int kt = 0; kt < n_kv; ++kt) {
    // refill the stage that tile kt - 1 held with tile kt - 1 + kStages
    if (warp == 0 && kt > 0 && kt - 1 + kStages < n_kv)
      kv_load<D, kFwdKeys, kStages, S>(smem, &k_map, &v_map, mask, full, empty,
                                       kt - 1 + kStages, h, T_len, lane);
    const int s = kt % kStages;
    const int k0 = kt * kFwdKeys;
    wait_full<kStages>(full, kt);

    // S = Q K^T: [64 rows][128 keys]
    float sc[kFwdKeys / 2];
    sm90::wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      sm90::wgmma_ss(sc, sm90::kmajor_desc<D, kBlockRows>(sbase + S::Q, 64 * wgi, k),
                     sm90::kmajor_desc<D, kFwdKeys>(sbase + S::K + s * S::KT, 0, k), k > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);

#pragma unroll
    for (int i = 0; i < kFwdKeys / 2; ++i) sc[i] *= sl2;
    if (mask != nullptr || k0 + kFwdKeys > T_len) {
      const float* kb = kbias + s * kFwdKeys;
#pragma unroll
      for (int i = 0; i < kFwdKeys / 8; ++i) {
        const float2 b = *reinterpret_cast<const float2*>(kb + 8 * i + 2 * c);
        sc[4 * i] += b.x;
        sc[4 * i + 1] += b.y;
        sc[4 * i + 2] += b.x;
        sc[4 * i + 3] += b.y;
      }
    }
    if (causal && kt == n_kv - 1) {  // the diagonal tile
#pragma unroll
      for (int i = 0; i < kFwdKeys / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = k0 + 8 * i + 2 * c + e;
          if (j > row_a) sc[4 * i + e] = -INFINITY;
          if (j > row_b) sc[4 * i + 2 + e] = -INFINITY;
        }
    }

    // online softmax: a row lives in the 4 lanes of a quad
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int i = 0; i < kFwdKeys / 8; ++i) {
      mx_a = fmaxf(mx_a, fmaxf(sc[4 * i], sc[4 * i + 1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
    // a row with no allowed key so far keeps p = 0 and l = 0
    const float mu_a = mn_a == -INFINITY ? 0.f : mn_a, mu_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float al_a = exp2_approx(m_a - mu_a), al_b = exp2_approx(m_b - mu_b);
    m_a = mn_a;
    m_b = mn_b;
    float ls_a = 0.f, ls_b = 0.f;
#pragma unroll
    for (int i = 0; i < kFwdKeys / 8; ++i) {
      sc[4 * i] = exp2_approx(sc[4 * i] - mu_a);
      sc[4 * i + 1] = exp2_approx(sc[4 * i + 1] - mu_a);
      sc[4 * i + 2] = exp2_approx(sc[4 * i + 2] - mu_b);
      sc[4 * i + 3] = exp2_approx(sc[4 * i + 3] - mu_b);
      ls_a += sc[4 * i] + sc[4 * i + 1];
      ls_b += sc[4 * i + 2] + sc[4 * i + 3];
    }
    l_a = l_a * al_a + ls_a;  // this thread's share of the row sum
    l_b = l_b * al_b + ls_b;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[4 * i] *= al_a;
      o[4 * i + 1] *= al_a;
      o[4 * i + 2] *= al_b;
      o[4 * i + 3] *= al_b;
    }

    // O += P V: P rounded to bf16 in registers (flash_attention.py:471)
    uint32_t pf[kFwdKeys / 16][4];
#pragma unroll
    for (int k = 0; k < kFwdKeys / 16; ++k) sm90::pack_a(sc, k, pf[k]);
    sm90::wgmma_fence();
#pragma unroll
    for (int k = 0; k < kFwdKeys / 16; ++k)
      sm90::wgmma_rs(o, pf[k], sm90::mnmajor_desc<D, kFwdKeys>(sbase + S::V + s * S::KT, k));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
    sm90::fence_regs(pf);
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  // a padded query row is an empty row: O = 0, lse = 0
  const bool va = row_a < T_len && (mask == nullptr || mask[row_a] != 0) && l_a > 0.f;
  const bool vb = row_b < T_len && (mask == nullptr || mask[row_b] != 0) && l_b > 0.f;
  if (c == 0) {
    if (row_a < T_len)
      lse[static_cast<int64_t>(h) * T_len + row_a] = va ? m_a * kLn2 + logf(l_a) : 0.f;
    if (row_b < T_len)
      lse[static_cast<int64_t>(h) * T_len + row_b] = vb ? m_b * kLn2 + logf(l_b) : 0.f;
  }
  store_frag<D>(out, o, row_a, va ? 1.f / l_a : 0.f, vb ? 1.f / l_b : 0.f, c, h, H, T_len);
}

// dK/dV. Shared memory: the block's K and V tiles (resident), the Q and dO
// rings, each stage's lse (times log2 e; +inf for an empty or absent query
// row, so its P is 0) and di, and the barriers.
template <int D>
struct DkvSmem {
  static constexpr int KV = kBlockRows * D * 2;
  static constexpr int QT = kDkvRows * D * 2;
  static constexpr int K = 0;
  static constexpr int V = KV;
  static constexpr int Q = 2 * KV;
  static constexpr int DO = Q + kDkvStages * QT;
  static constexpr int LSE = DO + kDkvStages * QT;
  static constexpr int DI = LSE + kDkvStages * kDkvRows * 4;
  static constexpr int BAR = DI + kDkvStages * kDkvRows * 4;  // kv_full, full[S], empty[S]
  static constexpr int BYTES = BAR + (1 + 2 * kDkvStages) * 8 + 1024;
};

// warp 0 of dK/dV: query tile t (its rows' lse and di, Q and dO) into its stage
template <int D>
__device__ __forceinline__ void dkv_load(uint8_t* smem, const CUtensorMap* q_map,
                                         const CUtensorMap* do_map, const float* lse,
                                         const float* di, const int32_t* mask, uint64_t* full,
                                         uint64_t* empty, int t, int qt0, int h, int T_len,
                                         int lane) {
  using S = DkvSmem<D>;
  using Tl = sm90::Tile<D>;
  const int s = t % kDkvStages, q0 = (qt0 + t) * kDkvRows;
  wait_empty<kDkvStages>(empty, t);
  float* lse_s = reinterpret_cast<float*>(smem + S::LSE) + s * kDkvRows;
  float* di_s = reinterpret_cast<float*>(smem + S::DI) + s * kDkvRows;
  for (int r = lane; r < kDkvRows; r += 32) {
    const int q = q0 + r;
    const bool real = q < T_len;
    const int64_t at = static_cast<int64_t>(h) * T_len + q;
    lse_s[r] = real && (mask == nullptr || mask[q] != 0) ? lse[at] * kLog2e : INFINITY;
    di_s[r] = real ? di[at] : 0.f;
  }
  __syncwarp();
  if (lane == 0) {
    sm90::mbar_arrive_expect_tx(&full[s], 2 * Tl::template bytes<kDkvRows>());
    for (int b = 0; b < Tl::NBOX; ++b) {
      sm90::tma_load_3d(smem + S::Q + s * S::QT + b * kDkvRows * Tl::RB, q_map, &full[s],
                        b * Tl::COLS, h, q0);
      sm90::tma_load_3d(smem + S::DO + s * S::QT + b * kDkvRows * Tl::RB, do_map, &full[s],
                        b * Tl::COLS, h, q0);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsTC, 1)
flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ CUtensorMap do_map,
                        const float* __restrict__ lse, const float* __restrict__ di,
                        const int32_t* __restrict__ mask, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int T_len, int H, float scale, int causal) {
  using S = DkvSmem<D>;
  using Tl = sm90::Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t sbase = sm90::smem_addr(smem);
  const float* lse_s = reinterpret_cast<const float*>(smem + S::LSE);
  const float* di_s = reinterpret_cast<const float*>(smem + S::DI);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kDkvStages;

  const int h = blockIdx.y;
  const int k0 = static_cast<int>(blockIdx.x) * kBlockRows;  // key tile 0 has the most work
  const int qt0 = causal ? k0 / kDkvRows : 0;  // first query tile at or below the diagonal
  const int n_it = (T_len + kDkvRows - 1) / kDkvRows - qt0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < kDkvStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kThreadsTC / 32);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (warp == 0) {
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(kv_full, 2 * Tl::template bytes<kBlockRows>());
      for (int b = 0; b < Tl::NBOX; ++b) {
        sm90::tma_load_3d(smem + S::K + b * kBlockRows * Tl::RB, &k_map, kv_full, b * Tl::COLS,
                          h, k0);
        sm90::tma_load_3d(smem + S::V + b * kBlockRows * Tl::RB, &v_map, kv_full, b * Tl::COLS,
                          h, k0);
      }
    }
    for (int t = 0; t < kDkvStages && t < n_it; ++t)
      dkv_load<D>(smem, &q_map, &do_map, lse, di, mask, full, empty, t, qt0, h, T_len, lane);
  }

  // warpgroup wgi owns keys k0 + 64 wgi .. + 63, and their dK and dV
  const int wgi = warp / 4, g = lane / 4, c = lane % 4;
  const int j_a = k0 + 64 * wgi + 16 * (warp % 4) + g, j_b = j_a + 8;
  const bool ok_a = j_a < T_len && (mask == nullptr || mask[j_a] != 0);
  const bool ok_b = j_b < T_len && (mask == nullptr || mask[j_b] != 0);
  const float sl2 = scale * kLog2e;
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  // Tile it's products run in two tensor-core sections of the warpgroup,
  // taken in turns with the other warpgroup's: S^T = K Q^T and dP^T = V
  // dO^T in section it, dV += P^T dO and dK += dS^T Q in section it + 1,
  // and P^T and dS^T in registers between them, while the other warpgroup
  // has the tensor cores. Tile it's stage is released after section it + 1.
  uint32_t pf[kDkvRows / 16][4], df[kDkvRows / 16][4];
  float st[kDkvRows / 2], dpt[kDkvRows / 2];
  if (wgi == 1) turn_pass(wgi);  // warpgroup 0 goes first
  sm90::mbar_wait(kv_full, 0);
  for (int it = 0; it <= n_it; ++it) {
    // refill the stage that tile it - 2 held (released after section it - 1)
    if (warp == 0 && it >= 2 && it + kDkvStages - 2 < n_it)
      dkv_load<D>(smem, &q_map, &do_map, lse, di, mask, full, empty, it + kDkvStages - 2, qt0,
                  h, T_len, lane);
    const int s = it % kDkvStages, sp = (it + kDkvStages - 1) % kDkvStages;
    if (it < n_it) wait_full<kDkvStages>(full, it);
    const uint32_t q_s = sbase + S::Q + s * S::QT, do_s = sbase + S::DO + s * S::QT;
    const uint32_t q_p = sbase + S::Q + sp * S::QT, do_p = sbase + S::DO + sp * S::QT;

    turn_wait(wgi);
    sm90::wgmma_fence();
    if (it > 0) {
      // tile it - 1: dV += P^T dO and dK += dS^T Q, P^T and dS^T rounded to
      // bf16 in registers (flash_attention.py:900, :918)
#pragma unroll
      for (int k = 0; k < kDkvRows / 16; ++k)
        sm90::wgmma_rs(dv_acc, pf[k], sm90::mnmajor_desc<D, kDkvRows>(do_p, k));
#pragma unroll
      for (int k = 0; k < kDkvRows / 16; ++k)
        sm90::wgmma_rs(dk_acc, df[k], sm90::mnmajor_desc<D, kDkvRows>(q_p, k));
    }
    if (it < n_it) {
      // tile it: S^T = K Q^T and dP^T = V dO^T, [64 keys][64 queries]
#pragma unroll
      for (int k = 0; k < D / 16; ++k)
        sm90::wgmma_ss(st, sm90::kmajor_desc<D, kBlockRows>(sbase + S::K, 64 * wgi, k),
                       sm90::kmajor_desc<D, kDkvRows>(q_s, 0, k), k > 0);
#pragma unroll
      for (int k = 0; k < D / 16; ++k)
        sm90::wgmma_ss(dpt, sm90::kmajor_desc<D, kBlockRows>(sbase + S::V, 64 * wgi, k),
                       sm90::kmajor_desc<D, kDkvRows>(do_s, 0, k), k > 0);
    }
    sm90::wgmma_commit();
    turn_pass(wgi);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dv_acc);
    sm90::fence_regs(dk_acc);
    sm90::fence_regs(pf);
    sm90::fence_regs(df);
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);
    if (it > 0 && lane == 0) sm90::mbar_arrive(&empty[sp]);
    if (it == n_it) break;

    // P^T = exp(scale S^T - lse) on the allowed pairs, dS^T = P^T (dP^T - di) scale:
    // key row j keeps the queries q >= lim (every one off the diagonal, none
    // for a masked or absent key)
    const int q0 = (qt0 + it) * kDkvRows;
    const bool diag = causal && q0 < k0 + kBlockRows;
    const int lim_a = !ok_a ? INT_MAX : diag ? j_a : INT_MIN;
    const int lim_b = !ok_b ? INT_MAX : diag ? j_b : INT_MIN;
    const float* ls = lse_s + s * kDkvRows;
    const float* ds = di_s + s * kDkvRows;
#pragma unroll
    for (int i = 0; i < kDkvRows / 8; ++i) {
      const float2 L = *reinterpret_cast<const float2*>(ls + 8 * i + 2 * c);
      const float2 Di = *reinterpret_cast<const float2*>(ds + 8 * i + 2 * c);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = q0 + 8 * i + 2 * c + e;
        const float le = e ? L.y : L.x, de = e ? Di.y : Di.x;
        float pa = exp2_approx(fmaf(st[4 * i + e], sl2, -le));
        float pb = exp2_approx(fmaf(st[4 * i + 2 + e], sl2, -le));
        if (q < lim_a) pa = 0.f;
        if (q < lim_b) pb = 0.f;
        st[4 * i + e] = pa;
        st[4 * i + 2 + e] = pb;
        dpt[4 * i + e] = (dpt[4 * i + e] - de) * pa * scale;
        dpt[4 * i + 2 + e] = (dpt[4 * i + 2 + e] - de) * pb * scale;
      }
    }
#pragma unroll
    for (int k = 0; k < kDkvRows / 16; ++k) {
      sm90::pack_a(st, k, pf[k]);
      sm90::pack_a(dpt, k, df[k]);
    }
  }
  store_frag<D>(dk, dk_acc, j_a, 1.f, 1.f, c, h, H, T_len);
  store_frag<D>(dv, dv_acc, j_a, 1.f, 1.f, c, h, H, T_len);
}

// dQ. Shared memory: the block's Q and dO tiles (resident), the K and V
// rings, each stage's key bias (0, or -inf for a masked or absent key) and
// the barriers.
template <int D>
struct DqSmem {
  static constexpr int QT = kBlockRows * D * 2;
  static constexpr int KT = kDqKeys * D * 2;
  static constexpr int Q = 0;
  static constexpr int DO = QT;
  static constexpr int K = 2 * QT;
  static constexpr int V = K + kDqStages * KT;
  static constexpr int KBIAS = V + kDqStages * KT;
  static constexpr int BAR = KBIAS + kDqStages * kDqKeys * 4;  // qd_full, full[S], empty[S]
  static constexpr int BYTES = BAR + (1 + 2 * kDqStages) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreadsTC, 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap do_map,
                       const float* __restrict__ lse, const float* __restrict__ di,
                       const int32_t* __restrict__ mask, bf16* __restrict__ dq, int T_len, int H,
                       float scale, int causal) {
  using S = DqSmem<D>;
  using Tl = sm90::Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t sbase = sm90::smem_addr(smem);
  const float* kbias = reinterpret_cast<const float*>(smem + S::KBIAS);
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* full = qd_full + 1;
  uint64_t* empty = full + kDqStages;

  const int n_tiles = (T_len + kBlockRows - 1) / kBlockRows;
  const int qt = n_tiles - 1 - static_cast<int>(blockIdx.x);  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int q0 = qt * kBlockRows;
  const int n_keys = (T_len + kDqKeys - 1) / kDqKeys;
  const int n_kv = causal ? min(n_keys, (q0 + kBlockRows) / kDqKeys) : n_keys;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    sm90::mbar_init(qd_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kThreadsTC / 32);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (warp == 0) {
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(qd_full, 2 * Tl::template bytes<kBlockRows>());
      for (int b = 0; b < Tl::NBOX; ++b) {
        sm90::tma_load_3d(smem + S::Q + b * kBlockRows * Tl::RB, &q_map, qd_full, b * Tl::COLS,
                          h, q0);
        sm90::tma_load_3d(smem + S::DO + b * kBlockRows * Tl::RB, &do_map, qd_full,
                          b * Tl::COLS, h, q0);
      }
    }
    for (int t = 0; t < kDqStages && t < n_kv; ++t)
      kv_load<D, kDqKeys, kDqStages, S>(smem, &k_map, &v_map, mask, full, empty, t, h,
                                         T_len, lane);
  }

  // warpgroup wgi owns query rows r0 .. r0 + 63 and their dQ; a row's lse
  // (times log2 e; +inf for an empty or absent row, so its P is 0) and di
  // are read once
  const int wgi = warp / 4, g = lane / 4, c = lane % 4;
  const int r0 = q0 + 64 * wgi;
  const int row_a = r0 + 16 * (warp % 4) + g, row_b = row_a + 8;
  float L_a = INFINITY, L_b = INFINITY, di_a = 0.f, di_b = 0.f;
  const int64_t at = static_cast<int64_t>(h) * T_len;
  if (row_a < T_len) {
    if (mask == nullptr || mask[row_a] != 0) L_a = lse[at + row_a] * kLog2e;
    di_a = di[at + row_a];
  }
  if (row_b < T_len) {
    if (mask == nullptr || mask[row_b] != 0) L_b = lse[at + row_b] * kLog2e;
    di_b = di[at + row_b];
  }
  const float sl2 = scale * kLog2e;
  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
  // Tile it's products run in two tensor-core sections of the warpgroup,
  // taken in turns with the other warpgroup's: S = Q K^T and dP = dO V^T in
  // section it, dQ += dS K in section it + 1, and dS in registers between
  // them. Tile it's stage is released after section it + 1.
  uint32_t df[kDqKeys / 16][4];
  float sc[kDqKeys / 2], dp[kDqKeys / 2];
  if (wgi == 1) turn_pass(wgi);  // warpgroup 0 goes first
  sm90::mbar_wait(qd_full, 0);
  for (int it = 0; it <= n_kv; ++it) {
    // refill the stage that tile it - 2 held (released after section it - 1)
    if (warp == 0 && it >= 2 && it + kDqStages - 2 < n_kv)
      kv_load<D, kDqKeys, kDqStages, S>(smem, &k_map, &v_map, mask, full, empty,
                                         it + kDqStages - 2, h, T_len, lane);
    const int s = it % kDqStages, sp = (it + kDqStages - 1) % kDqStages;
    if (it < n_kv) wait_full<kDqStages>(full, it);

    turn_wait(wgi);
    sm90::wgmma_fence();
    if (it > 0) {
      // tile it - 1: dQ += dS K, the K tile read MN-major
#pragma unroll
      for (int k = 0; k < kDqKeys / 16; ++k)
        sm90::wgmma_rs(dq_acc, df[k],
                       sm90::mnmajor_desc<D, kDqKeys>(sbase + S::K + sp * S::KT, k));
    }
    if (it < n_kv) {
      // tile it: S = Q K^T and dP = dO V^T, [64 rows][64 keys], K and V read K-major
      const uint32_t k_s = sbase + S::K + s * S::KT, v_s = sbase + S::V + s * S::KT;
#pragma unroll
      for (int k = 0; k < D / 16; ++k)
        sm90::wgmma_ss(sc, sm90::kmajor_desc<D, kBlockRows>(sbase + S::Q, 64 * wgi, k),
                       sm90::kmajor_desc<D, kDqKeys>(k_s, 0, k), k > 0);
#pragma unroll
      for (int k = 0; k < D / 16; ++k)
        sm90::wgmma_ss(dp, sm90::kmajor_desc<D, kBlockRows>(sbase + S::DO, 64 * wgi, k),
                       sm90::kmajor_desc<D, kDqKeys>(v_s, 0, k), k > 0);
    }
    sm90::wgmma_commit();
    turn_pass(wgi);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dq_acc);
    sm90::fence_regs(df);
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);
    if (it > 0 && lane == 0) sm90::mbar_arrive(&empty[sp]);
    if (it == n_kv) break;

    // P = 2^(S scale log2 e + bias - lse log2 e) on the allowed pairs, dS = P
    // (dP - di) scale, rounded to bf16 as the A operand of dQ += dS K
    // (flash_attention.py:1258 rounds dS to the keys' dtype)
    const int k0 = it * kDqKeys;
    const bool biased = mask != nullptr || k0 + kDqKeys > T_len;
    const bool diag = causal && k0 + kDqKeys - 1 > q0;  // the block's, not the warpgroup's
    const float* kb = kbias + s * kDqKeys;
#pragma unroll
    for (int i = 0; i < kDqKeys / 8; ++i) {
      const float2 b = biased ? *reinterpret_cast<const float2*>(kb + 8 * i + 2 * c)
                              : make_float2(0.f, 0.f);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = k0 + 8 * i + 2 * c + e;
        const float be = e ? b.y : b.x;
        float pa = exp2_approx(fmaf(sc[4 * i + e], sl2, be - L_a));
        float pb = exp2_approx(fmaf(sc[4 * i + 2 + e], sl2, be - L_b));
        if (diag && j > row_a) pa = 0.f;
        if (diag && j > row_b) pb = 0.f;
        dp[4 * i + e] = (dp[4 * i + e] - di_a) * pa * scale;
        dp[4 * i + 2 + e] = (dp[4 * i + 2 + e] - di_b) * pb * scale;
      }
    }
#pragma unroll
    for (int k = 0; k < kDqKeys / 16; ++k) sm90::pack_a(dp, k, df[k]);
  }
  store_frag<D>(dq, dq_acc, row_a, 1.f, 1.f, c, h, H, T_len);
}

// --- the tensor cores: f32 forward in split TF32 ----------------------------------

// The forward's K and V, split for the TF32 products, in the caller's
// scratch (4 H T_pad D floats, T_pad = T rounded up to kTfKeys; rows and
// keys past T are zeros): K hi and K lo as [H, T_pad, D]; V^T hi and V^T lo
// as [H, D, T_pad], keys permuted within each 8 as tf32_frag reads P
// (0, 2, 4, 6, 1, 3, 5, 7), so that O += P V has a K-major B operand.
template <int D>
__global__ void __launch_bounds__(kThreads)
split_kv_tf32_kernel(const float* __restrict__ k, int64_t k_rs, int64_t k_hs,
                     const float* __restrict__ v, int64_t v_rs, int64_t v_hs,
                     float* __restrict__ scratch, int T_len, int T_pad) {
  __shared__ float vs[kTfKeys][D + 1];
  const int h = blockIdx.y, k0 = blockIdx.x * kTfKeys, H = gridDim.y;
  const int64_t part = static_cast<int64_t>(H) * T_pad * D;
  float* k_hi = scratch + (static_cast<int64_t>(h) * T_pad + k0) * D;
  float* k_lo = k_hi + part;
  float* vt_hi = scratch + 2 * part + static_cast<int64_t>(h) * D * T_pad + k0;
  float* vt_lo = vt_hi + part;
  for (int idx = threadIdx.x; idx < kTfKeys * D; idx += kThreads) {
    const int r = idx / D, col = idx % D, j = k0 + r;
    const bool real = j < T_len;
    uint32_t hi, lo;
    sm90::split_tf32(real ? k[j * k_rs + h * k_hs + col] : 0.f, hi, lo);
    k_hi[idx] = __uint_as_float(hi);
    k_lo[idx] = __uint_as_float(lo);
    vs[r][col] = real ? v[j * v_rs + h * v_hs + col] : 0.f;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kTfKeys * D; idx += kThreads) {
    const int col = idx / kTfKeys, p = idx % kTfKeys;
    const int kk = p & 7;
    uint32_t hi, lo;
    sm90::split_tf32(vs[(p & ~7) + (kk < 4 ? 2 * kk : 2 * kk - 7)][col], hi, lo);
    vt_hi[static_cast<int64_t>(col) * T_pad + p] = __uint_as_float(hi);
    vt_lo[static_cast<int64_t>(col) * T_pad + p] = __uint_as_float(lo);
  }
}

// f32 forward. Shared memory: the K and V ring (a stage holds K hi, K lo,
// V^T hi and V^T lo of 32 keys), each thread's Q fragments, each stage's key
// bias and the barriers.
template <int D>
struct Tf32FwdSmem {
  static constexpr int PART = kTfKeys * D * 4;   // one split tile
  static constexpr int STAGE = 4 * PART;         // K hi, K lo, V^T hi, V^T lo
  static constexpr int Q = kTfStages * STAGE;    // [2 warpgroups][D / 8 slices][128] float4
  static constexpr int KBIAS = Q + kBlockRows * D * 4;
  static constexpr int BAR = KBIAS + kTfStages * kTfKeys * 4;  // full[S], empty[S]
  static constexpr int BYTES = BAR + 2 * kTfStages * 8 + 1024;
};

// warp 0 of the f32 forward: key tile t (its keys' bias and the four split
// tiles) into its stage
template <int D>
__device__ __forceinline__ void tf32_load(uint8_t* smem, const CUtensorMap* maps,
                                          const int32_t* mask, uint64_t* full, uint64_t* empty,
                                          int t, int h, int T_len, int lane) {
  using S = Tf32FwdSmem<D>;
  static_assert(kTfKeys == 32, "a key a lane");
  const int s = t % kTfStages, k0 = t * kTfKeys, j = k0 + lane;
  wait_empty<kTfStages>(empty, t);
  reinterpret_cast<float*>(smem + S::KBIAS)[s * kTfKeys + lane] =
      j < T_len && (mask == nullptr || mask[j] != 0) ? 0.f : -INFINITY;
  __syncwarp();
  if (lane == 0) {
    uint8_t* st = smem + s * S::STAGE;
    sm90::mbar_arrive_expect_tx(&full[s], S::STAGE);
    for (int b = 0; b < D / 32; ++b) {  // K: boxes of 32 columns (128 bytes)
      sm90::tma_load_3d(st + b * kTfKeys * 128, &maps[0], &full[s], 32 * b, h, k0);
      sm90::tma_load_3d(st + S::PART + b * kTfKeys * 128, &maps[1], &full[s], 32 * b, h, k0);
    }
    sm90::tma_load_3d(st + 2 * S::PART, &maps[2], &full[s], k0, h, 0);  // V^T: D rows x 32 keys
    sm90::tma_load_3d(st + 3 * S::PART, &maps[3], &full[s], k0, h, 0);
  }
}

struct SplitMaps {
  CUtensorMap m[4];  // K hi, K lo, V^T hi, V^T lo
};

template <int D>
__global__ void __launch_bounds__(kThreadsTC, 1)
flash_fwd_tf32x3_kernel(const float* __restrict__ q, int64_t q_rs, int64_t q_hs,
                        const __grid_constant__ SplitMaps maps, const int32_t* __restrict__ mask,
                        float* __restrict__ out, float* __restrict__ lse, int T_len, int H,
                        float scale, int causal) {
  using S = Tf32FwdSmem<D>;
  constexpr int NS = D / 8;  // 8-column slices of Q K^T
  constexpr int CH = 4;      // slices split into registers at a time (double-buffered)
  constexpr int NB = NS / CH > 1 ? 2 : 1;  // accumulators of the hi hi terms
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t sbase = sm90::smem_addr(smem);
  const float* kbias = reinterpret_cast<const float*>(smem + S::KBIAS);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* empty = full + kTfStages;

  const int n_tiles = (T_len + kBlockRows - 1) / kBlockRows;
  const int qt = n_tiles - 1 - static_cast<int>(blockIdx.x);  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int q0 = qt * kBlockRows;
  const int n_keys = (T_len + kTfKeys - 1) / kTfKeys;
  const int n_kv = causal ? min(n_keys, (q0 + kBlockRows) / kTfKeys) : n_keys;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wgi = warp / 4, g = lane / 4, c = lane % 4;
  const int r0 = q0 + 64 * wgi;
  const int row_a = r0 + 16 * (warp % 4) + g, row_b = row_a + 8;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTfStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kThreadsTC / 32);
    }
    sm90::mbar_fence_init();
  }
  // Each thread's A fragments of Q, f32 as read (rows past T are zeros):
  // slice s holds (row_a, 8s + c), (row_b, 8s + c), (row_a, 8s + c + 4),
  // (row_b, 8s + c + 4), split into TF32 hi and lo at each use. Only the
  // thread itself reads them back.
  float4* qf = reinterpret_cast<float4*>(smem + S::Q) + wgi * NS * 128 + threadIdx.x % 128;
  {
    const float* pa = q + static_cast<int64_t>(row_a) * q_rs + h * q_hs + c;
    const float* pb = pa + 8 * q_rs;
    const bool ra = row_a < T_len, rb = row_b < T_len;
#pragma unroll 4
    for (int s = 0; s < NS; ++s)
      qf[s * 128] = make_float4(ra ? pa[8 * s] : 0.f, rb ? pb[8 * s] : 0.f,
                                ra ? pa[8 * s + 4] : 0.f, rb ? pb[8 * s + 4] : 0.f);
  }
  __syncthreads();
  if (warp == 0)
    for (int t = 0; t < kTfStages && t < n_kv; ++t)
      tf32_load<D>(smem, maps.m, mask, full, empty, t, h, T_len, lane);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int kt = 0; kt < n_kv; ++kt) {
    // refill the stage that tile kt - 1 held with tile kt - 1 + kTfStages
    if (warp == 0 && kt > 0 && kt - 1 + kTfStages < n_kv)
      tf32_load<D>(smem, maps.m, mask, full, empty, kt - 1 + kTfStages, h, T_len, lane);
    const int s = kt % kTfStages;
    const int k0 = kt * kTfKeys;
    wait_full<kTfStages>(full, kt);
    {
      const uint32_t st = sbase + s * S::STAGE;

      // S = Q K^T: [64 rows][32 keys], lo hi + hi lo + hi hi a slice, Q split
      // CH slices at a time into a register buffer the wgmma of two batches
      // back has released. The tensor cores add each product to its
      // accumulator to about f32's precision, rounding toward zero, so the
      // sums that decide the accuracy are kept short: the small terms in
      // one accumulator, the hi hi terms in one per batch parity, and the
      // three added in f32
      float ss[kTfKeys / 2], sb[NB][kTfKeys / 2], sc[kTfKeys / 2];
      uint32_t qh[2][CH][4], ql[2][CH][4];
#pragma unroll
      for (int b = 0; b < NS / CH; ++b) {
        const int u = b & 1;
        if (b >= 2) {
          sm90::wgmma_wait<1>();
          sm90::fence_regs(qh[u]);
          sm90::fence_regs(ql[u]);
        }
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          const float4 f = qf[(CH * b + j) * 128];
          sm90::split_tf32(f.x, qh[u][j][0], ql[u][j][0]);
          sm90::split_tf32(f.y, qh[u][j][1], ql[u][j][1]);
          sm90::split_tf32(f.z, qh[u][j][2], ql[u][j][2]);
          sm90::split_tf32(f.w, qh[u][j][3], ql[u][j][3]);
        }
        sm90::wgmma_fence();
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          const int ks = CH * b + j;
          const uint64_t k_hi = sm90::kmajor_desc<D, kTfKeys, 4>(st, 0, ks);
          const uint64_t k_lo = sm90::kmajor_desc<D, kTfKeys, 4>(st + S::PART, 0, ks);
          sm90::wgmma_tf32_rs(ss, ql[u][j], k_hi, ks > 0);
          sm90::wgmma_tf32_rs(ss, qh[u][j], k_lo, 1);
          sm90::wgmma_tf32_rs(sb[b % NB], qh[u][j], k_hi, b >= NB || j > 0);
        }
        sm90::wgmma_commit();
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(ss);
#pragma unroll
      for (int n = 0; n < NB; ++n) sm90::fence_regs(sb[n]);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        sm90::fence_regs(qh[u]);
        sm90::fence_regs(ql[u]);
      }

#pragma unroll
      for (int i = 0; i < kTfKeys / 2; ++i) {
        float x = ss[i];
#pragma unroll
        for (int n = NB - 1; n >= 0; --n) x += sb[n][i];
        sc[i] = x * scale;
      }
      if (mask != nullptr || k0 + kTfKeys > T_len) {
        const float* kb = kbias + s * kTfKeys;
#pragma unroll
        for (int i = 0; i < kTfKeys / 8; ++i) {
          const float2 bb = *reinterpret_cast<const float2*>(kb + 8 * i + 2 * c);
          sc[4 * i] += bb.x;
          sc[4 * i + 1] += bb.y;
          sc[4 * i + 2] += bb.x;
          sc[4 * i + 3] += bb.y;
        }
      }
      if (causal && k0 + kTfKeys - 1 > q0) {  // on the block's diagonal (a test on r0 branches)
#pragma unroll
        for (int i = 0; i < kTfKeys / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = k0 + 8 * i + 2 * c + e;
            if (j > row_a) sc[4 * i + e] = -INFINITY;
            if (j > row_b) sc[4 * i + 2 + e] = -INFINITY;
          }
      }

      // online softmax in f32 (expf), a row in the 4 lanes of a quad
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int i = 0; i < kTfKeys / 8; ++i) {
        mx_a = fmaxf(mx_a, fmaxf(sc[4 * i], sc[4 * i + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
      }
      const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
      // a row with no allowed key so far keeps p = 0 and l = 0
      const float mu_a = mn_a == -INFINITY ? 0.f : mn_a, mu_b = mn_b == -INFINITY ? 0.f : mn_b;
      const float al_a = expf(m_a - mu_a), al_b = expf(m_b - mu_b);
      m_a = mn_a;
      m_b = mn_b;
      float ls_a = 0.f, ls_b = 0.f;
#pragma unroll
      for (int i = 0; i < kTfKeys / 8; ++i) {
        sc[4 * i] = expf(sc[4 * i] - mu_a);
        sc[4 * i + 1] = expf(sc[4 * i + 1] - mu_a);
        sc[4 * i + 2] = expf(sc[4 * i + 2] - mu_b);
        sc[4 * i + 3] = expf(sc[4 * i + 3] - mu_b);
        ls_a += sc[4 * i] + sc[4 * i + 1];
        ls_b += sc[4 * i + 2] + sc[4 * i + 3];
      }
      l_a = l_a * al_a + ls_a;  // this thread's share of the row sum
      l_b = l_b * al_b + ls_b;

      // O = O alpha + P V: the tile's P V in an accumulator of its own (P
      // split in registers in tf32_frag's key order, which the V^T tiles are
      // stored in; V^T hi and lo K-major from the stage), added in f32
      uint32_t ph[kTfKeys / 8][4], pl[kTfKeys / 8][4];
      float pv[D / 2];
#pragma unroll
      for (int i = 0; i < kTfKeys / 8; ++i) sm90::tf32_frag(sc, i, ph[i], pl[i]);
      sm90::wgmma_fence();
#pragma unroll
      for (int i = 0; i < kTfKeys / 8; ++i) {
        const uint64_t v_hi = sm90::kmajor_desc<kTfKeys, D, 4>(st + 2 * S::PART, 0, i);
        const uint64_t v_lo = sm90::kmajor_desc<kTfKeys, D, 4>(st + 3 * S::PART, 0, i);
        sm90::wgmma_tf32_rs(pv, pl[i], v_hi, i > 0);
        sm90::wgmma_tf32_rs(pv, ph[i], v_lo, 1);
        sm90::wgmma_tf32_rs(pv, ph[i], v_hi, 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(pv);
      sm90::fence_regs(ph);
      sm90::fence_regs(pl);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[4 * i] = fmaf(o[4 * i], al_a, pv[4 * i]);
        o[4 * i + 1] = fmaf(o[4 * i + 1], al_a, pv[4 * i + 1]);
        o[4 * i + 2] = fmaf(o[4 * i + 2], al_b, pv[4 * i + 2]);
        o[4 * i + 3] = fmaf(o[4 * i + 3], al_b, pv[4 * i + 3]);
      }
    }
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  // a padded query row is an empty row: O = 0, lse = 0
  const bool va = row_a < T_len && (mask == nullptr || mask[row_a] != 0) && l_a > 0.f;
  const bool vb = row_b < T_len && (mask == nullptr || mask[row_b] != 0) && l_b > 0.f;
  if (c == 0) {
    if (row_a < T_len) lse[static_cast<int64_t>(h) * T_len + row_a] = va ? m_a + logf(l_a) : 0.f;
    if (row_b < T_len) lse[static_cast<int64_t>(h) * T_len + row_b] = vb ? m_b + logf(l_b) : 0.f;
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = row_a + 8 * half;
    if (t >= T_len) continue;
    const float mul = half ? (vb ? 1.f / l_b : 0.f) : (va ? 1.f / l_a : 0.f);
    float* orow = out + (static_cast<int64_t>(t) * H + h) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<float2*>(orow + 8 * i + 2 * c) =
          make_float2(o[4 * i + 2 * half] * mul, o[4 * i + 2 * half + 1] * mul);
  }
}

// --- launchers -------------------------------------------------------------------

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

template <typename T, int D>
cudaError_t launch_fwd_tc(Operand q, Operand k, Operand v, const void* mask, void* out, void* lse,
                          int T_len, int H, float scale, int causal, cudaStream_t s,
                          void* /*scratch: the f32 route's*/) {
  static_assert(std::is_same<T, bf16>::value, "the tensor-core route is bf16");
  constexpr int cols = sm90::Tile<D>::COLS;
  CUtensorMap qm, km, vm;
  if (!sm90::encode_rows_map(&qm, q.p, T_len, H, D, q.rs, q.hs, kBlockRows, cols) ||
      !sm90::encode_rows_map(&km, k.p, T_len, H, D, k.rs, k.hs, kFwdKeys, cols) ||
      !sm90::encode_rows_map(&vm, v.p, T_len, H, D, v.rs, v.hs, kFwdKeys, cols))
    return cudaErrorInvalidValue;
  constexpr int smem = FwdSmem<D>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_tc_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((T_len + kBlockRows - 1) / kBlockRows, H);
  flash_fwd_tc_kernel<D><<<grid, kThreadsTC, smem, s>>>(
      qm, km, vm, static_cast<const int32_t*>(mask), static_cast<bf16*>(out),
      static_cast<float*>(lse), T_len, H, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv_tc(Operand q, Operand k, Operand v, Operand dO, const void* lse,
                          const void* di, const void* mask, void* dk, void* dv, int T_len, int H,
                          float scale, int causal, cudaStream_t s) {
  static_assert(std::is_same<T, bf16>::value, "the tensor-core route is bf16");
  constexpr int cols = sm90::Tile<D>::COLS;
  CUtensorMap qm, km, vm, dom;
  if (!sm90::encode_rows_map(&qm, q.p, T_len, H, D, q.rs, q.hs, kDkvRows, cols) ||
      !sm90::encode_rows_map(&km, k.p, T_len, H, D, k.rs, k.hs, kBlockRows, cols) ||
      !sm90::encode_rows_map(&vm, v.p, T_len, H, D, v.rs, v.hs, kBlockRows, cols) ||
      !sm90::encode_rows_map(&dom, dO.p, T_len, H, D, dO.rs, dO.hs, kDkvRows, cols))
    return cudaErrorInvalidValue;
  constexpr int smem = DkvSmem<D>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_tc_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((T_len + kBlockRows - 1) / kBlockRows, H);
  flash_bwd_dkv_tc_kernel<D><<<grid, kThreadsTC, smem, s>>>(
      qm, km, vm, dom, static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<const int32_t*>(mask), static_cast<bf16*>(dk), static_cast<bf16*>(dv), T_len, H,
      scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq_tc(Operand q, Operand k, Operand v, Operand dO, const void* lse,
                         const void* di, const void* mask, void* dq, int T_len, int H,
                         float scale, int causal, cudaStream_t s) {
  static_assert(std::is_same<T, bf16>::value, "the tensor-core route is bf16");
  constexpr int cols = sm90::Tile<D>::COLS;
  CUtensorMap qm, km, vm, dom;
  if (!sm90::encode_rows_map(&qm, q.p, T_len, H, D, q.rs, q.hs, kBlockRows, cols) ||
      !sm90::encode_rows_map(&km, k.p, T_len, H, D, k.rs, k.hs, kDqKeys, cols) ||
      !sm90::encode_rows_map(&vm, v.p, T_len, H, D, v.rs, v.hs, kDqKeys, cols) ||
      !sm90::encode_rows_map(&dom, dO.p, T_len, H, D, dO.rs, dO.hs, kBlockRows, cols))
    return cudaErrorInvalidValue;
  constexpr int smem = DqSmem<D>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((T_len + kBlockRows - 1) / kBlockRows, H);
  flash_bwd_dq_tc_kernel<D><<<grid, kThreadsTC, smem, s>>>(
      qm, km, vm, dom, static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<const int32_t*>(mask), static_cast<bf16*>(dq), T_len, H, scale, causal);
  return cudaGetLastError();
}

// The f32 forward: K and V split into the scratch (split_kv_tf32_kernel),
// then the split-TF32 kernel.
template <typename T, int D>
cudaError_t launch_fwd_tf32x3(Operand q, Operand k, Operand v, const void* mask, void* out,
                              void* lse, int T_len, int H, float scale, int causal,
                              cudaStream_t s, void* scratch) {
  static_assert(std::is_same<T, float>::value, "the split-TF32 route is f32");
  if (scratch == nullptr) return cudaErrorInvalidValue;
  const int T_pad = (T_len + kTfKeys - 1) / kTfKeys * kTfKeys;
  float* split = static_cast<float*>(scratch);
  const long long part = static_cast<long long>(H) * T_pad * D;
  SplitMaps maps;
  for (int i = 0; i < 2; ++i)  // K hi, K lo: [H, T_pad, D], boxes of 32 keys x 32 columns
    if (!sm90::encode_rows_map(&maps.m[i], split + i * part, T_pad, H, D, D,
                               static_cast<long long>(T_pad) * D, kTfKeys, 32, 4))
      return cudaErrorInvalidValue;
  for (int i = 2; i < 4; ++i)  // V^T hi, V^T lo: [H, D, T_pad], boxes of D rows x 32 keys
    if (!sm90::encode_rows_map(&maps.m[i], split + i * part, D, H, T_pad, T_pad,
                               static_cast<long long>(D) * T_pad, D, kTfKeys, 4))
      return cudaErrorInvalidValue;
  split_kv_tf32_kernel<D><<<dim3(T_pad / kTfKeys, H), kThreads, 0, s>>>(
      ptr<float>(k), k.rs, k.hs, ptr<float>(v), v.rs, v.hs, split, T_len, T_pad);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  constexpr int smem = Tf32FwdSmem<D>::BYTES;
  e = cudaFuncSetAttribute(flash_fwd_tf32x3_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((T_len + kBlockRows - 1) / kBlockRows, H);
  flash_fwd_tf32x3_kernel<D><<<grid, kThreadsTC, smem, s>>>(
      ptr<float>(q), q.rs, q.hs, maps, static_cast<const int32_t*>(mask),
      static_cast<float*>(out), static_cast<float*>(lse), T_len, H, scale, causal);
  return cudaGetLastError();
}

// Calls F32<float, D>(args...) or BF16<__nv_bfloat16, D>(args...) for the
// runtime dtype and head width; an unsupported pair is cudaErrorInvalidValue.
#define DG_DISPATCH(F32, BF16, dtype, D, ...)                                   \
  do {                                                                         \
    if (dtype == kF32) {                                                       \
      if (D == 32) return static_cast<int>(F32<float, 32>(__VA_ARGS__));       \
      if (D == 64) return static_cast<int>(F32<float, 64>(__VA_ARGS__));       \
      if (D == 128) return static_cast<int>(F32<float, 128>(__VA_ARGS__));     \
    } else if (dtype == kBF16) {                                               \
      if (D == 32) return static_cast<int>(BF16<bf16, 32>(__VA_ARGS__));       \
      if (D == 64) return static_cast<int>(BF16<bf16, 64>(__VA_ARGS__));       \
      if (D == 128) return static_cast<int>(BF16<bf16, 128>(__VA_ARGS__));     \
    }                                                                          \
    return static_cast<int>(cudaErrorInvalidValue);                            \
  } while (0)

}  // namespace

extern "C" {

// out [T, H, D] (contiguous, input dtype) and lse [H, T] (f32) from q, k, v
// [T, H, D] (each with its row and head strides in elements, unit stride
// over D); mask [T] int32 or null; D in {32, 64, 128}; dtype 0 = float32,
// 1 = bfloat16. In float32 `scratch` holds 4 H T_pad D floats (T_pad = T
// rounded up to 32), 16-byte aligned, for K and V split into TF32 (it is
// not read in bfloat16 and may be null there).
int dg_flash_attention_fwd(const void* q, long long q_rs, long long q_hs, const void* k,
                           long long k_rs, long long k_hs, const void* v, long long v_rs,
                           long long v_hs, const void* mask, void* out, void* lse, int T, int H,
                           int D, float scale, int causal, int dtype, void* stream,
                           void* scratch) {
  if (T <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cudaError_t e = bind_device_of(q)) return static_cast<int>(e);
  DG_DISPATCH(launch_fwd_tf32x3, launch_fwd_tc, dtype, D, Operand{q, q_rs, q_hs},
              Operand{k, k_rs, k_hs}, Operand{v, v_rs, v_hs}, mask, out, lse, T, H, scale,
              causal, s, scratch);
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
  DG_DISPATCH(launch_dkv, launch_dkv_tc, dtype, D, Operand{q, q_rs, q_hs}, Operand{k, k_rs, k_hs},
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
  DG_DISPATCH(launch_dq, launch_dq_tc, dtype, D, Operand{q, q_rs, q_hs}, Operand{k, k_rs, k_hs},
              Operand{v, v_rs, v_hs}, Operand{dO, do_rs, do_hs}, lse, di, mask, dq, T, H,
              scale, causal, s);
}

}  // extern "C"
