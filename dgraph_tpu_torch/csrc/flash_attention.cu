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
// and head strides (f32: multiples of 4 elements, rows 16-byte aligned;
// bf16: multiples of 8 elements, base 16-byte aligned, as TMA needs): the
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
// Every kernel runs on the tensor cores (sm90.cuh); DG_DISPATCH picks the
// bf16 or the split-TF32 f32 kernel by dtype. At T = 8192, H = 4, D = 128
// (causal) the forward is 6.9e10 FLOP (two products), dK/dV 1.4e11 (four),
// dQ 1.0e11 (three): far above the bytes (0.01-0.03 ms) at any rate, so the
// bound is the tensor cores. Blocks with the most tiles under a causal mask
// are numbered first so that they start first.
//
// bf16: 0.07, 0.14 and 0.10 ms at the bf16 rate of 989 TFLOP/s; f32 FMAs on
// the CUDA cores (a sixteenth of that rate, fed from shared memory) were
// 37-52x short of it. So every product is a wgmma (m64nNk16, bf16 in, f32
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
// f32 dK/dV and dQ: the tensor cores in split TF32 as well, at 3 x 1.4e11
// and 3 x 1.0e11 TF32 FLOP, 0.83 and 0.63 ms at 495 TFLOP/s (2.1 and 1.5 ms
// on the CUDA cores). Every product is a wgmma with A from registers; B
// must be K-major, and P^T, dS^T and dS come from accumulators:
//   - A pre-pass (split_bwd_tf32_kernel) writes the streamed operands as
//     TF32 hi and lo parts into the caller's scratch, as rows ([H, T_pad,
//     D]: the B of S and dP) and transposed ([H, D, T_pad], rows of each 8
//     in tf32_frag's order: the B of the output product), Q and dO for
//     dK/dV, K and V (K alone transposed) for dQ. TMA stages them in two
//     rings: ring A (row parts) is refilled as soon as S and dP are done
//     with it, ring B (transposed parts) after the output product.
//   - dq: a block per (128 query rows, head), each warpgroup 64 rows, whose
//     Q and dO stay in shared memory as each thread's A fragments (as the
//     forward holds Q), split at each use; 32-key tiles stream up to the
//     diagonal. S = Q K^T and dP = dO V^T (m64n32k8); P and dS in f32
//     registers (ex2.approx on log2-scaled terms); dQ += dS K (m64nDk8,
//     dS split in registers). At D = 128 the fragments take 128 KB, so each
//     ring has one stage (224 KB).
//   - dkv: the roles swapped, a block per (128 keys, head), query tiles
//     streamed from the diagonal, in two passes of one kernel: dV (K
//     resident, S^T and dV += P^T dO) and dK (K and V resident, S^T, dP^T
//     and dK += dS^T Q). One pass with both totals (128 registers) spilled
//     at D = 128 and fit only 16-query tiles, twice as many as 32-query
//     ones, each a chain of waits; the second S^T (a fifth product for the
//     backward's four) costs less.
//   - Accuracy: each tile's output product takes a fresh accumulator, added
//     to the f32 total in f32; S and dP keep their small and hi hi terms
//     apart. Against the backward evaluated in float64 at lm_flash, dK, dV
//     and dQ read 3-5e-6, below the f32 plain version's own 1.6e-5
//     (PERF.md).
//
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

constexpr int kThreads = 256;  // the split pre-passes

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

// --- the tensor cores: f32 backward in split TF32 ---------------------------------

constexpr int kBwdRowParts = 4;  // x hi, x lo, y hi, y lo: [H, T_pad, D] each
constexpr int kBwdPad = 32;      // T_pad: T rounded up to this

// Tiles and rings of the f32 backward kernels, by head width: R rows a
// streamed tile (queries for dK and dV, keys for dQ); NF resident operands
// (each thread's A fragments of its 64 rows); ring A of AP row parts from
// part 0 on and ring B of BP transposed parts from part B0 on (the
// scratch's parts, split_bwd_tf32_kernel), with SA and SB stages; CH slices
// of a resident operand split at a time. At D = 128 two resident operands
// take 128 KB, and the 32-row tiles of their kernels get one stage a ring;
// dV's one resident operand leaves room for 64-row tiles.
template <int D, bool DV>
struct DkvCfg {  // dV (DV) or dK: K resident (and V for dK)
  static constexpr int R = DV ? 64 : 32, NF = DV ? 1 : 2, AP = DV ? 2 : 4, BP = 2;
  static constexpr int B0 = DV ? 6 : 4, SA = D < 128 ? 2 : 1, SB = SA, CH = DV ? 2 : 4;
};
template <int D>
struct DqCfg {  // Q and dO resident
  static constexpr int R = 32, NF = 2, AP = 4, BP = 2, B0 = 4, SA = D < 128 ? 2 : 1, SB = SA;
  static constexpr int CH = 4;
};

// Two strided [T, H, D] f32 operands x and y split for the TF32 products
// into the caller's scratch, each part H T_pad D floats (T_pad = T rounded
// up to 32; rows past T are zeros): parts 0-3 x hi, x lo, y hi, y lo as [H,
// T_pad, D]; parts 4-5 x^T hi and lo, and with y_t parts 6-7 y^T hi and lo,
// as [H, D, T_pad] with the rows of each 8 in tf32_frag's order (0, 2, 4, 6,
// 1, 3, 5, 7), so that an accumulator's product over them has a K-major B.
template <int D>
__global__ void __launch_bounds__(kThreads)
split_bwd_tf32_kernel(const float* __restrict__ x, int64_t x_rs, int64_t x_hs,
                      const float* __restrict__ y, int64_t y_rs, int64_t y_hs,
                      float* __restrict__ scratch, int T_len, int T_pad, int y_t) {
  __shared__ float xs[32][D + 1], ys[32][D + 1];
  const int h = blockIdx.y, r0 = blockIdx.x * 32;
  const int64_t part = static_cast<int64_t>(gridDim.y) * T_pad * D;
  float* rows = scratch + (static_cast<int64_t>(h) * T_pad + r0) * D;
  float* cols = scratch + 4 * part + static_cast<int64_t>(h) * D * T_pad + r0;
  for (int idx = threadIdx.x; idx < 32 * D; idx += kThreads) {
    const int r = idx / D, col = idx % D, t = r0 + r;
    const bool real = t < T_len;
    const float xv = real ? x[t * x_rs + h * x_hs + col] : 0.f;
    const float yv = real ? y[t * y_rs + h * y_hs + col] : 0.f;
    uint32_t hi, lo;
    sm90::split_tf32(xv, hi, lo);
    rows[idx] = __uint_as_float(hi);
    rows[idx + part] = __uint_as_float(lo);
    sm90::split_tf32(yv, hi, lo);
    rows[idx + 2 * part] = __uint_as_float(hi);
    rows[idx + 3 * part] = __uint_as_float(lo);
    xs[r][col] = xv;
    ys[r][col] = yv;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < 32 * D; idx += kThreads) {
    const int col = idx / 32, p = idx % 32, kk = p & 7;
    const int src = (p & ~7) + (kk < 4 ? 2 * kk : 2 * kk - 7);
    const int64_t at = static_cast<int64_t>(col) * T_pad + p;
    uint32_t hi, lo;
    sm90::split_tf32(xs[src][col], hi, lo);
    cols[at] = __uint_as_float(hi);
    cols[at + part] = __uint_as_float(lo);
    if (y_t) {
      sm90::split_tf32(ys[src][col], hi, lo);
      cols[at + 2 * part] = __uint_as_float(hi);
      cols[at + 3 * part] = __uint_as_float(lo);
    }
  }
}

struct BwdMaps {
  CUtensorMap m[8];  // the scratch's parts (split_bwd_tf32_kernel)
};

// The f32 backward's shared memory (offsets from a 1024-aligned base): ring
// A of row parts (R rows x D, TMA's 128-byte swizzle in boxes of 32
// columns) for S and dP; ring B of transposed parts (D rows x R, likewise
// in boxes of 32 columns) for the output product; the block's resident operands
// as each thread's A fragments ([NF operands][2 warpgroups][D / 8
// slices][128] float4, as the f32 forward holds Q); the barriers.
template <int D, typename C>
struct Tf32BwdSmem {
  static constexpr int PART = C::R * D * 4;
  static constexpr int A = 0;
  static constexpr int B = C::SA * C::AP * PART;
  static constexpr int FRAG = B + C::SB * C::BP * PART;
  static constexpr int BAR = FRAG + C::NF * kBlockRows * D * 4;  // fullA, emptyA, fullB, emptyB
  static constexpr int BYTES = BAR + 2 * (C::SA + C::SB) * 8 + 1024;
};

// this thread's A fragments of rows row_a and row_a + 8 of head h of a
// strided [T, H, D] f32 operand (rows past T are zeros): slice s, at
// frag[s * 128], holds (row_a, 8s + c), (row_a + 8, 8s + c), (row_a, 8s + c
// + 4), (row_a + 8, 8s + c + 4). Only the thread itself reads them back.
template <int D>
__device__ __forceinline__ void load_frags(float4* frag, const float* __restrict__ x, int64_t rs,
                                           int64_t hs, int h, int row_a, int c, int T_len) {
  const float* pa = x + row_a * rs + h * hs + c;
  const float* pb = pa + 8 * rs;
  const bool ra = row_a < T_len, rb = row_a + 8 < T_len;
#pragma unroll 4
  for (int s = 0; s < D / 8; ++s)
    frag[s * 128] = make_float4(ra ? pa[8 * s] : 0.f, rb ? pb[8 * s] : 0.f,
                                ra ? pa[8 * s + 4] : 0.f, rb ? pb[8 * s + 4] : 0.f);
}

// The f32 backward's two rings, fed by warp 0 (every lane waits, lane 0
// issues): the tile of rows r0 .. r0 + R, t-th of the block, into ring A
// (C::AP row parts) and ring B (C::BP transposed parts from part C::B0). A
// stage's empty barrier completes when lane 0 of each of the 8 warps has
// arrived after the warp's last wgmma on it, and warp 0 refills it at once.
template <int D, typename C>
struct BwdRings {
  using S = Tf32BwdSmem<D, C>;
  uint8_t* smem;
  const CUtensorMap* maps;
  uint64_t *full_a, *empty_a, *full_b, *empty_b;
  int h, lane;

  __device__ __forceinline__ void load_a(int t, int r0) const {
    wait_empty<C::SA>(empty_a, t);
    if (lane == 0) {
      const int s = t % C::SA;
      uint8_t* st = smem + S::A + s * C::AP * S::PART;
      sm90::mbar_arrive_expect_tx(&full_a[s], C::AP * S::PART);
      for (int p = 0; p < C::AP; ++p)
        for (int b = 0; b < D / 32; ++b)
          sm90::tma_load_3d(st + p * S::PART + b * C::R * 128, &maps[p], &full_a[s], 32 * b, h,
                            r0);
    }
  }
  __device__ __forceinline__ void load_b(int t, int r0) const {
    wait_empty<C::SB>(empty_b, t);
    if (lane == 0) {
      const int s = t % C::SB;
      uint8_t* st = smem + S::B + s * C::BP * S::PART;
      sm90::mbar_arrive_expect_tx(&full_b[s], C::BP * S::PART);
      for (int p = 0; p < C::BP; ++p)
        for (int b = 0; b < C::R / 32; ++b)  // boxes of D rows x 32 columns
          sm90::tma_load_3d(st + p * S::PART + b * D * 128, &maps[C::B0 + p], &full_b[s],
                            r0 + 32 * b, h, 0);
    }
  }
  // the barriers, initialised by thread 0
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < C::SA; ++s) {
      sm90::mbar_init(&full_a[s], 1);
      sm90::mbar_init(&empty_a[s], kThreadsTC / 32);
    }
    for (int s = 0; s < C::SB; ++s) {
      sm90::mbar_init(&full_b[s], 1);
      sm90::mbar_init(&empty_b[s], kThreadsTC / 32);
    }
    sm90::mbar_fence_init();
  }
};

// out[64 x N] = A B^T over D in split TF32 on wgmma, lo hi + hi lo + hi hi a
// slice: A the warpgroup's resident fragments (frag), split CH slices at a
// time into a double buffer that the wgmma of two batches back have
// released, as the f32 forward splits Q; B [N rows][D] hi and lo K-major in
// shared memory. The small terms and the hi hi terms take accumulators of
// their own, added in f32. The accumulators start at 0 although the first
// wgmma could overwrite them: left undefined, their registers were assigned
// over a live value (a product issued after this one wrote into this one's
// result); a fence pins the zeros before the first wgmma, or the compiler
// writes them between wgmma in flight and ptxas waits for those (C7517).
template <int D, int N, int CH>
__device__ __forceinline__ void tf32x3_abt(float (&out)[N / 2], const float4* frag, uint32_t b_hi,
                                           uint32_t b_lo) {
  constexpr int NS = D / 8;
  float sm[N / 2], sb[N / 2];
  uint32_t ah[2][CH][4], al[2][CH][4];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sm[i] = sb[i] = 0.f;
  sm90::fence_regs(sm);
  sm90::fence_regs(sb);
#pragma unroll
  for (int b = 0; b < NS / CH; ++b) {
    const int u = b & 1;
    if (b >= 2) {
      sm90::wgmma_wait<1>();
      sm90::fence_regs(ah[u]);
      sm90::fence_regs(al[u]);
    }
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const float4 f = frag[(CH * b + j) * 128];
      sm90::split_tf32(f.x, ah[u][j][0], al[u][j][0]);
      sm90::split_tf32(f.y, ah[u][j][1], al[u][j][1]);
      sm90::split_tf32(f.z, ah[u][j][2], al[u][j][2]);
      sm90::split_tf32(f.w, ah[u][j][3], al[u][j][3]);
    }
    sm90::wgmma_fence();
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int ks = CH * b + j;
      const uint64_t hi = sm90::kmajor_desc<D, N, 4>(b_hi, 0, ks);
      const uint64_t lo = sm90::kmajor_desc<D, N, 4>(b_lo, 0, ks);
      sm90::wgmma_tf32_rs(sm, al[u][j], hi, 1);
      sm90::wgmma_tf32_rs(sb, ah[u][j], hi, 1);
      sm90::wgmma_tf32_rs(sm, ah[u][j], lo, 1);
    }
    sm90::wgmma_commit();
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(sm);
  sm90::fence_regs(sb);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    sm90::fence_regs(ah[u]);
    sm90::fence_regs(al[u]);
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) out[i] = sb[i] + sm[i];
}

// tot[64 x D] += A B over R in split TF32 on wgmma (m64nDk8): A the
// warpgroup's [64][R] operand as TF32 hi and lo fragments
// (tf32_frag of an accumulator), B a transposed part pair [D rows][R] hi
// and lo, K-major. The tile's product takes a fresh accumulator, small
// terms first, added to tot in f32.
template <int D, int R>
__device__ __forceinline__ void tf32x3_ab_add(float (&tot)[D / 2], uint32_t (&ah)[R / 8][4],
                                              uint32_t (&al)[R / 8][4], uint32_t b_hi,
                                              uint32_t b_lo) {
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  sm90::fence_regs(acc);
  sm90::wgmma_fence();
#pragma unroll
  for (int i = 0; i < R / 8; ++i) {
    sm90::wgmma_tf32_rs(acc, al[i], sm90::kmajor_desc<R, D, 4>(b_hi, 0, i), 1);
    sm90::wgmma_tf32_rs(acc, ah[i], sm90::kmajor_desc<R, D, 4>(b_lo, 0, i), 1);
  }
#pragma unroll
  for (int i = 0; i < R / 8; ++i)
    sm90::wgmma_tf32_rs(acc, ah[i], sm90::kmajor_desc<R, D, 4>(b_hi, 0, i), 1);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  sm90::fence_regs(ah);
  sm90::fence_regs(al);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) tot[i] += acc[i];
}

// rows row_a and row_a + 8 of a [64][D] f32 accumulator fragment to the
// contiguous [T, H, D] f32 output at head h
template <int D>
__device__ __forceinline__ void store_rows_f32(float* __restrict__ out, const float (&acc)[D / 2],
                                               int row_a, int c, int h, int H, int T_len) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = row_a + 8 * half;
    if (t >= T_len) continue;
    float* orow = out + (static_cast<int64_t>(t) * H + h) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<float2*>(orow + 8 * i + 2 * c) =
          make_float2(acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1]);
  }
}


// f32 dK and dV, in two passes of one kernel (a pass holds one 64-column
// total a thread, so neither spills): a block per (128 keys, head), each
// warpgroup 64 keys, whose K (and for dK V) stay as fragments; query tiles
// of R rows stream from the diagonal. dV: Q (ring A) for S^T, dO^T (ring B)
// for dV += P^T dO. dK: Q and dO (ring A) for S^T and dP^T, Q^T (ring B)
// for dK += dS^T Q. The dV pass computes S^T once more, a fifth product for
// the four of the backward.
template <int D, bool DV>
__global__ void __launch_bounds__(kThreadsTC, 1)
flash_bwd_dkv_tf32x3_kernel(const float* __restrict__ k, int64_t k_rs, int64_t k_hs,
                            const float* __restrict__ v, int64_t v_rs, int64_t v_hs,
                            const __grid_constant__ BwdMaps maps, const float* __restrict__ lse,
                            const float* __restrict__ di, const int32_t* __restrict__ mask,
                            float* __restrict__ out, int T_len, int H, float scale, int causal) {
  using C = DkvCfg<D, DV>;
  using S = Tf32BwdSmem<D, C>;
  constexpr int R = C::R, NS = D / 8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t sbase = sm90::smem_addr(smem);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + S::BAR);
  const BwdRings<D, C> ring{smem, maps.m, bar, bar + C::SA, bar + 2 * C::SA,
                            bar + 2 * C::SA + C::SB, static_cast<int>(blockIdx.y),
                            static_cast<int>(threadIdx.x % 32)};

  const int h = blockIdx.y;
  const int k0 = static_cast<int>(blockIdx.x) * kBlockRows;  // key tile 0 has the most work
  const int qt0 = causal ? k0 / R : 0;  // first query tile at or below the diagonal
  const int n_it = (T_len + R - 1) / R - qt0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wgi = warp / 4, g = lane / 4, c = lane % 4;
  const int j_a = k0 + 64 * wgi + 16 * (warp % 4) + g, j_b = j_a + 8;

  if (threadIdx.x == 0) ring.init();
  float4* kf = reinterpret_cast<float4*>(smem + S::FRAG) + wgi * NS * 128 + threadIdx.x % 128;
  float4* vf = kf + 2 * NS * 128;
  load_frags<D>(kf, k, k_rs, k_hs, h, j_a, c, T_len);
  if (!DV) load_frags<D>(vf, v, v_rs, v_hs, h, j_a, c, T_len);
  __syncthreads();
  if (warp == 0) {
    for (int t = 0; t < C::SA && t < n_it; ++t) ring.load_a(t, (qt0 + t) * R);
    for (int t = 0; t < C::SB && t < n_it; ++t) ring.load_b(t, (qt0 + t) * R);
  }

  const bool ok_a = j_a < T_len && (mask == nullptr || mask[j_a] != 0);
  const bool ok_b = j_b < T_len && (mask == nullptr || mask[j_b] != 0);
  const float sl2 = scale * kLog2e;  // logits in log2 units
  float tot[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) tot[i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int q0 = (qt0 + it) * R;

    // S^T = K Q^T (and dP^T = V dO^T): [64 keys][R queries]; then ring A's
    // stage is refilled
    const int sa = it % C::SA;
    wait_full<C::SA>(ring.full_a, it);
    const uint32_t st = sbase + S::A + sa * C::AP * S::PART;
    float sc[R / 2], dp[R / 2];
    tf32x3_abt<D, R, C::CH>(sc, kf, st, st + S::PART);
    if (!DV) tf32x3_abt<D, R, C::CH>(dp, vf, st + 2 * S::PART, st + 3 * S::PART);
    if (lane == 0) sm90::mbar_arrive(&ring.empty_a[sa]);
    if (warp == 0 && it + C::SA < n_it) ring.load_a(it + C::SA, q0 + C::SA * R);

    // P^T = 2^(S^T scale log2 e - lse log2 e) on the allowed pairs (dV),
    // dS^T = P^T (dP^T - di) scale (dK): key row j keeps the queries q >=
    // lim (every one off the diagonal, none for a masked or absent key)
    const bool diag = causal && q0 < k0 + kBlockRows;
    const int lim_a = !ok_a ? INT_MAX : diag ? j_a : INT_MIN;
    const int lim_b = !ok_b ? INT_MAX : diag ? j_b : INT_MIN;
#pragma unroll
    for (int i = 0; i < R / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // the query's lse (times log2 e; +inf for an empty or absent row,
        // so its P is 0) and di, read from a row that exists, then chosen:
        // no branch on the lane
        const int qq = q0 + 8 * i + 2 * c + e, qc = min(qq, T_len - 1);
        const int64_t at = static_cast<int64_t>(h) * T_len + qc;
        const bool real = qq < T_len && (mask == nullptr || mask[qc] != 0);
        const float le = real ? lse[at] * kLog2e : INFINITY;
        float pa = exp2_approx(fmaf(sc[4 * i + e], sl2, -le));
        float pb = exp2_approx(fmaf(sc[4 * i + 2 + e], sl2, -le));
        if (qq < lim_a) pa = 0.f;
        if (qq < lim_b) pb = 0.f;
        if (DV) {
          sc[4 * i + e] = pa;
          sc[4 * i + 2 + e] = pb;
        } else {
          const float de = qq < T_len ? di[at] : 0.f;
          sc[4 * i + e] = (dp[4 * i + e] - de) * pa * scale;
          sc[4 * i + 2 + e] = (dp[4 * i + 2 + e] - de) * pb * scale;
        }
      }

    // dV += P^T dO or dK += dS^T Q: P^T or dS^T split in registers, dO^T or
    // Q^T hi and lo from ring B, whose stage is then refilled
    const int sb = it % C::SB;
    wait_full<C::SB>(ring.full_b, it);
    const uint32_t bt = sbase + S::B + sb * C::BP * S::PART;
    uint32_t fh[R / 8][4], fl[R / 8][4];
#pragma unroll
    for (int i = 0; i < R / 8; ++i) sm90::tf32_frag(sc, i, fh[i], fl[i]);
    tf32x3_ab_add<D, R>(tot, fh, fl, bt, bt + S::PART);
    if (lane == 0) sm90::mbar_arrive(&ring.empty_b[sb]);
    if (warp == 0 && it + C::SB < n_it) ring.load_b(it + C::SB, q0 + C::SB * R);
  }
  store_rows_f32<D>(out, tot, j_a, c, h, H, T_len);
}

// f32 dQ: 7a with the roles swapped. A block per (128 query rows, head),
// heaviest causal tiles first, each warpgroup 64 rows, whose Q and dO stay
// as fragments and whose lse and di stay in registers; key tiles of R rows
// stream up to the diagonal: K and V (ring A) for S and dP, K^T (ring B)
// for dQ.
template <int D>
__global__ void __launch_bounds__(kThreadsTC, 1)
flash_bwd_dq_tf32x3_kernel(const float* __restrict__ q, int64_t q_rs, int64_t q_hs,
                           const float* __restrict__ dO, int64_t do_rs, int64_t do_hs,
                           const __grid_constant__ BwdMaps maps, const float* __restrict__ lse,
                           const float* __restrict__ di, const int32_t* __restrict__ mask,
                           float* __restrict__ dq, int T_len, int H, float scale, int causal) {
  using C = DqCfg<D>;
  using S = Tf32BwdSmem<D, C>;
  constexpr int R = C::R, NS = D / 8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t sbase = sm90::smem_addr(smem);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + S::BAR);
  const BwdRings<D, C> ring{smem, maps.m, bar, bar + C::SA, bar + 2 * C::SA,
                            bar + 2 * C::SA + C::SB, static_cast<int>(blockIdx.y),
                            static_cast<int>(threadIdx.x % 32)};

  const int n_tiles = (T_len + kBlockRows - 1) / kBlockRows;
  const int qt = n_tiles - 1 - static_cast<int>(blockIdx.x);  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int q0 = qt * kBlockRows;
  const int n_keys = (T_len + R - 1) / R;
  const int n_kv = causal ? min(n_keys, (q0 + kBlockRows) / R) : n_keys;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wgi = warp / 4, g = lane / 4, c = lane % 4;
  const int row_a = q0 + 64 * wgi + 16 * (warp % 4) + g, row_b = row_a + 8;

  if (threadIdx.x == 0) ring.init();
  float4* qf = reinterpret_cast<float4*>(smem + S::FRAG) + wgi * NS * 128 + threadIdx.x % 128;
  float4* dof = qf + 2 * NS * 128;
  load_frags<D>(qf, q, q_rs, q_hs, h, row_a, c, T_len);
  load_frags<D>(dof, dO, do_rs, do_hs, h, row_a, c, T_len);
  __syncthreads();
  if (warp == 0) {
    for (int t = 0; t < C::SA && t < n_kv; ++t) ring.load_a(t, t * R);
    for (int t = 0; t < C::SB && t < n_kv; ++t) ring.load_b(t, t * R);
  }

  // this thread's rows' lse (times log2 e; +inf for an empty or absent
  // row, so its P is 0) and di
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
  const float sl2 = scale * kLog2e;  // logits in log2 units
  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * R;
    // the tile's keys' bias: 0, or -inf for a masked or absent key
    float bias[R / 4];
#pragma unroll
    for (int i = 0; i < R / 4; ++i) {
      const int j = k0 + 8 * (i / 2) + 2 * c + i % 2;
      bias[i] = j < T_len && (mask == nullptr || mask[min(j, T_len - 1)] != 0) ? 0.f : -INFINITY;
    }

    // S = Q K^T and dP = dO V^T: [64 rows][R keys]; then ring A's stage is
    // refilled
    const int sa = kt % C::SA;
    wait_full<C::SA>(ring.full_a, kt);
    const uint32_t st = sbase + S::A + sa * C::AP * S::PART;
    float sc[R / 2], dp[R / 2];
    tf32x3_abt<D, R, C::CH>(sc, qf, st, st + S::PART);
    tf32x3_abt<D, R, C::CH>(dp, dof, st + 2 * S::PART, st + 3 * S::PART);
    if (lane == 0) sm90::mbar_arrive(&ring.empty_a[sa]);
    if (warp == 0 && kt + C::SA < n_kv) ring.load_a(kt + C::SA, k0 + C::SA * R);

    // P = 2^(S scale log2 e + bias - lse log2 e) on the allowed pairs, dS =
    // P (dP - di) scale; under a causal mask warpgroup 0 also runs the diagonal's key
    // tiles above all its rows (P = 0 there: a branch on the warpgroup
    // would serialize the wgmma)
    const bool diag = causal && k0 + R - 1 > q0;  // the block's, not the warpgroup's
#pragma unroll
    for (int i = 0; i < R / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = k0 + 8 * i + 2 * c + e;
        const float be = bias[2 * i + e];
        float pa = exp2_approx(fmaf(sc[4 * i + e], sl2, be - L_a));
        float pb = exp2_approx(fmaf(sc[4 * i + 2 + e], sl2, be - L_b));
        if (diag && j > row_a) pa = 0.f;
        if (diag && j > row_b) pb = 0.f;
        dp[4 * i + e] = (dp[4 * i + e] - di_a) * pa * scale;
        dp[4 * i + 2 + e] = (dp[4 * i + 2 + e] - di_b) * pb * scale;
      }

    // dQ += dS K: dS split in registers, K^T hi and lo from ring B, whose
    // stage is then refilled
    const int sb = kt % C::SB;
    wait_full<C::SB>(ring.full_b, kt);
    const uint32_t bt = sbase + S::B + sb * C::BP * S::PART;
    uint32_t fh[R / 8][4], fl[R / 8][4];
#pragma unroll
    for (int i = 0; i < R / 8; ++i) sm90::tf32_frag(dp, i, fh[i], fl[i]);
    tf32x3_ab_add<D, R>(dq_acc, fh, fl, bt, bt + S::PART);
    if (lane == 0) sm90::mbar_arrive(&ring.empty_b[sb]);
    if (warp == 0 && kt + C::SB < n_kv) ring.load_b(kt + C::SB, k0 + C::SB * R);
  }
  store_rows_f32<D>(dq, dq_acc, row_a, c, h, H, T_len);
}

// --- launchers -------------------------------------------------------------------

struct Operand {
  const void* p;
  long long rs, hs;
};

template <typename T>
const T* ptr(const Operand& o) { return static_cast<const T*>(o.p); }

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
                          float scale, int causal, cudaStream_t s,
                          void* /*scratch: the f32 route's*/) {
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
                         float scale, int causal, cudaStream_t s,
                         void* /*scratch: the f32 route's*/) {
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

// The f32 backward's split operands in the caller's scratch (parts of H
// T_pad D floats, split_bwd_tf32_kernel): tensor maps of the four row parts
// (boxes of R rows x 32 columns) and of the n_t transposed ones (boxes of
// D rows x 32 columns); rows past T read as zeros.
template <int D, int R>
bool encode_bwd_maps(BwdMaps& maps, float* split, int T_pad, int H, int n_t) {
  const long long head = static_cast<long long>(T_pad) * D, part = H * head;
  for (int i = 0; i < kBwdRowParts; ++i)
    if (!sm90::encode_rows_map(&maps.m[i], split + i * part, T_pad, H, D, D, head, R, 32, 4))
      return false;
  for (int i = kBwdRowParts; i < kBwdRowParts + n_t; ++i)
    if (!sm90::encode_rows_map(&maps.m[i], split + i * part, D, H, T_pad, T_pad, head, D, 32, 4))
      return false;
  return true;
}

// f32 dK/dV: Q and dO split into the scratch (8 parts), then the dV and
// the dK pass of the split-TF32 kernel.
template <typename T, int D>
cudaError_t launch_dkv_tf32x3(Operand q, Operand k, Operand v, Operand dO, const void* lse,
                              const void* di, const void* mask, void* dk, void* dv, int T_len,
                              int H, float scale, int causal, cudaStream_t s, void* scratch) {
  static_assert(std::is_same<T, float>::value, "the split-TF32 route is f32");
  if (scratch == nullptr) return cudaErrorInvalidValue;
  const int T_pad = (T_len + kBwdPad - 1) / kBwdPad * kBwdPad;
  float* split = static_cast<float*>(scratch);
  BwdMaps maps[2];  // the dV pass's 64-row tiles, the dK pass's 32-row ones
  if (!encode_bwd_maps<D, DkvCfg<D, true>::R>(maps[0], split, T_pad, H, 4) ||
      !encode_bwd_maps<D, DkvCfg<D, false>::R>(maps[1], split, T_pad, H, 4))
    return cudaErrorInvalidValue;
  split_bwd_tf32_kernel<D><<<dim3(T_pad / 32, H), kThreads, 0, s>>>(
      ptr<float>(q), q.rs, q.hs, ptr<float>(dO), dO.rs, dO.hs, split, T_len, T_pad, 1);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid((T_len + kBlockRows - 1) / kBlockRows, H);
  void* outs[2] = {dv, dk};
  for (int pass = 0; pass < 2; ++pass) {
    auto kernel = pass == 0 ? flash_bwd_dkv_tf32x3_kernel<D, true>
                            : flash_bwd_dkv_tf32x3_kernel<D, false>;
    const int smem = pass == 0 ? Tf32BwdSmem<D, DkvCfg<D, true>>::BYTES
                               : Tf32BwdSmem<D, DkvCfg<D, false>>::BYTES;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kThreadsTC, smem, s>>>(
        ptr<float>(k), k.rs, k.hs, ptr<float>(v), v.rs, v.hs, maps[pass],
        static_cast<const float*>(lse), static_cast<const float*>(di),
        static_cast<const int32_t*>(mask), static_cast<float*>(outs[pass]), T_len, H, scale,
        causal);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// f32 dQ: K and V split into the scratch (6 parts), then the split-TF32
// kernel.
template <typename T, int D>
cudaError_t launch_dq_tf32x3(Operand q, Operand k, Operand v, Operand dO, const void* lse,
                             const void* di, const void* mask, void* dq, int T_len, int H,
                             float scale, int causal, cudaStream_t s, void* scratch) {
  static_assert(std::is_same<T, float>::value, "the split-TF32 route is f32");
  if (scratch == nullptr) return cudaErrorInvalidValue;
  const int T_pad = (T_len + kBwdPad - 1) / kBwdPad * kBwdPad;
  float* split = static_cast<float*>(scratch);
  BwdMaps maps;
  if (!encode_bwd_maps<D, DqCfg<D>::R>(maps, split, T_pad, H, 2)) return cudaErrorInvalidValue;
  split_bwd_tf32_kernel<D><<<dim3(T_pad / 32, H), kThreads, 0, s>>>(
      ptr<float>(k), k.rs, k.hs, ptr<float>(v), v.rs, v.hs, split, T_len, T_pad, 0);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  constexpr int smem = Tf32BwdSmem<D, DqCfg<D>>::BYTES;
  e = cudaFuncSetAttribute(flash_bwd_dq_tf32x3_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((T_len + kBlockRows - 1) / kBlockRows, H);
  flash_bwd_dq_tf32x3_kernel<D><<<grid, kThreadsTC, smem, s>>>(
      ptr<float>(q), q.rs, q.hs, ptr<float>(dO), dO.rs, dO.hs, maps,
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<const int32_t*>(mask), static_cast<float*>(dq), T_len, H, scale, causal);
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
// (strided as above), lse and di [H, T] f32 and the mask of the forward. In
// float32 `scratch` holds 8 H T_pad D floats (T_pad = T rounded up to 32),
// 16-byte aligned, for Q and dO split into TF32, as rows and transposed (it
// is not read in bfloat16 and may be null there).
int dg_flash_attention_bwd_dkv(const void* q, long long q_rs, long long q_hs, const void* k,
                               long long k_rs, long long k_hs, const void* v, long long v_rs,
                               long long v_hs, const void* dO, long long do_rs,
                               long long do_hs, const void* lse, const void* di,
                               const void* mask, void* dk, void* dv, int T, int H, int D,
                               float scale, int causal, int dtype, void* stream,
                               void* scratch) {
  if (T <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cudaError_t e = bind_device_of(q)) return static_cast<int>(e);
  DG_DISPATCH(launch_dkv_tf32x3, launch_dkv_tc, dtype, D, Operand{q, q_rs, q_hs},
              Operand{k, k_rs, k_hs}, Operand{v, v_rs, v_hs}, Operand{dO, do_rs, do_hs}, lse, di,
              mask, dk, dv, T, H, scale, causal, s, scratch);
}

// dq [T, H, D] (contiguous, input dtype) from the same operands; in float32
// `scratch` holds 6 H T_pad D floats for K and V split into TF32 as rows,
// and K transposed.
int dg_flash_attention_bwd_dq(const void* q, long long q_rs, long long q_hs, const void* k,
                              long long k_rs, long long k_hs, const void* v, long long v_rs,
                              long long v_hs, const void* dO, long long do_rs, long long do_hs,
                              const void* lse, const void* di, const void* mask, void* dq,
                              int T, int H, int D, float scale, int causal, int dtype,
                              void* stream, void* scratch) {
  if (T <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cudaError_t e = bind_device_of(q)) return static_cast<int>(e);
  DG_DISPATCH(launch_dq_tf32x3, launch_dq_tc, dtype, D, Operand{q, q_rs, q_hs},
              Operand{k, k_rs, k_hs}, Operand{v, v_rs, v_hs}, Operand{dO, do_rs, do_hs}, lse, di,
              mask, dq, T, H, scale, causal, s, scratch);
}

}  // extern "C"
