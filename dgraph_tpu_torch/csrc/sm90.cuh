// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels:
// mbarriers, TMA tile loads (cp.async.bulk.tensor) and their host-side
// tensor maps, and bf16 and TF32 wgmma with f32 accumulators in registers
// (operands from shared memory through matrix descriptors, or A from
// registers).
//
// Fragment layout of a wgmma m64nN f32 accumulator d[N / 2], for thread
// lane l of warp w (0-3) of the warpgroup, g = l / 4, c = l % 4:
//   d[4i + 0] = (row 16w + g,     col 8i + 2c)    d[4i + 1] = (.., col 8i + 2c + 1)
//   d[4i + 2] = (row 16w + g + 8, col 8i + 2c)    d[4i + 3] = (.., col 8i + 2c + 1)
// A bf16 A operand from registers (m64k16) is four 32-bit pairs laid out the
// same way over 16 columns, so the accumulator chunks 2k and 2k + 1 of a
// product, rounded to bf16 and packed, are the A operand of its k-th
// 16-column slice (pack_a). A TF32 A operand (m64k8) is four 32-bit values
// a[0..3] at (row 16w + g, col c), (row + 8, col c), (row, col c + 4),
// (row + 8, col c + 4): not the accumulator's column order, so a product
// fed from an accumulator permutes its reduction index (see tf32_frag).
//
// Shared-memory tiles are what TMA writes: a box of R rows of RB bytes (RB =
// 128 with the 128-byte swizzle, 64 with the 64-byte one), 8-row groups of
// 8 * RB bytes, wider operands as several boxes side by side. A descriptor
// reads such a tile either K-major (the reduction runs along the row) or
// MN-major (along the rows; the transpose bit, bf16 only: TF32 operands in
// shared memory are K-major), see kmajor_desc and mnmajor_desc.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no driver library is linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dg {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers -------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA) and to
// the other threads; call once after the inits, before a __syncthreads
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// one arrival that also expects `bytes` of TMA writes before the phase ends
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the phase of parity `parity` has completed. A wait that
// outlasts kWaitCycles (about 2 s) traps: a protocol fault ends the launch
// with an error instead of holding the card.
constexpr long long kWaitCycles = 4LL << 30;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity)) {
    if (clock64() - t0 > kWaitCycles) __trap();
  }
}

// --- TMA -------------------------------------------------------------------------

// box of the 3-D map (coordinates innermost first: column, head, row) into
// dst; completes `bytes` of the transaction count of bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// cuTensorMapEncodeTiled, taken from the driver through the runtime so that
// the library needs no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// The map of a bf16 (elem = 2) or f32 (elem = 4) [T, H, D] operand (unit
// stride over D, row and head strides in elements, in whole 16-byte groups,
// base 16-byte aligned) whose box is `rows` rows of one head by `cols`
// columns (cols * elem = the swizzle span, 128 or 64 bytes). Rows past T
// read as zeros. False on failure.
inline bool encode_rows_map(CUtensorMap* map, const void* base, int T, int H, int D,
                            long long row_stride, long long head_stride, int rows, int cols,
                            int elem_bytes = 2) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint64_t elem = static_cast<cuuint64_t>(elem_bytes);
  // a size-1 dimension's stride is never stepped: any legal value will do
  if (H == 1) head_stride = D;
  if (T == 1) row_stride = static_cast<long long>(H) * head_stride;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(head_stride) * elem,
                                 static_cast<cuuint64_t>(row_stride) * elem};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(cols), 1u, static_cast<cuuint32_t>(rows)};
  const cuuint32_t estr[3] = {1u, 1u, 1u};
  const CUtensorMapSwizzle sw =
      cols * elem_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const CUtensorMapDataType type =
      elem_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return fn(map, type, 3, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// --- wgmma -------------------------------------------------------------------------

// Matrix descriptor of a swizzled tile in shared memory (start address,
// leading and stride byte offsets in 16-byte units, swizzle code in bits
// 62-63: 1 = 128-byte, 2 = 64-byte).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t swizzle_code) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(swizzle_code) << 62);
}

// A tile of R rows of an operand D columns of EB bytes wide (bf16: 2, f32
// read as TF32: 4), stored as D / COLS boxes of R rows x RB bytes (RB = 128
// for rows of 128 bytes or more, else 64). A reduction slice is 32 bytes:
// 16 bf16 or 8 TF32 columns.
template <int D, int EB = 2>
struct Tile {
  static constexpr int RB = D * EB >= 128 ? 128 : 64;   // bytes of a row within a box
  static constexpr int COLS = RB / EB;                  // columns of a box
  static constexpr int NBOX = D / COLS;
  static constexpr uint32_t SWIZZLE = RB == 128 ? 1 : 2;
  static constexpr int K_PER_BOX = RB / 32;             // reduction slices of a box
  template <int R>
  __host__ __device__ static constexpr int bytes() { return R * D * EB; }
};

// K-major: rows r0.. of an R-row tile at `base` as the M (or N) dimension,
// the k-th 32-byte column slice as the reduction slice k
template <int D, int R, int EB = 2>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t base, int r0, int k) {
  using Tl = Tile<D, EB>;
  const uint32_t a = base + (k / Tl::K_PER_BOX) * (R * Tl::RB) + r0 * Tl::RB +
                     (k % Tl::K_PER_BOX) * 32;
  return make_desc(a, 16, 8 * Tl::RB, Tl::SWIZZLE);
}

// MN-major (transpose bit): rows 16k..16k+15 of an R-row tile as the
// reduction slice k, its D columns as the N dimension (boxes R * RB apart)
template <int D, int R>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t base, int k) {
  using Tl = Tile<D>;
  return make_desc(base + k * 16 * Tl::RB, R * Tl::RB, 8 * Tl::RB, Tl::SWIZZLE);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of these registers across
// the wgmma issue / wait pair (the hardware reads and writes them
// asynchronously in between). No memory clobber: that would also pin every
// shared-memory read in place around it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]));
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

#define DG_ACC16 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define DG_ACC32 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define DG_ACC64 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define DG_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define DG_F16(i) DG_F4(i), DG_F4(i + 4), DG_F4(i + 8), DG_F4(i + 12)
#define DG_F32(i) DG_F16(i), DG_F16(i + 16)
#define DG_F64 DG_F32(0), DG_F32(32)

// d[64 x N] (+)= A[64 x 16] B[16 x N]; A and B K-major in shared memory.
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" DG_ACC32 "}, %32, %33, p, 1, 1, "
      "0, 0;\n}\n"
      : DG_F32(0)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" DG_ACC64 "}, %64, %65, p, 1, "
      "1, 0, 0;\n}\n"
      : DG_F64
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64 x N] += A[64 x 16] B[16 x N]; A in registers (pack_a), B MN-major in
// shared memory (the transpose bit), N = 2 * (size of d).
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" DG_ACC16
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : DG_F16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" DG_ACC32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : DG_F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" DG_ACC64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : DG_F64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[64 x N] (+)= A[64 x 8] B[8 x N] in TF32; A in registers (tf32_frag), B
// K-major in shared memory; N = 2 * (size of d). accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" DG_ACC16
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : DG_F16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" DG_ACC32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : DG_F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" DG_ACC64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : DG_F64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

#undef DG_F64
#undef DG_F32
#undef DG_F16
#undef DG_F4
#undef DG_ACC64
#undef DG_ACC32
#undef DG_ACC16

// accumulator chunks 2k, 2k + 1 rounded to bf16: the A operand of slice k
template <int N>
__device__ __forceinline__ void pack_a(const float (&d)[N], int k, uint32_t (&a)[4]) {
  a[0] = pack_bf16(d[8 * k + 0], d[8 * k + 1]);
  a[1] = pack_bf16(d[8 * k + 2], d[8 * k + 3]);
  a[2] = pack_bf16(d[8 * k + 4], d[8 * k + 5]);
  a[3] = pack_bf16(d[8 * k + 6], d[8 * k + 7]);
}

// x rounded to TF32 (nearest, ties away; the low 13 mantissa bits zero)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

// x = hi + lo in TF32, to about 2^-22 of |x|: the split of a 3xTF32 product
// (lo * hi + hi * lo + hi * hi; lo * lo is below f32's own rounding)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// Accumulator chunk k (columns 8k..8k+7) of a product, split into the TF32 A
// operands hi and lo of its k-th 8-column slice. The A layout holds columns
// c and c + 4 where the accumulator holds 2c and 2c + 1, so the slice's
// reduction index runs over the accumulator's columns in the order 0, 2, 4,
// 6, 1, 3, 5, 7: the B operand's rows must be stored in that order.
template <int N>
__device__ __forceinline__ void tf32_frag(const float (&d)[N], int k, uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  split_tf32(d[4 * k], hi[0], lo[0]);
  split_tf32(d[4 * k + 2], hi[1], lo[1]);
  split_tf32(d[4 * k + 1], hi[2], lo[2]);
  split_tf32(d[4 * k + 3], hi[3], lo[3]);
}

}  // namespace sm90
}  // namespace dg
