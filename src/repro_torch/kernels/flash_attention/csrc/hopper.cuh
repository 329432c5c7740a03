// Hopper (sm_90a) building blocks of the wgmma flash kernels
// (flash_attention_wgmma.cu, the forward; flash_attention_bwd_wgmma.cu, the
// backward): mbarriers, TMA loads through tensor maps, wgmma shared-memory
// descriptors with the 128-byte and the 32-byte swizzle, the wgmma products
// the kernels issue, and the host side that encodes a tensor map.
//
// The shared layout of a (rows x D) bf16 tile: D / 64 boxes of rows x 64
// columns (128-byte rows, 128-byte swizzle), and at D = 80 a last box of
// rows x 16 columns (32-byte rows, 32-byte swizzle): the 128-byte swizzle's
// MN-major wgmma operand spans whole 64-column atoms, so a 16-column
// remainder takes the swizzle whose atom is 16 columns wide.
#pragma once

#include <cuda.h>  // CUtensorMap; the encoder comes through cudaGetDriverEntryPoint
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace flash::sm90 {

constexpr int kBoxCols = 64;  // bf16 per 128-byte swizzled row of a box
constexpr int kRowBytes = 128;
constexpr int kTailCols = 16;  // bf16 per 32-byte swizzled row of D = 80's last box
constexpr int kTailRowBytes = 32;

// The boxes of a (Rows x D) bf16 tile in shared memory: kFull boxes of
// Rows x 64 columns (kBox bytes each), then, where D % 64 = 16, one box of
// Rows x 16 columns at kTailOff.  Every box starts on 1024 bytes.
template <int D, int Rows>
struct TileBoxes {
  static constexpr int kFull = D / kBoxCols;
  static constexpr bool kTail = D % kBoxCols != 0;
  static constexpr int kBox = Rows * kRowBytes;
  static constexpr int kTailOff = kFull * kBox;
  static constexpr int kBytes = kTailOff + (kTail ? Rows * kTailRowBytes : 0);
  static_assert(D % kBoxCols == 0 || D % kBoxCols == kTailCols, "D is 64 k or 64 k + 16");
  static_assert(kBytes % 1024 == 0, "boxes on the 128-byte swizzle's 1024-byte atom");
};

// ---- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Returns once the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One 4-d box (the map's box width of d, 1 head, rows positions, 1 batch)
// into shared memory; completes on `bar`.  Positions past S are zero-filled.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d0, int head, int pos, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(head), "r"(pos), "r"(batch)
      : "memory");
}

// One 2-d box (x0 .. x0 + box - 1 of row y) into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int x0, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x0), "r"(y)
      : "memory");
}

// wgmma shared-memory descriptor with the 128-byte swizzle.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// wgmma shared-memory descriptor with the 32-byte swizzle (layout type 3):
// an atom is 8 rows of 32 bytes.  K-major, `sbo` steps 8 rows; MN-major
// (16 columns a row), `sbo` steps 8 rows of K and `lbo` would step the next
// 16 columns, which an n16 product never reads.
__device__ __forceinline__ uint64_t sw32_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (3ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma fence, commit or wait.
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Keeps register-A fragments live (unwritten) until the wgmma group that
// reads them has completed.
template <int K>
__device__ __forceinline__ void hold(const uint32_t (&f)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) asm volatile("" ::"r"(f[kk][x]) : "memory");
}

#define FLASH_ACC8(i)                                                             \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),   \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define FLASH_ACC32 FLASH_ACC8(0), FLASH_ACC8(8), FLASH_ACC8(16), FLASH_ACC8(24)
#define FLASH_ACC64 FLASH_ACC32, FLASH_ACC8(32), FLASH_ACC8(40), FLASH_ACC8(48), FLASH_ACC8(56)
#define FLASH_REGS32                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define FLASH_REGS64                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "   \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "   \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x N f32) (+)= A (64 x 16, K-major, shared) . B (N x 16, K-major, shared)^T
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FLASH_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n\t}"
      : FLASH_ACC64
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FLASH_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n\t}"
      : FLASH_ACC32
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N f32) += A (64 x 16 bf16, registers) . B (16 x N, MN-major, shared)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FLASH_REGS64
      ", {%64, %65, %66, %67}, %68, 1, 1, 1, 1;"
      : FLASH_ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FLASH_REGS32
      ", {%32, %33, %34, %35}, %36, 1, 1, 1, 1;"
      : FLASH_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, 1, 1, 1, 1;"
      : FLASH_ACC8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// Columns [Off, Off + N) of an accumulator as an m64nN accumulator of its
// own: an m64nD accumulator is its 8-column groups in order, so at D = 80
// the first 32 floats are columns 0-63 and the last 8 columns 64-79.
template <int Off, int N, int R>
__device__ __forceinline__ float (&acc_cols(float (&d)[R]))[N / 2] {
  static_assert(Off % 16 == 0 && (Off + N) / 2 <= R, "whole 16-column steps inside d");
  return *reinterpret_cast<float(*)[N / 2]>(d + Off / 2);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// An m64nN accumulator (N / 2 floats) rounded to bf16 as the register-A
// fragments of N / 16 k-steps: its 8-column groups 2kk and 2kk + 1 are the
// fragment of columns 16kk .. 16kk + 15.
//
// Accumulator layout of an m64nN wgmma: thread `lane` of warp w of the
// warpgroup holds, for every 8-column group j, the columns
// 8j + 2(lane % 4) + {0, 1} of row 16w + lane / 4 (d[4j], d[4j + 1]) and of
// that row + 8 (d[4j + 2], d[4j + 3]).
template <int N>
__device__ __forceinline__ void pack_a(const float (&d)[N / 2], uint32_t (&f)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    f[kk][0] = pack_bf16(d[8 * kk], d[8 * kk + 1]);
    f[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    f[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    f[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// ---- host side ---------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, so that the library links
// without -lcuda.
inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a (B, S, heads, D) bf16 tensor: dims (D, heads, S, B), innermost
// first, with the tensor's own strides (elements); boxes of (box_cols, 1,
// rows, 1) under `swizzle`: (64, ...) with the 128-byte swizzle for the
// 64-column boxes, (16, ...) with the 32-byte swizzle for D = 80's last box,
// loaded at d = 64 and ending at the row's end.  A size-1 dimension's stride
// is never stepped over and is replaced by a packed one.
inline bool encode(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B, int S, int heads,
                   int D, long long sb, long long ss, long long sh, int rows,
                   int box_cols = kBoxCols,
                   CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  if (heads == 1) sh = D;
  if (S == 1) ss = heads * sh;
  if (B == 1) sb = S * ss;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of an f32 (rows, cols) row-major array (cols * 4 a multiple of 16
// bytes), boxes of (box, 1), no swizzle.
inline bool encode_rows_f32(EncodeTiled enc, CUtensorMap* map, const void* ptr, long long rows,
                            long long cols, int box) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t boxes[2] = {static_cast<cuuint32_t>(box), 1};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims, strides,
             boxes, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool aligned16(const void* p) { return reinterpret_cast<unsigned long long>(p) % 16 == 0; }

// The wgmma routes' layout test (ops.py::_aligned16): base pointer,
// and the (element) strides of every dimension of more than one element, on
// 16 bytes (8 bf16).
inline bool tma_ok(const void* p, int B, int S, int heads, long long sb, long long ss,
                   long long sh) {
  const auto dim_ok = [](int n, long long st) { return n == 1 || (st > 0 && st % 8 == 0); };
  return aligned16(p) && dim_ok(B, sb) && dim_ok(S, ss) && dim_ok(heads, sh);
}

// Streaming multiprocessors of the current device (the persistent grids'
// size), or a negative CUDA error.
inline int sm_count() {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return err == cudaSuccess ? sms : -static_cast<int>(err);
}

}  // namespace flash::sm90
