// Shared helpers of the port's Hopper (sm_90a) kernels: mbarriers, TMA
// tile loads and the host-side tensor maps they read, wgmma shared-memory
// descriptors, fences, and the warpgroup products the flash kernels and
// the int4 prefill kernel issue.
//
// Shared-memory tiles. A [rows, width] tile of 16-bit values is stored as
// width / PW panels of PW columns (PW = 64 or 32: one row of a panel is
// 128 or 64 bytes), each panel rows x (2 PW) bytes, swizzled the way TMA
// writes it with CU_TENSOR_MAP_SWIZZLE_128B / _64B: the 16-byte chunk c of
// row r sits at chunk c ^ (r % 8) (128B) or c ^ ((r / 2) % 4) (64B).
// Every tile starts on a 1024-byte boundary, so the pattern follows the
// shared-memory address, which is what the wgmma descriptors assume.
//  - K-major operand (rows = M or N, the reduction runs along a row):
//    descriptor start = panel + 32 bytes per 16-column step inside the
//    panel, LBO unused (16), SBO = 8 rows = 8 * (2 PW) bytes.
//  - MN-major operand (the reduction runs down the rows; wgmma's transpose
//    flag): start = panel 0 + 16 rows per 16-step, LBO = one panel's bytes
//    (the next PW columns), SBO = 8 rows.
// (CUTLASS's canonical GMMA layouts, cute/atom/mma_traits_sm90_gmma.hpp.)
//
// Register fragments (m64nN, f32 accumulator): thread t of the warpgroup
// holds rows 16 (t / 32) + (t % 32) / 4 and that + 8, columns
// 8 j + 2 (t % 4) + {0, 1}; d[4 j + {0, 1}] is the first row, d[4 j + {2,
// 3}] the second. Two adjacent 8-column groups of an accumulator, packed
// to 16 bits in pairs, are exactly the A fragment of one k16 step of a
// register-A wgmma (a[0..3] = groups 2s and 2s + 1, rows lo, hi).
#pragma once

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>
#include <type_traits>

namespace ptt {

// ---- host: tensor maps ----

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so
// the libraries need no -lcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-D map over a [B, S, H, hd] tensor of 16-bit T taken by element
// strides (sb, ss, sh; unit stride in hd), dims innermost first (hd, S, H,
// B), box (pw, rows, 1, 1) with the swizzle of a pw-column panel. Columns
// past hd and rows past S load as zeros.
template <typename T>
inline cudaError_t make_bshd_map(CUtensorMap* map, const void* base, int B,
                                 int S, int H, int hd, long long sb,
                                 long long ss, long long sh, int pw,
                                 int rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {cuuint64_t(hd), cuuint64_t(S), cuuint64_t(H),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(ss) * 2, cuuint64_t(sh) * 2,
                                 cuuint64_t(sb) * 2};
  const cuuint32_t box[4] = {cuuint32_t(pw), cuuint32_t(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map,
      std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      pw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 2-D map over a row-major [rows, cols] tensor of `elem_bytes`-byte
// elements (rows `row_bytes` apart), box (box_cols, box_rows) with the
// given swizzle. Elements past either edge load as zeros.
inline cudaError_t make_2d_map(CUtensorMap* map, CUtensorMapDataType type,
                               const void* base, long long rows,
                               long long cols, long long row_bytes,
                               int box_cols, int box_rows,
                               CUtensorMapSwizzle swizzle) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(row_bytes)};
  const cuuint32_t box[2] = {cuuint32_t(box_cols), cuuint32_t(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---- device: shared memory, mbarriers, TMA ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared-memory window rounded up to 1024 bytes (launches
// ask for 1024 bytes more than they use).
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Add `bytes` to the transaction count the current phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Arrive and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed (a fresh barrier
// counts its phase "1" as complete, so a producer's first wait on an
// empty slot passes at once).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map into shared memory; completion adds the
// box's bytes to `bar`'s transaction count.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box of a 2-D tensor map into shared memory (coordinates innermost
// first); completion adds the box's bytes to `bar`'s transaction count.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// Make this thread's ordinary shared-memory stores visible to the async
// proxy (wgmma's operand reads, TMA) before a barrier publishes them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- device: wgmma ----

// Shared-memory matrix descriptor; layout 1 = 128-byte swizzle, 2 = 64.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo,
                                               int swizzle_bytes) {
  const uint64_t layout = swizzle_bytes == 128 ? 1 : 2;
  return uint64_t((saddr & 0x3FFFF) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// The panel layout of a 16-bit tile DP columns wide (see the top of this
// file) and the descriptors that address it.
template <int DP>
struct Panels {
  static_assert(DP % 32 == 0 && DP <= 256, "tile width: a multiple of 32");
  // columns per panel: 64 where the width, and above 128 its half (a
  // warpgroup's share of the backward's outputs), are whole 64s
  static constexpr int PW =
      DP % 64 == 0 && (DP <= 128 || DP % 128 == 0) ? 64 : 32;
  static constexpr int SWB = 2 * PW;                 // bytes per panel row
  static constexpr int NP = DP / PW;                 // panels

  // K-major operand: rows row0..row0+63 (A) or all rows (B) of a tile of
  // `rows` rows at shared address `tile`, columns 16 kk..16 kk+15.
  __device__ static __forceinline__ uint64_t kmajor(uint32_t tile, int rows,
                                                    int row0, int kk) {
    const int col = 16 * kk;
    return wgmma_desc(tile + (col / PW) * rows * SWB + row0 * SWB +
                          (col % PW) * 2,
                      16, 8 * SWB, SWB);
  }

  // MN-major operand: rows k0..k0+15 of the tile (the reduction) and its
  // columns from col0 (a whole number of panels) on.
  __device__ static __forceinline__ uint64_t mnmajor(uint32_t tile, int rows,
                                                     int k0, int col0 = 0) {
    return wgmma_desc(tile + (col0 / PW) * rows * SWB + k0 * SWB, rows * SWB,
                      8 * SWB, SWB);
  }
};

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

// Keep the compiler from moving accumulator registers across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

#define PTT_WGMMA_SS_64(TY)                                             \
  asm volatile(                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                      \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY           \
      " {%0, %1, %2, %3, %4, %5, %6, %7,"                               \
      "%8, %9, %10, %11, %12, %13, %14, %15,"                           \
      "%16, %17, %18, %19, %20, %21, %22, %23,"                         \
      "%24, %25, %26, %27, %28, %29, %30, %31},"                        \
      " %32, %33, p, 1, 1, 0, 0;\n}\n"                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),     \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),     \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),\
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),\
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),\
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),\
        "+f"(d[30]), "+f"(d[31])                                        \
      : "l"(da), "l"(db), "r"(scale_d))

#define PTT_WGMMA_SS_128(TY)                                            \
  asm volatile(                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                      \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY          \
      " {%0, %1, %2, %3, %4, %5, %6, %7,"                               \
      "%8, %9, %10, %11, %12, %13, %14, %15,"                           \
      "%16, %17, %18, %19, %20, %21, %22, %23,"                         \
      "%24, %25, %26, %27, %28, %29, %30, %31,"                         \
      "%32, %33, %34, %35, %36, %37, %38, %39,"                         \
      "%40, %41, %42, %43, %44, %45, %46, %47,"                         \
      "%48, %49, %50, %51, %52, %53, %54, %55,"                         \
      "%56, %57, %58, %59, %60, %61, %62, %63},"                        \
      " %64, %65, p, 1, 1, 0, 0;\n}\n"                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),     \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),     \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),\
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),\
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),\
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),\
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),\
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),\
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),\
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),\
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),\
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),\
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])              \
      : "l"(da), "l"(db), "r"(scale_d))

#define PTT_WGMMA_RS_32(TY, TB)                                         \
  asm volatile(                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                      \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY           \
      " {%0, %1, %2, %3, %4, %5, %6, %7,"                               \
      "%8, %9, %10, %11, %12, %13, %14, %15},"                          \
      " {%16, %17, %18, %19}, %20, p, 1, 1, " TB ";\n}\n"               \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),     \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),     \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),\
        "+f"(d[15])                                                     \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),            \
        "r"(scale_d))

#define PTT_WGMMA_RS_64(TY, TB)                                         \
  asm volatile(                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                      \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY           \
      " {%0, %1, %2, %3, %4, %5, %6, %7,"                               \
      "%8, %9, %10, %11, %12, %13, %14, %15,"                           \
      "%16, %17, %18, %19, %20, %21, %22, %23,"                         \
      "%24, %25, %26, %27, %28, %29, %30, %31},"                        \
      " {%32, %33, %34, %35}, %36, p, 1, 1, " TB ";\n}\n"               \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),     \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),     \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),\
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),\
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),\
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),\
        "+f"(d[30]), "+f"(d[31])                                        \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),            \
        "r"(scale_d))

#define PTT_WGMMA_RS_96(TY, TB)                                         \
  asm volatile(                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"                      \
      "wgmma.mma_async.sync.aligned.m64n96k16.f32." TY "." TY           \
      " {%0, %1, %2, %3, %4, %5, %6, %7,"                               \
      "%8, %9, %10, %11, %12, %13, %14, %15,"                           \
      "%16, %17, %18, %19, %20, %21, %22, %23,"                         \
      "%24, %25, %26, %27, %28, %29, %30, %31,"                         \
      "%32, %33, %34, %35, %36, %37, %38, %39,"                         \
      "%40, %41, %42, %43, %44, %45, %46, %47},"                        \
      " {%48, %49, %50, %51}, %52, p, 1, 1, " TB ";\n}\n"               \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),     \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),     \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),\
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),\
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),\
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),\
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),\
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),\
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),\
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])                           \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),            \
        "r"(scale_d))

#define PTT_WGMMA_RS_128(TY, TB)                                        \
  asm volatile(                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                      \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY          \
      " {%0, %1, %2, %3, %4, %5, %6, %7,"                               \
      "%8, %9, %10, %11, %12, %13, %14, %15,"                           \
      "%16, %17, %18, %19, %20, %21, %22, %23,"                         \
      "%24, %25, %26, %27, %28, %29, %30, %31,"                         \
      "%32, %33, %34, %35, %36, %37, %38, %39,"                         \
      "%40, %41, %42, %43, %44, %45, %46, %47,"                         \
      "%48, %49, %50, %51, %52, %53, %54, %55,"                         \
      "%56, %57, %58, %59, %60, %61, %62, %63},"                        \
      " {%64, %65, %66, %67}, %68, p, 1, 1, " TB ";\n}\n"               \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),     \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),     \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),\
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),\
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),\
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),\
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),\
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),\
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),\
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),\
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),\
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),\
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])              \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),            \
        "r"(scale_d))


#define PTT_WGMMA_RS_192(TY, TB)                                        \
  asm volatile(                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"                     \
      "wgmma.mma_async.sync.aligned.m64n192k16.f32." TY "." TY          \
      " {%0, %1, %2, %3, %4, %5, %6, %7,"                               \
      "%8, %9, %10, %11, %12, %13, %14, %15,"                           \
      "%16, %17, %18, %19, %20, %21, %22, %23,"                         \
      "%24, %25, %26, %27, %28, %29, %30, %31,"                         \
      "%32, %33, %34, %35, %36, %37, %38, %39,"                         \
      "%40, %41, %42, %43, %44, %45, %46, %47,"                         \
      "%48, %49, %50, %51, %52, %53, %54, %55,"                         \
      "%56, %57, %58, %59, %60, %61, %62, %63,"                         \
      "%64, %65, %66, %67, %68, %69, %70, %71,"                         \
      "%72, %73, %74, %75, %76, %77, %78, %79,"                         \
      "%80, %81, %82, %83, %84, %85, %86, %87,"                         \
      "%88, %89, %90, %91, %92, %93, %94, %95},"                        \
      " {%96, %97, %98, %99}, %100, p, 1, 1, " TB ";\n}\n"              \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),     \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),     \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),\
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),\
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),\
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),\
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),\
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),\
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),\
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),\
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),\
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),\
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),\
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),\
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),\
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),\
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),\
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),\
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),\
        "+f"(d[95])                                                     \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),            \
        "r"(scale_d))

#define PTT_WGMMA_RS_256(TY, TB)                                        \
  asm volatile(                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                     \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY          \
      " {%0, %1, %2, %3, %4, %5, %6, %7,"                               \
      "%8, %9, %10, %11, %12, %13, %14, %15,"                           \
      "%16, %17, %18, %19, %20, %21, %22, %23,"                         \
      "%24, %25, %26, %27, %28, %29, %30, %31,"                         \
      "%32, %33, %34, %35, %36, %37, %38, %39,"                         \
      "%40, %41, %42, %43, %44, %45, %46, %47,"                         \
      "%48, %49, %50, %51, %52, %53, %54, %55,"                         \
      "%56, %57, %58, %59, %60, %61, %62, %63,"                         \
      "%64, %65, %66, %67, %68, %69, %70, %71,"                         \
      "%72, %73, %74, %75, %76, %77, %78, %79,"                         \
      "%80, %81, %82, %83, %84, %85, %86, %87,"                         \
      "%88, %89, %90, %91, %92, %93, %94, %95,"                         \
      "%96, %97, %98, %99, %100, %101, %102, %103,"                     \
      "%104, %105, %106, %107, %108, %109, %110, %111,"                 \
      "%112, %113, %114, %115, %116, %117, %118, %119,"                 \
      "%120, %121, %122, %123, %124, %125, %126, %127},"                \
      " {%128, %129, %130, %131}, %132, p, 1, 1, " TB ";\n}\n"          \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),     \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),     \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),\
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),\
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),\
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),\
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),\
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),\
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),\
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),\
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),\
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),\
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),\
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),\
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),\
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),\
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),\
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),\
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),\
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),\
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),\
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),\
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),\
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),\
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),\
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])                        \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),            \
        "r"(scale_d))

// d (+)= A B over one k16 step, A (64 x 16) and B (N x 16, K-major) read
// from shared memory through descriptors; scale_d = 0 overwrites d.
template <int N, typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_ss: N is 64 or 128");
  if constexpr (std::is_same<T, __half>::value) {
    if constexpr (N == 64) {
      PTT_WGMMA_SS_64("f16");
    } else {
      PTT_WGMMA_SS_128("f16");
    }
  } else {
    if constexpr (N == 64) {
      PTT_WGMMA_SS_64("bf16");
    } else {
      PTT_WGMMA_SS_128("bf16");
    }
  }
}

// d (+)= A B over one k16 step, A (64 x 16) from registers (a packed pair
// per register, the accumulator layout above) and B (16 x N) read
// MN-major from shared memory (the transpose flag set).
template <int N, typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  static_assert(N == 32 || N == 64 || N == 96 || N == 128 || N == 192 ||
                    N == 256,
                "wgmma_rs: N is 32, 64, 96, 128, 192 or 256");
  if constexpr (std::is_same<T, __half>::value) {
    if constexpr (N == 32) {
      PTT_WGMMA_RS_32("f16", "1");
    } else if constexpr (N == 64) {
      PTT_WGMMA_RS_64("f16", "1");
    } else if constexpr (N == 96) {
      PTT_WGMMA_RS_96("f16", "1");
    } else if constexpr (N == 128) {
      PTT_WGMMA_RS_128("f16", "1");
    } else if constexpr (N == 192) {
      PTT_WGMMA_RS_192("f16", "1");
    } else {
      PTT_WGMMA_RS_256("f16", "1");
    }
  } else {
    if constexpr (N == 32) {
      PTT_WGMMA_RS_32("bf16", "1");
    } else if constexpr (N == 64) {
      PTT_WGMMA_RS_64("bf16", "1");
    } else if constexpr (N == 96) {
      PTT_WGMMA_RS_96("bf16", "1");
    } else if constexpr (N == 128) {
      PTT_WGMMA_RS_128("bf16", "1");
    } else if constexpr (N == 192) {
      PTT_WGMMA_RS_192("bf16", "1");
    } else {
      PTT_WGMMA_RS_256("bf16", "1");
    }
  }
}

// d (+)= A B over one k16 step, A (64 x 16) from registers as in
// wgmma_rs and B (N x 16) read K-major from shared memory (no transpose:
// the int4 prefill's x tile, tokens as rows).
template <int N, typename T>
__device__ __forceinline__ void wgmma_rs_kmajor(float (&d)[N / 2],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  static_assert(N == 64, "wgmma_rs_kmajor: N is 64");
  if constexpr (std::is_same<T, __half>::value) {
    PTT_WGMMA_RS_64("f16", "0");
  } else {
    PTT_WGMMA_RS_64("bf16", "0");
  }
}

#undef PTT_WGMMA_SS_64
#undef PTT_WGMMA_SS_128
#undef PTT_WGMMA_RS_32
#undef PTT_WGMMA_RS_64
#undef PTT_WGMMA_RS_96
#undef PTT_WGMMA_RS_128
#undef PTT_WGMMA_RS_192
#undef PTT_WGMMA_RS_256


// ---- device: TF32 products (the f32 flash kernels' 3xTF32) ----
// d += A B over one k8 step of TF32 operands (32-bit registers or shared
// words whose low 13 mantissa bits the tensor core ignores), f32
// accumulation, A (64 x 8) and B (N x 8) both K-major: wgmma takes TF32
// only K-major (no transpose flag). A from shared memory (ss) or from
// registers (rs: a[0..3] the rows (t % 32) / 4 and + 8 of warp t / 32's 16,
// columns t % 4 and + 4, as mma.sync's m16n8k8 A fragment).
__device__ __forceinline__ void wgmma_tf32_ss_16(float (&d)[8], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7},"
      " %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_tf32_ss_32(float (&d)[16], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_tf32_ss_64(float (&d)[32], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_tf32_rs_16(float (&d)[8],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7},"
      " {%8, %9, %10, %11},"
      " %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_tf32_rs_32(float (&d)[16],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19},"
      " %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_tf32_rs_64(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35},"
      " %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_tf32_rs_96(float (&d)[48],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47},"
      " {%48, %49, %50, %51},"
      " %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_tf32_rs_128(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67},"
      " %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_tf32_rs_192(float (&d)[96],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95},"
      " {%96, %97, %98, %99},"
      " %100, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_tf32_rs_256(float (&d)[128],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127},"
      " {%128, %129, %130, %131},"
      " %132, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t da,
                                              uint64_t db) {
  static_assert(N == 16 || N == 32 || N == 64, "wgmma_tf32_ss: N 16-64");
  if constexpr (N == 16) {
    wgmma_tf32_ss_16(d, da, db);
  } else if constexpr (N == 32) {
    wgmma_tf32_ss_32(d, da, db);
  } else {
    wgmma_tf32_ss_64(d, da, db);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 96 || N == 128 ||
                    N == 192 || N == 256,
                "wgmma_tf32_rs: N is 16, 32, 64, 96, 128, 192 or 256");
  if constexpr (N == 16) {
    wgmma_tf32_rs_16(d, a, db);
  } else if constexpr (N == 32) {
    wgmma_tf32_rs_32(d, a, db);
  } else if constexpr (N == 64) {
    wgmma_tf32_rs_64(d, a, db);
  } else if constexpr (N == 96) {
    wgmma_tf32_rs_96(d, a, db);
  } else if constexpr (N == 128) {
    wgmma_tf32_rs_128(d, a, db);
  } else if constexpr (N == 192) {
    wgmma_tf32_rs_192(d, a, db);
  } else {
    wgmma_tf32_rs_256(d, a, db);
  }
}

}  // namespace ptt
