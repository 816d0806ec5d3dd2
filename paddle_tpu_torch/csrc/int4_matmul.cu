// Weight-only int4 matmul for Hopper (sm_90a):
//   y[m, n] = sum_g (x[m, hi half of group g] . hi_codes[g, n]) * s[g, n]
//                 + (x[m, lo half of group g] . lo_codes[g, n]) * s[gh + g, n]
// with x [M, K] (bf16, or f32 rounded to bf16), the codes packed two to a
// byte in [K/2, N] uint8 (high nibble: row k, low nibble: row k + K/2, each
// stored as q + 8), f32 scales [K/group, N], f32 accumulation, y [M, N] in
// x's dtype.
//
// Replaces: paddle_tpu/ops/int4_matmul.py `int4_matmul` (pallas_call at
// :118, kernel `_kernel` :54), reached through the weight-only int4 layer
// (`quantization/int4_layers.py:Int4Linear`).
//
// As there, the packed nibbles are read straight from device memory and
// unpacked in registers; no dequantized weight is ever written, and each
// group's scale multiplies that group's f32 partial product (never a
// 16-bit weight).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): the call must
// read x, the packed codes and the scales once and write y once. At decode
// (M = 1..16) the 0.5 byte per weight dominates and the product is far
// below the ~295 operations per byte where bf16 turns compute-bound: BYTES
// bound (a 2048 x 2048 weight: 2.1 MB, 0.6 us; Llama-1B's lm_head, 2048 x
// 32000: 33 MB, 10 us). At prefill (M = 512) the product is 2*M*K*N
// operations against the same weight bytes: OPERATIONS bound.
//
// Design (a simple kernel that is right first; TMA, wgmma and a pipelined
// ring are later work):
//  - the tensor cores through mma.sync m16n8k16 (bf16 in, f32 out) for
//    every M: the x tile is 16 rows at decode (M <= 16), 64 rows above, so
//    a decode call wastes rows of the MMA but no weight bytes;
//  - a block owns a 64-column tile and a range of whole groups; it stages
//    the x chunk (both halves) and the packed chunk (kc = 64, 32 or 16 rows
//    of bytes) in shared memory with 16-byte loads, and every thread turns
//    each packed byte it reads into both its high-half and its low-half
//    B operand, so one byte feeds two products;
//  - per group, the high- and low-half partials start at 0, run over the
//    group's 16-deep steps in order, then acc = acc + p_hi * s_hi and
//    acc = acc + p_lo * s_lo (the reference's order, explicitly rounded);
//  - at N = 2048 the 32 column tiles would leave most of the 132 SMs idle,
//    so blocks split K by whole groups (`splits` from the wrapper, chosen
//    from K, N and group only) and a second pass adds the f32 partials in
//    split order: no atomics, the bits repeat;
//  - A ROW'S BITS DO NOT DEPEND ON M: the split, the group and step order
//    are fixed by the weight's shape, and an MMA's output element depends
//    only on its own row of x, so a bucket-padded prompt gives the rows of
//    the unpadded one, and decode at M = 1 those of M = 16;
//  - the ragged edge: rows >= M are staged as zeros and never written;
//    columns >= N (N % 16 == 0, so a 16-byte chunk is all in or all out)
//    are zeros and never written; groups need not fill a tile.
// Needs group % 16 == 0, N % 16 == 0, x rows 16-byte aligned (the Python
// wrapper checks). The launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBN = 64;            // columns of a block's tile
constexpr int kThreads = 128;      // 4 warps
constexpr int kKC = 64;            // most rows of a half staged at once
constexpr int kXP = kKC + 8;       // x tile pitch (bf16): no bank conflicts
constexpr int kWP = kBN + 16;      // packed tile pitch (bytes)

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two values rounded to a bf16 pair in one register, the first in the low
// half (as an MMA operand register holds its smaller k).
__device__ __forceinline__ uint32_t bf16_bits(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two codes as a bf16 pair; codes in [-8, 7] are exact in bf16.
__device__ __forceinline__ uint32_t bf16_pair(int a, int b) {
  return bf16_bits(static_cast<float>(a), static_cast<float>(b));
}

// 8 values of x from global memory as 8 bf16 (16 bytes), zeros when absent.
__device__ __forceinline__ uint4 load_x8(const __nv_bfloat16* p, bool ok) {
  if (!ok) return make_uint4(0, 0, 0, 0);
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ uint4 load_x8(const float* p, bool ok) {
  if (!ok) return make_uint4(0, 0, 0, 0);
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  return make_uint4(bf16_bits(a.x, a.y), bf16_bits(a.z, a.w),
                    bf16_bits(b.x, b.y), bf16_bits(b.z, b.w));
}

// The A operand of one m16n8k16 step: rows ra, ra + 8 and columns ka,
// ka + 1, ka + 8, ka + 9 of a staged x tile (two bf16 a register).
template <int BM>
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16 (&t)[BM][kXP],
                                       int ra, int ka) {
  a[0] = *reinterpret_cast<const uint32_t*>(&t[ra][ka]);
  a[1] = *reinterpret_cast<const uint32_t*>(&t[ra + 8][ka]);
  a[2] = *reinterpret_cast<const uint32_t*>(&t[ra][ka + 8]);
  a[3] = *reinterpret_cast<const uint32_t*>(&t[ra + 8][ka + 8]);
}

__device__ __forceinline__ void store_y(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_y(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
int4_mm_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed,
               const float* __restrict__ scales, T* __restrict__ y,
               float* __restrict__ part, int M, int K, int N, int group,
               int splits) {
  constexpr int WM = BM / 16;          // warps along M
  constexpr int WN = 4 / WM;           // warps along N
  constexpr int NT = kBN / 8 / WN;     // n8 tiles a warp owns
  __shared__ __align__(16) __nv_bfloat16 xs[2][BM][kXP];
  __shared__ __align__(16) uint8_t ws[kKC][kWP];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wm = warp / WN, wn = warp % WN;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int half = K / 2, gh = half / group;
  const int per = (gh + splits - 1) / splits;
  const int g_begin = blockIdx.z * per;
  const int g_end = min(gh, g_begin + per);
  const int kc = group % 64 == 0 ? 64 : group % 32 == 0 ? 32 : 16;

  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;

  for (int g = g_begin; g < g_end; ++g) {
    float p_hi[NT][4], p_lo[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) p_hi[t][i] = p_lo[t][i] = 0.f;

    for (int c = 0; c < group; c += kc) {
      const int r0 = g * group + c;    // first packed row of the chunk
      // x: BM rows x kc columns of each half, 8 values a load
      const int xchunks = kc / 8;
      for (int i = tid; i < 2 * BM * xchunks; i += kThreads) {
        const int h = i / (BM * xchunks), rem = i % (BM * xchunks);
        const int r = rem / xchunks, col = (rem % xchunks) * 8;
        const int m = m0 + r;
        const T* src = x + static_cast<long long>(m) * K + h * half + r0 + col;
        *reinterpret_cast<uint4*>(&xs[h][r][col]) = load_x8(src, m < M);
      }
      // packed: kc rows x 64 bytes, 16 a load
      for (int i = tid; i < kc * (kBN / 16); i += kThreads) {
        const int r = i / (kBN / 16), col = (i % (kBN / 16)) * 16;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (n0 + col < N)
          v = *reinterpret_cast<const uint4*>(
              packed + static_cast<long long>(r0 + r) * N + n0 + col);
        *reinterpret_cast<uint4*>(&ws[r][col]) = v;
      }
      __syncthreads();

      for (int kk = 0; kk < kc; kk += 16) {
        const int ra = wm * 16 + gid, ka = kk + tig * 2;
        uint32_t a_hi[4], a_lo[4];
        load_a(a_hi, xs[0], ra, ka);
        load_a(a_lo, xs[1], ra, ka);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int nb = (wn * NT + t) * 8 + gid;
          const int u0 = ws[ka][nb], u1 = ws[ka + 1][nb];
          const int u2 = ws[ka + 8][nb], u3 = ws[ka + 9][nb];
          mma_bf16(p_hi[t], a_hi, bf16_pair((u0 >> 4) - 8, (u1 >> 4) - 8),
                   bf16_pair((u2 >> 4) - 8, (u3 >> 4) - 8));
          mma_bf16(p_lo[t], a_lo, bf16_pair((u0 & 15) - 8, (u1 & 15) - 8),
                   bf16_pair((u2 & 15) - 8, (u3 & 15) - 8));
        }
      }
      __syncthreads();
    }

    // the group's scales on its partials, high half first
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int n = n0 + (wn * NT + t) * 8 + tig * 2;
      float s_hi[2] = {0.f, 0.f}, s_lo[2] = {0.f, 0.f};
      if (n < N) {
        const float2 a = *reinterpret_cast<const float2*>(
            scales + static_cast<long long>(g) * N + n);
        const float2 b = *reinterpret_cast<const float2*>(
            scales + static_cast<long long>(gh + g) * N + n);
        s_hi[0] = a.x; s_hi[1] = a.y; s_lo[0] = b.x; s_lo[1] = b.y;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[t][i] = __fadd_rn(acc[t][i], __fmul_rn(p_hi[t][i], s_hi[i & 1]));
        acc[t][i] = __fadd_rn(acc[t][i], __fmul_rn(p_lo[t][i], s_lo[i & 1]));
      }
    }
  }

#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int n = n0 + (wn * NT + t) * 8 + tig * 2;
    if (n >= N) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + wm * 16 + gid + (i >= 2 ? 8 : 0);
      if (m >= M) continue;
      const long long at = static_cast<long long>(m) * N + n + (i & 1);
      if (splits == 1)
        store_y(y + at, acc[t][i]);
      else
        part[static_cast<long long>(blockIdx.z) * M * N + at] = acc[t][i];
    }
  }
}

// y = the splits' partials added in split order, in y's dtype.
template <typename T>
__global__ void int4_reduce_kernel(const float* __restrict__ part,
                                   T* __restrict__ y, long long MN,
                                   int splits) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < MN; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = part[i];
    for (int z = 1; z < splits; ++z) s = __fadd_rn(s, part[z * MN + i]);
    store_y(y + i, s);
  }
}

template <typename T, int BM>
cudaError_t launch(const void* x, const void* packed, const void* scales,
                   void* y, void* part, int M, int K, int N, int group,
                   int splits, cudaStream_t stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, splits);
  int4_mm_kernel<T, BM><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scales), static_cast<T*>(y),
      static_cast<float*>(part), M, K, N, group, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long MN = static_cast<long long>(M) * N;
  const int blocks = static_cast<int>(
      (MN + 255) / 256 < 4 * 132 ? (MN + 255) / 256 : 4 * 132);
  int4_reduce_kernel<T><<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(y), MN, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x's and y's). part: f32 [splits, M, N]
// scratch when splits > 1. Returns a cudaError_t (0 = success).
int ptt_int4_matmul(const void* x, const void* packed, const void* scales,
                    void* y, void* part, int M, int K, int N, int group,
                    int splits, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < 2 || N < 1 || group < 16 || group % 16 ||
      (K / 2) % group || N % 16 || splits < 1 ||
      (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const bool decode = M <= 16;
  if (dtype == 0)
    return decode ? launch<float, 16>(x, packed, scales, y, part, M, K, N,
                                      group, splits, s)
                  : launch<float, 64>(x, packed, scales, y, part, M, K, N,
                                      group, splits, s);
  if (dtype == 1)
    return decode ? launch<__nv_bfloat16, 16>(x, packed, scales, y, part, M,
                                              K, N, group, splits, s)
                  : launch<__nv_bfloat16, 64>(x, packed, scales, y, part, M,
                                              K, N, group, splits, s);
  return cudaErrorInvalidValue;
}

const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
