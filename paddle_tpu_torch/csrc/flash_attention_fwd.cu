// Flash-attention forward for Hopper (sm_90a): online-softmax attention
// over [B, S, H, D] tensors taken by stride, returning out (input dtype)
// and the row logsumexp lse [B, H, S] (f32).
//
// Replaces: paddle_tpu/ops/pallas_ops.py `_fa_forward` (pallas_call at
// :152, kernel `_fa_fwd_kernel` :82, `_online_update` :133), reached
// through `flash_attention_fwd` :372 and nn.functional SDPA.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): the kernel
// must read q, k, v once and write out once (plus 4 bytes of lse per
// row). Serving prefill at S=512, B=1, H=16, D=128 moves ~8.4 MB
// (2.5 us) and does 4*S*(S+1)/2*D*H ~= 1.07 GFLOP of causal matmul
// (1.1 us), so at serving prompt lengths it is bound by BYTES; it turns
// operation-bound only above S ~ 1200 (causal, D=128).
//
// Design (a simple kernel that is right first; wgmma, TMA and warp
// specialisation are later work):
//  - one block of 4 warps per (64-row q tile, head, batch); each warp
//    owns 16 query rows for the whole loop, so the softmax and the
//    accumulator rescale need only warp-level synchronisation;
//  - the q tile is read once into shared memory; k/v stream in 64-row
//    tiles, and a causal loop stops at the diagonal tile, so strictly
//    upper tiles are never loaded (about half the k/v bytes at S=512);
//  - QK^T and PV run on the tensor cores through WMMA 16x16x16 with
//    16-bit inputs and f32 accumulation; P is rounded to the input type
//    before PV, as the TPU kernel does (`p.astype(v.dtype)`);
//  - the running max m and sum l stay in registers (two lanes per row),
//    the f32 accumulator O in shared memory;
//  - TILE SIZES DO NOT DEPEND ON S: a row's result depends only on its
//    own prefix, so a bucket-padded prompt and the unpadded prompt give
//    identical rows (the serving engine pads, generate() does not);
//  - the ragged last tile is masked (keys >= S get the -1e30 of the TPU
//    kernel, rows >= S are computed but never stored).
// head_dim: any multiple of 8 up to 256. The kernel is instantiated at
// the tile widths DP in {32, 64, 96, 128, 192, 256} and a call runs the
// smallest DP >= head_dim: loads past the true head_dim are zero-filled
// (zero columns add nothing to QK^T and give zero output columns) and
// only the true width is written back; the softmax scale comes from the
// caller (1/sqrt(true head_dim)), never from DP. At DP = 256 a block
// takes 190 KB of shared memory.
//
// float32 (q, k, v and out): `flash_fwd_f32_kernel` below, f32 FMAs on
// the CUDA cores (no TF32), so it holds to the reference's f32 (its
// interpret mode is exact f32) to ~1e-5. One query row per warp, eight
// rows per block; k/v stream through shared memory in 32-key tiles, one
// key per lane for the scores, and each lane owns head_dim/32 output
// columns for PV. Head_dim any multiple of 4 up to 256. Bound by its
// scalar FMAs (67 TFLOP/s f32): a simple kernel that is right; TF32 or
// wgmma for f32 is later work.
//
// Inputs need a unit stride in D and 16-byte aligned rows (the Python
// wrapper checks both). The launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // key rows per tile
constexpr int kWarps = 4;        // each warp owns 16 query rows
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

// Shared-memory layout; pitches are padded against bank conflicts and
// keep every WMMA fragment pointer 32-byte aligned.
template <int D>
struct Smem {
  static constexpr int LDT = D + 8;    // 16-bit q/k/v tile pitch
  static constexpr int LDS = kBK + 4;  // f32 score pitch
  static constexpr int LDP = kBK + 8;  // 16-bit probability pitch
  static constexpr int LDO = D + 4;    // f32 accumulator pitch
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + size_t(kBQ) * LDT * 2;
  static constexpr size_t v_off = k_off + size_t(kBK) * LDT * 2;
  static constexpr size_t s_off = v_off + size_t(kBK) * LDT * 2;
  static constexpr size_t p_off = s_off + size_t(kBQ) * LDS * 4;
  static constexpr size_t o_off = p_off + size_t(kBQ) * LDP * 2;
  static constexpr size_t bytes = o_off + size_t(kBQ) * LDO * 4;
};

struct Strides {  // in elements: batch, sequence, head (D has stride 1)
  long long q_b, q_s, q_h;
  long long k_b, k_s, k_h;
  long long v_b, v_s, v_h;
  long long o_b, o_s, o_h;
};

__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void put(__half* p, float x) {
  *p = __float2half(x);
}

// Copy rows row0..row0+63 of one head into a shared tile of width D
// (the tile width), 16 bytes per thread per step; rows past S and
// columns past the true head_dim `hd` are zero-filled.
template <int D, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long row_stride, int row0,
                                          int S, int hd) {
  constexpr int kVec = 8;               // 8 x 16-bit = 16 bytes
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < kBQ * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    const int s = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < S && c < hd) {
      val = *reinterpret_cast<const uint4*>(src + s * row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * Smem<D>::LDT + c) = val;
  }
}

// D is the tile width; `hd` (a multiple of 8, <= D) the true head_dim.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int S, int H, int hd, Strides st,
                 float scale, int causal) {
  using L = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::q_off);
  T* sK = reinterpret_cast<T*>(smem + L::k_off);
  T* sV = reinterpret_cast<T*>(smem + L::v_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  T* sP = reinterpret_cast<T*>(smem + L::p_off);
  float* sO = reinterpret_cast<float*>(smem + L::o_off);

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const T* qh = q + b * st.q_b + h * st.q_h;
  const T* kh = k + b * st.k_b + h * st.k_h;
  const T* vh = v + b * st.v_b + h * st.v_h;

  load_tile<D>(sQ, qh, st.q_s, q0, S, hd);
  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    sO[(i / D) * L::LDO + (i % D)] = 0.f;
  }

  // softmax state of one row, held by a pair of lanes (each covers half
  // of the tile's columns and half of the accumulator row)
  const int r = warp * 16 + (lane >> 1);   // row within the q tile
  const int half = lane & 1;
  const int qpos = q0 + r;
  float m = kNegInf;
  float l = 0.f;

  const int nk = (S + kBK - 1) / kBK;
  const int j_last = causal ? min((q0 + kBQ - 1) / kBK, nk - 1) : nk - 1;

  for (int j = 0; j <= j_last; ++j) {
    __syncthreads();                     // previous k/v tile fully read
    load_tile<D>(sK, kh, st.k_s, j * kBK, S, hd);
    load_tile<D>(sV, vh, st.v_s, j * kBK, S, hd);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBK / 16];
#pragma unroll
      for (int n = 0; n < kBK / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::load_matrix_sync(a, sQ + warp * 16 * L::LDT + kk, L::LDT);
#pragma unroll
        for (int n = 0; n < kBK / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> bk;
          wmma::load_matrix_sync(bk, sK + n * 16 * L::LDT + kk, L::LDT);
          wmma::mma_sync(acc[n], a, bk, acc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < kBK / 16; ++n) {
        wmma::store_matrix_sync(sS + warp * 16 * L::LDS + n * 16, acc[n],
                                L::LDS, wmma::mem_row_major);
      }
    }
    __syncwarp();

    // online softmax update of row r over this tile's columns
    {
      const float* srow = sS + r * L::LDS;
      T* prow = sP + r * L::LDP;
      const int c0 = half * (kBK / 2);
      float sv[kBK / 2];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kBK / 2; ++c) {
        const int kpos = j * kBK + c0 + c;
        float x = srow[c0 + c] * scale;
        if (kpos >= S || (causal && kpos > qpos)) x = kNegInf;
        sv[c] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m, mx);
      const float alpha = expf(m - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kBK / 2; ++c) {
        const float p = expf(sv[c] - m_new);
        sum += p;
        put(prow + c0 + c, p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      l = l * alpha + sum;
      m = m_new;
      float* orow = sO + r * L::LDO + half * (D / 2);
#pragma unroll 8
      for (int c = 0; c < D / 2; ++c) orow[c] *= alpha;
    }
    __syncwarp();

    // O += P V for this warp's 16 rows
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      float* otile = sO + warp * 16 * L::LDO + n * 16;
      wmma::load_matrix_sync(o, otile, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::load_matrix_sync(a, sP + warp * 16 * L::LDP + kk, L::LDP);
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bv;
        wmma::load_matrix_sync(bv, sV + kk * L::LDT + n * 16, L::LDT);
        wmma::mma_sync(o, a, bv, o);
      }
      wmma::store_matrix_sync(otile, o, L::LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (qpos >= S) return;
  const float l_safe = (l == 0.f) ? 1.f : l;
  const float* orow = sO + r * L::LDO + half * (D / 2);
  T* dst = out + b * st.o_b + (long long)qpos * st.o_s + h * st.o_h +
           half * (D / 2);
#pragma unroll
  for (int c = 0; c < D / 2; c += 8) {
    if (half * (D / 2) + c >= hd) break;    // padded columns: not stored
    union {
      uint4 u;
      T e[8];
    } pack;
#pragma unroll
    for (int i = 0; i < 8; ++i) put(&pack.e[i], orow[c + i] / l_safe);
    *reinterpret_cast<uint4*>(dst + c) = pack.u;
  }
  if (half == 0) {
    lse[((long long)b * H + h) * S + qpos] = m + logf(l_safe);
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int S, int H, int hd,
                   const Strides& st, float scale, int causal,
                   cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<D, T>;
  const int smem = static_cast<int>(Smem<D>::bytes);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, S, H, hd, st,
      scale, causal);
  return cudaGetLastError();
}

// ---- float32: f32 FMAs on the CUDA cores, no TF32 ----

constexpr int kF32Rows = 8;          // query rows per block, one per warp
constexpr int kF32Keys = 32;         // keys per tile, one per lane
constexpr int kF32Threads = kF32Rows * 32;
constexpr int kF32Cols = 8;          // output columns per lane (256 / 32)

// f32 shared memory: q rows [8][hd], k and v tiles [32][hd + 1] (the odd
// pitch keeps a lane-per-key read of a column free of bank conflicts).
__host__ __device__ inline size_t f32_smem_bytes(int hd) {
  return sizeof(float) *
         (size_t(kF32Rows) * hd + 2 * size_t(kF32Keys) * (hd + 1));
}

// Rows row0..row0+ROWS-1 of one head into a shared [ROWS][ld] tile by
// float4 (hd is a multiple of 4); rows past S are zero-filled.
template <int ROWS>
__device__ __forceinline__ void load_rows_f32(float* dst, int ld,
                                              const float* src,
                                              long long row_stride, int row0,
                                              int S, int hd) {
  const int per_row = hd / 4;
  for (int i = threadIdx.x; i < ROWS * per_row; i += blockDim.x) {
    const int r = i / per_row;
    const int c = (i % per_row) * 4;
    const int s = row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < S) {
      val = *reinterpret_cast<const float4*>(src + s * row_stride + c);
    }
    float* d = dst + r * ld + c;
    d[0] = val.x;
    d[1] = val.y;
    d[2] = val.z;
    d[3] = val.w;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(kF32Threads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int S, int H, int hd,
                     Strides st, float scale, int causal) {
  extern __shared__ __align__(16) float fsm[];
  const int ld = hd + 1;
  float* sQ = fsm;
  float* sK = sQ + kF32Rows * hd;
  float* sV = sK + kF32Keys * ld;

  const int q0 = blockIdx.x * kF32Rows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qpos = q0 + warp;
  const float* qh = q + b * st.q_b + h * st.q_h;
  const float* kh = k + b * st.k_b + h * st.k_h;
  const float* vh = v + b * st.v_b + h * st.v_h;

  load_rows_f32<kF32Rows>(sQ, hd, qh, st.q_s, q0, S, hd);
  const float* qrow = sQ + warp * hd;
  float m = kNegInf;
  float l = 0.f;
  float o[kF32Cols];
#pragma unroll
  for (int i = 0; i < kF32Cols; ++i) o[i] = 0.f;

  const int nk = (S + kF32Keys - 1) / kF32Keys;
  const int j_last =
      causal ? min((q0 + kF32Rows - 1) / kF32Keys, nk - 1) : nk - 1;
  for (int j = 0; j <= j_last; ++j) {
    __syncthreads();                     // previous k/v tile fully read
    load_rows_f32<kF32Keys>(sK, ld, kh, st.k_s, j * kF32Keys, S, hd);
    load_rows_f32<kF32Keys>(sV, ld, vh, st.v_s, j * kF32Keys, S, hd);
    __syncthreads();
    // lane = key: its score against this warp's query row
    const int kpos = j * kF32Keys + lane;
    const float* krow = sK + lane * ld;
    float s = 0.f;
    for (int c = 0; c < hd; ++c) s = fmaf(qrow[c], krow[c], s);
    s *= scale;
    if (kpos >= S || (causal && kpos > qpos)) s = kNegInf;
    const float m_new = fmaxf(m, warp_max(s));
    const float alpha = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * alpha + warp_sum(p);
    m = m_new;
    // lane = output columns lane, lane + 32, ...: O = alpha O + P V
#pragma unroll
    for (int i = 0; i < kF32Cols; ++i) o[i] *= alpha;
    for (int jj = 0; jj < kF32Keys; ++jj) {
      const float pj = __shfl_sync(0xffffffffu, p, jj);
      const float* vrow = sV + jj * ld;
#pragma unroll
      for (int i = 0; i < kF32Cols; ++i) {
        const int c = lane + 32 * i;
        if (c < hd) o[i] = fmaf(pj, vrow[c], o[i]);
      }
    }
  }

  if (qpos >= S) return;
  const float l_safe = (l == 0.f) ? 1.f : l;
  float* dst = out + b * st.o_b + (long long)qpos * st.o_s + h * st.o_h;
#pragma unroll
  for (int i = 0; i < kF32Cols; ++i) {
    const int c = lane + 32 * i;
    if (c < hd) dst[c] = o[i] / l_safe;
  }
  if (lane == 0) lse[((long long)b * H + h) * S + qpos] = m + logf(l_safe);
}

cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, float* lse, int B, int S, int H, int hd,
                       const Strides& st, float scale, int causal,
                       cudaStream_t stream) {
  const int smem = static_cast<int>(f32_smem_bytes(hd));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kF32Rows - 1) / kF32Rows, H, B);
  flash_fwd_f32_kernel<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, S, H, hd,
      st, scale, causal);
  return cudaGetLastError();
}

// The smallest instantiated tile width that holds head_dim `hd`.
inline int tile_width(int hd) {
  if (hd <= 32) return 32;
  if (hd <= 64) return 64;
  if (hd <= 96) return 96;
  if (hd <= 128) return 128;
  if (hd <= 192) return 192;
  return 256;
}

}  // namespace

extern "C" {

// dtype: 0 = bfloat16, 1 = float16 (D a multiple of 8), 2 = float32 (D a
// multiple of 4); D <= 256. Returns a cudaError_t (0 = success).
int ptt_flash_attention_fwd(const void* q, const void* k, const void* v,
                            void* out, float* lse, int B, int S, int H,
                            int D, long long q_b, long long q_s,
                            long long q_h, long long k_b, long long k_s,
                            long long k_h, long long v_b, long long v_s,
                            long long v_h, long long o_b, long long o_s,
                            long long o_h, float scale, int causal,
                            int dtype, void* stream) {
  const Strides st{q_b, q_s, q_h, k_b, k_s, k_h,
                   v_b, v_s, v_h, o_b, o_s, o_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1 || D < 1 || D > 256) {
    return cudaErrorInvalidValue;
  }
  if (dtype == 2) {
    if (D % 4) return cudaErrorInvalidValue;
    return launch_f32(q, k, v, out, lse, B, S, H, D, st, scale, causal, s);
  }
  if (D % 8) return cudaErrorInvalidValue;
  const int dp = tile_width(D);
#define PTT_FLASH_CASE(DIM, TYPE, CODE)                                    \
  if (dtype == CODE && dp == DIM)                                        \
    return launch<DIM, TYPE>(q, k, v, out, lse, B, S, H, D, st, scale,   \
                             causal, s);
  PTT_FLASH_CASE(32, __nv_bfloat16, 0)
  PTT_FLASH_CASE(64, __nv_bfloat16, 0)
  PTT_FLASH_CASE(96, __nv_bfloat16, 0)
  PTT_FLASH_CASE(128, __nv_bfloat16, 0)
  PTT_FLASH_CASE(192, __nv_bfloat16, 0)
  PTT_FLASH_CASE(256, __nv_bfloat16, 0)
  PTT_FLASH_CASE(32, __half, 1)
  PTT_FLASH_CASE(64, __half, 1)
  PTT_FLASH_CASE(96, __half, 1)
  PTT_FLASH_CASE(128, __half, 1)
  PTT_FLASH_CASE(192, __half, 1)
  PTT_FLASH_CASE(256, __half, 1)
#undef PTT_FLASH_CASE
  return cudaErrorInvalidValue;
}

const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
