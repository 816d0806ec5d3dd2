// Flash-attention backward for Hopper (sm_90a): dq, dk, dv of causal or
// full attention over [B, S, H, D] tensors taken by stride, from the
// forward's saved row logsumexp lse [B, H, S] (f32) and
// delta = rowsum(out * dO) [B, H, S] (f32, computed by the caller).
//
// Replaces: paddle_tpu/ops/pallas_ops.py `_fa_bwd_dkdv_kernel` (:184)
// and `_fa_bwd_dq_kernel` (:229), as launched by `_fa_backward`
// (pallas_calls at :277 and :304, [B*H, S, D] layout) and by
// `_fa_backward_hsplit` (:585 and :612, the packed [B, S, 3*H*D]
// layout of the GPT trainer). Both layouts are strides here.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): the work
// must read q, k, v, dO (and the f32 lse, delta) once and write dq, dk,
// dv once, and do five matmuls over the (causal) score pairs: S = QK^T,
// dP = dO V^T, dV = P^T dO, dK = dS^T Q, dQ = dS K. At the GPT-1.3B
// training shape (B=6, S=1024, H=16, D=128, causal) that is ~176 MB
// (53 us) and 10*B*H*pairs*D = 6.4e10 flops (65 us): bound by
// OPERATIONS. This kernel recomputes S and dP in both passes (seven
// matmuls, as the reference does), so it cannot reach that bound.
//
// Design (simple and right first; wgmma, TMA, warp specialisation and
// a fused single pass are later work):
//  - two passes, as the reference: a dk/dv kernel with one block per
//    k tile that loops over the q tiles from the diagonal on (causal:
//    from tile (k0 / BQ), the reference's `i_start`), and a dq kernel
//    with one block per q tile that loops over the k tiles up to the
//    diagonal. Each block owns its output tile, so there are no atomics
//    and the gradients are the same bits on every run;
//  - every product runs on the tensor cores through WMMA 16x16x16 with
//    16-bit inputs and f32 accumulation, operands in shared memory;
//    the four warps of a block share out the 16x16 output fragments;
//  - the reference's roundings: P is rounded to dO's dtype before dV,
//    dS = P * (dP - delta) * scale is rounded to q's dtype before dK and
//    dQ, accumulators are f32 (in shared memory) and rounded once at
//    the end;
//  - TILE SIZES DEPEND ON D, NEVER ON S: BQ = 64; BK = 64 for D <= 128
//    and 32 above (shared memory). The ragged last tile is
//    masked: keys >= S give P = 0, rows >= S have P = 0 and are never
//    stored.
// head_dim: any multiple of 8 up to 256 in bf16 or f16. The kernels are
// instantiated at the tile widths D in {32, 64, 96, 128, 192, 256}, and a
// call runs the smallest D >= head_dim: q, k, v and dO columns past the
// true head_dim `hd` load as zeros (they add nothing to S or dP, and give
// zero dq/dk/dv columns) and only the true width is stored; the scale
// (1/sqrt(true head_dim)) comes from the caller.
//
// float32: `flash_bwd_*_f32_kernel` below, f32 FMAs on the CUDA cores
// (no TF32), head_dim any multiple of 4 up to 256. The same two passes:
// the dk/dv pass gives each warp one key row and streams 32-row q/dO
// tiles (one query row per lane for S and dP, each lane owning
// head_dim/32 columns of dk and dv); the dq pass gives each warp one
// query row and streams 32-key k/v tiles. Each warp owns its output
// rows and sums in a fixed order, so two runs give the same bits.
//
// Inputs and outputs need a unit stride in D and 16-byte aligned rows
// (the Python wrapper checks). The launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int kBQ = 64;          // query rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <int D>
struct Tile {
  static constexpr int BK = D > 128 ? 32 : 64;  // key rows per tile
  static constexpr int LDT = D + 8;             // 16-bit q/k/v/dO pitch
  static constexpr int LDS = BK + 4;            // f32 [BQ, BK] pitch
  static constexpr int LDP = BK + 8;            // 16-bit [BQ, BK] pitch
  static constexpr int LDA = D + 4;             // f32 accumulator pitch
};

// dk/dv pass: resident K, V and the two accumulators; Q, dO stream.
template <int D>
struct SmemKV {
  using t = Tile<D>;
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = k_off + size_t(t::BK) * t::LDT * 2;
  static constexpr size_t q_off = v_off + size_t(t::BK) * t::LDT * 2;
  static constexpr size_t do_off = q_off + size_t(kBQ) * t::LDT * 2;
  static constexpr size_t dk_off = do_off + size_t(kBQ) * t::LDT * 2;
  static constexpr size_t dv_off = dk_off + size_t(t::BK) * t::LDA * 4;
  static constexpr size_t s_off = dv_off + size_t(t::BK) * t::LDA * 4;
  static constexpr size_t dp_off = s_off + size_t(kBQ) * t::LDS * 4;
  static constexpr size_t p_off = dp_off + size_t(kBQ) * t::LDS * 4;
  static constexpr size_t ds_off = p_off + size_t(kBQ) * t::LDP * 2;
  static constexpr size_t l_off = ds_off + size_t(kBQ) * t::LDP * 2;
  static constexpr size_t d_off = l_off + size_t(kBQ) * 4;
  static constexpr size_t bytes = d_off + size_t(kBQ) * 4;
};

// dq pass: resident Q, dO and the accumulator; K, V stream.
template <int D>
struct SmemQ {
  using t = Tile<D>;
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = q_off + size_t(kBQ) * t::LDT * 2;
  static constexpr size_t k_off = do_off + size_t(kBQ) * t::LDT * 2;
  static constexpr size_t v_off = k_off + size_t(t::BK) * t::LDT * 2;
  static constexpr size_t dq_off = v_off + size_t(t::BK) * t::LDT * 2;
  static constexpr size_t s_off = dq_off + size_t(kBQ) * t::LDA * 4;
  static constexpr size_t dp_off = s_off + size_t(kBQ) * t::LDS * 4;
  static constexpr size_t ds_off = dp_off + size_t(kBQ) * t::LDS * 4;
  static constexpr size_t l_off = ds_off + size_t(kBQ) * t::LDP * 2;
  static constexpr size_t d_off = l_off + size_t(kBQ) * 4;
  static constexpr size_t bytes = d_off + size_t(kBQ) * 4;
};

struct Strides {  // in elements: batch, sequence, head (D has stride 1)
  long long q_b, q_s, q_h;
  long long k_b, k_s, k_h;
  long long v_b, v_s, v_h;
  long long do_b, do_s, do_h;
  long long dq_b, dq_s, dq_h;
  long long dk_b, dk_s, dk_h;
  long long dv_b, dv_s, dv_h;
};

__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void put(__half* p, float x) {
  *p = __float2half(x);
}

// Copy rows row0..row0+ROWS-1 of one head into a shared tile (pitch
// LDT), 16 bytes per thread per step; rows past S and columns past the
// true head_dim `hd` are zero-filled.
template <int D, int ROWS, typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          long long row_stride, int row0,
                                          int S, int hd) {
  constexpr int kVec = 8;
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    const int s = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < S && c < hd) {
      val = *reinterpret_cast<const uint4*>(src + s * row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * Tile<D>::LDT + c) = val;
  }
}

// Round ROWS rows of an f32 shared accumulator to T and store them by
// stride; rows past S and columns past `hd` are dropped.
template <int D, int ROWS, typename T>
__device__ __forceinline__ void store_rows(T* dst, const float* src,
                                           long long row_stride, int row0,
                                           int S, int hd) {
  constexpr int kPerRow = D / 8;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * 8;
    const int s = row0 + r;
    if (s >= S || c >= hd) continue;
    union {
      uint4 u;
      T e[8];
    } pack;
    const float* row = src + r * Tile<D>::LDA + c;
#pragma unroll
    for (int j = 0; j < 8; ++j) put(&pack.e[j], row[j]);
    *reinterpret_cast<uint4*>(dst + s * row_stride + c) = pack.u;
  }
}

template <int D>
__device__ __forceinline__ void zero_acc(float* acc, int rows) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    acc[(i / D) * Tile<D>::LDA + (i % D)] = 0.f;
  }
}

// Row statistics of q rows q0..q0+BQ-1; rows past S get 0.
__device__ __forceinline__ void load_stats(float* sl, float* sd,
                                           const float* lse,
                                           const float* delta, int q0,
                                           int S) {
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const int s = q0 + r;
    sl[r] = s < S ? lse[s] : 0.f;
    sd[r] = s < S ? delta[s] : 0.f;
  }
}

// C[M, N] (f32, row-major, pitch ldc) = (accumulate ? C : 0) + A B, all
// in shared memory. A is [M, K] and B is [K, N], each stored row-major
// or column-major as its layout says (pitches lda, ldb). The block's
// warps take the 16x16 output fragments in turn.
template <typename T, typename LA, typename LB>
__device__ __forceinline__ void gemm(float* C, int ldc, const T* A, int lda,
                                     const T* B, int ldb, int M, int N,
                                     int K, bool accumulate) {
  const int warp = threadIdx.x >> 5;
  const int nn = N / 16;
  for (int f = warp; f < (M / 16) * nn; f += kWarps) {
    const int m0 = (f / nn) * 16;
    const int n0 = (f % nn) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    float* cp = C + m0 * ldc + n0;
    if (accumulate) {
      wmma::load_matrix_sync(c, cp, ldc, wmma::mem_row_major);
    } else {
      wmma::fill_fragment(c, 0.f);
    }
    for (int kk = 0; kk < K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, LA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, LB> b;
      if constexpr (std::is_same<LA, wmma::row_major>::value) {
        wmma::load_matrix_sync(a, A + m0 * lda + kk, lda);
      } else {
        wmma::load_matrix_sync(a, A + kk * lda + m0, lda);
      }
      if constexpr (std::is_same<LB, wmma::row_major>::value) {
        wmma::load_matrix_sync(b, B + kk * ldb + n0, ldb);
      } else {
        wmma::load_matrix_sync(b, B + n0 * ldb + kk, ldb);
      }
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(cp, c, ldc, wmma::mem_row_major);
  }
}

// S = Q K^T and dP = dO V^T for one (q tile, k tile) pair, then
// P = exp(S * scale - lse) (0 where masked) and
// dS = P * (dP - delta) * scale, rounded to T. P is stored only when
// `sp` is given (the dk/dv pass).
template <int D, typename T>
__device__ __forceinline__ void scores(const T* sQ, const T* sdO,
                                       const T* sK, const T* sV, float* sS,
                                       float* sdP, const float* sl,
                                       const float* sd, T* sp, T* sds,
                                       int q0, int k0, int S, float scale,
                                       int causal) {
  using t = Tile<D>;
  gemm<T, wmma::row_major, wmma::col_major>(sS, t::LDS, sQ, t::LDT, sK,
                                            t::LDT, kBQ, t::BK, D, false);
  gemm<T, wmma::row_major, wmma::col_major>(sdP, t::LDS, sdO, t::LDT, sV,
                                            t::LDT, kBQ, t::BK, D, false);
  __syncthreads();
  for (int i = threadIdx.x; i < kBQ * t::BK; i += kThreads) {
    const int r = i / t::BK;
    const int c = i % t::BK;
    const int qpos = q0 + r;
    const int kpos = k0 + c;
    float p = 0.f;
    float ds = 0.f;
    if (qpos < S && kpos < S && (!causal || kpos <= qpos)) {
      p = expf(sS[r * t::LDS + c] * scale - sl[r]);
      ds = p * (sdP[r * t::LDS + c] - sd[r]) * scale;
    }
    if (sp != nullptr) put(sp + r * t::LDP + c, p);
    put(sds + r * t::LDP + c, ds);
  }
  __syncthreads();
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int S, int H, int hd, Strides st,
                      float scale, int causal) {
  using t = Tile<D>;
  using L = SmemKV<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem + L::k_off);
  T* sV = reinterpret_cast<T*>(smem + L::v_off);
  T* sQ = reinterpret_cast<T*>(smem + L::q_off);
  T* sdO = reinterpret_cast<T*>(smem + L::do_off);
  float* sdK = reinterpret_cast<float*>(smem + L::dk_off);
  float* sdV = reinterpret_cast<float*>(smem + L::dv_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  float* sdP = reinterpret_cast<float*>(smem + L::dp_off);
  T* sP = reinterpret_cast<T*>(smem + L::p_off);
  T* sdS = reinterpret_cast<T*>(smem + L::ds_off);
  float* sl = reinterpret_cast<float*>(smem + L::l_off);
  float* sd = reinterpret_cast<float*>(smem + L::d_off);

  const int k0 = blockIdx.x * t::BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = (long long)b * H + h;
  const float* lse_h = lse + bh * S;
  const float* delta_h = delta + bh * S;
  const T* qh = q + b * st.q_b + h * st.q_h;
  const T* doh = dout + b * st.do_b + h * st.do_h;

  load_rows<D, t::BK>(sK, k + b * st.k_b + h * st.k_h, st.k_s, k0, S, hd);
  load_rows<D, t::BK>(sV, v + b * st.v_b + h * st.v_h, st.v_s, k0, S, hd);
  zero_acc<D>(sdK, t::BK);
  zero_acc<D>(sdV, t::BK);

  const int nq = (S + kBQ - 1) / kBQ;
  for (int i = causal ? k0 / kBQ : 0; i < nq; ++i) {
    const int q0 = i * kBQ;
    __syncthreads();                     // previous tile fully read
    load_rows<D, kBQ>(sQ, qh, st.q_s, q0, S, hd);
    load_rows<D, kBQ>(sdO, doh, st.do_s, q0, S, hd);
    load_stats(sl, sd, lse_h, delta_h, q0, S);
    __syncthreads();
    scores<D>(sQ, sdO, sK, sV, sS, sdP, sl, sd, sP, sdS, q0, k0, S, scale,
              causal);
    // dV += P^T dO, dK += dS^T Q  ([BK, BQ] x [BQ, D])
    gemm<T, wmma::col_major, wmma::row_major>(sdV, t::LDA, sP, t::LDP, sdO,
                                              t::LDT, t::BK, D, kBQ, true);
    gemm<T, wmma::col_major, wmma::row_major>(sdK, t::LDA, sdS, t::LDP, sQ,
                                              t::LDT, t::BK, D, kBQ, true);
  }
  __syncthreads();
  store_rows<D, t::BK>(dk + b * st.dk_b + h * st.dk_h, sdK, st.dk_s, k0, S,
                       hd);
  store_rows<D, t::BK>(dv + b * st.dv_b + h * st.dv_h, sdV, st.dv_s, k0, S,
                       hd);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, int H, int hd, Strides st, float scale,
                    int causal) {
  using t = Tile<D>;
  using L = SmemQ<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::q_off);
  T* sdO = reinterpret_cast<T*>(smem + L::do_off);
  T* sK = reinterpret_cast<T*>(smem + L::k_off);
  T* sV = reinterpret_cast<T*>(smem + L::v_off);
  float* sdQ = reinterpret_cast<float*>(smem + L::dq_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  float* sdP = reinterpret_cast<float*>(smem + L::dp_off);
  T* sdS = reinterpret_cast<T*>(smem + L::ds_off);
  float* sl = reinterpret_cast<float*>(smem + L::l_off);
  float* sd = reinterpret_cast<float*>(smem + L::d_off);

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = (long long)b * H + h;
  const T* kh = k + b * st.k_b + h * st.k_h;
  const T* vh = v + b * st.v_b + h * st.v_h;

  load_rows<D, kBQ>(sQ, q + b * st.q_b + h * st.q_h, st.q_s, q0, S, hd);
  load_rows<D, kBQ>(sdO, dout + b * st.do_b + h * st.do_h, st.do_s, q0, S,
                    hd);
  load_stats(sl, sd, lse + bh * S, delta + bh * S, q0, S);
  zero_acc<D>(sdQ, kBQ);

  const int nk = (S + t::BK - 1) / t::BK;
  const int j_last = causal ? min((q0 + kBQ - 1) / t::BK, nk - 1) : nk - 1;
  for (int j = 0; j <= j_last; ++j) {
    const int k0 = j * t::BK;
    __syncthreads();                     // previous tile fully read
    load_rows<D, t::BK>(sK, kh, st.k_s, k0, S, hd);
    load_rows<D, t::BK>(sV, vh, st.v_s, k0, S, hd);
    __syncthreads();
    scores<D>(sQ, sdO, sK, sV, sS, sdP, sl, sd, static_cast<T*>(nullptr),
              sdS, q0, k0, S, scale, causal);
    // dQ += dS K  ([BQ, BK] x [BK, D])
    gemm<T, wmma::row_major, wmma::row_major>(sdQ, t::LDA, sdS, t::LDP, sK,
                                              t::LDT, kBQ, D, t::BK, true);
  }
  __syncthreads();
  store_rows<D, kBQ>(dq + b * st.dq_b + h * st.dq_h, sdQ, st.dq_s, q0, S,
                     hd);
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, void* dk, void* dv, int B, int S, int H,
                   int hd, const Strides& st, float scale, int causal,
                   cudaStream_t stream) {
  auto kv_kernel = flash_bwd_dkdv_kernel<D, T>;
  auto q_kernel = flash_bwd_dq_kernel<D, T>;
  const int kv_smem = static_cast<int>(SmemKV<D>::bytes);
  const int q_smem = static_cast<int>(SmemQ<D>::bytes);
  cudaError_t err = cudaFuncSetAttribute(
      kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, q_smem);
  if (err != cudaSuccess) return err;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  dim3 kv_grid((S + Tile<D>::BK - 1) / Tile<D>::BK, H, B);
  kv_kernel<<<kv_grid, kThreads, kv_smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      S, H, hd, st, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 q_grid((S + kBQ - 1) / kBQ, H, B);
  q_kernel<<<q_grid, kThreads, q_smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), S, H, hd, st, scale,
      causal);
  return cudaGetLastError();
}

// ---- float32: f32 FMAs on the CUDA cores, no TF32 ----

constexpr int kF32Rows = 8;          // resident rows per block, one a warp
constexpr int kF32Tile = 32;         // streamed rows per tile, one a lane
constexpr int kF32Threads = kF32Rows * 32;
constexpr int kF32Cols = 8;          // output columns per lane (256 / 32)

// Both passes: 2 resident [8][hd] row sets and 2 streamed [32][hd + 1]
// tiles (the odd pitch keeps a lane-per-row read free of bank
// conflicts), plus the streamed rows' lse and delta.
__host__ __device__ inline size_t f32_smem_bytes(int hd) {
  return sizeof(float) * (2 * size_t(kF32Rows) * hd +
                          2 * size_t(kF32Tile) * (hd + 1) + 2 * kF32Tile);
}

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

__device__ __forceinline__ float dot_f32(const float* a, const float* b,
                                         int hd) {
  float s = 0.f;
  for (int c = 0; c < hd; ++c) s = fmaf(a[c], b[c], s);
  return s;
}

// dk/dv: warp w owns key row k0 + w; lane = query row of the q tile.
__global__ void __launch_bounds__(kF32Threads)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int S, int H, int hd, Strides st, float scale,
                          int causal) {
  extern __shared__ __align__(16) float fsm[];
  const int ld = hd + 1;
  float* sK = fsm;
  float* sV = sK + kF32Rows * hd;
  float* sQ = sV + kF32Rows * hd;
  float* sdO = sQ + kF32Tile * ld;
  float* sl = sdO + kF32Tile * ld;
  float* sd = sl + kF32Tile;

  const int k0 = blockIdx.x * kF32Rows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kpos = k0 + warp;
  const long long bh = (long long)b * H + h;
  const float* qh = q + b * st.q_b + h * st.q_h;
  const float* doh = dout + b * st.do_b + h * st.do_h;

  load_rows_f32<kF32Rows>(sK, hd, k + b * st.k_b + h * st.k_h, st.k_s, k0, S,
                          hd);
  load_rows_f32<kF32Rows>(sV, hd, v + b * st.v_b + h * st.v_h, st.v_s, k0, S,
                          hd);
  const float* krow = sK + warp * hd;
  const float* vrow = sV + warp * hd;
  float ak[kF32Cols], av[kF32Cols];
#pragma unroll
  for (int i = 0; i < kF32Cols; ++i) ak[i] = av[i] = 0.f;

  const int nq = (S + kF32Tile - 1) / kF32Tile;
  for (int i0 = causal ? k0 / kF32Tile : 0; i0 < nq; ++i0) {
    const int q0 = i0 * kF32Tile;
    __syncthreads();                     // previous tile fully read
    load_rows_f32<kF32Tile>(sQ, ld, qh, st.q_s, q0, S, hd);
    load_rows_f32<kF32Tile>(sdO, ld, doh, st.do_s, q0, S, hd);
    for (int r = threadIdx.x; r < kF32Tile; r += blockDim.x) {
      const int s = q0 + r;
      sl[r] = s < S ? lse[bh * S + s] : 0.f;
      sd[r] = s < S ? delta[bh * S + s] : 0.f;
    }
    __syncthreads();
    const int qpos = q0 + lane;
    float p = 0.f;
    float ds = 0.f;
    if (qpos < S && kpos < S && (!causal || kpos <= qpos)) {
      p = expf(dot_f32(sQ + lane * ld, krow, hd) * scale - sl[lane]);
      ds = p * (dot_f32(sdO + lane * ld, vrow, hd) - sd[lane]) * scale;
    }
    // dV += P^T dO, dK += dS^T Q over the tile's rows, in row order
    for (int jj = 0; jj < kF32Tile; ++jj) {
      const float pj = __shfl_sync(0xffffffffu, p, jj);
      const float dsj = __shfl_sync(0xffffffffu, ds, jj);
      const float* qr = sQ + jj * ld;
      const float* dor = sdO + jj * ld;
#pragma unroll
      for (int i = 0; i < kF32Cols; ++i) {
        const int c = lane + 32 * i;
        if (c < hd) {
          av[i] = fmaf(pj, dor[c], av[i]);
          ak[i] = fmaf(dsj, qr[c], ak[i]);
        }
      }
    }
  }
  if (kpos >= S) return;
  float* dkr = dk + b * st.dk_b + (long long)kpos * st.dk_s + h * st.dk_h;
  float* dvr = dv + b * st.dv_b + (long long)kpos * st.dv_s + h * st.dv_h;
#pragma unroll
  for (int i = 0; i < kF32Cols; ++i) {
    const int c = lane + 32 * i;
    if (c < hd) {
      dkr[c] = ak[i];
      dvr[c] = av[i];
    }
  }
}

// dq: warp w owns query row q0 + w; lane = key row of the k tile.
__global__ void __launch_bounds__(kF32Threads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int S, int H, int hd,
                        Strides st, float scale, int causal) {
  extern __shared__ __align__(16) float fsm[];
  const int ld = hd + 1;
  float* sQ = fsm;
  float* sdO = sQ + kF32Rows * hd;
  float* sK = sdO + kF32Rows * hd;
  float* sV = sK + kF32Tile * ld;

  const int q0 = blockIdx.x * kF32Rows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qpos = q0 + warp;
  const long long bh = (long long)b * H + h;
  const float* kh = k + b * st.k_b + h * st.k_h;
  const float* vh = v + b * st.v_b + h * st.v_h;

  load_rows_f32<kF32Rows>(sQ, hd, q + b * st.q_b + h * st.q_h, st.q_s, q0, S,
                          hd);
  load_rows_f32<kF32Rows>(sdO, hd, dout + b * st.do_b + h * st.do_h,
                          st.do_s, q0, S, hd);
  const float row_lse = qpos < S ? lse[bh * S + qpos] : 0.f;
  const float row_delta = qpos < S ? delta[bh * S + qpos] : 0.f;
  const float* qrow = sQ + warp * hd;
  const float* dorow = sdO + warp * hd;
  float aq[kF32Cols];
#pragma unroll
  for (int i = 0; i < kF32Cols; ++i) aq[i] = 0.f;

  const int nk = (S + kF32Tile - 1) / kF32Tile;
  const int j_last =
      causal ? min((q0 + kF32Rows - 1) / kF32Tile, nk - 1) : nk - 1;
  for (int j = 0; j <= j_last; ++j) {
    const int k0 = j * kF32Tile;
    __syncthreads();                     // previous tile fully read
    load_rows_f32<kF32Tile>(sK, ld, kh, st.k_s, k0, S, hd);
    load_rows_f32<kF32Tile>(sV, ld, vh, st.v_s, k0, S, hd);
    __syncthreads();
    const int kpos = k0 + lane;
    float ds = 0.f;
    if (qpos < S && kpos < S && (!causal || kpos <= qpos)) {
      const float p =
          expf(dot_f32(qrow, sK + lane * ld, hd) * scale - row_lse);
      ds = p * (dot_f32(dorow, sV + lane * ld, hd) - row_delta) * scale;
    }
    // dQ += dS K over the tile's keys, in key order
    for (int jj = 0; jj < kF32Tile; ++jj) {
      const float dsj = __shfl_sync(0xffffffffu, ds, jj);
      const float* kr = sK + jj * ld;
#pragma unroll
      for (int i = 0; i < kF32Cols; ++i) {
        const int c = lane + 32 * i;
        if (c < hd) aq[i] = fmaf(dsj, kr[c], aq[i]);
      }
    }
  }
  if (qpos >= S) return;
  float* dqr = dq + b * st.dq_b + (long long)qpos * st.dq_s + h * st.dq_h;
#pragma unroll
  for (int i = 0; i < kF32Cols; ++i) {
    const int c = lane + 32 * i;
    if (c < hd) dqr[c] = aq[i];
  }
}

cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dq, void* dk, void* dv,
                       int B, int S, int H, int hd, const Strides& st,
                       float scale, int causal, cudaStream_t stream) {
  const int smem = static_cast<int>(f32_smem_bytes(hd));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_f32_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dout);
  dim3 grid((S + kF32Rows - 1) / kF32Rows, H, B);
  flash_bwd_dkdv_f32_kernel<<<grid, kF32Threads, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), S, H, hd, st, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_f32_kernel<<<grid, kF32Threads, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<float*>(dq), S, H, hd, st,
      scale, causal);
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
// multiple of 4); D <= 256. strides: 21 values, (batch, seq,
// head) for q, k, v, dout, dq, dk, dv in that order. Launches the dk/dv
// pass, then the dq pass, on `stream`. Returns a cudaError_t.
int ptt_flash_attention_bwd(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, void* dk,
                            void* dv, int B, int S, int H, int D,
                            const long long* strides, float scale,
                            int causal, int dtype, void* stream) {
  const long long* s = strides;
  const Strides st{s[0],  s[1],  s[2],  s[3],  s[4],  s[5],  s[6],
                   s[7],  s[8],  s[9],  s[10], s[11], s[12], s[13],
                   s[14], s[15], s[16], s[17], s[18], s[19], s[20]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1 || D < 1 || D > 256) {
    return cudaErrorInvalidValue;
  }
  if (dtype == 2) {
    if (D % 4) return cudaErrorInvalidValue;
    return launch_f32(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H, D, st,
                      scale, causal, cs);
  }
  if (D % 8) return cudaErrorInvalidValue;
  const int dp = tile_width(D);
#define PTT_BWD_CASE(DIM, TYPE, CODE)                                       \
  if (dtype == CODE && dp == DIM)                                         \
    return launch<DIM, TYPE>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, \
                             H, D, st, scale, causal, cs);
  PTT_BWD_CASE(32, __nv_bfloat16, 0)
  PTT_BWD_CASE(64, __nv_bfloat16, 0)
  PTT_BWD_CASE(96, __nv_bfloat16, 0)
  PTT_BWD_CASE(128, __nv_bfloat16, 0)
  PTT_BWD_CASE(192, __nv_bfloat16, 0)
  PTT_BWD_CASE(256, __nv_bfloat16, 0)
  PTT_BWD_CASE(32, __half, 1)
  PTT_BWD_CASE(64, __half, 1)
  PTT_BWD_CASE(96, __half, 1)
  PTT_BWD_CASE(128, __half, 1)
  PTT_BWD_CASE(192, __half, 1)
  PTT_BWD_CASE(256, __half, 1)
#undef PTT_BWD_CASE
  return cudaErrorInvalidValue;
}

const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
