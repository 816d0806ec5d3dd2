// Flash-attention backward for Hopper (sm_90a): dq, dk, dv of causal or
// full attention over [B, S, H, D] tensors taken by stride, from the
// forward's out, its saved row logsumexp lse [B, H, S] (f32) and dO.
//
// Replaces: paddle_tpu/ops/pallas_ops.py `_fa_bwd_dkdv_kernel` (:184)
// and `_fa_bwd_dq_kernel` (:229), as launched by `_fa_backward`
// (pallas_calls at :277 and :304, [B*H, S, D] layout) and by
// `_fa_backward_hsplit` (:585 and :612, the packed [B, S, 3*H*D]
// layout of the GPT trainer). Both layouts are strides here.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): the work
// must read q, k, v, dO, out (and the f32 lse) once and write dq, dk, dv
// once, and do five matmuls over the (causal) score pairs: S = QK^T,
// dP = dO V^T, dV = P^T dO, dK = dS^T Q, dQ = dS K. At the GPT-1.3B
// training shape (B=6, S=1024, H=16, D=128, causal) that is ~176 MB
// (53 us) and 10*B*H*pairs*D = 6.4e10 flops (65 us): bound by
// OPERATIONS. Two passes recompute S and dP (seven matmuls, as the
// reference does), so they cannot reach that bound.
//
// One launch runs three passes on the caller's stream:
//  1. delta = rowsum(out * dO) in f32 (`flash_bwd_delta_kernel`, a few
//     lanes a row; the reference computes it in XLA);
//  2. dk/dv: a block owns a key tile, a q tile loop from the diagonal on
//     (causal: the reference's `i_start`);
//  3. dq: a block owns a q tile, a key tile loop up to the diagonal.
// Each block owns its output tile, so there are no atomics and the
// gradients are the same bits on every run. The reference's roundings:
// P is rounded to dO's dtype before dV, dS = P * (dP - delta) * scale to
// q's dtype before dK and dQ; f32 accumulation.
//
// bf16 and f16 at every tile width, 32-256 (`flash_bwd_*_wgmma_kernel`):
// two consumer warpgroups (64 resident rows each; above width 128 the
// same 64 rows, each owning half of the output columns, since dK and dV
// would need DP registers a thread) and a producer warpgroup whose
// registers setmaxnreg moves to the consumers (40 / 232); one thread of
// it keeps a TMA ring of the streamed 64-row tiles full (3 stages, 2 at
// width 256; mbarriers), the dk/dv pass's lanes also stage the tile's
// lse and delta. Every product is `wgmma`:
//  - dk/dv: S^T = K Q^T and dP^T = V dO^T from shared memory (K, V
//    resident), P^T = exp(S^T scale - lse) and dS^T in registers, then
//    dV += P^T dO and dK += dS^T Q with P^T and dS^T (rounded) as
//    register A operands and dO, Q read MN-major; dK and dV stay in
//    registers (2 x DP/2 a thread, DP/2 above width 128);
//  - dq: S = Q K^T and dP = dO V^T (Q, dO resident; lse and delta of a
//    thread's two rows in registers), dS in registers, dQ += dS K with K
//    read MN-major; the next tile's S and dP are issued before this
//    tile's dQ product and dS is computed while it runs.
// The mask (rows or keys >= S; causal: key > row) is applied only on
// diagonal and ragged tiles; a warpgroup skips tiles wholly masked for
// it. TILE SIZES DEPEND ON D, NEVER ON S (64-row streamed tiles).
// head_dim: any multiple of 8 up to 256 in bf16 or f16, run at the
// smallest tile width DP in {32, 64, 96, 128, 192, 256} >= head_dim; TMA
// fills q, k, v and dO columns past the true head_dim `hd` with zeros
// (they add nothing to S or dP, and give zero dq/dk/dv columns) and only
// the true width is stored; the scale (1/sqrt(true head_dim)) comes from
// the caller.
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
// and strides (the Python wrapper checks; TMA needs both). The launcher
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>
#include <type_traits>

#include "hopper.cuh"

namespace {

struct Strides {  // in elements: batch, sequence, head (D has stride 1)
  long long q_b, q_s, q_h;
  long long k_b, k_s, k_h;
  long long v_b, v_s, v_h;
  long long do_b, do_s, do_h;
  long long dq_b, dq_s, dq_h;
  long long dk_b, dk_s, dk_h;
  long long dv_b, dv_s, dv_h;
  long long o_b, o_s, o_h;
};

// ---- delta = rowsum(out * dO) in f32, [B, H, S] ----
// The reference computes it in XLA before its backward kernels. `lpr`
// lanes a (row, head), the smallest power of two that covers the row in
// 16-byte loads (16 at head_dim 128 in bf16, so a warp takes two rows):
// loads of out and dO by stride, f32 products summed per lane in column
// order, then the lanes' butterfly. Bound by bytes (out and dO read
// once).

constexpr int kDeltaWarps = 8;

__device__ __forceinline__ float dot16(const uint4& a, const uint4& b,
                                       const __nv_bfloat16*) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]);
    const float2 w = __bfloat1622float2(y[i]);
    acc = fmaf(u.x, w.x, acc);
    acc = fmaf(u.y, w.y, acc);
  }
  return acc;
}

__device__ __forceinline__ float dot16(const uint4& a, const uint4& b,
                                       const __half*) {
  const __half2* x = reinterpret_cast<const __half2*>(&a);
  const __half2* y = reinterpret_cast<const __half2*>(&b);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __half22float2(x[i]);
    const float2 w = __half22float2(y[i]);
    acc = fmaf(u.x, w.x, acc);
    acc = fmaf(u.y, w.y, acc);
  }
  return acc;
}

__device__ __forceinline__ float dot16(const uint4& a, const uint4& b,
                                       const float*) {
  const float4 u = *reinterpret_cast<const float4*>(&a);
  const float4 w = *reinterpret_cast<const float4*>(&b);
  return fmaf(u.w, w.w, fmaf(u.z, w.z, fmaf(u.y, w.y, u.x * w.x)));
}

template <typename T>
__global__ void __launch_bounds__(kDeltaWarps * 32)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, int S, int H, int hd,
                       Strides st, long long rows, int lpr) {
  const int lane = threadIdx.x & 31;
  const long long r =
      (static_cast<long long>(blockIdx.x) * kDeltaWarps + (threadIdx.x >> 5)) *
          (32 / lpr) +
      lane / lpr;
  const int l = lane % lpr;
  constexpr int V = 16 / sizeof(T);
  float acc = 0.f;
  int b = 0, s = 0, h = 0;
  if (r < rows) {
    h = static_cast<int>(r % H);
    const long long bs = r / H;
    s = static_cast<int>(bs % S);
    b = static_cast<int>(bs / S);
    const T* orow = out + b * st.o_b + s * st.o_s + h * st.o_h;
    const T* drow = dout + b * st.do_b + s * st.do_s + h * st.do_h;
    for (int c = l * V; c < hd; c += lpr * V) {
      acc += dot16(*reinterpret_cast<const uint4*>(orow + c),
                   *reinterpret_cast<const uint4*>(drow + c),
                   static_cast<const T*>(nullptr));
    }
  }
  for (int o = lpr / 2; o > 0; o >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  }
  if (r < rows && l == 0) {
    delta[(static_cast<long long>(b) * H + h) * S + s] = acc;
  }
}

template <typename T>
cudaError_t launch_delta(const void* out, const void* dout, float* delta,
                         int B, int S, int H, int hd, const Strides& st,
                         cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  int lpr = 1;
  while (lpr < 32 && lpr * V < hd) lpr *= 2;
  const long long rows = static_cast<long long>(B) * S * H;
  const long long per_block = kDeltaWarps * (32 / lpr);
  const long long blocks = (rows + per_block - 1) / per_block;
  flash_bwd_delta_kernel<T><<<static_cast<unsigned>(blocks),
                              kDeltaWarps * 32, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, S, H,
      hd, st, rows, lpr);
  return cudaGetLastError();
}

// ---- bf16/f16: wgmma, TMA rings, registers ----

constexpr float kLog2e = 1.4426950408889634f;

template <int DP, int NWG>
struct BwdTiles {
  // Up to width 128 each consumer warpgroup owns 64 resident rows and
  // its outputs' whole width. Above, the accumulators (dK and dV: DP
  // registers a thread) do not fit: both warpgroups take the same 64
  // rows, each owns ON = DP / NWG of the output columns and computes S
  // and dP for them itself.
  static constexpr bool SPLIT = DP > 128;
  static constexpr int BR = SPLIT ? 64 : 64 * NWG;  // resident rows
  static constexpr int ON = SPLIT ? DP / NWG : DP;  // a warpgroup's columns
  static constexpr int BS = 64;              // streamed rows per tile
  static constexpr int STAGES = DP > 192 ? 2 : 3;   // shared memory
  static constexpr int RES = BR * DP * 2;    // one resident tile (bytes)
  static constexpr int STR = BS * DP * 2;    // one streamed tile
  // a stage: two streamed tiles, then (dk/dv pass) the tile's lse and
  // delta, 64 floats each
  static constexpr int STAGE = 2 * STR + 1024;
  __host__ __device__ static constexpr int res_off(int i) { return i * RES; }
  __host__ __device__ static constexpr int str_off(int s, int i) {
    return 2 * RES + s * STAGE + i * STR;
  }
  __host__ __device__ static constexpr int stat_off(int s) {
    return 2 * RES + s * STAGE + 2 * STR;
  }
  static constexpr int bar_off = 2 * RES + STAGES * STAGE;
  static constexpr int SMEM = bar_off + 8 * (1 + 2 * STAGES) + 1024;
  // the consumers and a whole producer warpgroup, whose registers
  // setmaxnreg hands to them (one warp of it loads)
  static constexpr int THREADS = 128 * NWG + 128;
};

constexpr int kBwdNWG = 2;
constexpr int kProducerRegs = 40;    // after setmaxnreg
constexpr int kConsumerRegs = 232;   // 128 x 40 + 256 x 232 <= 65536

// Pack an m64n64 accumulator, rounded to T, into the A fragments of four
// k16 steps.
template <typename T>
__device__ __forceinline__ void to_frags(const float (&x)[32],
                                         uint32_t (&f)[4][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    f[n / 2][(n % 2) * 2] = ptt::pack2<T>(x[4 * n], x[4 * n + 1]);
    f[n / 2][(n % 2) * 2 + 1] = ptt::pack2<T>(x[4 * n + 2], x[4 * n + 3]);
  }
}

// Round a thread's rows (row0, row0 + 8) of an m64nN accumulator to T and
// store them by stride; rows past S and columns past hd are dropped.
template <int N, typename T>
__device__ __forceinline__ void store_acc(T* base, long long row_stride,
                                          const float (&acc)[N / 2],
                                          int row0, int c2, int S, int hd) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    if (8 * n < hd) {                  // hd is a multiple of 8
      const int col = 8 * n + c2;
      if (row0 < S) {
        *reinterpret_cast<uint32_t*>(base + row0 * row_stride + col) =
            ptt::pack2<T>(acc[4 * n], acc[4 * n + 1]);
      }
      if (row0 + 8 < S) {
        *reinterpret_cast<uint32_t*>(base + (row0 + 8) * row_stride + col) =
            ptt::pack2<T>(acc[4 * n + 2], acc[4 * n + 3]);
      }
    }
  }
}

// dk/dv pass: a block owns BR keys (64 a consumer warpgroup, or 64 shared
// by both above width 128) with K and V resident; q, dO, lse and delta
// stream in 64-row tiles from the diagonal on. Per tile, by wgmma:
// S^T = K Q^T and dP^T = V dO^T (shared operands), P^T = exp(S^T scale -
// lse) and dS^T = P^T (dP^T - delta) scale in registers, then dV += P^T
// dO and dK += dS^T Q with P^T and dS^T (rounded) as register A operands
// and dO, Q read MN-major.
template <int DP, typename T>
__global__ void __launch_bounds__(BwdTiles<DP, kBwdNWG>::THREADS, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            T* __restrict__ dk, T* __restrict__ dv, int S,
                            int H, int hd, Strides st, float scale,
                            int causal) {
  constexpr int NWG = kBwdNWG;
  using C = BwdTiles<DP, NWG>;
  using P = ptt::Panels<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = ptt::align_1024(smem_raw);
  uint64_t* bar_res = reinterpret_cast<uint64_t*>(smem + C::bar_off);
  uint64_t* full = bar_res + 1;
  uint64_t* empty = full + C::STAGES;

  const int k0 = blockIdx.x * C::BR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * H + h;
  const int nq = (S + C::BS - 1) / C::BS;
  const int i0 = causal ? k0 / C::BS : 0;     // the reference's i_start
  const int tiles = nq - i0;

  if (threadIdx.x == 0) {
    ptt::mbar_init(bar_res, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      ptt::mbar_init(&full[s], 32);   // the producer warp's 32 lanes
      ptt::mbar_init(&empty[s], 4 * NWG);
    }
    ptt::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * NWG) {              // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (threadIdx.x >= 128 * NWG + 32) return;  // one warp loads
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      ptt::mbar_arrive_tx(bar_res, 2 * C::RES);
      for (int w = 0; w < C::BR / 64; ++w) {
        for (int p = 0; p < P::NP; ++p) {
          const int off = (p * C::BR + 64 * w) * P::SWB;
          ptt::tma_load_4d(smem + C::res_off(0) + off, &tk, bar_res,
                           p * P::PW, k0 + 64 * w, h, b);
          ptt::tma_load_4d(smem + C::res_off(1) + off, &tv, bar_res,
                           p * P::PW, k0 + 64 * w, h, b);
        }
      }
    }
    for (int it = 0; it < tiles; ++it) {
      const int s = it % C::STAGES;
      const int q0 = (i0 + it) * C::BS;
      ptt::mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
      if (lane == 0) {
        ptt::mbar_expect_tx(&full[s], 2 * C::STR);
        for (int p = 0; p < P::NP; ++p) {
          const int off = p * C::BS * P::SWB;
          ptt::tma_load_4d(smem + C::str_off(s, 0) + off, &tq, &full[s],
                           p * P::PW, q0, h, b);
          ptt::tma_load_4d(smem + C::str_off(s, 1) + off, &tdo, &full[s],
                           p * P::PW, q0, h, b);
        }
      }
      // lse (log2 domain) and delta of the tile's rows; rows past S get 0
      float* stat = reinterpret_cast<float*>(smem + C::stat_off(s));
      for (int r = lane; r < C::BS; r += 32) {
        const int qpos = q0 + r;
        stat[r] = qpos < S ? lse[bh * S + qpos] * kLog2e : 0.f;
        stat[C::BS + r] = qpos < S ? delta[bh * S + qpos] : 0.f;
      }
      ptt::mbar_arrive(&full[s]);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  // the warpgroup index through a shuffle, so the compiler sees it (and
  // the loop bounds and branches made from it) uniform
  const int wg =
      __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 7), 0);
  const int lane = threadIdx.x & 31;
  const int c2 = (lane & 3) * 2;
  const int row_w = C::SPLIT ? 0 : 64 * wg;   // my first resident row
  const int col_w = C::SPLIT ? C::ON * wg : 0;  // my first output column
  const int kw0 = k0 + row_w;
  const int key0 = kw0 + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
  const int key1 = key0 + 8;
  const uint32_t sbase = ptt::smem_u32(smem);
  const uint32_t sK = sbase + C::res_off(0);
  const uint32_t sV = sbase + C::res_off(1);
  const float scale_log2 = scale * kLog2e;

  float acc_k[C::ON / 2], acc_v[C::ON / 2];
#pragma unroll
  for (int i = 0; i < C::ON / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

  ptt::mbar_wait(bar_res, 0);
  for (int it = 0; it < tiles; ++it) {
    const int s = it % C::STAGES;
    const int q0 = (i0 + it) * C::BS;
    ptt::mbar_wait(&full[s], (it / C::STAGES) & 1);
    if (!causal || q0 + C::BS - 1 >= kw0) {   // not wholly above the keys
      const uint32_t sQ = sbase + C::str_off(s, 0);
      const uint32_t sdO = sbase + C::str_off(s, 1);
      const float* stat =
          reinterpret_cast<const float*>(smem + C::stat_off(s));
      float sp[32], dp[32];            // S^T then P^T; dP^T then dS^T
      ptt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        ptt::wgmma_ss<64, T>(sp, P::kmajor(sK, C::BR, row_w, kk),
                             P::kmajor(sQ, C::BS, 0, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        ptt::wgmma_ss<64, T>(dp, P::kmajor(sV, C::BR, row_w, kk),
                             P::kmajor(sdO, C::BS, 0, kk), kk > 0);
      }
      ptt::wgmma_commit();
      ptt::wgmma_wait<0>();
      ptt::fence_regs(sp);
      ptt::fence_regs(dp);

      const bool edge = q0 + C::BS > S || kw0 + 64 > S ||
                        (causal && q0 < kw0 + 63);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qc = 8 * n + c2 + e;
          const float l2 = stat[qc];
          float p0 = ptt::ex2(sp[4 * n + e] * scale_log2 - l2);
          float p1 = ptt::ex2(sp[4 * n + 2 + e] * scale_log2 - l2);
          if (edge) {
            const int qpos = q0 + qc;
            if (qpos >= S || key0 >= S || (causal && key0 > qpos)) p0 = 0.f;
            if (qpos >= S || key1 >= S || (causal && key1 > qpos)) p1 = 0.f;
          }
          sp[4 * n + e] = p0;
          sp[4 * n + 2 + e] = p1;
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dl = stat[C::BS + 8 * n + c2 + e];
          dp[4 * n + e] = sp[4 * n + e] * (dp[4 * n + e] - dl) * scale;
          dp[4 * n + 2 + e] =
              sp[4 * n + 2 + e] * (dp[4 * n + 2 + e] - dl) * scale;
        }
      }
      // both f32 tiles die into 16-bit fragments before the products
      // (two accumulators of DP / 2 leave no room to overlap them)
      uint32_t pf[4][4], df[4][4];
      to_frags<T>(sp, pf);
      to_frags<T>(dp, df);
      ptt::wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        ptt::wgmma_rs<C::ON, T>(
            acc_v, pf[kt], P::mnmajor(sdO, C::BS, 16 * kt, col_w), 1);
      }
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        ptt::wgmma_rs<C::ON, T>(
            acc_k, df[kt], P::mnmajor(sQ, C::BS, 16 * kt, col_w), 1);
      }
      ptt::wgmma_commit();
      ptt::wgmma_wait<0>();
      ptt::fence_regs(acc_v);
      ptt::fence_regs(acc_k);
    }
    __syncwarp();
    if (lane == 0) ptt::mbar_arrive(&empty[s]);
  }
  store_acc<C::ON>(dk + b * st.dk_b + h * st.dk_h + col_w, st.dk_s, acc_k,
                   key0, c2, S, hd - col_w);
  store_acc<C::ON>(dv + b * st.dv_b + h * st.dv_h + col_w, st.dv_s, acc_v,
                   key0, c2, S, hd - col_w);
}

// dq pass: a block owns BR query rows (as the dk/dv pass its keys) with
// Q and dO resident (their lse
// and delta in registers); k and v stream in 64-key tiles up to the
// diagonal. Per tile: S = Q K^T and dP = dO V^T (shared operands), P and
// dS = P (dP - delta) scale in registers, dQ += dS K with dS (rounded) as
// the register A operand and K read MN-major.
template <int DP, typename T>
__global__ void __launch_bounds__(BwdTiles<DP, kBwdNWG>::THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dq, int S, int H, int hd,
                          Strides st, float scale, int causal) {
  constexpr int NWG = kBwdNWG;
  using C = BwdTiles<DP, NWG>;
  using P = ptt::Panels<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = ptt::align_1024(smem_raw);
  uint64_t* bar_res = reinterpret_cast<uint64_t*>(smem + C::bar_off);
  uint64_t* full = bar_res + 1;
  uint64_t* empty = full + C::STAGES;

  const int nb = (S + C::BR - 1) / C::BR;
  const int q0 = (nb - 1 - static_cast<int>(blockIdx.x)) * C::BR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * H + h;
  const int nk = (S + C::BS - 1) / C::BS;
  const int tiles = causal ? min((q0 + C::BR - 1) / C::BS + 1, nk) : nk;

  if (threadIdx.x == 0) {
    ptt::mbar_init(bar_res, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      ptt::mbar_init(&full[s], 1);
      ptt::mbar_init(&empty[s], 4 * NWG);
    }
    ptt::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * NWG) {              // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (threadIdx.x == 128 * NWG) {
      ptt::mbar_arrive_tx(bar_res, 2 * C::RES);
      for (int w = 0; w < C::BR / 64; ++w) {
        for (int p = 0; p < P::NP; ++p) {
          const int off = (p * C::BR + 64 * w) * P::SWB;
          ptt::tma_load_4d(smem + C::res_off(0) + off, &tq, bar_res,
                           p * P::PW, q0 + 64 * w, h, b);
          ptt::tma_load_4d(smem + C::res_off(1) + off, &tdo, bar_res,
                           p * P::PW, q0 + 64 * w, h, b);
        }
      }
      for (int j = 0; j < tiles; ++j) {
        const int s = j % C::STAGES;
        ptt::mbar_wait(&empty[s], ((j / C::STAGES) & 1) ^ 1);
        ptt::mbar_arrive_tx(&full[s], 2 * C::STR);
        for (int p = 0; p < P::NP; ++p) {
          const int off = p * C::BS * P::SWB;
          ptt::tma_load_4d(smem + C::str_off(s, 0) + off, &tk, &full[s],
                           p * P::PW, j * C::BS, h, b);
          ptt::tma_load_4d(smem + C::str_off(s, 1) + off, &tv, &full[s],
                           p * P::PW, j * C::BS, h, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  // the warpgroup index through a shuffle, so the compiler sees it (and
  // the loop bounds and branches made from it) uniform
  const int wg =
      __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 7), 0);
  const int lane = threadIdx.x & 31;
  const int c2 = (lane & 3) * 2;
  const int row_w = C::SPLIT ? 0 : 64 * wg;   // my first resident row
  const int col_w = C::SPLIT ? C::ON * wg : 0;  // my first output column
  const int qw0 = q0 + row_w;
  const int row0 = qw0 + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
  const int row1 = row0 + 8;
  const int wg_tiles = causal ? min((qw0 + 63) / C::BS + 1, nk) : nk;
  const uint32_t sbase = ptt::smem_u32(smem);
  const uint32_t sQ = sbase + C::res_off(0);
  const uint32_t sdO = sbase + C::res_off(1);
  const float scale_log2 = scale * kLog2e;
  const float l20 = row0 < S ? lse[bh * S + row0] * kLog2e : 0.f;
  const float l21 = row1 < S ? lse[bh * S + row1] * kLog2e : 0.f;
  const float dl0 = row0 < S ? delta[bh * S + row0] : 0.f;
  const float dl1 = row1 < S ? delta[bh * S + row1] : 0.f;

  auto release = [&](int j) {
    __syncwarp();
    if (lane == 0) ptt::mbar_arrive(&empty[j % C::STAGES]);
  };

  float acc[C::ON / 2];
#pragma unroll
  for (int i = 0; i < C::ON / 2; ++i) acc[i] = 0.f;
  float sp[32], dp[32];
  uint32_t df[4][4];

  // Tile 0, then for each next tile j: S_j and dP_j are issued before
  // dQ += dS_{j-1} K_{j-1}, and dS_j is computed while that product runs.
  ptt::mbar_wait(bar_res, 0);
  for (int j = 0; j < wg_tiles; ++j) {
    ptt::mbar_wait(&full[j % C::STAGES], (j / C::STAGES) & 1);
    const uint32_t sK = sbase + C::str_off(j % C::STAGES, 0);
    const uint32_t sV = sbase + C::str_off(j % C::STAGES, 1);
    ptt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      ptt::wgmma_ss<64, T>(sp, P::kmajor(sQ, C::BR, row_w, kk),
                           P::kmajor(sK, C::BS, 0, kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      ptt::wgmma_ss<64, T>(dp, P::kmajor(sdO, C::BR, row_w, kk),
                           P::kmajor(sV, C::BS, 0, kk), kk > 0);
    }
    ptt::wgmma_commit();
    if (j > 0) {
      const uint32_t sKp = sbase + C::str_off((j - 1) % C::STAGES, 0);
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        ptt::wgmma_rs<C::ON, T>(
            acc, df[kt], P::mnmajor(sKp, C::BS, 16 * kt, col_w), 1);
      }
      ptt::wgmma_commit();
      ptt::wgmma_wait<1>();            // S_j and dP_j have landed
    } else {
      ptt::wgmma_wait<0>();
    }
    ptt::fence_regs(sp);
    ptt::fence_regs(dp);

    const int k0 = j * C::BS;
    const bool edge = k0 + C::BS > S || (causal && k0 + C::BS - 1 > qw0);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p0 = ptt::ex2(sp[4 * n + e] * scale_log2 - l20);
        float p1 = ptt::ex2(sp[4 * n + 2 + e] * scale_log2 - l21);
        if (edge) {
          const int key = k0 + 8 * n + c2 + e;
          if (key >= S || (causal && key > row0)) p0 = 0.f;
          if (key >= S || (causal && key > row1)) p1 = 0.f;
        }
        dp[4 * n + e] = p0 * (dp[4 * n + e] - dl0) * scale;
        dp[4 * n + 2 + e] = p1 * (dp[4 * n + 2 + e] - dl1) * scale;
      }
    }
    if (j > 0) {
      ptt::wgmma_wait<0>();            // dQ += dS_{j-1} K_{j-1} has landed
      ptt::fence_regs(acc);
      release(j - 1);
    }
    to_frags<T>(dp, df);
  }
  {
    const uint32_t sKp = sbase + C::str_off((wg_tiles - 1) % C::STAGES, 0);
    ptt::wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      ptt::wgmma_rs<C::ON, T>(
          acc, df[kt], P::mnmajor(sKp, C::BS, 16 * kt, col_w), 1);
    }
    ptt::wgmma_commit();
    ptt::wgmma_wait<0>();
    ptt::fence_regs(acc);
    release(wg_tiles - 1);
  }
  for (int j = wg_tiles; j < tiles; ++j) {   // tiles wholly past my rows
    ptt::mbar_wait(&full[j % C::STAGES], (j / C::STAGES) & 1);
    release(j);
  }
  store_acc<C::ON>(dq + b * st.dq_b + h * st.dq_h + col_w, st.dq_s, acc,
                   row0, c2, S, hd - col_w);
}

template <int DP, typename T>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dq, void* dk, void* dv,
                         int B, int S, int H, int hd, const Strides& st,
                         float scale, int causal, cudaStream_t stream) {
  using C = BwdTiles<DP, kBwdNWG>;
  using P = ptt::Panels<DP>;
  CUtensorMap mq, mk, mv, mdo;       // one box shape: (PW, 64) rows
  cudaError_t err = ptt::make_bshd_map<T>(&mq, q, B, S, H, hd, st.q_b,
                                          st.q_s, st.q_h, P::PW, 64);
  if (err == cudaSuccess) {
    err = ptt::make_bshd_map<T>(&mk, k, B, S, H, hd, st.k_b, st.k_s, st.k_h,
                                P::PW, 64);
  }
  if (err == cudaSuccess) {
    err = ptt::make_bshd_map<T>(&mv, v, B, S, H, hd, st.v_b, st.v_s, st.v_h,
                                P::PW, 64);
  }
  if (err == cudaSuccess) {
    err = ptt::make_bshd_map<T>(&mdo, dout, B, S, H, hd, st.do_b, st.do_s,
                                st.do_h, P::PW, 64);
  }
  if (err != cudaSuccess) return err;
  auto kv_kernel = flash_bwd_dkdv_wgmma_kernel<DP, T>;
  auto q_kernel = flash_bwd_dq_wgmma_kernel<DP, T>;
  err = cudaFuncSetAttribute(
      kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((S + C::BR - 1) / C::BR, H, B);
  kv_kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      S, H, hd, st, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  q_kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<T*>(dq), S, H, hd, st, scale,
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
// multiple of 4); D <= 256. strides: 24 values, (batch, seq, head) for q,
// k, v, dout, dq, dk, dv, out in that order. delta: [B, H, S] f32
// scratch. Launches the delta pass, the dk/dv pass, then the dq pass, on
// `stream`. Returns a cudaError_t.
int ptt_flash_attention_bwd(const void* q, const void* k, const void* v,
                            const void* dout, const void* out,
                            const float* lse, float* delta, void* dq,
                            void* dk, void* dv, int B, int S, int H, int D,
                            const long long* strides, float scale,
                            int causal, int dtype, void* stream) {
  const long long* s = strides;
  const Strides st{s[0],  s[1],  s[2],  s[3],  s[4],  s[5],  s[6],  s[7],
                   s[8],  s[9],  s[10], s[11], s[12], s[13], s[14], s[15],
                   s[16], s[17], s[18], s[19], s[20], s[21], s[22], s[23]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1 || D < 1 || D > 256 || dtype < 0 ||
      dtype > 2 || D % (dtype == 2 ? 4 : 8)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err =
      dtype == 0   ? launch_delta<__nv_bfloat16>(out, dout, delta, B, S, H, D,
                                                 st, cs)
      : dtype == 1 ? launch_delta<__half>(out, dout, delta, B, S, H, D, st,
                                          cs)
                   : launch_delta<float>(out, dout, delta, B, S, H, D, st,
                                         cs);
  if (err != cudaSuccess) return err;
  if (dtype == 2) {
    return launch_f32(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H, D, st,
                      scale, causal, cs);
  }
  const int dp = tile_width(D);
#define PTT_BWD_WGMMA_CASE(DIM, TYPE, CODE)                                 \
  if (dtype == CODE && dp == DIM)                                         \
    return launch_wgmma<DIM, TYPE>(q, k, v, dout, lse, delta, dq, dk, dv, \
                                   B, S, H, D, st, scale, causal, cs);
  PTT_BWD_WGMMA_CASE(32, __nv_bfloat16, 0)
  PTT_BWD_WGMMA_CASE(64, __nv_bfloat16, 0)
  PTT_BWD_WGMMA_CASE(96, __nv_bfloat16, 0)
  PTT_BWD_WGMMA_CASE(128, __nv_bfloat16, 0)
  PTT_BWD_WGMMA_CASE(192, __nv_bfloat16, 0)
  PTT_BWD_WGMMA_CASE(256, __nv_bfloat16, 0)
  PTT_BWD_WGMMA_CASE(32, __half, 1)
  PTT_BWD_WGMMA_CASE(64, __half, 1)
  PTT_BWD_WGMMA_CASE(96, __half, 1)
  PTT_BWD_WGMMA_CASE(128, __half, 1)
  PTT_BWD_WGMMA_CASE(192, __half, 1)
  PTT_BWD_WGMMA_CASE(256, __half, 1)
#undef PTT_BWD_WGMMA_CASE
  return cudaErrorInvalidValue;
}

const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
