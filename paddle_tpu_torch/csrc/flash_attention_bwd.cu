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
// float32: `flash_bwd_*_f32_kernel` below put all seven products on the
// tensor cores as 3xTF32 (csrc/tf32_tiles.cuh: each f32 operand a = hi +
// lo, a b ~= lo*hi + hi*lo + hi*hi in f32 sums, ~2^-21 of |a b| a product;
// one TF32 product alone would not hold the plain f32 version to 1e-4).
// wgmma takes TF32 only K-major, so the products over the streamed rows
// (dV, dK, dQ) read a transposed copy of the streamed tile, which the
// producer warpgroup stores beside the tile as it stands, both split into
// hi and lo halves. The resident operands (K and V, or Q and dO) are the
// register A operands of the score products: each consumer thread keeps
// its own fragments unsplit in shared memory and splits them a k8 step at
// a time, half the bytes of resident hi/lo tiles (which would not fit at
// widths 192 and 256). dk/dv: one consumer warpgroup computes S^T, P^T and
// dK, so each keeps one DP-wide accumulator; dq: two consumer warpgroups
// split each k tile's keys (their partial dQ added at the end in a fixed
// order) up to width 96, and from 128 on the D sums of S and dP (their
// halves added through shared memory) and dQ's columns.
// Head_dim any multiple of 4 up to 256, at the next tile width; the mask
// on diagonal and ragged tiles only, and a causal block starts or stops
// at its diagonal tile; tile sizes follow the width, never S. Each block
// owns its output rows and adds in a fixed order: two runs give the same
// bits. Bound by the tensor cores (three TF32 products, 495 TFLOP/s dense,
// for each f32 one). (An earlier design ran f32 FMAs on the CUDA cores,
// one warp a row; PERF.md keeps its times.)
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
#include "tf32_tiles.cuh"

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

// ---- float32: 3xTF32 products on wgmma ----

// f32 tiles, from the width alone (never S). Both passes own 64 resident
// rows a block and stream BS rows a tile (64 up to width 96, 32 at 128, 16
// above): the most that fits 227 KB of shared memory without spilling
// registers (64 rows at width 128 spilled and ran slower on an H100):
//  - a resident operand (K, V in the dk/dv pass; Q, dO in the dq pass) is
//    the register A operand of its products. Each consumer thread keeps
//    its own A fragments, unsplit, in shared memory (16 bytes a k8 step,
//    the 128 threads' side by side: no bank conflicts, no barrier, half
//    the bytes of the hi and lo halves) and splits them as it issues;
//  - a streamed tile is stored by the producer warpgroup in hi and lo
//    halves, K-major over D as it stands ([BS][DP], panels of 32 floats)
//    for the score products, and transposed ([DP][BS], panels of TW
//    floats, the rows in the order the score accumulator leaves its
//    columns) for the output products, whose reduction runs over it.
// Every tile sits on 1024 bytes.
template <int DP>
struct F32Bwd {
  // streamed rows a tile (q rows in dk/dv, keys in dq), the panel width
  // of its transposed copy, the bytes of one half of it
  static constexpr int BS = DP <= 96 ? 64 : DP <= 128 ? 32 : 16;
  static constexpr int TW = BS < 32 ? BS : 32;
  static constexpr int TILE = BS * DP * 4;
  static constexpr int RES = 128 * (DP / 2) * 4;  // a warpgroup's fragments
  // dk/dv: K and V fragments (one consumer warpgroup each), q and dO as
  // they stand (hi, lo each), q^T and dO^T (the same bytes at widths 96
  // and 256, where both do not fit), the tile's lse and delta, two P^T
  // exchange slots, then the mbarriers
  static constexpr bool KV_SHARED = DP == 96 || DP == 256;
  static constexpr int KV_NAT = 2 * RES;
  static constexpr int KV_TR = KV_NAT + (KV_SHARED ? 0 : 4 * TILE);
  static constexpr int KV_STAT = KV_NAT + (KV_SHARED ? 4 : 8) * TILE;
  static constexpr int KV_X = KV_STAT + 1024;
  static constexpr int KV_BAR = KV_X + 2 * 128 * (BS / 2) * 4;
  static constexpr int KV_SMEM = KV_BAR + 8 * 8 + 1024;
  // dq: q and dO fragments, k and v as they stand, k^T, the mbarriers
  static constexpr int Q_NAT = 2 * RES;
  static constexpr int Q_TR = Q_NAT + 4 * TILE;
  static constexpr int Q_BAR = Q_TR + 2 * TILE;
  static constexpr int Q_SMEM = Q_BAR + 4 * 8 + 1024;
  static_assert(KV_SMEM <= 232448 && Q_SMEM <= 232448, "shared memory");
};

// setmaxnreg in both passes (384 threads, 168 registers each at launch,
// 128 x producer + 256 x consumer = 384 x 168): the producer holds two
// tensors' loads of a streamed tile at once, the consumers an accumulator
// of up to DP / 2 registers beside the score tile and its A operands.
// The split, by pass and width, is the fastest of those timed on an H100
// (a producer that spills runs both passes slower; at width 128 the dk/dv
// pass ran faster at 168 / 168 than at 152 / 176, the dq pass the other
// way round; at 192 the dq pass ran faster at 136 / 184).
template <int DP, bool KV>
struct F32Regs {
  static constexpr int PRODUCER =
      KV ? (DP > 192 ? 136 : DP == 192 ? 152 : 168) : DP >= 192 ? 136 : 152;
  static constexpr int CONSUMER = (384 * 168 - 128 * PRODUCER) / 256;
};

template <int DP, bool KV>
__device__ __forceinline__ void producer_regs() {
  if constexpr (F32Regs<DP, KV>::PRODUCER < 168) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        F32Regs<DP, KV>::PRODUCER));
  }
}

template <int DP, bool KV>
__device__ __forceinline__ void consumer_regs() {
  if constexpr (F32Regs<DP, KV>::CONSUMER > 168) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        F32Regs<DP, KV>::CONSUMER));
  }
}

// Consumer thread t's A fragments of the 64 resident rows from r0 (zeros
// past S and hd): k8 step kk holds rows 16 (t / 32) + (t % 32) / 4 and
// that + 8, columns 8 kk + t % 4 and that + 4, in the register order of a
// TF32 A fragment, at bytes 16 (128 kk + t).
template <int DP>
__device__ __forceinline__ void store_frags(uint8_t* res, const float* src,
                                            long long rs, int r0, int S,
                                            int hd, int t) {
  const int lane = t & 31;
  const int ra = r0 + 16 * (t >> 5) + (lane >> 2), rb = ra + 8;
  const bool oka = ra < S, okb = rb < S;
#pragma unroll 4
  for (int kk = 0; kk < DP / 8; ++kk) {
    const int c0 = 8 * kk + (lane & 3), c1 = c0 + 4;
    float4 f;
    f.x = oka && c0 < hd ? src[ra * rs + c0] : 0.f;
    f.y = okb && c0 < hd ? src[rb * rs + c0] : 0.f;
    f.z = oka && c1 < hd ? src[ra * rs + c1] : 0.f;
    f.w = okb && c1 < hd ? src[rb * rs + c1] : 0.f;
    *reinterpret_cast<float4*>(res + (kk * 128 + t) * 16) = f;
  }
}

__device__ __forceinline__ void load_frag(const uint8_t* res, int kk, int t,
                                          uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(res + (kk * 128 + t) * 16);
  ptt::split_tf32(f.x, hi[0], lo[0]);
  ptt::split_tf32(f.y, hi[1], lo[1]);
  ptt::split_tf32(f.z, hi[2], lo[2]);
  ptt::split_tf32(f.w, hi[3], lo[3]);
}

// Register sets a resident product splits its fragments into: step kk
// uses set kk % kF32Sets, written again once step kk + 1 - kF32Sets has
// landed, so kF32Sets - 1 steps' products stay in flight.
constexpr int kF32Sets = 2;

// acc += A B^T as 3xTF32 over DP / 8 k8 steps, m64nN: A the thread's
// resident fragments, split a step at a time, B the K-major [N][DP] pair
// (hi at bh, lo at bl). Returns with every product landed.
template <int DP, int N>
__device__ __forceinline__ void res_product(float (&acc)[N / 2],
                                            const uint8_t* res, int t,
                                            uint32_t bh, uint32_t bl) {
  uint32_t h[kF32Sets][4], l[kF32Sets][4];
  load_frag(res, 0, t, h[0], l[0]);
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    const int s = kk % kF32Sets;
    const uint64_t dh = ptt::kmajor_desc<32>(bh, N, kk);
    const uint64_t dl = ptt::kmajor_desc<32>(bl, N, kk);
    ptt::wgmma_fence();
    ptt::wgmma_tf32_rs<N>(acc, l[s], dh);
    ptt::wgmma_tf32_rs<N>(acc, h[s], dl);
    ptt::wgmma_tf32_rs<N>(acc, h[s], dh);
    ptt::wgmma_commit();
    if (kk + 1 < DP / 8) {
      ptt::wgmma_wait<kF32Sets - 1>();
      const int n = (kk + 1) % kF32Sets;
      load_frag(res, kk + 1, t, h[n], l[n]);
    }
  }
  ptt::wgmma_wait<0>();
  ptt::fence_regs(acc);
}

// res_product for two products at once (the dq pass's S = Q K^T and dP =
// dO V^T) over the NKK k8 steps from kk0: a step issues both, so each
// step's group holds six products.
template <int NKK, int N, int ROWS>
__device__ __forceinline__ void res_product2(float (&acc0)[N / 2],
                                             const uint8_t* res0,
                                             uint32_t bh0, uint32_t bl0,
                                             float (&acc1)[N / 2],
                                             const uint8_t* res1,
                                             uint32_t bh1, uint32_t bl1,
                                             int t, int kk0) {
  uint32_t h0[kF32Sets][4], l0[kF32Sets][4];
  uint32_t h1[kF32Sets][4], l1[kF32Sets][4];
  load_frag(res0, kk0, t, h0[0], l0[0]);
  load_frag(res1, kk0, t, h1[0], l1[0]);
#pragma unroll
  for (int kk = 0; kk < NKK; ++kk) {
    const int s = kk % kF32Sets;
    const uint64_t dh0 = ptt::kmajor_desc<32>(bh0, ROWS, kk0 + kk);
    const uint64_t dl0 = ptt::kmajor_desc<32>(bl0, ROWS, kk0 + kk);
    const uint64_t dh1 = ptt::kmajor_desc<32>(bh1, ROWS, kk0 + kk);
    const uint64_t dl1 = ptt::kmajor_desc<32>(bl1, ROWS, kk0 + kk);
    ptt::wgmma_fence();
    ptt::wgmma_tf32_rs<N>(acc0, l0[s], dh0);
    ptt::wgmma_tf32_rs<N>(acc0, h0[s], dl0);
    ptt::wgmma_tf32_rs<N>(acc0, h0[s], dh0);
    ptt::wgmma_tf32_rs<N>(acc1, l1[s], dh1);
    ptt::wgmma_tf32_rs<N>(acc1, h1[s], dl1);
    ptt::wgmma_tf32_rs<N>(acc1, h1[s], dh1);
    ptt::wgmma_commit();
    if (kk + 1 < NKK) {
      ptt::wgmma_wait<kF32Sets - 1>();
      const int n = (kk + 1) % kF32Sets;
      load_frag(res0, kk0 + kk + 1, t, h0[n], l0[n]);
      load_frag(res1, kk0 + kk + 1, t, h1[n], l1[n]);
    }
  }
  ptt::wgmma_wait<0>();
  ptt::fence_regs(acc0);
  ptt::fence_regs(acc1);
}

// acc += X B as 3xTF32, m64nN: X an m64nBS score tile in the accumulator
// layout, split into the A operands of its BS / 8 k8 steps (slot t of step
// kk holds column 8 kk + 2 t, slot t + 4 column 8 kk + 2 t + 1: the order
// the producer's VUnits store B's rows in), B N rows (a multiple of 8 rows
// into a transposed [ROWS][..] pair, panels of TW floats) at k8 steps
// kk0... Returns with every product landed.
template <int N, int BS, int TW, int ROWS = N>
__device__ __forceinline__ void frag_product(float (&acc)[N / 2],
                                             const float (&x)[BS / 2],
                                             uint32_t bh, uint32_t bl,
                                             int kk0 = 0) {
  uint32_t h[BS / 8][4], l[BS / 8][4];
#pragma unroll
  for (int kk = 0; kk < BS / 8; ++kk) {
    ptt::split_tf32(x[4 * kk], h[kk][0], l[kk][0]);
    ptt::split_tf32(x[4 * kk + 2], h[kk][1], l[kk][1]);
    ptt::split_tf32(x[4 * kk + 1], h[kk][2], l[kk][2]);
    ptt::split_tf32(x[4 * kk + 3], h[kk][3], l[kk][3]);
  }
  ptt::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BS / 8; ++kk) {
    const uint64_t dh = ptt::kmajor_desc<TW>(bh, ROWS, kk0 + kk);
    const uint64_t dl = ptt::kmajor_desc<TW>(bl, ROWS, kk0 + kk);
    ptt::wgmma_tf32_rs<N>(acc, l[kk], dh);
    ptt::wgmma_tf32_rs<N>(acc, h[kk], dl);
    ptt::wgmma_tf32_rs<N>(acc, h[kk], dh);
  }
  ptt::wgmma_commit();
  ptt::wgmma_wait<0>();
  ptt::fence_regs(acc);
}

// A thread's rows (row0, row0 + 8) of an m64nDP f32 accumulator, stored by
// stride; rows past S and columns past hd are dropped.
template <int DP>
__device__ __forceinline__ void store_acc_f32(float* base, long long rs,
                                              const float (&acc)[DP / 2],
                                              int row0, int c2, int S,
                                              int hd) {
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = 8 * n + c2;
    if (col < hd) {                    // hd is a multiple of 4
      if (row0 < S) {
        *reinterpret_cast<float2*>(base + row0 * rs + col) =
            make_float2(acc[4 * n], acc[4 * n + 1]);
      }
      if (row0 + 8 < S) {
        *reinterpret_cast<float2*>(base + (row0 + 8) * rs + col) =
            make_float2(acc[4 * n + 2], acc[4 * n + 3]);
      }
    }
  }
}

// dk/dv pass: a block owns 64 keys. Warpgroup 0 holds K's fragments and
// computes S^T = K Q^T, P^T = exp(S^T scale - lse) and dV += P^T dO;
// warpgroup 1 holds V's and computes dP^T = V dO^T, takes P^T from
// warpgroup 0 through shared memory (two slots, mbarriers), forms dS^T =
// P^T (dP^T - delta) scale and dK += dS^T Q. Each owns one DP-wide
// accumulator (DP / 2 registers a thread). Warpgroup 2 is the producer:
// per q tile of BQ rows from the diagonal on (causal: the reference's
// i_start), q and dO as they stand with the tile's lse and delta (released
// once S^T, dP^T, P^T and dS^T are formed), then q^T and dO^T (released
// after the output products); at widths 96 and 256 the two share their
// bytes.
template <int DP>
__global__ void __launch_bounds__(384, 1)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int S, int H, int hd, Strides st, float scale,
                          int causal) {
  using C = F32Bwd<DP>;
  constexpr int BQ = C::BS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = ptt::align_1024(smem_raw);
  uint64_t* nat_full = reinterpret_cast<uint64_t*>(smem + C::KV_BAR);
  uint64_t* nat_empty = nat_full + 1;
  uint64_t* tr_full = nat_full + 2;
  uint64_t* tr_empty = nat_full + 3;
  uint64_t* x_full = nat_full + 4;         // two, a slot each
  uint64_t* x_empty = nat_full + 6;
  float* stat = reinterpret_cast<float*>(smem + C::KV_STAT);

  const int k0 = blockIdx.x * 64;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * H + h;
  const int nq = (S + BQ - 1) / BQ;
  const int i0 = causal ? k0 / BQ : 0;       // the reference's i_start
  const int tiles = nq - i0;

  if (threadIdx.x == 0) {
    ptt::mbar_init(nat_full, 128);
    ptt::mbar_init(tr_full, 128);
    ptt::mbar_init(nat_empty, 8);            // one arrival a consumer warp
    ptt::mbar_init(tr_empty, 8);
    for (int i = 0; i < 2; ++i) {
      ptt::mbar_init(&x_full[i], 128);
      ptt::mbar_init(&x_empty[i], 4);
    }
    ptt::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {                  // the producer
    producer_regs<DP, true>();
    const int pid = threadIdx.x - 256;
    const float* qh = q + b * st.q_b + h * st.q_h;
    const float* doh = dout + b * st.do_b + h * st.do_h;
    for (int it = 0; it < tiles; ++it) {
      const int q0 = (i0 + it) * BQ;
      {
        // both tensors' loads in flight while the slot is still in use
        ptt::RowUnits<DP, BQ> uq, ud;
        uq.load(qh, st.q_s, q0, S, hd, pid);
        ud.load(doh, st.do_s, q0, S, hd, pid);
        // the bytes are free once tile it - 1 no longer needs them
        ptt::mbar_wait(C::KV_SHARED ? tr_empty : nat_empty, (it & 1) ^ 1);
        uq.store(smem + C::KV_NAT, smem + C::KV_NAT + C::TILE, pid);
        ud.store(smem + C::KV_NAT + 2 * C::TILE,
                 smem + C::KV_NAT + 3 * C::TILE, pid);
        if (pid < BQ) {                        // lse in the log2 domain
          const int qpos = q0 + pid;
          stat[pid] = qpos < S ? lse[bh * S + qpos] * kLog2e : 0.f;
          stat[BQ + pid] = qpos < S ? delta[bh * S + qpos] : 0.f;
        }
        ptt::fence_proxy_async();
        ptt::mbar_arrive(nat_full);
      }
      {
        ptt::VUnits<DP, BQ, C::TW> uq, ud;
        uq.load(qh, st.q_s, q0, S, hd, pid);
        ud.load(doh, st.do_s, q0, S, hd, pid);
        if constexpr (C::KV_SHARED) {
          ptt::mbar_wait(nat_empty, it & 1);   // tile it's scores formed
        } else {
          ptt::mbar_wait(tr_empty, (it & 1) ^ 1);
        }
        uq.store(smem + C::KV_TR, smem + C::KV_TR + C::TILE, pid);
        ud.store(smem + C::KV_TR + 2 * C::TILE,
                 smem + C::KV_TR + 3 * C::TILE, pid);
        ptt::fence_proxy_async();
        ptt::mbar_arrive(tr_full);
      }
    }
    return;
  }

  consumer_regs<DP, true>();
  // the warpgroup index through a shuffle, so the compiler sees it (and
  // the branches made from it) uniform
  const int wg =
      __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 7), 0);
  const int t = threadIdx.x & 127;
  const int lane = threadIdx.x & 31;
  const int c2 = (lane & 3) * 2;
  const int key0 = k0 + (t >> 5) * 16 + (lane >> 2);
  const int key1 = key0 + 8;
  const uint32_t sbase = ptt::smem_u32(smem);
  // warpgroup 0: K's fragments and q for S^T, then dO^T for dV;
  // warpgroup 1: V's and dO for dP^T, then q^T for dK
  uint8_t* res = smem + wg * C::RES;
  if (wg == 0) {
    store_frags<DP>(res, k + b * st.k_b + h * st.k_h, st.k_s, k0, S, hd, t);
  } else {
    store_frags<DP>(res, v + b * st.v_b + h * st.v_h, st.v_s, k0, S, hd, t);
  }
  const uint32_t s_nat = sbase + C::KV_NAT + (wg == 0 ? 0 : 2) * C::TILE;
  const uint32_t s_tr = sbase + C::KV_TR + (wg == 0 ? 2 : 0) * C::TILE;
  const float scale_log2 = scale * kLog2e;
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) ptt::mbar_arrive(bar);
  };

  float acc[DP / 2];                     // dV (warpgroup 0) or dK (1)
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < tiles; ++it) {
    const int q0 = (i0 + it) * BQ;
    float sc[BQ / 2];                    // S^T then P^T; dP^T then dS^T
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) sc[i] = 0.f;
    ptt::mbar_wait(nat_full, it & 1);
    res_product<DP, BQ>(sc, res, t, s_nat, s_nat + C::TILE);
    float4* slot = reinterpret_cast<float4*>(smem + C::KV_X) +
                   (it & 1) * 128 * (BQ / 8);
    const uint32_t xpar = (it >> 1) & 1;
    if (wg == 0) {
      const bool edge = q0 + BQ > S || k0 + 64 > S ||
                        (causal && q0 < k0 + 63);
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qc = 8 * n + c2 + e;
          const float l2 = stat[qc];
          float p0 = ptt::ex2(sc[4 * n + e] * scale_log2 - l2);
          float p1 = ptt::ex2(sc[4 * n + 2 + e] * scale_log2 - l2);
          if (edge) {
            const int qpos = q0 + qc;
            if (qpos >= S || key0 >= S || (causal && key0 > qpos)) p0 = 0.f;
            if (qpos >= S || key1 >= S || (causal && key1 > qpos)) p1 = 0.f;
          }
          sc[4 * n + e] = p0;
          sc[4 * n + 2 + e] = p1;
        }
      }
      release(nat_empty);
      ptt::mbar_wait(&x_empty[it & 1], xpar ^ 1);
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
        slot[i * 128 + t] = make_float4(sc[4 * i], sc[4 * i + 1],
                                        sc[4 * i + 2], sc[4 * i + 3]);
      }
      ptt::mbar_arrive(&x_full[it & 1]);
    } else {
      ptt::mbar_wait(&x_full[it & 1], xpar);
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
        const float4 p = slot[i * 128 + t];
        const float dl0 = stat[BQ + 8 * i + c2];
        const float dl1 = stat[BQ + 8 * i + c2 + 1];
        sc[4 * i] = p.x * (sc[4 * i] - dl0) * scale;
        sc[4 * i + 1] = p.y * (sc[4 * i + 1] - dl1) * scale;
        sc[4 * i + 2] = p.z * (sc[4 * i + 2] - dl0) * scale;
        sc[4 * i + 3] = p.w * (sc[4 * i + 3] - dl1) * scale;
      }
      release(&x_empty[it & 1]);
      release(nat_empty);
    }
    ptt::mbar_wait(tr_full, it & 1);
    frag_product<DP, BQ, C::TW>(acc, sc, s_tr, s_tr + C::TILE);
    release(tr_empty);
  }
  if (wg == 0) {
    store_acc_f32<DP>(dv + b * st.dv_b + h * st.dv_h, st.dv_s, acc, key0, c2,
                      S, hd);
  } else {
    store_acc_f32<DP>(dk + b * st.dk_b + h * st.dk_h, st.dk_s, acc, key0, c2,
                      S, hd);
  }
}

// Both consumer warpgroups of a pass (256 threads) meet here.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// dq pass: a block owns 64 query rows and two consumer warpgroups share
// the work of every k tile of BK keys. Both read the block's Q and dO
// fragments (lse and delta of a thread's two rows in registers) and, per
// k tile up to the diagonal, compute S = Q K^T and dP = dO V^T, P and dS
// = P (dP - delta) scale in registers, and dQ += dS K. Up to width 96
// each takes half of the tile's keys and its own DP-wide dQ, and at the
// end warpgroup 1's partial dQ goes through shared memory to warpgroup 0,
// which adds it to its own (a fixed order); from 128 on each sums S and
// dP over half of D, the halves meet in shared memory (both warpgroups
// then hold the same S and dP bits), and each owns half of dQ's columns.
// The producer warpgroup stores k and v as they stand (released once S
// and dP are formed), then k^T (released after the dQ product).
template <int DP>
__global__ void __launch_bounds__(384, 1)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int S, int H, int hd,
                        Strides st, float scale, int causal) {
  using C = F32Bwd<DP>;
  constexpr int BK = C::BS;
  constexpr int HK = BK / 2;                 // a warpgroup's keys a tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = ptt::align_1024(smem_raw);
  uint64_t* nat_full = reinterpret_cast<uint64_t*>(smem + C::Q_BAR);
  uint64_t* nat_empty = nat_full + 1;
  uint64_t* tr_full = nat_full + 2;
  uint64_t* tr_empty = nat_full + 3;

  const int nb = (S + 63) / 64;
  const int q0 = (nb - 1 - static_cast<int>(blockIdx.x)) * 64;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * H + h;
  const int nk = (S + BK - 1) / BK;
  const int tiles = causal ? min((q0 + 63) / BK + 1, nk) : nk;

  if (threadIdx.x == 0) {
    ptt::mbar_init(nat_full, 128);
    ptt::mbar_init(tr_full, 128);
    ptt::mbar_init(nat_empty, 8);            // one arrival a consumer warp
    ptt::mbar_init(tr_empty, 8);
    ptt::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {                  // the producer
    producer_regs<DP, false>();
    const int pid = threadIdx.x - 256;
    const float* kh = k + b * st.k_b + h * st.k_h;
    const float* vh = v + b * st.v_b + h * st.v_h;
    for (int j = 0; j < tiles; ++j) {
      {
        // both tensors' loads in flight while the slot is still in use
        ptt::RowUnits<DP, BK> uk, uv;
        uk.load(kh, st.k_s, j * BK, S, hd, pid);
        uv.load(vh, st.v_s, j * BK, S, hd, pid);
        ptt::mbar_wait(nat_empty, (j & 1) ^ 1);
        uk.store(smem + C::Q_NAT, smem + C::Q_NAT + C::TILE, pid);
        uv.store(smem + C::Q_NAT + 2 * C::TILE,
                 smem + C::Q_NAT + 3 * C::TILE, pid);
        ptt::fence_proxy_async();
        ptt::mbar_arrive(nat_full);
      }
      {
        ptt::VUnits<DP, BK, C::TW> u;
        u.load(kh, st.k_s, j * BK, S, hd, pid);
        ptt::mbar_wait(tr_empty, (j & 1) ^ 1);
        u.store(smem + C::Q_TR, smem + C::Q_TR + C::TILE, pid);
        ptt::fence_proxy_async();
        ptt::mbar_arrive(tr_full);
      }
    }
    return;
  }

  consumer_regs<DP, false>();
  // the warpgroup index through a shuffle, so the compiler sees it (and
  // the branches made from it) uniform; this thread holds rows row0 and
  // row1 = row0 + 8, columns 8 n + c2 + {0, 1} of its warpgroup's keys
  const int wg =
      __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 7), 0);
  const int t = threadIdx.x & 127;
  const int lane = threadIdx.x & 31;
  const int c2 = (lane & 3) * 2;
  const int row0 = q0 + (t >> 5) * 16 + (lane >> 2);
  const int row1 = row0 + 8;
  const uint32_t sbase = ptt::smem_u32(smem);
  uint8_t* res_q = smem;
  uint8_t* res_do = smem + C::RES;
  // warpgroup 0 stores Q's fragments, warpgroup 1 dO's; both read both
  if (wg == 0) {
    store_frags<DP>(res_q, q + b * st.q_b + h * st.q_h, st.q_s, q0, S, hd,
                    t);
  } else {
    store_frags<DP>(res_do, dout + b * st.do_b + h * st.do_h, st.do_s, q0,
                    S, hd, t);
  }
  consumers_sync();
  const float scale_log2 = scale * kLog2e;
  const float l20 = row0 < S ? lse[bh * S + row0] * kLog2e : 0.f;
  const float l21 = row1 < S ? lse[bh * S + row1] * kLog2e : 0.f;
  const float dl0 = row0 < S ? delta[bh * S + row0] : 0.f;
  const float dl1 = row1 < S ? delta[bh * S + row1] : 0.f;
  // Up to width 96 the warpgroups split each k tile's keys (32 each); from
  // 128 on a tile has 32 or 16 keys, and they split D instead: each sums
  // S and dP over half of D, the two halves are added through shared
  // memory, and each owns half of dQ's columns (wider products, no
  // partial dQ to add at the end)
  constexpr bool DSPLIT = DP >= 128;
  constexpr int NS = DSPLIT ? BK : HK;          // score columns a warpgroup
  constexpr int NO = DSPLIT ? DP / 2 : DP;      // dQ columns a warpgroup
  constexpr int NKK = DSPLIT ? DP / 16 : DP / 8;  // k8 steps of S and dP
  const int kk0 = DSPLIT ? wg * NKK : 0;
  // my keys' rows in k and v as they stand (a multiple of 8 rows in)
  const uint32_t s_k = sbase + C::Q_NAT + (DSPLIT ? 0 : wg * HK * 128);
  const uint32_t s_v = s_k + 2 * C::TILE;
  // my rows of k^T (dQ's columns)
  const uint32_t s_kt = sbase + C::Q_TR + (DSPLIT ? wg * NO * C::TW * 4 : 0);
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) ptt::mbar_arrive(bar);
  };

  float acc[NO / 2];
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) acc[i] = 0.f;
  for (int j = 0; j < tiles; ++j) {
    const int k0 = j * BK + (DSPLIT ? 0 : wg * HK);   // my first key
    // causal: my keys may all lie above the block's rows in its last tile
    const bool live = !causal || k0 <= q0 + 63;
    float sp[NS / 2], dp[NS / 2];        // S then P; dP then dS
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) sp[i] = dp[i] = 0.f;
    ptt::mbar_wait(nat_full, j & 1);
    if (live) {
      res_product2<NKK, NS, BK>(sp, res_q, s_k, s_k + C::TILE, dp, res_do,
                                s_v, s_v + C::TILE, t, kk0);
    }
    if constexpr (DSPLIT) {
      // the other half of D's sums, through the bytes of k and v once
      // both warpgroups' products have read them (a + b = b + a: both
      // warpgroups hold the same bits)
      float4* x = reinterpret_cast<float4*>(smem + C::Q_NAT);
      consumers_sync();
#pragma unroll
      for (int i = 0; i < NS / 8; ++i) {
        x[((2 * wg) * (NS / 8) + i) * 128 + t] = make_float4(
            sp[4 * i], sp[4 * i + 1], sp[4 * i + 2], sp[4 * i + 3]);
        x[((2 * wg + 1) * (NS / 8) + i) * 128 + t] = make_float4(
            dp[4 * i], dp[4 * i + 1], dp[4 * i + 2], dp[4 * i + 3]);
      }
      consumers_sync();
#pragma unroll
      for (int i = 0; i < NS / 8; ++i) {
        const float4 os = x[((2 - 2 * wg) * (NS / 8) + i) * 128 + t];
        const float4 od = x[((3 - 2 * wg) * (NS / 8) + i) * 128 + t];
        sp[4 * i] += os.x;
        sp[4 * i + 1] += os.y;
        sp[4 * i + 2] += os.z;
        sp[4 * i + 3] += os.w;
        dp[4 * i] += od.x;
        dp[4 * i + 1] += od.y;
        dp[4 * i + 2] += od.z;
        dp[4 * i + 3] += od.w;
      }
    }
    release(nat_empty);
    const bool edge = k0 + NS > S || (causal && k0 + NS - 1 > q0);
#pragma unroll
    for (int n = 0; n < NS / 8; ++n) {
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
    ptt::mbar_wait(tr_full, j & 1);
    if (live) {
      frag_product<NO, NS, C::TW, DP>(acc, dp, s_kt, s_kt + C::TILE,
                                        DSPLIT ? 0 : wg * HK / 8);
    }
    release(tr_empty);
  }
  if constexpr (DSPLIT) {
    store_acc_f32<NO>(dq + b * st.dq_b + h * st.dq_h + wg * NO, st.dq_s, acc,
                      row0, c2, S, hd - wg * NO);
  } else {
    // warpgroup 1's dQ through the bytes of k and v (every product and
    // every store of the producer has landed once both are here)
    float4* part = reinterpret_cast<float4*>(smem + C::Q_NAT);
    consumers_sync();
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        part[i * 128 + t] = make_float4(acc[4 * i], acc[4 * i + 1],
                                        acc[4 * i + 2], acc[4 * i + 3]);
      }
    }
    consumers_sync();
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        const float4 o = part[i * 128 + t];
        acc[4 * i] += o.x;
        acc[4 * i + 1] += o.y;
        acc[4 * i + 2] += o.z;
        acc[4 * i + 3] += o.w;
      }
      store_acc_f32<DP>(dq + b * st.dq_b + h * st.dq_h, st.dq_s, acc, row0,
                        c2, S, hd);
    }
  }
}

template <int DP>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dq, void* dk, void* dv,
                       int B, int S, int H, int hd, const Strides& st,
                       float scale, int causal, cudaStream_t stream) {
  using C = F32Bwd<DP>;
  auto kv_kernel = flash_bwd_dkdv_f32_kernel<DP>;
  auto q_kernel = flash_bwd_dq_f32_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::KV_SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::Q_SMEM);
  if (err != cudaSuccess) return err;
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dout);
  dim3 grid((S + 63) / 64, H, B);
  kv_kernel<<<grid, 384, C::KV_SMEM, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), S, H, hd, st, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  q_kernel<<<grid, 384, C::Q_SMEM, stream>>>(
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
  const int dp = tile_width(D);
#define PTT_BWD_F32_CASE(DIM)                                               \
  if (dp == DIM)                                                          \
    return launch_f32<DIM>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H, \
                           D, st, scale, causal, cs);
  if (dtype == 2) {
    PTT_BWD_F32_CASE(32)
    PTT_BWD_F32_CASE(64)
    PTT_BWD_F32_CASE(96)
    PTT_BWD_F32_CASE(128)
    PTT_BWD_F32_CASE(192)
    PTT_BWD_F32_CASE(256)
    return cudaErrorInvalidValue;
  }
#undef PTT_BWD_F32_CASE
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
