// Fused AdamW with int8 moments for Hopper (sm_90a): one in-place pass
// over a LIST of leaves in one launch, each an [R, C] leaf's p, g, the
// int8 codes of m and of sqrt(v), and their per-row f32 scales. f32
// update math, decoupled weight decay, bias correction, the global
// grad-clip scale and an lr multiplier as in fused_adamw.cu; then m and
// sqrt(v) are requantized per row with stochastic rounding (m codes in
// [-127, 127], sqrt(v) codes in [0, 127]), and the new p optionally
// takes exact SR to bf16.
//
// Replaces: paddle_tpu/ops/fused_adamw.py `_kernel8` (:115), the
// pallas_call of `fused_adamw_update8` (:222), which the reference calls
// once per leaf; here one launch takes every leaf of one (p, g) dtype
// pair, and the per-leaf entry is that launch with a list of one. The
// TPU kernel draws all its noise from one core PRNG stream per row
// block; here each use has its own Philox4x32-10 stream (philox.cuh)
// under the key (seed + leaf_id * 1000003 mod 2^32, 0), with the
// counter (e / 4, stream, 0) for flat element e = r * C + c of the
// leaf: stream 0 for p, so p's bits equal fused_adamw.cu's for the same
// step and leaf, 1 for the m codes and 2 for the sqrt(v) codes. The
// plain PyTorch version (ops/fused_adamw.py) draws the same words.
//
// Bound on an H100 SXM (3.35 TB/s): per parameter read p, g (2 + 2
// bytes in bf16) and the two codes (1 + 1), write p and the two codes
// (2 + 1 + 1): 10 bytes, plus 16 bytes of scales per row: GPT-1.3B's 98
// int8-moment leaves move 13.1 GB (3.92 ms). The arithmetic is longer:
// ~140 SASS instructions a parameter on the common path (the update
// with two correctly rounded square roots and a division, two
// requantizations, three Philox streams: ~30 of them), counted by
// chip_smoke.py, take ~5.5 ms at 132 SMs x 4 warp instructions a clock:
// bound by its OPERATIONS on the card, though not on the data sheet's
// f32 rate. So loads have to overlap with arithmetic across resident
// blocks, and no value may be read twice.
//
// The leaf table. The wrapper (ops/fused_adamw.py AdamW8Leaves) lays out
// the p, m and v part once, writes the gradients' addresses and the
// step's keys a call, and copies it from pinned host memory on the
// launch's stream. int64 words: begin[0 .. L] (leaf l's first block in
// the launch; begin[L] is the grid), then L entries of 10 words: the p,
// g, m code, m scale, v code and v scale addresses, R, C, the rows a
// block takes (1, or 8192 / C for C = 2048 or 4096), the Philox key.
//
// Design. A block of 256 threads takes whole rows (the scales are per
// row): 8192 elements, 4 rows at C = 2048, 2 at C = 4096, else one row,
// so the per-block work (the leaf search, the
// reduction, the scales) is spread over as many elements at C = 2048 as
// at 8192. It finds its leaf by a binary search of begin[] (uniform
// across the block, so every load is a broadcast; the table stays in
// L1). A thread step is 8 consecutive elements from a multiple of 8 of
// the row: one 16-byte load of bf16 p (two of f32), one of g, 8 bytes of
// each code array, and the two Philox groups e / 4, e / 4 + 1 of a
// stream, so the bits do not depend on the launch shape. A block step is
// 2048 elements, inside one row; a thread loads all its steps (up to
// kKeep = 4: 8192 elements a block) first, then updates them while the p
// stream's Philox words are drawn, writes p, and keeps m2 and sqrt(v2)
// in registers (64 floats; nothing of a row in shared memory). The row
// maxima (order-free) come from warp shuffles and one barrier; then each
// code is floor(x / scale + u) with the quotient from the new scale's
// reciprocal, refined once a step (common.cuh ScaleDiv), and the clip
// and floor in one saturating conversion; 8 codes of each array a
// store. Two rare cases go through a loop after the kept steps that
// computes m2 and sqrt(v2) again from g and the old codes and scales (no
// store has touched them yet; the new scales are written after a last
// barrier): the steps past kKeep of a row longer than 8192 (pass 1 wrote
// their p), and a kept step with a value out of the fast division's
// range, whose codes are then cast with __fdiv_rn. Every other f32
// operation is an explicitly rounded intrinsic (the update's num / den a
// correctly rounded division), so nvcc contracts nothing into an FMA and
// the result is the same bits as the plain version's op-by-op arithmetic
// in the same order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStep = 8;                        // elements a thread step
constexpr int kBlockStep = kThreads * kStep;    // 2048
constexpr int kKeep = 4;                        // block steps in registers
static_assert(kKeep == 4, "the row reduction takes 1, 2 or 4 rows a block");
constexpr int kEntryWords = 10;

using ptt::Pack8;
using ptt::ScaleDiv;

// The step's f32 scalars, the same for every element of the launch.
struct Hyper {
  float scale, inv_bc1, inv_bc2, lr_t, decay, b1, omb1, b2, omb2, eps;
};

// One thread step's inputs.
template <typename TP, typename TG>
struct Step {
  Pack8<TP> p;
  Pack8<TG> g;
  uint2 mc, vc;     // 8 m codes, 8 sqrt(v) codes
};

template <typename T>
__device__ __forceinline__ void load8(Pack8<T>& out, const T* src) {
#pragma unroll
  for (int k = 0; k < Pack8<T>::kWords; ++k) {
    out.w[k] = *reinterpret_cast<const uint4*>(src + k * 8 / Pack8<T>::kWords);
  }
}

// Code j of 8 packed codes, as a float.
__device__ __forceinline__ float code(uint2 c, int j) {
  const uint32_t w = j < 4 ? c.x : c.y;
  return static_cast<float>(static_cast<int8_t>(w >> (8 * (j % 4))));
}

// m2 and v2 of one element from its gradient, its old codes and the
// row's old scales.
__device__ __forceinline__ float2 moments(float g, float mc, float vc,
                                          float msc, float vsc,
                                          const Hyper& h) {
  const float gs = __fmul_rn(g, h.scale);
  const float m = __fmul_rn(mc, msc);
  const float vsq = __fmul_rn(vc, vsc);
  const float v = __fmul_rn(vsq, vsq);
  return make_float2(
      __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(gs, h.omb1)),
      __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(gs, h.omb2), gs)));
}

// Pass 1 of a thread step at flat element e: the new p (written), and
// m2, sqrt(v2) and their running maxima.
template <typename TP, typename TG, bool SR>
__device__ __forceinline__ void update_step(Step<TP, TG>& st, TP* p,
                                            long long e, uint32_t key,
                                            float msc, float vsc,
                                            const Hyper& h, float (&m2)[8],
                                            float (&s2)[8], float& m_max,
                                            float& s_max) {
  uint32_t word[8];
  if (SR) {
    const uint4 w0 = ptt::philox_group(e >> 2, 0u, key, 0u);
    const uint4 w1 = ptt::philox_group((e >> 2) + 1, 0u, key, 0u);
    word[0] = w0.x; word[1] = w0.y; word[2] = w0.z; word[3] = w0.w;
    word[4] = w1.x; word[5] = w1.y; word[6] = w1.z; word[7] = w1.w;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 mv = moments(st.g.get(j), code(st.mc, j), code(st.vc, j),
                              msc, vsc, h);
    const float num = __fmul_rn(__fmul_rn(mv.x, h.inv_bc1), h.lr_t);
    const float den =
        __fadd_rn(__fsqrt_rn(__fmul_rn(mv.y, h.inv_bc2)), h.eps);
    const float p2 = __fsub_rn(__fmul_rn(st.p.get(j), h.decay),
                               __fdiv_rn(num, den));
    if (SR) {
      const uint32_t u = __float_as_uint(p2);
      const uint32_t y = isfinite(p2) ? u + (word[j] & 0xFFFFu) : u;
      reinterpret_cast<unsigned short*>(st.p.w)[j] =
          static_cast<unsigned short>(y >> 16);
    } else {
      ptt::put(st.p.vals() + j, p2);
    }
    m2[j] = mv.x;
    s2[j] = __fsqrt_rn(mv.y);
    m_max = fmaxf(m_max, fabsf(m2[j]));
    s_max = fmaxf(s_max, s2[j]);
  }
#pragma unroll
  for (int k = 0; k < Pack8<TP>::kWords; ++k) {
    *reinterpret_cast<uint4*>(p + e + k * 8 / Pack8<TP>::kWords) =
        st.p.w[k];
  }
}

// Pass 2 of a thread step at flat element e: the SR codes of m2 and
// sqrt(v2) at the row's new scales, 8 bytes of each array a store. The
// fast division's codes are stored only when every value is in its
// range (returns whether they were); `exact` takes __fdiv_rn instead.
template <bool kExact>
__device__ __forceinline__ bool code_step(const float (&m2)[8],
                                          const float (&s2)[8], long long e,
                                          uint32_t key, const ScaleDiv& dm,
                                          const ScaleDiv& dv,
                                          int8_t* __restrict__ mq,
                                          int8_t* __restrict__ vq) {
  const uint4 m0 = ptt::philox_group(e >> 2, 1u, key, 0u);
  const uint4 m1 = ptt::philox_group((e >> 2) + 1, 1u, key, 0u);
  const uint4 v0 = ptt::philox_group(e >> 2, 2u, key, 0u);
  const uint4 v1 = ptt::philox_group((e >> 2) + 1, 2u, key, 0u);
  const uint32_t wm[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
  const uint32_t wv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
  uint32_t zm[8], zv[8];
  bool ok = true;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float qm, qv;
    if (kExact) {
      qm = __fdiv_rn(m2[j], dm.b);
      qv = __fdiv_rn(s2[j], dv.b);
    } else {
      ok &= ptt::fast_ok(m2[j], dm) & ptt::fast_ok(s2[j], dv);
      qm = ptt::fast_quot(m2[j], dm);
      qv = ptt::fast_quot(s2[j], dv);
    }
    zm[j] = ptt::sr_code_fast(qm, ptt::uniform01(wm[j]), -127.f);
    zv[j] = ptt::sr_code_fast(qv, ptt::uniform01(wv[j]), 0.f);
  }
  if (ok) {
    *reinterpret_cast<uint2*>(mq + e) =
        make_uint2(ptt::pack4(zm[0], zm[1], zm[2], zm[3]),
                   ptt::pack4(zm[4], zm[5], zm[6], zm[7]));
    *reinterpret_cast<uint2*>(vq + e) =
        make_uint2(ptt::pack4(zv[0], zv[1], zv[2], zv[3]),
                   ptt::pack4(zv[4], zv[5], zv[6], zv[7]));
  }
  return ok;
}

// Two blocks an SM (at most 128 registers a thread) for bf16 p and g
// (the trainer's); the f32 ones spilled under that cap.
template <typename TP, typename TG, bool SR>
__global__ void __launch_bounds__(kThreads,
                                  sizeof(TP) + sizeof(TG) == 4 ? 2 : 1)
adamw8_rows_kernel(const long long* __restrict__ table, int n_leaves,
                   const float* __restrict__ sc, float lr, float wd, float b1,
                   float omb1, float b2, float omb2, float eps) {
  const long long block = blockIdx.x;
  int lo = 0, hi = n_leaves - 1;   // the last leaf whose begin <= block
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(table + mid) <= block) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const long long* leaf = table + n_leaves + 1 + kEntryWords * lo;
  TP* p = reinterpret_cast<TP*>(__ldg(leaf + 0));
  const TG* g = reinterpret_cast<const TG*>(__ldg(leaf + 1));
  int8_t* mq = reinterpret_cast<int8_t*>(__ldg(leaf + 2));
  float* ms = reinterpret_cast<float*>(__ldg(leaf + 3));
  int8_t* vq = reinterpret_cast<int8_t*>(__ldg(leaf + 4));
  float* vs = reinterpret_cast<float*>(__ldg(leaf + 5));
  const long long R = __ldg(leaf + 6);
  const int C = static_cast<int>(__ldg(leaf + 7));
  const int rpb = static_cast<int>(__ldg(leaf + 8));
  const uint32_t key = static_cast<uint32_t>(__ldg(leaf + 9));
  // rows r0 .. r0 + rpb - 1, contiguous: step k's thread t takes flat
  // element base + k * 2048 + 8 t, in row r0 + k * rpb / kKeep
  const long long r0 = (block - __ldg(table + lo)) * rpb;
  const long long base = r0 * C;
  const int span = static_cast<int>(R - r0 < rpb ? R - r0 : rpb) * C;

  Hyper h;
  h.scale = sc[0];
  h.inv_bc1 = sc[1];
  h.inv_bc2 = sc[2];
  h.lr_t = __fmul_rn(sc[3], lr);
  h.decay = __fsub_rn(1.f, __fmul_rn(h.lr_t, wd));
  h.b1 = b1;
  h.omb1 = omb1;
  h.b2 = b2;
  h.omb2 = omb2;
  h.eps = eps;
  const int t = threadIdx.x;
  auto row_of = [&](int k) { return (k * rpb) >> 2; };   // k * rpb / 4

  // pass 1: every kept step's loads first, then their updates
  Step<TP, TG> st[kKeep];
#pragma unroll
  for (int k = 0; k < kKeep; ++k) {
    const int o = k * kBlockStep + t * kStep;
    if (o < span) {
      const long long e = base + o;
      load8(st[k].p, p + e);
      load8(st[k].g, g + e);
      st[k].mc = *reinterpret_cast<const uint2*>(mq + e);
      st[k].vc = *reinterpret_cast<const uint2*>(vq + e);
    }
  }
  float m2[kKeep][kStep], s2[kKeep][kStep];
  float m_max[kKeep] = {}, s_max[kKeep] = {};    // by step
#pragma unroll
  for (int k = 0; k < kKeep; ++k) {
    const int o = k * kBlockStep + t * kStep;
    if (o < span) {
      const long long r = r0 + row_of(k);
      update_step<TP, TG, SR>(st[k], p, base + o, key, ms[r], vs[r], h,
                              m2[k], s2[k], m_max[k], s_max[k]);
    }
  }
  // steps past kKeep (one row of C > 8192): p and the maxima now, the
  // codes after
#pragma unroll 1
  for (int o = kKeep * kBlockStep + t * kStep; o < span; o += kBlockStep) {
    const long long e = base + o;
    Step<TP, TG> sx;
    load8(sx.p, p + e);
    load8(sx.g, g + e);
    sx.mc = *reinterpret_cast<const uint2*>(mq + e);
    sx.vc = *reinterpret_cast<const uint2*>(vq + e);
    float m2x[kStep], s2x[kStep];
    update_step<TP, TG, SR>(sx, p, e, key, ms[r0], vs[r0], h, m2x, s2x,
                            m_max[0], s_max[0]);
  }

  // the rows' maxima (slot j: row r0 + j): each slot its row's steps,
  // then the warp by shuffles, then the warps through shared memory
  if (rpb == 1) {
#pragma unroll
    for (int k = 1; k < kKeep; ++k) {
      m_max[0] = fmaxf(m_max[0], m_max[k]);
      s_max[0] = fmaxf(s_max[0], s_max[k]);
    }
  } else if (rpb == 2) {
    m_max[0] = fmaxf(m_max[0], m_max[1]);
    s_max[0] = fmaxf(s_max[0], s_max[1]);
    m_max[1] = fmaxf(m_max[2], m_max[3]);
    s_max[1] = fmaxf(s_max[2], s_max[3]);
  }
  __shared__ float2 warp_max[kKeep][kThreads / 32];
#pragma unroll
  for (int j = 0; j < kKeep; ++j) {
    if (j < rpb) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        m_max[j] = fmaxf(m_max[j], __shfl_xor_sync(~0u, m_max[j], o));
        s_max[j] = fmaxf(s_max[j], __shfl_xor_sync(~0u, s_max[j], o));
      }
      if (t % 32 == 0) warp_max[j][t / 32] = make_float2(m_max[j], s_max[j]);
    }
  }
  __syncthreads();
  float m_new[kKeep], v_new[kKeep];              // by slot
#pragma unroll
  for (int j = 0; j < kKeep; ++j) {
    if (j < rpb) {
      float2 mx = warp_max[j][0];
#pragma unroll
      for (int w = 1; w < kThreads / 32; ++w) {
        mx.x = fmaxf(mx.x, warp_max[j][w].x);
        mx.y = fmaxf(mx.y, warp_max[j][w].y);
      }
      m_new[j] = ptt::int8_scale(mx.x);
      v_new[j] = ptt::int8_scale(mx.y);
    }
  }
  // slot j's value of a (j < kKeep), without indexing registers
  auto pick = [&](const float (&a)[kKeep], int j) {
    return j == 0 ? a[0] : j == 1 ? a[1] : j == 2 ? a[2] : a[3];
  };

  // pass 2: the codes of the kept steps, each row's divisions set up at
  // its first step (step k is row k * rpb / 4's first when k * rpb % 4
  // is 0)
  uint32_t redo = 0;      // kept steps with a value out of the fast range
  ScaleDiv dm = ptt::scale_div(m_new[0]), dv = ptt::scale_div(v_new[0]);
#pragma unroll
  for (int k = 0; k < kKeep; ++k) {
    if (k > 0 && rpb > 1 && (k * rpb) % kKeep == 0) {
      const int j = rpb == 2 ? k / 2 : k;
      dm = ptt::scale_div(pick(m_new, j));
      dv = ptt::scale_div(pick(v_new, j));
    }
    const int o = k * kBlockStep + t * kStep;
    if (o < span &&
        !code_step<false>(m2[k], s2[k], base + o, key, dm, dv, mq, vq)) {
      redo |= 1u << k;
    }
  }
  // and of the steps past kKeep (C > 8192) and the kept steps in `redo`
  // (rare): m2 and sqrt(v2) again from g and the old codes and scales,
  // which no store has touched yet, then __fdiv_rn where the fast path
  // fails
#pragma unroll 1
  for (int k = redo ? __ffs(redo) - 1 : kKeep;
       k * kBlockStep + t * kStep < span; ++k) {
    if (k < kKeep && !(redo >> k & 1u)) continue;
    const long long e = base + k * kBlockStep + t * kStep;
    const int j = k < kKeep ? row_of(k) : 0;
    Pack8<TG> gx;
    load8(gx, g + e);
    const uint2 mc = *reinterpret_cast<const uint2*>(mq + e);
    const uint2 vc = *reinterpret_cast<const uint2*>(vq + e);
    float m2x[kStep], s2x[kStep];
#pragma unroll
    for (int i = 0; i < kStep; ++i) {
      const float2 mv = moments(gx.get(i), code(mc, i), code(vc, i),
                                ms[r0 + j], vs[r0 + j], h);
      m2x[i] = mv.x;
      s2x[i] = __fsqrt_rn(mv.y);
    }
    const ScaleDiv dmj = ptt::scale_div(pick(m_new, j));
    const ScaleDiv dvj = ptt::scale_div(pick(v_new, j));
    if (!code_step<false>(m2x, s2x, e, key, dmj, dvj, mq, vq)) {
      code_step<true>(m2x, s2x, e, key, dmj, dvj, mq, vq);
    }
  }
  // every thread has read the old scales: the new ones
  __syncthreads();
  if (t < rpb && r0 + t < R) {
    ms[r0 + t] = pick(m_new, t);
    vs[r0 + t] = pick(v_new, t);
  }
}

template <typename TP, typename TG, bool SR>
cudaError_t launch(const long long* table, int n_leaves, long long blocks,
                   const float* sc, float lr, float wd, float b1, float omb1,
                   float b2, float omb2, float eps, cudaStream_t stream) {
  adamw8_rows_kernel<TP, TG, SR>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
          table, n_leaves, sc, lr, wd, b1, omb1, b2, omb2, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements a block takes: kKeep block steps of 2048. The wrapper gives a
// leaf of C = 2048 or 4096 dividing it that many elements' rows a
// block, and any other leaf one row a block.
long long ptt_fused_adamw8_block_elements() { return kKeep * kBlockStep; }

// Dtype codes: 0 = float32, 1 = bfloat16 (p and g, the same for every
// leaf of the table); stoch_round needs a bfloat16 p. `table`: device
// int64 words as the header says, for n_leaves >= 1 leaves of R >= 1
// rows, begin[n_leaves] = blocks (ceil(R / rows a block) a leaf; rows a
// block is 1, or 8192 / C with C = 2048 or 4096); each leaf's C % 8 ==
// 0, p and g
// 16-byte aligned, the codes 8-byte aligned, all contiguous (codes [R,
// C] int8, scales [R] f32). `sc` points at 4 device floats: clip scale,
// 1/(1-b1^t), 1/(1-b2^t), lr multiplier. Returns a cudaError_t (0 =
// success).
int ptt_fused_adamw8_leaves(const void* table, int n_leaves,
                            long long blocks, const float* sc, int p_dtype,
                            int g_dtype, float lr, float wd, float b1,
                            float omb1, float b2, float omb2, float eps,
                            int stoch_round, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_leaves < 1 || blocks < 1) return cudaSuccess;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  if (stoch_round && p_dtype != 1) return cudaErrorInvalidValue;
  const long long* t = static_cast<const long long*>(table);
#define PTT_ADAMW8_CASE(PC, GC, SR, TP, TG)                                \
  if (p_dtype == PC && g_dtype == GC && (stoch_round != 0) == SR) {      \
    return launch<TP, TG, SR>(t, n_leaves, blocks, sc, lr, wd, b1, omb1, \
                              b2, omb2, eps, s);                         \
  }
  PTT_ADAMW8_CASE(0, 0, false, float, float)
  PTT_ADAMW8_CASE(0, 1, false, float, __nv_bfloat16)
  PTT_ADAMW8_CASE(1, 0, false, __nv_bfloat16, float)
  PTT_ADAMW8_CASE(1, 0, true, __nv_bfloat16, float)
  PTT_ADAMW8_CASE(1, 1, false, __nv_bfloat16, __nv_bfloat16)
  PTT_ADAMW8_CASE(1, 1, true, __nv_bfloat16, __nv_bfloat16)
#undef PTT_ADAMW8_CASE
  return cudaErrorInvalidValue;
}

const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
