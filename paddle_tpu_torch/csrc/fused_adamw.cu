// Fused AdamW for Hopper (sm_90a): one in-place pass over a LIST of
// parameter leaves' p, g, m, v in one launch, with f32 update math,
// decoupled weight decay, bias correction, the global grad-clip scale,
// an lr multiplier, and optionally exact stochastic rounding of the new
// p to bf16.
//
// Replaces: paddle_tpu/ops/fused_adamw.py `_kernel` (:42), the
// pallas_call of `fused_adamw_update` (:281), which the reference calls
// once per leaf; here one launch takes every leaf of one dtype
// combination, and the per-leaf entry is that launch with a list of one.
// The TPU kernel draws its rounding noise from the core's PRNG
// (`pltpu.prng_seed(seed + leaf_id*1000003, tile)`); here it is
// Philox4x32-10, keyed by (seed + leaf_id*1000003 mod 2^32, 0) with the
// counter (e / 4, 0, 0) for flat element e of the leaf, which takes word
// e % 4. So the noise depends on (step, leaf, element), not on the
// launch shape or the list, and the plain PyTorch version
// (ops/fused_adamw.py) reproduces it bit for bit.
//
// Bound on an H100 SXM (3.35 TB/s): 14 bytes per parameter with bf16
// p, g, m, v (read four, write three), no matmul: bound by BYTES; a
// 2048 x 8192 leaf moves 235 MB (70 us), the GPT-1.3B model ~18 GB
// (5.5 ms) per step.
//
// The leaf table. The wrapper writes it per call into a small device
// buffer, copied from pinned host memory on the launch's stream (the
// gradients are new tensors every step, so it cannot be built once; a
// buffer, unlike kernel parameters, takes a list of any length in one
// launch). The host lays out p, m and v's part once (ops/fused_adamw.py
// AdamWLeaves) and writes the gradients' addresses and the keys a call. int64 words: begin[0 .. L] (leaf l's first chunk; begin[L]
// is the grid), then L entries of 8 words: the p, g, m, v addresses, n,
// the Philox key, two unused.
//
// Design. The work is cut into chunks of kChunk = 256 threads x 8
// elements x kUnroll steps of one leaf; block b takes chunk b and finds
// its leaf by a binary search of begin[] (uniform across the block, so
// every thread's load is one broadcast; the table stays in L1). So a
// 2048-element bias is one block and `wte` 25,152: every SM is busy
// whatever the leaf sizes, and 194 small leaves cost one launch. A
// thread step takes 8 consecutive elements starting at a multiple of 8
// of its leaf: 16 bytes of each 16-bit tensor (two of an f32 one) and
// the two Philox groups e / 4, e / 4 + 1. A thread first loads all its
// kUnroll steps' p, g, m and v, then computes and stores them, so
// 4 x kUnroll x 16 bytes a thread are in flight. A leaf whose four base
// addresses are not all 16-byte aligned (a view), and the last n % 8
// elements of any leaf, take the same steps with scalar loads and
// stores guarded by n (a scalar head would shift the steps off the
// Philox groups): the same arithmetic, the same bits. Every f32
// operation is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn), so nvcc contracts nothing into an FMA and the
// result is the same bits as PyTorch's op-by-op f32 arithmetic in the
// plain version, in the same order. SR: add the low 16 bits of the word
// to the f32 bits of the new p and keep the top 16 (non-finite values
// untouched).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;
constexpr long long kChunk = kThreads * 8LL * kUnroll;
constexpr int kEntryWords = 8;

using ptt::Pack8;
using ptt::put;

// Elements e .. e + 7 of src: one or two 16-byte loads when `vec` (all 8
// inside the leaf, the base 16-byte aligned), else element by element,
// zeros past n.
template <typename T>
__device__ __forceinline__ void load8(Pack8<T>& out, const T* src,
                                      long long e, long long n, bool vec) {
  if (vec) {
#pragma unroll
    for (int k = 0; k < Pack8<T>::kWords; ++k) {
      out.w[k] = *reinterpret_cast<const uint4*>(src + e + k * 8 / Pack8<T>::kWords);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (e + j < n) {
        out.vals()[j] = src[e + j];
      } else {
        put(out.vals() + j, 0.f);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* dst, Pack8<T>& in, long long e,
                                       long long n, bool vec) {
  if (vec) {
#pragma unroll
    for (int k = 0; k < Pack8<T>::kWords; ++k) {
      *reinterpret_cast<uint4*>(dst + e + k * 8 / Pack8<T>::kWords) = in.w[k];
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (e + j < n) dst[e + j] = in.vals()[j];
    }
  }
}

template <typename TP, typename TG, typename TM, bool SR>
__global__ void __launch_bounds__(kThreads)
adamw_leaves_kernel(const long long* __restrict__ table, int n_leaves,
                    const float* __restrict__ sc, float lr, float wd,
                    float b1, float omb1, float b2, float omb2, float eps) {
  const long long chunk = blockIdx.x;
  int lo = 0, hi = n_leaves - 1;   // the last leaf whose begin <= chunk
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(table + mid) <= chunk) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const long long* leaf = table + n_leaves + 1 + kEntryWords * lo;
  TP* p = reinterpret_cast<TP*>(__ldg(leaf + 0));
  const TG* g = reinterpret_cast<const TG*>(__ldg(leaf + 1));
  TM* m = reinterpret_cast<TM*>(__ldg(leaf + 2));
  TM* v = reinterpret_cast<TM*>(__ldg(leaf + 3));
  const long long n = __ldg(leaf + 4);
  const uint32_t key = static_cast<uint32_t>(__ldg(leaf + 5));
  const bool aligned = ((__ldg(leaf + 0) | __ldg(leaf + 1) | __ldg(leaf + 2)
                         | __ldg(leaf + 3)) & 15) == 0;
  const long long base = (chunk - __ldg(table + lo)) * kChunk;

  const float scale = sc[0];
  const float inv_bc1 = sc[1];
  const float inv_bc2 = sc[2];
  const float lr_t = __fmul_rn(sc[3], lr);
  const float decay = __fsub_rn(1.f, __fmul_rn(lr_t, wd));

  Pack8<TP> ps[kUnroll];
  Pack8<TG> gs[kUnroll];
  Pack8<TM> ms[kUnroll], vs[kUnroll];
  long long es[kUnroll];
  bool vec[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    es[u] = base + (static_cast<long long>(u) * kThreads + threadIdx.x) * 8;
    vec[u] = aligned && es[u] + 8 <= n;
    if (es[u] < n) {
      load8(ps[u], p, es[u], n, vec[u]);
      load8(gs[u], g, es[u], n, vec[u]);
      load8(ms[u], m, es[u], n, vec[u]);
      load8(vs[u], v, es[u], n, vec[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long e = es[u];
    if (e >= n) continue;
    uint32_t word[8];
    if (SR) {
      const uint4 w0 = ptt::philox_group(e >> 2, 0u, key, 0u);
      const uint4 w1 = ptt::philox_group((e >> 2) + 1, 0u, key, 0u);
      word[0] = w0.x; word[1] = w0.y; word[2] = w0.z; word[3] = w0.w;
      word[4] = w1.x; word[5] = w1.y; word[6] = w1.z; word[7] = w1.w;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float gsc = __fmul_rn(gs[u].get(j), scale);
      const float m2 = __fadd_rn(__fmul_rn(ms[u].get(j), b1),
                                 __fmul_rn(gsc, omb1));
      const float v2 = __fadd_rn(__fmul_rn(vs[u].get(j), b2),
                                 __fmul_rn(__fmul_rn(gsc, omb2), gsc));
      const float num = __fmul_rn(__fmul_rn(m2, inv_bc1), lr_t);
      const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v2, inv_bc2)), eps);
      const float p2 = __fsub_rn(__fmul_rn(ps[u].get(j), decay),
                                 __fdiv_rn(num, den));
      if (SR) {
        const uint32_t bits = __float_as_uint(p2);
        const uint32_t y = isfinite(p2) ? bits + (word[j] & 0xFFFFu) : bits;
        reinterpret_cast<unsigned short*>(ps[u].w)[j] =
            static_cast<unsigned short>(y >> 16);
      } else {
        put(ps[u].vals() + j, p2);
      }
      put(ms[u].vals() + j, m2);
      put(vs[u].vals() + j, v2);
    }
    store8(p, ps[u], e, n, vec[u]);
    store8(m, ms[u], e, n, vec[u]);
    store8(v, vs[u], e, n, vec[u]);
  }
}

template <typename TP, typename TG, typename TM, bool SR>
cudaError_t launch(const long long* table, int n_leaves, long long chunks,
                   const float* sc, float lr, float wd, float b1, float omb1,
                   float b2, float omb2, float eps, cudaStream_t stream) {
  adamw_leaves_kernel<TP, TG, TM, SR>
      <<<static_cast<unsigned int>(chunks), kThreads, 0, stream>>>(
          table, n_leaves, sc, lr, wd, b1, omb1, b2, omb2, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements a chunk (a block) takes; the wrapper's begin[] counts chunks.
long long ptt_fused_adamw_chunk() { return kChunk; }

// Dtype codes: 0 = float32, 1 = bfloat16 (p, g, and m/v, which share
// one), the same for every leaf of the table. stoch_round needs a
// bfloat16 p. `table`: device int64 words as the header says, for
// n_leaves >= 1 leaves of n >= 1 elements, begin[n_leaves] = chunks.
// `sc` points at 4 device floats: clip scale, 1/(1-b1^t), 1/(1-b2^t),
// lr multiplier. Returns a cudaError_t (0 = success).
int ptt_fused_adamw_leaves(const void* table, int n_leaves, long long chunks,
                           const float* sc, int p_dtype, int g_dtype,
                           int mv_dtype, float lr, float wd, float b1,
                           float omb1, float b2, float omb2, float eps,
                           int stoch_round, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_leaves < 1 || chunks < 1) return cudaSuccess;
  if (chunks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  if (stoch_round && p_dtype != 1) return cudaErrorInvalidValue;
  const long long* t = static_cast<const long long*>(table);
#define PTT_ADAMW_CASE(PC, GC, MC, TP, TG, TM)                              \
  if (p_dtype == PC && g_dtype == GC && mv_dtype == MC) {                 \
    return stoch_round                                                    \
        ? launch<TP, TG, TM, true>(t, n_leaves, chunks, sc, lr, wd, b1,   \
                                   omb1, b2, omb2, eps, s)                \
        : launch<TP, TG, TM, false>(t, n_leaves, chunks, sc, lr, wd, b1,  \
                                    omb1, b2, omb2, eps, s);              \
  }
  PTT_ADAMW_CASE(0, 0, 0, float, float, float)
  PTT_ADAMW_CASE(0, 0, 1, float, float, __nv_bfloat16)
  PTT_ADAMW_CASE(0, 1, 0, float, __nv_bfloat16, float)
  PTT_ADAMW_CASE(0, 1, 1, float, __nv_bfloat16, __nv_bfloat16)
  PTT_ADAMW_CASE(1, 0, 0, __nv_bfloat16, float, float)
  PTT_ADAMW_CASE(1, 0, 1, __nv_bfloat16, float, __nv_bfloat16)
  PTT_ADAMW_CASE(1, 1, 0, __nv_bfloat16, __nv_bfloat16, float)
  PTT_ADAMW_CASE(1, 1, 1, __nv_bfloat16, __nv_bfloat16, __nv_bfloat16)
#undef PTT_ADAMW_CASE
  return cudaErrorInvalidValue;
}

const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
