// Fused AdamW for Hopper (sm_90a): one in-place pass over a parameter
// leaf's p, g, m, v with f32 update math, decoupled weight decay, bias
// correction, the global grad-clip scale, an lr multiplier, and
// optionally exact stochastic rounding of the new p to bf16.
//
// Replaces: paddle_tpu/ops/fused_adamw.py `_kernel` (:42), the
// pallas_call of `fused_adamw_update` (:281). The TPU kernel draws its
// rounding noise from the core's PRNG (`pltpu.prng_seed(seed +
// leaf_id*1000003, tile)`); here it is Philox4x32-10, keyed by
// (seed + leaf_id*1000003 mod 2^32, 0) with the counter (e / 4, 0, 0)
// for flat element e, which takes word e % 4. So the noise depends on
// (step, leaf, element), not on the launch shape, and the plain PyTorch
// version (ops/fused_adamw.py) reproduces it bit for bit.
//
// Bound on an H100 SXM (3.35 TB/s): 14 bytes per parameter with bf16
// p, g, m, v (read four, write three), no matmul: bound by BYTES; a
// 2048 x 8192 leaf moves 235 MB (70 us), the GPT-1.3B model ~18 GB
// (5.5 ms) per step.
//
// Design: each thread takes 4 consecutive elements (one Philox call
// gives their 4 words) in a grid-stride loop. Every f32 operation is an
// explicitly rounded intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn), so nvcc contracts nothing into an FMA and the result is
// the same bits as PyTorch's op-by-op f32 arithmetic in the plain
// version, in the same order. SR: add the low 16 bits of the word to
// the f32 bits of the new p and keep the top 16 (non-finite values
// untouched). One launch per leaf; a multi-tensor launch is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

using ptt::put;
using ptt::to_f32;

template <typename TP, typename TG, typename TM, bool SR>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(TP* __restrict__ p, const TG* __restrict__ g,
             TM* __restrict__ m, TM* __restrict__ v,
             const float* __restrict__ sc, long long n, float lr, float wd,
             float b1, float omb1, float b2, float omb2, float eps,
             uint32_t key) {
  const float scale = sc[0];
  const float inv_bc1 = sc[1];
  const float inv_bc2 = sc[2];
  const float lr_t = __fmul_rn(sc[3], lr);
  const float decay = __fsub_rn(1.f, __fmul_rn(lr_t, wd));
  const long long groups = (n + 3) / 4;
  for (long long grp = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       grp < groups; grp += (long long)gridDim.x * blockDim.x) {
    uint4 bits = make_uint4(0u, 0u, 0u, 0u);
    if (SR) {
      bits = ptt::philox_group(grp, 0u, key, 0u);
    }
    const uint32_t word[4] = {bits.x, bits.y, bits.z, bits.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long e = grp * 4 + j;
      if (e >= n) break;
      const float gs = __fmul_rn(to_f32(g[e]), scale);
      const float m2 = __fadd_rn(__fmul_rn(to_f32(m[e]), b1),
                                 __fmul_rn(gs, omb1));
      const float v2 = __fadd_rn(__fmul_rn(to_f32(v[e]), b2),
                                 __fmul_rn(__fmul_rn(gs, omb2), gs));
      const float num = __fmul_rn(__fmul_rn(m2, inv_bc1), lr_t);
      const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v2, inv_bc2)), eps);
      const float p2 = __fsub_rn(__fmul_rn(to_f32(p[e]), decay),
                                 __fdiv_rn(num, den));
      if (SR) {
        const uint32_t u = __float_as_uint(p2);
        const uint32_t y = isfinite(p2) ? u + (word[j] & 0xFFFFu) : u;
        __nv_bfloat16_raw raw;
        raw.x = static_cast<unsigned short>(y >> 16);
        reinterpret_cast<__nv_bfloat16_raw*>(p)[e] = raw;
      } else {
        put(p + e, p2);
      }
      put(m + e, m2);
      put(v + e, v2);
    }
  }
}

template <typename TP, typename TG, typename TM, bool SR>
cudaError_t launch(void* p, const void* g, void* m, void* v,
                   const float* sc, long long n, float lr, float wd,
                   float b1, float omb1, float b2, float omb2, float eps,
                   uint32_t key, cudaStream_t stream) {
  const long long groups = (n + 3) / 4;
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond this
  adamw_kernel<TP, TG, TM, SR><<<static_cast<int>(blocks), kThreads, 0,
                                 stream>>>(
      static_cast<TP*>(p), static_cast<const TG*>(g), static_cast<TM*>(m),
      static_cast<TM*>(v), sc, n, lr, wd, b1, omb1, b2, omb2, eps, key);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dtype codes: 0 = float32, 1 = bfloat16 (p, g, and m/v, which share
// one). stoch_round needs a bfloat16 p. `sc` points at 4 device floats:
// clip scale, 1/(1-b1^t), 1/(1-b2^t), lr multiplier. Returns a
// cudaError_t (0 = success).
int ptt_fused_adamw(void* p, const void* g, void* m, void* v,
                    const float* sc, long long n, int p_dtype, int g_dtype,
                    int mv_dtype, float lr, float wd, float b1, float omb1,
                    float b2, float omb2, float eps, unsigned int key,
                    int stoch_round, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1) return cudaSuccess;
  if (stoch_round && p_dtype != 1) return cudaErrorInvalidValue;
#define PTT_ADAMW_CASE(PC, GC, MC, TP, TG, TM)                              \
  if (p_dtype == PC && g_dtype == GC && mv_dtype == MC) {                 \
    return stoch_round                                                    \
        ? launch<TP, TG, TM, true>(p, g, m, v, sc, n, lr, wd, b1, omb1,   \
                                   b2, omb2, eps, key, s)                 \
        : launch<TP, TG, TM, false>(p, g, m, v, sc, n, lr, wd, b1, omb1,  \
                                    b2, omb2, eps, key, s);               \
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
