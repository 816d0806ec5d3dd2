// Fused AdamW with int8 moments for Hopper (sm_90a): one in-place pass
// over a [R, C] leaf's p, g, the int8 codes of m and of sqrt(v), and
// their per-row f32 scales. f32 update math, decoupled weight decay,
// bias correction, the global grad-clip scale and an lr multiplier as in
// fused_adamw.cu; then m and sqrt(v) are requantized per row with
// stochastic rounding (m codes in [-127, 127], sqrt(v) codes in
// [0, 127]), and the new p optionally takes exact SR to bf16.
//
// Replaces: paddle_tpu/ops/fused_adamw.py `_kernel8` (:115), the
// pallas_call of `fused_adamw_update8` (:222). The TPU kernel draws all
// its noise from one core PRNG stream per row block; here each use has
// its own Philox4x32-10 stream (philox.cuh) under the key
// (seed + leaf_id * 1000003 mod 2^32, 0), with the counter
// (e / 4, stream, 0) for flat element e = r * C + c: stream 0 for p, so
// p's bits equal fused_adamw.cu's for the same step and leaf, 1 for the
// m codes and 2 for the sqrt(v) codes. The plain PyTorch version
// (ops/fused_adamw.py) draws the same words.
//
// Bound on an H100 SXM (3.35 TB/s): per parameter read p, g (2 + 2
// bytes in bf16) and the two codes (1 + 1), write p and the two codes
// (2 + 1 + 1): 10 bytes, plus 16 bytes of scales per row; no matmul:
// bound by BYTES. The 50304 x 2048 `wte` moves 1.03 GB (0.31 ms).
//
// Design: one block per row (the reference's full-row blocks; nothing
// carries across blocks). Pass 1 reads the row once, in groups of 4
// elements per thread (one Philox call gives the 4 words of p's SR),
// writes the new p, and keeps m2 and sqrt(v2) in shared memory (2 * 4 * C
// bytes: 64 KB at C = 8192) while it takes their row maxima. A block
// reduction gives the new scales; pass 2 writes the codes from shared
// memory. Every f32 operation is an explicitly rounded intrinsic, so
// the bits equal the plain version's op-by-op arithmetic.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

using ptt::put;
using ptt::to_f32;

template <typename TP, typename TG, bool SR>
__global__ void __launch_bounds__(kThreads)
adamw8_kernel(TP* __restrict__ p, const TG* __restrict__ g,
              signed char* __restrict__ mq, float* __restrict__ ms,
              signed char* __restrict__ vq, float* __restrict__ vs,
              const float* __restrict__ sc, int C, float lr, float wd,
              float b1, float omb1, float b2, float omb2, float eps,
              uint32_t key) {
  extern __shared__ float buf[];        // m2 [C], then sqrt(v2) [C]
  float* m2s = buf;
  float* s2s = buf + C;
  const float scale = sc[0];
  const float inv_bc1 = sc[1];
  const float inv_bc2 = sc[2];
  const float lr_t = __fmul_rn(sc[3], lr);
  const float decay = __fsub_rn(1.f, __fmul_rn(lr_t, wd));
  const long long r = blockIdx.x;
  const long long base = r * C;
  const float m_scale = ms[r];
  const float v_scale = vs[r];
  float m_max = 0.f, s_max = 0.f;
  for (int c = threadIdx.x * 4; c < C; c += kThreads * 4) {
    const long long e = base + c;
    uint4 bits = make_uint4(0u, 0u, 0u, 0u);
    if (SR) bits = ptt::philox_group(e / 4, 0u, key, 0u);
    const uint32_t word[4] = {bits.x, bits.y, bits.z, bits.w};
    const char4 mc = *reinterpret_cast<const char4*>(mq + e);
    const char4 vc = *reinterpret_cast<const char4*>(vq + e);
    const signed char mcode[4] = {mc.x, mc.y, mc.z, mc.w};
    const signed char vcode[4] = {vc.x, vc.y, vc.z, vc.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float gs = __fmul_rn(to_f32(g[e + j]), scale);
      const float m = __fmul_rn(static_cast<float>(mcode[j]), m_scale);
      const float vsq = __fmul_rn(static_cast<float>(vcode[j]), v_scale);
      const float v = __fmul_rn(vsq, vsq);
      const float m2 = __fadd_rn(__fmul_rn(m, b1), __fmul_rn(gs, omb1));
      const float v2 = __fadd_rn(__fmul_rn(v, b2),
                                 __fmul_rn(__fmul_rn(gs, omb2), gs));
      const float num = __fmul_rn(__fmul_rn(m2, inv_bc1), lr_t);
      const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v2, inv_bc2)), eps);
      const float p2 = __fsub_rn(__fmul_rn(to_f32(p[e + j]), decay),
                                 __fdiv_rn(num, den));
      if (SR) {
        const uint32_t u = __float_as_uint(p2);
        const uint32_t y = isfinite(p2) ? u + (word[j] & 0xFFFFu) : u;
        __nv_bfloat16_raw raw;
        raw.x = static_cast<unsigned short>(y >> 16);
        reinterpret_cast<__nv_bfloat16_raw*>(p)[e + j] = raw;
      } else {
        put(p + e + j, p2);
      }
      const float s2 = __fsqrt_rn(v2);
      m2s[c + j] = m2;
      s2s[c + j] = s2;
      m_max = fmaxf(m_max, fabsf(m2));
      s_max = fmaxf(s_max, s2);
    }
  }
  // block_max syncs: every thread's m2s, s2s are written
  const float m_new = ptt::int8_scale(ptt::block_max<kThreads>(m_max));
  const float v_new = ptt::int8_scale(ptt::block_max<kThreads>(s_max));
  for (int c = threadIdx.x * 4; c < C; c += kThreads * 4) {
    const long long e = base + c;
    const uint4 bm = ptt::philox_group(e / 4, 1u, key, 0u);
    const uint4 bv = ptt::philox_group(e / 4, 2u, key, 0u);
    char4 mo, vo;
    mo.x = ptt::sr_code(m2s[c], m_new, bm.x, -127.f);
    mo.y = ptt::sr_code(m2s[c + 1], m_new, bm.y, -127.f);
    mo.z = ptt::sr_code(m2s[c + 2], m_new, bm.z, -127.f);
    mo.w = ptt::sr_code(m2s[c + 3], m_new, bm.w, -127.f);
    vo.x = ptt::sr_code(s2s[c], v_new, bv.x, 0.f);
    vo.y = ptt::sr_code(s2s[c + 1], v_new, bv.y, 0.f);
    vo.z = ptt::sr_code(s2s[c + 2], v_new, bv.z, 0.f);
    vo.w = ptt::sr_code(s2s[c + 3], v_new, bv.w, 0.f);
    *reinterpret_cast<char4*>(mq + e) = mo;
    *reinterpret_cast<char4*>(vq + e) = vo;
  }
  if (threadIdx.x == 0) {
    ms[r] = m_new;
    vs[r] = v_new;
  }
}

template <typename TP, typename TG, bool SR>
cudaError_t launch(void* p, const void* g, void* mq, void* ms, void* vq,
                   void* vs, const float* sc, long long R, int C, float lr,
                   float wd, float b1, float omb1, float b2, float omb2,
                   float eps, uint32_t key, cudaStream_t stream) {
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(C);
  auto kernel = adamw8_kernel<TP, TG, SR>;
  // above 48 KB (with the static block_max scratch) only after opting in
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned int>(R), kThreads, smem, stream>>>(
      static_cast<TP*>(p), static_cast<const TG*>(g),
      static_cast<signed char*>(mq), static_cast<float*>(ms),
      static_cast<signed char*>(vq), static_cast<float*>(vs), sc, C, lr, wd,
      b1, omb1, b2, omb2, eps, key);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// p, g: [R, C] (dtype codes 0 = float32, 1 = bfloat16), mq, vq: [R, C]
// int8, ms, vs: [R] f32, all contiguous; C % 4 == 0 and 8 * C bytes of
// shared memory (C <= 28672). stoch_round needs a bfloat16 p. `sc`
// points at 4 device floats: clip scale, 1/(1-b1^t), 1/(1-b2^t), lr
// multiplier. Returns a cudaError_t (0 = success).
int ptt_fused_adamw8(void* p, const void* g, void* mq, void* ms, void* vq,
                     void* vs, const float* sc, long long R, int C,
                     int p_dtype, int g_dtype, float lr, float wd, float b1,
                     float omb1, float b2, float omb2, float eps,
                     unsigned int key, int stoch_round, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R < 1 || C < 1) return cudaSuccess;
  if (C % 4 != 0 || C > 28672) return cudaErrorInvalidValue;
  if (stoch_round && p_dtype != 1) return cudaErrorInvalidValue;
#define PTT_ADAMW8_CASE(PC, GC, TP, TG)                                      \
  if (p_dtype == PC && g_dtype == GC) {                                    \
    return stoch_round                                                     \
        ? launch<TP, TG, true>(p, g, mq, ms, vq, vs, sc, R, C, lr, wd, b1, \
                               omb1, b2, omb2, eps, key, s)                \
        : launch<TP, TG, false>(p, g, mq, ms, vq, vs, sc, R, C, lr, wd,   \
                                b1, omb1, b2, omb2, eps, key, s);          \
  }
  PTT_ADAMW8_CASE(0, 0, float, float)
  PTT_ADAMW8_CASE(0, 1, float, __nv_bfloat16)
  PTT_ADAMW8_CASE(1, 0, __nv_bfloat16, float)
  PTT_ADAMW8_CASE(1, 1, __nv_bfloat16, __nv_bfloat16)
#undef PTT_ADAMW8_CASE
  return cudaErrorInvalidValue;
}

const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
