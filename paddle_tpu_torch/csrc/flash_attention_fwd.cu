// Flash-attention forward for Hopper (sm_90a): online-softmax attention
// over [B, S, H, D] tensors taken by stride, returning out (input dtype)
// and the row logsumexp lse [B, H, S] (f32).
//
// Replaces: paddle_tpu/ops/pallas_ops.py `_fa_forward` (pallas_call at
// :152, kernel `_fa_fwd_kernel` :82, `_online_update` :133) and
// `_fa_forward_qkvpacked` (pallas_call at :645), reached through
// `flash_attention_fwd` :372, `flash_attention_qkv_fused` :709 and
// nn.functional SDPA.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): the kernel
// must read q, k, v once and write out once (plus 4 bytes of lse per
// row). Serving prefill at S=512, B=1, H=16, D=128 moves ~8.4 MB
// (2.5 us) and does 4*S*(S+1)/2*D*H ~= 1.07 GFLOP of causal matmul
// (1.1 us), so at serving prompt lengths it is bound by BYTES; it turns
// operation-bound only above S ~ 1200 (causal, D=128). The GPT trainer's
// packed call (B=6, S=1024, H=16, D=128, causal) is bound by bytes too
// (30 us against 26 us of products).
//
// bf16 and f16 at every tile width, 32, 64, 96, 128, 192 and 256
// (`flash_fwd_wgmma_kernel`):
//  - one block per (q tile of BQ = 64 NWG rows, head, batch): NWG (1 or
//    2) consumer warpgroups, each owning 64 query rows, and a producer.
//    The launcher takes NWG = 2 when that still gives at least one block
//    per SM (132), else 1 (the serving shapes' small grids). With two,
//    the producer is a whole warpgroup whose registers setmaxnreg moves
//    to the consumers (40 / 232); with one, a single warp;
//  - the producer's one thread loads the q tile once and the k and v
//    tiles (BK = 128 keys; 64 at widths 192 and 256, whose O takes 96-128
//    registers a thread) into a 3-stage ring (2 at width 256) by TMA,
//    with full and empty mbarriers, so the next tiles load while the
//    consumers compute; a causal block stops at its diagonal tile, so
//    tiles above it are never loaded;
//  - S = Q K^T is `wgmma` m64nBKk16 with both operands read from the
//    swizzled shared tiles; the f32 scores stay in registers;
//  - the online softmax runs in registers: a row lies on the 4 threads of
//    a quad, so its max takes two shuffles; exp2 with log2(e) folded into
//    the scale; the row sum stays a per-thread partial until the end;
//  - P is rounded to v's dtype in registers (the TPU kernel's
//    `p.astype(v.dtype)`) and is the register A operand of the second
//    `wgmma` (m64nDPk16), V the B operand read MN-major (transposed) from
//    shared memory; the f32 accumulator O stays in registers and takes
//    the alpha rescale there;
//  - within a warpgroup, tile j's S is issued before tile j-1's PV and
//    its softmax runs while PV is on the tensor cores (the two warpgroups
//    also overlap each other);
//  - the mask (keys >= S and, causal, keys above the row: the TPU
//    kernel's -1e30) is applied only on diagonal and ragged tiles, and a
//    warpgroup skips the tiles wholly above its rows;
//  - the epilogue writes O / l in the input dtype into the strided out
//    view, only the true head_dim columns, and lse = (m + log2 l) ln 2.
// TILE SIZES DO NOT DEPEND ON S: BK (and so the order in which a row's
// keys are summed) follows the tile width only, and a tile wholly above a
// row changes none of its bits (alpha = 1, P = 0), so a row's result
// depends only on its own prefix and a bucket-padded prompt gives the
// unpadded prompt's rows bit for bit (the serving engine pads, generate()
// does not). NWG changes which block holds a row, not its arithmetic.
// head_dim: any multiple of 8 up to 256 runs at the smallest tile width
// DP >= head_dim; the tensor maps declare the true head_dim, so TMA fills
// the columns past it with zeros (they add nothing to QK^T and give zero
// output columns) and only the true width is written back; the softmax
// scale comes from the caller (1/sqrt(true head_dim)), never from DP.
//
// float32 (q, k, v and out): `flash_fwd_f32_kernel` below puts both
// products on the tensor cores as 3xTF32: each f32 operand a = hi + lo
// with hi = tf32(a) and lo = a - hi, and a b ~= lo*hi + hi*lo + hi*hi in
// f32 sums, ~2^-21 of |a b| a product where one TF32 product keeps ~2^-11
// and would not hold the reference's f32 (its interpret mode is exact
// f32) to 1e-4. wgmma takes TF32 only K-major, and P V's V is MN-major,
// so v cannot go from TMA to the tensor cores as it lands: a producer
// warpgroup loads q, k and v with plain 16-byte loads, splits each value
// and stores the halves where wgmma reads them (v transposed, its keys
// in the order the score accumulator leaves P's keys in, so P is the
// register A operand as it stands); one consumer warpgroup owns the
// block's 64 query rows. The split triples the operands' shared memory,
// so a tile is BK = 64 keys up to width 128 (32 at 192, 16 at 256), one
// buffer each for k and v; width, masks and tile skipping as above, so a
// row's bits do not follow S here either. Head_dim any multiple of 4 up
// to 256, at the next width of 32/64/96/128/192/256. Bound by the tensor
// cores: three TF32 products (495 TFLOP/s dense) for each f32 one.
// (A first design on mma.sync m16n8k8 TF32, its fragments split by each
// warp from cp.async tiles, was slower on an H100: its loads and splits,
// not its products, set its time; PERF.md has the numbers.)
//
// Inputs need a unit stride in D and 16-byte aligned rows and strides
// (the Python wrapper checks; TMA needs both). The launcher returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32_tiles.cuh"

namespace {

constexpr float kNegInf = -1e30f;

struct Strides {  // in elements: batch, sequence, head (D has stride 1)
  long long q_b, q_s, q_h;
  long long k_b, k_s, k_h;
  long long v_b, v_s, v_h;
  long long o_b, o_s, o_h;
};

// ---- bf16/f16: wgmma, a TMA ring, softmax in registers ----

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kSMs = 132;            // H100 SXM

template <int DP, int NWG>
struct FwdTiles {
  static constexpr int BQ = 64 * NWG;        // query rows per block
  // keys per tile, so the order of a row's sum, from the width alone:
  // above 128 columns the 64-key tile keeps S, P and O in registers
  static constexpr int BK = DP > 128 ? 64 : 128;
  static constexpr int STAGES = DP > 192 ? 2 : 3;   // shared memory
  static constexpr int Q_TILE = BQ * DP * 2;   // bytes
  static constexpr int KV_TILE = BK * DP * 2;
  __host__ __device__ static constexpr int k_off(int s) {
    return Q_TILE + s * 2 * KV_TILE;
  }
  __host__ __device__ static constexpr int v_off(int s) {
    return k_off(s) + KV_TILE;
  }
  static constexpr int bar_off = Q_TILE + STAGES * 2 * KV_TILE;
  static constexpr int SMEM = bar_off + 8 * (1 + 2 * STAGES) + 1024;
  // two consumer warpgroups come with a whole producer warpgroup, whose
  // registers setmaxnreg hands to them; one comes with one producer warp
  static constexpr int THREADS = 128 * NWG + (NWG == 2 ? 128 : 32);
};

constexpr int kProducerRegs = 40;    // after setmaxnreg (two consumers)
constexpr int kConsumerRegs = 232;   // 128 x 40 + 256 x 232 <= 65536

// One tile of scores in registers: scale to the log2 domain, mask (on
// diagonal and ragged tiles), take the row max over the quad, turn the
// scores into unnormalised probabilities in place, and return the row
// sums of this thread's part and the rescale factors of the old state.
template <int BK>
struct Softmax {
  float m0, m1;          // running max of rows row0 and row1, log2 domain
  float l0, l1;          // this thread's part of the row sums

  __device__ __forceinline__ void step(float (&sc)[BK / 2], int k0,
                                       bool edge, int S, int causal,
                                       int row0, int row1, int c2,
                                       float scale_log2, float& a0,
                                       float& a1) {
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = sc[4 * n + e] * scale_log2;
        float x1 = sc[4 * n + 2 + e] * scale_log2;
        if (edge) {
          const int key = k0 + 8 * n + c2 + e;
          if (key >= S || (causal && key > row0)) x0 = kNegInf;
          if (key >= S || (causal && key > row1)) x1 = kNegInf;
        }
        sc[4 * n + e] = x0;
        sc[4 * n + 2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    a0 = ptt::ex2(m0 - mx0);
    a1 = ptt::ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      sc[4 * n] = ptt::ex2(sc[4 * n] - m0);
      sc[4 * n + 1] = ptt::ex2(sc[4 * n + 1] - m0);
      sc[4 * n + 2] = ptt::ex2(sc[4 * n + 2] - m1);
      sc[4 * n + 3] = ptt::ex2(sc[4 * n + 3] - m1);
      s0 += sc[4 * n] + sc[4 * n + 1];
      s1 += sc[4 * n + 2] + sc[4 * n + 3];
    }
    l0 = l0 * a0 + s0;
    l1 = l1 * a1 + s1;
  }
};

// P (f32 in the score registers), rounded to T, as the A fragments of
// the BK / 16 k16 steps of the PV product.
template <int BK, typename T>
__device__ __forceinline__ void pack_p(const float (&sc)[BK / 2],
                                       uint32_t (&pf)[BK / 16][4]) {
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    pf[n / 2][(n % 2) * 2] = ptt::pack2<T>(sc[4 * n], sc[4 * n + 1]);
    pf[n / 2][(n % 2) * 2 + 1] = ptt::pack2<T>(sc[4 * n + 2], sc[4 * n + 3]);
  }
}

// S_j = Q K_j^T for warpgroup wg's 64 rows (one commit group's worth).
template <int DP, typename T, int NWG>
__device__ __forceinline__ void fwd_issue_s(
    float (&acc)[FwdTiles<DP, NWG>::BK / 2], uint32_t sbase, int wg, int j) {
  using C = FwdTiles<DP, NWG>;
  using P = ptt::Panels<DP>;
  const uint32_t sk = sbase + C::k_off(j % C::STAGES);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    ptt::wgmma_ss<C::BK, T>(acc, P::kmajor(sbase, C::BQ, 64 * wg, kk),
                            P::kmajor(sk, C::BK, 0, kk), kk > 0);
  }
}

// O += P_j V_j, P_j from registers, V_j read MN-major.
template <int DP, typename T, int NWG>
__device__ __forceinline__ void fwd_issue_pv(
    float (&acc)[DP / 2], const uint32_t (&p)[FwdTiles<DP, NWG>::BK / 16][4],
    uint32_t sbase, int j) {
  using C = FwdTiles<DP, NWG>;
  using P = ptt::Panels<DP>;
  const uint32_t sv = sbase + C::v_off(j % C::STAGES);
#pragma unroll
  for (int kt = 0; kt < C::BK / 16; ++kt) {
    ptt::wgmma_rs<DP, T>(acc, p[kt], P::mnmajor(sv, C::BK, 16 * kt), 1);
  }
}

template <int DP, typename T, int NWG>
__global__ void __launch_bounds__(FwdTiles<DP, NWG>::THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       T* __restrict__ out, float* __restrict__ lse, int S,
                       int H, int hd, long long o_b, long long o_s,
                       long long o_h, float scale_log2, int causal) {
  using C = FwdTiles<DP, NWG>;
  using P = ptt::Panels<DP>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = ptt::align_1024(smem_raw);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + C::bar_off);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + C::STAGES;

  const int nq = (S + C::BQ - 1) / C::BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * C::BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nk = (S + BK - 1) / BK;
  const int tiles = causal ? min((q0 + C::BQ - 1) / BK + 1, nk) : nk;

  if (threadIdx.x == 0) {
    ptt::mbar_init(bar_q, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      ptt::mbar_init(&full[s], 1);
      ptt::mbar_init(&empty[s], 4 * NWG);      // one arrival a warp
    }
    ptt::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * NWG) {              // the producer
    if constexpr (NWG == 2) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          kProducerRegs));
    }
    if (threadIdx.x == 128 * NWG) {
      ptt::mbar_arrive_tx(bar_q, C::Q_TILE);
      for (int w = 0; w < NWG; ++w) {
        for (int p = 0; p < P::NP; ++p) {
          ptt::tma_load_4d(smem + (p * C::BQ + 64 * w) * P::SWB, &tq, bar_q,
                           p * P::PW, q0 + 64 * w, h, b);
        }
      }
      for (int j = 0; j < tiles; ++j) {
        const int s = j % C::STAGES;
        ptt::mbar_wait(&empty[s], ((j / C::STAGES) & 1) ^ 1);
        ptt::mbar_arrive_tx(&full[s], 2 * C::KV_TILE);
        for (int p = 0; p < P::NP; ++p) {
          ptt::tma_load_4d(smem + C::k_off(s) + p * BK * P::SWB, &tk,
                           &full[s], p * P::PW, j * BK, h, b);
          ptt::tma_load_4d(smem + C::v_off(s) + p * BK * P::SWB, &tv,
                           &full[s], p * P::PW, j * BK, h, b);
        }
      }
    }
    return;
  }
  if constexpr (NWG == 2) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
  }

  // consumer warpgroup `wg`: query rows qw0..qw0+63; this thread holds
  // rows row0 and row1 = row0 + 8, columns 8 n + c2 + {0, 1}
  // the warpgroup index through a shuffle, so the compiler sees it (and
  // the loop bounds and branches made from it) uniform
  const int wg =
      __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 7), 0);
  const int lane = threadIdx.x & 31;
  const int c2 = (lane & 3) * 2;
  const int qw0 = q0 + 64 * wg;
  const int row0 = qw0 + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
  const int row1 = row0 + 8;
  const int wg_tiles = causal ? min((qw0 + 63) / BK + 1, nk) : nk;
  const uint32_t sbase = ptt::smem_u32(smem);

  auto edge = [&](int j) {
    return j * BK + BK > S || (causal && j * BK + BK - 1 > qw0);
  };
  auto release = [&](int j) {
    __syncwarp();
    if (lane == 0) ptt::mbar_arrive(&empty[j % C::STAGES]);
  };

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  Softmax<BK> sm{kNegInf, kNegInf, 0.f, 0.f};
  float sc[BK / 2];
  uint32_t pf[BK / 16][4];
  float a0, a1;

  // Tile 0, then for each next tile j: S_j is issued before P_{j-1} V_{j-1}
  // and its softmax runs while that product is on the tensor cores; O is
  // rescaled once P_{j-1} V_{j-1} has landed.
  ptt::mbar_wait(bar_q, 0);
  ptt::mbar_wait(&full[0], 0);
  ptt::wgmma_fence();
  fwd_issue_s<DP, T, NWG>(sc, sbase, wg, 0);
  ptt::wgmma_commit();
  ptt::wgmma_wait<0>();
  ptt::fence_regs(sc);
  sm.step(sc, 0, edge(0), S, causal, row0, row1, c2, scale_log2, a0, a1);
  pack_p<BK, T>(sc, pf);
  for (int j = 1; j < wg_tiles; ++j) {
    ptt::mbar_wait(&full[j % C::STAGES], (j / C::STAGES) & 1);
    ptt::wgmma_fence();
    fwd_issue_s<DP, T, NWG>(sc, sbase, wg, j);
    ptt::wgmma_commit();
    fwd_issue_pv<DP, T, NWG>(o, pf, sbase, j - 1);
    ptt::wgmma_commit();
    ptt::wgmma_wait<1>();               // S_j has landed
    ptt::fence_regs(sc);
    sm.step(sc, j * BK, edge(j), S, causal, row0, row1, c2, scale_log2, a0,
            a1);
    ptt::wgmma_wait<0>();               // P_{j-1} V_{j-1} has landed
    ptt::fence_regs(o);
    release(j - 1);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      o[4 * n] *= a0;
      o[4 * n + 1] *= a0;
      o[4 * n + 2] *= a1;
      o[4 * n + 3] *= a1;
    }
    pack_p<BK, T>(sc, pf);
  }
  ptt::wgmma_fence();
  fwd_issue_pv<DP, T, NWG>(o, pf, sbase, wg_tiles - 1);
  ptt::wgmma_commit();
  ptt::wgmma_wait<0>();
  ptt::fence_regs(o);
  release(wg_tiles - 1);
  for (int j = wg_tiles; j < tiles; ++j) {   // tiles wholly above my rows
    ptt::mbar_wait(&full[j % C::STAGES], (j / C::STAGES) & 1);
    release(j);
  }

  float l0 = sm.l0, l1 = sm.l1;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float ls0 = l0 == 0.f ? 1.f : l0;
  const float ls1 = l1 == 0.f ? 1.f : l1;
  T* ob = out + b * o_b + h * o_h;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = 8 * n + c2;
    if (8 * n < hd) {                  // hd is a multiple of 8
      if (row0 < S) {
        *reinterpret_cast<uint32_t*>(ob + row0 * o_s + col) =
            ptt::pack2<T>(o[4 * n] / ls0, o[4 * n + 1] / ls0);
      }
      if (row1 < S) {
        *reinterpret_cast<uint32_t*>(ob + row1 * o_s + col) =
            ptt::pack2<T>(o[4 * n + 2] / ls1, o[4 * n + 3] / ls1);
      }
    }
  }
  if ((lane & 3) == 0) {
    float* lb = lse + (static_cast<long long>(b) * H + h) * S;
    if (row0 < S) lb[row0] = (sm.m0 + log2f(ls0)) * kLn2;
    if (row1 < S) lb[row1] = (sm.m1 + log2f(ls1)) * kLn2;
  }
}

template <int DP, typename T, int NWG>
cudaError_t launch_wgmma_nwg(const void* q, const void* k, const void* v,
                         void* out, float* lse, int B, int S, int H, int hd,
                         const Strides& st, float scale, int causal,
                         cudaStream_t stream) {
  using C = FwdTiles<DP, NWG>;
  using P = ptt::Panels<DP>;
  CUtensorMap mq, mk, mv;
  cudaError_t err = ptt::make_bshd_map<T>(&mq, q, B, S, H, hd, st.q_b,
                                          st.q_s, st.q_h, P::PW, 64);
  if (err == cudaSuccess) {
    err = ptt::make_bshd_map<T>(&mk, k, B, S, H, hd, st.k_b, st.k_s, st.k_h,
                                P::PW, C::BK);
  }
  if (err == cudaSuccess) {
    err = ptt::make_bshd_map<T>(&mv, v, B, S, H, hd, st.v_b, st.v_s, st.v_h,
                                P::PW, C::BK);
  }
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_wgmma_kernel<DP, T, NWG>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((S + C::BQ - 1) / C::BQ, H, B);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
      mq, mk, mv, static_cast<T*>(out), lse, S, H, hd, st.o_b, st.o_s,
      st.o_h, scale * kLog2e, causal);
  return cudaGetLastError();
}

// Two consumer warpgroups a block when the 128-row grid still fills the
// card, else one (more, smaller blocks for the serving shapes).
template <int DP, typename T>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, float* lse, int B, int S, int H, int hd,
                         const Strides& st, float scale, int causal,
                         cudaStream_t stream) {
  const long long blocks128 = static_cast<long long>((S + 127) / 128) * B * H;
  if (blocks128 >= kSMs) {
    return launch_wgmma_nwg<DP, T, 2>(q, k, v, out, lse, B, S, H, hd, st,
                                      scale, causal, stream);
  }
  return launch_wgmma_nwg<DP, T, 1>(q, k, v, out, lse, B, S, H, hd, st,
                                    scale, causal, stream);
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


// ---- float32: 3xTF32 products on wgmma, a converting producer ----

// f32 tiles, from the width alone (never S): BQ = 64 query rows a block
// (one consumer warpgroup) and BK keys a tile, the most that keeps q, k
// and v^T in hi and lo halves within 192 KB of shared memory (64 up to
// width 128, 32 at 192, 16 at 256). Every tile sits on 1024 bytes: q hi,
// q lo [BQ][DP], k hi, k lo [BK][DP] (K-major, panels of 32 floats, the
// 128-byte swizzle), v^T hi, v^T lo [DP][BK] (panels of VW keys, the
// 128- or, at 16 keys, 64-byte swizzle), then the mbarriers.
template <int DP>
struct F32Tiles {
  static constexpr int BQ = 64;
  static constexpr int BK = DP <= 128 ? 64 : DP == 192 ? 32 : 16;
  static constexpr int VW = BK < 32 ? BK : 32;     // keys a v^T panel row
  static constexpr int Q_TILE = BQ * DP * 4;       // bytes
  static constexpr int KV_TILE = BK * DP * 4;
  __host__ __device__ static constexpr int q_off(int lo) {
    return lo * Q_TILE;
  }
  __host__ __device__ static constexpr int k_off(int lo) {
    return 2 * Q_TILE + lo * KV_TILE;
  }
  __host__ __device__ static constexpr int v_off(int lo) {
    return 2 * Q_TILE + (2 + lo) * KV_TILE;
  }
  static constexpr int bar_off = 2 * Q_TILE + 4 * KV_TILE;
  static constexpr int SMEM = bar_off + 8 * 5 + 1024;
  // the consumer warpgroup, then the producer warpgroup
  static constexpr int THREADS = 256;
};

// One block a (64-row q tile, head, batch): a consumer warpgroup and a
// producer warpgroup. Both products are TF32 wgmma in 3xTF32 form, small
// products first into the same f32 accumulator:
//  - the producer loads q once and each k and v tile with 16-byte loads,
//    splits every value into its TF32 pair and stores the halves in the
//    layouts wgmma reads: q and k K-major, v transposed (v^T, keys
//    K-major), since wgmma takes TF32 only K-major; k and v have a buffer
//    each and their own full/empty mbarriers, so k_{j+1} is written while
//    the consumer runs softmax_j and P_j V_j, v_{j+1} while it runs
//    S_{j+1}; v's loads start once k's tile is stored, so one
//    tile's loads hold registers at a time (faster on an H100 than both
//    at once);
//  - the consumer: S_j = Q K_j^T as 3 x DP / 8 SS products m64nBKk8; the
//    online softmax of the 16-bit kernels in registers (Softmax<BK>);
//    P_j split in registers into the A operands of 3 x BK / 8 RS products
//    m64nDPk8 into O. (Issuing S_j before P_{j-1} V_{j-1}, as the 16-bit
//    kernels do, needs both products' registers at once: at widths 32-256
//    ptxas spilled and serialised the products, and it ran slower on an
//    H100.)
//  - a causal block stops at its diagonal tile, the mask is applied only
//    on diagonal and ragged tiles, and keys past S and columns past hd
//    are zeros in the tiles.
template <int DP>
__global__ void __launch_bounds__(F32Tiles<DP>::THREADS, DP <= 64 ? 2 : 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int S, int H, int hd,
                     Strides st, float scale_log2, int causal) {
  using C = F32Tiles<DP>;
  constexpr int BQ = C::BQ, BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = ptt::align_1024(smem_raw);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + C::bar_off);
  uint64_t* k_full = bar_q + 1;
  uint64_t* k_empty = bar_q + 2;
  uint64_t* v_full = bar_q + 3;
  uint64_t* v_empty = bar_q + 4;

  const int nq = (S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nk = (S + BK - 1) / BK;
  const int tiles = causal ? min((q0 + BQ - 1) / BK + 1, nk) : nk;

  if (threadIdx.x == 0) {
    ptt::mbar_init(bar_q, 128);
    ptt::mbar_init(k_full, 128);
    ptt::mbar_init(v_full, 128);
    ptt::mbar_init(k_empty, 4);              // one arrival a consumer warp
    ptt::mbar_init(v_empty, 4);
    ptt::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {                  // the producer
    const int pid = threadIdx.x - 128;
    const float* kh = k + b * st.k_b + h * st.k_h;
    const float* vh = v + b * st.v_b + h * st.v_h;
    {
      ptt::RowUnits<DP, BQ> qu;
      qu.load(q + b * st.q_b + h * st.q_h, st.q_s, q0, S, hd, pid);
      qu.store(smem + C::q_off(0), smem + C::q_off(1), pid);
      ptt::fence_proxy_async();
      ptt::mbar_arrive(bar_q);
    }
    for (int j = 0; j < tiles; ++j) {
      ptt::RowUnits<DP, BK> ku;
      ptt::VUnits<DP, BK, C::VW> vu;
      ku.load(kh, st.k_s, j * BK, S, hd, pid);
      ptt::mbar_wait(k_empty, (j & 1) ^ 1);
      ku.store(smem + C::k_off(0), smem + C::k_off(1), pid);
      ptt::fence_proxy_async();
      ptt::mbar_arrive(k_full);
      vu.load(vh, st.v_s, j * BK, S, hd, pid);
      ptt::mbar_wait(v_empty, (j & 1) ^ 1);
      vu.store(smem + C::v_off(0), smem + C::v_off(1), pid);
      ptt::fence_proxy_async();
      ptt::mbar_arrive(v_full);
    }
    return;
  }

  // the consumer: this thread holds rows row0 and row1 = row0 + 8,
  // columns 8 n + c2 + {0, 1}
  const int lane = threadIdx.x & 31;
  const int c2 = (lane & 3) * 2;
  const int row0 = q0 + (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int row1 = row0 + 8;
  const uint32_t sbase = ptt::smem_u32(smem);
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) ptt::mbar_arrive(bar);
  };

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  Softmax<BK> sm{kNegInf, kNegInf, 0.f, 0.f};
  ptt::mbar_wait(bar_q, 0);
  for (int j = 0; j < tiles; ++j) {
    // S_j = Q K_j^T: q lo k hi, q hi k lo, q hi k hi a k8 step
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    ptt::mbar_wait(k_full, j & 1);
    ptt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      using ptt::kmajor_desc;
      const uint64_t qh = kmajor_desc<32>(sbase + C::q_off(0), BQ, kk);
      const uint64_t ql = kmajor_desc<32>(sbase + C::q_off(1), BQ, kk);
      const uint64_t kh = kmajor_desc<32>(sbase + C::k_off(0), BK, kk);
      const uint64_t kl = kmajor_desc<32>(sbase + C::k_off(1), BK, kk);
      ptt::wgmma_tf32_ss<BK>(sc, ql, kh);
      ptt::wgmma_tf32_ss<BK>(sc, qh, kl);
      ptt::wgmma_tf32_ss<BK>(sc, qh, kh);
    }
    ptt::wgmma_commit();
    ptt::wgmma_wait<0>();
    ptt::fence_regs(sc);
    release(k_empty);
    const bool edge = j * BK + BK > S || (causal && j * BK + BK - 1 > q0);
    float a0, a1;
    sm.step(sc, j * BK, edge, S, causal, row0, row1, c2, scale_log2, a0, a1);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      o[4 * n] *= a0;
      o[4 * n + 1] *= a0;
      o[4 * n + 2] *= a1;
      o[4 * n + 3] *= a1;
    }
    // P_j as the A operands: slot t of k8 step kk is key 8 kk + 2t (the
    // accumulator's column 2t), slot t + 4 key 8 kk + 2t + 1
    uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      ptt::split_tf32(sc[4 * kk], ph[kk][0], pl[kk][0]);
      ptt::split_tf32(sc[4 * kk + 2], ph[kk][1], pl[kk][1]);
      ptt::split_tf32(sc[4 * kk + 1], ph[kk][2], pl[kk][2]);
      ptt::split_tf32(sc[4 * kk + 3], ph[kk][3], pl[kk][3]);
    }
    ptt::mbar_wait(v_full, j & 1);
    ptt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      using ptt::kmajor_desc;
      const uint64_t vh = kmajor_desc<C::VW>(sbase + C::v_off(0), DP, kk);
      const uint64_t vl = kmajor_desc<C::VW>(sbase + C::v_off(1), DP, kk);
      ptt::wgmma_tf32_rs<DP>(o, pl[kk], vh);
      ptt::wgmma_tf32_rs<DP>(o, ph[kk], vl);
      ptt::wgmma_tf32_rs<DP>(o, ph[kk], vh);
    }
    ptt::wgmma_commit();
    ptt::wgmma_wait<0>();
    ptt::fence_regs(o);
    release(v_empty);
  }

  float l0 = sm.l0, l1 = sm.l1;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float ls0 = l0 == 0.f ? 1.f : l0;
  const float ls1 = l1 == 0.f ? 1.f : l1;
  float* ob = out + b * st.o_b + h * st.o_h;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = 8 * n + c2;
    if (col < hd) {                       // hd is a multiple of 4
      if (row0 < S) {
        *reinterpret_cast<float2*>(ob + row0 * st.o_s + col) =
            make_float2(o[4 * n] / ls0, o[4 * n + 1] / ls0);
      }
      if (row1 < S) {
        *reinterpret_cast<float2*>(ob + row1 * st.o_s + col) =
            make_float2(o[4 * n + 2] / ls1, o[4 * n + 3] / ls1);
      }
    }
  }
  if ((lane & 3) == 0) {
    float* lb = lse + (static_cast<long long>(b) * H + h) * S;
    if (row0 < S) lb[row0] = (sm.m0 + log2f(ls0)) * kLn2;
    if (row1 < S) lb[row1] = (sm.m1 + log2f(ls1)) * kLn2;
  }
}

template <int DP>
cudaError_t launch_f32_dp(const void* q, const void* k, const void* v,
                          void* out, float* lse, int B, int S, int H, int hd,
                          const Strides& st, float scale, int causal,
                          cudaStream_t stream) {
  using C = F32Tiles<DP>;
  auto kernel = flash_fwd_f32_kernel<DP>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((S + C::BQ - 1) / C::BQ, H, B);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, S, H, hd,
      st, scale * kLog2e, causal);
  return cudaGetLastError();
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
#define PTT_FLASH_F32_CASE(DIM)                                            \
  if (tile_width(D) == DIM)                                                \
    return launch_f32_dp<DIM>(q, k, v, out, lse, B, S, H, D, st, scale,    \
                              causal, s);
    PTT_FLASH_F32_CASE(32)
    PTT_FLASH_F32_CASE(64)
    PTT_FLASH_F32_CASE(96)
    PTT_FLASH_F32_CASE(128)
    PTT_FLASH_F32_CASE(192)
    PTT_FLASH_F32_CASE(256)
#undef PTT_FLASH_F32_CASE
    return cudaErrorInvalidValue;
  }
  if (D % 8) return cudaErrorInvalidValue;
  const int dp = tile_width(D);
#define PTT_FLASH_WGMMA_CASE(DIM, TYPE, CODE)                              \
  if (dtype == CODE && dp == DIM)                                        \
    return launch_wgmma<DIM, TYPE>(q, k, v, out, lse, B, S, H, D, st,    \
                                   scale, causal, s);
  PTT_FLASH_WGMMA_CASE(32, __nv_bfloat16, 0)
  PTT_FLASH_WGMMA_CASE(64, __nv_bfloat16, 0)
  PTT_FLASH_WGMMA_CASE(96, __nv_bfloat16, 0)
  PTT_FLASH_WGMMA_CASE(128, __nv_bfloat16, 0)
  PTT_FLASH_WGMMA_CASE(192, __nv_bfloat16, 0)
  PTT_FLASH_WGMMA_CASE(256, __nv_bfloat16, 0)
  PTT_FLASH_WGMMA_CASE(32, __half, 1)
  PTT_FLASH_WGMMA_CASE(64, __half, 1)
  PTT_FLASH_WGMMA_CASE(96, __half, 1)
  PTT_FLASH_WGMMA_CASE(128, __half, 1)
  PTT_FLASH_WGMMA_CASE(192, __half, 1)
  PTT_FLASH_WGMMA_CASE(256, __half, 1)
#undef PTT_FLASH_WGMMA_CASE
  return cudaErrorInvalidValue;
}

const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
