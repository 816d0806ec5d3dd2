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
// 16-bit weight): per group, acc = acc + p_hi * s_hi, then acc = acc +
// p_lo * s_lo, explicitly rounded, groups in order.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): the call must
// read x, the packed codes and the scales once and write y once. At decode
// (M = 1..16) the 0.5 byte per weight dominates: BYTES bound (a 2048 x
// 2048 weight: 2.2 MB, 0.66 us; Llama-1B's lm_head, 2048 x 32000: 35 MB,
// 10.4 us). At prefill (M = 512) the product's 2 M K N operations:
// OPERATIONS bound. So there are two kernels, one launch per call either
// way:
//
// DECODE, M <= 16 (`int4_mm_decode_kernel`): stream the weight.
//  - The product is y^T = W^T x^T on mma.sync m16n8k16: 16 weight columns
//    fill the MMA's M side, the tokens its N side (one n8 tile up to 8
//    tokens, two up to 16), so no weight byte is wasted on empty rows.
//  - Work unit: one warp, a tile of BN = 32 or 64 columns and a run of
//    whole groups (a K split). Each warp streams its packed rows through
//    its own ring of 8 stages of 16 rows (one k16 step) with cp.async
//    16-byte copies (each row one or two whole 32-byte sectors) and
//    wait_group; x's values for the step ride in the same stage.
//  - The MMA's k order within a 16-row step and its row order within a
//    tile are free (x and y follow): thread (g, t) takes packed rows
//    4t..4t+3 and BN / 8 columns from (BN / 8) g, so it reads each row's
//    bytes with one shared load (rows stored at slot r ^ ((r >> 2) &
//    (128 / BN - 1)), so the four t of a warp spread over the banks).
//  - Nibbles to bf16 without int->float: prmt gathers two rows' bytes of
//    two columns into one word, lop3 ORs each nibble under the exponent
//    of 128 (0x4300 | u = 128 + u), and one bf16x2 subtraction of 136
//    gives u - 8 exactly: about one integer op a code.
//  - The step loop is unrolled by the ring's depth, so every slot offset
//    is a constant: the kernel is bound by its instructions at these
//    sizes, not by its bytes.
//  - The K split (`bn`, `warps`, `splits`: ops/int4_matmul.py:int4_plan,
//    from the weight's shape only) puts enough warps on the card's 132
//    SMs. A block's warps take consecutive splits and add their partials
//    in warp order in shared memory; the blocks of a tile are one thread
//    block cluster, and each pushes its sum into rank 0's shared memory
//    (distributed shared memory) and arrives on rank 0's mbarrier, which
//    adds them in rank order. One launch, no workspace, no float atomics,
//    the same bits every run.
//
// PREFILL, M > 16 (`int4_mm_prefill_kernel`): wgmma.
//  - y^T = W^T x^T with wgmma m64n64k16: the unpacked weight is the
//    register A operand (a warpgroup's 64 columns; its fragment layout is
//    mma.sync's, so the decode kernel's unpack feeds it), x the K-major B
//    operand (64 tokens). A block owns a 64-token x 128-column tile of y:
//    two consumer warpgroups read the same x tiles.
//  - A producer warp keeps a 4-stage ring full by TMA: per stage 64
//    packed rows in one 64-column panel a warpgroup (64-byte swizzle, so
//    the consumers' 16-bit reads of four rows at once are conflict-free),
//    the matching x tiles of both halves (64 tokens x 64 k, 128-byte
//    swizzle), and the scale rows of every group that starts in the
//    stage, so a group's end never waits for a load from device memory.
//    f32 x is converted to bf16 by the producer warp itself, written in
//    the same swizzled layout and published with a proxy fence.
//  - Each group's high and low partials run on their own accumulators
//    (scale-d = 0 on the group's first k-step), are then scaled and added
//    to the output accumulator in the reference's order. A group's end
//    drains the warpgroup's products (its partials are read): the one
//    stall left. Two sets of partials alternating between groups in one
//    warpgroup serialise the wgmmas instead (ptxas C7514: other
//    instructions read one set while products into the other are in
//    flight).
//
// BITS: a row's result does not depend on M within a regime. The split
// follows the weight's shape only, the MMA's output element depends only
// on its own token's x, and prefill has no split; so decode at M = 1
// gives the rows of M = 16, and a bucket-padded prompt gives the rows of
// the unpadded one. Where the regimes meet (M = 16 / 17) the bits differ
// (other summation orders); both are within one bf16 step of the plain
// version. The ragged edges: tokens >= M and columns >= N load as zeros
// and are never written; packed rows past K/2 are never multiplied.
// Needs group % 16 == 0, N % 16 == 0, K % 8 == 0 (bf16 x) or K % 4 == 0
// (f32 x), 16-byte aligned rows (the Python wrapper checks). The launcher
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---- shared by both regimes ----

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

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

// The nibbles at bits 0-3 and 16-19 of v as a bf16 pair u - 8: lop3 puts
// each under the exponent of 128 ((v & 0x000F000F) | 0x43004300 is 128 +
// u in each half), and 128 + u - 136 is exact in bf16.
__device__ __forceinline__ uint32_t nibble_pair(uint32_t v) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;"
      : "=r"(r)
      : "r"(v), "r"(0x000F000Fu), "r"(0x43004300u));
  __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&r);
  b = __hsub2(b, __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<uint32_t*>(&b);
}

// P holds bytes [(ra, c0), (ra, c1), (rb, c0), (rb, c1)] of two packed
// rows ra < rb and two columns: the MMA A registers of column c0 and of
// column c1 for the k pair (ra, rb), high nibbles (rows k) and low
// nibbles (rows k + K/2).
__device__ __forceinline__ void unpack(uint32_t P, uint32_t& lo0,
                                       uint32_t& hi0, uint32_t& lo1,
                                       uint32_t& hi1) {
  lo0 = nibble_pair(P);
  hi0 = nibble_pair(P >> 4);
  lo1 = nibble_pair(P >> 8);
  hi1 = nibble_pair(P >> 12);
}

__device__ __forceinline__ float scaled_add(float acc, float p, float s) {
  return __fadd_rn(acc, __fmul_rn(p, s));
}

// Two adjacent outputs in y's dtype.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = bf16_bits(a, b);
}

// ---- decode: M <= 16 ----

constexpr int kDecStages = 8;               // ring stages a warp
constexpr int kDecRows = 16;                // partial rows (M <= 16)
constexpr int kDecMaxWarps = 8;             // warps a block

// The shared-memory row of packed row r (0..15) of a stage of BN-byte
// rows, so that the rows 4 t + i of a warp's four t land in distinct bank
// groups (two wavefronts for BN = 64, one for BN = 32).
template <int BN>
__device__ __forceinline__ int dec_slot(int r) {
  return r ^ ((r >> 2) & (128 / BN - 1));
}

// 16 bytes from global to shared memory (shared address dst), zeros when
// !ok.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four x values staged in shared memory (address a) as two bf16 pairs,
// zeros when absent.
template <typename T>
__device__ __forceinline__ uint2 lds_x4(uint32_t a, bool ok) {
  uint2 r = make_uint2(0, 0);
  if constexpr (std::is_same<T, float>::value) {
    float v0, v1, v2, v3;
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v0), "=f"(v1), "=f"(v2), "=f"(v3)
                 : "r"(a));
    if (ok) r = make_uint2(bf16_bits(v0, v1), bf16_bits(v2, v3));
  } else {
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];"
                 : "=r"(r.x), "=r"(r.y)
                 : "r"(a));
    if (!ok) r = make_uint2(0, 0);
  }
  return r;
}

// 4 or 8 consecutive floats.
template <int C>
__device__ __forceinline__ void load_f(const float* p, float (&v)[C],
                                       bool cg) {
#pragma unroll
  for (int q = 0; q < C / 4; ++q) {
    const float4* a = reinterpret_cast<const float4*>(p) + q;
    const float4 u = cg ? __ldcg(a) : *a;
    v[4 * q] = u.x; v[4 * q + 1] = u.y; v[4 * q + 2] = u.z;
    v[4 * q + 3] = u.w;
  }
}
template <int C>
__device__ __forceinline__ void store_f(float* p, const float (&v)[C]) {
#pragma unroll
  for (int q = 0; q < C / 4; ++q)
    reinterpret_cast<float4*>(p)[q] =
        make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}
template <int C>
__device__ __forceinline__ void store_y(float* p, const float (&v)[C]) {
  store_f<C>(p, v);
}
template <int C>
__device__ __forceinline__ void store_y(__nv_bfloat16* p,
                                        const float (&v)[C]) {
  uint32_t u[C / 2];
#pragma unroll
  for (int q = 0; q < C / 2; ++q) u[q] = bf16_bits(v[2 * q], v[2 * q + 1]);
  if constexpr (C == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
  }
}

// Thread-block clusters: the split arrive/wait of the cluster barrier,
// another block's shared address, stores to it, and arrivals on (and a
// wait for) an mbarrier that other blocks of the cluster arrive on.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
__device__ __forceinline__ uint32_t map_rank(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}
template <int C>
__device__ __forceinline__ void st_cluster(uint32_t a, const float (&v)[C]) {
#pragma unroll
  for (int q = 0; q < C / 4; ++q)
    asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(
                     a + 16 * q),
                 "f"(v[4 * q]), "f"(v[4 * q + 1]), "f"(v[4 * q + 2]),
                 "f"(v[4 * q + 3])
                 : "memory");
}
__device__ __forceinline__ void arrive_cluster(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
          bar)
      : "memory");
}
// Wait for phase 0 of a local mbarrier that other blocks arrive on; traps
// (an error, not a hang) if it has not completed after ~2^31 polls.
__device__ __forceinline__ void wait_cluster(uint64_t* bar) {
  const uint32_t a = ptt::smem_u32(bar);
  for (uint32_t i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a)
        : "memory");
    if (done) return;
    if (i == 0x7fffffffu) __trap();
  }
}

// A block owns a BN-column tile and `W` (blockDim / 32) consecutive splits
// of its K range, one a warp; splits / W blocks (one cluster) share a
// tile. NT n8 tiles of tokens (1: M <= 8, 2: M <= 16).
template <typename T, int NT, int BN>
__global__ void __launch_bounds__(kDecMaxWarps * 32)
int4_mm_decode_kernel(const T* __restrict__ x,
                      const uint8_t* __restrict__ packed,
                      const float* __restrict__ scales, T* __restrict__ y,
                      int M, int K, int N, int group, int splits) {
  constexpr int XE = sizeof(T);              // bytes of an x value
  constexpr int XT = 8 * NT;                 // token rows staged
  constexpr int XOFF = 16 * BN;              // the stage's x, after the codes
  // bytes of one k16 step: the codes, then x's 16 values of each half of
  // each token ([half][token][16])
  constexpr int STAGE = XOFF + 2 * XT * 16 * XE;
  constexpr int WB = BN / 8;                 // bytes of a row a thread reads
  constexpr int TT = BN / 16;                // m16 tiles a step
  constexpr int CPL = BN / 32;               // 16-byte code copies a lane
  constexpr int XPL = 2 * XT * XE / 32;      // 16-byte x copies a lane
  extern __shared__ __align__(128) uint8_t dsm[];
  const int W = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  // a tile's nb = splits / W blocks are one cluster: rank r takes splits
  // r W..r W + W - 1
  const int nb = splits / W;
  const int tile = blockIdx.x / nb, rank = blockIdx.x % nb;
  // rank 0 receives the other ranks' arrivals on pbar and their partials
  // ([nb - 1][16][BN] f32) in peer, after the rings
  uint64_t* pbar = reinterpret_cast<uint64_t*>(dsm + W * kDecStages * STAGE);
  float* peer = reinterpret_cast<float*>(dsm + W * kDecStages * STAGE + 16);
  if (nb > 1) {
    if (threadIdx.x == 0) {
      ptt::mbar_init(pbar, 32 * (nb - 1));
      ptt::fence_barrier_init();
    }
    __syncthreads();
    cluster_arrive();
  }
  const int n0 = tile * BN;
  const int half = K / 2, gh = half / group, spg = group / 16;
  const int per = (gh + splits - 1) / splits;
  const int g0 = (rank * W + warp) * per;
  const int steps = max(0, min(gh, g0 + per) - g0) * spg;
  const int r0 = g0 * group;                 // first packed row
  const uint32_t ring0 = ptt::smem_u32(dsm + warp * kDecStages * STAGE);

  // this lane's copies a stage: chunk q = lane + 32 i is row q / (BN / 16),
  // bytes 16 (q % (BN / 16)); the source walks 16 rows a stage
  const int cc = (lane % (BN / 16)) * 16;
  const bool ok = n0 + cc < N;
  const long long row_step = ok ? 16LL * N : 0;
  const long long copy_step = ok ? (32LL / (BN / 16)) * N : 0;
  const uint8_t* src =
      ok ? packed + static_cast<long long>(r0 + lane / (BN / 16)) * N + n0 +
               cc
         : packed;
  uint32_t dst[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i)
    dst[i] = ring0 + dec_slot<BN>((lane + 32 * i) / (BN / 16)) * BN + cc;
  // x rides in the same stages: chunk q = lane + 32 i is token q / (2 XE),
  // half (q / XE) % 2, bytes 16 (q % XE) of the step's 16 values
  const T* xsrc[XPL];
  uint32_t xdst[XPL];
  bool xcp[XPL];
#pragma unroll
  for (int i = 0; i < XPL; ++i) {
    const int q = lane + 32 * i, m = q / (2 * XE), h = (q / XE) % 2;
    xcp[i] = m < M;
    xsrc[i] = x + static_cast<long long>(xcp[i] ? m : 0) * K + h * half +
              r0 + (q % XE) * (16 / XE);
    xdst[i] = ring0 + XOFF + (h * XT + m) * 16 * XE + (q % XE) * 16;
  }
  // stage st goes to slot st % kDecStages; stages are issued in order
  auto issue = [&](int slot) {
    const uint32_t at = slot * STAGE;
#pragma unroll
    for (int i = 0; i < CPL; ++i)
      cp_async16(dst[i] + at, src + i * copy_step, ok);
#pragma unroll
    for (int i = 0; i < XPL; ++i) {
      cp_async16(xdst[i] + at, xcp[i] ? xsrc[i] : x, xcp[i]);
      xsrc[i] += 16;
    }
    src += row_step;
  };
#pragma unroll
  for (int st = 0; st < kDecStages - 1; ++st) {
    if (st < steps) issue(st);
    cp_async_commit();
  }

  const bool cols_ok = n0 + WB * gid < N;
  float acc[NT][TT][4], p_hi[NT][TT][4], p_lo[NT][TT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int t = 0; t < TT; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][t][i] = 0.f;
  float s_hi[WB], s_lo[WB];

  // x of token gid + 8 j at packed rows 4 tig..4 tig + 3 of a stage
  bool xok[NT];
  uint32_t xrd[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    xok[j] = gid + 8 * j < M;
    xrd[j] = ring0 + XOFF + (gid + 8 * j) * 16 * XE + 4 * tig * XE;
  }
  // this thread's row i of a stage: 4 tig + i (see dec_slot)
  uint32_t rd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    rd[i] = ring0 + dec_slot<BN>(4 * tig + i) * BN + WB * gid;
  const float* sp = scales + static_cast<long long>(g0) * N + n0 + WB * gid;
  const long long lo_rows = static_cast<long long>(gh) * N;

  // the steps in runs of kDecStages, so that every slot offset is a
  // constant of the unrolled body
  int gs = 0;                      // the step within its group
  for (int st0 = 0; st0 < steps; st0 += kDecStages) {
#pragma unroll
  for (int u = 0; u < kDecStages; ++u) {
    const int st = st0 + u;
    if (st >= steps) break;
    if (st + kDecStages - 1 < steps) issue((u + kDecStages - 1) % kDecStages);
    cp_async_commit();
    if (gs == 0) {                 // a group starts: its scales, p = 0
      if (cols_ok) {
        load_f<WB>(sp, s_hi, false);
        load_f<WB>(sp + lo_rows, s_lo, false);
      } else {
#pragma unroll
        for (int c = 0; c < WB; ++c) s_hi[c] = s_lo[c] = 0.f;
      }
      sp += N;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int t = 0; t < TT; ++t)
#pragma unroll
          for (int i = 0; i < 4; ++i) p_hi[j][t][i] = p_lo[j][t][i] = 0.f;
    }
    cp_async_wait<kDecStages - 1>();
    __syncwarp();
    const uint32_t at = u * STAGE;
    uint2 bh[NT], bl[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      bh[j] = lds_x4<T>(xrd[j] + at, xok[j]);
      bl[j] = lds_x4<T>(xrd[j] + at + XT * 16 * XE, xok[j]);
    }
    uint32_t w[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (BN == 64) {
        asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];"
                     : "=r"(w[i][0]), "=r"(w[i][1])
                     : "r"(rd[i] + at));
      } else {
        asm volatile("ld.shared.u32 %0, [%1];"
                     : "=r"(w[i][0])
                     : "r"(rd[i] + at));
        w[i][1] = 0;
      }
    }
    __syncwarp();                  // the slot is refilled next step

#pragma unroll
    for (int t = 0; t < TT; ++t) {
      // columns WB gid + 2 t (A row gid) and + 1 (A row gid + 8)
      const uint32_t sel = (t & 1) ? 0x7632u : 0x5410u;
      const uint32_t P01 = prmt(w[0][t >> 1], w[1][t >> 1], sel);
      const uint32_t P23 = prmt(w[2][t >> 1], w[3][t >> 1], sel);
      uint32_t a_hi[4], a_lo[4];
      unpack(P01, a_lo[0], a_hi[0], a_lo[1], a_hi[1]);
      unpack(P23, a_lo[2], a_hi[2], a_lo[3], a_hi[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mma_bf16(p_hi[j][t], a_hi, bh[j].x, bh[j].y);
        mma_bf16(p_lo[j][t], a_lo, bl[j].x, bl[j].y);
      }
    }

    if (++gs == spg) {             // the group's scales, high half first
      gs = 0;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int t = 0; t < TT; ++t)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = 2 * t + (i >> 1);
            acc[j][t][i] = scaled_add(acc[j][t][i], p_hi[j][t][i], s_hi[c]);
            acc[j][t][i] = scaled_add(acc[j][t][i], p_lo[j][t][i], s_lo[c]);
          }
    }
  }
  }
  cp_async_wait<0>();
  __syncwarp();

  // this warp's partial into its own ring ([16][BN] f32): tokens
  // 2 tig + e + 8 j, columns WB gid + c
  float* red = reinterpret_cast<float*>(dsm);
  float* mine = red + warp * (kDecStages * STAGE / 4);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = 2 * tig + e + 8 * j;
      if (m >= M) continue;
      float v[WB];
#pragma unroll
      for (int c = 0; c < WB; ++c) v[c] = acc[j][c >> 1][e + 2 * (c & 1)];
      store_f<WB>(mine + m * BN + WB * gid, v);
    }
  __syncthreads();
  if (nb > 1) cluster_wait();      // rank 0's pbar is initialised
  if (warp != 0) return;

  // warp 0: the block's warps in order, then (nb > 1) rank 0 adds the
  // other ranks' sums in rank order
  float v[NT][2][WB];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = 2 * tig + e + 8 * j;
      if (m >= M) continue;
      load_f<WB>(red + m * BN + WB * gid, v[j][e], false);
      for (int q = 1; q < W; ++q) {
        float u[WB];
        load_f<WB>(red + q * (kDecStages * STAGE / 4) + m * BN + WB * gid, u,
                   false);
#pragma unroll
        for (int c = 0; c < WB; ++c) v[j][e][c] = __fadd_rn(v[j][e][c], u[c]);
      }
    }
  if (nb > 1) {
    if (rank != 0) {               // push this block's sum to rank 0
      const uint32_t to = map_rank(ptt::smem_u32(peer), 0) +
                          (rank - 1) * kDecRows * BN * 4 + WB * gid * 4;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = 2 * tig + e + 8 * j;
          if (m < M) st_cluster<WB>(to + m * BN * 4, v[j][e]);
        }
      arrive_cluster(map_rank(ptt::smem_u32(pbar), 0));
      return;
    }
    wait_cluster(pbar);            // every other rank's sum is here
    for (int r = 1; r < nb; ++r)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = 2 * tig + e + 8 * j;
          if (m >= M) continue;
          float u[WB];
          load_f<WB>(peer + ((r - 1) * kDecRows + m) * BN + WB * gid, u,
                     false);
#pragma unroll
          for (int c = 0; c < WB; ++c)
            v[j][e][c] = __fadd_rn(v[j][e][c], u[c]);
        }
  }
  if (!cols_ok) return;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = 2 * tig + e + 8 * j;
      if (m < M)
        store_y<WB>(y + static_cast<long long>(m) * N + n0 + WB * gid,
                    v[j][e]);
    }
}

// ---- prefill: M > 16 ----

constexpr int kPreBM = 64;                  // tokens a block
constexpr int kPreWG = 2;                   // consumer warpgroups a block
constexpr int kPreBN = 64 * kPreWG;         // columns a block
constexpr int kPreKC = 64;                  // packed rows a stage
constexpr int kPreStages = 4;
constexpr int kPreX = kPreBM * kPreKC * 2;  // bytes of one x tile (bf16)
constexpr int kPrePanel = kPreBM * 128;     // its 64-column panels
constexpr int kPrePack = kPreKC * 64;       // bytes of a warpgroup's panel
constexpr int kPreW = kPreWG * kPrePack;    // bytes of one packed tile
// the scale rows (high and low half, kPreBN columns) of every group that
// starts in a stage: at most kPreKC / 16 of them
constexpr int kPreScaleSlot = 2 * kPreBN * 4;
constexpr int kPreScaleOff = 2 * kPreX + kPreW;
constexpr int kPreStage = kPreScaleOff + (kPreKC / 16) * kPreScaleSlot;
constexpr int kPreBarOff = kPreStages * kPreStage;
constexpr int kPreSmem = kPreBarOff + 16 * kPreStages + 1024;
constexpr int kPreThreads = 128 * kPreWG + 32;   // consumers, a producer

// Byte offset of (row r, byte column c) in a 64-column panel of packed
// rows as TMA writes it with CU_TENSOR_MAP_SWIZZLE_64B.
__device__ __forceinline__ int swz64(int r, int c) {
  return r * 64 + ((((c >> 4) ^ (r >> 1)) & 3) << 4) + (c & 15);
}

// The producer's x tiles from f32 x: 64 tokens x 64 k of each half,
// rounded to bf16 and stored as TMA's 128-byte swizzle would.
__device__ __forceinline__ void stage_x_f32(uint8_t* dst, const float* x,
                                            int M, int K, int m0, int k0,
                                            int lane) {
  for (int i = lane; i < kPreBM * 8; i += 32) {
    const int r = i >> 3, q = i & 7, m = m0 + r, k = k0 + 8 * q;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (m < M) {
      const float* p = x + static_cast<long long>(m) * K + k;
      if (k < K) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(p));
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      }
      if (k + 4 < K) {
        const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
        v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
      }
    }
    *reinterpret_cast<uint4*>(dst + r * 128 + ((q ^ (r & 7)) << 4)) =
        make_uint4(bf16_bits(v[0], v[1]), bf16_bits(v[2], v[3]),
                   bf16_bits(v[4], v[5]), bf16_bits(v[6], v[7]));
  }
}

template <typename T>
__global__ void __launch_bounds__(kPreThreads, 1)
int4_mm_prefill_kernel(const __grid_constant__ CUtensorMap tx,
                       const __grid_constant__ CUtensorMap tw,
                       const __grid_constant__ CUtensorMap ts,
                       const T* __restrict__ x, T* __restrict__ y, int M,
                       int K, int N, int group) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = ptt::align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kPreBarOff);
  uint64_t* empty = full + kPreStages;
  const int m0 = blockIdx.x * kPreBM, n0 = blockIdx.y * kPreBN;
  const int half = K / 2, gh = half / group, spg = group / 16;
  const int nsteps = half / 16;
  const int nchunks = (half + kPreKC - 1) / kPreKC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kPreStages; ++s) {
      ptt::mbar_init(&full[s], 1);
      ptt::mbar_init(&empty[s], 128 * kPreWG);  // every consumer thread
    }
    ptt::fence_barrier_init();
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  // the warpgroup index through a shuffle, so the compiler sees it (and
  // the branches made from it) uniform
  const int wg =
      __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 7), 0);
  if (wg == kPreWG) {                          // the producer warp
    for (int c = 0; c < nchunks; ++c) {
      const int s = c % kPreStages;
      uint8_t* st = smem + s * kPreStage;
      // the groups that start in this chunk: their scale rows come along
      const int r0 = c * kPreKC, r1 = min(r0 + kPreKC, half);
      const int g0 = (r0 + group - 1) / group;
      const int ng = (r1 + group - 1) / group - g0;
      ptt::mbar_wait(&empty[s], ((c / kPreStages) & 1) ^ 1);
      if constexpr (std::is_same<T, float>::value) {
        for (int q = 0; q < kPreKC / 64; ++q) {
          stage_x_f32(st + q * kPrePanel, x, M, K, m0, r0 + 64 * q, lane);
          stage_x_f32(st + kPreX + q * kPrePanel, x, M, K, m0,
                      half + r0 + 64 * q, lane);
        }
        ptt::fence_proxy_async();
        __syncwarp();
      }
      if (lane == 0) {
        const bool tma_x = !std::is_same<T, float>::value;
        ptt::mbar_arrive_tx(&full[s], (tma_x ? 2 * kPreX : 0) + kPreW +
                                          ng * kPreScaleSlot);
        for (int q = 0; tma_x && q < kPreKC / 64; ++q) {
          ptt::tma_load_2d(st + q * kPrePanel, &tx, &full[s], r0 + 64 * q,
                           m0);
          ptt::tma_load_2d(st + kPreX + q * kPrePanel, &tx, &full[s],
                           half + r0 + 64 * q, m0);
        }
        for (int q = 0; q < kPreWG; ++q)
          ptt::tma_load_2d(st + 2 * kPreX + q * kPrePack, &tw, &full[s],
                           n0 + 64 * q, r0);
        for (int i = 0; i < ng; ++i) {
          uint8_t* to = st + kPreScaleOff + i * kPreScaleSlot;
          ptt::tma_load_2d(to, &ts, &full[s], n0, g0 + i);
          ptt::tma_load_2d(to + kPreBN * 4, &ts, &full[s], n0, gh + g0 + i);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg owns columns 64 wg..64 wg + 63 of the tile; its
  // A rows 16 w + gid and + 8 are columns cl and cl + 1 (adjacent, so one
  // 16-bit read a packed row); both warpgroups read the same x tiles
  const int warp = (threadIdx.x >> 5) & 3, gid = lane >> 2, tig = lane & 3;
  const int cl = 64 * wg + 16 * warp + 2 * gid;
  const int col = n0 + cl;
  const bool col_ok = col < N;
  const uint32_t sbase = ptt::smem_u32(smem);
  using Pn = ptt::Panels<kPreKC>;

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float2 sh = make_float2(0.f, 0.f), sl = sh;

  // this thread's four packed rows of a k16 step (2 tig + {0, 1, 8, 9});
  // the swizzle of row 16 kk + r is that of r
  int off[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 2 * tig + (i & 1) + 8 * (i >> 1);
    off[i] = wg * kPrePack + swz64(r, cl & 63);
  }
  constexpr int ksteps = kPreKC / 16;

  // A chunk's products are one commit group; a stage is released (every
  // consumer thread arrives) once the next chunk's products are issued
  // and its own have landed (wait<1>), so the tensor cores are fed across
  // chunks. A group's end drains them (its partials are read); its scales
  // came with the stage where it started, so the drain waits for no load
  // from device memory. No branch here depends on the thread, so ptxas
  // keeps the wgmmas asynchronous.
  float ph[32], pl[32];
  int gs = 0;                      // the step within its group
  for (int c = 0; c < nchunks; ++c) {
    const int s = c % kPreStages;
    ptt::mbar_wait(&full[s], (c / kPreStages) & 1);
    const uint8_t* st = smem + s * kPreStage;
    const uint8_t* wt = st + 2 * kPreX;
    const uint8_t* sc = st + kPreScaleOff + cl * 4;
    const uint32_t xh = sbase + s * kPreStage, xl = xh + kPreX;
    const int nk = min(ksteps, nsteps - c * ksteps);
    int slot = 0;                  // groups started in this chunk so far
#pragma unroll
    for (int kk = 0; kk < ksteps; ++kk) {
      if (kk < nk) {
        uint32_t ah[4], al[4];
        const uint8_t* rows = wt + 16 * 64 * kk;
        const uint32_t h0 = *reinterpret_cast<const uint16_t*>(rows + off[0]);
        const uint32_t h1 = *reinterpret_cast<const uint16_t*>(rows + off[1]);
        const uint32_t h8 = *reinterpret_cast<const uint16_t*>(rows + off[2]);
        const uint32_t h9 = *reinterpret_cast<const uint16_t*>(rows + off[3]);
        unpack(prmt(h0, h1, 0x5410u), al[0], ah[0], al[1], ah[1]);
        unpack(prmt(h8, h9, 0x5410u), al[2], ah[2], al[3], ah[3]);
        if (gs == 0) {             // a group starts: its scales
          sh = *reinterpret_cast<const float2*>(sc + slot * kPreScaleSlot);
          sl = *reinterpret_cast<const float2*>(sc + slot * kPreScaleSlot +
                                                kPreBN * 4);
          ++slot;
        }
        ptt::wgmma_fence();
        ptt::wgmma_rs_kmajor<64, __nv_bfloat16>(
            ph, ah, Pn::kmajor(xh, 64, 0, kk), gs != 0);
        ptt::wgmma_rs_kmajor<64, __nv_bfloat16>(
            pl, al, Pn::kmajor(xl, 64, 0, kk), gs != 0);
        if (++gs == spg) {         // high half first
          gs = 0;
          ptt::wgmma_commit();
          ptt::wgmma_wait<0>();
          ptt::fence_regs(ph);
          ptt::fence_regs(pl);
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& a0 = acc[4 * j + e];        // column col
              float& a1 = acc[4 * j + 2 + e];    // column col + 1
              a0 = scaled_add(a0, ph[4 * j + e], sh.x);
              a0 = scaled_add(a0, pl[4 * j + e], sl.x);
              a1 = scaled_add(a1, ph[4 * j + 2 + e], sh.y);
              a1 = scaled_add(a1, pl[4 * j + 2 + e], sl.y);
            }
        }
      }
    }
    ptt::wgmma_commit();
    if (c > 0) {
      ptt::wgmma_wait<1>();
      ptt::mbar_arrive(&empty[(c - 1) % kPreStages]);
    }
  }

  if (!col_ok) return;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * j + 2 * tig + e;
      if (m < M)
        store2(y + static_cast<long long>(m) * N + col, acc[4 * j + e],
               acc[4 * j + 2 + e]);
    }
}

// ---- launchers ----

template <typename T, int BN>
cudaError_t launch_decode_bn(const void* x, const void* packed,
                             const void* scales, void* y, int M, int K,
                             int N, int group, int warps, int splits,
                             cudaStream_t stream) {
  const int nb = splits / warps;             // a cluster of nb blocks a tile
  const int tiles = (N + BN - 1) / BN;
  const int smem =
      warps * kDecStages * (16 * BN + 2 * (M <= 8 ? 8 : 16) * 16 *
                                          static_cast<int>(sizeof(T))) +
      (nb > 1 ? 16 + (nb - 1) * kDecRows * BN * 4 : 0);
  auto run = [&](auto kernel) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(tiles * nb);
    cfg.blockDim = dim3(warps * 32);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = nb;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                              static_cast<const uint8_t*>(packed),
                              static_cast<const float*>(scales),
                              static_cast<T*>(y), M, K, N, group, splits);
  };
  const cudaError_t err = M <= 8 ? run(int4_mm_decode_kernel<T, 1, BN>)
                                 : run(int4_mm_decode_kernel<T, 2, BN>);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t launch_decode(const void* x, const void* packed,
                          const void* scales, void* y, int M, int K, int N,
                          int group, int bn, int warps, int splits,
                          cudaStream_t stream) {
  return bn == 32 ? launch_decode_bn<T, 32>(x, packed, scales, y, M, K, N,
                                            group, warps, splits, stream)
                  : launch_decode_bn<T, 64>(x, packed, scales, y, M, K, N,
                                            group, warps, splits, stream);
}

template <typename T>
cudaError_t launch_prefill(const void* x, const void* packed,
                           const void* scales, void* y, int M, int K, int N,
                           int group, cudaStream_t stream) {
  CUtensorMap mx, mw, ms;
  cudaError_t err = ptt::make_2d_map(
      &mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, packed, K / 2, N, N, 64, kPreKC,
      CU_TENSOR_MAP_SWIZZLE_64B);
  if (err == cudaSuccess)
    err = ptt::make_2d_map(&ms, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scales,
                           K / group, N, 4LL * N, kPreBN, 1,
                           CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  if constexpr (std::is_same<T, float>::value) {
    mx = mw;                                   // unused: f32 x is staged
  } else {
    err = ptt::make_2d_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M, K,
                           2LL * K, 64, kPreBM,
                           CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
  }
  auto kernel = int4_mm_prefill_kernel<T>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kPreSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kPreBM - 1) / kPreBM, (N + kPreBN - 1) / kPreBN);
  kernel<<<grid, kPreThreads, kPreSmem, stream>>>(
      mx, mw, ms, static_cast<const T*>(x), static_cast<T*>(y), M, K, N,
      group);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x's and y's). M <= 16 runs the decode
// kernel on tiles of bn (32 or 64) columns, with `splits` K splits of
// whole groups, `warps` of them a block (splits % warps == 0) and the
// splits / warps (at most 8) blocks of a tile one cluster. M > 16 runs
// the prefill kernel (bn, warps and splits unused). Returns a cudaError_t
// (0 = success).
int ptt_int4_matmul(const void* x, const void* packed, const void* scales,
                    void* y, int M, int K, int N, int group, int bn,
                    int warps, int splits, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < 2 || N < 16 || group < 16 || group % 16 ||
      (K / 2) % group || N % 16 || K % (dtype == 0 ? 4 : 8) || dtype < 0 ||
      dtype > 1)
    return cudaErrorInvalidValue;
  if (M <= 16) {
    if ((bn != 32 && bn != 64) || warps < 1 || warps > kDecMaxWarps ||
        splits < warps || splits % warps || splits / warps > 8 ||
        splits > K / 2 / group)
      return cudaErrorInvalidValue;
    return dtype == 0
               ? launch_decode<float>(x, packed, scales, y, M, K, N, group,
                                      bn, warps, splits, s)
               : launch_decode<__nv_bfloat16>(x, packed, scales, y, M, K, N,
                                              group, bn, warps, splits, s);
  }
  return dtype == 0 ? launch_prefill<float>(x, packed, scales, y, M, K, N,
                                            group, s)
                    : launch_prefill<__nv_bfloat16>(x, packed, scales, y, M,
                                                    K, N, group, s);
}

const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
