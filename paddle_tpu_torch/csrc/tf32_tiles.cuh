// The f32 flash kernels' 3xTF32 operands (flash_attention_fwd.cu and
// flash_attention_bwd.cu): the split of an f32 value into TF32 halves, the
// K-major shared tiles TF32 wgmma reads (wgmma takes TF32 only K-major),
// and the producer warpgroup's stores of a tile's rows into them, as they
// stand (RowUnits) or transposed (VUnits).
#pragma once

#include <stdint.h>

#include "hopper.cuh"

namespace ptt {

// x as a TF32 pair: hi = x rounded to TF32's 10 stored mantissa bits
// (to nearest, ties away), lo = x - hi, exact in f32; the tensor core
// reads lo's top 19 bits. hi*hi + hi*lo + lo*hi leaves out lo*lo and lo's
// cut bits: ~2^-21 of |a b| a product, against TF32's 2^-11 alone.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// The 16-byte chunk of 4 consecutive K-dim values (k0 % 4 == 0) of row r
// in a K-major tile of `rows` rows stored as panels of PW floats, with the
// swizzle of a PW * 4-byte row (128: chunk ^ r % 8; 64: ^ (r / 2) % 4).
template <int PW>
__device__ __forceinline__ uint32_t kmajor_off(int rows, int r, int k0) {
  constexpr int RB = PW * 4;
  const int sw = RB == 128 ? (r & 7) : ((r >> 1) & 3);
  return (k0 / PW) * rows * RB + r * RB + ((((k0 % PW) >> 2) ^ sw) << 4);
}

// The descriptor of k8 step kk of a K-major tile (rows at `tile`, panels
// of PW floats).
template <int PW>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows,
                                                int kk) {
  constexpr int RB = PW * 4;
  return ptt::wgmma_desc(tile + (8 * kk / PW) * rows * RB + (8 * kk % PW) * 4,
                         16, 8 * RB, RB);
}

// The producer's share of ROWS rows x DP columns of one head (rows r0..,
// columns 0..hd-1; zeros past S and hd) as 16-byte units: load them, then
// store them split into the hi and lo K-major tiles.
template <int DP, int ROWS>
struct RowUnits {
  static constexpr int CH = DP / 4;                    // chunks a row
  static constexpr int N = (ROWS * CH + 127) / 128;    // units a thread
  float4 val[N];

  __device__ __forceinline__ void load(const float* src, long long rs, int r0,
                                       int S, int hd, int pid) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int u = pid + 128 * i, r = u / CH, c = (u % CH) * 4;
      val[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (u < ROWS * CH && r0 + r < S && c < hd) {
        val[i] = *reinterpret_cast<const float4*>(src + (r0 + r) * rs + c);
      }
    }
  }

  __device__ __forceinline__ void store(uint8_t* hi, uint8_t* lo,
                                        int pid) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int u = pid + 128 * i, r = u / CH, c = (u % CH) * 4;
      if (u < ROWS * CH) {
        uint4 h, l;
        split_tf32(val[i].x, h.x, l.x);
        split_tf32(val[i].y, h.y, l.y);
        split_tf32(val[i].z, h.z, l.z);
        split_tf32(val[i].w, h.w, l.w);
        const uint32_t off = kmajor_off<32>(ROWS, r, c);
        *reinterpret_cast<uint4*>(hi + off) = h;
        *reinterpret_cast<uint4*>(lo + off) = l;
      }
    }
  }
};

// The producer's share of a v tile (BK keys from k0, columns 0..hd-1),
// stored transposed and split into v^T hi and lo [DP][BK]: the k8 step's
// slot t holds key 2t, slot t + 4 key 2t + 1 (the order the score
// accumulator leaves P's keys in, so that P is the A operand as it
// stands). A unit is the 4 keys of one such half of a k8 step (keys
// 8 kg + half + 2i) x 4 columns: one 16-byte chunk of each of 4 v^T
// rows; 8 neighbouring lanes take the 8 chunks of one 128-byte row.
template <int DP, int BK, int VW>
struct VUnits {
  static constexpr int HK = BK / 4;                    // halves of k8 steps
  static constexpr int N = (HK * (DP / 4) + 127) / 128;
  float4 val[N][4];

  __device__ __forceinline__ void load(const float* src, long long rs, int k0,
                                       int S, int hd, int pid) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int u = pid + 128 * i, hk = u % HK, c = (u / HK) * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * (hk / 2) + hk % 2 + 2 * e;
        val[i][e] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (u < HK * (DP / 4) && key < S && c < hd) {
          val[i][e] = *reinterpret_cast<const float4*>(src + key * rs + c);
        }
      }
    }
  }

  __device__ __forceinline__ void store(uint8_t* hi, uint8_t* lo,
                                        int pid) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int u = pid + 128 * i, hk = u % HK, c = (u / HK) * 4;
      if (u >= HK * (DP / 4)) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {             // column c + e: a v^T row
        uint4 h, l;
        split_tf32(lane_of(val[i][0], e), h.x, l.x);
        split_tf32(lane_of(val[i][1], e), h.y, l.y);
        split_tf32(lane_of(val[i][2], e), h.z, l.z);
        split_tf32(lane_of(val[i][3], e), h.w, l.w);
        const uint32_t off = kmajor_off<VW>(DP, c + e, 4 * hk);
        *reinterpret_cast<uint4*>(hi + off) = h;
        *reinterpret_cast<uint4*>(lo + off) = l;
      }
    }
  }
};

}  // namespace ptt
