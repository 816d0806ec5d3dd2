// Training BatchNorm for Hopper (sm_90a): the four passes of the
// reference's streaming BN over an activation viewed as [N, C, S] (S the
// product of the spatial dims), in bf16, f16 or f32, with f32 sums.
//
// Replaces: paddle_tpu/ops/bn_pallas.py, its four pallas_calls:
//   1. stats  `_stats_call` :117 (`_stats_kernel` :34): per channel the
//      f32 sums of x and x*x over N and S;
//   2. apply  `_apply_call` :136 (`_apply_kernel` :51): y = x*scale[c] +
//      shift[c], optional relu, cast to x's dtype;
//   3. gsum   `_gsum_call` :149 (`_gsum_kernel` :59): per channel the
//      sums of dy and dy*x, dy first masked on y > 0 when relu is on
//      (the custom VJP's `jnp.where`, :227-229);
//   4. dx     `_dx_call` :162 (`_dx_kernel` :77): dx = A[c]*dy + B[c]*x +
//      D[c] (dy masked as in 3).
// The [C]-sized math between them (mean, var, rstd, scale, shift, A, B,
// D, dgamma, dbeta) stays in PyTorch, as it is XLA in the reference.
//
// Bound on an H100 SXM (3.35 TB/s): every pass is a stream over the
// activation with a few flops per element, so each is bound by BYTES:
// stats reads x (2 bytes a value in bf16), apply reads x and writes y
// (4), gsum reads dy and x (4), dx reads dy and x and writes dx (6).
// ResNet-50 at batch 256 holds 2.85 G BN values a step: 45.5 GB, ~13.6
// ms. The design keeps each pass at one read (+ one write):
//  - 16-byte vector loads and stores where S and the pointers allow
//    (8 bf16/f16 or 4 f32 values; else 8, 4 or 2 bytes; else scalar),
//    the f32 conversion in registers (no f32 copy of the activation);
//  - the relu mask of the backward is recomputed from x and the saved
//    scale/shift with the forward's exact operations (the same bits of
//    y), so gsum and dx never read y;
//  - SUMS WITHOUT A CARRIED GRID AND WITHOUT ATOMICS: the TPU kernel
//    accumulates over a sequential batch axis; here the blocks of a
//    channel run in no order, so each (channel, chunk) block writes its
//    f32 partial sums (a fixed-order block reduction), and a second
//    small pass adds a channel's partials in chunk order. The number of
//    chunks depends only on the shape (chosen by the caller to give the
//    132 SMs ~1000 blocks: the stem's 64 channels of 3.2 M values each
//    take 17 chunks, layer4's 2048 channels one), so two runs give the
//    same bits;
//  - the elementwise passes (apply, dx) run a grid-stride loop over the
//    whole tensor; a vector's channel comes from two integer divisions
//    by precomputed magic numbers (multiply-high and shift).
// Every f32 operation of apply and dx is an explicitly rounded
// intrinsic (no FMA contraction), so the plain PyTorch versions, which
// run the same operations one by one, give the same bits.
// Each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void put(__half* p, float x) {
  *p = __float2half_rn(x);
}

// V consecutive values, loaded and stored as one aligned access.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// n / d for 0 <= n < 2^31 by multiply-high and shift (the magic number
// of Granlund and Montgomery, as PyTorch's IntDivider computes it).
struct FastDiv {
  unsigned d, m, s;
  __host__ static FastDiv make(unsigned d) {
    unsigned s = 0;
    while (s < 32 && (1ull << s) < d) ++s;
    const unsigned long long one = 1;
    const unsigned long long m = ((one << 32) * ((one << s) - d)) / d + 1;
    return FastDiv{d, static_cast<unsigned>(m), s};
  }
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return (__umulhi(n, m) + n) >> s;
  }
};

// Geometry of one call: x viewed as [N, C, SV] vectors of V values.
struct Geo {
  int C;
  int SV;            // vectors per (n, c) row: S / V
  FastDiv by_sv;     // divide by SV
  FastDiv by_c;      // divide by C
};

// y of the apply pass in f32 before its cast: x * scale + shift, relu.
__device__ __forceinline__ float bn_y(float x, float sc, float sh, int relu) {
  float y = __fadd_rn(__fmul_rn(x, sc), sh);
  if (relu && y < 0.f) y = 0.f;
  return y;
}

// The relu mask of the backward: whether the apply pass stored y > 0
// (the same operations and the same rounding to T as bn_apply_kernel).
template <typename T>
__device__ __forceinline__ bool y_positive(float x, float sc, float sh) {
  T y;
  put(&y, bn_y(x, sc, sh, 1));
  return to_f32(y) > 0.f;
}

// The sums of a and b over the block, in thread 0, in a fixed order: a
// shuffle tree inside each warp, then the warps' sums in warp order.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float wa[kThreads / 32];
  __shared__ float wb[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    wa[warp] = a;
    wb[warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = wa[0];
    b = wb[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) {
      a += wa[w];
      b += wb[w];
    }
  }
}

// Block (c, p) covers vectors [p * L, (p + 1) * L) of channel c's N * SV
// and writes its partial sums to part[c * P + p] and part[(C + c) * P +
// p]. Kernel 1 (kGrad false): sums of x and x*x. Kernel 3 (kGrad true):
// sums of dy and dy*x, dy masked on y > 0 when relu.
template <typename T, int V, bool kGrad>
__global__ void __launch_bounds__(kThreads)
bn_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  const float* __restrict__ scale,
                  const float* __restrict__ shift, float* __restrict__ part,
                  Geo g, int M, int L, int relu) {
  const int c = blockIdx.x;
  const int p = blockIdx.y;
  const int P = gridDim.y;
  const int end = min(M, (p + 1) * L);
  const float sc = relu ? scale[c] : 0.f;
  const float sh = relu ? shift[c] : 0.f;
  float a = 0.f;
  float b = 0.f;
  for (int i = p * L + threadIdx.x; i < end; i += kThreads) {
    const int n = static_cast<int>(g.by_sv.div(static_cast<unsigned>(i)));
    const long long off =
        ((long long)n * g.C + c) * g.SV + (i - n * g.SV);
    const Pack<T, V> xv = reinterpret_cast<const Pack<T, V>*>(x)[off];
    if (!kGrad) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float f = to_f32(xv.v[e]);
        a += f;
        b = fmaf(f, f, b);
      }
    } else {
      const Pack<T, V> dv = reinterpret_cast<const Pack<T, V>*>(dy)[off];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float f = to_f32(xv.v[e]);
        float d = to_f32(dv.v[e]);
        if (relu && !y_positive<T>(f, sc, sh)) d = 0.f;
        a += d;
        b = fmaf(d, f, b);
      }
    }
  }
  block_sum2(a, b);
  if (threadIdx.x == 0) {
    part[(long long)c * P + p] = a;
    part[(long long)(g.C + c) * P + p] = b;
  }
}

// The second pass: channel c's partials added in chunk order.
__global__ void bn_sum_partials_kernel(const float* __restrict__ part,
                                       float* __restrict__ out1,
                                       float* __restrict__ out2, int C,
                                       int P) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const float* p1 = part + (long long)c * P;
  const float* p2 = part + (long long)(C + c) * P;
  float a = 0.f;
  float b = 0.f;
  for (int p = 0; p < P; ++p) {
    a += p1[p];
    b += p2[p];
  }
  out1[c] = a;
  out2[c] = b;
}

// Kernel 2: y = x * scale[c] + shift[c] (relu), in x's dtype.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_apply_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ shift, T* __restrict__ y, Geo g,
                int total, int relu) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < total;
       i += gridDim.x * kThreads) {
    const unsigned row = g.by_sv.div(static_cast<unsigned>(i));
    const int c = static_cast<int>(row - g.by_c.div(row) * g.C);
    const float sc = scale[c];
    const float sh = shift[c];
    const Pack<T, V> xv = reinterpret_cast<const Pack<T, V>*>(x)[i];
    Pack<T, V> yv;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      put(&yv.v[e], bn_y(to_f32(xv.v[e]), sc, sh, relu));
    }
    reinterpret_cast<Pack<T, V>*>(y)[i] = yv;
  }
}

// Kernel 4: dx = A[c] * dy + B[c] * x + D[c] (dy masked when relu), in
// x's dtype.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_dx_kernel(const T* __restrict__ dy, const T* __restrict__ x,
             const float* __restrict__ A, const float* __restrict__ B,
             const float* __restrict__ D, const float* __restrict__ scale,
             const float* __restrict__ shift, T* __restrict__ dx, Geo g,
             int total, int relu) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < total;
       i += gridDim.x * kThreads) {
    const unsigned row = g.by_sv.div(static_cast<unsigned>(i));
    const int c = static_cast<int>(row - g.by_c.div(row) * g.C);
    const float a = A[c];
    const float b = B[c];
    const float d = D[c];
    const float sc = relu ? scale[c] : 0.f;
    const float sh = relu ? shift[c] : 0.f;
    const Pack<T, V> dv = reinterpret_cast<const Pack<T, V>*>(dy)[i];
    const Pack<T, V> xv = reinterpret_cast<const Pack<T, V>*>(x)[i];
    Pack<T, V> out;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float xf = to_f32(xv.v[e]);
      float df = to_f32(dv.v[e]);
      if (relu && !y_positive<T>(xf, sc, sh)) df = 0.f;
      put(&out.v[e],
          __fadd_rn(__fadd_rn(__fmul_rn(df, a), __fmul_rn(xf, b)), d));
    }
    reinterpret_cast<Pack<T, V>*>(dx)[i] = out;
  }
}

// The widest vector (values) that divides S and keeps every pointer
// aligned: 16 bytes down to one value.
template <typename T>
int vector_width(long long S, const void* const* ptrs, int nptrs) {
  for (int V = 16 / static_cast<int>(sizeof(T)); V > 1; V >>= 1) {
    bool ok = S % V == 0;
    for (int i = 0; i < nptrs && ok; ++i) {
      ok = reinterpret_cast<uintptr_t>(ptrs[i]) % (V * sizeof(T)) == 0;
    }
    if (ok) return V;
  }
  return 1;
}

Geo geometry(int C, long long S, int V) {
  const int SV = static_cast<int>(S / V);
  return Geo{C, SV, FastDiv::make(SV), FastDiv::make(C)};
}

int elementwise_grid(int total) {
  const int blocks = (total + kThreads - 1) / kThreads;
  return blocks < 132 * 16 ? blocks : 132 * 16;
}

template <typename T, int V>
cudaError_t partial_sums(const void* x, const void* dy, const float* scale,
                         const float* shift, float* part, float* out1,
                         float* out2, int N, int C, long long S, int P,
                         int relu, cudaStream_t stream) {
  const Geo g = geometry(C, S, V);
  const int M = N * g.SV;
  const int L = (M + P - 1) / P;
  if (dy == nullptr) {
    bn_partial_kernel<T, V, false><<<dim3(C, P), kThreads, 0, stream>>>(
        static_cast<const T*>(x), nullptr, scale, shift, part, g, M, L, 0);
  } else {
    bn_partial_kernel<T, V, true><<<dim3(C, P), kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), scale, shift,
        part, g, M, L, relu);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_sum_partials_kernel<<<(C + 127) / 128, 128, 0, stream>>>(part, out1,
                                                              out2, C, P);
  return cudaGetLastError();
}

template <typename T>
cudaError_t partial_sums_any(const void* x, const void* dy,
                             const float* scale, const float* shift,
                             float* part, float* out1, float* out2, int N,
                             int C, long long S, int P, int relu,
                             cudaStream_t stream) {
  const void* ptrs[2] = {x, dy};
  switch (vector_width<T>(S, ptrs, dy ? 2 : 1)) {
    case 8:
      return partial_sums<T, 8>(x, dy, scale, shift, part, out1, out2, N, C,
                                S, P, relu, stream);
    case 4:
      return partial_sums<T, 4>(x, dy, scale, shift, part, out1, out2, N, C,
                                S, P, relu, stream);
    case 2:
      return partial_sums<T, 2>(x, dy, scale, shift, part, out1, out2, N, C,
                                S, P, relu, stream);
    default:
      return partial_sums<T, 1>(x, dy, scale, shift, part, out1, out2, N, C,
                                S, P, relu, stream);
  }
}

template <typename T, int V>
cudaError_t apply(const void* x, const float* scale, const float* shift,
                  void* y, int N, int C, long long S, int relu,
                  cudaStream_t stream) {
  const Geo g = geometry(C, S, V);
  const int total = N * C * g.SV;
  bn_apply_kernel<T, V><<<elementwise_grid(total), kThreads, 0, stream>>>(
      static_cast<const T*>(x), scale, shift, static_cast<T*>(y), g, total,
      relu);
  return cudaGetLastError();
}

template <typename T>
cudaError_t apply_any(const void* x, const float* scale, const float* shift,
                      void* y, int N, int C, long long S, int relu,
                      cudaStream_t stream) {
  const void* ptrs[2] = {x, y};
  switch (vector_width<T>(S, ptrs, 2)) {
    case 8:
      return apply<T, 8>(x, scale, shift, y, N, C, S, relu, stream);
    case 4:
      return apply<T, 4>(x, scale, shift, y, N, C, S, relu, stream);
    case 2:
      return apply<T, 2>(x, scale, shift, y, N, C, S, relu, stream);
    default:
      return apply<T, 1>(x, scale, shift, y, N, C, S, relu, stream);
  }
}

template <typename T, int V>
cudaError_t dx_pass(const void* dy, const void* x, const float* A,
                    const float* B, const float* D, const float* scale,
                    const float* shift, void* dx, int N, int C, long long S,
                    int relu, cudaStream_t stream) {
  const Geo g = geometry(C, S, V);
  const int total = N * C * g.SV;
  bn_dx_kernel<T, V><<<elementwise_grid(total), kThreads, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), A, B, D, scale,
      shift, static_cast<T*>(dx), g, total, relu);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dx_any(const void* dy, const void* x, const float* A,
                   const float* B, const float* D, const float* scale,
                   const float* shift, void* dx, int N, int C, long long S,
                   int relu, cudaStream_t stream) {
  const void* ptrs[3] = {dy, x, dx};
  switch (vector_width<T>(S, ptrs, 3)) {
    case 8:
      return dx_pass<T, 8>(dy, x, A, B, D, scale, shift, dx, N, C, S, relu,
                           stream);
    case 4:
      return dx_pass<T, 4>(dy, x, A, B, D, scale, shift, dx, N, C, S, relu,
                           stream);
    case 2:
      return dx_pass<T, 2>(dy, x, A, B, D, scale, shift, dx, N, C, S, relu,
                           stream);
    default:
      return dx_pass<T, 1>(dy, x, A, B, D, scale, shift, dx, N, C, S, relu,
                           stream);
  }
}

// N * C * S must stay below 2^31 (the wrapper checks): indices are int.
bool bad_shape(int N, int C, long long S, int P) {
  return N < 1 || C < 1 || S < 1 || P < 1 || P > 65535 ||
         (long long)N * C * S >= (1ll << 31);
}

}  // namespace

extern "C" {

// dtype: 0 = bfloat16, 1 = float16, 2 = float32. Every function returns
// a cudaError_t (0 = success).

// Kernel 1: s1[c] = sum x, s2[c] = sum x*x over N and S, through the
// scratch `part` ([2, C, P] f32, P chunks a channel).
int ptt_bn_stats(const void* x, float* part, float* s1, float* s2, int N,
                 int C, long long S, int P, int dtype, void* stream) {
  if (bad_shape(N, C, S, P)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return partial_sums_any<__nv_bfloat16>(x, nullptr, nullptr, nullptr,
                                             part, s1, s2, N, C, S, P, 0, st);
    case 1:
      return partial_sums_any<__half>(x, nullptr, nullptr, nullptr, part, s1,
                                      s2, N, C, S, P, 0, st);
    case 2:
      return partial_sums_any<float>(x, nullptr, nullptr, nullptr, part, s1,
                                     s2, N, C, S, P, 0, st);
  }
  return cudaErrorInvalidValue;
}

// Kernel 2: y = x * scale[c] + shift[c] (relu when relu != 0).
int ptt_bn_apply(const void* x, const float* scale, const float* shift,
                 void* y, int N, int C, long long S, int relu, int dtype,
                 void* stream) {
  if (bad_shape(N, C, S, 1)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return apply_any<__nv_bfloat16>(x, scale, shift, y, N, C, S, relu, st);
    case 1:
      return apply_any<__half>(x, scale, shift, y, N, C, S, relu, st);
    case 2:
      return apply_any<float>(x, scale, shift, y, N, C, S, relu, st);
  }
  return cudaErrorInvalidValue;
}

// Kernel 3: sdy[c] = sum dy, sdyx[c] = sum dy*x, dy masked on y > 0 (y
// recomputed from x, scale and shift) when relu != 0.
int ptt_bn_gsum(const void* dy, const void* x, const float* scale,
                const float* shift, float* part, float* sdy, float* sdyx,
                int N, int C, long long S, int P, int relu, int dtype,
                void* stream) {
  if (bad_shape(N, C, S, P)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return partial_sums_any<__nv_bfloat16>(x, dy, scale, shift, part, sdy,
                                             sdyx, N, C, S, P, relu, st);
    case 1:
      return partial_sums_any<__half>(x, dy, scale, shift, part, sdy, sdyx,
                                      N, C, S, P, relu, st);
    case 2:
      return partial_sums_any<float>(x, dy, scale, shift, part, sdy, sdyx, N,
                                     C, S, P, relu, st);
  }
  return cudaErrorInvalidValue;
}

// Kernel 4: dx = A[c] * dy + B[c] * x + D[c], dy masked as in kernel 3.
int ptt_bn_dx(const void* dy, const void* x, const float* A, const float* B,
              const float* D, const float* scale, const float* shift,
              void* dx, int N, int C, long long S, int relu, int dtype,
              void* stream) {
  if (bad_shape(N, C, S, 1)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dx_any<__nv_bfloat16>(dy, x, A, B, D, scale, shift, dx, N, C, S,
                                   relu, st);
    case 1:
      return dx_any<__half>(dy, x, A, B, D, scale, shift, dx, N, C, S, relu,
                            st);
    case 2:
      return dx_any<float>(dy, x, A, B, D, scale, shift, dx, N, C, S, relu,
                           st);
  }
  return cudaErrorInvalidValue;
}

const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
