// Shared helpers for the port's Hopper kernels (sm_90a).
//
// Every library built from a csrc/<name>.cu includes this header once and
// exports skt_error_string for the ctypes wrappers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

extern "C" const char* skt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Round through bf16, as the reference does where it casts an f32
// intermediate to the compute dtype.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// 8 bf16 values = one 16-byte access.
__device__ __forceinline__ void load8(const bf16* p, float* f) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void store8(bf16* p, const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// One warp layer-normalizes NSUM rows of `width` bf16 values each (width %
// 8 == 0) and hands the v-th group of 8 outputs to out(v, o), o[u] =
// sum_k bf16(LN(row k))[8v + u] in f32.  `chunk(k, v)` points at the v-th
// group of 8 values of row k, so callers gather rows by index math.  Flax
// numerics: f32 statistics, fast variance E[x^2] - E[x]^2 clipped at 0, f32
// affine.  The LayerNorm of every port kernel.  NSUM is a template argument:
// with a run-time count, Pangu's LayerNorm ran 19 % slower on an H100.
template <int NSUM, class Chunk, class Out>
__device__ __forceinline__ void layernorm_rows_warp(Chunk chunk, const float* __restrict__ scale,
                                                    const float* __restrict__ bias, int width,
                                                    float eps, Out out) {
  const int lane = threadIdx.x & 31;
  const int nv = width / 8;
  float mu[NSUM], inv[NSUM];
#pragma unroll
  for (int k = 0; k < NSUM; ++k) {
    float s = 0.f, s2 = 0.f;
    for (int v = lane; v < nv; v += 32) {
      float f[8];
      load8(chunk(k, v), f);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        s += f[u];
        s2 += f[u] * f[u];
      }
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    mu[k] = s / width;
    inv[k] = rsqrtf(fmaxf(s2 / width - mu[k] * mu[k], 0.f) + eps);
  }
  for (int v = lane; v < nv; v += 32) {
    float o[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < NSUM; ++k) {
      float f[8];
      load8(chunk(k, v), f);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int c = v * 8 + u;
        o[u] += bf16_round((f[u] - mu[k]) * inv[k] * scale[c] + bias[c]);
      }
    }
    out(v, o);
  }
}

// One row, written as bf16 to `out`.
template <class Chunk>
__device__ __forceinline__ void layernorm_row_warp(Chunk chunk, const float* __restrict__ scale,
                                                   const float* __restrict__ bias,
                                                   bf16* __restrict__ out, int width, float eps) {
  layernorm_rows_warp<1>([&](int, int v) { return chunk(v); }, scale, bias, width, eps,
                         [&](int v, const float* o) { store8(out + v * 8, o); });
}
