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

// One warp layer-normalizes one row of `width` bf16 values (width % 8 == 0)
// and writes it as bf16.  `chunk(v)` points at the v-th group of 8 input
// values, so callers gather rows by index math.  Flax numerics: f32
// statistics, fast variance E[x^2] - E[x]^2 clipped at 0, f32 affine.
template <class Chunk>
__device__ __forceinline__ void layernorm_row_warp(Chunk chunk, const float* __restrict__ scale,
                                                   const float* __restrict__ bias,
                                                   bf16* __restrict__ out, int width, float eps) {
  const int lane = threadIdx.x & 31;
  const int nv = width / 8;
  float s = 0.f, s2 = 0.f;
  for (int v = lane; v < nv; v += 32) {
    float f[8];
    load8(chunk(v), f);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      s += f[u];
      s2 += f[u] * f[u];
    }
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mu = s / width;
  const float inv = rsqrtf(fmaxf(s2 / width - mu * mu, 0.f) + eps);
  for (int v = lane; v < nv; v += 32) {
    float f[8];
    load8(chunk(v), f);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = v * 8 + u;
      f[u] = (f[u] - mu) * inv * scale[c] + bias[c];
    }
    store8(out + v * 8, f);
  }
}
