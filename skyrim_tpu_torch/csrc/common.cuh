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

// Streaming multiprocessors of the current device (persistent kernels size
// their grids by it).
inline int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
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

// 8 f32 values, or the first n of them and 0 for the rest: two 16-byte loads
// where all 8 are there and p is 16-byte aligned.
__device__ __forceinline__ void load8f(const float* p, int n, float* f) {
  if (n == 8 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const float4 lo = reinterpret_cast<const float4*>(p)[0], hi = reinterpret_cast<const float4*>(p)[1];
    f[0] = lo.x, f[1] = lo.y, f[2] = lo.z, f[3] = lo.w;
    f[4] = hi.x, f[5] = hi.y, f[6] = hi.z, f[7] = hi.w;
  } else {
#pragma unroll
    for (int u = 0; u < 8; ++u) f[u] = u < n ? p[u] : 0.f;
  }
}

__device__ __forceinline__ void store8(bf16* p, const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// --- asynchronous copies, tensor-core fragments ---------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const int n = pred ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)), "l"(gmem),
               "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.  Plain: thread l holds (row l / 4, columns
// 2 (l % 4), +1) of each matrix; .trans: (rows 2 (l % 4), +1, column l / 4).
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16 x 16, row-major fragments) * b (16 x 8), bf16 in, f32 out.
__device__ __forceinline__ void mma_16816(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                          unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

__device__ __forceinline__ float2 unpack_bf16(unsigned u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// Tensor-core accumulators give the 4 lanes of a quad 2 consecutive columns
// each of four 8-column tiles: x[t] = columns 2q, 2q + 1 of tile t in lane q.
// After two exchanges (with lane q ^ 2, then q ^ 1) lane q holds all 8 columns
// of tile q in v.
__device__ __forceinline__ void quad_transpose(const float (&x)[4][2], float (&v)[8]) {
  const unsigned full = 0xffffffffu;
  const bool b0 = threadIdx.x & 1, b1 = threadIdx.x & 2;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    // keep tiles 2 b1 and 2 b1 + 1 (a, b), send the other two to lane q ^ 2
    const float oa = b1 ? x[2][e] : x[0][e], ob = b1 ? x[3][e] : x[1][e];
    const float ra = __shfl_xor_sync(full, b1 ? x[0][e] : x[2][e], 2);
    const float rb = __shfl_xor_sync(full, b1 ? x[1][e] : x[3][e], 2);
    // keep tile 2 b1 + b0 = q, send the other (both halves) to lane q ^ 1
    const float k0 = b0 ? ob : oa, k1 = b0 ? rb : ra;  // tile q from lanes q, q ^ 2
    const float r0 = __shfl_xor_sync(full, b0 ? oa : ob, 1);  // ... from lane q ^ 1
    const float r1 = __shfl_xor_sync(full, b0 ? ra : rb, 1);  // ... from lane q ^ 3
    // slot p takes the value that came from lane p
    const float lo_a = b1 ? k1 : k0, lo_b = b1 ? r1 : r0;  // from lanes 0, 1: this lane's bit 0, the other
    const float hi_a = b1 ? k0 : k1, hi_b = b1 ? r0 : r1;  // from lanes 2, 3
    v[0 + e] = b0 ? lo_b : lo_a;
    v[2 + e] = b0 ? lo_a : lo_b;
    v[4 + e] = b0 ? hi_b : hi_a;
    v[6 + e] = b0 ? hi_a : hi_b;
  }
}

// One warp layer-normalizes a row of `width` bf16 values (width % 8 == 0)
// and hands the v-th group of 8 outputs to out(v, o), o[u] = bf16(LN(row)[8v
// + u]) held in f32.  `chunk(v)` points at the v-th group of 8 values.  Flax numerics:
// f32 statistics, fast variance E[x^2] - E[x]^2 clipped at 0, f32 affine.
template <class Chunk, class Out>
__device__ __forceinline__ void layernorm_rows_warp(Chunk chunk, const float* __restrict__ scale,
                                                    const float* __restrict__ bias, int width,
                                                    float eps, Out out) {
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
  const float mu = s / width, inv = rsqrtf(fmaxf(s2 / width - mu * mu, 0.f) + eps);
  for (int v = lane; v < nv; v += 32) {
    float o[8];
    load8(chunk(v), o);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = v * 8 + u;
      o[u] = bf16_round((o[u] - mu) * inv * scale[c] + bias[c]);
    }
    out(v, o);
  }
}
