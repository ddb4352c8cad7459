// Row-GEMM building blocks: the tiled GEMM of every port kernel that
// multiplies (Pangu's K1, K3, K4 through gemm.cu; GraphCast's K6-K9; K12-K14
// in graph_finish.cu), and the row kernels the GraphCast kernels share.
//
// The four GraphCast TPU kernels (skyrim_tpu/ops/fused_mlp.py fused_mlp and
// ops/graph_kernels.py fused_round_messages / fused_m2g_tiled /
// fused_g2m_tiled) all run rows through "prologue -> Dense -> epilogue ->
// LayerNorm -> aggregate".  At L = 512 the two 512x512 bf16 weights (1 MB) do
// not fit the 227 KB of shared memory a Hopper block has, so each is a short
// chain of launches of the three kernels here:
//
//   rowgemm_kernel  C = epi(A @ W): a tiled bf16 GEMM (f32 accumulation on the
//                   tensor cores, WMMA -> mma.sync, 128 x BN x 32 tiles, 8
//                   warps, two-stage shared-memory ring) whose A tile comes
//                   from a loader functor (plain rows with cp.async, strided or
//                   unaligned rows, or a computed prologue such as a gather +
//                   swish) and whose f32 results go to an epilogue functor.
//   ln_rows_kernel  one warp per output row: out = bf16([res +] sum_k
//                   bf16(LN(y[row * nsum + k]))), sum in f32, nsum 1 to 4,
//                   through common.cuh's layernorm_rows_warp; also Pangu's
//                   LayerNorm (fused_block.cu, nsum 1).
//   segsum_kernel   out[g, s, :] = sum of the rows r of group g with
//                   local[g, r] == s, in f32, in row order (deterministic),
//                   then bf16; local values outside [0, S) are skipped.  One
//                   block per (group, 128 columns), the S x 128 f32 sums in
//                   shared memory, each thread owning one column.
//
// Not yet wgmma/TMA, and the intermediates between the launches round-trip
// device memory: later work.
#pragma once

#include <math.h>
#include <mma.h>

#include "common.cuh"

namespace rowgemm {

using namespace nvcuda;

constexpr int BM = 128, BK = 32, THREADS = 256;
constexpr int SEG_COLS = 128;  // columns per segsum block (one per thread)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float swish(float x) { return x / (1.f + expf(-x)); }

enum Act { ACT_NONE = 0, ACT_SWISH = 1 };

// A as rows: element (m, k) of the first part at a1[m * s1m + k * s1k] for
// k < K1, then a second row-major part a2 (M, K2) for K1 <= k < K1 + K2 (the
// split first layer: x @ W[:K1] + x2 @ W[K1:] into one accumulator, the concat
// never built).  VEC: both parts are 16-byte aligned rows (s1k == 1, s1m, K1,
// K2 multiples of 8) and load with cp.async; otherwise element loads
// (feature-major input, or rows of 174, 3 or 4 values).
template <bool VEC>
struct ARows {
  const bf16* a1;
  long long s1m, s1k;
  int K1;
  const bf16* a2;
  int K2;
  int M;

  __device__ __forceinline__ void chunk(int row, int k, bf16* dst) const {
    const int K = K1 + K2;
    if (VEC) {
      const bool ok = row < M && k < K;
      const bf16* src = a1;
      if (ok) src = k < K1 ? a1 + row * s1m + k : a2 + (long long)row * K2 + (k - K1);
      cp_async16(dst, src, ok);
      return;
    }
    float f[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int kk = k + u;
      float v = 0.f;
      if (row < M && kk < K1)
        v = __bfloat162float(a1[row * s1m + kk * s1k]);
      else if (row < M && kk < K)
        v = __bfloat162float(a2[(long long)row * K2 + (kk - K1)]);
      f[u] = v;
    }
    store8(dst, f);
  }
};

// W (K, N) row-major bf16 (flax Dense layout); cp.async when N % 8 == 0.
__device__ __forceinline__ void load_b_chunk(const bf16* W, int K, int N, int k, int n, bf16* dst) {
  if ((N & 7) == 0) {
    const bool ok = k < K && n < N;
    cp_async16(dst, ok ? W + (size_t)k * N + n : W, ok);
    return;
  }
  float f[8];
#pragma unroll
  for (int u = 0; u < 8; ++u)
    f[u] = (k < K && n + u < N) ? __bfloat162float(W[(size_t)k * N + n + u]) : 0.f;
  store8(dst, f);
}

// Store 8 (or the nv valid of 8) f32 values as bf16 at out[row * N + col].
__device__ __forceinline__ void store_out(bf16* out, int N, int row, int col, const float* v,
                                          int nv) {
  bf16* p = out + (size_t)row * N + col;
  if (nv == 8 && (N & 7) == 0) {
    store8(p, v);
  } else {
    for (int u = 0; u < nv; ++u) p[u] = __float2bfloat16(v[u]);
  }
}

// out = bf16(act(acc + bias)), or bf16(bf16(acc + bias) + res) with a
// residual; ACT_SWISH acts on the f32 value, as GraphCast's MLPs do.
struct EpiStore {
  const float* bias;
  const bf16* res;
  bf16* out;
  int N;
  int act;

  __device__ __forceinline__ void operator()(int row, int col, float* v, int nv) const {
    float r[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (res) {
      if (nv == 8 && (N & 7) == 0) {  // 16-byte rows: one vector load
        load8(res + (size_t)row * N + col, r);
      } else {
        for (int u = 0; u < nv; ++u) r[u] = __bfloat162float(res[(size_t)row * N + col + u]);
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float t = v[u] + (u < nv ? bias[col + u] : 0.f);
      if (act == ACT_SWISH) t = swish(t);
      if (res) t = bf16_round(t) + r[u];
      v[u] = t;
    }
    store_out(out, N, row, col, v, nv);
  }
};

// C[M, N] = epi(A[M, K] @ W[K, N]).  grid (ceil(N / BN), ceil(M / BM)): the
// N tiles of one row block run side by side, so its A tile (or computed
// prologue) is read from device memory once and from L2 after.
template <int BN, class ALoad, class Epi>
__global__ void __launch_bounds__(THREADS)
    rowgemm_kernel(ALoad aload, const bf16* __restrict__ W, Epi epi, int M, int N, int K) {
  constexpr int WM = 32, WN = BN / 2, FM = WM / 16, FN = WN / 16;
  constexpr int LDA = BK + 8, LDB = BN + 8;  // +8 bf16 of padding against bank conflicts
  __shared__ __align__(128) bf16 As[2][BM * LDA];
  __shared__ __align__(128) bf16 Bs[2][BK * LDB];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  auto load_tile = [&](int kt, int s) {
    const int k0 = kt * BK;
    for (int c = tid; c < BM * (BK / 8); c += THREADS) {
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      aload.chunk(m0 + r, k0 + kc, &As[s][r * LDA + kc]);
    }
    for (int c = tid; c < BK * (BN / 8); c += THREADS) {
      const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
      load_b_chunk(W, K, N, k0 + r, n0 + nc, &Bs[s][r * LDB + nc]);
    }
    cp_async_commit();
  };

  const int nk = (K + BK - 1) / BK;
  load_tile(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < nk) {
      load_tile(kt + 1, s ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], &As[s][(wm * WM + i * 16) * LDA + kk], LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], &Bs[s][kk * LDB + wn * WN + j * 16], LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each fragment through a per-warp 16 x 16 f32 scratch (in As,
  // free after the last barrier); a lane owns 8 consecutive columns of a row
  constexpr int LDS = 20;
  float* scratch = reinterpret_cast<float*>(&As[0][0]) + warp * (16 * LDS);
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], LDS, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + wm * WM + i * 16 + r;
      const int gc = n0 + wn * WN + j * 16 + c0;
      if (gr < M && gc < N) {
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = scratch[r * LDS + c0 + u];
        epi(gr, gc, v, min(8, N - gc));
      }
      __syncwarp();
    }
  }
}

template <class ALoad, class Epi>
int launch_rowgemm(const ALoad& aload, const void* W, const Epi& epi, int M, int N, int K,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* w = static_cast<const bf16*>(W);
  const int mb = (M + BM - 1) / BM;
  if (mb > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);  // grid.y limit
  if (N % 128 == 0) {
    rowgemm_kernel<128><<<dim3(N / 128, mb), THREADS, 0, st>>>(aload, w, epi, M, N, K);
  } else {
    rowgemm_kernel<64><<<dim3((N + 63) / 64, mb), THREADS, 0, st>>>(aload, w, epi, M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[row] = bf16([res[row] +] sum_{k < NSUM} bf16(LN(y[row * NSUM + k]))),
// one warp per output row, C % 8 == 0; out may be y when NSUM == 1.
template <int NSUM>
__global__ void ln_rows_kernel(const bf16* y, const float* __restrict__ scale,
                               const float* __restrict__ bias, const bf16* __restrict__ res,
                               bf16* out, int rows, int C, float eps) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const bf16* yr = y + (size_t)row * NSUM * C;
  const bf16* rr = res ? res + (size_t)row * C : nullptr;
  bf16* orow = out + (size_t)row * C;
  layernorm_rows_warp<NSUM>([&](int k, int v) { return yr + (size_t)k * C + v * 8; }, scale, bias,
                            C, eps, [&](int v, float* o) {
                        if (rr) {
                          float r8[8];
                          load8(rr + v * 8, r8);
#pragma unroll
                          for (int u = 0; u < 8; ++u) o[u] = bf16_round(o[u]) + r8[u];
                        }
                        store8(orow + v * 8, o);
                      });
}

inline int launch_ln_rows(const void* y, const void* scale, const void* bias, const void* res,
                          void* out, int rows, int C, int nsum, float eps, void* stream) {
  const int warps = 8;
  const dim3 grid((rows + warps - 1) / warps), block(warps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16 *yb = static_cast<const bf16*>(y), *rb = static_cast<const bf16*>(res);
  const float *sf = static_cast<const float*>(scale), *bf = static_cast<const float*>(bias);
  bf16* ob = static_cast<bf16*>(out);
  switch (nsum) {  // 1: every LayerNorm but K8's and K13's; 3: their triangle slots
    case 1: ln_rows_kernel<1><<<grid, block, 0, st>>>(yb, sf, bf, rb, ob, rows, C, eps); break;
    case 2: ln_rows_kernel<2><<<grid, block, 0, st>>>(yb, sf, bf, rb, ob, rows, C, eps); break;
    case 3: ln_rows_kernel<3><<<grid, block, 0, st>>>(yb, sf, bf, rb, ob, rows, C, eps); break;
    case 4: ln_rows_kernel<4><<<grid, block, 0, st>>>(yb, sf, bf, rb, ob, rows, C, eps); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// out (G, S, C) bf16; x (G * R, C) bf16; local (G, R) int32.
__global__ void __launch_bounds__(SEG_COLS)
    segsum_kernel(const bf16* __restrict__ x, const int* __restrict__ local,
                  bf16* __restrict__ out, int R, int S, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);  // S x SEG_COLS
  int* loc = reinterpret_cast<int*>(acc + (size_t)S * SEG_COLS);  // R
  const int g = blockIdx.x, t = threadIdx.x;
  const int c = blockIdx.y * SEG_COLS + t;
  for (int i = t; i < S * SEG_COLS; i += SEG_COLS) acc[i] = 0.f;
  for (int i = t; i < R; i += SEG_COLS) loc[i] = local[(size_t)g * R + i];
  __syncthreads();
  if (c < C) {
    const bf16* xg = x + (size_t)g * R * C + c;
    constexpr int U = 8;
    int r = 0;
    for (; r + U <= R; r += U) {
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = __bfloat162float(xg[(size_t)(r + u) * C]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int s = loc[r + u];
        if ((unsigned)s < (unsigned)S) acc[s * SEG_COLS + t] += v[u];
      }
    }
    for (; r < R; ++r) {
      const int s = loc[r];
      if ((unsigned)s < (unsigned)S) acc[s * SEG_COLS + t] += __bfloat162float(xg[(size_t)r * C]);
    }
    for (int s = 0; s < S; ++s)
      out[((size_t)g * S + s) * C + c] = __float2bfloat16(acc[s * SEG_COLS + t]);
  }
}

// A too large S x SEG_COLS table fails cudaFuncSetAttribute; the error is
// returned to the wrapper, which raises.
inline int launch_segsum(const void* x, const void* local, void* out, int G, int R, int S, int C,
                         void* stream) {
  const size_t smem = (size_t)S * SEG_COLS * 4 + (size_t)R * 4;
  cudaError_t err = cudaFuncSetAttribute(segsum_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(G, (C + SEG_COLS - 1) / SEG_COLS);
  segsum_kernel<<<grid, SEG_COLS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const int*>(local), static_cast<bf16*>(out), R, S,
      C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rowgemm
