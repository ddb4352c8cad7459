// Tiled bf16 GEMM with a fused epilogue: C = epi(A @ B + bias).
//
// The matrix products inside the TPU kernels K1 (skyrim_tpu/ops/fused_block.py
// _fused_block_kernel: qkv, proj, both MLP layers), K3 (ops/resample.py
// _down_kernel) and K4 (_up_kernel) run here.  A is (M, K) row-major bf16, B is
// the Dense kernel (K, N) row-major bf16 (flax layout, x @ W), bias is f32 (N,),
// accumulation is f32 on the tensor cores (WMMA 16x16x16 bf16 -> mma.sync).
//
// Epilogues, in f32 before the single bf16 store:
//   0: acc + bias
//   1: gelu_tanh(bf16(acc + bias))           (flax nn.gelu on the compute dtype)
//   2: bf16(acc + bias) + residual            (the block's residual adds)
//
// Bound on this card: an (M,K)@(K,N) product with M >> K,N does 2MKN flops on
// 2M(K+N) bytes of activations, K*N/(K+N) flops per byte: 96 to 307 at Pangu's
// widths, around the H100's ridge of ~295, so the narrow products lean on
// bandwidth and the wide ones on the tensor cores.  Design: 128 x BN x 32 block tiles, 8 warps
// (4 x 2), each warp a 32 x BN/2 tile of 16x16 fragments; two-stage cp.async
// double buffer so the next K-slab loads while the tensor cores work; the
// epilogue goes through a per-warp 16x16 f32 scratch so bias, activation and
// residual are applied with 16-byte vector accesses.  Ragged M, N and K edges
// are zero-filled on load and masked on store (N % 8 == 0, K % 8 == 0).
// Not yet wgmma/TMA: a later PR's work.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 128, BK = 32, THREADS = 256;

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

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(k * (x + 0.044715f * x * x * x)));
}

template <int BN>
__global__ void __launch_bounds__(THREADS)
    gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                     const float* __restrict__ bias, const bf16* __restrict__ R,
                     bf16* __restrict__ C, int M, int N, int K, int epi) {
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
      const int gr = m0 + r, gk = k0 + kc;
      const bool ok = gr < M && gk < K;
      cp_async16(&As[s][r * LDA + kc], ok ? A + (size_t)gr * K + gk : A, ok);
    }
    for (int c = tid; c < BK * (BN / 8); c += THREADS) {
      const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
      const int gk = k0 + r, gn = n0 + nc;
      const bool ok = gk < K && gn < N;
      cp_async16(&Bs[s][r * LDB + nc], ok ? B + (size_t)gk * N + gn : B, ok);
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
        for (int u = 0; u < 8; ++u) v[u] = scratch[r * LDS + c0 + u] + bias[gc + u];
        if (epi == 1) {
#pragma unroll
          for (int u = 0; u < 8; ++u) v[u] = gelu_tanh(bf16_round(v[u]));
        } else if (epi == 2) {
          float res[8];
          load8(R + (size_t)gr * N + gc, res);
#pragma unroll
          for (int u = 0; u < 8; ++u) v[u] = bf16_round(v[u]) + res[u];
        }
        store8(C + (size_t)gr * N + gc, v);
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" int skt_gemm_bf16(const void* A, const void* B, const void* bias, const void* R,
                             void* C, int M, int N, int K, int epi, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(THREADS);
  if (N % 128 == 0) {
    const dim3 grid(N / 128, (M + BM - 1) / BM);
    gemm_bf16_kernel<128><<<grid, block, 0, st>>>(
        static_cast<const bf16*>(A), static_cast<const bf16*>(B), static_cast<const float*>(bias),
        static_cast<const bf16*>(R), static_cast<bf16*>(C), M, N, K, epi);
  } else {
    const dim3 grid((N + 63) / 64, (M + BM - 1) / BM);
    gemm_bf16_kernel<64><<<grid, block, 0, st>>>(
        static_cast<const bf16*>(A), static_cast<const bf16*>(B), static_cast<const float*>(bias),
        static_cast<const bf16*>(R), static_cast<bf16*>(C), M, N, K, epi);
  }
  return static_cast<int>(cudaGetLastError());
}
