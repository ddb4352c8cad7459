// K12, K13, K14: the finish and the untiled message kernels, as A loaders on
// the row GEMM of rowgemm.cuh.
//
// Replace skyrim_tpu/ops/fused_mlp.py fused_finish (Pallas body
// _finish_kernel) and skyrim_tpu/ops/graph_kernels.py
// fused_fixed_degree_messages (_m2g_kernel) and fused_block_messages
// (_g2m_kernel).  With finish(h) = LN(bf16(bf16(swish(h + b0)) @ W + b)),
// swish in f32:
//   K12  out[m]    = finish(x[m]);  W (L, Cout), Cout may differ from L
//   K13  out[m]    = bf16(sum_k finish(wide[m, k] + bias_w[m, k] + ad[m])), f32
//                    sum over the deg lane slices of the (N, deg * L) rows
//   K14  out[b, s] = bf16(sum of finish(src[b, r] + bias[b, r]) over the rows r
//                    of block b with local[b, r] == s), f32 in row order;
//                    local == SB marks a padding row, which never aggregates
// The TPU kernels hold a row tile and the weight in VMEM and K14 aggregates
// with a one-hot matmul; here the GEMM's A loader computes the swish prologue
// from the source rows, and the LayerNorm rows kernel (summing K13's slots)
// and the segmented sum (K14) of rowgemm.cuh follow as launches of their own:
//   K12  skt_finish_gemm, skt_ln_rows
//   K13  skt_fixed_degree_gemm (GEMM row q = m * deg + k), skt_ln_rows, nsum deg
//   K14  skt_finish_gemm with the bias rows, skt_ln_rows, skt_segment_sum
// (skt_ln_rows and skt_segment_sum are fused_mlp.cu's).
//
// Bounds on this card, at GraphCast's full width (L = 512): K12 over the
// 1,038,240 grid rows moves 2.13 GB (0.63 ms at 3.35 TB/s, bytes; 0.54 TFLOP);
// K13 over the same rows with deg 3 moves 8.5 GB (2.54 ms, bytes; 1.63 TFLOP);
// K14 over the grid->mesh block plan moves 3.4 GB (1.0 ms, bytes; 0.85 TFLOP on
// the real rows).
#include "rowgemm.cuh"

namespace {

// swish(x[m, k] + add[m, k] + b0[k]), add optional; rows of L % 8 == 0 values.
struct AFinish {
  const bf16* x;    // (M, L)
  const bf16* add;  // (M, L) or null
  const float* b0;  // (L,)
  int M, L;

  __device__ __forceinline__ void chunk(int m, int kk, bf16* dst) const {
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (m < M && kk < L) {
      float x8[8], a8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      load8(x + (size_t)m * L + kk, x8);
      if (add) load8(add + (size_t)m * L + kk, a8);
#pragma unroll
      for (int u = 0; u < 8; ++u) f[u] = rowgemm::swish(x8[u] + a8[u] + b0[kk + u]);
    }
    store8(dst, f);
  }
};

// GEMM row q = m * deg + k: swish(wide[m, k*L + c] + bias[m, k*L + c] + ad[m, c] + b0[c]).
struct AFixedDegree {
  const bf16* wide;  // (N, deg * L)
  const bf16* bias;  // (N, deg * L)
  const bf16* ad;    // (N, L)
  const float* b0;   // (L,)
  int rows, L, deg;

  __device__ __forceinline__ void chunk(int q, int kk, bf16* dst) const {
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (q < rows && kk < L) {
      const int m = q / deg;
      const size_t wide_at = (size_t)q * L + kk;  // == m * deg * L + k * L + kk
      float w8[8], b8[8], a8[8];
      load8(wide + wide_at, w8);
      load8(bias + wide_at, b8);
      load8(ad + (size_t)m * L + kk, a8);
#pragma unroll
      for (int u = 0; u < 8; ++u) f[u] = rowgemm::swish(w8[u] + b8[u] + a8[u] + b0[kk + u]);
    }
    store8(dst, f);
  }
};

}  // namespace

extern "C" int skt_finish_gemm(const void* x, const void* add, const void* b0, const void* W,
                               const void* b, void* out, int M, int L, int Cout, void* stream) {
  AFinish a{static_cast<const bf16*>(x), static_cast<const bf16*>(add),
            static_cast<const float*>(b0), M, L};
  rowgemm::EpiStore epi{static_cast<const float*>(b), nullptr, static_cast<bf16*>(out), Cout,
                        rowgemm::ACT_NONE};
  return rowgemm::launch_rowgemm(a, W, epi, M, Cout, L, stream);
}

extern "C" int skt_fixed_degree_gemm(const void* wide, const void* bias, const void* ad,
                                     const void* b0, const void* W, const void* b, void* out,
                                     int N, int L, int deg, void* stream) {
  AFixedDegree a{static_cast<const bf16*>(wide), static_cast<const bf16*>(bias),
                 static_cast<const bf16*>(ad), static_cast<const float*>(b0), N * deg, L, deg};
  rowgemm::EpiStore epi{static_cast<const float*>(b), nullptr, static_cast<bf16*>(out), L,
                        rowgemm::ACT_NONE};
  return rowgemm::launch_rowgemm(a, W, epi, N * deg, L, L, stream);
}
