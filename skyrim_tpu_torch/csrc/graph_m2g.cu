// K8: GraphCast's mesh->grid decoder messages over the face tiles.
//
// Replaces skyrim_tpu/ops/graph_kernels.py fused_m2g_tiled (Pallas body
// _m2g_tiled_kernel).  Per grid point p = (i, j) and slot k < 3:
//   row_k = uniq[i / th, j / tw, local_hw[i, j], k*L : (k+1)*L]
//   m_k   = LN(bf16(bf16(swish(row_k + bias[p, k] + ad[p] + b0)) @ W + b))
//   out[p] = bf16(sum_k m_k)   (f32 sum)
// The TPU kernel expands each tile's unique face rows with a one-hot matmul
// and relies on Pallas dropping the out-of-range rows of the partial tiles at
// the grid's edge (721 = 90 * 8 + 1, 1440 = 11 * 128 + 32).  Here the GEMM's
// A loader computes the swish prologue for GEMM row q = 3p + k straight from
// the tables (an indexed load of the face row), and rows exist only for real
// grid points, so partial tiles need no mask beyond the row bound M = 3 H W.
// Two launches: skt_m2g_gemm (here), skt_ln_rows with nsum = 3 (fused_mlp.cu).
//
// Bound on this card: bytes.  At full width the product is
// 2 * 3 * H * W * L^2 = 1.63 TFLOP (1.65 ms at 989 TFLOP/s) on 5.96 GB of
// tiles, bias, dst rows and output (1.78 ms at 3.35 TB/s).
#include "rowgemm.cuh"

namespace {

struct AM2G {
  const bf16* uniq;   // (TH, TW, U, 3L)
  const int* local;   // (H, W)
  const bf16* bias;   // (H, W, 3L)
  const bf16* ad;     // (H, W, L)
  const float* b0;    // (L,)
  int H, W, L, U, th, tw, TW;

  __device__ __forceinline__ void chunk(int q, int kk, bf16* dst) const {
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (q < 3 * H * W && kk < L) {
      const int p = q / 3, k = q % 3;
      const int i = p / W, j = p % W;
      const size_t t = (size_t)(i / th) * TW + j / tw;
      const size_t kl = (size_t)k * L + kk;
      float u8[8], b8[8], a8[8];
      load8(uniq + (t * U + local[p]) * 3 * L + kl, u8);
      load8(bias + (size_t)p * 3 * L + kl, b8);
      load8(ad + (size_t)p * L + kk, a8);
#pragma unroll
      for (int u = 0; u < 8; ++u) f[u] = rowgemm::swish(u8[u] + b8[u] + a8[u] + b0[kk + u]);
    }
    store8(dst, f);
  }
};

}  // namespace

extern "C" int skt_m2g_gemm(const void* uniq, const void* local, const void* bias, const void* ad,
                            const void* b0, const void* W, const void* b, void* out, int H, int Wd,
                            int L, int U, int th, int tw, int TW, void* stream) {
  AM2G a{static_cast<const bf16*>(uniq), static_cast<const int*>(local),
         static_cast<const bf16*>(bias),  static_cast<const bf16*>(ad),
         static_cast<const float*>(b0),   H, Wd, L, U, th, tw, TW};
  rowgemm::EpiStore epi{static_cast<const float*>(b), nullptr, static_cast<bf16*>(out), L, rowgemm::ACT_NONE};
  return rowgemm::launch_rowgemm(a, W, epi, 3 * H * Wd, L, L, stream);
}
