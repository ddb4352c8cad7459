// K9: GraphCast's grid->mesh encoder messages, grid-major over spatial tiles.
//
// Replaces skyrim_tpu/ops/graph_kernels.py fused_g2m_tiled (Pallas body
// _g2m_tiled_kernel).  Per tile t = (ti, tj) of th x tw grid points, slot
// k < D and tile point r:
//   m = LN(bf16(bf16(swish(asrc[p] + bias[p, k] + b0)) @ W + b))
//   out[ti, tj, local[ti, tj, k, r]] += m   (f32; local == U: empty slot)
// written as (TH, TW, U, L) bf16 tile partials; the cross-tile combine stays
// outside.  The TPU kernel aggregates with a one-hot matmul per slot; here
// GEMM row q enumerates (t, k, r) in the layout of `local`, its A loader
// computes the swish prologue from the contiguous source rows, and the
// segmented sum of rowgemm.cuh (groups = tiles, D * th * tw rows each)
// aggregates in row order.  Three launches: skt_g2m_gemm (here), skt_ln_rows,
// skt_segment_sum (fused_mlp.cu).
//
// Bound on this card: operations.  At full width the filled slots (the
// 1,629,780 edges) need 2 * E * L^2 = 0.854 TFLOP (0.864 ms at 989 TFLOP/s)
// on 2.88 GB.  The GEMM also runs the empty slots' rows (local == U), about
// half of its H * W * D rows; compacting them is later work.
#include "rowgemm.cuh"

namespace {

struct AG2M {
  const bf16* asrc;  // (H, W, L)
  const bf16* bias;  // (H, W, D * L)
  const float* b0;   // (L,)
  int W, L, D, th, tw, TW, rows;

  __device__ __forceinline__ void chunk(int q, int kk, bf16* dst) const {
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (q < rows && kk < L) {
      const int R = th * tw;
      const int t = q / (D * R), k = (q / R) % D, r = q % R;
      const int i = (t / TW) * th + r / tw, j = (t % TW) * tw + r % tw;
      const size_t p = (size_t)i * W + j;
      float a8[8], b8[8];
      load8(asrc + p * L + kk, a8);
      load8(bias + (p * D + k) * L + kk, b8);
#pragma unroll
      for (int u = 0; u < 8; ++u) f[u] = rowgemm::swish(a8[u] + b8[u] + b0[kk + u]);
    }
    store8(dst, f);
  }
};

}  // namespace

extern "C" int skt_g2m_gemm(const void* asrc, const void* bias, const void* b0, const void* W,
                            const void* b, void* out, int H, int Wd, int L, int D, int th, int tw,
                            void* stream) {
  const int rows = H * Wd * D;
  AG2M a{static_cast<const bf16*>(asrc), static_cast<const bf16*>(bias),
         static_cast<const float*>(b0), Wd, L, D, th, tw, Wd / tw, rows};
  rowgemm::EpiStore epi{static_cast<const float*>(b), nullptr, static_cast<bf16*>(out), L, rowgemm::ACT_NONE};
  return rowgemm::launch_rowgemm(a, W, epi, rows, L, L, stream);
}
