// K7: one GraphCast processor round over dst-sorted edge blocks.
//
// Replaces skyrim_tpu/ops/graph_kernels.py fused_round_messages (Pallas body
// _round_kernel).  Per edge block b (M rows, SB destination segments):
//   h   = e @ We + gsrc + staged[b, local] + b0      (f32), swish -> bf16
//   m   = LN(bf16(h @ W + b))                        -> bf16
//   ne  = bf16(e + m)
//   agg[b, s] = sum of ne over the rows with local == s, f32 -> bf16;
// rows with local == SB are padding: they compute but never aggregate.
// The TPU kernel expands staged and aggregates with one-hot matmuls on the
// MXU; here the expansion is an indexed load in this file's GEMM epilogue and
// the aggregation the segmented sum of rowgemm.cuh.  Four launches:
//   skt_round_gemm   h = bf16(swish(e @ We + gsrc + staged[local] + b0)) on the
//                    wgmma row GEMM, the expansion in its epilogue (here)
//   skt_mlp_gemm     y = bf16(h @ W + b)                     (fused_mlp.cu)
//   skt_ln_rows      ne = bf16(e + bf16(LN(y)))              (fused_mlp.cu)
//   skt_segment_sum  agg from ne                             (fused_mlp.cu)
// h, y and ne round-trip device memory.  (The second Dense with its LayerNorm
// and residual as one launch, a block 64 rows x all 512 columns on the cp.async
// ring so that y stays on the chip, took 1.24 ms against 0.39 + 0.40 ms for
// the two launches on an H100 at full width -- one block an SM, its LayerNorm
// epilogue not hidden behind another block's products -- and was not kept.)
//
// Bound on this card: operations.  At full width (B, M, L) = (322, 1024, 512)
// the two Dense products are 4 * B * M * L^2 = 346 GFLOP on 1.13 GB of edges,
// gathered sources, staged rows and outputs: 0.35 ms at 989 TFLOP/s.
#include "rowgemm.cuh"

namespace {

struct EpiRound {
  const float* bias;   // b0
  const bf16* gsrc;    // (rows, N): added as the kernels add a residual
  const bf16* staged;  // (B, SB, N)
  const int* local;    // (rows,)
  bf16* out;
  int N, M, SB;

  __host__ __device__ __forceinline__ const bf16* residual() const { return gsrc; }
  // N % 8 == 0 (the wrapper checks L), so every call has 8 columns
  __device__ __forceinline__ void apply(int row, int col, float* v, const float* b,
                                        const float* gs) const {
    const int l = local[row];
    float st[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if ((unsigned)l < (unsigned)SB) load8(staged + ((size_t)(row / M) * SB + l) * N + col, st);
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = rowgemm::swish(v[u] + gs[u] + st[u] + b[u]);
  }
};

}  // namespace

extern "C" int skt_round_gemm(const void* edges, const void* We, const void* b0, const void* gsrc,
                              const void* staged, const void* local, void* out, int rows, int L,
                              int M, int SB, void* stream) {
  rowgemm::ARows<true> a{static_cast<const bf16*>(edges), L, 1, L, nullptr, 0, rows};
  EpiRound epi{static_cast<const float*>(b0), static_cast<const bf16*>(gsrc),
               static_cast<const bf16*>(staged), static_cast<const int*>(local),
               static_cast<bf16*>(out), L, M, SB};
  return rowgemm::launch_rowgemm(a, We, epi, rows, L, L, stream);
}
