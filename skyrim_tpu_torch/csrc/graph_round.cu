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
// skt_round_gemm (here), skt_mlp_gemm, skt_ln_rows with the edges as the
// residual, skt_segment_sum (fused_mlp.cu).
//
// Bound on this card: operations.  At full width (B, M, L) = (322, 1024, 512)
// the two Dense products are 4 * B * M * L^2 = 346 GFLOP on 1.13 GB of edges,
// gathered sources, staged rows and outputs: 0.35 ms at 989 TFLOP/s.
#include "rowgemm.cuh"

namespace {

struct EpiRound {
  const float* b0;
  const bf16* gsrc;    // (rows, N)
  const bf16* staged;  // (B, SB, N)
  const int* local;    // (rows,)
  bf16* out;
  int N, M, SB;

  // N % 8 == 0 (the wrapper checks L), so nv == 8: 16-byte accesses
  __device__ __forceinline__ void operator()(int row, int col, float* v, int) const {
    const int l = local[row];
    const bool hit = (unsigned)l < (unsigned)SB;
    float gs[8], st[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    load8(gsrc + (size_t)row * N + col, gs);
    if (hit) load8(staged + ((size_t)(row / M) * SB + l) * N + col, st);
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = rowgemm::swish(v[u] + gs[u] + st[u] + b0[col + u]);
    store8(out + (size_t)row * N + col, v);
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
