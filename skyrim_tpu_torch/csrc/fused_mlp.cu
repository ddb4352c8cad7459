// K6: the row MLP [residual +] LN?(Dense2(swish(Dense1(x || x2)))), and the
// row kernels K7-K9 share (rowgemm.cuh).
//
// Replaces skyrim_tpu/ops/fused_mlp.py fused_mlp (Pallas body _mlp_kernel),
// GraphCast's node and edge MLPs.  The TPU kernel keeps a row tile and both
// weight matrices in VMEM; at L = 512 the weights alone (1 MB) exceed a Hopper
// block's shared memory, so K6 is two or three launches:
//   skt_mlp_gemm  h = bf16(swish(x @ W1[:K1] + x2 @ W1[K1:] + b1)), f32 swish;
//                 one accumulator for the split first layer (the concat is
//                 never built); x read in place, feature-major (Cin, N) when
//                 transposed, with element loads where rows are not 16-byte
//                 aligned (Cin 174, 3, 4)
//   skt_mlp_gemm  y = bf16(h @ W2 + b2)   (no LN: + residual here)
//   skt_ln_rows   out = bf16(res + bf16(LN(y)))   (residual after the LN)
// skt_segment_sum is the deterministic segmented sum of K7, K9 and K14.  The
// GEMM is rowgemm.cuh's: wgmma fed by TMA in persistent blocks on aligned rows,
// ~450 TFLOP/s at 512 wide on an H100, 46 % of the bf16 peak (torch.matmul on
// the same operands: ~600); a cp.async ring under a loader functor elsewhere.
//
// Bound on this card: operations.  At full width a grid MLP does
// 2 * N * (Cin * H + H * Cout) = 1.09 TFLOP (N = 1,038,240, 512 -> 512 -> 512)
// on 2.1 GB of rows in and out: 1.10 ms at 989 TFLOP/s against 0.64 ms at
// 3.35 TB/s.
#include "rowgemm.cuh"

extern "C" int skt_mlp_gemm(const void* a1, long long s1m, long long s1k, int K1, const void* a2,
                            int K2, const void* W, const void* bias, const void* res, void* out,
                            int M, int N, int act, int vec, void* stream) {
  const bf16* x1 = static_cast<const bf16*>(a1);
  const bf16* x2 = static_cast<const bf16*>(a2);
  rowgemm::EpiStore epi{static_cast<const float*>(bias), static_cast<const bf16*>(res),
                        static_cast<bf16*>(out), N, act};
  if (vec)
    return rowgemm::launch_rowgemm(rowgemm::ARows<true>{x1, s1m, s1k, K1, x2, K2, M}, W, epi, M, N,
                                   K1 + K2, stream);
  return rowgemm::launch_rowgemm(rowgemm::ARows<false>{x1, s1m, s1k, K1, x2, K2, M}, W, epi, M, N,
                                 K1 + K2, stream);
}

extern "C" int skt_ln_rows(const void* y, const void* scale, const void* bias, const void* res,
                           void* out, int rows, int C, int nsum, float eps, void* stream) {
  return rowgemm::launch_ln_rows(y, scale, bias, res, out, rows, C, nsum, eps, stream);
}

extern "C" int skt_segment_sum(const void* x, const void* local, void* out, int G, int R, int S,
                               int C, void* stream) {
  return rowgemm::launch_segsum(x, local, out, G, R, S, C, stream);
}
