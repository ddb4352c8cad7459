// K6: the row MLP [residual +] LN?(Dense2(swish(Dense1(x || x2)))), and the
// row kernels K7-K9 share (rowgemm.cuh).
//
// Replaces skyrim_tpu/ops/fused_mlp.py fused_mlp (Pallas body _mlp_kernel),
// GraphCast's node and edge MLPs.  The TPU kernel keeps a row tile and both
// weight matrices in VMEM; at L = 512 the weights alone (1 MB) exceed a Hopper
// block's shared memory, so K6 is two launches (three where Cout != H with a
// LayerNorm, none of GraphCast's):
//   skt_mlp_gemm    h = bf16(swish(x @ W1[:K1] + x2 @ W1[K1:] + b1)), f32
//                   swish; one accumulator for the split first layer (the
//                   concat is never built); x read in place: aligned rows or
//                   feature-major (Cin, N) by TMA on the aligned GEMM
//                   (embed_grid), element loads elsewhere (rows of 174, 3, 4)
//   skt_mlp_finish  with a LayerNorm and H == Cout <= 512: out =
//                   bf16([res +] bf16(LN(bf16(h @ W2 + b2)))) in one launch of
//                   rows_ln_kernel, whole rows a block, h by TMA, the LayerNorm
//                   and the residual in the epilogue
//   otherwise       skt_mlp_gemm y = bf16(h @ W2 + b2) (no LN: + residual
//                   here), then skt_ln_rows out = bf16(res + bf16(LN(y)))
// skt_segment_sum is the deterministic segmented sum of K7 and K14.  The
// GEMM is rowgemm.cuh's: on aligned rows wgmma fed by TMA, one persistent
// block an SM whose two consumer warpgroups take tiles in turn and store each
// epilogue by TMA, ~460 TFLOP/s at 512 wide on an NVIDIA H100 80GB HBM3 (700
// W), 47 % of the bf16 peak (torch.matmul on the same operands: ~600; the
// products alone, without the epilogue, ~660); a cp.async ring under a loader
// functor elsewhere.
//
// Bound on this card: operations.  At full width a grid MLP does
// 2 * N * (Cin * H + H * Cout) = 1.09 TFLOP (N = 1,038,240, 512 -> 512 -> 512)
// on 2.1 GB of rows in and out: 1.10 ms at 989 TFLOP/s against 0.64 ms at
// 3.35 TB/s.
#include <chrono>

#include "rowgemm.cuh"

// How A is read, as the wrapper chose it by the operands' shapes
// (ops/fused_mlp.py mlp_paths): A_ELEMENTS, element loads on the cp.async
// ring; A_ROWS, 16-byte aligned rows (the TMA kernel where N allows, else the
// ring); A_FEATURE_MAJOR_TMA, feature-major (K1, M) by TMA, an error where
// the operands do not allow it.
enum AMode { A_ELEMENTS = 0, A_ROWS = 1, A_FEATURE_MAJOR_TMA = 2 };

extern "C" int skt_mlp_gemm(const void* a1, long long s1m, long long s1k, int K1, const void* a2,
                            int K2, const void* W, const void* bias, const void* res, void* out,
                            int M, int N, int act, int a_mode, void* stream) {
  const bf16* x1 = static_cast<const bf16*>(a1);
  const bf16* x2 = static_cast<const bf16*>(a2);
  rowgemm::EpiStore epi{static_cast<const float*>(bias), static_cast<const bf16*>(res),
                        static_cast<bf16*>(out), N, act};
  if (a_mode == A_ROWS)
    return rowgemm::launch_rowgemm(rowgemm::ARows<true>{x1, s1m, s1k, K1, x2, K2, M}, W, epi, M, N,
                                   K1 + K2, stream);
  const rowgemm::ARows<false> a{x1, s1m, s1k, K1, x2, K2, M};
  if (a_mode == A_FEATURE_MAJOR_TMA) {
    const int err = rowgemm::launch_rowgemm_tma(a, static_cast<const bf16*>(W), epi, M, N, K1 + K2,
                                                static_cast<cudaStream_t>(stream));
    return err == rowgemm::TMA_NOT_TAKEN ? static_cast<int>(cudaErrorInvalidValue) : err;
  }
  return rowgemm::launch_rowgemm(a, W, epi, M, N, K1 + K2, stream);
}

// K6's finish where it has a LayerNorm and H == Cout <= 512: out =
// bf16([res +] bf16(LN(bf16(h @ W + b)))) in one launch of rows_ln_kernel<1>,
// h (M, L) rows brought by TMA, W (L, L); res (M, L) or null.
extern "C" int skt_mlp_finish(const void* h, const void* W, const void* b, const void* ln_scale,
                              const void* ln_bias, const void* res, void* out, int M, int L, float eps,
                              void* stream) {
  const rowgemm::TmaRows pro{static_cast<const bf16*>(h)};
  const rowgemm::EpiLN ln{static_cast<const float*>(b), static_cast<const float*>(ln_scale),
                          static_cast<const float*>(ln_bias), eps};
  if (!res) return rowgemm::launch_rows_ln<1>(pro, W, ln, out, M, L, stream);
  return rowgemm::launch_rows_ln<1>(pro, W, rowgemm::EpiLNRes{ln, static_cast<const bf16*>(res)}, out, M,
                                    L, stream);
}

extern "C" int skt_ln_rows(const void* y, const void* scale, const void* bias, const void* res,
                           void* out, int rows, int C, float eps, void* stream) {
  return rowgemm::launch_ln_rows(y, scale, bias, res, out, rows, C, eps, stream);
}

extern "C" int skt_segment_sum(const void* x, const void* local, void* out, int G, int R, int S,
                               int C, void* stream) {
  return rowgemm::launch_segsum(x, local, out, G, R, S, C, stream);
}

// The host's share of one aligned row-GEMM launch, ns a call, each the mean of
// n calls on the host clock (tools/kernel_variants.py prints them): ns[0]
// encoding the launch's three tensor maps (A, W, out), ns[1] one
// cudaFuncSetAttribute (which every launch paid before the attribute was set
// once an instance), ns[2] a whole skt_mlp_gemm launch as the wrappers make
// it.  a (M, K), W (K, N) and out (M, N) bf16 and bias (N,) f32 on the card,
// N % 128 == 0; n launches are queued.
extern "C" int skt_rowgemm_host_ns(const void* a, const void* W, const void* bias, void* out, int M,
                                   int N, int K, int n, void* stream, double* ns) {
  using clock = std::chrono::steady_clock;
  const auto per_call = [n](clock::time_point t0) {
    return std::chrono::duration<double, std::nano>(clock::now() - t0).count() / n;
  };
  CUtensorMap map;
  int err = 0;
  auto t0 = clock::now();
  for (int i = 0; i < n && !err; ++i) {
    err = rowgemm::make_tensor_map(&map, a, M, K, K, 128);
    if (!err) err = rowgemm::make_tensor_map(&map, W, K, N, N, rowgemm::BK);
    if (!err) err = rowgemm::make_tensor_map(&map, out, M, N, N, 128);
  }
  ns[0] = per_call(t0);
  t0 = clock::now();
  for (int i = 0; i < n && !err; ++i)
    err = static_cast<int>(cudaFuncSetAttribute(
        rowgemm::rowgemm_tma_kernel<128, 128, rowgemm::EpiStore>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rowgemm::TmaTile<128, 128>::SMEM));
  ns[1] = per_call(t0);
  t0 = clock::now();
  for (int i = 0; i < n && !err; ++i)
    err = skt_mlp_gemm(a, K, 1, K, nullptr, 0, W, bias, nullptr, out, M, N, rowgemm::ACT_NONE, A_ROWS,
                       stream);
  ns[2] = per_call(t0);
  return err;
}
