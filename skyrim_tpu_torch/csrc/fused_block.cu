// K1 pieces: LayerNorm and windowed multi-head attention with earth bias and
// shift mask.  With the GEMMs of gemm.cu they make up the pre-norm Swin/Pangu
// block that replaces skyrim_tpu/ops/fused_block.py fused_swin_block_4d
// (_fused_block_kernel); ops/fused_block.py composes the launches: five where
// the rows fit gemm.cu's LayerNorm-prologue GEMM (C <= 512, Pangu); five on
// gemm.cu's long-K GEMM for wider rows of whole 64-column slices (FengWu's C
// 1152, FuXi V1's C 1536), bound by the products' flops, which it feeds from
// tiles whose slices both consumers share, the LayerNorm applied slice by
// slice in shared memory; the seven-launch chain with the LayerNorms below
// for any other row wider than 512.
//
// skt_layernorm_bf16: rowgemm.cuh's ln_rows_kernel with one row per output,
// one warp per token row, f32 statistics (flax numerics), the chain's
// LayerNorms.  Bound: bytes (one read, one write of the activation).
//
// skt_window_attention_bf16: attention.cuh's bodies on the packed (Z, H, W, 3C)
// qkv of the block's GEMM, tokens addressed in place (Packed4D); `body` as in
// window_attention.cu; designs, limits and bound are in attention.cuh.
//
// skt_window_attention_backward_bf16: its reverse for K1's backward replay,
// attention_bwd.cuh (design, limits and bound there): dqkv packed like qkv and
// the f32 dbias partial sums of each run of windows.
#include "attention.cuh"
#include "attention_bwd.cuh"
#include "rowgemm.cuh"

extern "C" int skt_layernorm_bf16(const void* x, const void* scale, const void* bias, void* out,
                                  int rows, int C, float eps, void* stream) {
  return rowgemm::launch_ln_rows(x, scale, bias, nullptr, out, rows, C, eps, stream);
}

// bias (n_types, heads, wlen, wlen) f32, n_types 1 or nz * nh; mask (nz, nh,
// wlen, wlen) f32 or null.
extern "C" int skt_window_attention_bf16(const void* qkv, const void* bias, const void* mask,
                                         void* out, int Z, int H, int W, int C, int heads, int wz,
                                         int wh, int ww, int n_types, int vec, float scale,
                                         int body, void* stream) {
  const int nz = Z / wz, nh = H / wh, nw = W / ww, hd = C / heads;
  attention::Packed4D addr{static_cast<const bf16*>(qkv), static_cast<bf16*>(out), H, W, C, hd,
                           wz, wh, ww, nh, nw};
  return attention::launch(addr, bias, mask, nz * nh * nw, heads, wz * wh * ww, hd, nw, n_types,
                           nz * nh, vec, scale, body, stream);
}

// dout (Z, H, W, C) bf16; dqkv like qkv; bias and mask as above; dbias (rows,
// runs, heads, wlen, wlen) f32, rows 1 or nz * nh (the rows of windows that
// share a bias type and mask table), runs = ceil(windows a row / run).
extern "C" int skt_window_attention_backward_bf16(const void* qkv, const void* dout, const void* bias,
                                                  const void* mask, void* dqkv, void* dbias, int Z,
                                                  int H, int W, int C, int heads, int wz, int wh,
                                                  int ww, int n_types, int rows, int run,
                                                  float scale, void* stream) {
  const int nz = Z / wz, nh = H / wh, nw = W / ww, hd = C / heads, n_win = nz * nh * nw;
  attention::Packed4D addr{static_cast<const bf16*>(qkv), nullptr, H, W, C, hd, wz, wh, ww, nh, nw};
  return attention_bwd::launch(addr, dout, dqkv, bias, mask, dbias, n_win, heads, wz * wh * ww, hd,
                               n_win / rows, run, n_types, nz * nh, scale, stream);
}
