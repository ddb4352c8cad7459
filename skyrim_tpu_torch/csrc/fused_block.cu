// K1 pieces: LayerNorm and windowed multi-head attention with earth bias and
// shift mask.  With the GEMMs of gemm.cu they make up the pre-norm Swin/Pangu
// block that replaces skyrim_tpu/ops/fused_block.py fused_swin_block_4d
// (_fused_block_kernel); ops/fused_block.py composes the launches: five where
// the rows fit gemm.cu's LayerNorm-prologue GEMM (C <= 512, Pangu), the
// seven-launch chain with the LayerNorms below for wider rows (FuXi's C 1536).
//
// skt_layernorm_bf16: rowgemm.cuh's ln_rows_kernel with one row per output,
// one warp per token row, f32 statistics (flax numerics).  Bound: bytes (one
// read, one write of the activation).
//
// skt_window_attention_bf16: attention.cuh's bodies on the packed (Z, H, W, 3C)
// qkv of the block's GEMM, tokens addressed in place (Packed4D); `body` as in
// window_attention.cu; designs, limits and bound are in attention.cuh.
#include "attention.cuh"
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
