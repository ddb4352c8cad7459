// K5, K10, K11: the window attention of attention.cuh as ops of their own.
//
// Replace skyrim_tpu/ops/flash_window_attention.py fused_window_attention_4d
// (Pallas body _fused_kernel_4d), fused_window_attention (_fused_kernel) and
// flash_window_attention (_kernel): softmax(q k^T * hd^-1/2 + bias[type] +
// mask[z-win, h-win]) v per window and head.  The three TPU kernels differ in
// the layout they tile with BlockSpecs; here they are one kernel body with
// three token -> address maps:
//   K5   skt_attention_4d     packed (Z, H, W, 3C) -> (Z, H, W, C), window
//                             partition and reverse by index math (Packed4D)
//   K10  skt_attention_rows   partitioned packed (nWin, wlen, 3C) ->
//                             (nWin, wlen, C) (PackedRows)
//   K11  skt_attention_split  q, k, v (nWin, heads, wlen, hd) -> the same
//                             (SplitHeads)
// Window t takes bias type t / nw (n_types > 1) and mask table t / nw
// (n_masks > 1), nw the windows along longitude; the wrappers check the counts
// and choose the body (attention::Body: scores in registers for the models'
// geometries, the shared-memory tile for the rest).
//
// Bound on this card: bytes (at Pangu stage 1 the qkv, output, bias and mask
// are 0.9 GB, 0.27 ms at 3.35 TB/s, against 59 GFLOP); designs and limits are
// in attention.cuh.
#include "attention.cuh"

extern "C" int skt_attention_4d(const void* qkv, const void* bias, const void* mask, void* out,
                                int Z, int H, int W, int C, int heads, int wz, int wh, int ww,
                                int n_types, int vec, float scale, int body, void* stream) {
  const int nz = Z / wz, nh = H / wh, nw = W / ww, hd = C / heads;
  attention::Packed4D addr{static_cast<const bf16*>(qkv), static_cast<bf16*>(out), H, W, C, hd,
                           wz, wh, ww, nh, nw};
  return attention::launch(addr, bias, mask, nz * nh * nw, heads, wz * wh * ww, hd, nw, n_types,
                           nz * nh, vec, scale, body, stream);
}

extern "C" int skt_attention_rows(const void* qkv, const void* bias, const void* mask, void* out,
                                  int n_win, int wlen, int C, int heads, int nw, int n_types,
                                  int n_masks, int vec, float scale, int body,
                                  void* stream) {
  const int hd = C / heads;
  attention::PackedRows addr{static_cast<const bf16*>(qkv), static_cast<bf16*>(out), C, hd, wlen};
  return attention::launch(addr, bias, mask, n_win, heads, wlen, hd, nw, n_types, n_masks, vec,
                           scale, body, stream);
}

extern "C" int skt_attention_split(const void* q, const void* k, const void* v, const void* bias,
                                   const void* mask, void* out, int n_win, int heads, int wlen,
                                   int hd, int nw, int n_types, int n_masks, int vec, float scale,
                                   int body, void* stream) {
  attention::SplitHeads addr{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                             static_cast<const bf16*>(v), static_cast<bf16*>(out), heads, hd, wlen};
  return attention::launch(addr, bias, mask, n_win, heads, wlen, hd, nw, n_types, n_masks, vec,
                           scale, body, stream);
}
