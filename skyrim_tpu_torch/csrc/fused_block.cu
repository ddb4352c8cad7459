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
//
// K15, FuXi's Swin-V2 block (ops/fused_block.py fused_swin_v2_block), takes two
// pieces from here between gemm.cu's long-K products:
//
// skt_cosine_window_attention_bf16: attention.cuh's bodies in their cosine
// variant (CosinePacked4D) on the packed qkv, `body` as for
// skt_window_attention_bf16: q and k normalised a row at a time in shared
// memory, each head's clamped logit scale, the CPB bias table (n_types 1) and
// the shift mask.  FuXi's (6, 12) windows of 24 heads of 64 take the register
// body (WLP 80, HDP 64); any other window the general body takes runs there.
//
// skt_post_norm_rows_bf16: the residual-post-norm of a half-block, out =
// bf16(res + bf16(LN(y))) a row at a time (one warp a row, common.cuh's
// layernorm_rows_warp: f32 statistics, flax numerics), the output row rolled
// back by (s1, s2) along H and W: the shifted block's return to the unshifted
// frame rides on the store, so the block needs no second roll.  Bound: bytes
// (y and res read, out written: 0.16 GB at FuXi's trunk, 0.05 ms).
#include "attention.cuh"
#include "attention_bwd.cuh"
#include "rowgemm.cuh"

namespace {

// out[roll(row)] = bf16(res[row] + bf16(LN(y[row]))) over the H * W rows of C
// values; roll(h, w) = ((h + s1) % H, (w + s2) % W).  Without a roll out may
// be y; with one it is a buffer of its own.
__global__ void post_norm_rows_kernel(const bf16* y, const float* __restrict__ scale,
                                      const float* __restrict__ bias, const bf16* __restrict__ res,
                                      bf16* out, int H, int W, int C, int s1, int s2, float eps) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= H * W) return;
  int h = row / W + s1, w = row % W + s2;
  if (h >= H) h -= H;
  if (w >= W) w -= W;
  const bf16* yr = y + (size_t)row * C;
  const bf16* rr = res + (size_t)row * C;
  bf16* orow = out + ((size_t)h * W + w) * C;
  layernorm_rows_warp([&](int v) { return yr + v * 8; }, scale, bias, C, eps, [&](int v, float* o) {
    float r8[8];
    load8(rr + v * 8, r8);
#pragma unroll
    for (int u = 0; u < 8; ++u) o[u] += r8[u];
    store8(orow + v * 8, o);
  });
}

}  // namespace

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

// skt_window_attention_bf16's arguments (its scalar scale unused), then
// head_scale (heads,) f32.
extern "C" int skt_cosine_window_attention_bf16(const void* qkv, const void* bias, const void* mask,
                                                void* out, int Z, int H, int W, int C, int heads, int wz,
                                                int wh, int ww, int n_types, int vec, float, int body,
                                                void* stream, const void* head_scale) {
  const int nz = Z / wz, nh = H / wh, nw = W / ww, hd = C / heads;
  attention::CosinePacked4D addr{
      {static_cast<const bf16*>(qkv), static_cast<bf16*>(out), H, W, C, hd, wz, wh, ww, nh, nw},
      static_cast<const float*>(head_scale)};
  return attention::launch(addr, bias, mask, nz * nh * nw, heads, wz * wh * ww, hd, nw, n_types,
                           nz * nh, vec, 0.f, body, stream);
}

// y, res, out (H, W, C) bf16, C % 8 == 0; scale, bias (C,) f32; (s1, s2) the
// roll of the store, 0 <= s1 < H, 0 <= s2 < W.
extern "C" int skt_post_norm_rows_bf16(const void* y, const void* scale, const void* bias, const void* res,
                                       void* out, int H, int W, int C, int s1, int s2, float eps,
                                       void* stream) {
  const int warps = 8;
  post_norm_rows_kernel<<<(H * W + warps - 1) / warps, warps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(y), static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const bf16*>(res), static_cast<bf16*>(out), H, W, C, s1, s2, eps);
  return static_cast<int>(cudaGetLastError());
}
