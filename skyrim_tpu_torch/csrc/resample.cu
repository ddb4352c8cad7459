// K3 and K4 pieces: the 2x2 patch-merge LayerNorm and the 2x2 patch-expand
// LayerNorm around the GEMM of gemm.cu.
//
// merge_layernorm_kernel (K3, replaces skyrim_tpu/ops/resample.py
// fused_downsample / _down_kernel, with the GEMM after it): one warp per
// merged token (z, h2, w2) gathers the four parity tokens x[z, 2h2+i, 2w2+j, :]
// by index math in the merged lane order (2i+j)*C + c, normalizes over 4C in
// f32 and writes the bf16 row the GEMM reads.  The TPU kernel's algebraic split
// of LayerNorm across the four parity slabs works around Mosaic's shape casts
// and is not needed here.
//
// expand_layernorm_kernel (K4, replaces fused_upsample / _up_kernel, after the
// GEMM): one warp per output token (z, 2h+i, 2w+j) normalizes lane group 2i+j
// of the GEMM's (Z, H, W, 4Co) output over Co and writes (Z, 2H, 2W, Co)
// directly, so the 2x2 interleave costs no extra pass.
//
// Bound on this card: bytes (one read, one write); the gathers are whole
// 16-byte chunks of contiguous channel runs.
#include "common.cuh"

namespace {

__global__ void merge_layernorm_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                                       const float* __restrict__ bias, bf16* __restrict__ out,
                                       int Z, int H, int W, int C, float eps) {
  const int H2 = H / 2, W2 = W / 2;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= Z * H2 * W2) return;
  const int w2 = row % W2, h2 = (row / W2) % H2, z = row / (W2 * H2);
  const int cv = C / 8;
  auto chunk = [&](int v) {
    const int g = v / cv, c = (v % cv) * 8;
    const int h = 2 * h2 + (g >> 1), w = 2 * w2 + (g & 1);
    return x + (((size_t)z * H + h) * W + w) * C + c;
  };
  layernorm_row_warp(chunk, scale, bias, out + (size_t)row * 4 * C, 4 * C, eps);
}

__global__ void expand_layernorm_kernel(const bf16* __restrict__ m, const float* __restrict__ scale,
                                        const float* __restrict__ bias, bf16* __restrict__ out,
                                        int Z, int H, int W, int Co, float eps) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= Z * 4 * H * W) return;
  const int wo = row % (2 * W), ho = (row / (2 * W)) % (2 * H), z = row / (4 * H * W);
  const int g = 2 * (ho & 1) + (wo & 1);
  const bf16* src = m + (((size_t)z * H + (ho >> 1)) * W + (wo >> 1)) * 4 * Co + g * Co;
  layernorm_row_warp([&](int v) { return src + v * 8; }, scale, bias, out + (size_t)row * Co, Co,
                     eps);
}

constexpr int WARPS = 8;

}  // namespace

extern "C" int skt_merge_layernorm_bf16(const void* x, const void* scale, const void* bias,
                                        void* out, int Z, int H, int W, int C, float eps,
                                        void* stream) {
  const int rows = Z * (H / 2) * (W / 2);
  merge_layernorm_kernel<<<(rows + WARPS - 1) / WARPS, WARPS * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<bf16*>(out), Z, H, W, C, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int skt_expand_layernorm_bf16(const void* m, const void* scale, const void* bias,
                                         void* out, int Z, int H, int W, int Co, float eps,
                                         void* stream) {
  const int rows = Z * 4 * H * W;
  expand_layernorm_kernel<<<(rows + WARPS - 1) / WARPS, WARPS * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(m), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<bf16*>(out), Z, H, W, Co, eps);
  return static_cast<int>(cudaGetLastError());
}
