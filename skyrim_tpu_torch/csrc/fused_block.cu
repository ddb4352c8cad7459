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
// skt_layernorm_backward_bf16: the reverse of the LayerNorms of K1's backward
// replay (layernorm_backward_kernel below; ops/fused_block.py
// layernorm_backward).  It replaces no TPU kernel: the JAX package
// differentiates flax's LayerNorm in XLA inside _fused_swin_block_bwd's replay
// (skyrim_tpu/ops/fused_block.py), and the port's replay ran that f32
// composition under autograd, about 25 passes over the (rows, C) activation in
// f32.  Bound: bytes (x and dy read, dx written, the f32 partial sums of the
// scale's and bias's gradients once): 6 bytes an element, 0.18 ms at Pangu's
// stage 1 (535,680 x 192) and 0.095 ms at stage 2 (138,240 x 384) at 3.35 TB/s.
// Measured (H100 80GB HBM3, 700 W): 0.257 and 0.140 ms (72 and 68 % of the
// bound), against 8.37 and 4.32 ms for the f32 composition's forward and
// backward; at FuXi V1's 17,280 x 1536 0.147 ms (32 %; at 173 registers a
// thread one block fits an SM, and NV 6 loads no row ahead).
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

// The LayerNorm's backward, one warp a row, the row's x and dy held in
// registers (C <= 256 NV, C % 8 == 0, lanes on 8-value groups as
// layernorm_rows_warp reads them).  The row's f32 mean and rstd are taken
// again from x with flax's numerics (fast variance clipped at 0, eps), in
// layernorm_rows_warp's order, so x-hat is what the forward normalised; then
// with g = f32(dy) * scale,
//   dx = rstd * (g - mean(g) - x-hat * mean(g * x-hat)),
// rounded once to bf16; where the clip engaged the variance term drops out, as
// autograd's clamp_min passes no gradient below it.  dscale = sum dy * x-hat
// and dbias = sum dy accumulate in f32 registers over the rows a lane's warp
// walks (each lane owns its columns), the warps of a block add theirs in warp
// order in shared memory and the block writes its partial sums once: the
// wrapper adds the blocks' in a fixed order, so two calls give the same bits.
// A persistent grid (as many blocks as fit the SMs) walks the rows; at NV <= 2
// (Pangu's widths) the next row's loads are in flight while a row computes.
constexpr int LNB_WARPS = 8, LNB_THREADS = LNB_WARPS * 32, LNB_MAX_NV = 6;

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <int NV>
__global__ void __launch_bounds__(LNB_THREADS)
    layernorm_backward_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                              const float* __restrict__ scale, bf16* __restrict__ dx,
                              float* __restrict__ part, int rows, int C, float eps) {
  constexpr bool AHEAD = NV <= 2;
  __shared__ float gamma[NV * 256], red[2 * NV * 256];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nv = C / 8;
  const int stride = gridDim.x * LNB_WARPS;
  for (int c = threadIdx.x; c < C; c += LNB_THREADS) gamma[c] = scale[c];
  __syncthreads();
  float dg[NV][8], db[NV][8];
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int u = 0; u < 8; ++u) dg[k][u] = db[k][u] = 0.f;
  auto load_row = [&](int row, uint4(&xr)[NV], uint4(&gr)[NV]) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int v = lane + 32 * k;
      if (row < rows && v < nv) {
        xr[k] = *reinterpret_cast<const uint4*>(x + (size_t)row * C + v * 8);
        gr[k] = *reinterpret_cast<const uint4*>(dy + (size_t)row * C + v * 8);
      }
    }
  };
  int row = blockIdx.x * LNB_WARPS + warp;
  uint4 nx[NV], ng[NV];
  if constexpr (AHEAD) load_row(row, nx, ng);
  for (; row < rows; row += stride) {
    uint4 cx[NV], cg[NV];
    if constexpr (AHEAD) {
#pragma unroll
      for (int k = 0; k < NV; ++k) cx[k] = nx[k], cg[k] = ng[k];
      load_row(row + stride, nx, ng);
    } else {
      load_row(row, cx, cg);
    }
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (lane + 32 * k >= nv) continue;
      float f[8];
      unpack8(cx[k], f);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        s += f[u];
        s2 += f[u] * f[u];
      }
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mu = s / C, var = s2 / C - mu * mu, inv = rsqrtf(fmaxf(var, 0.f) + eps);
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int v = lane + 32 * k;
      if (v >= nv) continue;
      float f[8], d[8];
      unpack8(cx[k], f);
      unpack8(cg[k], d);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float xh = (f[u] - mu) * inv, g = d[u] * gamma[v * 8 + u];
        sg += g;
        sgx += g * xh;
        dg[k][u] += d[u] * xh;
        db[k][u] += d[u];
      }
    }
    sg = warp_sum(sg);
    sgx = warp_sum(sgx);
    const float mg = sg / C, mgx = var < 0.f ? 0.f : sgx / C;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int v = lane + 32 * k;
      if (v >= nv) continue;
      float f[8], d[8];
      unpack8(cx[k], f);
      unpack8(cg[k], d);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float xh = (f[u] - mu) * inv;
        f[u] = inv * (d[u] * gamma[v * 8 + u] - mg - xh * mgx);
      }
      store8(dx + (size_t)row * C + v * 8, f);
    }
  }
  // the block's partial sums: warp 0's, then each next warp's added in order
  for (int w = 0; w < LNB_WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int v = lane + 32 * k;
        if (v >= nv) continue;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int c = v * 8 + u;
          red[c] = w ? red[c] + dg[k][u] : dg[k][u];
          red[C + c] = w ? red[C + c] + db[k][u] : db[k][u];
        }
      }
    }
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.x * 2 * C;
  for (int i = threadIdx.x; i < 2 * C; i += LNB_THREADS) out[i] = red[i];
}

using LnbKernel = void (*)(const bf16*, const bf16*, const float*, bf16*, float*, int, int, float);

// The instantiation for rows of C values, or null where none holds them.
LnbKernel layernorm_backward_for(int C) {
  if (C <= 0 || C % 8) return nullptr;
  switch ((C + 255) / 256) {
    case 1: return layernorm_backward_kernel<1>;
    case 2: return layernorm_backward_kernel<2>;
    case 3: return layernorm_backward_kernel<3>;
    case 4: return layernorm_backward_kernel<4>;
    case 5: return layernorm_backward_kernel<5>;
    case LNB_MAX_NV: return layernorm_backward_kernel<LNB_MAX_NV>;
    default: return nullptr;
  }
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

// The blocks skt_layernorm_backward_bf16 launches for rows x C (the rows of
// the partial sums it writes): as many as fit the SMs at once, at most one a
// LNB_WARPS rows; -1 for a C no instantiation holds.
extern "C" int skt_layernorm_backward_blocks(int rows, int C) {
  const LnbKernel k = layernorm_backward_for(C);
  if (!k) return -1;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, LNB_THREADS, 0) != cudaSuccess) return -1;
  const int want = (rows + LNB_WARPS - 1) / LNB_WARPS;
  return want < per_sm * sm_count() ? want : per_sm * sm_count();
}

// x, dy, dx (rows, C) bf16, 16-byte aligned, C % 8 == 0, C <= 1536; scale (C,)
// f32; part (blocks, 2, C) f32: each block's sums of dy * x-hat, then of dy.
extern "C" int skt_layernorm_backward_bf16(const void* x, const void* dy, const void* scale, void* dx,
                                           void* part, int rows, int C, int blocks, float eps,
                                           void* stream) {
  const LnbKernel k = layernorm_backward_for(C);
  if (!k || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  k<<<blocks, LNB_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), static_cast<const float*>(scale),
      static_cast<bf16*>(dx), static_cast<float*>(part), rows, C, eps);
  return static_cast<int>(cudaGetLastError());
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
