// K1 pieces: LayerNorm and windowed multi-head attention with earth bias and
// shift mask.  With the GEMM of gemm.cu they make up the pre-norm Swin/Pangu
// block that replaces skyrim_tpu/ops/fused_block.py fused_swin_block_4d
// (_fused_block_kernel); ops/fused_block.py composes the seven launches.
//
// skt_layernorm_bf16: rowgemm.cuh's ln_rows_kernel with one row per output,
// one warp per token row, f32 statistics (flax numerics).  Bound: bytes (one
// read, one write of the activation).
//
// window_attention_kernel: one thread block per (window, head).  It reads the
// head's q/k/v lanes for the window's wlen tokens straight out of the packed
// (Z, H, W, 3C) qkv by index math (tokens ordered z, then h, then w inside a
// window, as skyrim_tpu/ops/windows.py window_partition), so no partition or
// reverse relayout touches device memory; computes S = q k^T on the tensor
// cores into shared memory (wlen^2 f32 = 83 KB at wlen 144), adds
// scale, bias[type, head] and mask[z-win, h-win] in f32, takes exp(s - max) in
// f32 and keeps it as bf16 in place of S, computes (e V) on the tensor cores
// and divides by the f32 row sums (the TPU kernel's normalisation after AV),
// then writes the head's lanes of (Z, H, W, C).  Bound: bytes of the f32 bias
// and mask tables (read from L2 once per block, shared along longitude) and
// the exp; the flops are ~4 * wlen^2 * hd per block.  Shared memory is
// wlen^2*4 + 3*wlen*hd_pad*2 + wlen*4 bytes (111 KB at wlen 144, hd 32), so two
// blocks fit on an SM; the f32 output tile reuses the q/k buffers.
#include <math.h>
#include <mma.h>

#include "rowgemm.cuh"

using namespace nvcuda;

namespace {

constexpr int ATT_THREADS = 256;
constexpr int MAX_COLS_PER_LANE = 8;  // wlen <= 256

__global__ void __launch_bounds__(ATT_THREADS, 2)
    window_attention_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                            const float* __restrict__ mask, bf16* __restrict__ out, int Z, int H,
                            int W, int C, int heads, int wz, int wh, int ww, int n_types,
                            int has_mask, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int WL = wz * wh * ww;
  const int hd = C / heads;
  const int HDP = (hd + 15) & ~15;
  const int nh = H / wh, nw = W / ww;

  // lon window fastest: consecutive blocks share one (type, head) bias table
  int b = blockIdx.x;
  const int win_w = b % nw;
  b /= nw;
  const int head = b % heads;
  b /= heads;
  const int win_h = b % nh;
  const int win_z = b / nh;

  float* S = reinterpret_cast<float*>(smem);        // WL x WL scores, then bf16 P in place
  bf16* Qs = reinterpret_cast<bf16*>(S + WL * WL);  // WL x HDP
  bf16* Ks = Qs + WL * HDP;
  bf16* Vs = Ks + WL * HDP;
  float* Os = reinterpret_cast<float*>(Qs);  // WL x HDP f32, over Qs and Ks once S is done
  float* rowsum = reinterpret_cast<float*>(Vs + WL * HDP);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
  auto token = [&](int i) -> size_t {
    const int zi = i / (wh * ww), hi = (i / ww) % wh, wi = i % ww;
    return ((size_t)(win_z * wz + zi) * H + (win_h * wh + hi)) * W + (win_w * ww + wi);
  };

  // 1. this head's q, k, v -> shared memory, zero-padded to HDP lanes
  const int cpr = HDP / 8;
  for (int t = tid; t < WL * cpr; t += blockDim.x) {
    const int i = t / cpr, c = (t % cpr) * 8;
    uint4 q = make_uint4(0, 0, 0, 0), k = q, v = q;
    if (c < hd) {
      const bf16* src = qkv + token(i) * (3 * C) + head * hd + c;
      q = *reinterpret_cast<const uint4*>(src);
      k = *reinterpret_cast<const uint4*>(src + C);
      v = *reinterpret_cast<const uint4*>(src + 2 * C);
    }
    *reinterpret_cast<uint4*>(Qs + i * HDP + c) = q;
    *reinterpret_cast<uint4*>(Ks + i * HDP + c) = k;
    *reinterpret_cast<uint4*>(Vs + i * HDP + c) = v;
  }
  __syncthreads();

  // 2. S = q k^T (k row-major is k^T column-major)
  const int T = WL / 16;
  for (int t = warp; t < T * T; t += nwarps) {
    const int ti = t / T, tj = t % T;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < HDP; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
      wmma::load_matrix_sync(a, Qs + ti * 16 * HDP + kk, HDP);
      wmma::load_matrix_sync(bk, Ks + tj * 16 * HDP + kk, HDP);
      wmma::mma_sync(acc, a, bk, acc);
    }
    wmma::store_matrix_sync(S + ti * 16 * WL + tj * 16, acc, WL, wmma::mem_row_major);
  }
  __syncthreads();

  // 3. rows: s*scale + bias + mask, e = exp(s - max) kept as bf16 over the
  //    row's own f32 bytes, f32 row sums
  const int type = n_types == 1 ? 0 : win_z * nh + win_h;
  const float* brow0 = bias + ((size_t)type * heads + head) * WL * WL;
  const float* mrow0 = has_mask ? mask + ((size_t)win_z * nh + win_h) * WL * WL : nullptr;
  for (int r = warp; r < WL; r += nwarps) {
    float vals[MAX_COLS_PER_LANE];
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < MAX_COLS_PER_LANE; ++t) {
      const int c = lane + 32 * t;
      vals[t] = -INFINITY;
      if (c < WL) {
        float s = S[r * WL + c] * scale + brow0[(size_t)r * WL + c];
        if (has_mask) s += mrow0[(size_t)r * WL + c];
        vals[t] = s;
        mx = fmaxf(mx, s);
      }
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < MAX_COLS_PER_LANE; ++t) {
      vals[t] = expf(vals[t] - mx);  // exp(-inf) = 0 for the unused slots
      sum += vals[t];
    }
    sum = warp_sum(sum);
    __syncwarp();
    bf16* P = reinterpret_cast<bf16*>(S + r * WL);
#pragma unroll
    for (int t = 0; t < MAX_COLS_PER_LANE; ++t) {
      const int c = lane + 32 * t;
      if (c < WL) P[c] = __float2bfloat16(vals[t]);
    }
    if (lane == 0) rowsum[r] = sum;
  }
  __syncthreads();

  // 4. O = P V
  const int LDP = 2 * WL;
  const bf16* P = reinterpret_cast<const bf16*>(S);
  const int TD = HDP / 16;
  for (int t = warp; t < T * TD; t += nwarps) {
    const int ti = t / TD, tj = t % TD;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < WL; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
      wmma::load_matrix_sync(a, P + ti * 16 * LDP + kk, LDP);
      wmma::load_matrix_sync(bv, Vs + kk * HDP + tj * 16, HDP);
      wmma::mma_sync(acc, a, bv, acc);
    }
    wmma::store_matrix_sync(Os + ti * 16 * HDP + tj * 16, acc, HDP, wmma::mem_row_major);
  }
  __syncthreads();

  // 5. normalise and write this head's lanes of (Z, H, W, C)
  const int cpo = hd / 8;
  for (int t = tid; t < WL * cpo; t += blockDim.x) {
    const int i = t / cpo, c = (t % cpo) * 8;
    const float den = rowsum[i];
    float o[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) o[u] = Os[i * HDP + c + u] / den;
    store8(out + token(i) * C + head * hd + c, o);
  }
}

}  // namespace

extern "C" int skt_layernorm_bf16(const void* x, const void* scale, const void* bias, void* out,
                                  int rows, int C, float eps, void* stream) {
  return rowgemm::launch_ln_rows(x, scale, bias, nullptr, out, rows, C, 1, eps, stream);
}

// A window too large for shared memory fails cudaFuncSetAttribute; the error
// is returned to the wrapper, which raises.
extern "C" int skt_window_attention_bf16(const void* qkv, const void* bias, const void* mask,
                                         void* out, int Z, int H, int W, int C, int heads, int wz,
                                         int wh, int ww, int n_types, float scale, void* stream) {
  const size_t wlen = wz * wh * ww, hdp = ((C / heads) + 15) & ~15;
  const size_t smem = wlen * wlen * 4 + 3 * wlen * hdp * 2 + wlen * 4;
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (Z / wz) * (H / wh) * (W / ww) * heads;
  window_attention_kernel<<<blocks, ATT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<bf16*>(out), Z, H, W, C, heads, wz, wh, ww,
      n_types, mask != nullptr, scale);
  return static_cast<int>(cudaGetLastError());
}
