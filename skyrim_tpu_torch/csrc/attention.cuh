// Windowed multi-head attention with earth bias and shift mask: one kernel
// body for K1's attention (fused_block.cu) and for K5, K10 and K11
// (window_attention.cu), which differ only in where a window's tokens lie.
//
// window_attention_kernel<Addr>: one thread block per (window, head).  Addr
// maps (window t, head, token i) to the head's q, k, v rows and its output
// row, so the block reads its wlen x hd lanes straight out of the caller's
// layout and no partition, head split or reverse relayout touches device
// memory.  It computes S = q k^T on the tensor cores into shared memory
// (wlen^2 f32 = 83 KB at wlen 144), adds scale, bias[type, head] and
// mask[z-win, h-win] in f32, takes exp(s - max) in f32 and keeps it as bf16 in
// place of S, computes (e V) on the tensor cores, divides by the f32 row sums
// and writes the head's lanes.  The reference normalises before its cast to
// bf16; dividing after the product keeps the row-sum reduction off the path to
// the weights' stores (normalising first cost 0.28 ms of 2.9 ms at Pangu stage
// 1 on an H100) and differs by one bf16 rounding of each weight.
//
// Any wlen and hd: the score tile is padded to a multiple of 16 in shared
// memory (WLP); padded key columns take no part in the max or the sum and get
// weight 0, padded query rows are not written.  hd is zero-padded to a
// multiple of 16 (HDP), and rows that are not 16-byte aligned (hd % 8 != 0)
// load and store element by element.  What remains: WLP <= 256 and
// WLP^2*4 + 3*WLP*HDP*2 + WLP*4 bytes of shared memory within a block's 227 KB
// (wlen 144 with hd up to 128; wlen up to 224 at hd 16).  The kernel is
// compiled once for padded and once for unpadded windows: with the padding's
// tests in the softmax loop Pangu's wlen 144 ran 10 % slower.
//
// Window t has bias type t / nw and mask table t / nw (nw windows along the
// periodic longitude share both), or table 0 where there is one.
//
// Bound: bytes of the f32 bias and mask tables (read from L2 once per block,
// shared along longitude) and the exp; the flops are ~4 * wlen^2 * hd per
// block.  At wlen 144, hd 32 a block takes 111 KB, so two fit on an SM; the
// f32 output tile reuses the q/k buffers.
#pragma once

#include <math.h>
#include <mma.h>

#include "common.cuh"

namespace attention {

using namespace nvcuda;

constexpr int THREADS = 256;
constexpr int MAX_COLS_PER_LANE = 8;  // WLP <= 256
constexpr size_t MAX_SMEM = 232448;   // 227 KB

// An address map gives, once per block, the origin of window t, and from it
// the head's q, k, v rows and output row of token i.

// Tokens of window t inside a packed (Z, H, W, 3C) qkv, ordered z, then h,
// then w (skyrim_tpu/ops/windows.py window_partition); windows ordered
// (z-win, h-win, w-win).  Output (Z, H, W, C), heads merged.
struct Packed4D {
  const bf16* qkv;
  bf16* out;
  int H, W, C, hd, wz, wh, ww, nh, nw;

  __device__ __forceinline__ size_t origin(int t) const {  // the window's first token
    const int win_w = t % nw, win_h = (t / nw) % nh, win_z = t / (nw * nh);
    return ((size_t)(win_z * wz) * H + win_h * wh) * W + win_w * ww;
  }
  __device__ __forceinline__ size_t token(size_t org, int i) const {
    const int zi = i / (wh * ww), hi = (i / ww) % wh, wi = i % ww;
    return org + ((size_t)zi * H + hi) * W + wi;
  }
  __device__ __forceinline__ void src(size_t org, int head, int i, const bf16*& q, const bf16*& k,
                                      const bf16*& v) const {
    q = qkv + token(org, i) * (3 * C) + head * hd;
    k = q + C;
    v = q + 2 * C;
  }
  __device__ __forceinline__ bf16* dst(size_t org, int head, int i) const {
    return out + token(org, i) * C + head * hd;
  }
};

// Partitioned packed rows (nWin, wlen, 3C) -> (nWin, wlen, C).
struct PackedRows {
  const bf16* qkv;
  bf16* out;
  int C, hd, wlen;

  __device__ __forceinline__ size_t origin(int t) const { return (size_t)t * wlen; }
  __device__ __forceinline__ void src(size_t org, int head, int i, const bf16*& q, const bf16*& k,
                                      const bf16*& v) const {
    q = qkv + (org + i) * (3 * C) + head * hd;
    k = q + C;
    v = q + 2 * C;
  }
  __device__ __forceinline__ bf16* dst(size_t org, int head, int i) const {
    return out + (org + i) * C + head * hd;
  }
};

// Split heads: q, k, v and the output all (nWin, heads, wlen, hd).
struct SplitHeads {
  const bf16 *q, *k, *v;
  bf16* out;
  int heads, hd, wlen;

  __device__ __forceinline__ size_t origin(int t) const { return (size_t)t * heads; }
  __device__ __forceinline__ size_t row(size_t org, int head, int i) const {
    return ((org + head) * wlen + i) * hd;
  }
  __device__ __forceinline__ void src(size_t org, int head, int i, const bf16*& qr, const bf16*& kr,
                                      const bf16*& vr) const {
    const size_t r = row(org, head, i);
    qr = q + r;
    kr = k + r;
    vr = v + r;
  }
  __device__ __forceinline__ bf16* dst(size_t org, int head, int i) const {
    return out + row(org, head, i);
  }
};

// 8 lanes of a row as one 16-byte value: a vector load where rows are 16-byte
// aligned, else the first n (<= 8) values one by one, zero-filled.
__device__ __forceinline__ uint4 load_lanes(const bf16* p, int n, bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(p);
  unsigned w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned lo = 2 * j < n ? __bfloat16_as_ushort(p[2 * j]) : 0u;
    const unsigned hi = 2 * j + 1 < n ? __bfloat16_as_ushort(p[2 * j + 1]) : 0u;
    w[j] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// bias (n_types, heads, WL, WL) f32; mask (n_masks, WL, WL) f32 or null.
// vec: every q/k/v/output row is 16-byte aligned (hd % 8 == 0, aligned bases).
template <class Addr, bool PAD>
__global__ void __launch_bounds__(THREADS, 2)
    window_attention_kernel(Addr addr, const float* __restrict__ bias,
                            const float* __restrict__ mask, int heads, int WL, int hd, int nw,
                            int n_types, int n_masks, int vec, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int WLP = PAD ? (WL + 15) & ~15 : WL;  // !PAD: WL % 16 == 0
  const int HDP = (hd + 15) & ~15;

  // lon window fastest: consecutive blocks share one (type, head) bias table
  const int b = blockIdx.x;
  const int head = (b / nw) % heads;
  const int row = b / (nw * heads);  // (z-win, h-win) row of windows
  const size_t org = addr.origin(row * nw + b % nw);

  float* S = reinterpret_cast<float*>(smem);          // WLP x WLP scores, then bf16 P in place
  bf16* Qs = reinterpret_cast<bf16*>(S + WLP * WLP);  // WLP x HDP
  bf16* Ks = Qs + WLP * HDP;
  bf16* Vs = Ks + WLP * HDP;
  float* Os = reinterpret_cast<float*>(Qs);  // WLP x HDP f32, over Qs and Ks once S is done
  float* rowsum = reinterpret_cast<float*>(Vs + WLP * HDP);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;

  // 1. this head's q, k, v -> shared memory, zero-padded to WLP rows, HDP lanes
  const int cpr = HDP / 8;
  for (int c8 = tid; c8 < WLP * cpr; c8 += blockDim.x) {
    const int i = c8 / cpr, c = (c8 % cpr) * 8;
    uint4 q = make_uint4(0, 0, 0, 0), k = q, v = q;
    if ((!PAD || i < WL) && c < hd) {
      const bf16 *qs, *ks, *vs;
      addr.src(org, head, i, qs, ks, vs);
      q = load_lanes(qs + c, hd - c, vec);
      k = load_lanes(ks + c, hd - c, vec);
      v = load_lanes(vs + c, hd - c, vec);
    }
    *reinterpret_cast<uint4*>(Qs + i * HDP + c) = q;
    *reinterpret_cast<uint4*>(Ks + i * HDP + c) = k;
    *reinterpret_cast<uint4*>(Vs + i * HDP + c) = v;
  }
  __syncthreads();

  // 2. S = q k^T (k row-major is k^T column-major)
  const int T = WLP / 16;
  for (int tile = warp; tile < T * T; tile += nwarps) {
    const int ti = tile / T, tj = tile % T;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < HDP; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
      wmma::load_matrix_sync(a, Qs + ti * 16 * HDP + kk, HDP);
      wmma::load_matrix_sync(bk, Ks + tj * 16 * HDP + kk, HDP);
      wmma::mma_sync(acc, a, bk, acc);
    }
    wmma::store_matrix_sync(S + ti * 16 * WLP + tj * 16, acc, WLP, wmma::mem_row_major);
  }
  __syncthreads();

  // 3. rows: s*scale + bias + mask over the WL real keys, e = exp(s - max)
  //    kept as bf16 over the row's own f32 bytes (0 for padded keys and padded
  //    query rows), f32 row sums
  const int type = n_types == 1 ? 0 : row;
  const float* brow0 = bias + ((size_t)type * heads + head) * WL * WL;
  const float* mrow0 = mask ? mask + (size_t)(n_masks == 1 ? 0 : row) * WL * WL : nullptr;
  for (int r = warp; r < WLP; r += nwarps) {
    float vals[MAX_COLS_PER_LANE];
    float mx = -INFINITY;
#pragma unroll
    for (int u = 0; u < MAX_COLS_PER_LANE; ++u) {
      const int c = lane + 32 * u;
      vals[u] = -INFINITY;
      if ((!PAD || r < WL) && c < WL) {
        float s = S[r * WLP + c] * scale + brow0[(size_t)r * WL + c];
        if (mrow0) s += mrow0[(size_t)r * WL + c];
        vals[u] = s;
        mx = fmaxf(mx, s);
      }
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < MAX_COLS_PER_LANE; ++u) {
      vals[u] = !PAD || r < WL ? expf(vals[u] - mx) : 0.f;  // exp(-inf) = 0 for the unused slots
      sum += vals[u];
    }
    sum = warp_sum(sum);
    __syncwarp();
    bf16* P = reinterpret_cast<bf16*>(S + r * WLP);
#pragma unroll
    for (int u = 0; u < MAX_COLS_PER_LANE; ++u) {
      const int c = lane + 32 * u;
      if (c < WLP) P[c] = __float2bfloat16(vals[u]);
    }
    if (lane == 0) rowsum[r] = sum;
  }
  __syncthreads();

  // 4. O = P V
  const int LDP = 2 * WLP;
  const bf16* P = reinterpret_cast<const bf16*>(S);
  const int TD = HDP / 16;
  for (int tile = warp; tile < T * TD; tile += nwarps) {
    const int ti = tile / TD, tj = tile % TD;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < WLP; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
      wmma::load_matrix_sync(a, P + ti * 16 * LDP + kk, LDP);
      wmma::load_matrix_sync(bv, Vs + kk * HDP + tj * 16, HDP);
      wmma::mma_sync(acc, a, bv, acc);
    }
    wmma::store_matrix_sync(Os + ti * 16 * HDP + tj * 16, acc, HDP, wmma::mem_row_major);
  }
  __syncthreads();

  // 5. normalise and write this head's lanes of the WL real rows
  for (int c8 = tid; c8 < WL * cpr; c8 += blockDim.x) {
    const int i = c8 / cpr, c = (c8 % cpr) * 8;
    if (c >= hd) continue;
    bf16* o = addr.dst(org, head, i) + c;
    const float den = rowsum[i];
    float o8[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) o8[u] = Os[i * HDP + c + u] / den;
    if (vec) {
      store8(o, o8);
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (c + u < hd) o[u] = __float2bfloat16(o8[u]);
    }
  }
}

// n_win windows of WL tokens, nw of them along longitude per bias type and
// mask table.  A window too large for shared memory is refused here; the
// error goes back to the wrapper, which raises.
template <class Addr>
int launch(const Addr& addr, const void* bias, const void* mask, int n_win, int heads, int WL,
           int hd, int nw, int n_types, int n_masks, int vec, float scale, void* stream) {
  const size_t wlp = (WL + 15) & ~15, hdp = (hd + 15) & ~15;
  const size_t smem = wlp * wlp * 4 + 3 * wlp * hdp * 2 + wlp * 4;
  if (wlp > 32 * MAX_COLS_PER_LANE || smem > MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kernel = WL % 16 ? window_attention_kernel<Addr, true> : window_attention_kernel<Addr, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_win * heads, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      addr, static_cast<const float*>(bias), static_cast<const float*>(mask), heads, WL, hd, nw,
      n_types, n_masks, vec, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attention
