// Windowed multi-head attention with earth bias and shift mask: the kernel
// bodies of K1's attention (fused_block.cu) and of K5, K10 and K11
// (window_attention.cu), which differ only in where a window's tokens lie.
//
// Addr maps (window t, head, token i) to the head's q, k, v rows and its output
// row, so a block reads its wlen x hd lanes straight out of the caller's
// layout and no partition, head split or reverse relayout touches device
// memory.  Window t has bias type t / nw and mask table t / nw (the nw windows
// along the periodic longitude share both), or table 0 where there is one.
//
// Two bodies; which one a shape takes is decided by the wrapper
// (ops/flash_window_attention.py attention_body) and passed in as `body`.
//
// BODY_REGISTERS, window_attention_regs_kernel<Addr, WLP, HDP>: the body of
// every geometry a model uses -- Pangu's (wlen 144, hd 32: WLP 144, HDP 32)
// and FuXi's and FengWu's (wlen 72, hd 64: WLP 80, HDP 64).  The work is bound
// by bytes and by exp, not by the tensor cores, so the design keeps every
// intermediate in registers and every table read to one per run of windows:
//   - a warp owns 16 query rows and all WLP keys; S = q k^T stays in the
//     mma.sync.m16n8k16 accumulators (WLP / 8 tiles x 4 f32 a thread).  The
//     softmax adds the tile (bias + mask) * log2(e) with one FMA a score,
//     takes the row max and sum over the thread's own values plus two quad
//     shuffles, exp2, casts exp2(s - max) to bf16 in registers and feeds the
//     pairs straight to the PV mma as A fragments; the output is divided by
//     the f32 row sums.  (The reference normalises before its cast, one bf16
//     rounding of each weight apart; that order took 6 to 7 % longer on an
//     H100: 72 more multiplies a thread and the sum's shuffles ahead of the
//     second product.)  No score, weight or
//     output tile in shared memory and no block-wide barrier between the two
//     products.
//   - shared memory holds q, k, v of one (window, head), twice (rows padded by
//     16 bytes so ldmatrix does not conflict), and the f32 bias + mask tile of
//     the block's (type, head, window row).  A block walks a run of the nw
//     longitude windows of that row: the tile is fetched once for the run, the
//     next window's q/k/v come in by cp.async while this one computes, one
//     barrier a window.  A row is one run unless that leaves fewer than 4
//     blocks an SM.  (The tile in registers instead, WLP / 2 more a thread,
//     spilt and ran 10 to 18 % slower.)
//   - padded key columns hold -inf in the tile, so they get weight exactly 0
//     with no test in the loop; padded query rows are computed and not
//     written; hd below HDP is zero-filled; rows that are not 16-byte aligned
//     load and store element by element.
//
// BODY_SHARED, window_attention_kernel<Addr, PAD>: the general body for any
// other wlen and hd, one block per (window, head): S through a wlen^2 f32 tile
// in shared memory (padded to a multiple of 16, WLP), softmax one row a warp,
// exp(s - max) kept as bf16 in place of S, PV on the tensor cores, division by
// the f32 row sums after it, as in the register body.  Limits: WLP <= 256 and
// WLP^2*4 + 3*WLP*HDP*2 + WLP*4 bytes of shared memory within a block's 227 KB.
//
// Bound: bytes (q, k, v in, output out, the tables once) and the exp; the
// flops are ~4 * wlen^2 * hd per (window, head).
#pragma once

#include <math.h>
#include <mma.h>

#include "common.cuh"

namespace attention {

using namespace nvcuda;

constexpr int THREADS = 256;
constexpr int MAX_COLS_PER_LANE = 8;  // WLP <= 256
constexpr size_t MAX_SMEM = 232448;   // 227 KB

// An address map gives the origin of window t, the offset rel(i) of token i from its
// window's origin (the same in every window, so a thread computes its own once)
// and, from origin and offset, the head's q, k, v rows and its output row.

// Tokens of window t inside a packed (Z, H, W, 3C) qkv, ordered z, then h,
// then w (skyrim_tpu/ops/windows.py window_partition); windows ordered
// (z-win, h-win, w-win).  Output (Z, H, W, C), heads merged.
struct Packed4D {
  const bf16* qkv;
  bf16* out;
  int H, W, C, hd, wz, wh, ww, nh, nw;

  __device__ __forceinline__ const bf16* base() const { return qkv; }
  __device__ __forceinline__ size_t origin(int t) const {  // the window's first token
    const int win_w = t % nw, win_h = (t / nw) % nh, win_z = t / (nw * nh);
    return ((size_t)(win_z * wz) * H + win_h * wh) * W + win_w * ww;
  }
  __device__ __forceinline__ size_t rel(int i) const {
    const int zi = i / (wh * ww), hi = (i / ww) % wh, wi = i % ww;
    return ((size_t)zi * H + hi) * W + wi;
  }
  __device__ __forceinline__ void src(size_t org, int head, size_t rel, const bf16*& q,
                                      const bf16*& k, const bf16*& v) const {
    q = qkv + (org + rel) * (3 * C) + head * hd;
    k = q + C;
    v = q + 2 * C;
  }
  __device__ __forceinline__ bf16* dst(size_t org, int head, size_t rel) const {
    return out + (org + rel) * C + head * hd;
  }
};

// Partitioned packed rows (nWin, wlen, 3C) -> (nWin, wlen, C).
struct PackedRows {
  const bf16* qkv;
  bf16* out;
  int C, hd, wlen;

  __device__ __forceinline__ const bf16* base() const { return qkv; }
  __device__ __forceinline__ size_t origin(int t) const { return (size_t)t * wlen; }
  __device__ __forceinline__ size_t rel(int i) const { return i; }
  __device__ __forceinline__ void src(size_t org, int head, size_t rel, const bf16*& q,
                                      const bf16*& k, const bf16*& v) const {
    q = qkv + (org + rel) * (3 * C) + head * hd;
    k = q + C;
    v = q + 2 * C;
  }
  __device__ __forceinline__ bf16* dst(size_t org, int head, size_t rel) const {
    return out + (org + rel) * C + head * hd;
  }
};

// Split heads: q, k, v and the output all (nWin, heads, wlen, hd).
struct SplitHeads {
  const bf16 *q, *k, *v;
  bf16* out;
  int heads, hd, wlen;

  __device__ __forceinline__ const bf16* base() const { return q; }
  __device__ __forceinline__ size_t origin(int t) const { return (size_t)t * heads; }
  __device__ __forceinline__ size_t rel(int i) const { return i; }
  __device__ __forceinline__ size_t row(size_t org, int head, size_t rel) const {
    return ((org + head) * wlen + rel) * hd;
  }
  __device__ __forceinline__ void src(size_t org, int head, size_t rel, const bf16*& qr,
                                      const bf16*& kr, const bf16*& vr) const {
    const size_t r = row(org, head, rel);
    qr = q + r;
    kr = k + r;
    vr = v + r;
  }
  __device__ __forceinline__ bf16* dst(size_t org, int head, size_t rel) const {
    return out + row(org, head, rel);
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
      addr.src(org, head, addr.rel(i), qs, ks, vs);
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
    bf16* o = addr.dst(org, head, addr.rel(i)) + c;
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

enum Body { BODY_SHARED = 0, BODY_REGISTERS = 1 };

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BLOCKS_PER_SM = 4;  // a row of windows is cut into runs only below this many blocks an SM

__device__ __forceinline__ float exp2_approx(float x) {  // 2^x, 2^-inf = +0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int WLP, int HDP>
struct RegsShape {
  static_assert(WLP % 16 == 0 && HDP % 32 == 0, "16 query rows a warp; k and v by ldmatrix.x4");
  static constexpr int WARPS = WLP / 16, THREADS = WARPS * 32;
  static constexpr int NT = WLP / 8;    // key tiles of the scores
  static constexpr int LD = HDP + 8;    // shared-memory row, 16 bytes of padding
  static constexpr int LDT = WLP + 8;   // row of the f32 tile: 8 rows x 8 words hit 32 banks
  static constexpr size_t QKV = 3 * (size_t)WLP * LD * sizeof(bf16);  // one window's q, k, v
  static constexpr size_t SMEM = 2 * QKV + (size_t)WLP * LDT * 4;  // + the f32 tile
};

// One block per (window row, head, run of longitude windows); grid x =
// rows * heads * runs, run r of a row covers windows [r * run, min(nw, (r + 1) * run)).
template <class Addr, int WLP, int HDP>
__global__ void __launch_bounds__(RegsShape<WLP, HDP>::THREADS, 1)
    window_attention_regs_kernel(Addr addr, const float* __restrict__ bias,
                                 const float* __restrict__ mask, int heads, int WL, int hd, int nw,
                                 int run, int runs, int n_types, int n_masks, int vec,
                                 float scale) {
  using Sh = RegsShape<WLP, HDP>;
  constexpr int NT = Sh::NT, LD = Sh::LD, DT = HDP / 8, CPR = HDP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* bufs = reinterpret_cast<bf16*>(smem);  // [2][q, k, v][WLP][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q4 = lane & 3;  // the fragment's row and column pair
  const int b = blockIdx.x;
  const int head = (b / runs) % heads, row = b / (runs * heads);
  const int w0 = (b % runs) * run, w1 = min(nw, w0 + run);

  // q, k, v of the window at origin org -> buffer s, zero-padded to WLP rows,
  // HDP lanes; a thread's chunks lie at the same token offsets in every window
  constexpr int CHUNKS = (WLP * CPR + Sh::THREADS - 1) / Sh::THREADS;
  size_t chunk_rel[CHUNKS];
#pragma unroll
  for (int n = 0; n < CHUNKS; ++n) chunk_rel[n] = addr.rel(min((tid + n * Sh::THREADS) / CPR, WL - 1));
  auto load_window = [&](int w, int s) {
    const size_t org = addr.origin(row * nw + w);
    bf16* Qs = bufs + (size_t)s * 3 * WLP * LD;
#pragma unroll
    for (int n = 0; n < CHUNKS; ++n) {
      const int c8 = tid + n * Sh::THREADS;
      if (c8 >= WLP * CPR) break;
      const int i = c8 / CPR, c = (c8 % CPR) * 8;
      const bool ok = i < WL && c < hd;
      const bf16 *qs = addr.base(), *ks = qs, *vs = qs;
      if (ok) {
        addr.src(org, head, chunk_rel[n], qs, ks, vs);
        qs += c, ks += c, vs += c;
      }
      bf16* d = Qs + i * LD + c;
      if (vec) {
        cp_async16(d, qs, ok);
        cp_async16(d + WLP * LD, ks, ok);
        cp_async16(d + 2 * WLP * LD, vs, ok);
      } else {
        const uint4 z = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(d) = ok ? load_lanes(qs, hd - c, false) : z;
        *reinterpret_cast<uint4*>(d + WLP * LD) = ok ? load_lanes(ks, hd - c, false) : z;
        *reinterpret_cast<uint4*>(d + 2 * WLP * LD) = ok ? load_lanes(vs, hd - c, false) : z;
      }
    }
    cp_async_commit();
  };
  load_window(w0, 0);

  // the run's tile: (bias[type, head] + mask[row]) * log2(e) over the WL real
  // keys, -inf in the padded key columns, 0 in the padded query rows
  const float* brow = bias + ((size_t)(n_types == 1 ? 0 : row) * heads + head) * WL * WL;
  const float* mrow = mask ? mask + (size_t)(n_masks == 1 ? 0 : row) * WL * WL : nullptr;
  const int r0 = warp * 16 + g;  // this thread's query rows: r0 and r0 + 8
  const size_t out_rel[2] = {addr.rel(min(r0, WL - 1)), addr.rel(min(r0 + 8, WL - 1))};
  float* tile = reinterpret_cast<float*>(smem + 2 * Sh::QKV);  // [WLP][LDT]
  if (WL % 4 == 0) {  // 16-byte loads, TILE_LOADS of them in flight a thread
    constexpr int TILE_LOADS = 6;
    const int n4 = WL * WL / 4, c4 = WL / 4;
    const float4 *b4 = reinterpret_cast<const float4*>(brow), *m4 = reinterpret_cast<const float4*>(mrow);
    for (int i0 = tid; i0 < n4; i0 += TILE_LOADS * Sh::THREADS) {
      float4 bv[TILE_LOADS], mv[TILE_LOADS];
#pragma unroll
      for (int u = 0; u < TILE_LOADS; ++u) {
        const int i = i0 + u * Sh::THREADS;
        bv[u] = mv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < n4) bv[u] = b4[i];
        if (i < n4 && mrow) mv[u] = m4[i];
      }
#pragma unroll
      for (int u = 0; u < TILE_LOADS; ++u) {
        const int i = i0 + u * Sh::THREADS;
        if (i < n4)
          *reinterpret_cast<float4*>(tile + (i / c4) * Sh::LDT + (i % c4) * 4) =
              make_float4((bv[u].x + mv[u].x) * LOG2E, (bv[u].y + mv[u].y) * LOG2E,
                          (bv[u].z + mv[u].z) * LOG2E, (bv[u].w + mv[u].w) * LOG2E);
      }
    }
  } else {
    for (int i = tid; i < WL * WL; i += Sh::THREADS)
      tile[(i / WL) * Sh::LDT + i % WL] = (brow[i] + (mrow ? mrow[i] : 0.f)) * LOG2E;
  }
  for (int i = tid; i < WLP * WLP - WL * WL; i += Sh::THREADS) {  // the padding, where WL < WLP
    const int r = i < (WLP - WL) * WLP ? WL + i / WLP : (i - (WLP - WL) * WLP) / (WLP - WL);
    const int c = i < (WLP - WL) * WLP ? i % WLP : WL + (i - (WLP - WL) * WLP) % (WLP - WL);
    tile[r * Sh::LDT + c] = c < WL ? 0.f : -INFINITY;
  }
  const float c2 = scale * LOG2E;

  for (int w = w0; w < w1; ++w) {
    const int s = (w - w0) & 1;
    cp_async_wait<0>();
    __syncthreads();  // window w (and the tile) landed; every warp is done with the other buffer
    if (w + 1 < w1) load_window(w + 1, s ^ 1);
    const bf16* Qs = bufs + (size_t)s * 3 * WLP * LD;
    const bf16* Ks = Qs + WLP * LD;
    const bf16* Vs = Ks + WLP * LD;

    // S = q k^T: this warp's 16 rows against every key tile
    unsigned qf[HDP / 16][4];
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk)
      ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + kk * 16 +
                              (lane >> 4) * 8);
    float S[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      S[j][0] = S[j][1] = S[j][2] = S[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HDP / 32; ++kk) {
        unsigned kf[4];  // keys 8j.., lanes 32kk .. 32kk + 31: two k16 steps
        ldmatrix_x4(kf, Ks + (j * 8 + (lane & 7)) * LD + kk * 32 + (lane >> 3) * 8);
        mma_16816(S[j], qf[2 * kk], kf[0], kf[1]);
        mma_16816(S[j], qf[2 * kk + 1], kf[2], kf[3]);
      }
    }

    // softmax over the keys, in f32 registers, base 2
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 ta = *reinterpret_cast<const float2*>(tile + r0 * Sh::LDT + j * 8 + q4 * 2);
      const float2 tb = *reinterpret_cast<const float2*>(tile + (r0 + 8) * Sh::LDT + j * 8 + q4 * 2);
      S[j][0] = fmaf(S[j][0], c2, ta.x);
      S[j][1] = fmaf(S[j][1], c2, ta.y);
      S[j][2] = fmaf(S[j][2], c2, tb.x);
      S[j][3] = fmaf(S[j][3], c2, tb.y);
      mx0 = fmaxf(mx0, fmaxf(S[j][0], S[j][1]));
      mx1 = fmaxf(mx1, fmaxf(S[j][2], S[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      S[j][0] = exp2_approx(S[j][0] - mx0);
      S[j][1] = exp2_approx(S[j][1] - mx0);
      S[j][2] = exp2_approx(S[j][2] - mx1);
      S[j][3] = exp2_approx(S[j][3] - mx1);
      sum0 += S[j][0] + S[j][1];
      sum1 += S[j][2] + S[j][3];
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;  // applied to the output, after PV

    // O = P v: two neighbouring score tiles are the A fragments of one k16 step
    float O[DT][4];
#pragma unroll
    for (int d = 0; d < DT; ++d) O[d][0] = O[d][1] = O[d][2] = O[d][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < WLP / 16; ++ks) {
      unsigned pf[4];
      pf[0] = pack_bf16(S[2 * ks][0], S[2 * ks][1]);
      pf[1] = pack_bf16(S[2 * ks][2], S[2 * ks][3]);
      pf[2] = pack_bf16(S[2 * ks + 1][0], S[2 * ks + 1][1]);
      pf[3] = pack_bf16(S[2 * ks + 1][2], S[2 * ks + 1][3]);
#pragma unroll
      for (int dp = 0; dp < HDP / 16; ++dp) {
        unsigned vf[4];  // keys 16ks.., lanes 16dp .. 16dp + 15: two n8 tiles
        ldmatrix_x4_trans(vf, Vs + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dp * 16 +
                                  (lane >> 4) * 8);
        mma_16816(O[2 * dp], pf, vf[0], vf[1]);
        mma_16816(O[2 * dp + 1], pf, vf[2], vf[3]);
      }
    }

    // write the head's lanes of the real rows: a quad exchanges its column
    // pairs so that each lane stores 8 consecutive lanes of a row
    const size_t org = addr.origin(row * nw + w);
#pragma unroll
    for (int d4 = 0; d4 < DT / 4; ++d4) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x[4][2], o8[8];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          x[t][0] = O[d4 * 4 + t][2 * h] * (h ? inv1 : inv0);
          x[t][1] = O[d4 * 4 + t][2 * h + 1] * (h ? inv1 : inv0);
        }
        quad_transpose(x, o8);
        const int i = r0 + 8 * h, c = (d4 * 4 + q4) * 8;
        if (i < WL && c < hd) {
          bf16* o = addr.dst(org, head, out_rel[h]) + c;
          if (vec) {
            store8(o, o8);
          } else {
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (c + u < hd) o[u] = __float2bfloat16(o8[u]);
          }
        }
      }
    }
  }
}

template <class Addr, int WLP, int HDP>
int launch_regs(const Addr& addr, const float* bias, const float* mask, int n_win, int heads,
                int WL, int hd, int nw, int n_types, int n_masks, int vec, float scale,
                cudaStream_t stream) {
  using Sh = RegsShape<WLP, HDP>;
  const int sms = sm_count();
  if (n_types == 1 && (n_masks <= 1 || !mask)) nw = n_win;  // one table: every window shares it
  const int rows = n_win / nw;
  const int want = (BLOCKS_PER_SM * sms + rows * heads - 1) / (rows * heads);
  const int run = (nw + min(want, nw) - 1) / min(want, nw), runs = (nw + run - 1) / run;
  auto kernel = window_attention_regs_kernel<Addr, WLP, HDP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sh::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<rows * heads * runs, Sh::THREADS, Sh::SMEM, stream>>>(
      addr, bias, mask, heads, WL, hd, nw, run, runs, n_types, n_masks, vec, scale);
  return static_cast<int>(cudaGetLastError());
}

// n_win windows of WL tokens, nw of them along longitude per bias type and
// mask table.  `body` is the wrapper's choice; a shape its body does not take
// is refused here and the error goes back to the wrapper, which raises.
template <class Addr>
int launch(const Addr& addr, const void* bias, const void* mask, int n_win, int heads, int WL,
           int hd, int nw, int n_types, int n_masks, int vec, float scale, int body, void* stream) {
  const float *bf = static_cast<const float*>(bias), *mf = static_cast<const float*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t wlp = (WL + 15) & ~15, hdp = (hd + 15) & ~15;
  if (body == BODY_REGISTERS) {
    if (wlp == 144 && hd <= 32)
      return launch_regs<Addr, 144, 32>(addr, bf, mf, n_win, heads, WL, hd, nw, n_types, n_masks,
                                        vec, scale, st);
    if (wlp == 80 && hd > 32 && hd <= 64)
      return launch_regs<Addr, 80, 64>(addr, bf, mf, n_win, heads, WL, hd, nw, n_types, n_masks,
                                       vec, scale, st);
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const size_t smem = wlp * wlp * 4 + 3 * wlp * hdp * 2 + wlp * 4;
  if (wlp > 32 * MAX_COLS_PER_LANE || smem > MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kernel = WL % 16 ? window_attention_kernel<Addr, true> : window_attention_kernel<Addr, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_win * heads, THREADS, smem, st>>>(addr, bf, mf, heads, WL, hd, nw, n_types, n_masks,
                                               vec, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attention
