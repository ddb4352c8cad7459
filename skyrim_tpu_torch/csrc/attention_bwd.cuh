// K1's attention backward: the reverse of attention.cuh's register body on the
// block's packed (Z, H, W, 3C) qkv, for K1's backward replay
// (ops/fused_block.py window_attention_backward).  It replaces no TPU kernel:
// the JAX package differentiates K1 by replaying its XLA composition
// (skyrim_tpu/ops/fused_block.py _fused_swin_block_bwd), and the port's replay
// ran that composition's attention in f32 over whole-stage score tensors.
//
// Per (window, head), with P = softmax(q k^T * scale + bias + mask) and dO the
// gradient of the attention output:
//   dP = dO v^T,  dS = P o (dP - rowsum(P o dP)),
//   dq = dS k * scale,  dk = dS^T q * scale,  dv = P^T dO,
//   dbias[type, head] = the sum of dS over the type's windows.
// rowsum(P o dP) equals rowsum(dO o O), so neither O nor a log-sum-exp is saved.
//
// Bound on this card: bytes (q, k, v and dO in, dq, dk, dv out, the f32 bias,
// mask and dbias tables once): at Pangu stage 1, 1.5 GB, 0.47 ms at 3.35 TB/s,
// against 0.15 TFLOP of products.  The design keeps every score-sized quantity
// out of device memory:
//   - a block owns one (window row, head): the bias type and mask table of a
//     row of nw longitude windows, which it walks.  The f32 (bias + mask) *
//     log2(e) tile is read once for the row, as in the forward body, and the
//     next window's q, k, v, dO come in by cp.async while this one computes.
//   - a warp owns 16 query rows and all WLP keys.  S = q k^T and dP = dO v^T
//     are recomputed in the mma.sync.m16n8k16 f32 accumulators a key tile
//     at a time, in three passes over the keys: the row max of the logits;
//     the row sums of e = exp2(logit - max) and of e o dP; then P = e / sum,
//     dS and dbias.  The softmax is exact (the whole row is in the warp's
//     quads) and no score-sized array stays in registers beside dbias's
//     WLP / 2 a thread: at 9 warps a block a thread has 168 registers (3
//     warps share a scheduler's 16,384), and keeping P there as well spilt
//     376 bytes a thread and ran 12 % slower at Pangu's stage 2 on an H100.
//     dq = dS k is warp-local: dS packed to bf16 feeds the product from
//     registers.
//   - dk and dv reduce over query rows: P, then dS, go through one bf16 tile
//     in shared memory, and warps own key rows for dv = P^T dO and dk = dS^T q
//     (ldmatrix.trans makes the transposes).
//   - dbias is summed in f32 registers over the row's windows, each thread on
//     its own fragment positions, and written once: a fixed order and no
//     atomics, so two runs give the same bits.  Where the rows are cut into
//     runs (too few rows to fill the card, or one bias table for every row),
//     each run writes its partial sum and the wrapper adds them in a fixed
//     order.
//   - P and dS are rounded to bf16 only as operands of the dv, dq and dk
//     products; scores, softmax, dP, dS and dbias stay f32.  Padded keys hold
//     -inf in the tile and get P = 0 exactly; padded query rows read zero q and
//     dO, so their dS is 0 and they add nothing to dk, dv or dbias.
//
// Measured (H100 80GB HBM3, 700 W): 2.13 ms at Pangu's stage 1 (22 % of the
// bound), 1.12 ms at stage 2 (23 %), 1.01 ms at FengWu's (1, 186, 360, 1152)
// (32 %); ptxas still spills 248 bytes a thread at WLP 144.
//
// Geometries: Pangu's (wlen 129-144, hd <= 32: WLP 144, HDP 32, 9 warps) and
// FuXi's and FengWu's (wlen 65-80, hd 33-64: WLP 80, HDP 64, 5 warps), hd a
// multiple of 8 and every row 16-byte aligned; any other geometry keeps the
// plain f32 replay (ops/fused_block.py attention_backward_body).  Shared
// memory at WLP 144: 2 x 46,080 (q, k, v, dO twice) + 87,552 (the f32 tile) +
// 43,776 (the bf16 P / dS tile) = 223,488 bytes, one block an SM.
#pragma once

#include "attention.cuh"

namespace attention_bwd {

using attention::exp2_approx;
using attention::LOG2E;
using attention::Packed4D;

template <int WLP, int HDP>
struct Shape {
  static_assert(WLP % 16 == 0 && HDP % 32 == 0, "16 query rows a warp; operands by ldmatrix.x4");
  static constexpr int WARPS = WLP / 16, THREADS = WARPS * 32;
  static constexpr int NT = WLP / 8;    // key tiles of the scores
  static constexpr int KS = WLP / 16;   // k16 steps over keys or query rows
  static constexpr int LD = HDP + 8;    // q, k, v, dO row, 16 bytes of padding
  static constexpr int LDT = WLP + 8;   // f32 tile row
  static constexpr int LDS = WLP + 8;   // bf16 P / dS row: 8 rows of 16 bytes hit 32 banks
  static constexpr size_t BUF = 4 * (size_t)WLP * LD * sizeof(bf16);  // q, k, v, dO of one window
  static constexpr size_t TILE = (size_t)WLP * LDT * sizeof(float);
  static constexpr size_t STAGE = (size_t)WLP * LDS * sizeof(bf16);
  static constexpr size_t SMEM = 2 * BUF + TILE + STAGE;
};

// acc (16 rows of the warp x HDP lanes, m16n8 fragments) * mul -> the lanes at
// `slot` (0: q, C: k, 2C: v) of dqkv's rows r0, r0 + 8; a quad exchanges its
// column pairs so that each lane stores 8 consecutive lanes of a row.
template <int HDP>
__device__ __forceinline__ void store_rows(bf16* dqkv, const float (&acc)[HDP / 8][4], float mul,
                                           size_t org, const size_t (&rel)[2], int r0, int WL,
                                           int hd, int C, int slot, int head) {
  const int q4 = threadIdx.x & 3;
#pragma unroll
  for (int d4 = 0; d4 < HDP / 32; ++d4) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x[4][2], o8[8];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        x[t][0] = acc[d4 * 4 + t][2 * h] * mul;
        x[t][1] = acc[d4 * 4 + t][2 * h + 1] * mul;
      }
      quad_transpose(x, o8);
      const int i = r0 + 8 * h, c = (d4 * 4 + q4) * 8;
      if (i < WL && c < hd) store8(dqkv + (org + rel[h]) * (3 * (size_t)C) + slot + head * hd + c, o8);
    }
  }
}

// One block per (window row, head, run of longitude windows); grid x =
// rows * heads * runs, run r of a row covering windows [r * run, min(nw, (r + 1)
// * run)).  dbias: the run's partial sums, (rows, runs, heads, WL, WL) f32.
template <int WLP, int HDP>
__global__ void __launch_bounds__(Shape<WLP, HDP>::THREADS, 1)
    window_attention_bwd_kernel(Packed4D addr, const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
                                const float* __restrict__ bias, const float* __restrict__ mask,
                                float* __restrict__ dbias, int heads, int WL, int hd, int nw,
                                int run, int runs, int n_types, int n_masks, float scale) {
  using Sh = Shape<WLP, HDP>;
  constexpr int NT = Sh::NT, KS = Sh::KS, LD = Sh::LD, LDS = Sh::LDS, DT = HDP / 8, CPR = HDP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* bufs = reinterpret_cast<bf16*>(smem);                              // [2][q, k, v, dO][WLP][LD]
  float* tile = reinterpret_cast<float*>(smem + 2 * Sh::BUF);              // [WLP][LDT]
  bf16* stage = reinterpret_cast<bf16*>(smem + 2 * Sh::BUF + Sh::TILE);   // [WLP][LDS]: P, then dS

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q4 = lane & 3;  // the fragment's row and column pair
  const int b = blockIdx.x;
  const int part = b % runs, head = (b / runs) % heads, row = b / (runs * heads);
  const int w0 = part * run, w1 = min(nw, w0 + run);
  const int C = addr.C;

  // q, k, v, dO of the window at origin org -> buffer s, zero-padded to WLP
  // rows, HDP lanes; a thread's chunks lie at the same token offsets in every window
  constexpr int CHUNKS = (WLP * CPR + Sh::THREADS - 1) / Sh::THREADS;
  size_t chunk_rel[CHUNKS];
#pragma unroll
  for (int n = 0; n < CHUNKS; ++n) chunk_rel[n] = addr.rel(min((tid + n * Sh::THREADS) / CPR, WL - 1));
  auto load_window = [&](int w, int s) {
    const size_t org = addr.origin(row * nw + w);
    bf16* Qs = bufs + (size_t)s * 4 * WLP * LD;
#pragma unroll
    for (int n = 0; n < CHUNKS; ++n) {
      const int c8 = tid + n * Sh::THREADS;
      if (c8 >= WLP * CPR) break;
      const int i = c8 / CPR, c = (c8 % CPR) * 8;
      const bool ok = i < WL && c < hd;
      const bf16 *qs = addr.qkv, *ks = qs, *vs = qs, *ds = dout;
      if (ok) {
        const size_t tok = org + chunk_rel[n];
        qs = addr.qkv + tok * (3 * (size_t)C) + head * hd + c;
        ks = qs + C;
        vs = qs + 2 * C;
        ds = dout + tok * C + head * hd + c;
      }
      bf16* d = Qs + i * LD + c;
      cp_async16(d, qs, ok);
      cp_async16(d + WLP * LD, ks, ok);
      cp_async16(d + 2 * WLP * LD, vs, ok);
      cp_async16(d + 3 * WLP * LD, ds, ok);
    }
    cp_async_commit();
  };
  load_window(w0, 0);

  // the row's tile, as the forward body builds it: (bias[type, head] +
  // mask[row]) * log2(e) over the WL real keys, -inf in the padded key
  // columns, 0 in the padded query rows
  const float* brow = bias + ((size_t)(n_types == 1 ? 0 : row) * heads + head) * WL * WL;
  const float* mrow = mask ? mask + (size_t)(n_masks == 1 ? 0 : row) * WL * WL : nullptr;
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
  const int r0 = warp * 16 + g;  // this thread's query rows, and in dk and dv its key rows: r0, r0 + 8
  const size_t rel[2] = {addr.rel(min(r0, WL - 1)), addr.rel(min(r0 + 8, WL - 1))};
  const int key0 = warp * 16;    // the warp's key rows in dk and dv

  float dB[NT][4];  // the row's dbias at this thread's fragment positions
#pragma unroll
  for (int j = 0; j < NT; ++j) dB[j][0] = dB[j][1] = dB[j][2] = dB[j][3] = 0.f;

  for (int w = w0; w < w1; ++w) {
    const int s = (w - w0) & 1;
    cp_async_wait<0>();
    __syncthreads();  // window w (and the tile) landed; every warp is done with the other buffer and the stage
    if (w + 1 < w1) load_window(w + 1, s ^ 1);
    const bf16* Qs = bufs + (size_t)s * 4 * WLP * LD;
    const bf16* Ks = Qs + WLP * LD;
    const bf16* Vs = Ks + WLP * LD;
    const bf16* Ds = Vs + WLP * LD;
    const size_t org = addr.origin(row * nw + w);

    // three passes over the key tiles, S = q k^T and dP = dO v^T recomputed a
    // tile at a time, so that no score-sized array stays in registers beside
    // dbias: (1) the row max of the base-2 logits; (2) the row sum of
    // e = exp2(logit - max) and rowsum(e o dP); (3) P = e / sum, P into the
    // stage, dS = P o (dP - rowsum(P o dP)) into dbias and, in bf16, into sf
    unsigned qf[HDP / 16][4], of[HDP / 16][4];
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const int off = (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + kk * 16 + (lane >> 4) * 8;
      ldmatrix_x4(qf[kk], Qs + off);
      ldmatrix_x4(of[kk], Ds + off);
    }
    // tile j of a product of this warp's 16 rows (a) with the keys' rows of b: keys 8j..,
    // lanes 32kk .. 32kk + 31 two k16 steps a ldmatrix
    auto product = [&](const unsigned (&a)[HDP / 16][4], const bf16* rhs, int j, float (&d)[4]) {
      d[0] = d[1] = d[2] = d[3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HDP / 32; ++kk) {
        unsigned f[4];
        ldmatrix_x4(f, rhs + (j * 8 + (lane & 7)) * LD + kk * 32 + (lane >> 3) * 8);
        mma_16816(d, a[2 * kk], f[0], f[1]);
        mma_16816(d, a[2 * kk + 1], f[2], f[3]);
      }
    };
    auto logits = [&](int j, float (&x)[4]) {  // S c2 + tile: the base-2 logits of tile j
      product(qf, Ks, j, x);
      const float2 ta = *reinterpret_cast<const float2*>(tile + r0 * Sh::LDT + j * 8 + q4 * 2);
      const float2 tb = *reinterpret_cast<const float2*>(tile + (r0 + 8) * Sh::LDT + j * 8 + q4 * 2);
      x[0] = fmaf(x[0], c2, ta.x);
      x[1] = fmaf(x[1], c2, ta.y);
      x[2] = fmaf(x[2], c2, tb.x);
      x[3] = fmaf(x[3], c2, tb.y);
    };
    auto quad_sum = [](float v) {
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      return v + __shfl_xor_sync(0xffffffffu, v, 2);
    };
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float x[4];
      logits(j, x);
      mx0 = fmaxf(mx0, fmaxf(x[0], x[1]));
      mx1 = fmaxf(mx1, fmaxf(x[2], x[3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    float sum0 = 0.f, sum1 = 0.f, D0 = 0.f, D1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float x[4], dp[4];
      logits(j, x);
      product(of, Vs, j, dp);
      const float e0 = exp2_approx(x[0] - mx0), e1 = exp2_approx(x[1] - mx0);
      const float e2 = exp2_approx(x[2] - mx1), e3 = exp2_approx(x[3] - mx1);
      sum0 += e0 + e1;
      sum1 += e2 + e3;
      D0 += e0 * dp[0] + e1 * dp[1];
      D1 += e2 * dp[2] + e3 * dp[3];
    }
    const float inv0 = 1.f / quad_sum(sum0), inv1 = 1.f / quad_sum(sum1);
    D0 = quad_sum(D0) * inv0;
    D1 = quad_sum(D1) * inv1;
    unsigned sf[KS][4];  // dS in bf16: the A fragments of dq = dS k, later the stage's dS
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float x[4], dp[4];
      logits(j, x);
      product(of, Vs, j, dp);
      const float p0 = exp2_approx(x[0] - mx0) * inv0, p1 = exp2_approx(x[1] - mx0) * inv0;
      const float p2 = exp2_approx(x[2] - mx1) * inv1, p3 = exp2_approx(x[3] - mx1) * inv1;
      // P in bf16 into the stage, for dv = P^T dO
      *reinterpret_cast<unsigned*>(stage + r0 * LDS + j * 8 + q4 * 2) = pack_bf16(p0, p1);
      *reinterpret_cast<unsigned*>(stage + (r0 + 8) * LDS + j * 8 + q4 * 2) = pack_bf16(p2, p3);
      const float d0 = p0 * (dp[0] - D0), d1 = p1 * (dp[1] - D0);
      const float d2 = p2 * (dp[2] - D1), d3 = p3 * (dp[3] - D1);
      dB[j][0] += d0;
      dB[j][1] += d1;
      dB[j][2] += d2;
      dB[j][3] += d3;
      sf[j / 2][2 * (j & 1)] = pack_bf16(d0, d1);
      sf[j / 2][2 * (j & 1) + 1] = pack_bf16(d2, d3);
    }

    // dq = dS k * scale: k as the B operand, keys along the reduction
    float acc[DT][4];
#pragma unroll
    for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int dp = 0; dp < HDP / 16; ++dp) {
        unsigned kf[4];  // keys 16ks.., lanes 16dp .. 16dp + 15: two n8 tiles
        ldmatrix_x4_trans(kf, Ks + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dp * 16 +
                                  (lane >> 4) * 8);
        mma_16816(acc[2 * dp], sf[ks], kf[0], kf[1]);
        mma_16816(acc[2 * dp + 1], sf[ks], kf[2], kf[3]);
      }
    }
    store_rows<HDP>(dqkv, acc, scale, org, rel, r0, WL, hd, C, 0, head);

    // dk and dv: this warp's 16 key rows, summed over every query row; the
    // stage's tile (rows: queries, columns: keys) transposed by ldmatrix.trans
    auto key_rows = [&](const bf16* rhs, float mul, int slot) {
      float kacc[DT][4];
#pragma unroll
      for (int d = 0; d < DT; ++d) kacc[d][0] = kacc[d][1] = kacc[d][2] = kacc[d][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        unsigned af[4];  // keys key0.., query rows 16ks..: the stage's 16 x 16 block transposed
        ldmatrix_x4_trans(af, stage + (ks * 16 + (lane >> 4) * 8 + (lane & 7)) * LDS + key0 +
                                  ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int dp = 0; dp < HDP / 16; ++dp) {
          unsigned bf[4];  // query rows 16ks.., lanes 16dp ..: two n8 tiles
          ldmatrix_x4_trans(bf, rhs + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dp * 16 +
                                    (lane >> 4) * 8);
          mma_16816(kacc[2 * dp], af, bf[0], bf[1]);
          mma_16816(kacc[2 * dp + 1], af, bf[2], bf[3]);
        }
      }
      store_rows<HDP>(dqkv, kacc, mul, org, rel, r0, WL, hd, C, slot, head);
    };
    __syncthreads();  // the stage holds every row's P
    key_rows(Ds, 1.f, 2 * C);  // dv = P^T dO
    __syncthreads();  // every warp is done with P
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = (2 * ks + h) * 8 + q4 * 2;
        *reinterpret_cast<unsigned*>(stage + r0 * LDS + c) = sf[ks][2 * h];
        *reinterpret_cast<unsigned*>(stage + (r0 + 8) * LDS + c) = sf[ks][2 * h + 1];
      }
    }
    __syncthreads();  // the stage holds every row's dS
    key_rows(Qs, scale, C);  // dk = dS^T q * scale
  }

  // the run's dbias over the WL real rows and keys
  float* out = dbias + (((size_t)row * runs + part) * heads + head) * WL * WL;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = j * 8 + q4 * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r < WL && c < WL) out[(size_t)r * WL + c] = dB[j][2 * h];
      if (r < WL && c + 1 < WL) out[(size_t)r * WL + c + 1] = dB[j][2 * h + 1];
    }
  }
}

template <int WLP, int HDP>
int launch_kernel(const Packed4D& addr, const bf16* dout, bf16* dqkv, const float* bias,
                  const float* mask, float* dbias, int n_win, int heads, int WL, int hd, int nw,
                  int run, int n_types, int n_masks, float scale, cudaStream_t stream) {
  using Sh = Shape<WLP, HDP>;
  auto kernel = window_attention_bwd_kernel<WLP, HDP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sh::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = n_win / nw, runs = (nw + run - 1) / run;
  kernel<<<rows * heads * runs, Sh::THREADS, Sh::SMEM, stream>>>(
      addr, dout, dqkv, bias, mask, dbias, heads, WL, hd, nw, run, runs, n_types, n_masks, scale);
  return static_cast<int>(cudaGetLastError());
}

// n_win windows of WL tokens in rows of nw that share a bias type and mask
// table, cut into runs of `run` windows; dbias (n_win / nw, runs, heads, WL,
// WL) f32.  A geometry outside the two instantiations is refused here and the
// error goes back to the wrapper, which raises.
inline int launch(const Packed4D& addr, const void* dout, void* dqkv, const void* bias,
                  const void* mask, void* dbias, int n_win, int heads, int WL, int hd, int nw,
                  int run, int n_types, int n_masks, float scale, void* stream) {
  const bf16* d = static_cast<const bf16*>(dout);
  bf16* dq = static_cast<bf16*>(dqkv);
  const float *bf = static_cast<const float*>(bias), *mf = static_cast<const float*>(mask);
  float* db = static_cast<float*>(dbias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int wlp = (WL + 15) & ~15;
  if (hd % 8 == 0 && wlp == 144 && hd <= 32)
    return launch_kernel<144, 32>(addr, d, dq, bf, mf, db, n_win, heads, WL, hd, nw, run, n_types,
                                  n_masks, scale, st);
  if (hd % 8 == 0 && wlp == 80 && hd > 32 && hd <= 64)
    return launch_kernel<80, 64>(addr, d, dq, bf, mf, db, n_win, heads, WL, hd, nw, run, n_types,
                                 n_masks, scale, st);
  return static_cast<int>(cudaErrorInvalidConfiguration);
}

}  // namespace attention_bwd
