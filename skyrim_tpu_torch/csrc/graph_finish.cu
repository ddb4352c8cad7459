// K12, K13, K14: the finish and the untiled message kernels.
//
// Replace skyrim_tpu/ops/fused_mlp.py fused_finish (Pallas body
// _finish_kernel) and skyrim_tpu/ops/graph_kernels.py
// fused_fixed_degree_messages (_m2g_kernel) and fused_block_messages
// (_g2m_kernel).  With finish(h) = LN(bf16(bf16(swish(h + b0)) @ W + b)),
// swish in f32:
//   K12  out[m]    = finish(x[m]);  W (L, Cout), Cout may differ from L
//   K13  out[m]    = bf16(sum_k finish((wide[m, k] + bias_w[m, k]) + ad[m])),
//                    f32 sum over the deg lane slices of the (N, deg * L) rows
//   K14  out[b, s] = bf16(sum of finish(src[b, r] + bias[b, r]) over the rows r
//                    of block b with local[b, r] == s), f32 in row order;
//                    local == SB marks a padding row, which never aggregates
// The TPU kernels hold a row tile and the weight in VMEM and K14 aggregates
// with a one-hot matmul.  Here:
//   K12  where Cout == L <= 512: skt_finish_rows_ln, one launch of
//        rowgemm.cuh's rows_ln_kernel<1>: each 64-row tile of x by TMA into
//        the whole-tile A block, the swish computed once a row in place
//        (FinishPoints: K14's point path with nothing loaded, the producer
//        warps taking 54 of the 64 rows), the products by wgmma with W by
//        TMA, the bias and the LayerNorm in the epilogue; the (N, L) product
//        never reaches device memory.  Other shapes: skt_finish_gemm
//        (rowgemm.cuh's cp.async-ring GEMM, the swish prologue in its A
//        loader), then fused_mlp.cu's skt_ln_rows
//   K13  skt_fixed_degree_messages: one launch of rowgemm.cuh's
//        rows_ln_kernel<deg> for deg 1 to 4, K8 without the tile lookup.  The
//        (N deg, L) view of bias_w is the first source of the A rows (row
//        deg m + k), brought by TMA into the whole-tile A block; producer
//        warps and, after their epilogue, the consumers load a point's deg
//        slices of wide and its ad row into registers and compute its deg
//        rows in place; the products by wgmma with W by TMA, the bias, the
//        LayerNorm and the slot sum in the epilogue.  A tile is 64, 32, 21
//        or 16 points.  No (N deg, L) intermediate reaches device memory.
//   K14  skt_block_messages: the (B M, L) messages in row order in one launch
//        of rows_ln_kernel<1>, then fused_mlp.cu's skt_segment_sum over each
//        block's rows (f32 in row order for sorted ids, the same bits on
//        every run, no atomics).  A block's SB x 512 f32 sums (671 KB at SB
//        328) do not fit one block's shared memory, so the sum stays a
//        launch of its own; the padding rows' messages are computed and
//        dropped by the sum.
//
// Bounds on this card, at GraphCast's full width (L = 512): K12 over the
// 1,038,240 grid rows moves 2.13 GB (0.63 ms at 3.35 TB/s, bytes; 0.54 TFLOP);
// K13 over the same rows with deg 3 moves 8.5 GB (2.54 ms, bytes; 1.63 TFLOP);
// K14 over the grid->mesh block plan moves 3.4 GB (1.0 ms, bytes; 0.85 TFLOP on
// the real rows).  What limits them (NVIDIA H100 80GB HBM3, 700 W,
// tools/kernel_variants.py messages): K12 1.63 ms (5.27 as the chain), the
// same with no swish: not its prologue but the rest of rows_ln_kernel's
// tile, as for K6's finish (rowgemm.cuh); K13 8.7 ms, 4.5 with its prologue left
// out, 7.4 with its products left out: the prologue's loads and swish; K14's
// messages 3.7 ms (2.6 without the prologue), its segmented sum 3.3 ms (one
// block an SM for the 168 KB table of SB 328, two warps with 32 rows' loads
// in flight each).
#include "rowgemm.cuh"

namespace {

// swish(x[m, k] + b0[k]); rows of L % 8 == 0 values.
struct AFinish {
  const bf16* x;    // (M, L)
  const float* b0;  // (L,)
  int M, L;

  __device__ __forceinline__ void chunk(int m, int kk, bf16* dst) const {
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (m < M && kk < L) {
      float x8[8];
      load8(x + (size_t)m * L + kk, x8);
#pragma unroll
      for (int u = 0; u < 8; ++u) f[u] = rowgemm::swish(x8[u] + b0[kk + u]);
    }
    store8(dst, f);
  }
};

// K13: point p < N, its DEG rows' prologue for rows_ln_kernel<DEG>.  The first
// source (row DEG p + k of an (N DEG, L) view) comes by TMA; load() brings the
// point's DEG chunks at kk of the second and its ad chunk into registers;
// make() computes the DEG chunks in place in the reference's order ((wide +
// bias) + ad) + b0 (f32 addition commutes, so either source may be the first).
template <int DEG>
struct FixedDegreePoints {
  static constexpr bool POINTS = true;  // GROUP 1 (deg 1) too
  const bf16* first;   // (N DEG, L), by TMA: bias_w
  const bf16* second;  // (N DEG, L), by loads: wide
  const bf16* ad;      // (N, L)
  const float* b0;     // (L,)
  int N;

  struct Raw {
    uint4 u[DEG], a;
    bool ok;
  };
  __host__ __device__ const bf16* rows_by_tma() const { return first; }
  __device__ __forceinline__ int index(int p) const { return p < N ? p : -1; }
  __device__ __forceinline__ void load(int p, int, int kk, int L, Raw& r) const {
    r.ok = p >= 0 && kk < L;
    if (!r.ok) return;
    const bf16* u = second + (size_t)p * DEG * L + kk;
#pragma unroll
    for (int k = 0; k < DEG; ++k) r.u[k] = *reinterpret_cast<const uint4*>(u + k * L);
    r.a = *reinterpret_cast<const uint4*>(ad + (size_t)p * L + kk);
  }
  __device__ __forceinline__ void make(const Raw& r, int kk, int L, bf16* const* rows) const {
    float a8[8], c8[8];
    if (r.ok) {
      load8(reinterpret_cast<const bf16*>(&r.a), a8);
      load8f(b0 + kk, 8, c8);
    }
#pragma unroll
    for (int k = 0; k < DEG; ++k) {
      float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (r.ok) {
        float b8[8];
        load8(rows[k], b8);
        load8(reinterpret_cast<const bf16*>(&r.u[k]), f);
#pragma unroll
        for (int u = 0; u < 8; ++u) f[u] = rowgemm::swish(((f[u] + b8[u]) + a8[u]) + c8[u]);
      }
      store8(rows[k], f);
    }
  }
};

// K14's messages: row q < M as a point of GROUP 1, swish((src[q] + bias[q]) +
// b0); the bias rows by TMA, the src chunk into registers.  (K9's row path,
// the bias chunk by cp.async into its place, took 5.10 ms at full width
// against 4.74 for this one; tools/kernel_variants.py messages, NVIDIA H100
// 80GB HBM3, 700 W.)
struct BlockPoints {
  static constexpr bool POINTS = true;
  // two points' loads in flight, each one 16-byte chunk (3.7 ms; one 4.1, three 3.9)
  static constexpr int IN_FLIGHT = 2;
  const bf16* src;   // (M, L)
  const bf16* bias;  // (M, L), by TMA
  const float* b0;   // (L,)
  int M;

  struct Raw {
    uint4 s;
    bool ok;
  };
  __host__ __device__ const bf16* rows_by_tma() const { return bias; }
  __device__ __forceinline__ int index(int q) const { return q < M ? q : -1; }
  __device__ __forceinline__ void load(int q, int, int kk, int L, Raw& r) const {
    r.ok = q >= 0 && kk < L;
    if (r.ok) r.s = *reinterpret_cast<const uint4*>(src + (size_t)q * L + kk);
  }
  __device__ __forceinline__ void make(const Raw& r, int kk, int L, bf16* const* rows) const {
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r.ok) {
      float b8[8], c8[8];
      load8(rows[0], b8);
      load8(reinterpret_cast<const bf16*>(&r.s), f);
      load8f(b0 + kk, 8, c8);
#pragma unroll
      for (int u = 0; u < 8; ++u) f[u] = rowgemm::swish((f[u] + b8[u]) + c8[u]);
    }
    store8(rows[0], f);
  }
};

// K12: row q < M as a point of GROUP 1, swish(x[q] + b0) computed in place
// on the x rows TMA brought; nothing else is loaded.  The producer warps take
// PRODUCER_POINTS<1> (54) of a tile's 64 rows while the consumers multiply
// the tile before, and the consumers the rest after their epilogue.  Over
// the 1,038,240 grid rows (NVIDIA H100 80GB HBM3, 700 W; PERF.md, PR 13):
// 54 producer rows, two a step of a lane's loop, 1.63-1.65 ms; one a step
// 1.68, three 1.65; 0 producer rows 2.10, 48: 1.79, 60: 1.71 (two a step),
// 51: 1.65, 57: 1.73, 63: 1.81 (one a step); the consumers applying the
// swish in place before their first product (TmaRows' load) 1.84; the same
// loads and stores with no swish 1.63-1.67.
struct FinishPoints {
  static constexpr bool POINTS = true;
  static constexpr int IN_FLIGHT = 2;
  const bf16* x;    // (M, L), by TMA
  const float* b0;  // (L,)
  int M;

  struct Raw {
    bool ok;
  };
  __host__ __device__ const bf16* rows_by_tma() const { return x; }
  __device__ __forceinline__ int index(int q) const { return q < M ? q : -1; }
  __device__ __forceinline__ void load(int q, int, int kk, int L, Raw& r) const { r.ok = q >= 0 && kk < L; }
  __device__ __forceinline__ void make(const Raw& r, int kk, int L, bf16* const* rows) const {
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r.ok) {
      float c8[8];
      load8(rows[0], f);
      load8f(b0 + kk, 8, c8);
#pragma unroll
      for (int u = 0; u < 8; ++u) f[u] = rowgemm::swish(f[u] + c8[u]);
    }
    store8(rows[0], f);
  }
};

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int DEG>
int fixed_degree(const void* wide, const void* bias, const void* ad, const void* b0, const void* W,
                 const rowgemm::EpiLN& epi, void* out, int N, int L, void* stream) {
  const FixedDegreePoints<DEG> pro{static_cast<const bf16*>(bias), static_cast<const bf16*>(wide),
                                   static_cast<const bf16*>(ad), static_cast<const float*>(b0), N};
  return rowgemm::launch_rows_ln<DEG>(pro, W, epi, out, N * DEG, L, stream);
}

}  // namespace

extern "C" int skt_finish_gemm(const void* x, const void* b0, const void* W, const void* b, void* out,
                               int M, int L, int Cout, void* stream) {
  AFinish a{static_cast<const bf16*>(x), static_cast<const float*>(b0), M, L};
  rowgemm::EpiStore epi{static_cast<const float*>(b), nullptr, static_cast<bf16*>(out), Cout,
                        rowgemm::ACT_NONE};
  return rowgemm::launch_rowgemm(a, W, epi, M, Cout, L, stream);
}

// K12 where Cout == L: x (M, L) bf16 rows, 16-byte aligned, L % 8 == 0,
// L <= 512; W (L, L); out (M, L).  One launch of rows_ln_kernel<1>.
extern "C" int skt_finish_rows_ln(const void* x, const void* b0, const void* W, const void* b, const void* ln_scale,
                                  const void* ln_bias, void* out, int M, int L, float eps, void* stream) {
  if (M <= 0 || !aligned16(x)) return static_cast<int>(cudaErrorInvalidValue);
  const rowgemm::EpiLN epi{static_cast<const float*>(b), static_cast<const float*>(ln_scale),
                           static_cast<const float*>(ln_bias), eps};
  const FinishPoints pro{static_cast<const bf16*>(x), static_cast<const float*>(b0), M};
  return rowgemm::launch_rows_ln<1>(pro, W, epi, out, M, L, stream);
}

// K13: wide, bias (N, deg L), ad (N, L) bf16 rows, 16-byte aligned, L % 8 == 0,
// L <= 512, N deg < 2^31; out (N, L).
extern "C" int skt_fixed_degree_messages(const void* wide, const void* bias, const void* ad, const void* b0,
                                         const void* W, const void* b, const void* ln_scale, const void* ln_bias,
                                         void* out, int N, int L, int deg, float eps, void* stream) {
  if (N <= 0 || (long long)N * deg >= (1LL << 31) || !aligned16(wide) || !aligned16(ad))
    return static_cast<int>(cudaErrorInvalidValue);
  const rowgemm::EpiLN epi{static_cast<const float*>(b), static_cast<const float*>(ln_scale),
                           static_cast<const float*>(ln_bias), eps};
  switch (deg) {
    case 1: return fixed_degree<1>(wide, bias, ad, b0, W, epi, out, N, L, stream);
    case 2: return fixed_degree<2>(wide, bias, ad, b0, W, epi, out, N, L, stream);
    case 3: return fixed_degree<3>(wide, bias, ad, b0, W, epi, out, N, L, stream);
    case 4: return fixed_degree<4>(wide, bias, ad, b0, W, epi, out, N, L, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K14's messages: src, bias (M, L) bf16 rows, 16-byte aligned, L % 8 == 0,
// L <= 512; out (M, L), row q's message.
extern "C" int skt_block_messages(const void* src, const void* bias, const void* b0, const void* W, const void* b,
                                  const void* ln_scale, const void* ln_bias, void* out, int M, int L, float eps,
                                  void* stream) {
  if (M <= 0 || !aligned16(src) || !aligned16(bias)) return static_cast<int>(cudaErrorInvalidValue);
  const rowgemm::EpiLN epi{static_cast<const float*>(b), static_cast<const float*>(ln_scale),
                           static_cast<const float*>(ln_bias), eps};
  const BlockPoints pro{static_cast<const bf16*>(src), static_cast<const bf16*>(bias), static_cast<const float*>(b0),
                        M};
  return rowgemm::launch_rows_ln<1>(pro, W, epi, out, M, L, stream);
}
