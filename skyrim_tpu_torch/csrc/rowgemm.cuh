// Row-GEMM building blocks: the tiled GEMM of every port kernel that
// multiplies (Pangu's K1 through gemm.cu, its TMA and wgmma pieces in K3's
// and K4's resample.cu; GraphCast's K6 and K7; K12's chain in
// graph_finish.cu), the row kernel with its LayerNorm inside
// (rows_ln_kernel: K6's finish, K8, K9, K12, K13, K14's messages), K1's GEMM with the LayerNorm in its prologue
// (ln_gemm_kernel), and the row kernels the GraphCast kernels share.
//
// The four GraphCast TPU kernels (skyrim_tpu/ops/fused_mlp.py fused_mlp and
// ops/graph_kernels.py fused_round_messages / fused_m2g_tiled /
// fused_g2m_tiled) all run rows through "prologue -> Dense -> epilogue ->
// LayerNorm -> aggregate".  At L = 512 the two 512x512 bf16 weights (1 MB) do
// not fit the 227 KB of shared memory a Hopper block has, so each is a short
// chain of launches of the kernels here:
//
//   rowgemm_kernel  C = epi(A @ W), bf16 in, f32 accumulation in registers by
//                   wgmma.mma_async (gemm_mainloop below): a 128 x BN x 64
//                   tile a block, two warpgroups of 64 rows each, a ring of
//                   three slices in dynamic shared memory filled by cp.async
//                   two slices ahead of the multiply, one barrier a slice, two
//                   blocks an SM.  Both tiles lie in the 128-byte swizzle: A
//                   K-major, W (K, N) row-major as the MN-major B operand (the
//                   instruction's transpose bit).  The A tile comes from a
//                   loader functor whose chunk(row, k, dst) writes 16 bytes,
//                   the swizzle's unit (strided or unaligned rows, or a
//                   computed prologue such as a gather + swish); the f32
//                   results go through an epilogue functor's apply() 8
//                   consecutive columns at a time, straight from the
//                   accumulators after a quad exchange, and are stored from
//                   registers.  Ragged M, N and K edges are zero-filled on
//                   load and masked at the store.
//   rowgemm_tma_kernel  the same product under the same functors for plain
//                   aligned rows (ARows<true>, N % 128 or % 192 == 0): one
//                   persistent block an SM, the slices brought by TMA (tensor
//                   maps made in launch_rowgemm_tma, completion on
//                   mbarriers) by one thread; two consumer
//                   warpgroups take whole tiles in turn (ping-pong), stage
//                   each epilogue's bf16 tile in shared memory and store it by
//                   TMA, so that one's epilogue runs under the other's
//                   products.  launch_rowgemm takes it wherever the operands
//                   allow.
//   ln_rows_kernel  one warp per row: out = bf16([res +] bf16(LN(y[row]))),
//                   through common.cuh's layernorm_rows_warp (K7, K12, and
//                   K1's LayerNorms on its chain, rows wider than 512 that
//                   are not whole 64-column slices, fused_block.cu).
//   segsum_kernel   out[g, s, :] = sum of the rows r of group g with
//                   local[g, r] == s, in f32, then bf16; local values outside
//                   [0, S) are skipped.  One block per (group, 128 columns),
//                   the S x 128 f32 sums in shared memory; a thread owns two
//                   columns, walks the rows in order, 16 loads a batch and the
//                   next batch in flight, sums
//                   a run of equal ids in registers and touches the table only
//                   where the id changes.  No atomics: each column has one
//                   owner, so the result is the same bits on every run, and
//                   for ids in sorted order the f32 sum in row order.
//   rows_ln_kernel  out = bf16(LN(bf16(prologue @ W + b))) for rows of up to
//                   512 columns in one launch (K9, K12, K14's messages;
//                   K6's finish, plain rows by TMA and a residual added), or the
//                   f32 sum of GROUP (2 to 4) consecutive rows' LayerNorms
//                   (K8's and K13's slots): 64 (or 63) rows x all columns a
//                   tile, so the LayerNorm and the slot sum run in the
//                   epilogue; the prologue computed once a row by producer
//                   warps into a whole-tile A buffer, W by TMA, two consumer
//                   warpgroups of 256 columns each exchanging row sums (see
//                   below).
//   ln_gemm_kernel  out = epi(bf16(LN(x)) @ W + b) for rows of up to 512
//                   columns (K1's LN1 + qkv and LN2 + fc1): a row block of x
//                   by TMA, normalised once in place in shared memory by
//                   producer warps, then multiplied by every N tile's W
//                   slices by two consumer warpgroups in turn (see below).
//   wide_gemm_kernel  out = epi(A @ W + b), or epi(bf16(LN(x)) @ W + b),
//                   for long rows (K1's four products at C > 512, FengWu's
//                   1152 and FuXi V1's 1536): both consumer warpgroups on one
//                   128 x 256 (or 192) tile, sharing every slice; the
//                   LayerNorm applied slice by slice in the ring from
//                   statistics of a first pass over the row block (see
//                   below).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time, not linked
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace rowgemm {

constexpr int BK = 64, THREADS = 256;  // a k slice of 128 bytes: one swizzle row
constexpr int STAGES = 3;              // slices in rowgemm_kernel's ring
constexpr int SEG_COLS = 128;          // columns per segsum block (two per thread)

// x * sigmoid(x) with the fast exponential and division (each within 2 ulps
// in f32, far below the bf16 rounding that follows): 8 of these run per
// 16-byte chunk in the computed prologues and per epilogue call.
__device__ __forceinline__ float swish(float x) { return __fdividef(x, 1.f + __expf(-x)); }

enum Act { ACT_NONE = 0, ACT_SWISH = 1 };

// A as rows: element (m, k) of the first part at a1[m * s1m + k * s1k] for
// k < K1, then a second row-major part a2 (M, K2) for K1 <= k < K1 + K2 (the
// split first layer: x @ W[:K1] + x2 @ W[K1:] into one accumulator, the concat
// never built).  VEC: both parts are 16-byte aligned rows (s1k == 1, s1m, K1,
// K2 multiples of 8) and load with cp.async; otherwise element loads
// (feature-major input, or rows of 174, 3 or 4 values).
template <bool VEC>
struct ARows {
  const bf16* a1;
  long long s1m, s1k;
  int K1;
  const bf16* a2;
  int K2;
  int M;

  __device__ __forceinline__ void chunk(int row, int k, bf16* dst) const {
    const int K = K1 + K2;
    if (VEC) {
      const bool ok = row < M && k < K;
      const bf16* src = a1;
      if (ok) src = k < K1 ? a1 + row * s1m + k : a2 + (long long)row * K2 + (k - K1);
      cp_async16(dst, src, ok);
      return;
    }
    float f[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int kk = k + u;
      float v = 0.f;
      if (row < M && kk < K1)
        v = __bfloat162float(a1[row * s1m + kk * s1k]);
      else if (row < M && kk < K)
        v = __bfloat162float(a2[(long long)row * K2 + (kk - K1)]);
      f[u] = v;
    }
    store8(dst, f);
  }
};

// W (K, N) row-major bf16 (flax Dense layout); cp.async when N % 8 == 0.
__device__ __forceinline__ void load_b_chunk(const bf16* W, int K, int N, int k, int n, bf16* dst) {
  if ((N & 7) == 0) {
    const bool ok = k < K && n < N;
    cp_async16(dst, ok ? W + (size_t)k * N + n : W, ok);
    return;
  }
  float f[8];
#pragma unroll
  for (int u = 0; u < 8; ++u)
    f[u] = (k < K && n + u < N) ? __bfloat162float(W[(size_t)k * N + n + u]) : 0.f;
  store8(dst, f);
}

// Store 8 (or the nv valid of 8) f32 values as bf16 at out[row * N + col].
__device__ __forceinline__ void store_out(bf16* out, int N, int row, int col, const float* v,
                                          int nv) {
  bf16* p = out + (size_t)row * N + col;
  if (nv == 8 && (N & 7) == 0) {
    store8(p, v);
  } else {
    for (int u = 0; u < nv; ++u) p[u] = __float2bfloat16(v[u]);
  }
}

// Epilogue functors.  apply(row, col, v, b, r) turns the f32 products v of 8
// consecutive columns of one row into the values to store, in registers,
// given bias[col .. col + 7] in b and, where residual() names a (rows, N)
// bf16 matrix, its 8 values at (row, col) in r.  The kernel brings b and r and
// stores v to out (row-major, row stride N) as bf16: rowgemm_kernel loads and
// stores straight from device memory; rowgemm_tma_kernel preloads its tile's
// bias into registers, brings the residual tile by TMA into shared memory and
// stores through a staged tile by TMA.  So each epilogue's arithmetic has one
// copy.
//
// out = bf16(act(acc + bias)), or bf16(bf16(acc + bias) + res) with a
// residual; ACT_SWISH acts on the f32 value, as GraphCast's MLPs do.
struct EpiStore {
  const float* bias;
  const bf16* res;
  bf16* out;
  int N;
  int act;

  __host__ __device__ __forceinline__ const bf16* residual() const { return res; }
  // b: bias[col .. col + 7]; r: the residual's 8 values where residual() is set
  __device__ __forceinline__ void apply(int, int, float* v, const float* b, const float* r) const {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float t = v[u] + b[u];
      if (act == ACT_SWISH) t = swish(t);
      if (res) t = bf16_round(t) + r[u];
      v[u] = t;
    }
  }
};

// The residual's 8 (or nv) values at (row, col) where the functor has one, else 0
// (rowgemm_kernel's loads).
template <class Epi>
__device__ __forceinline__ void load_residual(const Epi& epi, int row, int col, int nv, float* r) {
  const bf16* res = epi.residual();
#pragma unroll
  for (int u = 0; u < 8; ++u) r[u] = 0.f;
  if (!res) return;
  if (nv == 8 && (epi.N & 7) == 0) {
    load8(res + (size_t)row * epi.N + col, r);
  } else {
    for (int u = 0; u < nv; ++u) r[u] = __bfloat162float(res[(size_t)row * epi.N + col + u]);
  }
}

// --- wgmma ------------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle.  Tiles are made of atoms
// of 8 rows x 128 bytes (1024 bytes, 1024-byte aligned), the 16-byte chunk c of
// row r stored at chunk c ^ (r % 8).
__device__ __forceinline__ uint64_t wgmma_desc(unsigned saddr, unsigned lbo, unsigned sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes (cp.async, st.shared) made visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x N, f32) += a (64 x 16) * b (16 x N, N-major), both in shared memory;
// a K-major, or M-major where TA is 1 (the instruction's transpose bit for A,
// as b always takes it)
template <int N, int TA>
struct Wgmma;

template <int TA>
struct Wgmma<64, TA> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, 1, 1, 1, %34, 1;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "n"(TA));
  }
};

template <int TA>
struct Wgmma<128, TA> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, 1, 1, 1, %66, 1;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "n"(TA));
  }
};

template <int TA>
struct Wgmma<192, TA> {
  static __device__ __forceinline__ void run(float (&d)[96], uint64_t da, uint64_t db) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
        "%96, %97, 1, 1, 1, %98, 1;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(da), "l"(db), "n"(TA));
  }
};

template <int TA>
struct Wgmma<256, TA> {
  static __device__ __forceinline__ void run(float (&d)[128], uint64_t da, uint64_t db) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, 1, 1, 1, %130, 1;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "n"(TA));
  }
};

template <int N, int TA = 0>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t da, uint64_t db) {
  Wgmma<N, TA>::run(d, da, db);
}

// Block tile 128 x BN over the whole K: warpgroup wg takes rows [64 wg, +64)
// and every column.
template <int BN>
struct Tile {
  static constexpr int BM = 128;
  static constexpr int A_BYTES = BM * BK * 2, B_BYTES = BK * BN * 2, STAGE = A_BYTES + B_BYTES;
  static_assert(BN == 64 || BN == 128, "whole swizzle atoms, a wgmma width");
  static constexpr size_t SMEM = (size_t)STAGES * STAGE + 1024;  // + alignment
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// acc = A[m0 .. m0 + 128, :] @ W[:, n0 .. n0 + BN] for this thread's warpgroup.
// Slice kt lives in ring slot kt % STAGES: A as 128 rows of 128 bytes, W as
// (BN / 64) x 8 atoms, atom (j, i) holding k rows 8i .. 8i + 7 of columns
// 64j .. 64j + 63.  Slice kt + STAGES - 1 is loaded while slice kt multiplies:
// its slot was read by slice kt - 1, whose wgmma every warpgroup has waited
// for before this slice's barrier.  That keeps two slices of loads in the air
// and leaves it to the SM's other block to fill the tensor cores while this
// one drains.
template <int BN, class ALoad>
__device__ __forceinline__ void gemm_mainloop(const ALoad& aload, const bf16* __restrict__ W, int m0,
                                              int n0, int N, int K, unsigned char* ring,
                                              float (&acc)[BN / 2]) {
  using T = Tile<BN>;
  constexpr int D = STAGES - 1;  // slices loaded ahead
  const int tid = threadIdx.x, wg = tid >> 7;

  auto load_slice = [&](int kt) {
    unsigned char* As = ring + (kt % STAGES) * T::STAGE;
    unsigned char* Bs = As + T::A_BYTES;
    const int k0 = kt * BK;
#pragma unroll
    for (int c = tid; c < T::BM * (BK / 8); c += THREADS) {
      const int r = c >> 3, kc = c & 7;
      aload.chunk(m0 + r, k0 + kc * 8, reinterpret_cast<bf16*>(As + r * 128 + ((kc ^ (r & 7)) << 4)));
    }
#pragma unroll
    for (int c = tid; c < BK * (BN / 8); c += THREADS) {
      const int kr = c / (BN / 8), nc = c % (BN / 8);
      unsigned char* dst = Bs + ((nc >> 3) * (BK / 8) + (kr >> 3)) * 1024 + (kr & 7) * 128 +
                           (((nc & 7) ^ (kr & 7)) << 4);
      load_b_chunk(W, K, N, k0 + kr, n0 + nc * 8, reinterpret_cast<bf16*>(dst));
    }
  };

#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int kt = 0; kt < D; ++kt) {
    if (kt < nk) load_slice(kt);
    cp_async_commit();
  }
  // W atoms of one k16 step: 2 along K (stride 1024), BN / 64 along N (stride 8192)
  // (the descriptor's leading offset steps along N, its stride offset along K)
  constexpr unsigned B_N_STRIDE = (BK / 8) * 1024, B_K_STRIDE = 1024;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<D - 1>();
    fence_async_shared();
    __syncthreads();
    const unsigned a0 = smem_addr(ring + (kt % STAGES) * T::STAGE) + wg * 64 * 128;
    const unsigned b0 = smem_addr(ring + (kt % STAGES) * T::STAGE + T::A_BYTES);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      wgmma_bf16<BN>(acc, wgmma_desc(a0 + ks * 32, 16, 1024),
                     wgmma_desc(b0 + ks * 2 * B_K_STRIDE, B_N_STRIDE, B_K_STRIDE));
    wgmma_commit();
    if (kt + D < nk) load_slice(kt + D);
    cp_async_commit();
    wgmma_wait<0>();
  }
}

// The first column of the 8 that this lane gets at step j4 of
// for_each_8<WN, true>.
__device__ __forceinline__ int swizzled_col(int j4) {
  const int lane = threadIdx.x & 31;
  return (((lane >> 2) & 1 ? j4 ^ 1 : j4) * 4 + (lane & 3)) * 8;
}

// The accumulators of a warpgroup's 64 x WN tile, handed to f(row, col, v, j4)
// as 8 consecutive columns of one row (rows and columns relative to the tile)
// at step j4: lane (g, q) of warp w holds rows 16w + g and + 8, columns 8j +
// 2q, + 1 of every 8-column tile j; a quad exchanges four tiles at a time.
// SWIZZLED: lanes of odd g take the groups of four tiles in the order 1, 0, 3,
// 2, ..., so that a quarter warp (g = 2i, 2i + 1) writing its 16-byte chunks
// into rows of the 128-byte swizzle (chunk c of row r at c ^ (r % 8)) hits
// eight different chunk slots: no bank conflict.
template <int WN, bool SWIZZLED = false, class F>
__device__ __forceinline__ void for_each_8(const float (&acc)[WN / 2], F f) {
  static_assert(!SWIZZLED || WN % 64 == 0, "groups of four tiles come in pairs");
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, q = lane & 3;
  const bool swap = SWIZZLED && (g & 1);
#pragma unroll
  for (int j4 = 0; j4 < WN / 32; ++j4) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x[4][2], v[8];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          x[t][e] = swap ? acc[((j4 ^ 1) * 4 + t) * 4 + 2 * h + e] : acc[(j4 * 4 + t) * 4 + 2 * h + e];
      quad_transpose(x, v);
      f(w * 16 + g + 8 * h, SWIZZLED ? swizzled_col(j4) : (j4 * 4 + q) * 8, v, j4);
    }
  }
}

// --- TMA and mbarriers ---------------------------------------------------------

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Returns once the barrier's phase of this parity is complete.  A wait that
// lasts seconds means a lost arrival: trap, so that the launch fails instead
// of holding the card.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  const long long t0 = clock64();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > 4000000000LL) __trap();
  }
}
// The box of `map` at (c0 innermost, c1) -> shared memory; its bytes complete on `bar`.
__device__ __forceinline__ void tma_load_2d(unsigned dst, const CUtensorMap* map, unsigned bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
// Shared memory -> the box of `map` at (c0, c1), in this thread's bulk group;
// box rows and columns beyond the matrix are not written.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, unsigned src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// Returns once at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Named barriers (id 0 is __syncthreads): sync waits for n threads, arrive counts without waiting.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// A tiled bf16 tensor map of rank 1-5 in the 128-byte swizzle: dims[0]
// contiguous, strides in bytes for dims 1 .. rank - 1, boxes of box[i]
// elements (box[0] * 2 <= 128 bytes).  Elements beyond a dimension read as 0
// and are not written.  Returns a cudaError_t: cudaErrorNotSupported where
// CUDA offers no encoder, cudaErrorInvalidValue where the encoder refuses the
// operands.
inline int make_tensor_map_nd(CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
                              const uint64_t* strides, const uint32_t* box) {
  typedef CUresult (*Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                             const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                             CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                             CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<Encode>(fn);
  }
  if (rank < 1 || rank > 5) return static_cast<int>(cudaErrorInvalidValue);
  cuuint64_t d[5], st[4];
  cuuint32_t bx[5], step[5] = {1, 1, 1, 1, 1};
  for (int i = 0; i < rank; ++i) d[i] = dims[i], bx[i] = box[i];
  for (int i = 0; i + 1 < rank; ++i) st[i] = strides[i];
  const CUresult res =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), d, st, bx, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return static_cast<int>(res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue);
}

// A tensor map over a row-major bf16 matrix (rows x cols, row stride ld
// elements) with boxes of box_rows x 64 columns in the 128-byte swizzle: what
// a box writes is what gemm_mainloop's loaders write, rows of 128 bytes with
// chunk c of row r at c ^ (r % 8).  Rows and columns beyond the matrix read as
// 0.
inline int make_tensor_map(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                            uint64_t ld, uint32_t box_rows) {
  const uint64_t dims[2] = {cols, rows}, strides[1] = {ld * sizeof(bf16)};
  const uint32_t box[2] = {64, box_rows};
  return make_tensor_map_nd(map, base, 2, dims, strides, box);
}

// A consumer's staged epilogue tile (BM rows, boxes of 64 columns in the
// 128-byte swizzle; rowgemm_tma_kernel, ln_gemm_kernel): its first `boxes`
// boxes stored by TMA from one thread at (m0, n0), rows and columns past
// the matrix clipped; returns once the store has read the staging tile.
template <int BM>
__device__ __forceinline__ void store_tile(const CUtensorMap* mapOut, unsigned char* out_tile, int boxes,
                                           int m0, int n0) {
#pragma unroll
  for (int b = 0; b < boxes; ++b) tma_store_2d(mapOut, smem_addr(out_tile) + b * (BM * 128), n0 + 64 * b, m0);
  bulk_commit();
  bulk_wait_read<0>();
}

// The row GEMM for aligned rows (ARows<true>; N % 128 == 0, or % 192 == 0 for
// Pangu's 192 and 576): one persistent block an SM walks the tiles blockIdx.x,
// + gridDim.x, ..., each BM rows x BN columns over the whole K.
//
// - Producer: one thread of the third warpgroup (setmaxnreg 40) keeps TMA
//   loads in flight into a ring of STAGES slices (A BM x 64, W 64 x BN, in
//   gemm_mainloop's layout) in the walk's order.  full[s] completes when the
//   bytes of slot s have landed, empty[s] when the four warps of the consumer
//   that multiplied them have read them.
//   With a residual (Epi::residual(), K7's gsrc included), the producer
//   first brings the tile's residual by TMA into its consumer's staging tile
//   (res_full[c]), once that consumer's last store has read it (out_free[c]).
// - Two consumer warpgroups (setmaxnreg 232) take the walk's tiles in turn,
//   each a whole tile (BM / 64 wgmma rows of 64), and run the tile's epilogue
//   themselves: the functor's arithmetic on the accumulators in registers,
//   with the tile's bias loaded into registers before the products and the
//   residual read from the staging tile; bf16 into the consumer's own staging
//   tile in shared memory (the 128-byte swizzle, boxes of 64 columns, no bank
//   conflict), then one thread stores it by TMA (cp.async.bulk.tensor, rows
//   beyond M clipped), waits until the store has read it, and the warpgroup
//   goes back to its next tile.  No load from device memory is left in the
//   epilogue but K7's staged-row gather.
// - Ping-pong: named barriers 1 and 2 hand the tensor cores from one consumer
//   to the other.  A consumer starts a tile's products only once the other
//   has finished its previous tile's, and signals the other when its own are
//   done, so one consumer's epilogue (and its store) runs under the other's
//   products instead of in step with them.
//
// - AT (feature-major A, K6's embed_grid): A is (K1, M) with M contiguous,
//   an M-major operand as W is an N-major one.  A slice is BM / 64 boxes of
//   64 M (128 bytes, the swizzle's span) x 64 K rows, each laid out as a W
//   slice's column atom, and the products take it through the instruction's
//   transpose bit for A.  K rows past K1 come in as 0 from the map's
//   out-of-bounds fill (K1 = 174: three slices, the last one 18 rows short).
//   A template flag, so that the row-major instances compile as before.
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W): the products alone run at
// 660-670 TFLOP/s on 512-wide rows, above torch.matmul's ~600; what is left
// is the epilogue wherever it is longer than the other consumer's products,
// since one warpgroup runs a whole tile's epilogue: GELU after Pangu's K 192
// and 384 (fc1), K7's staged-row gather.  Most of Pangu's products are
// byte-bound (2M(K + N) bytes, 2MN more with a residual).
template <int BM, int BN>
struct TmaTile {
  static constexpr int A_BYTES = BM * BK * 2, B_BYTES = BK * BN * 2, STAGE = A_BYTES + B_BYTES;
  static constexpr int OUT_BYTES = BM * BN * 2;  // a consumer's staging tile
  static constexpr int FIXED = 1024 + 2 * OUT_BYTES + 32;  // alignment, the two staging tiles, their barriers
  static constexpr int STAGES = (232448 - FIXED) / (STAGE + 16);  // as deep as shared memory allows
  static constexpr size_t SMEM = (size_t)FIXED + (size_t)STAGES * (STAGE + 16);
  static_assert((BM == 64 || BM == 128) && BN % 64 == 0 && STAGES >= 2, "fits a block");
};
constexpr int TMA_THREADS = 384;  // two consumer warpgroups and a producer warpgroup

template <int BM, int BN, class Epi, bool AT = false>
__global__ void __launch_bounds__(TMA_THREADS, 1)
    rowgemm_tma_kernel(__grid_constant__ const CUtensorMap mapA1,
                       __grid_constant__ const CUtensorMap mapA2,
                       __grid_constant__ const CUtensorMap mapW,
                       __grid_constant__ const CUtensorMap mapOut,
                       __grid_constant__ const CUtensorMap mapRes, Epi epi, int M, int N, int K1,
                       int K, int tiles) {
  using T = TmaTile<BM, BN>;
  constexpr int S = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  unsigned char* staging = ring + S * T::STAGE;
  const unsigned full0 = smem_addr(staging + 2 * T::OUT_BYTES), empty0 = full0 + S * 8;
  // res_full[c]: the residual tile landed in consumer c's staging tile;
  // out_free[c]: consumer c's last store has read its staging tile
  const unsigned res_full0 = empty0 + S * 8, out_free0 = res_full0 + 16;
  const bool has_res = epi.residual() != nullptr;
  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4);
    }
    for (int c = 0; c < 2; ++c) {
      mbar_init(res_full0 + 8 * c, 1);
      mbar_init(out_free0 + 8 * c, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int tiles_n = N / BN, nk = (K + BK - 1) / BK;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid != 256) return;
    int stage = 0;
    unsigned phase = 0;
    for (int tile = blockIdx.x, p = 0; tile < tiles; tile += gridDim.x, ++p) {
      const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
      if (has_res) {  // the residual tile into its consumer's staging tile, once that is free
        const int c = p & 1;
        mbar_wait(out_free0 + 8 * c, ((p >> 1) & 1) ^ 1);  // passes at once on the first use
        mbar_expect_tx(res_full0 + 8 * c, T::OUT_BYTES);
        const unsigned dst = smem_addr(staging + c * T::OUT_BYTES);
#pragma unroll
        for (int b = 0; b < BN / 64; ++b)
          tma_load_2d(dst + b * (BM * 128), &mapRes, res_full0 + 8 * c, n0 + 64 * b, m0);
      }
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);  // passes at once the first time round
        const unsigned full = full0 + 8 * stage, slot = smem_addr(ring + stage * T::STAGE);
        mbar_expect_tx(full, T::STAGE);
        const int k0 = kt * BK;
        if (AT)
#pragma unroll
          for (int j = 0; j < BM / 64; ++j) tma_load_2d(slot + j * (BK / 8) * 1024, &mapA1, full, m0 + 64 * j, k0);
        else if (k0 < K1)
          tma_load_2d(slot, &mapA1, full, k0, m0);
        else
          tma_load_2d(slot, &mapA2, full, k0 - K1, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(slot + T::A_BYTES + j * (BK / 8) * 1024, &mapW, full, n0 + 64 * j, k0);
        if (++stage == S) stage = 0, phase ^= 1;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    constexpr unsigned B_N_STRIDE = (BK / 8) * 1024, B_K_STRIDE = 1024;
    const int me = wg, other = wg ^ 1;
    const bool elected = (tid & 127) == 0;
    unsigned char* out_tile = staging + me * T::OUT_BYTES;
    // position p of the block's walk is tile blockIdx.x + p * gridDim.x; this
    // consumer takes the positions p = me, me + 2, ...
    for (int p = me;; p += 2) {
      const int tile = blockIdx.x + p * gridDim.x;
      if (tile >= tiles) break;
      const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
      int stage = (p * nk) % S;  // the producer's slice p * nk of the walk
      unsigned phase = ((p * nk) / S) & 1;
      float acc[BM / 64][BN / 2];
#pragma unroll
      for (int h = 0; h < BM / 64; ++h)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[h][i] = 0.f;
      // this lane's bias values of the tile, for step j4 of the epilogue,
      // loaded while the products run
      float bias[BN / 32][8];
#pragma unroll
      for (int j4 = 0; j4 < BN / 32; ++j4) load8f(epi.bias + n0 + swizzled_col(j4), 8, bias[j4]);
      if (p > 0) bar_sync(1 + me, 256);  // position p - 1's products are done
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(full0 + 8 * stage, phase);
        const unsigned a0 = smem_addr(ring + stage * T::STAGE);
        const unsigned b0 = a0 + T::A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
          for (int h = 0; h < BM / 64; ++h)  // AT: box h, two k-atoms a step; else rows 64h.., 32 bytes a step
            wgmma_bf16<BN, AT>(acc[h], AT ? wgmma_desc(a0 + h * 64 * 128 + ks * 2 * B_K_STRIDE, B_N_STRIDE, B_K_STRIDE)
                                          : wgmma_desc(a0 + h * 64 * 128 + ks * 32, 16, 1024),
                               wgmma_desc(b0 + ks * 2 * B_K_STRIDE, B_N_STRIDE, B_K_STRIDE));
        wgmma_commit();
        // one group left in flight: the previous slice's products are done,
        // its slot goes back to the producer
        wgmma_wait<1>();
        if (kt > 0 && (tid & 31) == 0) mbar_arrive(empty0 + 8 * (stage == 0 ? S - 1 : stage - 1));
        if (++stage == S) stage = 0, phase ^= 1;
      }
      wgmma_wait<0>();
      if ((tid & 31) == 0) mbar_arrive(empty0 + 8 * (stage == 0 ? S - 1 : stage - 1));
      if (tile + gridDim.x < tiles) bar_arrive(1 + other, 256);  // position p + 1 may multiply

      // epilogue: the residual tile has landed in the staging tile (or, with
      // none, the last store has read it: the elected thread waited) ...
      if (has_res) mbar_wait(res_full0 + 8 * me, (p >> 1) & 1);
      bar_sync(3 + me, 128);
      // ... the functor's values into it, box b = columns 64b .. 64b + 63 ...
#pragma unroll
      for (int h = 0; h < BM / 64; ++h)
        for_each_8<BN, true>(acc[h], [&](int r, int c, float* v, int j4) {
          const int row = h * 64 + r;
          uint4* chunk = reinterpret_cast<uint4*>(out_tile + (c >> 6) * (BM * 128) + row * 128 +
                                                  ((((c >> 3) & 7) ^ (row & 7)) << 4));
          float res[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
          if (has_res) load8(reinterpret_cast<const bf16*>(chunk), res);
          if (m0 + row < M) epi.apply(m0 + row, n0 + c, v, bias[j4], res);
          *chunk = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                              pack_bf16(v[6], v[7]));
        });
      fence_async_shared();  // ... made visible to the TMA unit, then stored by one thread
      bar_sync(3 + me, 128);
      if (elected) {
        store_tile<BM>(&mapOut, out_tile, BN / 64, m0, n0);  // the staging tile is free again
        if (has_res) mbar_arrive(out_free0 + 8 * me);  // ... for the producer's residual
      }
    }
  }
}

// cudaFuncSetAttribute once for each kernel instance; every later launch gets
// the first call's result.  (Static: a function-local static of an inline
// function or a template is one object for every library loaded in the
// process, so one library's first call would stand for all.)
template <int BM, int BN, class Epi, bool AT>
static int tma_kernel_attribute() {
  static const int err = static_cast<int>(cudaFuncSetAttribute(
      rowgemm_tma_kernel<BM, BN, Epi, AT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)TmaTile<BM, BN>::SMEM));
  return err;
}

constexpr int TMA_NOT_TAKEN = -1;

// AT: a is feature-major (K1, M), row stride a.s1k, no second part.
template <int BM, int BN, bool AT, bool VEC, class Epi>
int launch_tma_tiles(const ARows<VEC>& a, const bf16* W, const Epi& epi, int M, int N, int K,
                     cudaStream_t st) {
  const long long tiles = (long long)(N / BN) * ((M + BM - 1) / BM);
  if (tiles > 0x7fffffffLL) return TMA_NOT_TAKEN;
  CUtensorMap mapA1, mapA2, mapW, mapOut, mapRes;
  if (int err = AT ? make_tensor_map(&mapA1, a.a1, a.K1, M, a.s1k, BK) : make_tensor_map(&mapA1, a.a1, M, a.K1, a.s1m, BM))
    return err;
  if (int err = make_tensor_map(&mapW, W, K, N, N, BK)) return err;
  if (int err = make_tensor_map(&mapOut, epi.out, M, N, N, BM)) return err;
  mapRes = mapOut;
  if (epi.residual())
    if (int err = make_tensor_map(&mapRes, epi.residual(), M, N, N, BM)) return err;
  mapA2 = mapA1;
  if (a.K2)
    if (int err = make_tensor_map(&mapA2, a.a2, M, a.K2, a.K2, BM)) return err;
  if (int err = tma_kernel_attribute<BM, BN, Epi, AT>()) return err;
  const unsigned grid = (unsigned)(tiles < sm_count() ? tiles : sm_count());
  rowgemm_tma_kernel<BM, BN, Epi, AT><<<grid, TMA_THREADS, TmaTile<BM, BN>::SMEM, st>>>(
      mapA1, mapA2, mapW, mapOut, mapRes, epi, M, N, a.K1, K, (int)tiles);
  return static_cast<int>(cudaGetLastError());
}

// Launches rowgemm_tma_kernel where the operands allow it, by their shapes:
// 16-byte aligned bases, W and out, N a multiple of 128 or 192, and
// - ARows<true>, rows: row strides of 16 bytes' multiples, a split first
//   part that ends on a slice;
// - ARows<false>, feature-major (s1m == 1, s1k == M): no second part, M % 8
//   == 0 (the map's row stride, 2M bytes, a multiple of 16).
// TMA_NOT_TAKEN for other shapes: the caller takes rowgemm_kernel.  A CUDA
// without the encoder, or an encoder that refuses operands that passed these
// tests, is an error and goes back to the wrapper, which raises.  Tiles: 128
// x 128 a consumer where N % 128 == 0 (128 accumulators a thread), else 64 x
// 192.
template <bool VEC, class Epi>
int launch_rowgemm_tma(const ARows<VEC>& a, const bf16* W, const Epi& epi, int M, int N, int K,
                       cudaStream_t st) {
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (M <= 0 || (N % 128 && N % 192) || !aligned(a.a1) || !aligned(W) || !aligned(epi.out) ||
      !aligned(epi.residual()))
    return TMA_NOT_TAKEN;
  if constexpr (VEC) {
    if (a.s1k != 1 || a.s1m % 8 || a.K1 % 8 || a.K2 % 8 || (a.K2 && (a.K1 % BK || !aligned(a.a2))))
      return TMA_NOT_TAKEN;
    if (N % 128 == 0) return launch_tma_tiles<128, 128, false>(a, W, epi, M, N, K, st);
    return launch_tma_tiles<64, 192, false>(a, W, epi, M, N, K, st);
  } else {
    if (a.s1m != 1 || a.s1k != M || M % 8 || a.K2) return TMA_NOT_TAKEN;
    if (N % 128 == 0) return launch_tma_tiles<128, 128, true>(a, W, epi, M, N, K, st);
    return launch_tma_tiles<64, 192, true>(a, W, epi, M, N, K, st);
  }
}

// C[M, N] = epi(A[M, K] @ W[K, N]).  One block a tile, the column blocks of
// one row block next to each other in the grid, so its A tile (or computed
// prologue) is read from device memory once and from L2 after.  (A persistent
// block walking several tiles with the next tile's loads in flight during the
// epilogue measured 17 % slower on an H100: the two blocks of an SM then run
// their epilogues in step.)
template <int BN, class ALoad, class Epi>
__global__ void __launch_bounds__(THREADS, 2)
    rowgemm_kernel(ALoad aload, const bf16* __restrict__ W, Epi epi, int M, int N, int K) {
  using T = Tile<BN>;
  static_assert(T::SMEM <= 113 * 1024, "two blocks an SM");
  extern __shared__ unsigned char smem_raw[];
  const int tiles_n = (N + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * T::BM, n0 = (blockIdx.x % tiles_n) * BN;
  float acc[BN / 2];
  gemm_mainloop<BN>(aload, W, m0, n0, N, K, align1024(smem_raw), acc);
  const int wg = threadIdx.x >> 7;
  for_each_8<BN>(acc, [&](int r, int c, float* v, int) {
    const int gr = m0 + wg * 64 + r, gc = n0 + c;
    if (gr < M && gc < N) {
      const int nv = min(8, N - gc);
      float b[8], res[8];
      load8f(epi.bias + gc, nv, b);
      load_residual(epi, gr, gc, nv, res);
      epi.apply(gr, gc, v, b, res);
      store_out(epi.out, epi.N, gr, gc, v, nv);
    }
  });
}

template <int BN, class ALoad, class Epi>
static int ring_kernel_attribute() {
  static const int err = static_cast<int>(cudaFuncSetAttribute(
      rowgemm_kernel<BN, ALoad, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tile<BN>::SMEM));
  return err;
}

template <class ALoad, class Epi>
int launch_rowgemm(const ALoad& aload, const void* W, const Epi& epi, int M, int N, int K,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* w = static_cast<const bf16*>(W);
  if constexpr (std::is_same<ALoad, ARows<true>>::value) {
    const int err = launch_rowgemm_tma(aload, w, epi, M, N, K, st);
    if (err != TMA_NOT_TAKEN) return err;
  }
  auto go = [&](auto kernel, int bn, size_t smem, int attr_err) {
    if (attr_err) return attr_err;
    const long long tiles = (long long)((N + bn - 1) / bn) * ((M + 127) / 128);
    if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
    kernel<<<(unsigned)tiles, THREADS, smem, st>>>(aload, w, epi, M, N, K);
    return static_cast<int>(cudaGetLastError());
  };
  if (N % 128 == 0)
    return go(rowgemm_kernel<128, ALoad, Epi>, 128, Tile<128>::SMEM,
              ring_kernel_attribute<128, ALoad, Epi>());
  return go(rowgemm_kernel<64, ALoad, Epi>, 64, Tile<64>::SMEM,
            ring_kernel_attribute<64, ALoad, Epi>());
}

// out[row] = bf16([res[row] +] bf16(LN(y[row]))), one warp per row, C % 8
// == 0; out may be y.
__global__ void ln_rows_kernel(const bf16* y, const float* __restrict__ scale,
                               const float* __restrict__ bias, const bf16* __restrict__ res,
                               bf16* out, int rows, int C, float eps) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const bf16* yr = y + (size_t)row * C;
  const bf16* rr = res ? res + (size_t)row * C : nullptr;
  bf16* orow = out + (size_t)row * C;
  layernorm_rows_warp([&](int v) { return yr + v * 8; }, scale, bias, C, eps, [&](int v, float* o) {
                        if (rr) {
                          float r8[8];
                          load8(rr + v * 8, r8);
#pragma unroll
                          for (int u = 0; u < 8; ++u) o[u] = bf16_round(o[u]) + r8[u];
                        }
                        store8(orow + v * 8, o);
                      });
}

inline int launch_ln_rows(const void* y, const void* scale, const void* bias, const void* res,
                          void* out, int rows, int C, float eps, void* stream) {
  const int warps = 8;
  ln_rows_kernel<<<(rows + warps - 1) / warps, warps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(y), static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const bf16*>(res), static_cast<bf16*>(out), rows, C, eps);
  return static_cast<int>(cudaGetLastError());
}

// out (G, S, C) bf16; x (G * R, C) bf16; local (G, R) int32; C even.
constexpr int SEG_THREADS = SEG_COLS / 2, SEG_ROWS = 16;  // rows a batch; two batches in flight

__global__ void __launch_bounds__(SEG_THREADS)
    segsum_kernel(const bf16* __restrict__ x, const int* __restrict__ local,
                  bf16* __restrict__ out, int R, int S, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);  // S x SEG_COLS
  int* loc = reinterpret_cast<int*>(acc + (size_t)S * SEG_COLS);  // R
  const int g = blockIdx.x, t = threadIdx.x;
  const int c = blockIdx.y * SEG_COLS + 2 * t;
  for (int i = t; i < S * SEG_COLS; i += SEG_THREADS) acc[i] = 0.f;
  for (int i = t; i < R; i += SEG_THREADS) loc[i] = local[(size_t)g * R + i];
  __syncthreads();
  if (c >= C) return;
  const bf16* xg = x + (size_t)g * R * C + c;
  float2* mine = reinterpret_cast<float2*>(acc) + t;  // this thread's columns of segment 0
  float2 run = make_float2(0.f, 0.f);
  int cur = -1;  // the id of the run being summed
  auto flush = [&]() {
    if ((unsigned)cur < (unsigned)S) {
      float2* p = mine + cur * SEG_THREADS;
      *p = make_float2(p->x + run.x, p->y + run.y);
    }
  };
  // the next SEG_ROWS rows are in flight while these are summed
  auto load = [&](__nv_bfloat162(&v)[SEG_ROWS], int r0) {
#pragma unroll
    for (int u = 0; u < SEG_ROWS; ++u)
      if (r0 + u < R) v[u] = *reinterpret_cast<const __nv_bfloat162*>(xg + (size_t)(r0 + u) * C);
  };
  __nv_bfloat162 v[SEG_ROWS], next[SEG_ROWS];
  load(v, 0);
  for (int r0 = 0; r0 < R; r0 += SEG_ROWS) {
    if (r0 + SEG_ROWS < R) load(next, r0 + SEG_ROWS);
#pragma unroll
    for (int u = 0; u < SEG_ROWS; ++u) {
      if (r0 + u >= R) break;
      const int s = loc[r0 + u];
      if (s != cur) {
        flush();
        run = make_float2(0.f, 0.f);
        cur = s;
      }
      const float2 f = __bfloat1622float2(v[u]);
      run.x += f.x;
      run.y += f.y;
    }
#pragma unroll
    for (int u = 0; u < SEG_ROWS; ++u) v[u] = next[u];
  }
  flush();
  for (int s = 0; s < S; ++s) {
    const float2 a = mine[s * SEG_THREADS];
    *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)g * S + s) * C + c) =
        __floats2bfloat162_rn(a.x, a.y);
  }
}

// A too large S x SEG_COLS table fails cudaFuncSetAttribute; the error is
// returned to the wrapper, which raises.
inline int launch_segsum(const void* x, const void* local, void* out, int G, int R, int S, int C,
                         void* stream) {
  if (C % 2) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)S * SEG_COLS * 4 + (size_t)R * 4;
  cudaError_t err = cudaFuncSetAttribute(segsum_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(G, (C + SEG_COLS - 1) / SEG_COLS);
  segsum_kernel<<<grid, SEG_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const int*>(local), static_cast<bf16*>(out), R, S,
      C);
  return static_cast<int>(cudaGetLastError());
}


// --- rows_ln_kernel: computed prologue -> Dense -> LayerNorm, whole rows a block ---
//
// out[o] = bf16(sum_{k < GROUP} bf16(LN(bf16(A[GROUP o + k] @ W + b)))), the
// sum in f32 in slot order, for M rows of L <= 512 columns, A[q] computed by
// a prologue functor, in one launch.  GROUP 1 (K9, K14, K13 at deg 1): out[q]
// is row q's message, 64-row tiles.  GROUP 2 to 4 (K13 at deg 2 to 4; K8 at
// 3): a tile is ROWS<GROUP> / GROUP = 32, 21 or 16 output points = 64, 63 or
// 64 rows, so every point's GROUP slot rows lie in one tile (GROUP 3: row 63
// of the 64-row wgmma tile is padding, set to 0 once, computed row by row and
// never stored).  The block's tile is all 512 columns, so that every row it
// writes is complete in the block and the LayerNorm (and the slot sum) runs
// in the epilogue.  One persistent block an SM walks the tiles blockIdx.x, +
// gridDim.x, ...
//
// - Prologue warps (warps 0-2 of the third warpgroup, setmaxnreg 72):
//   compute a tile's whole A block once, 64 rows x 512 K bf16 (64 KB, eight
//   slices of 64 K in gemm_mainloop's A layout), into one of two A buffers,
//   so the next tile's prologue runs while this one multiplies.  Each thread
//   fences its stores for the async proxy (wgmma) and arrives on the
//   buffer's a_full barrier.  Rows past M and columns past L come in as 0.
//   GROUP 1 with TmaRows (K6's finish: A is plain rows, nothing computed):
//   one thread brings the tile's 64 rows by TMA, boxes of 64 columns in the
//   128-byte swizzle straight into the A slices, completing on a_full.
//   Rows (GROUP 1, Pro::index / copy / load / make; K9): warp w takes
//   the rows w, w + 3, ..., a lane two 16-byte chunks of each.  The first
//   source of every chunk comes by cp.async straight to the chunk's place in
//   the buffer (a whole tile's worth in flight at once, without registers),
//   the others by loads into registers two rows at a time; the prologue is
//   then computed in place.
//   Points (GROUP > 1, or a Pro with POINTS; Pro::index / load / make; K8,
//   K13, K14): the tile's first source rows are contiguous
//   (Pro::rows_by_tma(), rows TR t .. TR t + TR - 1 for TR = ROWS<GROUP>),
//   so one thread brings them by TMA, boxes of 64 columns x TR rows in the
//   128-byte swizzle straight into the A slices (x_full), while warp w
//   loads the points w, w + 3, ... < PRODUCER_POINTS<GROUP>: a lane the other
//   sources of two chunks of all GROUP of a point's rows into registers
//   (Pro::IN_FLIGHT points at once, 1 unless it says), then its rows
//   computed in place.  The consumers compute the tile's other points
//   (share() below) and arrive on a_full too.
// - W thread (lane 0 of warp 3): TMA loads of W into a ring of W_STAGES
//   slices of 32 K x 512 columns (w_full / w_empty), the same walk for every
//   tile; columns and rows past L read as 0.
// - Two consumer warpgroups (setmaxnreg 216) share each A block; consumer c
//   owns columns 256c .. 256c + 255 of every tile (wgmma m64n256k16, 128 f32
//   accumulators a thread).  Epilogue: y = Epi::dense (bias, bf16), each
//   row's sums of y and y^2 over the consumer's columns (a quad's shuffles),
//   exchanged with the other consumer through shared memory under named
//   barrier 5, then Epi::norm with f32 statistics (fast variance clipped at
//   0); the bf16 values go into the A buffer just multiplied (both consumers
//   are past their products at barrier 5), in boxes of 64 columns in the
//   128-byte swizzle.  GROUP > 1: under the consumer's named barrier 6 + c,
//   each point's GROUP staged rows are read and summed in f32, then (after
//   a second barrier) the bf16 sums written in place as rows 0 .. TR / GROUP
//   - 1.
//   Epi::RESIDUAL (GROUP 1): once both consumers are past barrier 5 (the A
//   buffer read), one thread of each brings the residual's boxes of its
//   columns by TMA into the staging places (res_full[c]), and each output
//   pair is added to the residual pair it overwrites.
//   One thread of each consumer stores its four boxes by TMA (rows past the
//   output clipped), waits until the store has read them and arrives on the
//   buffer's a_empty barrier: the producer may refill it.  Points: then
//   every consumer thread computes its part of points PRO_POINTS .. TR /
//   GROUP - 1 of the next tile's prologue (its accumulators are dead, it would otherwise
//   wait on a_full), all its loads in flight at once, and arrives on
//   a_full.
//
// The exchange area holds one tile's partials: a consumer cannot write the
// next tile's before the other has read these, since the W slices of the next
// tile past the ring's depth are loaded only once both consumers have
// released the slices before them, and the other consumer releases them only
// after this epilogue.
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W, tools/kernel_variants.py
// g2m and m2g): the prologue's gathers.  K9 at full width: with the
// prologue left out, products, W stream (13.4 GB from L2) and epilogue take
// 2.1 ms; the prologue's arithmetic without its loads 2.5 ms; with its
// gathers 5.5 ms.  Three warps hold too few loads in flight, and the
// consumers' 128 accumulators a thread leave them 72 registers (a
// 512-thread block cannot compile the m64n256 product within 128
// registers).  K8 (49,440 tiles): 11.4 ms with the three warps computing
// every point, 8.5 ms with the consumers taking 9 of the 21 (12 producer
// points; 9 gave 9.4, 15 gave 9.5, 0 gave 13.3 ms).  K6's finish (16,223
// tiles over the grid rows, nothing to compute): 1.59 ms, 2.28 ms with the
// residual, whose TMA load in the epilogue nothing hides (kernel_variants
// mlp); with the residual's pairs or chunks in registers it took 2.8-4.0 ms.
// K13 (49,440 tiles of 21 points at deg 3) 8.7 ms and K14's messages (25,728
// tiles of 64 rows) 3.7 ms, also held by their prologues (graph_finish.cu).
// K12 over the grid rows (16,223 tiles, the swish in place on rows by TMA)
// 1.63 ms, the same with no swish: held, as K6's finish, by the rest of the
// tile (products, W stream, epilogue), not by its prologue.
namespace rowln {
constexpr int BM = 64, WIDTH = 512, BKW = 32;  // wgmma tile rows, the widest L, W slice depth
constexpr int A_BYTES = BM * WIDTH * 2;        // a whole tile's A block
constexpr int W_BYTES = BKW * WIDTH * 2;       // a W slice: 8 column atoms x 4 k-atoms
constexpr int W_STAGES = 3;
constexpr int THREADS = 384, PRO_WARPS = 3, PRO_THREADS = PRO_WARPS * 32;
constexpr int STATS_BYTES = 2 * BM * 8;        // (consumer, row) -> (sum, sum of squares)
constexpr size_t SMEM = 1024 + 2 * (size_t)A_BYTES + W_STAGES * (size_t)W_BYTES + STATS_BYTES + 128;
static_assert(SMEM <= 232448, "fits a block");
// rows a tile computes and stores: whole groups of GROUP rows (64, 64, 63, 64)
template <int GROUP>
constexpr int ROWS = BM - BM % GROUP;
// points: the producer warps compute points 0 .. PRO_POINTS - 1 of a tile
// (a multiple of PRO_WARPS points), the consumers the others.  K8 at GROUP 3:
// 12 of 21 points (9 gave 9.4, 15 gave 9.5 ms against 8.5; K13 at deg 3 9.1
// and 9.8 against 8.7).  K14 at GROUP 1: 54 of 64 rows 3.7 ms (36: 4.7, 48:
// 4.4, 51: 4.4, 57: 4.3, 60: 4.0, 63: 4.6; tools/kernel_variants.py messages).
// GROUP 2 and 4: 36 rows, not tuned.
template <int GROUP>
constexpr int PRODUCER_POINTS = GROUP == 1 ? 54 : GROUP == 2 ? 18 : GROUP == 3 ? 12 : 9;
// what a Pro says of its schedule, beside its functions.  POINTS: its rows
// come a point at a time, the first source by TMA (every GROUP > 1 does, a
// GROUP 1 Pro when it says so).  IN_FLIGHT: the points whose loads a producer
// lane keeps in flight at once on that path, 1 unless it says.
template <class P, class = void>
struct says_points : std::false_type {};
template <class P>
struct says_points<P, std::void_t<decltype(P::POINTS)>> : std::bool_constant<P::POINTS> {};
template <int GROUP, class Pro>
constexpr bool BY_POINTS = GROUP > 1 || says_points<Pro>::value;
template <class P, class = void>
struct in_flight : std::integral_constant<int, 1> {};
template <class P>
struct in_flight<P, std::void_t<decltype(P::IN_FLIGHT)>> : std::integral_constant<int, P::IN_FLIGHT> {};
}  // namespace rowln

// out = bf16(LN(bf16(acc + b))), flax numerics.
struct EpiLN {
  static constexpr bool RESIDUAL = false;
  const float* b;      // (L,) dense bias
  const float* scale;  // (L,) LayerNorm scale
  const float* shift;  // (L,) LayerNorm bias
  float eps;

  __device__ __forceinline__ float2 dense(int col, float a0, float a1) const {
    const float2 bb = __ldg(reinterpret_cast<const float2*>(b + col));
    return make_float2(bf16_round(a0 + bb.x), bf16_round(a1 + bb.y));
  }
  __device__ __forceinline__ float2 norm(int col, float y0, float y1, float mu, float inv) const {
    const float2 s = __ldg(reinterpret_cast<const float2*>(scale + col));
    const float2 t = __ldg(reinterpret_cast<const float2*>(shift + col));
    return make_float2((y0 - mu) * inv * s.x + t.x, (y1 - mu) * inv * s.y + t.y);
  }
};

// out = bf16(res + bf16(LN(bf16(acc + b)))), the residual (M, L) after the
// LayerNorm, as K6's LayerNorm rows kernel adds it (GROUP 1).
struct EpiLNRes : EpiLN {
  static constexpr bool RESIDUAL = true;
  const bf16* res;
};

// rows_ln_kernel's A as plain (M, L) row-major bf16 rows, brought by TMA with
// nothing computed (K6's second Dense, GROUP 1).
struct TmaRows {
  const bf16* a;
  __host__ __device__ const bf16* rows_by_tma() const { return a; }
};

template <int GROUP, class Pro, class Epi>
__global__ void __launch_bounds__(rowln::THREADS, 1)
    rows_ln_kernel(Pro pro, __grid_constant__ const CUtensorMap mapA,
                   __grid_constant__ const CUtensorMap mapW,
                   __grid_constant__ const CUtensorMap mapOut,
                   __grid_constant__ const CUtensorMap mapRes, Epi epi, int M, int L, int tiles) {
  using namespace rowln;
  static_assert(GROUP >= 1 && GROUP <= 4, "one to four slot rows a point");
  constexpr bool A_BY_TMA = std::is_same<Pro, TmaRows>::value;  // K6's finish: plain rows, nothing computed
  constexpr bool PTS = BY_POINTS<GROUP, Pro>;
  static_assert((!A_BY_TMA && !Epi::RESIDUAL) || GROUP == 1, "plain rows and the residual are GROUP 1's");
  static_assert(!(A_BY_TMA && PTS), "plain rows compute nothing");
  constexpr int TR = ROWS<GROUP>, OUT_ROWS = TR / GROUP;  // 64 / 64, 64 / 32, 63 / 21 or 64 / 16
  constexpr int PRO_POINTS = PRODUCER_POINTS<GROUP>;
  static_assert(PRO_POINTS % PRO_WARPS == 0 && PRO_POINTS < OUT_ROWS, "the producers' points divide among them");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* abuf = align1024(smem_raw);  // two A buffers, then the W ring
  unsigned char* wring = abuf + 2 * A_BYTES;
  float2* stats = reinterpret_cast<float2*>(wring + W_STAGES * W_BYTES);
  const unsigned w_full0 = smem_addr(stats + 2 * BM), w_empty0 = w_full0 + 8 * W_STAGES;
  const unsigned a_full0 = w_empty0 + 8 * W_STAGES, a_empty0 = a_full0 + 16;
  const unsigned x_full0 = a_empty0 + 16;  // points: the TMA-brought rows of buffer b landed
  const unsigned res_full0 = x_full0 + 16;  // Epi::RESIDUAL: consumer c's residual boxes landed
  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(w_full0 + 8 * s, 1);
      mbar_init(w_empty0 + 8 * s, 8);  // every consumer warp
    }
    for (int b = 0; b < 2; ++b) {
      // points: the consumers too; plain rows: the TMA thread's one arrival with the bytes
      mbar_init(a_full0 + 8 * b, A_BY_TMA ? 1 : PTS ? PRO_THREADS + 256 : PRO_THREADS);
      mbar_init(a_empty0 + 8 * b, 2);  // one thread of each consumer
      mbar_init(x_full0 + 8 * b, 1);
      if constexpr (Epi::RESIDUAL) mbar_init(res_full0 + 8 * b, 1);  // per consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // GROUP 3: the padding row of both buffers, which no prologue writes, set
  // to 0 (K8 measured 8.6-8.9 ms with this, 9.1 ms with the row left as
  // shared memory held it; NVIDIA H100 80GB HBM3, 700 W)
  if constexpr (TR < BM) {
    for (int i = tid; i < 2 * 8 * (BM - TR) * 8; i += rowln::THREADS) {
      const int chunk = i & 7, row = TR + ((i >> 3) % (BM - TR)), slice = (i >> 3) / (BM - TR);
      *reinterpret_cast<uint4*>(abuf + slice * (BM * 128) + row * 128 + chunk * 16) = make_uint4(0, 0, 0, 0);
    }
    fence_async_shared();
  }
  __syncthreads();
  const int nk = (L + BKW - 1) / BKW;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n");
    const int warp = (tid >> 5) - 8, lane = tid & 31;
    if (warp == PRO_WARPS) {  // the W thread
      if (lane) return;
      int stage = 0;
      unsigned phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(w_empty0 + 8 * stage, phase ^ 1);  // passes at once the first time round
          const unsigned full = w_full0 + 8 * stage, slot = smem_addr(wring + stage * W_BYTES);
          mbar_expect_tx(full, W_BYTES);
#pragma unroll
          for (int j = 0; j < WIDTH / 64; ++j)
            tma_load_2d(slot + j * (BKW / 8) * 1024, &mapW, full, 64 * j, kt * BKW);
          if (++stage == W_STAGES) stage = 0, phase ^= 1;
        }
      return;
    }
    // chunk c of row r of the A block: slice c / 8, the 128-byte swizzle
    const auto chunk = [](unsigned char* a, int r, int kc) {
      return reinterpret_cast<bf16*>(a + (kc >> 3) * (BM * 128) + r * 128 + (((kc & 7) ^ (r & 7)) << 4));
    };
    if constexpr (A_BY_TMA) {  // one thread brings each tile's rows by TMA, 0 past M and L
      if (warp || lane) return;
      const int slices = (L + 63) / 64;  // A slices that hold columns < L
      for (int tile = blockIdx.x, p = 0; tile < tiles; tile += gridDim.x, ++p) {
        const int b = p & 1;
        const unsigned a_full = a_full0 + 8 * b;
        mbar_wait(a_empty0 + 8 * b, ((p >> 1) & 1) ^ 1);  // passes at once on the first use
        mbar_expect_tx(a_full, slices * BM * 128);
        for (int s = 0; s < slices; ++s)
          tma_load_2d(smem_addr(abuf + b * A_BYTES) + s * (BM * 128), &mapA, a_full, 64 * s, tile * BM);
      }
    } else if constexpr (!PTS) {  // warp w computes rows w, w + 3, ... of each tile
      constexpr int PER = (BM + PRO_WARPS - 1) / PRO_WARPS;  // 22
      for (int tile = blockIdx.x, p = 0; tile < tiles; tile += gridDim.x, ++p) {
        const int b = p & 1, m0 = tile * BM;
        unsigned char* a = abuf + b * A_BYTES;
        // lane i holds the handle of the warp's i-th row
        const int my_row = warp + PRO_WARPS * lane;
        const int handle = lane < PER && my_row < BM ? pro.index(m0 + my_row, M) : -1;
        mbar_wait(a_empty0 + 8 * b, ((p >> 1) & 1) ^ 1);  // passes at once on the first use
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const int r = warp + PRO_WARPS * i, hd = __shfl_sync(0xffffffffu, handle, i);
          if (r < BM)
#pragma unroll
            for (int c = 0; c < 2; ++c) pro.copy(hd, (lane + 32 * c) * 8, L, chunk(a, r, lane + 32 * c));
        }
        cp_async_commit();
#pragma unroll 1
        for (int i = 0; i < PER; i += 2) {
          typename Pro::Raw raw[2][2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int hd = __shfl_sync(0xffffffffu, handle, i + h);
#pragma unroll
            for (int c = 0; c < 2; ++c) pro.load(hd, (lane + 32 * c) * 8, L, raw[h][c]);
          }
          if (i == 0) cp_async_wait<0>();  // this thread's copies have landed
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = warp + PRO_WARPS * (i + h);
            if (r >= BM) continue;
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int kc = lane + 32 * c;
              pro.make(raw[h][c], kc * 8, L, chunk(a, r, kc));
            }
          }
        }
        fence_async_shared();
        mbar_arrive(a_full0 + 8 * b);
      }
    } else {  // warp w computes points w, w + 3, ... < PRO_POINTS (rows GROUP pt ..) of each tile
      constexpr int PER = PRO_POINTS / PRO_WARPS;
      constexpr int STEP = in_flight<Pro>::value;  // points whose loads are in flight at once
      static_assert(PER % STEP == 0, "a warp's points divide into steps");
      const int slices = (L + 63) / 64;  // A slices that hold columns < L
      for (int tile = blockIdx.x, p = 0; tile < tiles; tile += gridDim.x, ++p) {
        const int b = p & 1, o0 = tile * OUT_ROWS;
        unsigned char* a = abuf + b * A_BYTES;
        const unsigned x_full = x_full0 + 8 * b;
        // lane i holds the handle of the warp's i-th point
        const int handle = lane < PER ? pro.index(o0 + warp + PRO_WARPS * lane) : -1;
        mbar_wait(a_empty0 + 8 * b, ((p >> 1) & 1) ^ 1);  // passes at once on the first use
        if (warp == 0 && lane == 0) {  // the tile's first source rows by TMA, 0 past M and L
          mbar_expect_tx(x_full, slices * TR * 128);
          for (int s = 0; s < slices; ++s) tma_load_2d(smem_addr(a) + s * (BM * 128), &mapA, x_full, 64 * s, tile * TR);
        }
#pragma unroll 1
        for (int i = 0; i < PER; i += STEP) {
          typename Pro::Raw raw[STEP][2];
#pragma unroll
          for (int h = 0; h < STEP; ++h) {
            const int pt = warp + PRO_WARPS * (i + h), hd = __shfl_sync(0xffffffffu, handle, i + h);
#pragma unroll
            for (int c = 0; c < 2; ++c) pro.load(hd, o0 + pt, (lane + 32 * c) * 8, L, raw[h][c]);
          }
          if (i == 0) mbar_wait(x_full, (p >> 1) & 1);
#pragma unroll
          for (int h = 0; h < STEP; ++h) {
            const int pt = warp + PRO_WARPS * (i + h);
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int kc = lane + 32 * c;
              bf16* rows[GROUP];
#pragma unroll
              for (int k = 0; k < GROUP; ++k) rows[k] = chunk(a, GROUP * pt + k, kc);
              pro.make(raw[h][c], kc * 8, L, rows);
            }
          }
        }
        fence_async_shared();
        mbar_arrive(a_full0 + 8 * b);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n");
  constexpr unsigned B_N_STRIDE = (BKW / 8) * 1024, B_K_STRIDE = 1024;
  const int c = wg, w = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const bool elected = (tid & 127) == 0;
  // points: this thread's share of the prologue of the tile at position p
  // of the walk (buffer p & 1), points PRO_POINTS .. OUT_ROWS - 1, a task one
  // (point, 16-byte chunk of its GROUP rows), all its loads in flight at once
  // once the tile's TMA-brought rows have landed; then it arrives on a_full
  // as the producer warps do.  Run between a tile's epilogue and the next
  // tile's products, when the accumulators are dead.
  const auto share = [&](int tile, int p) {
    if constexpr (PTS) {
      constexpr int TASKS = (OUT_ROWS - PRO_POINTS) * 64, PER = (TASKS + 255) / 256;
      const int b = p & 1, o0 = tile * OUT_ROWS;
      unsigned char* a = abuf + b * A_BYTES;
      int hd[PER];
      typename Pro::Raw raw[PER];
#pragma unroll
      for (int n = 0; n < PER; ++n) {
        const int task = tid + 256 * n;
        hd[n] = task < TASKS ? pro.index(o0 + PRO_POINTS + (task >> 6)) : -1;
      }
#pragma unroll
      for (int n = 0; n < PER; ++n) {
        const int task = tid + 256 * n;
        pro.load(hd[n], o0 + PRO_POINTS + (task >> 6), (task & 63) * 8, L, raw[n]);
      }
      mbar_wait(x_full0 + 8 * b, (p >> 1) & 1);
#pragma unroll
      for (int n = 0; n < PER; ++n) {
        const int task = tid + 256 * n, pt = PRO_POINTS + (task >> 6), kc = task & 63;
        if (task >= TASKS) continue;
        const auto chunk = [&](int r) {
          return reinterpret_cast<bf16*>(a + (kc >> 3) * (BM * 128) + r * 128 + (((kc & 7) ^ (r & 7)) << 4));
        };
        bf16* rows[GROUP];
#pragma unroll
        for (int k = 0; k < GROUP; ++k) rows[k] = chunk(GROUP * pt + k);
        pro.make(raw[n], kc * 8, L, rows);
      }
      fence_async_shared();
      mbar_arrive(a_full0 + 8 * b);
    }
  };
  share(blockIdx.x, 0);
  int stage = 0;
  unsigned phase = 0;
  for (int tile = blockIdx.x, p = 0; tile < tiles; tile += gridDim.x, ++p) {
    const int b = p & 1;
    unsigned char* a = abuf + b * A_BYTES;
    const unsigned a0 = smem_addr(a);
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    mbar_wait(a_full0 + 8 * b, (p >> 1) & 1);
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(w_full0 + 8 * stage, phase);
      const unsigned b0 = smem_addr(wring + stage * W_BYTES) + c * 4 * B_N_STRIDE;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BKW / 16; ++ks) {
        const int kstep = kt * (BKW / 16) + ks;  // 16-deep step: A slice kstep / 4, 32 bytes each
        wgmma_bf16<256>(acc, wgmma_desc(a0 + (kstep >> 2) * (BM * 128) + (kstep & 3) * 32, 16, 1024),
                        wgmma_desc(b0 + ks * 2 * B_K_STRIDE, B_N_STRIDE, B_K_STRIDE));
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous slice's products are done: its slot goes back
      if (kt > 0 && lane == 0) mbar_arrive(w_empty0 + 8 * (stage == 0 ? W_STAGES - 1 : stage - 1));
      if (++stage == W_STAGES) stage = 0, phase ^= 1;
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(w_empty0 + 8 * (stage == 0 ? W_STAGES - 1 : stage - 1));

    // epilogue: acc[4j + 2h + e] is row 16w + g + 8h, column 256c + 8j + 2q + e
    float s[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = 256 * c + 8 * j + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2 y = make_float2(0.f, 0.f);
        if (col < L) y = epi.dense(col, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        acc[4 * j + 2 * h] = y.x;
        acc[4 * j + 2 * h + 1] = y.y;
        s[h] += y.x + y.y;
        s2[h] += y.x * y.x + y.y * y.y;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        s[h] += __shfl_xor_sync(0xffffffffu, s[h], o);
        s2[h] += __shfl_xor_sync(0xffffffffu, s2[h], o);
      }
      if (q == 0) stats[c * BM + 16 * w + g + 8 * h] = make_float2(s[h], s2[h]);
    }
    bar_sync(5, 256);  // both consumers' partials written, both past their products
    // Epi::RESIDUAL: the A buffer is free, so the residual's boxes of this
    // consumer's columns come by TMA into the places the output is staged in
    // (rows past M as 0), and the normalisation below adds each pair where it
    // stages it
    if constexpr (Epi::RESIDUAL) {
      if (elected) {
        const unsigned res_full = res_full0 + 8 * c;
        int boxes = 0;
        for (int bx = 0; bx < 4; ++bx) boxes += 64 * (4 * c + bx) < L;
        mbar_expect_tx(res_full, boxes * BM * 128);
        for (int bx = 0; bx < boxes; ++bx)
          tma_load_2d(a0 + (4 * c + bx) * (BM * 128), &mapRes, res_full, 64 * (4 * c + bx), tile * BM);
      }
    }
    float mu[2], inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 o = stats[(c ^ 1) * BM + 16 * w + g + 8 * h];
      mu[h] = (s[h] + o.x) / L;  // the same bits in both consumers: f32 addition commutes
      inv[h] = rsqrtf(fmaxf((s2[h] + o.y) / L - mu[h] * mu[h], 0.f) + epi.eps);
    }
    if constexpr (Epi::RESIDUAL) mbar_wait(res_full0 + 8 * c, p & 1);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = 256 * c + 8 * j + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * w + g + 8 * h;
        float2 v = make_float2(0.f, 0.f);
        if (col < L) v = epi.norm(col, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], mu[h], inv[h]);
        // box 4c + j / 8 (columns of 64), the 16-byte chunk j % 8 of row r in the swizzle
        unsigned* const dst = reinterpret_cast<unsigned*>(a + (4 * c + (j >> 3)) * (BM * 128) + r * 128 +
                                                          ((((j & 7) ^ (r & 7))) << 4) + 4 * q);
        if constexpr (Epi::RESIDUAL) {  // bf16(res + bf16(LN(y))), res where the pair is staged
          if (col < L) {
            const float2 rr = unpack_bf16(*dst);
            v = make_float2(bf16_round(v.x) + rr.x, bf16_round(v.y) + rr.y);
          }
        }
        *dst = pack_bf16(v.x, v.y);
      }
    }
    if constexpr (GROUP > 1) {
      // each point's GROUP staged rows summed in f32 in slot order, a task
      // one (point, 16-byte chunk of this consumer's 256 columns), then the
      // sums written in place as rows 0 .. OUT_ROWS - 1 once every read is done
      constexpr int TASKS = OUT_ROWS * 32, PER = (TASKS + 127) / 128;
      const int t = tid & 127;
      const auto at = [&](int r, int kc) {  // chunk kc of this consumer's row r
        return a + (4 * c + (kc >> 3)) * (BM * 128) + r * 128 + ((((kc & 7) ^ (r & 7))) << 4);
      };
      bar_sync(6 + c, 128);  // this consumer's rows are staged
      uint4 sum[PER];
#pragma unroll
      for (int n = 0; n < PER; ++n) {
        const int task = t + 128 * n, pt = task >> 5, kc = task & 31;
        if (task >= TASKS) continue;
        float f[8], o[8];
        load8(reinterpret_cast<const bf16*>(at(GROUP * pt, kc)), o);
#pragma unroll
        for (int k = 1; k < GROUP; ++k) {
          load8(reinterpret_cast<const bf16*>(at(GROUP * pt + k, kc)), f);
#pragma unroll
          for (int u = 0; u < 8; ++u) o[u] += f[u];
        }
        sum[n] = make_uint4(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]), pack_bf16(o[4], o[5]), pack_bf16(o[6], o[7]));
      }
      bar_sync(6 + c, 128);  // every staged row read
#pragma unroll
      for (int n = 0; n < PER; ++n) {
        const int task = t + 128 * n;
        if (task < TASKS) *reinterpret_cast<uint4*>(at(task >> 5, task & 31)) = sum[n];
      }
    }
    fence_async_shared();  // made visible to the TMA unit, then stored by one thread
    bar_sync(6 + c, 128);
    if (elected) {
#pragma unroll
      for (int bx = 0; bx < 4; ++bx)
        if (64 * (4 * c + bx) < L)
          tma_store_2d(&mapOut, a0 + (4 * c + bx) * (BM * 128), 64 * (4 * c + bx), tile * OUT_ROWS);
      bulk_commit();
      bulk_wait_read<0>();
      mbar_arrive(a_empty0 + 8 * b);  // this consumer's half of the buffer is free again
    }
    if (tile + gridDim.x < tiles) share(tile + gridDim.x, p + 1);
  }
}

template <int GROUP, class Pro, class Epi>
static int rows_ln_attribute() {
  static const int err = static_cast<int>(cudaFuncSetAttribute(
      rows_ln_kernel<GROUP, Pro, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rowln::SMEM));
  return err;
}

// Launches rows_ln_kernel over M rows of L columns (L % 8 == 0, L <= 512,
// M % GROUP == 0; W (L, L) row-major, out (M / GROUP, L), both 16-byte
// aligned).  Points and TmaRows: Pro::rows_by_tma() is an (M, L) row-major
// bf16 matrix, 16-byte aligned, the first source of every A row (TmaRows:
// the only one).  EpiLNRes: its residual (M, L), 16-byte aligned.
template <int GROUP, class Pro, class Epi>
int launch_rows_ln(const Pro& pro, const void* W, const Epi& epi, void* out, int M, int L, void* stream) {
  constexpr int TR = rowln::ROWS<GROUP>;
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (M <= 0 || M % GROUP || L <= 0 || L % 8 || L > rowln::WIDTH || !aligned(W) || !aligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mapA, mapW, mapOut, mapRes;
  if (int err = make_tensor_map(&mapW, W, L, L, L, rowln::BKW)) return err;
  if (int err = make_tensor_map(&mapOut, out, M / GROUP, L, L, TR / GROUP)) return err;
  mapA = mapRes = mapW;  // not read where the prologue computes every row (K9), without a residual
  if constexpr (Epi::RESIDUAL) {
    if (!aligned(epi.res)) return static_cast<int>(cudaErrorInvalidValue);
    if (int err = make_tensor_map(&mapRes, epi.res, M, L, L, TR)) return err;
  }
  if constexpr (rowln::BY_POINTS<GROUP, Pro> || std::is_same<Pro, TmaRows>::value) {
    if (!aligned(pro.rows_by_tma())) return static_cast<int>(cudaErrorInvalidValue);
    if (int err = make_tensor_map(&mapA, pro.rows_by_tma(), M, L, L, TR)) return err;
  }
  if (int err = rows_ln_attribute<GROUP, Pro, Epi>()) return err;
  const int tiles = (M + TR - 1) / TR;
  const unsigned grid = (unsigned)(tiles < sm_count() ? tiles : sm_count());
  rows_ln_kernel<GROUP, Pro, Epi><<<grid, rowln::THREADS, rowln::SMEM, static_cast<cudaStream_t>(stream)>>>(
      pro, mapA, mapW, mapOut, mapRes, epi, M, L, tiles);
  return static_cast<int>(cudaGetLastError());
}

// --- ln_gemm_kernel: LayerNorm in the prologue -> Dense, whole rows of K a block ---
//
// out = epi(bf16(LN(x) * scale + shift) @ W + b), flax LayerNorm numerics,
// for M rows of K <= 512 columns (K % 8 == 0), W (K, N) row-major (N % 8 ==
// 0), in one launch: K1's LN1 + qkv and LN2 + fc1 + GELU (the TPU kernel
// skyrim_tpu/ops/fused_block.py _fused_block_kernel normalises inside the
// block, lines 109 and 157), where a LayerNorm rows launch wrote h to device
// memory for the aligned row GEMM to read back.  Epi::pair(v) turns the
// f32 sums (bias + products) of two consecutive columns into the values
// stored.
//
// One persistent block an SM takes a contiguous run of the tiles (row
// block, N tile) in row order, the blocks' runs differing by one tile at
// most (an even last wave).  A row block is BM rows x the whole K, a tile
// BM x BN.
// - LayerNorm warps (warps 0-2 of the last warpgroup, setmaxnreg
//   PRO_REGS): scale and shift into shared memory once; then for each row
//   block of the run, lane 0 of warp 0 brings the raw rows by TMA (boxes of
//   64 columns in the 128-byte swizzle, 0 past M and K) into one of the A
//   buffers once the consumers are past their products on it (a_empty,
//   x_full); the three warps then normalise the block in place, four rows a
//   warp at a time, eight lanes a row (f32 statistics, fast variance clipped
//   at 0, f32 affine, bf16 h), fence their stores for the async proxy and
//   arrive on a_full.  So the LayerNorm runs once a row, not once per N
//   tile, and the next row block's under this one's products (two A
//   buffers up to K 512 at 64 rows, up to K 256 at 128).
// - W thread (lane 0 of warp 3): the run's W slices (64 K x BN, boxes of 64
//   columns) by TMA into a ring (w_full / w_empty), tile by tile, as deep as
//   shared memory allows; rows past K and columns past N read as 0.
// - NC consumer warpgroups (setmaxnreg CON_REGS) take the run's tiles in
//   turn, tile q by consumer q % NC: wgmma on the tile's rows of the A block
//   and the W slices, the products ordered by named barriers 1 .. NC (a
//   consumer waits for tile q - 1's products and signals tile q + 1's), so
//   that one consumer's epilogue runs under the other's products.
//   The accumulators start from the tile's bias.  Epilogue: each
//   accumulator pair through Epi::pair, into the staging tile as one
//   bf16x2 word (the 128-byte swizzle: a warp's 32 words in 32 banks, no
//   exchange between lanes, unlike rowgemm_tma_kernel's), then stored by
//   TMA (store_tile; rows past M and columns past N clipped).  A
//   consumer's warps arrive on a_empty once past their last products of a
//   row block.
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W; PERF.md, tools/
// kernel_variants.py lngemm): not the products (with them left out the
// four instances keep 72-102 % of their time) but what feeds and drains
// them: the LayerNorm warps at stage 1, the GELU epilogue of fc1, the W
// ring's depth at K 384 (W streams from L2 once per 64-row block, 2.5 GB
// for stage-2 fc1).  Sharing W slices between two blocks of a cluster by
// TMA multicast halved that stream and gained nothing.
namespace lng {
// The layouts kept: A blocks and tiles of BM rows, tiles BN wide, NC
// consumers.  Rows of K <= 256 take the tall one (two 128-row A buffers and
// six W slices fit: W streams from L2 once per 128 rows), wider rows the
// other (PERF.md §6, the variants of ln_gemm_kernel).
constexpr int TALL_BM = 128, TALL_BN = 64, BM = 64, BN = 128, NC = 2;
constexpr int MAX_K = 512, MAX_STAGES = 8, NA = 2, LN_WARPS = 3, PRO_REGS = 56;  // NA: A buffers

template <int BM_, int BN_, int NC_>
struct Layout {
  static constexpr int THREADS = (NC_ + 1) * 128;
  static constexpr int LAUNCH_REGS = (65536 / THREADS) / 8 * 8 > 248 ? 248 : (65536 / THREADS) / 8 * 8;
  static constexpr int CON_FREE = ((THREADS * LAUNCH_REGS - 128 * PRO_REGS) / (NC_ * 128)) / 8 * 8;
  static constexpr int CON_REGS = CON_FREE > 240 ? 240 : CON_FREE;
  static constexpr int W_BYTES = BK * BN_ * 2;     // a W slice, 64 K x BN
  static constexpr int OUT_BYTES = BM_ * BN_ * 2;  // a consumer's staging tile
  // alignment, staging tiles, A barriers, the LayerNorm's scale and shift
  static constexpr int FIXED = 1024 + NC_ * OUT_BYTES + 3 * NA * 8 + 16 + 2 * MAX_K * 4;
  static constexpr int SMEM = 232448;
  static_assert(BM_ == 64 || BM_ == 128, "whole wgmma rows");
  static_assert(BN_ % 64 == 0 && BN_ <= 256, "whole boxes, a wgmma width");
  int a_bytes, stages;  // an A buffer's bytes, W slices in the ring (the launch needs 3)
  __host__ __device__ explicit Layout(int K) {
    a_bytes = BM_ * 128 * ((K + BK - 1) / BK);
    const int s = (SMEM - FIXED - NA * a_bytes) / (W_BYTES + 16);
    stages = s < MAX_STAGES ? s : MAX_STAGES;
  }
};

}  // namespace lng

template <int BM, int BN, int NC, class Epi>
__global__ void __launch_bounds__(lng::Layout<BM, BN, NC>::THREADS, 1)
    ln_gemm_kernel(__grid_constant__ const CUtensorMap mapX, __grid_constant__ const CUtensorMap mapW,
                   __grid_constant__ const CUtensorMap mapOut, const float* __restrict__ scale,
                   const float* __restrict__ shift, Epi epi, int M, int N, int K, float eps,
                   long long tiles) {
  using Lay = lng::Layout<BM, BN, NC>;
  const Lay lay(K);
  constexpr int NA = lng::NA;
  const int S = lay.stages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* abuf = align1024(smem_raw);  // the A buffers, the staging tiles, the W ring
  unsigned char* staging = abuf + NA * lay.a_bytes;
  unsigned char* wring = staging + NC * Lay::OUT_BYTES;
  const unsigned w_full0 = smem_addr(wring + S * Lay::W_BYTES), w_empty0 = w_full0 + 8 * S;
  const unsigned x_full0 = w_empty0 + 8 * S, a_full0 = x_full0 + 8 * NA, a_empty0 = a_full0 + 8 * NA;
  // the LayerNorm's scale, then its shift, in f32
  float* gb = reinterpret_cast<float*>(wring + S * Lay::W_BYTES + ((16 * S + 24 * NA + 15) & ~15));
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(w_full0 + 8 * s, 1);
      mbar_init(w_empty0 + 8 * s, 4);  // the four warps of the consumer that multiplied
    }
    for (int b = 0; b < NA; ++b) {
      mbar_init(x_full0 + 8 * b, 1);
      mbar_init(a_full0 + 8 * b, lng::LN_WARPS * 32);
      mbar_init(a_empty0 + 8 * b, 4 * NC);  // every consumer warp, once a row block
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int NT = (N + BN - 1) / BN, nk = (K + BK - 1) / BK;
  // this block's run of tiles [t0, t1) (not empty: the grid is at most the
  // tile count), row blocks rb0 .. rb1
  const long long t0 = tiles * blockIdx.x / gridDim.x, t1 = tiles * (blockIdx.x + 1) / gridDim.x;
  const int rb0 = (int)(t0 / NT), rb1 = (int)((t1 - 1) / NT);
  if (wg == NC) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(lng::PRO_REGS));
    const int warp = (tid >> 5) & 3;
    if (warp == lng::LN_WARPS) {
      if (lane == 0) {  // the W thread
        int stage = 0;
        unsigned phase = 0;
        for (long long t = t0; t < t1; ++t) {
          const int n0 = (int)(t % NT) * BN;
          for (int kt = 0; kt < nk; ++kt) {
            mbar_wait(w_empty0 + 8 * stage, phase ^ 1);  // passes at once the first time round
            const unsigned full = w_full0 + 8 * stage, slot = smem_addr(wring + stage * Lay::W_BYTES);
            mbar_expect_tx(full, Lay::W_BYTES);
#pragma unroll
            for (int j = 0; j < BN / 64; ++j) tma_load_2d(slot + j * (BK / 8) * 1024, &mapW, full, n0 + 64 * j, kt * BK);
            if (++stage == S) stage = 0, phase ^= 1;
          }
        }
      }
    } else {
      // the LayerNorm warps: scale and shift into shared memory once ...
      for (int i = tid - 128 * NC; i < K; i += lng::LN_WARPS * 32) gb[i] = scale[i], gb[lng::MAX_K + i] = shift[i];
      bar_sync(2 * NC + 1, lng::LN_WARPS * 32);
      // ... then a row block at a time, four rows a warp at a time, eight
      // lanes a row: lane s of a row's eight takes its 16-byte chunks s, s + 8, ...
      const int sub = lane & 7, nv = K / 8;
      for (int rb = rb0, p = 0; rb <= rb1; ++rb, ++p) {
        const int b = p % NA, use = p / NA;
        unsigned char* a = abuf + b * lay.a_bytes;
        if (warp == 0 && lane == 0) {  // the raw rows by TMA, once the buffer is free
          mbar_wait(a_empty0 + 8 * b, (use & 1) ^ 1);  // passes at once on the first use
          mbar_expect_tx(x_full0 + 8 * b, nk * BM * 128);
          for (int s = 0; s < nk; ++s)
            tma_load_2d(smem_addr(a) + s * (BM * 128), &mapX, x_full0 + 8 * b, 64 * s, rb * BM);
        }
        mbar_wait(x_full0 + 8 * b, use & 1);
        for (int r = 4 * warp + (lane >> 3); r < BM; r += 4 * lng::LN_WARPS) {
          const auto chunk = [&](int v) {  // 16-byte chunk v of row r: slice v / 8, the 128-byte swizzle
            return reinterpret_cast<bf16*>(a + (v >> 3) * (BM * 128) + r * 128 + (((v & 7) ^ (r & 7)) << 4));
          };
          float s = 0.f, s2 = 0.f;
#pragma unroll 2
          for (int v = sub; v < nv; v += 8) {
            float f[8];
            load8(chunk(v), f);
#pragma unroll
            for (int u = 0; u < 8; ++u) s += f[u], s2 += f[u] * f[u];
          }
#pragma unroll
          for (int o = 4; o > 0; o >>= 1) {  // over the row's eight lanes
            s += __shfl_xor_sync(0xffffffffu, s, o);
            s2 += __shfl_xor_sync(0xffffffffu, s2, o);
          }
          const float mu = s / K, inv = rsqrtf(fmaxf(s2 / K - mu * mu, 0.f) + eps);
#pragma unroll 2
          for (int v = sub; v < nv; v += 8) {
            float f[8], g[8], t[8];
            load8(chunk(v), f);
            const float4* gv = reinterpret_cast<const float4*>(gb + 8 * v);
            const float4* tv = reinterpret_cast<const float4*>(gb + lng::MAX_K + 8 * v);
            *reinterpret_cast<float4*>(g) = gv[0], *reinterpret_cast<float4*>(g + 4) = gv[1];
            *reinterpret_cast<float4*>(t) = tv[0], *reinterpret_cast<float4*>(t + 4) = tv[1];
#pragma unroll
            for (int u = 0; u < 8; ++u) f[u] = (f[u] - mu) * inv * g[u] + t[u];
            store8(chunk(v), f);
          }
        }
        fence_async_shared();
        mbar_arrive(a_full0 + 8 * b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Lay::CON_REGS));
    constexpr unsigned B_N_STRIDE = (BK / 8) * 1024, B_K_STRIDE = 1024;
    const int me = wg, w = (tid >> 5) & 3, g = lane >> 2, q = lane & 3;
    const bool elected = (tid & 127) == 0;
    unsigned char* out_tile = staging + me * Lay::OUT_BYTES;
    for (int rb = rb0, p = 0; rb <= rb1; ++rb, ++p) {
      const int b = p % NA;
      const unsigned a0 = smem_addr(abuf + b * lay.a_bytes);
      const long long base = (long long)rb * NT;  // the row block's first tile
      const int jlo = (int)((t0 > base ? t0 : base) - base), jhi = (int)((t1 < base + NT ? t1 : base + NT) - base);
      const int q_lo = (int)(base + jlo - t0);  // the run's position of tile jlo
      mbar_wait(a_full0 + 8 * b, (p / NA) & 1);
      int j = jlo + ((me - q_lo % NC) % NC + NC) % NC;  // this consumer's first tile: position % NC == me
      if (j >= jhi && lane == 0) mbar_arrive(a_empty0 + 8 * b);  // none in this row block
      for (; j < jhi; j += NC) {
        const int qt = q_lo + j - jlo, m0 = rb * BM, n0 = j * BN;
        int stage = (qt * nk) % S;  // the W thread's slice qt * nk of the run
        unsigned phase = ((qt * nk) / S) & 1;
        // the products accumulate onto the bias: acc[h][4i + 2e + c] is row
        // 64h + 16w + g + 8e, column 8i + 2q + c (0 past N)
        float acc[BM / 64][BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const int col = n0 + 8 * i + 2 * q;
          const float2 b = col < N ? __ldg(reinterpret_cast<const float2*>(epi.bias + col)) : make_float2(0.f, 0.f);
#pragma unroll
          for (int h = 0; h < BM / 64; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) acc[h][4 * i + 2 * e] = b.x, acc[h][4 * i + 2 * e + 1] = b.y;
        }
        if (qt > 0) bar_sync(1 + me, 256);  // tile qt - 1's products are done
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(w_full0 + 8 * stage, phase);
          const unsigned b0 = smem_addr(wring + stage * Lay::W_BYTES);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
            for (int h = 0; h < BM / 64; ++h)  // A slice kt, rows 64h.., 32 bytes a step
              wgmma_bf16<BN>(acc[h], wgmma_desc(a0 + kt * (BM * 128) + h * 64 * 128 + ks * 32, 16, 1024),
                             wgmma_desc(b0 + ks * 2 * B_K_STRIDE, B_N_STRIDE, B_K_STRIDE));
          wgmma_commit();
          wgmma_wait<1>();  // the previous slice's products are done: its slot goes back
          if (kt > 0 && lane == 0) mbar_arrive(w_empty0 + 8 * (stage == 0 ? S - 1 : stage - 1));
          if (++stage == S) stage = 0, phase ^= 1;
        }
        wgmma_wait<0>();
        if (lane == 0) {
          mbar_arrive(w_empty0 + 8 * (stage == 0 ? S - 1 : stage - 1));
          if (j + NC >= jhi) mbar_arrive(a_empty0 + 8 * b);  // past its last products on this A block
        }
        if (t0 + qt + 1 < t1) bar_arrive(1 + (me + 1) % NC, 256);  // tile qt + 1 may multiply
        bar_sync(1 + NC + me, 128);  // the last store has read the staging tile
        // one bf16x2 word a pair, at 4q in chunk i % 8 of box i / 8
#pragma unroll
        for (int h = 0; h < BM / 64; ++h)
#pragma unroll
          for (int i = 0; i < BN / 8; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int r = 64 * h + 16 * w + g + 8 * e;
              const float2 v = epi.pair(make_float2(acc[h][4 * i + 2 * e], acc[h][4 * i + 2 * e + 1]));
              *reinterpret_cast<unsigned*>(out_tile + (i >> 3) * (BM * 128) + r * 128 + (((i & 7) ^ (r & 7)) << 4) +
                                           4 * q) = pack_bf16(v.x, v.y);
            }
        fence_async_shared();
        bar_sync(1 + NC + me, 128);
        if (elected) store_tile<BM>(&mapOut, out_tile, min(BN / 64, (N - n0 + 63) / 64), m0, n0);
      }
    }
  }
}

template <int BM, int BN, int NC, class Epi>
static int ln_gemm_attribute() {
  static const int err = static_cast<int>(cudaFuncSetAttribute(
      ln_gemm_kernel<BM, BN, NC, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize, lng::Layout<BM, BN, NC>::SMEM));
  return err;
}

template <int BM, int BN, class Epi>
int launch_ln_gemm_as(const void* x, const float* scale, const float* shift, const void* W, const Epi& epi,
                      int M, int N, int K, float eps, cudaStream_t st) {
  using Lay = lng::Layout<BM, BN, lng::NC>;
  CUtensorMap mapX, mapW, mapOut;
  if (int err = make_tensor_map(&mapX, x, M, K, K, BM)) return err;
  if (int err = make_tensor_map(&mapW, W, K, N, N, BK)) return err;
  if (int err = make_tensor_map(&mapOut, epi.out, M, N, N, BM)) return err;
  if (int err = ln_gemm_attribute<BM, BN, lng::NC, Epi>()) return err;
  const long long tiles = (long long)((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  const unsigned grid = (unsigned)(tiles < sm_count() ? tiles : sm_count());
  ln_gemm_kernel<BM, BN, lng::NC, Epi><<<grid, Lay::THREADS, Lay::SMEM, st>>>(mapX, mapW, mapOut, scale, shift,
                                                                              epi, M, N, K, eps, tiles);
  return static_cast<int>(cudaGetLastError());
}

// Launches ln_gemm_kernel in one of lng's layouts, by K: x (M, K) and W (K,
// N) row-major bf16, epi.out (M, N) bf16, scale and shift f32 (K,); 0 < K <=
// 512, K % 8 == 0, N % 8 == 0, x, W and out 16-byte aligned.
// cudaErrorInvalidValue for other operands (the wrapper raises).
template <class Epi>
int launch_ln_gemm(const void* x, const float* scale, const float* shift, const void* W, const Epi& epi,
                   int M, int N, int K, float eps, void* stream) {
  using namespace lng;
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (M <= 0 || N <= 0 || K <= 0 || K > MAX_K || K % 8 || N % 8 || !aligned(x) || !aligned(W) ||
      !aligned(epi.out) || Layout<BM, BN, NC>(K).stages < 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Layout<TALL_BM, TALL_BN, NC>(K).stages >= 6)
    return launch_ln_gemm_as<TALL_BM, TALL_BN>(x, scale, shift, W, epi, M, N, K, eps, st);
  return launch_ln_gemm_as<BM, BN>(x, scale, shift, W, epi, M, N, K, eps, st);
}

// --- wide_gemm_kernel: long K, both consumers on one tile, LayerNorm in the ring ---
//
// out = epi(A @ W + b), or with LN epi(bf16(LN(x) * scale + shift) @ W + b)
// (flax numerics, as ln_gemm_kernel), for rows of any K % 8 == 0 (LN: K %
// 64 == 0), W (K, N) row-major, N % 8 == 0: K1's four products for rows
// wider than 512 (FengWu's fuser at C 1152, FuXi V1's trunk at C 1536; the
// TPU kernel skyrim_tpu/ops/fused_block.py _fused_block_kernel, its qkv,
// proj, fc1 and fc2 with LN1 and LN2 inside, lines 109 and 157).  There
// rowgemm_tma_kernel gave each consumer its own 128 x 128 tile: 32 KB of
// slices a stage for 2 x 128 x 128 x 64 flops, 64 flops a byte brought from
// L2, which held its products to 436-626 TFLOP/s at K 1152-6144, and the
// LayerNorm rows launch before two of them wrote h to device memory for the
// product to read back.
//
// One persistent block an SM; a tile is 128 rows x BN columns over the whole
// K (BN 256, or 192 where that divides N and 256 does not), a stage one
// 64-deep slice of it: A 128 x 64 (16 KB) and W 64 x BN in gemm_mainloop's
// layouts, 85 flops a byte at BN 256 (79 at 192), a ring of four.
// - TMA thread (lane 0 of warp 3 of the third warpgroup): the walk's slices
//   into the ring by TMA (rows and columns past M, K and N read as 0),
//   completing on land[s]; a slot goes back on empty[s], once every
//   consumer warp is done with it.  The walk: units of `group` consecutive
//   column tiles of one row block, unit blockIdx.x, + gridDim.x, ...;
//   without the LayerNorm one tile a unit, so the blocks at work at once
//   share a few row blocks of A and all of W in L2.
// - Two consumer warpgroups share every stage: consumer c multiplies rows
//   64c .. 64c + 63 by all BN columns (wgmma m64nBNk16, BN / 2 f32
//   accumulators a thread, started from the bias).  Epilogue: each
//   accumulator pair through Epi::pair into one of the consumer's two
//   staging boxes of 64 columns as one bf16x2 word (the 128-byte swizzle: no
//   bank conflict and no exchange between lanes), each box stored by TMA
//   from one thread (rows past M, columns past N clipped) while the next is
//   written and the TMA thread already loads the next tile's slices.  RES:
//   the residual comes by TMA into the staging box first, its first two
//   boxes while the tile's last slice multiplies, and each pair is added to
//   the residual word it overwrites.
// - LN: each unit begins with a statistics pass: its row block's x in
//   stages of 64-column boxes (nss stages), of which each consumer sums x
//   and x^2 of its own 64 rows, eight lanes a row, lane l the chunks l, l +
//   8, ... in order, then a fixed exchange over the eight: each row's
//   statistics are fixed by the row alone, never by the tile or where the
//   rows start.  The (mean, rstd) pairs go to the LayerNorm warps (warps 0-2
//   of the third warpgroup) through shared memory under named barriers 5 and
//   6.  Those normalise each product slice's A box in place once it lands,
//   a half (32 columns, two k-steps) at a time, four lanes a row (f32
//   statistics, fast variance clipped at 0, f32 affine, bf16 h: the product
//   takes bf16(LN(x)), as the chain's LayerNorm launch rounded it), fence
//   each half for the async proxy and hand it over on full[2s + h]; the
//   consumers multiply each half as it comes.  h never leaves shared memory.
// - No split K and no atomics: each output's sum runs over K in one order.
//
// Bound (NVIDIA H100 80GB HBM3, 700 W): operations at these shapes (K and N
// of 1152-6144: 2MKN flops on 2M(K + N) + 2KN bytes).  What holds it below
// them (tools/kernel_variants.py gemm and lngemm; PERF.md §6): the slices'
// feed, about 7.5 TB/s from L2 at 635 TFLOP/s, with a ring of four 48 KB
// slots; the epilogue, under no products; and with LN the LayerNorm warps,
// which take a stage longer than its products (a slice is normalised once
// for each of a row block's column tiles), and the statistics pass, one a
// unit.
namespace wide {
constexpr int BM = 128, CM = 64;        // the block tile's rows; a consumer's
constexpr int A_BYTES = BM * BK * 2;    // a stage's A box
constexpr int BOX_BYTES = CM * 64 * 2;  // a consumer's staging box: 64 rows x 64 columns
constexpr int SLOTS = 4, NTHREADS = 384, MAX_GROUP = 8;
constexpr int LN_WARPS = 3, LN_THREADS = LN_WARPS * 32;                  // the LayerNorm warps
constexpr int LN_ROWS = (BM + 8 * LN_WARPS - 1) / (8 * LN_WARPS);        // rows a LayerNorm lane normalises
// The tile BN columns wide (256, or 192 where N is a multiple of 192 and not
// of 256: FengWu's proj and fc2, N 1152, whose 256-wide tiles would leave a
// tenth of the products on padding columns); a stage is its A box and W slice.
template <int BN>
struct Shape {
  static_assert(BN == 192 || BN == 256, "a wgmma width the accumulators hold");
  static constexpr int W_BYTES = BK * BN * 2, STAGE = A_BYTES + W_BYTES;
  static constexpr int BOXES = STAGE / A_BYTES;  // A boxes of 64 columns a statistics stage holds
  // alignment, the ring, two staging boxes a consumer, the barriers, the
  // rows' (mean, rstd)
  static constexpr size_t SMEM = 1024 + (size_t)SLOTS * STAGE + 4 * BOX_BYTES + 32 * SLOTS + 32 + BM * 8;
  static_assert(SMEM <= 232448, "fits a block");
};
}  // namespace wide

// The 16-byte chunk `sub` of row r of a 64-column box (the 128-byte swizzle).
__device__ __forceinline__ bf16* wide_chunk(unsigned char* box, int r, int sub) {
  return reinterpret_cast<bf16*>(box + r * 128 + ((sub ^ (r & 7)) << 4));
}

template <bool LN, bool RES, int BN, class Epi>
__global__ void __launch_bounds__(wide::NTHREADS, 1)
    wide_gemm_kernel(__grid_constant__ const CUtensorMap mapA, __grid_constant__ const CUtensorMap mapW,
                     __grid_constant__ const CUtensorMap mapOut, __grid_constant__ const CUtensorMap mapRes,
                     const float* __restrict__ scale, const float* __restrict__ shift, float eps, Epi epi, int M,
                     int N, int K, int group) {
  using namespace wide;
  constexpr int S = SLOTS, STAGE = Shape<BN>::STAGE, BOXES = Shape<BN>::BOXES;
  constexpr unsigned B_N_STRIDE = (BK / 8) * 1024, B_K_STRIDE = 1024;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  unsigned char* staging = ring + S * STAGE;
  // land[s]: slot s's bytes landed; full[2s + h] (LN): half h of its A box
  // (columns 32h .. 32h + 31) normalised; empty[s]: every consumer warp is
  // done with it; res_full[2c + b] (RES): a residual box landed in consumer
  // c's staging box b; stats[r] (LN): row r's (mean, rstd) of the unit's row
  // block
  const unsigned land0 = smem_addr(staging + 4 * BOX_BYTES), full0 = land0 + 8 * S, empty0 = full0 + 16 * S;
  const unsigned res_full0 = empty0 + 8 * S;
  float2* stats = reinterpret_cast<float2*>(staging + 4 * BOX_BYTES + 32 * S + 32);
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(land0 + 8 * s, 1);
      mbar_init(full0 + 16 * s, LN_THREADS);
      mbar_init(full0 + 16 * s + 8, LN_THREADS);
      mbar_init(empty0 + 8 * s, 8);  // the consumers' eight warps
    }
    for (int b = 0; b < 4; ++b) mbar_init(res_full0 + 8 * b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int NT = (N + BN - 1) / BN, nk = (K + BK - 1) / BK, nss = LN ? (nk + BOXES - 1) / BOXES : 0;
  const int per_rb = (NT + group - 1) / group, units = (M + BM - 1) / BM * per_rb;
  const auto advance = [](int& stage, unsigned& phase) {
    if (++stage == wide::SLOTS) stage = 0, phase ^= 1;
  };
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(LN ? 72 : 40));
    const int warp = (tid >> 5) & 3;
    int stage = 0;
    unsigned phase = 0;
    if (warp == LN_WARPS) {
      if (lane) return;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int m0 = u / per_rb * BM, j0 = u % per_rb * group, j1 = min(j0 + group, NT);
        for (int ss = 0; ss < nss; ++ss, advance(stage, phase)) {  // the statistics pass
          mbar_wait(empty0 + 8 * stage, phase ^ 1);  // passes at once the first time round
          const int boxes = min(BOXES, nk - BOXES * ss);
          const unsigned land = land0 + 8 * stage, slot = smem_addr(ring + stage * STAGE);
          mbar_expect_tx(land, boxes * A_BYTES);
          for (int b = 0; b < boxes; ++b) tma_load_2d(slot + b * A_BYTES, &mapA, land, BK * (BOXES * ss + b), m0);
        }
        for (int j = j0; j < j1; ++j)
          for (int kt = 0; kt < nk; ++kt, advance(stage, phase)) {
            mbar_wait(empty0 + 8 * stage, phase ^ 1);
            const unsigned land = land0 + 8 * stage, slot = smem_addr(ring + stage * STAGE);
            mbar_expect_tx(land, STAGE);
            tma_load_2d(slot, &mapA, land, kt * BK, m0);
#pragma unroll
            for (int b = 0; b < BN / 64; ++b)
              tma_load_2d(slot + A_BYTES + b * (BK / 8) * 1024, &mapW, land, j * BN + 64 * b, kt * BK);
          }
      }
    } else if constexpr (LN) {
      // the LayerNorm warps: rows r0 + 24 i of the block, four lanes a row,
      // lane sub taking the 16-byte chunks sub and sub + 4 of every 64-column
      // box: the first half of a slice (k-steps 0, 1) is normalised and handed
      // over (full[2s]) before the second (full[2s + 1]).  A quarter warp
      // takes rows r and r + 4, whose halves lie in opposite banks.
      const int sub = lane & 3, r0 = 8 * warp + (lane >> 3) + 4 * ((lane >> 2) & 1);
      bar_arrive(6, 256 + LN_THREADS);  // no statistics to read yet
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int j0 = u % per_rb * group, j1 = min(j0 + group, NT);
        // the consumers' statistics pass is done (every statistics stage has
        // landed): (rstd, -mean * rstd) into registers, then the stages skipped
        bar_sync(5, 256 + LN_THREADS);
        float2 st[LN_ROWS];
#pragma unroll
        for (int i = 0; i < LN_ROWS; ++i) {
          const float2 v = r0 + 24 * i < BM ? stats[r0 + 24 * i] : make_float2(0.f, 0.f);
          st[i] = make_float2(v.y, -v.x * v.y);
        }
        if (u + gridDim.x < units) bar_arrive(6, 256 + LN_THREADS);  // the next unit's may be written
        for (int ss = 0; ss < nss; ++ss) advance(stage, phase);
        for (int j = j0; j < j1; ++j)
          for (int kt = 0; kt < nk; ++kt, advance(stage, phase)) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int c = sub + 4 * h, k = kt * BK + 8 * c;
              float gm[8], bt[8];
              *reinterpret_cast<float4*>(gm) = __ldg(reinterpret_cast<const float4*>(scale + k));
              *reinterpret_cast<float4*>(gm + 4) = __ldg(reinterpret_cast<const float4*>(scale + k + 4));
              *reinterpret_cast<float4*>(bt) = __ldg(reinterpret_cast<const float4*>(shift + k));
              *reinterpret_cast<float4*>(bt + 4) = __ldg(reinterpret_cast<const float4*>(shift + k + 4));
              if (h == 0) mbar_wait(land0 + 8 * stage, phase);
              uint4 x[LN_ROWS];  // every row's chunk in flight at once, then normalised and stored
#pragma unroll
              for (int i = 0; i < LN_ROWS; ++i)
                if (r0 + 24 * i < BM) x[i] = *reinterpret_cast<const uint4*>(wide_chunk(ring + stage * STAGE, r0 + 24 * i, c));
#pragma unroll
              for (int i = 0; i < LN_ROWS; ++i)
                if (r0 + 24 * i < BM) {
                  unsigned* xw = reinterpret_cast<unsigned*>(&x[i]);
#pragma unroll
                  for (int v = 0; v < 4; ++v) {  // (x - mean) * rstd as one fma, then the affine
                    const float lo = fmaf(__uint_as_float(xw[v] << 16), st[i].x, st[i].y);
                    const float hi = fmaf(__uint_as_float(xw[v] & 0xFFFF0000u), st[i].x, st[i].y);
                    xw[v] = pack_bf16(fmaf(lo, gm[2 * v], bt[2 * v]), fmaf(hi, gm[2 * v + 1], bt[2 * v + 1]));
                  }
                  *reinterpret_cast<uint4*>(wide_chunk(ring + stage * STAGE, r0 + 24 * i, c)) = x[i];
                }
              fence_async_shared();  // h made visible to wgmma
              mbar_arrive(full0 + 8 * (2 * stage + h));
            }
          }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(LN ? 216 : 232));
    const int me = wg, w = (tid >> 5) & 3, g = lane >> 2, q = lane & 3, t = tid & 127;
    const bool elected = t == 0;
    unsigned char* boxes_me = staging + me * 2 * BOX_BYTES;
    const unsigned res_me = res_full0 + 16 * me;
    const auto release = [&](int st) {  // the slot before st goes back to the TMA thread
      if (lane == 0) mbar_arrive(empty0 + 8 * (st == 0 ? S - 1 : st - 1));
    };
    // RES: the residual's box bx of the tile at (m0, n0) by TMA into staging
    // box bx % 2, landing on res_full
    const auto load_residual = [&](int bx, int m0, int n0) {
      mbar_expect_tx(res_me + 8 * (bx & 1), BOX_BYTES);
      tma_load_2d(smem_addr(boxes_me + (bx & 1) * BOX_BYTES), &mapRes, res_me + 8 * (bx & 1), n0 + 64 * bx,
                  m0 + CM * me);
    };
    unsigned res_phase = 0;   // RES: bit b, the parity of res_full[b]'s next completion
    unsigned full_phase = 0;  // LN: bit s, the parity of full[s]'s next completion (product slices only)
    int stage = 0;
    unsigned phase = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int m0 = u / per_rb * BM, j0 = u % per_rb * group, j1 = min(j0 + group, NT);
      if constexpr (LN) {  // the statistics pass over this consumer's rows, 64 me + (t >> 3) + 16 i
        const int sub = t & 7, lr0 = CM * me + (t >> 3);
        float s[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
        for (int ss = 0; ss < nss; ++ss, advance(stage, phase)) {
          mbar_wait(land0 + 8 * stage, phase);
          const int boxes = min(BOXES, nk - BOXES * ss);
          for (int b = 0; b < boxes; ++b)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float f[8];
              load8(wide_chunk(ring + stage * STAGE + b * A_BYTES, lr0 + 16 * i, sub), f);
#pragma unroll
              for (int v = 0; v < 8; ++v) s[i] += f[v], s2[i] += f[v] * f[v];
            }
          fence_async_shared();  // these reads before the TMA unit's next writes
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * stage);
        }
        bar_sync(6, 256 + LN_THREADS);  // the LayerNorm warps have read the last unit's statistics
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int o = 4; o > 0; o >>= 1) {  // over the row's eight lanes
            s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
            s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], o);
          }
          const float mu = s[i] / K;
          if (sub == 0) stats[lr0 + 16 * i] = make_float2(mu, rsqrtf(fmaxf(s2[i] / K - mu * mu, 0.f) + eps));
        }
        bar_arrive(5, 256 + LN_THREADS);  // ... and may read these
      }
      for (int j = j0; j < j1; ++j) {
        const int n0 = j * BN, nb = min(BN / 64, (N - n0 + 63) / 64);  // the tile's boxes that hold columns < N
        // the products accumulate onto the bias: acc[4i + 2e + c] is row
        // 16w + g + 8e, column 8i + 2q + c of the consumer's 64 x 256
        float acc[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const int col = n0 + 8 * i + 2 * q;
          const float2 b = col < N ? __ldg(reinterpret_cast<const float2*>(epi.bias + col)) : make_float2(0.f, 0.f);
#pragma unroll
          for (int e = 0; e < 2; ++e) acc[4 * i + 2 * e] = b.x, acc[4 * i + 2 * e + 1] = b.y;
        }
        for (int kt = 0; kt < nk; ++kt) {
          if constexpr (!LN) mbar_wait(land0 + 8 * stage, phase);
          const unsigned a0 = smem_addr(ring + stage * STAGE) + me * CM * 128, b0 = a0 - me * CM * 128 + A_BYTES;
#pragma unroll
          for (int ks = 0; ks < BK / 16; ++ks) {
            if constexpr (LN) {  // each half of the slice once it is normalised
              if (ks % 2 == 0) mbar_wait(full0 + 8 * (2 * stage + ks / 2), (full_phase >> stage) & 1);
            }
            if (ks == 0) wgmma_fence();
            wgmma_bf16<BN>(acc, wgmma_desc(a0 + ks * 32, 16, 1024),
                           wgmma_desc(b0 + ks * 2 * B_K_STRIDE, B_N_STRIDE, B_K_STRIDE));
          }
          if constexpr (LN) full_phase ^= 1u << stage;
          wgmma_commit();
          wgmma_wait<1>();  // the previous slice's products are done: its slot goes back
          if (kt > 0) release(stage);
          if constexpr (RES) {
            if (kt == nk - 1 && elected) {  // the residual's first boxes, once the last tile's stores read theirs
              bulk_wait_read<0>();
              for (int bx = 0; bx < min(nb, 2); ++bx) load_residual(bx, m0, n0);
            }
          }
          advance(stage, phase);
        }
        wgmma_wait<0>();
        release(stage);
        // epilogue, a box of 64 columns at a time, into the consumer's two
        // staging boxes in turn: one bf16x2 word a pair, at 4q in chunk i % 8
        // (RES: added to the residual's word there)
#pragma unroll
        for (int bx = 0; bx < BN / 64; ++bx) {
          if (bx >= nb) break;
          unsigned char* box = boxes_me + (bx & 1) * BOX_BYTES;
          if constexpr (RES) {
            mbar_wait(res_me + 8 * (bx & 1), (res_phase >> (bx & 1)) & 1);
            res_phase ^= 1u << (bx & 1);
          } else if (elected) {  // the store that last read this box is done with it
            if (bx == 0) bulk_wait_read<0>();
            else if (bx >= 2) bulk_wait_read<1>();
          }
          bar_sync(1 + me, 128);
#pragma unroll
          for (int ii = 0; ii < 8; ++ii)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 8 * bx + ii, r = 16 * w + g + 8 * e;
              unsigned* word = reinterpret_cast<unsigned*>(box + r * 128 + ((ii ^ (r & 7)) << 4) + 4 * q);
              const float2 v = make_float2(acc[4 * i + 2 * e], acc[4 * i + 2 * e + 1]);
              float2 y;
              if constexpr (RES) y = epi.pair(v, unpack_bf16(*word));
              else y = epi.pair(v);
              *word = pack_bf16(y.x, y.y);
            }
          fence_async_shared();  // made visible to the TMA unit, then stored by one thread
          bar_sync(1 + me, 128);
          if (elected) {
            tma_store_2d(&mapOut, smem_addr(box), n0 + 64 * bx, m0 + CM * me);  // rows past M clipped
            bulk_commit();
            if constexpr (RES) {  // the box two on, into this staging box once the store has read it
              if (bx + 2 < nb) {
                bulk_wait_read<0>();
                load_residual(bx + 2, m0, n0);
              }
            }
          }
        }
      }
    }
    if (elected) bulk_wait_read<0>();  // the last stores have read their boxes
  }
}

template <bool LN, bool RES, int BN, class Epi>
static int wide_attribute() {
  static const int err = static_cast<int>(cudaFuncSetAttribute(
      wide_gemm_kernel<LN, RES, BN, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wide::Shape<BN>::SMEM));
  return err;
}

// The column tiles a unit of wide_gemm_kernel's walk takes.  With the
// LayerNorm every unit begins with a statistics pass over its row block: a
// longer run of one row block's tiles pays fewer passes, but the last wave of
// units is coarser and more row blocks are at work at once (their x in L2).
// The walk's length in stage times, ceil(units / grid) * (G tiles of nk
// slices and an epilogue of about two, then the pass's nss stages), is least
// at the G returned (up to MAX_GROUP; one tile a unit without a pass).
inline int wide_group(int row_blocks, int NT, int nk, int nss, int grid) {
  if (nss == 0) return 1;
  int best_g = 1;
  long long best = 0;
  for (int G = 1; G <= NT && G <= wide::MAX_GROUP; ++G) {
    const long long units = (long long)row_blocks * ((NT + G - 1) / G);
    const long long t = (units + grid - 1) / grid * ((long long)G * (nk + 2) + nss);
    if (G == 1 || t < best) best = t, best_g = G;
  }
  return best_g;
}

template <bool LN, bool RES, int BN, class Epi>
int launch_wide_as(const void* A, const float* scale, const float* shift, const void* W, const Epi& epi, int M, int N,
                   int K, float eps, int group, cudaStream_t st) {
  using namespace wide;
  CUtensorMap mapA, mapW, mapOut, mapRes;
  if (int err = make_tensor_map(&mapA, A, M, K, K, BM)) return err;
  if (int err = make_tensor_map(&mapW, W, K, N, N, BK)) return err;
  if (int err = make_tensor_map(&mapOut, epi.out, M, N, N, CM)) return err;
  mapRes = mapOut;
  if (RES)
    if (int err = make_tensor_map(&mapRes, epi.residual(), M, N, N, CM)) return err;
  const int NT = (N + BN - 1) / BN, nk = (K + BK - 1) / BK, row_blocks = (M + BM - 1) / BM;
  if (!group) group = wide_group(row_blocks, NT, nk, LN ? (nk + Shape<BN>::BOXES - 1) / Shape<BN>::BOXES : 0, sm_count());
  const long long units = (long long)row_blocks * ((NT + group - 1) / group);
  if (units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = (unsigned)(units < sm_count() ? units : sm_count());
  if (int err = wide_attribute<LN, RES, BN, Epi>()) return err;
  wide_gemm_kernel<LN, RES, BN, Epi><<<grid, NTHREADS, Shape<BN>::SMEM, st>>>(mapA, mapW, mapOut, mapRes, scale, shift,
                                                                              eps, epi, M, N, K, group);
  return static_cast<int>(cudaGetLastError());
}

// Launches wide_gemm_kernel: A (M, K) and W (K, N) row-major bf16, epi.out
// (and epi.residual()) (M, N) bf16, all 16-byte aligned, K % 8 == 0, N % 8
// == 0; with scale and shift (K,) f32, 16-byte aligned, the LayerNorm of A's
// rows first (K % 64 == 0, no residual).  Tiles 256 wide, or 192 where that
// divides N and 256 does not (not with the LayerNorm, whose work a tile
// grows with the tile's share of N).  group: column tiles a unit, 0 for
// wide_group's.  cudaErrorInvalidValue for other operands (the wrapper
// raises).
template <class Epi>
int launch_wide_gemm(const void* A, const float* scale, const float* shift, const void* W, const Epi& epi, int M,
                     int N, int K, float eps, int group, void* stream) {
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool ln = scale != nullptr, res = epi.residual() != nullptr;
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 || N % 8 || group < 0 || !aligned(A) || !aligned(W) ||
      !aligned(epi.out) || !aligned(epi.residual()) || (ln && (K % BK || !aligned(scale) || !aligned(shift) || res)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool narrow = !ln && N % 256 && N % 192 == 0;
  if (ln) return launch_wide_as<true, false, 256>(A, scale, shift, W, epi, M, N, K, eps, group, st);
  if (res && narrow) return launch_wide_as<false, true, 192>(A, scale, shift, W, epi, M, N, K, eps, group, st);
  if (res) return launch_wide_as<false, true, 256>(A, scale, shift, W, epi, M, N, K, eps, group, st);
  if (narrow) return launch_wide_as<false, false, 192>(A, scale, shift, W, epi, M, N, K, eps, group, st);
  return launch_wide_as<false, false, 256>(A, scale, shift, W, epi, M, N, K, eps, group, st);
}

}  // namespace rowgemm
