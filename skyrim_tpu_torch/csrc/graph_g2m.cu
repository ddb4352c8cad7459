// K9: GraphCast's grid->mesh encoder messages, grid-major over spatial tiles.
//
// Replaces skyrim_tpu/ops/graph_kernels.py fused_g2m_tiled (Pallas body
// _g2m_tiled_kernel).  Per tile t = (ti, tj) of th x tw grid points, slot
// k < D and tile point r:
//   m = LN(bf16(bf16(swish(asrc[p] + bias[p, k] + b0)) @ W + b))
//   out[ti, tj, local[ti, tj, k, r]] += m   (f32; local == U: empty slot)
// written as (TH, TW, U, L) bf16 tile partials; the cross-tile combine stays
// outside.  The TPU kernel aggregates with a one-hot matmul per slot over
// every slot, empty or not.  Here only the E filled slots are computed, in
// the order of a static row plan (ops/graph.py g2m_row_plan): rows[q] = p * D
// + k, sorted by tile, then by tile-local destination u, then by (k, r), and
// csr[g * U + u] the first row of destination (g, u).  Two launches:
//   skt_g2m_messages  rowgemm.cuh's rows_ln_kernel: m = the E rows' messages
//                 in one launch, the swish prologue computed once a row by
//                 producer warps into a 64 x 512 A block (bias gathered by
//                 cp.async into it, asrc into registers), the products by
//                 wgmma from shared memory with W brought by TMA, the bias and
//                 the LayerNorm in the epilogue, m stored by TMA
//   skt_csr_sum   one warp a destination sums its rows of m in order in f32
//                 and stores bf16 once: no shared-memory table, no atomics,
//                 the same bits on every run; an empty destination comes out 0.
//
// Bound on this card: operations.  At full width the filled slots (the
// 1,629,780 edges, 52.3 % of the H * W * D = 3,114,720 slots) need
// 2 * E * L^2 = 0.854 TFLOP (0.864 ms at 989 TFLOP/s) on 2.88 GB.  A 64-row
// tile streams all of W (512 KB) from L2, 13.4 GB a forward.
#include "rowgemm.cuh"

namespace {

// Row q < M of the plan: swish(asrc[rows[q] / D] + bias[rows[q]] + b0), the
// prologue of rows_ln_kernel.  index() looks a row up once a tile; copy()
// starts the cp.async copy of its bias chunk at kk (each bias row is read
// once, from device memory) to the A chunk's place in shared memory; load()
// brings its asrc chunk (rows that repeat, often from L2) into registers;
// make() computes the chunk in place (0 past M or L).
struct G2MRows {
  const bf16* asrc;  // (H * W, L)
  const bf16* bias;  // (H * W * D, L)
  const float* b0;   // (L,)
  const int* rows;   // (E,)
  int D;

  struct Raw {
    uint4 a;
    bool ok;
  };
  __device__ __forceinline__ int index(int q, int M) const { return q < M ? rows[q] : -1; }
  __device__ __forceinline__ void copy(int row, int kk, int L, bf16* dst) const {
    const bool ok = row >= 0 && kk < L;
    cp_async16(dst, ok ? bias + (size_t)row * L + kk : bias, ok);
  }
  __device__ __forceinline__ void load(int row, int kk, int L, Raw& r) const {
    r.ok = row >= 0 && kk < L;
    if (r.ok) r.a = *reinterpret_cast<const uint4*>(asrc + (size_t)(row / D) * L + kk);
  }
  __device__ __forceinline__ void make(const Raw& r, int kk, int L, bf16* a) const {
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r.ok) {
      float b8[8], c8[8];
      load8(a, b8);
      load8(reinterpret_cast<const bf16*>(&r.a), f);
      load8f(b0 + kk, 8, c8);
#pragma unroll
      for (int u = 0; u < 8; ++u) f[u] = rowgemm::swish(f[u] + b8[u] + c8[u]);
    }
    store8(a, f);
  }
};

constexpr int CSR_WARPS = 8;

// out[d, :] = bf16(sum of x[csr[d] .. csr[d + 1]) in order, f32), C % 8 == 0.
// A lane owns two 8-column chunks of each 512-column pass; four rows' loads
// are in flight before they are added.
__global__ void __launch_bounds__(CSR_WARPS * 32)
    csr_sum_kernel(const bf16* __restrict__ x, const int* __restrict__ csr, bf16* __restrict__ out,
                   int n, int C) {
  const int d = blockIdx.x * CSR_WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (d >= n) return;
  const int r0 = csr[d], r1 = csr[d + 1], nv = C / 8;
  for (int v0 = 0; v0 < nv; v0 += 64) {
    const int va = v0 + lane, vb = va + 32;
    const bool ha = va < nv, hb = vb < nv;
    float acc[2][8];
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[0][u] = acc[1][u] = 0.f;
    int r = r0;
    for (; r + 4 <= r1; r += 4) {
      uint4 ra[4], rb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bf16* row = x + (size_t)(r + i) * C;
        if (ha) ra[i] = *reinterpret_cast<const uint4*>(row + va * 8);
        if (hb) rb[i] = *reinterpret_cast<const uint4*>(row + vb * 8);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float fa[8], fb[8];
        load8(reinterpret_cast<const bf16*>(&ra[i]), fa);
        load8(reinterpret_cast<const bf16*>(&rb[i]), fb);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          acc[0][u] += fa[u];
          acc[1][u] += fb[u];
        }
      }
    }
    for (; r < r1; ++r) {
      const bf16* row = x + (size_t)r * C;
      float f[8];
      if (ha) {
        load8(row + va * 8, f);
#pragma unroll
        for (int u = 0; u < 8; ++u) acc[0][u] += f[u];
      }
      if (hb) {
        load8(row + vb * 8, f);
#pragma unroll
        for (int u = 0; u < 8; ++u) acc[1][u] += f[u];
      }
    }
    bf16* o = out + (size_t)d * C;
    if (ha) store8(o + va * 8, acc[0]);
    if (hb) store8(o + vb * 8, acc[1]);
  }
}

}  // namespace

extern "C" int skt_g2m_messages(const void* asrc, const void* bias, const void* b0, const void* W,
                                const void* b, const void* ln_scale, const void* ln_bias,
                                const void* rows, void* out, int E, int L, int D, float eps,
                                void* stream) {
  G2MRows pro{static_cast<const bf16*>(asrc), static_cast<const bf16*>(bias),
              static_cast<const float*>(b0), static_cast<const int*>(rows), D};
  rowgemm::EpiLN epi{static_cast<const float*>(b), static_cast<const float*>(ln_scale),
                     static_cast<const float*>(ln_bias), eps};
  return rowgemm::launch_rows_ln<1>(pro, W, epi, out, E, L, stream);
}

extern "C" int skt_csr_sum(const void* x, const void* csr, void* out, int n, int C, void* stream) {
  if (C % 8 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  csr_sum_kernel<<<(n + CSR_WARPS - 1) / CSR_WARPS, CSR_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const int*>(csr), static_cast<bf16*>(out), n, C);
  return static_cast<int>(cudaGetLastError());
}
