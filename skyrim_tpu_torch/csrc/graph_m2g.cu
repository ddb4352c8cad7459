// K8: GraphCast's mesh->grid decoder messages over the face tiles.
//
// Replaces skyrim_tpu/ops/graph_kernels.py fused_m2g_tiled (Pallas body
// _m2g_tiled_kernel).  Per grid point p = (i, j) and slot k < 3:
//   row_k = uniq[i / th, j / tw, local_hw[i, j], k*L : (k+1)*L]
//   m_k   = bf16(LN(bf16(bf16(swish(row_k + bias[p, k] + ad[p] + b0)) @ W + b)))
//   out[p] = bf16(sum_k m_k)   (f32 sum, in slot order)
// The TPU kernel expands each tile's unique face rows with a one-hot matmul
// and relies on Pallas dropping the out-of-range rows of the partial tiles at
// the grid's edge (721 = 90 * 8 + 1, 1440 = 11 * 128 + 32).  Here the rows
// are the grid's points in order, 3p + k, so partial face tiles need no mask,
// and one launch of rowgemm.cuh's rows_ln_kernel<3> computes them all: a
// tile is 21 points = 63 rows, so each point's three messages meet in one
// block.  The bias rows of a tile are contiguous ((3 H W, L), rows 63t ..
// 63t + 62) and come by TMA straight into the A block; producer warps (12
// points) and, after their epilogue, the consumer warpgroups (the other 9)
// take a point at a time, load its dst row (ad) once and its three face rows
// (by local[p] from its tile's unique table, rows that repeat, from L2) into
// registers, and compute the three rows' swish in place, in the reference's
// order ((row + bias) + ad) + b0.  The products run on wgmma with W by TMA,
// the bias and the LayerNorm in the epilogue, where each consumer sums a
// point's three staged rows in f32 and stores the 21 bf16 sums by TMA.  No
// intermediate of 3 H W rows reaches device memory.
//
// Bound on this card: bytes.  At full width the product is
// 2 * 3 * H * W * L^2 = 1.63 TFLOP (1.65 ms at 989 TFLOP/s) on 5.96 GB of
// tiles, bias, dst rows and output (1.78 ms at 3.35 TB/s).  A tile streams
// all of W (512 KB) from L2: 25.9 GB a forward over 49,440 tiles.  What
// limits it is the prologue's gathers (rowgemm.cuh, rows_ln_kernel): 8.5 ms
// on an H100 (NVIDIA H100 80GB HBM3, 700 W), where the two-launch K8 before
// it took 19.0.
#include "rowgemm.cuh"

namespace {

// Point p < H W of the grid: its three rows' prologue for rows_ln_kernel<3>.
// index() finds the point's face row in its tile's unique table once a
// tile; load() brings the dst row's and the three face rows' chunks at kk
// into registers; make() computes the three chunks in place over the bias
// that TMA brought (0 past H W or L).
struct M2GPoints {
  const bf16* uniq;   // (TH * TW * U, 3L)
  const int* local;   // (H * W,)
  const bf16* bias;   // (3 H W, L): row 3p + k, the first source, by TMA
  const bf16* ad;     // (H W, L)
  const float* b0;    // (L,)
  int W, U, th, tw, TW, HW;

  struct Raw {
    uint4 u[3], a;
    bool ok;
  };
  __host__ __device__ const bf16* rows_by_tma() const { return bias; }
  __device__ __forceinline__ int index(int p) const {
    if (p >= HW) return -1;
    const int i = p / W, j = p - i * W;
    return ((i / th) * TW + j / tw) * U + local[p];
  }
  __device__ __forceinline__ void load(int urow, int p, int kk, int L, Raw& r) const {
    r.ok = urow >= 0 && kk < L;
    if (!r.ok) return;
    const bf16* u = uniq + (size_t)urow * 3 * L + kk;
#pragma unroll
    for (int k = 0; k < 3; ++k) r.u[k] = *reinterpret_cast<const uint4*>(u + k * L);
    r.a = *reinterpret_cast<const uint4*>(ad + (size_t)p * L + kk);
  }
  __device__ __forceinline__ void make(const Raw& r, int kk, int L, bf16* const* rows) const {
    float a8[8], c8[8];
    if (r.ok) {
      load8(reinterpret_cast<const bf16*>(&r.a), a8);
      load8f(b0 + kk, 8, c8);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
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

}  // namespace

extern "C" int skt_m2g_messages(const void* uniq, const void* local, const void* bias, const void* ad,
                                const void* b0, const void* W, const void* b, const void* ln_scale,
                                const void* ln_bias, void* out, int H, int Wd, int L, int U, int th, int tw,
                                int TW, float eps, void* stream) {
  if ((long long)H * Wd * 3 >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (!aligned(uniq) || !aligned(ad)) return static_cast<int>(cudaErrorInvalidValue);
  M2GPoints pro{static_cast<const bf16*>(uniq), static_cast<const int*>(local), static_cast<const bf16*>(bias),
                static_cast<const bf16*>(ad),   static_cast<const float*>(b0),  Wd, U, th, tw, TW, H * Wd};
  rowgemm::EpiLN epi{static_cast<const float*>(b), static_cast<const float*>(ln_scale),
                     static_cast<const float*>(ln_bias), eps};
  return rowgemm::launch_rows_ln<3>(pro, W, epi, out, 3 * H * Wd, L, stream);
}
