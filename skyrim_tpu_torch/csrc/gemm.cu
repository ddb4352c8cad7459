// bf16 GEMM with a fused epilogue: C = epi(A @ B + bias), and the same with
// a LayerNorm of A's rows in its prologue.
//
// The matrix products inside the TPU kernel K1 (skyrim_tpu/ops/fused_block.py
// _fused_block_kernel: qkv, proj, both MLP layers) run here.
//
// skt_gemm_bf16: rowgemm.cuh's rowgemm_tma_kernel: wgmma.mma_async fed by TMA,
// one persistent block an SM, two consumer warpgroups taking whole tiles in
// turn (128 x 128, or 64 x 192 for N 192 and 576) and storing their
// epilogues by TMA; the residual comes by TMA into the staging tile.  K1's
// proj and fc2 at C <= 512 (and all four products on K1's chain, rows wider
// than 512 that are not whole 64-column slices).
//
// skt_wide_gemm_bf16: rowgemm.cuh's wide_gemm_kernel, K1's four products for
// rows wider than 512 (FengWu's C 1152, FuXi V1's C 1536; K 1152-6144), with
// LN1 and LN2 in the prologue of qkv and fc1.  There the products are long
// and bound by the flops, and rowgemm_tma_kernel's separate 128 x 128 tiles
// a consumer fed its tensor cores 64 flops a byte of slices from L2: here
// both consumers share every 128 x 256 tile's slices (85 flops a byte; 128 x
// 192 where that divides N and 256 does not), the epilogue stores
// accumulator pairs straight into staging boxes, and LayerNorm warps apply
// the LayerNorm to each A slice in shared memory from row statistics of a
// first pass, so h never round-trips device memory.
//
// skt_ln_gemm_bf16: rowgemm.cuh's ln_gemm_kernel: epi(bf16(LN(x)) @ B +
// bias) for rows of K <= 512, K1's LN1 + qkv and LN2 + fc1 + GELU, each one
// launch: a row block of x by TMA into shared memory, normalised there once
// by producer warps, then multiplied by every N tile's W slices by two
// consumer warpgroups in turn, each accumulator pair stored through
// EpiGemm::pair.
//
// A is (M, K) row-major bf16, B is the Dense kernel (K, N) row-major bf16
// (flax layout, x @ W), bias is f32 (N,), accumulation is f32 on the tensor
// cores.  Epilogues, in f32 before the single bf16 store:
//   0: acc + bias
//   1: gelu_tanh(bf16(acc + bias))           (flax nn.gelu on the compute dtype)
//   2: bf16(acc + bias) + residual            (the block's residual adds)
//
// Bound on this card: an (M,K)@(K,N) product with M >> K,N does 2MKN flops on
// 2M(K+N) bytes of activations, K*N/(K+N) flops per byte: 96 to 307 at Pangu's
// widths, around the H100's ridge of ~295, so the narrow products lean on
// bandwidth and the wide ones on the tensor cores.  At Pangu's short K (192,
// 384) a tile's products are shorter than a GELU epilogue of one warpgroup;
// the times against torch.matmul's are in PERF.md (NVIDIA H100 80GB HBM3,
// 700 W).  N % 8 == 0 and K % 8 == 0 (16-byte rows); ragged M, N and K tile
// edges are zero-filled on load and masked or clipped on store.
#include "rowgemm.cuh"

namespace {

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  float t;  // tanh.approx: relative error 2^-11, below the bf16 rounding of the result
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(t) : "f"(k * (x + 0.044715f * x * x * x)));
  return 0.5f * x * (1.f + t);
}

// gelu_tanh with the constants folded: 0.5 x (1 + t) as h + h t, the cubic
// as x (k + k 0.044715 x^2) (the pair epilogue of ln_gemm_kernel)
__device__ __forceinline__ float gelu_tanh_fma(float x) {
  float t;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(t) : "f"(x * fmaf(0.7978845608028654f * 0.044715f, x * x, 0.7978845608028654f)));
  const float h = 0.5f * x;
  return fmaf(h, t, h);
}

// bf16_round by integer arithmetic (round to nearest even; the same bits for
// every finite value and infinity): the GELU epilogue is the longest of the
// row GEMM's, and this took 12 % off Pangu's fc1 products on an H100 against
// the conversion instructions (0.91 against 1.09 ms for Pangu's stage-1 fc1,
// NVIDIA H100 80GB HBM3, 700 W).
__device__ __forceinline__ float bf16_round_int(float x) {
  const unsigned u = __float_as_uint(x);
  return __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
}

// N % 8 == 0, so a lane's 8 columns are always whole: 16-byte accesses.
struct EpiGemm {
  const float* bias;
  const bf16* R;
  bf16* out;
  int N, epi;

  __host__ __device__ __forceinline__ const bf16* residual() const { return epi == 2 ? R : nullptr; }
  // two consecutive columns' acc + bias (ln_gemm_kernel; epilogues 0 and 1):
  // both rounded to bf16 by one conversion, GELU in five operations
  __device__ __forceinline__ float2 pair(float2 v) const {
    if (epi == 1) {
      v = __bfloat1622float2(__floats2bfloat162_rn(v.x, v.y));
      v = make_float2(gelu_tanh_fma(v.x), gelu_tanh_fma(v.y));
    }
    return v;
  }
  // the same with the residual epilogue's pair r (wide_gemm_kernel): bf16(acc
  // + bias) + r
  __device__ __forceinline__ float2 pair(float2 v, float2 r) const {
    if (epi == 2) return make_float2(bf16_round_int(v.x) + r.x, bf16_round_int(v.y) + r.y);
    return pair(v);
  }
  __device__ __forceinline__ void apply(int, int, float* v, const float* b, const float* res) const {
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] += b[u];
    if (epi == 1) {
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = gelu_tanh(bf16_round_int(v[u]));
    } else if (epi == 2) {
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = bf16_round(v[u]) + res[u];
    }
  }
};

}  // namespace

extern "C" int skt_gemm_bf16(const void* A, const void* B, const void* bias, const void* R,
                             void* C, int M, int N, int K, int epi, void* stream) {
  rowgemm::ARows<true> a{static_cast<const bf16*>(A), K, 1, K, nullptr, 0, M};
  EpiGemm e{static_cast<const float*>(bias), static_cast<const bf16*>(R), static_cast<bf16*>(C), N,
            epi};
  return rowgemm::launch_rowgemm(a, B, e, M, N, K, stream);
}

// x (M, K) bf16, scale and shift (K,) f32 (the LayerNorm), B (K, N) bf16,
// bias (N,) f32; epilogue 0 or, with gelu, 1.
extern "C" int skt_ln_gemm_bf16(const void* x, const void* scale, const void* shift, const void* B,
                                const void* bias, void* C, int M, int N, int K, int gelu, float eps,
                                void* stream) {
  EpiGemm e{static_cast<const float*>(bias), nullptr, static_cast<bf16*>(C), N, gelu ? 1 : 0};
  return rowgemm::launch_ln_gemm(x, static_cast<const float*>(scale), static_cast<const float*>(shift), B, e, M,
                                 N, K, eps, stream);
}

// The long-K row GEMM (wide_gemm_kernel): epi(A @ B + bias) with epilogue
// 0, 1 or 2 (R the residual), or with scale and shift (K,) f32 epi(bf16(LN(A))
// @ B + bias) with epilogue 0 or 1 (K % 64 == 0).  group: column tiles a unit
// of the walk, 0 for the launch's choice.
extern "C" int skt_wide_gemm_bf16(const void* A, const void* scale, const void* shift, const void* B,
                                  const void* bias, const void* R, void* C, int M, int N, int K, int epi,
                                  float eps, int group, void* stream) {
  EpiGemm e{static_cast<const float*>(bias), static_cast<const bf16*>(R), static_cast<bf16*>(C), N, epi};
  return rowgemm::launch_wide_gemm(A, static_cast<const float*>(scale), static_cast<const float*>(shift), B, e, M,
                                   N, K, eps, group, stream);
}
