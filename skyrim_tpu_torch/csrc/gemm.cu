// bf16 GEMM with a fused epilogue: C = epi(A @ B + bias).
//
// The matrix products inside the TPU kernels K1 (skyrim_tpu/ops/fused_block.py
// _fused_block_kernel: qkv, proj, both MLP layers), K3 (ops/resample.py
// _down_kernel) and K4 (_up_kernel) run here, on rowgemm.cuh's
// rowgemm_tma_kernel: wgmma.mma_async fed by TMA, one persistent block an SM,
// two consumer warpgroups taking whole tiles in turn (128 x 128, or 64 x 192
// for N 192 and 576) and storing their epilogues by TMA; the residual comes
// by TMA into the staging tile.  A is (M, K) row-major bf16, B is the Dense
// kernel (K, N) row-major bf16 (flax layout, x @ W), bias is f32 (N,),
// accumulation is f32 on the tensor cores.
//
// Epilogues, in f32 before the single bf16 store:
//   0: acc + bias
//   1: gelu_tanh(bf16(acc + bias))           (flax nn.gelu on the compute dtype)
//   2: bf16(acc + bias) + residual            (the block's residual adds)
//
// Bound on this card: an (M,K)@(K,N) product with M >> K,N does 2MKN flops on
// 2M(K+N) bytes of activations, K*N/(K+N) flops per byte: 96 to 307 at Pangu's
// widths, around the H100's ridge of ~295, so the narrow products lean on
// bandwidth and the wide ones on the tensor cores.  Measured on an NVIDIA H100
// 80GB HBM3 at 700 W: 150-540 TFLOP/s over Pangu's eight block products, the
// residual ones 1.3-1.7x their byte bound and the GELU ones (fc1) the
// slowest, their epilogue longer than the short (K 192, 384) products it
// should hide under (PERF.md).  N % 8 == 0 and K % 8 == 0 (16-byte rows);
// ragged M, N and K tile edges are zero-filled on load and masked on store.
#include "rowgemm.cuh"

namespace {

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  float t;  // tanh.approx: relative error 2^-11, below the bf16 rounding of the result
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(t) : "f"(k * (x + 0.044715f * x * x * x)));
  return 0.5f * x * (1.f + t);
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
