// K2: single-pass 3-axis cyclic roll, out[z,h,w,:] = x[(z+s0)%Z, (h+s1)%H, (w+s2)%W, :].
//
// Replaces skyrim_tpu/ops/roll.py roll3d (_roll_kernel), the shifted-window
// frame change around every shifted Pangu block.  Bound on this card: bytes
// (one read and one write of the activation, no arithmetic).  Design: one
// thread per 16-byte chunk of a token's channels, neighbouring threads on
// neighbouring chunks of the same token and then of the next output token, so
// reads and writes are coalesced 16-byte accesses; the source index is the
// output index with the shifts added (shifts pre-reduced to [0, dim)).
#include "common.cuh"

namespace {

__global__ void roll_kernel(const uint4* __restrict__ x, uint4* __restrict__ out, int Z, int H,
                            int W, int CV, int s0, int s1, int s2) {
  const size_t n = (size_t)Z * H * W * CV;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int cv = i % CV;
    size_t t = i / CV;
    const int w = t % W;
    t /= W;
    const int h = t % H;
    const int z = t / H;
    int zs = z + s0, hs = h + s1, ws = w + s2;
    if (zs >= Z) zs -= Z;
    if (hs >= H) hs -= H;
    if (ws >= W) ws -= W;
    out[i] = x[(((size_t)zs * H + hs) * W + ws) * CV + cv];
  }
}

}  // namespace

// row_bytes: bytes of one token's channels, a multiple of 16.
extern "C" int skt_roll(const void* x, void* out, int Z, int H, int W, int row_bytes, int s0,
                        int s1, int s2, void* stream) {
  const int CV = row_bytes / 16;
  const size_t n = (size_t)Z * H * W * CV;
  const int threads = 256;
  const size_t want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  roll_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), Z, H, W, CV, s0, s1, s2);
  return static_cast<int>(cudaGetLastError());
}
