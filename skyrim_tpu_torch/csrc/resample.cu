// K3 and K4: Pangu's patch merging (DownSample) and patch expansion
// (UpSample), each one launch of resample_kernel below.
//
// K4, skt_upsample_bf16 (replaces skyrim_tpu/ops/resample.py fused_upsample,
// Pallas body _up_kernel): out[z, 2h + i, 2w + j, :] = bf16(LN(bf16(x[z, h, w]
// @ W[:, g Co : (g + 1) Co] + b_g))) with g = 2i + j, the LayerNorm over the
// group's Co columns, rounded to bf16 before it as the TPU kernel rounds it
// (resample.py:177).
//
// K3, skt_downsample_bf16 (replaces fused_downsample, _down_kernel): the 2x2
// merge v = concat_{ij} x[z, 2h2 + i, 2w2 + j, :] over 4C, LayerNorm over 4C,
// Dense to N, through the TPU kernel's algebraic split (resample.py:10-23):
//   out = inv * (v @ W') - inv * mu * sw + ct,
// W' = bf16(diag(s) W), sw = the f32 column sums of W', ct = b_ln @ W + b,
// all three computed once with the parameters (ops/resample.py
// prepare_downsample), mu and inv the row's f32 statistics over its 4C raw
// values.  So the product runs on raw x as TMA brings it, and only the row's
// sum and sum of squares are needed in the epilogue.  H may be odd: row H
// (the reference's zero pad) comes in as zeros from the maps' out-of-bounds
// fill, and x may be a strided view (the stage's cropped buffer), read in
// place.
//
// Both: 2 MKN = 77 GFLOP on 0.30 GB at Pangu's widths (131,040 rows, 384 <->
// 768 columns): 0.078 ms of products against 0.090 ms of bytes on an H100,
// so neither may write an intermediate to device memory, and the weights
// (590 KB) stay out of the per-tile stream.  Design:
// - Column blocks with their weights resident.  The N columns are cut in
//   blocks of BN (K4: one group, Co <= 192 of 4 Co; K3: 128 of N = 384), and
//   a block's K x BN weights (147,456 bytes for K4, 196,608 for K3) are
//   brought once by TMA into shared memory.  Block b takes column block b %
//   ng and walks the row tiles b / ng, + gridDim.x / ng, ...: the ng blocks
//   of a row tile run it at about the same time, so it comes from device
//   memory once and from L2 ng - 1 times.  K3 takes three blocks of 128
//   rather than four of 96 although its ring then holds four slices, not
//   eight: 0.251 against 0.314 ms (PERF.md, tools/kernel_variants.py
//   resample, NVIDIA H100 80GB HBM3, 700 W).
// - Row tiles follow lines.  A line is the W (K4) or W / 2 (K3) pixels of
//   one (z, h); a tile is tw <= 64 consecutive pixels of a line (Pangu: 60,
//   three a line), the rows of one 64-row wgmma tile, the rest of it zero.
//   Every tile is then one TMA box per 64 channels, in the 128-byte swizzle
//   from a 1024-byte aligned slot:
//   - K4's input: x (Z, H, W, C) by a rank-4 map (C, W, H, Z), any row
//     strides; K4's output: out (Z, 2H, 2W, Co) as the rank-5 map (Co, j, W,
//     i, Z H), box (64, 1, tw, 1, 1) at (c, j, w0, i, line): the 2x2
//     interleave is the map's, not a pass.
//   - K3's input: the parity slab (i, j) of x by a rank-4 map (C, W / 2,
//     ceil((H - i) / 2), Z) with strides (2 sw, 2 sh, sz), four maps.  K
//     slice kt is channels 64 (kt / 4) .. of slab kt % 4: the four slabs'
//     slices of the same channels come one after another (W''s rows in that
//     order, each slab's C padded to Cp, a multiple of 64); in the slabs' own
//     order, three slices of a slab and then the next, the loads alone took
//     0.213 ms against 0.138 (96-column blocks; PERF.md).
// - One producer thread brings the row tiles' K slices (64 rows x 64
//   channels, 8 KB) into a ring; two consumer warpgroups take the tiles in
//   turn, wgmma m64nBNk16 on the slot and the resident weights (K4: W (K, 4
//   Co) MN-major by the transpose bit; K3: W'^T (N, 4 Cp) K-major).  K3's
//   consumers also read each slot's rows for the sums while its products
//   run: lane q of a row's quad loads chunks q and q ^ 4 in an order that
//   keeps a quarter warp's 16-byte loads on eight different chunk slots,
//   sums each chunk apart and adds the two sums, so that a pixel's output
//   does not depend on where the tiles cut its line (a lon-sharded chunk's
//   lines are cut elsewhere than the whole grid's; 0.260-0.275 ms against
//   0.247-0.255 for the order-dependent sums, tools/kernel_variants.py
//   resample, NVIDIA H100 80GB HBM3, 700 W).
// - Epilogue in registers: a row's BN values lie in one quad, so K4's group
//   statistics are two quad shuffles (and K3's row sums too).  K4's bf16
//   results go as one bf16x2 word a pair into one staging tile, shared by the
//   two consumers in walk order (out_free), then one thread stores its boxes
//   by TMA (columns past the matrix and pixels past the line clipped).  K3
//   has no room for a staging tile beside its weights: each lane stores 8
//   consecutive columns of a row from registers (K4 that way: 0.209 against
//   0.186 ms).
#include "rowgemm.cuh"

namespace {

using namespace rowgemm;

enum Mode { UP = 0, DOWN = 1 };

constexpr int BM = 64, SLOT = BM * 128, THREADS = 384;  // a K slice of a row tile: 64 rows x 128 bytes

template <int MODE>
struct Lay {
  static constexpr int BN = MODE == UP ? 192 : 128;      // a column block
  static constexpr int MAX_NK = MODE == UP ? 6 : 12;     // K slices of 64: K <= 384, 4 Cp <= 768
  static constexpr int W_BYTES = MAX_NK * BN * 128;      // the resident weights: 147,456 (K4), 196,608 (K3)
  static constexpr int OUT_BOXES = (BN + 63) / 64;       // K4: boxes of 64 columns a staged tile
  static constexpr int STAGING = MODE == UP ? OUT_BOXES * SLOT : 0;  // K3 stores from registers
  static constexpr int BARS = 256;
  static constexpr int SLOTS = (232448 - 1024 - W_BYTES - STAGING - BARS) / SLOT;  // 7 (K4), 4 (K3)
  static constexpr size_t SMEM = 1024 + (size_t)W_BYTES + STAGING + (size_t)SLOTS * SLOT + BARS;
  static_assert(SLOTS >= 4 && 2 * SLOTS * 8 + 16 <= BARS, "fits a block");
};

struct Maps {
  CUtensorMap a[4];  // K4: a[0], x; K3: the parity slab (i, j) of x at a[2i + j]
};

struct Geo {
  int lines_per_z;  // K4: H; K3: H2 = ceil(H / 2)
  int tw, nseg;     // pixels a row tile (<= 64), tiles a line
  int tiles;        // row tiles: Z * lines_per_z * nseg
  int ng;           // column blocks
  int nk;           // K slices of 64
  int cols;         // K4: Co; K3: N
  int kdiv;         // the LayerNorm's width: K4 Co, K3 4 C
  float eps;
  const float* p0;  // K4: the Dense bias (4 Co); K3: sw (N)
  const float* p1;  // K4: the LayerNorm scale (Co); K3: ct (N)
  const float* p2;  // K4: the LayerNorm shift (Co)
  int wl;           // K3: pixels a line (W / 2)
  bf16* out;        // K3: out (Z H2, W2, N)
};

__device__ __forceinline__ void tma_load_3d(unsigned dst, const CUtensorMap* map, unsigned bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(unsigned dst, const CUtensorMap* map, unsigned bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_5d(const CUtensorMap* map, unsigned src, int c0, int c1, int c2, int c3,
                                             int c4) {
  asm volatile("cp.async.bulk.tensor.5d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5, %6}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
               : "memory");
}

// d (64 x 128, f32) += a (64 x 16, K-major) * b (16 x 128, K-major: W'^T's rows)
__device__ __forceinline__ void wgmma_n128_kmajor(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, 1, 1, 1, 0, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db));
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    resample_kernel(__grid_constant__ const Maps maps, __grid_constant__ const CUtensorMap mapW,
                    __grid_constant__ const CUtensorMap mapOut, const Geo geo) {
  using L = Lay<MODE>;
  constexpr int BN = L::BN, S = L::SLOTS;
  constexpr unsigned B_N_STRIDE = (BK / 8) * 1024, B_K_STRIDE = 1024;  // K4's MN-major weights
  extern __shared__ unsigned char smem_raw[];
  unsigned char* wres = align1024(smem_raw);  // the resident weights, the staging tile, the ring
  unsigned char* staging = wres + L::W_BYTES;
  unsigned char* ring = staging + L::STAGING;
  const unsigned full0 = smem_addr(ring + S * SLOT), empty0 = full0 + 8 * S;
  // w_full: the weights landed; out_free: the last tile's store has read the staging tile
  const unsigned w_full = empty0 + 8 * S, out_free = w_full + 8;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int cb = blockIdx.x % geo.ng, first = blockIdx.x / geo.ng, step = gridDim.x / geo.ng;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4);  // the four warps of the consumer that multiplied
    }
    mbar_init(w_full, 1);
    mbar_init(out_free, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the slots' rows past tw, which no box writes, are 0
  for (int i = tid; i < S * SLOT / 16; i += THREADS) reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
  fence_async_shared();
  __syncthreads();
  const int nk = geo.nk;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid != 256) return;
    // the column block's weights, once: K4 BN / 64 boxes of W's group cb a
    // slice, K3 one box of 128 rows of W'^T (rows past N and K read as 0)
    mbar_expect_tx(w_full, nk * BN * 128);
    for (int kt = 0; kt < nk; ++kt) {
      const unsigned dst = smem_addr(wres) + kt * BN * 128;
      if (MODE == UP)
#pragma unroll
        for (int j = 0; j < BN / 64; ++j) tma_load_3d(dst + j * B_N_STRIDE, &mapW, w_full, 64 * j, cb, 64 * kt);
      else
        tma_load_2d(dst, &mapW, w_full, 64 * kt, cb * BN);
    }
    int stage = 0;
    unsigned phase = 0;
    for (int t = first; t < geo.tiles; t += step) {
      const int line = t / geo.nseg, w0 = (t % geo.nseg) * geo.tw;
      const int z = line / geo.lines_per_z, h = line % geo.lines_per_z;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);  // passes at once the first time round
        const unsigned full = full0 + 8 * stage, dst = smem_addr(ring + stage * SLOT);
        mbar_expect_tx(full, geo.tw * 128);
        if (MODE == UP) {
          tma_load_4d(dst, &maps.a[0], full, 64 * kt, w0, h, z);
        } else {  // slice kt: channels 64 (kt / 4) .. of parity slab kt % 4
          tma_load_4d(dst, &maps.a[kt & 3], full, 64 * (kt >> 2), w0, h, z);
        }
        if (++stage == S) stage = 0, phase ^= 1;
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int me = wg, other = wg ^ 1, w = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const bool elected = (tid & 127) == 0;
  // K3's row sums: lane q of row 16w + g (+ 8) reads chunks c0 and c0 ^ 4 of
  // each slice (physical slot c ^ g): a quarter warp's two rows then take
  // eight different slots
  const int c0 = (g & 1) ? q + 4 : q;
  mbar_wait(w_full, 0);
  // position p of the block's walk is row tile first + p * step; this
  // consumer takes the positions p = me, me + 2, ...
  for (int p = me;; p += 2) {
    const int t = first + p * step;
    if (t >= geo.tiles) break;
    const int line = t / geo.nseg, w0 = (t % geo.nseg) * geo.tw;
    int stage = (p * nk) % S;  // the producer's slice p * nk of the walk
    unsigned phase = ((p * nk) / S) & 1;
    // acc[4i + 2h + e]: row 16w + g + 8h, column 8i + 2q + e of the block
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    float s[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
    if (p > 0) bar_sync(1 + me, 256);  // position p - 1's products are done
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(full0 + 8 * stage, phase);
      const unsigned a0 = smem_addr(ring + stage * SLOT), b0 = smem_addr(wres) + kt * BN * 128;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        if constexpr (MODE == UP)
          wgmma_bf16<BN>(acc, wgmma_desc(a0 + ks * 32, 16, 1024), wgmma_desc(b0 + ks * 2 * B_K_STRIDE, B_N_STRIDE, B_K_STRIDE));
        else
          wgmma_n128_kmajor(acc, wgmma_desc(a0 + ks * 32, 16, 1024), wgmma_desc(b0 + ks * 32, 16, 1024));
      }
      wgmma_commit();
      if constexpr (MODE == DOWN) {  // the rows' sums from the slot, under its products
        const unsigned char* slot = ring + stage * SLOT;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float p[2] = {0.f, 0.f}, p2[2] = {0.f, 0.f};  // each chunk's sums apart
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float f[8];
            load8(reinterpret_cast<const bf16*>(slot + (16 * w + g + 8 * h) * 128 + (((c0 ^ (4 * c)) ^ g) << 4)), f);
#pragma unroll
            for (int u = 0; u < 8; ++u) p[c] += f[u], p2[c] += f[u] * f[u];
          }
          // one sum, whichever chunk the row's place in the tile loaded first
          s[h] += p[0] + p[1], s2[h] += p2[0] + p2[1];
        }
      }
      // one group left in flight: the previous slice's products are done,
      // its slot goes back to the producer
      wgmma_wait<1>();
      if (kt > 0 && lane == 0) mbar_arrive(empty0 + 8 * (stage == 0 ? S - 1 : stage - 1));
      if (++stage == S) stage = 0, phase ^= 1;
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty0 + 8 * (stage == 0 ? S - 1 : stage - 1));
    if (t + step < geo.tiles) bar_arrive(1 + other, 256);  // position p + 1 may multiply

    // epilogue: the values in place of the accumulators
    if constexpr (MODE == UP) {  // y = bf16(acc + b), then the group's LayerNorm over Co
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int col = 8 * i + 2 * q;
        const bool in = col < geo.cols;
        const float2 b = in ? __ldg(reinterpret_cast<const float2*>(geo.p0 + cb * geo.cols + col)) : make_float2(0.f, 0.f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float y0 = in ? bf16_round(acc[4 * i + 2 * h] + b.x) : 0.f;
          const float y1 = in ? bf16_round(acc[4 * i + 2 * h + 1] + b.y) : 0.f;
          acc[4 * i + 2 * h] = y0, acc[4 * i + 2 * h + 1] = y1;
          s[h] += y0 + y1, s2[h] += y0 * y0 + y1 * y1;
        }
      }
    }
    float mu[2], inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        s[h] += __shfl_xor_sync(0xffffffffu, s[h], o);
        s2[h] += __shfl_xor_sync(0xffffffffu, s2[h], o);
      }
      mu[h] = s[h] / geo.kdiv;
      inv[h] = rsqrtf(fmaxf(s2[h] / geo.kdiv - mu[h] * mu[h], 0.f) + geo.eps);
    }
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int col = 8 * i + 2 * q;
      float2 u = make_float2(0.f, 0.f), v = make_float2(0.f, 0.f);  // K4: scale, shift; K3: sw, ct
      if constexpr (MODE == UP) {
        if (col < geo.cols) u = __ldg(reinterpret_cast<const float2*>(geo.p1 + col)), v = __ldg(reinterpret_cast<const float2*>(geo.p2 + col));
      } else {
        const int gc = cb * BN + col;
        if (gc < geo.cols) u = __ldg(reinterpret_cast<const float2*>(geo.p0 + gc)), v = __ldg(reinterpret_cast<const float2*>(geo.p1 + gc));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float& a0 = acc[4 * i + 2 * h];
        float& a1 = acc[4 * i + 2 * h + 1];
        if constexpr (MODE == UP)
          a0 = (a0 - mu[h]) * inv[h] * u.x + v.x, a1 = (a1 - mu[h]) * inv[h] * u.y + v.y;
        else
          a0 = inv[h] * (a0 - mu[h] * u.x) + v.x, a1 = inv[h] * (a1 - mu[h] * u.y) + v.y;
      }
    }
    if constexpr (MODE == DOWN) {  // 8 consecutive columns of a row a lane, stored from registers
      for_each_8<BN>(acc, [&](int r, int c, float* v, int) {
        if (r < geo.tw && w0 + r < geo.wl && cb * BN + c < geo.cols)
          store8(geo.out + ((size_t)line * geo.wl + w0 + r) * geo.cols + cb * BN + c, v);
      });
    } else {  // K4: through the staging tile, one bf16x2 word a pair at 4q in chunk i % 8 of box i / 8
      if (p > 0) mbar_wait(out_free, (p - 1) & 1);  // position p - 1's store has read the staging tile
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * w + g + 8 * h;
          *reinterpret_cast<unsigned*>(staging + (i >> 3) * SLOT + r * 128 + (((i & 7) ^ (r & 7)) << 4) + 4 * q) =
              pack_bf16(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
        }
      fence_async_shared();  // made visible to the TMA unit, then stored by one thread
      bar_sync(3 + me, 128);
      if (elected) {  // group cb = 2i + j of pixels (line, w0 ..) -> out[z, 2h + i, 2w + j]
#pragma unroll
        for (int b = 0; b < L::OUT_BOXES; ++b)
          if (64 * b < geo.cols) tma_store_5d(&mapOut, smem_addr(staging) + b * SLOT, 64 * b, cb & 1, w0, cb >> 1, line);
        bulk_commit();
        bulk_wait_read<0>();
        mbar_arrive(out_free);
      }
    }
  }
}

template <int MODE>
int kernel_attribute() {
  static const int err = static_cast<int>(cudaFuncSetAttribute(
      resample_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Lay<MODE>::SMEM));
  return err;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Row tiles along a line of wl pixels: as few as fit 64 rows, as even as can be.
void line_tiles(int wl, Geo& geo) {
  geo.nseg = (wl + BM - 1) / BM;
  geo.tw = (wl + geo.nseg - 1) / geo.nseg;
}

template <int MODE>
int launch(const Maps& maps, const CUtensorMap& mapW, const CUtensorMap& mapOut, Geo geo, cudaStream_t st) {
  if (int err = kernel_attribute<MODE>()) return err;
  const int per = sm_count() / geo.ng;  // blocks a column block
  const int grid = geo.ng * (geo.tiles < per ? geo.tiles : per);
  resample_kernel<MODE><<<grid, THREADS, Lay<MODE>::SMEM, st>>>(maps, mapW, mapOut, geo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4: x (Z, H, W, C) bf16 with element strides (sz, sh, sw, 1); w (C, 4 Co)
// bf16 row-major; bias (4 Co), scale, shift (Co) f32; out (Z, 2H, 2W, Co)
// bf16 contiguous.  C <= 384, Co <= 192, both multiples of 8, strides of 8
// elements, 16-byte aligned bases: else cudaErrorInvalidValue.
extern "C" int skt_upsample_bf16(const void* x, long long sz, long long sh, long long sw, int Z, int H, int W, int C,
                                 const void* w, const void* bias, const void* scale, const void* shift, void* out,
                                 int Co, float eps, void* stream) {
  using L = Lay<UP>;
  if (Z <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 8 || C > 64 * L::MAX_NK || Co <= 0 || Co % 8 || Co > L::BN ||
      sz % 8 || sh % 8 || sw % 8 || !aligned16(x) || !aligned16(w) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  Geo geo{};
  line_tiles(W, geo);
  geo.lines_per_z = H, geo.tiles = Z * H * geo.nseg, geo.ng = 4, geo.nk = (C + 63) / 64;
  geo.cols = Co, geo.kdiv = Co, geo.eps = eps;
  geo.p0 = static_cast<const float*>(bias), geo.p1 = static_cast<const float*>(scale);
  geo.p2 = static_cast<const float*>(shift);
  Maps maps;
  CUtensorMap mapW, mapOut;
  const uint64_t e = sizeof(bf16), co = Co;
  {
    const uint64_t dims[4] = {(uint64_t)C, (uint64_t)W, (uint64_t)H, (uint64_t)Z};
    const uint64_t strides[3] = {sw * e, sh * e, sz * e};
    const uint32_t box[4] = {64, (uint32_t)geo.tw, 1, 1};
    if (int err = make_tensor_map_nd(&maps.a[0], x, 4, dims, strides, box)) return err;
    maps.a[1] = maps.a[2] = maps.a[3] = maps.a[0];
  }
  {
    const uint64_t dims[3] = {co, 4, (uint64_t)C}, strides[2] = {co * e, 4 * co * e};
    const uint32_t box[3] = {64, 1, 64};
    if (int err = make_tensor_map_nd(&mapW, w, 3, dims, strides, box)) return err;
  }
  {  // out (Z H, i, W, j, Co): the pixel (z, 2h + i, 2w + j)
    const uint64_t dims[5] = {co, 2, (uint64_t)W, 2, (uint64_t)Z * H};
    const uint64_t strides[4] = {co * e, 2 * co * e, 2 * W * co * e, 4 * W * co * e};
    const uint32_t box[5] = {64, 1, (uint32_t)geo.tw, 1, 1};
    if (int err = make_tensor_map_nd(&mapOut, out, 5, dims, strides, box)) return err;
  }
  return launch<UP>(maps, mapW, mapOut, geo, static_cast<cudaStream_t>(stream));
}

// K3: x (Z, H, W, C) bf16 with element strides (sz, sh, sw, 1), W even, H >=
// 2 (odd H: row H reads as 0); wt = W'^T (N, 4 Cp) bf16, Cp = C rounded up to
// 64, channel c of slab p at column 64 (4 (c / 64) + p) + c % 64, 0 past C;
// sw, ct (N) f32; out (Z, ceil(H / 2), W / 2, N) bf16 contiguous.  C <= 192
// and N <= 128 or a multiple of 128, both multiples of 8, strides of 8
// elements, 16-byte aligned bases: else cudaErrorInvalidValue.
extern "C" int skt_downsample_bf16(const void* x, long long sz, long long sh, long long sw, int Z, int H, int W,
                                   int C, const void* wt, const void* swv, const void* ct, void* out, int N,
                                   float eps, void* stream) {
  using L = Lay<DOWN>;
  const int cp = (C + 63) / 64 * 64;
  if (Z <= 0 || H < 2 || W <= 0 || W % 2 || C <= 0 || C % 8 || 4 * cp > 64 * L::MAX_NK || N <= 0 || N % 8 ||
      (N > L::BN && N % L::BN) || sz % 8 || sh % 8 || sw % 8 || !aligned16(x) || !aligned16(wt) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const int H2 = (H + 1) / 2, W2 = W / 2;
  Geo geo{};
  line_tiles(W2, geo);
  geo.lines_per_z = H2, geo.tiles = Z * H2 * geo.nseg, geo.ng = (N + L::BN - 1) / L::BN;
  geo.nk = 4 * cp / 64, geo.cols = N, geo.kdiv = 4 * C, geo.eps = eps;
  geo.p0 = static_cast<const float*>(swv), geo.p1 = static_cast<const float*>(ct), geo.p2 = nullptr;
  geo.wl = W2, geo.out = static_cast<bf16*>(out);
  Maps maps;
  CUtensorMap mapW;
  const uint64_t e = sizeof(bf16);
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) {  // the pixels (z, 2 h2 + i, 2 w2 + j)
      const uint64_t dims[4] = {(uint64_t)C, (uint64_t)W2, (uint64_t)((H - i + 1) / 2), (uint64_t)Z};
      const uint64_t strides[3] = {2 * sw * e, 2 * sh * e, sz * e};
      const uint32_t box[4] = {64, (uint32_t)geo.tw, 1, 1};
      const bf16* base = static_cast<const bf16*>(x) + i * sh + j * sw;
      if (int err = make_tensor_map_nd(&maps.a[2 * i + j], base, 4, dims, strides, box)) return err;
    }
  {
    const uint64_t dims[2] = {(uint64_t)4 * cp, (uint64_t)N}, strides[1] = {4 * (uint64_t)cp * e};
    const uint32_t box[2] = {64, (uint32_t)L::BN};
    if (int err = make_tensor_map_nd(&mapW, wt, 2, dims, strides, box)) return err;
  }
  return launch<DOWN>(maps, mapW, mapW, geo, static_cast<cudaStream_t>(stream));  // no output map: stores from registers
}
