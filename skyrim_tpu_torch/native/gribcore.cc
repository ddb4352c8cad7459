// gribcore: the native fast path of the GRIB2 decoder
// (skyrim_tpu_torch/data/grib.py), a copy of native/gribcore.cc.
//
// The decoder is numpy; this C++ host library takes its two hot inner
// loops:
//   - unpack_bits: big-endian n-bit integer stream -> int64 array
//   - decode_simple: fused unpack + (R + X*2^E) / 10^D -> float32, one pass
//
// decode_simple divides by 10^D as the numpy path does (not a multiply by
// 10^-D), so both paths give the same bits for every D.  A plain shared
// library with a C interface, built at first use with the host's g++
// (skyrim_tpu_torch/data/gribcore.py) and bound with ctypes.

#include <cstdint>
#include <cstddef>
#include <cmath>

extern "C" {

// Unpack `n` big-endian `nbits`-wide unsigned integers from `data`.
// Returns 0 on success, -1 if the buffer is too short.
int gribcore_unpack_bits(const uint8_t* data, size_t nbytes, int nbits,
                         size_t n, int64_t* out) {
    if (nbits == 0) {
        for (size_t i = 0; i < n; ++i) out[i] = 0;
        return 0;
    }
    if (nbits > 32) return -1;
    if (nbytes * 8 < n * (size_t)nbits) return -1;

    uint64_t acc = 0;
    int acc_bits = 0;
    size_t byte = 0;
    const uint64_t mask = (1ull << nbits) - 1;
    for (size_t i = 0; i < n; ++i) {
        while (acc_bits < nbits) {
            acc = (acc << 8) | data[byte++];
            acc_bits += 8;
        }
        out[i] = (int64_t)((acc >> (acc_bits - nbits)) & mask);
        acc_bits -= nbits;
    }
    return 0;
}

// Fused simple-packing decode: out[i] = (R + X[i]*2^E) / 10^D.
int gribcore_decode_simple(const uint8_t* data, size_t nbytes, int nbits,
                           size_t n, float R, int E, int D, float* out) {
    if (nbits > 32) return -1;
    const double scale = std::ldexp(1.0, E);
    const double dec = std::pow(10.0, (double)D);
    if (nbits == 0) {
        const float v = (float)((double)R / dec);
        for (size_t i = 0; i < n; ++i) out[i] = v;
        return 0;
    }
    if (nbytes * 8 < n * (size_t)nbits) return -1;
    uint64_t acc = 0;
    int acc_bits = 0;
    size_t byte = 0;
    const uint64_t mask = (1ull << nbits) - 1;
    for (size_t i = 0; i < n; ++i) {
        while (acc_bits < nbits) {
            acc = (acc << 8) | data[byte++];
            acc_bits += 8;
        }
        uint64_t x = (acc >> (acc_bits - nbits)) & mask;
        acc_bits -= nbits;
        out[i] = (float)(((double)R + (double)x * scale) / dec);
    }
    return 0;
}

// Invert second-order spatial differencing in place:
// x[i] = d[i] + 2*x[i-1] - x[i-2] for i >= 2.
void gribcore_undo_second_diff(int64_t* x, size_t n) {
    for (size_t i = 2; i < n; ++i) x[i] = x[i] + 2 * x[i - 1] - x[i - 2];
}

int gribcore_version() { return 1; }

}  // extern "C"
