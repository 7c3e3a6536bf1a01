// Device helpers shared by the BayesRRm sweep kernels (sweep_kernel.cu).
//
// Genotypes arrive h-packed (hydra_tpu/ops/decode.py): each 2-bit crumb
// holds h = 2 - genotype, 3 = missing, and crumb k of byte b is individual
// 4b + k. These replace the Pallas crumb decoders _decode_h_int and
// _decode_k (hydra_tpu/ops/window_kernels.py:78-105).
#pragma once

#include <cstdint>

namespace hydra {

// mrow column layout (hydra_tpu/ops/sweep_kernel.py:51-56), K components:
//   0 mave, 1 mstd, 2 beta_old, 3 u, 4 nrm, 5 act,
//   6..6+K-1 logl_static, 6+K..6+2K-2 inv_denom_k, 6+2K-1..6+3K-3 sd_k
constexpr int N_FIXED = 6;
constexpr int K_MAX = 16;      // mixture components a draw thread can hold

// crumb k of a byte: the raw h value (_decode_h_int); pads decode to 3
__device__ __forceinline__ int crumb(uint32_t byte, int k) {
    return static_cast<int>((byte >> (2 * k)) & 3u);
}

// _decode_k mask: 0 iff the crumb is missing (c == 3)
__device__ __forceinline__ int crumb_mask(int c) { return 1 - ((c + 1) >> 2); }

// _decode_k genotype: (2 - c) * mask, so missing and pads give 0
__device__ __forceinline__ int crumb_geno(int c) { return (2 - c) * crumb_mask(c); }

// the byte's four genotypes as signed int8 lanes, for __dp4a
__device__ __forceinline__ int geno_x4(uint32_t byte) {
    int out = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) out |= crumb_geno(crumb(byte, k)) << (8 * k);
    return out;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

}  // namespace hydra
