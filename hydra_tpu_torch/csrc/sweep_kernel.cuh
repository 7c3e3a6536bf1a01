// Device helpers and the residual axpy shared by the BayesRRm sweep kernels
// (sweep_kernel.cu) and the BayesW kernels (sweep_kernel_bw.cu).
//
// Genotypes arrive h-packed (hydra_tpu/ops/decode.py): each 2-bit crumb
// holds h = 2 - genotype, 3 = missing, and crumb k of byte b is individual
// 4b + k. The crumb helpers replace the Pallas decoders _decode_h_int and
// _decode_k (hydra_tpu/ops/window_kernels.py:78-105).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace hydra {

// mrow column layout (hydra_tpu/ops/sweep_kernel.py:51-56), K components:
//   0 mave, 1 mstd, 2 beta_old, 3 u, 4 nrm, 5 act,
//   6..6+K-1 logl_static, 6+K..6+2K-2 inv_denom_k, 6+2K-1..6+3K-3 sd_k
constexpr int N_FIXED = 6;
constexpr int K_MAX = 16;      // mixture components a draw thread can hold

// genotype modes of the stats and axpy passes
constexpr int MODE_MISSING = 0;         // s1 = sum g*x, s2 = sum m*x
constexpr int MODE_STALE_COMPLETE = 1;  // s1 = sum h*x, s2 = sum x
constexpr int MODE_EXACT_COMPLETE = 2;  // s1 = sum g*x, s2 = sum x, v = sum g

constexpr int AXPY_THREADS = 256;
constexpr float EULER_MASCHERONI = 0.577215664901532f;   // BayesW.cpp:42

inline int cdiv(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

inline size_t align256(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

#define HYDRA_CHECK_LAUNCH()                          \
    do {                                              \
        cudaError_t e_ = cudaGetLastError();          \
        if (e_ != cudaSuccess) return static_cast<int>(e_); \
    } while (0)

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

// Fixed-order reduction of one row's per-tile partials part[t * W + r].
__device__ __forceinline__ float reduce_tiles(const float* part, int n_tiles,
                                              int W, int r) {
    float s = 0.f;
    for (int t = 0; t < n_tiles; ++t) s += part[t * W + r];
    return s;
}

// ----------------------------------------------------------------- axpy --
// eps[4b + k] += d_k with d = sum_r c1_r * g_r + c2_r * m_r over the window's
// rows (coef = [c1[W], c2[W], cst]). One thread per packed byte (4
// individuals) loops over the rows; the decode stays in registers.
//   MODE_MISSING        d = sum c1*g + c2*m (pads decode to g = m = 0)
//   MODE_STALE_COMPLETE d = (cst - sum c1*h) * mask, cst = 2 sum c1 + sum c2
//   MODE_EXACT_COMPLETE d = (sum c1*g + cst) * mask,  cst = sum c2
// A null mask reads as 1 (the standalone window_axpy contract: the caller
// masks). REFRESH (BayesW) also rewrites vi = exp(alpha*eps' - EuMasc) *
// mask in the same pass (BayesW.cpp:1832-1834; alpha = sc[0]; mask is
// required then).
template <bool REFRESH>
__global__ void axpy_kernel(const uint8_t* __restrict__ pk, int nb,
                            const int* __restrict__ order_w, int W, int mode,
                            const float* __restrict__ coef,
                            const float* __restrict__ mask,
                            float* __restrict__ eps,
                            float* __restrict__ vi,
                            const float* __restrict__ sc) {
    extern __shared__ float sh[];          // c1[W], c2[W], slot[W]
    float* s_c1 = sh;
    float* s_c2 = sh + W;
    int* s_slot = reinterpret_cast<int*>(sh + 2 * W);
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
        s_c1[i] = coef[i];
        s_c2[i] = coef[W + i];
        s_slot[i] = order_w[i];
    }
    __syncthreads();
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= nb) return;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < W; ++r) {
        const uint32_t byte = pk[static_cast<size_t>(s_slot[r]) * nb + b];
        const float c1 = s_c1[r];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int c = crumb(byte, k);
            if (mode == MODE_STALE_COMPLETE) {
                acc[k] = fmaf(c1, static_cast<float>(c), acc[k]);
            } else if (mode == MODE_EXACT_COMPLETE) {
                acc[k] = fmaf(c1, static_cast<float>(crumb_geno(c)), acc[k]);
            } else {
                acc[k] = fmaf(c1, static_cast<float>(crumb_geno(c)), acc[k]);
                acc[k] = fmaf(s_c2[r], static_cast<float>(crumb_mask(c)), acc[k]);
            }
        }
    }
    float4* e4 = reinterpret_cast<float4*>(eps);
    float4 e = e4[b];
    const float4 m = mask != nullptr ? reinterpret_cast<const float4*>(mask)[b]
                                     : make_float4(1.f, 1.f, 1.f, 1.f);
    if (mode == MODE_MISSING) {
        e.x += acc[0]; e.y += acc[1]; e.z += acc[2]; e.w += acc[3];
    } else {
        const float cst = coef[2 * W];
        float d[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
            d[k] = mode == MODE_STALE_COMPLETE ? cst - acc[k] : acc[k] + cst;
        e.x += d[0] * m.x; e.y += d[1] * m.y; e.z += d[2] * m.z; e.w += d[3] * m.w;
    }
    e4[b] = e;
    if (REFRESH) {
        const float alpha = sc[0];
        float4 v;
        v.x = expf(__fsub_rn(__fmul_rn(alpha, e.x), EULER_MASCHERONI)) * m.x;
        v.y = expf(__fsub_rn(__fmul_rn(alpha, e.y), EULER_MASCHERONI)) * m.y;
        v.z = expf(__fsub_rn(__fmul_rn(alpha, e.z), EULER_MASCHERONI)) * m.z;
        v.w = expf(__fsub_rn(__fmul_rn(alpha, e.w), EULER_MASCHERONI)) * m.w;
        reinterpret_cast<float4*>(vi)[b] = v;
    }
}

}  // namespace hydra
