// Device helpers, the window Gram and the residual axpy shared by the
// BayesRRm sweep kernels (sweep_kernel.cu), the multi-trait kernels
// (sweep_kernel_mt.cu) and the BayesW kernels (sweep_kernel_bw.cu).
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
constexpr int T_MAX = 16;      // traits a multi-trait thread holds in registers

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

// ----------------------------------------------------------------- gram --
// The window Gram of the exact sweeps (sweep_kernel.cu, sweep_kernel_mt.cu).
// grid (nt * nt, n_chunks), block (32, 8). Block (ti, tj, chunk) computes
// the 32x32 tile of the window Gram over GRAM_CB packed bytes; thread
// (tx, ty) owns rows ty + 8q (q < 4) of column tx.
//   COMPLETE: exact int32 Gram of g planes by __dp4a on int8x4 genotypes.
//   else    : f32 Gram of x = (g - mave*m) * mstd, with row r's statistics
//             at mave[i * ld], mstd[i * ld], i = order_w[r] when by_slot
//             (the sweeps' mrow columns 0 and 1), else i = r (window_stats'
//             window-ordered vectors). COMPLETE reads none of them.
// Partials: part[chunk * W * W + i * W + j] (int32 bits when COMPLETE).
constexpr int GRAM_TW = 32;        // Gram tile edge
constexpr int GRAM_CB = 512;       // packed bytes per Gram chunk (partial)
constexpr int GRAM_SB = 32;        // packed bytes per shared-memory step

template <bool COMPLETE>
__global__ void gram_kernel(const uint8_t* __restrict__ pk, int nb,
                            const int* __restrict__ order_w, int W,
                            const float* __restrict__ mave,
                            const float* __restrict__ mstd, int ld, int by_slot,
                            float* __restrict__ part) {
    const int nt = (W + GRAM_TW - 1) / GRAM_TW;
    const int ti = blockIdx.x / nt, tj = blockIdx.x % nt;
    const int b0 = blockIdx.y * GRAM_CB;
    const int b1 = min(b0 + GRAM_CB, nb);
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * 32 + tx;
    const size_t ww = static_cast<size_t>(W) * W;
    if constexpr (COMPLETE) {
        __shared__ int As[GRAM_TW][GRAM_SB + 1];
        __shared__ int Bs[GRAM_TW][GRAM_SB + 1];
        int acc[4] = {0, 0, 0, 0};
        for (int sb = b0; sb < b1; sb += GRAM_SB) {
            for (int i = tid; i < GRAM_TW * GRAM_SB; i += 256) {
                const int rr = i / GRAM_SB, bb = i % GRAM_SB;
                const int ra = ti * GRAM_TW + rr, rb = tj * GRAM_TW + rr;
                const bool inb = sb + bb < b1;
                As[rr][bb] = (ra < W && inb)
                    ? geno_x4(pk[static_cast<size_t>(order_w[ra]) * nb + sb + bb]) : 0;
                Bs[rr][bb] = (rb < W && inb)
                    ? geno_x4(pk[static_cast<size_t>(order_w[rb]) * nb + sb + bb]) : 0;
            }
            __syncthreads();
#pragma unroll 8
            for (int kk = 0; kk < GRAM_SB; ++kk) {
                const int bv = Bs[tx][kk];
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[q] = __dp4a(As[ty + 8 * q][kk], bv, acc[q]);
            }
            __syncthreads();
        }
        int* out = reinterpret_cast<int*>(part) + blockIdx.y * ww;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int i = ti * GRAM_TW + ty + 8 * q, j = tj * GRAM_TW + tx;
            if (i < W && j < W) out[static_cast<size_t>(i) * W + j] = acc[q];
        }
    } else {
        constexpr int SI = GRAM_SB * 4;   // individuals per step
        __shared__ float Af[GRAM_TW][SI + 1];
        __shared__ float Bf[GRAM_TW][SI + 1];
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int sb = b0; sb < b1; sb += GRAM_SB) {
            for (int i = tid; i < GRAM_TW * GRAM_SB; i += 256) {
                const int rr = i / GRAM_SB, bb = i % GRAM_SB;
                const bool inb = sb + bb < b1;
#pragma unroll
                for (int side = 0; side < 2; ++side) {
                    const int ra = (side == 0 ? ti : tj) * GRAM_TW + rr;
                    float x[4] = {0.f, 0.f, 0.f, 0.f};
                    if (ra < W && inb) {
                        const int slot = order_w[ra];
                        const size_t si = static_cast<size_t>(by_slot ? slot : ra) * ld;
                        const float av = mave[si];
                        const float sd = mstd[si];
                        const uint32_t byte = pk[static_cast<size_t>(slot) * nb + sb + bb];
#pragma unroll
                        for (int k = 0; k < 4; ++k) {
                            const int c = crumb(byte, k);
                            const float m = static_cast<float>(crumb_mask(c));
                            const float g = static_cast<float>(crumb_geno(c));
                            x[k] = (g - av * m) * sd;
                        }
                    }
                    float (*dst)[SI + 1] = side == 0 ? Af : Bf;
#pragma unroll
                    for (int k = 0; k < 4; ++k) dst[rr][4 * bb + k] = x[k];
                }
            }
            __syncthreads();
#pragma unroll 8
            for (int kk = 0; kk < SI; ++kk) {
                const float bv = Bf[tx][kk];
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[q] = fmaf(Af[ty + 8 * q][kk], bv, acc[q]);
            }
            __syncthreads();
        }
        float* out = part + blockIdx.y * ww;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int i = ti * GRAM_TW + ty + 8 * q, j = tj * GRAM_TW + tx;
            if (i < W && j < W) out[static_cast<size_t>(i) * W + j] = acc[q];
        }
    }
}

// Fixed-order sum of the Gram partials over chunks -> G (W, W) f32. The
// complete-data integer Gram stays raw here; the draw standardizes it.
__global__ void gram_reduce_kernel(const float* __restrict__ part, int n_chunks,
                                   int W, int complete, float* __restrict__ G) {
    const size_t ww = static_cast<size_t>(W) * W;
    const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (e >= ww) return;
    if (complete) {
        const int* p = reinterpret_cast<const int*>(part);
        int s = 0;
        for (int c = 0; c < n_chunks; ++c) s += p[c * ww + e];
        G[e] = static_cast<float>(s);
    } else {
        float s = 0.f;
        for (int c = 0; c < n_chunks; ++c) s += part[c * ww + e];
        G[e] = s;
    }
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
