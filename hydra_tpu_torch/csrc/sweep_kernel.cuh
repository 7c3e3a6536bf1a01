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
constexpr int K_MAX = 16;      // mixture components a draw thread holds in registers
constexpr int K_ANY = 0;       // the draws' bound above K_MAX: constants read from memory
constexpr int T_MAX = 16;      // traits a multi-trait thread holds in registers
// The widest window of the arms that hold a window in one block (a draw
// thread a marker, up to the block's 1,024 threads) or its coefficients in
// shared memory; wider windows take the WIDE arms: the exact recurrences in
// pieces of WIDE_W markers, a launch each, and the axpys with their
// coefficients staged a chunk of rows at a time.
constexpr int WIDE_W = 1024;

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

#define HYDRA_CHECK(call)                                  \
    do {                                                   \
        cudaError_t e_ = (call);                           \
        if (e_ != cudaSuccess) return static_cast<int>(e_); \
    } while (0)

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <class F>
inline cudaError_t allow_smem(F* kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

// crumb k of a byte: the raw h value (_decode_h_int); pads decode to 3
__device__ __forceinline__ int crumb(uint32_t byte, int k) {
    return static_cast<int>((byte >> (2 * k)) & 3u);
}

// _decode_k mask: 0 iff the crumb is missing (c == 3)
__device__ __forceinline__ int crumb_mask(int c) { return 1 - ((c + 1) >> 2); }

// _decode_k genotype: (2 - c) * mask, so missing and pads give 0
__device__ __forceinline__ int crumb_geno(int c) { return (2 - c) * crumb_mask(c); }

// a packed byte's four crumbs as the four bytes of a word (byte k = crumb k)
__device__ __forceinline__ uint32_t spread_crumbs(uint32_t byte) {
    return (byte & 0x3u) | ((byte & 0xcu) << 6) | ((byte & 0x30u) << 12) |
           ((byte & 0xc0u) << 18);
}

// crumb_geno on all 16 crumbs of a packed word at once: h = 0, 1, 2, 3
// (missing) -> genotype 2, 1, 0, 0, two bits per crumb in place
__device__ __forceinline__ uint32_t geno_crumbs(uint32_t x) {
    const uint32_t not_hi = (~x >> 1) & 0x55555555u;
    return ((not_hi & ~x & 0x55555555u) << 1) | (not_hi & x);
}

// the four crumbs at bit 2k of each byte of a word, shifted to bits 0-1
__device__ __forceinline__ uint32_t crumbs_at(uint32_t x, int k) {
    return (x >> (2 * k)) & 0x03030303u;
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

// a hint: bring the 128-byte line at p into L2
__device__ __forceinline__ void prefetch_l2(const void* p) {
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// Fixed-order reduction of one row's per-tile partials part[t * W + r].
__device__ __forceinline__ float reduce_tiles(const float* part, int n_tiles,
                                              int W, int r) {
    float s = 0.f;
    for (int t = 0; t < n_tiles; ++t) s += part[t * W + r];
    return s;
}

// ------------------------------------------------------------ stats tile --
// The tile of the per-row passes over a window's packed rows and one f32
// vector x in individual order: stats_kernel (x = eps, sweep_kernel.cu)
// and levels_kernel (x = vi, sweep_kernel_bw.cu). A block covers one
// STATS_TB-byte tile (128 words, 2,048 individuals) for STATS_WARPS warps
// of STATS_RPW rows each; lane l of a warp owns the tile's words l, l + 32,
// l + 64, l + 96 (16 individuals each) of each of its rows.
constexpr int STATS_TB = 512;      // packed bytes a tile
constexpr int STATS_WARPS = 8;     // warps a block
constexpr int STATS_RPW = 2;       // rows a warp, their loads in flight together
constexpr int STATS_THREADS = STATS_WARPS * 32;
constexpr int STATS_STAGE = STATS_TB / STATS_THREADS;   // x float4 a thread stages

// the staged x tile's float4 f lives at swz(f): lane l's reads of its
// word's four float4 (f = 4 (l + 32 j) + q) then fall in distinct banks
__device__ __forceinline__ int swz(int f) { return f ^ ((f >> 3) & 3); }

// Loads only (no arithmetic on x, so the files built with and without
// -fmad=false share it). load(), called by every thread of the block:
//  - the warp's rows' packed words first (words[p][j] = word l + 32 j of
//    row r0 + p; rows past W repeat row W - 1), so their two round trips
//    (order, row) run while the block stages x;
//  - the same rows' tile of the next window (next_w, may be null) to L2, a
//    hint: lane 4p + l prefetches line l of row r0 + p;
//  - a block of STATS_THREADS stages the tile's x (8 KB) once in s_x
//    (swizzled), every load in flight, behind one barrier; a block of one
//    warp (W <= STATS_RPW) reads it straight into registers;
//  - each lane's 64 values of x in registers, ev[j][4 q + k] = individual
//    16 (w0 + l + 32 j) + 4 q + k (zero past the tile's nj words a lane).
// Returns false for a warp with no rows (r0 >= W), after the barrier.
struct StatsTile {
    int w0;                        // the tile's first word
    int nj;                        // words a lane, 1..4
    int r0;                        // the warp's first row
    uint32_t words[STATS_RPW][4];
    float ev[4][16];

    __device__ __forceinline__ bool load(const uint8_t* __restrict__ pk, int nb,
                                         const float* __restrict__ x,
                                         const int* __restrict__ order_w,
                                         const int* __restrict__ next_w, int W,
                                         float4* s_x) {
        w0 = blockIdx.x * (STATS_TB / 4);
        const int nw = min(STATS_TB / 4, nb / 4 - w0);     // a multiple of 32
        nj = nw / 32;
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
        r0 = (blockIdx.y * (blockDim.x >> 5) + warp) * STATS_RPW;
        if (r0 < W) {
#pragma unroll
            for (int p = 0; p < STATS_RPW; ++p) {
                const int r = min(r0 + p, W - 1);
                const uint32_t* row = reinterpret_cast<const uint32_t*>(
                    pk + static_cast<size_t>(order_w[r]) * nb) + w0 + lane;
#pragma unroll
                for (int j = 0; j < 4; ++j) words[p][j] = j < nj ? __ldg(row + 32 * j) : 0u;
            }
        }
        const int pr = r0 + (lane >> 2);
        const int next_slot = next_w != nullptr && lane < 4 * STATS_RPW && pr < W &&
                                      (lane & 3) < nj
                                  ? next_w[pr]
                                  : -1;
        const float4* x4 = reinterpret_cast<const float4*>(x) + 4 * w0;
        const bool staged = blockDim.x == STATS_THREADS;
        if (staged) {
            float4 st[STATS_STAGE];
#pragma unroll
            for (int q = 0; q < STATS_STAGE; ++q) {
                const int f = threadIdx.x + q * STATS_THREADS;
                st[q] = f < 4 * nw ? __ldg(x4 + f) : make_float4(0.f, 0.f, 0.f, 0.f);
            }
#pragma unroll
            for (int q = 0; q < STATS_STAGE; ++q) s_x[swz(threadIdx.x + q * STATS_THREADS)] = st[q];
            __syncthreads();
        }
        if (r0 >= W) return false;
        if (next_slot >= 0)
            prefetch_l2(pk + static_cast<size_t>(next_slot) * nb + 4 * w0 + 128 * (lane & 3));
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int f = (lane + 32 * j) * 4 + q;
                const float4 e = j >= nj ? make_float4(0.f, 0.f, 0.f, 0.f)
                                 : staged ? s_x[swz(f)] : __ldg(x4 + f);
                ev[j][4 * q] = e.x;
                ev[j][4 * q + 1] = e.y;
                ev[j][4 * q + 2] = e.z;
                ev[j][4 * q + 3] = e.w;
            }
        return true;
    }
};

// The grid of a window's pass over the tile: (tiles, ceil(W / rows a
// block)), STATS_THREADS a block, one warp for W <= STATS_RPW.
inline dim3 stats_grid(int nb, int W) {
    return dim3(cdiv(nb, STATS_TB), cdiv(W, STATS_WARPS * STATS_RPW));
}

inline int stats_threads(int W) { return W <= STATS_RPW ? 32 : STATS_THREADS; }

// ------------------------------------------------------ complete gram --
// The complete-data window Grams of the exact sweeps (hydra_sweep_exact,
// hydra_sweep_exact_mt), of window_stats (hydra_window_stats) and of
// hydra_window_grams: G_w = g g^T over window w's rows order[w W .. w W +
// W), g = the genotype planes, for a batch of n consecutive windows in one
// launch, written as f32 (n, W, W), raw (the callers standardize it).
// Serves _sweep_exact_kernel (hydra_tpu/ops/sweep_kernel.py:567; its Gram
// at :399-402), sweep_exact_mt (hydra_tpu/ops/sweep_kernel_mt.py:499) and
// window_stats (hydra_tpu/ops/window_kernels.py:180).
//
// Bound: bytes, the W * nb packed bytes a window in and its (W, W) f32
// out (1.67 MB at W=128, N=50,000: 0.50 us at 3.35 TB/s), just above the
// symmetric Gram's W (W + 1) n_pad int8 operations (0.83 G: 0.42 us at
// 1,979 TOP/s). A window's Gram depends on its rows alone, not on eps or
// the chain, so a sweep computes many windows' Grams in one launch ahead
// of their draws, and a block owns one (window, upper tile) and runs all
// of its individuals: no split, no atomics, no ticket, no memset, and the
// launch is off the windows' chain of stats -> draw -> axpy. The design:
//  - int8 tensor cores: mma.sync m16n8k32 s8 x s8 -> s32, the fragments
//    loaded by ldmatrix. Genotypes 0..2 are exact in int8 and the sums in
//    int32, so G is the same integer in any order of the individuals:
//    deterministic and bit for bit the plain version's g @ g^T. A word's
//    16 individuals are stored crumb-major (crumbs_at: byte 4k + q is
//    crumb k of packed byte q), the same order in every row.
//  - decode once: a block decodes its rows' packed words into int8 in
//    shared memory (geno_crumbs + crumbs_at, 16 genotypes a word, no
//    table; rows past W decode to 0), and the next stage's packed words
//    are loaded into registers while the tensor cores run the current one.
//  - symmetry: only the tiles ti <= tj of GRAM_I8_TILE rows run; a diagonal
//    tile feeds the same shared rows to A (row-major) and B (column-major).
//  - the per-window caller (window_stats, n = 1: 3 tiles at W=128) splits
//    the individuals across blocks (grid.z) so that ~2 blocks an SM are in
//    flight; the splits meet in one int32 accumulator (n, W, W) by
//    coalesced integer atomics (exact in any order), and the last block of
//    a tile (an atomic ticket) converts it to f32 in G, both triangles,
//    and re-zeroes its accumulator and ticket; the caller zeroes acc once.
// The f32 conversion is exact while every entry (<= 4 n_pad) is <= 2^24:
// n_pad <= GRAM_I8_MAX_NPAD; the C entry points refuse more.
constexpr int GRAM_I8_TILE = 64;          // output tile edge (window rows)
constexpr int GRAM_I8_SB = 64;            // packed bytes a stage (256 individuals)
constexpr int GRAM_I8_LD = 4 * GRAM_I8_SB + 16;   // shared row stride, bytes
constexpr int GRAM_I8_TLD = GRAM_I8_TILE + 1;     // int32 stride of the output tile
constexpr int GRAM_I8_THREADS = 256;
constexpr int GRAM_I8_BLOCKS = 264;       // target blocks a launch (2 per SM)
constexpr long long GRAM_I8_MAX_NPAD = 1LL << 22;
// A sweep's batch of Grams: as many windows as GRAM_BATCH_BYTES of f32
// hold (all 782 of M=100K at W=128; 16 at W=1024), at most
// GRAM_BATCH_WINDOWS, so a sweep of any length reserves at most 64 MB.
// ops/window_kernels.py keeps a copy of both (gram_batch_windows).
constexpr long long GRAM_BATCH_BYTES = 64LL << 20;
constexpr int GRAM_BATCH_WINDOWS = 4096;

// windows a batched Gram launch of a sweep of n_windows windows of W takes
inline int gram_batch_windows(int n_windows, int W) {
    const long long cap = GRAM_BATCH_BYTES / (4LL * W * W);
    long long b = cap < GRAM_BATCH_WINDOWS ? cap : GRAM_BATCH_WINDOWS;
    if (b > n_windows) b = n_windows;
    return b < 1 ? 1 : static_cast<int>(b);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 16-byte matrices from shared memory: lanes 8i .. 8i + 7 give
// matrix i's row addresses; r[i] is matrix i's word at (lane / 4, lane % 4)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// grid (nt (nt + 1) / 2, n, splits), GRAM_I8_THREADS threads. Block (tile,
// w, split) sums tile `tile` of window w over split_bytes packed bytes;
// with one split it writes G + w W^2 itself, else it adds into acc + w W^2
// (int32) and tickets[w * tiles + tile] counts the splits done.
__global__ void __launch_bounds__(GRAM_I8_THREADS, 3)
gram_i8_batch_kernel(const uint8_t* __restrict__ pk, int nb, const int* __restrict__ order,
                     int W, int split_bytes, int* __restrict__ acc,
                     int* __restrict__ tickets, float* __restrict__ G) {
    __shared__ __align__(16) uint8_t sa[GRAM_I8_TILE * GRAM_I8_LD];
    __shared__ __align__(16) uint8_t sb[GRAM_I8_TILE * GRAM_I8_LD];
    __shared__ int s_last;
    const int nt = (W + GRAM_I8_TILE - 1) / GRAM_I8_TILE;
    int ti = 0, rest = blockIdx.x;
    while (rest >= nt - ti) rest -= nt - ti++;
    const int tj = ti + rest;
    const bool diag = ti == tj;
    const uint8_t* sbr = diag ? sa : sb;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const size_t WW = static_cast<size_t>(W) * W;
    const int* order_w = order + static_cast<size_t>(blockIdx.y) * W;
    float* Gw = G + blockIdx.y * WW;
    const int b0 = blockIdx.z * split_bytes;
    const int b1 = min(b0 + split_bytes, nb);

    // loader: a stage is GRAM_I8_TILE rows x 16 packed words a tile; this
    // thread loads word wd of rows (tid >> 4) + 16q
    const int wd = tid & 15;
    const uint32_t* src_a[4];
    const uint32_t* src_b[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int r = (tid >> 4) + 16 * q;
        const int ra = ti * GRAM_I8_TILE + r, rb = tj * GRAM_I8_TILE + r;
        src_a[q] = ra < W ? reinterpret_cast<const uint32_t*>(
                                pk + static_cast<size_t>(order_w[ra]) * nb) + wd
                          : nullptr;
        src_b[q] = rb < W ? reinterpret_cast<const uint32_t*>(
                                pk + static_cast<size_t>(order_w[rb]) * nb) + wd
                          : nullptr;
    }
    // wa, wb: the next stage's words; na, nb_: the stage after, in flight
    // while the next is stored and the current multiplied (two stages in
    // flight measured faster than one where the blocks are few)
    uint32_t wa[4], wb[4], na[4], nb_[4];
    auto load = [&](uint32_t (&xa)[4], uint32_t (&xb)[4], int s) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            xa[q] = src_a[q] && s < b1 ? __ldg(src_a[q] + s / 4) : 0u;
            xb[q] = !diag && src_b[q] && s < b1 ? __ldg(src_b[q] + s / 4) : 0u;
        }
    };
    auto store = [&](uint8_t* dst, bool second) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const uint32_t y = geno_crumbs(second ? wb[q] : wa[q]);
            // rows past W decode to 0, not to the genotype 2 of a 0 byte
            const uint4 v = (second ? src_b[q] : src_a[q])
                                ? make_uint4(crumbs_at(y, 0), crumbs_at(y, 1), crumbs_at(y, 2),
                                             crumbs_at(y, 3))
                                : make_uint4(0u, 0u, 0u, 0u);
            *reinterpret_cast<uint4*>(dst + ((tid >> 4) + 16 * q) * GRAM_I8_LD + 16 * wd) = v;
        }
    };

    // warp: rows 16 (warp & 3) .. +16 of the tile, columns 32 (warp >> 2) ..
    // +32. ldmatrix rows: A's four 8 x 16-byte matrices are (rows 0-7, 8-15)
    // x (bytes 0-15, 16-31) of the warp's 16 rows; B's, a pair of 8-column
    // blocks 2p, 2p + 1, (block 2p, 2p + 1) x (bytes 0-15, 16-31)
    const int g = lane >> 2, t4 = lane & 3;
    const int m0 = 16 * (warp & 3), n0 = 32 * (warp >> 2);
    const uint8_t* la = sa + (m0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * GRAM_I8_LD +
                        16 * (lane >> 4);
    const uint8_t* lb = sbr + (n0 + 8 * (lane >> 4) + (lane & 7)) * GRAM_I8_LD +
                        16 * ((lane >> 3) & 1);
    int c[4][4] = {};
    load(wa, wb, b0);
    load(na, nb_, b0 + GRAM_I8_SB);
    for (int s = b0; s < b1; s += GRAM_I8_SB) {
        __syncthreads();                  // the previous stage is consumed
        store(sa, false);
        if (!diag) store(sb, true);
        __syncthreads();
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            wa[q] = na[q];
            wb[q] = nb_[q];
        }
        load(na, nb_, s + 2 * GRAM_I8_SB);
#pragma unroll
        for (int kk = 0; kk < 4 * GRAM_I8_SB; kk += 32) {
            uint32_t a[4];
            ldmatrix_x4(a, la + kk);
#pragma unroll
            for (int p = 0; p < 2; ++p) {
                uint32_t b[4];
                ldmatrix_x4(b, lb + 16 * p * GRAM_I8_LD + kk);
                mma_s8(c[2 * p], a, b[0], b[1]);
                mma_s8(c[2 * p + 1], a, b[2], b[3]);
            }
        }
    }

    // the block's tile through shared memory (int32, row stride
    // GRAM_I8_TLD), then coalesced stores: G's both triangles, or atomics
    __syncthreads();
    int* tile = reinterpret_cast<int*>(sa);          // [64][65] int32, 16.6 KB
#pragma unroll
    for (int nn = 0; nn < 4; ++nn)
#pragma unroll
        for (int h = 0; h < 4; ++h)
            tile[(m0 + g + 8 * (h >> 1)) * GRAM_I8_TLD + n0 + 8 * nn + 2 * t4 + (h & 1)] =
                c[nn][h];
    __syncthreads();
    constexpr int PER = GRAM_I8_TILE * GRAM_I8_TILE / GRAM_I8_THREADS;
    if (gridDim.z == 1) {
#pragma unroll
        for (int q = 0; q < PER; ++q) {
            const int e = tid + q * GRAM_I8_THREADS;
            const int r = e / GRAM_I8_TILE, cc = e % GRAM_I8_TILE;
            int i = ti * GRAM_I8_TILE + r, j = tj * GRAM_I8_TILE + cc;
            if (i < W && j < W) Gw[static_cast<size_t>(i) * W + j] = tile[r * GRAM_I8_TLD + cc];
            // a diagonal tile holds both triangles; else row r of the
            // transpose: G[tj T + r, ti T + cc] = tile[cc][r]
            i = tj * GRAM_I8_TILE + r;
            j = ti * GRAM_I8_TILE + cc;
            if (!diag && i < W && j < W)
                Gw[static_cast<size_t>(i) * W + j] = tile[cc * GRAM_I8_TLD + r];
        }
        return;
    }
    int* acc_w = acc + blockIdx.y * WW;
    for (int e = tid; e < GRAM_I8_TILE * GRAM_I8_TILE; e += GRAM_I8_THREADS) {
        const int i = ti * GRAM_I8_TILE + e / GRAM_I8_TILE;
        const int j = tj * GRAM_I8_TILE + e % GRAM_I8_TILE;
        if (i < W && j < W)
            atomicAdd(acc_w + static_cast<size_t>(i) * W + j,
                      tile[(e / GRAM_I8_TILE) * GRAM_I8_TLD + e % GRAM_I8_TILE]);
    }
    __threadfence();
    __syncthreads();
    int* ticket = tickets + static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
    if (tid == 0) s_last = atomicAdd(ticket, 1) == static_cast<int>(gridDim.z) - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    // every split's atomics are done: read the tile from L2 (all loads in
    // flight at once, not one round trip each), then write G and zero acc
    int sum[PER];
#pragma unroll
    for (int q = 0; q < PER; ++q) {
        const int e = tid + q * GRAM_I8_THREADS;
        const int i = ti * GRAM_I8_TILE + e / GRAM_I8_TILE;
        const int j = tj * GRAM_I8_TILE + e % GRAM_I8_TILE;
        sum[q] = i < W && j < W ? __ldcg(acc_w + static_cast<size_t>(i) * W + j) : 0;
    }
#pragma unroll
    for (int q = 0; q < PER; ++q) {
        const int e = tid + q * GRAM_I8_THREADS;
        const int i = ti * GRAM_I8_TILE + e / GRAM_I8_TILE;
        const int j = tj * GRAM_I8_TILE + e % GRAM_I8_TILE;
        if (i < W && j < W) {
            const float v = static_cast<float>(sum[q]);
            Gw[static_cast<size_t>(i) * W + j] = v;
            Gw[static_cast<size_t>(j) * W + i] = v;
            acc_w[static_cast<size_t>(i) * W + j] = 0;
        }
    }
    if (tid == 0) *ticket = 0;
}

// int32 words of the accumulator and tickets of a split launch over n
// windows
inline size_t gram_i8_acc_ints(int W, int n = 1) {
    const size_t nt = (W + GRAM_I8_TILE - 1) / GRAM_I8_TILE;
    return (static_cast<size_t>(W) * W + nt * (nt + 1) / 2) * n;
}

// The raw complete-data Grams of the n windows order[0 .. n W) into G (n,
// W, W) f32, one launch. acc == nullptr: one block a tile runs all the
// individuals. Else (gram_i8_acc_ints(W, n) ints, zero; zero again when
// the launch ends) the individuals split across blocks as far as the n
// windows' tiles fall short of GRAM_I8_BLOCKS.
inline int launch_gram_i8(const uint8_t* pk, int nb, const int* order, int W, int n,
                          int* acc, float* G, cudaStream_t stream) {
    const int nt = cdiv(W, GRAM_I8_TILE);
    const int tiles = nt * (nt + 1) / 2;
    const int n_stage = nb / GRAM_I8_SB;
    int per = n_stage;
    if (acc != nullptr) {
        const int want = cdiv(GRAM_I8_BLOCKS, static_cast<long long>(tiles) * n);
        per = want >= n_stage ? 1 : cdiv(n_stage, want);
    }
    gram_i8_batch_kernel<<<dim3(tiles, n, cdiv(n_stage, per)), GRAM_I8_THREADS, 0, stream>>>(
        pk, nb, order, W, per * GRAM_I8_SB, acc,
        acc == nullptr ? nullptr : acc + static_cast<size_t>(W) * W * n, G);
    HYDRA_CHECK_LAUNCH();
    return 0;
}

// ------------------------------------------------------------- cp.async --
// One 4-byte asynchronous copy from global to shared memory (cp.async,
// sm_80+). No register holds the value in flight, so a warp keeps a whole
// tile's loads in flight at once.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                 "l"(src)
                 : "memory");
}

// One 16-byte asynchronous copy from global to shared memory (both 16-byte
// aligned), cached in L2 only.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ------------------------------------------------------- missing gram --
// The missing-data window Grams of the exact sweep (hydra_sweep_exact),
// window_stats (hydra_window_stats) and hydra_window_grams: G_w = x x^T in
// f32 (W, W) for a batch of n consecutive windows in one launch, x = (g -
// mave*m) * mstd over window w's rows order[w W .. w W + W), with row r's
// statistics at mave[i * ld] and mstd[i * ld], i = order[w W + r] when
// by_slot (the sweep's mrow columns 0 and 1), else i = r (window_stats'
// window-ordered vectors, n = 1). Serves _sweep_exact_kernel's Gram
// (hydra_tpu/ops/sweep_kernel.py:399-402) and window_stats
// (hydra_tpu/ops/window_kernels.py:180) on missing genotypes.
//
// The sums are fixed: per GRAM_CB-byte chunk (2,048 individuals) entry
// (i, j) is one fmaf chain from 0.f over the chunk's individuals in
// ascending order, and the chunks' sums are added in chunk order from
// 0.f. fmaf(x_i, x_j, a) == fmaf(x_j, x_i, a), so G is symmetric bit for
// bit, and no choice of tiles, batch or split changes a bit.
//
// Bound: operations, W (W + 1) / 2 * n_pad f32 multiply-adds a window for
// the symmetric half (12.4 us at W=128, N=50,000 at 67 TFLOP/s; the W * nb
// packed bytes take 0.5 us). Tensor cores run no fmaf chain, so every
// multiply-add is an FFMA with both operands from shared memory. A
// thread's TR x TR chains use each loaded operand TR times: 8 x 8 chains
// (GramWide) load a quarter of an operand a multiply-add, 4 x 4 half of
// one. A window's Gram depends on its rows and their statistics alone, so
// a sweep computes many windows' Grams in one launch ahead of their
// draws, enough blocks to fill the card with whole-window tiles. The
// design:
//  - grid (the tiles ti <= tj of T rows, n windows[, chunks]); a block of
//    GRAM_F32_THREADS (8 x 8) owns one (window, tile) and walks its chunks
//    in order; thread (ty, tx) owns rows h (T / H) + V ty + a and columns
//    h (T / H) + V tx + b (V consecutive rows a vector load, H loads a
//    side) and runs their TR x TR chains side by side on operands staged
//    k-major (one individual's rows contiguous), so a quarter warp's loads
//    are one broadcast A vector and eight consecutive B vectors;
//  - decode once, by the same threads, between their chains: stage s + 1
//    (GramWide: 4 packed bytes a row, 16 individuals; the smaller tiles
//    16 bytes, 64 individuals) is decoded into one half of a
//    double-buffered f32 stage while stage s is multiplied out of the
//    other, one barrier a stage, so the decode's latency hides behind the
//    multiply-adds of the same instruction stream (a separate decoding
//    warp measured slower); GramWide's small stages keep 6 blocks an SM
//    (16 KB of stages and 16 KB of running sums a block); thread t decodes
//    rows t and t + 64 of the tile (its rows ti T.., then tj T..), each
//    crumb into one of its row's four x values (gram_x, the plain
//    version's arithmetic, once a thread and row; rows past W give 0), its
//    packed words loaded from memory two stages ahead; a diagonal tile
//    decodes its T rows once for both sides;
//  - the chunk order in registers and shared memory: at a chunk's end each
//    thread adds its chains into its running sums (shared memory, its own
//    slots) and restarts them from 0.f; the last chunk's sums go to G,
//    both triangles;
//  - the per-window caller (window_stats, n = 1) has too few tiles to fill
//    the card: there the launch splits the chunks across blocks (grid.z,
//    one chunk a block), each writes its partial tile, and the last block
//    of a tile (an atomic ticket, zeroed by the caller once) adds them in
//    chunk order.
// The tile (gram_f32_plan): the largest of GramWide (64 rows, 8 x 8
// chains), GramMid (32, 4 x 4) and GramNarrow (16, 2 x 2), none wider
// than W needs, whose tiles give a launch GRAM_F32_BLOCKS blocks; where
// none does, the per-window caller splits.
constexpr int GRAM_CB = 512;            // packed bytes a chunk (one fmaf chain)
constexpr int GRAM_F32_BATCH = 16;      // chunk partials a thread loads at once
constexpr int GRAM_F32_BLOCKS = 200;    // the least blocks a launch
constexpr int GRAM_F32_THREADS = 64;    // 8 x 8 threads a block

// x of crumb c on a row with statistics (av, sd), as the plain version
__device__ __forceinline__ float gram_x(int c, float av, float sd) {
    const float m = static_cast<float>(crumb_mask(c));
    const float g = static_cast<float>(crumb_geno(c));
    return (g - av * m) * sd;
}

// component c (0..3) of l
__device__ __forceinline__ float pick4(const float4& l, uint32_t c) {
    const float lo = (c & 1u) ? l.y : l.x;
    const float hi = (c & 1u) ? l.w : l.z;
    return (c & 2u) ? hi : lo;
}

// A tile shape of gram_f32_batch_kernel: T x T entries, thread (ty, tx)
// of 8 x 8 owning TR x TR; a side's TR rows are H vector loads of V; a
// stage is SB packed bytes a row (KS individuals), of which a thread
// decodes DR rows (rows t + 64 q). Small tiles take long stages: their
// chains are short, and a stage's barrier, loads and decode would
// otherwise outweigh them
template <int T_, int TR_, int SB_>
struct GramTile {
    static constexpr int T = T_, TR = TR_, SB = SB_, KS = 4 * SB;
    static_assert(SB == 4 || SB == 16, "a row's stage is one word or one uint4");
    static constexpr int V = TR < 4 ? TR : 4;
    static constexpr int H = TR / V;
    static constexpr int R = 2 * T;                  // stage rows, both sides
    static constexpr int DR = (R + GRAM_F32_THREADS - 1) / GRAM_F32_THREADS;
    static_assert(8 * TR == T, "8 x 8 threads cover the tile");
};
using GramWide = GramTile<64, 8, 4>;
using GramMid = GramTile<32, 4, 16>;
using GramNarrow = GramTile<16, 2, 16>;

// V consecutive floats of shared memory
template <int V>
__device__ __forceinline__ void load_v(float* dst, const float* src) {
    if constexpr (V == 4) {
        const float4 v = *reinterpret_cast<const float4*>(src);
        dst[0] = v.x;
        dst[1] = v.y;
        dst[2] = v.z;
        dst[3] = v.w;
    } else {
        const float2 v = *reinterpret_cast<const float2*>(src);
        dst[0] = v.x;
        dst[1] = v.y;
    }
}

// dynamic shared memory of gram_f32_batch_kernel on Tile: two f32 stages of
// KS individuals x 2T rows and the running sums
template <class Tile>
__host__ __device__ constexpr size_t gram_f32_smem() {
    return sizeof(float) * (2 * Tile::KS * Tile::R +
                            Tile::TR * Tile::TR * GRAM_F32_THREADS);
}

// grid (nt (nt + 1) / 2, n, 1 or n_chunks), GRAM_F32_THREADS threads,
// gram_f32_smem<Tile>() bytes. Block (tile, w, z) runs tile `tile` of
// window w over all chunks (gridDim.z == 1) and writes G + w W^2, or over
// chunk z alone, writing its partial tile to part[((w * tiles + tile) *
// n_chunks + z) * T^2 + li T + lj]; then tickets[w * tiles + tile] counts
// the chunks done, and the last block adds them.
template <class Tile>
__global__ void __launch_bounds__(GRAM_F32_THREADS, 6)
gram_f32_batch_kernel(const uint8_t* __restrict__ pk, int nb, const int* __restrict__ order,
                      int W, const float* __restrict__ mave, const float* __restrict__ mstd,
                      int ld, int by_slot, float* __restrict__ part, int* __restrict__ tickets,
                      float* __restrict__ G) {
    constexpr int T = Tile::T, TR = Tile::TR, V = Tile::V, H = Tile::H, R = Tile::R;
    constexpr int DR = Tile::DR, NT = GRAM_F32_THREADS;
    constexpr int SB = Tile::SB, KS = Tile::KS, NW = SB / 4;
    constexpr int XS = KS * R;                       // floats an f32 stage
    constexpr size_t TT = static_cast<size_t>(T) * T;
    extern __shared__ __align__(16) unsigned char gram_smem[];
    float* xs = reinterpret_cast<float*>(gram_smem);                 // [2][KS][R]
    float* s_sum = xs + 2 * XS;                                      // [TR TR][NT]
    __shared__ int s_last;
    const int tid = threadIdx.x;
    const int nt = (W + T - 1) / T;
    int ti = 0, rest = blockIdx.x;
    while (rest >= nt - ti) rest -= nt - ti++;
    const int tj = ti + rest;
    const bool diag = ti == tj;
    const int* order_w = order + static_cast<size_t>(blockIdx.y) * W;
    float* Gw = G + static_cast<size_t>(blockIdx.y) * W * W;
    const bool split = gridDim.z > 1;
    const int n_chunks = (nb + GRAM_CB - 1) / GRAM_CB;
    const int bs = split ? blockIdx.z * GRAM_CB : 0;
    const int be = split ? min(bs + GRAM_CB, nb) : nb;
    const int n_st = (be - bs) / SB;
    constexpr int ST_CHUNK = GRAM_CB / SB;           // stages a chunk
    const int rows = diag ? T : R;                   // a diagonal tile: one side

    // the decoding side: this thread's stage rows u = tid + NT q < rows
    // (the tile's rows ti T.., then tj T..), their packed words and x
    // values; a row past W reads row 0's words with all x = 0
    const uint8_t* src[DR];
    float4 lut[DR];
#pragma unroll
    for (int q = 0; q < DR; ++q) {
        const int u = tid + NT * q;
        const int r = u < T ? ti * T + u : tj * T + u - T;
        const bool live = u < rows && r < W;
        src[q] = pk + static_cast<size_t>(order_w[live ? r : 0]) * nb + bs;
        lut[q] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (live) {
            const size_t si = static_cast<size_t>(by_slot ? order_w[r] : r) * ld;
            const float av = mave[si], sd = mstd[si];
            lut[q] = make_float4(gram_x(0, av, sd), gram_x(1, av, sd), gram_x(2, av, sd),
                                 gram_x(3, av, sd));
        }
    }
    // stage s's words (s clamped to the last stage: the loads past the end
    // are never decoded into a stage that is read)
    auto load = [&](uint32_t (&w)[DR][NW], int s) {
        s = min(s, n_st - 1);
#pragma unroll
        for (int q = 0; q < DR; ++q) {
            if constexpr (NW == 1) {
                w[q][0] = __ldg(reinterpret_cast<const uint32_t*>(src[q] + s * SB));
            } else {
                const uint4 v = __ldg(reinterpret_cast<const uint4*>(src[q] + s * SB));
                w[q][0] = v.x;
                w[q][1] = v.y;
                w[q][2] = v.z;
                w[q][3] = v.w;
            }
        }
    };
    // a stage's x into buffer b: xs[b][k][u] for this thread's rows u
    auto decode = [&](const uint32_t (&w)[DR][NW], int b) {
        float* dst = xs + b * XS + tid;
#pragma unroll
        for (int q = 0; q < DR; ++q) {
            if (tid + NT * q < rows) {
#pragma unroll
                for (int k = 0; k < KS; ++k)
                    dst[k * R + NT * q] = pick4(lut[q], (w[q][k / 16] >> (2 * (k % 16))) & 3u);
            }
        }
    };

    const int ty = tid / 8, tx = tid % 8;
    const int bside = diag ? 0 : T;                  // the B rows' first stage row
    float acc[TR][TR];
#pragma unroll
    for (int e = 0; e < TR * TR; ++e) s_sum[e * NT + tid] = 0.f;
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TR; ++j) acc[i][j] = 0.f;
    uint32_t wcur[DR][NW], wnext[DR][NW];
    load(wcur, 0);
    load(wnext, 1);
    decode(wcur, 0);
    __syncthreads();
    for (int s = 0; s < n_st; ++s) {
        // stage s + 1's x into the other buffer (past the last stage:
        // never read), stage s + 2's words from memory, stage s's chains
#pragma unroll
        for (int q = 0; q < DR; ++q)
#pragma unroll
            for (int j = 0; j < NW; ++j) wcur[q][j] = wnext[q][j];
        load(wnext, s + 2);
        decode(wcur, (s + 1) & 1);
        const float* xk = xs + (s & 1) * XS;
        // an explicit count: with the bare pragma, 32-individual stages of
        // this loop ran about 1.5x slower at W=128
#pragma unroll(KS)
        for (int k = 0; k < KS; ++k) {
            float a[TR], b[TR];
#pragma unroll
            for (int h = 0; h < H; ++h) {
                load_v<V>(a + h * V, xk + k * R + h * (T / H) + V * ty);
                load_v<V>(b + h * V, xk + k * R + bside + h * (T / H) + V * tx);
            }
#pragma unroll
            for (int i = 0; i < TR; ++i)
#pragma unroll
                for (int j = 0; j < TR; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
        if ((s + 1) % ST_CHUNK == 0 || s + 1 == n_st) {
            // a chunk's end: its sums into the running sums, in chunk order
            // from 0.f (split: the block's one chunk, as is)
#pragma unroll
            for (int i = 0; i < TR; ++i)
#pragma unroll
                for (int j = 0; j < TR; ++j) {
                    float* sp = s_sum + (i * TR + j) * NT + tid;
                    *sp = split ? acc[i][j] : __fadd_rn(*sp, acc[i][j]);
                    acc[i][j] = 0.f;
                }
        }
    }

    // G[i, j] of tile entry (li, lj), and G[j, i] off the diagonal (a
    // diagonal tile computes both triangles itself)
    auto put = [&](int li, int lj, float v) {
        const int i = ti * T + li, j = tj * T + lj;
        if (i < W && j < W) {
            Gw[static_cast<size_t>(i) * W + j] = v;
            if (!diag) Gw[static_cast<size_t>(j) * W + i] = v;
        }
    };
    auto row_of = [&](int i, int t) { return i / V * (T / H) + V * t + i % V; };
    if (!split) {
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
            for (int j = 0; j < TR; ++j)
                put(row_of(i, ty), row_of(j, tx), s_sum[(i * TR + j) * NT + tid]);
        return;
    }
    const size_t tile_id = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
    float* mine = part + (tile_id * n_chunks + blockIdx.z) * TT;
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TR; ++j)
            mine[row_of(i, ty) * T + row_of(j, tx)] = s_sum[(i * TR + j) * NT + tid];
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(tickets + tile_id, 1) + 1 == n_chunks;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    // every chunk's partial is in: the sums from 0.f in chunk order, a
    // batch of chunks' loads in flight at once, from L2
    const float4* tile = reinterpret_cast<const float4*>(part + tile_id * n_chunks * TT);
    for (int e4 = tid; e4 < static_cast<int>(TT / 4); e4 += NT) {
        float sum[4] = {0.f, 0.f, 0.f, 0.f};
        for (int c0 = 0; c0 < n_chunks; c0 += GRAM_F32_BATCH) {
            float4 v[GRAM_F32_BATCH];
#pragma unroll
            for (int c = 0; c < GRAM_F32_BATCH; ++c)
                v[c] = c0 + c < n_chunks ? __ldcg(tile + (c0 + c) * (TT / 4) + e4)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int c = 0; c < GRAM_F32_BATCH; ++c) {
                if (c0 + c < n_chunks) {
                    sum[0] += v[c].x;
                    sum[1] += v[c].y;
                    sum[2] += v[c].z;
                    sum[3] += v[c].w;
                }
            }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) put((4 * e4 + k) / T, (4 * e4 + k) % T, sum[k]);
    }
    if (tid == 0) tickets[tile_id] = 0;
}

// The tile and split of a missing-data Gram launch over n windows (see
// section's note): T rows, split the chunks across blocks or not
struct GramF32Plan {
    int T;
    bool split;
};

inline GramF32Plan gram_f32_plan(int W, int n, int nb, bool can_split) {
    const int top = W > 32 ? GramWide::T : W > 16 ? GramMid::T : GramNarrow::T;
    auto blocks = [&](int T) {
        const long long nt = cdiv(W, T);
        return nt * (nt + 1) / 2 * n;
    };
    for (int T = top; T >= GramNarrow::T; T /= 2)
        if (blocks(T) >= GRAM_F32_BLOCKS) return {T, false};
    if (!can_split) return {GramNarrow::T, false};
    const long long chunks = cdiv(nb, GRAM_CB);
    for (int T = top; T >= GramNarrow::T; T /= 2)
        if (blocks(T) * chunks >= GRAM_F32_BLOCKS) return {T, true};
    return {GramNarrow::T, true};
}

// the upper tiles a window of a split launch: its tickets
inline size_t gram_f32_tiles(int W, int nb) {
    const size_t nt = cdiv(W, gram_f32_plan(W, 1, nb, true).T);
    return nt * (nt + 1) / 2;
}

// floats of the chunk partials a window's split launch writes
inline size_t gram_f32_part_floats(int W, int nb) {
    const GramF32Plan p = gram_f32_plan(W, 1, nb, true);
    return p.split ? gram_f32_tiles(W, nb) * cdiv(nb, GRAM_CB) * p.T * p.T : 0;
}

template <class Tile>
inline int launch_gram_f32_tile(const uint8_t* pk, int nb, const int* order, int W, int n,
                                bool split, const float* mave, const float* mstd, int ld,
                                int by_slot, float* part, int* tickets, float* G,
                                cudaStream_t stream) {
    const int nt = cdiv(W, Tile::T);
    constexpr size_t smem = gram_f32_smem<Tile>();
    // the opt-in counts the static ticket flag too
    HYDRA_CHECK(allow_smem(gram_f32_batch_kernel<Tile>, smem + sizeof(int)));
    gram_f32_batch_kernel<Tile>
        <<<dim3(nt * (nt + 1) / 2, n, split ? cdiv(nb, GRAM_CB) : 1), GRAM_F32_THREADS, smem,
           stream>>>(pk, nb, order, W, mave, mstd, ld, by_slot, part, tickets, G);
    HYDRA_CHECK_LAUNCH();
    return 0;
}

// The missing-data Grams of the n windows order[0 .. n W) into G (n, W, W)
// f32, one launch. part == nullptr: no split (the sweeps, many windows).
// Else (n = 1: gram_f32_part_floats floats; tickets gram_f32_tiles ints,
// zero, and zero again when the launch ends) the chunks may split.
inline int launch_gram_f32(const uint8_t* pk, int nb, const int* order, int W, int n,
                           const float* mave, const float* mstd, int ld, int by_slot,
                           float* part, int* tickets, float* G, cudaStream_t stream) {
    const GramF32Plan p = gram_f32_plan(W, n, nb, part != nullptr);
    auto* const launch = p.T == GramWide::T  ? launch_gram_f32_tile<GramWide>
                         : p.T == GramMid::T ? launch_gram_f32_tile<GramMid>
                                             : launch_gram_f32_tile<GramNarrow>;
    return launch(pk, nb, order, W, n, p.split, mave, mstd, ld, by_slot, part, tickets, G,
                  stream);
}

// The exact sweeps' batched Grams: where window w of a sweep of n_windows
// windows of W (order: the sweep's) starts a batch of gram_batch_windows,
// the Grams of that batch's windows into G (batch, W, W), one launch, else
// nothing. Complete data the raw g g^T, missing data x x^T from the
// statistics at mave[slot * ld], mstd[slot * ld]; neither splits the
// individuals.
inline int launch_gram_batch(const uint8_t* pk, int nb, const int* order, int W, int w,
                             int n_windows, int complete, const float* mave,
                             const float* mstd, int ld, float* G, cudaStream_t stream) {
    const int batch = gram_batch_windows(n_windows, W);
    if (w % batch) return 0;
    const int* order_w = order + static_cast<size_t>(w) * W;
    const int n = n_windows - w < batch ? n_windows - w : batch;
    return complete ? launch_gram_i8(pk, nb, order_w, W, n, nullptr, G, stream)
                    : launch_gram_f32(pk, nb, order_w, W, n, mave, mstd, ld, 1, nullptr,
                                      nullptr, G, stream);
}

// ----------------------------------------------------------- stale draw --
// One row's two stats, the sums of its tile partials pa[t * stride + e] and
// pb[t * stride + e] over t = 0..n_tiles-1: each from 0.f in tile order,
// reduce_tiles' adds, with TILE_BATCH tiles' loads of both in flight before
// their adds (a 2,048-individual tile, so one batch up to N = 65,536).
constexpr int TILE_BATCH = 32;

__device__ __forceinline__ float2 reduce_tile_pair(const float* __restrict__ pa,
                                                   const float* __restrict__ pb,
                                                   int n_tiles, size_t stride, size_t e) {
    float a = 0.f, b = 0.f;
    for (int t0 = 0; t0 < n_tiles; t0 += TILE_BATCH) {
        float va[TILE_BATCH], vb[TILE_BATCH];
#pragma unroll
        for (int j = 0; j < TILE_BATCH; ++j) {
            const bool in = t0 + j < n_tiles;
            va[j] = in ? pa[(t0 + j) * stride + e] : 0.f;
            vb[j] = in ? pb[(t0 + j) * stride + e] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < TILE_BATCH; ++j) {
            if (t0 + j < n_tiles) {
                a += va[j];
                b += vb[j];
            }
        }
    }
    return make_float2(a, b);
}

// One marker's stale draw, shared by stale_draw_kernel and the axpy kernels
// that draw their window themselves (sweep_kernel.cu): num0 from the
// marker's stats s1, s2 (complete data: s1 = sum h*eps, h-decoded as 2 s2 -
// s1) and its mrow row, then the normalized mixture draw of
// _sweep_kernel._sample (hydra_tpu/ops/sweep_kernel.py:733-803): probs
// exp(l - mx) / sm with sm summed in k order, comp = #{cumulative probs u
// exceeds}. The loops run to the compile-time bound KB >= K, guarded by the
// runtime K, so the temporaries stay in registers; the operations and their
// order are those of a loop to K, so every KB >= K gives the same bits.
// The row's loads are all issued before the arithmetic. c1 = dbeta * mstd
// and c2 = -c1 * mave are the window's axpy coefficients.
struct StaleDraw {
    float4 out;                    // bnew, comp, acum0, dbeta
    float c1, c2;
};

template <int KB>
__device__ __forceinline__ StaleDraw stale_draw(const float* __restrict__ row, int K,
                                                float s1, float s2, bool complete,
                                                float i2se, float dNm1) {
    const int km1 = K - 1;
    const int bl = N_FIXED, bi = N_FIXED + K, bs = N_FIXED + 2 * K - 1;
    const float mave = row[0], mstd = row[1], bold = row[2];
    const float u = row[3], nrm = row[4], act = row[5];
    float l[KB], muk[KB - 1], invd[KB - 1], sdk[KB - 1];
    l[0] = row[bl];
#pragma unroll
    for (int j = 0; j < KB - 1; ++j) {
        if (j < km1) {
            l[j + 1] = row[bl + 1 + j];
            invd[j] = row[bi + j];
            sdk[j] = row[bs + j];
        }
    }
    const float s1v = complete ? 2.0f * s2 - s1 : s1;   // h-decode
    const float num0 = mstd * (s1v - mave * s2) + bold * dNm1;
    float mx = l[0];
#pragma unroll
    for (int j = 0; j < KB - 1; ++j) {
        if (j < km1) {
            muk[j] = num0 * invd[j];
            l[j + 1] = l[j + 1] + muk[j] * num0 * i2se;
            mx = fmaxf(mx, l[j + 1]);
        }
    }
    float sm = 0.f;
#pragma unroll
    for (int j = 0; j < KB; ++j) {
        if (j < K) {
            l[j] = expf(l[j] - mx);
            sm = j == 0 ? l[0] : sm + l[j];
        }
    }
    float cum = l[0] / sm;
    const float p0 = cum;
    float compf = u > cum ? 1.f : 0.f;
#pragma unroll
    for (int j = 1; j < KB - 1; ++j) {
        if (j < km1) {
            cum = cum + l[j] / sm;
            compf += u > cum ? 1.f : 0.f;
        }
    }
    float bnz = 0.f;
#pragma unroll
    for (int j = 0; j < KB - 1; ++j)
        if (j < km1 && compf == static_cast<float>(j + 1)) bnz = muk[j] + nrm * sdk[j];
    const float pos = compf > 0.f ? 1.f : 0.f;
    const float bnew = bnz * pos * act;
    const float dbeta = bold - bnew;
    const float c1 = dbeta * mstd;
    return {make_float4(bnew, compf * act, p0 * act + (1.f - act), dbeta), c1, -c1 * mave};
}

// The draw above for K > K_MAX (KB = K_ANY): no register arrays. Each pass
// over the components reads the marker's constants from its row (in L1)
// and recomputes l_j and exp(l_j - mx) by the same operations, rounded one
// at a time (no contraction, as the plain version), so each pass sees the
// values the register arm would hold; the passes, their order and the
// selection are those of stale_draw<KB>.
template <>
__device__ __forceinline__ StaleDraw stale_draw<K_ANY>(const float* __restrict__ row, int K,
                                                       float s1, float s2, bool complete,
                                                       float i2se, float dNm1) {
    const int km1 = K - 1;
    const float* logl = row + N_FIXED;
    const float* invd = row + N_FIXED + K;
    const float* sdk = row + N_FIXED + 2 * K - 1;
    const float mave = row[0], mstd = row[1], bold = row[2];
    const float u = row[3], nrm = row[4], act = row[5];
    const float s1v = complete ? 2.0f * s2 - s1 : s1;   // h-decode
    const float num0 = mstd * (s1v - mave * s2) + bold * dNm1;
    // l_j: logl_0, then logl_j + muk_{j-1} num0 i2se
    auto lj = [&](int j) {
        return j == 0 ? logl[0]
                      : __fadd_rn(logl[j],
                                  __fmul_rn(__fmul_rn(__fmul_rn(num0, invd[j - 1]), num0), i2se));
    };
    float mx = logl[0];
    for (int j = 1; j < K; ++j) mx = fmaxf(mx, lj(j));
    float sm = 0.f;
    for (int j = 0; j < K; ++j) {
        const float e = expf(__fsub_rn(lj(j), mx));
        sm = j == 0 ? e : __fadd_rn(sm, e);
    }
    float cum = __fdiv_rn(expf(__fsub_rn(logl[0], mx)), sm);
    const float p0 = cum;
    float compf = u > cum ? 1.f : 0.f;
    for (int j = 1; j < km1; ++j) {
        cum = __fadd_rn(cum, __fdiv_rn(expf(__fsub_rn(lj(j), mx)), sm));
        compf += u > cum ? 1.f : 0.f;
    }
    float bnz = 0.f;
    const int sel = static_cast<int>(compf) - 1;
    if (sel >= 0) bnz = __fadd_rn(__fmul_rn(num0, invd[sel]), __fmul_rn(nrm, sdk[sel]));
    const float pos = compf > 0.f ? 1.f : 0.f;
    const float bnew = bnz * pos * act;
    const float dbeta = bold - bnew;
    const float c1 = dbeta * mstd;
    return {make_float4(bnew, compf * act, p0 * act + (1.f - act), dbeta), c1, -c1 * mave};
}

// The inputs of a window's stale draw, for an axpy that draws its
// coefficients itself: the stats partials (n_tiles a row), mrow (C columns,
// K components), sc = [1/(2 sigma_e), N - 1, ...], and out (m_loc, 4) per
// slot, which block 0 writes.
struct StaleDrawArgs {
    const float* mrow;
    int C, K;
    const float* part_s1;
    const float* part_s2;
    int n_tiles;
    const float* sc;
    float* out;
};

// Every block draws its window's W markers, marker r on thread r (looping
// by the block's threads), into s_c1[r], s_c2[r], zero from W to W4; the
// caller's barrier follows. The draws need only the window's partials and
// mrow rows, so every block computes the same c1 and c2.
template <int KB>
__device__ __forceinline__ void draw_window(const StaleDrawArgs& dr, const int* order_w, int W,
                                            int W4, bool complete, float* s_c1, float* s_c2) {
    const float i2se = dr.sc[0], dNm1 = dr.sc[1];
    for (int r = threadIdx.x; r < W4; r += blockDim.x) {
        float c1 = 0.f, c2 = 0.f;
        if (r < W) {
            const int slot = order_w[r];
            const float2 s = reduce_tile_pair(dr.part_s1, dr.part_s2, dr.n_tiles, W, r);
            const StaleDraw d = stale_draw<KB>(dr.mrow + static_cast<size_t>(slot) * dr.C,
                                               dr.K, s.x, s.y, complete, i2se, dNm1);
            if (blockIdx.x == 0) reinterpret_cast<float4*>(dr.out)[slot] = d.out;
            c1 = d.c1;
            c2 = d.c2;
        }
        s_c1[r] = c1;
        s_c2[r] = c2;
    }
}

// The h-decode constant 2 sum(c1) + sum(c2) from shared c1[W4], c2[W4],
// float4 at a time, each sum in window order from 0.f: the zeros past W
// leave both sums as they are (a sum that starts at +0 is never -0, and x +
// 0 = x), so this is the sequential sum over the W markers
__device__ __forceinline__ float h_cst4(const float* c1, const float* c2, int W4) {
    const float4* a4 = reinterpret_cast<const float4*>(c1);
    const float4* b4 = reinterpret_cast<const float4*>(c2);
    float a = 0.f, b = 0.f;
#pragma unroll 4
    for (int j = 0; j < W4 / 4; ++j) {
        const float4 x = a4[j], y = b4[j];
        a += x.x;
        b += y.x;
        a += x.y;
        b += y.y;
        a += x.z;
        b += y.z;
        a += x.w;
        b += y.w;
    }
    return 2.0f * a + b;
}

// ----------------------------------------------------------------- axpy --
// eps[i] += d_i with d = sum_r c1_r * g_r + c2_r * m_r over the window's rows
// (coef = [c1[W], c2[W], cst]), individual i's rows added in the order r =
// 0..W-1 by one fmaf each (two for missing data):
//   MODE_MISSING        d = sum c1*g + c2*m (pads decode to g = m = 0)
//   MODE_STALE_COMPLETE d = (cst - sum c1*h) * mask, cst = 2 sum c1 + sum c2
//   MODE_EXACT_COMPLETE d = (sum c1*g + cst) * mask,  cst = sum c2
// A null mask reads as 1 (the standalone window_axpy contract: the caller
// masks). REFRESH (BayesW) also rewrites vi = exp(alpha*eps' - EuMasc) *
// mask in the same pass (BayesW.cpp:1832-1834; alpha = sc[0]; mask is
// required then) and adds its own cst from c1 and c2 (refresh_cst; coef
// holds no cst then). DRAW_KB > 0 (the stale sweeps, sweep_kernel.cu):
// every block first draws the window's c1 and c2 itself (draw_window with
// stale_draw<DRAW_KB>, from the stats partials and mrow rows in dr; block 0
// writes out) and adds its own cst (h_cst4); coef is not read. The draws
// run while the block's rows load, and a stale window takes one launch
// fewer. STANDALONE (window_axpy, sweep_kernel_bw.cu): one launch a call;
// eps is the output d alone, written and not read (eps[i] = 0.f + d, as
// the accumulation into a zeroed vector it replaces); c1 = coef[W] and c2
// = sc[W] are the caller's own vectors (sc carries REFRESH's scalars, of
// which a standalone call has none: the parameters stay those of the
// other instantiations, which a separate c2 parameter slowed, by up to
// 0.16 us a launch on an H100); no mask; complete data forms cst = 2
// sum(c1) itself, in window order from 0.f (the caller adds sum(c2) and
// masks).
//
// Bound: bytes, the W * nb packed bytes, eps read and written and the mask
// (2.21 MB at W=128, N=50,000: 0.66 us at 3.35 TB/s); the rows were just
// read by the window's stats pass, so they come from L2. The design:
//  - a thread per individual (AXPY_THREADS a block, 64 packed bytes of
//    every row): 196 blocks at N=50,000, 1.5 an SM. Its eps and mask are
//    loaded first, beside the rows.
//  - every row's load in flight at once: the block copies its AXPY_ROWS x
//    64-byte tile of packed rows to shared memory, four rows by four bytes
//    a thread, behind one barrier; past AXPY_ROWS rows the next chunk's
//    loads are issued before the current chunk is consumed. A window then
//    costs two L2 round trips (order, rows), not W.
//  - the tile is stored transposed (a 4 x 4 byte transpose in registers),
//    so one shared word holds four consecutive rows of a packed byte: a
//    thread reads it, shifts its crumbs to the bottom of each byte, and
//    each row's crumb becomes a float by one byte permute into 2^23 + c
//    and one subtraction (exact; no quarter-rate integer conversion), then
//    the row's fmaf, with c1 read four rows at a time. The exact-mode tile
//    holds genotype crumbs (geno_crumbs).
//  - up to AXPY_DIRECT rows (W = 1 is the --stale and BayesW default) a
//    thread reads its byte of each row straight from memory: no tile, no
//    barrier.
// WIDE (windows above WIDE_W): the coefficients are staged a chunk of
// AXPY_ROWS rows at a time, behind one more barrier a chunk, so shared
// memory does not grow with W (2 W floats passed 48 KB at W = 6,144 and
// 227 KB at W = 29,000); REFRESH's constant runs over the chunks, in window
// order from 0.f as h_cst4 adds it. The rows, their order and every fmaf
// are the other arms'. No draw (the folded draws stop at STALE_FOLD_MAX_W).
constexpr int AXPY_TB = AXPY_THREADS / 4;    // packed bytes a block
constexpr int AXPY_ROWS = 128;               // rows of a shared tile chunk
constexpr int AXPY_LDW = AXPY_ROWS / 4 + 1;  // words a tile column (a packed byte), padded
constexpr int AXPY_DIRECT = 8;               // up to this W, no shared tile

// byte q of x (a crumb 0..3) as a float, exactly: 2^23 + c - 2^23
__device__ __forceinline__ float byte_float(uint32_t x, int q) {
    return __int_as_float(__byte_perm(x, 0x4B000000u, 0x7540 | q)) - 8388608.0f;
}

// A block's tile of the window's packed rows, for axpy_kernel and
// axpy_mt_kernel (sweep_kernel_mt.cu). Thread tid loads word cw = tid & 15
// (bytes 4cw..4cw+3 of the block's AXPY_TB) of rows 64 g + 4 rg + 0..3 (rg =
// tid >> 4, g = 0, 1) of each AXPY_ROWS-row chunk into registers, every load
// in flight; the constructor issues the first chunk's. stage(tile, r0),
// called for r0 = 0, AXPY_ROWS, ... below W, stores chunk r0 transposed (a 4
// x 4 byte transpose by __byte_perm), so that word j of packed byte bt's
// column, tile[bt * AXPY_LDW + j], holds the chunk's rows 4j..4j+3 (GENO:
// their genotype crumbs, geno_crumbs); behind a barrier it issues the next
// chunk's loads and returns the chunk's words a column. Rows past W are zero
// bytes.
struct AxpyTile {
    const uint8_t* base;
    const int* order_w;
    int nb, W, rg;
    uint32_t nx[2][4];

    __device__ __forceinline__ AxpyTile(const uint8_t* pk, int nb_, const int* order_w_, int W_)
        : base(pk + static_cast<size_t>(blockIdx.x) * AXPY_TB + 4 * (threadIdx.x & 15)),
          order_w(order_w_), nb(nb_), W(W_), rg(threadIdx.x >> 4) {
        fetch(0);
    }

    __device__ __forceinline__ void fetch(int r0) {
#pragma unroll
        for (int g = 0; g < 2; ++g)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int r = r0 + 64 * g + 4 * rg + q;
                nx[g][q] = r < W ? __ldg(reinterpret_cast<const uint32_t*>(
                                       base + static_cast<size_t>(order_w[r]) * nb))
                                 : 0u;
            }
    }

    template <bool GENO>
    __device__ __forceinline__ int stage(uint32_t* tile, int r0) {
        const int cw = threadIdx.x & 15;
        if (r0 > 0) __syncthreads();           // the last chunk consumed
#pragma unroll
        for (int g = 0; g < 2; ++g) {
            // t[c] = byte c of rows 64 g + 4 rg + 0..3
            const uint32_t lo01 = __byte_perm(nx[g][0], nx[g][1], 0x5140);
            const uint32_t hi01 = __byte_perm(nx[g][0], nx[g][1], 0x7362);
            const uint32_t lo23 = __byte_perm(nx[g][2], nx[g][3], 0x5140);
            const uint32_t hi23 = __byte_perm(nx[g][2], nx[g][3], 0x7362);
            const uint32_t t[4] = {
                __byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
            for (int c = 0; c < 4; ++c)
                tile[(4 * cw + c) * AXPY_LDW + 16 * g + rg] = GENO ? geno_crumbs(t[c]) : t[c];
        }
        __syncthreads();
        if (r0 + AXPY_ROWS < W) fetch(r0 + AXPY_ROWS);
        return (min(AXPY_ROWS, W - r0) + 3) >> 2;
    }
};

// BayesW's h-decode constant 2 sum(c1) + sum(c2) of coef = [c1[W], c2[W]],
// each sum in window order from 0.f: its draw kernel spreads a window's
// markers over many blocks, so the axpy that needs the constant adds it
template <bool REFRESH, int MODE>
__device__ __forceinline__ float refresh_cst(const float* c1, const float* c2, int W) {
    if (!REFRESH || MODE != MODE_STALE_COMPLETE) return 0.f;
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int r = 0; r < AXPY_DIRECT; ++r) {
        if (r < W) {
            a += c1[r];
            b += c2[r];
        }
    }
    return 2.0f * a + b;
}

// The same from the axpy's shared c1[W4], c2[W4] (h_cst4)
template <bool REFRESH, int MODE>
__device__ __forceinline__ float refresh_cst4(const float* c1, const float* c2, int W4) {
    if (!REFRESH || MODE != MODE_STALE_COMPLETE) return 0.f;
    return h_cst4(c1, c2, W4);
}

template <bool REFRESH, int MODE, int DRAW_KB = 0, bool STANDALONE = false, bool WIDE = false>
__global__ void __launch_bounds__(AXPY_THREADS)
axpy_kernel(const uint8_t* __restrict__ pk, int nb, const int* __restrict__ order_w, int W,
            const float* __restrict__ coef, const float* __restrict__ mask,
            float* __restrict__ eps, float* __restrict__ vi,
            const float* __restrict__ sc, const StaleDrawArgs dr) {
    constexpr bool DRAW = DRAW_KB > 0;
    static_assert(!(WIDE && DRAW), "the wide arm takes its coefficients from coef");
    // c1[W4], c2[W4] (missing), zero past W; WIDE: a chunk's, AXPY_ROWS each
    extern __shared__ float4 sh_axpy[];
    __shared__ uint32_t tile[AXPY_TB * AXPY_LDW];
    const int W4 = WIDE ? AXPY_ROWS : (W + 3) & ~3;
    float* s_c1 = reinterpret_cast<float*>(sh_axpy);
    float* s_c2 = s_c1 + W4;
    const int tid = threadIdx.x;
    const int i = blockIdx.x * AXPY_THREADS + tid;
    float e = STANDALONE ? 0.f : eps[i];
    const float m = mask != nullptr ? mask[i] : 1.f;
    const int bt = tid >> 2;               // this thread's packed byte (column)
    const int k = tid & 3;                 // and crumb
    float acc = 0.f, cst = 0.f;
    if (!WIDE && W <= AXPY_DIRECT) {
        // few rows: the thread reads its byte of each row straight from
        // memory, all loads in flight; no tile, and no barrier unless the
        // block draws its coefficients
        const uint8_t* col = pk + static_cast<size_t>(blockIdx.x) * AXPY_TB + bt;
        uint32_t bytes[AXPY_DIRECT];
#pragma unroll
        for (int r = 0; r < AXPY_DIRECT; ++r)
            bytes[r] = r < W ? __ldg(col + static_cast<size_t>(order_w[r]) * nb) : 0u;
        const float* c1 = coef;
        const float* c2 = STANDALONE ? sc : coef + W;
        if constexpr (DRAW) {
            draw_window<DRAW_KB>(dr, order_w, W, W4, MODE == MODE_STALE_COMPLETE, s_c1, s_c2);
            __syncthreads();
            c1 = s_c1;
            c2 = s_c2;
            if (MODE == MODE_STALE_COMPLETE) cst = h_cst4(s_c1, s_c2, W4);
        } else if constexpr (STANDALONE) {
            if (MODE == MODE_STALE_COMPLETE) {
                float a = 0.f;       // sum(c1) in window order from 0.f
#pragma unroll
                for (int r = 0; r < AXPY_DIRECT; ++r)
                    if (r < W) a += c1[r];
                cst = 2.0f * a;
            }
        } else {
            cst = refresh_cst<REFRESH, MODE>(coef, coef + W, W);
        }
#pragma unroll
        for (int r = 0; r < AXPY_DIRECT; ++r) {
            if (r >= W) break;
            const uint32_t c = (bytes[r] >> (2 * k)) & 3u;
            // the genotype of crumb c is (0x6 >> 2c) & 3: 2, 1, 0, 0
            if (MODE == MODE_MISSING) {
                acc = fmaf(c1[r], byte_float((0x6u >> (2 * c)) & 3u, 0), acc);
                acc = fmaf(c2[r], c == 3u ? 0.f : 1.f, acc);
            } else {
                acc = fmaf(c1[r], byte_float(MODE == MODE_EXACT_COMPLETE
                                                 ? (0x6u >> (2 * c)) & 3u : c, 0), acc);
            }
        }
    } else {
        if constexpr (!DRAW && !WIDE) {
            for (int r = tid; r < W4; r += AXPY_THREADS) {
                s_c1[r] = r < W ? coef[r] : 0.f;
                if (MODE == MODE_MISSING || REFRESH)
                    s_c2[r] = r < W ? (STANDALONE ? sc[r] : coef[W + r]) : 0.f;
            }
        }
        // the exact-mode tile holds the genotype (coef staged behind stage()'s
        // barrier); rows past W hold 0 bytes and c1 = c2 = 0: fmaf adds an
        // exact 0 to acc (never -0), so whole words of four rows change
        // nothing
        AxpyTile tl(pk, nb, order_w, W);
        // a drawing block's draws run while its first chunk's rows load,
        // and land behind stage()'s barrier
        if constexpr (DRAW)
            draw_window<DRAW_KB>(dr, order_w, W, W4, MODE == MODE_STALE_COMPLETE, s_c1, s_c2);
        const uint32_t* col = tile + bt * AXPY_LDW;
        // STANDALONE complete data: sum(c1) in window order from 0.f, as
        // h_cst4 adds it (the zeros past W change nothing), a second chain
        // beside acc's on the c1 values the row loop reads anyway
        constexpr bool OWN_SUM = STANDALONE && MODE == MODE_STALE_COMPLETE;
        constexpr bool WIDE_CST = WIDE && REFRESH && MODE == MODE_STALE_COMPLETE;
        float c1_sum = 0.f, c2_sum = 0.f;
        for (int r0 = 0; r0 < W; r0 += AXPY_ROWS) {
            if constexpr (WIDE) {
                // the chunk's coefficients, once the last chunk is consumed;
                // stage()'s barriers publish them
                if (r0 > 0) __syncthreads();
                for (int r = tid; r < AXPY_ROWS; r += AXPY_THREADS) {
                    const int rr = r0 + r;
                    s_c1[r] = rr < W ? coef[rr] : 0.f;
                    if (MODE == MODE_MISSING || REFRESH)
                        s_c2[r] = rr < W ? (STANDALONE ? sc[rr] : coef[W + rr]) : 0.f;
                }
            }
            const int nwd = tl.stage<MODE == MODE_EXACT_COMPLETE>(tile, r0);
            const float4* c1 = reinterpret_cast<const float4*>(s_c1 + (WIDE ? 0 : r0));
            const float4* c2 = reinterpret_cast<const float4*>(s_c2 + (WIDE ? 0 : r0));
            if constexpr (WIDE_CST) {
                const int n = min(AXPY_ROWS, W - r0);
                for (int r = 0; r < n; ++r) {
                    c1_sum += s_c1[r];
                    c2_sum += s_c2[r];
                }
            }
#pragma unroll 4
            for (int j = 0; j < nwd; ++j) {
                const uint32_t w = col[j];
                const float4 a = c1[j];
                if (MODE == MODE_MISSING) {
                    const uint32_t g = crumbs_at(geno_crumbs(w), k);
                    const uint32_t mb = crumbs_at(~(w & (w >> 1)) & 0x55555555u, k);
                    const float4 b = c2[j];
                    acc = fmaf(a.x, byte_float(g, 0), acc);
                    acc = fmaf(b.x, byte_float(mb, 0), acc);
                    acc = fmaf(a.y, byte_float(g, 1), acc);
                    acc = fmaf(b.y, byte_float(mb, 1), acc);
                    acc = fmaf(a.z, byte_float(g, 2), acc);
                    acc = fmaf(b.z, byte_float(mb, 2), acc);
                    acc = fmaf(a.w, byte_float(g, 3), acc);
                    acc = fmaf(b.w, byte_float(mb, 3), acc);
                } else {
                    // stale: the raw h; exact: the genotype
                    const uint32_t c = crumbs_at(w, k);
                    acc = fmaf(a.x, byte_float(c, 0), acc);
                    acc = fmaf(a.y, byte_float(c, 1), acc);
                    acc = fmaf(a.z, byte_float(c, 2), acc);
                    acc = fmaf(a.w, byte_float(c, 3), acc);
                    if (OWN_SUM) {
                        c1_sum += a.x;
                        c1_sum += a.y;
                        c1_sum += a.z;
                        c1_sum += a.w;
                    }
                }
            }
        }
        // c1 and c2 staged behind stage()'s barrier
        if (DRAW && MODE == MODE_STALE_COMPLETE)
            cst = h_cst4(s_c1, s_c2, W4);
        else if (WIDE_CST)
            cst = 2.0f * c1_sum + c2_sum;
        else if (OWN_SUM)
            cst = 2.0f * c1_sum;
        else
            cst = refresh_cst4<REFRESH, MODE>(s_c1, s_c2, W4);
    }
    if (MODE == MODE_MISSING) {
        e += acc;
    } else {
        if (!DRAW && !STANDALONE && (!REFRESH || MODE != MODE_STALE_COMPLETE))
            cst = coef[2 * W];
        const float d = MODE == MODE_STALE_COMPLETE ? cst - acc : acc + cst;
        e += d * m;
    }
    eps[i] = e;
    if (REFRESH) vi[i] = expf(__fsub_rn(__fmul_rn(sc[0], e), EULER_MASCHERONI)) * m;
}

// One window's axpy over its W rows order_w[0..W) (nb a multiple of 128);
// above WIDE_W the wide arm.
template <bool REFRESH>
inline int launch_axpy(const uint8_t* pk, int nb, const int* order_w, int W, int mode,
                       const float* coef, const float* mask, float* eps, float* vi,
                       const float* sc, cudaStream_t stream) {
    const bool wide = W > WIDE_W;
    auto* const kernel =
        wide ? (mode == MODE_MISSING ? axpy_kernel<REFRESH, MODE_MISSING, 0, false, true>
                : mode == MODE_STALE_COMPLETE
                    ? axpy_kernel<REFRESH, MODE_STALE_COMPLETE, 0, false, true>
                    : axpy_kernel<REFRESH, MODE_EXACT_COMPLETE, 0, false, true>)
        : mode == MODE_MISSING ? axpy_kernel<REFRESH, MODE_MISSING>
        : mode == MODE_STALE_COMPLETE
            ? axpy_kernel<REFRESH, MODE_STALE_COMPLETE>
            : axpy_kernel<REFRESH, MODE_EXACT_COMPLETE>;
    kernel<<<nb / AXPY_TB, AXPY_THREADS, 2 * sizeof(float) * (wide ? AXPY_ROWS : (W + 3) & ~3),
             stream>>>(pk, nb, order_w, W, coef, mask, eps, vi, sc, StaleDrawArgs{});
    HYDRA_CHECK_LAUNCH();
    return 0;
}

// ------------------------------------------------------ exact recurrence --
// The exact W-step recurrence of one window, shared by exact_draw_kernel
// and window_gibbs_kernel (sweep_kernel.cu) and the multi-trait
// exact_mt_draw_kernel and window_recurrence_mt_kernel (sweep_kernel_mt.cu):
// after marker j's draw, num_i += G(i, j) * dbeta_j, for j = 0..W-1 in
// order.
struct Draw {
    float bnew, compf, pr0, s, dbeta;
    // the outputs comp and acum0, apart because the recurrence's chain
    // needs dbeta alone (acum0 is a division)
    __device__ float comp(float act) const { return compf * act; }
    __device__ float acum(float act) const { return (pr0 / s) * act + (1.f - act); }
};

// One marker of the exact recurrence, given its corrected dot product num:
// the draw of _sweep_exact_kernel.step (hydra_tpu/ops/sweep_kernel.py:
// 452-517) and of window_gibbs (hydra_tpu/ops/gibbs_kernel.py:57-107):
// clamp max(l - mx, -60), unnormalized u*s against the running cum. logl
// (K), invd and sd (K-1) are the marker's mixture constants. The loops run
// to the compile-time bound KB >= K, guarded by k < K - 1 (folded away
// where the caller's K is a constant), so the temporaries stay in
// registers: a loop to the runtime K put them in local memory, on the
// recurrence's serial chain. The component is the number of running sums
// u*s exceeds; they only grow (each term is positive), so the exceeded
// ones are a prefix and the selected component is the last of them, found
// in the same pass: the same choice as the plain version's count-then-
// select, one chain shorter.
template <int KB>
__device__ __forceinline__ Draw exact_draw(float num, const float* logl,
                                           const float* invd, const float* sd,
                                           int K, float u, float nrm, float act,
                                           float bold, float i2se) {
    const int km1 = K - 1;
    const float logl0 = logl[0];
    float mx = logl0;
    float muk[KB - 1], pr[KB - 1];
#pragma unroll
    for (int k = 0; k < KB - 1; ++k) {
        muk[k] = 0.f;
        pr[k] = 0.f;
        if (k < km1) {
            muk[k] = num * invd[k];
            pr[k] = logl[1 + k] + muk[k] * num * i2se;
            mx = fmaxf(mx, pr[k]);
        }
    }
    const float pr0 = expf(fmaxf(logl0 - mx, -60.0f));
    float s = pr0;
#pragma unroll
    for (int k = 0; k < KB - 1; ++k)
        if (k < km1) {
            pr[k] = expf(fmaxf(pr[k] - mx, -60.0f));
            s = s + pr[k];
        }
    const float us = u * s;
    float cum = pr0, compf = 0.f, mu_sel = 0.f, sd_sel = 0.f;
#pragma unroll
    for (int k = 0; k < KB - 1; ++k)
        if (k < km1) {
            const bool over = us > cum;
            compf += over ? 1.f : 0.f;
            mu_sel = over ? muk[k] : mu_sel;
            sd_sel = over ? sd[k] : sd_sel;
            cum = cum + pr[k];
        }
    const float pos = compf > 0.f ? 1.f : 0.f;
    const float bnew = pos * act * (mu_sel + nrm * sd_sel);
    return {bnew, compf, pr0, s, bold - bnew};
}

// exact_draw for K > K_MAX (the K_ANY arms): component k's constants at
// logl[(1 + k) ld], invd[k ld], sd[k ld] (ld = 1 a single-trait row, T a
// multi-trait one), read in each pass over K (L1) instead of held in
// registers; every pass recomputes pr_k by the same operations, rounded one
// at a time (no contraction, as the plain version), so the passes and the
// selection are exact_draw<KB>'s on the same values.
__device__ __forceinline__ float any_pr(float num, const float* logl, const float* invd,
                                        int ld, int k, float i2se) {
    return __fadd_rn(logl[(1 + k) * ld],
                     __fmul_rn(__fmul_rn(__fmul_rn(num, invd[k * ld]), num), i2se));
}

__device__ __forceinline__ Draw exact_draw_any(float num, const float* logl, const float* invd,
                                               const float* sd, int ld, int K, float u,
                                               float nrm, float act, float bold, float i2se) {
    const int km1 = K - 1;
    const float logl0 = logl[0];
    float mx = logl0;
    for (int k = 0; k < km1; ++k) mx = fmaxf(mx, any_pr(num, logl, invd, ld, k, i2se));
    const float pr0 = expf(fmaxf(__fsub_rn(logl0, mx), -60.0f));
    float s = pr0;
    for (int k = 0; k < km1; ++k)
        s = __fadd_rn(s, expf(fmaxf(__fsub_rn(any_pr(num, logl, invd, ld, k, i2se), mx), -60.0f)));
    const float us = __fmul_rn(u, s);
    float cum = pr0, compf = 0.f;
    int sel = -1;
    for (int k = 0; k < km1; ++k) {
        if (us > cum) {
            compf += 1.f;
            sel = k;
        }
        cum = __fadd_rn(cum,
                        expf(fmaxf(__fsub_rn(any_pr(num, logl, invd, ld, k, i2se), mx), -60.0f)));
    }
    const float mu_sel = sel >= 0 ? __fmul_rn(num, invd[sel * ld]) : 0.f;
    const float sd_sel = sel >= 0 ? sd[sel * ld] : 0.f;
    const float pos = compf > 0.f ? 1.f : 0.f;
    const float bnew = __fmul_rn(__fmul_rn(pos, act), __fadd_rn(mu_sel, __fmul_rn(nrm, sd_sel)));
    return {bnew, compf, pr0, s, bold - bnew};
}

// The K_ANY recurrences' constants staged in shared memory. Read in place,
// each lane's pass over K reads its own row: 32 lines a warp a component,
// on the serial chain (4.9 us a step at K = 20, chip_smoke.py phase 4).
// Staged, element e of a marker's 3K - 2 constants (logl 0..K-1, invd
// 0..K-2, sd 0..K-2) of lane l of warp w lies at s[(w (3K - 2) + e) 32 +
// l]: the warp reads 32 consecutive floats a component. Each lane stages
// and reads its own column only, so no barrier. The host adds
// any_stage_bytes to a launch's shared memory where they fit beside the
// recurrence's; a kernel stages where its launch has them (any_staged),
// else reads in place. Same values, same operations: the same draws.
constexpr size_t SMEM_OPTIN = 227 * 1024;   // an H100 block's opt-in maximum

inline size_t any_stage_bytes(int W, int K, size_t base) {
    const size_t b = sizeof(float) * cdiv(W, 32) * 32 * (3 * static_cast<size_t>(K) - 2);
    return K > K_MAX && base + b <= SMEM_OPTIN ? b : 0;
}

// whether this launch's dynamic shared memory holds the staged constants
// after its first `base` floats
__device__ __forceinline__ bool any_staged(int W, int K, int base) {
    unsigned bytes;
    asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(bytes));
    return static_cast<size_t>(bytes) >=
           sizeof(float) * (static_cast<size_t>(base) +
                            static_cast<size_t>((W + 31) >> 5) * 32 * (3 * K - 2));
}

// lane's column dst (stride 32) from its marker's constants
__device__ __forceinline__ void stage_any(float* dst, const float* logl, const float* invd,
                                          const float* sd, int K) {
    for (int k = 0; k < K; ++k) dst[k * 32] = logl[k];
    for (int k = 0; k < K - 1; ++k) {
        dst[(K + k) * 32] = invd[k];
        dst[(2 * K - 1 + k) * 32] = sd[k];
    }
}

// The draw kernels by mixture size: K = 4 (the CLI default) with K a
// compile-time constant, else the register bound 8 or K_MAX on a runtime K,
// and above K_MAX the K_ANY arm (no bound: the constants read from memory).
// The constant pays: at K = 4, exact W=128, N=50,000 on an H100 at 700 W,
// exact_draw_kernel<4, true> took 27.3-27.7 us a window and <8, false>
// 50.6 (chip_smoke.py phase 4, both builds in one run).
template <class F>
inline F* by_components(int K, F* k4, F* k8, F* k16, F* kany) {
    return K == 4 ? k4 : (K <= 8 ? k8 : (K <= K_MAX ? k16 : kany));
}

// The same for the folded stale draws, which run at K <= K_MAX only
template <class F>
inline F* by_components(int K, F* k4, F* k8, F* k16) {
    return by_components(K, k4, k8, k16, k16);
}

// The catch-up of one piece of a window's exact chain (windows above
// WIDE_W markers run their chain as pieces, one launch each): a
// marker of the piece starting at p0 adds elem(j) * db(j) for the earlier
// pieces' steps j = 0..p0-1, in step order and with the fmaf of
// warp_recurrence, before the piece's own recurrence continues the chain.
// So every marker still adds its updates in the order j = 0..W-1, as the
// one-block recurrence and the plain version do.
template <class Elem, class Db>
__device__ __forceinline__ float catch_up(int p0, float num, const Elem& elem, const Db& db) {
#pragma unroll 8
    for (int j = 0; j < p0; ++j) num = fmaf(elem(j), db(j), num);
    return num;
}

// The recurrence's schedule, one block for one window's chain. Bound: the
// serial chain, W dependent draws (each waits for the previous step's
// update), not bytes (the Gram is 64 KB at W=128) nor operations (W^2
// multiply-adds). So everything but the draw is off the chain:
//  - one thread per marker, warp b owns markers 32b..32b+31; warp b runs
//    their 32 steps alone, warp-synchronously: every lane draws its own
//    marker (no divergence), lane j's draw is step j's, __shfl_sync
//    broadcasts its dbeta and every lane applies num = fmaf(G(i, j),
//    dbeta_j, num). No block barrier inside a block's steps, one
//    __syncthreads per 32 steps.
//  - registers, not memory, on the chain: the caller's draw holds the
//    lane's constants in registers (exact_draw<KB>, KB >= K in {4, 8,
//    K_MAX}); the Gram element of each step comes from shared memory,
//    loaded off the chain.
//  - trailing updates: while warp b steps, every later warp w stages its
//    32x32 tile of rows 32b.. (each lane its own marker's elements, copied
//    asynchronously, then standardized by the caller's finish) in shared
//    memory; after the block's barrier it applies the block's 32 updates in
//    step order.
//    So each marker still adds its updates in step order j = 0..W-1 with
//    the same fmaf: the chain is the plain version's.
//  - the diagonal tile a warp steps with is staged by that warp while the
//    previous warp steps (two buffers), so no global load waits on the
//    chain but warp 0's first tile. Every Gram element is staged once.
//  - a ragged last block (W not a multiple of 32) runs W - 32b steps; its
//    missing lanes are present (the block is whole warps) with zero
//    constants and zero tiles, so the full shuffle mask is right.
// Dynamic shared memory: exact_draw_smem bytes, 4 W floats of the
// callers' per-marker arrays (dbeta first) and (W/32 + 2) 32 x 32 tiles:
// 26 KB at W=128, 152 KB at W=1024.
inline size_t exact_draw_smem(int W) {
    const size_t nw = cdiv(W, 32);
    return sizeof(float) * (4 * static_cast<size_t>(W) + (nw + 2) * 32 * 32);
}

// Element (row j, column i) of the window Gram for thread i, standardized
// with thread i's own statistics (mave, mstd, v) and row j's (mj, sj, vj).
__device__ __forceinline__ float std_gram(float g, int complete, float mave, float mstd,
                                          float v, float mj, float sj, float vj,
                                          float n_real) {
    return complete ? (mstd * sj) * (g - mave * vj - v * mj + n_real * (mave * mj)) : g;
}

// Runs the schedule above in a block of cdiv(W, 32) * 32 threads: thread r
// is marker r (live while r < W) with its num before the window's updates;
// src(j) is the address of G(r, j), its marker's element of step j, and
// finish(j, g) standardizes it once it is staged; draw(num) is its
// marker's draw. s_db [W] and tiles [(W/32 + 2) * 32 * 32] are shared
// memory; whatever finish reads in shared memory is written before a
// barrier ahead of the call. Returns the lane's own draw, made at its step.
//
// A tile is staged as 32 asynchronous copies a lane, one wait, then the
// standardization in place: one round trip to L2 a tile, whatever the
// register budget. Staged through registers (8 loads in flight), warp
// b + 1's two tiles took about as long as warp b's 32 steps, so the block's
// barrier waited on them whenever code generation shifted: this function
// so staged ran exact_draw_kernel at 32.6 us per W=128 window, the same
// chain written inline at 25.6 (chip_smoke.py phase 4 through
// scripts/chip_compare.py, NVIDIA H100 80GB HBM3, 700 W).
template <class Src, class Finish, class DrawFn>
__device__ __forceinline__ Draw warp_recurrence(int W, float numv, const Src& src,
                                                const Finish& finish, const DrawFn& draw,
                                                float* s_db, float* tiles) {
    const int r = threadIdx.x, warp = r >> 5, lane = r & 31;
    const int nw = blockDim.x >> 5;
    float* s_tile = tiles + warp * 32 * 32;   // this warp's trailing [32][32]
    float* s_diag = tiles + nw * 32 * 32;     // [2][32][32], warp b's at b & 1
    const bool live = r < W;
    // rows r0.. r0 + 31 of this lane's column to dst[j * 32 + lane]; rows
    // past W (a ragged last block) and dead lanes give 0
    auto fetch = [&](int r0, float* dst) {
#pragma unroll 8
        for (int j = 0; j < 32; ++j) {
            if (live && r0 + j < W)
                cp_async4(dst + j * 32 + lane, src(r0 + j));
            else
                dst[j * 32 + lane] = 0.f;
        }
    };
    auto standardize = [&](int r0, float* dst) {
#pragma unroll 8
        for (int j = 0; j < 32; ++j)
            if (live && r0 + j < W) dst[j * 32 + lane] = finish(r0 + j, dst[j * 32 + lane]);
    };
    if (warp == 0) {
        fetch(0, s_diag);
        cp_async_wait_all();
        standardize(0, s_diag);
    }
    Draw mine{0.f, 0.f, 0.f, 1.f, 0.f};
    for (int b = 0; b < nw; ++b) {
        const int r0 = 32 * b;
        if (warp == b) {
            // every staged element was written by this lane: no barrier
            const float* gd = s_diag + (b & 1) * 32 * 32 + lane;
            const int steps = min(32, W - r0);
#pragma unroll 4
            for (int j = 0; j < steps; ++j) {
                const Draw d = draw(numv);
                if (lane == j) mine = d;
                const float db = __shfl_sync(0xffffffffu, d.dbeta, j);
                numv = fmaf(gd[j * 32], db, numv);
            }
            if (live) s_db[r] = mine.dbeta;
        } else if (warp > b) {
            // this warp's tile of block b (whole: only the last block can be
            // ragged), and warp b + 1 its diagonal tile, while warp b steps
            float* next = s_diag + ((b + 1) & 1) * 32 * 32;
            fetch(r0, s_tile);
            if (warp == b + 1) fetch(r0 + 32, next);
            cp_async_wait_all();
            standardize(r0, s_tile);
            if (warp == b + 1) standardize(r0 + 32, next);
        }
        __syncthreads();
        if (warp > b) {
#pragma unroll 8
            for (int j = 0; j < 32; ++j) numv = fmaf(s_tile[j * 32 + lane], s_db[r0 + j], numv);
        }
    }
    return mine;
}

}  // namespace hydra
