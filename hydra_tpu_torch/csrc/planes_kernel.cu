// Cached decoded-plane kernels for Hopper (sm_90a): BayesRRm's per-window
// branch with --cache-planes on (stale windows, complete genotypes).
//
// Replaces the Pallas kernels of hydra_tpu/ops/planes.py:
//   hydra_window_stats_planes <- window_stats_planes (_stats_kernel)
//   hydra_window_axpy_planes  <- window_axpy_planes  (_axpy_kernel)
//
// The planes are (M, n_pad) int8 genotypes 0/1/2 in INDIVIDUAL order (the
// TPU's flat-deinterleaved layout is not kept); missing genotypes and pad
// individuals are 0. A window's rows are read in place through rows[] (no
// gather). Per window:
//   stats: s1_r = sum_i planes[rows[r], i] * eps_i
//   axpy : d_i  = sum_r c1_r * planes[rows[r], i]  (the genotype part; the
//          caller adds sum(c2) and multiplies by the individual mask)
//
// What bounds them on this card: bytes. Each reads the window's W rows of
// one byte per genotype (4x the packed rows) plus eps or writes d; two
// multiply-adds per genotype are far below the f32 peak. The design reads
// four genotypes per char4 load and four residuals per float4, a warp per
// row and tile in the stats (fixed-order tile partials, no float atomics,
// so equal inputs give bitwise-equal outputs) and a thread per four
// individuals looping over the rows in the axpy.

#include <cstdint>

#include "sweep_kernel.cuh"

namespace hydra {

constexpr int PLANES_TW = 512;     // char4 words (2,048 individuals) per stats tile
constexpr int PLANES_ROWS = 8;     // rows per stats block (one per warp)

// grid (n_tiles, ceil(W / PLANES_ROWS)), 256 threads. Warp = one row over
// one tile; lane reads words w0 + lane + 32j. Partials part[tile * W + row].
__global__ void stats_planes_kernel(const int8_t* __restrict__ planes, int nw,
                                    const float* __restrict__ eps,
                                    const int* __restrict__ rows, int W,
                                    float* __restrict__ part) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = blockIdx.y * PLANES_ROWS + warp;
    if (r >= W) return;
    const int t = blockIdx.x;
    const char4* row = reinterpret_cast<const char4*>(planes)
                       + static_cast<size_t>(rows[r]) * nw;
    const float4* e4 = reinterpret_cast<const float4*>(eps);
    const int w0 = t * PLANES_TW;
    const int w1 = min(w0 + PLANES_TW, nw);
    float a = 0.f;
    for (int wd = w0 + lane; wd < w1; wd += 32) {
        const char4 g = row[wd];
        const float4 e = e4[wd];
        a = fmaf(static_cast<float>(g.x), e.x, a);
        a = fmaf(static_cast<float>(g.y), e.y, a);
        a = fmaf(static_cast<float>(g.z), e.z, a);
        a = fmaf(static_cast<float>(g.w), e.w, a);
    }
    a = warp_sum(a);
    if (lane == 0) part[t * W + r] = a;
}

__global__ void planes_reduce_kernel(const float* __restrict__ part, int n_tiles,
                                     int W, float* __restrict__ s1) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r < W) s1[r] = reduce_tiles(part, n_tiles, W, r);
}

// One thread per char4 word (4 individuals) loops over the window's rows;
// c1 and rows sit in shared memory.
__global__ void axpy_planes_kernel(const int8_t* __restrict__ planes, int nw,
                                   const int* __restrict__ rows, int W,
                                   const float* __restrict__ c1,
                                   float* __restrict__ out) {
    extern __shared__ float sh[];          // c1[W], rows[W]
    float* s_c1 = sh;
    int* s_row = reinterpret_cast<int*>(sh + W);
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
        s_c1[i] = c1[i];
        s_row[i] = rows[i];
    }
    __syncthreads();
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= nw) return;
    const char4* p4 = reinterpret_cast<const char4*>(planes);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < W; ++r) {
        const char4 g = p4[static_cast<size_t>(s_row[r]) * nw + b];
        const float c = s_c1[r];
        acc.x = fmaf(c, static_cast<float>(g.x), acc.x);
        acc.y = fmaf(c, static_cast<float>(g.y), acc.y);
        acc.z = fmaf(c, static_cast<float>(g.z), acc.z);
        acc.w = fmaf(c, static_cast<float>(g.w), acc.w);
    }
    reinterpret_cast<float4*>(out)[b] = acc;
}

inline bool planes_shapes_ok(int W, int n_pad) {
    return W >= 1 && W <= 1024 && n_pad > 0 && n_pad % 512 == 0;
}

}  // namespace hydra

extern "C" {

// Bytes of device scratch one window_stats_planes call needs.
long long hydra_planes_workspace_bytes(int n_pad, int window) {
    using namespace hydra;
    return static_cast<long long>(
        align256(sizeof(float) * static_cast<size_t>(cdiv(n_pad / 4, PLANES_TW)) * window));
}

// s1 (W,) = planes[rows[r]] . eps for the window rows[0..W); eps (n_pad,).
int hydra_window_stats_planes(const void* planes, const void* eps, const void* rows,
                              void* s1, void* ws, int window, int n_pad, void* stream) {
    using namespace hydra;
    if (!planes_shapes_ok(window, n_pad)) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int nw = n_pad / 4;
    const int n_tiles = cdiv(nw, PLANES_TW);
    float* part = static_cast<float*>(ws);
    stats_planes_kernel<<<dim3(n_tiles, cdiv(window, PLANES_ROWS)), PLANES_ROWS * 32, 0,
                          st>>>(static_cast<const int8_t*>(planes), nw,
                                static_cast<const float*>(eps),
                                static_cast<const int*>(rows), window, part);
    HYDRA_CHECK_LAUNCH();
    planes_reduce_kernel<<<cdiv(window, 256), 256, 0, st>>>(part, n_tiles, window,
                                                             static_cast<float*>(s1));
    HYDRA_CHECK_LAUNCH();
    return 0;
}

// out (n_pad,) = sum_r c1_r * planes[rows[r]] over the window rows[0..W).
int hydra_window_axpy_planes(const void* planes, const void* rows, const void* c1,
                             void* out, int window, int n_pad, void* stream) {
    using namespace hydra;
    if (!planes_shapes_ok(window, n_pad)) return static_cast<int>(cudaErrorInvalidValue);
    const int nw = n_pad / 4;
    axpy_planes_kernel<<<cdiv(nw, AXPY_THREADS), AXPY_THREADS, 2 * sizeof(float) * window,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(planes), nw, static_cast<const int*>(rows), window,
        static_cast<const float*>(c1), static_cast<float*>(out));
    HYDRA_CHECK_LAUNCH();
    return 0;
}

const char* hydra_planes_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
