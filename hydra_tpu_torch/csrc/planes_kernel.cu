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
// operations per genotype are far below the f32 peak. So both designs put
// every row byte of a window in flight at once with 16-byte cp.async copies
// into shared memory, and turn a genotype byte into a float exactly by one
// byte permute and one subtraction (byte_float; no quarter-rate integer
// conversion). Both keep the summation order of the first CUDA kernels of
// these two functions (a warp a row and tile, then a second reduction
// kernel; a thread per four individuals), which the plain versions in
// ops/planes.py repeat: equal inputs give bitwise-equal outputs, with no
// float atomics.

#include <cstdint>

#include "sweep_kernel.cuh"

namespace hydra {

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// atomicAdd with release and acquire at device scope: behind a barrier, one
// thread's ticket orders the block's earlier writes before it (cumulative)
// and, for the block that draws the last, the others' before its reads
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
    int old;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
                 : "=r"(old)
                 : "l"(p), "r"(v)
                 : "memory");
    return old;
}

// wait until at most N of this thread's committed cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------------ stats --
// A tile is PLANES_TW char4 words (2,048 individuals). Order of a row's s1:
// lane l of its warp adds the tile's words l + 32 j (j = 0, 1, ...) with
// fmaf over their four genotypes from 0.f, the warp adds its lanes by
// warp_sum's xor butterfly, and the tiles' partials are added in tile order
// from 0.f (reduce_tiles).
//
// One launch a call, grid (tiles, row groups of PLANES_WARPS rows),
// PLANES_THREADS a block, one row a warp:
//  - the block copies the tile's eps (8 KB) and each warp its row's tile
//    segment (2 KB) to shared memory with 16-byte cp.async copies, every
//    copy in flight behind one wait and one barrier. A warp's float4 reads
//    of eps at l + 32 j fall on 32 consecutive float4 (each quarter warp on
//    128 consecutive bytes), so no swizzle is needed.
//  - each block writes its rows' tile partials part[t * W + r] and, behind
//    a barrier, takes a ticket on its row group's counter (one thread's
//    acquire-release atomic); the block that draws the last ticket copies
//    the group's partials to shared memory (through L2, __ldcg; all loads
//    in flight), adds each row's in tile order, writes s1 and sets the
//    counter back to 0. The counters live in the caller's workspace,
//    zeroed once when it is allocated.
// Two rows a warp (staged or in registers) and the same kernel without the
// ticket followed by a reduction kernel were timed against this design and
// not kept (PERF.md, findings of the planes kernels).
constexpr int PLANES_TW = 512;      // char4 words (2,048 individuals) a tile
constexpr int PLANES_WARPS = 8;     // warps (rows) a stats block
constexpr int PLANES_THREADS = PLANES_WARPS * 32;
// counters: a launch takes at most PLANES_MAX_W rows; a window above runs
// as launches of PLANES_MAX_W rows (each row's s1 is its own sums alone)
constexpr int PLANES_MAX_W = 1024;
constexpr int PLANES_GROUPS = PLANES_MAX_W / PLANES_WARPS;
constexpr int PLANES_TICKET_BYTES = 256 * ((sizeof(int) * PLANES_GROUPS + 255) / 256);

__global__ void __launch_bounds__(PLANES_THREADS)
stats_planes_kernel(const int8_t* __restrict__ planes, int nw, const float* __restrict__ eps,
                    const int* __restrict__ rows, int W, float* __restrict__ part,
                    int* __restrict__ tickets, float* __restrict__ s1) {
    __shared__ float4 s_e[PLANES_TW];
    __shared__ uint32_t s_g[PLANES_WARPS * PLANES_TW];
    __shared__ bool s_last;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int t = blockIdx.x, w0 = t * PLANES_TW;
    const int tw = min(PLANES_TW, nw - w0);      // 128, 256, 384 or 512 words
    const int nj = tw >> 5;                      // words a lane
    const int g0 = blockIdx.y * PLANES_WARPS;    // the block's first row
    const int r = g0 + warp;                     // the warp's row
    const bool busy = r < W;
    // the row's slot first, then eps' copies (which need no slot) while
    // the slot loads, then the row's own
    const int slot = busy ? __ldg(rows + r) : 0;
    const float4* e4 = reinterpret_cast<const float4*>(eps) + w0;
    for (int f = tid; f < tw; f += PLANES_THREADS) cp_async16(s_e + f, e4 + f);
    uint32_t* g_w = s_g + warp * PLANES_TW;
    if (busy) {
        const uint32_t* row = reinterpret_cast<const uint32_t*>(
            planes + static_cast<size_t>(slot) * (4 * static_cast<size_t>(nw))) + w0;
        for (int k = lane; k < (tw >> 2); k += 32) cp_async16(g_w + 4 * k, row + 4 * k);
    }
    cp_async_wait_all();
    __syncthreads();
    if (busy) {
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            if (j >= nj) break;
            const float4 e = s_e[lane + 32 * j];
            const uint32_t g = g_w[lane + 32 * j];
            a = fmaf(byte_float(g, 0), e.x, a);
            a = fmaf(byte_float(g, 1), e.y, a);
            a = fmaf(byte_float(g, 2), e.z, a);
            a = fmaf(byte_float(g, 3), e.w, a);
        }
        const float v = warp_sum(a);
        if (lane == 0) part[static_cast<size_t>(t) * W + r] = v;
    }
    __syncthreads();
    if (tid == 0)
        s_last = atomic_add_acq_rel(tickets + blockIdx.y, 1) == static_cast<int>(gridDim.x) - 1;
    __syncthreads();
    if (!s_last) return;
    // the group's partials to shared memory (eps' tile is free now), every
    // load in flight, STAGE_TILES tiles at a time; then thread p adds row
    // p's in tile order
    float* s_p = reinterpret_cast<float*>(s_e);
    constexpr int STAGE_TILES = 4 * PLANES_TW / PLANES_WARPS;
    const int n_tiles = gridDim.x;
    float s = 0.f;
    for (int u0 = 0; u0 < n_tiles; u0 += STAGE_TILES) {
        const int nu = min(STAGE_TILES, n_tiles - u0);
        if (u0 > 0) __syncthreads();
        for (int k = tid; k < nu * PLANES_WARPS; k += PLANES_THREADS) {
            const int rk = g0 + k % PLANES_WARPS;
            s_p[k] = rk < W ? __ldcg(part + static_cast<size_t>(u0 + k / PLANES_WARPS) * W + rk)
                            : 0.f;
        }
        __syncthreads();
        if (tid < PLANES_WARPS) {
#pragma unroll 8
            for (int u = 0; u < nu; ++u) s += s_p[u * PLANES_WARPS + tid];
        }
    }
    if (tid < PLANES_WARPS && g0 + tid < W) s1[g0 + tid] = s;
    if (tid == 0) tickets[blockIdx.y] = 0;
}

// ------------------------------------------------------------------- axpy --
// Each individual's chain: acc = fmaf(c1[r], g[r][i], acc) for r = 0..W-1
// in window order, from 0.f. A thread per individual, AXPY_THREADS a block
// (196 blocks at N=50,000):
//  - past AXPY_DIRECT rows the block copies its 256-byte segment of each
//    row of a chunk of AXPY_ROWS rows (32 KB) to shared memory with
//    16-byte cp.async copies, all in flight (the rows' slots loaded first,
//    together); the next chunk's copies are in flight while a chunk is
//    consumed (PLANES_STAGES buffers), so a window costs a few round trips
//    to memory, not W. Deeper pipelines and smaller chunks timed no
//    faster at W=64, the main path's. c1 waits in shared memory (zero past
//    W, read four rows at a time; a row past W adds fmaf(0, finite, acc) =
//    acc, never -0).
//  - a thread reads the word holding its genotype byte of each row of the
//    chunk (a quarter warp's reads fall on one word), turns the byte into
//    a float exactly (byte_float) and runs the row's fmaf;
//  - up to AXPY_DIRECT rows a thread reads its byte of each row straight
//    from memory, all loads in flight: no tile, no barrier.
// WIDE (windows above WIDE_W): c1 is not staged (W floats of shared memory
// passed 227 KB beside the buffers at W = 41,000); every thread reads a
// chunk's four coefficients at a time from memory (the same addresses for
// the block: L1), zero past W. The rows, their order and every fmaf are the
// other arm's.
constexpr int PLANES_AXPY_WORDS = AXPY_THREADS / 4;   // words of a row a block
constexpr int PLANES_COPIERS = AXPY_THREADS / 16;     // rows a pass of the block's copies
constexpr int PLANES_STAGES = 2;                      // chunk buffers

// rows of one chunk buffer: the window's (rounded up to 4) up to a chunk
__host__ __device__ inline int axpy_planes_buffer_rows(int W) {
    return min((W + 3) & ~3, AXPY_ROWS);
}

// dynamic shared memory: c1 (not WIDE), and a buffer a stage up to the
// window's chunks
inline size_t axpy_planes_smem(int W) {
    const int buffers = W <= AXPY_DIRECT ? 0 : min(PLANES_STAGES, cdiv(W, AXPY_ROWS));
    return sizeof(float) * (W > WIDE_W ? 0 : (W + 3) & ~3) +
           sizeof(uint32_t) * buffers * axpy_planes_buffer_rows(W) * PLANES_AXPY_WORDS;
}

template <bool WIDE = false>
__global__ void __launch_bounds__(AXPY_THREADS)
axpy_planes_kernel(const int8_t* __restrict__ planes, int n_pad, const int* __restrict__ rows,
                   int W, const float* __restrict__ c1, float* __restrict__ out) {
    extern __shared__ float4 sh_planes[];   // c1[W4] (not WIDE), then the chunk buffers
    const int tid = threadIdx.x;
    const int i = blockIdx.x * AXPY_THREADS + tid;
    const uint8_t* pl = reinterpret_cast<const uint8_t*>(planes);
    float acc = 0.f;
    if (!WIDE && W <= AXPY_DIRECT) {
        uint32_t g[AXPY_DIRECT];
#pragma unroll
        for (int r = 0; r < AXPY_DIRECT; ++r)
            g[r] = r < W ? __ldg(pl + static_cast<size_t>(__ldg(rows + r)) * n_pad + i) : 0u;
#pragma unroll
        for (int r = 0; r < AXPY_DIRECT; ++r) {
            if (r >= W) break;
            acc = fmaf(__ldg(c1 + r), byte_float(g[r], 0), acc);
        }
    } else {
        const int W4 = WIDE ? 0 : (W + 3) & ~3;
        float* s_c1 = reinterpret_cast<float*>(sh_planes);
        uint32_t* tile = reinterpret_cast<uint32_t*>(s_c1 + W4);
        const int buf_words = axpy_planes_buffer_rows(W) * PLANES_AXPY_WORDS;
        const int n_chunks = (W + AXPY_ROWS - 1) / AXPY_ROWS;
        // thread tid copies 16-byte piece tid & 15 of rows tid >> 4, + 16, ...
        const uint8_t* src = pl + static_cast<size_t>(blockIdx.x) * AXPY_THREADS + 16 * (tid & 15);
        constexpr int PER = AXPY_ROWS / PLANES_COPIERS;    // rows a thread copies a chunk
        // chunk c's copies into buffer c mod PLANES_STAGES, one commit group
        // a chunk (an empty group past the last, so the waits count alike)
        const auto load_chunk = [&](int c) {
            if (c < n_chunks) {
                const int r0 = c * AXPY_ROWS, nr = min(AXPY_ROWS, W - r0);
                uint32_t* buf = tile + (c % PLANES_STAGES) * buf_words;
                int slot[PER];
#pragma unroll
                for (int k = 0; k < PER; ++k) {
                    const int rr = (tid >> 4) + k * PLANES_COPIERS;
                    slot[k] = rr < nr ? __ldg(rows + r0 + rr) : 0;
                }
#pragma unroll
                for (int k = 0; k < PER; ++k) {
                    const int rr = (tid >> 4) + k * PLANES_COPIERS;
                    if (rr < nr)
                        cp_async16(buf + rr * PLANES_AXPY_WORDS + 4 * (tid & 15),
                                   src + static_cast<size_t>(slot[k]) * n_pad);
                }
            }
            cp_async_commit();
        };
#pragma unroll
        for (int c = 0; c < PLANES_STAGES - 1; ++c) load_chunk(c);
        if constexpr (!WIDE)
            for (int r = tid; r < W4; r += AXPY_THREADS) s_c1[r] = r < W ? c1[r] : 0.f;
        const int col = tid >> 2, q = tid & 3;
        for (int c = 0; c < n_chunks; ++c) {
            load_chunk(c + PLANES_STAGES - 1);    // its buffer was consumed at c - 1
            cp_async_wait_group<PLANES_STAGES - 1>();
            __syncthreads();
            const int r0 = c * AXPY_ROWS;
            const uint32_t* w = tile + (c % PLANES_STAGES) * buf_words + col;
            const float4* c4 = reinterpret_cast<const float4*>(s_c1 + r0);
            const int n4 = (min(AXPY_ROWS, W - r0) + 3) >> 2;
#pragma unroll 4
            for (int j = 0; j < n4; ++j) {
                float4 a;
                if constexpr (WIDE) {
                    const int rr = r0 + 4 * j;
                    a = make_float4(__ldg(c1 + rr), rr + 1 < W ? __ldg(c1 + rr + 1) : 0.f,
                                    rr + 2 < W ? __ldg(c1 + rr + 2) : 0.f,
                                    rr + 3 < W ? __ldg(c1 + rr + 3) : 0.f);
                } else {
                    a = c4[j];
                }
                const uint32_t* wj = w + 4 * j * PLANES_AXPY_WORDS;
                acc = fmaf(a.x, byte_float(wj[0], q), acc);
                acc = fmaf(a.y, byte_float(wj[PLANES_AXPY_WORDS], q), acc);
                acc = fmaf(a.z, byte_float(wj[2 * PLANES_AXPY_WORDS], q), acc);
                acc = fmaf(a.w, byte_float(wj[3 * PLANES_AXPY_WORDS], q), acc);
            }
            // this buffer is refilled by the load of chunk c + PLANES_STAGES
            if (c + PLANES_STAGES < n_chunks) __syncthreads();
        }
    }
    out[i] = acc;
}

inline bool planes_shapes_ok(int W, int n_pad) {
    return W >= 1 && n_pad > 0 && n_pad % 512 == 0;
}

}  // namespace hydra

extern "C" {

// Bytes of device workspace a window_stats_planes call needs: the row
// groups' ticket counters (which the kernel leaves at 0; zero them once)
// and the tile partials of a launch (at most PLANES_MAX_W rows).
long long hydra_planes_workspace_bytes(int n_pad, int window) {
    using namespace hydra;
    const int w = window < PLANES_MAX_W ? window : PLANES_MAX_W;
    return PLANES_TICKET_BYTES +
           static_cast<long long>(align256(
               sizeof(float) * static_cast<size_t>(cdiv(n_pad / 4, PLANES_TW)) * w));
}

// s1 (W,) = planes[rows[r]] . eps for the window rows[0..W); eps (n_pad,);
// ws: hydra_planes_workspace_bytes, its counters at 0. One launch.
int hydra_window_stats_planes(const void* planes, const void* eps, const void* rows,
                              void* s1, void* ws, int window, int n_pad, void* stream) {
    using namespace hydra;
    if (!planes_shapes_ok(window, n_pad)) return static_cast<int>(cudaErrorInvalidValue);
    const int nw = n_pad / 4;
    int* tickets = static_cast<int*>(ws);
    float* part = reinterpret_cast<float*>(static_cast<char*>(ws) + PLANES_TICKET_BYTES);
    for (int r0 = 0; r0 < window; r0 += PLANES_MAX_W) {
        const int w = window - r0 < PLANES_MAX_W ? window - r0 : PLANES_MAX_W;
        stats_planes_kernel<<<dim3(cdiv(nw, PLANES_TW), cdiv(w, PLANES_WARPS)), PLANES_THREADS,
                              0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int8_t*>(planes), nw, static_cast<const float*>(eps),
            static_cast<const int*>(rows) + r0, w, part, tickets,
            static_cast<float*>(s1) + r0);
        HYDRA_CHECK_LAUNCH();
    }
    return 0;
}

// out (n_pad,) = sum_r c1_r * planes[rows[r]] over the window rows[0..W).
int hydra_window_axpy_planes(const void* planes, const void* rows, const void* c1,
                             void* out, int window, int n_pad, void* stream) {
    using namespace hydra;
    if (!planes_shapes_ok(window, n_pad)) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = axpy_planes_smem(window);
    auto* const kernel = window > WIDE_W ? axpy_planes_kernel<true> : axpy_planes_kernel<false>;
    HYDRA_CHECK(allow_smem(kernel, smem));
    kernel<<<n_pad / AXPY_THREADS, AXPY_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(planes), n_pad, static_cast<const int*>(rows), window,
        static_cast<const float*>(c1), static_cast<float*>(out));
    HYDRA_CHECK_LAUNCH();
    return 0;
}

const char* hydra_planes_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
