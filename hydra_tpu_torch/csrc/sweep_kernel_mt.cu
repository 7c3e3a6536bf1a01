// Multi-trait BayesRRm kernels for Hopper (sm_90a).
//
// Replaces the Pallas kernels of the JAX package's multi-trait path:
//   hydra_sweep_stale_mt   <- sweep_stale_mt  (hydra_tpu/ops/sweep_kernel_mt.py:214)
//   hydra_sweep_exact_mt   <- sweep_exact_mt  (hydra_tpu/ops/sweep_kernel_mt.py:499)
//   hydra_window_stats_mt  <- window_stats_mt (hydra_tpu/ops/window_kernels.py:451)
//   hydra_window_axpy_mt   <- window_axpy_mt  (hydra_tpu/ops/window_kernels.py:534)
// and runs the exact per-window recurrence of the sampler's per-window path,
// which the JAX package leaves to a lax.scan (hydra_tpu/samplers/
// bayesrrm_mt.py:439-456), as one kernel: hydra_mt_window_recurrence.
//
// Layouts. The residual eps and the trait mask tm are (n_pad, T) f32 in
// individual order (individual i, trait t at i*T + t; crumb k of packed
// byte b is individual 4b + k): no plane-major (4T, NB) rows. mrow is
// (m_loc, T*(3K+4)), column blocks of T (block b, trait t at b*T + t):
//   0 mave, 1 mstd, 2 beta_old, 3 u, 4 nrm, 5 act, 6.. logl_static (K),
//   6+K.. inv_denom_k (K-1), 6+2K-1.. sd_k (K-1)
// as hydra_tpu/ops/sweep_kernel_mt.py:47-56. order (m_loc,) maps sweep
// position -> slot; out (m_loc, 3T) = [beta_new (T), comp (T), acum (T)]
// per SLOT.
//
// A sweep is sweep_kernel.cu's design with a trait axis: the host loops
// over windows and launches per window on one stream, the launch boundary
// being the barrier between phases:
//   stale: stats_mt -> axpy_mt, which draws the window itself  (2 launches;
//          stats_mt -> stale_draw_mt -> axpy_mt above MT_FOLD_MAX_W)
//   exact: stats_mt -> exact_mt_draw -> axpy_mt                       (3)
//          and, at a batch's first window, the batch's Grams in one launch
//          (gram_i8_batch_kernel, sweep_kernel.cuh)
// The exact sweep is valid for complete genotypes and full phenotypes only
// (the trait-shared integer Gram, standardized with trait 0's statistics
// and n_real; hydra_tpu/samplers/bayesrrm_mt.py:748-749 gates it the same).
// On marker shards hydra_sweep_windows_mt runs a range of a sweep's windows
// (one a call), so the caller can add the ranks' summed residual change
// between two windows; the exact Grams stay once a batch.
//
// What bounds it on this card, per window: stats_mt and axpy_mt each read
// the W packed rows and the (n_pad, T) residual once, ~W*NB + 4*T*n_pad*
// (3 for the axpy) bytes -> bytes-bound, but at W=64..128 and N=50,000 a
// window is ~2-4 MB, so each launch is a few dependent memory round trips
// (~1 us of HBM time). They are BayesRRm's stats_kernel and axpy_kernel
// with a trait axis: the stats stage a tile's eps once per block of rows,
// the axpy runs a thread per individual over a shared tile of the rows;
// the decode stays in registers and is shared by the T traits, whose
// accumulators live in registers (T bounded at compile time, mt_by_traits).
// The exact recurrence is a serial
// chain of W steps per trait: one block per trait, each the BayesRRm exact
// draw's warp-synchronous design (warp_recurrence, sweep_kernel.cuh).
//
// Determinism: no atomics (a block owns its Gram tile whole). Partials
// land in per-tile scratch and are reduced in a fixed order, so equal
// inputs give bitwise-equal outputs.

#include <algorithm>
#include <cstdint>

#include "sweep_kernel.cuh"

namespace hydra {

constexpr int MT_STATS_TB = 512;     // packed bytes a stats tile (2,048 individuals)
constexpr int MT_STATS_WARPS = 8;    // warps a stats block
constexpr int MT_STATS_RPW = 2;      // rows a stats warp
constexpr int MT_DRAW_THREADS = 256;

// ---------------------------------------------------------------- stats --
// Per-tile partials of one window's rows r and traits t:
//   MODE_MISSING        s1 = sum g*e, s2 = sum m*e
//   MODE_STALE_COMPLETE s1 = sum h*e (h-decode), s2 = sum e
//   MODE_EXACT_COMPLETE s1 = sum g*e, s2 = sum e, and v = sum g per row
// at part[(tile * W + r) * T + t] and part_v[tile * W + r]. Within a tile,
// lane l of a warp adds its bytes l, l + 32, ..., l + 480 in that order,
// crumbs k = 0..3 inside each (individuals 4 (l + 32 j) + k), one fmaf (or
// add) each, then the warp's xor butterfly; the draw kernels and
// stats_mt_reduce_kernel add the tiles in order.
//
// Bound: bytes, the W * nb packed rows, eps (n_pad, T) once and the
// partials (2.4 MB at W=128, T=4, N=50,000: 0.7 us at 3.35 TB/s), beside
// 2 T W n_pad f32 operations (0.77 us at 67 TFLOP/s). grid (tiles, ceil(W /
// rows a block)); a block covers one tile for MT_STATS_WARPS warps of
// MT_STATS_RPW rows (16 rows: 200 blocks at W=128, N=50,000, 1.5 an SM):
//  - the tile's eps (2,048 x T floats) is copied from memory once per block
//    into shared memory (cp.async, all in flight; T = 16 takes 139 KB), a
//    packed byte's four individuals at TB floats each, TB | 1 float4 a byte
//    (so 8 lanes' 16-byte loads meet 8 distinct bank groups). At step j a
//    lane reads its byte's values by TB 16-byte loads into registers and
//    applies them to all RPW rows of its warp: eps traffic falls by the rows
//    a block, not by row.
//  - a warp loads its rows' packed words (word l + 32 q of the tile to lane
//    l, coalesced) before the block stages eps, so the order -> row round
//    trips and the eps copies are in flight together; step j's byte comes
//    to its lane by one shuffle.
//  - each block prefetches its rows' tile of the next window to L2 (next_w,
//    a hint), so that pass finds them there.
//  - the crumbs decode a byte at a time (geno_crumbs, the mask bits) and
//    become floats by byte_float; v counts genotypes by __popc.
//  - complete data's s2 = sum e is the same for every row: the block's warps
//    share its traits (trait t to warp t mod warps), each adds its own in
//    the lane order above and writes them for every row of the block.
// The accumulators live in registers: T is bounded at compile time by TB in
// {1, 2, 4, 8, 16} (mt_by_traits). More than T_MAX traits run in groups of
// at most T_MAX, a launch each (GROUP, TB = T_MAX): the launch's eps and
// partials start at the group's first trait and keep the stride ld of all
// the traits, and its eps tile is sized by the group. A (row, trait)'s
// partial is the same sum in the same order in any group.
// The register bound TB of T traits (the instantiations of mt_by_traits).
inline int mt_trait_bound(int T) { return T <= 1 ? 1 : T <= 2 ? 2 : T <= 4 ? 4 : T <= 8 ? 8 : 16; }

// Shared memory of the staged eps tile: TB | 1 float4 a packed byte.
inline size_t stats_mt_smem(int T) {
    return sizeof(float4) * MT_STATS_TB * (mt_trait_bound(T) | 1);
}

template <int MODE, int TB, bool GROUP = false>
__global__ void __launch_bounds__(MT_STATS_WARPS * 32)
stats_mt_kernel(const uint8_t* __restrict__ pk, int nb, const float* __restrict__ eps, int T,
                const int* __restrict__ order_w, const int* __restrict__ next_w, int W,
                float* __restrict__ part_s1, float* __restrict__ part_s2,
                float* __restrict__ part_v, int ld_run) {
    const int ld = GROUP ? ld_run : T;     // the traits' stride in eps and the partials
    constexpr int RPW = MT_STATS_RPW;
    constexpr int S4 = TB | 1;             // float4 a packed byte in s_eps4
    extern __shared__ float4 s_eps4[];
    const int tile = blockIdx.x;
    const int b0 = tile * MT_STATS_TB;
    const int nbt = min(MT_STATS_TB, nb - b0);     // a multiple of 128
    const int nj = nbt / 32;                       // steps a lane, 4..16
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nw = blockDim.x >> 5;
    const int rb = blockIdx.y * nw * RPW;          // the block's first row
    const int r0 = rb + warp * RPW;
    // the rows' packed words first: their round trips (order, row) run while
    // the block stages eps
    uint32_t words[RPW][4];
    if (r0 < W) {
#pragma unroll
        for (int p = 0; p < RPW; ++p) {
            const int r = min(r0 + p, W - 1);
            const uint32_t* row = reinterpret_cast<const uint32_t*>(
                pk + static_cast<size_t>(order_w[r]) * nb + b0) + lane;
#pragma unroll
            for (int q = 0; q < 4; ++q) words[p][q] = 4 * q < nj ? __ldg(row + 32 * q) : 0u;
        }
    }
    if (!GROUP && T == TB && (reinterpret_cast<uintptr_t>(eps) & 15) == 0) {
        // a byte's 4T values are T float4 in eps too (a view of eps may
        // start off a 16-byte boundary: then float by float, below)
        const float4* e4 = reinterpret_cast<const float4*>(eps) + static_cast<size_t>(b0) * TB;
        for (int f = threadIdx.x; f < nbt * TB; f += blockDim.x)
            cp_async16(s_eps4 + f + (f / TB) * (S4 - TB), e4 + f);
    } else {
        // individual x of the tile, trait t (slots t >= T feed no output)
        const float* e0 = eps + static_cast<size_t>(b0) * 4 * ld;
        float* const s_eps = reinterpret_cast<float*>(s_eps4);
        for (int x = threadIdx.x; x < 4 * nbt; x += blockDim.x)
            for (int t = 0; t < T; ++t)
                cp_async4(s_eps + (x >> 2) * 4 * S4 + (x & 3) * TB + t, e0 + x * ld + t);
    }
    cp_async_wait_all();
    __syncthreads();
    // the warps that hold rows share complete data's sum e: trait t to warp
    // t mod their count
    const int n_act = min(nw, (W - rb + RPW - 1) / RPW);
    if (r0 >= W) return;
    // the same rows' tile of the next window to L2: lane 4p + l, line l of row r0 + p
    if (next_w != nullptr && lane < 4 * RPW) {
        const int pr = r0 + (lane >> 2), line = lane & 3;
        if (pr < W && 4 * line < nj)
            prefetch_l2(pk + static_cast<size_t>(next_w[pr]) * nb + b0 + 128 * line);
    }
    constexpr int RS = MODE == MODE_MISSING ? RPW : 1;   // s2 accumulators: per row, or shared
    float a[RPW][TB], s[RS][TB];
    int v[RPW];
#pragma unroll
    for (int p = 0; p < RPW; ++p) {
        v[p] = 0;
#pragma unroll
        for (int t = 0; t < TB; ++t) {
            a[p][t] = 0.f;
            if (p < RS) s[p][t] = 0.f;
        }
    }
    bool own[TB];
#pragma unroll
    for (int t = 0; t < TB; ++t) own[t] = MODE != MODE_MISSING && t < T && t % n_act == warp;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        if (j >= nj) break;
        const int bj = lane + 32 * j;
        // individual 4 bj + k, trait t: float k TB + t of the byte's
        float ev[4][TB];
#pragma unroll
        for (int q = 0; q < TB; ++q) {
            const float4 x = s_eps4[bj * S4 + q];
            const float f[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) ev[(4 * q + u) / TB][(4 * q + u) % TB] = f[u];
        }
        if (MODE != MODE_MISSING) {
#pragma unroll
            for (int t = 0; t < TB; ++t)
                if (own[t]) {
#pragma unroll
                    for (int k = 0; k < 4; ++k) s[0][t] += ev[k][t];
                }
        }
        // byte lane + 32 j of the tile: word (lane >> 2) + 8 j, held by lane
        // (lane >> 2) + 8 (j & 3) in its word j >> 2
        const int src = (lane >> 2) + 8 * (j & 3), shift = 8 * (lane & 3);
#pragma unroll
        for (int p = 0; p < RPW; ++p) {
            const uint32_t y = (__shfl_sync(0xffffffffu, words[p][j >> 2], src) >> shift) & 0xffu;
            // stale complete: the raw h; else the genotype crumbs
            const uint32_t x = MODE == MODE_STALE_COMPLETE ? y : geno_crumbs(y) & 0xffu;
            const uint32_t xs = spread_crumbs(x);
            const uint32_t ms = spread_crumbs(~(y & (y >> 1)) & 0x55u);   // 1: not missing
            if (MODE == MODE_EXACT_COMPLETE) v[p] += __popc(x & 0x55u) + 2 * __popc(x & 0xaau);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const float hk = byte_float(xs, k);
                const float mk = byte_float(ms, k);
#pragma unroll
                for (int t = 0; t < TB; ++t) {
                    a[p][t] = fmaf(hk, ev[k][t], a[p][t]);
                    if (MODE == MODE_MISSING) s[p][t] = fmaf(mk, ev[k][t], s[p][t]);
                }
            }
        }
    }
    if (MODE != MODE_MISSING) {
        // this warp's traits of sum e, for every row of the block
        const int nr = min(nw * RPW, W - rb);
#pragma unroll
        for (int t = 0; t < TB; ++t) {
            if (own[t]) {
                const float st = warp_sum(s[0][t]);
                if (lane < nr) part_s2[(static_cast<size_t>(tile) * W + rb + lane) * ld + t] = st;
            }
        }
    }
#pragma unroll
    for (int p = 0; p < RPW; ++p) {
        const int r = r0 + p;
        if (r >= W) break;
        const size_t base = (static_cast<size_t>(tile) * W + r) * ld;
#pragma unroll
        for (int t = 0; t < TB; ++t) {
            if (t < T) {
                const float at = warp_sum(a[p][t]);
                if (lane == 0) part_s1[base + t] = at;
                if (MODE == MODE_MISSING) {
                    const float st = warp_sum(s[p < RS ? p : 0][t]);
                    if (lane == 0) part_s2[base + t] = st;
                }
            }
        }
        if (MODE == MODE_EXACT_COMPLETE) {
            const int vv = warp_sum(v[p]);
            if (lane == 0) part_v[static_cast<size_t>(tile) * W + r] = static_cast<float>(vv);
        }
    }
}

// Kernel instantiations by traits: the register bound TB >= T.
template <class F>
inline F* mt_by_traits(int T, F* t1, F* t2, F* t4, F* t8, F* t16) {
    const int tb = mt_trait_bound(T);
    return tb == 1 ? t1 : tb == 2 ? t2 : tb == 4 ? t4 : tb == 8 ? t8 : t16;
}

template <int MODE>
inline int launch_stats_mt_mode(const uint8_t* pk, int nb, const float* eps, int T,
                                const int* order_w, const int* next_w, int W,
                                float* part_s1, float* part_s2, float* part_v,
                                cudaStream_t stream) {
    const int warps = std::min(MT_STATS_WARPS, cdiv(W, MT_STATS_RPW));
    const dim3 grid(cdiv(nb, MT_STATS_TB), cdiv(W, warps * MT_STATS_RPW));
    if (T > T_MAX) {
        // groups of T_MAX traits, a launch each
        auto* const kernel = stats_mt_kernel<MODE, T_MAX, true>;
        const size_t smem = stats_mt_smem(T_MAX);
        HYDRA_CHECK(allow_smem(kernel, smem));
        for (int t0 = 0; t0 < T; t0 += T_MAX) {
            kernel<<<grid, warps * 32, smem, stream>>>(
                pk, nb, eps + t0, std::min(T_MAX, T - t0), order_w, next_w, W, part_s1 + t0,
                part_s2 + t0, part_v, T);
            HYDRA_CHECK_LAUNCH();
        }
        return 0;
    }
    auto* const kernel = mt_by_traits(T, stats_mt_kernel<MODE, 1>, stats_mt_kernel<MODE, 2>,
                                      stats_mt_kernel<MODE, 4>, stats_mt_kernel<MODE, 8>,
                                      stats_mt_kernel<MODE, 16>);
    const size_t smem = stats_mt_smem(T);
    HYDRA_CHECK(allow_smem(kernel, smem));
    kernel<<<grid, warps * 32, smem, stream>>>(pk, nb, eps, T, order_w, next_w, W, part_s1,
                                               part_s2, part_v, T);
    HYDRA_CHECK_LAUNCH();
    return 0;
}

// One window's stats partials over its rows order_w[0..W); next_w (or
// null) names the next window's rows for the L2 prefetch.
inline int launch_stats_mt(const uint8_t* pk, int nb, const float* eps, int T,
                           const int* order_w, const int* next_w, int W, int mode,
                           float* part_s1, float* part_s2, float* part_v,
                           cudaStream_t stream) {
    auto* const launch = mode == MODE_MISSING ? launch_stats_mt_mode<MODE_MISSING>
                         : mode == MODE_STALE_COMPLETE
                             ? launch_stats_mt_mode<MODE_STALE_COMPLETE>
                             : launch_stats_mt_mode<MODE_EXACT_COMPLETE>;
    return launch(pk, nb, eps, T, order_w, next_w, W, part_s1, part_s2, part_v, stream);
}

// Fixed-order sum over tiles of one (row, trait) partial; e = r * T + t.
__device__ __forceinline__ float reduce_tiles_mt(const float* part, int n_tiles,
                                                 size_t wt, size_t e) {
    float s = 0.f;
    for (int tile = 0; tile < n_tiles; ++tile) s += part[tile * wt + e];
    return s;
}

// window_stats_mt's output: s1, s2 (W, T). Complete data reconstructs
// s1 = 2 sum(e) - sum(h e) and leaves s2 to the caller (per-trait sum(eps)).
__global__ void stats_mt_reduce_kernel(const float* __restrict__ part_s1,
                                       const float* __restrict__ part_s2,
                                       int n_tiles, int W, int T, int complete,
                                       float* __restrict__ s1,
                                       float* __restrict__ s2) {
    const size_t wt = static_cast<size_t>(W) * T;
    const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (e >= wt) return;
    const float a = reduce_tiles_mt(part_s1, n_tiles, wt, e);
    const float b = reduce_tiles_mt(part_s2, n_tiles, wt, e);
    if (complete) {
        s1[e] = 2.0f * b - a;
    } else {
        s1[e] = a;
        s2[e] = b;
    }
}

// ----------------------------------------------------------------- draw --
// One (marker, trait)'s mrow constants, read once into registers: column
// block b of trait t at row[b * T + t], the mixture's to the compile-time
// bound KB >= K (zero past K, and everywhere for a lane past W).
template <int KB>
struct MtMarker {
    float mave = 0.f, mstd = 0.f, bold = 0.f, u = 0.f, nrm = 0.f, act = 0.f;
    float logl[KB] = {}, invd[KB - 1] = {}, sd[KB - 1] = {};

    __device__ __forceinline__ void load(const float* row, int T, int t, int K) {
        mave = row[t];
        mstd = row[T + t];
        bold = row[2 * T + t];
        u = row[3 * T + t];
        nrm = row[4 * T + t];
        act = row[5 * T + t];
#pragma unroll
        for (int k = 0; k < KB; ++k) {
            if (k < K) logl[k] = row[(N_FIXED + k) * T + t];
            if (k < KB - 1 && k < K - 1) {
                invd[k] = row[(N_FIXED + K + k) * T + t];
                sd[k] = row[(N_FIXED + 2 * K - 1 + k) * T + t];
            }
        }
    }
};

// K > K_MAX (KB = K_ANY): the marker's fixed columns in registers, the
// mixture constants read in place (component k at logl[k ld], invd[k ld],
// sd[k ld], ld = T) by the draws' passes over K.
template <>
struct MtMarker<K_ANY> {
    float mave = 0.f, mstd = 0.f, bold = 0.f, u = 0.f, nrm = 0.f, act = 0.f;
    const float* logl = nullptr;
    const float* invd = nullptr;
    const float* sd = nullptr;
    int ld = 1;

    __device__ __forceinline__ void load(const float* row, int T, int t, int K) {
        mave = row[t];
        mstd = row[T + t];
        bold = row[2 * T + t];
        u = row[3 * T + t];
        nrm = row[4 * T + t];
        act = row[5 * T + t];
        logl = row + N_FIXED * T + t;
        invd = row + (N_FIXED + K) * T + t;
        sd = row + (N_FIXED + 2 * K - 1) * T + t;
        ld = T;
    }
};

// The normalized draw of the stale kernel (hydra_tpu/ops/sweep_kernel_mt.py:
// 140-161), which is also the sampler's draw_rows (bayesrrm_mt.py:348-368)
// and the plain draw_normalized: exp(l - mx) unclamped, sm summed in k
// order, probs = p / sm, comp = #{k < K-1 : u > cum_k} with cum_0 = p_0 /
// sm, cum_k = cum_{k-1} + p_k / sm; acum = p_0 / sm * act + (1 - act). The
// same operations in the same order, in registers to the bound KB as
// exact_draw<KB> (sweep_kernel.cuh), whose last-exceeded selection it
// shares (the cums only grow).
template <int KB>
__device__ __forceinline__ Draw normalized_draw(float num, const MtMarker<KB>& c, int K,
                                                float i2se) {
    const int km1 = K - 1;
    const float logl0 = c.logl[0];
    float mx = logl0;
    float muk[KB - 1], pr[KB - 1];
#pragma unroll
    for (int k = 0; k < KB - 1; ++k) {
        muk[k] = 0.f;
        pr[k] = 0.f;
        if (k < km1) {
            muk[k] = num * c.invd[k];
            pr[k] = c.logl[1 + k] + muk[k] * num * i2se;
            mx = fmaxf(mx, pr[k]);
        }
    }
    const float pr0 = expf(logl0 - mx);
    float sm = pr0;
#pragma unroll
    for (int k = 0; k < KB - 1; ++k)
        if (k < km1) {
            pr[k] = expf(pr[k] - mx);
            sm = sm + pr[k];
        }
    float cum = pr0 / sm, compf = 0.f, mu_sel = 0.f, sd_sel = 0.f;
#pragma unroll
    for (int k = 0; k < KB - 1; ++k)
        if (k < km1) {
            if (k > 0) cum = cum + pr[k - 1] / sm;
            const bool over = c.u > cum;
            compf += over ? 1.f : 0.f;
            mu_sel = over ? muk[k] : mu_sel;
            sd_sel = over ? c.sd[k] : sd_sel;
        }
    const float pos = compf > 0.f ? 1.f : 0.f;
    const float bnew = pos * c.act * (mu_sel + c.nrm * sd_sel);
    return {bnew, compf, pr0, sm, c.bold - bnew};
}

// The same draw for K > K_MAX: each pass over K reads the constants in
// place and recomputes pr_k (any_pr, sweep_kernel.cuh) and exp(pr_k - mx)
// by the same operations, rounded one at a time (no contraction, as the
// plain version); the passes and the selection are those above.
__device__ __forceinline__ Draw normalized_draw(float num, const MtMarker<K_ANY>& c, int K,
                                                float i2se) {
    const int km1 = K - 1;
    const float logl0 = c.logl[0];
    float mx = logl0;
    for (int k = 0; k < km1; ++k) mx = fmaxf(mx, any_pr(num, c.logl, c.invd, c.ld, k, i2se));
    auto pe = [&](int k) { return expf(__fsub_rn(any_pr(num, c.logl, c.invd, c.ld, k, i2se), mx)); };
    const float pr0 = expf(__fsub_rn(logl0, mx));
    float sm = pr0;
    for (int k = 0; k < km1; ++k) sm = __fadd_rn(sm, pe(k));
    float cum = __fdiv_rn(pr0, sm), compf = 0.f;
    int sel = -1;
    for (int k = 0; k < km1; ++k) {
        if (k > 0) cum = __fadd_rn(cum, __fdiv_rn(pe(k - 1), sm));
        if (c.u > cum) {
            compf += 1.f;
            sel = k;
        }
    }
    const float mu_sel = sel >= 0 ? __fmul_rn(num, c.invd[sel * c.ld]) : 0.f;
    const float sd_sel = sel >= 0 ? c.sd[sel * c.ld] : 0.f;
    const float pos = compf > 0.f ? 1.f : 0.f;
    const float bnew =
        __fmul_rn(__fmul_rn(pos, c.act), __fadd_rn(mu_sel, __fmul_rn(c.nrm, sd_sel)));
    return {bnew, compf, pr0, sm, c.bold - bnew};
}

// One (marker r, trait t)'s stale draw, shared by stale_draw_mt_kernel and
// the axpy_mt_kernel that draws its window itself: num0 from the row's
// stats partials (e = r * T + t, reduce_tile_pair) and trait t's mrow
// constants, normalized_draw, the outputs to out (write_out), and the
// axpy's coefficients c1 = dbeta * mstd, c2 = -c1 * mave.
template <int KB>
__device__ __forceinline__ float2 stale_draw_mt(const StaleDrawArgs& dr, const int* order_w,
                                                int W, int T, int r, int t, bool complete,
                                                bool write_out) {
    const size_t wt = static_cast<size_t>(W) * T;
    const int slot = order_w[r];
    MtMarker<KB> c;
    c.load(dr.mrow + static_cast<size_t>(slot) * dr.C, T, t, dr.K);
    const float2 s = reduce_tile_pair(dr.part_s1, dr.part_s2, dr.n_tiles, wt,
                                      static_cast<size_t>(r) * T + t);
    const float s1v = complete ? 2.0f * s.y - s.x : s.x;     // h-decode
    const float num0 = c.mstd * (s1v - c.mave * s.y) + c.bold * dr.sc[T + t];
    const Draw d = normalized_draw(num0, c, dr.K, dr.sc[t]);
    if (write_out) {
        float* o = dr.out + static_cast<size_t>(slot) * 3 * T;
        o[t] = d.bnew;
        o[T + t] = d.comp(c.act);
        o[2 * T + t] = d.acum(c.act);
    }
    const float c1 = (c.bold - d.bnew) * c.mstd;
    return make_float2(c1, -c1 * c.mave);
}

// Stale draw: one thread per (marker r, trait t), e = r * T + t; the stale
// sweep folds it into axpy_mt_kernel up to MT_FOLD_MAX_W markers a window
// and launches it alone above.
template <int KB>
__global__ void stale_draw_mt_kernel(const StaleDrawArgs dr, int T,
                                     const int* __restrict__ order_w, int W, int complete,
                                     float* __restrict__ coef) {
    const size_t wt = static_cast<size_t>(W) * T;
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= static_cast<int>(wt)) return;
    const int r = e / T, t = e % T;
    const float2 c = stale_draw_mt<KB>(dr, order_w, W, T, r, t, complete != 0, true);
    coef[static_cast<size_t>(t) * W + r] = c.x;
    coef[wt + static_cast<size_t>(t) * W + r] = c.y;
}

// ----------------------------------------------------------- recurrence --
// The exact W-step recurrence for T traits, in the exact sweep (the
// trait-shared integer Gram) and in the per-window path (an f32 Gram,
// shared (W, W) or per trait (T, W, W)). The traits are independent chains
// that share at most the Gram, so each runs BayesRRm's design alone: grid
// T, block t runs trait t's chain as warp_recurrence (sweep_kernel.cuh;
// cdiv(W, 32) * 32 threads, one per marker, warp-synchronous 32-marker
// blocks, one __syncthreads per 32 steps, the Gram's tiles staged off the
// chain), each lane's trait-t constants in registers (MtMarker<KB>, KB in
// {4, 8, K_MAX} by by_components; above K_MAX, MtMarker<K_ANY> reads them
// in place). The T chains run on T SMs at once; each
// block stages the window's Gram itself, from L2. Each (marker, trait) adds
// G(i, j) * dbeta_j[t] for j = 0..W-1 in order with the same fmaf and
// draws with the plain version's operations in its order. Dynamic shared
// memory: exact_draw_smem(W), laid out as exact_draw_kernel's (dbeta, 3 W
// floats of Gram statistics, the tiles).

// Exact sweep draw. num0 from the stats partials (complete data: s2 = sum
// e per trait), the clamped draw. The raw integer Gram, standardized while
// staged with trait 0's mave, mstd, v = sum g and n_real = sc[2T]
// (sweep_kernel_mt.py:391-399), is symmetric: lane i reads G(i, j) as
// G[j * W + i], coalesced. Every block reads trait 0's statistics for the
// Gram and its own trait's for num0 and the coefficients. K_ANY: the draw
// reads its constants in place (exact_draw_any, stride T). PIECED (windows
// above WIDE_W): exact_draw_kernel's pieces, a launch of grid T each;
// pre = [dbeta (T, W) | mave0 | mstd0 | v (W each)], trait 0's block
// writing the statistics.
template <int KB, bool FIXED, bool PIECED = false>
__global__ void __launch_bounds__(1024)
exact_mt_draw_kernel(const float* __restrict__ mrow, int C, int k_run, int T,
                     const int* __restrict__ order_w, int W,
                     const float* __restrict__ part_s1, const float* __restrict__ part_s2,
                     const float* __restrict__ part_v, int n_tiles,
                     const float* __restrict__ G, const float* __restrict__ sc,
                     float* __restrict__ out, float* __restrict__ coef, int p0_run,
                     float* __restrict__ pre) {
    const int K = FIXED ? KB : k_run;
    const int p0 = PIECED ? p0_run : 0;
    const int Wp = PIECED ? min(WIDE_W, W - p0) : W;   // this launch's markers
    const int t = blockIdx.x, r = threadIdx.x;
    const int i = p0 + r;                 // the lane's window position
    extern __shared__ float sh[];
    float* s_mave = sh + Wp;              // [Wp] trait 0's, for the Gram
    float* s_mstd = sh + 2 * Wp;          // [Wp]
    float* s_v = sh + 3 * Wp;             // [Wp]
    const size_t wt = static_cast<size_t>(W) * T;
    const bool live = r < Wp;
    MtMarker<KB> c;
    int slot = 0;
    float numv = 0.f, mave0 = 0.f, mstd0 = 0.f, v = 0.f;
    if (live) {
        slot = order_w[i];
        const float* row = mrow + static_cast<size_t>(slot) * C;
        c.load(row, T, t, K);
        const size_t e = static_cast<size_t>(i) * T + t;
        const float s1 = reduce_tiles_mt(part_s1, n_tiles, wt, e);
        const float s2 = reduce_tiles_mt(part_s2, n_tiles, wt, e);
        numv = c.mstd * (s1 - c.mave * s2) + c.bold * sc[T + t];
        mave0 = row[0];
        mstd0 = row[T];
        v = reduce_tiles(part_v, n_tiles, W, i);
        s_mave[r] = mave0;
        s_mstd[r] = mstd0;
        s_v[r] = v;
        if (PIECED && t == 0) {
            pre[wt + i] = mave0;
            pre[wt + W + i] = mstd0;
            pre[wt + 2 * W + i] = v;
        }
    } else if constexpr (KB == K_ANY) {
        c.load(mrow, T, t, K);            // a dead lane's draw reads slot 0's constants
    }
    __syncthreads();
    const float n_real = sc[2 * T], i2se = sc[t];
    if constexpr (PIECED) {
        if (live)
            numv = catch_up(
                p0, numv,
                [&](int j) {
                    return std_gram(G[static_cast<size_t>(j) * W + i], 1, mave0, mstd0, v,
                                    pre[wt + j], pre[wt + W + j], pre[wt + 2 * W + j], n_real);
                },
                [&](int j) { return pre[static_cast<size_t>(t) * W + j]; });
    }
    const Draw mine = warp_recurrence(
        Wp, numv, [&](int rj) { return G + static_cast<size_t>(p0 + rj) * W + i; },
        [&](int rj, float g) {
            return std_gram(g, 1, mave0, mstd0, v, s_mave[rj], s_mstd[rj], s_v[rj], n_real);
        },
        [&](float num) {
            if constexpr (KB == K_ANY)
                return exact_draw_any(num, c.logl, c.invd, c.sd, c.ld, K, c.u, c.nrm, c.act,
                                      c.bold, i2se);
            else
                return exact_draw<KB>(num, c.logl, c.invd, c.sd, K, c.u, c.nrm, c.act, c.bold,
                                      i2se);
        },
        sh, sh + 4 * Wp);
    if (live) {
        float* o = out + static_cast<size_t>(slot) * 3 * T;
        o[t] = mine.bnew;
        o[T + t] = mine.comp(c.act);
        o[2 * T + t] = mine.acum(c.act);
        const float c1 = mine.dbeta * c.mstd;
        coef[static_cast<size_t>(t) * W + i] = c1;
        coef[wt + static_cast<size_t>(t) * W + i] = -c1 * c.mave;
        if constexpr (PIECED) pre[static_cast<size_t>(t) * W + i] = mine.dbeta;
    }
}

// The per-window recurrence: num0 (W, T) and a standardized f32 Gram in,
// the sampler's draw_rows form (bayesrrm_mt.py:384-388); out (4, W, T) =
// [beta_new, comp, acum, dbeta]. The per-trait Gram (a masked product) is
// not bitwise symmetric, so lane i reads G(i, j) = G[t][i][j] (row = the
// marker it updates, column = the step), as the plain version's
// gram[:, :, j] and the JAX scan's blocks[..., j]: a row a lane, from L2.
// K_ANY and PIECED as exact_mt_draw_kernel; a piece catches up with the
// earlier pieces' dbeta from out.
template <int KB, bool FIXED, bool SHARED, bool PIECED = false>
__global__ void __launch_bounds__(1024)
window_recurrence_mt_kernel(const float* __restrict__ G, const float* __restrict__ num0,
                            const float* __restrict__ mrow, int C, int k_run, int T,
                            const int* __restrict__ order_w, int W,
                            const float* __restrict__ i2se, float* __restrict__ out,
                            int p0_run) {
    const int K = FIXED ? KB : k_run;
    const int p0 = PIECED ? p0_run : 0;
    const int Wp = PIECED ? min(WIDE_W, W - p0) : W;   // this launch's markers
    const int t = blockIdx.x, r = threadIdx.x;
    const int i = p0 + r;                 // the lane's window position
    extern __shared__ float sh[];
    const bool live = r < Wp;
    MtMarker<KB> c;
    float numv = 0.f;
    if (live) {
        c.load(mrow + static_cast<size_t>(order_w[i]) * C, T, t, K);
        numv = num0[static_cast<size_t>(i) * T + t];
    } else if constexpr (KB == K_ANY) {
        c.load(mrow, T, t, K);            // a dead lane's draw reads row 0's constants
    }
    const float* g_row = G + ((SHARED ? 0 : static_cast<size_t>(t) * W) + i) * W;
    const float i2se_t = i2se[t];
    if constexpr (PIECED) {
        if (live)
            numv = catch_up(p0, numv, [&](int j) { return g_row[j]; }, [&](int j) {
                return out[(3 * static_cast<size_t>(W) + j) * T + t];
            });
    }
    const Draw mine = warp_recurrence(
        Wp, numv, [&](int rj) { return g_row + p0 + rj; }, [](int, float g) { return g; },
        [&](float num) { return normalized_draw(num, c, K, i2se_t); }, sh, sh + 4 * Wp);
    if (live) {
        const size_t wt = static_cast<size_t>(W) * T;
        const size_t e = static_cast<size_t>(i) * T + t;
        out[e] = mine.bnew;
        out[wt + e] = mine.comp(c.act);
        out[2 * wt + e] = mine.acum(c.act);
        out[3 * wt + e] = mine.dbeta;
    }
}

// ----------------------------------------------------------------- axpy --
// out[i*T + t] += d[i, t] * tm[i*T + t] (a null tm reads as 1: the
// standalone window_axpy_mt contract, where the caller adds sum(c2) and
// masks), for individual i and trait t, the window's rows r = 0..W-1 added
// in order by one fmaf each (coef = [c1 (T, W), c2 (T, W)]):
//   COMPLETE d = cst_t - sum_r c1[t, r] * h_r,  cst_t = 2 sum c1 + (add_c2 ?
//            sum c2 : 0), both sums sequential over r (sum c1*g = 2 sum c1 -
//            sum c1*h)
//   else     d = sum_r c1[t, r] * g_r + c2[t, r] * m_r
//
// Bound: bytes, the W * nb packed rows, eps read and written and tm read
// (4.0 MB at W=128, T=4, N=50,000: 1.2 us at 3.35 TB/s; the rows were just
// read by the window's stats pass, so they come from L2), beside 2 T W n_pad
// f32 operations (0.77 us). axpy_kernel's design (sweep_kernel.cuh) with T
// accumulators:
//  - a thread per individual (AXPY_THREADS a block, 64 packed bytes of every
//    row): 196 blocks at N=50,000. Its T eps and tm values are loaded first,
//    beside the rows, and its T accumulators live in registers (T bounded
//    at compile time by TB, mt_by_traits).
//  - every row's load in flight: the block copies its AXPY_ROWS x 64-byte
//    tile of packed rows to shared memory, transposed so that one word
//    holds four rows of a packed byte, the next chunk issued before the
//    current one is consumed (AxpyTile, shared with axpy_kernel). The
//    sampler's windows are W >= 8, so unlike axpy_kernel there is no
//    straight path for a few rows.
//  - c1 and c2 in shared memory, [T][W rounded up to 4], zero past W, read
//    as float4 of four rows; crumbs become floats by byte_float.
//  - cst's sequential sums run on lanes of warp 0 from shared memory, four
//    rows a load, while the rows' loads are in flight. Summed straight from
//    memory, one load a row, they held every block: the exact sweep's axpy
//    took 12.1 us a T=4, W=128 window, 7.7 without (scripts/chip_compare.py,
//    H100 SXM at 700 W).
// With missing genotypes at TB = 16 ptxas spills 56 bytes; one row word a
// loop step removes the spill but ran slower at T = 16 (PERF.md).
// Rows past W hold zero bytes and zero coefficients: fmaf adds an exact 0 to
// an accumulator that is never -0, so whole words of four rows change
// nothing. DRAW_KB > 0 (the stale sweep): every block draws the window's
// W x T coefficients itself (stale_draw_mt<DRAW_KB>, from the stats
// partials and mrow rows in dr; block 0 writes out) while its first chunk
// of rows loads, and coef is not read: one launch fewer a window.
// WIDE (windows above WIDE_W or more than T_MAX traits; TB = T_MAX): the
// launch takes a group of at most T_MAX traits, out, tm and coef starting
// at the group's first trait with the stride ld of all the traits (c2 at
// coef[(ld + t) W + r]), and stages the coefficients a chunk of AXPY_ROWS
// rows at a time behind one more barrier a chunk ([T][AXPY_ROWS] each), so
// shared memory does not grow with W; warp 0's sums run over the chunks,
// in row order from 0.f as above. No draw.
template <bool COMPLETE, int TB, int DRAW_KB = 0, bool WIDE = false>
__global__ void __launch_bounds__(AXPY_THREADS)
axpy_mt_kernel(const uint8_t* __restrict__ pk, int nb, const int* __restrict__ order_w, int W,
               int T, const float* __restrict__ coef, int add_c2,
               const float* __restrict__ tm, float* __restrict__ out,
               const StaleDrawArgs dr, int ld_run) {
    static_assert(!(WIDE && DRAW_KB), "the wide arm takes its coefficients from coef");
    const int ld = WIDE ? ld_run : T;      // the traits' stride in out, tm and coef
    extern __shared__ float4 sh_mt[];      // c1 [T][W4], c2 [T][W4], zero past W
    __shared__ uint32_t tile[AXPY_TB * AXPY_LDW];
    __shared__ float s_sum[2][T_MAX];      // complete: sum c1, sum c2 (or 0)
    const int W4 = WIDE ? AXPY_ROWS : (W + 3) & ~3;
    float* s_c1 = reinterpret_cast<float*>(sh_mt);
    float* s_c2 = s_c1 + T * W4;
    const int tid = threadIdx.x;
    const int k = tid & 3;                 // this thread's crumb of its packed byte
    const size_t i = static_cast<size_t>(blockIdx.x) * AXPY_THREADS + tid;
    float e[TB], mk[TB], acc[TB];
    auto load_eps = [&]() {
#pragma unroll
        for (int t = 0; t < TB; ++t) {
            e[t] = t < T ? out[i * ld + t] : 0.f;
            mk[t] = t < T && tm != nullptr ? tm[i * ld + t] : 1.f;
            acc[t] = 0.f;
        }
    };
    // a drawing block loads its eps and tm after the draw, so they are not
    // live beside the draw's registers (they are first read after the rows)
    if constexpr (DRAW_KB == 0) load_eps();
    AxpyTile tl(pk, nb, order_w, W);       // the first chunk's loads in flight
    if constexpr (DRAW_KB > 0) {
        // the block draws the window's W x T coefficients itself while its
        // rows load, (marker r, trait t) on x = r * T + t as
        // stale_draw_mt_kernel, then the zeros from W to W4
        const int wt = W * T, pad = W4 - W;
        for (int x = tid; x < T * W4; x += AXPY_THREADS) {
            float2 c = make_float2(0.f, 0.f);
            int r, t;
            if (x < wt) {
                r = x / T;
                t = x - r * T;
                c = stale_draw_mt<DRAW_KB>(dr, order_w, W, T, r, t, COMPLETE, blockIdx.x == 0);
            } else {
                t = (x - wt) / pad;
                r = W + (x - wt) - t * pad;
            }
            s_c1[t * W4 + r] = c.x;
            s_c2[t * W4 + r] = c.y;
        }
        load_eps();
    } else if constexpr (!WIDE) {
        for (int x = tid; x < T * W4; x += AXPY_THREADS) {
            const int t = x / W4, r = x - t * W4;
            s_c1[x] = r < W ? coef[t * W + r] : 0.f;
            s_c2[x] = r < W ? coef[(T + t) * W + r] : 0.f;
        }
    }
    if (!WIDE) __syncthreads();
    if (!WIDE && COMPLETE && tid < 32) {
        // lane t: sum c1[t, :], lane 16 + t: sum c2[t, :] (0 unless add_c2),
        // four rows a shared load, the adds in row order
        const int which = tid >> 4, t = tid & 15;
        if (t < T) {
            float a = 0.f;
            if (which == 0 || add_c2) {
                const float4* src = reinterpret_cast<const float4*>(
                    (which ? s_c2 : s_c1) + t * W4);
                const int n4 = W4 / 4, tail = W - 4 * (n4 - 1);
#pragma unroll 4
                for (int j = 0; j < n4 - 1; ++j) {
                    const float4 v = src[j];
                    a += v.x;
                    a += v.y;
                    a += v.z;
                    a += v.w;
                }
                const float4 v = src[n4 - 1];
                a += v.x;
                if (tail > 1) a += v.y;
                if (tail > 2) a += v.z;
                if (tail > 3) a += v.w;
            }
            s_sum[which][t] = a;
        }
    }
    // s_sum is read after stage()'s barrier (WIDE: after the loop's)
    const uint32_t* col = tile + (tid >> 2) * AXPY_LDW;
    float wsum = 0.f;                      // WIDE: lane (which, t)'s running sum
    for (int r0 = 0; r0 < W; r0 += AXPY_ROWS) {
        if constexpr (WIDE) {
            // the chunk's coefficients, once the last chunk is consumed;
            // stage()'s barriers publish them
            if (r0 > 0) __syncthreads();
            for (int x = tid; x < T * AXPY_ROWS; x += AXPY_THREADS) {
                const int t = x / AXPY_ROWS, rr = r0 + x - t * AXPY_ROWS;
                s_c1[x] = rr < W ? coef[static_cast<size_t>(t) * W + rr] : 0.f;
                s_c2[x] = rr < W ? coef[static_cast<size_t>(ld + t) * W + rr] : 0.f;
            }
        }
        const int nwd = tl.stage<false>(tile, r0);
        if (WIDE && COMPLETE && tid < 32) {
            const int which = tid >> 4, t = tid & 15;
            if (t < T && (which == 0 || add_c2)) {
                const float* src = (which ? s_c2 : s_c1) + t * W4;
                const int n = min(AXPY_ROWS, W - r0);
                for (int r = 0; r < n; ++r) wsum += src[r];
            }
        }
#pragma unroll 2
        for (int j = 0; j < nwd; ++j) {
            const uint32_t w = col[j];
            const int rj = (WIDE ? 0 : r0) + 4 * j;
            // row rj + u's crumb as a float: x[u] (stale: h, else g), y[u] (m)
            const uint32_t c = crumbs_at(COMPLETE ? w : geno_crumbs(w), k);
            const uint32_t mb = crumbs_at(~(w & (w >> 1)) & 0x55555555u, k);
            float x[4], y[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                x[u] = byte_float(c, u);
                y[u] = byte_float(mb, u);
            }
#pragma unroll
            for (int t = 0; t < TB; ++t) {
                if (t < T) {
                    const float4 a4 = *reinterpret_cast<const float4*>(s_c1 + t * W4 + rj);
                    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
                    float b[4] = {0.f, 0.f, 0.f, 0.f};
                    if (!COMPLETE) {
                        const float4 b4 = *reinterpret_cast<const float4*>(s_c2 + t * W4 + rj);
                        b[0] = b4.x;
                        b[1] = b4.y;
                        b[2] = b4.z;
                        b[3] = b4.w;
                    }
#pragma unroll
                    for (int u = 0; u < 4; ++u) {
                        acc[t] = fmaf(a[u], x[u], acc[t]);
                        if (!COMPLETE) acc[t] = fmaf(b[u], y[u], acc[t]);
                    }
                }
            }
        }
    }
    if (WIDE && COMPLETE) {
        if (tid < 32 && (tid & 15) < T) s_sum[tid >> 4][tid & 15] = wsum;
        __syncthreads();
    }
#pragma unroll
    for (int t = 0; t < TB; ++t) {
        if (t < T) {
            const float d = COMPLETE ? (2.0f * s_sum[0][t] + s_sum[1][t]) - acc[t] : acc[t];
            out[i * ld + t] = e[t] + d * mk[t];
        }
    }
}

template <bool COMPLETE, int DRAW_KB = 0>
inline int launch_axpy_mt_kind(const uint8_t* pk, int nb, const int* order_w, int W, int T,
                               const float* coef, int add_c2, const float* tm, float* out,
                               const StaleDrawArgs& dr, cudaStream_t stream) {
    // the opt-in counts the static tile too
    constexpr size_t static_smem =
        sizeof(uint32_t) * AXPY_TB * AXPY_LDW + sizeof(float) * 2 * T_MAX;
    if (DRAW_KB == 0 && (W > WIDE_W || T > T_MAX)) {
        // the wide arm, a launch a group of T_MAX traits
        auto* const kernel = axpy_mt_kernel<COMPLETE, T_MAX, 0, true>;
        const size_t smem = sizeof(float) * 2 * T_MAX * AXPY_ROWS;
        HYDRA_CHECK(allow_smem(kernel, smem + static_smem));
        for (int t0 = 0; t0 < T; t0 += T_MAX) {
            kernel<<<nb / AXPY_TB, AXPY_THREADS, smem, stream>>>(
                pk, nb, order_w, W, std::min(T_MAX, T - t0), coef + static_cast<size_t>(t0) * W,
                add_c2, tm == nullptr ? nullptr : tm + t0, out + t0, dr, T);
            HYDRA_CHECK_LAUNCH();
        }
        return 0;
    }
    auto* const kernel = mt_by_traits(
        T, axpy_mt_kernel<COMPLETE, 1, DRAW_KB>, axpy_mt_kernel<COMPLETE, 2, DRAW_KB>,
        axpy_mt_kernel<COMPLETE, 4, DRAW_KB>, axpy_mt_kernel<COMPLETE, 8, DRAW_KB>,
        axpy_mt_kernel<COMPLETE, 16, DRAW_KB>);
    const size_t smem = sizeof(float) * 2 * T * ((W + 3) & ~3);
    HYDRA_CHECK(allow_smem(kernel, smem + static_smem));
    kernel<<<nb / AXPY_TB, AXPY_THREADS, smem, stream>>>(pk, nb, order_w, W, T, coef, add_c2,
                                                         tm, out, dr, T);
    HYDRA_CHECK_LAUNCH();
    return 0;
}

int launch_axpy_mt(const uint8_t* pk, int nb, const int* order_w, int W, int T,
                   const float* coef, int add_c2, int complete, const float* tm,
                   float* out, cudaStream_t stream) {
    return complete ? launch_axpy_mt_kind<true>(pk, nb, order_w, W, T, coef, add_c2, tm, out,
                                                StaleDrawArgs{}, stream)
                    : launch_axpy_mt_kind<false>(pk, nb, order_w, W, T, coef, add_c2, tm, out,
                                                 StaleDrawArgs{}, stream);
}

// The stale sweep folds a window's draw into its axpy up to this many
// markers a window; above it stale_draw_mt_kernel runs as its own launch.
// Every axpy block draws the whole window, W x T draws, so the fold's
// redundant reads grow with W; its axpy's work grows with T as well.
// Device us a window of the folded axpy_mt_kernel against
// stale_draw_mt_kernel + axpy_mt_kernel, N = 50,000
// (chip_smoke.print_stale_fold_times, H100 SXM at 700 W, both in one run):
// W=64 T=1 5.43 vs 8.33, T=4 7.62 vs 10.31, T=16 31.11 vs 34.04; W=128
// T=1 6.79 vs 9.77, T=4 12.88 vs 12.28, T=16 47.28 vs 46.67. At T=1 the
// fold wins at W=128 too, but the multi-trait CLI runs T >= 2 (a phenotype
// file a trait).
// Windows above it are run: BIAS_SWEEP_MT.md's T=3 stale sweep goes to
// W=256. chip_smoke.py holds both sides against the plain version (T=4,
// W=64 and 128).
constexpr int MT_FOLD_MAX_W = 64;

// One stale window's draw and axpy in one launch: axpy_mt_kernel<complete,
// TB, KB> with the draw's bound KB on the mixture size (by_components).
inline int launch_draw_axpy_mt(const uint8_t* pk, int nb, const int* order_w, int W, int T,
                               const StaleDrawArgs& dr, int complete, const float* tm,
                               float* out, cudaStream_t stream) {
    auto* const launch =
        complete ? by_components(dr.K, launch_axpy_mt_kind<true, 4>,
                                 launch_axpy_mt_kind<true, 8>, launch_axpy_mt_kind<true, K_MAX>)
                 : by_components(dr.K, launch_axpy_mt_kind<false, 4>,
                                 launch_axpy_mt_kind<false, 8>,
                                 launch_axpy_mt_kind<false, K_MAX>);
    return launch(pk, nb, order_w, W, T, nullptr, 1, tm, out, dr, stream);
}

// ------------------------------------------------------------ workspace --
struct MtWorkspace {
    float* part_s1;
    float* part_s2;
    float* part_v;
    float* coef;
    float* gram;          // exact: a batch of Grams (gram_batch_windows, W, W)
    float* pre;           // exact above WIDE_W: the pieces' (T + 3) W floats
    size_t bytes;
};

inline MtWorkspace layout_mt(void* base, int m_loc, int nb, int W, int T, bool exact) {
    const size_t n_tiles = cdiv(nb, MT_STATS_TB);
    const size_t wt = static_cast<size_t>(W) * T;
    size_t off = 0;
    MtWorkspace ws{};
    char* p = static_cast<char*>(base);
    auto take = [&](size_t floats) {
        float* out = reinterpret_cast<float*>(p + off);
        off += align256(floats * sizeof(float));
        return out;
    };
    ws.part_s1 = take(n_tiles * wt);
    ws.part_s2 = take(n_tiles * wt);
    ws.part_v = take(n_tiles * W);
    ws.coef = take(2 * wt);
    if (exact)
        ws.gram = take(static_cast<size_t>(gram_batch_windows(m_loc / W, W)) * W * W);
    if (exact && W > WIDE_W) ws.pre = take(wt + 3 * static_cast<size_t>(W));
    ws.bytes = off;
    return ws;
}

inline bool shapes_ok_mt(int nb, int W, int T) {
    return W >= 1 && T >= 1 && nb > 0 && nb % 128 == 0;
}

// The exact recurrence of a window (grid T): one launch, or one a piece of
// WIDE_W markers above it; pre: the pieces' (T + 3) W floats.
inline int launch_exact_mt_draw(const float* mrow, int C, int K, int T, const int* order_w,
                                int W, const float* part_s1, const float* part_s2,
                                const float* part_v, int n_tiles, const float* G,
                                const float* sc, float* out, float* coef, float* pre,
                                cudaStream_t stream) {
    const bool pieced = W > WIDE_W;
    auto* const draw =
        pieced ? by_components(K, exact_mt_draw_kernel<4, true, true>,
                               exact_mt_draw_kernel<8, false, true>,
                               exact_mt_draw_kernel<K_MAX, false, true>,
                               exact_mt_draw_kernel<K_ANY, false, true>)
               : by_components(K, exact_mt_draw_kernel<4, true>, exact_mt_draw_kernel<8, false>,
                               exact_mt_draw_kernel<K_MAX, false>,
                               exact_mt_draw_kernel<K_ANY, false>);
    const size_t smem = exact_draw_smem(pieced ? WIDE_W : W);
    HYDRA_CHECK(allow_smem(draw, smem));
    for (int p0 = 0; p0 < W; p0 += WIDE_W) {
        const int wp = std::min(WIDE_W, W - p0);
        draw<<<T, cdiv(wp, 32) * 32, smem, stream>>>(mrow, C, K, T, order_w, W, part_s1,
                                                     part_s2, part_v, n_tiles, G, sc, out, coef,
                                                     p0, pre);
        HYDRA_CHECK_LAUNCH();
    }
    return 0;
}

// Windows w_begin .. w_end - 1 of a sweep (0 .. m_loc / W for a whole one).
// A sweep run as several ranges runs them in order on one workspace: an
// exact range takes the Grams its batch's first window left there.
int run_sweep_mt(bool exact, const uint8_t* pk, float* eps, const float* tm,
                 const float* mrow, const int* order, const float* sc, float* out,
                 void* ws_base, int m_loc, int nb, int W, int K, int T, int complete,
                 int w_begin, int w_end, cudaStream_t stream) {
    if (!shapes_ok_mt(nb, W, T) || m_loc <= 0 || m_loc % W || K < 2 ||
        tm == nullptr || (exact && !complete) || (exact && 4LL * nb > GRAM_I8_MAX_NPAD) ||
        w_begin < 0 || w_end > m_loc / W || w_begin > w_end)
        return static_cast<int>(cudaErrorInvalidValue);
    const int C = T * (N_FIXED + 3 * K - 2);
    const MtWorkspace ws = layout_mt(ws_base, m_loc, nb, W, T, exact);
    const int n_windows = m_loc / W;
    const int batch = gram_batch_windows(n_windows, W);
    const int n_tiles = cdiv(nb, MT_STATS_TB);
    const int mode = !complete ? MODE_MISSING
                               : (exact ? MODE_EXACT_COMPLETE : MODE_STALE_COMPLETE);
    auto* const stale_draw = by_components(K, stale_draw_mt_kernel<4>, stale_draw_mt_kernel<8>,
                                           stale_draw_mt_kernel<K_MAX>,
                                           stale_draw_mt_kernel<K_ANY>);
    const StaleDrawArgs dr{mrow, C, K, ws.part_s1, ws.part_s2, n_tiles, sc, out};
    const bool fold = !exact && W <= MT_FOLD_MAX_W && K <= K_MAX && T <= T_MAX;
    for (int w = w_begin; w < w_end; ++w) {
        const int* order_w = order + static_cast<size_t>(w) * W;
        const int* next_w = w + 1 < n_windows ? order_w + W : nullptr;
        if (exact) {
            // at a batch's first window, the batch's Grams, ahead of their draws
            const int err = launch_gram_batch(pk, nb, order, W, w, n_windows, 1, nullptr,
                                              nullptr, 0, ws.gram, stream);
            if (err) return err;
        }
        int err = launch_stats_mt(pk, nb, eps, T, order_w, next_w, W, mode, ws.part_s1,
                                  ws.part_s2, ws.part_v, stream);
        if (err) return err;
        if (fold) {
            err = launch_draw_axpy_mt(pk, nb, order_w, W, T, dr, complete, tm, eps, stream);
            if (err) return err;
            continue;
        }
        if (exact) {
            err = launch_exact_mt_draw(mrow, C, K, T, order_w, W, ws.part_s1, ws.part_s2,
                                       ws.part_v, n_tiles,
                                       ws.gram + static_cast<size_t>(w % batch) * W * W, sc,
                                       out, ws.coef, ws.pre, stream);
            if (err) return err;
        } else {
            stale_draw<<<cdiv(static_cast<long long>(W) * T, MT_DRAW_THREADS), MT_DRAW_THREADS,
                         0, stream>>>(dr, T, order_w, W, complete, ws.coef);
            HYDRA_CHECK_LAUNCH();
        }
        err = launch_axpy_mt(pk, nb, order_w, W, T, ws.coef, 1, complete, tm, eps, stream);
        if (err) return err;
    }
    return 0;
}

}  // namespace hydra

extern "C" {

// Bytes of device scratch one sweep of m_loc markers (or one
// window_stats_mt call: m_loc = window, exact = 0) needs.
long long hydra_mt_workspace_bytes(int m_loc, int nb, int window, int n_traits, int exact) {
    if (window < 1 || m_loc < window) return 0;
    return static_cast<long long>(
        hydra::layout_mt(nullptr, m_loc, nb, window, n_traits, exact != 0).bytes);
}

// A whole stale multi-trait sweep. eps (n_pad, T) is updated in place; tm
// (n_pad, T) is the trait mask; out (m_loc, 3T) receives [beta_new, comp,
// acum] per SLOT; sc = [1/(2 sigma_e) (T), dN - 1 (T), n_real].
int hydra_sweep_stale_mt(const void* pk, void* eps, const void* tm, const void* mrow,
                         const void* order, const void* sc, void* out, void* ws,
                         int m_loc, int nb, int window, int n_mix, int n_traits,
                         int complete, void* stream) {
    return hydra::run_sweep_mt(
        false, static_cast<const uint8_t*>(pk), static_cast<float*>(eps),
        static_cast<const float*>(tm), static_cast<const float*>(mrow),
        static_cast<const int*>(order), static_cast<const float*>(sc),
        static_cast<float*>(out), ws, m_loc, nb, window, n_mix, n_traits, complete, 0,
        m_loc / window, static_cast<cudaStream_t>(stream));
}

// A whole exact multi-trait sweep (complete genotypes, full phenotypes);
// same contract.
int hydra_sweep_exact_mt(const void* pk, void* eps, const void* tm, const void* mrow,
                         const void* order, const void* sc, void* out, void* ws,
                         int m_loc, int nb, int window, int n_mix, int n_traits,
                         int complete, void* stream) {
    return hydra::run_sweep_mt(
        true, static_cast<const uint8_t*>(pk), static_cast<float*>(eps),
        static_cast<const float*>(tm), static_cast<const float*>(mrow),
        static_cast<const int*>(order), static_cast<const float*>(sc),
        static_cast<float*>(out), ws, m_loc, nb, window, n_mix, n_traits, complete, 0,
        m_loc / window, static_cast<cudaStream_t>(stream));
}

// Windows w_begin .. w_end - 1 of a stale or exact multi-trait sweep, the
// contract of hydra_sweep_stale_mt / hydra_sweep_exact_mt otherwise: eps is
// updated in place and out receives those windows' slots. A sweep split
// into ranges calls them in window order on one workspace, so an exact
// sweep still launches its Grams once a batch, at the batch's first window.
int hydra_sweep_windows_mt(int exact, const void* pk, void* eps, const void* tm,
                           const void* mrow, const void* order, const void* sc, void* out,
                           void* ws, int m_loc, int nb, int window, int n_mix, int n_traits,
                           int complete, int w_begin, int w_end, void* stream) {
    return hydra::run_sweep_mt(
        exact != 0, static_cast<const uint8_t*>(pk), static_cast<float*>(eps),
        static_cast<const float*>(tm), static_cast<const float*>(mrow),
        static_cast<const int*>(order), static_cast<const float*>(sc),
        static_cast<float*>(out), ws, m_loc, nb, window, n_mix, n_traits, complete, w_begin,
        w_end, static_cast<cudaStream_t>(stream));
}

// s1, s2 (W, T) of the window rows pk[rows[r]] against eps (n_pad, T);
// complete data writes s1 only (s2 is the caller's per-trait sum(eps)).
int hydra_window_stats_mt(const void* pk, const void* eps, const void* rows, void* s1,
                          void* s2, void* ws, int window, int nb, int n_traits,
                          int complete, void* stream) {
    using namespace hydra;
    const int W = window, T = n_traits;
    if (!shapes_ok_mt(nb, W, T) || (!complete && s2 == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const MtWorkspace w = layout_mt(ws, W, nb, W, T, false);
    const int n_tiles = cdiv(nb, MT_STATS_TB);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int err = launch_stats_mt(
        static_cast<const uint8_t*>(pk), nb, static_cast<const float*>(eps), T,
        static_cast<const int*>(rows), nullptr, W,
        complete ? MODE_STALE_COMPLETE : MODE_MISSING, w.part_s1, w.part_s2, w.part_v, st);
    if (err) return err;
    stats_mt_reduce_kernel<<<cdiv(static_cast<long long>(W) * T, 256), 256, 0, st>>>(
        w.part_s1, w.part_s2, n_tiles, W, T, complete, static_cast<float*>(s1),
        static_cast<float*>(s2));
    HYDRA_CHECK_LAUNCH();
    return 0;
}

// out (n_pad, T) += sum_r c1[t, r] G_r + c2[t, r] M_r over the rows
// pk[rows[r]]; coef = [c1 (T, W), c2 (T, W)]. Complete data: the genotype
// part only (the caller adds sum(c2) and masks).
int hydra_window_axpy_mt(const void* pk, const void* rows, const void* coef, void* out,
                         int window, int nb, int n_traits, int complete, void* stream) {
    using namespace hydra;
    if (!shapes_ok_mt(nb, window, n_traits)) return static_cast<int>(cudaErrorInvalidValue);
    return launch_axpy_mt(static_cast<const uint8_t*>(pk), nb,
                          static_cast<const int*>(rows), window, n_traits,
                          static_cast<const float*>(coef), 0, complete, nullptr,
                          static_cast<float*>(out), static_cast<cudaStream_t>(stream));
}

// The exact recurrence of one window: G (W, W) if shared else (T, W, W),
// num0 (W, T), the window's mrow rows mrow[rows[j]], i2se (T,); out (4, W,
// T) = [beta_new, comp, acum, dbeta].
int hydra_mt_window_recurrence(const void* G, const void* num0, const void* mrow,
                               const void* rows, const void* i2se, void* out, int window,
                               int n_mix, int n_traits, int shared, void* stream) {
    using namespace hydra;
    const int W = window, T = n_traits, K = n_mix;
    if (W < 1 || T < 1 || K < 2) return static_cast<int>(cudaErrorInvalidValue);
    const int C = T * (N_FIXED + 3 * K - 2);
    const bool pieced = W > WIDE_W;
    auto* const rec =
        pieced ? (shared ? by_components(K, window_recurrence_mt_kernel<4, true, true, true>,
                                         window_recurrence_mt_kernel<8, false, true, true>,
                                         window_recurrence_mt_kernel<K_MAX, false, true, true>,
                                         window_recurrence_mt_kernel<K_ANY, false, true, true>)
                         : by_components(K, window_recurrence_mt_kernel<4, true, false, true>,
                                         window_recurrence_mt_kernel<8, false, false, true>,
                                         window_recurrence_mt_kernel<K_MAX, false, false, true>,
                                         window_recurrence_mt_kernel<K_ANY, false, false, true>))
        : shared ? by_components(K, window_recurrence_mt_kernel<4, true, true>,
                                 window_recurrence_mt_kernel<8, false, true>,
                                 window_recurrence_mt_kernel<K_MAX, false, true>,
                                 window_recurrence_mt_kernel<K_ANY, false, true>)
                 : by_components(K, window_recurrence_mt_kernel<4, true, false>,
                                 window_recurrence_mt_kernel<8, false, false>,
                                 window_recurrence_mt_kernel<K_MAX, false, false>,
                                 window_recurrence_mt_kernel<K_ANY, false, false>);
    const size_t smem = exact_draw_smem(pieced ? WIDE_W : W);
    HYDRA_CHECK(allow_smem(rec, smem));
    for (int p0 = 0; p0 < W; p0 += WIDE_W) {
        const int wp = std::min(WIDE_W, W - p0);
        rec<<<T, cdiv(wp, 32) * 32, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(G), static_cast<const float*>(num0),
            static_cast<const float*>(mrow), C, K, T, static_cast<const int*>(rows), W,
            static_cast<const float*>(i2se), static_cast<float*>(out), p0);
        HYDRA_CHECK_LAUNCH();
    }
    return 0;
}

const char* hydra_mt_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
