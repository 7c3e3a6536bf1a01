// BayesRRm whole-sweep kernels for Hopper (sm_90a): stale and exact windows.
//
// Replaces the Pallas mega-kernels of hydra_tpu/ops/sweep_kernel.py and the
// per-window kernels of the single-trait per-window branch:
//   hydra_sweep_stale  <- sweep_stale  (_sweep_kernel)
//   hydra_sweep_exact  <- sweep_exact  (_sweep_exact_kernel)
//   hydra_window_stats <- window_stats (hydra_tpu/ops/window_kernels.py)
//   hydra_window_gibbs <- window_gibbs (hydra_tpu/ops/gibbs_kernel.py)
//   hydra_sweep_stale_sd <- sweep_stale_sd (_sweep_sd_kernel, the
//                           single-decode stale sweep)
//   hydra_sweep_windows  a range of the stale or exact sweep's windows, for
//                        marker shards that sum the residual's change
//                        across ranks after each window
//
// What they compute, per window of W markers (slots order[w*W .. w*W+W)):
//   stats : s1 = sum g*eps, s2 = sum m*eps over all individuals
//   gram  : (exact) the window Gram of standardized genotypes
//   draw  : the mixture/beta draw of every marker from its mrow row
//           (stale: all W at once, inside the axpy's launch; exact: the
//           W-step sequential recurrence num_j = num0_j + sum_{k<j}
//           dbeta_k * G_jk)
//   axpy  : eps += sum_r c1_r * g_r + c2_r * m_r (axpy_kernel, shared with
//           the BayesW sweep in sweep_kernel.cuh)
//
// Design. On the TPU the grid (window, phase, tile) runs in order on one
// core with eps resident in VMEM. Here blocks run in parallel and in no
// order, so every phase of every window is its own launch on the caller's
// stream, and the launch boundary is the barrier between stats -> draw ->
// axpy. The window loop runs on the host; the slot permutation is read on
// the device (order[]), so a sweep never syncs with the host.
//
// What bounds it on this card: every window reads its W packed rows twice
// (stats, axpy) plus once more in the exact Gram, and the exact draw is a
// serial chain of W steps in one block; each launch is a few dependent
// memory round trips more than its bytes. The design keeps the decode in
// registers (no decoded planes in memory); the stats pass stages each
// 2,048-individual eps tile once per 16 rows and prefetches the next
// window's rows to L2 (stats_kernel); the axpy runs a thread per individual
// over a shared tile of the window's rows, every row's load in flight
// (axpy_kernel, sweep_kernel.cuh); the recurrence runs warp-synchronously
// out of shared memory (exact_draw_kernel). A window's Gram depends on its
// rows and their statistics alone, not on eps, so the exact sweep computes
// a batch of windows' Grams (gram_batch_windows) in one launch at the
// batch's first window, off the windows' chain: the complete-data Grams on
// the int8 tensor cores (gram_i8_batch_kernel), the missing-data Grams as
// fmaf chains over the symmetric half (gram_f32_batch_kernel). A stale
// window's draw runs inside its axpy (every axpy block draws the window),
// so it takes 2 launches; an exact one 3, plus one a batch. The host's
// enqueue of these launches is left for a later change.
//
// Determinism: no float atomics (window_stats' split complete Gram's are
// integer, exact in any order). Partial sums land in per-tile or per-chunk scratch and are
// reduced in a fixed order, so equal inputs give bitwise-equal outputs.

#include <cstdint>

#include "sweep_kernel.cuh"

namespace hydra {

// ---------------------------------------------------------------- stats --
// Per-tile partials part[tile * W + r] of one window's rows r: s1 = sum
// g*eps (complete stale data: sum h*eps), s2 = sum m*eps (complete data:
// sum eps) and, exact complete data, v = sum g. Within a tile, lane l of a
// warp adds its words l, l + 32, l + 64, l + 96 (16 individuals each)
// individual by individual, then the warp's xor butterfly; the draw
// kernels and window_stats_finish_kernel add the tiles in order.
//
// Bound: bytes, the W * nb packed bytes, eps once and the partials (1.84 MB
// at W=128, N=50,000: 0.55 us at 3.35 TB/s). grid (tiles, ceil(W / rows a
// block)); a block covers one tile for STATS_WARPS * STATS_RPW rows
// (StatsTile, sweep_kernel.cuh, shared with BayesW's levels_kernel):
//  - the tile's eps (8 KB) is read from memory once per block into shared
//    memory, and each lane keeps its 64 values in registers for all of its
//    warp's rows, so eps traffic falls by the rows a block, not per row;
//  - a warp issues the packed words of its STATS_RPW rows together, before
//    the block stages eps, so the order -> row loads and the eps loads are
//    in flight at once; a block of a lone warp (W <= STATS_RPW) reads its
//    eps straight into registers;
//  - the window's rows are read here first, from HBM: each block prefetches
//    its tile of the next window's rows to L2 (next_w, a hint), so the
//    next stats pass finds them there;
//  - complete data's s2 = sum eps is the same sum for every row: each warp
//    adds it once, in the lane order above, and writes it for each row;
//  - the crumbs decode a word at a time (geno_crumbs, the mask bits) and
//    become floats by a byte permute into 2^23 + c and one subtraction
//    (byte_float), not the quarter-rate integer conversion.
// STORE (the single-decode sweep) also writes the row's crumbs, one byte
// per individual, to dec[r * 4 * nb + i]: a word's 16 as one 16-byte store.
template <int MODE, bool STORE>
__global__ void __launch_bounds__(STATS_THREADS)
stats_kernel(const uint8_t* __restrict__ pk, int nb, const float* __restrict__ eps,
             const int* __restrict__ order_w, const int* __restrict__ next_w, int W,
             float* __restrict__ part_s1, float* __restrict__ part_s2,
             float* __restrict__ part_v, uint8_t* __restrict__ dec) {
    __shared__ __align__(16) float4 s_eps[STATS_TB];
    StatsTile tl;
    if (!tl.load(pk, nb, eps, order_w, next_w, W, s_eps)) return;
    const int t = blockIdx.x, lane = threadIdx.x & 31;
    const int w0 = tl.w0, nj = tl.nj, r0 = tl.r0;
    const auto& ev = tl.ev;
    float b_all = 0.f;
    if (MODE != MODE_MISSING) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (j < nj) {
#pragma unroll
                for (int i = 0; i < 16; ++i) b_all += ev[j][i];
            }
        }
        b_all = warp_sum(b_all);
    }
#pragma unroll
    for (int p = 0; p < STATS_RPW; ++p) {
        const int r = r0 + p;
        if (r >= W) break;
        float a = 0.f, b = 0.f;
        int v = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (j >= nj) break;
            const uint32_t word = tl.words[p][j];
            if constexpr (STORE) {
                uint4* drow = reinterpret_cast<uint4*>(dec + static_cast<size_t>(r) * 4 * nb);
                drow[w0 + lane + 32 * j] =
                    make_uint4(spread_crumbs(word & 0xffu), spread_crumbs((word >> 8) & 0xffu),
                               spread_crumbs((word >> 16) & 0xffu), spread_crumbs(word >> 24));
            }
            // stale complete: the raw h; else the genotype crumbs. Crumb
            // 4q + k (individual 16 wd + 4q + k) is byte q of crumbs_at(x, k)
            const uint32_t x = MODE == MODE_STALE_COMPLETE ? word : geno_crumbs(word);
            const uint32_t mbits = ~(word & (word >> 1)) & 0x55555555u;   // 1: not missing
            uint32_t xs[4], ms[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                xs[k] = crumbs_at(x, k);
                ms[k] = crumbs_at(mbits, k);
            }
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const float e = ev[j][4 * q + k];
                    a = fmaf(byte_float(xs[k], q), e, a);
                    if (MODE == MODE_MISSING) b = fmaf(byte_float(ms[k], q), e, b);
                }
            if (MODE == MODE_EXACT_COMPLETE)
                v += __popc(x & 0x55555555u) + 2 * __popc(x & 0xaaaaaaaau);
        }
        a = warp_sum(a);
        if (MODE == MODE_MISSING) b = warp_sum(b);
        if (MODE == MODE_EXACT_COMPLETE) v = warp_sum(v);
        if (lane == 0) {
            part_s1[t * W + r] = a;
            part_s2[t * W + r] = MODE == MODE_MISSING ? b : b_all;
            if (MODE == MODE_EXACT_COMPLETE) part_v[t * W + r] = static_cast<float>(v);
        }
    }
}

// One window's stats partials over its W rows order_w[0..W); STORE writes
// the crumbs to dec (the single-decode sweep: stale or missing modes).
template <bool STORE>
inline int launch_stats(const uint8_t* pk, int nb, const float* eps, const int* order_w,
                        const int* next_w, int W, int mode, float* part_s1, float* part_s2,
                        float* part_v, uint8_t* dec, cudaStream_t stream) {
    auto* const kernel = mode == MODE_MISSING ? stats_kernel<MODE_MISSING, STORE>
                         : mode == MODE_STALE_COMPLETE
                             ? stats_kernel<MODE_STALE_COMPLETE, STORE>
                             : stats_kernel<MODE_EXACT_COMPLETE, STORE>;
    kernel<<<stats_grid(nb, W), stats_threads(W), 0, stream>>>(pk, nb, eps, order_w, next_w, W,
                                                                part_s1, part_s2, part_v, dec);
    HYDRA_CHECK_LAUNCH();
    return 0;
}

// ----------------------------------------------------------- stale draw --
// One block, one thread per marker of the window: stale_draw (sweep_kernel.
// cuh) on each, the h-decode axpy constant by thread 0. The stale sweeps
// fold this draw into their axpy (axpy_kernel<false, MODE, KB>,
// axpy_decoded_kernel<MODE, KB>) up to STALE_FOLD_MAX_W markers a window
// and K_MAX components; above, it runs in its own launch before the axpy.
// WIDE (windows above WIDE_W): 1,024 threads, each drawing the markers r,
// r + 1024, ...; c1 and c2 go straight to coef, and thread 0 adds the
// constant from there behind the block's barrier, in slot order as below,
// so shared memory does not grow with W.
template <int KB, bool WIDE = false>
__global__ void __launch_bounds__(1024, 1)
stale_draw_kernel(const float* __restrict__ mrow, int C, int K,
                  const int* __restrict__ order_w, int W,
                  const float* __restrict__ part_s1,
                  const float* __restrict__ part_s2, int n_tiles,
                  int complete, const float* __restrict__ sc,
                  float* __restrict__ out, float* __restrict__ coef) {
    extern __shared__ float sh[];          // c1[W], c2[W] (not WIDE)
    if constexpr (WIDE) {
        for (int r = threadIdx.x; r < W; r += blockDim.x) {
            const int slot = order_w[r];
            const float2 s = reduce_tile_pair(part_s1, part_s2, n_tiles, W, r);
            const StaleDraw d = stale_draw<KB>(mrow + static_cast<size_t>(slot) * C, K, s.x,
                                               s.y, complete != 0, sc[0], sc[1]);
            reinterpret_cast<float4*>(out)[slot] = d.out;
            coef[r] = d.c1;
            coef[W + r] = d.c2;
        }
        __syncthreads();
        if (threadIdx.x == 0 && complete) {
            float a = 0.f, b = 0.f;
            for (int j = 0; j < W; ++j) a += coef[j];
            for (int j = 0; j < W; ++j) b += coef[W + j];
            coef[2 * W] = 2.0f * a + b;
        }
        return;
    }
    const int r = threadIdx.x;
    if (r < W) {
        const int slot = order_w[r];
        const float2 s = reduce_tile_pair(part_s1, part_s2, n_tiles, W, r);
        const StaleDraw d = stale_draw<KB>(mrow + static_cast<size_t>(slot) * C, K, s.x,
                                           s.y, complete != 0, sc[0], sc[1]);
        reinterpret_cast<float4*>(out)[slot] = d.out;
        sh[r] = d.c1;
        sh[W + r] = d.c2;
    }
    __syncthreads();
    if (r < W) {
        coef[r] = sh[r];
        coef[W + r] = sh[W + r];
    }
    if (r == 0 && complete) {
        // h-decode axpy constant: 2 * sum(c1) + sum(c2), in slot order
        float a = 0.f, b = 0.f;
        for (int j = 0; j < W; ++j) a += sh[j];
        for (int j = 0; j < W; ++j) b += sh[W + j];
        coef[2 * W] = 2.0f * a + b;
    }
}

// A stale window's separate draw (stale_draw_kernel), by mixture size and
// window width.
inline int launch_stale_draw(const float* mrow, int C, int K, const int* order_w, int W,
                             const float* part_s1, const float* part_s2, int n_tiles,
                             int complete, const float* sc, float* out, float* coef,
                             cudaStream_t stream) {
    const bool wide = W > WIDE_W;
    auto* const kernel =
        wide ? by_components(K, stale_draw_kernel<4, true>, stale_draw_kernel<8, true>,
                             stale_draw_kernel<K_MAX, true>, stale_draw_kernel<K_ANY, true>)
             : by_components(K, stale_draw_kernel<4>, stale_draw_kernel<8>,
                             stale_draw_kernel<K_MAX>, stale_draw_kernel<K_ANY>);
    kernel<<<1, wide ? WIDE_W : cdiv(W, 32) * 32, wide ? 0 : 2 * sizeof(float) * W, stream>>>(
        mrow, C, K, order_w, W, part_s1, part_s2, n_tiles, complete, sc, out, coef);
    HYDRA_CHECK_LAUNCH();
    return 0;
}

// The stale sweeps fold the window's draw into its axpy up to this many
// markers a window; above it the draw runs as its own launch
// (stale_draw_kernel). Every axpy block draws the whole window, so the
// fold's redundant reads and its draws a thread grow with W. Device us a
// window of the folded axpy against stale_draw_kernel + axpy_kernel, N =
// 50,000 (chip_smoke.print_stale_fold_times, H100 SXM at 700 W, both in one
// run): W=1 3.84 vs 5.46, 64 6.55 vs 7.80, 128 8.30 vs 9.21, 256 12.50 vs
// 12.62, 512 23.04 vs 19.61, 1024 43.72 vs 32.57. Stale windows above it
// are run: BIAS_SWEEP.md's stale sweep goes to W=1024. chip_smoke.py holds
// both sides against the plain version (W=64 and 512).
constexpr int STALE_FOLD_MAX_W = 256;

// One stale window's draw and axpy in one launch: axpy_kernel<false, mode,
// KB> with the draw's bound KB on the mixture size (by_components).
inline int launch_draw_axpy(const uint8_t* pk, int nb, const int* order_w, int W, int mode,
                            const StaleDrawArgs& dr, const float* mask, float* eps,
                            cudaStream_t stream) {
    auto* const kernel =
        mode == MODE_MISSING
            ? by_components(dr.K, axpy_kernel<false, MODE_MISSING, 4>,
                            axpy_kernel<false, MODE_MISSING, 8>,
                            axpy_kernel<false, MODE_MISSING, K_MAX>)
            : by_components(dr.K, axpy_kernel<false, MODE_STALE_COMPLETE, 4>,
                            axpy_kernel<false, MODE_STALE_COMPLETE, 8>,
                            axpy_kernel<false, MODE_STALE_COMPLETE, K_MAX>);
    kernel<<<nb / AXPY_TB, AXPY_THREADS, 2 * sizeof(float) * ((W + 3) & ~3), stream>>>(
        pk, nb, order_w, W, nullptr, mask, eps, nullptr, dr.sc, dr);
    HYDRA_CHECK_LAUNCH();
    return 0;
}

// ----------------------------------------------------------- exact draw --
// The exact recurrence of one window: the W-step chain of
// _sweep_exact_kernel.step (hydra_tpu/ops/sweep_kernel.py:452-526), num_i +=
// G_ij * dbeta_j after marker j's draw, with the complete-data integer Gram
// standardized by the rank-1 correction of sweep_kernel.py:435-442, run
// as warp_recurrence (sweep_kernel.cuh) in one block. Each lane holds its
// marker's mrow constants in registers from the start (exact_draw<KB>;
// K_ANY: exact_draw_any reads them from the row, or from shared memory
// where the launch has room, stage_any); the Gram's elements are
// standardized as they are staged, each once, with the lane's own
// statistics and row j's from shared memory. The integer Gram is
// symmetric, so lane i reads G(i, j) as G[j * W + i], coalesced. Dynamic
// shared memory: exact_draw_smem(W).
//
// KB: exact_draw's bound on K; FIXED: K == KB, a compile-time constant.
// PIECED (windows above WIDE_W markers): the launch runs the piece of
// markers p0 .. p0 + min(WIDE_W, W - p0) of the window (a thread
// each, exact_draw_smem of the piece), its markers first catching up on
// the earlier pieces' steps (catch_up: their dbeta, mave, mstd and v from
// pre = [dbeta | mave | mstd | v] (W each), which every piece writes for
// its markers, standardized by the same std_gram); the last piece adds the
// complete-data constant over all W.
template <int KB, bool FIXED, bool PIECED = false>
__global__ void __launch_bounds__(1024)
exact_draw_kernel(const float* __restrict__ mrow, int C, int k_run,
                  const int* __restrict__ order_w, int W,
                  const float* __restrict__ part_s1, const float* __restrict__ part_s2,
                  const float* __restrict__ part_v, int n_tiles, int complete,
                  const float* __restrict__ G, const float* __restrict__ sc,
                  float* __restrict__ out, float* __restrict__ coef, int p0_run,
                  float* __restrict__ pre) {
    const int K = FIXED ? KB : k_run;
    const int p0 = PIECED ? p0_run : 0;
    const int Wp = PIECED ? min(WIDE_W, W - p0) : W;   // this launch's markers
    extern __shared__ float sh[];
    const int r = threadIdx.x, warp = r >> 5, lane = r & 31;
    const int i = p0 + r;                 // the lane's window position
    float* s_db = sh;                     // [Wp]
    float* s_mave = sh + Wp;              // [Wp]
    float* s_mstd = sh + 2 * Wp;          // [Wp]
    float* s_v = sh + 3 * Wp;             // [Wp]
    const float i2se = sc[0], dNm1 = sc[1], n_real = sc[2];
    const bool live = r < Wp;
    // this lane's marker: statistics, num and its mrow constants
    float numv = 0.f, mave = 0.f, mstd = 0.f, v = 0.f;
    float u = 0.f, nrm = 0.f, act = 0.f, bold = 0.f;
    constexpr int KR = KB == K_ANY ? 2 : KB;     // the register arrays' bound
    float logl[KR], invd[KR - 1], sdk[KR - 1];
    int slot = 0;
    if (live) {
        slot = order_w[i];
        const float* row = mrow + static_cast<size_t>(slot) * C;
        const float s1 = reduce_tiles(part_s1, n_tiles, W, i);
        const float s2 = reduce_tiles(part_s2, n_tiles, W, i);
        mave = row[0];
        mstd = row[1];
        bold = row[2];
        u = row[3];
        nrm = row[4];
        act = row[5];
        v = complete ? reduce_tiles(part_v, n_tiles, W, i) : 0.f;
        numv = mstd * (s1 - mave * s2) + bold * dNm1;
        s_mave[r] = mave;
        s_mstd[r] = mstd;
        s_v[r] = v;
        if constexpr (PIECED) {
            pre[W + i] = mave;
            pre[2 * W + i] = mstd;
            pre[3 * W + i] = v;
        }
    }
    // K_ANY: the row's constants in place (a dead lane reads slot 0's), or
    // staged in shared memory after the recurrence's (any_staged)
    const float* row_l = mrow + static_cast<size_t>(slot) * C + N_FIXED;
    bool staged = false;
    float* s_any = sh;
    if constexpr (KB == K_ANY) {
        const int s_base = 4 * Wp + (((Wp + 31) >> 5) + 2) * 32 * 32;   // exact_draw_smem(Wp)
        staged = any_staged(Wp, K, s_base);
        s_any = sh + s_base + warp * (3 * K - 2) * 32 + lane;
        if (staged) stage_any(s_any, row_l, row_l + K, row_l + 2 * K - 1, K);
    }
#pragma unroll
    for (int k = 0; k < (KB == K_ANY ? 0 : KB); ++k) {
        const bool has = live && k < K;
        logl[k] = has ? mrow[static_cast<size_t>(slot) * C + N_FIXED + k] : 0.f;
        if (k < KB - 1) {
            invd[k] = has && k < K - 1 ? mrow[static_cast<size_t>(slot) * C + N_FIXED + K + k]
                                       : 0.f;
            sdk[k] = has && k < K - 1
                         ? mrow[static_cast<size_t>(slot) * C + N_FIXED + 2 * K - 1 + k]
                         : 0.f;
        }
    }
    if constexpr (PIECED) {
        // the earlier pieces' steps, from their pre columns
        if (live)
            numv = catch_up(
                p0, numv,
                [&](int j) {
                    return std_gram(G[static_cast<size_t>(j) * W + i], complete, mave, mstd, v,
                                    pre[W + j], pre[2 * W + j], pre[3 * W + j], n_real);
                },
                [&](int j) { return pre[j]; });
    }
    __syncthreads();
    const Draw mine = warp_recurrence(
        Wp, numv, [&](int rj) { return G + static_cast<size_t>(p0 + rj) * W + i; },
        [&](int rj, float g) {
            return std_gram(g, complete, mave, mstd, v, s_mave[rj], s_mstd[rj], s_v[rj],
                            n_real);
        },
        [&](float num) {
            if constexpr (KB == K_ANY) {
                if (staged)
                    return exact_draw_any(num, s_any, s_any + K * 32, s_any + (2 * K - 1) * 32,
                                          32, K, u, nrm, act, bold, i2se);
                return exact_draw_any(num, row_l, row_l + K, row_l + 2 * K - 1, 1, K, u, nrm,
                                      act, bold, i2se);
            } else
                return exact_draw<KB>(num, logl, invd, sdk, K, u, nrm, act, bold, i2se);
        },
        s_db, sh + 4 * Wp);
    if (live) {
        float* o = out + static_cast<size_t>(slot) * 4;
        o[0] = mine.bnew;
        o[1] = mine.comp(act);
        o[2] = mine.acum(act);
        o[3] = mine.dbeta;
        const float c1 = mine.dbeta * mstd;
        coef[i] = c1;
        coef[W + i] = -c1 * mave;
        s_v[r] = -c1 * mave;          // c2, for the complete-data constant
        if constexpr (PIECED) pre[i] = mine.dbeta;
    }
    __syncthreads();
    if (warp == 0 && complete && p0 + Wp == W) {
        // sum(c2), broadcast on real lanes: lane-strided partials, then a
        // fixed-order warp tree (the last piece: over the whole window's
        // coef, this launch's and the earlier ones')
        float b = 0.f;
        for (int j = lane; j < W; j += 32) b += PIECED ? coef[W + j] : s_v[j];
        b = warp_sum(b);
        if (lane == 0) coef[2 * W] = b;
    }
}

// The exact recurrence of a window: one launch (exact_draw_kernel), or one
// a piece of WIDE_W markers above it; pre: the pieces' 4 W floats.
inline int launch_exact_draw(const float* mrow, int C, int K, const int* order_w, int W,
                             const float* part_s1, const float* part_s2, const float* part_v,
                             int n_tiles, int complete, const float* G, const float* sc,
                             float* out, float* coef, float* pre, cudaStream_t stream) {
    const bool pieced = W > WIDE_W;
    auto* const draw =
        pieced ? by_components(K, exact_draw_kernel<4, true, true>,
                               exact_draw_kernel<8, false, true>,
                               exact_draw_kernel<K_MAX, false, true>,
                               exact_draw_kernel<K_ANY, false, true>)
               : by_components(K, exact_draw_kernel<4, true>, exact_draw_kernel<8, false>,
                               exact_draw_kernel<K_MAX, false>, exact_draw_kernel<K_ANY, false>);
    const size_t base = exact_draw_smem(pieced ? WIDE_W : W);
    const size_t smem = base + any_stage_bytes(pieced ? WIDE_W : W, K, base);
    HYDRA_CHECK(allow_smem(draw, smem));
    for (int p0 = 0; p0 < W; p0 += WIDE_W) {
        const int wp = W - p0 < WIDE_W ? W - p0 : WIDE_W;
        draw<<<1, cdiv(wp, 32) * 32, smem, stream>>>(mrow, C, K, order_w, W, part_s1, part_s2,
                                                     part_v, n_tiles, complete, G, sc, out,
                                                     coef, p0, pre);
        HYDRA_CHECK_LAUNCH();
    }
    return 0;
}

// ------------------------------------------------------------ workspace --
struct Workspace {
    float* part_s1;
    float* part_s2;
    float* part_v;
    float* coef;
    float* gram;          // exact: a batch of Grams (gram_batch_windows, W, W)
    float* pre;           // exact above WIDE_W: the pieces' 4 W floats
    size_t bytes;
};

inline Workspace layout(void* base, int m_loc, int nb, int W, bool exact) {
    const size_t n_tiles = cdiv(nb, STATS_TB);
    size_t off = 0;
    Workspace ws{};
    char* p = static_cast<char*>(base);
    auto take = [&](size_t floats) {
        float* out = reinterpret_cast<float*>(p + off);
        off += align256(floats * sizeof(float));
        return out;
    };
    ws.part_s1 = take(n_tiles * W);
    ws.part_s2 = take(n_tiles * W);
    ws.part_v = take(n_tiles * W);
    ws.coef = take(2 * static_cast<size_t>(W) + 1);
    if (exact)
        ws.gram = take(static_cast<size_t>(gram_batch_windows(m_loc / W, W)) * W * W);
    if (exact && W > WIDE_W) ws.pre = take(4 * static_cast<size_t>(W));
    ws.bytes = off;
    return ws;
}

inline bool shapes_ok(int m_loc, int nb, int W, int K) {
    return W >= 1 && m_loc > 0 && m_loc % W == 0 && nb > 0 && nb % 128 == 0 && K >= 2;
}

// Windows w_begin .. w_end - 1 of a sweep (0 .. m_loc / W for a whole
// one). A sweep run as several ranges runs them in order on one workspace:
// an exact range takes the Grams its batch's first window left there.
int run_sweep(bool exact, const uint8_t* pk, float* eps, const float* mrow,
              const int* order, const float* mask, const float* sc, float* out,
              void* ws_base, int m_loc, int nb, int W, int K, int complete,
              int w_begin, int w_end, cudaStream_t stream) {
    if (!shapes_ok(m_loc, nb, W, K) || (complete && mask == nullptr) ||
        (exact && complete && 4LL * nb > GRAM_I8_MAX_NPAD) || w_begin < 0 ||
        w_end > m_loc / W || w_begin > w_end)
        return static_cast<int>(cudaErrorInvalidValue);
    const int C = N_FIXED + 3 * K - 2;
    const Workspace ws = layout(ws_base, m_loc, nb, W, exact);
    const int n_windows = m_loc / W;
    const int batch = gram_batch_windows(n_windows, W);
    const int n_tiles = cdiv(nb, STATS_TB);
    const int mode = !complete ? MODE_MISSING
                               : (exact ? MODE_EXACT_COMPLETE : MODE_STALE_COMPLETE);
    const StaleDrawArgs dr{mrow, C, K, ws.part_s1, ws.part_s2, n_tiles, sc, out};
    const bool fold = !exact && W <= STALE_FOLD_MAX_W && K <= K_MAX;
    for (int w = w_begin; w < w_end; ++w) {
        const int* order_w = order + static_cast<size_t>(w) * W;
        const int* next_w = w + 1 < n_windows ? order_w + W : nullptr;
        if (exact) {
            // at a batch's first window, the batch's Grams, ahead of their draws
            const int err = launch_gram_batch(pk, nb, order, W, w, n_windows, complete, mrow,
                                              mrow + 1, C, ws.gram, stream);
            if (err) return err;
        }
        int err = launch_stats<false>(pk, nb, eps, order_w, next_w, W, mode, ws.part_s1,
                                      ws.part_s2, ws.part_v, nullptr, stream);
        if (err) return err;
        if (fold) {
            err = launch_draw_axpy(pk, nb, order_w, W, mode, dr, mask, eps, stream);
            if (err) return err;
            continue;
        }
        err = exact ? launch_exact_draw(mrow, C, K, order_w, W, ws.part_s1, ws.part_s2,
                                        ws.part_v, n_tiles, complete,
                                        ws.gram + static_cast<size_t>(w % batch) * W * W, sc,
                                        out, ws.coef, ws.pre, stream)
                    : launch_stale_draw(mrow, C, K, order_w, W, ws.part_s1, ws.part_s2,
                                        n_tiles, complete, sc, out, ws.coef, stream);
        if (err) return err;
        err = launch_axpy<false>(pk, nb, order_w, W, mode, ws.coef, mask, eps, nullptr,
                                 nullptr, stream);
        if (err) return err;
    }
    return 0;
}

// ------------------------------------------------ single-decode stale sweep --
// Port of sweep_stale_sd (hydra_tpu/ops/sweep_kernel.py:255-332): the stale
// sweep with each window's packed bytes decoded once. A window of W markers
// runs as W / Wt sub-windows; per sub-window
//   stats_kernel<true>   s1, s2 (stats_kernel's tile order) and the rows'
//                        crumbs to dec (Wt x n_pad bytes, one a genotype)
//   axpy_decoded_kernel  the draw of its Wt markers in every block
//                        (draw_window, as the stale axpy_kernel; above
//                        STALE_FOLD_MAX_W a stale_draw_kernel launch before
//                        it), then the update from dec, not from the packed
//                        bytes, accumulated in dacc over the sub-windows and
//                        added to eps at the window's last one
// so every marker of the window reads the same stale eps for any Wt, and
// with Wt = W the sweep is hydra_sweep_stale's bit for bit.
//
// Bound: bytes, W * NB packed bytes and 3 x 4 * NB * 4 of eps per window
// (read by the stats, read and written by the axpy); two multiply-adds per
// genotype are far below the f32 peak. The stats kernel writes the decoded
// crumbs to a scratch (3.2 MB at W=64 x N=50,000, resident in the 50 MB
// L2) and the axpy runs a thread per individual that loads one decoded
// byte per row, with the per-individual sum in axpy_kernel's order. The TPU kernel's bf16
// hi/lo split of c1/c2 (a matrix-unit device) is not carried over: the
// update multiplies in f32. Launches stay per sub-window on one stream.
//
// Missing data needs no second plane: a decoded byte is the crumb c, and
// g = (2 - c) * m, m = (c != 3) come from it as in axpy_kernel. Complete
// data: d = cst - sum c1 * h per sub-window, times the mask at the end.
// DRAW_KB > 0: every block draws the sub-window's coefficients itself from
// the stats partials (draw_window with stale_draw<DRAW_KB>, block 0 writing
// out; order_w names its rows) into c1[W4], c2[W4], and adds its own cst
// (h_cst4), as axpy_kernel<false, MODE, DRAW_KB>; coef is not read.
template <int MODE, int DRAW_KB = 0>
__global__ void axpy_decoded_kernel(const uint8_t* __restrict__ dec, int n_pad, int W,
                                    const float* __restrict__ coef,
                                    const float* __restrict__ mask,
                                    float* __restrict__ eps, float* __restrict__ dacc,
                                    int first, int last, const int* __restrict__ order_w,
                                    const StaleDrawArgs dr) {
    constexpr bool DRAW = DRAW_KB > 0;
    extern __shared__ float4 sh_dec[];     // c1[W], c2[W] (DRAW: W4 each, zero past W)
    const int W4 = (W + 3) & ~3;
    float* s_c1 = reinterpret_cast<float*>(sh_dec);
    float* s_c2 = s_c1 + (DRAW ? W4 : W);
    float cst = 0.f;
    if constexpr (DRAW) {
        draw_window<DRAW_KB>(dr, order_w, W, W4, MODE == MODE_STALE_COMPLETE, s_c1, s_c2);
        __syncthreads();
        if (MODE == MODE_STALE_COMPLETE) cst = h_cst4(s_c1, s_c2, W4);
    } else {
        for (int i = threadIdx.x; i < W; i += blockDim.x) {
            s_c1[i] = coef[i];
            s_c2[i] = coef[W + i];
        }
        __syncthreads();
    }
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_pad) return;
    float acc = 0.f;
#pragma unroll 8
    for (int r = 0; r < W; ++r) {
        const int c = dec[static_cast<size_t>(r) * n_pad + i];
        if constexpr (MODE == MODE_STALE_COMPLETE) {
            acc = fmaf(s_c1[r], static_cast<float>(c), acc);
        } else {
            acc = fmaf(s_c1[r], static_cast<float>(crumb_geno(c)), acc);
            acc = fmaf(s_c2[r], static_cast<float>(crumb_mask(c)), acc);
        }
    }
    float d = MODE == MODE_STALE_COMPLETE ? (DRAW ? cst : coef[2 * W]) - acc : acc;
    if (!first) d = dacc[i] + d;
    if (!last) {
        dacc[i] = d;
        return;
    }
    if constexpr (MODE == MODE_STALE_COMPLETE)
        eps[i] += d * mask[i];
    else
        eps[i] += d;
}

struct SdWorkspace {
    float* part_s1;
    float* part_s2;
    float* coef;
    float* dacc;          // the window's update over its sub-windows
    uint8_t* dec;         // a sub-window's decoded rows, Wt x 4 * nb bytes
    size_t bytes;
};

inline SdWorkspace sd_layout(void* base, int nb, int Wt, bool accumulate) {
    const size_t n_tiles = cdiv(nb, STATS_TB);
    size_t off = 0;
    SdWorkspace ws{};
    char* p = static_cast<char*>(base);
    auto take = [&](size_t bytes) {
        char* out = p + off;
        off += align256(bytes);
        return out;
    };
    ws.part_s1 = reinterpret_cast<float*>(take(sizeof(float) * n_tiles * Wt));
    ws.part_s2 = reinterpret_cast<float*>(take(sizeof(float) * n_tiles * Wt));
    ws.coef = reinterpret_cast<float*>(take(sizeof(float) * (2 * static_cast<size_t>(Wt) + 1)));
    ws.dacc = accumulate ? reinterpret_cast<float*>(take(sizeof(float) * 4 * static_cast<size_t>(nb)))
                         : nullptr;
    ws.dec = reinterpret_cast<uint8_t*>(take(static_cast<size_t>(Wt) * 4 * nb));
    ws.bytes = off;
    return ws;
}

int run_sweep_sd(const uint8_t* pk, float* eps, const float* mrow, const int* order,
                 const float* mask, const float* sc, float* out, void* ws_base, int m_loc,
                 int nb, int W, int Wt, int K, int complete, cudaStream_t stream) {
    if (!shapes_ok(m_loc, nb, W, K) || Wt < 1 || W % Wt || (complete && mask == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const int C = N_FIXED + 3 * K - 2;
    const int n_sub = W / Wt;
    const SdWorkspace ws = sd_layout(ws_base, nb, Wt, n_sub > 1);
    const int n_windows = m_loc / W;
    const int n_tiles = cdiv(nb, STATS_TB);
    const int mode = complete ? MODE_STALE_COMPLETE : MODE_MISSING;
    const int axpy_blocks = cdiv(4LL * nb, AXPY_THREADS);
    const size_t coef_smem = 2 * sizeof(float) * Wt;
    const bool fold = Wt <= STALE_FOLD_MAX_W && K <= K_MAX;
    // the folded kernel holds c1, c2 to Wt rounded up to 4
    const size_t fold_smem = 2 * sizeof(float) * ((Wt + 3) & ~3);
    const StaleDrawArgs dr{mrow, C, K, ws.part_s1, ws.part_s2, n_tiles, sc, out};
    auto* const axpy =
        !fold ? (complete ? axpy_decoded_kernel<MODE_STALE_COMPLETE>
                          : axpy_decoded_kernel<MODE_MISSING>)
        : complete ? by_components(K, axpy_decoded_kernel<MODE_STALE_COMPLETE, 4>,
                                   axpy_decoded_kernel<MODE_STALE_COMPLETE, 8>,
                                   axpy_decoded_kernel<MODE_STALE_COMPLETE, K_MAX>)
                   : by_components(K, axpy_decoded_kernel<MODE_MISSING, 4>,
                                   axpy_decoded_kernel<MODE_MISSING, 8>,
                                   axpy_decoded_kernel<MODE_MISSING, K_MAX>);
    // a sub-window's coefficients wait in shared memory: the opt-in past 48 KB
    if (!fold) HYDRA_CHECK(allow_smem(axpy, coef_smem));
    for (int w = 0; w < n_windows; ++w) {
        for (int s = 0; s < n_sub; ++s) {
            const int* order_s = order + static_cast<size_t>(w) * W + s * Wt;
            const int* next_s = w + 1 < n_windows || s + 1 < n_sub ? order_s + Wt : nullptr;
            const int err = launch_stats<true>(pk, nb, eps, order_s, next_s, Wt, mode,
                                               ws.part_s1, ws.part_s2, nullptr, ws.dec, stream);
            if (err) return err;
            if (!fold) {
                const int e = launch_stale_draw(mrow, C, K, order_s, Wt, ws.part_s1, ws.part_s2,
                                                n_tiles, complete, sc, out, ws.coef, stream);
                if (e) return e;
            }
            axpy<<<axpy_blocks, AXPY_THREADS, fold ? fold_smem : coef_smem, stream>>>(
                ws.dec, 4 * nb, Wt, ws.coef, mask, eps, ws.dacc, s == 0, s == n_sub - 1,
                order_s, dr);
            HYDRA_CHECK_LAUNCH();
        }
    }
    return 0;
}

// ---------------------------------------------------------- window_stats --
// Port of window_stats (hydra_tpu/ops/window_kernels.py:180-248) for the
// per-window branch: the window's rows are read in place through rows[]
// (no gather). stats_kernel's tile partials are reduced in tile order;
// complete stale data turns hs1 = sum h*eps into s1 = 2 sum(eps) - hs1 with
// the row's own sum(eps).
__global__ void window_stats_finish_kernel(const float* __restrict__ part_s1,
                                           const float* __restrict__ part_s2,
                                           const float* __restrict__ part_v,
                                           int n_tiles, int W, int mode,
                                           float* __restrict__ s1,
                                           float* __restrict__ s2,
                                           float* __restrict__ v) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= W) return;
    const float a = reduce_tiles(part_s1, n_tiles, W, r);
    const float b = reduce_tiles(part_s2, n_tiles, W, r);
    s1[r] = mode == MODE_STALE_COMPLETE ? __fsub_rn(2.0f * b, a) : a;
    s2[r] = b;
    if (mode == MODE_EXACT_COMPLETE) v[r] = reduce_tiles(part_v, n_tiles, W, r);
}

// The complete-data Gram's rank-1 standardization (window_kernels.py:
// 239-246), in place on the raw integer Gram, one rounding per operation
// (no contraction), so the plain version repeats it bit for bit:
//   G_ij = (mstd_i mstd_j) ((G_ij - mave_i v_j - v_i mave_j) + n mave_i mave_j)
__global__ void gram_standardize_kernel(float* __restrict__ G, int W,
                                        const float* __restrict__ mave,
                                        const float* __restrict__ mstd,
                                        const float* __restrict__ v,
                                        const float* __restrict__ n_real) {
    const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (e >= static_cast<size_t>(W) * W) return;
    const int i = static_cast<int>(e / W), j = static_cast<int>(e % W);
    float t = __fsub_rn(G[e], __fmul_rn(mave[i], v[j]));
    t = __fsub_rn(t, __fmul_rn(v[i], mave[j]));
    t = __fadd_rn(t, __fmul_rn(n_real[0], __fmul_rn(mave[i], mave[j])));
    G[e] = __fmul_rn(__fmul_rn(mstd[i], mstd[j]), t);
}

struct WindowWorkspace {
    float* part_s1;
    float* part_s2;
    float* part_v;
    float* v;
    float* gram_part;     // the missing-data Gram's chunk partials
    int* gram_acc;        // the complete Gram's accumulator, or the missing one's tickets
    size_t bytes;
};

inline WindowWorkspace window_layout(void* base, int nb, int W, bool exact,
                                     bool complete) {
    const size_t n_tiles = cdiv(nb, STATS_TB);
    size_t off = 0;
    WindowWorkspace ws{};
    char* p = static_cast<char*>(base);
    auto take = [&](size_t floats) {
        float* out = reinterpret_cast<float*>(p + off);
        off += align256(floats * sizeof(float));
        return out;
    };
    ws.part_s1 = take(n_tiles * W);
    ws.part_s2 = take(n_tiles * W);
    ws.part_v = take(n_tiles * W);
    ws.v = take(W);
    if (exact && complete) {
        ws.gram_acc = reinterpret_cast<int*>(take(gram_i8_acc_ints(W, 1)));
    } else if (exact) {
        ws.gram_part = take(gram_f32_part_floats(W, nb));
        ws.gram_acc = reinterpret_cast<int*>(take(gram_f32_tiles(W, nb)));
    }
    ws.bytes = off;
    return ws;
}

int run_window_stats(const uint8_t* pk, const float* eps, const int* rows,
                     const float* mave, const float* mstd, const float* n_real,
                     float* s1, float* s2, float* gram, void* ws_base, int W, int nb,
                     bool exact, int complete, cudaStream_t stream) {
    if (W < 1 || nb <= 0 || nb % 128 || (exact && gram == nullptr) ||
        (exact && complete && (n_real == nullptr || 4LL * nb > GRAM_I8_MAX_NPAD)))
        return static_cast<int>(cudaErrorInvalidValue);
    const WindowWorkspace ws = window_layout(ws_base, nb, W, exact, complete != 0);
    const int n_tiles = cdiv(nb, STATS_TB);
    const int mode = !complete ? MODE_MISSING
                               : (exact ? MODE_EXACT_COMPLETE : MODE_STALE_COMPLETE);
    int err = launch_stats<false>(pk, nb, eps, rows, nullptr, W, mode, ws.part_s1,
                                  ws.part_s2, ws.part_v, nullptr, stream);
    if (err) return err;
    window_stats_finish_kernel<<<cdiv(W, 256), 256, 0, stream>>>(
        ws.part_s1, ws.part_s2, ws.part_v, n_tiles, W, mode, s1, s2, ws.v);
    HYDRA_CHECK_LAUNCH();
    if (!exact) return 0;
    // the workspace is new each call: one memset a call (a window of the
    // per-window branch) besides the kernels
    HYDRA_CHECK(cudaMemsetAsync(
        ws.gram_acc, 0,
        sizeof(int) * (complete ? gram_i8_acc_ints(W, 1) : gram_f32_tiles(W, nb)), stream));
    if (!complete)
        return launch_gram_f32(pk, nb, rows, W, 1, mave, mstd, 1, 0, ws.gram_part, ws.gram_acc,
                               gram, stream);
    err = launch_gram_i8(pk, nb, rows, W, 1, ws.gram_acc, gram, stream);
    if (err) return err;
    gram_standardize_kernel<<<cdiv(static_cast<long long>(W) * W, 256), 256, 0, stream>>>(
        gram, W, mave, mstd, ws.v, n_real);
    HYDRA_CHECK_LAUNCH();
    return 0;
}

// ---------------------------------------------------------- window_gibbs --
// Port of window_gibbs (hydra_tpu/ops/gibbs_kernel.py:112-140): the exact
// W-step recurrence of one window on separate inputs, as the TPU kernel
// takes them: num0, u, nrm, act, bold (W,), logl (W, K), invd and sd
// (W, K-1), a standardized Gram (W, W) and i2se; out dbeta, bnew, comp and
// acum (W,). Bound: the serial chain of W dependent draws, not bytes (the
// Gram is 64 KB at W=128) nor operations (W^2 multiply-adds). So it runs
// exact_draw_kernel's schedule, warp_recurrence (sweep_kernel.cuh), in one
// block of cdiv(W, 32) warps: lane r loads its own marker's constants into
// registers before the chain (exact_draw<KB>, the k < K guards of
// exact_draw_kernel, so K is a constant at KB = 4), every lane draws its
// own marker, __shfl_sync broadcasts step j's dbeta, one __syncthreads a
// 32 steps, and the Gram's tiles are staged by cp.async off the chain; the
// Gram is symmetric, so lane r's element of step j is G[j * W + r],
// coalesced, and needs no standardization (finish is the identity). Each
// lane writes its own four outputs after the chain, coalesced. Marker r
// still adds num_r = fmaf(G(j, r), dbeta_j, num_r) for j = 0..r-1 in step
// order and draws with exact_draw<KB>: the chain of the one-thread-a-step
// kernel this replaces (its W block barriers and W global loads on the
// chain), bit for bit. Dynamic shared memory: window_gibbs_smem(W).
// K_ANY: exact_draw_any reads the lane's constants from logl, invd and sd
// in place, or staged in shared memory where the launch has room
// (stage_any). PIECED (windows above WIDE_W): the launch runs the piece
// p0 .. p0 + min(WIDE_W, W - p0), its markers first catching up on
// the earlier pieces' steps (catch_up, their dbeta from the output).
inline size_t window_gibbs_smem(int W) {
    const size_t nw = cdiv(W, 32);
    return sizeof(float) * (static_cast<size_t>(W) + (nw + 2) * 32 * 32);
}

template <int KB, bool FIXED, bool PIECED = false>
__global__ void __launch_bounds__(1024)
window_gibbs_kernel(const float* __restrict__ G, const float* __restrict__ num0,
                    const float* __restrict__ logl, const float* __restrict__ invd,
                    const float* __restrict__ sd, const float* __restrict__ u_in,
                    const float* __restrict__ nrm_in, const float* __restrict__ act_in,
                    const float* __restrict__ bold_in, const float* __restrict__ i2se_p,
                    int W, int k_run, float* __restrict__ dbeta, float* __restrict__ bnew,
                    int* __restrict__ comp, float* __restrict__ acum, int p0_run) {
    const int K = FIXED ? KB : k_run;
    const int p0 = PIECED ? p0_run : 0;
    const int Wp = PIECED ? min(WIDE_W, W - p0) : W;   // this launch's markers
    extern __shared__ float sh[];         // dbeta[Wp], then the recurrence's tiles
    const int r = threadIdx.x;
    const int i = p0 + r;                 // the lane's window position
    const bool live = r < Wp;
    const float i2se = i2se_p[0];
    // this lane's marker: num and its constants, in registers
    float numv = 0.f, u = 0.f, nrm = 0.f, act = 0.f, bold = 0.f;
    constexpr int KR = KB == K_ANY ? 2 : KB;     // the register arrays' bound
    float logl_r[KR], invd_r[KR - 1], sd_r[KR - 1];
    if (live) {
        numv = num0[i];
        u = u_in[i];
        nrm = nrm_in[i];
        act = act_in[i];
        bold = bold_in[i];
    }
#pragma unroll
    for (int k = 0; k < (KB == K_ANY ? 0 : KB); ++k) {
        const bool has = live && k < K;
        logl_r[k] = has ? logl[static_cast<size_t>(i) * K + k] : 0.f;
        if (k < KB - 1) {
            invd_r[k] = has && k < K - 1 ? invd[static_cast<size_t>(i) * (K - 1) + k] : 0.f;
            sd_r[k] = has && k < K - 1 ? sd[static_cast<size_t>(i) * (K - 1) + k] : 0.f;
        }
    }
    // K_ANY: the constants in place (a dead lane reads marker 0's), or
    // staged in shared memory after the recurrence's (any_staged)
    const size_t im = live ? i : 0;
    bool staged = false;
    float* s_any = sh;
    if constexpr (KB == K_ANY) {
        const int s_base = Wp + (((Wp + 31) >> 5) + 2) * 32 * 32;   // window_gibbs_smem(Wp)
        staged = any_staged(Wp, K, s_base);
        s_any = sh + s_base + (r >> 5) * (3 * K - 2) * 32 + (r & 31);
        if (staged) stage_any(s_any, logl + im * K, invd + im * (K - 1), sd + im * (K - 1), K);
    }
    if constexpr (PIECED) {
        if (live)
            numv = catch_up(
                p0, numv, [&](int j) { return G[static_cast<size_t>(j) * W + i]; },
                [&](int j) { return dbeta[j]; });
    }
    const Draw mine = warp_recurrence(
        Wp, numv, [&](int rj) { return G + static_cast<size_t>(p0 + rj) * W + i; },
        [](int, float g) { return g; },
        [&](float num) {
            if constexpr (KB == K_ANY) {
                if (staged)
                    return exact_draw_any(num, s_any, s_any + K * 32, s_any + (2 * K - 1) * 32,
                                          32, K, u, nrm, act, bold, i2se);
                return exact_draw_any(num, logl + im * K, invd + im * (K - 1),
                                      sd + im * (K - 1), 1, K, u, nrm, act, bold, i2se);
            } else
                return exact_draw<KB>(num, logl_r, invd_r, sd_r, K, u, nrm, act, bold, i2se);
        },
        sh, sh + Wp);
    if (live) {
        dbeta[i] = mine.dbeta;
        bnew[i] = mine.bnew;
        comp[i] = static_cast<int>(mine.comp(act));
        acum[i] = mine.acum(act);
    }
}

}  // namespace hydra

extern "C" {

// Bytes of device scratch one sweep of m_loc markers needs (the caller
// allocates it).
long long hydra_sweep_workspace_bytes(int m_loc, int nb, int window, int exact) {
    if (window < 1 || m_loc < window) return 0;
    return static_cast<long long>(hydra::layout(nullptr, m_loc, nb, window, exact != 0).bytes);
}

// The Grams of the n_windows windows order[w W .. w W + W) of pk (m_loc,
// nb), into out (n_windows, W, W) f32, gram_batch_windows windows a
// launch, as the exact sweep computes them: complete data the raw g g^T,
// missing data x x^T with x = (g - mave m) mstd from mave, mstd (m_loc,)
// per slot.
int hydra_window_grams(const void* pk, const void* order, const void* mave, const void* mstd,
                       void* out, int n_windows, int nb, int window, int complete,
                       void* stream) {
    using namespace hydra;
    const int W = window;
    if (W < 1 || n_windows < 1 || nb <= 0 || nb % 128 ||
        (complete && 4LL * nb > GRAM_I8_MAX_NPAD) ||
        (!complete && (mave == nullptr || mstd == nullptr)))
        return static_cast<int>(cudaErrorInvalidValue);
    const int batch = gram_batch_windows(n_windows, W);
    for (int w = 0; w < n_windows; w += batch) {
        const int err = launch_gram_batch(
            static_cast<const uint8_t*>(pk), nb, static_cast<const int*>(order), W, w,
            n_windows, complete, static_cast<const float*>(mave),
            static_cast<const float*>(mstd), 1,
            static_cast<float*>(out) + static_cast<size_t>(w) * W * W,
            static_cast<cudaStream_t>(stream));
        if (err) return err;
    }
    return 0;
}

// A whole stale-window sweep. eps (4*nb,) is updated in place; out
// (m_loc, 4) receives [beta_new, comp, acum0, dbeta] per SLOT; order
// (m_loc,) maps sweep position -> slot; sc = [1/(2 sigma_e), N-1, N].
int hydra_sweep_stale(const void* pk, void* eps, const void* mrow, const void* order,
                      const void* mask, const void* sc, void* out, void* ws,
                      int m_loc, int nb, int window, int n_mix, int complete,
                      void* stream) {
    return hydra::run_sweep(false, static_cast<const uint8_t*>(pk),
                            static_cast<float*>(eps), static_cast<const float*>(mrow),
                            static_cast<const int*>(order), static_cast<const float*>(mask),
                            static_cast<const float*>(sc), static_cast<float*>(out), ws,
                            m_loc, nb, window, n_mix, complete, 0, m_loc / window,
                            static_cast<cudaStream_t>(stream));
}

// A whole exact (Gram-corrected sequential Gibbs) sweep; same contract.
int hydra_sweep_exact(const void* pk, void* eps, const void* mrow, const void* order,
                      const void* mask, const void* sc, void* out, void* ws,
                      int m_loc, int nb, int window, int n_mix, int complete,
                      void* stream) {
    return hydra::run_sweep(true, static_cast<const uint8_t*>(pk),
                            static_cast<float*>(eps), static_cast<const float*>(mrow),
                            static_cast<const int*>(order), static_cast<const float*>(mask),
                            static_cast<const float*>(sc), static_cast<float*>(out), ws,
                            m_loc, nb, window, n_mix, complete, 0, m_loc / window,
                            static_cast<cudaStream_t>(stream));
}

// Windows w_begin .. w_end - 1 of a stale or exact sweep, the contract of
// hydra_sweep_stale / hydra_sweep_exact otherwise: eps is updated in place
// and out receives those windows' slots. A sweep split into ranges calls
// them in window order on one workspace, so an exact sweep still launches
// its Grams once a batch, at the batch's first window.
int hydra_sweep_windows(int exact, const void* pk, void* eps, const void* mrow,
                        const void* order, const void* mask, const void* sc, void* out,
                        void* ws, int m_loc, int nb, int window, int n_mix, int complete,
                        int w_begin, int w_end, void* stream) {
    return hydra::run_sweep(exact != 0, static_cast<const uint8_t*>(pk),
                            static_cast<float*>(eps), static_cast<const float*>(mrow),
                            static_cast<const int*>(order), static_cast<const float*>(mask),
                            static_cast<const float*>(sc), static_cast<float*>(out), ws,
                            m_loc, nb, window, n_mix, complete, w_begin, w_end,
                            static_cast<cudaStream_t>(stream));
}

// Bytes of device scratch one single-decode sweep needs.
long long hydra_sweep_sd_workspace_bytes(int nb, int window, int sub_window) {
    if (sub_window < 1) return 0;
    return static_cast<long long>(
        hydra::sd_layout(nullptr, nb, sub_window, window / sub_window > 1).bytes);
}

// A whole single-decode stale sweep (sub_window Wt divides window); the
// contract of hydra_sweep_stale.
int hydra_sweep_stale_sd(const void* pk, void* eps, const void* mrow, const void* order,
                         const void* mask, const void* sc, void* out, void* ws, int m_loc,
                         int nb, int window, int sub_window, int n_mix, int complete,
                         void* stream) {
    return hydra::run_sweep_sd(static_cast<const uint8_t*>(pk), static_cast<float*>(eps),
                               static_cast<const float*>(mrow),
                               static_cast<const int*>(order),
                               static_cast<const float*>(mask),
                               static_cast<const float*>(sc), static_cast<float*>(out), ws,
                               m_loc, nb, window, sub_window, n_mix, complete,
                               static_cast<cudaStream_t>(stream));
}

// Bytes of device scratch one window_stats call needs.
long long hydra_window_workspace_bytes(int nb, int window, int exact, int complete) {
    return static_cast<long long>(
        hydra::window_layout(nullptr, nb, window, exact != 0, complete != 0).bytes);
}

// (s1, s2[, gram]) of the window rows[0..W) of pk against eps (4*nb,):
// s1 = sum g*eps (complete stale: 2 sum(eps) - sum h*eps), s2 = sum m*eps
// (complete: sum(eps)); exact adds the standardized Gram (W, W) from
// mave/mstd (W,) in window order and n_real (1,).
int hydra_window_stats(const void* pk, const void* eps, const void* rows,
                       const void* mave, const void* mstd, const void* n_real,
                       void* s1, void* s2, void* gram, void* ws, int window, int nb,
                       int exact, int complete, void* stream) {
    return hydra::run_window_stats(
        static_cast<const uint8_t*>(pk), static_cast<const float*>(eps),
        static_cast<const int*>(rows), static_cast<const float*>(mave),
        static_cast<const float*>(mstd), static_cast<const float*>(n_real),
        static_cast<float*>(s1), static_cast<float*>(s2), static_cast<float*>(gram), ws,
        window, nb, exact != 0, complete, static_cast<cudaStream_t>(stream));
}

// The exact recurrence of one window (window_gibbs): outputs dbeta, bnew,
// acum (W,) f32 and comp (W,) int32.
int hydra_window_gibbs(const void* gram, const void* num0, const void* logl,
                       const void* invd, const void* sd, const void* u,
                       const void* nrm, const void* act, const void* bold,
                       const void* i2se, void* dbeta, void* bnew, void* comp,
                       void* acum, int window, int n_mix, void* stream) {
    using namespace hydra;
    if (window < 1 || n_mix < 2) return static_cast<int>(cudaErrorInvalidValue);
    const bool pieced = window > WIDE_W;
    auto* const gibbs =
        pieced ? by_components(n_mix, window_gibbs_kernel<4, true, true>,
                               window_gibbs_kernel<8, false, true>,
                               window_gibbs_kernel<K_MAX, false, true>,
                               window_gibbs_kernel<K_ANY, false, true>)
               : by_components(n_mix, window_gibbs_kernel<4, true>,
                               window_gibbs_kernel<8, false>, window_gibbs_kernel<K_MAX, false>,
                               window_gibbs_kernel<K_ANY, false>);
    const size_t base = window_gibbs_smem(pieced ? WIDE_W : window);
    const size_t smem = base + any_stage_bytes(pieced ? WIDE_W : window, n_mix, base);
    HYDRA_CHECK(allow_smem(gibbs, smem));
    for (int p0 = 0; p0 < window; p0 += WIDE_W) {
        const int wp = window - p0 < WIDE_W ? window - p0 : WIDE_W;
        gibbs<<<1, cdiv(wp, 32) * 32, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(gram), static_cast<const float*>(num0),
            static_cast<const float*>(logl), static_cast<const float*>(invd),
            static_cast<const float*>(sd), static_cast<const float*>(u),
            static_cast<const float*>(nrm), static_cast<const float*>(act),
            static_cast<const float*>(bold), static_cast<const float*>(i2se), window,
            n_mix, static_cast<float*>(dbeta), static_cast<float*>(bnew),
            static_cast<int*>(comp), static_cast<float*>(acum), p0);
        HYDRA_CHECK_LAUNCH();
    }
    return 0;
}

const char* hydra_sweep_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
