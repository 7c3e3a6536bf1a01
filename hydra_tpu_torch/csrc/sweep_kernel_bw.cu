// BayesW kernels for Hopper (sm_90a): the whole stale-window sweep and its
// two per-window passes on their own.
//
// Replaces the Pallas kernels
//   hydra_sweep_stale_bw     <- sweep_stale_bw    (hydra_tpu/ops/sweep_kernel_bw.py:330)
//   hydra_window_level_sums  <- window_level_sums (hydra_tpu/ops/window_kernels.py:356)
//   hydra_window_axpy        <- window_axpy       (hydra_tpu/ops/window_kernels.py:284)
//
// Per window of W markers (slots order[w*W .. w*W+W)), three launches on the
// caller's stream; the launch boundary is the barrier between them:
//   levels_kernel  (= window_level_sums, phase 0 of the TPU sweep): per-tile
//                  partials of s1 = sum_{h=1} vi, s2 = sum_{h=0} vi, the mask
//                  dot sum_{h!=3} vi (missing data only) and sum vi;
//   bw_draw_kernel (phase 0's last tile): one warp per marker reduces the
//                  partials in a fixed order and draws the marker
//                  (BayesW.cpp:1480-1640): closed-form own-effect removal,
//                  adaptive Gauss-Hermite marginal likelihoods, the
//                  component, and the slice draw of beta;
//   axpy_kernel<true> (= window_axpy + phase 1, sweep_kernel.cuh): eps +=
//                  the window's update and vi = exp(alpha*eps - EuMasc)*mask
//                  in the same pass (BayesW.cpp:1642-1834).
// At W=1 (exact sequential BayesW) a sweep is 3 launches per marker and
// host enqueue bounds it; launch fusion is left for a later change.
//
// This file compiles with -fmad=false: the draw's arithmetic is the plain
// PyTorch version's, operation by operation, because component and slice
// accept decisions are discontinuous in it. Where a fused multiply-add is
// meant (the accumulations), fmaf says so.
//
// Determinism: no float atomics; partials are reduced in a fixed order.

#include <cstdint>

#include "sweep_kernel.cuh"

namespace hydra {

constexpr int Q_MAX = 64;          // Gauss-Hermite nodes a draw takes
constexpr int DRAW_WARPS = 4;      // markers (warps) a draw block
constexpr unsigned FULL = 0xffffffffu;
constexpr int BW_LANE_K = 32;      // components a draw warp holds a lane each

// BayesW mrow column layout (hydra_tpu/ops/sweep_kernel_bw.py:64-81),
// J = K-1, S = n_shrink:
//   0 mave, 1 inv_sd, 2 bold, 3 u, 4 act, 5 sf, 6..8 th0..th2,
//   9..11 e0..e2, 12 ml0, 13.. pj[J], sqrt2ck[J], adc[J], two_ck_sg[J],
//   slim[J], then le, u_br, uu[S]
constexpr int BW_FIXED = 13;

// ------------------------------------------------------------- levels --
// Replaces phase 0's level sums of _sweep_bw_kernel (_levels, hydra_tpu/ops/
// sweep_kernel_bw.py:84-158) and _levels_kernel / window_level_sums
// (hydra_tpu/ops/window_kernels.py:319-390). Per-tile partials
// part[t * W + r] of the window's rows r: s1 = sum i1*vi, s2 = sum i2*vi,
// missing data also the mask dot sum m*vi, and part_all[t] = sum vi. Complete
// data uses the h-decode indicators i1 = h(2-h), i2 = (1-h)(2-h)/2 (exact
// integers; pads, h = 3, give -3 and 1 and meet vi == 0); missing data
// g = _decode_k's genotype, i1 = g(2-g), i2 = g(g-1)/2, m the mask.
//
// Bound: bytes, the W * nb packed bytes, vi once and the partials (1.03 MB
// at W=64, N=50,000: 0.31 us at 3.35 TB/s), just above the two or three
// f32 multiply-adds a genotype (0.29 us at 67 TFLOP/s). The design is
// stats_kernel's (StatsTile, sweep_kernel.cuh): a block covers one 512-byte
// tile for 16 rows; the tile's vi (8 KB) is staged once a block and each
// lane keeps its 64 values in registers for all of its warp's rows (the
// kernel before read a warp's own copy of vi for every row); a warp's rows'
// packed words are in flight together, and each block prefetches its tile
// of the next window's rows to L2. The indicators become floats a word at a
// time by a byte permute into 2^23 + y and one subtraction (byte_float),
// not the quarter-rate integer conversion: complete i1 = y - 3 with y = 3,
// 4, 3, 0 for h = 0..3, so each fmaf takes the same operands as before.
//
// Order (the partials are bit for bit the plain version's, level_partials):
// lane l adds its words l, l + 32, l + 64, l + 96, individual by individual,
// one fmaf a sum (missing: m, then i1, then i2), then the warp's xor
// butterfly; the warp of row 0 adds sum vi in the same lane order.

// byte q of x (0..4) minus 3 as a float, exactly: (2^23 + y) - (2^23 + 3)
__device__ __forceinline__ float byte_float_m3(uint32_t x, int q) {
    return __int_as_float(__byte_perm(x, 0x4B000000u, 0x7540 | q)) - 8388611.0f;
}

template <bool COMPLETE>
__global__ void __launch_bounds__(STATS_THREADS)
levels_kernel(const uint8_t* __restrict__ pk, int nb, const float* __restrict__ vi,
              const int* __restrict__ order_w, const int* __restrict__ next_w, int W,
              float* __restrict__ part_s1, float* __restrict__ part_s2,
              float* __restrict__ part_bv, float* __restrict__ part_all) {
    __shared__ __align__(16) float4 s_vi[STATS_TB];
    StatsTile tl;
    if (!tl.load(pk, nb, vi, order_w, next_w, W, s_vi)) return;
    const int t = blockIdx.x, lane = threadIdx.x & 31;
    const int nj = tl.nj;
    const auto& ev = tl.ev;
    if (tl.r0 == 0) {
        float tot = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (j < nj) {
#pragma unroll
                for (int i = 0; i < 16; ++i) tot += ev[j][i];
            }
        }
        tot = warp_sum(tot);
        if (lane == 0) part_all[t] = tot;
    }
#pragma unroll
    for (int p = 0; p < STATS_RPW; ++p) {
        const int r = tl.r0 + p;
        if (r >= W) break;
        float a = 0.f, b = 0.f, bv = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (j >= nj) break;
            const uint32_t w = tl.words[p][j], hi = w >> 1;
            // one bit a crumb (bit 2i): h == 1; then i2 and the mask
            const uint32_t one = w & ~hi & 0x55555555u;
            const uint32_t i2b = COMPLETE ? ~(w ^ hi) & 0x55555555u : ~(w | hi) & 0x55555555u;
            const uint32_t mb = ~(w & hi) & 0x55555555u;
            // complete: y = i1 + 3 = 3 [h even] + 4 [h == 1]; the 3s two
            // bits a crumb, the 4s moved to bit 2 of crumb 4q + k's byte
            const uint32_t even3 = (~w & 0x55555555u) * 3u;
            uint32_t x1[4], x2[4], xm[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const uint32_t fours = (k == 0 ? one << 2 : one >> (2 * k - 2)) & 0x04040404u;
                x1[k] = COMPLETE ? crumbs_at(even3, k) | fours : crumbs_at(one, k);
                x2[k] = crumbs_at(i2b, k);
                xm[k] = crumbs_at(mb, k);
            }
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const float v = ev[j][4 * q + k];
                    if (!COMPLETE) bv = fmaf(byte_float(xm[k], q), v, bv);
                    a = fmaf(COMPLETE ? byte_float_m3(x1[k], q) : byte_float(x1[k], q), v, a);
                    b = fmaf(byte_float(x2[k], q), v, b);
                }
        }
        a = warp_sum(a);
        b = warp_sum(b);
        if (!COMPLETE) bv = warp_sum(bv);
        if (lane == 0) {
            part_s1[t * W + r] = a;
            part_s2[t * W + r] = b;
            if (!COMPLETE) part_bv[t * W + r] = bv;
        }
    }
}

// Fixed-order tile reduction for the standalone window_level_sums.
__global__ void levels_reduce_kernel(const float* __restrict__ part_s1,
                                     const float* __restrict__ part_s2,
                                     const float* __restrict__ part_bv,
                                     int n_tiles, int W, int complete,
                                     float* __restrict__ s1,
                                     float* __restrict__ s2,
                                     float* __restrict__ sb) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= W) return;
    s1[r] = reduce_tiles(part_s1, n_tiles, W, r);
    s2[r] = reduce_tiles(part_s2, n_tiles, W, r);
    if (!complete) sb[r] = reduce_tiles(part_bv, n_tiles, W, r);
}

// ---------------------------------------------------------------- draw --
struct BwDens {
    float alpha, sf, vi0, vi1, vi2, th0, th1, th2, two_ck_sg;
    // beta_dens in the expm1 form (BayesW.cpp:145-156, samplers/bayesw.py)
    __device__ __forceinline__ float operator()(float x) const {
        return -alpha * x * sf - vi0 * expm1f(th0 * x) - vi1 * expm1f(th1 * x)
               - vi2 * expm1f(th2 * x) - x * x / two_ck_sg;
    }
};

// Marker r's level sums over the tiles, each in tile order from 0.f as
// reduce_tiles adds them, on every lane: the lanes load 32 tiles' partials
// at once into the warp's st (4 x 32 floats of shared memory), then every
// lane adds them in tile order, the four sums interleaved (complete data's
// mask dot stays 0).
struct LevelSums {
    float s1, s2, sb, s_all;
};

__device__ __forceinline__ LevelSums warp_level_sums(
    const float* __restrict__ part_s1, const float* __restrict__ part_s2,
    const float* __restrict__ part_bv, const float* __restrict__ part_all, int n_tiles,
    int W, int r, bool complete, int lane, float (*st)[32]) {
    LevelSums ls{0.f, 0.f, 0.f, 0.f};
    for (int t0 = 0; t0 < n_tiles; t0 += 32) {
        const int t = t0 + lane;
        const bool in = t < n_tiles;
        st[0][lane] = in ? part_s1[t * W + r] : 0.f;
        st[1][lane] = in ? part_s2[t * W + r] : 0.f;
        st[2][lane] = in && !complete ? part_bv[t * W + r] : 0.f;
        st[3][lane] = in ? part_all[t] : 0.f;
        __syncwarp();
        const int n = min(32, n_tiles - t0);
#pragma unroll 8
        for (int i = 0; i < n; ++i) {
            ls.s1 += st[0][i];
            ls.s2 += st[1][i];
            ls.sb += st[2][i];
            ls.s_all += st[3][i];
        }
        __syncwarp();
    }
    return ls;
}

// x0 stepped k times by d, one rounding a step (the stepping-out chain)
__device__ __forceinline__ float step_out(float x0, float d, int k) {
    for (int i = 0; i < k; ++i) x0 = x0 + d;
    return x0;
}

__device__ __forceinline__ float step_in(float x0, float d, int k) {
    for (int i = 0; i < k; ++i) x0 = x0 - d;
    return x0;
}

// Replaces the draw of _sweep_bw_kernel (_draw, hydra_tpu/ops/
// sweep_kernel_bw.py:159-291, its slice sampler at 235-291), without the
// TPU's row layout, Taylor expm1, 128-lane GH pad or bf16 split. One warp
// per marker, DRAW_WARPS markers a block, cdiv(W, DRAW_WARPS) blocks.
//
// Bound: bytes, the W mrow rows, the tile partials, out and coef (~35 KB at
// W=64, N=50,000: 0.010 us at 3.35 TB/s); the ~2,700 f32 operations and
// ~440 transcendentals a marker are less (0.003 us at 67 TFLOP/s). So the
// kernel is latency-bound: a marker is a chain of dependent steps. The
// kernel before ran one thread per marker in one block (one SM of 132),
// each thread through the (K-1) Q quadrature nodes and a fixed slice budget
// of 1 + 2 n_expand + n_shrink log-density evaluations in series. Here:
//  - the markers spread over the card, a warp each;
//  - the row's columns are loaded first, a lane's component's columns on
//    its own lane, so that their latency overlaps the partials';
//  - the lanes load the tile partials 32 tiles at once; every lane adds
//    them in tile order from 0.f (warp_level_sums), as reduce_tiles does,
//    the four sums interleaved;
//  - the lanes take the (K-1) Q quadrature nodes (j, q), each term
//    gh_w[q] * expf(temp) with the same operations as before, into shared
//    memory (sigma_ad computed once a component, on lane j + 1); lane
//    j + 1 adds component j's terms in node order from 0.f, so ml[j + 1]
//    lives in lane j + 1 (not in local memory); the mixture sums run in
//    component order through shuffles;
//  - the slice draw is skipped where its result is unused (comp == 0 or
//    act == 0: beta_new = 0 whatever it returns);
//  - stepping out in one round: lane p evaluates f at point p of bold,
//    left_0..left_{n-1} and right_0..right_{n-1}, each built by the
//    loop's own repeated subtraction (addition) of width; a side stops at
//    its first failing step, as the loop does (every later step re-tests
//    the same point and fails again);
//  - shrinking in one round: a rejected step moves the bracket by
//    xc < bold alone, so the candidates of all steps (each as if the ones
//    before it were rejected) follow from the bracket chain without f;
//    lane i evaluates step i and the first accepted one is the draw
//    (after acceptance x, left and right never change);
//  - complete data's axpy constant 2 sum(c1) + sum(c2) needs every marker
//    of the window, in window order from 0.f: the axpy kernel that follows
//    adds it (refresh_cst, sweep_kernel.cuh) from its shared c1 and c2.
//    Left to the last draw block to finish (a ticket, __threadfence, a
//    re-read of c1 and c2), it sat at the end of the draw's critical path
//    behind two device-wide round trips.
// Dynamic shared memory: draw_smem (the warps' quadrature terms and their
// copies of the Gauss-Hermite table).
// WIDE_K (more than BW_LANE_K components, one a lane no longer fits): the
// components' sigma_ad, sqrt2ck and ml wait in the warp's shared memory
// instead of on lane j + 1 (lane l computes components l, l + 32, ...),
// the mixture sums run in component order from there, and the selected
// component's two_ck_sg and slim come from the row: the same operations
// in the same order (this file has no contraction).
template <bool WIDE_K = false>
__global__ void __launch_bounds__(DRAW_WARPS * 32)
bw_draw_kernel(const float* __restrict__ mrow, int C, int K,
               const int* __restrict__ order_w, int W,
               const float* __restrict__ part_s1,
               const float* __restrict__ part_s2,
               const float* __restrict__ part_bv,
               const float* __restrict__ part_all, int n_tiles,
               int complete, const float* __restrict__ ghx,
               const float* __restrict__ ghw, int Q,
               const float* __restrict__ sc, int n_expand,
               int n_shrink, float* __restrict__ out,
               float* __restrict__ coef) {
    extern __shared__ float sh[];
    __shared__ float s_tiles[DRAW_WARPS][4][32];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = blockIdx.x * DRAW_WARPS + warp;
    const int km1 = K - 1, nq = km1 * Q;
    if (r < W) {
        const float alpha = sc[0];
        const int slot = order_w[r];
        const float* row = mrow + static_cast<size_t>(slot) * C;
        // the row first, so that its load runs beside the partials': the
        // fixed columns, on lane j + 1 component j's (pj, sqrt2ck, adc,
        // two_ck_sg, slim), on lane i the first round's shrink uniform i
        const int bp = BW_FIXED, bs = BW_FIXED + km1, ba = BW_FIXED + 2 * km1;
        const int bt = BW_FIXED + 3 * km1, bl = BW_FIXED + 4 * km1;
        const int br = BW_FIXED + 5 * km1;
        const int jl = lane >= 1 && lane <= km1 ? lane - 1 : 0;
        const float mave = row[0], inv_sd = row[1], bold = row[2];
        const float u = row[3], act = row[4];
        BwDens f;
        f.alpha = alpha;
        f.sf = row[5];
        f.th0 = row[6];
        f.th1 = row[7];
        f.th2 = row[8];
        const float e0 = row[9], e1 = row[10], e2 = row[11], ml0 = row[12];
        const float pj_l = row[bp + jl], sqk_l = row[bs + jl], adc_l = row[ba + jl];
        const float tck_l = row[bt + jl], slim_l = row[bl + jl];
        const float le = row[br], u_br = row[br + 1];
        const float uu0 = lane < n_shrink ? row[br + 2 + lane] : 0.f;
        // the warp's copy of the Gauss-Hermite table
        float* s_gx = sh + DRAW_WARPS * nq + warp * 2 * Q;
        float* s_gw = s_gx + Q;
        for (int q = lane; q < Q; q += 32) {
            s_gx[q] = ghx[q];
            s_gw[q] = ghw[q];
        }
        const LevelSums ls = warp_level_sums(part_s1, part_s2, part_bv, part_all, n_tiles,
                                             W, r, complete, lane, s_tiles[warp]);
        const float s1 = ls.s1, s2 = ls.s2, s_all = ls.s_all;
        const float sm = complete ? 0.f : s_all - ls.sb;
        const float s0 = s_all - s1 - s2 - sm;

        // own-effect removal (tmp_vi recompute, BayesW.cpp:1499-1516)
        f.vi1 = s1 * e1;
        f.vi2 = s2 * e2;
        const float vsum = s0 * e0 + f.vi1 + f.vi2 + sm;
        f.vi0 = vsum - f.vi1 - f.vi2;
        const float exp_sum = (f.vi1 * (1.0f - 2.0f * mave)
                               + 4.0f * (1.0f - mave) * f.vi2
                               + vsum * mave * mave) * inv_sd * inv_sd;

        // adaptive Gauss-Hermite marginal likelihoods (BayesW.cpp:716-726);
        // sigma_ad is the substitution's Jacobian (BayesW.cpp:711); lane
        // j + 1 holds component j's (WIDE_K: s_sig[j], s_sqk[j])
        const float sig_l = 1.0f / sqrtf(1.0f + adc_l * exp_sum);
        float* term = sh + warp * nq;
        float* s_ml = sh + DRAW_WARPS * (nq + 2 * Q) + warp * 3 * K;   // WIDE_K: ml[K]
        float* s_sig = s_ml + K;                                       // [K - 1]
        float* s_sqk = s_sig + K - 1;                                  // [K - 1]
        if constexpr (WIDE_K) {
            for (int j = lane; j < km1; j += 32) {
                s_sig[j] = 1.0f / sqrtf(1.0f + row[ba + j] * exp_sum);
                s_sqk[j] = row[bs + j];
            }
        }
        __syncwarp();
        // node n's term (nodes past nq computed on a clamped node, not
        // stored): three a lane at a time, straight-line, so that their
        // transcendentals overlap
        auto node = [&](int n) {
            const int nn = min(n, nq - 1);
            const int j = nn / Q, q = nn - j * Q;
            const float sigma_ad = WIDE_K ? s_sig[j] : __shfl_sync(FULL, sig_l, j + 1);
            const float sqk = WIDE_K ? s_sqk[j] : __shfl_sync(FULL, sqk_l, j + 1);
            const float s_node = sigma_ad * s_gx[q];
            const float sq = s_node * sqk;
            const float temp = -alpha * sq * f.sf - f.vi0 * expm1f(f.th0 * sq)
                               - f.vi1 * expm1f(f.th1 * sq)
                               - f.vi2 * expm1f(f.th2 * sq) - s_node * s_node;
            const float v = s_gw[q] * expf(temp);
            if (n < nq) term[n] = v;
        };
        for (int n0 = 0; n0 < nq; n0 += 96) {
            node(n0 + lane);
            node(n0 + 32 + lane);
            node(n0 + 64 + lane);
        }
        __syncwarp();
        float ml = ml0;                        // lane j: ml[j]
        float sm_ml, compf;
        if constexpr (WIDE_K) {
            // component j + 1's ml on lane j mod 32, into s_ml; the sums
            // from there in component order, on every lane
            if (lane == 0) s_ml[0] = ml0;
            for (int j = lane; j < km1; j += 32) {
                float acc = 0.f;
#pragma unroll 8
                for (int q = 0; q < Q; ++q) acc = acc + term[j * Q + q];
                s_ml[1 + j] = row[bp + j] * (s_sig[j] * acc);
            }
            __syncwarp();
            sm_ml = s_ml[0];
            for (int j = 1; j < K; ++j) sm_ml = sm_ml + s_ml[j];
            float cum = s_ml[0] / sm_ml;
            compf = u > cum ? 1.f : 0.f;
            for (int j = 1; j < K; ++j) {
                cum = cum + s_ml[j] / sm_ml;
                compf = compf + (u > cum ? 1.f : 0.f);
            }
        } else {
            if (lane >= 1 && lane <= km1) {
                float acc = 0.f;
#pragma unroll 8
                for (int q = 0; q < Q; ++q) acc = acc + term[jl * Q + q];
                ml = pj_l * (sig_l * acc);
            }
            sm_ml = __shfl_sync(FULL, ml, 0);
            for (int j = 1; j < K; ++j) sm_ml = sm_ml + __shfl_sync(FULL, ml, j);
            // comp = min(#{cum probs < u}, K-1), zeroed for inactive markers
            const float pr = ml / sm_ml;
            float cum = __shfl_sync(FULL, pr, 0);
            compf = u > cum ? 1.f : 0.f;
            for (int j = 1; j < K; ++j) {
                cum = cum + __shfl_sync(FULL, pr, j);
                compf = compf + (u > cum ? 1.f : 0.f);
            }
        }
        compf = fminf(compf, static_cast<float>(km1)) * act;

        // slice sampler on beta_dens (utils/slice_sampler.py), only where
        // its result is used (warp-uniform)
        const bool draw = compf > 0.f && act > 0.f;
        float x = bold;
        if (draw) {
            const int ksel = compf > 1.f ? static_cast<int>(compf) - 1 : 0;
            f.two_ck_sg = WIDE_K ? row[bt + ksel] : __shfl_sync(FULL, tck_l, ksel + 1);
            const float slim = WIDE_K ? row[bl + ksel] : __shfl_sync(FULL, slim_l, ksel + 1);
            const float width = fmaxf(slim / 5.0f, 1e-3f);
            const float lower = bold - slim, upper = bold + slim;
            const float left0 = bold - width * u_br;
            const float right0 = left0 + width;
            // point p: 0 bold, 1 + k left_k, 1 + n_expand + k right_k
            float log_y = 0.f;
            int kl = n_expand, kr = n_expand;  // first failing step a side
            for (int p0 = 0; p0 <= 2 * n_expand; p0 += 32) {
                if (p0 > 0 && kl < n_expand && kr < n_expand) break;
                const int p = p0 + lane;
                const bool is_l = p >= 1 && p <= n_expand;
                const bool is_r = p > n_expand && p <= 2 * n_expand;
                const float xp = is_l ? step_in(left0, width, p - 1)
                                 : is_r ? step_out(right0, width, p - 1 - n_expand)
                                        : bold;
                const float fp = f(xp);
                if (p0 == 0) log_y = __shfl_sync(FULL, fp, 0) - le;
                const unsigned fl = __ballot_sync(FULL, is_l && !(fp > log_y && xp > lower));
                const unsigned fr = __ballot_sync(FULL, is_r && !(fp > log_y && xp < upper));
                if (kl == n_expand && fl) kl = p0 + __ffs(fl) - 2;
                if (kr == n_expand && fr) kr = p0 + __ffs(fr) - 2 - n_expand;
            }
            float left = fmaxf(step_in(left0, width, kl), lower);
            float right = fminf(step_out(right0, width, kr), upper);
            // shrinking: a rejected step moves the bracket by xc < bold
            // alone, so steps s0..s0+31 (each as if every step before it
            // was rejected) are known before f: every lane runs the bracket
            // chain, lane i evaluates step s0 + i, the first accepted is x
            for (int s0 = 0; s0 < n_shrink; s0 += 32) {
                const int n = min(32, n_shrink - s0);
                const float uu = s0 == 0 ? uu0 : lane < n ? row[br + 2 + s0 + lane] : 0.f;
                float xc_l = bold;
#pragma unroll 8
                for (int i = 0; i < n; ++i) {
                    const float xc = left + __shfl_sync(FULL, uu, i) * (right - left);
                    if (i == lane) xc_l = xc;
                    if (xc < bold) left = xc;
                    else right = xc;
                }
                const unsigned ok = __ballot_sync(FULL, lane < n && f(xc_l) > log_y);
                if (ok) {
                    x = __shfl_sync(FULL, xc_l, __ffs(ok) - 1);
                    break;
                }
            }
        }
        const float bnew = draw ? x : 0.f;
        const float dbeta = bold - bnew;
        const float c1 = dbeta * inv_sd;
        if (lane == 0) {
            reinterpret_cast<float4*>(out)[slot] = make_float4(bnew, compf, dbeta, 0.f);
            coef[r] = c1;
            coef[W + r] = -c1 * mave;
        }
    }
}

inline size_t draw_smem(int K, int Q) {
    return sizeof(float) * DRAW_WARPS *
           ((K + 1) * static_cast<size_t>(Q) + (K > BW_LANE_K ? 3 * K : 0));
}

// ------------------------------------------------------------ workspace --
struct BwWorkspace {
    float* part_s1;
    float* part_s2;
    float* part_bv;
    float* part_all;
    float* coef;
    size_t bytes;
};

inline BwWorkspace bw_layout(void* base, int nb, int W) {
    const size_t n_tiles = cdiv(nb, STATS_TB);
    size_t off = 0;
    BwWorkspace ws{};
    char* p = static_cast<char*>(base);
    auto take = [&](size_t floats) {
        float* out = reinterpret_cast<float*>(p + off);
        off += align256(floats * sizeof(float));
        return out;
    };
    ws.part_s1 = take(n_tiles * W);
    ws.part_s2 = take(n_tiles * W);
    ws.part_bv = take(n_tiles * W);
    ws.part_all = take(n_tiles);
    ws.coef = take(2 * static_cast<size_t>(W));
    ws.bytes = off;
    return ws;
}

// One window's level-sum partials over its W rows order_w[0..W); next_w
// (may be null) the next window's rows, prefetched to L2.
inline int levels_launch(const uint8_t* pk, int nb, const float* vi, const int* order_w,
                         const int* next_w, int W, int complete, const BwWorkspace& ws,
                         cudaStream_t stream) {
    auto* const kernel = complete ? levels_kernel<true> : levels_kernel<false>;
    kernel<<<stats_grid(nb, W), stats_threads(W), 0, stream>>>(
        pk, nb, vi, order_w, next_w, W, ws.part_s1, ws.part_s2, ws.part_bv, ws.part_all);
    HYDRA_CHECK_LAUNCH();
    return 0;
}

int run_sweep_bw(const uint8_t* pk, float* eps, float* vi, const float* mrow,
                 const int* order, const float* mask, const float* ghx,
                 const float* ghw, int Q, const float* sc, float* out,
                 void* ws_base, int m_loc, int nb, int W, int K, int complete,
                 int n_expand, int n_shrink, cudaStream_t stream) {
    if (W < 1 || m_loc <= 0 || m_loc % W || nb <= 0 || nb % 128 ||
        K < 2 || Q < 1 || Q > Q_MAX || n_expand < 0 ||
        n_shrink < 0 || mask == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    const int C = BW_FIXED + 5 * (K - 1) + 2 + n_shrink;
    const BwWorkspace ws = bw_layout(ws_base, nb, W);
    const int n_tiles = cdiv(nb, STATS_TB);
    const int n_windows = m_loc / W;
    const int draw_blocks = cdiv(W, DRAW_WARPS);
    const int draw_threads = 32 * (W < DRAW_WARPS ? W : DRAW_WARPS);
    const size_t smem = draw_smem(K, Q);
    const int mode = complete ? MODE_STALE_COMPLETE : MODE_MISSING;
    auto* const draw = K > BW_LANE_K ? bw_draw_kernel<true> : bw_draw_kernel<false>;
    HYDRA_CHECK(allow_smem(draw, smem + sizeof(float) * DRAW_WARPS * 4 * 32));
    for (int w = 0; w < n_windows; ++w) {
        const int* order_w = order + static_cast<size_t>(w) * W;
        int err = levels_launch(pk, nb, vi, order_w, w + 1 < n_windows ? order_w + W : nullptr,
                                W, complete, ws, stream);
        if (err) return err;
        draw<<<draw_blocks, draw_threads, smem, stream>>>(
            mrow, C, K, order_w, W, ws.part_s1, ws.part_s2, ws.part_bv,
            ws.part_all, n_tiles, complete, ghx, ghw, Q, sc, n_expand, n_shrink,
            out, ws.coef);
        HYDRA_CHECK_LAUNCH();
        err = launch_axpy<true>(pk, nb, order_w, W, mode, ws.coef, mask, eps, vi, sc, stream);
        if (err) return err;
    }
    return 0;
}

}  // namespace hydra

extern "C" {

// Bytes of device scratch one BayesW sweep or window_level_sums call needs.
long long hydra_bw_workspace_bytes(int nb, int window) {
    return static_cast<long long>(hydra::bw_layout(nullptr, nb, window).bytes);
}

// A whole BayesW stale-window sweep. eps and vi (4*nb,) are updated in
// place; out (m_loc, 4) receives [beta_new, comp, dbeta, 0] per SLOT; order
// (m_loc,) maps sweep position -> slot; sc = [alpha]; ghx/ghw the Q
// Gauss-Hermite nodes and adjusted weights; mask the individual mask.
int hydra_sweep_stale_bw(const void* pk, void* eps, void* vi, const void* mrow,
                         const void* order, const void* mask, const void* ghx,
                         const void* ghw, int q, const void* sc, void* out,
                         void* ws, int m_loc, int nb, int window, int n_mix,
                         int complete, int n_expand, int n_shrink, void* stream) {
    return hydra::run_sweep_bw(
        static_cast<const uint8_t*>(pk), static_cast<float*>(eps),
        static_cast<float*>(vi), static_cast<const float*>(mrow),
        static_cast<const int*>(order), static_cast<const float*>(mask),
        static_cast<const float*>(ghx), static_cast<const float*>(ghw), q,
        static_cast<const float*>(sc), static_cast<float*>(out), ws, m_loc, nb,
        window, n_mix, complete, n_expand, n_shrink,
        static_cast<cudaStream_t>(stream));
}

// (s1, s2, sb) (W,) for the W rows order[0..W) of pk: sum_{g=1} vi,
// sum_{g=2} vi and, for missing data, the mask dot (sb untouched when
// complete).
int hydra_window_level_sums(const void* pk, const void* vi, const void* order,
                            void* s1, void* s2, void* sb, void* ws, int window,
                            int nb, int complete, void* stream) {
    using namespace hydra;
    if (window < 1 || nb <= 0 || nb % 128) return static_cast<int>(cudaErrorInvalidValue);
    const BwWorkspace w = bw_layout(ws, nb, window);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int err = levels_launch(static_cast<const uint8_t*>(pk), nb,
                                  static_cast<const float*>(vi), static_cast<const int*>(order),
                                  nullptr, window, complete, w, st);
    if (err) return err;
    levels_reduce_kernel<<<cdiv(window, 256), 256, 0, st>>>(
        w.part_s1, w.part_s2, w.part_bv, cdiv(nb, STATS_TB), window, complete,
        static_cast<float*>(s1), static_cast<float*>(s2), static_cast<float*>(sb));
    HYDRA_CHECK_LAUNCH();
    return 0;
}

// out (4*nb,) = sum_r c1_r * g_r + c2_r * m_r over the rows order[0..W),
// c1 and c2 (W,) each; out is written, not read. Complete data returns the
// genotype part only, as 2 sum(c1) - sum c1*h with sum(c1) in window order
// (the caller adds sum(c2) and masks). One launch: axpy_kernel<false, MODE,
// 0, true> (sweep_kernel.cuh) stages c1 and c2 and forms the constant
// itself; above WIDE_W its wide arm, a chunk of coefficients at a time.
int hydra_window_axpy(const void* pk, const void* order, const void* c1, const void* c2,
                      void* out, int window, int nb, int complete, void* stream) {
    using namespace hydra;
    if (window < 1 || nb <= 0 || nb % 128) return static_cast<int>(cudaErrorInvalidValue);
    const bool wide = window > WIDE_W;
    auto* const kernel =
        wide ? (complete ? axpy_kernel<false, MODE_STALE_COMPLETE, 0, true, true>
                         : axpy_kernel<false, MODE_MISSING, 0, true, true>)
             : (complete ? axpy_kernel<false, MODE_STALE_COMPLETE, 0, true>
                         : axpy_kernel<false, MODE_MISSING, 0, true>);
    kernel<<<nb / AXPY_TB, AXPY_THREADS,
             2 * sizeof(float) * (wide ? AXPY_ROWS : (window + 3) & ~3),
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(pk), nb, static_cast<const int*>(order), window,
        static_cast<const float*>(c1), nullptr, static_cast<float*>(out), nullptr,
        static_cast<const float*>(c2), StaleDrawArgs{});
    HYDRA_CHECK_LAUNCH();
    return 0;
}

const char* hydra_bw_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
