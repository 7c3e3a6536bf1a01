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
//   stale: stats_mt -> stale_draw_mt -> axpy_mt                (3 launches)
//   exact: stats_mt -> gram_i8 -> exact_mt_draw -> axpy_mt            (4)
// The exact sweep is valid for complete genotypes and full phenotypes only
// (the trait-shared integer Gram, standardized with trait 0's statistics
// and n_real; hydra_tpu/samplers/bayesrrm_mt.py:748-749 gates it the same).
//
// What bounds it on this card, per window: stats_mt and axpy_mt each read
// the W packed rows and the (n_pad, T) residual once, ~W*NB + 4*T*n_pad*
// (2 for the axpy) bytes -> bytes-bound, but at W=64..128 and N=50,000 a
// window is ~1-2 MB, so each launch is latency-bound (tens of us against
// ~0.5 us of HBM time). The decode stays in registers and is shared by the
// T traits (one byte load serves T fused multiply-adds); T partial sums per
// thread live in registers (T <= T_MAX). The exact recurrence is a serial
// chain of W steps per trait: one block per trait, each the BayesRRm exact
// draw's warp-synchronous design (warp_recurrence, sweep_kernel.cuh).
//
// Determinism: no float atomics (the Gram's are integer, exact in any
// order). Partials land in per-tile scratch and are reduced in a fixed
// order, so equal inputs give bitwise-equal outputs.

#include <cstdint>

#include "sweep_kernel.cuh"

namespace hydra {

constexpr int MT_STATS_TB = 512;     // packed bytes per stats block
constexpr int MT_STATS_ROWS = 8;     // rows per stats block (one per warp)
constexpr int MT_AXPY_THREADS = 128;
constexpr int MT_DRAW_THREADS = 256;

// ---------------------------------------------------------------- stats --
// grid (n_tiles, ceil(W / MT_STATS_ROWS)), 256 threads. Warp = one row of
// the window over one tile of MT_STATS_TB bytes, lane = one byte per step
// (4 individuals x T traits of eps, contiguous). Per trait:
//   MODE_MISSING        s1 = sum g*e, s2 = sum m*e
//   MODE_STALE_COMPLETE s1 = sum h*e (h-decode), s2 = sum e
//   MODE_EXACT_COMPLETE s1 = sum g*e, s2 = sum e, and v = sum g per row
// Partials: part[(tile * W + r) * T + t], part_v[tile * W + r].
__global__ void stats_mt_kernel(const uint8_t* __restrict__ pk, int nb,
                                const float* __restrict__ eps, int T,
                                const int* __restrict__ order_w, int W, int mode,
                                float* __restrict__ part_s1,
                                float* __restrict__ part_s2,
                                float* __restrict__ part_v) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = blockIdx.y * MT_STATS_ROWS + warp;
    if (r >= W) return;
    const int tile = blockIdx.x;
    const uint8_t* row = pk + static_cast<size_t>(order_w[r]) * nb;
    const int b1 = min((tile + 1) * MT_STATS_TB, nb);
    float a[T_MAX], s[T_MAX];
#pragma unroll
    for (int t = 0; t < T_MAX; ++t) {
        a[t] = 0.f;
        s[t] = 0.f;
    }
    int v = 0;
    for (int b = tile * MT_STATS_TB + lane; b < b1; b += 32) {
        const uint32_t byte = row[b];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int c = crumb(byte, k);
            const float* e = eps + (4 * static_cast<size_t>(b) + k) * T;
            if (mode == MODE_STALE_COMPLETE) {
                const float h = static_cast<float>(c);
#pragma unroll
                for (int t = 0; t < T_MAX; ++t) {
                    if (t < T) {
                        const float x = e[t];
                        a[t] = fmaf(h, x, a[t]);
                        s[t] += x;
                    }
                }
            } else {
                const int m = crumb_mask(c);
                const int gi = (2 - c) * m;
                const float g = static_cast<float>(gi);
                const float mf = static_cast<float>(m);
                if (mode == MODE_EXACT_COMPLETE) v += gi;
#pragma unroll
                for (int t = 0; t < T_MAX; ++t) {
                    if (t < T) {
                        const float x = e[t];
                        a[t] = fmaf(g, x, a[t]);
                        s[t] = mode == MODE_EXACT_COMPLETE ? s[t] + x : fmaf(mf, x, s[t]);
                    }
                }
            }
        }
    }
    const size_t base = (static_cast<size_t>(tile) * W + r) * T;
#pragma unroll
    for (int t = 0; t < T_MAX; ++t) {
        if (t < T) {
            const float at = warp_sum(a[t]);
            const float st = warp_sum(s[t]);
            if (lane == 0) {
                part_s1[base + t] = at;
                part_s2[base + t] = st;
            }
        }
    }
    if (mode == MODE_EXACT_COMPLETE) {
        v = warp_sum(v);
        if (lane == 0) part_v[static_cast<size_t>(tile) * W + r] = static_cast<float>(v);
    }
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

// Stale draw: one thread per (marker r, trait t), e = r * T + t.
__global__ void stale_draw_mt_kernel(const float* __restrict__ mrow, int C, int K,
                                     int T, const int* __restrict__ order_w, int W,
                                     const float* __restrict__ part_s1,
                                     const float* __restrict__ part_s2, int n_tiles,
                                     int complete, const float* __restrict__ sc,
                                     float* __restrict__ out, float* __restrict__ coef) {
    const size_t wt = static_cast<size_t>(W) * T;
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= static_cast<int>(wt)) return;
    const int r = e / T, t = e % T;
    const int slot = order_w[r];
    MtMarker<K_MAX> c;
    c.load(mrow + static_cast<size_t>(slot) * C, T, t, K);
    const float s1 = reduce_tiles_mt(part_s1, n_tiles, wt, e);
    const float s2 = reduce_tiles_mt(part_s2, n_tiles, wt, e);
    const float s1v = complete ? 2.0f * s2 - s1 : s1;     // h-decode
    const float num0 = c.mstd * (s1v - c.mave * s2) + c.bold * sc[T + t];
    const Draw d = normalized_draw(num0, c, K, sc[t]);
    float* o = out + static_cast<size_t>(slot) * 3 * T;
    o[t] = d.bnew;
    o[T + t] = d.comp(c.act);
    o[2 * T + t] = d.acum(c.act);
    const float c1 = (c.bold - d.bnew) * c.mstd;
    coef[static_cast<size_t>(t) * W + r] = c1;
    coef[wt + static_cast<size_t>(t) * W + r] = -c1 * c.mave;
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
// {4, 8, K_MAX} by by_components). The T chains run on T SMs at once; each
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
// Gram and its own trait's for num0 and the coefficients.
template <int KB, bool FIXED>
__global__ void __launch_bounds__(1024)
exact_mt_draw_kernel(const float* __restrict__ mrow, int C, int k_run, int T,
                     const int* __restrict__ order_w, int W,
                     const float* __restrict__ part_s1, const float* __restrict__ part_s2,
                     const float* __restrict__ part_v, int n_tiles,
                     const float* __restrict__ G, const float* __restrict__ sc,
                     float* __restrict__ out, float* __restrict__ coef) {
    const int K = FIXED ? KB : k_run;
    const int t = blockIdx.x, r = threadIdx.x;
    extern __shared__ float sh[];
    float* s_mave = sh + W;               // [W] trait 0's, for the Gram
    float* s_mstd = sh + 2 * W;           // [W]
    float* s_v = sh + 3 * W;              // [W]
    const size_t wt = static_cast<size_t>(W) * T;
    const bool live = r < W;
    MtMarker<KB> c;
    int slot = 0;
    float numv = 0.f, mave0 = 0.f, mstd0 = 0.f, v = 0.f;
    if (live) {
        slot = order_w[r];
        const float* row = mrow + static_cast<size_t>(slot) * C;
        c.load(row, T, t, K);
        const size_t e = static_cast<size_t>(r) * T + t;
        const float s1 = reduce_tiles_mt(part_s1, n_tiles, wt, e);
        const float s2 = reduce_tiles_mt(part_s2, n_tiles, wt, e);
        numv = c.mstd * (s1 - c.mave * s2) + c.bold * sc[T + t];
        mave0 = row[0];
        mstd0 = row[T];
        v = reduce_tiles(part_v, n_tiles, W, r);
        s_mave[r] = mave0;
        s_mstd[r] = mstd0;
        s_v[r] = v;
    }
    __syncthreads();
    const float n_real = sc[2 * T], i2se = sc[t];
    const Draw mine = warp_recurrence(
        W, numv, [&](int rj) { return G + static_cast<size_t>(rj) * W + r; },
        [&](int rj, float g) {
            return std_gram(g, 1, mave0, mstd0, v, s_mave[rj], s_mstd[rj], s_v[rj], n_real);
        },
        [&](float num) {
            return exact_draw<KB>(num, c.logl, c.invd, c.sd, K, c.u, c.nrm, c.act, c.bold,
                                  i2se);
        },
        sh, sh + 4 * W);
    if (live) {
        float* o = out + static_cast<size_t>(slot) * 3 * T;
        o[t] = mine.bnew;
        o[T + t] = mine.comp(c.act);
        o[2 * T + t] = mine.acum(c.act);
        const float c1 = mine.dbeta * c.mstd;
        coef[static_cast<size_t>(t) * W + r] = c1;
        coef[wt + static_cast<size_t>(t) * W + r] = -c1 * c.mave;
    }
}

// The per-window recurrence: num0 (W, T) and a standardized f32 Gram in,
// the sampler's draw_rows form (bayesrrm_mt.py:384-388); out (4, W, T) =
// [beta_new, comp, acum, dbeta]. The per-trait Gram (a masked product) is
// not bitwise symmetric, so lane i reads G(i, j) = G[t][i][j] (row = the
// marker it updates, column = the step), as the plain version's
// gram[:, :, j] and the JAX scan's blocks[..., j]: a row a lane, from L2.
template <int KB, bool FIXED, bool SHARED>
__global__ void __launch_bounds__(1024)
window_recurrence_mt_kernel(const float* __restrict__ G, const float* __restrict__ num0,
                            const float* __restrict__ mrow, int C, int k_run, int T,
                            const int* __restrict__ order_w, int W,
                            const float* __restrict__ i2se, float* __restrict__ out) {
    const int K = FIXED ? KB : k_run;
    const int t = blockIdx.x, r = threadIdx.x;
    extern __shared__ float sh[];
    const bool live = r < W;
    MtMarker<KB> c;
    float numv = 0.f;
    if (live) {
        c.load(mrow + static_cast<size_t>(order_w[r]) * C, T, t, K);
        numv = num0[static_cast<size_t>(r) * T + t];
    }
    const float* g_row = G + ((SHARED ? 0 : static_cast<size_t>(t) * W) + r) * W;
    const float i2se_t = i2se[t];
    const Draw mine = warp_recurrence(
        W, numv, [&](int rj) { return g_row + rj; }, [](int, float g) { return g; },
        [&](float num) { return normalized_draw(num, c, K, i2se_t); }, sh, sh + 4 * W);
    if (live) {
        const size_t wt = static_cast<size_t>(W) * T;
        const size_t e = static_cast<size_t>(r) * T + t;
        out[e] = mine.bnew;
        out[wt + e] = mine.comp(c.act);
        out[2 * wt + e] = mine.acum(c.act);
        out[3 * wt + e] = mine.dbeta;
    }
}

// ----------------------------------------------------------------- axpy --
// d[i, t] for individual i = 4b + k, one thread per packed byte, T x 4
// accumulators in registers, the window's coefficients in shared memory:
//   COMPLETE d = cst_t - sum_r c1[t, r] * h_r,  cst_t = 2 sum c1 + (add_c2 ?
//            sum c2 : 0)   (sum c1*g = 2 sum c1 - sum c1*h)
//   else     d = sum_r c1[t, r] * g_r + c2[t, r] * m_r
// out[i*T + t] += d * tm[i*T + t]; a null tm reads as 1 (the standalone
// window_axpy_mt contract: the caller adds sum(c2) and masks).
template <bool COMPLETE>
__global__ void axpy_mt_kernel(const uint8_t* __restrict__ pk, int nb,
                               const int* __restrict__ order_w, int W, int T,
                               const float* __restrict__ coef, int add_c2,
                               const float* __restrict__ tm, float* __restrict__ out) {
    extern __shared__ float sh[];   // c1[T*W], c2[T*W], cst[T_MAX], slot[W]
    const int tw = T * W;
    float* s_c1 = sh;
    float* s_c2 = sh + tw;
    float* s_cst = sh + 2 * tw;
    int* s_slot = reinterpret_cast<int*>(s_cst + T_MAX);
    for (int i = threadIdx.x; i < tw; i += blockDim.x) {
        s_c1[i] = coef[i];
        s_c2[i] = coef[tw + i];
    }
    for (int i = threadIdx.x; i < W; i += blockDim.x) s_slot[i] = order_w[i];
    __syncthreads();
    if (COMPLETE && threadIdx.x < T) {
        const int t = threadIdx.x;
        float a = 0.f, c = 0.f;
        for (int r = 0; r < W; ++r) a += s_c1[t * W + r];
        if (add_c2)
            for (int r = 0; r < W; ++r) c += s_c2[t * W + r];
        s_cst[t] = 2.0f * a + c;
    }
    __syncthreads();
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= nb) return;
    float acc[T_MAX][4];
#pragma unroll
    for (int t = 0; t < T_MAX; ++t)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[t][k] = 0.f;
    for (int r = 0; r < W; ++r) {
        const uint32_t byte = pk[static_cast<size_t>(s_slot[r]) * nb + b];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int c = crumb(byte, k);
            if (COMPLETE) {
                const float h = static_cast<float>(c);
#pragma unroll
                for (int t = 0; t < T_MAX; ++t)
                    if (t < T) acc[t][k] = fmaf(s_c1[t * W + r], h, acc[t][k]);
            } else {
                const float m = static_cast<float>(crumb_mask(c));
                const float g = static_cast<float>(crumb_geno(c));
#pragma unroll
                for (int t = 0; t < T_MAX; ++t)
                    if (t < T) {
                        acc[t][k] = fmaf(s_c1[t * W + r], g, acc[t][k]);
                        acc[t][k] = fmaf(s_c2[t * W + r], m, acc[t][k]);
                    }
            }
        }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const size_t i = (4 * static_cast<size_t>(b) + k) * T;
#pragma unroll
        for (int t = 0; t < T_MAX; ++t)
            if (t < T) {
                const float d = COMPLETE ? s_cst[t] - acc[t][k] : acc[t][k];
                const float mk = tm != nullptr ? tm[i + t] : 1.f;
                out[i + t] += d * mk;
            }
    }
}

// ------------------------------------------------------------ workspace --
struct MtWorkspace {
    float* part_s1;
    float* part_s2;
    float* part_v;
    float* coef;
    float* gram;
    int* gram_acc;        // gram_i8_kernel's accumulator and tickets
    size_t bytes;
};

inline MtWorkspace layout_mt(void* base, int nb, int W, int T, bool exact) {
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
    if (exact) {
        ws.gram = take(static_cast<size_t>(W) * W);
        ws.gram_acc = reinterpret_cast<int*>(take(gram_i8_acc_ints(W)));
    }
    ws.bytes = off;
    return ws;
}

inline bool shapes_ok_mt(int nb, int W, int T) {
    return W >= 1 && W <= 1024 && T >= 1 && T <= T_MAX && nb > 0 && nb % 128 == 0;
}

inline size_t axpy_smem(int W, int T) {
    return sizeof(float) * (2 * static_cast<size_t>(T) * W + T_MAX + W);
}

int launch_axpy_mt(const uint8_t* pk, int nb, const int* order_w, int W, int T,
                   const float* coef, int add_c2, int complete, const float* tm,
                   float* out, cudaStream_t stream) {
    const size_t smem = axpy_smem(W, T);
    const int blocks = cdiv(nb, MT_AXPY_THREADS);
    if (complete) {
        HYDRA_CHECK(allow_smem(axpy_mt_kernel<true>, smem));
        axpy_mt_kernel<true><<<blocks, MT_AXPY_THREADS, smem, stream>>>(
            pk, nb, order_w, W, T, coef, add_c2, tm, out);
    } else {
        HYDRA_CHECK(allow_smem(axpy_mt_kernel<false>, smem));
        axpy_mt_kernel<false><<<blocks, MT_AXPY_THREADS, smem, stream>>>(
            pk, nb, order_w, W, T, coef, add_c2, tm, out);
    }
    HYDRA_CHECK_LAUNCH();
    return 0;
}

int run_sweep_mt(bool exact, const uint8_t* pk, float* eps, const float* tm,
                 const float* mrow, const int* order, const float* sc, float* out,
                 void* ws_base, int m_loc, int nb, int W, int K, int T, int complete,
                 cudaStream_t stream) {
    if (!shapes_ok_mt(nb, W, T) || m_loc <= 0 || m_loc % W || K < 2 || K > K_MAX ||
        tm == nullptr || (exact && !complete) || (exact && 4LL * nb > GRAM_I8_MAX_NPAD))
        return static_cast<int>(cudaErrorInvalidValue);
    const int C = T * (N_FIXED + 3 * K - 2);
    const MtWorkspace ws = layout_mt(ws_base, nb, W, T, exact);
    const int n_windows = m_loc / W;
    const int n_tiles = cdiv(nb, MT_STATS_TB);
    const int mode = !complete ? MODE_MISSING
                               : (exact ? MODE_EXACT_COMPLETE : MODE_STALE_COMPLETE);
    const dim3 stats_grid(n_tiles, cdiv(W, MT_STATS_ROWS));
    const size_t draw_smem = exact_draw_smem(W);
    auto* const draw = by_components(K, exact_mt_draw_kernel<4, true>,
                                     exact_mt_draw_kernel<8, false>,
                                     exact_mt_draw_kernel<K_MAX, false>);
    if (exact) {
        HYDRA_CHECK(allow_smem(draw, draw_smem));
        HYDRA_CHECK(cudaMemsetAsync(ws.gram_acc, 0, sizeof(int) * gram_i8_acc_ints(W), stream));
    }
    for (int w = 0; w < n_windows; ++w) {
        const int* order_w = order + static_cast<size_t>(w) * W;
        stats_mt_kernel<<<stats_grid, MT_STATS_ROWS * 32, 0, stream>>>(
            pk, nb, eps, T, order_w, W, mode, ws.part_s1, ws.part_s2, ws.part_v);
        HYDRA_CHECK_LAUNCH();
        if (exact) {
            const int err = launch_gram_i8(pk, nb, order_w, W, ws.gram_acc, ws.gram, stream);
            if (err) return err;
            draw<<<T, cdiv(W, 32) * 32, draw_smem, stream>>>(
                mrow, C, K, T, order_w, W, ws.part_s1, ws.part_s2, ws.part_v, n_tiles,
                ws.gram, sc, out, ws.coef);
        } else {
            stale_draw_mt_kernel<<<cdiv(static_cast<long long>(W) * T, MT_DRAW_THREADS),
                                   MT_DRAW_THREADS, 0, stream>>>(
                mrow, C, K, T, order_w, W, ws.part_s1, ws.part_s2, n_tiles, complete, sc,
                out, ws.coef);
        }
        HYDRA_CHECK_LAUNCH();
        const int err = launch_axpy_mt(pk, nb, order_w, W, T, ws.coef, 1, complete, tm,
                                       eps, stream);
        if (err) return err;
    }
    return 0;
}

}  // namespace hydra

extern "C" {

// Bytes of device scratch one sweep or one window_stats_mt call needs.
long long hydra_mt_workspace_bytes(int nb, int window, int n_traits, int exact) {
    return static_cast<long long>(
        hydra::layout_mt(nullptr, nb, window, n_traits, exact != 0).bytes);
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
        static_cast<float*>(out), ws, m_loc, nb, window, n_mix, n_traits, complete,
        static_cast<cudaStream_t>(stream));
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
        static_cast<float*>(out), ws, m_loc, nb, window, n_mix, n_traits, complete,
        static_cast<cudaStream_t>(stream));
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
    const MtWorkspace w = layout_mt(ws, nb, W, T, false);
    const int n_tiles = cdiv(nb, MT_STATS_TB);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    stats_mt_kernel<<<dim3(n_tiles, cdiv(W, MT_STATS_ROWS)), MT_STATS_ROWS * 32, 0, st>>>(
        static_cast<const uint8_t*>(pk), nb, static_cast<const float*>(eps), T,
        static_cast<const int*>(rows), W, complete ? MODE_STALE_COMPLETE : MODE_MISSING,
        w.part_s1, w.part_s2, w.part_v);
    HYDRA_CHECK_LAUNCH();
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
    if (W < 1 || W > 1024 || T < 1 || T > T_MAX || K < 2 || K > K_MAX)
        return static_cast<int>(cudaErrorInvalidValue);
    const int C = T * (N_FIXED + 3 * K - 2);
    const size_t smem = exact_draw_smem(W);
    auto* const rec = shared ? by_components(K, window_recurrence_mt_kernel<4, true, true>,
                                             window_recurrence_mt_kernel<8, false, true>,
                                             window_recurrence_mt_kernel<K_MAX, false, true>)
                             : by_components(K, window_recurrence_mt_kernel<4, true, false>,
                                             window_recurrence_mt_kernel<8, false, false>,
                                             window_recurrence_mt_kernel<K_MAX, false, false>);
    HYDRA_CHECK(allow_smem(rec, smem));
    rec<<<T, cdiv(W, 32) * 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(G), static_cast<const float*>(num0),
        static_cast<const float*>(mrow), C, K, T, static_cast<const int*>(rows), W,
        static_cast<const float*>(i2se), static_cast<float*>(out));
    HYDRA_CHECK_LAUNCH();
    return 0;
}

const char* hydra_mt_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
