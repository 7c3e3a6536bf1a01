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
//   bw_draw_kernel (phase 0's last tile): one thread per marker reduces the
//                  partials in a fixed order and draws the marker
//                  (BayesW.cpp:1480-1640): closed-form own-effect removal,
//                  adaptive Gauss-Hermite marginal likelihoods, the
//                  component, and a fixed-budget slice draw of beta;
//   axpy_kernel<true> (= window_axpy + phase 1, sweep_kernel.cuh): eps +=
//                  the window's update and vi = exp(alpha*eps - EuMasc)*mask
//                  in the same pass (BayesW.cpp:1642-1834).
//
// What bounds it on this card: each window reads its W packed rows twice
// (levels, axpy; the axpy a thread per individual over a shared tile of the
// rows, sweep_kernel.cuh) and vi and eps once each per pass; the
// draw is ~45 log-density evaluations (3 expm1f each) plus (K-1)*Q
// quadrature nodes per marker on one block. At W=1 (exact sequential
// BayesW) a sweep is 3 launches per marker and host enqueue bounds it;
// launch fusion is left for a later change.
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

constexpr int LEVELS_TB = 512;     // packed bytes per levels tile
constexpr int LEVELS_ROWS = 8;     // rows per levels block (one per warp)
constexpr int Q_MAX = 64;          // Gauss-Hermite nodes held in shared memory

// BayesW mrow column layout (hydra_tpu/ops/sweep_kernel_bw.py:64-81),
// J = K-1, S = n_shrink:
//   0 mave, 1 inv_sd, 2 bold, 3 u, 4 act, 5 sf, 6..8 th0..th2,
//   9..11 e0..e2, 12 ml0, 13.. pj[J], sqrt2ck[J], adc[J], two_ck_sg[J],
//   slim[J], then le, u_br, uu[S]
constexpr int BW_FIXED = 13;

// ------------------------------------------------------------- levels --
// grid (n_tiles, ceil(W / rows)), rows warps per block; warp = one row of
// the window over one tile of LEVELS_TB bytes, lane = one 32-bit word (16
// individuals) per step, vi read as one float4 per packed byte. Complete
// data uses the h-decode indicators i1 = h(2-h), i2 = (1-h)(1-h/2) (exact
// integers); pads (h = 3) meet vi == 0. Missing data decodes g, m
// (_decode_k) with i1 = g(2-g), i2 = g(g-1)/2 and adds the mask dot.
__global__ void levels_kernel(const uint8_t* __restrict__ pk, int nb,
                              const float* __restrict__ vi,
                              const int* __restrict__ order_w, int W, int complete,
                              float* __restrict__ part_s1,
                              float* __restrict__ part_s2,
                              float* __restrict__ part_bv,
                              float* __restrict__ part_all) {
    const int rows = blockDim.x >> 5;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = blockIdx.y * rows + warp;
    if (r >= W) return;
    const int t = blockIdx.x;
    const uint32_t* row = reinterpret_cast<const uint32_t*>(
        pk + static_cast<size_t>(order_w[r]) * nb);
    const float4* v4 = reinterpret_cast<const float4*>(vi);
    const int w0 = t * (LEVELS_TB / 4);
    const int w1 = min(w0 + LEVELS_TB / 4, nb / 4);
    const bool total = r == 0;             // one row also sums vi itself
    float a = 0.f, b = 0.f, bv = 0.f, tot = 0.f;
    for (int wd = w0 + lane; wd < w1; wd += 32) {
        const uint32_t word = row[wd];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const uint32_t byte = (word >> (8 * q)) & 0xffu;
            const float4 v = v4[wd * 4 + q];
            const float vk[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int c = crumb(byte, k);
                int i1, i2;
                if (complete) {
                    i1 = c * (2 - c);
                    i2 = ((1 - c) * (2 - c)) / 2;
                } else {
                    const int g = crumb_geno(c);
                    i1 = g * (2 - g);
                    i2 = (g * (g - 1)) / 2;
                    bv = fmaf(static_cast<float>(crumb_mask(c)), vk[k], bv);
                }
                a = fmaf(static_cast<float>(i1), vk[k], a);
                b = fmaf(static_cast<float>(i2), vk[k], b);
                if (total) tot += vk[k];
            }
        }
    }
    a = warp_sum(a);
    b = warp_sum(b);
    if (!complete) bv = warp_sum(bv);
    if (total) tot = warp_sum(tot);
    if (lane == 0) {
        part_s1[t * W + r] = a;
        part_s2[t * W + r] = b;
        if (!complete) part_bv[t * W + r] = bv;
        if (total) part_all[t] = tot;
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

// One block, one thread per marker of the window
// (hydra_tpu/ops/sweep_kernel_bw.py:159-291, without the TPU's row layout,
// Taylor expm1, 128-lane GH pad or bf16 split).
__global__ void bw_draw_kernel(const float* __restrict__ mrow, int C, int K,
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
    extern __shared__ float sh[];          // c1[W], c2[W], ghx[Q], ghw[Q]
    float* s_gx = sh + 2 * W;
    float* s_gw = s_gx + Q;
    for (int i = threadIdx.x; i < Q; i += blockDim.x) {
        s_gx[i] = ghx[i];
        s_gw[i] = ghw[i];
    }
    __syncthreads();
    const int r = threadIdx.x;
    if (r < W) {
        const float alpha = sc[0];
        const int km1 = K - 1;
        const int slot = order_w[r];
        const float* row = mrow + static_cast<size_t>(slot) * C;
        const float s1 = reduce_tiles(part_s1, n_tiles, W, r);
        const float s2 = reduce_tiles(part_s2, n_tiles, W, r);
        float s_all = 0.f;
        for (int t = 0; t < n_tiles; ++t) s_all += part_all[t];
        const float sm = complete ? 0.f : s_all - reduce_tiles(part_bv, n_tiles, W, r);
        const float s0 = s_all - s1 - s2 - sm;

        const float mave = row[0], inv_sd = row[1], bold = row[2];
        const float u = row[3], act = row[4];
        BwDens f;
        f.alpha = alpha;
        f.sf = row[5];
        f.th0 = row[6];
        f.th1 = row[7];
        f.th2 = row[8];
        // own-effect removal (tmp_vi recompute, BayesW.cpp:1499-1516)
        f.vi1 = s1 * row[10];
        f.vi2 = s2 * row[11];
        const float vsum = s0 * row[9] + f.vi1 + f.vi2 + sm;
        f.vi0 = vsum - f.vi1 - f.vi2;
        const float exp_sum = (f.vi1 * (1.0f - 2.0f * mave)
                               + 4.0f * (1.0f - mave) * f.vi2
                               + vsum * mave * mave) * inv_sd * inv_sd;

        // adaptive Gauss-Hermite marginal likelihoods (BayesW.cpp:716-726);
        // sigma_ad is the substitution's Jacobian (BayesW.cpp:711)
        const int bp = BW_FIXED, bs = BW_FIXED + km1, ba = BW_FIXED + 2 * km1;
        const int bt = BW_FIXED + 3 * km1, bl = BW_FIXED + 4 * km1;
        const int br = BW_FIXED + 5 * km1;
        float ml[K_MAX];
        ml[0] = row[12];
        for (int j = 0; j < km1; ++j) {
            const float sigma_ad = 1.0f / sqrtf(1.0f + row[ba + j] * exp_sum);
            const float sqk = row[bs + j];
            float acc = 0.f;
            for (int q = 0; q < Q; ++q) {
                const float s_node = sigma_ad * s_gx[q];
                const float sq = s_node * sqk;
                const float temp = -alpha * sq * f.sf - f.vi0 * expm1f(f.th0 * sq)
                                   - f.vi1 * expm1f(f.th1 * sq)
                                   - f.vi2 * expm1f(f.th2 * sq) - s_node * s_node;
                acc = acc + s_gw[q] * expf(temp);
            }
            ml[j + 1] = row[bp + j] * (sigma_ad * acc);
        }
        float sm_ml = ml[0];
        for (int j = 1; j < K; ++j) sm_ml = sm_ml + ml[j];
        // comp = min(#{cum probs < u}, K-1), zeroed for inactive markers
        float cum = ml[0] / sm_ml;
        float compf = u > cum ? 1.f : 0.f;
        for (int j = 0; j < km1; ++j) {
            cum = cum + ml[j + 1] / sm_ml;
            compf = compf + (u > cum ? 1.f : 0.f);
        }
        compf = fminf(compf, static_cast<float>(km1)) * act;

        // fixed-budget slice sampler on beta_dens (utils/slice_sampler.py)
        const int ksel = compf > 1.f ? static_cast<int>(compf) - 1 : 0;
        f.two_ck_sg = row[bt + ksel];
        const float slim = row[bl + ksel];
        const float width = fmaxf(slim / 5.0f, 1e-3f);
        const float lower = bold - slim, upper = bold + slim;
        const float log_y = f(bold) - row[br];
        float left = bold - width * row[br + 1];
        float right = left + width;
        for (int i = 0; i < n_expand; ++i) {
            if (f(left) > log_y && left > lower) left = left - width;
            if (f(right) > log_y && right < upper) right = right + width;
        }
        left = fmaxf(left, lower);
        right = fminf(right, upper);
        float x = bold;
        bool accepted = false;
        for (int s = 0; s < n_shrink; ++s) {
            const float xc = left + row[br + 2 + s] * (right - left);
            const bool ok = f(xc) > log_y;
            if (ok && !accepted) x = xc;
            accepted = accepted || ok;
            if (!accepted) {
                if (xc < bold) left = xc;
                else right = xc;
            }
        }
        // x is still bold unless a shrink step accepted
        const bool draw = compf > 0.f && act > 0.f;
        const float bnew = draw ? x : 0.f;
        const float dbeta = bold - bnew;
        float* o = out + static_cast<size_t>(slot) * 4;
        o[0] = bnew;
        o[1] = compf;
        o[2] = dbeta;
        o[3] = 0.f;
        const float c1 = dbeta * inv_sd;
        sh[r] = c1;
        sh[W + r] = -c1 * mave;
    }
    __syncthreads();
    if (r < W) {
        coef[r] = sh[r];
        coef[W + r] = sh[W + r];
    }
    if (r == 0 && complete) {
        // h-decode axpy constant: 2 * sum(c1) + sum(c2), in window order
        float a = 0.f, b = 0.f;
        for (int j = 0; j < W; ++j) a += sh[j];
        for (int j = 0; j < W; ++j) b += sh[W + j];
        coef[2 * W] = 2.0f * a + b;
    }
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
    const size_t n_tiles = cdiv(nb, LEVELS_TB);
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
    ws.coef = take(2 * static_cast<size_t>(W) + 1);
    ws.bytes = off;
    return ws;
}

inline void levels_launch(const uint8_t* pk, int nb, const float* vi,
                          const int* order_w, int W, int complete,
                          const BwWorkspace& ws, cudaStream_t stream) {
    const int rows = W < LEVELS_ROWS ? W : LEVELS_ROWS;
    const dim3 grid(cdiv(nb, LEVELS_TB), cdiv(W, rows));
    levels_kernel<<<grid, rows * 32, 0, stream>>>(
        pk, nb, vi, order_w, W, complete, ws.part_s1, ws.part_s2, ws.part_bv,
        ws.part_all);
}

int run_sweep_bw(const uint8_t* pk, float* eps, float* vi, const float* mrow,
                 const int* order, const float* mask, const float* ghx,
                 const float* ghw, int Q, const float* sc, float* out,
                 void* ws_base, int m_loc, int nb, int W, int K, int complete,
                 int n_expand, int n_shrink, cudaStream_t stream) {
    if (W < 1 || W > 1024 || m_loc <= 0 || m_loc % W || nb <= 0 || nb % 128 ||
        K < 2 || K > K_MAX || Q < 1 || Q > Q_MAX || n_expand < 0 ||
        n_shrink < 0 || mask == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    const int C = BW_FIXED + 5 * (K - 1) + 2 + n_shrink;
    const BwWorkspace ws = bw_layout(ws_base, nb, W);
    const int n_tiles = cdiv(nb, LEVELS_TB);
    const int draw_threads = cdiv(W, 32) * 32;
    const size_t draw_smem = sizeof(float) * (2 * static_cast<size_t>(W) + 2 * Q);
    const int mode = complete ? MODE_STALE_COMPLETE : MODE_MISSING;
    for (int w = 0; w < m_loc / W; ++w) {
        const int* order_w = order + static_cast<size_t>(w) * W;
        levels_launch(pk, nb, vi, order_w, W, complete, ws, stream);
        HYDRA_CHECK_LAUNCH();
        bw_draw_kernel<<<1, draw_threads, draw_smem, stream>>>(
            mrow, C, K, order_w, W, ws.part_s1, ws.part_s2, ws.part_bv,
            ws.part_all, n_tiles, complete, ghx, ghw, Q, sc, n_expand, n_shrink,
            out, ws.coef);
        HYDRA_CHECK_LAUNCH();
        const int err = launch_axpy<true>(pk, nb, order_w, W, mode, ws.coef, mask, eps, vi,
                                          sc, stream);
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
    if (window < 1 || window > 1024 || nb <= 0 || nb % 128)
        return static_cast<int>(cudaErrorInvalidValue);
    const BwWorkspace w = bw_layout(ws, nb, window);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    levels_launch(static_cast<const uint8_t*>(pk), nb, static_cast<const float*>(vi),
                  static_cast<const int*>(order), window, complete, w, st);
    HYDRA_CHECK_LAUNCH();
    levels_reduce_kernel<<<cdiv(window, 256), 256, 0, st>>>(
        w.part_s1, w.part_s2, w.part_bv, cdiv(nb, LEVELS_TB), window, complete,
        static_cast<float*>(s1), static_cast<float*>(s2), static_cast<float*>(sb));
    HYDRA_CHECK_LAUNCH();
    return 0;
}

// out (4*nb,) += sum_r c1_r * g_r + c2_r * m_r over the rows order[0..W),
// coef = [c1[W], c2[W], 2 * sum(c1)]. Complete data returns the genotype
// part only, as 2 sum(c1) - sum c1*h (the caller adds sum(c2) and masks).
int hydra_window_axpy(const void* pk, const void* order, const void* coef,
                      void* out, int window, int nb, int complete, void* stream) {
    using namespace hydra;
    if (window < 1 || window > 1024 || nb <= 0 || nb % 128)
        return static_cast<int>(cudaErrorInvalidValue);
    return launch_axpy<false>(static_cast<const uint8_t*>(pk), nb,
                              static_cast<const int*>(order), window,
                              complete ? MODE_STALE_COMPLETE : MODE_MISSING,
                              static_cast<const float*>(coef), nullptr,
                              static_cast<float*>(out), nullptr, nullptr,
                              static_cast<cudaStream_t>(stream));
}

const char* hydra_bw_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
