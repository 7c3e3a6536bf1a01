"""BayesW draw in bw_draw_kernel's order (CPU): ``bw_draw_early_exit_ref``
against the window draw ``_draw`` of ``sweep_stale_bw_ref``.

The CUDA draw runs a warp per marker: the quadrature terms at once, each
component's summed in node order, the slice draw only where comp and act
are non-zero, the stepping-out points evaluated together with each side
stopped at its first failing step, and the shrink steps up to the first
accepted one. ``bw_draw_early_exit_ref`` repeats that order per marker; it
must give ``_draw``'s (beta_new, comp, dbeta) bit for bit, which is what
lets the kernel stay bit for bit the plain version. Inputs are made with
numpy from a seed at BayesW's scales (N=800 individuals, alpha 4..10,
mixture variances 1e-4..1e-2) with markers placed on every branch:
component 0, act 0 (pad rows), le = 0 (the slice level at f(bold)),
le = -1 (an empty slice: the shrink budget runs out, x = bold), le = 50
and a vanishing sigmaG (stepping out stopped by the bounds lower/upper),
and the usual first-shrink acceptance.
K in {2, 4, 16}, Q in {1, 25, 64}, (n_expand, n_shrink) in {(0, 0), (0,
24), (10, 1), (10, 24)}, complete and missing genotypes. The draw's slice
step (``slice_sample_rounds``, three rounds of density evaluations) is held
bit for bit to the fixed-budget ``slice_sample_noise`` on the same inputs.

This file imports neither JAX nor the JAX package.
"""

import numpy as np
import pytest
import torch

from hydra_tpu_torch.ops import sweep_kernel_bw as tskbw
from hydra_tpu_torch.samplers.bayesw import gh_table
from hydra_tpu_torch.utils.slice_sampler import (slice_sample_noise,
                                                 slice_sample_rounds)

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)

W, N = 64, 800


def draw_inputs(K, Q, n_shrink, complete, seed):
    """(rows (W, C), s1, s2, sb, s_all (W,), gh_x, gh_w, alpha), f32."""
    rs = np.random.RandomState(seed)
    km1 = K - 1
    alpha = rs.uniform(4.0, 10.0)
    p = rs.uniform(0.05, 0.5, W)
    mave = 2.0 * p
    inv_sd = 1.0 / np.sqrt(2.0 * p * (1.0 - p))
    bold = np.where(rs.random_sample(W) < 0.5, 0.01 * rs.randn(W), 0.0)
    pad = np.arange(W) % 16 == 15                     # act 0: pad rows
    mave[pad] = inv_sd[pad] = bold[pad] = 0.0
    s_all = N * rs.uniform(0.8, 1.2, W)
    s1 = 2.0 * p * (1.0 - p) * s_all * rs.uniform(0.9, 1.1, W)
    s2 = p * p * s_all * rs.uniform(0.9, 1.1, W)
    sb = None if complete else s_all * (1.0 - 0.02 * rs.random_sample(W))
    sf = 0.5 * np.sqrt(N) * rs.randn(W)
    g = np.arange(3.0)[:, None]
    ab = alpha * bold
    e = np.exp(ab * (g - mave) * inv_sd)               # (3, W)
    th = alpha * (mave - g) * inv_sd
    cva = np.logspace(-4, -2, km1)
    sig = rs.uniform(0.3, 0.7, W)
    tiny = np.arange(W) % 8 == 3                        # slim << width
    sig[tiny] = 1e-9
    pi = rs.dirichlet(np.ones(K), W)
    le = rs.exponential(1.0, W)
    le[np.arange(W) % 8 == 5] = 0.0                     # level at f(bold)
    le[np.arange(W) % 8 == 6] = 50.0                    # wide slice
    le[np.arange(W) % 8 == 7] = -1.0                    # an empty slice
    u = rs.random_sample(W)
    u[np.arange(W) % 8 == 7] = 0.9999                   # a non-zero component
    cols = [mave, inv_sd, bold, u, (~pad).astype(float), sf, th[0], th[1],
            th[2], e[0], e[1], e[2], pi[:, 0] * np.sqrt(np.pi)]
    rows = np.concatenate(
        [np.stack(cols, axis=1), pi[:, 1:],
         np.sqrt(2.0 * cva * sig[:, None]), alpha ** 2 * sig[:, None] * cva,
         2.0 * cva * sig[:, None], 2.0 * np.sqrt(sig[:, None] * cva),
         le[:, None], rs.random_sample((W, 1)),
         rs.random_sample((W, n_shrink))], axis=1)
    assert rows.shape[1] == tskbw.bw_mrow_width(K, n_shrink)
    x, w = gh_table(Q)

    def t(a):
        return None if a is None else torch.from_numpy(
            np.asarray(a, np.float32))

    return (t(rows), t(s1), t(s2), t(sb), t(s_all), t(x), t(w),
            torch.tensor(alpha, dtype=torch.float32))


def _bits(x):
    return x.view(torch.int32)


@pytest.mark.parametrize("complete", [True, False])
@pytest.mark.parametrize("n_expand,n_shrink", [(0, 0), (0, 24), (10, 1),
                                               (10, 24)])
@pytest.mark.parametrize("Q", [1, 25, 64])
@pytest.mark.parametrize("K", [2, 4, 16])
def test_early_exit_draw_matches_window_draw(K, Q, n_expand, n_shrink,
                                             complete):
    rows, s1, s2, sb, s_all, gh_x, gh_w, alpha = draw_inputs(
        K, Q, n_shrink, complete, seed=K * 1000 + Q)
    want = tskbw._draw(rows, s1, s2, sb, s_all, gh_x, gh_w, alpha, K,
                       complete, n_expand, n_shrink)
    got, infos = [], []
    for r in range(W):
        info = {}
        got.append(tskbw.bw_draw_early_exit_ref(
            rows[r], s1[r], s2[r], None if complete else sb[r], s_all[r],
            gh_x, gh_w, alpha, K, complete, n_expand, n_shrink, info=info))
        infos.append(info)
    for i, name in enumerate(("beta_new", "comp", "dbeta")):
        g = torch.stack([x[i] for x in got])
        assert torch.equal(_bits(g), _bits(want[i])), name
    act = rows[:, 4] > 0
    comp = want[1]
    assert bool((~act).any()) and bool(((comp == 0) & act).any())
    sliced = [i for i in infos if i["slice"]]
    assert sliced and len(sliced) < W
    assert all(i["slice"] == bool(c > 0) for i, c in zip(infos, comp))
    if n_shrink:
        assert any(i["accepted"] and i["shrinks"] == 1 for i in sliced)
        assert any(not i["accepted"] for i in sliced)
    else:
        assert all(bool(b == r[2]) for b, r, i in zip(want[0], rows, infos)
                   if i["slice"])
    if n_expand:
        assert any(i["left_at_lower"] or i["right_at_upper"] for i in sliced)
        assert any(i["left_steps"] < n_expand and not i["left_at_lower"]
                   for i in sliced)


@pytest.mark.parametrize("complete", [True, False])
@pytest.mark.parametrize("n_expand,n_shrink", [(0, 0), (10, 1), (10, 24)])
@pytest.mark.parametrize("K", [2, 4, 16])
def test_rounds_draw_matches_window_draw(K, n_expand, n_shrink, complete,
                                         monkeypatch):
    """The draw's slice step (``slice_sample_rounds``: the density in three
    rounds) against the fixed-budget transition ``slice_sample_noise`` on
    the same density, noise and bounds as ``_draw`` hands it, on markers of
    every branch: bit for bit."""
    rows, s1, s2, sb, s_all, gh_x, gh_w, alpha = draw_inputs(
        K, 25, n_shrink, complete, seed=K * 100 + n_shrink)
    calls = []

    def recorded(*a, **k):
        x = slice_sample_rounds(*a, **k)
        calls.append((a, k, x))
        return x

    monkeypatch.setattr(tskbw, "slice_sample_rounds", recorded)
    tskbw._draw(rows, s1, s2, sb, s_all, gh_x, gh_w, alpha, K, complete,
                n_expand, n_shrink)
    (a, k, got), = calls
    want = slice_sample_noise(*a, **k)
    assert torch.equal(_bits(got), _bits(want))
