"""The port's multi-trait W < 8 and ``--mega off`` paths and BayesW
``--mega off`` against the JAX sampler, against the port's own whole-sweep
branches, and BayesW's chain against the numpy golden model (CPU).

One sweep from the JAX sampler's state with its own draws (the harnesses of
tests/test_torch_bayesrrm_mt.py and tests/test_torch_bayesw.py) must give
the port's sweep on each new path the JAX per-window ``window_body``'s state
(the JAX sampler on the CPU backend runs no Pallas kernel): eps, beta and
acum within atol 5e-4 / rtol 1e-3 (f32 summation order), components and
cass equal, as those files' tests hold the other branches. Each port
per-window path then runs against the port's whole-sweep branch of the same
order and noise, within the same tolerance, components equal.
"""

import numpy as np
import pytest
import torch

from hydra_tpu.io.plink import decode_bed_numpy
from hydra_tpu.parallel.mesh import make_mesh
from hydra_tpu.samplers.bayesrrm_mt import BayesRRmMT as JaxBayesRRmMT
from hydra_tpu.samplers.bayesw import BayesW as JaxBayesW
from hydra_tpu_torch.ops import sweep_kernel_bw as tskbw
from hydra_tpu_torch.samplers import bayesrrm_mt as tmt
from hydra_tpu_torch.samplers import bayesw as tbw
from hydra_tpu_torch.samplers.bayesrrm_mt import BayesRRmMT

from tests.test_bayesrrm_mt import simulate_mt
from tests.test_torch_bayesrrm_mt import (_jax_noise as mt_noise,
                                          _jax_state_numpy as mt_state,
                                          with_missing)
from tests.test_torch_bayesw import (_dataset as bw_dataset,
                                     _jax_noise as bw_noise,
                                     _jax_numpy as bw_state)

torch.set_num_threads(1)

TOL = dict(atol=5e-4, rtol=1e-3)

MT_PATHS = {
    # name: (window, exact, NaN fraction, missing genotypes, mega,
    #        the port's branch)
    "w1_stale": (1, False, 0.1, 0.0, "auto", "sweep_stale_mt"),
    "w1_exact": (1, True, 0.0, 0.03, "auto", "sweep_stale_mt"),
    "w4_exact_shared": (4, True, 0.0, 0.0, "auto", "sweep_exact_mt"),
    "w4_exact_nan": (4, True, 0.1, 0.0, "auto", "window_sweep"),
    "w4_stale": (4, False, 0.0, 0.03, "auto", "sweep_stale_mt"),
    "off_stale": (16, False, 0.1, 0.03, "off", "window_sweep"),
    "off_exact": (16, True, 0.0, 0.0, "off", "window_sweep"),
}


def _spy(monkeypatch, obj, name, seen):
    fn = getattr(obj, name)

    def wrapped(*a, **k):
        seen.append(name)
        return fn(*a, **k)

    monkeypatch.setattr(obj, name, wrapped)


@pytest.mark.parametrize("path", list(MT_PATHS))
def test_mt_sweep_matches_jax(path, monkeypatch):
    W, exact, na_frac, missing, mega, branch = MT_PATHS[path]
    ds, phenos, _ = simulate_mt(m=48, n=240, n_traits=2, seed=13,
                                na_frac=na_frac)
    if missing:
        ds = with_missing(ds, missing, 6)
    seed, it = 7, 2
    j = JaxBayesRRmMT(ds, phenos, window=W, exact=exact, seed=seed,
                      mesh=make_mesh(1), mega=mega)
    t = BayesRRmMT(ds, phenos, window=W, exact=exact, seed=seed, mega=mega,
                   device="cpu")
    assert not j.cfg.use_pallas and not j.cfg.use_mega
    # the JAX schedule rule on a TPU: marker below 8 and for --mega off
    assert t.cfg.schedule == j.cfg.schedule == "marker"
    assert t.cfg.exact == (exact and W > 1)
    seen = []
    for name in ("sweep_stale_mt", "sweep_exact_mt"):
        _spy(monkeypatch, tmt, name, seen)
    _spy(monkeypatch, t, "window_sweep", seen)
    sj = j.init_state()
    st = tmt.state_from_numpy(mt_state(sj), "cpu")
    sj2, stats_j = j.step(sj, it)
    st2, stats_t = t.step(st, it, noise=mt_noise(seed, it, j.cfg))
    assert seen == [branch]
    a, b = tmt.state_to_numpy(st2), mt_state(sj2)
    for name in ("eps", "beta", "acum"):
        np.testing.assert_allclose(a[name], b[name], err_msg=name, **TOL)
    np.testing.assert_array_equal(a["components"], b["components"])
    np.testing.assert_array_equal(stats_t.cass.numpy(),
                                  np.asarray(stats_j.cass))
    assert len(np.unique(a["components"])) >= 2


@pytest.mark.parametrize("exact,na_frac", [(False, 0.1), (True, 0.0)])
def test_mt_per_window_matches_whole_sweep(exact, na_frac):
    """--mega off against the whole-sweep kernel's plain version on the
    same marker order and noise: stale (sweep_stale_mt) and exact with the
    shared Gram (sweep_exact_mt)."""
    ds, phenos, _ = simulate_mt(m=64, n=300, n_traits=3, seed=3,
                                na_frac=na_frac)
    kw = dict(window=16, exact=exact, seed=5, schedule="marker",
              device="cpu")
    off = BayesRRmMT(ds, phenos, mega="off", **kw)
    whole = BayesRRmMT(ds, phenos, **kw)
    assert off.cfg.per_window and not whole.cfg.per_window
    g = torch.Generator().manual_seed(1)
    T, ml = phenos.shape[0], off.cfg.m_loc
    noise = dict(mu=torch.randn(T, generator=g),
                 u=torch.rand((ml, T), generator=g),
                 nrm=torch.randn((ml, T), generator=g),
                 perm=torch.randperm(ml, generator=g))
    st = off.init_state()
    a, _ = off.step(st, 0, noise=noise)
    b, _ = whole.step(st, 0, noise=noise)
    a, b = tmt.state_to_numpy(a), tmt.state_to_numpy(b)
    for name in ("eps", "beta", "acum"):
        np.testing.assert_allclose(a[name], b[name], err_msg=name, **TOL)
    np.testing.assert_array_equal(a["components"], b["components"])


@pytest.mark.parametrize("window,missing_frac", [(1, 0.0), (16, 0.03)])
def test_bw_mega_off_matches_jax(window, missing_frac):
    ds, *_ = bw_dataset(48, 240, 13, missing_frac, censor_frac=0.2)
    seed, it = 7, 2
    j = JaxBayesW(ds, window=window, seed=seed, mesh=make_mesh(1),
                  quad_points=9, mega="off")
    t = tbw.BayesW(ds, window=window, seed=seed, quad_points=9, mega="off",
               device="cpu")
    assert t.cfg.per_window and t.cfg.schedule == j.cfg.schedule == "marker"
    sj = j.init_state()
    st = tbw.state_from_numpy(bw_state(sj), "cpu")
    noise = bw_noise(seed, it, j.cfg.m_loc, j.cfg.n_windows, "marker")
    before = dict(tskbw.launches)
    sj2, stats_j = j.step(sj, it)
    st2, stats_t = t.step(st, it, noise=noise)
    assert tskbw.launches == before
    a, b = tbw.state_to_numpy(st2), bw_state(sj2)
    np.testing.assert_allclose(a["mu"], b["mu"], rtol=1e-5)
    np.testing.assert_allclose(a["alpha"], b["alpha"], rtol=1e-5)
    for name in ("eps", "beta"):
        np.testing.assert_allclose(a[name], b[name], err_msg=name, **TOL)
    np.testing.assert_array_equal(a["components"], b["components"])
    np.testing.assert_array_equal(stats_t.cass.numpy(),
                                  np.asarray(stats_j.cass))
    assert int((a["components"] > 0).sum()) >= 2


@pytest.mark.parametrize("window,missing_frac", [(4, 0.03), (16, 0.0)])
def test_bw_per_window_matches_whole_sweep(window, missing_frac):
    """BayesW --mega off against sweep_stale_bw's plain version on the same
    marker order and noise."""
    ds, *_ = bw_dataset(64, 300, 5, missing_frac, censor_frac=0.2)
    kw = dict(window=window, seed=3, quad_points=9, schedule="marker",
              device="cpu")
    off, whole = tbw.BayesW(ds, mega="off", **kw), tbw.BayesW(ds, **kw)
    st = off.init_state()
    noise = dict(off.slot_noise(1), perm=torch.randperm(
        off.cfg.m_loc, generator=torch.Generator().manual_seed(2)))
    for s in (off, whole):
        noise.update({k: v for k, v in bw_noise(3, 1, s.cfg.m_loc,
                                                s.cfg.n_windows,
                                                "marker").items()
                      if k in ("mu", "alpha")})
    a, _ = off.step(st, 1, noise=noise)
    b, _ = whole.step(st, 1, noise=noise)
    a, b = tbw.state_to_numpy(a), tbw.state_to_numpy(b)
    for name in ("eps", "beta"):
        np.testing.assert_allclose(a[name], b[name], err_msg=name, **TOL)
    np.testing.assert_array_equal(a["components"], b["components"])
    assert int((a["components"] > 0).sum()) >= 2


def test_bw_chain_matches_numpy_golden_model():
    """The port's BayesW (whole sweep, W = 8) against the independent numpy
    golden model (hydra_tpu/testing/reference_bayesw.py) at the sizes and
    thresholds of tests/test_bayesw.py::test_bw_matches_numpy_golden_model:
    M=64, N=400, 150 sweeps, 9 quadrature points, the same posterior on
    alpha, mu, sigmaG and beta."""
    from hydra_tpu.testing.reference_bayesw import sweep
    from tests.test_bayesw import simulate_weibull

    m, n = 64, 400
    ds, *_ = simulate_weibull(m=m, n=n, seed=19)
    g_np, mask_np = decode_bed_numpy(ds.geno.packed, ds.geno.n_pad)
    g_np, mask_np = g_np[:, :n], mask_np[:, :n]
    geno_codes = np.where(mask_np > 0, g_np, -1).astype(int)
    xt = (g_np - ds.geno.mave[:, None] * mask_np) / ds.geno.msd[:, None]
    rng = np.random.RandomState(101)
    y = ds.y
    mu = float(y.mean())
    alpha = float(np.pi / np.sqrt(6.0 * np.sum((y - mu) ** 2) / (n - 1)))
    st = dict(eps=y - mu, beta=np.zeros(m), mu=mu, alpha=alpha,
              sigma_g=np.array([np.pi ** 2 / (6.0 * alpha ** 2)]),
              pi_l=np.array([[0.99, 1 - 0.99 - 2.0 / m, 1.0 / m, 1.0 / m]]))
    nit = 150
    gold = dict(alpha=[], mu=[], sg=[], beta=0.0)
    for it in range(nit):
        out = sweep(xt, geno_codes, ds.geno.mave, ds.geno.msd, st["eps"],
                    np.asarray(ds.fail, float), st["beta"], ds.groups,
                    ds.mS[:, 1:], st["sigma_g"], st["mu"], st["alpha"],
                    st["pi_l"], rng, quad_n=9)
        st = {k: out[k] for k in
              ("eps", "beta", "mu", "alpha", "sigma_g", "pi_l")}
        if it >= nit // 2:
            gold["alpha"].append(out["alpha"])
            gold["mu"].append(out["mu"])
            gold["sg"].append(out["sigma_g"].sum())
            gold["beta"] = gold["beta"] + out["beta"]
    s = tbw.BayesW(ds, window=8, seed=23, quad_points=9, device="cpu")
    stt = s.init_state()
    port = dict(alpha=[], mu=[], sg=[], beta=0.0)
    for it in range(nit):
        stt, _ = s.step(stt, it)
        if it >= nit // 2:
            port["alpha"].append(float(stt.alpha))
            port["mu"].append(float(stt.mu))
            port["sg"].append(float(stt.sigma_g.sum()))
            port["beta"] = port["beta"] + s.beta_global(stt)
    a_np, a_t = np.mean(gold["alpha"]), np.mean(port["alpha"])
    mu_np, mu_t = np.mean(gold["mu"]), np.mean(port["mu"])
    sg_np, sg_t = np.mean(gold["sg"]), np.mean(port["sg"])
    assert abs(a_t - a_np) / a_np < 0.15, (a_t, a_np)
    assert abs(mu_t - mu_np) < 0.05, (mu_t, mu_np)
    assert abs(sg_t - sg_np) / max(sg_np, 1e-6) < 0.5, (sg_t, sg_np)
    assert np.corrcoef(gold["beta"], port["beta"])[0, 1] > 0.8
