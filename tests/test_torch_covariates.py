"""Covariates (fixed effects) in the port's samplers against the JAX
samplers (CPU).

One sweep with covariates, from the JAX sampler's state and with the JAX
sampler's own draws rebuilt from its key schedule (those of each sampler's
test file, plus the covariates' permutation and normals, or BayesW's slice
noise per covariate, sites 7/8 of BayesRRm and multi-trait, 6/7 of BayesW),
must give the same state on every path: BayesRRm exact and stale, BayesFH,
BayesW W=1 and W=64, and multi-trait with 10% NaN phenotypes. eps, beta,
acum and gamma within atol 5e-4 / rtol 1e-3 (f32 summation order),
components and cass equal, BayesW's mu and alpha within rtol 1e-5. The
JAX paths are those of the files' own one-sweep tests (whole-sweep
kernels in interpret mode, BayesW's per-window path).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydra_tpu.parallel.mesh import make_mesh
from hydra_tpu.samplers.bayesrrm_mt import BayesRRmMT as JaxBayesRRmMT
from hydra_tpu.samplers.bayesw import BayesW as JaxBayesW
from hydra_tpu.utils.slice_sampler import slice_noise
from hydra_tpu_torch.samplers import bayesrrm as tbrr
from hydra_tpu_torch.samplers import bayesrrm_mt as tmt
from hydra_tpu_torch.samplers import bayesw as tbw

from tests.test_bayesrrm import simulate
from tests.test_bayesrrm_mt import simulate_mt
from tests.test_torch_bayesfh import _jax_noise as fh_noise
from tests.test_torch_bayesfh import _jax_whole_sweep
from tests.test_torch_bayesrrm_mt import _jax_noise as mt_noise
from tests.test_torch_bayesw import _dataset as bw_dataset
from tests.test_torch_bayesw import _jax_noise as bw_noise

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)

F32 = jnp.float32
TOL = dict(atol=5e-4, rtol=1e-3)


def _site(seed, it, s):
    return jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), it), s)


def _torch(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _numpy(state, fields):
    return {k: np.asarray(getattr(state, k)) for k in fields}


def _with_covariates(ds, n_cov, seed, effect=0.3):
    """The dataset with F standard-normal covariates that also shift y."""
    rs = np.random.RandomState(seed)
    X = rs.randn(ds.geno.n, n_cov)
    return dataclasses.replace(ds, X=X, y=ds.y + effect * X @ rs.randn(n_cov))


def _check(st2, sj2, names, comps=True):
    for name in names:
        np.testing.assert_allclose(getattr(st2, name).numpy(),
                                   np.asarray(getattr(sj2, name)), **TOL,
                                   err_msg=name)
    if comps:
        np.testing.assert_array_equal(st2.components.numpy(),
                                      np.asarray(sj2.components))


@pytest.mark.parametrize("case", ["exact", "stale_missing", "fh"])
def test_bayesrrm_cov_sweep_matches_jax(case):
    """BayesRRm exact and stale (2% missing calls) and BayesFH, whole-sweep
    kernels, block schedule, F = 3."""
    exact = case != "stale_missing"
    fh = case == "fh"
    ds, _, _ = simulate(m=150, n=400, h2=0.5, seed=5,
                        missing_frac=0.0 if exact else 0.02)
    ds = _with_covariates(ds, 3, 11)
    seed, it = 7, 3
    j = _jax_whole_sweep(ds, 32, exact, seed, fh, "block")
    t = tbrr.BayesRRm(ds, window=32, exact=exact, seed=seed, fh=fh,
                      schedule="block", device="cpu")
    assert t.cfg.n_cov == j.cfg.n_cov == 3
    np.testing.assert_array_equal(t.x_cov.numpy(), np.asarray(j.x_cov))
    sj = j.init_state()
    st = tbrr.state_from_numpy(_numpy(sj, tbrr.STATE_FIELDS), "cpu")
    sj2, stats_j = j.step(sj, it)
    noise = fh_noise(j, it, stats_j.m0)
    noise.update(_torch(dict(
        covperm=jax.random.permutation(_site(seed, it, 8), 3),
        cov=jax.random.normal(_site(seed, it, 7), (3,), F32))))
    st2, stats_t = t.step(st, it, noise=noise)
    _check(st2, sj2, ("eps", "beta", "acum", "gamma"))
    np.testing.assert_array_equal(stats_t.cass.numpy(),
                                  np.asarray(stats_j.cass))
    assert np.abs(st2.gamma.numpy()).min() > 0.0
    assert np.all(st2.eps.numpy()[ds.geno.n:] == 0.0)
    # the covariates' order of the sweep, as .xiv.0 records it
    order = t.cov_order(it)
    assert order.dtype == np.int32 and sorted(order) == [0, 1, 2]


@pytest.mark.parametrize("window,schedule", [(1, "block"), (64, "marker")])
def test_bayesw_cov_sweep_matches_jax(window, schedule):
    """BayesW W=1 and W=64 with F = 2: the slice draw of each covariate
    with the JAX sampler's noise (fold_in(site 6, i) for the i-th visited),
    then the rest of the sweep."""
    ds, *_ = bw_dataset(100, 240, 13, 0.0, censor_frac=0.2)
    ds = _with_covariates(ds, 2, 12, effect=0.02)
    seed, it = 7, 2
    j = JaxBayesW(ds, window=window, seed=seed, mesh=make_mesh(1),
                  quad_points=9, schedule=schedule)
    assert not j.cfg.use_pallas and not j.cfg.use_mega
    t = tbw.BayesW(ds, window=window, seed=seed, quad_points=9, device="cpu",
                   schedule=schedule)
    assert t.cfg.n_cov == j.cfg.n_cov == 2
    for name in ("x_cov", "sum_fail_fix"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))
    sj = j.init_state()
    st = tbw.state_from_numpy(_numpy(sj, tbw.STATE_FIELDS), "cpu")
    noise = bw_noise(seed, it, j.cfg.m_loc, j.cfg.n_windows, schedule)
    per = [slice_noise(jax.random.fold_in(_site(seed, it, 6), i), (), 24)
           for i in range(2)]
    noise["cov"] = (torch.from_numpy(np.array([p[0] for p in per])),
                    torch.from_numpy(np.array([p[1] for p in per])),
                    torch.from_numpy(np.array([p[2] for p in per]).T.copy()))
    noise["covperm"] = torch.from_numpy(np.array(
        jax.random.permutation(_site(seed, it, 7), 2)))
    sj2, stats_j = j.step(sj, it)
    st2, stats_t = t.step(st, it, noise=noise)
    for name in ("mu", "alpha"):
        np.testing.assert_allclose(float(getattr(st2, name)),
                                   float(getattr(sj2, name)), rtol=1e-5)
    np.testing.assert_allclose(st2.gamma.numpy(), np.asarray(sj2.gamma),
                               rtol=1e-5, atol=1e-7)
    _check(st2, sj2, ("eps", "beta"))
    np.testing.assert_array_equal(stats_t.cass.numpy(),
                                  np.asarray(stats_j.cass))
    assert np.all(st2.gamma.numpy() != 0.0)


def test_mt_cov_sweep_matches_jax():
    """Multi-trait, T = 3 traits with 10% NaN phenotypes, F = 3: each
    trait's covariate dot products and residual updates under its mask
    (the exact per-window path, marker schedule)."""
    ds, phenos, _ = simulate_mt(m=90, n=300, n_traits=3, seed=13,
                                na_frac=0.1)
    X = np.random.RandomState(14).randn(ds.geno.n, 3)
    ds = dataclasses.replace(ds, X=X)
    seed, it = 7, 2
    j = JaxBayesRRmMT(ds, phenos, window=16, exact=True, seed=seed,
                      mesh=make_mesh(1), schedule="marker")
    t = tmt.BayesRRmMT(ds, phenos, window=16, exact=True, seed=seed,
                       device="cpu")
    assert t.cfg.n_cov == j.cfg.n_cov == 3 and t.cfg.schedule == "marker"
    np.testing.assert_array_equal(t.x_cov.numpy(), np.asarray(j.x_cov))
    sj = j.init_state()
    assert np.asarray(sj.gamma).shape == (3, 3)
    st = tmt.state_from_numpy(_numpy(sj, tmt.STATE_FIELDS), "cpu")
    noise = mt_noise(seed, it, j.cfg)
    noise.update(_torch(dict(
        covperm=jax.random.permutation(_site(seed, it, 8), 3),
        cov=jax.random.normal(_site(seed, it, 7), (3, 3), F32))))
    sj2, stats_j = j.step(sj, it)
    st2, stats_t = t.step(st, it, noise=noise)
    _check(st2, sj2, ("eps", "beta", "acum", "gamma"))
    np.testing.assert_array_equal(stats_t.cass.numpy(),
                                  np.asarray(stats_j.cass))
    assert np.all(st2.eps.numpy()[t.trait_mask.numpy() == 0.0] == 0.0)
    assert np.all(st2.gamma.numpy() != 0.0)
