"""Port BayesW sampler vs the JAX sampler (CPU).

Layout and state conversion must match the JAX sampler exactly. One sweep
with the JAX sampler's own draws (mu and alpha slice noise, per-slot
component uniforms and slice noise, window or marker permutation), built
here with ``jax.random`` on its key schedule, must match the JAX per-window
path (``use_pallas=False`` on the CPU backend): eps and beta within atol
5e-4 / rtol 1e-3 (f32 summation order differs), components and cass
equal, mu and alpha within rtol 1e-5. A short chain recovers the simulated
mu, alpha and beta (the recipe of tests/test_bayesw.py::test_weibull_recovery).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydra_tpu.data.genotypes import GenotypeData
from hydra_tpu.io.plink import decode_bed_numpy
from hydra_tpu.parallel.mesh import make_mesh
from hydra_tpu.samplers.bayesw import BayesW as JaxBayesW
from hydra_tpu.utils.slice_sampler import slice_noise
from hydra_tpu_torch.ops import sweep_kernel_bw as tskbw
from hydra_tpu_torch.samplers.bayesw import (STATE_FIELDS, BayesW,
                                             gh_table, state_from_numpy,
                                             state_to_numpy)

from tests.test_bayesrrm import _pack
from tests.test_bayesw import simulate_weibull

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)

N_SHRINK = 24


def _dataset(m, n, seed, missing_frac=0.0, censor_frac=0.0):
    ds, beta, alpha, mu = simulate_weibull(m=m, n=n, seed=seed,
                                           censor_frac=censor_frac)
    if missing_frac:
        rs = np.random.RandomState(seed + 1)
        g, mask = decode_bed_numpy(ds.geno.packed, ds.geno.n)
        geno = np.where(mask > 0, g, -1).astype(np.int64)
        geno[rs.random_sample(geno.shape) < missing_frac] = -1
        gd = GenotypeData.from_packed(_pack(geno), ds.geno.n,
                                      np.zeros(0, np.int64))
        ds = dataclasses.replace(ds, geno=gd)
    return ds, beta, alpha, mu


def _jax_noise(seed, it, m_loc, n_windows, schedule):
    """The JAX sampler's own draws for iteration `it`
    (hydra_tpu/samplers/bayesw.py:170-292, single device), as torch."""
    key = jax.random.fold_in(jax.random.key(seed), it)

    def site(s):
        return jax.random.fold_in(key, s)

    keys = jax.vmap(lambda i: jax.random.fold_in(site(2), i))(
        jnp.arange(m_loc))
    u = jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float32))(keys)
    bkeys = jax.vmap(lambda k: jax.random.fold_in(k, 1))(keys)
    le, ub, uu = jax.vmap(lambda k: slice_noise(k, (), N_SHRINK))(bkeys)
    perm_key = jax.random.fold_in(site(5), 0)
    noise = dict(u=u, le=le, ub=ub, uu=uu)
    if schedule == "block":
        noise["wperm"] = jax.random.permutation(perm_key, n_windows)
    else:
        noise["perm"] = jax.random.permutation(perm_key, m_loc)
    out = {k: torch.from_numpy(np.array(v)) for k, v in noise.items()}
    for name, s in (("mu", 0), ("alpha", 1)):
        out[name] = tuple(torch.from_numpy(np.array(v))
                          for v in slice_noise(site(s), (), N_SHRINK))
    return out


def _jax_numpy(state):
    return {k: np.asarray(getattr(state, k)) for k in STATE_FIELDS}


def test_gh_table_matches_jax():
    from hydra_tpu.samplers.bayesw import gh_table as jax_gh_table
    for n in (3, 9, 25):
        for a, b in zip(gh_table(n), jax_gh_table(n)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("missing_frac,schedule", [(0.0, "block"),
                                                   (0.03, "marker")])
def test_layout_and_state_match_jax(missing_frac, schedule):
    ds, *_ = _dataset(60, 300, 5, missing_frac)
    j = JaxBayesW(ds, window=16, seed=7, mesh=make_mesh(1), quad_points=9,
                  schedule=schedule)
    t = BayesW(ds, window=16, seed=7, quad_points=9, device="cpu",
               schedule=schedule)
    assert t.cfg.m_loc == j.cfg.m_loc == 64           # 4 pad slots
    assert t.cfg.complete == j.cfg.complete == (missing_frac == 0.0)
    assert t.cfg.schedule == j.cfg.schedule == schedule
    np.testing.assert_array_equal(t.slot_to_marker, j.slot_to_marker)
    np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
    for name in ("mave", "msd", "valid", "sum_fail"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))
    np.testing.assert_array_equal(t.groups.numpy(), np.asarray(j.groups))
    x = _jax_numpy(j.init_state())
    back = state_to_numpy(state_from_numpy(x, "cpu"))
    mine = state_to_numpy(t.init_state())
    for name in STATE_FIELDS:
        assert back[name].dtype == x[name].dtype, name
        np.testing.assert_array_equal(back[name], x[name])
        np.testing.assert_array_equal(mine[name], x[name])


@pytest.mark.parametrize("window,schedule,missing_frac", [
    (1, "block", 0.0),
    (1, "marker", 0.03),
    (16, "block", 0.03),
    (16, "marker", 0.0),
])
def test_one_step_matches_jax(window, schedule, missing_frac):
    ds, *_ = _dataset(48, 240, 13, missing_frac, censor_frac=0.2)
    seed, it = 7, 2
    j = JaxBayesW(ds, window=window, seed=seed, mesh=make_mesh(1),
                  quad_points=9, schedule=schedule)
    assert not j.cfg.use_pallas and not j.cfg.use_mega
    t = BayesW(ds, window=window, seed=seed, quad_points=9, device="cpu",
               schedule=schedule)
    sj = j.init_state()
    st = state_from_numpy(_jax_numpy(sj), "cpu")
    noise = _jax_noise(seed, it, j.cfg.m_loc, j.cfg.n_windows, schedule)
    before = dict(tskbw.launches)
    sj2, stats_j = j.step(sj, it)
    st2, stats_t = t.step(st, it, noise=noise)
    assert tskbw.launches == before            # CPU tensors: plain version
    np.testing.assert_allclose(float(st2.mu), float(sj2.mu), rtol=1e-5)
    np.testing.assert_allclose(float(st2.alpha), float(sj2.alpha), rtol=1e-5)
    np.testing.assert_allclose(st2.eps.numpy(), np.asarray(sj2.eps),
                               atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(st2.beta.numpy(), np.asarray(sj2.beta),
                               atol=5e-4, rtol=1e-3)
    np.testing.assert_array_equal(st2.components.numpy(),
                                  np.asarray(sj2.components))
    np.testing.assert_array_equal(stats_t.cass.numpy(),
                                  np.asarray(stats_j.cass))
    # the draws did something: non-zero components were sampled
    assert int((st2.components.numpy() > 0).sum()) >= 2


def test_state_round_trip_and_determinism():
    ds, *_ = _dataset(40, 200, 3)
    runs = []
    for _ in range(2):
        s = BayesW(ds, window=8, seed=11, quad_points=7, device="cpu")
        st, _ = s.run(2)
        runs.append(state_to_numpy(st))
        back = state_to_numpy(state_from_numpy(runs[-1], "cpu"))
        for name in STATE_FIELDS:
            np.testing.assert_array_equal(back[name], runs[-1][name])
    for name in STATE_FIELDS:
        np.testing.assert_array_equal(runs[0][name], runs[1][name])


def test_chain_recovers_weibull_truth():
    ds, beta_true, alpha_true, mu_true = _dataset(100, 800, 17)
    s = BayesW(ds, window=4, seed=19, quad_points=25, device="cpu")
    st = s.init_state()
    mus, alphas, betas, n_iter, burn = [], [], 0.0, 80, 40
    for it in range(n_iter):
        st, _ = s.step(st, it)
        if it >= burn:
            mus.append(float(st.mu))
            alphas.append(float(st.alpha))
            betas = betas + s.beta_global(st)
    assert np.isfinite(st.eps.numpy()).all()
    assert abs(np.mean(mus) - mu_true) < 0.1, np.mean(mus)
    assert abs(np.mean(alphas) - alpha_true) / alpha_true < 0.25, \
        np.mean(alphas)
    corr = np.corrcoef(betas / (n_iter - burn), beta_true)[0, 1]
    assert corr > 0.5, corr
