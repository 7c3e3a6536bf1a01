"""Port BayesRRm sampler vs the JAX sampler and the numpy golden model (CPU).

Layout and state conversion must match the JAX sampler exactly; one sweep
with the same injected noise (mu draw, per-slot u/nrm, window permutation)
must match the JAX whole-sweep kernel in interpret mode within the kernel
tolerances; chains must recover h2 and agree with the sequential golden
chain of hydra_tpu/testing/reference_bayesrrm.py.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from hydra_tpu.parallel.mesh import make_mesh
from hydra_tpu.samplers.bayesrrm import BayesRRm as JaxBayesRRm
from hydra_tpu_torch.samplers.bayesrrm import (STATE_FIELDS, BayesRRm,
                                               state_from_numpy,
                                               state_to_numpy)

from tests.test_bayesrrm import simulate

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)


def _jax_sampler(ds, window, exact, seed):
    """The JAX block-schedule whole-sweep path, kernels in interpret mode."""
    s = JaxBayesRRm(ds, window=window, exact=exact, seed=seed,
                    mesh=make_mesh(1), schedule="block")
    s.cfg = dataclasses.replace(s.cfg, use_mega=True, interpret=True)
    s._step = s._build_step()
    s._multi = {}
    return s


def _jax_noise(seed, it, m_glob, n_windows):
    """The JAX sampler's own draws for iteration `it`
    (samplers/bayesrrm.py:233-277), handed to the port."""
    key = jax.random.fold_in(jax.random.key(seed), it)

    def site(s):
        return jax.random.fold_in(key, s)

    f32 = jnp.float32
    wp = jax.random.permutation(jax.random.fold_in(site(6), 0), n_windows)
    return {k: torch.from_numpy(np.array(v)) for k, v in dict(
        mu=jax.random.normal(site(0), (), f32),
        u=jax.random.uniform(site(1), (m_glob,), f32),
        nrm=jax.random.normal(site(2), (m_glob,), f32),
        wperm=wp).items()}


def _jax_state_numpy(state):
    return {k: np.asarray(getattr(state, k)) for k in STATE_FIELDS}


@pytest.mark.parametrize("missing_frac", [0.0, 0.03])
def test_layout_and_state_match_jax(missing_frac):
    ds, _, _ = simulate(m=150, n=400, h2=0.5, seed=5,
                        missing_frac=missing_frac)
    j = JaxBayesRRm(ds, window=32, exact=True, seed=7, mesh=make_mesh(1),
                    schedule="block")
    t = BayesRRm(ds, window=32, exact=True, seed=7, device="cpu")
    assert t.cfg.m_loc == j.cfg.m_loc == 160           # 10 pad slots
    assert t.cfg.complete == j.cfg.complete == (missing_frac == 0.0)
    assert t.cfg.schedule == "block"
    np.testing.assert_array_equal(t.slot_to_marker, j.slot_to_marker)
    np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
    for name in ("mave", "mstd", "valid"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))
    np.testing.assert_array_equal(t.groups.numpy(), np.asarray(j.groups))
    x = _jax_state_numpy(j.init_state())
    back = state_to_numpy(state_from_numpy(x, "cpu"))
    for name in STATE_FIELDS:
        assert back[name].dtype == x[name].dtype, name
        np.testing.assert_array_equal(back[name], x[name])
    # the port's own init has the same deterministic parts
    mine = state_to_numpy(t.init_state())
    for name in ("eps", "beta", "components", "mu", "sigma_e", "est_pi"):
        np.testing.assert_allclose(mine[name], x[name], rtol=1e-6)


@pytest.mark.parametrize("exact,missing_frac", [(True, 0.0), (False, 0.03)])
def test_one_sweep_matches_jax(exact, missing_frac):
    ds, _, _ = simulate(m=150, n=400, h2=0.5, seed=5,
                        missing_frac=missing_frac)
    seed, it = 7, 3
    j = _jax_sampler(ds, 32, exact, seed)
    t = BayesRRm(ds, window=32, exact=exact, seed=seed, device="cpu")
    sj = j.init_state()
    st = state_from_numpy(_jax_state_numpy(sj), "cpu")
    noise = _jax_noise(seed, it, j.cfg.m_glob, j.cfg.n_windows)
    sj2, stats_j = j.step(sj, it)
    st2, stats_t = t.step(st, it, noise=noise)
    np.testing.assert_allclose(float(st2.mu), float(sj2.mu), rtol=1e-6)
    np.testing.assert_allclose(st2.eps.numpy(), np.asarray(sj2.eps),
                               atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(st2.beta.numpy(), np.asarray(sj2.beta),
                               atol=5e-4, rtol=1e-3)
    np.testing.assert_array_equal(st2.components.numpy(),
                                  np.asarray(sj2.components))
    np.testing.assert_allclose(st2.acum.numpy(), np.asarray(sj2.acum),
                               atol=5e-4, rtol=1e-3)
    np.testing.assert_array_equal(stats_t.cass.numpy(),
                                  np.asarray(stats_j.cass))
    np.testing.assert_allclose(stats_t.beta_sqn.numpy(),
                               np.asarray(stats_j.beta_sqn), rtol=1e-3)


def _port_chain(sampler, n_iter, burn):
    state = sampler.init_state()
    h2, beta_sum = [], 0.0
    for it in range(n_iter):
        state, _ = sampler.step(state, it)
        if it >= burn:
            sg = float(state.sigma_g.sum())
            se = float(state.sigma_e)
            h2.append(sg / (sg + se))
            beta_sum = beta_sum + sampler.beta_global(state)
    assert np.isfinite(state.eps.numpy()).all()
    return float(np.mean(h2)), beta_sum / (n_iter - burn)


def _golden_chain(ds, n_iter, burn):
    """The sequential numpy Gibbs chain of test_matches_numpy_golden_model."""
    from hydra_tpu.io.pheno import center_and_scale
    from hydra_tpu.io.plink import decode_bed_numpy
    from hydra_tpu.testing.reference_bayesrrm import sweep

    n, m = ds.geno.n, ds.geno.m
    y = center_and_scale(ds.y)
    g, mask = decode_bed_numpy(ds.geno.packed, ds.geno.n_pad)
    xt = ((g - ds.geno.mave[:, None] * mask) * ds.geno.mstd[:, None])[:, :n]
    rng = np.random.RandomState(99)
    mS = ds.mS[0]
    pi = np.concatenate([[0.5], 0.5 * mS[1:] / mS[1:].sum()])[None, :]
    st = dict(eps=y.copy(), beta=np.zeros(m), mu=0.0,
              sigma_g=np.array([0.5]), sigma_e=float(y @ y / n * 0.5),
              est_pi=pi)
    h2 = []
    for it in range(n_iter):
        out = sweep(xt, st["eps"], st["beta"], ds.groups, ds.mS,
                    st["sigma_g"], st["sigma_e"], st["mu"], st["est_pi"], rng)
        st = {k: out[k] for k in st}
        if it >= burn:
            sg = out["sigma_g"].sum()
            h2.append(sg / (sg + out["sigma_e"]))
    return float(np.mean(h2))


def test_exact_chain_recovers_h2_and_matches_golden():
    ds, beta_true, h2_true = simulate(m=128, n=300, h2=0.5, seed=17)
    sampler = BayesRRm(ds, window=32, exact=True, seed=55, device="cpu")
    h2_port, beta_mean = _port_chain(sampler, 200, 100)
    h2_gold = _golden_chain(ds, 200, 100)
    assert abs(h2_port - h2_true) < 0.15, h2_port
    assert abs(h2_port - h2_gold) < 0.1, (h2_port, h2_gold)
    assert np.corrcoef(beta_mean, beta_true)[0, 1] > 0.55


@pytest.mark.parametrize("exact,schedule,m,n,data_seed,n_iter,burn", [
    (True, "block", 128, 400, 5, 150, 50),
    (False, "block", 256, 600, 8, 200, 100),
    (False, "marker", 256, 600, 8, 200, 100),
])
def test_chain_with_missing_genotypes(exact, schedule, m, n, data_seed,
                                      n_iter, burn):
    ds, beta_true, h2_true = simulate(m=m, n=n, h2=0.5, seed=data_seed,
                                      missing_frac=0.05)
    sampler = BayesRRm(ds, window=32, exact=exact, seed=4, device="cpu",
                       schedule=schedule)
    assert not sampler.cfg.complete and sampler.cfg.schedule == schedule
    h2_port, beta_mean = _port_chain(sampler, n_iter, burn)
    assert abs(h2_port - h2_true) < 0.15, h2_port
    assert np.corrcoef(beta_mean, beta_true)[0, 1] > 0.55


def test_chain_is_deterministic_in_seed():
    ds, _, _ = simulate(m=96, n=300, h2=0.5, seed=2)
    runs = []
    for _ in range(2):
        s = BayesRRm(ds, window=32, exact=True, seed=9, device="cpu")
        st, _ = s.run(3)
        runs.append(state_to_numpy(st))
    for name in STATE_FIELDS:
        np.testing.assert_array_equal(runs[0][name], runs[1][name])


def test_small_window_is_not_ported():
    """Windows below 8 run, single-trait and multi-trait alike (the
    whole-sweep kernels take every W, on the marker schedule the JAX
    sampler resolves for them)."""
    from hydra_tpu_torch.samplers.bayesrrm_mt import BayesRRmMT

    ds, _, _ = simulate(m=64, n=200, h2=0.5, seed=2)
    s = BayesRRm(ds, window=4, device="cpu")
    assert s.cfg.schedule == "marker" and not s.cfg.per_window
    st, stats = s.run(2)
    assert np.isfinite(st.eps.numpy()).all() and int(stats.m0.sum()) > 0
    mt = BayesRRmMT(ds, np.stack([ds.y, ds.y]), window=4, device="cpu")
    assert mt.cfg.schedule == "marker" and mt.cfg.exact
    st = mt.init_state()
    for it in range(2):
        st, stats = mt.step(st, it)
    assert np.isfinite(st.eps.numpy()).all() and int(stats.m0.sum()) > 0
