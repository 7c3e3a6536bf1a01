"""Port multi-trait BayesRRm vs the JAX sampler and the numpy golden model
(CPU).

Layout, masked marker statistics and state conversion must match the JAX
``BayesRRmMT``; one sweep with the JAX sampler's own draws injected (mu,
per-slot u/nrm, window or marker permutation) must match it for each of
the three branches (stale and exact whole-sweep kernels in interpret mode;
the exact per-window path with NaN phenotypes) within the kernel
tolerances; a chain must agree per trait with the sequential golden model
of hydra_tpu/testing/reference_bayesrrm_mt.py.
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
from hydra_tpu.samplers.bayesrrm_mt import BayesRRmMT as JaxBayesRRmMT
from hydra_tpu_torch.ops.decode import decode_planes_hp
from hydra_tpu_torch.samplers.bayesrrm_mt import (STATE_FIELDS, BayesRRmMT,
                                                  masked_marker_stats,
                                                  state_from_numpy,
                                                  state_to_numpy)

from tests.test_bayesrrm import _pack
from tests.test_bayesrrm_mt import simulate_mt

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)


def with_missing(ds, frac, seed):
    """The dataset with a fraction of genotypes set missing (stats
    recomputed by from_packed)."""
    g, _ = decode_bed_numpy(ds.geno.packed, ds.geno.n)
    g = g.astype(np.int64)
    g[np.random.RandomState(seed).random_sample(g.shape) < frac] = -1
    gd = GenotypeData.from_packed(_pack(g), ds.geno.n,
                                  np.array([], dtype=np.int64))
    return dataclasses.replace(ds, geno=gd)


def _jax_sampler(ds, phenos, window, exact, seed, schedule, mega):
    s = JaxBayesRRmMT(ds, phenos, window=window, exact=exact, seed=seed,
                      mesh=make_mesh(1), schedule=schedule)
    if mega:
        # the whole-sweep kernels in interpret mode (tests/test_sweep_kernel_mt)
        s.cfg = dataclasses.replace(s.cfg, use_mega=True, interpret=True)
        s._step = s._build_step()
    return s


def _jax_noise(seed, it, cfg):
    """The JAX sampler's own draws for iteration `it`
    (samplers/bayesrrm_mt.py:251-290), handed to the port."""
    key = jax.random.fold_in(jax.random.key(seed), it)

    def site(s):
        return jax.random.fold_in(key, s)

    T, f32 = cfg.n_traits, jnp.float32
    noise = dict(mu=jax.random.normal(site(0), (T,), f32),
                 u=jax.random.uniform(site(1), (cfg.m_glob, T), f32),
                 nrm=jax.random.normal(site(2), (cfg.m_glob, T), f32))
    pkey = jax.random.fold_in(site(6), 0)
    if cfg.schedule == "block":
        noise["wperm"] = jax.random.permutation(pkey, cfg.n_windows)
    else:
        noise["perm"] = jax.random.permutation(pkey, cfg.m_loc)
    return {k: torch.from_numpy(np.array(v)) for k, v in noise.items()}


def _jax_state_numpy(state):
    return {k: np.asarray(getattr(state, k)) for k in STATE_FIELDS}


@pytest.mark.parametrize("exact,na_frac,missing,schedule", [
    (False, 0.0, 0.0, "block"),
    (True, 0.1, 0.03, "marker"),
])
def test_layout_and_state_match_jax(exact, na_frac, missing, schedule):
    ds, phenos, _ = simulate_mt(m=70, n=300, n_traits=3, seed=5,
                                na_frac=na_frac)
    if missing:
        ds = with_missing(ds, missing, 6)
    j = JaxBayesRRmMT(ds, phenos, window=16, exact=exact, seed=7,
                      mesh=make_mesh(1), schedule=schedule)
    t = BayesRRmMT(ds, phenos, window=16, exact=exact, seed=7, device="cpu")
    assert t.cfg.schedule == j.cfg.schedule == schedule
    assert t.cfg.m_loc == j.cfg.m_loc == 80                 # 10 pad slots
    assert (t.cfg.complete, t.cfg.full_pheno) == (j.cfg.complete,
                                                  j.cfg.full_pheno)
    np.testing.assert_array_equal(t.slot_to_marker, j.slot_to_marker)
    np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
    np.testing.assert_array_equal(t.groups.numpy(), np.asarray(j.groups))
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    np.testing.assert_array_equal(t.trait_mask.numpy(),
                                  np.asarray(j.trait_mask))
    np.testing.assert_array_equal(t.dN.numpy(), np.asarray(j.n_per_trait))
    for name in ("mave", "mstd"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), rtol=1e-6)
    x = _jax_state_numpy(j.init_state())
    back = state_to_numpy(state_from_numpy(x, "cpu"))
    for name in STATE_FIELDS:
        assert back[name].dtype == x[name].dtype, name
        np.testing.assert_array_equal(back[name], x[name])
    mine = state_to_numpy(t.init_state())
    for name in ("eps", "beta", "components", "acum", "mu", "sigma_e",
                 "est_pi", "gamma"):
        assert mine[name].shape == x[name].shape, name
        np.testing.assert_allclose(mine[name], x[name], rtol=1e-6)


def test_masked_stats_match_jax_blockwise():
    """The float64 masked statistics, computed a few markers per block,
    against the JAX sampler's host computation (<= 1e-6 relative)."""
    ds, phenos, _ = simulate_mt(m=40, n=250, n_traits=2, seed=8, na_frac=0.2)
    ds = with_missing(ds, 0.05, 9)
    j = JaxBayesRRmMT(ds, phenos, window=8, seed=1, mesh=make_mesh(1),
                      schedule="marker")
    mask = torch.from_numpy(np.isfinite(phenos).astype(np.float64))
    mave, mstd = masked_marker_stats(ds.geno.packed, ds.geno.n, mask,
                                     block_bytes=4096)
    np.testing.assert_allclose(mave.numpy(), np.asarray(j.mave)[:40],
                               rtol=1e-6)
    np.testing.assert_allclose(mstd.numpy(), np.asarray(j.mstd)[:40],
                               rtol=1e-6)


BRANCHES = {
    # name: (exact, NaN fraction, schedule, JAX whole-sweep kernel)
    "stale": (False, 0.1, "block", True),
    "exact_shared_gram": (True, 0.0, "block", True),
    "exact_per_window": (True, 0.1, "marker", False),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_one_sweep_matches_jax(branch):
    exact, na_frac, schedule, mega = BRANCHES[branch]
    ds, phenos, _ = simulate_mt(m=90, n=300, n_traits=3, seed=13,
                                na_frac=na_frac)
    seed, it = 7, 2
    j = _jax_sampler(ds, phenos, 16, exact, seed, schedule, mega)
    t = BayesRRmMT(ds, phenos, window=16, exact=exact, seed=seed,
                   device="cpu")
    assert t.cfg.schedule == schedule
    sj = j.init_state()
    st = state_from_numpy(_jax_state_numpy(sj), "cpu")
    noise = _jax_noise(seed, it, j.cfg)
    sj2, stats_j = j.step(sj, it)
    st2, stats_t = t.step(st, it, noise=noise)
    np.testing.assert_allclose(st2.mu.numpy(), np.asarray(sj2.mu), rtol=1e-6)
    for name in ("eps", "beta", "acum"):
        np.testing.assert_allclose(getattr(st2, name).numpy(),
                                   np.asarray(getattr(sj2, name)),
                                   atol=5e-4, rtol=1e-3, err_msg=name)
    np.testing.assert_array_equal(st2.components.numpy(),
                                  np.asarray(sj2.components))
    np.testing.assert_array_equal(stats_t.cass.numpy(),
                                  np.asarray(stats_j.cass))
    np.testing.assert_allclose(stats_t.beta_sqn.numpy(),
                               np.asarray(stats_j.beta_sqn), rtol=1e-3,
                               atol=1e-8)
    assert len(np.unique(st2.components.numpy())) >= 3
    assert np.all(st2.eps.numpy()[t.trait_mask.numpy() == 0.0] == 0.0)


def _golden_h2_beta(ds, phenos, n_iter, burn):
    """The sequential numpy multi-trait chain of
    tests/test_bayesrrm_mt.py::test_mt_matches_numpy_golden_model, without
    covariates."""
    from hydra_tpu.testing import reference_bayesrrm_mt as mtref

    m, n = ds.geno.m, ds.geno.n
    T = phenos.shape[0]
    g, miss = decode_bed_numpy(ds.geno.packed, n)
    tm = np.isfinite(phenos).astype(np.float64).T
    nonas = tm.sum(axis=0)
    y = np.where(tm.T > 0, phenos, 0.0)
    y = (y - y.sum(1)[:, None] / nonas[:, None]) * tm.T
    y *= np.sqrt((nonas - 1) / (y * y).sum(1))[:, None]
    mave = np.zeros((m, T))
    mstd = np.zeros((m, T))
    for t in range(T):
        mt = miss * tm[:, t][None, :]
        cnt = mt.sum(1)
        mave[:, t] = (g * mt).sum(1) / cnt
        mstd[:, t] = np.sqrt((cnt - 1)
                             / (mt * (g - mave[:, t][:, None]) ** 2).sum(1))
    rng = np.random.RandomState(99)
    mS = ds.mS[0]
    pi = np.concatenate([[0.5], 0.5 * mS[1:] / mS[1:].sum()])
    st = dict(eps=(y * tm.T).T, beta=np.zeros((m, T)), mu=np.zeros(T),
              sigma_g=np.full((T, 1), 0.5),
              sigma_e=(y ** 2).sum(1) / nonas * 0.5,
              est_pi=np.tile(pi, (T, 1, 1)))
    h2, bsum = [], 0.0
    for it in range(n_iter):
        out = mtref.sweep(g, miss, tm, st["eps"], st["beta"], mave, mstd,
                          ds.groups, ds.mS, st["sigma_g"], st["sigma_e"],
                          st["mu"], st["est_pi"], rng)
        st = {k: out[k] for k in st}
        if it >= burn:
            sg = out["sigma_g"].sum(axis=1)
            h2.append(sg / (sg + out["sigma_e"]))
            bsum = bsum + out["beta"]
    return np.mean(h2, axis=0), bsum / (n_iter - burn)


def test_chain_matches_golden_model():
    """200 exact sweeps on NaN phenotypes (the per-window path) agree per
    trait with the sequential golden chain: posterior h2 within 0.12 and
    posterior mean effects correlated > 0.9."""
    ds, phenos, betas = simulate_mt(m=96, n=400, n_traits=2, seed=43,
                                    na_frac=0.08)
    h2_gold, beta_gold = _golden_h2_beta(ds, phenos, 200, 100)
    s = BayesRRmMT(ds, phenos, window=16, seed=55, device="cpu")
    assert s.cfg.exact and not s.cfg.full_pheno
    st = s.init_state()
    h2, bsum = [], 0.0
    for it in range(200):
        st, _ = s.step(st, it)
        if it >= 100:
            sg = st.sigma_g.sum(dim=1).numpy()
            h2.append(sg / (sg + st.sigma_e.numpy()))
            bsum = bsum + s.beta_global(st)
    h2_port, beta_port = np.mean(h2, axis=0), bsum / 100
    for t in range(2):
        assert abs(h2_port[t] - h2_gold[t]) < 0.12, (t, h2_port, h2_gold)
        assert np.corrcoef(beta_port[:, t], beta_gold[:, t])[0, 1] > 0.9, t
        assert np.corrcoef(beta_port[:, t], betas[:, t])[0, 1] > 0.5, t
    assert np.all(st.eps.numpy()[:ds.geno.n][~np.isfinite(phenos).T] == 0.0)


@pytest.mark.parametrize("exact", [False, True])
def test_chain_is_deterministic_in_seed(exact):
    ds, phenos, _ = simulate_mt(m=48, n=200, n_traits=2, seed=2, na_frac=0.1)
    runs = []
    for _ in range(2):
        s = BayesRRmMT(ds, phenos, window=16, exact=exact, seed=9,
                       device="cpu")
        st = s.init_state()
        for it in range(3):
            st, _ = s.step(st, it)
        runs.append(state_to_numpy(st))
    for name in STATE_FIELDS:
        np.testing.assert_array_equal(runs[0][name], runs[1][name])


@pytest.mark.parametrize("na_frac", [0.0, 0.1])
def test_window_gram_matches_plain_product(na_frac):
    """The chunked window Gram (S = 2 chunks at n_pad = 1024) equals the
    plain masked product of the JAX sampler's _mt_gram_blocks."""
    ds, phenos, _ = simulate_mt(m=40, n=1000, n_traits=2, seed=4,
                                na_frac=na_frac)
    ds = with_missing(ds, 0.03, 5)
    s = BayesRRmMT(ds, phenos, window=16, seed=3, device="cpu")
    assert s.gram_chunks == 2
    slots = torch.arange(16, 32)
    mave, mstd = s.mave[slots].double(), s.mstd[slots].double()
    g, m = (x.double() for x in decode_planes_hp(s.packed[slots]))
    xt = (g[None] - mave.T[:, :, None] * m[None]) * mstd.T[:, :, None]
    want = torch.einsum("twn,tvn->twv",
                        xt * s.trait_mask.T.double()[:, None, :], xt)
    got = s.window_gram(slots, s.mave[slots], s.mstd[slots])
    if na_frac == 0.0:
        want = want[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-3)

