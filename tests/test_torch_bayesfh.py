"""Port BayesFH (``--mpibayes bayesFHMPI``) and the single-decode stale sweep
against the JAX sampler and the numpy golden model (CPU).

One sweep from the JAX sampler's state with the JAX sampler's own draws
(mu, u, nrm, the schedule's permutation, the FH gammas g_nu / g_lam of
sites 9 / 10 and the per-group variates of sites 13 / 11 / 12 behind
hyp_tau, tau and c_slab, rebuilt from its key schedule) must give the same
state on every branch: the whole sweep exact and stale (block schedule, the
JAX kernels in interpret mode), the per-window branch (the JAX CPU
``window_body``) and the single-decode sweep (HYDRA_TPU_SD=8, marker
schedule). eps, beta, acum, lambda and nu within atol 5e-4 / rtol 1e-3 (f32
summation order), components and cass equal, tau, hyp_tau, c_slab and
sigmaG within rtol 1e-4. Then an FH chain against
``hydra_tpu/testing/reference_bayesfh.py`` at the thresholds of
tests/test_bayesrrm.py::test_fh_matches_numpy_golden_model.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydra_tpu.parallel.mesh import make_mesh
from hydra_tpu.samplers.bayesrrm import BayesRRm as JaxBayesRRm
from hydra_tpu_torch.ops import sweep_kernel as tsk
from hydra_tpu_torch.samplers.bayesrrm import (STATE_FIELDS, BayesRRm,
                                               state_from_numpy,
                                               state_to_numpy)

from tests.test_bayesrrm import simulate

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)

F32 = jnp.float32
V0 = 3.0                     # v0L = v0t = v0c (the CLI defaults)


def _jax_noise(j, it, m0):
    """The JAX sampler's draws for iteration ``it`` (samplers/bayesrrm.py:
    233-285, 880-895) as the port's ``step(noise=...)`` takes them; the
    per-group gamma shapes need the sweep's m0."""
    cfg = j.cfg
    key = jax.random.fold_in(jax.random.key(j.seed), it)

    def site(s):
        return jax.random.fold_in(key, s)

    def gamma(k, a, shape=()):
        return jax.random.gamma(k, jnp.asarray(a, F32), shape, F32)

    d = dict(mu=jax.random.normal(site(0), (), F32),
             u=jax.random.uniform(site(1), (cfg.m_glob,), F32),
             nrm=jax.random.normal(site(2), (cfg.m_glob,), F32))
    pk = jax.random.fold_in(site(6), 0)
    if cfg.schedule == "block":
        d["wperm"] = jax.random.permutation(pk, cfg.n_windows)
    else:
        d["perm"] = jax.random.permutation(pk, cfg.m_loc)
    if cfg.fh:
        a = np.float32(0.5 + 0.5 * cfg.v0L)
        d["g_nu"] = gamma(site(9), a, (cfg.m_glob,))
        d["g_lam"] = gamma(site(10), a, (cfg.m_glob,))
        m0 = np.asarray(m0, np.float32)
        d["fh_gamma"] = jnp.asarray([[
            gamma(jax.random.fold_in(site(13), g), 0.5 + 0.5 * cfg.v0t),
            gamma(jax.random.fold_in(site(11), g),
                  np.float32(0.5) * (m0[g] + np.float32(cfg.v0t))),
            gamma(jax.random.fold_in(site(12), g),
                  np.float32(0.5) * (np.float32(cfg.v0c) + m0[g]))]
            for g in range(cfg.num_groups)])
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _jax_whole_sweep(ds, window, exact, seed, fh, schedule):
    """The JAX whole-sweep kernels in interpret mode on one device."""
    s = JaxBayesRRm(ds, window=window, exact=exact, seed=seed, fh=fh,
                    mesh=make_mesh(1), schedule=schedule)
    s.cfg = dataclasses.replace(s.cfg, use_mega=True, interpret=True)
    s._step = s._build_step()
    s._multi = {}
    return s


def _state(x):
    return {k: np.asarray(getattr(x, k)) for k in STATE_FIELDS}


CASES = {
    # id: (window, exact, missing_frac, fh, branch)
    "fh_exact_block": (32, True, 0.0, True, "block"),
    "fh_stale_block_missing": (32, False, 0.03, True, "block"),
    "fh_mega_off_exact": (16, True, 0.03, True, "mega_off"),
    "sd_bayesrrm": (32, False, 0.0, False, "sd"),
    "sd_fh_missing": (32, False, 0.03, True, "sd"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_one_sweep_matches_jax(case, monkeypatch):
    window, exact, missing_frac, fh, branch = CASES[case]
    monkeypatch.setenv("HYDRA_TPU_SD", "8" if branch == "sd" else "")
    ds, _, _ = simulate(m=150, n=400, h2=0.5, seed=5,
                        missing_frac=missing_frac)
    seed, it = 7, 3
    if branch == "mega_off":
        j = JaxBayesRRm(ds, window=window, exact=exact, seed=seed, fh=fh,
                        mesh=make_mesh(1), mega="off")
        t = BayesRRm(ds, window=window, exact=exact, seed=seed, fh=fh,
                     mega="off", device="cpu")
        assert t.cfg.per_window and not j.cfg.use_mega
    else:
        schedule = "block" if branch == "block" else "marker"
        j = _jax_whole_sweep(ds, window, exact, seed, fh, schedule)
        t = BayesRRm(ds, window=window, exact=exact, seed=seed, fh=fh,
                     schedule=schedule, device="cpu")
    assert t.cfg.schedule == j.cfg.schedule and t.cfg.fh == fh
    assert t.cfg.sub_window == (8 if branch == "sd" else 0)
    sj = j.init_state()
    xj = _state(sj)
    if fh:
        assert float(xj["tau"]) != 1.0 and np.all(xj["lambda_var"] > 0)
    sj2, stats_j = j.step(sj, it)
    noise = _jax_noise(j, it, stats_j.m0)
    before = dict(tsk.launches)
    st2, stats_t = t.step(state_from_numpy(xj, "cpu"), it, noise=noise)
    assert tsk.launches == before              # CPU: the plain versions
    a, b = state_to_numpy(st2), _state(sj2)
    np.testing.assert_array_equal(a["components"], b["components"])
    np.testing.assert_array_equal(stats_t.cass.numpy(),
                                  np.asarray(stats_j.cass))
    np.testing.assert_allclose(a["mu"], b["mu"], rtol=1e-6)
    for name in ("eps", "beta", "acum", "lambda_var", "nu_var"):
        np.testing.assert_allclose(a[name], b[name], atol=5e-4, rtol=1e-3,
                                   err_msg=name)
    if fh:
        for name in ("tau", "hyp_tau", "c_slab", "sigma_g"):
            np.testing.assert_allclose(a[name], b[name], rtol=1e-4,
                                       err_msg=name)
        assert float(a["tau"]) != float(xj["tau"])      # the chain moved
    assert len(np.unique(a["components"])) >= 3


def test_sd_sub_window_gate(monkeypatch):
    """HYDRA_TPU_SD reaches the single-decode sweep only where the JAX
    sampler's gate does: whole-sweep stale windows W >= 8 on the marker
    schedule."""
    ds, _, _ = simulate(m=64, n=200, h2=0.5, seed=2)
    monkeypatch.setenv("HYDRA_TPU_SD", "auto")
    kw = dict(device="cpu", seed=1)
    assert BayesRRm(ds, window=16, exact=False, schedule="marker",
                    **kw).cfg.sub_window == 16
    for args in (dict(window=16, exact=False, schedule="block"),
                 dict(window=16, exact=True, schedule="marker"),
                 dict(window=4, exact=False, schedule="marker"),
                 dict(window=16, exact=False, schedule="marker",
                      mega="off")):
        assert BayesRRm(ds, **args, **kw).cfg.sub_window == 0, args
    monkeypatch.setenv("HYDRA_TPU_SD", "12")
    with pytest.raises(ValueError, match="must divide"):
        BayesRRm(ds, window=16, exact=False, schedule="marker", **kw)


def test_fh_chain_matches_numpy_golden_model():
    """The thresholds of tests/test_bayesrrm.py::
    test_fh_matches_numpy_golden_model on its data: corr(mean beta) with
    the golden chain > 0.9, sigmaE within 15%, both corr with the truth
    > 0.6."""
    from hydra_tpu.io.pheno import center_and_scale
    from hydra_tpu.io.plink import decode_bed_numpy
    from hydra_tpu.testing import reference_bayesfh as fhref

    ds, beta_true, _ = simulate(m=96, n=500, h2=0.5, frac_causal=0.05,
                                seed=61)
    m = ds.m
    y = center_and_scale(ds.y)
    g, mask = decode_bed_numpy(ds.geno.packed, ds.geno.n_pad)
    xt = ((g - ds.geno.mave[:, None] * mask)
          * ds.geno.mstd[:, None])[:, :500]
    rng = np.random.RandomState(71)
    st = dict(eps=y.copy(), beta=np.zeros(m), mu=0.0,
              sigma_e=float(y @ y / 500 * 0.5),
              est_pi=np.array([[0.5, 0.5 * 0.001 / 0.111, 0.5 * 0.01 / 0.111,
                                0.5 * 0.1 / 0.111]]),
              fh=fhref.init_fh(rng, 1, m))
    nit = 200
    bsum, se_l = 0.0, []
    for it in range(nit):
        out = fhref.sweep(xt, st["eps"], st["beta"], ds.groups,
                          st["est_pi"], st["sigma_e"], st["mu"], st["fh"],
                          rng)
        st = {k: out[k] for k in st}
        if it >= nit // 2:
            bsum = bsum + out["beta"]
            se_l.append(out["sigma_e"])
    b_np, se_np = bsum / (nit // 2), np.mean(se_l)

    sampler = BayesRRm(ds, window=8, fh=True, seed=77, device="cpu")
    state = sampler.init_state()
    bsum, se_l = 0.0, []
    for it in range(nit):
        state, _ = sampler.step(state, it)
        if it >= nit // 2:
            bsum = bsum + sampler.beta_global(state)
            se_l.append(float(state.sigma_e))
    b_t, se_t = bsum / (nit // 2), np.mean(se_l)
    assert np.corrcoef(b_np, b_t)[0, 1] > 0.9, np.corrcoef(b_np, b_t)[0, 1]
    assert abs(se_t - se_np) / se_np < 0.15, (se_t, se_np)
    assert np.corrcoef(b_np, beta_true)[0, 1] > 0.6
    assert np.corrcoef(b_t, beta_true)[0, 1] > 0.6
