"""The port's float64 branch (``--dtype float64``) of BayesRRm and BayesFH
against the JAX sampler in float64 (CPU).

The JAX sampler runs float64 without Pallas, on its XLA ``window_body`` in
float64 on the marker schedule; one sweep from its state with its own
draws (mu, u, nrm, the marker permutation and, for BayesFH, the gammas of
sites 9 / 10 / 13 / 11 / 12, rebuilt from its key schedule in float64)
must give the port's float64 branch the same state within rtol 1e-9 on eps
and beta, components and cass equal. ``jax_enable_x64`` is switched on for
the JAX side and restored afterwards, as tests/test_bayesrrm.py's float64
test does. Then ``ops/decode.standardized_window`` against the JAX
package's, and the CLI's float64 run (its schedule, its dtype in the
restart state, and multi-trait and BayesW ignoring the flag as the JAX
CLI does).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydra_tpu.ops import decode as jdecode
from hydra_tpu.parallel.mesh import make_mesh
from hydra_tpu.samplers.bayesrrm import BayesRRm as JaxBayesRRm
from hydra_tpu_torch import cli
from hydra_tpu_torch.ops import decode as tdecode
from hydra_tpu_torch.ops import window_kernels as twk
from hydra_tpu_torch.samplers.bayesrrm import (STATE_FIELDS, BayesRRm,
                                               state_from_numpy,
                                               state_to_numpy)

from tests.test_bayesrrm import simulate

torch.set_num_threads(1)

F64 = jnp.float64


def _jax_noise(j, it, m0):
    """The JAX float64 sampler's draws for iteration ``it``
    (samplers/bayesrrm.py:233-285, 880-895) as the port's ``step(noise=...)``
    takes them."""
    cfg = j.cfg
    key = jax.random.fold_in(jax.random.key(j.seed), it)

    def site(s):
        return jax.random.fold_in(key, s)

    def gamma(k, a, shape=()):
        return jax.random.gamma(k, jnp.asarray(a, F64), shape, F64)

    d = dict(mu=jax.random.normal(site(0), (), F64),
             u=jax.random.uniform(site(1), (cfg.m_glob,), F64),
             nrm=jax.random.normal(site(2), (cfg.m_glob,), F64),
             perm=jax.random.permutation(jax.random.fold_in(site(6), 0),
                                         cfg.m_loc))
    if cfg.fh:
        a = 0.5 + 0.5 * cfg.v0L
        d["g_nu"] = gamma(site(9), a, (cfg.m_glob,))
        d["g_lam"] = gamma(site(10), a, (cfg.m_glob,))
        m0 = np.asarray(m0, np.float64)
        d["fh_gamma"] = jnp.asarray([[
            gamma(jax.random.fold_in(site(13), g), 0.5 + 0.5 * cfg.v0t),
            gamma(jax.random.fold_in(site(11), g), 0.5 * (m0[g] + cfg.v0t)),
            gamma(jax.random.fold_in(site(12), g), 0.5 * (cfg.v0c + m0[g]))]
            for g in range(cfg.num_groups)])
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("fh,exact,window,missing_frac", [
    (False, True, 16, 0.0), (False, False, 16, 0.03), (False, True, 4, 0.03),
    (True, True, 16, 0.03), (True, False, 8, 0.0)])
def test_one_sweep_matches_jax_f64(x64, fh, exact, window, missing_frac):
    ds, _, _ = simulate(m=64, n=200, h2=0.5, seed=5,
                        missing_frac=missing_frac)
    seed, it = 7, 3
    j = JaxBayesRRm(ds, window=window, exact=exact, seed=seed, fh=fh,
                    mesh=make_mesh(1), dtype="float64")
    t = BayesRRm(ds, window=window, exact=exact, seed=seed, fh=fh,
                 dtype="float64", device="cpu")
    assert not j.cfg.use_pallas and not j.cfg.use_mega
    assert t.cfg.schedule == j.cfg.schedule == "marker" and t.cfg.per_window
    sj = j.init_state()
    xj = {k: np.asarray(getattr(sj, k)) for k in STATE_FIELDS}
    assert xj["eps"].dtype == np.float64
    sj2, stats_j = j.step(sj, it)
    noise = _jax_noise(j, it, stats_j.m0)
    before = dict(twk.launches)
    st2, stats_t = t.step(state_from_numpy(xj, "cpu", torch.float64), it,
                          noise=noise)
    assert twk.launches == before              # no kernel on this branch
    a = state_to_numpy(st2)
    b = {k: np.asarray(getattr(sj2, k)) for k in STATE_FIELDS}
    assert a["eps"].dtype == a["beta"].dtype == np.float64
    np.testing.assert_array_equal(a["components"], b["components"])
    np.testing.assert_array_equal(stats_t.cass.numpy(),
                                  np.asarray(stats_j.cass))
    for name in ("eps", "beta"):
        np.testing.assert_allclose(a[name], b[name], rtol=1e-9, atol=1e-12,
                                   err_msg=name)
    for name in ("mu", "acum", "lambda_var", "nu_var"):
        np.testing.assert_allclose(a[name], b[name], rtol=1e-9, atol=1e-12,
                                   err_msg=name)
    if fh:
        for name in ("tau", "hyp_tau", "c_slab", "sigma_g"):
            np.testing.assert_allclose(a[name], b[name], rtol=1e-9,
                                       err_msg=name)
    assert len(np.unique(a["components"])) >= 2


@pytest.mark.parametrize("missing", [False, True])
def test_decode_helpers_match_jax(missing):
    """standardized_window of ops/decode.py (on h-packed bytes) against the
    JAX package's (on PLINK-coded bytes)."""
    rs = np.random.RandomState(3)
    W, nb = 12, 32
    plink = rs.randint(0, 256, size=(W, nb)).astype(np.uint8)
    if not missing:
        # code 1 is missing: map it to 3 (genotype 0)
        c = np.stack([(plink >> (2 * k)) & 3 for k in range(4)], -1)
        c[c == 1] = 3
        plink = (c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4)
                 | (c[..., 3] << 6)).astype(np.uint8)
    hp = torch.from_numpy(tdecode.hpack_bytes(plink))
    mave = rs.rand(W).astype(np.float32) * 2
    mstd = rs.rand(W).astype(np.float32) + 0.5
    xt = tdecode.standardized_window(hp, torch.from_numpy(mave),
                                     torch.from_numpy(mstd))
    np.testing.assert_allclose(
        xt.numpy(), np.asarray(jdecode.standardized_window(
            jnp.asarray(plink), jnp.asarray(mave), jnp.asarray(mstd))),
        rtol=1e-6, atol=1e-6)


def _argv(base, out, *extra):
    return ["--device", "cpu", "--mpibayes", "bayesMPI", "--bfile", base,
            "--pheno", base + ".phen", "--S", "0.001,0.01,0.1",
            "--chain-length", "12", "--thin", "2", "--save", "4", "--seed",
            "3", "--mcmc-out-dir", str(out), "--mcmc-out-name", "run",
            "--dtype", "float64", *extra]


@pytest.fixture
def small_bed(synthetic_bed_factory):
    base, geno = synthetic_bed_factory(60, 200, seed=4)
    rs = np.random.RandomState(5)
    y = (geno - geno.mean(1, keepdims=True)).T @ (rs.randn(60) * 0.1) \
        + rs.randn(200)
    with open(base + ".phen", "w") as fh:
        fh.writelines(f"per{i} per{i} {y[i]:.6f}\n" for i in range(200))
    with open(base + ".fail", "w") as fh:
        fh.writelines(f"{int(v)}\n" for v in rs.random_sample(200) > 0.2)
    return base


@pytest.mark.parametrize("extra", [[], ["--stale", "--window", "8"],
                                   ["--mpibayes", "bayesFHMPI"]])
def test_cli_f64_runs_and_restarts(small_bed, tmp_path, extra, capsys):
    """--dtype float64 through the CLI: the marker schedule (.rng.0), and a
    restart from the save at 8 repeats the uninterrupted chain's records
    byte for byte."""
    out = tmp_path / "o"
    assert cli.main(_argv(small_bed, out, *extra)) == 0
    rng = json.load(open(out / "run.rng.0"))
    assert rng["schedule"] == "marker" and rng["iteration"] == 8
    full = open(out / "run.csv").read().splitlines()
    os.rename(out / "run.csv", out / "full.csv")
    with open(out / "run.csv", "w") as fh:      # the chain cut after 9
        fh.write("\n".join(full[:5]) + "\n")
    assert cli.main(_argv(small_bed, out, "--restart", *extra)) == 0
    rs = open(out / "run_rs.csv").read().splitlines()
    assert rs == full[5:]
    assert not [p for p in os.listdir(out) if p.endswith(".prev")]


@pytest.mark.parametrize("model", ["mt", "bw"])
def test_cli_f64_is_ignored_outside_bayesrrm(small_bed, tmp_path, capsys,
                                             model):
    """Multi-trait and BayesW run float32 with an INFO line, as the JAX CLI
    passes --dtype to BayesRRm alone (hydra_tpu/runner.py:388-392)."""
    if model == "mt":
        extra = ["--pheno", small_bed + ".phen," + small_bed + ".phen"]
    else:
        extra = ["--mpibayes", "bayesWMPI", "--failure", small_bed + ".fail",
                 "--quad_points", "5"]
    assert cli.main(_argv(small_bed, tmp_path / "o", *extra,
                          "--chain-length", "3")) == 0
    assert "--dtype float64 ignored" in capsys.readouterr().out
