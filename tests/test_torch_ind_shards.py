"""``--ind-shards``: a (markers x individuals) grid of torch.distributed
ranks, on the CPU with gloo.

BayesRRm, BayesFH and BayesW on the rank grids 1x2, 2x2, 1x4 (marker
shards x chunks of individuals) and two slices of 1x2 (``--dcn-slices
2``), held against the JAX sampler on ``make_mesh(D I, n_ind=I,
n_dcn=S)`` over the virtual CPU devices: the JAX sampler's own draws (its
``_S_PERM`` permutation keyed by each marker shard, u / nrm / the BayesW
slot keys over all marker slots, the covariates' order and normals) go to
the port's ranks, one sweep each. Components and component counts equal;
beta and the residual gathered from the chunks within the tolerances of
tests/test_torch_multidevice.py (atol 5e-4, rtol 1e-3; float64 atol and
rtol 1e-9); beta, components and acum the same bits on every rank of an
individual group, the residual's chunk the same bits on every rank of a
marker group and its padding 0. N = 400 and 1,500 split into chunks that
the port pads to 512 individuals (n_pad / I = 256, 128 and 768), N = 1,000
into unpadded ones (512).

Through the launcher (``scripts/run_multiprocess_torch.py``) a 2x2
``--det-sync 1`` CLI chain repeats bit for bit, and one with a rank
SIGKILLed mid-chain and ``--restart``ed is byte for byte the uninterrupted
one. ``--check-RAM --ind-shards I`` is held to the JAX estimate.

The file starts six multi-process launches: the sweep workers on two and on
four ranks (this file run as a script under the launcher; the three
four-rank grids in one launch, every case in it), two uninterrupted
chains, the killed chain and its restart.
"""

import dataclasses
import os
import pickle
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
from run_multiprocess_torch import launch, wait_all  # noqa: E402

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)
RANK_ENV = {"OMP_NUM_THREADS": "1"}

M, IT, SEED = 200, 3, 7
# name: (marker shards a slice, chunks of individuals I, slices S)
GRIDS = {"1x2": (1, 2, 1), "2x2": (2, 2, 1), "1x4": (1, 4, 1),
         "s2x1x2": (1, 2, 2)}
# id: (model, window, exact, cross_sync, missing_frac, n, dtype, covariates)
CASES = {
    "stale_w8_n1500": ("brr", 8, False, 0, 0.0, 1500, "float32", 0),
    "stale_w8_missing": ("brr", 8, False, 0, 0.03, 400, "float32", 0),
    "exact_w8": ("brr", 8, True, 0, 0.0, 400, "float32", 0),
    "exact_w8_missing": ("brr", 8, True, 0, 0.03, 400, "float32", 0),
    "exact_w8_n1000": ("brr", 8, True, 0, 0.03, 1000, "float32", 0),
    "exact_cs4": ("brr", 8, True, 4, 0.0, 400, "float32", 0),
    "exact_cs4_missing": ("brr", 8, True, 4, 0.03, 400, "float32", 0),
    "fh_cov": ("fh", 8, True, 0, 0.0, 400, "float32", 3),
    "fh_cov_missing": ("fh", 8, True, 0, 0.03, 400, "float32", 3),
    "bw_w8": ("bw", 8, False, 0, 0.0, 400, "float32", 0),
    "bw_w8_missing": ("bw", 8, False, 0, 0.03, 400, "float32", 0),
    "f64_exact": ("brr", 8, True, 0, 0.0, 400, "float64", 0),
    "f64_exact_missing": ("brr", 8, True, 0, 0.03, 400, "float64", 0),
}
# each kind of sweep on complete data on one grid and 3% missing on another
ON_GRIDS = {
    "1x2": ("stale_w8_n1500", "exact_w8_missing", "fh_cov", "bw_w8_missing",
            "f64_exact", "exact_w8_n1000"),
    "2x2": ("stale_w8_missing", "exact_w8", "exact_cs4", "exact_cs4_missing",
            "fh_cov_missing", "bw_w8", "f64_exact_missing"),
    "1x4": ("exact_w8_missing", "stale_w8_n1500"),
    "s2x1x2": ("exact_w8", "stale_w8_missing", "bw_w8_missing"),
}
LAUNCHES = {2: ("1x2",), 4: ("2x2", "1x4", "s2x1x2")}
PER_SLOT = ("beta", "components", "acum", "lambda_var", "nu_var")
LAUNCH_TIMEOUT = 300


def _ranks(grid):
    n_m, n_ind, n_dcn = GRIDS[grid]
    return n_m * n_ind * n_dcn


# ---------------------------------------------------------------- worker --
def _sweep(sp, rank, world):
    """One case's sweep on this rank of its grid with the JAX draws: its
    state, the residual gathered from the chunks, and its place."""
    from hydra_tpu_torch.samplers import bayesrrm, bayesw
    from tests.test_torch_multidevice import _port_dataset

    model, window, exact, cs, _, _, dtype, _ = CASES[sp["case"]]
    _, n_ind, n_dcn = GRIDS[sp["grid"]]
    ds = _port_dataset(sp["data"])
    kw = dict(window=window, seed=SEED, device="cpu", n_dev=world // n_ind,
              rank=rank // n_ind, n_ind=n_ind, n_dcn=n_dcn)
    if model == "bw":
        mod, s = bayesw, bayesw.BayesW(ds, quad_points=9, **kw)
    else:
        mod = bayesrrm
        s = bayesrrm.BayesRRm(ds, exact=exact, fh=model == "fh",
                              cross_sync=cs, dtype=dtype, **kw)
    x = {k: (bayesrrm.shard_rows(v, s.cfg) if k in PER_SLOT else v)
         for k, v in sp["state"].items()}
    x["eps"] = s._local(x["eps"])
    noise = {k: (tuple(torch.from_numpy(a) for a in v)
                 if isinstance(v, tuple) else torch.from_numpy(v))
             for k, v in sp["noise"][rank // n_ind].items()}
    st0 = (mod.state_from_numpy(x, "cpu") if model == "bw"
           else mod.state_from_numpy(x, "cpu", dtype=s.dt))
    st, stats = s.step(st0, IT, noise=noise)
    out = {f"state_{k}": v for k, v in mod.state_to_numpy(st).items()}
    out.update(eps_full=s.residual(st.eps).numpy(), cass=stats.cass.numpy(),
               beta_sqn=stats.beta_sqn.numpy(),
               per_window=np.array(s.cfg.per_window),
               schedule=np.array(s.cfg.schedule),
               shard=np.array(s.grid.shard), chunk=np.array(s.grid.chunk),
               n_loc=np.array(s.cfg.n_loc))
    return out


def worker(spec_path, out_dir):
    """One rank: every case of every grid of the spec, saved per rank."""
    from hydra_tpu_torch.parallel import distributed

    assert distributed.init_distributed("cpu")
    rank, world = distributed.rank(), distributed.world_size()
    with open(spec_path, "rb") as fh:
        specs = pickle.load(fh)
    for key, sp in specs.items():
        np.savez(os.path.join(out_dir, f"{key}.{rank}.npz"),
                 **_sweep(sp, rank, world))
    distributed.destroy()


# ------------------------------------------------------------- JAX side --
def _dataset(model, missing, n, n_cov):
    if model == "bw":
        from tests.test_torch_bayesw import _dataset as bw_dataset
        return bw_dataset(M // 2, n, 13, missing, censor_frac=0.2)[0]
    from tests.test_bayesrrm import simulate
    ds = simulate(m=M, n=n, h2=0.5, seed=5, missing_frac=missing)[0]
    if n_cov:
        rs = np.random.RandomState(11)
        X = rs.randn(ds.geno.n, n_cov)
        ds = dataclasses.replace(ds, X=X, y=ds.y + 0.3 * X @ rs.randn(n_cov))
    return ds


def _brr_noise(j, m0):
    """The JAX BayesRRm sampler's draws of iteration IT in its dtype, one
    dict a marker shard (samplers/bayesrrm.py:252-285, 880-924)."""
    import jax
    import jax.numpy as jnp

    cfg = j.cfg
    f = jnp.float64 if cfg.dtype == "float64" else jnp.float32
    key = jax.random.fold_in(jax.random.key(SEED), IT)

    def site(s):
        return jax.random.fold_in(key, s)

    def gamma(k, a, shape=()):
        return jax.random.gamma(k, jnp.asarray(a, f), shape, f)

    common = dict(mu=jax.random.normal(site(0), (), f),
                  u=jax.random.uniform(site(1), (cfg.m_glob,), f),
                  nrm=jax.random.normal(site(2), (cfg.m_glob,), f))
    if cfg.n_cov:
        common["covperm"] = jax.random.permutation(site(8), cfg.n_cov)
        common["cov"] = jax.random.normal(site(7), (cfg.n_cov,), f)
    if cfg.fh:
        a = np.float32(0.5 + 0.5 * cfg.v0L)
        common["g_nu"] = gamma(site(9), a, (cfg.m_glob,))
        common["g_lam"] = gamma(site(10), a, (cfg.m_glob,))
        m0 = np.asarray(m0, np.float32)
        common["fh_gamma"] = jnp.asarray([[
            gamma(jax.random.fold_in(site(13), g), 0.5 + 0.5 * cfg.v0t),
            gamma(jax.random.fold_in(site(11), g),
                  np.float32(0.5) * (m0[g] + np.float32(cfg.v0t))),
            gamma(jax.random.fold_in(site(12), g),
                  np.float32(0.5) * (np.float32(cfg.v0c) + m0[g]))]
            for g in range(cfg.num_groups)])
    assert cfg.schedule == "marker"
    out = []
    for d in range(cfg.n_dev):
        nz = dict(common, perm=jax.random.permutation(
            jax.random.fold_in(site(6), d), cfg.m_loc))
        out.append({k: np.array(v) for k, v in nz.items()})
    return out


def _jax_case(name, grid):
    """(spec for the ranks, the JAX sweep's state and stats as numpy)."""
    import jax

    from hydra_tpu.parallel.mesh import make_mesh
    from hydra_tpu.samplers.bayesrrm import BayesRRm as JaxBayesRRm
    from hydra_tpu.samplers.bayesw import BayesW as JaxBayesW
    from tests.test_torch_multidevice import _bw_noise, _plain

    model, window, exact, cs, missing, n, dtype, n_cov = CASES[name]
    n_m, n_ind, n_dcn = GRIDS[grid]
    mesh = make_mesh(_ranks(grid), n_ind=n_ind, n_dcn=n_dcn)
    ds = _dataset(model, missing, n, n_cov)
    f64 = dtype == "float64"
    if f64:
        jax.config.update("jax_enable_x64", True)
    try:
        if model == "bw":
            j = JaxBayesW(ds, window=window, seed=SEED, quad_points=9,
                          mesh=mesh)
        else:
            j = JaxBayesRRm(ds, window=window, exact=exact, seed=SEED,
                            fh=model == "fh", cross_sync=cs, dtype=dtype,
                            mesh=mesh)
        assert (j.cfg.n_dev, j.cfg.n_ind) == (n_m * n_dcn, n_ind)
        assert not j.cfg.use_mega
        s0 = j.init_state()
        state = {k: np.array(v) for k, v in s0._asdict().items()}
        s1, stats = j.step(s0, IT)
        noise = (_bw_noise(j) if model == "bw"
                 else _brr_noise(j, stats.m0))
        ref = {k: np.array(v) for k, v in s1._asdict().items()}
        ref.update(cass=np.array(stats.cass),
                   beta_sqn=np.array(stats.beta_sqn))
    finally:
        if f64:
            jax.config.update("jax_enable_x64", False)
    return (dict(case=name, grid=grid, data=_plain(ds), state=state,
                 noise=noise), ref)


def _run_ranks(n_ranks, tmp):
    specs, refs = {}, {}
    for grid in LAUNCHES[n_ranks]:
        for name in ON_GRIDS[grid]:
            key = f"{grid}.{name}"
            specs[key], refs[key] = _jax_case(name, grid)
    spec_path = os.path.join(tmp, "spec.pkl")
    with open(spec_path, "wb") as fh:
        pickle.dump(specs, fh)
    procs = launch(n_ranks, [spec_path, tmp], device="cpu", stdout_dir=tmp,
                   command=[sys.executable, os.path.abspath(__file__)],
                   env=RANK_ENV)
    codes = wait_all(procs, timeout=LAUNCH_TIMEOUT)
    logs = "".join(open(os.path.join(tmp, f"rank{r}.log")).read()[-2000:]
                   for r in range(n_ranks))
    assert codes == [0] * n_ranks, (codes, logs)
    ranks = {key: [dict(np.load(os.path.join(tmp, f"{key}.{r}.npz")))
                   for r in range(n_ranks)] for key in specs}
    return refs, ranks


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    refs, ranks = {}, {}
    for n_ranks in LAUNCHES:
        tmp = str(tmp_path_factory.mktemp(f"grid{n_ranks}"))
        r, k = _run_ranks(n_ranks, tmp)
        refs.update(r)
        ranks.update(k)
    return refs, ranks


@pytest.mark.parametrize("grid,name", [(g, c) for g in ON_GRIDS
                                       for c in ON_GRIDS[g]])
def test_sweep_on_grid_matches_jax_mesh(sweeps, grid, name):
    refs, ranks = sweeps
    ref, rk = refs[f"{grid}.{name}"], ranks[f"{grid}.{name}"]
    model, _, _, _, _, n, dtype, n_cov = CASES[name]
    _, n_ind, _ = GRIDS[grid]
    n_shards = len(rk) // n_ind
    tol = (dict(atol=1e-9, rtol=1e-9) if dtype == "float64"
           else dict(atol=5e-4, rtol=1e-3))
    # the per-window branch on the marker schedule, rank r at (r // I, r % I)
    for r, x in enumerate(rk):
        assert str(x["schedule"]) == "marker" and bool(x["per_window"])
        assert (int(x["shard"]), int(x["chunk"])) == (r // n_ind, r % n_ind)
    # the chunk's padding: n_pad / I individuals, padded to 512
    length = ref["eps"].shape[0] // n_ind
    assert int(rk[0]["n_loc"]) == -(-length // 512) * 512
    per_slot = [k for k in PER_SLOT if f"state_{k}" in rk[0]]
    for d in range(n_shards):
        group = rk[d * n_ind:(d + 1) * n_ind]      # an individual group
        for x in group[1:]:
            for k in per_slot:
                np.testing.assert_array_equal(x[f"state_{k}"],
                                              group[0][f"state_{k}"], k)
    for i in range(n_ind):
        group = rk[i::n_ind]                       # a marker group
        for x in group[1:]:
            np.testing.assert_array_equal(x["state_eps"],
                                          group[0]["state_eps"])
        assert np.all(group[0]["state_eps"][length:] == 0.0)
    for x in rk[1:]:
        np.testing.assert_array_equal(x["eps_full"], rk[0]["eps_full"])
        np.testing.assert_array_equal(x["cass"], rk[0]["cass"])
    glob = {k: np.concatenate([rk[d * n_ind][f"state_{k}"]
                               for d in range(n_shards)])
            for k in per_slot}
    np.testing.assert_array_equal(glob["components"], ref["components"])
    np.testing.assert_array_equal(rk[0]["cass"], ref["cass"])
    np.testing.assert_allclose(rk[0]["eps_full"], ref["eps"], **tol)
    assert np.all(rk[0]["eps_full"][n:] == 0.0)
    np.testing.assert_allclose(glob["beta"], ref["beta"], **tol)
    np.testing.assert_allclose(rk[0]["beta_sqn"], ref["beta_sqn"],
                               rtol=1e-3)
    np.testing.assert_allclose(rk[0]["state_mu"], ref["mu"], rtol=1e-5)
    if model == "bw":
        np.testing.assert_allclose(rk[0]["state_alpha"], ref["alpha"],
                                   rtol=1e-5)
    else:
        np.testing.assert_allclose(glob["acum"], ref["acum"], **tol)
    if n_cov:
        np.testing.assert_allclose(rk[0]["state_gamma"], ref["gamma"], **tol)
        assert np.abs(rk[0]["state_gamma"]).min() > 0.0
    if model == "fh":
        for k in ("lambda_var", "nu_var"):
            np.testing.assert_allclose(glob[k], ref[k], atol=5e-4,
                                       rtol=1e-3, err_msg=k)
        for k in ("tau", "hyp_tau", "c_slab", "sigma_g"):
            np.testing.assert_allclose(rk[0][f"state_{k}"], ref[k],
                                       rtol=1e-4, err_msg=k)
    assert len(np.unique(glob["components"])) >= 2


# ------------------------------------------------------------------ CLI --
N_CLI = 400
CHAIN = ["--chain-length", "40", "--thin", "2", "--save", "10",
         "--seed", "42", "--S", "0.001,0.01,0.1", "--window", "16",
         "--det-sync", "1", "--ind-shards", "2"]
OUT_FILES = ("r.csv", "r.bet", "r.cpn", "r.acu", "r.eps.0", "r.mus.0",
             "r.mrk.0", "r.xbet", "r.xcpn", "r.rng.0")


@pytest.fixture(scope="module")
def cli_bed(tmp_path_factory):
    from tests.conftest import make_synthetic_bed

    tmp = tmp_path_factory.mktemp("indbed")
    base, geno = make_synthetic_bed(tmp, M, N_CLI, seed=9,
                                    missing_rate=0.03)
    rs = np.random.RandomState(5)
    x = np.where(geno < 0, 0, geno).astype(float)
    x -= x.mean(axis=1, keepdims=True)
    g = x.T @ (rs.randn(M) * (rs.random_sample(M) < 0.1))
    y = g / g.std() + rs.randn(N_CLI)
    with open(base + ".phen", "w") as fh:
        fh.writelines(f"per{i} per{i} {y[i]:.6f}\n" for i in range(N_CLI))
    return base


def _argv(base, out, extra=()):
    return ["--mpibayes", "bayesMPI", "--bfile", base, "--pheno",
            base + ".phen", "--mcmc-out-dir", str(out), "--mcmc-out-name",
            "r", *CHAIN, *extra]


def _launch_chain(base, out, logs, extra=()):
    return launch(4, _argv(base, out, extra), device="cpu", stdout_dir=logs,
                  env=RANK_ENV)


def _check(procs, logs):
    codes = wait_all(procs, timeout=LAUNCH_TIMEOUT)
    txt = "".join(open(os.path.join(logs, f"rank{r}.log")).read()
                  for r in range(4))
    assert codes == [0] * 4, (codes, txt[-4000:])
    return txt


@pytest.fixture(scope="module")
def chains(cli_bed, tmp_path_factory):
    """Two uninterrupted 2x2 chains, a third with rank 1 SIGKILLed once
    the csv passes iteration 20, and its restart."""
    tmp = tmp_path_factory.mktemp("indchains")
    res = {}
    for name in ("a", "b"):
        logs = tmp / f"logs_{name}"
        logs.mkdir()
        res[name + "_log"] = _check(
            _launch_chain(cli_bed, tmp / name, str(logs)), str(logs))
        res[name] = tmp / name
    kil, logs = tmp / "killed", tmp / "logs_k"
    logs.mkdir()
    procs = _launch_chain(cli_bed, kil, str(logs))
    csv = kil / "r.csv"
    deadline, killed = time.time() + LAUNCH_TIMEOUT, False
    while time.time() < deadline and not killed:
        if all(p.poll() is not None for p in procs):
            break
        rows = (csv.read_text().strip().split("\n") if csv.exists()
                else [])
        if rows and rows[-1].strip() and int(rows[-1].split(",")[0]) >= 20:
            procs[1].kill()
            killed = True
        time.sleep(0.01)
    wait_all(procs, timeout=60)          # the other ranks go with rank 1
    res["killed"] = killed
    logs = tmp / "logs_rs"
    logs.mkdir()
    res["restart_log"] = _check(
        _launch_chain(cli_bed, kil, str(logs), ("--restart",)), str(logs))
    res["k"] = kil
    return res


def test_grid_det_sync_chain_is_repeatable(chains):
    for f in OUT_FILES:
        assert ((chains["a"] / f).read_bytes()
                == (chains["b"] / f).read_bytes()), f
    # every rank read its marker shard's .bed rows, every individual's
    # columns: two shards of M / 2 rows, each read by two ranks
    loads = [int(ln.split("load")[1].split()[0])
             for ln in chains["a_log"].splitlines() if "seconds to load" in ln]
    assert loads == [(M // 2) * (N_CLI // 4)] * 4, loads
    # the saved residual is all N individuals, gathered from the chunks
    raw = (chains["a"] / "r.eps.0").read_bytes()
    assert len(raw) == 4 + 4 + 8 * N_CLI


def test_grid_chain_h2_within_cli_bounds(chains):
    from hydra_tpu import postproc

    h2 = postproc._parse_chain_csv(str(chains["a"] / "r.csv"))["h2"]
    assert len(h2) == 20 and np.all((h2 > 0) & (h2 < 1))


def test_grid_kill_one_rank_then_restart_bytewise(chains):
    from soak_restart_torch import compare_runs

    assert chains["killed"], "the chain finished before the kill"
    its = compare_runs(str(chains["a"] / "r"), str(chains["k"] / "r_rs"), M)
    assert its[0] > 20 and its[-1] == 38, its


@pytest.mark.parametrize("n,n_ind", [(400, 2), (1000, 2), (1500, 2),
                                     (5000, 4)])
def test_check_ram_ind_shards_matches_jax(tmp_path, capsys, n, n_ind):
    """--check-RAM --ind-shards I: a device's chunk of the individuals is
    the JAX estimate's n_loc rounded up to 512, and every residual-length
    buffer of the port's estimate shrinks with it."""
    from hydra_tpu.diag import ramcheck as jram
    from hydra_tpu_torch.diag import ramcheck as tram

    want = jram.estimate_bytes(M, n, n_ind, 16, n_ind=n_ind)
    got = tram.estimate_bytes(M, n, 16, n_ind=n_ind)
    one = tram.estimate_bytes(M, n, 16)
    assert got["n_pad"] == want["n_pad"] and got["m_loc"] == want["m_loc"]
    assert got["n_loc"] == -(-want["n_loc"] // 512) * 512
    assert got["geno"] == got["m_loc"] * got["n_loc"] // 4
    if got["n_loc"] == want["n_loc"]:
        assert got["geno"] == want["geno"]
    for k in ("geno", "staging", "eps", "window_ws"):
        assert got[k] * want["n_pad"] == one[k] * got["n_loc"], k
    # the CLI on one process: no launch needed for the estimate
    from hydra_tpu_torch import cli
    bed = str(tmp_path / "none")
    assert cli.main(["--bfile", bed, "--pheno", bed + ".phen",
                     "--number-individuals", str(n), "--number-markers",
                     str(M), "--check-RAM", "--window", "16", "--device",
                     "cpu", "--ind-shards", str(n_ind)]) == 0
    assert (f"ind-shards={n_ind} ({got['n_loc']} individuals a device)"
            in capsys.readouterr().out)


if __name__ == "__main__":
    worker(sys.argv[1], sys.argv[2])
