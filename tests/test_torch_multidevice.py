"""Marker shards on torch.distributed ranks, on the CPU with gloo.

BayesRRm, BayesFH and BayesW on D = 2 and 4 ranks, one process a shard,
held against the JAX sampler on ``make_mesh(D)`` over the virtual CPU
devices: the JAX sampler's own draws (its ``_S_PERM`` permutation keyed by
each shard, u / nrm / the BayesW slot keys over all D m_loc slots) go to D
port ranks, one sweep each, and the ranks' eps and beta must agree with it
within the single-device sweep tests' tolerances, components equal, eps the
same bits on every rank. One rank under a process group is the
single-device chain bit for bit. Through the launcher
(``scripts/run_multiprocess_torch.py``) a two-rank ``--det-sync 1`` CLI
chain repeats bit for bit, and one with a rank SIGKILLed mid-chain and
``--restart``ed is byte for byte the uninterrupted one.

The file starts six multi-process launches: the sweep workers at D = 2 and
4 (this file run as a script under the launcher, every case in one
launch), two uninterrupted chains, the killed chain and its restart.
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
from run_multiprocess_torch import free_port, launch, wait_all  # noqa: E402

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)
RANK_ENV = {"OMP_NUM_THREADS": "1"}

M, N, IT, SEED = 200, 400, 3, 7
# id: (model, window, exact, cross_sync, missing_frac)
CASES = {
    "stale_w8": ("brr", 8, False, 0, 0.0),
    "stale_w8_missing": ("brr", 8, False, 0, 0.03),
    "exact_cs_w": ("brr", 8, True, 0, 0.0),
    "exact_cs_w_missing": ("brr", 8, True, 0, 0.03),
    "exact_cs4": ("brr", 8, True, 4, 0.0),
    "exact_cs4_missing": ("brr", 8, True, 4, 0.03),
    "exact_cs1": ("brr", 8, True, 1, 0.0),
    "exact_cs1_missing": ("brr", 8, True, 1, 0.03),
    "exact_w4_missing": ("brr", 4, True, 0, 0.03),
    "fh_exact": ("fh", 8, True, 0, 0.0),
    "fh_exact_missing": ("fh", 8, True, 0, 0.03),
    "bw_w8": ("bw", 8, False, 0, 0.0),
    "bw_w8_missing": ("bw", 8, False, 0, 0.03),
}
# each kind of sweep on complete data at one D and 3% missing at the other
ON_RANKS = {
    2: ("stale_w8", "exact_cs_w_missing", "exact_cs4", "exact_cs1_missing",
        "fh_exact_missing", "bw_w8_missing", "exact_w4_missing"),
    4: ("stale_w8_missing", "exact_cs_w", "exact_cs4_missing", "exact_cs1",
        "fh_exact", "bw_w8"),
}
N_SHRINK = 24
LAUNCH_TIMEOUT = 300


# ---------------------------------------------------------------- worker --
def _port_dataset(d):
    """A port Dataset from the plain arrays of a JAX one."""
    from hydra_tpu_torch.data import genotypes as tg

    geno = tg.GenotypeData(**d["geno"])
    return tg.Dataset(geno=geno, **d["rest"])


def worker(spec_path, out_dir):
    """One rank: every case's sweep with the JAX draws, saved per rank."""
    from hydra_tpu_torch.parallel import distributed
    from hydra_tpu_torch.samplers import bayesrrm, bayesw

    assert distributed.init_distributed("cpu")
    rank, world = distributed.rank(), distributed.world_size()
    with open(spec_path, "rb") as fh:
        specs = pickle.load(fh)
    for name, sp in specs.items():
        model, window, exact, cs, _ = CASES[name]
        ds = _port_dataset(sp["data"])
        if model == "bw":
            mod = bayesw
            s = bayesw.BayesW(ds, window=window, seed=SEED, quad_points=9,
                              device="cpu", n_dev=world, rank=rank)
        else:
            mod = bayesrrm
            s = bayesrrm.BayesRRm(ds, window=window, exact=exact, seed=SEED,
                                  fh=model == "fh", cross_sync=cs,
                                  device="cpu", n_dev=world, rank=rank)
        x = {k: (bayesrrm.shard_rows(v, s.cfg)
                 if v.ndim == 1 and v.shape[0] == s.cfg.m_glob else v)
             for k, v in sp["state"].items()}
        noise = {k: (tuple(torch.from_numpy(a) for a in v)
                     if isinstance(v, tuple) else torch.from_numpy(v))
                 for k, v in sp["noise"][rank].items()}
        st, stats = s.step(mod.state_from_numpy(x, "cpu"), IT, noise=noise)
        out = {f"state_{k}": v for k, v in mod.state_to_numpy(st).items()}
        out.update(cass=stats.cass.numpy(), beta_sqn=stats.beta_sqn.numpy(),
                   per_window=np.array(getattr(s.cfg, "per_window", False)),
                   cross=np.array(getattr(s.cfg, "cross", False)),
                   schedule=np.array(s.cfg.schedule))
        np.savez(os.path.join(out_dir, f"{name}.{rank}.npz"), **out)
    distributed.destroy()


# ------------------------------------------------------------- JAX side --
def _plain(ds):
    """A JAX Dataset as plain arrays (the ranks import no JAX)."""
    geno = {f.name: getattr(ds.geno, f.name)
            for f in dataclasses.fields(ds.geno)}
    rest = {f.name: getattr(ds, f.name) for f in dataclasses.fields(ds)
            if f.name != "geno"}
    return dict(geno=geno, rest=rest)


def _dataset(model, missing_frac):
    if model == "bw":
        from tests.test_torch_bayesw import _dataset as bw_dataset
        return bw_dataset(M // 2, N, 13, missing_frac, censor_frac=0.2)[0]
    from tests.test_bayesrrm import simulate
    return simulate(m=M, n=N, h2=0.5, seed=5, missing_frac=missing_frac)[0]


def _brr_noise(j, m0):
    """The JAX BayesRRm sampler's draws of iteration IT, one dict a shard
    (samplers/bayesrrm.py:252-285, 880-895)."""
    import jax
    import jax.numpy as jnp

    f32 = jnp.float32
    cfg = j.cfg
    key = jax.random.fold_in(jax.random.key(SEED), IT)

    def site(s):
        return jax.random.fold_in(key, s)

    def gamma(k, a, shape=()):
        return jax.random.gamma(k, jnp.asarray(a, f32), shape, f32)

    common = dict(mu=jax.random.normal(site(0), (), f32),
                  u=jax.random.uniform(site(1), (cfg.m_glob,), f32),
                  nrm=jax.random.normal(site(2), (cfg.m_glob,), f32))
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


def _bw_noise(j):
    """The JAX BayesW sampler's draws of iteration IT, one dict a shard:
    the slot keys over all D m_loc slots (bayesw.py:262-292)."""
    import jax
    import jax.numpy as jnp

    from hydra_tpu.utils.slice_sampler import slice_noise

    cfg = j.cfg
    key = jax.random.fold_in(jax.random.key(SEED), IT)

    def site(s):
        return jax.random.fold_in(key, s)

    keys = jax.vmap(lambda i: jax.random.fold_in(site(2), i))(
        jnp.arange(cfg.m_loc * cfg.n_dev))
    u = jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float32))(keys)
    bkeys = jax.vmap(lambda k: jax.random.fold_in(k, 1))(keys)
    le, ub, uu = jax.vmap(lambda k: slice_noise(k, (), N_SHRINK))(bkeys)
    common = {k: np.array(v) for k, v in dict(u=u, le=le, ub=ub,
                                              uu=uu).items()}
    for name, s in (("mu", 0), ("alpha", 1)):
        common[name] = tuple(np.array(v)
                             for v in slice_noise(site(s), (), N_SHRINK))
    assert cfg.schedule == "marker"
    return [dict(common, perm=np.array(jax.random.permutation(
        jax.random.fold_in(site(5), d), cfg.m_loc)))
        for d in range(cfg.n_dev)]


def _jax_case(name, n_dev):
    """(spec for the ranks, the JAX sweep's state and stats as numpy)."""
    from hydra_tpu.parallel.mesh import make_mesh
    from hydra_tpu.samplers.bayesrrm import BayesRRm as JaxBayesRRm
    from hydra_tpu.samplers.bayesw import BayesW as JaxBayesW

    model, window, exact, cs, missing = CASES[name]
    ds = _dataset(model, missing)
    if model == "bw":
        j = JaxBayesW(ds, window=window, seed=SEED, quad_points=9,
                      mesh=make_mesh(n_dev))
    else:
        j = JaxBayesRRm(ds, window=window, exact=exact, seed=SEED,
                        fh=model == "fh", cross_sync=cs,
                        mesh=make_mesh(n_dev))
    assert j.cfg.n_dev == n_dev and not j.cfg.use_mega
    s0 = j.init_state()
    state = {k: np.array(v) for k, v in s0._asdict().items()}
    s1, stats = j.step(s0, IT)
    noise = _bw_noise(j) if model == "bw" else _brr_noise(j, stats.m0)
    ref = {k: np.array(v) for k, v in s1._asdict().items()}
    ref.update(cass=np.array(stats.cass), beta_sqn=np.array(stats.beta_sqn))
    return dict(data=_plain(ds), state=state, noise=noise), ref


def _run_ranks(n_dev, tmp):
    specs, refs = {}, {}
    for name in ON_RANKS[n_dev]:
        specs[name], refs[name] = _jax_case(name, n_dev)
    spec_path = os.path.join(tmp, "spec.pkl")
    with open(spec_path, "wb") as fh:
        pickle.dump(specs, fh)
    procs = launch(n_dev, [spec_path, tmp], device="cpu", stdout_dir=tmp,
                   command=[sys.executable, os.path.abspath(__file__)],
                   env=RANK_ENV)
    codes = wait_all(procs, timeout=LAUNCH_TIMEOUT)
    logs = "".join(open(os.path.join(tmp, f"rank{r}.log")).read()[-2000:]
                   for r in range(n_dev))
    assert codes == [0] * n_dev, (codes, logs)
    ranks = {name: [dict(np.load(os.path.join(tmp, f"{name}.{r}.npz")))
                    for r in range(n_dev)] for name in specs}
    return refs, ranks


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    out = {}
    for n_dev in (2, 4):
        tmp = str(tmp_path_factory.mktemp(f"ranks{n_dev}"))
        out[n_dev] = _run_ranks(n_dev, tmp)
    return out


@pytest.mark.parametrize("n_dev,name", [(d, c) for d in ON_RANKS
                                         for c in ON_RANKS[d]])
def test_sweep_on_ranks_matches_jax_mesh(sweeps, n_dev, name):
    refs, ranks = sweeps[n_dev]
    ref, rk = refs[name], ranks[name]
    model, window, exact, cs, _ = CASES[name]
    assert all(str(r["schedule"]) == "marker" for r in rk)
    if model != "bw":
        # D > 1: the whole-sweep kernels a window a launch for W >= 8 and
        # no in-window exchange, else the per-window branch
        cross = exact and 0 < cs < window
        assert all(bool(r["cross"]) == cross for r in rk)
        assert all(bool(r["per_window"]) == (cross or window < 8)
                   for r in rk)
    # the residual is replicated: the same bits on every rank
    for r in rk[1:]:
        np.testing.assert_array_equal(r["state_eps"], rk[0]["state_eps"])
        np.testing.assert_array_equal(r["cass"], rk[0]["cass"])
    glob = {k: np.concatenate([r[f"state_{k}"] for r in rk])
            for k in ("beta", "components")}
    np.testing.assert_array_equal(glob["components"], ref["components"])
    np.testing.assert_array_equal(rk[0]["cass"], ref["cass"])
    np.testing.assert_allclose(rk[0]["state_eps"], ref["eps"], atol=5e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(glob["beta"], ref["beta"], atol=5e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(rk[0]["beta_sqn"], ref["beta_sqn"],
                               rtol=1e-3)
    np.testing.assert_allclose(rk[0]["state_mu"], ref["mu"], rtol=1e-5)
    if model == "fh":
        for k in ("lambda_var", "nu_var"):
            np.testing.assert_allclose(
                np.concatenate([r[f"state_{k}"] for r in rk]), ref[k],
                atol=5e-4, rtol=1e-3, err_msg=k)
        for k in ("tau", "hyp_tau", "c_slab", "sigma_g"):
            np.testing.assert_allclose(rk[0][f"state_{k}"], ref[k],
                                       rtol=1e-4, err_msg=k)
    assert len(np.unique(glob["components"])) >= 2


@pytest.mark.parametrize("n_dev,schedule", [(2, "block"), (4, "block"),
                                             (4, "marker")])
def test_global_slot_layout_matches_jax_mesh(n_dev, schedule):
    """Every rank builds every shard's slot_to_marker, the JAX sampler's
    on make_mesh(D) (each shard's block permutation drawn in shard order
    from one stream), from a marker blocks file too."""
    from hydra_tpu.parallel.mesh import make_mesh
    from hydra_tpu.samplers.bayesrrm import BayesRRm as JaxBayesRRm
    from hydra_tpu_torch.data.genotypes import shard_layout
    from hydra_tpu_torch.samplers.bayesrrm import global_slots

    ds = _dataset("brr", 0.0)
    # a marker blocks file: first and last marker of each rank's block
    firsts = np.array([0, 37, 90, 150][:n_dev] if n_dev == 4 else [0, 90])
    lasts = np.append(firsts[1:] - 1, ds.m - 1)
    for blocks in (None, (firsts, lasts)):
        ds = dataclasses.replace(ds, blocks=blocks)
        j = JaxBayesRRm(ds, window=16, exact=False, seed=SEED,
                        mesh=make_mesh(n_dev), schedule=schedule)
        starts, lengths, m_loc = shard_layout(ds.m, n_dev, 16, blocks)
        assert m_loc == j.cfg.m_loc
        got, _ = global_slots(starts, lengths, m_loc, schedule, SEED)
        np.testing.assert_array_equal(got, j.slot_to_marker)


@pytest.mark.cuda
@pytest.mark.parametrize("exact,missing", [(True, False), (True, True),
                                           (False, False), (False, True)])
def test_cuda_sweep_a_window_a_launch_matches_plain(exact, missing):
    """On marker shards the whole-sweep kernels run a window a launch
    (``sync``, C ``hydra_sweep_windows``): W=64, 8 windows, with an
    identity sum, against the plain version run the same way (the inputs
    and tolerances of test_torch_cuda.py::test_cuda_kernel_matches_plain);
    components equal, one launch a window (one call without ``sync``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run python chip_smoke.py there)")
    # the card tests' helpers: test files import as top-level modules
    from test_torch_cuda import _card, make_inputs
    from hydra_tpu_torch.ops import sweep_kernel as tsk

    dev = _card()
    W, m = 64, 512
    pk, eps, mask, mrow, n = make_inputs(m, 256, 7, missing, 9)
    t = [torch.from_numpy(a).to(dev) for a in (pk, eps, mrow, mask)]
    order = tsk.block_order(torch.randperm(
        m // W, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev), W)
    kw = dict(window=W, n_mix=4, complete=not missing, ind_mask=t[3],
              order=order)
    sweep = tsk.sweep_exact if exact else tsk.sweep_stale
    plain = tsk.sweep_exact_ref if exact else tsk.sweep_stale_ref
    name = "sweep_exact" if exact else "sweep_stale"
    tsk.reset_launches()
    e_k, o_k = sweep(t[0], t[1], t[2], 0.7, float(n - 1), sync=lambda d: d,
                     **kw)
    torch.cuda.synchronize()
    assert tsk.launches[name] == m // W
    e_r, o_r = plain(t[0], t[1], t[2], 0.7, float(n - 1), sync=lambda d: d,
                     **kw)
    torch.testing.assert_close(e_k, e_r, atol=5e-4, rtol=1e-3)
    torch.testing.assert_close(o_k[:, 0], o_r[:, 0], atol=5e-4, rtol=1e-3)
    assert torch.equal(o_k[:, 1], o_r[:, 1])
    tsk.reset_launches()
    sweep(t[0], t[1], t[2], 0.7, float(n - 1), **kw)
    assert tsk.launches[name] == 1


# ------------------------------------------------------------------ CLI --
CHAIN = ["--chain-length", "40", "--thin", "2", "--save", "10",
         "--seed", "42", "--S", "0.001,0.01,0.1", "--window", "16",
         "--det-sync", "1"]
OUT_FILES = ("r.csv", "r.bet", "r.cpn", "r.acu", "r.eps.0", "r.mus.0",
             "r.mrk.0", "r.xbet", "r.xcpn", "r.rng.0")


@pytest.fixture(scope="module")
def cli_bed(tmp_path_factory):
    from tests.conftest import make_synthetic_bed

    tmp = tmp_path_factory.mktemp("mdbed")
    base, geno = make_synthetic_bed(tmp, M, N, seed=9, missing_rate=0.03)
    rs = np.random.RandomState(5)
    x = np.where(geno < 0, 0, geno).astype(float)
    x -= x.mean(axis=1, keepdims=True)
    g = x.T @ (rs.randn(M) * (rs.random_sample(M) < 0.1))
    y = g / g.std() + rs.randn(N)
    with open(base + ".phen", "w") as fh:
        fh.writelines(f"per{i} per{i} {y[i]:.6f}\n" for i in range(N))
    return base


def _argv(base, out, extra=()):
    return ["--mpibayes", "bayesMPI", "--bfile", base, "--pheno",
            base + ".phen", "--mcmc-out-dir", str(out), "--mcmc-out-name",
            "r", *CHAIN, *extra]


def _launch_chain(base, out, logs, extra=()):
    return launch(2, _argv(base, out, extra), device="cpu", stdout_dir=logs,
                  env=RANK_ENV)


def _check(procs, logs):
    codes = wait_all(procs, timeout=LAUNCH_TIMEOUT)
    txt = "".join(open(os.path.join(logs, f"rank{r}.log")).read()
                  for r in range(2))
    assert codes == [0, 0], (codes, txt[-4000:])
    return txt


@pytest.fixture(scope="module")
def chains(cli_bed, tmp_path_factory):
    """Two uninterrupted two-rank chains, a third with rank 1 SIGKILLed
    once the csv passes iteration 20, and its restart."""
    tmp = tmp_path_factory.mktemp("chains")
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
    wait_all(procs, timeout=60)          # rank 0 goes with rank 1
    res["killed"] = killed
    logs = tmp / "logs_rs"
    logs.mkdir()
    res["restart_log"] = _check(
        _launch_chain(cli_bed, kil, str(logs), ("--restart",)), str(logs))
    res["k"] = kil
    return res


def test_two_rank_det_sync_chain_is_repeatable(chains):
    for f in OUT_FILES:
        assert ((chains["a"] / f).read_bytes()
                == (chains["b"] / f).read_bytes()), f
    # rank 0 alone wrote, and each rank read only its shard's .bed rows
    assert "rank   0 took" in chains["a_log"]
    assert "rank   1 took" in chains["a_log"]
    loads = [int(ln.split("load")[1].split()[0])
             for ln in chains["a_log"].splitlines() if "seconds to load" in ln]
    assert loads == [(M // 2) * (N // 4)] * 2, loads


def test_two_rank_chain_h2_within_cli_bounds(chains):
    from hydra_tpu import postproc

    h2 = postproc._parse_chain_csv(str(chains["a"] / "r.csv"))["h2"]
    assert len(h2) == 20 and np.all((h2 > 0) & (h2 < 1))


def test_kill_one_rank_then_restart_bytewise(chains):
    from soak_restart_torch import compare_runs

    assert chains["killed"], "the chain finished before the kill"
    its = compare_runs(str(chains["a"] / "r"), str(chains["k"] / "r_rs"), M)
    assert its[0] > 20 and its[-1] == 38, its


@pytest.mark.parametrize("extra", [[], ["--stale"]])
def test_one_rank_process_group_is_the_single_device_chain(
        cli_bed, tmp_path, monkeypatch, extra):
    from hydra_tpu_torch import cli

    def argv(out):
        return ["--device", "cpu", "--mpibayes", "bayesMPI", "--bfile",
                cli_bed, "--pheno", cli_bed + ".phen", "--mcmc-out-dir",
                str(tmp_path / out), "--mcmc-out-name", "r",
                "--chain-length", "12", "--thin", "2", "--save", "10",
                "--seed", "42", "--S", "0.001,0.01,0.1", "--window", "16",
                *extra]

    assert cli.main(argv("plain")) == 0
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="localhost",
                     MASTER_PORT=str(free_port())).items():
        monkeypatch.setenv(k, v)
    assert cli.main(argv("group") + ["--n-devices", "1"]) == 0
    import torch.distributed as tdist
    assert not tdist.is_initialized()            # the CLI left its group
    for f in OUT_FILES:
        assert ((tmp_path / "plain" / f).read_bytes()
                == (tmp_path / "group" / f).read_bytes()), f


if __name__ == "__main__":
    worker(sys.argv[1], sys.argv[2])
