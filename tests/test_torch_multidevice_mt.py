"""Multi-trait marker shards and ``--dcn-slices`` on torch.distributed
ranks, on the CPU with gloo.

Multi-trait BayesRRm on D = 2 and 4 ranks, one process a shard, held
against the JAX ``BayesRRmMT`` on ``make_mesh(D)`` over the virtual CPU
devices with the JAX sampler's own draws (its ``_S_PERM`` permutation keyed
by each shard, u / nrm over all D m_loc slots), one sweep each: stale and
exact windows, the whole-sweep kernels a window a launch and the
per-window path, exact with --cross-sync 4 and 1 (every shard's Gram
blocks), W = 4 (per window), 3% missing genotypes, covariates; T = 2
with NaN phenotypes in one trait where the case has them. On D = 4 ranks
in two slices
(``n_dcn=2``) BayesRRm stale and exact, BayesFH, BayesW and multi-trait
against ``make_mesh(4, n_dcn=2)``, and ``mesh.hier_sum`` against the JAX
``hier_psum``. The tolerances are those of test_torch_multidevice.py:
components and cass equal, eps and beta within atol 5e-4 / rtol 1e-3, mu
within rtol 1e-5, eps the same bits on every rank.

Through two ranks a multi-trait ``--det-sync 1`` CLI chain repeats bit for
bit and the same chain at ``--dcn-slices 2`` is the flat one byte for byte
(--det-sync sums over all ranks at any S); a ``--dcn-slices 2`` chain
without --det-sync (``hier_sum`` every window) with rank 1 SIGKILLed
mid-chain and ``--restart``ed is byte for byte the uninterrupted one.
Through four ranks in two slices the chain without --det-sync agrees with
the flat one within the sweep tolerances. One rank under a process group
is the single-device chain bit for bit.

The file starts four multi-process launches: the D = 2 sweeps with the
--det-sync and --dcn-slices chains, the D = 4 sweeps with the flat and
--dcn-slices chains, the chain to be killed, and its restart with the
repeated chain.
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

M, N, IT, SEED, T = 160, 400, 3, 7, 2
# id: (model, window, exact, cross_sync, schedule, missing genotypes,
#      NaN phenotypes in trait 0, covariates, n_dcn)
CASES = {
    "mt_stale_w8_block": ("mt", 8, False, 0, "block", 0.0, True, False, 1),
    "mt_stale_w8_missing": ("mt", 8, False, 0, "marker", 0.03, True, False,
                            1),
    "mt_exact_w8_full": ("mt", 8, True, 0, "marker", 0.0, False, False, 1),
    "mt_exact_w8_nan": ("mt", 8, True, 0, "marker", 0.0, True, False, 1),
    "mt_exact_cs4_full": ("mt", 8, True, 4, "marker", 0.0, False, False, 1),
    "mt_exact_cs4_missing": ("mt", 8, True, 4, "marker", 0.03, False, False,
                             1),
    "mt_exact_cs1_nan": ("mt", 8, True, 1, "marker", 0.0, True, False, 1),
    "mt_exact_w8_cov": ("mt", 8, True, 0, "marker", 0.0, True, True, 1),
    "mt_exact_w4_nan": ("mt", 4, True, 0, "marker", 0.0, True, False, 1),
    "dcn_brr_stale": ("brr", 8, False, 0, "marker", 0.0, False, False, 2),
    "dcn_brr_exact": ("brr", 8, True, 0, "marker", 0.03, False, False, 2),
    "dcn_fh_exact": ("fh", 8, True, 0, "marker", 0.0, False, False, 2),
    "dcn_bw_w8": ("bw", 8, False, 0, "marker", 0.0, False, False, 2),
    "dcn_mt_stale": ("mt", 8, False, 0, "marker", 0.0, True, False, 2),
}
ON_RANKS = {
    2: ("mt_stale_w8_block", "mt_exact_w8_full", "mt_exact_w8_nan",
        "mt_exact_cs4_full", "mt_exact_cs1_nan", "mt_exact_w8_cov",
        "mt_exact_cs4_missing", "mt_exact_w4_nan"),
    4: ("mt_stale_w8_block", "mt_stale_w8_missing", "mt_exact_w8_full",
        "mt_exact_w8_nan", "mt_exact_cs1_nan", "dcn_brr_stale",
        "dcn_brr_exact", "dcn_fh_exact", "dcn_bw_w8", "dcn_mt_stale"),
}
HIER_SHAPES = ((64,), (30,), (16, 2))
LAUNCH_TIMEOUT = 300


# ---------------------------------------------------------------- worker --
def _sweep(name, sp, rank, world):
    """One case's sweep on this rank, with the JAX draws: its state and
    stats as numpy, and the branch it took."""
    from hydra_tpu_torch.parallel import mesh
    from hydra_tpu_torch.samplers import bayesrrm, bayesrrm_mt, bayesw
    from tests.test_torch_multidevice import _port_dataset

    model, window, exact, cs, schedule, _, _, _, n_dcn = CASES[name]
    ds = _port_dataset(sp["data"])
    kw = dict(window=window, seed=SEED, device="cpu", n_dev=world,
              rank=rank, n_dcn=n_dcn)
    if model == "mt":
        mod = bayesrrm_mt
        s = bayesrrm_mt.BayesRRmMT(ds, sp["phenos"], exact=exact,
                                   cross_sync=cs, schedule=schedule, **kw)
        per_slot = ("beta", "components", "acum")
    elif model == "bw":
        mod = bayesw
        s = bayesw.BayesW(ds, quad_points=9, **kw)
        per_slot = ("beta", "components")
    else:
        mod = bayesrrm
        s = bayesrrm.BayesRRm(ds, exact=exact, fh=model == "fh", **kw)
        per_slot = ("beta", "components", "acum", "lambda_var", "nu_var")
    x = {k: (bayesrrm.shard_rows(v, s.cfg) if k in per_slot else v)
         for k, v in sp["state"].items()}
    noise = {k: (tuple(torch.from_numpy(a) for a in v)
                 if isinstance(v, tuple) else torch.from_numpy(v))
             for k, v in sp["noise"][rank].items()}
    st, stats = s.step(mod.state_from_numpy(x, "cpu"), IT, noise=noise)
    out = {f"state_{k}": v for k, v in mod.state_to_numpy(st).items()}
    out.update(cass=stats.cass.numpy(), beta_sqn=stats.beta_sqn.numpy(),
               per_window=np.array(getattr(s.cfg, "per_window", False)),
               cross=np.array(getattr(s.cfg, "cross", False)),
               schedule=np.array(s.cfg.schedule),
               hier=np.array(s._esum.func is mesh.hier_sum))
    return out


def worker(spec_path, out_dir):
    """One rank: every case's sweep with the JAX draws, then (D = 4)
    hier_sum on the slice grid, then the CLI runs the spec names, each
    through the CLI's body, results saved per rank."""
    from hydra_tpu_torch import cli
    from hydra_tpu_torch.options import parse_args
    from hydra_tpu_torch.parallel import distributed, mesh

    assert distributed.init_distributed("cpu")
    rank, world = distributed.rank(), distributed.world_size()
    with open(spec_path, "rb") as fh:
        spec = pickle.load(fh)
    for name, sp in spec["sweeps"].items():
        np.savez(os.path.join(out_dir, f"{name}.{rank}.npz"),
                 **_sweep(name, sp, rank, world))
    if spec.get("hier"):
        import torch.distributed as tdist
        groups = distributed.marker_grid(2)
        out = {f"grid{i}": np.array(tdist.get_process_group_ranks(g))
               for i, g in enumerate(groups)}
        for shape in HIER_SHAPES:
            v = ((torch.arange(int(np.prod(shape)), dtype=torch.float32)
                  + 1.0) * (rank + 1)).reshape(shape)
            out["x".join(map(str, shape))] = mesh.hier_sum(v, groups).numpy()
        np.savez(os.path.join(out_dir, f"hier.{rank}.npz"), **out)
    for argv in spec.get("cli", []):
        assert cli._run(parse_args(["--device", "cpu", *argv])) == 0
    distributed.destroy()


# ------------------------------------------------------------- JAX side --
def _data(name):
    """(JAX Dataset, phenos (T, N) or None) of a case."""
    from tests.test_bayesrrm_mt import simulate_mt
    from tests.test_torch_bayesrrm_mt import with_missing
    from tests.test_torch_multidevice import _dataset

    model, _, _, _, _, missing, nan, cov, _ = CASES[name]
    if model != "mt":
        return _dataset(model, missing), None
    ds, phenos, _ = simulate_mt(m=M, n=N, n_traits=T, seed=21)
    if nan:
        rs = np.random.RandomState(4)
        phenos[0, rs.choice(N, N // 10, replace=False)] = np.nan
    if missing:
        ds = with_missing(ds, missing, 6)
    if cov:
        ds = dataclasses.replace(
            ds, X=np.random.RandomState(8).randn(N, 3).astype(np.float64))
    return ds, phenos


def _mt_noise(j):
    """The JAX multi-trait sampler's draws of iteration IT, one dict a shard
    (samplers/bayesrrm_mt.py:266-291, :616-619)."""
    import jax
    import jax.numpy as jnp

    f32, cfg = jnp.float32, j.cfg
    key = jax.random.fold_in(jax.random.key(SEED), IT)

    def site(s):
        return jax.random.fold_in(key, s)

    common = dict(mu=jax.random.normal(site(0), (T,), f32),
                  u=jax.random.uniform(site(1), (cfg.m_glob, T), f32),
                  nrm=jax.random.normal(site(2), (cfg.m_glob, T), f32))
    if cfg.n_cov:
        common["covperm"] = jax.random.permutation(site(8), cfg.n_cov)
        common["cov"] = jax.random.normal(site(7), (cfg.n_cov, T), f32)
    out = []
    for d in range(cfg.n_dev):
        pkey = jax.random.fold_in(site(6), d)
        nz = dict(common)
        if cfg.schedule == "block":
            nz["wperm"] = jax.random.permutation(pkey, cfg.n_windows)
        else:
            nz["perm"] = jax.random.permutation(pkey, cfg.m_loc)
        out.append({k: np.array(v) for k, v in nz.items()})
    return out


def _jax_case(name, n_dev):
    """(spec for the ranks, the JAX sweep's state and stats as numpy) on
    make_mesh(n_dev, n_dcn=...)."""
    from hydra_tpu.parallel.mesh import make_mesh
    from hydra_tpu.samplers.bayesrrm import BayesRRm as JaxBayesRRm
    from hydra_tpu.samplers.bayesrrm_mt import BayesRRmMT as JaxBayesRRmMT
    from hydra_tpu.samplers.bayesw import BayesW as JaxBayesW
    from tests.test_torch_multidevice import _brr_noise, _bw_noise, _plain

    model, window, exact, cs, schedule, _, _, _, n_dcn = CASES[name]
    ds, phenos = _data(name)
    mesh = make_mesh(n_dev, n_dcn=n_dcn)
    if model == "mt":
        j = JaxBayesRRmMT(ds, phenos, window=window, exact=exact, seed=SEED,
                          cross_sync=cs, schedule=schedule, mesh=mesh)
    elif model == "bw":
        j = JaxBayesW(ds, window=window, seed=SEED, quad_points=9, mesh=mesh)
    else:
        j = JaxBayesRRm(ds, window=window, exact=exact, seed=SEED,
                        fh=model == "fh", mesh=mesh)
    assert j.cfg.n_dev == n_dev and j.cfg.n_dcn == n_dcn
    assert j.cfg.schedule == schedule and not j.cfg.use_mega
    s0 = j.init_state()
    state = {k: np.array(v) for k, v in s0._asdict().items()}
    s1, stats = j.step(s0, IT)
    noise = {"mt": lambda: _mt_noise(j), "bw": lambda: _bw_noise(j)}.get(
        model, lambda: _brr_noise(j, stats.m0))()
    ref = {k: np.array(v) for k, v in s1._asdict().items()}
    ref.update(cass=np.array(stats.cass), beta_sqn=np.array(stats.beta_sqn))
    return dict(data=_plain(ds), phenos=phenos, state=state,
                noise=noise), ref


def _jax_hier():
    """hier_psum over make_mesh(4, n_dcn=2) of (arange + 1) * (shard + 1)
    in every shape of HIER_SHAPES (tests/test_dcn.py's body)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from hydra_tpu.parallel.mesh import (DCN_AXIS, MARKER_AXIS, hier_psum,
                                         make_mesh)

    mesh = make_mesh(4, n_dcn=2)
    out = {}
    for shape in HIER_SHAPES:
        def f(shape=shape):
            dev = jax.lax.axis_index((DCN_AXIS, MARKER_AXIS))
            v = ((jnp.arange(int(np.prod(shape)), dtype=jnp.float32) + 1.0)
                 * (dev + 1)).reshape(shape)
            return hier_psum(v, 2)
        out["x".join(map(str, shape))] = np.asarray(jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(), out_specs=P()))())
    return out


# ------------------------------------------------------------------ CLI --
CHAIN = ["--chain-length", "40", "--thin", "2", "--save", "10",
         "--seed", "42", "--S", "0.001,0.01,0.1", "--window", "16"]
DET, DCN = ("--det-sync", "1"), ("--dcn-slices", "2")
TRAIT_FILES = ("csv", "bet", "cpn", "acu", "eps.0", "mus.0", "mrk.0",
               "rng.0")


def _mt_bed(tmp):
    """A .bed of M x N with 3% missing calls and two phenotype files, the
    second with "NA" for a tenth of the individuals."""
    from tests.conftest import make_synthetic_bed

    base, geno = make_synthetic_bed(tmp, M, N, seed=9, missing_rate=0.03)
    rs = np.random.RandomState(5)
    x = np.where(geno < 0, 0, geno).astype(float)
    x -= x.mean(axis=1, keepdims=True)
    paths = []
    for t in range(T):
        g = x.T @ (rs.randn(M) * (rs.random_sample(M) < 0.1))
        y = g / g.std() + rs.randn(N)
        na = rs.random_sample(N) < (0.1 if t else 0.0)
        path = f"{base}.t{t}.phen"
        with open(path, "w") as fh:
            fh.writelines(f"per{i} per{i} "
                          f"{'NA' if na[i] else format(y[i], '.6f')}\n"
                          for i in range(N))
        paths.append(path)
    return base, ",".join(paths)


def _argv(bed, out, extra=()):
    base, phen = bed
    return ["--mpibayes", "bayesMPI", "--bfile", base, "--pheno", phen,
            "--mcmc-out-dir", str(out), "--mcmc-out-name", "r", *CHAIN,
            *extra]


def _logs(logs, n):
    return "".join(open(os.path.join(logs, f"rank{r}.log")).read()
                   for r in range(n))


def _finish(procs, logs):
    codes = wait_all(procs, timeout=LAUNCH_TIMEOUT)
    assert codes == [0] * len(procs), (codes, _logs(logs, len(procs))[-4000:])


def _kill_rank1_at(procs, csv, at):
    """SIGKILL rank 1 once ``csv`` shows iteration ``at``; True if it did."""
    deadline = time.time() + LAUNCH_TIMEOUT
    while time.time() < deadline:
        if all(p.poll() is not None for p in procs):
            return False
        rows = ([ln for ln in open(csv) if ln.strip()]
                if os.path.exists(csv) else [])
        if rows and int(rows[-1].split(",")[0]) >= at:
            procs[1].kill()
            return True
        time.sleep(0.01)
    return False


def _worker_launch(n_dev, tmp, spec):
    spec_path = os.path.join(tmp, "spec.pkl")
    with open(spec_path, "wb") as fh:
        pickle.dump(spec, fh)
    return launch(n_dev, [spec_path, tmp], device="cpu", stdout_dir=tmp,
                  command=[sys.executable, os.path.abspath(__file__)],
                  env=RANK_ENV)


@pytest.fixture(scope="module")
def bed(tmp_path_factory):
    return _mt_bed(tmp_path_factory.mktemp("mdmt_bed"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, bed):
    """The JAX references; then at once the D = 2 sweeps with the
    --det-sync chain flat and at --dcn-slices 2 and the --dcn-slices 2
    chain without it, the D = 4 sweeps with hier_sum and the flat and
    --dcn-slices 2 chains without --det-sync, and the --dcn-slices 2 chain
    to be killed; rank 1 of the last SIGKILLed past iteration 20, then one
    launch of its restart and the --det-sync chain again."""
    tmp = tmp_path_factory.mktemp("mdmt")
    refs, dirs, procs = {}, {}, {}
    for n_dev in (2, 4):
        specs = {}
        for name in ON_RANKS[n_dev]:
            specs[name], refs[(n_dev, name)] = _jax_case(name, n_dev)
        dirs[n_dev] = str(tmp / f"ranks{n_dev}")
        os.makedirs(dirs[n_dev])
        spec = dict(sweeps=specs)
        if n_dev == 2:
            spec["cli"] = [_argv(bed, tmp / "a", DET),
                           _argv(bed, tmp / "dcn", DET + DCN),
                           _argv(bed, tmp / "dn", DCN)]
        else:
            spec["hier"] = True
            spec["cli"] = [_argv(bed, tmp / "f4"), _argv(bed, tmp / "d4", DCN)]
        procs[n_dev] = _worker_launch(n_dev, dirs[n_dev], spec)
    hier_ref = _jax_hier()
    logs_k = str(tmp / "logs_k")
    os.makedirs(logs_k)
    kil = launch(2, _argv(bed, tmp / "k", DCN), device="cpu",
                 stdout_dir=logs_k, env=RANK_ENV)
    killed = _kill_rank1_at(kil, str(tmp / "k" / "r.t1.csv"), 20)
    wait_all(kil, timeout=60)               # rank 0 goes with rank 1
    for n_dev in (2, 4):
        _finish(procs[n_dev], dirs[n_dev])
    rs_dir = str(tmp / "ranks_rs")
    os.makedirs(rs_dir)
    _finish(_worker_launch(2, rs_dir, dict(sweeps={}, cli=[
        _argv(bed, tmp / "k", DCN + ("--restart",)),
        _argv(bed, tmp / "b", DET)])),
        rs_dir)
    ranks = {(d, name): [dict(np.load(os.path.join(dirs[d],
                                                   f"{name}.{r}.npz")))
                         for r in range(d)]
             for d in (2, 4) for name in ON_RANKS[d]}
    hier = [dict(np.load(os.path.join(dirs[4], f"hier.{r}.npz")))
            for r in range(4)]
    return dict(tmp=tmp, refs=refs, ranks=ranks, hier=hier,
                hier_ref=hier_ref, killed=killed,
                log_a=_logs(dirs[2], 2), log_k=_logs(logs_k, 2))


@pytest.mark.parametrize("n_dev,name", [(d, c) for d in ON_RANKS
                                         for c in ON_RANKS[d]])
def test_sweep_on_ranks_matches_jax_mesh(runs, n_dev, name):
    ref, rk = runs["refs"][(n_dev, name)], runs["ranks"][(n_dev, name)]
    model, window, exact, cs, schedule, _, nan, _, n_dcn = CASES[name]
    assert all(str(r["schedule"]) == schedule for r in rk)
    # the residual's change goes through hier_sum on slices alone
    assert all(bool(r["hier"]) == (n_dcn > 1) for r in rk)
    if model == "mt":
        # the whole-sweep kernels a window a launch for W >= 8 unless an
        # in-window exchange (cross) or NaN / missing data sends exact
        # windows to the per-window path
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
    if model == "mt":
        # masked entries stay exactly 0 after the summed change
        assert np.all(rk[0]["state_eps"][ref["eps"] == 0.0] == 0.0)
        if nan:
            assert (ref["eps"][:N, 0] == 0.0).sum() >= N // 10
        np.testing.assert_allclose(rk[0]["state_gamma"], ref["gamma"],
                                   atol=5e-4, rtol=1e-3)
    if model == "fh":
        for k in ("lambda_var", "nu_var"):
            np.testing.assert_allclose(
                np.concatenate([r[f"state_{k}"] for r in rk]), ref[k],
                atol=5e-4, rtol=1e-3, err_msg=k)
    assert len(np.unique(glob["components"])) >= 2


def test_hier_sum_matches_hier_psum(runs):
    """hier_sum over the slice-major grid of 4 ranks in 2 slices equals the
    JAX hier_psum on make_mesh(4, n_dcn=2): 64 (8 chunks), 30 (one
    all_reduce) and a (16, 2) matrix, on every rank; the slice groups are
    {0, 1}, {2, 3} and the dcn groups {0, 2}, {1, 3}."""
    for r, h in enumerate(runs["hier"]):
        np.testing.assert_array_equal(h["grid0"], [2 * (r // 2),
                                                   2 * (r // 2) + 1])
        np.testing.assert_array_equal(h["grid1"], [r % 2, r % 2 + 2])
        for key, ref in runs["hier_ref"].items():
            np.testing.assert_array_equal(h[key], ref, err_msg=key)


def _same(a, b):
    return [f"t{t}.{ext}" for t in range(T) for ext in TRAIT_FILES
            if (a / f"r.t{t}.{ext}").read_bytes()
            != (b / f"r.t{t}.{ext}").read_bytes()]


def test_two_rank_mt_det_sync_chain_is_repeatable(runs):
    tmp = runs["tmp"]
    assert not _same(tmp / "a", tmp / "b")
    # rank 0 alone wrote, and each rank read only its shard's .bed rows
    loads = [int(ln.split("load")[1].split()[0])
             for ln in runs["log_a"].splitlines() if "seconds to load" in ln]
    assert loads[:2] == [(M // 2) * (N // 4)] * 2, loads
    assert "RESULT : it   10: h2 per trait" in runs["log_a"]


def test_two_rank_mt_chain_at_dcn_slices_is_the_flat_chain(runs):
    """Under --det-sync the residual's change is summed in rank order over
    all ranks at any --dcn-slices (as the JAX det_psum), so this shows only
    that making the slice grid changes nothing."""
    tmp = runs["tmp"]
    assert not _same(tmp / "a", tmp / "dcn")


def _records(path, dtype, width, header=4):
    """(iterations, values (records, width)) of a [header][u32 it][width
    values]* output file."""
    rec = np.dtype([("it", "<u4"), ("v", dtype, (width,))])
    raw = np.frombuffer(open(path, "rb").read()[header:], dtype=rec)
    return raw["it"], raw["v"]


def test_four_rank_mt_chain_at_dcn_slices_matches_the_flat_chain(runs):
    """Without --det-sync, four ranks in two slices sum the residual's
    change over their slice, then across slices (hier_sum, every window of
    the chain); the flat chain sums it in one all_reduce. The two orders
    round differently, so the 40-sweep chains agree within the sweep
    tolerances (components equal), not bit for bit."""
    tmp, worst = runs["tmp"], 0.0
    for t in range(T):
        a, b = tmp / "f4" / f"r.t{t}", tmp / "d4" / f"r.t{t}"
        ca = np.loadtxt(f"{a}.csv", delimiter=",", ndmin=2)
        cb = np.loadtxt(f"{b}.csv", delimiter=",", ndmin=2)
        assert ca.shape == cb.shape and ca.shape[0] == 20, ca.shape
        np.testing.assert_allclose(cb, ca, atol=5e-4, rtol=1e-3)
        for ext, dt, width, hdr in ((".bet", "<f8", M, 4),
                                    (".acu", "<f8", M, 4),
                                    (".cpn", "<i4", M, 4),
                                    (".mus.0", "<f8", 1, 0)):
            ia, va = _records(f"{a}{ext}", dt, width, hdr)
            ib, vb = _records(f"{b}{ext}", dt, width, hdr)
            np.testing.assert_array_equal(ib, ia, err_msg=ext)
            if ext == ".cpn":
                np.testing.assert_array_equal(vb, va)
            else:
                np.testing.assert_allclose(vb, va, atol=5e-4, rtol=1e-3,
                                           err_msg=ext)
                worst = max(worst, float(np.abs(vb - va).max()))
        (ea,), (eb,) = (_records(f"{x}.eps.0", "<f8", N, 4)[1]
                        for x in (a, b))
        np.testing.assert_allclose(eb, ea, atol=5e-4, rtol=1e-3)
    # the two sums are not the same bits: hier_sum ran in the chain
    assert _same(tmp / "f4", tmp / "d4") and worst > 0.0


def test_kill_one_rank_then_restart_mt_bytewise(runs):
    """A --dcn-slices 2 chain without --det-sync (hier_sum a window),
    rank 1 SIGKILLed and --restart'ed, is byte for byte the uninterrupted
    one."""
    from soak_restart_torch import compare_runs

    assert runs["killed"], "the chain finished before the kill"
    for t in range(T):
        its = compare_runs(str(runs["tmp"] / "dn" / f"r.t{t}"),
                           str(runs["tmp"] / "k" / f"r_rs.t{t}"), M)
        assert its[0] > 20 and its[-1] == 38, its


def test_one_rank_process_group_is_the_single_device_mt_chain(
        bed, tmp_path, monkeypatch):
    from hydra_tpu_torch import cli

    def argv(out):
        return ["--device", "cpu", *_argv(bed, tmp_path / out, DET),
                "--chain-length", "12"]

    assert cli.main(argv("plain")) == 0
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="localhost",
                     MASTER_PORT=str(free_port())).items():
        monkeypatch.setenv(k, v)
    assert cli.main(argv("group") + ["--n-devices", "1"]) == 0
    import torch.distributed as tdist
    assert not tdist.is_initialized()            # the CLI left its group
    assert not _same(tmp_path / "plain", tmp_path / "group")


def test_mt_cross_sync_is_ignored_with_a_line(bed, tmp_path, capsys):
    """As the JAX CLI, multi-trait runs without --cross-sync and says so."""
    from hydra_tpu_torch import cli

    argv = ["--device", "cpu", *_argv(bed, tmp_path / "cs", DET),
            "--chain-length", "3", "--cross-sync", "4"]
    assert cli.main(argv) == 0
    assert ("INFO   : --cross-sync ignored by multi-trait"
            in capsys.readouterr().out)


@pytest.mark.parametrize("extra,error,match", [
    (["--ind-shards", "2"], ValueError, "must divide the 1 ranks"),
    (["--dcn-slices", "2"], ValueError, "must divide the 1 ranks"),
    (["--dcn-slices", "0"], ValueError, "must divide"),
])
def test_refused_before_reading(tmp_path, extra, error, match):
    """An --ind-shards or a --dcn-slices that does not divide the ranks is
    refused with the reason before any data is read: the .bed and the
    phenotypes named here do not exist."""
    from hydra_tpu_torch import cli

    base = str(tmp_path / "missing")
    with pytest.raises(error, match=match):
        cli.main(["--device", "cpu", *_argv((base, base + ".a,"
                                             + base + ".b"), tmp_path / "o"),
                  *extra])


@pytest.mark.cuda
@pytest.mark.parametrize("exact,missing", [(True, False), (False, False),
                                           (False, True)])
def test_cuda_mt_sweep_a_window_a_launch_matches_plain(exact, missing):
    """On marker shards the multi-trait whole-sweep kernels run a window a
    launch (``sync``, C ``hydra_sweep_windows_mt``): T=4, W=64, 8 windows,
    with an identity sum, against the plain version run the same way (the
    inputs of test_torch_cuda.py::test_cuda_mt_sweep_matches_plain; NaN
    phenotypes in the stale cases); components equal, one launch a window
    (one call without ``sync``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run python chip_smoke.py there)")
    # the card tests' helpers: test files import as top-level modules
    from test_torch_cuda import _card, make_mt_inputs
    from hydra_tpu_torch.ops import sweep_kernel as tsk
    from hydra_tpu_torch.ops import sweep_kernel_mt as tmk

    dev = _card()
    W, m, Tn = 64, 512, 4
    pk, eps, tm, mrow, dnm1 = (torch.from_numpy(a).to(dev) for a in
                               make_mt_inputs(m, 256, Tn, 7, missing, 9,
                                              0.0 if exact else 0.1,
                                              shared_stats=exact))
    args = (pk, eps, tm, mrow,
            torch.tensor([0.6, 0.7, 0.8, 0.9], device=dev), dnm1)
    order = tsk.block_order(torch.randperm(
        m // W, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev), W)
    kw = dict(window=W, n_mix=4, order=order)
    if exact:
        sweep, plain, name = (tmk.sweep_exact_mt, tmk.sweep_exact_mt_ref,
                              "sweep_exact_mt")
    else:
        kw["complete"] = not missing
        sweep, plain, name = (tmk.sweep_stale_mt, tmk.sweep_stale_mt_ref,
                              "sweep_stale_mt")
    tmk.reset_launches()
    e_k, o_k = sweep(*args, sync=lambda d: d, **kw)
    torch.cuda.synchronize()
    assert tmk.launches[name] == m // W
    e_r, o_r = plain(*args, sync=lambda d: d, **kw)
    torch.testing.assert_close(e_k, e_r, atol=5e-4, rtol=1e-3)
    torch.testing.assert_close(o_k[:, :Tn], o_r[:, :Tn], atol=5e-4,
                               rtol=1e-3)
    assert torch.equal(o_k[:, Tn:2 * Tn], o_r[:, Tn:2 * Tn])
    assert torch.all(e_k[tm == 0.0] == 0.0)
    tmk.reset_launches()
    sweep(*args, **kw)
    assert tmk.launches[name] == 1


if __name__ == "__main__":
    worker(sys.argv[1], sys.argv[2])
