"""The port's CLI on the CPU: hydra-format outputs of BayesRRm (the
whole-sweep and per-window branches, windows below 8, the single-decode
stale sweep), BayesFH and BayesW, runs with JAX and the JAX package
absent (a restart with covariates among them), NotImplementedError for
what the port does not run on several devices, and the launcher named for
--n-devices without ranks. Restarts and covariates are
tests/test_torch_restart.py's; sparse input, --bed-to-sparse, --check-RAM
and the runs the port's kernel limits once refused are
tests/test_torch_host_paths.py's."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hydra_tpu import postproc
from hydra_tpu.outputs.restart import read_restart
from hydra_tpu_torch import cli

from tests.conftest import make_synthetic_bed

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, N = 200, 500
MW, NW = 40, 400          # BayesW: the CLI default W = 1 visits markers singly


@pytest.fixture
def bed(synthetic_bed_factory, tmp_path):
    base, geno = synthetic_bed_factory(M, N, seed=4)
    rs = np.random.RandomState(5)
    x = geno - geno.mean(axis=1, keepdims=True)
    beta = np.zeros(M)
    causal = rs.choice(M, 20, replace=False)
    beta[causal] = rs.randn(20) * 0.1
    y = x.T @ beta + rs.randn(N)
    with open(base + ".phen", "w") as fh:
        for i in range(N):
            fh.write(f"per{i} per{i} {y[i]:.6f}\n")
    return base


@pytest.fixture
def fh_bed(synthetic_bed_factory):
    """The bed of ``bed`` with a phenotype of h2 ~ 0.5: BayesFH's shrinkage
    zeroes the weaker signal of ``bed`` within a few sweeps (so does the
    JAX sampler's), after which every marker is excluded."""
    base, geno = synthetic_bed_factory(M, N, seed=4)
    rs = np.random.RandomState(5)
    x = geno - geno.mean(axis=1, keepdims=True)
    g = x.T @ (rs.randn(M) * (rs.random_sample(M) < 0.1))
    y = g / g.std() + rs.randn(N)
    with open(base + ".phen", "w") as fh:
        fh.writelines(f"per{i} per{i} {y[i]:.6f}\n" for i in range(N))
    return base


@pytest.fixture
def bw_bed(tmp_path):
    """Weibull log-times (alpha 8, mu 4) with 20% censoring."""
    (tmp_path / "bw").mkdir()
    base, geno = make_synthetic_bed(tmp_path / "bw", MW, NW, seed=6)
    rs = np.random.RandomState(7)
    x = (geno - geno.mean(axis=1, keepdims=True)) / geno.std(axis=1,
                                                             keepdims=True)
    beta = np.zeros(MW)
    causal = rs.choice(MW, 8, replace=False)
    beta[causal] = rs.randn(8) * 0.05
    y = 4.0 + x.T @ beta + (np.log(rs.exponential(1.0, NW)) + 0.5772) / 8.0
    fail = (rs.random_sample(NW) > 0.2).astype(int)
    with open(base + ".phen", "w") as fh:
        fh.writelines(f"per{i} per{i} {y[i]:.6f}\n" for i in range(NW))
    with open(base + ".fail", "w") as fh:
        fh.writelines(f"{f}\n" for f in fail)
    return base


def write_mt_phenos(base, n_traits, na_frac, seed):
    """T phenotype files <base>.t<k>.phen over the bed's individuals, "NA"
    for a fraction of each trait; returns their comma-joined paths."""
    rs = np.random.RandomState(seed)
    paths = []
    for t in range(n_traits):
        y = rs.randn(N) + 0.3 * t
        path = f"{base}.t{t}.phen"
        with open(path, "w") as fh:
            for i in range(N):
                v = "NA" if rs.rand() < na_frac else f"{y[i]:.6f}"
                fh.write(f"per{i} per{i} {v}\n")
        paths.append(path)
    return ",".join(paths)


def _mt_argv(base, out_dir, phen, *extra):
    return ["--mpibayes", "bayesMPI", "--bfile", base, "--pheno", phen,
            "--S", "0.001,0.01,0.1", "--chain-length", "12", "--thin", "5",
            "--save", "10", "--seed", "3", "--mcmc-out-dir", str(out_dir),
            "--mcmc-out-name", "mt", *extra]


def _bw_argv(base, out_dir, *extra):
    return ["--mpibayes", "bayesWMPI", "--bfile", base, "--pheno",
            base + ".phen", "--failure", base + ".fail", "--S",
            "0.001,0.01,0.1", "--quad_points", "7", "--chain-length", "6",
            "--thin", "2", "--save", "4", "--seed", "3", "--mcmc-out-dir",
            str(out_dir), "--mcmc-out-name", "bw", *extra]


def _argv(base, out_dir, *extra):
    return ["--mpibayes", "bayesMPI", "--bfile", base, "--pheno",
            base + ".phen", "--S", "0.001,0.01,0.1", "--chain-length", "20",
            "--thin", "5", "--save", "10", "--seed", "3", "--mcmc-out-dir",
            str(out_dir), "--mcmc-out-name", "run", *extra]


@pytest.mark.parametrize("extra", [[], ["--stale", "--window", "32"]])
def test_cli_writes_hydra_outputs(bed, tmp_path, extra):
    out = tmp_path / "out"
    assert cli.main(["--device", "cpu", *_argv(bed, out, *extra)]) == 0
    base = str(out / "run")
    rows = [ln for ln in open(base + ".csv") if ln.strip()]
    assert len(rows) == 4                       # iterations 0, 5, 10, 15
    for ext in (".bet", ".cpn"):
        with open(base + ext, "rb") as fh:
            assert int(np.frombuffer(fh.read(4), np.uint32)[0]) == M
    recs = list(postproc._read_records(base + ".bet", np.float64))
    assert [it for it, _ in recs] == [0, 5, 10, 15]
    assert all(np.isfinite(v).all() for _, v in recs)
    cpn = list(postproc._read_records(base + ".cpn", np.int32))
    assert all(((c >= 0) & (c < 4)).all() for _, c in cpn)
    h2 = postproc._parse_chain_csv(base + ".csv")["h2"]
    assert np.all((h2 > 0) & (h2 < 1))
    rd = read_restart(base, M, N, 10)
    assert rd.iteration == 10 and rd.seed == 3
    assert rd.rng_exact == (not extra) and rd.rng_schedule == "block"
    assert rd.rng_window == (64 if not extra else 32)
    assert np.isfinite(rd.eps).all() and len(rd.eps) == N


@pytest.mark.parametrize("extra", [[], ["--window", "16", "--schedule",
                                          "marker"]])
def test_cli_bayesw_writes_hydra_outputs(bw_bed, tmp_path, extra):
    out = tmp_path / "out"
    assert cli.main(["--device", "cpu", *_bw_argv(bw_bed, out, *extra)]) == 0
    base = str(out / "bw")
    rows = [ln.split(",") for ln in open(base + ".csv") if ln.strip()]
    assert [int(r[0]) for r in rows] == [0, 2, 4]
    # it, mu, sigmaG sum, alpha, h2w, m0, piRows, piCols, sigmaG[G], pi[G*K]
    mu, alpha, h2w = (np.array([float(r[i]) for r in rows]) for i in (1, 3, 4))
    assert np.all(np.abs(mu - 4.0) < 0.5) and np.all((alpha > 1) & (alpha < 50))
    assert np.all((h2w >= 0) & (h2w < 1))
    assert all(len(r) == 8 + 1 + 4 for r in rows)
    for ext, dt in ((".bet", np.float64), (".cpn", np.int32)):
        recs = list(postproc._read_records(base + ext, dt))
        assert [it for it, _ in recs] == [0, 2, 4]
        assert all(len(v) == MW and np.isfinite(v).all() for _, v in recs)
    assert all(((c >= 0) & (c < 4)).all()
               for _, c in postproc._read_records(base + ".cpn", np.int32))
    raw = np.fromfile(base + ".mrk.0", np.uint32)
    assert raw[0] == 4 and raw[1] == MW
    assert sorted(raw[2:].view(np.int32).tolist()) == list(range(MW))
    raw = open(base + ".eps.0", "rb").read()
    assert np.frombuffer(raw[:8], np.uint32).tolist() == [4, NW]
    assert np.isfinite(np.frombuffer(raw[8:], np.float64)).all()
    assert not os.path.exists(base + ".acu")          # BayesW writes no .acu


@pytest.mark.parametrize("extra,na_frac,schedule", [
    ([], 0.0, "block"),                               # sweep_exact_mt
    (["--stale", "--window", "16"], 0.1, "block"),    # sweep_stale_mt
    ([], 0.1, "marker"),                              # the per-window path
])
def test_cli_mt_writes_per_trait_outputs(bed, tmp_path, extra, na_frac,
                                         schedule, capsys):
    phen = write_mt_phenos(bed, 3, na_frac, seed=8)
    out = tmp_path / "out"
    assert cli.main(["--device", "cpu", *_mt_argv(bed, out, phen,
                                                   *extra)]) == 0
    assert "h2 per trait = [" in capsys.readouterr().out
    for t in range(3):
        base = str(out / f"mt.t{t}")
        h2 = postproc._parse_chain_csv(base + ".csv")["h2"]
        assert len(h2) == 3 and np.all((h2 > 0) & (h2 < 1))   # 0, 5, 10
        recs = list(postproc._read_records(base + ".bet", np.float64))
        assert [it for it, _ in recs] == [0, 5, 10]
        assert all(len(v) == M and np.isfinite(v).all() for _, v in recs)
        cpn = list(postproc._read_records(base + ".cpn", np.int32))
        assert all(((c >= 0) & (c < 4)).all() for _, c in cpn)
        assert os.path.exists(base + ".acu")
        rd = read_restart(base, M, N, 10)
        assert rd.iteration == 10 and rd.rng_schedule == schedule
        assert np.isfinite(rd.eps).all() and len(rd.eps) == N


@pytest.mark.parametrize("extra", [["--n-devices", "2"]])
def test_cli_mt_unsupported_paths_raise(bed, tmp_path, extra):
    """Multi-trait runs on D marker shards, one rank a device: --n-devices
    2 without a process group names the launcher and reads nothing."""
    phen = write_mt_phenos(bed, 2, 0.0, seed=1)
    with pytest.raises(ValueError, match="run_multiprocess_torch.py"):
        cli.main(["--device", "cpu", *_mt_argv(bed, tmp_path / "x", phen),
                  *extra])
    assert not list((tmp_path / "x").glob("*.csv"))


def test_cli_runs_without_jax(bed, bw_bed, tmp_path):
    """The card's machine has no JAX: block it, and the JAX package, before
    anything imports, then run BayesRRm, multi-trait BayesRRm and BayesW,
    and a BayesRRm chain with covariates cut at 10 iterations and
    restarted (``--restart``)."""
    out = tmp_path / "nojax"
    mt = _mt_argv(bed, out, write_mt_phenos(bed, 2, 0.1, seed=2))
    cov = tmp_path / "c.cov"
    rs = np.random.RandomState(6)
    cov.write_text("".join(f"per{i} per{i} {rs.randn():.5f} {rs.randn():.5f}\n"
                           for i in range(N)))
    rst = [*_argv(bed, out / "rs"), "--covariates", str(cov), "--device",
           "cpu"]
    code = ("import sys; sys.modules['jax'] = None\n"
            "sys.modules['hydra_tpu'] = None\n"
            "from hydra_tpu_torch import cli\n"
            f"assert cli.main({['--device', 'cpu', *_argv(bed, out)]!r}) == 0\n"
            f"assert cli.main({['--device', 'cpu', '--mega', 'off',
                                *_argv(bed, out / 'off')]!r}) == 0\n"
            f"assert cli.main({['--device', 'cpu', *mt]!r}) == 0\n"
            f"assert cli.main({[*rst, '--chain-length', '11']!r}) == 0\n"
            f"assert cli.main({[*rst, '--restart', '--chain-length', '21']!r})"
            " == 0\n"
            f"sys.exit(cli.main({['--device', 'cpu', *_bw_argv(bw_bed, out)]!r}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-3000:]
    assert "RESULT : it   10" in res.stdout
    assert "h2 per trait = [" in res.stdout
    assert "0. m0=" in res.stdout and "alpha=" in res.stdout
    for d in (out, out / "off"):
        assert len([ln for ln in open(d / "run.csv") if ln.strip()]) == 4
    for t in range(2):
        assert len([ln for ln in open(out / f"mt.t{t}.csv")
                    if ln.strip()]) == 3
    assert len([ln for ln in open(out / "bw.csv") if ln.strip()]) == 3
    # the restart resumed at 11 (the save at 10) and saved gamma at 20
    assert [int(ln.split(",")[0]) for ln in open(out / "rs" / "run_rs.csv")
            if ln.strip()] == [15, 20]
    raw = open(out / "rs" / "run_rs.gam.0", "rb").read()
    assert np.frombuffer(raw[:8], np.uint32).tolist() == [20, 2]


@pytest.mark.parametrize("extra,error,match", [
    (["--ind-shards", "2"], ValueError, "must divide the 1 ranks"),
    (["--dcn-slices", "2"], ValueError, "must divide the 1 ranks"),
])
def test_cli_unsupported_paths_raise(bed, tmp_path, extra, error, match):
    """--ind-shards I and --dcn-slices S run where they divide the ranks,
    so one process refuses I = 2 and S = 2. Both before any data is
    read."""
    with pytest.raises(error, match=match):
        cli.main(["--device", "cpu", *_argv(bed, tmp_path / "x"), *extra])
    assert not list((tmp_path / "x").glob("*.csv"))


@pytest.mark.parametrize("n", ["2", "4"])
def test_cli_devices_without_ranks_raise(bed, tmp_path, n):
    """--n-devices D > 1 runs one rank a device: without a process group
    the CLI names the launcher instead of running one shard."""
    with pytest.raises(ValueError, match="run_multiprocess_torch.py"):
        cli.main(["--device", "cpu", *_argv(bed, tmp_path / "x"),
                  "--n-devices", n])
    assert not (tmp_path / "x" / "run.csv").exists()


def _rng_record(base):
    with open(base + ".rng.0") as fh:
        return json.load(fh)


@pytest.mark.parametrize("kind", ["bayesw", "multi_trait"])
def test_cli_cache_planes_is_ignored_outside_bayesrrm(bed, bw_bed, tmp_path,
                                                      kind, capsys):
    """BayesW and multi-trait BayesRRm run with --cache-planes on and say
    that they ignore it, as the JAX CLI runs them (its runner passes the
    flag to single-trait BayesRRm alone)."""
    out = tmp_path / "out"
    if kind == "bayesw":
        argv, names = _bw_argv(bw_bed, out), ["bw"]
    else:
        argv = _mt_argv(bed, out, write_mt_phenos(bed, 2, 0.0, seed=9))
        names = ["mt.t0", "mt.t1"]
    assert cli.main(["--device", "cpu", *argv, "--cache-planes", "on"]) == 0
    assert "INFO   : --cache-planes on ignored" in capsys.readouterr().out
    for name in names:
        assert len([ln for ln in open(out / f"{name}.csv") if ln.strip()]) == 3
        assert _rng_record(str(out / name))["schedule"] == "block"


@pytest.mark.parametrize("cli_name", ["port", "jax"])
def test_cli_bayesw_reads_the_first_of_several_phenos(bw_bed, tmp_path,
                                                      cli_name):
    """BayesW with --pheno a,b runs on a alone, as the JAX CLI runs it (it
    sends every bayesWMPI run to run_bayesw, which reads the first file):
    the same .csv and .bet as --pheno a, in the port and in the JAX CLI."""
    from hydra_tpu import cli as jax_cli
    other = bw_bed + ".other.phen"
    rs = np.random.RandomState(11)
    with open(other, "w") as fh:
        fh.writelines(f"per{i} per{i} {4.0 + rs.randn():.6f}\n"
                      for i in range(NW))
    main = cli.main if cli_name == "port" else jax_cli.main
    pre = ["--device", "cpu"] if cli_name == "port" else []
    outs = {}
    for name, phen in (("one", bw_bed + ".phen"),
                       ("two", bw_bed + ".phen," + other)):
        argv = _bw_argv(bw_bed, tmp_path / name)
        argv[argv.index("--pheno") + 1] = phen
        assert main([*pre, *argv]) == 0
        outs[name] = {ext: open(tmp_path / name / f"bw{ext}", "rb").read()
                      for ext in (".csv", ".bet")}
    assert outs["two"] == outs["one"]
    assert len([ln for ln in outs["one"][".csv"].splitlines()
                if ln.strip()]) == 3


@pytest.mark.parametrize("window,schedule", [(4, "marker"), (8, "block")])
def test_cli_bayesw_auto_schedule_follows_jax(bw_bed, tmp_path, window,
                                              schedule):
    """--schedule auto resolves as the JAX sampler's rule: block where
    its whole-sweep kernel runs (W >= 8 or W = 1), marker for 2 <= W <= 7;
    .rng.0 records it."""
    out = tmp_path / "out"
    assert cli.main(["--device", "cpu", *_bw_argv(bw_bed, out, "--window",
                                                  str(window))]) == 0
    rng = _rng_record(str(out / "bw"))
    assert rng["schedule"] == schedule and rng["window"] == window


@pytest.mark.parametrize("extra,window,exact", [
    (["--mega", "off"], 64, True),                    # per-window, exact
    (["--mega", "off", "--stale", "--window", "64"], 64, False),
    (["--cache-planes", "on", "--stale", "--window", "64"], 64, False),
    (["--stale"], 1, False),         # window defaults to --sync-rate 1
    (["--window", "4"], 4, True),
])
def test_cli_window_paths_write_outputs(bed, tmp_path, extra, window, exact,
                                        capsys):
    """The per-window branch and windows below 8: hydra outputs, and the
    marker schedule the JAX CLI resolves for the same flags (its
    whole-sweep kernel is off: --mega off, forced planes, W < 8)."""
    out = tmp_path / "out"
    assert cli.main(["--device", "cpu", *_argv(bed, out, *extra)]) == 0
    assert ("INFO   : --cache-planes on ignored"
            not in capsys.readouterr().out)
    base = str(out / "run")
    recs = list(postproc._read_records(base + ".bet", np.float64))
    assert [it for it, _ in recs] == [0, 5, 10, 15]
    assert all(len(v) == M and np.isfinite(v).all() for _, v in recs)
    cpn = list(postproc._read_records(base + ".cpn", np.int32))
    assert all(((c >= 0) & (c < 4)).all() for _, c in cpn)
    assert any((c > 0).any() for _, c in cpn)
    h2 = postproc._parse_chain_csv(base + ".csv")["h2"]
    assert len(h2) == 4 and np.all((h2 > 0) & (h2 < 1))
    rd = read_restart(base, M, N, 10)
    assert rd.rng_schedule == "marker"
    assert rd.rng_window == window and rd.rng_exact == exact
    assert np.isfinite(rd.eps).all() and len(rd.eps) == N


@pytest.mark.parametrize("extra,sd,schedule,per_window", [
    (["--mpibayes", "bayesFHMPI"], "", "block", False),
    (["--mpibayes", "bayesFHMPI", "--stale", "--window", "32"], "", "block",
     False),
    (["--mpibayes", "bayesFHMPI", "--mega", "off", "--stale", "--window",
      "32"], "", "marker", True),
    (["--stale", "--window", "32", "--schedule", "marker"], "16", "marker",
     False),
    (["--mpibayes", "bayesFHMPI", "--stale", "--window", "32", "--schedule",
      "marker"], "16", "marker", False),
])
def test_cli_fh_and_sd_write_outputs(fh_bed, tmp_path, monkeypatch, extra,
                                     sd, schedule, per_window):
    """BayesFH on each branch and the single-decode stale sweep
    (HYDRA_TPU_SD) through the CLI: hydra outputs, the FH state in
    .fh.npz (marker order, with its iteration) and the schedule in .rng.0.
    On the CPU the wrappers run their plain versions, so no launch is
    counted; the sampler's branch is checked instead."""
    from hydra_tpu_torch import runner
    monkeypatch.setenv("HYDRA_TPU_SD", sd)
    seen = {}
    run = runner.run_bayesrrm

    def spy(opt, *a, **kw):
        res = run(opt, *a, **kw)
        seen["cfg"] = res["sampler"].cfg
        return res

    monkeypatch.setattr(runner, "run_bayesrrm", spy)
    out = tmp_path / "out"
    assert cli.main(["--device", "cpu", *_argv(fh_bed, out, *extra),
                     "--chain-length", "11"]) == 0
    cfg = seen["cfg"]
    fh = "bayesFHMPI" in extra
    assert cfg.fh == fh and cfg.sub_window == (16 if sd else 0)
    assert cfg.per_window == per_window
    base = str(out / "run")
    recs = list(postproc._read_records(base + ".bet", np.float64))
    assert [it for it, _ in recs] == [0, 5, 10]
    assert all(len(v) == M and np.isfinite(v).all() for _, v in recs)
    h2 = postproc._parse_chain_csv(base + ".csv")["h2"]
    assert len(h2) == 3 and np.all((h2 > 0) & (h2 < 1))
    rd = read_restart(base, M, N, 10)
    assert rd.rng_schedule == schedule and rd.iteration == 10
    assert os.path.exists(base + ".fh.npz") == fh
    if fh:
        st = np.load(base + ".fh.npz")
        assert sorted(st.files) == ["c_slab", "hyp_tau", "iteration",
                                    "lambda_var", "nu_var", "tau"]
        assert int(st["iteration"]) == 10
        assert st["lambda_var"].shape == st["nu_var"].shape == (M,)
        assert np.all(st["lambda_var"] > 0) and np.all(st["nu_var"] > 0)
        assert st["c_slab"].shape == (1,) and float(st["tau"]) > 0


def test_cuda_request_without_card_raises(bed, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA path runs instead")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(_argv(bed, tmp_path / "x"))
