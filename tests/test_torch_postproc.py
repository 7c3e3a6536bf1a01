"""The port's post-processing CLI, ``python -m hydra_tpu_torch.postproc``,
against the JAX package's, ``python -m hydra_tpu.postproc``, on the outputs
of short CPU chains of the port's CLI (BayesRRm, its restart, and BayesW):
each of the nine commands prints the same bytes and exits with the same
code from both modules (``main`` under ``python -m``), ``combine-csv``
writes the same file, and ``predict`` gives the same scores on a small
PLINK panel with missing calls. The port's CLI runs with ``jax`` and
``hydra_tpu`` blocked, and the isolation scan of
tests/test_torch_isolation.py covers the new module."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.conftest import make_synthetic_bed

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, N, N_PANEL = 60, 160, 50
CHAIN = ["--S", "0.001,0.01,0.1", "--thin", "2", "--save", "4", "--seed",
         "3", "--device", "cpu"]


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """A BayesRRm chain of 12 sweeps, its restart to 20, a BayesW chain of
    8 sweeps on the same bed (with failure indicators), and a scoring
    panel of N_PANEL individuals with 5% missing calls; the paths by
    name."""
    from hydra_tpu_torch import cli

    tmp = tmp_path_factory.mktemp("postproc")
    base, geno = make_synthetic_bed(tmp, M, N, seed=4)
    rs = np.random.RandomState(5)
    x = (geno - geno.mean(axis=1, keepdims=True)) / geno.std(
        axis=1, keepdims=True)
    y = x.T @ (rs.randn(M) * (rs.random_sample(M) < 0.2)) + rs.randn(N)
    with open(base + ".phen", "w") as fh:
        fh.writelines(f"per{i} per{i} {4.0 + 0.1 * y[i]:.6f}\n"
                      for i in range(N))
    with open(base + ".fail", "w") as fh:
        fh.writelines(f"{int(f)}\n" for f in rs.random_sample(N) > 0.2)
    out = tmp / "out"
    common = ["--bfile", base, "--pheno", base + ".phen", "--mcmc-out-dir",
              str(out), *CHAIN]
    assert cli.main(["--mpibayes", "bayesMPI", *common, "--mcmc-out-name",
                     "run", "--chain-length", "12"]) == 0
    assert cli.main(["--mpibayes", "bayesMPI", *common, "--mcmc-out-name",
                     "run", "--chain-length", "20", "--restart"]) == 0
    assert cli.main(["--mpibayes", "bayesWMPI", *common, "--failure",
                     base + ".fail", "--quad_points", "7", "--mcmc-out-name",
                     "bw", "--chain-length", "8"]) == 0
    (tmp / "panel").mkdir()
    panel, _ = make_synthetic_bed(tmp / "panel", M, N_PANEL, seed=8,
                                  missing_rate=0.05)
    paths = {k: str(out / k) for k in ("run", "run_rs", "bw")}
    return dict(paths, panel=panel, tmp=tmp)


# command id -> the arguments after ``python -m <package>.postproc``, from
# the chains' paths ("{out}": the file a command writes, one a package)
COMMANDS = {
    "beta-convert": lambda p: ["beta-convert", p["run"] + ".bet", "3"],
    "cpn-convert": lambda p: ["cpn-convert", p["run"] + ".cpn", "3"],
    "eps-convert": lambda p: ["eps-convert", p["run"] + ".eps.0"],
    "extract-beta": lambda p: ["extract-beta", p["run"] + ".bet", "1", "4"],
    "extract-cpn": lambda p: ["extract-cpn", p["run"] + ".cpn", "1", "4"],
    "beta-check": lambda p: ["beta-check", p["run"] + ".bet",
                             p["bw"] + ".bet"],
    "beta-check-same": lambda p: ["beta-check", p["run"] + ".bet",
                                  p["run"] + ".bet"],
    "combine-csv": lambda p: ["combine-csv", "{out}", p["run"] + ".csv",
                              p["run_rs"] + ".csv"],
    "ess": lambda p: ["ess", p["run"] + ".csv", p["run_rs"] + ".csv",
                      "--burnin", "1"],
    "ess-bw": lambda p: ["ess", p["bw"] + ".csv"],
    "predict": lambda p: ["predict", p["run_rs"] + ".bet", "--bfile",
                          p["panel"], "--burnin", "1", "--mus",
                          p["run_rs"] + ".mus.0"],
}


def _postproc(package, argv, env=None):
    return subprocess.run([sys.executable, "-m", f"{package}.postproc",
                           *argv], cwd=REPO, capture_output=True,
                          timeout=120, env=env)


@pytest.mark.parametrize("name", list(COMMANDS))
def test_postproc_command_prints_the_jax_package_bytes(chains, name):
    argv = COMMANDS[name](chains)
    runs = {}
    for package in ("hydra_tpu", "hydra_tpu_torch"):
        out = str(chains["tmp"] / f"{name}.{package}.csv")
        runs[package] = (_postproc(package, [a.replace("{out}", out)
                                             for a in argv]), out)
    (j, j_out), (t, t_out) = runs["hydra_tpu"], runs["hydra_tpu_torch"]
    assert j.returncode == t.returncode, (j.stderr, t.stderr)
    assert t.stdout == j.stdout
    if name == "combine-csv":
        assert open(t_out, "rb").read() == open(j_out, "rb").read()
        assert len(open(t_out).readlines()) == 10          # iterations 0..18
    elif name == "beta-check":
        assert t.returncode == 1 and b"MISMATCH" in t.stdout
    else:
        assert t.returncode == 0 and t.stdout, t.stderr
    if name.startswith("ess"):
        rows = [ln.split() for ln in t.stdout.decode().splitlines()[2:]]
        assert len(rows) == 4
        assert all(np.isfinite(float(v)) for r in rows for v in r[1:])
    if name == "predict":
        assert len(t.stdout.decode().splitlines()) == N_PANEL


def test_predict_scores_equal_on_a_panel(chains, tmp_path):
    """``predict`` of both packages, called as functions: the same scores
    and the same score file, finite and not all equal."""
    from hydra_tpu import postproc as jpp
    from hydra_tpu_torch import postproc as tpp

    args = (chains["run_rs"] + ".bet", chains["panel"])
    kw = dict(burnin=1, mus_path=chains["run_rs"] + ".mus.0")
    sj = jpp.predict(*args, out_path=str(tmp_path / "j.txt"), **kw)
    st = tpp.predict(*args, out_path=str(tmp_path / "t.txt"), **kw)
    np.testing.assert_array_equal(st, sj)
    assert st.shape == (N_PANEL,) and np.all(np.isfinite(st))
    assert np.ptp(st) > 0.0
    assert ((tmp_path / "t.txt").read_bytes()
            == (tmp_path / "j.txt").read_bytes())


def test_postproc_runs_without_jax(chains):
    """The card's machine has no JAX: with ``jax`` and ``hydra_tpu``
    blocked before anything imports, the port's ``ess`` and ``predict``
    print what they print with both present."""
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['hydra_tpu'] = None\n"
            "runpy.run_module('hydra_tpu_torch.postproc', "
            "run_name='__main__')\n")
    for name in ("ess", "predict"):
        argv = COMMANDS[name](chains)
        res = subprocess.run([sys.executable, "-c", code, *argv], cwd=REPO,
                             capture_output=True, timeout=120)
        assert res.returncode == 0, res.stderr.decode()[-2000:]
        assert res.stdout == _postproc("hydra_tpu_torch", argv).stdout


def test_isolation_scan_covers_postproc():
    from tests.test_torch_isolation import _port_sources

    assert os.path.join(REPO, "hydra_tpu_torch", "postproc.py") in set(
        _port_sources())
