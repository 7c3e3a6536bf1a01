"""The port's CLI on the CPU: hydra-format outputs, a run with JAX absent,
and NotImplementedError for every path the port does not have."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hydra_tpu import postproc
from hydra_tpu.outputs.restart import read_restart
from hydra_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, N = 200, 500


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


def test_cli_runs_without_jax(bed, tmp_path):
    """The card's machine has no JAX: block it before anything imports."""
    out = tmp_path / "nojax"
    code = ("import sys; sys.modules['jax'] = None\n"
            "from hydra_tpu_torch import cli\n"
            f"sys.exit(cli.main({['--device', 'cpu', *_argv(bed, out)]!r}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "RESULT : it   10" in res.stdout
    assert len([ln for ln in open(out / "run.csv") if ln.strip()]) == 4


@pytest.mark.parametrize("extra", [
    ["--mpibayes", "bayesFHMPI"],
    ["--mpibayes", "bayesWMPI"],
    ["--restart"],
    ["--check-RAM"],
    ["--bed-to-sparse"],
    ["--window", "4"],
    ["--stale"],                     # window defaults to --sync-rate 1
    ["--dtype", "float64"],
    ["--n-devices", "2"],
    ["--cache-planes", "on"],
    ["--mega", "off"],
])
def test_cli_unsupported_paths_raise(bed, tmp_path, extra):
    with pytest.raises(NotImplementedError, match="not ported"):
        cli.main(["--device", "cpu", *_argv(bed, tmp_path / "x"), *extra])


def test_cli_covariates_and_sparse_raise(bed, tmp_path):
    cov = tmp_path / "c.cov"
    cov.write_text("ID,c1\n" + "".join(f"{i},0.5\n" for i in range(N)))
    with pytest.raises(NotImplementedError, match="covariates"):
        cli.main(["--device", "cpu", *_argv(bed, tmp_path / "x"),
                  "--covariates", str(cov)])
    with pytest.raises(NotImplementedError, match="sparse"):
        cli.main(["--device", "cpu", *_argv(bed, tmp_path / "x"),
                  "--sparse-dir", str(tmp_path), "--sparse-basename", "s"])


def test_cuda_request_without_card_raises(bed, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA path runs instead")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(_argv(bed, tmp_path / "x"))
