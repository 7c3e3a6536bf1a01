"""The port's host-side paths against the JAX package (CPU): the sparse
genotype files (``io/sparse.py``, ``--bed-to-sparse``), sparse input to a
chain, ``--check-RAM`` (``diag/ramcheck.py``), the runs the port's kernel
limits once refused (W > 1024, K > 16, T > 16), and the schedule each new CLI path records (.rng.0)
beside the JAX CLI's under the same explicit ``--schedule``."""

import json
import os

import numpy as np
import pytest
import torch

from hydra_tpu import cli as jcli
from hydra_tpu.data import genotypes as jgeno
from hydra_tpu.diag import ramcheck as jram
from hydra_tpu.io import sparse as jsparse
from hydra_tpu.io.pheno import PhenoData
from hydra_tpu_torch import cli
from hydra_tpu_torch.data import genotypes as tgeno
from hydra_tpu_torch.diag import ramcheck as tram
from hydra_tpu_torch.io import sparse as tsparse
from hydra_tpu_torch.options import parse_args

torch.set_num_threads(1)

M, N = 150, 333
SPARSE_EXTS = ("ss1", "ss2", "ssm", "sl1", "sl2", "slm", "si1", "si2", "sim",
               "dim")


@pytest.fixture
def bed(tmp_path):
    """A .bed with 4% missing calls, a phenotype, failures and two more
    traits."""
    from hydra_tpu_torch.io.plink import write_bed
    rs = np.random.RandomState(3)
    p = rs.uniform(0.05, 0.5, (M, 1))
    g = ((rs.random_sample((M, N)) < p).astype(np.int64)
         + (rs.random_sample((M, N)) < p))
    g[rs.random_sample(g.shape) < 0.04] = -1
    base = str(tmp_path / "g")
    write_bed(base + ".bed", g)
    with open(base + ".fam", "w") as fh:
        fh.writelines(f"f{i} i{i} 0 0 0 -9\n" for i in range(N))
    with open(base + ".bim", "w") as fh:
        fh.writelines(f"1 rs{j} 0 {j + 1} A C\n" for j in range(M))
    for name, y in (("phen", rs.randn(N)), ("t1.phen", rs.randn(N)),
                    ("wphen", 4.0 + 0.1 * rs.randn(N))):
        with open(f"{base}.{name}", "w") as fh:
            fh.writelines(f"f{i} i{i} {y[i]:.6f}\n" for i in range(N))
    with open(base + ".fail", "w") as fh:
        fh.writelines(f"{int(v)}\n" for v in rs.random_sample(N) < 0.8)
    return base


def _sparse(tmp_path, mod, name, bed, block):
    out = str(tmp_path / name / "s")
    os.makedirs(os.path.dirname(out))
    mod.write_sparse_files(bed + ".bed", N, M, out, block_size=block)
    return out


def test_sparse_files_match_jax(bed, tmp_path):
    """The converter writes the JAX package's bytes (blocks of 64 and 7
    markers), and both readers rebuild the .bed's packed bytes."""
    from hydra_tpu_torch.io.plink import read_bed
    j = _sparse(tmp_path, jsparse, "j", bed, 64)
    for block in (64, 7):
        t = _sparse(tmp_path, tsparse, f"t{block}", bed, block)
        for ext in SPARSE_EXTS:
            assert (open(f"{t}.{ext}", "rb").read()
                    == open(f"{j}.{ext}", "rb").read()), ext
    sp_t, sp_j = tsparse.read_sparse_files(t), jsparse.read_sparse_files(j)
    packed = tsparse.sparse_to_packed_bed(sp_t)
    np.testing.assert_array_equal(packed, jsparse.sparse_to_packed_bed(sp_j))
    np.testing.assert_array_equal(packed, read_bed(bed + ".bed", N, M))
    # a slice of markers
    part = tsparse.read_sparse_files(t, marker_start=20, marker_count=30)
    np.testing.assert_array_equal(tsparse.sparse_to_packed_bed(part),
                                  packed[20:50])


def test_sparse_dataset_matches_jax(bed, tmp_path):
    """load_dataset from sparse files (and from both sources) gives the JAX
    Dataset's packed bytes and marker statistics."""
    s = _sparse(tmp_path, tsparse, "t", bed, 64)
    na = np.array([3, 40], np.int64)
    ph = PhenoData(y=np.random.RandomState(1).randn(N - 2), na_indices=na)
    t = tgeno.load_dataset("", ph, sparse_basename=s)
    j = jgeno.load_dataset(sparse_basename=s, pheno=ph)
    both = tgeno.load_dataset(bed, ph, sparse_basename=s)
    for name in ("packed", "mave", "mstd", "msd", "nm"):
        want = getattr(j.geno, name)
        np.testing.assert_array_equal(getattr(t.geno, name), want, name)
        np.testing.assert_array_equal(getattr(both.geno, name), want, name)
    assert (t.geno.n, t.geno.n_pad, t.m) == (j.geno.n, j.geno.n_pad, j.m)


def _argv(bed, out, *extra):
    return ["--device", "cpu", "--mpibayes", "bayesMPI", "--bfile", bed,
            "--pheno", bed + ".phen", "--S", "0.001,0.01,0.1",
            "--chain-length", "9", "--thin", "2", "--save", "4", "--seed",
            "3", "--mcmc-out-dir", str(out), "--mcmc-out-name", "run",
            *extra]


@pytest.mark.parametrize("extra", [[], ["--stale", "--window", "16"]])
def test_cli_sparse_run_is_the_bed_run(bed, tmp_path, extra):
    """--bed-to-sparse, then a chain from the sparse files alone: its csv
    and .bet are the .bed chain's, byte for byte."""
    sd = tmp_path / "sp"
    sd.mkdir()
    assert cli.main(["--bfile", bed, "--bed-to-sparse", "--sparse-dir",
                     str(sd), "--sparse-basename", "g"]) == 0
    assert cli.main(_argv(bed, tmp_path / "a", *extra)) == 0
    argv = _argv(bed, tmp_path / "b", *extra)
    i = argv.index("--bfile")
    argv[i:i + 2] = ["--sparse-dir", str(sd), "--sparse-basename", "g"]
    assert cli.main(argv) == 0
    for ext in (".csv", ".bet", ".cpn", ".xbet"):
        assert (open(tmp_path / "a" / f"run{ext}", "rb").read()
                == open(tmp_path / "b" / f"run{ext}", "rb").read()), ext


def test_cli_bed_to_sparse_matches_jax_cli(bed, tmp_path):
    for name, main in (("t", cli.main), ("j", jcli.main)):
        (tmp_path / name).mkdir()
        assert main(["--bfile", bed, "--bed-to-sparse", "--sparse-dir",
                     str(tmp_path / name), "--sparse-basename", "s",
                     "--blocks-per-rank", "3"]) == 0
    for ext in SPARSE_EXTS:
        assert (open(tmp_path / "t" / f"s.{ext}", "rb").read()
                == open(tmp_path / "j" / f"s.{ext}", "rb").read()), ext


@pytest.mark.parametrize("window,exact", [(1, False), (64, True),
                                          (1024, False)])
def test_check_ram_matches_jax_fields(bed, window, exact, capsys):
    """--check-RAM: the JAX estimate's fields, the same packed layout (geno,
    m_loc, n_pad), every part counted, and the budget of the device
    (--device cpu: the host's memory)."""
    opt = parse_args(_argv(bed, "x", "--check-RAM", "--window", str(window),
                           *([] if exact else ["--stale"])))
    est = tram.check_ram_usage(opt)
    want = jram.estimate_bytes(M, N, 1, window)
    assert set(want) <= set(est)
    for k in ("geno", "m_loc", "n_pad", "n_loc"):
        assert est[k] == want[k], k
    assert est["total"] == sum(est[k] for k in (
        "geno", "staging", "eps", "marker_state", "window_ws", "gram"))
    assert est["budget"] == os.sysconf("SC_PAGE_SIZE") * os.sysconf(
        "SC_PHYS_PAGES")
    assert "device memory estimate" in capsys.readouterr().out
    assert cli.main(_argv(bed, "x", "--check-RAM")) == 0


def test_check_ram_sparse_matches_jax(bed, tmp_path):
    s = _sparse(tmp_path, tsparse, "t", bed, 64)
    argv = ["--sparse-dir", os.path.dirname(s), "--sparse-basename", "s",
            "--check-RAM", "--check-RAM-tasks", "5",
            "--check-RAM-tasks-per-node", "2", "--pheno", bed + ".phen"]
    from hydra_tpu.options import parse_args as jparse
    assert tram.check_ram_usage(parse_args(argv)) == jram.check_ram_usage(
        jparse(argv))


@pytest.mark.parametrize("extra,what", [
    (["--window", "1025"], "--window 1025"),
    (["--S", ",".join(f"{0.001 * (i + 1):g}" for i in range(16))],
     "17 mixture components"),
    (["--pheno", "17 traits"], "17 traits"),
])
def test_port_limits_refused_before_reading(bed, tmp_path, extra, what):
    """What the port once refused before reading any data (W > 1024, K >
    16, T > 16) now runs, as in the JAX package: the same argv on the
    small .bed through both CLIs under the same explicit --schedule (each
    CLI resolves auto by its own backend), exit 0, the same records
    (.rng.0: seed,
    iteration, window, exact, schedule; the csv's iteration column; the
    .bet header), and the port's csv h2 in (0, 1)."""
    if what == "17 traits":
        extra = ["--pheno", ",".join(
            bed + (".phen" if i % 2 == 0 else ".t1.phen") for i in range(17))]
    recs = []
    for name, main in (("t", cli.main), ("j", jcli.main)):
        argv = _argv(bed, tmp_path / name, *extra, "--chain-length", "5",
                     "--thin", "1", "--schedule", "marker")
        assert main(argv) == 0, what
        base = tmp_path / name / ("run.t16" if what == "17 traits" else "run")
        rec = json.load(open(f"{base}.rng.0"))
        rec.pop("hypers", None)
        rows = [ln.split(",") for ln in open(f"{base}.csv") if ln.strip()]
        header = np.fromfile(f"{base}.bet", dtype=np.uint32, count=1)
        recs.append((rec, [r[0] for r in rows], int(header[0])))
        if name == "t":
            h2 = [float(r[3 + int(r[1])]) for r in rows]
            assert all(0.0 < v < 1.0 for v in h2), h2
    assert recs[0] == recs[1]
    assert recs[0][2] == M and len(recs[0][1]) == 5


CLI_PATHS = {
    "mt_stale_w1": ["--pheno", "{b}.phen,{b}.t1.phen", "--stale"],
    "mt_exact_w4": ["--pheno", "{b}.phen,{b}.t1.phen", "--window", "4"],
    "mt_mega_off": ["--pheno", "{b}.phen,{b}.t1.phen", "--stale",
                    "--window", "16", "--mega", "off"],
    "bw_mega_off": ["--mpibayes", "bayesWMPI", "--pheno", "{b}.wphen",
                    "--failure", "{b}.fail", "--quad_points", "5",
                    "--window", "16", "--mega", "off"],
    "f64_stale": ["--dtype", "float64", "--stale", "--window", "16"],
}


@pytest.mark.parametrize("path", list(CLI_PATHS))
def test_cli_new_paths_record_the_jax_schedule(bed, tmp_path, path):
    """Each new path through both CLIs under --schedule marker: the same
    .rng.0 (seed, iteration, window, exact, schedule). The JAX CLI's
    float64 run needs jax_enable_x64, restored afterwards."""
    import jax
    x64 = path.startswith("f64")
    extra = [a.format(b=bed) for a in CLI_PATHS[path]] + ["--schedule",
                                                          "marker"]
    recs = []
    for name, main in (("t", cli.main), ("j", jcli.main)):
        argv = _argv(bed, tmp_path / name, *extra, "--chain-length", "5")
        jax.config.update("jax_enable_x64", x64 and name == "j")
        try:
            assert main(argv) == 0
        finally:
            jax.config.update("jax_enable_x64", False)
        base = tmp_path / name / ("run.t0" if path.startswith("mt")
                                  else "run")
        rec = json.load(open(f"{base}.rng.0"))
        rec.pop("hypers", None)
        recs.append(rec)
    assert recs[0] == recs[1]
    assert recs[0]["schedule"] == "marker" and recs[0]["iteration"] == 4
