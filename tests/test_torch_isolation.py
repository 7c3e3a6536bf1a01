"""The port stands alone: no module of ``hydra_tpu_torch`` (its
``parallel/`` package and ``native.py`` included; nor ``chip_smoke.py``,
``scripts/soak_restart_torch.py``, ``scripts/run_multiprocess_torch.py``,
``scripts/ess_certification_torch.py`` or
``scripts/profile_phases_torch.py``) imports JAX or the JAX package, nor
loads the JAX package's ``.bed`` helper library, and the port's own copies
of the option parser, readers, dataset assembly and writers behave as the
JAX package's do on the same inputs."""

import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

import hydra_tpu.data.genotypes as jgeno
import hydra_tpu.io.groups as jgroups
import hydra_tpu.io.pheno as jpheno
import hydra_tpu.io.plink as jplink
import hydra_tpu.options as jopt
import hydra_tpu.outputs.writers as jwriters
import hydra_tpu_torch.data.genotypes as tgeno
import hydra_tpu_torch.io.groups as tgroups
import hydra_tpu_torch.io.pheno as tpheno
import hydra_tpu_torch.io.plink as tplink
import hydra_tpu_torch.options as topt
import hydra_tpu_torch.outputs.writers as twriters

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_sources():
    root = os.path.join(REPO, "hydra_tpu_torch")
    for d, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")
    for script in ("soak_restart_torch.py", "run_multiprocess_torch.py",
                   "ess_certification_torch.py", "profile_phases_torch.py"):
        yield os.path.join(REPO, "scripts", script)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("hydra_tpu", "jax", "jaxlib")


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    for path in _port_sources():
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad


@pytest.mark.parametrize("argv", [
    ["--mpibayes", "bayesWMPI", "--bfile", "x", "--pheno", "x.phen",
     "--failure", "x.fail", "--quad_points", "9", "--window", "128",
     "--schedule", "marker", "--seed", "4"],
    ["--mpibayes", "bayesMPI", "--bfile", "x", "--pheno", "a.phen",
     "--groupIndexFile", "g", "--groupMixtureFile", "m", "--S", "0.1,0.2",
     "--thin", "3", "--save", "7", "--stale", "--sync-rate", "8",
     "--seed", "9"],
])
def test_parse_args_matches_jax(argv, tmp_path):
    argv = argv + ["--mcmc-out-dir", str(tmp_path)]
    assert (dataclasses.asdict(topt.parse_args(argv))
            == dataclasses.asdict(jopt.parse_args(argv)))


def test_readers_and_dataset_match_jax(synthetic_bed_factory, tmp_path):
    m, n = 30, 50
    base, _ = synthetic_bed_factory(m, n, seed=2, missing_rate=0.05)
    rs = np.random.RandomState(0)
    with open(base + ".phen", "w") as fh:
        for i in range(n):
            v = "NA" if i in (3, 17) else f"{rs.randn():.5f}"
            fh.write(f"per{i} per{i} {v}\n")
    with open(base + ".fail", "w") as fh:
        fh.writelines(f"{int(rs.rand() > 0.3)}\n" for _ in range(n))
    pt = tpheno.read_phen_fail_files(base + ".phen", base + ".fail", n)
    pj = jpheno.read_phen_fail_files(base + ".phen", base + ".fail", n)
    for name in ("y", "na_indices", "fail"):
        np.testing.assert_array_equal(getattr(pt, name), getattr(pj, name))
    np.testing.assert_array_equal(tpheno.read_failure_file(base + ".fail"),
                                  jpheno.read_failure_file(base + ".fail"))
    bt = tplink.read_bed(base + ".bed", n, m)
    np.testing.assert_array_equal(bt, jplink.read_bed(base + ".bed", n, m))
    assert tplink.read_bim(base + ".bim").snp_id == \
        jplink.read_bim(base + ".bim").snp_id
    gt = tgeno.GenotypeData.from_packed(bt, n, pt.na_indices)
    gj = jgeno.GenotypeData.from_packed(bt, n, pj.na_indices)
    for f in dataclasses.fields(gj):
        a, b = getattr(gt, f.name), getattr(gj, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f.name
    for m_tot, w in ((1000, 64), (37, 1)):
        for a, b in zip(tgeno.shard_layout(m_tot, 1, w),
                        jgeno.shard_layout(m_tot, 1, w)):
            np.testing.assert_array_equal(a, b)
    ms = tmp_path / "g.mS"
    ms.write_text("0.001,0.01;0.002,0.02")
    np.testing.assert_array_equal(tgroups.read_ms_file(str(ms)),
                                  jgroups.read_ms_file(str(ms)))


def test_read_multi_phenos_matches_jax(tmp_path):
    """The port's copy of the multi-trait phenotype reader (NaN masks)."""
    import hydra_tpu.runner as jrunner
    import hydra_tpu_torch.runner as trunner

    rs = np.random.RandomState(3)
    paths = []
    for t in range(3):
        p = tmp_path / f"t{t}.phen"
        p.write_text("".join(
            f"f{i} i{i} {'NA' if rs.rand() < 0.2 else f'{rs.randn():.6f}'}\n"
            for i in range(40)) + "\n")
        paths.append(str(p))
    argv = ["--mpibayes", "bayesMPI", "--bfile", "x", "--pheno",
            ",".join(paths), "--mcmc-out-dir", str(tmp_path)]
    got = trunner.read_multi_phenos(topt.parse_args(argv), 40)
    want = jrunner.read_multi_phenos(jopt.parse_args(argv), 40)
    assert got.shape == (3, 40) and np.isnan(got).any()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="expected 41"):
        trunner.read_multi_phenos(topt.parse_args(argv), 41)


def test_plane_lut_is_a_copy():
    """The port's copy of the plane LUT (hydra_tpu/ops/planes.py::_lut),
    and its h-packed form, which build_planes uses, against the decode."""
    import torch

    import hydra_tpu.ops.planes as jplanes
    import hydra_tpu_torch.ops.planes as tplanes
    from hydra_tpu_torch.ops.decode import decode_planes_hp

    np.testing.assert_array_equal(tplanes._lut(), jplanes._lut())
    g, _ = decode_planes_hp(torch.arange(256, dtype=torch.uint8)[:, None])
    np.testing.assert_array_equal(tplanes.hpack_lut(),
                                  g.numpy().astype(np.int8))


@pytest.mark.parametrize("survival", [False, True])
def test_writers_are_byte_identical(survival, tmp_path):
    rs = np.random.RandomState(1)
    m, n, G, K = 12, 20, 2, 4
    outs = {}
    for name, mod in (("t", twriters), ("j", jwriters)):
        base = str(tmp_path / name / "run")
        w = mod.McmcWriter(base, m, n, G, K, thin=2, save=4, seed=5,
                           survival=survival, window=16, exact=False,
                           schedule="block")
        rows = []
        r2 = np.random.RandomState(7)
        for it in (0, 2, 4):
            beta, comp = r2.randn(m), r2.randint(0, K, m).astype(np.int32)
            sg, pi = r2.rand(G), r2.dirichlet(np.ones(K), G)
            row = (w.csv_row_bw(it, 4.1, sg, 9.5, 3, pi) if survival
                   else w.csv_row_brr(it, sg, 0.7, 3, pi))
            rows.append(row)
            w.on_thin(it, beta, comp, row, 0.25,
                      acum=None if survival else r2.rand(m))
            if it == 4:
                w.on_save(it, r2.randn(n), np.arange(m, dtype=np.int32),
                          beta, comp)
        outs[name] = (base, rows)
    (bt, rows_t), (bj, rows_j) = outs["t"], outs["j"]
    assert rows_t == rows_j
    for ext in (".bet", ".cpn", ".csv", ".mus.0", ".eps.0", ".mrk.0",
                ".xbet", ".xcpn", ".rng.0") + (() if survival else (".acu",)):
        assert open(bt + ext, "rb").read() == open(bj + ext, "rb").read(), ext
    assert os.path.exists(bt + ".acu") == (not survival)


def test_port_sources_include_the_parallel_package():
    names = {os.path.relpath(p, REPO) for p in _port_sources()}
    assert {os.path.join("hydra_tpu_torch", "parallel", f)
            for f in ("distributed.py", "mesh.py")} <= names
    assert {os.path.join("hydra_tpu_torch", "native.py"),
            os.path.join("scripts", "ess_certification_torch.py"),
            os.path.join("scripts", "profile_phases_torch.py")} <= names


def test_port_loads_no_library_of_the_jax_package():
    """No source of the port names the JAX package's helper library or its
    directory; the port's own helper is built under hydra_tpu_torch."""
    bad = [os.path.relpath(p, REPO) for p in _port_sources()
           if "libbedio" in open(p).read()
           or ("hydra_tpu/native" in open(p).read()
               and not p.endswith("native.py"))]
    assert not bad, bad
    from hydra_tpu_torch.ops import _build
    assert _build.host_library_path().startswith(
        os.path.join(REPO, "hydra_tpu_torch", "_build") + os.sep)


@pytest.mark.parametrize("port,original", [
    ("hydra_tpu_torch/csrc/bedio.cpp", "hydra_tpu/native/bedio.cpp"),
    ("hydra_tpu_torch/utils/compression.py", "hydra_tpu/utils/compression.py"),
    ("hydra_tpu_torch/utils/gadgets.py", "hydra_tpu/utils/gadgets.py"),
])
def test_copied_sources_are_byte_for_byte(port, original):
    """The helper's source and the two small utilities are the JAX
    package's files, byte for byte."""
    with open(os.path.join(REPO, port), "rb") as a, \
            open(os.path.join(REPO, original), "rb") as b:
        assert a.read() == b.read()


def test_null_writer_is_a_copy():
    """Ranks other than 0 get a writer whose every method, the ones the
    runners call and any other, swallows its arguments, as the JAX
    package's; dunder lookups still fail (copy, pickle, repr stay sane)."""
    for w in (twriters.NullWriter(), jwriters.NullWriter()):
        assert w.on_thin(0, np.zeros(3), np.zeros(3), "row", 0.5) is None
        assert w.csv_row_brr(0, np.ones(1), 1.0, 3, np.ones((1, 2))) is None
        assert w.on_save(2, np.zeros(4), np.arange(3), np.zeros(3),
                         np.zeros(3), gamma=None) is None
        assert w.commit_save() is None and w.anything(1, k=2) is None
        with pytest.raises(AttributeError):
            w.__deepcopy__
    assert (sorted(vars(twriters.NullWriter)) == sorted(vars(
        jwriters.NullWriter))
        and twriters.NullWriter.__getattr__.__code__.co_code
        == jwriters.NullWriter.__getattr__.__code__.co_code)


@pytest.mark.parametrize("value", ["", "0", "8", "16", "32", "auto"])
def test_sd_sub_window_is_a_copy(value, monkeypatch):
    """The port's HYDRA_TPU_SD parse against the JAX package's where the
    JAX VMEM rule for "auto" also gives the whole window (W=32 over 128
    packed bytes); a sub-window that does not divide the window raises in
    the port (the JAX kernel asserts)."""
    import hydra_tpu.ops.sweep_kernel as jsk
    import hydra_tpu_torch.ops.sweep_kernel as tsk

    monkeypatch.setenv("HYDRA_TPU_SD", value)
    for complete in (True, False):
        assert (tsk.sd_sub_window(32, 128, complete)
                == jsk.sd_sub_window(32, 128, complete))
    monkeypatch.setenv("HYDRA_TPU_SD", "12")
    with pytest.raises(ValueError, match="must divide"):
        tsk.sd_sub_window(32, 128, True)


def test_gamma_rate_draws_are_copies(monkeypatch):
    """gamma_rate_rng and inv_gamma_rate_rng on the same standard gamma
    variates give the JAX package's values bit for bit."""
    import jax
    import jax.numpy as jnp
    import torch

    import hydra_tpu.utils.dist as jdist
    import hydra_tpu_torch.utils.dist as tdist

    z = np.array([0.37, 1.9, 4.25], np.float32)
    shape = np.array([0.5, 2.0, 6.5], np.float32)
    rate = np.array([1.0, 0.3, 7.0], np.float32)
    monkeypatch.setattr(jax.random, "gamma",
                        lambda key, a, shape=None, dtype=None: jnp.asarray(z))
    monkeypatch.setattr(tdist, "gamma_rng", lambda g, a: torch.from_numpy(z))
    key, gen = jax.random.key(0), torch.Generator()
    for jf, tf in ((jdist.gamma_rate_rng, tdist.gamma_rate_rng),
                   (jdist.inv_gamma_rate_rng, tdist.inv_gamma_rate_rng)):
        want = np.asarray(jf(key, jnp.asarray(shape), jnp.asarray(rate)))
        got = tf(gen, torch.from_numpy(shape), torch.from_numpy(rate))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("reader", ["read_phen_cov_files",
                                    "read_phen_fail_cov_files",
                                    "read_csv_covariates"])
def test_covariate_readers_match_jax(reader, tmp_path):
    """The port's copies of the three covariate readers on files with "NA"
    in the phenotype and in covariates (the joint NA drop of
    data.cpp:1615-1802), and the comma-separated file without IDs."""
    n = 40
    rs = np.random.RandomState(4)
    phen, cov, fail, csv = (str(tmp_path / f) for f in
                            ("p.phen", "c.cov", "f.fail", "c.csv"))
    with open(phen, "w") as fh:
        fh.writelines(f"f{i} i{i} {'NA' if i in (2, 9) else rs.randn()}\n"
                      for i in range(n))
    with open(cov, "w") as fh:
        for i in range(n):
            c = ["NA" if (i, k) in ((5, 1), (9, 0), (30, 2)) else
                 f"{rs.randn():.6f}" for k in range(3)]
            fh.write(f"f{i} i{i} {' '.join(c)}\n")
    with open(fail, "w") as fh:
        fh.writelines(f"{int(rs.rand() > 0.3)}\n" for _ in range(n))
    with open(csv, "w") as fh:
        fh.writelines(f"{rs.randn():.6f},{rs.randn():.6f}\n"
                      for _ in range(n))
    args = {"read_phen_cov_files": (phen, cov, n),
            "read_phen_fail_cov_files": (phen, cov, fail, n),
            "read_csv_covariates": (csv, n)}[reader]
    got, want = getattr(tpheno, reader)(*args), getattr(jpheno, reader)(*args)
    if reader == "read_csv_covariates":
        assert got.shape == (n, 2)
        np.testing.assert_array_equal(got, want)
        with pytest.raises(ValueError, match="different number"):
            tpheno.read_csv_covariates(csv, n + 1)
        return
    for name in ("y", "na_indices", "fail", "X"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if b is not None:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.na_indices.tolist() == [2, 5, 9, 30]
    assert got.X.shape == (n - 4, 3)


@pytest.mark.parametrize("survival", [False, True])
def test_covariate_writers_are_byte_identical(survival, tmp_path):
    """gamma and the covariates' order: .gam.0 / .xiv.0 (BayesRRm), the
    .gam text rows / .xiv (BayesW), byte for byte the JAX writer's."""
    m, n, F = 10, 16, 3
    files = {}
    for name, mod in (("t", twriters), ("j", jwriters)):
        base = str(tmp_path / name / "run")
        w = mod.McmcWriter(base, m, n, 1, 4, thin=2, save=4, seed=5,
                           covariates=True, survival=survival, window=8,
                           exact=True, schedule="block")
        r2 = np.random.RandomState(3)
        for it in (0, 2, 4):
            beta, comp = r2.randn(m), r2.randint(0, 4, m).astype(np.int32)
            gamma = r2.randn(F)
            row = (w.csv_row_bw(it, 4.0, r2.rand(1), 8.0, 3,
                                r2.dirichlet(np.ones(4), 1)) if survival
                   else w.csv_row_brr(it, r2.rand(1), 0.7, 3,
                                      r2.dirichlet(np.ones(4), 1)))
            text = (f"{it:5d}, " + ", ".join(f"{v:20.17f}" for v in gamma)
                    + "\n")
            if it == 4:
                w.on_save(it, r2.randn(n), np.arange(m, dtype=np.int32),
                          beta, comp, gamma=gamma,
                          x_order=np.array([2, 0, 1], np.int32))
            w.on_thin(it, beta, comp, row, 0.25,
                      acum=None if survival else r2.rand(m),
                      gamma_text=text if survival else None)
        files[name] = base
    exts = ((".gam", ".xiv") if survival else (".gam.0", ".xiv.0")) + (
        ".csv", ".bet", ".eps.0", ".xbet")
    for ext in exts:
        a = open(files["t"] + ext, "rb").read()
        assert a == open(files["j"] + ext, "rb").read(), ext
        assert a, ext
