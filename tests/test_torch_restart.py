"""``--restart`` of the port against the JAX package, and the port's CLI
restarts byte for byte (CPU).

- ``outputs/restart.py::read_restart`` and its port copy give equal
  RestartData on the same files, written by the JAX CLI and by the port's
  CLI, for BayesRRm, BayesFH, BayesW and multi-trait, all with covariates;
- each sampler's ``init_state_from_restart`` gives the JAX sampler's state
  from the same RestartData (multi-trait: the JAX runner's per-trait
  rebuild, hydra_tpu/runner.py:190-232, with gamma, which the JAX runner
  never restores);
- ``apply_restart_rng`` takes the saved seed, window and schedule as the
  JAX runner's does, with the same lines;
- a port-CLI run cut short and restarted writes every record after the
  restart byte for byte as the uninterrupted run (csv rows, .bet, .cpn,
  .acu, .mus.0, gamma, the last .eps.0), for each sampler, and so does a
  run SIGKILLed mid-chain (scripts/soak_restart_torch.py);
- restarting from iteration 0 is refused with the JAX message.
"""

import contextlib
import dataclasses
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hydra_tpu import cli as jax_cli
from hydra_tpu import runner as jrunner
from hydra_tpu.options import parse_args as jparse
from hydra_tpu.outputs import restart as jrestart
from hydra_tpu.parallel.mesh import make_mesh
from hydra_tpu.samplers.bayesrrm import BayesRRm as JaxBayesRRm
from hydra_tpu.samplers.bayesrrm_mt import BayesRRmMT as JaxBayesRRmMT
from hydra_tpu.samplers.bayesw import BayesW as JaxBayesW
from hydra_tpu_torch import cli
from hydra_tpu_torch import runner as trunner
from hydra_tpu_torch.options import parse_args as tparse
from hydra_tpu_torch.outputs import restart as trestart
from hydra_tpu_torch.samplers import bayesrrm as tbrr
from hydra_tpu_torch.samplers import bayesrrm_mt as tmt
from hydra_tpu_torch.samplers import bayesw as tbw
from scripts import soak_restart_torch as soak

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, N, F, T = 120, 300, 3, 2
MW = 40                       # BayesW: the CLI default W = 1 visits markers singly
MODELS = ("brr", "fh", "bw", "mt")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """soak_restart_torch's inputs: M x N (BayesW: MW x N) with F
    covariates, "NA" in some, and T multi-trait phenotypes."""
    d = tmp_path_factory.mktemp("restart_inputs")
    base, wbase = str(d / "b"), str(d / "w")
    soak.write_inputs(base, M, N, seed=5, n_cov=F, n_traits=T)
    soak.write_inputs(wbase, MW, N, seed=6, n_cov=F, n_traits=0)
    return dict(brr=base, fh=base, mt=base, bw=wbase)


def _m(model):
    return MW if model == "bw" else M


def _n(model):
    """Individuals kept: the single-trait readers drop every 37th, "NA" in
    its first covariate; multi-trait reads its covariates for all N."""
    return N if model == "mt" else N - N // 37


def _argv(inputs, model, out, name, iters, **kw):
    return soak.cli_argv(inputs[model], model, str(out), name, iters,
                         device="", thin=2, save=4, n_cov=F,
                         n_traits=T if model == "mt" else 0, **kw)


def _bases(out, name, model):
    sfx = [f".t{t}" for t in range(T)] if model == "mt" else [""]
    return [os.path.join(str(out), name + s) for s in sfx]


def _read(mod, base, model):
    return mod.read_restart(base, _m(model), _n(model), 4, covariates=True,
                            survival=model == "bw")


def _assert_restart_equal(a, b):
    assert [f.name for f in dataclasses.fields(a)] == \
        [f.name for f in dataclasses.fields(b)]
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, dict):
            assert sorted(x) == sorted(y), f.name
            for k in y:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
        elif isinstance(y, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("model", MODELS)
def test_read_restart_matches_jax(inputs, tmp_path, writer, model):
    """Both readers on the same files: gamma from .gam.0 (BayesW: the .gam
    row of the restart iteration), .xiv(.0), .fh.npz for BayesFH."""
    argv = _argv(inputs, model, tmp_path, "run", 10, seed=3)
    if writer == "jax":
        assert jax_cli.main(argv + ["--n-devices", "1"]) == 0
    else:
        assert cli.main(argv + ["--device", "cpu"]) == 0
    for base in _bases(tmp_path, "run", model):
        got, want = _read(trestart, base, model), _read(jrestart, base, model)
        _assert_restart_equal(got, want)
        assert got.iteration == 8 and got.start_iteration == 9
        assert got.gamma is not None and got.gamma.shape == (F,)
        assert (got.fh_state is not None) == (model == "fh")
        if model != "mt":
            assert got.x_order is not None and sorted(got.x_order) == [0, 1, 2]


@pytest.mark.parametrize("model", MODELS)
def test_init_state_from_restart_matches_jax(inputs, tmp_path, model):
    """The port's restart state from the port's RestartData equals the JAX
    sampler's from the JAX RestartData of the same files (FH state, gamma
    and the slot layout included)."""
    argv = _argv(inputs, model, tmp_path, "run", 10, seed=3)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    topt, jopt = tparse(argv + ["--device", "cpu"]), jparse(argv)
    if model == "mt":
        ds_t, ph = trunner.mt_dataset_from_options(topt)
        t = tmt.BayesRRmMT(ds_t, ph, window=topt.window, exact=topt.exact,
                           seed=3, device="cpu")
        j = JaxBayesRRmMT(ds_t, ph, window=topt.window, exact=topt.exact,
                          seed=3, mesh=make_mesh(1),
                          schedule=t.cfg.schedule)
        rds_t = [_read(trestart, b, model) for b in _bases(tmp_path, "run",
                                                          model)]
        got = tmt.state_to_numpy(t.init_state_from_restart(rds_t))
        # the JAX runner's rebuild (hydra_tpu/runner.py:190-232), gamma too
        rds = [_read(jrestart, b, model) for b in _bases(tmp_path, "run",
                                                        model)]
        want = {k: np.asarray(getattr(j.init_state(), k)).copy()
                for k in tmt.STATE_FIELDS}
        sel = j.slot_to_marker >= 0
        for k, rd in enumerate(rds):
            want["eps"][:N, k] = rd.eps
            want["beta"][sel, k] = rd.beta[j.slot_to_marker[sel]]
            want["components"][sel, k] = rd.components[j.slot_to_marker[sel]]
        for name in ("mu", "sigma_e"):
            want[name] = np.array([getattr(rd, name) for rd in rds],
                                  np.float32)
        for name in ("sigma_g", "est_pi"):
            want[name] = np.stack([getattr(rd, name) for rd in rds]
                                  ).astype(np.float32)
        want["gamma"] = np.stack([rd.gamma for rd in rds], 1).astype(
            np.float32)
        np.testing.assert_array_equal(t.slot_to_marker, j.slot_to_marker)
    else:
        ds_t = trunner.dataset_from_options(topt)
        ds_j = jrunner.dataset_from_options(jopt)
        rd_t = _read(trestart, str(tmp_path / "run"), model)
        rd_j = _read(jrestart, str(tmp_path / "run"), model)
        if model == "bw":
            t = tbw.BayesW(ds_t, window=topt.window, seed=3, quad_points=7,
                           device="cpu")
            j = JaxBayesW(ds_j, window=topt.window, seed=3, quad_points=7,
                          mesh=make_mesh(1), schedule=t.cfg.schedule)
            fields, to_np = tbw.STATE_FIELDS, tbw.state_to_numpy
        else:
            fh = model == "fh"
            t = tbrr.BayesRRm(ds_t, window=topt.window, exact=topt.exact,
                              seed=3, fh=fh, device="cpu")
            j = JaxBayesRRm(ds_j, window=topt.window, exact=topt.exact,
                            seed=3, fh=fh, mesh=make_mesh(1),
                            schedule=t.cfg.schedule)
            fields, to_np = tbrr.STATE_FIELDS, tbrr.state_to_numpy
        np.testing.assert_array_equal(t.slot_to_marker, j.slot_to_marker)
        got = to_np(t.init_state_from_restart(rd_t))
        want = {k: np.asarray(getattr(j.init_state_from_restart(rd_j), k))
                for k in fields}
    for name, w in want.items():
        if name == "acum":
            continue
        assert got[name].dtype == w.dtype, name
        np.testing.assert_array_equal(got[name], w, err_msg=name)
    assert np.all(got["gamma"] != 0.0)


@pytest.mark.parametrize("saved,flags", [
    (dict(seed=11, rng_window=128, rng_schedule="block", rng_exact=True),
     []),
    (dict(seed=11, rng_window=32, rng_schedule="marker", rng_exact=False),
     ["--seed", "5", "--window", "64", "--schedule", "block"]),
    (dict(seed=11, rng_window=1, rng_schedule="block", rng_exact=True),
     ["--mpibayes", "bayesWMPI", "--window", "8"]),
])
def test_apply_restart_rng_matches_jax(saved, flags):
    """The saved seed always wins; an automatic window or schedule takes
    the saved one, a chosen one keeps its value with a WARNING; the same
    lines as the JAX runner's."""
    argv = ["--mpibayes", "bayesMPI", "--bfile", "x", "--pheno", "x.phen",
            *flags]
    outs = []
    for parse, mod, rmod in ((tparse, trunner, trestart),
                             (jparse, jrunner, jrestart)):
        opt = parse(argv)
        rd = rmod.RestartData(
            iteration=8, start_iteration=9, sigma_g=np.ones(1), sigma_e=1.0,
            est_pi=np.ones((1, 4)), mu=0.0, beta=np.zeros(3),
            components=np.zeros(3, np.int32), eps=np.zeros(2),
            marker_order=np.arange(3), **saved)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.apply_restart_rng(opt, rd)
        outs.append((opt.seed, opt.window, opt.schedule, buf.getvalue()))
    assert outs[0] == outs[1]
    assert outs[0][0] == 11 and outs[0][3]


RESTART_CASES = {
    # id: (model, extra CLI flags)
    "bayesrrm_exact": ("brr", []),
    "bayesrrm_stale": ("brr", ["--stale", "--window", "32"]),
    "bayesfh": ("fh", []),
    "bayesw": ("bw", []),
    "multi_trait": ("mt", []),
}


@pytest.mark.parametrize("case", list(RESTART_CASES))
def test_cli_restart_is_bitwise(inputs, tmp_path, case):
    """Full chain == a chain cut at 10 iterations + --restart (no --seed:
    it comes from cut.rng.0), byte for byte after the restart; the JAX
    package's test_cli_restart_bitwise_no_seed for the port's CLI."""
    model, extra = RESTART_CASES[case]

    def run(name, iters, **kw):
        argv = _argv(inputs, model, tmp_path, name, iters, extra=extra, **kw)
        assert cli.main(argv + ["--device", "cpu"]) == 0

    run("full", 20, seed=31)
    run("cut", 10, seed=31)
    run("cut", 20, restart=True)
    for full, rs in zip(_bases(tmp_path, "full", model),
                        _bases(tmp_path, "cut_rs", model)):
        its = soak.compare_runs(full, rs, _m(model), survival=model == "bw",
                                covariates=True)
        assert its == [10, 12, 14, 16, 18]
    # the original files survive
    for cut in _bases(tmp_path, "cut", model):
        assert soak.last_csv_iter(cut + ".csv") == 8


def test_restart_from_iteration_zero_is_refused(inputs, tmp_path):
    """BayesRRm.cpp:868-875: a chain with no save after iteration 0."""
    argv = _argv(inputs, "brr", tmp_path, "short", 3, seed=3)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    with pytest.raises(ValueError, match="cannot restart from iteration 0"):
        cli.main(_argv(inputs, "brr", tmp_path, "short", 10, restart=True)
                 + ["--device", "cpu"])


def test_soak_sigkill_restart_cpu(tmp_path):
    """scripts/soak_restart_torch.py --device cpu: a chain SIGKILLed once
    its csv shows iteration 20 (a save), restarted, byte-identical to the
    uninterrupted run for every record after the restart."""
    res = subprocess.run(
        [sys.executable, "scripts/soak_restart_torch.py", "--device", "cpu",
         "--m", "100", "--n", "300", "--iters", "40", "--kill-at", "20",
         "--workdir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "# SIGKILL at csv iteration 20" in res.stdout
    assert "# SOAK PASS [brr]" in res.stdout
    rows = [r for r in open(tmp_path / "out" / "cut_rs.csv") if r.strip()]
    assert int(rows[0].split(",")[0]) == 22
