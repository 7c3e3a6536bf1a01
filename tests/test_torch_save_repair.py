"""A save cut at any point restarts: the port's save repair (CPU).

Each file of a save goes to ``<file>.tmp`` and is renamed in, the previous
generation kept as ``<file>.prev`` until every trait's csv row of the save
is on disk (``outputs/writers.py``), and the reader takes whichever
generation carries the csv's iteration (``outputs/restart.py``). Here one
save (iteration 8 of a 13-iteration chain, thin 2, save 4) fails in turn at
each file operation it makes: every open for writing (the new files, the
thin records, the csv row), every rename and the removal of the previous
generation. After each failure ``--restart`` must resume the chain byte for
byte the uninterrupted one (``scripts/soak_restart_torch.py::
compare_runs``: csv rows, .bet, .cpn, .acu, .mus.0, gamma, the last
.eps.0) and its last save's .xbet too. Run for BayesRRm with covariates,
BayesFH with covariates (its .fh.npz state), BayesW with covariates and
multi-trait BayesRRm (two traits). A completed
save's directory holds no .prev or .tmp file and the JAX package's reader
still reads it.
"""

import builtins
import os

import numpy as np
import pytest
import torch

from hydra_tpu.outputs import restart as jrestart
from hydra_tpu_torch import cli
from hydra_tpu_torch.outputs import writers

from scripts import soak_restart_torch as soak

torch.set_num_threads(1)

M, MW, N, F, T = 32, 16, 128, 2, 2
ITERS, THIN, SAVE, CUT = 13, 2, 4, 8


class Faults:
    """Counts the writers' file operations from the save at CUT on and
    raises at operation ``at``."""

    def __init__(self, at):
        self.at, self.n, self.armed = at, 0, False

    def hit(self, what):
        if self.armed:
            if self.n == self.at:
                raise OSError(f"injected failure at operation {self.n} "
                              f"({what})")
            self.n += 1


class _Os:
    def __init__(self, faults):
        self._f = faults

    def replace(self, a, b):
        self._f.hit(f"replace {os.path.basename(a)}")
        os.replace(a, b)

    def remove(self, p):
        self._f.hit(f"remove {os.path.basename(p)}")
        os.remove(p)

    def __getattr__(self, name):
        return getattr(os, name)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("repair")
    base, wbase = str(d / "g"), str(d / "w")
    soak.write_inputs(base, M, N, seed=5, n_cov=F, n_traits=T)
    soak.write_inputs(wbase, MW, N, seed=6, n_cov=F, n_traits=0)
    return {"brr": base, "fh": base, "mt": base, "bw": wbase}


def _argv(inputs, model, out, restart=False):
    return soak.cli_argv(inputs[model], model, str(out), "run", ITERS,
                         device="cpu", thin=THIN, save=SAVE,
                         n_cov=0 if model == "mt" else F,
                         n_traits=T if model == "mt" else 0, seed=11,
                         restart=restart, extra=("--window", "4"))


def _run(inputs, model, out, monkeypatch, at):
    """The chain with a failure at operation ``at`` of the save at CUT;
    returns the operations that save made (at is never reached when it is
    larger)."""
    f = Faults(at)
    save, thin = writers.McmcWriter.on_save, writers.McmcWriter.on_thin

    def on_save(self, it, *a, **k):
        if it == CUT:
            f.armed = True
        return save(self, it, *a, **k)

    def on_thin(self, it, *a, **k):
        if it > CUT:
            f.armed = False
        return thin(self, it, *a, **k)

    def opener(path, mode="r", *a, **k):
        if any(c in mode for c in "wa+"):
            f.hit(f"open {os.path.basename(path)}")
        return builtins.open(path, mode, *a, **k)

    with monkeypatch.context() as mp:
        mp.setattr(writers.McmcWriter, "on_save", on_save)
        mp.setattr(writers.McmcWriter, "on_thin", on_thin)
        mp.setattr(writers, "open", opener, raising=False)
        mp.setattr(writers, "os", _Os(f))
        try:
            cli.main(_argv(inputs, model, out))
        except OSError as e:
            assert "injected" in str(e)
            return None
    return f.n


def _bases(model, d, name):
    return ([str(d / f"{name}.t{t}") for t in range(T)] if model == "mt"
            else [str(d / name)])


@pytest.mark.parametrize("model", ["brr", "fh", "bw", "mt"])
def test_a_failed_save_restarts_byte_for_byte(inputs, model, tmp_path,
                                              monkeypatch):
    full = tmp_path / "full"
    n_ops = _run(inputs, model, full, monkeypatch, at=10 ** 6)
    assert n_ops > 10
    m = MW if model == "bw" else M
    for base in _bases(model, full, "run"):
        assert not [p for p in os.listdir(full) if p.endswith((".prev",
                                                               ".tmp"))]
        # the JAX package's reader reads a completed save (N less the
        # individuals an "NA" covariate drops)
        n = int(np.fromfile(base + ".eps.0", np.uint32, 2)[1])
        rd = jrestart.read_restart(base, m, n, SAVE, covariates=model != "mt",
                                   survival=model == "bw")
        assert rd.iteration == 12
    for at in range(n_ops):
        cut = tmp_path / f"cut{at}"
        assert _run(inputs, model, cut, monkeypatch, at) is None, at
        assert cli.main(_argv(inputs, model, cut, restart=True)) == 0
        for fb, cb in zip(_bases(model, full, "run"),
                          _bases(model, cut, "run_rs")):
            its = soak.compare_runs(fb, cb, m, survival=model == "bw",
                                    covariates=model != "mt")
            assert its[-1] == ITERS - 1, (at, its)
            assert (open(fb + ".xbet", "rb").read()
                    == open(cb + ".xbet", "rb").read()), at
