"""MCMC output writers — hydra-compatible binary/text formats.

The port's own copy of ``hydra_tpu/outputs/writers.py`` (same names, same
bytes on disk). ``on_thin`` appends the csv row after the iteration's other
records, and the runners call ``on_save`` before ``on_thin``: a row in the
csv means every record of that iteration is whole on disk, so a chain
killed right after a row restarts from it.

A save never overwrites the previous generation of a file in place: the
file is renamed to ``<file>.prev``, the new bytes are written to
``<file>.tmp`` and renamed in (``os.replace``). ``commit_save``, which the
runners call after the csv row (of every trait), removes the ``.prev``
files. So a kill at any point of a save leaves, for each file, the
generation the csv's last save row names in ``<file>`` or ``<file>.prev``,
and ``outputs/restart.py`` takes whichever carries that iteration. After a
completed save the directory holds the same files and bytes as before.

Reproduces the reference's output files (BayesRRm.cpp:2736-2877 write blocks;
binary layouts documented at :2797-2800 and postproc/beta_converter.cpp:40-52):

  .csv   text, one row per thinned iteration: it, nG, sigmaG[G], sigmaE, h2,
         m0, piRows, piCols, pi[G*K]                       (BayesRRm.cpp:2742-2764)
  .bet   [u32 Mtot] then per thinned it: [u32 it][f64 x Mtot]
  .cpn   [u32 Mtot] then per thinned it: [u32 it][i32 x Mtot]
  .acu   like .bet (P(comp=0) per marker)
  .xbet  [u32 Mtot][u32 it][f64 x Mtot]   — last saved state only, overwritten
  .xcpn  [u32 Mtot][u32 it][i32 x Mtot]
  .mus.0 per thinned it: [u32 it][f64 mu]
  .eps.0 [u32 it][u32 Ntot][f64 x Ntot]   — overwritten each --save
  .mrk.0 [u32 it][u32 M][i32 x M]
  .gam.0 / .xiv.0 covariate dumps           (when covariates are used)
  .rng.0 JSON {seed, iteration} — replaces the boost mt19937 state dump
         (distributions_boost.cpp:38-55): counter-based keys re-derive all
         randomness from (seed, iteration), so this is the complete RNG state;
         float64 chains add their sigmaG, sigmaE and pi ("hypers")
  .lst   list of files tarred each --save  (BayesRRm.cpp:1245-1262)
  .fh.npz FH extension state and its "iteration" (the reference never
         dumps FH state — its FH restart silently re-inits; we restore it
         exactly)

The ".0" suffix replaces the reference's per-rank suffix: a single logical
writer (host 0) covers all shards, as device->host gathers replace MPI-IO.

BayesW uses the same writer with `survival=True`: its .csv row layout is
it, mu, sigmaG.sum, alpha, h2w, m0, piRows, piCols, sigmaG[G], pi[G*K]
(BayesW.cpp:1942-1961) and .gam is a text file (:1971-1980).
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import time
from typing import Optional

import numpy as np

PREV, TMP = ".prev", ".tmp"
# the files a save replaces
SAVE_EXTS = (".eps.0", ".mrk.0", ".xbet", ".xcpn", ".gam.0", ".xiv",
             ".xiv.0", ".fh.npz", ".rng.0")


def tagged(it: int, values: np.ndarray, dtype) -> bytes:
    """[u32 it][u32 n][n values]: the .eps.0 / .mrk.0 / .gam.0 / .xiv
    record."""
    return (np.asarray([it, len(values)], dtype=np.uint32).tobytes()
            + np.asarray(values).astype(dtype).tobytes())


class McmcWriter:
    def __init__(self, mcmc_out: str, mtot: int, ntot: int, num_groups: int,
                 k: int, thin: int, save: int, seed: int,
                 covariates: bool = False, survival: bool = False,
                 make_tarball: bool = False, window: int = 0,
                 exact: bool = True, schedule: str = "marker"):
        self.base = mcmc_out
        self.mtot, self.ntot = mtot, ntot
        self.num_groups, self.k = num_groups, k
        self.thin, self.save = thin, save
        self.seed = seed
        self.window, self.exact = window, exact
        self.schedule = schedule
        self.covariates = covariates
        self.survival = survival
        self.make_tarball = make_tarball
        self.n_thinned = 0

        d = os.path.dirname(mcmc_out)
        if d:
            os.makedirs(d, exist_ok=True)
            if make_tarball:
                os.makedirs(os.path.join(d, "tarballs"), exist_ok=True)

        # a save left unfinished by an earlier chain of this name
        for ext in SAVE_EXTS:
            for tail in (PREV, TMP):
                if os.path.exists(self.base + ext + tail):
                    os.remove(self.base + ext + tail)
        self._prev = []
        # fresh files; header = Mtot (BayesRRm.cpp:1302-1309)
        hdr = np.asarray([mtot], dtype=np.uint32).tobytes()
        for ext in (".bet", ".cpn", ".acu", ".xbet", ".xcpn"):
            if survival and ext == ".acu":
                continue
            with open(self.base + ext, "wb") as fh:
                fh.write(hdr)
        for ext in (".csv", ".mus.0", ".eps.0", ".mrk.0"):
            open(self.base + ext, "wb").close()
        if covariates:
            open(self.base + (".gam" if survival else ".gam.0"),
                 "w" if survival else "wb").close()
            open(self.base + (".xiv" if survival else ".xiv.0"), "wb").close()
        self._write_lst()

    def _write_lst(self):
        with open(self.base + ".lst", "w") as fh:
            for ext in (".csv", ".xbet", ".xcpn", ".acu", ".rng.0", ".mrk.0",
                        ".xiv.0", ".eps.0", ".gam.0", ".mus.0"):
                fh.write(self.base + ext + "\n")

    # ------------------------------------------------------------------
    def csv_row_brr(self, it: int, sigma_g: np.ndarray, sigma_e: float,
                    m0: int, est_pi: np.ndarray) -> str:
        """BayesRRm.cpp:2742-2761 row layout."""
        parts = [f"{it:5d}", f" {len(sigma_g):4d}"]
        parts += [f" {v:20.15f}" for v in sigma_g]
        sg = float(np.sum(sigma_g))
        parts += [f" {sigma_e:20.15f}", f" {sg / (sigma_e + sg):20.15f}",
                  f" {m0:7d}", f" {est_pi.shape[0]:4d}", f" {est_pi.shape[1]:2d}"]
        parts += [f" {v:20.15f}" for v in est_pi.ravel()]
        return ",".join(parts) + "\n"

    def csv_row_bw(self, it: int, mu: float, sigma_g: np.ndarray, alpha: float,
                   m0: int, pi_l: np.ndarray) -> str:
        """BayesW.cpp:1942-1961 row layout."""
        sg = float(np.sum(sigma_g))
        h2w = sg / (sg + np.pi**2 / (6 * alpha * alpha))
        parts = [f"{it:5d}", f" {mu:20.15f}", f" {sg:20.15f}", f" {alpha:20.15f}",
                 f" {h2w:20.15f}", f" {m0:7d}", f" {pi_l.shape[0]:7d}",
                 f" {pi_l.shape[1]:2d}"]
        parts += [f" {v:20.15f}" for v in sigma_g]
        parts += [f" {v:20.15f}" for v in pi_l.ravel()]
        return ",".join(parts) + "\n"

    # ------------------------------------------------------------------
    def on_thin(self, it: int, beta: np.ndarray, components: np.ndarray,
                csv_row: str, mu: float, acum: Optional[np.ndarray] = None,
                gamma_text: Optional[str] = None):
        rec_it = np.asarray([it], dtype=np.uint32).tobytes()
        with open(self.base + ".bet", "ab") as fh:
            fh.write(rec_it)
            fh.write(beta.astype(np.float64).tobytes())
        with open(self.base + ".cpn", "ab") as fh:
            fh.write(rec_it)
            fh.write(components.astype(np.int32).tobytes())
        if acum is not None:
            with open(self.base + ".acu", "ab") as fh:
                fh.write(rec_it)
                fh.write(acum.astype(np.float64).tobytes())
        with open(self.base + ".mus.0", "ab") as fh:
            fh.write(rec_it)
            fh.write(np.asarray([mu], dtype=np.float64).tobytes())
        if gamma_text is not None:
            with open(self.base + ".gam", "a") as fh:
                fh.write(gamma_text)
        with open(self.base + ".csv", "a") as fh:
            fh.write(csv_row)
        self.n_thinned += 1

    def _replace(self, ext: str, data: bytes):
        """Write one file of a save: the old generation to <file>.prev, the
        new bytes to <file>.tmp, renamed in."""
        path = self.base + ext
        if os.path.exists(path):
            os.replace(path, path + PREV)
            self._prev.append(path + PREV)
        with open(path + TMP, "wb") as fh:
            fh.write(data)
        os.replace(path + TMP, path)

    def on_save(self, it: int, eps: np.ndarray, marker_order: np.ndarray,
                beta: np.ndarray, components: np.ndarray,
                gamma: Optional[np.ndarray] = None,
                x_order: Optional[np.ndarray] = None,
                fh_state: Optional[dict] = None,
                hypers: Optional[dict] = None):
        """hypers: float64 chains' sigmaG, sigmaE and pi, kept in .rng.0 at
        full precision (the csv rounds them to 15 decimals, which a float32
        chain's values survive and a float64 chain's do not)."""
        self._replace(".eps.0", tagged(it, eps, np.float64))
        self._replace(".mrk.0", tagged(it, marker_order, np.int32))
        hdr = np.asarray([self.mtot, it], dtype=np.uint32).tobytes()
        self._replace(".xbet", hdr + beta.astype(np.float64).tobytes())
        self._replace(".xcpn", hdr + components.astype(np.int32).tobytes())
        if self.covariates and gamma is not None and not self.survival:
            self._replace(".gam.0", tagged(it, gamma, np.float64))
        if self.covariates and x_order is not None:
            self._replace(".xiv" if self.survival else ".xiv.0",
                          tagged(it, x_order, np.int32))
        if fh_state is not None:
            buf = io.BytesIO()
            np.savez(buf, **fh_state, iteration=np.uint32(it))
            self._replace(".fh.npz", buf.getvalue())
        # complete RNG state: counter-based keys re-derive all randomness from
        # (seed, iteration); window/exact pin the chain schedule so a restart
        # reproduces the uninterrupted chain bitwise (the equivalent of the
        # reference's boost state dump, distributions_boost.cpp:38-55)
        rng = {"seed": self.seed, "iteration": it, "window": self.window,
               "exact": self.exact, "schedule": self.schedule}
        if hypers is not None:
            rng["hypers"] = {k: np.asarray(v, np.float64).tolist()
                             for k, v in hypers.items()}
        self._replace(".rng.0", json.dumps(rng).encode())
        if self.make_tarball:
            self._tarball(it)

    def commit_save(self):
        """Drop the previous generation of the last save's files: call once
        the save's csv row (every trait's) is on disk."""
        for path in self._prev:
            os.remove(path)
        self._prev = []

    def _tarball(self, it: int):
        """dump_<name>_<it>__<timestamp>.tar of the .lst files
        (BayesRRm.cpp:2850-2876)."""
        d = os.path.dirname(self.base) or "."
        name = os.path.basename(self.base)
        ts = time.strftime("%Y-%m-%d_%H-%M-%S")
        tar = os.path.join(d, "tarballs", f"dump_{name}_{it:05d}__{ts}.tar")
        files = [ln.strip() for ln in open(self.base + ".lst")
                 if ln.strip() and os.path.exists(ln.strip())]
        subprocess.run(["tar", "-cf", tar] + files, check=False,
                       stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


class NullWriter:
    """No-op writer for the ranks other than 0 (the port's copy of
    ``hydra_tpu/outputs/writers.py::NullWriter``).

    Marker-shard runs keep ONE writer, rank 0's: the analogue of the
    reference's rank-0 file creation and offset-disjoint MPI-IO writes
    (BayesRRm.cpp:2736-2877). The other ranks still take part in the
    collective gathers; every file method here swallows the result."""

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return lambda *a, **k: None
