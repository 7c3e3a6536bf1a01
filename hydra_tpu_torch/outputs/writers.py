"""MCMC output writers — hydra-compatible binary/text formats.

The port's own copy of ``hydra_tpu/outputs/writers.py`` (same names, same
bytes on disk). ``on_thin`` appends the csv row after the iteration's other
records, and the runners call ``on_save`` before ``on_thin``: a row in the
csv means every record of that iteration is whole on disk, so a chain
killed right after a row restarts from it.

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
         randomness from (seed, iteration), so this is the complete RNG state.
  .lst   list of files tarred each --save  (BayesRRm.cpp:1245-1262)
  .fh.npz FH extension state (the reference never dumps FH state — its FH
         restart silently re-inits; we restore it exactly)

The ".0" suffix replaces the reference's per-rank suffix: a single logical
writer (host 0) covers all shards, as device->host gathers replace MPI-IO.

BayesW uses the same writer with `survival=True`: its .csv row layout is
it, mu, sigmaG.sum, alpha, h2w, m0, piRows, piCols, sigmaG[G], pi[G*K]
(BayesW.cpp:1942-1961) and .gam is a text file (:1971-1980).
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Optional

import numpy as np


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

    def on_save(self, it: int, eps: np.ndarray, marker_order: np.ndarray,
                beta: np.ndarray, components: np.ndarray,
                gamma: Optional[np.ndarray] = None,
                x_order: Optional[np.ndarray] = None,
                fh_state: Optional[dict] = None):
        it_u = np.asarray([it], dtype=np.uint32)
        with open(self.base + ".eps.0", "wb") as fh:
            fh.write(it_u.tobytes())
            fh.write(np.asarray([len(eps)], dtype=np.uint32).tobytes())
            fh.write(eps.astype(np.float64).tobytes())
        with open(self.base + ".mrk.0", "wb") as fh:
            fh.write(it_u.tobytes())
            fh.write(np.asarray([len(marker_order)], dtype=np.uint32).tobytes())
            fh.write(marker_order.astype(np.int32).tobytes())
        for ext, arr, dt in ((".xbet", beta, np.float64),
                             (".xcpn", components, np.int32)):
            with open(self.base + ext, "r+b") as fh:
                fh.seek(4)
                fh.write(it_u.tobytes())
                fh.write(arr.astype(dt).tobytes())
        if self.covariates and gamma is not None and not self.survival:
            with open(self.base + ".gam.0", "wb") as fh:
                fh.write(it_u.tobytes())
                fh.write(np.asarray([len(gamma)], dtype=np.uint32).tobytes())
                fh.write(gamma.astype(np.float64).tobytes())
        if self.covariates and x_order is not None:
            ext = ".xiv" if self.survival else ".xiv.0"
            with open(self.base + ext, "wb") as fh:
                fh.write(it_u.tobytes())
                fh.write(np.asarray([len(x_order)], dtype=np.uint32).tobytes())
                fh.write(x_order.astype(np.int32).tobytes())
        # complete RNG state: counter-based keys re-derive all randomness from
        # (seed, iteration); window/exact pin the chain schedule so a restart
        # reproduces the uninterrupted chain bitwise (the equivalent of the
        # reference's boost state dump, distributions_boost.cpp:38-55)
        with open(self.base + ".rng.0", "w") as fh:
            json.dump({"seed": self.seed, "iteration": it,
                       "window": self.window, "exact": self.exact,
                       "schedule": self.schedule}, fh)
        if fh_state is not None:
            np.savez(self.base + ".fh.npz", **fh_state)
        if self.make_tarball:
            self._tarball(it)

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
