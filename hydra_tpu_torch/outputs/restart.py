"""Restart / resume readers — hydra-compatible.

The port's own copy of ``hydra_tpu/outputs/restart.py`` (same names, same
RestartData from the same files; numpy only).

Equivalent of Data::read_mcmc_output_* (data.cpp:33-665) and
BayesRRm::init_from_restart (BayesRRm.cpp:842-928): find the last *saved*
iteration from the .csv, read back beta/components (.xbet/.xcpn, or the
.bet/.cpn history when --ignore-xfiles), epsilon, mu, marker order, gamma;
resume at iteration + 1. Restarting from iteration 0 is refused
(BayesRRm.cpp:868-875).

A save interrupted by a kill leaves the previous generation of its files
as ``<file>.prev`` (``outputs/writers.py``): each file is read from
whichever of ``<file>`` and ``<file>.prev`` carries the iteration of the
csv's last save row, and a csv row counts only once its newline is on
disk.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from hydra_tpu_torch.outputs.writers import PREV


@dataclass
class RestartData:
    iteration: int               # iteration_to_restart_from
    start_iteration: int         # iteration + 1
    sigma_g: np.ndarray
    sigma_e: float
    est_pi: np.ndarray           # (G, K)
    mu: float
    beta: np.ndarray             # (Mtot,)
    components: np.ndarray       # (Mtot,)
    eps: np.ndarray              # (Ntot,)
    marker_order: np.ndarray
    seed: int
    rng_window: Optional[int] = None   # chain schedule saved in .rng.0
    rng_exact: Optional[bool] = None
    rng_schedule: Optional[str] = None  # marker | block (absent pre-r4)
    gamma: Optional[np.ndarray] = None
    x_order: Optional[np.ndarray] = None
    fh_state: Optional[dict] = None
    alpha: Optional[float] = None   # BayesW
    pi_l: Optional[np.ndarray] = None


def _save_row(path: str, save: int, min_tokens: int,
              iteration: Optional[int]):
    """The tokens of the last whole save row of a csv, or of the row of
    ``iteration`` when given."""
    best = None
    with open(path) as fh:
        for line in fh:
            tok = [t.strip() for t in line.split(",")]
            if len(tok) < min_tokens or not line.endswith("\n"):
                continue
            it = int(tok[0])
            if it > 0 and it % save == 0 and (iteration is None
                                              or it == iteration):
                best = tok
    return best


def last_save_iteration(path: str, save: int) -> int:
    """The iteration of a csv's last whole save row (0 when it has none)."""
    best = _save_row(path, save, 5, None)
    return 0 if best is None else int(best[0])


def _parse_csv_brr(path: str, save: int, iteration: Optional[int] = None):
    """Find the last saved iteration row (data.cpp:408-519 logic)."""
    best = _save_row(path, save, 5, iteration)
    if best is None:
        raise ValueError(
            "cannot restart from iteration 0; run the chain longer first"
        )  # BayesRRm.cpp:868-875
    it = int(best[0])
    g = int(best[1])
    sigma_g = np.asarray([float(v) for v in best[2:2 + g]])
    sigma_e = float(best[2 + g])
    m0 = int(best[4 + g])  # noqa: F841 (parsed for validation only)
    rows = int(best[5 + g])
    cols = int(best[6 + g])
    pi = np.asarray([float(v) for v in best[7 + g: 7 + g + rows * cols]])
    return it, sigma_g, sigma_e, pi.reshape(rows, cols)


def _parse_csv_bw(path: str, save: int, iteration: Optional[int] = None):
    """BayesW csv layout (BayesW.cpp:1942-1961; data.cpp:524-617)."""
    best = _save_row(path, save, 8, iteration)
    if best is None:
        raise ValueError("cannot restart from iteration 0; run the chain longer first")
    it = int(best[0])
    mu = float(best[1])
    alpha = float(best[3])
    rows = int(best[6])
    cols = int(best[7])
    sigma_g = np.asarray([float(v) for v in best[8: 8 + rows]])
    pi = np.asarray([float(v) for v in best[8 + rows: 8 + rows + rows * cols]])
    return it, mu, alpha, sigma_g, pi.reshape(rows, cols)


def _tag(path: str) -> Optional[int]:
    """The iteration a save file carries: the u32 after the Mtot header of
    .xbet/.xcpn, the first u32 of the tagged vectors, the "iteration" of
    .rng.0 and .fh.npz."""
    if not os.path.exists(path):
        return None
    if path.endswith((".rng.0", ".rng.0" + PREV)):
        with open(path) as fh:
            return json.load(fh).get("iteration")
    if path.endswith((".fh.npz", ".fh.npz" + PREV)):
        with np.load(path) as z:
            return int(z["iteration"]) if "iteration" in z.files else None
    with open(path, "rb") as fh:
        head = np.frombuffer(fh.read(8), dtype=np.uint32)
    x = path.endswith((".xbet", ".xcpn", ".xbet" + PREV, ".xcpn" + PREV))
    want = 2 if x else 1
    return int(head[want - 1]) if len(head) >= want else None


def generation(path: str, it: int) -> str:
    """``path`` or ``path.prev``, whichever carries iteration ``it`` (the
    file itself when neither does: its reader then names the mismatch)."""
    prev = path + PREV
    if not os.path.exists(prev):
        return path
    return prev if _tag(path) != it and _tag(prev) == it else path


def _read_x_file(path: str, mtot: int, dtype, expected_it: int) -> np.ndarray:
    with open(path, "rb") as fh:
        hdr = np.frombuffer(fh.read(8), dtype=np.uint32)
        if hdr[0] != mtot:
            raise ValueError(f"{path}: Mtot mismatch {hdr[0]} != {mtot}")
        if hdr[1] != expected_it:
            raise ValueError(f"{path}: iteration tag {hdr[1]} != {expected_it}")
        return np.frombuffer(fh.read(), dtype=dtype, count=mtot).copy()


def _read_history_file(path: str, mtot: int, dtype, expected_it: int) -> np.ndarray:
    """Scan a .bet/.cpn full-history file for the record tagged expected_it."""
    itemsize = np.dtype(dtype).itemsize
    rec = 4 + mtot * itemsize
    with open(path, "rb") as fh:
        m = np.frombuffer(fh.read(4), dtype=np.uint32)[0]
        if m != mtot:
            raise ValueError(f"{path}: Mtot mismatch {m} != {mtot}")
        size = os.path.getsize(path)
        nrec = (size - 4) // rec
        for r in range(nrec - 1, -1, -1):
            fh.seek(4 + r * rec)
            it = np.frombuffer(fh.read(4), dtype=np.uint32)[0]
            if it == expected_it:
                return np.frombuffer(fh.read(mtot * itemsize), dtype=dtype).copy()
    raise ValueError(f"{path}: no record for iteration {expected_it}")


def _read_tagged_vector(path: str, dtype, expected_it: int):
    with open(path, "rb") as fh:
        it, n = np.frombuffer(fh.read(8), dtype=np.uint32)
        if it != expected_it:
            raise ValueError(f"{path}: iteration tag {it} != {expected_it}")
        return np.frombuffer(fh.read(), dtype=dtype, count=n).copy()


def read_restart(mcmc_out: str, mtot: int, ntot: int, save: int,
                 use_xfiles: bool = True, covariates: bool = False,
                 survival: bool = False,
                 iteration: Optional[int] = None) -> RestartData:
    """The state of the csv's last save, or of the save at ``iteration``
    (multi-trait: the last save every trait's csv holds)."""
    if survival:
        it, mu, alpha, sigma_g, pi_l = _parse_csv_bw(mcmc_out + ".csv", save,
                                                     iteration)
        sigma_e, est_pi = 0.0, pi_l
    else:
        it, sigma_g, sigma_e, est_pi = _parse_csv_brr(mcmc_out + ".csv", save,
                                                      iteration)
        alpha, pi_l = None, None
        # mu from the .mus file record tagged `it`
        mu = _read_mu(mcmc_out + ".mus.0", it)

    def f(ext):
        return generation(mcmc_out + ext, it)

    if use_xfiles:
        beta = _read_x_file(f(".xbet"), mtot, np.float64, it)
        comps = _read_x_file(f(".xcpn"), mtot, np.int32, it)
    else:
        beta = _read_history_file(mcmc_out + ".bet", mtot, np.float64, it)
        comps = _read_history_file(mcmc_out + ".cpn", mtot, np.int32, it)

    eps = _read_tagged_vector(f(".eps.0"), np.float64, it)
    if len(eps) != ntot:
        raise ValueError(f".eps length {len(eps)} != Ntot {ntot}")
    # .mrk is validated (tag/iteration) and surfaced for format parity with
    # the reference (data.cpp:33-71), but no consumer needs it on resume:
    # the counter-based RNG re-derives every per-iteration shuffle from
    # (seed, iteration), unlike the reference's stateful mt19937.
    marker_order = _read_tagged_vector(f(".mrk.0"), np.int32, it)

    with open(f(".rng.0")) as fh:
        rng = json.load(fh)

    gamma = x_order = None
    if covariates and not survival and os.path.exists(f(".gam.0")):
        gamma = _read_tagged_vector(f(".gam.0"), np.float64, it)
    elif covariates and survival and os.path.exists(mcmc_out + ".gam"):
        # BayesW writes gamma as text rows "it, g0, g1, ..."; restart takes
        # the row tagged with the restart iteration
        # (read_mcmc_output_gam_file_bW, data.cpp:621-665)
        with open(mcmc_out + ".gam") as fh:
            for line in fh:
                tok = [t.strip() for t in line.split(",")]
                if len(tok) > 1 and int(tok[0]) == it:
                    gamma = np.asarray([float(v) for v in tok[1:]])
    if covariates:
        xiv = f(".xiv" if survival else ".xiv.0")
        # the covariate order is re-derived from (seed, iteration) by the
        # counter-based RNG; read the dump only when present and non-empty
        if os.path.exists(xiv) and os.path.getsize(xiv) >= 8:
            x_order = _read_tagged_vector(xiv, np.int32, it)

    fh_state = None
    if os.path.exists(f(".fh.npz")):
        with np.load(f(".fh.npz")) as z:
            fh_state = {k: z[k] for k in z.files}

    # a float64 chain's hyper-parameters at full precision
    hyp = rng.get("hypers")
    if hyp is not None:
        sigma_g = np.asarray(hyp["sigma_g"], np.float64)
        sigma_e = float(hyp["sigma_e"])
        est_pi = np.asarray(hyp["est_pi"], np.float64)

    return RestartData(
        iteration=it, start_iteration=it + 1, sigma_g=sigma_g, sigma_e=sigma_e,
        est_pi=est_pi, mu=mu, beta=beta, components=comps, eps=eps,
        marker_order=marker_order, seed=int(rng["seed"]),
        rng_window=rng.get("window"), rng_exact=rng.get("exact"),
        rng_schedule=rng.get("schedule"),
        gamma=gamma, x_order=x_order, fh_state=fh_state, alpha=alpha, pi_l=pi_l)


def _read_mu(mus_path: str, expected_it: int) -> float:
    """Scan the .mus file ([u32 it][f64 mu] records) for expected_it
    (data.cpp:214-256)."""
    with open(mus_path, "rb") as fh:
        data = fh.read()
    n = len(data) // 12
    for r in range(n - 1, -1, -1):
        it = np.frombuffer(data[r * 12: r * 12 + 4], dtype=np.uint32)[0]
        if it == expected_it:
            return float(np.frombuffer(data[r * 12 + 4: r * 12 + 12],
                                       dtype=np.float64)[0])
    raise ValueError(f"{mus_path}: no record for iteration {expected_it}")
