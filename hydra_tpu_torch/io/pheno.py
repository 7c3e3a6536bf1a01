"""Phenotype / failure / covariate readers with hydra NA semantics.

Equivalents of Data::readPhenotypeFile (data.cpp:1805-1885),
readPhenCovFiles (:1615-1675), readPhenFailFiles / readPhenFailCovFiles
(:1681-1802), readFailureFile (:1919-1937) and readCSVFile (:1888-1915).
The port's own copy of ``hydra_tpu/io/pheno.py`` (same names and
behaviour).

NA handling (the reference's core semantic): individuals whose phenotype —
or any covariate — is the literal string "NA" are *dropped*: their line
indices are recorded (`na_indices` == NAsInds), the returned vectors are
compacted to the non-NA individuals, and the genotype matrix must be
corrected to remove those columns (C8).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class PhenoData:
    y: np.ndarray                    # (N - numNAs,) phenotype values
    na_indices: np.ndarray           # original line indices of NA individuals
    fail: Optional[np.ndarray] = None      # (N - numNAs,) failure indicators (BayesW)
    X: Optional[np.ndarray] = None         # (N - numNAs, F) covariates

    @property
    def num_nas(self) -> int:
        return len(self.na_indices)


def read_phenotype_file(path: str, expected_n: Optional[int] = None) -> PhenoData:
    """.phen: `fid pid value` per line; value 'NA' drops the individual
    (data.cpp:1805-1837)."""
    vals: List[float] = []
    nas: List[int] = []
    line_no = 0
    with open(path) as fh:
        for raw in fh:
            parts = raw.split()
            if not parts:
                continue
            if parts[2] == "NA":
                nas.append(line_no)
            else:
                vals.append(float(parts[2]))
            line_no += 1
    if expected_n is not None and line_no != expected_n:
        raise ValueError(f"{path}: expected {expected_n} individuals, found {line_no}")
    return PhenoData(np.asarray(vals, dtype=np.float64), np.asarray(nas, dtype=np.int64))


def read_failure_file(path: str) -> np.ndarray:
    """.fail: one 0/1 per line; anything else is skipped as missing
    (data.cpp:1919-1937)."""
    vals = []
    with open(path) as fh:
        for raw in fh:
            for tok in raw.split():
                v = int(float(tok))
                if v in (0, 1):
                    vals.append(v)
    return np.asarray(vals, dtype=np.float64)


def read_csv_covariates(path: str, expected_n: int) -> np.ndarray:
    """Comma-separated covariates, no ID columns (data.cpp:1888-1915)."""
    rows = []
    with open(path) as fh:
        for raw in fh:
            line = raw.strip()
            if not line:
                continue
            rows.append([float(c) for c in line.split(",")])
    X = np.asarray(rows, dtype=np.float64)
    if X.shape[0] != expected_n:
        raise ValueError(
            "covariate file has different number of individuals as BED file"
        )
    return X


def read_phen_cov_files(phen_path: str, cov_path: str, expected_n: int) -> PhenoData:
    """Joint .phen + .cov read: drop individuals with NA in either
    (data.cpp:1615-1675). Covariate columns start at field 2 (fid pid c1 ...)."""
    vals: List[float] = []
    covs: List[List[float]] = []
    nas: List[int] = []
    line_no = 0
    with open(phen_path) as fp, open(cov_path) as fc:
        for raw_p, raw_c in zip(fp, fc):
            parts_p = raw_p.split()
            parts_c = raw_c.split()
            if not parts_p:
                continue
            na_c = any(tok == "NA" for tok in parts_c[2:])
            if parts_p[2] != "NA" and not na_c:
                vals.append(float(parts_p[2]))
                covs.append([float(t) for t in parts_c[2:]])
            else:
                nas.append(line_no)
            line_no += 1
    if line_no != expected_n:
        raise ValueError(f"{phen_path}: expected {expected_n} individuals, found {line_no}")
    return PhenoData(
        np.asarray(vals, dtype=np.float64),
        np.asarray(nas, dtype=np.int64),
        X=np.asarray(covs, dtype=np.float64),
    )


def read_phen_fail_files(phen_path: str, fail_path: str, expected_n: int) -> PhenoData:
    """Joint .phen + .fail read for BayesW (data.cpp:1681-1744 semantics):
    individuals with NA phenotype are dropped from both vectors."""
    vals: List[float] = []
    fails: List[float] = []
    nas: List[int] = []
    line_no = 0
    with open(phen_path) as fp, open(fail_path) as ff:
        for raw_p, raw_f in zip(fp, ff):
            parts_p = raw_p.split()
            if not parts_p:
                continue
            f_tok = raw_f.split()[0]
            if parts_p[2] != "NA":
                vals.append(float(parts_p[2]))
                fails.append(float(f_tok))
            else:
                nas.append(line_no)
            line_no += 1
    if line_no != expected_n:
        raise ValueError(f"{phen_path}: expected {expected_n} individuals, found {line_no}")
    return PhenoData(
        np.asarray(vals, dtype=np.float64),
        np.asarray(nas, dtype=np.int64),
        fail=np.asarray(fails, dtype=np.float64),
    )


def read_phen_fail_cov_files(
    phen_path: str, cov_path: str, fail_path: str, expected_n: int
) -> PhenoData:
    """Joint .phen + .cov + .fail read (data.cpp:1681-1802): drop on NA in
    phenotype or any covariate."""
    vals: List[float] = []
    fails: List[float] = []
    covs: List[List[float]] = []
    nas: List[int] = []
    line_no = 0
    with open(phen_path) as fp, open(cov_path) as fc, open(fail_path) as ff:
        for raw_p, raw_c, raw_f in zip(fp, fc, ff):
            parts_p = raw_p.split()
            parts_c = raw_c.split()
            if not parts_p:
                continue
            na_c = any(tok == "NA" for tok in parts_c[2:])
            if parts_p[2] != "NA" and not na_c:
                vals.append(float(parts_p[2]))
                covs.append([float(t) for t in parts_c[2:]])
                fails.append(float(raw_f.split()[0]))
            else:
                nas.append(line_no)
            line_no += 1
    if line_no != expected_n:
        raise ValueError(f"{phen_path}: expected {expected_n} individuals, found {line_no}")
    return PhenoData(
        np.asarray(vals, dtype=np.float64),
        np.asarray(nas, dtype=np.int64),
        fail=np.asarray(fails, dtype=np.float64),
        X=np.asarray(covs, dtype=np.float64),
    )


def center_and_scale(y: np.ndarray) -> np.ndarray:
    """Center and scale to sum-of-squares == N-1 (BayesRRm.cpp:371-388)."""
    y = y - y.mean()
    sqn = np.sqrt((len(y) - 1) / np.sum(y * y))
    return y * sqn
