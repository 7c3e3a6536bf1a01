"""Group / annotation / prior file readers.

Equivalents of Data::readGroupFile (data.cpp:1940-1959), readmSFile
(:1963-2009), read_group_priors (:2034-2061), read_dirichlet_priors
(:2069-2096), readMarkerBlocksFile (:1391-1440). The port's own copy of
``hydra_tpu/io/groups.py`` (same names and behaviour).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def read_group_file(path: str) -> np.ndarray:
    """Marker -> group index, whitespace-separated ints (data.cpp:1940-1959)."""
    with open(path) as fh:
        vals = [int(tok) for tok in fh.read().split()]
    return np.asarray(vals, dtype=np.int32)


def read_ms_file(path: str) -> np.ndarray:
    """Per-group mixture grid "c1,c2,c3;c1,c2,c3" (data.cpp:1963-2009).

    Returns (numGroups, K) with a 0.0 column prepended; strictly positive
    components enforced, equal component counts per group enforced.
    """
    with open(path) as fh:
        text = fh.read().strip()
    groups = [g for g in text.split(";") if g.strip()]
    rows = []
    ncomp = None
    for g in groups:
        vals = [float(t) for t in g.split(",") if t.strip()]
        if ncomp is None:
            ncomp = len(vals)
        elif len(vals) != ncomp:
            raise ValueError("all group mixtures must have the same number of components")
        if any(v <= 0.0 for v in vals):
            raise ValueError("mixture value can only be strictly positive")
        rows.append([0.0] + vals)
    return np.asarray(rows, dtype=np.float64)


def read_group_priors(path: str) -> np.ndarray:
    """Per-group (v0, s0) sigmaG priors: "v0,s0; v0,s0; ..." (data.cpp:2034-2061)."""
    with open(path) as fh:
        text = fh.read().strip()
    rows = []
    for g in text.split(";"):
        if not g.strip():
            continue
        vals = [float(t) for t in g.split(",") if t.strip()]
        rows.append(vals[:2])
    return np.asarray(rows, dtype=np.float64)


def read_dirichlet_priors(path: str) -> np.ndarray:
    """Per-group Dirichlet concentration rows: "a,b,c; d,e,f; ..."
    (data.cpp:2069-2096)."""
    with open(path) as fh:
        text = fh.read().strip()
    rows = []
    for g in text.split(";"):
        if not g.strip():
            continue
        rows.append([float(t) for t in g.split(",") if t.strip()])
    return np.asarray(rows, dtype=np.float64)


def read_marker_blocks_file(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Marker block definitions, one 'start end' (inclusive) pair per line
    (data.cpp:1391-1440). Returns (starts, ends) int arrays."""
    starts, ends = [], []
    with open(path) as fh:
        for raw in fh:
            parts = raw.split()
            if not parts:
                continue
            starts.append(int(parts[0]))
            ends.append(int(parts[1]))
    s = np.asarray(starts, dtype=np.int64)
    e = np.asarray(ends, dtype=np.int64)
    if np.any(e < s):
        raise ValueError("marker block with end < start")
    return s, e


def assign_blocks_to_tasks(
    num_blocks: int,
    blocks_starts: np.ndarray,
    blocks_ends: np.ndarray,
    mtot: int,
    nranks: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Marker sharding across ranks/devices.

    Equivalent of mpi_assign_blocks_to_tasks (BayesRRm.cpp:781-827) /
    mpi_define_blocks_of_markers (:396-413): with no block file, markers are
    split as evenly as possible (first Mtot % nranks shards get one extra);
    with a block file, blocks map 1:1 to ranks (numBlocks must equal nranks).
    Returns (MrankS, MrankL).
    """
    if num_blocks == 0:
        base = mtot // nranks
        extra = mtot % nranks
        lengths = np.full(nranks, base, dtype=np.int64)
        lengths[:extra] += 1
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        return starts, lengths
    if num_blocks != nranks:
        raise ValueError(
            f"number of blocks ({num_blocks}) must match number of shards ({nranks})"
        )
    starts = np.asarray(blocks_starts, dtype=np.int64)
    lengths = np.asarray(blocks_ends, dtype=np.int64) - starts + 1
    return starts, lengths
