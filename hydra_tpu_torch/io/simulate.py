"""Simulated PLINK panels: HWE genotypes packed by the OpenMP helper.

``write_panel`` writes ``base.bed/.bim/.fam`` and ``base.phen``: M markers
x N individuals, each marker's allele frequency p ~ U(0.05, 0.5), its
genotypes g = (u < a) + (u < b) of uniform bytes u with a = 256 p^2 and
b = 256 (2p - p^2) (``native.bed_generate``), calls missing independently
with probability ``missing``, and a phenotype of true heritability ``h2``
built as ``scripts/simulate_example.py`` builds ``normal.phen``: a fraction
``frac_causal`` of the markers causal with effects N(0, h2 / n_causal) on
the standardized genotypes (missing calls 0), the genetic values then
scaled to a sample variance of h2, plus noise of variance 1 - h2. ``na``
individuals get an "NA" phenotype.

Everything comes from ``seed``: blocks of markers are made on threads, each
from its own child of the seed's ``SeedSequence``, so the bytes do not
depend on the number of threads.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np

from hydra_tpu_torch import native
from hydra_tpu_torch.io.plink import BED_MAGIC, bed_bytes_per_marker


def thresholds(p: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-marker byte thresholds (a, b): P(g = 2) = a / 256 ~ p^2 and
    P(g >= 1) = b / 256 ~ 2p - p^2."""
    a = np.rint(256.0 * p * p).astype(np.uint8)
    b = np.rint(256.0 * (2.0 * p - p * p)).astype(np.uint8)
    return a, b


def _missing_positions(rng: np.random.Generator, total: int,
                       rate: float) -> np.ndarray:
    """Positions < total, each kept with probability rate (geometric gaps)."""
    if rate <= 0.0:
        return np.empty(0, np.int64)
    out, last = [], -1
    while True:
        k = int(total * rate + 6.0 * np.sqrt(total * rate) + 16)
        pos = last + np.cumsum(rng.geometric(rate, k))
        out.append(pos[pos < total])
        if pos[-1] >= total:
            return np.concatenate(out)
        last = int(pos[-1])


def set_missing(packed: np.ndarray, n: int, pos: np.ndarray) -> None:
    """Code the calls at flat positions pos (row n + individual) of
    (rows, nbytes) packed bytes missing (0b01), in place."""
    rows, cols = np.divmod(pos, n)
    byte = rows * packed.shape[1] + (cols >> 2)
    lane = cols & 3
    flat = packed.reshape(-1)
    for k in range(4):
        at = byte[lane == k]
        flat[at] = (flat[at] & np.uint8(~(3 << (2 * k)) & 0xFF)) | np.uint8(
            1 << (2 * k))


def packed_blocks(m: int, n: int, seed: int, missing: float = 0.0,
                  block: int = 2048, workers: Optional[int] = None
                  ) -> Iterator[Tuple[int, np.ndarray]]:
    """(first marker, packed rows) of the panel, a block of markers at a
    time, in marker order. Allele frequencies from ``default_rng(seed)``;
    block b's bytes and missing calls from child b of ``SeedSequence``
    (seed)."""
    p = np.random.default_rng(seed).uniform(0.05, 0.5, m)
    a, b = thresholds(p)
    nbytes = bed_bytes_per_marker(n)
    starts = list(range(0, m, block))
    children = np.random.SeedSequence(seed).spawn(len(starts))
    workers = workers or min(8, os.cpu_count() or 1)

    def draw(i):
        rng = np.random.default_rng(children[i])
        r0 = starts[i]
        rows = min(block, m - r0)
        u = rng.integers(0, 256, (rows, n), dtype=np.uint8)
        pk = native.bed_generate(u, a[r0:r0 + rows], b[r0:r0 + rows], nbytes)
        set_missing(pk, n, _missing_positions(rng, rows * n, missing))
        return pk

    with ThreadPoolExecutor(workers) as ex:
        for w0 in range(0, len(starts), workers):
            idx = range(w0, min(len(starts), w0 + workers))
            for i, pk in zip(idx, ex.map(draw, idx)):
                yield starts[i], pk


def write_panel(base: str, m: int, n: int, seed: int, missing: float = 0.0,
                h2: float = 0.5, frac_causal: float = 0.05, na: int = 0,
                block: int = 2048) -> dict:
    """Write base.bed/.bim/.fam/.phen (see the module docstring). Returns
    the truth: {"h2": var(g) / var(y) over the individuals with a
    phenotype, "n_causal", "na_indices"}."""
    rng = np.random.default_rng([seed, 1])
    n_causal = max(1, int(round(m * frac_causal)))
    causal = np.sort(rng.choice(m, n_causal, replace=False))
    beta = rng.standard_normal(n_causal) * np.sqrt(h2 / n_causal)
    gval = np.zeros(n, np.float64)
    with open(base + ".bed", "wb") as fh:
        fh.write(BED_MAGIC)
        for r0, pk in packed_blocks(m, n, seed, missing, block):
            pk.tofile(fh)
            sel = causal[(causal >= r0) & (causal < r0 + len(pk))]
            if len(sel):
                g, mk = native.bed_decode(pk[sel - r0])
                g, mk = g[:, :n].astype(np.float64), mk[:, :n]
                cnt = mk.sum(axis=1)
                mean = g.sum(axis=1) / np.maximum(cnt, 1.0)
                sd = np.sqrt(((g - mean[:, None] * mk) ** 2).sum(axis=1)
                             / np.maximum(cnt - 1.0, 1.0))
                sd = np.where(sd > 0, sd, 1.0)
                x = (g - mean[:, None] * mk) / sd[:, None]
                gval += x.T @ beta[np.searchsorted(causal, sel)]
    # the genetic values scaled to variance h2 (their sample variance, not
    # only in expectation), the noise of variance 1 - h2
    gval *= np.sqrt(h2 / gval.var()) if gval.var() > 0 else 0.0
    y = gval + rng.standard_normal(n) * np.sqrt(max(1e-6, 1.0 - h2))
    na_idx = np.sort(rng.choice(n, na, replace=False)) if na else np.empty(
        0, np.int64)
    has = np.ones(n, bool)
    has[na_idx] = False
    with open(base + ".fam", "w") as fh:
        fh.writelines(f"per{i} per{i} 0 0 0 -9\n" for i in range(n))
    with open(base + ".bim", "w") as fh:
        fh.writelines(f"1 rs{j} 0 {j + 1} A C\n" for j in range(m))
    with open(base + ".phen", "w") as fh:
        fh.writelines(f"per{i} per{i} {y[i]:.15f}\n" if has[i]
                      else f"per{i} per{i} NA\n" for i in range(n))
    return {"h2": float(gval[has].var() / y[has].var()),
            "n_causal": n_causal, "na_indices": na_idx}
