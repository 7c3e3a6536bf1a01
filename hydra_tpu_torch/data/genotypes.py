"""Dataset assembly for the port: ``load_dataset`` on the reused readers.

Counterpart of ``hydra_tpu.data.genotypes.load_dataset`` for one process.
The JAX version logs its load bandwidth through ``jax.process_index()`` on the
plain ``.bed`` path and has a multi-process branch; this one does neither, so
it runs where JAX is not installed. Types and helpers (``GenotypeData``,
``Dataset``, ``make_default_groups``) are the reference's own.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np

from hydra_tpu.data.genotypes import Dataset, GenotypeData, make_default_groups
from hydra_tpu.io import plink
from hydra_tpu.io.pheno import PhenoData


def load_dataset(
    bed_basename: str,
    pheno: PhenoData,
    n: int = 0,
    m: int = 0,
    groups: Optional[np.ndarray] = None,
    mS: Optional[np.ndarray] = None,
    S: Optional[List[float]] = None,
    priors: Optional[np.ndarray] = None,
    d_priors: Optional[np.ndarray] = None,
    blocks: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> Dataset:
    """Read a PLINK trio and assemble a Dataset (main.cpp:60-136, .bed only).

    Missing-phenotype individuals are dropped and re-packed, marker
    statistics computed and individuals padded exactly as the reference
    package does (``GenotypeData.from_packed``)."""
    if not bed_basename:
        raise ValueError("a .bed basename is required")
    if n == 0 or m == 0:
        n = plink.read_fam(bed_basename + ".fam").n
        m = plink.read_bim(bed_basename + ".bim").m
    t0 = time.perf_counter()
    packed = plink.read_bed(bed_basename + ".bed", n, m)
    tl = time.perf_counter() - t0
    # data-load bandwidth log (BayesRRm.cpp:1420-1424)
    print(f"INFO   : rank   0 took {tl:.3f} seconds to load  {packed.nbytes} "
          f"bytes  =>  BW = {packed.nbytes * 1e-9 / max(tl, 1e-9):7.3f} GB/s",
          flush=True)
    geno = GenotypeData.from_packed(packed, n, pheno.na_indices)
    if groups is None or mS is None:
        groups, mS = make_default_groups(m, S or [0.01, 0.001, 0.0001])
    if len(groups) != m:
        raise ValueError(f"group file covers {len(groups)} markers, expected {m}")
    num_groups = int(mS.shape[0])
    if groups.max(initial=0) >= num_groups:
        raise ValueError("group index exceeds number of groups in mixture file")
    return Dataset(
        geno=geno,
        y=pheno.y,
        groups=np.asarray(groups, dtype=np.int32),
        num_groups=num_groups,
        mS=np.asarray(mS, dtype=np.float64),
        fail=pheno.fail,
        X=pheno.X,
        priors=priors,
        d_priors=d_priors,
        num_nas=pheno.num_nas,
        blocks=blocks,
    )
