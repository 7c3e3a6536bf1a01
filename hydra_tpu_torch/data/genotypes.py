"""Dataset assembly: packed genotypes + phenotypes + groups, padded.

The port's own copy of ``hydra_tpu/data/genotypes.py``: read the ``.bed``
bytes (on marker shards only the rows of this rank's shard,
``marker_offset``/``marker_count``), apply the missing-phenotype correction (C8,
data.cpp:1112-1158 — drop individual columns and re-pack), compute marker
statistics (C9, BayesRRm.cpp:1502-1508) and pad individuals so the packed
width is a whole number of 128-byte tiles (pad codes = missing, so decoded
planes are zero there and contribute nothing to any reduction).

``GenotypeData``, ``Dataset``, ``make_default_groups``, ``shard_layout`` and
``pad_individuals`` keep the JAX package's names and behaviour. The host
passes run the port's OpenMP helper (``native.py``, ``csrc/bedio.cpp``):
``bed_remove_individuals`` for the missing-phenotype correction and
``bed_counts`` for the marker statistics, as the JAX package does;
``marker_counts`` and ``io.plink.remove_individuals_packed`` are their
plain numpy versions. ``load_dataset`` reads ``.bed`` or sparse input
(``io/sparse.py``).
"""

from __future__ import annotations

import fcntl
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from hydra_tpu_torch import native
from hydra_tpu_torch.io import plink
from hydra_tpu_torch.io import sparse as sparse_io
from hydra_tpu_torch.io.groups import assign_blocks_to_tasks
from hydra_tpu_torch.io.pheno import PhenoData
from hydra_tpu_torch.parallel import distributed

IND_ALIGN = 512          # individuals padded to multiple of this (128 bytes packed)
_PAD_BYTE = 0b01010101   # 4 missing codes


def pad_individuals(n: int) -> int:
    """Padded individual count: a multiple of IND_ALIGN whose packed width
    NB = 128*q has a divisor k in [4, 9] (the JAX package's tiling rule,
    ``hydra_tpu/data/genotypes.py::pad_individuals``). The port keeps it so
    both packages lay out the same n_pad for the same data; pads are
    missing-coded and masked everywhere, so it changes shapes only."""
    q0 = -(-n // IND_ALIGN)
    if q0 <= 36:
        return q0 * IND_ALIGN

    def best_k(q):
        return max((k for k in range(4, 10) if q % k == 0), default=0)

    cands = [(q, best_k(q)) for q in range(q0, q0 + 8)]
    for q, k in cands:
        if k >= 7:
            return q * IND_ALIGN
    for q, k in cands:
        if k:
            return q * IND_ALIGN
    return q0 * IND_ALIGN


def _pad_packed_columns(packed: np.ndarray, n: int, n_pad: int) -> np.ndarray:
    """Pad individuals to n_pad with missing codes (decode to zero planes)."""
    m, nbytes = packed.shape
    nbytes_pad = n_pad // 4
    out = np.full((m, nbytes_pad), _PAD_BYTE, dtype=np.uint8)
    out[:, :nbytes] = packed
    # Mark the tail of the last partially-used byte as missing
    rem = n % 4
    if rem:
        last = n // 4
        keep_mask = (1 << (2 * rem)) - 1
        out[:, last] = (packed[:, last] & keep_mask) | (_PAD_BYTE & ~keep_mask & 0xFF)
    return out


def marker_counts(packed: np.ndarray, n: int, block_bytes: int = 1 << 24
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(n1, n2, nm) per marker over the first n individuals: genotype-1,
    genotype-2 and missing counts, decoded a block of rows at a time so the
    host never holds a dense (M, N) plane. The plain version of
    ``native.bed_counts`` (float64 here)."""
    m, nb = packed.shape
    out = np.zeros((3, m), dtype=np.float64)
    step = max(1, block_bytes // max(4 * nb, 1))
    for r0 in range(0, m, step):
        geno, mask = plink.decode_bed_numpy(packed[r0:r0 + step], n)
        out[0, r0:r0 + step] = ((geno == 1.0) & (mask == 1.0)).sum(axis=1)
        out[1, r0:r0 + step] = (geno == 2.0).sum(axis=1)
        out[2, r0:r0 + step] = (mask == 0.0).sum(axis=1)
    return out[0], out[1], out[2]


@dataclass
class GenotypeData:
    """Packed genotypes for the full marker range."""
    packed: np.ndarray        # (M, N_pad // 4) uint8, NA-corrected, padded
    n: int                    # individuals after NA correction (Ntot - numNAs)
    n_pad: int
    m: int                    # markers (unpadded)
    mave: np.ndarray          # (M,) per-marker mean      (BayesRRm.cpp:1503)
    mstd: np.ndarray          # (M,) 1/sd                 (BayesRRm.cpp:1507)
    msd: np.ndarray           # (M,) sd                   (BayesW.cpp:1220)
    n1: np.ndarray
    n2: np.ndarray
    nm: np.ndarray
    # a rank that read only its shard's rows holds global markers
    # [marker_offset, marker_offset + m); m_tot and nm_tot are then the
    # global marker count and missing-call count
    marker_offset: int = 0
    m_tot: Optional[int] = None
    nm_tot: Optional[float] = None

    @property
    def m_global(self) -> int:
        return self.m if self.m_tot is None else self.m_tot

    @property
    def nm_global_sum(self) -> float:
        return (float(np.asarray(self.nm).sum())
                if self.nm_tot is None else self.nm_tot)

    @staticmethod
    def from_packed(packed: np.ndarray, n: int, na_indices: np.ndarray) -> "GenotypeData":
        if len(na_indices):
            packed = native.bed_remove_individuals(packed, n, na_indices)
            n = n - len(na_indices)
        m = packed.shape[0]
        n_pad = pad_individuals(n)
        packed = _pad_packed_columns(packed, n, n_pad)
        # over the first n individuals: the pad crumbs are coded missing
        n1, n2, nm = (c.astype(np.float64)
                      for c in native.bed_counts(packed, n))
        dn = float(n)
        with np.errstate(divide="ignore", invalid="ignore"):
            mave = (n1 + 2.0 * n2) / (dn - nm)
            var = (
                n1 * (1.0 - mave) ** 2
                + n2 * (2.0 - mave) ** 2
                + (dn - n1 - n2 - nm) * mave**2
            )
            mstd = np.sqrt((dn - 1.0) / var)
            msd = np.sqrt(var / (dn - 1.0))
        # Monomorphic markers have undefined std in the reference; disable them
        # cleanly here (zero weight) instead of propagating inf.
        bad = ~np.isfinite(mstd)
        mave[bad] = 0.0
        mstd[bad] = 0.0
        msd[bad] = 0.0
        return GenotypeData(packed, n, n_pad, m, mave, mstd, msd, n1, n2, nm)


@dataclass
class Dataset:
    geno: GenotypeData
    y: np.ndarray                       # (N,) phenotype, NA-compacted (not yet scaled)
    groups: np.ndarray                  # (M,) int32 marker -> group
    num_groups: int
    mS: np.ndarray                      # (G, K) mixture grid incl. 0.0 column
    fail: Optional[np.ndarray] = None   # (N,) failure indicators (BayesW)
    X: Optional[np.ndarray] = None      # (N, F) covariates
    priors: Optional[np.ndarray] = None     # (G, 2) sigmaG (v0, s0) priors
    d_priors: Optional[np.ndarray] = None   # (G, K) Dirichlet priors
    num_nas: int = 0
    blocks: Optional[Tuple[np.ndarray, np.ndarray]] = None  # custom shard blocks

    @property
    def n(self) -> int:
        return self.geno.n

    @property
    def m(self) -> int:
        return self.geno.m_global


def make_default_groups(m: int, S: List[float]) -> Tuple[np.ndarray, np.ndarray]:
    """Single group 0 with the --S grid, 0.0 prepended (BayesRRm.cpp:984-996)."""
    groups = np.zeros(m, dtype=np.int32)
    mS = np.asarray([[0.0] + list(S)], dtype=np.float64)
    if any(s <= 0.0 for s in S):
        raise ValueError("mixture value can only be strictly positive")
    return groups, mS


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
    sparse_basename: str = "",
    marker_offset: int = 0,
    marker_count: Optional[int] = None,
    n_ind: int = 1,
) -> Dataset:
    """Read genotypes (a PLINK trio, sparse files, or both) and assemble a
    Dataset (main.cpp:60-136; the JAX package's source selection,
    hydra_tpu/data/genotypes.py:185-250).

    Sparse files alone are rebuilt into packed bytes; with a .bed as well
    (the reference's mixed representation) the .bed is read and the
    sparse .dim must agree with it. Missing-phenotype individuals are
    dropped and re-packed, marker statistics computed and individuals
    padded exactly as the JAX package does (``GenotypeData.from_packed``).

    marker_count (a .bed only) reads the rows of global markers
    marker_offset .. + marker_count alone, this rank's shard (the MPI-IO
    reads of data.cpp:671-739): groups and phenotypes stay global, the
    rows and their statistics local, and the global missing-call count is
    summed over ranks in float64 (``allreduce_host_sum``), each shard's
    once: under ``--ind-shards`` n_ind the n_ind ranks of a shard read the
    same rows, and only the first of them adds its count."""
    local = marker_count is not None
    if local and not bed_basename:
        raise ValueError("a per-rank marker slice reads a .bed")
    if bed_basename:
        if n == 0 or m == 0:
            n = plink.read_fam(bed_basename + ".fam").n
            m = plink.read_bim(bed_basename + ".bim").m
        t0 = time.perf_counter()
        if local:
            # ranks on one host take turns: storage shared by concurrent
            # streams can fall far below one stream's rate (the JAX
            # package's flock, hydra_tpu/data/genotypes.py:215-227)
            with open(bed_basename + ".bed", "rb") as lk:
                fcntl.flock(lk, fcntl.LOCK_EX)
                packed = plink.read_bed(bed_basename + ".bed", n, m,
                                        marker_start=marker_offset,
                                        marker_count=marker_count)
                fcntl.flock(lk, fcntl.LOCK_UN)
        else:
            packed = plink.read_bed(bed_basename + ".bed", n, m)
        tl = time.perf_counter() - t0
        # data-load bandwidth log (BayesRRm.cpp:1420-1424)
        print(f"INFO   : rank {distributed.rank():3d} took {tl:.3f} seconds "
              f"to load  "
              f"{packed.nbytes} bytes  =>  BW = "
              f"{packed.nbytes * 1e-9 / max(tl, 1e-9):7.3f} GB/s", flush=True)
        if sparse_basename:
            sn, sm = sparse_io.read_dim(sparse_basename)
            if (sn, sm) != (n, m):
                raise ValueError(
                    f"mixed representation: sparse files are ({sm} x {sn}) "
                    f"but BED is ({m} x {n})")
            print("INFO   : mixed representation requested; the packed-BED "
                  "device format subsumes it (threshold-fnz moot, numerics "
                  "identical)", flush=True)
    elif sparse_basename:
        sp = sparse_io.read_sparse_files(sparse_basename)
        n, m = sp.n, sp.m
        packed = sparse_io.sparse_to_packed_bed(sp)
    else:
        raise ValueError("either BED, SPARSE or BOTH")  # main.cpp:134
    geno = GenotypeData.from_packed(packed, n, pheno.na_indices)
    if local:
        geno.marker_offset, geno.m_tot = marker_offset, m
        first = distributed.rank() % n_ind == 0
        geno.nm_tot = distributed.allreduce_host_sum(
            float(np.asarray(geno.nm).sum()) if first else 0.0)
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


def shard_layout(
    mtot: int, n_dev: int, window: int,
    blocks: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Compute (starts, lengths, m_loc_pad) for marker sharding.

    Equal split like mpi_define_blocks_of_markers (BayesRRm.cpp:396-413), or a
    user block file (mpi_assign_blocks_to_tasks :781-827). Every shard is
    padded to the same m_loc_pad = ceil(max_len / window) * window so the
    windowed sweep is uniform (pad slots contribute zero deltas, mirroring
    BayesRRm.cpp:2029-2034).
    """
    if blocks is not None:
        starts, lengths = assign_blocks_to_tasks(
            len(blocks[0]), blocks[0], blocks[1], mtot, n_dev
        )
    else:
        starts, lengths = assign_blocks_to_tasks(0, None, None, mtot, n_dev)
    max_len = int(lengths.max())
    m_loc_pad = ((max_len + window - 1) // window) * window
    return starts, lengths, m_loc_pad


def marker_shards(
    mtot: int, n_dev: int, rank: int, window: int,
    blocks: Optional[Tuple[np.ndarray, np.ndarray]] = None, n_ind: int = 1,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """``shard_layout`` for marker shard ``rank`` of ``n_dev``, each shard
    held by ``n_ind`` ranks (``--ind-shards``: the grid's rank r holds shard
    r // n_ind), refused up front with the reason where it cannot run: a
    shard outside 0..n_dev-1, n_dev n_ind > 1 without a process group of
    that many ranks, or a shard left without markers (M < D * W; the JAX
    ``_mp_marker_slice`` raises a bare ValueError, hydra_tpu/runner.py:84).
    The runner and every sampler call it, so the rows a rank reads are the
    rows its sampler lays out."""
    if not 0 <= rank < n_dev:
        raise ValueError(f"rank {rank} is outside 0..{n_dev - 1}")
    if n_dev * n_ind > 1 and distributed.world_size() != n_dev * n_ind:
        raise RuntimeError(
            f"{n_dev} marker shards x {n_ind} chunks of individuals need a "
            f"process group of {n_dev * n_ind} ranks (this process sees "
            f"{distributed.world_size()}); launch with "
            "scripts/run_multiprocess_torch.py or torchrun")
    starts, lengths, m_loc = shard_layout(mtot, n_dev, window, blocks)
    empty = [d for d in range(n_dev) if lengths[d] == 0]
    if empty:
        raise ValueError(f"{mtot} markers over {n_dev} ranks leave rank(s) "
                         f"{empty} without markers; run fewer ranks")
    return starts, lengths, m_loc


def ind_chunk(n_pad: int, n_ind: int) -> Tuple[int, int]:
    """(length, n_loc) of a chunk of individuals under ``--ind-shards``
    n_ind: the JAX layout's n_pad / n_ind individuals a chunk (chunk c holds
    individuals c length .. (c + 1) length), and the rank's padded length
    n_loc, a multiple of IND_ALIGN (the CUDA kernels take whole 128-byte
    packed rows). An n_pad that does not split in whole bytes raises with
    the JAX sampler's message (hydra_tpu/samplers/bayesrrm.py:995-998)."""
    if n_pad % (4 * n_ind):
        raise ValueError(
            f"individual padding {n_pad} not divisible by "
            f"4*n_ind={4 * n_ind}; use a power-of-two inds axis <= 128")
    length = n_pad // n_ind
    return length, -(-length // IND_ALIGN) * IND_ALIGN


def chunk_columns(packed, n_pad: int, n_ind: int, chunk: int, pad_byte):
    """The byte columns of individual chunk ``chunk`` of packed rows
    (rows, n_pad / 4), padded to n_loc / 4 bytes with ``pad_byte`` (four
    missing codes: PLINK 0x55, h-packed 0xFF), so pad individuals decode to
    zero genotype and mask. numpy or torch rows alike."""
    length, n_loc = ind_chunk(n_pad, n_ind)
    b0, nb = chunk * length // 4, length // 4
    rows = packed[:, b0:b0 + nb]
    if n_loc == length:
        return rows
    if isinstance(rows, np.ndarray):
        out = np.full((rows.shape[0], n_loc // 4), pad_byte, dtype=np.uint8)
    else:
        import torch

        out = torch.full((rows.shape[0], n_loc // 4), pad_byte,
                         dtype=torch.uint8, device=rows.device)
    out[:, :nb] = rows
    return out


def chunk_rows(x: np.ndarray, n_ind: int, chunk: int) -> np.ndarray:
    """Individual chunk ``chunk`` of an individual-indexed array (n_pad,
    ...), zero-padded to n_loc rows (``ind_chunk``)."""
    length, n_loc = ind_chunk(x.shape[0], n_ind)
    out = np.zeros((n_loc,) + x.shape[1:], dtype=x.dtype)
    out[:length] = x[chunk * length:(chunk + 1) * length]
    return out
