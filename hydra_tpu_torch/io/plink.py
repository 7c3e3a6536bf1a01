"""PLINK file readers/writers (.fam, .bim, .bed, .dim).

Behavioral equivalents of the reference's Data::readFamFile (data.cpp:1443),
Data::readBimFile (data.cpp:1470) and the BED byte handling used by
load_data_from_bed_file (data.cpp:671-739). The port's own copy of
``hydra_tpu/io/plink.py`` (same names and behaviour).

The 2-bit BED coding, as interpreted by the reference (data.cpp:879-884 —
"inverted" relative to PLINK's docs because hydra counts allele1):

    bits 00 -> genotype 2
    bits 01 -> missing
    bits 10 -> genotype 1
    bits 11 -> genotype 0

Individuals are packed 4 per byte, LSB-first; each marker occupies
ceil(N/4) bytes; the file starts with the 3 magic bytes 0x6c 0x1b 0x01.

The packed bytes are the on-device representation (decoded inside the
kernels), so the reader returns the raw (M, ceil(N/4)) uint8 array.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

BED_MAGIC = b"\x6c\x1b\x01"

# code -> genotype value (missing -> 0) and validity mask, matching
# dotp_lut_a / dotp_lut_b (src/dotp_lut.h:3,1031; generator src/mk_lut.cpp:7-73)
CODE_TO_GENO = np.array([2.0, 0.0, 1.0, 0.0])   # lut_a row pattern
CODE_TO_MASK = np.array([1.0, 0.0, 1.0, 1.0])   # lut_b row pattern (0 = missing)
MISSING_CODE = 1


@dataclass
class FamInfo:
    fid: List[str]
    pid: List[str]
    sex: np.ndarray

    @property
    def n(self) -> int:
        return len(self.fid)


@dataclass
class BimInfo:
    chrom: List[str]
    snp_id: List[str]
    gen_pos: np.ndarray
    phys_pos: np.ndarray
    allele1: List[str]
    allele2: List[str]

    @property
    def m(self) -> int:
        return len(self.snp_id)


def read_fam(path: str) -> FamInfo:
    """Read a .fam file; duplicate (fid,pid) IDs are an error (data.cpp:1455-1458)."""
    fid, pid, sex = [], [], []
    seen = set()
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            key = parts[0] + ":" + parts[1]
            if key in seen:
                raise ValueError(f"Duplicate individual ID found: {parts[0]}\t{parts[1]}")
            seen.add(key)
            fid.append(parts[0])
            pid.append(parts[1])
            sex.append(int(parts[4]))
    return FamInfo(fid, pid, np.asarray(sex, dtype=np.int32))


def read_bim(path: str) -> BimInfo:
    """Read a .bim file; duplicate SNP IDs are an error (data.cpp:1485-1488)."""
    chrom, snp, a1, a2 = [], [], [], []
    gpos, ppos = [], []
    seen = set()
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[1] in seen:
                raise ValueError(f"Duplicate SNP ID found: {parts[1]}")
            seen.add(parts[1])
            chrom.append(parts[0])
            snp.append(parts[1])
            gpos.append(float(parts[2]))
            ppos.append(int(parts[3]))
            a1.append(parts[4])
            a2.append(parts[5])
    return BimInfo(chrom, snp, np.asarray(gpos), np.asarray(ppos, dtype=np.int64), a1, a2)


def bed_bytes_per_marker(n: int) -> int:
    """snpLenByt (BayesRRm.cpp:1010)."""
    return (n + 3) // 4


def read_bed(
    path: str,
    n_individuals: int,
    n_markers: int,
    marker_start: int = 0,
    marker_count: Optional[int] = None,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Read a slice of markers from a .bed file as packed bytes.

    Returns uint8 array of shape (marker_count, ceil(N/4)). Equivalent data
    source as Data::load_data_from_bed_file (data.cpp:671-739) but without
    conversion to sparse index lists — packed bytes are the native
    device representation.
    """
    nbytes = bed_bytes_per_marker(n_individuals)
    if marker_count is None:
        marker_count = n_markers - marker_start
    expected = 3 + nbytes * n_markers
    actual = os.path.getsize(path)
    if actual != expected:
        raise ValueError(
            f"BED size mismatch for {path}: expected {expected} bytes "
            f"(3 + {n_markers}x{nbytes}), found {actual}"
        )  # mirrors check_file_size (mpi_utils.hpp:52-67)
    nb = marker_count * nbytes
    if out is not None and out.size >= nb:
        # reuse caller's buffer: fresh page faults cost ~6 s/GB on cloud VMs,
        # dominating blockwise streaming reads (measured: np copy into a cold
        # mmap runs 0.17 GB/s vs 9.3 GB/s warm)
        dst = out.reshape(-1)[:nb]
    else:
        dst = np.empty(nb, dtype=np.uint8)
    with open(path, "rb") as fh:
        magic = fh.read(3)
        if magic != BED_MAGIC:
            raise ValueError(f"{path} is not a SNP-major PLINK .bed file")
        fh.seek(3 + marker_start * nbytes)
        got = fh.readinto(memoryview(dst))
        if got != nb:
            raise ValueError(f"short read from {path}: {got} < {nb}")
    return dst.reshape(marker_count, nbytes)


def write_bed(path: str, genotypes: np.ndarray) -> None:
    """Write integer genotypes (M, N) with values {0,1,2, -1=missing} as .bed."""
    geno_to_code = {0: 0b11, 1: 0b10, 2: 0b00, -1: 0b01}
    m, n = genotypes.shape
    nbytes = bed_bytes_per_marker(n)
    codes = np.empty((m, n), dtype=np.uint8)
    for g, c in geno_to_code.items():
        codes[genotypes == g] = c
    padded = np.full((m, nbytes * 4), MISSING_CODE, dtype=np.uint8)
    padded[:, :n] = codes
    b = (
        padded[:, 0::4]
        | (padded[:, 1::4] << 2)
        | (padded[:, 2::4] << 4)
        | (padded[:, 3::4] << 6)
    )
    with open(path, "wb") as fh:
        fh.write(BED_MAGIC)
        fh.write(b.astype(np.uint8).tobytes())


def read_dim(path: str) -> Tuple[int, int]:
    """Read a .dim file: 'N M' (example/t_M10K_N_5K.dim, set_Ntot/set_Mtot
    via --number-individuals/--number-markers)."""
    with open(path) as fh:
        parts = fh.read().split()
    return int(parts[0]), int(parts[1])


def decode_bed_numpy(packed: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Reference decode of packed BED bytes to (genotypes, mask) — NumPy
    golden path used by tests and host-side tools.

    Returns (geno, mask) float64 arrays of shape (M, N): geno has missing as 0,
    mask is 0 where missing else 1 — exactly dotp_lut_a/dotp_lut_b semantics.
    """
    m, nbytes = packed.shape
    codes = np.empty((m, nbytes * 4), dtype=np.uint8)
    codes[:, 0::4] = packed & 3
    codes[:, 1::4] = (packed >> 2) & 3
    codes[:, 2::4] = (packed >> 4) & 3
    codes[:, 3::4] = (packed >> 6) & 3
    codes = codes[:, :n]
    return CODE_TO_GENO[codes], CODE_TO_MASK[codes]


def remove_individuals_packed(packed: np.ndarray, n: int, na_indices: np.ndarray) -> np.ndarray:
    """Drop individuals (missing phenotypes) from packed BED data, repacking.

    Equivalent outcome to Data::sparse_data_correct_for_missing_phenotype
    (data.cpp:1112-1158) which renumbers sparse indices; here we re-pack the
    2-bit codes with the NA columns removed.
    """
    if len(na_indices) == 0:
        return packed
    m, nbytes = packed.shape
    codes = np.empty((m, nbytes * 4), dtype=np.uint8)
    codes[:, 0::4] = packed & 3
    codes[:, 1::4] = (packed >> 2) & 3
    codes[:, 2::4] = (packed >> 4) & 3
    codes[:, 3::4] = (packed >> 6) & 3
    keep = np.ones(n, dtype=bool)
    keep[np.asarray(na_indices, dtype=np.int64)] = False
    codes = codes[:, :n][:, keep]
    n_new = codes.shape[1]
    nbytes_new = bed_bytes_per_marker(n_new)
    padded = np.full((m, nbytes_new * 4), MISSING_CODE, dtype=np.uint8)
    padded[:, :n_new] = codes
    return (
        padded[:, 0::4]
        | (padded[:, 1::4] << 2)
        | (padded[:, 2::4] << 4)
        | (padded[:, 3::4] << 6)
    ).astype(np.uint8)
