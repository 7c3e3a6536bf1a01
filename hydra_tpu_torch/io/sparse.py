"""hydra sparse-genotype files: reader, writer and the packed-byte rebuild.

The port's own copy of ``hydra_tpu/io/sparse.py`` (same files, same bytes).
The converter runs the OpenMP helper (``native.bed_counts`` and
``native.bed_sparse_fill``), the readers numpy. The reference's 9-file
representation (write_sparse_data_files BayesRRm.cpp:437-770;
load_data_from_sparse_files data.cpp:742-823):

    basename.ss{1,2,m}  per-marker start offsets   (uint64, Mtot entries)
    basename.sl{1,2,m}  per-marker element counts  (uint64, Mtot entries)
    basename.si{1,2,m}  individual indices         (uint32, concatenated)
    basename.dim        text "N M"

Index lists hold the individuals whose genotype is 1 ("1"), 2 ("2") or
missing ("m"); zeros are implicit. The port computes on packed bytes, so
sparse input is rebuilt into them (``sparse_to_packed_bed``) and the
chain is the one of the ``.bed`` the files came from; ``write_sparse_files``
is the ``--bed-to-sparse`` converter.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from hydra_tpu_torch import native
from hydra_tpu_torch.io.plink import (MISSING_CODE, bed_bytes_per_marker,
                                      decode_bed_numpy, read_bed)

TAGS = ("1", "2", "m")


@dataclass
class SparseGenotypes:
    n: int
    m: int
    s1: np.ndarray  # starts, uint64 (local to this slice)
    l1: np.ndarray  # lengths, uint64
    i1: np.ndarray  # indices, uint32
    s2: np.ndarray
    l2: np.ndarray
    i2: np.ndarray
    sm: np.ndarray
    lm: np.ndarray
    im: np.ndarray


def write_sparse_files(bed_path: str, n: int, m: int, out_basename: str,
                       block_size: int = 8192) -> None:
    """Convert a .bed to the 9-file sparse representation (--bed-to-sparse),
    as the JAX package's converter (``hydra_tpu/io/sparse.py:60-160``): a
    block of markers at a time, ``bed_counts`` sizing each marker's slices
    and ``bed_sparse_fill`` writing the individuals in parallel over
    markers. The block's bytes and three rotating sets of index buffers are
    reused from block to block (fresh pages fault in slowly on cloud
    hosts), and a writer thread appends a block's ``.si`` bytes while the
    next block is read, counted and filled; its error is raised after the
    join. With a queue of depth 1, set k is idle again by the time block
    k + 3 fills it. ``write_sparse_files_ref`` is the plain version."""
    files = {t: open(out_basename + f".si{t}", "wb") for t in TAGS}
    starts = {t: [] for t in TAGS}
    lengths = {t: [] for t in TAGS}
    offs = dict.fromkeys(TAGS, 0)
    pk_buf = np.empty(block_size * bed_bytes_per_marker(n), np.uint8)
    idx_sets = [[np.empty(0, np.uint32) for _ in TAGS] for _ in range(3)]
    wq: "queue.Queue" = queue.Queue(maxsize=1)
    werr = []

    def writer():
        while True:
            item = wq.get()
            if item is None:
                return
            try:
                for fh, view in item:
                    fh.write(view)
            except Exception as e:  # raised after the join
                werr.append(e)

    wthread = threading.Thread(target=writer, daemon=True)
    wthread.start()
    try:
        for bi, blk_start in enumerate(range(0, m, block_size)):
            blk = min(block_size, m - blk_start)
            packed = read_bed(bed_path, n, m, blk_start, blk, out=pk_buf)
            counts = native.bed_counts(packed, n)
            local = [np.concatenate(([0], np.cumsum(c[:-1], dtype=np.int64)))
                     for c in counts]
            bufs = idx_sets[bi % 3]
            for k, cnt in enumerate(counts):
                need = int(cnt.sum())
                if bufs[k].size < need:
                    bufs[k] = np.empty(int(need * 1.3), np.uint32)
            idx = native.bed_sparse_fill(packed, n, *local, *counts,
                                         out=bufs)
            wq.put([(files[t], memoryview(i)) for t, i in zip(TAGS, idx)])
            for tag, first, cnt in zip(TAGS, local, counts):
                starts[tag].extend((offs[tag] + first).tolist())
                lengths[tag].extend(cnt.tolist())
                offs[tag] += int(cnt.sum())
    finally:
        wq.put(None)
        wthread.join()
        for fh in files.values():
            fh.close()
    if werr:
        raise werr[0]
    _write_index_files(out_basename, n, m, starts, lengths)


def _write_index_files(out_basename, n, m, starts, lengths):
    for tag in TAGS:
        np.asarray(starts[tag], dtype=np.uint64).tofile(
            out_basename + f".ss{tag}")
        np.asarray(lengths[tag], dtype=np.uint64).tofile(
            out_basename + f".sl{tag}")
    with open(out_basename + ".dim", "w") as fh:
        fh.write(f"{n} {m}\n")


def write_sparse_files_ref(bed_path: str, n: int, m: int, out_basename: str,
                           block_size: int = 8192) -> None:
    """Plain version of ``write_sparse_files``: a block of markers at a
    time decoded with numpy, each tag's indices by ``np.nonzero``."""
    starts = {t: [] for t in TAGS}
    lengths = {t: [] for t in TAGS}
    offs = dict.fromkeys(TAGS, 0)
    files = {t: open(out_basename + f".si{t}", "wb") for t in TAGS}
    try:
        for blk_start in range(0, m, block_size):
            blk = min(block_size, m - blk_start)
            geno, mask = decode_bed_numpy(
                read_bed(bed_path, n, m, blk_start, blk), n)
            for tag, sel in (("1", (geno == 1.0) & (mask == 1.0)),
                             ("2", (geno == 2.0) & (mask == 1.0)),
                             ("m", mask == 0.0)):
                # row-major nonzero: each marker's individuals, in order
                files[tag].write(np.nonzero(sel)[1].astype(np.uint32)
                                 .tobytes())
                cnt = sel.sum(axis=1).astype(np.int64)
                first = offs[tag] + np.concatenate(([0], np.cumsum(cnt)[:-1]))
                starts[tag].extend(first.tolist())
                lengths[tag].extend(cnt.tolist())
                offs[tag] += int(cnt.sum())
    finally:
        for fh in files.values():
            fh.close()
    _write_index_files(out_basename, n, m, starts, lengths)


def read_dim(basename: str) -> Tuple[int, int]:
    """(N, M) from the text .dim file (data.cpp:1072-1079)."""
    with open(basename + ".dim") as fh:
        parts = fh.read().split()
    return int(parts[0]), int(parts[1])


def read_sparse_files(basename: str, marker_start: int = 0,
                      marker_count: Optional[int] = None) -> SparseGenotypes:
    """Read a marker slice from sparse files (data.cpp:742-823,
    :1072-1106)."""
    n, m = read_dim(basename)
    if marker_count is None:
        marker_count = m - marker_start

    def load(tag: str):
        ss = np.fromfile(basename + f".ss{tag}", dtype=np.uint64,
                         count=marker_count, offset=marker_start * 8)
        sl = np.fromfile(basename + f".sl{tag}", dtype=np.uint64,
                         count=marker_count, offset=marker_start * 8)
        n_elem = int(ss[-1] + sl[-1] - ss[0]) if marker_count > 0 else 0
        si = np.fromfile(basename + f".si{tag}", dtype=np.uint32,
                         count=n_elem, offset=int(ss[0]) * 4 if marker_count
                         else 0)
        return ss - ss[0] if marker_count > 0 else ss, sl, si

    s1, l1, i1 = load("1")
    s2, l2, i2 = load("2")
    sm, lm, im = load("m")
    return SparseGenotypes(n, marker_count, s1, l1, i1, s2, l2, i2, sm, lm,
                           im)


def sparse_to_packed_bed(sp: SparseGenotypes) -> np.ndarray:
    """Packed PLINK bytes from the index lists (get_bed_marker_from_sparse,
    data.cpp:826-865). Codes: 0 -> 0b11, 1 -> 0b10, 2 -> 0b00, missing ->
    0b01; pad crumbs missing."""
    m, n = sp.m, sp.n
    nbytes = bed_bytes_per_marker(n)
    codes = np.full((m, nbytes * 4), MISSING_CODE, dtype=np.uint8)
    codes[:, :n] = 0b11                                  # default genotype 0
    for code, s, ln, idx in ((0b10, sp.s1, sp.l1, sp.i1),
                             (0b00, sp.s2, sp.l2, sp.i2),
                             (MISSING_CODE, sp.sm, sp.lm, sp.im)):
        ln = ln.astype(np.int64)
        rows = np.repeat(np.arange(m), ln)
        # element k of marker j sits at s[j] + k
        pos = (np.repeat(s.astype(np.int64), ln) + np.arange(len(rows))
               - np.repeat(np.cumsum(ln) - ln, ln))
        codes[rows, idx[pos]] = code
    return (codes[:, 0::4] | (codes[:, 1::4] << 2) | (codes[:, 2::4] << 4)
            | (codes[:, 3::4] << 6)).astype(np.uint8)
