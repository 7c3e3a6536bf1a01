"""ctypes bindings for the OpenMP ``.bed`` helper (``csrc/bedio.cpp``).

The port's own copy of ``hydra_tpu/native/__init__.py``: the same nine
entry points under the same names, argument types and returns. The
library is built with g++ at the first call (``ops/_build.load_host``),
on the CPU as on the card's host; a failed build raises, and nothing
falls back to numpy.

The load path runs ``bed_remove_individuals`` and ``bed_counts``
(``data/genotypes.py``) and ``bed_hpack`` (``ops/decode.hpack_bytes``);
``--bed-to-sparse`` runs ``bed_counts`` and ``bed_sparse_fill``
(``io/sparse.py``); ``bed_generate`` writes the simulated panels
(``io/simulate.py``). ``bed_decode``, ``bed_expand_planes``, ``bed_dot``
and ``bed_pack`` serve the tests: the port expands its planes on the card
(``ops/planes.build_planes``).

The plain versions that the load path's passes are held against live in
the port (``bed_counts``: ``data.genotypes.marker_counts``;
``bed_hpack``: ``ops.decode.hpack_bytes_ref``; ``bed_decode``:
``io.plink.decode_bed_numpy``; ``bed_remove_individuals``:
``io.plink.remove_individuals_packed``; ``bed_sparse_fill``: the converter
``io.sparse.write_sparse_files_ref``); those of the entry points that only
the tests call live in ``tests/test_torch_native.py``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        from hydra_tpu_torch.ops import _build

        lib = _build.load_host()
        i64 = ctypes.c_int64
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C")
        i8p = np.ctypeslib.ndpointer(np.int8, flags="C")
        lib.bed_counts.argtypes = [u8p, i64, i64, i64, i64p, i64p, i64p]
        lib.bed_decode.argtypes = [u8p, i64, i64, f32p, f32p]
        lib.bed_remove_individuals.argtypes = [u8p, i64, i64, i64, u8p, u8p,
                                               i64]
        lib.bed_sparse_fill.argtypes = [u8p, i64, i64, i64, i64p, i64p, i64p,
                                        u32p, u32p, u32p]
        lib.bed_dot.argtypes = [u8p, i64, i64, i64, f64p, f64p, f64p, f64p]
        lib.bed_pack.argtypes = [u8p, i64, i64, u8p, i64]
        lib.bed_generate.argtypes = [u8p, i64, i64, u8p, u8p, u8p, i64]
        lib.bed_expand_planes.argtypes = [u8p, i64, i64, i8p]
        lib.bed_hpack.argtypes = [u8p, i64, u8p]
        for fn in (lib.bed_counts, lib.bed_decode, lib.bed_remove_individuals,
                   lib.bed_sparse_fill, lib.bed_dot, lib.bed_pack,
                   lib.bed_generate, lib.bed_expand_planes, lib.bed_hpack):
            fn.restype = None
        _lib = lib
        return _lib


def _fits(n: int, nbytes: int) -> None:
    """The helper reads and writes the bytes that n and nbytes say,
    unchecked: n individuals must fit a row of nbytes."""
    if not 0 <= n <= 4 * nbytes:
        raise ValueError(f"{n} individuals do not fit {nbytes} bytes a row")


def _rows(packed: np.ndarray, n: Optional[int] = None) -> Tuple[int, int]:
    """(m, nbytes) of 2-D packed rows (holding n individuals)."""
    if packed.ndim != 2:
        raise ValueError(f"packed rows must be 2-D, got {packed.shape}")
    m, nbytes = packed.shape
    if n is not None:
        _fits(n, nbytes)
    return m, nbytes


def bed_counts(packed: np.ndarray, n: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(n1, n2, nm) int64 per marker over the first n individuals."""
    lib = _load()
    m, nbytes = _rows(packed, n)
    n1 = np.empty(m, np.int64)
    n2 = np.empty(m, np.int64)
    nm = np.empty(m, np.int64)
    lib.bed_counts(np.ascontiguousarray(packed), m, nbytes, n, n1, n2, nm)
    return n1, n2, nm


def bed_hpack(packed: np.ndarray) -> np.ndarray:
    """PLINK-coded bytes -> h-packed device bytes (OpenMP bitwise pass)."""
    lib = _load()
    pk = np.ascontiguousarray(packed)
    out = np.empty_like(pk)
    lib.bed_hpack(pk.reshape(-1), pk.size, out.reshape(-1))
    return out


def bed_decode(packed: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(geno, mask) float32 (m, 4 nbytes): every crumb, pads included."""
    lib = _load()
    m, nbytes = _rows(packed)
    geno = np.empty((m, nbytes * 4), np.float32)
    mask = np.empty((m, nbytes * 4), np.float32)
    lib.bed_decode(np.ascontiguousarray(packed), m, nbytes, geno, mask)
    return geno, mask


def bed_expand_planes(packed: np.ndarray) -> np.ndarray:
    """Flat-deinterleaved int8 planes: out[i, k nbytes + b] = the genotype
    of crumb k of byte b (the JAX package's plane layout)."""
    lib = _load()
    m, nbytes = _rows(packed)
    out = np.empty((m, nbytes * 4), np.int8)
    lib.bed_expand_planes(np.ascontiguousarray(packed), m, nbytes, out)
    return out


def bed_remove_individuals(packed: np.ndarray, n: int,
                           na_indices: np.ndarray) -> np.ndarray:
    """Drop individuals ``na_indices`` of the first n and repack; the tail
    crumbs of the last byte are coded missing."""
    lib = _load()
    m, nbytes = _rows(packed, n)
    keep = np.ones(n, np.uint8)
    keep[np.asarray(na_indices, np.int64)] = 0
    n_new = int(keep.sum())
    out_nbytes = (n_new + 3) // 4
    out = np.empty((m, out_nbytes), np.uint8)
    lib.bed_remove_individuals(np.ascontiguousarray(packed), m, nbytes, n,
                               keep, out, out_nbytes)
    return out


def bed_sparse_fill(packed: np.ndarray, n: int, s1, s2, sm, c1, c2, cm,
                    out=None):
    """The individuals of genotype 1, 2 and missing of each marker, marker
    j's at s[j] .. s[j] + c[j] of (i1, i2, im) uint32. out: optional
    (i1, i2, im) buffers to fill (capacity checked); reuse avoids the
    cold-page faults of fresh buffers a block."""
    lib = _load()
    m, nbytes = _rows(packed, n)
    if any(len(a) != m for a in (s1, s2, sm, c1, c2, cm)):
        raise ValueError(f"offsets and counts must hold {m} markers")
    need = (int(c1.sum()), int(c2.sum()), int(cm.sum()))
    if out is not None and all(b.size >= k for b, k in zip(out, need)):
        i1, i2, im = (b[:k] for b, k in zip(out, need))
    else:
        i1, i2, im = (np.empty(k, np.uint32) for k in need)
    lib.bed_sparse_fill(np.ascontiguousarray(packed), m, nbytes, n,
                        np.ascontiguousarray(s1, np.int64),
                        np.ascontiguousarray(s2, np.int64),
                        np.ascontiguousarray(sm, np.int64), i1, i2, im)
    return i1, i2, im


def bed_pack(geno: np.ndarray, nbytes: int) -> np.ndarray:
    """Integer genotypes {0, 1, 2} (anything else missing) -> BED bytes."""
    lib = _load()
    m, n = geno.shape
    _fits(n, nbytes)
    out = np.empty((m, nbytes), np.uint8)
    lib.bed_pack(np.ascontiguousarray(geno, np.uint8), m, n, out, nbytes)
    return out


def bed_generate(rand_bytes: np.ndarray, thr_a: np.ndarray, thr_b: np.ndarray,
                 nbytes: int) -> np.ndarray:
    """HWE genotype generation + packing: g = (u < a) + (u < b) per marker."""
    lib = _load()
    m, n = rand_bytes.shape
    _fits(n, nbytes)
    if len(thr_a) != m or len(thr_b) != m:
        raise ValueError(f"thresholds must hold {m} markers")
    out = np.empty((m, nbytes), np.uint8)
    lib.bed_generate(np.ascontiguousarray(rand_bytes), m, n,
                     np.ascontiguousarray(thr_a, np.uint8),
                     np.ascontiguousarray(thr_b, np.uint8), out, nbytes)
    return out


def bed_dot(packed: np.ndarray, n: int, eps: np.ndarray, mave: np.ndarray,
            mstd: np.ndarray) -> np.ndarray:
    """num_j = mstd_j (sum_i g_ji eps_i - mave_j sum_i m_ji eps_i) over the
    first n individuals, in float64."""
    lib = _load()
    m, nbytes = _rows(packed, n)
    if len(eps) > 4 * nbytes or len(mave) != m or len(mstd) != m:
        raise ValueError("eps must fit the rows; mave, mstd one a marker")
    num = np.empty(m, np.float64)
    eps_pad = np.zeros(nbytes * 4, np.float64)
    eps_pad[: len(eps)] = eps
    lib.bed_dot(np.ascontiguousarray(packed), m, nbytes, n, eps_pad,
                np.ascontiguousarray(mave, np.float64),
                np.ascontiguousarray(mstd, np.float64), num)
    return num
