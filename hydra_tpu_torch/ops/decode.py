"""h-packed genotype bytes and their plain torch decode.

The device format is the reference package's "hpack" (``hydra_tpu/ops/
decode.py``): each 2-bit crumb stores h = 2 - genotype, 3 = missing, and
crumb k of byte b is individual 4b + k. ``hpack_bytes`` runs the OpenMP
helper's ``bed_hpack`` (``native.py``), as that module's does;
``hpack_bytes_ref`` is its plain numpy version.

``decode_planes_hp`` / ``decode_planes`` are the plain decode the plain sweep
versions use; the CUDA kernels decode crumbs in registers instead
(``csrc/sweep_kernel.cuh``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from hydra_tpu_torch import native


def hpack_bytes(packed: np.ndarray) -> np.ndarray:
    """PLINK-coded packed bytes -> h-packed device bytes (the helper's
    ``bed_hpack``, an OpenMP pass; same shape)."""
    return native.bed_hpack(packed)


def hpack_bytes_ref(packed: np.ndarray) -> np.ndarray:
    """Plain version of ``hpack_bytes``: the bitwise form of the crumb map
    0->0, 1->3, 2->1, 3->2, out = (L << 1) | (L ^ H) with L/H the crumb
    low/high bit planes."""
    lo = packed & np.uint8(0x55)
    hi = (packed >> np.uint8(1)) & np.uint8(0x55)
    return ((lo << np.uint8(1)) | (lo ^ hi)).astype(np.uint8)


def crumbs(packed: torch.Tensor) -> torch.Tensor:
    """(..., NB) uint8 -> (..., 4*NB) int32 crumb codes, individual order."""
    b = packed.to(torch.int32)
    codes = torch.stack([(b >> (2 * k)) & 3 for k in range(4)], dim=-1)
    return codes.reshape(*packed.shape[:-1], -1)


def decode_h(packed: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Raw h crumbs of h-packed bytes (complete data: h = 2 - g; pads are 3)."""
    return crumbs(packed).to(dtype)


def decode_planes_hp(packed: torch.Tensor, dtype=torch.float32
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h-packed bytes -> (geno, mask): geno = (2 - c) * mask, mask = (c != 3)."""
    c = crumbs(packed)
    mask = 1 - ((c + 1) >> 2)
    return ((2 - c) * mask).to(dtype), mask.to(dtype)


def decode_planes(packed: torch.Tensor, dtype=torch.float32
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PLINK-coded bytes -> (geno, mask): code 0 -> (2,1), 1 -> (0,0),
    2 -> (1,1), 3 -> (0,1)."""
    c = crumbs(packed)
    geno = torch.where(c == 0, 2, torch.where(c == 2, 1, 0))
    return geno.to(dtype), (c != 1).to(dtype)


def standardized_window(packed: torch.Tensor, mave: torch.Tensor,
                        mstd: torch.Tensor, dtype=torch.float32
                        ) -> torch.Tensor:
    """x~ = mstd * (g - mave * m) for a window of h-packed rows: (W, NB)
    uint8 -> (W, 4*NB) ``dtype`` (``hydra_tpu/ops/decode.py::
    standardized_window`` on the port's device bytes; pad and missing
    individuals are 0)."""
    g, m = decode_planes_hp(packed, dtype)
    return (g - mave.to(dtype)[:, None] * m) * mstd.to(dtype)[:, None]

