"""Cached decoded genotype planes: BayesRRm's per-window branch with
``--cache-planes on`` (stale windows, complete genotypes).

Port of ``hydra_tpu/ops/planes.py``. The genotypes are decoded once, on the
device, into int8 planes (M, n_pad) in INDIVIDUAL order (0/1/2; missing
genotypes and pad individuals 0); each window then streams one byte per
genotype instead of decoding 2-bit crumbs. The JAX package's
flat-deinterleaved layout was a TPU workaround and is not kept: here the
residual pairs with a plane row as it is. So is the JAX package's host
expansion of the planes (its OpenMP ``bed_expand_planes``, there for the
TPU's slow host link): the port binds and tests it (``native.py``), but
``build_planes`` decodes on the card.

  build_planes(pk) -> (M, 4*NB) int8 planes of h-packed rows
  window_stats_planes(planes, eps, rows) -> s1 (W,) = planes[rows] @ eps
  window_axpy_planes(planes, c1, rows) -> sum_r c1_r planes[rows_r], the
      genotype part of dε; the caller adds sum(c2) and masks:
          d_eps = (window_axpy_planes(...) + c2.sum()) * ind_mask

``rows`` (W,) int32 names the window's slots (read in place on the device);
None means all rows. For CUDA tensors the wrappers launch the kernels of
``csrc/planes_kernel.cu``, one launch a call each; for CPU tensors they run
the plain versions ``*_ref``, which add in the kernels' order (the stats
per 2,048-individual tile, lane by lane, then the warp's xor butterfly and
the tiles in order; the axpy row by row), so on the card the two agree bit
for bit. The stats kernel adds its tiles' partials in the launch (a
last-block ticket a row group): its partials and counters live in one
workspace a (device, stream), allocated zeroed on first use and grown when
a larger window or width needs it; the kernel leaves the counters at 0.
Calls on one stream run in turn, so they share it safely.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hydra_tpu_torch.ops.decode import hpack_bytes
from hydra_tpu_torch.ops.window_kernels import seq_sum, tile_sums

f32 = torch.float32

# Kernel launches through each wrapper (one per window of the planes path).
launches = {"window_stats_planes": 0, "window_axpy_planes": 0}

# (device index, stream handle) -> the stats kernel's workspace (uint8):
# ticket counters, then tile partials
_workspace = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lut() -> np.ndarray:
    """PLINK byte -> its four genotypes (256, 4) int8: codes 00 -> 2,
    10 -> 1, 11 -> 0, 01 (missing / pad) -> 0. The port's copy of
    ``hydra_tpu/ops/planes.py::_lut``."""
    codes = (np.arange(256, dtype=np.uint16)[:, None]
             >> (2 * np.arange(4, dtype=np.uint16)[None, :])) & 3
    return np.choose(codes, [2, 0, 1, 0]).astype(np.int8)


def hpack_lut() -> np.ndarray:
    """h-packed byte -> its four genotypes (256, 4) int8 (the device bytes;
    ``hpack_bytes`` maps bytes one to one)."""
    out = np.empty((256, 4), dtype=np.int8)
    out[hpack_bytes(np.arange(256, dtype=np.uint8))] = _lut()
    return out


def build_planes(pk: torch.Tensor, block: int = 2048) -> torch.Tensor:
    """(M, NB) h-packed rows -> (M, 4*NB) int8 planes on pk's device,
    decoded ``block`` rows at a time."""
    if pk.dtype != torch.uint8 or pk.dim() != 2:
        raise ValueError(f"pk must be (M, NB) uint8, got {pk.dtype} "
                         f"{tuple(pk.shape)}")
    m, nb = pk.shape
    lut = torch.from_numpy(hpack_lut()).to(pk.device)
    out = torch.empty((m, 4 * nb), dtype=torch.int8, device=pk.device)
    for r0 in range(0, m, block):
        r1 = min(m, r0 + block)
        out[r0:r1] = lut[pk[r0:r1].to(torch.int64)].reshape(r1 - r0, -1)
    return out


def _check(planes, rows):
    if planes.dtype != torch.int8 or planes.dim() != 2:
        raise ValueError(f"planes must be (M, n_pad) int8, got {planes.dtype} "
                         f"{tuple(planes.shape)}")
    if rows is not None and (rows.dim() != 1 or rows.dtype not in (
            torch.int32, torch.int64)):
        raise ValueError("rows must be (W,) int32")
    return planes.shape[0] if rows is None else rows.shape[0]


def _rows(planes, rows):
    return planes if rows is None else planes[rows.to(torch.int64)]


def _check_vec(x, name, n):
    if x.dtype != f32 or tuple(x.shape) != (n,):
        raise ValueError(f"{name} must be ({n},) float32, got {x.dtype} "
                         f"{tuple(x.shape)}")


def window_stats_planes_ref(planes: torch.Tensor, eps: torch.Tensor,
                            rows: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Plain PyTorch s1 (same contract as ``window_stats_planes``)."""
    _check(planes, rows)
    _check_vec(eps, "eps", planes.shape[1])
    return seq_sum(tile_sums(_rows(planes, rows).to(f32) * eps, word=4))


def window_axpy_planes_ref(planes: torch.Tensor, c1: torch.Tensor,
                           rows: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain PyTorch axpy (same contract as ``window_axpy_planes``)."""
    W = _check(planes, rows)
    _check_vec(c1, "c1", W)
    g = _rows(planes, rows).to(f32)
    acc = torch.zeros(planes.shape[1], dtype=f32, device=planes.device)
    for r in range(W):
        acc = acc + c1[r] * g[r]
    return acc


def _card(planes, rows, W, what, **vecs):
    dev = planes.device
    if dev.type != "cuda":
        raise ValueError(f"no {what} kernel for device {dev}")
    if planes.shape[1] % 512:
        raise ValueError(f"planes width {planes.shape[1]} is not a multiple "
                         "of 512 individuals")
    if W < 1:
        raise ValueError(f"the kernels take 1 or more rows, got {W}")
    if rows is None:
        rows = torch.arange(W, dtype=torch.int32, device=dev)
    if rows.dtype != torch.int32:
        raise ValueError(f"rows must be int32, got {rows.dtype}")
    for name, t in dict(planes=planes, rows=rows, **vecs).items():
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous and on {dev}")
    for name in ("planes", "eps"):      # copied 16 bytes at a time
        t = planes if name == "planes" else vecs.get(name)
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    from hydra_tpu_torch.ops import _build
    return rows, _build.load("planes_kernel.cu")


def _raise(lib, what, err):
    raise RuntimeError(f"{what} kernel launch failed: "
                       f"{lib.hydra_planes_error_string(err).decode()}")


def _stats_workspace(lib, dev, stream, n_pad, W):
    """The workspace of the stream, at least a (W, n_pad) call's; a new one
    is zeroed (the ticket counters start at 0)."""
    need = lib.hydra_planes_workspace_bytes(n_pad, W)
    key = (dev.index, stream)
    ws = _workspace.get(key)
    if ws is None or ws.numel() < need:
        ws = _workspace[key] = torch.zeros(need, dtype=torch.uint8,
                                           device=dev)
    return ws


def window_stats_planes(planes: torch.Tensor, eps: torch.Tensor,
                        rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """s1 (W,): the CUDA kernel on CUDA tensors, the plain version on CPU
    tensors."""
    W = _check(planes, rows)
    _check_vec(eps, "eps", planes.shape[1])
    if planes.device.type == "cpu":
        return window_stats_planes_ref(planes, eps, rows)
    rows, lib = _card(planes, rows, W, "window_stats_planes", eps=eps)
    dev, n_pad = planes.device, planes.shape[1]
    s1 = torch.empty(W, dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = _stats_workspace(lib, dev, stream, n_pad, W)
    with torch.cuda.device(dev):
        err = lib.hydra_window_stats_planes(
            planes.data_ptr(), eps.data_ptr(), rows.data_ptr(),
            s1.data_ptr(), ws.data_ptr(), W, n_pad, stream)
    if err:
        _raise(lib, "window_stats_planes", err)
    launches["window_stats_planes"] += 1
    return s1


def window_axpy_planes(planes: torch.Tensor, c1: torch.Tensor,
                       rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum_r c1_r planes[rows_r] (n_pad,): the CUDA kernel on CUDA tensors,
    the plain version on CPU tensors."""
    W = _check(planes, rows)
    _check_vec(c1, "c1", W)
    if planes.device.type == "cpu":
        return window_axpy_planes_ref(planes, c1, rows)
    rows, lib = _card(planes, rows, W, "window_axpy_planes", c1=c1)
    dev, n_pad = planes.device, planes.shape[1]
    out = torch.empty(n_pad, dtype=f32, device=dev)
    with torch.cuda.device(dev):
        err = lib.hydra_window_axpy_planes(
            planes.data_ptr(), rows.data_ptr(), c1.data_ptr(), out.data_ptr(),
            W, n_pad, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        _raise(lib, "window_axpy_planes", err)
    launches["window_axpy_planes"] += 1
    return out
