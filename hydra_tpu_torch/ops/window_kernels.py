"""Per-window passes over a window's packed rows: BayesRRm's stats, the
residual axpy and BayesW's level sums.

Port of ``hydra_tpu/ops/window_kernels.py``'s ``window_stats``,
``window_axpy`` and ``window_level_sums``. Each takes the packed rows
(W, NB) uint8 (h-packed, ``ops/decode.py``), or all rows (m_loc, NB) with
``rows`` (W,) int32 naming the window's slots (read in place on the device,
not gathered), and works in individual order: eps, vi and dε are (4*NB,)
f32 with crumb k of byte b at 4b + k (no plane-major layout).

  window_stats(pk, eps, mave, mstd, exact, complete, n_real) -> (s1, s2,
      gram): s1 = sum g*eps and s2 = sum m*eps per marker (BayesRRm's
      per-window branch). Complete data returns s2 = None (the caller uses
      sum(eps), zero on pads); complete stale data computes s1 by the
      h-decode 2*sum(eps) - sum h*eps. exact adds the standardized window
      Gram (W, W): complete data the raw integer Gram of the g planes with
      the rank-1 correction from v = sum g and ``n_real``, missing data the
      f32 Gram of x = (g - mave*m) * mstd.
  window_level_sums(pk, vi) -> (s1, s2, sb): sum_{g=1} vi, sum_{g=2} vi and
      the mask dot sum_{g not missing} vi per marker (partial_sum,
      BayesW.cpp:49-65); complete data returns sb = None (the caller uses
      sum(vi), which is zero on pads).
  window_axpy(pk, c1, c2) -> dε = sum_m c1_m G_m + c2_m M_m; complete data
      returns only the genotype part (the caller adds sum(c2) and masks):
          d_eps = (window_axpy(..., complete=True) + c2.sum()) * ind_mask
      by the h-decode 2 sum(c1) - sum c1*h, sum(c1) in window order from 0.
      On the card one launch (the kernel writes dε and forms 2 sum(c1)).
  window_grams(pk, order, window[, mave, mstd]) -> (n_windows, W, W): the
      Grams of the consecutive windows order[w W .. w W + W) of all rows, as
      the exact sweeps compute them ahead of their draws, many windows a
      launch: complete data (mave None) the raw integer g g^T, missing data
      x x^T with x = (g - mave*m) * mstd from per-slot mave, mstd (m_loc,).

For CUDA tensors the wrappers launch the kernels (``window_stats``:
``hydra_window_stats`` of ``csrc/sweep_kernel.cu``, which reuses the sweep's
``stats_kernel`` and Gram kernels; the others ``csrc/sweep_kernel_bw.cu``'s
``levels_kernel`` and the shared ``axpy_kernel``); for CPU tensors they run
the plain versions ``*_ref``. ``window_grams`` launches
``hydra_window_grams``, the exact sweeps' batched Gram kernels. The same
BayesW kernels run inside every window of ``sweep_stale_bw``, and
``launches`` counts them there as well.

``sweep_update_ref`` replays a whole sweep's residual updates from its
draws in axpy_kernel's order, the reference the sweeps' axpy is held to;
``sweep_update_mt_ref`` does the same for the multi-trait sweeps'
axpy_mt_kernel. The multi-trait wrappers' plain versions are matmul forms;
``window_stats_mt_seq`` and ``window_axpy_mt_seq`` (on
``stats_mt_partials`` and ``axpy_mt_rows``) compute the same in the
kernels' order.

The plain versions add in the kernels' order: the stats and level sums per
512-byte tile, each of its 32 lanes sequentially over its words, then the
warp's xor butterfly and the tiles in order; the axpy row by row; the
complete-data Gram is exact integers standardized with one rounding per
operation. On the card the plain version and the kernel then agree bit for
bit, but for the missing-data Gram and a pad row's h = 3 products in
complete stale data (3*eps rounds in the plain version, not in the kernel's
fused multiply-add; pad rows have mstd = 0). The missing-data Gram's kernel
(gram_f32_batch_kernel) runs one fused multiply-add chain an entry per
2,048-individual chunk, individuals in order, and adds the chunks in order;
the plain version's ``x @ x.T`` is a library matmul, so the two agree to
f32 rounding (about 3e-5 of the diagonal), not bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from hydra_tpu_torch.ops.decode import crumbs, decode_h, decode_planes_hp

f32 = torch.float32
LEVELS_TB = 512        # packed bytes per levels and stats tile (csrc/*.cu)
_LANES = 32

# Kernel launches per name: one per standalone wrapper call, plus one per
# window of each sweep_stale_bw call (the sweep launches the same kernels).
launches = {"window_stats": 0, "window_level_sums": 0, "window_axpy": 0,
            "window_stats_mt": 0, "window_axpy_mt": 0, "window_grams": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check(pk: torch.Tensor, vec: torch.Tensor, name: str) -> None:
    if pk.dtype != torch.uint8 or pk.dim() != 2:
        raise ValueError(f"pk must be (W, NB) uint8, got {pk.dtype} "
                         f"{tuple(pk.shape)}")
    nb = pk.shape[1]
    if vec.dtype != f32 or tuple(vec.shape) != (4 * nb,):
        raise ValueError(f"{name} must be ({4 * nb},) float32, got "
                         f"{vec.dtype} {tuple(vec.shape)}")


def seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim, left to right (a kernel's serial loop)."""
    s = x[..., 0]
    for i in range(1, x.shape[-1]):
        s = s + x[..., i]
    return s


def seq_sum0(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim from +0, left to right: a kernel's ``s = 0.f;
    s += x`` (``seq_sum`` starts from x[0], which differs for -0)."""
    return seq_sum(torch.nn.functional.pad(x, (1, 0)))


def tile_sums(x: torch.Tensor, word: int = 16) -> torch.Tensor:
    """(..., 4*NB) -> (..., n_tiles): per-tile sums in the order of
    levels_kernel and stats_kernel (word = 16: a tile holds 128 32-bit words
    of 16 individuals each) or of the planes' stats_planes_kernel (word = 4:
    512 char4 words of 4). Every tile holds 2,048 individuals; lane l adds
    its words l, l + 32, ... of the tile individual by individual, then the
    warp combines lanes by the xor butterfly. Zero padding to whole tiles
    adds exact zeros."""
    n = x.shape[-1]
    per_tile = 4 * LEVELS_TB
    steps = per_tile // (_LANES * word)
    n_tiles = -(-n // per_tile)
    x = torch.nn.functional.pad(x, (0, n_tiles * per_tile - n))
    x = x.reshape(*x.shape[:-1], n_tiles, steps, _LANES, word)
    x = x.movedim(-2, -3)                       # (..., t, lane, j, crumb)
    acc = seq_sum(x.reshape(*x.shape[:-2], steps * word))
    lane = torch.arange(_LANES, device=x.device)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lane ^ off]
    return acc[..., 0]


def level_partials(pk: torch.Tensor, vi: torch.Tensor, complete: bool):
    """Per-tile partials (W, n_tiles) of s1, s2, the mask dot (None when
    complete) and (n_tiles,) of sum(vi), as levels_kernel writes them.
    Complete data uses the h-decode indicators i1 = h(2-h),
    i2 = (1-h)(1-h/2) (pads, h = 3, must meet vi == 0); missing data
    decodes g, m with i1 = g(2-g), i2 = g(g-1)/2."""
    c = crumbs(pk)
    if complete:
        i1, i2, m = c * (2 - c), ((1 - c) * (2 - c)) // 2, None
    else:
        m = 1 - ((c + 1) >> 2)
        g = (2 - c) * m
        i1, i2 = g * (2 - g), (g * (g - 1)) // 2
    planes = [i1, i2] + ([] if complete else [m])
    parts = tile_sums(torch.stack(planes).to(f32) * vi)
    return (parts[0], parts[1], None if complete else parts[2],
            tile_sums(vi))


def window_level_sums_ref(pk: torch.Tensor, vi: torch.Tensor,
                          complete: bool = False,
                          rows: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     Optional[torch.Tensor]]:
    """Plain PyTorch level sums (same contract as ``window_level_sums``)."""
    _check_rows(pk, rows, "W")
    _check(pk, vi, "vi")
    p1, p2, pb, _ = level_partials(_window_rows(pk, rows), vi, complete)
    return seq_sum(p1), seq_sum(p2), (None if complete else seq_sum(pb))


def axpy_rows(pk: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor,
              complete: bool) -> torch.Tensor:
    """axpy_kernel's accumulator (4*NB,), row by row: complete data
    sum c1*h, missing data sum c1*g + c2*m (products of c by 0, 1 or 2 are
    exact, so each step rounds once as the kernel's fmaf does)."""
    c = crumbs(pk).to(f32)
    acc = torch.zeros(c.shape[1], dtype=f32, device=pk.device)
    if complete:
        for r in range(c.shape[0]):
            acc = acc + c1[r] * c[r]
        return acc
    m = 1.0 - (c == 3.0).to(f32)
    g = (2.0 - c) * m
    for r in range(c.shape[0]):
        acc = acc + c1[r] * g[r]
        acc = acc + c2[r] * m[r]
    return acc


def lane_sum(x: torch.Tensor) -> torch.Tensor:
    """sum(x) as exact_draw_kernel adds the complete-data axpy constant:
    lane l adds x[l], x[l + 32], ... in order, then the xor butterfly."""
    pad = -(-x.shape[0] // _LANES) * _LANES - x.shape[0]
    acc = torch.zeros(_LANES, dtype=f32, device=x.device)
    for r in torch.nn.functional.pad(x, (0, pad)).reshape(-1, _LANES):
        acc = acc + r
    lane = torch.arange(_LANES, device=x.device)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[lane ^ off]
    return acc[0]


def sweep_update_ref(pk: torch.Tensor, eps: torch.Tensor, mrow: torch.Tensor,
                     dbeta: torch.Tensor, order: torch.Tensor, window: int,
                     mode: str, ind_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """eps after a whole sweep's residual updates, given every slot's dbeta
    (the sweep's own draws): the plain version of the sweeps' axpy_kernel
    in its order, per individual one step per row, with c1 = dbeta * mrow
    column 1 and c2 = -c1 * mrow column 0 (BayesRRm's mstd and mave,
    BayesW's inverse sd and mave). mode "missing": d = sum c1*g + c2*m;
    "stale" (complete): d = (2 sum c1 + sum c2 - sum c1*h) * mask; "exact"
    (complete): d = (sum c1*g + lane_sum(c2)) * mask. A sweep's eps held
    to this bit for bit holds its axpy so."""
    eps = eps.clone()
    for w in range(order.shape[0] // window):
        slots = order[w * window:(w + 1) * window].to(torch.int64)
        c1 = dbeta[slots] * mrow[slots, 1]
        c2 = -c1 * mrow[slots, 0]
        if mode == "missing":
            eps = eps + axpy_rows(pk[slots], c1, c2, False)
        elif mode == "stale":
            cst = 2.0 * seq_sum(c1) + seq_sum(c2)
            eps = eps + (cst - axpy_rows(pk[slots], c1, c2, True)) * ind_mask
        else:
            g, _ = decode_planes_hp(pk[slots])
            acc = torch.zeros_like(eps)
            for r in range(window):
                acc = acc + c1[r] * g[r]
            eps = eps + (acc + lane_sum(c2)) * ind_mask
    return eps


def _window_rows(pk: torch.Tensor, rows: Optional[torch.Tensor]) -> torch.Tensor:
    return pk if rows is None else pk[rows.to(torch.int64)]


def _check_rows(pk, rows, n_rows_name: str):
    if pk.dtype != torch.uint8 or pk.dim() != 2:
        raise ValueError(f"pk must be (rows, NB) uint8, got {pk.dtype} "
                         f"{tuple(pk.shape)}")
    if rows is not None and (rows.dim() != 1 or rows.dtype not in (
            torch.int32, torch.int64)):
        raise ValueError(f"rows must be ({n_rows_name},) int32")
    return pk.shape[0] if rows is None else rows.shape[0]


def stats_partials(pk: torch.Tensor, eps: torch.Tensor, exact: bool,
                   complete: bool):
    """Per-tile partials (W, n_tiles) of stats_kernel's three sums: s1
    (complete stale data: sum h*eps), s2 (complete data: sum eps, the same
    for every row) and v = sum g (exact complete data only, else None)."""
    c = crumbs(pk)
    if complete and not exact:
        return tile_sums(c.to(f32) * eps), tile_sums(eps).expand(
            pk.shape[0], -1), None
    m = 1 - ((c + 1) >> 2)
    g = ((2 - c) * m).to(f32)
    if complete:
        return (tile_sums(g * eps), tile_sums(eps).expand(pk.shape[0], -1),
                tile_sums(g))
    return tile_sums(g * eps), tile_sums(m.to(f32) * eps), None


def _check_stats(pk, eps, mave, mstd, exact, complete, n_real, rows):
    W = _check_rows(pk, rows, "W")
    _check(pk, eps, "eps")
    for name, x in (("mave", mave), ("mstd", mstd)):
        if x.dtype != f32 or tuple(x.shape) != (W,):
            raise ValueError(f"{name} must be ({W},) float32, got {x.dtype} "
                             f"{tuple(x.shape)}")
    if exact and complete and n_real is None:
        raise ValueError("exact complete window_stats needs n_real")
    return W


def window_stats_ref(pk: torch.Tensor, eps: torch.Tensor, mave: torch.Tensor,
                     mstd: torch.Tensor, exact: bool, complete: bool = False,
                     n_real=None, rows: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                Optional[torch.Tensor]]:
    """Plain PyTorch window stats (same contract as ``window_stats``)."""
    _check_stats(pk, eps, mave, mstd, exact, complete, n_real, rows)
    pk = _window_rows(pk, rows)
    p1, p2, pv = stats_partials(pk, eps, exact, complete)
    s1, s2 = seq_sum(p1), seq_sum(p2)
    if complete and not exact:
        s1 = 2.0 * s2 - s1                     # h-decode
    gram = None
    if exact and complete:
        # raw integer Gram (exact in f32) and its rank-1 standardization,
        # one rounding per operation as gram_standardize_kernel
        g, _ = decode_planes_hp(pk)
        v = seq_sum(pv)
        n = torch.as_tensor(n_real, dtype=f32, device=pk.device)
        am = mave[:, None]
        t = g @ g.T - am * v[None, :]
        t = t - v[:, None] * mave[None, :]
        t = t + n * (am * mave[None, :])
        gram = (mstd[:, None] * mstd[None, :]) * t
    elif exact:
        g, m = decode_planes_hp(pk)
        x = (g - mave[:, None] * m) * mstd[:, None]
        gram = x @ x.T
    return s1, (None if complete else s2), gram


def window_axpy_ref(pk: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor,
                    complete: bool = False,
                    rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch axpy (same contract as ``window_axpy``)."""
    acc = axpy_rows(_window_rows(pk, rows), c1, c2, complete)
    # h-decode: sum c1*g = 2*sum(c1) - sum c1*h, sum(c1) in window order
    # from 0 as the kernel adds it
    return 2.0 * seq_sum0(c1) - acc if complete else acc


def _card_rows(pk: torch.Tensor, rows: Optional[torch.Tensor], W: int,
               what: str) -> torch.Tensor:
    """What the CUDA kernels take; returns the window's rows as int32 on
    the card (0..W-1 when ``rows`` is None)."""
    if pk.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {pk.device}")
    if pk.shape[1] % 128:
        raise ValueError(f"packed width {pk.shape[1]} is not a multiple of "
                         "128 bytes (individuals pad to 512)")
    if W < 1:
        raise ValueError(f"the kernels take 1 or more rows, got {W}")
    if not pk.is_contiguous():
        raise ValueError("pk must be contiguous")
    if rows is None:
        return torch.arange(W, dtype=torch.int32, device=pk.device)
    if (rows.dtype != torch.int32 or rows.device != pk.device
            or not rows.is_contiguous()):
        raise ValueError(f"rows must be contiguous int32 on {pk.device}")
    return rows


def _raise(lib, what, err):
    raise RuntimeError(f"{what} kernel launch failed: "
                       f"{lib.hydra_bw_error_string(err).decode()}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def window_stats(pk: torch.Tensor, eps: torch.Tensor, mave: torch.Tensor,
                 mstd: torch.Tensor, exact: bool, complete: bool = False,
                 n_real=None, rows: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                            Optional[torch.Tensor]]:
    """(s1, s2, gram) of one window: the CUDA kernels on CUDA tensors, the
    plain version on CPU tensors. mave, mstd (W,) in window order; n_real
    (a number or a one-element tensor) for exact complete data."""
    W = _check_stats(pk, eps, mave, mstd, exact, complete, n_real, rows)
    if pk.device.type == "cpu":
        return window_stats_ref(pk, eps, mave, mstd, exact, complete, n_real,
                                rows)
    rows = _card_rows(pk, rows, W, "window_stats")
    from hydra_tpu_torch.ops import _build

    dev = pk.device
    for name, x in (("eps", eps), ("mave", mave), ("mstd", mstd)):
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous and on {dev}")
    lib = _build.load()
    nb = pk.shape[1]
    nr = (torch.as_tensor(n_real, dtype=f32, device=dev).reshape(1)
          if exact and complete else None)
    out = torch.empty((2, W), dtype=f32, device=dev)
    gram = torch.empty((W, W), dtype=f32, device=dev) if exact else None
    ws = torch.empty(lib.hydra_window_workspace_bytes(nb, W, int(exact),
                                                      int(complete)),
                     dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = lib.hydra_window_stats(
            pk.data_ptr(), eps.data_ptr(), rows.data_ptr(), mave.data_ptr(),
            mstd.data_ptr(), None if nr is None else nr.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(),
            None if gram is None else gram.data_ptr(), ws.data_ptr(), W, nb,
            int(exact), int(complete), _stream(dev))
    if err:
        raise RuntimeError("window_stats kernel launch failed: "
                           f"{lib.hydra_sweep_error_string(err).decode()}")
    launches["window_stats"] += 1
    return out[0], (None if complete else out[1]), gram


def _check_grams(pk, order, window, mave, mstd) -> int:
    if pk.dtype != torch.uint8 or pk.dim() != 2:
        raise ValueError(f"pk must be (m_loc, NB) uint8, got {pk.dtype} "
                         f"{tuple(pk.shape)}")
    if (order.dim() != 1 or order.dtype not in (torch.int32, torch.int64)
            or window < 1 or order.numel() % window or not order.numel()):
        raise ValueError(f"order must be windows of {window} int32 slots, "
                         f"got {order.dtype} {tuple(order.shape)}")
    if (mave is None) != (mstd is None):
        raise ValueError("missing-data Grams need both mave and mstd")
    for name, x in (("mave", mave), ("mstd", mstd)):
        if x is not None and (x.dtype != f32
                              or tuple(x.shape) != (pk.shape[0],)):
            raise ValueError(f"{name} must be ({pk.shape[0]},) float32 per "
                             f"slot, got {x.dtype} {tuple(x.shape)}")
    return order.numel() // window


def window_grams_ref(pk: torch.Tensor, order: torch.Tensor, window: int,
                     mave: Optional[torch.Tensor] = None,
                     mstd: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch window Grams (same contract as ``window_grams``): each
    window's Gram as ``window_stats_ref`` forms it, stacked (n_windows, W,
    W) through ``order``, 256 windows a batched product (their decoded rows
    in memory at once). Complete data is exact (integer sums below 2^24);
    missing data is ``x @ x.T`` of a library matmul."""
    n_windows = _check_grams(pk, order, window, mave, mstd)
    out = torch.empty((n_windows, window, window), dtype=f32,
                      device=pk.device)
    order = order.long()
    step = 256
    for w0 in range(0, n_windows, step):
        slots = order[w0 * window:(w0 + step) * window]
        g, m = decode_planes_hp(pk[slots])
        if mave is not None:
            g = (g - mave[slots, None] * m) * mstd[slots, None]
        x = g.view(-1, window, g.shape[1])
        out[w0:w0 + x.shape[0]] = torch.bmm(x, x.transpose(1, 2))
    return out


# a sweep's batch of Grams: GRAM_BATCH_BYTES and GRAM_BATCH_WINDOWS of
# csrc/sweep_kernel.cuh
GRAM_BATCH_BYTES, GRAM_BATCH_WINDOWS = 64 << 20, 4096


def gram_batch_windows(n_windows: int, window: int) -> int:
    """Windows one batched Gram launch of an exact sweep of ``n_windows``
    windows takes (``gram_batch_windows`` of csrc/sweep_kernel.cuh): as many
    as GRAM_BATCH_BYTES of f32 Grams hold, at most GRAM_BATCH_WINDOWS and
    n_windows, at least 1."""
    cap = GRAM_BATCH_BYTES // (4 * window * window)
    return max(1, min(cap, GRAM_BATCH_WINDOWS, n_windows))


def window_grams(pk: torch.Tensor, order: torch.Tensor, window: int,
                 mave: Optional[torch.Tensor] = None,
                 mstd: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The Grams (n_windows, W, W) of the windows order[w W .. w W + W) of
    pk (m_loc, NB): the exact sweeps' batched Gram kernels on CUDA tensors
    (``gram_batch_windows`` windows a launch), the plain version on CPU
    tensors. mave, mstd (m_loc,) per slot give missing-data Grams; without
    them the raw integer Gram of the genotype planes."""
    n_windows = _check_grams(pk, order, window, mave, mstd)
    if pk.device.type == "cpu":
        return window_grams_ref(pk, order, window, mave, mstd)
    _card_rows(pk, None, window, "window_grams")
    from hydra_tpu_torch.ops import _build

    dev = pk.device
    if order.dtype != torch.int32:
        raise ValueError(f"order must be int32, got {order.dtype}")
    for name, x in (("order", order), ("mave", mave), ("mstd", mstd)):
        if x is not None and (x.device != dev or not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous and on {dev}")
    lib = _build.load()
    out = torch.empty((n_windows, window, window), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        err = lib.hydra_window_grams(
            pk.data_ptr(), order.data_ptr(),
            None if mave is None else mave.data_ptr(),
            None if mstd is None else mstd.data_ptr(), out.data_ptr(),
            n_windows, pk.shape[1], window, int(mave is None), _stream(dev))
    if err:
        raise RuntimeError("window_grams kernel launch failed: "
                           f"{lib.hydra_sweep_error_string(err).decode()}")
    launches["window_grams"] += 1
    return out


def window_level_sums(pk: torch.Tensor, vi: torch.Tensor,
                      complete: bool = False,
                      rows: Optional[torch.Tensor] = None):
    """(s1, s2, sb) per window marker, the markers ``pk[rows]`` (all of pk
    when rows is None): the CUDA kernel on CUDA tensors, the plain version
    on CPU tensors."""
    W = _check_rows(pk, rows, "W")
    _check(pk, vi, "vi")
    if pk.device.type == "cpu":
        return window_level_sums_ref(pk, vi, complete, rows)
    nb = pk.shape[1]
    order = _card_rows(pk, rows, W, "window_level_sums")
    from hydra_tpu_torch.ops import _build

    dev = pk.device
    if vi.device != dev or not vi.is_contiguous():
        raise ValueError(f"vi must be contiguous and on {dev}")
    lib = _build.load("sweep_kernel_bw.cu")
    out = torch.empty((3, W), dtype=f32, device=dev)
    ws = torch.empty(lib.hydra_bw_workspace_bytes(nb, W), dtype=torch.uint8,
                     device=dev)
    with torch.cuda.device(dev):
        err = lib.hydra_window_level_sums(
            pk.data_ptr(), vi.data_ptr(), order.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), out[2].data_ptr(), ws.data_ptr(), W, nb,
            int(complete), _stream(dev))
    if err:
        _raise(lib, "window_level_sums", err)
    launches["window_level_sums"] += 1
    return out[0], out[1], (None if complete else out[2])


def window_axpy(pk: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor,
                complete: bool = False,
                rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dε (4*NB,): the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors."""
    W = _check_rows(pk, rows, "W")
    for name, c in (("c1", c1), ("c2", c2)):
        if c.dtype != f32 or tuple(c.shape) != (W,):
            raise ValueError(f"{name} must be ({W},) float32, got {c.dtype} "
                             f"{tuple(c.shape)}")
    if pk.device.type == "cpu":
        return window_axpy_ref(pk, c1, c2, complete, rows)
    rows = _card_rows(pk, rows, W, "window_axpy")
    from hydra_tpu_torch.ops import _build

    dev = pk.device
    if c1.device != dev or c2.device != dev:
        raise ValueError(f"c1 and c2 must be on {dev}")
    if not (c1.is_contiguous() and c2.is_contiguous()):
        raise ValueError("c1 and c2 must be contiguous")
    lib = _build.load("sweep_kernel_bw.cu")
    nb = pk.shape[1]
    # one launch: the kernel writes every element of out and forms the
    # complete-data constant 2 sum(c1) itself
    out = torch.empty(4 * nb, dtype=f32, device=dev)
    with torch.cuda.device(dev):
        err = lib.hydra_window_axpy(
            pk.data_ptr(), rows.data_ptr(), c1.data_ptr(), c2.data_ptr(),
            out.data_ptr(), W, nb, int(complete), _stream(dev))
    if err:
        _raise(lib, "window_axpy", err)
    launches["window_axpy"] += 1
    return out


# ---------------------------------------------------------------------------
# Multi-trait passes (module docstring)
# ---------------------------------------------------------------------------


def _check_stats_mt(pk, eps, rows):
    W = _check_rows(pk, rows, "W")
    nb = pk.shape[1]
    if eps.dtype != f32 or eps.dim() != 2 or eps.shape[0] != 4 * nb:
        raise ValueError(f"eps must be ({4 * nb}, T) float32, got {eps.dtype} "
                         f"{tuple(eps.shape)}")
    return W, eps.shape[1]


def _check_axpy_mt(pk, c1, c2, rows):
    W = _check_rows(pk, rows, "W")
    if c1.dim() != 2 or c1.shape[1] != W:
        raise ValueError(f"c1 must be (T, {W}) float32, got {c1.dtype} "
                         f"{tuple(c1.shape)}")
    for name, c in (("c1", c1), ("c2", c2)):
        if c.dtype != f32 or tuple(c.shape) != tuple(c1.shape):
            raise ValueError(f"{name} must be ({c1.shape[0]}, {W}) float32, "
                             f"got {c.dtype} {tuple(c.shape)}")
    return W, c1.shape[0]


def window_stats_mt_ref(pk: torch.Tensor, eps: torch.Tensor,
                        complete: bool = False,
                        rows: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch multi-trait stats (same contract as
    ``window_stats_mt``)."""
    _check_stats_mt(pk, eps, rows)
    pk = _window_rows(pk, rows)
    if complete:
        # h-decode, as the kernel: s1 = 2*sum(eps) - h.eps
        return 2.0 * eps.sum(dim=0) - decode_h(pk) @ eps, None
    g, m = decode_planes_hp(pk)
    return g @ eps, m @ eps


def window_axpy_mt_ref(pk: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor,
                       complete: bool = False,
                       rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch multi-trait axpy (same contract as
    ``window_axpy_mt``)."""
    _check_axpy_mt(pk, c1, c2, rows)
    pk = _window_rows(pk, rows)
    if complete:
        # h-decode: sum c1*g = 2*sum(c1) - sum c1*h
        return 2.0 * c1.sum(dim=1) - decode_h(pk).T @ c1.T
    g, m = decode_planes_hp(pk)
    return g.T @ c1.T + m.T @ c2.T


# The multi-trait plain versions in the kernels' order (stats_mt_kernel,
# axpy_mt_kernel): on the card the kernels agree with them bit for bit, but
# for complete stale data's pad rows and the complete axpy's pad
# individuals (h = 3 products, which these round and the kernels fuse).
_MT_ROW_CHUNK = 64      # rows a step of stats_mt_partials (bounds its memory)


def stats_mt_partials(pk: torch.Tensor, eps: torch.Tensor, exact: bool,
                      complete: bool):
    """Per-tile partials (W, T, n_tiles) of stats_mt_kernel's sums, in its
    order: per (row, trait), ``tile_sums(word=4)`` of the products from +0
    (lane l adds bytes l, l + 32, ... of a 512-byte tile, crumb by crumb).
    s1 is sum h*eps for complete stale data, else sum g*eps; s2 is sum
    m*eps, or sum eps (the same for every row) for complete data; v (W,
    n_tiles) is sum g for exact complete data, else None."""
    c = crumbs(pk)
    m = 1 - ((c + 1) >> 2)
    x = (c if complete and not exact else (2 - c) * m).to(f32)
    e = eps.T                                            # (T, n_pad)

    def partials(planes):
        return torch.cat([tile_sums(planes[r:r + _MT_ROW_CHUNK, None, :]
                                    * e[None] + 0.0, word=4)
                          for r in range(0, planes.shape[0], _MT_ROW_CHUNK)])

    p1 = partials(x)
    p2 = (tile_sums(e + 0.0, word=4).expand(pk.shape[0], -1, -1) if complete
          else partials(m.to(f32)))
    pv = tile_sums(x, word=4) if exact and complete else None
    return p1, p2, pv


def window_stats_mt_seq(pk: torch.Tensor, eps: torch.Tensor,
                        complete: bool = False,
                        rows: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``window_stats_mt`` in the kernels' order: the partials of
    ``stats_mt_partials`` added tile by tile from +0, as
    stats_mt_reduce_kernel (complete data: s1 = 2 s2 - sum h*eps)."""
    _check_stats_mt(pk, eps, rows)
    p1, p2, _ = stats_mt_partials(_window_rows(pk, rows), eps, False,
                                  complete)
    s1, s2 = seq_sum0(p1), seq_sum0(p2)
    return (2.0 * s2 - s1, None) if complete else (s1, s2)


def axpy_mt_rows(pk: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor,
                 complete: bool) -> torch.Tensor:
    """axpy_mt_kernel's accumulators (n_pad, T), row by row for each trait:
    complete data sum c1[t, r]*h_r, missing data sum c1[t, r]*g_r +
    c2[t, r]*m_r (products by 0, 1 or 2 are exact, so each step rounds once
    as the kernel's fmaf does)."""
    c = crumbs(pk).to(f32)
    acc = torch.zeros((c.shape[1], c1.shape[0]), dtype=f32, device=pk.device)
    if complete:
        for r in range(c.shape[0]):
            acc = acc + c[r, :, None] * c1[None, :, r]
        return acc
    m = 1.0 - (c == 3.0).to(f32)
    g = (2.0 - c) * m
    for r in range(c.shape[0]):
        acc = acc + g[r, :, None] * c1[None, :, r]
        acc = acc + m[r, :, None] * c2[None, :, r]
    return acc


def window_axpy_mt_seq(pk: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor,
                       complete: bool = False,
                       rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``window_axpy_mt`` in the kernel's order: complete data 2 sum(c1) -
    ``axpy_mt_rows`` (sum(c1) sequential from +0), added to a zero
    residual."""
    _check_axpy_mt(pk, c1, c2, rows)
    acc = axpy_mt_rows(_window_rows(pk, rows), c1, c2, complete)
    d = 2.0 * seq_sum0(c1) + 0.0 - acc if complete else acc
    return torch.zeros_like(acc) + d


def sweep_update_mt_ref(pk: torch.Tensor, eps: torch.Tensor, tm: torch.Tensor,
                        mrow: torch.Tensor, out: torch.Tensor,
                        order: torch.Tensor, window: int, complete: bool
                        ) -> torch.Tensor:
    """eps (n_pad, T) after a whole multi-trait sweep's residual updates,
    given its ``out`` (beta_new per slot in columns 0..T-1; the sweep's own
    draws): the plain version of the sweeps' axpy_mt_kernel in its order,
    with c1 = (beta_old - beta_new) * mstd and c2 = -c1 * mave from mrow's
    column blocks 2, 1 and 0. Complete data (stale and exact): eps += (2
    sum c1 + sum c2 - sum c1*h) * tm; missing data: eps += (sum c1*g +
    c2*m) * tm. A sweep's eps held to this bit for bit holds its axpy so."""
    T = eps.shape[1]
    b = mrow.reshape(mrow.shape[0], -1, T)
    eps = eps.clone()
    for w in range(order.shape[0] // window):
        slots = order[w * window:(w + 1) * window].to(torch.int64)
        bw = b[slots]
        c1 = ((bw[:, 2] - out[slots, :T]) * bw[:, 1]).T      # (T, W)
        c2 = -c1 * bw[:, 0].T
        acc = axpy_mt_rows(pk[slots], c1, c2, complete)
        if complete:
            eps = eps + (2.0 * seq_sum0(c1) + seq_sum0(c2) - acc) * tm
        else:
            eps = eps + acc * tm
    return eps


def _mt_card(pk, rows, W, T, what):
    from hydra_tpu_torch.ops.sweep_kernel_mt import check_card_shapes
    rows = _card_rows(pk, rows, W, what)
    check_card_shapes(pk.shape[1], W, T)
    return rows


def window_stats_mt(pk: torch.Tensor, eps: torch.Tensor,
                    complete: bool = False,
                    rows: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(s1, s2) each (W, T): the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors."""
    W, T = _check_stats_mt(pk, eps, rows)
    if pk.device.type == "cpu":
        return window_stats_mt_ref(pk, eps, complete, rows)
    rows = _mt_card(pk, rows, W, T, "window_stats_mt")
    from hydra_tpu_torch.ops import sweep_kernel_mt as skmt

    dev = pk.device
    skmt.on_device(dev, pk=pk, eps=eps, rows=rows)
    lib = skmt._lib()
    nb = pk.shape[1]
    s1 = torch.empty((W, T), dtype=f32, device=dev)
    s2 = None if complete else torch.empty((W, T), dtype=f32, device=dev)
    ws = torch.empty(lib.hydra_mt_workspace_bytes(W, nb, W, T, 0),
                     dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = lib.hydra_window_stats_mt(
            pk.data_ptr(), eps.data_ptr(), rows.data_ptr(), s1.data_ptr(),
            None if s2 is None else s2.data_ptr(), ws.data_ptr(), W, nb, T,
            int(complete), skmt._stream(dev))
    if err:
        skmt._raise(lib, "window_stats_mt", err)
    launches["window_stats_mt"] += 1
    return s1, s2


def window_axpy_mt(pk: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor,
                   complete: bool = False,
                   rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dε (n_pad, T): the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors."""
    W, T = _check_axpy_mt(pk, c1, c2, rows)
    if pk.device.type == "cpu":
        return window_axpy_mt_ref(pk, c1, c2, complete, rows)
    rows = _mt_card(pk, rows, W, T, "window_axpy_mt")
    from hydra_tpu_torch.ops import sweep_kernel_mt as skmt

    dev = pk.device
    skmt.on_device(dev, pk=pk, c1=c1, c2=c2, rows=rows)
    lib = skmt._lib()
    nb = pk.shape[1]
    coef = torch.cat([c1.reshape(-1), c2.reshape(-1)])
    out = torch.zeros((4 * nb, T), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        err = lib.hydra_window_axpy_mt(
            pk.data_ptr(), rows.data_ptr(), coef.data_ptr(), out.data_ptr(),
            W, nb, T, int(complete), skmt._stream(dev))
    if err:
        skmt._raise(lib, "window_axpy_mt", err)
    launches["window_axpy_mt"] += 1
    return out
