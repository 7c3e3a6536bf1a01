"""Whole-sweep BayesRRm kernels: stale and exact windows.

Port of ``hydra_tpu/ops/sweep_kernel.py`` (``sweep_stale``, ``sweep_exact``,
``sweep_stale_sd``). A sweep walks the markers window by window; per window
it computes s1 = sum g*eps and s2 = sum m*eps, draws every marker's mixture
component and beta from its ``mrow`` row, and applies the residual update.
Exact mode adds the window Gram and the W-step sequential recurrence, which
gives exact sequential Gibbs. The single-decode stale sweep decodes each
window's packed rows once, in sub-windows of ``sub_window`` markers, and
adds the window's update to eps at its end (``sd_sub_window`` reads the
sub-window from HYDRA_TPU_SD).

Layouts at this interface:
  pk    (m_loc, NB) uint8   h-packed genotypes in SLOT order
  eps   (4*NB,) f32         residual in individual order (no plane-major
                            de-interleave: crumb k of byte b is 4b + k)
  mrow  (m_loc, 6+3K-2) f32 per-slot rows, column layout below
  order (m_loc,) int32      sweep position -> slot (``block_order`` makes it
                            from a block-schedule window permutation)
  ind_mask (4*NB,) f32      1 on real individuals (complete data only)
Returns (eps', out) with out (m_loc, 4) = [beta_new, comp, acum0, dbeta] per
slot. mave/mstd come from mrow columns 0/1 (the JAX ``mcol``).

On marker shards (one rank a shard) ``sweep_stale`` and ``sweep_exact``
take ``sync``, which sums a residual change across the ranks: the sweep
then runs one window a launch (``hydra_sweep_windows``) and, after each
window, adds the ranks' summed change to the eps it started from, as the
JAX sampler's multi-shard per-window launches do (bayesrrm.py:728-763).
An exact sweep still computes its Grams once a batch.

``sweep_stale`` / ``sweep_exact`` / ``sweep_stale_sd`` launch the CUDA
kernels of ``csrc/sweep_kernel.cu`` for CUDA tensors and raise on what the
kernels do not take; for CPU tensors they run the plain versions
``sweep_stale_ref`` / ``sweep_exact_ref`` / ``sweep_stale_sd_ref`` (torch,
vectorized per window), which the tests hold against the JAX kernels in
interpret mode.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from hydra_tpu_torch.ops.decode import decode_h, decode_planes_hp

f32 = torch.float32

# mrow column layout (K = mixture components incl. zero):
#   0 mave, 1 mstd, 2 beta_old, 3 u, 4 nrm, 5 act,
#   6..6+K-1        logl_static (log pi, first col unshifted)
#   6+K..6+2K-2     inv_denomk  (K-1 cols)
#   6+2K-1..6+3K-3  sd_k        (K-1 cols)
N_FIXED = 6


def mrow_width(k: int) -> int:
    return N_FIXED + 3 * k - 2


# Kernel launches through each wrapper (one per sweep; on marker shards one
# per window). The sampler's main
# path must move these; comparisons against the plain versions call the
# kernels through the same wrappers, so callers reset and read around the
# run they want to count.
launches = {"sweep_stale": 0, "sweep_exact": 0, "sweep_stale_sd": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def block_order(win_perm: torch.Tensor, window: int) -> torch.Tensor:
    """Block schedule: window w covers slots win_perm[w]*W .. +W-1."""
    wp = win_perm.to(torch.int64)
    ar = torch.arange(window, device=wp.device, dtype=torch.int64)
    return (wp[:, None] * window + ar).reshape(-1).to(torch.int32)


def _scalars(i_2se, dNm1, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.as_tensor(i_2se, dtype=f32, device=device),
            torch.as_tensor(dNm1, dtype=f32, device=device))


def _cols(rows: torch.Tensor, K: int):
    bl, bi, bs = N_FIXED, N_FIXED + K, N_FIXED + 2 * K - 1
    return (rows[..., bl:bl + K], rows[..., bi:bi + K - 1],
            rows[..., bs:bs + K - 1])


def stale_draw(rows, num0, i2se, K):
    """Vectorized stale-window draw (sweep_kernel.py:733-803, the sampler's
    draw_rows, bayesrrm.py:383-406) of W markers from their mrow rows
    (W, C) and dot products num0 (W,): normalized probs, comp = #{cumulative
    probs exceeded by u}. Returns (beta_new, comp, acum0, dbeta)."""
    bold, u, nrm, act = rows[:, 2], rows[:, 3], rows[:, 4], rows[:, 5]
    logl, invd, sd = _cols(rows, K)
    muks = num0[:, None] * invd                                 # (W, K-1)
    logls = torch.cat([logl[:, :1], logl[:, 1:] + muks * num0[:, None] * i2se],
                      dim=1)
    prs = torch.exp(logls - logls.max(dim=1, keepdim=True).values)
    sm = prs[:, 0]
    for j in range(1, K):
        sm = sm + prs[:, j]
    probs = prs / sm[:, None]
    cum = probs[:, 0]
    compf = (u > cum).to(f32)
    for j in range(1, K - 1):
        cum = cum + probs[:, j]
        compf = compf + (u > cum).to(f32)
    sel = compf[:, None] == torch.arange(1, K, device=rows.device, dtype=f32)
    bnz = (sel * (muks + nrm[:, None] * sd)).sum(dim=1)
    bnew = bnz * (compf > 0).to(f32) * act
    return bnew, compf * act, probs[:, 0] * act + (1.0 - act), bold - bnew


def exact_draw(num, logl, invd, sd, u, nrm, act, bold, i2se):
    """One marker of the exact recurrence (sweep_kernel.py:452-517 and
    gibbs_kernel.py:57-107; ``exact_draw`` in csrc/sweep_kernel.cu): clamp
    max(l - mx, -60), unnormalized u*s against the running cum. logl (K,),
    invd and sd (K-1,). Returns (beta_new, comp, acum0, dbeta)."""
    K = logl.shape[0]
    muk = num * invd
    ls = logl[1:] + muk * num * i2se
    mx = torch.maximum(logl[0], ls.max())
    pr0 = torch.exp(torch.clamp(logl[0] - mx, min=-60.0))
    prs = torch.exp(torch.clamp(ls - mx, min=-60.0))
    cs = torch.cumsum(torch.cat([pr0.reshape(1), prs]), 0)  # running cum
    s = cs[-1]
    compf = (u * s > cs[:-1]).to(f32).sum()
    sel = (torch.arange(1, K, device=logl.device, dtype=f32) == compf).to(f32)
    bnew = (compf > 0).to(f32) * act * ((sel * muk).sum()
                                        + nrm * (sel * sd).sum())
    return bnew, compf * act, (pr0 / s) * act + (1.0 - act), bold - bnew


def _check(pk, eps, mrow, window, n_mix, complete, ind_mask, order):
    if pk.dtype != torch.uint8 or pk.dim() != 2:
        raise ValueError(f"pk must be (m_loc, NB) uint8, got {pk.dtype} "
                         f"{tuple(pk.shape)}")
    m_loc, nb = pk.shape
    if eps.dtype != f32 or tuple(eps.shape) != (4 * nb,):
        raise ValueError(f"eps must be ({4 * nb},) float32, got {eps.dtype} "
                         f"{tuple(eps.shape)}")
    if mrow.dtype != f32 or tuple(mrow.shape) != (m_loc, mrow_width(n_mix)):
        raise ValueError(f"mrow must be ({m_loc}, {mrow_width(n_mix)}) "
                         f"float32, got {mrow.dtype} {tuple(mrow.shape)}")
    if window < 1 or m_loc % window:
        raise ValueError(f"m_loc {m_loc} is not a multiple of window {window}")
    if complete and (ind_mask is None or tuple(ind_mask.shape) != (4 * nb,)):
        raise ValueError("complete-data sweeps need ind_mask of shape "
                         f"({4 * nb},)")
    if order is not None and tuple(order.shape) != (m_loc,):
        raise ValueError(f"order must be ({m_loc},), got {tuple(order.shape)}")


def _order(order, m_loc, device):
    if order is None:
        return torch.arange(m_loc, device=device)
    return order.to(device=device, dtype=torch.int64)


def sd_sub_window(window: int, nb: int, complete: bool) -> int:
    """Sub-window of the single-decode stale sweep, from HYDRA_TPU_SD (the
    port's copy of hydra_tpu/ops/sweep_kernel.py::sd_sub_window): unset or
    "0" gives 0, the two-phase ``sweep_stale``; an integer is the
    sub-window and must divide the window; "auto" is the whole window.

    The JAX rule for "auto" sizes the sub-window to a 3.5 MB VMEM budget.
    Here a sub-window's decoded rows live in device memory (sub-window x
    4 * nb bytes: 3.2 MB at W=64, N=50,000, inside the H100's 50 MB L2), so
    one sub-window per window needs no budget; ``nb`` and ``complete`` keep
    the JAX signature."""
    ov = os.environ.get("HYDRA_TPU_SD", "")
    if not ov or ov == "0":
        return 0
    wt = window if ov == "auto" else int(ov)
    if wt < 1 or window % wt:
        raise ValueError(f"HYDRA_TPU_SD={ov} must divide the window "
                         f"({window})")
    return wt


def _check_sub_window(window, sub_window):
    if not 1 <= sub_window <= window or window % sub_window:
        raise ValueError(f"sub_window {sub_window} must divide the window "
                         f"({window})")


def _synced(eps, new, sync):
    """eps after a window whose update took it to ``new``: on marker
    shards (sync given) eps plus the ranks' summed change."""
    return new if sync is None else eps + sync(new - eps)


def _stale_ref(pk, eps, mrow, i_2se, dNm1, window, sub_window, n_mix,
               complete, ind_mask, order, sync=None):
    m_loc = pk.shape[0]
    W, K = window, n_mix
    i2se, dnm1 = _scalars(i_2se, dNm1, pk.device)
    order = _order(order, m_loc, pk.device)
    eps = eps.clone()
    out = torch.zeros((m_loc, 4), dtype=f32, device=pk.device)
    for w in range(m_loc // W):
        slots = order[w * W:(w + 1) * W]
        rows = mrow[slots]
        if complete:
            # h-decode: s1 = 2*sum(eps) - sum(h*eps); pads (h = 3) meet
            # eps == 0 here and the ind_mask in the update
            h = decode_h(pk[slots])
            s2 = eps.sum()
            s1 = 2.0 * s2 - h @ eps
        else:
            g, m = decode_planes_hp(pk[slots])
            s1, s2 = g @ eps, m @ eps
        num0 = rows[:, 1] * (s1 - rows[:, 0] * s2) + rows[:, 2] * dnm1
        bnew, comp, acum, dbeta = stale_draw(rows, num0, i2se, K)
        c1 = dbeta * rows[:, 1]
        c2 = -c1 * rows[:, 0]
        # the window's update, summed sub-window by sub-window and added to
        # eps once at the window's end
        d = None
        for s in range(0, W, sub_window):
            sl = slice(s, s + sub_window)
            if complete:
                ds = (2.0 * c1[sl].sum() + c2[sl].sum()) - c1[sl] @ h[sl]
            else:
                ds = c1[sl] @ g[sl] + c2[sl] @ m[sl]
            d = ds if d is None else d + ds
        eps = _synced(eps, eps + (d * ind_mask if complete else d), sync)
        out[slots] = torch.stack([bnew, comp, acum, dbeta], dim=1)
    return eps, out


@torch.inference_mode()
def sweep_stale_ref(pk, eps, mrow, i_2se, dNm1, *, window: int, n_mix: int,
                    complete: bool, ind_mask: Optional[torch.Tensor] = None,
                    order: Optional[torch.Tensor] = None, sync=None):
    """Plain PyTorch stale sweep (same math as the CUDA kernel)."""
    _check(pk, eps, mrow, window, n_mix, complete, ind_mask, order)
    return _stale_ref(pk, eps, mrow, i_2se, dNm1, window, window, n_mix,
                      complete, ind_mask, order, sync)


@torch.inference_mode()
def sweep_stale_sd_ref(pk, eps, mrow, i_2se, dNm1, *, window: int,
                       sub_window: int, n_mix: int, complete: bool,
                       ind_mask: Optional[torch.Tensor] = None,
                       order: Optional[torch.Tensor] = None):
    """Plain single-decode stale sweep: per window ``sweep_stale_ref``'s
    stats and draw; the update summed over sub-windows of ``sub_window``
    markers in the kernel's order and added to eps at the window's end, so
    every marker of the window reads the same stale eps for any
    sub-window (sweep_kernel.py:211-220)."""
    _check(pk, eps, mrow, window, n_mix, complete, ind_mask, order)
    _check_sub_window(window, sub_window)
    return _stale_ref(pk, eps, mrow, i_2se, dNm1, window, sub_window, n_mix,
                      complete, ind_mask, order)


@torch.inference_mode()
def sweep_exact_ref(pk, eps, mrow, i_2se, dNm1, *, window: int, n_mix: int,
                    complete: bool, ind_mask: Optional[torch.Tensor] = None,
                    order: Optional[torch.Tensor] = None, sync=None):
    """Plain PyTorch exact sweep: window Gram + W-step recurrence written as
    the kernel's rank-1 update num_i += G_ij * dbeta_j."""
    _check(pk, eps, mrow, window, n_mix, complete, ind_mask, order)
    m_loc = pk.shape[0]
    W, K = window, n_mix
    i2se, dnm1 = _scalars(i_2se, dNm1, pk.device)
    order = _order(order, m_loc, pk.device)
    eps = eps.clone()
    out = torch.zeros((m_loc, 4), dtype=f32, device=pk.device)
    for w in range(m_loc // W):
        slots = order[w * W:(w + 1) * W]
        rows = mrow[slots]
        mave, mstd = rows[:, 0], rows[:, 1]
        g, m = decode_planes_hp(pk[slots])
        s1 = g @ eps
        if complete:
            # integer Gram of the g planes + rank-1 standardization, with
            # n_real = dNm1 + 1 (sweep_kernel.py:435-442, :613-617)
            s2 = eps.sum()
            v = g.sum(dim=1)
            mm = mave[:, None]
            gram = (mstd[:, None] * mstd[None, :]) * (
                g @ g.T - mm * v[None, :] - v[:, None] * mave[None, :]
                + (dnm1 + 1.0) * (mm * mave[None, :]))
        else:
            s2 = m @ eps
            x = (g - mave[:, None] * m) * mstd[:, None]
            gram = x @ x.T
        numv = mstd * (s1 - mave * s2) + rows[:, 2] * dnm1
        logl, invd, sd = _cols(rows, K)
        res = []
        for j in range(W):
            r = exact_draw(numv[j], logl[j], invd[j], sd[j], rows[j, 3],
                           rows[j, 4], rows[j, 5], rows[j, 2], i2se)
            numv = numv + gram[:, j] * r[3]
            res.append(torch.stack(r))
        res = torch.stack(res)                               # (W, 4)
        c1 = res[:, 3] * mstd
        c2 = -c1 * mave
        if complete:
            new = eps + (c1 @ g + c2.sum()) * ind_mask
        else:
            new = eps + (c1 @ g + c2 @ m)
        eps = _synced(eps, new, sync)
        out[slots] = res
    return eps, out


def _launch(name, exact, pk, eps, mrow, i_2se, dNm1, window, n_mix, complete,
            ind_mask, order, sub_window=0, sync=None):
    from hydra_tpu_torch.ops import _build

    dev = pk.device
    m_loc, nb = pk.shape
    if n_mix < 2:
        raise ValueError(f"the sweep takes 2 or more mixture components, "
                         f"got {n_mix}")
    if nb % 128:
        raise ValueError(f"packed width {nb} is not a multiple of 128 bytes "
                         "(individuals pad to 512, data/genotypes.py)")
    tensors = [pk, eps, mrow] + ([ind_mask] if complete else [])
    if order is None:
        order = torch.arange(m_loc, device=dev, dtype=torch.int32)
    tensors.append(order)
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("sweep operands must be contiguous and on "
                             f"{dev}")
    if order.dtype != torch.int32:
        raise ValueError(f"order must be int32, got {order.dtype}")
    if complete and ind_mask.dtype != f32:
        raise ValueError(f"ind_mask must be float32, got {ind_mask.dtype}")
    lib = _build.load()
    i2se, dnm1 = _scalars(i_2se, dNm1, dev)
    sc = torch.stack([i2se, dnm1, dnm1 + 1.0]).contiguous()
    if sub_window:
        nbytes = lib.hydra_sweep_sd_workspace_bytes(nb, window, sub_window)
        fn = lib.hydra_sweep_stale_sd
        shape = (m_loc, nb, window, sub_window, n_mix, int(complete))
    else:
        nbytes = lib.hydra_sweep_workspace_bytes(m_loc, nb, window,
                                                 int(exact))
        fn = lib.hydra_sweep_exact if exact else lib.hydra_sweep_stale
        shape = (m_loc, nb, window, n_mix, int(complete))
    ws = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    eps_out = eps.clone()
    out = torch.zeros((m_loc, 4), dtype=f32, device=dev)
    mask_ptr = ind_mask.data_ptr() if complete else None

    def check(err):
        if err:
            raise RuntimeError(f"{name} kernel launch failed: "
                               f"{lib.hydra_sweep_error_string(err).decode()}")
        launches[name] += 1

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if sync is None:
            check(fn(pk.data_ptr(), eps_out.data_ptr(), mrow.data_ptr(),
                     order.data_ptr(), mask_ptr, sc.data_ptr(),
                     out.data_ptr(), ws.data_ptr(), *shape, stream))
            return eps_out, out
        # marker shards: a window a launch, its change summed over ranks
        for w in range(m_loc // window):
            new = eps_out.clone()
            check(lib.hydra_sweep_windows(
                int(exact), pk.data_ptr(), new.data_ptr(), mrow.data_ptr(),
                order.data_ptr(), mask_ptr, sc.data_ptr(), out.data_ptr(),
                ws.data_ptr(), *shape, w, w + 1, stream))
            eps_out = _synced(eps_out, new, sync)
    return eps_out, out


def sweep_stale(pk, eps, mrow, i_2se, dNm1, *, window: int, n_mix: int,
                complete: bool, ind_mask: Optional[torch.Tensor] = None,
                order: Optional[torch.Tensor] = None, sync=None):
    """Stale-window sweep: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors."""
    _check(pk, eps, mrow, window, n_mix, complete, ind_mask, order)
    if pk.device.type == "cpu":
        return sweep_stale_ref(pk, eps, mrow, i_2se, dNm1, window=window,
                               n_mix=n_mix, complete=complete,
                               ind_mask=ind_mask, order=order, sync=sync)
    if pk.device.type != "cuda":
        raise ValueError(f"no sweep kernel for device {pk.device}")
    return _launch("sweep_stale", False, pk, eps, mrow, i_2se, dNm1, window,
                   n_mix, complete, ind_mask, order, sync=sync)


def sweep_stale_sd(pk, eps, mrow, i_2se, dNm1, *, window: int,
                   sub_window: int, n_mix: int, complete: bool,
                   ind_mask: Optional[torch.Tensor] = None,
                   order: Optional[torch.Tensor] = None):
    """Single-decode stale sweep: the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors."""
    _check(pk, eps, mrow, window, n_mix, complete, ind_mask, order)
    _check_sub_window(window, sub_window)
    if pk.device.type == "cpu":
        return sweep_stale_sd_ref(pk, eps, mrow, i_2se, dNm1, window=window,
                                  sub_window=sub_window, n_mix=n_mix,
                                  complete=complete, ind_mask=ind_mask,
                                  order=order)
    if pk.device.type != "cuda":
        raise ValueError(f"no sweep kernel for device {pk.device}")
    return _launch("sweep_stale_sd", False, pk, eps, mrow, i_2se, dNm1,
                   window, n_mix, complete, ind_mask, order, sub_window)


def sweep_exact(pk, eps, mrow, i_2se, dNm1, *, window: int, n_mix: int,
                complete: bool, ind_mask: Optional[torch.Tensor] = None,
                order: Optional[torch.Tensor] = None, sync=None):
    """Exact-mode sweep: the CUDA kernel on CUDA tensors, the plain version
    on CPU tensors."""
    _check(pk, eps, mrow, window, n_mix, complete, ind_mask, order)
    if pk.device.type == "cpu":
        return sweep_exact_ref(pk, eps, mrow, i_2se, dNm1, window=window,
                               n_mix=n_mix, complete=complete,
                               ind_mask=ind_mask, order=order, sync=sync)
    if pk.device.type != "cuda":
        raise ValueError(f"no sweep kernel for device {pk.device}")
    return _launch("sweep_exact", True, pk, eps, mrow, i_2se, dNm1, window,
                   n_mix, complete, ind_mask, order, sync=sync)
