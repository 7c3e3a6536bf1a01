"""Multi-trait whole-sweep kernels (stale and exact) and the per-window exact
recurrence.

Port of ``hydra_tpu/ops/sweep_kernel_mt.py`` (``sweep_stale_mt``,
``sweep_exact_mt``) plus the recurrence that the JAX sampler's per-window
path runs as a ``lax.scan`` (``hydra_tpu/samplers/bayesrrm_mt.py:439-456``).
A sweep walks the markers window by window; per window it computes the
per-(marker, trait) dots s1 = sum g*eps_t and s2 = sum m*eps_t with one
decode shared by the T traits, draws every (marker, trait) from its
``mrow`` columns, and applies the trait-masked residual update. The exact
sweep adds the trait-shared window Gram and the W-step recurrence, for
complete genotypes and full phenotypes only (the sampler gates it).

Layouts at this interface:
  pk    (m_loc, NB) uint8      h-packed genotypes in SLOT order
  eps   (n_pad, T) f32         residual in individual order, one column per
                               trait (the JAX ``MtState.eps`` layout; no
                               plane-major (4T, NB) rows). Zero on pad
                               individuals and on each trait's NaN entries.
  tm    (n_pad, T) f32         trait mask: 1 where trait t of individual i
                               is observed, 0 on NaN entries and pads
  mrow  (m_loc, T*(3K+4)) f32  per-slot rows, column blocks of T (below)
  order (m_loc,) int32         sweep position -> slot (``block_order``)
Returns (eps', out) with out (m_loc, 3T) = [beta_new (T), comp (T),
acum (T)] per slot, the JAX ``out`` columns.

On marker shards (one rank a shard) ``sweep_stale_mt`` and
``sweep_exact_mt`` take ``sync``, which sums a residual change across the
ranks: the sweep then runs one window a launch (``hydra_sweep_windows_mt``)
and, after each window, adds the ranks' summed change to the eps it started
from, held at 0 on masked entries (the JAX ``hpsum(d_eps) * tm_t``,
bayesrrm_mt.py:474). An exact sweep still computes its Grams once a batch.

``sweep_stale_mt`` / ``sweep_exact_mt`` / ``mt_window_recurrence`` launch
the CUDA kernels of ``csrc/sweep_kernel_mt.cu`` for CUDA tensors and raise
on what the kernels do not take; for CPU tensors they run the plain
versions ``*_ref``, which the tests hold against the JAX kernels in
interpret mode.
"""

from __future__ import annotations

from typing import Optional

import torch

from hydra_tpu_torch.ops.decode import decode_h, decode_planes_hp

f32 = torch.float32

# mrow column blocks (T columns each; hydra_tpu/ops/sweep_kernel_mt.py:47-56):
#   0 mave, 1 mstd, 2 bold, 3 u, 4 nrm, 5 act,
#   6..6+K-1 logl_static, 6+K..6+2K-2 inv_denomk, 6+2K-1..6+3K-3 sd_k
N_FIXED_BLOCKS = 6


def mt_mrow_width(k: int, t: int) -> int:
    return t * (N_FIXED_BLOCKS + 3 * k - 2)


# Kernel launches through each wrapper (one per sweep, on marker shards one
# per window; one per window recurrence). The sampler's main path must move
# these; comparisons against the plain versions call the kernels through the
# same wrappers, so callers reset and read around the run they want to
# count.
launches = {"sweep_stale_mt": 0, "sweep_exact_mt": 0,
            "mt_window_recurrence": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _blocks(rows: torch.Tensor, T: int) -> torch.Tensor:
    """(..., T*(3K+4)) rows -> (..., 3K+4, T) column blocks."""
    return rows.reshape(*rows.shape[:-1], -1, T)


def draw_normalized(b: torch.Tensor, num: torch.Tensor, i2se: torch.Tensor,
                    K: int):
    """The stale kernel's draw (sweep_kernel_mt.py:140-161), which is also
    the sampler's draw_rows (bayesrrm_mt.py:348-368). b (..., 3K+4, T),
    num (..., T) -> (beta_new, comp, acum), each (..., T)."""
    n0 = N_FIXED_BLOCKS
    logl, invd, sd = (b[..., n0:n0 + K, :], b[..., n0 + K:n0 + 2 * K - 1, :],
                      b[..., n0 + 2 * K - 1:n0 + 3 * K - 2, :])
    u, nrm, act = b[..., 3, :], b[..., 4, :], b[..., 5, :]
    muk = num[..., None, :] * invd                              # (..., K-1, T)
    ls = torch.cat([logl[..., :1, :],
                    logl[..., 1:, :] + muk * num[..., None, :] * i2se], dim=-2)
    prs = torch.exp(ls - ls.max(dim=-2, keepdim=True).values)
    sm = prs[..., 0, :]
    for j in range(1, K):
        sm = sm + prs[..., j, :]
    probs = prs / sm[..., None, :]
    cum = probs[..., 0, :]
    compf = (u > cum).to(f32)
    for j in range(1, K - 1):
        cum = cum + probs[..., j, :]
        compf = compf + (u > cum).to(f32)
    ks = torch.arange(1, K, device=b.device, dtype=f32)[:, None]
    sel = (compf[..., None, :] == ks).to(f32)
    bnz = (sel * (muk + nrm[..., None, :] * sd)).sum(dim=-2)
    bnew = (compf > 0).to(f32) * act * bnz
    return bnew, compf * act, probs[..., 0, :] * act + (1.0 - act)


def draw_clamped(b: torch.Tensor, num: torch.Tensor, i2se: torch.Tensor,
                 K: int):
    """The exact kernel's draw (sweep_kernel_mt.py:430-455) for one marker,
    all traits: exp(max(l - mx, -60)), unnormalized u*s against the running
    cum. b (3K+4, T), num (T,) -> (beta_new, comp, acum), each (T,)."""
    n0 = N_FIXED_BLOCKS
    logl, invd, sd = (b[n0:n0 + K], b[n0 + K:n0 + 2 * K - 1],
                      b[n0 + 2 * K - 1:n0 + 3 * K - 2])
    muk = num * invd                                            # (K-1, T)
    ls = logl[1:] + muk * num * i2se
    mx = torch.maximum(logl[0], ls.max(dim=0).values)
    pr0 = torch.exp(torch.clamp(logl[0] - mx, min=-60.0))
    prs = torch.exp(torch.clamp(ls - mx, min=-60.0))
    cs = torch.cumsum(torch.cat([pr0[None], prs]), dim=0)       # running cum
    s = cs[-1]
    compf = (b[3] * s > cs[:-1]).to(f32).sum(dim=0)
    ks = torch.arange(1, K, device=b.device, dtype=f32)[:, None]
    sel = (ks == compf).to(f32)
    act = b[5]
    bnew = (compf > 0).to(f32) * act * ((sel * muk).sum(dim=0)
                                        + b[4] * (sel * sd).sum(dim=0))
    return bnew, compf * act, (pr0 / s) * act + (1.0 - act)


def _check(pk, eps, tm, mrow, i_2se, dNm1, window, n_mix, order):
    if pk.dtype != torch.uint8 or pk.dim() != 2:
        raise ValueError(f"pk must be (m_loc, NB) uint8, got {pk.dtype} "
                         f"{tuple(pk.shape)}")
    m_loc, nb = pk.shape
    if eps.dtype != f32 or eps.dim() != 2 or eps.shape[0] != 4 * nb:
        raise ValueError(f"eps must be ({4 * nb}, T) float32, got {eps.dtype} "
                         f"{tuple(eps.shape)}")
    T = eps.shape[1]
    if tm is None or tuple(tm.shape) != tuple(eps.shape) or tm.dtype != f32:
        raise ValueError(f"tm must be ({4 * nb}, {T}) float32")
    if mrow.dtype != f32 or tuple(mrow.shape) != (m_loc, mt_mrow_width(n_mix, T)):
        raise ValueError(f"mrow must be ({m_loc}, {mt_mrow_width(n_mix, T)}) "
                         f"float32, got {mrow.dtype} {tuple(mrow.shape)}")
    for name, v in (("i_2se", i_2se), ("dNm1", dNm1)):
        if tuple(v.shape) != (T,):
            raise ValueError(f"{name} must be ({T},), got {tuple(v.shape)}")
    if window < 1 or m_loc % window:
        raise ValueError(f"m_loc {m_loc} is not a multiple of window {window}")
    if order is not None and tuple(order.shape) != (m_loc,):
        raise ValueError(f"order must be ({m_loc},), got {tuple(order.shape)}")


def _synced(eps, new, tm, sync):
    """eps after a window whose update took it to ``new``: on marker
    shards (sync given) eps plus the ranks' summed change, times the trait
    mask."""
    return new if sync is None else eps + sync(new - eps) * tm


def _order(order, m_loc, device):
    if order is None:
        return torch.arange(m_loc, device=device)
    return order.to(device=device, dtype=torch.int64)


@torch.inference_mode()
def sweep_stale_mt_ref(pk, eps, tm, mrow, i_2se, dNm1, *, window: int,
                       n_mix: int, complete: bool,
                       order: Optional[torch.Tensor] = None, sync=None):
    """Plain PyTorch stale multi-trait sweep (same math as the kernel)."""
    _check(pk, eps, tm, mrow, i_2se, dNm1, window, n_mix, order)
    m_loc, T = pk.shape[0], eps.shape[1]
    W, K = window, n_mix
    i2se, dnm1 = i_2se.to(f32), dNm1.to(f32)
    order = _order(order, m_loc, pk.device)
    eps = eps.clone()
    out = torch.zeros((m_loc, 3 * T), dtype=f32, device=pk.device)
    for w in range(m_loc // W):
        slots = order[w * W:(w + 1) * W]
        b = _blocks(mrow[slots], T)
        mave, mstd, bold = b[:, 0], b[:, 1], b[:, 2]
        if complete:
            # h-decode: s1 = 2*sum(eps) - h.eps; pads (h = 3) meet eps == 0
            # here and tm == 0 in the update
            h = decode_h(pk[slots])
            s2 = eps.sum(dim=0)
            s1 = 2.0 * s2 - h @ eps
        else:
            g, m = decode_planes_hp(pk[slots])
            s1, s2 = g @ eps, m @ eps
        num0 = mstd * (s1 - mave * s2) + bold * dnm1
        bnew, comp, acum = draw_normalized(b, num0, i2se, K)
        c1 = (bold - bnew) * mstd                                # (W, T)
        c2 = -c1 * mave
        if complete:
            csum = 2.0 * c1.sum(dim=0) + c2.sum(dim=0)
            new = eps + (csum - h.T @ c1) * tm
        else:
            new = eps + (g.T @ c1 + m.T @ c2) * tm
        eps = _synced(eps, new, tm, sync)
        out[slots] = torch.cat([bnew, comp, acum], dim=1)
    return eps, out


@torch.inference_mode()
def sweep_exact_mt_ref(pk, eps, tm, mrow, i_2se, dNm1, *, window: int,
                       n_mix: int, order: Optional[torch.Tensor] = None,
                       sync=None):
    """Plain PyTorch exact multi-trait sweep (complete genotypes, full
    phenotypes): the trait-shared integer Gram standardized with trait 0's
    mave/mstd and n_real = dNm1[0] + 1 (sweep_kernel_mt.py:391-399), then
    the recurrence as the kernel's rank-1 update num_i += G_ij * dbeta_j."""
    _check(pk, eps, tm, mrow, i_2se, dNm1, window, n_mix, order)
    m_loc, T = pk.shape[0], eps.shape[1]
    W, K = window, n_mix
    i2se, dnm1 = i_2se.to(f32), dNm1.to(f32)
    n_real = dnm1[0] + 1.0
    order = _order(order, m_loc, pk.device)
    eps = eps.clone()
    out = torch.zeros((m_loc, 3 * T), dtype=f32, device=pk.device)
    for w in range(m_loc // W):
        slots = order[w * W:(w + 1) * W]
        b = _blocks(mrow[slots], T)
        mave, mstd, bold = b[:, 0], b[:, 1], b[:, 2]
        g, _ = decode_planes_hp(pk[slots])
        s1 = g @ eps
        s2 = eps.sum(dim=0)
        v = g.sum(dim=1)
        ma, ms = mave[:, 0], mstd[:, 0]
        gram = (ms[:, None] * ms[None, :]) * (
            g @ g.T - ma[:, None] * v[None, :] - v[:, None] * ma[None, :]
            + n_real * (ma[:, None] * ma[None, :]))
        numv = mstd * (s1 - mave * s2) + bold * dnm1              # (W, T)
        res = []
        for j in range(W):
            bnew, comp, acum = draw_clamped(b[j], numv[j], i2se, K)
            db = bold[j] - bnew
            numv = numv + gram[:, j:j + 1] * db[None, :]
            res.append(torch.stack([bnew, comp, acum, db]))
        res = torch.stack(res)                                    # (W, 4, T)
        c1 = res[:, 3] * mstd
        c2 = -c1 * mave
        csum = 2.0 * c1.sum(dim=0) + c2.sum(dim=0)
        new = eps + (csum - decode_h(pk[slots]).T @ c1) * tm
        eps = _synced(eps, new, tm, sync)
        out[slots] = res[:, :3].reshape(W, 3 * T)
    return eps, out


def _check_recurrence(gram, num0, mrow, i_2se, n_mix, rows):
    if num0.dtype != f32 or num0.dim() != 2:
        raise ValueError(f"num0 must be (W, T) float32, got {num0.dtype} "
                         f"{tuple(num0.shape)}")
    W, T = num0.shape
    if gram.dtype != f32 or tuple(gram.shape) not in ((W, W), (T, W, W)):
        raise ValueError(f"gram must be ({W}, {W}) or ({T}, {W}, {W}) "
                         f"float32, got {gram.dtype} {tuple(gram.shape)}")
    n_rows = W if rows is None else mrow.shape[0]
    if mrow.dtype != f32 or tuple(mrow.shape) != (n_rows,
                                                  mt_mrow_width(n_mix, T)):
        raise ValueError(f"mrow must be ({n_rows}, {mt_mrow_width(n_mix, T)})"
                         f" float32, got {mrow.dtype} {tuple(mrow.shape)}")
    if rows is not None and tuple(rows.shape) != (W,):
        raise ValueError(f"rows must be ({W},), got {tuple(rows.shape)}")
    if tuple(i_2se.shape) != (T,):
        raise ValueError(f"i_2se must be ({T},), got {tuple(i_2se.shape)}")


@torch.inference_mode()
def mt_window_recurrence_ref(gram, num0, mrow, i_2se, *, n_mix: int,
                             rows: Optional[torch.Tensor] = None):
    """Plain PyTorch exact recurrence of one window (the sampler's scan,
    bayesrrm_mt.py:439-456, with its draw_rows form). gram (W, W) shared or
    (T, W, W) per trait, standardized; num0 (W, T); mrow the window's rows
    (W, C), or all rows with ``rows`` selecting the window's slots.
    Returns (beta_new, comp, acum, dbeta), each (W, T)."""
    _check_recurrence(gram, num0, mrow, i_2se, n_mix, rows)
    W, T = num0.shape
    b = _blocks(mrow if rows is None else mrow[rows.to(torch.int64)], T)
    i2se = i_2se.to(f32)
    numv = num0.clone()
    res = []
    for j in range(W):
        bnew, comp, acum = draw_normalized(b[j], numv[j], i2se, n_mix)
        db = b[j, 2] - bnew
        col = gram[:, :, j].T if gram.dim() == 3 else gram[:, j:j + 1]
        numv = numv + col * db[None, :]
        res.append(torch.stack([bnew, comp, acum, db]))
    res = torch.stack(res, dim=1)                                 # (4, W, T)
    return res[0], res[1], res[2], res[3]


# ---- the float64 witness of a knife-edge draw -----------------------------
# Two f32 computations of one exact chain (the kernel's fmaf update of num,
# the plain version's multiply then add) can take adjacent components at a
# draw whose u s lies within their rounding of a cumulative-probability
# boundary; the chains then go on apart. first_differences finds such
# chains; recurrence_edge and sweep_exact_mt_edge decide in float64 whether
# the first differing draw is on a knife edge.
U32 = 2.0 ** -24                  # f32 unit roundoff


def first_differences(comp_a, comp_b, window: int):
    """(w, j, t) of every chain (window w, trait t) whose components differ
    (comp_* (n, T) in sweep-position order), j its first differing step."""
    T = comp_a.shape[1]
    diff = (comp_a != comp_b).reshape(-1, window, T)
    return [(w, int(diff[w, :, t].nonzero()[0]), t)
            for w, t in diff.any(dim=1).nonzero().tolist()]


@torch.inference_mode()
def recurrence_edge(g_row, num0, db, blk, i2se, n_mix: int, comps,
                    num0_err: float = 0.0, points: int = 257) -> bool:
    """Whether step j = len(db) of one trait's chain is a knife edge between
    the components ``comps``: in float64, num = num0 + sum_i g_row[i] db[i]
    from the chain's earlier steps (db, one chain's own history), and the
    clamped draw of its column block ``blk`` (3K+4,) over num +- the f32
    forward error bound of that sum ((j + 2) u sum |terms|, plus num0_err)
    takes each of ``comps`` (0 where the block's act is 0, as comp * act)."""
    f64 = torch.float64
    terms = g_row[:len(db)].to(f64) * db.to(f64)
    num = float(num0) + float(terms.sum())
    err = ((len(db) + 2) * U32 * (abs(float(num0)) + float(terms.abs().sum()))
           + num0_err)
    x = num + err * torch.linspace(-1.0, 1.0, points, dtype=f64,
                                   device=blk.device)
    b = blk.to(f64)
    n0, K = N_FIXED_BLOCKS, n_mix
    logl, invd = b[n0:n0 + K], b[n0 + K:n0 + 2 * K - 1]
    ls = torch.cat([logl[:1].expand(points, 1),
                    logl[1:] + x[:, None] * invd * x[:, None] * float(i2se)],
                   dim=1)
    pr = torch.exp(torch.clamp(ls - ls.max(dim=1, keepdim=True).values,
                               min=-60.0))
    cs = pr.cumsum(dim=1)
    taken = set(((b[3] * cs[:, -1:] > cs[:, :-1]).sum(dim=1)
                 * int(b[5] != 0)).tolist())
    return set(int(c) for c in comps) <= taken


@torch.inference_mode()
def sweep_exact_mt_edge(pk, eps, tm, mrow, i_2se, dNm1, out, *, window: int,
                        n_mix: int, order, w: int, j: int, t: int,
                        comps) -> bool:
    """recurrence_edge for step j of trait t in window w of an exact
    multi-trait sweep (sweep_exact_mt_ref's chain), from the sweep's own
    draws ``out`` (m_loc, 3T): the earlier windows' residual updates and
    the window's Gram and num0 replayed in float64, num0's error bounded
    by its sums' (n_pad + W + 4 terms)."""
    f64 = torch.float64
    T, W = eps.shape[1], window
    order = _order(order, pk.shape[0], pk.device)
    eps, tm = eps.to(f64), tm.to(f64)
    dnm1 = dNm1.to(f64)
    n_real = float(dnm1[0]) + 1.0

    def window_of(v):
        slots = order[v * W:(v + 1) * W]
        b = _blocks(mrow[slots], T).to(f64)
        db = b[:, 2] - out[slots][:, :T].to(f64)
        return slots, b, db

    for v in range(w):
        slots, b, db = window_of(v)
        c1 = db * b[:, 1]
        csum = 2.0 * c1.sum(dim=0) - (c1 * b[:, 0]).sum(dim=0)
        eps = eps + (csum - decode_h(pk[slots], f64).T @ c1) * tm
    slots, b, db = window_of(w)
    g, _ = decode_planes_hp(pk[slots])
    g = g.to(f64)
    ma, ms = b[j, 0, 0], b[j, 1, 0]
    v_all = g.sum(dim=1)
    mave, mstd = b[:, 0, 0], b[:, 1, 0]
    g_row = (ms * mstd) * (g[j] @ g.T - ma * v_all - g[j].sum() * mave
                           + n_real * ma * mave)
    s1, s2 = g[j] @ eps[:, t], eps[:, t].sum()
    num0 = b[j, 1, t] * (s1 - b[j, 0, t] * s2) + b[j, 2, t] * dnm1[t]
    abs_sum = (g[j].abs() @ eps[:, t].abs()
               + b[j, 0, t].abs() * eps[:, t].abs().sum())
    num0_err = float((eps.shape[0] + W + 4) * U32 * (
        b[j, 1, t].abs() * abs_sum + (b[j, 2, t] * dnm1[t]).abs()))
    return recurrence_edge(g_row, num0, db[:j, t], b[j, :, t], i_2se[t],
                           n_mix, comps, num0_err)


def _lib():
    from hydra_tpu_torch.ops import _build
    return _build.load("sweep_kernel_mt.cu")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _raise(lib, what, err):
    raise RuntimeError(f"{what} kernel launch failed: "
                       f"{lib.hydra_mt_error_string(err).decode()}")


def check_card_shapes(nb: int, window: int, n_traits: int) -> None:
    """What the CUDA kernels take (csrc/sweep_kernel_mt.cu): any window
    and trait count (above 1,024 markers and 16 traits their wide arms),
    packed rows of a multiple of 128 bytes."""
    if window < 1 or n_traits < 1:
        raise ValueError(f"the kernels take a window and traits of 1 or "
                         f"more, got window {window}, {n_traits} traits")
    if nb % 128:
        raise ValueError(f"packed width {nb} is not a multiple of 128 bytes "
                         "(individuals pad to 512, data/genotypes.py)")


def on_device(dev, **tensors) -> None:
    for name, t in tensors.items():
        if t is not None and (t.device != dev or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous and on {dev}")


def _launch(name, exact, pk, eps, tm, mrow, i_2se, dNm1, window, n_mix,
            complete, order, sync=None):
    dev = pk.device
    m_loc, nb = pk.shape
    T = eps.shape[1]
    check_card_shapes(nb, window, T)
    if n_mix < 2:
        raise ValueError(f"the sweep takes 2 or more mixture components, "
                         f"got {n_mix}")
    if order is None:
        order = torch.arange(m_loc, device=dev, dtype=torch.int32)
    if order.dtype != torch.int32:
        raise ValueError(f"order must be int32, got {order.dtype}")
    on_device(dev, pk=pk, eps=eps, tm=tm, mrow=mrow, order=order)
    lib = _lib()
    i2se = i_2se.to(device=dev, dtype=f32)
    dnm1 = dNm1.to(device=dev, dtype=f32)
    sc = torch.cat([i2se, dnm1, dnm1[:1] + 1.0]).contiguous()
    ws = torch.empty(lib.hydra_mt_workspace_bytes(m_loc, nb, window, T,
                                                  int(exact)),
                     dtype=torch.uint8, device=dev)
    eps_out = eps.clone()
    out = torch.zeros((m_loc, 3 * T), dtype=f32, device=dev)
    fn = lib.hydra_sweep_exact_mt if exact else lib.hydra_sweep_stale_mt
    args = (m_loc, nb, window, n_mix, T, int(complete))

    def check(err):
        if err:
            _raise(lib, name, err)
        launches[name] += 1

    with torch.cuda.device(dev):
        if sync is None:
            check(fn(pk.data_ptr(), eps_out.data_ptr(), tm.data_ptr(),
                     mrow.data_ptr(), order.data_ptr(), sc.data_ptr(),
                     out.data_ptr(), ws.data_ptr(), *args, _stream(dev)))
            return eps_out, out
        # marker shards: a window a launch, its change summed over ranks
        for w in range(m_loc // window):
            new = eps_out.clone()
            check(lib.hydra_sweep_windows_mt(
                int(exact), pk.data_ptr(), new.data_ptr(), tm.data_ptr(),
                mrow.data_ptr(), order.data_ptr(), sc.data_ptr(),
                out.data_ptr(), ws.data_ptr(), *args, w, w + 1, _stream(dev)))
            eps_out = _synced(eps_out, new, tm, sync)
    return eps_out, out


def sweep_stale_mt(pk, eps, tm, mrow, i_2se, dNm1, *, window: int, n_mix: int,
                   complete: bool, order: Optional[torch.Tensor] = None,
                   sync=None):
    """Stale multi-trait sweep: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors."""
    _check(pk, eps, tm, mrow, i_2se, dNm1, window, n_mix, order)
    if pk.device.type == "cpu":
        return sweep_stale_mt_ref(pk, eps, tm, mrow, i_2se, dNm1,
                                  window=window, n_mix=n_mix,
                                  complete=complete, order=order, sync=sync)
    if pk.device.type != "cuda":
        raise ValueError(f"no sweep kernel for device {pk.device}")
    return _launch("sweep_stale_mt", False, pk, eps, tm, mrow, i_2se, dNm1,
                   window, n_mix, complete, order, sync)


def sweep_exact_mt(pk, eps, tm, mrow, i_2se, dNm1, *, window: int, n_mix: int,
                   order: Optional[torch.Tensor] = None, sync=None):
    """Exact multi-trait sweep (complete genotypes and full phenotypes only;
    dNm1 is the same for every trait): the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors."""
    _check(pk, eps, tm, mrow, i_2se, dNm1, window, n_mix, order)
    if pk.device.type == "cpu":
        return sweep_exact_mt_ref(pk, eps, tm, mrow, i_2se, dNm1,
                                  window=window, n_mix=n_mix, order=order,
                                  sync=sync)
    if pk.device.type != "cuda":
        raise ValueError(f"no sweep kernel for device {pk.device}")
    return _launch("sweep_exact_mt", True, pk, eps, tm, mrow, i_2se, dNm1,
                   window, n_mix, True, order, sync)


def mt_window_recurrence(gram, num0, mrow, i_2se, *, n_mix: int,
                         rows: Optional[torch.Tensor] = None):
    """The exact recurrence of one window: the CUDA kernel on CUDA tensors,
    the plain version on CPU tensors. Returns (beta_new, comp, acum,
    dbeta), each (W, T)."""
    _check_recurrence(gram, num0, mrow, i_2se, n_mix, rows)
    if num0.device.type == "cpu":
        return mt_window_recurrence_ref(gram, num0, mrow, i_2se,
                                        n_mix=n_mix, rows=rows)
    if num0.device.type != "cuda":
        raise ValueError(f"no recurrence kernel for device {num0.device}")
    dev = num0.device
    W, T = num0.shape
    if n_mix < 2:
        raise ValueError(f"the recurrence takes 2 or more mixture "
                         f"components, got {n_mix}")
    if rows is None:
        rows = torch.arange(W, device=dev, dtype=torch.int32)
    if rows.dtype != torch.int32:
        raise ValueError(f"rows must be int32, got {rows.dtype}")
    i2se = i_2se.to(device=dev, dtype=f32).contiguous()
    on_device(dev, gram=gram, num0=num0, mrow=mrow, rows=rows)
    lib = _lib()
    out = torch.empty((4, W, T), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        err = lib.hydra_mt_window_recurrence(
            gram.data_ptr(), num0.data_ptr(), mrow.data_ptr(),
            rows.data_ptr(), i2se.data_ptr(), out.data_ptr(), W, n_mix, T,
            int(gram.dim() == 2), _stream(dev))
    if err:
        _raise(lib, "mt_window_recurrence", err)
    launches["mt_window_recurrence"] += 1
    return out[0], out[1], out[2], out[3]
