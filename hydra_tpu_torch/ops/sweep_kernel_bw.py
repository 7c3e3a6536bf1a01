"""Whole-sweep BayesW kernel: every stale window of one sweep.

Port of ``hydra_tpu/ops/sweep_kernel_bw.py`` (``sweep_stale_bw``). Per
window of W markers (slots ``order[w*W:(w+1)*W]``):

  level sums s1 = sum_{g=1} vi, s2 = sum_{g=2} vi, the mask dot and
  sum(vi) -> closed-form removal of each marker's own effect -> adaptive
  Gauss-Hermite marginal likelihoods -> component draw -> fixed-budget
  slice draw of beta (utils/slice_sampler.py) -> residual axpy and
  vi = exp(alpha*eps - EuMasc) * mask (BayesW.cpp:1480-1834).

Everything per marker, including all the randomness, arrives in ``mrow``,
whose column layout is the JAX package's (``bw_mrow_width``; 54 columns
at K=4, S=24), so one row array feeds both packages.

Layouts at this interface:
  pk      (m_loc, NB) uint8   h-packed genotypes in SLOT order
  eps, vi (4*NB,) f32         residual and vi in individual order
  mrow    (m_loc, C) f32      per-slot rows, column layout below
  gh_x/w  (Q,) f32            Gauss-Hermite nodes and adjusted weights
  alpha   () f32              Weibull shape (a device tensor: no host sync)
  ind_mask (4*NB,) f32        1 on real individuals
  order   (m_loc,) int32      sweep position -> slot (``block_order``)
Returns (eps', out) with out (m_loc, 4) = [beta_new, comp, dbeta, 0] per
slot.

``sweep_stale_bw`` launches ``hydra_sweep_stale_bw`` of
``csrc/sweep_kernel_bw.cu`` for CUDA tensors (levels_kernel,
bw_draw_kernel and axpy_kernel per window) and raises on what it does not
take; for CPU tensors it runs the plain version ``sweep_stale_bw_ref``,
which repeats the kernels' arithmetic in their order (see
``ops/window_kernels.py``) and which the tests hold against the JAX
sampler. Its draw ``_draw`` runs the fixed slice budget vectorized over
the window; ``bw_draw_early_exit_ref`` is one marker's draw in
bw_draw_kernel's order (a warp per marker: the slice skipped where its
result is unused, stepping out and shrinking each in one round of
evaluations), which the CPU tests hold bit for bit against ``_draw``.
"""

from __future__ import annotations

from typing import Optional

import torch

from hydra_tpu_torch.ops import window_kernels as wk
from hydra_tpu_torch.utils.slice_sampler import (N_EXPAND, N_SHRINK,
                                                 slice_sample_rounds)

f32 = torch.float32
EULER_MASCHERONI = 0.577215664901532   # EuMasc, BayesW.cpp:42
Q_MAX = 64                             # csrc/sweep_kernel_bw.cu

# mrow column layout (K = mixtures incl. zero, J = K-1, S = n_shrink):
#   0 mave, 1 inv_sd, 2 bold, 3 u, 4 act, 5 sf,
#   6 th0, 7 th1, 8 th2,            theta coefficients of the expm1 form
#   9 e0, 10 e1, 11 e2,             own-effect removal factors
#   12 ml0,                         pi0 * sqrt(pi) (zero-component ml)
#   13..13+J-1        pj            non-zero pi factors
#   +J                sqrt2ck_j     sqrt(2 c_k sigmaG)
#   +2J               adc_j         alpha^2 sigmaG c_k (sigma_ad)
#   +3J               two_ck_sg_j   2 c_k max(sigmaG, tiny)
#   +4J               slim_j        2 sqrt(sum sigmaG * c_k) (safe limit)
#   13+5J             le            slice exponential draw
#   14+5J             u_br          slice bracket uniform
#   15+5J..+S-1       uu_s          slice shrink uniforms
N_FIXED = 13

# One count per sweep launched on the card; the per-window kernels it runs
# are counted in window_kernels.launches.
launches = {"sweep_stale_bw": 0}


def bw_mrow_width(k: int, n_shrink: int = N_SHRINK) -> int:
    return N_FIXED + 5 * (k - 1) + 2 + n_shrink


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check(pk, eps, vi, mrow, gh_x, gh_w, window, n_mix, ind_mask, order,
           n_shrink):
    if pk.dtype != torch.uint8 or pk.dim() != 2:
        raise ValueError(f"pk must be (m_loc, NB) uint8, got {pk.dtype} "
                         f"{tuple(pk.shape)}")
    m_loc, nb = pk.shape
    for name, t in (("eps", eps), ("vi", vi), ("ind_mask", ind_mask)):
        if t.dtype != f32 or tuple(t.shape) != (4 * nb,):
            raise ValueError(f"{name} must be ({4 * nb},) float32, got "
                             f"{t.dtype} {tuple(t.shape)}")
    C = bw_mrow_width(n_mix, n_shrink)
    if mrow.dtype != f32 or tuple(mrow.shape) != (m_loc, C):
        raise ValueError(f"mrow must be ({m_loc}, {C}) float32, got "
                         f"{mrow.dtype} {tuple(mrow.shape)}")
    if gh_x.dtype != f32 or gh_x.dim() != 1 or gh_w.shape != gh_x.shape:
        raise ValueError("gh_x and gh_w must be equal (Q,) float32 vectors")
    if window < 1 or m_loc % window:
        raise ValueError(f"m_loc {m_loc} is not a multiple of window {window}")
    if order is not None and tuple(order.shape) != (m_loc,):
        raise ValueError(f"order must be ({m_loc},), got {tuple(order.shape)}")


def _draw(rows, s1, s2, sb, s_all, gh_x, gh_w, alpha, K, complete,
          n_expand, n_shrink):
    """The window's draw (bw_draw_kernel), vectorized over its W markers,
    operation by operation in the kernel's order: the quadrature terms of
    all nodes at once, each component's summed in node order, and the
    slice draw's density in three rounds (``slice_sample_rounds``)."""
    km1 = K - 1
    (mave, inv_sd, bold, u, act, sf, th0, th1, th2, e0, e1, e2,
     ml0) = rows[:, :N_FIXED].unbind(1)
    sm = torch.zeros_like(s1) if complete else s_all - sb
    s0 = s_all - s1 - s2 - sm
    # own-effect removal (tmp_vi recompute, BayesW.cpp:1499-1516)
    vi1 = s1 * e1
    vi2 = s2 * e2
    vsum = s0 * e0 + vi1 + vi2 + sm
    vi0 = vsum - vi1 - vi2
    exp_sum = (vi1 * (1.0 - 2.0 * mave) + 4.0 * (1.0 - mave) * vi2
               + vsum * mave * mave) * inv_sd * inv_sd

    def cols(j):
        return rows[:, N_FIXED + j * km1:N_FIXED + (j + 1) * km1]

    pj, sqrt2ck, adc, two_ck_sg_k, slim_k = (cols(j) for j in range(5))
    br = N_FIXED + 5 * km1
    # adaptive Gauss-Hermite marginal likelihoods (BayesW.cpp:716-726);
    # sigma_ad is the substitution's Jacobian (BayesW.cpp:711)
    sigma_ad = 1.0 / torch.sqrt(1.0 + adc * exp_sum[:, None])     # (W, J)
    # (Q, W, J): every node's term at once, added in node order
    s_node = sigma_ad * gh_x[:, None, None]
    sq = s_node * sqrt2ck
    temp = (-alpha * sq * sf[:, None]
            - vi0[:, None] * torch.expm1(th0[:, None] * sq)
            - vi1[:, None] * torch.expm1(th1[:, None] * sq)
            - vi2[:, None] * torch.expm1(th2[:, None] * sq)
            - s_node * s_node)
    terms = gh_w[:, None, None] * torch.exp(temp)
    acc = terms[0]
    for q in range(1, gh_x.shape[0]):
        acc = acc + terms[q]
    ml = pj * (sigma_ad * acc)                                     # (W, J)
    sm_ml = ml0
    for j in range(km1):
        sm_ml = sm_ml + ml[:, j]
    # comp = min(#{cum probs < u}, K-1), zeroed for inactive markers
    cum = ml0 / sm_ml
    compf = (u > cum).to(f32)
    for j in range(km1):
        cum = cum + ml[:, j] / sm_ml
        compf = compf + (u > cum).to(f32)
    compf = torch.clamp(compf, max=float(km1)) * act

    # fixed-budget slice sampler on beta_dens (BayesW.cpp:145-156)
    ksel = torch.clamp(compf - 1.0, min=0.0).to(torch.int64)[:, None]
    two_ck_sg = two_ck_sg_k.gather(1, ksel)[:, 0]
    slim = slim_k.gather(1, ksel)[:, 0]

    def logf(x):
        return (-alpha * x * sf - vi0 * torch.expm1(th0 * x)
                - vi1 * torch.expm1(th1 * x) - vi2 * torch.expm1(th2 * x)
                - x * x / two_ck_sg)

    x = slice_sample_rounds(logf, bold, rows[:, br], rows[:, br + 1],
                            rows[:, br + 2:br + 2 + n_shrink].T,
                            torch.clamp(slim / 5.0, min=1e-3),
                            lower=bold - slim, upper=bold + slim,
                            n_expand=n_expand, n_shrink=n_shrink)
    bnew = torch.where((compf > 0.0) & (act > 0.0), x, 0.0)
    return bnew, compf, bold - bnew


def bw_draw_early_exit_ref(row, s1, s2, sb, s_all, gh_x, gh_w, alpha, K,
                           complete, n_expand=N_EXPAND, n_shrink=N_SHRINK,
                           info: Optional[dict] = None):
    """One marker's draw in bw_draw_kernel's order (a warp per marker),
    bit for bit ``_draw``'s for that marker.

    row (C,) is the marker's mrow row; s1, s2, sb (None when complete) and
    s_all its level sums, alpha the shape (0-dim f32). The (K-1, Q)
    quadrature terms are computed at once (the lanes), each component's
    added in node order from 0; the slice draw runs only where comp and act
    are non-zero (elsewhere beta_new = 0 whatever it returns); the stepping-
    out points bold, left_0..left_{n-1}, right_0..right_{n-1} (each by the
    loop's own repeated subtraction or addition of width) are evaluated
    together and each side stops at its first failing step (the fixed-
    budget loop re-tests that point and fails again); the shrink steps'
    candidates are built by the bracket chain as if each step before them
    was rejected (a rejection moves the bracket by xc < bold alone), f is
    evaluated at all of them together, and the first accepted one is the
    draw. ``info`` (a dict) receives which branches ran: slice, left_steps,
    right_steps, left_at_lower, right_at_upper, shrinks (up to the accepted
    step), accepted. Returns (beta_new, comp, dbeta)."""
    km1 = K - 1
    (mave, inv_sd, bold, u, act, sf, th0, th1, th2, e0, e1, e2,
     ml0) = row[:N_FIXED].unbind()
    sm = torch.zeros_like(s1) if complete else s_all - sb
    s0 = s_all - s1 - s2 - sm
    vi1 = s1 * e1
    vi2 = s2 * e2
    vsum = s0 * e0 + vi1 + vi2 + sm
    vi0 = vsum - vi1 - vi2
    exp_sum = (vi1 * (1.0 - 2.0 * mave) + 4.0 * (1.0 - mave) * vi2
               + vsum * mave * mave) * inv_sd * inv_sd
    pj, sqrt2ck, adc, two_ck_sg_k, slim_k = (
        row[N_FIXED + j * km1:N_FIXED + (j + 1) * km1] for j in range(5))
    br = N_FIXED + 5 * km1
    # the lanes' quadrature terms (j, q); lane j + 1 adds row j in q order
    sigma_ad = 1.0 / torch.sqrt(1.0 + adc * exp_sum)             # (J,)
    s_node = sigma_ad[:, None] * gh_x[None, :]                    # (J, Q)
    sq = s_node * sqrt2ck[:, None]
    temp = (-alpha * sq * sf - vi0 * torch.expm1(th0 * sq)
            - vi1 * torch.expm1(th1 * sq) - vi2 * torch.expm1(th2 * sq)
            - s_node * s_node)
    term = gh_w * torch.exp(temp)
    acc = torch.zeros(km1, dtype=f32, device=row.device)
    for q in range(gh_x.shape[0]):
        acc = acc + term[:, q]
    ml = pj * (sigma_ad * acc)
    sm_ml = ml0
    for j in range(km1):
        sm_ml = sm_ml + ml[j]
    cum = ml0 / sm_ml
    compf = (u > cum).to(f32)
    for j in range(km1):
        cum = cum + ml[j] / sm_ml
        compf = compf + (u > cum).to(f32)
    compf = torch.clamp(compf, max=float(km1)) * act
    info = {} if info is None else info
    info.update(slice=bool(compf > 0.0) and bool(act > 0.0), left_steps=0,
                right_steps=0, left_at_lower=False, right_at_upper=False,
                shrinks=0, accepted=False)
    if not info["slice"]:
        bnew = torch.zeros_like(bold)
        return bnew, compf, bold - bnew

    ksel = int(compf.item()) - 1 if compf > 1.0 else 0
    two_ck_sg, slim = two_ck_sg_k[ksel], slim_k[ksel]

    def logf(x):
        return (-alpha * x * sf - vi0 * torch.expm1(th0 * x)
                - vi1 * torch.expm1(th1 * x) - vi2 * torch.expm1(th2 * x)
                - x * x / two_ck_sg)

    width = torch.clamp(slim / 5.0, min=1e-3)
    lower, upper = bold - slim, bold + slim
    left0 = bold - width * row[br + 1]
    right0 = left0 + width
    lefts, rights = [left0], [right0]
    for _ in range(n_expand):
        lefts.append(lefts[-1] - width)
        rights.append(rights[-1] + width)
    # one round: f at bold and at the n_expand points of each side
    fp = logf(torch.stack([bold] + lefts[:n_expand] + rights[:n_expand]))
    log_y = fp[0] - row[br]

    def first_fail(ok):
        return next((k for k in range(n_expand) if not ok[k]), n_expand)

    kl = first_fail([bool(fp[1 + k] > log_y) and bool(lefts[k] > lower)
                     for k in range(n_expand)])
    kr = first_fail([bool(fp[1 + n_expand + k] > log_y)
                     and bool(rights[k] < upper) for k in range(n_expand)])
    info.update(left_steps=kl, right_steps=kr,
                left_at_lower=kl < n_expand and bool(lefts[kl] <= lower),
                right_at_upper=kr < n_expand and bool(rights[kr] >= upper))
    left = torch.maximum(lefts[kl], lower)
    right = torch.minimum(rights[kr], upper)
    # shrinking in one round: a rejected step moves the bracket by
    # xc < bold alone, so every step's candidate (as if the steps before
    # it were rejected) follows without f; the first accepted one is x
    cands = []
    for s in range(n_shrink):
        xc = left + row[br + 2 + s] * (right - left)
        cands.append(xc)
        if xc < bold:
            left = xc
        else:
            right = xc
    x = bold
    if n_shrink:
        ok = (logf(torch.stack(cands)) > log_y).tolist()
        first = next((s for s in range(n_shrink) if ok[s]), None)
        info.update(shrinks=n_shrink if first is None else first + 1,
                    accepted=first is not None)
        if first is not None:
            x = cands[first]
    return x, compf, bold - x


@torch.inference_mode()
def sweep_stale_bw_ref(pk, eps, vi, mrow, gh_x, gh_w, alpha, *, window: int,
                       n_mix: int, complete: bool, ind_mask: torch.Tensor,
                       order: Optional[torch.Tensor] = None,
                       n_expand: int = N_EXPAND, n_shrink: int = N_SHRINK):
    """Plain PyTorch BayesW sweep (the CUDA kernels' arithmetic)."""
    _check(pk, eps, vi, mrow, gh_x, gh_w, window, n_mix, ind_mask, order,
           n_shrink)
    m_loc = pk.shape[0]
    W = window
    alpha = torch.as_tensor(alpha, dtype=f32, device=pk.device)
    order = (torch.arange(m_loc, device=pk.device) if order is None
             else order.to(device=pk.device, dtype=torch.int64))
    eps = eps.clone()
    out = torch.zeros((m_loc, 4), dtype=f32, device=pk.device)
    for w in range(m_loc // W):
        slots = order[w * W:(w + 1) * W]
        rows = mrow[slots]
        pk_w = pk[slots]
        p1, p2, pb, pa = wk.level_partials(pk_w, vi, complete)
        s_all = wk.seq_sum(pa)
        bnew, comp, dbeta = _draw(
            rows, wk.seq_sum(p1), wk.seq_sum(p2),
            None if complete else wk.seq_sum(pb), s_all, gh_x, gh_w, alpha,
            n_mix, complete, n_expand, n_shrink)
        c1 = dbeta * rows[:, 1]
        c2 = -c1 * rows[:, 0]
        acc = wk.axpy_rows(pk_w, c1, c2, complete)
        if complete:
            # h-decode: (2 sum c1 + sum c2 - sum c1*h) * mask
            cst = 2.0 * wk.seq_sum(c1) + wk.seq_sum(c2)
            eps = eps + (cst - acc) * ind_mask
        else:
            eps = eps + acc
        vi = torch.exp(alpha * eps - EULER_MASCHERONI) * ind_mask
        out[slots] = torch.stack([bnew, comp, dbeta, torch.zeros_like(bnew)],
                                 dim=1)
    return eps, out


def sweep_stale_bw(pk, eps, vi, mrow, gh_x, gh_w, alpha, *, window: int,
                   n_mix: int, complete: bool, ind_mask: torch.Tensor,
                   order: Optional[torch.Tensor] = None,
                   n_expand: int = N_EXPAND, n_shrink: int = N_SHRINK):
    """BayesW stale-window sweep: the CUDA kernels on CUDA tensors, the
    plain version on CPU tensors."""
    _check(pk, eps, vi, mrow, gh_x, gh_w, window, n_mix, ind_mask, order,
           n_shrink)
    kw = dict(window=window, n_mix=n_mix, complete=complete,
              ind_mask=ind_mask, order=order, n_expand=n_expand,
              n_shrink=n_shrink)
    if pk.device.type == "cpu":
        return sweep_stale_bw_ref(pk, eps, vi, mrow, gh_x, gh_w, alpha, **kw)
    if pk.device.type != "cuda":
        raise ValueError(f"no sweep kernel for device {pk.device}")
    from hydra_tpu_torch.ops import _build

    dev = pk.device
    m_loc, nb = pk.shape
    if n_mix < 2:
        raise ValueError(f"the sweep takes 2 or more mixture components, "
                         f"got {n_mix}")
    if not 1 <= gh_x.shape[0] <= Q_MAX:
        raise ValueError(f"the CUDA sweep takes 1..{Q_MAX} quadrature "
                         f"points, got {gh_x.shape[0]}")
    if nb % 128:
        raise ValueError(f"packed width {nb} is not a multiple of 128 bytes "
                         "(individuals pad to 512, data/genotypes.py)")
    if order is None:
        order = torch.arange(m_loc, device=dev, dtype=torch.int32)
    if order.dtype != torch.int32:
        raise ValueError(f"order must be int32, got {order.dtype}")
    for t in (pk, eps, vi, mrow, gh_x, gh_w, ind_mask, order):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"sweep operands must be contiguous and on {dev}")
    lib = _build.load("sweep_kernel_bw.cu")
    sc = torch.as_tensor(alpha, dtype=f32, device=dev).reshape(1).contiguous()
    ws = torch.empty(lib.hydra_bw_workspace_bytes(nb, window),
                     dtype=torch.uint8, device=dev)
    eps_out = eps.clone()
    vi_work = vi.clone()
    out = torch.zeros((m_loc, 4), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        err = lib.hydra_sweep_stale_bw(
            pk.data_ptr(), eps_out.data_ptr(), vi_work.data_ptr(),
            mrow.data_ptr(), order.data_ptr(), ind_mask.data_ptr(),
            gh_x.data_ptr(), gh_w.data_ptr(), gh_x.shape[0], sc.data_ptr(),
            out.data_ptr(), ws.data_ptr(), m_loc, nb, window, n_mix,
            int(complete), n_expand, n_shrink,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("sweep_stale_bw kernel launch failed: "
                           f"{lib.hydra_bw_error_string(err).decode()}")
    n_windows = m_loc // window
    launches["sweep_stale_bw"] += 1
    wk.launches["window_level_sums"] += n_windows
    wk.launches["window_axpy"] += n_windows
    return eps_out, out
