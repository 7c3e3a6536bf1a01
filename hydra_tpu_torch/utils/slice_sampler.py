"""Vectorized slice sampling with fixed budgets (replaces the reference's ARMS).

Port of ``hydra_tpu/utils/slice_sampler.py``. The reference samples its
log-concave BayesW conditionals (mu, Weibull shape alpha, non-zero beta)
with adaptive rejection metropolis sampling (src/BayesW_arms.cpp); slice
sampling (Neal 2003) has the same stationary law, needs only log-density
evaluations and runs a batch of independent targets at once.

Fixed budgets keep the work data-independent: ``n_expand`` stepping-out
steps on each side, then ``n_shrink`` shrinkage steps. If the budget runs
out the current point is kept (a lazy but valid transition). No step
branches on a value on the host, so a draw on the card never waits for it.

The randomness is explicit: ``slice_noise`` draws (exponential level,
bracket uniform, shrink uniforms) from a ``torch.Generator``, and
``slice_sample_noise`` takes them as tensors, which is how the tests hand
the JAX sampler's draws to the port.
"""

from __future__ import annotations

from typing import Callable

import torch

from hydra_tpu_torch.utils.dist import exponential_rng

N_EXPAND, N_SHRINK = 10, 24


def slice_noise(g: torch.Generator, shape=(), n_shrink: int = N_SHRINK,
                device="cpu", dtype=torch.float32):
    """(log_exp (shape,), u_bracket (shape,), u_shrink (n_shrink,) + shape)
    for one slice transition of each target."""
    shape = tuple(shape)
    le = exponential_rng(g, shape, device, dtype)
    ub = torch.rand(shape, generator=g, device=device, dtype=dtype)
    uu = torch.rand((n_shrink,) + shape, generator=g, device=device,
                    dtype=dtype)
    return le, ub, uu


def slice_sample(logf: Callable, x0: torch.Tensor, g: torch.Generator,
                 width, lower=-float("inf"), upper=float("inf"),
                 n_expand: int = N_EXPAND, n_shrink: int = N_SHRINK,
                 mask=None) -> torch.Tensor:
    """One slice-sampling transition for a batch of independent targets,
    its randomness drawn from ``g``."""
    le, ub, uu = slice_noise(g, x0.shape, n_shrink, x0.device, x0.dtype)
    return slice_sample_noise(logf, x0, le, ub, uu, width, lower, upper,
                              n_expand=n_expand, n_shrink=n_shrink, mask=mask)


def slice_sample_noise(logf: Callable, x0: torch.Tensor,
                       log_exp: torch.Tensor, u_bracket: torch.Tensor,
                       u_shrink: torch.Tensor, width,
                       lower=-float("inf"), upper=float("inf"),
                       n_expand: int = N_EXPAND, n_shrink: int = N_SHRINK,
                       mask=None) -> torch.Tensor:
    """``slice_sample`` with the randomness passed in: log_exp and
    u_bracket of x0's shape, u_shrink of (n_shrink,) + x0's shape.

    logf maps points of x0's shape to log densities; mask (bool, x0's
    shape) leaves False targets at x0."""
    def t(v):
        return torch.as_tensor(v, dtype=x0.dtype, device=x0.device)

    lower, upper = t(lower), t(upper)
    width = torch.broadcast_to(t(width), x0.shape)
    log_y = logf(x0) - log_exp
    left = x0 - width * u_bracket
    right = left + width
    for _ in range(n_expand):
        left = torch.where((logf(left) > log_y) & (left > lower),
                           left - width, left)
        right = torch.where((logf(right) > log_y) & (right < upper),
                            right + width, right)
    left = torch.maximum(left, lower)
    right = torch.minimum(right, upper)
    x = x0
    accepted = torch.zeros(x0.shape, dtype=torch.bool, device=x0.device)
    for i in range(n_shrink):
        xc = left + u_shrink[i] * (right - left)
        ok = logf(xc) > log_y
        x = torch.where(ok & ~accepted, xc, x)
        accepted = accepted | ok
        shrinkable = ~accepted
        left = torch.where(shrinkable & (xc < x0), xc, left)
        right = torch.where(shrinkable & (xc >= x0), xc, right)
    x = torch.where(accepted, x, x0)
    if mask is not None:
        x = torch.where(mask, x, x0)
    return x


def slice_sample_rounds(logf: Callable, x0: torch.Tensor,
                        log_exp: torch.Tensor, u_bracket: torch.Tensor,
                        u_shrink: torch.Tensor, width,
                        lower=-float("inf"), upper=float("inf"),
                        n_expand: int = N_EXPAND,
                        n_shrink: int = N_SHRINK) -> torch.Tensor:
    """``slice_sample_noise``'s transition with logf evaluated in three
    rounds instead of 2 n_expand + n_shrink: at x0, at every stepping-out
    point of both sides (each built by the loop's own repeated subtraction
    or addition of width; a side stops at its first failing point, where
    the fixed-budget loop stays), and at every shrink candidate (each
    built as if the steps before it were rejected: a rejection moves the
    bracket by xc < x0 alone), the first accepted one the draw. The same
    arithmetic in the same order, so the same draw; logf takes points
    (k,) + x0's shape. Far fewer kernel launches on a card."""
    def t(v):
        return torch.as_tensor(v, dtype=x0.dtype, device=x0.device)

    lower, upper = t(lower), t(upper)
    width = torch.broadcast_to(t(width), x0.shape)
    left0 = x0 - width * u_bracket
    lefts, rights = [left0], [left0 + width]
    for _ in range(n_expand):
        lefts.append(lefts[-1] - width)
        rights.append(rights[-1] + width)
    lefts, rights = torch.stack(lefts), torch.stack(rights)
    f = logf(torch.cat([x0[None], lefts[:n_expand], rights[:n_expand]]))
    log_y = f[0] - log_exp

    def stop(pts, fp, inside):
        # the first failing step (n_expand where none fails)
        fail = torch.cat([~((fp > log_y) & inside),
                          torch.ones_like(x0, dtype=torch.bool)[None]])
        return pts.gather(0, fail.to(torch.uint8).argmax(0, keepdim=True))[0]

    left = torch.maximum(
        stop(lefts, f[1:n_expand + 1], lefts[:n_expand] > lower), lower)
    right = torch.minimum(
        stop(rights, f[n_expand + 1:], rights[:n_expand] < upper), upper)
    if not n_shrink:
        return x0
    cands = []
    for i in range(n_shrink):
        xc = left + u_shrink[i] * (right - left)
        cands.append(xc)
        left = torch.where(xc < x0, xc, left)
        right = torch.where(xc >= x0, xc, right)
    cands = torch.stack(cands)
    ok = logf(cands) > log_y
    first = torch.cat([ok, torch.ones_like(x0, dtype=torch.bool)[None]]
                      ).to(torch.uint8).argmax(0, keepdim=True)
    x = torch.cat([cands, x0[None]]).gather(0, first)[0]
    return x
