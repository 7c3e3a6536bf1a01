"""The exact-mode window Gibbs recurrence on its own.

Port of ``hydra_tpu/ops/gibbs_kernel.py``'s ``window_gibbs``: per marker j of
a window, in order,

    num_j   = num0_j + sum_{k<j} dbeta_k * Gram_jk
    comp_j  ~ categorical(logL(num_j)), beta_j ~ N(muk_comp, sd_comp)
    dbeta_j = beta_old_j - beta_j

with the draw form of the TPU kernel (clamp at -60, unnormalized u*s against
the running cum; ``ops/sweep_kernel.exact_draw``). All randomness (u, nrm)
is drawn by the caller. Inputs: gram (W, W) standardized and symmetric;
num0, u, nrm, act, bold (W,); logl_static (W, K); inv_denomk, sd_k
(W, K-1); i2se a number or a one-element tensor. Returns (dbeta, beta_new,
comp (int32), acum0), each (W,).

``window_gibbs`` launches ``hydra_window_gibbs`` of ``csrc/sweep_kernel.cu``
for CUDA tensors: ``window_gibbs_kernel``, one block on the exact sweep's
warp-synchronous schedule (``warp_recurrence``: each lane's constants in
registers, one barrier a 32 steps) and its draw; for CPU tensors it runs
``window_gibbs_ref``, which applies the Gram row by row in the kernel's
step order (num_i += Gram_ji * dbeta_j after step j).
"""

from __future__ import annotations

from typing import Tuple

import torch

from hydra_tpu_torch.ops.sweep_kernel import exact_draw

f32 = torch.float32

# Kernel launches through the wrapper (one per window of the per-window
# branch's exact sweeps).
launches = {"window_gibbs": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check(gram, num0, logl_static, inv_denomk, sd_k, u, nrm, act, bold):
    if num0.dtype != f32 or num0.dim() != 1:
        raise ValueError(f"num0 must be (W,) float32, got {num0.dtype} "
                         f"{tuple(num0.shape)}")
    W = num0.shape[0]
    if logl_static.dim() != 2 or logl_static.shape[0] != W:
        raise ValueError(f"logl_static must be ({W}, K), got "
                         f"{tuple(logl_static.shape)}")
    K = logl_static.shape[1]
    shapes = dict(gram=(W, W), logl_static=(W, K), inv_denomk=(W, K - 1),
                  sd_k=(W, K - 1), u=(W,), nrm=(W,), act=(W,), bold=(W,))
    given = dict(gram=gram, logl_static=logl_static, inv_denomk=inv_denomk,
                 sd_k=sd_k, u=u, nrm=nrm, act=act, bold=bold)
    for name, x in given.items():
        if x.dtype != f32 or tuple(x.shape) != shapes[name]:
            raise ValueError(f"{name} must be {shapes[name]} float32, got "
                             f"{x.dtype} {tuple(x.shape)}")
    return W, K


@torch.inference_mode()
def window_gibbs_ref(gram, num0, logl_static, inv_denomk, sd_k, u, nrm, act,
                     bold, i2se) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor, torch.Tensor]:
    """Plain PyTorch recurrence (same contract as ``window_gibbs``)."""
    W, _ = _check(gram, num0, logl_static, inv_denomk, sd_k, u, nrm, act,
                  bold)
    i2se = torch.as_tensor(i2se, dtype=f32, device=num0.device).reshape(())
    numv = num0.clone()
    res = []
    for j in range(W):
        r = exact_draw(numv[j], logl_static[j], inv_denomk[j], sd_k[j], u[j],
                       nrm[j], act[j], bold[j], i2se)
        numv = numv + gram[j] * r[3]
        res.append(torch.stack(r))
    bnew, comp, acum, dbeta = torch.stack(res).unbind(1)
    return dbeta, bnew, comp.to(torch.int32), acum


def window_gibbs(gram, num0, logl_static, inv_denomk, sd_k, u, nrm, act, bold,
                 i2se) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """(dbeta, beta_new, comp, acum0) of one window: the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors."""
    W, K = _check(gram, num0, logl_static, inv_denomk, sd_k, u, nrm, act,
                  bold)
    if num0.device.type == "cpu":
        return window_gibbs_ref(gram, num0, logl_static, inv_denomk, sd_k, u,
                                nrm, act, bold, i2se)
    if num0.device.type != "cuda":
        raise ValueError(f"no window_gibbs kernel for device {num0.device}")
    if K < 2:
        raise ValueError(f"the recurrence takes 2 or more mixture "
                         f"components, got {K}")
    from hydra_tpu_torch.ops import _build

    dev = num0.device
    ins = (gram, num0, logl_static, inv_denomk, sd_k, u, nrm, act, bold)
    for x in ins:
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"window_gibbs operands must be contiguous and "
                             f"on {dev}")
    i2se = torch.as_tensor(i2se, dtype=f32, device=dev).reshape(1)
    lib = _build.load()
    out = torch.empty((3, W), dtype=f32, device=dev)
    comp = torch.empty(W, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.hydra_window_gibbs(
            *(x.data_ptr() for x in ins), i2se.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), comp.data_ptr(), out[2].data_ptr(), W, K,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("window_gibbs kernel launch failed: "
                           f"{lib.hydra_sweep_error_string(err).decode()}")
    launches["window_gibbs"] += 1
    return out[0], out[1], comp, out[2]
