"""Collectives over the 1-D marker mesh: one rank a marker shard.

The 1-D part of ``hydra_tpu/parallel/mesh.py``. The reference shards
markers across MPI ranks and keeps the residual replicated, summing each
window's change with MPI_Allreduce (BayesRRm.cpp:2456-2460); the JAX
package does it with ``psum`` over the "markers" axis. Here the ranks of
the default ``torch.distributed`` group are the shards, in rank order.

  marker_sum   all_reduce(SUM); the identity on one rank
  det_sum      the port of ``det_psum``: each rank writes its addend into
               its own row of a zero (D, ...) buffer, one all_reduce only
               ever adds values to zeros (exact in any order: x + 0.0 is x,
               a -0.0 becomes +0.0 on every rank alike), then the rows are
               summed on each rank in rank order. The same bits for any
               backend or topology (--det-sync)
  gather_rows  every rank's tensor, stacked (D, ...) in rank order, by the
               same one-hot all_reduce: the exact exchange's all_gather
  shard_sum    a sampler's sum over its shards (the JAX ``ma_sum``):
               det_sum under --det-sync, else marker_sum

Each is an ``all_reduce``, which NCCL and gloo take on CPU and CUDA tensors
(gloo has no all_gather of CUDA tensors). Every rank calls each at the
same point.
"""

from __future__ import annotations

import torch
import torch.distributed as tdist

from hydra_tpu_torch.parallel import distributed


def marker_sum(v: torch.Tensor) -> torch.Tensor:
    """v summed over ranks (a new tensor; v is left as it is)."""
    if distributed.world_size() == 1:
        return v
    out = v.clone()
    tdist.all_reduce(out)
    return out


def gather_rows(v: torch.Tensor) -> torch.Tensor:
    """(D, *v.shape): row r is rank r's v, on every rank."""
    n = distributed.world_size()
    if n == 1:
        return v[None]
    buf = torch.zeros((n,) + tuple(v.shape), dtype=v.dtype, device=v.device)
    buf[distributed.rank()] = v
    tdist.all_reduce(buf)
    return buf


def det_sum(v: torch.Tensor) -> torch.Tensor:
    """v summed over ranks in rank order, the same bits on every topology."""
    n = distributed.world_size()
    if n == 1:
        return v
    rows = gather_rows(v)
    acc = rows[0]
    for r in range(1, n):
        acc = acc + rows[r]
    return acc


def shard_sum(v: torch.Tensor, n_dev: int, det: bool) -> torch.Tensor:
    """v summed over a sampler's n_dev marker shards (the JAX ``ma_sum``):
    ``det_sum`` under --det-sync, else ``marker_sum``; v itself on one
    shard."""
    if n_dev == 1:
        return v
    return (det_sum if det else marker_sum)(v)
