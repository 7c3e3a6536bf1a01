"""Collectives over the rank grid: marker shards and chunks of individuals.

The port of ``hydra_tpu/parallel/mesh.py``'s sums. The reference shards
markers across MPI ranks and keeps the residual replicated, summing each
window's change with MPI_Allreduce (BayesRRm.cpp:2456-2460); the JAX
package does it with ``psum`` over the "markers" axis, and with
``--ind-shards`` adds a psum over the "inds" axis for every sum over
individuals. Here the marker shards are the ranks of a marker group and the
chunks of individuals the ranks of an individual group
(``distributed.rank_grid``); a ``group`` of None is every rank.

  marker_sum   all_reduce(SUM) over ``group``; the identity on one rank
  det_sum      the port of ``det_psum``: each rank writes its addend into
               its own row of a zero (D, ...) buffer, one all_reduce only
               ever adds values to zeros (exact in any order: x + 0.0 is x,
               a -0.0 becomes +0.0 on every rank alike), then the rows are
               summed on each rank in rank order. The same bits for any
               backend or topology (--det-sync)
  gather_rows  every rank's tensor of ``group``, stacked (D, ...) in rank
               order, by the same one-hot all_reduce: the exact exchange's
               all_gather
  shard_sum    a sampler's sum over its marker shards (the JAX ``ma_sum``):
               det_sum under --det-sync, else marker_sum
  hier_sum     the port of ``hier_psum`` (--dcn-slices S): the sum over
               this rank's slice, then over its position across slices,
               a 1-D vector whose length divides by DCN_CHUNKS in that
               many chunks
  residual_sum the sum of a window's residual change (the JAX ``hpsum``):
               hier_sum for S > 1 without --det-sync, else shard_sum
  ind_sum      a sum over the chunks of individuals (the JAX ``psum_i``):
               the rank-order sum of det_sum over the individual group, so
               every rank of it gets the same bits and draws alike

Each is an ``all_reduce``, which NCCL and gloo take on CPU and CUDA tensors
(gloo has no all_gather of CUDA tensors). Every rank of a group calls each
at the same point.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as tdist

from hydra_tpu_torch.parallel import distributed


def marker_sum(v: torch.Tensor, group=None) -> torch.Tensor:
    """v summed over ``group``'s ranks (a new tensor; v is left as it
    is)."""
    if distributed.group_size(group) == 1:
        return v
    out = v.clone()
    tdist.all_reduce(out, group=group)
    return out


def gather_rows(v: torch.Tensor, group=None) -> torch.Tensor:
    """(D, *v.shape): row r is the v of ``group``'s rank r, on every rank
    of it."""
    n = distributed.group_size(group)
    if n == 1:
        return v[None]
    buf = torch.zeros((n,) + tuple(v.shape), dtype=v.dtype, device=v.device)
    buf[tdist.get_rank(group)] = v
    tdist.all_reduce(buf, group=group)
    return buf


def det_sum(v: torch.Tensor, group=None) -> torch.Tensor:
    """v summed over ``group``'s ranks in rank order, the same bits on every
    topology."""
    if distributed.group_size(group) == 1:
        return v
    rows = gather_rows(v, group)
    acc = rows[0]
    for r in range(1, rows.shape[0]):
        acc = acc + rows[r]
    return acc


def shard_sum(v: torch.Tensor, n_dev: int, det: bool,
              group=None) -> torch.Tensor:
    """v summed over a sampler's n_dev marker shards, the ranks of its
    marker ``group`` (the JAX ``ma_sum``): ``det_sum`` under --det-sync,
    else ``marker_sum``; v itself on one shard."""
    if n_dev == 1:
        return v
    return (det_sum if det else marker_sum)(v, group)


def ind_sum(v: torch.Tensor, grid) -> torch.Tensor:
    """v summed over the chunks of individuals of ``grid``'s individual
    group (the JAX ``psum_i``) in rank order: the draws that follow must be
    the same on every rank of the group, and a plain all_reduce's bits are
    not promised alike on every rank. v itself at I = 1 (``grid`` None or
    of one chunk)."""
    if grid is None or grid.n_ind == 1:
        return v
    return det_sum(v, grid.inds)


# The JAX hier_psum's chunk count over the dcn axis (mesh.py:115-136). There
# it lets XLA overlap the chunks' transfers; here each chunk is a blocking
# all_reduce of its own, the same elementwise sum in DCN_CHUNKS calls.
DCN_CHUNKS = 8


def hier_sum(v: torch.Tensor, groups) -> torch.Tensor:
    """v summed over the marker hierarchy of ``distributed.rank_grid``
    (the JAX ``hier_psum``, hydra_tpu/parallel/mesh.py:115-136): one
    all_reduce over the rank's slice group, then over its dcn group, which
    a 1-D v whose length divides by DCN_CHUNKS crosses in DCN_CHUNKS
    separate all_reduces of a chunk each and anything else (the (n_pad, T)
    multi-trait change) in one. A group of one rank is skipped. A new
    tensor; v is left as it is."""
    slice_g, dcn_g = groups
    out = v.clone()
    if tdist.get_world_size(slice_g) > 1:
        tdist.all_reduce(out, group=slice_g)
    if tdist.get_world_size(dcn_g) == 1:
        return out
    if out.dim() == 1 and out.shape[0] % DCN_CHUNKS == 0:
        for part in out.view(DCN_CHUNKS, -1):
            tdist.all_reduce(part, group=dcn_g)
    else:
        tdist.all_reduce(out, group=dcn_g)
    return out


def residual_sum(n_dev: int, det: bool, n_dcn: int = 1, n_ind: int = 1):
    """A sampler's sum of a window's residual change over its marker shards
    (the JAX ``hpsum``), on the grid of ``n_dcn`` slices and ``n_ind``
    chunks (its groups made here, a collective point): ``hier_sum`` over
    the slices inside the rank's marker group when n_dcn > 1 without
    --det-sync, else ``shard_sum`` over the marker group, so a --det-sync
    chain at any n_dcn is the flat one bit for bit, as ``det_psum`` runs
    over the whole flattened marker axis."""
    grid = (distributed.rank_grid(n_dcn, n_ind) if n_dcn > 1 or n_ind > 1
            else None)
    if n_dcn > 1 and not det:
        return functools.partial(hier_sum, groups=grid.hier)
    return functools.partial(shard_sum, n_dev=n_dev, det=det,
                             group=grid and grid.markers)
