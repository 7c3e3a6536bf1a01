"""Process groups: one ``torch.distributed`` rank a device, on a grid of
marker shards and chunks of individuals.

The port's copy of ``hydra_tpu/parallel/distributed.py``. The reference is
an MPI program with one rank a block of markers (main.cpp:20 MPI_Init,
mpi_utils.hpp:8-67); here each rank is a process that runs the unmodified
CLI on its own device, wired into one process group from the environment
that ``torchrun`` (``python -m torch.distributed.run``) or
``scripts/run_multiprocess_torch.py`` exports. The JAX package's
HYDRA_COORDINATOR / HYDRA_NUM_PROCS / HYDRA_PROC_ID are read as well.

The backend is NCCL for cuda and gloo for cpu unless HYDRA_TORCH_BACKEND
names one; a rank's device is cuda:LOCAL_RANK unless HYDRA_TORCH_DEVICE
names one (several ranks on one card: gloo, since NCCL refuses two ranks
on one device). Nothing falls back: a failed init raises.

Only ``all_reduce`` and ``broadcast`` are issued (here and in
``parallel/mesh.py``), which NCCL and gloo take on CPU and CUDA tensors
alike. Every rank must call a collective at the same point.

``--dcn-slices S`` and ``--ind-shards I`` lay the ranks out as the JAX
package's mesh ``make_mesh(D I, n_ind=I, n_dcn=S)``: ``rank_grid`` gives a
rank its marker shard and its chunk of individuals, and makes the groups
the samplers sum over: the I ranks of a marker shard (its individual
group), the ranks of a chunk (its marker group), and inside that one group
a slice and one a position across slices, which ``mesh.hier_sum`` reduces
over.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as tdist

_JAX_ENV = (("HYDRA_NUM_PROCS", "WORLD_SIZE"), ("HYDRA_PROC_ID", "RANK"))


def _environment() -> Optional[dict]:
    """RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT from
    torchrun's variables or the JAX package's; None outside a launch."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        out = {k: env[k] for k in ("RANK", "WORLD_SIZE")}
        out["LOCAL_RANK"] = env.get("LOCAL_RANK", env["RANK"])
        out["MASTER_ADDR"] = env.get("MASTER_ADDR", "localhost")
        out["MASTER_PORT"] = env.get("MASTER_PORT", "")
        return out
    coord = env.get("HYDRA_COORDINATOR")
    if not coord:
        return None
    host, port = coord.rsplit(":", 1)
    out = {dst: env.get(src, "0") for src, dst in _JAX_ENV}
    out.update(LOCAL_RANK=out["RANK"], MASTER_ADDR=host, MASTER_PORT=port)
    return out


def rank_device(device: str = "") -> torch.device:
    """This rank's device: cpu when asked for, else HYDRA_TORCH_DEVICE or
    cuda:LOCAL_RANK. A CUDA device that is not there raises."""
    if device == "cpu":
        return torch.device("cpu")
    name = os.environ.get("HYDRA_TORCH_DEVICE")
    if not name:
        env = _environment() or {}
        name = f"cuda:{int(env.get('LOCAL_RANK', 0))}"
    dev = torch.device(name)
    if dev.type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if (dev.index or 0) >= n:
            raise RuntimeError(
                f"rank device {dev} requested but {n} CUDA device(s) are "
                "visible; pass --device cpu for the CPU path, or "
                "HYDRA_TORCH_DEVICE=cuda:0 to put several ranks on one card")
    return dev


def init_distributed(device: str = "") -> bool:
    """Join the process group the environment describes. Returns False
    outside a launch (one process, nothing initialized), True once the
    group is up. ``device`` is the CLI's --device ("cpu" or cuda);
    HYDRA_TORCH_BACKEND overrides NCCL for cuda / gloo for cpu."""
    if tdist.is_initialized():
        return True
    env = _environment()
    if env is None:
        return False
    dev = rank_device(device)
    backend = (os.environ.get("HYDRA_TORCH_BACKEND")
               or ("nccl" if dev.type == "cuda" else "gloo"))
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be nccl or gloo, got {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs cuda devices; use gloo with "
                         "--device cpu")
    if not env["MASTER_PORT"]:
        raise RuntimeError("MASTER_PORT is not set (torchrun and "
                           "scripts/run_multiprocess_torch.py set it)")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    global _DEVICE
    _DEVICE = dev
    tdist.init_process_group(
        backend=backend,
        init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
        rank=int(env["RANK"]), world_size=int(env["WORLD_SIZE"]))
    return True


_DEVICE: Optional[torch.device] = None


@dataclass(frozen=True)
class Grid:
    """This rank's place on the (S, n_marker, I) rank grid and its groups
    (``rank_grid``). A group of None is the default group (every rank);
    ``inds`` is None at I = 1, where no individual group is made."""
    n_dcn: int               # S slices of the marker shards
    n_ind: int               # I individual chunks a marker shard
    shard: int               # flat marker shard index, rank // I
    chunk: int               # individual chunk, rank % I
    markers: object          # the S n_marker ranks of this chunk
    inds: object             # the I ranks of this marker shard
    hier: object             # (slice group, dcn group) inside
                             # ``markers`` at S > 1, else None


# (n_dcn, n_ind) -> this rank's Grid, made by rank_grid
_GRIDS: dict = {}


def rank_grid(n_dcn: int = 1, n_ind: int = 1) -> Grid:
    """This rank's place on the row-major grid of ``make_mesh(D I, n_ind=I,
    n_dcn=S)`` (hydra_tpu/parallel/mesh.py:63-71, ``grid.reshape(n_dcn,
    n_marker, n_ind)``): rank r = (s n_marker + m) I + i holds marker shard
    r // I = s n_marker + m (the flat index the JAX slot layout uses) and
    individual chunk i = r % I. The groups: an individual group a marker
    shard (its I ranks, the JAX "inds" axis), a marker group a chunk (its
    S n_marker ranks, the flattened ("dcn", "markers") axes), and inside
    each marker group a group a slice (its n_marker ranks, "markers") and
    one a position across slices ("dcn"), for ``mesh.hier_sum``. At I = 1
    the marker group is the default group and no individual group is made;
    at S = 1 as well no group is made at all. Every rank makes every group,
    the individual groups', the marker groups', the slices' and then the
    positions', in the same order, on its first call (a collective point);
    later calls return the same Grid. An S I that does not divide the ranks
    raises."""
    n, r = world_size(), rank()
    if n_dcn < 1 or n_ind < 1 or n % (n_dcn * n_ind):
        raise ValueError(f"--dcn-slices {n_dcn} x --ind-shards {n_ind} must "
                         f"divide the {n} ranks (slices of equal size and "
                         "chunks of every marker shard, as make_mesh "
                         "requires)")
    key = (n_dcn, n_ind)
    if key not in _GRIDS:
        n_sh = n // n_ind
        n_m = n_sh // n_dcn
        shard, chunk = r // n_ind, r % n_ind
        made = []

        def group(ranks, mine, prev):
            made.append(tdist.new_group(ranks))
            return made[-1] if mine else prev

        inds = markers = hier = None
        if n_ind > 1:
            for d in range(n_sh):
                inds = group([d * n_ind + i for i in range(n_ind)],
                             d == shard, inds)
            for i in range(n_ind):
                markers = group([d * n_ind + i for d in range(n_sh)],
                                i == chunk, markers)
        if n_dcn > 1:
            sl = dc = None
            for i in range(n_ind):
                for s in range(n_dcn):
                    sl = group([(s * n_m + m) * n_ind + i for m in range(n_m)],
                               (i, s) == (chunk, shard // n_m), sl)
            for i in range(n_ind):
                for m in range(n_m):
                    dc = group([(s * n_m + m) * n_ind + i
                                for s in range(n_dcn)],
                               (i, m) == (chunk, shard % n_m), dc)
            hier = (sl, dc)
        _GRIDS[key] = (Grid(n_dcn, n_ind, shard, chunk, markers, inds, hier),
                       made)
    return _GRIDS[key][0]


def marker_grid(n_dcn: int):
    """This rank's (slice group, dcn group) on the slice-major grid of
    ``make_mesh(D, n_dcn=S)``: ``rank_grid(n_dcn).hier``."""
    return rank_grid(n_dcn).hier


def destroy() -> None:
    """Leave the process group (the CLI's last step): the grids' groups
    first, then the default group."""
    if tdist.is_initialized():
        for _, made in _GRIDS.values():
            for g in made:
                tdist.destroy_process_group(g)
        _GRIDS.clear()
        tdist.destroy_process_group()


def world_size() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def rank() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def is_primary() -> bool:
    """Rank 0 (or a run without a process group): the one that writes."""
    return rank() == 0


def backend() -> str:
    return tdist.get_backend() if tdist.is_initialized() else ""


def host_device() -> torch.device:
    """Where host values travel in a collective: the rank's card under
    NCCL, which takes no CPU tensors, else the CPU."""
    if backend() == "nccl":
        return _DEVICE if _DEVICE is not None else torch.device(
            "cuda", torch.cuda.current_device())
    return torch.device("cpu")


def gather_markers(t: torch.Tensor, group=None) -> torch.Tensor:
    """Marker-sharded state (m_loc, ...) of every marker shard, stacked in
    shard order (n_shards m_loc, ...) (multi-trait: (m_loc, T) -> (D m_loc,
    T)), for the writer on rank 0 (the counterpart of ``fetch_global``, the
    reference's MPI_Gatherv into rank 0's buffers, BayesRRm.cpp:2768-2795),
    over ``group``: the rank's marker group (``Grid.markers``), every rank
    when None. Every rank calls it at the same point and gets the result
    (``mesh.gather_rows``: one all_reduce that only adds values to zeros,
    so it is exact). Identity on a group of one rank."""
    from hydra_tpu_torch.parallel.mesh import gather_rows

    if group_size(group) == 1:
        return t
    return gather_rows(t, group).reshape((-1,) + tuple(t.shape[1:]))


def gather_individuals(t: torch.Tensor, grid: Grid, length: int
                       ) -> torch.Tensor:
    """A residual whose chunks the ranks of ``grid``'s individual group
    hold (each (n_loc, ...): multi-trait (n_loc, T); its first ``length``
    rows real, the rest the chunk's own padding), as the whole (I length,
    ...) on every rank of the group, chunk after chunk: the residual rank 0
    writes and saves. Exact, as ``gather_markers``; the identity at
    I = 1."""
    from hydra_tpu_torch.parallel.mesh import gather_rows

    if grid.n_ind == 1:
        return t
    return gather_rows(t, grid.inds)[:, :length].reshape(
        (-1,) + tuple(t.shape[1:]))


def group_size(group=None) -> int:
    """Ranks of ``group`` (every rank when None; 1 without a process
    group)."""
    if not tdist.is_initialized():
        return 1
    return tdist.get_world_size(group)


def allreduce_host_sum(value: float) -> float:
    """A host scalar summed over ranks in float64 (the MPI_Allreduce of
    load-time metadata, e.g. the missing-genotype count that gates the
    complete-data kernels). The JAX package's copy gathers a float64 array
    that JAX without x64 truncates to float32, so sums above 2^24 lose
    their integer exactness (hydra_tpu/parallel/distributed.py:130); here
    the all_reduce runs in float64. No-op without a process group."""
    if world_size() == 1:
        return float(value)
    t = torch.tensor([float(value)], dtype=torch.float64,
                     device=host_device())
    tdist.all_reduce(t)
    return float(t.item())


def broadcast_object(obj):
    """``obj`` of rank 0 on every rank (the restart state rank 0 read);
    identity without a process group."""
    if world_size() == 1:
        return obj
    box = [obj if is_primary() else None]
    tdist.broadcast_object_list(box, src=0, device=host_device())
    return box[0]
