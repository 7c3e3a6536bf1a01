"""Process groups: one ``torch.distributed`` rank a marker shard and device.

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

``--dcn-slices S`` lays the D ranks out as the JAX package's hierarchical
mesh (``make_mesh(D, n_dcn=S)``): ``marker_grid`` makes one group a slice
and one a position across slices, which ``mesh.hier_sum`` reduces over.
"""

from __future__ import annotations

import os
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


# n_dcn -> this rank's (slice group, dcn group), made by marker_grid
_GRIDS: dict = {}


def marker_grid(n_dcn: int):
    """This rank's (slice group, dcn group) on the slice-major grid of
    ``make_mesh(D, n_dcn=S)`` (hydra_tpu/parallel/mesh.py:68,
    ``grid.reshape(n_dcn, n_marker)``): rank r = s (D / S) + m is slice s,
    position m, and holds marker shard r, as on the flat mesh. The slice
    group (the "markers" axis) holds the D / S ranks of slice s, the dcn
    group (the "dcn" axis) the S ranks at position m. Every rank makes every
    group, the slices' first, in the same order, on its first call (a
    collective point); later calls return the same groups. An S that does
    not divide D raises."""
    n = world_size()
    if n_dcn < 1 or n % n_dcn:
        raise ValueError(f"--dcn-slices {n_dcn} must divide the {n} ranks "
                         "(slices of equal size, as make_mesh requires)")
    if n_dcn not in _GRIDS:
        n_m, r = n // n_dcn, rank()
        mine = [None, None]
        for s in range(n_dcn):
            g = tdist.new_group([s * n_m + m for m in range(n_m)])
            if r // n_m == s:
                mine[0] = g
        for m in range(n_m):
            g = tdist.new_group([s * n_m + m for s in range(n_dcn)])
            if r % n_m == m:
                mine[1] = g
        _GRIDS[n_dcn] = tuple(mine)
    return _GRIDS[n_dcn]


def destroy() -> None:
    """Leave the process group (the CLI's last step): the grid's groups
    first, then the default group."""
    if tdist.is_initialized():
        for groups in _GRIDS.values():
            for g in groups:
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


def gather_markers(t: torch.Tensor) -> torch.Tensor:
    """Marker-sharded state (m_loc, ...) of every rank, stacked in rank
    order (D * m_loc, ...) (multi-trait: (m_loc, T) -> (D m_loc, T)), for
    the writer on rank 0 (the counterpart of
    ``fetch_global``, the reference's MPI_Gatherv into rank 0's buffers,
    BayesRRm.cpp:2768-2795). Every rank calls it at the same point and gets
    the result (``mesh.gather_rows``: one all_reduce that only adds values
    to zeros, so it is exact). Identity without a process group."""
    from hydra_tpu_torch.parallel.mesh import gather_rows

    if world_size() == 1:
        return t
    return gather_rows(t).reshape((-1,) + tuple(t.shape[1:]))


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
