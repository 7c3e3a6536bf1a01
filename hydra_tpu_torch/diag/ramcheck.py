"""Device-memory estimate for a chain: the port's ``--check-RAM`` (C24).

The port's own copy of ``hydra_tpu/diag/ramcheck.py``. The reference
simulates per-node malloc of its sparse structures across a SLURM layout
(checkRamUsage, BayesRRm.cpp:2947-3084); ``check_ram_sparse`` keeps that
simulation for sparse input. For a .bed, ``estimate_bytes`` counts the
buffers the port's samplers hold on their one device: the packed rows (and
their one transient copy while they are laid out in slot order), the
residual-length vectors, the per-slot kernel rows and state, and the
largest sweep scratch of the run's branch; with ``--ind-shards I`` a
device holds one chunk of the individuals (``ind_chunk``: n_pad / I padded
to 512), and every residual-length buffer shrinks with it, as the JAX
estimate divides them by its "inds" axis. The budget is the device's own
memory: the card's (``torch.cuda.mem_get_info``), or the host's physical
memory with ``--device cpu``.
"""

from __future__ import annotations

import os

import numpy as np

from hydra_tpu_torch.data.genotypes import ind_chunk, pad_individuals
from hydra_tpu_torch.io.groups import (assign_blocks_to_tasks,
                                       read_marker_blocks_file)
from hydra_tpu_torch.ops.sweep_kernel import mrow_width
from hydra_tpu_torch.ops.sweep_kernel_bw import bw_mrow_width
from hydra_tpu_torch.ops.sweep_kernel_mt import mt_mrow_width
from hydra_tpu_torch.ops.window_kernels import (GRAM_BATCH_BYTES,
                                                gram_batch_windows)
from hydra_tpu_torch.options import Options


def estimate_bytes(m_tot: int, n: int, window: int, k: int = 4,
                   num_groups: int = 1, n_traits: int = 1,
                   model: str = "bayesMPI", exact: bool = False,
                   dtype: str = "float32", mega: str = "auto",
                   n_ind: int = 1) -> dict:
    """Device bytes of one chain on one device, by part: every marker, and
    one of ``n_ind`` chunks of the individuals (n_loc of them). The JAX
    estimate's fields (geno, eps, marker_state, window_ws, gram, total,
    m_loc, n_pad, n_loc) plus ``staging``, the layout's transient copy of
    the packed rows."""
    n_pad = pad_individuals(n)
    n_loc = ind_chunk(n_pad, n_ind)[1]
    nb = n_loc // 4
    W = max(window, 1)
    m_loc = -(-m_tot // W) * W
    T = max(n_traits, 1)
    f = 8 if dtype == "float64" else 4
    geno = m_loc * nb
    staging = m_loc * nb
    if model == "bayesWMPI":
        cols = bw_mrow_width(k) + 16
    elif T > 1:
        cols = mt_mrow_width(k, T) + 8 * T
    else:
        cols = mrow_width(k) + 16
    # kernel rows, the per-slot state and the group one-hot; the
    # per-window branch gathers the rows into sweep order once more
    rows = 2 if mega == "off" or dtype == "float64" else 1
    marker_state = rows * m_loc * f * (cols + num_groups)
    eps = 16 * n_loc * T * f
    n_windows = m_loc // W
    gram = T * W * W * f
    if dtype == "float64":
        # a window's decoded rows in float64 (values, mask, standardized)
        window_ws = 3 * W * n_loc * 8
    elif T > 1 and exact:
        # the per-window Gram's decoded planes per trait
        window_ws = 3 * T * W * n_loc * 4
    elif exact and mega != "off":
        # the exact sweep's batch of window Grams
        window_ws = min(GRAM_BATCH_BYTES,
                        gram_batch_windows(n_windows, W) * W * W * 4)
    else:
        window_ws = W * nb * 8
    total = geno + staging + eps + marker_state + window_ws + gram
    return dict(geno=geno, staging=staging, eps=eps,
                marker_state=marker_state, window_ws=window_ws, gram=gram,
                total=total, m_loc=m_loc, n_pad=n_pad, n_loc=n_loc)


def device_budget(device: str) -> int:
    """Bytes the chain's device has: the card's memory, or the host's
    physical memory for ``--device cpu``."""
    from hydra_tpu_torch.samplers.bayesrrm import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        import torch

        return int(torch.cuda.mem_get_info(dev)[1])
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def check_ram_sparse(opt: Options) -> dict:
    """Reference-parity path: read the REAL .sl1/.sl2/.slm element counts and
    simulate the SLURM node packing (checkRamUsage, BayesRRm.cpp:2947-3084).

    Node n holds tasks [n*tpn, (n+1)*tpn) while nodes past `nfull` drop one
    task (the reference's block task-assignment replica, :3030-3037); each
    task's RAM is (n1+n2+nm) u32 indices over its marker range."""
    basename = (opt.sparse_dir + "/" + opt.sparse_basename
                if opt.sparse_dir else opt.sparse_basename)
    n1l = np.fromfile(basename + ".sl1", dtype=np.uint64)
    n2l = np.fromfile(basename + ".sl2", dtype=np.uint64)
    nml = np.fromfile(basename + ".slm", dtype=np.uint64)
    mtot = len(n1l)

    tpn = max(1, opt.check_ram_tpn or 1)
    nranks = max(1, opt.check_ram_tasks or 1)
    blocks = (read_marker_blocks_file(opt.marker_blocks_file)
              if opt.marker_blocks_file else None)
    if blocks is not None:
        nranks = len(blocks[0])
        starts, lens = assign_blocks_to_tasks(
            nranks, blocks[0], blocks[1], mtot, nranks)
    else:
        starts, lens = assign_blocks_to_tasks(0, None, None, mtot, nranks)
    nnodes = -(-nranks // tpn)
    nfull = nranks + nnodes * (1 - tpn)
    print(f"INFO  : will simulate {nranks} ranks on {nnodes} nodes with "
          f"max {tpn} tasks per node.")
    print(f"INFO   : longest  task has {int(lens.max())} markers.")
    print(f"INFO   : smallest task has {int(lens.min())} markers.")
    print(f"INFO   : number of nodes fully loaded: {nfull}")

    node_gb = []
    task = 0
    for node in range(nnodes):
        this_tpn = tpn if node < nfull else tpn - 1
        ram = 0.0
        for _ in range(this_tpn):
            s, ln = int(starts[task]), int(lens[task])
            n1 = int(n1l[s: s + ln].sum())
            n2 = int(n2l[s: s + ln].sum())
            nm = int(nml[s: s + ln].sum())
            gb = (n1 + n2 + nm) * 4 * 1e-9
            ram += gb
            print(f"   - t {task:3d}  n {node:2d} sm {s:7d}  l {ln:6d} "
                  f"markers. Number of 1s: {n1}, 2s: {n2}, ms: {nm} "
                  f"=> RAM: {gb:7.3f} GB; RAM on node: {ram:7.3f}")
            task += 1
        node_gb.append(ram)
    mx = int(np.argmax(node_gb))
    print(f"    => max RAM required on a node will be {max(node_gb):7.3f} GB "
          f"on node {mx}")
    print(f"    => setting up your sbatch with {nranks} tasks and {tpn} "
          f"tasks per node should work; Will require {nnodes} nodes!")
    return dict(node_gb=node_gb, max_gb=max(node_gb), nodes=nnodes,
                nranks=nranks)


def check_ram_usage(opt: Options) -> dict:
    """--check-RAM: print the estimate of the run ``opt`` describes and
    whether it fits the device; returns the estimate (its ``budget``
    the device's bytes)."""
    if opt.read_from_sparse_files:
        return check_ram_sparse(opt)
    from hydra_tpu_torch.io import plink
    from hydra_tpu_torch.runner import mixture_components

    n = opt.number_individuals or plink.read_fam(opt.bed_file + ".fam").n
    m = opt.number_markers or plink.read_bim(opt.bed_file + ".bim").m
    bw = opt.bayes_type == "bayesWMPI"
    T = len(opt.phenotype_files) if opt.multi_phen and not bw else 1
    # the chain's own dtype: multi-trait and BayesW run float32
    dtype = opt.dtype if T == 1 and not bw else "float32"
    est = estimate_bytes(m, n, opt.window, k=mixture_components(opt),
                         n_traits=T, model=opt.bayes_type,
                         exact=opt.exact and opt.window > 1, dtype=dtype,
                         mega=opt.mega, n_ind=opt.ind_shards)
    budget = device_budget(opt.device)
    est["budget"] = budget
    gb = est["total"] / 1e9
    print(f"INFO   : M={m} N={n} on one device, window={opt.window}, "
          f"{T} trait(s), {dtype}, ind-shards={opt.ind_shards} "
          f"({est['n_loc']} individuals a device)")
    print(f"INFO   : device memory estimate: {gb:.3f} GB (geno "
          f"{est['geno'] / 1e9:.3f}, staging {est['staging'] / 1e9:.3f}, "
          f"workspace {est['window_ws'] / 1e9:.3f}) of "
          f"{budget / 1e9:.3f} GB on {opt.device or 'cuda'}")
    if est["total"] > budget:
        print(f"WARNING: exceeds the device's {budget / 1e9:.1f} GB; use "
              "fewer markers, a smaller window or the JAX package's "
              "multi-device runs")
    return est
