"""Chain runners: Options -> Dataset -> sampler -> hydra files.

Ports of ``hydra_tpu/runner.py::run_bayesrrm`` (BayesRRm and BayesFH;
main.cpp:47-177 and the in-sampler output blocks, BayesRRm.cpp:2736-2877),
``run_bayesrrm_mt``
(per-trait ``.t<k>`` outputs) and ``hydra_tpu/runner_bayesw.py::run_bayesw``
(BayesW.cpp:1935-2090), with covariates and ``--restart``. The sweeps run
on the device; at each thin/save/log boundary the values the writers need
come to the host in ONE batched copy.

A restart (``--restart``) reads the last saved iteration of
``<out>`` (``outputs/restart.py``), takes the saved seed, window and
schedule (``apply_restart_rng``), writes to ``<out>_rs`` and resumes at the
next iteration: the draws depend only on (seed, iteration, site), so the
resumed chain repeats the uninterrupted one. An iteration's files are
written save first and its csv row last, so a row in the csv means every
record of that iteration is on disk; the previous save's files stay as
``<file>.prev`` until then (``McmcWriter.commit_save``), so a kill inside a
save restarts from the save before it.

Under a process group (``parallel/distributed.py``) BayesRRm, BayesFH,
BayesW and multi-trait BayesRRm run one marker shard a rank, the ranks
laid out as ``--dcn-slices`` slices where it is given: each rank reads
only its shard's ``.bed`` rows, rank 0 alone writes (``NullWriter`` on the
others) and reads a restart, which it broadcasts, and the marker-sharded
state comes to rank 0 through ``gather_markers`` at every record, on every
rank alike. ``--ind-shards I`` (every sampler) gives each marker shard I
ranks, each with a chunk of the individuals: rank r reads shard r // I's
rows and keeps chunk r % I's byte columns, and the residual rank 0 saves
is the chunks gathered over its individual group (``residual``); a
restart's residual goes to every rank, each taking its chunk.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from hydra_tpu_torch.data.genotypes import Dataset, load_dataset, marker_shards
from hydra_tpu_torch.io import groups as groups_io
from hydra_tpu_torch.io import pheno as pheno_io
from hydra_tpu_torch.io import plink
from hydra_tpu_torch.options import Options
from hydra_tpu_torch.outputs.restart import (RestartData,
                                             last_save_iteration,
                                             read_restart)
from hydra_tpu_torch.outputs.writers import McmcWriter, NullWriter
from hydra_tpu_torch.parallel import distributed
from hydra_tpu_torch.samplers.bayesrrm import BayesRRm, resolve_device
from hydra_tpu_torch.samplers.bayesrrm_mt import BayesRRmMT
from hydra_tpu_torch.samplers.bayesw import BayesW
from hydra_tpu_torch.utils import telemetry


def mixture_components(opt: Options) -> int:
    """K, the zero class included: the --groups-mS file's width, else the
    --S grid's length + 1 (make_default_groups)."""
    if opt.group_index_file and opt.group_mixture_file:
        return int(groups_io.read_ms_file(opt.group_mixture_file).shape[1])
    return len(opt.S) + 1


def check_supported(opt: Options) -> None:
    """Raise before any data is read for what the port does not run, with
    the reason: a --dcn-slices S and --ind-shards I whose product does not
    divide the ranks (the JAX ``make_mesh`` raises the same,
    hydra_tpu/parallel/mesh.py:57-60);
    --n-devices other than 0 or the number of ranks (each rank is one
    device, so D > 1 needs D ranks under a launcher). Any window width,
    mixture size and trait count runs, as in the JAX package: above 1,024
    markers a window, 16 components or 16 traits the CUDA kernels take
    their wide arms (csrc/sweep_kernel.cuh)."""
    world = distributed.world_size()
    # --check-RAM estimates a device's share of a --ind-shards run without
    # launching it
    host_only = opt.bed_to_sparse or opt.check_ram
    if opt.ind_shards < 1 or (world % opt.ind_shards and not host_only):
        raise ValueError(
            f"--ind-shards {opt.ind_shards} must divide the {world} ranks of "
            "this launch: each marker shard is held by ind-shards ranks, one "
            "chunk of the individuals each (launch marker shards x "
            "ind-shards ranks)")
    n_shards = max(world // opt.ind_shards, 1)
    if opt.dcn_slices < 1 or n_shards % opt.dcn_slices:
        raise ValueError(
            f"--dcn-slices {opt.dcn_slices} must divide the {world} ranks of "
            "this launch"
            + (f" ({n_shards} marker shards of --ind-shards "
               f"{opt.ind_shards} ranks each)" if opt.ind_shards > 1 else "")
            + ": the ranks form dcn-slices slices of equal size, one marker "
            "shard a rank (launch a multiple of it)")
    if opt.n_devices > 1 and world == 1:
        raise ValueError(
            f"--n-devices {opt.n_devices} runs one rank a device: launch "
            f"{opt.n_devices} ranks with scripts/run_multiprocess_torch.py "
            f"--nprocs {opt.n_devices} or python -m torch.distributed.run "
            f"--nproc-per-node {opt.n_devices} -m hydra_tpu_torch.cli")
    if opt.n_devices not in (0, world):
        raise ValueError(f"--n-devices {opt.n_devices} differs from the "
                         f"{world} ranks of this launch (0 takes them all)")


def note_ignored_flags(opt: Options) -> None:
    """The JAX runner passes --cache-planes and --dtype to BayesRRm alone
    (hydra_tpu/runner.py:388-392), and --cross-sync to single-trait
    BayesRRm alone (its multi-trait sampler is built without it, :190-193);
    BayesW and multi-trait ignore them, and say so here."""
    if opt.plane_cache == "on":
        print("INFO   : --cache-planes on ignored (only single-trait BayesRRm "
              "reads the int8 planes)", flush=True)
    if opt.dtype == "float64":
        print("INFO   : --dtype float64 ignored (only single-trait BayesRRm "
              "and BayesFH run float64); this chain runs float32", flush=True)
    if opt.cross_sync and opt.multi_phen and opt.bayes_type != "bayesWMPI":
        print("INFO   : --cross-sync ignored by multi-trait BayesRRm (the "
              "JAX CLI builds it without it): exact windows on marker shards "
              "exchange at the window boundary", flush=True)


def autosize_exact_window(opt: Options, n: int) -> None:
    """The JAX runner's rule (hydra_tpu/runner.py:307-319): the auto exact
    default W=64 becomes 128 for N > 16384. Under the block schedule the
    chain depends on W, so the port takes the same W for the same flags."""
    if opt.window_auto and opt.exact and n > 16384 and opt.window == 64:
        opt.window = 128
        print("INFO   : exact mode: window auto-sized to 128 for N > 16384",
              flush=True)


def rank_marker_slice(opt: Options, m: int, blocks=None):
    """This rank's .bed rows (marker_offset, marker_count): the markers of
    its shard, rank // --ind-shards (the port of hydra_tpu/runner.py:71-90,
    the reference's per-rank MPI-IO reads, data.cpp:671-739), every
    individual's columns (the marker statistics need them all); (0, None),
    every row, on one marker shard or without a .bed. Shard starts depend
    only on (m, D, blocks), so this is the layout the sampler builds. A
    shard without markers is refused here, before the read."""
    a = shard_args(opt)
    if a["n_dev"] == 1 or not opt.read_from_bed_file:
        return 0, None
    d = a["rank"]
    starts, lengths, _ = marker_shards(m, a["n_dev"], d, max(opt.window, 1),
                                       blocks, a["n_ind"])
    return int(starts[d]), int(lengths[d])


def dataset_from_options(opt: Options) -> Dataset:
    """Input dispatch of main.cpp:60-157 (hydra_tpu/runner.py:90-129): a
    .bed, sparse files (--sparse-dir/--sparse-basename) or both. BayesW
    reads the .phen, .cov and .fail files together, and BayesRRm the .phen
    and .cov files; an individual with "NA" in its phenotype or any
    covariate is dropped."""
    n, m = opt.number_individuals, opt.number_markers
    if opt.read_from_bed_file and (n == 0 or m == 0):
        n = plink.read_fam(opt.bed_file + ".fam").n
        m = plink.read_bim(opt.bed_file + ".bim").m
    phen = opt.phenotype_files[0]
    if opt.bayes_type == "bayesWMPI":
        if not opt.failure_file:
            raise ValueError("BayesW requires failure indicators (--failure)")
        ph = (pheno_io.read_phen_fail_cov_files(phen, opt.covariates_file,
                                                opt.failure_file, n)
              if opt.covariates else
              pheno_io.read_phen_fail_files(phen, opt.failure_file, n))
    elif opt.covariates:
        ph = pheno_io.read_phen_cov_files(phen, opt.covariates_file, n)
    else:
        ph = pheno_io.read_phenotype_file(phen, expected_n=n or None)
    grp = mS = None
    if opt.group_index_file:
        grp = groups_io.read_group_file(opt.group_index_file)
        mS = groups_io.read_ms_file(opt.group_mixture_file)
    priors = (groups_io.read_group_priors(opt.priors_file)
              if opt.priors_file else None)
    d_priors = (groups_io.read_dirichlet_priors(opt.d_priors_file)
                if opt.d_priors_file else None)
    blocks = (groups_io.read_marker_blocks_file(opt.marker_blocks_file)
              if opt.marker_blocks_file else None)
    offset, count = rank_marker_slice(opt, m, blocks)
    return load_dataset(opt.bed_file if opt.read_from_bed_file else "", ph,
                        n=n, m=m, groups=grp, mS=mS, S=opt.S, priors=priors,
                        d_priors=d_priors, blocks=blocks,
                        sparse_basename=(opt.sparse_dir + "/"
                                         + opt.sparse_basename
                                         if opt.read_from_sparse_files
                                         else ""),
                        marker_offset=offset, marker_count=count,
                        n_ind=opt.ind_shards)


def iter_blocks(start_it: int, chain_length: int, thin: int, save: int,
                verbose: bool):
    """Yield (it, k): run k sweeps landing exactly ON event iteration it
    (hydra_tpu/runner.py::_iter_blocks)."""
    def is_event(i):
        return (i % thin == 0 or (i > 0 and i % save == 0)
                or (verbose and i % 10 == 0) or i == chain_length - 1)

    it = start_it
    while it < chain_length:
        e = it
        while not is_event(e):
            e += 1
        yield e, e - it + 1
        it = e + 1


def fetch_host(pulls: dict) -> dict:
    """Copy a dict of device tensors to the host in ONE transfer: flattened
    into one float64 buffer (exact for the f32 and int32 values here)."""
    names = list(pulls)
    flat = torch.cat([pulls[k].reshape(-1).to(torch.float64) for k in names])
    host = flat.cpu().numpy()
    out, off = {}, 0
    for k in names:
        t = pulls[k]
        n = t.numel()
        out[k] = host[off:off + n].reshape(tuple(t.shape))
        off += n
    return out


def _device(opt: Options) -> torch.device:
    device = (distributed.rank_device(opt.device)
              if distributed.world_size() > 1 else resolve_device(opt.device))
    if device.type == "cuda":
        # reference matmuls (plain versions, hyper updates) stay true f32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def apply_restart_rng(opt: Options, rd: RestartData) -> None:
    """Continue the saved chain's draws (hydra_tpu/runner.py:322-367; the
    reference restores its boost state from .rng.<rank>, BayesRRm.cpp:1204).
    The draws depend only on (seed, iteration, site), so the saved seed is
    the whole RNG state: take it, never the time(0) default, and keep the
    saved window and schedule where they were chosen automatically, so the
    restarted chain repeats the uninterrupted one."""
    if opt.seed_given and opt.seed != rd.seed:
        print(f"WARNING: --seed {opt.seed} differs from the saved RNG state "
              f"(seed {rd.seed}); using the saved seed to continue the chain",
              flush=True)
    opt.seed = rd.seed
    if rd.rng_window is not None and rd.rng_window != opt.window:
        if opt.window_auto:
            print(f"INFO   : restart: adopting the saved chain's window "
                  f"{rd.rng_window} (auto default was {opt.window})",
                  flush=True)
            opt.window = rd.rng_window
        else:
            print(f"WARNING: restart with --window {opt.window} but the chain "
                  f"was saved with window {rd.rng_window}; the restarted chain "
                  f"will not reproduce the uninterrupted one", flush=True)
    saved_schedule = rd.rng_schedule
    if saved_schedule is not None and opt.schedule != saved_schedule:
        if opt.schedule == "auto":
            print(f"INFO   : restart: adopting the saved chain's "
                  f"'{saved_schedule}' schedule", flush=True)
            opt.schedule = saved_schedule
        else:
            print(f"WARNING: restart with --schedule {opt.schedule} but the "
                  f"chain was saved with '{saved_schedule}'; the restarted "
                  f"chain will not reproduce the uninterrupted one",
                  flush=True)
    # BayesW has no --exact switch: exactness there is window == 1, which
    # is what its writer records
    eff_exact = (opt.window == 1 if opt.bayes_type == "bayesWMPI"
                 else opt.exact)
    if rd.rng_exact is not None and rd.rng_exact != eff_exact:
        print(f"WARNING: restart with exact={eff_exact} but the chain was "
              f"saved with exact={rd.rng_exact}; the restarted chain will "
              f"not reproduce the uninterrupted one", flush=True)


def on_rank0(fn, *args, **kw):
    """``fn(*args, **kw)`` on rank 0, its result broadcast to every rank
    (the other ranks may not see rank 0's files; the JAX runner reads them
    on every process, hydra_tpu/runner.py:380). A failure on rank 0 raises
    on every rank."""
    res = None
    if distributed.is_primary():
        try:
            res = ("ok", fn(*args, **kw))
        except Exception as e:              # noqa: BLE001 - sent on, raised
            res = ("error", e)
    kind, value = distributed.broadcast_object(res)
    if kind == "error":
        raise value
    return value


def read_mt_restart(opt: Options, n_traits: int, m: int, n: int) -> list:
    """Every trait's RestartData at the last save that every trait's csv
    holds (a kill between two traits' rows leaves the later traits one save
    behind)."""
    last = min(last_save_iteration(opt.mcmc_out + f".t{t}.csv", opt.save)
               for t in range(n_traits))
    return [read_restart(opt.mcmc_out + f".t{t}", m, n, opt.save,
                         use_xfiles=opt.use_xfiles_in_restart,
                         covariates=opt.covariates, iteration=last or None)
            for t in range(n_traits)]


def shard_args(opt: Options) -> dict:
    """Every sampler's rank-grid arguments: one marker shard every
    --ind-shards ranks (rank r holds shard r // I and chunk r % I), the
    shards in --dcn-slices slices."""
    n_ind = max(int(opt.ind_shards), 1)
    return dict(n_dev=distributed.world_size() // n_ind,
                rank=distributed.rank() // n_ind, n_ind=n_ind,
                det_sync=bool(opt.det_sync), n_dcn=int(opt.dcn_slices))


def new_writer(*args, **kw):
    """Rank 0's McmcWriter; a NullWriter on the other ranks."""
    if distributed.is_primary():
        return McmcWriter(*args, **kw)
    return NullWriter()


def restart_outputs(opt: Options) -> None:
    """Outputs of a restarted chain go to ``<name>_rs``, so the original
    files survive (BayesRRm.cpp:1206-1222)."""
    opt.mcmc_out_name += "_rs"


def run_bayesrrm(opt: Options, dataset: Optional[Dataset] = None,
                 verbose: bool = True,
                 packed_device: Optional[torch.Tensor] = None) -> dict:
    """BayesRRm (BayesFH for ``--mpibayes bayesFHMPI``) chain with
    hydra-format outputs, on ``opt.device``. packed_device: the genotypes
    already h-packed on the device (``BayesRRm``'s argument), for data made
    there. Returns the state and the seconds of the chain (``total_seconds``)
    and of its host-side writes (``write_seconds``)."""
    check_supported(opt)
    device = _device(opt)
    ds = dataset if dataset is not None else dataset_from_options(opt)
    fh = opt.bayes_type == "bayesFHMPI"
    autosize_exact_window(opt, ds.n)
    rd = None
    if opt.restart:
        rd = on_rank0(read_restart, opt.mcmc_out, ds.m, ds.n, opt.save,
                      use_xfiles=opt.use_xfiles_in_restart,
                      covariates=opt.covariates)
        apply_restart_rng(opt, rd)
        restart_outputs(opt)
    sampler = BayesRRm(ds, window=opt.window, exact=opt.exact,
                       shuffle=bool(opt.shuffle_markers), seed=opt.seed,
                       schedule=opt.schedule, mega=opt.mega,
                       plane_cache=opt.plane_cache, fh=fh, dtype=opt.dtype,
                       fh_params=dict(v0L=opt.v0L, v0t=opt.v0t, v0c=opt.v0c,
                                      s02c=opt.s02c, tau0=opt.tau0),
                       device=device, packed_device=packed_device,
                       cross_sync=opt.cross_sync, **shard_args(opt))
    state = (sampler.init_state() if rd is None
             else sampler.init_state_from_restart(rd))
    start_it = 0 if rd is None else rd.start_iteration
    writer = new_writer(opt.mcmc_out, ds.m, ds.n, ds.num_groups,
                        ds.mS.shape[1], opt.thin, opt.save, opt.seed,
                        covariates=opt.covariates, window=opt.window,
                        exact=opt.exact, schedule=sampler.cfg.schedule)
    marker_order = sampler.slot_to_marker[
        sampler.slot_to_marker >= 0].astype(np.int32)
    gather = sampler.gather_markers
    primary = distributed.is_primary()

    tot_proc = write_s = 0.0
    stats = None
    for it, k in iter_blocks(start_it, opt.chain_length, opt.thin, opt.save,
                             verbose):
        t0 = time.time()
        for i in range(it - k + 1, it + 1):
            state, stats = sampler.step(state, i)
        on_thin = it % opt.thin == 0
        on_save = it > 0 and it % opt.save == 0
        on_log = verbose and it % 10 == 0
        pulls = dict(sigma_g=state.sigma_g, sigma_e=state.sigma_e,
                     mu=state.mu, m0=stats.m0)
        if on_thin or on_save:
            pulls.update(beta=gather(state.beta),
                         components=gather(state.components))
        if on_thin:
            pulls.update(est_pi=state.est_pi, acum=gather(state.acum))
        if on_save:
            pulls.update(eps=sampler.residual(state.eps), gamma=state.gamma)
            if fh:
                pulls.update(lambda_var=gather(state.lambda_var),
                             nu_var=gather(state.nu_var),
                             c_slab=state.c_slab, tau=state.tau,
                             hyp_tau=state.hyp_tau)
        if on_log:
            pulls.update(beta_sqn=stats.beta_sqn, cass=stats.cass)
        h = fetch_host(pulls)
        t_w = time.time()
        if on_thin or on_save:
            beta_g = sampler.to_marker_order(h["beta"])
            comp_g = sampler.to_marker_order(
                h["components"].astype(np.int64)).astype(np.int32)
        if on_save:
            # the FH state in marker order (hydra_tpu/runner.py:466-481)
            fh_state = dict(
                lambda_var=sampler.to_marker_order(h["lambda_var"]),
                nu_var=sampler.to_marker_order(h["nu_var"]),
                c_slab=h["c_slab"], tau=float(h["tau"]),
                hyp_tau=float(h["hyp_tau"])) if fh else None
            writer.on_save(it, h["eps"][:ds.n], marker_order, beta_g, comp_g,
                           gamma=h["gamma"],
                           x_order=(sampler.cov_order(it) if opt.covariates
                                    else None),
                           fh_state=fh_state,
                           hypers=(dict(sigma_g=h["sigma_g"],
                                        sigma_e=h["sigma_e"],
                                        est_pi=h["est_pi"])
                                   if sampler.cfg.dtype == "float64"
                                   else None))
        if on_thin:
            sg = h["sigma_g"]
            row = writer.csv_row_brr(it, sg, float(h["sigma_e"]),
                                     int(h["m0"].sum()), h["est_pi"])
            writer.on_thin(it, beta_g, comp_g, row, float(h["mu"]),
                           acum=sampler.to_marker_order(h["acum"]))
        if on_save:
            writer.commit_save()
        dt = time.time() - t0
        tot_proc += dt
        write_s += time.time() - t_w
        if on_log and primary:
            print(telemetry.result_line(
                it, dt / k, float(h["sigma_g"].sum()), float(h["sigma_e"]),
                float(h["beta_sqn"].sum()), int(h["m0"].sum())), flush=True)
            print(telemetry.cass_table(it, sampler.mtot_grp, h["sigma_g"],
                                       h["cass"]), flush=True)
    n_done = opt.chain_length - start_it
    if verbose and n_done > 0 and primary:
        print(telemetry.exit_line(tot_proc, n_done,
                                  distributed.world_size()), flush=True)
    return dict(state=state, stats=stats, sampler=sampler,
                total_seconds=tot_proc, write_seconds=write_s,
                mcmc_out=opt.mcmc_out)


def read_multi_phenos(opt: Options, n: int) -> np.ndarray:
    """Read T phenotype files into (T, N) with NaN for missing individuals
    (readPhenotypeFileAndSetNanMask semantics, data.cpp:1578-1609). The
    port's copy of ``hydra_tpu/runner.py::read_multi_phenos``."""
    rows = []
    for path in opt.phenotype_files:
        vals = []
        with open(path) as fh:
            for raw in fh:
                parts = raw.split()
                if not parts:
                    continue
                vals.append(np.nan if parts[2] == "NA" else float(parts[2]))
        if n and len(vals) != n:
            raise ValueError(f"{path}: expected {n} individuals, found {len(vals)}")
        rows.append(vals)
    return np.asarray(rows, dtype=np.float64)


def mt_dataset_from_options(opt: Options):
    """(Dataset, phenos (T, N)) for a multi-trait run: every individual
    keeps its genotypes, NaN phenotypes are masked per trait, not removed,
    and covariates (a comma-separated file without IDs) are read for all
    N individuals (hydra_tpu/runner.py:159-179). Under a process group each
    rank reads its shard's .bed rows (``rank_marker_slice``: shard
    rank // --ind-shards, every individual's columns)."""
    n = opt.number_individuals or plink.read_fam(opt.bed_file + ".fam").n
    m = opt.number_markers or plink.read_bim(opt.bed_file + ".bim").m
    phenos = read_multi_phenos(opt, n)
    ph = pheno_io.PhenoData(
        y=np.nan_to_num(phenos[0]), na_indices=np.array([], dtype=np.int64),
        X=(pheno_io.read_csv_covariates(opt.covariates_file, n)
           if opt.covariates else None))
    grp = mS = None
    if opt.group_index_file:
        grp = groups_io.read_group_file(opt.group_index_file)
        mS = groups_io.read_ms_file(opt.group_mixture_file)
    offset, count = rank_marker_slice(opt, m)
    ds = load_dataset(opt.bed_file, ph, n=n, m=m, groups=grp, mS=mS, S=opt.S,
                      marker_offset=offset, marker_count=count,
                      n_ind=opt.ind_shards)
    return ds, phenos


def run_bayesrrm_mt(opt: Options, verbose: bool = True) -> dict:
    """Multi-trait BayesRRm chain (``--pheno a,b,...``) with per-trait
    hydra outputs ``<out>.t<k>.{csv,bet,cpn,acu,...}``, on ``opt.device``
    (hydra_tpu/runner.py:150-304), on one device, a marker shard a rank or
    the --ind-shards grid (rank 0 writes and reads the restart, and saves
    the residual gathered from the chunks). A restart reads every trait's
    files, their covariate dumps included, and so restores gamma, which the
    JAX runner does not (it reads them without ``covariates``). As the JAX
    runner, it builds the sampler without --cross-sync."""
    check_supported(opt)
    note_ignored_flags(opt)
    device = _device(opt)
    ds, phenos = mt_dataset_from_options(opt)
    T = phenos.shape[0]
    autosize_exact_window(opt, ds.n)
    rds = None
    if opt.restart:
        rds = on_rank0(read_mt_restart, opt, T, ds.m, ds.n)
        apply_restart_rng(opt, rds[0])
        restart_outputs(opt)
    sampler = BayesRRmMT(ds, phenos, window=opt.window, exact=opt.exact,
                         shuffle=bool(opt.shuffle_markers), seed=opt.seed,
                         schedule=opt.schedule, mega=opt.mega, device=device,
                         **shard_args(opt))
    state = (sampler.init_state() if rds is None
             else sampler.init_state_from_restart(rds))
    start_it = 0 if rds is None else rds[0].start_iteration
    writers = [new_writer(opt.mcmc_out + f".t{t}", ds.m, ds.n, ds.num_groups,
                          ds.mS.shape[1], opt.thin, opt.save, opt.seed,
                          covariates=opt.covariates, window=opt.window,
                          exact=opt.exact, schedule=sampler.cfg.schedule)
               for t in range(T)]
    marker_order = sampler.slot_to_marker[
        sampler.slot_to_marker >= 0].astype(np.int32)
    gather = sampler.gather_markers
    primary = distributed.is_primary()

    tot_proc = write_s = 0.0
    stats = None
    for it, k in iter_blocks(start_it, opt.chain_length, opt.thin, opt.save,
                             verbose):
        t0 = time.time()
        for i in range(it - k + 1, it + 1):
            state, stats = sampler.step(state, i)
        on_thin = it % opt.thin == 0
        on_save = it > 0 and it % opt.save == 0
        on_log = verbose and it % 10 == 0
        pulls = dict(sigma_g=state.sigma_g, sigma_e=state.sigma_e)
        if on_thin or on_save:
            pulls.update(beta=gather(state.beta),
                         components=gather(state.components), mu=state.mu)
        if on_thin:
            pulls.update(m0=stats.m0, est_pi=state.est_pi,
                         acum=gather(state.acum))
        if on_save:
            pulls.update(eps=sampler.residual(state.eps), gamma=state.gamma)
        h = fetch_host(pulls)
        t_w = time.time()
        if on_thin or on_save:
            beta_g = sampler.to_marker_order(h["beta"])
            comp_g = sampler.to_marker_order(
                h["components"].astype(np.int64)).astype(np.int32)
        if on_save:
            for t, w in enumerate(writers):
                w.on_save(it, h["eps"][:ds.n, t], marker_order, beta_g[:, t],
                          comp_g[:, t], gamma=(h["gamma"][:, t]
                                               if opt.covariates else None))
        if on_thin:
            # pad slots report P(zero) = 1, as the JAX runner's .acu
            acum_g = sampler.to_marker_order(h["acum"], fill=1.0)
            for t, w in enumerate(writers):
                row = w.csv_row_brr(it, h["sigma_g"][t], float(h["sigma_e"][t]),
                                    int(h["m0"][t].sum()), h["est_pi"][t])
                w.on_thin(it, beta_g[:, t], comp_g[:, t], row,
                          float(h["mu"][t]), acum=acum_g[:, t])
        if on_save:
            # the previous save's files go once every trait's row is on
            # disk: a kill between two traits' rows restarts every trait
            # from the save all their csvs hold
            for w in writers:
                w.commit_save()
        tot_proc += time.time() - t0
        write_s += time.time() - t_w
        if on_log and primary:
            sg = h["sigma_g"].sum(axis=1)
            se = h["sigma_e"]
            print(f"RESULT : it {it:4d}: h2 per trait = "
                  f"{np.array2string(sg / (sg + se), precision=4)}",
                  flush=True)
    n_done = opt.chain_length - start_it
    if verbose and n_done > 0 and primary:
        print(telemetry.exit_line(tot_proc, n_done,
                                  distributed.world_size()), flush=True)
    return dict(state=state, stats=stats, sampler=sampler,
                total_seconds=tot_proc, write_seconds=write_s,
                mcmc_out=opt.mcmc_out)


def run_bayesw(opt: Options, dataset: Optional[Dataset] = None,
               verbose: bool = True) -> dict:
    """BayesW chain with hydra-format outputs, on ``opt.device``
    (hydra_tpu/runner_bayesw.py): gamma as ``.gam`` text rows on each thin
    and the covariates' order as ``.xiv`` on each save."""
    check_supported(opt)
    note_ignored_flags(opt)
    device = _device(opt)
    ds = dataset if dataset is not None else dataset_from_options(opt)
    rd = None
    if opt.restart:
        rd = on_rank0(read_restart, opt.mcmc_out, ds.m, ds.n, opt.save,
                      use_xfiles=opt.use_xfiles_in_restart,
                      covariates=opt.covariates, survival=True)
        apply_restart_rng(opt, rd)
        restart_outputs(opt)
    sampler = BayesW(ds, window=opt.window, shuffle=bool(opt.shuffle_markers),
                     seed=opt.seed, quad_points=int(opt.quad_points),
                     schedule=opt.schedule, mega=opt.mega, device=device,
                     **shard_args(opt))
    state = (sampler.init_state() if rd is None
             else sampler.init_state_from_restart(rd))
    start_it = 0 if rd is None else rd.start_iteration
    # window=1 is exact sequential BayesW; record it as such
    writer = new_writer(opt.mcmc_out, ds.m, ds.n, ds.num_groups,
                        ds.mS.shape[1], opt.thin, opt.save, opt.seed,
                        covariates=opt.covariates, survival=True,
                        window=opt.window, exact=(opt.window == 1),
                        schedule=sampler.cfg.schedule)
    marker_order = sampler.slot_to_marker[
        sampler.slot_to_marker >= 0].astype(np.int32)
    gather = sampler.gather_markers
    primary = distributed.is_primary()

    tot_proc = write_s = 0.0
    stats = None
    for it, k in iter_blocks(start_it, opt.chain_length, opt.thin, opt.save,
                             verbose):
        t0 = time.time()
        for i in range(it - k + 1, it + 1):
            state, stats = sampler.step(state, i)
        on_thin = it % opt.thin == 0
        on_save = it > 0 and it % opt.save == 0
        on_log = verbose and it % 10 == 0
        pulls = dict(sigma_g=state.sigma_g, mu=state.mu, alpha=state.alpha,
                     m0=stats.m0)
        if on_thin or on_save:
            pulls.update(beta=gather(state.beta),
                         components=gather(state.components))
        if on_thin:
            pulls.update(pi_l=state.pi_l, gamma=state.gamma)
        if on_save:
            pulls.update(eps=sampler.residual(state.eps))
        h = fetch_host(pulls)
        t_w = time.time()
        if on_thin or on_save:
            beta_g = sampler.to_marker_order(h["beta"])
            comp_g = sampler.to_marker_order(
                h["components"].astype(np.int64)).astype(np.int32)
        if on_save:
            writer.on_save(it, h["eps"][:ds.n], marker_order, beta_g, comp_g,
                           x_order=(sampler.cov_order(it) if opt.covariates
                                    else None))
        if on_thin:
            row = writer.csv_row_bw(it, float(h["mu"]), h["sigma_g"],
                                    float(h["alpha"]), int(h["m0"].sum()),
                                    h["pi_l"])
            # gamma as a text row "it, g0, g1, ..." (BayesW.cpp:1971-1980)
            gamma_text = (f"{it:5d}, " + ", ".join(
                f"{v:20.17f}" for v in h["gamma"]) + "\n"
                if opt.covariates else None)
            writer.on_thin(it, beta_g, comp_g, row, float(h["mu"]),
                           gamma_text=gamma_text)
        if on_save:
            writer.commit_save()
        dt = time.time() - t0
        tot_proc += dt
        write_s += time.time() - t_w
        if on_log and primary:
            print(telemetry.bw_line(it, int(h["m0"].sum()), float(h["mu"]),
                                    float(h["alpha"]),
                                    float(h["sigma_g"].sum()), dt),
                  flush=True)
    n_done = opt.chain_length - start_it
    if verbose and n_done > 0 and primary:
        print(telemetry.exit_line(tot_proc, n_done,
                                  distributed.world_size()), flush=True)
    return dict(state=state, stats=stats, sampler=sampler,
                total_seconds=tot_proc, write_seconds=write_s,
                mcmc_out=opt.mcmc_out)
