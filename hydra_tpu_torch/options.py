"""Run configuration for hydra_tpu_torch.

The port's own copy of ``hydra_tpu/options.py``: the reference's CLI surface
(src/options.hpp:20-138, src/options.cpp:5-397) as a dataclass + argparse
front-end, including the `--inp-file` key-value option file
(options.cpp:335-397). Field names, defaults and ``validate()`` are the JAX
package's, so the same argv gives the same ``Options`` in both packages;
``--device`` also takes ``cuda``. Which options the port runs is decided in
``hydra_tpu_torch.runner.check_supported``.
"""

from __future__ import annotations

import argparse
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Options:
    # --- analysis selection (options.hpp:62-64, main.cpp:47-177) ---
    bayes_type: str = ""                 # bayesMPI | bayesWMPI | bayesFHMPI
    bed_to_sparse: bool = False          # --bed-to-sparse (C6 converter)
    blocks_per_rank: int = 1             # --blocks-per-rank
    check_ram: bool = False              # --check-RAM
    check_ram_tasks: int = 0             # --check-RAM-tasks
    check_ram_tpn: int = 0               # --check-RAM-tasks-per-node

    # --- inputs (options.hpp:66-79) ---
    bed_file: str = ""                   # --bfile (basename without .bed)
    phenotype_files: List[str] = field(default_factory=list)  # --pheno (comma-sep)
    failure_file: str = ""               # --failure (BayesW)
    covariates_file: str = ""            # --covariates
    covariates: bool = False
    group_index_file: str = ""           # --groupIndexFile
    group_mixture_file: str = ""         # --groupMixtureFile
    priors_file: str = ""                # --groupPriorsFile
    d_priors_file: str = ""              # --dPriorsFile
    marker_blocks_file: str = ""         # --marker-blocks-file
    sparse_dir: str = ""                 # --sparse-dir
    sparse_basename: str = ""            # --sparse-basename
    number_markers: int = 0              # --number-markers
    number_individuals: int = 0          # --number-individuals
    read_from_bed_file: bool = False
    read_from_sparse_files: bool = False
    mixed_representation: bool = False
    threshold_fnz: float = 0.06          # --threshold-fnz (options.hpp:86)

    # --- chain control (options.hpp:101-127 defaults) ---
    chain_length: int = 10000            # --chain-length
    burnin: int = 5000                   # --burn-in
    seed: int = 0                        # --seed (default: time(0), options.hpp:104)
    seed_given: bool = False             # True when --seed was passed explicitly
    window_auto: bool = False            # True when the exact default window
                                         # was hardware-sized (not user-set);
                                         # the runner may re-size it once N is
                                         # known (identical semantics)
    thin: int = 5                        # --thin
    save: int = 10                       # --save
    S: List[float] = field(default_factory=lambda: [0.01, 0.001, 0.0001])  # --S
    shuffle_markers: int = 1             # --shuf-mark
    sync_rate: int = 1                   # --sync-rate (options.cpp:213-216)
    sparse_sync: bool = False            # --sparse-sync (accepted; no-op on one device)
    bed_sync: bool = False               # --bed-sync   (accepted; no-op on one device)

    # --- outputs (options.hpp:73-75) ---
    mcmc_out_dir: str = ""               # --mcmc-out-dir
    mcmc_out_name: str = "default_output_name"  # --mcmc-out-name
    title: str = "brr"                   # --out (run label, options.cpp:247-249)
    restart: bool = False                # --restart
    use_xfiles_in_restart: bool = True   # negated by --ignore-xfiles

    # --- BayesW (options.hpp:57-58) ---
    quad_points: str = "25"              # --quad_points (3..25, adaptive G-H)

    # --- FH hyperpriors (options.hpp:89-96) ---
    beta_a: float = 1.0                  # --betaA
    beta_b: float = 1.0                  # --betaB
    tau0: float = 1.0                    # --tau0
    s02c: float = 1.0                    # --s02c
    v0c: float = 3.0                     # --v0c
    v0L: float = 3.0                     # --v0L
    v0t: float = 3.0                     # --v0t

    # --- multi-trait ---
    multi_phen: bool = False             # set when --pheno has >1 file
    interleave: bool = False             # --interleave-phenotypes: AoS vs SoA
    # epsilon layout in the reference (BayesRRm_mt.cpp:449-520); an XLA
    # layout detail here — accepted no-op, numerics identical

    # --- accelerator knobs (no reference equivalent) ---
    window: int = 0                      # marker-window batch size; 0 → = sync_rate
    exact: bool = True                   # Gram-corrected exact sequential semantics
    n_devices: int = 0                   # 0 → the ranks of the launch
    ind_shards: int = 1                  # individual-axis mesh shards (N-sharding)
    dcn_slices: int = 1                  # multi-slice hierarchy: ("dcn","markers")
    dtype: str = "float32"               # accumulation dtype
    plane_cache: str = "off"             # int8 decoded-plane cache (ops/planes.py)
    mega: str = "auto"                   # whole-sweep mega-kernel gate override
    schedule: str = "auto"               # marker-processing schedule
                                         # (auto|marker|block; see BayesRRmConfig)
    cross_sync: int = 0                  # exact-mode cross-shard exchange
    det_sync: int = 0                    # topology-invariant reductions
                                         # interval B (markers); 0 -> window
    device: str = ""                     # "" = cuda | cuda | cpu

    @property
    def mcmc_out(self) -> str:
        if self.mcmc_out_dir:
            return os.path.join(self.mcmc_out_dir, self.mcmc_out_name)
        return self.mcmc_out_name

    @property
    def num_mixtures(self) -> int:
        return len(self.S) + 1

    def validate(self) -> "Options":
        """Post-parse validation mirroring options.cpp:160-230 + BayesRRm.cpp:1056-1066."""
        if self.seed == 0:
            self.seed = int(time.time())
        # save must be >= thin and a multiple of thin (BayesRRm.cpp:1058-1066)
        requested_save = self.save
        if self.save < self.thin:
            self.save = self.thin
        if self.save % self.thin != 0:
            self.save = (self.save // self.thin) * self.thin
        if self.save != requested_save:
            print(f"INFO   : --save {requested_save} adjusted to {self.save} "
                  f"(must be a multiple of --thin {self.thin}, "
                  f"BayesRRm.cpp:1058-1066)", flush=True)
        if (self.group_index_file == "") != (self.group_mixture_file == ""):
            raise ValueError(
                "you need to activate both --groupIndexFile and --groupMixtureFile"
            )  # main.cpp:147-149
        if bool(self.sparse_dir) != bool(self.sparse_basename):
            raise ValueError(
                "--sparse-dir and --sparse-basename must either be both set or unset"
            )  # options.cpp:192
        if self.window <= 0:
            if self.exact and self.bayes_type != "bayesWMPI":
                # Exact mode is PROVEN window-invariant (the Gram correction
                # reproduces sequential Gibbs for any W —
                # tests/test_bayesrrm.py::test_exact_mode_is_exact_across_shards
                # asserts W=1 == W=4 chains), so the default window is sized
                # for the hardware, not tied to --sync-rate: W=64 takes the
                # whole-sweep window kernels at identical semantics.
                self.window = 64
                self.window_auto = True
                if self.sync_rate != self.window:
                    print("INFO   : exact mode: using window=64 (window-"
                          "invariant semantics; pass --window to override)",
                          flush=True)
            else:
                self.window = max(1, self.sync_rate)
        if self.bayes_type == "bayesWMPI" and self.window > 64:
            # BIAS_SWEEP_BW.md: BayesW stale windows W=256 drift the Weibull
            # shape posterior (alpha 12.2 vs 11.2, m0 +58%); W <= 64 matches
            # W=1 within the posterior CI. The reference's --sync-rate has
            # the same staleness trade-off (options.cpp:213-216) but no guard.
            print(f"WARNING: --window {self.window} > 64 for bayesWMPI: "
                  "stale windows this wide measurably bias the alpha/m0 "
                  "posterior (BIAS_SWEEP_BW.md); keep BayesW windows <= 64 "
                  "(--window 1 runs EXACT sequential BayesW via the W=1 "
                  "whole-sweep kernel)", flush=True)
        if self.mcmc_out_dir:
            os.makedirs(self.mcmc_out_dir, exist_ok=True)
            os.makedirs(os.path.join(self.mcmc_out_dir, "tarballs"), exist_ok=True)
        return self


def _read_option_file(path: str) -> List[str]:
    """Parse the reference's key-value option file into argv tokens.

    Format (options.cpp:335-397): one `key value` pair per line, keys without
    leading dashes; lines starting with '#' ignored.
    """
    argv: List[str] = []
    with open(path) as fh:
        for raw in fh:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(None, 1)
            key = parts[0]
            if not key.startswith("--"):
                key = "--" + key
            argv.append(key)
            if len(parts) > 1 and parts[1].strip():
                argv.append(parts[1].strip())
    return argv


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hydra-tpu-torch",
        description="Bayesian whole-genome regression on PyTorch + CUDA "
                    "(hydra rebuild)",
        allow_abbrev=False,
    )
    a = p.add_argument
    a("--inp-file", default="", help="key-value option file (options.cpp:335)")
    a("--mpibayes", "--bayes", dest="bayes_type", default="",
      help="bayesMPI | bayesWMPI | bayesFHMPI")
    a("--bfile", dest="bed_file", default="")
    a("--pheno", dest="pheno", default="", help="phenotype file(s), comma-separated")
    a("--failure", dest="failure_file", default="")
    a("--covariates", dest="covariates_file", default="")
    a("--groupIndexFile", dest="group_index_file", default="")
    a("--groupMixtureFile", dest="group_mixture_file", default="")
    a("--group", dest="group_index_file_legacy", default="")
    a("--mS", dest="group_mixture_file_legacy", default="")
    a("--groupPriorsFile", dest="priors_file", default="")
    a("--dPriorsFile", dest="d_priors_file", default="")
    a("--marker-blocks-file", dest="marker_blocks_file", default="")
    a("--sparse-dir", dest="sparse_dir", default="")
    a("--sparse-basename", dest="sparse_basename", default="")
    a("--number-markers", dest="number_markers", type=int, default=0)
    a("--number-individuals", dest="number_individuals", type=int, default=0)
    a("--bed-to-sparse", action="store_true", dest="bed_to_sparse")
    a("--blocks-per-rank", dest="blocks_per_rank", type=int, default=1)
    a("--check-RAM", action="store_true", dest="check_ram")
    a("--check-RAM-tasks", dest="check_ram_tasks", type=int, default=0)
    a("--check-RAM-tasks-per-node", dest="check_ram_tpn", type=int, default=0)
    a("--threshold-fnz", dest="threshold_fnz", type=float, default=0.06)
    a("--chain-length", dest="chain_length", type=int, default=10000)
    a("--burn-in", dest="burnin", type=int, default=5000)
    a("--seed", dest="seed", type=int, default=0)
    a("--thin", dest="thin", type=int, default=5)
    a("--save", dest="save", type=int, default=10)
    a("--S", dest="S", default="0.01,0.001,0.0001")
    a("--shuf-mark", dest="shuffle_markers", type=int, default=1)
    a("--sync-rate", dest="sync_rate", type=int, default=1)
    a("--sparse-sync", action="store_true", dest="sparse_sync")
    a("--bed-sync", action="store_true", dest="bed_sync")
    a("--mcmc-out-dir", dest="mcmc_out_dir", default="")
    a("--mcmc-out-name", dest="mcmc_out_name", default="default_output_name")
    a("--out", dest="title", default="brr",
      help="run title/label (options.cpp:247-249)")
    # declared but commented out in the reference (options.hpp:25,
    # options.cpp:37-42 inside /* */) — accepted as a documented no-op
    a("--mpiBayesGroups", action="store_true", dest="mpi_bayes_groups",
      help=argparse.SUPPRESS)
    a("--restart", action="store_true", dest="restart")
    a("--ignore-xfiles", action="store_true", dest="ignore_xfiles")
    a("--quad_points", dest="quad_points", default="25")
    a("--betaA", dest="beta_a", type=float, default=1.0)
    a("--betaB", dest="beta_b", type=float, default=1.0)
    a("--tau0", dest="tau0", type=float, default=1.0)
    a("--s02c", dest="s02c", type=float, default=1.0)
    a("--v0c", dest="v0c", type=float, default=3.0)
    a("--v0L", dest="v0L", type=float, default=3.0)
    a("--v0t", dest="v0t", type=float, default=3.0)
    a("--interleave-phenotypes", action="store_true", dest="interleave")
    # accelerator knobs (no reference equivalent)
    a("--window", dest="window", type=int, default=0)
    a("--stale", action="store_true", dest="stale",
      help="use stale-window semantics instead of exact Gram-corrected Gibbs")
    a("--n-devices", dest="n_devices", type=int, default=0,
      help="marker shards, one torch.distributed rank and device each: 0 "
           "or the number of ranks the launcher started "
           "(scripts/run_multiprocess_torch.py, torchrun); BayesRRm, "
           "BayesFH, BayesW and multi-trait BayesRRm")
    a("--ind-shards", dest="ind_shards", type=int, default=1,
      help="I chunks of the individuals a marker shard (BayesRRm, BayesFH, "
           "BayesW and multi-trait BayesRRm; I must divide the ranks): rank "
           "r holds marker shard r // I and chunk r % I of the residual and "
           "byte columns, and each window's statistics are summed over the "
           "shard's I ranks before the draw. --check-RAM: a device's share "
           "of such a run")
    a("--dcn-slices", dest="dcn_slices", type=int, default=1,
      help="S slices of the marker ranks (S divides them): rank r = s "
           "(D/S) + m is slice s, position m, and holds marker shard r as "
           "on the flat layout; each window's residual change is summed "
           "over the slice's ranks, then across slices (a 1-D residual in "
           "8 chunks). Every sampler; with --det-sync 1 the chain is the "
           "flat one bit for bit")
    a("--dtype", dest="dtype", default="float32",
      choices=["float32", "float64"],
      help="sampler accumulation dtype (the reference is f64 end-to-end): "
           "float64 runs single-trait BayesRRm/FH in plain torch float64 "
           "per window on the marker schedule, as the JAX package runs it "
           "without Pallas; multi-trait and BayesW run float32 and say so")
    a("--cache-planes", dest="plane_cache", default="off",
      choices=["off", "on", "auto"],
      help="cache int8 decoded genotype planes: 'on' runs single-trait "
           "BayesRRm/FH stale windows W >= 8 on complete genotypes through "
           "the per-window branch (elsewhere an INFO line says it is "
           "ignored; BayesW and multi-trait ignore it with an INFO line); "
           "'auto' is an accepted alias of 'off'")
    a("--mega", dest="mega", default="auto",
      choices=["auto", "on", "off"],
      help="whole-sweep kernels: 'off' runs the per-window branch of "
           "every sampler (marker schedule)")
    a("--schedule", dest="schedule", default="auto",
      choices=["auto", "marker", "block"],
      help="marker-processing schedule for stale windows: 'marker' = the "
           "reference's fresh per-sweep marker permutation; 'block' = a "
           "one-time decorrelating marker->slot permutation plus per-sweep "
           "window-BLOCK shuffle, so the whole-sweep kernels read windows "
           "in place. auto = block, but marker for --mega off, forced "
           "planes, --dtype float64 and W < 8 (BayesRRm/FH), BayesW W = "
           "2..7, multi-trait W < 8 and exact runs with missing calls "
           "or NaN phenotypes, and more than one marker shard")
    a("--det-sync", dest="det_sync", type=int, default=0,
      help="1 = marker shards sum the residual's change and the counts in "
           "rank order (each rank's addend in its row of a zero buffer, "
           "one all_reduce, the rows added locally): the same bits on any "
           "backend or layout, at D times the payload")
    a("--cross-sync", dest="cross_sync", type=int, default=0,
      help="exact mode, >1 marker shards, single-trait BayesRRm/FH "
           "(multi-trait ignores it with an INFO line, as the JAX CLI "
           "does): apply OTHER shards' delta-betas "
           "to the in-window correction every B markers (must divide the "
           "window). Default 0 = once per window (the window-boundary "
           "residual sum; no in-window collective — strictly fresher than "
           "the reference at --sync-rate=window, which freezes epsilon "
           "on-rank too). 1 = strict syncRate-1 parity (one scalar/shard "
           "collective per marker step; latency-bound at scale)")
    a("--device", dest="device", default="",
      choices=["", "cuda", "cpu", "tpu"],
      help="device: empty or cuda runs the CUDA kernels and raises without "
           "a card; cpu runs the plain PyTorch versions; tpu raises (it is "
           "the JAX package's)")
    # Reference-compat flags. --raw-update selects a numerically identical
    # epsilon update formula in the reference's 1-rank path (BayesW.cpp:1812)
    # -> accepted no-op. The PPBayes/preprocess flags select the non-MPI
    # preprocessed-BED engine the reference declares but does not build
    # (SURVEY dead/legacy: src/limitsequencegraph.cpp) -> explicit error.
    a("--raw-update", action="store_true", dest="raw_update")
    for dead in ("--ppbayes", "--ppasyncbayes"):
        a(dead, dest="dead_analysis", action="store",
          metavar="TYPE", default="", help=argparse.SUPPRESS)
    a("--preprocess", action="store_true", dest="dead_preprocess",
      help=argparse.SUPPRESS)
    a("--compress", action="store_true", dest="dead_preprocess",
      help=argparse.SUPPRESS)
    return p


def parse_args(argv: Optional[List[str]] = None) -> Options:
    parser = build_parser()
    ns, unknown = parser.parse_known_args(argv)
    if ns.inp_file:
        file_argv = _read_option_file(ns.inp_file)
        ns, unknown = parser.parse_known_args(file_argv + (argv or []))
    if unknown:
        # the reference rejects unrecognised flags (options.cpp:292-296)
        raise SystemExit(f'Error: invalid option "{unknown[0]}".')

    opt = Options()
    opt.bayes_type = ns.bayes_type
    opt.bed_file = ns.bed_file
    opt.phenotype_files = [s for s in ns.pheno.split(",") if s] if ns.pheno else []
    opt.multi_phen = len(opt.phenotype_files) > 1
    opt.failure_file = ns.failure_file
    opt.covariates_file = ns.covariates_file
    opt.covariates = bool(ns.covariates_file)
    opt.group_index_file = ns.group_index_file or ns.group_index_file_legacy
    opt.group_mixture_file = ns.group_mixture_file or ns.group_mixture_file_legacy
    opt.priors_file = ns.priors_file
    opt.d_priors_file = ns.d_priors_file
    opt.marker_blocks_file = ns.marker_blocks_file
    opt.sparse_dir = ns.sparse_dir
    opt.sparse_basename = ns.sparse_basename
    opt.number_markers = ns.number_markers
    opt.number_individuals = ns.number_individuals
    opt.bed_to_sparse = ns.bed_to_sparse
    opt.blocks_per_rank = ns.blocks_per_rank
    opt.check_ram = ns.check_ram
    opt.check_ram_tasks = ns.check_ram_tasks
    opt.check_ram_tpn = ns.check_ram_tpn
    opt.threshold_fnz = ns.threshold_fnz
    opt.chain_length = ns.chain_length
    opt.burnin = ns.burnin
    opt.seed = ns.seed
    opt.seed_given = ns.seed != 0
    opt.thin = ns.thin
    opt.save = ns.save
    opt.S = [float(s) for s in str(ns.S).split(",") if s]
    opt.shuffle_markers = ns.shuffle_markers
    opt.sync_rate = ns.sync_rate
    opt.sparse_sync = ns.sparse_sync
    opt.bed_sync = ns.bed_sync
    opt.mcmc_out_dir = ns.mcmc_out_dir
    opt.mcmc_out_name = ns.mcmc_out_name
    opt.title = ns.title
    opt.restart = ns.restart
    opt.use_xfiles_in_restart = not ns.ignore_xfiles
    opt.quad_points = ns.quad_points
    opt.beta_a = ns.beta_a
    opt.beta_b = ns.beta_b
    opt.tau0 = ns.tau0
    opt.s02c = ns.s02c
    opt.v0c = ns.v0c
    opt.v0L = ns.v0L
    opt.v0t = ns.v0t
    opt.interleave = ns.interleave
    opt.window = ns.window
    opt.exact = not ns.stale
    opt.n_devices = ns.n_devices
    opt.ind_shards = ns.ind_shards
    opt.dcn_slices = ns.dcn_slices
    opt.dtype = ns.dtype
    opt.plane_cache = ns.plane_cache
    opt.mega = ns.mega
    opt.schedule = ns.schedule
    opt.cross_sync = ns.cross_sync
    opt.det_sync = ns.det_sync
    opt.device = ns.device
    if getattr(ns, "dead_analysis", "") or getattr(ns, "dead_preprocess", False):
        raise SystemExit(
            "FATAL  : the PPBayes/preprocess path is not built in the "
            "reference and is not reproduced here; use --mpibayes "
            "bayesMPI|bayesWMPI|bayesFHMPI (SURVEY.md layer map, dead/legacy)")
    # read-source selection (main.cpp:67-136): bed if --bfile, sparse if --sparse-dir
    opt.read_from_bed_file = bool(opt.bed_file)
    opt.read_from_sparse_files = bool(opt.sparse_dir)
    opt.mixed_representation = opt.read_from_bed_file and opt.read_from_sparse_files
    return opt.validate()
