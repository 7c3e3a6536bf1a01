"""BayesRRm and BayesFH: spike + Gaussian-mixture Gibbs.

Port of ``hydra_tpu/samplers/bayesrrm.py`` (reference BayesRRm::runMpiGibbs,
src/BayesRRm.cpp:933-2939): h-packed genotypes, covariates (fixed
effects), on one device or on D marker shards, one ``torch.distributed``
rank a shard (``n_dev``, ``rank``; see "Marker shards" below). A sweep is

  mu update -> per-marker noise -> mrow build -> the windows -> cass ->
  sigmaG (BayesFH: the local shrinkage and the group tau chain), pi ->
  the covariates' ridge sweep -> sigmaE

and the windows take one of three branches, as the JAX sampler's do:
  - whole sweep (the default): one sweep_exact / sweep_stale call over all
    windows (``ops/sweep_kernel.py``), any W >= 1; stale windows W >= 8 on
    the marker schedule take sweep_stale_sd instead when HYDRA_TPU_SD asks
    for it (``sd_sub_window``), where the JAX sampler takes it;
  - per window (``mega="off"``, or forced planes): the JAX ``window_body``
    (bayesrrm.py:293-661) with its kernels, per window window_stats (or
    window_stats_planes) -> num0 -> the stale draw or window_gibbs ->
    window_axpy (or window_axpy_planes), ``window_sweep`` below;
  - float64 (``dtype="float64"``, ``--dtype float64``): the JAX package
    runs it without Pallas, on the XLA ``window_body`` in float64 on the
    marker schedule (bayesrrm.py:188, :1000-1018); the port runs the same
    per window in plain torch float64 (``window_sweep_f64``): the decoded
    standardized rows, their dot products with the residual, the exact
    window's Gram as a float64 matmul and the recurrence, or the stale
    draw, and the residual update. The state, hyper-parameters and
    restart state are float64 too.

with everything per marker kept in SLOT order. The schedule permutes the
slots a sweep visits: "block" (the default) keeps a one-time setup
permutation of marker -> slot (the JAX sampler's, same RandomState seed, so
``slot_to_marker`` matches it exactly) and shuffles whole windows each
sweep; "marker" shuffles every slot each sweep.

Randomness is counter-based, one ``torch.Generator`` per (seed, iteration,
site) with the JAX sampler's site ids, and the per-marker u/nrm are drawn
over all slots and indexed by slot. ``step(..., noise=...)`` takes the
draws from the caller instead, which is how the tests hold one sweep
against the JAX sampler.

Marker shards (n_dev = D > 1) follow the JAX sampler on ``make_mesh(D)``:
the same slot layout (shard d holds global slots d m_loc .. (d + 1) m_loc,
every rank draws every shard's block permutation in shard order), each
shard's own sweep order (its generator keyed by the shard, as
``fold_in(site(_S_PERM), dev)``), the per-slot noise drawn over all D m_loc
slots and sliced at rank m_loc, and the residual replicated: after every
window each rank adds the ranks' summed change (``mesh.residual_sum``:
``marker_sum``, ``det_sum`` with det_sync, ``hier_sum`` over the slices of
``--dcn-slices`` (n_dcn), whose shard layout is the flat one). The
branches at D > 1:
  - whole sweep (float32, stale, or exact with cross_sync >= W, W >= 8,
    mega not off; the JAX ``use_wmega``): the whole-sweep kernels a window
    a launch, the exact Grams still once a batch (``sync`` of
    ``ops/sweep_kernel.py``);
  - per window (mega off, W < 8, float64): ``window_sweep`` /
    ``window_sweep_f64`` with the sum after each window's axpy;
  - exact with cross_sync B < W: per window, the cross-shard Gram blocks
    (torch ops: complete data from the ranks' packed bytes and the rank-1
    standardization, missing data from their standardized rows) and the
    recurrence with the other shards' steps applied every B steps
    (``_cross_recurrence``, the JAX bayesrrm.py:443-609).
The component counts, sums of beta^2 and BayesFH's scaled sum are summed
over the marker shards; the hyper-parameter draws are the same on every
rank.

Chunks of individuals (n_ind = I > 1, ``--ind-shards``) follow the JAX
sampler on ``make_mesh(D I, n_ind=I)``: each marker shard is held by the I
ranks of its individual group (``distributed.rank_grid``), each with the
byte columns, residual, mask and covariates of its chunk of n_pad / I
individuals, padded to a multiple of 512 (the kernels' whole 128-byte rows;
pads are missing-coded and masked). The marker statistics come from the
whole rows. The per-window branch runs, marker schedule: per window the
chunk's statistics (and Gram) are summed over the individual group in one
all_reduce before num0 (``mesh.ind_sum``, the JAX ``psum_i``, the same
bits on every rank of it), so the draws agree across the group, and the
residual change of the chunk is summed over the marker group. mu's and
sigmaE's sums and the covariates' dot products are summed over the
individual group too.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from hydra_tpu_torch.data.genotypes import (Dataset, chunk_columns,
                                            chunk_rows, ind_chunk,
                                            marker_shards)
from hydra_tpu_torch.io.pheno import center_and_scale
from hydra_tpu_torch.ops.decode import (decode_planes_hp, hpack_bytes,
                                        standardized_window)
from hydra_tpu_torch.ops.gibbs_kernel import window_gibbs
from hydra_tpu_torch.ops.planes import (build_planes, window_axpy_planes,
                                        window_stats_planes)
from hydra_tpu_torch.ops.sweep_kernel import (N_FIXED, block_order, mrow_width,
                                              sd_sub_window, stale_draw,
                                              sweep_exact, sweep_stale,
                                              sweep_stale_sd)
from hydra_tpu_torch.ops.window_kernels import window_axpy, window_stats
from hydra_tpu_torch.parallel import distributed, mesh
from hydra_tpu_torch.utils import dist

f32 = torch.float32

# Hyper-priors (BayesRRm.h:29-34)
V0E = 1e-4
S02E = 1e-4
V0G_DEFAULT = 1e-4
S02G_DEFAULT = 1e-4
S02F = 1.0               # fixed-effect prior variance (BayesRRm.h:35)

# RNG site ids, as in the JAX sampler (hydra_tpu/samplers/bayesrrm.py:79-82)
_S_MU, _S_UNIF, _S_NORM, _S_SIGMAG, _S_PI, _S_SIGMAE = 0, 1, 2, 3, 4, 5
_S_PERM, _S_COV, _S_COVPERM = 6, 7, 8
_S_NU, _S_LAM, _S_TAU, _S_CSLAB, _S_HTAU = 9, 10, 11, 12, 13
_S_INIT_SIGMAG, _S_INIT_FH = 100, 101
_INIT_ITERATION = -1     # init-time draws sit outside the chain's iterations


def recurrence_f64(gram, num0, rows, i2se, K):
    """The exact window's sequential recurrence in float64 (the JAX
    ``marker_step``, bayesrrm.py:609-621, on its ``draw_rows``): marker j
    draws from num0_j + corr_j, then corr += dbeta_j Gram[:, j]. Returns
    (W, 4) = [beta_new, comp, acum0, dbeta]."""
    corr = torch.zeros_like(num0)
    res = []
    for j in range(num0.shape[0]):
        bn, cp, ac, db = stale_draw(rows[j:j + 1], (num0[j] + corr[j])[None],
                                    i2se, K)
        corr = corr + db * gram[:, j]
        res.append(torch.cat([bn, cp, ac, db]))
    return torch.stack(res)


def global_slots(starts, lengths, m_loc: int, schedule: str, seed: int):
    """(slot_to_marker (D m_loc,), [each shard's permutation of its m_loc
    slots]) for the shards of ``shard_layout``: shard d's slots hold its
    markers then pads (-1), permuted on the block schedule by the one-time
    setup permutation (identity on the marker schedule). Every shard's
    permutation is drawn in shard order from one RandomState, the JAX
    samplers' (bayesrrm.py:1192-1215, bayesw.py:695-711), so the layout does
    not depend on the rank that builds it."""
    n_dev = len(starts)
    slot_to_marker = np.full(n_dev * m_loc, -1, dtype=np.int64)
    rs = (np.random.RandomState((seed ^ 0x5EED1) & 0x7FFFFFFF)
          if schedule == "block" else None)
    perms = []
    for d in range(n_dev):
        s, ln = int(starts[d]), int(lengths[d])
        sl = slot_to_marker[d * m_loc:(d + 1) * m_loc]
        sl[:ln] = np.arange(s, s + ln)
        p = rs.permutation(m_loc) if rs is not None else np.arange(m_loc)
        sl[:] = sl[p]
        perms.append(p)
    return slot_to_marker, perms


def shard_rows(x, cfg):
    """This shard's rows of a per-slot array over all D m_loc slots (a
    draw, or ``slot_to_marker``): rows rank m_loc .. (rank + 1) m_loc, the
    JAX ``dynamic_slice(.., dev m_loc)``. ``cfg`` is a sampler's config
    (m_loc, n_dev, rank). An array of another length raises."""
    if x.shape[0] != cfg.m_glob:
        raise ValueError(f"a per-slot array has D m_loc = {cfg.m_glob} rows, "
                         f"got {x.shape[0]}")
    return x[cfg.rank * cfg.m_loc:(cfg.rank + 1) * cfg.m_loc]


def sweep_order(cfg, seed: int, it: int, site: int, device: torch.device,
                noise: Optional[dict] = None) -> torch.Tensor:
    """Slots in the order sweep ``it`` visits them (int32), for any
    sampler's ``cfg`` (shuffle, schedule, window, m_loc, rank, n_dev): the
    identity without shuffling, else a permutation of the windows (block
    schedule) or of the slots, given as noise "wperm" / "perm" or drawn
    from the generator of draw site ``site`` (the sampler's ``_S_PERM``)
    keyed by the shard."""
    noise = noise or {}
    if not cfg.shuffle:
        return torch.arange(cfg.m_loc, dtype=torch.int32, device=device)
    block = cfg.schedule == "block"
    perm = noise.get("wperm" if block else "perm")
    if perm is None:
        perm = torch.randperm(cfg.n_windows if block else cfg.m_loc,
                              device=device,
                              generator=dist.shard_generator(
                                  seed, it, site, device, cfg.rank,
                                  cfg.n_dev))
    if block:
        return block_order(perm.to(device), cfg.window)
    return perm.to(device, torch.int32)


def resolve_device(name: str) -> torch.device:
    """``--device``: empty means cuda. A CUDA request without a card raises;
    the CPU path runs only when asked for."""
    name = name or "cuda"
    if name == "tpu":
        raise ValueError("--device tpu is the JAX package's (hydra_tpu.cli); "
                         "this port runs on cuda or cpu")
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() "
                           "is false; pass --device cpu to run the plain "
                           "PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return dev


class OnGrid:
    """A sampler's place on the rank grid (``distributed.rank_grid``),
    shared by BayesRRm, BayesW and multi-trait BayesRRm: ``grid`` (None on one marker shard
    without slices or chunks of individuals), ``cfg`` (n_pad, n_ind) and
    ``_isum``, the sampler's sum over the chunks."""

    def _join_grid(self, n_dcn: int, n_ind: int, shard: int) -> int:
        """Set ``grid`` (its groups made here, a collective point) and
        return this rank's chunk of individuals; a rank that does not hold
        marker shard ``shard`` raises."""
        self.grid = (distributed.rank_grid(int(n_dcn), n_ind)
                     if n_dcn > 1 or n_ind > 1 else None)
        if self.grid is None:
            return 0
        if self.grid.shard != shard:
            raise ValueError(f"rank {distributed.rank()} holds marker shard "
                             f"{self.grid.shard}, not {shard}")
        return self.grid.chunk

    @property
    def marker_group(self):
        """The ranks of this rank's chunk, one a marker shard (None: every
        rank)."""
        return self.grid.markers if self.grid is not None else None

    def _local(self, x: np.ndarray) -> np.ndarray:
        """This rank's chunk of an individual-indexed array (n_pad, ...)."""
        chunk = self.grid.chunk if self.grid is not None else 0
        return chunk_rows(x, self.cfg.n_ind, chunk)

    def gather_markers(self, t: torch.Tensor) -> torch.Tensor:
        """Per-slot state of every marker shard, in shard order, on every
        rank (``distributed.gather_markers`` over the marker group)."""
        return distributed.gather_markers(t, self.marker_group)

    def residual(self, eps: torch.Tensor) -> torch.Tensor:
        """The whole residual (n_pad, ...) from this rank's chunk: the
        chunks of the individual group gathered (a collective at I > 1)."""
        if self.cfg.n_ind == 1:
            return eps
        return distributed.gather_individuals(
            eps, self.grid, self.cfg.n_pad // self.cfg.n_ind)

    def _ind_pack(self, *parts):
        """``parts`` (tensors, or None) summed over the chunks of
        individuals (``self._isum``) in one all_reduce of their
        concatenation; the identity at I = 1."""
        if self.cfg.n_ind == 1:
            return parts
        live = [t for t in parts if t is not None]
        flat = self._isum(torch.cat([t.reshape(-1) for t in live]))
        out, off = [], 0
        for t in parts:
            if t is None:
                out.append(None)
                continue
            out.append(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()
        return out


@dataclass(frozen=True)
class BayesRRmConfig:
    n_real: int          # individuals after NA correction (dN)
    n_pad: int
    m_tot: int           # real markers
    m_loc: int           # padded marker slots (multiple of window)
    window: int
    k: int               # mixture components incl. zero
    num_groups: int
    exact: bool
    shuffle: bool
    schedule: str        # "block" | "marker"
    complete: bool       # no missing genotypes among real individuals
    per_window: bool = False   # the per-window branch (mega off / planes)
    planes: bool = False       # cached int8 planes (--cache-planes on)
    sub_window: int = 0        # > 0: the single-decode stale sweep
    n_cov: int = 0             # covariates (fixed effects)
    fh: bool = False           # BayesFH (--mpibayes bayesFHMPI)
    dtype: str = "float32"     # "float64": the plain torch float64 branch
    n_dev: int = 1             # marker shards, one rank each
    rank: int = 0              # this rank's shard
    cross_sync: int = 0        # exact, D > 1: steps between exchanges (W:
                               # the window-boundary residual sum only)
    det_sync: bool = False     # rank-order sums, the same on any topology
    n_dcn: int = 1             # --dcn-slices: slices of the marker hierarchy
    n_ind: int = 1             # --ind-shards: chunks of individuals a shard
    n_loc: int = 0             # this rank's individuals (its chunk, padded)
    # FH hyper-priors (options.hpp:89-96)
    v0L: float = 3.0
    v0t: float = 3.0
    v0c: float = 3.0
    s02c: float = 1.0
    tau0: float = 1.0

    @property
    def n_windows(self) -> int:
        return self.m_loc // self.window

    @property
    def m_glob(self) -> int:
        return self.m_loc * self.n_dev

    @property
    def cross(self) -> bool:
        """Exact windows that exchange steps across shards inside the
        window (cross_sync < W), the JAX sampler's not ``local_exact``."""
        return self.n_dev > 1 and self.exact and self.cross_sync < self.window


@dataclass
class BayesRRmState:
    eps: torch.Tensor          # (n_pad,) residual
    beta: torch.Tensor         # (m_loc,) per slot
    components: torch.Tensor   # (m_loc,) int32 per slot
    acum: torch.Tensor         # (m_loc,) P(zero component), per slot
    mu: torch.Tensor           # ()
    sigma_e: torch.Tensor      # ()
    sigma_g: torch.Tensor      # (G,)
    est_pi: torch.Tensor       # (G, K)
    gamma: torch.Tensor        # (F,) fixed effects
    # BayesFH (lambda 1, nu 0, c_slab 0, tau = hyp_tau = 1 otherwise)
    lambda_var: torch.Tensor   # (m_loc,) local shrinkage, per slot
    nu_var: torch.Tensor       # (m_loc,)
    c_slab: torch.Tensor       # (G,)
    tau: torch.Tensor          # ()
    hyp_tau: torch.Tensor      # ()


STATE_FIELDS = tuple(f.name for f in dataclasses.fields(BayesRRmState))


@dataclass
class IterStats:
    m0: torch.Tensor             # (G,) non-zero markers per group
    cass: torch.Tensor           # (G, K)
    beta_sqn: torch.Tensor       # (G,)
    sum_abs_dbeta: torch.Tensor  # ()


def state_from_numpy(x, device, dtype=f32) -> BayesRRmState:
    """A state from numpy arrays: a JAX ``BayesRRmState`` converted with
    ``np.asarray`` per field, or a dict with the same field names; the
    real fields in ``dtype``."""
    get = x.get if isinstance(x, dict) else (lambda k: getattr(x, k))
    out = {}
    for name in STATE_FIELDS:
        dt = torch.int32 if name == "components" else dtype
        out[name] = torch.as_tensor(np.array(get(name)), dtype=dt,
                                    device=device)
    return BayesRRmState(**out)


def state_to_numpy(state: BayesRRmState) -> dict:
    """Field name -> numpy array (the JAX state's names and dtypes)."""
    return {name: getattr(state, name).cpu().numpy() for name in STATE_FIELDS}


class BayesRRm(OnGrid):
    """Data layout, state init and the Gibbs sweep of one device or one
    marker shard."""

    def __init__(self, dataset: Dataset, *, window: int, exact: bool = True,
                 shuffle: bool = True, seed: int = 0, schedule: str = "auto",
                 mega: str = "auto", plane_cache: str = "off",
                 fh: bool = False, fh_params: Optional[dict] = None,
                 dtype: str = "float32", device="cuda",
                 packed_device: Optional[torch.Tensor] = None,
                 n_dev: int = 1, rank: int = 0, cross_sync: int = 0,
                 det_sync: bool = False, n_dcn: int = 1, n_ind: int = 1):
        """fh: BayesFH, with the hyper-priors v0L, v0t, v0c, s02c, tau0 of
        ``fh_params`` (the CLI defaults where absent). mega: "off" takes
        the per-window branch ("auto"/"on": the whole-sweep kernels, which
        take every W). plane_cache: "on" takes
        the per-window branch on cached int8 planes for stale windows
        W >= 8 on complete genotypes (else it is ignored, as in the JAX
        sampler). dtype: "float64" runs the plain torch float64 branch
        (per window, marker schedule, no kernels), as the JAX sampler runs
        float64 without Pallas. packed_device: the genotypes already
        h-packed on the device, (M, NB) uint8 in marker order, for data
        generated there; then ``dataset.geno`` supplies only n, n_pad and
        the marker statistics. n_dev > 1: this rank's shard ``rank`` of
        n_dev, under a process group of n_dev ranks (``dataset.geno`` may
        hold this shard's rows alone, from ``marker_offset``); cross_sync
        (exact): steps between the cross-shard exchanges, 0 = the window;
        det_sync: rank-order sums (``mesh.det_sum``); n_dcn: the slices of
        ``--dcn-slices`` (the residual's change summed by ``hier_sum``);
        n_ind: the chunks of individuals of ``--ind-shards``, one rank each
        (n_dev n_ind ranks; this rank's chunk is its rank modulo n_ind, see
        "Chunks of individuals" above)."""
        self.ds = dataset
        self.seed = int(seed)
        self.device = (device if isinstance(device, torch.device)
                       else resolve_device(device))
        geno = dataset.geno
        K = int(dataset.mS.shape[1])
        if window < 1:
            raise ValueError(f"--window {window} is below 1")
        if schedule not in ("auto", "marker", "block"):
            raise ValueError(f"schedule must be auto/marker/block, "
                             f"got {schedule!r}")
        if mega not in ("auto", "on", "off"):
            raise ValueError(f"mega must be auto/on/off, got {mega!r}")
        if dtype not in ("float32", "float64"):
            raise ValueError(f"dtype must be float32/float64, got {dtype!r}")
        f64 = dtype == "float64"
        self.dt = torch.float64 if f64 else f32
        n_dev, rank, n_ind = int(n_dev), int(rank), int(n_ind)
        # cross-shard exchange interval (the JAX rule, bayesrrm.py:976-980)
        cs = min(cross_sync, window) if cross_sync > 0 else window
        if exact and cs < window and window % cs:
            raise ValueError(f"--cross-sync {cs} must divide the window "
                             f"({window})")
        complete = bool(geno.nm_global_sum == 0)
        # the JAX gates (bayesrrm.py:1001-1118) without the TPU-backend
        # term: forced planes need float32 stale windows W >= 8 on complete
        # data and one process; float64 runs no kernel, so no whole sweep
        planes = (plane_cache == "on" and window >= 8 and not exact
                  and complete and not f64 and n_dev == 1 and n_ind == 1)
        if plane_cache == "on" and not planes:
            print("INFO   : --cache-planes on ignored (needs float32 stale "
                  "windows >= 8, complete data and one device without "
                  "--ind-shards)", flush=True)
        # D > 1: the whole-sweep kernels a window a launch where the JAX
        # use_wmega runs them (W >= 8, no in-window exchange), else the
        # per-window branch (its window_body); chunks of individuals take
        # the per-window branch (the JAX mega_ok and use_wmega need
        # n_ind = 1, bayesrrm.py:1017-1018, :1101)
        per_window = (mega == "off" or planes or f64 or n_ind > 1
                      or (n_dev > 1 and (window < 8
                                         or (exact and cs < window))))
        # auto: block wherever the JAX package's whole-sweep kernel hosts
        # it (W >= 8, mega not off, no forced planes, one shard: its
        # mega_ok), else marker, so CPU and CUDA runs take the JAX chain
        # schedule of the same flags
        if schedule == "auto":
            schedule = ("block" if window >= 8 and not per_window
                        and n_dev == 1 else "marker")
        if schedule == "block" and exact:
            print("INFO   : exact run — block schedule (exact sequential-"
                  "Gibbs semantics preserved; scan order depends on the "
                  "window partition — --schedule marker restores "
                  "window-invariant chains)", flush=True)
        starts, lengths, m_loc = marker_shards(geno.m_global, n_dev, rank,
                                               window, dataset.blocks, n_ind)
        # this rank's chunk of individuals (n_loc, the whole n_pad at I = 1)
        # and the groups it sums over
        _, n_loc = ind_chunk(geno.n_pad, n_ind)
        chunk = self._join_grid(n_dcn, n_ind, rank)
        nb = n_loc // 4
        # the JAX gate of the single-decode sweep (bayesrrm.py:788-815):
        # the one-shard whole-sweep branch's stale windows W >= 8, marker
        # schedule
        sub_window = (sd_sub_window(window, nb, complete)
                      if (not exact and not per_window and window >= 8
                          and schedule == "marker" and n_dev == 1) else 0)
        fhp = fh_params or {}
        self.cfg = cfg = BayesRRmConfig(
            n_real=geno.n, n_pad=geno.n_pad, m_tot=geno.m_global, m_loc=m_loc,
            window=window, k=K, num_groups=dataset.num_groups, exact=exact,
            shuffle=shuffle, schedule=schedule, complete=complete,
            per_window=per_window, planes=planes, sub_window=sub_window,
            n_cov=0 if dataset.X is None else int(dataset.X.shape[1]),
            fh=bool(fh), dtype=dtype, n_dev=n_dev, rank=rank, cross_sync=cs,
            det_sync=bool(det_sync), n_dcn=int(n_dcn), n_ind=n_ind,
            n_loc=n_loc,
            **{k: float(fhp.get(k, d)) for k, d in (
                ("v0L", 3.0), ("v0t", 3.0), ("v0c", 3.0), ("s02c", 1.0),
                ("tau0", 1.0))})
        # sums over the marker shards (the JAX ma_sum), of the residual's
        # change (its hpsum) and over the chunks of individuals (psum_i)
        self._sum = functools.partial(mesh.shard_sum, n_dev=n_dev,
                                      det=bool(det_sync),
                                      group=self.marker_group)
        self._esum = mesh.residual_sum(n_dev, bool(det_sync), int(n_dcn),
                                       n_ind)
        self._isum = functools.partial(mesh.ind_sum, grid=self.grid)
        if self.device.type == "cuda":
            self._check_memory(nb)

        # ---- slot layout: slot = marker, then the block setup permutation
        # (every shard's slot_to_marker; this shard's rows and statistics)
        self.slot_to_marker, perms = global_slots(starts, lengths, m_loc,
                                                  schedule, self.seed)
        p = perms[rank]
        s, ln = int(starts[rank]), int(lengths[rank])
        ls = s - geno.marker_offset          # this shard's rows in geno
        groups_g = np.zeros(m_loc, dtype=np.int32)
        mave_g = np.zeros(m_loc, dtype=np.float32)
        mstd_g = np.zeros(m_loc, dtype=np.float32)
        valid_g = np.zeros(m_loc, dtype=np.float32)
        mave_g[:ln] = geno.mave[ls:ls + ln]
        mstd_g[:ln] = geno.mstd[ls:ls + ln]
        groups_g[:ln] = dataset.groups[s:s + ln]
        valid_g[:ln] = 1.0
        groups_g, mave_g, mstd_g = groups_g[p], mave_g[p], mstd_g[p]
        valid_g = valid_g[p]

        dev = self.device
        # the rows' byte columns of this rank's chunk (the marker statistics
        # above come from the whole rows)
        if packed_device is None:
            # pad slots are all-missing: PLINK 0x55, h-packed 0xFF
            packed_g = np.full((m_loc, nb), 0b01010101, dtype=np.uint8)
            packed_g[:ln] = chunk_columns(geno.packed[ls:ls + ln], cfg.n_pad,
                                          n_ind, chunk, 0b01010101)
            self.packed = torch.from_numpy(hpack_bytes(packed_g[p])).to(dev)
            del packed_g
        else:
            rows = torch.full((m_loc, nb), 0xFF, dtype=torch.uint8,
                              device=dev)
            rows[:ln] = chunk_columns(packed_device[ls:ls + ln], cfg.n_pad,
                                      n_ind, chunk, 0xFF)
            self.packed = rows[torch.from_numpy(p).to(dev)]
            del rows
        # int8 planes in individual order, decoded on the device
        self.planes = build_planes(self.packed) if planes else None
        self._f64_graph = None     # the float64 recurrence's CUDA graph
        dt = self.dt
        self.groups = torch.from_numpy(groups_g).to(dev, torch.int64)
        self.mave = torch.from_numpy(mave_g).to(dev, dt)
        self.mstd = torch.from_numpy(mstd_g).to(dev, dt)
        self.valid = torch.from_numpy(valid_g).to(dev, dt)
        G = cfg.num_groups
        self.group_onehot = (self.groups[None, :] == torch.arange(
            G, device=dev)[:, None]).to(dt)                     # (G, m_loc)

        # mixture grids (BayesRRm.cpp:1004-1108) and priors
        mS = dataset.mS.astype(np.float32)
        cvai = np.zeros_like(mS)
        cvai[:, 1:] = 1.0 / mS[:, 1:]
        dirc = (dataset.d_priors if dataset.d_priors is not None
                else np.ones((G, K)))
        sp = (dataset.priors if dataset.priors is not None
              else np.full((G, 2), (V0G_DEFAULT, S02G_DEFAULT)))
        self.mtot_grp = np.bincount(dataset.groups, minlength=G)
        ind_mask = np.zeros(cfg.n_pad, dtype=np.float32)
        ind_mask[:cfg.n_real] = 1.0
        # covariates (n_pad, F), zero on pad individuals (the JAX layout,
        # bayesrrm.py:1279-1281)
        x_cov = np.zeros((cfg.n_pad, cfg.n_cov), dtype=np.float32)
        if cfg.n_cov:
            x_cov[:cfg.n_real] = dataset.X
        ind_mask, x_cov = self._local(ind_mask), self._local(x_cov)

        def put(a):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

        self.cva = put(mS)
        self.cvai = put(cvai)
        self.dirc = put(dirc)
        self.sigma_priors = put(sp)
        self.mtot = put(self.mtot_grp)
        self.ind_mask = put(ind_mask)
        self.x_cov = put(x_cov)
        self.dN = put(float(cfg.n_real))
        # the chunk's real individuals: the complete-data Gram's rank-1
        # correction is linear in them (the JAX n_real_loc, :852)
        self.dN_loc = put(float(ind_mask.sum()))
        self.dNm1 = put(float(cfg.n_real - 1))
        self.tiny = put(1e-30)

    def _check_memory(self, nb: int) -> None:
        """Refuse a run whose device arrays cannot fit before allocating
        them: packed bytes, the int8 planes (one byte per genotype), per-slot
        rows (twice on the per-window branch: the sweep-order copy; float64
        rows take 8 bytes a value), a float64 window's decoded rows and the
        largest sweep scratch (the exact sweep's batch of window Grams, the
        single-decode sweep's decoded rows), against the card's free memory
        (torch.cuda.mem_get_info)."""
        from hydra_tpu_torch.ops import _build

        cfg = self.cfg
        lib = _build.load()
        exact, complete = int(cfg.exact), int(cfg.complete)
        workspace = max(
            lib.hydra_sweep_workspace_bytes(cfg.m_loc, nb, cfg.window, exact),
            lib.hydra_window_workspace_bytes(nb, cfg.window, exact, complete),
            lib.hydra_sweep_sd_workspace_bytes(nb, cfg.window,
                                               cfg.sub_window))
        rows = 2 if cfg.per_window else 1
        f = 8 if cfg.dtype == "float64" else 4
        need = (2 * cfg.m_loc * nb      # packed rows + one copy while laid out
                + (cfg.m_loc * cfg.n_loc if cfg.planes else 0)
                + rows * cfg.m_loc * f * (mrow_width(cfg.k) + 16
                                          + cfg.num_groups)
                # float64: a window's decoded, standardized rows
                + (3 * cfg.window * cfg.n_loc * 8 if f == 8 else 0)
                + workspace + 8 * cfg.n_loc * f + (256 << 20))
        free, total = torch.cuda.mem_get_info(self.device)
        if need > free:
            raise MemoryError(
                f"BayesRRm needs ~{need / 1e9:.2f} GB on {self.device} "
                f"({cfg.m_loc} slots x {nb} packed bytes), "
                f"{free / 1e9:.2f} GB of {total / 1e9:.2f} GB are free")

    # ------------------------------------------------------------------
    def _gen(self, it: int, site: int) -> torch.Generator:
        return dist.site_generator(self.seed, it, site, self.device)

    def _sync(self):
        """The window's residual change summed over shards, or None on one
        shard (the whole sweep is then one call)."""
        return self._esum if self.cfg.n_dev > 1 else None

    def init_state(self) -> BayesRRmState:
        """init_from_scratch (BayesRRm.cpp:1224-1240, :1564-1584)."""
        cfg, dev = self.cfg, self.device
        y = center_and_scale(self.ds.y)
        eps = np.zeros(cfg.n_pad)
        eps[:cfg.n_real] = y
        sigma_e = float(np.sum(y * y) / cfg.n_real * 0.5)
        G, K = cfg.num_groups, cfg.k
        one = torch.ones(G, dtype=self.dt, device=dev)
        # sigmaG ~ Beta(1, 1) per group, empty groups zeroed (:1231-1240)
        sg = dist.beta_rng(self._gen(_INIT_ITERATION, _S_INIT_SIGMAG), one, one)
        sg = torch.where(self.mtot == 0, 0.0, sg)
        # priorPi: col0 = 0.5, the rest proportional to cVa (:1097-1107)
        mS = self.ds.mS
        pi0 = np.zeros((G, K))
        pi0[:, 0] = 0.5
        pi0[:, 1:] = 0.5 * mS[:, 1:] / mS[:, 1:].sum(axis=1, keepdims=True)
        if cfg.fh:
            # hyp_tau, tau and c_slab per group (:1354-1366), in that order
            # from one generator; lambda0 = sum(c_slab) / M (:1160-1161)
            g = self._gen(_INIT_ITERATION, _S_INIT_FH)

            def t(v):
                return torch.tensor(v, dtype=self.dt, device=dev)

            hyp_tau = dist.inv_gamma_rate_rng(g, t(0.5),
                                              t(1.0 / cfg.tau0 ** 2))
            tau = dist.inv_gamma_rate_rng(g, t(0.5 * cfg.v0t),
                                          cfg.v0t / hyp_tau)
            c_slab = dist.inv_scaled_chisq_rng(
                g, torch.full((G,), cfg.v0c, dtype=self.dt, device=dev),
                t(cfg.s02c))
            lam0 = c_slab.sum() / cfg.m_tot
        else:
            hyp_tau = tau = lam0 = torch.ones((), dtype=self.dt, device=dev)
            c_slab = torch.zeros(G, dtype=self.dt, device=dev)
        zeros = torch.zeros(cfg.m_loc, dtype=self.dt, device=dev)
        return BayesRRmState(
            lambda_var=lam0.expand(cfg.m_loc).clone(), nu_var=zeros.clone(),
            c_slab=c_slab, tau=tau, hyp_tau=hyp_tau,
            eps=torch.from_numpy(self._local(eps)).to(dev, self.dt),
            beta=zeros.clone(),
            components=torch.zeros(cfg.m_loc, dtype=torch.int32, device=dev),
            acum=zeros.clone(),
            mu=torch.zeros((), dtype=self.dt, device=dev),
            sigma_e=torch.tensor(sigma_e, dtype=self.dt, device=dev),
            sigma_g=sg.to(self.dt),
            est_pi=torch.as_tensor(pi0, dtype=self.dt, device=dev),
            gamma=torch.zeros(cfg.n_cov, dtype=self.dt, device=dev))

    def init_state_from_restart(self, rd) -> BayesRRmState:
        """The state saved at ``rd.iteration`` (init_from_restart,
        BayesRRm.cpp:842-928; the JAX sampler's :1401-1438): eps, beta and
        components into their slots, mu, sigmaE, sigmaG, pi, gamma and,
        for BayesFH, the state of ``.fh.npz``. The chain resumes at
        ``rd.start_iteration``."""
        cfg, dev = self.cfg, self.device
        st = self.init_state()
        local = shard_rows(self.slot_to_marker, cfg)
        sel = local >= 0
        marker = local[sel]

        def slots(values, fill, dt=None):
            out = np.full(cfg.m_loc, fill, dtype=np.float64)
            out[sel] = values[marker]
            return torch.as_tensor(out, dtype=dt or self.dt, device=dev)

        def t(v):
            return torch.as_tensor(np.asarray(v, np.float64), dtype=self.dt,
                                   device=dev)

        eps = np.zeros(cfg.n_pad)
        eps[:cfg.n_real] = rd.eps
        st.eps, st.mu = t(self._local(eps)), t(rd.mu)
        st.sigma_e = t(rd.sigma_e)
        st.beta = slots(rd.beta, 0.0)
        st.components = slots(rd.components, 0, torch.int32)
        st.sigma_g, st.est_pi = t(rd.sigma_g), t(rd.est_pi)
        if rd.gamma is not None and cfg.n_cov > 0:
            st.gamma = t(rd.gamma)
        if rd.fh_state is not None and cfg.fh:
            fs = rd.fh_state
            st.lambda_var = slots(fs["lambda_var"], 1.0)
            st.nu_var = slots(fs["nu_var"], 0.0)
            st.c_slab, st.tau = t(fs["c_slab"]), t(fs["tau"])
            st.hyp_tau = t(fs["hyp_tau"])
        return st

    # ------------------------------------------------------------------
    def sweep_order(self, it: int, noise: Optional[dict] = None
                    ) -> torch.Tensor:
        """Slots in the order sweep `it` visits them (int32)."""
        return sweep_order(self.cfg, self.seed, it, _S_PERM, self.device,
                           noise)

    def build_mrow(self, state: BayesRRmState, u: torch.Tensor,
                   nrm: torch.Tensor, active: torch.Tensor,
                   lamt: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Per-slot kernel rows (sweep_kernel.py:51-56 layout; the JAX
        sampler's :701-725). BayesFH passes each slot's shrunk variance
        ``lamt``, which replaces sigmaG * cVa for every component."""
        cfg = self.cfg
        tiny, dNm1 = self.tiny, self.dNm1
        grp = self.groups
        sigma_e, sigma_g = state.sigma_e, state.sigma_g
        log_pi = torch.log(torch.maximum(state.est_pi[grp], tiny))   # (m, K)
        if lamt is not None:
            shape = (cfg.m_loc, cfg.k - 1)
            denomk = (dNm1 + sigma_e / lamt)[:, None].expand(shape)
            log_detk = torch.log((lamt / sigma_e) * dNm1
                                 + 1.0)[:, None].expand(shape)
        else:
            safe_g = torch.maximum(sigma_g[grp], tiny)
            denomk = dNm1 + (sigma_e / safe_g)[:, None] * self.cvai[grp][:, 1:]
            log_detk = torch.log((sigma_g[grp] / sigma_e)[:, None] * dNm1
                                 * self.cva[grp][:, 1:] + 1.0)
        inv_denomk = 1.0 / denomk
        sd_k = torch.sqrt(sigma_e * inv_denomk)
        logl_static = torch.cat(
            [log_pi[:, :1], log_pi[:, 1:] - 0.5 * log_detk], dim=1)
        mrow = torch.cat(
            [self.mave[:, None], self.mstd[:, None], state.beta[:, None],
             u[:, None], nrm[:, None], active.to(self.dt)[:, None],
             logl_static, inv_denomk, sd_k], dim=1).contiguous()
        assert mrow.shape[1] == mrow_width(cfg.k)
        return mrow

    def window_sweep(self, eps: torch.Tensor, mrow: torch.Tensor,
                     order: torch.Tensor, i2se: torch.Tensor):
        """The per-window branch (the JAX ``window_body``, bayesrrm.py:
        293-661, with its kernels): per window, window_stats (or
        window_stats_planes) -> num0 = mstd (s1 - mave s2) + beta_old (N-1)
        -> the draw -> window_axpy (or window_axpy_planes, + sum(c2), times
        the individual mask). The rows are gathered into sweep order once,
        so each window reads contiguous slices; the genotype rows are read
        in place through the window's slots. Stale windows draw with the
        normalized ``stale_draw`` (the JAX ``draw_rows`` form), exact ones
        with ``window_gibbs`` (clamp at -60, unnormalized u*s, as the TPU
        kernel). On marker shards each window's residual change is summed
        over the ranks (the JAX ``hpsum``, bayesrrm.py:644), and exact
        windows with cross_sync < W draw through ``_cross_recurrence``.
        Nothing else syncs with the host. Returns (eps', out) with out
        (m_loc, 4) = [beta_new, comp, acum0, dbeta] per slot, as the
        whole-sweep kernels return it."""
        cfg = self.cfg
        W, K = cfg.window, cfg.k
        slots = order.to(torch.int64)
        rows_s = mrow[slots]                                    # (m_loc, C)
        mave_s, mstd_s, bold_s, u_s, nrm_s, act_s = (
            rows_s[:, i].contiguous() for i in range(N_FIXED))
        logl_s, invd_s, sd_s = (
            rows_s[:, a:a + n].contiguous() for a, n in (
                (N_FIXED, K), (N_FIXED + K, K - 1),
                (N_FIXED + 2 * K - 1, K - 1)))
        outs = []
        for w in range(cfg.n_windows):
            sl = slice(w * W, (w + 1) * W)
            rows = order[sl]
            mave, mstd, bold = mave_s[sl], mstd_s[sl], bold_s[sl]
            if cfg.planes:
                s1 = window_stats_planes(self.planes, eps, rows)
                s2, gram = eps.sum(), None
            else:
                s1, s2, gram = window_stats(self.packed, eps, mave, mstd,
                                            cfg.exact and not cfg.cross,
                                            cfg.complete, self.dN_loc, rows)
                if s2 is None:
                    # complete data: every marker's mask dot is sum(eps)
                    # (zero on pad individuals)
                    s2 = eps.sum()
                if cfg.n_ind > 1:
                    # the chunks' partial sums, between the stats and the
                    # draw (the JAX psum_i, bayesrrm.py:340-342)
                    s1, s2, gram = self._ind_pack(s1, s2.expand(W), gram)
            num0 = mstd * (s1 - mave * s2) + bold * self.dNm1
            if cfg.cross:
                bnew, comp, acum, dbeta = self._cross_recurrence(
                    self._cross_blocks(rows, mave, mstd), num0, rows_s[sl],
                    i2se).unbind(1)
            elif cfg.exact:
                dbeta, bnew, comp, acum = window_gibbs(
                    gram, num0, logl_s[sl], invd_s[sl], sd_s[sl], u_s[sl],
                    nrm_s[sl], act_s[sl], bold, i2se)
                comp = comp.to(self.dt)
            else:
                bnew, comp, acum, dbeta = stale_draw(rows_s[sl], num0, i2se,
                                                     K)
            c1 = dbeta * mstd
            c2 = -c1 * mave
            if cfg.planes:
                d_eps = ((window_axpy_planes(self.planes, c1, rows)
                          + c2.sum()) * self.ind_mask)
            elif cfg.complete:
                d_eps = ((window_axpy(self.packed, c1, c2, True, rows)
                          + c2.sum()) * self.ind_mask)
            else:
                d_eps = window_axpy(self.packed, c1, c2, False, rows)
            eps = eps + self._esum(d_eps)
            outs.append(torch.stack([bnew, comp, acum, dbeta], dim=1))
        out = torch.empty((cfg.m_loc, 4), dtype=self.dt, device=self.device)
        out[slots] = torch.cat(outs)
        return eps, out

    def window_sweep_f64(self, eps: torch.Tensor, mrow: torch.Tensor,
                         order: torch.Tensor, i2se: torch.Tensor):
        """The float64 branch (the JAX XLA ``window_body`` in float64,
        bayesrrm.py:293-661 without Pallas), plain torch: per window the
        standardized rows x~ (W, n_pad) in float64, num0 = x~ eps +
        beta_old (N-1), then the stale draw (``stale_draw``, the JAX
        ``draw_rows``) or, exact, the window Gram x~ x~^T and the
        sequential recurrence (the JAX ``marker_step``: each marker's
        ``draw_rows`` on num0 + corr, corr += dbeta_j Gram[:, j]), and
        eps += dbeta x~, summed over marker shards (cross_sync < W:
        ``_cross_recurrence`` on the shards' standardized rows). Returns
        (eps', out (m_loc, 4)) as window_sweep."""
        cfg = self.cfg
        W, K = cfg.window, cfg.k
        slots = order.to(torch.int64)
        rows_s = mrow[slots]
        outs = []
        for w in range(cfg.n_windows):
            sl = slice(w * W, (w + 1) * W)
            rows = rows_s[sl]
            xt = standardized_window(self.packed[slots[sl]], rows[:, 0],
                                     rows[:, 1], torch.float64)
            dot, gram = self._ind_pack(
                xt @ eps, xt @ xt.T if cfg.exact and not cfg.cross else None)
            num0 = dot + rows[:, 2] * self.dNm1
            if cfg.cross:
                outs.append(self._cross_recurrence(
                    self._cross_blocks(slots[sl], rows[:, 0], rows[:, 1], xt),
                    num0, rows, i2se))
                dbeta = outs[-1][:, 3]
            elif cfg.exact:
                outs.append(self._recurrence(gram, num0, rows, i2se))
                dbeta = outs[-1][:, 3]
            else:
                bnew, comp, acum, dbeta = stale_draw(rows, num0, i2se, K)
                outs.append(torch.stack([bnew, comp, acum, dbeta], dim=1))
            eps = eps + self._esum(dbeta @ xt)
        out = torch.empty((cfg.m_loc, 4), dtype=self.dt, device=self.device)
        out[slots] = torch.cat(outs)
        return eps, out

    def _cross_blocks(self, rows, mave, mstd, xt=None):
        """(D, W, W) Gram blocks of an exact window on marker shards:
        blocks[d, j, t] = x~_j (this shard) . x~_t (shard d's window), the
        JAX sampler's exchange (bayesrrm.py:443-536) as torch ops. Complete
        float32 data ships the ranks' packed rows (W, NB) and (mave, mstd,
        v = sum g) and rebuilds each block from the integer g Gram with the
        rank-1 standardization; otherwise (missing data, or the float64
        branch's ``xt``) the standardized rows. ``mesh.gather_rows``
        exchanges both exactly over the marker group. Every block is linear
        in the chunk's individuals (the rank-1 correction through the
        chunk's real count), so the chunks' blocks are summed over the
        individual group (the JAX ``corr_blk``, bayesrrm.py:452-466)."""
        cfg, grp = self.cfg, self.marker_group
        if xt is None and cfg.complete:
            pk = self.packed[rows.to(torch.int64)]
            g = decode_planes_hp(pk)[0]                         # (W, n_loc)
            v = g.sum(dim=1)
            pk_all = mesh.gather_rows(pk, grp)                  # (D, W, NB)
            st = mesh.gather_rows(torch.stack([mave, mstd, v]), grp)
            g_all = decode_planes_hp(pk_all.reshape(-1, pk.shape[1]))[0]
            gg = torch.einsum("wn,dvn->dwv", g,
                              g_all.reshape(cfg.n_dev, cfg.window, -1))
            ma, ms, vr = (st[:, i, None, :] for i in range(3))
            return self._isum((mstd[None, :, None] * ms) * (
                gg - ma * v[None, :, None] - mave[None, :, None] * vr
                + self.dN_loc * (mave[None, :, None] * ma)))
        if xt is None:
            xt = standardized_window(self.packed[rows.to(torch.int64)], mave,
                                     mstd, self.dt)
        return self._isum(torch.einsum("wn,dvn->dwv", xt,
                                       mesh.gather_rows(xt, grp)))

    def _cross_recurrence(self, blocks, num0, rows, i2se):
        """An exact window's recurrence on marker shards with cross_sync
        B < W (the JAX bayesrrm.py:558-609): marker j of every shard draws
        at the same step from num0_j + corr_j (``stale_draw``, the JAX
        ``draw_one``); its own shard's delta enters corr at once, the other
        shards' every B steps (one exchange of the B deltas, added through
        their blocks); B = 1 exchanges every step. Returns (W, 4) =
        [beta_new, comp, acum0, dbeta]."""
        cfg = self.cfg
        W, B, K = cfg.window, cfg.cross_sync, cfg.k
        own = blocks[cfg.rank]
        corr = torch.zeros_like(num0)
        res = []
        for b in range(W // B):
            dbs = []
            for j in range(b * B, (b + 1) * B):
                r = torch.cat(stale_draw(rows[j:j + 1],
                                         (num0[j] + corr[j])[None], i2se, K))
                res.append(r)
                dbs.append(r[3])
                if B > 1:
                    corr = corr + r[3] * own[:, j]
            db_b = torch.stack(dbs)                              # (B,)
            db_all = mesh.gather_rows(db_b, self.marker_group)   # (D, B)
            cols = blocks[:, :, b * B:(b + 1) * B]               # (D, W, B)
            cross = torch.einsum("dt,dwt->w", db_all, cols)
            corr = (corr + cross if B == 1
                    else corr + cross - own[:, b * B:(b + 1) * B] @ db_b)
        return torch.stack(res)

    def _recurrence(self, gram, num0, rows, i2se):
        """The float64 exact window's recurrence (``recurrence_f64``). On
        the card its W steps of small torch ops are captured once in a CUDA
        graph and replayed a window (the same kernels on copies of the
        window's inputs), which takes the host's per-op cost off the
        sequential chain."""
        if self.device.type != "cuda":
            return recurrence_f64(gram, num0, rows, i2se, self.cfg.k)
        if self._f64_graph is None:
            ins = [t.clone() for t in (gram, num0, rows, i2se)]
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):              # warm-up, as capture
                recurrence_f64(*ins, self.cfg.k)     # asks
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = recurrence_f64(*ins, self.cfg.k)
            self._f64_graph = (graph, ins, out)
        graph, ins, out = self._f64_graph
        for dst, src in zip(ins, (gram, num0, rows, i2se)):
            dst.copy_(src)
        graph.replay()
        return out.clone()

    def step(self, state: BayesRRmState, it: int,
             noise: Optional[dict] = None):
        """One Gibbs sweep. `noise` (tests) may supply the standard-normal
        draw of mu ("mu"), the per-slot "u"/"nrm", the "wperm"/"perm", the
        covariates' order "covperm" and normals "cov" (F,) and, for
        BayesFH, the standard gamma variates "g_nu"/"g_lam" (per slot) and
        "fh_gamma" (G, 3: hyp_tau, tau, c_slab)."""
        cfg, dev = self.cfg, self.device
        noise = noise or {}
        G, K = cfg.num_groups, cfg.k
        dN, dNm1, tiny = self.dN, self.dNm1, self.tiny

        # ---- mu update (BayesRRm.cpp:1675-1686) ----
        eps = state.eps + state.mu * self.ind_mask
        z = noise.get("mu")
        if z is None:
            z = torch.randn((), dtype=self.dt, device=dev,
                            generator=self._gen(it, _S_MU))
        mu = (self._isum(eps.sum()) / dN
              + torch.sqrt(state.sigma_e / dN) * z.to(dev))
        eps = eps - mu * self.ind_mask

        # ---- schedule and per-slot randomness ----
        order = self.sweep_order(it, noise)
        u = noise.get("u")
        if u is None:
            u = torch.rand(cfg.m_glob, dtype=self.dt, device=dev,
                           generator=self._gen(it, _S_UNIF))
        nrm = noise.get("nrm")
        if nrm is None:
            nrm = torch.randn(cfg.m_glob, dtype=self.dt, device=dev,
                              generator=self._gen(it, _S_NORM))
        u, nrm = shard_rows(u, cfg), shard_rows(nrm, cfg)
        # adaV: markers of zeroed groups are skipped (BayesRRm.cpp:1589-1597)
        active = ((state.sigma_g[self.groups] > 0.0) & (self.valid > 0.0)
                  & (self.mstd > 0.0))
        lamt = None
        if cfg.fh:
            # nu and the shrunk slab variance per slot (BayesRRm.cpp:1729-1730;
            # the JAX sampler's :278-285, :702-711)
            g_nu, g_lam = noise.get("g_nu"), noise.get("g_lam")
            if g_nu is None:
                shape = torch.full((cfg.m_glob,), 0.5 + 0.5 * cfg.v0L,
                                   dtype=self.dt, device=dev)
                g_nu = dist.gamma_rng(self._gen(it, _S_NU), shape)
                g_lam = dist.gamma_rng(self._gen(it, _S_LAM), shape)
            g_nu = shard_rows(g_nu.to(dev), cfg)
            g_lam = shard_rows(g_lam.to(dev), cfg)
            nu = (cfg.v0L / state.lambda_var + 1.0) / g_nu
            csl = state.c_slab[self.groups]
            lamt = torch.maximum(
                state.tau * csl / (state.tau + csl * state.lambda_var), tiny)
        mrow = self.build_mrow(state, u.to(dev), nrm.to(dev), active, lamt)

        # ---- every window, in sweep order: one whole-sweep call or the
        # per-window branch ----
        i2se = 0.5 / state.sigma_e
        if cfg.dtype == "float64":
            eps, out = self.window_sweep_f64(eps, mrow, order, i2se)
        elif cfg.per_window:
            eps, out = self.window_sweep(eps, mrow, order, i2se)
        else:
            kw = dict(window=cfg.window, n_mix=K, complete=cfg.complete,
                      ind_mask=self.ind_mask if cfg.complete else None,
                      order=order)
            if cfg.sub_window:
                eps, out = sweep_stale_sd(self.packed, eps.contiguous(), mrow,
                                          i2se, dNm1,
                                          sub_window=cfg.sub_window, **kw)
            else:
                sweep = sweep_exact if cfg.exact else sweep_stale
                eps, out = sweep(self.packed, eps.contiguous(), mrow, i2se,
                                 dNm1, sync=self._sync(), **kw)
        beta = out[:, 0].contiguous()
        comps = out[:, 1].to(torch.int32)
        acum = out[:, 2].contiguous()
        act = active.to(self.dt)
        # component counts over active markers (BayesRRm.cpp:1904): 0/1
        # weights, so the sums are exact integers in any order (and, unlike
        # bincount, index_add_ does not wait for the device)
        cass = self._sum(torch.zeros(G * K, dtype=self.dt, device=dev
                                     ).index_add_(
            0, self.groups * K + comps.to(torch.int64), act).reshape(G, K))
        # fixed-order per-group reductions (no float atomics), summed over
        # shards (BayesRRm.cpp:2515-2521)
        beta_sqn = self._sum(
            (self.group_onehot * (beta * beta)[None, :]).sum(dim=1))
        sum_abs_db = self._sum(out[:, 3].abs().sum())

        # ---- per-group hyper-parameter updates (BayesRRm.cpp:2525-2578) ----
        m0 = self.mtot - cass[:, 0]
        skip = (self.mtot == 0) | (m0 == 0) | (cass.sum(dim=1) == 0)
        fh_state = dict(lambda_var=state.lambda_var, nu_var=state.nu_var,
                        c_slab=state.c_slab, tau=state.tau,
                        hyp_tau=state.hyp_tau)
        if cfg.fh:
            # local shrinkage after beta (BayesRRm.cpp:1952), then the group
            # chain; sigmaG is the groups' sum of beta^2 (:2565)
            lam = (0.5 * beta * beta / state.tau + cfg.v0L / nu) / g_lam
            fh_state = self._fh_groups(it, noise, beta, lam, beta_sqn, m0,
                                       skip, state)
            fh_state.update(lambda_var=lam, nu_var=nu)
            sigma_g = torch.where(skip, 0.0, beta_sqn)
        else:
            v0g, s02g = self.sigma_priors[:, 0], self.sigma_priors[:, 1]
            sg_draw = dist.inv_scaled_chisq_rng(
                self._gen(it, _S_SIGMAG), v0g + m0,
                (beta_sqn * m0 + v0g * s02g) / torch.maximum(v0g + m0, tiny))
            sigma_g = torch.where(skip, 0.0, sg_draw)
        # pi | Dirichlet(cass + dirc) (:2576-2577); skipped groups keep theirs
        pi_draw = dist.dirichlet_rng(self._gen(it, _S_PI), cass + self.dirc)
        est_pi = torch.where(skip[:, None], state.est_pi, pi_draw)

        eps, gamma = self.cov_sweep(eps, state, it, noise)

        # ---- sigmaE (BayesRRm.cpp:2685-2690) ----
        e_sqn = self._isum((eps * eps).sum())
        sigma_e = dist.inv_scaled_chisq_rng(
            self._gen(it, _S_SIGMAE), V0E + dN,
            (e_sqn + V0E * S02E) / (V0E + dN))

        new = BayesRRmState(eps=eps, beta=beta, components=comps, acum=acum,
                            mu=mu, sigma_e=sigma_e, sigma_g=sigma_g,
                            est_pi=est_pi, gamma=gamma, **fh_state)
        return new, IterStats(m0=m0, cass=cass, beta_sqn=beta_sqn,
                              sum_abs_dbeta=sum_abs_db)

    def cov_sweep(self, eps: torch.Tensor, state: BayesRRmState, it: int,
                  noise: dict):
        """The fixed effects' ridge sweep (BayesRRm.cpp:2648-2681; the JAX
        sampler's :913-931): the F covariates in a random order, each
        gamma_j drawn from its normal full conditional given the residual
        with its own effect restored, under the sweep's incoming sigmaE.
        F dot products and axpys on the residual, plain torch (the JAX
        sampler runs them as a lax.scan of jnp.dot, outside any kernel).
        Returns (eps', gamma')."""
        cfg, dev = self.cfg, self.device
        F = cfg.n_cov
        if F == 0:
            return eps, state.gamma
        xi = noise.get("covperm")
        if xi is None:
            xi = torch.randperm(F, device=dev,
                                generator=self._gen(it, _S_COVPERM))
        z = noise.get("cov")
        if z is None:
            z = torch.randn(F, dtype=self.dt, device=dev,
                            generator=self._gen(it, _S_COV))
        xi, z = xi.to(dev, torch.int64), z.to(dev)
        sigma_e = state.sigma_e
        denom = self.dNm1 + sigma_e / S02F
        sd = torch.sqrt(sigma_e / denom)
        cols = self.x_cov[:, xi].T.contiguous()          # (F, n_loc), in order
        g = state.gamma[xi]
        out = []
        for i in range(F):
            col, g_old = cols[i], g[i]
            g_new = (self._isum(torch.dot(col, eps + g_old * col)) / denom
                     + z[i] * sd)
            eps = eps + (g_old - g_new) * col
            out.append(g_new)
        gamma = torch.empty_like(state.gamma)
        gamma[xi] = torch.stack(out)
        return eps, gamma

    def cov_order(self, it: int) -> np.ndarray:
        """The covariates' order at iteration ``it`` (the sweep's own
        permutation, re-drawn from its site), written to ``.xiv.0``; a
        restart never reads it."""
        return torch.randperm(self.cfg.n_cov, device=self.device,
                              generator=self._gen(it, _S_COVPERM)
                              ).cpu().numpy().astype(np.int32)

    def _fh_groups(self, it, noise, beta, lam, beta_sqn, m0, skip, state):
        """BayesFH's sequential per-group chain of hyp_tau, tau and c_slab
        (BayesRRm.cpp:2557-2562; the JAX sampler's :874-895); skipped groups
        keep their values. The standard gamma variates behind the three
        draws of each group come from ``noise["fh_gamma"]`` (G, 3) when the
        caller gives them, else from the sites _S_HTAU, _S_TAU, _S_CSLAB."""
        cfg, dev = self.cfg, self.device
        G = cfg.num_groups
        # sum of beta^2 / lambda over real markers (:875-876)
        scaled_bsqn = self._sum(torch.where(
            self.valid > 0, beta * beta / torch.clamp(lam, min=1e-30),
            0.0).sum())
        shapes = (torch.full_like(m0, 0.5 + 0.5 * cfg.v0t),
                  0.5 * (m0 + cfg.v0t), 0.5 * (cfg.v0c + m0))
        z = noise.get("fh_gamma")
        if z is None:
            z = torch.stack([dist.gamma_rng(self._gen(it, site), a)
                             for site, a in zip((_S_HTAU, _S_TAU, _S_CSLAB),
                                                shapes)], dim=1)
        z = z.to(dev)
        tau, hyp_tau, c_slab = state.tau, state.hyp_tau, []
        for g in range(G):
            # inv_gamma_rate_rng and inv_scaled_chisq_rng on the variates
            ht = 1.0 / (z[g, 0] * (1.0 / (1.0 / (cfg.tau0 * cfg.tau0)
                                          + 1.0 / tau)))
            t = 1.0 / (z[g, 1] * (1.0 / (cfg.v0t / ht + 0.5 * scaled_bsqn)))
            dof = cfg.v0c + m0[g]
            cs = 1.0 / (z[g, 2] * (1.0 / (0.5 * dof * (
                (beta_sqn[g] * m0[g] + cfg.v0c * cfg.s02c) / dof))))
            hyp_tau = torch.where(skip[g], hyp_tau, ht)
            tau = torch.where(skip[g], tau, t)
            c_slab.append(torch.where(skip[g], state.c_slab[g], cs))
        return dict(c_slab=torch.stack(c_slab), tau=tau, hyp_tau=hyp_tau)

    # ------------------------------------------------------------------
    def to_marker_order(self, flat: np.ndarray) -> np.ndarray:
        """Per-slot values of every shard (D m_loc,) -> reference marker
        order (Mtot,)."""
        out = np.zeros(self.cfg.m_tot, dtype=flat.dtype)
        sel = self.slot_to_marker >= 0
        out[self.slot_to_marker[sel]] = flat[sel]
        return out

    def beta_global(self, state: BayesRRmState) -> np.ndarray:
        """beta in marker order (a collective on marker shards)."""
        beta = self.gather_markers(state.beta)
        return self.to_marker_order(beta.cpu().numpy().astype(np.float64))

    def run(self, n_iterations: int, state: Optional[BayesRRmState] = None,
            start_iteration: int = 0, callback=None):
        """Plain chain loop; the runner adds the output cadence."""
        if state is None:
            state = self.init_state()
        stats = None
        for it in range(start_iteration, n_iterations):
            state, stats = self.step(state, it)
            if callback is not None:
                callback(it, state, stats)
        return state, stats
