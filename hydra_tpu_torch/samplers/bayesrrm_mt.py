"""Multi-trait BayesRRm on one device, on D marker shards, or on a
(markers x individuals) rank grid.

Port of ``hydra_tpu/samplers/bayesrrm_mt.py`` (``BayesRRmMT``; reference
BayesRRm_mt::runMpiGibbsMultiTraits, src/BayesRRm_mt.cpp:290-1426). T traits
share one genotype shard; each keeps its own residual column, mu, sigmaE,
sigmaG and pi per group, and beta column. Missing phenotypes are per-trait
NaN masks, not removals: a masked individual contributes nothing to that
trait's dot products, residual updates or statistics, and the marker
statistics are per (marker, trait) under the trait's mask.

The residual is (n_pad, T) in individual order, one column per trait (the
JAX ``MtState`` layout), held at 0 on pad individuals and on each trait's
NaN entries. A sweep is

  per-trait mu -> per-slot noise (m_loc, T) -> mrow -> one of three
  branches -> cass -> per-(trait, group) sigmaG and pi -> the covariates'
  per-trait ridge sweep -> per-trait sigmaE

with the branch chosen as the JAX sampler does (without its TPU gates),
where exact means ``exact`` and W > 1 (``exact_b``, bayesrrm_mt.py:696:
exact W = 1 is the stale sweep):

  stale                                     sweep_stale_mt
  exact, complete genotypes, no NaN trait    sweep_exact_mt (shared Gram)
  exact otherwise, or ``mega="off"``         per window (``window_sweep``):
      window_stats_mt -> exact: the window Gram (a plain matmul of decoded
      planes; (W, W) from trait 0's statistics when no phenotype is NaN,
      else T masked (T, W, W) Grams, bayesrrm_mt.py:137-184) ->
      mt_window_recurrence; stale: the draw from the frozen residual (torch
      ops, the JAX ``draw_rows``) -> window_axpy_mt

``schedule="auto"`` is block where the JAX sampler's whole-sweep kernels
host the sweep (W >= 8, ``mega`` not off, stale or exact with complete
genotypes and full phenotypes) and marker otherwise (bayesrrm_mt.py:
715-726), so the same flags take the same chain in both packages. The block
setup permutation and the RNG site ids are the JAX sampler's; ``step(...,
noise=...)`` takes the draws from the caller. The Gram is a float32 matmul:
on CUDA, TF32 must be off (``torch.backends.cuda.matmul.allow_tf32``; the
runner turns it off).

Marker shards (n_dev = D > 1, one ``torch.distributed`` rank a shard)
follow the JAX sampler on ``make_mesh(D)`` (``make_mesh(D, n_dcn=S)``
under ``n_dcn``) as the single-trait sampler's do: the slot layout of
``global_slots`` (every rank draws every shard's block permutation in shard
order, bayesrrm_mt.py:845-861), each shard's sweep order keyed by the shard
(:272-283), the per-(slot, trait) noise drawn over all D m_loc slots and
sliced at rank m_loc (:286-291), the masked statistics from the rank's own
``.bed`` rows, and the residual replicated: after every window each rank
adds the ranks' summed change (``mesh.residual_sum``: ``hier_sum`` under
n_dcn > 1, ``det_sum`` under det_sync), times the trait mask. ``schedule=
"auto"`` is marker. The branches at D > 1, as the JAX gates decide them
(:745-766, the TPU terms left out):
  - whole sweep, a window a launch (``sync``): W >= 8, mega not off, and
    stale, or exact on complete genotypes and full phenotypes with
    cross_sync >= W (the JAX ``use_wmega``);
  - per window (``window_sweep``) otherwise, the sum after each window's
    axpy; exact with cross_sync B < W draws with every shard's Gram blocks
    from the ranks' gathered rows (``_cross_blocks``) and exchanges the
    other shards' steps every B steps (``_cross_recurrence``, the JAX
    :391-456).
The component counts and sums of beta^2 are summed over ranks; the
hyper-parameter draws and the covariates' sweep are the same on every rank.

Chunks of individuals (n_ind = I > 1, ``--ind-shards``) follow the JAX
sampler on ``make_mesh(D I, n_ind=I)`` as BayesRRm's do (``OnGrid``): each
marker shard is held by the I ranks of its individual group, each with the
byte columns, residual (n_loc, T), trait mask and covariates of its chunk of
n_pad / I individuals, padded to a multiple of 512. The per-(marker, trait)
statistics come from the whole rows under the whole masks. The per-window
branch runs, marker schedule; the JAX ``psum_i`` points are sums over the
individual group in rank order (``mesh.ind_sum``, the same bits on every
rank of it): mu's residual sums, each window's s1, s2 and exact Gram in one
all_reduce (``_ind_pack``) before num0, the cross-shard Gram blocks, the
covariates' dot products and sigmaE's sums of squares. The residual's
change of a window and cass and beta^2 are summed over the marker group.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from hydra_tpu_torch.data.genotypes import (Dataset, chunk_columns,
                                            ind_chunk, marker_shards)
from hydra_tpu_torch.ops.decode import decode_planes_hp, hpack_bytes
from hydra_tpu_torch.ops.sweep_kernel_mt import (_blocks,
                                                 draw_normalized,
                                                 mt_mrow_width,
                                                 mt_window_recurrence,
                                                 sweep_exact_mt,
                                                 sweep_stale_mt)
from hydra_tpu_torch.ops.window_kernels import window_axpy_mt, window_stats_mt
from hydra_tpu_torch.parallel import mesh
from hydra_tpu_torch.samplers.bayesrrm import (S02E, S02F, S02G_DEFAULT,
                                               V0E, V0G_DEFAULT, OnGrid,
                                               global_slots, resolve_device,
                                               shard_rows, sweep_order)
from hydra_tpu_torch.utils import dist

f32 = torch.float32

# RNG site ids, as in the JAX sampler (hydra_tpu/samplers/bayesrrm_mt.py:57-59)
_S_MU, _S_UNIF, _S_NORM, _S_SIGMAG, _S_PI, _S_SIGMAE, _S_PERM = range(7)
_S_COV, _S_COVPERM = 7, 8
_S_INIT = 100
_INIT_ITERATION = -1     # init-time draws sit outside the chain's iterations


@dataclass(frozen=True)
class MtConfig:
    n_pad: int
    m_tot: int
    m_loc: int
    window: int
    k: int
    num_groups: int
    n_traits: int
    shuffle: bool
    schedule: str        # "block" | "marker"
    complete: bool       # no missing genotypes
    exact: bool          # exact and W > 1 (exact W = 1 is the stale sweep)
    full_pheno: bool     # no NaN phenotype: trait-shared statistics
    n_cov: int = 0       # covariates (fixed effects)
    per_window: bool = False   # the per-window branches (mega="off"; D > 1:
                               # W < 8 or an in-window exchange)
    n_dev: int = 1       # marker shards, one rank each
    rank: int = 0        # this rank's shard
    cross_sync: int = 0  # exact, D > 1: steps between exchanges (W: the
                         # window-boundary residual sum only)
    det_sync: bool = False     # rank-order sums, the same on any topology
    n_dcn: int = 1       # --dcn-slices: slices of the marker hierarchy
    n_ind: int = 1       # --ind-shards: chunks of individuals a shard
    n_loc: int = 0       # this rank's individuals (n_pad at I = 1)

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
class MtState:
    eps: torch.Tensor          # (n_loc, T), masked entries held at 0
    beta: torch.Tensor         # (m_loc, T) per slot
    components: torch.Tensor   # (m_loc, T) int32
    acum: torch.Tensor         # (m_loc, T) P(zero component)
    mu: torch.Tensor           # (T,)
    sigma_e: torch.Tensor      # (T,)
    sigma_g: torch.Tensor      # (T, G)
    est_pi: torch.Tensor       # (T, G, K)
    gamma: torch.Tensor        # (F, T) per-trait fixed effects


STATE_FIELDS = tuple(f.name for f in dataclasses.fields(MtState))


@dataclass
class MtStats:
    m0: torch.Tensor           # (T, G)
    cass: torch.Tensor         # (T, G, K)
    beta_sqn: torch.Tensor     # (T, G)


def state_from_numpy(x, device) -> MtState:
    """A state from numpy arrays: a JAX ``MtState`` converted with
    ``np.asarray`` per field, or a dict with the same field names."""
    get = x.get if isinstance(x, dict) else (lambda k: getattr(x, k))
    out = {}
    for name in STATE_FIELDS:
        dt = torch.int32 if name == "components" else f32
        out[name] = torch.as_tensor(np.array(get(name)), dtype=dt,
                                    device=device)
    return MtState(**out)


def state_to_numpy(state: MtState) -> dict:
    """Field name -> numpy array (the JAX state's names, shapes and dtypes)."""
    return {name: getattr(state, name).cpu().numpy() for name in STATE_FIELDS}


def scaled_phenotypes(phenos: np.ndarray):
    """Per-trait NaN masks and centred, scaled phenotypes
    (bayesrrm_mt.py:770-780; data.cpp:1495-1529 under the mask): returns
    (y, mask, nonas), y and mask (T, N) float64, y zero where masked."""
    mask = np.isfinite(phenos).astype(np.float64)
    y = np.where(mask > 0, phenos, 0.0)
    nonas = mask.sum(axis=1)
    mean = (y * mask).sum(axis=1) / nonas
    y = (y - mean[:, None]) * mask
    y = y * np.sqrt((nonas - 1) / (y * y).sum(axis=1))[:, None]
    return y, mask, nonas


def masked_marker_stats(packed: Union[np.ndarray, torch.Tensor], n: int,
                        mask: torch.Tensor, block_bytes: int = 1 << 27):
    """Per-(marker, trait) mean and 1/sd over the individuals each trait
    observes (BayesRRm_mt.cpp:604-665; bayesrrm_mt.py:782-810), in float64,
    a block of markers at a time on ``mask``'s device.

    packed: (M, NB) PLINK-coded numpy bytes (host data) or h-packed bytes
    already on the device. mask: (T, n) float64. Returns (mave, mstd), each
    (M, T) float64 on the device; markers with no variance under a mask
    get 0, 0. Blocks hold ~block_bytes per decoded float64 plane."""
    dev = mask.device
    m, nb = packed.shape
    blk = max(1, block_bytes // (32 * nb))       # 4*nb individuals x 8 bytes
    mt = mask.T.contiguous()                                       # (n, T)
    mave = torch.empty((m, mask.shape[0]), dtype=torch.float64, device=dev)
    mstd = torch.empty_like(mave)
    for r0 in range(0, m, blk):
        rows = packed[r0:r0 + blk]
        if isinstance(rows, np.ndarray):
            rows = torch.from_numpy(hpack_bytes(rows))
        g, mk = decode_planes_hp(rows.to(dev), torch.float64)
        g, mk = g[:, :n], mk[:, :n]
        cnt = mk @ mt
        s = g @ mt                      # g is 0 where missing
        sq = (g * g) @ mt
        ave = s / torch.clamp(cnt, min=1.0)
        var = sq - 2.0 * ave * s + ave * ave * cnt
        sd = torch.sqrt(torch.clamp(cnt - 1.0, min=1.0) / var)
        bad = ~torch.isfinite(sd)
        mave[r0:r0 + blk] = torch.where(bad, 0.0, ave)
        mstd[r0:r0 + blk] = torch.where(bad, 0.0, sd)
    return mave, mstd


def gram_chunks(n_pad: int) -> int:
    """Chunks S of whole 512-individual blocks that the window Gram's long
    axis is cut into (``BayesRRmMT.window_gram``)."""
    blocks = n_pad // 512 if n_pad % 512 == 0 else 1
    return max(d for d in (16, 14, 8, 7, 4, 2, 1) if blocks % d == 0)


class BayesRRmMT(OnGrid):
    """Data layout, state init and the multi-trait Gibbs sweep of one
    device, marker shard or rank of the grid."""

    def __init__(self, dataset: Dataset, phenos: np.ndarray, *, window: int,
                 exact: bool = True, shuffle: bool = True, seed: int = 0,
                 schedule: str = "auto", mega: str = "auto", device="cuda",
                 packed_device: Optional[torch.Tensor] = None,
                 n_dev: int = 1, rank: int = 0, cross_sync: int = 0,
                 det_sync: bool = False, n_dcn: int = 1, n_ind: int = 1):
        """phenos: (T, N) raw phenotypes with NaN for missing. mega: "off"
        takes the per-window branches ("auto"/"on": the whole-sweep
        kernels where the JAX sampler's run). packed_device: the genotypes
        already h-packed on the device, (M, NB) uint8 in marker order, for
        data generated there; then ``dataset.geno`` supplies only n, n_pad
        and the marker statistics. n_dev > 1: this rank's shard ``rank`` of
        n_dev, under a process group of n_dev ranks (``dataset.geno`` may
        hold this shard's rows alone, from ``marker_offset``); cross_sync
        (exact): steps between the cross-shard exchanges, 0 = the window;
        det_sync: rank-order sums (``mesh.det_sum``); n_dcn: the slices of
        ``--dcn-slices`` (the residual's change summed by ``hier_sum``);
        n_ind: the chunks of individuals of ``--ind-shards``, one rank each
        (n_dev n_ind ranks, this rank's chunk its rank modulo n_ind)."""
        self.ds = dataset
        self.seed = int(seed)
        self.device = dev = (device if isinstance(device, torch.device)
                             else resolve_device(device))
        geno = dataset.geno
        T, n = phenos.shape
        K = int(dataset.mS.shape[1])
        if n != geno.n:
            raise ValueError("phenotype matrix does not match genotype N")
        if window < 1:
            raise ValueError(f"--window {window} is below 1")
        if schedule not in ("auto", "marker", "block"):
            raise ValueError(f"schedule must be auto/marker/block, "
                             f"got {schedule!r}")
        if mega not in ("auto", "on", "off"):
            raise ValueError(f"mega must be auto/on/off, got {mega!r}")
        complete = bool(geno.nm_global_sum == 0)
        full_ph = bool(np.isfinite(phenos).all())
        shared_gram = complete and full_ph
        n_dev, rank, n_ind = int(n_dev), int(rank), int(n_ind)
        # exact with W = 1 is the plain sequential schedule: the stale
        # sweep of one-marker windows (bayesrrm_mt.py:694-696)
        exact = exact and window > 1
        # cross-shard exchange interval (the JAX rule, bayesrrm_mt.py:697-701)
        cs = min(cross_sync, window) if cross_sync > 0 else window
        if exact and cs < window and window % cs:
            raise ValueError(f"--cross-sync {cs} must divide the window "
                             f"({window})")
        # D > 1: the whole-sweep kernels a window a launch where the JAX
        # use_wmega runs them (W >= 8, no in-window exchange), else the
        # per-window branch; chunks of individuals take the per-window
        # branch (the JAX use_mega and use_wmega need n_ind = 1,
        # bayesrrm_mt.py:745-763)
        per_window = (mega == "off" or n_ind > 1
                      or (n_dev > 1 and (window < 8
                                         or (exact and cs < window))))
        if schedule == "auto":
            schedule = ("block" if (window >= 8 and mega != "off"
                                    and (not exact or shared_gram)
                                    and n_dev == 1 and n_ind == 1)
                        else "marker")
            if schedule == "block":
                print("INFO   : mt block schedule (whole-sweep kernel streams "
                      "windows in place; --schedule marker restores the "
                      "per-sweep marker shuffle"
                      + (" and window-invariant exact chains" if exact
                         else "") + ")", flush=True)
        elif schedule == "block" and exact:
            print("INFO   : mt exact mode with --schedule block: exact "
                  "sequential-Gibbs semantics preserved; the window-width "
                  "invariance is waived (scan order depends on the window "
                  "partition)", flush=True)
        starts, lengths, m_loc = marker_shards(geno.m_global, n_dev, rank,
                                               window, dataset.blocks, n_ind)
        # this rank's chunk of individuals (n_loc, the whole n_pad at I = 1)
        # and the groups it sums over
        _, n_loc = ind_chunk(geno.n_pad, n_ind)
        chunk = self._join_grid(n_dcn, n_ind, rank)
        self.cfg = cfg = MtConfig(
            n_pad=geno.n_pad, m_tot=geno.m_global, m_loc=m_loc, window=window,
            k=K, num_groups=dataset.num_groups, n_traits=T, shuffle=shuffle,
            schedule=schedule, complete=complete, exact=exact,
            full_pheno=full_ph,
            n_cov=0 if dataset.X is None else int(dataset.X.shape[1]),
            per_window=per_window, n_dev=n_dev, rank=rank, cross_sync=cs,
            det_sync=bool(det_sync), n_dcn=int(n_dcn), n_ind=n_ind,
            n_loc=n_loc)
        # sums over the marker shards (the JAX ma_sum), of the residual's
        # change (its hpsum) and over the chunks of individuals (psum_i)
        self._sum = functools.partial(mesh.shard_sum, n_dev=n_dev,
                                      det=bool(det_sync),
                                      group=self.marker_group)
        self._esum = mesh.residual_sum(n_dev, bool(det_sync), int(n_dcn),
                                       n_ind)
        self._isum = functools.partial(mesh.ind_sum, grid=self.grid)
        nb = n_loc // 4
        if dev.type == "cuda":
            self._check_memory(nb)

        # masks and per-trait centred/scaled phenotypes
        self._y, mask, self._nonas = scaled_phenotypes(phenos)

        # per-(marker, trait) masked statistics of this shard's whole rows
        # under the whole masks (before a rank keeps its chunk's columns);
        # full phenotypes take the genotype statistics every trait shares
        s, ln = int(starts[rank]), int(lengths[rank])
        ls = s - geno.marker_offset          # this shard's rows in geno
        if full_ph:
            mave = np.tile(geno.mave[ls:ls + ln, None], (1, T))
            mstd = np.tile(geno.mstd[ls:ls + ln, None], (1, T))
        else:
            src = (geno.packed if packed_device is None
                   else packed_device)[ls:ls + ln]
            mv, ms = masked_marker_stats(
                src, n, torch.as_tensor(mask, dtype=torch.float64,
                                        device=dev))
            mave, mstd = mv.cpu().numpy(), ms.cpu().numpy()

        # ---- slot layout: slot = marker, then the block setup permutation
        # (every shard's slot_to_marker, the JAX sampler's stream,
        # bayesrrm_mt.py:845-861; this shard's rows and statistics)
        self.slot_to_marker, perms = global_slots(starts, lengths, m_loc,
                                                  schedule, self.seed)
        p = perms[rank]
        groups_g = np.zeros(m_loc, dtype=np.int32)
        mave_g = np.zeros((m_loc, T), dtype=np.float32)
        mstd_g = np.zeros((m_loc, T), dtype=np.float32)
        valid_g = np.zeros(m_loc, dtype=np.float32)
        mave_g[:ln] = mave
        mstd_g[:ln] = mstd
        groups_g[:ln] = dataset.groups[s:s + ln]
        valid_g[:ln] = 1.0
        groups_g, mave_g, mstd_g = groups_g[p], mave_g[p], mstd_g[p]
        valid_g = valid_g[p]

        # the rows' byte columns of this rank's chunk
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

        def put(a, dt=f32):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

        G = cfg.num_groups
        self.groups = put(groups_g, torch.int64)
        self.mave = put(mave_g)
        self.mstd = put(mstd_g)
        self.valid = put(valid_g)
        self.group_onehot = (self.groups[None, :] == torch.arange(
            G, device=dev)[:, None]).to(f32)                    # (G, m_loc)
        mS = dataset.mS.astype(np.float32)
        cvai = np.zeros_like(mS)
        cvai[:, 1:] = 1.0 / mS[:, 1:]
        self.cva = put(mS)
        self.cvai = put(cvai)
        self.mtot_grp = np.bincount(dataset.groups, minlength=G)
        self.mtot = put(self.mtot_grp)
        tm = np.zeros((cfg.n_pad, T), dtype=np.float32)
        tm[:n] = mask.T
        # covariates (n_pad, F), full N: each trait's NaN mask applies in
        # the sweep (bayesrrm_mt.py:893-898); both of this rank's chunk
        x_cov = np.zeros((cfg.n_pad, cfg.n_cov), dtype=np.float32)
        if cfg.n_cov:
            x_cov[:n] = dataset.X
        tm, x_cov = self._local(tm), self._local(x_cov)
        self.trait_mask = put(tm)
        self.x_cov = put(x_cov)
        self.gram_chunks = S = gram_chunks(n_loc)
        self.trait_mask_chunks = self.trait_mask.T.contiguous().view(
            T, S, 1, n_loc // S)
        self.dN = put(self._nonas)
        # the chunk's individuals of trait 0: the complete-data cross
        # blocks' rank-1 correction is linear in them (the JAX n_loc,
        # bayesrrm_mt.py:145)
        self.dN_loc = put(float(tm[:, 0].sum()))
        self.dNm1 = self.dN - 1.0
        self.tiny = put(1e-30)

    def _check_memory(self, nb: int) -> None:
        """Refuse a run whose device arrays cannot fit before allocating
        them: packed bytes (twice while laid out), per-slot rows and the
        residual-sized buffers, the window Gram scratch and the decoded
        planes of one window's Gram (torch.cuda.mem_get_info)."""
        from hydra_tpu_torch.ops import _build

        cfg = self.cfg
        T, W = cfg.n_traits, cfg.window
        workspace = _build.load("sweep_kernel_mt.cu").hydra_mt_workspace_bytes(
            cfg.m_loc, nb, W, T, int(cfg.exact))
        need = (2 * cfg.m_loc * nb
                + cfg.m_loc * 4 * (mt_mrow_width(cfg.k, T) + 8 * T
                                   + cfg.num_groups)
                + workspace + 16 * cfg.n_loc * T * 4
                + 3 * T * W * cfg.n_loc * 4 + (256 << 20))
        free, total = torch.cuda.mem_get_info(self.device)
        if need > free:
            raise MemoryError(
                f"BayesRRmMT needs ~{need / 1e9:.2f} GB on {self.device} "
                f"({cfg.m_loc} slots x {nb} packed bytes, {T} traits), "
                f"{free / 1e9:.2f} GB of {total / 1e9:.2f} GB are free")

    # ------------------------------------------------------------------
    def _gen(self, it: int, site: int) -> torch.Generator:
        return dist.site_generator(self.seed, it, site, self.device)

    def init_state(self) -> MtState:
        """bayesrrm_mt.py:926-957: eps = the scaled phenotypes (this rank's
        chunk of them), sigmaE half their variance, sigmaG ~ Beta(1, 1) per
        (trait, group), pi with column 0 = 0.5 and the rest proportional to
        the variances."""
        cfg, dev = self.cfg, self.device
        T, G, K = cfg.n_traits, cfg.num_groups, cfg.k
        eps = np.zeros((cfg.n_pad, T), dtype=np.float32)
        eps[:self.ds.geno.n] = self._y.T
        sigma_e = (self._y ** 2).sum(axis=1) / self._nonas * 0.5
        one = torch.ones((T, G), dtype=f32, device=dev)
        sg = dist.beta_rng(self._gen(_INIT_ITERATION, _S_INIT), one, one)
        mS = self.ds.mS
        pi0 = np.zeros((T, G, K))
        pi0[:, :, 0] = 0.5
        pi0[:, :, 1:] = 0.5 * (mS[:, 1:] / mS[:, 1:].sum(
            axis=1, keepdims=True))[None, :, :]
        zeros = torch.zeros((cfg.m_loc, T), dtype=f32, device=dev)
        return MtState(
            eps=torch.from_numpy(self._local(eps)).to(dev),
            beta=zeros.clone(),
            components=torch.zeros((cfg.m_loc, T), dtype=torch.int32,
                                   device=dev),
            acum=zeros.clone(),
            mu=torch.zeros(T, dtype=f32, device=dev),
            sigma_e=torch.as_tensor(sigma_e, dtype=f32, device=dev),
            sigma_g=sg.to(f32),
            est_pi=torch.as_tensor(pi0, dtype=f32, device=dev),
            gamma=torch.zeros((cfg.n_cov, T), dtype=f32, device=dev))

    def init_state_from_restart(self, rds) -> MtState:
        """The state saved at ``rds[t].iteration`` by every trait t's
        files: the per-trait rebuild of the JAX runner
        (hydra_tpu/runner.py:190-232). Each trait's residual column,
        beta and components columns (into their slots), mu, sigmaE,
        sigmaG, pi and, when every trait's files hold it, gamma (F, T);
        the JAX runner reads the trait files without their covariate dumps
        there and so never restores gamma, the port does. Each rank keeps
        its chunk of the residual. The chain resumes at
        ``rds[0].start_iteration``."""
        cfg, dev = self.cfg, self.device
        st = self.init_state()
        local = shard_rows(self.slot_to_marker, cfg)
        sel = local >= 0
        marker = local[sel]
        T, n = cfg.n_traits, self.ds.geno.n
        eps = np.zeros((cfg.n_pad, T), np.float32)
        beta = np.zeros((cfg.m_loc, T), np.float32)
        comps = np.zeros((cfg.m_loc, T), np.int32)
        for t, rd in enumerate(rds):
            eps[:n, t] = rd.eps
            beta[sel, t] = rd.beta[marker]
            comps[sel, t] = rd.components[marker]
        out = dict(eps=self._local(eps), beta=beta, components=comps,
                   mu=np.array([rd.mu for rd in rds], np.float32),
                   sigma_e=np.array([rd.sigma_e for rd in rds], np.float32),
                   sigma_g=np.stack([rd.sigma_g for rd in rds]).astype(
                       np.float32),
                   est_pi=np.stack([rd.est_pi for rd in rds]).astype(
                       np.float32))
        if cfg.n_cov > 0 and all(rd.gamma is not None for rd in rds):
            out["gamma"] = np.stack([rd.gamma for rd in rds],
                                    axis=1).astype(np.float32)
        for name, v in out.items():
            setattr(st, name, torch.as_tensor(
                v, dtype=torch.int32 if name == "components" else f32,
                device=dev))
        return st

    # ------------------------------------------------------------------
    def sweep_order(self, it: int, noise: Optional[dict] = None
                    ) -> torch.Tensor:
        """Slots in the order sweep `it` visits them (int32)."""
        return sweep_order(self.cfg, self.seed, it, _S_PERM, self.device,
                           noise)

    def active(self, state: MtState) -> torch.Tensor:
        """(m_loc, T): sigma_g[t, group] > 0, a real slot, mstd > 0
        (bayesrrm_mt.py:293)."""
        return ((state.sigma_g.T[self.groups] > 0.0)
                & (self.valid[:, None] > 0.0) & (self.mstd > 0.0))

    def build_mrow(self, state: MtState, u: torch.Tensor, nrm: torch.Tensor,
                   active: torch.Tensor) -> torch.Tensor:
        """Per-slot kernel rows (sweep_kernel_mt.py:47-56 layout; the JAX
        sampler's :526-546)."""
        cfg = self.cfg
        grp = self.groups
        sigma_e = state.sigma_e                                  # (T,)
        sig_g = state.sigma_g.T[grp]                             # (m, T)
        cva = self.cva[grp][:, None, 1:]                         # (m, 1, K-1)
        cvai = self.cvai[grp][:, None, 1:]
        log_pi = torch.log(torch.maximum(
            state.est_pi.permute(1, 0, 2)[grp], self.tiny))      # (m, T, K)
        safe_g = torch.maximum(sig_g, self.tiny)[:, :, None]
        denomk = (self.dNm1[None, :, None]
                  + (sigma_e[None, :, None] / safe_g) * cvai)
        inv_denomk = 1.0 / denomk                                # (m, T, K-1)
        sd_k = torch.sqrt(sigma_e[None, :, None] * inv_denomk)
        log_detk = torch.log((sig_g[:, :, None] / sigma_e[None, :, None])
                             * self.dNm1[None, :, None] * cva + 1.0)
        logl_static = torch.cat([log_pi[:, :, :1],
                                 log_pi[:, :, 1:] - 0.5 * log_detk], dim=2)
        mrow = torch.cat(
            [self.mave, self.mstd, state.beta, u, nrm, active.to(f32),
             logl_static.transpose(1, 2).reshape(cfg.m_loc, -1),
             inv_denomk.transpose(1, 2).reshape(cfg.m_loc, -1),
             sd_k.transpose(1, 2).reshape(cfg.m_loc, -1)],
            dim=1).contiguous()
        assert mrow.shape[1] == mt_mrow_width(cfg.k, cfg.n_traits)
        return mrow

    def window_gram(self, slots: torch.Tensor, mave_w: torch.Tensor,
                    mstd_w: torch.Tensor) -> torch.Tensor:
        """The standardized Gram of one window (bayesrrm_mt.py:137-184,
        local_only): (W, W) from trait 0's statistics when no phenotype is
        NaN, else (T, W, W) Grams xm_t . x~_t^T under each trait's mask.

        The individual axis is cut into S chunks and the S partial Grams
        come from one batched matmul, summed in order: a (W, n) x (n, W)
        product per trait has too few output tiles to fill the card
        (measured 1.48 ms per window at T=4, W=128, N=50,000 on an H100
        80GB HBM3, 700 W, chip_smoke.py)."""
        cfg = self.cfg
        W, n, S = slots.shape[0], cfg.n_loc, self.gram_chunks
        g, m = decode_planes_hp(self.packed[slots])               # (W, n_loc)
        g, m = (x.view(W, S, n // S).transpose(0, 1).contiguous()
                for x in (g, m))                                  # (S, W, n/S)
        if cfg.full_pheno:
            xt = (g - mave_w[:, :1] * m) * mstd_w[:, :1]
            return torch.bmm(xt, xt.transpose(1, 2)).sum(dim=0)
        T = cfg.n_traits
        # contiguous (T, W) statistics keep every product in (T, S, W, n/S)
        # order, so the reshapes below are views
        mave_t, mstd_t = (x.T.contiguous()[:, None, :, None]
                          for x in (mave_w, mstd_w))
        xt = (g[None] - mave_t * m[None]) * mstd_t                # (T, S, W, n/S)
        xm = xt * self.trait_mask_chunks
        return torch.bmm(xm.reshape(T * S, W, -1),
                         xt.reshape(T * S, W, -1).transpose(1, 2)
                         ).reshape(T, S, W, W).sum(dim=1)

    def window_sweep(self, eps: torch.Tensor, mrow: torch.Tensor,
                     order: torch.Tensor, i2se: torch.Tensor):
        """The per-window path (the JAX ``window_body``, bayesrrm_mt.py:
        298-492, with its Pallas window kernels), per window: stats ->
        num0 -> the draw -> axpy. Exact: the Gram and the recurrence;
        stale: every (marker, trait) drawn from the frozen residual (torch
        ops: ``draw_normalized``, the JAX ``draw_rows``). On marker shards
        each window's change is summed over the ranks before the trait
        mask (the JAX ``hpsum(d_eps) * tm_t``, bayesrrm_mt.py:474, 478), and
        exact windows with cross_sync < W draw through
        ``_cross_recurrence`` on every shard's Gram blocks. On chunks of
        individuals the chunk's s1, s2 and Gram are summed over the
        individual group in one all_reduce between the statistics and the
        draw (the JAX ``psum_i``, bayesrrm_mt.py:323-327). Returns (eps',
        out (m_loc, 3T))."""
        cfg = self.cfg
        W, T = cfg.window, cfg.n_traits
        out = torch.zeros((cfg.m_loc, 3 * T), dtype=f32, device=self.device)
        for w in range(cfg.n_windows):
            rows = order[w * W:(w + 1) * W]
            slots = rows.to(torch.int64)
            s1, s2 = window_stats_mt(self.packed, eps, cfg.complete,
                                     rows=rows)
            if s2 is None:
                # complete genotypes: the mask dot is the per-trait sum(eps)
                s2 = eps.sum(dim=0)[None, :]
            # one gather of the window's rows: (W, 3K+4, T) column blocks
            b = _blocks(mrow[slots], T)
            mave_w, mstd_w, bold = b[:, 0], b[:, 1], b[:, 2]
            gram = (self.window_gram(slots, mave_w, mstd_w)
                    if cfg.exact and not cfg.cross else None)
            s1, s2, gram = self._ind_pack(s1, s2, gram)
            num0 = mstd_w * (s1 - mave_w * s2) + bold * self.dNm1
            if cfg.cross:
                bnew, comp, acum, db = self._cross_recurrence(
                    self._cross_blocks(slots, mave_w, mstd_w), num0, b, i2se)
            elif cfg.exact:
                bnew, comp, acum, db = mt_window_recurrence(
                    gram, num0.contiguous(), mrow, i2se, n_mix=cfg.k,
                    rows=rows)
            else:
                bnew, comp, acum = draw_normalized(b, num0, i2se, cfg.k)
                db = bold - bnew
            c1 = (db * mstd_w).T.contiguous()                        # (T, W)
            c2 = -(c1 * mave_w.T)
            d_eps = window_axpy_mt(self.packed, c1, c2, cfg.complete,
                                   rows=rows)
            if cfg.complete:
                d_eps = d_eps + c2.sum(dim=1)[None, :]
            eps = eps + self._esum(d_eps) * self.trait_mask
            out[slots] = torch.cat([bnew, comp, acum], dim=1)
        return eps, out

    def _cross_blocks(self, slots, mave_w, mstd_w):
        """Every shard's Gram blocks of an exact window (the JAX
        ``_mt_gram_blocks``, bayesrrm_mt.py:118-214, as torch ops):
        blocks[d, j, k] = x~_j (this shard) . x~_k (shard d's window) with
        full phenotypes, (D, W, W); blocks[d, t, j, k] under trait t's
        mask and statistics with NaN phenotypes, (D, T, W, W). The ranks'
        packed rows (W, NB) and statistics rows (W, 2T) are gathered
        over the marker group (``mesh.gather_rows``, exact) and each
        shard's block rebuilt here: complete genotypes with full phenotypes
        from the integer Gram and the rank-1 standardization (through the
        chunk's individual count), otherwise from the standardized rows.
        Every block is linear in the chunk's individuals, so the blocks are
        summed over the individual group (the JAX ``psum_i`` in ``blk``).
        The JAX sampler passes the rows round a ring (a gather under dcn);
        both give the same blocks within the sweep tolerances."""
        cfg, grp = self.cfg, self.marker_group
        T = cfg.n_traits
        pk = self.packed[slots]
        g, m = decode_planes_hp(pk)                              # (W, n_loc)
        pk_all = mesh.gather_rows(pk, grp)                       # (D, W, NB)
        st_all = mesh.gather_rows(torch.cat([mave_w, mstd_w], dim=1), grp)
        ma0, ms0 = mave_w[:, 0], mstd_w[:, 0]
        if cfg.full_pheno:
            if cfg.complete:
                v = g.sum(dim=1)
            else:
                xt = (g - ma0[:, None] * m) * ms0[:, None]
        else:
            xt = ((g[None] - mave_w.T[:, :, None] * m[None])
                  * mstd_w.T[:, :, None])                        # (T, W, n)
            xm = xt * self.trait_mask.T[:, None, :]
        blocks = []
        for d in range(cfg.n_dev):
            g_d, m_d = decode_planes_hp(pk_all[d])
            ma_d, ms_d = st_all[d, :, 0], st_all[d, :, T]
            if cfg.full_pheno and cfg.complete:
                blocks.append((ms0[:, None] * ms_d[None, :]) * (
                    g @ g_d.T - ma_d[None, :] * v[:, None]
                    - ma0[:, None] * g_d.sum(dim=1)[None, :]
                    + self.dN_loc * (ma0[:, None] * ma_d[None, :])))
            elif cfg.full_pheno:
                blocks.append(xt @ ((g_d - ma_d[:, None] * m_d)
                                    * ms_d[:, None]).T)
            else:
                ma_t, ms_t = st_all[d, :, :T].T, st_all[d, :, T:].T
                xt_d = ((g_d[None] - ma_t[:, :, None] * m_d[None])
                        * ms_t[:, :, None])
                blocks.append(torch.bmm(xm, xt_d.transpose(1, 2)))
        return self._isum(torch.stack(blocks))

    def _cross_recurrence(self, blocks, num0, b, i2se):
        """An exact window's recurrence on marker shards with cross_sync
        B < W (the JAX bayesrrm_mt.py:391-456): marker j of every shard
        draws at the same step from num0_j + corr_j (``draw_normalized``,
        the JAX ``draw_rows``); its own shard's (T,) delta enters corr at
        once, the other shards' every B steps (one gather of the (B, T)
        deltas, added through their blocks); B = 1 gathers every step.
        b is the window's (W, 3K+4, T) column blocks. Returns (beta_new,
        comp, acum, dbeta), each (W, T)."""
        cfg = self.cfg
        W, B = cfg.window, cfg.cross_sync
        shared = blocks.dim() == 3
        own = blocks[cfg.rank]                          # (W, W) or (T, W, W)

        def col(x, j):                                   # (W, 1) or (W, T)
            return x[:, j:j + 1] if shared else x[:, :, j].T

        corr = torch.zeros_like(num0)
        res = []
        for bi in range(W // B):
            dbs = []
            for j in range(bi * B, (bi + 1) * B):
                bnew, comp, acum = draw_normalized(b[j], num0[j] + corr[j],
                                                   i2se, cfg.k)
                db = b[j, 2] - bnew
                res.append(torch.stack([bnew, comp, acum, db]))
                dbs.append(db)
                if B > 1:
                    corr = corr + col(own, j) * db[None, :]
            db_b = torch.stack(dbs)                                # (B, T)
            db_all = mesh.gather_rows(db_b, self.marker_group)     # (D, B, T)
            cols = slice(bi * B, (bi + 1) * B)
            if shared:
                cross = torch.einsum("dst,dws->wt", db_all,
                                     blocks[:, :, cols])
                own_c = torch.einsum("st,ws->wt", db_b, own[:, cols])
            else:
                cross = torch.einsum("dst,dtws->wt", db_all,
                                     blocks[:, :, :, cols])
                own_c = torch.einsum("st,tws->wt", db_b, own[:, :, cols])
            corr = corr + cross if B == 1 else corr + cross - own_c
        res = torch.stack(res, dim=1)                            # (4, W, T)
        return res[0], res[1], res[2], res[3]

    def step(self, state: MtState, it: int, noise: Optional[dict] = None):
        """One Gibbs sweep. `noise` (tests) may supply the standard-normal
        draws of mu ("mu", (T,)), the per-slot "u"/"nrm" (m_loc, T), the
        "wperm"/"perm", and the covariates' order "covperm" (F,) and
        normals "cov" (F, T)."""
        cfg, dev = self.cfg, self.device
        noise = noise or {}
        T, G, K = cfg.n_traits, cfg.num_groups, cfg.k
        dN, tm, tiny = self.dN, self.trait_mask, self.tiny

        # ---- per-trait mu (bayesrrm_mt.py:266-270) ----
        eps = state.eps + state.mu[None, :] * tm
        z = noise.get("mu")
        if z is None:
            z = torch.randn(T, dtype=f32, device=dev,
                            generator=self._gen(it, _S_MU))
        mu = (self._isum(eps.sum(dim=0)) / dN
              + torch.sqrt(state.sigma_e / dN) * z.to(dev))
        eps = (eps - mu[None, :] * tm).contiguous()

        # ---- schedule and per-(slot, trait) randomness, drawn over all
        # D m_loc slots and sliced at this shard's ----
        order = self.sweep_order(it, noise)
        u = noise.get("u")
        if u is None:
            u = torch.rand((cfg.m_glob, T), dtype=f32, device=dev,
                           generator=self._gen(it, _S_UNIF))
        nrm = noise.get("nrm")
        if nrm is None:
            nrm = torch.randn((cfg.m_glob, T), dtype=f32, device=dev,
                              generator=self._gen(it, _S_NORM))
        u, nrm = shard_rows(u.to(dev), cfg), shard_rows(nrm.to(dev), cfg)
        active = self.active(state)
        mrow = self.build_mrow(state, u, nrm, active)
        i2se = 0.5 / state.sigma_e

        # ---- the sweep: one of three branches (module docstring); on
        # marker shards the whole sweeps run a window a launch ----
        sync = self._esum if cfg.n_dev > 1 else None
        if not cfg.exact and not cfg.per_window:
            eps, out = sweep_stale_mt(self.packed, eps, tm, mrow, i2se,
                                      self.dNm1, window=cfg.window, n_mix=K,
                                      complete=cfg.complete, order=order,
                                      sync=sync)
        elif cfg.complete and cfg.full_pheno and not cfg.per_window:
            eps, out = sweep_exact_mt(self.packed, eps, tm, mrow, i2se,
                                      self.dNm1, window=cfg.window, n_mix=K,
                                      order=order, sync=sync)
        else:
            eps, out = self.window_sweep(eps, mrow, order, i2se)
        beta = out[:, :T].contiguous()
        comps = out[:, T:2 * T].to(torch.int32)
        acum = out[:, 2 * T:].contiguous()

        # component counts over active (slot, trait): 0/1 weights, exact in
        # any order (bayesrrm_mt.py:576-583)
        idx = (torch.arange(T, device=dev)[None, :] * (G * K)
               + self.groups[:, None] * K + comps.to(torch.int64))
        cass = self._sum(torch.zeros(T * G * K, dtype=f32, device=dev
                                     ).index_add_(
            0, idx.reshape(-1), active.to(f32).reshape(-1)).reshape(T, G, K))
        # fixed-order per-(trait, group) reductions (no float atomics),
        # summed over shards
        beta_sqn = self._sum((self.group_onehot[:, :, None]
                              * (beta * beta)[None]).sum(dim=1).T)  # (T, G)

        # ---- per-(trait, group) hypers (bayesrrm_mt.py:603-613) ----
        mtot = self.mtot[None, :]
        m0 = mtot - cass[:, :, 0]
        skip = (mtot == 0) | (m0 == 0) | (cass.sum(dim=2) == 0)
        dof = V0G_DEFAULT + m0
        scale = (beta_sqn * m0 + V0G_DEFAULT * S02G_DEFAULT) / torch.maximum(
            dof, tiny)
        sg_draw = dist.inv_scaled_chisq_rng(self._gen(it, _S_SIGMAG), dof,
                                            scale)
        sigma_g = torch.where(skip, 0.0, sg_draw)
        pi_draw = dist.dirichlet_rng(self._gen(it, _S_PI), cass + 1.0)
        est_pi = torch.where(skip[:, :, None], state.est_pi, pi_draw)

        eps, gamma = self.cov_sweep(eps, state, it, noise)

        # ---- per-trait sigmaE (bayesrrm_mt.py:645-648) ----
        e_sqn = self._isum((eps * eps).sum(dim=0))
        sigma_e = dist.inv_scaled_chisq_rng(
            self._gen(it, _S_SIGMAE), V0E + dN,
            (e_sqn + V0E * S02E) / (V0E + dN))

        new = MtState(eps=eps, beta=beta, components=comps, acum=acum, mu=mu,
                      sigma_e=sigma_e, sigma_g=sigma_g, est_pi=est_pi,
                      gamma=gamma)
        return new, MtStats(m0=m0, cass=cass, beta_sqn=beta_sqn)

    def cov_sweep(self, eps: torch.Tensor, state: MtState, it: int,
                  noise: dict):
        """The per-trait fixed-effects ridge sweep (the JAX sampler's
        :616-643, the multi-trait form of BayesRRm.cpp:2648-2681): the F
        covariates in one random order, each drawing a (T,) gamma row, the
        dot products and residual updates of trait t under its NaN mask,
        under each trait's incoming sigmaE, the dot products summed over
        the chunks of individuals. Plain torch. Returns (eps', gamma')."""
        cfg, dev = self.cfg, self.device
        F, T = cfg.n_cov, cfg.n_traits
        if F == 0:
            return eps, state.gamma
        xi = noise.get("covperm")
        if xi is None:
            xi = torch.randperm(F, device=dev,
                                generator=self._gen(it, _S_COVPERM))
        z = noise.get("cov")
        if z is None:
            z = torch.randn((F, T), dtype=f32, device=dev,
                            generator=self._gen(it, _S_COV))
        xi, z = xi.to(dev, torch.int64), z.to(dev)
        sigma_e = state.sigma_e
        denom = self.dNm1 + sigma_e / S02F                       # (T,)
        sd = torch.sqrt(sigma_e / denom)
        cols = self.x_cov[:, xi].T.contiguous()          # (F, n_loc), in order
        g = state.gamma[xi]                                      # (F, T)
        out = []
        for i in range(F):
            colm = cols[i][:, None] * self.trait_mask            # (n_pad, T)
            g_old = g[i]
            g_new = (self._isum((colm * (eps + g_old[None, :] * colm)
                                 ).sum(dim=0)) / denom + z[i] * sd)
            eps = eps + (g_old - g_new)[None, :] * colm
            out.append(g_new)
        gamma = torch.empty_like(state.gamma)
        gamma[xi] = torch.stack(out)
        return eps, gamma

    # ------------------------------------------------------------------
    def to_marker_order(self, flat: np.ndarray, fill=0) -> np.ndarray:
        """Per-slot values of every shard (D m_loc, ...) -> reference marker
        order (Mtot, ...); pad slots dropped."""
        out = np.full((self.cfg.m_tot,) + flat.shape[1:], fill,
                      dtype=flat.dtype)
        sel = self.slot_to_marker >= 0
        out[self.slot_to_marker[sel]] = flat[sel]
        return out

    def beta_global(self, state: MtState) -> np.ndarray:
        """beta (Mtot, T) in marker order (a collective on marker shards)."""
        beta = self.gather_markers(state.beta)
        return self.to_marker_order(beta.cpu().numpy().astype(np.float64))
