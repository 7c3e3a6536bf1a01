"""BayesW: Weibull survival-model Gibbs sampler.

Port of ``hydra_tpu/samplers/bayesw.py`` (reference BayesW::runMpiGibbs_bW,
src/BayesW.cpp:905-2151) for one device or D marker shards, one
``torch.distributed`` rank a shard: log-time phenotype y, failure
indicators, covariates (fixed effects), Weibull shape alpha, spike +
Gaussian-mixture marker effects whose marginal likelihoods come from
adaptive Gauss-Hermite quadrature. A sweep is

  mu slice draw -> a slice draw per covariate -> alpha slice draw -> vi
  refresh -> per-slot noise -> mrow build -> one sweep_stale_bw call over
  all windows -> cass -> sigmaG, pi draws

``mega="off"`` replaces the sweep_stale_bw call by the JAX per-window
``window_body`` (bayesw.py:279-423), one window at a time
(``window_sweep``): window_level_sums -> the window's draw (torch ops,
``sweep_kernel_bw._draw``, the plain version of the whole-sweep kernel's
draw: the own-effect removal, the adaptive Gauss-Hermite marginals, the
component draw and the slice draw of beta on the same per-slot noise) ->
window_axpy -> the vi refresh, on the marker schedule.

with everything per marker kept in SLOT order. W = 1 is exact sequential
BayesW; W > 1 runs the reference's stale windows (--sync-rate). The
"block" schedule (the port's ``auto``) keeps the JAX sampler's one-time
marker -> slot permutation (same RandomState seed, so ``slot_to_marker``
matches) and shuffles whole windows each sweep; "marker" shuffles every
slot each sweep.

Randomness is counter-based: one ``torch.Generator`` per (seed, iteration,
site) with the JAX sampler's site ids, and the per-slot draws (component
uniform, slice exponential, bracket and shrink uniforms) are made over all
slots and indexed by slot. ``step(..., noise=...)`` takes them from the
caller instead, which is how the tests hold one sweep against the JAX
sampler. The densities use the expm1 form of the JAX sampler's module
docstring.

On D > 1 marker shards (``n_dev``, ``rank``) the layout, the shard-keyed
sweep order and the per-slot noise (drawn over all D m_loc slots, sliced at
rank m_loc) are ``samplers/bayesrrm.py``'s. The JAX sampler runs its
per-window ``window_body`` there (its whole-sweep kernel needs one shard,
bayesw.py:592-595), summing the residual change over ranks after each
window: here ``mega="off"`` runs ``window_sweep`` with that sum, and
otherwise each window is one ``sweep_stale_bw`` call on the window's rows
(``shard_sweep``; its plain version is ``window_sweep``'s draw) followed by
the sum (``mesh.residual_sum``: ``hier_sum`` over the slices of
``--dcn-slices``, n_dcn) and the vi refresh. mu, alpha and the covariates
are drawn on every rank alike from the replicated residual; the component
counts and sums of beta^2 are summed over the marker shards.

Chunks of individuals (n_ind = I > 1, ``--ind-shards``) take the layout of
``samplers/bayesrrm.py`` (each rank its chunk's byte columns, residual,
mask, failures and covariates; the markers' failure sums from the whole
rows) and the per-window branch (``window_sweep``, marker schedule): each
window's level sums and sum(vi) are summed over the individual group in one
all_reduce before the draw, and every other sum over individuals (w0, the
failures' dot with the residual, the alpha and covariate densities at each
of the slice sampler's fixed number of evaluations, the covariates' squared
norms) is summed over it as well, so the draws agree across the group.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from hydra_tpu_torch.data.genotypes import (Dataset, chunk_columns,
                                            ind_chunk, marker_shards)
from hydra_tpu_torch.ops.decode import crumbs, hpack_bytes
from hydra_tpu_torch.ops.sweep_kernel_bw import (EULER_MASCHERONI, Q_MAX,
                                                 _draw, bw_mrow_width,
                                                 sweep_stale_bw)
from hydra_tpu_torch.ops.window_kernels import window_axpy, window_level_sums
from hydra_tpu_torch.parallel import distributed, mesh
from hydra_tpu_torch.samplers.bayesrrm import (OnGrid, global_slots,
                                              resolve_device, shard_rows,
                                              sweep_order)
from hydra_tpu_torch.utils import dist
from hydra_tpu_torch.utils.slice_sampler import (N_EXPAND, N_SHRINK,
                                                 slice_noise,
                                                 slice_sample,
                                                 slice_sample_noise)

f32 = torch.float32
SQRT_PI = 1.77245385090552

# priors (BayesW.hpp:85-89)
ALPHA_0 = 0.01
KAPPA_0 = 0.01
SIGMA_MU = 100.0
ALPHA_SIGMA = 1.0
BETA_SIGMA = 0.0001

# RNG site ids, as in the JAX sampler (hydra_tpu/samplers/bayesw.py:69-70)
_S_MU, _S_ALPHA, _S_MARKER, _S_SIGMAG, _S_PI, _S_PERM, _S_COV, _S_COVPERM = (
    0, 1, 2, 3, 4, 5, 6, 7)


def gh_table(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Gauss-Hermite nodes and *adjusted* weights w~ = w exp(x^2): the
    reference's hard-coded tables for n in {3..25} (BayesW.cpp:174-712)."""
    x, w = np.polynomial.hermite.hermgauss(n)
    return x, w * np.exp(x * x)


@dataclass(frozen=True)
class BayesWConfig:
    n_real: int
    n_pad: int
    m_tot: int
    m_loc: int
    window: int
    k: int                    # mixtures incl. zero component
    num_groups: int
    quad_n: int
    shuffle: bool
    schedule: str             # "block" | "marker"
    complete: bool            # no missing genotypes among real individuals
    n_cov: int = 0            # covariates (fixed effects)
    per_window: bool = False  # mega="off": the per-window branch
    n_dev: int = 1            # marker shards, one rank each
    rank: int = 0             # this rank's shard
    det_sync: bool = False    # rank-order sums, the same on any topology
    n_dcn: int = 1            # --dcn-slices: slices of the marker hierarchy
    n_ind: int = 1            # --ind-shards: chunks of individuals a shard
    n_loc: int = 0            # this rank's individuals (its chunk, padded)

    @property
    def n_windows(self) -> int:
        return self.m_loc // self.window

    @property
    def m_glob(self) -> int:
        return self.m_loc * self.n_dev


@dataclass
class BayesWState:
    eps: torch.Tensor          # (n_pad,) residual y - mu - X beta
    beta: torch.Tensor         # (m_loc,) per slot
    components: torch.Tensor   # (m_loc,) int32 per slot
    mu: torch.Tensor           # ()
    alpha: torch.Tensor        # () Weibull shape
    sigma_g: torch.Tensor      # (G,)
    pi_l: torch.Tensor         # (G, K)
    gamma: torch.Tensor        # (F,) fixed effects


STATE_FIELDS = tuple(f.name for f in dataclasses.fields(BayesWState))


@dataclass
class BayesWStats:
    m0: torch.Tensor           # (G,)
    cass: torch.Tensor         # (G, K)
    beta_sqn: torch.Tensor     # (G,)


def state_from_numpy(x, device) -> BayesWState:
    """A state from numpy arrays: a JAX ``BayesWState`` converted with
    ``np.asarray`` per field, or a dict with the same field names."""
    get = x.get if isinstance(x, dict) else (lambda k: getattr(x, k))
    out = {}
    for name in STATE_FIELDS:
        dt = torch.int32 if name == "components" else f32
        out[name] = torch.as_tensor(np.array(get(name)), dtype=dt,
                                    device=device)
    return BayesWState(**out)


def state_to_numpy(state: BayesWState) -> dict:
    """Field name -> numpy array (the JAX state's names and dtypes)."""
    return {name: getattr(state, name).cpu().numpy() for name in STATE_FIELDS}


class BayesW(OnGrid):
    """Data layout, state init and the Gibbs sweep of one device or one
    marker shard."""

    def __init__(self, dataset: Dataset, *, window: int = 1,
                 shuffle: bool = True, seed: int = 0, quad_points: int = 25,
                 schedule: str = "auto", mega: str = "auto", device="cuda",
                 packed_device: Optional[torch.Tensor] = None,
                 n_dev: int = 1, rank: int = 0, det_sync: bool = False,
                 n_dcn: int = 1, n_ind: int = 1):
        """mega: "off" takes the per-window branch ("auto"/"on": the
        whole-sweep kernel). packed_device: the genotypes already h-packed on
        the device,
        (M, NB) uint8 in marker order, for data generated there; then
        ``dataset.geno`` supplies only n, n_pad and the marker statistics.
        n_dev > 1: this rank's shard ``rank`` under a process group of
        n_dev ranks; det_sync: rank-order sums (``mesh.det_sum``); n_dcn: the
        slices of ``--dcn-slices`` (the residual's change summed by
        ``hier_sum``); n_ind: the chunks of individuals of ``--ind-shards``
        (n_dev n_ind ranks, the layout of ``samplers/bayesrrm.py``)."""
        if dataset.fail is None:
            raise ValueError("BayesW requires failure indicators (--failure)")
        self.ds = dataset
        self.seed = int(seed)
        self.device = (device if isinstance(device, torch.device)
                       else resolve_device(device))
        geno = dataset.geno
        K = int(dataset.mS.shape[1])
        if window < 1:
            raise ValueError(f"--window {window} is below 1")
        if K < 2:
            raise ValueError(f"{K} mixture components: BayesW takes 2 or "
                             "more")
        if not 1 <= quad_points <= Q_MAX:
            raise ValueError(f"--quad_points {quad_points}: takes 1..{Q_MAX}")
        if schedule not in ("auto", "marker", "block"):
            raise ValueError(f"schedule must be auto/marker/block, "
                             f"got {schedule!r}")
        if mega not in ("auto", "on", "off"):
            raise ValueError(f"mega must be auto/on/off, got {mega!r}")
        n_dev, rank, n_ind = int(n_dev), int(rank), int(n_ind)
        # auto follows the JAX sampler's rule (hydra_tpu/samplers/bayesw.py:
        # 593-611): block where its whole-sweep kernel runs (W >= 8 or
        # W = 1, mega not off, one shard, no chunks of individuals), marker
        # otherwise; its TPU memory gates are not copied
        if schedule == "auto":
            schedule = ("block" if (window >= 8 or window == 1)
                        and mega != "off" and n_dev == 1 and n_ind == 1
                        else "marker")
        if schedule == "block":
            print("INFO   : BayesW block schedule (the whole-sweep kernel "
                  "reads windows in place; --schedule marker restores the "
                  "per-sweep marker shuffle)", flush=True)
        starts, lengths, m_loc = marker_shards(geno.m_global, n_dev, rank,
                                               window, dataset.blocks, n_ind)
        _, n_loc = ind_chunk(geno.n_pad, n_ind)
        chunk = self._join_grid(n_dcn, n_ind, rank)
        self.cfg = cfg = BayesWConfig(
            n_real=geno.n, n_pad=geno.n_pad, m_tot=geno.m_global, m_loc=m_loc,
            window=window, k=K, num_groups=dataset.num_groups,
            quad_n=quad_points, shuffle=shuffle, schedule=schedule,
            complete=bool(geno.nm_global_sum == 0),
            n_cov=0 if dataset.X is None else int(dataset.X.shape[1]),
            per_window=mega == "off" or n_ind > 1, n_dev=n_dev, rank=rank,
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
        mave_g = np.zeros(m_loc, dtype=np.float64)
        msd_g = np.zeros(m_loc, dtype=np.float64)
        valid_g = np.zeros(m_loc, dtype=np.float32)
        mave_g[:ln] = geno.mave[ls:ls + ln]
        msd_g[:ln] = geno.msd[ls:ls + ln]
        groups_g[:ln] = dataset.groups[s:s + ln]
        valid_g[:ln] = 1.0
        groups_g, mave_g, msd_g = groups_g[p], mave_g[p], msd_g[p]
        valid_g = valid_g[p]

        dev = self.device
        full = (geno.packed if packed_device is None else packed_device)
        full = full[ls:ls + ln]
        # the markers' failure sums from the whole rows, before the rank
        # keeps its chunk's byte columns
        sum_fail = np.zeros(m_loc, dtype=np.float32)
        sum_fail[:ln] = self._sum_fail(
            full if packed_device is not None
            else torch.from_numpy(hpack_bytes(full)).to(dev),
            geno.mave[ls:ls + ln], geno.msd[ls:ls + ln], dataset.fail)
        if packed_device is None:
            # pad slots are all-missing: PLINK 0x55, h-packed 0xFF
            packed_g = np.full((m_loc, nb), 0b01010101, dtype=np.uint8)
            packed_g[:ln] = chunk_columns(full, cfg.n_pad, n_ind, chunk,
                                          0b01010101)
            self.packed = torch.from_numpy(hpack_bytes(packed_g[p])).to(dev)
            del packed_g
        else:
            rows = torch.full((m_loc, nb), 0xFF, dtype=torch.uint8,
                              device=dev)
            rows[:ln] = chunk_columns(full, cfg.n_pad, n_ind, chunk, 0xFF)
            self.packed = rows[torch.from_numpy(p).to(dev)]
            del rows
        del full

        G = cfg.num_groups
        ind_mask = np.zeros(cfg.n_pad, dtype=np.float32)
        ind_mask[:cfg.n_real] = 1.0
        fail = np.zeros(cfg.n_pad, dtype=np.float32)
        fail[:cfg.n_real] = dataset.fail
        # covariates (n_pad, F), zero on pad individuals, and per covariate
        # sum_i x_ij fail_i in float64 (BayesW.cpp:1236-1239; the JAX
        # sampler's :753-760)
        x_cov = np.zeros((cfg.n_pad, cfg.n_cov), dtype=np.float32)
        sff = np.zeros(cfg.n_cov, dtype=np.float32)
        if cfg.n_cov:
            x_cov[:cfg.n_real] = dataset.X
            sff = np.asarray(dataset.X.T @ dataset.fail, np.float32)

        def put(a, dt=f32):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

        self.groups = put(groups_g, torch.int64)
        self.mave = put(mave_g)
        self.msd = put(msd_g)
        self.valid = put(valid_g)
        self.ind_mask = put(self._local(ind_mask))
        self.fail = put(self._local(fail))
        self.x_cov = put(self._local(x_cov))
        self.sum_fail_fix = put(sff)
        self.sum_fail = put(sum_fail[p])
        self.group_onehot = (self.groups[None, :] == torch.arange(
            G, device=dev)[:, None]).to(f32)                    # (G, m_loc)
        # non-zero mixture values only (cVa in bW, BayesW.cpp:781-786)
        self.cva_nz = put(dataset.mS[:, 1:])
        self.mtot_grp = np.bincount(dataset.groups, minlength=G)
        self.mtot = put(self.mtot_grp)
        gh_x, gh_w = gh_table(cfg.quad_n)
        self.gh_x, self.gh_w = put(gh_x), put(gh_w)
        # failures over all individuals (0/1: exact in f32)
        self.d_events = put(float(fail.sum()))
        self.dN = put(float(cfg.n_real))

    def _check_memory(self, nb: int) -> None:
        """Refuse a run whose device arrays cannot fit before allocating
        them: packed bytes (twice while laid out), per-slot rows and the
        residual-length vectors, against torch.cuda.mem_get_info."""
        from hydra_tpu_torch.ops import _build

        cfg = self.cfg
        ws = _build.load("sweep_kernel_bw.cu").hydra_bw_workspace_bytes(
            nb, cfg.window)
        need = (2 * cfg.m_loc * nb
                + cfg.m_loc * 4 * (bw_mrow_width(cfg.k) + 16 + cfg.num_groups)
                + ws + 16 * cfg.n_pad * 4 + (256 << 20))
        free, total = torch.cuda.mem_get_info(self.device)
        if need > free:
            raise MemoryError(
                f"BayesW needs ~{need / 1e9:.2f} GB on {self.device} "
                f"({cfg.m_loc} slots x {nb} packed bytes), "
                f"{free / 1e9:.2f} GB of {total / 1e9:.2f} GB are free")

    def _sum_fail(self, rows: torch.Tensor, mave: np.ndarray,
                  msd: np.ndarray, fail_real: np.ndarray) -> np.ndarray:
        """Per marker (sum_{g=1} f + 2 sum_{g=2} f - mave * sum f) / sd
        (BayesW.cpp:1222-1229) of this shard's whole h-packed rows (ln,
        n_pad / 4) on the device, over all individuals: the counts taken
        blockwise (0/1 sums, exact in f32) and finished in float64 on the
        host as the JAX sampler does."""
        fail = torch.zeros(4 * rows.shape[1], dtype=f32, device=rows.device)
        fail[:len(fail_real)] = torch.as_tensor(fail_real, dtype=f32)
        counts = []
        step = max(1, (64 << 20) // (16 * rows.shape[1]))
        for r0 in range(0, rows.shape[0], step):
            c = crumbs(rows[r0:r0 + step])
            ind = torch.stack([(c == 1), (c == 0)]).to(f32)   # g = 1, g = 2
            counts.append(ind @ fail)
        s12 = torch.cat(counts, dim=1).cpu().numpy().astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            out = (s12[0] + 2.0 * s12[1] - mave * fail_real.sum()) / msd
        out[~np.isfinite(out)] = 0.0
        return out.astype(np.float32)

    # ------------------------------------------------------------------
    def _gen(self, it: int, site: int) -> torch.Generator:
        return dist.site_generator(self.seed, it, site, self.device)

    def init_state(self) -> BayesWState:
        """BayesW::init (BayesW.cpp:728-853)."""
        cfg, dev = self.cfg, self.device
        y = self.ds.y
        mu = float(y.mean())
        denominator = 6.0 * np.sum((y - mu) ** 2) / (len(y) - 1)
        alpha = float(np.pi / np.sqrt(denominator))
        G, K = cfg.num_groups, cfg.k
        sigma_g = np.full(G, np.pi**2 / (6.0 * alpha**2) / G)
        mtot = cfg.m_tot
        pi_l = np.full((G, K), 1.0 / mtot)
        pi_l[:, 0] = 0.99
        pi_l[:, 1] = 1.0 - pi_l[:, 0] - (K - 2) / mtot
        eps = np.zeros(cfg.n_pad, dtype=np.float32)
        eps[:cfg.n_real] = y - mu
        return state_from_numpy(dict(
            eps=self._local(eps), beta=np.zeros(cfg.m_loc, np.float32),
            components=np.zeros(cfg.m_loc, np.int32), mu=np.float32(mu),
            alpha=np.float32(alpha), sigma_g=sigma_g.astype(np.float32),
            pi_l=pi_l.astype(np.float32),
            gamma=np.zeros(cfg.n_cov, np.float32)), dev)

    def init_state_from_restart(self, rd) -> BayesWState:
        """The state saved at ``rd.iteration`` (the JAX sampler's
        :820-843): eps, beta and components into their slots, mu, alpha,
        sigmaG, pi and gamma. The chain resumes at
        ``rd.start_iteration``."""
        cfg = self.cfg
        local = shard_rows(self.slot_to_marker, cfg)
        sel = local >= 0
        eps = np.zeros(cfg.n_pad, dtype=np.float32)
        eps[:cfg.n_real] = rd.eps
        beta = np.zeros(cfg.m_loc, dtype=np.float32)
        comps = np.zeros(cfg.m_loc, dtype=np.int32)
        beta[sel] = rd.beta[local[sel]]
        comps[sel] = rd.components[local[sel]]
        gamma = (rd.gamma if rd.gamma is not None and cfg.n_cov > 0
                 else np.zeros(cfg.n_cov))
        return state_from_numpy(dict(
            eps=self._local(eps), beta=beta, components=comps,
            mu=np.float32(rd.mu),
            alpha=np.float32(rd.alpha),
            sigma_g=np.asarray(rd.sigma_g, np.float32),
            pi_l=np.asarray(rd.pi_l, np.float32),
            gamma=np.asarray(gamma, np.float32)), self.device)

    # ------------------------------------------------------------------
    def sweep_order(self, it: int, noise: Optional[dict] = None
                    ) -> torch.Tensor:
        """Slots in the order sweep `it` visits them (int32)."""
        return sweep_order(self.cfg, self.seed, it, _S_PERM, self.device,
                           noise)

    def slot_noise(self, it: int, noise: Optional[dict] = None) -> dict:
        """Per-slot draws of sweep `it`: the component uniform "u" and the
        slice noise "le", "ub" (m_loc,) and "uu" (m_loc, n_shrink), drawn
        (or given) over all D m_loc slots and sliced to this shard's."""
        noise = noise or {}
        keys = ("u", "le", "ub", "uu")
        if all(k in noise for k in keys):
            out = {k: noise[k].to(self.device) for k in keys}
        else:
            g = self._gen(it, _S_MARKER)
            m = self.cfg.m_glob
            u = torch.rand(m, generator=g, device=self.device)
            le, ub, uu = slice_noise(g, (m,), N_SHRINK, self.device)
            out = dict(u=u, le=le, ub=ub, uu=uu.T)
        return {k: shard_rows(v, self.cfg) for k, v in out.items()}

    def build_mrow(self, state: BayesWState, alpha: torch.Tensor,
                   slot: dict) -> torch.Tensor:
        """Per-slot kernel rows (sweep_kernel_bw.py column layout; the JAX
        sampler's :474-498)."""
        grp = self.groups
        act = (self.valid > 0) & (self.msd > 0)
        inv_sd = torch.where(act, 1.0 / torch.clamp(self.msd, min=1e-30), 0.0)
        mave, bold = self.mave, state.beta
        ab = alpha * bold
        e0 = torch.exp(ab * (0.0 - mave) * inv_sd)
        e1 = torch.exp(ab * (1.0 - mave) * inv_sd)
        e2 = torch.exp(ab * (2.0 - mave) * inv_sd)
        th0 = alpha * mave * inv_sd
        th1 = alpha * (mave - 1.0) * inv_sd
        th2 = alpha * (mave - 2.0) * inv_sd
        cva = self.cva_nz[grp]                                 # (m, K-1)
        sig = state.sigma_g[grp]
        pj = torch.exp(torch.log(torch.clamp(state.pi_l, min=1e-30))[grp])
        ml0 = pj[:, 0] * SQRT_PI
        sqrt2ck = torch.sqrt(2.0 * cva * sig[:, None])
        adc = alpha * alpha * sig[:, None] * cva
        two_ck_sg = 2.0 * cva * torch.clamp(sig, min=1e-30)[:, None]
        slim = 2.0 * torch.sqrt(state.sigma_g.sum() * cva)
        cols = [mave, inv_sd, bold, slot["u"], act.to(f32), self.sum_fail,
                th0, th1, th2, e0, e1, e2, ml0]
        mrow = torch.cat([torch.stack(cols, dim=1), pj[:, 1:], sqrt2ck, adc,
                          two_ck_sg, slim, slot["le"][:, None],
                          slot["ub"][:, None], slot["uu"]], dim=1)
        assert mrow.shape[1] == bw_mrow_width(self.cfg.k)
        return mrow.contiguous()

    def _slice(self, logf, x0, it, site, noise_key, noise, width,
               lower=-float("inf")):
        """One scalar slice draw, its noise from the caller or site."""
        given = noise.get(noise_key)
        if given is None:
            return slice_sample(logf, x0, self._gen(it, site), width,
                                lower=lower)
        le, ub, uu = (t.to(self.device) for t in given)
        return slice_sample_noise(logf, x0, le, ub, uu, width, lower=lower)

    def step(self, state: BayesWState, it: int,
             noise: Optional[dict] = None):
        """One Gibbs sweep. `noise` (tests) may supply the slice noise
        (le, ub, uu) of "mu" and "alpha", the covariates' order "covperm"
        and slice noise "cov" (le (F,), ub (F,), uu (n_shrink, F), the i-th
        column for the i-th covariate visited), the per-slot "u", "le",
        "ub", "uu" (slot_noise) and the "wperm"/"perm"."""
        cfg = self.cfg
        noise = noise or {}
        mask, fail = self.ind_mask, self.fail
        d_events = self.d_events
        eps, alpha, mu_old = state.eps, state.alpha, state.mu

        # ---- mu (mu_dens, BayesW.cpp:77-88), w0 at the current residual;
        # every sum over individuals is summed over their chunks (the JAX
        # psum_i, bayesw.py:182-247)
        isum = self._isum
        w0 = isum((torch.exp(alpha * eps - EULER_MASCHERONI) * mask).sum())

        def mu_logf(x):
            return (-alpha * d_events * x
                    - w0 * torch.expm1(-alpha * (x - mu_old))
                    - x * x / (2.0 * SIGMA_MU))

        # the location's conditional sd is ~ 1/(alpha sqrt(N))
        mu_width = torch.clamp(2.0 / (alpha * torch.sqrt(self.dN)), min=1e-3)
        mu = self._slice(mu_logf, mu_old, it, _S_MU, "mu", noise, mu_width)
        eps = eps + (mu_old - mu) * mask
        eps, gamma = self.cov_sweep(eps, alpha, state.gamma, it, noise)

        # ---- Weibull shape alpha (alpha_dens, BayesW.cpp:132-142)
        vi_cur = torch.exp(alpha * eps - EULER_MASCHERONI) * mask
        c_lin = isum((eps * fail).sum()) - KAPPA_0

        def alpha_logf(x):
            dx = x - alpha
            return ((ALPHA_0 + d_events - 1.0)
                    * (torch.log(torch.clamp(x, min=1e-30)) - torch.log(alpha))
                    + dx * c_lin
                    - isum((vi_cur * torch.expm1(eps * dx)).sum()))

        # shape-parameter sd ~ 0.78 alpha / sqrt(n_events): bracket ~2 sd
        alpha_width = torch.clamp(
            1.6 * alpha / torch.sqrt(torch.clamp(d_events, min=4.0)),
            min=1e-3)
        alpha = self._slice(alpha_logf, alpha, it, _S_ALPHA, "alpha", noise,
                            alpha_width, lower=1e-6)

        # ---- vi (BayesW.cpp:1452-1455), schedule, per-slot noise, sweep
        vi = torch.exp(alpha * eps - EULER_MASCHERONI) * mask
        order = self.sweep_order(it, noise)
        mrow = self.build_mrow(state, alpha, self.slot_noise(it, noise))
        if cfg.per_window:
            eps, out = self.window_sweep(eps, vi, mrow, order, alpha)
        elif cfg.n_dev > 1:
            eps, out = self.shard_sweep(eps, vi, mrow, order, alpha)
        else:
            eps, out = sweep_stale_bw(
                self.packed, eps.contiguous(), vi.contiguous(), mrow,
                self.gh_x, self.gh_w, alpha, window=cfg.window, n_mix=cfg.k,
                complete=cfg.complete, ind_mask=mask, order=order)
        beta = out[:, 0].contiguous()
        comps = out[:, 1].to(torch.int32)

        # ---- cass over active markers (0/1 weights: exact in any order)
        G, K = cfg.num_groups, cfg.k
        act = ((self.valid > 0) & (self.msd > 0)).to(f32)
        cass = self._sum(torch.zeros(G * K, dtype=f32, device=self.device
                                     ).index_add_(
            0, self.groups * K + comps.to(torch.int64), act).reshape(G, K))
        beta_sqn = self._sum(
            (self.group_onehot * (beta * beta)[None, :]).sum(dim=1))

        # ---- hypers (BayesW.cpp:1885-1905)
        m0 = self.mtot - cass[:, 0]
        sigma_g = dist.inv_gamma_rng(self._gen(it, _S_SIGMAG),
                                     ALPHA_SIGMA + 0.5 * m0,
                                     BETA_SIGMA + 0.5 * m0 * beta_sqn)
        sigma_g = torch.where(self.mtot == 0, 0.0, sigma_g)
        pi_l = dist.dirichlet_rng(self._gen(it, _S_PI), cass + 1.0)

        new = BayesWState(eps=eps, beta=beta, components=comps, mu=mu,
                          alpha=alpha, sigma_g=sigma_g, pi_l=pi_l,
                          gamma=gamma)
        return new, BayesWStats(m0=m0, cass=cass, beta_sqn=beta_sqn)

    def window_sweep(self, eps: torch.Tensor, vi: torch.Tensor,
                     mrow: torch.Tensor, order: torch.Tensor,
                     alpha: torch.Tensor):
        """The per-window branch (the JAX ``window_body``, bayesw.py:
        279-423): per window of slots ``order[w W:(w + 1) W]``, the level
        sums of vi (window_level_sums), the draw from the window's mrow
        rows (torch ops), the residual axpy (window_axpy; complete data
        (axpy + sum(c2)) * mask), on marker shards summed over the ranks
        (the JAX ``hpsum``, bayesw.py:411), and vi = exp(alpha eps -
        EuMasc) * mask. Nothing else syncs with the host. Returns (eps', out
        (m_loc, 4)) as sweep_stale_bw does. On chunks of individuals the
        level sums and sum(vi) are summed over the individual group in one
        all_reduce before the draw, which then runs alike on every rank of
        it (the JAX psum_i, bayesw.py:304-312)."""
        cfg, mask = self.cfg, self.ind_mask
        W = cfg.window
        out = torch.zeros((cfg.m_loc, 4), dtype=f32, device=self.device)
        for w in range(cfg.n_windows):
            rows = order[w * W:(w + 1) * W]
            slots = rows.to(torch.int64)
            r = mrow[slots]
            s1, s2, sb = window_level_sums(self.packed, vi, cfg.complete,
                                           rows=rows)
            s1, s2, sb, s_all = self._ind_pack(s1, s2, sb, vi.sum())
            bnew, comp, dbeta = _draw(r, s1, s2, sb, s_all, self.gh_x,
                                      self.gh_w, alpha, cfg.k, cfg.complete,
                                      N_EXPAND, N_SHRINK)
            c1 = dbeta * r[:, 1]
            c2 = -c1 * r[:, 0]
            if cfg.complete:
                d_eps = (window_axpy(self.packed, c1, c2, True, rows)
                         + c2.sum()) * mask
            else:
                d_eps = window_axpy(self.packed, c1, c2, False, rows)
            eps = eps + self._esum(d_eps)
            vi = torch.exp(alpha * eps - EULER_MASCHERONI) * mask
            out[slots] = torch.stack([bnew, comp, dbeta,
                                      torch.zeros_like(bnew)], dim=1)
        return eps, out

    def shard_sweep(self, eps: torch.Tensor, vi: torch.Tensor,
                    mrow: torch.Tensor, order: torch.Tensor,
                    alpha: torch.Tensor):
        """The per-window branch on marker shards with the whole-sweep
        kernel: per window one ``sweep_stale_bw`` call on the window's
        packed rows and mrow rows (level sums, draw, axpy), the change of
        eps summed over the ranks, and the vi refresh. Returns (eps', out)
        as ``window_sweep``."""
        cfg, mask = self.cfg, self.ind_mask
        W = cfg.window
        out = torch.zeros((cfg.m_loc, 4), dtype=f32, device=self.device)
        for w in range(cfg.n_windows):
            slots = order[w * W:(w + 1) * W].to(torch.int64)
            new, out_w = sweep_stale_bw(
                self.packed[slots], eps, vi.contiguous(),
                mrow[slots].contiguous(), self.gh_x, self.gh_w, alpha,
                window=W, n_mix=cfg.k, complete=cfg.complete, ind_mask=mask)
            eps = eps + self._esum(new - eps)
            vi = torch.exp(alpha * eps - EULER_MASCHERONI) * mask
            out[slots] = out_w
        return eps, out

    def cov_sweep(self, eps: torch.Tensor, alpha: torch.Tensor,
                  gamma: torch.Tensor, it: int, noise: dict):
        """The fixed effects (gamma_dens, BayesW.cpp:119-129; the JAX
        sampler's :204-235): the F covariates in a random order, each
        gamma_j slice-sampled given the residual with its own effect
        restored, the bracket width from the covariate's column norm.
        The i-th covariate visited takes the i-th slice noise. Plain torch,
        like the mu and alpha draws. Returns (eps', gamma')."""
        cfg, dev, mask = self.cfg, self.device, self.ind_mask
        F = cfg.n_cov
        if F == 0:
            return eps, gamma
        xi = noise.get("covperm")
        if xi is None:
            xi = torch.randperm(F, device=dev,
                                generator=self._gen(it, _S_COVPERM))
        given = noise.get("cov")
        if given is None:
            given = slice_noise(self._gen(it, _S_COV), (F,), N_SHRINK, dev)
        le, ub, uu = (t.to(dev) for t in given)
        xi = xi.to(dev, torch.int64)
        col_sq = self._isum((self.x_cov * self.x_cov * mask[:, None]).sum(
            dim=0))
        cols = self.x_cov[:, xi].T.contiguous()          # (F, n_loc), in order
        sff, csq, g = self.sum_fail_fix[xi], col_sq[xi], gamma[xi]
        out = []
        for i in range(F):
            col, g_old = cols[i], g[i]
            w = torch.exp(alpha * (eps + col * g_old)
                          - EULER_MASCHERONI) * mask

            def g_logf(x, col=col, w=w, sf=sff[i]):
                return (-alpha * x * sf
                        - self._isum((w * torch.expm1(-alpha * col * x)).sum())
                        - x * x / (2.0 * SIGMA_MU))

            width = torch.clamp(2.0 / (alpha * torch.sqrt(
                torch.clamp(csq[i], min=1.0))), min=1e-3)
            g_new = slice_sample_noise(g_logf, g_old, le[i], ub[i], uu[:, i],
                                       width)
            eps = eps + (g_old - g_new) * col * mask
            out.append(g_new)
        new = torch.empty_like(gamma)
        new[xi] = torch.stack(out)
        return eps, new

    def cov_order(self, it: int) -> np.ndarray:
        """The covariates' order at iteration ``it`` (the sweep's own
        permutation, re-drawn from its site), written to ``.xiv``; a
        restart never reads it."""
        return torch.randperm(self.cfg.n_cov, device=self.device,
                              generator=self._gen(it, _S_COVPERM)
                              ).cpu().numpy().astype(np.int32)

    # ------------------------------------------------------------------
    def to_marker_order(self, flat: np.ndarray) -> np.ndarray:
        """Per-slot values of every shard (D m_loc,) -> reference marker
        order (Mtot,)."""
        out = np.zeros(self.cfg.m_tot, dtype=flat.dtype)
        sel = self.slot_to_marker >= 0
        out[self.slot_to_marker[sel]] = flat[sel]
        return out

    def beta_global(self, state: BayesWState) -> np.ndarray:
        """beta in marker order (a collective on marker shards)."""
        beta = self.gather_markers(state.beta)
        return self.to_marker_order(beta.cpu().numpy().astype(np.float64))

    def components_global(self, state: BayesWState) -> np.ndarray:
        comps = self.gather_markers(state.components)
        return self.to_marker_order(comps.cpu().numpy())

    def run(self, n_iterations: int, state: Optional[BayesWState] = None,
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
