"""The port's per-window BayesRRm branch (``--mega off``, ``--cache-planes
on``) and windows below 8 against the JAX package (CPU).

Kernels: the plain versions of window_stats, window_gibbs,
window_stats_planes and window_axpy_planes (which the wrappers take for CPU
tensors) against the JAX Pallas kernels in interpret mode, on the same
numpy inputs, W in {1, 16}, complete and missing genotypes, exact and
stale; build_planes against ``build_planes_host`` re-laid to individual
order. The last 37 individuals are padding (missing-coded, eps = 0) and
three pad markers (all missing, mstd = 0) sit among the rows.

Sweeps: one sweep with the JAX sampler's own draws (mu, u, nrm and the
marker permutation of its key schedule) against the JAX sampler's CPU
path (its ``window_body`` with XLA decode and dot; the Pallas per-window
kernels do not run under ``shard_map`` on the CPU) and, for the planes,
against its ``use_planes`` path in interpret mode. Components must agree
exactly; eps and beta within 5e-5 (f32 summation order; the exact draw
forms differ only at rounding ties: ``window_gibbs`` clamps and compares
u*s unnormalized, the JAX CPU ``draw_one`` normalizes). Then the
per-window branch against the port's own whole-sweep branch, and exact
W = 1 against W = 16 on the marker schedule (window invariance).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from hydra_tpu.ops import planes as jpl
from hydra_tpu.ops import window_kernels as jwk
from hydra_tpu.ops.decode import unhpack_bytes
from hydra_tpu.ops.gibbs_kernel import window_gibbs as jax_window_gibbs
from hydra_tpu.parallel.mesh import make_mesh, marker_axes
from hydra_tpu.samplers.bayesrrm import BayesRRm as JaxBayesRRm
from hydra_tpu_torch.ops import gibbs_kernel as tgk
from hydra_tpu_torch.ops import planes as tpl
from hydra_tpu_torch.ops import window_kernels as twk
from hydra_tpu_torch.samplers.bayesrrm import (STATE_FIELDS, BayesRRm,
                                               state_from_numpy,
                                               state_to_numpy)

from tests.test_bayesrrm import simulate
from tests.test_torch_cuda import make_inputs

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)

M, NB = 24, 128          # kernel inputs: 24 rows of 512 individuals


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rows(W, seed, m=M):
    return np.random.RandomState(seed).choice(m, W, replace=False).astype(
        np.int32)


@pytest.mark.parametrize("W", [1, 16])
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("missing", [False, True])
def test_window_stats_matches_jax(missing, exact, W):
    """s1, s2 within rtol 1e-5 / atol 1e-4 (sums of ~475 terms of size
    ~1). The Gram: complete data is exact integers plus the same rank-1
    correction (atol 1e-3); missing data the JAX kernel splits x into bf16
    hi + lo and drops lo*lo (~1e-5 of the diagonal, ~475), atol 2e-2."""
    pk, eps, _, mrow, n = make_inputs(M, NB, 3, missing, 3)
    rows = _rows(W, 4)
    mave, mstd = mrow[rows, 0], mrow[rows, 1]
    complete = not missing
    got = twk.window_stats(_t(pk), _t(eps), _t(mave), _t(mstd), exact,
                           complete, float(n), _t(rows))
    want = jwk.window_stats(jnp.asarray(pk[rows]),
                            jwk.deinterleave(jnp.asarray(eps)),
                            jnp.asarray(mave), jnp.asarray(mstd), exact,
                            interpret=True, complete=complete,
                            n_real=float(n))
    for a, b, atol in zip(got, want, (1e-4, 1e-4, 1e-3 if complete else 2e-2)):
        assert (a is None) == (b is None)
        if b is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=atol)
    # the rows are read in place: the same as the gathered window
    same = twk.window_stats(_t(pk[rows]), _t(eps), _t(mave), _t(mstd), exact,
                            complete, float(n))
    for a, b in zip(got, same):
        assert (a is None and b is None) or torch.equal(a, b)
    c1 = _t((np.random.RandomState(5).randn(W) * 0.05).astype(np.float32))
    c2 = -c1 * _t(mave)
    assert torch.equal(twk.window_axpy(_t(pk), c1, c2, complete, _t(rows)),
                       twk.window_axpy(_t(pk[rows]), c1, c2, complete))


def _gibbs_inputs(W, seed, K=4):
    """A window's recurrence inputs (tests/test_gibbs_kernel.py's recipe):
    a symmetric Gram of 512 individuals, num0 of a few units, K - 1
    non-zero components, 10% inactive markers."""
    rs = np.random.RandomState(seed)
    xt = rs.randn(W, 512).astype(np.float32) / 20
    gram = xt @ xt.T
    gram = ((gram + gram.T) / 2).astype(np.float32)
    invd = (np.full((W, K - 1), 1 / 300.0)
            * np.arange(1.0, K)).astype(np.float32)
    act = (rs.rand(W) > 0.1).astype(np.float32)
    act[0] = 1.0
    return dict(
        gram=gram, num0=(rs.randn(W) * 4).astype(np.float32),
        logl_static=np.log(rs.dirichlet(np.ones(K), W)).astype(np.float32),
        inv_denomk=invd, sd_k=np.sqrt(0.5 * invd).astype(np.float32),
        u=rs.rand(W).astype(np.float32),
        nrm=rs.randn(W).astype(np.float32), act=act,
        bold=(rs.randn(W) * 0.02).astype(np.float32))


@pytest.mark.parametrize("W,K", [
    pytest.param(W, K, id=str(W) if K == 4 else f"W{W}-K{K}")
    for W in (1, 16, 33, 64) for K in (2, 4, 6)])
def test_window_gibbs_matches_jax(W, K):
    """Same draw form (clamp at -60, unnormalized u*s): components equal,
    dbeta / beta / acum within 2e-5 (the Gram correction's summation
    order). The windows cross the CUDA recurrence's 32-marker blocks (33: a
    ragged last block); K = 2 and 6 beside the default 4."""
    args = _gibbs_inputs(W, 6, K)
    got = tgk.window_gibbs(*(_t(a) for a in args.values()), 1.0)
    want = jax_window_gibbs(*(jnp.asarray(a) for a in args.values()), 1.0,
                            interpret=True)
    assert got[2].dtype == torch.int32
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for i in (0, 1, 3):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   atol=2e-5)
    inactive = args["act"] == 0
    assert np.all(got[2].numpy()[inactive] == 0)
    assert np.all(got[1].numpy()[inactive] == 0)


def _planes_pair(missing, seed, m=M, nb=NB):
    """The port's planes (individual order) and the JAX package's
    (flat-deinterleaved, from the PLINK-coded bytes) of the same rows."""
    pk, eps, _, _, _ = make_inputs(m, nb, seed, missing, 3)
    mine = tpl.build_planes(_t(pk))
    theirs = jpl.build_planes_host(unhpack_bytes(pk))
    return pk, eps, mine, theirs


def test_build_planes_matches_jax():
    _, _, mine, theirs = _planes_pair(True, 7)
    assert mine.dtype == torch.int8 and tuple(mine.shape) == (M, 4 * NB)
    relaid = theirs.reshape(M, 4, NB).transpose(0, 2, 1).reshape(M, -1)
    np.testing.assert_array_equal(mine.numpy(), relaid)


def _check_planes_against_jax(W, nb):
    """window_stats_planes (rtol 1e-5, atol 1e-4) and window_axpy_planes
    (atol 1e-6) against the JAX kernels in interpret mode, on W rows drawn
    from max(24, 2 W) of 4 nb individuals."""
    m = max(M, 2 * W)
    pk, eps, mine, theirs = _planes_pair(False, 8, m, nb)
    rows = _rows(W, 9, m)
    s1 = tpl.window_stats_planes(mine, _t(eps), _t(rows))
    want = jpl.window_stats_planes(
        jnp.asarray(theirs[rows]),
        jwk.deinterleave(jnp.asarray(eps)).reshape(1, -1), interpret=True)
    np.testing.assert_allclose(s1.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    c1 = (np.random.RandomState(10).randn(W) * 0.05).astype(np.float32)
    d = tpl.window_axpy_planes(mine, _t(c1), _t(rows))
    want = jwk.interleave(jpl.window_axpy_planes(
        jnp.asarray(theirs[rows]), jnp.asarray(c1),
        interpret=True).reshape(4, nb))
    np.testing.assert_allclose(d.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("W", [1, 16, 8, 33, 64])
def test_planes_kernels_match_jax(W):
    """The planes' plain versions against the JAX kernels on 512
    individuals, one (short) stats tile."""
    _check_planes_against_jax(W, NB)


@pytest.mark.parametrize("W", [8, 33])
def test_planes_kernels_match_jax_ragged_tiles(W):
    """The same on 2,560 individuals: a whole 2,048-individual stats tile
    and a ragged last one of 512."""
    _check_planes_against_jax(W, 640)


# ---------------------------------------------------------------- sweeps --

def _jax_marker_noise(seed, it, m_loc):
    """The JAX sampler's draws for iteration `it` on the marker schedule
    (samplers/bayesrrm.py:249-277), handed to the port."""
    key = jax.random.fold_in(jax.random.key(seed), it)

    def site(s):
        return jax.random.fold_in(key, s)

    f32 = jnp.float32
    return {k: _t(np.array(v)) for k, v in dict(
        mu=jax.random.normal(site(0), (), f32),
        u=jax.random.uniform(site(1), (m_loc,), f32),
        nrm=jax.random.normal(site(2), (m_loc,), f32),
        perm=jax.random.permutation(jax.random.fold_in(site(6), 0),
                                    m_loc)).items()}


def _compare(a, b, atol=5e-5):
    """Port state a vs JAX state b (numpy dicts)."""
    np.testing.assert_array_equal(a["components"], b["components"])
    for name in ("mu", "eps", "beta", "acum"):
        np.testing.assert_allclose(a[name], b[name], atol=atol, rtol=0)


def _one_sweep(j, t, it=3):
    sj = j.init_state()
    xj = {k: np.asarray(getattr(sj, k)) for k in STATE_FIELDS}
    noise = _jax_marker_noise(j.seed, it, j.cfg.m_loc)
    sj2, stats_j = j.step(sj, it)
    st2, stats_t = t.step(state_from_numpy(xj, "cpu"), it, noise=noise)
    np.testing.assert_array_equal(stats_t.cass.numpy(),
                                  np.asarray(stats_j.cass))
    _compare(state_to_numpy(st2),
             {k: np.asarray(getattr(sj2, k)) for k in STATE_FIELDS})
    return st2


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("missing_frac", [0.0, 0.03])
def test_mega_off_sweep_matches_jax(exact, missing_frac):
    """W = 16, 150 markers in 160 slots (pad slots can head a window)."""
    ds, _, _ = simulate(m=150, n=400, h2=0.5, seed=5,
                        missing_frac=missing_frac)
    j = JaxBayesRRm(ds, window=16, exact=exact, seed=7, mesh=make_mesh(1),
                    mega="off")
    t = BayesRRm(ds, window=16, exact=exact, seed=7, device="cpu",
                 mega="off")
    assert t.cfg.per_window and not j.cfg.use_mega
    assert t.cfg.schedule == j.cfg.schedule == "marker"
    assert t.cfg.m_loc == j.cfg.m_loc == 160
    _one_sweep(j, t)


@pytest.mark.parametrize("window,exact,mega,missing_frac", [
    (1, True, "off", 0.0),         # per-window branch, one marker a window
    (4, False, "off", 0.03),
    (1, False, "auto", 0.03),      # the whole-sweep kernels below W = 8
    (4, True, "auto", 0.0),
])
def test_small_window_sweep_matches_jax(window, exact, mega, missing_frac):
    ds, _, _ = simulate(m=96, n=300, h2=0.5, seed=6,
                        missing_frac=missing_frac)
    j = JaxBayesRRm(ds, window=window, exact=exact, seed=3,
                    mesh=make_mesh(1), mega=mega)
    t = BayesRRm(ds, window=window, exact=exact, seed=3, device="cpu",
                 mega=mega)
    assert t.cfg.per_window == (mega == "off")
    assert t.cfg.schedule == j.cfg.schedule == "marker"
    _one_sweep(j, t)


def test_planes_sweep_matches_jax():
    """--cache-planes on (stale W = 16, complete data) against the JAX
    use_planes path (tests/test_planes.py's recipe, interpret mode)."""
    ds, _, _ = simulate(m=150, n=400, h2=0.5, seed=5)
    j = JaxBayesRRm(ds, window=16, exact=False, seed=7, mesh=make_mesh(1))
    j.cfg = dataclasses.replace(j.cfg, use_planes=True, use_mega=False,
                                interpret=True)
    j.planes = jax.device_put(
        jpl.build_planes_host(unhpack_bytes(np.asarray(j.packed))),
        NamedSharding(j.mesh, P(marker_axes(1), None)))
    j._step = j._build_step()
    t = BayesRRm(ds, window=16, exact=False, seed=7, device="cpu",
                 plane_cache="on")
    assert t.cfg.planes and t.cfg.per_window and t.cfg.schedule == "marker"
    _one_sweep(j, t)


@pytest.mark.parametrize("exact,missing_frac", [(True, 0.03), (False, 0.0)])
def test_per_window_matches_whole_sweep(exact, missing_frac):
    """The port's two branches on the same marker order and noise: the
    same chain up to f32 summation order (exact: also the stale draw's
    normalized form against the kernel's, which agree off ties)."""
    ds, _, _ = simulate(m=150, n=400, h2=0.5, seed=8,
                        missing_frac=missing_frac)
    states = []
    for mega in ("off", "auto"):
        t = BayesRRm(ds, window=16, exact=exact, seed=2, device="cpu",
                     mega=mega, schedule="marker")
        st = t.init_state()
        for it in range(2):
            st, stats = t.step(st, it)
        states.append((state_to_numpy(st), stats.cass.numpy()))
    (a, ca), (b, cb) = states
    np.testing.assert_array_equal(ca, cb)
    _compare(a, b, atol=1e-4)


def test_exact_is_window_invariant():
    """Exact W = 1 (the whole-sweep kernel) and W = 16 (the per-window
    branch) on --schedule marker walk the same markers in the same order
    with the same draws: the same chain over 3 sweeps."""
    ds, _, _ = simulate(m=160, n=300, h2=0.5, seed=9)
    assert ds.geno.m == 160                    # no pad slots at W = 16
    states = []
    for window, mega in ((1, "auto"), (16, "off")):
        t = BayesRRm(ds, window=window, exact=True, seed=4, device="cpu",
                     mega=mega, schedule="marker")
        st = t.init_state()
        for it in range(3):
            st, _ = t.step(st, it)
        states.append(state_to_numpy(st))
    _compare(*states, atol=1e-4)
