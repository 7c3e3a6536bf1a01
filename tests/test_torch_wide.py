"""The port's former kernel limits against the JAX package (CPU): windows
above 1,024 markers, more than 16 mixture components and more than 16
traits, which the CUDA kernels now run in their wide arms (pieces of the
exact chain, coefficients staged a chunk at a time, the draws' constants
read in place, trait groups; csrc/sweep_kernel.cuh). On the CPU the
wrappers run their plain versions, which loop over any W, K and T; these
tests hold them, and the samplers and CLI around them, to the JAX package
at those sizes with the tolerances of the tests at the sizes below
(tests/test_torch_sweep_kernel.py, test_torch_sweep_kernel_mt.py,
test_torch_window_path.py, test_torch_bayesw.py, test_torch_bayesrrm_mt.py),
components equal. The card tests of the wide arms are the
``test_cuda_wide_*`` cases of tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydra_tpu.ops import sweep_kernel as jsk
from hydra_tpu.ops import sweep_kernel_mt as jskmt
from hydra_tpu.ops.gibbs_kernel import window_gibbs as jax_window_gibbs
from hydra_tpu.ops.window_kernels import (deinterleave, deinterleave_mt,
                                          interleave, interleave_mt)
from hydra_tpu.parallel.mesh import make_mesh
from hydra_tpu.samplers.bayesw import BayesW as JaxBayesW
from hydra_tpu_torch.ops import gibbs_kernel as tgk
from hydra_tpu_torch.ops import sweep_kernel as tsk
from hydra_tpu_torch.ops import sweep_kernel_mt as tskmt
from hydra_tpu_torch.samplers.bayesrrm import BayesRRm, state_to_numpy
from hydra_tpu_torch.samplers.bayesrrm_mt import BayesRRmMT
from hydra_tpu_torch.samplers.bayesw import BayesW

from tests.test_bayesrrm import simulate
from tests.test_bayesrrm_mt import simulate_mt
from tests.test_torch_bayesrrm_mt import (_jax_noise as _jax_mt_noise,
                                          _jax_sampler as _jax_mt_sampler,
                                          _jax_state_numpy)
from tests.test_torch_bayesw import _dataset as _bw_dataset
from tests.test_torch_bayesw import _jax_noise as _jax_bw_noise
from tests.test_torch_bayesw import _jax_numpy as _jax_bw_numpy
from tests.test_torch_cuda import (make_inputs, make_mt_inputs,
                                   mt_recurrence_inputs)
from tests.test_torch_window_path import _gibbs_inputs, _t

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)

WIDE_K = 20
T20 = 20


def _assert_sweep(e_t, o_t, e_j, o_j, comp):
    """tests/test_torch_sweep_kernel.py's tolerances: eps and the real
    outputs at atol 5e-4 / rtol 1e-3, components (columns ``comp``)
    equal."""
    np.testing.assert_allclose(e_t, e_j, atol=5e-4, rtol=1e-3)
    np.testing.assert_array_equal(o_t[:, comp], o_j[:, comp])
    np.testing.assert_allclose(o_t, o_j, atol=5e-4, rtol=1e-3)


def _single_sweep_vs_jax(exact, missing, window, n_mix, m, seed, miss_frac):
    nb = 128
    pk, eps, mask, mrow, n = make_inputs(m, nb, seed, missing, 11, k=n_mix,
                                         miss_frac=miss_frac)
    wp = np.random.RandomState(seed).permutation(m // window).astype(
        np.int32)
    i2se, dnm1 = 0.7, float(n - 1)
    kw = dict(window=window, n_mix=n_mix, complete=not missing,
              ind_mask4=jnp.asarray(deinterleave(mask)), interpret=True,
              win_perm=jnp.asarray(wp))
    args = (jnp.asarray(pk), deinterleave(jnp.asarray(eps)), jnp.asarray(mrow))
    if exact:
        e_j, o_j = jsk.sweep_exact(*args, jnp.asarray(mrow[:, :2]),
                                   jnp.float32(i2se), jnp.float32(dnm1), **kw)
    else:
        e_j, o_j = jsk.sweep_stale(*args, jnp.asarray(i2se, jnp.float32),
                                   jnp.float32(dnm1), **kw)
    fn = tsk.sweep_exact if exact else tsk.sweep_stale
    before = dict(tsk.launches)
    e_t, o_t = fn(torch.from_numpy(pk), torch.from_numpy(eps),
                  torch.from_numpy(mrow), i2se, dnm1, window=window,
                  n_mix=n_mix, complete=not missing,
                  ind_mask=torch.from_numpy(mask),
                  order=tsk.block_order(torch.from_numpy(wp), window))
    assert tsk.launches == before        # CPU tensors: plain version only
    e_t, o_t = e_t.numpy(), o_t.numpy()
    _assert_sweep(e_t, o_t, np.asarray(interleave(e_j)), np.asarray(o_j), 1)
    assert len(np.unique(o_t[:, 1])) >= 3
    assert np.all(e_t[n:] == 0.0)


@pytest.mark.parametrize("exact,missing", [(True, False), (False, True)])
def test_sweep_w2048_matches_jax(exact, missing):
    """One BayesRRm sweep at W = 2,048 (M = 4,096, N = 512, two windows in
    a permuted order): exact on complete genotypes, stale on 3% missing
    calls, against the JAX kernels in interpret mode."""
    _single_sweep_vs_jax(exact, missing, 2048, 4, 4096, 21, 0.03)


@pytest.mark.parametrize("exact,missing", [(False, False), (False, True),
                                           (True, False), (True, True)])
def test_sweep_k20_matches_jax(exact, missing):
    """Stale and exact sweeps at K = 20 (a 19-value --S grid), complete and
    5% missing calls, W = 32 over 128 markers."""
    _single_sweep_vs_jax(exact, missing, 32, WIDE_K, 128, 30 + 2 * exact
                         + missing, 0.05)


@pytest.mark.parametrize("W,K", [(1536, 4), (64, WIDE_K)])
def test_window_gibbs_wide_matches_jax(W, K):
    """window_gibbs at W = 1,536 (a piece of 1,024 and one of 512 on the
    card) and at K = 20 against the JAX kernel in interpret mode:
    test_window_gibbs_matches_jax's tolerances, components equal."""
    args = _gibbs_inputs(W, 6, K)
    got = tgk.window_gibbs(*(_t(a) for a in args.values()), 1.0)
    want = jax_window_gibbs(*(jnp.asarray(a) for a in args.values()), 1.0,
                            interpret=True)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for i in (0, 1, 3):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   atol=2e-5)
    assert len(np.unique(got[2].numpy())) >= 3


def test_planes_w2048_match_jax():
    """The planes kernels' plain versions at W = 2,048 against the JAX
    kernels in interpret mode on 2,048 of 4,096 rows of 512 individuals:
    window_stats_planes within test_torch_window_path's tolerances (rtol
    1e-5, atol 1e-4). window_axpy_planes' atol there (1e-6) is the rounding
    of a 16..64-row sum; a 2,048-row sum in two orders (the port's row
    order, the JAX kernel's product) differs by up to the forward error
    bound of f32 summation, 2 W u sum_r |c1_r g_ri| (u = 2^-24), so each
    individual is held to that bound, and the port's sum also to its own
    one-sided bound against the sum in float64."""
    import hydra_tpu.ops.planes as jpl
    from hydra_tpu.ops import window_kernels as jwk
    from hydra_tpu_torch.ops import planes as tpl
    from tests.test_torch_window_path import _planes_pair, _rows
    W, nb = 2048, 128
    pk, eps, mine, theirs = _planes_pair(False, 8, 2 * W, nb)
    rows = _rows(W, 9, 2 * W)
    s1 = tpl.window_stats_planes(mine, _t(eps), _t(rows))
    want = jpl.window_stats_planes(
        jnp.asarray(theirs[rows]),
        jwk.deinterleave(jnp.asarray(eps)).reshape(1, -1), interpret=True)
    np.testing.assert_allclose(s1.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    c1 = (np.random.RandomState(10).randn(W) * 0.05).astype(np.float32)
    d = tpl.window_axpy_planes(mine, _t(c1), _t(rows)).numpy()
    want = np.asarray(jwk.interleave(jpl.window_axpy_planes(
        jnp.asarray(theirs[rows]), jnp.asarray(c1),
        interpret=True).reshape(4, nb)))
    g = mine.numpy()[rows].astype(np.float64)
    exact = c1.astype(np.float64) @ g
    bound = W * 2.0 ** -24 * (np.abs(c1.astype(np.float64)) @ np.abs(g))
    assert np.all(np.abs(d - exact) <= bound)
    assert np.all(np.abs(d - want) <= 2 * bound)


def _mt_sweep_vs_jax(exact, na_frac, window, n_mix, seed, m=64):
    nb, T = 128, T20
    pk, eps, tm, mrow, dnm1 = make_mt_inputs(m, nb, T, seed, False, 3,
                                             na_frac, shared_stats=exact,
                                             k=n_mix)
    i2se = np.linspace(0.6, 0.9, T).astype(np.float32)
    wp = np.random.RandomState(seed).permutation(m // window).astype(
        np.int32)
    kw = dict(window=window, n_mix=n_mix, n_traits=T, interpret=True,
              win_perm=jnp.asarray(wp))
    args = (jnp.asarray(pk), deinterleave_mt(jnp.asarray(eps)),
            deinterleave_mt(jnp.asarray(tm)), jnp.asarray(mrow),
            jnp.asarray(i2se), jnp.asarray(dnm1))
    if exact:
        e_j, o_j = jskmt.sweep_exact_mt(*args, **kw)
    else:
        e_j, o_j = jskmt.sweep_stale_mt(*args, complete=True, **kw)
    t_args = [torch.from_numpy(a) for a in (pk, eps, tm, mrow, i2se, dnm1)]
    order = tsk.block_order(torch.from_numpy(wp), window)
    if exact:
        e_t, o_t = tskmt.sweep_exact_mt(*t_args, window=window, n_mix=n_mix,
                                        order=order)
    else:
        e_t, o_t = tskmt.sweep_stale_mt(*t_args, window=window, n_mix=n_mix,
                                        complete=True, order=order)
    e_t, o_t = e_t.numpy(), o_t.numpy()
    _assert_sweep(e_t, o_t, np.asarray(interleave_mt(e_j, T)),
                  np.asarray(o_j), slice(T, 2 * T))
    assert len(np.unique(o_t[:, T:2 * T])) >= 3
    assert np.all(e_t[tm == 0.0] == 0.0)


@pytest.mark.parametrize("exact,na_frac,n_mix", [(False, 0.1, 4),
                                                 (True, 0.0, 4),
                                                 (False, 0.0, WIDE_K)])
def test_sweep_mt_t20_matches_jax(exact, na_frac, n_mix):
    """Multi-trait whole sweeps at T = 20 (two groups of traits on the
    card) against the JAX kernels in interpret mode: stale with 10% NaN per
    trait, exact with full phenotypes (the whole-sweep kernel's domain),
    and stale at K = 20."""
    _mt_sweep_vs_jax(exact, na_frac, 16, n_mix, 40 + n_mix + int(exact))


def test_mt_exact_nan_t20_sweep_matches_jax():
    """The exact per-window path at T = 20 with 10% NaN per trait
    (window_stats_mt, the masked per-trait Gram, mt_window_recurrence,
    window_axpy_mt) against the JAX sampler, one sweep with its own draws:
    test_one_sweep_matches_jax's tolerances."""
    from hydra_tpu_torch.samplers.bayesrrm_mt import state_from_numpy
    ds, phenos, _ = simulate_mt(m=40, n=300, n_traits=T20, seed=13,
                                na_frac=0.1)
    seed, it = 7, 2
    j = _jax_mt_sampler(ds, phenos, 8, True, seed, "marker", False)
    t = BayesRRmMT(ds, phenos, window=8, exact=True, seed=seed, device="cpu")
    assert t.cfg.schedule == "marker" and not t.cfg.full_pheno
    sj = j.init_state()
    st = state_from_numpy(_jax_state_numpy(sj), "cpu")
    sj2, stats_j = j.step(sj, it)
    st2, stats_t = t.step(st, it, noise=_jax_mt_noise(seed, it, j.cfg))
    for name in ("eps", "beta", "acum"):
        np.testing.assert_allclose(getattr(st2, name).numpy(),
                                   np.asarray(getattr(sj2, name)),
                                   atol=5e-4, rtol=1e-3, err_msg=name)
    np.testing.assert_array_equal(st2.components.numpy(),
                                  np.asarray(sj2.components))
    np.testing.assert_array_equal(stats_t.cass.numpy(),
                                  np.asarray(stats_j.cass))


def test_bayesw_step_w2048_matches_jax():
    """One BayesW step at W = 2,048 (2,048 markers in one window, 3%
    missing calls, 20% censored) against the JAX per-window path with its
    own draws: test_one_step_matches_jax's tolerances."""
    from hydra_tpu_torch.samplers.bayesw import state_from_numpy
    ds, *_ = _bw_dataset(2048, 240, 13, 0.03, censor_frac=0.2)
    seed, it = 7, 2
    j = JaxBayesW(ds, window=2048, seed=seed, mesh=make_mesh(1),
                  quad_points=9, schedule="block")
    t = BayesW(ds, window=2048, seed=seed, quad_points=9, device="cpu",
               schedule="block")
    assert t.cfg.m_loc == j.cfg.m_loc == 2048
    sj = j.init_state()
    st = state_from_numpy(_jax_bw_numpy(sj), "cpu")
    noise = _jax_bw_noise(seed, it, j.cfg.m_loc, j.cfg.n_windows, "block")
    sj2, stats_j = j.step(sj, it)
    st2, stats_t = t.step(st, it, noise=noise)
    np.testing.assert_allclose(float(st2.mu), float(sj2.mu), rtol=1e-5)
    np.testing.assert_allclose(float(st2.alpha), float(sj2.alpha), rtol=1e-5)
    np.testing.assert_allclose(st2.eps.numpy(), np.asarray(sj2.eps),
                               atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(st2.beta.numpy(), np.asarray(sj2.beta),
                               atol=5e-4, rtol=1e-3)
    np.testing.assert_array_equal(st2.components.numpy(),
                                  np.asarray(sj2.components))
    np.testing.assert_array_equal(stats_t.cass.numpy(),
                                  np.asarray(stats_j.cass))
    assert int((st2.components.numpy() > 0).sum()) >= 2


def test_exact_w2048_is_the_w64_chain():
    """Exact W = 2,048 and W = 64 on --schedule marker walk the same
    markers in the same order with the same draws (exact mode's window
    invariance): the same chain over 2 sweeps, as
    test_torch_window_path.py::test_exact_is_window_invariant checks at
    W = 1 and 16."""
    ds, _, _ = simulate(m=2048, n=300, h2=0.5, seed=9)
    states = []
    for window in (2048, 64):
        t = BayesRRm(ds, window=window, exact=True, seed=4, device="cpu",
                     schedule="marker")
        assert t.cfg.m_loc == 2048 and not t.cfg.per_window
        st = t.init_state()
        for it in range(2):
            st, _ = t.step(st, it)
        states.append(state_to_numpy(st))
    a, b = states
    np.testing.assert_array_equal(a["components"], b["components"])
    for name in ("mu", "eps", "beta", "acum"):
        np.testing.assert_allclose(a[name], b[name], atol=1e-4, rtol=0)


@pytest.mark.parametrize("source", ["sweep", "per_trait"])
def test_knife_edge_witness_takes_the_chains_draws(source):
    """The float64 witness of the card's knife-edge cases
    (sweep_kernel_mt.recurrence_edge and sweep_exact_mt_edge, which replay
    a chain from its own history) on the plain version's chains, W = 64,
    T = 3, K = 20 (the sweep: both windows, the second after the first's
    update): at every step of two traits it takes the chain's own
    component, and never a component K / 2 away."""
    W, T, K = 64, 3, WIDE_K
    args, kw = mt_recurrence_inputs(source, W, T, K, torch.device("cpu"))
    if source == "sweep":
        _, out = tskmt.sweep_exact_mt_ref(*args, **kw)
        comp = out[kw["order"].long(), T:2 * T]

        def edge(w, j, t, comps):
            return tskmt.sweep_exact_mt_edge(*args, out, w=w, j=j, t=t,
                                             comps=comps, **kw)
        windows = (0, 1)
    else:
        gram, num0, mrow, i2se = args
        _, comp, _, db = tskmt.mt_window_recurrence_ref(*args, **kw)
        blk = mrow[kw["rows"].long()].reshape(W, -1, T)

        def edge(w, j, t, comps):
            return tskmt.recurrence_edge(gram[t, j], num0[j, t], db[:j, t],
                                         blk[j, :, t], i2se[t], K, comps)
        windows = (0,)
    assert len(torch.unique(comp)) >= 3
    for w in windows:
        for t in (0, T - 1):
            for j in range(W):
                c = int(comp[w * W + j, t])
                assert edge(w, j, t, (c,)), (w, j, t)
                assert not edge(w, j, t, ((c + K // 2) % K,)), (w, j, t)
