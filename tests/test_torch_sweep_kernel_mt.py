"""Port multi-trait kernels vs the JAX Pallas kernels (interpret mode, CPU).

The same numpy inputs (``tests/test_torch_cuda.make_mt_inputs``) go through
the JAX kernels (plane-major residual and trait mask, converted with
``deinterleave_mt`` / ``interleave_mt`` on the JAX side only,
``interpret=True``) and the port's plain versions, which the wrappers take
for CPU tensors. Tolerances are those of tests/test_sweep_kernel_mt.py:
eps and beta at atol 5e-4 / rtol 1e-3 (f32 summation order differs),
components exactly equal. The window kernels compare at rtol 1e-5 /
atol 1e-4 (a handful of f32 sums over 512 individuals).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydra_tpu.ops import sweep_kernel_mt as jskmt
from hydra_tpu.ops import window_kernels as jwk
from hydra_tpu.ops.gibbs_kernel import window_gibbs
from hydra_tpu.ops.window_kernels import deinterleave_mt, interleave_mt
from hydra_tpu_torch.ops import sweep_kernel_mt as tskmt
from hydra_tpu_torch.ops import window_kernels as twk
from hydra_tpu_torch.ops.decode import decode_planes_hp
from hydra_tpu_torch.ops.sweep_kernel import block_order

from tests.test_torch_cuda import K, make_mt_inputs, stale_mt_f64

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)

T = 3

SWEEP_CASES = [
    # (exact, missing genotypes, NaN fraction, win_perm, pad markers, W)
    (False, False, 0.0, True, 5, 16),
    (False, True, 0.1, True, 5, 16),
    (False, False, 0.1, False, 0, 32),
    (True, False, 0.0, True, 5, 16),
    (True, False, 0.0, False, 3, 32),
]


def _sweep_vs_jax(exact, missing, na_frac, use_perm, n_pads, window, seed,
                  m=64, n_mix=K):
    """One multi-trait sweep of the JAX kernel and of the port's wrapper on
    CPU tensors (its plain version) from the same numpy inputs."""
    nb = 128
    pk, eps, tm, mrow, dnm1 = make_mt_inputs(m, nb, T, seed, missing, n_pads,
                                             na_frac, shared_stats=exact,
                                             k=n_mix)
    i2se = np.array([0.6, 0.7, 0.8], np.float32)
    wp = (np.random.RandomState(5).permutation(m // window).astype(np.int32)
          if use_perm else None)
    kw = dict(window=window, n_mix=n_mix, n_traits=T, interpret=True,
              win_perm=None if wp is None else jnp.asarray(wp))
    args = (jnp.asarray(pk), deinterleave_mt(jnp.asarray(eps)),
            deinterleave_mt(jnp.asarray(tm)), jnp.asarray(mrow),
            jnp.asarray(i2se), jnp.asarray(dnm1))
    if exact:
        e_j, o_j = jskmt.sweep_exact_mt(*args, **kw)
    else:
        e_j, o_j = jskmt.sweep_stale_mt(*args, complete=not missing, **kw)
    e_j, o_j = np.asarray(interleave_mt(e_j, T)), np.asarray(o_j)

    t_args = [torch.from_numpy(a) for a in (pk, eps, tm, mrow, i2se, dnm1)]
    order = None if wp is None else block_order(torch.from_numpy(wp), window)
    before = dict(tskmt.launches)
    if exact:
        e_t, o_t = tskmt.sweep_exact_mt(*t_args, window=window, n_mix=n_mix,
                                        order=order)
    else:
        e_t, o_t = tskmt.sweep_stale_mt(*t_args, window=window, n_mix=n_mix,
                                        complete=not missing, order=order)
    assert tskmt.launches == before      # CPU tensors: plain version only
    e_t, o_t = e_t.numpy(), o_t.numpy()
    np.testing.assert_allclose(e_t, e_j, atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(o_t[:, :T], o_j[:, :T], atol=5e-4, rtol=1e-3)
    np.testing.assert_array_equal(o_t[:, T:2 * T], o_j[:, T:2 * T])
    np.testing.assert_allclose(o_t[:, 2 * T:], o_j[:, 2 * T:], atol=5e-4,
                               rtol=1e-3)
    # the draws did something; pads and NaN entries stay zero
    assert len(np.unique(o_t[:, T:2 * T])) >= min(3, n_mix)
    assert np.all(e_t[tm == 0.0] == 0.0)


@pytest.mark.parametrize("exact,missing,na_frac,use_perm,n_pads,window",
                         SWEEP_CASES)
def test_sweep_mt_matches_jax(exact, missing, na_frac, use_perm, n_pads,
                              window):
    _sweep_vs_jax(exact, missing, na_frac, use_perm, n_pads, window,
                  3 + window)


@pytest.mark.parametrize("window", [24, 40])
@pytest.mark.parametrize("n_mix", [2, 5])
def test_sweep_exact_mt_any_components_matches_jax(n_mix, window):
    """The exact sweep's plain version, which the card holds the CUDA
    exact_mt_draw_kernel against, pinned to the JAX kernel at mixture sizes
    beside the default K = 4 (the kernel's register bounds 8 and K_MAX) and
    at windows that are not a multiple of the kernel's 32-marker blocks
    (W=40: a ragged second block)."""
    _sweep_vs_jax(True, False, 0.0, window == 24, 3, window, 40 + n_mix,
                  m=2 * window, n_mix=n_mix)


@pytest.mark.parametrize("n_traits", [1, 4])
def test_stale_mt_f64_witness_matches_jax(n_traits):
    """The float64 stale sweep that the card test takes as the witness of a
    knife-edge case (test_torch_cuda.stale_mt_f64) against the JAX
    sweep_stale_mt in interpret mode, complete genotypes and full
    phenotypes at the case's mixture size K=16: components equal, eps and
    beta within the sweep tolerance."""
    m, nb, window, n_mix = 64, 128, 32, 16
    pk, eps, tm, mrow, dnm1 = make_mt_inputs(m, nb, n_traits, 50 + n_traits,
                                             False, 3, k=n_mix)
    i2se = np.linspace(0.6, 0.9, n_traits).astype(np.float32)
    wp = np.random.RandomState(5).permutation(m // window).astype(np.int32)
    e_j, o_j = jskmt.sweep_stale_mt(
        jnp.asarray(pk), deinterleave_mt(jnp.asarray(eps)),
        deinterleave_mt(jnp.asarray(tm)), jnp.asarray(mrow),
        jnp.asarray(i2se), jnp.asarray(dnm1), complete=True, window=window,
        n_mix=n_mix, n_traits=n_traits, interpret=True,
        win_perm=jnp.asarray(wp))
    e_j, o_j = np.asarray(interleave_mt(e_j, n_traits)), np.asarray(o_j)
    e_w, o_w = stale_mt_f64(
        *(torch.from_numpy(a) for a in (pk, eps, tm, mrow, i2se, dnm1)),
        window=window, n_mix=n_mix,
        order=block_order(torch.from_numpy(wp), window))
    e_w, o_w = e_w.numpy(), o_w.numpy()
    T = n_traits
    np.testing.assert_allclose(e_w, e_j, atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(o_w[:, :T], o_j[:, :T], atol=5e-4, rtol=1e-3)
    np.testing.assert_array_equal(o_w[:, T:2 * T], o_j[:, T:2 * T])
    np.testing.assert_allclose(o_w[:, 2 * T:], o_j[:, 2 * T:], atol=5e-4,
                               rtol=1e-3)
    assert len(np.unique(o_w[:, T:2 * T])) >= 3


@pytest.mark.parametrize("missing,na_frac", [(False, 0.1), (True, 0.0)])
def test_window_stats_mt_matches_jax(missing, na_frac):
    pk, eps, tm, _, _ = make_mt_inputs(48, 128, T, 7, missing, 0, na_frac)
    rows = np.random.RandomState(1).permutation(48)[:16].astype(np.int32)
    s_j = jwk.window_stats_mt(jnp.asarray(pk[rows]),
                              deinterleave_mt(jnp.asarray(eps)), T,
                              interpret=True, complete=not missing)
    before = dict(twk.launches)
    s_t = twk.window_stats_mt(torch.from_numpy(pk), torch.from_numpy(eps),
                              complete=not missing,
                              rows=torch.from_numpy(rows))
    assert twk.launches == before
    for a, b in zip(s_t, s_j):
        if b is None:
            assert a is None
            continue
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-4)


@pytest.mark.parametrize("missing", [False, True])
def test_window_axpy_mt_matches_jax(missing):
    pk, _, _, _, _ = make_mt_inputs(16, 128, T, 9, missing, 0)
    rs = np.random.RandomState(2)
    c1 = (rs.randn(T, 16) * 0.05).astype(np.float32)
    c2 = (rs.randn(T, 16) * 0.05).astype(np.float32)
    d_j = interleave_mt(jwk.window_axpy_mt(
        jnp.asarray(pk), jnp.asarray(c1), jnp.asarray(c2), interpret=True,
        complete=not missing), T)
    d_t = twk.window_axpy_mt(torch.from_numpy(pk), torch.from_numpy(c1),
                             torch.from_numpy(c2), complete=not missing)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("shared", [False, True])
def test_recurrence_matches_window_gibbs(shared):
    """The per-window recurrence against the JAX window_gibbs kernel, trait
    by trait: a standardized Gram of real genotypes under the trait masks,
    num0 from the residual. window_gibbs draws in the exact-kernel form,
    the recurrence in the sampler's normalized form; the two agree to
    rounding, and components exactly on these inputs."""
    W = 16
    pk, eps, tm, mrow, dnm1 = make_mt_inputs(W, 128, T, 11, True, 2, 0.1,
                                             shared_stats=shared)
    if shared:
        tm[:] = tm[:, :1]
        eps = (eps * tm).astype(np.float32)
    b = mrow.reshape(W, -1, T)
    g, msk = decode_planes_hp(torch.from_numpy(pk))
    g, msk = g.numpy(), msk.numpy()
    xt = (g[None] - b[:, 0].T[:, :, None] * msk[None]) * b[:, 1].T[:, :, None]
    gram = np.einsum("twn,tvn->twv", xt * tm.T[:, None, :], xt)
    num0 = (np.einsum("twn,nt->wt", xt, eps) + b[:, 2] * dnm1).astype(
        np.float32)
    i2se = np.array([0.6, 0.7, 0.8], np.float32)
    gram_t = torch.from_numpy((gram[0] if shared else gram).astype(np.float32))
    before = dict(tskmt.launches)
    bnew, comp, acum, db = tskmt.mt_window_recurrence(
        gram_t, torch.from_numpy(num0), torch.from_numpy(mrow),
        torch.from_numpy(i2se), n_mix=K)
    assert tskmt.launches == before
    for t in range(T):
        bt = b[:, :, t]
        db_j, b_j, c_j, a_j = window_gibbs(
            jnp.asarray(gram[0 if shared else t]), jnp.asarray(num0[:, t]),
            jnp.asarray(bt[:, 6:6 + K]), jnp.asarray(bt[:, 6 + K:5 + 2 * K]),
            jnp.asarray(bt[:, 5 + 2 * K:]), jnp.asarray(bt[:, 3]),
            jnp.asarray(bt[:, 4]), jnp.asarray(bt[:, 5]),
            jnp.asarray(bt[:, 2]), float(i2se[t]), interpret=True)
        np.testing.assert_array_equal(comp[:, t].numpy(), np.asarray(c_j))
        for x, y in ((bnew, b_j), (acum, a_j), (db, db_j)):
            np.testing.assert_allclose(x[:, t].numpy(), np.asarray(y),
                                       atol=5e-4, rtol=1e-3)
    assert len(np.unique(comp.numpy())) >= 3


def test_wrappers_reject_bad_operands():
    pk, eps, tm, mrow, dnm1 = (torch.from_numpy(a) for a in
                               make_mt_inputs(32, 128, T, 1, False, 0))
    i2se = torch.full((T,), 0.5)
    kw = dict(n_mix=K, complete=True)
    with pytest.raises(ValueError, match="multiple of window"):
        tskmt.sweep_stale_mt(pk, eps, tm, mrow, i2se, dnm1, window=24, **kw)
    with pytest.raises(ValueError, match="tm must be"):
        tskmt.sweep_stale_mt(pk, eps, tm[:, :2], mrow, i2se, dnm1, window=16,
                             **kw)
    with pytest.raises(ValueError, match="i_2se"):
        tskmt.sweep_exact_mt(pk, eps, tm, mrow, i2se[:2], dnm1, window=16,
                             n_mix=K)
    with pytest.raises(ValueError, match="no sweep kernel"):
        tskmt.sweep_stale_mt(*(a.to("meta") for a in (pk, eps, tm, mrow,
                                                      i2se, dnm1)),
                             window=16, **kw)
    with pytest.raises(ValueError, match="c1 must be"):
        twk.window_axpy_mt(pk[:16], torch.zeros(T, 8), torch.zeros(T, 8))
    with pytest.raises(ValueError, match="gram must be"):
        tskmt.mt_window_recurrence(torch.zeros(8, 8), torch.zeros(16, T),
                                   mrow[:16], i2se, n_mix=K)


@pytest.mark.parametrize("n_traits", [1, 4])
def test_recurrence_unsymmetric_gram_matches_window_gibbs(n_traits):
    """The per-window recurrence's plain version, which the card holds
    window_recurrence_mt_kernel against, against the JAX window_gibbs
    kernel with a per-trait Gram that is deliberately not symmetric. Both
    read G(i, j) with i the marker updated and j the step (window_gibbs
    row j of its Gram for marker j; the JAX scan blocks[..., j]). The
    inputs are checked to tell G from its transpose, so a transposed read
    on either side fails. W=40 crosses the kernel's 32-marker blocks."""
    W, nt = 40, n_traits
    pk, eps, tm, mrow, dnm1 = make_mt_inputs(W, 128, nt, 17 + nt, True, 2,
                                             0.1)
    b = mrow.reshape(W, -1, nt)
    g, msk = decode_planes_hp(torch.from_numpy(pk))
    g, msk = g.numpy(), msk.numpy()
    xt = (g[None] - b[:, 0].T[:, :, None] * msk[None]) * b[:, 1].T[:, :, None]
    gram = np.einsum("twn,tvn->twv", xt * tm.T[:, None, :], xt)
    off = gram[:, ~np.eye(W, dtype=bool)]
    rs = np.random.RandomState(6)
    gram = (gram + 0.3 * off.std() * rs.randn(*gram.shape)).astype(np.float32)
    num0 = (np.einsum("twn,nt->wt", xt, eps) + b[:, 2] * dnm1).astype(
        np.float32)
    i2se = np.array([0.6, 0.7, 0.8, 0.9][:nt], np.float32)
    args = (torch.from_numpy(num0), torch.from_numpy(mrow),
            torch.from_numpy(i2se))
    before = dict(tskmt.launches)
    bnew, comp, acum, db = tskmt.mt_window_recurrence(
        torch.from_numpy(gram), *args, n_mix=K)
    assert tskmt.launches == before
    swapped = tskmt.mt_window_recurrence(
        torch.from_numpy(gram.transpose(0, 2, 1).copy()), *args, n_mix=K)
    assert not torch.equal(swapped[1], comp) or any(
        not torch.allclose(x, y, atol=5e-4, rtol=1e-3)
        for x, y in zip(swapped, (bnew, comp, acum, db)))
    for t in range(nt):
        bt = b[:, :, t]
        db_j, b_j, c_j, a_j = window_gibbs(
            jnp.asarray(gram[t]), jnp.asarray(num0[:, t]),
            jnp.asarray(bt[:, 6:6 + K]), jnp.asarray(bt[:, 6 + K:5 + 2 * K]),
            jnp.asarray(bt[:, 5 + 2 * K:]), jnp.asarray(bt[:, 3]),
            jnp.asarray(bt[:, 4]), jnp.asarray(bt[:, 5]),
            jnp.asarray(bt[:, 2]), float(i2se[t]), interpret=True)
        np.testing.assert_array_equal(comp[:, t].numpy(), np.asarray(c_j))
        for x, y in ((bnew, b_j), (acum, a_j), (db, db_j)):
            np.testing.assert_allclose(x[:, t].numpy(), np.asarray(y),
                                       atol=5e-4, rtol=1e-3)
    assert len(np.unique(comp.numpy())) >= 3


def _mt_window_inputs(n_traits, missing, seed, W=16):
    """A window's rows (W of 48, pad rows among them), the residual with
    10% NaN per trait and coefficients (T, W), zero on pad rows."""
    pk, eps, _, _, _ = make_mt_inputs(48, 128, n_traits, seed, missing, 4,
                                      0.1)
    rows = np.random.RandomState(seed).permutation(48)[:W].astype(np.int32)
    rs = np.random.RandomState(seed + 2)
    c1 = (rs.randn(n_traits, W) * 0.05).astype(np.float32)
    c1[:, (pk[rows] == 0xFF).all(axis=1)] = 0.0
    c2 = (rs.randn(n_traits, W) * 0.05).astype(np.float32)
    return pk, eps, rows, c1, c2


@pytest.mark.parametrize("missing", [False, True])
@pytest.mark.parametrize("n_traits", [1, 4, 16])
def test_stats_mt_partials_match_jax(n_traits, missing):
    """The order-exact stats (stats_mt_partials added tile by tile), which
    the card holds stats_mt_kernel to bit for bit, against the JAX
    window_stats_mt kernel in interpret mode."""
    pk, eps, rows, _, _ = _mt_window_inputs(n_traits, missing, 21 + n_traits)
    s_j = jwk.window_stats_mt(jnp.asarray(pk[rows]),
                              deinterleave_mt(jnp.asarray(eps)), n_traits,
                              interpret=True, complete=not missing)
    s_t = twk.window_stats_mt_seq(torch.from_numpy(pk), torch.from_numpy(eps),
                                  not missing, torch.from_numpy(rows))
    for a, b in zip(s_t, s_j):
        assert (a is None) == (b is None)
        if b is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-4)


@pytest.mark.parametrize("missing", [False, True])
@pytest.mark.parametrize("n_traits", [1, 4, 16])
def test_axpy_mt_rows_match_jax(n_traits, missing):
    """The order-exact axpy (axpy_mt_rows, row by row for each trait),
    which the card holds axpy_mt_kernel to bit for bit, against the JAX
    window_axpy_mt kernel in interpret mode."""
    pk, _, rows, c1, c2 = _mt_window_inputs(n_traits, missing, 31 + n_traits)
    d_j = interleave_mt(jwk.window_axpy_mt(
        jnp.asarray(pk[rows]), jnp.asarray(c1), jnp.asarray(c2),
        interpret=True, complete=not missing), n_traits)
    d_t = twk.window_axpy_mt_seq(torch.from_numpy(pk), torch.from_numpy(c1),
                                 torch.from_numpy(c2), not missing,
                                 torch.from_numpy(rows))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("complete", [False, True])
@pytest.mark.parametrize("n_traits", [1, 4, 16])
def test_order_exact_mt_match_matmul(n_traits, complete):
    """The order-exact multi-trait stats and axpy against the matmul plain
    versions the wrappers take on the CPU, and the exact sweep's partials
    (s1 = sum g*eps, s2 = sum eps, v = sum g) against their matmul forms."""
    pk, eps, rows, c1, c2 = _mt_window_inputs(n_traits, not complete,
                                              41 + n_traits)
    pk, eps, rows, c1, c2 = (torch.from_numpy(a) for a in
                             (pk, eps, rows, c1, c2))
    for a, b in zip(twk.window_stats_mt_seq(pk, eps, complete, rows),
                    twk.window_stats_mt_ref(pk, eps, complete, rows)):
        assert (a is None) == (b is None)
        if b is not None:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(
        twk.window_axpy_mt_seq(pk, c1, c2, complete, rows),
        twk.window_axpy_mt_ref(pk, c1, c2, complete, rows), rtol=1e-5,
        atol=1e-5)
    if complete:
        g, _ = decode_planes_hp(pk[rows.long()])
        p1, p2, pv = twk.stats_mt_partials(pk[rows.long()], eps, True, True)
        assert p1.shape == (16, n_traits, 1) and pv.shape == (16, 1)
        torch.testing.assert_close(p1.sum(-1), g @ eps, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(p2.sum(-1), eps.sum(0).expand(16, -1),
                                   rtol=1e-5, atol=1e-4)
        assert torch.equal(pv[:, 0], g.sum(1))


@pytest.mark.parametrize("kind", ["stale", "stale_missing", "exact"])
def test_sweep_update_mt_ref_replays_sweeps(kind):
    """sweep_update_mt_ref, which the card holds the sweeps' axpy_mt_kernel
    to bit for bit, replays the plain sweeps' residual from their own
    draws (the sweeps' matmul updates add in another order)."""
    exact, missing = kind == "exact", kind == "stale_missing"
    W, m = 16, 64
    pk, eps, tm, mrow, dnm1 = make_mt_inputs(m, 128, T, 51, missing, 5,
                                             0.0 if exact else 0.1,
                                             shared_stats=exact)
    t = [torch.from_numpy(a) for a in (pk, eps, tm, mrow, dnm1)]
    i2se = torch.tensor([0.6, 0.7, 0.8])
    order = block_order(torch.from_numpy(
        np.random.RandomState(3).permutation(m // W)), W)
    if exact:
        e_s, o_s = tskmt.sweep_exact_mt_ref(*t[:4], i2se, t[4], window=W,
                                            n_mix=K, order=order)
    else:
        e_s, o_s = tskmt.sweep_stale_mt_ref(*t[:4], i2se, t[4], window=W,
                                            n_mix=K, complete=not missing,
                                            order=order)
    e_r = twk.sweep_update_mt_ref(t[0], t[1], t[2], t[3], o_s, order, W,
                                  not missing)
    assert not torch.allclose(e_r, t[1], rtol=0, atol=1e-3)   # eps moved
    torch.testing.assert_close(e_r, e_s, rtol=1e-5, atol=1e-5)
    assert torch.all(e_r[t[2] == 0.0] == 0.0)
