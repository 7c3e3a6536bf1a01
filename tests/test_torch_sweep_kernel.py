"""Port sweep kernels vs the JAX Pallas kernels (interpret mode, CPU):
sweep_stale, sweep_exact and the single-decode sweep_stale_sd.

The same numpy inputs (``tests/test_torch_cuda.make_inputs``) go through
``hydra_tpu.ops.sweep_kernel`` (plane-major residual, ``interpret=True``)
and the port's plain versions, which the wrappers take for CPU tensors. Tolerances are those of
tests/test_sweep_kernel.py: eps and beta at atol=5e-4, rtol=1e-3 (f32
summation order differs), components exactly equal.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from hydra_tpu.ops import sweep_kernel as jsk
from hydra_tpu.ops.decode import hpack_bytes as jax_hpack_bytes
from hydra_tpu.ops.window_kernels import deinterleave, interleave
from hydra_tpu_torch.ops import sweep_kernel as tsk
from hydra_tpu_torch.ops.decode import decode_planes, decode_planes_hp, hpack_bytes

from tests.test_torch_cuda import K, make_inputs

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)

CASES = [
    # (exact, missing, win_perm, pad markers, window)
    (False, False, True, 11, 32),
    (False, True, True, 11, 32),
    (True, False, True, 11, 32),
    (True, True, True, 11, 32),
    (False, False, False, 0, 32),
    (True, True, False, 5, 32),
    (True, False, True, 5, 8),
]


@pytest.mark.parametrize("exact,missing,use_perm,n_pads,window", CASES)
def test_sweep_matches_jax(exact, missing, use_perm, n_pads, window):
    m, nb = (128, 128) if window == 32 else (64, 128)
    pk, eps, mask, mrow, n = make_inputs(m, nb, 3 + window + n_pads,
                                         missing, n_pads)
    wp = (np.random.RandomState(5).permutation(m // window).astype(np.int32)
          if use_perm else None)
    i2se, dnm1 = 0.7, float(n - 1)
    kw = dict(window=window, n_mix=K, complete=not missing,
              ind_mask4=jnp.asarray(deinterleave(mask)), interpret=True,
              win_perm=None if wp is None else jnp.asarray(wp))
    args = (jnp.asarray(pk), deinterleave(jnp.asarray(eps)), jnp.asarray(mrow))
    if exact:
        e_j, o_j = jsk.sweep_exact(*args, jnp.asarray(mrow[:, :2]),
                                   jnp.float32(i2se), jnp.float32(dnm1), **kw)
    else:
        e_j, o_j = jsk.sweep_stale(*args, jnp.asarray(i2se, jnp.float32),
                                   jnp.float32(dnm1), **kw)
    e_j, o_j = np.asarray(interleave(e_j)), np.asarray(o_j)

    fn = tsk.sweep_exact if exact else tsk.sweep_stale
    before = dict(tsk.launches)
    e_t, o_t = fn(torch.from_numpy(pk), torch.from_numpy(eps),
                  torch.from_numpy(mrow), i2se, dnm1, window=window, n_mix=K,
                  complete=not missing, ind_mask=torch.from_numpy(mask),
                  order=(None if wp is None
                         else tsk.block_order(torch.from_numpy(wp), window)))
    assert tsk.launches == before        # CPU tensors: plain version only
    e_t, o_t = e_t.numpy(), o_t.numpy()
    np.testing.assert_allclose(e_t, e_j, atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(o_t[:, 0], o_j[:, 0], atol=5e-4, rtol=1e-3)
    np.testing.assert_array_equal(o_t[:, 1], o_j[:, 1])
    np.testing.assert_allclose(o_t[:, 2:], o_j[:, 2:], atol=5e-4, rtol=1e-3)
    # the draws did something: several components in use, pads stay zero
    assert len(np.unique(o_t[:, 1])) >= 3
    assert np.all(e_t[n:] == 0.0)


@pytest.mark.parametrize("n_mix", [2, 16])
@pytest.mark.parametrize("missing", [False, True])
def test_stale_sweep_any_components_matches_jax(missing, n_mix):
    """The plain stale sweep, the card tests' yardstick of the draw that
    the stale axpy kernels fold in, at the mixture sizes below and at the
    draw's register bounds (K 2 and 16 = K_MAX) against the JAX sweep_stale
    in interpret mode: the tolerances of test_sweep_matches_jax, components
    equal."""
    m, nb, window = 128, 128, 32
    pk, eps, mask, mrow, n = make_inputs(m, nb, 40 + n_mix, missing, 7,
                                         k=n_mix)
    wp = np.random.RandomState(9).permutation(m // window).astype(np.int32)
    i2se, dnm1 = 0.7, float(n - 1)
    e_j, o_j = jsk.sweep_stale(
        jnp.asarray(pk), deinterleave(jnp.asarray(eps)), jnp.asarray(mrow),
        jnp.asarray(i2se, jnp.float32), jnp.float32(dnm1), window=window,
        n_mix=n_mix, complete=not missing,
        ind_mask4=jnp.asarray(deinterleave(mask)), interpret=True,
        win_perm=jnp.asarray(wp))
    e_t, o_t = tsk.sweep_stale(
        torch.from_numpy(pk), torch.from_numpy(eps), torch.from_numpy(mrow),
        i2se, dnm1, window=window, n_mix=n_mix, complete=not missing,
        ind_mask=torch.from_numpy(mask),
        order=tsk.block_order(torch.from_numpy(wp), window))
    e_t, o_t = e_t.numpy(), o_t.numpy()
    e_j, o_j = np.asarray(interleave(e_j)), np.asarray(o_j)
    np.testing.assert_allclose(e_t, e_j, atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(o_t[:, 0], o_j[:, 0], atol=5e-4, rtol=1e-3)
    np.testing.assert_array_equal(o_t[:, 1], o_j[:, 1])
    np.testing.assert_allclose(o_t[:, 2:], o_j[:, 2:], atol=5e-4, rtol=1e-3)
    assert len(np.unique(o_t[:, 1])) >= min(3, n_mix)


def _sd_inputs(missing):
    """W=32 over 128 markers (5 pad markers) on a marker-schedule order."""
    pk, eps, mask, mrow, n = make_inputs(128, 128, 21, missing, 5)
    order = np.random.RandomState(6).permutation(128).astype(np.int32)
    return pk, eps, mask, mrow, n, order


@pytest.mark.parametrize("sub_window", [8, 16, 32])
@pytest.mark.parametrize("missing", [False, True])
def test_sweep_stale_sd_matches_jax(missing, sub_window):
    """The plain single-decode sweep against the JAX sweep_stale_sd
    (interpret mode) on the rows gathered in sweep order: components equal,
    out within rtol 2e-5 / atol 2e-6, eps within rtol 1e-4 / atol 2e-5 (the
    JAX kernel splits c1 / c2 into bf16 hi + lo for its matrix unit; the
    port multiplies in f32)."""
    pk, eps, mask, mrow, n, order = _sd_inputs(missing)
    i2se, dnm1 = 0.7, float(n - 1)
    e_j, o_j = jsk.sweep_stale_sd(
        jnp.asarray(pk[order]), deinterleave(jnp.asarray(eps)),
        jnp.asarray(mrow[order]), jnp.float32(i2se), jnp.float32(dnm1),
        window=32, sub_window=sub_window, n_mix=K, complete=not missing,
        ind_mask4=jnp.asarray(deinterleave(mask)), interpret=True)
    o_slot = np.empty_like(np.asarray(o_j))
    o_slot[order] = np.asarray(o_j)
    before = dict(tsk.launches)
    e_t, o_t = tsk.sweep_stale_sd(
        torch.from_numpy(pk), torch.from_numpy(eps), torch.from_numpy(mrow),
        i2se, dnm1, window=32, sub_window=sub_window, n_mix=K,
        complete=not missing, ind_mask=torch.from_numpy(mask),
        order=torch.from_numpy(order))
    assert tsk.launches == before        # CPU tensors: plain version only
    e_t, o_t = e_t.numpy(), o_t.numpy()
    np.testing.assert_array_equal(o_t[:, 1], o_slot[:, 1])
    np.testing.assert_allclose(o_t, o_slot, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(e_t, np.asarray(interleave(e_j)), rtol=1e-4,
                               atol=2e-5)
    assert len(np.unique(o_t[:, 1])) >= 3 and np.all(e_t[n:] == 0.0)


@pytest.mark.parametrize("missing", [False, True])
def test_sweep_stale_sd_matches_two_phase(missing):
    """The plain single-decode sweep against the port's sweep_stale_ref:
    the stats and draws are the same computation (the first window's out
    equal bit for bit, components equal throughout), the update differs
    only in its f32 summation over sub-windows, and one sub-window a window
    is sweep_stale_ref's sweep bit for bit."""
    pk, eps, mask, mrow, n, order = _sd_inputs(missing)
    args = [torch.from_numpy(a) for a in (pk, eps, mrow)] + [0.7, float(n - 1)]
    kw = dict(window=32, n_mix=K, complete=not missing,
              ind_mask=torch.from_numpy(mask), order=torch.from_numpy(order))
    e_a, o_a = tsk.sweep_stale_ref(*args, **kw)
    for wt in (8, 32):
        e_b, o_b = tsk.sweep_stale_sd_ref(*args, sub_window=wt, **kw)
        first = torch.from_numpy(order[:32]).long()
        assert torch.equal(o_a[first], o_b[first])
        assert torch.equal(o_a[:, 1], o_b[:, 1])
        if wt == 32:
            assert torch.equal(e_a, e_b) and torch.equal(o_a, o_b)
        torch.testing.assert_close(o_b, o_a, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(e_b, e_a, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="must divide"):
        tsk.sweep_stale_sd(*args, sub_window=12, **kw)


def test_hpack_and_decode_match_jax():
    from hydra_tpu.ops.decode import decode_planes as jdp, \
        decode_planes_hp as jdph
    rs = np.random.RandomState(0)
    pk = rs.randint(0, 256, (7, 32)).astype(np.uint8)
    np.testing.assert_array_equal(hpack_bytes(pk), jax_hpack_bytes(pk))
    for tf, jf, x in ((decode_planes, jdp, pk),
                      (decode_planes_hp, jdph, jax_hpack_bytes(pk))):
        gt, mt = tf(torch.from_numpy(x))
        gj, mj = jf(jnp.asarray(x))
        np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


def test_wrappers_reject_bad_operands():
    pk, eps, mask, mrow, n = make_inputs(64, 128, 1, False, 0)
    args = [torch.from_numpy(a) for a in (pk, eps, mrow)]
    with pytest.raises(ValueError, match="multiple of window"):
        tsk.sweep_stale(*args, 0.5, 10.0, window=48, n_mix=K, complete=False)
    with pytest.raises(ValueError, match="ind_mask"):
        tsk.sweep_exact(*args, 0.5, 10.0, window=32, n_mix=K, complete=True)
    with pytest.raises(ValueError, match="no sweep kernel"):
        tsk.sweep_stale(*[a.to("meta") for a in args], 0.5, 10.0, window=32,
                        n_mix=K, complete=False)
