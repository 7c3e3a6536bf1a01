"""Port window kernels vs the JAX Pallas kernels (interpret mode, CPU).

The same numpy inputs go through ``hydra_tpu.ops.window_kernels``
(plane-major vi, eps and output, ``interpret=True``, as
tests/test_window_kernels.py runs them) and the port's plain versions,
which the wrappers take for CPU tensors (the CUDA kernels are held to
these bit for bit on the card). W=16, NB=512, complete and missing
genotypes; the axpy and the stats also at the CUDA kernels' geometry edges,
W in {1, 7, 16, 40} (the stats' 16-row blocks and the axpy's 4-row words
cut mid-way) and NB in {128, 512, 640} (the smallest width, one 512-byte
stats tile, one and a quarter). The last 37 individuals are padding
(missing-coded, vi = eps = 0). Tolerance rtol 1e-5, atol 1e-5 (f32
summation order differs); the stats atol 1e-4 (sums of up to 2,523 terms
of size ~1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydra_tpu.ops import window_kernels as jwk
from hydra_tpu.ops.window_kernels import deinterleave, interleave
from hydra_tpu_torch.ops import window_kernels as twk
from hydra_tpu_torch.ops.decode import decode_planes_hp, hpack_bytes

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)

W, NB, N_PAD_IND = 16, 512, 37
GEOMETRY = [(w, nb) for w in (1, 7, 16, 40) for nb in (128, 512, 640)]


def _geometry_params():
    """(missing, w, nb) cases; W=16, NB=512 keeps its original id."""
    return [pytest.param(missing, w, nb, id=str(missing) if (w, nb) == (W, NB)
                         else f"{missing}-W{w}-NB{nb}")
            for missing in (False, True) for w, nb in GEOMETRY]


def _inputs(missing, seed, w=W, nb=NB, rate=0.05):
    rs = np.random.RandomState(seed)
    geno = rs.randint(0, 3, (w, 4 * nb))
    code = np.select([geno == 0, geno == 1, geno == 2],
                     [0b11, 0b10, 0b00]).astype(np.uint8)
    if missing:
        code[rs.random_sample(code.shape) < rate] = 0b01
    n = 4 * nb - N_PAD_IND
    code[:, n:] = 0b01
    pk = hpack_bytes((code[:, 0::4] | (code[:, 1::4] << 2)
                      | (code[:, 2::4] << 4) | (code[:, 3::4] << 6)
                      ).astype(np.uint8))
    vi = (np.abs(rs.randn(4 * nb)) + 0.1).astype(np.float32)
    vi[n:] = 0.0
    c1 = (rs.randn(w) * 0.05).astype(np.float32)
    c2 = (rs.randn(w) * 0.05).astype(np.float32)
    return pk, vi, c1, c2


@pytest.mark.parametrize("missing", [False, True])
def test_level_sums_match_jax(missing):
    pk, vi, _, _ = _inputs(missing, 3)
    s_j = jwk.window_level_sums(jnp.asarray(pk), deinterleave(jnp.asarray(vi)),
                                interpret=True, complete=not missing)
    before = dict(twk.launches)
    s_t = twk.window_level_sums(torch.from_numpy(pk), torch.from_numpy(vi),
                                complete=not missing)
    assert twk.launches == before        # CPU tensors: plain version only
    for a, b in zip(s_t, s_j):
        if b is None:
            assert a is None
            continue
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    # and against the plain definition: sums of vi by genotype class
    g, m = decode_planes_hp(torch.from_numpy(pk), torch.float64)
    v = torch.from_numpy(vi).double()
    np.testing.assert_allclose(s_t[0].numpy(), ((g == 1) * m).double() @ v,
                               rtol=1e-5)
    np.testing.assert_allclose(s_t[1].numpy(), (g == 2).double() @ v,
                               rtol=1e-5)


@pytest.mark.parametrize("missing,w,nb", _geometry_params() + [
    pytest.param(missing, 33, NB, id=f"{missing}-W33-NB{NB}")
    for missing in (False, True)])
def test_axpy_matches_jax(missing, w, nb):
    """The plain axpy (complete data: 2 sum(c1) in window order from 0,
    minus sum c1*h) against the JAX kernel; W = 33 ends in a partial 4-row
    word of the CUDA kernel's tile."""
    pk, _, c1, c2 = _inputs(missing, 5, w, nb)
    d_j = interleave(jwk.window_axpy(jnp.asarray(pk), jnp.asarray(c1),
                                     jnp.asarray(c2), interpret=True,
                                     complete=not missing))
    before = dict(twk.launches)
    d_t = twk.window_axpy(torch.from_numpy(pk), torch.from_numpy(c1),
                          torch.from_numpy(c2), complete=not missing)
    assert twk.launches == before
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("missing,w,nb", _geometry_params())
@pytest.mark.parametrize("exact", [False, True])
def test_stats_match_jax(exact, missing, w, nb):
    """The stats kernel's sums (s1, and s2 for missing data) of rows read in
    place through ``rows`` (three pad rows of 2w + 3 in the pool), against
    the JAX window_stats of the gathered rows; exact adds the Gram, which
    the complete-data integer Gram gives to rounding of its correction
    (atol 1e-3) and missing data to the JAX bf16 hi/lo split (atol 2e-2,
    tests/test_torch_window_path.py)."""
    rs = np.random.RandomState(11)
    pool, _, _, _ = _inputs(missing, 7, 2 * w + 3, nb)
    pool[rs.choice(2 * w + 3, 3, replace=False)] = 0xFF
    rows = rs.choice(2 * w + 3, w, replace=False).astype(np.int32)
    n = 4 * nb - N_PAD_IND
    eps = rs.randn(4 * nb).astype(np.float32)
    eps[n:] = 0.0
    mave = rs.uniform(0.2, 1.8, w).astype(np.float32)
    mstd = rs.uniform(0.8, 1.6, w).astype(np.float32)
    complete = not missing
    before = dict(twk.launches)
    got = twk.window_stats(torch.from_numpy(pool), torch.from_numpy(eps),
                           torch.from_numpy(mave), torch.from_numpy(mstd),
                           exact, complete, float(n), torch.from_numpy(rows))
    assert twk.launches == before
    want = jwk.window_stats(jnp.asarray(pool[rows]),
                            deinterleave(jnp.asarray(eps)), jnp.asarray(mave),
                            jnp.asarray(mstd), exact, interpret=True,
                            complete=complete, n_real=float(n))
    for a, b, atol in zip(got, want, (1e-4, 1e-4, 1e-3 if complete else 2e-2)):
        assert (a is None) == (b is None)
        if b is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b).reshape(
                a.shape), rtol=1e-5, atol=atol)


@pytest.mark.parametrize("nb", [128, 640])
@pytest.mark.parametrize("w", [7, 16, 40])
@pytest.mark.parametrize("missing", [False, True])
def test_window_grams_match_jax(missing, w, nb):
    """window_grams (the CPU wrapper takes window_grams_ref) over the 4
    windows of one shuffled order of 4w slots, one of them a pad row
    (all missing), against the JAX window_stats Gram of each window's
    gathered rows. Complete data: the raw integer Gram, which window_stats
    returns as is for mave = 0, mstd = 1, equal. 2% missing calls: x x^T
    with the per-slot mave, mstd, to the JAX bf16 hi/lo split (atol 2e-2,
    as test_stats_match_jax) and to float64 within the forward error bound
    of an f32 sum of the 4 nb products, 4 nb 2^-24 |x| |x|^T."""
    rs = np.random.RandomState(17 + w)
    m = 4 * w
    pk, _, _, _ = _inputs(missing, 19, m, nb, rate=0.02)
    pk[rs.randint(m)] = 0xFF
    order = rs.permutation(m).astype(np.int32)
    mave = rs.uniform(0.2, 1.8, m).astype(np.float32)
    mstd = rs.uniform(0.8, 1.6, m).astype(np.float32)
    eps = np.zeros(4 * nb, np.float32)
    kw = (dict(mave=torch.from_numpy(mave), mstd=torch.from_numpy(mstd))
          if missing else {})
    before = dict(twk.launches)
    got = twk.window_grams(torch.from_numpy(pk), torch.from_numpy(order), w,
                           **kw)
    assert twk.launches == before
    assert got.shape == (4, w, w) and got.dtype == torch.float32
    for k in range(4):
        slots = order[k * w:(k + 1) * w]
        av = mave[slots] if missing else np.zeros(w, np.float32)
        sd = mstd[slots] if missing else np.ones(w, np.float32)
        want = np.asarray(jwk.window_stats(
            jnp.asarray(pk[slots]), deinterleave(jnp.asarray(eps)),
            jnp.asarray(av), jnp.asarray(sd), True, interpret=True,
            complete=not missing, n_real=0.0)[2])
        g, mk = decode_planes_hp(torch.from_numpy(pk[slots]), torch.float64)
        if not missing:
            np.testing.assert_array_equal(got[k].numpy(), want)
            np.testing.assert_array_equal(got[k].numpy(), (g @ g.T).numpy())
            continue
        av64 = torch.from_numpy(av).double()[:, None]
        x = (g - av64 * mk) * torch.from_numpy(sd).double()[:, None]
        np.testing.assert_allclose(got[k].numpy(), want, rtol=1e-5, atol=2e-2)
        bound = 4 * nb * 2.0 ** -24 * (x.abs() @ x.abs().T)
        assert bool(((got[k].double() - x @ x.T).abs() <= bound).all())


def test_tile_sums_cover_partial_tiles():
    """The kernel-order sums equal plain sums on a width that leaves the
    last 512-byte tile partly empty."""
    x = torch.from_numpy(np.random.RandomState(0).rand(3, 4 * 640)
                         .astype(np.float32))
    parts = twk.tile_sums(x)
    assert parts.shape == (3, 2)
    np.testing.assert_allclose(twk.seq_sum(parts).numpy(),
                               x.double().sum(1).numpy(), rtol=1e-6)


def test_wrappers_reject_bad_operands():
    pk, vi, c1, c2 = (torch.from_numpy(a) for a in _inputs(False, 1))
    with pytest.raises(ValueError, match="vi must be"):
        twk.window_level_sums(pk, vi[:-4])
    with pytest.raises(ValueError, match="c1 must be"):
        twk.window_axpy(pk, c1[:-1], c2)
    with pytest.raises(ValueError, match="no window_axpy kernel"):
        twk.window_axpy(pk.to("meta"), c1.to("meta"), c2.to("meta"))
    order = torch.arange(W, dtype=torch.int32)
    with pytest.raises(ValueError, match="order must be windows"):
        twk.window_grams(pk, order[:-1], W)
    with pytest.raises(ValueError, match="need both mave and mstd"):
        twk.window_grams(pk, order, W, mave=torch.zeros(W))
    with pytest.raises(ValueError, match="no window_grams kernel"):
        twk.window_grams(pk.to("meta"), order.to("meta"), W)
