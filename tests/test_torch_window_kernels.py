"""Port BayesW window kernels vs the JAX Pallas kernels (interpret mode, CPU).

The same numpy inputs go through ``hydra_tpu.ops.window_kernels``
(plane-major vi and output, ``interpret=True``, as
tests/test_window_kernels.py runs them) and the port's plain versions,
which the wrappers take for CPU tensors. W=16, NB=512, complete and missing
genotypes; the last 37 individuals are padding (missing-coded, vi = 0).
Tolerance rtol 1e-5, atol 1e-5 (f32 summation order differs).
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


def _inputs(missing, seed):
    rs = np.random.RandomState(seed)
    geno = rs.randint(0, 3, (W, 4 * NB))
    code = np.select([geno == 0, geno == 1, geno == 2],
                     [0b11, 0b10, 0b00]).astype(np.uint8)
    if missing:
        code[rs.random_sample(code.shape) < 0.05] = 0b01
    n = 4 * NB - N_PAD_IND
    code[:, n:] = 0b01
    pk = hpack_bytes((code[:, 0::4] | (code[:, 1::4] << 2)
                      | (code[:, 2::4] << 4) | (code[:, 3::4] << 6)
                      ).astype(np.uint8))
    vi = (np.abs(rs.randn(4 * NB)) + 0.1).astype(np.float32)
    vi[n:] = 0.0
    c1 = (rs.randn(W) * 0.05).astype(np.float32)
    c2 = (rs.randn(W) * 0.05).astype(np.float32)
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


@pytest.mark.parametrize("missing", [False, True])
def test_axpy_matches_jax(missing):
    pk, _, c1, c2 = _inputs(missing, 5)
    d_j = interleave(jwk.window_axpy(jnp.asarray(pk), jnp.asarray(c1),
                                     jnp.asarray(c2), interpret=True,
                                     complete=not missing))
    before = dict(twk.launches)
    d_t = twk.window_axpy(torch.from_numpy(pk), torch.from_numpy(c1),
                          torch.from_numpy(c2), complete=not missing)
    assert twk.launches == before
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5,
                               atol=1e-5)


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
