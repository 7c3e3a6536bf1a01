"""Tests that need a CUDA card: the port's kernels and sampler on the card
against their plain versions and the CPU sampler.

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``tests/conftest.py`` imports jax). Without a card every test skips; the
decision is made inside each test. ``make_inputs`` also feeds the CPU parity
tests in test_torch_sweep_kernel.py.
"""

import numpy as np
import pytest
import torch

from hydra_tpu_torch.ops import sweep_kernel as tsk
from hydra_tpu_torch.ops.decode import hpack_bytes

K = 4


def make_inputs(m, nb, seed, missing, n_pad_markers):
    """Packed genotypes, residual, mask and mrow rows. The last 37
    individuals are padding (missing-coded, eps = 0, mask = 0); pad markers
    (all missing, act = 0) sit at random slots."""
    rs = np.random.RandomState(seed)
    geno = rs.randint(0, 3, (m, 4 * nb))
    code = np.select([geno == 0, geno == 1, geno == 2],
                     [0b11, 0b10, 0b00]).astype(np.uint8)
    if missing:
        code[rs.random_sample(code.shape) < 0.05] = 0b01
    n = 4 * nb - 37
    code[:, n:] = 0b01
    pads = rs.choice(m, n_pad_markers, replace=False)
    code[pads] = 0b01
    pk = hpack_bytes((code[:, 0::4] | (code[:, 1::4] << 2)
                      | (code[:, 2::4] << 4) | (code[:, 3::4] << 6)
                      ).astype(np.uint8))
    eps = rs.randn(4 * nb).astype(np.float32)
    eps[n:] = 0.0
    mask = np.zeros(4 * nb, np.float32)
    mask[:n] = 1.0
    mrow = np.zeros((m, tsk.mrow_width(K)), np.float32)
    mrow[:, 0] = rs.uniform(0.2, 1.8, m)                 # mave
    mrow[:, 1] = rs.uniform(0.8, 1.6, m)                 # mstd
    mrow[:, 2] = rs.randn(m) * 0.02                      # beta_old
    mrow[:, 3] = rs.uniform(0, 1, m)                     # u
    mrow[:, 4] = rs.randn(m)                             # nrm
    mrow[:, 5] = 1.0                                     # act
    mrow[:, 6:6 + K] = np.log(rs.dirichlet(np.ones(K), m))
    mrow[:, 6 + K:6 + 2 * K - 1] = rs.uniform(8e-4, 1.2e-3, (m, K - 1))
    mrow[:, 6 + 2 * K - 1:] = rs.uniform(0.02, 0.04, (m, K - 1))
    mrow[pads, :3] = 0.0
    mrow[pads, 5] = 0.0
    return pk, eps, mask, mrow, n


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("missing", [False, True])
def test_cuda_kernel_matches_plain(exact, missing):
    """On the card: the CUDA kernel against its plain version, with the
    same tolerances (f32 reduction order only), and bitwise-repeatable."""
    dev = _card()
    pk, eps, mask, mrow, n = make_inputs(256, 256, 7, missing, 9)
    t = [torch.from_numpy(a).to(dev) for a in (pk, eps, mrow, mask)]
    gen = torch.Generator(device=dev).manual_seed(0)
    order = tsk.block_order(torch.randperm(256 // 32, generator=gen,
                                           device=dev), 32)
    kw = dict(window=32, n_mix=K, complete=not missing, ind_mask=t[3],
              order=order)
    fn = tsk.sweep_exact if exact else tsk.sweep_stale
    ref = tsk.sweep_exact_ref if exact else tsk.sweep_stale_ref
    e_k, o_k = fn(t[0], t[1], t[2], 0.7, float(n - 1), **kw)
    e_k2, o_k2 = fn(t[0], t[1], t[2], 0.7, float(n - 1), **kw)
    e_r, o_r = ref(t[0], t[1], t[2], 0.7, float(n - 1), **kw)
    torch.cuda.synchronize()
    assert torch.equal(e_k, e_k2) and torch.equal(o_k, o_k2)
    torch.testing.assert_close(e_k, e_r, atol=5e-4, rtol=1e-3)
    torch.testing.assert_close(o_k[:, 0], o_r[:, 0], atol=5e-4, rtol=1e-3)
    assert torch.equal(o_k[:, 1], o_r[:, 1])


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run python chip_smoke.py there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _dataset(m, n, seed, missing_frac):
    """A small simulated Dataset (complete or with missing genotypes)."""
    from hydra_tpu.data.genotypes import Dataset, GenotypeData, \
        make_default_groups
    from hydra_tpu.io.plink import MISSING_CODE, bed_bytes_per_marker
    rs = np.random.RandomState(seed)
    p = rs.uniform(0.05, 0.5, (m, 1))
    geno = rs.binomial(1, p, (m, n)) + rs.binomial(1, p, (m, n))
    geno[rs.random_sample((m, n)) < missing_frac] = -1
    code = np.select([geno == 0, geno == 1, geno == 2, geno < 0],
                     [0b11, 0b10, 0b00, MISSING_CODE]).astype(np.uint8)
    padded = np.full((m, bed_bytes_per_marker(n) * 4), MISSING_CODE, np.uint8)
    padded[:, :n] = code
    packed = (padded[:, 0::4] | (padded[:, 1::4] << 2)
              | (padded[:, 2::4] << 4) | (padded[:, 3::4] << 6))
    gd = GenotypeData.from_packed(packed.astype(np.uint8), n,
                                  np.zeros(0, np.int64))
    groups, mS = make_default_groups(m, [0.001, 0.01, 0.1])
    return Dataset(geno=gd, y=rs.randn(n), groups=groups, num_groups=1, mS=mS)


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("missing_frac", [0.0, 0.03])
def test_cuda_sampler_sweep_matches_cpu(exact, missing_frac):
    """One sweep of the CUDA sampler against the CPU sampler from the same
    state with the same noise."""
    from hydra_tpu_torch.samplers.bayesrrm import (BayesRRm, state_from_numpy,
                                                   state_to_numpy)
    dev = _card()
    ds = _dataset(300, 700, 3, missing_frac)
    cpu = BayesRRm(ds, window=32, exact=exact, seed=5, device="cpu")
    gpu = BayesRRm(ds, window=32, exact=exact, seed=5, device=dev)
    s_cpu = cpu.init_state()
    s_gpu = state_from_numpy(state_to_numpy(s_cpu), dev)
    g = torch.Generator().manual_seed(1)
    noise = dict(mu=torch.randn((), generator=g),
                 u=torch.rand(cpu.cfg.m_loc, generator=g),
                 nrm=torch.randn(cpu.cfg.m_loc, generator=g),
                 wperm=torch.randperm(cpu.cfg.n_windows, generator=g))
    before = dict(tsk.launches)
    a, sa = cpu.step(s_cpu, 0, noise=noise)
    b, sb = gpu.step(s_gpu, 0, noise={k: v.to(dev) for k, v in noise.items()})
    name = "sweep_exact" if exact else "sweep_stale"
    assert tsk.launches[name] == before[name] + 1
    a, b = state_to_numpy(a), state_to_numpy(b)
    np.testing.assert_allclose(b["eps"], a["eps"], atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(b["beta"], a["beta"], atol=5e-4, rtol=1e-3)
    np.testing.assert_array_equal(b["components"], a["components"])
    np.testing.assert_array_equal(sb.cass.cpu().numpy(), sa.cass.numpy())
