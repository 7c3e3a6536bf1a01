"""Tests that need a CUDA card: the port's kernels and samplers (BayesRRm
and BayesFH with their whole-sweep, single-decode and per-window branches,
BayesW and multi-trait BayesRRm) on the card against their plain versions
and the CPU samplers.

This file imports neither JAX nor the JAX package, so it also runs on a
machine without them:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``tests/conftest.py`` imports jax). Without a card every test skips; the
decision is made inside each test. ``make_inputs`` and ``make_mt_inputs``
also feed the CPU parity tests in test_torch_sweep_kernel{,_mt}.py.
"""

import functools
import hashlib

import numpy as np
import pytest
import torch

from hydra_tpu_torch.ops import sweep_kernel as tsk
from hydra_tpu_torch.ops import sweep_kernel_bw as tskbw
from hydra_tpu_torch.ops import window_kernels as twk
from hydra_tpu_torch.ops.decode import hpack_bytes

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)

K = 4


def make_inputs(m, nb, seed, missing, n_pad_markers, k=K, miss_frac=0.05):
    """Packed genotypes, residual, mask and mrow rows of k mixture
    components (``miss_frac`` of the calls missing when ``missing``). The
    last 37 individuals are padding (missing-coded, eps = 0, mask = 0); pad
    markers (all missing, act = 0) sit at random slots."""
    rs = np.random.RandomState(seed)
    geno = rs.randint(0, 3, (m, 4 * nb))
    code = np.select([geno == 0, geno == 1, geno == 2],
                     [0b11, 0b10, 0b00]).astype(np.uint8)
    if missing:
        code[rs.random_sample(code.shape) < miss_frac] = 0b01
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
    mrow = np.zeros((m, tsk.mrow_width(k)), np.float32)
    mrow[:, 0] = rs.uniform(0.2, 1.8, m)                 # mave
    mrow[:, 1] = rs.uniform(0.8, 1.6, m)                 # mstd
    mrow[:, 2] = rs.randn(m) * 0.02                      # beta_old
    mrow[:, 3] = rs.uniform(0, 1, m)                     # u
    mrow[:, 4] = rs.randn(m)                             # nrm
    mrow[:, 5] = 1.0                                     # act
    mrow[:, 6:6 + k] = np.log(rs.dirichlet(np.ones(k), m))
    mrow[:, 6 + k:6 + 2 * k - 1] = rs.uniform(8e-4, 1.2e-3, (m, k - 1))
    mrow[:, 6 + 2 * k - 1:] = rs.uniform(0.02, 0.04, (m, k - 1))
    mrow[pads, :3] = 0.0
    mrow[pads, 5] = 0.0
    return pk, eps, mask, mrow, n


def make_mt_inputs(m, nb, T, seed, missing, n_pad_markers, na_frac=0.0,
                   shared_stats=False, k=K):
    """Multi-trait kernel inputs: packed genotypes as ``make_inputs``, the
    (n_pad, T) residual and trait mask (0 on the 37 pad individuals and on
    a fraction ``na_frac`` of NaN entries per trait, where eps is 0 too),
    mrow rows (m, T*(3k+4)) of k mixture components and per-trait dNm1.
    shared_stats repeats trait 0's mave/mstd for every trait (full
    phenotypes)."""
    from hydra_tpu_torch.ops.sweep_kernel_mt import mt_mrow_width
    pk, _, _, _, n = make_inputs(m, nb, seed, missing, 0)
    rs = np.random.RandomState(seed + 1)
    pads = rs.choice(m, n_pad_markers, replace=False)
    pk[pads] = 0xFF
    tm = np.zeros((4 * nb, T), np.float32)
    tm[:n] = rs.random_sample((n, T)) >= na_frac
    eps = (rs.randn(4 * nb, T) * tm).astype(np.float32)

    def per_trait(lo, hi):
        x = rs.uniform(lo, hi, (m, T))
        return np.repeat(x[:, :1], T, axis=1) if shared_stats else x

    blocks = np.zeros((m, 3 * k + 4, T))
    blocks[:, 0] = per_trait(0.2, 1.8)                    # mave
    blocks[:, 1] = per_trait(0.8, 1.6)                    # mstd
    blocks[:, 2] = rs.randn(m, T) * 0.02                  # beta_old
    blocks[:, 3] = rs.uniform(0, 1, (m, T))               # u
    blocks[:, 4] = rs.randn(m, T)                         # nrm
    blocks[:, 5] = 1.0                                    # act
    blocks[:, 6:6 + k] = np.log(rs.dirichlet(np.ones(k), (m, T))).transpose(
        0, 2, 1)
    blocks[:, 6 + k:5 + 2 * k] = rs.uniform(8e-4, 1.2e-3, (m, k - 1, T))
    blocks[:, 5 + 2 * k:] = rs.uniform(0.02, 0.04, (m, k - 1, T))
    blocks[pads, :3] = 0.0
    blocks[pads, 5] = 0.0
    mrow = blocks.reshape(m, -1).astype(np.float32)
    assert mrow.shape[1] == mt_mrow_width(k, T)
    dnm1 = (tm.sum(axis=0) - 1.0).astype(np.float32)
    return pk, eps, tm, mrow, dnm1


@pytest.mark.cuda
@pytest.mark.parametrize("window", [1, 20, 32, 33, 128, 256])
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("missing", [False, True])
def test_cuda_kernel_matches_plain(exact, missing, window):
    """On the card: the CUDA kernel against its plain version, with the
    same tolerances (f32 reduction order only), and bitwise-repeatable.
    The windows cross the exact draw's 32-marker blocks (33: a ragged last
    block) and the int8 Gram's 64-row tiles (128, 256)."""
    dev = _card()
    m = window * max(4, 512 // window)
    pk, eps, mask, mrow, n = make_inputs(m, 256, 7, missing, 9)
    t = [torch.from_numpy(a).to(dev) for a in (pk, eps, mrow, mask)]
    gen = torch.Generator(device=dev).manual_seed(0)
    order = tsk.block_order(torch.randperm(m // window, generator=gen,
                                           device=dev), window)
    kw = dict(window=window, n_mix=K, complete=not missing, ind_mask=t[3],
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


@pytest.mark.cuda
@pytest.mark.parametrize("window", [33, 128])
@pytest.mark.parametrize("n_mix", [2, 6, 12])
def test_cuda_exact_draw_any_components(n_mix, window):
    """The exact draw's register bound on K (4, 8, 16: one kernel each)
    against the plain version with the mixture sizes the default K = 4
    leaves out, through the sweep and through window_gibbs."""
    from hydra_tpu_torch.ops import gibbs_kernel as tgk
    dev = _card()
    m = 4 * window
    pk, eps, mask, mrow, n = (
        torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray) else a
        for a in make_inputs(m, 256, 11, False, 5, k=n_mix))
    kw = dict(window=window, n_mix=n_mix, complete=True, ind_mask=mask)
    e_k, o_k = tsk.sweep_exact(pk, eps, mrow, 0.7, float(n - 1), **kw)
    e_r, o_r = tsk.sweep_exact_ref(pk, eps, mrow, 0.7, float(n - 1), **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(e_k, e_r, atol=5e-4, rtol=1e-3)
    torch.testing.assert_close(o_k[:, 0], o_r[:, 0], atol=5e-4, rtol=1e-3)
    assert torch.equal(o_k[:, 1], o_r[:, 1])
    # window_gibbs on the first window's rows and a correlation-like Gram
    b = mrow[:window]
    x = torch.randn(window, 512, generator=torch.Generator().manual_seed(3))
    gram = (x @ x.T / 512).to(dev)
    num0 = 30.0 * torch.randn(window, generator=torch.Generator().manual_seed(4))
    cols = (b[:, 6:6 + n_mix], b[:, 6 + n_mix:5 + 2 * n_mix],
            b[:, 5 + 2 * n_mix:], b[:, 3], b[:, 4], b[:, 5], b[:, 2])
    args = [gram, num0.to(dev)] + [c.contiguous() for c in cols] + [0.7]
    k_out = tgk.window_gibbs(*args)
    r_out = tgk.window_gibbs_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(k_out[2], r_out[2])
    for a, r in zip(k_out, r_out):
        torch.testing.assert_close(a.float(), r.float(), atol=5e-4, rtol=1e-3)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run python chip_smoke.py there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _dataset(m, n, seed, missing_frac, weibull=False):
    """A small simulated Dataset (complete or with missing genotypes);
    weibull adds log-times and 20% censoring for BayesW."""
    from hydra_tpu_torch.data.genotypes import (Dataset, GenotypeData,
                                                make_default_groups)
    from hydra_tpu_torch.io.plink import MISSING_CODE, bed_bytes_per_marker
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
    if weibull:
        y = 4.0 + (np.log(rs.exponential(1.0, n)) + 0.5772) / 8.0
        return Dataset(geno=gd, y=y, groups=groups, num_groups=1, mS=mS,
                       fail=(rs.random_sample(n) > 0.2).astype(np.float64))
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


def _bw_noise(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    m = cfg.m_loc
    noise = dict(u=torch.rand(m, generator=g),
                 le=torch.empty(m).exponential_(generator=g),
                 ub=torch.rand(m, generator=g),
                 uu=torch.rand(m, 24, generator=g),
                 wperm=torch.randperm(cfg.n_windows, generator=g))
    for k in ("mu", "alpha"):
        noise[k] = (torch.empty(()).exponential_(generator=g),
                    torch.rand((), generator=g), torch.rand(24, generator=g))
    return noise


@pytest.mark.cuda
@pytest.mark.parametrize("window", [1, 16])
@pytest.mark.parametrize("missing_frac", [0.0, 0.03])
def test_cuda_bw_sweep_matches_plain(window, missing_frac):
    """On the card: the BayesW sweep kernel against its plain version on
    the card from a sampler's own rows, and bitwise-repeatable."""
    from hydra_tpu_torch.samplers.bayesw import BayesW
    dev = _card()
    s = BayesW(_dataset(96, 700, 4, missing_frac, weibull=True),
               window=window, seed=3, quad_points=9, device=dev)
    st = s.init_state()
    st.pi_l = torch.tensor([[0.5, 0.2, 0.2, 0.1]], device=dev)
    vi = torch.exp(st.alpha * st.eps - tskbw.EULER_MASCHERONI) * s.ind_mask
    mrow = s.build_mrow(st, st.alpha, s.slot_noise(0))
    args = (s.packed, st.eps, vi, mrow, s.gh_x, s.gh_w, st.alpha)
    kw = dict(window=window, n_mix=4, complete=s.cfg.complete,
              ind_mask=s.ind_mask, order=s.sweep_order(0))
    e_k, o_k = tskbw.sweep_stale_bw(*args, **kw)
    e_k2, o_k2 = tskbw.sweep_stale_bw(*args, **kw)
    e_r, o_r = tskbw.sweep_stale_bw_ref(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(e_k, e_k2) and torch.equal(o_k, o_k2)
    torch.testing.assert_close(e_k, e_r, atol=5e-4, rtol=1e-3)
    torch.testing.assert_close(o_k[:, 0], o_r[:, 0], atol=5e-4, rtol=1e-3)
    assert torch.equal(o_k[:, 1], o_r[:, 1])
    assert int((o_k[:, 1] > 0).sum()) >= 3


@pytest.mark.cuda
@pytest.mark.parametrize("missing", [False, True])
def test_cuda_window_kernels_match_plain(missing):
    dev = _card()
    pk, eps, mask, _, n = make_inputs(64, 256, 9, missing, 0)
    pk = torch.from_numpy(pk).to(dev)
    vi = torch.from_numpy(np.abs(eps) * mask).to(dev)
    g = torch.Generator(device=dev).manual_seed(2)
    c1 = 0.05 * torch.randn(64, generator=g, device=dev)
    c2 = 0.05 * torch.randn(64, generator=g, device=dev)
    before = dict(twk.launches)
    sums_k = twk.window_level_sums(pk, vi, not missing)
    sums_r = twk.window_level_sums_ref(pk, vi, not missing)
    d_k = twk.window_axpy(pk, c1, c2, not missing)
    d_r = twk.window_axpy_ref(pk, c1, c2, not missing)
    torch.cuda.synchronize()
    for name in ("window_level_sums", "window_axpy"):
        assert twk.launches[name] == before[name] + 1
    assert (sums_k[2] is None) == (sums_r[2] is None) == (not missing)
    for a, b in zip(sums_k, sums_r):
        if b is not None:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    # the axpy repeats the plain version's steps: bit for bit, but for the
    # pad individuals' h = 3 products in complete data (the plain version
    # rounds 3 * c1, the kernel's fused multiply-add does not)
    assert torch.equal(d_k[:n], d_r[:n])
    if missing:
        assert torch.equal(d_k, d_r)
    torch.testing.assert_close(d_k, d_r, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n_mix", [2, 4, 6, 12, 16])
@pytest.mark.parametrize("window", [1, 31, 32, 33, 64, 128, 200, 1024])
def test_cuda_window_gibbs_matches_plain(window, n_mix):
    """window_gibbs_kernel (the warp-synchronous recurrence; one kernel a
    register bound on K: 4 with K a constant, 8, 16) against its plain
    version on a correlation-like Gram (x x^T / 512): components equal,
    dbeta, beta and acum within 5e-4 / 1e-3 (the plain version rounds the
    Gram update's product, the kernel fuses it), a second call bit for bit
    the first, and inactive markers (act = 0, the pad markers and every
    seventh) drawn to comp = 0 and beta = 0. The windows end in a ragged
    last warp (1, 31, 33, 200) or fill whole warps, up to the kernel's
    largest (1,024 markers, 32 warps)."""
    from hydra_tpu_torch.ops import gibbs_kernel as tgk
    dev = _card()
    _, _, _, mrow, _, _ = _card_inputs(window, 128, False, 13, dev,
                                       n_pad_markers=window // 10 + 1,
                                       k=n_mix)
    mrow[::7, 5] = 0.0
    gen = torch.Generator().manual_seed(window * 31 + n_mix)
    x = torch.randn(window, 512, generator=gen)
    gram = (x @ x.T / 512).to(dev)
    num0 = (30.0 * torch.randn(window, generator=gen)).to(dev)
    cols = (mrow[:, 6:6 + n_mix], mrow[:, 6 + n_mix:5 + 2 * n_mix],
            mrow[:, 5 + 2 * n_mix:], mrow[:, 3], mrow[:, 4], mrow[:, 5],
            mrow[:, 2])
    args = [gram, num0] + [c.contiguous() for c in cols] + [0.7]
    before = dict(tgk.launches)
    k_out = tgk.window_gibbs(*args)
    k_again = tgk.window_gibbs(*args)
    r_out = tgk.window_gibbs_ref(*args)
    torch.cuda.synchronize()
    assert tgk.launches["window_gibbs"] == before["window_gibbs"] + 2
    assert k_out[2].dtype == torch.int32
    for a, b in zip(k_out, k_again):
        assert torch.equal(a, b)
    assert torch.equal(k_out[2], r_out[2])
    for a, r in zip(k_out, r_out):
        torch.testing.assert_close(a.float(), r.float(), atol=5e-4, rtol=1e-3)
    inactive = mrow[:, 5] == 0.0
    assert bool(inactive.any())
    assert bool((k_out[2][inactive] == 0).all())
    assert bool((k_out[1][inactive] == 0.0).all())
    if window >= 32:
        assert int(torch.unique(k_out[2]).numel()) >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("missing", [False, True])
@pytest.mark.parametrize("window", [1, 33, 64, 200, 1024])
def test_cuda_window_axpy_bitwise(window, missing):
    """window_axpy (one launch: axpy_kernel<false, MODE, 0, true> writes
    d eps and forms the complete-data constant 2 sum(c1) in window order)
    bit for bit its plain version at N=50,000 on rows drawn in shuffled
    order from 2 W, pad rows among them (complete data: but the pad
    individuals' h = 3 products, which the plain version rounds and the
    kernel fuses; the caller masks them), and bitwise repeatable."""
    dev = _card()
    complete = not missing
    m = 2 * window
    pk, _, _, mrow, n, _ = _card_inputs(m, 12_544, missing, 19, dev)
    gen = torch.Generator(device=dev).manual_seed(window)
    rows = torch.randperm(m, generator=gen, device=dev)[:window].to(
        torch.int32)
    c1 = 0.05 * torch.randn(window, generator=gen, device=dev)
    c1[mrow[rows.long(), 1] == 0.0] = 0.0           # pad rows: mstd = 0
    c2 = -c1 * mrow[rows.long(), 0]
    before = dict(twk.launches)
    d_k = twk.window_axpy(pk, c1, c2, complete, rows)
    d_k2 = twk.window_axpy(pk, c1, c2, complete, rows)
    d_r = twk.window_axpy_ref(pk, c1, c2, complete, rows)
    torch.cuda.synchronize()
    assert twk.launches["window_axpy"] == before["window_axpy"] + 2
    assert torch.equal(d_k, d_k2)
    assert torch.equal(d_k[:n], d_r[:n])
    if missing:
        assert torch.equal(d_k, d_r)


@pytest.mark.cuda
@pytest.mark.parametrize("missing", [False, True])
def test_cuda_window_axpy_one_launch(missing):
    """One window_axpy call, as the per-window branch makes it (the
    window's rows given), is one CUDA kernel on the card: axpy_kernel, no
    torch glue (no cat, sum, multiply or zero fill) and no memset."""
    dev = _card()
    pk, _, _, mrow, _, _ = _card_inputs(128, 12_544, missing, 23, dev)
    rows = torch.arange(64, 128, dtype=torch.int32, device=dev)
    c1 = 0.05 * torch.randn(64, generator=torch.Generator(
        device=dev).manual_seed(3), device=dev)
    c2 = -c1 * mrow[rows.long(), 0]
    twk.window_axpy(pk, c1, c2, not missing, rows)
    got = _device_launches(lambda: twk.window_axpy(pk, c1, c2, not missing,
                                                   rows))
    assert sum(got.values()) == 1, got
    assert "hydra::axpy_kernel" in next(iter(got)), got


@pytest.mark.cuda
@pytest.mark.parametrize("window", [1, 32])
def test_cuda_bw_sampler_sweep_matches_cpu(window):
    """One BayesW sweep of the CUDA sampler against the CPU sampler from the
    same state with the same noise; the launch counters move."""
    from hydra_tpu_torch.samplers.bayesw import (BayesW, state_from_numpy,
                                                 state_to_numpy)
    dev = _card()
    ds = _dataset(200, 600, 8, 0.02, weibull=True)
    cpu = BayesW(ds, window=window, seed=5, quad_points=9, device="cpu")
    gpu = BayesW(ds, window=window, seed=5, quad_points=9, device=dev)
    s_cpu = cpu.init_state()
    s_gpu = state_from_numpy(state_to_numpy(s_cpu), dev)
    noise = _bw_noise(cpu.cfg, 1)
    before = {**tskbw.launches, **twk.launches}
    a, sa = cpu.step(s_cpu, 0, noise=noise)
    b, sb = gpu.step(s_gpu, 0, noise=noise)
    after = {**tskbw.launches, **twk.launches}
    assert after["sweep_stale_bw"] == before["sweep_stale_bw"] + 1
    for name in ("window_level_sums", "window_axpy"):
        assert after[name] == before[name] + gpu.cfg.n_windows
    a, b = state_to_numpy(a), state_to_numpy(b)
    np.testing.assert_allclose(b["mu"], a["mu"], rtol=1e-5)
    np.testing.assert_allclose(b["alpha"], a["alpha"], rtol=1e-5)
    np.testing.assert_allclose(b["eps"], a["eps"], atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(b["beta"], a["beta"], atol=5e-4, rtol=1e-3)
    np.testing.assert_array_equal(b["components"], a["components"])
    np.testing.assert_array_equal(sb.cass.cpu().numpy(), sa.cass.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("exact,missing,na_frac", [
    (False, False, 0.0), (False, True, 0.1)])
def test_cuda_mt_sweep_matches_plain(exact, missing, na_frac):
    """On the card: the multi-trait stale sweep kernels against their plain
    versions (f32 reduction order only), and bitwise-repeatable. The exact
    sweep is a case of test_cuda_mt_recurrence_matches_plain."""
    from hydra_tpu_torch.ops import sweep_kernel_mt as tskmt
    dev = _card()
    T = 4
    pk, eps, tm, mrow, dnm1 = make_mt_inputs(256, 256, T, 7, missing, 9,
                                             na_frac, shared_stats=exact)
    t = [torch.from_numpy(a).to(dev) for a in (pk, eps, tm, mrow, dnm1)]
    i2se = torch.tensor([0.6, 0.7, 0.8, 0.9], device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    order = tsk.block_order(torch.randperm(256 // 32, generator=gen,
                                           device=dev), 32)
    kw = dict(window=32, n_mix=K, order=order)
    if exact:
        fn, ref = tskmt.sweep_exact_mt, tskmt.sweep_exact_mt_ref
    else:
        kw["complete"] = not missing
        fn, ref = tskmt.sweep_stale_mt, tskmt.sweep_stale_mt_ref
    before = dict(tskmt.launches)
    e_k, o_k = fn(t[0], t[1], t[2], t[3], i2se, t[4], **kw)
    e_k2, o_k2 = fn(t[0], t[1], t[2], t[3], i2se, t[4], **kw)
    e_r, o_r = ref(t[0], t[1], t[2], t[3], i2se, t[4], **kw)
    torch.cuda.synchronize()
    name = "sweep_exact_mt" if exact else "sweep_stale_mt"
    assert tskmt.launches[name] == before[name] + 2
    assert torch.equal(e_k, e_k2) and torch.equal(o_k, o_k2)
    torch.testing.assert_close(e_k, e_r, atol=5e-4, rtol=1e-3)
    torch.testing.assert_close(o_k[:, :T], o_r[:, :T], atol=5e-4, rtol=1e-3)
    assert torch.equal(o_k[:, T:2 * T], o_r[:, T:2 * T])
    assert torch.all(e_k[t[2] == 0.0] == 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("missing,na_frac", [(False, 0.1), (True, 0.0)])
def test_cuda_mt_window_kernels_match_plain(missing, na_frac):
    """window_stats_mt and window_axpy_mt on the card against their plain
    versions (the recurrence: test_cuda_mt_recurrence_matches_plain)."""
    dev = _card()
    T, W = 4, 32
    pk, eps, _, _, _ = make_mt_inputs(96, 256, T, 9, missing, 3, na_frac)
    pk, eps = (torch.from_numpy(a).to(dev) for a in (pk, eps))
    rows = torch.randperm(96, device=dev)[:W].to(torch.int32)
    g = torch.Generator(device=dev).manual_seed(2)
    c1 = 0.05 * torch.randn(T, W, generator=g, device=dev)
    c2 = 0.05 * torch.randn(T, W, generator=g, device=dev)
    before = dict(twk.launches)
    s_k = twk.window_stats_mt(pk, eps, not missing, rows)
    s_r = twk.window_stats_mt_ref(pk, eps, not missing, rows)
    d_k = twk.window_axpy_mt(pk, c1, c2, not missing, rows)
    d_r = twk.window_axpy_mt_ref(pk, c1, c2, not missing, rows)
    torch.cuda.synchronize()
    for name in ("window_stats_mt", "window_axpy_mt"):
        assert twk.launches[name] == before[name] + 1
    assert (s_k[1] is None) == (s_r[1] is None) == (not missing)
    for a, b in zip(s_k, s_r):
        if b is not None:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(d_k, d_r, rtol=1e-5, atol=1e-5)


def mt_recurrence_inputs(source, window, n_traits, n_mix, dev):
    """(args, kwargs) of one multi-trait exact recurrence on ``dev``:
    ``"sweep"`` two windows of ``sweep_exact_mt`` (complete genotypes, full
    phenotypes: the trait-shared integer Gram), with the markers' own mave
    and mstd so the chain stays finite at any W; ``"shared"`` and
    ``"per_trait"`` one window of ``mt_window_recurrence`` on a (W, W) or
    (T, W, W) Gram of 1,024 standard normal columns (the scale of the
    rows' 1/N-sized inv_denom) and num0 of the same scale. The per-trait
    Gram is made unsymmetric: half the off-diagonal spread of noise."""
    from hydra_tpu_torch.ops.decode import decode_planes_hp
    W, T = window, n_traits
    m = 2 * W
    pk, eps, tm, mrow, dnm1 = make_mt_inputs(m, 128, T, W + 7 * n_mix,
                                             False, 3, shared_stats=True,
                                             k=n_mix)
    i2se = torch.linspace(0.6, 0.9, T)
    gen = torch.Generator().manual_seed(W)
    if source == "sweep":
        g, msk = (x.double() for x in decode_planes_hp(torch.from_numpy(pk)))
        n = msk.sum(dim=1)
        mave = g.sum(dim=1) / n.clamp(min=1.0)
        var = (((g - mave[:, None]) * msk) ** 2).sum(dim=1)
        mstd = torch.where(n > 1, torch.sqrt((n - 1) / var.clamp(min=1.0)),
                           0.0)
        b = mrow.reshape(m, -1, T)
        b[:, 0], b[:, 1] = mave[:, None].numpy(), mstd[:, None].numpy()
        order = tsk.block_order(torch.randperm(2, generator=gen), W)
        args = [torch.from_numpy(a) for a in (pk, eps, tm, mrow)]
        args = [a.to(dev) for a in args + [i2se, torch.from_numpy(dnm1)]]
        return args, dict(window=W, n_mix=n_mix, order=order.to(dev))
    rows = torch.randperm(m, generator=gen)[:W].to(torch.int32)
    num0 = 30.0 * torch.randn(W, T, generator=gen)
    x = torch.randn(T if source == "per_trait" else 1, W, 1024,
                    generator=gen).to(dev)
    gram = x @ x.transpose(1, 2)
    if source == "per_trait":
        off = gram[:, ~torch.eye(W, dtype=torch.bool, device=dev)]
        gram = gram + 0.5 * off.std() * torch.randn(
            T, W, W, generator=gen).to(dev)
    else:
        gram = gram[0]
    args = [gram.contiguous()] + [a.to(dev) for a in (
        num0, torch.from_numpy(mrow), i2se)]
    return args, dict(n_mix=n_mix, rows=rows.to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("n_mix", [2, 4, 6, 12])
@pytest.mark.parametrize("n_traits", [1, 4, 16])
@pytest.mark.parametrize("window", [8, 31, 32, 33, 128, 200, 1024])
@pytest.mark.parametrize("source", ["sweep", "shared", "per_trait"])
def test_cuda_mt_recurrence_matches_plain(source, window, n_traits, n_mix):
    """The multi-trait exact recurrence on the card against its plain
    versions: exact_mt_draw_kernel through sweep_exact_mt (its trait-shared
    integer Gram) and window_recurrence_mt_kernel through
    mt_window_recurrence (a shared or a per-trait f32 Gram); within
    tolerance, components equal, bitwise repeatable, one launch a call.
    The windows cross the kernels' 32-marker blocks (31, 33, 200: a ragged
    last block) up to the largest W; K = 4 and the register bounds 8 and
    K_MAX. The per-trait Gram is not symmetric, and the plain version on
    its transpose is checked to fall outside the tolerance, so a
    transposed read fails."""
    from hydra_tpu_torch.ops import sweep_kernel_mt as tskmt
    dev = _card()
    T = n_traits
    args, kw = mt_recurrence_inputs(source, window, T, n_mix, dev)
    if source == "sweep":
        name, fn, ref = ("sweep_exact_mt", tskmt.sweep_exact_mt,
                         tskmt.sweep_exact_mt_ref)

        def comp(o):
            return o[1][:, T:2 * T]
    else:
        name, fn, ref = ("mt_window_recurrence", tskmt.mt_window_recurrence,
                         tskmt.mt_window_recurrence_ref)

        def comp(o):
            return o[1]
    before = tskmt.launches[name]
    k1, k2 = fn(*args, **kw), fn(*args, **kw)
    r = ref(*args, **kw)
    torch.cuda.synchronize()
    assert tskmt.launches[name] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(k1, k2))
    assert torch.equal(comp(k1), comp(r))
    for a, b in zip(k1, r):
        torch.testing.assert_close(a, b, atol=5e-4, rtol=1e-3)
    assert torch.unique(comp(k1)).numel() >= min(3, n_mix)
    if source == "sweep":
        assert torch.all(k1[0][args[2] == 0.0] == 0.0)
    if source == "per_trait":
        swapped = ref(args[0].transpose(1, 2).contiguous(), *args[1:], **kw)
        assert not torch.equal(comp(swapped), comp(r)) or any(
            not torch.allclose(a, b, atol=5e-4, rtol=1e-3)
            for a, b in zip(swapped, r))


@pytest.mark.cuda
@pytest.mark.parametrize("exact,na_frac", [(False, 0.1), (True, 0.0),
                                           (True, 0.1)])
def test_cuda_mt_sampler_sweep_matches_cpu(exact, na_frac):
    """One multi-trait sweep of the CUDA sampler against the CPU sampler
    from the same state with the same noise, for each branch; the branch's
    launch counters move."""
    from hydra_tpu_torch.ops import sweep_kernel_mt as tskmt
    from hydra_tpu_torch.samplers.bayesrrm_mt import (BayesRRmMT,
                                                      state_from_numpy,
                                                      state_to_numpy)
    dev = _card()
    ds = _dataset(300, 700, 3, 0.0)
    rs = np.random.RandomState(4)
    phenos = rs.randn(3, 700)
    phenos[rs.random_sample(phenos.shape) < na_frac] = np.nan
    cpu = BayesRRmMT(ds, phenos, window=32, exact=exact, seed=5,
                     device="cpu")
    gpu = BayesRRmMT(ds, phenos, window=32, exact=exact, seed=5, device=dev)
    s_cpu = cpu.init_state()
    s_gpu = state_from_numpy(state_to_numpy(s_cpu), dev)
    g = torch.Generator().manual_seed(1)
    m = cpu.cfg.m_loc
    noise = dict(mu=torch.randn(3, generator=g),
                 u=torch.rand(m, 3, generator=g),
                 nrm=torch.randn(m, 3, generator=g),
                 wperm=torch.randperm(cpu.cfg.n_windows, generator=g),
                 perm=torch.randperm(m, generator=g))
    before = {**twk.launches, **tskmt.launches}
    a, sa = cpu.step(s_cpu, 0, noise=noise)
    b, sb = gpu.step(s_gpu, 0, noise={k: v.to(dev) for k, v in noise.items()})
    after = {**twk.launches, **tskmt.launches}
    if not exact:
        moved = {"sweep_stale_mt": 1}
    elif na_frac == 0.0:
        moved = {"sweep_exact_mt": 1}
    else:
        moved = {k: gpu.cfg.n_windows for k in (
            "window_stats_mt", "mt_window_recurrence", "window_axpy_mt")}
    for name, count in moved.items():
        assert after[name] == before[name] + count, name
    a, b = state_to_numpy(a), state_to_numpy(b)
    np.testing.assert_allclose(b["mu"], a["mu"], rtol=1e-5)
    np.testing.assert_allclose(b["eps"], a["eps"], atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(b["beta"], a["beta"], atol=5e-4, rtol=1e-3)
    np.testing.assert_array_equal(b["components"], a["components"])
    np.testing.assert_array_equal(sb.cass.cpu().numpy(), sa.cass.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("missing", [False, True])
def test_cuda_window_path_kernels_match_plain(exact, missing):
    """The per-window branch's kernels on the card against their plain
    versions: window_stats (rows read in place), window_gibbs on its Gram,
    and, for complete data, the planes' stats and axpy. The stats and the
    planes add in the plain versions' order (bitwise for s1, s2, the
    complete Gram and the planes, but for pad rows in complete stale data,
    whose 3*eps products the kernel fuses into its multiply-add); the
    missing-data Gram and the recurrence within f32 rounding; components
    equal."""
    from hydra_tpu_torch.ops import gibbs_kernel as tgk
    from hydra_tpu_torch.ops import planes as tpl
    dev = _card()
    pk, eps, _, mrow, n = make_inputs(96, 256, 11, missing, 3)
    pk, eps, mrow = (torch.from_numpy(a).to(dev) for a in (pk, eps, mrow))
    W = 32
    rows = torch.randperm(96, device=dev)[:W].to(torch.int32)
    b = mrow[rows.long()]
    mave, mstd = b[:, 0].contiguous(), b[:, 1].contiguous()
    complete = not missing
    before = {**twk.launches, **tgk.launches, **tpl.launches}
    got = twk.window_stats(pk, eps, mave, mstd, exact, complete, float(n),
                           rows)
    got2 = twk.window_stats(pk, eps, mave, mstd, exact, complete, float(n),
                            rows)
    want = twk.window_stats_ref(pk, eps, mave, mstd, exact, complete,
                                float(n), rows)
    torch.cuda.synchronize()
    for a, a2, r in zip(got, got2, want):
        assert (a is None) == (r is None)
        if r is None:
            continue
        assert torch.equal(a, a2)
        if (r.dim() == 1 and (missing or exact)
                or r.dim() == 2 and complete):
            assert torch.equal(a, r)
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-3)
    if exact:
        s2 = got[1] if got[1] is not None else eps.sum()
        num0 = mstd * (got[0] - mave * s2) + b[:, 2] * float(n - 1)
        cols = (b[:, 6:6 + K], b[:, 6 + K:5 + 2 * K], b[:, 5 + 2 * K:],
                b[:, 3], b[:, 4], b[:, 5], b[:, 2])
        args = [got[2], num0] + [c.contiguous() for c in cols] + [0.7]
        k_out = tgk.window_gibbs(*args)
        r_out = tgk.window_gibbs_ref(*args)
        torch.cuda.synchronize()
        assert torch.equal(k_out[2], r_out[2])
        for a, r in zip(k_out, r_out):
            torch.testing.assert_close(a.float(), r.float(), atol=5e-4,
                                       rtol=1e-3)
    if complete and not exact:
        planes = tpl.build_planes(pk)
        c1 = 0.05 * torch.randn(W, device=dev)
        s_k = tpl.window_stats_planes(planes, eps, rows)
        d_k = tpl.window_axpy_planes(planes, c1, rows)
        torch.cuda.synchronize()
        assert torch.equal(s_k, tpl.window_stats_planes_ref(planes, eps, rows))
        assert torch.equal(d_k, tpl.window_axpy_planes_ref(planes, c1, rows))
    after = {**twk.launches, **tgk.launches, **tpl.launches}
    assert after["window_stats"] == before["window_stats"] + 2
    assert after["window_gibbs"] == before["window_gibbs"] + int(exact)
    for name in ("window_stats_planes", "window_axpy_planes"):
        assert after[name] == before[name] + int(complete and not exact)


# The batched window Grams (window_grams, the exact sweeps' Gram launches):
# windows a call (the cap: gram_batch_windows' windows a launch; cap + 1:
# two launches), W across the 64-row int8 tiles and the 16/32/64-row f32
# tiles, N = 2,048, 2,049 and 5,000 (1, 2 and 3 chunks, pad individuals)
GRAM_BATCHES = (1, 2, 7, "cap", "cap+1")
GRAM_WINDOWS = (1, 8, 33, 64, 128, 200, 1024)
GRAM_NS = (2048, 2049, 5000)


def _batched_gram_params(old, path=None):
    """The test's earlier cases (ids kept), then the batched cases (with
    ``path`` first where the test takes one)."""
    head = () if path is None else (path,)
    return old + [pytest.param(*head, w, n, b, id="-".join(
        [*head, str(w), str(n), f"B{b}"]))
        for w in GRAM_WINDOWS for n in GRAM_NS for b in GRAM_BATCHES]


def _check_batched_grams(window, n, batch, missing):
    """window_grams over windows of a shuffled order of all slots: complete
    data g g^T bit for bit; missing data (2% missing calls, mave and mstd
    per slot) within the forward error bound of its summation order of
    x x^T in float64 on the same f32 x, symmetric bit for bit; both
    repeatable bit for bit, and bit for bit window_stats' Gram of the same
    rows (the per-window path, its individuals split across blocks) at the
    first, middle and last window; the cap launches once, cap + 1 twice."""
    from hydra_tpu_torch.ops.decode import decode_planes_hp
    dev = _card()
    cap = twk.gram_batch_windows(1 << 30, window)
    n_windows = {"cap": cap, "cap+1": cap + 1}.get(batch, batch)
    nb = -(-n // 512) * 128
    m = n_windows * window
    g = torch.Generator(device=dev).manual_seed(window + n)
    h = torch.randint(0, 3, (m, 4 * nb), generator=g, device=dev,
                      dtype=torch.uint8)
    if missing:
        h[torch.rand((m, 4 * nb), generator=g, device=dev) < 0.02] = 3
    h[:, n:] = 3
    pads = torch.randperm(m, generator=g, device=dev)[:m // 8]
    h[pads] = 3
    h4 = h.view(m, nb, 4)
    pk = (h4[..., 0] | (h4[..., 1] << 2) | (h4[..., 2] << 4)
          | (h4[..., 3] << 6)).contiguous()
    del h, h4
    order = torch.randperm(m, generator=g, device=dev).to(torch.int32)
    if missing:
        mave = 2.0 * torch.rand(m, generator=g, device=dev)
        mstd = 0.8 + 0.8 * torch.rand(m, generator=g, device=dev)
        mave[pads], mstd[pads] = 0.0, 0.0
        kw = dict(mave=mave, mstd=mstd)
    else:
        kw = {}
    got = twk.window_grams(pk, order, window, **kw)
    again = twk.window_grams(pk, order, window, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    step = 64
    for w0 in range(0, n_windows, step):
        slots = order[w0 * window:(w0 + step) * window].long()
        part = got[w0:w0 + step]
        if not missing:
            x = decode_planes_hp(pk[slots])[0].view(-1, window, 4 * nb)
            assert torch.equal(part, torch.bmm(x, x.transpose(1, 2)))
            continue
        assert torch.equal(part, part.transpose(1, 2))
        gg, mk = decode_planes_hp(pk[slots])
        x = ((gg - mave[slots, None] * mk) * mstd[slots, None]).double()
        x = x.view(-1, window, 4 * nb)
        bound = (2048 + -(-nb // 512)) * 2.0 ** -24 * torch.bmm(
            x.abs(), x.abs().transpose(1, 2))
        err = (part.double() - torch.bmm(x, x.transpose(1, 2))).abs()
        assert bool((err <= 1.01 * bound).all())
    eps = torch.zeros(4 * nb, device=dev)
    for w in sorted({0, n_windows // 2, n_windows - 1}):
        rows = order[w * window:(w + 1) * window].contiguous()
        if missing:
            av = mave[rows.long()].contiguous()
            sd = mstd[rows.long()].contiguous()
            one = twk.window_stats(pk, eps, av, sd, True, False, float(n),
                                   rows)[2]
        else:
            ones = torch.ones(window, device=dev)
            one = twk.window_stats(pk, eps, ones * 0.0, ones, True, True,
                                   0.0, rows)[2]
        torch.cuda.synchronize()
        assert torch.equal(got[w], one), w
    if batch in ("cap", "cap+1"):
        kernel = "gram_f32_batch_kernel" if missing else "gram_i8_batch_kernel"
        want = {kernel: 1 if batch == "cap" else 2}
        names = _port_launches(lambda: twk.window_grams(pk, order, window,
                                                        **kw))
        assert names == want


@pytest.mark.cuda
@pytest.mark.parametrize("window,n,batch", _batched_gram_params(
    [pytest.param(w, None, None, id=str(w)) for w in (33, 128, 256)]))
def test_cuda_complete_gram_is_exact(window, n, batch):
    """The complete-data Gram (int8 tensor cores) is bit for bit the plain
    version's. The per-window path (window_stats: the individuals split
    across blocks and summed by integer atomics), standardized and raw, and
    the same on a second call (its accumulator is left zeroed), at two
    sizes: the second has more individuals, so more splits reach every
    tile. The batched path (window_grams, as the exact sweeps launch it):
    _check_batched_grams."""
    from hydra_tpu_torch.ops.decode import decode_planes_hp
    if batch is not None:
        _check_batched_grams(window, n, batch, False)
        return
    dev = _card()
    for nb in (256, 2048):
        pk, eps, _, mrow, n = make_inputs(320, nb, 13, False, 4)
        pk, eps, mrow = (torch.from_numpy(a).to(dev) for a in (pk, eps, mrow))
        rows = torch.randperm(320, device=dev)[:window].to(torch.int32)
        b = mrow[rows.long()]
        args = (pk, eps, b[:, 0].contiguous(), b[:, 1].contiguous(), True,
                True, float(n), rows)
        got = twk.window_stats(*args)
        again = twk.window_stats(*args)
        want = twk.window_stats_ref(*args)
        ones = torch.ones(window, device=dev)
        raw = twk.window_stats(pk, eps, ones * 0.0, ones, True, True, 0.0,
                               rows)[2]
        torch.cuda.synchronize()
        g = decode_planes_hp(pk[rows.long()])[0]
        assert torch.equal(raw, g @ g.T)
        assert torch.equal(got[2], again[2])
        assert torch.equal(got[2], want[2])
        assert torch.equal(got[0], want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["exact", "stale", "planes"])
def test_cuda_mega_off_sweep_matches_cpu(kind):
    """One sweep of the per-window branch (--mega off; planes: --cache-planes
    on) on the card against the CPU sampler from the same state with the
    same noise; the branch's kernels launch once per window."""
    from hydra_tpu_torch.ops import gibbs_kernel as tgk
    from hydra_tpu_torch.ops import planes as tpl
    from hydra_tpu_torch.samplers.bayesrrm import (BayesRRm, state_from_numpy,
                                                   state_to_numpy)
    dev = _card()
    ds = _dataset(300, 700, 3, 0.0 if kind == "planes" else 0.03)
    kw = dict(window=32, exact=kind == "exact", seed=5,
              mega="auto" if kind == "planes" else "off",
              plane_cache="on" if kind == "planes" else "off")
    cpu = BayesRRm(ds, device="cpu", **kw)
    gpu = BayesRRm(ds, device=dev, **kw)
    assert gpu.cfg.per_window and gpu.cfg.planes == (kind == "planes")
    s_cpu = cpu.init_state()
    s_gpu = state_from_numpy(state_to_numpy(s_cpu), dev)
    g = torch.Generator().manual_seed(1)
    noise = dict(mu=torch.randn((), generator=g),
                 u=torch.rand(cpu.cfg.m_loc, generator=g),
                 nrm=torch.randn(cpu.cfg.m_loc, generator=g),
                 perm=torch.randperm(cpu.cfg.m_loc, generator=g))
    before = {**twk.launches, **tgk.launches, **tpl.launches}
    a, sa = cpu.step(s_cpu, 0, noise=noise)
    b, sb = gpu.step(s_gpu, 0, noise={k: v.to(dev) for k, v in noise.items()})
    after = {**twk.launches, **tgk.launches, **tpl.launches}
    moved = {"planes": ("window_stats_planes", "window_axpy_planes"),
             "exact": ("window_stats", "window_gibbs", "window_axpy"),
             "stale": ("window_stats", "window_axpy")}[kind]
    for name in moved:
        assert after[name] == before[name] + gpu.cfg.n_windows, name
    a, b = state_to_numpy(a), state_to_numpy(b)
    np.testing.assert_allclose(b["eps"], a["eps"], atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(b["beta"], a["beta"], atol=5e-4, rtol=1e-3)
    np.testing.assert_array_equal(b["components"], a["components"])
    np.testing.assert_array_equal(sb.cass.cpu().numpy(), sa.cass.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("sub_window", [8, 32])
@pytest.mark.parametrize("missing", [False, True])
def test_cuda_sd_kernel_matches_plain(missing, sub_window):
    """On the card: the single-decode sweep against its plain version
    (components equal, eps and beta within the sweep tolerances), bitwise
    repeatable, and with one sub-window a window bit for bit the two-phase
    sweep_stale kernel (the same sums in the same order)."""
    dev = _card()
    pk, eps, mask, mrow, n = make_inputs(256, 256, 7, missing, 9)
    t = [torch.from_numpy(a).to(dev) for a in (pk, eps, mrow, mask)]
    order = torch.randperm(256, device=dev).to(torch.int32)
    kw = dict(window=32, n_mix=K, complete=not missing, ind_mask=t[3],
              order=order)
    before = dict(tsk.launches)
    args = (t[0], t[1], t[2], 0.7, float(n - 1))
    e_k, o_k = tsk.sweep_stale_sd(*args, sub_window=sub_window, **kw)
    e_k2, o_k2 = tsk.sweep_stale_sd(*args, sub_window=sub_window, **kw)
    e_r, o_r = tsk.sweep_stale_sd_ref(*args, sub_window=sub_window, **kw)
    e_2p, o_2p = tsk.sweep_stale(*args, **kw)
    torch.cuda.synchronize()
    assert tsk.launches["sweep_stale_sd"] == before["sweep_stale_sd"] + 2
    assert torch.equal(e_k, e_k2) and torch.equal(o_k, o_k2)
    torch.testing.assert_close(e_k, e_r, atol=5e-4, rtol=1e-3)
    torch.testing.assert_close(o_k[:, 0], o_r[:, 0], atol=5e-4, rtol=1e-3)
    assert torch.equal(o_k[:, 1], o_r[:, 1])
    assert torch.equal(o_k[:, 1], o_2p[:, 1])
    if sub_window == 32:
        assert torch.equal(e_k, e_2p) and torch.equal(o_k, o_2p)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fh_exact", "fh_stale_missing", "sd",
                                  "fh_sd_missing", "fh_mega_off"])
def test_cuda_fh_and_sd_sweep_matches_cpu(kind, monkeypatch):
    """One BayesFH sweep (exact, stale, per-window) and one single-decode
    sweep (HYDRA_TPU_SD=16, marker schedule; BayesRRm and BayesFH) of the
    CUDA sampler against the CPU sampler from the same state with the same
    noise; the branch's kernel launches."""
    from hydra_tpu_torch.samplers.bayesrrm import (BayesRRm, state_from_numpy,
                                                   state_to_numpy)
    dev = _card()
    sd = "sd" in kind
    monkeypatch.setenv("HYDRA_TPU_SD", "16" if sd else "")
    ds = _dataset(300, 700, 3, 0.03 if "missing" in kind else 0.0)
    kw = dict(window=32, exact=kind in ("fh_exact", "fh_mega_off"), seed=5,
              fh=kind.startswith("fh"),
              mega="off" if kind == "fh_mega_off" else "auto",
              schedule="marker" if sd or kind == "fh_mega_off" else "block")
    cpu = BayesRRm(ds, device="cpu", **kw)
    gpu = BayesRRm(ds, device=dev, **kw)
    assert gpu.cfg.sub_window == (16 if sd else 0)
    s_cpu = cpu.init_state()
    s_gpu = state_from_numpy(state_to_numpy(s_cpu), dev)
    g = torch.Generator().manual_seed(1)
    m = cpu.cfg.m_loc
    shape = torch.full((m,), 2.0)
    noise = dict(mu=torch.randn((), generator=g),
                 u=torch.rand(m, generator=g),
                 nrm=torch.randn(m, generator=g),
                 wperm=torch.randperm(cpu.cfg.n_windows, generator=g),
                 perm=torch.randperm(m, generator=g),
                 g_nu=torch._standard_gamma(shape, generator=g),
                 g_lam=torch._standard_gamma(shape, generator=g),
                 fh_gamma=torch._standard_gamma(torch.full((1, 3), 3.0),
                                                generator=g))
    before = {**tsk.launches, **twk.launches}
    a, sa = cpu.step(s_cpu, 0, noise=noise)
    b, sb = gpu.step(s_gpu, 0, noise={k: v.to(dev) for k, v in noise.items()})
    after = {**tsk.launches, **twk.launches}
    name = ("sweep_stale_sd" if sd else "window_stats" if kind == "fh_mega_off"
            else "sweep_exact" if kw["exact"] else "sweep_stale")
    want = gpu.cfg.n_windows if kind == "fh_mega_off" else 1
    assert after[name] == before[name] + want
    a, b = state_to_numpy(a), state_to_numpy(b)
    for f in ("eps", "beta", "lambda_var", "nu_var"):
        np.testing.assert_allclose(b[f], a[f], atol=5e-4, rtol=1e-3,
                                   err_msg=f)
    for f in ("tau", "hyp_tau", "c_slab", "sigma_g"):
        if kw["fh"]:
            np.testing.assert_allclose(b[f], a[f], rtol=1e-4, err_msg=f)
    np.testing.assert_array_equal(b["components"], a["components"])
    np.testing.assert_array_equal(sb.cass.cpu().numpy(), sa.cass.numpy())


def _card_inputs(m, nb, missing, seed, dev, n_pad_markers=3, k=K, n=None):
    """``make_inputs`` made on the card (numpy is too slow for 2,048 rows
    of 50,176 individuals a case): h crumbs 0..2, 5% missing when
    ``missing``, the individuals from n (default: the last 37) padding,
    up to ``n_pad_markers``
    pad markers (a quarter of the rows at most; all missing, mave = mstd =
    bold = act = 0), mave and mstd the markers' own (BayesRRm.cpp:
    1502-1508), so the draws stay finite at any width; mrow rows of k
    mixture components. Returns (pk, eps, mask, mrow, n, pads)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = 4 * nb - 37 if n is None else n
    h = torch.randint(0, 3, (m, 4 * nb), generator=g, device=dev,
                      dtype=torch.uint8)
    if missing:
        h[torch.rand((m, 4 * nb), generator=g, device=dev) < 0.05] = 3
    h[:, n:] = 3
    pads = torch.randperm(m, generator=g, device=dev)[
        :min(n_pad_markers, m // 4)]
    h[pads] = 3
    h4 = h.view(m, nb, 4)
    pk = (h4[..., 0] | (h4[..., 1] << 2) | (h4[..., 2] << 4)
          | (h4[..., 3] << 6)).contiguous()
    eps = torch.randn(4 * nb, generator=g, device=dev)
    eps[n:] = 0.0
    mask = torch.zeros(4 * nb, device=dev)
    mask[:n] = 1.0

    def unif(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)

    real = (h[:, :n] != 3).double()
    gv = (2.0 - h[:, :n].double()) * real
    mave = gv.sum(1) / real.sum(1).clamp(min=1.0)
    var = (((gv - mave[:, None]) * real) ** 2).sum(1)
    mstd = torch.sqrt((n - 1) / var.clamp(min=1.0))
    p = unif(0.05, 1.0, m, k)
    mrow = torch.cat([mave.float()[:, None], mstd.float()[:, None],
                      0.02 * torch.randn((m, 1), generator=g, device=dev),
                      unif(0.0, 1.0, m, 1),
                      torch.randn((m, 1), generator=g, device=dev),
                      torch.ones((m, 1), device=dev),
                      torch.log(p / p.sum(1, keepdim=True)),
                      unif(8e-4, 1.2e-3, m, k - 1),
                      unif(0.02, 0.04, m, k - 1)], dim=1).contiguous()
    mrow[pads, :3] = 0.0
    mrow[pads, 5] = 0.0
    return pk, eps, mask, mrow, n, pads


def _bw_card_sampler(m, nb, missing, window, seed, dev,
                     s_grid=(0.001, 0.01, 0.1)):
    """A BayesW sampler (block schedule, K = len(s_grid) + 1 (4), Q=9) on
    ``_card_inputs``'s genotypes without pad markers, with their own marker
    statistics."""
    from hydra_tpu_torch.data.genotypes import (Dataset, GenotypeData,
                                                make_default_groups)
    from hydra_tpu_torch.ops.decode import crumbs
    from hydra_tpu_torch.samplers.bayesw import BayesW
    pk, _, _, _, n, _ = _card_inputs(m, nb, missing, seed, dev, 0)
    c = crumbs(pk)[:, :n].double()
    real = (c != 3).double()
    gv = (2.0 - c) * real
    mave = gv.sum(1) / real.sum(1)
    var = (((gv - mave[:, None]) * real) ** 2).sum(1)
    mstd = torch.sqrt((n - 1) / var)
    mave_h, mstd_h = mave.cpu().numpy(), mstd.cpu().numpy()
    geno = GenotypeData(packed=np.zeros((0, nb), np.uint8), n=n,
                        n_pad=4 * nb, m=m, mave=mave_h, mstd=mstd_h,
                        msd=1.0 / mstd_h, n1=None, n2=None,
                        nm=(n - real.sum(1)).cpu().numpy())
    groups, mS = make_default_groups(m, list(s_grid))
    rs = np.random.RandomState(seed)
    y = 4.0 + (np.log(rs.exponential(1.0, n)) + 0.5772) / 8.0
    ds = Dataset(geno=geno, y=y, groups=groups, num_groups=1, mS=mS,
                 fail=(rs.random_sample(n) > 0.1).astype(np.float64))
    return BayesW(ds, window=window, seed=seed, quad_points=9, device=dev,
                  packed_device=pk)


# Cases of test_cuda_bw_draw_bitwise whose kernel output (eps, out) was
# already not bit for bit the plain version's before bw_draw_kernel and
# levels_kernel were redesigned: window-n_quad-n_shrink-n_expand-missing
# and the first 16 hex digits of the SHA-256 of eps then out, as the
# kernels before the redesign gave them on an NVIDIA H100 80GB HBM3. All
# are slice draws on a knife edge (mostly the empty slice, le = -1, and
# the level at f(bold), le = 0), where the plain version's torch exp and
# expm1 and the kernel's expf and expm1f (built with -fmad=false) differ
# in a last bit; the kernels are held to those digests instead.
BW_DRAW_NOT_PLAIN = dict(line.split() for line in """
    3-1-24-0-True d0399a04af1e28cc
    3-25-24-0-True 9b2be2d9f6e223ba
    3-64-24-0-True 9b2be2d9f6e223ba
    4-25-24-10-True 7b6e800ac6855831
    4-64-24-10-True 7b6e800ac6855831
    64-1-1-0-False c9ef3ebfb1e5f295
    64-1-1-0-True 636391a3f1501b07
    64-1-1-10-False 23202c60dbac1d12
    64-1-1-10-True fd1822ad76280b35
    64-1-24-0-False 53c591eeedb0aaab
    64-1-24-0-True c999b723ef5b12b3
    64-1-24-10-False 492efe94b736e083
    64-1-24-10-True 4119cc131f23bec0
    64-25-1-0-False ba9888c9df33dc38
    64-25-1-0-True fafd8db8e1f7eadd
    64-25-1-10-False ef57db8e273436c3
    64-25-1-10-True 3c75ffd2f53ff01d
    64-25-24-0-False 4dd0cc6d6519b9a2
    64-25-24-0-True e3f01a6c00a96c38
    64-25-24-10-False a858c4a67feb1821
    64-25-24-10-True 22a935ae939180a3
    64-64-1-0-False 018999def4a9a470
    64-64-1-0-True fafd8db8e1f7eadd
    64-64-1-10-False a33a4e5c4664a075
    64-64-1-10-True f68371f697513eef
    64-64-24-0-False 0f6b020fea148bcf
    64-64-24-0-True e3f01a6c00a96c38
    64-64-24-10-False 2c1ae798f833f38f
    64-64-24-10-True 22a935ae939180a3
    200-1-1-0-False 19924c441060e036
    200-1-1-0-True a32d8daba2f8b735
    200-1-1-10-False 5d6f671fc3c14a91
    200-1-1-10-True 92442274ec025105
    200-1-24-0-False 88ad6cf41c492746
    200-1-24-0-True 9c26ded088aeac04
    200-1-24-10-False afea20ff23a919d3
    200-1-24-10-True 256c8b41f837b099
    200-25-1-0-False e6ac7e62418d0e90
    200-25-1-0-True 469352542df530d5
    200-25-1-10-False 5b99e51830aa9b4c
    200-25-1-10-True a9129d7191fbf161
    200-25-24-0-False efcecf8cae378725
    200-25-24-0-True b801c41648f29c0f
    200-25-24-10-False ffecd43c50727825
    200-25-24-10-True d336fb534c236a1c
    200-64-1-0-False 83325d5da95123e3
    200-64-1-0-True c2148157c22400c2
    200-64-1-10-False 2c48095b39c21dd3
    200-64-1-10-True c8d55a031997e996
    200-64-24-0-False 3df3024a5745b114
    200-64-24-0-True 82bba18347b532da
    200-64-24-10-False 8b07f13162d4be6f
    200-64-24-10-True 56077926c929e318
    1024-1-1-0-False 15cfddf4cda803b5
    1024-1-1-0-True a129a7ad3f2495b5
    1024-1-1-10-False 6afba1f60a930c85
    1024-1-1-10-True 03bf57ba3523d8d5
    1024-1-24-0-False ae0ea704ff332919
    1024-1-24-0-True 863a88414d0d00b6
    1024-1-24-10-False 6741f3b0671f8c7f
    1024-1-24-10-True 40395bd46147efbb
    1024-25-1-0-False af288ba1233c0b8f
    1024-25-1-0-True fe4b37323103eb92
    1024-25-1-10-False 853cc59f751e0698
    1024-25-1-10-True 04226e14a6a7b003
    1024-25-24-0-False 1a012d2898aac048
    1024-25-24-0-True 5157f98b30f7db4e
    1024-25-24-10-False 6e02c74d39d39293
    1024-25-24-10-True 9b1db2c1f757d34f
    1024-64-1-0-False 43c8dd59b36dbba5
    1024-64-1-0-True 84b290c945656b23
    1024-64-1-10-False 7fef0a56c1397e54
    1024-64-1-10-True 202145a05faff3fb
    1024-64-24-0-False 2edc8c0426b5d3cf
    1024-64-24-0-True e9d06b643b76376b
    1024-64-24-10-False 5473205507ed7055
    1024-64-24-10-True 77080ed03fcbd8a5
""".strip().splitlines())


@functools.lru_cache(maxsize=4)
def _bw_draw_state(window, missing):
    """A BayesW sweep's inputs at nb = 640 (two tiles, the second a
    quarter full), three windows of ``window`` markers, with mrow rows
    placed on every branch of the draw: act 0 (pad rows, every 16th), the
    slice level at f(bold) (le = 0), a wide slice (le = 50), an empty one
    (le = -1, u near 1: the shrink budget runs out, x = bold) and a
    vanishing slice limit (stepping out stopped by lower/upper); 20% of the
    markers start at a non-zero effect. Returns (packed, eps, vi, mrow with
    all N_SHRINK shrink uniforms, alpha, ind_mask, order, complete)."""
    dev = _card()
    s = _bw_card_sampler(3 * window, 640, missing, window, 5, dev)
    st = s.init_state()
    g = torch.Generator(device=dev).manual_seed(window)
    m = s.cfg.m_loc
    nz = torch.rand(m, generator=g, device=dev) < 0.2
    st.beta = torch.where(nz, 0.02 * torch.randn(m, generator=g, device=dev),
                          0.0)
    st.pi_l = torch.tensor([[0.5, 0.2, 0.2, 0.1]], device=dev)
    vi = torch.exp(st.alpha * st.eps - tskbw.EULER_MASCHERONI) * s.ind_mask
    mrow = s.build_mrow(st, st.alpha, s.slot_noise(0))
    km1, br = 3, tskbw.N_FIXED + 15
    i = torch.arange(m, device=dev)
    pad = i % 16 == 15
    mrow[pad, :3] = 0.0
    mrow[pad, 4] = 0.0
    mrow[i % 8 == 3, tskbw.N_FIXED + 4 * km1:br] = 1e-5
    mrow[i % 8 == 5, br] = 0.0
    mrow[i % 8 == 6, br] = 50.0
    mrow[i % 8 == 7, br] = -1.0
    mrow[i % 8 == 7, 3] = 0.9999
    return (s.packed, st.eps, vi, mrow, st.alpha, s.ind_mask,
            s.sweep_order(0), s.cfg.complete)


@pytest.mark.cuda
@pytest.mark.parametrize("missing", [False, True])
@pytest.mark.parametrize("n_expand", [0, 10])
@pytest.mark.parametrize("n_shrink", [0, 1, 24])
@pytest.mark.parametrize("n_quad", [1, 25, 64])
@pytest.mark.parametrize("window", [1, 3, 4, 5, 64, 200, 1024])
def test_cuda_bw_draw_bitwise(window, n_quad, n_shrink, n_expand, missing):
    """sweep_stale_bw (bw_draw_kernel a warp per marker, levels_kernel on
    the stats tile) bitwise repeatable and bit for bit its plain version,
    eps and all of out, from ``_bw_draw_state``. The windows cross the
    draw's 4-warp blocks (3, 4, 5) and the last-block ticket of the axpy
    constant (5 and up, three windows a sweep). Where the kernels before
    the redesign already differed from the plain version (BW_DRAW_NOT_PLAIN)
    the output must equal theirs, by digest, and the plain version's within
    the sweep tolerance, components equal."""
    from hydra_tpu_torch.samplers.bayesw import gh_table
    dev = _card()
    pk, eps, vi, mrow, alpha, mask, order, complete = _bw_draw_state(
        window, missing)
    mrow = mrow[:, :tskbw.bw_mrow_width(4, n_shrink)].contiguous()
    gh_x, gh_w = (torch.tensor(a, dtype=torch.float32, device=dev)
                  for a in gh_table(n_quad))
    args = (pk, eps, vi, mrow, gh_x, gh_w, alpha)
    kw = dict(window=window, n_mix=4, complete=complete, ind_mask=mask,
              order=order, n_expand=n_expand, n_shrink=n_shrink)
    e_k, o_k = tskbw.sweep_stale_bw(*args, **kw)
    e_k2, o_k2 = tskbw.sweep_stale_bw(*args, **kw)
    e_r, o_r = tskbw.sweep_stale_bw_ref(*args, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(e_k).all()) and bool(torch.isfinite(o_k).all())
    assert torch.equal(e_k, e_k2) and torch.equal(o_k, o_k2)
    case = f"{window}-{n_quad}-{n_shrink}-{n_expand}-{missing}"
    if case not in BW_DRAW_NOT_PLAIN:
        assert torch.equal(o_k, o_r)
        assert torch.equal(e_k, e_r)
        return
    h = hashlib.sha256()
    for t in (e_k, o_k):
        h.update(t.cpu().numpy().tobytes())
    assert h.hexdigest()[:16] == BW_DRAW_NOT_PLAIN[case]
    assert torch.equal(o_k[:, 1], o_r[:, 1])
    torch.testing.assert_close(e_k, e_r, atol=5e-4, rtol=1e-3)
    torch.testing.assert_close(o_k, o_r, atol=5e-4, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("missing", [False, True])
@pytest.mark.parametrize("nb", [128, 640, 12544])
@pytest.mark.parametrize("window", [1, 7, 64, 128, 200, 1024])
@pytest.mark.parametrize("path", ["window_axpy", "window_stats",
                                  "sweep_stale", "sweep_exact",
                                  "sweep_stale_sd", "sweep_stale_bw",
                                  "window_level_sums"])
def test_cuda_stream_kernels_bitwise(path, window, nb, missing):
    """axpy_kernel, stats_kernel and levels_kernel (each instantiation) bit
    for bit their plain versions, and bitwise repeatable, through every
    entry point that launches them. The windows cross the axpy's 128-row
    shared tile (200, 1024) and the 16-row blocks of stats_kernel and
    levels_kernel (7, 200); nb = 128 is the smallest width the kernels
    take, 640 ends in half a 512-byte tile, 12,544 is N=50,000 (24.5
    tiles). window_axpy, window_stats and window_level_sums against their
    plain versions (window_level_sums on gathered rows and on rows read in
    place through ``rows``) (complete data: but the pad individuals' and pad rows'
    h = 3 products, which the plain version rounds and the kernel fuses;
    window_level_sums' s2 takes h = 3 as 1 and stays bit for bit there);
    the sweeps' eps against the plain axpy replayed from the kernel's own
    draws; sweep_stale_sd (stats_kernel<true>) at a sub-window of the whole
    window against sweep_stale."""
    dev = _card()
    complete = not missing
    m = 2 * window
    if path == "sweep_stale_bw":
        s = _bw_card_sampler(m, nb, missing, window, 5, dev)
        st = s.init_state()
        st.pi_l = torch.tensor([[0.5, 0.2, 0.2, 0.1]], device=dev)
        vi = torch.exp(st.alpha * st.eps - tskbw.EULER_MASCHERONI) * s.ind_mask
        mrow = s.build_mrow(st, st.alpha, s.slot_noise(0))
        order = s.sweep_order(0)
        args = (s.packed, st.eps, vi, mrow, s.gh_x, s.gh_w, st.alpha)
        kw = dict(window=window, n_mix=4, complete=s.cfg.complete,
                  ind_mask=s.ind_mask, order=order)
        assert s.cfg.complete == complete
        e_k, o_k = tskbw.sweep_stale_bw(*args, **kw)
        e_k2, o_k2 = tskbw.sweep_stale_bw(*args, **kw)
        e_r = twk.sweep_update_ref(s.packed, st.eps, mrow, o_k[:, 2], order,
                                   window, "stale" if complete else "missing",
                                   s.ind_mask)
        torch.cuda.synchronize()
        assert torch.equal(e_k, e_k2) and torch.equal(o_k, o_k2)
        assert torch.equal(e_k, e_r)
        return
    pk, eps, mask, mrow, n, pads = _card_inputs(m, nb, missing, 7, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = torch.randperm(m, generator=gen, device=dev)[:window].to(
        torch.int32)
    if path == "window_axpy":
        c1 = 0.05 * torch.randn(window, generator=gen, device=dev)
        c1[mrow[rows.long(), 1] == 0.0] = 0.0       # pad rows: mstd = 0
        c2 = -c1 * mrow[rows.long(), 0]
        d_k = twk.window_axpy(pk, c1, c2, complete, rows)
        d_k2 = twk.window_axpy(pk, c1, c2, complete, rows)
        d_r = twk.window_axpy_ref(pk, c1, c2, complete, rows)
        torch.cuda.synchronize()
        assert torch.equal(d_k, d_k2)
        assert torch.equal(d_k[:n], d_r[:n])
        if missing:
            assert torch.equal(d_k, d_r)
        return
    if path == "window_level_sums":
        pk_w = pk[rows.long()].contiguous()
        vi = torch.exp(0.5 * eps - tskbw.EULER_MASCHERONI) * mask
        got = twk.window_level_sums(pk_w, vi, complete)
        again = twk.window_level_sums(pk_w, vi, complete)
        want = twk.window_level_sums_ref(pk_w, vi, complete)
        # the rows read in place (BayesW --mega off) as the gathered ones
        via = twk.window_level_sums(pk, vi, complete, rows)
        torch.cuda.synchronize()
        for a, v in zip(got, via):
            assert (a is None and v is None) or torch.equal(a, v)
        real = mrow[rows.long(), 1] != 0.0          # not a pad row
        for i, (a, a2, r) in enumerate(zip(got, again, want)):
            assert (a is None) == (r is None)
            if r is None:
                continue
            assert torch.equal(a, a2)
            if complete and i == 0:
                assert torch.equal(a[real], r[real])
            else:
                assert torch.equal(a, r)
        return
    if path == "window_stats":
        b = mrow[rows.long()]
        real = b[:, 1] != 0.0                       # not a pad row
        for exact in ((False, True) if complete else (False,)):
            args = (pk, eps, b[:, 0].contiguous(), b[:, 1].contiguous(),
                    exact, complete, float(n), rows)
            got = twk.window_stats(*args)
            again = twk.window_stats(*args)
            want = twk.window_stats_ref(*args)
            torch.cuda.synchronize()
            for a, a2, r in zip(got[:2], again[:2], want[:2]):
                assert (a is None) == (r is None)
                if r is None:
                    continue
                assert torch.equal(a, a2)
                if complete and not exact:
                    assert torch.equal(a[real], r[real])
                else:
                    assert torch.equal(a, r)
        return
    order = tsk.block_order(torch.randperm(2, generator=gen, device=dev),
                            window)
    kw = dict(window=window, n_mix=K, complete=complete,
              ind_mask=mask if complete else None, order=order)
    if path == "sweep_stale_sd":
        e_k, o_k = tsk.sweep_stale_sd(pk, eps, mrow, 0.7, float(n - 1),
                                      sub_window=window, **kw)
        e_k2, o_k2 = tsk.sweep_stale_sd(pk, eps, mrow, 0.7, float(n - 1),
                                        sub_window=window, **kw)
        e_s, o_s = tsk.sweep_stale(pk, eps, mrow, 0.7, float(n - 1), **kw)
        torch.cuda.synchronize()
        assert torch.equal(e_k, e_k2) and torch.equal(o_k, o_k2)
        assert torch.equal(e_k, e_s) and torch.equal(o_k, o_s)
        return
    exact = path == "sweep_exact"
    fn = tsk.sweep_exact if exact else tsk.sweep_stale
    e_k, o_k = fn(pk, eps, mrow, 0.7, float(n - 1), **kw)
    e_k2, o_k2 = fn(pk, eps, mrow, 0.7, float(n - 1), **kw)
    mode = "missing" if missing else ("exact" if exact else "stale")
    e_r = twk.sweep_update_ref(pk, eps, mrow, o_k[:, 3], order, window, mode,
                               mask)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(e_k).all()) and bool(torch.isfinite(o_k).all())
    assert torch.equal(e_k, e_k2) and torch.equal(o_k, o_k2)
    assert torch.equal(e_k, e_r)


def _card_mt_inputs(m, nb, T, missing, exact, seed, dev, k=K):
    """``_card_inputs`` with T traits: eps and the trait mask (n_pad, T),
    10% NaN per trait unless ``exact`` (full phenotypes), mrow (m,
    T*(3k+4)) whose beta_old, u and nrm differ by trait, and, unless
    ``exact`` (trait 0's statistics for every trait), mstd too. Returns
    (pk, eps, tm, mrow, dnm1, n, pads)."""
    from hydra_tpu_torch.ops.sweep_kernel_mt import mt_mrow_width
    pk, _, _, row1, n, pads = _card_inputs(m, nb, missing, seed, dev, k=k)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    tm = torch.zeros((4 * nb, T), device=dev)
    tm[:n] = (torch.rand((n, T), generator=g, device=dev)
              >= (0.0 if exact else 0.1)).float()
    eps = torch.randn((4 * nb, T), generator=g, device=dev) * tm
    b = row1[:, :, None].repeat(1, 1, T)
    b[:, 2] = 0.02 * torch.randn((m, T), generator=g, device=dev)
    b[:, 3] = torch.rand((m, T), generator=g, device=dev)
    b[:, 4] = torch.randn((m, T), generator=g, device=dev)
    if not exact:
        b[:, 1] *= 0.9 + 0.2 * torch.rand((m, T), generator=g, device=dev)
    b[pads, 2] = 0.0
    mrow = b.reshape(m, -1).contiguous()
    assert mrow.shape[1] == mt_mrow_width(k, T)
    return pk, eps, tm, mrow, tm.sum(dim=0) - 1.0, n, pads


MT_STREAM_CASES = [
    (path, window, nb, n_traits, missing)
    for path in ("window_stats_mt", "window_axpy_mt", "sweep_stale_mt",
                 "sweep_exact_mt")
    for window in (1, 7, 64, 128, 200, 1024)
    for nb in (128, 640, 12544)
    for n_traits in (1, 3, 4, 16)
    for missing in (False, True)
    if not (path == "sweep_exact_mt" and missing)]


@pytest.mark.cuda
@pytest.mark.parametrize("path,window,nb,n_traits,missing", MT_STREAM_CASES)
def test_cuda_mt_stream_kernels_bitwise(path, window, nb, n_traits, missing):
    """axpy_mt_kernel and stats_mt_kernel (each instantiation by mode and
    trait bound, T = 3 below its bound 4) bit for bit their plain versions
    in the kernels' order, and bitwise repeatable, through every entry point
    that launches them.
    The windows cross the axpy's 128-row shared tile (200, 1024) and the
    stats' row groups (7, 200); nb = 128 is the smallest width the kernels
    take, 640 ends in a quarter of a 512-byte tile, 12,544 is N=50,000.
    window_stats_mt and window_axpy_mt against window_stats_mt_seq and
    window_axpy_mt_seq (complete data: but the pad rows' and pad
    individuals' h = 3 products, which the plain versions round and the
    kernels fuse); the sweeps' eps against sweep_update_mt_ref replayed
    from the kernels' own draws."""
    from hydra_tpu_torch.ops import sweep_kernel_mt as tskmt
    dev = _card()
    complete = not missing
    exact = path == "sweep_exact_mt"
    m = 2 * window
    pk, eps, tm, mrow, dnm1, n, pads = _card_mt_inputs(
        m, nb, n_traits, missing, exact, 7, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = torch.randperm(m, generator=gen, device=dev)[:window].to(
        torch.int32)
    real = ~torch.isin(rows.long(), pads)
    if path == "window_stats_mt":
        got = twk.window_stats_mt(pk, eps, complete, rows)
        again = twk.window_stats_mt(pk, eps, complete, rows)
        want = twk.window_stats_mt_seq(pk, eps, complete, rows)
        torch.cuda.synchronize()
        keep = real if complete else slice(None)
        for a, a2, r in zip(got, again, want):
            assert (a is None) == (r is None)
            if r is not None:
                assert torch.equal(a, a2)
                assert torch.equal(a[keep], r[keep])
        return
    if path == "window_axpy_mt":
        c1 = 0.05 * torch.randn((n_traits, window), generator=gen, device=dev)
        c1[:, ~real] = 0.0
        c2 = -c1 * mrow[rows.long(), 0][None, :]
        d_k = twk.window_axpy_mt(pk, c1, c2, complete, rows)
        d_k2 = twk.window_axpy_mt(pk, c1, c2, complete, rows)
        d_r = twk.window_axpy_mt_seq(pk, c1, c2, complete, rows)
        torch.cuda.synchronize()
        assert torch.equal(d_k, d_k2)
        assert torch.equal(d_k[:n], d_r[:n])
        if missing:
            assert torch.equal(d_k, d_r)
        return
    order = tsk.block_order(torch.randperm(2, generator=gen, device=dev),
                            window)
    i2se = torch.linspace(0.6, 0.9, n_traits, device=dev)
    kw = dict(window=window, n_mix=K, order=order)
    if exact:
        fn = tskmt.sweep_exact_mt
    else:
        fn = tskmt.sweep_stale_mt
        kw["complete"] = complete
    e_k, o_k = fn(pk, eps, tm, mrow, i2se, dnm1, **kw)
    e_k2, o_k2 = fn(pk, eps, tm, mrow, i2se, dnm1, **kw)
    e_r = twk.sweep_update_mt_ref(pk, eps, tm, mrow, o_k, order, window,
                                  complete)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(e_k).all()) and bool(torch.isfinite(o_k).all())
    assert torch.equal(e_k, e_k2) and torch.equal(o_k, o_k2)
    assert torch.equal(e_k, e_r)


@pytest.mark.cuda
@pytest.mark.parametrize("n_traits", (1, 4, 16))
@pytest.mark.parametrize("missing", (False, True))
def test_cuda_window_stats_mt_unaligned_eps(n_traits, missing):
    """stats_mt_kernel on a contiguous eps view that starts 4 bytes past a
    16-byte boundary (a slice of a larger tensor) gives the bits it gives on
    an aligned copy, where it stages the tile's eps 16 bytes a copy."""
    dev = _card()
    complete = not missing
    window, nb = 128, 640
    pk, eps, _, _, _, _, _ = _card_mt_inputs(
        2 * window, nb, n_traits, missing, False, 11, dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = torch.randperm(2 * window, generator=gen, device=dev)[:window].to(
        torch.int32)
    flat = torch.zeros(eps.numel() + 1, device=dev)
    flat[1:] = eps.reshape(-1)
    view = flat[1:].view(eps.shape)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    assert eps.data_ptr() % 16 == 0
    got = twk.window_stats_mt(pk, view, complete, rows)
    want = twk.window_stats_mt(pk, eps, complete, rows)
    torch.cuda.synchronize()
    for a, r in zip(got, want):
        assert (a is None) == (r is None)
        if r is not None:
            assert torch.equal(a, r)


STALE_FOLD_CASES = (
    [("sweep_stale", window, n_mix, 1, missing, 640)
     for window in (1, 2, 7, 8, 9, 64, 128, 256, 257, 1024)
     for n_mix in (2, 4, 16) for missing in (False, True)]
    + [("sweep_stale_mt", window, n_mix, n_traits, missing, 640)
       for window in (8, 64, 257, 1024) for n_mix in (2, 4, 16)
       for n_traits in (1, 4, 16) for missing in (False, True)]
    + [("sweep_stale_sd", sub_window, n_mix, 1, missing, 640)
       for sub_window in (16, 64) for n_mix in (2, 4, 16)
       for missing in (False, True)]
    # 33 tiles of 2,048 individuals: two batches of the tile partials' loads
    + [("sweep_stale", 64, 4, 1, False, 16896),
       ("sweep_stale", 9, 2, 1, True, 16896),
       ("sweep_stale_mt", 64, 4, 4, False, 16896),
       ("sweep_stale_sd", 16, 4, 1, True, 16896)])


def stale_mt_f64(pk, eps, tm, mrow, i2se, dnm1, *, window, n_mix, order):
    """The stale multi-trait sweep on complete genotypes in float64:
    sweep_stale_mt_ref's operations with every operand widened, the
    independent witness of a case on a knife edge of the f32 plain
    version. Returns (eps, out), float64."""
    from hydra_tpu_torch.ops.decode import decode_h
    from hydra_tpu_torch.ops.sweep_kernel_mt import draw_normalized
    f64 = torch.float64
    T = eps.shape[1]
    eps, tm, i2se, dnm1 = (x.to(f64) for x in (eps, tm, i2se, dnm1))
    out = torch.zeros((pk.shape[0], 3 * T), dtype=f64, device=pk.device)
    for w in range(pk.shape[0] // window):
        slots = order[w * window:(w + 1) * window]
        b = mrow[slots].to(f64).reshape(window, -1, T)
        mave, mstd, bold = b[:, 0], b[:, 1], b[:, 2]
        h = decode_h(pk[slots], f64)
        s2 = eps.sum(dim=0)
        s1 = 2.0 * s2 - h @ eps
        bnew, comp, acum = draw_normalized(
            b, mstd * (s1 - mave * s2) + bold * dnm1, i2se, n_mix)
        c1 = (bold - bnew) * mstd
        c2 = -c1 * mave
        eps = eps + (2.0 * c1.sum(dim=0) + c2.sum(dim=0) - h.T @ c1) * tm
        out[slots] = torch.cat([bnew, comp, acum], dim=1)
    return eps, out


# A case whose plain version, in f32 with the stats summed by matmul, takes
# another component than the kernels on a knife edge: the kernels' outputs
# are held instead to the SHA-256 prefix of (eps, out) that the kernels
# before the fold gave (the same bits), to the number of components that
# differ from the plain version there, and to the same sweep in float64
# (stale_mt_f64): components equal, eps and beta within the sweep
# tolerance. Its marker is in the second window, after the first's
# updates, where the plain eps is up to 1.1e-3 off the kernel's.
STALE_FOLD_NOT_PLAIN = {
    ("sweep_stale_mt", 1024, 16, 4, False, 640): ("2261b2e97e4994e3", 1)}


@pytest.mark.cuda
@pytest.mark.parametrize("path,window,n_mix,n_traits,missing,nb",
                         STALE_FOLD_CASES)
def test_cuda_stale_fold_matches_plain(path, window, n_mix, n_traits,
                                       missing, nb):
    """The stale sweeps, whose axpy draws its window itself (every block
    draws all W markers; block 0 writes out), against their plain versions
    at every mixture bound of the draw (K 2 and 4 below their bounds 8 and
    4, 16 at K_MAX) and windows that cross the axpy's direct path (W <= 8),
    a float4 of coefficients (W = 2, 7, 9, 257), its 128-row tile (257,
    1024) and the fold thresholds (256 and 257; multi-trait 64 and 257),
    complete and with missing genotypes, at nb = 640 (2 tiles of
    partials) and 16,896 (33 tiles: two batches of their loads): components
    equal, eps and beta within the sweep tolerance, bitwise repeatable.
    sweep_stale's and sweep_stale_mt's eps bit for bit the plain axpy
    replayed from the kernel's own draws (sweep_update_ref,
    sweep_update_mt_ref); sweep_stale_mt at T = 1, 4, 16 traits;
    sweep_stale_sd a window of 64 in sub-windows of 16 (components equal
    to sweep_stale's) and 64 (bit for bit sweep_stale)."""
    from hydra_tpu_torch.ops import sweep_kernel_mt as tskmt
    dev = _card()
    complete = not missing
    W = 64 if path == "sweep_stale_sd" else window
    m = 2 * W
    gen = torch.Generator(device=dev).manual_seed(3)
    order = tsk.block_order(torch.randperm(2, generator=gen, device=dev), W)
    if path == "sweep_stale_mt":
        pk, eps, tm, mrow, dnm1, n, _ = _card_mt_inputs(
            m, nb, n_traits, missing, False, 5, dev, k=n_mix)
        i2se = torch.linspace(0.6, 0.9, n_traits, device=dev)
        args = (pk, eps, tm, mrow, i2se, dnm1)
        kw = dict(window=W, n_mix=n_mix, complete=complete, order=order)
        e_k, o_k = tskmt.sweep_stale_mt(*args, **kw)
        e_k2, o_k2 = tskmt.sweep_stale_mt(*args, **kw)
        e_r, o_r = tskmt.sweep_stale_mt_ref(*args, **kw)
        same = torch.equal(e_k, twk.sweep_update_mt_ref(
            pk, eps, tm, mrow, o_k, order, W, complete))
        comp, beta = slice(n_traits, 2 * n_traits), slice(0, n_traits)
    else:
        pk, eps, mask, mrow, n, _ = _card_inputs(m, nb, missing, 5, dev,
                                                 k=n_mix)
        args = (pk, eps, mrow, 0.7, float(n - 1))
        kw = dict(window=W, n_mix=n_mix, complete=complete,
                  ind_mask=mask if complete else None, order=order)
        if path == "sweep_stale_sd":
            e_k, o_k = tsk.sweep_stale_sd(*args, sub_window=window, **kw)
            e_k2, o_k2 = tsk.sweep_stale_sd(*args, sub_window=window, **kw)
            e_r, o_r = tsk.sweep_stale_sd_ref(*args, sub_window=window, **kw)
            e_s, o_s = tsk.sweep_stale(*args, **kw)
            same = torch.equal(o_k[:, 1], o_s[:, 1]) and (
                window < W or (torch.equal(e_k, e_s) and torch.equal(o_k, o_s)))
        else:
            e_k, o_k = tsk.sweep_stale(*args, **kw)
            e_k2, o_k2 = tsk.sweep_stale(*args, **kw)
            e_r, o_r = tsk.sweep_stale_ref(*args, **kw)
            same = torch.equal(e_k, twk.sweep_update_ref(
                pk, eps, mrow, o_k[:, 3], order, W,
                "stale" if complete else "missing", mask))
        comp, beta = 1, 0
    torch.cuda.synchronize()
    assert bool(torch.isfinite(e_k).all()) and bool(torch.isfinite(o_k).all())
    assert torch.equal(e_k, e_k2) and torch.equal(o_k, o_k2)
    assert same
    known = STALE_FOLD_NOT_PLAIN.get((path, window, n_mix, n_traits, missing,
                                      nb))
    if known is not None:
        h = hashlib.sha256()
        for t in (e_k, o_k):
            h.update(t.contiguous().cpu().numpy().tobytes())
        assert h.hexdigest()[:16] == known[0]
        assert int((o_k[:, comp] != o_r[:, comp]).sum()) == known[1]
        e_w, o_w = stale_mt_f64(pk, eps, tm, mrow, i2se, dnm1, window=W,
                                n_mix=n_mix, order=order)
        n_kernel = int((o_k[:, comp].double() != o_w[:, comp]).sum())
        n_plain = int((o_r[:, comp].double() != o_w[:, comp]).sum())
        assert n_kernel == 0, (f"float64 takes other components than the "
                               f"kernels at {n_kernel} markers, than the f32 "
                               f"plain version at {n_plain}")
        torch.testing.assert_close(e_k.double(), e_w, atol=5e-4, rtol=1e-3)
        torch.testing.assert_close(o_k[:, beta].double(), o_w[:, beta],
                                   atol=5e-4, rtol=1e-3)
        return
    assert torch.equal(o_k[:, comp], o_r[:, comp])
    if m >= 128:
        assert len(torch.unique(o_k[:, comp])) >= min(3, n_mix)
    torch.testing.assert_close(e_k, e_r, atol=5e-4, rtol=1e-3)
    torch.testing.assert_close(o_k[:, beta], o_r[:, beta], atol=5e-4,
                               rtol=1e-3)


def _device_launches(fn):
    """{device activity: launches} of one call of fn, every kernel and
    memset of the card from torch.profiler but the warm-up spin kernels (a
    session that comes back empty is taken again)."""
    import time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # a session's first kernels can go unrecorded (up to 7 seen,
            # a sweep's Gram among them): spin kernels and a pause first
            for _ in range(16):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(0.02)
            fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if (getattr(e, "device_type", None) == DeviceType.CUDA
                    and "spin_kernel" not in e.key):
                out[e.key] = out.get(e.key, 0) + e.count
        if out:
            return out
    pytest.fail("the profiler saw no device activity")


def _port_launches(fn):
    """{port kernel name: launches} of one call of fn, from
    ``_device_launches``."""
    out = {}
    for key, count in _device_launches(fn).items():
        if "hydra::" in key:
            name = key.split("hydra::", 1)[1].split("<", 1)[0]
            name = name.split("(", 1)[0]
            out[name] = out.get(name, 0) + count
    if not out:
        pytest.fail("the profiler saw no kernel of the port")
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("path,window,n,batch", _batched_gram_params(
    [pytest.param(p, w, n, None, id=f"{p}-{w}-{n}")
     for p in ("window_stats", "sweep_exact")
     for w in (1, 20, 32, 33, 64, 128, 256, 1024) for n in (2048, 2049, 5000)],
    "window_grams"))
def test_cuda_missing_gram(path, window, n, batch):
    """The missing-data Gram (gram_f32_batch_kernel: fmaf chains over the
    symmetric half, its 2,048-individual chunks added in order; the sweep
    computes its windows' Grams in one launch, window_stats splits the
    chunks across blocks and the last block of each tile adds them) through
    both callers, at N = 2,048, 2,049 and 5,000 (1, 2 and 3 chunks), with
    pad individuals and, from W = 20, pad rows (all missing, mave = mstd =
    0; window_stats' window holds one): each entry of each window's Gram
    within the forward error bound of its summation order of x x^T in
    float64 on the same f32 x (the 2.8e-5 of the diagonal seen at N=50,000
    is exceeded at N=2,048 by the parent's kernels too, bit for bit the
    same), G == G^T bit for bit, two calls bit for bit equal, and the
    profile one Gram launch a window_stats call and one a sweep (both
    windows), none a window of the sweep. The sweep reads its rows'
    statistics by slot from mrow; window_stats on the same window's rows
    gives its Gram, and the sweep's eps is bit for bit the plain axpy
    replayed from its own draws. window_grams (the batched path on many
    windows): _check_batched_grams."""
    from hydra_tpu_torch.ops.decode import decode_planes_hp
    if batch is not None:
        _check_batched_grams(window, n, batch, True)
        return
    dev = _card()
    nb = -(-n // 512) * 128
    m = 2 * window
    pk, eps, _, mrow, _, pads = _card_inputs(m, nb, True, 3 + window, dev,
                                             n_pad_markers=2, n=n)
    gen = torch.Generator(device=dev).manual_seed(window)
    if path == "window_stats":
        rest = torch.randperm(m, generator=gen, device=dev)
        if pads.numel():
            rest = torch.cat([pads[:1], rest[rest != pads[0]]])
        windows = [rest[:window].to(torch.int32)]
    else:
        order = tsk.block_order(torch.randperm(2, generator=gen, device=dev),
                                window)
        windows = [order[:window], order[window:]]

    def gram(rows):
        b = mrow[rows.long()]
        return twk.window_stats(pk, eps, b[:, 0].contiguous(),
                                b[:, 1].contiguous(), True, False, float(n),
                                rows.contiguous())[2]

    for rows in windows:
        g1, g2 = gram(rows), gram(rows)
        b = mrow[rows.long()]
        g, mk = decode_planes_hp(pk[rows.long()])
        x = ((g - b[:, :1] * mk) * b[:, 1:2]).double()
        torch.cuda.synchronize()
        assert torch.equal(g1, g2)
        assert torch.equal(g1, g1.T)
        # the forward error bound of the kernel's order: one chain of at
        # most 2,048 fmaf a chunk, then the chunks in order
        bound = (2048 + -(-nb // 512)) * 2.0 ** -24 * (x.abs() @ x.abs().T)
        assert bool(((g1.double() - x @ x.T).abs() <= 1.01 * bound).all())
    if path == "window_stats":
        names = _port_launches(lambda: gram(windows[0]))
        assert names.get("gram_f32_batch_kernel") == 1
        assert not {"gram_reduce_kernel", "gram_kernel",
                    "gram_f32_kernel"} & set(names)
        return
    kw = dict(window=window, n_mix=K, complete=False, order=order)
    e_k, o_k = tsk.sweep_exact(pk, eps, mrow, 0.7, float(n - 1), **kw)
    e_k2, o_k2 = tsk.sweep_exact(pk, eps, mrow, 0.7, float(n - 1), **kw)
    e_r = twk.sweep_update_ref(pk, eps, mrow, o_k[:, 3], order, window,
                               "missing")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(e_k).all()) and bool(torch.isfinite(o_k).all())
    assert torch.equal(e_k, e_k2) and torch.equal(o_k, o_k2)
    assert torch.equal(e_k, e_r)
    names = _port_launches(lambda: tsk.sweep_exact(
        pk, eps, mrow, 0.7, float(n - 1), **kw))
    assert names.get("gram_f32_batch_kernel") == 1
    assert not {"gram_reduce_kernel", "gram_kernel",
                "gram_f32_kernel"} & set(names)
    assert sum(names.values()) == 3 * 2 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["complete", "missing", "mt"])
def test_cuda_exact_sweep_grams_per_batch(kind):
    """An exact sweep of one window more than a batch of Grams holds (W =
    1024: gram_batch_windows' cap + 1 windows) launches its Grams once a
    batch, twice in all, beside 3 kernels a window, and is bit for bit the
    same sweep run as two sweeps, the batch's windows and then the last
    window alone from the first's eps (each window's draw reads its own
    Gram of the batch). BayesRRm on complete and 5% missing calls, and
    multi-trait (T=3, complete, full phenotypes)."""
    from hydra_tpu_torch.ops import sweep_kernel_mt as tskmt
    dev = _card()
    W, nb = 1024, 512
    cap = twk.gram_batch_windows(1 << 30, W)
    m = (cap + 1) * W
    missing = kind == "missing"
    if kind == "mt":
        pk, eps, tm, mrow, dnm1, n, _ = _card_mt_inputs(m, nb, 3, False, True,
                                                        21, dev)
        i2se = torch.full((3,), 0.7, device=dev)

        def sweep(pk, eps, mrow, order):
            return tskmt.sweep_exact_mt(pk, eps, tm, mrow, i2se, dnm1,
                                        window=W, n_mix=K, order=order)
        kernel = "gram_i8_batch_kernel"
    else:
        pk, eps, mask, mrow, n, _ = _card_inputs(m, nb, missing, 21, dev)

        def sweep(pk, eps, mrow, order):
            return tsk.sweep_exact(pk, eps, mrow, 0.7, float(n - 1), window=W,
                                   n_mix=K, complete=not missing,
                                   ind_mask=None if missing else mask,
                                   order=order)
        kernel = "gram_f32_batch_kernel" if missing else "gram_i8_batch_kernel"
    gen = torch.Generator(device=dev).manual_seed(3)
    order = tsk.block_order(torch.randperm(cap + 1, generator=gen, device=dev),
                            W)
    e_k, o_k = sweep(pk, eps, mrow, order)
    head, tail = order[:cap * W].long(), order[cap * W:].long()
    arange = torch.arange(cap * W, device=dev, dtype=torch.int32)
    e_a, o_a = sweep(pk[head].contiguous(), eps, mrow[head].contiguous(),
                     arange)
    e_b, o_b = sweep(pk[tail].contiguous(), e_a, mrow[tail].contiguous(),
                     arange[:W].contiguous())
    torch.cuda.synchronize()
    assert bool(torch.isfinite(e_k).all()) and bool(torch.isfinite(o_k).all())
    assert torch.equal(e_k, e_b)
    assert torch.equal(o_k[head], o_a) and torch.equal(o_k[tail], o_b)
    names = _port_launches(lambda: sweep(pk, eps, mrow, order))
    assert names.get(kernel) == 2
    assert sum(names.values()) == 3 * (cap + 1) + 2


# The planes kernels: window_stats_planes (one launch a call, its tiles'
# partials added by the last block of each row group's ticket, counters in
# a workspace a device that the kernel leaves at 0) and window_axpy_planes
# (a thread per individual over cp.async chunks of the window's rows).

def _card_planes(m, n_pad, seed, dev):
    """(m, n_pad) int8 planes of genotypes 0..2 on the card, row 0 all
    zero (a pad marker), and eps (n_pad,)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    planes = torch.randint(0, 3, (m, n_pad), generator=g, device=dev,
                           dtype=torch.int8)
    planes[0] = 0
    eps = torch.randn(n_pad, generator=g, device=dev)
    return planes, eps, g


@pytest.mark.cuda
@pytest.mark.parametrize("n_pad", [512, 4_608, 50_176])
@pytest.mark.parametrize("window", [1, 8, 31, 33, 64, 200, 1024])
def test_cuda_planes_bitwise(window, n_pad):
    """Both planes kernels bit for bit their plain versions on W rows in
    shuffled order from 2 W + 1 (the zero row among them, and the first
    slot repeated last from W = 8 on), at widths of one short stats tile
    (512 individuals), two whole tiles and a ragged third (4,608) and
    N=50,000 (50,176: 24 whole tiles and a half); a second call is bit for
    bit the first."""
    from hydra_tpu_torch.ops import planes as tpl
    dev = _card()
    m = 2 * window + 1
    planes, eps, g = _card_planes(m, n_pad, 29 + window, dev)
    rows = torch.randperm(m, generator=g, device=dev)[:window]
    rows[window // 2] = 0
    if window >= 8:
        rows[-1] = rows[0]
    rows = rows.to(torch.int32)
    c1 = 0.05 * torch.randn(window, generator=g, device=dev)
    before = dict(tpl.launches)
    s_k = tpl.window_stats_planes(planes, eps, rows)
    s_k2 = tpl.window_stats_planes(planes, eps, rows)
    d_k = tpl.window_axpy_planes(planes, c1, rows)
    d_k2 = tpl.window_axpy_planes(planes, c1, rows)
    torch.cuda.synchronize()
    assert tpl.launches["window_stats_planes"] == (
        before["window_stats_planes"] + 2)
    assert tpl.launches["window_axpy_planes"] == (
        before["window_axpy_planes"] + 2)
    assert torch.equal(s_k, tpl.window_stats_planes_ref(planes, eps, rows))
    assert torch.equal(d_k, tpl.window_axpy_planes_ref(planes, c1, rows))
    assert torch.equal(s_k, s_k2) and torch.equal(d_k, d_k2)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["stats", "axpy"])
def test_cuda_planes_one_launch(which):
    """One window_stats_planes call and one window_axpy_planes call (W=64,
    N=50,000) are each one CUDA kernel on the card: no second reduction
    kernel, no memset or allocation fill of a workspace, no torch op."""
    from hydra_tpu_torch.ops import planes as tpl
    dev = _card()
    planes, eps, g = _card_planes(128, 50_176, 31, dev)
    rows = torch.arange(64, 128, dtype=torch.int32, device=dev)
    c1 = 0.05 * torch.randn(64, generator=g, device=dev)
    fn = ((lambda: tpl.window_stats_planes(planes, eps, rows))
          if which == "stats" else
          (lambda: tpl.window_axpy_planes(planes, c1, rows)))
    fn()
    got = _device_launches(fn)
    assert sum(got.values()) == 1, got
    assert f"hydra::{which}_planes_kernel" in next(iter(got)), got


@pytest.mark.cuda
def test_cuda_planes_stats_workspace_counters_return_to_zero():
    """Calls of W = 8, 1024, 8, 64, 1024 and 8 on the one workspace of the
    stream give the plain version's s1 bit for bit, and after each call
    every ticket counter is 0 again."""
    from hydra_tpu_torch.ops import planes as tpl
    dev = _card()
    planes, eps, g = _card_planes(2048, 50_176, 37, dev)
    for window in (8, 1024, 8, 64, 1024, 8):
        rows = torch.randperm(2048, generator=g, device=dev)[:window].to(
            torch.int32)
        want = tpl.window_stats_planes_ref(planes, eps, rows)
        s = tpl.window_stats_planes(planes, eps, rows)
        torch.cuda.synchronize()
        stream = torch.cuda.current_stream(dev).cuda_stream
        ws = tpl._workspace[(planes.device.index, stream)]
        assert not bool(ws[:512].any())    # the counters: 128 int32 first
        assert torch.equal(s, want)


@pytest.mark.cuda
def test_cuda_planes_stats_workspace_per_stream():
    """window_stats_planes on a second stream of the device takes a
    workspace of its own (its ticket counters are not the first stream's),
    and both streams' calls give the plain version's s1 bit for bit."""
    from hydra_tpu_torch.ops import planes as tpl
    dev = _card()
    planes, eps, g = _card_planes(1024, 50_176, 41, dev)
    rows = [torch.randperm(1024, generator=g, device=dev)[:w].to(torch.int32)
            for w in (64, 200)]
    want = [tpl.window_stats_planes_ref(planes, eps, r) for r in rows]
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    got = [tpl.window_stats_planes(planes, eps, rows[0])]
    with torch.cuda.stream(side):
        got.append(tpl.window_stats_planes(planes, eps, rows[1]))
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize()
    index = planes.device.index
    main = tpl._workspace[(index, torch.cuda.current_stream(dev).cuda_stream)]
    other = tpl._workspace[(index, side.cuda_stream)]
    assert main.data_ptr() != other.data_ptr()
    for ws in (main, other):
        assert not bool(ws[:512].any())
    for s, w in zip(got, want):
        assert torch.equal(s, w)


# ------------------------------------------------------------- wide arms --
# Windows above 1,024 markers, more than 16 mixture components and more
# than 16 traits: the kernels' wide arms (csrc/sweep_kernel.cuh: WIDE_W,
# WIDE_W, K_ANY; T_MAX trait groups) against their plain versions.
WIDE_K = 20
S_GRID_20 = tuple(float(x) for x in np.geomspace(1e-4, 0.5, WIDE_K - 1))


@pytest.mark.cuda
@pytest.mark.parametrize("n_mix", [K, WIDE_K])
@pytest.mark.parametrize("window", [1025, 2048])
@pytest.mark.parametrize("exact,missing", [(False, False), (False, True),
                                           (True, False), (True, True)])
def test_cuda_wide_sweep_matches_plain(exact, missing, window, n_mix):
    """Stale and exact sweeps of two windows above 1,024 markers (1,025: a
    piece of one marker; 2,048: two whole pieces), K = 4 and 20, complete
    and 5% missing calls, on a shuffled window order: the kernels against
    their plain versions with test_cuda_kernel_matches_plain's tolerances,
    components equal, bitwise repeatable."""
    dev = _card()
    m = 2 * window
    pk, eps, mask, mrow, n, _ = _card_inputs(m, 128, missing, 17 + window,
                                             dev, n_pad_markers=9, k=n_mix)
    order = tsk.block_order(torch.tensor([1, 0], device=dev), window)
    kw = dict(window=window, n_mix=n_mix, complete=not missing,
              ind_mask=mask, order=order)
    fn = tsk.sweep_exact if exact else tsk.sweep_stale
    ref = tsk.sweep_exact_ref if exact else tsk.sweep_stale_ref
    e_k, o_k = fn(pk, eps, mrow, 0.7, float(n - 1), **kw)
    e_k2, o_k2 = fn(pk, eps, mrow, 0.7, float(n - 1), **kw)
    e_r, o_r = ref(pk, eps, mrow, 0.7, float(n - 1), **kw)
    torch.cuda.synchronize()
    assert torch.equal(e_k, e_k2) and torch.equal(o_k, o_k2)
    torch.testing.assert_close(e_k, e_r, atol=5e-4, rtol=1e-3)
    torch.testing.assert_close(o_k[:, 0], o_r[:, 0], atol=5e-4, rtol=1e-3)
    assert torch.equal(o_k[:, 1], o_r[:, 1])
    assert torch.unique(o_k[:, 1]).numel() >= 3


@pytest.mark.cuda
@pytest.mark.parametrize("n_mix", [K, WIDE_K])
@pytest.mark.parametrize("window,sub_window", [(2048, 1024), (2048, 2048),
                                               (64, 64)])
def test_cuda_wide_sd_matches_plain(window, sub_window, n_mix):
    """The single-decode stale sweep with sub-windows at and above 1,024
    markers and at K = 20 (no fold: its own draw launch) against its plain
    version, and with one sub-window a window bit for bit sweep_stale."""
    dev = _card()
    m = 2 * window
    pk, eps, mask, mrow, n, _ = _card_inputs(m, 128, True, 5, dev, k=n_mix)
    kw = dict(window=window, n_mix=n_mix, complete=False, ind_mask=mask)
    args = (pk, eps, mrow, 0.7, float(n - 1))
    e_k, o_k = tsk.sweep_stale_sd(*args, sub_window=sub_window, **kw)
    e_r, o_r = tsk.sweep_stale_sd_ref(*args, sub_window=sub_window, **kw)
    e_2p, o_2p = tsk.sweep_stale(*args, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(e_k, e_r, atol=5e-4, rtol=1e-3)
    torch.testing.assert_close(o_k[:, 0], o_r[:, 0], atol=5e-4, rtol=1e-3)
    assert torch.equal(o_k[:, 1], o_r[:, 1])
    if sub_window == window:
        assert torch.equal(e_k, e_2p) and torch.equal(o_k, o_2p)


@pytest.mark.cuda
@pytest.mark.parametrize("n_mix", [K, 12, WIDE_K])
@pytest.mark.parametrize("window", [64, 1025, 1536, 2048])
def test_cuda_wide_window_gibbs_matches_plain(window, n_mix):
    """window_gibbs above 1,024 markers (pieces of 1,024, each catching up
    on the earlier pieces' steps) and at K = 20 (the constants staged in
    shared memory where they fit, else read in place) against the plain
    version: test_cuda_window_gibbs_matches_plain's checks."""
    test_cuda_window_gibbs_matches_plain(window, n_mix)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [2048])
@pytest.mark.parametrize("nb", [128, 640])
@pytest.mark.parametrize("missing", [False, True])
@pytest.mark.parametrize("path", ["window_axpy", "window_stats",
                                  "sweep_stale", "sweep_exact",
                                  "sweep_stale_sd", "sweep_stale_bw",
                                  "window_level_sums"])
def test_cuda_wide_stream_kernels_bitwise(path, missing, nb, window):
    """The wide axpy (coefficients staged a chunk at a time) and the stats
    and levels passes at W = 2,048 bit for bit their plain versions:
    test_cuda_stream_kernels_bitwise's checks."""
    test_cuda_stream_kernels_bitwise(path, window, nb, missing)


@pytest.mark.cuda
@pytest.mark.parametrize("path,window,nb,n_traits,missing", [
    (path, window, nb, n_traits, missing)
    for path in ("window_stats_mt", "window_axpy_mt", "sweep_stale_mt",
                 "sweep_exact_mt")
    for window, n_traits in ((64, 20), (200, 17), (1025, 4), (2048, 20))
    for nb in (128, 640)
    for missing in (False, True)
    if not (path == "sweep_exact_mt" and missing)])
def test_cuda_wide_mt_stream_kernels_bitwise(path, window, nb, n_traits,
                                             missing):
    """The multi-trait passes in groups of 16 traits (T = 17, 20) and at
    windows above 1,024 markers bit for bit their plain versions in the
    kernels' order: test_cuda_mt_stream_kernels_bitwise's checks."""
    test_cuda_mt_stream_kernels_bitwise(path, window, nb, n_traits, missing)


# Cases of test_cuda_wide_mt_recurrence_matches_plain (source, W, T, K)
# whose chains meet a knife-edge draw: 40,960 draws of 20 components
# (778,240 boundary comparisons, four times the largest case of
# test_cuda_mt_recurrence_matches_plain), where in one chain (a window's
# trait) the kernel's fused update of num (one rounding a step, the plain
# version's two) leaves a draw on the other side of a cumulative-probability
# boundary than the plain version's, and the chain goes on from there.
WIDE_MT_KNIFE_EDGE = {("sweep", 2048, 20, WIDE_K),
                      ("per_trait", 2048, 20, WIDE_K)}


def _chains_agree_but_one(k, r, T, W, witness, order=None):
    """Components (W positions of each window, T traits) of the kernel's
    and the plain version's chains: equal in every chain but at most one,
    and in that chain equal up to its first difference, which moves the
    draw to an adjacent component on a knife edge: ``witness(w, j, t,
    comps)``, the float64 draw over num's f32 error bound from the kernel's
    own history (sweep_kernel_mt.recurrence_edge), takes both components.
    Returns the other chains' mask (positions x traits)."""
    from hydra_tpu_torch.ops.sweep_kernel_mt import first_differences
    ck, cr = (c if order is None else c[order.long()] for c in (k, r))
    chains = first_differences(ck, cr, W)
    assert len(chains) <= 1, chains
    keep = torch.ones_like(ck, dtype=torch.bool)
    for w, j, t in chains:
        a, b = float(ck[w * W + j, t]), float(cr[w * W + j, t])
        assert abs(a - b) == 1.0
        assert witness(w, j, t, (a, b)), (
            f"window {w} trait {t} step {j}: components {a:g} and {b:g} are "
            "not both within f32 rounding of the float64 draw")
        keep[w * W + j:(w + 1) * W, t] = False
    return keep


@pytest.mark.cuda
@pytest.mark.parametrize("n_mix", [K, WIDE_K])
@pytest.mark.parametrize("n_traits", [4, 20])
@pytest.mark.parametrize("window", [64, 1025, 2048])
@pytest.mark.parametrize("source", ["sweep", "shared", "per_trait"])
def test_cuda_wide_mt_recurrence_matches_plain(source, window, n_traits,
                                               n_mix):
    """The multi-trait exact recurrences in pieces of 1,024 markers, at 20
    traits and at K = 20: test_cuda_mt_recurrence_matches_plain's checks;
    in WIDE_MT_KNIFE_EDGE's cases, bitwise repeatable, components equal in
    every chain but the knife-edge one (_chains_agree_but_one, its first
    difference witnessed in float64), and every draw of the other chains
    within the sweep tolerance (the sweep: eps of the other traits too)."""
    from hydra_tpu_torch.ops import sweep_kernel_mt as tskmt
    if (source, window, n_traits, n_mix) not in WIDE_MT_KNIFE_EDGE:
        test_cuda_mt_recurrence_matches_plain(source, window, n_traits, n_mix)
        return
    dev = _card()
    T = n_traits
    args, kw = mt_recurrence_inputs(source, window, T, n_mix, dev)
    fn, ref = ((tskmt.sweep_exact_mt, tskmt.sweep_exact_mt_ref)
               if source == "sweep" else
               (tskmt.mt_window_recurrence, tskmt.mt_window_recurrence_ref))
    k1, k2 = fn(*args, **kw), fn(*args, **kw)
    r = ref(*args, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(k1, k2))
    if source == "sweep":
        order = kw["order"]

        def witness(w, j, t, comps):
            return tskmt.sweep_exact_mt_edge(*args, k1[1], j=j, w=w, t=t,
                                             comps=comps, **kw)

        keep = _chains_agree_but_one(k1[1][:, T:2 * T], r[1][:, T:2 * T], T,
                                     window, witness, order)
        for c in range(3):
            a, b = (o[1][:, c * T:(c + 1) * T][order.long()] for o in (k1, r))
            torch.testing.assert_close(a[keep], b[keep], atol=5e-4, rtol=1e-3)
        whole = keep.all(dim=0)                 # traits without the edge
        torch.testing.assert_close(k1[0][:, whole], r[0][:, whole],
                                   atol=5e-4, rtol=1e-3)
        return
    gram, num0, mrow, i2se = args
    blk = mrow[kw["rows"].long()].reshape(window, -1, T)

    def witness(w, j, t, comps):
        return tskmt.recurrence_edge(gram[t, j], num0[j, t], k1[3][:j, t],
                                     blk[j, :, t], i2se[t], n_mix, comps)

    keep = _chains_agree_but_one(k1[1], r[1], T, window, witness)
    for a, b in zip(k1, r):
        torch.testing.assert_close(a[keep], b[keep], atol=5e-4, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("stale", [True, False])
def test_cuda_wide_mt_sweep_nan_matches_plain(stale):
    """T = 20, K = 20, 10% NaN phenotypes: the stale whole sweep (no fold:
    its own draw launch, the passes in two trait groups) and the exact
    per-window path's recurrence (mt_window_recurrence on a per-trait Gram)
    against their plain versions on the card: components equal, the
    sweep tolerances."""
    from hydra_tpu_torch.ops import sweep_kernel_mt as tskmt
    dev = _card()
    T, W = 20, 64
    pk, eps, tm, mrow, dnm1, n, _ = _card_mt_inputs(4 * W, 128, T, False,
                                                     False, 23, dev,
                                                     k=WIDE_K)
    i2se = torch.linspace(0.6, 0.9, T, device=dev)
    kw = dict(window=W, n_mix=WIDE_K, complete=True)
    if stale:
        e_k, o_k = tskmt.sweep_stale_mt(pk, eps, tm, mrow, i2se, dnm1, **kw)
        e_r, o_r = tskmt.sweep_stale_mt_ref(pk, eps, tm, mrow, i2se, dnm1,
                                            **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(e_k, e_r, atol=5e-4, rtol=1e-3)
        torch.testing.assert_close(o_k[:, :T], o_r[:, :T], atol=5e-4,
                                   rtol=1e-3)
        assert torch.equal(o_k[:, T:2 * T], o_r[:, T:2 * T])
        return
    rows = torch.arange(W, dtype=torch.int32, device=dev)
    num0 = 30.0 * torch.randn(W, T, device=dev)
    x = torch.randn(T, W, 1024, device=dev)
    gram = (x @ x.transpose(1, 2)).contiguous()
    k = tskmt.mt_window_recurrence(gram, num0, mrow, i2se, n_mix=WIDE_K,
                                   rows=rows)
    r = tskmt.mt_window_recurrence_ref(gram, num0, mrow, i2se, n_mix=WIDE_K,
                                       rows=rows)
    torch.cuda.synchronize()
    assert torch.equal(k[1], r[1])
    for a, b in zip(k, r):
        torch.testing.assert_close(a, b, atol=5e-4, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("window,n_mix", [(2048, 4), (1025, WIDE_K), (64, 40)])
def test_cuda_wide_bw_sweep_matches_plain(window, n_mix):
    """sweep_stale_bw above 1,024 markers (the wide axpy with the vi
    refresh), at K = 20 (a component a lane) and K = 40 (bw_draw_kernel's
    WIDE_K arm: the components in the warp's shared memory) against its
    plain version: components equal, eps and out within the sweep
    tolerance (knife-edge slice states may differ in a last bit), bitwise
    repeatable."""
    from hydra_tpu_torch.samplers.bayesw import gh_table
    dev = _card()
    grid = tuple(float(x) for x in np.geomspace(1e-4, 0.5, n_mix - 1))
    s = _bw_card_sampler(2 * window, 128, True, window, 5, dev, s_grid=grid)
    st = s.init_state()
    g = torch.Generator(device=dev).manual_seed(window + n_mix)
    p = torch.rand((1, n_mix), generator=g, device=dev) + 0.1
    st.pi_l = p / p.sum()
    m = s.cfg.m_loc
    nz = torch.rand(m, generator=g, device=dev) < 0.2
    st.beta = torch.where(nz, 0.02 * torch.randn(m, generator=g, device=dev),
                          0.0)
    vi = torch.exp(st.alpha * st.eps - tskbw.EULER_MASCHERONI) * s.ind_mask
    mrow = s.build_mrow(st, st.alpha, s.slot_noise(0))
    gh_x, gh_w = (torch.tensor(a, dtype=torch.float32, device=dev)
                  for a in gh_table(9))
    args = (s.packed, st.eps, vi, mrow, gh_x, gh_w, st.alpha)
    kw = dict(window=window, n_mix=n_mix, complete=s.cfg.complete,
              ind_mask=s.ind_mask, order=s.sweep_order(0))
    e_k, o_k = tskbw.sweep_stale_bw(*args, **kw)
    e_k2, o_k2 = tskbw.sweep_stale_bw(*args, **kw)
    e_r, o_r = tskbw.sweep_stale_bw_ref(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(e_k, e_k2) and torch.equal(o_k, o_k2)
    assert torch.equal(o_k[:, 1], o_r[:, 1])
    assert int((o_k[:, 1] > 0).sum()) >= 2
    torch.testing.assert_close(e_k, e_r, atol=5e-4, rtol=1e-3)
    torch.testing.assert_close(o_k, o_r, atol=5e-4, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("n_pad", [512, 50_176])
@pytest.mark.parametrize("window", [1025, 2048, 3000])
def test_cuda_wide_planes_bitwise(window, n_pad):
    """Both planes kernels above 1,024 rows (the stats in launches of
    1,024 rows, the axpy reading c1 in place) bit for bit their plain
    versions: test_cuda_planes_bitwise's checks."""
    test_cuda_planes_bitwise(window, n_pad)
