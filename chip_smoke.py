#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (hydra_tpu_torch) on one NVIDIA card.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printing its wall time:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
     builds the kernels from hydra_tpu_torch/csrc with nvcc (one nvcc per
     source, started together).
  2. sweep_stale / sweep_exact against their plain PyTorch versions on the
     card at main-path shapes (M=4,096 x N=50,000, W=64 and 128, complete
     and missing genotypes, block window permutation; exact also at W=256
     and W=200, a window that is not a multiple of 32); bitwise
     repeatability; with missing genotypes at W=64 and 128 the Gram of the
     sweep's first window against x x^T in float64 (check_missing_gram). At
     the main-path windows (stale 64, exact 128) axpy_kernel is held bit
     for bit against the plain axpy replayed from the kernel's own draws,
     and stats_kernel (through window_stats on the first window's rows)
     against its plain version; the exact sweep's profile must show its
     window Grams in one batched launch, none a window
     (check_gram_launches).
  2b. the BayesW kernels against their plain versions: sweep_stale_bw at
     M=4,096 x N=50,000, W=64 (complete and 2% missing) and at W=1 with
     M=512, eps and out bit for bit the plain version's (axpy_kernel<true>
     also bit for bit the plain axpy replayed from the sweep's draws);
     window_level_sums and window_axpy at W=64 x N=50,000 (bit for bit;
     window_axpy but for the pad individuals of complete data).
  3. the BayesRRm CLI end to end (``--mpibayes bayesMPI``) at M=10,000 x
     N=5,000, exact default then --stale, 50 iterations each; the sweep
     kernels' launch counts must move. One sweep of the CUDA sampler is
     held against the CPU sampler with the same noise.
  3b. the BayesW CLI end to end (``--mpibayes bayesWMPI``) at M=10,000 x
     N=5,000, the W=1 default and --window 64, 20 iterations each; the
     BayesW kernels' launch counts must move. One CUDA sweep is held
     against the CPU sampler with the same noise.
  4. real size M=100,000 x N=50,000 (1.25 GB of packed genotypes made on
     the card): ms/sweep and markers/s, exact W=128 and stale W=64, then
     exact W=128 on 2% missing calls; the exact sweeps must launch their
     Grams once a batch (gram_i8_batch_kernel, missing data
     gram_f32_batch_kernel; check_gram_launches); each dataset's batched
     Grams of all its W=128 and W=64 windows (the 64-row tiles the
     real-size sweeps take) against g g^T, x x^T in float64 and
     window_stats' Gram (check_batched_grams); here
     and in 4b, 4d and 4e each sweep's device us per window by kernel,
     stats_kernel's and axpy_kernel's bounds per window and launches.
  4b. BayesW W=64 block at the same size, and W=1 at M=10,000 x N=5,000:
     ms/sweep, markers/s, per-kernel device time, host enqueue time, and
     levels_kernel's and bw_draw_kernel's bounds per window.
Multi-trait BayesRRm (T=4 traits):
  2c. sweep_stale_mt (W=64) and sweep_exact_mt (W=128) against their plain
     versions at M=4,096 x N=50,000 with full phenotypes (sweep_exact_mt's
     Grams one batched launch, check_gram_launches), sweep_stale_mt
     with 2% missing genotypes and 10% NaN per trait; window_stats_mt,
     window_axpy_mt and mt_window_recurrence at W=128 with and without NaN;
     then the SHA-256 of the exact recurrences', the mt packed passes', the
     BayesW sweep's, the BayesRRm stale sweeps' and the per-window branch's
     (window_gibbs, window_axpy, one --mega off exact sweep) outputs on
     fixed-seed inputs (print_digests), to hold two trees bit for bit.
  3c. the multi-trait CLI (``--pheno t0,t1,t2,t3``) at M=10,000 x N=5,000:
     exact with full phenotypes, --stale --window 64, and exact with 10% NaN
     per trait (the per-window path), 40 iterations each; every mt launch
     count must move, .t0-.t3 outputs exist with posterior h2 near the
     simulated 0.5. One sweep of each branch is held against the CPU
     sampler with the same state and noise.
  4c. M=100,000 x N=50,000: exact W=128 and stale W=64 (block, full
     phenotypes) and the per-window path with 10% NaN (marker schedule):
     ms/sweep, markers/s, per-kernel device time.
BayesRRm's per-window branch (--mega off, --cache-planes on) and W < 8:
  2d. window_stats (W=128; exact and stale, complete and 2% missing),
     window_gibbs (W=128, on a real window's Gram), window_axpy (W=128, bit
     for bit its plain version, one device kernel a call),
     window_stats_planes and window_axpy_planes (W=64, bit for bit their
     plain versions, one device kernel a call) against their plain
     versions at N=50,000,
     bitwise repeatable (window_stats' s1, s2 bit for bit); the planes
     kernels beside torch.mv on the planes cast to f32 before timing (and,
     once, with the cast inside the timed call).
  3d. the CLI at M=10,000 x N=5,000, 20 iterations each: --mega off (exact
     W=64), --mega off --stale --window 64, --cache-planes on --stale
     --window 64 and --stale (W=1, the whole-sweep kernel on the marker
     schedule); each run's kernels' launch counts must move; one CUDA sweep
     of each against the CPU sampler with the same state and noise.
  4d. M=25,000 x N=50,000 (cut from M=100,000, the time limit): --mega
     off exact W=128 and stale W=64, and --cache-planes on stale W=64
     (1.25 GB of int8 planes); stale W=1 at
     M=10,000 x N=5,000: ms/sweep, busy share, host enqueue, device time
     per kernel; window_gibbs_kernel alone a call at W=64, 128 and 1024
     (print_window_gibbs_times); the planes kernels alone a call at W=64
     and 1024 beside torch.mv and their bounds (print_planes_times).
BayesFH (--mpibayes bayesFHMPI) and the single-decode stale sweep
(HYDRA_TPU_SD, --stale --schedule marker):
  2e. sweep_stale_sd against its plain version at M=4,096 x N=50,000, W=64,
     sub-windows 64 and 16, complete and 2% missing, marker-schedule order;
     bitwise repeatable; sweep_stale on the same inputs beside it (bit for
     bit at sub-window 64).
  2f. the single-trait packed passes beside one PyTorch call on the
     window's decoded rows (print_library_times): device time a call of
     stats_kernel, axpy_kernel, levels_kernel and the complete Gram against
     torch.mv, torch.addmv, torch.mm and the fastest Gram of torch.mm f32,
     bf16 and torch._int_mm, and the missing-data Gram against torch.mm f32
     of the standardized rows (W=128 and W=64); the batched Grams of 1
     and 64 windows a window against torch.bmm (bf16; missing data f32 of the
     standardized rows) on the same windows; the library times of
     window_stats, window_axpy and window_level_sums in the kernels line.
  3e. the CLI at M=10,000 x N=5,000, 20 iterations each: BayesFH exact
     default, --stale --window 64 and --mega off; HYDRA_TPU_SD=16 --stale
     --window 64 --schedule marker for bayesMPI and bayesFHMPI; launch
     counts, .fh.npz, h2; one CUDA sweep of each against the CPU sampler.
  4e. M=100,000 x N=50,000: BayesFH exact W=128 (block); stale W=64 marker
     through sweep_stale and sweep_stale_sd (sub-windows 64 and 16):
     ms/sweep, markers/s, busy share, device time per kernel.
Restart and covariates (--restart, --covariates):
  3f. the CLI at M=10,000 x N=5,000 on the beds of phases 3, 3b and 3c with
     F=12 covariates ("fid pid c1 .. c12" with "NA" entries; multi-trait a
     comma-separated file): BayesRRm exact with covariates, --stale
     --window 64, BayesFH, BayesW W=1 with covariates and multi-trait T=4
     with covariates, each a full run of 30 iterations, a run cut at 15 and
     a --restart of it; every record after the restart (csv rows, .bet,
     .cpn, .acu, .mus.0, gamma, the last .eps.0) byte for byte the full
     run's (scripts/soak_restart_torch.py::compare_runs); one CUDA sweep
     with covariates of BayesRRm, BayesW and multi-trait against the CPU
     sampler; BayesRRm's and BayesW's ms/sweep with and without them.
  4f. BayesRRm exact W=128 with F=12 covariates at M=100,000 x N=50,000,
     thin 5, save 10: ms/sweep by CUDA events with and without the
     covariates, an uninterrupted run of 60 sweeps (the writer's share), a
     run in a child process (``chip_smoke.py --restart-child``, the data
     made anew from their seeds) SIGKILLed once its csv shows iteration
     36, a --restart in another child (seconds from its start to its first
     sweep), and every record after the restart byte for byte the
     uninterrupted run's.
Marker shards (one torch.distributed rank a shard, rank children started
by scripts/run_multiprocess_torch.py, ``chip_smoke.py --rank-child``):
  3h. on phase 3's and 3b's beds: the BayesRRm CLI, exact and --stale, 20
     iterations, on one rank under an NCCL process group, byte for byte the
     run without a group; two ranks on the one card (gloo on CUDA tensors:
     NCCL refuses two ranks on one device): one sweep of exact W=64
     --cross-sync 8, exact W=64, stale W=64 and BayesW W=64 at M=3,000 x
     N=5,500 (write_sweep_beds) by the CUDA
     sampler against the same two ranks' CPU sampler on the same state and
     noise (components equal, eps and beta within phase 3's tolerance, eps
     the same bits on both ranks, each wrapper launched once a window); a
     stale W=64 --det-sync chain of 25 sweeps twice, bit for bit; a
     BayesW chain (8 sweeps), its wrappers' launches; the chain again with
     rank 1 SIGKILLed once its csv shows iteration 10 (beside the one-rank
     run, both started at once), a
     --restart, and every later record byte for byte the uninterrupted
     chain's (compare_runs); then one stale W=64 shard sweep at M=100,000 x
     N=50,000 (50,000 markers a rank, made on the card) after one warm-up:
     ms/sweep by CUDA events and the time in all_reduce a sweep, printed as
     two ranks sharing one card, not a multi-GPU speed. One two-rank launch
     runs the restart, the sweeps, the chains and the timed sweep; the last
     two wait until the one-rank run is done.
  3i. in phase 3h's two-rank launch, multi-trait shards and --dcn-slices:
     one sweep (M=3,000 x N=5,500, as 3h's) of multi-trait T=4 stale W=64
     (10% NaN), exact W=64 (full phenotypes: sweep_exact_mt a window a
     launch), exact W=64 with 10% NaN (the per-window path) and BayesRRm
     stale W=64 at --dcn-slices 2, CUDA
     against the same ranks' CPU sampler (components equal, eps the same
     bits on both ranks, each wrapper once a window); on phase 3c's bed
     multi-trait stale W=64 chains of 25 sweeps: --det-sync twice (bit for
     bit) and at --dcn-slices 2 (byte for byte the flat chain: --det-sync
     sums over all ranks at any S); without --det-sync flat and at
     --dcn-slices 2 (hier_sum a window; within the sweep tolerances,
     components equal), and at --dcn-slices 2 with rank 1 SIGKILLed at
     iteration 10 (its own launch beside 3h's) and --restart'ed (byte for
     byte the uninterrupted one); one multi-trait T=4 stale W=64 shard
     sweep at M=100,000 x N=50,000, ms/sweep by CUDA events and all_reduce
     ms, as two ranks sharing one card, not a multi-GPU speed, and the
     window-a-launch route on its first 8 windows against the plain
     version on the same card tensors; at the stale W=64 shard sweep's
     size, hier_sum's chunked sum across two slices timed against one
     all_reduce.
  3j. --ind-shards, a (markers x individuals) rank grid (rank r holds
     marker shard r // I and chunk r % I of the individuals, padded to a
     multiple of 512): in phase 3h's two-rank launch, the 1x2 grid, one
     sweep of exact W=64, stale W=64, exact W=64 with 2% missing calls and
     BayesW W=64 at M=3,000 x N=5,500 (n_pad 5,632: chunks of 2,816 padded
     to 3,072) by the CUDA sampler against the same ranks' CPU sampler
     (components equal, the gathered eps the same bits on both ranks, beta
     the same bits on both, the padding 0, window_stats / window_gibbs /
     window_axpy / window_level_sums once a window); in a four-rank launch
     of its own beside 3h's killed chains, the 2x2 grid, one exact W=64
     --cross-sync 8 sweep the same way; multi-trait T=4 the same way on
     phase 3i's beds: on the 1x2 grid stale W=64 and exact W=64 with 10%
     NaN (window_stats_mt, window_axpy_mt and, exact, mt_window_recurrence
     on each chunk once a window), on the 2x2 grid exact W=64 with full
     phenotypes; one 1x2 stale W=64 sweep at M=25,000 x N=50,000 (every
     marker on both ranks, 25,088 individuals a rank) and one of
     multi-trait T=4 with 10% NaN on 3i's real-size genotypes' first 25,000
     markers: ms/sweep by CUDA events and all_reduce ms a sweep, printed as
     two ranks sharing one card, not a multi-GPU speed; ``python -m
     hydra_tpu_torch.postproc`` ess and predict on 3h's two-rank --det-sync
     chain (finite R-hat and ESS, a score for each of the bed's 5,000
     individuals).
The wide arms (windows above 1,024 markers, more than 16 mixture
components or traits):
  2g. at N=50,000: sweep_stale (complete) and sweep_exact (complete and 2%
     missing calls) at W=1,025 and 2,048 over two windows, each sweep's eps
     bit for bit the plain axpy replayed from its draws; sweep_stale W=64
     and sweep_exact W=128 (complete and 2% missing) at K=20; window_gibbs
     at W=1,025 and 2,048 (K=4) and W=128 at K=20; multi-trait T=20 on
     4,096 markers: sweep_stale_mt W=64 with 10% NaN, sweep_exact_mt W=128
     on full phenotypes, window_stats_mt, window_axpy_mt (bit for bit) and
     mt_window_recurrence on a W=128 window with 10% NaN; then all three
     multi-trait arms at once (phase_wide_mt: W=2,048, T=20, K=20 on two
     windows: sweep_stale_mt with 10% NaN, sweep_exact_mt on full
     phenotypes, the exact per-window path's passes and recurrence with
     10% NaN; an exact chain may take an adjacent component at one draw
     that float64 shows on a knife edge, compare_chains);
     sweep_stale_sd with a sub-window of 2,048 (complete and 2% missing,
     bit for bit sweep_stale) and the planes kernels at W=2,048 (bit for
     bit; phase_wide_passes); all against their plain versions, components
     equal. Phase 2b also holds sweep_stale_bw bit for bit at W=1,025 and
     2,048, and at K=40 (W=64) within the sweep tolerance, components
     equal (BW_WIDE_CASES).
  3k. the CLI on phase 3's and 3c's beds (M=10,000 x N=5,000), 5
     iterations each: --window 2048, --stale --sync-rate 2048, a --S grid of
     19 values (K=20) and 20 --pheno files (--stale --window 64); the
     sweep wrapper launches once a sweep, the records check out.
  4 and 4c also read the wide arms at M=100,000 x N=50,000 in at most
     three sweeps each (wide_reading: ms a step by CUDA events, busy
     share, launches, device ms by kernel): exact and stale W=2,048, exact
     W=1,024 beside them, exact W=128 at K=20, multi-trait T=20 stale W=64.
     To keep the smoke inside its limit (it read 1,170.1 s of phases with
     4d and 4g at M=100,000), 4d's per-window rows and 4g run at M=25,000,
     4g profiling a sweep of its first 2,500 markers (10,000 before).
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Any failure raises before those lines. JAX
and the JAX package are blocked: the port must run without them.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

sys.modules["jax"] = None          # the port imports neither JAX
sys.modules["hydra_tpu"] = None    # nor the JAX package
REPO = os.path.dirname(os.path.abspath(__file__))
K = 4
MS = (0.0, 1e-4, 1e-3, 1e-2)       # mixture variances incl. the zero class
SIGMA_E, SIGMA_G = 0.5, 0.5
EULER_MASCHERONI = 0.577215664901532
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS_PER_S = {"f32": 67e12, "int8": 1979e12}


def bound(nbytes, ops):
    """(ms, "bytes" | "operations"): the least time the card could take,
    the larger of the bytes moved over HBM bandwidth and the operations
    ({type: count}) over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(v / PEAK_OPS_PER_S[k] for k, v in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _launch_modules():
    from hydra_tpu_torch.ops import (gibbs_kernel, planes, sweep_kernel,
                                     sweep_kernel_bw, sweep_kernel_mt,
                                     window_kernels)
    return (sweep_kernel, sweep_kernel_bw, sweep_kernel_mt, window_kernels,
            gibbs_kernel, planes)


def reset_all_launches():
    for mod in _launch_modules():
        mod.reset_launches()


def all_launches():
    out = {}
    for mod in _launch_modules():
        out.update(mod.launches)
    return out


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    print(f"== {name}", flush=True)
    yield
    print(f"== {name}: {time.perf_counter() - t0:.1f} s wall", flush=True)


def device_genotypes(torch, m, n, n_pad, gen, missing=0.0, chunk=8192):
    """h-packed (m, n_pad/4) uint8 genotypes made on the card: g ~
    Binomial(2, p) with per-marker p ~ U(0.05, 0.5); pads (individuals >= n)
    are missing. Returns (packed, mave, mstd, nm) with the reference's
    marker statistics (BayesRRm.cpp:1502-1508)."""
    dev = gen.device
    out = torch.empty((m, n_pad // 4), dtype=torch.uint8, device=dev)
    mave = torch.empty(m, dtype=torch.float64, device=dev)
    mstd = torch.empty(m, dtype=torch.float64, device=dev)
    nm = torch.empty(m, dtype=torch.float64, device=dev)
    for r0 in range(0, m, chunk):
        r1 = min(m, r0 + chunk)
        p = 0.05 + 0.45 * torch.rand((r1 - r0, 1), generator=gen, device=dev)
        g = ((torch.rand((r1 - r0, n_pad), generator=gen, device=dev) < p)
             .to(torch.uint8)
             + (torch.rand((r1 - r0, n_pad), generator=gen, device=dev) < p)
             .to(torch.uint8))
        h = 2 - g
        if missing:
            h[torch.rand((r1 - r0, n_pad), generator=gen, device=dev)
              < missing] = 3
        h[:, n:] = 3
        real = h[:, :n]
        n1 = (real == 1).sum(1).double()
        n2 = (real == 0).sum(1).double()
        nmiss = (real == 3).sum(1).double()
        mu = (n1 + 2 * n2) / (n - nmiss)
        var = (n1 * (1 - mu) ** 2 + n2 * (2 - mu) ** 2
               + (n - n1 - n2 - nmiss) * mu ** 2)
        mave[r0:r1], mstd[r0:r1], nm[r0:r1] = mu, torch.sqrt((n - 1) / var), nmiss
        h4 = h.view(r1 - r0, n_pad // 4, 4)
        out[r0:r1] = (h4[..., 0] | (h4[..., 1] << 2) | (h4[..., 2] << 4)
                      | (h4[..., 3] << 6))
    return out, mave.float(), mstd.float(), nm


def kernel_rows(torch, mave, mstd, gen, n, pads, variances=MS[1:]):
    """mrow rows as the sampler builds them (sweep_kernel.py column layout)
    for sigmaE = sigmaG = 0.5, pi = (0.5, rest prop. to the variances),
    K = len(variances) + 1 components."""
    from hydra_tpu_torch.ops.sweep_kernel import mrow_width
    dev = mave.device
    m = mave.shape[0]
    k = len(variances) + 1
    cva = torch.tensor(variances, device=dev)
    pi = torch.cat([torch.tensor([0.5], device=dev), 0.5 * cva / cva.sum()])
    dnm1 = float(n - 1)
    denom = dnm1 + (SIGMA_E / SIGMA_G) / cva
    invd = (1.0 / denom).expand(m, k - 1)
    sd = torch.sqrt(SIGMA_E * invd)
    logl = torch.cat([torch.log(pi[:1]), torch.log(pi[1:])
                      - 0.5 * torch.log(SIGMA_G / SIGMA_E * dnm1 * cva + 1.0)])
    bold = torch.where(torch.rand(m, generator=gen, device=dev) < 0.2,
                       0.01 * torch.randn(m, generator=gen, device=dev), 0.0)
    act = torch.ones(m, device=dev)
    mave, mstd = mave.clone(), mstd.clone()
    mave[pads] = 0.0
    mstd[pads] = 0.0
    bold[pads] = 0.0
    act[pads] = 0.0
    rows = torch.cat([mave[:, None], mstd[:, None], bold[:, None],
                      torch.rand(m, 1, generator=gen, device=dev),
                      torch.randn(m, 1, generator=gen, device=dev),
                      act[:, None], logl.expand(m, k), invd, sd], dim=1)
    assert rows.shape[1] == mrow_width(k)
    return rows.contiguous()


def cuda_ms(torch, fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        res = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, res


def compare_outputs(torch, name, label, fn, ref, reps, tol, card, rec,
                    comp_of=None):
    """Kernel wrapper vs plain version on the same inputs: bitwise
    repeatable, within ``tol`` (per output: (rtol, atol)), components equal
    where ``comp_of`` picks them. Returns (kernel ms, plain ms)."""
    k0 = fn()                                  # build + warm up
    ms, k1 = cuda_ms(torch, fn, reps)
    ref()
    plain_ms, r1 = cuda_ms(torch, ref, 1)
    k0, k1, r1 = ([t for t in x if t is not None] for x in (k0, k1, r1))
    if not all(torch.equal(a, b) for a, b in zip(k0, k1)):
        raise AssertionError(f"{name} is not bitwise repeatable")
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(k1, r1))
    bitwise = all(torch.equal(a, b) for a, b in zip(k1, r1))
    n_comp = (int((comp_of(k1) != comp_of(r1)).sum().item()) if comp_of
              else 0)
    used = int(torch.unique(comp_of(k1)).numel()) if comp_of else 0
    print(f"{name:19s} {label:28s} kernel {ms:8.4f} ms  plain {plain_ms:9.3f}"
          f" ms  max|diff| {err:.3e}  bitwise equal to plain {bitwise}"
          + (f"  comp mismatches {n_comp}  components used {used}"
             if comp_of else "") + f"  [{card}]", flush=True)
    for a, b, (rtol, atol) in zip(k1, r1, tol):
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=atol)
    if n_comp:
        raise AssertionError(f"{name}: {n_comp} component mismatches "
                             "against the plain version")
    if comp_of and used < 2:
        raise AssertionError(f"{name}: degenerate draws")
    rec[name]["err"] = max(rec[name]["err"], err)
    return ms, plain_ms


def compare_chains(torch, name, label, fn, ref, reps, tol, card, rec,
                   comp_of, by_trait, W, witness):
    """compare_outputs for an exact multi-trait chain (windows of W, T
    traits): bitwise repeatable; components (comp_of: (positions, T) in
    sweep order) equal, but that one chain (a window's trait) may take an
    adjacent component at its first difference where the float64 witness
    (``witness(k1, w, j, t, comps)``, sweep_kernel_mt.recurrence_edge)
    finds a knife edge, and go on apart; the outputs (by_trait: tensors
    with traits last) of every other trait within ``tol``. Returns (kernel
    ms, plain ms)."""
    from hydra_tpu_torch.ops.sweep_kernel_mt import first_differences
    k0 = fn()                                  # build + warm up
    ms, k1 = cuda_ms(torch, fn, reps)
    ref()
    plain_ms, r1 = cuda_ms(torch, ref, 1)
    if not all(torch.equal(a, b) for a, b in zip(k0, k1)):
        raise AssertionError(f"{name} is not bitwise repeatable")
    ck, cr = comp_of(k1), comp_of(r1)
    chains = first_differences(ck, cr, W)
    keep = torch.ones(ck.shape[1], dtype=torch.bool, device=ck.device)
    for w, j, t in chains:
        a, b = float(ck[w * W + j, t]), float(cr[w * W + j, t])
        edge = (len(chains) == 1 and abs(a - b) == 1.0
                and witness(k1, w, j, t, (a, b)))
        print(f"  {name} {label}: window {w} trait {t} step {j} takes "
              f"component {a:g}, the plain version {b:g}: "
              f"{'a knife edge in float64' if edge else 'NOT a knife edge'}"
              f"  [{card}]", flush=True)
        if not edge:
            raise AssertionError(f"{name} {label}: components differ from "
                                 "the plain version")
        keep[t] = False
    ka, ra = by_trait(k1), by_trait(r1)
    err = max((a[..., keep].float() - b[..., keep].float()).abs().max().item()
              for a, b in zip(ka, ra))
    used = int(torch.unique(ck).numel())
    print(f"{name:19s} {label:28s} kernel {ms:8.4f} ms  plain {plain_ms:9.3f}"
          f" ms  max|diff| {err:.3e} ({int(keep.sum())} of {keep.numel()} "
          f"traits)  bitwise equal to plain "
          f"{all(torch.equal(a, b) for a, b in zip(k1, r1))}  knife-edge "
          f"chains {len(chains)}  components used {used}  [{card}]",
          flush=True)
    for a, b, (rtol, atol) in zip(ka, ra, tol):
        torch.testing.assert_close(a[..., keep].float(), b[..., keep].float(),
                                   rtol=rtol, atol=atol)
    if used < 2:
        raise AssertionError(f"{name}: degenerate draws")
    rec[name]["err"] = max(rec[name]["err"], err)
    return ms, plain_ms


def check_axpy_bitwise(torch, label, e_k, replay, card):
    """axpy_kernel's eps against the plain axpy replayed from the same
    draws: must be equal bit for bit."""
    same = torch.equal(e_k, replay)
    print(f"  axpy_kernel through {label}: bit for bit the plain axpy "
          f"replayed from the kernel's draws {same}  [{card}]", flush=True)
    if not same:
        raise AssertionError(f"axpy_kernel through {label} differs from its "
                             "plain version")


def check_stale_launches(torch, label, run, draw_kernel, separate, card):
    """Fails unless one stale sweep (run) launched its draw alone
    (draw_kernel, ``separate``: a window above the kernels' fold threshold)
    or only inside its axpy, from the profile's kernel names."""
    names = port_kernels(device_times(torch, run, label))
    print(f"  {label} launches {', '.join(sorted(names))}  [{card}]",
          flush=True)
    if (draw_kernel in names) != separate:
        raise AssertionError(f"{label}: {draw_kernel} "
                             f"{'not ' if separate else ''}launched")


def check_one_launch(torch, label, fn, card):
    """Fails unless one call of fn runs exactly one device kernel (the
    profile's every kernel and memset, the port's and torch's)."""
    per = device_times(torch, fn, label, "hydra::")
    n = sum(v[0] for v in per.values())
    print(f"  {label}: {n} device kernel(s) a call: "
          f"{', '.join(k[:60] for k in per)}  [{card}]", flush=True)
    if n != 1:
        raise AssertionError(f"{label}: {n} device kernels a call, not 1")


def check_gram_launches(torch, label, run, n_windows, W, missing, card,
                        per=None):
    """Fails unless one exact sweep (run; per, its device_times profile
    where taken) launched its window Grams once a batch of
    gram_batch_windows windows, by the batched kernel of its data
    (gram_i8_batch_kernel; missing genotypes gram_f32_batch_kernel), and no
    per-window Gram: 3 launches a window (stats, draw, axpy) and one a
    batch."""
    from hydra_tpu_torch.ops import window_kernels as wk
    batch = wk.gram_batch_windows(n_windows, W)
    n_batches = -(-n_windows // batch)
    want = "gram_f32_batch_kernel" if missing else "gram_i8_batch_kernel"
    per = per or device_times(torch, run, label)
    if not any(want in k for k in per):
        # the batch's Gram is a sweep's first launch, the one a session
        # loses most often (device_times): a session without it is taken
        # again, and the counts below hold for the one that has it
        per = device_times(torch, run, label, need=want)
    grams = {kernel_name(k): v[0] for k, v in per.items()
             if "hydra::" in k and "gram" in kernel_name(k)}
    n_port = sum(v[0] for k, v in per.items() if "hydra::" in k)
    print(f"  {label}: Gram launches {grams}, {n_windows} windows of "
          f"{batch} a batch; {n_port} launches of the port  [{card}]",
          flush=True)
    if grams != {want: n_batches} or n_port != 3 * n_windows + n_batches:
        raise AssertionError(f"{label}: Gram launches {grams} and {n_port} "
                             f"port launches, not {{{want!r}: {n_batches}}} "
                             f"and {3 * n_windows + n_batches}")


def check_batched_grams(torch, label, pk, n, W, card, mave=None, mstd=None):
    """The exact sweep's batched Grams (window_grams) of all M / W windows
    of a random order of pk's rows (n individuals; mave, mstd per slot:
    missing-data Grams), so that the launch takes the tile the main path's
    batch takes at this size (the profile names it; missing data: the
    64-row GramTile, asserted): one launch a batch, G == G^T and a second
    call bit for bit over every window, and at four windows (first, two
    inside, last) bit for bit window_stats' Gram of the same rows (the
    per-window launch, its individuals split) and, complete data, bit for
    bit g g^T in float64, missing data within the forward error bound of
    its summation order of x x^T in float64 (missing_gram_error)."""
    import re
    from hydra_tpu_torch.ops import window_kernels as wk
    from hydra_tpu_torch.ops.decode import decode_planes_hp
    dev = pk.device
    m, nb = pk.shape
    n_win = m // W
    missing = mave is not None
    kw = dict(mave=mave, mstd=mstd) if missing else {}
    gen = torch.Generator(device=dev).manual_seed(53)
    order = torch.randperm(m, generator=gen, device=dev)[:n_win * W].to(
        torch.int32)

    def run():
        return wk.window_grams(pk, order, W, **kw)

    got, again = run(), run()
    per = device_times(torch, run, f"{label} batched Grams W={W}",
                       "hydra::")
    tiles = {k.split("hydra::", 1)[1].split("(", 1)[0]: v[0]
             for k, v in per.items() if "hydra::" in k}
    n_batches = -(-n_win // wk.gram_batch_windows(n_win, W))
    same = torch.equal(got, again)
    sym = torch.equal(got, got.transpose(1, 2))
    eps = torch.zeros(4 * nb, device=dev)
    ones = torch.ones(W, device=dev)
    over = of_diag = 0.0
    exact = per_window = True
    for w in sorted({0, n_win // 3, 2 * n_win // 3, n_win - 1}):
        rows = order[w * W:(w + 1) * W].contiguous()
        if missing:
            mave_w = mave[rows.long()].contiguous()
            mstd_w = mstd[rows.long()].contiguous()
            one = wk.window_stats(pk, eps, mave_w, mstd_w, True, False,
                                  float(n), rows)[2]
            o, d = missing_gram_error(torch, pk, mave_w, mstd_w, rows, got[w])
            over, of_diag = max(over, o), max(of_diag, d)
        else:
            one = wk.window_stats(pk, eps, ones * 0.0, ones, True, True, 0.0,
                                  rows)[2]
            g = decode_planes_hp(pk[rows.long()])[0].double()
            exact = exact and torch.equal(got[w].double(), g @ g.T)
        per_window = per_window and torch.equal(got[w], one)
    err = (f"max|G - x x^T (f64)| {of_diag:.3e} of the diagonal, "
           f"{over:.3f} of its summation's error bound" if missing
           else f"G == g g^T (f64) bit for bit {exact}")
    print(f"  {label} batched Grams W={W}: {n_win} windows, launches "
          f"{tiles}; {err}; G == G^T {sym}, repeatable {same}, window_stats' "
          f"Gram bit for bit {per_window}  [{card}]", flush=True)
    want = "gram_f32_batch_kernel" if missing else "gram_i8_batch_kernel"
    if sum(tiles.values()) != n_batches or any(
            not k.startswith(want) for k in tiles):
        raise AssertionError(f"{label} batched Grams W={W}: launches {tiles},"
                             f" not {n_batches} of {want}")
    if missing and not all(re.search(r"GramTile<64,", k) for k in tiles):
        raise AssertionError(f"{label} batched Grams W={W}: not the 64-row "
                             f"tile ({tiles})")
    if not (same and sym and per_window and exact and over <= 1.0):
        raise AssertionError(f"{label} batched Grams W={W} are off their "
                             "references")


def check_stats_bitwise(torch, label, pk, eps, mrow, rows, exact, complete,
                        n, card):
    """stats_kernel's s1 and s2, through window_stats on the rows ``rows``,
    against the plain version in the kernel's order: bit for bit (complete
    stale data: but for pad rows, mstd = 0, whose 3*eps products the plain
    version rounds and the kernel fuses)."""
    from hydra_tpu_torch.ops import window_kernels as wk
    b = mrow[rows.long()]
    args = (pk, eps, b[:, 0].contiguous(), b[:, 1].contiguous(), exact,
            complete, float(n), rows)
    got, want = wk.window_stats(*args), wk.window_stats_ref(*args)
    keep = b[:, 1] != 0.0 if complete and not exact else slice(None)
    same = all(torch.equal(a[keep], r[keep]) for a, r in zip(got[:2], want[:2])
               if r is not None)
    print(f"  stats_kernel through {label}: s1, s2 bit for bit the plain "
          f"version {same}  [{card}]", flush=True)
    if not same:
        raise AssertionError(f"stats_kernel through {label} differs from its "
                             "plain version")


def missing_gram_error(torch, pk, mave_w, mstd_w, rows, gram):
    """(largest |G - x x^T| over its bound, largest |G - x x^T| over the
    largest diagonal entry) of a missing-data Gram on the window rows
    ``rows``, x = (g - mave*m) * mstd in f32 and x x^T in float64. The
    bound of entry (i, j) is the forward error of the kernel's summation
    order, (L + C) u sum_k |x_ik x_jk| (u = 2^-24, L the 2,048 individuals
    of a chunk's fmaf chain, C the chunks added after it), 1% over."""
    from hydra_tpu_torch.ops.decode import decode_planes_hp
    g, mk = decode_planes_hp(pk[rows.long()])
    x = ((g - mave_w[:, None] * mk) * mstd_w[:, None]).double()
    ref, mag = x @ x.T, x.abs() @ x.abs().T
    n_chunks = -(-pk.shape[1] // 512)
    err = (gram.double() - ref).abs()
    bound = 1.01 * (2048 + n_chunks) * 2.0 ** -24 * mag
    return ((err / bound.clamp(min=1e-300)).max().item(),
            (err.max() / ref.diagonal().abs().max()).item())


def check_missing_gram(torch, label, pk, mave_w, mstd_w, rows, gram, card):
    """The missing-data Gram (gram_f32_batch_kernel) of the window rows
    ``rows`` against x x^T in float64 on the same f32 x: every entry within
    the forward error bound of its summation order (missing_gram_error),
    and symmetric bit for bit."""
    over, of_diag = missing_gram_error(torch, pk, mave_w, mstd_w, rows, gram)
    sym = torch.equal(gram, gram.T)
    print(f"  gram_f32_batch_kernel through {label}: max|G - x x^T (f64)| "
          f"{of_diag:.3e} of the diagonal, {over:.3f} of its summation's "
          f"error bound; G == G^T bit for bit {sym}  [{card}]", flush=True)
    if not sym or not over <= 1.0:
        raise AssertionError(f"the missing-data Gram through {label} is off "
                             "its float64 reference or not symmetric")


def check_mt_bitwise(kernel, label, same, card):
    """A multi-trait packed pass against its plain version in the kernel's
    order (window_kernels.window_stats_mt_seq, window_axpy_mt_seq,
    sweep_update_mt_ref): must be equal bit for bit."""
    print(f"  {kernel} through {label}: bit for bit the plain version in its "
          f"order {same}  [{card}]", flush=True)
    if not same:
        raise AssertionError(f"{kernel} through {label} differs from its "
                             "plain version")


def print_mt_stream_bounds(W, nb, T, launches, missing=False, draw_cols=0):
    """The least time of one window's stats_mt_kernel and axpy_mt_kernel
    launches. Bytes: each reads the W packed rows and the order once; the
    stats eps (n_pad, T) once and write s1, s2 per tile, row and trait (and
    v); the axpy reads eps and tm and writes eps, with c1 and c2 (T, W), or,
    where it draws the window (draw_cols, the mrow width), the two stats
    partials a tile, row and trait and the W mrow rows, writing out (3 T
    floats a marker). Operations: one f32 multiply-add (2 operations) per
    genotype and trait for s1 and for the axpy, twice that with missing
    genotypes (s2 = sum m*eps; c2*m); ~100 a draw."""
    n_pad, n_tiles = 4 * nb, -(-nb // 512)
    ops = {"f32": (4.0 if missing else 2.0) * T * W * n_pad}
    draw = (4 * (2 * n_tiles * W * T + W * draw_cols + 3 * W * T - 2 * T * W)
            if draw_cols else 0)
    parts = []
    for name, nbytes, extra in (
            ("stats_mt_kernel",
             W * nb + 4 * W + 4 * T * n_pad + 4 * n_tiles * W * (2 * T + 1),
             0),
            ("axpy_mt_kernel" + (" with the draw" if draw_cols else ""),
             W * nb + 4 * W + 8 * T * W + 12 * T * n_pad + draw,
             100.0 * W * T if draw_cols else 0)):
        ms, by = bound(nbytes, {"f32": ops["f32"] + extra})
        parts.append(f"{name} {1e3 * ms:.4f} us ({by}; bytes "
                     f"{1e6 * nbytes / HBM_BYTES_PER_S:.4f} us)")
    print(f"  bound per window (W={W}, T={T}, nb={nb}): {', '.join(parts)}; "
          f"operations {1e6 * ops['f32'] / PEAK_OPS_PER_S['f32']:.4f} us; "
          f"{launches} launches a sweep each", flush=True)


def print_stream_bounds(W, nb, launches, stats=True, axpy=True,
                        refresh=False, decode=False, draw_cols=0):
    """The least time of one window's stats_kernel and axpy_kernel launches
    (bytes: each reads the W packed rows once; stats eps once and writes
    three per-tile partials a row, decode adds the crumbs, one byte an
    individual and row, which the single-decode sweep's axpy
    (axpy_decoded_kernel) reads in place of the packed rows; axpy reads eps
    and the mask and writes eps, refresh
    adds the vi write; an axpy that draws the window (draw_cols, the mrow
    width) reads the two stats partials a tile and row and the W mrow rows
    once and writes out; operations: one f32 multiply-add per genotype and
    sum, ~100 a draw, far below), and their launches a sweep."""
    n_pad, n_tiles = 4 * nb, -(-nb // 512)
    st = bound(W * nb + 4 * n_pad + 12 * n_tiles * W + 4 * W
               + (W * n_pad if decode else 0), {"f32": 4.0 * W * n_pad})
    ax = bound((W * n_pad if decode else W * nb) + 12 * n_pad + 4 * (3 * W + 1)
               + (4 * n_pad if refresh else 0)
               # drawing: partials and mrow rows in, out out, no coef
               + (4 * (2 * n_tiles * W + W * draw_cols) + 16 * W
                  - 4 * (2 * W + 1) if draw_cols else 0),
               {"f32": 4.0 * W * n_pad + (100.0 * W if draw_cols else 0)})
    parts = ([f"stats_kernel{'<true>' if decode else ''} {1e3 * st[0]:.4f} "
              f"us ({st[1]})"] if stats else []) + (
        [f"{'axpy_decoded_kernel' if decode else 'axpy_kernel'}"
         f"{'<true>' if refresh else ''}"
         f"{' with the draw' if draw_cols else ''} {1e3 * ax[0]:.4f} us "
         f"({ax[1]})"] if axpy else [])
    print(f"  bound per window (W={W}, nb={nb}): {', '.join(parts)}; "
          f"{launches} launches a sweep each", flush=True)


def phase_kernels(torch, sk, card):
    """Kernel vs plain version at main-path shapes (and exact at W=256
    and W=200; stale at W=512, the draw's own launch)."""
    import numpy as np
    from hydra_tpu_torch.ops import window_kernels as wk
    dev = torch.device("cuda")
    m, n = 4096, 50_000
    n_pad = padded_individuals(np, n)
    rec = {"sweep_stale": dict(err=0.0), "sweep_exact": dict(err=0.0)}
    for missing in (0.0, 0.02):
        gen = torch.Generator(device=dev).manual_seed(11)
        pk, mave, mstd, _ = device_genotypes(torch, m, n, n_pad, gen, missing)
        pads = torch.randperm(m, generator=gen, device=dev)[:37]
        pk[pads] = 0xFF
        mrow = kernel_rows(torch, mave, mstd, gen, n, pads)
        eps = 0.8 * torch.randn(n_pad, generator=gen, device=dev)
        eps[n:] = 0.0
        mask = torch.zeros(n_pad, device=dev)
        mask[:n] = 1.0
        # exact also at W=256 and at W=200 (not a multiple of 32: a ragged
        # last 32-marker block of the draw) on the first 4,000 rows; stale
        # also at W=512, where the draw keeps its own launch
        # (stale_draw_kernel, above the kernels' STALE_FOLD_MAX_W = 256)
        for window in (64, 128, 256, 200, 512):
            mw = m - m % window
            pk_w, mrow_w = pk[:mw], mrow[:mw]
            order = sk.block_order(torch.randperm(
                mw // window, generator=gen, device=dev), window)
            kw = dict(window=window, n_mix=K, complete=not missing,
                      ind_mask=mask if not missing else None, order=order)
            for name, fn, ref in (
                    ("sweep_stale", sk.sweep_stale, sk.sweep_stale_ref),
                    ("sweep_exact", sk.sweep_exact, sk.sweep_exact_ref)):
                if window not in ((64, 128, 512) if name == "sweep_stale"
                                  else (64, 128, 256, 200)):
                    continue
                def run():
                    return fn(pk_w, eps, mrow_w, 1.0 / (2 * SIGMA_E),
                              float(n - 1), **kw)
                def plain():
                    return ref(pk_w, eps, mrow_w, 1.0 / (2 * SIGMA_E),
                               float(n - 1), **kw)
                e0, o0 = run()                         # build + warm up
                ms, (e1, o1) = cuda_ms(torch, run, 5)
                plain()                                # warm up
                plain_ms, (er, orf) = cuda_ms(torch, plain, 1)
                if not (torch.equal(e0, e1) and torch.equal(o0, o1)):
                    raise AssertionError(f"{name} is not bitwise repeatable")
                d_eps = (e1 - er).abs().max().item()
                d_beta = (o1[:, 0] - orf[:, 0]).abs().max().item()
                n_comp = int((o1[:, 1] != orf[:, 1]).sum().item())
                n_used = int(torch.unique(o1[:, 1]).numel())
                print(f"{name:11s} W={window:3d} {'missing ' if missing else 'complete'}"
                      f" kernel {ms:9.3f} ms  plain {plain_ms:9.3f} ms  "
                      f"max|d eps| {d_eps:.3e}  max|d beta| {d_beta:.3e}  "
                      f"comp mismatches {n_comp}  components used {n_used}"
                      f"  [{card}]", flush=True)
                torch.testing.assert_close(e1, er, atol=5e-4, rtol=1e-3)
                torch.testing.assert_close(o1[:, 0], orf[:, 0], atol=5e-4,
                                           rtol=1e-3)
                if n_comp:
                    raise AssertionError(f"{name}: {n_comp} component "
                                         "mismatches against the plain version")
                if n_used < 2:
                    raise AssertionError(f"{name}: degenerate draws")
                r = rec[name]
                r["err"] = max(r["err"], d_eps, d_beta)
                main_w = 128 if name == "sweep_exact" else 64
                if name == "sweep_stale" and window in (64, 512):
                    # either side of the fold threshold
                    check_stale_launches(torch, f"{name} W={window}", run,
                                         "stale_draw_kernel", window == 512,
                                         card)
                if window in (main_w, 512):
                    mode = ("missing" if missing else
                            "exact" if name == "sweep_exact" else "stale")
                    check_axpy_bitwise(torch, f"{name} W={window}", e1,
                                       wk.sweep_update_ref(pk_w, eps, mrow_w,
                                                           o1[:, 3], order,
                                                           window, mode,
                                                           mask), card)
                if window == main_w:
                    check_stats_bitwise(torch, f"{name} W={window}", pk_w,
                                        eps, mrow_w, order[:window],
                                        name == "sweep_exact", not missing, n,
                                        card)
                if window == main_w and name == "sweep_exact":
                    check_gram_launches(
                        torch, f"{name} W={window}"
                        f"{' missing' if missing else ''}", run,
                        mw // window, window, missing, card)
                if name == "sweep_exact" and missing and window in (64, 128):
                    # the sweep's Gram kernel on its first window's rows
                    rows = order[:window].contiguous()
                    b = mrow_w[rows.long()]
                    mave_w = b[:, 0].contiguous()
                    mstd_w = b[:, 1].contiguous()
                    check_missing_gram(
                        torch, f"{name} W={window}", pk_w, mave_w, mstd_w,
                        rows, wk.window_stats(pk_w, eps, mave_w, mstd_w, True,
                                              False, float(n), rows)[2], card)
                if window == main_w and not missing:
                    r["ms"], r["plain_ms"] = ms, plain_ms
                    # packed rows, eps, mrow, order, mask in; eps, out out.
                    # Ops: s1 and the axpy, one FMA each per genotype; the
                    # exact Gram is symmetric: (W + 1) / 2 int8 multiply-adds
                    # per genotype
                    nbytes = (pk.numel() + 3 * 4 * n_pad + mrow.numel() * 4
                              + 4 * m + 16 * m)
                    ops = {"f32": 4.0 * m * n_pad}
                    if name == "sweep_exact":
                        ops["int8"] = (window + 1.0) * m * n_pad
                    r["bound_ms"], r["bound_by"] = bound(nbytes, ops)
    return rec


# phase 2g's arms: windows above 1,024 markers (the exact chain in pieces
# of 1,024, the wide axpy), K = 20 (the draws' constants read in place) and
# T = 20 (the multi-trait passes in groups of 16 traits)
WIDE_WINDOWS = (1025, 2048)
WIDE_VARIANCES = tuple(1e-5 * 1000.0 ** (i / 18) for i in range(19))   # K=20
WIDE_T = 20


def phase_wide_kernels(torch, np, sk, card, rec):
    """The wide arms against their plain versions at N=50,000 (into the
    records ``rec`` of phases 2, 2c and 2d): sweep_stale (complete) and
    sweep_exact (complete and 2% missing calls) at W = 1,025 and 2,048 over
    two windows, each sweep's eps bit for bit the plain axpy replayed from
    its own draws; sweep_stale and sweep_exact at K = 20 (W = 64 and 128
    over 1,024 markers; exact also on 2% missing calls); window_gibbs at W
    = 1,025 and 2,048 (K = 4) and at W = 128, K = 20; multi-trait T = 20 on
    4,096 markers: sweep_stale_mt W=64 with 10% NaN per trait, sweep_exact_mt
    W=128 with full phenotypes, and the exact per-window path's
    window_stats_mt, mt_window_recurrence and window_axpy_mt on one W=128
    window with 10% NaN. Tolerances are those of the arms at W <= 1,024:
    components equal, the sweeps within atol 5e-4 / rtol 1e-3 and bitwise
    repeatable; the multi-trait passes bit for bit their plain versions in
    the kernels' order (the sweeps' eps against the replayed update)."""
    from hydra_tpu_torch.ops import gibbs_kernel as gk
    from hydra_tpu_torch.ops import sweep_kernel_mt as skmt
    from hydra_tpu_torch.ops import window_kernels as wk
    dev = torch.device("cuda")
    n = 50_000
    n_pad = padded_individuals(np, n)
    i2se = 1.0 / (2 * SIGMA_E)
    tol = [(1e-3, 5e-4)] * 4
    cases = ([(w, MS[1:], miss, names) for w in WIDE_WINDOWS
              for miss, names in ((0.0, ("sweep_stale", "sweep_exact")),
                                  (0.02, ("sweep_exact",)))]
             + [(64, WIDE_VARIANCES, 0.0, ("sweep_stale",)),
                (128, WIDE_VARIANCES, 0.0, ("sweep_exact",)),
                (128, WIDE_VARIANCES, 0.02, ("sweep_exact",))])
    for window, variances, missing, names in cases:
        k = len(variances) + 1
        m = 2 * window if window > 1024 else 1024
        gen = torch.Generator(device=dev).manual_seed(window + k)
        pk, mave, mstd, _ = device_genotypes(torch, m, n, n_pad, gen, missing)
        pads = torch.randperm(m, generator=gen, device=dev)[:9]
        pk[pads] = 0xFF
        mrow = kernel_rows(torch, mave, mstd, gen, n, pads, variances)
        eps = 0.8 * torch.randn(n_pad, generator=gen, device=dev)
        eps[n:] = 0.0
        mask = torch.zeros(n_pad, device=dev)
        mask[:n] = 1.0
        order = sk.block_order(torch.randperm(m // window, generator=gen,
                                              device=dev), window)
        kw = dict(window=window, n_mix=k, complete=not missing,
                  ind_mask=mask if not missing else None, order=order)
        data = f"W={window} K={k} {'missing 2%' if missing else 'complete'}"
        for name in names:
            fn, ref = ((sk.sweep_exact, sk.sweep_exact_ref)
                       if name == "sweep_exact"
                       else (sk.sweep_stale, sk.sweep_stale_ref))
            ms, plain_ms = compare_outputs(
                torch, name, data,
                lambda: fn(pk, eps, mrow, i2se, float(n - 1), **kw),
                lambda: ref(pk, eps, mrow, i2se, float(n - 1), **kw), 2,
                tol, card, rec, comp_of=lambda o: o[1][:, 1])
            # phase 2's bound of the same sweep
            nbytes = (pk.numel() + 3 * 4 * n_pad + mrow.numel() * 4 + 4 * m
                      + 16 * m)
            ops = {"f32": 4.0 * m * n_pad}
            if name == "sweep_exact":
                ops["int8"] = (window + 1.0) * m * n_pad
            print_bound(f"{name} {data}", dict(
                zip(("ms", "plain_ms"), (ms, plain_ms)),
                **dict(zip(("bound_ms", "bound_by"), bound(nbytes, ops)))))
            if window > 1024:
                e_k, o_k = fn(pk, eps, mrow, i2se, float(n - 1), **kw)
                mode = ("missing" if missing else
                        "exact" if name == "sweep_exact" else "stale")
                check_axpy_bitwise(torch, f"{name} {data}", e_k,
                                   wk.sweep_update_ref(pk, eps, mrow,
                                                       o_k[:, 3], order,
                                                       window, mode, mask),
                                   card)
        del pk, mrow
    # window_gibbs: pieces of 1,024 markers, and K = 20
    for window, k in ((1025, K), (2048, K), (128, len(WIDE_VARIANCES) + 1)):
        args = gibbs_inputs(torch, window, k, torch.Generator(
            device=dev).manual_seed(window + k))
        ms, plain_ms = compare_outputs(
            torch, "window_gibbs", f"W={window} K={k}",
            lambda: gk.window_gibbs(*args), lambda: gk.window_gibbs_ref(*args),
            3, tol, card, rec, comp_of=lambda o: o[2])
        # phase 2d's bound of a call
        nbytes = (4 * window * window + 4 * window * (5 + k + 2 * (k - 1))
                  + 4 + 16 * window)
        print_bound(f"window_gibbs W={window} K={k}", dict(
            ms=ms, plain_ms=plain_ms, **dict(zip(("bound_ms", "bound_by"), bound(
                nbytes, {"f32": 2.0 * window * window + 100.0 * window})))))
    # multi-trait, T = 20
    m, T = 4096, WIDE_T
    gen = torch.Generator(device=dev).manual_seed(29)
    pk, mave, mstd, _ = device_genotypes(torch, m, n, n_pad, gen)
    pads = torch.randperm(m, generator=gen, device=dev)[:37]
    pk[pads] = 0xFF
    mrow = mt_kernel_rows(torch, mave, mstd, gen, n, pads, T)
    i2se_t = torch.full((T,), i2se, device=dev)
    for na_frac in (0.1, 0.0):
        tm = torch.zeros((n_pad, T), device=dev)
        tm[:n] = (torch.rand((n, T), generator=gen, device=dev)
                  >= na_frac).float()
        eps = 0.8 * torch.randn((n_pad, T), generator=gen, device=dev) * tm
        dnm1 = tm.sum(dim=0) - 1.0
        data = f"T={T} {'NaN 10%' if na_frac else 'full'}"
        name, window = (("sweep_stale_mt", 64) if na_frac
                        else ("sweep_exact_mt", 128))
        fn, ref = ((skmt.sweep_stale_mt, skmt.sweep_stale_mt_ref) if na_frac
                   else (skmt.sweep_exact_mt, skmt.sweep_exact_mt_ref))
        kw = dict(window=window, n_mix=K, order=sk.block_order(
            torch.randperm(m // window, generator=gen, device=dev), window))
        if na_frac:
            kw["complete"] = True
        ms, plain_ms = compare_outputs(
            torch, name, f"W={window} {data}",
            lambda: fn(pk, eps, tm, mrow, i2se_t, dnm1, **kw),
            lambda: ref(pk, eps, tm, mrow, i2se_t, dnm1, **kw), 2, tol, card,
            rec, comp_of=lambda o: o[1][:, T:2 * T])
        # phase 2c's bound of the same sweep
        nbytes = (pk.numel() + 3 * 4 * T * n_pad + mrow.numel() * 4 + 4 * m
                  + 12 * T * m)
        ops = {"f32": 4.0 * T * m * n_pad}
        if not na_frac:
            ops["int8"] = (window + 1.0) * m * n_pad
        print_bound(f"{name} W={window} {data}", dict(
            ms=ms, plain_ms=plain_ms,
            **dict(zip(("bound_ms", "bound_by"), bound(nbytes, ops)))))
        e_k, o_k = fn(pk, eps, tm, mrow, i2se_t, dnm1, **kw)
        check_mt_bitwise("axpy_mt_kernel", f"{name} W={window} {data}",
                         torch.equal(e_k, wk.sweep_update_mt_ref(
                             pk, eps, tm, mrow, o_k, kw["order"], window,
                             True)), card)
        if not na_frac:
            continue
        # the exact per-window path's kernels on one W=128 window
        W = 128
        rows = torch.randperm(m, generator=gen, device=dev)[:W].to(
            torch.int32)
        slots = rows.long()
        real = ~torch.isin(slots, pads)
        check_mt_bitwise("stats_mt_kernel", f"window_stats_mt W={W} {data}",
                         all(torch.equal(a[real], b[real]) for a, b in zip(
                             wk.window_stats_mt(pk, eps, True, rows),
                             wk.window_stats_mt_seq(pk, eps, True, rows))
                             if b is not None), card)
        c1 = 0.01 * torch.randn((T, W), generator=gen, device=dev) * real
        c2 = -c1 * mave[slots][None, :]
        check_mt_bitwise("axpy_mt_kernel", f"window_axpy_mt W={W} {data}",
                         torch.equal(wk.window_axpy_mt(pk, c1, c2, True,
                                                       rows)[:n],
                                     wk.window_axpy_mt_seq(pk, c1, c2, True,
                                                           rows)[:n]), card)
        x = torch.randn((T, W, 1024), generator=gen, device=dev)
        gram = (x @ x.transpose(1, 2)).contiguous()
        num0 = 30.0 * torch.randn((W, T), generator=gen, device=dev)
        compare_outputs(torch, "mt_window_recurrence", f"W={W} {data}",
                        lambda: skmt.mt_window_recurrence(
                            gram, num0, mrow, i2se_t, n_mix=K, rows=rows),
                        lambda: skmt.mt_window_recurrence_ref(
                            gram, num0, mrow, i2se_t, n_mix=K, rows=rows), 3,
                        tol, card, rec, comp_of=lambda o: o[1])
    del pk, mrow, eps, tm
    phase_wide_mt(torch, np, sk, card, rec, m, n, n_pad)
    phase_wide_passes(torch, np, sk, card, rec, m, n, n_pad)


def phase_wide_mt(torch, np, sk, card, rec, m, n, n_pad):
    """Phase 2g's multi-trait arms all at once: W = 2,048 (pieces, the wide
    passes), T = 20 (trait groups) and K = 20 (K_ANY draws) on two windows
    of M=4,096 x N=50,000: sweep_stale_mt with 10% NaN, sweep_exact_mt on
    full phenotypes (its contract), and the exact per-window path with 10%
    NaN (window_stats_mt and window_axpy_mt bit for bit their plain
    versions, mt_window_recurrence on a per-trait Gram). The sweeps' eps
    bit for bit the plain update replayed from their own draws. The exact
    chains through compare_chains (a knife edge witnessed in float64), the
    rest through compare_outputs; tolerances of the arms at W <= 1,024."""
    from hydra_tpu_torch.ops import sweep_kernel_mt as skmt
    from hydra_tpu_torch.ops import window_kernels as wk
    dev = torch.device("cuda")
    W, T, k20 = 2048, WIDE_T, len(WIDE_VARIANCES) + 1
    tol = [(1e-3, 5e-4)] * 4
    gen = torch.Generator(device=dev).manual_seed(31)
    pk, mave, mstd, _ = device_genotypes(torch, m, n, n_pad, gen)
    pads = torch.randperm(m, generator=gen, device=dev)[:37]
    pk[pads] = 0xFF
    mrow = mt_kernel_rows(torch, mave, mstd, gen, n, pads, T, WIDE_VARIANCES)
    i2se_t = torch.linspace(0.6, 0.9, T, device=dev)
    order = sk.block_order(torch.randperm(m // W, generator=gen, device=dev),
                           W)
    for na_frac in (0.1, 0.0):
        tm = torch.zeros((n_pad, T), device=dev)
        tm[:n] = (torch.rand((n, T), generator=gen, device=dev)
                  >= na_frac).float()
        eps = 0.8 * torch.randn((n_pad, T), generator=gen, device=dev) * tm
        dnm1 = tm.sum(dim=0) - 1.0
        data = f"W={W} T={T} K={k20} {'NaN 10%' if na_frac else 'full'}"
        args = (pk, eps, tm, mrow, i2se_t, dnm1)
        if na_frac:
            name, kw = "sweep_stale_mt", dict(window=W, n_mix=k20, order=order,
                                              complete=True)
            ms, plain_ms = compare_outputs(
                torch, name, data, lambda: skmt.sweep_stale_mt(*args, **kw),
                lambda: skmt.sweep_stale_mt_ref(*args, **kw), 2, tol, card,
                rec, comp_of=lambda o: o[1][:, T:2 * T])
        else:
            name, kw = "sweep_exact_mt", dict(window=W, n_mix=k20, order=order)

            def witness(k1, w, j, t, comps):
                return skmt.sweep_exact_mt_edge(*args, k1[1], w=w, j=j, t=t,
                                                comps=comps, **kw)

            ms, plain_ms = compare_chains(
                torch, name, data, lambda: skmt.sweep_exact_mt(*args, **kw),
                lambda: skmt.sweep_exact_mt_ref(*args, **kw), 2, tol, card,
                rec, lambda o: o[1][order.long(), T:2 * T],
                lambda o: (o[0], o[1].reshape(m, 3, T)), W, witness)
        # phase 2c's bound of the same sweep
        nbytes = (pk.numel() + 3 * 4 * T * n_pad + mrow.numel() * 4 + 4 * m
                  + 12 * T * m)
        ops = {"f32": 4.0 * T * m * n_pad}
        if not na_frac:
            ops["int8"] = (W + 1.0) * m * n_pad
        print_bound(f"{name} {data}", dict(
            ms=ms, plain_ms=plain_ms,
            **dict(zip(("bound_ms", "bound_by"), bound(nbytes, ops)))))
        e_k, o_k = (skmt.sweep_stale_mt if na_frac
                    else skmt.sweep_exact_mt)(*args, **kw)
        check_mt_bitwise("axpy_mt_kernel", f"{name} {data}",
                         torch.equal(e_k, wk.sweep_update_mt_ref(
                             pk, eps, tm, mrow, o_k, order, W, True)), card)
        if not na_frac:
            continue
        # the exact per-window path's kernels on one W=2,048 window
        rows = torch.randperm(m, generator=gen, device=dev)[:W].to(
            torch.int32)
        slots = rows.long()
        real = ~torch.isin(slots, pads)
        check_mt_bitwise("stats_mt_kernel", f"window_stats_mt {data}",
                         all(torch.equal(a[real], b[real]) for a, b in zip(
                             wk.window_stats_mt(pk, eps, True, rows),
                             wk.window_stats_mt_seq(pk, eps, True, rows))
                             if b is not None), card)
        c1 = 0.01 * torch.randn((T, W), generator=gen, device=dev) * real
        c2 = -c1 * mave[slots][None, :]
        check_mt_bitwise("axpy_mt_kernel", f"window_axpy_mt {data}",
                         torch.equal(wk.window_axpy_mt(pk, c1, c2, True,
                                                       rows)[:n],
                                     wk.window_axpy_mt_seq(pk, c1, c2, True,
                                                           rows)[:n]), card)
        x = torch.randn((T, W, 1024), generator=gen, device=dev)
        gram = (x @ x.transpose(1, 2)).contiguous()
        del x
        num0 = 30.0 * torch.randn((W, T), generator=gen, device=dev)
        blk = mrow[slots].reshape(W, -1, T)
        rargs = (gram, num0, mrow, i2se_t)

        def witness(k1, w, j, t, comps):
            return skmt.recurrence_edge(gram[t, j], num0[j, t], k1[3][:j, t],
                                        blk[j, :, t], i2se_t[t], k20, comps)

        compare_chains(torch, "mt_window_recurrence", data,
                       lambda: skmt.mt_window_recurrence(
                           *rargs, n_mix=k20, rows=rows),
                       lambda: skmt.mt_window_recurrence_ref(
                           *rargs, n_mix=k20, rows=rows), 3, tol, card, rec,
                       lambda o: o[1], lambda o: o, W, witness)
        del gram


def phase_wide_passes(torch, np, sk, card, rec, m, n, n_pad):
    """Phase 2g's single-trait wide arms beside the sweeps: sweep_stale_sd
    with one sub-window of 2,048 markers a window (complete and 2% missing
    calls; components equal and the tolerance of phase 2e, and bit for bit
    sweep_stale on the same inputs, as there), and window_stats_planes and
    window_axpy_planes at W = 2,048 (the stats in launches of 1,024 rows,
    axpy_planes_kernel<true>), bit for bit their plain versions, on
    M=4,096 x N=50,000."""
    from hydra_tpu_torch.ops import planes as tpl
    dev = torch.device("cuda")
    W = 2048
    i2se = 1.0 / (2 * SIGMA_E)
    tol = [(1e-3, 5e-4)] * 2
    for missing in (0.0, 0.02):
        gen = torch.Generator(device=dev).manual_seed(37)
        pk, mave, mstd, _ = device_genotypes(torch, m, n, n_pad, gen, missing)
        pads = torch.randperm(m, generator=gen, device=dev)[:37]
        pk[pads] = 0xFF
        mrow = kernel_rows(torch, mave, mstd, gen, n, pads)
        eps = 0.8 * torch.randn(n_pad, generator=gen, device=dev)
        eps[n:] = 0.0
        mask = torch.zeros(n_pad, device=dev)
        mask[:n] = 1.0
        order = torch.randperm(m, generator=gen, device=dev).to(torch.int32)
        complete = not missing
        kw = dict(window=W, n_mix=K, complete=complete,
                  ind_mask=mask if complete else None, order=order)
        args = (pk, eps, mrow, i2se, float(n - 1))
        data = f"W={W} Wt={W} {'complete' if complete else 'missing 2%'}"
        compare_outputs(
            torch, "sweep_stale_sd", data,
            lambda: sk.sweep_stale_sd(*args, sub_window=W, **kw),
            lambda: sk.sweep_stale_sd_ref(*args, sub_window=W, **kw), 2, tol,
            card, rec, comp_of=lambda o: o[1][:, 1])
        e_k, o_k = sk.sweep_stale_sd(*args, sub_window=W, **kw)
        e_s, o_s = sk.sweep_stale(*args, **kw)
        same = torch.equal(e_k, e_s) and torch.equal(o_k, o_s)
        print(f"  beside sweep_stale on the same inputs: bitwise equal "
              f"{same}  [{card}]", flush=True)
        if not same:
            raise AssertionError(f"sweep_stale_sd {data} is not sweep_stale "
                                 "bit for bit")
        if not complete:
            continue
        planes = tpl.build_planes(pk)
        rows = torch.randperm(m, generator=gen, device=dev)[:W].to(
            torch.int32)
        c1 = 0.05 * torch.randn(W, generator=gen, device=dev)
        for name, fn, ref in (
                ("window_stats_planes",
                 lambda: (tpl.window_stats_planes(planes, eps, rows),),
                 lambda: (tpl.window_stats_planes_ref(planes, eps, rows),)),
                ("window_axpy_planes",
                 lambda: (tpl.window_axpy_planes(planes, c1, rows),),
                 lambda: (tpl.window_axpy_planes_ref(planes, c1, rows),))):
            ms, plain_ms = compare_outputs(torch, name, f"W={W}", fn, ref, 5,
                                           [(1e-5, 1e-6 * n)], card, rec)
            if not torch.equal(fn()[0], ref()[0]):
                raise AssertionError(f"{name} W={W} differs from its plain "
                                     "version")
            # phase 2d's bound of a call
            nbytes = W * n_pad + 8 * W + 4 * n_pad + (
                4 * W if name == "window_stats_planes" else 0)
            print_bound(f"{name} W={W}", dict(
                ms=ms, plain_ms=plain_ms, **dict(zip(
                    ("bound_ms", "bound_by"),
                    bound(nbytes, {"f32": 2.0 * W * n_pad})))))
        del planes, pk, mrow


def write_plink(np, base, m, n, seed, weibull=False, missing=0.0):
    """Synthetic .bed/.bim/.fam/.phen with h2 = 0.5 over 1% causal markers.
    weibull: the .phen holds log-times mu + g + (log E + EuMasc)/alpha with
    alpha 8, mu 4, E ~ Exp(1) (tests/test_bayesw.py::simulate_weibull's
    model), and a .fail marks 10% of individuals as censored. missing: the
    share of calls written as missing (drawn from seed + 1; the phenotype
    comes from the complete genotypes)."""
    from hydra_tpu_torch.io.plink import write_bed
    rs = np.random.RandomState(seed)
    p = rs.uniform(0.05, 0.5, (m, 1))
    geno = ((rs.random_sample((m, n)) < p).astype(np.int8)
            + (rs.random_sample((m, n)) < p).astype(np.int8))
    if missing:
        miss = np.random.RandomState(seed + 1).random_sample((m, n)) < missing
        write_bed(base + ".bed", np.where(miss, -1, geno).astype(np.int8))
    else:
        write_bed(base + ".bed", geno)
    with open(base + ".fam", "w") as fh:
        fh.writelines(f"f{i} i{i} 0 0 0 -9\n" for i in range(n))
    with open(base + ".bim", "w") as fh:
        fh.writelines(f"1 rs{j} 0 {j + 1} A C\n" for j in range(m))
    causal = rs.choice(m, m // 100, replace=False)
    x = geno[causal].astype(np.float64)
    x = (x - x.mean(1, keepdims=True)) / x.std(1, keepdims=True)
    g = x.T @ (rs.randn(len(causal)) * np.sqrt(0.5 / len(causal)))
    if weibull:
        alpha = 8.0
        noise_var = np.pi ** 2 / 6.0 / alpha ** 2
        y = (4.0 + g * np.sqrt(noise_var)
             + (np.log(rs.exponential(1.0, n)) + EULER_MASCHERONI) / alpha)
        with open(base + ".fail", "w") as fh:
            fh.writelines(f"{int(v)}\n" for v in rs.random_sample(n) > 0.1)
    else:
        y = g + rs.randn(n) * np.sqrt(0.5)
    with open(base + ".phen", "w") as fh:
        fh.writelines(f"f{i} i{i} {y[i]:.8f}\n" for i in range(n))


def check_outputs(np, base, m, n_rows, survival=False):
    """hydra formats: .csv rows (BayesRRm: it, nG, sigmaG[nG], sigmaE, h2,
    ...; BayesW: it, mu, sigmaG, alpha, h2w, ...) and .bet/.cpn =
    [u32 Mtot] then [u32 it][Mtot values] per thinned row. Returns the mean
    h2 (BayesW: the mean alpha) over the second half of the rows."""
    rows = [ln.split(",") for ln in open(base + ".csv") if ln.strip()]
    if len(rows) != n_rows:
        raise AssertionError(f"{base}.csv has {len(rows)} rows, want {n_rows}")
    its = [int(r[0]) for r in rows]
    for ext, dt in ((".bet", np.float64), (".cpn", np.int32)):
        raw = np.fromfile(base + ext, dtype=np.uint8)
        if int(raw[:4].view(np.uint32)[0]) != m:
            raise AssertionError(f"{base}{ext}: bad Mtot header")
        rec = raw[4:].reshape(n_rows, 4 + m * np.dtype(dt).itemsize)
        if (rec[:, :4].copy().view(np.uint32)[:, 0].tolist() != its
                or not np.isfinite(rec[:, 4:].copy().view(dt)).all()):
            raise AssertionError(f"{base}{ext}: bad records")
    if survival:
        alpha = np.array([float(r[3]) for r in rows])
        h2w = np.array([float(r[4]) for r in rows])
        if not (np.all(np.isfinite(alpha) & (alpha > 0))
                and np.all((h2w >= 0) & (h2w < 1))):
            raise AssertionError(f"{base}.csv: bad alpha {alpha} or h2w {h2w}")
        return float(alpha[len(alpha) // 2:].mean())
    h2 = np.array([float(r[3 + int(r[1])]) for r in rows])
    if not np.all(np.isfinite(h2) & (h2 > 0) & (h2 < 1)):
        raise AssertionError(f"{base}.csv: h2 outside (0, 1): {h2}")
    return float(h2[len(h2) // 2:].mean())


def padded_individuals(np, n):
    """n_pad as the data layout pads n individuals."""
    from hydra_tpu_torch.data.genotypes import pad_individuals
    return pad_individuals(n)


def phase_cli(torch, np, sk, tmp):
    """The main path through the CLI, counted; then one CUDA sweep against
    the CPU sampler with identical noise."""
    from hydra_tpu_torch import cli
    from hydra_tpu_torch.samplers.bayesrrm import (BayesRRm, state_from_numpy,
                                                   state_to_numpy)
    from hydra_tpu_torch.runner import dataset_from_options
    from hydra_tpu_torch.options import parse_args
    m, n = 10_000, 5_000
    base = os.path.join(tmp, "t_M10K_N_5K")
    write_plink(np, base, m, n, seed=3)
    common = ["--mpibayes", "bayesMPI", "--bfile", base, "--pheno",
              base + ".phen", "--S", "0.0001,0.001,0.01", "--chain-length",
              "50", "--thin", "5", "--save", "10", "--seed", "7",
              "--mcmc-out-dir", os.path.join(tmp, "out")]
    reset_all_launches()
    rc = [cli.main(common + ["--mcmc-out-name", "exact"]),
          cli.main(common + ["--mcmc-out-name", "stale", "--stale",
                             "--window", "64"])]
    torch.cuda.synchronize()
    launches = all_launches()
    print(f"main-path kernel launches: {json.dumps(launches)}", flush=True)
    if rc != [0, 0]:
        raise AssertionError(f"CLI exit codes {rc}")
    for name in ("sweep_exact", "sweep_stale"):
        if launches[name] != 50:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 "in the main-path run, want 50")
    for name in ("exact", "stale"):
        h2 = check_outputs(np, os.path.join(tmp, "out", name), m, 10)
        print(f"{name}: 10 thinned records, mean h2 over the last 5 = "
              f"{h2:.4f} (simulated 0.5)", flush=True)

    # one sweep, CUDA sampler vs CPU sampler, same state and noise
    opt = parse_args(common + ["--window", "64"])
    ds = dataset_from_options(opt)
    for exact in (True, False):
        cpu = BayesRRm(ds, window=64, exact=exact, seed=7, device="cpu")
        gpu = BayesRRm(ds, window=64, exact=exact, seed=7, device="cuda")
        s_cpu = cpu.init_state()
        s_gpu = state_from_numpy(state_to_numpy(s_cpu), "cuda")
        g = torch.Generator().manual_seed(5)
        noise = dict(mu=torch.randn((), generator=g),
                     u=torch.rand(cpu.cfg.m_loc, generator=g),
                     nrm=torch.randn(cpu.cfg.m_loc, generator=g),
                     wperm=torch.randperm(cpu.cfg.n_windows, generator=g))
        a, _ = cpu.step(s_cpu, 0, noise=noise)
        b, _ = gpu.step(s_gpu, 0, noise={k: v.cuda() for k, v in noise.items()})
        a, b = state_to_numpy(a), state_to_numpy(b)
        d_eps = float(np.abs(a["eps"] - b["eps"]).max())
        d_beta = float(np.abs(a["beta"] - b["beta"]).max())
        n_comp = int((a["components"] != b["components"]).sum())
        print(f"one {'exact' if exact else 'stale'} sweep, CUDA vs CPU "
              f"sampler: max|d eps| {d_eps:.3e}  max|d beta| {d_beta:.3e}  "
              f"comp mismatches {n_comp}", flush=True)
        np.testing.assert_allclose(b["eps"], a["eps"], atol=5e-4, rtol=1e-3)
        np.testing.assert_allclose(b["beta"], a["beta"], atol=5e-4, rtol=1e-3)
        if n_comp:
            raise AssertionError("component mismatches CUDA vs CPU sampler")
    return launches


# phase 3k: the wide arms through the CLI (name, bed, extra argv, the
# launch counter that must move once a sweep)
WIDE_CLI_ITERS = 5
WIDE_CLI_RUNS = (
    ("wide_exact_w2048", "t_M10K_N_5K", ("--window", "2048"), "sweep_exact"),
    ("wide_stale_sync2048", "t_M10K_N_5K", ("--stale", "--sync-rate", "2048"),
     "sweep_stale"),
    ("wide_k20", "t_M10K_N_5K",
     ("--S", ",".join(f"{v:.6g}" for v in WIDE_VARIANCES)), "sweep_exact"),
    ("wide_t20_stale", "mt_M10K_N_5K", ("--stale", "--window", "64"),
     "sweep_stale_mt"))


def phase_wide_cli(torch, np, tmp):
    """The wide arms through the CLI on phase 3's and 3c's beds (M=10,000 x
    N=5,000), WIDE_CLI_ITERS iterations each, counted: --window 2048
    (exact, 5 windows of which the last mostly pad slots), --stale
    --sync-rate 2048, a --S grid of 19 values (K = 20) and 20 --pheno files
    (T = 20, --stale --window 64); each run's csv and .bet records are
    checked, and its sweep wrapper must launch once a sweep."""
    from hydra_tpu_torch import cli
    m, n = 10_000, 5_000
    phen = write_mt_phenos(np, os.path.join(tmp, "mt_M10K_N_5K"), m, n,
                           WIDE_T, seed=31)
    reset_all_launches()
    for name, bed, extra, counter in WIDE_CLI_RUNS:
        base = os.path.join(tmp, bed)
        argv = ["--mpibayes", "bayesMPI", "--bfile", base, "--pheno",
                phen if counter.endswith("_mt") else base + ".phen",
                "--chain-length", str(WIDE_CLI_ITERS), "--thin", "1",
                "--save", "5", "--seed", "7", "--mcmc-out-dir",
                os.path.join(tmp, "out"), "--mcmc-out-name", name, *extra]
        if "--S" not in extra:
            argv += ["--S", "0.0001,0.001,0.01"]
        before = all_launches()[counter]
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        moved = all_launches()[counter] - before
        out = os.path.join(tmp, "out", name + (".t0" if counter.endswith("_mt")
                                              else ""))
        h2 = check_outputs(np, out, m, WIDE_CLI_ITERS)
        print(f"{name}: exit {rc}, {counter} launched {moved} times, "
              f"{time.perf_counter() - t0:.1f} s, mean h2 over the last "
              f"rows {h2:.4f}", flush=True)
        if rc != 0 or moved != WIDE_CLI_ITERS:
            raise AssertionError(f"{name}: exit {rc}, {counter} launched "
                                 f"{moved} times, want {WIDE_CLI_ITERS}")
    launches = all_launches()
    print(f"wide-arm CLI kernel launches: {json.dumps(launches)}", flush=True)
    return launches


def wide_reading(torch, s, label, card):
    """One sampler configuration in at most three sweeps: a warm-up step,
    a step timed by CUDA events with the wrappers' launches counted, and a
    profiled step (torch.profiler): ms a step (one sweep and its
    hyperparameters), busy share, device kernels a sweep and the device ms
    by kernel [card]."""
    st = s.init_state()
    st, _ = s.step(st, 0)
    torch.cuda.synchronize()
    reset_all_launches()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    st, _ = s.step(st, 1)
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop)
    counted = {k: v for k, v in all_launches().items() if v}
    if not bool(torch.isfinite(st.eps).all()):
        raise AssertionError(f"{label}: non-finite residual")
    per = device_times(torch, lambda: s.step(st, 2), label)
    busy = sum(v[1] for v in per.values())
    n_dev = sum(v[0] for v in per.values())
    n_port = sum(v[0] for k, v in per.items() if "hydra::" in k)
    print(f"wide reading {label}: {ms:.2f} ms a step by CUDA events, "
          f"wrapper launches {json.dumps(counted)}, {n_dev} device kernels "
          f"({n_port} of the port), profiler device time {busy:.2f} ms "
          f"({100.0 * busy / ms:.1f}% busy)  [{card}]", flush=True)
    ranked = sorted(per.items(), key=lambda kv: -kv[1][1])
    for i, (k, (cnt, t)) in enumerate(ranked):
        if i >= 8 and "hydra::" not in k:
            continue
        print(f"    {t:9.3f} ms  {cnt:6d} x  {k[:90]}", flush=True)


def phase_wide_real_size(torch, np, ds, pk, card):
    """Phase 4's readings of the wide arms on its complete M=100,000 x
    N=50,000 data (wide_reading, three sweeps each): BayesRRm exact and
    stale at W = 2,048 (49 windows, 100,352 slots), exact at W = 1,024 (the
    cost of running a 2,048-marker exact window as two windows of 1,024
    instead of in pieces), and exact W=128 at K = 20 (the same genotypes, a
    19-value variance grid)."""
    import dataclasses
    from hydra_tpu_torch.data.genotypes import make_default_groups
    from hydra_tpu_torch.samplers.bayesrrm import BayesRRm
    from hydra_tpu_torch.ops.sweep_kernel import mrow_width
    dev = torch.device("cuda")
    nb = pk.shape[1]
    for exact, window in ((True, 2048), (False, 2048), (True, 1024)):
        s = BayesRRm(ds, window=window, exact=exact, seed=1, device=dev,
                     packed_device=pk)
        wide_reading(torch, s, f"{'exact' if exact else 'stale'} "
                     f"W={window} M=100,000 x N=50,000", card)
        print_stream_bounds(window, nb, s.cfg.n_windows)
        if exact:
            print_exact_bounds(window, nb, mrow_width(K), True,
                               s.cfg.n_windows)
        del s
    groups, mS = make_default_groups(ds.geno.m, list(WIDE_VARIANCES))
    ds20 = dataclasses.replace(ds, groups=groups, mS=mS)
    s = BayesRRm(ds20, window=128, exact=True, seed=1, device=dev,
                 packed_device=pk)
    wide_reading(torch, s, "exact W=128 K=20 M=100,000 x N=50,000", card)
    print_exact_bounds(128, nb, mrow_width(len(WIDE_VARIANCES) + 1), True,
                       s.cfg.n_windows)


def real_size_dataset(torch, np, missing=0.0, m=100_000, seed=2):
    """M=100,000 (or m) x N=50,000 genotypes made on the card (seed 2 or
    ``seed``; with ``missing``, a share of missing calls) as a Dataset and
    its packed rows on the card, phenotypes noise."""
    from hydra_tpu_torch.data.genotypes import (Dataset, GenotypeData,
                                                make_default_groups)
    dev = torch.device("cuda")
    n = 50_000
    n_pad = padded_individuals(np, n)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    pk, mave, mstd, nm = device_genotypes(torch, m, n, n_pad, gen, missing)
    torch.cuda.synchronize()
    print(f"generated {pk.numel() / 1e9:.3f} GB of packed genotypes on the "
          f"card in {time.perf_counter() - t0:.1f} s"
          + (f", {100 * missing:g}% missing" if missing else ""), flush=True)
    mave_h, mstd_h = mave.cpu().numpy(), mstd.cpu().numpy()
    geno = GenotypeData(packed=np.zeros((0, n_pad // 4), np.uint8), n=n,
                        n_pad=n_pad, m=m, mave=mave_h, mstd=mstd_h,
                        msd=1.0 / mstd_h, n1=None, n2=None,
                        nm=nm.cpu().numpy())
    groups, mS = make_default_groups(m, list(MS[1:]))
    y = np.random.RandomState(0).randn(n)
    return Dataset(geno=geno, y=y, groups=groups, num_groups=1, mS=mS), pk


def real_size_sweeps(torch, sk, ds, pk, exact, window, card, data="",
                     gram_check=False):
    """ms/sweep (host clock over 10 steps after 2 warm-up) and markers/s
    of one BayesRRm block configuration on ``real_size_dataset``'s data,
    then its profile (profile_sweep; gram_check: and check_gram_launches).
    Returns profile_sweep's profile."""
    from hydra_tpu_torch.samplers.bayesrrm import BayesRRm
    dev = torch.device("cuda")
    m = ds.geno.m
    torch.cuda.reset_peak_memory_stats()
    s = BayesRRm(ds, window=window, exact=exact, seed=1, device=dev,
                 packed_device=pk)
    st = s.init_state()
    for it in range(2):
        st, _ = s.step(st, it)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for it in range(2, 12):
        st, stats = s.step(st, it)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 100.0
    if not bool(torch.isfinite(st.eps).all()):
        raise AssertionError("non-finite residual at real size")
    sg, se = float(st.sigma_g.sum()), float(st.sigma_e)
    print(f"real size M=100,000 x N=50,000 {'exact' if exact else 'stale'}"
          f" W={window} block{data}: {ms:.2f} ms/sweep, {m / ms * 1e3:,.0f} "
          f"markers/s (10 sweeps after 2 warm-up), h2 {sg / (sg + se):.4f},"
          f" peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB  "
          f"[{card}]", flush=True)
    return profile_sweep(torch, sk, s, st, card, gram_check)


def phase_real_size(torch, np, sk, card):
    """BayesRRm exact W=128 and stale W=64 block at M=100,000 x N=50,000 on
    complete genotypes, then exact W=128 with 2% missing calls (a single
    missing call sends the exact sweep to the missing-data Gram); after
    each dataset's sweeps its batched Grams at W=128 and W=64 against their
    references (check_batched_grams)."""
    ds, pk = real_size_dataset(torch, np)
    for exact, window in ((True, 128), (False, 64)):
        real_size_sweeps(torch, sk, ds, pk, exact, window, card,
                         gram_check=exact)
    for window in (128, 64):
        check_batched_grams(torch, "real size", pk, ds.geno.n, window, card)
    phase_wide_real_size(torch, np, ds, pk, card)
    del ds, pk
    ds, pk = real_size_dataset(torch, np, 0.02)
    real_size_sweeps(torch, sk, ds, pk, True, 128, card, " missing 2%",
                     gram_check=True)
    dev = torch.device("cuda")
    mave = torch.from_numpy(ds.geno.mave).float().to(dev)
    mstd = torch.from_numpy(ds.geno.mstd).float().to(dev)
    for window in (128, 64):
        check_batched_grams(torch, "real size missing 2%", pk, ds.geno.n,
                            window, card, mave, mstd)


def profile_sweep(torch, sk, s, st, card, gram_check=False):
    """Where one BayesRRm sweep's time goes (see profile_run); gram_check:
    an exact sweep's Grams launch once a batch (check_gram_launches)."""
    cfg = s.cfg
    dev = s.device
    active = (st.sigma_g[s.groups] > 0) & (s.valid > 0) & (s.mstd > 0)
    mrow = s.build_mrow(st, torch.rand(cfg.m_loc, device=dev),
                        torch.randn(cfg.m_loc, device=dev), active)
    order = s.sweep_order(0)
    fn = sk.sweep_exact if cfg.exact else sk.sweep_stale
    kw = dict(window=cfg.window, n_mix=cfg.k, complete=cfg.complete,
              ind_mask=s.ind_mask if cfg.complete else None, order=order)
    # exact: stats, draw, axpy a window, and a batch's Grams in one launch
    # (gram_i8_batch_kernel; missing: gram_f32_batch_kernel); stale:
    # stats, then the axpy, which draws the window itself up to the
    # kernels' STALE_FOLD_MAX_W (above, the draw alone first: the profile
    # shows which)
    n_sub = cfg.window // cfg.sub_window if cfg.sub_window else 1
    if cfg.sub_window:
        fn = sk.sweep_stale_sd
        kw["sub_window"] = cfg.sub_window

    def launches(names):
        if cfg.exact:
            return 3 * cfg.n_windows + -(-cfg.n_windows // gram_batch(
                cfg.n_windows, cfg.window))
        return cfg.n_windows * n_sub * (3 if "stale_draw_kernel" in names
                                        else 2)

    def run():
        return fn(s.packed, st.eps, mrow, 0.5 / st.sigma_e,
                  float(cfg.n_real - 1), **kw)

    per = profile_run(torch, run, f"{'exact' if cfg.exact else 'stale'} "
                      f"W={cfg.window}"
                      + (f" Wt={cfg.sub_window}" if cfg.sub_window else ""),
                      launches, card, cfg.n_windows)
    fold = "stale_draw_kernel" not in port_kernels(per)
    nb = s.packed.shape[1]
    if cfg.sub_window:
        # stats_kernel<true> a sub-window; the update is axpy_decoded_kernel
        print_stream_bounds(cfg.sub_window, nb, cfg.n_windows * cfg.window
                            // cfg.sub_window, decode=True,
                            draw_cols=mrow.shape[1] if fold else 0)
    else:
        print_stream_bounds(cfg.window, nb, cfg.n_windows,
                            draw_cols=mrow.shape[1] if not cfg.exact and fold
                            else 0)
    if cfg.exact:
        print_exact_bounds(cfg.window, s.packed.shape[1], mrow.shape[1],
                           cfg.complete, cfg.n_windows)
    if gram_check:
        check_gram_launches(torch, f"real size exact W={cfg.window}"
                            f"{'' if cfg.complete else ' missing'}", run,
                            cfg.n_windows, cfg.window, not cfg.complete, card,
                            per)
    return per


def gram_batch(n_windows, W):
    """Windows a batched Gram launch of an exact sweep takes
    (window_kernels.gram_batch_windows; a tree whose sweeps launch a Gram a
    window: 1)."""
    from hydra_tpu_torch.ops import window_kernels as wk
    fn = getattr(wk, "gram_batch_windows", None)
    return 1 if fn is None else fn(n_windows, W)


def missing_gram_bound(W, nb, n_windows=1):
    """(ms, by) of one missing-data window Gram (gram_f32_batch_kernel), a
    window of a launch over n_windows: the launch's bound over n_windows.
    A window's W packed rows, order entries and mave and mstd in, its
    (W, W) f32 Gram out; the symmetric half's W (W + 1) / 2 entries, one
    f32 multiply-add (2 operations) per entry and individual."""
    ms, by = bound(n_windows * (W * nb + 12 * W + 4 * W * W),
                   {"f32": n_windows * W * (W + 1.0) * 4 * nb})
    return ms / n_windows, by


def complete_gram_bound(W, nb, n_windows=1):
    """(ms, by) of one complete-data window Gram (gram_i8_batch_kernel), a
    window of a launch over n_windows: a window's W packed rows and order
    entries in, its (W, W) f32 Gram out; the symmetric Gram's W (W + 1) / 2
    entries, one int8 multiply-add (2 operations) per entry and
    individual."""
    ms, by = bound(n_windows * (W * nb + 4 * W + 4 * W * W),
                   {"int8": n_windows * W * (W + 1.0) * 4 * nb})
    return ms / n_windows, by


def print_exact_bounds(W, nb, C, complete=True, n_windows=1):
    """The least time of one exact window's Gram and draw launches, the
    Gram a window of its batch (the sweep's n_windows windows in batches
    of gram_batch): complete_gram_bound or, missing data,
    missing_gram_bound. exact_draw_kernel: the stats partials (s1, s2, v),
    the W mrow rows and the Gram in, out and coef out; the rank-1 update
    (2 W^2 f32) and ~100 f32 operations a draw."""
    n_tiles = -(-nb // 512)
    batch = gram_batch(n_windows, W)
    gram = (complete_gram_bound if complete else missing_gram_bound)(
        W, nb, batch)
    draw = bound(12 * n_tiles * W + 4 * W * C + 4 * W * W + 16 * W
                 + 4 * (2 * W + 1), {"f32": 2.0 * W * W + 100.0 * W})
    print(f"  bound per window (W={W}, nb={nb}): "
          f"{'gram_i8_batch_kernel' if complete else 'gram_f32_batch_kernel'}"
          f" {1e3 * gram[0]:.4f} us ({gram[1]}; a window of a batch of "
          f"{batch}), exact_draw_kernel {1e3 * draw[0]:.4f} us ({draw[1]})",
          flush=True)


def print_bw_bounds(W, nb, C, complete, Q, launches):
    """The least time of one BayesW window's levels_kernel and
    bw_draw_kernel launches. levels_kernel: the W packed rows and the order
    in, vi once, the per-tile partials out (s1, s2, with missing data the
    mask dot, and sum vi); one f32 multiply-add (2 operations) a genotype
    and sum. bw_draw_kernel: the W mrow rows (C floats), the order, the
    partials and the Gauss-Hermite table in, out (4 floats a marker) and
    coef (2 W + 1) out; ~2,700 f32 operations a marker, as if every marker
    ran the whole slice budget (the bytes bound it either way)."""
    n_pad, n_tiles = 4 * nb, -(-nb // 512)
    sums = 2 if complete else 3
    parts = 4 * n_tiles * (sums * W + 1)
    levels = bound(W * nb + 4 * W + 4 * n_pad + parts,
                   {"f32": 2.0 * sums * W * n_pad})
    draw = bound(4 * W * C + 4 * W + parts + 8 * Q + 16 * W + 4 * (2 * W + 1),
                 {"f32": 2700.0 * W})
    print(f"  bound per window (W={W}, nb={nb}): levels_kernel "
          f"{1e3 * levels[0]:.4f} us ({levels[1]}), bw_draw_kernel "
          f"{1e3 * draw[0]:.4f} us ({draw[1]}); {launches} launches a sweep "
          "each", flush=True)


def device_times(torch, fn, label, need=""):
    """{kernel name: (launches, device ms)} of one call of fn, from
    torch.profiler's device activities (fn is called again where its
    session came back empty, or with no activity whose name holds
    ``need``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    # a session comes back empty now and then among many short ones (three
    # in a row seen once, before a one-launch call): it is taken again, up
    # to 6 times, each with a longer lead-in, before it fails
    for attempt in range(6):
        if attempt:
            print(f"  {label}: profiler session {attempt} saw no device "
                  "activity; taken again", flush=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # a session's first kernels can go unrecorded (up to 7 seen, a
            # sweep's Gram among them): spin kernels, left out of the
            # result, and a pause first
            for _ in range(16 << attempt):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(0.02 * (1 + attempt))
            fn()
            torch.cuda.synchronize()
        per = {}
        for e in prof.key_averages():
            # device activities only: an aten op's self device time repeats
            # that of the kernels it launched
            t = getattr(e, "self_device_time_total", 0.0) or 0.0
            if (t > 0 and getattr(e, "device_type", None) == DeviceType.CUDA
                    and "spin_kernel" not in e.key):
                per[e.key] = (e.count, t / 1000.0)
        if any(need in k for k in per):
            return per
        time.sleep(1.0)
    raise AssertionError(f"{label}: the profiler saw no device activity")


def _profile_retry(torch, fn, label):
    """device_times of fn, or None (a timing only, reported not measured)
    where every session came back empty."""
    try:
        return device_times(torch, fn, label)
    except AssertionError:
        return None


def kernel_name(key):
    """A port kernel's name in a profiler key (``void hydra::axpy_kernel<
    false, 1, 4>(...)`` -> ``axpy_kernel``)."""
    return key.split("hydra::", 1)[1].split("<", 1)[0].split("(", 1)[0]


def port_kernels(per):
    """The names of the port's kernels in a device_times profile."""
    return {kernel_name(k) for k in per if "hydra::" in k}


def profile_run(torch, run, label, launches, card, n_windows=None):
    """Host time to enqueue one sweep's launches against the time to
    finish on the card, and device time by kernel (torch.profiler; CUDA
    events time the whole sweep as a cross-check): ms per sweep, launches
    per sweep (or a function of the port's kernel names in the profile,
    for a sweep whose launches a window depend on the side of a fold
    threshold it took) and, given the sweep's windows, us per window.
    Returns the profile (device_times)."""
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ev_ms, _ = cuda_ms(torch, run, 3)
    per = device_times(torch, run, label)
    busy = sum(v[1] for v in per.values())
    n_dev = sum(v[0] for v in per.values())
    n_port = sum(v[0] for k, v in per.items() if "hydra::" in k)
    if callable(launches):
        launches = launches(port_kernels(per))
    print(f"  sweep {label}: {launches} kernel launches ({n_dev} device "
          f"kernels in the profile, {n_port} of the port); host enqueue "
          f"{1e3 * (t1 - t0):.2f} ms, done after {1e3 * (t2 - t0):.2f} ms; "
          f"CUDA events {ev_ms:.2f} ms/sweep; profiler device time "
          f"{busy:.2f} ms ({100.0 * busy / ev_ms:.1f}% busy)  [{card}]",
          flush=True)
    # the 8 longest, and every kernel of the port below them
    ranked = sorted(per.items(), key=lambda kv: -kv[1][1])
    for i, (k, (cnt, ms)) in enumerate(ranked):
        if i >= 8 and "hydra::" not in k:
            continue
        per_win = (f"  {1e3 * ms / n_windows:8.2f} us/window" if n_windows
                   else "")
        print(f"    {ms:9.3f} ms  {cnt:6d} x{per_win}  {k[:90]}", flush=True)
    return per


def bw_sampler(torch, np, m, n, seed, window, missing=0.0, variances=MS[1:]):
    """A BayesW sampler (block schedule, K = len(variances) + 1 (4), Q=25)
    on genotypes made on the card, Weibull log-times (alpha 8, mu 4) and
    10% censoring."""
    from hydra_tpu_torch.data.genotypes import (Dataset, GenotypeData,
                                                make_default_groups)
    from hydra_tpu_torch.samplers.bayesw import BayesW
    dev = torch.device("cuda")
    n_pad = padded_individuals(np, n)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pk, mave, mstd, nm = device_genotypes(torch, m, n, n_pad, gen, missing)
    mave_h = mave.double().cpu().numpy()
    mstd_h = mstd.double().cpu().numpy()
    geno = GenotypeData(packed=np.zeros((0, n_pad // 4), np.uint8), n=n,
                        n_pad=n_pad, m=m, mave=mave_h, mstd=mstd_h,
                        msd=1.0 / mstd_h, n1=None, n2=None,
                        nm=nm.cpu().numpy())
    groups, mS = make_default_groups(m, list(variances))
    rs = np.random.RandomState(seed)
    y = 4.0 + (np.log(rs.exponential(1.0, n)) + EULER_MASCHERONI) / 8.0
    fail = (rs.random_sample(n) > 0.1).astype(np.float64)
    ds = Dataset(geno=geno, y=y, groups=groups, num_groups=1, mS=mS,
                 fail=fail)
    return BayesW(ds, window=window, seed=seed, quad_points=25, device=dev,
                  packed_device=pk)


# phase 2b's BayesW cases (M, W, missing genotypes) at N=50,000, and its
# wide arms (M, W, missing genotypes, K): windows above 1,024 markers (the
# wide axpy with the vi refresh) and K = 40 (bw_draw_kernel<true>, the
# components in the warp's shared memory)
BW_CASES = ((4096, 64, 0.0), (4096, 64, 0.02), (512, 1, 0.0))
BW_WIDE_CASES = ((2050, 1025, 0.0, K), (4096, 2048, 0.02, K),
                 (4096, 64, 0.0, 40))


def bw_case(torch, np, m, window, missing, k=K):
    """A BayesW sweep's inputs at N=50,000 (bw_sampler, seed 11, K = k: a
    geometric grid of k - 1 variances from 1e-4 above 4): a state with 20%
    non-zero effects and a loose pi, so that every component and the slice
    sampler are exercised. Returns (sampler, sweep_stale_bw's positional
    args, its keywords, vi, the generator, left where it is)."""
    dev = torch.device("cuda")
    variances = (MS[1:] if k == K else
                 tuple(1e-4 * 1000.0 ** (i / (k - 2)) for i in range(k - 1)))
    s = bw_sampler(torch, np, m, 50_000, 11, window, missing, variances)
    cfg = s.cfg
    st = s.init_state()
    gen = torch.Generator(device=dev).manual_seed(3)
    nz = torch.rand(cfg.m_loc, generator=gen, device=dev) < 0.2
    st.beta = torch.where(nz, 0.02 * torch.randn(
        cfg.m_loc, generator=gen, device=dev), 0.0) * s.valid
    if k == K:
        st.pi_l = torch.tensor([[0.5, 0.2, 0.2, 0.1]], device=dev)
    else:
        p = torch.rand((1, k), generator=gen, device=dev) + 0.1
        st.pi_l = p / p.sum()
    alpha = st.alpha
    vi = torch.exp(alpha * st.eps - EULER_MASCHERONI) * s.ind_mask
    mrow = s.build_mrow(st, alpha, s.slot_noise(0))
    args = (s.packed, st.eps, vi, mrow, s.gh_x, s.gh_w, alpha)
    kw = dict(window=window, n_mix=cfg.k, complete=cfg.complete,
              ind_mask=s.ind_mask, order=s.sweep_order(0))
    return s, args, kw, vi, gen


def phase_bw_kernels(torch, np, card):
    """The BayesW kernels against their plain versions on the card. The
    plain versions repeat the kernels' arithmetic in their order, so the
    outputs must be equal bit for bit (sweep_stale_bw's eps and out,
    window_level_sums' sums, window_axpy's but for complete data's pad
    individuals) as well as within the sweep tolerance (atol 5e-4, rtol
    1e-3), and components must agree exactly. At K = 40 (bw_draw_kernel's
    K > 32 arm) the sweep is held as its card test holds it: components
    equal, eps and out within the sweep tolerance (a knife-edge slice
    state may differ in a last bit), its axpy bit for bit the plain update
    replayed from its draws."""
    from hydra_tpu_torch.ops import sweep_kernel_bw as skbw
    from hydra_tpu_torch.ops import window_kernels as wk
    dev = torch.device("cuda")
    rec = {k: dict(err=0.0) for k in ("sweep_stale_bw", "window_level_sums",
                                      "window_axpy")}
    for m, window, missing, k in ([c + (K,) for c in BW_CASES]
                                  + list(BW_WIDE_CASES)):
        s, args, kw, vi, gen = bw_case(torch, np, m, window, missing, k)
        cfg, mrow = s.cfg, args[3]

        def run():
            return skbw.sweep_stale_bw(*args, **kw)

        def plain():
            return skbw.sweep_stale_bw_ref(*args, **kw)

        e0, o0 = run()                               # build + warm up
        ms, (e1, o1) = cuda_ms(torch, run, 5)
        plain()
        plain_ms, (er, orf) = cuda_ms(torch, plain, 1)
        if not (torch.equal(e0, e1) and torch.equal(o0, o1)):
            raise AssertionError("sweep_stale_bw is not bitwise repeatable")
        d_eps = (e1 - er).abs().max().item()
        d_beta = (o1[:, 0] - orf[:, 0]).abs().max().item()
        n_comp = int((o1[:, 1] != orf[:, 1]).sum().item())
        used = torch.unique(o1[:, 1]).numel()
        bitwise = torch.equal(e1, er) and torch.equal(o1, orf)
        data = "missing 2%" if missing else "complete"
        data += f" K={k}" if k != K else ""
        print(f"sweep_stale_bw M={m} W={window:2d} {data:10s} kernel "
              f"{ms:9.3f} ms  plain {plain_ms:9.3f} ms  max|d eps| "
              f"{d_eps:.3e}  max|d beta| {d_beta:.3e}  comp mismatches "
              f"{n_comp}  components used {used}  non-zero "
              f"{int((o1[:, 1] > 0).sum())}  bitwise equal to plain "
              f"{bitwise}  [{card}]", flush=True)
        torch.testing.assert_close(e1, er, atol=5e-4, rtol=1e-3)
        torch.testing.assert_close(o1[:, 0], orf[:, 0], atol=5e-4, rtol=1e-3)
        if k != K:
            torch.testing.assert_close(o1, orf, atol=5e-4, rtol=1e-3)
        elif not bitwise:
            raise AssertionError(f"sweep_stale_bw W={window} {data} differs "
                                 "from its plain version")
        if n_comp:
            raise AssertionError(f"sweep_stale_bw: {n_comp} component "
                                 "mismatches against the plain version")
        if used < 3:
            raise AssertionError("sweep_stale_bw: degenerate draws")
        check_axpy_bitwise(torch, f"sweep_stale_bw W={window} {data}", e1,
                           wk.sweep_update_ref(
                               s.packed, args[1], mrow, o1[:, 2], kw["order"],
                               window, "stale" if cfg.complete else "missing",
                               s.ind_mask), card)
        r = rec["sweep_stale_bw"]
        r["err"] = max(r["err"], d_eps, d_beta)
        n_pad, nb = cfg.n_pad, s.packed.shape[1]
        # packed rows, eps, vi, mask, mrow, order, GH in; eps, out out.
        # Ops: the two level-sum FMAs and the axpy FMA per genotype, the vi
        # refresh per window, ~2,700 for each marker's draw
        nbytes = (m * nb + 4 * 4 * n_pad + mrow.numel() * 4 + 4 * m
                  + 8 * 25 + 16 * m)
        ops = {"f32": 6.0 * m * n_pad + 4.0 * (m // window) * n_pad
               + 2700.0 * m}
        if window == 64 and not missing and k == K:
            r["ms"], r["plain_ms"] = ms, plain_ms
            r["bound_ms"], r["bound_by"] = bound(nbytes, ops)
        elif window > 64 or k != K:
            print_bound(f"sweep_stale_bw W={window} {data}", dict(
                ms=ms, plain_ms=plain_ms,
                **dict(zip(("bound_ms", "bound_by"), bound(nbytes, ops)))))

        if window != 64 or k != K:
            continue
        # the standalone window kernels on the first window's rows
        pk_w = s.packed[:window].contiguous()
        c1 = 0.05 * torch.randn(window, generator=gen, device=dev)
        c2 = -c1 * s.mave[:window]
        complete = cfg.complete
        for name, fn, ref, ops_per in (
                ("window_level_sums",
                 lambda: wk.window_level_sums(pk_w, vi, complete),
                 lambda: wk.window_level_sums_ref(pk_w, vi, complete),
                 4.0 if complete else 6.0),
                ("window_axpy",
                 lambda: wk.window_axpy(pk_w, c1, c2, complete),
                 lambda: wk.window_axpy_ref(pk_w, c1, c2, complete),
                 2.0 if complete else 4.0)):
            k0 = fn()
            kms, k1 = cuda_ms(torch, fn, 20)
            ref()
            pms, p1 = cuda_ms(torch, ref, 1)
            k0, k1, p1 = ([t for t in x if t is not None]
                          if isinstance(x, tuple) else [x]
                          for x in (k0, k1, p1))
            if not all(torch.equal(a, b) for a, b in zip(k0, k1)):
                raise AssertionError(f"{name} is not bitwise repeatable")
            err = max((a - b).abs().max().item() for a, b in zip(k1, p1))
            bitwise = all(torch.equal(a, b) for a, b in zip(k1, p1))
            print(f"{name:17s} W={window} {data:10s} kernel {kms:8.4f} ms  "
                  f"plain {pms:9.3f} ms  max|diff| {err:.3e}  bitwise equal "
                  f"to plain {bitwise}  [{card}]", flush=True)
            for a, b in zip(k1, p1):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
            if name == "window_level_sums" and not bitwise:
                raise AssertionError("window_level_sums differs from its "
                                     "plain version")
            if name == "window_axpy":
                # bit for bit but for the pad individuals' h = 3 products in
                # complete data (the plain version rounds 3 c1; the caller
                # masks them)
                same = torch.equal(k1[0][:cfg.n_real], p1[0][:cfg.n_real])
                if not same or (not complete
                                and not torch.equal(k1[0], p1[0])):
                    raise AssertionError("window_axpy differs from its plain "
                                         "version")
            r = rec[name]
            r["err"] = max(r["err"], err)
            if complete:
                r["ms"], r["plain_ms"] = kms, pms
                # packed rows plus vi in, 3 sums out; or packed rows plus
                # c1, c2 in, d eps out
                nbytes = window * nb + (16 * nb + 12 * window
                                        if name == "window_level_sums"
                                        else 8 * window + 16 * nb)
                r["bound_ms"], r["bound_by"] = bound(
                    nbytes, {"f32": ops_per * window * n_pad})
        # the rows-in-place route (BayesW --mega off): a shuffled window of
        # slots read where they lie, bit for bit its plain version and the
        # call on the same rows gathered
        slots = torch.randperm(m, generator=gen, device=dev)[:window]
        rows = slots.to(torch.int32)
        got = wk.window_level_sums(s.packed, vi, complete, rows)
        ref = wk.window_level_sums_ref(s.packed, vi, complete, rows)
        gat = wk.window_level_sums(s.packed[slots].contiguous(), vi,
                                   complete)
        got, ref, gat = ([t for t in x if t is not None]
                         for x in (got, ref, gat))
        err = max((a - b).abs().max().item() for a, b in zip(got, ref))
        same_ref = all(torch.equal(a, b) for a, b in zip(got, ref))
        same_gat = all(torch.equal(a, b) for a, b in zip(got, gat))
        print(f"window_level_sums W={window} {data:10s} rows in place: "
              f"max|diff| {err:.3e}  bitwise equal to plain {same_ref}, to "
              f"the gathered call {same_gat}  [{card}]", flush=True)
        if not (same_ref and same_gat):
            raise AssertionError("window_level_sums with rows differs from "
                                 "its plain version or the gathered call")
        rec["window_level_sums"]["err"] = max(
            rec["window_level_sums"]["err"], err)
        del s, args, vi
    return rec


def phase_bw_cli(torch, np, tmp):
    """The BayesW main path through the CLI, counted: the W=1 default and
    --window 64; then one CUDA sweep against the CPU sampler."""
    from hydra_tpu_torch import cli
    from hydra_tpu_torch.options import parse_args
    from hydra_tpu_torch.runner import dataset_from_options
    from hydra_tpu_torch.samplers.bayesw import (BayesW, state_from_numpy,
                                                 state_to_numpy)
    m, n, iters = 10_000, 5_000, 20
    base = os.path.join(tmp, "weibull_M10K_N_5K")
    write_plink(np, base, m, n, seed=4, weibull=True)
    common = ["--mpibayes", "bayesWMPI", "--bfile", base, "--pheno",
              base + ".phen", "--failure", base + ".fail", "--S",
              "0.0001,0.001,0.01", "--chain-length", str(iters), "--thin",
              "5", "--save", "10", "--seed", "7", "--mcmc-out-dir",
              os.path.join(tmp, "out")]
    reset_all_launches()
    t0 = time.perf_counter()
    rc = [cli.main(common + ["--mcmc-out-name", "bw_w1"])]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rc.append(cli.main(common + ["--mcmc-out-name", "bw_w64", "--window",
                                 "64"]))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = all_launches()
    print(f"main-path kernel launches: {json.dumps(launches)}; CLI wall "
          f"W=1 {t1 - t0:.1f} s, W=64 {t2 - t1:.1f} s ({iters} iterations "
          "each, data load included)", flush=True)
    if rc != [0, 0]:
        raise AssertionError(f"CLI exit codes {rc}")
    per_window = iters * (m + m // 64 + (m % 64 > 0))
    want = {"sweep_stale_bw": 2 * iters, "window_level_sums": per_window,
            "window_axpy": per_window, "sweep_stale": 0, "sweep_exact": 0}
    for name, count in want.items():
        if launches[name] != count:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"in the BayesW run, want {count}")
    for name in ("bw_w1", "bw_w64"):
        a = check_outputs(np, os.path.join(tmp, "out", name), m, 4,
                          survival=True)
        print(f"{name}: 4 thinned records, mean alpha over the last 2 = "
              f"{a:.3f} (simulated 8)", flush=True)

    # one W=64 sweep, CUDA sampler vs CPU sampler, same state and noise
    ds = dataset_from_options(parse_args(common + ["--window", "64"]))
    cpu = BayesW(ds, window=64, seed=7, device="cpu")
    gpu = BayesW(ds, window=64, seed=7, device="cuda")
    s_cpu = cpu.init_state()
    s_gpu = state_from_numpy(state_to_numpy(s_cpu), "cuda")
    g = torch.Generator().manual_seed(5)
    ml = cpu.cfg.m_loc
    noise = dict(u=torch.rand(ml, generator=g),
                 le=torch.empty(ml).exponential_(generator=g),
                 ub=torch.rand(ml, generator=g),
                 uu=torch.rand(ml, 24, generator=g),
                 wperm=torch.randperm(cpu.cfg.n_windows, generator=g))
    for k in ("mu", "alpha"):
        noise[k] = (torch.empty(()).exponential_(generator=g),
                    torch.rand((), generator=g), torch.rand(24, generator=g))
    a, _ = cpu.step(s_cpu, 0, noise=noise)
    b, _ = gpu.step(s_gpu, 0, noise=noise)
    a, b = state_to_numpy(a), state_to_numpy(b)
    d_eps = float(np.abs(a["eps"] - b["eps"]).max())
    d_beta = float(np.abs(a["beta"] - b["beta"]).max())
    n_comp = int((a["components"] != b["components"]).sum())
    print(f"one BayesW W=64 sweep, CUDA vs CPU sampler: max|d eps| "
          f"{d_eps:.3e}  max|d beta| {d_beta:.3e}  comp mismatches {n_comp}"
          f"  d mu {float(b['mu'] - a['mu']):.3e}  d alpha "
          f"{float(b['alpha'] - a['alpha']):.3e}", flush=True)
    np.testing.assert_allclose(b["eps"], a["eps"], atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(b["beta"], a["beta"], atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(b["mu"], a["mu"], rtol=1e-5)
    np.testing.assert_allclose(b["alpha"], a["alpha"], rtol=1e-5)
    if n_comp:
        raise AssertionError("component mismatches CUDA vs CPU sampler")
    return launches


def phase_bw_real_size(torch, np, card):
    """BayesW W=64 at M=100,000 x N=50,000 and W=1 at M=10,000 x N=5,000:
    ms/sweep, markers/s and where a sweep's time goes."""
    from hydra_tpu_torch.ops import sweep_kernel_bw as skbw
    for m, n, window, n_time in ((100_000, 50_000, 64, 10),
                                 (10_000, 5_000, 1, 3)):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        s = bw_sampler(torch, np, m, n, 2, window)
        torch.cuda.synchronize()
        print(f"BayesW M={m:,} x N={n:,}: data and sampler set up in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        st = s.init_state()
        for it in range(2):
            st, _ = s.step(st, it)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for it in range(2, 2 + n_time):
            st, stats = s.step(st, it)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n_time
        if not bool(torch.isfinite(st.eps).all()):
            raise AssertionError("non-finite residual at real size")
        print(f"real size BayesW M={m:,} x N={n:,} W={window} block: "
              f"{ms:.2f} ms/sweep, {m / ms * 1e3:,.0f} markers/s ({n_time} "
              f"sweeps after 2 warm-up), alpha {float(st.alpha):.3f}, m0 "
              f"{int(stats.m0.sum())}, peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB  [{card}]",
              flush=True)
        cfg = s.cfg
        alpha = st.alpha
        vi = torch.exp(alpha * st.eps - EULER_MASCHERONI) * s.ind_mask
        mrow = s.build_mrow(st, alpha, s.slot_noise(0))
        kw = dict(window=window, n_mix=cfg.k, complete=cfg.complete,
                  ind_mask=s.ind_mask, order=s.sweep_order(0))

        def run():
            return skbw.sweep_stale_bw(s.packed, st.eps, vi, mrow, s.gh_x,
                                       s.gh_w, alpha, **kw)

        profile_run(torch, run, f"BayesW W={window} M={m:,}",
                    cfg.n_windows * 3, card, cfg.n_windows)
        print_stream_bounds(window, s.packed.shape[1], cfg.n_windows,
                            stats=False, refresh=True)
        print_bw_bounds(window, s.packed.shape[1], mrow.shape[1],
                        cfg.complete, s.gh_x.shape[0], cfg.n_windows)
        del s, st, vi, mrow


def mt_phenotypes(np, n, n_traits, seed, na_frac=0.0):
    """(T, n) phenotypes with NaN for a fraction of each trait."""
    rs = np.random.RandomState(seed)
    ph = rs.randn(n_traits, n)
    ph[rs.random_sample(ph.shape) < na_frac] = np.nan
    return ph


def mt_kernel_rows(torch, mave, mstd, gen, n, pads, T, variances=MS[1:]):
    """Multi-trait mrow rows (sweep_kernel_mt.py column blocks of T) as the
    sampler builds them for sigmaE = sigmaG = 0.5: the single-trait rows of
    ``kernel_rows`` with per-trait beta_old, u and nrm."""
    from hydra_tpu_torch.ops.sweep_kernel_mt import mt_mrow_width
    per = [kernel_rows(torch, mave, mstd, gen, n, pads, variances)
           for _ in range(T)]
    out = torch.stack(per, dim=2).reshape(mave.shape[0], -1).contiguous()
    assert out.shape[1] == mt_mrow_width(len(variances) + 1, T)
    return out


def print_bound(name, r):
    print(f"{name:20s} recorded: kernel {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.6f} ms "
          f"({r['bound_by']})", flush=True)


def print_digests(torch, np):
    """SHA-256 of the outputs of the exact recurrences and the draws built
    on their device code, on fixed-seed inputs at phase 2c's shapes
    (M=4,096 x N=50,000, T=4 with full phenotypes; the recurrences at
    W=128, the stale sweep at W=64): sweep_exact_mt (eps, out), one window
    of mt_window_recurrence on a shared and on a per-trait Gram (10% NaN
    per trait), sweep_stale_mt, BayesRRm's sweep_exact, and with 2%
    missing genotypes and 10% NaN per trait sweep_stale_mt, window_stats_mt
    and window_axpy_mt; then BayesW's sweep_stale_bw (eps, out) at phase
    2b's cases (bw_case: M=4,096 W=64 complete and 2% missing, M=512 W=1);
    then the BayesRRm stale sweeps (stale_digest_outputs), the exact
    sweep and window_stats on missing genotypes (missing_exact_digest_outputs,
    the exact sweep also at M=16,384, the real-size sweeps' Gram tile) and
    the per-window branch's window_gibbs, window_axpy, one --mega off
    exact sweep, the planes kernels and one --cache-planes on sweep
    (window_branch_digest_outputs).
    Two trees' kernels are bit for bit the same where their digests are
    (scripts/chip_compare.py runs this in each tree). Returns {name:
    digest}."""
    from hydra_tpu_torch.ops import sweep_kernel as sk
    from hydra_tpu_torch.ops import sweep_kernel_bw as skbw
    from hydra_tpu_torch.ops import sweep_kernel_mt as skmt
    from hydra_tpu_torch.ops import window_kernels as wk
    from hydra_tpu_torch.ops.decode import decode_planes_hp
    dev = torch.device("cuda")
    m, n, T, W = 4096, 50_000, 4, 128
    n_pad = padded_individuals(np, n)
    gen = torch.Generator(device=dev).manual_seed(17)
    pk, mave, mstd, _ = device_genotypes(torch, m, n, n_pad, gen)
    pads = torch.randperm(m, generator=gen, device=dev)[:37]
    pk[pads] = 0xFF
    mrow = mt_kernel_rows(torch, mave, mstd, gen, n, pads, T)
    tm = torch.zeros((n_pad, T), device=dev)
    tm[:n] = 1.0
    eps = 0.8 * torch.randn((n_pad, T), generator=gen, device=dev) * tm
    i2se = torch.full((T,), 1.0 / (2 * SIGMA_E), device=dev)
    dnm1 = tm.sum(dim=0) - 1.0
    order = sk.block_order(torch.randperm(m // W, generator=gen, device=dev),
                           W)
    outs = {"sweep_exact_mt W=128": skmt.sweep_exact_mt(
        pk, eps, tm, mrow, i2se, dnm1, window=W, n_mix=K, order=order)}
    rows = order[:W].contiguous()
    slots = rows.long()
    b = mrow[slots].reshape(W, -1, T)
    s1, _ = wk.window_stats_mt(pk, eps, True, rows)
    num0 = (b[:, 1] * (s1 - b[:, 0] * eps.sum(dim=0)) + b[:, 2] * dnm1
            ).contiguous()
    g, mk = decode_planes_hp(pk[slots])
    xt = (g - b[:, 0, :1] * mk) * b[:, 1, :1]
    nan = (torch.rand((n_pad, T), generator=gen, device=dev) >= 0.1) * tm
    for label, gram in (("shared", xt @ xt.T), ("per-trait", torch.bmm(
            xt[None] * nan.T[:, None, :],
            xt[None].expand(T, -1, -1).transpose(1, 2)))):
        outs[f"mt_window_recurrence W=128 {label} Gram"] = (
            skmt.mt_window_recurrence(gram, num0, mrow, i2se, n_mix=K,
                                      rows=rows))
    del g, mk, xt
    order64 = sk.block_order(torch.randperm(m // 64, generator=gen,
                                            device=dev), 64)
    outs["sweep_stale_mt W=64"] = skmt.sweep_stale_mt(
        pk, eps, tm, mrow, i2se, dnm1, window=64, n_mix=K, complete=True,
        order=order64)
    rows1 = kernel_rows(torch, mave, mstd, gen, n, pads)
    outs["sweep_exact W=128"] = sk.sweep_exact(
        pk, eps[:, 0].contiguous(), rows1, 1.0 / (2 * SIGMA_E),
        float(n - 1), window=W, n_mix=K, complete=True,
        ind_mask=tm[:, 0].contiguous(), order=order)
    # the packed passes' missing-genotype modes: 2% missing genotypes, 10%
    # NaN per trait, through the stale sweep and the per-window passes
    pk, mave, mstd, _ = device_genotypes(torch, m, n, n_pad, gen, 0.02)
    pk[pads] = 0xFF
    mrow = mt_kernel_rows(torch, mave, mstd, gen, n, pads, T)
    tm = torch.zeros((n_pad, T), device=dev)
    tm[:n] = (torch.rand((n, T), generator=gen, device=dev) >= 0.1).float()
    eps = 0.8 * torch.randn((n_pad, T), generator=gen, device=dev) * tm
    data = "missing 2%, NaN 10%"
    outs[f"sweep_stale_mt W=64 {data}"] = skmt.sweep_stale_mt(
        pk, eps, tm, mrow, i2se, tm.sum(dim=0) - 1.0, window=64, n_mix=K,
        complete=False, order=order64)
    outs[f"window_stats_mt W=128 {data}"] = wk.window_stats_mt(
        pk, eps, False, rows)
    c1 = 0.01 * torch.randn((T, W), generator=gen, device=dev)
    outs[f"window_axpy_mt W=128 {data}"] = (wk.window_axpy_mt(
        pk, c1, -c1 * mave[slots][None, :], False, rows),)
    for m_bw, w_bw, missing in BW_CASES:
        _, args, kw, _, _ = bw_case(torch, np, m_bw, w_bw, missing)
        data = "missing 2%" if missing else "complete"
        outs[f"sweep_stale_bw M={m_bw} W={w_bw} {data}"] = (
            skbw.sweep_stale_bw(*args, **kw))
    outs.update(stale_digest_outputs(torch, np))
    outs.update(missing_exact_digest_outputs(torch, np))
    outs.update(window_branch_digest_outputs(torch, np))
    torch.cuda.synchronize()
    digests = {}
    for name, tensors in outs.items():
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.contiguous().cpu().numpy().tobytes())
        digests[name] = h.hexdigest()
        print(f"digest {name}: sha256 {digests[name]}", flush=True)
    return digests


def stale_digest_outputs(torch, np):
    """The BayesRRm stale sweeps' (eps, out) on fixed-seed inputs at
    M=4,096 x N=50,000 (its own generator, so the digests before it keep
    their inputs): sweep_stale at W=64 complete and with 2% missing
    genotypes, at W=512, and at W=1 on the first 512 markers;
    sweep_stale_sd at W=64, sub-window 16. Returns {name: (eps, out)}."""
    from hydra_tpu_torch.ops import sweep_kernel as sk
    dev = torch.device("cuda")
    m, n = 4096, 50_000
    n_pad = padded_individuals(np, n)
    outs = {}
    for missing in (0.0, 0.02):
        gen = torch.Generator(device=dev).manual_seed(29)
        pk, mave, mstd, _ = device_genotypes(torch, m, n, n_pad, gen, missing)
        pads = torch.randperm(m, generator=gen, device=dev)[:37]
        pk[pads] = 0xFF
        mrow = kernel_rows(torch, mave, mstd, gen, n, pads)
        eps = 0.8 * torch.randn(n_pad, generator=gen, device=dev)
        eps[n:] = 0.0
        mask = torch.zeros(n_pad, device=dev)
        mask[:n] = 1.0
        complete = not missing
        data = "complete" if complete else "missing 2%"
        args = (1.0 / (2 * SIGMA_E), float(n - 1))
        cases = ((64, m, 0), (512, m, 0), (1, 512, 0), (64, m, 16)) if complete \
            else ((64, m, 0),)
        for W, mw, wt in cases:
            order = sk.block_order(torch.randperm(mw // W, generator=gen,
                                                  device=dev), W)
            kw = dict(window=W, n_mix=K, complete=complete,
                      ind_mask=mask if complete else None, order=order)
            ins = (pk[:mw], eps, mrow[:mw].contiguous()) + args
            if wt:
                outs[f"sweep_stale_sd M={mw} W={W} Wt={wt} {data}"] = (
                    sk.sweep_stale_sd(*ins, sub_window=wt, **kw))
            else:
                outs[f"sweep_stale M={mw} W={W} {data}"] = sk.sweep_stale(
                    *ins, **kw)
    return outs


def missing_exact_digest_outputs(torch, np):
    """The missing-data Gram's callers on fixed-seed inputs at phase 2's
    shapes (M=4,096 x N=50,000, 2% missing calls, 37 pad markers; its own
    generator): sweep_exact (eps, out) at W=128 and W=64 (the CLI
    default), block order, and window_stats' exact Gram of the W=128
    sweep's first window; then sweep_exact at W=128 and W=64 on M=16,384
    (its own generator, 147 pad markers), where a batch of Grams has
    enough windows for the 64-row tile the real-size sweeps take (128
    windows of three tiles, 256 of one; M=4,096 takes the 32- and 16-row
    tiles). Returns {name: tensors}."""
    from hydra_tpu_torch.ops import sweep_kernel as sk
    from hydra_tpu_torch.ops import window_kernels as wk
    dev = torch.device("cuda")
    m, n = 4096, 50_000
    n_pad = padded_individuals(np, n)
    gen = torch.Generator(device=dev).manual_seed(47)
    pk, mave, mstd, _ = device_genotypes(torch, m, n, n_pad, gen, 0.02)
    pads = torch.randperm(m, generator=gen, device=dev)[:37]
    pk[pads] = 0xFF
    mrow = kernel_rows(torch, mave, mstd, gen, n, pads)
    eps = 0.8 * torch.randn(n_pad, generator=gen, device=dev)
    eps[n:] = 0.0
    outs = {}
    for W in (128, 64):
        order = sk.block_order(torch.randperm(m // W, generator=gen,
                                              device=dev), W)
        outs[f"sweep_exact W={W} missing 2%"] = sk.sweep_exact(
            pk, eps, mrow, 1.0 / (2 * SIGMA_E), float(n - 1), window=W,
            n_mix=K, complete=False, order=order)
        if W == 128:
            rows = order[:W].contiguous()
            b = mrow[rows.long()]
            outs["window_stats W=128 exact missing 2%"] = (wk.window_stats(
                pk, eps, b[:, 0].contiguous(), b[:, 1].contiguous(), True,
                False, float(n), rows)[2],)
    m = 16_384
    gen = torch.Generator(device=dev).manual_seed(59)
    pk, mave, mstd, _ = device_genotypes(torch, m, n, n_pad, gen, 0.02)
    pads = torch.randperm(m, generator=gen, device=dev)[:147]
    pk[pads] = 0xFF
    mrow = kernel_rows(torch, mave, mstd, gen, n, pads)
    for W in (128, 64):
        order = sk.block_order(torch.randperm(m // W, generator=gen,
                                              device=dev), W)
        outs[f"sweep_exact M={m} W={W} missing 2%"] = sk.sweep_exact(
            pk, eps, mrow, 1.0 / (2 * SIGMA_E), float(n - 1), window=W,
            n_mix=K, complete=False, order=order)
    return outs


def gibbs_inputs(torch, W, k, gen):
    """window_gibbs' inputs for a window of W markers and k mixture
    components, made on the card from ``gen``: a correlation-like Gram x
    x^T / 512, num0 of 30 units, the draw's constants in the ranges of
    kernel_rows' and 10% inactive markers. Returns the wrapper's
    arguments."""
    dev = gen.device
    x = torch.randn(W, 512, generator=gen, device=dev)
    gram = x @ x.T / 512
    num0 = 30.0 * torch.randn(W, generator=gen, device=dev)
    p = 0.05 + torch.rand(W, k, generator=gen, device=dev)
    logl = torch.log(p / p.sum(1, keepdim=True))
    invd = 8e-4 + 4e-4 * torch.rand(W, k - 1, generator=gen, device=dev)
    sd = 0.02 + 0.02 * torch.rand(W, k - 1, generator=gen, device=dev)
    u = torch.rand(W, generator=gen, device=dev)
    nrm = torch.randn(W, generator=gen, device=dev)
    act = (torch.rand(W, generator=gen, device=dev) >= 0.1).float()
    bold = 0.02 * torch.randn(W, generator=gen, device=dev) * act
    i2se = torch.tensor(1.0 / (2 * SIGMA_E), device=dev)
    return [gram, num0, logl, invd, sd, u, nrm, act, bold, i2se]


def window_branch_digest_outputs(torch, np):
    """The per-window branch's kernels on fixed-seed inputs (each its own
    generator): window_gibbs at W=64, 128 and 1024 with K=4 and 6
    (gibbs_inputs); window_axpy at W=64 on 2% missing genotypes and on
    complete ones (M=4,096 x N=50,000, shuffled rows), the complete one
    held here bit for bit to window_axpy_ref on the real individuals (its
    constant 2 sum(c1) is summed in window order, so its digest differs
    from a tree that sums c1 in torch's reduction order); and one --mega
    off exact sweep (window_sweep, W=128, marker order) on M=4,096 x
    N=50,000 with 2% missing calls, which takes no complete-data
    constant; then window_stats_planes and window_axpy_planes
    at W=8, 64 and 1024 on shuffled rows of complete M=4,096 x N=50,000
    planes, and one --cache-planes on sweep (stale W=64, marker order) on
    complete genotypes of the same size. Returns {name: tensors}."""
    from hydra_tpu_torch.ops import gibbs_kernel as gk
    from hydra_tpu_torch.ops import planes as tpl
    from hydra_tpu_torch.ops import window_kernels as wk
    from hydra_tpu_torch.samplers.bayesrrm import BayesRRm
    dev = torch.device("cuda")
    outs = {}
    for W in (64, 128, 1024):
        for k in (4, 6):
            gen = torch.Generator(device=dev).manual_seed(61 + W + k)
            outs[f"window_gibbs W={W} K={k}"] = gk.window_gibbs(
                *gibbs_inputs(torch, W, k, gen))
    m, n, W = 4096, 50_000, 64
    n_pad = padded_individuals(np, n)
    for missing in (0.02, 0.0):
        gen = torch.Generator(device=dev).manual_seed(67)
        pk, mave, mstd, _ = device_genotypes(torch, m, n, n_pad, gen, missing)
        rows = torch.randperm(m, generator=gen, device=dev)[:W].to(
            torch.int32)
        c1 = 0.01 * torch.randn(W, generator=gen, device=dev)
        c2 = -c1 * mave[rows.long()]
        d = wk.window_axpy(pk, c1, c2, not missing, rows)
        if missing:
            outs[f"window_axpy W={W} missing 2%"] = (d,)
            continue
        ref = wk.window_axpy_ref(pk, c1, c2, True, rows)
        if not torch.equal(d[:n], ref[:n]):
            raise AssertionError("window_axpy (complete) differs from "
                                 "window_axpy_ref")
        print("window_axpy W=64 complete: bit for bit window_axpy_ref on "
              "the real individuals; its digest depends on the order of "
              "the constant's sum (window order here)", flush=True)
        outs[f"window_axpy W={W} complete, 2 sum(c1) in window order"] = (d,)
    del pk
    ds, pk = real_size_dataset(torch, np, 0.02, m=m, seed=71)
    s = BayesRRm(ds, window=128, exact=True, seed=1, device=dev, mega="off",
                 packed_device=pk)
    if not s.cfg.per_window or s.cfg.complete:
        raise AssertionError("the digest's sampler must take the per-window "
                             "branch on missing genotypes")
    st = s.init_state()
    gen = torch.Generator(device=dev).manual_seed(73)
    active = (st.sigma_g[s.groups] > 0) & (s.valid > 0) & (s.mstd > 0)
    mrow = s.build_mrow(st, torch.rand(m, generator=gen, device=dev),
                        torch.randn(m, generator=gen, device=dev), active)
    outs["window_sweep --mega off exact W=128 missing 2%"] = s.window_sweep(
        st.eps, mrow, s.sweep_order(0), 0.5 / st.sigma_e)
    del s, st, pk
    gen = torch.Generator(device=dev).manual_seed(83)
    pk, _, _, _ = device_genotypes(torch, m, n, n_pad, gen)
    planes = tpl.build_planes(pk)
    del pk
    eps = 0.8 * torch.randn(n_pad, generator=gen, device=dev)
    eps[n:] = 0.0
    for W in (8, 64, 1024):
        rows = torch.randperm(m, generator=gen, device=dev)[:W].to(
            torch.int32)
        c1 = 0.05 * torch.randn(W, generator=gen, device=dev)
        outs[f"window_stats_planes W={W}"] = (
            tpl.window_stats_planes(planes, eps, rows),)
        outs[f"window_axpy_planes W={W}"] = (
            tpl.window_axpy_planes(planes, c1, rows),)
    del planes
    ds, pk = real_size_dataset(torch, np, 0.0, m=m, seed=89)
    s = BayesRRm(ds, window=64, exact=False, seed=1, device=dev,
                 plane_cache="on", packed_device=pk)
    if not (s.cfg.per_window and s.cfg.planes
            and s.cfg.schedule == "marker"):
        raise AssertionError("the digest's sampler must take the planes "
                             "branch on the marker schedule")
    st = s.init_state()
    gen = torch.Generator(device=dev).manual_seed(91)
    active = (st.sigma_g[s.groups] > 0) & (s.valid > 0) & (s.mstd > 0)
    mrow = s.build_mrow(st, torch.rand(m, generator=gen, device=dev),
                        torch.randn(m, generator=gen, device=dev), active)
    outs["window_sweep --cache-planes on stale W=64"] = s.window_sweep(
        st.eps, mrow, s.sweep_order(0), 0.5 / st.sigma_e)
    return outs


def print_missing_exact_times(torch, np, card):
    """BayesRRm's exact sweep on missing genotypes at M=100,000 x
    N=50,000 with 2% missing calls (real_size_dataset): exact W=128 and
    W=64 (the CLI default) block, ms/sweep, CUDA events, busy share,
    launches and device us a window by kernel (real_size_sweeps), then the
    Gram's device us a window, summed over the kernels whose name holds
    "gram"; then the Gram alone at W = 64, 128, 256 and 1024: window_stats'
    exact missing-data Gram (one window a call), and, where the tree has
    window_grams, the exact sweep's batched Grams of all M / W windows of
    a random order (gram_batch_windows a launch), device us a window by
    kernel from torch.profiler over 10 calls after a warm-up (3 at
    W = 1024), beside its bound (missing_gram_bound).
    scripts/chip_compare.py runs this tree's version in every tree."""
    from hydra_tpu_torch.ops import sweep_kernel as sk
    from hydra_tpu_torch.ops import window_kernels as wk
    dev = torch.device("cuda")
    ds, pk = real_size_dataset(torch, np, 0.02)
    m, n, nb = ds.geno.m, ds.geno.n, pk.shape[1]
    for window in (128, 64):
        per = real_size_sweeps(torch, sk, ds, pk, True, window, card,
                               " missing 2%")
        n_windows = -(-m // window)
        gram = {k: v for k, v in per.items()
                if "hydra::" in k and "gram" in kernel_name(k)}
        print(f"missing exact W={window}: the Gram "
              f"{1e3 * sum(v[1] for v in gram.values()) / n_windows:.2f} us a "
              f"window ({', '.join(sorted(kernel_name(k) for k in gram))}; "
              f"{sum(v[0] for v in gram.values())} launches a sweep of "
              f"{n_windows} windows)  [{card}]", flush=True)
    gen = torch.Generator(device=dev).manual_seed(43)
    eps = 0.8 * torch.randn(4 * nb, generator=gen, device=dev)
    eps[n:] = 0.0
    mave = torch.from_numpy(ds.geno.mave).float().to(dev)
    mstd = torch.from_numpy(ds.geno.mstd).float().to(dev)
    calls = 10
    for W in (64, 128, 256, 1024):
        rows = torch.randperm(m, generator=gen, device=dev)[:W].to(
            torch.int32)
        mw, sw = mave[rows.long()], mstd[rows.long()]

        def gram():
            return wk.window_stats(pk, eps, mw, sw, True, False, float(n),
                                   rows)

        gram()
        per = _profile_retry(torch, lambda: [gram() for _ in range(calls)],
                             f"missing gram W={W}")
        got = ("not measured" if per is None else ", ".join(
            f"{kernel_name(k)} {1e3 * v[1] / calls:.2f} us"
            for k, v in sorted(per.items())
            if "hydra::" in k and "gram" in kernel_name(k)))
        b_ms, b_by = missing_gram_bound(W, nb)
        print(f"missing gram W={W} N={n}: {got} a window; bound "
              f"{1e3 * b_ms:.4f} us ({b_by})  [{card}]", flush=True)
        if not hasattr(wk, "window_grams"):
            continue
        n_win = m // W
        order = torch.randperm(m, generator=gen, device=dev)[:n_win * W].to(
            torch.int32)
        reps = 3 if W == 1024 else calls

        def grams():
            return wk.window_grams(pk, order, W, mave, mstd)

        grams()
        per = _profile_retry(torch, lambda: [grams() for _ in range(reps)],
                             f"missing grams W={W}")
        got = ("not measured" if per is None else ", ".join(
            f"{kernel_name(k)} {1e3 * v[1] / (reps * n_win):.2f} us "
            f"({v[0] // reps} launches)"
            for k, v in sorted(per.items())
            if "hydra::" in k and "gram" in kernel_name(k)))
        b_ms, b_by = missing_gram_bound(W, nb, n_win)
        print(f"missing gram batch W={W} N={n}: {got} a window of "
              f"{n_win}; bound {1e3 * b_ms:.4f} us ({b_by})  [{card}]",
              flush=True)
    del ds, pk


def phase_mt_kernels(torch, np, card):
    """The multi-trait kernels against their plain versions at main-path
    shapes (M=4,096 x N=50,000, T=4): sweep_stale_mt W=64 and W=128 (the
    draw folded into the axpy, and in its own launch) and sweep_exact_mt
    W=128 on complete data with full phenotypes, sweep_stale_mt W=64 and
    W=128 with 2% missing genotypes and 10% NaN per trait; the
    per-window kernels at W=128 with and without NaN."""
    from hydra_tpu_torch.ops import sweep_kernel_mt as skmt
    from hydra_tpu_torch.ops import window_kernels as wk
    from hydra_tpu_torch.ops.decode import decode_h, decode_planes_hp
    from hydra_tpu_torch.ops.sweep_kernel import block_order
    dev = torch.device("cuda")
    m, n, T = 4096, 50_000, 4
    n_pad = padded_individuals(np, n)
    nb = n_pad // 4
    rec = {k: dict(err=0.0) for k in ("sweep_stale_mt", "sweep_exact_mt",
                                      "window_stats_mt", "window_axpy_mt",
                                      "mt_window_recurrence")}
    i2se = torch.full((T,), 1.0 / (2 * SIGMA_E), device=dev)
    tol = [(1e-3, 5e-4)] * 4

    def compare(name, label, fn, ref, reps, comp_of=None):
        return compare_outputs(torch, name, label, fn, ref, reps, tol, card,
                               rec, comp_of)

    for missing, na_frac in ((0.0, 0.0), (0.02, 0.1), (0.0, 0.1)):
        gen = torch.Generator(device=dev).manual_seed(13)
        pk, mave, mstd, _ = device_genotypes(torch, m, n, n_pad, gen, missing)
        pads = torch.randperm(m, generator=gen, device=dev)[:37]
        pk[pads] = 0xFF
        mrow = mt_kernel_rows(torch, mave, mstd, gen, n, pads, T)
        tm = torch.zeros((n_pad, T), device=dev)
        tm[:n] = (torch.rand((n, T), generator=gen, device=dev)
                  >= na_frac).float()
        eps = 0.8 * torch.randn((n_pad, T), generator=gen, device=dev) * tm
        dnm1 = tm.sum(dim=0) - 1.0
        data = (f"{'missing 2%' if missing else 'complete'}"
                f"{', NaN 10%' if na_frac else ''}")
        full = na_frac == 0.0
        # sweep_stale_mt also at W=128, where the draw keeps its own launch
        # (stale_draw_mt_kernel, above the kernels' MT_FOLD_MAX_W = 64); its
        # order from a generator of its own, so the draws after it stay
        sweeps = [("sweep_stale_mt", 64)] + ([("sweep_exact_mt", 128)]
                                             if full and not missing else [])
        if missing or full:
            for name, window in sweeps + [("sweep_stale_mt", 128)]:
                side = (name, window) == ("sweep_stale_mt", 128)
                order = block_order(torch.randperm(
                    m // window, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(17)
                    if side else gen), window)
                kw = dict(window=window, n_mix=K, order=order)
                if name == "sweep_stale_mt":
                    fn, ref = skmt.sweep_stale_mt, skmt.sweep_stale_mt_ref
                    kw["complete"] = not missing
                else:
                    fn, ref = skmt.sweep_exact_mt, skmt.sweep_exact_mt_ref
                ms, plain_ms = compare(
                    name, f"W={window} {data}",
                    lambda: fn(pk, eps, tm, mrow, i2se, dnm1, **kw),
                    lambda: ref(pk, eps, tm, mrow, i2se, dnm1, **kw), 5,
                    comp_of=lambda o: o[1][:, T:2 * T])
                e_k, o_k = fn(pk, eps, tm, mrow, i2se, dnm1, **kw)
                check_mt_bitwise("axpy_mt_kernel", f"{name} W={window} {data}",
                                 torch.equal(e_k, wk.sweep_update_mt_ref(
                                     pk, eps, tm, mrow, o_k, kw["order"],
                                     window, not missing)), card)
                if name == "sweep_stale_mt":
                    # either side of the fold threshold
                    check_stale_launches(
                        torch, f"{name} W={window} {data}",
                        lambda: fn(pk, eps, tm, mrow, i2se, dnm1, **kw),
                        "stale_draw_mt_kernel", side, card)
                else:
                    check_gram_launches(
                        torch, f"{name} W={window} {data}",
                        lambda: fn(pk, eps, tm, mrow, i2se, dnm1, **kw),
                        m // window, window, False, card)
                if full and not side:
                    r = rec[name]
                    r["ms"], r["plain_ms"] = ms, plain_ms
                    # packed rows, eps, tm, mrow, order in; eps, out out.
                    # Ops: s1 and the axpy, one FMA each per genotype and
                    # trait; the symmetric exact Gram adds (W + 1) / 2 int8
                    # multiply-adds per genotype (shared by the traits)
                    nbytes = (pk.numel() + 3 * 4 * T * n_pad
                              + mrow.numel() * 4 + 4 * m + 12 * T * m)
                    ops = {"f32": 4.0 * T * m * n_pad}
                    if name == "sweep_exact_mt":
                        ops["int8"] = (window + 1.0) * m * n_pad
                    r["bound_ms"], r["bound_by"] = bound(nbytes, ops)
                    print_bound(name, r)
        # the per-window kernels on one window of W=128 rows: bit for bit
        # their plain versions in the kernels' order (complete data: but the pad rows' and pad individuals' h = 3
        # products, which the plain versions round and the kernels fuse)
        W = 128
        rows = torch.randperm(m, generator=gen, device=dev)[:W].to(
            torch.int32)
        slots = rows.long()
        c1 = 0.01 * torch.randn((T, W), generator=gen, device=dev)
        c2 = -c1 * mave[slots][None, :]
        real = ~torch.isin(slots, pads)
        c1b = c1 * real                        # pad rows: mstd = 0, c1 = 0
        c2b = -c1b * mave[slots][None, :]
        complete = not missing
        keep = real if complete else slice(None)
        check_mt_bitwise("stats_mt_kernel", f"window_stats_mt W={W} {data}",
                         all(torch.equal(a[keep], b[keep]) for a, b in zip(
                             wk.window_stats_mt(pk, eps, complete, rows),
                             wk.window_stats_mt_seq(pk, eps, complete, rows))
                             if b is not None), card)
        ind = slice(None, n) if complete else slice(None)
        check_mt_bitwise("axpy_mt_kernel", f"window_axpy_mt W={W} {data}",
                         torch.equal(
                             wk.window_axpy_mt(pk, c1b, c2b, complete,
                                               rows)[ind],
                             wk.window_axpy_mt_seq(pk, c1b, c2b, complete,
                                                   rows)[ind]), card)
        if missing:
            continue
        # the same window against the matmul plain versions
        compare("window_stats_mt", f"W={W} {data}",
                lambda: wk.window_stats_mt(pk, eps, True, rows),
                lambda: wk.window_stats_mt_ref(pk, eps, True, rows), 20)
        compare("window_axpy_mt", f"W={W} {data}",
                lambda: (wk.window_axpy_mt(pk, c1, c2, True, rows),),
                lambda: (wk.window_axpy_mt_ref(pk, c1, c2, True, rows),), 20)
        # a real window: num0 from the stats, the standardized Gram of the
        # decoded rows ((W, W) shared without NaN, (T, W, W) masked with)
        b = mrow[slots].reshape(W, -1, T)
        s1, _ = wk.window_stats_mt(pk, eps, True, rows)
        num0 = (b[:, 1] * (s1 - b[:, 0] * eps.sum(dim=0)) + b[:, 2] * dnm1
                ).contiguous()
        g, mk = decode_planes_hp(pk[slots])
        xt = (g - b[:, 0, :1] * mk) * b[:, 1, :1]
        gram = (xt @ xt.T if full else
                torch.bmm(xt[None] * tm.T[:, None, :],
                          xt[None].expand(T, -1, -1).transpose(1, 2)))
        del g, mk, xt
        ms, plain_ms = compare(
            "mt_window_recurrence", f"W={W} {'shared' if full else 'per-trait'}"
            " Gram", lambda: skmt.mt_window_recurrence(
                gram, num0, mrow, i2se, n_mix=K, rows=rows),
            lambda: skmt.mt_window_recurrence_ref(
                gram, num0, mrow, i2se, n_mix=K, rows=rows), 20,
            comp_of=lambda o: o[1])
        if full:
            continue
        # branch-3 shapes (complete genotypes, NaN): the recorded times
        for name, fn, ref, nbytes, ops in (
                ("window_stats_mt",
                 lambda: wk.window_stats_mt(pk, eps, True, rows),
                 lambda: wk.window_stats_mt_ref(pk, eps, True, rows),
                 W * nb + 4 * T * n_pad + 4 * W + 8 * W * T,
                 {"f32": 2.0 * T * W * n_pad}),
                ("window_axpy_mt",
                 lambda: (wk.window_axpy_mt(pk, c1, c2, True, rows),),
                 lambda: (wk.window_axpy_mt_ref(pk, c1, c2, True, rows),),
                 W * nb + 4 * W + 8 * T * W + 4 * T * n_pad,
                 {"f32": 2.0 * T * W * n_pad}),
                ("mt_window_recurrence",
                 lambda: skmt.mt_window_recurrence(
                     gram, num0, mrow, i2se, n_mix=K, rows=rows),
                 lambda: skmt.mt_window_recurrence_ref(
                     gram, num0, mrow, i2se, n_mix=K, rows=rows),
                 gram.numel() * 4 + 4 * W * T + b.numel() * 4 + 16 * W * T,
                 # the rank-1 update per step and trait; ~100 ops per draw
                 {"f32": 2.0 * T * W * W + 100.0 * W * T})):
            r = rec[name]
            if name == "mt_window_recurrence":
                r["ms"], r["plain_ms"] = ms, plain_ms
            else:
                fn()
                r["ms"], _ = cuda_ms(torch, fn, 20)
                ref()
                r["plain_ms"], _ = cuda_ms(torch, ref, 1)
            r["bound_ms"], r["bound_by"] = bound(nbytes, ops)
            print_bound(name, r)
        # the library's yardstick: one torch.mm of the window's rows,
        # decoded to f32 before timing, against eps (n_pad, T) or c1; the
        # same 20 calls as device time alone (the CUDA-event times include
        # the host's enqueue of each call)
        hw = decode_h(pk[slots])
        for name, fn, lib in (
                ("window_stats_mt",
                 lambda: wk.window_stats_mt(pk, eps, True, rows),
                 lambda: torch.mm(hw, eps)),
                ("window_axpy_mt",
                 lambda: wk.window_axpy_mt(pk, c1, c2, True, rows),
                 lambda: torch.mm(hw.t(), c1.t()))):
            r = rec[name]
            lib()
            r["library_ms"], _ = cuda_ms(torch, lib, 20)
            for key, f in (("device_ms", fn), ("library_device_ms", lib)):
                per = device_times(torch, lambda: [f() for _ in range(20)],
                                   name)
                r[key] = sum(v[1] for v in per.values()) / 20
            print(f"{name:19s} library torch.mm on the decoded rows "
                  f"{r['library_ms']:.4f} ms; device time per call: kernel "
                  f"{r['device_ms']:.4f} ms, library "
                  f"{r['library_device_ms']:.4f} ms  [{card}]", flush=True)
        del pk, mrow, eps, tm, gram, hw
    print_digests(torch, np)
    return rec


def write_mt_phenos(np, base, m, n, n_traits, seed, na_frac=0.0):
    """T phenotype files next to a .bed written by ``write_plink``: each
    trait h2 = 0.5 over its own 1% causal markers, "NA" for a fraction
    ``na_frac`` of individuals per trait. Returns the comma-joined paths."""
    from hydra_tpu_torch.io.plink import decode_bed_numpy, read_bed
    rs = np.random.RandomState(seed)
    g, _ = decode_bed_numpy(read_bed(base + ".bed", n, m), n)
    paths = []
    for t in range(n_traits):
        causal = rs.choice(m, m // 100, replace=False)
        x = g[causal]
        x = (x - x.mean(1, keepdims=True)) / x.std(1, keepdims=True)
        y = (x.T @ (rs.randn(len(causal)) * np.sqrt(0.5 / len(causal)))
             + rs.randn(n) * np.sqrt(0.5))
        path = f"{base}.t{t}{'_na' if na_frac else ''}.phen"
        with open(path, "w") as fh:
            fh.writelines(
                f"f{i} i{i} {'NA' if rs.rand() < na_frac else f'{y[i]:.8f}'}\n"
                for i in range(n))
        paths.append(path)
    return ",".join(paths)


def phase_mt_cli(torch, np, tmp):
    """The multi-trait main path through the CLI, counted, at M=10,000 x
    N=5,000 with T=4: exact with full phenotypes (sweep_exact_mt), --stale
    --window 64 (sweep_stale_mt) and exact with 10% NaN per trait (the
    per-window path); then one CUDA sweep of each branch against the CPU
    sampler with identical state and noise."""
    from hydra_tpu_torch import cli
    from hydra_tpu_torch.options import parse_args
    from hydra_tpu_torch.runner import mt_dataset_from_options
    from hydra_tpu_torch.samplers.bayesrrm_mt import (BayesRRmMT,
                                                      state_from_numpy,
                                                      state_to_numpy)
    m, n, T, iters = 10_000, 5_000, 4, 40
    base = os.path.join(tmp, "mt_M10K_N_5K")
    write_plink(np, base, m, n, seed=5)
    full = write_mt_phenos(np, base, m, n, T, seed=6)
    nan = write_mt_phenos(np, base, m, n, T, seed=7, na_frac=0.1)

    def argv(phen, name, *extra):
        return ["--mpibayes", "bayesMPI", "--bfile", base, "--pheno", phen,
                "--S", "0.0001,0.001,0.01", "--chain-length", str(iters),
                "--thin", "5", "--save", "10", "--seed", "7",
                "--mcmc-out-dir", os.path.join(tmp, "out"),
                "--mcmc-out-name", name, *extra]

    runs = (("mt_exact", full, ()), ("mt_stale", full,
                                     ("--stale", "--window", "64")),
            ("mt_nan", nan, ()))
    reset_all_launches()
    rc, wall = [], []
    for name, phen, extra in runs:
        t0 = time.perf_counter()
        rc.append(cli.main(argv(phen, name, *extra)))
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    launches = all_launches()
    print(f"main-path kernel launches: {json.dumps(launches)}; CLI wall "
          + ", ".join(f"{r[0]} {w:.1f} s" for r, w in zip(runs, wall))
          + f" ({iters} iterations each, data load included)", flush=True)
    if rc != [0, 0, 0]:
        raise AssertionError(f"CLI exit codes {rc}")
    n_win = -(-m // 64)
    want = {"sweep_exact_mt": iters, "sweep_stale_mt": iters,
            "window_stats_mt": iters * n_win, "window_axpy_mt": iters * n_win,
            "mt_window_recurrence": iters * n_win}
    for name, count in want.items():
        if launches[name] != count:
            raise AssertionError(f"{name} launched {launches[name]} times in "
                                 f"the multi-trait run, want {count}")
    for name, _, _ in runs:
        h2 = [check_outputs(np, os.path.join(tmp, "out", f"{name}.t{t}"), m,
                            iters // 5) for t in range(T)]
        print(f"{name}: .t0-.t3 with {iters // 5} thinned records each; mean "
              f"h2 over the last {iters // 10} per trait "
              f"{[round(v, 4) for v in h2]} (simulated 0.5)", flush=True)
        if not all(abs(v - 0.5) < 0.25 for v in h2):
            raise AssertionError(f"{name}: posterior h2 {h2} far from 0.5")

    # one sweep of each branch, CUDA sampler vs CPU sampler
    for name, phen, extra in runs:
        opt = parse_args(argv(phen, name, *extra))
        ds, phenos = mt_dataset_from_options(opt)
        window, exact = opt.window, opt.exact
        cpu = BayesRRmMT(ds, phenos, window=window, exact=exact, seed=7,
                         device="cpu")
        gpu = BayesRRmMT(ds, phenos, window=window, exact=exact, seed=7,
                         device="cuda")
        s_cpu = cpu.init_state()
        s_gpu = state_from_numpy(state_to_numpy(s_cpu), "cuda")
        g = torch.Generator().manual_seed(5)
        ml = cpu.cfg.m_loc
        noise = dict(mu=torch.randn(T, generator=g),
                     u=torch.rand(ml, T, generator=g),
                     nrm=torch.randn(ml, T, generator=g),
                     wperm=torch.randperm(cpu.cfg.n_windows, generator=g),
                     perm=torch.randperm(ml, generator=g))
        a, sa = cpu.step(s_cpu, 0, noise=noise)
        b, sb = gpu.step(s_gpu, 0, noise={k: v.cuda() for k, v in noise.items()})
        a, b = state_to_numpy(a), state_to_numpy(b)
        d_eps = float(np.abs(a["eps"] - b["eps"]).max())
        d_beta = float(np.abs(a["beta"] - b["beta"]).max())
        n_comp = int((a["components"] != b["components"]).sum())
        print(f"one {name} sweep (W={window}, {cpu.cfg.schedule}), CUDA vs "
              f"CPU sampler: max|d eps| {d_eps:.3e}  max|d beta| "
              f"{d_beta:.3e}  comp mismatches {n_comp}", flush=True)
        np.testing.assert_allclose(b["eps"], a["eps"], atol=5e-4, rtol=1e-3)
        np.testing.assert_allclose(b["beta"], a["beta"], atol=5e-4, rtol=1e-3)
        if n_comp or not np.array_equal(sa.cass.numpy(), sb.cass.cpu().numpy()):
            raise AssertionError("component mismatches CUDA vs CPU sampler")
    return launches


def print_mt_draw_bound(W, nb, C, T, kind):
    """The least time of one window's multi-trait draw launch.
    exact_mt_draw_kernel ("exact", the exact sweep): the stats partials (s1
    and s2 per trait, v), the W mrow rows, the order and the (W, W) Gram in,
    out and coef out. window_recurrence_mt_kernel ("per_trait", the
    per-window path): the (T, W, W) Gram, num0, the W mrow rows, the order
    and i2se in, (4, W, T) out. Both: the rank-1 update (2 T W^2 f32) and
    ~100 f32 operations a draw. stale_draw_mt_kernel ("stale"): the stats
    partials (s1, s2), the W mrow rows, the order and sc in, out and coef
    out; ~100 f32 operations a draw."""
    n_tiles = -(-nb // 512)
    ops = {"f32": 2.0 * T * W * W + 100.0 * W * T}
    if kind == "per_trait":
        name = "window_recurrence_mt_kernel"
        nbytes = 4 * (T * W * W + W * T + W * C + W + T + 4 * W * T)
    elif kind == "exact":
        name = "exact_mt_draw_kernel"
        nbytes = 4 * (n_tiles * W * (2 * T + 1) + W * C + W + W * W
                      + 2 * T + 1 + 5 * W * T)
    else:
        name = "stale_draw_mt_kernel"
        ops = {"f32": 100.0 * W * T}
        nbytes = 4 * (2 * n_tiles * W * T + W * C + W + 2 * T + 1 + 5 * W * T)
    ms, by = bound(nbytes, ops)
    print(f"  bound per window (W={W}, T={T}, nb={nb}): {name} "
          f"{1e3 * ms:.4f} us ({by})", flush=True)


def phase_mt_real_size(torch, np, card):
    """Multi-trait at M=100,000 x N=50,000, T=4: exact W=128 and stale W=64
    on the block schedule with full phenotypes, and the per-window path
    (exact W=128, marker schedule) with 10% NaN per trait."""
    from hydra_tpu_torch.data.genotypes import (Dataset, GenotypeData,
                                                make_default_groups)
    from hydra_tpu_torch.ops import sweep_kernel_mt as skmt
    from hydra_tpu_torch.samplers.bayesrrm_mt import BayesRRmMT
    dev = torch.device("cuda")
    m, n, T = 100_000, 50_000, 4
    n_pad = padded_individuals(np, n)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(3)
    pk, mave, mstd, nm = device_genotypes(torch, m, n, n_pad, gen)
    torch.cuda.synchronize()
    print(f"generated {pk.numel() / 1e9:.3f} GB of packed genotypes on the "
          f"card in {time.perf_counter() - t0:.1f} s", flush=True)
    mave_h, mstd_h = mave.double().cpu().numpy(), mstd.double().cpu().numpy()
    geno = GenotypeData(packed=np.zeros((0, n_pad // 4), np.uint8), n=n,
                        n_pad=n_pad, m=m, mave=mave_h, mstd=mstd_h,
                        msd=1.0 / mstd_h, n1=None, n2=None,
                        nm=nm.cpu().numpy())
    groups, mS = make_default_groups(m, list(MS[1:]))
    ds = Dataset(geno=geno, y=np.zeros(n), groups=groups, num_groups=1, mS=mS)
    for label, exact, window, na_frac, n_time in (
            ("exact", True, 128, 0.0, 5), ("stale", False, 64, 0.0, 10),
            ("exact NaN 10%", True, 128, 0.1, 3)):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        s = BayesRRmMT(ds, mt_phenotypes(np, n, T, 4, na_frac), window=window,
                       exact=exact, seed=1, device=dev, packed_device=pk)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        st = s.init_state()
        for it in range(2):
            st, _ = s.step(st, it)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for it in range(2, 2 + n_time):
            st, stats = s.step(st, it)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n_time
        if not bool(torch.isfinite(st.eps).all()):
            raise AssertionError("non-finite residual at real size")
        print(f"real size mt T={T} M=100,000 x N=50,000 {label} W={window} "
              f"{s.cfg.schedule}: {ms:.2f} ms/sweep, {m / ms * 1e3:,.0f} "
              f"markers/s ({n_time} sweeps after 2 warm-up; sampler set up "
              f"in {setup:.1f} s), peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB  [{card}]",
              flush=True)
        cfg = s.cfg
        mrow = s.build_mrow(st, torch.rand((cfg.m_loc, T), device=dev),
                            torch.randn((cfg.m_loc, T), device=dev),
                            s.active(st))
        order = s.sweep_order(0)
        i2se = 0.5 / st.sigma_e
        if not exact:
            def run():
                return skmt.sweep_stale_mt(
                    s.packed, st.eps, s.trait_mask, mrow, i2se, s.dNm1,
                    window=window, n_mix=cfg.k, complete=cfg.complete,
                    order=order)
            # the axpy draws the window itself up to the kernels'
            # MT_FOLD_MAX_W (above, the draw alone first: the profile
            # shows which)
            def n_launch(names):
                return cfg.n_windows * (3 if "stale_draw_mt_kernel" in names
                                        else 2)
        elif na_frac == 0.0:
            def run():
                return skmt.sweep_exact_mt(
                    s.packed, st.eps, s.trait_mask, mrow, i2se, s.dNm1,
                    window=window, n_mix=cfg.k, order=order)
            # stats, draw, axpy a window; the Grams once a batch
            n_launch = 3 * cfg.n_windows + -(-cfg.n_windows // gram_batch(
                cfg.n_windows, window))
        else:
            def run():
                return s.window_sweep(st.eps, mrow, order, i2se)
            n_launch = "4 kernel + torch"
        per = profile_run(torch, run, f"mt {label} W={window}", n_launch,
                          card, cfg.n_windows)
        fold = not exact and "stale_draw_mt_kernel" not in port_kernels(per)
        print_mt_stream_bounds(window, s.packed.shape[1], T, cfg.n_windows,
                               draw_cols=mrow.shape[1] if fold else 0)
        if not fold:
            print_mt_draw_bound(window, s.packed.shape[1], mrow.shape[1], T,
                                "stale" if not exact else
                                "per_trait" if na_frac > 0.0 else "exact")
        del s, st, mrow
    # the trait groups at T = 20: stale W=64 with full phenotypes, three
    # sweeps (wide_reading)
    s = BayesRRmMT(ds, mt_phenotypes(np, n, WIDE_T, 4), window=64,
                   exact=False, seed=1, device=dev, packed_device=pk)
    wide_reading(torch, s, f"mt T={WIDE_T} stale W=64 M=100,000 x N=50,000",
                 card)
    # two launches of each pass a window, a group of 16 traits and one of 4
    print_mt_stream_bounds(64, pk.shape[1], WIDE_T, 2 * s.cfg.n_windows)
    del s, pk


def print_mt_pass_times(torch, np, card):
    """Device time per call of the multi-trait packed passes alone,
    stats_mt_kernel (through window_stats_mt) and axpy_mt_kernel (through
    window_axpy_mt), at N=50,000 (nb = 12,544) on fixed-seed rows of
    M=4,096 markers with 10% NaN per trait: complete and 2% missing
    genotypes, T = 1, 4 and 16, W = 64 and 128; torch.profiler over 20
    calls after a warm-up (a configuration whose profile comes back empty
    three times reads "not measured"). scripts/chip_compare.py runs this
    tree's version in every tree, so two trees' kernels meet the same
    calls."""
    from hydra_tpu_torch.ops import window_kernels as wk
    dev = torch.device("cuda")
    m, n, calls = 4096, 50_000, 20
    n_pad = padded_individuals(np, n)
    gen = torch.Generator(device=dev).manual_seed(23)
    for missing in (0.0, 0.02):
        pk, _, _, _ = device_genotypes(torch, m, n, n_pad, gen, missing)
        complete = not missing
        for T in (1, 4, 16):
            tm = torch.zeros((n_pad, T), device=dev)
            tm[:n] = (torch.rand((n, T), generator=gen, device=dev)
                      >= 0.1).float()
            eps = torch.randn((n_pad, T), generator=gen, device=dev) * tm
            for W in (64, 128):
                rows = torch.randperm(m, generator=gen, device=dev)[:W].to(
                    torch.int32)
                c1 = 0.01 * torch.randn((T, W), generator=gen, device=dev)
                c2 = 0.01 * torch.randn((T, W), generator=gen, device=dev)
                us = []
                for kernel, fn in (
                        ("stats_mt_kernel",
                         lambda: wk.window_stats_mt(pk, eps, complete, rows)),
                        ("axpy_mt_kernel",
                         lambda: wk.window_axpy_mt(pk, c1, c2, complete,
                                                   rows))):
                    fn()
                    per = _profile_retry(
                        torch, lambda: [fn() for _ in range(calls)], kernel)
                    if per is None:
                        us.append("not measured")
                        continue
                    dev_ms = sum(ms for k, (_, ms) in per.items()
                                 if f"::{kernel}<" in k or f"::{kernel}(" in k)
                    us.append(f"{dev_ms * 1e3 / calls:.2f} us")
                print(f"mt pass T={T} W={W} "
                      f"{'missing' if missing else 'complete'}: "
                      f"stats_mt_kernel {us[0]}, axpy_mt_kernel {us[1]} a "
                      f"call  [{card}]", flush=True)
            del tm, eps
        del pk


def print_stale_fold_times(torch, np, card):
    """Device time a window of the stale sweeps' kernels by name, from
    torch.profiler over one sweep after a warm-up, at N=50,000 on
    fixed-seed complete genotypes (M=4,096; W=1 on 512 markers):
    sweep_stale at W = 1, 64, 128, 256, 512, 1024 and sweep_stale_mt at T =
    1, 4, 16 and W = 64, 128, 512, 1024 (full phenotypes). Where a tree
    launches the draw alone, "draw + axpy" adds it to the axpy; where the
    axpy draws the window itself, it is the axpy alone. scripts/chip_compare.py runs
    this tree's version in every tree, so the folded and the separate draw
    meet the same sweeps; the fold thresholds come from these lines.
    Each configuration's profile covers 3 sweeps."""
    from hydra_tpu_torch.ops import sweep_kernel as sk
    from hydra_tpu_torch.ops import sweep_kernel_mt as skmt
    dev = torch.device("cuda")
    m, n = 4096, 50_000
    n_pad = padded_individuals(np, n)
    gen = torch.Generator(device=dev).manual_seed(31)
    pk, mave, mstd, _ = device_genotypes(torch, m, n, n_pad, gen)
    pads = torch.randperm(m, generator=gen, device=dev)[:37]
    pk[pads] = 0xFF
    mask = torch.zeros(n_pad, device=dev)
    mask[:n] = 1.0

    def report(label, run, n_windows, reps=3):
        run()
        n_windows *= reps
        for _ in range(3):
            # a profile that missed launches (fewer than 2 a window) is
            # taken again, then reported not measured
            per = _profile_retry(torch, lambda: [run() for _ in range(reps)],
                                 label)
            if per is None:
                break
            us, launches = {}, 0
            for k, (cnt, ms) in per.items():
                if "hydra::" not in k:
                    continue
                launches += cnt
                name = kernel_name(k)
                us[name] = us.get(name, 0.0) + 1e3 * ms / n_windows
            if launches >= 2 * n_windows:
                break
        else:
            per = None
        if per is None:
            print(f"stale fold {label}: not measured  [{card}]", flush=True)
            return
        draw = sum(v for k, v in us.items() if "draw" in k)
        axpy = sum(v for k, v in us.items() if "axpy" in k)
        print(f"stale fold {label}: "
              + ", ".join(f"{k} {v:.2f} us" for k, v in sorted(us.items()))
              + f" a window; draw + axpy {draw + axpy:.2f} us; "
              f"{launches // reps} launches a sweep of {n_windows // reps} "
              f"windows  [{card}]", flush=True)

    mrow = kernel_rows(torch, mave, mstd, gen, n, pads)
    eps = 0.8 * torch.randn(n_pad, generator=gen, device=dev)
    eps[n:] = 0.0
    for W in (1, 64, 128, 256, 512, 1024):
        mw = 512 if W == 1 else m
        order = sk.block_order(torch.randperm(mw // W, generator=gen,
                                              device=dev), W)
        rows = mrow[:mw].contiguous()
        report(f"sweep_stale W={W}", lambda: sk.sweep_stale(
            pk[:mw], eps, rows, 1.0 / (2 * SIGMA_E), float(n - 1), window=W,
            n_mix=K, complete=True, ind_mask=mask, order=order), mw // W)
    del mrow, eps
    for T in (1, 4, 16):
        mrow = mt_kernel_rows(torch, mave, mstd, gen, n, pads, T)
        tm = torch.zeros((n_pad, T), device=dev)
        tm[:n] = 1.0
        eps = 0.8 * torch.randn((n_pad, T), generator=gen, device=dev) * tm
        i2se = torch.full((T,), 1.0 / (2 * SIGMA_E), device=dev)
        dnm1 = tm.sum(dim=0) - 1.0
        for W in (64, 128, 512, 1024):
            order = sk.block_order(torch.randperm(m // W, generator=gen,
                                                  device=dev), W)
            report(f"sweep_stale_mt T={T} W={W}", lambda: skmt.sweep_stale_mt(
                pk, eps, tm, mrow, i2se, dnm1, window=W, n_mix=K,
                complete=True, order=order), m // W)
        del mrow, tm, eps
    del pk


def print_library_times(torch, np, card):
    """The library yardstick of the single-trait packed passes, by rows 8
    and 9's convention: one PyTorch call on the window's rows decoded to f32
    (bf16, int8) before timing computes the same function as the kernel, at
    N=50,000 on fixed-seed complete genotypes (M=4,096). Device time a call
    from torch.profiler over 20 calls after a warm-up, for the kernels (by
    name, through window_stats, window_axpy and window_level_sums) and for
    the library calls:
      stats_kernel    torch.mv of the rows (exact: g; stale: h) against eps
      the Gram        of the W=128 rows (gram_i8_batch_kernel through
                      window_stats): torch.mm in f32 and in bf16,
                      torch._int_mm in int8 (the fastest is named)
      axpy_kernel     torch.addmv(eps, rows^T, c1)
      levels_kernel   torch.mm of the 2W level indicators (g = 1, g = 2)
                      against vi
    at W=128 (exact) and W=64 (stale; BayesW's levels), and on 2% missing
    calls the missing-data Gram (gram_f32_batch_kernel, through
    window_stats' exact branch) against torch.mm f32 of the window's
    decoded, standardized rows, W=128 and W=64. Then the exact sweeps'
    batched Grams (window_grams, where the tree has it) of 1 and 64 windows
    of W=128 (complete data also 256; missing data also W=64), device us a
    window (a batch of 1 is one unsplit launch, the alternative to
    window_stats' split one), beside
    torch.bmm of the same windows' decoded rows, bf16 (exact) for complete
    data and f32 of the standardized rows for missing data. window_stats'
    row (exact complete W=128: s1 and the standardized Gram) takes
    torch.mv and torch.mm of the standardized rows, two calls.
    window_axpy's device time is every kernel of one call (the wrapper's
    glue, where a tree has any, included); on missing data also at W=64,
    beside torch.addmv of the 2W decoded rows [g; m]. Returns
    {wrapper: {library_ms (CUDA events a call), device_ms,
    library_device_ms, library}} for window_stats, window_axpy and
    window_level_sums."""
    from hydra_tpu_torch.ops import window_kernels as wk
    from hydra_tpu_torch.ops.decode import decode_h
    dev = torch.device("cuda")
    m, n, calls = 4096, 50_000, 20
    n_pad = padded_individuals(np, n)
    gen = torch.Generator(device=dev).manual_seed(37)
    pk, mave, mstd, _ = device_genotypes(torch, m, n, n_pad, gen)
    eps = 0.8 * torch.randn(n_pad, generator=gen, device=dev)
    eps[n:] = 0.0
    vi = torch.exp(0.5 * eps - EULER_MASCHERONI)
    vi[n:] = 0.0
    rec = {}

    def dev_us(fn, label, names=None):
        """{kernel: us a call} (names: the substrings kept) and their sum."""
        fn()
        per = _profile_retry(torch, lambda: [fn() for _ in range(calls)],
                             label)
        if per is None:
            return None, float("nan")
        got = {}
        for k, (_, ms) in per.items():
            short = k.split("hydra::", 1)[-1].split("(", 1)[0][:40]
            if names is None or any(x in k for x in names):
                got[short] = got.get(short, 0.0) + 1e3 * ms / calls
        return got, sum(got.values())

    def show(label, kernel, lib):
        ks = ("not measured" if kernel[0] is None else ", ".join(
            f"{k} {v:.2f}" for k, v in kernel[0].items()))
        print(f"library {label}: kernel {ks} us a call; "
              + "; ".join(f"{name} {us:.2f} us" for name, us in lib)
              + f"  [{card}]", flush=True)

    for W, exact in ((128, True), (64, False)):
        rows = torch.randperm(m, generator=gen, device=dev)[:W].to(
            torch.int32)
        slots = rows.long()
        h = decode_h(pk[slots])
        h[:, n:] = 0.0
        x = (2.0 - h) if exact else h               # the stats' rows
        x[:, n:] = 0.0
        c1 = 0.01 * torch.randn(W, generator=gen, device=dev)
        c2 = -c1 * mave[slots]
        mw, sw = mave[slots].contiguous(), mstd[slots].contiguous()
        tag = f"W={W} {'exact' if exact else 'stale'}"
        # window_stats: s1 (and, exact, the standardized Gram)
        kern = dev_us(lambda: wk.window_stats(pk, eps, mw, sw, exact, True,
                                              float(n), rows),
                      "window_stats")
        lib = [("torch.mv", dev_us(lambda: torch.mv(x, eps), "mv")[1])]
        if exact:
            xs = ((x - mw[:, None]) * sw[:, None])
            xs[:, n:] = 0.0
            lib.append(("torch.mm f32 of the standardized rows", dev_us(
                lambda: torch.mm(xs, xs.t()), "mm")[1]))
            g8 = x.to(torch.int8)
            gb = x.to(torch.bfloat16)
            grams = [("torch.mm f32", dev_us(lambda: torch.mm(x, x.t()),
                                             "mm")[1]),
                     ("torch.mm bf16", dev_us(lambda: torch.mm(gb, gb.t()),
                                              "mm")[1])]
            try:
                grams.append(("torch._int_mm int8", dev_us(
                    lambda: torch._int_mm(g8, g8.t()), "int_mm")[1]))
            except RuntimeError as e:
                print(f"library torch._int_mm refused: {e}", flush=True)
            best = min(grams, key=lambda kv: kv[1])
            show(f"complete gram {tag}", dev_us(
                lambda: wk.window_stats(pk, eps, mw, sw, True, True,
                                        float(n), rows), "gram",
                ["gram"]), grams + [("fastest " + best[0], best[1])])
            lib_ms, _ = cuda_ms(torch, lambda: (torch.mv(x, eps),
                                                torch.mm(xs, xs.t())), calls)
            rec["window_stats"] = dict(
                library_ms=lib_ms, device_ms=kern[1] / 1e3,
                library_device_ms=(lib[0][1] + lib[1][1]) / 1e3,
                library="torch.mv + torch.mm on the decoded rows")
        show(f"window_stats {tag}", kern, lib)
        show(f"stats_kernel {tag}", dev_us(
            lambda: wk.window_stats(pk, eps, mw, sw, exact, True, float(n),
                                    rows), "stats", ["::stats_kernel"]),
             lib[:1])
        # window_axpy: d eps; the library adds to eps as well
        kern = dev_us(lambda: wk.window_axpy(pk, c1, c2, True, rows),
                      "window_axpy")
        lib = [("torch.addmv", dev_us(lambda: torch.addmv(eps, x.t(), c1),
                                      "addmv")[1])]
        show(f"window_axpy (axpy_kernel) {tag}", kern, lib)
        if not exact:
            lib_ms, _ = cuda_ms(torch, lambda: torch.addmv(eps, x.t(), c1),
                                calls)
            rec["window_axpy"] = dict(
                library_ms=lib_ms, device_ms=kern[1] / 1e3,
                library_device_ms=lib[0][1] / 1e3,
                library="torch.addmv on the decoded rows")
            # BayesW's level sums: i1 = (g == 1), i2 = (g == 2) against vi
            pk_w = pk[slots].contiguous()
            g = 2.0 - h
            g[:, n:] = 0.0
            lv = torch.cat([(g == 1.0).float(), (g == 2.0).float()])
            vcol = vi[:, None].contiguous()
            kern = dev_us(lambda: wk.window_level_sums(pk_w, vi, True),
                          "window_level_sums")
            lib = [("torch.mm", dev_us(lambda: torch.mm(lv, vcol),
                                       "mm")[1])]
            show(f"window_level_sums (levels_kernel) {tag}", kern, lib)
            lib_ms, _ = cuda_ms(torch, lambda: torch.mm(lv, vcol), calls)
            rec["window_level_sums"] = dict(
                library_ms=lib_ms, device_ms=kern[1] / 1e3,
                library_device_ms=lib[0][1] / 1e3,
                library="torch.mm of the level indicators against vi")
    # the exact sweeps' batched complete Grams: 64 and 256 windows of W=128
    # a launch, device us a window, beside torch.bmm in bf16 (exact: sums
    # of 0, 1, 2 products below 2^24) of the same windows' decoded rows
    from hydra_tpu_torch.ops.decode import decode_planes_hp
    grams_fn = getattr(wk, "window_grams", None)

    def windows(W, n_win):
        """n_win windows of W distinct rows each (the M rows permuted as
        often as n_win W rows need)."""
        reps = -(-n_win * W // m)
        return torch.cat([torch.randperm(m, generator=gen, device=dev)
                          for _ in range(reps)])[:n_win * W].to(torch.int32)

    def batched(label, order, W, n_win, lib, **kw):
        kern = (None, float("nan"))
        if grams_fn is not None:
            got, us = dev_us(lambda: grams_fn(pk, order, W, **kw), "grams",
                             ["gram"])
            kern = (None if got is None else
                    {k: v / n_win for k, v in got.items()}, us / n_win)
        show(f"{label} W={W} batch of {n_win}, a window", kern,
             [(name, us / n_win) for name, us in lib])

    # one window (one block a tile over all the individuals: the batch of
    # 1, beside window_stats' split launch above), 64 windows (192 blocks:
    # fewer than 2 an SM) and 256 (768)
    W = 128
    for n_win in (1, 64, 256):
        order = windows(W, n_win)
        xb = decode_planes_hp(pk[order.long()])[0].view(
            n_win, W, n_pad).to(torch.bfloat16)
        batched("complete gram", order, W, n_win, [("torch.bmm bf16", dev_us(
            lambda: torch.bmm(xb, xb.transpose(1, 2)), "bmm")[1])])
        del xb
    # the missing-data Gram beside torch.mm f32 of the window's decoded,
    # standardized rows (2% missing calls, its own generator), one window
    # of W=128 and of W=64; then batched, beside torch.bmm f32
    gen = torch.Generator(device=dev).manual_seed(39)
    pk, mave, mstd, _ = device_genotypes(torch, m, n, n_pad, gen, 0.02)
    for W in (128, 64):
        rows = torch.randperm(m, generator=gen, device=dev)[:W].to(
            torch.int32)
        mw = mave[rows.long()].contiguous()
        sw = mstd[rows.long()].contiguous()
        g, mk = decode_planes_hp(pk[rows.long()])
        xs = ((g - mw[:, None] * mk) * sw[:, None]).contiguous()
        show(f"missing gram W={W} exact missing 2%", dev_us(
            lambda: wk.window_stats(pk, eps, mw, sw, True, False, float(n),
                                    rows), "gram", ["gram"]),
             [("torch.mm f32 of the standardized rows",
               dev_us(lambda: torch.mm(xs, xs.t()), "mm")[1])])
        if W == 64:
            # window_axpy on missing data, sum c1 g + c2 m: the library's
            # one call takes the 2W decoded rows [g; m] and [c1; c2]
            c1 = 0.01 * torch.randn(W, generator=gen, device=dev)
            c2 = -c1 * mw
            gm = torch.cat([g, mk]).t()
            cc = torch.cat([c1, c2])
            show(f"window_axpy (axpy_kernel) W={W} missing 2%", dev_us(
                lambda: wk.window_axpy(pk, c1, c2, False, rows),
                "window_axpy"), [("torch.addmv", dev_us(
                    lambda: torch.addmv(eps, gm, cc), "addmv")[1])])
            del gm
        for n_win in (1, 64):
            order = windows(W, n_win)
            slots = order.long()
            g, mk = decode_planes_hp(pk[slots])
            xs = ((g - mave[slots, None] * mk) * mstd[slots, None]).view(
                n_win, W, n_pad)
            batched("missing gram", order, W, n_win, [(
                "torch.bmm f32 of the standardized rows", dev_us(
                    lambda: torch.bmm(xs, xs.transpose(1, 2)), "bmm")[1])],
                mave=mave, mstd=mstd)
            del g, mk, xs
    del pk
    return rec


def phase_window_kernels(torch, np, card):
    """The per-window branch's kernels against their plain versions at
    N=50,000, rows read in place from M=4,096 packed rows (a pad slot at
    the window's head): window_stats at W=128 (exact and stale, complete
    and 2% missing), window_gibbs on the complete exact window's own Gram
    and num0, window_axpy on the window's rows (complete and 2% missing:
    bit for bit window_axpy_ref, complete data on the real individuals, and
    one device kernel a call in the profile, check_one_launch),
    window_stats_planes and window_axpy_planes at W=64 (complete
    data). Tolerances: the stats rtol 1e-4, atol 1e-6 N (the plain versions
    add in the kernels' order, so s1, s2, the complete Gram and the planes
    come out bit for bit, but for a pad row's 3*eps products in complete
    stale data, which the kernel fuses into its multiply-add; the
    missing-data Gram's kernel, gram_f32_batch_kernel, runs one fused
    multiply-add chain an entry per 2,048-individual chunk and adds the
    chunks in order, the plain version a library matmul, so the two agree
    to f32 rounding;
    check_missing_gram holds every entry to x x^T in float64 within the
    forward error bound of that order and G == G^T bit for bit); the
    recurrence atol 5e-4,
    rtol 1e-3 and 0 component mismatches."""
    from hydra_tpu_torch.ops import gibbs_kernel as gk
    from hydra_tpu_torch.ops import planes as tpl
    from hydra_tpu_torch.ops import window_kernels as wk
    dev = torch.device("cuda")
    m, n = 4096, 50_000
    n_pad = padded_individuals(np, n)
    nb = n_pad // 4
    rec = {k: dict(err=0.0) for k in ("window_stats", "window_gibbs",
                                      "window_stats_planes",
                                      "window_axpy_planes")}
    stats_tol = [(1e-4, 1e-6 * n)] * 3
    for missing in (0.0, 0.02):
        gen = torch.Generator(device=dev).manual_seed(17)
        pk, mave, mstd, _ = device_genotypes(torch, m, n, n_pad, gen, missing)
        pads = torch.randperm(m, generator=gen, device=dev)[:37]
        pk[pads] = 0xFF
        mrow = kernel_rows(torch, mave, mstd, gen, n, pads)
        eps = 0.8 * torch.randn(n_pad, generator=gen, device=dev)
        eps[n:] = 0.0
        complete = not missing
        data = "complete" if complete else "missing 2%"
        W = 128
        rest = torch.randperm(m, generator=gen, device=dev)
        rest = rest[rest != pads[0]]
        rows = torch.cat([pads[:1], rest[:W - 1]]).to(torch.int32)
        b = mrow[rows.long()]
        mave_w, mstd_w = b[:, 0].contiguous(), b[:, 1].contiguous()
        for exact in (True, False):
            args = (pk, eps, mave_w, mstd_w, exact, complete, float(n), rows)
            ms, plain_ms = compare_outputs(
                torch, "window_stats", f"W={W} {'exact' if exact else 'stale'}"
                f" {data}", lambda: wk.window_stats(*args),
                lambda: wk.window_stats_ref(*args), 20, stats_tol, card, rec)
            check_stats_bitwise(torch, f"window_stats W={W} "
                                f"{'exact' if exact else 'stale'} {data}", pk,
                                eps, mrow, rows, exact, complete, n, card)
            if exact and not complete:
                check_missing_gram(torch, f"window_stats W={W} {data}", pk,
                                   mave_w, mstd_w, rows,
                                   wk.window_stats(*args)[2], card)
            if not (exact and complete):
                continue
            r = rec["window_stats"]
            r["ms"], r["plain_ms"] = ms, plain_ms
            # packed rows, eps, mave, mstd, rows, n in; s1 and the Gram out.
            # Ops: s1 one FMA per genotype, sum(eps) once; the symmetric
            # integer Gram (W + 1) / 2 multiply-adds and v one add per
            # genotype
            nbytes = W * nb + 4 * n_pad + 12 * W + 4 + 4 * W + 4 * W * W
            r["bound_ms"], r["bound_by"] = bound(
                nbytes, {"f32": 2.0 * W * n_pad + n_pad,
                         "int8": W * (W + 1.0) * n_pad + W * n_pad})
            print_bound("window_stats", r)
            # the same window's recurrence
            s1, _, gram = wk.window_stats(*args)
            num0 = mstd_w * (s1 - mave_w * eps.sum()) + b[:, 2] * float(n - 1)
            cols = [c.contiguous() for c in (
                b[:, 6:6 + K], b[:, 6 + K:5 + 2 * K], b[:, 5 + 2 * K:],
                b[:, 3], b[:, 4], b[:, 5], b[:, 2])]
            gargs = [gram, num0] + cols + [1.0 / (2 * SIGMA_E)]
            r = rec["window_gibbs"]
            r["ms"], r["plain_ms"] = compare_outputs(
                torch, "window_gibbs", f"W={W} {data}",
                lambda: gk.window_gibbs(*gargs),
                lambda: gk.window_gibbs_ref(*gargs), 20,
                [(1e-3, 5e-4)] * 4, card, rec, comp_of=lambda o: o[2])
            # Gram and the per-marker inputs in; four (W,) outputs. Ops:
            # the rank-1 update, one FMA per (step, marker); ~100 per draw
            nbytes = 4 * W * W + 4 * W * (5 + K + 2 * (K - 1)) + 4 + 16 * W
            r["bound_ms"], r["bound_by"] = bound(
                nbytes, {"f32": 2.0 * W * W + 100.0 * W})
            print_bound("window_gibbs", r)
        # window_axpy on the same window's rows: one launch a call, bit for
        # bit its plain version (complete data: on the real individuals)
        c1 = 0.01 * torch.randn(W, generator=gen, device=dev) * mstd_w
        c2 = -c1 * mave_w
        d_k = wk.window_axpy(pk, c1, c2, complete, rows)
        d_r = wk.window_axpy_ref(pk, c1, c2, complete, rows)
        same = torch.equal(d_k[:n], d_r[:n]) and (complete
                                                  or torch.equal(d_k, d_r))
        print(f"window_axpy W={W} {data}: bit for bit window_axpy_ref "
              f"{same}  [{card}]", flush=True)
        if not same:
            raise AssertionError(f"window_axpy W={W} {data} differs from "
                                 "window_axpy_ref")
        check_one_launch(torch, f"window_axpy W={W} {data}",
                         lambda: wk.window_axpy(pk, c1, c2, complete, rows),
                         card)
        if not complete:
            continue
        W = 64
        planes = tpl.build_planes(pk)
        rows = torch.cat([pads[:1], rest[W:2 * W - 1]]).to(torch.int32)
        c1 = 0.05 * torch.randn(W, generator=gen, device=dev)
        pwf = planes[rows.long()].float()   # the library's input, cast before timing
        for name, fn, ref, lib in (
                ("window_stats_planes",
                 lambda: (tpl.window_stats_planes(planes, eps, rows),),
                 lambda: (tpl.window_stats_planes_ref(planes, eps, rows),),
                 lambda: torch.mv(pwf, eps)),
                ("window_axpy_planes",
                 lambda: (tpl.window_axpy_planes(planes, c1, rows),),
                 lambda: (tpl.window_axpy_planes_ref(planes, c1, rows),),
                 lambda: torch.mv(pwf.t(), c1))):
            r = rec[name]
            r["ms"], r["plain_ms"] = compare_outputs(
                torch, name, f"W={W} {data}", fn, ref, 20,
                [(1e-5, 1e-6 * n)], card, rec)
            if not torch.equal(fn()[0], ref()[0]):
                raise AssertionError(f"{name} W={W} differs from its plain "
                                     "version")
            # one launch a call: the kernel alone, no memset, no torch op
            check_one_launch(torch, f"{name} W={W}", fn, card)
            lib()
            r["library_ms"], want = cuda_ms(torch, lib, 20)
            torch.testing.assert_close(fn()[0], want, rtol=1e-5,
                                       atol=1e-6 * n)
            # the same 20 calls as device time alone (the CUDA-event times
            # above include the host's enqueue of each call); the library's
            # on the rows cast to f32 before timing
            for key, f in (("device_ms", fn), ("library_device_ms", lib)):
                per = device_times(torch, lambda: [f() for _ in range(20)],
                                   name)
                r[key] = sum(v[1] for v in per.values()) / 20
            # the window's int8 rows, eps or the coefficients, rows in;
            # s1 or d eps out. Ops: one FMA per genotype
            nbytes = W * n_pad + 8 * W + 4 * n_pad + (
                4 * W if name == "window_stats_planes" else 0)
            r["bound_ms"], r["bound_by"] = bound(
                nbytes, {"f32": 2.0 * W * n_pad})
            print(f"{name:19s} library torch.mv on the rows cast to f32 "
                  f"before timing {r['library_ms']:.4f} ms; device time per "
                  f"call: kernel {r['device_ms']:.4f} ms, library "
                  f"{r['library_device_ms']:.4f} ms  [{card}]", flush=True)
            print_bound(name, r)
        del planes, pwf
    return rec


WINDOW_RUNS = (("off_exact", ("--mega", "off")),
               ("off_stale", ("--mega", "off", "--stale", "--window", "64")),
               ("planes", ("--cache-planes", "on", "--stale", "--window",
                           "64")),
               ("stale_w1", ("--stale",)))


def phase_window_cli(torch, np, tmp):
    """The per-window branch and W = 1 through the CLI at M=10,000 x
    N=5,000 (phase 3's bed), 20 iterations each (WINDOW_RUNS), each run's
    launches counted on its own; then one CUDA sweep of each against the
    CPU sampler with the same state and noise."""
    from hydra_tpu_torch import cli
    from hydra_tpu_torch.options import parse_args
    from hydra_tpu_torch.runner import dataset_from_options
    from hydra_tpu_torch.samplers.bayesrrm import (BayesRRm, state_from_numpy,
                                                   state_to_numpy)
    m, n, iters = 10_000, 5_000, 20
    base = os.path.join(tmp, "t_M10K_N_5K")
    common = ["--mpibayes", "bayesMPI", "--bfile", base, "--pheno",
              base + ".phen", "--S", "0.0001,0.001,0.01", "--chain-length",
              str(iters), "--thin", "5", "--save", "10", "--seed", "7",
              "--mcmc-out-dir", os.path.join(tmp, "out")]
    n_win = -(-m // 64)
    moved = {"off_exact": ("window_stats", "window_gibbs", "window_axpy"),
             "off_stale": ("window_stats", "window_axpy"),
             "planes": ("window_stats_planes", "window_axpy_planes"),
             "stale_w1": ("sweep_stale",)}
    total = {}
    for name, extra in WINDOW_RUNS:
        reset_all_launches()
        t0 = time.perf_counter()
        rc = cli.main(common + ["--mcmc-out-name", name, *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in all_launches().items() if v}
        print(f"{name} ({' '.join(extra)}): exit {rc}, {wall:.1f} s wall for "
              f"{iters} iterations, launches {json.dumps(launches)}",
              flush=True)
        if rc != 0:
            raise AssertionError(f"CLI exit code {rc}")
        want = {k: (iters if name == "stale_w1" else iters * n_win)
                for k in moved[name]}
        if launches != want:
            raise AssertionError(f"{name}: launches {launches}, want {want}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        h2 = check_outputs(np, os.path.join(tmp, "out", name), m, iters // 5)
        print(f"{name}: {iters // 5} thinned records, mean h2 over the last "
              f"{iters // 10} = {h2:.4f} (simulated 0.5)", flush=True)

    # one sweep of each, CUDA sampler vs CPU sampler, same state and noise
    for name, extra in WINDOW_RUNS:
        opt = parse_args(common + list(extra))
        ds = dataset_from_options(opt)
        kw = dict(window=opt.window, exact=opt.exact, seed=7, mega=opt.mega,
                  plane_cache=opt.plane_cache)
        cpu = BayesRRm(ds, device="cpu", **kw)
        gpu = BayesRRm(ds, device="cuda", **kw)
        s_cpu = cpu.init_state()
        s_gpu = state_from_numpy(state_to_numpy(s_cpu), "cuda")
        g = torch.Generator().manual_seed(5)
        ml = cpu.cfg.m_loc
        noise = dict(mu=torch.randn((), generator=g),
                     u=torch.rand(ml, generator=g),
                     nrm=torch.randn(ml, generator=g),
                     perm=torch.randperm(ml, generator=g))
        t0 = time.perf_counter()
        a, sa = cpu.step(s_cpu, 0, noise=noise)
        t1 = time.perf_counter()
        b, sb = gpu.step(s_gpu, 0, noise={k: v.cuda() for k, v in noise.items()})
        a, b = state_to_numpy(a), state_to_numpy(b)
        d_eps = float(np.abs(a["eps"] - b["eps"]).max())
        d_beta = float(np.abs(a["beta"] - b["beta"]).max())
        n_comp = int((a["components"] != b["components"]).sum())
        print(f"one {name} sweep (W={opt.window}, {gpu.cfg.schedule}, "
              f"{'per-window' if gpu.cfg.per_window else 'whole-sweep'}"
              f"{', planes' if gpu.cfg.planes else ''}), CUDA vs CPU sampler "
              f"({t1 - t0:.1f} s on the CPU): max|d eps| {d_eps:.3e}  max|d "
              f"beta| {d_beta:.3e}  comp mismatches {n_comp}", flush=True)
        if gpu.cfg.schedule != "marker":
            raise AssertionError(f"{name}: schedule {gpu.cfg.schedule}")
        np.testing.assert_allclose(b["eps"], a["eps"], atol=5e-4, rtol=1e-3)
        np.testing.assert_allclose(b["beta"], a["beta"], atol=5e-4, rtol=1e-3)
        if n_comp or not np.array_equal(sa.cass.numpy(), sb.cass.cpu().numpy()):
            raise AssertionError("component mismatches CUDA vs CPU sampler")
    return total


# phase 4d's configurations: (M, N, ((label, exact, W, mega, cache planes),
# ...)); MEGA_OFF_REAL_SIZE the two --mega off rows alone and
# PLANES_REAL_SIZE the planes row, at M=100,000 (scripts/chip_compare.py).
# The smoke's host-bound per-window rows run at M=25,000: at M=100,000 the
# whole smoke read 1,170.1 s of phases, 1,182 s with its start, of its
# 1,200 s limit (NVIDIA H100 80GB HBM3, 700 W), 4d 194.6 s of it
WINDOW_REAL_SIZE = (
    (25_000, 50_000, (("--mega off exact", True, 128, "off", "off"),
                       ("--mega off stale", False, 64, "off", "off"),
                       ("--cache-planes on stale", False, 64, "auto", "on"))),
    (10_000, 5_000, (("--stale", False, 1, "auto", "off"),)))
MEGA_OFF_REAL_SIZE = ((100_000, 50_000, WINDOW_REAL_SIZE[0][2][:2]),)
PLANES_REAL_SIZE = ((100_000, 50_000, WINDOW_REAL_SIZE[0][2][2:]),)


def print_window_gibbs_times(torch, np, card):
    """window_gibbs_kernel alone, device us a call (torch.profiler over 20
    calls after a warm-up, over the launches the session recorded: one can
    drop some) at W=64, 128 and 1024, K=4 (gibbs_inputs), and a step (a
    call over W), beside its bound a call: the Gram's and the markers'
    bytes over the card's rate. The W dependent draws bound it in fact
    (the chain), which no rate measures."""
    from hydra_tpu_torch.ops import gibbs_kernel as gk
    dev = torch.device("cuda")
    calls = 20
    for W in (64, 128, 1024):
        gen = torch.Generator(device=dev).manual_seed(79 + W)
        args = gibbs_inputs(torch, W, K, gen)
        gk.window_gibbs(*args)
        per = _profile_retry(torch, lambda: [gk.window_gibbs(*args)
                                             for _ in range(calls)],
                             "window_gibbs") or {}
        mine = [v for k, v in per.items() if "window_gibbs" in k]
        n = sum(cnt for cnt, _ in mine)
        us = 1e3 * sum(ms for _, ms in mine) / n if n else float("nan")
        others = sum(cnt for k, (cnt, _) in per.items()
                     if "window_gibbs" not in k)
        nbytes = 4 * W * W + 4 * W * (5 + K + 2 * (K - 1)) + 4 + 16 * W
        b_ms, by = bound(nbytes, {"f32": 2.0 * W * W + 100.0 * W})
        print(f"window_gibbs W={W} K={K}: window_gibbs_kernel {us:.2f} us "
              f"a call, {us / W:.4f} us a step ({n} of {calls} calls "
              f"recorded); bound {1e3 * b_ms:.4f} us ({by}); other device "
              f"kernels: {others}  [{card}]", flush=True)


# the widths print_planes_times times (W=8 and 256 read in PERF.md §6);
# the smoke's time limit keeps two
PLANES_TIMES_W = (64, 1024)


def print_planes_times(torch, np, card, calls=20):
    """window_stats_planes and window_axpy_planes alone, device us a call
    (torch.profiler over ``calls`` calls after a warm-up: each kernel's
    mean a launch times its launches a call), at the W of PLANES_TIMES_W
    on int8 planes of M=4,096 x N=50,000, each two ways: "cold", call k on
    window k mod 20 of a random order of the rows (up to M / W windows),
    so from W=64 on the windows' rows exceed the L2 cache and come mostly
    from device memory, as the stats pass reads them on the main path;
    "warm", every call on the first window, whose rows stay in L2 up to
    W=256, as the axpy reads them after the stats on the main path (and as
    PERF.md timed both kernels before this design). Beside each: its bound a
    call (the window's int8 rows, the row indices, eps and s1 or c1 and d,
    over 3.35 TB/s) and torch.mv on the same windows' rows cast to f32
    before timing (the library yardstick; the f32 rows are 4x the bytes)."""
    from hydra_tpu_torch.ops import planes as tpl
    dev = torch.device("cuda")
    m, n = 4096, 50_000
    n_pad = padded_individuals(np, n)
    gen = torch.Generator(device=dev).manual_seed(97)
    pk, _, _, _ = device_genotypes(torch, m, n, n_pad, gen)
    planes = tpl.build_planes(pk)
    del pk
    eps = 0.8 * torch.randn(n_pad, generator=gen, device=dev)
    eps[n:] = 0.0
    for W in PLANES_TIMES_W:
        order = torch.randperm(m, generator=gen, device=dev).to(torch.int32)
        wins = [order[k * W:(k + 1) * W].contiguous()
                for k in range(min(20, m // W))]
        c1 = 0.05 * torch.randn(W, generator=gen, device=dev)
        rows_f32 = [planes[w.long()].float() for w in wins]
        fns = {"window_stats_planes":
               lambda k: tpl.window_stats_planes(planes, eps, wins[k]),
               "window_axpy_planes":
               lambda k: tpl.window_axpy_planes(planes, c1, wins[k]),
               "torch.mv stats": lambda k: torch.mv(rows_f32[k], eps),
               "torch.mv axpy": lambda k: torch.mv(rows_f32[k].t(), c1)}
        b_ms, by = bound(W * n_pad + 8 * W + 4 * n_pad,
                         {"f32": 2.0 * W * n_pad})
        for mode, nw in (("cold", len(wins)), ("warm", 1)):
            us = {}
            for name, f in fns.items():
                for k in range(nw):
                    f(k)
                per = _profile_retry(torch, lambda: [f(k % nw)
                                                     for k in range(calls)],
                                     name)
                if not per:
                    us[name] = "not measured"
                    continue
                t = sum(1e3 * ms / cnt * max(1, round(cnt / calls))
                        for cnt, ms in per.values())
                names = ", ".join(kernel_name(k) if "hydra::" in k
                                  else k[:40] for k in per)
                us[name] = f"{t:.2f} us ({names})"
            print(f"planes W={W} {mode}: "
                  + "; ".join(f"{k} {v}" for k, v in us.items())
                  + f"; bound {1e3 * b_ms:.4f} us ({by}) a call  [{card}]",
                  flush=True)
        del rows_f32
    del planes


def print_host_split(torch, run, label, n_windows, card, top=12):
    """Where the host's enqueue of one exact per-window sweep (run) goes:
    the host time of each kernel wrapper the sampler calls (each timed by
    the host clock around its call, the sampler's module patched for one
    sweep) and the rest, the sampler's own torch calls, us a window; then
    the ``top`` torch operators by their own CPU time in torch.profiler
    (CPU activity only), us a window."""
    from torch.profiler import ProfilerActivity, profile
    from hydra_tpu_torch.samplers import bayesrrm as sb
    names = ("window_stats", "window_gibbs", "window_axpy")
    spent = dict.fromkeys(names, 0.0)
    calls = dict.fromkeys(names, 0)
    orig = {k: getattr(sb, k) for k in names}

    def timed(k, f):
        def call(*a, **kw):
            t = time.perf_counter()
            out = f(*a, **kw)
            spent[k] += time.perf_counter() - t
            calls[k] += 1
            return out
        return call

    run()
    torch.cuda.synchronize()
    for k, f in orig.items():
        setattr(sb, k, timed(k, f))
    try:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
    finally:
        for k, f in orig.items():
            setattr(sb, k, f)
    per = 1e6 / n_windows
    parts = [f"{k} {per * spent[k]:.1f} ({calls[k] / n_windows:g} a window)"
             for k in names]
    rest = wall - sum(spent.values())
    print(f"  host split {label}: enqueue {per * wall:.1f} us a window = "
          f"{', '.join(parts)}, the sampler's own torch calls "
          f"{per * rest:.1f}  [{card}]", flush=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    torch.cuda.synchronize()
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    print("    torch operators by own CPU time a window (profiled): "
          + "; ".join(f"{e.key} {e.self_cpu_time_total / n_windows:.1f} us "
                      f"x{e.count / n_windows:g}" for e in ops[:top]),
          flush=True)


def phase_window_real_size(torch, np, sk, card, configs=WINDOW_REAL_SIZE,
                           host_split=False):
    """The per-window branch at M=100,000 x N=50,000 (--mega off exact
    W=128, --mega off stale W=64, --cache-planes on stale W=64) and the
    whole-sweep stale kernel at W=1 at M=10,000 x N=5,000 (configs,
    WINDOW_REAL_SIZE): ms/sweep, markers/s, busy share, host enqueue,
    device time per kernel; host_split: where an exact per-window sweep's
    enqueue goes (print_host_split)."""
    from hydra_tpu_torch.data.genotypes import (Dataset, GenotypeData,
                                                make_default_groups)
    from hydra_tpu_torch.samplers.bayesrrm import BayesRRm
    dev = torch.device("cuda")
    for m, n, runs in configs:
        n_pad = padded_individuals(np, n)
        gen = torch.Generator(device=dev).manual_seed(2)
        pk, mave, mstd, nm = device_genotypes(torch, m, n, n_pad, gen)
        mave_h, mstd_h = mave.cpu().numpy(), mstd.cpu().numpy()
        geno = GenotypeData(packed=np.zeros((0, n_pad // 4), np.uint8), n=n,
                            n_pad=n_pad, m=m, mave=mave_h, mstd=mstd_h,
                            msd=1.0 / mstd_h, n1=None, n2=None,
                            nm=nm.cpu().numpy())
        groups, mS = make_default_groups(m, list(MS[1:]))
        y = np.random.RandomState(0).randn(n)
        ds = Dataset(geno=geno, y=y, groups=groups, num_groups=1, mS=mS)
        for label, exact, window, mega, pc in runs:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            s = BayesRRm(ds, window=window, exact=exact, seed=1, device=dev,
                         mega=mega, plane_cache=pc, packed_device=pk)
            torch.cuda.synchronize()
            setup = time.perf_counter() - t0
            st = s.init_state()
            st, _ = s.step(st, 0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for it in range(1, 3):
                st, stats = s.step(st, it)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / 2
            if not bool(torch.isfinite(st.eps).all()):
                raise AssertionError("non-finite residual at real size")
            sg, se = float(st.sigma_g.sum()), float(st.sigma_e)
            print(f"real size M={m:,} x N={n:,} {label} W={window} "
                  f"{s.cfg.schedule}: {ms:.2f} ms/sweep, {m / ms * 1e3:,.0f} "
                  f"markers/s (2 sweeps after 1 warm-up; set up in "
                  f"{setup:.1f} s), h2 {sg / (sg + se):.4f}, peak "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB  [{card}]",
                  flush=True)
            if not s.cfg.per_window:
                profile_sweep(torch, sk, s, st, card)
            else:
                cfg = s.cfg
                active = ((st.sigma_g[s.groups] > 0) & (s.valid > 0)
                          & (s.mstd > 0))
                mrow = s.build_mrow(st, torch.rand(cfg.m_loc, device=dev),
                                    torch.randn(cfg.m_loc, device=dev),
                                    active)
                order = s.sweep_order(0)
                i2se = 0.5 / st.sigma_e
                # complete data: exact 4 window_stats launches (stats,
                # finish, Gram, standardize) and a memset of the Gram's
                # accumulator + window_gibbs + the axpy; stale 2 stats
                # launches + axpy; the planes one stats launch + axpy
                per = 6 if exact else 2 if pc == "on" else 3
                memset = (f" + 1 memset/window = {cfg.n_windows}" if exact
                          else "")
                profile_run(torch, lambda: s.window_sweep(st.eps, mrow, order,
                                                          i2se),
                            f"{label} W={window}",
                            f"{per}/window = {per * cfg.n_windows} CUDA-kernel"
                            + memset, card, cfg.n_windows)
                if host_split and exact:
                    print_host_split(torch, lambda: s.window_sweep(
                        st.eps, mrow, order, i2se), f"{label} W={window}",
                        cfg.n_windows, card)
                if pc != "on":
                    print_stream_bounds(window, s.packed.shape[1],
                                        cfg.n_windows)
            del s, st
        del pk


@contextlib.contextmanager
def sd_env(value):
    """HYDRA_TPU_SD set to ``value`` ("" unsets it) inside the block."""
    old = os.environ.get("HYDRA_TPU_SD")
    os.environ["HYDRA_TPU_SD"] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ["HYDRA_TPU_SD"]
        else:
            os.environ["HYDRA_TPU_SD"] = old


def phase_sd_kernels(torch, np, sk, card):
    """sweep_stale_sd against its plain version at M=4,096 x N=50,000, W=64,
    sub-windows 64 and 16, complete and 2% missing genotypes, on a
    marker-schedule order (a fresh permutation of every slot): bitwise
    repeatable, eps and the outputs within atol 5e-4 / rtol 1e-3, components
    equal; beside it sweep_stale on the same inputs (components equal; bit
    for bit at one sub-window a window, the same sums in the same order)."""
    dev = torch.device("cuda")
    m, n, W = 4096, 50_000, 64
    n_pad = padded_individuals(np, n)
    rec = {"sweep_stale_sd": dict(err=0.0)}
    tol = [(1e-3, 5e-4)] * 2
    for missing in (0.0, 0.02):
        gen = torch.Generator(device=dev).manual_seed(23)
        pk, mave, mstd, _ = device_genotypes(torch, m, n, n_pad, gen, missing)
        pads = torch.randperm(m, generator=gen, device=dev)[:37]
        pk[pads] = 0xFF
        mrow = kernel_rows(torch, mave, mstd, gen, n, pads)
        eps = 0.8 * torch.randn(n_pad, generator=gen, device=dev)
        eps[n:] = 0.0
        mask = torch.zeros(n_pad, device=dev)
        mask[:n] = 1.0
        order = torch.randperm(m, generator=gen, device=dev).to(torch.int32)
        complete = not missing
        kw = dict(window=W, n_mix=K, complete=complete,
                  ind_mask=mask if complete else None, order=order)
        args = (pk, eps, mrow, 1.0 / (2 * SIGMA_E), float(n - 1))
        data = "complete" if complete else "missing 2%"
        two_phase = sk.sweep_stale(*args, **kw)
        two_ms, _ = cuda_ms(torch, lambda: sk.sweep_stale(*args, **kw), 5)
        for wt in (W, 16):
            def run():
                return sk.sweep_stale_sd(*args, sub_window=wt, **kw)

            def plain():
                return sk.sweep_stale_sd_ref(*args, sub_window=wt, **kw)

            ms, plain_ms = compare_outputs(
                torch, "sweep_stale_sd", f"W={W} Wt={wt} {data}", run, plain,
                5, tol, card, rec, comp_of=lambda o: o[1][:, 1])
            e_k, o_k = run()
            same = torch.equal(e_k, two_phase[0]) and torch.equal(
                o_k, two_phase[1])
            n_comp = int((o_k[:, 1] != two_phase[1][:, 1]).sum().item())
            print(f"  beside sweep_stale on the same inputs ({two_ms:.4f} ms): "
                  f"comp mismatches {n_comp}, bitwise equal {same}  [{card}]",
                  flush=True)
            if n_comp:
                raise AssertionError("sweep_stale_sd and sweep_stale disagree "
                                     "on components")
            if wt == W and not same:
                raise AssertionError("sweep_stale_sd at one sub-window a "
                                     "window is not sweep_stale bit for bit")
            if wt == 16 and complete:
                # the CLI main path's sub-window (phase 3e)
                r = rec["sweep_stale_sd"]
                r["ms"], r["plain_ms"] = ms, plain_ms
                # as sweep_stale's: packed rows, eps, mrow, order, mask in;
                # eps, out out; the stats and the update one FMA each per
                # genotype
                nbytes = (pk.numel() + 3 * 4 * n_pad + mrow.numel() * 4
                          + 4 * m + 16 * m)
                r["bound_ms"], r["bound_by"] = bound(
                    nbytes, {"f32": 4.0 * m * n_pad})
                print_bound("sweep_stale_sd", r)
        del pk, mrow, two_phase
    return rec


# (name, HYDRA_TPU_SD, extra CLI flags, {kernel: launches per iteration})
SD_RUNS = (("fh_exact", "", ("--mpibayes", "bayesFHMPI"), {"sweep_exact": 1}),
           ("fh_stale", "", ("--mpibayes", "bayesFHMPI", "--stale",
                             "--window", "64"), {"sweep_stale": 1}),
           ("fh_mega_off", "", ("--mpibayes", "bayesFHMPI", "--mega", "off"),
            {"window_stats": 157, "window_gibbs": 157, "window_axpy": 157}),
           ("sd_bayesmpi", "16", ("--stale", "--window", "64", "--schedule",
                                  "marker"), {"sweep_stale_sd": 1}),
           ("sd_fh", "16", ("--mpibayes", "bayesFHMPI", "--stale", "--window",
                            "64", "--schedule", "marker"),
            {"sweep_stale_sd": 1}))


def phase_sd_cli(torch, np, tmp):
    """BayesFH (exact default, --stale --window 64, --mega off) and the
    single-decode stale sweep (HYDRA_TPU_SD=16 --stale --window 64
    --schedule marker, BayesRRm and BayesFH) through the CLI at M=10,000 x
    N=5,000 (phase 3's bed), 20 iterations each (SD_RUNS), each run's
    launches counted on its own; .fh.npz written by the FH runs; then one
    CUDA sweep of each against the CPU sampler with the same state and
    noise."""
    from hydra_tpu_torch import cli
    from hydra_tpu_torch.options import parse_args
    from hydra_tpu_torch.runner import dataset_from_options
    from hydra_tpu_torch.samplers.bayesrrm import (BayesRRm, state_from_numpy,
                                                   state_to_numpy)
    m, iters = 10_000, 20
    base = os.path.join(tmp, "t_M10K_N_5K")
    common = ["--mpibayes", "bayesMPI", "--bfile", base, "--pheno",
              base + ".phen", "--S", "0.0001,0.001,0.01", "--chain-length",
              str(iters), "--thin", "5", "--save", "10", "--seed", "7",
              "--mcmc-out-dir", os.path.join(tmp, "out")]
    total = {}
    for name, sd, extra, per_it in SD_RUNS:
        reset_all_launches()
        t0 = time.perf_counter()
        with sd_env(sd):
            rc = cli.main(common + ["--mcmc-out-name", name, *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in all_launches().items() if v}
        print(f"{name} (HYDRA_TPU_SD={sd or 'unset'} {' '.join(extra)}): exit "
              f"{rc}, {wall:.1f} s wall for {iters} iterations, launches "
              f"{json.dumps(launches)}", flush=True)
        if rc != 0:
            raise AssertionError(f"CLI exit code {rc}")
        want = {k: v * iters for k, v in per_it.items()}
        if launches != want:
            raise AssertionError(f"{name}: launches {launches}, want {want}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        out = os.path.join(tmp, "out", name)
        h2 = check_outputs(np, out, m, iters // 5)
        fh = "bayesFHMPI" in extra
        if os.path.exists(out + ".fh.npz") != fh:
            raise AssertionError(f"{name}: .fh.npz present {not fh}")
        if fh:
            st = np.load(out + ".fh.npz")
            if not (st["lambda_var"].shape == (m,)
                    and np.isfinite(st["lambda_var"]).all()
                    and float(st["tau"]) > 0):
                raise AssertionError(f"{name}: bad .fh.npz")
        print(f"{name}: {iters // 5} thinned records, mean h2 over the last "
              f"{iters // 10} = {h2:.4f} (simulated 0.5)"
              f"{', .fh.npz tau %.4g' % float(st['tau']) if fh else ''}",
              flush=True)

    # one sweep of each, CUDA sampler vs CPU sampler, same state and noise
    for name, sd, extra, _ in SD_RUNS:
        opt = parse_args(common + list(extra))
        ds = dataset_from_options(opt)
        kw = dict(window=opt.window, exact=opt.exact, seed=7, mega=opt.mega,
                  schedule=opt.schedule, fh=opt.bayes_type == "bayesFHMPI")
        with sd_env(sd):
            cpu = BayesRRm(ds, device="cpu", **kw)
            gpu = BayesRRm(ds, device="cuda", **kw)
        s_cpu = cpu.init_state()
        s_gpu = state_from_numpy(state_to_numpy(s_cpu), "cuda")
        g = torch.Generator().manual_seed(5)
        ml = cpu.cfg.m_loc
        shape = torch.full((ml,), 2.0)
        noise = dict(mu=torch.randn((), generator=g),
                     u=torch.rand(ml, generator=g),
                     nrm=torch.randn(ml, generator=g),
                     wperm=torch.randperm(cpu.cfg.n_windows, generator=g),
                     perm=torch.randperm(ml, generator=g),
                     g_nu=torch._standard_gamma(shape, generator=g),
                     g_lam=torch._standard_gamma(shape, generator=g),
                     fh_gamma=torch._standard_gamma(torch.full((1, 3), 3.0),
                                                    generator=g))
        t0 = time.perf_counter()
        a, sa = cpu.step(s_cpu, 0, noise=noise)
        t1 = time.perf_counter()
        b, sb = gpu.step(s_gpu, 0, noise={k: v.cuda() for k, v in noise.items()})
        a, b = state_to_numpy(a), state_to_numpy(b)
        diffs = {f: float(np.abs(a[f] - b[f]).max())
                 for f in ("eps", "beta", "lambda_var", "tau", "c_slab")}
        n_comp = int((a["components"] != b["components"]).sum())
        print(f"one {name} sweep (W={opt.window}, {gpu.cfg.schedule}, "
              f"sub-window {gpu.cfg.sub_window}, fh {gpu.cfg.fh}), CUDA vs CPU"
              f" sampler ({t1 - t0:.1f} s on the CPU): max|d| "
              f"{json.dumps({k: float(f'{v:.3e}') for k, v in diffs.items()})}"
              f"  comp mismatches {n_comp}", flush=True)
        for f in ("eps", "beta", "lambda_var", "nu_var"):
            np.testing.assert_allclose(b[f], a[f], atol=5e-4, rtol=1e-3,
                                       err_msg=f)
        for f in ("tau", "hyp_tau", "c_slab", "sigma_g") if kw["fh"] else ():
            np.testing.assert_allclose(b[f], a[f], rtol=1e-4, err_msg=f)
        if n_comp or not np.array_equal(sa.cass.numpy(), sb.cass.cpu().numpy()):
            raise AssertionError("component mismatches CUDA vs CPU sampler")
    return total


def phase_sd_real_size(torch, np, sk, card):
    """M=100,000 x N=50,000: BayesFH exact W=128 (block schedule) and stale
    W=64 --schedule marker through sweep_stale and through sweep_stale_sd
    (sub-window 64 and 16): ms/sweep, markers/s, busy share, host enqueue,
    device time per kernel."""
    from hydra_tpu_torch.data.genotypes import (Dataset, GenotypeData,
                                                make_default_groups)
    from hydra_tpu_torch.samplers.bayesrrm import BayesRRm
    dev = torch.device("cuda")
    m, n = 100_000, 50_000
    n_pad = padded_individuals(np, n)
    gen = torch.Generator(device=dev).manual_seed(2)
    pk, mave, mstd, nm = device_genotypes(torch, m, n, n_pad, gen)
    mave_h, mstd_h = mave.cpu().numpy(), mstd.cpu().numpy()
    geno = GenotypeData(packed=np.zeros((0, n_pad // 4), np.uint8), n=n,
                        n_pad=n_pad, m=m, mave=mave_h, mstd=mstd_h,
                        msd=1.0 / mstd_h, n1=None, n2=None,
                        nm=nm.cpu().numpy())
    groups, mS = make_default_groups(m, list(MS[1:]))
    y = np.random.RandomState(0).randn(n)
    ds = Dataset(geno=geno, y=y, groups=groups, num_groups=1, mS=mS)
    for label, sd, exact, window, schedule, fh in (
            ("BayesFH exact", "", True, 128, "block", True),
            ("stale sweep_stale", "", False, 64, "marker", False),
            ("stale sweep_stale_sd Wt=64", "64", False, 64, "marker", False),
            ("stale sweep_stale_sd Wt=16", "16", False, 64, "marker", False)):
        torch.cuda.reset_peak_memory_stats()
        with sd_env(sd):
            s = BayesRRm(ds, window=window, exact=exact, seed=1, device=dev,
                         schedule=schedule, fh=fh, packed_device=pk)
        st = s.init_state()
        for it in range(2):
            st, _ = s.step(st, it)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for it in range(2, 5):
            st, stats = s.step(st, it)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 3
        if not bool(torch.isfinite(st.eps).all()):
            raise AssertionError("non-finite residual at real size")
        sg, se = float(st.sigma_g.sum()), float(st.sigma_e)
        print(f"real size M={m:,} x N={n:,} {label} W={window} "
              f"{s.cfg.schedule} (sub-window {s.cfg.sub_window}): {ms:.2f} "
              f"ms/sweep, {m / ms * 1e3:,.0f} markers/s (3 sweeps after 2 "
              f"warm-up), h2 {sg / (sg + se):.4f}, peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB  [{card}]",
              flush=True)
        profile_sweep(torch, sk, s, st, card)
        del s, st
    del pk


# phase 3f's runs: (name, bed written by phases 3-3c, sampler, extra CLI
# flags, covariates, the kernel each sweep launches once)
RESTART_RUNS = (
    ("bayesrrm_exact_cov", "t_M10K_N_5K", "brr", (), True, "sweep_exact"),
    ("bayesrrm_stale", "t_M10K_N_5K", "brr", ("--stale", "--window", "64"),
     False, "sweep_stale"),
    ("bayesfh", "t_M10K_N_5K", "fh", (), False, "sweep_exact"),
    ("bayesw_w1_cov", "weibull_M10K_N_5K", "bw", (), True, "sweep_stale_bw"),
    ("mt_t4_cov", "mt_M10K_N_5K", "mt", (), True, "sweep_exact_mt"))
RESTART_F = 12                    # covariates of phases 3f and 4f


def write_covariates(np, base, n, seed):
    """F=12 standard-normal covariates for a .bed of ``write_plink``, in
    the two formats the readers take: ``<base>.cov`` ("fid pid c1 .. c12",
    every 50th individual "NA" in one covariate: the single-trait readers
    drop it) and ``<base>.csv.cov`` (comma-separated, no IDs, no "NA": the
    multi-trait reader keeps every individual)."""
    rs = np.random.RandomState(seed)
    X = rs.randn(n, RESTART_F)
    with open(base + ".cov", "w") as fh:
        for i in range(n):
            vals = [("NA" if i % 50 == 49 and k == i % RESTART_F
                     else f"{X[i, k]:.8f}") for k in range(RESTART_F)]
            fh.write(f"f{i} i{i} " + " ".join(vals) + "\n")
    with open(base + ".csv.cov", "w") as fh:
        fh.writelines(",".join(f"{v:.8f}" for v in X[i]) + "\n"
                      for i in range(n))


def restart_argv(tmp, bed, model, name, iters, cov, extra, restart=False):
    """CLI arguments of one phase-3f run (thin 5, save 10, seed 7; a
    restart takes the saved seed)."""
    base = os.path.join(tmp, bed)
    argv = ["--bfile", base, "--S", "0.0001,0.001,0.01", "--chain-length",
            str(iters), "--thin", "5", "--save", "10", "--mcmc-out-dir",
            os.path.join(tmp, "out_restart"), "--mcmc-out-name", name]
    if not restart:
        argv += ["--seed", "7"]
    if model == "bw":
        argv += ["--mpibayes", "bayesWMPI", "--pheno", base + ".phen",
                 "--failure", base + ".fail"]
    elif model == "mt":
        argv += ["--mpibayes", "bayesMPI", "--pheno",
                 ",".join(f"{base}.t{t}.phen" for t in range(4))]
    else:
        argv += ["--mpibayes", "bayesFHMPI" if model == "fh" else "bayesMPI",
                 "--pheno", base + ".phen"]
    if cov:
        argv += ["--covariates",
                 base + (".csv.cov" if model == "mt" else ".cov")]
    return argv + list(extra) + (["--restart"] if restart else [])


def covariate_noise(torch, g, F, shape, slice_noise=False):
    """The covariates' permutation and draws of one sweep from generator
    ``g``: normals of ``shape`` (BayesRRm (F,), multi-trait (F, T)), or
    BayesW's slice noise (le (F,), ub (F,), uu (24, F))."""
    noise = dict(covperm=torch.randperm(F, generator=g))
    if slice_noise:
        noise["cov"] = (torch.empty(F).exponential_(generator=g),
                        torch.rand(F, generator=g),
                        torch.rand(24, F, generator=g))
    else:
        noise["cov"] = torch.randn(shape, generator=g)
    return noise


def check_cov_sweeps(torch, np, tmp):
    """One sweep with F=12 covariates of each sampler (BayesRRm exact,
    BayesW W=64, multi-trait T=4), CUDA sampler against CPU sampler with
    the same state and noise: eps, beta and gamma within atol 5e-4 / rtol
    1e-3, components equal."""
    from hydra_tpu_torch.options import parse_args
    from hydra_tpu_torch.runner import (dataset_from_options,
                                        mt_dataset_from_options)
    from hydra_tpu_torch.samplers import bayesrrm, bayesrrm_mt, bayesw
    for model, bed, window in (("brr", "t_M10K_N_5K", 64),
                               ("bw", "weibull_M10K_N_5K", 64),
                               ("mt", "mt_M10K_N_5K", 64)):
        opt = parse_args(restart_argv(tmp, bed, model, "x", 1, True,
                                      ("--window", str(window))))
        g = torch.Generator().manual_seed(9)
        if model == "mt":
            ds, ph = mt_dataset_from_options(opt)
            mod = bayesrrm_mt

            def make(dev):
                return bayesrrm_mt.BayesRRmMT(ds, ph, window=window,
                                              exact=True, seed=7, device=dev)
        elif model == "bw":
            ds = dataset_from_options(opt)
            mod = bayesw

            def make(dev):
                return bayesw.BayesW(ds, window=window, seed=7, device=dev)
        else:
            ds = dataset_from_options(opt)
            mod = bayesrrm

            def make(dev):
                return bayesrrm.BayesRRm(ds, window=window, exact=True,
                                         seed=7, device=dev)
        cpu, gpu = make("cpu"), make("cuda")
        ml, T = cpu.cfg.m_loc, 4
        if model == "bw":
            noise = dict(u=torch.rand(ml, generator=g),
                         le=torch.empty(ml).exponential_(generator=g),
                         ub=torch.rand(ml, generator=g),
                         uu=torch.rand(ml, 24, generator=g),
                         wperm=torch.randperm(cpu.cfg.n_windows, generator=g))
            for k in ("mu", "alpha"):
                noise[k] = (torch.empty(()).exponential_(generator=g),
                            torch.rand((), generator=g),
                            torch.rand(24, generator=g))
            noise.update(covariate_noise(torch, g, RESTART_F, None, True))
        else:
            shape = (ml, T) if model == "mt" else (ml,)
            noise = dict(mu=torch.randn(shape[1:], generator=g),
                         u=torch.rand(shape, generator=g),
                         nrm=torch.randn(shape, generator=g),
                         wperm=torch.randperm(cpu.cfg.n_windows, generator=g),
                         perm=torch.randperm(ml, generator=g))
            noise.update(covariate_noise(
                torch, g, RESTART_F,
                (RESTART_F, T) if model == "mt" else (RESTART_F,)))
        s_cpu = cpu.init_state()
        s_cpu.gamma = torch.randn(s_cpu.gamma.shape, generator=g) * 0.1
        s_gpu = mod.state_from_numpy(mod.state_to_numpy(s_cpu), "cuda")

        def to(d, dev):
            return {k: (tuple(t.to(dev) for t in v) if isinstance(v, tuple)
                        else v.to(dev)) for k, v in d.items()}

        a, _ = cpu.step(s_cpu, 0, noise=noise)
        b, _ = gpu.step(s_gpu, 0, noise=to(noise, "cuda"))
        a, b = mod.state_to_numpy(a), mod.state_to_numpy(b)
        d = {k: float(np.abs(a[k] - b[k]).max()) for k in ("eps", "beta",
                                                            "gamma")}
        n_comp = int((a["components"] != b["components"]).sum())
        print(f"one {model} sweep W={window} with {RESTART_F} covariates, "
              f"CUDA vs CPU sampler: max|d eps| {d['eps']:.3e}  max|d beta| "
              f"{d['beta']:.3e}  max|d gamma| {d['gamma']:.3e}  comp "
              f"mismatches {n_comp}", flush=True)
        for k in ("eps", "beta", "gamma"):
            np.testing.assert_allclose(b[k], a[k], atol=5e-4, rtol=1e-3,
                                       err_msg=k)
        if n_comp:
            raise AssertionError("component mismatches CUDA vs CPU sampler")


def covariate_ms(torch, make, iters=5):
    """ms/sweep by CUDA events of ``make(with_covariates)``'s sampler, with
    and without covariates, after one warm-up sweep each."""
    out = []
    for cov in (True, False):
        s = make(cov)
        st, _ = s.step(s.init_state(), 0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for it in range(1, iters + 1):
            st, _ = s.step(st, it)
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
        del s, st
    return out


def phase_restart_cli(torch, np, tmp, card):
    """Restart and covariates through the CLI at M=10,000 x N=5,000 on the
    beds of phases 3, 3b and 3c with F=12 covariates (write_covariates):
    for each of RESTART_RUNS a full run of 30 iterations, a run cut at 15
    and a --restart of it to 30 (no --seed); every record the restarted
    run wrote must equal the full run's bytes (compare_runs of
    scripts/soak_restart_torch.py: csv rows, .bet, .cpn, .acu, .mus.0,
    .gam.0 / .gam rows, the last .eps.0); each run's kernel launched once
    a sweep. Then one CUDA sweep with covariates of each sampler against
    the CPU sampler, and BayesRRm's and BayesW's ms/sweep with and without
    the covariates."""
    import dataclasses
    from hydra_tpu_torch import cli
    from hydra_tpu_torch.options import parse_args
    from hydra_tpu_torch.runner import dataset_from_options
    from hydra_tpu_torch.samplers.bayesrrm import BayesRRm
    from hydra_tpu_torch.samplers.bayesw import BayesW
    from scripts import soak_restart_torch as soak
    m, n, full, cut = 10_000, 5_000, 30, 15
    for bed, seed in (("t_M10K_N_5K", 21), ("weibull_M10K_N_5K", 22),
                      ("mt_M10K_N_5K", 23)):
        write_covariates(np, os.path.join(tmp, bed), n, seed)
    for name, bed, model, extra, cov, kernel in RESTART_RUNS:
        out = os.path.join(tmp, "out_restart")
        t0 = time.perf_counter()
        reset_all_launches()
        rc = [cli.main(restart_argv(tmp, bed, model, name + "_full", full,
                                    cov, extra))]
        torch.cuda.synchronize()
        launches = all_launches()[kernel]
        rc.append(cli.main(restart_argv(tmp, bed, model, name, cut, cov,
                                        extra)))
        rc.append(cli.main(restart_argv(tmp, bed, model, name, full, cov,
                                        extra, restart=True)))
        torch.cuda.synchronize()
        if rc != [0, 0, 0]:
            raise AssertionError(f"{name}: CLI exit codes {rc}")
        if launches != full:
            raise AssertionError(f"{name}: {kernel} launched {launches} "
                                 f"times in {full} sweeps")
        sfx = [f".t{t}" for t in range(4)] if model == "mt" else [""]
        for s in sfx:
            its = soak.compare_runs(os.path.join(out, name + "_full" + s),
                                    os.path.join(out, name + "_rs" + s), m,
                                    survival=model == "bw", covariates=cov)
            if its != [15, 20, 25]:
                raise AssertionError(f"{name}{s}: compared iterations {its}")
        print(f"{name}: restart from iteration 10 byte-identical to the "
              f"uninterrupted run at iterations {its} ({len(sfx)} file "
              f"set{'s' if len(sfx) > 1 else ''}: csv, .bet, .cpn, "
              f"{'' if model == 'bw' else '.acu, '}.mus.0"
              f"{', gamma' if cov else ''}, .eps.0); {kernel} {launches} "
              f"launches in {full} sweeps; "
              f"{time.perf_counter() - t0:.1f} s wall", flush=True)
    check_cov_sweeps(torch, np, tmp)
    for model, bed in (("brr", "t_M10K_N_5K"), ("bw", "weibull_M10K_N_5K")):
        opt = parse_args(restart_argv(tmp, bed, model, "x", 1, True, ()))
        ds = dataset_from_options(opt)

        def make(cov):
            d = ds if cov else dataclasses.replace(ds, X=None)
            if model == "bw":
                return BayesW(d, window=1, seed=7, device="cuda")
            return BayesRRm(d, window=opt.window, exact=True, seed=7,
                            device="cuda")
        with_cov, without = covariate_ms(torch, make)
        print(f"{'BayesW W=1' if model == 'bw' else 'BayesRRm exact W=64'} "
              f"M={ds.geno.m:,} x N={ds.geno.n:,}: {with_cov:.2f} ms/sweep with "
              f"{RESTART_F} covariates, {without:.2f} without, "
              f"{with_cov - without:.2f} ms a sweep for the covariates "
              f"(CUDA events, 5 sweeps)  [{card}]", flush=True)


# phase 4f: BayesRRm exact W=128 block with F=12 covariates at M=100,000 x
# N=50,000, production cadence; the SIGKILL lands once the csv shows 36
REAL_RESTART = dict(iters=60, kill_at=36, thin=5, save=10, window=128)


def real_size_covariates(np, n, seed=12):
    """(n, F=12) standard-normal covariates of phase 4f, from ``seed``."""
    return np.random.RandomState(seed).randn(n, RESTART_F)


def real_restart_options(out, name, restart=False):
    """Options of a phase-4f run. The dataset is made in memory
    (real_size_dataset, real_size_covariates), so no file is read; the
    covariate flag turns on gamma's outputs and their restart."""
    from hydra_tpu_torch.options import parse_args
    r = REAL_RESTART
    opt = parse_args(
        ["--mpibayes", "bayesMPI", "--bfile", "in-memory", "--pheno",
         "in-memory.phen", "--S", ",".join(str(v) for v in MS[1:]),
         "--chain-length", str(r["iters"]), "--thin", str(r["thin"]),
         "--save", str(r["save"]), "--window", str(r["window"]),
         "--mcmc-out-dir", out, "--mcmc-out-name", name, "--device", "cuda"]
        + (["--restart"] if restart else ["--seed", "7"]))
    opt.covariates, opt.covariates_file = True, "in-memory"
    return opt


def real_restart_dataset(torch, np):
    """real_size_dataset's M=100,000 x N=50,000 with real_size_covariates:
    the same bytes in every process, made from their seeds on the card."""
    import dataclasses
    ds, pk = real_size_dataset(torch, np)
    return dataclasses.replace(ds, X=real_size_covariates(np, ds.geno.n)), pk


def restart_child(args):
    """A phase-4f chain in a process of its own (``chip_smoke.py
    --restart-child '{"out": ..., "name": ..., "restart": ...}'``): the
    dataset made anew, then run_bayesrrm. Its last line is a JSON record
    with the time the first sweep ended (time.time(), after a synchronize)
    and the chain's and the writer's seconds."""
    import torch
    import numpy as np
    sys.path.insert(0, REPO)
    from hydra_tpu_torch.runner import run_bayesrrm
    from hydra_tpu_torch.samplers import bayesrrm

    first = {}
    step = bayesrrm.BayesRRm.step

    def timed_step(self, state, it, noise=None):
        out = step(self, state, it, noise)
        if not first:
            torch.cuda.synchronize()
            first.update(it=it, at=time.time())
        return out

    bayesrrm.BayesRRm.step = timed_step
    ds, pk = real_restart_dataset(torch, np)
    opt = real_restart_options(args["out"], args["name"], args["restart"])
    res = run_bayesrrm(opt, dataset=ds, packed_device=pk)
    print(json.dumps(dict(first_it=first["it"], first_at=first["at"],
                          total_s=res["total_seconds"],
                          write_s=res["write_seconds"])), flush=True)
    return 0


def phase_restart_real_size(torch, np, card):
    """One full-width restart: BayesRRm exact W=128 block with F=12
    covariates at M=100,000 x N=50,000 (complete genotypes, 1.25 GB packed,
    made on the card from its seed in each process), thin 5, save 10. ms a
    sweep by CUDA events with and without the covariates; an uninterrupted
    run of 60 sweeps here (its writer's share of the chain's wall); a run
    in a child process SIGKILLed once its csv shows iteration >= 36; a
    --restart of it in another child (the seconds from its start to its
    first sweep); then every record after the restart byte for byte the
    uninterrupted run's (compare_runs)."""
    import dataclasses
    from hydra_tpu_torch.runner import run_bayesrrm
    from hydra_tpu_torch.samplers.bayesrrm import BayesRRm
    from scripts import soak_restart_torch as soak
    r = REAL_RESTART
    ds, pk = real_restart_dataset(torch, np)
    m = ds.geno.m
    dev = torch.device("cuda")

    def make(cov):
        d = ds if cov else dataclasses.replace(ds, X=None)
        return BayesRRm(d, window=r["window"], exact=True, seed=1,
                        device=dev, packed_device=pk)

    with_cov, without = covariate_ms(torch, make, iters=10)
    print(f"real size M=100,000 x N=50,000 exact W={r['window']} block: "
          f"{with_cov:.2f} ms/sweep with {RESTART_F} covariates, "
          f"{without:.2f} without: {with_cov - without:.3f} ms a sweep for "
          f"the covariate sweep (CUDA events, 10 sweeps after 1 warm-up)  "
          f"[{card}]", flush=True)
    with tempfile.TemporaryDirectory() as work:
        out = os.path.join(work, "out")
        t0 = time.perf_counter()
        res = run_bayesrrm(real_restart_options(out, "full"), dataset=ds,
                           packed_device=pk, verbose=False)
        wall = time.perf_counter() - t0
        share = res["write_seconds"] / res["total_seconds"]
        print(f"uninterrupted run: {r['iters']} sweeps, {wall:.2f} s wall "
              f"(set-up included), chain {res['total_seconds']:.2f} s, "
              f"writer {res['write_seconds']:.3f} s = {100 * share:.1f}% of "
              f"the chain's wall (thin {r['thin']}, save {r['save']})  "
              f"[{card}]", flush=True)
        del res, ds, pk
        torch.cuda.empty_cache()

        def child(name, restart):
            return [sys.executable, os.path.join(REPO, "chip_smoke.py"),
                    "--restart-child", json.dumps(dict(
                        out=out, name=name, restart=restart))]

        t0 = time.perf_counter()
        seen = soak.run_killed(child("cut", False),
                               os.path.join(out, "cut.csv"), r["kill_at"],
                               os.path.join(work, "cut.log"), timeout=600)
        print(f"cut run SIGKILLed at csv iteration {seen} "
              f"({time.perf_counter() - t0:.1f} s after its start)",
              flush=True)
        t_spawn = time.time()
        proc = subprocess.run(child("cut", True), cwd=REPO,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError("restarted run failed:\n"
                                 + proc.stdout[-3000:] + proc.stderr[-3000:])
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        its = soak.compare_runs(os.path.join(out, "full"),
                                os.path.join(out, "cut_rs"), m,
                                covariates=True)
        if rec["first_it"] <= 30 or its[0] < rec["first_it"]:
            raise AssertionError(f"restart resumed at {rec['first_it']}, "
                                 f"compared {its}")
    print(f"restart: first sweep (iteration {rec['first_it']}) done "
          f"{rec['first_at'] - t_spawn:.2f} s after the process started "
          f"(data made on the card, kernels loaded); writer "
          f"{100 * rec['write_s'] / rec['total_s']:.1f}% of its chain's wall;"
          f" records at iterations {its} (csv, .bet, .cpn, .acu, .mus.0, "
          f".gam.0, .eps.0) byte-identical to the uninterrupted run "
          f"(M={m:,})  [{card}]", flush=True)


# ---- phases 3g and 4g: the remaining single-device paths ----------------

@contextlib.contextmanager
def step_events(torch):
    """CUDA events around every sweep of the three samplers while the block
    runs; yields the list of (start, stop) event pairs."""
    from hydra_tpu_torch.samplers import bayesrrm, bayesrrm_mt, bayesw
    pairs, saved = [], []
    for cls in (bayesrrm.BayesRRm, bayesrrm_mt.BayesRRmMT, bayesw.BayesW):
        step = cls.step

        def timed(self, state, it, noise=None, step=step):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = step(self, state, it, noise)
            b.record()
            pairs.append((a, b))
            return out

        saved.append((cls, step))
        cls.step = timed
    try:
        yield pairs
    finally:
        for cls, step in saved:
            cls.step = step


def events_ms(torch, pairs, skip=2):
    """Mean ms a sweep from step_events' pairs, the first ``skip`` left
    out (warm-up)."""
    torch.cuda.synchronize()
    ts = [a.elapsed_time(b) for a, b in pairs[skip:]]
    return sum(ts) / len(ts)


# phase 3g's CLI runs at M=10,000 x N=5,000: (name, bed, model, extra
# flags, {kernel: launches a sweep, "W" meaning one a window of W=64})
NEW_PATH_RUNS = (
    ("mt_stale_w1", "mt_M10K_N_5K", "mt", ("--stale",),
     {"sweep_stale_mt": 1}),
    ("mt_exact_w4", "mt_M10K_N_5K", "mt", ("--window", "4"),
     {"sweep_exact_mt": 1}),
    ("mt_off_stale", "mt_M10K_N_5K", "mt",
     ("--mega", "off", "--stale", "--window", "64"),
     {"window_stats_mt": "W", "window_axpy_mt": "W"}),
    ("mt_off_exact", "mt_M10K_N_5K", "mt", ("--mega", "off"),
     {"window_stats_mt": "W", "mt_window_recurrence": "W",
      "window_axpy_mt": "W"}),
    ("bw_off_w64", "weibull_M10K_N_5K", "bw",
     ("--mega", "off", "--window", "64"),
     {"window_level_sums": "W", "window_axpy": "W"}),
    ("f64_exact", "t_M10K_N_5K", "brr", ("--dtype", "float64"), {}),
    ("f64_stale", "t_M10K_N_5K", "brr",
     ("--dtype", "float64", "--stale", "--window", "64"), {}),
    ("fh_f64_exact", "t_M10K_N_5K", "fh", ("--dtype", "float64"), {}),
    ("fh_f64_stale", "t_M10K_N_5K", "fh",
     ("--dtype", "float64", "--stale", "--window", "64"), {}))
SAVE_KILL = dict(iters=30, save_at=20, op=7)   # the 7th file of save 20
NEW_PATH_M = 10_000                            # markers of phase 3g's beds


def new_path_argv(tmp, bed, model, name, iters, extra, restart=False):
    """CLI arguments of a phase-3g run (thin 5, save 10, seed 7)."""
    argv = restart_argv(tmp, bed, model, name, iters, False, extra,
                        restart=restart)
    i = argv.index("--mcmc-out-dir")
    argv[i + 1] = os.path.join(tmp, "out_new")
    return argv


def save_kill_child(args):
    """A phase-3g chain in a process of its own (``chip_smoke.py
    --save-kill-child JSON``) that SIGKILLs itself inside the save at
    ``save_at``: at its ``op``-th file, the old generation renamed to
    .prev and the new one not yet written."""
    import signal
    sys.path.insert(0, REPO)
    from hydra_tpu_torch import cli
    from hydra_tpu_torch.outputs import writers
    state = dict(armed=False, n=0)
    on_save, replace = writers.McmcWriter.on_save, writers.McmcWriter._replace

    def armed_save(self, it, *a, **k):
        state["armed"] = state["armed"] or it == args["save_at"]
        return on_save(self, it, *a, **k)

    def killing_replace(self, ext, data):
        if state["armed"]:
            state["n"] += 1
            if state["n"] == args["op"]:
                os.replace(self.base + ext, self.base + ext + writers.PREV)
                os.kill(os.getpid(), signal.SIGKILL)
        return replace(self, ext, data)

    writers.McmcWriter.on_save = armed_save
    writers.McmcWriter._replace = killing_replace
    return cli.main(args["argv"])


def new_path_sweeps(torch, np, tmp):
    """One CUDA sweep of each new path against the CPU sampler on the same
    state and noise (M=1,000 x N=5,000: the CPU side runs the plain
    versions): multi-trait W=1 stale, W=4 exact, --mega off stale and
    exact, BayesW --mega off W=64, and float64 BayesRRm exact and stale.
    float32 within atol 5e-4 / rtol 1e-3, float64 within rtol 1e-9;
    components equal."""
    from hydra_tpu_torch.options import parse_args
    from hydra_tpu_torch.runner import (dataset_from_options,
                                        mt_dataset_from_options)
    from hydra_tpu_torch.samplers import bayesrrm, bayesrrm_mt, bayesw
    m, n, T = 1_000, 5_000, 4
    base = os.path.join(tmp, "sm_M1K_N_5K")
    write_plink(np, base, m, n, seed=31)
    phen = write_mt_phenos(np, base, m, n, T, seed=32, na_frac=0.05)
    wbase = os.path.join(tmp, "smw_M1K_N_5K")
    write_plink(np, wbase, m, n, seed=33, weibull=True)
    cases = (("mt W=1 stale", "mt", dict(window=1, exact=False)),
             ("mt W=4 exact", "mt", dict(window=4, exact=True)),
             ("mt --mega off stale", "mt", dict(window=64, exact=False,
                                                mega="off")),
             ("mt --mega off exact", "mt", dict(window=64, exact=True,
                                                mega="off")),
             ("BayesW --mega off W=64", "bw", dict(window=64, mega="off",
                                                   quad_points=25)),
             ("float64 exact W=64", "brr", dict(window=64, exact=True,
                                                dtype="float64")),
             ("float64 stale W=64", "brr", dict(window=64, exact=False,
                                                dtype="float64")))
    for label, model, kw in cases:
        g = torch.Generator().manual_seed(5)
        if model == "mt":
            opt = parse_args(["--bfile", base, "--pheno", phen])
            ds, phenos = mt_dataset_from_options(opt)
            mod = bayesrrm_mt

            def make(dev, ds=ds, phenos=phenos, kw=kw):
                return bayesrrm_mt.BayesRRmMT(ds, phenos, seed=7, device=dev,
                                              **kw)
        elif model == "bw":
            opt = parse_args(["--mpibayes", "bayesWMPI", "--bfile", wbase,
                              "--pheno", wbase + ".phen", "--failure",
                              wbase + ".fail"])
            ds = dataset_from_options(opt)
            mod = bayesw

            def make(dev, ds=ds, kw=kw):
                return bayesw.BayesW(ds, seed=7, device=dev, **kw)
        else:
            opt = parse_args(["--bfile", base, "--pheno", base + ".phen"])
            ds = dataset_from_options(opt)
            mod = bayesrrm

            def make(dev, ds=ds, kw=kw):
                return bayesrrm.BayesRRm(ds, seed=7, device=dev, **kw)
        cpu, gpu = make("cpu"), make("cuda")
        s_cpu = cpu.init_state()
        ml = cpu.cfg.m_loc
        if model == "mt":
            noise = dict(mu=torch.randn(T, generator=g),
                         u=torch.rand(ml, T, generator=g),
                         nrm=torch.randn(ml, T, generator=g),
                         perm=torch.randperm(ml, generator=g))
        elif model == "bw":
            from hydra_tpu_torch.utils.slice_sampler import slice_noise
            noise = dict(cpu.slot_noise(3),
                         perm=torch.randperm(ml, generator=g),
                         mu=slice_noise(g, (), 24),
                         alpha=slice_noise(g, (), 24))
        else:
            dt = cpu.dt
            noise = dict(mu=torch.randn((), generator=g, dtype=dt),
                         u=torch.rand(ml, generator=g, dtype=dt),
                         nrm=torch.randn(ml, generator=g, dtype=dt),
                         perm=torch.randperm(ml, generator=g))
        dt = getattr(cpu, "dt", torch.float32)
        s_gpu = mod.state_from_numpy(mod.state_to_numpy(s_cpu), "cuda",
                                     **({"dtype": dt} if model == "brr"
                                        else {}))
        before = all_launches()
        a, _ = cpu.step(s_cpu, 3, noise=noise)
        if all_launches() != before:
            raise AssertionError(f"{label}: the CPU sweep launched kernels")
        b, _ = gpu.step(s_gpu, 3, noise={
            k: (v.cuda() if torch.is_tensor(v) else tuple(x.cuda() for x in v))
            for k, v in noise.items()})
        a, b = mod.state_to_numpy(a), mod.state_to_numpy(b)
        tol = (dict(rtol=1e-9, atol=1e-9) if dt == torch.float64
               else dict(atol=5e-4, rtol=1e-3))
        d_eps = float(np.abs(a["eps"] - b["eps"]).max())
        n_comp = int((a["components"] != b["components"]).sum())
        print(f"one {label} sweep ({gpu.cfg.schedule}), CUDA vs CPU "
              f"sampler: max|d eps| {d_eps:.3e}  max|d beta| "
              f"{float(np.abs(a['beta'] - b['beta']).max()):.3e}  comp "
              f"mismatches {n_comp}", flush=True)
        np.testing.assert_allclose(b["eps"], a["eps"], **tol)
        np.testing.assert_allclose(b["beta"], a["beta"], **tol)
        if n_comp:
            raise AssertionError(f"{label}: component mismatches")


def phase_new_paths_cli(torch, np, tmp, card):
    """The paths this slice adds, through the CLI at M=10,000 x N=5,000 on
    the beds of phases 3, 3b and 3c, 12 iterations each (NEW_PATH_RUNS):
    ms/sweep by CUDA events (sweeps 2..11) and each run's launches, held to
    one a sweep or one a window (float64: none); then --bed-to-sparse and
    a stale W=64 chain from the sparse files, whose .csv and .bet are the
    .bed chain's bytes; --check-RAM; a multi-trait T=4 stale W=64 chain
    SIGKILLed inside its save at 20 (SAVE_KILL) and restarted, every
    record after the restart byte for byte the uninterrupted chain's; and
    one CUDA sweep of each new path against the CPU sampler
    (new_path_sweeps). Returns the launches."""
    from hydra_tpu_torch import cli
    from hydra_tpu_torch.diag.ramcheck import check_ram_usage
    from hydra_tpu_torch.options import parse_args
    from scripts import soak_restart_torch as soak
    m, iters = NEW_PATH_M, 12
    out = os.path.join(tmp, "out_new")
    total = {}
    for name, bed, model, extra, per in NEW_PATH_RUNS:
        reset_all_launches()
        with step_events(torch) as pairs:
            t0 = time.perf_counter()
            rc = cli.main(new_path_argv(tmp, bed, model, name, iters, extra))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ms = events_ms(torch, pairs)
        launches = {k: v for k, v in all_launches().items() if v}
        if rc != 0:
            raise AssertionError(f"{name}: CLI exit code {rc}")
        win = -(-m // 64)
        want = {k: iters * (win if v == "W" else v) for k, v in per.items()}
        if launches != want:
            raise AssertionError(f"{name}: launches {launches}, want {want}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        sfx = [f".t{t}" for t in range(4)] if model == "mt" else [""]
        vals = [check_outputs(np, os.path.join(out, name + s), m, 3,
                              survival=model == "bw") for s in sfx]
        print(f"{name} ({' '.join(extra)}): {ms:.2f} ms/sweep by CUDA "
              f"events ({iters - 2} sweeps after 2), {wall:.1f} s wall with "
              f"data load, launches {json.dumps(launches)}; "
              f"{'alpha' if model == 'bw' else 'h2'} "
              f"{[round(v, 4) for v in vals]}  [{card}]", flush=True)

    # sparse files: written from the .bed, then a chain from them alone
    base = os.path.join(tmp, "t_M10K_N_5K")
    sd = os.path.join(tmp, "sparse")
    os.makedirs(sd, exist_ok=True)
    t0 = time.perf_counter()
    if cli.main(["--bfile", base, "--bed-to-sparse", "--sparse-dir", sd,
                 "--sparse-basename", "t"]) != 0:
        raise AssertionError("--bed-to-sparse failed")
    conv = time.perf_counter() - t0
    stale = ("--stale", "--window", "64")
    argv = new_path_argv(tmp, "t_M10K_N_5K", "brr", "from_bed", iters, stale)
    rc = [cli.main(argv)]
    i = argv.index("--bfile")
    argv[i:i + 2] = ["--sparse-dir", sd, "--sparse-basename", "t"]
    argv[argv.index("--mcmc-out-name") + 1] = "from_sparse"
    rc.append(cli.main(argv))
    if rc != [0, 0]:
        raise AssertionError(f"sparse runs: exit codes {rc}")
    for ext in (".csv", ".bet", ".cpn", ".xbet"):
        a = open(os.path.join(out, "from_bed" + ext), "rb").read()
        if a != open(os.path.join(out, "from_sparse" + ext), "rb").read():
            raise AssertionError(f"the sparse run's {ext} differs from the "
                                 ".bed run's")
    print(f"--bed-to-sparse: {conv:.1f} s for M={m:,}; the chain from the "
          "sparse files wrote the .bed chain's .csv, .bet, .cpn and .xbet "
          "byte for byte", flush=True)
    est = check_ram_usage(parse_args(new_path_argv(
        tmp, "t_M10K_N_5K", "brr", "ram", iters, ("--check-RAM",))))
    if not 0 < est["total"] < est["budget"]:
        raise AssertionError(f"--check-RAM: {est}")

    # a SIGKILL inside a save, then --restart
    sk = SAVE_KILL
    stale_mt = ("--stale", "--window", "64")
    rc = cli.main(new_path_argv(tmp, "mt_M10K_N_5K", "mt", "kill_full",
                                sk["iters"], stale_mt))
    child = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"),
         "--save-kill-child", json.dumps(dict(
             save_at=sk["save_at"], op=sk["op"], argv=new_path_argv(
                 tmp, "mt_M10K_N_5K", "mt", "kill", sk["iters"],
                 stale_mt)))], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    if child.returncode != -9:
        raise AssertionError(f"the child was to die by SIGKILL, exit "
                             f"{child.returncode}: {child.stderr[-2000:]}")
    left = sorted(f for f in os.listdir(out) if f.startswith("kill.")
                  and f.endswith(".prev"))
    rc2 = cli.main(new_path_argv(tmp, "mt_M10K_N_5K", "mt", "kill",
                                 sk["iters"], stale_mt, restart=True))
    if [rc, rc2] != [0, 0]:
        raise AssertionError(f"save-kill runs: exit codes {[rc, rc2]}")
    for t in range(4):
        its = soak.compare_runs(os.path.join(out, f"kill_full.t{t}"),
                                os.path.join(out, f"kill_rs.t{t}"), m)
        if its != [15, 20, 25]:
            raise AssertionError(f"trait {t}: compared iterations {its}")
    print(f"multi-trait T=4 stale W=64: SIGKILL inside the save at "
          f"{sk['save_at']} (its file {sk['op']} renamed aside, the new one "
          f"unwritten; {len(left)} .prev files left), --restart from 10 "
          f"byte-identical to the uninterrupted chain at {its} on every "
          "trait (csv, .bet, .cpn, .acu, .mus.0, .eps.0)", flush=True)
    new_path_sweeps(torch, np, tmp)
    return total


def slice_markers(ds, pk, m):
    """The first ``m`` markers of a real-size Dataset and its packed rows
    on the card (the same width N)."""
    import dataclasses
    g = ds.geno
    geno = dataclasses.replace(g, m=m, mave=g.mave[:m], mstd=g.mstd[:m],
                               msd=g.msd[:m], nm=g.nm[:m])
    return dataclasses.replace(ds, geno=geno, groups=ds.groups[:m]), pk[:m]


def phase_new_paths_real_size(torch, np, card, m_profile=2_500):
    """The new paths at full width, M=25,000 x N=50,000 (genotypes made on
    the card; at M=100,000 this phase took 95.4 s of a smoke that came
    within 18 s of its limit): multi-trait T=4 --mega off stale W=64 and
    --stale W=1,
    BayesW --mega off W=64 and float64 stale W=64 (BayesRRm). For each,
    ms/sweep by host clock after a synchronize (one warm-up sweep), the
    wrappers' launches of a timed sweep, --check-RAM's estimate beside
    torch.cuda.max_memory_allocated, and the device's busy share from one
    profiled sweep of the first ``m_profile`` markers (the same width and
    windows: these paths' windows all cost the same, and a profile of a
    whole per-window sweep holds up to 600,000 kernels)."""
    import dataclasses
    from hydra_tpu_torch.diag.ramcheck import estimate_bytes
    from hydra_tpu_torch.samplers.bayesrrm import BayesRRm
    from hydra_tpu_torch.samplers.bayesrrm_mt import BayesRRmMT
    from hydra_tpu_torch.samplers.bayesw import BayesW
    dev = torch.device("cuda")
    m, n, T = 25_000, 50_000, 4
    ds, pk = real_size_dataset(torch, np, m=m)
    phen = mt_phenotypes(np, n, T, 4)
    rs = np.random.RandomState(2)
    ds_w = dataclasses.replace(
        ds, y=4.0 + (np.log(rs.exponential(1.0, n)) + EULER_MASCHERONI) / 8.0,
        fail=(rs.random_sample(n) > 0.1).astype(np.float64))
    runs = (
        ("mt T=4 --mega off stale W=64", lambda d, p: BayesRRmMT(
            d, phen, window=64, exact=False, seed=1, mega="off", device=dev,
            packed_device=p), 2, ds, dict(window=64, n_traits=T,
                                          mega="off")),
        ("mt T=4 --stale W=1", lambda d, p: BayesRRmMT(
            d, phen, window=1, exact=False, seed=1, device=dev,
            packed_device=p), 2, ds, dict(window=1, n_traits=T)),
        ("BayesW --mega off W=64", lambda d, p: BayesW(
            d, window=64, seed=2, quad_points=25, mega="off", device=dev,
            packed_device=p), 1, ds_w, dict(window=64, model="bayesWMPI",
                                            mega="off")),
        ("float64 stale W=64", lambda d, p: BayesRRm(
            d, window=64, exact=False, seed=1, dtype="float64", device=dev,
            packed_device=p), 2, ds, dict(window=64, dtype="float64")))
    for label, make, n_time, data, est_kw in runs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        s = make(data, pk)
        st = s.init_state()
        st, _ = s.step(st, 0)
        torch.cuda.synchronize()
        reset_all_launches()
        t0 = time.perf_counter()
        for it in range(1, 1 + n_time):
            st, _ = s.step(st, it)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n_time
        counted = {k: v // n_time for k, v in all_launches().items() if v}
        if not bool(torch.isfinite(st.eps).all()):
            raise AssertionError(f"{label}: non-finite residual")
        peak = torch.cuda.max_memory_allocated() - base_mem
        est = estimate_bytes(m, n, k=4, **est_kw)
        print(f"real size M={m:,} x N={n:,} {label} ({s.cfg.schedule}): "
              f"{ms:.1f} ms/sweep ({n_time} after 1), the wrappers' "
              f"launches a sweep {json.dumps(counted)}; peak "
              f"{peak / 1e9:.2f} GB beside the packed rows already on the "
              f"card ({pk.numel() / 1e9:.2f} GB); --check-RAM estimate "
              f"{est['total'] / 1e9:.2f} GB (geno {est['geno'] / 1e9:.2f} + "
              f"staging {est['staging'] / 1e9:.2f} + the rest "
              f"{(est['total'] - est['geno'] - est['staging']) / 1e9:.2f})"
              f"  [{card}]", flush=True)
        del s, st
        # the busy share from one profiled sweep of the first m_profile
        # markers, timed by the host clock beside it
        s = make(*slice_markers(data, pk, m_profile))
        st, _ = s.step(s.init_state(), 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.step(st, 1)
        torch.cuda.synchronize()
        part_ms = (time.perf_counter() - t0) * 1e3
        per = device_times(torch, lambda: s.step(st, 2), label)
        busy = sum(v[1] for v in per.values())
        print(f"  one sweep of the first {m_profile:,} markers: "
              f"{part_ms:.1f} ms, {sum(v[0] for v in per.values())} device "
              f"kernels, device time {busy:.1f} ms = "
              f"{100.0 * busy / part_ms:.1f}% busy  [{card}]", flush=True)
        for k, (cnt, dms) in sorted(per.items(), key=lambda kv: -kv[1][1])[:5]:
            print(f"    {dms:9.3f} ms  {cnt:7d} x  {k[:90]}", flush=True)
        del s, st
        torch.cuda.empty_cache()
    del pk



# ---- phase 3h: marker shards, one torch.distributed rank a shard ---------

# (case, model[:bed], flags, the wrappers a window of the CUDA sweep
# launches); the CPU-against-CUDA sweeps of phases 3h-3j run on the M=3,000
# beds of write_sweep_beds (the CPU sampler's sweeps set the two-rank
# launch's length)
SHARD_SWEEPS = (("exact_cs8", "brr:t_M3K_N_5500",
                 ("--window", "64", "--cross-sync", "8"),
                 ("window_stats", "window_axpy")),
                ("exact_w64", "brr:t_M3K_N_5500", ("--window", "64"),
                 ("sweep_exact",)),
                ("stale_w64", "brr:t_M3K_N_5500",
                 ("--stale", "--window", "64"), ("sweep_stale",)),
                ("bw_w64", "bw:weibull_M3K_N_5500", ("--window", "64"),
                 ("sweep_stale_bw",)))
SHARD_CHAIN = dict(iters=25, kill_at=10,
                   extra=("--stale", "--window", "64", "--det-sync", "1"))
# CLI chains through the ranks: (case, model, flags, sweeps, the wrappers
# that must launch). No --cross-sync chain: ~7 s a sweep on two ranks
# sharing the card (gloo stages each of its ~870 collectives a sweep via
# the host); its sweep check shows its launches
SHARD_LAUNCHED = (("bw_w64", "bw", ("--window", "64", "--det-sync", "1"), 8,
                   ("sweep_stale_bw",)),)
SHARD_REAL = dict(m=100_000, n=50_000, window=64, warmup=1, sweeps=1)
SHARD_FILES = (".csv", ".bet", ".cpn", ".acu", ".eps.0", ".mus.0", ".mrk.0",
               ".xbet", ".xcpn", ".rng.0")
SHARD_TIMEOUT = 360
# phase 3i, in phase 3h's two-rank launch: (case, model:bed ("mt_na": the
# phenotypes with 10% NaN), flags, the wrappers a window of the CUDA sweep
# launches)
MT_SHARD_SWEEPS = (
    ("mt_stale_w64", "mt_na:mt_M3K_N_5500", ("--stale", "--window", "64"),
     ("sweep_stale_mt",)),
    ("mt_exact_w64", "mt:mt_M3K_N_5500", ("--window", "64"),
     ("sweep_exact_mt",)),
    ("mt_exact_w64_nan", "mt_na:mt_M3K_N_5500", ("--window", "64"),
     ("window_stats_mt", "window_axpy_mt", "mt_window_recurrence")),
    ("dcn_stale_w64", "brr:t_M3K_N_5500",
     ("--stale", "--window", "64", "--dcn-slices", "2"), ("sweep_stale",)))
MT_SHARD_CHAIN = dict(iters=25, kill_at=10, extra=("--stale", "--window", "64"))
DET_SYNC, DCN_SLICES = ("--det-sync", "1"), ("--dcn-slices", "2")
# phase 3i's chains: name -> flags after MT_SHARD_CHAIN's; "k" is SIGKILLed
# and --restart'ed, and compared with "dn"
MT_SHARD_CHAINS = dict(a=DET_SYNC, b=DET_SYNC, dcn=DET_SYNC + DCN_SLICES,
                       fn=(), dn=DCN_SLICES, k=DCN_SLICES)
MT_SHARD_REAL = dict(m=100_000, n=50_000, n_traits=4, window=64, warmup=1,
                     sweeps=1)
# phase 3j, --ind-shards: the 1x2 grid's sweeps in phase 3h's two-rank
# launch, the 2x2 grid's in a four-rank launch of its own (N=5,500: n_pad
# 5,632, each chunk of 2,816 individuals padded to 3,072); (case,
# model:bed, flags, the wrappers a window launches)
IND = ("--ind-shards", "2")
IND_SWEEPS = (
    ("ind_exact_w64", "brr:t_M3K_N_5500", ("--window", "64") + IND,
     ("window_stats", "window_gibbs", "window_axpy")),
    ("ind_stale_w64", "brr:t_M3K_N_5500", ("--stale", "--window", "64") + IND,
     ("window_stats", "window_axpy")),
    ("ind_exact_w64_missing", "brr:t_M3K_N_5500_na", ("--window", "64") + IND,
     ("window_stats", "window_gibbs", "window_axpy")),
    ("ind_bw_w64", "bw:weibull_M3K_N_5500", ("--window", "64") + IND,
     ("window_level_sums", "window_axpy")))
IND_MT = ("window_stats_mt", "window_axpy_mt")
IND_SWEEPS += (
    ("mt_ind_stale_w64", "mt_na:mt_M3K_N_5500",
     ("--stale", "--window", "64") + IND, IND_MT),
    ("mt_ind_exact_w64_nan", "mt_na:mt_M3K_N_5500", ("--window", "64") + IND,
     IND_MT + ("mt_window_recurrence",)))
IND4_SWEEPS = (("ind4_exact_cs8", "brr:t_M3K_N_5500",
                ("--window", "64", "--cross-sync", "8") + IND,
                ("window_stats", "window_axpy")),
               ("mt_ind4_exact_w64", "mt:mt_M3K_N_5500",
                ("--window", "64") + IND, IND_MT + ("mt_window_recurrence",)))
# the 1x2 readings at N=50,000: M cut from 100,000 to 25,000 (the smoke's
# time limit; gloo's all_reduce a window sets their time); multi-trait on
# the first 25,000 markers of phase 3i's real-size genotypes (made once on
# each rank for both readings) with 10% NaN
IND_REAL = dict(m=25_000, n=50_000, window=64, warmup=1, sweeps=1, n_ind=2)
MT_IND_REAL = dict(MT_SHARD_REAL, m=25_000, n_ind=2, na_frac=0.1)


def write_sweep_beds(np, tmp):
    """The beds of phases 3h-3j's CPU-against-CUDA sweeps, M=3,000 x
    N=5,500 (n_pad 5,632: at --ind-shards 2 chunks of 2,816 individuals,
    each padded to 3,072): BayesRRm complete and with 2% missing calls,
    BayesW, and multi-trait T=4 (full and 10% NaN phenotypes)."""
    for name, kw in (("t_M3K_N_5500", {}),
                     ("t_M3K_N_5500_na", dict(missing=0.02)),
                     ("weibull_M3K_N_5500", dict(weibull=True))):
        write_plink(np, os.path.join(tmp, name), 3_000, 5_500, seed=31, **kw)
    base = os.path.join(tmp, "mt_M3K_N_5500")
    write_plink(np, base, 3_000, 5_500, seed=33)
    write_mt_phenos(np, base, 3_000, 5_500, 4, seed=6)
    write_mt_phenos(np, base, 3_000, 5_500, 4, seed=7, na_frac=0.1)


def shard_argv(tmp, model, name, iters, extra, restart=False):
    """CLI arguments of a phase-3h run on phase 3's, 3b's or (multi-trait)
    3c's bed, or the bed named after a colon ("bw:weibull_M3K_N_5500", one
    of write_sweep_beds) (thin 5, save 10, seed 7), its outputs in
    <tmp>/out_shards; model "mt_na" takes the phenotypes with 10% NaN."""
    model, _, bed = model.partition(":")
    bed = bed or {"bw": "weibull_M10K_N_5K", "mt": "mt_M10K_N_5K",
                  "mt_na": "mt_M10K_N_5K"}.get(model, "t_M10K_N_5K")
    argv = restart_argv(tmp, bed, "mt" if model == "mt_na" else model, name,
                        iters, False, extra, restart=restart)
    argv[argv.index("--mcmc-out-dir") + 1] = os.path.join(tmp, "out_shards")
    if model == "mt_na":
        i = argv.index("--pheno") + 1
        argv[i] = argv[i].replace(".phen", "_na.phen")
    return argv


def shard_sweeps(torch, np, tmp, cases=SHARD_SWEEPS):
    """On each rank, one sweep of every case by the CUDA sampler and by the
    CPU sampler of the same shards, on the same state and noise (made on
    the CPU from one seed, the sweep order from a seed a marker shard):
    both ranks' samplers sum over the same gloo groups (over its slices'
    groups under --dcn-slices; under --ind-shards I each rank holds marker
    shard rank // I and chunk rank % I of the individuals). Returns, by
    case, the CUDA sweep's differences and wrapper launches and the SHA-256
    of its eps (under --ind-shards the chunks gathered; the same on every
    rank)."""
    from hydra_tpu_torch.options import parse_args
    from hydra_tpu_torch.parallel import distributed, mesh
    from hydra_tpu_torch.runner import (dataset_from_options,
                                        mt_dataset_from_options)
    from hydra_tpu_torch.samplers import bayesrrm, bayesrrm_mt, bayesw
    from hydra_tpu_torch.utils.slice_sampler import N_SHRINK, slice_noise
    r, n_dev = distributed.rank(), distributed.world_size()
    dev = distributed.rank_device()
    out = {}
    for name, model, extra, _ in cases:
        opt = parse_args(shard_argv(tmp, model, name, 1, extra))
        model = model.partition(":")[0]
        mt = model.startswith("mt")
        if mt:
            ds, phenos = mt_dataset_from_options(opt)
            mod = bayesrrm_mt
        else:
            ds = dataset_from_options(opt)
            mod = bayesw if model == "bw" else bayesrrm

        n_ind = opt.ind_shards

        def make(device):
            kw = dict(window=opt.window, seed=7, device=device,
                      n_dev=n_dev // n_ind, rank=r // n_ind,
                      n_dcn=opt.dcn_slices)
            if mt:
                return bayesrrm_mt.BayesRRmMT(ds, phenos, exact=opt.exact,
                                              n_ind=n_ind, **kw)
            if model == "bw":
                return bayesw.BayesW(ds, n_ind=n_ind, **kw)
            return bayesrrm.BayesRRm(ds, exact=opt.exact,
                                     cross_sync=opt.cross_sync, n_ind=n_ind,
                                     **kw)

        cpu, gpu = make("cpu"), make(dev)
        g = torch.Generator().manual_seed(5)
        m_glob = cpu.cfg.m_glob
        if model == "bw":
            le, ub, uu = slice_noise(g, (m_glob,), N_SHRINK, "cpu")
            noise = dict(u=torch.rand(m_glob, generator=g), le=le, ub=ub,
                         uu=uu.T.contiguous(),
                         mu=slice_noise(g, (), N_SHRINK, "cpu"),
                         alpha=slice_noise(g, (), N_SHRINK, "cpu"))
        else:
            shape = (m_glob, cpu.cfg.n_traits) if mt else (m_glob,)
            noise = dict(mu=torch.randn(shape[1:], generator=g),
                         u=torch.rand(shape, generator=g),
                         nrm=torch.randn(shape, generator=g))
        noise["perm"] = torch.randperm(
            cpu.cfg.m_loc,
            generator=torch.Generator().manual_seed(11 + r // n_ind))
        s_cpu = cpu.init_state()
        s_gpu = mod.state_from_numpy(mod.state_to_numpy(s_cpu), dev)
        t0 = time.perf_counter()
        a, _ = cpu.step(s_cpu, 0, noise=noise)
        t1 = time.perf_counter()
        reset_all_launches()
        b, _ = gpu.step(s_gpu, 0, noise=noise)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = {k: v for k, v in all_launches().items() if v}
        whole = (gpu.residual(b.eps).cpu().numpy() if n_ind > 1
                 else None)
        a, b = mod.state_to_numpy(a), mod.state_to_numpy(b)
        np.testing.assert_allclose(b["eps"], a["eps"], atol=5e-4, rtol=1e-3)
        np.testing.assert_allclose(b["beta"], a["beta"], atol=5e-4,
                                   rtol=1e-3)
        out[name] = dict(
            d_eps=float(np.abs(a["eps"] - b["eps"]).max()),
            d_beta=float(np.abs(a["beta"] - b["beta"]).max()),
            comp_mismatches=int((a["components"] != b["components"]).sum()),
            n_windows=gpu.cfg.n_windows, launches=launches,
            cpu_s=t1 - t0, cuda_s=t2 - t1,
            hier=gpu._esum.func is mesh.hier_sum,
            masked_nonzero=(int((b["eps"][gpu.trait_mask.cpu().numpy() == 0]
                                 != 0).sum()) if mt else 0),
            eps_sha=hashlib.sha256(
                (b["eps"] if whole is None else whole).tobytes()).hexdigest(),
            n_loc=getattr(gpu.cfg, "n_loc", 0),
            pad_nonzero=(int((b["eps"][gpu.cfg.n_pad // n_ind:] != 0).sum())
                         if n_ind > 1 else 0),
            beta_sha=hashlib.sha256(b["beta"].tobytes()).hexdigest())
    return out


def mt_real_data(torch, np):
    """MT_SHARD_REAL's genotypes on this rank's card: each of its two marker
    shards made from its seed (2 + shard), as ``shard_real_size`` makes a
    shard; [(packed, mave, mstd, nm)] in shard order."""
    from hydra_tpu_torch.data.genotypes import shard_layout
    from hydra_tpu_torch.parallel import distributed
    real, dev = MT_SHARD_REAL, distributed.rank_device()
    n = real["n"]
    _, lengths, _ = shard_layout(real["m"], 2, real["window"])
    return [device_genotypes(torch, int(ln), n, padded_individuals(np, n),
                             torch.Generator(device=dev).manual_seed(2 + d))
            for d, ln in enumerate(lengths)]


def shard_real_size(torch, np, mt=False, real=None, data=None):
    """This rank's shard of M=100,000 x N=50,000 stale W=64 (genotypes
    made on the card from a seed a marker shard, or this shard's rows of
    ``data``, ``mt_real_data``; mt: multi-trait T=4 with full phenotypes;
    ``real`` IND_REAL: every marker on each rank of the 1x2 grid, each with
    its chunk of the individuals, the per-window branch; MT_IND_REAL: the
    same for multi-trait with 10% NaN): after the warm-up, ms a sweep by
    CUDA events, then as many sweeps with each all_reduce of the sampler
    timed alone (synchronized before and after)."""
    from hydra_tpu_torch.data.genotypes import (Dataset, GenotypeData,
                                                make_default_groups,
                                                shard_layout)
    from hydra_tpu_torch.parallel import distributed
    from hydra_tpu_torch.samplers.bayesrrm import BayesRRm
    from hydra_tpu_torch.samplers.bayesrrm_mt import BayesRRmMT
    real = real or (MT_SHARD_REAL if mt else SHARD_REAL)
    n_ind = real.get("n_ind", 1)
    r, n_dev = distributed.rank(), distributed.world_size() // n_ind
    d = r // n_ind
    dev = distributed.rank_device()
    m, n, W = real["m"], real["n"], real["window"]
    starts, lengths, _ = shard_layout(m, n_dev, W)
    s, ln = int(starts[d]), int(lengths[d])
    n_pad = padded_individuals(np, n)
    if data is None:
        gen = torch.Generator(device=dev).manual_seed(2 + d)
        pk, mave, mstd, nm = device_genotypes(torch, ln, n, n_pad, gen)
    else:
        pk, mave, mstd, nm = (torch.cat(x)[s:s + ln] for x in zip(*data))
    mave_h, mstd_h = mave.cpu().numpy(), mstd.cpu().numpy()
    geno = GenotypeData(
        packed=np.zeros((0, n_pad // 4), np.uint8), n=n, n_pad=n_pad, m=ln,
        mave=mave_h, mstd=mstd_h, msd=1.0 / mstd_h, n1=None, n2=None,
        nm=nm.cpu().numpy(), marker_offset=s, m_tot=m,
        nm_tot=distributed.allreduce_host_sum(
            float(nm.sum()) if r % n_ind == 0 else 0.0))
    groups, mS = make_default_groups(m, list(MS[1:]))
    ds = Dataset(geno=geno, y=np.random.RandomState(0).randn(n),
                 groups=groups, num_groups=1, mS=mS)
    kw = dict(window=W, exact=False, seed=1, device=dev, packed_device=pk,
              n_dev=n_dev, rank=d)
    smp = (BayesRRmMT(ds, mt_phenotypes(np, n, real["n_traits"], 4,
                                        real.get("na_frac", 0.0)),
                      n_ind=n_ind, **kw)
           if mt else BayesRRm(ds, n_ind=n_ind, **kw))
    del pk
    kernel = ("window_stats_mt" if mt and n_ind > 1 else "sweep_stale_mt"
              if mt else "window_stats" if n_ind > 1 else "sweep_stale")
    st = smp.init_state()
    k, w = real["sweeps"], real["warmup"]
    reset_all_launches()
    with step_events(torch) as pairs:
        for it in range(w + k):
            st, _ = smp.step(st, it)
    ms = events_ms(torch, pairs, skip=w)
    per_sweep = {name: v / (w + k) for name, v in all_launches().items()
                 if v}
    launches = per_sweep.get(kernel, 0)
    calls, spent = [0], [0.0]

    def timed(plain):
        def run(v):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            res = plain(v)
            torch.cuda.synchronize(dev)
            spent[0] += time.perf_counter() - t0
            calls[0] += 1
            return res
        return run

    # the sums over shards, of the residual's change and (--ind-shards) over
    # the chunks of individuals, each timed alone
    smp._sum, smp._esum = timed(smp._sum), timed(smp._esum)
    if n_ind > 1:
        smp._isum = timed(smp._isum)
    t0 = time.perf_counter()
    for it in range(w + k, w + 2 * k):
        st, _ = smp.step(st, it)
    torch.cuda.synchronize(dev)
    wall = (time.perf_counter() - t0) / k * 1e3
    if not bool(torch.isfinite(st.eps).all()):
        raise AssertionError("non-finite residual on marker shards")
    res = dict(ms=ms, allreduce_ms=spent[0] / k * 1e3,
               allreduce_calls=calls[0] / k, timed_wall_ms=wall,
               launches_per_sweep=launches, n_windows=smp.cfg.n_windows,
               markers=ln, eps_sha=hashlib.sha256(
                   smp.residual(st.eps).cpu().numpy().tobytes()
                   if n_ind > 1 else st.eps.cpu().numpy().tobytes()
               ).hexdigest())
    if n_ind > 1:
        res.update(n_loc=smp.cfg.n_loc, launches=per_sweep)
    elif mt:
        res["window_check"] = shard_window_check(torch, smp, st)
    else:
        res["dcn_chunks"] = dcn_chunk_cost(torch, st.eps)
    return res


def shard_window_check(torch, smp, st, n_win=8):
    """The multi-trait window-a-launch route (``sync``: C
    ``hydra_sweep_windows_mt`` and the per-window sum) on the first
    ``n_win`` windows of the real-size sampler's card tensors (its packed
    rows, eps, trait mask and kernel rows from fresh draws), against the
    plain version run the same way, both with an identity sum: components
    equal, eps and beta within atol 5e-4 / rtol 1e-3, one launch a
    window."""
    from hydra_tpu_torch.ops import sweep_kernel_mt as skmt
    cfg, dev = smp.cfg, smp.device
    T, W = cfg.n_traits, cfg.window
    g = torch.Generator(device=dev).manual_seed(23)
    u = torch.rand((cfg.m_loc, T), generator=g, device=dev)
    nrm = torch.randn((cfg.m_loc, T), generator=g, device=dev)
    mrow = smp.build_mrow(st, u, nrm, smp.active(st))
    rows = slice(0, n_win * W)
    args = (smp.packed[rows], st.eps, smp.trait_mask, mrow[rows],
            0.5 / st.sigma_e, smp.dNm1)
    kw = dict(window=W, n_mix=cfg.k, complete=cfg.complete,
              sync=lambda d: d)
    before = skmt.launches["sweep_stale_mt"]
    e_k, o_k = skmt.sweep_stale_mt(*args, **kw)
    torch.cuda.synchronize(dev)
    n_launch = skmt.launches["sweep_stale_mt"] - before
    e_r, o_r = skmt.sweep_stale_mt_ref(*args, **kw)
    if n_launch != n_win:
        raise AssertionError(f"window-a-launch route: {n_launch} launches "
                             f"for {n_win} windows")
    if not torch.equal(o_k[:, T:2 * T], o_r[:, T:2 * T]):
        raise AssertionError("window-a-launch route at real size: "
                             "components differ from the plain version")
    torch.testing.assert_close(e_k, e_r, atol=5e-4, rtol=1e-3)
    torch.testing.assert_close(o_k[:, :T], o_r[:, :T], atol=5e-4, rtol=1e-3)
    return dict(windows=n_win, launches=n_launch,
                d_eps=float((e_k - e_r).abs().max()),
                d_beta=float((o_k[:, :T] - o_r[:, :T]).abs().max()))


def dcn_chunk_cost(torch, eps, reps=20):
    """ms a call of ``mesh.hier_sum`` over the grid of two slices (the 1-D
    residual change across slices in DCN_CHUNKS all_reduces, the JAX
    rule) and of one all_reduce of the same vector over the same dcn
    group, ``reps`` calls each after one, synchronized around; the two
    sums must be the same bits (two ranks: a + b either way)."""
    import torch.distributed as tdist
    from hydra_tpu_torch.parallel import distributed, mesh
    groups = distributed.marker_grid(2)
    v = eps.clone()
    if v.shape[0] % mesh.DCN_CHUNKS:
        raise AssertionError(f"n_pad {v.shape[0]} is not a multiple of "
                             f"{mesh.DCN_CHUNKS}: no chunked sum to time")

    def one(x):
        out = x.clone()
        tdist.all_reduce(out, group=groups[1])
        return out

    def timed(fn):
        fn(v)
        torch.cuda.synchronize(v.device)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(v)
        torch.cuda.synchronize(v.device)
        return (time.perf_counter() - t0) / reps * 1e3, out

    chunked_ms, a = timed(lambda x: mesh.hier_sum(x, groups))
    single_ms, b = timed(one)
    if not torch.equal(a, b):
        raise AssertionError("hier_sum in chunks differs from one "
                             "all_reduce")
    return dict(chunked_ms=chunked_ms, single_ms=single_ms,
                n=int(v.shape[0]), chunks=mesh.DCN_CHUNKS)


def rank_child(args):
    """One rank of phase 3h (``chip_smoke.py --rank-child JSON``, started
    by scripts/run_multiprocess_torch.py): the process group from the
    launcher's environment, then its tasks in order ("cli": CLI runs
    through the CLI's body, ``cli._run``, with each run's wrapper
    launches; "sweeps": shard_sweeps; "wait": until the file ``path``
    exists, so what follows has the card to itself; "real", "mt_real",
    "ind_real", "mt_ind_real": shard_real_size, the last on "mt_real"'s
    genotypes; "ind_sweeps", "ind4_sweeps": phase 3j's shard_sweeps), the
    results, with each task's seconds, in <out>/rank<r>.json."""
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    from hydra_tpu_torch import cli
    from hydra_tpu_torch.options import parse_args
    from hydra_tpu_torch.parallel import distributed
    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.init_distributed()
    res = dict(rank=distributed.rank(), world=distributed.world_size(),
               backend=distributed.backend(),
               device=str(distributed.rank_device()), cli=[], seconds=[])
    try:
        for task in args["tasks"]:
            t_task = time.perf_counter()
            if task["kind"] == "wait":
                deadline = time.time() + SHARD_TIMEOUT
                while not os.path.exists(task["path"]):
                    if time.time() > deadline:
                        raise TimeoutError(f"no {task['path']}")
                    time.sleep(0.05)
            elif task["kind"] == "cli":
                for argv in task["argvs"]:
                    reset_all_launches()
                    t0 = time.perf_counter()
                    rc = cli._run(parse_args(argv))
                    torch.cuda.synchronize()
                    res["cli"].append(dict(
                        label=task.get("label", "cli"), rc=rc,
                        seconds=time.perf_counter() - t0,
                        launches={k: v for k, v in all_launches().items()
                                  if v}))
            elif task["kind"] == "sweeps":
                res["sweeps"] = shard_sweeps(torch, np, task["tmp"])
            elif task["kind"] == "mt_sweeps":
                res["mt_sweeps"] = shard_sweeps(torch, np, task["tmp"],
                                                MT_SHARD_SWEEPS)
            elif task["kind"] == "mt_real":
                data = mt_real_data(torch, np)
                res["mt_real"] = shard_real_size(torch, np, mt=True,
                                                 data=data)
            elif task["kind"] == "mt_ind_real":
                res["mt_ind_real"] = shard_real_size(
                    torch, np, mt=True, real=MT_IND_REAL, data=data)
                del data
            elif task["kind"] in ("ind_sweeps", "ind4_sweeps"):
                res[task["kind"]] = shard_sweeps(
                    torch, np, task["tmp"], IND_SWEEPS
                    if task["kind"] == "ind_sweeps" else IND4_SWEEPS)
            elif task["kind"] == "ind_real":
                res["ind_real"] = shard_real_size(torch, np, real=IND_REAL)
            else:
                res["real"] = shard_real_size(torch, np)
            res["seconds"].append(
                (task.get("label", task["kind"]),
                 time.perf_counter() - t_task))
    finally:
        distributed.destroy()
    with open(os.path.join(args["out"], f"rank{res['rank']}.json"),
              "w") as fh:
        json.dump(res, fh)
    return 0


def start_ranks(tmp, label, nprocs, tasks, backend, same_device=False):
    """Start ``nprocs`` rank children on their tasks (rank_child);
    returns the run for kill_rank1 / finish_ranks."""
    from scripts import run_multiprocess_torch as mp
    out = os.path.join(tmp, f"ranks_{label}")
    os.makedirs(out)
    procs = mp.launch(nprocs, [json.dumps(dict(tasks=tasks, out=out))],
                      device="cuda", backend=backend, same_device=same_device,
                      stdout_dir=out, command=[sys.executable,
                                               os.path.join(REPO,
                                                            "chip_smoke.py"),
                                               "--rank-child"])
    return dict(label=label, out=out, procs=procs, backend=backend,
                t0=time.perf_counter())


def kill_rank1(kills):
    """For each (run, csv, at) of ``kills``, all watched at once: SIGKILL
    rank 1 of ``run`` once ``csv`` shows iteration ``at``; the other ranks
    go with it (wait_all)."""
    from scripts import run_multiprocess_torch as mp
    deadline, todo, seen = time.time() + SHARD_TIMEOUT, list(kills), {}
    while time.time() < deadline and todo:
        for run, csv, at in list(todo):
            procs = run["procs"]
            rows = ([ln for ln in open(csv) if ln.strip()]
                    if os.path.exists(csv) else [])
            if rows and int(rows[-1].split(",")[0]) >= at:
                procs[1].kill()
                seen[run["label"]] = int(rows[-1].split(",")[0])
                todo.remove((run, csv, at))
            elif all(p.poll() is not None for p in procs):
                todo.remove((run, csv, at))
        time.sleep(0.01)
    for run, _, _ in kills:
        mp.wait_all(run["procs"], timeout=60)
        if run["label"] not in seen:
            raise AssertionError(f"{run['label']}: the chain ended before "
                                 "the kill")
        print(f"{run['label']}: rank 1 SIGKILLed at csv iteration "
              f"{seen[run['label']]}", flush=True)


def finish_ranks(run):
    """Wait for ``run``'s ranks (SHARD_TIMEOUT); raise unless every one
    exits 0; return their results."""
    from scripts import run_multiprocess_torch as mp
    n = len(run["procs"])
    codes = mp.wait_all(run["procs"], timeout=SHARD_TIMEOUT)
    if codes != [0] * n:
        logs = "".join(open(os.path.join(run["out"], f"rank{r}.log")).read()
                       [-3000:] for r in range(n))
        raise AssertionError(f"{run['label']}: rank exit codes {codes}\n"
                             f"{logs}")
    print(f"{run['label']}: {n} rank(s), {run['backend']}, "
          f"{time.perf_counter() - run['t0']:.1f} s from launch to exit",
          flush=True)
    return [json.load(open(os.path.join(run["out"], f"rank{r}.json")))
            for r in range(n)]


def same_files(a, b, traits=0):
    """Names of SHARD_FILES whose bytes differ between output bases a, b
    (multi-trait: every trait's ``.t<k>`` files)."""
    bases = [f".t{t}" for t in range(traits)] if traits else [""]
    return [t + ext for t in bases for ext in SHARD_FILES
            if (open(a + t + ext, "rb").read()
                != open(b + t + ext, "rb").read())]


def cli_runs(rank_res, label):
    """A rank child's CLI runs of the tasks labelled ``label``."""
    return [run for run in rank_res["cli"] if run["label"] == label]


def phase_shards(torch, np, tmp, card):
    """Marker shards, one torch.distributed rank a shard (rank children
    through scripts/run_multiprocess_torch.py): the BayesRRm CLI, exact and
    --stale, on one rank under an NCCL group, byte for byte the run without
    a group; two ranks on the one card (gloo on CUDA tensors, NCCL refuses
    two ranks on a device): one sweep of exact W=64 --cross-sync 8, exact
    W=64, stale W=64 and BayesW W=64 against the same two ranks' CPU sweep,
    a stale W=64 --det-sync chain twice (bit for bit), a BayesW chain with
    its wrappers' launches, the chain with rank 1 SIGKILLed and
    --restart'ed (byte for byte), and one M=100,000 x N=50,000 stale W=64
    shard sweep timed. The one-rank run and the chains to be killed (phase
    3i's multi-trait one too) run at once; then one two-rank launch takes
    the restarts and the sweeps (3h's, 3i's and 3j's 1x2 grid) beside the
    one-rank run's tail, waits until that run is checked, and runs the
    chains and the timed sweeps with the card to itself; phase 3j's 2x2
    grid runs in a four-rank launch of its own beside the killed chains.
    Returns the two ranks' and the four ranks' results for phases 3i and
    3j (``check_mt_shards``, ``check_ind_shards``)."""
    from hydra_tpu_torch import cli
    from scripts import soak_restart_torch as soak
    out = os.path.join(tmp, "out_shards")
    ch, mch = SHARD_CHAIN, MT_SHARD_CHAIN
    write_sweep_beds(np, tmp)
    plain = [shard_argv(tmp, "brr", f"d1_{k}", 20, extra)
             for k, extra in (("exact", ()), ("stale", ("--stale",)))]
    grouped = [[a.replace("d1_", "d1g_") for a in argv] for argv in plain]
    d1 = start_ranks(tmp, "d1_nccl", 1, [dict(kind="cli", argvs=grouped)],
                     "nccl")
    killed = shard_argv(tmp, "brr", "d2_k", ch["iters"], ch["extra"])
    mt_killed = shard_argv(tmp, "mt", "mt2_k", mch["iters"],
                           mch["extra"] + MT_SHARD_CHAINS["k"])
    kills, d4 = [], None
    try:
        d4 = start_ranks(tmp, "ind4_gloo", 4,
                         [dict(kind="ind4_sweeps", tmp=tmp)], "gloo",
                         same_device=True)
        kills = [start_ranks(tmp, label, 2, [dict(kind="cli", argvs=[argv])],
                             "gloo", same_device=True)
                 for label, argv in (("d2_kill", killed),
                                     ("mt2_kill", mt_killed))]
        kill_rank1([(kills[0], os.path.join(out, "d2_k.csv"), ch["kill_at"]),
                    (kills[1], os.path.join(out, "mt2_k.t3.csv"),
                     mch["kill_at"])])
    except BaseException:
        for p in d1["procs"] + [p for k in kills + [d4] if k
                                for p in k["procs"]]:
            p.kill()
        raise
    # one launch: the restarts and the CUDA-against-CPU sweeps beside the
    # one-rank run, then (once that run is checked) the chains and the
    # timed sweeps alone on the card
    chain = [shard_argv(tmp, "brr", f"d2_{k}", ch["iters"], ch["extra"])
             for k in ("a", "b")]
    launched = [shard_argv(tmp, model, f"d2_{name}", iters, extra)
                for name, model, extra, iters, _ in SHARD_LAUNCHED]
    mt_chain = [shard_argv(tmp, "mt", f"mt2_{k}", mch["iters"],
                           mch["extra"] + extra)
                for k, extra in MT_SHARD_CHAINS.items() if k != "k"]
    gate = os.path.join(tmp, "d1_checked")
    d2 = start_ranks(tmp, "d2_gloo", 2, [
        dict(kind="cli", label="restart", argvs=[shard_argv(
            tmp, "brr", "d2_k", ch["iters"], ch["extra"], restart=True)]),
        dict(kind="cli", label="mt_restart", argvs=[shard_argv(
            tmp, "mt", "mt2_k", mch["iters"],
            mch["extra"] + MT_SHARD_CHAINS["k"], restart=True)]),
        dict(kind="sweeps", tmp=tmp),
        dict(kind="mt_sweeps", tmp=tmp), dict(kind="ind_sweeps", tmp=tmp),
        dict(kind="wait", path=gate),
        dict(kind="cli", label="chains", argvs=chain + launched),
        dict(kind="cli", label="mt_chains", argvs=mt_chain),
        dict(kind="real"), dict(kind="mt_real"), dict(kind="mt_ind_real"),
        dict(kind="ind_real")],
        "gloo", same_device=True)
    try:
        for argv in plain:
            if cli.main(argv) != 0:
                raise AssertionError("one-device CLI run failed")
        (r0,) = finish_ranks(d1)
        for k in ("exact", "stale"):
            bad = same_files(os.path.join(out, f"d1_{k}"),
                             os.path.join(out, f"d1g_{k}"))
            if bad:
                raise AssertionError(f"one rank under NCCL, {k}: {bad} "
                                     "differ from the run without a process "
                                     "group")
    except BaseException:
        for p in d1["procs"] + d2["procs"] + d4["procs"]:
            p.kill()
        raise
    print(f"one rank under NCCL ({r0['backend']}, {r0['device']}): exact and"
          f" --stale CLI outputs byte for byte the run without a group; "
          f"launches {r0['cli'][0]['launches']}, {r0['cli'][1]['launches']}",
          flush=True)
    open(gate, "w").close()
    try:
        ranks4 = finish_ranks(d4)
    except BaseException:
        for p in d2["procs"]:
            p.kill()
        raise
    ranks = finish_ranks(d2)
    print("two ranks, seconds a task (rank 0): " + ", ".join(
        f"{k} {v:.1f}" for k, v in ranks[0]["seconds"]), flush=True)
    check_shard_sweeps(ranks, "sweeps", SHARD_SWEEPS)
    chains = cli_runs(ranks[0], "chains")
    bad = same_files(os.path.join(out, "d2_a"), os.path.join(out, "d2_b"))
    if bad:
        raise AssertionError(f"two-rank --det-sync chain not repeatable: "
                             f"{bad}")
    h2 = check_outputs(np, os.path.join(out, "d2_a"), 10_000,
                       ch["iters"] // 5)
    print(f"two-rank --det-sync stale W=64 chain ({ch['iters']} sweeps) bit "
          f"for bit repeatable, mean h2 over the last half {h2:.4f}; "
          f"{chains[0]['seconds']:.1f} s", flush=True)
    for (name, _, _, iters, kernels), run in zip(SHARD_LAUNCHED, chains[2:]):
        if any(run["launches"].get(k, 0) <= 0 for k in kernels):
            raise AssertionError(f"two-rank {name} chain launched "
                                 f"{run['launches']}, want {kernels}")
        print(f"two-rank {name} chain ({iters} sweeps): rank 0 launches "
              f"{run['launches']}, {run['seconds']:.1f} s", flush=True)
    its = soak.compare_runs(os.path.join(out, "d2_a"),
                            os.path.join(out, "d2_k_rs"), 10_000)
    print(f"two ranks, rank 1 SIGKILLed and --restart'ed: csv rows, .bet, "
          f".cpn, .acu, .mus.0 at iterations {its[0]}..{its[-1]} and the "
          f"last .eps.0 byte for byte the uninterrupted chain's", flush=True)
    print_shard_real(ranks, "real", "stale W=64", SHARD_REAL, "sweep_stale",
                     card)
    dc = [rk["real"]["dcn_chunks"] for rk in ranks]
    print(f"TWO RANKS SHARING ONE CARD (gloo): --dcn-slices 2's sum of a "
          f"window's residual change ({dc[0]['n']:,} floats) in "
          f"{dc[0]['chunks']} chunked all_reduces "
          f"{max(d['chunked_ms'] for d in dc):.3f} ms a call against one "
          f"all_reduce {max(d['single_ms'] for d in dc):.3f} ms (rank 0 "
          f"{dc[0]['chunked_ms']:.3f} / {dc[0]['single_ms']:.3f}), the same "
          f"bits  [{card}]", flush=True)
    return ranks, ranks4


def check_shard_sweeps(ranks, key, cases):
    """The ranks' CUDA-against-CPU sweeps of ``cases``: eps the same bits
    on every rank (--ind-shards: the chunks gathered, beta the same bits on
    every rank of an individual group, the chunk's padding 0), components
    equal, each wrapper once a window, the trait mask's entries held at 0;
    a --dcn-slices case summed by hier_sum."""
    for name, _, extra, kernels in cases:
        rs = [rk[key][name] for rk in ranks]
        if len({r["eps_sha"] for r in rs}) != 1:
            raise AssertionError(f"{name}: the ranks' CUDA eps differ")
        n_ind = (int(extra[extra.index("--ind-shards") + 1])
                 if "--ind-shards" in extra else 1)
        if n_ind > 1:
            for d in range(len(rs) // n_ind):
                if len({r["beta_sha"] for r in
                        rs[d * n_ind:(d + 1) * n_ind]}) != 1:
                    raise AssertionError(f"{name}: beta differs across the "
                                         f"individual group of shard {d}")
            if any(r["pad_nonzero"] for r in rs):
                raise AssertionError(f"{name}: a chunk's padding is not 0")
        if any(r["comp_mismatches"] for r in rs):
            raise AssertionError(f"{name}: components differ, CUDA vs CPU")
        if any(r["masked_nonzero"] for r in rs):
            raise AssertionError(f"{name}: masked eps entries are not 0")
        if any(r["hier"] != ("--dcn-slices" in extra) for r in rs):
            raise AssertionError(f"{name}: hier_sum {rs[0]['hier']}")
        for r in rs:
            if any(r["launches"].get(k) != r["n_windows"] for k in kernels):
                raise AssertionError(f"{name}: launches {r['launches']}, "
                                     f"want {kernels} once a window")
        grid = (f"{len(rs) // n_ind}x{n_ind} grid, {rs[0]['n_loc']:,} "
                f"individuals a rank, " if n_ind > 1 else "")
        print(f"{len(rs)} ranks, {grid}one {name} sweep CUDA vs CPU: "
              f"max|d eps| {max(r['d_eps'] for r in rs):.3e}  max|d beta| "
              f"{max(r['d_beta'] for r in rs):.3e}  comp mismatches 0, "
              f"eps the same bits on every rank; rank 0 launches "
              f"{rs[0]['launches']} ({rs[0]['n_windows']} windows); rank 0 "
              f"CPU sweep {rs[0]['cpu_s']:.1f} s, CUDA "
              f"{rs[0]['cuda_s']:.1f} s", flush=True)


def print_shard_real(ranks, key, label, real, kernel, card):
    """The timed shard sweep at M=100,000 x N=50,000 of both ranks."""
    rs = [rk[key] for rk in ranks]
    if len({r["eps_sha"] for r in rs}) != 1:
        raise AssertionError(f"real size {label}: the ranks' eps differ")
    r0 = rs[0]
    print(f"TWO RANKS SHARING ONE CARD (not a multi-GPU speed): {label}, "
          f"M={real['m']:,} x N={real['n']:,}, "
          f"{r0['markers']:,} markers a rank, {r0['n_windows']} windows a "
          f"rank: {max(r['ms'] for r in rs):.2f} ms/sweep by CUDA events "
          f"(rank 0 {r0['ms']:.2f}, rank 1 {rs[1]['ms']:.2f}; "
          f"{real['sweeps']} sweep(s) after {real['warmup']}), all_reduce "
          f"{r0['allreduce_ms']:.2f} ms a sweep in {r0['allreduce_calls']:.0f}"
          f" calls (each synchronized before and after; those sweeps "
          f"{r0['timed_wall_ms']:.2f} ms), {kernel} launches a sweep "
          f"{r0['launches_per_sweep']:.0f}  [{card}]", flush=True)


def chain_diff(np, a, b, m, n, traits):
    """Two multi-trait chains' outputs held within the sweep tolerances
    (atol 5e-4, rtol 1e-3), every trait's: csv values, .bet, .acu and
    .mus.0 records and the last .eps.0; .cpn records equal. Returns the
    largest absolute difference."""
    worst = 0.0
    for t in range(traits):
        pa, pb = f"{a}.t{t}", f"{b}.t{t}"
        pairs = [(np.loadtxt(pa + ".csv", delimiter=",", ndmin=2),
                  np.loadtxt(pb + ".csv", delimiter=",", ndmin=2), ".csv")]
        for ext, dt, width, hdr in ((".bet", "<f8", m, 4),
                                    (".acu", "<f8", m, 4),
                                    (".cpn", "<i4", m, 4),
                                    (".mus.0", "<f8", 1, 0),
                                    (".eps.0", "<f8", n, 4)):
            rec = np.dtype([("it", "<u4"), ("v", dt, (width,))])
            ra, rb = (np.frombuffer(open(p + ext, "rb").read()[hdr:],
                                    dtype=rec) for p in (pa, pb))
            if not np.array_equal(ra["it"], rb["it"]):
                raise AssertionError(f"{pb}{ext}: other records than {pa}")
            if ext == ".cpn" and not np.array_equal(ra["v"], rb["v"]):
                raise AssertionError(f"{pb}.cpn: components differ from {pa}")
            pairs.append((ra["v"], rb["v"], ext))
        for x, y, ext in pairs:
            if x.shape != y.shape or not np.allclose(y, x, atol=5e-4,
                                                     rtol=1e-3):
                raise AssertionError(f"{pb}{ext}: beyond the sweep "
                                     f"tolerances of {pa}")
            worst = max(worst, float(np.abs(y - x).max(initial=0.0)))
    return worst


def check_mt_shards(np, ranks, tmp, card):
    """Phase 3i's readings from phase 3h's two-rank launch: the
    multi-trait and --dcn-slices sweeps against the CPU, the multi-trait
    --det-sync chain repeatable and at --dcn-slices 2 the flat one byte for
    byte, the killed chain's restart byte for byte, the timed sweep."""
    from scripts import soak_restart_torch as soak
    out, mch, T = os.path.join(tmp, "out_shards"), MT_SHARD_CHAIN, 4
    tasks = dict(ranks[0]["seconds"])
    spent = sum(tasks[k] for k in ("mt_restart", "mt_sweeps", "mt_chains",
                                   "mt_real"))
    print(f"phase 3i ran inside phase 3h's launch: {spent:.1f} s of rank "
          f"0's tasks (" + ", ".join(f"{k} {tasks[k]:.1f}" for k in (
              "mt_restart", "mt_sweeps", "mt_chains", "mt_real")) + "), "
          "and its killed chain in a launch of its own beside 3h's",
          flush=True)
    check_shard_sweeps(ranks, "mt_sweeps", MT_SHARD_SWEEPS)
    runs = cli_runs(ranks[0], "mt_chains")
    if any(r["rc"] for r in runs):
        raise AssertionError(f"multi-trait chains: exit codes "
                             f"{[r['rc'] for r in runs]}")
    base = {k: os.path.join(out, f"mt2_{k}") for k in MT_SHARD_CHAINS}
    bad = same_files(base["a"], base["b"], T)
    if bad:
        raise AssertionError(f"two-rank multi-trait --det-sync chain not "
                             f"repeatable: {bad}")
    # --det-sync sums over all ranks in rank order at any --dcn-slices:
    # this shows only that making the slice grid changes nothing
    bad = same_files(base["a"], base["dcn"], T)
    if bad:
        raise AssertionError(f"multi-trait --det-sync chain at --dcn-slices "
                             f"2 differs from the flat one: {bad}")
    h2 = [check_outputs(np, f"{base['a']}.t{t}", 10_000, mch["iters"] // 5)
          for t in range(T)]
    h2s = ", ".join(f"{v:.4f}" for v in h2)
    secs = ", ".join(f"{k} {r['seconds']:.1f}"
                     for k, r in zip([k for k in MT_SHARD_CHAINS if k != "k"],
                                     runs))
    print(f"two-rank multi-trait T={T} --det-sync stale W=64 chain "
          f"({mch['iters']} sweeps) bit for bit repeatable and at "
          f"--dcn-slices 2 byte for byte the flat chain; mean h2 over the "
          f"last half {h2s}; rank 0 launches {runs[0]['launches']}; chains "
          f"{secs} s", flush=True)
    # without --det-sync: hier_sum every window at --dcn-slices 2
    worst = chain_diff(np, base["fn"], base["dn"], 10_000, 5_000, T)
    bad = same_files(base["fn"], base["dn"], T)
    print(f"two-rank multi-trait chain without --det-sync at --dcn-slices 2 "
          f"(hier_sum a window) against the flat one: within atol 5e-4 / "
          f"rtol 1e-3, components equal, max|diff| {worst:.3e}, files that "
          f"differ in bytes {bad or 'none'}", flush=True)
    for t in range(T):
        its = soak.compare_runs(f"{base['dn']}.t{t}",
                                os.path.join(out, f"mt2_k_rs.t{t}"), 10_000)
    print(f"two ranks, multi-trait at --dcn-slices 2 without --det-sync, "
          f"rank 1 SIGKILLed and --restart'ed: every trait's csv rows, .bet, "
          f".cpn, .acu, .mus.0 at iterations {its[0]}..{its[-1]} and the "
          f"last .eps.0 byte for byte the uninterrupted chain's", flush=True)
    wc = [rk["mt_real"]["window_check"] for rk in ranks]
    print(f"real size, the window-a-launch route (sync) on each rank's first "
          f"{wc[0]['windows']} windows of the sampler's card tensors against "
          f"its plain version run the same way: max|d eps| "
          f"{max(w['d_eps'] for w in wc):.3e}, max|d beta| "
          f"{max(w['d_beta'] for w in wc):.3e}, components equal, "
          f"{wc[0]['launches']} launches  [{card}]", flush=True)
    print_shard_real(ranks, "mt_real",
                     f"multi-trait T={MT_SHARD_REAL['n_traits']} stale W=64",
                     MT_SHARD_REAL, "sweep_stale_mt", card)


def check_ind_shards(np, ranks, ranks4, tmp, card):
    """Phase 3j's readings (--ind-shards): the 1x2 grid's sweeps from phase
    3h's two-rank launch and the 2x2 grid's from its four-rank one, CUDA
    against the CPU sampler (``check_shard_sweeps``), the 1x2 grid's timed
    sweeps at M=25,000 x N=50,000 (single-trait, and multi-trait T=4 with
    10% NaN), and the port's postproc on 3h's two-rank chain
    (``check_postproc``). Returns the wrappers' launches of rank 0's CUDA
    sweeps, for the kernels' record."""
    tasks = dict(ranks[0]["seconds"])
    own = ("ind_sweeps", "ind_real", "mt_ind_real")
    print(f"phase 3j ran inside phase 3h's launch: "
          f"{sum(tasks[k] for k in own):.1f} s of rank 0's tasks ("
          + ", ".join(f"{k} {tasks[k]:.1f}" for k in own) + "), and the 2x2 "
          f"grid in a four-rank launch of its own beside 3h's (ind4_sweeps "
          f"{dict(ranks4[0]['seconds'])['ind4_sweeps']:.1f} s)", flush=True)
    check_shard_sweeps(ranks, "ind_sweeps", IND_SWEEPS)
    check_shard_sweeps(ranks4, "ind4_sweeps", IND4_SWEEPS)
    print_shard_real(ranks, "ind_real", "--ind-shards 2 (1x2 grid: every "
                     "marker on both ranks, a chunk of the individuals each) "
                     "stale W=64 per window", IND_REAL, "window_stats", card)
    r0 = ranks[0]["ind_real"]
    if r0["launches"].get("window_axpy") != r0["n_windows"]:
        raise AssertionError(f"--ind-shards real size: launches a sweep "
                             f"{r0['launches']}, want window_stats and "
                             f"window_axpy once a window")
    print(f"--ind-shards 2 real size: {r0['n_loc']:,} individuals a rank, "
          f"wrappers a sweep {r0['launches']} ({r0['n_windows']} windows)  "
          f"[{card}]", flush=True)
    label = (f"multi-trait T={MT_IND_REAL['n_traits']} 10% NaN "
             "--ind-shards 2 (1x2 grid) stale W=64 per window")
    print_shard_real(ranks, "mt_ind_real", label, MT_IND_REAL,
                     "window_stats_mt", card)
    r0 = ranks[0]["mt_ind_real"]
    if any(r0["launches"].get(k) != r0["n_windows"] for k in IND_MT):
        raise AssertionError(f"multi-trait --ind-shards real size: launches "
                             f"a sweep {r0['launches']}, want {IND_MT} once "
                             "a window")
    print(f"{label}: {r0['ms']:.2f} ms a sweep by CUDA events, "
          f"{100.0 * r0['allreduce_ms'] / r0['timed_wall_ms']:.1f}% of the "
          f"timed sweep ({r0['timed_wall_ms']:.2f} ms) in gloo all_reduce "
          f"({r0['allreduce_ms']:.2f} ms, {r0['allreduce_calls']:.0f} "
          f"calls), wrappers a sweep {r0['launches']} ({r0['n_windows']} "
          f"windows), n_loc {r0['n_loc']:,}  [{card}]", flush=True)
    check_postproc(np, tmp)
    launches = {}
    for rk in (ranks[0]["ind_sweeps"], ranks4[0]["ind4_sweeps"]):
        for res in rk.values():
            for name, v in res["launches"].items():
                launches[name] = launches.get(name, 0) + v
    return launches


def check_postproc(np, tmp):
    """``python -m hydra_tpu_torch.postproc`` ess and predict on phase 3h's
    two-rank --det-sync chain (its thin records and phase 3's bed): R-hat
    and ESS finite for every trace, a score for each individual."""
    base = os.path.join(tmp, "out_shards", "d2_a")
    runs = {}
    for name, argv in (("ess", ["ess", base + ".csv", "--burnin", "1"]),
                       ("predict", ["predict", base + ".bet", "--bfile",
                                    os.path.join(tmp, "t_M10K_N_5K"),
                                    "--burnin", "1", "--mus",
                                    base + ".mus.0"])):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "hydra_tpu_torch.postproc",
                              *argv], cwd=REPO, capture_output=True,
                             text=True, timeout=300)
        if res.returncode:
            raise AssertionError(f"postproc {name}: exit {res.returncode}\n"
                                 f"{res.stderr[-3000:]}")
        runs[name] = (res.stdout.splitlines(), time.perf_counter() - t0)
    rows = [ln.split() for ln in runs["ess"][0][2:]]
    if len(rows) != 4 or not all(np.isfinite(float(v)) for r in rows
                                 for v in r[1:]):
        raise AssertionError(f"postproc ess: {runs['ess'][0]}")
    scores = np.array([float(ln.split()[2]) for ln in runs["predict"][0]])
    if scores.shape != (5_000,) or not np.all(np.isfinite(scores)):
        raise AssertionError(f"postproc predict: {scores.shape} scores")
    print("postproc on the two-rank --det-sync chain: ess " + "; ".join(
        f"{r[0]} ess {r[3]} rhat {r[4]}" for r in rows)
        + f" ({runs['ess'][1]:.1f} s); predict {scores.shape[0]:,} finite "
        f"scores, sd {scores.std():.4f} ({runs['predict'][1]:.1f} s)",
        flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--restart-child":
        return restart_child(json.loads(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--save-kill-child":
        return save_kill_child(json.loads(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--rank-child":
        return rank_child(json.loads(sys.argv[2]))
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import numpy as np
        from hydra_tpu_torch.ops import _build
        from hydra_tpu_torch.ops import sweep_kernel as sk
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run this script "
              "from the repository root", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with phase("1: card and build"):
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        print(card, flush=True)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)}", flush=True)
        t0 = time.perf_counter()
        log = _build.build(ptxas_verbose=True)
        libs = [_build.library_path(src) for src in _build.SOURCES]
        for src in _build.SOURCES:
            _build.load(src)
        print(f"kernels built in {time.perf_counter() - t0:.1f} s: "
              f"{', '.join(libs)}", flush=True)
        for ln in log.splitlines():
            if ("registers" in ln or "spill" in ln or "Compiling" in ln
                    or ln.endswith(".cu:")):
                print("  ptxas:", ln.strip().replace("ptxas info    : ", ""))
    with phase("2: kernels vs plain versions (M=4,096 x N=50,000)"):
        rec = phase_kernels(torch, sk, card)
    with phase("2b: BayesW kernels vs plain versions (N=50,000)"):
        rec.update(phase_bw_kernels(torch, np, card))
    with phase("2c: multi-trait kernels vs plain versions (M=4,096 x "
               "N=50,000, T=4)"):
        rec.update(phase_mt_kernels(torch, np, card))
    with phase("2d: per-window kernels vs plain versions (N=50,000)"):
        rec.update(phase_window_kernels(torch, np, card))
    with phase("2e: single-decode stale sweep vs its plain version "
               "(M=4,096 x N=50,000)"):
        rec.update(phase_sd_kernels(torch, np, sk, card))
    with phase("2f: the packed passes beside their library calls "
               "(N=50,000)"):
        for name, r in print_library_times(torch, np, card).items():
            rec[name].update(r)
    with phase("2g: the wide arms vs plain versions (W 1,025 and 2,048, "
               "K=20, T=20; N=50,000)"):
        phase_wide_kernels(torch, np, sk, card, rec)
    with tempfile.TemporaryDirectory() as tmp:
        with phase("3: BayesRRm CLI end to end (M=10,000 x N=5,000)"):
            launches = phase_cli(torch, np, sk, tmp)
        with phase("3b: BayesW CLI end to end (M=10,000 x N=5,000)"):
            bw_launches = phase_bw_cli(torch, np, tmp)
        with phase("3c: multi-trait CLI end to end (M=10,000 x N=5,000, "
                   "T=4)"):
            mt_launches = phase_mt_cli(torch, np, tmp)
        with phase("3d: per-window branch and W=1 through the CLI "
                   "(M=10,000 x N=5,000)"):
            window_launches = phase_window_cli(torch, np, tmp)
        with phase("3e: BayesFH and the single-decode sweep through the CLI "
                   "(M=10,000 x N=5,000)"):
            sd_launches = phase_sd_cli(torch, np, tmp)
        with phase("3f: restart and covariates through the CLI (M=10,000 x "
                   "N=5,000, F=12)"):
            phase_restart_cli(torch, np, tmp, card)
        with phase("3g: multi-trait W < 8 and --mega off, BayesW --mega off, "
                   "float64, sparse input, --check-RAM and a kill inside a "
                   "save through the CLI (M=10,000 x N=5,000)"):
            new_launches = phase_new_paths_cli(torch, np, tmp, card)
        with phase("3h: marker shards on torch.distributed ranks (M=10,000 "
                   "x N=5,000; one two-rank sweep at M=100,000 x N=50,000)"):
            ranks, ranks4 = phase_shards(torch, np, tmp, card)
        with phase("3i: multi-trait marker shards and --dcn-slices (run in "
                   "3h's launch; M=10,000 x N=5,000, T=4; one two-rank "
                   "sweep at M=100,000 x N=50,000)"):
            check_mt_shards(np, ranks, tmp, card)
        with phase("3j: --ind-shards, a (markers x individuals) rank grid "
                   "(1x2 in 3h's launch, 2x2 in its own; M=3,000 x N=5,500, "
                   "multi-trait T=4; one 1x2 sweep at M=25,000 x N=50,000 "
                   "each, single- and multi-trait) and postproc"):
            ind_launches = check_ind_shards(np, ranks, ranks4, tmp, card)
        with phase("3k: the wide arms through the CLI (--window 2048, "
                   "--stale --sync-rate 2048, K=20, T=20; M=10,000 x "
                   "N=5,000)"):
            wide_launches = phase_wide_cli(torch, np, tmp)
    for name in ("sweep_stale_bw", "window_level_sums", "window_axpy"):
        launches[name] = bw_launches[name]
    for name in ("sweep_stale_mt", "sweep_exact_mt", "window_stats_mt",
                 "window_axpy_mt", "mt_window_recurrence"):
        launches[name] = mt_launches[name]
    for name in ("window_stats", "window_gibbs", "window_stats_planes",
                 "window_axpy_planes"):
        launches[name] = window_launches[name]
    launches["sweep_stale_sd"] = sd_launches["sweep_stale_sd"]
    for name, v in new_launches.items():
        launches[name] += v
    for name, v in ind_launches.items():
        launches[name] += v
    for name, v in wide_launches.items():
        launches[name] += v
    with phase("4: real size (M=100,000 x N=50,000)"):
        phase_real_size(torch, np, sk, card)
    with phase("4b: BayesW real size"):
        phase_bw_real_size(torch, np, card)
    with phase("4c: multi-trait real size (M=100,000 x N=50,000, T=4)"):
        phase_mt_real_size(torch, np, card)
        print_mt_pass_times(torch, np, card)
    with phase("4d: per-window branch real size (M=25,000 x N=50,000) and "
               "stale W=1"):
        phase_window_real_size(torch, np, sk, card)
        print_window_gibbs_times(torch, np, card)
        print_planes_times(torch, np, card)
    with phase("4e: BayesFH and the single-decode sweep real size "
               "(M=100,000 x N=50,000)"):
        phase_sd_real_size(torch, np, sk, card)
    with phase("4f: one full-width restart (M=100,000 x N=50,000, F=12)"):
        phase_restart_real_size(torch, np, card)
    with phase("4g: the new paths at full width (M=25,000 x N=50,000)"):
        phase_new_paths_real_size(torch, np, card)

    # (wrapper, source, TPU kernel it replaces, the CUDA kernels it launches)
    table = (
        ("sweep_stale", "sweep_kernel.cu", "hydra_tpu/ops/sweep_kernel.py:836",
         "stats_kernel, axpy_kernel<false, MODE, KB> (draws the window: "
         "stale_draw in every block; above STALE_FOLD_MAX_W or K_MAX "
         "stale_draw_kernel<KB>, then axpy_kernel; above WIDE_W "
         "stale_draw_kernel<KB, true> and axpy_kernel<..., true>; K > 16 "
         "KB = K_ANY)"),
        ("sweep_exact", "sweep_kernel.cu", "hydra_tpu/ops/sweep_kernel.py:567",
         "stats_kernel, exact_draw_kernel, axpy_kernel a window; "
         "gram_i8_batch_kernel (missing: gram_f32_batch_kernel<Tile>) once "
         "a batch of windows; above WIDE_W exact_draw_kernel<KB, FIXED, "
         "true> a piece of 1,024 markers and axpy_kernel<..., true>; K > 16 "
         "KB = K_ANY"),
        ("sweep_stale_sd", "sweep_kernel.cu",
         "hydra_tpu/ops/sweep_kernel.py:255",
         "stats_kernel<true>, axpy_decoded_kernel<MODE, KB> (draws the "
         "sub-window; above STALE_FOLD_MAX_W stale_draw_kernel, then "
         "axpy_decoded_kernel)"),
        ("sweep_stale_bw", "sweep_kernel_bw.cu",
         "hydra_tpu/ops/sweep_kernel_bw.py:330",
         "levels_kernel, bw_draw_kernel (K > 32: bw_draw_kernel<true>), "
         "axpy_kernel<true> (above WIDE_W axpy_kernel<true, ..., true>)"),
        ("window_level_sums", "sweep_kernel_bw.cu",
         "hydra_tpu/ops/window_kernels.py:356",
         "levels_kernel, levels_reduce_kernel"),
        ("window_axpy", "sweep_kernel_bw.cu",
         "hydra_tpu/ops/window_kernels.py:284",
         "axpy_kernel<false, MODE, 0, true> (one launch a call; above "
         "WIDE_W axpy_kernel<false, MODE, 0, true, true>)"),
        ("sweep_stale_mt", "sweep_kernel_mt.cu",
         "hydra_tpu/ops/sweep_kernel_mt.py:214",
         "stats_mt_kernel, axpy_mt_kernel<COMPLETE, TB, KB> (draws the "
         "window: stale_draw_mt in every block; above MT_FOLD_MAX_W, K_MAX "
         "or T_MAX stale_draw_mt_kernel, then axpy_mt_kernel; above WIDE_W "
         "or T_MAX stats_mt_kernel<MODE, 16, true> and axpy_mt_kernel<..., "
         "true> a group of 16 traits)"),
        ("sweep_exact_mt", "sweep_kernel_mt.cu",
         "hydra_tpu/ops/sweep_kernel_mt.py:499",
         "stats_mt_kernel, exact_mt_draw_kernel, axpy_mt_kernel a window; "
         "gram_i8_batch_kernel once a batch of windows; above WIDE_W "
         "exact_mt_draw_kernel<KB, FIXED, true> a piece; T > 16 the trait "
         "groups"),
        ("window_stats_mt", "sweep_kernel_mt.cu",
         "hydra_tpu/ops/window_kernels.py:451",
         "stats_mt_kernel (T > 16: <MODE, 16, true> a group), "
         "stats_mt_reduce_kernel"),
        ("window_axpy_mt", "sweep_kernel_mt.cu",
         "hydra_tpu/ops/window_kernels.py:534",
         "axpy_mt_kernel (above WIDE_W or T_MAX <COMPLETE, 16, 0, true> a "
         "group)"),
        # not a Pallas kernel: the JAX sampler's lax.scan recurrence
        ("mt_window_recurrence", "sweep_kernel_mt.cu",
         "hydra_tpu/samplers/bayesrrm_mt.py:439",
         "window_recurrence_mt_kernel (above WIDE_W a launch a "
         "piece; K > 16 KB = K_ANY)"),
        ("window_stats", "sweep_kernel.cu",
         "hydra_tpu/ops/window_kernels.py:180",
         "stats_kernel, window_stats_finish_kernel, gram_i8_batch_kernel "
         "(the individuals split) + gram_standardize_kernel (exact "
         "complete; exact missing: gram_f32_batch_kernel<Tile>, the "
         "chunks split)"),
        ("window_gibbs", "sweep_kernel.cu", "hydra_tpu/ops/gibbs_kernel.py:112",
         "window_gibbs_kernel<KB, FIXED> (warp_recurrence; above "
         "WIDE_W <KB, FIXED, true> a piece; K > 16 KB = K_ANY)"),
        ("window_stats_planes", "planes_kernel.cu",
         "hydra_tpu/ops/planes.py:138",
         "stats_planes_kernel (one launch a call, a launch a 1,024 rows "
         "above: the last block of a row group's ticket adds the tiles' "
         "partials)"),
        ("window_axpy_planes", "planes_kernel.cu",
         "hydra_tpu/ops/planes.py:196",
         "axpy_planes_kernel (a thread per individual, rows staged by "
         "cp.async; above WIDE_W axpy_planes_kernel<true>)"))
    # library_ms: the planes kernels, torch.mv on the window's int8 rows
    # cast to f32 before timing; the window passes (window_stats, window_axpy,
    # window_level_sums and the multi-trait two), PyTorch's call on the
    # window's rows decoded to f32 before timing (print_library_times,
    # phase 2c). Null for the sweeps and the recurrences: no PyTorch call
    # runs a chain of draws, stale or exact. Rows with a library time add
    # the device time a call (device_ms, library_device_ms) beside the
    # CUDA-event times.
    kernels = [dict(name=name, route="cuda",
                    source=f"hydra_tpu_torch/csrc/{src}", replaces=replaces,
                    launches=launches[name], max_abs_err=rec[name]["err"],
                    ms=rec[name]["ms"], plain_ms=rec[name]["plain_ms"],
                    bound_ms=rec[name]["bound_ms"],
                    bound_by=rec[name]["bound_by"],
                    library_ms=rec[name].get("library_ms"), cuda=cuda,
                    **{k: rec[name][k] for k in ("device_ms",
                                                 "library_device_ms")
                       if k in rec[name]})
               for name, src, replaces, cuda in table]
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
