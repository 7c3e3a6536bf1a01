#!/usr/bin/env python3
"""Real-size timings of one or more checkouts of the PyTorch/CUDA port, in
turn, on one CUDA card: each tree's own ``chip_smoke.py`` phases 4 (exact
W=128 and stale W=64 block), 4e (BayesFH exact W=128, stale W=64 marker
through the two-phase and single-decode sweeps), 4b (BayesW W=64 and W=1)
and 4c (multi-trait T=4 exact W=128 and stale W=64 block, and the
per-window path with 10% NaN), and the stale W=1 sweep at M=10,000 x
N=5,000, each with its per-kernel device time from ``profile_sweep`` /
``profile_run``. First, in every tree, this tree's
``chip_smoke.print_digests`` (the same inputs everywhere, the tree's own
kernels) prints the SHA-256 of the exact recurrences', the mt packed
passes' and the BayesW sweep's outputs, so equal
digests show two trees' kernels bit for bit the same; then this tree's
``chip_smoke.print_mt_pass_times`` times the multi-trait packed passes
alone (T 1/4/16, W 64/128, complete and missing), this tree's
``chip_smoke.print_stale_fold_times`` the stale sweeps' kernels a window
(single-trait W 1..1024, multi-trait T 1/4/16 x W 64..1024) and this
tree's ``chip_smoke.print_library_times`` the single-trait packed passes
and the missing-data Gram beside their library calls, on the same calls,
and this tree's ``chip_smoke.print_missing_exact_times`` BayesRRm exact
W=128 and W=64 on 2% missing genotypes at M=100,000 x N=50,000 and the
missing-data Gram alone a window (W 64, 128, 256, 1024), per window and,
where the tree batches the exact sweeps' Grams, batched; then this tree's
``chip_smoke.print_window_gibbs_times`` (window_gibbs_kernel alone a call,
W 64, 128, 1024), ``chip_smoke.print_planes_times`` (the planes kernels
alone a call, at ``PLANES_TIMES_W``, beside torch.mv on the rows cast to f32
before timing) and phase 4d's two ``--mega off`` rows (exact W=128 and
stale W=64 at M=100,000 x N=50,000, ``MEGA_OFF_REAL_SIZE``) with the exact
sweep's host enqueue split by wrapper and by torch operator
(``print_host_split``), and its ``--cache-planes on`` stale W=64 row
(``PLANES_REAL_SIZE``).

Compare two versions inside one call, in turns, e.g. a ``git archive`` of
the parent unpacked into a git-ignored directory beside this tree:

    python3 scripts/chip_compare.py [--logs DIR] [--digests] build/parent . . build/parent

``--digests`` runs the digests alone in each tree (a minute or two a tree).

Each run goes to ``DIR/compare_<i>_<tree>.log`` (default ``build/compare``,
git-ignored); a summary line per configuration (ms/sweep, CUDA-event
ms/sweep, device ms and busy share, host enqueue, device kernels a sweep,
and the stats, axpy (BayesRRm's, single-decode and multi-trait), stale
draw, exact recurrence (``window_gibbs`` too), planes and BayesW levels
and draw kernels' device us per window, and the Gram's), the multi-trait
passes' device us per call, the stale fold, library, missing-data Gram,
``window_gibbs``, planes and host split lines and the digests are printed
at the end.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

# runs inside each tree (cwd), with that tree's chip_smoke.py and package
PAYLOAD = r'''
import importlib.util, os, sys, time
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
import chip_smoke as c
spec = importlib.util.spec_from_file_location("digest_smoke", sys.argv[2])
d = importlib.util.module_from_spec(spec)
spec.loader.exec_module(d)
from hydra_tpu_torch.data.genotypes import (Dataset, GenotypeData,
                                            make_default_groups)
from hydra_tpu_torch.ops import sweep_kernel as sk
from hydra_tpu_torch.samplers.bayesrrm import BayesRRm
card = sys.argv[1]
torch.backends.cuda.matmul.allow_tf32 = False
d.print_digests(torch, np)
if sys.argv[3:] == ["digests"]:
    sys.exit(0)
d.print_mt_pass_times(torch, np, card)
d.print_stale_fold_times(torch, np, card)
d.print_library_times(torch, np, card)
d.print_missing_exact_times(torch, np, card)
d.print_window_gibbs_times(torch, np, card)
d.print_planes_times(torch, np, card)
d.phase_window_real_size(torch, np, sk, card, d.MEGA_OFF_REAL_SIZE,
                         host_split=True)
d.phase_window_real_size(torch, np, sk, card, d.PLANES_REAL_SIZE)
c.phase_real_size(torch, np, sk, card)
c.phase_sd_real_size(torch, np, sk, card)
c.phase_bw_real_size(torch, np, card)
c.phase_mt_real_size(torch, np, card)
dev = torch.device("cuda")
m, n = 10_000, 5_000
n_pad = c.padded_individuals(np, n)
gen = torch.Generator(device=dev).manual_seed(2)
pk, mave, mstd, nm = c.device_genotypes(torch, m, n, n_pad, gen)
mh, sh = mave.cpu().numpy(), mstd.cpu().numpy()
geno = GenotypeData(packed=np.zeros((0, n_pad // 4), np.uint8), n=n,
                    n_pad=n_pad, m=m, mave=mh, mstd=sh, msd=1.0 / sh, n1=None,
                    n2=None, nm=nm.cpu().numpy())
groups, mS = make_default_groups(m, list(c.MS[1:]))
ds = Dataset(geno=geno, y=np.random.RandomState(0).randn(n), groups=groups,
             num_groups=1, mS=mS)
s = BayesRRm(ds, window=1, exact=False, seed=1, device=dev, packed_device=pk)
st = s.init_state()
for it in range(2):
    st, _ = s.step(st, it)
torch.cuda.synchronize()
t0 = time.perf_counter()
for it in range(2, 5):
    st, _ = s.step(st, it)
torch.cuda.synchronize()
print(f"real size M=10,000 x N=5,000 stale W=1 block: "
      f"{(time.perf_counter() - t0) * 1e3 / 3:.2f} ms/sweep  [{card}]",
      flush=True)
c.profile_sweep(torch, sk, s, st, card)
'''

CONFIG = re.compile(r"real size (.*?): ([\d.,]+) ms/sweep")
SWEEP = re.compile(r"\((\d+) device kernels in the profile.*host enqueue ([\d.]+) ms.*"
                   r"CUDA events ([\d.]+) ms/sweep; "
                   r"profiler device time ([\d.]+) ms \(([\d.]+)% busy")
KERNEL = re.compile(r"([\d.]+) us/window\s+(?:void )?hydra::(stats|axpy|stats_mt|axpy_mt|"
                    r"axpy_decoded|stale_draw|stale_draw_mt|exact_draw|exact_mt_draw|"
                    r"window_recurrence_mt|levels|bw_draw|gram|gram_reduce|"
                    r"gram_f32|gram_i8|gram_f32_batch|gram_i8_batch|window_gibbs|"
                    r"window_stats_finish|gram_standardize|stats_planes|"
                    r"axpy_planes|planes_reduce)_kernel"
                    r"(<[^(]*>)?\(")
FOLD = re.compile(r"^stale fold (.*?): (.*) a window; draw \+ axpy ([\d.]+) us; "
                  r"(\d+) launches")
DIGEST = re.compile(r"^digest (.*): sha256 ([0-9a-f]{64})")
PASS = re.compile(r"^mt pass (.*): stats_mt_kernel ([\d.]+) us, "
                  r"axpy_mt_kernel ([\d.]+) us")


def summary(path):
    """One line per configuration of a run's log."""
    rows = []
    with open(path) as fh:
        for ln in fh:
            m = CONFIG.search(ln)
            if m:
                rows.append(f"  {m.group(1)[:58]:58s} step {m.group(2)}")
                continue
            m = SWEEP.search(ln)
            if m and rows:
                rows[-1] += (f" events {m.group(3)} device {m.group(4)} "
                             f"({m.group(5)}%) enqueue {m.group(2)} "
                             f"kernels {m.group(1)}")
                continue
            if ln.startswith(("library ", "missing gram ", "missing exact ",
                              "window_gibbs W=", "planes W=", "  host split ",
                              "    torch operators by own CPU time")):
                rows.append("  " + ln.split("  [")[0].strip())
                continue
            m = FOLD.search(ln)
            if m:
                rows.append(f"  fold {m.group(1):24s} draw+axpy {m.group(3)} us, "
                            f"{m.group(4)} launches ({m.group(2)})")
                continue
            m = KERNEL.search(ln)
            if m and rows:
                rows[-1] += f" {m.group(2)} {m.group(1)}"
                continue
            m = DIGEST.search(ln)
            if m:
                rows.append(f"  digest {m.group(1):44s} {m.group(2)}")
                continue
            m = PASS.search(ln)
            if m:
                rows.append(f"  mt pass {m.group(1):22s} stats_mt "
                            f"{m.group(2)} axpy_mt {m.group(3)} us")
    return rows


def main(argv) -> int:
    logs_dir = "build/compare"
    if argv[:1] == ["--logs"]:
        logs_dir, argv = argv[1], argv[2:]
    only = argv[:1] == ["--digests"]
    if only:
        argv = argv[1:]
    trees = argv or ["."]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    smoke = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    out = os.path.abspath(logs_dir)
    os.makedirs(out, exist_ok=True)
    logs, rc = [], 0
    for i, tree in enumerate(trees, 1):
        name = os.path.basename(os.path.abspath(tree))
        log = os.path.join(out, f"compare_{i}_{name}.log")
        with open(log, "w") as fh:
            r = subprocess.run([sys.executable, "-c", PAYLOAD, card, smoke]
                               + (["digests"] if only else []),
                               cwd=tree, stdout=fh, stderr=subprocess.STDOUT,
                               timeout=1200).returncode
        print(f"tree {tree}: exit {r}, log {log}", flush=True)
        rc = rc or r
        logs.append((tree, log))
    print(card)
    for tree, log in logs:
        print(f"{tree} ({os.path.basename(log)})")
        print("\n".join(summary(log)))
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
