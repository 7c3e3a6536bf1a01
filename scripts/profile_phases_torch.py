"""Where a sampler's step goes: the port's step split into its host phases.

The counterpart of scripts/profile_phases.py (a Mosaic tile sweep of the
JAX package's kernel) for hydra_tpu_torch: one ``step`` of a sampler at
M=100,000 x N=50,000 split by timestamps around each of its phases. No
sampler is edited: the script wraps the sampler's methods on the instance
and the sweep function in the sampler's module, each wrapper taking a
timestamp as it enters and as it returns (CUDA events on the card,
``time.perf_counter`` on the CPU), and the step itself one at its start
and end. The segments between consecutive timestamps are the phases, so
they cover the step; the step is also timed from outside the wrappers,
and the phases' sum is held to that time (within 10%).

  bw   BayesW W=64 (block) with F=12 covariates: the mu and alpha slice
       draws (``_slice``), ``cov_sweep``, ``sweep_order``, ``slot_noise``,
       ``build_mrow``, the sweep (``sweep_stale_bw``) and the hypers
       (cass, sigmaG, pi after the sweep).
  brr  BayesRRm exact W=128 (block): mu, ``sweep_order``, the per-slot
       randoms, ``build_mrow``, the sweep (``sweep_exact``), the hypers
       and ``cov_sweep``; on the card the sweep's device time by kernel
       from torch.profiler (one more step).
  ingest  the load path of a .bed run (chip_smoke's phase 1b: a panel of
       M x N with 2% missing calls and 10 NA phenotypes, written to a
       temporary directory, loaded through ``load_dataset``): its stages
       by ``chip_smoke.ingest_load``, once with the OpenMP helper and once
       with the helper's passes set to their plain numpy versions from the
       script (``bed_remove_individuals``, ``bed_counts``, ``bed_hpack``:
       the load path as it ran before the helper). Not in the default
       ``--models``: the plain load takes minutes at M=100,000 x N=50,000.

Genotypes: the simulated panel of ``hydra_tpu_torch.io.simulate`` (HWE,
complete calls) made in memory from ``--seed``, loaded through
``GenotypeData.from_packed``; a phenotype of N(0, 1) (BayesRRm) or Weibull
log-times with 10% censoring (BayesW).

Usage:
    python scripts/profile_phases_torch.py [--models bw,brr] [--m 100000]
        [--n 50000] [--steps 5] [--seed 1] [--device cpu] [--json FILE]
    python scripts/profile_phases_torch.py --models ingest
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

EULER_MASCHERONI = 0.577215664901532
N_COV = 12
# the segment between two wrapped calls, by the wrapper that returned last
# and the one entered next ("" = the step's start or end)
GAPS = {
    "brr": {("", "sweep_order"): "mu",
            ("sweep_order", "build_mrow"): "per-slot randoms, active mask",
            ("build_mrow", "sweep_exact"): "glue",
            ("sweep_exact", "cov_sweep"): "hypers (cass, sigmaG, pi)",
            ("cov_sweep", ""): "sigmaE"},
    "bw": {("", "mu slice"): "w0",
           ("mu slice", "cov_sweep"): "eps after mu",
           ("cov_sweep", "alpha slice"): "vi, c_lin",
           ("alpha slice", "sweep_order"): "vi",
           ("build_mrow", "sweep_stale_bw"): "glue",
           ("sweep_stale_bw", ""): "hypers (cass, sigmaG, pi)"},
}


class Clock:
    """Timestamps: CUDA events on the card (ms between them on the
    device's timeline), perf_counter on the CPU."""

    def __init__(self, torch, device):
        self.torch, self.cuda = torch, device.type == "cuda"

    def now(self):
        if self.cuda:
            e = self.torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b):
        if self.cuda:
            return a.elapsed_time(b)
        return 1e3 * (b - a)

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()


class Phases:
    """Wrap callables so that each call leaves an enter and a return mark;
    ``step`` returns the step's marks."""

    def __init__(self, clock):
        self.clock, self.marks = clock, None

    def wrap(self, fn, name):
        def wrapped(*args, **kw):
            label = name(args) if callable(name) else name
            if self.marks is not None:
                self.marks.append((label, ">", self.clock.now()))
            out = fn(*args, **kw)
            if self.marks is not None:
                self.marks.append((label, "<", self.clock.now()))
            return out
        return wrapped

    def step(self, sampler, state, it):
        """(new state, [(phase, ms)], ms of the step timed outside)."""
        c = self.clock
        outer0 = c.now()
        self.marks = [("", "<", c.now())]
        state, _ = sampler.step(state, it)
        self.marks.append(("", ">", c.now()))
        outer1 = c.now()
        c.sync()
        marks, self.marks = self.marks, None
        return state, marks, c.ms(outer0, outer1)


def segments(clock, marks, gaps):
    """[(phase, ms)] between consecutive marks."""
    out = []
    for (la, ka, ta), (lb, kb, tb) in zip(marks, marks[1:]):
        if ka == ">" and kb == "<" and la == lb:
            name = la
        else:
            prev = la if ka == "<" else f"{la} (start)"
            name = gaps.get((prev, lb), f"{prev or 'start'} -> {lb or 'end'}")
        out.append((name, clock.ms(ta, tb)))
    return out


def panel_dataset(m, n, seed, with_fail):
    """The in-memory dataset: packed rows of the simulated panel through
    GenotypeData.from_packed, a phenotype (and failures, covariates)."""
    from hydra_tpu_torch.data.genotypes import (Dataset, GenotypeData,
                                                make_default_groups)
    from hydra_tpu_torch.io.simulate import packed_blocks
    packed = np.concatenate([pk for _, pk in packed_blocks(m, n, seed)])
    geno = GenotypeData.from_packed(packed, n, np.empty(0, np.int64))
    groups, mS = make_default_groups(m, [0.0001, 0.001, 0.01])
    rs = np.random.RandomState(seed)
    if with_fail:
        y = 4.0 + (np.log(rs.exponential(1.0, n)) + EULER_MASCHERONI) / 8.0
        fail = (rs.random_sample(n) > 0.1).astype(np.float64)
        X = rs.randn(n, N_COV)
    else:
        y, fail, X = rs.randn(n), None, None
    return Dataset(geno=geno, y=y, groups=groups, num_groups=1, mS=mS,
                   fail=fail, X=X)


def instrument(model, sampler, phases):
    """Wrap the sampler's phases; returns (module, name, function) of the
    wrapped sweep function, to restore."""
    if model == "brr":
        import hydra_tpu_torch.samplers.bayesrrm as mod
        names = ("sweep_order", "build_mrow", "cov_sweep")
        sweep = "sweep_exact"
    else:
        import hydra_tpu_torch.samplers.bayesw as mod
        names = ("cov_sweep", "sweep_order", "slot_noise", "build_mrow")
        sweep = "sweep_stale_bw"
        sampler._slice = phases.wrap(sampler._slice,
                                     lambda a: f"{a[4]} slice")
    for name in names:
        setattr(sampler, name, phases.wrap(getattr(sampler, name), name))
    original = getattr(mod, sweep)
    setattr(mod, sweep, phases.wrap(original, sweep))
    return mod, sweep, original


def kernel_split(torch, sampler, state, it):
    """Device ms by kernel of one step (torch.profiler, chip_smoke's
    device_times)."""
    import chip_smoke
    per = chip_smoke.device_times(torch, lambda: sampler.step(state, it),
                                  "profile_phases_torch")
    return sorted(((k[:90], cnt, ms) for k, (cnt, ms) in per.items()),
                  key=lambda r: -r[2])


def plain_versions():
    """(module, attribute, plain version) of each helper pass of the load
    path."""
    from hydra_tpu_torch import native
    from hydra_tpu_torch.data import genotypes
    from hydra_tpu_torch.io import plink
    from hydra_tpu_torch.ops import decode
    return [(native, "bed_remove_individuals",
             plink.remove_individuals_packed),
            (native, "bed_counts", genotypes.marker_counts),
            (native, "bed_hpack", decode.hpack_bytes_ref)]


def profile_ingest(args, torch, device, card):
    import chip_smoke
    from hydra_tpu_torch.io.simulate import write_panel
    r = chip_smoke.INGEST
    label = (f"ingest, M={args.m} x N={args.n}, {r['missing']:.0%} missing "
             f"calls, {r['na']} NA phenotypes")
    res = dict(model="ingest", label=label, card=card)
    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "ingest")
        t0 = time.perf_counter()
        write_panel(base, args.m, args.n, r["seed"], missing=r["missing"],
                    na=r["na"])
        print(f"== {label}: panel written in {time.perf_counter() - t0:.2f}"
              " s", flush=True)
        for key, name, pairs in (("helper", "with the OpenMP helper", []),
                                 ("plain", "plain numpy versions",
                                  plain_versions())):
            with chip_smoke.patched(pairs):
                times, _ = chip_smoke.ingest_load(torch, np, base, args.n,
                                                  dev=device)
            chip_smoke.print_ingest(name, times, card)
            res[key] = times
    return res


def profile(model, args, torch, device, card):
    if model == "ingest":
        return profile_ingest(args, torch, device, card)
    from hydra_tpu_torch.samplers.bayesrrm import BayesRRm
    from hydra_tpu_torch.samplers.bayesw import BayesW
    t0 = time.perf_counter()
    ds = panel_dataset(args.m, args.n, args.seed, model == "bw")
    if model == "brr":
        s = BayesRRm(ds, window=128, exact=True, seed=args.seed,
                     device=device)
        label = f"BayesRRm exact W=128 block, M={args.m} x N={args.n}"
    else:
        s = BayesW(ds, window=64, seed=args.seed, quad_points=25,
                   device=device)
        label = (f"BayesW W=64 block, F={N_COV} covariates, M={args.m} x "
                 f"N={args.n}")
    print(f"== {label}: data and sampler {time.perf_counter() - t0:.1f} s",
          flush=True)
    clock = Clock(torch, device)
    st = s.init_state()
    # warm-up, then the uninstrumented step's time
    for it in range(2):
        st, _ = s.step(st, it)
    clock.sync()
    plain = []
    for it in range(2, 2 + args.steps):
        a = clock.now()
        st, _ = s.step(st, it)
        b = clock.now()
        clock.sync()
        plain.append(clock.ms(a, b))
    phases = Phases(clock)
    mod, sweep, original = instrument(model, s, phases)
    try:
        runs = []
        for it in range(2 + args.steps, 2 + 2 * args.steps):
            st, marks, outer = phases.step(s, st, it)
            runs.append((segments(clock, marks, GAPS[model]), outer))
    finally:
        setattr(mod, sweep, original)
    names = [name for name, _ in runs[0][0]]
    mean = {}
    for segs, _ in runs:
        for name, ms in segs:
            mean[name] = mean.get(name, 0.0) + ms / len(runs)
    total = sum(mean.values())
    outer = sum(o for _, o in runs) / len(runs)
    plain_ms = sum(plain) / len(plain)
    print(f"{label}: step {outer:.3f} ms timed outside the wrappers "
          f"(uninstrumented {plain_ms:.3f} ms), phases sum {total:.3f} ms "
          f"({100.0 * (total - outer) / outer:+.1f}%), mean of "
          f"{args.steps} steps  [{card}]", flush=True)
    for name in dict.fromkeys(names):
        print(f"    {mean[name]:10.3f} ms  {100.0 * mean[name] / total:5.1f}%"
              f"  {name}", flush=True)
    res = dict(model=model, label=label, card=card, steps=args.steps,
               step_ms=outer, plain_step_ms=plain_ms, phases_ms=total,
               phases=[[name, mean[name]] for name in dict.fromkeys(names)])
    if model == "brr" and device.type == "cuda":
        split = kernel_split(torch, s, st, 2 + 2 * args.steps)
        print("    the step's device time by kernel (torch.profiler):",
              flush=True)
        for key, cnt, ms in split[:12]:
            print(f"      {ms:9.3f} ms  {cnt:6d} x  {key}", flush=True)
        res["kernels"] = [[k, c, ms] for k, c, ms in split]
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", default="bw,brr")
    ap.add_argument("--m", type=int, default=100_000)
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default="", help="write the splits here")
    args = ap.parse_args(argv)

    import torch
    device = torch.device(args.device)
    card = "cpu"
    if device.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"# {card}; host CPUs {os.cpu_count()}", flush=True)
    results = [profile(model, args, torch, device, card)
               for model in args.models.split(",")]
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(results, fh, indent=1)
    bad = [r["label"] for r in results
           if "phases_ms" in r
           and abs(r["phases_ms"] - r["step_ms"]) > 0.1 * r["step_ms"]]
    if bad:
        print(f"phases do not sum to within 10% of the step: {bad}",
              flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
