"""ESS per second of the port's schedules and windows (the counterpart of
scripts/ess_certification.py for hydra_tpu_torch).

Runs the same five configurations as real chains of ``python -m
hydra_tpu_torch.cli`` (BayesRRm, thin 5) on one simulated panel and writes
the table:

    config x {ms a sweep (the CLI's "time to process the data" over the
    sweeps), ESS of h2 / sigmaG / sigmaE per 1,000 sweeps, ESS per second,
    posterior h2}

ESS comes from ``hydra_tpu_torch.postproc.chain_stats`` over the records
after ``--burnin-rec``. The panel is made from ``--seed``
(``hydra_tpu_torch.io.simulate.write_panel``): an HWE ``.bed`` packed by
the OpenMP helper's ``bed_generate``, complete genotypes, and a phenotype
of true h2 = 0.5 (5% of the markers causal), M=100,000 x N=50,000 by
default.

``--S`` sets the mixture's variance grid (the JAX script's
0.001,0.01,0.1 by default).

Usage:
    python scripts/ess_certification_torch.py [--iters 2000]
        [--burnin-rec 60] [--m 100000] [--n 50000] [--seed 1]
        [--S 0.001,0.01,0.1] [--configs exact_block,...] [--device cpu]
        [--workdir DIR] [--out FILE]
"""

import argparse
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CONFIGS = {
    # name: extra CLI flags (scripts/ess_certification.py:33-41)
    "exact_block": ["--window", "128"],
    "exact_marker": ["--window", "128", "--schedule", "marker"],
    "stale_w64_block": ["--stale", "--sync-rate", "64"],
    "stale_w256_block": ["--stale", "--sync-rate", "256"],
    "stale_w256_marker": ["--stale", "--sync-rate", "256",
                          "--schedule", "marker"],
}
THIN = 5
DEFAULT_S = "0.001,0.01,0.1"
PARAMS = ("h2", "sigmaG", "sigmaE")


def run_config(name, flags, base, iters, workdir, device, S=DEFAULT_S,
               cli="hydra_tpu_torch.cli", env=None):
    """One chain of ``python -m cli``; {csv, wall, proc_s} or None when it
    failed."""
    out = os.path.join(workdir, "ess_" + name)
    os.makedirs(out, exist_ok=True)
    cmd = [sys.executable, "-m", cli, "--mpibayes",
           "bayesMPI", "--bfile", base, "--pheno", base + ".phen",
           "--mcmc-out-dir", out, "--mcmc-out-name", "c",
           "--chain-length", str(iters), "--thin", str(THIN), "--save",
           "500", "--seed", "1234", "--S", S] + flags
    if device:
        cmd += ["--device", device]
    env = dict(os.environ, **(env or {}), PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.time()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=7200,
                       env=env, cwd=REPO)
    wall = time.time() - t0
    if r.returncode != 0:
        print(f"FAILED {name}:\n{r.stdout[-1500:]}\n{r.stderr[-1500:]}",
              flush=True)
        return None
    m = re.search(r"time to process the data: ([0-9.]+) sec", r.stdout)
    if m is None:
        print(f"FAILED {name}: no 'time to process the data' line",
              flush=True)
        return None
    return dict(csv=os.path.join(out, "c.csv"), wall=wall,
                proc_s=float(m.group(1)))


def table(rows, args, truth, card):
    lines = [f"# ESS per second, hydra_tpu_torch: M={args.m} x N={args.n}, "
             f"{card} (iters={args.iters}, thin={THIN}, burn-in "
             f"{args.burnin_rec} records; --S {args.S}; true h2 "
             f"{truth:.4f})", "",
             "| config | ms/sweep | ESS(h2)/1k | ESS(sigmaG)/1k | "
             "ESS(sigmaE)/1k | ESS(h2)/s | ESS(sigmaG)/s | ESS(sigmaE)/s | "
             "posterior h2 |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(
            f"| {r['name']} | {r['ms_per_sweep']:.2f} | "
            + " | ".join(f"{r[f'ess_{p}_per_1k']:.1f}" for p in PARAMS)
            + " | "
            + " | ".join(f"{r[f'ess_{p}_per_s']:.2f}" for p in PARAMS)
            + f" | {r['mean_h2']:.4f} |")
    return "\n".join(lines) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--burnin-rec", type=int, default=60,
                    help="burn-in in thinned records (thin=5)")
    ap.add_argument("--m", type=int, default=100_000)
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--S", default=DEFAULT_S,
                    help="the mixture's variance grid")
    ap.add_argument("--configs", default=",".join(CONFIGS))
    ap.add_argument("--device", default="",
                    help="the CLI's --device (default: the card)")
    ap.add_argument("--workdir", default="")
    ap.add_argument("--out", default="",
                    help="the table's file (default: WORKDIR/ess_cert.md)")
    args = ap.parse_args(argv)

    from hydra_tpu_torch import postproc
    from hydra_tpu_torch.io.simulate import write_panel

    workdir = args.workdir or tempfile.mkdtemp(prefix="ess_cert_torch_")
    os.makedirs(workdir, exist_ok=True)
    card = "cpu"
    if args.device != "cpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"# {card}; host CPUs {os.cpu_count()}", flush=True)
    base = os.path.join(workdir, "panel")
    t0 = time.time()
    truth = write_panel(base, args.m, args.n, args.seed, h2=0.5)["h2"]
    print(f"# panel M={args.m} x N={args.n} written in "
          f"{time.time() - t0:.1f} s (true h2 {truth:.4f})", flush=True)

    rows = []
    used = args.iters - args.burnin_rec * THIN
    for name in args.configs.split(","):
        flags = CONFIGS[name]
        print(f"== {name}: {' '.join(flags)}", flush=True)
        res = run_config(name, flags, base, args.iters, workdir, args.device,
                         args.S)
        if res is None:
            continue
        stats = postproc.chain_stats([res["csv"]], burnin=args.burnin_rec,
                                     out=sys.stderr)
        row = dict(name=name, proc_s=res["proc_s"], wall=res["wall"],
                   ms_per_sweep=1e3 * res["proc_s"] / args.iters)
        for p in PARAMS:
            ess = stats[p]["ess"]
            row[f"ess_{p}_per_1k"] = ess / used * 1000.0
            row[f"ess_{p}_per_s"] = ess / (res["proc_s"] * used / args.iters)
            row[f"mean_{p}"] = stats[p]["mean"]
        rows.append(row)
        print(f"   {row['ms_per_sweep']:.2f} ms/sweep, wall {res['wall']:.1f}"
              f" s, h2 ESS/1k = {row['ess_h2_per_1k']:.1f}, h2 ESS/s = "
              f"{row['ess_h2_per_s']:.2f}, h2 mean = {row['mean_h2']:.4f}",
              flush=True)
    text = table(rows, args, truth, card)
    out = args.out or os.path.join(workdir, "ess_cert.md")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as fh:
        fh.write(text)
    print(text + f"wrote {out}", flush=True)
    return 0 if len(rows) == len(args.configs.split(",")) else 1


if __name__ == "__main__":
    sys.exit(main())
