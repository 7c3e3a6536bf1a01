"""Posterior h2 of the JAX package and of hydra_tpu_torch on one panel, on
the CPU: a witness that tells a shortfall of the port's h2 from one of the
model and its prior.

Writes one simulated panel (``hydra_tpu_torch.io.simulate.write_panel``,
as ``scripts/ess_certification_torch.py`` makes it: HWE genotypes, true h2
0.5 over 5% causal markers) and runs each configuration of
``scripts/ess_certification_torch.py`` as a chain of ``python -m
hydra_tpu.cli`` (JAX on the CPU) and of ``python -m hydra_tpu_torch.cli
--device cpu`` with the same flags, seed and ``--S`` grid. For each chain
it prints the posterior mean of h2 after the burn-in, its sd, its ESS and
the Monte Carlo standard error sd / sqrt(ESS), and for each configuration
the two means' difference over their joint standard error.

The panel's per-marker effect variance is h2 / (0.05 M), and N times it is
5 at M = 2 N, as on the M=100,000 x N=50,000 panel; ``--S`` places the
mixture's smallest component against it (on that panel 1e-4 against
0.001 x sigmaG ~ 5e-4, a ratio of 0.2; at M=2,000 x N=1,000, 5e-3
against 0.05 x sigmaG gives the same ratio).

Usage:
    python scripts/h2_witness_cpu.py [--m 2000] [--n 1000] [--seed 1]
        [--iters 2000] [--burnin-rec 60] [--S 0.001,0.01,0.1]
        [--configs exact_block,stale_w256_block] [--workdir DIR]
"""

import argparse
import math
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

CLIS = (("jax", "hydra_tpu.cli", "", {"JAX_PLATFORMS": "cpu"}),
        ("torch", "hydra_tpu_torch.cli", "cpu", {}))


def main(argv=None):
    import ess_certification_torch as ess
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=2000)
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--burnin-rec", type=int, default=60)
    ap.add_argument("--S", default=ess.DEFAULT_S)
    ap.add_argument("--configs", default="exact_block,stale_w256_block")
    ap.add_argument("--workdir", default="")
    args = ap.parse_args(argv)

    from hydra_tpu_torch import postproc
    from hydra_tpu_torch.io.simulate import write_panel

    workdir = args.workdir or tempfile.mkdtemp(prefix="h2_witness_")
    os.makedirs(workdir, exist_ok=True)
    base = os.path.join(workdir, "panel")
    truth = write_panel(base, args.m, args.n, args.seed, h2=0.5)["h2"]
    print(f"# panel M={args.m} x N={args.n}, true h2 {truth:.4f}; --S "
          f"{args.S}; {args.iters} sweeps, thin {ess.THIN}, burn-in "
          f"{args.burnin_rec} records; host CPUs {os.cpu_count()}",
          flush=True)
    print("| config | package | posterior h2 | sd | ESS | MC se |",
          flush=True)
    print("|---|---|---|---|---|---|", flush=True)
    failed = 0
    for name in args.configs.split(","):
        got = {}
        for label, cli, device, env in CLIS:
            res = ess.run_config(name, ess.CONFIGS[name], base, args.iters,
                                 os.path.join(workdir, label), device,
                                 args.S, cli=cli, env=env)
            if res is None:
                failed += 1
                continue
            h2 = postproc.chain_stats([res["csv"]], burnin=args.burnin_rec,
                                      out=open(os.devnull, "w"))["h2"]
            se = h2["sd"] / math.sqrt(max(h2["ess"], 1.0))
            got[label] = (h2["mean"], se)
            print(f"| {name} | {label} | {h2['mean']:.4f} | {h2['sd']:.4f} "
                  f"| {h2['ess']:.1f} | {se:.4f} |", flush=True)
        if len(got) == 2:
            (a, sa), (b, sb) = got["jax"], got["torch"]
            print(f"| {name} | torch - jax | {b - a:+.4f} | | | "
                  f"{(b - a) / math.hypot(sa, sb):+.2f} se |", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
