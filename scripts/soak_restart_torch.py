"""SIGKILL-and-restart soak of the port's CLI (``python -m hydra_tpu_torch.cli``).

A chain is run three times on the same inputs and flags:

  1. full : --iters iterations, uninterrupted;
  2. cut  : the same command, SIGKILLed (a hard crash: no atexit, no flush)
            once its csv shows an iteration >= --kill-at;
  3. rs   : --restart from cut's last save, without --seed (the saved seed
            is taken from cut.rng.0), writing cut_rs.*;

then every record cut_rs wrote must equal full's, byte for byte
(``compare_runs``): the csv rows, the .bet, .cpn, .acu and .mus.0 records,
the covariates' gamma (.gam.0 of the last save; BayesW: the .gam text
rows) and the last save's .eps.0. The reference's srun_restart.sh scenario
(test/scripts/srun_restart.sh:140-200); ``scripts/soak_restart.py`` is the
JAX package's.

The inputs are made from --data-seed: an M x N .bed (genotypes
Binomial(2, p)), a phenotype with h2 = 0.5, Weibull log-times and failure
indicators for BayesW, and F covariates, which also enter the phenotype:
``fid pid c1 .. cF`` with a few "NA" entries for the single-trait samplers
and a comma-separated file without IDs for multi-trait (--pheno of T
traits).

Usage:
  python scripts/soak_restart_torch.py --device cpu --model brr
      [--m 200] [--n 500] [--iters 40] [--kill-at 20] [--thin 2]
      [--save 10] [--covariates 3] [--traits 2] [--flags "--stale --window 32"]
      [--workdir DIR]

``--kill-at`` is best a multiple of --save: the kill then lands while the
chain runs the sweeps after a whole save, never inside the next one.
Exits 0 and prints one "SOAK PASS" line per compared file set.
"""

from __future__ import annotations

import argparse
import os
import shlex
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_inputs(base: str, m: int, n: int, seed: int, n_cov: int,
                 n_traits: int) -> None:
    """<base>.bed/.bim/.fam, .phen (h2 0.5 over 5% causal markers plus the
    covariates' effects), .wphen (Weibull log-times, alpha 8, mu 4) and
    .fail (80% events), .cov (``fid pid c1 .. cF``, every 37th individual
    "NA" in its first covariate), .csv.cov (comma-separated, no IDs) and
    .t<k>.phen for k < n_traits (5% "NA")."""
    sys.path.insert(0, REPO)
    from hydra_tpu_torch.io.plink import write_bed

    rs = np.random.RandomState(seed)
    p = rs.uniform(0.05, 0.5, (m, 1))
    geno = ((rs.random_sample((m, n)) < p).astype(np.int8)
            + (rs.random_sample((m, n)) < p).astype(np.int8))
    write_bed(base + ".bed", geno)
    with open(base + ".fam", "w") as fh:
        fh.writelines(f"f{i} i{i} 0 0 0 -9\n" for i in range(n))
    with open(base + ".bim", "w") as fh:
        fh.writelines(f"1 rs{j} 0 {j + 1} A C\n" for j in range(m))
    x = (geno - geno.mean(1, keepdims=True)) / np.maximum(
        geno.std(1, keepdims=True), 1e-6)
    X = rs.randn(n, n_cov)
    fixed = X @ (rs.randn(n_cov) * 0.3) if n_cov else np.zeros(n)

    def genetic():
        beta = np.zeros(m)
        causal = rs.choice(m, max(1, m // 20), replace=False)
        beta[causal] = rs.randn(len(causal))
        g = x.T @ beta
        return g / g.std()

    def phen(path, y, na=0.0):
        with open(path, "w") as fh:
            fh.writelines(
                f"f{i} i{i} {'NA' if rs.rand() < na else f'{y[i]:.8f}'}\n"
                for i in range(n))

    phen(base + ".phen",
         np.sqrt(0.5) * (genetic() + rs.randn(n)) + fixed)
    yw = (4.0 + 0.1 * genetic() + 0.1 * fixed
          + (np.log(rs.exponential(1.0, n)) + 0.577215664901532) / 8.0)
    phen(base + ".wphen", yw)
    with open(base + ".fail", "w") as fh:
        fh.writelines(f"{int(v)}\n" for v in rs.random_sample(n) < 0.8)
    with open(base + ".cov", "w") as fh:
        for i in range(n):
            vals = [("NA" if k == 0 and i % 37 == 36 else f"{X[i, k]:.6f}")
                    for k in range(n_cov)]
            fh.write(f"f{i} i{i} " + " ".join(vals) + "\n")
    with open(base + ".csv.cov", "w") as fh:
        fh.writelines(",".join(f"{v:.6f}" for v in X[i]) + "\n"
                      for i in range(n))
    for t in range(n_traits):
        phen(f"{base}.t{t}.phen",
             np.sqrt(0.5) * (genetic() + rs.randn(n)) + fixed, na=0.05)


def cli_argv(base: str, model: str, out: str, name: str, iters: int, *,
             device: str, thin: int, save: int, n_cov: int, n_traits: int,
             seed=None, restart=False, extra=()) -> list:
    """``python -m hydra_tpu_torch.cli`` arguments of one run."""
    a = ["--bfile", base, "--S", "0.001,0.01,0.1", "--chain-length",
         str(iters), "--thin", str(thin), "--save", str(save),
         "--mcmc-out-dir", out, "--mcmc-out-name", name]
    if model == "bw":
        a += ["--mpibayes", "bayesWMPI", "--pheno", base + ".wphen",
              "--failure", base + ".fail", "--quad_points", "7"]
    elif model == "mt":
        a += ["--mpibayes", "bayesMPI", "--pheno",
              ",".join(f"{base}.t{t}.phen" for t in range(n_traits))]
    else:
        a += ["--mpibayes", "bayesFHMPI" if model == "fh" else "bayesMPI",
              "--pheno", base + ".phen"]
    if n_cov:
        a += ["--covariates", base + (".csv.cov" if model == "mt" else ".cov")]
    if device:
        a += ["--device", device]
    if seed is not None:
        a += ["--seed", str(seed)]
    if restart:
        a += ["--restart"]
    return a + list(extra)


def last_csv_iter(path: str) -> int:
    """The iteration of the csv's last whole row, -1 if none."""
    try:
        with open(path) as fh:
            rows = [r for r in fh.read().split("\n")[:-1] if r.strip()]
        return int(rows[-1].split(",")[0]) if rows else -1
    except (OSError, ValueError):
        return -1


def run_killed(cmd: list, csv: str, kill_at: int, log: str,
               timeout: float = 3600.0, env=None) -> int:
    """Run ``cmd`` and SIGKILL it once ``csv`` shows an iteration >=
    ``kill_at``. Returns the csv iteration at the kill; raises if the run
    ended first or timed out."""
    with open(log, "w") as out:
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=out,
                                stderr=subprocess.STDOUT, env=env)
        t_end = time.time() + timeout
        try:
            while proc.poll() is None and time.time() < t_end:
                seen = last_csv_iter(csv)
                if seen >= kill_at:
                    os.kill(proc.pid, signal.SIGKILL)
                    proc.wait()
                    return seen
                time.sleep(0.005)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    raise RuntimeError(f"the run to be killed ended (exit {proc.returncode}) "
                       f"or timed out before its csv showed iteration "
                       f"{kill_at}; see {log}")


def _records(path: str, itemsize: int, header: int = 4) -> dict:
    """{iteration: bytes} of a [header][u32 it][itemsize bytes]* file."""
    raw = open(path, "rb").read()
    rec, out = 4 + itemsize, {}
    for r in range((len(raw) - header) // rec):
        chunk = raw[header + r * rec: header + (r + 1) * rec]
        out[int(np.frombuffer(chunk[:4], np.uint32)[0])] = chunk
    return out


def _rows(path: str) -> dict:
    with open(path) as fh:
        return {int(r.split(",")[0]): r for r in fh.read().split("\n")
                if r.strip()}


def compare_runs(full: str, rs: str, m: int, survival: bool = False,
                 covariates: bool = False) -> list:
    """Raise unless every record that ``rs`` (a restarted run's output
    base) wrote equals ``full``'s for the same iteration, byte for byte:
    csv rows, .bet, .cpn, .acu (BayesRRm) and .mus.0 records, gamma
    (.gam.0 of the last save; BayesW: the .gam rows) and the last save's
    .eps.0. Returns the compared csv iterations."""
    full_rows, rs_rows = _rows(full + ".csv"), _rows(rs + ".csv")
    if not rs_rows:
        raise AssertionError(f"{rs}.csv: the restarted run wrote no rows")
    bad = [it for it, r in rs_rows.items() if full_rows.get(it) != r]
    if bad:
        raise AssertionError(f"{rs}.csv: rows differ from the uninterrupted "
                             f"run at iterations {sorted(bad)[:5]}")
    sets = [(".bet", 8 * m, 4), (".cpn", 4 * m, 4), (".mus.0", 8, 0)]
    if not survival:
        sets.append((".acu", 8 * m, 4))
    for ext, size, hdr in sets:
        a, b = _records(full + ext, size, hdr), _records(rs + ext, size, hdr)
        if sorted(b) != sorted(rs_rows):
            raise AssertionError(f"{rs}{ext}: records at {sorted(b)}, csv "
                                 f"rows at {sorted(rs_rows)}")
        bad = [it for it in b if a.get(it) != b[it]]
        if bad:
            raise AssertionError(f"{rs}{ext}: records differ from the "
                                 f"uninterrupted run at {sorted(bad)[:5]}")
    whole = [".eps.0"]
    if covariates and not survival:
        whole.append(".gam.0")
    for ext in whole:
        if open(full + ext, "rb").read() != open(rs + ext, "rb").read():
            raise AssertionError(f"{rs}{ext}: the last save differs from the "
                                 "uninterrupted run's")
    if covariates and survival:
        a, b = _rows(full + ".gam"), _rows(rs + ".gam")
        if sorted(b) != sorted(rs_rows) or any(a.get(it) != b[it] for it in b):
            raise AssertionError(f"{rs}.gam: rows differ from the "
                                 "uninterrupted run's")
    return sorted(rs_rows)


def soak(args) -> list:
    """The three runs and the comparison; returns (suffix, iterations)
    per compared file set."""
    work = args.workdir or tempfile.mkdtemp(prefix="soak_torch_")
    os.makedirs(work, exist_ok=True)
    base = os.path.join(work, "soak")
    traits = args.traits if args.model == "mt" else 0
    write_inputs(base, args.m, args.n, args.data_seed, args.covariates,
                 traits)
    out = os.path.join(work, "out")
    py = [sys.executable, "-m", "hydra_tpu_torch.cli"]
    kw = dict(device=args.device, thin=args.thin, save=args.save,
              n_cov=args.covariates, n_traits=traits,
              extra=shlex.split(args.flags))
    env = {**os.environ, "PYTHONPATH": REPO}
    t0 = time.time()
    subprocess.run(py + cli_argv(base, args.model, out, "full", args.iters,
                                 seed=args.seed, **kw),
                   check=True, cwd=REPO, env=env,
                   stdout=open(os.path.join(work, "full.log"), "w"),
                   stderr=subprocess.STDOUT)
    print(f"# full run: {time.time() - t0:.1f} s wall", flush=True)
    sfx = [f".t{t}" for t in range(traits)] if traits else [""]
    seen = run_killed(py + cli_argv(base, args.model, out, "cut", args.iters,
                                    seed=args.seed, **kw),
                      os.path.join(out, "cut" + sfx[0] + ".csv"),
                      args.kill_at, os.path.join(work, "cut.log"), env=env)
    print(f"# SIGKILL at csv iteration {seen}", flush=True)
    subprocess.run(py + cli_argv(base, args.model, out, "cut", args.iters,
                                 restart=True, **kw),
                   check=True, cwd=REPO, env=env,
                   stdout=open(os.path.join(work, "rs.log"), "w"),
                   stderr=subprocess.STDOUT)
    done = []
    for s in sfx:
        its = compare_runs(os.path.join(out, "full" + s),
                           os.path.join(out, "cut_rs" + s), args.m,
                           survival=args.model == "bw",
                           covariates=args.covariates > 0)
        print(f"# SOAK PASS [{args.model}{s}]: restarted after the SIGKILL "
              f"at iteration {seen}; {len(its)} csv rows ({its[0]}..{its[-1]})"
              f" and their records byte-identical to the uninterrupted run",
              flush=True)
        done.append((s, its))
    return done


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=("brr", "fh", "bw", "mt"),
                    default="brr")
    ap.add_argument("--device", default="", help="'' = cuda, or cpu")
    ap.add_argument("--m", type=int, default=200)
    ap.add_argument("--n", type=int, default=500)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--kill-at", type=int, default=20)
    ap.add_argument("--thin", type=int, default=2)
    ap.add_argument("--save", type=int, default=10)
    ap.add_argument("--covariates", type=int, default=3,
                    help="number of covariates F (0: none)")
    ap.add_argument("--traits", type=int, default=2,
                    help="multi-trait: number of traits")
    ap.add_argument("--seed", type=int, default=31, help="chain seed")
    ap.add_argument("--data-seed", type=int, default=5)
    ap.add_argument("--flags", default="",
                    help="extra CLI flags, e.g. '--stale --window 32'")
    ap.add_argument("--workdir", default="",
                    help="inputs and outputs (default: a new temp dir)")
    return ap.parse_args(argv)


if __name__ == "__main__":
    soak(parse())
