"""Post-processing tools — equivalents of the reference's postproc/ binaries.

The port's own copy of ``hydra_tpu/postproc.py``: the same nine commands,
names and output bytes, numpy only, no device; ``predict`` reads the panel
with ``hydra_tpu_torch.io.plink``.

One Python CLI replaces the seven small C++/shell tools (postproc/*.cpp,
extractBeta.sh, extractCpn.sh, combineCSV.sh). Output formats match so
downstream R analysis (example/plot_example.R, postproc/postproc.R) keeps
working:

  beta-convert  <file.bet> <niter>                 (beta_converter.cpp:17-60)
  cpn-convert   <file.cpn> <niter>                 (components_converter.cpp)
  eps-convert   <file.eps.0>                       (epsilon_converter.cpp)
  extract-beta  <file.bet> <min_it> <max_it>       (extract_non_zero_betaAll.cpp)
  extract-cpn   <file.cpn> <min_it> <max_it>       (extract_non_zero_cpnAll.cpp)
  beta-check    <a.bet> <b.bet>                    (beta_checker.cpp)
  combine-csv   <out.csv> <in1.csv> [in2.csv ...]  (combineCSV.sh)

Beyond the reference's tool set (no C++ counterpart exists — the reference
leaves convergence checks and scoring to ad-hoc R):

  ess      <chain.csv> [chain2.csv ...] [--burnin N]
           Split-R-hat + effective sample size (Geyer initial monotone
           sequence, Vehtari et al. 2021) for the hyperparameter traces
           (sigmaG, sigmaE/alpha, h2, m0). Auto-detects the BayesRRm vs
           BayesW csv layout (BayesRRm.cpp:2742-2761 / BayesW.cpp:1942-1961).
  predict  <out.bet> --bfile <basename> [--burnin N] [--mus <out.mus.0>]
           [--out scores.txt]
           Polygenic scores from the posterior-mean betas on a (new) PLINK
           panel: score_i = sum_j beta_j (g_ij - mave_j) / mstd_j, markers
           standardized with the SCORING panel's own statistics (betas are
           on the standardized scale, BayesRRm.cpp:1778-1783); missing
           genotypes impute to the mean (contribute 0). --mus adds the
           posterior-mean intercept.

Usage: python -m hydra_tpu_torch.postproc <command> [args]
"""

from __future__ import annotations

import sys

import numpy as np


def _read_records(path: str, dtype):
    """Yield (iteration, values) from a .bet/.cpn-layout file."""
    itemsize = np.dtype(dtype).itemsize
    with open(path, "rb") as fh:
        m = int(np.frombuffer(fh.read(4), dtype=np.uint32)[0])
        rec = 4 + m * itemsize
        while True:
            raw = fh.read(rec)
            if len(raw) < rec:
                break
            it = int(np.frombuffer(raw[:4], dtype=np.uint32)[0])
            vals = np.frombuffer(raw[4:], dtype=dtype)
            yield it, vals


def beta_convert(path: str, niter: int, out=sys.stdout):
    """Emit records 0..niter INCLUSIVE — the reference's own loop is
    `for (iter=0; iter<=niter; ++iter)` (postproc/beta_converter.cpp:41)."""
    for i, (it, vals) in enumerate(_read_records(path, np.float64)):
        if i > niter:
            break
        for marker, b in enumerate(vals):
            out.write(f"{it:5d}/{marker:7d} = {b:20.12f}\n")


def cpn_convert(path: str, niter: int, out=sys.stdout):
    for i, (it, vals) in enumerate(_read_records(path, np.int32)):
        if i > niter:
            break
        for marker, c in enumerate(vals):
            out.write(f"{it:5d}/{marker:7d} = {c:3d}\n")


def eps_convert(path: str, out=sys.stdout):
    with open(path, "rb") as fh:
        it, n = np.frombuffer(fh.read(8), dtype=np.uint32)
        eps = np.frombuffer(fh.read(), dtype=np.float64, count=n)
    out.write(f"iteration {it}, N = {n}\n")
    for i, e in enumerate(eps):
        out.write(f"{i:7d} = {e:20.12f}\n")


def extract_nonzero(path: str, min_rec: int, max_rec: int, dtype,
                    out=sys.stdout):
    """Long-format (record, marker, value) rows for non-zero entries."""
    fmt = "{:7d} {:7d} {:20.12f}\n" if dtype == np.float64 else "{:7d} {:7d} {:3d}\n"
    for i, (it, vals) in enumerate(_read_records(path, dtype)):
        if i < min_rec or i > max_rec:
            continue
        nz = np.nonzero(np.abs(vals) > 1e-17)[0] if dtype == np.float64 \
            else np.nonzero(vals)[0]
        for marker in nz:
            out.write(fmt.format(i, int(marker), vals[marker]))


def beta_check(a: str, b: str) -> int:
    """Compare two .bet files; returns count of mismatches (beta_checker.cpp)."""
    ra = list(_read_records(a, np.float64))
    rb = list(_read_records(b, np.float64))
    bad = 0
    for (ia, va), (ib, vb) in zip(ra, rb):
        if ia != ib or not np.allclose(va, vb, atol=1e-12):
            bad += 1
            print(f"MISMATCH at record it {ia} vs {ib}: "
                  f"max |d| = {np.max(np.abs(va - vb)) if len(va) == len(vb) else 'shape'}")
    if len(ra) != len(rb):
        bad += abs(len(ra) - len(rb))
    print(f"{bad} mismatching records")
    return bad


def combine_csv(out_path: str, inputs):
    """Stitch restart CSVs, dropping duplicate iterations (combineCSV.sh)."""
    seen = set()
    rows = []
    for path in inputs:
        with open(path) as fh:
            for line in fh:
                if not line.strip():
                    continue
                it = int(line.split(",")[0])
                if it not in seen:
                    seen.add(it)
                    rows.append((it, line))
    rows.sort(key=lambda r: r[0])
    with open(out_path, "w") as fh:
        for _, line in rows:
            fh.write(line)


# ---------------------------------------------------------------------------
# Convergence diagnostics (ess) — no reference counterpart.

def _autocov(x: np.ndarray) -> np.ndarray:
    """Biased autocovariance of a 1-D series via FFT (O(n log n))."""
    n = len(x)
    xd = x - x.mean()
    nfft = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(xd, nfft)
    return np.fft.irfft(f * np.conj(f), nfft)[:n].real / n


def _split_rhat_ess(chains) -> tuple:
    """Split-R-hat and bulk ESS (Vehtari et al. 2021, the Stan estimator:
    rank-normalization omitted — the monitored traces are variances/ratios
    with light tails). Each chain is split in half; ESS uses Geyer's initial
    monotone positive sequence on the multi-chain autocorrelation."""
    h = min(len(c) for c in chains) // 2
    if h < 2:
        return float("nan"), float("nan")
    x = np.stack([half for c in chains for half in (c[:h], c[h:2 * h])])
    m, n = x.shape
    cm = x.mean(axis=1)
    cv = x.var(axis=1, ddof=1)
    w = cv.mean()
    var_plus = (n - 1) / n * w
    if m > 1:
        var_plus += cm.var(ddof=1)
    if not var_plus > 0:
        return 1.0, float(m * n)          # constant trace: converged, trivially
    rhat = float(np.sqrt(var_plus / w)) if w > 0 else float("inf")
    acov = np.stack([_autocov(row) for row in x]).mean(axis=0)
    rho = 1.0 - (w - acov) / var_plus
    # Geyer pairs: P_t = rho_{2t} + rho_{2t+1}, truncated at the first
    # negative pair, forced monotone non-increasing.
    tau = -1.0
    prev = float("inf")
    for t in range(0, n - 1, 2):
        p = rho[t] + rho[t + 1]
        if p < 0:
            break
        p = min(p, prev)
        prev = p
        tau += 2.0 * p
    ess = m * n / max(tau, 1.0 / np.log10(max(m * n, 10)))
    return rhat, float(min(ess, m * n * np.log10(max(m * n, 10))))


def _parse_chain_csv(path: str) -> dict:
    """Extract hyperparameter traces from a .csv chain file. Detects the
    layout: BayesRRm rows carry an integer group count in column 1
    (BayesRRm.cpp:2742-2761); BayesW rows carry mu, a float
    (BayesW.cpp:1942-1961)."""
    its, sig_g, second, h2, m0 = [], [], [], [], []
    second_name = None
    with open(path) as fh:
        for line in fh:
            c = [p.strip() for p in line.strip().split(",")]
            if len(c) < 6:
                continue
            its.append(int(c[0]))
            if "." in c[1]:                     # BayesW: it, mu, sigmaG, alpha, h2w, m0
                second_name = "alpha"
                sig_g.append(float(c[2]))
                second.append(float(c[3]))
                h2.append(float(c[4]))
                m0.append(float(c[5]))
            else:                               # BayesRRm: it, G, sigmaG*G, sigmaE, h2, m0
                second_name = "sigmaE"
                g = int(c[1])
                sig_g.append(sum(float(v) for v in c[2:2 + g]))
                second.append(float(c[2 + g]))
                h2.append(float(c[3 + g]))
                m0.append(float(c[4 + g]))
    return {"iterations": np.asarray(its),
            "sigmaG": np.asarray(sig_g),
            (second_name or "sigmaE"): np.asarray(second),
            "h2": np.asarray(h2), "m0": np.asarray(m0)}


def chain_stats(paths, burnin: int = 0, out=sys.stdout) -> dict:
    """Print mean/sd/ESS/split-R-hat for each hyperparameter trace across
    one or more chains (thinned records AFTER the first `burnin` records)."""
    parsed = [_parse_chain_csv(p) for p in paths]
    params = [k for k in parsed[0] if k != "iterations"]
    out.write(f"# chains: {len(paths)}, records used per chain: "
              f"{[max(0, len(p['iterations']) - burnin) for p in parsed]} "
              f"(burnin {burnin} records)\n")
    out.write(f"{'param':>8} {'mean':>14} {'sd':>12} {'ess':>9} {'rhat':>8}\n")
    results = {}
    for name in params:
        chains = [p[name][burnin:].astype(np.float64) for p in parsed]
        allv = np.concatenate(chains)
        rhat, ess = _split_rhat_ess(chains)
        results[name] = dict(mean=float(allv.mean()),
                             sd=float(allv.std(ddof=1)) if len(allv) > 1 else 0.0,
                             ess=ess, rhat=rhat)
        out.write(f"{name:>8} {allv.mean():14.6f} "
                  f"{results[name]['sd']:12.6f} {ess:9.1f} {rhat:8.4f}\n")
    return results


# ---------------------------------------------------------------------------
# Polygenic scoring (predict) — no reference counterpart.

def _posterior_mean_records(path: str, dtype, burnin: int) -> np.ndarray:
    acc = None
    count = 0
    for i, (_, vals) in enumerate(_read_records(path, dtype)):
        if i < burnin:
            continue
        acc = vals.astype(np.float64) if acc is None else acc + vals
        count += 1
    if count == 0:
        raise ValueError(f"{path}: no records after burnin {burnin}")
    return acc / count


def predict(bet_path: str, bfile: str, burnin: int = 0,
            mus_path: str = None, out_path: str = None,
            block: int = 4096, out=sys.stdout) -> np.ndarray:
    """Score a PLINK panel with posterior-mean effects. Blockwise over
    markers so UKB-scale panels never materialize densely on the host."""
    from hydra_tpu_torch.io import plink

    beta = _posterior_mean_records(bet_path, np.float64, burnin)
    fam = plink.read_fam(bfile + ".fam")
    bim = plink.read_bim(bfile + ".bim")
    if bim.m != len(beta):
        raise ValueError(f"{bet_path} has {len(beta)} markers but "
                         f"{bfile}.bim has {bim.m}")
    mu = 0.0
    if mus_path:
        mu = float(_posterior_mean_mu(mus_path, burnin))
    score = np.full(fam.n, mu, dtype=np.float64)
    for start in range(0, bim.m, block):
        cnt = min(block, bim.m - start)
        packed = plink.read_bed(bfile + ".bed", fam.n, bim.m, start, cnt)
        geno, mask = plink.decode_bed_numpy(packed, fam.n)
        nobs = mask.sum(axis=1)
        mave = (geno * mask).sum(axis=1) / np.maximum(nobs, 1)
        # mstd: the samplers' estimator (data/genotypes.py) — sd over
        # observed entries around the observed mean
        var = (mask * (geno - mave[:, None]) ** 2).sum(axis=1) \
            / np.maximum(nobs - 1, 1)
        mstd = np.sqrt(np.maximum(var, 0))
        ok = mstd > 0
        w = np.where(ok, beta[start:start + cnt] / np.where(ok, mstd, 1), 0.0)
        # missing genotypes impute to the marker mean: centered value 0
        centered = mask * (geno - mave[:, None])
        score += centered.T @ w
    lines = [f"{f} {p} {s:.8f}\n" for f, p, s in zip(fam.fid, fam.pid, score)]
    if out_path:
        with open(out_path, "w") as fh:
            fh.writelines(lines)
    else:
        out.writelines(lines)
    return score


def _posterior_mean_mu(path: str, burnin: int) -> float:
    """Mean over [uint32 it][f64 mu] records (.mus.0, writers.py on_thin)."""
    raw = np.fromfile(path, dtype=np.uint8)
    rec = np.dtype([("it", np.uint32), ("mu", np.float64)])
    recs = raw.view(rec) if raw.size % rec.itemsize == 0 else None
    if recs is None or len(recs) <= burnin:
        raise ValueError(f"{path}: bad .mus.0 layout or no records after "
                         f"burnin {burnin}")
    return float(recs["mu"][burnin:].mean())


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    cmd, args = argv[0], argv[1:]
    if cmd == "beta-convert":
        beta_convert(args[0], int(args[1]))
    elif cmd == "cpn-convert":
        cpn_convert(args[0], int(args[1]))
    elif cmd == "eps-convert":
        eps_convert(args[0])
    elif cmd == "extract-beta":
        extract_nonzero(args[0], int(args[1]), int(args[2]), np.float64)
    elif cmd == "extract-cpn":
        extract_nonzero(args[0], int(args[1]), int(args[2]), np.int32)
    elif cmd == "beta-check":
        return 1 if beta_check(args[0], args[1]) else 0
    elif cmd == "combine-csv":
        combine_csv(args[0], args[1:])
    elif cmd == "ess":
        import argparse
        ap = argparse.ArgumentParser(prog="postproc ess")
        ap.add_argument("chains", nargs="+")
        ap.add_argument("--burnin", type=int, default=0,
                        help="thinned records to drop from each chain")
        ns = ap.parse_args(args)
        chain_stats(ns.chains, burnin=ns.burnin)
    elif cmd == "predict":
        import argparse
        ap = argparse.ArgumentParser(prog="postproc predict")
        ap.add_argument("bet")
        ap.add_argument("--bfile", required=True)
        ap.add_argument("--burnin", type=int, default=0)
        ap.add_argument("--mus", default=None,
                        help=".mus.0 file; adds the posterior-mean intercept")
        ap.add_argument("--out", default=None)
        ns = ap.parse_args(args)
        predict(ns.bet, ns.bfile, burnin=ns.burnin, mus_path=ns.mus,
                out_path=ns.out)
    else:
        print(f"unknown command: {cmd}\n{__doc__}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
