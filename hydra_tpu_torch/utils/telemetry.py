"""Reference-format log lines for the port's runners.

Same fields as ``hydra_tpu/utils/telemetry.py`` (reference
BayesRRm.cpp:2713-2722, :2931-2936) and the BayesW progress line of
``hydra_tpu/runner_bayesw.py:110-114``. The sync fields are zero: on one
device there are no collectives, and on marker shards they are not timed
here; the exit line says which.
"""

from __future__ import annotations


def result_line(it: int, proc_s: float, sigma_g: float, sigma_e: float,
                betasq: float, m0: int) -> str:
    """Per-iteration RESULT line; rank 0, no collectives."""
    z = 0.0
    return (f"RESULT : it {it:4d}, rank    0: proc = {proc_s:9.3f} s, "
            f"sync = {z:9.3f} ({z:9.3f} + {z:9.3f}), "
            f"n_sync = {0:8d} ({0:8d} + {0:8d}) ({z:7.3f} / {z:7.3f}), "
            f"sigmaG = {sigma_g:15.10f}, sigmaE = {sigma_e:15.10f}, "
            f"betasq = {betasq:15.10f}, m0 = {m0:10d}")


def exit_line(total_s: float, n_iter: int, n_ranks: int = 1) -> str:
    """Exit summary with the %-time-in-allreduce field."""
    what = ("1-device run: no collectives" if n_ranks == 1
            else f"{n_ranks} ranks: collectives not timed")
    return (f"INFO   : rank    0, time to process the data: {total_s:.3f} sec, "
            f"with 0.000 (0.000, 0.000) =  0.0% spent on allred (0, 0) "
            f"[{what}] ({n_iter} iterations)")


def cass_table(it: int, mtot_grp, sigma_g, cass) -> str:
    """Per-group cass table printed each reported iteration
    (BayesRRm.cpp:2588-2607)."""
    lines = [f"INFO   : global cass on iteration {it}:"]
    for g in range(len(mtot_grp)):
        row = f"         MtotGrp[{g:3d}] = {int(mtot_grp[g]):8d}  | "
        if int(mtot_grp[g]) == 0:
            row += " (empty group)"
        elif float(sigma_g[g]) == 0.0:
            row += " excluded (sigmaG set to zero)"
        else:
            row += " cass:" + "".join(f" {int(v):8d}" for v in cass[g])
        lines.append(row)
    return "\n".join(lines)


def bw_line(it: int, m0: int, mu: float, alpha: float, sigma_g: float,
            seconds: float) -> str:
    """BayesW progress line of a reported iteration."""
    return (f"{it}. m0={m0}; mu={mu:.5f}; alpha={alpha:.5f}; "
            f"sigmaG={sigma_g:.5f} ({seconds:.3f}s)")
