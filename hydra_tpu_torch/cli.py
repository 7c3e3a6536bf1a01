"""Command-line entry point: ``python -m hydra_tpu_torch.cli <hydra flags>``.

The flags are the reference's (``hydra_tpu_torch.options``). This port runs
``--mpibayes bayesMPI`` (BayesRRm; multi-trait BayesRRm when ``--pheno``
names several comma-separated files), ``--mpibayes bayesFHMPI`` (BayesFH;
with several phenotypes the JAX CLI, and so this one, runs multi-trait
BayesRRm) and ``--mpibayes bayesWMPI`` (BayesW, with ``--failure``) on one
device: ``--device`` empty means cuda,
``--device cpu`` runs the plain PyTorch path. Everything else raises
NotImplementedError naming what is missing (``runner.check_supported``).
"""

from __future__ import annotations

import sys

from hydra_tpu_torch.options import parse_args


def main(argv=None) -> int:
    from hydra_tpu_torch.runner import (check_supported, run_bayesrrm,
                                        run_bayesrrm_mt, run_bayesw)

    opt = parse_args(argv)
    check_supported(opt)
    rrm = run_bayesrrm_mt if opt.multi_phen else run_bayesrrm
    runners = {"bayesMPI": rrm, "bayesFHMPI": rrm, "bayesWMPI": run_bayesw}
    if opt.bayes_type not in runners:
        print(f"FATAL  : Wrong analysis requested: {opt.bayes_type!r} "
              f"(expected bayesMPI | bayesWMPI | bayesFHMPI)", file=sys.stderr)
        return 1
    runners[opt.bayes_type](opt)
    return 0


if __name__ == "__main__":
    sys.exit(main())
