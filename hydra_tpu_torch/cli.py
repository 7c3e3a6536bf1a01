"""Command-line entry point: ``python -m hydra_tpu_torch.cli <hydra flags>``.

The flags are ``hydra_tpu.options``'s (the reference's). This port runs
``--mpibayes bayesMPI`` on one device: ``--device`` empty means cuda,
``--device cpu`` runs the plain PyTorch path. Everything else raises
NotImplementedError naming what is missing (``runner.check_supported``).
"""

from __future__ import annotations

import sys

from hydra_tpu.options import parse_args


def main(argv=None) -> int:
    from hydra_tpu_torch.runner import check_supported, run_bayesrrm

    opt = parse_args(argv)
    check_supported(opt)
    if opt.bayes_type != "bayesMPI":
        print(f"FATAL  : Wrong analysis requested: {opt.bayes_type!r} "
              f"(expected bayesMPI)", file=sys.stderr)
        return 1
    run_bayesrrm(opt)
    return 0


if __name__ == "__main__":
    sys.exit(main())
