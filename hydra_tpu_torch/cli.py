"""Command-line entry point: ``python -m hydra_tpu_torch.cli <hydra flags>``.

The flags are the reference's (``hydra_tpu_torch.options``). Dispatch
mirrors main.cpp:47-177 and ``hydra_tpu/cli.py``:

  --bed-to-sparse        the sparse-file converter (io/sparse.py)
  --check-RAM            the device-memory estimate (diag/ramcheck.py)
  --mpibayes bayesMPI    BayesRRm; multi-trait BayesRRm when ``--pheno``
                         names several comma-separated files
  --mpibayes bayesFHMPI  BayesFH (with several phenotypes the JAX CLI, and
                         so this one, runs multi-trait BayesRRm)
  --mpibayes bayesWMPI   BayesW (with ``--failure``)

on one device, or on D marker shards with one process a device under a
launcher (``scripts/run_multiprocess_torch.py``, or ``python -m
torch.distributed.run --nproc-per-node D -m hydra_tpu_torch.cli ...``):
``main`` joins the process group the environment describes first and
leaves it last (``parallel/distributed.py``). ``--device`` empty means
cuda (NCCL between ranks), ``--device cpu`` runs the plain PyTorch path
(gloo); ``--dcn-slices S`` lays the ranks out in S slices, and
``--ind-shards I`` gives each marker shard I ranks, one chunk of the
individuals each (every sampler). What the port does not run (an S or I
that does not divide the ranks, its kernel limits) raises before any data
is read (``runner.check_supported``).
"""

from __future__ import annotations

import sys

from hydra_tpu_torch.options import parse_args
from hydra_tpu_torch.parallel import distributed


def main(argv=None) -> int:
    opt = parse_args(argv)
    distributed.init_distributed(opt.device)
    try:
        return _run(opt)
    finally:
        distributed.destroy()


def _run(opt) -> int:
    from hydra_tpu_torch.runner import (check_supported, run_bayesrrm,
                                        run_bayesrrm_mt, run_bayesw)

    check_supported(opt)
    if (opt.bed_to_sparse or opt.check_ram) and not distributed.is_primary():
        return 0              # host-only tasks: rank 0 does them
    if opt.bed_to_sparse:
        from hydra_tpu_torch.io import plink
        from hydra_tpu_torch.io.sparse import write_sparse_files
        n = opt.number_individuals or plink.read_fam(opt.bed_file + ".fam").n
        m = opt.number_markers or plink.read_bim(opt.bed_file + ".bim").m
        out = (opt.sparse_dir + "/" + opt.sparse_basename
               if opt.sparse_dir else opt.bed_file)
        # --blocks-per-rank bounds the conversion's memory (BayesRRm.cpp:
        # 469-471; one rank here)
        block_size = min(8192, -(-m // max(1, opt.blocks_per_rank)))
        print(f"INFO   : converting {opt.bed_file}.bed (M={m}, N={n}) -> "
              f"{out}.s* in blocks of {block_size} markers")
        write_sparse_files(opt.bed_file + ".bed", n, m, out,
                           block_size=block_size)
        return 0
    if opt.check_ram:
        from hydra_tpu_torch.diag.ramcheck import check_ram_usage
        check_ram_usage(opt)
        return 0
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
