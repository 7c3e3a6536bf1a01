"""hydra_tpu_torch — BayesRRm (single- and multi-trait), BayesFH and BayesW
on PyTorch + hand-written CUDA for NVIDIA Hopper.

The PyTorch/CUDA port of ``hydra_tpu``. The JAX package stays the reference;
this package mirrors its module names so each counterpart is easy to find:

  hydra_tpu_torch.options          the reference's CLI surface (own copy)
  hydra_tpu_torch.io               PLINK, phenotype/failure and group readers;
                                   io.sparse: the sparse genotype files
                                   (``--bed-to-sparse``, sparse input)
  hydra_tpu_torch.data.genotypes   GenotypeData, Dataset, load_dataset (.bed,
                                   sparse files or both)
  hydra_tpu_torch.diag.ramcheck    ``--check-RAM``: the device-memory
                                   estimate of a run
  hydra_tpu_torch.outputs.writers  hydra-format McmcWriter (a save keeps
                                   the previous generation as .prev until
                                   its csv row is written); NullWriter on
                                   ranks other than 0
  hydra_tpu_torch.outputs.restart  read_restart: the saved state of a chain
                                   (``--restart``), from whichever
                                   generation the csv names
  hydra_tpu_torch.ops.decode       h-pack + plain torch decode, the
                                   standardized window (float64 branch)
  hydra_tpu_torch.ops.sweep_kernel     sweep_stale / sweep_exact /
                                   sweep_stale_sd (BayesRRm, BayesFH)
  hydra_tpu_torch.ops.sweep_kernel_bw  sweep_stale_bw (BayesW)
  hydra_tpu_torch.ops.sweep_kernel_mt  sweep_stale_mt / sweep_exact_mt /
                                   mt_window_recurrence (multi-trait)
  hydra_tpu_torch.ops.window_kernels   window_stats / window_axpy /
                                   window_level_sums, window_stats_mt /
                                   window_axpy_mt
  hydra_tpu_torch.ops.gibbs_kernel     window_gibbs (the per-window exact
                                   draw)
  hydra_tpu_torch.ops.planes       window_stats_planes / window_axpy_planes
                                   (cached int8 planes); CUDA kernels in
                                   csrc/, plain versions beside their
                                   wrappers
  hydra_tpu_torch.parallel.distributed  the process group (one rank a
                                   device), the rank grid of marker shards
                                   and chunks of individuals (rank_grid),
                                   gather_markers, gather_individuals,
                                   allreduce_host_sum, broadcast_object
  hydra_tpu_torch.parallel.mesh    marker_sum / det_sum / gather_rows /
                                   ind_sum over the grid's groups
                                   (all_reduce only)
  hydra_tpu_torch.utils.dist       torch.Generator distributions
  hydra_tpu_torch.utils.slice_sampler  fixed-budget slice sampling
  hydra_tpu_torch.samplers.bayesrrm / .bayesrrm_mt / .bayesw  the
                                   samplers: every branch of the JAX
                                   samplers on one device (whole sweep,
                                   per window, W >= 1, float64 BayesRRm);
                                   all four on marker shards, BayesRRm/FH
                                   and BayesW also on chunks of individuals
  hydra_tpu_torch.runner / .cli    hydra-format chain runners (covariates,
                                   ``--restart``) and CLI

scripts/soak_restart_torch.py SIGKILLs a CLI chain, restarts it and holds
every record after the restart byte for byte to the uninterrupted run;
scripts/run_multiprocess_torch.py starts D ranks of the CLI on one host.

Nothing here imports JAX or ``hydra_tpu``: the modules the port shares with
the JAX package in behaviour (options, io, data, outputs) are its own
copies, held against the originals by tests/test_torch_isolation.py.
"""

__version__ = "0.3.0"
