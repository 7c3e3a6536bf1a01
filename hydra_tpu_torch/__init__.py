"""hydra_tpu_torch — BayesRRm on PyTorch + hand-written CUDA for NVIDIA Hopper.

The PyTorch/CUDA port of ``hydra_tpu``. The JAX package stays the reference;
this package mirrors its module names so each counterpart is easy to find:

  hydra_tpu_torch.data.genotypes   load_dataset (jax-free rebuild)
  hydra_tpu_torch.ops.decode       h-pack + plain torch decode
  hydra_tpu_torch.ops.sweep_kernel sweep_stale / sweep_exact (CUDA kernels
                                   in csrc/sweep_kernel.cu, plain versions
                                   beside them)
  hydra_tpu_torch.utils.dist       torch.Generator distributions
  hydra_tpu_torch.samplers.bayesrrm  one-device BayesRRm sampler
  hydra_tpu_torch.runner / .cli    hydra-format chain runner and CLI

File formats, options and readers are reused from the jax-free modules of
``hydra_tpu`` (io, options, outputs, native, data.genotypes types). Nothing
here imports JAX.
"""

__version__ = "0.1.0"
