"""Distributions on explicit ``torch.Generator``s.

Counterparts of ``hydra_tpu/utils/dist.py`` (norm_rng, gamma_rng,
gamma_rate_rng, inv_gamma_rng, inv_gamma_rate_rng, inv_scaled_chisq_rng,
beta_rng, dirichlet_rng, plus the exponential draw of the slice sampler;
reference distributions_boost.cpp:28-136). There is no global RNG: every draw site gets its own generator, seeded from
(seed, iteration, site) by ``site_generator`` — the counter-based scheme of
the JAX sampler, so ``.rng.0`` = {seed, iteration, window, exact, schedule}
stays the whole restart state. The bits differ from threefry; tests inject
the same noise into both packages instead of matching streams.
"""

from __future__ import annotations

import torch

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def site_generator(seed: int, iteration: int, site: int,
                   device: torch.device, shard=None) -> torch.Generator:
    """A fresh generator for one draw site of one iteration; ``shard``
    keys a marker shard's own draws (the JAX sampler's ``fold_in(site,
    dev)``), None the draws every rank shares."""
    h = _splitmix64(int(seed) & _M64)
    h = _splitmix64(h ^ (int(iteration) & _M64))
    h = _splitmix64(h ^ (int(site) & _M64))
    if shard is not None:
        h = _splitmix64(h ^ (int(shard) & _M64))
    g = torch.Generator(device=device)
    g.manual_seed(h & ((1 << 63) - 1))
    return g


def shard_generator(seed: int, iteration: int, site: int,
                    device: torch.device, rank: int, n_dev: int
                    ) -> torch.Generator:
    """A marker shard's own draws (its sweep order): keyed by ``rank`` on
    n_dev > 1, as the JAX sampler's ``fold_in(site(s), dev)``; one shard
    keeps the unkeyed site."""
    return site_generator(seed, iteration, site, device,
                          rank if n_dev > 1 else None)


def norm_rng(g: torch.Generator, mean: torch.Tensor, sigma2: torch.Tensor
             ) -> torch.Tensor:
    """N(mean, sigma2); the second argument is the variance
    (distributions_boost.cpp:109-113)."""
    z = torch.randn(mean.shape, generator=g, device=mean.device,
                    dtype=mean.dtype)
    return mean + torch.sqrt(sigma2) * z


def gamma_rng(g: torch.Generator, alpha: torch.Tensor) -> torch.Tensor:
    """Gamma(alpha, 1), elementwise."""
    return torch._standard_gamma(alpha, generator=g)


def exponential_rng(g: torch.Generator, shape, device, dtype=torch.float32
                    ) -> torch.Tensor:
    """Exp(1) draws of the given shape."""
    return torch.empty(shape, device=device, dtype=dtype).exponential_(
        generator=g)


def inv_gamma_rng(g: torch.Generator, shape: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    """InvGamma(shape, scale) = 1 / Gamma(shape, 1/scale), elementwise
    (distributions_boost.cpp:89-91)."""
    return 1.0 / (gamma_rng(g, shape) * (1.0 / scale))


def gamma_rate_rng(g: torch.Generator, shape: torch.Tensor,
                   rate: torch.Tensor) -> torch.Tensor:
    """Gamma with the rate parameterisation, elementwise
    (distributions_boost.cpp:101-103)."""
    return gamma_rng(g, shape) * (1.0 / rate)


def inv_gamma_rate_rng(g: torch.Generator, shape: torch.Tensor,
                       rate: torch.Tensor) -> torch.Tensor:
    """1 / Gamma(shape, rate-parameterised), elementwise
    (distributions_boost.cpp:97-99)."""
    return 1.0 / gamma_rate_rng(g, shape, rate)


def inv_scaled_chisq_rng(g: torch.Generator, dof: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    """Scaled inverse chi-squared = InvGamma(dof/2, dof*scale/2)
    (distributions_boost.cpp:105-107)."""
    return (0.5 * dof * scale) / gamma_rng(g, 0.5 * dof)


def beta_rng(g: torch.Generator, a: torch.Tensor, b: torch.Tensor
             ) -> torch.Tensor:
    """Beta(a, b) as Ga / (Ga + Gb) (distributions_boost.cpp:132-136)."""
    ga = gamma_rng(g, a)
    gb = gamma_rng(g, b)
    return ga / (ga + gb)


def dirichlet_rng(g: torch.Generator, alpha: torch.Tensor) -> torch.Tensor:
    """Row-wise Dirichlet by gamma normalisation
    (distributions_boost.cpp:79-87)."""
    x = gamma_rng(g, alpha)
    return x / x.sum(dim=-1, keepdim=True)
