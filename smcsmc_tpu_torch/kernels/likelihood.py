"""Batched 2-state Felsenstein pruning on array trees (counterpart of
``smcsmc_tpu/kernels/likelihood.py``).

Infinite-sites-style two-state likelihood (reference particle.cpp:625-680):
``p_nomut = exp(-mu * branch_length)`` per branch, leaf states 0/1, missing
(-1) scores [1, 1], root prior 1/2:1/2 (or 1:0 with ``ancestral_aware``).
A ready-propagation sweep: each pass combines every internal node whose
two children already carry partials, with per-node rescaling so the log
likelihood stays exact at large n; n-1 passes at every n, the same launches
whatever the trees (the JAX package stops its loop at n > 8 once every node
is ready, kernels/likelihood.py:144, which gives the same result).
"""

from __future__ import annotations

import numpy as np
import torch


def _prune(trees, al: torch.Tensor, mutation_rate: float, prior):
    """Pruning of allele configurations ``al`` [C, n] on every tree: the
    rescaled root likelihood under the root ``prior`` (p0, p1) and its log
    scale, each [C, P]."""
    time, parent, c0, c1 = trees.time, trees.parent, trees.child0, trees.child1
    P, N = time.shape
    n = (N + 1) // 2
    dev = time.device
    al = al.to(torch.int32)
    C = al.shape[0]
    mu = torch.tensor(mutation_rate, dtype=torch.float32, device=dev)
    prior = torch.tensor(prior, dtype=torch.float32, device=dev)

    l0 = torch.where(al == 1, 0.0, 1.0)
    l1 = torch.where(al == 0, 0.0, 1.0)
    pad = torch.zeros((C, n - 1), device=dev)
    leaf_part = torch.stack([torch.cat([l0, pad], 1), torch.cat([l1, pad], 1)],
                            2)  # [C, N, 2]
    partial = leaf_part[:, None].expand(C, P, N, 2)
    is_leaf = c0 < 0
    ready = is_leaf  # [P, N]: readiness follows the tree, not the alleles

    i0 = c0.clamp(min=0).long()
    i1 = c1.clamp(min=0).long()
    has0 = c0 >= 0
    has1 = c1 >= 0
    zero = torch.zeros_like(time)
    t0 = time - torch.where(has0, time.gather(1, i0), zero)
    t1 = time - torch.where(has1, time.gather(1, i1), zero)
    p0 = torch.exp(-t0 * mu)[:, :, None]  # no-mutation prob per child branch
    p1 = torch.exp(-t1 * mu)[:, :, None]
    idx0 = i0[None, :, :, None].expand(C, P, N, 2)
    idx1 = i1[None, :, :, None].expand(C, P, N, 2)
    acc = torch.zeros((C, P), device=dev)

    def combine_pass(partial, acc, ready):
        zp = torch.zeros_like(partial)
        a0 = torch.where(has0[:, :, None], partial.gather(2, idx0), zp)
        a1 = torch.where(has1[:, :, None], partial.gather(2, idx1), zp)
        r0 = has0 & ready.gather(1, i0)
        r1 = has1 & ready.gather(1, i1)
        can = ~ready & ~is_leaf & r0 & r1
        m0 = a0 * p0 + a0.flip(-1) * (1.0 - p0)
        m1 = a1 * p1 + a1.flip(-1) * (1.0 - p1)
        val = m0 * m1
        sc = torch.maximum(val[..., 0], val[..., 1]).clamp(min=1e-30)
        partial = torch.where(can[:, :, None], val / sc[..., None], partial)
        acc = acc + torch.where(can, torch.log(sc), torch.zeros_like(sc)).sum(2)
        return partial, acc, ready | can

    # n-1 passes always suffice (each readies at least the lowest internal
    # node not yet ready); once every node is ready a pass changes nothing,
    # so there is no data-dependent loop condition and no host read
    for _ in range(n - 1):
        partial, acc, ready = combine_pass(partial, acc, ready)
    root = (parent < 0)[:, :, None]
    root_part = torch.where(root, partial, torch.zeros_like(partial)).sum(2)
    return root_part[..., 0] * prior[0] + root_part[..., 1] * prior[1], acc


def site_log_likelihood(trees, alleles: torch.Tensor, mutation_rate: float,
                        ancestral_aware: bool = False) -> torch.Tensor:
    """Per-particle log-likelihood of one site.

    ``alleles`` is an integer tensor with values 0/1/-1 on the trees'
    device: ``[n]`` gives ``[P]``; ``[C, n]`` (C allele configurations of
    the same site) gives ``[C, P]`` from one pass over the trees, at the
    launches of a single configuration."""
    single = alleles.dim() == 1
    lik, acc = _prune(trees, alleles[None] if single else alleles,
                      mutation_rate,
                      (1.0, 0.0) if ancestral_aware else (0.5, 0.5))
    ll = torch.log(lik.clamp(min=1e-30)) + acc
    return ll[0] if single else ll


def site_likelihood_scaled(trees, alleles: torch.Tensor,
                           mutation_rate: float, prior=(0.5, 0.5)):
    """Single-tree pruning with an ancestral prior, for every tree
    (``_site_likelihood_one`` of the JAX package's kernels/likelihood.py:27,
    batched): alleles [n] 0/1/-1 (any other code reads as missing) ->
    (rescaled root likelihood [P], its log scale [P]); the likelihood is
    their product ``lik * exp(acc)``."""
    lik, acc = _prune(trees, alleles[None], mutation_rate, prior)
    return lik[0], acc[0]


def phase_averaged_log_likelihood(trees, configs: torch.Tensor,
                                  mutation_rate: float,
                                  ancestral_aware: bool = False
                                  ) -> torch.Tensor:
    """[P] log of the site likelihood averaged over the phase configurations
    ``configs`` [C, n] of an unphased site (particleContainer.cpp:212-224):
    ``logsumexp`` over the configurations minus ``log(C)``.  The caller
    passes only the site's own configurations, so no mask is needed."""
    ll = site_log_likelihood(trees, configs, mutation_rate, ancestral_aware)
    C = configs.shape[0]
    if C == 1:
        return ll[0]
    return torch.logsumexp(ll, dim=0) - float(np.log(np.float32(C)))
