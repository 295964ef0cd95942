"""The APF lookahead log-likelihood, batched over particles (counterpart of
``smcsmc_tpu/kernels/lookahead.py``; plain torch operations, written over
the particle axis instead of vmapped).

``ForestState::includeLookaheadLikelihood`` (particle.cpp:439-617) on the
array trees:

- singletons (apf >= 1): for each leaf, the probability of the distance to
  its first singleton given the leaf's terminal branch, integrated over two
  recombination-rate regimes (the expected one and half of it) and over the
  model's terminal-branch-length quantiles (particle.cpp:473-525);
- doubletons (apf >= 2): for each doubleton, the probability of keeping or
  acquiring the cherry given the evidence distances (particle.cpp:526-570);
- the first split (apf >= 3): the probability of the first variant with
  more than two carriers given the tree (particle.cpp:572-608); apf 4 takes
  the equilibrium split probability 1/C(n, k) (particle.cpp:593-595).

The result enters the pilot weight only (the resampling guide) and is
divided back out of the posterior at resampling: an auxiliary particle
filter.  Every constant is rounded to float32 as the JAX package's traced
scalars are.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .likelihood import site_likelihood_scaled

# two recombination-rate regimes (particle.cpp:455-456)
_REL_RHO = (1.0, 0.5)
_REL_RHO_P = (0.5, 0.5)
_TINY = 1e-30

# terminal-branch-length quantile probabilities (smcsmc.cpp:134)
TBLQ_PROBS = (0.001, 0.003, 0.01, 0.03, 0.1, 0.5, 0.95)


def tblq_bin_widths(probs=TBLQ_PROBS):
    """Integration weights per quantile bin: qbot = prev (0 for the first),
    qtop = next (1 for the last) — particle.cpp:497-499."""
    probs = np.asarray(probs, dtype=np.float32)
    qbot = np.concatenate([[0.0], probs[:-1]])
    qtop = np.concatenate([probs[:-1], [1.0]])
    return qtop - qbot


class Quantiles(NamedTuple):
    """The model's terminal branch lengths, from
    ``calibrate.terminal_branch_quantiles``."""

    lengths: torch.Tensor  # [n, Q] f32 quantiles of each leaf's branch
    widths: torch.Tensor  # [Q] f32 integration weights (tblq_bin_widths)
    etbl: float  # mean tree length
    l_mean: float  # mean of the top quantiles (particle.cpp:529-530)


def _f32(x) -> float:
    return float(np.float32(x))


def _shift(x: torch.Tensor) -> torch.Tensor:
    """x[..., j - 1] at j (0 at j = 0)."""
    return torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=-1)


def singleton_loglik(pt_leaf, fsd, rel_mu, unph, mu, rho, tblq_len, tblq_w):
    """([P] log-probability of the per-leaf first-singleton distances,
    [P, n] mutation probability per leaf for the doubleton term).

    pt_leaf [P, n]: the leaves' parent heights; fsd, rel_mu [n] f32, unph
    [n] bool; tblq_len [n, Q]; tblq_w [Q]."""
    n = pt_leaf.shape[1]
    # unphased-het pairs: the even index carries the combined branch length
    # (particle.cpp:475-480); the odd partner is skipped (particle.cpp:522-524)
    li_next = torch.cat([pt_leaf[:, 1:], torch.zeros_like(pt_leaf[:, :1])], 1)
    li = torch.where(unph, pt_leaf + li_next, pt_leaf)
    skip = _shift(unph)

    rho_tbl = _f32(_f32(_f32(2.0 * np.float32(rho)) * np.float32(n - 1))
                   / np.float32(n))
    li_mu = li * mu * rel_mu  # [P, n]
    # mut_prob mirrors onto the skipped partner (particle.cpp:484-488)
    mut_prob = torch.where(skip, _shift(li_mu), li_mu)

    asi = fsd.abs()
    lprime_mu = tblq_len * mu * rel_mu[:, None]  # [n, Q]
    p = torch.zeros_like(li)
    for r, rp in zip(_REL_RHO, _REL_RHO_P):
        li_rho = li * rho_tbl * r  # [P, n]
        s = li_rho + li_mu
        fe = torch.exp(-s * asi)
        a = s[:, :, None]  # [P, n, 1]
        # guard near-singular divisor (particle.cpp:502-504)
        near = (a - lprime_mu).abs() < (a + lprime_mu) * 1e-5
        lpm = torch.where(near, lprime_mu * _f32(1.0001), lprime_mu)
        div = a - lpm
        e_l = torch.exp(-lpm * asi[:, None])
        mu_l = li_mu[:, :, None] - lpm
        term_mut = (li_rho[:, :, None] * lpm * e_l
                    + mu_l * a * fe[:, :, None]) / div
        term_miss = (li_rho[:, :, None] * e_l + mu_l * fe[:, :, None]) / div
        term = torch.where((fsd > 0)[:, None], term_mut, term_miss)
        p = p + rp * (term * tblq_w).sum(dim=2)
    logp = torch.where(skip, 0.0, torch.log(p.clamp(min=_TINY)))
    return logp.sum(dim=1), mut_prob


def doubleton_loglik(parent, pt_leaf, mut_prob, dbl, rho, l_mean):
    """[P] log-probability of the observed doubletons (particle.cpp:526-570).

    dbl = (s1, s2 [D] i32 (-1: an empty slot), first_ev, last_ev [D] f32,
    u1, u2 [D] bool)."""
    s1, s2, first_ev, last_ev, u1, u2 = dbl
    n = pt_leaf.shape[1]
    valid = s1 >= 0
    s1c = s1.clamp(0, n - 1).long()
    s2c = s2.clamp(0, n - 1).long()
    rho32 = np.float32(rho)
    rho_c = _f32(_f32(_f32(4.0 * rho32) * np.float32(n - 2)) / np.float32(n))
    rhoprime_c = _f32(rho32 * np.float32(n - 1))
    p_eq = _f32(2.0 / (3.0 * (n - 1)))

    # greedy phasing search for the cherry (particle.cpp:536-543): the
    # first match in (ph1, ph2) = (0,0), (0,1), (1,0), (1,1) order wins
    has_cherry = torch.zeros(parent.shape[0], s1.shape[0], dtype=torch.bool,
                             device=parent.device)
    cherry_leaf = s1c.expand_as(has_cherry)
    for ph1, ph2 in ((0, 0), (0, 1), (1, 0), (1, 1)):
        i1 = (s1c + ph1).clamp(0, n - 1)
        i2 = (s2c + ph2).clamp(0, n - 1)
        ok = ((ph1 <= u1.long()) & (ph2 <= u2.long())
              & (s1c + ph1 <= n - 1) & (s2c + ph2 <= n - 1))
        m = (parent[:, i1] == parent[:, i2]) & ok
        cherry_leaf = torch.where(m & ~has_cherry, i1, cherry_leaf)
        has_cherry = has_cherry | m
    l_ch = pt_leaf.gather(1, cherry_leaf)  # [P, D]

    p_ch = torch.zeros_like(l_ch)
    p_noch = torch.zeros_like(l_ch)
    mutprob = 0.5 * (mut_prob[:, s1c] + mut_prob[:, s2c])
    for r, rp in zip(_REL_RHO, _REL_RHO_P):
        exp_rho = torch.exp(_f32(-rho_c * np.float32(r)) * l_ch * last_ev)
        # NB the equilibrium term is NOT weighted by rel_rho_p in the
        # reference (particle.cpp:550): p += rp*exp_rho + p_eq*(1-exp_rho)
        p_ch = p_ch + rp * exp_rho + p_eq * (1.0 - exp_rho)
        far = _f32(_f32(-rhoprime_c * np.float32(r)) * np.float32(l_mean))
        p_noch = p_noch + rp * (
            mutprob + (1.0 - mutprob) * p_eq
            * (1.0 - torch.exp(far * first_ev)))
    p = torch.where(has_cherry, p_ch, p_noch)
    return torch.where(valid, torch.log(p.clamp(min=_TINY)), 0.0).sum(dim=1)


def split_loglik(trees, treelen, split_dist, split_alleles, split_k, mu,
                 rho, etbl, apf_level):
    """[P] log-probability of the first split (particle.cpp:572-608); 0
    where the segment saw none (``split_dist`` -1)."""
    n = trees.num_leaves
    valid = bool(split_dist > -0.5)
    if not valid:
        return torch.zeros_like(treelen)
    rate_of_change = treelen * _f32(rho) / 2.0
    p_nochange = torch.exp(-rate_of_change * max(float(split_dist), 0.0))
    lik, acc = site_likelihood_scaled(trees, split_alleles, mu)
    p_splitdata = lik * torch.exp(acc)
    k = float(split_k)
    if apf_level == 4:
        # 1 / nchoosek(n, k) via lgamma (particle.cpp:594-595)
        logc = (np.float32(math.lgamma(n + 1.0))
                - np.float32(math.lgamma(k + 1.0))
                - np.float32(math.lgamma(n - k + 1.0)))
        p_correct = _f32(np.exp(-np.float32(logc)))
    else:
        p_correct = _f32(np.float32(k) / np.float32(4.0 * n * n))
    # reproduces the reference expression literally, 2n * (0.577 * ln n)
    # (particle.cpp:605; the comment says gamma + ln n but the code multiplies)
    sbl = _f32(np.float32(k) * np.float32(etbl)
               / (np.float32(2.0 * n) * (np.float32(0.577)
                                         * np.log(np.float32(n)))))
    p = p_nochange * p_splitdata + (1.0 - p_nochange) * p_correct * mu * sbl
    return torch.log(p.clamp(min=_TINY))


def lookahead_loglik(trees, treelen, la_seg, quantiles: Quantiles, mu, rho,
                     apf_level: int) -> torch.Tensor:
    """[P] lookahead log-likelihood of one segment for every particle.

    trees: the post-trip trees; treelen [P] their length; la_seg: the
    segment's columns (fsd, rel_mu, unph [n]; dbl_s1, dbl_s2, dbl_first,
    dbl_last, dbl_unph1, dbl_unph2 [D]; split_dist, split_alleles [n],
    split_k) on the trees' device, but the split's distance and count,
    which are host numbers."""
    (fsd, rel_mu, unph, d_s1, d_s2, d_first, d_last, d_u1, d_u2,
     sp_dist, sp_alleles, sp_k) = la_seg
    n = fsd.shape[0]
    mu = _f32(mu)
    time, parent = trees.time, trees.parent
    pt_leaf = time.gather(1, parent[:, :n].clamp(0, time.shape[1] - 1).long())
    ll, mut_prob = singleton_loglik(pt_leaf, fsd, rel_mu, unph, mu, rho,
                                    quantiles.lengths, quantiles.widths)
    if apf_level >= 2:
        ll = ll + doubleton_loglik(parent, pt_leaf, mut_prob,
                                   (d_s1, d_s2, d_first, d_last, d_u1, d_u2),
                                   rho, quantiles.l_mean)
    if apf_level >= 3:
        ll = ll + split_loglik(trees, treelen, sp_dist, sp_alleles, sp_k, mu,
                               rho, quantiles.etbl, apf_level)
    return ll
