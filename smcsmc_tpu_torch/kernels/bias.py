"""Height-biased recombination points and delayed importance weights: the
plain torch pieces of the biased segment pass.

Counterparts: ``smcsmc_tpu/kernels/transition.py::_sample_recomb_point_biased``
(:160, without guide branch rates), ``smcsmc_tpu/smc.py::_push_delayed``
(:488) and ``_apply_due_delayed`` (:540).  Under bias the proposal draws
the recombination point with density ``strength(section(y)) / weighted
length`` instead of ``1 / length``; the posterior weight takes the whole
importance weight at once, the pilot weight (on which the sweep resamples)
takes it at once only where the point's section is unbiased, and otherwise
through a ring of delayed factors, applied in ``k`` geometric steps as the
sweep moves on (particle.cpp:869-916).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .tree import INF, parent_time

# compile-time caps of the biased kernel (csrc/trip.cu MAX_SECTIONS,
# MAX_DELAY_SLOTS)
MAX_SECTIONS = 8
MAX_DELAY_SLOTS = 32
# which height keys the delay (pfparam.hpp:282): the recombination point,
# or the first coalescence; with one population and no migration the first
# coal-or-migration event (-delay_migr) is the coalescence
DELAY_TYPES = {"recomb": 0, "coal": 1, "migr": 1}


class BiasedPass(NamedTuple):
    """What a biased segment pass reads and updates beyond the plain one.
    The five tensors are updated IN PLACE."""

    log_pilot: torch.Tensor  # [P] f32 pilot (sampling) weights
    df_pos: torch.Tensor  # [P, K] f32 next application position (INF: free)
    df_logf: torch.Tensor  # [P, K] f32 log factor per application
    df_delta: torch.Tensor  # [P, K] f32 spacing, doubled per application
    df_k: torch.Tensor  # [P, K] i32 applications left
    heights: torch.Tensor  # [S+1] f32 section boundaries 0, h_1, ..., INF
    strengths: torch.Tensor  # [S] f32 proposal weight of each section
    delays: torch.Tensor  # [E] f32 application delay (bp) by epoch
    front: float  # the segment's start, chunk relative (host float32)
    delay_type: str = "recomb"  # a key of DELAY_TYPES
    delay_k: int = 3  # geometric applications (particle.cpp:891)


def section_of(heights: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """[P] bias section of heights ``h``: the last boundary at or below."""
    S = heights.shape[0] - 1
    cnt = (heights[None, :] <= h[:, None]).sum(dim=1)
    return (cnt - 1).clamp(0, S - 1)


def epoch_index(epoch_start: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[P] epoch of times ``t`` by comparison count (transition.py:88)."""
    E = epoch_start.shape[0]
    cnt = (t[:, None] >= epoch_start[None, :]).sum(dim=1)
    return (cnt - 1).clamp(0, E - 1)


def biased_point(u, time, parent, heights, strengths):
    """Height-biased recombination point of every particle from its
    uniform ``u`` [P]: the weighted segments ``|branch_j ∩ section_s| *
    strength_s`` in node-major order, the first whose running sum reaches
    ``u`` times their total.  Returns (c [P] i32, h_r, log_iw, strength),
    ``log_iw = log(weighted length) - log(length) - log(strength)``."""
    P, N = time.shape
    S = strengths.shape[0]
    pt = parent_time(time, parent)
    lo = torch.maximum(time[:, :, None], heights[None, None, :-1])  # [P,N,S]
    hi = torch.minimum(pt[:, :, None], heights[None, None, 1:])
    seg = (hi - lo).clamp(min=0.0)
    seg = torch.where(parent[:, :, None] < 0, torch.zeros_like(seg), seg)
    cum = (seg * strengths[None, None, :]).reshape(P, N * S).cumsum(dim=1)
    weighted = cum[:, -1]
    plain = seg.sum(dim=(1, 2))
    x = u * weighted
    hit = cum >= x[:, None]
    idx = torch.where(hit.any(dim=1), hit.to(torch.int32).argmax(dim=1),
                      torch.full_like(hit[:, 0], N * S - 1, dtype=torch.int64))
    prev = torch.where(
        idx > 0, cum.gather(1, (idx - 1).clamp(min=0)[:, None])[:, 0],
        torch.zeros_like(x))
    s = idx % S
    strength = strengths[s]
    h_r = (lo.reshape(P, N * S).gather(1, idx[:, None])[:, 0]
           + (x - prev) / strength.clamp(min=1e-30))
    log_iw = (torch.log(weighted) - torch.log(plain.clamp(min=1e-30))
              - torch.log(strength.clamp(min=1e-30)))
    return (idx // S).to(torch.int32), h_r, log_iw, strength


def push_delayed(df_pos, df_logf, df_delta, df_k, mask, pos, delay, log_iw,
                 kk: int):
    """Insert k-step geometric delayed factors into each masked particle's
    first free slot (particle.hpp:63-82): k applications of ``log_iw / k``
    at ``pos + delta``, then after 2 delta, 4 delta, ..., the last at ``pos
    + delay``, with ``delta = delay / (2^k - 1)``.  A particle whose ring is
    full takes the whole factor at once: returns the new ring and that
    additive pilot-weight correction."""
    K = df_pos.shape[1]
    free = df_pos >= 0.5 * INF
    has_free = free.any(dim=1)
    slot = free.to(torch.int32).argmax(dim=1)
    delta = delay / (2.0 ** kk - 1.0)
    do = mask & has_free
    hit = (torch.arange(K, device=df_pos.device)[None, :] == slot[:, None]) \
        & do[:, None]
    df_pos = torch.where(hit, (pos + delta)[:, None], df_pos)
    df_logf = torch.where(hit, (log_iw / kk)[:, None], df_logf)
    df_delta = torch.where(hit, delta[:, None], df_delta)
    df_k = torch.where(hit, torch.full_like(df_k, kk), df_k)
    overflow = torch.where(mask & ~has_free, log_iw, torch.zeros_like(log_iw))
    return df_pos, df_logf, df_delta, df_k, overflow


def apply_due_delayed(df_pos, df_logf, df_delta, df_k, front: float):
    """Apply every factor whose position the sweep has reached
    (particle.cpp:911-916, applyDelayedAdjustment particle.hpp:199-209):
    returns the additive pilot-weight update [P] and the new ring."""
    due = df_pos <= front
    add = torch.where(due, df_logf, torch.zeros_like(df_logf)).sum(dim=1)
    again = due & (df_k > 1)
    done = due & (df_k <= 1)
    df_pos = torch.where(again, df_pos + 2.0 * df_delta,
                         torch.where(done, torch.full_like(df_pos, INF),
                                     df_pos))
    df_delta = torch.where(again, 2.0 * df_delta, df_delta)
    df_k = torch.where(again, df_k - 1,
                       torch.where(done, torch.zeros_like(df_k), df_k))
    df_logf = torch.where(done, torch.zeros_like(df_logf), df_logf)
    return add, df_pos, df_logf, df_delta, df_k
