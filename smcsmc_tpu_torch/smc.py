"""The particle-filter sweep along the genome (counterpart of
``smcsmc_tpu/smc.py``, plain configuration).

One call of the segment step advances every particle over one .seg record:
the segment's tree pass (tree summaries, the recombination trips inside the
segment, the final extension and the push of the segment's statistics into
the lag FIFO: one launch of ``kernels.trip.segment_pass``), the site
likelihood at the segment end, the Kahan-compensated normalisation, the
lagged commit and, when the ESS drops, systematic resampling.  Segment descriptors (length, state, leaf status, distance to
the next site) stay on the host, so branching on them costs no device
synchronisation; the host reads the ESS once per segment to decide on
resampling.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .kernels.likelihood import site_log_likelihood
from .kernels.tree import (
    Epochs,
    Trees,
    branch_lengths,
    make_initial_trees,
)
from .kernels.trip import segment_pass

# recombination trips per particle and segment (the JAX sweep's
# max_recomb_iters bound)
MAX_RECOMB_ITERS = 64

# ---------------------------------------------------------------------------
# sufficient statistics: flat layout copied from smcsmc_tpu/smc.py:53-131
# ---------------------------------------------------------------------------


class SuffStats(NamedTuple):
    """Opportunity/count tensors (reference: count.hpp:92-100)."""

    coal_opp: np.ndarray  # [..., E, Pp]
    coal_cnt: np.ndarray  # [..., E, Pp]
    mig_opp: np.ndarray  # [..., E, Pp]
    mig_cnt: np.ndarray  # [..., E, Pp, Pp]
    recomb_opp: np.ndarray  # [..., E]
    recomb_cnt: np.ndarray  # [..., E]


def stats_field_shapes(E: int, Pp: int):
    return [(E, Pp), (E, Pp), (E, Pp), (E, Pp, Pp), (E,), (E,)]


def stats_width(E: int, Pp: int) -> int:
    return sum(int(np.prod(s)) for s in stats_field_shapes(E, Pp))


def unpack_stats(flat, E: int, Pp: int) -> SuffStats:
    """flat [..., K] -> SuffStats (numpy arrays or torch tensors)."""
    lead = flat.shape[:-1]
    out, off = [], 0
    for sh in stats_field_shapes(E, Pp):
        k = int(np.prod(sh))
        out.append(flat[..., off:off + k].reshape(tuple(lead) + sh))
        off += k
    return SuffStats(*out)


def pack_epoch_masks(masks, E: int, Pp: int) -> np.ndarray:
    """Per-field [E] masks -> one flat [K] float32 mask."""
    parts = []
    for m, sh in zip(masks, stats_field_shapes(E, Pp)):
        parts.append(np.repeat(np.asarray(m, np.float32), int(np.prod(sh)) // E))
    return np.concatenate(parts)


# ---------------------------------------------------------------------------
# configuration and state
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PFConfig:
    """Sweep configuration (reference flags at pfparam.cpp:63-169)."""

    num_particles: int
    num_leaves: int
    ess_threshold: float = 0.5  # resample when ESS < frac * P
    fifo_slots: int = 4  # lag FIFO depth


class PFState(NamedTuple):
    """Particle-filter state.  Device tensors except ``slot_open``,
    ``front`` (host float32, advanced by the host-known segment lengths)
    and ``num_resamples`` (host int)."""

    trees: Trees
    log_w: torch.Tensor  # [P] normalised log posterior weights
    next_rec: torch.Tensor  # [P] next recombination pos rel. to the front
    fifo: torch.Tensor  # [P, F, K] pending lagged statistics
    slot_open: np.ndarray  # [E] f32 position where the newest slot opened
    stats: torch.Tensor  # [K] committed, posterior-weighted
    stats_wt: torch.Tensor  # [K] committed, w^2-weighted
    ln_norm: torch.Tensor  # [] f32 accumulated log normaliser
    ln_norm_c: torch.Tensor  # [] f32 Kahan compensation
    front: np.float32  # sweep position, chunk-relative
    num_resamples: int


class Segment(NamedTuple):
    """One .seg record as the step consumes it: host scalars plus views
    into the chunk's device arrays."""

    length: int
    state: int  # SEGMENT_* code
    leaf_status: int  # -1 all missing / 0 mixed / 1 complete
    alleles: torch.Tensor  # [n] int8 segment-final site
    has_data: torch.Tensor  # [n] bool
    fifo_mask: torch.Tensor  # [K] f32 max_epoch_to_update gate


def _uniform_log_weight(P: int) -> float:
    """-log(P) rounded to float32, the weight of a freshly (re)sampled
    particle."""
    return float(-np.log(np.float32(P)))


def init_state(generator: torch.Generator, epochs: Epochs, cfg: PFConfig,
               sample_pop, rho: float, sample_time=None) -> PFState:
    """Draw the initial particle population (particleContainer.cpp:33-65)."""
    P = cfg.num_particles
    E, Pp = epochs.num_epochs, epochs.num_pops
    dev = epochs.start.device
    trees = make_initial_trees(generator, epochs, P, sample_pop, sample_time)
    treelen = branch_lengths(trees.time, trees.parent).sum(dim=1)
    expo = torch.empty(P, device=dev).exponential_(1.0, generator=generator)
    K = stats_width(E, Pp)
    return PFState(
        trees=trees,
        log_w=torch.full((P,), _uniform_log_weight(P), device=dev),
        next_rec=expo / (rho * treelen).clamp(min=1e-30),
        fifo=torch.zeros((P, cfg.fifo_slots, K), device=dev),
        slot_open=np.zeros(E, np.float32),
        stats=torch.zeros(K, device=dev),
        stats_wt=torch.zeros(K, device=dev),
        ln_norm=torch.zeros((), device=dev),
        ln_norm_c=torch.zeros((), device=dev),
        front=np.float32(0.0),
        num_resamples=0,
    )


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def systematic_resample(log_w: torch.Tensor, u) -> torch.Tensor:
    """Stratified inverse-CDF resampling (particleContainer.cpp:474-504)
    with the uniform ``u`` given; returns [P] int64 ancestor indices."""
    P = log_w.shape[0]
    cum = torch.softmax(log_w, dim=0).cumsum(dim=0)
    targets = (u + torch.arange(P, dtype=torch.float32, device=log_w.device)) / P
    return torch.searchsorted(cum, targets, right=False).clamp(0, P - 1)


def gather_particles(state: PFState, idx: torch.Tensor) -> PFState:
    """Ancestry gather: trees, FIFO and next recombination follow the
    particle (reference copy constructor, particle.cpp:113-136)."""
    return state._replace(
        trees=Trees(*(x.index_select(0, idx) for x in state.trees)),
        fifo=state.fifo.index_select(0, idx),
        next_rec=state.next_rec.index_select(0, idx),
    )


def commit_slot(state: PFState, rotate_e: np.ndarray, slot: int) -> PFState:
    """Commit FIFO slot ``slot`` for the epochs in ``rotate_e`` with the
    particles' current normalised weights (count.cpp:448-555), then rotate
    those epochs' FIFOs by one slot."""
    w = torch.softmax(state.log_w, dim=0)
    E = rotate_e.shape[0]
    rot = torch.as_tensor(
        pack_epoch_masks([np.asarray(rotate_e, np.float32)] * 6, E, 1),
        device=w.device)
    x = state.fifo[:, slot]
    stats = state.stats + rot * (x * w[:, None]).sum(dim=0)
    stats_wt = state.stats_wt + rot * (x * (w ** 2)[:, None]).sum(dim=0)
    rolled = torch.roll(state.fifo, 1, dims=1)
    rolled[:, 0] = 0.0
    fifo = torch.where(rot[None, None, :] > 0, rolled, state.fifo)
    return state._replace(stats=stats, stats_wt=stats_wt, fifo=fifo)


def flush_pending(state: PFState) -> PFState:
    """End-of-data flush: commit every pending slot with current weights
    (count.cpp:366), without rotating."""
    w = torch.softmax(state.log_w, dim=0)
    total = state.fifo.sum(dim=1)  # [P, K]
    return state._replace(
        stats=state.stats + (total * w[:, None]).sum(dim=0),
        stats_wt=state.stats_wt + (total * (w ** 2)[:, None]).sum(dim=0),
        fifo=torch.zeros_like(state.fifo),
    )


def fifo_gate_masks(dist_mut: np.ndarray, lags: np.ndarray) -> np.ndarray:
    """[S, K] max_epoch_to_update gate (smcsmc.cpp:266-275): an epoch
    records a segment's events only while the next informative site is
    closer than half its lag."""
    gate = (np.asarray(dist_mut, np.float32)[:, None]
            < 0.5 * np.asarray(lags, np.float32)[None, :]).astype(np.float32)
    return np.tile(gate, (1, 6))  # the six [E] fields of the Pp=1 layout


# ---------------------------------------------------------------------------
# one segment step
# ---------------------------------------------------------------------------


def make_segment_step(cfg: PFConfig, epochs: Epochs, mutation_rate: float,
                      rho: float, lags, generator: torch.Generator):
    """Build the per-segment step ``step(state, seg) -> (state, (ess,
    resampled, front))``.  The step updates the state's tensors in place."""
    P = cfg.num_particles
    F = cfg.fifo_slots
    dev = epochs.start.device
    span = (np.asarray(lags, np.float32) / np.float32(max(F - 1, 1)))
    mu = float(np.float32(mutation_rate))
    rho = float(np.float32(rho))
    inv2ne = epochs.inv2ne.contiguous()
    epoch_start = epochs.start.contiguous()
    log_w0 = _uniform_log_weight(P)
    T = MAX_RECOMB_ITERS
    tl = torch.empty(P, device=dev)  # post-trip tree length, per segment

    def step(state: PFState, seg: Segment):
        L = float(seg.length)
        trees = state.trees
        log_w = state.log_w
        next_rec = state.next_rec
        fifo = state.fifo

        # ---- the segment's tree pass: summaries, trips inside [front,
        # front + L), final extension, push into FIFO slot 0: one launch ----
        uniforms = torch.rand((T if L > 0 else 0, P, 4), generator=generator,
                              device=dev)
        segment_pass(uniforms, seg.leaf_status, trees.time, trees.parent,
                     trees.child0, trees.child1, next_rec, log_w, fifo,
                     seg.fifo_mask, tl, L, mu, rho, epoch_start, inv2ne,
                     seg.has_data)

        # ---- site likelihood at the segment-final position ----------------
        if seg.state == 0 and seg.leaf_status != -1:  # SEGMENT_INVARIANT
            log_w = log_w + site_log_likelihood(trees, seg.alleles, mu)

        # ---- normalise; Kahan-compensated log-likelihood in f32 -----------
        delta_ln = torch.logsumexp(log_w, dim=0)
        log_w = log_w - delta_ln
        y = delta_ln - state.ln_norm_c
        t = state.ln_norm + y
        ln_norm_c = (t - state.ln_norm) - y
        ln_norm = t

        front = np.float32(state.front + np.float32(L))
        state = state._replace(log_w=log_w, next_rec=next_rec, fifo=fifo,
                               ln_norm=ln_norm, ln_norm_c=ln_norm_c,
                               front=front)

        # ---- lagged commit: epochs rotate their FIFO every `span` bp ------
        rotate_e = (front - state.slot_open) >= span
        if rotate_e.any():
            state = commit_slot(state, rotate_e, F - 1)
        state = state._replace(
            slot_open=np.where(rotate_e, front, state.slot_open).astype(
                np.float32))

        # ---- ESS and resampling (one host read per segment) ---------------
        wp = torch.softmax(log_w, dim=0)
        ess = float(1.0 / (wp * wp).sum())
        need = ess < cfg.ess_threshold * P and seg.length > 0
        if need:
            u = torch.rand((), generator=generator, device=dev)
            idx = systematic_resample(log_w, u)
            state = gather_particles(state, idx)
            # clones re-draw their next recombination (memorylessness,
            # particle.cpp:393-436) from the post-trip tree length
            tl_r = tl.index_select(0, idx)
            expo = torch.empty(P, device=dev).exponential_(
                1.0, generator=generator)
            state = state._replace(
                log_w=torch.full_like(log_w, log_w0),
                next_rec=expo / (rho * tl_r).clamp(min=1e-30),
                num_resamples=state.num_resamples + 1,
            )
        return state, (ess, need, float(front))

    return step


def default_lags(epoch_start, rho: float) -> np.ndarray:
    """Per-epoch lag defaults (count.cpp:230-247): 4 / (rho * top_t), where
    top_t is the epoch's upper boundary; 20 kb if only one epoch."""
    start = np.asarray(epoch_start, dtype=np.float32)
    if start.shape[0] == 1:
        return np.array([20000.0], dtype=np.float32)
    top = np.append(start[1:], start[-1])
    return (4.0 / (rho * np.maximum(top, 1e-30))).astype(np.float32)
