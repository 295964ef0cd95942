"""The particle-filter sweep along the genome (counterpart of
``smcsmc_tpu/smc.py``: one population, with or without height-biased
recombination, or structured populations with migration).

One call of the segment step advances every particle over one .seg record:
the segment's tree pass (tree summaries, the recombination trips inside the
segment, the final extension and the push of the segment's statistics into
the lag FIFO: one launch of ``kernels.trip.segment_pass``), the site
likelihood at the segment end, the Kahan-compensated normalisation, the
lagged commit and, when the ESS drops, systematic resampling.  Under bias
(``PFConfig.use_bias``) the same launch also tracks the pilot weights and
the ring of delayed importance factors; the step then normalises the pilot,
takes the ESS from it and resamples on it with the auxiliary reweight.
With several populations (``PFConfig.has_migration``) the launch is the
migration pass: the loop walk with migration, the SPR routing the branches'
migration buffers, walks capped and events dropped counted into
``PFState.diag``; resampling gathers the populations and buffers too.
Under bias, a guide or local recording with several populations the
launch is the migration pass's proposal variant of the same flags.
With VB tables the launch is the pass's VB variant, which adds each trip's
VB term to the weights.  With a recombination guide (``PFConfig.use_guide``)
the launch is the guided biased pass (one section of strength 1 without
height bias): gaps in guide mass, branch weights by the guide's rates, the
survival weight of each extension; the pilot is tracked as under bias.
With local recording (``PFConfig.num_windows`` > 0) each trip also pushes
a pending event into the particle's ring of local events, and the step
spreads the segment's recombination opportunity over its windows and adds
the events that came due to theirs (``kernels.local``).  With the APF
(``PFConfig.apf``) the step adds the segment's lookahead log-likelihood
to the pilot weights (normalised: the
effective pilot), takes the ESS from it and resamples on it with the
auxiliary reweight; the pilot itself never keeps the lookahead.  With ARG
recording (``PFConfig.record_arg``) each trip also pushes its rows into
the particle's ARG ring (``kernels.arg``), which resampling gathers with
the particle.
Segment descriptors (length, state, leaf status, distance to the next site)
stay on the host, so branching on them costs no device synchronisation; the
host reads the ESS once per segment to decide on resampling.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .kernels.arg import ARG_FIELDS, ARG_SLOTS, ArgPass, init_arg_ring
from .kernels.bias import BiasedPass
from .kernels.guide import GuideTables, draw_gap, inv_mass
from .kernels.likelihood import phase_averaged_log_likelihood
from .kernels.local import LocalPass, add_window_opportunity, commit_due_local
from .kernels.lookahead import Quantiles, lookahead_loglik
from .kernels.migration import (
    MAX_WALK_EVENTS,
    MigrationPass,
    migration_tables,
    stats_field_shapes,
    stats_offsets,
)
from .kernels.tree import (
    INF,
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
# sufficient statistics: the flat row of kernels.migration.stats_offsets
# ---------------------------------------------------------------------------


class SuffStats(NamedTuple):
    """Opportunity/count tensors (reference: count.hpp:92-100)."""

    coal_opp: np.ndarray  # [..., E, Pp]
    coal_cnt: np.ndarray  # [..., E, Pp]
    mig_opp: np.ndarray  # [..., E, Pp]
    mig_cnt: np.ndarray  # [..., E, Pp, Pp]
    recomb_opp: np.ndarray  # [..., E]
    recomb_cnt: np.ndarray  # [..., E]


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
    """One [..., E] mask per field -> one flat [..., K] float32 mask, each
    epoch's value repeated over the field's populations."""
    parts = []
    for m, sh in zip(masks, stats_field_shapes(E, Pp)):
        parts.append(np.repeat(np.asarray(m, np.float32),
                               math.prod(sh) // E, axis=-1))
    return np.concatenate(parts, axis=-1)


@dataclass(frozen=True)
class PFConfig:
    """Sweep configuration (reference flags at pfparam.cpp:63-169)."""

    num_particles: int
    num_leaves: int
    ess_threshold: float = 0.5  # resample when ESS < frac * P
    fifo_slots: int = 4  # lag FIFO depth
    ancestral_aware: bool = False  # allele 0 is ancestral (root prior 1:0)
    use_bias: bool = False  # height-biased recombination sampling
    delay_slots: int = 32  # delayed-importance-factor ring capacity
    delay_k: int = 3  # k-step geometric application (particle.cpp:891)
    # which height keys the delay (particle.cpp:874-876): "recomb" (the
    # recombination point), "coal" (-delay_coal) or "migr" (-delay_migr:
    # the first coalescence or migration of the new branch; the
    # coalescence without migration)
    delay_type: str = "recomb"
    # several populations: the migration pass (the loop walk; a -ej split
    # without migration runs it with zero rates)
    has_migration: bool = False
    max_walk_events: int = MAX_WALK_EVENTS  # bound of a migration walk
    max_mig: int = 16  # events per branch buffer (with has_migration)
    apf: int = 0  # auxiliary-particle-filter level 0-4 (-apf, particle.cpp:439)
    # recombination guide (pfparam.hpp:96-223): gaps in guide mass, points
    # weighed by the guide's per-leaf rates; the pilot is tracked
    use_guide: bool = False
    # local recombination recording (count.cpp:559-654); num_windows > 0
    # turns it on.  Windows are chunk relative.
    num_windows: int = 0  # ceil(chunk_len / window_size)
    window_size: float = 100.0  # local_recording_interval_ (count.hpp:115)
    local_ring: int = 32  # pending local events per particle
    record_arg: bool = False  # keep a per-particle ARG event ring (-arg)
    arg_slots: int = ARG_SLOTS  # its capacity (the newest rows are kept)

    @property
    def desc_words(self) -> int:
        """u32 words per descendant bitmask in the JAX package's layout (the
        port keeps one int64): 1 up to 32 leaves, 2 up to the reference's
        64-leaf Descendants_t contract (descendants.hpp:16)."""
        if self.num_leaves > 64:
            raise ValueError(
                "descendant recording supports at most 64 sample haplotypes "
                f"(got {self.num_leaves}); reference has the same u64 cap"
            )
        return 1 if self.num_leaves <= 32 else 2

    @property
    def tracks_pilot(self) -> bool:
        """The pilot weights differ from the posterior ones: under bias
        or the guide (under the APF alone they are equal until the step's
        lookahead)."""
        return self.use_bias or self.use_guide


class PFState(NamedTuple):
    """Particle-filter state.  Device tensors except ``slot_open``,
    ``front`` (host float32, advanced by the host-known segment lengths)
    and ``num_resamples`` (host int)."""

    trees: Trees
    log_w: torch.Tensor  # [P] normalised log posterior weights
    log_pilot: torch.Tensor  # [P] pilot (sampling) weights; log_w itself
    # when there is no bias
    next_rec: torch.Tensor  # [P] next recombination pos rel. to the front
    fifo: torch.Tensor  # [P, F, K] pending lagged statistics
    slot_open: np.ndarray  # [E] f32 position where the newest slot opened
    stats: torch.Tensor  # [K] committed, posterior-weighted
    stats_wt: torch.Tensor  # [K] committed, w^2-weighted
    ln_norm: torch.Tensor  # [] f32 accumulated log normaliser
    ln_norm_c: torch.Tensor  # [] f32 Kahan compensation
    front: np.float32  # sweep position, chunk-relative
    num_resamples: int
    # delayed importance factors (particle.hpp:59-101 as a fixed ring; a
    # free slot has pos == INF); capacity 1 and untouched without bias
    df_pos: torch.Tensor  # [P, K] application position (chunk relative)
    df_logf: torch.Tensor  # [P, K] log factor applied per activation
    df_delta: torch.Tensor  # [P, K] spacing; doubles per activation
    df_k: torch.Tensor  # [P, K] i32 remaining activations
    # approximation pressure of the migration pass: [0] walks that hit
    # max_walk_events (force-coalesced), [1] migration events dropped on
    # buffer overflow (float64, so that the kernel's atomic adds of whole
    # counts stay exact and order-free)
    diag: torch.Tensor = None  # [2] f64
    # local recording (None without it): the window accumulators, and the
    # per-particle ring of pending events (count.cpp:559-613)
    win_opp_diff: torch.Tensor = None  # [W+1] differential opportunity
    win_cnt: torch.Tensor = None  # [W, n+2] leaf, time, log-time counts
    lr_pos: torch.Tensor = None  # [P, R] event position (INF: free slot)
    lr_due: torch.Tensor = None  # [P, R] commit position
    lr_time: torch.Tensor = None  # [P, R] recombination height
    lr_desc: torch.Tensor = None  # [P, R] i64 leaves below the cut branch
    lr_dropped: torch.Tensor = None  # [] i32 events dropped on a full ring
    # ARG recording (None without it): the ring of kernels.arg.ArgPass
    arg_pos: torch.Tensor = None  # [P, A] f32
    arg_code: torch.Tensor = None  # [P, A] i8 0 R, 1 C, 2 M
    arg_time: torch.Tensor = None  # [P, A] f32
    arg_from: torch.Tensor = None  # [P, A] i8
    arg_to: torch.Tensor = None  # [P, A] i8
    arg_desc: torch.Tensor = None  # [P, A] i64 leaf bitmask (<= 64 leaves)
    arg_n: torch.Tensor = None  # [P] i32 rows pushed (the ring index)


class Segment(NamedTuple):
    """One .seg record as the step consumes it: host scalars plus views
    into the chunk's device arrays."""

    length: int
    state: int  # SEGMENT_* code
    leaf_status: int  # -1 all missing / 0 mixed / 1 complete
    configs: torch.Tensor  # [C, n] int8: the segment-final site's phase
    # configurations (C = 1 for a phased site; only the site's own, no padding)
    has_data: torch.Tensor  # [n] bool
    fifo_mask: torch.Tensor  # [K] f32 recording gate (fifo_gate_masks)
    # the APF lookahead's columns of the segment (kernels.lookahead.
    # lookahead_loglik's la_seg), or None without the APF
    lookahead: tuple | None = None


def _uniform_log_weight(P: int) -> float:
    """-log(P) rounded to float32, the weight of a freshly (re)sampled
    particle."""
    return float(-np.log(np.float32(P)))


def init_state(generator: torch.Generator, epochs: Epochs, cfg: PFConfig,
               sample_pop, rho: float, sample_time=None,
               guide: GuideTables | None = None) -> PFState:
    """Draw the initial particle population (particleContainer.cpp:33-65).
    Under ``cfg.use_guide`` the first gap is drawn in the ``guide``'s mass
    (smc.py:294-303 of the JAX package)."""
    P = cfg.num_particles
    E, Pp = epochs.num_epochs, epochs.num_pops
    dev = epochs.start.device
    trees = make_initial_trees(generator, epochs, P, sample_pop, sample_time,
                               cfg.max_mig if cfg.has_migration else 0)
    treelen = branch_lengths(trees.time, trees.parent).sum(dim=1)
    expo = torch.empty(P, device=dev).exponential_(1.0, generator=generator)
    K = stats_offsets(E, Pp)["width"]
    log_w = torch.full((P,), _uniform_log_weight(P), device=dev)
    D = cfg.delay_slots if cfg.tracks_pilot else 1
    gap = expo / (rho * treelen).clamp(min=1e-30)
    if cfg.use_guide and guide is not None:
        gap = inv_mass(guide, gap)
    rings = {}  # local recording's and the ARG's, where the sweep keeps them
    if cfg.num_windows > 0:
        W, R, n = cfg.num_windows, cfg.local_ring, cfg.num_leaves
        rings = dict(
            win_opp_diff=torch.zeros(W + 1, device=dev),
            win_cnt=torch.zeros((W, n + 2), device=dev),
            lr_pos=torch.full((P, R), INF, device=dev),
            lr_due=torch.full((P, R), INF, device=dev),
            lr_time=torch.zeros((P, R), device=dev),
            lr_desc=torch.zeros((P, R), dtype=torch.int64, device=dev),
            lr_dropped=torch.zeros((), dtype=torch.int32, device=dev))
    if cfg.record_arg:
        if cfg.desc_words:  # raises above 64 leaves
            rings.update(init_arg_ring(trees, cfg.arg_slots))
    return PFState(
        trees=trees,
        log_w=log_w,
        log_pilot=log_w.clone() if cfg.tracks_pilot else log_w,
        next_rec=gap,
        fifo=torch.zeros((P, cfg.fifo_slots, K), device=dev),
        slot_open=np.zeros(E, np.float32),
        stats=torch.zeros(K, device=dev),
        stats_wt=torch.zeros(K, device=dev),
        ln_norm=torch.zeros((), device=dev),
        ln_norm_c=torch.zeros((), device=dev),
        front=np.float32(0.0),
        num_resamples=0,
        df_pos=torch.full((P, D), INF, device=dev),
        df_logf=torch.zeros((P, D), device=dev),
        df_delta=torch.zeros((P, D), device=dev),
        df_k=torch.zeros((P, D), dtype=torch.int32, device=dev),
        diag=torch.zeros(2, dtype=torch.float64, device=dev),
        **rings,
    )


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def block_scan(x: torch.Tensor, width: int = 128) -> torch.Tensor:
    """Inclusive prefix sum of a vector whose float result does not depend
    on the device's timing.

    ``x.cumsum(0)`` of a vector goes to a single-pass scan across blocks
    (CUB's decoupled look-back): a block adds its predecessors' partial
    sums in whatever grouping it finds ready, so the rounding changes from
    run to run.  Here the vector is cut into rows of ``width``: each row is
    scanned within one block, and the row totals are scanned down dim 0 of
    a [rows, 2] tensor, which torch does with one thread per column, in
    order.  At least two rows, so that neither scan is of a lone vector."""
    n = x.shape[0]
    rows = max(2, -(-n // width))
    padded = x.new_zeros(rows * width)
    padded[:n] = x
    within = padded.view(rows, width).cumsum(1)
    totals = within[:, -1:]
    before = torch.cat([totals, torch.zeros_like(totals)], 1).cumsum(0)[:, :1]
    return (within + (before - totals)).reshape(-1)[:n]


def systematic_resample(log_w: torch.Tensor, u) -> torch.Tensor:
    """Stratified inverse-CDF resampling (particleContainer.cpp:474-504)
    with the uniform ``u`` given; returns [P] int64 ancestor indices."""
    P = log_w.shape[0]
    cum = block_scan(torch.softmax(log_w, dim=0))
    targets = (u + torch.arange(P, dtype=torch.float32, device=log_w.device)) / P
    return torch.searchsorted(cum, targets, right=False).clamp(0, P - 1)


def gather_particles(state: PFState, idx: torch.Tensor,
                     ring: bool = True) -> PFState:
    """Ancestry gather: trees (with their populations and migration
    buffers), FIFO, next recombination, (with ``ring``) the delayed
    factors, the ring of pending local events and the ARG ring follow the
    particle (reference copy constructor, particle.cpp:113-136)."""
    state = state._replace(
        trees=Trees(*(None if x is None else x.index_select(0, idx)
                      for x in state.trees)),
        fifo=state.fifo.index_select(0, idx),
        next_rec=state.next_rec.index_select(0, idx),
    )
    if ring:
        state = state._replace(**{
            k: getattr(state, k).index_select(0, idx)
            for k in ("df_pos", "df_logf", "df_delta", "df_k")})
    if state.lr_pos is not None:
        state = state._replace(**{
            k: getattr(state, k).index_select(0, idx)
            for k in ("lr_pos", "lr_due", "lr_time", "lr_desc")})
    if state.arg_pos is not None:
        state = state._replace(**{
            k: getattr(state, k).index_select(0, idx) for k in ARG_FIELDS})
    return state


def commit_slot(state: PFState, rotate_e: np.ndarray, slot: int,
                Pp: int) -> PFState:
    """Commit FIFO slot ``slot`` for the epochs in ``rotate_e`` with the
    particles' current normalised weights (count.cpp:448-555), then rotate
    those epochs' FIFOs by one slot.  The rows have the layout of ``Pp``
    populations."""
    w = torch.softmax(state.log_w, dim=0)
    E = rotate_e.shape[0]
    rot = torch.as_tensor(
        pack_epoch_masks([np.asarray(rotate_e, np.float32)] * 6, E, Pp),
        device=w.device)
    x = state.fifo[:, slot]
    stats = state.stats + rot * (x * w[:, None]).sum(dim=0)
    stats_wt = state.stats_wt + rot * (x * (w ** 2)[:, None]).sum(dim=0)
    rolled = torch.roll(state.fifo, 1, dims=1)
    rolled[:, 0] = 0.0
    fifo = torch.where(rot[None, None, :] > 0, rolled, state.fifo)
    return state._replace(stats=stats, stats_wt=stats_wt, fifo=fifo)


def flush_pending(state: PFState, window_size: float = 100.0) -> PFState:
    """End-of-data flush: commit every pending slot with current weights
    (count.cpp:366), without rotating; every pending local event is
    committed likewise, into windows of ``window_size`` bp."""
    w = torch.softmax(state.log_w, dim=0)
    total = state.fifo.sum(dim=1)  # [P, K]
    if state.lr_pos is not None:
        commit_due_local(state.win_cnt, state.lr_pos, state.lr_due,
                         state.lr_time, state.lr_desc, w, INF, window_size)
    return state._replace(
        stats=state.stats + (total * w[:, None]).sum(dim=0),
        stats_wt=state.stats_wt + (total * (w ** 2)[:, None]).sum(dim=0),
        fifo=torch.zeros_like(state.fifo),
    )


def fifo_gate_masks(dist_mut: np.ndarray, lags: np.ndarray,
                    xc_epochs=(), xr_epochs=(), Pp: int = 1) -> np.ndarray:
    """[S, K] recording gate of every segment, built once on the host.

    max_epoch_to_update (smcsmc.cpp:266-275): an epoch records a segment's
    events only while the next informative site is closer than half its
    lag.  Folded in are the recording masks of ``-xc`` / ``-xr``
    (record_event_in_epoch, pfparam.cpp:82-99): the epochs in ``xc_epochs``
    record no coalescence or migration statistic, those in ``xr_epochs`` no
    recombination statistic.  The row has the layout of ``Pp`` populations
    (``stats_offsets(E, Pp)["width"]`` columns)."""
    gate = (np.asarray(dist_mut, np.float32)[:, None]
            < 0.5 * np.asarray(lags, np.float32)[None, :]).astype(np.float32)
    E = gate.shape[1]
    xc = np.ones(E, np.float32)
    xr = np.ones(E, np.float32)
    xc[[e for e in xc_epochs if 0 <= e < E]] = 0.0
    xr[[e for e in xr_epochs if 0 <= e < E]] = 0.0
    return pack_epoch_masks([gate * xc] * 4 + [gate * xr] * 2, E, Pp)


# ---------------------------------------------------------------------------
# one segment step
# ---------------------------------------------------------------------------


def make_segment_step(cfg: PFConfig, epochs: Epochs, mutation_rate: float,
                      rho: float, lags, generator: torch.Generator,
                      bias_heights=None, bias_strengths=None, delays=None,
                      vb_tables=None, quantiles: Quantiles | None = None,
                      guide: GuideTables | None = None):
    """Build the per-segment step ``step(state, seg) -> (state, (ess,
    resampled, front))``.  The step updates the state's tensors in place.

    With ``cfg.use_bias``: ``bias_heights`` [S+1] (0, the section
    boundaries in generations, INF), ``bias_strengths`` [S] and the
    delayed factors' application ``delays`` [E] (bp) by epoch.
    ``vb_tables`` = (vb_coal [E, Pp], vb_mig [E, Pp, Pp]) with the ``-xc``
    epochs' entries 0 turns VB on.  With ``cfg.apf`` > 0: the model's
    terminal branch ``quantiles``, and every segment carries its lookahead
    columns.  With ``cfg.use_guide``: the chunk's ``guide`` tables and the
    ``delays``; without height bias the pass runs with one section [0, INF)
    of strength 1.  With ``cfg.num_windows`` > 0 the step records local
    recombination into the state's windows and ring."""
    P = cfg.num_particles
    F, Pp = cfg.fifo_slots, epochs.num_pops
    dev = epochs.start.device
    span = (np.asarray(lags, np.float32) / np.float32(max(F - 1, 1)))
    mu = float(np.float32(mutation_rate))
    rho = float(np.float32(rho))
    inv2ne = epochs.inv2ne.contiguous()
    epoch_start = epochs.start.contiguous()
    log_w0 = _uniform_log_weight(P)
    T = MAX_RECOMB_ITERS
    tl = torch.empty(P, device=dev)  # post-trip tree length, per segment
    tracks = cfg.tracks_pilot
    if tracks:
        if not cfg.use_bias:
            # the guide without height bias: one all-heights section
            bias_heights, bias_strengths = [0.0, INF], [1.0]
        tables = tuple(
            torch.as_tensor(np.asarray(x, np.float32), device=dev)
            for x in (bias_heights, bias_strengths, delays))
    g = guide if cfg.use_guide else None
    if cfg.use_guide and guide is None:
        raise ValueError("use_guide needs the guide's tables")
    record_local = cfg.num_windows > 0
    ws = float(cfg.window_size)
    if record_local:
        lags_t = torch.as_tensor(np.asarray(lags, np.float32), device=dev)
        ropp = torch.empty(P, device=dev)  # the pass's ungated opportunity
    if cfg.has_migration:
        mig_tables = migration_tables(epochs)
    vb = None
    if vb_tables is not None:
        vb = tuple(torch.as_tensor(np.asarray(x, np.float32), device=dev)
                   .contiguous() for x in vb_tables)

    def step(state: PFState, seg: Segment):
        L = float(seg.length)
        trees = state.trees
        log_w = state.log_w
        log_pilot = state.log_pilot

        # ---- the segment's tree pass: summaries, trips inside [front,
        # front + L), final extension, push into FIFO slot 0 (under bias
        # also the pilot, the ring and its drain at front + L): one launch --
        uniforms = torch.rand((T if L > 0 else 0, P, 4), generator=generator,
                              device=dev)
        biased = migration = local = arg = None
        if tracks:
            biased = BiasedPass(
                log_pilot, state.df_pos, state.df_logf, state.df_delta,
                state.df_k, *tables, float(state.front), cfg.delay_type,
                cfg.delay_k)
        if cfg.has_migration:
            # the segment's key of the walk's counter-based generator
            key = torch.randint(0, 2 ** 31 - 1, (2,), generator=generator,
                                device=dev, dtype=torch.int32)
            migration = MigrationPass(
                trees.pop, trees.mig_time, trees.mig_dest, state.diag, key,
                *mig_tables, cfg.max_walk_events)
        if record_local:
            local = LocalPass(state.lr_pos, state.lr_due, state.lr_time,
                              state.lr_desc, state.lr_dropped, lags_t, ropp,
                              float(state.front))
        if cfg.record_arg:
            arg = ArgPass(*(getattr(state, k) for k in ARG_FIELDS),
                          float(state.front))
        extra = {k: v for k, v in (("guide", g), ("local", local),
                                   ("arg", arg)) if v is not None}
        segment_pass(uniforms, seg.leaf_status, trees.time, trees.parent,
                     trees.child0, trees.child1, state.next_rec, log_w,
                     state.fifo, seg.fifo_mask, tl, L, mu, rho, epoch_start,
                     inv2ne, seg.has_data, biased, migration, vb, **extra)

        # ---- site likelihood at the segment-final position ----------------
        if seg.state == 0 and seg.leaf_status != -1:  # SEGMENT_INVARIANT
            ll = phase_averaged_log_likelihood(
                trees, seg.configs, mu, cfg.ancestral_aware)
            log_w = log_w + ll
            if tracks:
                log_pilot = log_pilot + ll

        # ---- normalise; Kahan-compensated log-likelihood in f32 -----------
        delta_ln = torch.logsumexp(log_w, dim=0)
        log_w = log_w - delta_ln
        y = delta_ln - state.ln_norm_c
        t = state.ln_norm + y
        ln_norm_c = (t - state.ln_norm) - y
        ln_norm = t
        if tracks:
            log_pilot = log_pilot - torch.logsumexp(log_pilot, dim=0)
        else:
            log_pilot = log_w

        front = np.float32(state.front + np.float32(L))
        state = state._replace(log_w=log_w, log_pilot=log_pilot,
                               ln_norm=ln_norm, ln_norm_c=ln_norm_c,
                               front=front)

        # ---- local recording: the segment's opportunity, weighted by the
        # normalised weights, spread over [front - L, front); then the
        # pending events due at the front (smc.py:1236-1251) ---------------
        if record_local:
            w_now = torch.softmax(log_w, dim=0)
            add_window_opportunity(state.win_opp_diff,
                                   np.float32(front - np.float32(L)), front,
                                   (w_now * ropp).sum(), ws)
            commit_due_local(state.win_cnt, state.lr_pos, state.lr_due,
                             state.lr_time, state.lr_desc, w_now,
                             float(front), ws)

        # ---- lagged commit: epochs rotate their FIFO every `span` bp ------
        rotate_e = (front - state.slot_open) >= span
        if rotate_e.any():
            state = commit_slot(state, rotate_e, F - 1, Pp)
        state = state._replace(
            slot_open=np.where(rotate_e, front, state.slot_open).astype(
                np.float32))

        # ---- ESS and resampling on the pilot weights (the posterior ones
        # without bias); under the APF on the pilot plus the segment's
        # lookahead log-likelihood, renormalised (particleContainer.cpp:
        # 228-243); one host read per segment -----------------------------
        pilot_eff = log_pilot
        if cfg.apf > 0:
            la = lookahead_loglik(state.trees, tl, seg.lookahead, quantiles,
                                  mu, rho, cfg.apf)
            pilot_eff = log_pilot + la
            pilot_eff = pilot_eff - torch.logsumexp(pilot_eff, dim=0)
        wp = torch.softmax(pilot_eff, dim=0)
        ess = float(1.0 / (wp * wp).sum())
        need = ess < cfg.ess_threshold * P and seg.length > 0
        if need:
            u = torch.rand((), generator=generator, device=dev)
            idx = systematic_resample(pilot_eff, u)
            state = gather_particles(state, idx, ring=tracks)
            # clones re-draw their next recombination (memorylessness,
            # particle.cpp:393-436) from the post-trip tree length
            tl_r = tl.index_select(0, idx)
            expo = torch.empty(P, device=dev).exponential_(
                1.0, generator=generator)
            if g is None:
                gap = expo / (rho * tl_r).clamp(min=1e-30)
            else:
                gap = draw_gap(g, expo, rho, tl_r,
                               torch.full_like(tl_r, float(front)))
            if tracks or cfg.apf > 0:
                # auxiliary reweight: w' = (w / pilot)[ancestor] / P
                log_w = (log_w - pilot_eff).index_select(0, idx) + log_w0
                log_pilot = torch.full_like(log_w, log_w0)
            else:
                log_w = log_pilot = torch.full_like(log_w, log_w0)
            state = state._replace(
                log_w=log_w, log_pilot=log_pilot,
                next_rec=gap,
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
