"""EM orchestration for the torch port: one chunk sweep -> sufficient
statistics -> M-step (counterpart of ``smcsmc_tpu/em.py``, single chunk).

The numpy-only helpers ``prior_pseudostats``, ``_leaf_status``, the host
half of ``prepare_blocks`` and the one-population branch of ``m_step`` are
copied from ``smcsmc_tpu/em.py`` (:189, :210, :253, :834): the port imports
nothing of the JAX package.  ``m_step`` grows the options (VB, Ne cap,
excluded epochs) when those are ported (ROADMAP queue 1).
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .device import resolve_device
from .kernels.tree import epochs_from_demography
from . import outfmt
from .demography import Demography
from .segio import (
    SEGMENT_INVARIANT,
    SegData,
    define_chunks,
    slice_seg,
    split_long_segments,
)
from .smc import (
    PFConfig,
    Segment,
    SuffStats,
    default_lags,
    fifo_gate_masks,
    flush_pending,
    init_state,
    make_segment_step,
    unpack_stats,
)

logger = logging.getLogger("smcsmc_tpu_torch")

# segments between the host's finite checks of the log-likelihood (the JAX
# package checks once per scan block of this many segments)
CHECK_EVERY = 2048


@dataclass
class EMConfig:
    """EM options (subset of smcsmc_tpu.em.EMConfig; reference defaults
    pfparam.cpp:193-255, model.py:44-81)."""

    num_particles: int = 100
    em_iters: int = 0  # number of EM updates (0 = a single E-step pass)
    ess_threshold: float = 0.5
    lag: float = 0.0  # 0 -> per-epoch default 4/(rho*top_t)
    seed: int = 1
    length: float | None = None  # inference window from the first site, bp
    outdir: str | None = None
    device: str = "cuda"


def prior_pseudostats(demo: Demography):
    """Initial pseudocounts (count.cpp:161-227): each accumulator starts with
    opportunity 1 and count = the current model rate, so empty epochs return
    the prior rate from the M-step instead of 0/0."""
    E, Pp = demo.num_epochs, demo.num_populations
    coal_opp = np.ones((E, Pp), dtype=np.float64)
    coal_cnt = 1.0 / (2.0 * demo.pop_sizes)
    mig_opp = np.ones((E, Pp), dtype=np.float64)
    mig_cnt = demo.mig_rates.copy()
    recomb_opp = np.ones((E,), dtype=np.float64)
    recomb_cnt = np.full((E,), demo.recombination_rate, dtype=np.float64)
    return SuffStats(
        coal_opp=coal_opp,
        coal_cnt=coal_cnt,
        mig_opp=mig_opp,
        mig_cnt=mig_cnt,
        recomb_opp=recomb_opp,
        recomb_cnt=recomb_cnt,
    )


def _leaf_status(alleles: np.ndarray) -> np.ndarray:
    """Per-segment data class: -1 all-missing, 1 complete, 0 mixed
    (particle.cpp:748-758)."""
    missing = alleles < 0
    all_missing = np.all(missing, axis=1)
    none_missing = np.all(~missing, axis=1)
    return np.where(all_missing, -1, np.where(none_missing, 1, 0)).astype(np.int8)


@dataclass
class ChunkSegments:
    """A chunk's segments: descriptors on the host, site data on the device
    (uploaded once per chunk)."""

    lengths: np.ndarray  # [S] int
    states: np.ndarray  # [S] int8
    leaf_status: np.ndarray  # [S] int8
    dist_mut: np.ndarray  # [S] f32 distance to the next informative site
    alleles: torch.Tensor  # [S, n] int8
    has_data: torch.Tensor  # [S, n] bool
    fifo_mask: torch.Tensor  # [S, K] f32

    def __len__(self) -> int:
        return len(self.lengths)

    def __getitem__(self, s: int) -> Segment:
        return Segment(int(self.lengths[s]), int(self.states[s]),
                       int(self.leaf_status[s]), self.alleles[s],
                       self.has_data[s], self.fifo_mask[s])


def prepare_segments(seg: SegData, chunk_start: int, lags, device
                     ) -> ChunkSegments:
    """Host half of ``smcsmc_tpu.em.prepare_blocks`` for phased data:
    chunk-relative lengths (first segment clipped to the chunk), leaf
    status, distance to the next informative site and the FIFO gate."""
    lengths = seg.lengths.astype(np.int64)
    alleles = seg.alleles.astype(np.int8)
    states = seg.states.astype(np.int8)
    leaf_status = _leaf_status(alleles)
    first_off = chunk_start - int(seg.positions[0])
    if first_off > 0:
        lengths = lengths.copy()
        lengths[0] = max(int(lengths[0]) - first_off, 0)
    # distance from each segment's start to the next informative site
    # (reference distance_to_mutation, segdata.cpp:234-241)
    is_site = (states == SEGMENT_INVARIANT) & (leaf_status != -1)
    site_end = np.where(
        is_site, (seg.positions + seg.lengths).astype(np.float64), np.inf
    )
    next_site = np.minimum.accumulate(site_end[::-1])[::-1]
    dist_mut = np.minimum(
        next_site - seg.positions.astype(np.float64), 1e30
    ).astype(np.float32)
    al = torch.as_tensor(alleles).to(device)
    return ChunkSegments(
        lengths=lengths, states=states, leaf_status=leaf_status,
        dist_mut=dist_mut, alleles=al, has_data=al >= 0,
        fifo_mask=torch.as_tensor(fifo_gate_masks(dist_mut, lags)).to(device),
    )


def start_sweep(demo: Demography, seg: SegData, cfg: EMConfig,
                chunk=(None, None), seed: int = 1):
    """Set up a sweep over (a window of) the genome: returns the initial
    state, the chunk's segments, the segment step and the chunk start."""
    dev = resolve_device(cfg.device)
    start, end = chunk
    if start is not None:
        seg = slice_seg(seg, start, end)
        chunk_start = start
    else:
        chunk_start = int(seg.positions[0])
    if np.any(seg.alleles == 2):
        raise NotImplementedError(
            "unphased alleles (code 2) are not yet in the torch port "
            "(ROADMAP queue 1, data variants)")

    # bound per-step recombination work (pfparam.cpp:364: 2/(4*N0*rho))
    max_seg_len = 2.0 / max(4.0 * demo.n0 * demo.recombination_rate, 1e-30)
    seg = split_long_segments(seg, max_seg_len)

    epochs = epochs_from_demography(demo, dev)
    pfcfg = PFConfig(
        num_particles=cfg.num_particles,
        num_leaves=demo.num_samples,
        ess_threshold=cfg.ess_threshold,
    )
    rho = demo.recombination_rate
    if cfg.lag > 0:
        lags = np.full(demo.num_epochs, cfg.lag, dtype=np.float32)
    else:
        lags = default_lags(demo.change_times, rho)

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = init_state(gen, epochs, pfcfg, demo.sample_pops, rho,
                       sample_time=demo.sample_times)
    segs = prepare_segments(seg, chunk_start, lags, dev)
    step = make_segment_step(pfcfg, epochs, demo.mutation_rate, rho, lags, gen)
    return state, segs, step, chunk_start


def run_chunk(demo: Demography, seg: SegData, cfg: EMConfig,
              chunk=(None, None), seed: int = 1):
    """One particle-filter sweep over (a window of) the genome; returns host
    SuffStats, the w^2 stats, the log-likelihood and diagnostics."""
    state, segs, step, chunk_start = start_sweep(demo, seg, cfg, chunk, seed)
    ess_trace = np.zeros(len(segs))
    resample_rows = []  # (genome position, ESS) at each resample event
    for s in range(len(segs)):
        state, (ess, resampled, front) = step(state, segs[s])
        ess_trace[s] = ess
        if resampled:
            resample_rows.append((front + chunk_start, ess))
        if (s + 1) % CHECK_EVERY == 0 or s == len(segs) - 1:
            # FP/NaN policy (reference traps FE_INVALID, smcsmc.cpp:52-54):
            # fail fast with context instead of propagating a NaN
            ln_now = float(state.ln_norm)
            if not np.isfinite(ln_now):
                raise FloatingPointError(
                    f"non-finite log-normalizer ({ln_now}) after segment {s} "
                    f"of chunk starting at {chunk_start} "
                    f"(front={float(state.front):.0f})")
    state = flush_pending(state)

    pseudo = prior_pseudostats(demo)
    E_, Pp_ = demo.num_epochs, demo.num_populations

    def host(flat, add):
        parts = unpack_stats(flat.cpu().numpy(), E_, Pp_)
        return SuffStats(*(np.asarray(x, np.float64) + p
                           for x, p in zip(parts, add)))

    stats = host(state.stats, pseudo)
    stats_wt = host(state.stats_wt, SuffStats(*(np.ones_like(p) for p in pseudo)))
    diag = {
        "num_resamples": state.num_resamples,
        "ess": ess_trace,
        "resample_rows": resample_rows,
        "final_front": float(state.front),
        "num_segments": len(segs),
    }
    return stats, stats_wt, float(state.ln_norm), diag


def m_step(demo: Demography, stats: SuffStats) -> Demography:
    """Parameter update from sufficient statistics (count.cpp:267-352
    reset_Ne / reset_recomb_rate): the branch of ``smcsmc_tpu.em.m_step``
    that its default EMConfig takes for one population (no VB, no Ne cap,
    no excluded epochs; migration rates stay as they are)."""
    coal_opp = np.asarray(stats.coal_opp, dtype=np.float64)
    coal_cnt = np.asarray(stats.coal_cnt, dtype=np.float64)
    rate = coal_cnt / np.maximum(coal_opp, 1e-300)
    ne = 1.0 / (2.0 * np.maximum(rate, 1e-300))

    new_rho = demo.recombination_rate
    r_opp = float(np.asarray(stats.recomb_opp, dtype=np.float64).sum())
    r_cnt = float(np.asarray(stats.recomb_cnt, dtype=np.float64).sum())
    if r_opp > 0:
        new_rho = r_cnt / r_opp

    return demo.with_updated_rates(
        pop_sizes=ne, mig_rates=demo.mig_rates, recombination_rate=new_rho
    )


@dataclass
class EMResult:
    demos: list  # per-iteration models (post-update)
    stats: list  # per-iteration SuffStats
    stats_wt: list
    log_likelihoods: list
    out_text: list = field(default_factory=list)
    estep_seconds: list = field(default_factory=list)
    num_segments: int = 0


def run_em(demo: Demography, seg: SegData, cfg: EMConfig) -> EMResult:
    """EM loop over one chunk (model.py:1102-1184): E-step sweep, .out
    rows per iteration (``emiter{it}/chunkfinal.out``), M-step, and the
    final ``result.out`` with the iterations newest first."""
    result = EMResult(demos=[], stats=[], stats_wt=[], log_likelihoods=[])
    if cfg.outdir:
        os.makedirs(cfg.outdir, exist_ok=True)
    chunk = (None, None)
    if cfg.length is not None:
        c = define_chunks(seg, 1, length=cfg.length)[0]
        chunk = (c.start, c.end)

    current = demo
    for it in range(cfg.em_iters + 1):
        t0 = time.monotonic()
        stats, stats_wt, logl, diag = run_chunk(
            current, seg, cfg, chunk=chunk, seed=cfg.seed + 1000 * it)
        seconds = time.monotonic() - t0
        text = outfmt.stats_to_out(
            it, current.change_times, stats, stats_wt, logl,
            cfg.num_particles, num_resamples=diag["num_resamples"],
            sequence_len=float(seg.end),
        )
        result.out_text.append(text)
        if cfg.outdir:
            os.makedirs(os.path.join(cfg.outdir, f"emiter{it}"), exist_ok=True)
            with open(os.path.join(cfg.outdir, f"emiter{it}",
                                   "chunkfinal.out"), "w") as fh:
                fh.write(text)
        current = m_step(current, stats)
        result.demos.append(current)
        result.stats.append(stats)
        result.stats_wt.append(stats_wt)
        result.log_likelihoods.append(logl)
        result.estep_seconds.append(seconds)
        result.num_segments = diag["num_segments"]
        logger.info(
            "EM iteration %d: E-step %.3f s over %d segments at P=%d, "
            "logL %.2f, %d resample(s)", it, seconds, diag["num_segments"],
            cfg.num_particles, logl, diag["num_resamples"])

    if cfg.outdir:
        with open(os.path.join(cfg.outdir, "result.out"), "w") as fh:
            fh.write(result.out_text[0].split("\n")[0] + "\n")
            for it in range(len(result.out_text) - 1, -1, -1):
                fh.write("\n".join(result.out_text[it].split("\n")[1:]))
    return result
