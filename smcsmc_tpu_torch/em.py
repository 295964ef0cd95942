"""EM orchestration for the torch port: chunk sweeps -> sufficient
statistics -> M-step (counterpart of ``smcsmc_tpu/em.py``).

The numpy-only helpers ``prior_pseudostats``, ``_leaf_status``,
``_phase_configs``, the host half of ``prepare_blocks``, ``sum_stats``,
``_stats_from_outdata``, ``m_step``, ``_digamma64`` and ``vb_log_tables``
are copied from ``smcsmc_tpu/em.py``: the port imports nothing of the JAX
package.  ``_auto_mig_buffer`` is copied too.  With ``-apf`` each chunk's
lookahead columns come from the C scan of ``csrc/lookahead.c`` (built with
gcc at first use) and its terminal-branch quantiles from trees drawn on the
device.  With ``-guide`` each chunk's guide comes from the copied
``recombio.guide_to_windows``; with ``-alpha`` each iteration records the
windows into ``emiter{it}/chunk{ci}.recomb.gz`` and, from iteration 1 on,
sweeps on the previous iteration's record smoothed by the copied
``processrecombination.LocalRecombination``.  With ``-arg`` each
iteration writes each chunk's ``emiter{it}/chunk{ci}.trees.gz`` (the
copied ``argout.write_trees``) from the ARG ring of one particle drawn by
weight (``_sample_arg_particle``, copied).  Not ported yet (ROADMAP queue
1): online EM, the multi-process chunk partition.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, NamedTuple

import numpy as np
import torch

from . import outfmt
from .argout import write_trees
from .calibrate import (
    calibrated_lags_and_delays,
    default_bias_strengths,
    terminal_branch_quantiles,
)
from .checkpoint import (
    have_outfile,
    load_iteration,
    load_state,
    remove_state,
    save_state,
)
from .demography import Demography
from .device import resolve_device
from .kernels._build import load_lookahead_library
from .kernels.guide import guide_tables
from .kernels.local import split_windows
from .kernels.migration import MAX_MIG, MAX_POPS
from .kernels.tree import epochs_from_demography
from .kernels.trip import MAX_EPOCHS, MAX_LEAVES, WIDE_MAX_LEAVES
from .lookahead import LookaheadData, _compute_lookahead_native
from .processrecombination import LocalRecombination
from .recombio import guide_to_windows, write_recomb
from .segio import (
    SEGMENT_INVARIANT,
    SegData,
    define_chunks,
    slice_seg,
    split_long_segments,
)
from .smc import (
    PFConfig,
    PFState,
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

# segments between the host's finite checks of the log-likelihood, and the
# unit of ``checkpoint_blocks`` (the JAX package checks once per scan block
# of this many segments)
CHECK_EVERY = 2048


@dataclass
class EMConfig:
    """EM options (subset of smcsmc_tpu.em.EMConfig; reference defaults
    pfparam.cpp:193-255, model.py:44-81)."""

    num_particles: int = 100
    em_iters: int = 0  # number of EM updates (0 = a single E-step pass)
    ess_threshold: float = 0.5
    lag: float = 0.0  # 0 -> per-epoch default 4/(rho*top_t)
    calibrate_lag: bool = False  # Monte-Carlo survival pre-pass (smcsmc.cpp:169)
    ne_cap: float = 200000.0
    use_cap: bool = False
    ancestral_aware: bool = False
    apf: int = 0  # auxiliary particle filter level 0-4 (-apf)
    apf_trees: int = 100_000  # trees for the terminal-branch-quantile pre-pass
    dephase: bool = False  # treat phased het pairs as unphased (-dephase)
    max_phase_configs: int = 8  # cap on enumerated phase configurations
    seed: int = 1
    infer_recomb: bool = True
    infer_migration: bool = True
    vb: bool = False  # Dirichlet/VB pseudocount smoothing (model.py:997-1001)
    vb_pseudocount: float = 1.0
    xc_epochs: tuple = ()  # epochs excluded from coalescent updates (-xc)
    xr_epochs: tuple = ()  # epochs excluded from recombination updates (-xr)
    chunks: int = 1
    # chunk-window controls (model.py:563-662 define_chunks; pfparam.cpp
    # -startpos): gaps > maxgap split chunks, pieces < minseg are dropped,
    # inference runs over [startpos, startpos + length)
    maxgap: int = 200000
    minseg: int = 500000
    startpos: float | None = None
    length: float | None = None
    outdir: str | None = None
    record_ess: bool = False  # write .resample ESS trace (pfparam.cpp:530)
    # biased sampling (-bias_heights/-bias_strengths; heights in
    # generations, converted from 4N0 units by the CLI)
    bias_heights: tuple = ()  # e.g. (200.0,): sections [0,200), [200,inf)
    bias_strengths: tuple = ()  # one per section; () with bias_heights set
    # -> auto-calibrated once per run (calibrate.default_bias_strengths)
    delay: float = 0.5  # delay fraction of survival (pfparam.cpp:223)
    lag_fraction: float = 2.0  # lag = fraction * survival (pfparam.cpp:222)
    # the height that keys the delayed factors' delay: "recomb", "coal"
    # (-delay_coal) or "migr" (-delay_migr); particle.cpp:874-876
    delay_type: str = "recomb"
    # -no_m_step (model.py:240-245): run E-steps but keep parameters fixed
    do_m_step: bool = True
    # concurrent chunk sweeps, one thread per chunk, each on its own GPU
    # (the reference runs chunks as concurrent subprocesses by default,
    # -nothreads to disable, model.py:1094-1100).  0 = one worker per
    # visible GPU; 1 = serial (-nothreads).
    chunk_workers: int = 0
    # mid-sweep fault tolerance: save the whole sweep state every k blocks
    # of CHECK_EVERY segments; a re-run of the same chunk resumes from the
    # last checkpoint.  0 = off.
    checkpoint_blocks: int = 0
    # per-branch migration-event capacity (-migbuf; 0 = sized from the
    # demography by _auto_mig_buffer)
    mig_buffer: int = 0
    # recombination guide loop (-alpha, model.py:65,1125-1148): alpha > 0
    # records local recombination into .recomb.gz every iteration, smooths
    # it (WBS) into the next iteration's guide, and samples recombination
    # positions and points from that guide with importance weights
    alpha: float = 0.0
    beta: float = 4.0  # WBS smoothness (model.py:68)
    guide_file: str | None = None  # explicit guide for every chunk (-guide)
    guide_interval: float = 100.0  # local_recording_interval_ (count.hpp:115)
    # -arg: keep each particle's ARG event ring and write one particle's
    # (drawn by weight) as emiter{it}/chunk{ci}.trees.gz
    record_arg: bool = False
    device: str = "cuda"


def _auto_mig_buffer(demo: Demography) -> int:
    """Size the per-branch migration-event buffers so they rarely saturate
    (saturation triggers hold-based event dropping — an approximation that
    is counted in the chunk diagnostics).  Expected events per branch ~
    (total out-migration rate) x (tree-height scale); generous multiple for
    the tail and for the pairwise above-root excursions."""
    m_out = float(np.max(np.sum(demo.mig_rates, axis=2)))
    ne_max = float(np.max(demo.pop_sizes))
    t_scale = float(np.max(demo.change_times)) + 4.0 * ne_max
    expect = m_out * t_scale
    return int(np.clip(8 * np.ceil((6.0 * expect + 8.0) / 8.0), 16, 96))


def refuse_caps(demo: Demography, cfg: EMConfig) -> None:
    """Raise NotImplementedError for a run on the card that the CUDA
    kernels' compile-time caps do not hold (ROADMAP queue 1, item 19):
    more haplotypes, epochs or populations, or longer migration buffers;
    above MAX_LEAVES haplotypes (the wide kernels of the plain, biased,
    guided and local passes: ``-guide`` and ``-alpha`` run there) also
    several populations or migration and ``-apf``, whose passes have no
    wide form; and ``-arg`` with ``-guide`` or ``-alpha``, or with height
    bias above MAX_LEAVES haplotypes or with several populations or
    migration, which have no ARG variant (ROADMAP queue 1, item 16).  The
    CPU runs every size and combination.  Callers check before any tree
    is built."""
    if torch.device(cfg.device).type != "cuda":
        return
    buffer = cfg.mig_buffer or _auto_mig_buffer(demo)
    n = demo.num_samples
    structured = (demo.num_populations > 1
                  or bool(np.any(demo.mig_rates > 0)))
    if cfg.record_arg:
        for what, used in (
                ("-guide", cfg.guide_file is not None),
                ("-alpha", cfg.alpha > 0),
                (f"-bias_heights at {n} haplotypes",
                 bool(cfg.bias_heights) and n > MAX_LEAVES),
                ("-bias_heights with several populations or migration",
                 bool(cfg.bias_heights) and structured)):
            if used:
                raise NotImplementedError(
                    f"-arg with {what} on the card: that pass has no ARG "
                    "variant; run with -device cpu (ROADMAP queue 1, item "
                    "16)")
    if n > MAX_LEAVES:
        for what, used in (
                ("several populations or migration", structured),
                ("-apf", cfg.apf > 0)):
            if used:
                raise NotImplementedError(
                    f"{n} haplotypes with {what} on the card: the kernels "
                    f"of that path hold at most {MAX_LEAVES} (MAX_LEAVES); "
                    "run with -device cpu (ROADMAP queue 1, item 19)")
    for what, value, cap, name in (
            ("haplotypes", n, WIDE_MAX_LEAVES, "WIDE_MAX_LEAVES"),
            ("epochs", demo.num_epochs, MAX_EPOCHS, "MAX_EPOCHS"),
            ("populations", demo.num_populations, MAX_POPS, "MAX_POPS"),
            ("-migbuf events per migration buffer", buffer, MAX_MIG,
             "MAX_MIG")):
        if value > cap:
            raise NotImplementedError(
                f"{value} {what} on the card: the CUDA kernels hold at most "
                f"{cap} ({name}); run with -device cpu (ROADMAP queue 1, "
                "item 19)")


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


def _phase_configs(alleles: np.ndarray, max_configs: int, dephase: bool):
    """Per-site phase-configuration enumeration (reference:
    particleContainer.cpp:138-181).  Unphased het pairs (code 2,2 — or any
    het pair under ``dephase``) contribute a factor 2 of configurations; the
    site likelihood is the mean over them.  Returns configs [S, C, n] (int8,
    repeats padded) and n_configs [S]."""
    S, n = alleles.shape
    configs = np.repeat(alleles[:, None, :], max_configs, axis=1).astype(np.int8)
    n_configs = np.ones(S, dtype=np.int32)
    for s in range(S):
        al = alleles[s]
        pairs = []
        for i in range(0, n - 1, 2):
            unphased = al[i] == 2 or (
                dephase and al[i] >= 0 and al[i + 1] >= 0 and al[i] + al[i + 1] == 1
            )
            if unphased:
                pairs.append(i)
        if not pairs:
            continue
        k = min(len(pairs), int(np.log2(max_configs)))
        n_configs[s] = 2**k
        for cidx in range(2**k):
            cfg = al.copy()
            for b, i in enumerate(pairs[:k]):
                bit = (cidx >> b) & 1
                cfg[i], cfg[i + 1] = (0, 1) if bit == 0 else (1, 0)
            # pairs beyond capacity keep an arbitrary (0,1) assignment
            for i in pairs[k:]:
                cfg[i], cfg[i + 1] = 0, 1
            configs[s, cidx] = cfg
    return configs, n_configs


def _digamma64(x: np.ndarray) -> np.ndarray:
    """Float64 digamma via the recurrence + asymptotic series the reference
    uses (particle.cpp:65-74 exp_digamma)."""
    x = np.asarray(x, np.float64).copy()
    f = np.zeros_like(x)
    for _ in range(8):  # shift x above 6 (counts are >= ~1e-6 after flooring)
        small = x < 6.0
        if not np.any(small):
            break
        f = np.where(small, f + 1.0 / np.maximum(x, 1e-12), f)
        x = np.where(small, x + 1.0, x)
    return np.log(x) - 1.0 / (2.0 * x) - 1.0 / (12.0 * x * x) - f


def vb_log_tables(demo: Demography, counts=None, pseudocount: float = 1.0):
    """Per-rate VB log-correction tables psi(C) - log(C) for the in-proposal
    correction (particle.cpp:266-272).  ``counts`` = (coal [E,Pp],
    mig [E,Pp,Pp]) event counts from the previous EM iteration; defaults to
    1e10 (factor ~= 1, populationmodels.py:260-267) before the first M-step."""
    E, Pp = demo.num_epochs, demo.num_populations
    if counts is None:
        coal_c = np.full((E, Pp), 1e10)
        mig_c = np.full((E, Pp, Pp), 1e10)
    else:
        coal_c = np.maximum(np.asarray(counts[0], np.float64) + pseudocount,
                            1e-3)
        mig_c = np.maximum(np.asarray(counts[1], np.float64) + pseudocount,
                           1e-3)
    tbl = lambda c: (_digamma64(c) - np.log(c)).astype(np.float32)
    return tbl(coal_c), tbl(mig_c)


def vb_pass_tables(demo: Demography, counts, cfg: EMConfig):
    """The VB tables as the segment pass takes them: ``vb_log_tables``
    with the ``-xc`` epochs' entries 0, since those epochs record no
    events (the JAX step multiplies by the same 0/1 mask in its loop; a
    product with 1 or 0 is exact)."""
    vb_coal, vb_mig = vb_log_tables(demo, counts, cfg.vb_pseudocount)
    xc = np.ones(demo.num_epochs, np.float32)
    for e in cfg.xc_epochs:
        if 0 <= e < demo.num_epochs:
            xc[e] = 0.0
    return vb_coal * xc[:, None], vb_mig * xc[:, None, None]


def compute_lookahead(seg: SegData) -> LookaheadData:
    """The APF lookahead columns of every segment (segdata.cpp:225-410)
    from the C scan of ``csrc/lookahead.c``, built at first use; a failed
    build raises.  ``lookahead.compute_lookahead_py`` is the oracle."""
    return _compute_lookahead_native(load_lookahead_library(), seg, None)


@dataclass
class ChunkSegments:
    """A chunk's segments: descriptors on the host, site data on the device
    (uploaded once per chunk)."""

    lengths: np.ndarray  # [S] int
    states: np.ndarray  # [S] int8
    leaf_status: np.ndarray  # [S] int8
    dist_mut: np.ndarray  # [S] f32 distance to the next informative site
    n_configs: np.ndarray  # [S] int32 phase configurations of the site
    configs: torch.Tensor  # [S, C, n] int8
    has_data: torch.Tensor  # [S, n] bool
    fifo_mask: torch.Tensor  # [S, K] f32
    # with the APF: the lookahead columns (lookahead_columns), else None
    lookahead: tuple | None = None

    def __len__(self) -> int:
        return len(self.lengths)

    def __getitem__(self, s: int) -> Segment:
        # the host knows n_configs: a phased site is handed one
        # configuration and costs what it cost before
        la = None
        if self.lookahead is not None:
            la = tuple(x[s] for x in self.lookahead)
        return Segment(int(self.lengths[s]), int(self.states[s]),
                       int(self.leaf_status[s]),
                       self.configs[s, :int(self.n_configs[s])],
                       self.has_data[s], self.fifo_mask[s], la)


def lookahead_columns(la: LookaheadData, device) -> tuple:
    """The per-segment columns that ``kernels.lookahead.lookahead_loglik``
    reads, in its order: fsd, rel_mu, unphased [S, n]; the doubleton slots
    s1, s2, first, last, unph1, unph2 [S, D] on ``device`` (uploaded once
    per chunk); split_dist [S] (host f32, the step branches on it), the
    split's alleles [S, n] on the device and split_k [S] (host i32)."""
    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x)).to(device)

    return (dev(la.fsd), dev(la.rel_mu), dev(la.unphased), dev(la.dbl_s1),
            dev(la.dbl_s2), dev(la.dbl_first), dev(la.dbl_last),
            dev(la.dbl_unph1), dev(la.dbl_unph2),
            np.asarray(la.split_dist, np.float32), dev(la.split_alleles),
            np.asarray(la.split_k, np.int32))


def prepare_segments(seg: SegData, chunk_start: int, lags, device,
                     max_configs: int = 1, dephase: bool = False,
                     xc_epochs=(), xr_epochs=(), Pp: int = 1,
                     lookahead: LookaheadData | None = None
                     ) -> ChunkSegments:
    """Host half of ``smcsmc_tpu.em.prepare_blocks`` (without its block
    padding): chunk-relative lengths (first segment clipped to the chunk),
    leaf status, phase configurations (``max_configs`` > 1 enables the
    marginalisation over unphased genotypes), distance to the next
    informative site and the recording gate (in the statistics layout of
    ``Pp`` populations); with ``lookahead`` also the APF columns."""
    lengths = seg.lengths.astype(np.int64)
    alleles = seg.alleles.astype(np.int8)
    states = seg.states.astype(np.int8)
    leaf_status = _leaf_status(alleles)
    first_off = chunk_start - int(seg.positions[0])
    if first_off > 0:
        lengths = lengths.copy()
        lengths[0] = max(int(lengths[0]) - first_off, 0)
    configs, n_configs = _phase_configs(alleles, max_configs, dephase)
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
    gate = fifo_gate_masks(dist_mut, lags, xc_epochs, xr_epochs, Pp)
    return ChunkSegments(
        lengths=lengths, states=states, leaf_status=leaf_status,
        dist_mut=dist_mut, n_configs=n_configs,
        configs=torch.as_tensor(configs).to(device),
        has_data=torch.as_tensor(alleles >= 0).to(device),
        fifo_mask=torch.as_tensor(gate).to(device),
        lookahead=(None if lookahead is None
                   else lookahead_columns(lookahead, device)),
    )


class Sweep(NamedTuple):
    """What a sweep over one chunk starts from."""

    state: PFState
    segs: ChunkSegments
    step: Callable  # step(state, segment) -> (state, (ess, resampled, front))
    chunk_start: int
    generator: torch.Generator  # the sweep's only source of randomness


def start_sweep(demo: Demography, seg: SegData, cfg: EMConfig,
                chunk=(None, None), seed: int = 1, vb_counts=None,
                guide_file: str | None = None) -> Sweep:
    """Set up a sweep over (a window of) the genome: the initial state, the
    chunk's segments, the segment step, the chunk start and the generator
    that the state was drawn from and the step goes on drawing from.
    ``vb_counts`` = (coal [E, Pp], mig [E, Pp, Pp]), the previous
    iteration's event counts, sets the VB tables of ``cfg.vb`` (None: the
    tables of counts 1e10, before the first M-step).  ``guide_file`` (a
    ``.recomb_guide.gz``) guides the sweep; ``cfg.alpha`` > 0 records its
    windows of ``cfg.guide_interval`` bp."""
    dev = resolve_device(cfg.device)
    start, end = chunk
    if start is not None:
        seg = slice_seg(seg, start, end)
        chunk_start = start
    else:
        chunk_start = int(seg.positions[0])

    # bound per-step recombination work (pfparam.cpp:364: 2/(4*N0*rho))
    max_seg_len = 2.0 / max(4.0 * demo.n0 * demo.recombination_rate, 1e-30)
    seg = split_long_segments(seg, max_seg_len)
    chunk_len = float(seg.end) - chunk_start
    num_windows = (int(np.ceil(chunk_len / cfg.guide_interval))
                   if cfg.alpha > 0 else 0)

    refuse_caps(demo, dataclasses.replace(
        cfg, guide_file=guide_file or cfg.guide_file))
    epochs = epochs_from_demography(demo, dev)
    bias_strengths = cfg.bias_strengths
    if cfg.bias_heights and not bias_strengths:
        # a sweep set up alone (run_chunks resolves them once per run)
        bias_strengths = _resolve_bias_strengths(demo, cfg, epochs)
    pfcfg = PFConfig(
        num_particles=cfg.num_particles,
        num_leaves=demo.num_samples,
        ess_threshold=cfg.ess_threshold,
        ancestral_aware=cfg.ancestral_aware,
        use_bias=bool(bias_strengths) and any(s != 1.0
                                              for s in bias_strengths),
        delay_type=cfg.delay_type,
        has_migration=epochs.structured,
        max_mig=cfg.mig_buffer or _auto_mig_buffer(demo),
        apf=cfg.apf,
        use_guide=guide_file is not None,
        num_windows=num_windows,
        window_size=cfg.guide_interval,
        record_arg=cfg.record_arg,
    )
    rho = demo.recombination_rate
    delays = None
    if cfg.lag > 0:
        lags = np.full(demo.num_epochs, cfg.lag, dtype=np.float32)
    elif cfg.calibrate_lag:
        cal = torch.Generator(device=dev)
        cal.manual_seed(seed + 7919)
        lags, delays = calibrated_lags_and_delays(
            cal, epochs, demo.sample_pops, rho,
            lag_fraction=cfg.lag_fraction, delay=cfg.delay)
        lags = lags.astype(np.float32)
        logger.info("calibrated lags (bp) by epoch: %s",
                    " ".join(f"{x:.4g}" for x in lags))
    else:
        lags = default_lags(demo.change_times, rho)
    bias = {}  # the step's optional inputs
    if pfcfg.use_bias or pfcfg.use_guide:
        if delays is None:
            # no calibration pre-pass: survival ~ lag / lag_fraction
            delays = np.asarray(lags) * (cfg.delay / cfg.lag_fraction)
        bias["delays"] = np.asarray(delays, np.float32)
    if pfcfg.use_bias:
        bias.update(
            bias_heights=np.concatenate([[0.0], list(cfg.bias_heights),
                                         [3e38]]),
            bias_strengths=np.asarray(bias_strengths, np.float32))
    guide = None
    if pfcfg.use_guide:
        g_rate, g_leaf = guide_to_windows(guide_file, chunk_start, chunk_len,
                                          cfg.guide_interval)
        if g_leaf.shape[1] != demo.num_samples:
            raise ValueError(
                f"guide file has {g_leaf.shape[1]} leaf columns, "
                f"expected {demo.num_samples}")
        guide = guide_tables(g_rate, g_leaf, rho, cfg.guide_interval, dev)
        bias["guide"] = guide

    # phase-configuration capacity: 1 unless unphased data (or -dephase)
    has_unphased = bool(np.any(seg.alleles == 2)) or cfg.dephase
    max_configs = cfg.max_phase_configs if has_unphased else 1

    # APF pre-passes (em.py:493-505 of the JAX package): the lookahead
    # scan of the chunk on the host, the terminal branch quantiles from
    # trees drawn on the device with a generator of their own
    la = None
    if cfg.apf > 0:
        la = compute_lookahead(seg)
        qgen = torch.Generator(device=dev)
        qgen.manual_seed(seed + 104729)
        bias["quantiles"] = terminal_branch_quantiles(
            qgen, epochs, demo.sample_pops, num_trees=cfg.apf_trees)
    if cfg.vb:
        bias["vb_tables"] = vb_pass_tables(demo, vb_counts, cfg)

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = init_state(gen, epochs, pfcfg, demo.sample_pops, rho,
                       sample_time=demo.sample_times, guide=guide)
    segs = prepare_segments(seg, chunk_start, lags, dev,
                            max_configs=max_configs, dephase=cfg.dephase,
                            xc_epochs=cfg.xc_epochs, xr_epochs=cfg.xr_epochs,
                            Pp=demo.num_populations, lookahead=la)
    step = make_segment_step(pfcfg, epochs, demo.mutation_rate, rho, lags, gen,
                             **bias)
    return Sweep(state, segs, step, chunk_start, gen)


def run_chunk(demo: Demography, seg: SegData, cfg: EMConfig,
              chunk=(None, None), seed: int = 1, vb_counts=None,
              guide_file: str | None = None):
    """One particle-filter sweep over (a chunk of) the genome; returns host
    SuffStats, the w^2 stats, the log-likelihood and diagnostics.

    With ``cfg.checkpoint_blocks`` > 0 and an ``outdir`` the whole sweep
    state is saved every ``checkpoint_blocks * CHECK_EVERY`` segments under
    ``ckpt/seed{seed}_start{chunk_start}`` (unique per EM iteration and
    chunk, because ``run_em`` derives ``seed`` from both); a re-run of the
    same chunk continues from there, and the file goes when the chunk ends.

    ``guide_file`` guides the sweep (``-guide``, or the guide loop); with
    ``cfg.alpha`` > 0 ``diag["local_recomb"]`` holds the recorded windows
    (what ``recombio.write_recomb`` writes); with ``cfg.record_arg``
    ``diag["arg"]`` the ARG ring of one particle drawn by weight (what
    ``argout.write_trees`` writes)."""
    state, segs, step, chunk_start, gen = start_sweep(
        demo, seg, cfg, chunk, seed, vb_counts, guide_file)
    ess_trace = np.zeros(len(segs))
    resample_rows = []  # (genome position, ESS) at each resample event
    first = 0

    ckpt_path = None
    if cfg.checkpoint_blocks > 0 and cfg.outdir:
        ckpt_path = os.path.join(cfg.outdir, "ckpt",
                                 f"seed{seed}_start{int(chunk_start)}")
        if os.path.exists(ckpt_path):
            state, done = load_state(ckpt_path, gen, state.log_w.device)
            first = done["segments"]
            ess_trace[:first] = done["ess"]
            resample_rows = [tuple(r) for r in done["resample_rows"]]
            logger.info("resuming chunk sweep from checkpoint after segment "
                        "%d", first - 1)
    every = cfg.checkpoint_blocks * CHECK_EVERY

    for s in range(first, len(segs)):
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
        if ckpt_path and (s + 1) % every == 0 and s + 1 < len(segs):
            save_state(ckpt_path, state, gen, {
                "segments": s + 1, "ess": ess_trace[:s + 1].tolist(),
                "resample_rows": [list(r) for r in resample_rows]})
    state = flush_pending(state, cfg.guide_interval)
    if ckpt_path:
        # chunk finished: iteration-level resume takes over from here
        remove_state(ckpt_path)

    pseudo = prior_pseudostats(demo)
    E_, Pp_ = demo.num_epochs, demo.num_populations

    def host(flat, add):
        parts = unpack_stats(flat.cpu().numpy(), E_, Pp_)
        return SuffStats(*(np.asarray(x, np.float64) + p
                           for x, p in zip(parts, add)))

    stats = host(state.stats, pseudo)
    stats_wt = host(state.stats_wt, SuffStats(*(np.ones_like(p) for p in pseudo)))
    capped, dropped = (float(x) for x in state.diag.cpu())
    if capped or dropped:
        logger.warning(
            "approximation pressure in chunk: %d migration walks hit "
            "max_walk_events, %d migration events dropped on buffer overflow "
            "(max_mig=%d) — consider raising -migbuf", int(capped),
            int(dropped), cfg.mig_buffer or _auto_mig_buffer(demo))
    diag = {
        "walks_capped": capped,
        "mig_events_dropped": dropped,
        "num_resamples": state.num_resamples,
        "ess": ess_trace,
        "resample_rows": resample_rows,
        "final_front": float(state.front),
        "num_segments": len(segs),
        # segments stepped over by data class and by phase configurations,
        # counted from the host descriptors
        "leaf_status_counts": {
            ls: int((segs.leaf_status == ls).sum()) for ls in (1, 0, -1)},
        "unphased_sites": int(((segs.n_configs > 1)
                               & (segs.states == SEGMENT_INVARIANT)
                               & (segs.leaf_status != -1)).sum()),
    }
    if state.win_cnt is not None:
        leaf, tcnt, lcnt = (x.cpu().numpy().astype(np.float64)
                            for x in split_windows(state.win_cnt))
        diag["local_recomb"] = {
            "opp_diff": state.win_opp_diff.cpu().numpy().astype(np.float64),
            "leaf_cnt": leaf,
            "time_cnt": tcnt,
            "logtime_cnt": lcnt,
            "dropped": int(state.lr_dropped),
            "start": chunk_start,
            "window_size": cfg.guide_interval,
        }
        if diag["local_recomb"]["dropped"]:
            logger.warning("%d local recombination events dropped on full "
                           "rings in the chunk starting at %d",
                           diag["local_recomb"]["dropped"], chunk_start)
    if state.arg_pos is not None:
        best = _sample_arg_particle(state.log_w.cpu().numpy(), seed)
        row = {k: getattr(state, f"arg_{k}")[best].cpu().numpy()
               for k in ("pos", "code", "time", "from", "to", "desc")}
        # the int64 word as the reference's u64, so that leaf 63 prints
        row["desc"] = row["desc"].view(np.uint64)
        diag["arg"] = dict(row, n=int(state.arg_n[best]), start=chunk_start)
    return stats, stats_wt, float(state.ln_norm), diag


def _sample_arg_particle(log_w: np.ndarray, seed: int) -> int:
    """Draw ONE particle index proportional to posterior weight for the
    -arg output (the reference resamples down to a single particle before
    printTrees: smcsmc.cpp:395-396 + particleContainer.cpp:247 — a weighted
    draw, not the argmax, so ARG-derived outputs are not biased toward the
    posterior mode)."""
    lw = np.asarray(log_w, dtype=np.float64)
    w = np.exp(lw - lw.max())
    w = w / w.sum()
    rng = np.random.default_rng(seed + 65537)
    return int(rng.choice(w.shape[0], p=w))


def _worker_devices(device: str) -> list[str]:
    """The devices chunk workers run on: every visible GPU for ``cuda``,
    else the one device named."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return [str(dev)]


def _resolve_bias_strengths(demo: Demography, cfg: EMConfig, epochs=None):
    """Bias strengths from the model, from the run's seed (getBiasRatio,
    model_summary.hpp:119-133), so that every chunk proposes alike."""
    dev = resolve_device(cfg.device)
    if epochs is None:
        epochs = epochs_from_demography(demo, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed + 50021)
    strengths = default_bias_strengths(gen, epochs, demo.sample_pops,
                                       cfg.bias_heights)
    logger.info("auto-calibrated bias_strengths for heights %s: %s",
                cfg.bias_heights, " ".join(f"{s:.3g}" for s in strengths))
    return strengths


def run_chunks(demo: Demography, seg: SegData, cfg: EMConfig, chunks,
               seeds=None, vb_counts=None, guide_files=None):
    """Run genome chunks concurrently, the scale-out axis the reference
    implements as concurrent ``smcsmc`` subprocesses (model.py:1094-1100,
    execute.py:26-105).  Each chunk runs in its own thread on its own GPU
    with its own ``torch.Generator`` (seeded with ``seeds[ci]``; nothing
    draws from a global generator), so on a multi-GPU host the sweeps run
    in parallel; with one device (or one worker) the chunks run one after
    another.  ``vb_counts``: the previous iteration's event counts for
    ``cfg.vb``; ``guide_files``: each chunk's guide file or None.  Returns
    the per-chunk (stats, stats_wt, logl, diag) tuples in chunk order."""
    n = len(chunks)
    if seeds is None:
        seeds = [cfg.seed + ci for ci in range(n)]
    if guide_files is None:
        guide_files = [None] * n
    if cfg.bias_heights and not cfg.bias_strengths:
        # once for the whole run: every chunk proposes with the same
        # strengths, and the 20,000-tree pre-pass runs once
        cfg = dataclasses.replace(
            cfg, bias_strengths=tuple(_resolve_bias_strengths(demo, cfg)))
    devs = _worker_devices(cfg.device)
    workers = cfg.chunk_workers if cfg.chunk_workers > 0 else len(devs)
    workers = min(workers, n, len(devs))

    def one(ci, device=cfg.device):
        return run_chunk(demo, seg, dataclasses.replace(cfg, device=device),
                         chunk=chunks[ci], seed=seeds[ci],
                         vb_counts=vb_counts, guide_file=guide_files[ci])

    if workers <= 1:
        return [one(ci) for ci in range(n)]
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(lambda ci: one(ci, devs[ci % len(devs)]),
                           range(n)))


def sum_stats(stats_list: list[SuffStats]) -> SuffStats:
    """Cross-chunk reduction (model.py:903-910)."""
    return SuffStats(*(sum(xs) for xs in zip(*stats_list)))


def _stats_from_outdata(data, demo: Demography, col_opp: str = "Opp",
                        col_cnt: str = "Count",
                        xr_epochs: tuple = ()) -> SuffStats:
    """Rebuild a SuffStats from a parsed .out (for resume, model.py:1120).

    With ``col_opp="Wt"`` this reconstructs the w^2-weighted statistics from
    the ESS column instead (parse_outfile recovers Wt = Opp/ESS).

    The .out records only the epoch-aggregated Recomb row (count.cpp:83-113
    — per-epoch rows are compiled out in the reference too), so the
    per-epoch breakdown is spread uniformly over the epochs that were
    recording (all except ``xr_epochs``); the M-step re-aggregates the same
    total, so the resumed -xr behavior matches the live path instead of
    collapsing everything into epoch 0."""
    E, Pp = demo.num_epochs, demo.num_populations
    coal_opp = np.zeros((E, Pp))
    coal_cnt = np.zeros((E, Pp))
    mig_opp = np.zeros((E, Pp))
    mig_cnt = np.zeros((E, Pp, Pp))
    recomb_opp = np.zeros((E,))
    recomb_cnt = np.zeros((E,))
    for key in data:
        (typ, epoch, frm, to, clump), col = key
        if col != "Count" or clump != -1:
            continue  # per-chunk (Clump >= 0) rows are diagnostics only
        k0 = (typ, epoch, frm, to, clump)
        if typ == "Coal" and 0 <= epoch < E and 0 <= frm < Pp:
            coal_opp[epoch, frm] = data[(k0, col_opp)]
            coal_cnt[epoch, frm] = data[(k0, col_cnt)]
        elif typ == "Migr" and 0 <= epoch < E:
            mig_opp[epoch, frm] = data[(k0, col_opp)]
            mig_cnt[epoch, frm, to] = data[(k0, col_cnt)]
        elif typ == "Recomb":
            keep = np.ones(E, bool)
            for xe in xr_epochs:
                if 0 <= xe < E:
                    keep[xe] = False
            k_n = max(int(keep.sum()), 1)
            recomb_opp[keep] += data[(k0, col_opp)] / k_n
            recomb_cnt[keep] += data[(k0, col_cnt)] / k_n
    return SuffStats(
        coal_opp=coal_opp, coal_cnt=coal_cnt, mig_opp=mig_opp,
        mig_cnt=mig_cnt, recomb_opp=recomb_opp, recomb_cnt=recomb_cnt,
    )


def m_step(
    demo: Demography, stats: SuffStats, cfg: EMConfig
) -> Demography:
    """Parameter update from sufficient statistics (count.cpp:267-352
    reset_Ne / reset_recomb_rate / reset_mig_rate; VB pseudocounts
    model.py:997-1001)."""
    coal_opp = np.asarray(stats.coal_opp, dtype=np.float64)
    coal_cnt = np.asarray(stats.coal_cnt, dtype=np.float64)
    if cfg.vb:
        # Dirichlet pseudocounts: add prior-rate-matching mass
        prior_rate = 1.0 / (2.0 * demo.pop_sizes)
        coal_cnt = coal_cnt + cfg.vb_pseudocount
        coal_opp = coal_opp + cfg.vb_pseudocount / np.maximum(prior_rate, 1e-300)
    rate = coal_cnt / np.maximum(coal_opp, 1e-300)
    ne = 1.0 / (2.0 * np.maximum(rate, 1e-300))
    if cfg.use_cap:
        ne = np.minimum(ne, cfg.ne_cap)
    # -xc: keep prior sizes in excluded epochs (pfparam.cpp record masks)
    for e in cfg.xc_epochs:
        if 0 <= e < ne.shape[0]:
            ne[e] = demo.pop_sizes[e]

    new_mig = demo.mig_rates
    if cfg.infer_migration and demo.num_populations > 1:
        mig_opp = np.asarray(stats.mig_opp, dtype=np.float64)
        mig_cnt = np.asarray(stats.mig_cnt, dtype=np.float64)
        new_mig = mig_cnt / np.maximum(mig_opp[:, :, None], 1e-300)
        for i in range(demo.num_populations):
            new_mig[:, i, i] = 0.0
        # -xc excludes coal AND migration epochs (RECORD_COALMIGR_EVENT,
        # pfparam.cpp:96)
        for e in cfg.xc_epochs:
            if 0 <= e < new_mig.shape[0]:
                new_mig[e] = demo.mig_rates[e]

    new_rho = demo.recombination_rate
    if cfg.infer_recomb:
        r_opp_e = np.asarray(stats.recomb_opp, dtype=np.float64).copy()
        r_cnt_e = np.asarray(stats.recomb_cnt, dtype=np.float64).copy()
        for e in cfg.xr_epochs:  # -xr: exclude epochs from the aggregate
            if 0 <= e < r_opp_e.shape[0]:
                r_opp_e[e] = 0.0
                r_cnt_e[e] = 0.0
        r_opp, r_cnt = float(r_opp_e.sum()), float(r_cnt_e.sum())
        if r_opp > 0:
            new_rho = r_cnt / r_opp

    return demo.with_updated_rates(
        pop_sizes=ne, mig_rates=new_mig, recombination_rate=new_rho
    )


@dataclass
class EMResult:
    demos: list  # per-iteration models (post-update)
    stats: list  # per-iteration summed SuffStats
    stats_wt: list
    log_likelihoods: list
    out_text: list = field(default_factory=list)
    # per iteration: E-step wall seconds and segments stepped over (both 0
    # for an iteration taken from a finished .out on resume)
    estep_seconds: list = field(default_factory=list)
    num_segments: list = field(default_factory=list)
    chunks: list = field(default_factory=list)  # (start, end) windows


def run_em(demo: Demography, seg: SegData, cfg: EMConfig) -> EMResult:
    """The EM loop (model.py:1102-1184): per iteration the chunks'
    E-step sweeps, ``emiter{it}/chunkfinal.out`` (aggregate rows, plus one
    Clump row group per chunk when there are several) and the M-step; then
    ``result.out`` with the iterations' aggregate rows, newest first.  An
    iteration whose ``chunkfinal.out`` is already complete in ``outdir`` is
    not swept again: its statistics are read back from the file.  With
    ``cfg.alpha`` > 0 each iteration also writes each chunk's
    ``chunk{ci}.recomb.gz`` and, from iteration 1 on, sweeps each chunk on
    the previous iteration's, smoothed into ``chunk{ci}.recomb_guide.gz``;
    ``cfg.guide_file`` guides every chunk from iteration 0 on.  With
    ``cfg.record_arg`` each iteration writes each chunk's
    ``chunk{ci}.trees.gz``."""
    refuse_caps(demo, cfg)
    result = EMResult(demos=[], stats=[], stats_wt=[], log_likelihoods=[])
    if cfg.outdir:
        os.makedirs(cfg.outdir, exist_ok=True)

    windowed = (
        cfg.startpos is not None
        and cfg.startpos > float(seg.positions[0])
    ) or cfg.length is not None
    if cfg.chunks > 1 or windowed:
        chunks = [
            (c.start, c.end)
            for c in define_chunks(
                seg, cfg.chunks, maxgap=cfg.maxgap, minseg=cfg.minseg,
                startpos=cfg.startpos, length=cfg.length,
            )
        ]
    else:
        chunks = [(None, None)]
    result.chunks = chunks
    logger.info("chunks: %s", chunks)

    current = demo
    vb_counts = None  # the previous iteration's event counts (VB)
    for it in range(cfg.em_iters + 1):
        # idempotent resume (model.py:1105-1115): skip finished iterations
        if cfg.outdir and have_outfile(cfg.outdir, it):
            data = load_iteration(cfg.outdir, it)
            stats = _stats_from_outdata(data, current, xr_epochs=cfg.xr_epochs)
            # the w^2 stats live in the ESS column (Wt = Opp/ESS); feeding
            # the posterior stats here would corrupt the ESS column of
            # result.out
            stats_wt = _stats_from_outdata(
                data, current, col_opp="Wt", col_cnt="Wt",
                xr_epochs=cfg.xr_epochs,
            )
            with open(
                os.path.join(cfg.outdir, f"emiter{it}", "chunkfinal.out")
            ) as fh:
                result.out_text.append(fh.read())
            logl = data.get((("LogL", -1, -1, -1, -1), "Count"), 0.0)
            if cfg.do_m_step:
                current = m_step(current, stats, cfg)
            if cfg.vb:
                vb_counts = (stats.coal_cnt, stats.mig_cnt)
            result.demos.append(current)
            result.stats.append(stats)
            result.stats_wt.append(stats_wt)
            result.log_likelihoods.append(logl)
            result.estep_seconds.append(0.0)
            result.num_segments.append(0)
            logger.info("finished iteration %d found in %s: not swept again",
                        it, cfg.outdir)
            continue

        guide_files = [cfg.guide_file] * len(chunks)
        if cfg.alpha > 0 and it > 0 and cfg.outdir:
            # the guide loop (model.py:1125-1143): the previous iteration's
            # .recomb.gz of each chunk, smoothed, guides that chunk
            for ci in range(len(chunks)):
                recomb = os.path.join(cfg.outdir, f"emiter{it - 1}",
                                      f"chunk{ci}.recomb.gz")
                if not os.path.exists(recomb):
                    continue
                lr = LocalRecombination(recomb, iteration=it - 1)
                lr.smooth(cfg.alpha, cfg.beta)
                guide_files[ci] = os.path.join(cfg.outdir, f"emiter{it}",
                                               f"chunk{ci}.recomb_guide.gz")
                os.makedirs(os.path.dirname(guide_files[ci]), exist_ok=True)
                lr.write_data(guide_files[ci])
                logger.info("iteration %d, chunk %d: guide %s", it, ci,
                            guide_files[ci])
        t0 = time.monotonic()
        per_chunk = run_chunks(
            current, seg, cfg, chunks,
            seeds=[cfg.seed + 1000 * it + ci for ci in range(len(chunks))],
            vb_counts=vb_counts, guide_files=guide_files,
        )
        seconds = time.monotonic() - t0
        if cfg.alpha > 0 and cfg.outdir:
            os.makedirs(os.path.join(cfg.outdir, f"emiter{it}"), exist_ok=True)
            for ci, pc in enumerate(per_chunk):
                lrd = pc[3]["local_recomb"]
                write_recomb(
                    os.path.join(cfg.outdir, f"emiter{it}",
                                 f"chunk{ci}.recomb.gz"),
                    it, lrd["window_size"], lrd["opp_diff"], lrd["leaf_cnt"],
                    lrd["time_cnt"], lrd["logtime_cnt"],
                    start_position=lrd["start"])
        if cfg.record_arg and cfg.outdir:
            os.makedirs(os.path.join(cfg.outdir, f"emiter{it}"), exist_ok=True)
            for ci, pc in enumerate(per_chunk):
                a = pc[3]["arg"]
                write_trees(
                    os.path.join(cfg.outdir, f"emiter{it}",
                                 f"chunk{ci}.trees.gz"),
                    a["pos"], a["code"], a["time"], a["from"], a["to"],
                    a["desc"], a["n"], start_position=a["start"])
        stats = sum_stats([pc[0] for pc in per_chunk])
        stats_wt = sum_stats([pc[1] for pc in per_chunk])
        logl = sum(pc[2] for pc in per_chunk)
        n_resample = sum(pc[3]["num_resamples"] for pc in per_chunk)
        n_segments = sum(pc[3]["num_segments"] for pc in per_chunk)

        if cfg.record_ess and cfg.outdir:
            # .resample contract (pfparam.cpp:530-538): one row per resample
            # event, "position<TAB>ESS"
            os.makedirs(os.path.join(cfg.outdir, f"emiter{it}"), exist_ok=True)
            with open(
                os.path.join(cfg.outdir, f"emiter{it}", "chunkfinal.resample"), "w"
            ) as fh:
                for pc in per_chunk:
                    for p_, e_ in pc[3]["resample_rows"]:
                        fh.write(f"{int(p_)}\t{e_}\n")

        clump = -1 if len(chunks) > 1 else None
        text = outfmt.stats_to_out(
            it, current.change_times, stats, stats_wt, logl,
            cfg.num_particles, num_resamples=n_resample,
            sequence_len=float(seg.end), clump=clump,
        )
        if len(chunks) > 1:
            # per-chunk Clump rows (merged-format contract, model.py:913-947:
            # the per-iteration file carries aggregate rows at Clump -1 plus
            # one row group per chunk; result.out keeps only the aggregates)
            for ci, pc in enumerate(per_chunk):
                text += outfmt.stats_to_out(
                    it, current.change_times, pc[0], pc[1], pc[2],
                    cfg.num_particles,
                    num_resamples=pc[3]["num_resamples"],
                    sequence_len=float(seg.end),
                    clump=ci, header=False,
                )
        result.out_text.append(text)
        if cfg.outdir:
            os.makedirs(os.path.join(cfg.outdir, f"emiter{it}"), exist_ok=True)
            with open(os.path.join(cfg.outdir, f"emiter{it}",
                                   "chunkfinal.out"), "w") as fh:
                fh.write(text)

        if cfg.do_m_step:
            # -no_m_step (model.py:1020-1022): keep parameters fixed
            current = m_step(current, stats, cfg)
        if cfg.vb:
            vb_counts = (stats.coal_cnt, stats.mig_cnt)
        result.demos.append(current)
        result.stats.append(stats)
        result.stats_wt.append(stats_wt)
        result.log_likelihoods.append(logl)
        result.estep_seconds.append(seconds)
        result.num_segments.append(n_segments)
        counts = {ls: sum(pc[3]["leaf_status_counts"][ls] for pc in per_chunk)
                  for ls in (1, 0, -1)}
        logger.info(
            "EM iteration %d: E-step %.3f s over %d segments at P=%d, "
            "logL %.2f, %d resample(s), %d chunk(s); segments by leaf status "
            "%s, %d unphased site(s)", it, seconds, n_segments,
            cfg.num_particles, logl, n_resample, len(chunks), counts,
            sum(pc[3]["unphased_sites"] for pc in per_chunk))

    if cfg.outdir:
        # result.out passes through only aggregate rows (Clump -1, or no
        # Clump column at all for single-chunk runs): model.py:974-987
        with open(os.path.join(cfg.outdir, "result.out"), "w") as fh:
            fh.write(result.out_text[0].split("\n")[0] + "\n")
            for it in range(len(result.out_text) - 1, -1, -1):
                body = result.out_text[it].split("\n")[1:]
                keep = [
                    ln for ln in body
                    if not ln or len(chunks) == 1 or ln.split()[-1] == "-1"
                ]
                fh.write("\n".join(keep))
    return result
