"""Smoke run of the PyTorch/CUDA port (smcsmc_tpu_torch) on one GPU.

    python3 chip_smoke.py [--until build|compare|time]

Phases, each fatal on failure:

1. print the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the kernels from csrc/trip.cu with nvcc for sm_90a and print what
   ptxas says of them (registers, shared memory, stack frame, spills) and
   what the card grants each kernel at the paths' shapes and at the caps
   (``kernel_resources``: registers, stack, shared bytes, particles per
   block and per SM, waves at P=10,000); then
   run the resampler's scan (``smc.block_scan``) 2000 times at P=10,000
   with matrix products queued among the runs: every result must equal the
   first bit for bit (``torch.cumsum``'s differences are printed beside);
3. compare both entry points of the kernel, ``trip`` and ``segment_pass``
   (and the biased and the migration pass, see 9 and 10),
   with their plain torch versions on the card with identical uniforms:
   (P=10000, n=4, E=9: the main path's shape), (P=10000, n=4, E=8),
   (P=4096, n=8, E=33) and (P=10000, n=8, E=33: the whole-genome path's
   shape); leaf status 1, 0 (some leaves without data) and -1;
   one trip, and 64 trips in one launch on the longest segment the sweep
   makes (50 kb).  Each float is held to rtol 1e-4 plus an atol in its own
   units (kernels.trip.float_tolerances: one node height is 1e-5 of the
   tallest node; positions 1e-5 of L; log_w mu x L x N node heights; counts
   to half an event).  One trip: trees equal in >= 99.9% of particles and
   every float within tolerance on the particles whose trees agree.  64
   trips vs plain: >= 99.9% of particles agree in trees and floats, since a
   last-bit difference in a node height can grow along a chain of trips
   (the next hazard integrates the moved heights).  For ``trip``, 64 trips
   in one launch equal 64 single-trip launches bit for bit;
4. time both entry points at the main path's shape (P=10000, n=4, E=9) and
   at the whole-genome path's (P=10000, n=8, E=33), each on the path's mean
   and on the longest segment: device time per launch (CUDA events
   around 20 launches on cloned states, queued behind a matrix product so
   that the host's enqueueing is not in the interval), the same with at
   most 1, 2 and 4 trips allowed and with no particle recombining, an empty
   launch, the host's time per wrapper call (perf_counter around 200 calls,
   no synchronise inside) and the plain version (median of 3).  From the
   counted work of those launches (active particles, trips, and the
   statistics that are not zero and so have to reach the FIFO) it prints
   each kernel's bound, the larger of bytes over 3.35 TB/s and operations
   over 67 TFLOP/s, and the share of it the kernel reaches.  At the
   whole-genome shape the biased pass is timed the same way, its bound
   counting the section table, the pilot weight, the positions of the ring
   and the ring slots the pass changed;
5. run the main path through smc2-torch's entry point
   (smcsmc_tpu_torch.cli.smcsmc_main) on bench.py's single-population data
   (n=4, 2 Mb) at -Np 10000 -EM 1 with 9 epochs and -record_ess;
6. check result.out of the last iteration (LogL finite and negative; Coal
   Ne within 2x of 10000 in every interior epoch with >= 5 posterior
   coalescences, and at least 3 such epochs; Recomb rate within 2x of
   1e-9), that the main path launched ``segment_pass`` once per segment and
   iteration, and that it launched ``trip`` and ran no plain version at all;
7. run the whole-genome path through the same entry point: two simulated
   chromosomes of 2 Mb (n=8, every heterozygous pair unphased, a 300 kb
   stretch with one sample missing, a 120 kb and a 250 kb stretch with all
   missing; smcsmc_tpu_torch.sweep_profile.genome_data) as two .seg files,
   ``-segs a.seg b.seg -chunks 4 -Np 10000 -EM 1 -P 133 133016 "31*1"
   -record_ess -ckpt 1``; check the launch counts (``segment_pass`` once
   per segment of every chunk and iteration, no ``trip``, no plain version),
   that segments of every leaf status and sites with several phase
   configurations were stepped over, result.out as in 6 (each epoch from 25
   posterior coalescences on, the 33 epochs being narrow, and the interior
   epochs' pooled Ne within 25% of 10000), that the chunks'
   Clump rows sum to the aggregate LogL, that ``chunkfinal.resample`` has
   one row per resample event and that no checkpoint is left; delete
   iteration 1 and run the same command again: iteration 0 must launch
   nothing and keep its rows; then sweep one chunk twice with one seed, once
   through ``save_state``/``load_state`` at half way into a sweep set up
   from another seed: log-likelihood and committed statistics bit for
   bit;
8. profile 10 steady segments of both sweeps with torch.profiler
   (smcsmc_tpu_torch.sweep_profile): device busy share, launches per
   segment, kernel time per launch, top device operations;
9. the biased path: the whole-genome data through the same entry point
   with the production proposal, ``-segs a.seg b.seg -chunks 4 -Np 10000
   -EM 0 -P 133 133016 "31*1" -record_ess -seed 7 -bias_heights 0 0.05
   -calibrate_lag 2``: the biased ``segment_pass``
   once per segment, the plain one and the plain versions never, ``trip`` as
   often as the lag calibration pre-passes report (more than 0); the
   auto-calibrated bias strengths and the calibrated lags logged; the
   genome path's result check; E-step updates/s and the LogL of each
   iteration in full; a profile of chunk 0 with the same proposal
   (launches per segment, device busy share) and what its rings hold
   (``ring_census``: slots in use per particle, the shares of particles
   that recombine or have a factor due).  The biased pass is compared in
   phase 3 at (P=10000, n=8, E=33) at each leaf status, with every ring
   full, and at its caps corner (P=10001, n=8, E=64, 8 sections, 32
   slots); the last two with no tree mismatch at one trip.

10. the migration pass (the compile-time migration variant of
   ``segment_pass``): compared with its plain version in phase 3 at
   the twopop path's shape (P=10000, n=4, E=8, Pp=2, Mw=56) on trees of
   bench.py's two-population model with filled buffers (plain
   ``make_initial_trees``), leaf status 1, 0 and -1, one trip and 64
   trips, plus buffers that overflow (-migbuf 16 at m=2e-4; they must drop
   events), a lone sample in population 0 (samples [0, 1, 1, 1]; some
   walks must coalesce above the old root), walks bounded at 3 events
   (some must be capped and coalesce onto the root lineage) and the
   kernel's caps (``sweep_profile.caps_demo``: n=8, E=64, Pp=4, Mw=96, at
   P=10,001 so that the last block is ragged): no tree mismatch, node
   times, populations and the buffers' times and destinations bit for
   bit, the walk diagnostics equal, floats within ``float_tolerances``;
   the kernel's resources (``cudaFuncGetAttributes``: registers, local and
   static shared bytes; the dynamic shared bytes and particles per block
   it is launched with) at the twopop shape and at the caps are printed
   after the build; then the twopop path: bench.py's
   ``twopop_em_iter`` configuration (2 populations, samples [0, 0, 1, 1],
   8 epochs, m=5e-5, 2 Mb, ``simulate_seg(seed=13)``) through the same
   entry point with ``-Np 10000 -EM 0`` (one E-step since the twopop
   proposal's runs, 17, sweep the data twice more) and the flags of
   ``sweep_profile.twopop_flags``: the migration pass once per segment,
   every other pass and every plain version never; in the E-step at the
   truth per population Coal Ne within 2x in every interior epoch with >=
   5 posterior coalescences (>= 3 such), every interior epoch with >= 5
   coalescences in both populations together within 2x, each
   population's pooled interior Ne within 25%, the pooled migration rate
   within [0.5x, 2x] of 5e-5 and Recomb within 2x
   (``TWOPOP_POOLED_WITHIN`` says why); walks capped and events dropped
   printed; the same command again with -arg must give its LogL bit for
   bit (see 16); a
   profile of the twopop sweep; the migration pass timed at the twopop
   data's mean segment and at 50 kb (device us per launch, host us, plain
   ms, bound from counted work with the buffer events read and the rows
   changed, events per walk), the timed launch held to the plain version's
   run on the same inputs, bit for bit as in phase 3.

11. VB (-vb): the VB variant of each pass (``segment_pass(..., vb=...)``,
   each trip's term added to the weights inside the kernel) compared in
   phase 3 with its plain version on VB tables from small counts drawn in
   [0.05, 5] with one -xc epoch (``vb_tables``): the plain pass at the main
   path's shape at each leaf status, at the genome shape and at (P=10,001,
   n=8, E=64), the biased pass at the genome shape at each leaf status and
   at its caps corner, the migration pass at the twopop shape at each leaf
   status and at its caps corner; one trip with no tree mismatch and every
   float (log_w, log_pilot) within tolerance, 64 trips as in 3, the
   migration pass's trees and buffers bit for bit, and the VB terms
   moving log_w.  Each VB variant timed beside its pass in 4 and 10
   (without the trip ladder).  Then bench.py's feature_vb: the main path's
   command with ``-vb -EM 1``: the VB plain pass
   once per segment of each E-step, nothing else; iteration 1's estimates
   checked as in 6;
   iteration 0's LogL within 1e-4 relative of the main path's, iteration
   1's different; a sweep profile.  The biased and the twopop path's
   profiles run once more with ``vb=True``, so that their VB variants run
   in the sweep (launched more than 0 times, their passes without VB 0).
12. The APF (-apf): bench.py's feature_apf, the main path's command with
   ``-apf 2 -EM 0``: the plain pass once per segment, estimates checked as
   in 6, the .resample trace (the ESS of the effective pilot at each
   resampling) different from the main path's; a sweep profile (the
   launches and device time the lookahead adds per segment against the
   main path's); ``lookahead_loglik`` alone at P=10,000 (launches and
   device time per call under torch.profiler, bound).
13. bench.py's feature_apf8 through ``em.run_em`` with ``EMConfig(apf=2,
   apf_trees=50_000)`` on ``sweep_profile.apf8_data`` (n=8, a 100 kb
   window of four missing, leaves 0/1 unphased): the plain pass once per
   segment, estimates as in 6; profiles with and without the APF;
   ``lookahead_loglik`` alone at n=8.

14. The recombination guide and local recording: the guided biased pass
   (``segment_pass(..., guide=...)``), the local plain and biased passes
   (``local=...``), the guided local pass and the VB variant of each,
   compared in phase 3 with their plain versions on a guide that is not
   constant and a ring of pending events 30% in use (``compare_guide``:
   each at the main path's shape at leaf status 1 and 0, one trip and 64;
   the local biased passes with every ring full at the genome shape; the
   guided local, biased local and local passes at the biased pass's caps
   corner; the VB variants at one trip), rings held too (bitmasks and
   drops exactly); each timed in phase 4 at the main path's shape beside
   the pass it is a variant of (the biased pass is timed there too), its
   bound counted from its own trips.  Then bench.py's feature_bias_guide, the main path's command
   with ``-bias_heights 0 0.01 -bias_strengths 2 1 -guide`` (a constant
   guide as bench.py writes it) ``-EM 0``: the guided pass once per
   segment, nothing else, estimates as in 6, a profile; and the guide
   loop, the main path's command with ``-alpha 0.5 -EM 1``: the local
   plain pass once per segment of iteration 0, the guided local pass
   (iteration 1 on the smoothed guide) once per segment of iteration 1,
   estimates as in 6, each ``.recomb.gz`` of 20,000 windows with its
   summed opportunity and leaf counts within ``RECOMB_OPP_VS_OUT`` and
   ``RECOMB_CNT_VS_OUT`` of the ``.out``'s, profiles of both iterations;
   the local biased pass and the four VB variants in short sweeps of
   their own without the profiler (``variant_sweeps``); the local
   recording's torch ops alone (``local_ops_cost``).

15. Samples above 8 haplotypes (the wide kernels of ``csrc/trip.cu``:
   ``trip``, the plain and the biased pass, each pass with and without
   VB; 8 lanes per particle up to 16 leaves, 16 up to 64): compared
   in phase 3 (``compare_wide``) at n of 9, 16, 17, 33 and 64, 9 and 64
   epochs (``WIDE_SHAPES``, P ragged against the block), each leaf status,
   one trip at 20 kb and 64 trips at 50 kb (the VB variants at one trip),
   the biased pass with 2 sections at 9 epochs and 8 at 64 and a ring 30%
   in use, against the plain version run in float64 and rounded to
   float32; timed at (10,000, 16, 9) and (10,000, 64, 9) on the data's
   mean segment and at 50 kb, beside the bound from counted work; then
   bench.py's headline demography with n=16 (``sweep_profile.wide_data``)
   through the main path's command at ``-EM 0`` (the wide pass
   once per segment, nothing else, estimates as in 6, a profile), the same
   with ``-bias_heights 0 0.05 -calibrate_lag 2`` and one E-step (the wide
   biased pass, the wide ``trip`` in the lag pre-passes), the VB variants
   in short sweeps, and n=64 over 200 kb swept once (a finite LogL, more
   than one coalescence counted).

16. ARG recording (``-arg``: the ARG variants of the plain, biased,
   migration and wide plain passes, each with and without VB, which push
   each trip's R, C and M rows into the particle's ring of 512 rows):
   compared in phase 3 (``compare_arg``) with their plain versions on a
   ring in use, at the main and genome shapes (and once at P=10,001), the
   twopop shape and its caps corner, n=16 and n=64, each leaf status, one
   trip and 64, VB off and on: 0 tree mismatches and equal rings at one
   trip, the 0.1% budget at 64, the migration pass's trees, buffers and
   heights bit for bit, every output but the ring bit for bit the same
   kernel's without ARG; then the main path's command with ``-arg`` (the
   ARG plain pass once per segment, the main path's LogL bit for bit,
   every R/C row's leaves nonzero and within the full mask, a full binary
   tree at 7 positions from ``argout.build_tables``), its profiles with
   and without ``-vb``, the ring's gather alone; the biased ARG passes in
   short sweeps of the genome data; the twopop rerun with ``-arg`` (see
   10: M rows, ``find_segments`` tracts) and its profiles; the wide ARG
   pass in short sweeps of the n=16 and n=64 data (a row reaching leaf
   63) and a profile; each ARG pass timed beside its parent on the
   parent's timed inputs, in turns, with the bound from counted work, the
   ring's bytes included.

17. Structured populations with the production proposal (the migration
   pass's proposal variants: biased, guided and biased, local, biased
   local, guided local, each with and without VB): compared in phase 3
   (``compare_mig_proposal``) with their plain versions at the twopop
   shape and its caps corner (8 sections), each leaf status, one trip and
   64, the delay keyed by the point, the coalescence and -delay_migr, a
   ring of delayed factors and one of local events 30% in use, a guide
   that is not constant: no tree mismatch, trees, buffers and heights bit
   for bit, floats within tolerance, rings equal; then bench.py's
   twopop_em_iter data with ``-bias_heights 0 0.05 -calibrate_lag 2
   -delay_migr -EM 1`` (run A: the biased migration pass once per
   segment, the migration pass exactly as often as the lag calibration
   logs) and with ``-alpha 0.5 -EM 1`` (run B: the local migration pass in
   iteration 0, writing its ``.recomb.gz``, the guided local one on the
   smoothed guide in iteration 1), no plain version, estimates checked
   per interior epoch over both populations with the pooled migration
   rate, a profile of each; the variants neither run takes in short
   sweeps; each variant timed at the twopop mean segment and at 50 kb in
   turns with the migration pass without the proposal, beside its bound
   and plain version.

The line before the last is a JSON object with each kernel's build/compare/
time record (the VB, guided and local variants as kernels of their own)
and the new paths' updates/s, launches and device ms per segment
(``feature_paths``), the wide paths' (``wide_paths``), the ARG paths'
with the ring's gather (``arg_paths``) and the twopop proposal's runs
(``twopop_proposal_paths``); the last line
is {"ok": true, "device": {...}}.  Without a
CUDA device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MU, RHO, NE = 1e-8, 1e-9, 10000.0
RTOL = 1e-4
MATCH_MIN = 0.999  # share of particles whose kernel and plain results agree
MAX_SEG = 2.0 / (4.0 * NE * RHO)  # the sweep's segment split length, bp
MIN_EPOCH_EVENTS = 5.0  # posterior coalescences for an epoch to be checked
# the same on the whole-genome path.  Its 33 epochs are narrow: over 4 Mb an
# epoch that reaches 5-15 posterior coalescences often does so by an upward
# fluctuation, which reads as a low Ne (seeds 7, 7, 8, 9 on an H100, python
# -m smcsmc_tpu_torch.repeatability: 2570-16450 at 5-15 coalescences,
# 6522-12265 from 20 on; with seed 7 the oldest epoch with data, 29, read
# 4189-5472 at 11-18 coalescences).  So each epoch is held to 2x from 25
# coalescences on, and all interior epochs pooled (sum of opportunity over
# twice the sum of coalescences, 9055-9407 in those runs) to 25%.
GENOME_MIN_EPOCH_EVENTS = 25.0
GENOME_POOLED_WITHIN = 0.25
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
FIFO_SLOTS = 4  # PFConfig.fifo_slots, the sweep's lag FIFO depth
# the segments of every sweep profile: warmed, timed without the profiler,
# profiled (sweep_profile's defaults are 100, 300 and 200; a twentieth of
# them keeps the whole script, with the twopop proposal's paths, inside
# its time limit on a slow host: a profile costs 2-12 s, most of it
# reading the profiler's events)
PROFILE_WINDOW = dict(warm=3, timed=15, profiled=10)
DEVICE = "cuda"  # where the entry points are driven


_T0 = time.monotonic()


def _log(msg: str) -> None:
    print(msg, flush=True)


def _elapsed(what: str) -> None:
    """The script's seconds so far, after ``what``."""
    _log(f"elapsed {time.monotonic() - _T0:.1f} s after {what}")


def _demo(n: int, E: int, L: float = 2e6):
    """bench.py's single_pop_demo for E=8; the -P 133 133016 grid else."""
    import numpy as np

    from smcsmc_tpu_torch.demography import Demography

    if E == 8:
        change = np.concatenate([[0.0], np.logspace(2.5, 5.0, E - 1)])
    else:
        change = np.concatenate(
            [[0.0], np.logspace(np.log10(133.0), np.log10(133016.0), E - 1)])
    return Demography(
        change_times=change, pop_sizes=np.full((E, 1), NE),
        mig_rates=np.zeros((E, 1, 1)), sample_pops=np.zeros(n, np.int32),
        mutation_rate=MU, recombination_rate=RHO, sequence_length=L,
    )


SEGMENT_STATE = ("time", "parent", "child0", "child1", "next_rec", "log_w")
# the biased pass as compared and timed: two sections, [0, 2000) at strength
# 4 and [2000, inf) at 1 (-bias_heights 0 0.05 at N0 10,000 gives the
# boundary 2000; 4 is about what the calibration gives the genome model),
# the JAX package's 32 ring slots, a segment starting at 10 kb
BIAS_HEIGHTS = (0.0, 2000.0, 3e38)
BIAS_STRENGTHS = (4.0, 1.0)
BIAS_SLOTS = 32
BIAS_FRONT = 10000.0
BIASED_PASS = "segment_pass (biased)"
# the biased pass's caps corner: 8 leaves, 64 epochs, 8 sections (one of
# them unbiased, so that some factors go to the pilot at once), 32 slots, at
# a particle count that leaves the last block ragged
BIAS_CAPS_HEIGHTS = (0.0, 300.0, 1000.0, 2000.0, 4000.0, 8000.0, 16000.0,
                     32000.0, 3e38)
BIAS_CAPS_STRENGTHS = (6.0, 5.0, 4.0, 3.0, 1.0, 2.0, 1.5, 1.25)


# the migration pass as compared, timed and driven: bench.py's twopop
# model (two populations of Ne 10,000, samples [0, 0, 1, 1], 8 epochs,
# symmetric m = 5e-5) with em._auto_mig_buffer's 56 events per branch
MIGRATION_PASS = "segment_pass (migration)"
TWOPOP_P = 10000
TWOPOP_M = 5e-5
TWOPOP_MW = 56

# the VB variants of the three passes (-vb: each trip's VB term added to
# the weights inside the pass), as counted, compared, timed and driven
VB_PASS = "segment_pass (vb)"
BIASED_VB_PASS = "segment_pass (biased, vb)"
MIGRATION_VB_PASS = "segment_pass (migration, vb)"
# each pass by name: the count of segment_pass that its wrapper adds to
LAUNCH_COUNTS = {"segment_pass": "launches", BIASED_PASS: "biased_launches",
                 MIGRATION_PASS: "migration_launches",
                 VB_PASS: "vb_launches", BIASED_VB_PASS: "biased_vb_launches",
                 MIGRATION_VB_PASS: "migration_vb_launches"}
XC_EPOCH = 1  # the -xc epoch of the VB tables compared and timed

# the recombination guide and local recording: the guided biased pass, the
# local plain and biased passes, each with its VB variant; by name its
# flags (biased, guide, local) and the pass whose variant it is
GUIDE_PASS = "segment_pass (biased, guide)"
GUIDE_LOCAL_PASS = "segment_pass (biased, guide, local)"
BIASED_LOCAL_PASS = "segment_pass (biased, local)"
LOCAL_PASS = "segment_pass (local)"
GUIDE_PASSES = {GUIDE_PASS: ((True, True, False), BIASED_PASS),
                GUIDE_LOCAL_PASS: ((True, True, True), BIASED_PASS),
                BIASED_LOCAL_PASS: ((True, False, True), BIASED_PASS),
                LOCAL_PASS: ((False, False, True), "segment_pass")}


def vb_name(name: str) -> str:
    """The name of a pass's VB variant."""
    return name[:-1] + ", vb)"


GUIDE_PASSES.update({vb_name(k): (flags, vb_name(parent) if parent !=
                                  "segment_pass" else VB_PASS)
                     for k, (flags, parent) in GUIDE_PASSES.items()})
for _name, ((_b, _g, _l), _) in GUIDE_PASSES.items():
    LAUNCH_COUNTS[_name] = ("biased_" if _b else "") + ("guide_" if _g else "") \
        + ("local_" if _l else "") + ("vb_" if "vb" in _name else "") \
        + "launches"
# the wide kernels (more than 8 leaves): the plain and biased passes, each
# with and without VB, and trip
WIDE_PASS = "segment_pass (wide)"
WIDE_VB_PASS = "segment_pass (wide, vb)"
BIASED_WIDE_PASS = "segment_pass (biased, wide)"
BIASED_WIDE_VB_PASS = "segment_pass (biased, wide, vb)"
WIDE_TRIP = "trip (wide)"
LAUNCH_COUNTS.update({WIDE_PASS: "wide_launches",
                      WIDE_VB_PASS: "wide_vb_launches",
                      BIASED_WIDE_PASS: "biased_wide_launches",
                      BIASED_WIDE_VB_PASS: "biased_wide_vb_launches"})
# each wide kernel by the name phase_time gives the narrow one
WIDE_NAMES = {"trip": WIDE_TRIP, "segment_pass": WIDE_PASS,
              VB_PASS: WIDE_VB_PASS, BIASED_PASS: BIASED_WIDE_PASS,
              BIASED_VB_PASS: BIASED_WIDE_VB_PASS}
# ARG recording (-arg): the ARG variants of the plain, biased, migration
# and wide plain passes, each with and without VB; by name the count its
# wrapper adds to and the pass it is a variant of
ARG_PASS = "segment_pass (arg)"
BIASED_ARG_PASS = "segment_pass (biased, arg)"
MIGRATION_ARG_PASS = "segment_pass (migration, arg)"
WIDE_ARG_PASS = "segment_pass (wide, arg)"
ARG_PARENTS = {ARG_PASS: "segment_pass", BIASED_ARG_PASS: BIASED_PASS,
               MIGRATION_ARG_PASS: MIGRATION_PASS, WIDE_ARG_PASS: WIDE_PASS}
ARG_PARENTS.update({vb_name(k): vb_name(v) if v != "segment_pass"
                    else VB_PASS for k, v in list(ARG_PARENTS.items())})
for _name in ARG_PARENTS:
    LAUNCH_COUNTS[_name] = (
        ("biased_" if "biased" in _name else "migration_"
         if "migration" in _name else "") + ("wide_" if "wide" in _name
                                             else "")
        + "arg_" + ("vb_" if "vb" in _name else "") + "launches")
ARG_A = 512  # PFConfig.arg_slots
# the migration pass with the production proposal and local recording:
# biased, guided (and biased), local, biased local, guided local, each
# with and without VB; by name its flags (biased, guide, local)
MIG_BIASED_PASS = "segment_pass (migration, biased)"
MIG_GUIDE_PASS = "segment_pass (migration, biased, guide)"
MIG_LOCAL_PASS = "segment_pass (migration, local)"
MIG_BIASED_LOCAL_PASS = "segment_pass (migration, biased, local)"
MIG_GUIDE_LOCAL_PASS = "segment_pass (migration, biased, guide, local)"
MIG_PROPOSAL_PASSES = {MIG_BIASED_PASS: (True, False, False),
                       MIG_GUIDE_PASS: (True, True, False),
                       MIG_LOCAL_PASS: (False, False, True),
                       MIG_BIASED_LOCAL_PASS: (True, False, True),
                       MIG_GUIDE_LOCAL_PASS: (True, True, True)}
MIG_PROPOSAL_PASSES.update({vb_name(k): v for k, v in
                            list(MIG_PROPOSAL_PASSES.items())})
for _name, (_b, _g, _l) in MIG_PROPOSAL_PASSES.items():
    LAUNCH_COUNTS[_name] = ("migration_" + ("biased_" if _b else "")
                            + ("guide_" if _g else "")
                            + ("local_" if _l else "")
                            + ("vb_" if "vb" in _name else "") + "launches")
# the compared shapes (P, n, E): P leaves the last block ragged (16
# particles per block up to 16 leaves, 8 above; n = 16 and 17 on either
# side of the group sizes' boundary) and is smaller where the plain
# version's [P, N + E, E, N] hazard grid would take more than a few GB
WIDE_SHAPES = ((10001, 9, 9), (4001, 9, 64), (10001, 16, 9), (4001, 16, 64),
               (4001, 17, 9), (4001, 33, 9), (2001, 33, 64), (4001, 64, 9),
               (1001, 64, 64))
WIDE_P = 10000
GUIDE_WINDOW = 100.0  # EMConfig.guide_interval, bp
LOCAL_SLOTS = 32  # PFConfig.local_ring
# bench.py's feature_bias_guide: -bias_heights 0 0.01 (400 generations)
# -bias_strengths 2 1, with a constant guide
BIAS_GUIDE_FLAGS = ["-bias_heights", "0", "0.01", "-bias_strengths", "2",
                    "1"]


class MigCase:
    """Two-population trees (or, with ``caps``, those of
    ``sweep_profile.caps_demo``: 8 samples, 64 epochs, 4 populations) with
    filled migration buffers (the plain ``make_initial_trees``) and the
    inputs of a migration segment pass on the card, made from a seed."""

    def __init__(self, P, leaf_status, L, nr_scale, seed, m=TWOPOP_M,
                 Mw=TWOPOP_MW, sample_pops=(0, 0, 1, 1),
                 max_walk_events=None, caps=False):
        import numpy as np
        import torch

        from smcsmc_tpu_torch.kernels.migration import (
            migration_tables,
            stats_offsets,
        )
        from smcsmc_tpu_torch.kernels.tree import (
            epochs_from_demography,
            make_initial_trees,
        )
        from smcsmc_tpu_torch.sweep_profile import caps_demo, twopop_demo

        dev = torch.device(DEVICE)
        demo = (caps_demo(m) if caps
                else twopop_demo(m=m, sample_pops=sample_pops))
        self.demo = demo
        self.P, self.L, self.Mw = P, L, Mw
        self.n, self.E = demo.num_samples, demo.num_epochs
        self.Pp = demo.num_populations
        self.max_walk_events = max_walk_events
        self.leaf_status = leaf_status
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(seed)
        self.epochs = epochs_from_demography(demo, dev)
        trees = make_initial_trees(self.gen, self.epochs, P,
                                   demo.sample_pops, max_mig=Mw)
        hd = torch.ones(self.n, dtype=torch.bool, device=dev)
        if leaf_status == 0:
            hd[0] = hd[2] = False
        elif leaf_status == -1:
            hd[:] = False
        self.has_data = hd
        nr = torch.rand(P, generator=self.gen, device=dev) * nr_scale * L
        self.base = {k: v.contiguous() for k, v in dict(
            time=trees.time, parent=trees.parent, child0=trees.child0,
            child1=trees.child1, next_rec=nr,
            log_w=torch.full((P,), -float(np.log(P)), device=dev),
            pop=trees.pop, mig_time=trees.mig_time,
            mig_dest=trees.mig_dest).items()}
        self.start = self.epochs.start.contiguous()
        self.inv2ne = self.epochs.inv2ne.contiguous()
        self.K = stats_offsets(self.E, self.Pp)["width"]
        self.fifo = torch.rand((P, FIFO_SLOTS, self.K), generator=self.gen,
                               device=dev)
        self.fifo[:, 0] = 0.0
        self.fifo_mask = (torch.rand(self.K, generator=self.gen, device=dev)
                          < 0.75).float()
        self.tables = migration_tables(self.epochs)
        self.key = torch.randint(0, 2 ** 31 - 1, (2,), generator=self.gen,
                                 device=dev, dtype=torch.int32)

    def uniforms(self, T):
        import torch

        return torch.rand((T, self.P, 4), generator=self.gen, device=DEVICE)

    def fresh(self):
        import torch

        st = {k: v.clone() for k, v in self.base.items()}
        st["fifo"] = self.fifo.clone()
        st["tl"] = torch.empty(self.P, device=DEVICE)
        st["diag"] = torch.zeros(2, dtype=torch.float64, device=DEVICE)
        return st

    def run(self, fn, u, st, vb=None):
        from smcsmc_tpu_torch.kernels.migration import MigrationPass

        mp = MigrationPass(st["pop"], st["mig_time"], st["mig_dest"],
                           st["diag"], self.key, *self.tables)
        if self.max_walk_events is not None:
            mp = mp._replace(max_walk_events=self.max_walk_events)
        fn(u, self.leaf_status, *(st[k] for k in SEGMENT_STATE), st["fifo"],
           self.fifo_mask, st["tl"], self.L, MU, RHO, self.start,
           self.inv2ne, self.has_data, None, mp, vb=vb)
        return st

    def result(self, st):
        """The pass's outputs under the names ``disagreement`` knows (with
        a proposal variant's pilot weight and ring of delayed factors)."""
        import torch

        from smcsmc_tpu_torch.kernels.trip import BIAS_FIELDS

        if not torch.equal(st["fifo"][:, 1:], self.fifo[:, 1:]):
            raise SystemExit("the migration pass wrote outside FIFO slot 0")
        out = {k: st[k] for k in SEGMENT_STATE + ("pop", "mig_time",
                                                  "mig_dest")
               + BIAS_FIELDS if k in st}
        out["tl"] = st["tl"]
        out["pending"] = st["fifo"][:, 0]
        return out

    def fresh_proposal(self, flags, S=2):
        """State of a proposal variant of the pass (``flags`` = (biased,
        guide, local)): the pass's, with a pilot weight and a ring of
        delayed factors (30% of the slots in use and every slot of the
        first 16 particles; due from the segment's start to two segments
        on) where biased, and a ring of pending local events (the same
        shares; positions before the front, due from the front to two
        segments on) and the output of the segment's opportunity where
        local; the rings, the section table (2 or ``S`` = 8 sections) and
        the lags drawn at the first call."""
        import torch

        from smcsmc_tpu_torch.kernels.tree import INF

        biased, _, local = flags
        if not hasattr(self, "pring"):
            P, dev, g = self.P, DEVICE, self.gen

            def used_of(K):
                used = torch.rand((P, K), generator=g, device=dev) < 0.3
                used[:16] = True
                return used

            used = used_of(BIAS_SLOTS)
            self.pring = dict(
                log_pilot=torch.randn(P, generator=g, device=dev),
                df_pos=torch.where(used, BIAS_FRONT + 2 * self.L * torch.rand(
                    (P, BIAS_SLOTS), generator=g, device=dev), INF),
                df_logf=torch.where(used, torch.randn(
                    (P, BIAS_SLOTS), generator=g, device=dev), 0.0),
                df_delta=torch.where(used, 3000.0 * torch.rand(
                    (P, BIAS_SLOTS), generator=g, device=dev), 0.0),
                df_k=torch.where(used, torch.randint(
                    1, 4, (P, BIAS_SLOTS), generator=g, device=dev,
                    dtype=torch.int32), 0))
            heights, strengths = ((BIAS_HEIGHTS, BIAS_STRENGTHS) if S == 2
                                  else (BIAS_CAPS_HEIGHTS,
                                        BIAS_CAPS_STRENGTHS))
            self.bias_tables = (
                torch.tensor(heights, device=dev),
                torch.tensor(strengths, device=dev),
                torch.linspace(3000.0, 30000.0, self.E, device=dev))
            used = used_of(LOCAL_SLOTS)
            pos = BIAS_FRONT - 2e4 * torch.rand((P, LOCAL_SLOTS),
                                                generator=g, device=dev)
            self.lring = dict(
                lr_pos=torch.where(used, pos, INF),
                lr_due=torch.where(used, pos + 2e4 + 2 * self.L * torch.rand(
                    (P, LOCAL_SLOTS), generator=g, device=dev), INF),
                lr_time=torch.where(used, 5e4 * torch.rand(
                    (P, LOCAL_SLOTS), generator=g, device=dev), 0.0),
                lr_desc=torch.where(used, torch.randint(
                    1, 1 << self.n, (P, LOCAL_SLOTS), generator=g,
                    device=dev), 0),
                lr_dropped=torch.zeros((), dtype=torch.int32, device=dev))
            self.lags = torch.linspace(2000.0, 40000.0, self.E, device=dev)
        st = self.fresh()
        if biased:
            st.update({k: v.clone() for k, v in self.pring.items()})
        if local:
            st.update({k: v.clone() for k, v in self.lring.items()})
            st["ropp"] = torch.zeros(self.P, device=DEVICE)
        return st

    def run_proposal(self, fn, u, st, flags, vb=None, delay="recomb",
                     rows=1):
        """A proposal variant (``flags``) of the pass on state ``st``, the
        delay keyed by ``delay``, a guide's rates constant over ``rows``
        windows (:func:`_guide_of`)."""
        from smcsmc_tpu_torch.kernels.bias import BiasedPass
        from smcsmc_tpu_torch.kernels.local import LocalPass
        from smcsmc_tpu_torch.kernels.migration import MigrationPass

        biased, guide, local = flags
        b = (BiasedPass(st["log_pilot"], st["df_pos"], st["df_logf"],
                        st["df_delta"], st["df_k"], *self.bias_tables,
                        BIAS_FRONT, delay) if biased else None)
        lp = (LocalPass(st["lr_pos"], st["lr_due"], st["lr_time"],
                        st["lr_desc"], st["lr_dropped"], self.lags,
                        st["ropp"], BIAS_FRONT) if local else None)
        mp = MigrationPass(st["pop"], st["mig_time"], st["mig_dest"],
                           st["diag"], self.key, *self.tables)
        if self.max_walk_events is not None:
            mp = mp._replace(max_walk_events=self.max_walk_events)
        fn(u, self.leaf_status, *(st[k] for k in SEGMENT_STATE), st["fifo"],
           self.fifo_mask, st["tl"], self.L, MU, RHO, self.start,
           self.inv2ne, self.has_data, b, mp, vb=vb,
           guide=_guide_of(self, rows) if guide else None, local=lp)
        return st


class Case:
    """Trees and trip inputs on the card, made from a seed."""

    def __init__(self, P, n, E, leaf_status, L, nr_scale, seed):
        import torch

        from smcsmc_tpu_torch.kernels.tree import (
            epochs_from_demography,
            make_initial_trees,
            tree_summaries,
        )

        dev = torch.device(DEVICE)
        self.P, self.n, self.E, self.L = P, n, E, L
        self.leaf_status = leaf_status
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(seed)
        self.demo = _demo(n, E)
        self.epochs = epochs_from_demography(self.demo, dev)
        trees = make_initial_trees(self.gen, self.epochs, P,
                                   [0] * n)
        hd = torch.ones(n, dtype=torch.bool, device=dev)
        if leaf_status == 0:
            hd[0] = False
            hd[n // 2] = False
        elif leaf_status == -1:
            hd[:] = False
        self.has_data = hd
        tl, tle, B = tree_summaries(trees, self.epochs, leaf_status, hd)
        nr = torch.rand(P, generator=self.gen, device=dev) * nr_scale * L
        self.base = dict(
            time=trees.time, parent=trees.parent, child0=trees.child0,
            child1=trees.child1, next_rec=nr,
            upd=torch.zeros(P, device=dev),
            log_w=torch.full((P,), -float(torch.log(torch.tensor(float(P)))),
                             device=dev),
            tl=tl, B=B, tl_e=tle,
            pending=torch.zeros((P, 6 * E), device=dev),
        )
        self.base = {k: v.contiguous() for k, v in self.base.items()}
        self.start = self.epochs.start.contiguous()
        self.inv2ne = self.epochs.inv2ne.contiguous()
        # for segment_pass: a FIFO whose slot 0 starts empty (so that it ends
        # as pending x mask) and whose other slots must stay as they are,
        # and a gate that closes some epochs
        K = 6 * E
        self.fifo = torch.rand((P, FIFO_SLOTS, K), generator=self.gen,
                               device=dev)
        self.fifo[:, 0] = 0.0
        self.fifo_mask = (torch.rand(K, generator=self.gen, device=dev)
                          < 0.75).float()

    def uniforms(self, T):
        import torch

        return torch.rand((T, self.P, 4), generator=self.gen, device=DEVICE)

    def fresh(self):
        return {k: v.clone() for k, v in self.base.items()}

    def run(self, fn, u, state):
        from smcsmc_tpu_torch.kernels.trip import FIELDS

        fn(u, self.leaf_status, *(state[k] for k in FIELDS), self.L, MU,
           RHO, self.start, self.inv2ne, self.has_data)
        return state

    def fresh_segment(self):
        """State of a segment pass: the trees, next_rec, log_w, the FIFO
        and the output tree length."""
        import torch

        st = {k: self.base[k].clone() for k in SEGMENT_STATE}
        st["fifo"] = self.fifo.clone()
        st["tl"] = torch.empty(self.P, device=DEVICE)
        return st

    def run_segment(self, fn, u, st, vb=None):
        fn(u, self.leaf_status, *(st[k] for k in SEGMENT_STATE), st["fifo"],
           self.fifo_mask, st["tl"], self.L, MU, RHO, self.start,
           self.inv2ne, self.has_data, vb=vb)
        return st

    def segment_result(self, st):
        """A segment pass's outputs under the names ``disagreement`` knows
        (FIFO slot 0 is pending x mask); the other slots must be intact."""
        import torch

        from smcsmc_tpu_torch.kernels.trip import BIAS_FIELDS

        if not torch.equal(st["fifo"][:, 1:], self.fifo[:, 1:]):
            raise SystemExit("segment_pass wrote outside FIFO slot 0")
        out = {k: st[k] for k in SEGMENT_STATE + BIAS_FIELDS if k in st}
        out["tl"] = st["tl"]
        out["pending"] = st["fifo"][:, 0]
        return out

    def fresh_biased(self, full=False, heights=BIAS_HEIGHTS,
                     strengths=BIAS_STRENGTHS):
        """State of a biased segment pass: a plain one's, a pilot weight
        and a ring of delayed factors with 30% of the slots in use (due
        between the segment's start and twice its length on) and every
        slot in use for the first 16 particles (their factors go to the
        pilot at once); with ``full`` every slot of every particle.  The
        ring and the section table (``heights``, ``strengths``) are drawn
        at the first call."""
        import torch

        from smcsmc_tpu_torch.kernels.tree import INF

        if not hasattr(self, "ring"):
            P, D, dev = self.P, BIAS_SLOTS, DEVICE
            used = torch.rand((P, D), generator=self.gen, device=dev) < 0.3
            used[:16] = True
            if full:
                used[:] = True
            self.ring = dict(
                log_pilot=torch.randn(P, generator=self.gen, device=dev),
                df_pos=torch.where(used, BIAS_FRONT + 2 * self.L * torch.rand(
                    (P, D), generator=self.gen, device=dev),
                    torch.full((P, D), INF, device=dev)),
                df_logf=torch.where(used, torch.randn(
                    (P, D), generator=self.gen, device=dev), 0.0),
                df_delta=torch.where(used, 3000.0 * torch.rand(
                    (P, D), generator=self.gen, device=dev), 0.0),
                df_k=torch.where(used, torch.randint(
                    1, 4, (P, D), generator=self.gen, device=dev,
                    dtype=torch.int32), 0))
            self.bias_tables = (
                torch.tensor(heights, device=dev),
                torch.tensor(strengths, device=dev),
                torch.linspace(3000.0, 30000.0, self.E, device=dev))
        st = self.fresh_segment()
        st.update({k: v.clone() for k, v in self.ring.items()})
        return st

    def run_biased(self, fn, u, st, vb=None):
        from smcsmc_tpu_torch.kernels.bias import BiasedPass

        biased = BiasedPass(st["log_pilot"], st["df_pos"], st["df_logf"],
                            st["df_delta"], st["df_k"], *self.bias_tables,
                            BIAS_FRONT)
        fn(u, self.leaf_status, *(st[k] for k in SEGMENT_STATE), st["fifo"],
           self.fifo_mask, st["tl"], self.L, MU, RHO, self.start,
           self.inv2ne, self.has_data, biased, vb=vb)
        return st


# A guide's rates change from one window of 100 bp to the next only at its
# change points.  One that changes in every window (the one-trip cases'
# guide) makes every event within rounding of a window's edge take the next
# window's leaf rates; on a chain of trips the kernel and its plain
# version, whose positions differ in their last bits (the tree length is
# summed in another order), then part at such edges: 11 of 10,000
# particles over about 9 trips each at the genome shape (a probe on the
# card, NVIDIA H100 80GB HBM3, 700 W), against the 0.1% that chains of
# trips are allowed.  A smoothed guide changes at a few points per Mb, so
# the 64-trip cases take rates constant over rows of this many windows.
GUIDE_CHAIN_ROWS = 50


def _guide_of(c, rows=1):
    """A guide that is not constant over case ``c``'s windows: random rates
    around rho and random leaf rates, drawn per row of ``rows`` windows of
    100 bp over [0, front + 2L); on the card, drawn once per case."""
    import numpy as np

    from smcsmc_tpu_torch.kernels.guide import guide_tables

    if getattr(c, "_guide_rows", None) != rows:
        rng = np.random.default_rng(c.P + c.E)
        W = int(np.ceil((BIAS_FRONT + 2 * c.L) / GUIDE_WINDOW))
        nrow = -(-W // rows)
        rate = np.repeat(RHO * rng.uniform(0.2, 3.0, nrow), rows)[:W]
        leaf = np.repeat(rng.uniform(0.3, 2.0, (nrow, c.n)), rows,
                         axis=0)[:W]
        c._guide = guide_tables(rate, leaf, RHO, GUIDE_WINDOW, DEVICE)
        c._guide_rows = rows
    return c._guide


def _fresh_new(c, name, full=False, heights=BIAS_HEIGHTS,
               strengths=BIAS_STRENGTHS):
    """State of case ``c`` for the guided or local pass ``name``: the
    plain or biased pass's, with a ring of pending local events (30% of the
    slots in use, the first 16 rings full, or every ring with ``full``;
    positions before the front, due from the front to two segments on)
    drawn at the first call, and the output of the segment's
    opportunity."""
    import torch

    from smcsmc_tpu_torch.kernels.tree import INF

    (biased, _, local), _ = GUIDE_PASSES[name]
    st = (c.fresh_biased(full, heights, strengths) if biased
          else c.fresh_segment())
    if local:
        if not hasattr(c, "lring"):
            P, R, dev = c.P, LOCAL_SLOTS, "cuda"
            used = torch.rand((P, R), generator=c.gen, device=dev) < 0.3
            used[:16] = True
            if full:
                used[:] = True
            pos = BIAS_FRONT - 2e4 * torch.rand((P, R), generator=c.gen,
                                                device=dev)
            c.lring = dict(
                lr_pos=torch.where(used, pos, INF),
                lr_due=torch.where(used, pos + 2e4 + 2 * c.L * torch.rand(
                    (P, R), generator=c.gen, device=dev), INF),
                lr_time=torch.where(used, 5e4 * torch.rand(
                    (P, R), generator=c.gen, device=dev), 0.0),
                lr_desc=torch.where(used, torch.randint(
                    1, 1 << c.n, (P, R), generator=c.gen, device=dev), 0),
                lr_dropped=torch.zeros((), dtype=torch.int32, device=dev))
            c.lags = torch.linspace(2000.0, 40000.0, c.E, device=dev)
        st.update({k: v.clone() for k, v in c.lring.items()})
        st["ropp"] = torch.zeros(c.P, device="cuda")
    return st


def _run_new(c, fn, u, st, name, vb=None, rows=1):
    """The guided or local pass ``name`` (``fn``: the wrapper or its plain
    version) on case ``c``'s state ``st``, a guide's rates constant over
    ``rows`` windows."""
    from smcsmc_tpu_torch.kernels.bias import BiasedPass
    from smcsmc_tpu_torch.kernels.local import LocalPass

    (biased, guide, local), _ = GUIDE_PASSES[name]
    b = (BiasedPass(st["log_pilot"], st["df_pos"], st["df_logf"],
                    st["df_delta"], st["df_k"], *c.bias_tables, BIAS_FRONT)
         if biased else None)
    lp = (LocalPass(st["lr_pos"], st["lr_due"], st["lr_time"],
                    st["lr_desc"], st["lr_dropped"], c.lags, st["ropp"],
                    BIAS_FRONT) if local else None)
    fn(u, c.leaf_status, *(st[k] for k in SEGMENT_STATE), st["fifo"],
       c.fifo_mask, st["tl"], c.L, MU, RHO, c.start, c.inv2ne, c.has_data,
       b, vb=vb, guide=_guide_of(c, rows) if guide else None, local=lp)
    return st


LOCAL_FIELDS = ("lr_pos", "lr_due", "lr_time", "lr_desc", "ropp")


def _ring_apart(got, ref, agree, L, tol):
    """The local ring's fields of two runs that differ on the particles in
    ``agree``: slots in use, positions and due positions (to the positions'
    tolerance), heights (a node height's), bitmasks exactly, the segment's
    opportunity (the FIFO's recombination opportunity's)."""
    import torch

    from smcsmc_tpu_torch.kernels.tree import INF

    apart = []
    if not torch.equal((got["lr_pos"] < INF)[agree],
                       (ref["lr_pos"] < INF)[agree]):
        apart.append("slots in use")
    for k, atol in (("lr_pos", tol["next_rec"]), ("lr_due", tol["next_rec"]),
                    ("lr_time", tol["time"]), ("ropp", tol["ropp"])):
        a, b = got[k][agree].double(), ref[k][agree].double()
        if not bool(((a - b).abs() <= RTOL * b.abs() + atol).all()):
            apart.append(k)
    if not torch.equal(got["lr_desc"][agree], ref["lr_desc"][agree]):
        apart.append("lr_desc")
    return apart


def guide_cases():
    """The guided and local passes' cases: (pass, label, (P, n, E), leaf
    status, ring and section options, trips): each pass at the main
    path's shape at leaf status 1 and 0, one trip and 64 on the longest
    segment; the local biased passes with every ring full at the genome
    shape; the guided local, biased local and local passes at the biased
    pass's caps corner; each VB variant at one trip."""
    out = []
    for name in (GUIDE_PASS, GUIDE_LOCAL_PASS, BIASED_LOCAL_PASS,
                 LOCAL_PASS):
        for ls in (1, 0):
            out += [(name, "", (10000, 4, 9), ls, {}, T) for T in (1, 64)]
        out.append((vb_name(name), "", (10000, 4, 9), 1, {}, 1))
    for name in (GUIDE_LOCAL_PASS, BIASED_LOCAL_PASS, LOCAL_PASS):
        out += [(name, " every ring full", (GENOME_P, 8, 33), 1,
                 dict(full=True), T) for T in (1, 64)]
    for name in (GUIDE_LOCAL_PASS, BIASED_LOCAL_PASS, LOCAL_PASS):
        out.append((name, " caps corner (8 sections)", (CAPS_P, 8, 64), 1,
                    dict(heights=BIAS_CAPS_HEIGHTS,
                         strengths=BIAS_CAPS_STRENGTHS), 1))
    return out


def compare_guide(segment_pass, segment_pass_plain, tallies):
    """Each guided and local pass against its plain version on identical
    inputs (a guide that is not constant, a ring 30% in use or full): one
    trip with no tree mismatch, every float within tolerance and the
    rings' contents equal (bitmasks and drops exactly, positions,
    heights and the segment's opportunity within their tolerances), on a
    guide that changes in every window; 64 trips with at most 0.1% of the
    particles apart and the rings equal on the others, on a guide that
    changes every ``GUIDE_CHAIN_ROWS`` windows.  The comparisons must push events, and with full rings
    drop them."""
    import torch

    from smcsmc_tpu_torch.kernels.trip import disagreement, float_tolerances

    for name in GUIDE_PASSES:
        tallies[name] = (Tally(), Tally())
    ok = True
    for name, label, (P, n, E), ls, ring, T in guide_cases():
        L, nr_scale = ((20000.0, 1.5) if T == 1 else (MAX_SEG, 0.1))
        c = Case(P, n, E, ls, L=L, nr_scale=nr_scale,
                 seed=23 * P + T + ls + len(label) + len(name))
        vb = vb_tables(c.demo, T + ls) if "vb" in name else None
        u = c.uniforms(T)
        rows = 1 if T == 1 else GUIDE_CHAIN_ROWS
        sts = [_run_new(c, fn, u, _fresh_new(c, name, **ring), name, vb,
                        rows) for fn in (segment_pass, segment_pass_plain)]
        torch.cuda.synchronize()
        got, ref = (c.segment_result({k: v for k, v in st.items()
                                      if k not in LOCAL_FIELDS
                                      and k != "lr_dropped"})
                    for st in sts)
        trees, floats, errs = disagreement(got, ref, c.L, MU, RTOL)
        agree = ~(trees | floats)
        local = GUIDE_PASSES[name][0][2]
        ring_note = ""
        if local:
            tol = float_tolerances(ref, c.L, MU)
            tol["ropp"] = float(tol["pending"][4 * E])
            apart = _ring_apart(sts[0], sts[1], agree, c.L, tol)
            drops = [int(st["lr_dropped"]) for st in sts]
            pushed = int((sts[1]["lr_pos"] != c.lring["lr_pos"]).sum())
            if T == 1 and drops[0] != drops[1]:
                apart.append("drops")
            if pushed == 0 and not ring.get("full"):
                apart.append("no event pushed")
            if ring.get("full") and drops[1] == 0:
                apart.append("no event dropped on full rings")
            ring_note = (f"; ring {'equal' if not apart else apart} "
                         f"({pushed} slots pushed, dropped {drops[0]} / "
                         f"{drops[1]})")
        else:
            apart = []
        if T == 1:
            good = int(trees.sum()) == 0 and int(floats.sum()) == 0
        else:
            good = int((trees | floats).sum()) <= (1.0 - MATCH_MIN) * P
        good &= not apart
        tallies[name][T > 1].add(trees, floats, errs)
        _report(f"{name}{label} P={P} n={n} E={E} leaf_status={ls} "
                f"trips={T}" + (" vs plain" if T > 1 else "") + ring_note,
                P, trees, floats, errs, good)
        ok &= good
    return ok


class Tally:
    """Worst errors over one kind of comparison, for the kernels line."""

    def __init__(self):
        self.max_abs_err, self.field = 0.0, "-"
        self.max_err_over_tol = 0.0
        self.tree_mismatches = self.particles_beyond = 0

    def add(self, trees, floats, errs):
        self.tree_mismatches += int(trees.sum())
        self.particles_beyond += int(floats.sum())
        for k, (err, ratio) in errs.items():
            if err > self.max_abs_err:
                self.max_abs_err, self.field = err, k
            self.max_err_over_tol = max(self.max_err_over_tol, ratio)

    def record(self):
        return {"max_abs_err": self.max_abs_err, "field": self.field,
                "max_err_over_tol": self.max_err_over_tol,
                "tree_mismatches": self.tree_mismatches,
                "particles_beyond_tol": self.particles_beyond}


def _report(name, P, trees, floats, errs, good):
    worst = max(errs, key=lambda k: errs[k][1])
    by_field = " ".join(f"{k}={e:.3g}" for k, (e, _) in errs.items())
    _log(f"compare {name}: tree mismatches {int(trees.sum())}/{P}, floats "
         f"beyond tolerance {int(floats.sum())}; max abs err {by_field}; "
         f"worst err/tol {errs[worst][1]:.4g} ({worst}) -> "
         f"{'ok' if good else 'FAIL'}")


def phase_compare(kernels):
    """Run every comparison; return {entry point: (single, chained)}, the
    worst errors of each kind."""
    import torch

    from smcsmc_tpu_torch.kernels.trip import FIELDS, disagreement

    trip, trip_plain = kernels["trip"]
    segment_pass, segment_pass_plain = kernels["segment_pass"]
    tallies = {name: (Tally(), Tally()) for name in kernels}
    ok = True

    def both(c, u):
        """(got, ref) of each entry point on case ``c`` with uniforms ``u``."""
        out = {"trip": (c.run(trip, u, c.fresh()),
                        c.run(trip_plain, u, c.fresh()))}
        got = c.run_segment(segment_pass, u, c.fresh_segment())
        ref = c.run_segment(segment_pass_plain, u, c.fresh_segment())
        out["segment_pass"] = (c.segment_result(got), c.segment_result(ref))
        torch.cuda.synchronize()
        return out

    for P, n, E in ((10000, 4, 9), (10000, 4, 8), (4096, 8, 33),
                    (10000, 8, 33)):
        budget = (1.0 - MATCH_MIN) * P
        for ls in (1, 0, -1):
            # one trip, most particles active: every particle whose tree
            # agrees must agree in every float
            c = Case(P, n, E, ls, L=20000.0, nr_scale=1.5, seed=P + n + E + ls)
            for name, (got, ref) in both(c, c.uniforms(1)).items():
                trees, floats, errs = disagreement(got, ref, c.L, MU, RTOL)
                good = int(trees.sum()) <= budget and int(floats.sum()) == 0
                tallies[name][0].add(trees, floats, errs)
                _report(f"{name} P={P} n={n} E={E} leaf_status={ls} trips=1",
                        P, trees, floats, errs, good)
                ok &= good
            # 64 trips in one launch vs plain on the longest segment the
            # sweep produces; for trip also vs 64 single launches
            c = Case(P, n, E, ls, L=MAX_SEG, nr_scale=0.1,
                     seed=7 * P + n + E + ls)
            u = c.uniforms(64)
            results = both(c, u)
            for name, (got, ref) in results.items():
                trees, floats, errs = disagreement(got, ref, c.L, MU, RTOL)
                good = int((trees | floats).sum()) <= budget
                tallies[name][1].add(trees, floats, errs)
                _report(f"{name} P={P} n={n} E={E} leaf_status={ls} trips=64 "
                        f"vs plain", P, trees, floats, errs, good)
                ok &= good
            seq = c.fresh()
            for j in range(64):
                c.run(trip, u[j:j + 1].contiguous(), seq)
            torch.cuda.synchronize()
            got = results["trip"][0]
            same = all(torch.equal(got[k], seq[k]) for k in FIELDS)
            _log(f"compare trip P={P} n={n} E={E} leaf_status={ls} trips=64 "
                 f"vs 64x trips=1: bit for bit "
                 f"{'equal -> ok' if same else 'FAIL'}")
            ok &= same

    # the biased pass at the biased path's shape (pilot weight and ring
    # fields held too: float_tolerances names them), then with every ring
    # full and at the caps corner, where one trip must leave no tree
    # mismatch at all
    tallies[BIASED_PASS] = (Tally(), Tally())
    cases = [(GENOME_P, 8, 33, ls, "", {}) for ls in (1, 0, -1)] + [
        (GENOME_P, 8, 33, 1, " every ring full", dict(full=True)),
        (CAPS_P, 8, 64, 1, " caps corner (8 sections)",
         dict(heights=BIAS_CAPS_HEIGHTS, strengths=BIAS_CAPS_STRENGTHS))]
    for P, n, E, ls, label, ring in cases:
        budget = 0 if label else (1.0 - MATCH_MIN) * P
        for T, L, nr_scale in ((1, 20000.0, 1.5), (64, MAX_SEG, 0.1)):
            c = Case(P, n, E, ls, L=L, nr_scale=nr_scale,
                     seed=11 * P + T + ls + len(label))
            u = c.uniforms(T)
            got = c.segment_result(c.run_biased(segment_pass, u,
                                                c.fresh_biased(**ring)))
            ref = c.segment_result(c.run_biased(segment_pass_plain, u,
                                                c.fresh_biased()))
            torch.cuda.synchronize()
            if torch.equal(ref["df_pos"], c.ring["df_pos"]):
                raise SystemExit("the biased comparison moved no factor")
            trees, floats, errs = disagreement(got, ref, c.L, MU, RTOL)
            if T == 1:
                good = int(trees.sum()) <= budget and int(floats.sum()) == 0
            else:
                good = int((trees | floats).sum()) <= (1.0 - MATCH_MIN) * P
            tallies[BIASED_PASS][T > 1].add(trees, floats, errs)
            _report(f"{BIASED_PASS}{label} P={P} n={n} E={E} leaf_status="
                    f"{ls} trips={T}" + (" vs plain" if T > 1 else ""), P,
                    trees, floats, errs, good)
            ok &= good
    ok &= compare_migration(segment_pass, segment_pass_plain, tallies)
    ok &= compare_mig_proposal(segment_pass, segment_pass_plain, tallies)
    ok &= compare_vb(segment_pass, segment_pass_plain, tallies)
    ok &= compare_guide(segment_pass, segment_pass_plain, tallies)
    ok &= compare_wide(kernels, tallies)
    if not ok:
        raise SystemExit("kernel and plain version disagree beyond tolerance")
    return tallies


# the cases of the migration pass: bench.py's twopop model at each leaf
# status; buffers that overflow (-migbuf 16 at m = 2e-4); a lone sample in
# population 0 (samples [0, 1, 1, 1]), whose cut lineage has no partner of
# its population below the root but its own branch; walks bounded at 3
# events (about 5 on average at this model), so that many are capped and
# force-coalesce onto the root lineage; the kernel's caps (8 samples, 64
# epochs, 4 populations, 96 events per buffer: the most shared memory per
# particle) with a particle count that leaves the last block ragged
CAPS_P = 10001
MIG_CASES = ([("twopop", {}, ls) for ls in (1, 0, -1)]
             + [("overflow", {"m": 2e-4, "Mw": 16}, 1),
                ("above the root", {"sample_pops": (0, 1, 1, 1)}, 1),
                ("capped", {"max_walk_events": 3}, 1),
                ("caps corner", {"caps": True, "m": 1e-4, "Mw": 96,
                                 "P": CAPS_P}, 1)])
# what the migration pass must give exactly as its plain version does
MIG_EXACT = ("time", "parent", "child0", "child1", "pop", "mig_time",
             "mig_dest")


def compare_migration(segment_pass, segment_pass_plain, tallies,
                      P=TWOPOP_P):
    """The migration pass against its plain version for each of
    :data:`MIG_CASES` (at the twopop path's shape, P, n=4, E=8, Pp=2,
    unless the case says otherwise), one trip and 64 trips: no tree
    mismatch, node times, populations and the buffers' times and
    destinations bit for bit, the walk diagnostics equal, floats within
    ``float_tolerances``; the overflow case must drop events, the
    above-the-root case must coalesce above the old root, the capped case
    must cap walks and the caps corner must leave its last block ragged."""
    import torch

    from smcsmc_tpu_torch.kernels.trip import disagreement, kernel_resources

    tallies[MIGRATION_PASS] = (Tally(), Tally())
    ok = True
    for label, kw, ls in MIG_CASES:
        kw = dict(kw)
        Pc = kw.pop("P", P)
        for T, L, nr_scale in ((1, 20000.0, 1.5), (64, MAX_SEG, 0.1)):
            c = MigCase(Pc, ls, L, nr_scale, seed=13 * Pc + T + ls, **kw)
            u = c.uniforms(T)
            got_st = c.run(segment_pass, u, c.fresh())
            ref_st = c.run(segment_pass_plain, u, c.fresh())
            torch.cuda.synchronize()
            got, ref = c.result(got_st), c.result(ref_st)
            trees, floats, errs = disagreement(got, ref, c.L, MU, RTOL,
                                               Pp=c.Pp)
            exact = all(torch.equal(got[k], ref[k]) for k in MIG_EXACT)
            same_diag = torch.equal(got_st["diag"], ref_st["diag"])
            good = (int(trees.sum()) == 0 and int(floats.sum()) == 0
                    and exact and same_diag)
            above = int((ref["time"].max(dim=1).values
                         > c.base["time"].max(dim=1).values).sum())
            capped, dropped = (float(x) for x in ref_st["diag"])
            ppb = kernel_resources("migration", c.n, c.E, c.Pp, c.Mw)[
                "particles_per_block"]
            if label == "overflow" and T == 64:
                good &= dropped > 0
            if label == "above the root":
                good &= above > 0
            if label == "capped":
                good &= capped > 0
            if label == "caps corner":
                good &= Pc % ppb != 0
            tallies[MIGRATION_PASS][T > 1].add(trees, floats, errs)
            _report(f"{MIGRATION_PASS} {label} P={Pc} n={c.n} E={c.E} "
                    f"Pp={c.Pp} Mw={c.Mw} ({ppb} particles per block) "
                    f"leaf_status={ls} trips={T}"
                    + (" vs plain" if T > 1 else "")
                    + f" (walks capped {capped:g}, events dropped "
                    f"{dropped:g}, kernel {got_st['diag'].tolist()}; "
                    f"{above} coalesced above the old root; trees and "
                    f"buffers bit for bit {exact})",
                    Pc, trees, floats, errs, good)
            ok &= good
    return ok


# the proposal variants' cases: (pass, label, MigCase options, leaf
# status, trips, delay type), each of the ten at the twopop shape and at
# the caps corner (8 sections; P ragged against the block) with one trip,
# the biased and the guided local pass also with 64 trips on the longest
# segment; across them every leaf status, both trip counts, 2 sections
# and 8 and the three delay types
MIG_CAPS = {"caps": True, "m": 1e-4, "Mw": 96}
MIG_PROPOSAL_CASES = (
    [(MIG_BIASED_PASS, "", {}, 1, 1, "recomb"),
     (MIG_BIASED_PASS, "", {}, 0, 64, "coal"),
     (MIG_BIASED_PASS, " caps corner", MIG_CAPS, 1, 1, "migr"),
     (MIG_GUIDE_PASS, "", {}, 1, 1, "migr"),
     (MIG_GUIDE_PASS, "", {}, -1, 1, "recomb"),
     (MIG_GUIDE_PASS, " caps corner", MIG_CAPS, 0, 1, "coal"),
     (MIG_LOCAL_PASS, "", {}, 0, 1, "recomb"),
     (MIG_LOCAL_PASS, "", {}, 1, 1, "recomb"),
     (MIG_LOCAL_PASS, " caps corner", MIG_CAPS, 1, 1, "recomb"),
     (MIG_BIASED_LOCAL_PASS, "", {}, -1, 1, "coal"),
     (MIG_BIASED_LOCAL_PASS, "", {}, 1, 1, "migr"),
     (MIG_BIASED_LOCAL_PASS, " caps corner", MIG_CAPS, 1, 1, "recomb"),
     (MIG_GUIDE_LOCAL_PASS, "", {}, 0, 1, "recomb"),
     (MIG_GUIDE_LOCAL_PASS, "", {}, 0, 64, "migr"),
     (MIG_GUIDE_LOCAL_PASS, " caps corner", MIG_CAPS, 1, 1, "coal")]
    + [(vb_name(name), label, kw, ls, 1, delay)
       for name, label, kw, ls, delay in (
           (MIG_BIASED_PASS, "", {}, 1, "migr"),
           (MIG_BIASED_PASS, " caps corner", MIG_CAPS, 0, "coal"),
           (MIG_GUIDE_PASS, "", {}, 0, "recomb"),
           (MIG_GUIDE_PASS, " caps corner", MIG_CAPS, 1, "coal"),
           (MIG_LOCAL_PASS, "", {}, 0, "recomb"),
           (MIG_LOCAL_PASS, " caps corner", MIG_CAPS, -1, "recomb"),
           (MIG_BIASED_LOCAL_PASS, "", {}, 1, "recomb"),
           (MIG_BIASED_LOCAL_PASS, " caps corner", MIG_CAPS, 1, "migr"),
           (MIG_GUIDE_LOCAL_PASS, "", {}, -1, "migr"),
           (MIG_GUIDE_LOCAL_PASS, " caps corner", MIG_CAPS, 0, "coal"))])


# corners of the proposal variants (mig_corner): every slot of the ring of
# delayed factors in use, so that the pilot takes each late factor at once;
# eight slots a particle due in the segment with 2-4 applications left, so
# that each application doubles its spacing; every slot of the local ring
# in use, so that each event is dropped; the forests of the caps corner's
# trees (several roots, an internal node unused, a child of -1), every
# forest's particle recombining at the segment's start
MIG_CORNERS = ("full ring", "due many", "local full", "forest")


def mig_corner(c, st, corner):
    """State ``st`` of a proposal variant on case ``c`` turned into
    ``corner`` (:data:`MIG_CORNERS`), the same tensors at every call."""
    import torch

    if not hasattr(c, "_corner"):
        g = torch.Generator(device=DEVICE).manual_seed(c.P + 17)
        P, D, R = c.P, BIAS_SLOTS, LOCAL_SLOTS

        def draw(shape, scale=1.0, at=0.0):
            return at + scale * torch.rand(shape, generator=g, device=DEVICE)

        lpos = draw((P, R), -2e4, BIAS_FRONT)
        c._corner = dict(
            df_pos=draw((P, D), 2 * c.L, BIAS_FRONT),
            df_logf=torch.randn((P, D), generator=g, device=DEVICE),
            df_delta=draw((P, D), 3000.0),
            df_k=torch.randint(2, 5, (P, D), generator=g, device=DEVICE,
                               dtype=torch.int32),
            due=draw((P, 8), c.L, BIAS_FRONT),
            lr_pos=lpos, lr_due=lpos + 2e4 + draw((P, R), 2 * c.L),
            lr_time=draw((P, R), 5e4),
            lr_desc=torch.randint(1, 1 << c.n, (P, R), generator=g,
                                  device=DEVICE))
    x = c._corner
    if corner == "full ring":
        for k in ("df_pos", "df_logf", "df_delta", "df_k"):
            st[k] = x[k].clone()
    elif corner == "due many":
        st["df_pos"][:, :8] = x["due"]
        for k in ("df_logf", "df_delta", "df_k"):
            st[k][:, :8] = x[k][:, :8]
    elif corner == "local full":
        for k in ("lr_pos", "lr_due", "lr_time", "lr_desc"):
            st[k] = x[k].clone()
    elif corner == "forest":
        forest = (st["parent"] < 0).sum(dim=1) > 1
        st["next_rec"][forest] = 1.0
    elif corner is not None:
        raise ValueError(f"unknown corner {corner!r}")
    return st


def mig_proposal_one(segment_pass, segment_pass_plain, tallies, name,
                     label, kw, ls, T, delay, P=TWOPOP_P, caps_P=CAPS_P,
                     exact=True, corner=None):
    """One case of :func:`compare_mig_proposal`: the proposal variant
    ``name`` and its plain version on identical inputs (a ring of delayed
    factors and one of local events each 30% in use, a guide that is not
    constant: its rates change every window at one trip, every
    ``GUIDE_CHAIN_ROWS`` windows at more; ``corner`` one of
    :data:`MIG_CORNERS` instead).  As :func:`compare_migration` holds the
    migration pass: no tree mismatch, node times, populations and the
    buffers' times and destinations bit for bit (times within tolerance
    with ``exact`` False), the walk diagnostics equal, every float within
    ``float_tolerances``; the local ring as :func:`compare_guide` holds it
    (slots in use, bitmasks and drops exactly); the case must change a
    ring slot and push a local event (drop one, with every slot in use),
    and a forest's particle must recombine."""
    import torch

    from smcsmc_tpu_torch.kernels.migration import stats_offsets
    from smcsmc_tpu_torch.kernels.trip import disagreement, float_tolerances

    flags = MIG_PROPOSAL_PASSES[name]
    biased, _, local = flags
    Pc = caps_P if kw.get("caps") else P
    L, nr_scale = (20000.0, 1.5) if T == 1 else (MAX_SEG, 0.1)
    c = MigCase(Pc, ls, L, nr_scale, seed=29 * Pc + T + ls + len(name), **kw)
    u = c.uniforms(T)
    vb = vb_tables(c.demo, T + ls) if "vb" in name else None
    rows = 1 if T == 1 else GUIDE_CHAIN_ROWS
    S = 8 if kw.get("caps") else 2
    start = mig_corner(c, c.fresh_proposal(flags, S), corner)
    sts = [c.run_proposal(fn, u, {k: v.clone() for k, v in start.items()},
                          flags, vb, delay, rows)
           for fn in (segment_pass, segment_pass_plain)]
    _sync()
    got, ref = (c.result(st) for st in sts)
    trees, floats, errs = disagreement(got, ref, c.L, MU, RTOL, Pp=c.Pp)
    keys = MIG_EXACT if exact else tuple(k for k in MIG_EXACT if k not in (
        "time", "mig_time"))
    same = all(torch.equal(got[k], ref[k]) for k in keys)
    same_diag = torch.equal(sts[0]["diag"], sts[1]["diag"])
    apart, notes = [], []
    if biased:
        changed = int((sts[1]["df_pos"] != start["df_pos"]).sum())
        notes.append(f"{changed} ring slots changed")
        if changed == 0:
            apart.append("no ring slot changed")
    if local:
        tol = float_tolerances(ref, c.L, MU, Pp=c.Pp)
        tol["ropp"] = float(tol["pending"][stats_offsets(
            c.E, c.Pp)["recomb_opp"]])
        apart += _ring_apart(sts[0], sts[1], ~(trees | floats), c.L, tol)
        drops = [int(st["lr_dropped"]) for st in sts]
        pushed = int((sts[1]["lr_pos"] != start["lr_pos"]).sum())
        if drops[0] != drops[1]:
            apart.append("drops")
        if corner == "local full" and drops[0] == 0:
            apart.append("no event dropped")
        if pushed == 0 and corner != "local full":
            apart.append("no event pushed")
        notes.append(f"{pushed} local events pushed, dropped {drops[0]} / "
                     f"{drops[1]}")
    if corner == "forest":
        # a forest's particle that took its trip has a new next_rec
        forest = (start["parent"] < 0).sum(dim=1) > 1
        moved = forest & (sts[1]["next_rec"] != start["next_rec"])
        grafted = moved & (sts[1]["parent"] != start["parent"]).any(dim=1)
        notes.append(f"{int(moved.sum())} forests recombine, "
                     f"{int(grafted.sum())} of them regrafted")
        if int(moved.sum()) == 0:
            apart.append("no forest recombines")
    good = (int(trees.sum()) == 0 and int(floats.sum()) == 0 and same
            and same_diag and not apart)
    tallies.setdefault(name, (Tally(), Tally()))[T > 1].add(trees, floats,
                                                             errs)
    _report(f"{name}{label} P={Pc} n={c.n} E={c.E} Pp={c.Pp} Mw={c.Mw} "
            f"leaf_status={ls} trips={T}" + (" vs plain" if T > 1 else "")
            + (f" delay {delay}" if biased else "")
            + (f" {corner}" if corner else "")
            + f" ({'; '.join(notes)}; walks capped, events dropped "
            f"{sts[1]['diag'].tolist()}; trees and buffers bit for bit "
            f"{same}" + (f"; rings {apart}" if apart else "") + ")",
            Pc, trees, floats, errs, good)
    return good


def compare_mig_proposal(segment_pass, segment_pass_plain, tallies,
                         P=TWOPOP_P, caps_P=CAPS_P, exact=True):
    """Each proposal variant of the migration pass against its plain
    version, :data:`MIG_PROPOSAL_CASES` by :func:`mig_proposal_one` (the
    caps corner at ``caps_P`` particles, the others at ``P``)."""
    ok = True
    for name, label, kw, ls, T, delay in MIG_PROPOSAL_CASES:
        ok &= mig_proposal_one(segment_pass, segment_pass_plain, tallies,
                               name, label, kw, ls, T, delay, P, caps_P,
                               exact)
    return ok


def _in_double(x):
    """``x`` with its float32 tensors in float64: a state or a dict of
    them, a tuple of tensors, or a :class:`Case` (a shallow copy with its
    epoch tables, FIFO, gate and bias tables in float64), for a run of the
    plain version in double."""
    import copy

    import torch

    def up(v):
        return (v.double() if isinstance(v, torch.Tensor)
                and v.dtype == torch.float32 else v)
    if isinstance(x, dict):
        return {k: _in_double(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_in_double(v) for v in x)
    if isinstance(x, Case):
        d = copy.copy(x)
        for k in ("start", "inv2ne", "fifo", "fifo_mask"):
            setattr(d, k, up(getattr(x, k)))
        if hasattr(x, "bias_tables"):
            d.bias_tables = _in_double(x.bias_tables)
        return d
    return up(x)


def compare_wide(kernels, tallies):
    """The wide kernels (more than 8 leaves) against their plain versions
    on identical inputs at each of :data:`WIDE_SHAPES`, leaf status 1, 0
    and -1, one trip at 20 kb and 64 trips at 50 kb: ``trip``, the plain
    and the biased pass (2 sections at 9 epochs, 8 at 64; a ring 30% in
    use), each pass with and without VB (:func:`vb_tables`; the VB
    variants at one trip, as ``compare_vb`` holds the caps).  One trip: no
    tree mismatch and every float within tolerance; 64 trips: at most 0.1%
    of the particles apart, as the narrow kernels.  The reference is the
    plain version run in float64 (:func:`_in_double`) and rounded to
    float32 as the kernel stores it: the wide kernels
    compute a trip in double, and along 64 trips at 64 leaves the plain
    version in float32 drifts by up to 2.4 node units from the float64 run
    (the kernel by 0.09; host rehearsal), which put single particles of
    the float32 comparison beyond tolerance.  ``trip``'s 64 trips in one
    launch equal 64 single-trip launches bit for bit."""
    import torch

    from smcsmc_tpu_torch.kernels.trip import FIELDS, disagreement

    trip, trip_plain = kernels["trip"]
    segment_pass, segment_pass_plain = kernels["segment_pass"]
    for name in (WIDE_TRIP, *WIDE_NAMES.values()):
        tallies.setdefault(name, (Tally(), Tally()))
    ok = True
    for P, n, E in WIDE_SHAPES:
        t0 = time.monotonic()
        bias = ({} if E < 64 else dict(heights=BIAS_CAPS_HEIGHTS,
                                       strengths=BIAS_CAPS_STRENGTHS))
        for ls in (1, 0, -1):
            for T, L, nr_scale in ((1, 20000.0, 1.5), (64, MAX_SEG, 0.1)):
                c = Case(P, n, E, ls, L=L, nr_scale=nr_scale,
                         seed=23 * P + n + E + T + ls)
                u = c.uniforms(T)
                vb = vb_tables(c.demo, T + ls + n)
                runs = {WIDE_TRIP: (c.fresh, c.run, trip, trip_plain, None)}
                for name, fresh, run, tables in (
                        (WIDE_PASS, c.fresh_segment, c.run_segment, None),
                        (WIDE_VB_PASS, c.fresh_segment, c.run_segment, vb),
                        (BIASED_WIDE_PASS,
                         lambda: c.fresh_biased(**bias), c.run_biased,
                         None),
                        (BIASED_WIDE_VB_PASS,
                         lambda: c.fresh_biased(**bias), c.run_biased, vb)):
                    runs[name] = (fresh, run, segment_pass,
                                  segment_pass_plain, tables)
                for name, (fresh, run, fn, plain, tables) in runs.items():
                    if tables is not None and T > 1:
                        continue  # the VB variants at one trip
                    extra = {} if tables is None else dict(vb=tables)
                    got = run(fn, u, fresh(), **extra)
                    d = _in_double(c)
                    ref = getattr(d, run.__name__)(
                        plain, u.double(), _in_double(fresh()),
                        **_in_double(extra))
                    if name != WIDE_TRIP:
                        got, ref = c.segment_result(got), d.segment_result(ref)
                    # the float64 answer as the float32 the kernel stores
                    ref = {k: v.float() if v.dtype == torch.float64 else v
                           for k, v in ref.items()}
                    torch.cuda.synchronize()
                    trees, floats, errs = disagreement(got, ref, c.L, MU,
                                                       RTOL)
                    if T == 1:
                        good = int(trees.sum()) == 0 and int(floats.sum()) == 0
                    else:
                        good = (int((trees | floats).sum())
                                <= (1.0 - MATCH_MIN) * P)
                    tallies[name][T > 1].add(trees, floats, errs)
                    _report(f"{name} P={P} n={n} E={E} leaf_status={ls} "
                            f"trips={T}" + (" vs plain" if T > 1 else ""),
                            P, trees, floats, errs, good)
                    ok &= good
                    if name == WIDE_TRIP and T > 1:
                        seq = c.fresh()
                        for j in range(T):
                            c.run(trip, u[j:j + 1].contiguous(), seq)
                        torch.cuda.synchronize()
                        same = all(torch.equal(got[k], seq[k])
                                   for k in FIELDS)
                        _log(f"compare {WIDE_TRIP} P={P} n={n} E={E} "
                             f"leaf_status={ls} trips=64 vs 64x trips=1: bit "
                             f"for bit {'equal -> ok' if same else 'FAIL'}")
                        ok &= same
        _log(f"compare wide shape P={P} n={n} E={E}: "
             f"{time.monotonic() - t0:.1f} s")
    return ok


def _sync():
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


def arg_ring(P, n, gen, A=ARG_A):
    """An ARG ring in use on ``DEVICE``: ``arg_n`` from 0 to 2A (about
    half the rings wrapped, the first 16 one row short of wrapping), rows
    drawn at random (codes 0-2, populations -1..1, heights up to 5e4,
    positions before ``BIAS_FRONT``, leaves any of n bits)."""
    import torch

    dev = DEVICE
    arg_n = torch.randint(0, 2 * A, (P,), generator=gen, device=dev,
                          dtype=torch.int32)
    arg_n[:16] = A - 1

    def small(lo, hi):
        return torch.randint(lo, hi, (P, A), generator=gen, device=dev,
                             dtype=torch.int32).to(torch.int8)
    return dict(
        arg_pos=BIAS_FRONT * torch.rand((P, A), generator=gen, device=dev),
        arg_code=small(0, 3),
        arg_time=5e4 * torch.rand((P, A), generator=gen, device=dev),
        arg_from=small(-1, 2), arg_to=small(-1, 2),
        arg_desc=torch.randint(0, 1 << min(n, 62), (P, A), generator=gen,
                               device=dev, dtype=torch.int64),
        arg_n=arg_n)


def arg_apart(got, ref, agree, tol, exact_time=False):
    """Where two runs' ARG rings differ: a [P] bool mask of the particles
    whose rings differ in any row (``arg_n``, codes, populations and
    leaves exactly; positions to the positions' tolerance and heights to
    a node height's, or bit for bit with ``exact_time``), and the fields
    that differ on the particles in ``agree``."""
    import torch

    differs = got["arg_n"] != ref["arg_n"]
    fields = ["arg_n"] if bool(differs[agree].any()) else []
    for k in ("arg_code", "arg_from", "arg_to", "arg_desc"):
        bad = (got[k] != ref[k]).any(dim=1)
        differs |= bad
        if bool(bad[agree].any()):
            fields.append(k)
    for k, atol in (("arg_pos", tol["next_rec"]), ("arg_time", tol["time"])):
        a, b = got[k].double(), ref[k].double()
        if exact_time and k == "arg_time":
            bad = (got[k].view(torch.int32) != ref[k].view(torch.int32)
                   ).any(dim=1)
        else:
            bad = ((a - b).abs() > RTOL * b.abs() + atol).any(dim=1)
        differs |= bad
        if bool(bad[agree].any()):
            fields.append(k)
    return differs, fields


def _arg_of(st, front=BIAS_FRONT):
    from smcsmc_tpu_torch.kernels.arg import ARG_FIELDS, ArgPass

    return ArgPass(*(st[k] for k in ARG_FIELDS), front)


def _arg_rows(st, base, code=None):
    """Rows pushed over all particles (the change of ``arg_n``), or those
    of one ``code`` among the newest ``A`` of each particle."""
    import torch

    new = (st["arg_n"] - base["arg_n"]).long()
    if code is None:
        return int(new.sum())
    A = st["arg_code"].shape[1]
    k = torch.arange(A, device=new.device)
    slot = (base["arg_n"].long()[:, None] + k[None, :]) % A
    mine = k[None, :] < new[:, None]
    return int(((st["arg_code"].gather(1, slot) == code) & mine).sum())


def _arg_check(name, label, P, got_st, ref_st, plain_st, result, L, T,
               tallies, exact_time=False, Pp=1, base=None, want_bit63=False):
    """One ARG comparison: the kernel's run ``got_st`` against the plain
    version's ``ref_st`` (``result`` maps a state to what ``disagreement``
    takes), and against the same kernel without ARG (``plain_st``): every
    output but the ring bit for bit.  One trip: no tree mismatch, floats
    within tolerance, rings equal; 64 trips: at most 0.1% of the
    particles apart in trees, floats or rings.  The rows must have been
    pushed; with ``want_bit63`` some row's leaves must reach bit 63."""
    import torch

    from smcsmc_tpu_torch.kernels.arg import ARG_FIELDS
    from smcsmc_tpu_torch.kernels.trip import disagreement, float_tolerances

    tallies.setdefault(name, (Tally(), Tally()))
    got, ref = result(got_st), result(ref_st)
    trees, floats, errs = disagreement(got, ref, L, MU, RTOL, Pp=Pp)
    agree = ~(trees | floats)
    tol = float_tolerances(ref, L, MU, Pp=Pp)
    ring_differs, fields = arg_apart(got_st, ref_st, agree, tol, exact_time)
    base_out = result(plain_st)
    same = [k for k in base_out if not torch.equal(
        got[k].view(torch.int32) if got[k].dtype == torch.float32 else got[k],
        base_out[k].view(torch.int32) if base_out[k].dtype == torch.float32
        else base_out[k])]
    rows = _arg_rows(ref_st, base)
    apart = int((trees | floats | ring_differs).sum())
    if T == 1:
        good = apart == 0
    else:
        good = apart <= (1.0 - MATCH_MIN) * P and not fields
    good &= not same and rows > 0
    bit63 = bool((ref_st["arg_desc"] < 0).any())
    if want_bit63:
        good &= bit63
    tallies[name][T > 1].add(trees, floats, errs)
    _report(f"{name}{label} trips={T}" + (" vs plain" if T > 1 else "")
            + f"; {rows} rows pushed, rings apart {int(ring_differs.sum())}"
            + (f" {fields}" if fields else "")
            + f"; without ARG {'bit for bit' if not same else same}"
            + ("; a row reaches leaf 63" if bit63 else ""),
            P, trees, floats, errs, good)
    return good


def arg_narrow(segment_pass, segment_pass_plain, tallies, P, n, E, ls, T,
               biased, vb, label="", A=ARG_A):
    """One case of :func:`compare_arg`: the plain or the biased pass's ARG
    variant at (P, n, E), leaf status ``ls``, ``T`` trips, with or without
    VB, on a ring of ``A`` slots in use."""
    L, nr_scale = (20000.0, 1.5) if T == 1 else (MAX_SEG, 0.1)
    c = Case(P, n, E, ls, L=L, nr_scale=nr_scale, seed=31 * P + n + E + T + ls)
    u = c.uniforms(T)
    tables = vb_tables(c.demo, T + ls + n) if vb else None
    fresh = c.fresh_biased if biased else c.fresh_segment
    c.aring = arg_ring(P, n, c.gen, A)

    def run(fn, with_arg=True):
        st = fresh()
        st.update({k: v.clone() for k, v in c.aring.items()})
        b = None
        if biased:
            from smcsmc_tpu_torch.kernels.bias import BiasedPass

            b = BiasedPass(st["log_pilot"], st["df_pos"], st["df_logf"],
                           st["df_delta"], st["df_k"], *c.bias_tables,
                           BIAS_FRONT)
        fn(u, c.leaf_status, *(st[k] for k in SEGMENT_STATE),
           st["fifo"], c.fifo_mask, st["tl"], c.L, MU, RHO, c.start,
           c.inv2ne, c.has_data, b, vb=tables,
           arg=_arg_of(st) if with_arg else None)
        return st
    got, ref, base = (run(segment_pass), run(segment_pass_plain),
                      run(segment_pass, False))
    _sync()
    name = BIASED_ARG_PASS if biased else ARG_PASS
    name = vb_name(name) if vb else name
    ring = f" A={A}" if A != ARG_A else ""
    return _arg_check(name, f"{label}{ring} P={P} n={n} E={E} leaf_status="
                      f"{ls}", P, got, ref, base, c.segment_result,
                      c.L, T, tallies, base=c.aring)


def arg_migration(segment_pass, segment_pass_plain, tallies, P, ls, T, vb,
                  caps=False, A=ARG_A, mig_exact=True, m_rows=None):
    """One case of :func:`compare_arg`: the migration pass's ARG variant at
    the twopop shape (P, n=4, E=8, Pp=2, Mw=56) or its caps corner (n=8,
    E=64, Pp=4, Mw=96), leaf status ``ls``, ``T`` trips, with or without
    VB, on a ring of ``A`` slots in use; the M rows pushed are appended to
    ``m_rows``."""
    import torch

    L, nr_scale = (20000.0, 1.5) if T == 1 else (MAX_SEG, 0.1)
    kw = dict(caps=True, m=1e-4, Mw=96) if caps else {}
    c = MigCase(P, ls, L, nr_scale, seed=17 * P + T + ls, **kw)
    u = c.uniforms(T)
    tables = vb_tables(c.demo, T + ls) if vb else None
    aring = arg_ring(P, c.n, c.gen, A)

    def run(fn, with_arg=True):
        st = c.fresh()
        st.update({k: v.clone() for k, v in aring.items()})
        from smcsmc_tpu_torch.kernels.migration import MigrationPass

        mp = MigrationPass(st["pop"], st["mig_time"], st["mig_dest"],
                           st["diag"], c.key, *c.tables)
        fn(u, c.leaf_status, *(st[k] for k in SEGMENT_STATE),
           st["fifo"], c.fifo_mask, st["tl"], c.L, MU, RHO, c.start,
           c.inv2ne, c.has_data, None, mp, vb=tables,
           arg=_arg_of(st) if with_arg else None)
        return st
    got, ref, base = (run(segment_pass), run(segment_pass_plain),
                      run(segment_pass, False))
    _sync()
    exact = all(torch.equal(got[k], ref[k]) for k in MIG_EXACT)
    hops = _arg_rows(ref, aring, code=2)
    if m_rows is not None:
        m_rows.append(hops)
    name = vb_name(MIGRATION_ARG_PASS) if vb else MIGRATION_ARG_PASS
    ring = f" A={A}" if A != ARG_A else ""
    good = _arg_check(name, f"{' caps corner' if caps else ''}{ring} P={P} "
                      f"n={c.n} E={c.E} Pp={c.Pp} Mw={c.Mw} leaf_status="
                      f"{ls} (trees and buffers bit for bit {exact}, "
                      f"{hops} M rows)", P, got, ref, base, c.result,
                      c.L, T, tallies, exact_time=mig_exact, Pp=c.Pp,
                      base=aring)
    return good and (exact or not mig_exact)


def arg_wide(segment_pass, segment_pass_plain, tallies, P, n, ls, T, vb):
    """One case of :func:`compare_arg`: the wide plain pass's ARG variant
    at (P, n, E=9), leaf status ``ls``, ``T`` trips, with or without VB,
    against the plain version in float64."""
    import torch

    L, nr_scale = (20000.0, 1.5) if T == 1 else (MAX_SEG, 0.1)
    c = Case(P, n, 9, ls, L=L, nr_scale=nr_scale, seed=37 * P + n + T + ls)
    u = c.uniforms(T)
    tables = vb_tables(c.demo, T + ls + n) if vb else None
    aring = arg_ring(P, n, c.gen)
    d = _in_double(c)

    def run(case, fn, uu, tbl, dbl=False, with_arg=True):
        st = case.fresh_segment()
        st.update({k: v.clone() for k, v in aring.items()})
        if dbl:
            st = _in_double(st)
        fn(uu, c.leaf_status, *(st[k] for k in SEGMENT_STATE),
           st["fifo"], case.fifo_mask, st["tl"], c.L, MU, RHO,
           case.start, case.inv2ne, c.has_data, vb=tbl,
           arg=_arg_of(st) if with_arg else None)
        return st
    got = run(c, segment_pass, u, tables)
    base = run(c, segment_pass, u, tables, with_arg=False)
    ref = run(d, segment_pass_plain, u.double(), _in_double(tables),
              dbl=True)
    # the float64 answer as the float32 the kernel stores
    ref = {k: v.float() if v.dtype == torch.float64 else v
           for k, v in ref.items()}
    _sync()
    name = vb_name(WIDE_ARG_PASS) if vb else WIDE_ARG_PASS
    return _arg_check(name, f" P={P} n={n} E=9 leaf_status={ls}", P,
                      got, ref, base, c.segment_result, c.L, T, tallies,
                      base=aring, want_bit63=n == 64 and ls == 1)


def arg_cases(P=10000, wide_P=(10001, 1001)):
    """The cases of :func:`compare_arg` in its order: (group, function,
    keyword arguments)."""
    out = []
    for n, E in ((4, 9), (8, 33)):
        for ls in (1, 0, -1):
            for T in (1, 64):
                for biased in (False, True):
                    for vb in (False, True):
                        out.append(("narrow", arg_narrow, dict(
                            P=P, n=n, E=E, ls=ls, T=T, biased=biased,
                            vb=vb)))
    for biased in (False, True):
        out.append(("narrow", arg_narrow, dict(
            P=P + 1, n=8, E=33, ls=1, T=1, biased=biased, vb=False,
            label=" ragged")))
    # rings of fewer slots than a trip's rows: later rows take the slots
    # of earlier ones
    out.append(("narrow", arg_narrow, dict(P=P + 1, n=4, E=9, ls=1, T=64,
                                           biased=False, vb=False, A=1)))
    out.append(("narrow", arg_narrow, dict(P=P + 1, n=8, E=33, ls=1, T=64,
                                           biased=True, vb=False, A=3)))
    for ls in (1, 0, -1):
        for T in (1, 64):
            for vb in (False, True):
                out.append(("migration", arg_migration, dict(
                    P=P, ls=ls, T=T, vb=vb)))
    for T in (1, 64):
        out.append(("migration", arg_migration, dict(P=P + 1, ls=1, T=T,
                                                     vb=False, caps=True)))
    out.append(("migration", arg_migration, dict(P=P + 1, ls=1, T=64,
                                                 vb=False, A=3)))
    out.append(("migration", arg_migration, dict(P=P + 1, ls=1, T=1,
                                                 vb=True, A=1)))
    for ls in (1, 0, -1):
        for T in (1, 64):
            for vb in (False, True):
                out.append(("wide", arg_wide, dict(P=wide_P[0], n=16, ls=ls,
                                                   T=T, vb=vb)))
    for T in (1, 64):
        for vb in (False, True):
            out.append(("wide", arg_wide, dict(P=wide_P[1], n=64, ls=1, T=T,
                                               vb=vb)))
    return out


def compare_arg(segment_pass, segment_pass_plain, tallies, P=10000,
                wide_P=(10001, 1001), mig_exact=True):
    """The ARG variants against their plain versions on identical inputs
    and a ring in use (:func:`arg_ring`, about half the rings wrapped):
    the plain and the biased pass at the main shape (P, n=4, E=9) and the
    genome shape (P, n=8, E=33), once at P + 1 (a ragged last block); the
    migration pass at the twopop shape (P, n=4, E=8, Pp=2, Mw=56) and at
    its caps corner (P + 1, n=8, E=64, Pp=4, Mw=96); the wide plain pass
    at (wide_P[0], n=16, E=9) and (wide_P[1], n=64, E=9), against the
    plain version in float64; each at leaf status 1, 0 and -1, one trip
    and 64, VB off and on (at n=64 and the caps corners leaf status 1);
    and the narrow and migration passes on rings of 1 and 3 slots, fewer
    than a trip's rows (:func:`arg_cases`).  See :func:`_arg_check` for
    what must hold; the migration pass's trees, buffers and the rings'
    heights bit for bit, as ``MIG_EXACT`` (within tolerance without
    ``mig_exact``: a host build's ``log1pf`` is not the card's, so its
    walk times part in the last bit)."""
    ok = True
    m_rows = []
    t0, group = time.monotonic(), "narrow"
    for kind, fn, kw in arg_cases(P, wide_P) + [("end", None, None)]:
        if kind != group:
            _log(f"compare ARG {group}: {time.monotonic() - t0:.1f} s"
                 + (f", {sum(m_rows)} M rows pushed"
                    if group == "migration" else ""))
            t0, group = time.monotonic(), kind
        if fn is None:
            break
        if kind == "migration":
            kw = dict(kw, mig_exact=mig_exact, m_rows=m_rows)
        ok &= fn(segment_pass, segment_pass_plain, tallies, **kw)
    return ok and sum(m_rows) > 0


def vb_cases():
    """The VB variants' cases: (pass, label, shape or MigCase arguments,
    leaf status): the main path's shape and the genome path's for the plain
    pass, the genome path's for the biased pass and the twopop path's for
    the migration pass, each at its kernel's caps too."""
    return ([(VB_PASS, "", (10000, 4, 9), ls) for ls in (1, 0, -1)]
            + [(VB_PASS, "", (GENOME_P, 8, 33), 1),
               (VB_PASS, " caps", (CAPS_P, 8, 64), 1)]
            + [(BIASED_VB_PASS, "", (GENOME_P, 8, 33), ls)
               for ls in (1, 0, -1)]
            + [(BIASED_VB_PASS, " caps corner (8 sections)", (CAPS_P, 8, 64),
                1)]
            + [(MIGRATION_VB_PASS, " twopop", {}, ls) for ls in (1, 0, -1)]
            + [(MIGRATION_VB_PASS, " caps corner",
                {"caps": True, "m": 1e-4, "Mw": 96, "P": CAPS_P}, 1)])


def compare_vb(segment_pass, segment_pass_plain, tallies):
    """The VB variant of each pass against its plain version with VB on
    identical inputs, VB tables from small counts (:func:`vb_tables`): one
    trip in every case, with no tree mismatch and every float within
    tolerance (``log_w`` and ``log_pilot`` by ``float_tolerances``); 64
    trips at the paths' shapes (not at the caps) with, as for the passes
    without VB, at most 0.1% of the particles apart; the migration pass's
    trees and buffers bit for bit.  At one trip the VB terms must move
    ``log_w`` away from the plain version without VB."""
    import torch

    from smcsmc_tpu_torch.kernels.trip import disagreement

    for name in (VB_PASS, BIASED_VB_PASS, MIGRATION_VB_PASS):
        tallies[name] = (Tally(), Tally())
    ok = True
    for name, label, shape, ls in vb_cases():
        trip_counts = ((1, 20000.0, 1.5),) + (
            ((64, MAX_SEG, 0.1),) if "caps" not in label else ())
        for T, L, nr_scale in trip_counts:
            # the plain version without VB, at one trip: the terms moved
            # log_w
            runs = ((segment_pass, True), (segment_pass_plain, True)) + (
                ((segment_pass_plain, False),) if T == 1 else ())
            if name == MIGRATION_VB_PASS:
                kw = dict(shape)
                P = kw.pop("P", TWOPOP_P)
                c = MigCase(P, ls, L, nr_scale, seed=17 * P + T + ls, **kw)
                vb = vb_tables(c.demo, T + ls)
                u = c.uniforms(T)
                got, ref, *off = (c.result(c.run(fn, u, c.fresh(),
                                                 vb if on else None))
                                  for fn, on in runs)
                extra = dict(Pp=c.Pp)
                exact = all(torch.equal(got[k], ref[k]) for k in MIG_EXACT)
            else:
                P, n, E = shape
                c = Case(P, n, E, ls, L=L, nr_scale=nr_scale,
                         seed=19 * P + T + ls + len(label))
                vb = vb_tables(c.demo, T + ls)
                u = c.uniforms(T)
                if name == VB_PASS:
                    fresh, run = c.fresh_segment, c.run_segment
                else:
                    ring = ({} if not label else dict(
                        heights=BIAS_CAPS_HEIGHTS,
                        strengths=BIAS_CAPS_STRENGTHS))
                    fresh = (lambda ring=ring: c.fresh_biased(**ring))
                    run = c.run_biased
                got, ref, *off = (c.segment_result(run(
                    fn, u, fresh(), vb if on else None)) for fn, on in runs)
                extra, exact = {}, True
            torch.cuda.synchronize()
            trees, floats, errs = disagreement(got, ref, c.L, MU, RTOL,
                                               **extra)
            if T == 1:
                moved = float((ref["log_w"] - off[0]["log_w"]).abs().max())
                good = (int(trees.sum()) == 0 and int(floats.sum()) == 0
                        and moved > 1e-3)
                shown = f"the VB terms move log_w by up to {moved:.4g}"
            else:
                good = int((trees | floats).sum()) <= (1.0 - MATCH_MIN) * P
                shown = "vs plain"
            good &= exact
            tallies[name][T > 1].add(trees, floats, errs)
            _report(f"{name}{label} P={P} n={c.n} E={c.E} leaf_status={ls} "
                    f"trips={T} ({shown}"
                    + (f"; trees and buffers bit for bit {exact}"
                       if name == MIGRATION_VB_PASS else "") + ")",
                    P, trees, floats, errs, good)
            ok &= good
    return ok


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _device_ms(launch, states, filler):
    """Device time per launch: CUDA events around one launch per state,
    queued behind ``filler`` (a few ms of device work) so that every launch
    is enqueued before the first one starts."""
    import torch

    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    filler()
    t0.record()
    for st in states:
        launch(st)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / len(states)


def _host_us(launch, states):
    """The host's time per wrapper call, no synchronise inside."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for st in states:
        launch(st)
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / len(states) * 1e6


def _bounds(c, active, trips, pushed, moved=0):
    """Least time (ms) the card could take for one launch of each entry
    point with ``active`` recombining particles, ``trips`` trips in all and
    ``pushed`` statistics that are not zero after the gate: bytes the
    function must move (each input read once, each output written once)
    over the memory rate, and its float operations over the float32 rate;
    the larger bounds it.  For the biased pass also ``moved`` ring slots
    that changed (pushed or applied)."""
    P, N, E = c.P, 2 * c.n - 1, c.E
    S, D = len(BIAS_STRENGTHS), BIAS_SLOTS
    tree = 4 * N * 4  # time, parent, child0, child1 rows
    tables = 4 * 2 * E + c.n  # epoch_start, inv2ne, has_data
    # a trip: (epoch x node) overlaps for the hazard mass and the refreshed
    # summaries (4 operations each), the node-time candidates (N x N x 5),
    # the O(N) scans and the per-epoch records
    flop_trip = 2 * E * N * 4 + N * N * 5 + 20 * N + 12 * E
    nbytes = {
        # every particle reads next_rec; an active one reads and writes its
        # tree, tl_e, pending and five scalars, and reads 16 B per trip
        "trip": tables + 4 * P
        + active * 2 * (tree + 4 * E + 4 * 6 * E + 5 * 4) + 16 * trips,
        # every particle reads its tree, reads and writes next_rec and
        # log_w and writes tl; an active one writes its tree and reads 16 B
        # per trip.  Of the FIFO only slot 0's entries that take a nonzero
        # statistic are read and written: a particle that does not
        # recombine has its recombination opportunity alone, in the epochs
        # its tree reaches and the gate leaves open
        "segment_pass": tables + 4 * 6 * E + P * (tree + 2 * 4 + 2 * 4 + 4)
        + active * tree + 16 * trips + 2 * 4 * pushed,
    }
    flop = {"trip": trips * flop_trip,
            "segment_pass": trips * flop_trip + P * E * N * 4 + 2 * pushed}
    # the biased pass besides: the section table and the delays; every
    # particle reads and writes its pilot weight and reads the positions of
    # its ring (to find what is due and what is free); a slot that changed
    # has its other three words read and all four written.  A trip weighs
    # the N x S segments twice (about 6 operations each)
    nbytes[BIASED_PASS] = (nbytes["segment_pass"] + 4 * (2 * S + 1 + E)
                      + P * (2 * 4 + 4 * D) + moved * (3 + 4) * 4)
    flop[BIASED_PASS] = (flop["segment_pass"] + trips * 2 * N * S * 6
                         + P * D * 2)
    out = {}
    for name in nbytes:
        by_bytes = nbytes[name] / HBM_BYTES_PER_S * 1e3
        by_ops = flop[name] / F32_FLOP_PER_S * 1e3
        out[name] = dict(bound_ms=max(by_bytes, by_ops),
                         bound_by="bytes" if by_bytes >= by_ops
                         else "operations", bytes=nbytes[name],
                         flop=flop[name])
    return out


def _timing_case(P, n, E, L):
    """A case as a segment of length L finds it: next recombination drawn
    as at a segment start, Exp(1)/(rho*tl); and uniforms for 64 trips."""
    import torch

    c = Case(P, n, E, 1, L=L, nr_scale=0.0, seed=99)
    expo = torch.empty(P, device="cuda").exponential_(1.0, generator=c.gen)
    c.base["next_rec"] = (expo / (RHO * c.base["tl"])).contiguous()
    return c, c.uniforms(64)


def _best_device_ms(launch, fresh, filler):
    """Best of 3 runs of 20 launches, each on a fresh state."""
    launch(fresh())  # warm-up
    return min(_device_ms(launch, [fresh() for _ in range(20)], filler)
               for _ in range(3))


def _plain_ms(run, plain, u, fresh):
    """Median of 3 runs of the plain version, CUDA events."""
    import torch

    times = []
    for _ in range(3):
        st = fresh()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0.record()
        run(plain, u, st)
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return _median(times)


def _filler():
    """A few ms of device work to queue timed launches behind."""
    import torch

    a = torch.rand((4096, 4096), device="cuda")
    return lambda: torch.mm(a, a)


def time_empty_launch():
    """Device time (ms) of a launch that does nothing."""
    import torch

    from smcsmc_tpu_torch.kernels._build import load_trip_library

    lib = load_trip_library()

    def noop(_):
        err = lib.smc_noop_launch(torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise SystemExit(f"empty launch failed: CUDA error {err}")

    noop(None)  # the first launch loads the module
    empty_ms = _device_ms(noop, range(200), _filler())
    _log(f"time empty launch: {empty_ms * 1e3:.2f} us of device time each "
         f"(200 back to back)")
    return empty_ms


def _bound_of(nbytes, flop):
    """The bound of work that moves ``nbytes`` and does ``flop``."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flop / F32_FLOP_PER_S * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bytes=nbytes, flop=flop)


def _with_vb(bound, E, Pp, trips):
    """A pass's bound with VB besides: its tables read (E Pp + E Pp Pp
    words) and one addition per trip."""
    return _bound_of(bound["bytes"] + 4 * (E * Pp + E * Pp * Pp),
                     bound["flop"] + trips)


def _guide_bound(bound, c, active, trips, name):
    """A guided or local pass's bound: its parent's (at this variant's
    trips) plus, under the guide, per trip the mass table's search (15
    entries), four mass lookups (two words each) and the n leaf rates read,
    the branch rates merged and ranked and the segments weighed once more;
    with local recording the lags, per recombining particle its ring's
    positions read, per trip an event written (20 B) and the cut branch's
    leaves found, and every particle's opportunity written."""
    (_, guide, local), _ = GUIDE_PASSES[name]
    N, E, n, S = 2 * c.n - 1, c.E, c.n, len(BIAS_STRENGTHS)
    nbytes, flop = bound["bytes"], bound["flop"]
    if guide:
        nbytes += trips * 4 * (15 + 8 + n)
        flop += trips * (3 * n + n * n + 2 * N * S + 40)
    if local:
        nbytes += 4 * E + active * 4 * LOCAL_SLOTS + trips * 20 + 4 * c.P
        flop += trips * (N + 10) + c.P * E
    return _bound_of(nbytes, flop)


def phase_time(kernels, shape, seg_lengths, biased=False, vb=False,
               guide=False, names=None):
    """Times of both entry points (and, with ``biased``, of the biased
    pass; with ``vb``, of the VB variant of the segment pass and, with
    ``biased`` too, of the biased one, without the trip ladder, on the
    first segment length alone; with ``guide`` (and ``biased``), of the
    guided and local passes without the ladder, their VB variants on the
    first segment length alone, on a guide that is not constant and a ring
    30% in use) at ``shape`` (P, n, E) for each (label, segment length);
    see the module docstring.  ``names`` renames the entries in the rows
    and the log (the wide kernels: :data:`WIDE_NAMES`)."""
    P, n, E = shape
    filler = _filler()
    rows = {}
    for label, L in seg_lengths:
        c, u = _timing_case(P, n, E, L)
        # counted work: a trip adds one recombination count to one epoch;
        # FIFO slot 0 starts empty, so what is not zero in it afterwards is
        # what the segment pass had to push
        st = c.run(kernels["trip"][0], u, c.fresh())
        per_particle = st["pending"][:, 5 * c.E:].sum(dim=1)
        active = int((c.base["next_rec"] < L).sum())
        trips = int(round(float(per_particle.sum())))
        st = c.run_segment(kernels["segment_pass"][0], u, c.fresh_segment())
        pushed = int((st["fifo"][:, 0] != 0).sum())
        makers = {"trip": (c.fresh, c.run),
                  "segment_pass": (c.fresh_segment, c.run_segment)}
        entries = [(name, kernel, plain) for name, (kernel, plain)
                   in kernels.items()]
        moved = 0
        if biased:
            makers[BIASED_PASS] = (c.fresh_biased, c.run_biased)
            entries.append((BIASED_PASS, *kernels["segment_pass"]))
            st = c.run_biased(kernels["segment_pass"][0], u, c.fresh_biased())
            moved = int(sum((st[k] != c.ring[k]) for k in (
                "df_pos", "df_logf", "df_delta", "df_k")).gt(0).sum())
        bounds = _bounds(c, active, trips, pushed, moved)
        if guide:
            # counted work of each guided and local pass on this run's
            # inputs: its trips (a local pass pushes or drops one event per
            # trip; the guided pass takes the guided local pass's trips),
            # the statistics it pushes and the ring slots it changes
            counted = {}
            for name in (GUIDE_LOCAL_PASS, GUIDE_PASS, BIASED_LOCAL_PASS,
                         LOCAL_PASS):
                (b_, _, local), parent = GUIDE_PASSES[name]
                st = _run_new(c, kernels["segment_pass"][0], u,
                              _fresh_new(c, name), name)
                n_trips = (int((st["lr_pos"] != c.lring["lr_pos"]).sum())
                           + int(st["lr_dropped"]) if local
                           else counted[GUIDE_LOCAL_PASS])
                counted[name] = n_trips
                mv = (int(sum((st[k] != c.ring[k]) for k in (
                    "df_pos", "df_logf", "df_delta", "df_k")).gt(0).sum())
                    if b_ else 0)
                base = _bounds(c, active, n_trips,
                               int((st["fifo"][:, 0] != 0).sum()),
                               mv)[BIASED_PASS if b_ else "segment_pass"]
                bounds[name] = _guide_bound(base, c, active, n_trips, name)
                makers[name] = (lambda name=name: _fresh_new(c, name),
                                lambda fn, u, st, name=name:
                                _run_new(c, fn, u, st, name))
                entries.append((name, *kernels["segment_pass"]))
                if vb and label == seg_lengths[0][0]:
                    tables = vb_tables(c.demo, 5)
                    vname = vb_name(name)
                    makers[vname] = (makers[name][0],
                                     lambda fn, u, st, name=name, t=tables:
                                     _run_new(c, fn, u, st, name, t))
                    entries.append((vname, *kernels["segment_pass"]))
                    bounds[vname] = _with_vb(bounds[name], E, 1, n_trips)
            _log(f"time {label}: trips of the guided and local passes "
                 f"{counted}")
        if vb and label == seg_lengths[0][0]:  # the mean segment only
            tables = vb_tables(c.demo, 5)
            vb_entries = [(VB_PASS, "segment_pass")] + (
                [(BIASED_VB_PASS, BIASED_PASS)] if biased else [])
            for name, base in vb_entries:
                fresh, run = makers[base]
                makers[name] = (fresh, lambda fn, u, st, run=run:
                                run(fn, u, st, vb=tables))
                entries.append((name, *kernels["segment_pass"]))
                bounds[name] = _with_vb(bounds[base], E, 1, trips)
        _log(f"time {label} (P={P} n={n} E={E}, L={L:g} bp): {active} of "
             f"{c.P} particles "
             f"recombine, {trips} trips in all, at most "
             f"{int(per_particle.max())} in one particle; {pushed} of "
             f"{c.P * 6 * c.E} statistics are not zero after the gate"
             + (f"; the biased pass changes {moved} of "
                f"{c.P * BIAS_SLOTS} ring slots" if biased else ""))
        rows[label] = {"L": L, "active": active, "trips": trips,
                       "pushed": pushed, "moved": moved}
        for name, kernel, plain in entries:
            fresh, run = makers[name]

            def launch(st, fn=kernel, run=run, u=u):
                run(fn, u, st)

            def idle(fresh=fresh):
                st = fresh()
                st["next_rec"] += 1e9  # nobody recombines
                return st

            # what a launch costs before any trip, and per trip allowed
            ladder = {}
            if name not in (VB_PASS, BIASED_VB_PASS) \
                    and name not in GUIDE_PASSES:
                ladder["no trips"] = _best_device_ms(launch, idle, filler)
                for T in (1, 2, 4):
                    ladder[f"trips<={T}"] = _best_device_ms(
                        lambda st, ut=u[:T].contiguous(), run=run,
                        kernel=kernel: run(kernel, ut, st), fresh, filler)
            t = dict(kernel_ms=_best_device_ms(launch, fresh, filler),
                     ladder=ladder, plain_ms=_plain_ms(run, plain, u, fresh),
                     host_us=_host_us(launch, [fresh() for _ in range(200)]),
                     **bounds[name])
            shown = (names or {}).get(name, name)
            rows[label][shown] = t
            _log(f"time {shown} {label}: kernel {t['kernel_ms'] * 1e3:.2f} us "
                 f"of device time per launch (best of 3 x 20 launches; "
                 + ", ".join(f"{k} {x * 1e3:.2f} us"
                             for k, x in ladder.items())
                 + f"); host {t['host_us']:.2f} us per wrapper call; plain "
                 f"{t['plain_ms']:.4f} ms (median of 3); bound "
                 f"{t['bound_ms'] * 1e3:.3f} us by {t['bound_by']} "
                 f"({t['bytes']} B, {t['flop']} FLOP), kernel reaches "
                 f"{t['bound_ms'] / t['kernel_ms']:.4f} of it")
    return rows


def _mig_bounds(c, active, trips, events, valid, rows, pushed):
    """Least time (ms) of one migration pass: bytes over the memory rate,
    operations over the float32 rate, the larger.  Bytes: the tables; every
    particle reads its tree with populations (5 rows of N words), reads
    and writes next_rec and log_w and writes tl; an active particle writes
    its tree back, reads 16 B of uniforms per trip and the ``valid`` buffer
    events it walks through (time and destination, 8 B each: every event
    of the branches it reads, once); ``rows`` buffer rows that changed are
    written whole (Mw events of 8 B); of the FIFO only slot 0's entries
    that take a nonzero statistic are read and written.  Operations: per
    walk event the Philox draw (about 100 integer operations), the scan
    over N branches (cursor, population, crossing, breakpoint: about 12
    each) and the epoch's tables (2 E); per trip the point and the SPR's
    routing (about 40 Mw), the refreshed summaries (8 E N); at entry the
    summaries of every tree (4 E N)."""
    P, N, E, Pp, Mw = c.P, 2 * c.n - 1, c.E, 2, c.Mw
    tables = 4 * (E + E * Pp * (3 + Pp) + c.K) + c.n
    nbytes = (tables + P * (5 * N * 4 + 2 * 2 * 4 + 4)
              + active * 5 * N * 4 + 16 * trips + 8 * valid
              + rows * Mw * 8 + 2 * 4 * pushed)
    flop = (events * (100 + 12 * N + 2 * E) + trips * (40 * Mw + 8 * E * N)
            + P * 4 * E * N + 2 * pushed)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flop / F32_FLOP_PER_S * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bytes=nbytes, flop=flop)


def _mig_timing_case(P, L):
    """A migration case as a segment of length L finds it (next
    recombination Exp(1)/(rho*tl), as at a segment start), and uniforms for
    64 trips."""
    import torch

    from smcsmc_tpu_torch.kernels.tree import Trees, tree_summaries

    c = MigCase(P, 1, L, 0.0, seed=99)
    b = c.base
    tl, _, _ = tree_summaries(
        Trees(b["parent"], b["time"], b["child0"], b["child1"]),
        c.epochs, 1, c.has_data)
    expo = torch.empty(P, device=DEVICE).exponential_(1.0, generator=c.gen)
    b["next_rec"] = (expo / (RHO * tl)).contiguous()
    return c, c.uniforms(64)


def phase_time_migration(kernel, plain, seg_lengths, P=TWOPOP_P, vb=False):
    """The migration pass at the two-population path's shape (P, n=4, E=8,
    Pp=2, Mw=56) for each (label, segment length): device time per launch
    (best of 3 x 20 launches), host time per wrapper call, the plain
    version (median of 3), the bound from the counted work and the walks'
    length in events (counted on the plain version's run, which draws the
    kernel's numbers); the kernel's outputs held to the plain version's
    as in :func:`compare_migration`.  With ``vb`` the VB variant too, on
    the first segment length (under the key ``"vb"`` of its row), its
    outputs held to the plain version's with VB within tolerance."""
    import torch

    import smcsmc_tpu_torch.kernels.migration as mig_mod
    from smcsmc_tpu_torch.kernels.migration import stats_offsets
    from smcsmc_tpu_torch.kernels.tree import INF
    from smcsmc_tpu_torch.kernels.trip import disagreement

    filler = _filler()
    rows_out = {}
    for label, L in seg_lengths:
        c, u = _mig_timing_case(P, L)
        b = c.base
        seen, walk = [], mig_mod.walk_mig

        def counting(*a, **k):
            out = walk(*a, **k)
            seen.append(out[8][a[6]])
            return out

        mig_mod.walk_mig = counting
        try:
            ref = c.run(plain, u, c.fresh())
        finally:
            mig_mod.walk_mig = walk
        per_walk = torch.cat(seen) if seen else torch.zeros(0)
        st = c.run(kernel, u, c.fresh())
        torch.cuda.synchronize()
        got_r, ref_r = c.result(st), c.result(ref)
        trees_d, floats_d, errs = disagreement(got_r, ref_r, L, MU, RTOL,
                                               Pp=2)
        exact = all(torch.equal(got_r[k], ref_r[k]) for k in MIG_EXACT)
        good = (int((trees_d | floats_d).sum()) == 0 and exact
                and torch.equal(st["diag"], ref["diag"]))
        _report(f"{MIGRATION_PASS} timed launch P={P} L={L:g} trips=64 vs "
                f"plain (trees and buffers bit for bit {exact})", P,
                trees_d, floats_d, errs, good)
        if not good:
            raise SystemExit("the timed migration pass disagrees with its "
                             "plain version")
        act = b["next_rec"] < L
        active = int(act.sum())
        off = stats_offsets(c.E, 2)["recomb_cnt"]
        trips = int(round(float(st["fifo"][:, 0, off:].sum())))
        valid = int((b["mig_time"][act] < INF).sum())
        changed = int(((st["mig_time"] != b["mig_time"])
                       | (st["mig_dest"] != b["mig_dest"])).any(dim=2).sum())
        pushed = int((st["fifo"][:, 0] != 0).sum())
        events = int(per_walk.sum())
        bound = _mig_bounds(c, active, trips, events, valid, changed, pushed)

        def launch(st, u=u, c=c):
            c.run(kernel, u, st)

        t = dict(kernel_ms=_best_device_ms(launch, c.fresh, filler),
                 plain_ms=_plain_ms(c.run, plain, u, c.fresh),
                 host_us=_host_us(launch, [c.fresh() for _ in range(100)]),
                 active=active, trips=trips, walks=int(per_walk.numel()),
                 walk_events=events,
                 events_per_walk_mean=(events / max(per_walk.numel(), 1)),
                 events_per_walk_max=int(per_walk.max()) if per_walk.numel()
                 else 0, valid_events_read=valid, rows_changed=changed,
                 pushed=pushed, L=L, **bound)
        rows_out[label] = t
        if vb and label == seg_lengths[0][0]:  # the mean segment only
            tables = vb_tables(c.demo, 5)
            got_r = c.result(c.run(kernel, u, c.fresh(), tables))
            ref_r = c.result(c.run(plain, u, c.fresh(), tables))
            trees_d, floats_d, errs = disagreement(got_r, ref_r, L, MU, RTOL,
                                                   Pp=2)
            good = int((trees_d | floats_d).sum()) <= (1.0 - MATCH_MIN) * P
            _report(f"{MIGRATION_VB_PASS} timed launch P={P} L={L:g} "
                    f"trips=64 vs plain", P, trees_d, floats_d, errs, good)
            if not good:
                raise SystemExit("the timed migration pass with VB "
                                 "disagrees with its plain version")

            def launch_vb(st, u=u, c=c, tables=tables):
                c.run(kernel, u, st, tables)

            t["vb"] = dict(
                kernel_ms=_best_device_ms(launch_vb, c.fresh, filler),
                plain_ms=_plain_ms(lambda fn, u, st: c.run(fn, u, st,
                                                           tables),
                                   plain, u, c.fresh),
                host_us=_host_us(launch_vb, [c.fresh() for _ in range(100)]),
                **_with_vb(bound, c.E, 2, trips))
            _log(f"time {MIGRATION_VB_PASS} {label}: kernel "
                 f"{t['vb']['kernel_ms'] * 1e3:.2f} us of device time per "
                 f"launch (best of 3 x 20 launches; without VB "
                 f"{t['kernel_ms'] * 1e3:.2f} us); host "
                 f"{t['vb']['host_us']:.2f} us per wrapper call; plain "
                 f"{t['vb']['plain_ms']:.4f} ms; bound "
                 f"{t['vb']['bound_ms'] * 1e3:.3f} us by "
                 f"{t['vb']['bound_by']}")
        _log(f"time {MIGRATION_PASS} {label} (P={P} n=4 E=8 Pp=2 "
             f"Mw={c.Mw}, L={L:g} bp): {active} of {P} particles recombine, "
             f"{trips} trips, {t['walks']} walks of "
             f"{t['events_per_walk_mean']:.2f} events on average and "
             f"{t['events_per_walk_max']} at "
             f"most; {valid} buffer events read, {changed} buffer rows "
             f"changed, {pushed} statistics pushed; kernel "
             f"{t['kernel_ms'] * 1e3:.2f} us of device time per launch (best "
             f"of 3 x 20 launches); host {t['host_us']:.2f} us per wrapper "
             f"call; plain {t['plain_ms']:.4f} ms (median of 3); bound "
             f"{t['bound_ms'] * 1e3:.3f} us by {t['bound_by']} "
             f"({t['bytes']} B, {t['flop']} operations), kernel reaches "
             f"{t['bound_ms'] / t['kernel_ms']:.4f} of it")
    return rows_out


def _mig_proposal_bound(bound, c, name, active, trips, slots_changed):
    """A proposal variant's bound: the migration pass's (:func:`_mig_bounds`
    at this variant's own trips and walk events) plus, under bias, the
    section table and the delays, every particle's pilot weight read and
    written and its ring's positions read (what is due and what is free),
    a ring slot that changed its other three words read and all four
    written, and per trip the N x S segments weighed and summed (about 6
    operations each); under the guide per trip the mass table's search
    (15 entries), four mass lookups (two words each) and the n leaf rates
    read, the branch rates merged and ranked and the segments weighed once
    more; with local recording the lags, per recombining particle its
    ring's positions read, per trip an event written (20 B) and the cut
    branch's leaves found, and every particle's opportunity written; with
    VB its tables and one addition per trip."""
    biased, guide, local = MIG_PROPOSAL_PASSES[name]
    N, E, n, P = 2 * c.n - 1, c.E, c.n, c.P
    S, D = len(BIAS_STRENGTHS), BIAS_SLOTS
    nbytes, flop = bound["bytes"], bound["flop"]
    if biased:
        nbytes += (4 * (2 * S + 1 + E) + P * (2 * 4 + 4 * D)
                   + slots_changed * (3 + 4) * 4)
        flop += trips * N * S * 6 + P * D * 2
    if guide:
        nbytes += trips * 4 * (15 + 8 + n)
        flop += trips * (3 * n + n * n + 2 * N * S + 40)
    if local:
        nbytes += 4 * E + active * 4 * LOCAL_SLOTS + trips * 20 + 4 * P
        flop += trips * (N + 10) + P * E
    out = _bound_of(nbytes, flop)
    return _with_vb(out, E, c.Pp, trips) if "vb" in name else out


def _walk_events(plain, c, u, flags):
    """Events per walk [walks] of a proposal variant (``flags``; delay
    ``migr``, the guide's rates constant over ``GUIDE_CHAIN_ROWS`` windows)
    on case ``c``, counted on the plain version, which draws the kernel's
    numbers."""
    import torch

    import smcsmc_tpu_torch.kernels.migration as mig_mod

    seen, walk = [], mig_mod.walk_mig

    def counting(*a, **k):
        out = walk(*a, **k)
        seen.append(out[8][a[6]])
        return out

    mig_mod.walk_mig = counting
    try:
        c.run_proposal(plain, u, c.fresh_proposal(flags), flags, None,
                       "migr" if flags[0] else "recomb", GUIDE_CHAIN_ROWS)
    finally:
        mig_mod.walk_mig = walk
    return torch.cat(seen) if seen else torch.zeros(0)


def phase_time_mig_proposal(kernel, plain, seg_lengths, uniform_walks,
                            P=TWOPOP_P):
    """Each proposal variant of the migration pass at the two-population
    path's shape (P, n=4, E=8, Pp=2, Mw=56; 2 sections, the delay keyed
    by -delay_migr, rings 30% in use, the guide's rates constant over
    ``GUIDE_CHAIN_ROWS`` windows) for each (label, segment length), in
    turns with the migration pass without the proposal (its VB variant
    beside a VB variant) on the same inputs: parent, variant, variant,
    parent, each the best of 3 x 20 launches; the host's time per wrapper
    call; on the first length the plain version (one run, CUDA events),
    its outputs held to the kernel's as :func:`mig_proposal_one` holds
    them; the bound from counted work (:func:`_mig_proposal_bound`), the
    walks' events counted on the plain versions of the biased and guided
    points and, for the uniform point, taken from ``uniform_walks``
    ({label: (walks, events)} of :func:`phase_time_migration`'s run on the
    same inputs); a variant's walks are those of its point (VB and local
    recording change no walk).  Returns {label: {pass: row}}."""
    import torch

    from smcsmc_tpu_torch.kernels.tree import INF
    from smcsmc_tpu_torch.kernels.trip import disagreement

    filler = _filler()
    rows_out = {}
    for li, (label, L) in enumerate(seg_lengths):
        c, u = _mig_timing_case(P, L)
        b = c.base
        act = b["next_rec"] < L
        active = int(act.sum())
        valid = int((b["mig_time"][act] < INF).sum())
        walks = {"uniform": uniform_walks[label]}
        for kind, flags in (("biased", MIG_PROPOSAL_PASSES[MIG_BIASED_PASS]),
                            ("guided", MIG_PROPOSAL_PASSES[MIG_GUIDE_PASS])):
            per_walk = _walk_events(plain, c, u, flags)
            walks[kind] = (int(per_walk.numel()), int(per_walk.sum()))
        row = {}
        for name, flags in MIG_PROPOSAL_PASSES.items():
            biased, guide, local = flags
            vb = vb_tables(c.demo, 5) if "vb" in name else None
            delay = "migr" if biased else "recomb"
            trips, events = walks["guided" if guide else "biased" if biased
                                  else "uniform"]

            def launch(st, c=c, u=u, flags=flags, vb=vb, delay=delay):
                c.run_proposal(kernel, u, st, flags, vb, delay,
                               GUIDE_CHAIN_ROWS)

            def parent(st, c=c, u=u, vb=vb):
                c.run(kernel, u, st, vb)

            def fresh(c=c, flags=flags):
                return c.fresh_proposal(flags)

            turns = [_best_device_ms(f, fr, filler) for f, fr in (
                (parent, c.fresh), (launch, fresh), (launch, fresh),
                (parent, c.fresh))]
            st = fresh()
            launch(st)
            torch.cuda.synchronize()
            changed = int(((st["mig_time"] != b["mig_time"])
                           | (st["mig_dest"] != b["mig_dest"])).any(
                               dim=2).sum())
            pushed = int((st["fifo"][:, 0] != 0).sum())
            slots = (int(((st["df_pos"] != c.pring["df_pos"])
                          | (st["df_k"] != c.pring["df_k"])).sum())
                     if biased else 0)
            bound = _mig_proposal_bound(
                _mig_bounds(c, active, trips, events, valid, changed,
                            pushed), c, name, active, trips, slots)
            t = dict(kernel_ms=min(turns[1:3]), parent_ms=min(turns[0],
                                                               turns[3]),
                     turns_ms=turns,
                     host_us=_host_us(launch, [fresh() for _ in range(50)]),
                     active=active, trips=trips, walk_events=events,
                     valid_events_read=valid, rows_changed=changed,
                     pushed=pushed, slots_changed=slots, L=L, **bound)
            if li == 0:
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                ref = fresh()
                torch.cuda.synchronize()
                t0.record()
                c.run_proposal(plain, u, ref, flags, vb, delay,
                               GUIDE_CHAIN_ROWS)
                t1.record()
                torch.cuda.synchronize()
                t["plain_ms"] = t0.elapsed_time(t1)
                got_r, ref_r = c.result(st), c.result(ref)
                trees_d, floats_d, errs = disagreement(got_r, ref_r, L, MU,
                                                       RTOL, Pp=2)
                exact = all(torch.equal(got_r[k], ref_r[k])
                            for k in MIG_EXACT)
                good = (int((trees_d | floats_d).sum()) == 0 and exact
                        and torch.equal(st["diag"], ref["diag"]))
                if local:
                    good &= bool(torch.equal(st["lr_desc"], ref["lr_desc"])
                                 and torch.equal(st["lr_dropped"],
                                                 ref["lr_dropped"]))
                _report(f"{name} timed launch P={P} L={L:g} trips=64 vs "
                        f"plain (trees and buffers bit for bit {exact})", P,
                        trees_d, floats_d, errs, good)
                if not good:
                    raise SystemExit(f"the timed {name} disagrees with its "
                                     "plain version")
            row[name] = t
            _log(f"time {name} {label} (P={P} n=4 E=8 Pp=2 Mw={c.Mw}, "
                 f"L={L:g} bp): {active} particles recombine, {trips} "
                 f"walks of {events / max(trips, 1):.2f} events on average; "
                 f"{slots} ring slots changed, {pushed} statistics pushed; "
                 f"kernel {t['kernel_ms'] * 1e3:.2f} us of device time per "
                 f"launch beside {MIGRATION_VB_PASS if vb is not None else MIGRATION_PASS} "
                 f"{t['parent_ms'] * 1e3:.2f} us (turns parent, variant, "
                 f"variant, parent: "
                 + ", ".join(f"{x * 1e3:.2f}" for x in turns)
                 + f" us); host {t['host_us']:.2f} us per call"
                 + (f"; plain {t['plain_ms']:.4f} ms" if "plain_ms" in t
                    else "")
                 + f"; bound {t['bound_ms'] * 1e3:.3f} us by "
                 f"{t['bound_by']} ({t['bytes']} B, {t['flop']} operations), "
                 f"kernel reaches {t['bound_ms'] / t['kernel_ms']:.4f} of it")
        rows_out[label] = row
    return rows_out


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)


class _count_calls:
    """Count the calls of a module's functions until ``restore()``."""

    def __init__(self, module, names):
        self.module = module
        self.saved = {k: getattr(module, k) for k in names}
        self.counts = dict.fromkeys(names, 0)
        for k in names:
            setattr(module, k, self._counting(k))

    def _counting(self, name):
        def call(*args, **kwargs):
            self.counts[name] += 1
            return self.saved[name](*args, **kwargs)
        return call

    def restore(self):
        for k, fn in self.saved.items():
            setattr(self.module, k, fn)


def _read_out(path, it):
    """Rows of iteration ``it`` of a .out file as dicts."""
    with open(path) as fh:
        lines = [ln.split() for ln in fh.read().strip().split("\n")]
    header = lines[0]
    rows = [dict(zip(header, ln)) for ln in lines[1:]]
    return [r for r in rows if int(r["Iter"]) == it]


def reset_counts():
    """Every kernel's launch count to 0."""
    import smcsmc_tpu_torch.kernels.trip as trip_mod

    trip_mod.trip.launches = 0
    trip_mod.trip.wide_launches = 0
    for count in LAUNCH_COUNTS.values():
        setattr(trip_mod.segment_pass, count, 0)


def read_counts():
    """{kernel: launches} since :func:`reset_counts`."""
    import smcsmc_tpu_torch.kernels.trip as trip_mod

    return {"trip": trip_mod.trip.launches,
            WIDE_TRIP: trip_mod.trip.wide_launches,
            **{name: getattr(trip_mod.segment_pass, count)
               for name, count in LAUNCH_COUNTS.items()}}


def _run_cli(argv):
    """``smcsmc_main(argv)`` with the kernels' launch counts set to 0 just
    before and read just after, the calls of the plain versions counted and
    the package's log records kept.  Returns (launches, plain calls, the
    ``EM iteration`` records, all records, wall seconds)."""
    import smcsmc_tpu_torch.kernels.trip as trip_mod
    from smcsmc_tpu_torch import cli

    rec = _Records()
    lg = logging.getLogger("smcsmc_tpu_torch")
    lg.setLevel(logging.INFO)
    lg.addHandler(rec)
    plain_calls = _count_calls(trip_mod, ("trip_plain", "segment_pass_plain",
                                          "migration_trips"))
    try:
        reset_counts()
        t0 = time.monotonic()
        rc = cli.smcsmc_main(argv)
        wall = time.monotonic() - t0
        launches = read_counts()
    finally:
        plain_calls.restore()
        lg.removeHandler(rec)
    if rc != 0:
        raise SystemExit(f"smcsmc_main returned {rc}")
    steps = [r for r in rec.records if r.msg.startswith("EM iteration")]
    return launches, plain_calls.counts, steps, rec.records, wall


def _log_esteps(steps, P, card):
    for r in steps:
        it, secs, nseg = r.args[0], r.args[1], r.args[2]
        _log(f"  E-step {it}: {secs:.3f} s over {nseg} segments = "
             f"{P * nseg / secs:.6g} particle-site updates/s on {card}")


def _check_estimates(rows, it, problems, min_events=MIN_EPOCH_EVENTS,
                     pooled_within=None):
    """The result checks on one iteration's aggregate rows: LogL finite and
    negative, Coal Ne within 2x of the truth in the informed interior
    epochs (``min_events`` posterior coalescences or more), the interior
    epochs' pooled Ne within ``pooled_within`` of the truth where that is
    given, Recomb rate within 2x of the truth."""
    import numpy as np

    logl = [float(r["Count"]) for r in rows if r["Type"] == "LogL"]
    coal = [r for r in rows if r["Type"] == "Coal"]
    recomb = [r for r in rows if r["Type"] == "Recomb"]
    if len(logl) != 1 or not np.isfinite(logl[0]) or logl[0] >= 0:
        problems.append(f"LogL {logl}")
    # interior epochs that carry data: few recombinations happen over a few
    # Mb, and the youngest epochs see almost no coalescences, so their Ne
    # is the prior's pseudocount ratio
    informed = [r for r in coal[1:len(coal) - 1]
                if float(r["Count"]) >= min_events]
    if len(informed) < 3:
        problems.append(f"only {len(informed)} interior epochs with >= "
                        f"{min_events} coalescences")
    for r in informed:
        ne = float(r["Ne"])
        if not 0.5 * NE <= ne <= 2.0 * NE:
            problems.append(f"Coal epoch {r['Epoch']} Ne {ne:.1f}")
    interior = coal[1:len(coal) - 1]
    pooled = (sum(float(r["Opp"]) for r in interior)
              / (2.0 * sum(float(r["Count"]) for r in interior)))
    if pooled_within is not None and abs(pooled - NE) > pooled_within * NE:
        problems.append(f"pooled Ne of the interior epochs {pooled:.1f}")
    rate = float(recomb[0]["Rate"]) if recomb else float("nan")
    if not 0.5 * RHO <= rate <= 2.0 * RHO:
        problems.append(f"Recomb rate {rate:.4g}")
    _log("result.out (iteration %d): LogL %s; %d informed interior epochs "
         "(>= %g coalescences), pooled interior Ne %.1f; Coal Ne "
         "(coalescences) by epoch %s; Recomb rate %.4g"
         % (it, logl, len(informed), min_events, pooled,
            " ".join(f"{float(r['Ne']):.1f} ({float(r['Count']):.1f})"
                     for r in coal), rate))


def _check_launches(launches, plain, segments, problems, path,
                    name="segment_pass"):
    """One launch per segment of the pass ``name`` that the path takes and
    none of the other passes; no plain version; ``trip`` (the wide one
    with a wide pass) only in the biased path's pre-pass."""
    if launches[name] != segments:
        problems.append(f"{name} launched {launches[name]} "
                        f"times for {segments} segments")
    for other in LAUNCH_COUNTS:
        if other != name and launches[other] != 0:
            problems.append(f"{other} launched {launches[other]} times on "
                            f"the {path}")
    biased = name in (BIASED_PASS, BIASED_VB_PASS, BIASED_WIDE_PASS,
                      BIASED_WIDE_VB_PASS)
    wide = name in WIDE_NAMES.values()
    for entry in ("trip", WIDE_TRIP):
        if launches[entry] != 0 and (not biased or wide != (entry ==
                                                            WIDE_TRIP)):
            problems.append(f"{entry} launched {launches[entry]} times on "
                            f"the {path}")
    if any(plain.values()):
        problems.append(f"the {path} ran a plain version: {plain}")


def _main_argv(seg_path, out, em_iters=1):
    """The main path's command (bench.py's data at -Np 10000, 9 epochs,
    seed 7, the ESS trace of each resampling recorded)."""
    return ["-seg", seg_path, "-o", out, "-Np", "10000", "-EM",
            str(em_iters), "-N0", "10000", "-mu", "1e-8", "-rho", "1e-9",
            "-P", "133", "133016", "7*1", "-record_ess", "-seed", "7",
            "-device", DEVICE]


def _resample_rows(out, it):
    with open(os.path.join(out, f"emiter{it}", "chunkfinal.resample")) as fh:
        return fh.read().split()


def phase_main_path(card, seg):
    """The main path; returns (launches, E-step records, iteration 0's
    .resample rows)."""
    from smcsmc_tpu_torch.segio import write_seg

    P, em_iters = 10000, 1
    with tempfile.TemporaryDirectory() as tmp:
        seg_path = os.path.join(tmp, "bench.seg")
        write_seg(seg_path, seg)
        out = os.path.join(tmp, "out")
        argv = _main_argv(seg_path, out, em_iters)
        launches, plain, steps, _, wall = _run_cli(argv)
        rows = _read_out(os.path.join(out, "result.out"), em_iters)
        resample = _resample_rows(out, 0)
    if len(steps) != em_iters + 1:
        raise SystemExit("main path did not log every EM iteration")
    _log(f"main path: smc2-torch -Np {P} -EM {em_iters} ran in {wall:.2f} s "
         f"wall; kernel launches {launches}; calls of the plain versions "
         f"{plain}")
    _log_esteps(steps, P, card)

    problems = []
    _check_estimates(rows, em_iters, problems)
    _check_launches(launches, plain, sum(r.args[2] for r in steps), problems,
                    "main path")
    if problems:
        raise SystemExit("result checks failed: " + "; ".join(problems))
    _log("result checks: ok")
    return launches, steps, resample


def _profile(card, label, demo, seg, P, **options):
    """A sweep profile (sweep_profile.profile_sweep) with the launch counts
    set to 0 before and read after; printed under ``label``.  Returns
    (report, launches)."""
    from smcsmc_tpu_torch.sweep_profile import profile_sweep, report_lines

    reset_counts()
    rep = profile_sweep(demo, seg, P, DEVICE, **PROFILE_WINDOW, **options)
    launches = read_counts()
    _log(f"{label} sweep profile on {card}: launches {launches}")
    for ln in report_lines(rep):
        _log(ln)
    _elapsed(f"the {label} profile")
    return rep, launches


def phase_vb_path(card, seg, main_steps):
    """bench.py's feature_vb through smcsmc_main: the main path's command
    with ``-vb -EM 1``, so that iteration 1 uses the tables of the counts
    before it.
    The VB variant of the plain pass once per segment of each E-step, no
    other pass and no plain version; the estimates of iteration 1 checked
    as the main path's; iteration 0's LogL within 1e-4
    relative of the main path's (its tables, from counts of 1e10, add about
    -5e-11 per event), iteration 1's different from the main path's.
    Returns (launches, E-step records, profile, profile launches)."""
    from smcsmc_tpu_torch.segio import write_seg
    from smcsmc_tpu_torch.sweep_profile import bench_data

    P, em_iters = 10000, 1
    with tempfile.TemporaryDirectory() as tmp:
        seg_path = os.path.join(tmp, "bench.seg")
        write_seg(seg_path, seg)
        out = os.path.join(tmp, "out")
        argv = _main_argv(seg_path, out, em_iters) + ["-vb"]
        launches, plain, steps, _, wall = _run_cli(argv)
        rows = _read_out(os.path.join(out, "result.out"), em_iters)
    if len(steps) != em_iters + 1:
        raise SystemExit("VB path did not log every EM iteration")
    logl = [r.args[4] for r in steps]
    main_logl = [r.args[4] for r in main_steps]
    _log(f"VB path: smc2-torch -Np {P} -EM {em_iters} -vb ran in {wall:.2f} s"
         f" wall; kernel launches {launches}; calls of the plain versions "
         f"{plain}; LogL by iteration {logl!r} (main path {main_logl!r})")
    _log_esteps(steps, P, card)
    problems = []
    _check_estimates(rows, em_iters, problems)
    _check_launches(launches, plain, sum(r.args[2] for r in steps), problems,
                    "VB path", VB_PASS)
    if abs(logl[0] - main_logl[0]) > 1e-4 * abs(main_logl[0]):
        problems.append(f"iteration 0's LogL {logl[0]} is not the main "
                        f"path's {main_logl[0]}")
    if logl[1] == main_logl[1]:
        problems.append("iteration 1's LogL equals the main path's")
    if problems:
        raise SystemExit("VB path checks failed: " + "; ".join(problems))
    _log("VB path checks: ok")
    demo, seg = bench_data()
    rep, p_launches = _profile(card, "VB path", demo, seg, P, vb=True)
    return launches, steps, rep, p_launches


def phase_apf_path(card, seg, main_resample):
    """bench.py's feature_apf through smcsmc_main: the main path's command
    with ``-apf 2 -EM 0``.  The plain pass once per segment, no other pass
    and no plain version; the estimates checked as the main path's; the
    .resample trace (the ESS of the effective pilot at each resampling)
    different from the main path's iteration 0.  Returns (launches, E-step
    records, profile)."""
    from smcsmc_tpu_torch.segio import write_seg
    from smcsmc_tpu_torch.sweep_profile import bench_data

    P = 10000
    with tempfile.TemporaryDirectory() as tmp:
        seg_path = os.path.join(tmp, "bench.seg")
        write_seg(seg_path, seg)
        out = os.path.join(tmp, "out")
        argv = _main_argv(seg_path, out, 0) + ["-apf", "2"]
        launches, plain, steps, _, wall = _run_cli(argv)
        rows = _read_out(os.path.join(out, "result.out"), 0)
        resample = _resample_rows(out, 0)
    _log(f"APF path: smc2-torch -Np {P} -EM 0 -apf 2 ran in {wall:.2f} s "
         f"wall; kernel launches {launches}; calls of the plain versions "
         f"{plain}; {len(resample) // 2} resamplings (main path "
         f"{len(main_resample) // 2})")
    _log_esteps(steps, P, card)
    problems = []
    _check_estimates(rows, 0, problems)
    _check_launches(launches, plain, sum(r.args[2] for r in steps), problems,
                    "APF path")
    if resample == main_resample:
        problems.append("the ESS trace equals the main path's")
    if problems:
        raise SystemExit("APF path checks failed: " + "; ".join(problems))
    _log("APF path checks: ok")
    demo, seg = bench_data()
    rep, _ = _profile(card, "APF path", demo, seg, P, apf=2)
    return launches, steps, rep


# The alpha path's .recomb.gz against its .out: the windows' summed
# opportunity is the segments' ungated opportunity weighted at each
# segment's end, the summed leaf counts are the events weighted a lag later
# (less the events dropped on full rings of 32 slots, a fifth of them on
# this data); the .out's Recomb Opp and Count come through the lagged FIFO
# behind the recording gate.  So they agree only roughly.  The JAX
# package's own runs of this command on the CPU (smcsmc_tpu.cli -Np 500
# -EM 1 -alpha 0.5, seeds 7-10) gave .recomb.gz / .out - 1 of -0.1% to
# +4.6% for the opportunity and -25.1% to -3.1% for the leaf counts
# (iterations 0 and 1); the tolerances are twice the largest, rounded up.
RECOMB_OPP_VS_OUT = 0.10
RECOMB_CNT_VS_OUT = 0.55


def recomb_totals(path):
    """(windows, summed opportunity, summed leaf counts) of a .recomb.gz:
    each window's opportunity and leaf counts per nt times its size."""
    import gzip

    with gzip.open(path, "rt") as fh:
        header = fh.readline().rstrip("\n").split("\t")
        n = sum(1 for col in header if col.isdigit())
        rows, opp, cnt = 0, 0.0, 0.0
        for ln in fh:
            e = ln.rstrip("\n").split("\t")
            size = float(e[2])
            opp += float(e[3]) * size
            cnt += sum(float(x) for x in e[4:4 + n]) * size
            rows += 1
    return rows, opp, cnt


def write_constant_guide(path, demo):
    """bench.py's synthetic constant guide (sweep_profile's)."""
    from smcsmc_tpu_torch.sweep_profile import write_constant_guide as w

    return w(path, demo)


def phase_bias_guide_path(card, seg):
    """bench.py's feature_bias_guide through smcsmc_main: the main path's
    command with ``-bias_heights 0 0.01 -bias_strengths 2 1 -guide
    g.recomb_guide.gz -EM 0`` (a constant guide written as bench.py writes
    it).  The guided biased pass once per segment, no other pass, no
    ``trip`` and no plain version; estimates checked as the main path's; a
    sweep profile.  Returns (launches, E-step records, profile)."""
    from smcsmc_tpu_torch.segio import write_seg
    from smcsmc_tpu_torch.sweep_profile import BIAS_GUIDE_OPTIONS, bench_data

    P = 10000
    demo, _ = bench_data()
    with tempfile.TemporaryDirectory() as tmp:
        seg_path = os.path.join(tmp, "bench.seg")
        write_seg(seg_path, seg)
        out = os.path.join(tmp, "out")
        guide = write_constant_guide(os.path.join(tmp, "g.recomb_guide.gz"),
                                     demo)
        argv = (_main_argv(seg_path, out, 0) + BIAS_GUIDE_FLAGS
                + ["-guide", guide])
        launches, plain, steps, _, wall = _run_cli(argv)
        rows = _read_out(os.path.join(out, "result.out"), 0)
        _log(f"bias-guide path: smc2-torch -Np {P} -EM 0 "
             f"{' '.join(BIAS_GUIDE_FLAGS)} -guide (constant) ran in "
             f"{wall:.2f} s wall; kernel launches {launches}; calls of the "
             f"plain versions {plain}; LogL {[r.args[4] for r in steps]!r}")
        _log_esteps(steps, P, card)
        problems = []
        _check_estimates(rows, 0, problems)
        _check_launches(launches, plain, sum(r.args[2] for r in steps),
                        problems, "bias-guide path", GUIDE_PASS)
        if problems:
            raise SystemExit("bias-guide path checks failed: "
                             + "; ".join(problems))
        _log("bias-guide path checks: ok")
        rep, _ = _profile(card, "bias-guide path", demo, seg, P,
                          guide_file=guide, **BIAS_GUIDE_OPTIONS)
    return launches, steps, rep


def phase_alpha_path(card, seg):
    """The guide loop through smcsmc_main: the main path's command with
    ``-alpha 0.5 -EM 1``.  Iteration 0 records its windows with the local
    plain pass, once per segment; iteration 1 smooths them into
    ``emiter1/chunk0.recomb_guide.gz`` and sweeps on it with the guided
    local pass (one section of strength 1: no height bias), once per
    segment; nothing else, no ``trip``, no plain version.  Each
    iteration's estimates checked as the main path's; each ``.recomb.gz``
    of 20,000 windows, its summed opportunity and leaf counts within
    ``RECOMB_OPP_VS_OUT`` and ``RECOMB_CNT_VS_OUT`` of the ``.out``'s
    Recomb Opp and Count; the log
    names iteration 1's guide.  Then sweep profiles of iteration 0's setup
    and of iteration 1's (on the smoothed guide).  Returns (launches,
    E-step records, profiles, the windows' totals)."""
    from smcsmc_tpu_torch.segio import write_seg
    from smcsmc_tpu_torch.sweep_profile import bench_data

    P, em_iters = 10000, 1
    demo, _ = bench_data()
    problems = []
    with tempfile.TemporaryDirectory() as tmp:
        seg_path = os.path.join(tmp, "bench.seg")
        write_seg(seg_path, seg)
        out = os.path.join(tmp, "out")
        argv = _main_argv(seg_path, out, em_iters) + ["-alpha", "0.5"]
        launches, plain, steps, records, wall = _run_cli(argv)
        guide = os.path.join(out, "emiter1", "chunk0.recomb_guide.gz")
        totals = {}
        for it in range(em_iters + 1):
            rows = _read_out(os.path.join(out, "result.out"), it)
            _check_estimates(rows, it, problems)
            recomb = [r for r in rows if r["Type"] == "Recomb"][0]
            windows, opp, cnt = recomb_totals(os.path.join(
                out, f"emiter{it}", "chunk0.recomb.gz"))
            ratio = (opp / float(recomb["Opp"]), cnt / float(recomb["Count"]))
            totals[it] = {"windows": windows, "opp": opp, "count": cnt,
                          "out_opp": float(recomb["Opp"]),
                          "out_count": float(recomb["Count"]),
                          "ratio": ratio}
            _log(f"alpha path iteration {it}: .recomb.gz {windows} windows, "
                 f"opportunity {opp:.6g} and leaf counts {cnt:.6g} against "
                 f"the .out's Recomb Opp {recomb['Opp']} and Count "
                 f"{recomb['Count']}: ratios {ratio[0]:.4f} {ratio[1]:.4f}")
            if windows != 20000:
                problems.append(f"iteration {it}'s .recomb.gz has {windows} "
                                "windows")
            if (abs(ratio[0] - 1.0) > RECOMB_OPP_VS_OUT
                    or abs(ratio[1] - 1.0) > RECOMB_CNT_VS_OUT):
                problems.append(f"iteration {it}'s .recomb.gz totals are "
                                f"{ratio} of the .out's")
        read = [r for r in records if "guide" in r.getMessage()
                and r.getMessage().startswith("iteration 1")]
        if not os.path.exists(guide) or not read:
            problems.append("iteration 1 did not read a smoothed guide")
        segs = [r.args[2] for r in steps]
        _log(f"alpha path: smc2-torch -Np {P} -EM {em_iters} -alpha 0.5 ran "
             f"in {wall:.2f} s wall; kernel launches {launches}; calls of "
             f"the plain versions {plain}; LogL {[r.args[4] for r in steps]!r}"
             f"; {read[0].getMessage() if read else 'no guide read'}")
        _log_esteps(steps, P, card)
        want = {LOCAL_PASS: segs[0], GUIDE_LOCAL_PASS: segs[1]}
        for name, n in launches.items():
            if n != want.get(name, 0):
                problems.append(f"{name} launched {n} times on the alpha "
                                f"path (want {want.get(name, 0)})")
        if any(plain.values()):
            problems.append(f"the alpha path ran a plain version: {plain}")
        if problems:
            raise SystemExit("alpha path checks failed: "
                             + "; ".join(problems))
        _log("alpha path checks: ok")
        rep0, _ = _profile(card, "alpha path (iteration 0: recording)", demo,
                           seg, P, alpha=0.5)
        rep1, _ = _profile(card, "alpha path (iteration 1: guided, "
                           "recording)", demo, seg, P, alpha=0.5,
                           guide_file=guide)
    return launches, steps, (rep0, rep1), totals


def variant_sweeps(card, segments=60):
    """Each guided or local pass that neither path of the slice runs,
    driven over the first ``segments`` segments of the main path's data
    at P=10,000 by :func:`_short_sweep`: the local biased pass (-alpha with
    feature_bias_guide's bias), and the VB variants of the four.  Returns
    {pass: launches}."""
    import tempfile as _tf

    from smcsmc_tpu_torch.sweep_profile import BIAS_GUIDE_OPTIONS, bench_data

    demo, seg = bench_data()
    out = {}
    with _tf.TemporaryDirectory() as tmp:
        guide = write_constant_guide(os.path.join(tmp, "g.recomb_guide.gz"),
                                     demo)
        runs = {BIASED_LOCAL_PASS: dict(alpha=0.5, **BIAS_GUIDE_OPTIONS)}
        for name, opts in ((GUIDE_PASS, dict(guide_file=guide,
                                             **BIAS_GUIDE_OPTIONS)),
                           (GUIDE_LOCAL_PASS, dict(guide_file=guide,
                                                   alpha=0.5)),
                           (BIASED_LOCAL_PASS, runs[BIASED_LOCAL_PASS]),
                           (LOCAL_PASS, dict(alpha=0.5))):
            runs[vb_name(name)] = dict(opts, vb=True)
        for name, opts in runs.items():
            out[name] = _short_sweep(card, name, demo, seg, segments,
                                     **opts)[name]
    return out


def local_ops_cost(card, P=10000, calls=50, W=20000, R=LOCAL_SLOTS, n=4):
    """The torch ops of local recording alone at the alpha path's shape
    (P=10,000, a ring of 32 slots about 15% in use, a tenth of the events
    due, 20,000 windows, n=4): ``add_window_opportunity`` over a segment of
    1,491 bp (the main path's mean) and ``commit_due_local``, each
    ``calls`` times under torch.profiler on fresh rings: launches and device
    us per call, and each one's bound (ring, weights and opportunities read
    once, the windows touched written once)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from smcsmc_tpu_torch.kernels.local import (
        add_window_opportunity,
        commit_due_local,
    )
    from smcsmc_tpu_torch.kernels.tree import INF
    from smcsmc_tpu_torch.sweep_profile import _LAUNCH_CALLS

    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    dev = "cuda"
    front = 1e6
    used = torch.rand((P, R), generator=g, device=dev) < 0.15
    pos = front - 3e4 * torch.rand((P, R), generator=g, device=dev)
    due = torch.where(torch.rand((P, R), generator=g, device=dev) < 0.1,
                      front - 1.0, front + 1e4)
    ring = [torch.where(used, pos, INF), torch.where(used, due, INF),
            torch.where(used, 1e4 * torch.rand((P, R), generator=g,
                                               device=dev), 0.0),
            torch.where(used, torch.randint(1, 16, (P, R), generator=g,
                                            device=dev), 0)]
    n_due = int((used & (due <= front)).sum())
    w = torch.softmax(torch.randn(P, generator=g, device=dev), 0)
    ropp = 1e4 * torch.rand(P, generator=g, device=dev)
    win_opp = torch.zeros(W + 1, device=dev)
    win_cnt = torch.zeros((W + 1, n + 2), device=dev)
    rings = [[x.clone() for x in ring] for _ in range(calls + 1)]
    ops = {
        "add_window_opportunity": lambda k: add_window_opportunity(
            win_opp, np.float32(front - 1491.0), np.float32(front),
            (w * ropp).sum(), GUIDE_WINDOW),
        "commit_due_local": lambda k: commit_due_local(
            win_cnt, *rings[k], w, front, GUIDE_WINDOW)}
    out = {}
    for name, op in ops.items():
        op(calls)  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for k in range(calls):
                op(k)
            torch.cuda.synchronize()
        ka = prof.key_averages()
        dev_us = sum(e.self_device_time_total for e in ka
                     if e.device_type == DeviceType.CUDA)
        launches = sum(e.count for e in ka if e.key in _LAUNCH_CALLS)
        if name == "commit_due_local":
            nbytes = P * R * (4 + 4 + 4 + 8) + 4 * P + n_due * (
                8 + 4 * (n + 2) * 2)
            flop = P * R * (n * 3 + 10)
        else:
            nbytes, flop = 8 * P + 4 * 4 * 2, 2 * P + 16
        out[name] = dict(launches_per_call=launches / calls,
                         device_us_per_call=dev_us / calls,
                         **_bound_of(nbytes, flop))
        _log(f"{name} alone on {card} (P={P}, R={R}, W={W}, {n_due} events "
             f"due): {launches / calls:.2f} launches and "
             f"{dev_us / calls:.2f} us of device time per call; bound "
             f"{out[name]['bound_ms'] * 1e3:.3f} us by "
             f"{out[name]['bound_by']} ({nbytes} B)")
    return out


def phase_apf8_path(card):
    """bench.py's feature_apf8 through ``em.run_em`` with ``EMConfig(apf=2,
    apf_trees=50_000)`` as bench.py passes it: n=8, missing windows, an
    unphased pair (sweep_profile.apf8_data), P=10,000, one E-step at the
    truth.  The plain pass once per segment, nothing else; the estimates
    checked as the main path's.  Returns (launches, E-step seconds and
    segments, profile, profile without the APF)."""
    from smcsmc_tpu_torch import em
    import smcsmc_tpu_torch.kernels.trip as trip_mod
    from smcsmc_tpu_torch.sweep_profile import apf8_data

    P = 10000
    demo, seg = apf8_data()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = em.EMConfig(num_particles=P, apf=2, apf_trees=50_000,
                          outdir=tmp, seed=7, device=DEVICE)
        plain = _count_calls(trip_mod, ("trip_plain", "segment_pass_plain",
                                        "migration_trips"))
        try:
            reset_counts()
            t0 = time.monotonic()
            res = em.run_em(demo, seg, cfg)
            wall = time.monotonic() - t0
            launches = read_counts()
        finally:
            plain.restore()
        rows = _read_out(os.path.join(tmp, "result.out"), 0)
    secs, nseg = res.estep_seconds[0], res.num_segments[0]
    _log(f"APF8 path: em.run_em(EMConfig(num_particles={P}, apf=2, "
         f"apf_trees=50000)) ran in {wall:.2f} s wall; kernel launches "
         f"{launches}; calls of the plain versions {plain.counts}; LogL "
         f"{res.log_likelihoods!r}")
    _log(f"  E-step 0: {secs:.3f} s over {nseg} segments = "
         f"{P * nseg / secs:.6g} particle-site updates/s on {card}")
    problems = []
    _check_estimates(rows, 0, problems)
    _check_launches(launches, plain.counts, nseg, problems, "APF8 path")
    if problems:
        raise SystemExit("APF8 path checks failed: " + "; ".join(problems))
    _log("APF8 path checks: ok")
    rep, _ = _profile(card, "APF8 path", demo, seg, P, apf=2,
                      apf_trees=50_000)
    base, _ = _profile(card, "APF8 data without the APF", demo, seg, P)
    return launches, (secs, nseg), rep, base


def lookahead_cost(card, demo, seg, P=10000, calls=50):
    """The APF lookahead alone (``kernels.lookahead.lookahead_loglik`` at
    level 2, plain torch operations) at P particles on trees drawn from
    ``demo``, on the columns of a segment of ``seg`` with doubletons: its
    kernel launches and device time per call (torch.profiler over
    ``calls`` calls) and its bound: the bytes it must move (node times and
    parents, tree lengths, the segment's columns and the quantiles read
    once, the result written once) over the memory rate, its operations
    (two rate regimes per leaf and quantile, about 16 each; per doubleton
    four phasings and two regimes, about 40) over the float32 rate."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from smcsmc_tpu_torch.calibrate import terminal_branch_quantiles
    from smcsmc_tpu_torch.em import compute_lookahead, lookahead_columns
    from smcsmc_tpu_torch.kernels.lookahead import lookahead_loglik
    from smcsmc_tpu_torch.kernels.tree import (
        branch_lengths,
        epochs_from_demography,
        make_initial_trees,
    )
    from smcsmc_tpu_torch.segio import split_long_segments

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    epochs = epochs_from_demography(demo, "cuda")
    trees = make_initial_trees(gen, epochs, P, demo.sample_pops)
    tl = branch_lengths(trees.time, trees.parent).sum(dim=1)
    la = compute_lookahead(split_long_segments(seg, MAX_SEG))
    s = int(np.flatnonzero(la.dbl_s1[:, 0] >= 0)[0])
    cols = tuple(c[s] for c in lookahead_columns(la, "cuda"))
    quant = terminal_branch_quantiles(gen, epochs, demo.sample_pops,
                                      num_trees=25_000)

    def call():
        return lookahead_loglik(trees, tl, cols, quant, MU, RHO, 2)

    out = call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in ka
                 if e.device_type == DeviceType.CUDA) / calls
    launch_calls = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                    "cuLaunchKernel", "cuLaunchKernelEx")
    launches = sum(e.count for e in ka if e.key in launch_calls) / calls
    n, N = demo.num_samples, trees.time.shape[1]
    D, Q = la.dbl_s1.shape[1], quant.lengths.shape[1]
    nbytes = (P * (2 * N * 4 + 4 + 4) + n * (3 * 4 + 4) + D * 6 * 4
              + (n + 1) * Q * 4)
    flop = P * (2 * n * Q * 16 + D * 40)
    bound = _bound_of(nbytes, flop)
    _log(f"lookahead_loglik (apf 2) at P={P} n={n} on {card}: "
         f"{launches:.1f} kernel launches and {dev_us:.2f} us of device time "
         f"per call ({calls} calls under torch.profiler); bound "
         f"{bound['bound_ms'] * 1e3:.3f} us by {bound['bound_by']} "
         f"({nbytes} B, {flop} FLOP); finite {bool(torch.isfinite(out).all())}")
    if not bool(torch.isfinite(out).all()):
        raise SystemExit("the lookahead log-likelihood is not finite")
    return dict(P=P, n=n, launches_per_call=launches,
                device_us_per_call=dev_us, **bound)


GENOME_P = 10000


def _genome_argv(paths, out):
    return ["-segs", *paths, "-chunks", "4", "-o", out, "-Np", str(GENOME_P),
            "-EM", "1", "-N0", "10000", "-mu", "1e-8", "-rho", "1e-9", "-P",
            "133", "133016", "31*1", "-record_ess", "-ckpt", "1", "-seed",
            "7", "-device", DEVICE]


def _mid_sweep_checkpoint(demo, seg, chunk, tmp):
    """Sweep ``chunk`` twice with one seed: straight through, and with
    ``save_state`` at half way and ``load_state`` into a sweep that was set
    up from another seed.  Both must end bit for bit equal: every device
    reduction of the sweep repeats bit for bit (the resampler's scan is
    ``smc.block_scan``, held by ``phase_scan_repeat``)."""
    import torch

    from smcsmc_tpu_torch.checkpoint import load_state, save_state
    from smcsmc_tpu_torch.em import EMConfig, start_sweep
    from smcsmc_tpu_torch.smc import flush_pending

    cfg = EMConfig(num_particles=GENOME_P, device=DEVICE)
    sweep = start_sweep(demo, seg, cfg, chunk, seed=31)
    state = sweep.state
    for s in range(len(sweep.segs)):
        state, _ = sweep.step(state, sweep.segs[s])
    ref = flush_pending(state)

    first = start_sweep(demo, seg, cfg, chunk, seed=31)
    half = len(first.segs) // 2
    state = first.state
    for s in range(half):
        state, _ = first.step(state, first.segs[s])
    path = os.path.join(tmp, "midsweep.ckpt")
    save_state(path, state, first.generator, {"segments": half})
    size = os.path.getsize(path)
    second = start_sweep(demo, seg, cfg, chunk, seed=32)
    state, done = load_state(path, second.generator, DEVICE)
    for s in range(done["segments"], len(second.segs)):
        state, _ = second.step(state, second.segs[s])
    got = flush_pending(state)
    same = {k: torch.equal(getattr(got, k), getattr(ref, k))
            for k in ("ln_norm", "stats", "stats_wt", "log_w")}
    same["num_resamples"] = got.num_resamples == ref.num_resamples
    _log(f"mid-sweep checkpoint: chunk {chunk}, {len(first.segs)} segments, "
         f"saved after {half} ({size} bytes), loaded into a sweep started "
         f"from another seed; ln_norm {float(got.ln_norm):.4f} vs "
         f"{float(ref.ln_norm):.4f} uninterrupted, {got.num_resamples} vs "
         f"{ref.num_resamples} resamples; bit for bit equal: {same}")
    if not all(same.values()):
        raise SystemExit("a sweep resumed from a checkpoint differs from "
                         "the uninterrupted sweep of the same seed")


def phase_genome_path(card):
    """The whole-genome path through smcsmc_main; see the module docstring.
    Returns (launches of the first run, E-step records, the model and the
    merged data, the chunks, the mean segment length)."""
    import numpy as np

    from smcsmc_tpu_torch.segio import write_seg
    from smcsmc_tpu_torch.sweep_profile import genome_data, genome_model

    problems = []
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, name) for name in ("a.seg", "b.seg")]
        for path, chrom in zip(paths, genome_data()):
            write_seg(path, chrom)
        out = os.path.join(tmp, "out")
        argv = _genome_argv(paths, out)
        launches, plain, steps, records, wall = _run_cli(argv)
        chunks = next(r.args[0] for r in records
                      if r.msg.startswith("chunks:"))
        shown = " ".join(os.path.basename(a) if a in paths else a
                         for a in argv if a != out)
        _log(f"genome path: smc2-torch {shown} ran in "
             f"{wall:.2f} s wall; chunks {chunks}; kernel launches "
             f"{launches}; calls of the plain versions {plain}")
        _log_esteps(steps, GENOME_P, card)
        if len(steps) != 2 or len(chunks) != 4:
            raise SystemExit(f"genome path: {len(steps)} EM iterations "
                             f"logged, {len(chunks)} chunks")
        segments = sum(r.args[2] for r in steps)
        _check_launches(launches, plain, segments, problems, "genome path")
        for r in steps:
            by_status, unphased = r.args[7], r.args[8]
            _log(f"  iteration {r.args[0]}: segments by leaf status "
                 f"{by_status}, {unphased} sites with several phase "
                 f"configurations")
            if min(by_status.values()) < 1 or unphased < 1:
                problems.append(f"iteration {r.args[0]} stepped over no "
                                f"segment of some kind: {by_status}, "
                                f"{unphased} unphased")

        first_result = open(os.path.join(out, "result.out")).read()
        for it in (0, 1):
            rows = _read_out(os.path.join(out, f"emiter{it}",
                                          "chunkfinal.out"), it)
            agg = [r for r in rows if r["Clump"] == "-1"]
            if it == 1:
                _check_estimates(agg, it, problems, GENOME_MIN_EPOCH_EVENTS,
                                 GENOME_POOLED_WITHIN)
            logl = float(next(r["Count"] for r in agg if r["Type"] == "LogL"))
            parts = [float(r["Count"]) for r in rows
                     if r["Type"] == "LogL" and r["Clump"] != "-1"]
            # the .out prints 8 significant digits
            if len(parts) != 4 or abs(sum(parts) - logl) > 1e-6 * abs(logl):
                problems.append(f"iteration {it}: chunk LogL {parts} do not "
                                f"sum to {logl}")
            resamp = float(next(r["Count"] for r in agg
                                if r["Type"] == "Resamp"))
            with open(os.path.join(out, f"emiter{it}",
                                   "chunkfinal.resample")) as fh:
                n_rows = sum(1 for _ in fh)
            if n_rows != int(resamp):
                problems.append(f"iteration {it}: {n_rows} .resample rows "
                                f"for {resamp} resample events")
            _log(f"  iteration {it}: chunk LogL {parts} sum to {sum(parts)!r}"
                 f" (aggregate {logl!r}); {n_rows} .resample rows for "
                 f"{int(resamp)} resample events")
        if os.path.exists(os.path.join(out, "ckpt")):
            problems.append("a mid-sweep checkpoint was left behind")
        if problems:
            raise SystemExit("genome path checks failed: "
                             + "; ".join(problems))
        _log("genome path checks: ok")

        # ---- resume: iteration 1 lost, the same command again -------------
        import shutil

        shutil.rmtree(os.path.join(out, "emiter1"))
        os.remove(os.path.join(out, "result.out"))
        re_launches, re_plain, re_steps, _, re_wall = _run_cli(argv)
        _check_launches(re_launches, re_plain, steps[1].args[2], problems,
                        "resumed genome path")
        if [r.args[0] for r in re_steps] != [1]:
            problems.append(f"the resumed run swept iterations "
                            f"{[r.args[0] for r in re_steps]}, not [1]")
        second_result = open(os.path.join(out, "result.out")).read()

        def rows_of(text, it):
            return [ln for ln in text.split("\n")[1:]
                    if ln and int(ln.split()[0]) == it]

        if rows_of(second_result, 0) != rows_of(first_result, 0):
            problems.append("the resumed run changed iteration 0's rows")
        a, b = rows_of(first_result, 1), rows_of(second_result, 1)
        differ = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
        l1 = [float(ln.split()[8]) for ln in a if " LogL " in ln][0]
        l2 = [float(ln.split()[8]) for ln in b if " LogL " in ln][0]
        _log(f"resume: the same command again after deleting emiter1/ and "
             f"result.out ran in {re_wall:.2f} s wall; launches "
             f"{re_launches} (iteration 0 launched nothing); result.out "
             f"byte for byte equal: {second_result == first_result}; "
             f"iteration 0 rows equal, iteration 1 rows that differ: "
             f"{differ} of {len(a)}; LogL {l2!r} vs {l1!r} in the first run")
        if second_result != first_result:
            _log("  why it differs: the resumed run reads iteration 0's "
                 "statistics back from chunkfinal.out, which prints counts "
                 "of 0.1 and more with two decimals, so its M-step starts "
                 "iteration 1 from a model that differs from the first "
                 "run's in the third or fourth digit (the JAX package's "
                 "resume does the same)")
            if abs(l2 - l1) > 0.01 * abs(l1):
                problems.append(f"resumed iteration 1 LogL {l2} is not "
                                f"within 1% of {l1}")
        _log_esteps(re_steps, GENOME_P, card)
        if problems:
            raise SystemExit("resume checks failed: " + "; ".join(problems))

        demo, seg = genome_model(paths)
        _mid_sweep_checkpoint(demo, seg, tuple(chunks[3]), tmp)

        from smcsmc_tpu_torch.segio import slice_seg, split_long_segments

        lengths = np.concatenate([
            split_long_segments(slice_seg(seg, c0, c1), MAX_SEG).lengths
            for c0, c1 in chunks])
    return (launches, re_launches, steps, demo, seg, chunks,
            float(lengths.mean()))


def phase_scan_repeat(repeats=2000, P=10000):
    """The resampler's scan (``smc.block_scan``) of one weight vector
    ``repeats`` times, a matrix product queued before every seventh, each
    result held bit for bit to the first; ``torch.cumsum``, which the
    resampler used before, is counted alongside for contrast."""
    import torch

    from smcsmc_tpu_torch.smc import block_scan

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    w = torch.softmax(torch.randn(P, generator=gen, device="cuda") * 3, 0)
    filler = _filler()
    counts = {}
    for name, scan in (("block_scan", block_scan),
                       ("torch.cumsum", lambda x: x.cumsum(0))):
        first, differ = scan(w), 0
        for i in range(repeats):
            if i % 7 == 0:
                filler()
            differ += int(not torch.equal(scan(w), first))
        counts[name] = differ
    _log(f"scan repeat P={P}: of {repeats} results, "
         f"{counts['block_scan']} of the resampler's block_scan and "
         f"{counts['torch.cumsum']} of torch.cumsum differ bit for bit from "
         f"their first")
    if counts["block_scan"]:
        raise SystemExit("the resampler's scan did not repeat bit for bit")
    return counts


BIASED_FLAGS = ["-bias_heights", "0", "0.05", "-calibrate_lag", "2"]


def phase_biased_path(card):
    """The whole-genome data through smcsmc_main with the production
    proposal (``BIASED_FLAGS``); see the module docstring.  Returns
    (launches, E-step records, trip launches the pre-passes reported,
    the profile of chunk 0)."""
    from smcsmc_tpu_torch.segio import write_seg
    from smcsmc_tpu_torch.sweep_profile import (
        BIASED_OPTIONS,
        genome_data,
        genome_model,
        profile_sweep,
        report_lines,
    )

    problems = []
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, name) for name in ("a.seg", "b.seg")]
        for path, chrom in zip(paths, genome_data()):
            write_seg(path, chrom)
        out = os.path.join(tmp, "out")
        # the genome path's command without -ckpt (no chunk reaches a
        # checkpoint) and with the production proposal
        # one E-step
        argv = _genome_argv(paths, out)
        i = argv.index("-ckpt")
        argv = argv[:i] + argv[i + 2:] + BIASED_FLAGS
        argv[argv.index("-EM") + 1] = "0"
        launches, plain, steps, records, wall = _run_cli(argv)
        shown = " ".join(os.path.basename(a) if a in paths else a
                         for a in argv if a != out)
        _log(f"biased path: smc2-torch {shown} ran in {wall:.2f} s wall; "
             f"kernel launches {launches}; calls of the plain versions "
             f"{plain}")
        _log_esteps(steps, GENOME_P, card)
        _log(f"biased path: LogL by iteration "
             f"{[r.args[4] for r in steps]!r} (in full)")
        msgs = [r.getMessage() for r in records]
        reported = sum(r.args[0] for r in records
                       if r.msg.startswith("survival calibration:"))
        for m in msgs:
            if m.startswith(("auto-calibrated bias_strengths",
                             "calibrated lags", "Calibrated lag",
                             "survival calibration")):
                _log("  log: " + m)
        if len(steps) != 1:
            raise SystemExit(f"biased path: {len(steps)} EM iterations")
        _check_launches(launches, plain, sum(r.args[2] for r in steps),
                        problems, "biased path", BIASED_PASS)
        if launches["trip"] == 0 or launches["trip"] != reported:
            problems.append(f"trip launched {launches['trip']} times, the "
                            f"calibration pre-passes report {reported}")
        if not any(m.startswith("auto-calibrated bias_strengths")
                   for m in msgs) or not any(
                m.startswith("calibrated lags") for m in msgs):
            problems.append("the calibrated strengths or lags were not "
                            "logged")
        rows = [r for r in _read_out(os.path.join(out, "emiter0",
                                                  "chunkfinal.out"), 0)
                if r["Clump"] == "-1"]
        _check_estimates(rows, 0, problems, GENOME_MIN_EPOCH_EVENTS,
                         GENOME_POOLED_WITHIN)
        if problems:
            raise SystemExit("biased path checks failed: "
                             + "; ".join(problems))
        _log("biased path checks: ok")
        demo, seg = genome_model(paths)
    chunk = next(r.args[0] for r in records if r.msg.startswith("chunks:"))[0]
    rep = profile_sweep(demo, seg, GENOME_P, DEVICE, **PROFILE_WINDOW,
                        chunk=tuple(chunk),
                        **BIASED_OPTIONS)
    _log(f"biased path sweep profile (chunk {chunk}, E=33) on {card}:")
    for ln in report_lines(rep):
        _log(ln)
    census = ring_census(demo, seg, tuple(chunk))
    _log(f"biased path rings (first {census['segments']} segments of chunk "
         f"{chunk}, counted before each pass): "
         + ", ".join(f"{k} {v:.4f}" for k, v in census.items()
                     if k != "segments"))
    rep["ring_census"] = census
    # the same profile with -vb: the biased pass's VB variant in the sweep
    rep["vb"], vb_launches = _profile(
        card, f"biased path with -vb (chunk {chunk})", demo, seg, GENOME_P,
        chunk=tuple(chunk), vb=True, **BIASED_OPTIONS)
    launches[BIASED_VB_PASS] = vb_launches[BIASED_VB_PASS]
    if vb_launches[BIASED_VB_PASS] == 0 or vb_launches[BIASED_PASS] != 0:
        raise SystemExit(f"the biased sweep with -vb launched {vb_launches}")
    return launches, steps, reported, rep


def ring_census(demo, seg, chunk, segments=300, P=GENOME_P, device=DEVICE):
    """What the biased pass finds on the real path: the first ``segments``
    segments of ``chunk`` swept with the production proposal
    (``sweep_profile.BIASED_OPTIONS``), counted before each pass: ring
    slots in use per particle, and the shares of particles that recombine
    in the segment, that have a factor due at its end, and either.
    Returns the means over the segments (sums kept on the device)."""
    import torch

    import smcsmc_tpu_torch.smc as smc_mod
    from smcsmc_tpu_torch.em import EMConfig, start_sweep
    from smcsmc_tpu_torch.kernels.tree import INF
    from smcsmc_tpu_torch.sweep_profile import BIASED_OPTIONS

    cfg = EMConfig(num_particles=P, device=device, **BIASED_OPTIONS)
    state, segs, step, _, _ = start_sweep(demo, seg, cfg, chunk, seed=7)
    sums = torch.zeros(4, dtype=torch.float64, device=device)
    passes = 0
    real = smc_mod.segment_pass

    def counted(*args):
        nonlocal passes
        next_rec, L, b = args[6], args[11], args[17]
        if b is not None:
            used = b.df_pos < 0.5 * INF
            end = float(torch.tensor(b.front, dtype=torch.float32)
                        + torch.tensor(L, dtype=torch.float32))
            rec = next_rec < L
            due = (b.df_pos <= end).any(dim=1)
            sums.add_(torch.stack([used.sum(dim=1).double().mean(),
                                   rec.double().mean(), due.double().mean(),
                                   (rec | due).double().mean()]))
            passes += 1
        return real(*args)

    smc_mod.segment_pass = counted
    try:
        for s in range(min(segments, len(segs))):
            state, _ = step(state, segs[s])
    finally:
        smc_mod.segment_pass = real
    means = (sums / max(passes, 1)).tolist()
    return dict(zip(("slots_in_use_per_particle", "share_recombining",
                     "share_with_factor_due", "share_recombining_or_due"),
                    means), segments=passes)


TWOPOP_MIN_EVENTS = 5.0  # posterior coalescences for an epoch to be checked
# Each interior epoch with >= 5 posterior coalescences, both populations
# together (sum of opportunity over twice the sum of coalescences), is held
# to 2x at every iteration, and each population's pooled interior Ne to
# 25%.  Each (epoch, population) is held to 2x in the E-step at the truth
# (iteration 0) only: the genealogy that simulate_seg drew for these 2 Mb
# reads epoch 4 of population 1 at 2993 and epoch 3 of population 1 at
# 24285 from its own trees, while every epoch pooled over the populations
# reads 8184-13809 (python -m smcsmc_tpu_torch.repeatability --genealogy).
# With 4 Nm = 2 the data say little about which population a coalescence
# fell in, and the M-steps move the model: epoch 4 drifts to 0.46-0.50 of
# the truth in population 0 in iterations 1-2 of seeds 7 and 8 (NVIDIA
# H100, repeatability --twopop-seeds 7 8 9), while iteration 0 of seeds 7,
# 8 and 9 holds every checked (epoch, population) to 0.56-1.11 of it.
TWOPOP_POOLED_WITHIN = 0.25


def _check_twopop(rows, it, problems, per_epoch):
    """The two-population result checks on one iteration's rows: LogL
    finite and negative; the Ne of every interior epoch with >= 5
    posterior coalescences in both populations together within 2x of
    10,000; with ``per_epoch``, per population Coal Ne within 2x of 10,000
    in every interior epoch with >= 5 posterior coalescences, at least 3
    such (epoch, population) over both populations; each
    population's pooled interior Ne (sum of opportunity over twice the sum
    of coalescences) within 25% of 10,000; the pooled migration rate (sum
    of counts over sum of opportunity, both directions, all epochs) within
    [0.5x, 2x] of 5e-5; Recomb rate within 2x of 1e-9."""
    import numpy as np

    logl = [float(r["Count"]) for r in rows if r["Type"] == "LogL"]
    if len(logl) != 1 or not np.isfinite(logl[0]) or logl[0] >= 0:
        problems.append(f"LogL {logl}")
    coal = [r for r in rows if r["Type"] == "Coal"]
    epochs = sorted({int(r["Epoch"]) for r in coal})
    interior = [r for r in coal if int(r["Epoch"]) in epochs[1:-1]]
    informed = [r for r in interior
                if float(r["Count"]) >= TWOPOP_MIN_EVENTS]
    pooled_epoch = {}
    for e in epochs[1:-1]:
        mine = [r for r in interior if int(r["Epoch"]) == e]
        count = sum(float(r["Count"]) for r in mine)
        if count >= TWOPOP_MIN_EVENTS:
            pooled_epoch[e] = sum(float(r["Opp"]) for r in mine) / (2 * count)
            if not 0.5 * NE <= pooled_epoch[e] <= 2.0 * NE:
                problems.append(f"iteration {it}: epoch {e} Ne over both "
                                f"populations {pooled_epoch[e]:.1f}")
    if per_epoch:
        if len(informed) < 3:
            problems.append(f"only {len(informed)} interior (epoch, "
                            f"population) with >= {TWOPOP_MIN_EVENTS} "
                            f"coalescences")
        for r in informed:
            ne = float(r["Ne"])
            if not 0.5 * NE <= ne <= 2.0 * NE:
                problems.append(f"iteration {it}: Coal epoch {r['Epoch']} "
                                f"population {r['From']} Ne {ne:.1f}")
    pooled_ne = {}
    for q in sorted({r["From"] for r in interior}):
        mine = [r for r in interior if r["From"] == q]
        pooled_ne[q] = (sum(float(r["Opp"]) for r in mine)
                        / (2.0 * sum(float(r["Count"]) for r in mine)))
        if abs(pooled_ne[q] - NE) > TWOPOP_POOLED_WITHIN * NE:
            problems.append(f"iteration {it}: pooled interior Ne of "
                            f"population {q} {pooled_ne[q]:.1f}")
    migr = [r for r in rows if r["Type"] == "Migr"]
    pooled = (sum(float(r["Count"]) for r in migr)
              / max(sum(float(r["Opp"]) for r in migr), 1e-300))
    if not 0.5 * TWOPOP_M <= pooled <= 2.0 * TWOPOP_M:
        problems.append(f"iteration {it}: pooled migration rate "
                        f"{pooled:.4g}")
    recomb = [r for r in rows if r["Type"] == "Recomb"]
    rate = float(recomb[0]["Rate"]) if recomb else float("nan")
    if not 0.5 * RHO <= rate <= 2.0 * RHO:
        problems.append(f"iteration {it}: Recomb rate {rate:.4g}")
    _log("result.out (iteration %d): LogL %s; %d interior (epoch, "
         "population) with >= %g coalescences; Ne by informed epoch over "
         "both populations %s; pooled interior Ne by population %s; Coal Ne "
         "(coalescences) by epoch/population %s; pooled migration rate "
         "%.5g over %d Migr rows; Recomb rate %.4g"
         % (it, logl, len(informed), TWOPOP_MIN_EVENTS,
            {e: round(v, 1) for e, v in pooled_epoch.items()},
            {q: round(v, 1) for q, v in pooled_ne.items()},
            " ".join(f"{r['Epoch']}/{r['From']}:{float(r['Ne']):.1f}"
                     f"({float(r['Count']):.1f})" for r in coal),
            pooled, len(migr), rate))
    return pooled


def phase_twopop_path(card):
    """bench.py's twopop_em_iter configuration through smcsmc_main:
    ``smc2-torch -Np 10000 -EM 0`` with the flags of
    ``sweep_profile.twopop_flags`` on ``simulate_seg(twopop_demo, seed=13)``
    (2 Mb), at the truth; the same command a second time with ``-arg``,
    which must give the same LogL bit for bit through
    the migration pass's ARG variant (once per segment, nothing else),
    its ``.trees.gz`` holding M rows (from one population to another, with
    leaves) and ``argout.find_segments`` giving tracts of positive length
    (tests/test_migration_inference.py::TestMigrationTracts).  Returns
    (launches, E-step records, the model and data, the profile, the pooled
    migration rate, the walk diagnostics, and the ARG run's launches,
    E-step records and profile)."""
    from smcsmc_tpu_torch.segio import write_seg
    from smcsmc_tpu_torch.sweep_profile import (
        profile_sweep,
        report_lines,
        twopop_data,
        twopop_flags,
    )

    demo, seg = twopop_data()
    problems, logls = [], []
    with tempfile.TemporaryDirectory() as tmp:
        seg_path = os.path.join(tmp, "twopop.seg")
        write_seg(seg_path, seg)
        for run in (0, 1):
            out = os.path.join(tmp, f"out{run}")
            argv = ["-seg", seg_path, "-o", out, "-Np", str(TWOPOP_P), "-EM",
                    "0", *twopop_flags(), "-seed", "7", "-device",
                    DEVICE] + (["-arg"] if run else [])
            # the first run is checked and reported; the second records the
            # ARG
            launches_r, plain, steps_r, records, wall = _run_cli(argv)
            logls.append([r.args[4] for r in steps_r])
            if run:
                arg_launches, arg_steps = launches_r, steps_r
                _log(f"twopop path with -arg ran in {wall:.2f} s "
                     f"wall; kernel launches {launches_r}")
                _log_esteps(steps_r, TWOPOP_P, card)
                _check_launches(launches_r, plain,
                                sum(r.args[2] for r in steps_r), problems,
                                "twopop ARG path", MIGRATION_ARG_PASS)
                problems += _twopop_trees(out)
                continue
            launches, steps = launches_r, steps_r
            shown = " ".join(a for a in argv if a not in (seg_path, out))
            _log(f"twopop path: smc2-torch {shown} ran in {wall:.2f} s "
                 f"wall; kernel launches {launches}; calls of the plain "
                 f"versions {plain}")
            _log_esteps(steps, TWOPOP_P, card)
            if len(steps) != 1:
                raise SystemExit(f"twopop path: {len(steps)} EM iterations")
            _check_launches(launches, plain, sum(r.args[2] for r in steps),
                            problems, "twopop path", MIGRATION_PASS)
            pressure = [r.args[:2] for r in records
                        if r.msg.startswith("approximation pressure")]
            _log(f"  migration walks capped and events dropped, per E-step "
                 f"with any: {pressure or 'none'}")
            pooled = _check_twopop(_read_out(os.path.join(out, "result.out"),
                                             0), 0, problems, True)
    _log(f"twopop path: LogL {logls[0]} and, the same seed again with -arg, "
         f"{logls[1]}: bit for bit equal {logls[0] == logls[1]}")
    if logls[0] != logls[1]:
        problems.append("the same seed gave another LogL")
    if problems:
        raise SystemExit("twopop path checks failed: " + "; ".join(problems))
    _log("twopop path checks: ok")
    rep = profile_sweep(demo, seg, TWOPOP_P, DEVICE, **PROFILE_WINDOW)
    _log(f"twopop path sweep profile on {card}:")
    for ln in report_lines(rep):
        _log(ln)
    # the same profile with -vb: the migration pass's VB variant in the sweep
    rep["vb"], vb_launches = _profile(card, "twopop path with -vb", demo, seg,
                                      TWOPOP_P, vb=True)
    launches[MIGRATION_VB_PASS] = vb_launches[MIGRATION_VB_PASS]
    if (vb_launches[MIGRATION_VB_PASS] == 0
            or vb_launches[MIGRATION_PASS] != 0):
        raise SystemExit(f"the twopop sweep with -vb launched {vb_launches}")
    # and with -arg, and -arg -vb: the ARG migration pass in the sweep
    arg_rep, arg_prof_launches = _profile(card, "twopop path with -arg", demo,
                                          seg, TWOPOP_P, record_arg=True)
    _, vb_arg = _profile(card, "twopop path with -arg -vb", demo, seg,
                         TWOPOP_P, record_arg=True, vb=True)
    arg_launches[vb_name(MIGRATION_ARG_PASS)] = \
        vb_arg[vb_name(MIGRATION_ARG_PASS)]
    if (arg_prof_launches[MIGRATION_ARG_PASS] == 0
            or vb_arg[vb_name(MIGRATION_ARG_PASS)] == 0
            or vb_arg[MIGRATION_ARG_PASS] != 0):
        raise SystemExit(f"the twopop sweeps with -arg launched "
                         f"{arg_prof_launches} and {vb_arg}")
    return (launches, steps, demo, seg, rep, pooled, pressure, arg_launches,
            arg_steps, arg_rep)


def _check_mig_launches(launches, plain, want, problems, path):
    """Each pass of ``want`` ({pass: launches}) launched as often as it
    says, every other pass and ``trip`` never, no plain version."""
    for name in LAUNCH_COUNTS:
        if launches[name] != want.get(name, 0):
            problems.append(f"{name} launched {launches[name]} times on the "
                            f"{path} (want {want.get(name, 0)})")
    for entry in ("trip", WIDE_TRIP):
        if launches[entry] != 0:
            problems.append(f"{entry} launched {launches[entry]} times on "
                            f"the {path}")
    if any(plain.values()):
        problems.append(f"the {path} ran a plain version: {plain}")


def phase_twopop_proposal(card):
    """bench.py's twopop_em_iter data through smcsmc_main with the
    production proposal and with the guide loop, each ``-Np 10000 -EM 1``
    with the flags of ``sweep_profile.twopop_flags``:

    A. ``TWOPOP_PROPOSAL_FLAGS`` (``-bias_heights 0 0.05 -calibrate_lag 2
       -delay_migr``): the biased migration pass once per segment of each
       E-step, the migration pass exactly as often as the lag calibration
       pre-passes log (one trip per launch), nothing else, no plain
       version; the calibrated strengths and lags logged;
    B. ``-alpha 0.5``: iteration 0 records its windows with the local
       migration pass once per segment into ``emiter0/chunk0.recomb.gz``
       (20,000 windows), iteration 1 sweeps on the smoothed guide (the log
       names it) with the guided local migration pass once per segment;
       nothing else.

    Each iteration's estimates checked as the twopop path checks its later
    iterations (``_check_twopop`` without the per-population epochs);
    each run's profile (run B's of iteration 1's setup).  Returns
    ({run: launches}, {run: E-step records}, {run: profile}, calibration
    launches logged)."""
    from smcsmc_tpu_torch.segio import write_seg
    from smcsmc_tpu_torch.sweep_profile import (
        TWOPOP_PROPOSAL_FLAGS,
        TWOPOP_PROPOSAL_OPTIONS,
        twopop_data,
        twopop_flags,
    )

    demo, seg = twopop_data()
    problems = []
    launches, steps, reps = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        seg_path = os.path.join(tmp, "twopop.seg")
        write_seg(seg_path, seg)
        for run, extra in (("A", TWOPOP_PROPOSAL_FLAGS),
                           ("B", ["-alpha", "0.5"])):
            out = os.path.join(tmp, f"out{run}")
            argv = ["-seg", seg_path, "-o", out, "-Np", str(TWOPOP_P), "-EM",
                    "1", *twopop_flags(), *extra, "-seed", "7", "-device",
                    DEVICE]
            got, plain, st, records, wall = _run_cli(argv)
            launches[run], steps[run] = got, st
            segs = [r.args[2] for r in st]
            shown = " ".join(a for a in argv if a not in (seg_path, out))
            _log(f"twopop {run}: smc2-torch {shown} ran in {wall:.2f} s "
                 f"wall; kernel launches {got}; calls of the plain versions "
                 f"{plain}; LogL by iteration {[r.args[4] for r in st]!r}")
            _log_esteps(st, TWOPOP_P, card)
            if len(st) != 2:
                raise SystemExit(f"twopop {run}: {len(st)} EM iterations")
            if run == "A":
                reported = sum(r.args[0] for r in records
                               if r.msg.startswith("survival calibration:"))
                for r in records:
                    m = r.getMessage()
                    if m.startswith(("auto-calibrated bias_strengths",
                                     "calibrated lags",
                                     "survival calibration")):
                        _log("  log: " + m)
                if reported == 0 or not any(
                        r.getMessage().startswith("calibrated lags")
                        for r in records):
                    problems.append("A: no lag calibration logged")
                want = {MIG_BIASED_PASS: sum(segs), MIGRATION_PASS: reported}
            else:
                want = {MIG_LOCAL_PASS: segs[0], MIG_GUIDE_LOCAL_PASS: segs[1]}
                guide = os.path.join(out, "emiter1", "chunk0.recomb_guide.gz")
                windows, opp, cnt = recomb_totals(os.path.join(
                    out, "emiter0", "chunk0.recomb.gz"))
                read = [r for r in records if "guide" in r.getMessage()
                        and r.getMessage().startswith("iteration 1")]
                _log(f"twopop B: iteration 0's .recomb.gz {windows} windows, "
                     f"opportunity {opp:.6g}, leaf counts {cnt:.6g}; "
                     f"{read[0].getMessage() if read else 'no guide read'}")
                if windows != 20000 or not opp > 0 or not cnt > 0:
                    problems.append(f"B: iteration 0's .recomb.gz has "
                                    f"{windows} windows, {opp} opportunity")
                if not os.path.exists(guide) or not read:
                    problems.append("B: iteration 1 did not read a smoothed "
                                    "guide")
            _check_mig_launches(got, plain, want, problems, f"twopop {run}")
            for it in range(2):
                _check_twopop(_read_out(os.path.join(out, "result.out"), it),
                              it, problems, False)
            if run == "B":
                reps["B"], _ = _profile(card, "twopop B (iteration 1: "
                                        "guided, recording)", demo, seg,
                                        TWOPOP_P, alpha=0.5,
                                        guide_file=guide)
    if problems:
        raise SystemExit("twopop proposal checks failed: "
                         + "; ".join(problems))
    _log("twopop proposal path checks: ok")
    reps["A"], prof = _profile(card, "twopop A (production proposal)", demo,
                               seg, TWOPOP_P, **TWOPOP_PROPOSAL_OPTIONS)
    if prof[MIG_BIASED_PASS] == 0:
        raise SystemExit(f"the twopop A profile launched {prof}")
    return launches, steps, reps, reported


def mig_proposal_sweeps(card, segments=30):
    """The proposal variants of the migration pass that neither run of
    :func:`phase_twopop_proposal` takes, each driven over the first
    ``segments`` segments of the twopop data at P=10,000 by
    :func:`_short_sweep`: the guided biased pass (``-guide``, a constant
    guide, with bias), the biased local pass (-alpha with bias) and the
    VB variant of every one.  The bias strengths are given (4 1), so no
    calibration runs.  Returns {pass: launches}."""
    from smcsmc_tpu_torch.sweep_profile import twopop_data

    demo, seg = twopop_data()
    bias = dict(bias_heights=(2000.0,), bias_strengths=(4.0, 1.0),
                delay_type="migr")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        guide = write_constant_guide(os.path.join(tmp, "g.recomb_guide.gz"),
                                     demo)
        runs = {MIG_GUIDE_PASS: dict(guide_file=guide, **bias),
                MIG_BIASED_LOCAL_PASS: dict(alpha=0.5, **bias)}
        for name, opts in ((MIG_BIASED_PASS, bias),
                           (MIG_GUIDE_PASS, runs[MIG_GUIDE_PASS]),
                           (MIG_LOCAL_PASS, dict(alpha=0.5)),
                           (MIG_BIASED_LOCAL_PASS,
                            runs[MIG_BIASED_LOCAL_PASS]),
                           (MIG_GUIDE_LOCAL_PASS, dict(guide_file=guide,
                                                       alpha=0.5))):
            runs[vb_name(name)] = dict(opts, vb=True)
        for name, opts in runs.items():
            guide_file = opts.pop("guide_file", None)
            out[name] = _short_sweep(card, name, demo, seg, segments,
                                     guide_file=guide_file, **opts)[name]
    return out


def _twopop_trees(out):
    """The problems of a twopop run's ``emiter0/chunk0.trees.gz``: it must
    hold M rows, each between two populations and with leaves, R/C rows
    with leaves within the full mask, and ``find_segments`` tracts of
    positive length in one direction or the other."""
    import numpy as np

    from smcsmc_tpu_torch.argout import find_segments, read_trees

    from smcsmc_tpu_torch.sweep_profile import twopop_data

    L = float(twopop_data()[0].sequence_length)
    path = os.path.join(out, "emiter0", "chunk0.trees.gz")
    ev = read_trees(path)
    m = ev[ev["code"] == "M"]
    bad, rc = _rc_rows(ev, 4)
    tracts = [find_segments(path, a, b, sequence_length=L)
              for a, b in ((0, 1), (1, 0))]
    lengths = [float((t["right"] - t["left"]).sum()) if len(t) else 0.0
               for t in tracts]
    _log(f"  twopop emiter0/chunk0.trees.gz: {len(ev)} rows, {len(m)} M "
         f"rows, {rc} R/C rows ({bad} with empty or too wide leaves); "
         f"tracts 0->1 {len(tracts[0])} ({lengths[0]:.0f} bp), 1->0 "
         f"{len(tracts[1])} ({lengths[1]:.0f} bp)")
    problems = []
    if not len(m) or np.any(m["from"] == m["to"]) or np.any(m["desc"] == 0):
        problems.append(f"M rows {len(m)}")
    if bad:
        problems.append(f"{bad} R/C rows with bad leaves")
    if not any(len(t) and np.all(t["right"] > t["left"]) for t in tracts):
        problems.append("no tract of positive length")
    return problems




def _run_wide(argv, seg):
    """``seg`` written to a .seg file and swept by ``smcsmc_main`` with the
    main path's command and ``argv`` after it (``-EM`` replaced where
    given); returns what :func:`_run_cli` returns and the rows of
    ``result.out`` by iteration."""
    from smcsmc_tpu_torch.segio import write_seg

    with tempfile.TemporaryDirectory() as tmp:
        seg_path = os.path.join(tmp, "wide.seg")
        write_seg(seg_path, seg)
        out = os.path.join(tmp, "out")
        cmd = _main_argv(seg_path, out)
        if "-EM" in argv:
            i = argv.index("-EM")
            cmd[cmd.index("-EM") + 1] = argv[i + 1]
            argv = argv[:i] + argv[i + 2:]
        launches, plain, steps, records, wall = _run_cli(cmd + argv)
        rows = [_read_out(os.path.join(out, "result.out"), it)
                for it in range(len(steps))]
    return launches, plain, steps, records, wall, rows


def _short_sweep(card, name, demo, seg, segments=60, guide_file=None,
                 **options):
    """The first ``segments`` segments of ``seg`` swept at P=10,000 with the
    ``EMConfig`` ``options`` (and the recombination guide ``guide_file``),
    without the profiler, the launch counts set to 0 before and read after:
    the pass ``name`` must launch once per segment and no other pass.
    Returns the launches."""
    import torch

    from smcsmc_tpu_torch.em import EMConfig, start_sweep

    reset_counts()
    state, segs, step, _, _ = start_sweep(
        demo, seg, EMConfig(num_particles=10000, device=DEVICE, **options),
        seed=7, guide_file=guide_file)
    for k in range(segments):
        state, _ = step(state, segs[k])
    torch.cuda.synchronize()
    n = read_counts()
    others = {k: v for k, v in n.items() if v and k != name}
    _log(f"short sweep of {name} on {card}: {n[name]} launches over "
         f"{segments} segments" + (f"; others {others}" if others else ""))
    if n[name] != segments or others:
        raise SystemExit(f"the sweep of {name} launched {n}")
    return n


def phase_wide_path(card):
    """bench.py's headline demography with n=16 (``sweep_profile.wide_data``,
    2 Mb) through smcsmc_main with the main path's command at one E-step
    (``-Np 10000 -EM 0``: the wide passes' time is on the wide biased path
    too): the wide pass once per segment, nothing else,
    estimates as on the main path; a profile, and a short sweep with
    ``-vb`` (the wide pass's VB variant, :func:`_short_sweep`).  Returns
    (launches, E-step records, the profile, the data's mean segment
    length)."""
    from smcsmc_tpu_torch.segio import split_long_segments
    from smcsmc_tpu_torch.sweep_profile import wide_data

    demo, seg = wide_data()
    launches, plain, steps, _, wall, rows = _run_wide(["-EM", "0"], seg)
    _log(f"wide path (n=16): smc2-torch -Np {WIDE_P} -EM 0 ran in "
         f"{wall:.2f} s wall; kernel launches {launches}; calls of the "
         f"plain versions {plain}")
    _log_esteps(steps, WIDE_P, card)
    _log(f"wide path: LogL by iteration {[r.args[4] for r in steps]!r} "
         f"(in full)")
    problems = []
    if len(steps) != 1:
        problems.append(f"{len(steps)} EM iterations logged")
    _check_estimates(rows[-1], len(rows) - 1, problems)
    _check_launches(launches, plain, sum(r.args[2] for r in steps), problems,
                    "wide path", WIDE_PASS)
    if problems:
        raise SystemExit("wide path checks failed: " + "; ".join(problems))
    _log("wide path checks: ok")
    _elapsed("the wide path's run")
    rep, _ = _profile(card, "wide path (n=16, E=9)", demo, seg, WIDE_P)
    launches[WIDE_VB_PASS] = _short_sweep(card, WIDE_VB_PASS, demo, seg,
                                          vb=True)[WIDE_VB_PASS]
    mean_len = float(split_long_segments(seg, MAX_SEG).lengths.mean())
    return launches, steps, rep, mean_len


def phase_wide_biased_path(card):
    """The wide path's command with the production proposal
    (``BIASED_FLAGS``) and one E-step: the wide biased pass once per
    segment, the wide ``trip`` as often as the lag calibration's pre-passes
    report (more than 0), nothing else, estimates as on the main path; a
    profile with the proposal, and a short sweep of the biased pass with
    ``-vb`` (its VB variant; bias strengths from the model, lags not
    calibrated).  Returns (launches, E-step records, trip launches
    reported, the profile)."""
    from smcsmc_tpu_torch.sweep_profile import BIASED_OPTIONS, wide_data

    demo, seg = wide_data()
    launches, plain, steps, records, wall, rows = _run_wide(
        ["-EM", "0"] + BIASED_FLAGS, seg)
    _log(f"wide biased path (n=16): smc2-torch -Np {WIDE_P} -EM 0 "
         f"{' '.join(BIASED_FLAGS)} ran in {wall:.2f} s wall; kernel "
         f"launches {launches}; calls of the plain versions {plain}")
    _log_esteps(steps, WIDE_P, card)
    _log(f"wide biased path: LogL {[r.args[4] for r in steps]!r} (in full)")
    reported = sum(r.args[0] for r in records
                   if r.msg.startswith("survival calibration:"))
    for r in records:
        m = r.getMessage()
        if m.startswith(("auto-calibrated bias_strengths", "calibrated lags",
                         "survival calibration")):
            _log("  log: " + m)
    problems = []
    if len(steps) != 1:
        problems.append(f"{len(steps)} EM iterations logged")
    _check_launches(launches, plain, sum(r.args[2] for r in steps), problems,
                    "wide biased path", BIASED_WIDE_PASS)
    if launches[WIDE_TRIP] == 0 or launches[WIDE_TRIP] != reported:
        problems.append(f"{WIDE_TRIP} launched {launches[WIDE_TRIP]} times, "
                        f"the calibration pre-passes report {reported}")
    _check_estimates(rows[0], 0, problems)
    if problems:
        raise SystemExit("wide biased path checks failed: "
                         + "; ".join(problems))
    _log("wide biased path checks: ok")
    _elapsed("the wide biased path's run")
    rep, _ = _profile(card, "wide biased path (n=16, E=9)", demo, seg,
                      WIDE_P, **BIASED_OPTIONS)
    launches[BIASED_WIDE_VB_PASS] = _short_sweep(
        card, BIASED_WIDE_VB_PASS, demo, seg, vb=True,
        bias_heights=BIASED_OPTIONS["bias_heights"])[BIASED_WIDE_VB_PASS]
    return launches, steps, reported, rep


def phase_wide64_path(card):
    """The wide kernels' cap: bench.py's headline demography with n=64
    over 200 kb (``sweep_profile.wide64_data``) swept once (``-EM 0``) at
    P=10,000 through smcsmc_main: the wide pass once per segment, a finite
    negative LogL and more than one coalescence counted (what
    tests/test_large_n.py asks of the JAX package at n=64).  Returns
    (launches, E-step records, the data's mean segment length)."""
    from smcsmc_tpu_torch.segio import split_long_segments
    from smcsmc_tpu_torch.sweep_profile import wide64_data

    import numpy as np

    demo, seg = wide64_data()
    launches, plain, steps, _, wall, rows = _run_wide(["-EM", "0"], seg)
    _log_esteps(steps, WIDE_P, card)
    logl = [float(r["Count"]) for r in rows[0] if r["Type"] == "LogL"]
    coal = sum(float(r["Count"]) for r in rows[0] if r["Type"] == "Coal")
    _log(f"n=64 sweep: smc2-torch -Np {WIDE_P} -EM 0 over 200 kb ran in "
         f"{wall:.2f} s wall; kernel launches {launches}; LogL {logl}; "
         f"{coal:.1f} coalescences counted")
    problems = []
    if len(logl) != 1 or not np.isfinite(logl[0]) or logl[0] >= 0:
        problems.append(f"LogL {logl}")
    if not coal > 1.0:
        problems.append(f"{coal} coalescences counted")
    _check_launches(launches, plain, sum(r.args[2] for r in steps), problems,
                    "n=64 sweep", WIDE_PASS)
    if problems:
        raise SystemExit("n=64 sweep checks failed: " + "; ".join(problems))
    _log("n=64 sweep checks: ok")
    return launches, steps, float(
        split_long_segments(seg, MAX_SEG).lengths.mean())


def _tree_problems(tb, L, n):
    """tests/test_tskit_conversion.py::_check_trees_valid as a list of
    problems: at 7 positions a full binary tree (2n - 2 edges, every child
    one parent, every leaf present, parents above children)."""
    import numpy as np

    problems = []
    edges = tb["edges"]
    if len(edges) < 2 * n - 2 or not np.all(edges["right"] > edges["left"]):
        problems.append(f"{len(edges)} edges")
    t = tb["nodes"]["time"]
    for x in np.linspace(1.0, L - 1.0, 7):
        cover = edges[(edges["left"] <= x) & (x < edges["right"])]
        children, counts = np.unique(cover["child"], return_counts=True)
        if (len(cover) != 2 * n - 2 or not np.all(counts == 1)
                or not set(range(n)) <= set(children.tolist())
                or not np.all(t[cover["parent"]] > t[cover["child"]])):
            problems.append(f"no full binary tree at {x:.0f} "
                            f"({len(cover)} edges)")
    return problems


def _rc_rows(ev, n):
    """The R and C rows of a .trees.gz whose leaves are empty or beyond the
    full mask of n leaves, and how many R/C rows it has."""
    import numpy as np

    rc = ev[(ev["code"] == "R") | (ev["code"] == "C")]
    full = np.uint64((1 << n) - 1) if n < 64 else np.uint64(2 ** 64 - 1)
    bad = int(((rc["desc"] == 0) | (rc["desc"] > full)).sum())
    return bad, len(rc)


def phase_arg_main_path(card, seg, main_steps):
    """The main path's command with ``-arg`` (``-Np 10000 -EM 1``): the ARG
    plain pass once per segment of each E-step and nothing else, each
    iteration's LogL bit for bit the main path's (the ARG variant draws
    nothing and changes no weight), each ``emiter{it}/chunk0.trees.gz``
    with every R/C row's leaves nonzero and within the full mask, and the
    copied ``argout.build_tables`` giving a full binary tree at 7
    positions.  Returns (launches, E-step records)."""
    from smcsmc_tpu_torch.argout import build_tables, read_trees
    from smcsmc_tpu_torch.segio import write_seg

    problems = []
    with tempfile.TemporaryDirectory() as tmp:
        seg_path = os.path.join(tmp, "bench.seg")
        write_seg(seg_path, seg)
        out = os.path.join(tmp, "out")
        launches, plain, steps, _, wall = _run_cli(
            _main_argv(seg_path, out) + ["-arg"])
        _log(f"ARG main path: smc2-torch -Np 10000 -EM 1 -arg ran in "
             f"{wall:.2f} s wall; kernel launches {launches}")
        _log_esteps(steps, 10000, card)
        _check_launches(launches, plain, sum(r.args[2] for r in steps),
                        problems, "ARG main path", ARG_PASS)
        logl, main = [r.args[4] for r in steps], [r.args[4]
                                                  for r in main_steps]
        _log(f"ARG main path: LogL by iteration {logl!r}, the main path's "
             f"{main!r}: bit for bit equal {logl == main}")
        if logl != main:
            problems.append("LogL differs from the main path's")
        for it in range(len(steps)):
            ev = read_trees(os.path.join(out, f"emiter{it}",
                                         "chunk0.trees.gz"))
            bad, rc = _rc_rows(ev, 4)
            tp = _tree_problems(build_tables(ev, float(seg.end)),
                                float(seg.end), 4)
            _log(f"  emiter{it}/chunk0.trees.gz: {len(ev)} rows, {rc} R/C "
                 f"rows, {bad} with empty or too wide leaves; trees at 7 "
                 f"positions {'full and binary' if not tp else tp}")
            if bad or tp or rc < 3:
                problems.append(f"emiter{it} trees: {bad} bad rows, {tp}")
    if problems:
        raise SystemExit("ARG main path checks failed: "
                         + "; ".join(problems))
    _log("ARG main path checks: ok")
    return launches, steps


def ring_gather_cost(P=10000, A=ARG_A, repeats=20):
    """What the ARG ring's gather costs at each resampling: the seven
    ``index_select`` of ``smc.gather_particles`` on a ring of P x A slots
    (19 B a slot), device time per gather by CUDA events over ``repeats``
    gathers, beside its bound (the ring read and written once)."""
    import torch

    from smcsmc_tpu_torch.kernels.arg import ARG_FIELDS

    gen = torch.Generator(device=DEVICE).manual_seed(5)
    ring = arg_ring(P, 4, gen, A)
    idx = torch.randint(0, P, (P,), generator=gen, device=DEVICE)

    def gather(_):
        for k in ARG_FIELDS:
            ring[k].index_select(0, idx)
    gather(None)
    ms = _device_ms(gather, range(repeats), _filler())
    nbytes = 2 * sum(ring[k].element_size() * ring[k].numel()
                     for k in ARG_FIELDS)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    _log(f"ARG ring gather at P={P}, A={A}: {ms * 1e3:.2f} us of device "
         f"time per resampling (7 index_select), bound {bound * 1e3:.2f} us "
         f"by bytes ({nbytes} B read and written)")
    return {"P": P, "A": A, "ms": ms, "bound_ms": bound, "bytes": nbytes}


def phase_arg_wide(card):
    """The wide ARG pass in short sweeps: bench.py's headline demography
    with n=16 (60 segments at P=10,000, ``record_arg``) and n=64 over 200
    kb (30 segments): the ARG wide pass once per segment and no other
    pass, every pushed R/C row's leaves nonzero and within the full mask,
    at n=64 a pushed row reaching leaf 63.  Returns (launches by data,
    the n=16 data's profile)."""
    import torch

    from smcsmc_tpu_torch.em import EMConfig, start_sweep
    from smcsmc_tpu_torch.sweep_profile import wide64_data, wide_data

    out = {}
    problems = []
    for label, (demo, seg), segments in (("n=16", wide_data(), 60),
                                         ("n=64", wide64_data(), 30)):
        n = demo.num_samples
        reset_counts()
        state, segs, step, _, _ = start_sweep(
            demo, seg, EMConfig(num_particles=WIDE_P, device=DEVICE,
                                record_arg=True), seed=7)
        n0 = state.arg_n.clone()
        for k in range(segments):
            state, _ = step(state, segs[k])
        torch.cuda.synchronize()
        counts = read_counts()
        others = {k: v for k, v in counts.items()
                  if v and k != WIDE_ARG_PASS}
        out[label] = counts
        # the rows pushed in these segments (fewer than A per particle)
        A = state.arg_code.shape[1]
        new = (state.arg_n - n0).long()
        k = torch.arange(A, device=new.device)
        slot = (n0.long()[:, None] + k[None, :]) % A
        mine = (k[None, :] < new[:, None]) & (new[:, None] <= A)
        code = state.arg_code.gather(1, slot)
        desc = state.arg_desc.gather(1, slot)
        rc = mine & (code <= 1)
        # leaves empty, or (below 64 leaves) beyond the full mask
        bad_leaves = ((desc <= 0) | (desc > (1 << n) - 1) if n < 64
                      else desc == 0)
        bad = int((rc & bad_leaves).sum())
        top = int((rc & (desc < 0)).sum())
        _log(f"ARG wide short sweep {label} on {card}: "
             f"{counts[WIDE_ARG_PASS]} launches over {segments} segments, "
             f"{int(rc.sum())} R/C rows pushed, {bad} with empty or too "
             f"wide leaves, {top} reaching leaf 63"
             + (f"; others {others}" if others else ""))
        if counts[WIDE_ARG_PASS] != segments or others or bad \
                or not int(rc.sum()) or (n == 64 and not top):
            problems.append(f"{label}: {counts[WIDE_ARG_PASS]} launches, "
                            f"others {others}, {bad} bad rows, {top} at "
                            "leaf 63")
    if problems:
        raise SystemExit("ARG wide checks failed: " + "; ".join(problems))
    _log("ARG wide checks: ok")
    demo, seg = wide_data()
    rep, _ = _profile(card, "wide path (n=16) with -arg", demo, seg, WIDE_P,
                      record_arg=True)
    return out, rep


def phase_time_arg(kernels, lengths, parents):
    """Each ARG pass timed beside its parent pass on the inputs that
    ``phase_time`` / ``phase_time_migration`` timed the parent on (the
    same shape, segment length and seed; ``lengths`` maps a pass to its
    data's mean segment length, ``parents`` to the parent's timed row), in
    turns (parent, ARG, ARG, parent; best of 3 x 20 launches each), with
    a ring in use: device time per launch of both, host time per wrapper
    call, the plain version's time and the bound: the parent's counted
    work plus the ring's (every particle's ``arg_n`` read, a recombining
    particle's written, 19 B per row pushed; per trip the leaves' walks up
    the tree, two compares per node and leaf)."""
    from smcsmc_tpu_torch.kernels.bias import BiasedPass
    from smcsmc_tpu_torch.kernels.migration import MigrationPass

    segment_pass, segment_pass_plain = kernels["segment_pass"]
    filler = _filler()
    rows = {}
    for name, parent in ARG_PARENTS.items():
        vb = "vb" in name
        L = lengths[name]
        if "migration" in name:
            c, u = _mig_timing_case(TWOPOP_P, L)
            fresh0 = c.fresh

            def run(fn, u, st, with_arg=True, c=c):
                mp = MigrationPass(st["pop"], st["mig_time"],
                                   st["mig_dest"], st["diag"], c.key,
                                   *c.tables)
                fn(u, c.leaf_status, *(st[k] for k in SEGMENT_STATE),
                   st["fifo"], c.fifo_mask, st["tl"], c.L, MU, RHO, c.start,
                   c.inv2ne, c.has_data, None, mp, vb=tables,
                   arg=_arg_of(st) if with_arg else None)
                return st
        else:
            n = 16 if "wide" in name else 8 if "biased" in name else 4
            E = 33 if "biased" in name else 9
            c, u = _timing_case(10000, n, E, L)
            biased = "biased" in name
            fresh0 = (c.fresh_biased if biased else c.fresh_segment)

            def run(fn, u, st, with_arg=True, c=c, biased=biased):
                bp = (BiasedPass(st["log_pilot"], st["df_pos"],
                                 st["df_logf"], st["df_delta"], st["df_k"],
                                 *c.bias_tables, BIAS_FRONT)
                      if biased else None)
                fn(u, c.leaf_status, *(st[k] for k in SEGMENT_STATE),
                   st["fifo"], c.fifo_mask, st["tl"], c.L, MU, RHO, c.start,
                   c.inv2ne, c.has_data, bp, vb=tables,
                   arg=_arg_of(st) if with_arg else None)
                return st
        tables = vb_tables(c.demo, 5) if vb else None
        fresh0()  # draws the biased pass's ring as phase_time did
        aring = arg_ring(c.P, c.n, c.gen)

        def fresh(fresh0=fresh0, aring=aring):
            st = fresh0()
            st.update({k: v.clone() for k, v in aring.items()})
            return st
        st = run(segment_pass, u, fresh())
        pushed = _arg_rows(st, aring)
        active = int((c.base["next_rec"] < L).sum())
        trips = pushed // 2 if "migration" not in name \
            else parents[name]["trips"]
        N = 2 * c.n - 1
        prow = parents[name]
        bound = _bound_of(prow["bytes"] + 4 * c.P + 4 * active + 19 * pushed,
                          prow["flop"] + trips * 2 * c.n * N)

        def launch(st, run=run, u=u):
            run(segment_pass, u, st)

        def launch_parent(st, run=run, u=u):
            run(segment_pass, u, st, False)
        turns = [_best_device_ms(fn, fresh, filler) for fn in (
            launch_parent, launch, launch, launch_parent)]
        t = dict(kernel_ms=min(turns[1:3]),
                 parent_ms=min(turns[0], turns[3]), turns_ms=turns,
                 plain_ms=_plain_ms(run, segment_pass_plain, u, fresh),
                 host_us=_host_us(launch, [fresh() for _ in range(20)]),
                 rows_pushed=pushed, active=active, trips=trips, L=L,
                 **bound)
        rows[name] = t
        _log(f"time {name} at L={L:g} bp (P={c.P} n={c.n} E={c.E}): "
             f"kernel {t['kernel_ms'] * 1e3:.2f} us per launch beside "
             f"{parent} {t['parent_ms'] * 1e3:.2f} us (turns parent, ARG, "
             f"ARG, parent: {', '.join(f'{x * 1e3:.2f}' for x in turns)} "
             f"us); host {t['host_us']:.2f} us per call; plain "
             f"{t['plain_ms']:.4f} ms; {pushed} rows pushed by {active} "
             f"particles; bound {t['bound_ms'] * 1e3:.3f} us by "
             f"{t['bound_by']} ({t['bytes']} B, {t['flop']} FLOP), kernel "
             f"reaches {t['bound_ms'] / t['kernel_ms']:.4f} of it")
    return rows


def vb_tables(demo, seed):
    """VB tables on the card as the sweep passes them (em.vb_pass_tables):
    from event counts drawn in [0.05, 5] with epoch ``XC_EPOCH`` excluded,
    so that each coalescence and migration adds a term of order 0.1-1 (the
    tables of iteration 0, from counts of 1e10, add about -5e-11, which
    vanishes in f32 and would compare zeros)."""
    import numpy as np
    import torch

    from smcsmc_tpu_torch.em import EMConfig, vb_pass_tables

    rng = np.random.default_rng(seed)
    E, Pp = demo.num_epochs, demo.num_populations
    counts = (rng.uniform(0.05, 5.0, (E, Pp)),
              rng.uniform(0.05, 5.0, (E, Pp, Pp)))
    coal, mig = vb_pass_tables(demo, counts, EMConfig(vb=True,
                                                      xc_epochs=(XC_EPOCH,)))
    return tuple(torch.as_tensor(x, device=DEVICE).contiguous()
                 for x in (coal, mig))


REPLACES = "smcsmc_tpu/kernels/pallas_trip.py:91"
# (entry name, kernel_resources variant, (shape label, its arguments))
RESOURCE_SHAPES = (
    ("trip", "trip", (("main (n=4, E=9)", (4, 9)),
                      ("genome (n=8, E=33)", (8, 33)))),
    ("segment_pass", "segment_pass", (("main (n=4, E=9)", (4, 9)),
                                      ("genome (n=8, E=33)", (8, 33)))),
    (BIASED_PASS, "biased", (
        ("main (n=4, E=9, S=2)", (4, 9)), ("genome (n=8, E=33, S=2)", (8, 33)),
        ("caps (n=8, E=64, S=8)", (8, 64, 1, 0, 8)))),
    (MIGRATION_PASS, "migration", (
        ("twopop (n=4, E=8, Pp=2, Mw=56)", (4, 8, 2, TWOPOP_MW)),
        ("caps (n=8, E=64, Pp=4, Mw=96)", (8, 64, 4, 96)))),
    # the VB variants (kernel_resources(..., vb=True))
    (VB_PASS, "segment_pass", (
        ("main (n=4, E=9)", (4, 9, 1, 0, 2, True)),
        ("genome (n=8, E=33)", (8, 33, 1, 0, 2, True)))),
    (BIASED_VB_PASS, "biased", (
        ("genome (n=8, E=33, S=2)", (8, 33, 1, 0, 2, True)),
        ("caps (n=8, E=64, S=8)", (8, 64, 1, 0, 8, True)))),
    (MIGRATION_VB_PASS, "migration", (
        ("twopop (n=4, E=8, Pp=2, Mw=56)", (4, 8, 2, TWOPOP_MW, 2, True)),
        ("caps (n=8, E=64, Pp=4, Mw=96)", (8, 64, 4, 96, 2, True)))),
) + tuple(
    # the guided and local passes (kernel_resources(..., guide=, local=))
    (name, "biased" if flags[0] else "segment_pass", (
        ("main (n=4, E=9)", (4, 9, 1, 0, 2, "vb" in name, *flags[1:])),
        ("genome (n=8, E=33)", (8, 33, 1, 0, 2, "vb" in name, *flags[1:])))
     + ((("caps (n=8, E=64, S=8)", (8, 64, 1, 0, 8, "vb" in name,
                                      *flags[1:])),) if flags[0] else ()))
    for name, (flags, _) in GUIDE_PASSES.items()) + (
    # the wide kernels at the wide path's shape (n=16), at n=64 and, for
    # the biased pass, at its caps
    (WIDE_TRIP, "trip", (("wide (n=16, E=9)", (16, 9)),
                         ("n=64 (n=64, E=9)", (64, 9)))),
    (WIDE_PASS, "segment_pass", (("wide (n=16, E=9)", (16, 9)),
                                 ("n=64 (n=64, E=9)", (64, 9)),
                                 ("n=64 (n=64, E=64)", (64, 64)))),
    (WIDE_VB_PASS, "segment_pass", (
        ("wide (n=16, E=9)", (16, 9, 1, 0, 2, True)),
        ("n=64 (n=64, E=9)", (64, 9, 1, 0, 2, True)))),
    (BIASED_WIDE_PASS, "biased", (
        ("wide (n=16, E=9, S=2)", (16, 9)), ("n=64 (n=64, E=9, S=2)", (64, 9)),
        ("caps (n=64, E=64, S=8)", (64, 64, 1, 0, 8)))),
    (BIASED_WIDE_VB_PASS, "biased", (
        ("wide (n=16, E=9, S=2)", (16, 9, 1, 0, 2, True)),
        ("caps (n=64, E=64, S=8)", (64, 64, 1, 0, 8, True))))) + tuple(
    # the ARG variants (kernel_resources(..., arg=True)) at their paths'
    # shapes and caps
    (name, variant, tuple((label, (*dims, "vb" in name, False, False, True))
                          for label, dims in shapes))
    for base, variant, shapes in (
        (ARG_PASS, "segment_pass", (("main (n=4, E=9)", (4, 9, 1, 0, 2)),
                                    ("genome (n=8, E=33)", (8, 33, 1, 0, 2)))),
        (BIASED_ARG_PASS, "biased", (
            ("genome (n=8, E=33, S=2)", (8, 33, 1, 0, 2)),
            ("caps (n=8, E=64, S=8)", (8, 64, 1, 0, 8)))),
        (MIGRATION_ARG_PASS, "migration", (
            ("twopop (n=4, E=8, Pp=2, Mw=56)", (4, 8, 2, TWOPOP_MW, 2)),
            ("caps (n=8, E=64, Pp=4, Mw=96)", (8, 64, 4, 96, 2)))),
        (WIDE_ARG_PASS, "segment_pass", (("wide (n=16, E=9)", (16, 9, 1, 0, 2)),
                                         ("n=64 (n=64, E=9)", (64, 9, 1, 0, 2)))))
    for name in (base, vb_name(base))) + tuple(
    # the migration pass's proposal variants (kernel_resources("migration",
    # ..., vb, guide, local, biased=)) at the twopop shape and the caps
    (name, "migration", (
        ("twopop (n=4, E=8, Pp=2, Mw=56, S=2)",
         (4, 8, 2, TWOPOP_MW, 2, "vb" in name, g, lo, False, b)),
        ("caps (n=8, E=64, Pp=4, Mw=96, S=8)",
         (8, 64, 4, 96, 8, "vb" in name, g, lo, False, b))))
    for name, (b, g, lo) in MIG_PROPOSAL_PASSES.items())
SOURCE = "smcsmc_tpu_torch/csrc/trip.cu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--until", choices=("build", "compare", "time"),
                    help="stop after this phase (a short first run of a "
                    "changed kernel); no result line is printed then")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no GPU, "
              "nothing measured", file=sys.stderr)
        return 1
    global _T0
    _T0 = time.monotonic()
    elapsed = _elapsed
    sys.path.insert(0, HERE)
    from smcsmc_tpu_torch.kernels import _build
    from smcsmc_tpu_torch.kernels.trip import (
        kernel_resources,
        segment_pass,
        segment_pass_plain,
        trip,
        trip_plain,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    card = smi.splitlines()[0]
    _log(smi)
    _log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
         f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    info = _build.build_trip_library(force=True)
    _log(f"built {os.path.relpath(info.path, HERE)} from "
         f"{os.path.relpath(_build.SOURCE, HERE)} with nvcc "
         f"{' '.join(_build.NVCC_FLAGS)} in {info.seconds:.2f} s "
         f"({_build.TRIP_PARTS} units compiled side by side, then linked)")
    for ln in info.log.splitlines():
        if ("registers" in ln or "spill" in ln or "stack frame" in ln
                or "Compiling entry function" in ln):
            _log("  ptxas: " + ln.strip())
    # what the card grants each kernel at the shapes of the paths and at
    # the caps: registers, stack, shared memory, particles per block and
    # SM, waves at P=10,000
    resources = {name: {shape: kernel_resources(variant, *dims) for shape,
                        dims in shapes}
                 for name, variant, shapes in RESOURCE_SHAPES}
    for name, by_shape in resources.items():
        for shape, res in by_shape.items():
            _log(f"{name} resources at {shape}: "
                 + ", ".join(f"{k} {v}" for k, v in res.items()))
    if args.until == "build":
        return 0
    scan_counts = phase_scan_repeat()

    from smcsmc_tpu_torch.segio import split_long_segments
    from smcsmc_tpu_torch.sweep_profile import (
        bench_data,
        profile_sweep,
        report_lines,
        wide_data,
    )

    # bench.py's headline data (n=4, 2 Mb); the main path sweeps it with
    # the 9 epochs of -P 133 133016 "7*1"
    demo, seg = bench_data()
    mean_len = float(split_long_segments(seg, MAX_SEG).lengths.mean())

    kernels = {"trip": (trip, trip_plain),
               "segment_pass": (segment_pass, segment_pass_plain)}
    tallies = phase_compare(kernels)
    elapsed("compare")
    if not compare_arg(segment_pass, segment_pass_plain, tallies):
        raise SystemExit("an ARG pass disagrees with its plain version")
    elapsed("the ARG compare")
    if args.until == "compare":
        return 0
    empty_ms = time_empty_launch()
    timing = phase_time(kernels, (10000, 4, 9),
                        [("mean bench segment", mean_len),
                         ("longest segment", MAX_SEG)], biased=True,
                        vb=True, guide=True)
    elapsed("the main shape's timing")
    if args.until == "time":
        return 0
    launches, steps, main_resample = phase_main_path(card, seg)
    elapsed("the main path")

    # where the sweep's time goes (after the main path's launch count)
    main_rep = profile_sweep(demo, seg, 10000, "cuda", **PROFILE_WINDOW)
    for ln in report_lines(main_rep):
        _log(ln)

    # the main path's command with -arg: the ARG plain pass, the same LogL
    arg_launches, arg_steps = phase_arg_main_path(card, seg, steps)
    arg_rep, _ = _profile(card, "ARG main path", demo, seg, 10000,
                          record_arg=True)
    _, arg_vb = _profile(card, "ARG main path with -vb", demo, seg, 10000,
                         record_arg=True, vb=True)
    arg_launches[vb_name(ARG_PASS)] = arg_vb[vb_name(ARG_PASS)]
    if arg_vb[vb_name(ARG_PASS)] == 0 or arg_vb[ARG_PASS] != 0:
        raise SystemExit(f"the ARG sweep with -vb launched {arg_vb}")
    gather = ring_gather_cost()
    elapsed("the ARG main path")

    # bench.py's feature_vb and feature_apf on the main path's data, and
    # the lookahead alone at its shape
    # bench.py's feature_bias_guide and the guide loop (-alpha), the
    # passes that no path of the slice runs, the local ops alone
    bg_launches, bg_steps, bg_rep = phase_bias_guide_path(card, seg)
    al_launches, al_steps, al_reps, al_totals = phase_alpha_path(card, seg)
    sweeps = variant_sweeps(card)
    local_cost = local_ops_cost(card)
    elapsed("the bias-guide and alpha paths")

    v_launches, v_steps, v_rep, _ = phase_vb_path(card, seg, steps)
    a_launches, a_steps, a_rep = phase_apf_path(card, seg, main_resample)
    la_cost = {"n=4": lookahead_cost(card, demo, seg)}
    elapsed("the VB and APF paths")

    (g_launches, g_resume_launches, g_steps, g_demo, g_seg, g_chunks,
     g_mean_len) = phase_genome_path(card)
    elapsed("the genome path")
    g_timing = phase_time(kernels, (GENOME_P, 8, 33),
                          [("mean genome segment", g_mean_len),
                           ("longest segment", MAX_SEG)], biased=True,
                          vb=True)
    elapsed("the genome shape's timing")
    _log(f"genome path sweep profile (chunk {g_chunks[0]}, E=33) on {card}:")
    for ln in report_lines(profile_sweep(g_demo, g_seg, GENOME_P, "cuda",
                                         **PROFILE_WINDOW,
                                         chunk=tuple(g_chunks[0]))):
        _log(ln)

    b_launches, b_steps, b_reported, b_profile = phase_biased_path(card)
    elapsed("the biased path")
    # the biased pass's ARG variants in short sweeps of the genome data
    # (no path of the slice runs them), the strengths given so that no
    # calibration launches trip
    ab_launches = {}
    for vb in (False, True):
        name = vb_name(BIASED_ARG_PASS) if vb else BIASED_ARG_PASS
        ab_launches[name] = _short_sweep(
            card, name, g_demo, g_seg, record_arg=True, vb=vb,
            bias_heights=(2000.0,), bias_strengths=(4.0, 1.0))[name]
    elapsed("the biased ARG sweeps")

    # bench.py's feature_apf8 (n=8, missing windows, an unphased pair)
    a8_launches, a8_step, a8_rep, a8_base = phase_apf8_path(card)
    from smcsmc_tpu_torch.sweep_profile import apf8_data

    la_cost["n=8"] = lookahead_cost(card, *apf8_data())
    elapsed("the APF8 path")

    (m_launches, m_steps, m_demo, m_seg, m_profile, m_pooled,
     m_pressure, ma_launches, ma_steps, ma_rep) = phase_twopop_path(card)
    elapsed("the twopop path")
    m_mean_len = float(split_long_segments(m_seg, MAX_SEG).lengths.mean())
    m_timing = phase_time_migration(
        segment_pass, segment_pass_plain,
        [("mean twopop segment", m_mean_len), ("longest segment", MAX_SEG)],
        vb=True)
    elapsed("the migration pass's timing")
    # the production proposal and the guide loop on the twopop data, the
    # proposal variants that neither runs in short sweeps, and each
    # variant's time beside the migration pass
    mp_launches, mp_steps, mp_reps, mp_cal = phase_twopop_proposal(card)
    mp_sweeps = mig_proposal_sweeps(card)
    elapsed("the twopop proposal paths")
    mp_timing = phase_time_mig_proposal(
        segment_pass, segment_pass_plain,
        [("mean twopop segment", m_mean_len), ("longest segment", MAX_SEG)],
        {label: (row["walks"], row["walk_events"])
         for label, row in m_timing.items()})
    elapsed("the proposal variants' timing")

    # the wide kernels' paths (n=16 plain and biased, n=64) and their times
    # at (10,000, 16, 9) and (10,000, 64, 9)
    w_launches, w_steps, w_rep, w_mean = phase_wide_path(card)
    elapsed("the wide path")
    wb_launches, wb_steps, wb_reported, wb_rep = phase_wide_biased_path(card)
    elapsed("the wide biased path")
    w64_launches, w64_steps, w64_mean = phase_wide64_path(card)
    elapsed("the n=64 sweep")
    wa_launches, wa_rep = phase_arg_wide(card)
    _, wa_vb = _profile(card, "wide path (n=16) with -arg -vb", *wide_data(),
                        WIDE_P, record_arg=True, vb=True)
    wa_launches["n=16"][vb_name(WIDE_ARG_PASS)] = \
        wa_vb[vb_name(WIDE_ARG_PASS)]
    if wa_vb[vb_name(WIDE_ARG_PASS)] == 0 or wa_vb[WIDE_ARG_PASS] != 0:
        raise SystemExit(f"the wide ARG sweep with -vb launched {wa_vb}")
    elapsed("the wide ARG sweeps")
    w_timing = phase_time(kernels, (WIDE_P, 16, 9),
                          [("mean wide segment", w_mean),
                           ("longest segment", MAX_SEG)], biased=True,
                          vb=True, names=WIDE_NAMES)
    w64_timing = phase_time(kernels, (WIDE_P, 64, 9),
                            [("mean n=64 segment", w64_mean),
                             ("longest segment", MAX_SEG)], biased=True,
                            vb=True, names=WIDE_NAMES)
    elapsed("the wide passes' timing")
    # each ARG pass beside its parent, on the parent's timed inputs
    mean_w = w_timing["mean wide segment"]
    m_row = m_timing["mean twopop segment"]
    main_t = timing["mean bench segment"]
    genome_t = g_timing["mean genome segment"]
    parents = {ARG_PASS: main_t["segment_pass"], vb_name(ARG_PASS):
               main_t[VB_PASS], BIASED_ARG_PASS: genome_t[BIASED_PASS],
               vb_name(BIASED_ARG_PASS): genome_t[BIASED_VB_PASS],
               MIGRATION_ARG_PASS: m_row,
               vb_name(MIGRATION_ARG_PASS): dict(m_row["vb"],
                                                 trips=m_row["trips"]),
               WIDE_ARG_PASS: mean_w[WIDE_PASS],
               vb_name(WIDE_ARG_PASS): mean_w[WIDE_VB_PASS]}
    lengths = {}
    for name in ARG_PARENTS:
        lengths[name] = (m_mean_len if "migration" in name else w_mean
                         if "wide" in name else g_mean_len
                         if "biased" in name else mean_len)
    a_timing = phase_time_arg(kernels, lengths, parents)
    elapsed("the ARG passes' timing")

    head = timing["mean bench segment"]
    g_head = g_timing["mean genome segment"]
    record = {"kernels": [], "empty_launch_ms": empty_ms,
              "scan_repeat": scan_counts,
              "timed_at": {"P": 10000, "n": 4, "E": 9,
                           "active": head["active"], "trips": head["trips"],
                           "pushed": head["pushed"]},
              "genome_path_timed_at": {
                  "P": GENOME_P, "n": 8, "E": 33, "L": g_head["L"],
                  "active": g_head["active"], "trips": g_head["trips"],
                  "pushed": g_head["pushed"], "moved": g_head["moved"]},
              "biased_path": {
                  "segments": sum(r.args[2] for r in b_steps),
                  "estep_seconds": [r.args[1] for r in b_steps],
                  "trip_launches_reported": b_reported,
                  "launches_per_segment": b_profile["launches_per_segment"],
                  "device_busy_share": b_profile["device_busy_share"],
                  "device_ms_per_segment":
                      b_profile["device_ms_per_segment"],
                  "pass_us_per_launch": b_profile["pass_us_per_launch"],
                  "logl": [r.args[4] for r in b_steps],
                  "ring_census": b_profile["ring_census"]},
              "twopop_path": {
                  "segments": sum(r.args[2] for r in m_steps),
                  "estep_seconds": [r.args[1] for r in m_steps],
                  "logl": [r.args[4] for r in m_steps],
                  "pooled_migration_rate": m_pooled,
                  "walks_capped_events_dropped": m_pressure,
                  "launches_per_segment": m_profile["launches_per_segment"],
                  "device_ms_per_segment":
                      m_profile["device_ms_per_segment"],
                  "device_busy_share": m_profile["device_busy_share"],
                  "pass_us_per_launch": m_profile["pass_us_per_launch"]}}

    def feature(steps_, P, rep, base, nseg=None):
        if nseg is None:
            rows = [(r.args[1], r.args[2]) for r in steps_]
        else:
            rows = [nseg]
        return {"updates_per_s": [P * n / s for s, n in rows],
                "estep_seconds": [s for s, _ in rows],
                "segments": sum(n for _, n in rows),
                "launches_per_segment": rep["launches_per_segment"],
                "device_ms_per_segment": rep["device_ms_per_segment"],
                "device_busy_share": rep["device_busy_share"],
                "pass_us_per_launch": rep["pass_us_per_launch"],
                "added_launches_per_segment":
                    rep["launches_per_segment"] - base["launches_per_segment"],
                "added_device_ms_per_segment":
                    rep["device_ms_per_segment"]
                    - base["device_ms_per_segment"]}

    record["feature_paths"] = {
        "card": card,
        "vb": dict(feature(v_steps, 10000, v_rep, main_rep),
                   logl=[r.args[4] for r in v_steps]),
        "apf": dict(feature(a_steps, 10000, a_rep, main_rep),
                    logl=[r.args[4] for r in a_steps]),
        "apf8": feature(None, 10000, a8_rep, a8_base, nseg=a8_step),
        "biased_vb_profile": {k: b_profile["vb"][k] for k in (
            "launches_per_segment", "device_ms_per_segment",
            "pass_us_per_launch")},
        "twopop_vb_profile": {k: m_profile["vb"][k] for k in (
            "launches_per_segment", "device_ms_per_segment",
            "pass_us_per_launch")},
        "lookahead_loglik": la_cost,
        "bias_guide": dict(feature(bg_steps, 10000, bg_rep, main_rep),
                           logl=[r.args[4] for r in bg_steps]),
        "alpha": dict(feature(al_steps, 10000, al_reps[0], main_rep),
                      logl=[r.args[4] for r in al_steps],
                      recomb_vs_out=al_totals,
                      guided_profile={k: al_reps[1][k] for k in (
                          "launches_per_segment", "device_ms_per_segment",
                          "device_busy_share", "ms_per_segment",
                          "pass_us_per_launch")},
                      guided_added_launches_per_segment=(
                          al_reps[1]["launches_per_segment"]
                          - main_rep["launches_per_segment"])),
        "local_ops": local_cost}
    timed_keys = ("kernel_ms", "plain_ms", "bound_ms", "bound_by")

    def wide_path(steps_, rep):
        return {"updates_per_s": [WIDE_P * r.args[2] / r.args[1]
                                  for r in steps_],
                "estep_seconds": [r.args[1] for r in steps_],
                "segments": sum(r.args[2] for r in steps_),
                "logl": [r.args[4] for r in steps_],
                **{k: rep[k] for k in (
                    "launches_per_segment", "device_ms_per_segment",
                    "device_busy_share", "ms_per_segment",
                    "pass_us_per_launch")}}

    record["wide_paths"] = {
        "card": card,
        "wide": wide_path(w_steps, w_rep),
        "wide_biased": dict(wide_path(wb_steps, wb_rep),
                            trip_launches_reported=wb_reported),
        "n64": {"estep_seconds": [r.args[1] for r in w64_steps],
                "segments": sum(r.args[2] for r in w64_steps),
                "logl": [r.args[4] for r in w64_steps]}}
    for name in (WIDE_TRIP, WIDE_PASS, WIDE_VB_PASS, BIASED_WIDE_PASS,
                 BIASED_WIDE_VB_PASS):
        # launches on the path that runs each: the wide path for the plain
        # pass and its VB variant (from its -vb profile), the wide biased
        # path for the biased pass, its VB variant and trip (the lag
        # calibration); times at (10,000, 16, 9), and at n=64 beside
        single, chained = tallies[name]
        own = ("wide" if name in (WIDE_PASS, WIDE_VB_PASS)
               else "wide biased")
        by_path = {"wide": w_launches[name], "wide biased":
                   wb_launches[name], "n=64": w64_launches[name]}
        t = w_timing["mean wide segment"][name]
        entry = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": by_path[own],
            "launches_on": own, "launches_by_path": by_path,
            "max_abs_err": single.max_abs_err,
            "compare": {"trips=1": single.record(),
                        "trips=64 vs plain": chained.record()},
            "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "host_us_per_call": t["host_us"],
            "resources": resources[name],
            "n64_shape": {label: {k: row[name][k] for k in timed_keys}
                          for label, row in w64_timing.items()
                          if name in row}}
        if name in w_timing["longest segment"]:
            entry["longest_segment"] = {
                k: w_timing["longest segment"][name][k] for k in timed_keys}
        record["kernels"].append(entry)
    for name in GUIDE_PASSES:
        # the guided and local passes: launches on the path of the slice
        # that runs each, or in its own short sweep; times at the main
        # path's shape beside the pass they are a variant of
        single, chained = tallies[name]
        own = {GUIDE_PASS: ("bias_guide", bg_launches),
               LOCAL_PASS: ("alpha", al_launches),
               GUIDE_LOCAL_PASS: ("alpha", al_launches)}.get(name)
        t = head[name]
        parent = GUIDE_PASSES[name][1]
        entry = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES,
            "launches": own[1][name] if own else sweeps[name],
            "launches_on": own[0] if own else "its own sweep",
            "launches_by_path": {"bias_guide": bg_launches[name],
                                 "alpha": al_launches[name]},
            "max_abs_err": single.max_abs_err,
            "compare": {"trips=1": single.record(),
                        "trips=64 vs plain": chained.record()},
            "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "host_us_per_call": t["host_us"],
            "parent": parent, "parent_ms": head[parent]["kernel_ms"],
            "resources": resources[name]}
        if name in timing["longest segment"]:
            entry["longest_segment"] = {
                k: timing["longest segment"][name][k] for k in timed_keys}
            entry["longest_segment"]["parent_ms"] = \
                timing["longest segment"][parent]["kernel_ms"]
        record["kernels"].append(entry)
    for name in (*kernels, BIASED_PASS, MIGRATION_PASS, VB_PASS,
                 BIASED_VB_PASS, MIGRATION_VB_PASS):
        single, chained = tallies[name]
        compare = {"trips=1": single.record(),
                   "trips=64 vs plain": chained.record()}
        if name == "trip":
            compare["trips=64 vs 64x trips=1"] = "bit for bit equal"
        by_path = {"main": launches[name], "genome": g_launches[name],
                   "genome resumed": g_resume_launches[name],
                   "biased": b_launches[name], "twopop": m_launches[name],
                   "vb": v_launches[name], "apf": a_launches[name],
                   "apf8": a8_launches[name],
                   "bias_guide": bg_launches[name],
                   "alpha": al_launches[name]}
        # each entry point's own path: the main path for the plain pass,
        # the biased path for the biased pass and for trip (its
        # calibration pre-pass), the twopop path for the migration pass,
        # the VB path for the plain pass's VB variant; the biased and the
        # twopop path's sweep with -vb for theirs
        own = {"segment_pass": "main", MIGRATION_PASS: "twopop",
               VB_PASS: "vb", MIGRATION_VB_PASS: "twopop"}.get(
            name, "biased")
        # device time per launch at the mean segment of the entry point's
        # own shape: the main path's for the plain kernels, the genome
        # data's for the biased pass, the twopop data's for the migration
        # pass
        t = {BIASED_PASS: g_head.get(name),
             BIASED_VB_PASS: g_head.get(name),
             MIGRATION_PASS: m_timing["mean twopop segment"],
             MIGRATION_VB_PASS: m_timing["mean twopop segment"]["vb"]}.get(
                 name, head.get(name))
        entry = {
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES,
            "launches": by_path[own],
            "launches_by_path": by_path,
            # kernel vs plain on identical inputs, one trip
            "max_abs_err": single.max_abs_err,
            "compare": compare,
            "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,  # no single PyTorch call computes a trip
            "host_us_per_call": t["host_us"],
        }
        # registers, local and static shared bytes (cudaFuncGetAttributes),
        # dynamic shared bytes and particles per block as launched, blocks
        # and particles per SM, waves at P=10,000
        entry["resources"] = resources[name]
        if name in (MIGRATION_PASS, MIGRATION_VB_PASS):
            # the twopop shape (P=10000, n=4, E=8, Pp=2, Mw=56)
            entry["twopop_shape"] = {
                label: {k: v for k, v in (
                    row if name == MIGRATION_PASS else row["vb"]).items()
                    if k != "vb"}
                for label, row in m_timing.items()
                if name == MIGRATION_PASS or "vb" in row}
            record["kernels"].append(entry)
            continue
        # the whole-genome shape (P=10000, n=8, E=33): the times at its
        # mean and (but for the VB variants) longest segment
        entry["genome_shape"] = {
            "mean_segment": {k: g_head[name][k] for k in timed_keys},
            "host_us_per_call": g_head[name]["host_us"]}
        if name in g_timing["longest segment"]:
            entry["genome_shape"]["longest_segment"] = {
                k: g_timing["longest segment"][name][k] for k in timed_keys}
        if name in timing["longest segment"]:
            entry["longest_segment"] = {
                k: timing["longest segment"][name][k] for k in timed_keys}
        record["kernels"].append(entry)
    # the ARG variants: launches on the path that runs each (the VB
    # variants in their path's profile with -vb, the biased ones in short
    # sweeps), times beside the parent pass on its timed inputs
    arg_where = {ARG_PASS: ("ARG main", arg_launches),
                 BIASED_ARG_PASS: ("its own sweep", ab_launches),
                 MIGRATION_ARG_PASS: ("twopop ARG", ma_launches),
                 WIDE_ARG_PASS: ("ARG wide n=16 sweep", wa_launches["n=16"])}
    arg_where.update({vb_name(k): (f"{where} with -vb", counts)
                      for k, (where, counts) in list(arg_where.items())})
    for name, parent in ARG_PARENTS.items():
        single, chained = tallies[name]
        t = a_timing[name]
        where, counts = arg_where[name]
        record["kernels"].append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": counts[name],
            "launches_on": where, "max_abs_err": single.max_abs_err,
            "compare": {"trips=1": single.record(),
                        "trips=64 vs plain": chained.record()},
            "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "host_us_per_call": t["host_us"],
            "parent": parent, "parent_ms": t["parent_ms"],
            "timed_at": {k: t[k] for k in ("L", "active", "trips",
                                           "rows_pushed")},
            "resources": resources[name]})

    # the migration pass's proposal variants: launches on the run that
    # takes each (A: the production proposal, B: the guide loop) or in
    # its own short sweep, times beside the migration pass
    mp_where = {MIG_BIASED_PASS: "twopop A", MIG_LOCAL_PASS: "twopop B",
                MIG_GUIDE_LOCAL_PASS: "twopop B"}
    mp_mean = mp_timing["mean twopop segment"]
    mp_long = mp_timing["longest segment"]
    for name in MIG_PROPOSAL_PASSES:
        single, chained = tallies[name]
        t = mp_mean[name]
        where = mp_where.get(name, "its own sweep")
        record["kernels"].append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES,
            "launches": (mp_launches[where[-1]][name] if name in mp_where
                         else mp_sweeps[name]),
            "launches_on": where,
            "max_abs_err": single.max_abs_err,
            "compare": {"trips=1": single.record(),
                        "trips=64 vs plain": chained.record()},
            "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "host_us_per_call": t["host_us"],
            "parent": (MIGRATION_VB_PASS if "vb" in name
                       else MIGRATION_PASS),
            "parent_ms": t["parent_ms"],
            "timed_at": {k: t[k] for k in (
                "L", "active", "trips", "walk_events", "slots_changed",
                "pushed")},
            "longest_segment": {k: mp_long[name][k] for k in (
                "kernel_ms", "parent_ms", "bound_ms", "bound_by", "trips",
                "walk_events")},
            "resources": resources[name]})

    def profiled(rep, P):
        return {"updates_per_s_unprofiled": P / rep["ms_per_segment"] * 1e3,
                **{k: rep[k] for k in (
                    "launches_per_segment", "device_ms_per_segment",
                    "device_busy_share", "ms_per_segment",
                    "pass_us_per_launch")}}
    record["arg_paths"] = {
        "card": card,
        "main": dict(feature(arg_steps, 10000, arg_rep, main_rep),
                     logl=[r.args[4] for r in arg_steps]),
        "twopop": dict(profiled(ma_rep, TWOPOP_P), logl=[
            r.args[4] for r in ma_steps], updates_per_s=[
            TWOPOP_P * r.args[2] / r.args[1] for r in ma_steps],
            added_launches_per_segment=(ma_rep["launches_per_segment"]
                                        - m_profile["launches_per_segment"])),
        "wide": dict(profiled(wa_rep, WIDE_P),
                     added_launches_per_segment=(
                         wa_rep["launches_per_segment"]
                         - w_rep["launches_per_segment"])),
        "wide_short_sweeps": {k: v[WIDE_ARG_PASS]
                              for k, v in wa_launches.items()},
        "ring_gather": gather}

    def twopop_run(run, rep):
        st = mp_steps[run]
        return {"updates_per_s": [TWOPOP_P * r.args[2] / r.args[1]
                                  for r in st],
                "estep_seconds": [r.args[1] for r in st],
                "segments": [r.args[2] for r in st],
                "logl": [r.args[4] for r in st],
                "launches": {k: v for k, v in mp_launches[run].items() if v},
                **{k: rep[k] for k in (
                    "launches_per_segment", "device_ms_per_segment",
                    "device_busy_share", "ms_per_segment",
                    "pass_us_per_launch")}}
    record["twopop_proposal_paths"] = {
        "card": card,
        "A": dict(twopop_run("A", mp_reps["A"]),
                  calibration_launches=mp_cal),
        "B": twopop_run("B", mp_reps["B"]),
        "short_sweeps": mp_sweeps}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
