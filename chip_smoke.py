"""Smoke run of the PyTorch/CUDA port (smcsmc_tpu_torch) on one GPU.

    python3 chip_smoke.py [--until build|compare|time]

Phases, each fatal on failure:

1. print the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the kernels from csrc/trip.cu with nvcc for sm_90a and print what
   ptxas says of them (registers, shared memory, stack frame, spills); then
   run the resampler's scan (``smc.block_scan``) 2000 times at P=10,000
   with matrix products queued among the runs: every result must equal the
   first bit for bit (``torch.cumsum``'s differences are printed beside);
3. compare both entry points of the kernel, ``trip`` and ``segment_pass``,
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
   (n=4, 2 Mb) at -Np 10000 -EM 1 with 9 epochs;
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
8. profile 200 steady segments of both sweeps with torch.profiler
   (smcsmc_tpu_torch.sweep_profile): device busy share, launches per
   segment, kernel time per launch, top device operations;
9. the biased path: the whole-genome data through the same entry point
   with the production proposal, ``-segs a.seg b.seg -chunks 4 -Np 10000
   -EM 1 -P 133 133016 "31*1" -record_ess -seed 7 -bias_heights 0 0.05
   -calibrate_lag 2``: the biased ``segment_pass`` once per segment of
   each E-step, the plain one and the plain versions never, ``trip`` as
   often as the lag calibration pre-passes report (more than 0); the
   auto-calibrated bias strengths and the calibrated lags logged; the
   genome path's result check; E-step updates/s, and a profile of chunk 0
   with the same proposal (launches per segment, device busy share).

The line before the last is a JSON object with each kernel's build/compare/
time record; the last line is {"ok": true, "device": {...}}.  Without a
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
DEVICE = "cuda"  # where the entry points are driven


def _log(msg: str) -> None:
    print(msg, flush=True)


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


class Case:
    """Trees and trip inputs on the card, made from a seed."""

    def __init__(self, P, n, E, leaf_status, L, nr_scale, seed):
        import torch

        from smcsmc_tpu_torch.kernels.tree import (
            epochs_from_demography,
            make_initial_trees,
            tree_summaries,
        )

        dev = torch.device("cuda")
        self.P, self.n, self.E, self.L = P, n, E, L
        self.leaf_status = leaf_status
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(seed)
        self.epochs = epochs_from_demography(_demo(n, E), dev)
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

        return torch.rand((T, self.P, 4), generator=self.gen, device="cuda")

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
        st["tl"] = torch.empty(self.P, device="cuda")
        return st

    def run_segment(self, fn, u, st):
        fn(u, self.leaf_status, *(st[k] for k in SEGMENT_STATE), st["fifo"],
           self.fifo_mask, st["tl"], self.L, MU, RHO, self.start,
           self.inv2ne, self.has_data)
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

    def fresh_biased(self):
        """State of a biased segment pass: a plain one's, a pilot weight
        and a ring of delayed factors with 30% of the slots in use (due
        between the segment's start and twice its length on) and every
        slot in use for the first 16 particles (their factors go to the
        pilot at once)."""
        import torch

        from smcsmc_tpu_torch.kernels.tree import INF

        if not hasattr(self, "ring"):
            P, D, dev = self.P, BIAS_SLOTS, "cuda"
            used = torch.rand((P, D), generator=self.gen, device=dev) < 0.3
            used[:16] = True
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
                torch.tensor(BIAS_HEIGHTS, device=dev),
                torch.tensor(BIAS_STRENGTHS, device=dev),
                torch.linspace(3000.0, 30000.0, self.E, device=dev))
        st = self.fresh_segment()
        st.update({k: v.clone() for k, v in self.ring.items()})
        return st

    def run_biased(self, fn, u, st):
        from smcsmc_tpu_torch.kernels.bias import BiasedPass

        biased = BiasedPass(st["log_pilot"], st["df_pos"], st["df_logf"],
                            st["df_delta"], st["df_k"], *self.bias_tables,
                            BIAS_FRONT)
        fn(u, self.leaf_status, *(st[k] for k in SEGMENT_STATE), st["fifo"],
           self.fifo_mask, st["tl"], self.L, MU, RHO, self.start,
           self.inv2ne, self.has_data, biased)
        return st


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

    # the biased pass at the biased path's shape: pilot weight and ring
    # fields held too (float_tolerances names them)
    tallies[BIASED_PASS] = (Tally(), Tally())
    P, n, E = GENOME_P, 8, 33
    budget = (1.0 - MATCH_MIN) * P
    for ls in (1, 0, -1):
        for T, L, nr_scale in ((1, 20000.0, 1.5), (64, MAX_SEG, 0.1)):
            c = Case(P, n, E, ls, L=L, nr_scale=nr_scale,
                     seed=11 * P + T + ls)
            u = c.uniforms(T)
            got = c.segment_result(c.run_biased(segment_pass, u,
                                                c.fresh_biased()))
            ref = c.segment_result(c.run_biased(segment_pass_plain, u,
                                                c.fresh_biased()))
            torch.cuda.synchronize()
            if torch.equal(ref["df_pos"], c.ring["df_pos"]):
                raise SystemExit("the biased comparison moved no factor")
            trees, floats, errs = disagreement(got, ref, c.L, MU, RTOL)
            if T == 1:
                good = int(trees.sum()) <= budget and int(floats.sum()) == 0
            else:
                good = int((trees | floats).sum()) <= budget
            tallies[BIASED_PASS][T > 1].add(trees, floats, errs)
            _report(f"{BIASED_PASS} P={P} n={n} E={E} leaf_status={ls} "
                    f"trips={T}" + (" vs plain" if T > 1 else ""), P, trees,
                    floats, errs, good)
            ok &= good
    if not ok:
        raise SystemExit("kernel and plain version disagree beyond tolerance")
    return tallies


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


def phase_time(kernels, shape, seg_lengths, biased=False):
    """Times of both entry points (and, with ``biased``, of the biased
    pass) at ``shape`` (P, n, E) for each (label, segment length); see the
    module docstring."""
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
            ladder = {"no trips": _best_device_ms(launch, idle, filler)}
            for T in (1, 2, 4):
                ladder[f"trips<={T}"] = _best_device_ms(
                    lambda st, ut=u[:T].contiguous(), run=run, kernel=kernel:
                    run(kernel, ut, st), fresh, filler)
            t = dict(kernel_ms=_best_device_ms(launch, fresh, filler),
                     ladder=ladder, plain_ms=_plain_ms(run, plain, u, fresh),
                     host_us=_host_us(launch, [fresh() for _ in range(200)]),
                     **bounds[name])
            rows[label][name] = t
            _log(f"time {name} {label}: kernel {t['kernel_ms'] * 1e3:.2f} us "
                 f"of device time per launch (best of 3 x 20 launches; "
                 + ", ".join(f"{k} {x * 1e3:.2f} us"
                             for k, x in ladder.items())
                 + f"); host {t['host_us']:.2f} us per wrapper call; plain "
                 f"{t['plain_ms']:.4f} ms (median of 3); bound "
                 f"{t['bound_ms'] * 1e3:.3f} us by {t['bound_by']} "
                 f"({t['bytes']} B, {t['flop']} FLOP), kernel reaches "
                 f"{t['bound_ms'] / t['kernel_ms']:.4f} of it")
    return rows


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
    plain_calls = _count_calls(trip_mod, ("trip_plain", "segment_pass_plain"))
    try:
        trip_mod.trip.launches = 0
        trip_mod.segment_pass.launches = 0
        trip_mod.segment_pass.biased_launches = 0
        t0 = time.monotonic()
        rc = cli.smcsmc_main(argv)
        wall = time.monotonic() - t0
        launches = {"trip": trip_mod.trip.launches,
                    "segment_pass": trip_mod.segment_pass.launches,
                    BIASED_PASS: trip_mod.segment_pass.biased_launches}
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
                    biased=False):
    """One launch per segment of the pass the path takes and none of the
    other; no plain version; ``trip`` only in a biased path's pre-pass."""
    name, other = (BIASED_PASS, "segment_pass") if biased else ("segment_pass",
                                                          BIASED_PASS)
    if launches[name] != segments:
        problems.append(f"{name} launched {launches[name]} "
                        f"times for {segments} segments")
    if launches[other] != 0:
        problems.append(f"{other} launched {launches[other]} times on the "
                        f"{path}")
    if launches["trip"] != 0 and not biased:
        problems.append(f"trip launched {launches['trip']} times on the "
                        f"{path}, which goes through segment_pass")
    if any(plain.values()):
        problems.append(f"the {path} ran a plain version: {plain}")


def phase_main_path(card, seg):
    from smcsmc_tpu_torch.segio import write_seg

    P, em_iters = 10000, 1
    with tempfile.TemporaryDirectory() as tmp:
        seg_path = os.path.join(tmp, "bench.seg")
        write_seg(seg_path, seg)
        out = os.path.join(tmp, "out")
        argv = ["-seg", seg_path, "-o", out, "-Np", str(P), "-EM",
                str(em_iters), "-N0", "10000", "-mu", "1e-8", "-rho", "1e-9",
                "-P", "133", "133016", "7*1", "-seed", "7", "-device", DEVICE]
        launches, plain, steps, _, wall = _run_cli(argv)
        rows = _read_out(os.path.join(out, "result.out"), em_iters)
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
    return launches, steps


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
        argv = _genome_argv(paths, out)
        i = argv.index("-ckpt")
        argv = argv[:i] + argv[i + 2:] + BIASED_FLAGS
        launches, plain, steps, records, wall = _run_cli(argv)
        shown = " ".join(os.path.basename(a) if a in paths else a
                         for a in argv if a != out)
        _log(f"biased path: smc2-torch {shown} ran in {wall:.2f} s wall; "
             f"kernel launches {launches}; calls of the plain versions "
             f"{plain}")
        _log_esteps(steps, GENOME_P, card)
        msgs = [r.getMessage() for r in records]
        reported = sum(r.args[0] for r in records
                       if r.msg.startswith("survival calibration:"))
        for m in msgs:
            if m.startswith(("auto-calibrated bias_strengths",
                             "calibrated lags", "Calibrated lag",
                             "survival calibration")):
                _log("  log: " + m)
        if len(steps) != 2:
            raise SystemExit(f"biased path: {len(steps)} EM iterations")
        _check_launches(launches, plain, sum(r.args[2] for r in steps),
                        problems, "biased path", biased=True)
        if launches["trip"] == 0 or launches["trip"] != reported:
            problems.append(f"trip launched {launches['trip']} times, the "
                            f"calibration pre-passes report {reported}")
        if not any(m.startswith("auto-calibrated bias_strengths")
                   for m in msgs) or not any(
                m.startswith("calibrated lags") for m in msgs):
            problems.append("the calibrated strengths or lags were not "
                            "logged")
        rows = [r for r in _read_out(os.path.join(out, "emiter1",
                                                  "chunkfinal.out"), 1)
                if r["Clump"] == "-1"]
        _check_estimates(rows, 1, problems, GENOME_MIN_EPOCH_EVENTS,
                         GENOME_POOLED_WITHIN)
        if problems:
            raise SystemExit("biased path checks failed: "
                             + "; ".join(problems))
        _log("biased path checks: ok")
        demo, seg = genome_model(paths)
    chunk = next(r.args[0] for r in records if r.msg.startswith("chunks:"))[0]
    rep = profile_sweep(demo, seg, GENOME_P, DEVICE, chunk=tuple(chunk),
                        **BIASED_OPTIONS)
    _log(f"biased path sweep profile (chunk {chunk}, E=33) on {card}:")
    for ln in report_lines(rep):
        _log(ln)
    return launches, steps, reported, rep


REPLACES = "smcsmc_tpu/kernels/pallas_trip.py:91"
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
    sys.path.insert(0, HERE)
    from smcsmc_tpu_torch.kernels import _build
    from smcsmc_tpu_torch.kernels.trip import (
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
         f"{' '.join(_build.NVCC_FLAGS)} in {info.seconds:.2f} s")
    for ln in info.log.splitlines():
        if ("registers" in ln or "spill" in ln or "stack frame" in ln
                or "Compiling entry function" in ln):
            _log("  ptxas: " + ln.strip())
    if args.until == "build":
        return 0
    scan_counts = phase_scan_repeat()

    from smcsmc_tpu_torch.segio import split_long_segments
    from smcsmc_tpu_torch.sweep_profile import (
        bench_data,
        profile_sweep,
        report_lines,
    )

    # bench.py's headline data (n=4, 2 Mb); the main path sweeps it with
    # the 9 epochs of -P 133 133016 "7*1"
    demo, seg = bench_data()
    mean_len = float(split_long_segments(seg, MAX_SEG).lengths.mean())

    kernels = {"trip": (trip, trip_plain),
               "segment_pass": (segment_pass, segment_pass_plain)}
    tallies = phase_compare(kernels)
    if args.until == "compare":
        return 0
    empty_ms = time_empty_launch()
    timing = phase_time(kernels, (10000, 4, 9),
                        [("mean bench segment", mean_len),
                         ("longest segment", MAX_SEG)])
    if args.until == "time":
        return 0
    launches, _ = phase_main_path(card, seg)

    # where the sweep's time goes (after the main path's launch count)
    for ln in report_lines(profile_sweep(demo, seg, 10000, "cuda")):
        _log(ln)

    (g_launches, g_resume_launches, g_steps, g_demo, g_seg, g_chunks,
     g_mean_len) = phase_genome_path(card)
    g_timing = phase_time(kernels, (GENOME_P, 8, 33),
                          [("mean genome segment", g_mean_len),
                           ("longest segment", MAX_SEG)], biased=True)
    _log(f"genome path sweep profile (chunk {g_chunks[0]}, E=33) on {card}:")
    for ln in report_lines(profile_sweep(g_demo, g_seg, GENOME_P, "cuda",
                                         chunk=tuple(g_chunks[0]))):
        _log(ln)

    b_launches, b_steps, b_reported, b_profile = phase_biased_path(card)

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
                  "pass_us_per_launch": b_profile["pass_us_per_launch"]}}
    timed_keys = ("kernel_ms", "plain_ms", "bound_ms", "bound_by")
    for name in (*kernels, BIASED_PASS):
        single, chained = tallies[name]
        compare = {"trips=1": single.record(),
                   "trips=64 vs plain": chained.record()}
        if name == "trip":
            compare["trips=64 vs 64x trips=1"] = "bit for bit equal"
        by_path = {"main": launches[name], "genome": g_launches[name],
                   "genome resumed": g_resume_launches[name],
                   "biased": b_launches[name]}
        # each entry point's own path: the main path for the plain pass,
        # the biased path for the biased pass and for trip (its
        # calibration pre-pass)
        own = "main" if name == "segment_pass" else "biased"
        # device time per launch at the mean segment of the entry point's
        # own shape: the main path's for the plain kernels, the genome
        # data's for the biased pass
        t = g_head[name] if name == BIASED_PASS else head[name]
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
            # the whole-genome shape (P=10000, n=8, E=33): the times at its
            # mean and longest segment
            "genome_shape": {
                "mean_segment": {k: g_head[name][k] for k in timed_keys},
                "longest_segment": {
                    k: g_timing["longest segment"][name][k]
                    for k in timed_keys},
                "host_us_per_call": g_head[name]["host_us"]},
        }
        if name != BIASED_PASS:
            entry["longest_segment"] = {
                k: timing["longest segment"][name][k] for k in timed_keys}
        record["kernels"].append(entry)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
