"""Smoke run of the PyTorch/CUDA port (smcsmc_tpu_torch) on one GPU.

    python3 chip_smoke.py [--until build|compare|time]

Phases, each fatal on failure:

1. print the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the kernels from csrc/trip.cu with nvcc for sm_90a and print what
   ptxas says of them (registers, shared memory, stack frame, spills);
3. compare both entry points of the kernel, ``trip`` and ``segment_pass``,
   with their plain torch versions on the card with identical uniforms:
   (P=10000, n=4, E=9: the main path's shape), (P=10000, n=4, E=8) and
   (P=4096, n=8, E=33); leaf status 1, 0 (some leaves without data) and -1;
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
4. time both entry points at the main path's shape (P=10000, n=4, E=9), on
   the mean and on the longest segment: device time per launch (CUDA events
   around 20 launches on cloned states, queued behind a matrix product so
   that the host's enqueueing is not in the interval), the same with at
   most 1, 2 and 4 trips allowed and with no particle recombining, an empty
   launch, the host's time per wrapper call (perf_counter around 200 calls,
   no synchronise inside) and the plain version (median of 3).  From the
   counted work of those launches (active particles, trips, and the
   statistics that are not zero and so have to reach the FIFO) it prints
   each kernel's bound, the larger of bytes over 3.35 TB/s and operations
   over 67 TFLOP/s, and the share of it the kernel reaches;
5. run the main path through smc2-torch's entry point
   (smcsmc_tpu_torch.cli.smcsmc_main) on bench.py's single-population data
   (n=4, 2 Mb) at -Np 10000 -EM 1 with 9 epochs;
6. check result.out of the last iteration (LogL finite and negative; Coal
   Ne within 2x of 10000 in every interior epoch with >= 5 posterior
   coalescences, and at least 3 such epochs; Recomb rate within 2x of
   1e-9), that the main path launched ``segment_pass`` once per segment and
   iteration, and that it launched ``trip`` and ran no plain version at all;
7. profile 200 steady segments of the same sweep with torch.profiler
   (smcsmc_tpu_torch.sweep_profile): device busy share, launches per
   segment, kernel time per launch, top device operations.

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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
FIFO_SLOTS = 4  # PFConfig.fifo_slots, the sweep's lag FIFO depth


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

        if not torch.equal(st["fifo"][:, 1:], self.fifo[:, 1:]):
            raise SystemExit("segment_pass wrote outside FIFO slot 0")
        out = {k: st[k] for k in SEGMENT_STATE}
        out["tl"] = st["tl"]
        out["pending"] = st["fifo"][:, 0]
        return out


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

    for P, n, E in ((10000, 4, 9), (10000, 4, 8), (4096, 8, 33)):
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


def _bounds(c, active, trips, pushed):
    """Least time (ms) the card could take for one launch of each entry
    point with ``active`` recombining particles, ``trips`` trips in all and
    ``pushed`` statistics that are not zero after the gate: bytes the
    function must move (each input read once, each output written once)
    over the memory rate, and its float operations over the float32 rate;
    the larger bounds it."""
    P, N, E = c.P, 2 * c.n - 1, c.E
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


def phase_time(kernels, seg_lengths):
    """Times of both entry points at the main path's shape (P=10000, n=4,
    E=9) for each (label, segment length); see the module docstring."""
    import torch

    from smcsmc_tpu_torch.kernels._build import load_trip_library

    lib = load_trip_library()
    a = torch.rand((4096, 4096), device="cuda")

    def filler():
        torch.mm(a, a)

    def noop(_):
        err = lib.smc_noop_launch(torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise SystemExit(f"empty launch failed: CUDA error {err}")

    noop(None)  # the first launch loads the module
    empty_ms = _device_ms(noop, range(200), filler)
    _log(f"time empty launch: {empty_ms * 1e3:.2f} us of device time each "
         f"(200 back to back)")

    rows = {"empty_launch_ms": empty_ms}
    for label, L in seg_lengths:
        c, u = _timing_case(10000, 4, 9, L)
        # counted work: a trip adds one recombination count to one epoch;
        # FIFO slot 0 starts empty, so what is not zero in it afterwards is
        # what the segment pass had to push
        st = c.run(kernels["trip"][0], u, c.fresh())
        per_particle = st["pending"][:, 5 * c.E:].sum(dim=1)
        active = int((c.base["next_rec"] < L).sum())
        trips = int(round(float(per_particle.sum())))
        st = c.run_segment(kernels["segment_pass"][0], u, c.fresh_segment())
        pushed = int((st["fifo"][:, 0] != 0).sum())
        bounds = _bounds(c, active, trips, pushed)
        _log(f"time {label} (L={L:g} bp): {active} of {c.P} particles "
             f"recombine, {trips} trips in all, at most "
             f"{int(per_particle.max())} in one particle; {pushed} of "
             f"{c.P * 6 * c.E} statistics are not zero after the gate")
        makers = {"trip": (c.fresh, c.run),
                  "segment_pass": (c.fresh_segment, c.run_segment)}
        rows[label] = {"L": L, "active": active, "trips": trips,
                       "pushed": pushed}
        for name, (kernel, plain) in kernels.items():
            fresh, run = makers[name]

            def launch(st, fn=kernel, run=run, u=u):
                run(fn, u, st)

            def idle():
                st = fresh()
                st["next_rec"] += 1e9  # nobody recombines
                return st

            # what a launch costs before any trip, and per trip allowed
            ladder = {"no trips": _best_device_ms(launch, idle, filler)}
            for T in (1, 2, 4):
                ladder[f"trips<={T}"] = _best_device_ms(
                    lambda st, ut=u[:T].contiguous(): run(kernel, ut, st),
                    fresh, filler)
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


def phase_main_path(card, seg):
    import numpy as np

    import smcsmc_tpu_torch.kernels.trip as trip_mod
    from smcsmc_tpu_torch import cli
    from smcsmc_tpu_torch.segio import write_seg

    P, em_iters = 10000, 1
    rec = _Records()
    lg = logging.getLogger("smcsmc_tpu_torch")
    lg.setLevel(logging.INFO)
    lg.addHandler(rec)
    with tempfile.TemporaryDirectory() as tmp:
        seg_path = os.path.join(tmp, "bench.seg")
        write_seg(seg_path, seg)
        out = os.path.join(tmp, "out")
        argv = ["-seg", seg_path, "-o", out, "-Np", str(P), "-EM",
                str(em_iters), "-N0", "10000", "-mu", "1e-8", "-rho", "1e-9",
                "-P", "133", "133016", "7*1", "-seed", "7", "-device", "cuda"]
        plain_calls = _count_calls(trip_mod, ("trip_plain",
                                              "segment_pass_plain"))
        trip_mod.trip.launches = 0
        trip_mod.segment_pass.launches = 0
        t0 = time.monotonic()
        rc = cli.smcsmc_main(argv)
        wall = time.monotonic() - t0
        launches = {"trip": trip_mod.trip.launches,
                    "segment_pass": trip_mod.segment_pass.launches}
        plain_calls.restore()
        if rc != 0:
            raise SystemExit(f"smcsmc_main returned {rc}")
        rows = _read_out(os.path.join(out, "result.out"), em_iters)
    lg.removeHandler(rec)
    steps = [r for r in rec.records if r.msg.startswith("EM iteration")]
    if len(steps) != em_iters + 1:
        raise SystemExit("main path did not log every EM iteration")
    _log(f"main path: smc2-torch -Np {P} -EM {em_iters} ran in {wall:.2f} s "
         f"wall; kernel launches {launches}; calls of the plain versions "
         f"{plain_calls.counts}")
    for r in steps:
        it, secs, nseg = r.args[0], r.args[1], r.args[2]
        _log(f"  E-step {it}: {secs:.3f} s over {nseg} segments = "
             f"{P * nseg / secs:.6g} particle-site updates/s on {card}")

    # ---- result checks ---------------------------------------------------
    logl = [float(r["Count"]) for r in rows if r["Type"] == "LogL"]
    coal = [r for r in rows if r["Type"] == "Coal"]
    recomb = [r for r in rows if r["Type"] == "Recomb"]
    problems = []
    if len(logl) != 1 or not np.isfinite(logl[0]) or logl[0] >= 0:
        problems.append(f"LogL {logl}")
    # interior epochs that carry data: with n=4 over 2 Mb only ~130
    # recombinations happen, and the youngest epochs see almost no
    # coalescences, so their Ne is the prior's pseudocount ratio
    informed = [r for r in coal[1:len(coal) - 1]
                if float(r["Count"]) >= MIN_EPOCH_EVENTS]
    if len(informed) < 3:
        problems.append(f"only {len(informed)} interior epochs with >= "
                        f"{MIN_EPOCH_EVENTS} coalescences")
    for r in informed:
        ne = float(r["Ne"])
        if not 0.5 * NE <= ne <= 2.0 * NE:
            problems.append(f"Coal epoch {r['Epoch']} Ne {ne:.1f}")
    rate = float(recomb[0]["Rate"]) if recomb else float("nan")
    if not 0.5 * RHO <= rate <= 2.0 * RHO:
        problems.append(f"Recomb rate {rate:.4g}")
    _log("result.out (iteration %d): LogL %s; Coal Ne by epoch %s; Recomb "
         "rate %.4g" % (em_iters, logl,
                        [round(float(r["Ne"]), 1) for r in coal], rate))
    segments = sum(r.args[2] for r in steps)  # over all E-steps
    if launches["segment_pass"] != segments:
        problems.append(f"segment_pass launched {launches['segment_pass']} "
                        f"times for {segments} segments")
    if launches["trip"] != 0:
        problems.append(f"trip launched {launches['trip']} times on the "
                        f"main path, which goes through segment_pass")
    if any(plain_calls.counts.values()):
        problems.append(f"the main path ran a plain version: "
                        f"{plain_calls.counts}")
    if problems:
        raise SystemExit("result checks failed: " + "; ".join(problems))
    _log("result checks: ok")
    return launches, steps


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

    from smcsmc_tpu_torch.segio import split_long_segments
    from smcsmc_tpu_torch.sweep_profile import (
        bench_data,
        profile_sweep,
        report_lines,
    )

    demo, seg = bench_data()  # bench.py's headline data (n=4, E=8, 2 Mb)
    mean_len = float(split_long_segments(seg, MAX_SEG).lengths.mean())

    kernels = {"trip": (trip, trip_plain),
               "segment_pass": (segment_pass, segment_pass_plain)}
    tallies = phase_compare(kernels)
    if args.until == "compare":
        return 0
    timing = phase_time(kernels, [("mean bench segment", mean_len),
                                  ("longest segment", MAX_SEG)])
    if args.until == "time":
        return 0
    launches, _ = phase_main_path(card, seg)

    # where the sweep's time goes (after the main path's launch count)
    for ln in report_lines(profile_sweep(demo, seg, 10000, "cuda")):
        _log(ln)

    head = timing["mean bench segment"]
    record = {"kernels": [], "empty_launch_ms": timing["empty_launch_ms"],
              "timed_at": {"P": 10000, "n": 4, "E": 9,
                           "active": head["active"], "trips": head["trips"],
                           "pushed": head["pushed"]}}
    for name in kernels:
        single, chained = tallies[name]
        compare = {"trips=1": single.record(),
                   "trips=64 vs plain": chained.record()}
        if name == "trip":
            compare["trips=64 vs 64x trips=1"] = "bit for bit equal"
        t = head[name]
        record["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES,
            "launches": launches[name],
            # kernel vs plain on identical inputs, one trip
            "max_abs_err": single.max_abs_err,
            "compare": compare,
            # device time per launch at the mean segment
            "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,  # no single PyTorch call computes a trip
            "host_us_per_call": t["host_us"],
            "longest_segment": {
                k: timing["longest segment"][name][k]
                for k in ("kernel_ms", "plain_ms", "bound_ms", "bound_by")},
        })
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
