"""Smoke run of the PyTorch/CUDA port (smcsmc_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. print the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the trip kernel from csrc/trip.cu with nvcc for sm_90a;
3. compare kernel and plain torch trip on the card with identical uniforms:
   (P=10000, n=4, E=8) and (P=4096, n=8, E=33); leaf status 1, 0 (some
   leaves without data) and -1; one trip, and 64 trips in one launch
   against the plain version and against 64 single-trip launches, on the
   longest segment the sweep makes (50 kb).  Each float is held to rtol
   1e-4 plus an atol in its own units (kernels.trip.float_tolerances: one
   node height is 1e-5 of the tallest node; positions 1e-5 of L; log_w
   mu x L x N node heights; counts to half an event).  One trip: trees
   equal in >= 99.9% of particles and every float within tolerance on the
   particles whose trees agree.  64 trips vs plain: >= 99.9% of particles agree in
   trees and floats, since a last-bit difference in a node height can grow
   along a chain of trips (the next hazard integrates the moved heights).
   64 trips in one launch equal 64 single-trip launches bit for bit;
4. time kernel and plain version with CUDA events (medians) at P=10000,
   n=4, E=8;
5. run the main path through smc2-torch's entry point
   (smcsmc_tpu_torch.cli.smcsmc_main) on bench.py's single-population data
   (n=4, 2 Mb) at -Np 10000 -EM 1 with 9 epochs;
6. check result.out of the last iteration (LogL finite and negative; Coal
   Ne within 2x of 10000 in every interior epoch with >= 5 posterior
   coalescences, and at least 3 such epochs; Recomb rate within 2x of
   1e-9) and that the main path launched the trip kernel;
7. profile 200 steady segments of the same sweep with torch.profiler
   (smcsmc_tpu_torch.sweep_profile): device busy share, launches per
   segment, trip kernel time per launch, top device operations.

The line before the last is a JSON object with the kernel's build/compare/
time record; the last line is {"ok": true, "device": {...}}.  Without a
CUDA device the script exits non-zero and prints no result.
"""

from __future__ import annotations

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


def _log(msg: str) -> None:
    print(msg, flush=True)


def _demo(n: int, E: int, L: float = 2e6):
    """bench.py's single_pop_demo for E=8; the -P 133 133016 grid else."""
    import numpy as np

    from smcsmc_tpu_torch.shared import Demography

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


class Case:
    """Trees and trip inputs on the card, made from a seed."""

    def __init__(self, P, n, E, leaf_status, L, nr_scale, seed):
        import torch

        from smcsmc_tpu_torch.kernels.tree import (
            epochs_from_demography,
            make_initial_trees,
        )
        from smcsmc_tpu_torch.smc import tree_summaries

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

    def uniforms(self, T):
        import torch

        return torch.rand((T, self.P, 4), generator=self.gen, device="cuda")

    def fresh(self):
        return {k: v.clone() for k, v in self.base.items()}

    def run(self, fn, u, state):
        from smcsmc_tpu_torch.kernels.trip import FIELDS

        fn(u, self.leaf_status, *(state[k] for k in FIELDS), self.L, MU,
           RHO, self.epochs.start.contiguous(),
           self.epochs.inv2ne.contiguous(), self.has_data)
        return state


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


def phase_compare(trip, trip_plain):
    """Run every comparison; return the worst errors of each kind."""
    import torch

    from smcsmc_tpu_torch.kernels.trip import FIELDS, disagreement

    single, chained = Tally(), Tally()
    ok = True
    for P, n, E in ((10000, 4, 8), (4096, 8, 33)):
        budget = (1.0 - MATCH_MIN) * P
        for ls in (1, 0, -1):
            # one trip, most particles active: every particle whose tree
            # agrees must agree in every float
            c = Case(P, n, E, ls, L=20000.0, nr_scale=1.5, seed=P + n + E + ls)
            u = c.uniforms(1)
            ref = c.run(trip_plain, u, c.fresh())
            got = c.run(trip, u, c.fresh())
            torch.cuda.synchronize()
            trees, floats, errs = disagreement(got, ref, c.L, MU, RTOL)
            good = int(trees.sum()) <= budget and int(floats.sum()) == 0
            single.add(trees, floats, errs)
            _report(f"P={P} n={n} E={E} leaf_status={ls} trips=1", P, trees,
                    floats, errs, good)
            ok &= good
            # 64 trips in one launch vs plain, and vs 64 single launches, on
            # the longest segment the sweep produces
            c = Case(P, n, E, ls, L=MAX_SEG, nr_scale=0.1,
                     seed=7 * P + n + E + ls)
            u = c.uniforms(64)
            ref = c.run(trip_plain, u, c.fresh())
            got = c.run(trip, u, c.fresh())
            seq = c.fresh()
            for j in range(64):
                c.run(trip, u[j:j + 1].contiguous(), seq)
            torch.cuda.synchronize()
            trees, floats, errs = disagreement(got, ref, c.L, MU, RTOL)
            good = int((trees | floats).sum()) <= budget
            chained.add(trees, floats, errs)
            _report(f"P={P} n={n} E={E} leaf_status={ls} trips=64 vs plain",
                    P, trees, floats, errs, good)
            ok &= good
            same = all(torch.equal(got[k], seq[k]) for k in FIELDS)
            _log(f"compare P={P} n={n} E={E} leaf_status={ls} trips=64 vs "
                 f"64x trips=1: bit for bit {'equal -> ok' if same else 'FAIL'}")
            ok &= same
    if not ok:
        raise SystemExit("kernel and plain trip disagree beyond tolerance")
    return single, chained


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def phase_time(trip, trip_plain, seg_lengths):
    """Median device time of one segment's trip loop (64 uniforms rows),
    kernel vs plain, alternating, at P=10000, n=4, E=8."""
    import torch

    rows = {}
    for label, L in seg_lengths:
        c = Case(10000, 4, 8, 1, L=L, nr_scale=0.0, seed=99)
        # next recombination as drawn at a segment start: Exp(1)/(rho*tl)
        expo = torch.empty(c.P, device="cuda").exponential_(
            1.0, generator=c.gen)
        c.base["next_rec"] = (expo / (RHO * c.base["tl"])).contiguous()
        active = float((c.base["next_rec"] < L).float().mean())
        u = c.uniforms(64)
        times = {"kernel": [], "plain": []}
        order = ["plain", "kernel", "kernel", "plain"] * 5
        fns = {"kernel": trip, "plain": trip_plain}
        for which in ["kernel", "plain"]:  # warm-up
            c.run(fns[which], u, c.fresh())
        torch.cuda.synchronize()
        for which in order:
            st = c.fresh()
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            c.run(fns[which], u, st)
            t1.record()
            torch.cuda.synchronize()
            times[which].append(t0.elapsed_time(t1))
        rows[label] = dict(L=L, active=active,
                           kernel_ms=_median(times["kernel"]),
                           plain_ms=_median(times["plain"]))
        _log(f"time {label} (L={L:g} bp, {active:.1%} of particles recombine): "
             f"kernel {rows[label]['kernel_ms']:.4f} ms, plain "
             f"{rows[label]['plain_ms']:.4f} ms (median of 10, CUDA events)")
    return rows


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def _read_out(path, it):
    """Rows of iteration ``it`` of a .out file as dicts."""
    with open(path) as fh:
        lines = [ln.split() for ln in fh.read().strip().split("\n")]
    header = lines[0]
    rows = [dict(zip(header, ln)) for ln in lines[1:]]
    return [r for r in rows if int(r["Iter"]) == it]


def phase_main_path(trip, card, seg):
    import numpy as np

    from smcsmc_tpu_torch import cli
    from smcsmc_tpu_torch.shared import write_seg

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
        trip.launches = 0
        t0 = time.monotonic()
        rc = cli.smcsmc_main(argv)
        wall = time.monotonic() - t0
        launches = trip.launches
        if rc != 0:
            raise SystemExit(f"smcsmc_main returned {rc}")
        rows = _read_out(os.path.join(out, "result.out"), em_iters)
    lg.removeHandler(rec)
    steps = [r for r in rec.records if r.msg.startswith("EM iteration")]
    if len(steps) != em_iters + 1:
        raise SystemExit("main path did not log every EM iteration")
    _log(f"main path: smc2-torch -Np {P} -EM {em_iters} ran in {wall:.2f} s "
         f"wall; trip kernel launches {launches}")
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
    if launches <= 0:
        problems.append("trip kernel was not launched on the main path")
    if problems:
        raise SystemExit("result checks failed: " + "; ".join(problems))
    _log("result checks: ok")
    return launches, steps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no GPU, "
              "nothing measured", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from smcsmc_tpu_torch.kernels import _build
    from smcsmc_tpu_torch.kernels.trip import trip, trip_plain

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
        if "registers" in ln or "spill" in ln or "stack frame" in ln:
            _log("  ptxas: " + ln.strip())

    from smcsmc_tpu_torch.shared import split_long_segments
    from smcsmc_tpu_torch.sweep_profile import (
        bench_data,
        profile_sweep,
        report_lines,
    )

    demo, seg = bench_data()  # bench.py's headline data (n=4, E=8, 2 Mb)
    mean_len = float(split_long_segments(seg, MAX_SEG).lengths.mean())

    single, chained = phase_compare(trip, trip_plain)
    timing = phase_time(trip, trip_plain,
                        [("mean bench segment", mean_len),
                         ("longest segment", MAX_SEG)])
    launches, _ = phase_main_path(trip, card, seg)

    # where the sweep's time goes (after the main path's launch count)
    for ln in report_lines(profile_sweep(demo, seg, 10000, "cuda")):
        _log(ln)

    head = timing["mean bench segment"]
    record = {"kernels": [{
        "name": "trip",
        "route": "cuda",
        "source": "smcsmc_tpu_torch/csrc/trip.cu",
        "replaces": "smcsmc_tpu/kernels/pallas_trip.py:91",
        "launches": launches,
        # kernel vs plain on identical inputs, one trip
        "max_abs_err": single.max_abs_err,
        "compare": {"trips=1": single.record(),
                    "trips=64 vs plain": chained.record(),
                    "trips=64 vs 64x trips=1": "bit for bit equal"},
        "ms": head["kernel_ms"],
        "plain_ms": head["plain_ms"],
    }]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
