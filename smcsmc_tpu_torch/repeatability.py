"""Does the sweep repeat from run to run, and how far do the whole-genome
and the two-population paths' estimates spread over seeds?

    python -m smcsmc_tpu_torch.repeatability [--np 10000] [--device cuda]
        [--seeds 7 7 8 9] [--main-runs 3] [--twopop-seeds 7 8 9]
        [--feature-runs 2]
        [--features vb apf apf8 bias_guide alpha arg twopop_arg]
        [--scan cumsum]
    python -m smcsmc_tpu_torch.repeatability --lockstep 3
    python -m smcsmc_tpu_torch.repeatability --summary twopop result.out
    python -m smcsmc_tpu_torch.repeatability --genealogy 13 1 2 3

Five measurements, each printed as it ends:

1. the device reductions of the segment step, repeated on one input and
   held bit for bit to their first result, with a matrix product queued now
   and then so that the card's timing varies: the resampler's scan of the
   normalised weights (``smc.block_scan``) beside ``torch.cumsum``, which
   it replaced, ``logsumexp`` (the normaliser's), the weighted column
   sum of a [P, 198] block (the commit's) and the local recording's commit
   (``index_put_`` with accumulation of 8 P rows of 6 values into 201
   windows), at P, 4096 and 100,000;
2. the log-likelihood of the smoke's main path (``sweep_profile.bench_data``,
   one E-step) in ``--main-runs`` fresh processes with one seed;
3. the whole-genome path (``sweep_profile.genome_data``, ``-chunks 4 -EM 1
   -P 133 133016 "31*1"``) once per entry of ``--seeds``, each in a fresh
   process: LogL per iteration, and per epoch of the last iteration the
   posterior coalescences and the Ne estimate.  A seed given twice shows
   whether a whole run repeats;
4. the two-population path (``sweep_profile.twopop_data`` with
   ``twopop_flags``, ``-EM 2``, as ``chip_smoke.py`` runs it) once per entry
   of ``--twopop-seeds``, each in a fresh process: LogL per iteration and,
   per iteration, each population's posterior coalescences and Ne estimate
   by epoch, its pooled interior Ne and the pooled migration rate;
5. VB, the APF and the guide: the main path's data with ``-vb -EM 2``
   (``vb``), with ``-apf 2`` (``apf``), ``sweep_profile.apf8_data`` with
   ``-apf 2`` (``apf8``), the main path's data with bench.py's
   feature_bias_guide (``bias_guide``: ``BIAS_GUIDE_FLAGS`` and the
   constant guide of ``write_constant_guide``, one E-step) and with
   ``-alpha 0.5 -EM 1`` (``alpha``: the guide loop; the digest of each
   iteration's ``.recomb.gz`` text, uncompressed, is printed too: gzip
   stamps the time into the file's header), each ``--feature-runs`` times
   with one seed, each run in a fresh process: LogL per iteration (and
   the ``.recomb.gz`` digests), which must repeat bit for bit.  ``arg``
   runs the main path's data with ``-arg -EM 1`` and ``twopop_arg`` the
   two-population path with ``-arg -EM 0``: the digest of each
   iteration's ``.trees.gz`` text, uncompressed, is printed beside the
   LogL.  ``--features`` picks some of them.

``--lockstep N`` instead sweeps the main path's data and the genome path's
first chunk N times each as two sweeps of one seed side by side in one
process, holds every field of the two states bit for bit after every
segment and reports the first segment at which they part: the fields, how
many particles, and whether that segment resampled.

``--genealogy [SEED ...]`` replays the genealogy that ``simulate_seg`` drew
for the twopop data (seed 13, its sites held to the data's) or for other
seeds of the same model, and prints the Ne that its own trees read per
(epoch, population) and per epoch: what a posterior could at best recover.

``--summary twopop RESULT_OUT`` prints what 4 prints for each iteration of
a ``result.out`` that another run wrote (the JAX package's ``smc2`` on the
same data, for example).

``--scan cumsum`` repeats 2 and 3 with the resampler's scan replaced by
``torch.cumsum``, the single-pass scan across blocks that the sweep used
before ``block_scan``: if those runs part and the others do not, that scan
is what kept a run from repeating.
"""

from __future__ import annotations

import argparse
import gzip
import hashlib
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from . import smc
from .segio import define_chunks, write_seg
from .simulate import _Sim
from .sweep_profile import (
    BIAS_GUIDE_FLAGS,
    GENOME_PATTERN,
    apf8_data,
    bench_data,
    genome_data,
    genome_model,
    twopop_data,
    twopop_flags,
    write_constant_guide,
)

MODEL = ["-N0", "10000", "-mu", "1e-8", "-rho", "1e-9"]
# the feature paths of measurement 5
FEATURES = ("vb", "apf", "apf8", "bias_guide", "alpha", "arg", "twopop_arg")


def _print_digests(out: str, label: str, kind: str, iterations) -> None:
    """The sha256 of each iteration's chunk-0 ``.recomb.gz`` or
    ``.trees.gz`` text, uncompressed (gzip stamps the time into its
    header)."""
    for it in iterations:
        with gzip.open(os.path.join(out, f"emiter{it}",
                                    f"chunk0.{kind}.gz")) as fh:
            text = fh.read()
        print(f"{label}: emiter{it}/chunk0.{kind}.gz text sha256 "
              f"{hashlib.sha256(text).hexdigest()} "
              f"({text.count(b'\n')} lines)", flush=True)


def reductions(P: int, device: str, repeats: int = 20000) -> list[str]:
    """Count the repeats of each reduction that differ from the first."""
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    log_w = torch.randn(P, generator=gen, device=device) * 3
    w = torch.softmax(log_w, 0)
    block = torch.rand(P, 198, generator=gen, device=device)
    filler = torch.randn(2048, 2048, device=device)
    # the commit of due local events: rows of 6 values (n=4) into 200
    # windows and a sink, as local.commit_due_local adds them
    rows = torch.randint(0, 201, (P * 8,), generator=gen, device=device)
    vals = torch.rand(P * 8, 6, generator=gen, device=device) * w.repeat(
        8)[:, None]
    ops = {"block scan": lambda: smc.block_scan(w),
           "cumsum": lambda: w.cumsum(0),
           "logsumexp": lambda: torch.logsumexp(log_w, 0),
           "weighted sum": lambda: (block * w[:, None]).sum(0),
           "local commit": lambda: torch.zeros(
               201, 6, device=device).index_put_((rows,), vals,
                                                 accumulate=True)}
    lines = []
    for name, op in ops.items():
        first, differ = op(), 0
        for i in range(repeats):
            if i % 7 == 0:
                filler @ filler
            differ += int(not torch.equal(op(), first))
        lines.append(f"repeat {name} P={P}: {differ} of {repeats} results "
                     f"differ bit for bit from the first")
    return lines


def _resample_with_cumsum(log_w: torch.Tensor, u) -> torch.Tensor:
    """``smc.systematic_resample`` with ``torch.cumsum`` for its scan."""
    P = log_w.shape[0]
    cum = torch.softmax(log_w, dim=0).cumsum(dim=0)
    targets = (u + torch.arange(P, dtype=torch.float32,
                                device=log_w.device)) / P
    return torch.searchsorted(cum, targets, right=False).clamp(0, P - 1)


def first_divergence(demo, seg, num_particles: int, device: str,
                     chunk=(None, None), seed: int = 7) -> str:
    """Two sweeps of one seed in step; the first segment after which their
    states differ, as a line of text."""
    from .em import EMConfig, start_sweep

    cfg = EMConfig(num_particles=num_particles, device=device)
    a = start_sweep(demo, seg, cfg, chunk, seed)
    b = start_sweep(demo, seg, cfg, chunk, seed)

    def fields(state):
        out = {k: v for k, v in state.trees._asdict().items()
               if v is not None}
        out.update({k: getattr(state, k) for k in (
            "log_w", "next_rec", "fifo", "stats", "stats_wt", "ln_norm")})
        return out

    def differing(sa, sb):
        fa, fb = fields(sa), fields(sb)
        return {k: int((fa[k] != fb[k]).reshape(fa[k].shape[0], -1)
                       .any(1).sum()) if fa[k].dim() else 1
                for k in fa if not torch.equal(fa[k], fb[k])}

    sa, sb = a.state, b.state
    if differing(sa, sb):
        return f"the initial states differ: {differing(sa, sb)}"
    for s in range(len(a.segs)):
        sa, (ess_a, res_a, _) = a.step(sa, a.segs[s])
        sb, (ess_b, res_b, _) = b.step(sb, b.segs[s])
        diff = differing(sa, sb)
        if diff or ess_a != ess_b:
            return (f"part after segment {s} of {len(a.segs)} (length "
                    f"{int(a.segs.lengths[s])}, leaf status "
                    f"{int(a.segs.leaf_status[s])}, "
                    f"{int(a.segs.n_configs[s])} phase configurations): rows "
                    f"that differ by field {diff}; ESS {ess_a!r} vs {ess_b!r}; "
                    f"resampled {res_a} vs {res_b}; {sa.num_resamples} "
                    f"resamples so far")
    return (f"equal bit for bit after every one of {len(a.segs)} segments "
            f"({sa.num_resamples} resamples)")


def lockstep(times: int, num_particles: int, device: str) -> None:
    demo, seg = bench_data()
    for _ in range(times):
        print("lockstep main path: "
              + first_divergence(demo, seg, num_particles, device), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, n) for n in ("a.seg", "b.seg")]
        for path, chrom in zip(paths, genome_data()):
            write_seg(path, chrom)
        demo, seg = genome_model(paths)
    first = define_chunks(seg, 4)[0]
    for _ in range(times):
        print("lockstep genome path, first chunk: "
              + first_divergence(demo, seg, num_particles, device,
                                 (first.start, first.end)), flush=True)


def _logl_rows(path):
    with open(path) as fh:
        rows = [ln.split() for ln in fh]
    return [dict(zip(rows[0], r)) for r in rows[1:]]


def run_cli(data: str, seed: int, num_particles: int, device: str,
            scan: str = "block") -> None:
    """One ``smc2-torch`` run in this process; prints what it found."""
    from .cli import smcsmc_main

    if scan == "cumsum":
        smc.systematic_resample = _resample_with_cumsum

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out")
        run = ["-o", out, "-Np", str(num_particles), "-seed", str(seed),
               "-device", device]
        common = [*run, *MODEL]
        if data in ("main", "vb", "apf", "apf8", "bias_guide", "alpha",
                    "arg"):
            seg = os.path.join(tmp, "bench.seg")
            demo, chrom = apf8_data() if data == "apf8" else bench_data()
            write_seg(seg, chrom)
            guide = write_constant_guide(
                os.path.join(tmp, "g.recomb_guide.gz"), demo)
            flags = {"main": ["-EM", "0"], "vb": ["-EM", "2", "-vb"],
                     "apf": ["-EM", "0", "-apf", "2"],
                     "apf8": ["-EM", "0", "-apf", "2"],
                     "bias_guide": ["-EM", "0", *BIAS_GUIDE_FLAGS,
                                    "-guide", guide],
                     "alpha": ["-EM", "1", "-alpha", "0.5"],
                     "arg": ["-EM", "1", "-arg"]}[data]
            smcsmc_main(["-seg", seg, *flags, "-P", "133", "133016",
                         "7*1", *common])
            if data in ("alpha", "arg"):
                _print_digests(out, f"{data} path seed {seed}",
                               "recomb" if data == "alpha" else "trees",
                               (0, 1))
        elif data in ("twopop", "twopop_arg"):
            seg = os.path.join(tmp, "twopop.seg")
            write_seg(seg, twopop_data()[1])
            flags = (["-EM", "2"] if data == "twopop"
                     else ["-EM", "0", "-arg"])
            smcsmc_main(["-seg", seg, *flags, *twopop_flags(), *run])
            if data == "twopop_arg":
                _print_digests(out, f"{data} path seed {seed}", "trees",
                               (0,))
        else:
            paths = [os.path.join(tmp, n) for n in ("a.seg", "b.seg")]
            for path, chrom in zip(paths, genome_data()):
                write_seg(path, chrom)
            smcsmc_main(["-segs", *paths, "-chunks", "4", "-EM", "1", "-P",
                         *GENOME_PATTERN, *common])
        rows = _logl_rows(os.path.join(out, "result.out"))
    report(rows, data, f"{data} path seed {seed} ({scan})")


def report(rows, data: str, label: str) -> None:
    """Print LogL per iteration of a ``result.out``'s rows and, for the
    genome path, the last iteration's epochs, for the twopop path each
    iteration's :func:`_twopop_summary`."""
    last = max(int(r["Iter"]) for r in rows)
    logl = {int(r["Iter"]): r["Count"] for r in rows if r["Type"] == "LogL"}
    print(f"{label}: LogL by iteration "
          f"{[logl[i] for i in sorted(logl)]}", flush=True)
    if data == "genome":
        coal = [r for r in rows if r["Type"] == "Coal"
                and int(r["Iter"]) == last]
        print("  epoch:coalescences/Ne "
              + " ".join(f"{r['Epoch']}:{float(r['Count']):.1f}/"
                         f"{float(r['Ne']):.0f}" for r in coal), flush=True)
    if data in ("twopop", "twopop_arg"):
        for it in sorted(logl):
            print(f"  iteration {it}: " + _twopop_summary(
                [r for r in rows if int(r["Iter"]) == it]), flush=True)


def _twopop_summary(rows) -> str:
    """Per population the epochs' coalescences/Ne and the pooled interior
    Ne (sum of opportunity over twice the sum of coalescences), and the
    pooled migration rate, of one iteration's rows."""
    coal = [r for r in rows if r["Type"] == "Coal"]
    last_epoch = max(int(r["Epoch"]) for r in coal)
    parts = []
    for q in sorted({r["From"] for r in coal}):
        mine = [r for r in coal if r["From"] == q]
        inner = [r for r in mine if 0 < int(r["Epoch"]) < last_epoch]
        pooled = (sum(float(r["Opp"]) for r in inner)
                  / (2.0 * sum(float(r["Count"]) for r in inner)))
        parts.append(f"population {q} epoch:coalescences/Ne "
                     + " ".join(f"{r['Epoch']}:{float(r['Count']):.1f}/"
                                f"{float(r['Ne']):.0f}" for r in mine)
                     + f", pooled interior Ne {pooled:.0f}")
    migr = [r for r in rows if r["Type"] == "Migr"]
    rate = (sum(float(r["Count"]) for r in migr)
            / sum(float(r["Opp"]) for r in migr))
    return "; ".join(parts) + f"; pooled migration rate {rate:.4g}"


def _tree_coalescence(sim, E: int, Pp: int):
    """Pairwise coalescence opportunity (generations x pairs of lineages in
    one population) and coalescences of a simulated tree, per (epoch,
    population)."""
    opp, cnt = np.zeros((E, Pp)), np.zeros((E, Pp))
    pt = sim.parent_time()
    root_h = float(sim.time[sim.root()])
    cuts = set(sim.time.tolist()) | set(sim.demo.change_times.tolist())
    for events in sim.mig_events:
        cuts |= {float(t) for t, _ in events}
    cuts = sorted(t for t in cuts if t < root_h) + [root_h]
    for a, b in zip(cuts[:-1], cuts[1:]):
        k = np.zeros(Pp)
        for i in np.flatnonzero((sim.time <= a) & (a < pt)):
            k[sim.branch_pop(int(i), a)] += 1
        opp[sim._epoch(a)] += k * (k - 1) / 2.0 * (b - a)
    for m in range(sim.n, len(sim.time)):
        t = float(sim.time[m])
        cnt[sim._epoch(t), sim._map(int(sim.pop[m]), t)] += 1
    return opp, cnt


def genealogy(demo, seed: int, seg=None):
    """The genealogy that ``simulate_seg(demo, seed)`` drew, replayed with
    the same random stream: per (epoch, population) the pairwise
    coalescence opportunity and the coalescences of every local tree, each
    weighted by the bp it spans.  Their ratio over two is the Ne that the
    data's own trees read.  With ``seg`` (what ``simulate_seg`` returned)
    the replayed sites are held to its sites.  Returns (opportunity,
    coalescences, trees)."""
    rng = np.random.default_rng(seed)
    sim = _Sim(demo, rng)
    L, mu, rho = (int(demo.sequence_length), demo.mutation_rate,
                  demo.recombination_rate)
    E, Pp = demo.pop_sizes.shape
    opp, cnt = np.zeros((E, Pp)), np.zeros((E, Pp))
    sites, trees, x = set(), 0, 0.0
    while x < L:  # simulate_seg's loop, drawing what it draws
        tl = sim.total_length()
        end = min(x + rng.exponential(1.0 / max(rho * tl, 1e-300)), L)
        o, c = _tree_coalescence(sim, E, Pp)
        opp += (end - x) * o
        cnt += (end - x) * c
        trees += 1
        n_mut = rng.poisson(mu * tl * (end - x))
        if n_mut:
            for pos in np.sort(rng.uniform(x, end, size=n_mut)):
                rng.uniform()  # the mutation's branch
                sites.add(int(pos) + 1)
        x = end
        if x < L:
            sim.recombine()
    if seg is not None and sorted(sites) != seg.positions[1:].tolist():
        raise RuntimeError("the replayed genealogy is not the data's")
    return opp, cnt, trees


def genealogy_report(demo, seed: int, seg=None) -> str:
    """:func:`genealogy` as one line: per population the epochs'
    coalescences per local tree (bp-weighted mean) and Ne, then each
    epoch's Ne pooled over the populations."""
    opp, cnt, trees = genealogy(demo, seed, seg)

    def ne(o, c):
        return f"{o / (2.0 * c):.0f}" if c > 0 else "-"

    per_tree = cnt / demo.sequence_length
    parts = [f"population {q} epoch:coalescences per tree/Ne " + " ".join(
        f"{e}:{per_tree[e, q]:.3f}/{ne(opp[e, q], cnt[e, q])}"
        for e in range(opp.shape[0])) for q in range(opp.shape[1])]
    pooled = " ".join(f"{e}:{ne(opp[e].sum(), cnt[e].sum())}"
                      for e in range(opp.shape[0]))
    return (f"genealogy of simulate_seg seed {seed} ({trees} trees over "
            f"{demo.sequence_length / 1e6:g} Mb"
            f"{', its sites equal to the data' if seg else ''}): "
            + "; ".join(parts) + f"; pooled over populations {pooled}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--np", type=int, default=10000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, nargs="*", default=[7, 7, 8, 9])
    ap.add_argument("--main-runs", type=int, default=3)
    ap.add_argument("--twopop-seeds", type=int, nargs="*", default=[7, 8, 9])
    ap.add_argument("--feature-runs", type=int, default=2,
                    help="runs of each feature path")
    ap.add_argument("--features", nargs="*", default=list(FEATURES),
                    choices=FEATURES, help="the feature paths to run")
    ap.add_argument("--scan", choices=("block", "cumsum"),
                    default="block", help="the resampler's scan")
    ap.add_argument("--lockstep", type=int, default=0, metavar="N",
                    help="only this: N pairs of sweeps side by side on each "
                    "path's data")
    ap.add_argument("--run", nargs=2, metavar=("DATA", "SEED"),
                    help="one run in this process (what the fresh processes "
                    "are started with)")
    ap.add_argument("--summary", nargs=2, metavar=("DATA", "RESULT_OUT"),
                    help="only this: what a run prints, from a result.out "
                    "that either package wrote")
    ap.add_argument("--genealogy", type=int, nargs="*", metavar="SEED",
                    help="only this: the Ne that the twopop data's own "
                    "trees read (seed 13: the data itself), on the CPU")
    args = ap.parse_args(argv)
    if args.summary:
        path = args.summary[1]
        report(_logl_rows(path), args.summary[0], path)
        return 0
    if args.genealogy is not None:
        demo, seg = twopop_data()
        for seed in args.genealogy or [13]:
            print(genealogy_report(demo, seed, seg if seed == 13 else None),
                  flush=True)
        return 0
    if args.run:
        run_cli(args.run[0], int(args.run[1]), args.np, args.device,
                args.scan)
        return 0
    if args.lockstep:
        lockstep(args.lockstep, args.np, args.device)
        return 0
    if args.scan == "block":
        for P in (args.np, 4096, 100000):
            print("\n".join(reductions(P, args.device)), flush=True)
    runs = ([("main", 7)] * args.main_runs
            + [("genome", s) for s in args.seeds]
            + [("twopop", s) for s in args.twopop_seeds]
            + [(data, 7) for data in args.features
               for _ in range(args.feature_runs)])
    for data, seed in runs:
        subprocess.run(
            [sys.executable, "-m", "smcsmc_tpu_torch.repeatability", "--np",
             str(args.np), "--device", args.device, "--scan", args.scan,
             "--run", data, str(seed)],
            check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
