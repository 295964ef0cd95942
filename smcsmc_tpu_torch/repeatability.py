"""Does the sweep repeat from run to run, and how far do the whole-genome
path's estimates spread over seeds?

    python -m smcsmc_tpu_torch.repeatability [--np 10000] [--device cuda]
        [--seeds 7 7 8 9] [--main-runs 3] [--scan cumsum]
    python -m smcsmc_tpu_torch.repeatability --lockstep 3

Three measurements, each printed as it ends:

1. the device reductions of the segment step, repeated on one input and
   held bit for bit to their first result, with a matrix product queued now
   and then so that the card's timing varies: the resampler's scan of the
   normalised weights (``smc.block_scan``) beside ``torch.cumsum``, which
   it replaced, ``logsumexp`` (the normaliser's) and the weighted column
   sum of a [P, 198] block (the commit's), at P, 4096 and 100,000;
2. the log-likelihood of the smoke's main path (``sweep_profile.bench_data``,
   one E-step) in ``--main-runs`` fresh processes with one seed;
3. the whole-genome path (``sweep_profile.genome_data``, ``-chunks 4 -EM 1
   -P 133 133016 "31*1"``) once per entry of ``--seeds``, each in a fresh
   process: LogL per iteration, and per epoch of the last iteration the
   posterior coalescences and the Ne estimate.  A seed given twice shows
   whether a whole run repeats.

``--lockstep N`` instead sweeps the main path's data and the genome path's
first chunk N times each as two sweeps of one seed side by side in one
process, holds every field of the two states bit for bit after every
segment and reports the first segment at which they part: the fields, how
many particles, and whether that segment resampled.

``--scan cumsum`` repeats 2 and 3 with the resampler's scan replaced by
``torch.cumsum``, the single-pass scan across blocks that the sweep used
before ``block_scan``: if those runs part and the others do not, that scan
is what kept a run from repeating.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import torch

from . import smc
from .segio import define_chunks, write_seg
from .sweep_profile import (
    GENOME_PATTERN,
    bench_data,
    genome_data,
    genome_model,
)

MODEL = ["-N0", "10000", "-mu", "1e-8", "-rho", "1e-9"]


def reductions(P: int, device: str, repeats: int = 20000) -> list[str]:
    """Count the repeats of each reduction that differ from the first."""
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    log_w = torch.randn(P, generator=gen, device=device) * 3
    w = torch.softmax(log_w, 0)
    block = torch.rand(P, 198, generator=gen, device=device)
    filler = torch.randn(2048, 2048, device=device)
    ops = {"block scan": lambda: smc.block_scan(w),
           "cumsum": lambda: w.cumsum(0),
           "logsumexp": lambda: torch.logsumexp(log_w, 0),
           "weighted sum": lambda: (block * w[:, None]).sum(0)}
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
        out = dict(state.trees._asdict())
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
        common = ["-o", out, "-Np", str(num_particles), *MODEL, "-seed",
                  str(seed), "-device", device]
        if data == "main":
            seg = os.path.join(tmp, "bench.seg")
            write_seg(seg, bench_data()[1])
            smcsmc_main(["-seg", seg, "-EM", "0", "-P", "133", "133016",
                         "7*1", *common])
        else:
            paths = [os.path.join(tmp, n) for n in ("a.seg", "b.seg")]
            for path, chrom in zip(paths, genome_data()):
                write_seg(path, chrom)
            smcsmc_main(["-segs", *paths, "-chunks", "4", "-EM", "1", "-P",
                         *GENOME_PATTERN, *common])
        rows = _logl_rows(os.path.join(out, "result.out"))
    last = max(int(r["Iter"]) for r in rows)
    logl = {int(r["Iter"]): r["Count"] for r in rows if r["Type"] == "LogL"}
    print(f"{data} path seed {seed} ({scan}): LogL by iteration "
          f"{[logl[i] for i in sorted(logl)]}", flush=True)
    if data == "genome":
        coal = [r for r in rows if r["Type"] == "Coal"
                and int(r["Iter"]) == last]
        print("  epoch:coalescences/Ne "
              + " ".join(f"{r['Epoch']}:{float(r['Count']):.1f}/"
                         f"{float(r['Ne']):.0f}" for r in coal), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--np", type=int, default=10000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, nargs="*", default=[7, 7, 8, 9])
    ap.add_argument("--main-runs", type=int, default=3)
    ap.add_argument("--scan", choices=("block", "cumsum"),
                    default="block", help="the resampler's scan")
    ap.add_argument("--lockstep", type=int, default=0, metavar="N",
                    help="only this: N pairs of sweeps side by side on each "
                    "path's data")
    ap.add_argument("--run", nargs=2, metavar=("DATA", "SEED"),
                    help="one run in this process (what the fresh processes "
                    "are started with)")
    args = ap.parse_args(argv)
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
    runs = [("main", 7)] * args.main_runs + [("genome", s) for s in args.seeds]
    for data, seed in runs:
        subprocess.run(
            [sys.executable, "-m", "smcsmc_tpu_torch.repeatability", "--np",
             str(args.np), "--device", args.device, "--scan", args.scan,
             "--run", data, str(seed)],
            check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
