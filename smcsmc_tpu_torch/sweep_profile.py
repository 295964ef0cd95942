"""Where the sweep's time goes, read from torch.profiler.

    python -m smcsmc_tpu_torch.sweep_profile [--np 10000] [--device cuda]
        [--data bench|genome|twopop|apf8|wide|wide64] [--biased] [--vb]
        [--apf LEVEL]
        [--guide] [--alpha A] [--arg] [--trace out/sweep_trace.json]

It sweeps bench.py's headline data (one population of Ne 10,000, n=4, 8
epochs from 0 and logspace(2.5, 5), 2 Mb, ``simulate_seg(seed=11)``) or,
with ``--data genome``, the first chunk of the whole-genome data of
:func:`genome_data` (n=8, 33 epochs, unphased, with missing stretches)
or, with ``--data twopop``, bench.py's two-population data
(:func:`twopop_data`: the migration pass) or, with ``--data apf8``,
bench.py's feature_apf8 data (:func:`apf8_data`: n=8, missing windows, an
unphased pair) or, with ``--data wide``, bench.py's headline demography
with n=16 (:func:`wide_data`: the wide kernels) or, with ``--data wide64``,
the same with n=64 over 200 kb
with the port's segment step, as ``em.run_chunk`` does (``--biased``: with
the production proposal of ``-bias_heights 0 0.05 -calibrate_lag 2`` at N0
10,000, bias strengths and lags calibrated from the model, as
:data:`BIASED_OPTIONS` says; ``--vb``: the VB variant of the pass, with
the tables of iteration 0; ``--apf LEVEL``: the auxiliary particle filter,
its lookahead after every pass; ``--guide``: bench.py's feature_bias_guide,
the constant guide of :func:`write_constant_guide` with
:data:`BIAS_GUIDE_OPTIONS`; ``--alpha A``: local recording into windows,
as iteration 0 of the guide loop; ``--arg``: ARG recording, the ARG
variant of the pass and the ring's gather at each resampling): the
initial trees, then
``warm`` segments, ``timed`` segments without the profiler (milliseconds
per segment), then ``profiled`` segments under torch.profiler.  It reports
the device time per segment and its share of the unprofiled and of the
profiled wall time, the device operations
and kernel launches per segment, the device time per launch of the
hand-written kernel (``segment_pass``) and the operations that take the
most device time.  ``chip_smoke.py``
prints the same report after its main path.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .demography import Demography
from .em import EMConfig, start_sweep
from .segio import SegData, define_chunks, merge_segs, write_seg
from .simulate import simulate_seg

_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx")


# bench.py's feature_bias_guide (bench.py:259-274): -bias_heights 0 0.01
# (400 generations at N0 10,000) -bias_strengths 2 1 and a constant guide
BIAS_GUIDE_OPTIONS = {"bias_heights": (400.0,), "bias_strengths": (2.0, 1.0)}
BIAS_GUIDE_FLAGS = ["-bias_heights", "0", "0.01", "-bias_strengths", "2",
                    "1"]


def write_constant_guide(path: str, demo: Demography,
                         window: int = 10000) -> str:
    """The synthetic constant guide bench.py writes for feature_bias_guide:
    rows of ``window`` bp over the sequence and one beyond, each at the
    model's recombination rate with every leaf's relative rate 1."""
    import gzip

    n = demo.num_samples
    L = int(demo.sequence_length)
    with gzip.open(path, "wt") as fh:
        fh.write("locus\tsize\trecomb_rate\t"
                 + "\t".join(str(i + 1) for i in range(n)) + "\n")
        for w in range(0, L + window, window):
            fh.write(f"{w}\t{window}\t{demo.recombination_rate:.4e}\t"
                     + "\t".join("1.0" for _ in range(n)) + "\n")
    return path


def bench_data(n: int = 4, E: int = 8, L: float = 2e6, seed: int = 11):
    """bench.py's ``single_pop_demo`` and its data."""
    change = np.concatenate([[0.0], np.logspace(2.5, 5.0, E - 1)])
    demo = Demography(
        change_times=change, pop_sizes=np.full((E, 1), 10000.0),
        mig_rates=np.zeros((E, 1, 1)), sample_pops=np.zeros(n, np.int32),
        mutation_rate=1e-8, recombination_rate=1e-9, sequence_length=L,
    )
    return demo, simulate_seg(demo, seed=seed)


def wide_data(n: int = 16, L: float = 2e6):
    """bench.py's ``single_pop_demo(n=16)`` and its data
    (``simulate_seg(seed=11)``, 2 Mb): eight diploid genomes, the wide
    kernels' path (2,664 records before the sweep's split).  With n=64
    and L=2e5 (:func:`wide64_data`) the wide kernels' cap."""
    return bench_data(n=n, L=L)


def wide64_data():
    """:func:`wide_data` with 64 haplotypes over 200 kb (403 records)."""
    return wide_data(n=64, L=2e5)


def apf8_data(L: float = 2e6):
    """bench.py's feature_apf8 data: :func:`bench_data` at n=8 with every
    leaf missing in one window of 100 kb out of four and the heterozygous
    sites of leaves 0 and 1 unphased."""
    demo, seg = bench_data(n=8, L=L)
    al = seg.alleles.copy()
    al[(seg.positions // 100_000) % 4 == 1] = -1
    het = (al[:, 0] + al[:, 1] == 1) & (al[:, 0] >= 0)
    al[het, 0] = 2
    al[het, 1] = 2
    return demo, SegData(positions=seg.positions, lengths=seg.lengths,
                         states=seg.states, alleles=al,
                         phased=np.array([False, False] + [True] * 6))


def twopop_demo(L: float = 2e6, E: int = 8, m: float = 5e-5,
                sample_pops=(0, 0, 1, 1)) -> Demography:
    """bench.py's ``twopop_demo``: two populations of Ne 10,000, samples
    [0, 0, 1, 1], 8 epochs from 0 and logspace(2.5, 5), symmetric
    migration m per generation in every epoch."""
    change = np.concatenate([[0.0], np.logspace(2.5, 5.0, E - 1)])
    mig = np.zeros((E, 2, 2))
    mig[:, 0, 1] = mig[:, 1, 0] = m
    return Demography(
        change_times=change, pop_sizes=np.full((E, 2), 10000.0),
        mig_rates=mig, sample_pops=np.array(sample_pops, np.int32),
        mutation_rate=1e-8, recombination_rate=1e-9, sequence_length=L,
    )


def caps_demo(m: float = 1e-4) -> Demography:
    """The migration kernel's caps (``MAX_LEAVES``, ``MAX_EPOCHS``,
    ``MAX_POPS``): four populations of Ne 10,000 with two samples each, 64
    epochs from 0 and logspace(2.5, 5), symmetric migration m per
    generation between every pair."""
    E, Pp = 64, 4
    mig = np.full((E, Pp, Pp), m)
    return Demography(
        change_times=np.concatenate([[0.0], np.logspace(2.5, 5.0, E - 1)]),
        pop_sizes=np.full((E, Pp), 10000.0), mig_rates=mig,
        sample_pops=np.repeat(np.arange(Pp, dtype=np.int32), 2),
        mutation_rate=1e-8, recombination_rate=1e-9, sequence_length=2e6,
    )


def twopop_data(L: float = 2e6, E: int = 8, m: float = 5e-5,
                seed: int = 13):
    """:func:`twopop_demo` and its data, simulated as bench.py's
    ``run_twopop_em`` does."""
    demo = twopop_demo(L, E, m)
    return demo, simulate_seg(demo, seed=seed)


def twopop_flags(E: int = 8, m: float = 5e-5, n0: float = 10000.0):
    """The ``smc2`` flags of :func:`twopop_data`'s model, times in 4 N0
    units: ``-I 2 2 2``, ``-eN t 1`` at the E - 1 change times and ``-em 0
    i j M`` both ways with M = 4 N0 m."""
    times = np.logspace(2.5, 5.0, E - 1) / (4.0 * n0)
    M = f"{4.0 * n0 * m:g}"
    flags = ["-N0", f"{n0:g}", "-mu", "1e-8", "-rho", "1e-9", "-I", "2", "2",
             "2"]
    for t in times:
        flags += ["-eN", repr(float(t)), "1"]
    return flags + ["-em", "0", "1", "2", M, "-em", "0", "2", "1", M]


# the whole-genome data, per chromosome and in its bp: (all-missing
# stretches: one of 250 kb, longer than -maxgap, where define_chunks splits,
# and one of 120 kb that a chunk sweeps over; the stretch where one diploid
# sample is missing; that sample)
GENOME_GAPS = ((((1_200_000, 1_450_000), (1_600_000, 1_720_000)),
                (300_000, 600_000), 1),
               (((900_000, 1_150_000), (300_000, 420_000)),
                (1_400_000, 1_700_000), 2))
GENOME_PATTERN = ("133", "133016", "31*1")  # the standard 31-epoch grid
# the EMConfig fields of ``-bias_heights 0 0.05 -calibrate_lag 2`` at N0
# 10,000 (0.05 x 4 N0 generations), the flags a production run adds
BIASED_OPTIONS = {"bias_heights": (2000.0,), "calibrate_lag": True,
          "lag_fraction": 2.0}
# the production proposal of the two-population path: those flags with
# -delay_migr (the delay keyed by the first coalescence or migration)
TWOPOP_PROPOSAL_FLAGS = ["-bias_heights", "0", "0.05", "-calibrate_lag", "2",
                         "-delay_migr"]
TWOPOP_PROPOSAL_OPTIONS = dict(BIASED_OPTIONS, delay_type="migr")


def unphase_and_blank(seg: SegData, all_missing, sample_missing,
                      sample: int) -> SegData:
    """``seg`` as an unphased VCF with gaps would give it: every
    heterozygous pair of leaves (2i, 2i+1) recoded to 2,2; the leaves of
    diploid ``sample`` missing in the segments that start inside
    ``sample_missing``; the segments that start inside each stretch of
    ``all_missing`` replaced by one segment with every leaf missing."""
    al = seg.alleles.astype(np.int8).copy()
    a, b = al[:, 0::2], al[:, 1::2]  # views: the two leaves of each sample
    het = (a >= 0) & (b >= 0) & (a != b)
    a[het] = 2
    b[het] = 2
    pos = seg.positions
    inside = (pos >= sample_missing[0]) & (pos < sample_missing[1])
    al[inside, 2 * sample:2 * sample + 2] = -1
    lengths = seg.lengths.copy()
    keep = np.ones(len(pos), bool)
    for lo, hi in all_missing:
        gap = np.flatnonzero((pos >= lo) & (pos < hi))
        g0, g1 = int(gap[0]), int(gap[-1]) + 1
        lengths[g0] = lengths[g0:g1].sum()
        al[g0] = -1
        keep[g0 + 1:g1] = False
    return SegData(positions=pos[keep], lengths=lengths[keep],
                   states=seg.states[keep], alleles=al[keep],
                   phased=np.zeros(al.shape[1], bool))


def genome_data(n: int = 8, L: float = 2e6, seeds=(21, 22),
                gaps=GENOME_GAPS):
    """A small whole genome: ``len(seeds)`` chromosomes of ``L`` bp, one
    population of Ne 10,000, ``n`` leaves (n/2 diploid samples), mu 1e-8,
    rho 1e-9, each passed through :func:`unphase_and_blank`.  Returns the
    list of SegData, one per chromosome."""
    truth = Demography(
        change_times=np.array([0.0]), pop_sizes=np.array([[10000.0]]),
        mig_rates=np.zeros((1, 1, 1)), sample_pops=np.zeros(n, np.int32),
        mutation_rate=1e-8, recombination_rate=1e-9, sequence_length=L,
    )
    return [unphase_and_blank(simulate_seg(truth, seed=seed), *gap)
            for seed, gap in zip(seeds, gaps)]


def genome_model(paths, maxgap: int = 200000):
    """The merged data of the .seg files ``paths`` and the model that
    ``smc2-torch -N0 10000 -mu 1e-8 -rho 1e-9 -P 133 133016 "31*1"`` starts
    from on them."""
    from .cli import build_demography

    seg, _ = merge_segs(list(paths), gap=maxgap)
    io = {"N0": 10000.0, "mu": 1e-8, "rho": 1e-9, "pattern": GENOME_PATTERN,
          "p_pattern": None, "tmax": 2.0, "length": None, "nsam": None}
    return build_demography(None, [], io, seg=seg), seg


def profile_sweep(demo, seg, num_particles: int, device: str = "cuda",
                  seed: int = 7, warm: int = 100, timed: int = 300,
                  profiled: int = 200, trace: str | None = None,
                  chunk=(None, None), guide_file: str | None = None,
                  **options) -> dict:
    """Sweep the first ``warm + timed + profiled`` segments (of the window
    ``chunk``) with the ``EMConfig`` ``options`` (for example
    :data:`BIASED_OPTIONS`) and the recombination guide ``guide_file``;
    return the report as a dict (times in ms and us, shares of the
    profiled wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = EMConfig(num_particles=num_particles, device=device, **options)
    on_cuda = torch.device(device).type == "cuda"

    def sync():
        if on_cuda:
            torch.cuda.synchronize()

    t0 = time.monotonic()
    state, segs, step, _, _ = start_sweep(demo, seg, cfg, chunk, seed,
                                          guide_file=guide_file)
    sync()
    init_s = time.monotonic() - t0
    if len(segs) < warm + timed + profiled:
        raise ValueError(f"{len(segs)} segments, fewer than "
                         f"{warm + timed + profiled}")
    for s in range(warm):
        state, _ = step(state, segs[s])
    sync()
    t0 = time.monotonic()
    for s in range(warm, warm + timed):
        state, _ = step(state, segs[s])
    sync()
    ms_per_segment = (time.monotonic() - t0) / timed * 1e3

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda
                                     else [])
    with profile(activities=acts) as prof:
        t0 = time.monotonic()
        for s in range(warm + timed, warm + timed + profiled):
            state, _ = step(state, segs[s])
        sync()
        wall_us = (time.monotonic() - t0) * 1e6
    if trace:
        prof.export_chrome_trace(trace)

    ka = prof.key_averages()
    on_dev = [e for e in ka if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in on_dev)
    # the hand-written kernel of csrc/trip.cu, by its name in the trace
    pass_ev = [e for e in on_dev if "segment_pass" in e.key]
    pass_n = sum(e.count for e in pass_ev)
    top = sorted(on_dev, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    return {
        "segments": profiled,
        "unphased_sites": int((segs.n_configs[:warm + timed + profiled] > 1)
                              .sum()),
        "mixed_segments": int((segs.leaf_status[:warm + timed + profiled]
                               == 0).sum()),
        "init_s": init_s,
        "ms_per_segment": ms_per_segment,
        "profiled_ms_per_segment": wall_us / profiled / 1e3,
        "device_ms_per_segment": dev_us / profiled / 1e3,
        # the profiler slows the host, not the device: the unprofiled wall
        # is the better estimate of the device's busy share in a real run
        "device_busy_share": dev_us / profiled / 1e3 / ms_per_segment,
        "device_busy_share_profiled": dev_us / wall_us,
        "device_ops_per_segment": sum(e.count for e in on_dev) / profiled,
        "launches_per_segment": sum(
            e.count for e in ka if e.key in _LAUNCH_CALLS) / profiled,
        "pass_launches": pass_n,
        "pass_us_per_launch": (sum(e.self_device_time_total for e in pass_ev)
                               / pass_n if pass_n else float("nan")),
        "top_device_ops": [
            {"name": e.key[:70], "share": e.self_device_time_total / dev_us,
             "per_segment": e.count / profiled,
             "us_per_call": e.self_device_time_total / e.count}
            for e in top],
    }


def report_lines(rep: dict) -> list[str]:
    """The report as printable lines."""
    lines = [
        f"sweep profile: initial trees and setup {rep['init_s']:.3f} s; "
        f"{rep['ms_per_segment']:.4f} ms/segment unprofiled, "
        f"{rep['profiled_ms_per_segment']:.4f} ms/segment under the profiler "
        f"({rep['segments']} segments; of all swept, "
        f"{rep['unphased_sites']} with more than one phase configuration "
        f"and {rep['mixed_segments']} with some leaves missing)",
        f"  device time {rep['device_ms_per_segment']:.4f} ms/segment: busy "
        f"{rep['device_busy_share']:.4f} of the unprofiled wall "
        f"({rep['device_busy_share_profiled']:.4f} of the profiled); "
        f"{rep['device_ops_per_segment']:.2f} device ops and "
        f"{rep['launches_per_segment']:.2f} kernel launch calls per segment; "
        f"segment_pass kernel {rep['pass_us_per_launch']:.2f} us per launch "
        f"over {rep['pass_launches']} launches",
    ]
    for op in rep["top_device_ops"]:
        lines.append(f"  {op['share']:7.2%} of device time, "
                     f"{op['per_segment']:6.2f}/segment, "
                     f"{op['us_per_call']:8.2f} us/call  {op['name']}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--np", type=int, default=10000, help="particles")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", default=None,
                    help="write a Chrome trace of the profiled segments here")
    ap.add_argument("--data", choices=("bench", "genome", "twopop", "apf8",
                                       "wide", "wide64"),
                    default="bench")
    ap.add_argument("--biased", action="store_true",
                    help="the production proposal (BIASED_OPTIONS)")
    ap.add_argument("--vb", action="store_true", help="-vb")
    ap.add_argument("--apf", type=int, default=0, help="-apf LEVEL")
    ap.add_argument("--guide", action="store_true",
                    help="feature_bias_guide (BIAS_GUIDE_OPTIONS)")
    ap.add_argument("--alpha", type=float, default=0.0,
                    help="-alpha: local recording")
    ap.add_argument("--arg", action="store_true", help="-arg")
    args = ap.parse_args(argv)
    chunk = (None, None)
    if args.data == "bench":
        demo, seg = bench_data()
    elif args.data == "apf8":
        demo, seg = apf8_data()
    elif args.data == "twopop":
        demo, seg = twopop_data()
    elif args.data in ("wide", "wide64"):
        demo, seg = wide_data() if args.data == "wide" else wide64_data()
    else:
        import os
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            paths = [os.path.join(tmp, f"chr{i}.seg")
                     for i, _ in enumerate(GENOME_GAPS)]
            for path, chrom in zip(paths, genome_data()):
                write_seg(path, chrom)
            demo, seg = genome_model(paths)
        c = define_chunks(seg, 4)[0]
        chunk = (c.start, c.end)
    options = dict(BIASED_OPTIONS if args.biased else {}, vb=args.vb,
                   apf=args.apf, alpha=args.alpha, record_arg=args.arg)
    if args.guide:
        import os
        import tempfile

        options.update(BIAS_GUIDE_OPTIONS)
        tmp = tempfile.mkdtemp()
        options["guide_file"] = write_constant_guide(
            os.path.join(tmp, "g.recomb_guide.gz"), demo)
    rep = profile_sweep(demo, seg, args.np, args.device, trace=args.trace,
                        chunk=chunk, **options)
    print("\n".join(report_lines(rep)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
