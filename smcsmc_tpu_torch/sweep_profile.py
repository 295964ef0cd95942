"""Where the sweep's time goes, read from torch.profiler.

    python -m smcsmc_tpu_torch.sweep_profile [--np 10000] [--device cuda]
        [--trace chiprun_out/sweep_trace.json]

It sweeps bench.py's headline data (one population of Ne 10,000, n=4, 8
epochs from 0 and logspace(2.5, 5), 2 Mb, ``simulate_seg(seed=11)``) with
the port's segment step, as ``em.run_chunk`` does: the initial trees, then
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

from .em import EMConfig, start_sweep
from .demography import Demography
from .simulate import simulate_seg

_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx")


def bench_data(n: int = 4, E: int = 8, L: float = 2e6, seed: int = 11):
    """bench.py's ``single_pop_demo`` and its data."""
    change = np.concatenate([[0.0], np.logspace(2.5, 5.0, E - 1)])
    demo = Demography(
        change_times=change, pop_sizes=np.full((E, 1), 10000.0),
        mig_rates=np.zeros((E, 1, 1)), sample_pops=np.zeros(n, np.int32),
        mutation_rate=1e-8, recombination_rate=1e-9, sequence_length=L,
    )
    return demo, simulate_seg(demo, seed=seed)


def profile_sweep(demo, seg, num_particles: int, device: str = "cuda",
                  seed: int = 7, warm: int = 100, timed: int = 300,
                  profiled: int = 200, trace: str | None = None) -> dict:
    """Sweep the first ``warm + timed + profiled`` segments; return the
    report as a dict (times in ms and us, shares of the profiled wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = EMConfig(num_particles=num_particles, device=device)
    on_cuda = torch.device(device).type == "cuda"

    def sync():
        if on_cuda:
            torch.cuda.synchronize()

    t0 = time.monotonic()
    state, segs, step, _ = start_sweep(demo, seg, cfg, seed=seed)
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
    pass_ev = [e for e in on_dev if "segment_pass_kernel" in e.key]
    pass_n = sum(e.count for e in pass_ev)
    top = sorted(on_dev, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    return {
        "segments": profiled,
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
        f"({rep['segments']} segments)",
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
    args = ap.parse_args(argv)
    demo, seg = bench_data()
    rep = profile_sweep(demo, seg, args.np, args.device, trace=args.trace)
    print("\n".join(report_lines(rep)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
