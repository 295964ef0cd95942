"""Where the migration pass of ``segment_pass`` spends its time, on one GPU.

    python3 tools/migration_probe.py [work] [caps] [phases]

At the twopop path's shape (n=4, E=8, Pp=2, Mw=56; the cases of
``chip_smoke.MigCase``), with device time per launch as ``chip_smoke``
times it (CUDA events, best of 3 x 20 launches):

* ``work``: the kernel as built, at one wave of particles (P = SMs x the
  warps an SM holds) and at P=10,000: nobody recombining; one trip with
  walks capped at 1 event; one trip with whole walks; 8 trips, capped and
  whole.  Differences between the rows price the parts of a trip.
* ``caps``: the register cap (``MIG_MIN_BLOCKS`` of ``csrc/trip.cu``, the
  resident blocks the compiler must allow) against registers, stack bytes
  and time at the twopop data's mean segment and at 50 kb; two rounds in
  opposite order.
* ``phases``: a copy of the kernel with ``clock64()`` around the phases of
  a trip (point, walk, routing, summaries) and of a walk event (branch
  scan, scalar logic, the rest), lane 0's sums divided by its counts; the
  counters cost registers, so read the shares, not the totals.

Prints the card's name and power limit first.  Library builds go into
``build/`` (gitignored)."""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
os.chdir(ROOT)

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402
from smcsmc_tpu_torch.kernels import _build  # noqa: E402
from smcsmc_tpu_torch.kernels.tree import Trees, tree_summaries  # noqa: E402
from smcsmc_tpu_torch.kernels.trip import (  # noqa: E402
    kernel_resources,
    segment_pass,
)
from smcsmc_tpu_torch.segio import split_long_segments  # noqa: E402
from smcsmc_tpu_torch.sweep_profile import twopop_data  # noqa: E402

SOURCE = _build.SOURCE
CAP_LINE = "#define MIG_MIN_BLOCKS "


def _use_source(text: str, name: str) -> _build.BuildInfo:
    """Build ``text`` as the trip library from ``build/<name>/trip.cu``."""
    d = ROOT / "build" / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "trip.cu").write_text(text)
    _build.SOURCE = d / "trip.cu"
    _build.load_trip_library.cache_clear()
    return _build.build_trip_library()


def _ptxas_of_mig(info: _build.BuildInfo) -> str:
    lines = info.log.splitlines()
    for j, ln in enumerate(lines):
        if "segment_pass_mig_kernelILb0E" in ln and j + 2 < len(lines):
            return f"{lines[j + 1].strip()} | {lines[j + 2].strip()}"
    return "(no ptxas output)"


def _segment_case(P, L):
    """A MigCase as a segment of length L finds it, uniforms for 64 trips."""
    c = cs.MigCase(P, 1, L, 0.0, seed=99)
    b = c.base
    tl, _, _ = tree_summaries(
        Trees(b["parent"], b["time"], b["child0"], b["child1"]), c.epochs,
        1, c.has_data)
    expo = torch.empty(P, device="cuda").exponential_(1.0, generator=c.gen)
    b["next_rec"] = (expo / (cs.RHO * tl)).contiguous()
    return c, c.uniforms(64)


def _time(c, u, filler):
    def launch(st, u=u, c=c):
        c.run(segment_pass, u, st)

    return cs._best_device_ms(launch, c.fresh, filler) * 1e3


def work(filler):
    res = kernel_resources("migration", 4, 8, 2, cs.TWOPOP_MW)
    print(f"resources: {res}", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    wave = sms * res["blocks_per_sm"] * res["particles_per_block"]
    for P in (wave, cs.TWOPOP_P):
        for label, T, max_ev, active in (
                ("nobody recombines", 1, None, False),
                ("1 trip, walks capped at 1 event", 1, 1, True),
                ("1 trip, whole walks", 1, None, True),
                ("8 trips, walks capped at 1 event", 8, 1, True),
                ("8 trips, whole walks", 8, None, True)):
            L = 1e9 if active else 1000.0
            c = cs.MigCase(P, 1, L, 0.0, seed=5, max_walk_events=max_ev)
            c.base["next_rec"].fill_(1.0 if active else 2 * L)
            print(f"work P={P}: {label}: {_time(c, c.uniforms(T), filler):.2f}"
                  f" us per launch", flush=True)


def caps(filler, mean_len):
    src = SOURCE.read_text()
    line = next(ln for ln in src.splitlines() if ln.startswith(CAP_LINE))
    values = (16, 14, 12, 10, 8)
    for rnd, order in enumerate((values, values[::-1])):
        for mb in order:
            info = _use_source(src.replace(line, f"{CAP_LINE}{mb}"),
                               f"probe_cap{mb}")
            if info.built:
                print(f"caps MIG_MIN_BLOCKS {mb}: ptxas {_ptxas_of_mig(info)}",
                      flush=True)
            res = kernel_resources("migration", 4, 8, 2, cs.TWOPOP_MW)
            times = [_time(*_segment_case(cs.TWOPOP_P, L), filler)
                     for L in (mean_len, cs.MAX_SEG)]
            print(f"caps round {rnd} MIG_MIN_BLOCKS {mb}: registers "
                  f"{res['registers']}, local {res['local_bytes']} B, "
                  f"{res['blocks_per_sm']} blocks per SM: mean segment "
                  f"{times[0]:.2f} us, 50 kb {times[1]:.2f} us", flush=True)
    _build.SOURCE = SOURCE
    _build.load_trip_library.cache_clear()


# (anchor in the kernel, text put before it); P_ holds cycle sums by phase
PHASES = ("point", "walk", "route", "summaries", "event scan",
          "event scalars", "event rest", "events", "trips")
PROBES = (
    ("  extern __shared__ float smem[];",
     "  long long P_[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0}, c1_ = 0, c2_ = 0;"),
    ("    // ---- uniform point: running sum",
     "    c1_ = clock64(); P_[8] += 1;"),
    ("    // ---- the loop walk from (c, h_r)",
     "    P_[0] += clock64() - c1_; c1_ = clock64();"),
    ("      const uint4 r4 = r4_next;", "      c2_ = clock64(); P_[7] += 1;"),
    ("      const unsigned members = __ballot_sync(WARP_ALL, member);",
     "      __syncwarp(); P_[4] += clock64() - c2_; c2_ = clock64();"),
    ("      const float x = u24(r4.y) * rate;",
     "      __syncwarp(); P_[5] += clock64() - c2_; c2_ = clock64();"),
    ("    if (!done) {  // capped",
     "      __syncwarp(); P_[6] += clock64() - c2_;"),
    ("    // ---- the SPR with buffer routing",
     "    P_[1] += clock64() - c1_; c1_ = clock64();"),
    ("    // ---- refreshed summaries, then the next gap",
     "    P_[2] += clock64() - c1_; c1_ = clock64();"),
    ("    moved = true;", "    P_[3] += clock64() - c1_;"),
    ("    if (capped > 0.0f) atomicAdd(&a.diag[0], (double)capped);",
     "    for (int q = 0; q < 9; ++q) atomicAdd(&g_prof[q], "
     "(unsigned long long)P_[q]);"),
)


def phases(mean_len):
    lines = SOURCE.read_text().split("\n")
    start = next(j for j, ln in enumerate(lines)
                 if ln.startswith("segment_pass_mig_kernel("))
    put = {}
    for anchor, text in PROBES:
        j = next(j for j in range(start, len(lines)) if anchor in lines[j])
        if anchor.startswith("    if (!done)"):
            j -= 1  # inside the event loop, before its closing brace
        put.setdefault(j, []).append(text)
    out = []
    for j, ln in enumerate(lines):
        out += put.get(j, [])
        out.append(ln)
    text = "\n".join(out).replace(
        "namespace {\n", "__device__ unsigned long long g_prof[16];\n"
        "namespace {\n", 1)
    text += """
extern "C" int smc_prof_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  if (e != cudaSuccess) return (int)e;
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
"""
    info = _use_source(text, "probe_phases")
    print(f"phases: ptxas {_ptxas_of_mig(info)}", flush=True)
    lib = _build.load_trip_library()
    lib.smc_prof_read.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * 16)()
    for label, L in (("mean segment", mean_len), ("50 kb", cs.MAX_SEG)):
        c, u = _segment_case(cs.TWOPOP_P, L)
        lib.smc_prof_read(buf)
        c.run(segment_pass, u, c.fresh())
        torch.cuda.synchronize()
        lib.smc_prof_read(buf)
        v = dict(zip(PHASES, list(buf)))
        tr, ev = max(v["trips"], 1), max(v["events"], 1)
        print(f"phases {label}: {v['trips']} trips, "
              f"{v['events']} walk events; cycles per trip: "
              + ", ".join(f"{k} {v[k] / tr:.0f}"
                          for k in ("point", "walk", "route", "summaries"))
              + "; cycles per walk event: "
              + ", ".join(f"{k} {v[k] / ev:.0f}" for k in
                          ("event scan", "event scalars", "event rest")),
              flush=True)
    _build.SOURCE = SOURCE
    _build.load_trip_library.cache_clear()


def main(argv):
    what = argv or ["work", "caps", "phases"]
    if not torch.cuda.is_available():
        print("migration_probe: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    _, seg = twopop_data()
    mean_len = float(split_long_segments(seg, cs.MAX_SEG).lengths.mean())
    filler = cs._filler()
    if "work" in what:
        work(filler)
    if "caps" in what:
        caps(filler, mean_len)
    if "phases" in what:
        phases(mean_len)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
