"""Where the wide kernels of ``csrc/trip.cu`` (more than 8 leaves) spend
their time, on one GPU.

    python3 tools/wide_probe.py [--source TRIP_CU] [resources] [work] [phases]
    python3 tools/wide_probe.py times DIR [DIR ...]
    python3 tools/wide_probe.py logl DIR [DIR ...]

Device time per launch as ``chip_smoke`` times it (CUDA events, best of 3 x
20 launches on fresh states queued behind a matrix product):

* ``resources``: registers, stack bytes, shared bytes, particles per block
  and per SM and the waves a launch of 10,000 particles takes
  (``kernel_resources``) for every wide kernel (``trip``, the plain and the
  biased pass with and without VB, the plain pass's ARG variant) at n = 9,
  16, 17, 33 and 64, E = 9.
* ``work``: the plain and the biased pass and ``trip`` at n=16 and n=64
  (E = 9), at one wave of particles (SMs x the particles an SM holds of the
  kernel) and at P=10,000: nobody recombining, every particle one trip,
  every particle 8 trips (uniforms for 8 trips, nobody's next recombination
  ever past the segment's end).
* ``phases``: a copy of the kernels with ``clock64()`` around the parts of
  a trip (the point; the hazard with its candidates and t_c; the
  coalescence target, the records and the ARG rows; the SPR; the refreshed
  summaries) and of the segment pass (entry loads and summaries, the final
  extension and the drain, the write-back), lane 0's cycles summed over
  the launch and divided by its counts, for the plain and the biased pass
  at n=16 and n=64 on the wide data's mean segment and at 50 kb.  The
  counters cost registers, so read the shares, not the totals.

``--source`` builds another ``trip.cu`` (a parent's, from a ``git archive``
under ``build/``) behind this tree's wrappers: the C interface is the same.

``times DIR [DIR ...]`` times, for each checkout DIR in a fresh process
started there (that checkout's ``chip_smoke``, wrappers and kernels), the
wide kernels at (P=10,000, n=16, E=9) and (10,000, 64, 9) on the wide data's
mean segment (``sweep_profile.wide_data`` and ``wide64_data``) and at 50 kb,
as ``chip_smoke.phase_time`` draws them (``_timing_case``): the plain pass
with and without VB and with nobody recombining ("idle"), the biased pass
with and without VB, ``trip``, the plain pass's ARG variant (a ring in
use); each beside the bound of its counted work (``chip_smoke._bounds``;
the ARG pass's as ``phase_time_arg`` counts it).  One JSON
line per DIR in the order given; give a parent checkout first and last, so
that two commits are compared within one call (parent, change, change,
parent).

``logl DIR [DIR ...]`` runs, for each checkout DIR in a fresh process
started there, ``chip_smoke.py``'s n=64 sweep (``wide64_data``) and the
wide path's first E-step (``wide_data``, n=16) at ``-Np 10000 -EM 0``
with seeds 7, 8 and 9, and prints each LogL in full: the spread over
seeds beside the change between checkouts.

Prints the card's name and power limit first.  Library builds go into
``build/`` (gitignored)."""

from __future__ import annotations

import ctypes
import json
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
from smcsmc_tpu_torch.kernels.trip import (  # noqa: E402
    kernel_resources,
    segment_pass,
    trip,
)

SOURCE = _build.SOURCE
P, E = cs.WIDE_P, 9
# (label, kernel_resources variant, keyword arguments)
KERNELS = (("trip", "trip", {}), ("plain", "segment_pass", {}),
           ("plain vb", "segment_pass", dict(vb=True)),
           ("plain arg", "segment_pass", dict(arg=True)),
           ("biased", "biased", {}), ("biased vb", "biased", dict(vb=True)))


def _use_source(text: str, name: str) -> _build.BuildInfo:
    """Build ``text`` as the trip library from ``build/<name>/trip.cu``."""
    d = ROOT / "build" / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "trip.cu").write_text(text)
    _build.SOURCE = d / "trip.cu"
    _build.load_trip_library.cache_clear()
    return _build.build_trip_library()


def _wide_ptxas(info: _build.BuildInfo) -> list[str]:
    """ptxas's lines of the wide kernels: name, registers and stack."""
    out, lines = [], info.log.splitlines()
    for j, ln in enumerate(lines):
        if "Compiling entry function" in ln and "wide_kernel" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
            out.append(name + ": " + " | ".join(
                x.strip() for x in lines[j + 1:j + 4]
                if "Function properties" not in x))
    return out


def resources():
    for n in (9, 16, 17, 33, 64):
        for label, variant, kw in KERNELS:
            r = kernel_resources(variant, n, E, **kw)
            print(f"resources {label} n={n} E={E}: registers "
                  f"{r['registers']}, stack {r['local_bytes']} B, shared "
                  f"{r['dynamic_shared_bytes']} B per block of "
                  f"{r['particles_per_block']}, {r['blocks_per_sm']} blocks "
                  f"= {r['particles_per_sm']} particles per SM, "
                  f"{r['waves_at_10000']} waves at 10,000", flush=True)


def _time(launch, fresh, filler):
    return cs._best_device_ms(launch, fresh, filler) * 1e3


def work(filler):
    for n in (16, 64):
        for label, variant, _ in (KERNELS[1], KERNELS[4], KERNELS[0]):
            r = kernel_resources(variant, n, E)
            wave = r["sms"] * r["particles_per_sm"]
            for Pw in (wave, P):
                row = []
                for what, T, active in (("nobody recombines", 1, False),
                                        ("1 trip", 1, True),
                                        ("8 trips", 8, True)):
                    L = 1e9 if active else 1000.0
                    c = cs.Case(Pw, n, E, 1, L=L, nr_scale=0.0, seed=5)
                    c.base["next_rec"].fill_(1.0 if active else 2 * L)
                    u = c.uniforms(T)
                    if variant == "trip":
                        t = _time(lambda st: c.run(trip, u, st), c.fresh,
                                  filler)
                    elif variant == "biased":
                        t = _time(lambda st: c.run_biased(segment_pass, u, st),
                                  c.fresh_biased, filler)
                    else:
                        t = _time(
                            lambda st: c.run_segment(segment_pass, u, st),
                            c.fresh_segment, filler)
                    row.append(f"{what} {t:.2f}")
                print(f"work {label} n={n} P={Pw}: " + ", ".join(row)
                      + " us per launch", flush=True)


# cycle sums in g_prof: 0 point, 1 hazard, 2 target and records, 3 SPR,
# 4 summaries, 5 entry, 6 final extension and drain, 7 write-back,
# 8 trips, 9 particles
PHASES = ("point", "hazard", "target and records", "SPR", "summaries",
          "entry", "final and drain", "write-back")


def _add(k: int, start: str) -> str:
    return (f"__syncwarp(gm); if (lane == 0) atomicAdd(&g_prof[{k}], "
            f"(unsigned long long)(clock64() - {start}));")


# (anchor, text put before it); anchors are lines that begin with them
TRIP_PROBES = (
    ("  int c = -1;", "  long long t_ = clock64();"),
    ("  // ---- SMC' hazard inversion", "  " + _add(0, "t_")
     + " t_ = clock64();"),
    ("  // ---- coalescence target", "  " + _add(1, "t_")
     + " t_ = clock64();"),
    ("  // ---- SPR: cut the branch above c", "  " + _add(2, "t_")
     + " t_ = clock64();"),
    ("  // ---- refreshed tree summaries", "  " + _add(3, "t_")
     + " t_ = clock64();"),
    ("  return TripEvent{(float)h_r", "  " + _add(4, "t_")
     + " if (lane == 0) atomicAdd(&g_prof[8], 1ull);"),
)
BODY_PROBES = (
    ("  const bool live = i < a.P;", "  long long s_ = clock64();"),
    ("  bool moved = false;", "  " + _add(5, "s_")
     + " if (lane == 0) atomicAdd(&g_prof[9], 1ull);"),
    ("  // ---- final extension to the segment end", "  s_ = clock64();"),
    ("  // ---- push the segment's statistics into FIFO slot 0",
     "  " + _add(6, "s_") + " s_ = clock64();"),
    ("  if (lane == 0) {\n    a.next_rec[i] = nr;\n    a.log_w[i] = lw;",
     "  " + _add(7, "s_")),
)


def _insert(lines, start, stop, probes):
    """Put each probe's text before the first line in [start, stop) that
    begins its anchor (an anchor of several lines: consecutive lines), or
    after its last line where the anchor starts with ">"."""
    put = {}
    for anchor, text in probes:
        after = anchor.startswith(">")
        first = anchor.lstrip(">").split("\n")
        j = next((j for j in range(start, stop - len(first) + 1)
                  if all(lines[j + q].startswith(first[q])
                         for q in range(len(first)))), None)
        if j is None:
            raise SystemExit(f"probe: anchor not found: {first[0]!r}")
        put.setdefault(j + len(first) if after else j, []).append(text)
    out = []
    for j, ln in enumerate(lines):
        out += put.get(j, [])
        out.append(ln)
    return out


def _span(lines, marker):
    at = next(j for j, ln in enumerate(lines) if marker in ln)
    end = next(j for j in range(at, len(lines)) if lines[j].startswith("}"))
    return at, end


def _instrumented(src: str) -> str:
    lines = src.split("\n")
    lines = _insert(lines, *_span(lines, "TripEvent wide_trip("), TRIP_PROBES)
    lines = _insert(lines, *_span(lines, "void wide_segment_body("),
                    BODY_PROBES)
    text = "\n".join(lines)
    # one counter array in each unit's anonymous namespace; the wide unit's
    # is read
    text = text.replace("namespace {\n", "namespace {\n__device__ unsigned "
                        "long long g_prof[16];\n", 1)
    return text + """
#if SMC_WIDE
extern "C" int smc_wide_prof_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  if (e != cudaSuccess) return (int)e;
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
#endif
"""


def _wide_means():
    from smcsmc_tpu_torch.segio import split_long_segments
    from smcsmc_tpu_torch.sweep_profile import wide64_data, wide_data

    return {n: float(split_long_segments(data()[1], cs.MAX_SEG)
                     .lengths.mean())
            for n, data in ((16, wide_data), (64, wide64_data))}


def phases(source_text: str):
    info = _use_source(_instrumented(source_text), "wide_probe_phases")
    for ln in _wide_ptxas(info):
        print(f"phases ptxas: {ln}", flush=True)
    lib = _build.load_trip_library()
    lib.smc_wide_prof_read.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * 16)()
    means = _wide_means()
    for n in (16, 64):
        for label, L in (("mean segment", means[n]), ("50 kb", cs.MAX_SEG)):
            c, u = cs._timing_case(P, n, E, L)
            for kind in ("plain", "biased"):
                lib.smc_wide_prof_read(buf)
                if kind == "plain":
                    c.run_segment(segment_pass, u, c.fresh_segment())
                else:
                    c.run_biased(segment_pass, u, c.fresh_biased())
                torch.cuda.synchronize()
                lib.smc_wide_prof_read(buf)
                v = list(buf)
                parts = dict(zip(PHASES, v[:8]))
                total = max(sum(parts.values()), 1)
                tr, pa = max(v[8], 1), max(v[9], 1)
                print(f"phases {kind} n={n} {label} (L={L:.1f}): {v[9]} "
                      f"particles, {v[8]} trips; cycles per particle: "
                      + ", ".join(f"{k} {x / pa:.0f} ({x / total:.3f})"
                                  for k, x in parts.items())
                      + "; cycles per trip: " + ", ".join(
                          f"{k} {parts[k] / tr:.0f}" for k in PHASES[:5]),
                      flush=True)


RUN = """
import json, os, sys
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
import torch
from smcsmc_tpu_torch.kernels.trip import segment_pass, trip
from smcsmc_tpu_torch.segio import split_long_segments
from smcsmc_tpu_torch.sweep_profile import wide64_data, wide_data

means = {n: float(split_long_segments(d()[1], cs.MAX_SEG).lengths.mean())
         for n, d in ((16, wide_data), (64, wide64_data))}
filler = cs._filler()
out = {"dir": os.getcwd(), "rows": {}}
for n in (16, 64):
    for label, L in (("mean", means[n]), ("50 kb", cs.MAX_SEG)):
        c, u = cs._timing_case(10000, n, 9, L)
        vb = cs.vb_tables(c.demo, 5)
        c.fresh_biased()  # the ring and the section table
        aring = cs.arg_ring(c.P, c.n, c.gen)

        def arg_fresh():
            st = c.fresh_segment()
            st.update({k: v.clone() for k, v in aring.items()})
            return st

        def arg_run(st):
            segment_pass(u, c.leaf_status, *(st[k] for k in cs.SEGMENT_STATE),
                         st["fifo"], c.fifo_mask, st["tl"], c.L, cs.MU, cs.RHO,
                         c.start, c.inv2ne, c.has_data, None,
                         arg=cs._arg_of(st))
            return st

        def idle():
            st = c.fresh_segment()
            st["next_rec"] += 1e9
            return st

        # the counted work, as chip_smoke.phase_time counts it
        st = c.run(trip, u, c.fresh())
        trips = int(round(float(st["pending"][:, 5 * c.E:].sum())))
        active = int((c.base["next_rec"] < L).sum())
        st = c.run_segment(segment_pass, u, c.fresh_segment())
        pushed = int((st["fifo"][:, 0] != 0).sum())
        st = c.run_biased(segment_pass, u, c.fresh_biased())
        moved = int(sum((st[k] != c.ring[k]) for k in (
            "df_pos", "df_logf", "df_delta", "df_k")).gt(0).sum())
        b = cs._bounds(c, active, trips, pushed, moved)
        st = c.run_segment(segment_pass, u, idle())
        b_idle = cs._bounds(c, 0, 0, int((st["fifo"][:, 0] != 0).sum()))
        rows = int(cs._arg_rows(arg_run(arg_fresh()), aring))
        N = 2 * n - 1
        bound = {"trip": b["trip"], "plain": b["segment_pass"],
                 "plain idle": b_idle["segment_pass"],
                 "plain vb": cs._with_vb(b["segment_pass"], 9, 1, trips),
                 "biased": b[cs.BIASED_PASS],
                 "biased vb": cs._with_vb(b[cs.BIASED_PASS], 9, 1, trips),
                 "plain arg": cs._bound_of(
                     b["segment_pass"]["bytes"] + 4 * c.P + 4 * active
                     + 19 * rows,
                     b["segment_pass"]["flop"] + trips * 2 * n * N)}
        runs = {
            "trip": (c.fresh, lambda st: c.run(trip, u, st)),
            "plain": (c.fresh_segment,
                      lambda st: c.run_segment(segment_pass, u, st)),
            "plain idle": (idle,
                           lambda st: c.run_segment(segment_pass, u, st)),
            "plain vb": (c.fresh_segment, lambda st: c.run_segment(
                segment_pass, u, st, vb=vb)),
            "biased": (c.fresh_biased,
                       lambda st: c.run_biased(segment_pass, u, st)),
            "biased vb": (c.fresh_biased, lambda st: c.run_biased(
                segment_pass, u, st, vb=vb)),
            "plain arg": (arg_fresh, arg_run)}
        for name, (fresh, launch) in runs.items():
            ms = cs._best_device_ms(launch, fresh, filler)
            out["rows"][f"n={n} {label} {name}"] = dict(
                us=ms * 1e3, bound_us=bound[name]["bound_ms"] * 1e3,
                bound_by=bound[name]["bound_by"],
                share=bound[name]["bound_ms"] / ms)
        out["rows"][f"n={n} {label}"] = dict(L=L, active=active, trips=trips,
                                             pushed=pushed, moved=moved,
                                             arg_rows=rows)
print("WIDE_TIMES " + json.dumps(out), flush=True)
"""


LOGL = """
import os, sys
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
from smcsmc_tpu_torch.sweep_profile import wide64_data, wide_data

for name, data in (("n=64 sweep", wide64_data), ("n=16 E-step", wide_data)):
    seg = data()[1]
    for seed in (7, 8, 9):
        steps = cs._run_wide(["-EM", "0", "-seed", str(seed)], seg)[2]
        print(f"WIDE_LOGL {os.getcwd()} {name} seed {seed}: LogL "
              f"{[r.args[4] for r in steps]!r}", flush=True)
"""


def logl(dirs):
    for d in dirs:
        proc = subprocess.run([sys.executable, "-c", LOGL],
                              cwd=os.path.abspath(d), capture_output=True,
                              text=True)
        print("\n".join(ln for ln in proc.stdout.splitlines()
                        if ln.startswith("WIDE_LOGL ")), flush=True)
        if proc.returncode != 0:
            print(proc.stderr, flush=True)
            return proc.returncode
    return 0


def times(dirs):
    rows = []
    for d in dirs:
        proc = subprocess.run([sys.executable, "-c", RUN],
                              cwd=os.path.abspath(d), capture_output=True,
                              text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, flush=True)
            return proc.returncode
        line = next(ln for ln in proc.stdout.splitlines()
                    if ln.startswith("WIDE_TIMES "))
        rows.append(json.loads(line[len("WIDE_TIMES "):]))
        print(line, flush=True)
    for key in rows[0]["rows"]:
        if "us" not in rows[0]["rows"][key]:
            continue
        print(f"{key}: " + ", ".join(
            f"{r['dir'].rsplit('/', 1)[-1]} {r['rows'][key]['us']:.2f} us "
            f"({r['rows'][key]['share']:.4f} of "
            f"{r['rows'][key]['bound_us']:.3f} us)"
            for r in rows if key in r["rows"]), flush=True)
    return 0


def main(argv):
    if not torch.cuda.is_available():
        print("wide_probe: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    if argv[:1] == ["times"]:
        return times(argv[1:] or [str(ROOT)])
    if argv[:1] == ["logl"]:
        return logl(argv[1:] or [str(ROOT)])
    source = SOURCE
    if argv[:1] == ["--source"]:
        source, argv = Path(argv[1]).resolve(), argv[2:]
    text = source.read_text()
    what = argv or ["resources", "work", "phases"]
    info = _use_source(text, "wide_probe")
    print(f"built {source} in {info.seconds:.1f} s", flush=True)
    for ln in _wide_ptxas(info):
        print(f"ptxas: {ln}", flush=True)
    filler = cs._filler()
    if "resources" in what:
        resources()
    if "work" in what:
        work(filler)
    if "phases" in what:
        phases(text)
    _build.SOURCE = SOURCE
    _build.load_trip_library.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
