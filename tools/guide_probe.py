"""Where the guided passes of ``csrc/trip.cu`` (the biased pass with a
recombination guide, with and without local recording) spend their time,
on one GPU.

    python3 tools/guide_probe.py [--source TRIP_CU] [resources] [work] [phases]
    python3 tools/guide_probe.py times DIR [DIR ...]

Device time per launch as ``chip_smoke`` times it (CUDA events, best of 3 x
20 launches on fresh states queued behind a matrix product):

* ``resources``: registers, stack bytes, shared bytes, blocks per SM and
  the waves a launch of 10,000 particles takes (``kernel_resources``) of
  the biased, the guided and the guided local pass, each with and without
  VB, at (n=4, E=9, 2 sections), (8, 33, 2) and the caps (8, 64, 8).
* ``work``: the biased, guided and guided local passes at (10,000, 4, 9)
  and (10,000, 8, 33): nobody recombining, every particle one trip, every
  particle 8 trips (a 1 Mb segment, nobody's chain past its end), on
  ``chip_smoke``'s guide that changes in every window of 100 bp.
* ``phases``: a copy of the kernels with ``clock64()`` around the parts of
  a trip of the narrow passes (the extension with the guide's span; the
  branch rates: the leaves' rates, the ranks and their merge; the weighing
  and the running sums; the point's search and logarithms; the hazard;
  the target, the records and the local event; the SPR; the refreshed
  summaries; the gap, with the guide's mass and its inverse) and of the
  segment pass (entry; the final extension's span; the rest of the final
  extension and the drain; the write-back), lane 0's cycles summed over
  the launch and divided by its counts, for the biased, guided and guided
  local passes at (10,000, 4, 9) on the mean bench segment and at 50 kb
  and at (10,000, 8, 33) on the genome data's mean segment, each on the
  smoke's guide and on a 2 Mb guide.  The counters cost registers and
  syncs, so read the shares, not the totals.

The guides: ``chip_smoke._guide_of`` (random rates per window of 100 bp
over [0, front + 2L) with the front at 10 kb: about 130 windows at the
mean bench segment and 1100 at 50 kb), the same with rates constant over
rows of ``GUIDE_CHAIN_ROWS`` windows ("chain"), and a 2 Mb guide of 20,000
windows with the segment at its middle (front 1 Mb), the size of a sweep's
chunk.  ``--source`` builds another ``trip.cu`` (a parent's, from a ``git
archive`` under ``build/``) behind this tree's wrappers: the C interface is
the same.

``times DIR [DIR ...]`` times, for each checkout DIR in a fresh process
started there (that checkout's ``chip_smoke``, wrappers and kernels), the
biased, biased local, guided and guided local passes (the guided ones with
VB too at the mean segments) at (10,000, 4, 9) on the mean bench segment
and at 50 kb, each on the smoke's guide, the chain guide and the 2 Mb
guide, and at (10,000, 8, 33) on the genome data's mean segment on the
smoke's and the 2 Mb guide; each beside the bound of its counted work as
``chip_smoke.phase_time`` counts it.  One JSON line per DIR in the order
given; give a parent checkout first and last, so that two commits are
compared within one call (parent, change, change, parent).

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
from wide_probe import _insert, _span, _use_source  # noqa: E402
from smcsmc_tpu_torch.kernels.trip import (  # noqa: E402
    kernel_resources,
    segment_pass,
)

SOURCE = _build.SOURCE
P = 10000
# (label, flags of kernel_resources)
KERNELS = (("biased", {}), ("guided", dict(guide=True)),
           ("guided local", dict(guide=True, local=True)))
# each kind by the pass chip_smoke names
PASSES = {"biased": cs.BIASED_PASS, "guided": cs.GUIDE_PASS,
          "guided local": cs.GUIDE_LOCAL_PASS}
SHAPES = ((4, 9, 2), (8, 33, 2), (8, 64, 8))


def _biased_ptxas(info: _build.BuildInfo) -> list[str]:
    """ptxas's lines of the narrow biased kernels: name, registers, stack."""
    out, lines = [], info.log.splitlines()
    for j, ln in enumerate(lines):
        if "Compiling entry function" in ln and "biased_kernel" in ln \
                and "wide" not in ln:
            name = ln.split("'")[1] if "'" in ln else ln
            out.append(name + ": " + " | ".join(
                x.strip() for x in lines[j + 1:j + 4]
                if "Function properties" not in x))
    return out


def resources():
    for n, E, S in SHAPES:
        for label, kw in KERNELS:
            for vb in (False, True):
                r = kernel_resources("biased", n, E, S=S, vb=vb, **kw)
                print(f"resources {label}{' vb' if vb else ''} n={n} E={E} "
                      f"S={S}: registers {r['registers']}, stack "
                      f"{r['local_bytes']} B, shared "
                      f"{r['dynamic_shared_bytes']} B per block of "
                      f"{r['particles_per_block']}, {r['blocks_per_sm']} "
                      f"blocks = {r['particles_per_sm']} particles per SM, "
                      f"{r['waves_at_10000']} waves at 10,000", flush=True)


def _launcher(c, name, u):
    """(fresh, launch) of pass ``name`` on case ``c`` with uniforms ``u``."""
    if name == cs.BIASED_PASS:
        return c.fresh_biased, lambda st: c.run_biased(segment_pass, u, st)
    return (lambda: cs._fresh_new(c, name),
            lambda st: cs._run_new(c, segment_pass, u, st, name))


def work(filler):
    for n, E in ((4, 9), (8, 33)):
        for label, _ in KERNELS:
            row = []
            for what, T, active in (("nobody recombines", 1, False),
                                    ("1 trip", 1, True),
                                    ("8 trips", 8, True)):
                L = 1e6
                c = cs.Case(P, n, E, 1, L=L, nr_scale=0.0, seed=5)
                c.base["next_rec"].fill_(1.0 if active else 2 * L)
                fresh, launch = _launcher(c, PASSES[label], c.uniforms(T))
                ms = cs._best_device_ms(launch, fresh, filler)
                row.append(f"{what} {ms * 1e3:.2f}")
            print(f"work {label} n={n} E={E} P={P}: " + ", ".join(row)
                  + " us per launch", flush=True)


# cycle sums in g_prof, by index
PHASES = ("extension", "branch rates", "weighing", "point search",
          "hazard", "target and records", "SPR", "summaries", "gap",
          "trips", "entry", "particles", "final span", "final and drain",
          "write-back")
TRIP_PARTS = (0, 1, 2, 3, 4, 5, 6, 7, 8)
BODY_PARTS = (10, 12, 13, 14)


# each counter is spread over SLOTS addresses (a group's by its index), so
# that the groups' atomics do not queue on one address
SLOTS = 64
SLOT = f"((blockIdx.x * (BLOCK / GROUP) + threadIdx.x / GROUP) % {SLOTS})"


def _add(k: int, start: str) -> str:
    return (f"__syncwarp(gm); if (lane == 0) atomicAdd(&g_prof[{k * SLOTS} "
            f"+ {SLOT}], (unsigned long long)(clock64() - {start}));")


def _count(k: int) -> str:
    return f"if (lane == 0) atomicAdd(&g_prof[{k * SLOTS} + {SLOT}], 1ull);"


# (anchor, text) as wide_probe._insert takes them
TRIP_PROBES = (
    ("  // ---- extension: no-mutation likelihood",
     "  long long t_ = clock64();"),
    ("  int c = -1;", "  " + _add(0, "t_") + " t_ = clock64();"),
    ("    for (int j = lane; j < N; j += GROUP) {\n"
     "      const int p = w.par[j];",
     "    " + _add(1, "t_") + " t_ = clock64();"),
    ("    const float x = u_pt * wtot;",
     "    " + _add(2, "t_") + " t_ = clock64();"),
    ("  // ---- SMC' hazard inversion",
     "  " + _add(3, "t_") + " t_ = clock64();"),
    ("  // ---- coalescence target",
     "  " + _add(4, "t_") + " t_ = clock64();"),
    ("  // ---- SPR: cut the branch above c",
     "  " + _add(5, "t_") + " t_ = clock64();"),
    ("  // ---- refreshed tree summaries",
     "  " + _add(6, "t_") + " t_ = clock64();"),
    (">  summaries<NP>(tb, w, h, lane, gm, tl, B);",
     "  " + _add(7, "t_") + " t_ = clock64();"),
    ("  return TripEvent{h_r, t_c,", "  " + _add(8, "t_") + " " + _count(9)),
)
BODY_PROBES = (
    ("  const bool live = i < a.P;", "  long long s_ = clock64();"),
    ("  bool moved = false;", "  " + _add(10, "s_") + " " + _count(11)),
    ("  // ---- final extension to the segment end", "  s_ = clock64();"),
    ("  for (int e = lane; e < E; e += GROUP) pend[4 * E + e] += delta",
     "  " + _add(12, "s_") + " s_ = clock64();"),
    ("  // ---- push the segment's statistics into FIFO slot 0",
     "  " + _add(13, "s_") + " s_ = clock64();"),
    ("  if (lane == 0) {\n    a.next_rec[i] = nr;\n    a.log_w[i] = lw;",
     "  " + _add(14, "s_")),
)


def instrumented(src: str) -> str:
    """``src`` (a trip.cu) with the counters of ``phases`` in the narrow
    trip and segment pass, and ``smc_guide_prof_read`` to read them."""
    lines = src.split("\n")
    lines = _insert(lines, *_span(lines, "TripEvent one_trip("), TRIP_PROBES)
    lines = _insert(lines, *_span(lines, "void segment_pass_body("),
                    BODY_PROBES)
    text = "\n".join(lines)
    # one counter array in each unit's anonymous namespace; the narrow
    # unit's is read
    text = text.replace("namespace {\n", "namespace {\n__device__ unsigned "
                        f"long long g_prof[{16 * SLOTS}];\n", 1)
    return text + f"""
#if SMC_NARROW
extern "C" int smc_guide_prof_read(unsigned long long* out) {{
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  if (e != cudaSuccess) return (int)e;
  unsigned long long z[{16 * SLOTS}] = {{0}};
  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}}
#endif
"""


def _means():
    """The mean bench segment and the genome data's mean segment (bp)."""
    import numpy as np

    from smcsmc_tpu_torch.segio import split_long_segments
    from smcsmc_tpu_torch.sweep_profile import bench_data, genome_data

    bench = float(split_long_segments(bench_data()[1], cs.MAX_SEG)
                  .lengths.mean())
    genome = float(np.concatenate([
        split_long_segments(s, cs.MAX_SEG).lengths
        for s in genome_data()]).mean())
    return bench, genome


# the timed cells: (shape (n, E), label, which mean or 50 kb, guides)
CELLS = (((4, 9), "mean", "bench", ("smoke", "chain", "2 Mb")),
         ((4, 9), "50 kb", None, ("smoke", "chain", "2 Mb")),
         ((8, 33), "genome mean", "genome", ("smoke", "2 Mb")))

# A cell's case, in a checkout's own chip_smoke: `guide` "smoke" is
# chip_smoke's guide changing every window over [0, front + 2L), "chain"
# the same constant over rows of GUIDE_CHAIN_ROWS windows, "2 Mb" 20,000
# windows with the segment at its middle.  Sets cs.BIAS_FRONT, which the
# case's rings and runs read.
CASE = """
def guide_case(n, E, L, guide):
    import numpy as np
    from smcsmc_tpu_torch.kernels.guide import guide_tables

    cs.BIAS_FRONT = 1e6 if guide == "2 Mb" else 10000.0
    c, u = cs._timing_case(10000, n, E, L)
    rows = cs.GUIDE_CHAIN_ROWS if guide == "chain" else 1
    if guide == "2 Mb":
        rng = np.random.default_rng(c.P + c.E)
        W = 20000
        c._guide = guide_tables(cs.RHO * rng.uniform(0.2, 3.0, W),
                                rng.uniform(0.3, 2.0, (W, n)), cs.RHO,
                                cs.GUIDE_WINDOW, "cuda")
        c._guide_rows = 1
    else:
        cs._guide_of(c, rows)
    return c, u, rows
"""


def phases(source_text: str):
    info = _use_source(instrumented(source_text), "guide_probe_phases")
    for ln in _biased_ptxas(info):
        print(f"phases ptxas: {ln}", flush=True)
    lib = _build.load_trip_library()
    lib.smc_guide_prof_read.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * (16 * SLOTS))()
    bench, genome = _means()
    scope = {"cs": cs}
    exec(CASE, scope)
    for (n, E), label, which, guides in CELLS:
        L = {"bench": bench, "genome": genome, None: cs.MAX_SEG}[which]
        for guide in guides:
            if guide == "chain":
                continue
            c, u, rows = scope["guide_case"](n, E, L, guide)
            for kind, name in PASSES.items():
                if kind == "biased" and guide != "smoke":
                    continue
                fresh, launch = _launcher(c, name, u)
                st = fresh()
                lib.smc_guide_prof_read(buf)
                launch(st)
                torch.cuda.synchronize()
                lib.smc_guide_prof_read(buf)
                v = [sum(buf[k * SLOTS:(k + 1) * SLOTS]) for k in range(16)]
                tr, pa = max(v[9], 1), max(v[11], 1)
                trip = sum(v[k] for k in TRIP_PARTS)
                body = sum(v[k] for k in BODY_PARTS)
                print(f"phases {kind} n={n} E={E} {label} (L={L:.1f}) "
                      f"{guide if kind != 'biased' else 'no'} guide: "
                      f"{v[11]} particles, {v[9]} trips; cycles per trip "
                      f"{trip / tr:.0f}: " + ", ".join(
                          f"{PHASES[k]} {v[k] / tr:.0f} "
                          f"({v[k] / max(trip, 1):.3f})" for k in TRIP_PARTS)
                      + "; cycles per particle: trips "
                      f"{trip / pa:.0f}, " + ", ".join(
                          f"{PHASES[k]} {v[k] / pa:.0f}"
                          for k in BODY_PARTS)
                      + f"; the trips' share {trip / max(trip + body, 1):.3f}",
                      flush=True)
    cs.BIAS_FRONT = 10000.0


RUN = """
import json, os, sys
sys.path.insert(0, os.getcwd())
import numpy as np
import chip_smoke as cs
import torch
from smcsmc_tpu_torch.kernels.trip import segment_pass, trip
from smcsmc_tpu_torch.segio import split_long_segments
from smcsmc_tpu_torch.sweep_profile import bench_data, genome_data
""" + CASE + """
bench = float(split_long_segments(bench_data()[1], cs.MAX_SEG).lengths.mean())
genome = float(np.concatenate([split_long_segments(s, cs.MAX_SEG).lengths
                               for s in genome_data()]).mean())
CELLS = json.loads(sys.argv[1])
filler = cs._filler()
out = {"dir": os.getcwd(), "rows": {}}
for (n, E), label, which, guides in CELLS:
    L = {"bench": bench, "genome": genome, None: cs.MAX_SEG}[which]
    for guide in guides:
        c, u, rows = guide_case(n, E, L, guide)
        # the counted work, as chip_smoke.phase_time counts it
        st = c.run(trip, u, c.fresh())
        trips = int(round(float(st["pending"][:, 5 * c.E:].sum())))
        active = int((c.base["next_rec"] < L).sum())
        st = c.run_segment(segment_pass, u, c.fresh_segment())
        pushed = int((st["fifo"][:, 0] != 0).sum())
        st = c.run_biased(segment_pass, u, c.fresh_biased())
        moved = int(sum((st[k] != c.ring[k]) for k in (
            "df_pos", "df_logf", "df_delta", "df_k")).gt(0).sum())
        bounds = {cs.BIASED_PASS: cs._bounds(c, active, trips, pushed,
                                             moved)[cs.BIASED_PASS]}
        runs = {}
        if guide == "smoke":
            runs[cs.BIASED_PASS] = (c.fresh_biased, lambda st: c.run_biased(
                segment_pass, u, st))
        counted = {}
        for name in (cs.GUIDE_LOCAL_PASS, cs.GUIDE_PASS,
                     cs.BIASED_LOCAL_PASS):
            if name == cs.BIASED_LOCAL_PASS and guide != "smoke":
                continue
            (_, g, local), _ = cs.GUIDE_PASSES[name]
            st = cs._run_new(c, segment_pass, u, cs._fresh_new(c, name),
                             name, rows=rows)
            n_trips = (int((st["lr_pos"] != c.lring["lr_pos"]).sum())
                       + int(st["lr_dropped"]) if local
                       else counted[cs.GUIDE_LOCAL_PASS])
            counted[name] = n_trips
            mv = int(sum((st[k] != c.ring[k]) for k in (
                "df_pos", "df_logf", "df_delta", "df_k")).gt(0).sum())
            base = cs._bounds(c, active, n_trips,
                              int((st["fifo"][:, 0] != 0).sum()),
                              mv)[cs.BIASED_PASS]
            bounds[name] = cs._guide_bound(base, c, active, n_trips, name)
            runs[name] = (lambda name=name: cs._fresh_new(c, name),
                          lambda st, name=name: cs._run_new(
                              c, segment_pass, u, st, name, rows=rows))
            if which is not None and g:
                vb = cs.vb_tables(c.demo, 5)
                vname = cs.vb_name(name)
                bounds[vname] = cs._with_vb(bounds[name], E, 1, n_trips)
                runs[vname] = (lambda name=name: cs._fresh_new(c, name),
                               lambda st, name=name, vb=vb: cs._run_new(
                                   c, segment_pass, u, st, name, vb,
                                   rows=rows))
        key = f"n={n} E={E} {label} {guide} guide"
        for name, (fresh, launch) in runs.items():
            ms = cs._best_device_ms(launch, fresh, filler)
            b = bounds[name]
            out["rows"][f"{key}: {name}"] = dict(
                us=ms * 1e3, bound_us=b["bound_ms"] * 1e3,
                bound_by=b["bound_by"], share=b["bound_ms"] / ms)
        out["rows"][key] = dict(L=L, active=active, trips=trips,
                                guided_trips=counted[cs.GUIDE_PASS],
                                windows=int(c._guide.g_rel.shape[0]))
print("GUIDE_TIMES " + json.dumps(out), flush=True)
"""


def times(dirs):
    rows = []
    for d in dirs:
        proc = subprocess.run([sys.executable, "-c", RUN, json.dumps(CELLS)],
                              cwd=os.path.abspath(d), capture_output=True,
                              text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, flush=True)
            return proc.returncode
        line = next(ln for ln in proc.stdout.splitlines()
                    if ln.startswith("GUIDE_TIMES "))
        rows.append(json.loads(line[len("GUIDE_TIMES "):]))
        print(line, flush=True)
    for key in rows[0]["rows"]:
        if "us" not in rows[0]["rows"][key]:
            print(f"{key}: {rows[0]['rows'][key]}", flush=True)
            continue
        print(f"{key}: " + ", ".join(
            f"{r['dir'].rsplit('/', 1)[-1]} {r['rows'][key]['us']:.2f} us "
            f"({r['rows'][key]['share']:.4f} of "
            f"{r['rows'][key]['bound_us']:.3f} us)"
            for r in rows if key in r["rows"]), flush=True)
    return 0


def main(argv):
    if not torch.cuda.is_available():
        print("guide_probe: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    if argv[:1] == ["times"]:
        return times(argv[1:] or [str(ROOT)])
    source = SOURCE
    if argv[:1] == ["--source"]:
        source, argv = Path(argv[1]).resolve(), argv[2:]
    text = source.read_text()
    what = argv or ["resources", "work", "phases"]
    if "resources" in what or "work" in what:
        info = _use_source(text, "guide_probe")
        print(f"built {source} in {info.seconds:.1f} s", flush=True)
        for ln in _biased_ptxas(info):
            print(f"ptxas: {ln}", flush=True)
    if "resources" in what:
        resources()
    if "work" in what:
        work(cs._filler())
    if "phases" in what:
        phases(text)
    _build.SOURCE = SOURCE
    _build.load_trip_library.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
