"""Where the narrow passes with local recording of ``csrc/trip.cu`` spend
their time, on one GPU: the local pass (``segment_pass_kernel<NP, VB,
LOCAL=true>``) and the biased local pass (``segment_pass_biased_kernel<NP,
VB, GUIDE=false, LOCAL=true>``), each with and without VB, beside their
parents without local recording and beside the guided local pass, which
runs the same local block.

    python3 tools/local_probe.py [--source TRIP_CU] [resources] [work] [phases]
    python3 tools/local_probe.py times DIR [DIR ...]
    python3 tools/local_probe.py trip

Cells: P=10,000 at the main path's shape (n=4, E=9, 2 sections), the
genome's (8, 33, 2) and the caps (8, 64, 8 sections), each on the mean
bench segment and at 50 kb (``chip_smoke._timing_case``: next_rec drawn as
at a segment's start, uniforms for 64 trips), with the local ring 30% in
use (``chip_smoke._fresh_new``: the first 16 rings full) and with every
ring full (the biased passes' rings of delayed factors too).  Device time
per launch as ``chip_smoke`` times it (CUDA events, best of 3 x 20
launches on fresh states queued behind a matrix product); every comparison
in turns (A, B, ..., B, A), the best of each.

* ``resources``: registers, stack bytes, shared bytes, blocks per SM and
  the waves a launch of 10,000 particles takes (``kernel_resources``) of
  the plain, local, biased, biased local and guided local passes, each
  with and without VB, at the three shapes; ptxas's lines of the narrow
  unit's segment-pass kernels.
* ``work``: copies of the kernel with one part of the local recording
  taken out, timed in turns beside the kernel and beside its parent pass
  (the same pass without local recording): "no leaf walk" (no leaf's walk
  up to c: no leaves in the event), "no ring read" (every slot taken as
  free at entry, the ring's positions not read), "no event store" (the
  event's four words not written), "no lag min" (each lane's own epoch of
  h_r, no group minimum), "no opportunity sum" (the segment's opportunity
  written as 0) and "64 registers" (the local pass held at 8 blocks an
  SM).  A part taken out changes what the pass writes (the bit for bit
  column says whether it did), not its trees.
* ``phases``: (1) a copy of the kernels with ``clock64()`` around the
  parts of a trip (up to the local event; the lag's epoch; the leaves'
  walk and ballot; the event's store; the SPR; the whole trip) and of the
  pass (the entry up to the barrier and the ring's combine; the final
  extension with the opportunity; the biased apply; the write-back), lane
  0's cycles summed over the launch and divided by the trips and the
  particles; (2) each part done twice, the second dependent on the first
  through an index offset that is 0 at run time but not to the compiler,
  every output bit for bit the kernel's own (checked), timed in turns
  beside it: "walk x2", "lag x2", "store x2", "ring x2" (the entry read)
  and "opportunity x2".  Lane 0's counters inflate waits on memory: read
  their shares, and the parts done twice for what a part costs a launch.
  ``work`` and ``phases`` anchor on the design that walked the leaves (PR
  9's local block): give a later tree ``--source
  build/parent/smcsmc_tpu_torch/csrc/trip.cu``.

``times DIR [DIR ...]`` builds the ``trip.cu`` of the first checkout DIR
whole and the narrow unit (``-DSMC_PART=0``) of each other one linked with
the first's other units, and times them behind this tree's wrappers (the C
interface is the same) in the order given: the four local kernels, the
guided local pass with and without VB and the plain and biased passes
without local recording, on every cell.  Give a parent checkout first and
last (parent, change, change, parent); each DIR's times are printed beside
the others', and the outputs of every DIR's kernel must be the first DIR's
bit for bit (checked: trees, next_rec, log_w, log_pilot, tl_out, the FIFO,
the ring of delayed factors, the local ring's positions, due positions,
heights and leaves, the drop count and the opportunity).

``trip`` times ``trip`` as the lag calibration launches it
(``calibrate.calibrate_survival``: 256 genealogies, one trip a launch, a
window of 100 kb) at (256, 8, 33) and (256, 4, 9), with its bound from the
counted work (``chip_smoke._bounds``) and its plain version's time.

Library builds go into ``build/local_probe/`` (gitignored), by
``tools/probe_common.py``: every nvcc process started together.  Prints
the card's name and power limit first."""

from __future__ import annotations

import ctypes
import math
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
os.chdir(ROOT)

import chip_smoke as cs  # noqa: E402
import probe_common as pc  # noqa: E402
import torch  # noqa: E402
from arg_probe import _variant  # noqa: E402
from smcsmc_tpu_torch.kernels import _build  # noqa: E402
from smcsmc_tpu_torch.kernels.trip import RESOURCES  # noqa: E402
from wide_probe import _insert, _span  # noqa: E402

OUT = ROOT / "build" / "local_probe"
P = 10000
# (label, n, E, sections)
SHAPES = (("main", 4, 9, 2), ("genome", 8, 33, 2), ("caps", 8, 64, 8))
VB_OF = {cs.LOCAL_PASS: cs.vb_name(cs.LOCAL_PASS),
         cs.BIASED_LOCAL_PASS: cs.vb_name(cs.BIASED_LOCAL_PASS)}
# the four local kernels and the pass each is a variant of
PARENT_OF = {cs.LOCAL_PASS: "segment_pass", VB_OF[cs.LOCAL_PASS]: cs.VB_PASS,
             cs.BIASED_LOCAL_PASS: cs.BIASED_PASS,
             VB_OF[cs.BIASED_LOCAL_PASS]: cs.BIASED_VB_PASS}
GUIDED = (cs.GUIDE_LOCAL_PASS, cs.vb_name(cs.GUIDE_LOCAL_PASS))
WINDOW = 1e5  # calibrate_survival's window: 2 Mb in 20


def _lengths():
    """(label, bp): the mean bench segment and 50 kb."""
    from smcsmc_tpu_torch.segio import split_long_segments
    from smcsmc_tpu_torch.sweep_profile import bench_data

    mean = float(split_long_segments(bench_data()[1], cs.MAX_SEG)
                 .lengths.mean())
    return (("mean", mean), ("50 kb", cs.MAX_SEG))


def _cells():
    """[(label, (n, E, S, L, full))] of every cell."""
    return [(f"{shape} {lab} {'full' if full else '30%'}", (n, E, S, L, full))
            for shape, n, E, S in SHAPES for lab, L in _lengths()
            for full in (False, True)]


def _runs(n, E, S, L, full):
    """(case, {pass: (fresh, run(fn, st))}) of the local, biased local and
    guided local passes, their VB forms and the parents without local
    recording on one cell, as ``chip_smoke.phase_time`` drives them."""
    c, u = cs._timing_case(P, n, E, L)
    h, s = ((cs.BIAS_CAPS_HEIGHTS, cs.BIAS_CAPS_STRENGTHS) if S == 8
            else (cs.BIAS_HEIGHTS, cs.BIAS_STRENGTHS))
    vb = cs.vb_tables(c.demo, 5)
    out = {}
    for v in (None, vb):
        for name in (cs.LOCAL_PASS, cs.BIASED_LOCAL_PASS, cs.GUIDE_LOCAL_PASS):
            out[name if v is None else cs.vb_name(name)] = (
                lambda name=name: cs._fresh_new(c, name, full, h, s),
                lambda fn, st, name=name, v=v: cs._run_new(c, fn, u, st,
                                                           name, v))
        out["segment_pass" if v is None else cs.VB_PASS] = (
            c.fresh_segment, lambda fn, st, v=v: c.run_segment(fn, u, st, v))
        out[cs.BIASED_PASS if v is None else cs.BIASED_VB_PASS] = (
            lambda: c.fresh_biased(full, h, s),
            lambda fn, st, v=v: c.run_biased(fn, u, st, v))
    return c, out


def _events(lib, c, runs):
    """What the local pass of ``lib`` does on a cell: events pushed and
    dropped."""
    fresh, run = runs[cs.LOCAL_PASS]
    st = run(pc.via(lib), fresh())
    pushed = int((st["lr_pos"] != c.lring["lr_pos"]).sum())
    return pushed, int(st["lr_dropped"])


# ---- resources -------------------------------------------------------------

# (label, kind of smc_kernel_resources, guide, local)
KERNELS = (("plain", 1, False, False), ("local", 1, False, True),
           ("biased", 2, False, False), ("biased local", 2, False, True),
           ("guided local", 2, True, True))


def _res(lib, kind, n, E, S, vb, guide, local):
    out = (ctypes.c_int * len(RESOURCES))()
    err = lib.smc_kernel_resources(kind, n, E, S, 1, 0, int(vb), int(guide),
                                   int(local), 0, out)
    if err != 0:
        raise SystemExit(f"smc_kernel_resources failed: CUDA error {err}")
    r = dict(zip(RESOURCES, out))
    per_sm = r["blocks_per_sm"] * r["particles_per_block"]
    return dict(r, particles_per_sm=per_sm,
                waves_at_10000=math.ceil(10000 / max(per_sm * r["sms"], 1)))


def _res_line(r):
    return (f"registers {r['registers']}, stack {r['local_bytes']} B, shared "
            f"{r['dynamic_shared_bytes']} B per block of "
            f"{r['particles_per_block']}, {r['blocks_per_sm']} blocks = "
            f"{r['particles_per_sm']} particles per SM, "
            f"{r['waves_at_10000']} waves at 10,000")


def resources(lib, log):
    for ln in pc.ptxas(log, "segment_pass"):
        if "wide" not in ln.split(":")[0] and "mig" not in ln.split(":")[0]:
            print(f"ptxas: {ln}", flush=True)
    for shape, n, E, S in SHAPES:
        for label, kind, guide, local in KERNELS:
            for vb in (False, True):
                r = _res(lib, kind, n, E, S, vb, guide, local)
                print(f"resources {label}{' vb' if vb else ''} {shape} "
                      f"(n={n} E={E} S={S}): {_res_line(r)}", flush=True)


# ---- work: parts taken out -------------------------------------------------

LEAF_WALK = """    bool below = false;
    if (lane < tb.n) {
      int cur = lane;
      for (int s = 0; s < N && cur >= 0; ++s) {
        if (cur == c) {
          below = true;
          break;
        }
        cur = w.par[cur];
      }
    }
"""
LAG_MIN = "    int e = group_min(lag_epoch, gm);\n"
EVENT_STORE = """      if (lane == 0) {
        const size_t at = (size_t)i * a->R + slot;
        const float pos = tb.front + nr;
        a->lr_pos[at] = pos;
        a->lr_due[at] = pos + tb.lag[e];
        a->lr_time[at] = h_r;
        a->lr_desc[at] = (long long)desc;
      }
"""
RING_READ = """      if (nr < a.L)
        for (int s = lane; s < a.R; s += GROUP)
          if (a.lr_pos[(size_t)i * a.R + s] >= 0.5f * BIG) ring.free |= 1u << s;
"""
OPP_SUM = """    float mine = 0.0f;
    for (int e = lane; e < E; e += GROUP) mine += pend[4 * E + e];
    const float ropp = group_sum(mine, gm);
"""
PLAIN_KERNEL = ("template <int NP, bool VB, bool LOCAL, bool ARG = false>\n"
                "__global__ void __launch_bounds__(BLOCK) segment_pass_kernel")
# (name, groups of (old, new) edits, as arg_probe._variant takes them)
WORK = (
    ("no leaf walk", [[(LEAF_WALK, "    bool below = false;\n")]]),
    ("no ring read", [[(RING_READ, "      ring.free = a.R >= 32 ? ~0u : "
                                   "(1u << a.R) - 1u;\n")]]),
    ("no event store", [[(EVENT_STORE, "")]]),
    ("no lag min", [[(LAG_MIN, "    int e = lag_epoch;\n")]]),
    ("no opportunity sum", [[(OPP_SUM, "    const float ropp = 0.0f;\n")]]),
    ("64 registers", [[(PLAIN_KERNEL, PLAIN_KERNEL.replace(
        "(BLOCK)", "(BLOCK, LOCAL ? 8 : 1)"))]]),
)


def _sources(text: str, edits) -> dict[str, str]:
    """{name: text} of each edit group list that fits ``text``."""
    out = {}
    for name, groups in edits:
        src = _variant(text, name, groups)
        if src is None:
            print(f"variant {name} does not fit this source", flush=True)
        else:
            out[name] = src
    return out


def _narrow_libs(text, variants):
    """{name: loaded library}: ``text`` built whole as "kernel", each of
    ``variants`` as its narrow unit beside the kernel's other units."""
    built = pc.build(OUT, {"kernel": text}, variants, text,
                     unit=pc.NARROW_UNIT)
    for name, (_, log) in built.items():
        for ln in pc.ptxas(log, "segment_pass"):
            head = ln.split(":")[0]
            if "wide" not in head and "Lb1ELb0EEEv" in head:
                print(f"  ptxas {name}: {ln}", flush=True)
    return {k: pc.load(v[0]) for k, v in built.items()}


def _turns(entries, filler):
    """{label: best ms} of [(label, lib, fresh, run)] timed in turns."""
    ms = {}
    for label, lib, fresh, run in entries + entries[::-1]:
        t = cs._best_device_ms(lambda st, fn=pc.via(lib), run=run:
                               run(fn, st), fresh, filler)
        ms[label] = min(ms.get(label, t), t)
    return ms


def work(text: str, filler):
    libs = _narrow_libs(text, _sources(text, WORK))
    names = list(libs)
    for label, cell in _cells():
        c, runs = _runs(*cell)
        pushed, dropped = _events(libs["kernel"], c, runs)
        print(f"cell {label} (L={cell[3]:.1f}): the local pass pushes "
              f"{pushed} events, drops {dropped}", flush=True)
        for kname, parent in PARENT_OF.items():
            fresh, run = runs[kname]
            same = pc.same(libs, names, fresh, run)
            entries = [(n, libs[n], fresh, run) for n in names]
            entries.append(("without local", libs["kernel"], *runs[parent]))
            ms = _turns(entries, filler)
            print(f"work {kname} {label}: " + ", ".join(
                f"{n} {ms[n] * 1e3:.2f} us"
                + ("" if n == "kernel" else
                   f" ({(ms[n] - ms['kernel']) * 1e3:+.2f}"
                   + (f"; bit for bit {same[n]})" if n in same else ")"))
                for n in ms), flush=True)


# ---- phases: counters and parts done twice ---------------------------------

PARTS = ("to the local event", "lag epoch", "leaves' walk and ballot",
         "event's store", "SPR", "trip", "trips", "entry", "particles",
         "final extension and opportunity", "apply", "write-back")
TRIP_PARTS = (0, 1, 2, 3, 4)
SLOTS = 64
SLOT = f"((blockIdx.x * (BLOCK / GROUP) + threadIdx.x / GROUP) % {SLOTS})"


def _add(k: int, start: str) -> str:
    return (f"__syncwarp(gm); if (lane == 0) atomicAdd(&g_prof[{k * SLOTS} + "
            f"{SLOT}], (unsigned long long)(clock64() - {start}));")


def _count(k: int) -> str:
    return f"if (lane == 0) atomicAdd(&g_prof[{k * SLOTS} + {SLOT}], 1ull);"


# (anchor, text) as wide_probe._insert takes them: one_trip's, then
# segment_pass_body's
TRIP_PROBES = (
    ("  // ---- extension: no-mutation likelihood",
     "  long long t_ = clock64();"),
    ("  if constexpr (LOCAL) {\n    // ---- the trip's local event",
     "  long long l_ = clock64(); if constexpr (LOCAL) { " + _add(0, "t_")
     + " l_ = clock64(); }"),
    ("    if (e >= E) e = h_r >= tb.est[0] ? E - 1 : 0;",
     "    " + _add(1, "l_") + " l_ = clock64();"),
    ("    if (ring->free != 0u) {", "    " + _add(2, "l_")
     + " l_ = clock64();"),
    ("  if constexpr (ARG) {\n    // ---- the trip's ARG rows",
     "  if constexpr (LOCAL) { " + _add(3, "l_") + " }"),
    ("  // ---- SPR: cut the branch above c", "  long long s_ = clock64();"),
    ("  // ---- refreshed tree summaries", "  " + _add(4, "s_")),
    ("  return TripEvent{h_r, t_c, log_iw, strength, key_epoch, vb, liw,",
     "  " + _add(5, "t_") + " " + _count(6)),
)
BODY_PROBES = (
    ("  const bool live = i < a.P;", "  long long b_ = clock64();"),
    ("  Tables tb;\n  bind_tables(a, smem, tb, BIAS, vb, LOCAL, GUIDE);",
     "  " + _add(7, "b_") + " " + _count(8)),
    ("  // ---- final extension to the segment end", "  b_ = clock64();"),
    ("  if constexpr (BIAS) {\n    // ---- the pilot's extension",
     "  " + _add(9, "b_") + " b_ = clock64();"),
    ("  // ---- push the segment's statistics into FIFO slot 0",
     "  " + _add(10, "b_") + " b_ = clock64();"),
    ("  if (lane == 0) {\n    a.next_rec[i] = nr;", "  " + _add(11, "b_")),
)


def instrumented(src: str) -> str:
    """``src`` (the parent's trip.cu) with the counters of ``phases`` in
    the narrow trip and pass, and ``smc_local_prof_read`` to read them."""
    lines = src.split("\n")
    lines = _insert(lines, *_span(lines, "TripEvent one_trip("), TRIP_PROBES)
    lines = _insert(lines, *_span(lines, "void segment_pass_body("),
                    BODY_PROBES)
    text = "\n".join(lines)
    words = len(PARTS) * SLOTS
    text = text.replace("namespace {\n", "namespace {\n__device__ unsigned "
                        f"long long g_prof[{words}];\n", 1)
    return text + f"""
#if SMC_NARROW
extern "C" int smc_local_prof_read(unsigned long long* out) {{
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  if (e != cudaSuccess) return (int)e;
  unsigned long long z[{words}] = {{0}};
  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}}
#endif
"""


# what the kernel cannot see is 0: the front is never NaN
ZT = "(tb.front != tb.front ? 1 : 0)"
ZA = "(a.front != a.front ? 1 : 0)"
# each part done twice: the second pass starts from the first's result
# through a zero, so that it waits for it and computes the same values
TWICE = (
    ("walk x2", [[(LEAF_WALK, LEAF_WALK + LEAF_WALK.replace(
        "    bool below = false;\n",
        "    const bool below0 = below;\n    below = false;\n").replace(
        "int cur = lane;", f"int cur = lane + ((int)below0 & {ZT});"))]]),
    ("lag x2", [[(LAG_MIN, LAG_MIN + f"    e = group_min(lag_epoch + (e & "
                 f"{ZT}), gm);\n")]]),
    ("store x2", [[(EVENT_STORE, EVENT_STORE + EVENT_STORE.replace(
        "a->R + slot;", f"a->R + slot + (slot & {ZT});"))]]),
    ("ring x2", [[(RING_READ, RING_READ + (
        "      {\n        const unsigned f0 = ring.free;\n"
        "        ring.free = 0u;\n")
        + RING_READ.replace("a.R + s]", f"a.R + s + (f0 & {ZA})]")
        + "      }\n")]]),
    ("opportunity x2", [[(OPP_SUM, OPP_SUM.replace(
        "const float ropp =", "const float ropp0 =") + (
        f"    mine = (float)(__float_as_uint(ropp0) & {ZT});\n"
        "    for (int e = lane; e < E; e += GROUP) mine += pend[4 * E + e];\n"
        "    const float ropp = group_sum(mine, gm);\n"))]]),
)


def phases(text: str, filler):
    libs = _narrow_libs(text, {"counters": instrumented(text),
                               **_sources(text, TWICE)})
    lib = libs.pop("counters")
    lib.smc_local_prof_read.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * (len(PARTS) * SLOTS))()
    names = list(libs)
    for label, cell in _cells():
        c, runs = _runs(*cell)
        for pname in (*PARENT_OF, *PARENT_OF.values(), cs.GUIDE_LOCAL_PASS):
            fresh, run = runs[pname]
            lib.smc_local_prof_read(buf)
            run(pc.via(lib), fresh())
            torch.cuda.synchronize()
            lib.smc_local_prof_read(buf)
            v = [sum(buf[k * SLOTS:(k + 1) * SLOTS])
                 for k in range(len(PARTS))]
            tr, pa = max(v[6], 1), max(v[8], 1)
            print(f"phases {pname} {label}: {v[8]} particles, {v[6]} trips;"
                  f" cycles per trip {v[5] / tr:.0f}: " + ", ".join(
                      f"{PARTS[k]} {v[k] / tr:.0f} ({v[k] / max(v[5], 1):.3f})"
                      for k in TRIP_PARTS)
                  + f"; cycles per particle: trips {v[5] / pa:.0f}, "
                  + ", ".join(f"{PARTS[k]} {v[k] / pa:.0f}"
                              for k in (7, 9, 10, 11)), flush=True)
        for kname in PARENT_OF:
            fresh, run = runs[kname]
            same = pc.same(libs, names, fresh, run)
            ms = pc.turns(libs, names, fresh, run, filler)
            print(f"apart {kname} {label}: " + ", ".join(
                f"{n} {ms[n] * 1e3:.2f} us"
                + ("" if n == "kernel" else
                   f" ({(ms[n] - ms['kernel']) * 1e3:+.2f})")
                for n in names) + f"; bit for bit the kernel's: {same}",
                flush=True)
            if not all(same.values()):
                raise SystemExit("local_probe: a doubled part changed an "
                                 "output")


# ---- times: checkouts in turns ---------------------------------------------

def times(dirs, filler):
    texts = {d: (Path(d).resolve() / "smcsmc_tpu_torch" / "csrc"
                 / "trip.cu").read_text() for d in dict.fromkeys(dirs)}
    first = next(iter(texts))
    built = pc.build(OUT, {first: texts[first]},
                     {d: t for d, t in texts.items() if d != first},
                     texts[first], unit=pc.NARROW_UNIT)
    label_of = {d: Path(d).resolve().name or d for d in texts}
    for d, (_, log) in built.items():
        for ln in pc.ptxas(log, "segment_pass"):
            head = ln.split(":")[0]
            if "wide" not in head and "mig" not in head:
                print(f"ptxas {label_of[d]}: {ln}", flush=True)
    libs = {d: pc.load(p) for d, (p, _) in built.items()}
    passes = (*PARENT_OF, *GUIDED, "segment_pass", cs.BIASED_PASS)
    cases = []
    for label, cell in _cells():
        _, runs = _runs(*cell)
        cases.append((f"{label} (L={cell[3]:.1f})",
                      {k: runs[k] for k in passes}))
    pc.times(libs, label_of, dirs, cases, filler)


# ---- trip as the lag calibration launches it --------------------------------

def trip_times(filler):
    from smcsmc_tpu_torch.kernels.trip import trip, trip_plain

    for n, E in ((8, 33), (4, 9)):
        c, u = cs._timing_case(256, n, E, WINDOW)
        u1 = u[:1].contiguous()
        st = c.run(trip, u1, c.fresh())
        trips = int(round(float(st["pending"][:, 5 * E:].sum())))
        active = int((c.base["next_rec"] < WINDOW).sum())
        bound = cs._bounds(c, active, trips, 0)["trip"]
        ms = [cs._best_device_ms(lambda st: c.run(trip, u1, st), c.fresh,
                                 filler) for _ in range(2)]
        plain = cs._plain_ms(c.run, trip_plain, u1, c.fresh)
        print(f"trip (256, {n}, {E}) one trip, L={WINDOW:g}: {active} of 256 "
              f"genealogies take a trip; {ms[0] * 1e3:.2f}, "
              f"{ms[1] * 1e3:.2f} us per launch; bound "
              f"{bound['bound_ms'] * 1e3:.3f} us ({bound['bytes']} B, "
              f"{bound['flop']} FLOP, {bound['bound_by']}); share "
              f"{bound['bound_ms'] / min(ms):.4f}; plain version "
              f"{plain:.4f} ms", flush=True)


def main(argv):
    if not torch.cuda.is_available():
        print("local_probe: no CUDA device", file=sys.stderr)
        return 1
    print(pc.card(), flush=True)
    filler = cs._filler()
    if argv[:1] == ["times"]:
        times(argv[1:] or [str(ROOT)], filler)
        return 0
    if argv[:1] == ["trip"]:
        trip_times(filler)
        return 0
    source = _build.SOURCE
    if argv[:1] == ["--source"]:
        source, argv = Path(argv[1]).resolve(), argv[2:]
    text = source.read_text()
    what = argv or ["resources", "work", "phases"]
    if "resources" in what:
        lib, log = pc.build(OUT, {"source": text})["source"]
        resources(pc.load(lib), log)
    if "work" in what:
        work(text, filler)
    if "phases" in what:
        phases(text, filler)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
