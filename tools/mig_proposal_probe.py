"""Where the proposal variants of the migration pass of ``csrc/trip.cu``
(``segment_pass_mig_proposal_kernel``: biased, guided, local, biased local
and guided local, each with and without VB) spend their time, on one GPU.

    python3 tools/mig_proposal_probe.py [--source TRIP_CU] [resources] [work] [phases]
    python3 tools/mig_proposal_probe.py times DIR [DIR ...]
    python3 tools/mig_proposal_probe.py runs DIR [DIR ...]

Cells: the two-population shape of ``chip_smoke.phase_time_mig_proposal``
(P=10,000, n=4, E=8, Pp=2, Mw=56, 2 sections, rings 30% in use, the delay
keyed by -delay_migr, the guide's rates constant over
``GUIDE_CHAIN_ROWS`` windows) on the twopop data's mean segment and at 50
kb.  Device time per launch as ``chip_smoke`` times it (CUDA events, best
of 3 x 20 launches on fresh states queued behind a matrix product); every
comparison in turns (A, B, ..., B, A), the best of each.

* ``resources``: registers, stack bytes, shared bytes, blocks per SM and
  the waves a launch of 10,000 particles takes (``kernel_resources``) of
  the ten proposal kernels and the migration pass, at the twopop shape and
  at the caps (n=8, E=64, Pp=4, Mw=96, 8 sections); ptxas's lines of the
  migration unit's kernels (registers, stack, spill stores and loads).
* ``work``: the biased and the guided local pass beside copies of the
  kernel with one part taken out: "no chain" (the point's running sums by
  a lane-parallel scan, not one serial chain: bits differ), "no ring" (no
  ring of delayed factors: no slot read, pushed or applied), "no merge"
  (the guide's leaf rates not read, every branch rate 1: no ranks, no
  merge), "no leaf walk" (local recording without the leaves' walk to c
  and without the event's store) and "128 registers" (the same code held
  at 8 blocks an SM, ``MIG_MIN_BLOCKS`` 8: the spills' price, beside its
  blocks per SM and waves).  A part taken out changes what the pass
  computes, and from the first trip on its walks too: read the gaps as
  what the part costs with its trips, and the bit for bit column for
  whether the walks stayed.
* ``phases``: (1) a copy of the kernels with ``clock64()`` around the
  parts of a trip of the migration body (extension with the guide's
  loads; branch rates; weighing; the point's chain; search and
  logarithms; the loop walk; the weights and the ring's push; the local
  event; the SPR; summaries and gap) and of the pass (entry; the final
  extension, the local ring's count and the ring's apply; the
  write-back), lane 0's cycles summed over the launch and divided by the
  trips and the particles; (2) each part measured apart: copies that do
  one part twice, the second pass dependent on the first through an index
  offset that is 0 at run time but not to the compiler, every output bit
  for bit the kernel's own (checked), timed in turns beside it: "chain
  x2", "ring x2" (the push's ballot and the apply's sum), "guide x2" (the
  window's leaf rates and mass, and the inverse mass of the gap), "merge
  x2" (lane 0's merge) and "walk x2" (the local leaves' walk).  Lane 0's
  counters inflate waits on memory: read their shares, and the parts
  measured apart for what a part costs a launch.  The parts taken out
  and done twice anchor on the design that held the proposal's state in
  registers ("128 registers" fits both designs): give a later tree
  ``--source build/parent/smcsmc_tpu_torch/csrc/trip.cu``; an edit that
  does not fit the source is left out.  The counters fit both designs (in
  the scratch-held one the "local event" part is all that follows the
  walk up to the SPR, and a local event stored before the walk counts in
  the walk's part).

``times DIR [DIR ...]`` builds the ``trip.cu`` of each checkout DIR
(a parent's from a ``git archive`` under ``build/``) and times them
behind this tree's wrappers (the C interface is the same) in the order
given, kernel by kernel: the ten proposal kernels and the migration pass
with and without VB and ARG, on the cells above.  Give a parent checkout
first and last (parent, change, change, parent); each DIR's best is
printed beside the others', and the outputs of every DIR's kernel must be
the first DIR's bit for bit (checked).

``runs DIR [DIR ...]`` runs, in each checkout DIR in a fresh process
started there (its ``chip_smoke``, package and kernels), the twopop runs
A and B of ``chip_smoke.phase_twopop_proposal`` (``-Np 10000 -EM 1``, A
with ``TWOPOP_PROPOSAL_FLAGS``, B with ``-alpha 0.5``) and prints each
E-step's seconds, particle-site updates/s and LogL: two commits' end to
end on one host (parent, change, change, parent).

The migration unit's SASS beside a parent's, with its spill instructions:
``python3 tools/arg_probe.py sass PARENT_DIR --changed mig``.

Library builds go into ``build/mig_proposal_probe/`` (gitignored), by
``tools/probe_common.py``: the units of ``trip.cu`` other than the
migration pass without VB are built once from the source and each
variant's migration unit beside them, all nvcc processes started
together.  Prints the card's name and power limit first."""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
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

OUT = ROOT / "build" / "mig_proposal_probe"
P = cs.TWOPOP_P
# the proposal kernels without VB by (biased, guide, local), as
# chip_smoke names them
PROPOSALS = {flags: name for name, flags in cs.MIG_PROPOSAL_PASSES.items()
             if "vb" not in name}
HEADLINE = (cs.MIG_BIASED_PASS, cs.MIG_GUIDE_LOCAL_PASS)
# what the kernel cannot see is 0: the front is never NaN
Z = "(a.front != a.front ? 1 : 0)"


def _res(lib, biased, guide, local, vb=False, caps=False):
    """kernel_resources of a proposal kernel (or, with all three False,
    the migration pass) of library ``lib``."""
    import math

    n, E, Pp, Mw, S = (8, 64, 4, 96, 8) if caps else (4, 8, 2, 56, 2)
    out = (ctypes.c_int * len(RESOURCES))()
    kind = 4 if biased or guide else 3
    err = lib.smc_kernel_resources(kind, n, E, S, Pp, Mw, int(vb),
                                   int(guide), int(local), 0, out)
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


# ---- cells -----------------------------------------------------------------

def _cells():
    from smcsmc_tpu_torch.segio import split_long_segments
    from smcsmc_tpu_torch.sweep_profile import twopop_data

    mean = float(split_long_segments(twopop_data()[1], cs.MAX_SEG)
                 .lengths.mean())
    return (("mean", mean), ("50 kb", cs.MAX_SEG))


def _runs(c, u):
    """{pass name: (fresh, run(fn, st))} of the migration pass and every
    proposal kernel (with and without VB) on case ``c``, as
    ``chip_smoke.phase_time_mig_proposal`` drives them; the ARG variants
    of the migration pass with an ARG ring in use."""
    vb = cs.vb_tables(c.demo, 5)
    out = {}
    for v in (None, vb):
        name = cs.MIGRATION_PASS if v is None else cs.MIGRATION_VB_PASS
        out[name] = (c.fresh, lambda fn, st, v=v: c.run(fn, u, st, v))
    aring = cs.arg_ring(c.P, c.n, c.gen)

    def fresh_arg():
        st = c.fresh()
        st.update({k: x.clone() for k, x in aring.items()})
        return st

    def run_arg(fn, st, v):
        from smcsmc_tpu_torch.kernels.migration import MigrationPass

        mp = MigrationPass(st["pop"], st["mig_time"], st["mig_dest"],
                           st["diag"], c.key, *c.tables)
        fn(u, c.leaf_status, *(st[k] for k in cs.SEGMENT_STATE),
           st["fifo"], c.fifo_mask, st["tl"], c.L, cs.MU, cs.RHO, c.start,
           c.inv2ne, c.has_data, None, mp, vb=v, arg=cs._arg_of(st))
        return st

    out[cs.MIGRATION_ARG_PASS] = (fresh_arg, lambda fn, st: run_arg(
        fn, st, None))
    out[cs.vb_name(cs.MIGRATION_ARG_PASS)] = (fresh_arg, lambda fn, st:
                                              run_arg(fn, st, vb))
    for name, flags in cs.MIG_PROPOSAL_PASSES.items():
        v = vb if "vb" in name else None
        delay = "migr" if flags[0] else "recomb"
        out[name] = (lambda flags=flags: c.fresh_proposal(flags),
                     lambda fn, st, flags=flags, v=v, delay=delay:
                     c.run_proposal(fn, u, st, flags, v, delay,
                                    cs.GUIDE_CHAIN_ROWS))
    return out


# ---- resources -------------------------------------------------------------

def resources(lib):
    for caps in (False, True):
        at = ("n=8 E=64 Pp=4 Mw=96 S=8" if caps
              else "n=4 E=8 Pp=2 Mw=56 S=2")
        for flags, name in [((False, False, False), cs.MIGRATION_PASS),
                            *PROPOSALS.items()]:
            for vb in (False, True):
                r = _res(lib, *flags, vb=vb, caps=caps)
                print(f"resources {cs.vb_name(name) if vb else name} {at}: "
                      f"{_res_line(r)}", flush=True)


# ---- work: parts taken out ---------------------------------------------------

CHAIN = """      float wtot = 0.0f, ptot = 0.0f, btot = 0.0f;
      int s_q = 0;
      for (int q = 0; q < Q; ++q) {
        wtot += xw.wseg[q];
        ptot += xw.seg[q];
        if constexpr (GUIDE) {
          btot += xw.seg[q] * bs[s_q];
          s_q = s_q + 1 == S ? 0 : s_q + 1;
        }
        if ((q & 31) == lane) xw.cum[q] = wtot;
      }
"""
SCAN = """      float wtot = 0.0f, ptot = 0.0f, btot = 0.0f;
      {  // probe: a lane-parallel scan (Q <= 32), not the plain order
        float wv = lane < Q ? xw.wseg[lane] : 0.0f;
        float pv = lane < Q ? xw.seg[lane] : 0.0f;
        float bv = GUIDE && lane < Q ? xw.seg[lane] * bs[lane % S] : 0.0f;
        for (int off = 1; off < 32; off <<= 1) {
          const float x = __shfl_sync(WARP_ALL, wv, max(lane - off, 0));
          if (lane >= off) wv += x;
          pv += __shfl_xor_sync(WARP_ALL, pv, off);
          bv += __shfl_xor_sync(WARP_ALL, bv, off);
        }
        if (lane < Q) xw.cum[lane] = wv;
        wtot = __shfl_sync(WARP_ALL, wv, Q - 1);
        ptot = pv;
        btot = bv;
      }
"""
RING_SLOTS = "  const int S = BIAS ? a.S : 0, Q = N * S, D = BIAS ? a.K : 0;\n"
LEAF_LOAD = ("      if (lane < n) leaf_rate = a.g_leaf[(size_t)win * n + "
             "lane];\n")
MERGE = """        if (lane < N) xw.rate[lane] = lane < n ? leaf_rate : 0.0f;
        if (lane < n - 1) {
          const int v = n + lane;
          const float tv = w.tm[v];
          int rank = 0;
          for (int q = n; q < N; ++q) {
            const float tq = w.tm[q];
            rank += (tq < tv || (tq == tv && q < v)) ? 1 : 0;
          }
          xw.order[rank] = v;
        }
        __syncwarp();
        if (lane == 0) {
"""
MERGE_LOOP = """          for (int q = 0; q < n - 1; ++q) {
            const int v = xw.order[q];
            const int v0 = w.c0[v], v1 = w.c1[v];
            xw.rate[v] = 0.5f * (xw.rate[v0 < 0 ? N - 1 : v0]
                                 + xw.rate[v1 < 0 ? N - 1 : v1]);
          }
"""
MERGE_ROOT = """          const int root = xw.order[n - 2];
          const int rc0 = w.c0[root] < 0 ? N - 1 : w.c0[root];
          const int rc1 = w.c1[root] < 0 ? N - 1 : w.c1[root];
          const float mx = fmaxf(xw.rate[rc0], xw.rate[rc1]);
          xw.rate[rc0] = mx;
          xw.rate[rc1] = mx;
        }
"""
LEAF_WALK = """      bool below = false;
      if (lane < n) {
        int cur = lane;
        for (int q = 0; q < N && cur >= 0; ++q) {
          if (cur == c) {
            below = true;
            break;
          }
          cur = w.par[cur];
        }
      }
"""
LOCAL_STORE = """        if (lane == 0) {
          const size_t at = (size_t)i * a.R + slot;
          const float pos = a.front + nr;
          a.lr_pos[at] = pos;
          a.lr_due[at] = pos + lag[epoch_of(est, E, h_r)];
          a.lr_time[at] = h_r;
          a.lr_desc[at] = (long long)desc;
        }
"""
KERNEL = ("template <bool VB, bool BIAS, bool GUIDE, bool LOCAL>\n"
          "__global__ void __launch_bounds__(MIG_PPB * 32, MIG_MIN_BLOCKS)\n"
          "segment_pass_mig_proposal_kernel(const Args a) {\n")
# (name, groups of (old, new) edits, as arg_probe._variant takes them)
WORK = (
    ("no chain", [[(CHAIN, SCAN)]]),
    ("no ring", [[(RING_SLOTS, RING_SLOTS.replace("BIAS ? a.K : 0", "0"))]]),
    ("no merge", [[(LEAF_LOAD, "      if (lane < n) leaf_rate = 1.0f;\n"),
                   (MERGE + MERGE_LOOP + MERGE_ROOT,
                    "        if (lane < N) xw.rate[lane] = 1.0f;\n")]]),
    ("no leaf walk", [[(LEAF_WALK, "      bool below = false;\n"),
                       (LOCAL_STORE, "")]]),
    ("128 registers", [[(KERNEL, KERNEL.replace("MIG_MIN_BLOCKS", "8"))]]),
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


def work(text: str, filler):
    built = pc.build(OUT, {"kernel": text}, _sources(text, WORK), text)
    libs = {k: pc.load(v[0]) for k, v in built.items()}
    for name, (_, log) in built.items():
        for ln in pc.ptxas(log, "mig"):
            if "proposal" in ln.split(":")[0] and "Lb0ELb1E" in ln:
                print(f"  ptxas {name}: {ln}", flush=True)
    if "128 registers" in libs:
        for flags in ((True, False, False), (True, True, True)):
            for k in ("kernel", "128 registers"):
                print(f"resources {PROPOSALS[flags]} ({k}): "
                      f"{_res_line(_res(libs[k], *flags))}", flush=True)
    for label, L in _cells():
        c, u = cs._mig_timing_case(P, L)
        runs = _runs(c, u)
        for pname in HEADLINE + (cs.MIGRATION_PASS,):
            fresh, run = runs[pname]
            names = list(libs)
            same = pc.same(libs, names, fresh, run)
            ms = pc.turns(libs, names, fresh, run, filler)
            print(f"work {pname} {label} (L={L:.1f}): " + ", ".join(
                f"{n} {ms[n] * 1e3:.2f} us"
                + ("" if n == "kernel" else
                   f" ({(ms[n] - ms['kernel']) * 1e3:+.2f}; bit for bit "
                   f"{same[n]})") for n in names), flush=True)


# ---- phases: counters and parts done twice ---------------------------------

PARTS = ("extension", "branch rates", "weighing", "chain", "search",
         "walk", "weights and ring push", "local event", "SPR",
         "summaries and gap", "trips", "entry", "particles",
         "final and apply", "write-back")
TRIP_PARTS = tuple(range(10))
BODY_PARTS = (11, 13, 14)
SLOTS = 64
SLOT = f"((blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32) % {SLOTS})"


def _add(k: int, start: str) -> str:
    return (f"__syncwarp(); if (lane == 0) atomicAdd(&g_prof[{k * SLOTS} + "
            f"{SLOT}], (unsigned long long)(clock64() - {start}));")


def _count(k: int) -> str:
    return f"if (lane == 0) atomicAdd(&g_prof[{k * SLOTS} + {SLOT}], 1ull);"


LOCAL_ANCHOR = ("    if constexpr (LOCAL) {\n      // ---- the trip's local "
                "event")
WALK_ANCHOR = "    // ---- the loop walk from (c, h_r)"
AFTER_WALK = "    // the whole term after the walk"
# (anchor, text) as wide_probe._insert takes them, in mig_pass_body
PROBES = (
    ("  const bool live = i < a.P;", "  long long s_ = clock64();"),
    ("  for (int k = 0; k < a.trips; ++k) {",
     "  " + _add(11, "s_") + " " + _count(12)),
    ("    const float4 u = load_uniforms(a, k, i);",
     "    long long t_ = clock64();"),
    ("    int c = -1;", "    " + _add(0, "t_") + " t_ = clock64();"),
    ("      if (lane < N) {\n        const float t_j = w.tm[lane]",
     "      " + _add(1, "t_") + " t_ = clock64();"),
    ("      float wtot = 0.0f, ptot = 0.0f, btot = 0.0f;",
     "      " + _add(2, "t_") + " t_ = clock64();"),
    ("      const float xb = u_pt * wtot;",
     "      " + _add(3, "t_") + " t_ = clock64();"),
    (WALK_ANCHOR, "    " + _add(4, "t_") + " t_ = clock64();"),
    (AFTER_WALK, "    " + _add(5, "t_") + " t_ = clock64();"),
    (LOCAL_ANCHOR, "    " + _add(6, "t_") + " t_ = clock64();"),
    ("    // ---- the SPR with buffer routing",
     "    " + _add(7, "t_") + " t_ = clock64();"),
    ("    // ---- refreshed summaries, then the next gap",
     "    " + _add(8, "t_") + " t_ = clock64();"),
    (">    moved = true;", "    " + _add(9, "t_") + " " + _count(10)),
    ("  // ---- final extension to the segment end",
     "  s_ = clock64();"),
    ("  float* slot = a.fifo + (size_t)i * a.fifo_stride;",
     "  " + _add(13, "s_") + " s_ = clock64();"),
    ("  if (lane == 0) {\n    if (capped > 0.0f)", "  " + _add(14, "s_")),
)


def instrumented(src: str) -> str:
    """``src`` (the parent's trip.cu) with the counters of ``phases`` in
    the migration body, and ``smc_migp_prof_read`` to read them."""
    lines = src.split("\n")
    start, stop = _span(lines, "void mig_pass_body(")
    body = "\n".join(lines[start:stop])
    # a design that stores the local event before the walk has it in the
    # walk's part
    probes = [p for p in PROBES if p[0] != LOCAL_ANCHOR
              or body.find(LOCAL_ANCHOR) > body.find(AFTER_WALK)]
    lines = _insert(lines, start, stop, probes)
    text = "\n".join(lines)
    words = len(PARTS) * SLOTS
    text = text.replace("namespace {\n", "namespace {\n__device__ unsigned "
                        f"long long g_prof[{words}];\n", 1)
    return text + f"""
#if SMC_MIG
extern "C" int smc_migp_prof_read(unsigned long long* out) {{
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  if (e != cudaSuccess) return (int)e;
  unsigned long long z[{words}] = {{0}};
  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}}
#endif
"""


def _second(block: str, pairs) -> str:
    for old, new in pairs:
        if old not in block:
            raise SystemExit(f"mig_proposal_probe: {old!r} not in its block")
        block = block.replace(old, new)
    return block


FREES = """        const unsigned frees =
            __ballot_sync(WARP_ALL, lane < D && rpos >= 0.5f * BIG);
"""
APPLY = """    if (__any_sync(WARP_ALL, due)) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        add += __shfl_xor_sync(WARP_ALL, add, off);
      lp = lp + add;
    }
"""
MASS = "      m_nr = guide_mass(gt, win, x1);\n"
INV = "      const float nxt = guide_inv_mass(gt, m_nr + gap_m);\n"
# each part done twice: the second pass starts from the first's result
# through Z, so that it waits for it and computes the same values
TWICE = (
    ("chain x2", [[(CHAIN, CHAIN + _second(CHAIN, [
        ("      float wtot = 0.0f, ptot = 0.0f, btot = 0.0f;\n"
         "      int s_q = 0;\n",
         "      const int z2_ = (int)(__float_as_uint(wtot) & " + Z + ");\n"
         "      wtot = 0.0f; ptot = 0.0f; btot = 0.0f; s_q = z2_;\n"),
        ("xw.wseg[q]", "xw.wseg[q + z2_]"), ("xw.seg[q]", "xw.seg[q + z2_]")
    ]))]]),
    ("ring x2", [[(FREES, FREES.replace("frees =", "frees0 =") + (
        "        const unsigned frees = frees0 & __ballot_sync(WARP_ALL, "
        "lane + (int)(frees0 & " + Z + ") < D && rpos >= 0.5f * BIG);\n")),
        (APPLY, """    if (__any_sync(WARP_ALL, due)) {
      const float add0 = add;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        add += __shfl_xor_sync(WARP_ALL, add, off);
      float add2 = add0 + (float)(__float_as_uint(add) & """ + Z + """);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        add2 += __shfl_xor_sync(WARP_ALL, add2, off);
      lp = lp + add2;
    }
""")]]),
    ("guide x2", [[(MASS, MASS + (
        "      {\n        const int w2 = win + (int)(__float_as_uint(m_nr) "
        "& " + Z + ");\n  " + LEAF_LOAD.replace("win", "w2") + "        "
        "m_nr = guide_mass(gt, w2, x1);\n      }\n")),
        (INV, INV.replace("nxt =", "nxt0 =") + (
            "      const float nxt = guide_inv_mass(gt, m_nr + gap_m + "
            "(float)(__float_as_uint(nxt0) & " + Z + "));\n"))]]),
    ("merge x2", [[(MERGE_LOOP, MERGE_LOOP + _second(MERGE_LOOP, [
        ("xw.order[q]", "xw.order[q + " + Z + "]")]))]]),
    ("walk x2", [[(LEAF_WALK, LEAF_WALK + _second(LEAF_WALK, [
        ("      bool below = false;\n", "      const bool below0 = below;\n"
         "      below = false;\n"),
        ("int cur = lane;", "int cur = lane + ((int)below0 & " + Z + ");")
    ]))]]),
)


def phases(text: str, filler):
    cells = _cells()
    built = pc.build(OUT, {"kernel": text}, {"counters": instrumented(text),
                                     **_sources(text, TWICE)}, text)
    libs = {k: pc.load(v[0]) for k, v in built.items()}
    for ln in pc.ptxas(built["counters"][1], "mig"):
        if "Lb0E" in ln.split(":")[0]:
            print(f"phases ptxas counters: {ln}", flush=True)
    lib = libs.pop("counters")
    lib.smc_migp_prof_read.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * (len(PARTS) * SLOTS))()
    for label, L in cells:
        c, u = cs._mig_timing_case(P, L)
        runs = _runs(c, u)
        for pname in (cs.MIGRATION_PASS, *PROPOSALS.values()):
            fresh, run = runs[pname]
            lib.smc_migp_prof_read(buf)
            run(pc.via(lib), fresh())
            torch.cuda.synchronize()
            lib.smc_migp_prof_read(buf)
            v = [sum(buf[k * SLOTS:(k + 1) * SLOTS])
                 for k in range(len(PARTS))]
            tr, pa = max(v[10], 1), max(v[12], 1)
            trip = sum(v[k] for k in TRIP_PARTS)
            print(f"phases {pname} {label} (L={L:.1f}): {v[12]} particles, "
                  f"{v[10]} trips; cycles per trip {trip / tr:.0f}: "
                  + ", ".join(f"{PARTS[k]} {v[k] / tr:.0f} "
                              f"({v[k] / max(trip, 1):.3f})"
                              for k in TRIP_PARTS)
                  + "; cycles per particle: trips "
                  f"{trip / pa:.0f}, " + ", ".join(
                      f"{PARTS[k]} {v[k] / pa:.0f}" for k in BODY_PARTS),
                  flush=True)
        for pname in PROPOSALS.values():
            fresh, run = runs[pname]
            names = list(libs)
            same = pc.same(libs, names, fresh, run)
            ms = pc.turns(libs, names, fresh, run, filler)
            print(f"apart {pname} {label}: " + ", ".join(
                f"{n} {ms[n] * 1e3:.2f} us"
                + ("" if n == "kernel" else
                   f" ({(ms[n] - ms['kernel']) * 1e3:+.2f})")
                for n in names) + f"; bit for bit the kernel's: {same}",
                flush=True)
            if not all(same.values()):
                raise SystemExit("mig_proposal_probe: a doubled part "
                                 "changed an output")


# ---- times: checkouts in turns ---------------------------------------------

def times(dirs, filler):
    libs, label_of = pc.checkouts(OUT, dirs, "mig")
    cases = []
    for label, L in _cells():
        c, u = cs._mig_timing_case(P, L)
        cases.append((f"{label} (L={L:.1f})", _runs(c, u)))
    pc.times(libs, label_of, dirs, cases, filler)


# ---- runs: twopop A and B of each checkout, on one host ---------------------

# run in each checkout: chip_smoke's twopop A and B (phase_twopop_proposal's
# commands), each E-step's seconds, updates/s and LogL
RUNS = """
import json, os, sys, tempfile
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
from smcsmc_tpu_torch.segio import write_seg
from smcsmc_tpu_torch.sweep_profile import (TWOPOP_PROPOSAL_FLAGS,
                                            twopop_data, twopop_flags)

out = {"dir": os.getcwd()}
with tempfile.TemporaryDirectory() as tmp:
    seg_path = os.path.join(tmp, "twopop.seg")
    write_seg(seg_path, twopop_data()[1])
    for run, extra in (("A", TWOPOP_PROPOSAL_FLAGS), ("B", ["-alpha", "0.5"])):
        argv = ["-seg", seg_path, "-o", os.path.join(tmp, run), "-Np",
                str(cs.TWOPOP_P), "-EM", "1", *twopop_flags(), *extra,
                "-seed", "7", "-device", "cuda"]
        _, _, st, _, wall = cs._run_cli(argv)
        out[run] = [dict(seconds=r.args[1], segments=r.args[2],
                         updates=cs.TWOPOP_P * r.args[2] / r.args[1],
                         logl=r.args[4]) for r in st]
print("MIGP_RUNS " + json.dumps(out), flush=True)
"""


def runs(dirs):
    for d in dirs:
        proc = subprocess.run([sys.executable, "-c", RUNS],
                              cwd=os.path.abspath(d), capture_output=True,
                              text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:] + proc.stderr[-4000:], flush=True)
            return proc.returncode
        line = next(ln for ln in proc.stdout.splitlines()
                    if ln.startswith("MIGP_RUNS "))
        r = json.loads(line[len("MIGP_RUNS "):])
        for run in ("A", "B"):
            print(f"runs {Path(d).resolve().name} {run}: " + "; ".join(
                f"E-step {k}: {x['seconds']:.3f} s, {x['updates']:.6g} "
                f"updates/s, LogL {x['logl']!r}"
                for k, x in enumerate(r[run])), flush=True)
    return 0


def main(argv):
    if not torch.cuda.is_available():
        print("mig_proposal_probe: no CUDA device", file=sys.stderr)
        return 1
    print(pc.card(), flush=True)
    filler = cs._filler()
    if argv[:1] == ["times"]:
        times(argv[1:] or [str(ROOT)], filler)
        return 0
    if argv[:1] == ["runs"]:
        return runs(argv[1:] or [str(ROOT)])
    source = _build.SOURCE
    if argv[:1] == ["--source"]:
        source, argv = Path(argv[1]).resolve(), argv[2:]
    text = source.read_text()
    what = argv or ["resources", "work", "phases"]
    if "resources" in what:
        lib, log = pc.build(OUT, {"source": text})["source"]
        for ln in pc.ptxas(log, "mig"):
            print(f"ptxas: {ln}", flush=True)
        resources(pc.load(lib))
    if "work" in what:
        work(text, filler)
    if "phases" in what:
        phases(text, filler)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
