"""Where the ARG variants of the narrow and migration passes of
``csrc/trip.cu`` spend their time, on one GPU.

    python3 tools/arg_probe.py [--source TRIP_CU] [resources] [work] [phases]
    python3 tools/arg_probe.py times DIR [DIR ...]
    python3 tools/arg_probe.py variants [--source TRIP_CU]
    python3 tools/arg_probe.py sass PARENT_DIR [DIR] [--changed NAME]

Device time per launch as ``chip_smoke`` times it (CUDA events, best of 3 x
20 launches on fresh states queued behind a matrix product), every ARG
launch on a ring in use (``chip_smoke.arg_ring``: ``arg_n`` up to twice
the ring's 512 slots, about half the rings wrapped, 16 one row short of
wrapping):

* ``resources``: registers, stack bytes, shared bytes, blocks per SM and
  the waves a launch of 10,000 particles takes (``kernel_resources``) of
  each ARG pass and its parent, with and without VB: the plain pass at
  (n=4, E=9) and (8, 33), the biased pass at (8, 33, 2 sections) and its
  caps (8, 64, 8), the migration pass at (4, 8, Pp=2, Mw=56) and its caps
  (8, 64, 4, 96).
* ``work``: each ARG pass beside its parent at P=10,000 with nobody
  recombining, every particle one trip and every particle 8 trips (a 1 Mb
  segment, nobody's chain past its end): the ARG's fixed part and its part
  per trip.
* ``phases``: (1) a copy of the kernels with ``clock64()`` around the ARG
  block's parts in a trip of the narrow passes and of the migration pass
  (the leaves' walks; the two ballots; lane 0's stores with their slot
  modulos) and around the SPR after them and the whole trip, lane 0's
  cycles summed over the launch and divided by the trips, with and
  without ARG; (2) each part measured apart: copies of the kernels that do
  the walks with their ballots twice ("walks x2") or lane 0's stores with
  their modulos twice ("stores x2"), on an index offset the compiler
  cannot see is 0, every output bit for bit the kernel's own (checked),
  timed in turns beside it and beside the pass without ARG.  Cells: the
  plain pass at (10,000, 4, 9) on the mean bench segment and at 50 kb,
  the biased pass at (10,000, 8, 33) on the genome data's mean segment,
  the migration pass at the twopop shape on its mean segment and at 50
  kb.  Lane 0's counters misread waits on memory: read their shares, and
  the parts measured apart for what a part costs a launch.  ``phases``
  reads the ARG blocks of the design it priced (PR 13's): give a later
  tree ``--source build/parent/smcsmc_tpu_torch/csrc/trip.cu``.

``times DIR [DIR ...]`` times, for each checkout DIR in a fresh process
started there (that checkout's ``chip_smoke``, wrappers and kernels), each
ARG pass beside its parent pass without ARG as that checkout's
``chip_smoke.phase_time_arg`` does (in turns parent, ARG, ARG, parent; the
bound is the parent's counted work, ``_bounds`` / ``_mig_bounds``, plus
the ring's): the plain pass at (10,000, 4, 9) on the mean bench segment
and at 50 kb, the biased pass at (10,000, 8, 33) on the genome data's
mean segment, the migration pass at (10,000, 4, 8, Pp=2, Mw=56) on the
twopop data's mean segment and at 50 kb, each with and without VB.  One
JSON line per DIR in the order given; give a parent checkout first and
last, so that two commits are compared within one call (parent, change,
change, parent).

``variants`` builds this tree's ``trip.cu`` and copies of it with one
design choice of the ARG blocks changed, and times them in turns beside
it: "prefetch" (each recombining particle's group asks the L2 for the
lines of its first rows' slots at the segment's entry), "walk late"
(the leaves' paths walked just before the ballots, not at the trip's
start), "64 registers" (the plain ARG pass held at 8 blocks an SM),
"ballots late" (the narrow pass's ballots at the trip's end, beside its
rows) and, to price each part, copies with a part taken out (their ring
outputs differ): "no stores" (the rows not written), "no walk" (no
leaf's path), "no ballots" (each lane's own bits for the leaves) and
"bare" (all three).  ``--source`` runs them on another design's
``trip.cu``; a variant that does not fit the source's text is left out.
Every other variant's outputs must be bit for bit the tree's (checked).  Cells: the plain pass at the mean bench segment, at
50 kb and with every particle one trip (a 1 Mb segment), the biased pass
at the genome mean, the migration pass at the twopop mean, at 50 kb and
with every particle one trip.

``sass PARENT_DIR [DIR]`` builds the ``trip.cu`` of both checkouts (DIR
defaults to this one), disassembles each library with ``cuobjdump -sass``
and compares them kernel by kernel: every kernel of the parent must be in
DIR the same code, instruction for instruction; DIR's kernels that the
parent lacks are listed (they must be instantiations of the migration
pass's proposal kernel, ``segment_pass_mig_proposal_kernel``).  Exits 1
if a kernel differs, is missing or is new and not one of those.  With
``--changed NAME`` the kernels whose mangled name NAME matches (a regular
expression: ``mig``, the migration unit's; ``local``, a name of
:data:`CHANGED`, the narrow kernels with local recording) may differ, and
each is listed with its local loads and stores (``LDL``/``STL``: spills)
in both builds.

``--source`` builds another ``trip.cu`` (a parent's, from a ``git archive``
under ``build/``) behind this tree's wrappers: the C interface is the same.
Prints the card's name and power limit first.  Library builds go into
``build/`` (gitignored)."""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
os.chdir(ROOT)

import chip_smoke as cs  # noqa: E402
import probe_common as pc  # noqa: E402
import torch  # noqa: E402
from smcsmc_tpu_torch.kernels import _build  # noqa: E402
from smcsmc_tpu_torch.kernels.trip import (  # noqa: E402
    kernel_resources,
    segment_pass,
)
from wide_probe import _insert, _span, _use_source  # noqa: E402

SOURCE = _build.SOURCE
# (label, kernel_resources variant, shapes)
RESOURCE_CELLS = (
    ("plain", "segment_pass", (dict(n=4, E=9), dict(n=8, E=33))),
    ("biased", "biased", (dict(n=8, E=33, S=2), dict(n=8, E=64, S=8))),
    ("migration", "migration", (dict(n=4, E=8, Pp=2, Mw=56),
                                dict(n=8, E=64, Pp=4, Mw=96))))


def _ptxas(info: _build.BuildInfo) -> list[str]:
    """ptxas's lines of the narrow plain, biased and migration kernels:
    name, registers, stack."""
    out, lines = [], info.log.splitlines()
    for j, ln in enumerate(lines):
        if "Compiling entry function" in ln and "wide" not in ln and any(
                k in ln for k in ("segment_pass_kernel", "biased_kernel",
                                  "mig_kernel")):
            name = ln.split("'")[1] if "'" in ln else ln
            out.append(name + ": " + " | ".join(
                x.strip() for x in lines[j + 1:j + 4]
                if "Function properties" not in x))
    return out


def resources():
    for label, variant, shapes in RESOURCE_CELLS:
        for shape in shapes:
            for arg in (False, True):
                for vb in (False, True):
                    r = kernel_resources(variant, vb=vb, arg=arg, **shape)
                    at = " ".join(f"{k}={v}" for k, v in shape.items())
                    print(f"resources {label}{' arg' if arg else ''}"
                          f"{' vb' if vb else ''} {at}: registers "
                          f"{r['registers']}, stack {r['local_bytes']} B, "
                          f"shared {r['dynamic_shared_bytes']} B per block "
                          f"of {r['particles_per_block']}, "
                          f"{r['blocks_per_sm']} blocks = "
                          f"{r['particles_per_sm']} particles per SM, "
                          f"{r['waves_at_10000']} waves at 10,000",
                          flush=True)


# the plain pass's shapes by kind ("plain" the main path's, "plain n=8"
# the genome's)
ARG_SHAPES = {"plain": (4, 9), "plain n=8": (8, 33)}


def arg_case(kind, L, seed=None, active=None, T=64):
    """(case, uniforms, fresh, run) of pass ``kind`` ("plain", "plain n=8",
    "biased", "migration") at its shape, as ``chip_smoke.phase_time_arg``
    drives it: drawn as a segment of length L finds it
    (``_timing_case`` / ``_mig_timing_case``) or, with ``seed``, every
    particle recombining (``active``) or nobody, uniforms for T trips; the
    state with an ARG ring in use; ``run(fn, u, st, arg=True, vb=None)``."""
    from smcsmc_tpu_torch.kernels.bias import BiasedPass
    from smcsmc_tpu_torch.kernels.migration import MigrationPass

    if kind == "migration":
        if seed is None:
            c, u = cs._mig_timing_case(cs.TWOPOP_P, L)
        else:
            c = cs.MigCase(10000, 1, L, 0.0, seed=seed)
            c.base["next_rec"].fill_(1.0 if active else 2 * L)
            u = c.uniforms(T)
        fresh0 = c.fresh

        def run(fn, u, st, arg=True, vb=None):
            mp = MigrationPass(st["pop"], st["mig_time"], st["mig_dest"],
                               st["diag"], c.key, *c.tables)
            fn(u, c.leaf_status, *(st[k] for k in cs.SEGMENT_STATE),
               st["fifo"], c.fifo_mask, st["tl"], c.L, cs.MU, cs.RHO,
               c.start, c.inv2ne, c.has_data, None, mp, vb=vb,
               arg=cs._arg_of(st) if arg else None)
            return st
    else:
        n, E = (8, 33) if kind == "biased" else ARG_SHAPES[kind]
        if seed is None:
            c, u = cs._timing_case(10000, n, E, L)
        else:
            c = cs.Case(10000, n, E, 1, L=L, nr_scale=0.0, seed=seed)
            c.base["next_rec"].fill_(1.0 if active else 2 * L)
            u = c.uniforms(T)
        biased = kind == "biased"
        fresh0 = c.fresh_biased if biased else c.fresh_segment

        def run(fn, u, st, arg=True, vb=None):
            bp = (BiasedPass(st["log_pilot"], st["df_pos"], st["df_logf"],
                             st["df_delta"], st["df_k"], *c.bias_tables,
                             cs.BIAS_FRONT) if biased else None)
            fn(u, c.leaf_status, *(st[k] for k in cs.SEGMENT_STATE),
               st["fifo"], c.fifo_mask, st["tl"], c.L, cs.MU, cs.RHO,
               c.start, c.inv2ne, c.has_data, bp, vb=vb,
               arg=cs._arg_of(st) if arg else None)
            return st
    fresh0()  # draws the biased pass's ring as phase_time does
    aring = cs.arg_ring(c.P, c.n, c.gen)
    c.aring = aring

    def fresh():
        st = fresh0()
        st.update({k: v.clone() for k, v in aring.items()})
        return st
    return c, u, fresh, run


def work(filler):
    for kind in ("plain", "plain n=8", "biased", "migration"):
        row = []
        for what, T, active in (("nobody recombines", 1, False),
                                ("1 trip", 1, True), ("8 trips", 8, True)):
            c, u, fresh, run = arg_case(kind, 1e6, seed=5, active=active,
                                        T=T)
            ms = [cs._best_device_ms(lambda st, arg=arg: run(
                segment_pass, u, st, arg), fresh, filler)
                for arg in (False, True, True, False)]
            rows = cs._arg_rows(run(segment_pass, u, fresh()), c.aring)
            row.append(f"{what} {min(ms[0], ms[3]) * 1e3:.2f} / "
                       f"{min(ms[1], ms[2]) * 1e3:.2f} (+"
                       f"{(min(ms[1:3]) - min(ms[0], ms[3])) * 1e3:.2f}; "
                       f"{rows} rows)")
        print(f"work {kind} (n={c.n} E={c.E}) P={c.P}, without / with ARG "
              "in turns: " + ", ".join(row) + " us per launch", flush=True)


# cycle sums in g_prof, by index: the narrow trip's, then the migration
# pass's
PARTS = ("walks", "ballots", "stores", "SPR", "trip", "trips")
MIG = len(PARTS)
SLOTS = 64
SLOT = f"((blockIdx.x * (BLOCK / GROUP) + threadIdx.x / GROUP) % {SLOTS})"
MIG_SLOT = f"((blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32) % {SLOTS})"


def _add(k: int, start: str, mig: bool = False) -> str:
    slot, sync = (MIG_SLOT, "__syncwarp()") if mig else (SLOT,
                                                          "__syncwarp(gm)")
    return (f"{sync}; if (lane == 0) atomicAdd(&g_prof[{k * SLOTS} + "
            f"{slot}], (unsigned long long)(clock64() - {start}));")


def _count(k: int, mig: bool = False) -> str:
    slot = MIG_SLOT if mig else SLOT
    return f"if (lane == 0) atomicAdd(&g_prof[{k * SLOTS} + {slot}], 1ull);"


# (anchor, text) as wide_probe._insert takes them: the parent's ARG blocks
TRIP_PROBES = (
    ("  // ---- extension: no-mutation likelihood",
     "  long long t_ = clock64();"),
    ("    bool bc = false, bd = false;", "    long long a_ = clock64();"),
    ("    const int shift = (threadIdx.x & 31) & ~(GROUP - 1);",
     "    " + _add(0, "a_") + " a_ = clock64();"),
    ("    if (lane == 0) {\n      const float pos = tb.front + nr;",
     "    " + _add(1, "a_") + " a_ = clock64();"),
    ("    *an += 2;", "    " + _add(2, "a_")),
    ("  // ---- SPR: cut the branch above c", "  long long s_ = clock64();"),
    ("  // ---- refreshed tree summaries", "  " + _add(3, "s_")),
    ("  return TripEvent{h_r, t_c,", "  " + _add(4, "t_") + " " + _count(5)),
)
MIG_PROBES = (
    ("    const float4 u = load_uniforms(a, k, i);",
     "    long long t_ = clock64();"),
    ("      bool bc = false, bd = false;", "      long long a_ = clock64();"),
    ("      const unsigned dc = __ballot_sync(WARP_ALL, bc);",
     "      " + _add(MIG, "a_", True) + " a_ = clock64();"),
    ("      if (lane == 0) {\n        const float pos = a.front + nr;",
     "      " + _add(MIG + 1, "a_", True) + " a_ = clock64();"),
    ("      an += 2 + hops;", "      " + _add(MIG + 2, "a_", True)),
    ("    // ---- the SPR with buffer routing",
     "    long long s_ = clock64();"),
    ("    // ---- refreshed summaries, then the next gap",
     "    " + _add(MIG + 3, "s_", True)),
    (">    moved = true;",
     "    " + _add(MIG + 4, "t_", True) + " " + _count(MIG + 5, True)),
)
TRIP_SPAN = "TripEvent one_trip("
MIG_SPAN = "segment_pass_mig_kernel(const Args a) {"


def instrumented(src: str) -> str:
    """``src`` (the parent's trip.cu) with the counters of ``phases`` in
    the narrow trip and the migration pass, and ``smc_arg_prof_read`` to
    read them."""
    lines = src.split("\n")
    lines = _insert(lines, *_span(lines, TRIP_SPAN), TRIP_PROBES)
    lines = _insert(lines, *_span(lines, MIG_SPAN), MIG_PROBES)
    text = "\n".join(lines)
    text = text.replace("namespace {\n", "namespace {\n__device__ unsigned "
                        f"long long g_prof[{2 * MIG * SLOTS}];\n", 1)
    return text + f"""
#if SMC_NARROW
extern "C" int smc_arg_prof_read(unsigned long long* out) {{
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  if (e != cudaSuccess) return (int)e;
  unsigned long long z[{2 * MIG * SLOTS}] = {{0}};
  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}}
#endif
"""


# The parts measured apart: text replaced inside the ARG blocks of the
# parent's narrow trip and migration pass.  `z_` is 0 at run time (the
# front is never NaN) but not to the compiler, so the second walk and the
# second stores stay; every output is the kernel's own.
ZERO = "const int z_ = {front} != {front} ? 1 : 0;"
NARROW_WALK = """    bool bc = false, bd = false;
    if (lane < tb.n) {
      int cur = lane;
      for (int s = 0; s < N && cur >= 0; ++s) {
        bc = bc || cur == c;
        bd = bd || cur == d;
        cur = w.par[cur];
      }
    }
    const int shift = (threadIdx.x & 31) & ~(GROUP - 1);
    const unsigned dc = (__ballot_sync(gm, bc) >> shift) & ((1u << GROUP) - 1u);
    const unsigned dd = (__ballot_sync(gm, bd) >> shift) & ((1u << GROUP) - 1u);
"""
NARROW_STORES = """    if (lane == 0) {
      const float pos = tb.front + nr;
      arg_push(*a, i, *an, 0, pos, h_r, -1, -1, (long long)dc);
      arg_push(*a, i, *an + 1, 1, pos, t_c, 0, -1, (long long)(dc | dd));
    }
"""
MIG_WALK = """      bool bc = false, bd = false;
      if (lane < n) {
        int cur = lane;
        for (int s = 0; s < N && cur >= 0; ++s) {
          bc = bc || cur == c;
          bd = bd || cur == d;
          cur = w.par[cur];
        }
      }
      const unsigned dc = __ballot_sync(WARP_ALL, bc);
      const unsigned dd = __ballot_sync(WARP_ALL, bd);
"""
MIG_STORES = """      if (lane == 0) {
        const float pos = a.front + nr;
        arg_push(a, i, an, 0, pos, h_r, -1, -1, (long long)dc);
        arg_push(a, i, an + 1, 1, pos, t_c, fpop, -1, (long long)(dc | dd));
        for (int j = 0; j < hops; ++j)
          arg_push(a, i, an + 2 + j, 2, pos, w.ev_t[j],
                   j == 0 ? p_start : (int)w.ev_d[j - 1], (int)w.ev_d[j],
                   (long long)dc);
      }
"""


def _twice_walk(block: str, front: str) -> str:
    """``block`` (the walks and ballots) done twice, the second on the
    targets plus ``z_``; the masks the AND of both (equal)."""
    second = (block.replace("bool bc = false, bd = false;",
                            "bool bc2 = false, bd2 = false;")
              .replace("bc = bc || cur == c;", "bc2 = bc2 || cur == c + z_;")
              .replace("bd = bd || cur == d;", "bd2 = bd2 || cur == d + z_;")
              .replace("const unsigned dc =", "const unsigned dc2 =")
              .replace("const unsigned dd =", "const unsigned dd2 =")
              .replace("ballot_sync(gm, bc)", "ballot_sync(gm, bc2)")
              .replace("ballot_sync(gm, bd)", "ballot_sync(gm, bd2)")
              .replace("(WARP_ALL, bc)", "(WARP_ALL, bc2)")
              .replace("(WARP_ALL, bd)", "(WARP_ALL, bd2)")
              .replace("const int shift =", "const int shift2 =")
              .replace(">> shift)", ">> shift2)"))
    first = (block.replace("const unsigned dc =", "const unsigned dc1 =")
             .replace("const unsigned dd =", "const unsigned dd1 ="))
    pad = block[:len(block) - len(block.lstrip())]
    return (first + pad + ZERO.format(front=front) + "\n" + second + pad
            + "const unsigned dc = dc1 & dc2, dd = dd1 & dd2;\n")


def _twice_stores(block: str, front: str, an: str) -> str:
    """``block`` (lane 0's pushes) done twice, the second at row ``an``
    plus ``z_``."""
    pad = block[:len(block) - len(block.lstrip())]
    second = block.replace(f"i, {an} + ", f"i, {an} + z_ + ").replace(
        f"i, {an},", f"i, {an} + z_,")
    return block + pad + ZERO.format(front=front) + "\n" + second


def apart_sources(src: str) -> dict[str, str]:
    """The parent's trip.cu with each part of the ARG blocks done twice:
    {"walks x2": text, "stores x2": text}."""
    for block in (NARROW_WALK, NARROW_STORES, MIG_WALK, MIG_STORES):
        if src.count(block) != 1:
            raise SystemExit("arg_probe: the source's ARG blocks are not "
                             "the parent's")
    return {
        "walks x2": src.replace(NARROW_WALK, _twice_walk(
            NARROW_WALK, "tb.front")).replace(MIG_WALK, _twice_walk(
                MIG_WALK, "a.front")),
        "stores x2": src.replace(NARROW_STORES, _twice_stores(
            NARROW_STORES, "tb.front", "*an")).replace(
                MIG_STORES, _twice_stores(MIG_STORES, "a.front", "an")),
    }


def _means():
    """The mean segment (bp) of the bench, genome and twopop data."""
    import numpy as np

    from smcsmc_tpu_torch.segio import split_long_segments
    from smcsmc_tpu_torch.sweep_profile import (
        bench_data,
        genome_data,
        twopop_data,
    )

    def mean(seg):
        return split_long_segments(seg, cs.MAX_SEG).lengths

    return dict(bench=float(mean(bench_data()[1]).mean()),
                genome=float(np.concatenate([mean(s) for s in genome_data()])
                             .mean()),
                twopop=float(mean(twopop_data()[1]).mean()))


# the cells of phases: (kind, label, which mean; None: 50 kb)
PHASE_CELLS = (("plain", "mean", "bench"), ("plain", "50 kb", None),
               ("biased", "genome mean", "genome"),
               ("migration", "mean", "twopop"), ("migration", "50 kb", None))


def phases(text: str, filler):
    means = _means()
    # (1) the counters
    info = _use_source(instrumented(text), "arg_probe_phases")
    for ln in _ptxas(info):
        print(f"phases ptxas: {ln}", flush=True)
    lib = _build.load_trip_library()
    lib.smc_arg_prof_read.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * (2 * MIG * SLOTS))()
    for kind, label, which in PHASE_CELLS:
        L = means[which] if which else cs.MAX_SEG
        c, u, fresh, run = arg_case(kind, L)
        base = MIG if kind == "migration" else 0
        for arg in (False, True):
            lib.smc_arg_prof_read(buf)
            run(segment_pass, u, fresh(), arg)
            torch.cuda.synchronize()
            lib.smc_arg_prof_read(buf)
            v = [sum(buf[(base + k) * SLOTS:(base + k + 1) * SLOTS])
                 for k in range(MIG)]
            tr = max(v[5], 1)
            print(f"phases {kind}{' arg' if arg else ''} {label} "
                  f"(L={L:.1f}): {v[5]} trips; cycles per trip: "
                  + ", ".join(f"{PARTS[k]} {v[k] / tr:.0f}"
                              for k in range(5))
                  + (f"; the ARG block's share of a trip "
                     f"{sum(v[:3]) / max(v[4], 1):.3f}" if arg else ""),
                  flush=True)
    # (2) the parts measured apart
    libs = {}
    for name, src in (("ARG", text), *apart_sources(text).items()):
        info = _use_source(src, "arg_probe_" + name.replace(" ", "_"))
        print(f"built {name} in {info.seconds:.1f} s", flush=True)
        libs[name] = _build.load_trip_library()
    for kind, label, which in PHASE_CELLS:
        L = means[which] if which else cs.MAX_SEG
        c, u, fresh, run = arg_case(kind, L)
        for vb in (None, cs.vb_tables(c.demo, 5)):
            names = ("ARG", "walks x2", "stores x2")
            same = pc.same(libs, names, fresh,
                           lambda fn, st, vb=vb: run(fn, u, st, vb=vb))
            ms = pc.turns(libs, names, fresh,
                          lambda fn, st, vb=vb: run(fn, u, st, vb=vb), filler)
            parent = min(cs._best_device_ms(
                lambda st, vb=vb: run(pc.via(libs["ARG"]), u, st, False, vb),
                fresh, filler) for _ in range(2))
            print(f"apart {kind}{' vb' if vb is not None else ''} {label} "
                  f"(L={L:.1f}): ARG {ms['ARG'] * 1e3:.2f} us, walks x2 "
                  f"{ms['walks x2'] * 1e3:.2f} (+"
                  f"{(ms['walks x2'] - ms['ARG']) * 1e3:.2f}), stores x2 "
                  f"{ms['stores x2'] * 1e3:.2f} (+"
                  f"{(ms['stores x2'] - ms['ARG']) * 1e3:.2f}); without ARG "
                  f"{parent * 1e3:.2f} us; outputs bit for bit the ARG "
                  f"kernel's: {same}", flush=True)
            if not all(same.values()):
                raise SystemExit("arg_probe: a doubled part changed an "
                                 "output")


# The `times` script, run in each checkout: the parent pass's counted work
# as chip_smoke.phase_time / phase_time_migration count it, then that
# checkout's phase_time_arg on the cells given.
RUN = """
import json, os, sys
sys.path.insert(0, os.getcwd())
import numpy as np
import chip_smoke as cs
import torch
from smcsmc_tpu_torch.kernels.trip import (segment_pass, segment_pass_plain,
                                           trip)
from smcsmc_tpu_torch.segio import split_long_segments
from smcsmc_tpu_torch.sweep_profile import bench_data, genome_data, twopop_data


def parent_row(name, L):
    import smcsmc_tpu_torch.kernels.migration as mig_mod
    from smcsmc_tpu_torch.kernels.migration import stats_offsets
    from smcsmc_tpu_torch.kernels.tree import INF

    vb = "vb" in name
    if "migration" in name:
        c, u = cs._mig_timing_case(cs.TWOPOP_P, L)
        seen, walk = [], mig_mod.walk_mig

        def counting(*a, **k):
            out = walk(*a, **k)
            seen.append(out[8][a[6]])
            return out

        mig_mod.walk_mig = counting
        try:
            c.run(segment_pass_plain, u, c.fresh())
        finally:
            mig_mod.walk_mig = walk
        st = c.run(segment_pass, u, c.fresh())
        b = c.base
        act = b["next_rec"] < L
        off = stats_offsets(c.E, 2)["recomb_cnt"]
        trips = int(round(float(st["fifo"][:, 0, off:].sum())))
        bound = cs._mig_bounds(
            c, int(act.sum()), trips, int(torch.cat(seen).sum()),
            int((b["mig_time"][act] < INF).sum()),
            int(((st["mig_time"] != b["mig_time"])
                 | (st["mig_dest"] != b["mig_dest"])).any(dim=2).sum()),
            int((st["fifo"][:, 0] != 0).sum()))
        if vb:
            bound = cs._with_vb(bound, c.E, 2, trips)
        return dict(bound, trips=trips)
    biased = "biased" in name
    n, E = (8, 33) if biased else (4, 9)
    c, u = cs._timing_case(10000, n, E, L)
    st = c.run(trip, u, c.fresh())
    trips = int(round(float(st["pending"][:, 5 * c.E:].sum())))
    active = int((c.base["next_rec"] < L).sum())
    st = c.run_segment(segment_pass, u, c.fresh_segment())
    pushed = int((st["fifo"][:, 0] != 0).sum())
    moved = 0
    if biased:
        st = c.run_biased(segment_pass, u, c.fresh_biased())
        moved = int(sum((st[k] != c.ring[k]) for k in (
            "df_pos", "df_logf", "df_delta", "df_k")).gt(0).sum())
    bound = cs._bounds(c, active, trips, pushed, moved)[
        cs.BIASED_PASS if biased else "segment_pass"]
    if vb:
        bound = cs._with_vb(bound, E, 1, trips)
    return dict(bound, trips=trips)


def mean(seg):
    return split_long_segments(seg, cs.MAX_SEG).lengths

means = dict(bench=float(mean(bench_data()[1]).mean()),
             genome=float(np.concatenate([mean(s) for s in genome_data()])
                          .mean()),
             twopop=float(mean(twopop_data()[1]).mean()))
CELLS = json.loads(sys.argv[1])
kernels = {"segment_pass": (segment_pass, segment_pass_plain)}
everyone = dict(cs.ARG_PARENTS)
out = {"dir": os.getcwd(), "rows": {}}
for label, which in CELLS:
    lengths = {cs.vb_name(k) if vb else k: means[w] if w else cs.MAX_SEG
               for k, w in which.items() for vb in (False, True)}
    cs.ARG_PARENTS = {k: everyone[k] for k in lengths}
    parents = {k: parent_row(k, L) for k, L in lengths.items()}
    rows = cs.phase_time_arg(kernels, lengths, parents)
    for k, t in rows.items():
        out["rows"][f"{label}: {k}"] = dict(
            us=t["kernel_ms"] * 1e3, parent_us=t["parent_ms"] * 1e3,
            turns_us=[x * 1e3 for x in t["turns_ms"]],
            bound_us=t["bound_ms"] * 1e3, bound_by=t["bound_by"],
            share=t["bound_ms"] / t["kernel_ms"], rows=t["rows_pushed"],
            trips=t["trips"], active=t["active"], L=t["L"],
            plain_ms=t["plain_ms"], host_us=t["host_us"])
print("ARG_TIMES " + json.dumps(out), flush=True)
"""
# (label, {pass: which mean, None for 50 kb}); each pass with and without
# VB
TIME_CELLS = (
    ("mean", {cs.ARG_PASS: "bench", cs.BIASED_ARG_PASS: "genome",
              cs.MIGRATION_ARG_PASS: "twopop"}),
    ("50 kb", {cs.ARG_PASS: None, cs.MIGRATION_ARG_PASS: None}))


def times(dirs):
    rows = []
    for d in dirs:
        proc = subprocess.run([sys.executable, "-c", RUN,
                               json.dumps(TIME_CELLS)],
                              cwd=os.path.abspath(d), capture_output=True,
                              text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, flush=True)
            return proc.returncode
        line = next(ln for ln in proc.stdout.splitlines()
                    if ln.startswith("ARG_TIMES "))
        rows.append(json.loads(line[len("ARG_TIMES "):]))
        print(line, flush=True)
    for key in rows[0]["rows"]:
        print(f"{key}: " + ", ".join(
            f"{r['dir'].rsplit('/', 1)[-1]} {r['rows'][key]['us']:.2f} us "
            f"(without ARG {r['rows'][key]['parent_us']:.2f}; "
            f"{r['rows'][key]['share']:.4f} of "
            f"{r['rows'][key]['bound_us']:.3f} us)"
            for r in rows if key in r["rows"]), flush=True)
    return 0


# The design choices priced by `variants`: (name, groups of edits, each
# [(old, new), ...] of text replaced in a trip.cu).  A group applies where
# its first text is there (the anchors of the designs tried: the rows
# pushed before the SPR with a division for the first slot, the rows
# pushed at the trip's end, the final design with one ballot and a mask
# for the first slot); a variant that fits no group is left out.
PREFETCH = """
// ARG: lanes 0-5 ask the L2 for the line of field `lane` at `slot`
__device__ __forceinline__ void arg_prefetch(const Args& a, int i, int slot,
                                             int lane) {
  const size_t at = (size_t)i * a.A + slot;
  const void* p = lane == 0 ? (const void*)(a.arg_pos + at)
      : lane == 1 ? (const void*)(a.arg_code + at)
      : lane == 2 ? (const void*)(a.arg_time + at)
      : lane == 3 ? (const void*)(a.arg_from + at)
      : lane == 4 ? (const void*)(a.arg_to + at)
      : (const void*)(a.arg_desc + at);
  if (lane < 6) asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// ARG: the nodes on the path"""
NARROW_SLOTS = ("    if constexpr (ARG) ac.slot = (int)((unsigned)ac.n % "
                "(unsigned)a.A);\n",
                "    if constexpr (ARG) ac.slot = arg_slot_of(ac.n, a.A);\n")
MIG_SLOTS = ("      ac.slot = (int)((unsigned)ac.n % (unsigned)a.A);\n",
             "    if (a.trips > 0 && nr < a.L) ac.slot = arg_slot_of(ac.n, "
             "a.A);\n")
# each leaf's path walked at the trip's start, and where the ballots start
NARROW_PATHS = {
    "  if constexpr (ARG) path = leaf_path<NP>(w.par, lane, tb.n);\n":
        ("  if constexpr (ARG) path = 0u;\n",
         "    path = leaf_path<NP>(w.par, lane, tb.n);\n"),
    "  if constexpr (ARG)\n"
    "    path = leaf_path<NP>(w.par, NP == 7 ? lane & 3 : lane, tb.n);\n":
        ("  if constexpr (ARG)\n    path = 0u;\n",
         "    path = leaf_path<NP>(w.par, NP == 7 ? lane & 3 : lane, "
         "tb.n);\n")}
NARROW_BALLOTS = (
    "    // slot the C row, the later push, is the one kept ----\n",
    "    // below c and below d (a leaf is below a node on its path) ----\n",
    "    // C row, the later push, is the one kept ----\n")
MIG_PATHS = {
    "    if constexpr (ARG) path = leaf_path<MAX_NODES>(w.par, lane, n);\n":
        ("    if constexpr (ARG) path = 0u;\n",
         "      path = leaf_path<MAX_NODES>(w.par, lane, n);\n"),
    "    if constexpr (ARG)\n"
    "      path = leaf_path<MAX_NODES>(w.par, lane & 7, lane < 16 ? n : 0);\n":
        ("    if constexpr (ARG)\n      path = 0u;\n",
         "      path = leaf_path<MAX_NODES>(w.par, lane & 7, lane < 16 ? n : "
         "0);\n")}
MIG_BALLOTS = ("      // rows) is not written ----\n",
               "      // fewer slots than rows) is not written ----\n",
               "      // the trip takes (a ring of fewer slots than rows) is "
               "not written ----\n")
PLAIN_KERNEL = ("template <int NP, bool VB, bool LOCAL, bool ARG = false>\n"
                "__global__ void __launch_bounds__(BLOCK) segment_pass_kernel")
PUT_BODY = """  const size_t at = (size_t)i * a.A + slot;
  a.arg_pos[at] = pos;
  a.arg_code[at] = (signed char)code;
  a.arg_time[at] = time;
  a.arg_from[at] = (signed char)from;
  a.arg_to[at] = (signed char)to;
  a.arg_desc[at] = desc;
}
"""
# the ballots, as each lane's own bits (a part taken out)
BALLOTS_OUT = [
    ("    dc = (__ballot_sync(gm, bc) >> shift) & ((1u << GROUP) - 1u);\n"
     "    dd = (__ballot_sync(gm, bd) >> shift) & ((1u << GROUP) - 1u);\n",
     "    dc = bc;\n    dd = bd;\n"),
    ("    const unsigned dc = (__ballot_sync(gm, bc) >> shift) & ((1u << "
     "GROUP) - 1u);\n    const unsigned dd = (__ballot_sync(gm, bd) >> "
     "shift) & ((1u << GROUP) - 1u);\n",
     "    const unsigned dc = bc, dd = bd;\n"),
    ("      dc = (__ballot_sync(gm, bc) >> shift) & ((1u << GROUP) - 1u);\n"
     "      dd = (__ballot_sync(gm, bd) >> shift) & ((1u << GROUP) - 1u);\n",
     "      dc = bc;\n      dd = bd;\n"),
    ("          (__ballot_sync(gm, x >= 0 && (path >> x & 1u) != 0u) >> "
     "shift)\n", "          ((x >= 0 && (path >> x & 1u) != 0u) >> shift)\n"),
    ("      const unsigned dc = __ballot_sync(WARP_ALL, bc);\n"
     "      const unsigned dd = __ballot_sync(WARP_ALL, bd);\n",
     "      const unsigned dc = bc, dd = bd;\n"),
    ("          __ballot_sync(WARP_ALL, x >= 0 && (path >> x & 1u) != 0u);\n",
     "          (x >= 0 && (path >> x & 1u) != 0u);\n")]
# the narrow pass's ballots before the SPR and its rows at the trip's end
NARROW_BALLOT_BLOCK = """  if constexpr (ARG) {
    // ---- the leaves of the trip's ARG rows, in the tree before the SPR:
    // below c and below d (a leaf is below a node on its path) ----
    const bool bc = c >= 0 && (path >> c & 1u) != 0u;
    const bool bd = d >= 0 && (path >> d & 1u) != 0u;
    const int shift = (threadIdx.x & 31) & ~(GROUP - 1);
    dc = (__ballot_sync(gm, bc) >> shift) & ((1u << GROUP) - 1u);
    dd = (__ballot_sync(gm, bd) >> shift) & ((1u << GROUP) - 1u);
  }
"""
NARROW_ROWS_AT_END = ("  if constexpr (ARG) {\n    // ---- the trip's ARG "
                      "rows (smc.py:1021-1037) at its position (now\n")
# the parts taken out (their ring outputs differ from the tree's)
DIAGNOSTIC = {
    "no stores": [[(PUT_BODY, "}\n")]],
    "no walk": [[(k, v[0])] for k, v in {**NARROW_PATHS,
                                         **MIG_PATHS}.items()],
    "no ballots": [[x] for x in BALLOTS_OUT],
}
DIAGNOSTIC["bare"] = sum(DIAGNOSTIC.values(), [])
# each design's ballots anchor beside the path it walks
WALKS = list(zip(NARROW_BALLOTS, [*NARROW_PATHS.items()][:1] * 2
                 + [*NARROW_PATHS.items()][1:])) + list(zip(
                     MIG_BALLOTS, [*MIG_PATHS.items()][:1] * 2
                     + [*MIG_PATHS.items()][1:]))
VARIANTS = (
    ("prefetch", [[("\n// ARG: the nodes on the path", PREFETCH)]]
     + [[(x, x + "    if constexpr (ARG) arg_prefetch(a, i, ac.slot, lane);"
          "\n")] for x in NARROW_SLOTS]
     + [[(x, x + "    if (a.trips > 0 && nr < a.L) arg_prefetch(a, i, "
          "ac.slot, lane);\n")] for x in MIG_SLOTS]),
    ("walk late", [[(b, b + walk), (path, zero)]
                   for b, (path, (zero, walk)) in WALKS]),
    ("64 registers", [[
        (PLAIN_KERNEL, PLAIN_KERNEL.replace("(BLOCK)", "(BLOCK, ARG ? 8 : 1)"))
    ]]),
    ("ballots late", [[(NARROW_BALLOT_BLOCK, ""),
                       (NARROW_ROWS_AT_END,
                        NARROW_BALLOT_BLOCK + NARROW_ROWS_AT_END)]]),
    *DIAGNOSTIC.items(),
)


def _variant(text: str, name: str, groups) -> str | None:
    """``text`` with each group of a variant's edits whose first text is
    there (None: no group is)."""
    done = 0
    for group in groups:
        if group[0][0] not in text:
            continue
        for old, new in group:
            if text.count(old) != 1:
                raise SystemExit(f"arg_probe: variant {name}: {old[:60]!r} "
                                 f"found {text.count(old)} times")
            text = text.replace(old, new)
        done += 1
    return text if done else None


# (kind, label, which mean, or None: 50 kb, or "one trip")
VARIANT_CELLS = (("plain", "mean", "bench"), ("plain", "50 kb", None),
                 ("plain", "one trip each", "one trip"),
                 ("biased", "genome mean", "genome"),
                 ("migration", "mean", "twopop"), ("migration", "50 kb", None),
                 ("migration", "one trip each", "one trip"))


def variants(text: str, filler):
    means = _means()
    libs = {}
    for name, edits in (("tree", []), *VARIANTS):
        src = _variant(text, name, edits) if edits else text
        if src is None:
            print(f"variant {name} does not fit this source", flush=True)
            continue
        info = _use_source(src, "arg_probe_" + name.replace(" ", "_"))
        print(f"built {name} in {info.seconds:.1f} s", flush=True)
        for ln in _ptxas(info):
            if "Lb1EEEv" in ln.split(":")[0]:
                print(f"  ptxas {name}: {ln}", flush=True)
        libs[name] = _build.load_trip_library()
    names = list(libs)
    for kind, label, which in VARIANT_CELLS:
        if which == "one trip":
            c, u, fresh, run = arg_case(kind, 1e6, seed=5, active=True, T=1)
        else:
            c, u, fresh, run = arg_case(
                kind, means[which] if which else cs.MAX_SEG)
        same = pc.same(libs, names, fresh,
                       lambda fn, st: run(fn, u, st))
        ms = pc.turns(libs, names, fresh, lambda fn, st: run(fn, u, st),
                      filler)
        parent = cs._best_device_ms(lambda st: run(
            pc.via(libs["tree"]), u, st, False), fresh, filler)
        print(f"variants {kind} {label}: " + ", ".join(
            f"{n} {ms[n] * 1e3:.2f} us" for n in names)
            + f"; without ARG {parent * 1e3:.2f} us; bit for bit the tree's: "
            f"{same}", flush=True)
        if not all(same[n] for n in same if n not in DIAGNOSTIC):
            raise SystemExit("arg_probe: a design variant changed an output")


# the kernels a tree may add beside its parent's: the migration pass's
# proposal variants, the wide guided and local passes
NEW_KERNELS = ("segment_pass_mig_proposal_kernel",
               "segment_pass_wide_local_kernel",
               "segment_pass_biased_wide_proposal_kernel")
# --changed by name: the narrow kernels with local recording (the plain
# pass's LOCAL, the third template argument; the biased pass's, the
# fourth)
CHANGED = {"local": r"segment_pass_kernelILi\d+ELb[01]ELb1E"
                    r"|segment_pass_biased_kernelILi\d+ELb[01]ELb[01]ELb1E"}


def sass(parent: str, here: str, changed: str | None = None) -> int:
    pattern = re.compile(CHANGED.get(changed, changed)) if changed else None

    def named(k):
        return pattern is not None and pattern.search(k) is not None

    codes = []
    for d in (parent, here):
        src = Path(d).resolve() / "smcsmc_tpu_torch" / "csrc" / "trip.cu"
        info = _use_source(src.read_text(), "arg_probe_sass_"
                           + str(len(codes)))
        codes.append(pc.sass(info.path))
        print(f"sass {src}: {len(codes[-1])} kernels", flush=True)
    old, new = codes
    missing = sorted(set(old) - set(new))
    added = sorted(set(new) - set(old))
    foreign = [k for k in added if not any(x in k for x in NEW_KERNELS)]
    differ = sorted(k for k in old if k in new and old[k] != new[k])
    for k in sorted(old):
        what = ("missing" if k in missing else "differs" if k in differ
                else "same")
        spills = ""
        if named(k) and k in new:
            (l0, s0), (l1, s1) = pc.spills(old[k]), pc.spills(new[k])
            spills = f"; LDL {l0} / {l1}, STL {s0} / {s1}"
        print(f"sass {what}: {k} ({old[k].count(chr(10))} / "
              f"{new[k].count(chr(10)) if k in new else 0} lines{spills})")
    for k in added:
        print(f"sass new: {k} ({new[k].count(chr(10))} lines)")
    outside = [k for k in differ if not named(k)]
    print(f"sass: {len(old)} kernels of the parent, {len(differ)} differ "
          f"({len(outside)} outside those named {changed!r}), "
          f"{len(missing)} missing; {len(added)} new, {len(foreign)} of "
          f"them not a proposal or wide guided or local kernel", flush=True)
    return 1 if outside or missing or foreign else 0


def main(argv):
    if not torch.cuda.is_available():
        print("arg_probe: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    if argv[:1] == ["times"]:
        return times(argv[1:] or [str(ROOT)])
    if argv[:1] == ["variants"]:
        variants((Path(argv[2]).resolve() if argv[1:2] == ["--source"]
                  else SOURCE).read_text(), cs._filler())
        _build.SOURCE = SOURCE
        _build.load_trip_library.cache_clear()
        return 0
    if argv[:1] == ["sass"]:
        changed = None
        if "--changed" in argv:
            k = argv.index("--changed")
            changed, argv = argv[k + 1], argv[:k] + argv[k + 2:]
        rc = sass(argv[1], argv[2] if len(argv) > 2 else str(ROOT), changed)
        _build.SOURCE = SOURCE
        _build.load_trip_library.cache_clear()
        return rc
    source = SOURCE
    if argv[:1] == ["--source"]:
        source, argv = Path(argv[1]).resolve(), argv[2:]
    text = source.read_text()
    what = argv or ["resources", "work", "phases"]
    filler = cs._filler()
    if "resources" in what or "work" in what:
        info = _use_source(text, "arg_probe")
        print(f"built {source} in {info.seconds:.1f} s", flush=True)
        for ln in _ptxas(info):
            print(f"ptxas: {ln}", flush=True)
    if "resources" in what:
        resources()
    if "work" in what:
        work(filler)
    if "phases" in what:
        phases(text, filler)
    _build.SOURCE = SOURCE
    _build.load_trip_library.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
