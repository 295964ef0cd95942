"""Where the biased variant of ``segment_pass`` spends its time, on one GPU.

    python3 tools/bias_probe.py [resources] [census] [work] [phases] [occupancy]

At the genome path's shape (P=10,000, n=8, E=33; two sections and the
32-slot ring of ``chip_smoke``'s ``BIAS_*`` tables), with device time per
launch as ``chip_smoke`` times it (CUDA events, best of 3 x 20 launches):

* ``resources``: every kernel's registers, stack bytes, shared bytes,
  particles per block, blocks and particles per SM and the waves a launch
  of 10,000 particles takes (``kernel_resources``), at n=4, E=9 and at
  n=8, E=33.
* ``census``: what the real path's rings hold: the first 600 segments of
  the genome data's first chunk swept with the production proposal
  (``chip_smoke.ring_census``).
* ``work``: the biased pass against the plain one at one wave of particles
  (SMs x the particles an SM holds of the biased kernel) and at P=10,000:
  nobody recombining, one trip, 8 trips; each biased row with the ring
  empty, 30% full (``Case.fresh_biased``'s density) and full.
* ``phases``: a copy of the kernel with ``clock64()`` around its phases
  (entry loads, the point, the hazard and records, the SPR and summaries,
  the ring push, the drain, the write-back), lane 0's sums divided by its
  counts; the counters cost registers, so read the shares, not the totals.
* ``occupancy``: the biased kernel at its natural register count against
  the counts that ``__launch_bounds__(BLOCK, k)`` allows for k = 4, 5, 6
  resident blocks per SM: registers, stack bytes and time at the mean
  genome segment and at 50 kb, over two rounds in opposite order.

Prints the card's name and power limit first.  Library builds go into
``build/`` (gitignored)."""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
os.chdir(ROOT)

import chip_smoke as cs  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from smcsmc_tpu_torch.kernels import _build  # noqa: E402
from smcsmc_tpu_torch.kernels.tree import INF  # noqa: E402
from smcsmc_tpu_torch.kernels.trip import (  # noqa: E402
    RESOURCE_VARIANTS,
    kernel_resources,
    segment_pass,
)

SOURCE = _build.SOURCE
P, N_LEAVES, E = cs.GENOME_P, 8, 33
# the declaration of the biased pass's kernel, whose launch bounds the
# occupancy rows replace
DECL = re.compile(r"__global__ void __launch_bounds__\([^)]*\)\s*"
                  r"segment_pass_biased_kernel\(")


def _use_source(text: str, name: str) -> _build.BuildInfo:
    """Build ``text`` as the trip library from ``build/<name>/trip.cu``."""
    d = ROOT / "build" / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "trip.cu").write_text(text)
    _build.SOURCE = d / "trip.cu"
    _build.load_trip_library.cache_clear()
    return _build.build_trip_library()


def _restore():
    _build.SOURCE = SOURCE
    _build.load_trip_library.cache_clear()


def _ptxas_of_biased(info: _build.BuildInfo) -> str:
    """ptxas's lines of the biased instantiation at 15 nodes, without
    VB."""
    lines = info.log.splitlines()
    for j, ln in enumerate(lines):
        if "Compiling entry function" in ln \
                and "segment_pass_biased_kernelILi15ELb0E" in ln:
            return " | ".join(x.strip() for x in lines[j + 1:j + 4]
                              if "Function properties" not in x)
    return "(no ptxas output)"


def resources():
    for n, e in ((4, 9), (N_LEAVES, E)):
        for variant in RESOURCE_VARIANTS:
            kw = dict(Pp=2, Mw=cs.TWOPOP_MW) if variant == "migration" else {}
            ee = 8 if variant == "migration" and n == 4 else e
            print(f"resources {variant} n={n} E={ee}: "
                  f"{kernel_resources(variant, n, ee, **kw)}", flush=True)


def _genome():
    """The genome data's model, merged segments and chunks, and the mean
    segment length of the sweep over them."""
    from smcsmc_tpu_torch.em import EMConfig, define_chunks
    from smcsmc_tpu_torch.segio import slice_seg, split_long_segments, write_seg
    from smcsmc_tpu_torch.sweep_profile import genome_data, genome_model

    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, k) for k in ("a.seg", "b.seg")]
        for path, chrom in zip(paths, genome_data()):
            write_seg(path, chrom)
        demo, seg = genome_model(paths)
    cfg = EMConfig()
    chunks = [(c.start, c.end) for c in define_chunks(
        seg, 4, maxgap=cfg.maxgap, minseg=cfg.minseg)]
    mean_len = float(np.concatenate([
        split_long_segments(slice_seg(seg, c0, c1), cs.MAX_SEG).lengths
        for c0, c1 in chunks]).mean())
    return demo, seg, chunks, mean_len


def census(demo, seg, chunks):
    rep = cs.ring_census(demo, seg, tuple(chunks[0]))
    print("census (first 600 segments of chunk "
          f"{chunks[0]}, P={P}): " + ", ".join(
              f"{k} {v:.4f}" for k, v in rep.items()), flush=True)


def _ring(c, density):
    """``c``'s ring tables with ``density`` of the slots in use."""
    c.fresh_biased()  # the section table and delays
    D = cs.BIAS_SLOTS
    used = torch.rand((c.P, D), generator=c.gen, device="cuda") < density
    pos = cs.BIAS_FRONT + 2 * c.L * torch.rand((c.P, D), generator=c.gen,
                                               device="cuda")
    c.ring = dict(
        log_pilot=torch.randn(c.P, generator=c.gen, device="cuda"),
        df_pos=torch.where(used, pos, torch.full_like(pos, INF)),
        df_logf=torch.where(used, torch.randn_like(pos), 0.0),
        df_delta=torch.where(used, 3000.0 * torch.rand_like(pos), 0.0),
        df_k=torch.where(used, torch.randint_like(pos, 1, 4), 0).to(
            torch.int32))


def _time(launch, fresh, filler):
    return cs._best_device_ms(launch, fresh, filler) * 1e3


def work(filler):
    res = kernel_resources("biased", N_LEAVES, E)
    wave = res["sms"] * res["particles_per_sm"]
    for Pw in (wave, P):
        for label, T, active in (("nobody recombines", 1, False),
                                 ("1 trip", 1, True), ("8 trips", 8, True)):
            L = 1e9 if active else 1000.0
            c = cs.Case(Pw, N_LEAVES, E, 1, L=L, nr_scale=0.0, seed=5)
            c.base["next_rec"].fill_(1.0 if active else 2 * L)
            u = c.uniforms(T)
            plain = _time(lambda st: c.run_segment(segment_pass, u, st),
                          c.fresh_segment, filler)
            row = [f"plain {plain:.2f}"]
            for ring, density in (("empty", 0.0), ("30%", 0.3),
                                  ("full", 1.0)):
                _ring(c, density)
                t = _time(lambda st: c.run_biased(segment_pass, u, st),
                          c.fresh_biased, filler)
                row.append(f"biased ring {ring} {t:.2f}")
            print(f"work P={Pw}: {label}: " + ", ".join(row)
                  + " us per launch", flush=True)


def _segment_case(L):
    c, u = cs._timing_case(P, N_LEAVES, E, L)
    c.fresh_biased()
    return c, u


def occupancy(filler, mean_len):
    src = SOURCE.read_text()
    if not DECL.search(src):
        raise SystemExit("bias_probe: the segment pass's declaration moved")
    variants = [("natural", "__launch_bounds__(BLOCK)")] + [
        (f"{k} blocks", f"__launch_bounds__(BLOCK, {k})") for k in (4, 5, 6)]
    for rnd, order in enumerate((variants, variants[::-1])):
        for label, bounds in order:
            text = DECL.sub(
                f"__global__ void {bounds} segment_pass_biased_kernel(", src)
            info = _use_source(text, "probe_occ_" + label.split()[0])
            if info.built:
                print(f"occupancy {label}: ptxas {_ptxas_of_biased(info)}",
                      flush=True)
            res = kernel_resources("biased", N_LEAVES, E)
            times = []
            for L in (mean_len, cs.MAX_SEG):
                c, u = _segment_case(L)
                times.append(_time(
                    lambda st, c=c, u=u: c.run_biased(segment_pass, u, st),
                    c.fresh_biased, filler))
            print(f"occupancy round {rnd} {label}: registers "
                  f"{res['registers']}, local {res['local_bytes']} B, "
                  f"{res['blocks_per_sm']} blocks ({res['particles_per_sm']} "
                  f"particles) per SM, {res['waves_at_10000']} waves: mean "
                  f"segment {times[0]:.2f} us, 50 kb {times[1]:.2f} us",
                  flush=True)
    _restore()


# the phases: (anchor line in the source, text put before it).  P_ holds
# cycle sums: 0 entry, 1 point, 2 hazard and records, 3 SPR and summaries,
# 4 push, 5 drain, 6 write-back, 7 trips, 8 particles, 9 pushes
PHASES = ("entry", "point", "hazard and records", "SPR and summaries",
          "push", "drain", "write-back")
KERNEL_PROBES = (
    ("  // the tables, the gate and the particle's rows are all under way",
     "  long long c0_ = clock64(), c1_ = 0;"),
    ("  bool moved = false;", "  __syncwarp(gm); P_[0] += clock64() - c0_;"
     " P_[8] += 1;"),
    ("      // the posterior takes the whole importance weight;",
     "      c1_ = clock64(); P_[7] += 1;"),
    ("    u = u_next;", "    if (BIAS) { __syncwarp(gm); P_[4] += clock64()"
     " - c1_; }"),
    ("    // ---- the pilot's extension; the delayed factors due",
     "    c1_ = clock64();"),
    ("  // ---- push the segment's statistics into FIFO slot 0",
     "  if (BIAS) { __syncwarp(gm); P_[5] += clock64() - c1_; }"
     " c1_ = clock64();"),
    ("  if (lane == 0) {\n    a.next_rec[i] = nr;",
     "  __syncwarp(gm); P_[6] += clock64() - c1_;\n"
     "  if (lane == 0 && BIAS) for (int q = 0; q < 10; ++q) "
     "atomicAdd(&g_prof[q], (unsigned long long)P_[q]);"),
)
TRIP_PROBES = (
    ("  // ---- extension: no-mutation likelihood", "  long long t0_ = 0;"),
    ("    // ---- height-biased point: over the segments",
     "    t0_ = clock64();"),
    ("  // ---- SMC' hazard inversion",
     "  if (BIAS) { __syncwarp(gm); P_[1] += clock64() - t0_; }"
     " long long t1_ = clock64();"),
    ("  // ---- SPR: cut the branch above c, regraft onto d at t_c",
     "  __syncwarp(gm); P_[2] += clock64() - t1_; t1_ = clock64();"),
    ("  return TripEvent{", "  __syncwarp(gm); P_[3] += clock64() - t1_;"),
)


def _insert(lines, start, stop, probes):
    """Put each probe's text before the first line at or after ``start``
    (and before ``stop``) that begins its anchor."""
    put = {}
    for anchor, text in probes:
        first = anchor.split("\n")
        j = next((j for j in range(start, stop - len(first) + 1)
                  if all(lines[j + q].startswith(first[q])
                         for q in range(len(first)))), None)
        if j is None:
            raise SystemExit(f"bias_probe: anchor not found: {first[0]!r}")
        put.setdefault(j, []).append(text)
    out = []
    for j, ln in enumerate(lines):
        out += put.get(j, [])
        out.append(ln)
    return out


def _instrumented(src: str) -> str:
    lines = src.split("\n")
    trip_at = next(j for j, ln in enumerate(lines)
                   if "TripEvent one_trip(" in ln)
    trip_end = next(j for j in range(trip_at, len(lines))
                    if lines[j].startswith("}"))
    lines = _insert(lines, trip_at, trip_end, TRIP_PROBES)
    seg_at = next(j for j, ln in enumerate(lines)
                  if "segment_pass_body(const Args& a)" in ln)
    seg_end = next(j for j in range(seg_at, len(lines))
                   if lines[j].startswith("}"))
    lines = _insert(lines, seg_at, seg_end, KERNEL_PROBES)
    text = "\n".join(lines)
    # one_trip takes the kernel's counters; trip_kernel passes its own
    text = re.sub(r"(TripEvent one_trip\([^{]*?)\) \{",
                  r"\1, long long* P_) {", text, count=1)
    text = re.sub(r"(one_trip<NP, (?:false|BIAS)(?:, VB)?>\([^;]*?)\);",
                  r"\1, P_);", text)
    text = text.replace(
        "  extern __shared__ float smem[];",
        "  extern __shared__ float smem[];\n  long long P_[10] = {0};")
    text = text.replace("namespace {\n", "__device__ unsigned long long "
                        "g_prof[16];\nnamespace {\n", 1)
    return text + """
extern "C" int smc_prof_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  if (e != cudaSuccess) return (int)e;
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
"""


def phases(mean_len):
    info = _use_source(_instrumented(SOURCE.read_text()), "probe_phases")
    print(f"phases: ptxas {_ptxas_of_biased(info)}", flush=True)
    lib = _build.load_trip_library()
    lib.smc_prof_read.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * 16)()
    for label, L in (("mean segment", mean_len), ("50 kb", cs.MAX_SEG)):
        c, u = _segment_case(L)
        lib.smc_prof_read(buf)
        c.run_biased(segment_pass, u, c.fresh_biased())
        torch.cuda.synchronize()
        lib.smc_prof_read(buf)
        v = list(buf)
        parts = dict(zip(PHASES, v[:7]))
        total = max(sum(parts.values()), 1)
        tr, pa = max(v[7], 1), max(v[8], 1)
        print(f"phases {label}: {v[8]} particles, {v[7]} trips; cycles per "
              "particle: " + ", ".join(
                  f"{k} {x / pa:.0f} ({x / total:.3f})"
                  for k, x in parts.items())
              + "; cycles per trip: " + ", ".join(
                  f"{k} {parts[k] / tr:.0f}" for k in PHASES[1:5]),
              flush=True)
    _restore()


def main(argv):
    what = argv or ["resources", "census", "work", "phases", "occupancy"]
    if not torch.cuda.is_available():
        print("bias_probe: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    demo, seg, chunks, mean_len = _genome()
    print(f"genome data: chunks {chunks}, mean segment {mean_len:.2f} bp",
          flush=True)
    filler = cs._filler()
    if "resources" in what:
        resources()
    if "census" in what:
        census(demo, seg, chunks)
    if "work" in what:
        work(filler)
    if "phases" in what:
        phases(mean_len)
    if "occupancy" in what:
        occupancy(filler, mean_len)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
