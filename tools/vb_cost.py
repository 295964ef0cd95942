"""What VB costs the segment passes, against a parent checkout.

    python3 tools/vb_cost.py DIR [DIR ...]

For each checkout DIR, in a fresh process started there, times the three
segment passes of that checkout's ``csrc/trip.cu`` on the card at the
shapes of ``chip_smoke.py``'s paths: the plain pass at the main path's
shape (P=10,000, n=4, E=9) on bench.py's mean segment, the biased pass at
the genome path's (P=10,000, n=8, E=33, two sections) on the genome data's
mean segment, and the migration pass at the twopop path's (P=10,000, n=4,
E=8, Pp=2, Mw=56) on the twopop data's mean segment.  Each time is the
device time per launch, best of 3 x 20 launches on fresh states queued
behind a matrix product (``chip_smoke._best_device_ms``).  Where the
checkout has VB (``chip_smoke.vb_tables``), each pass is timed with VB too,
with tables from small counts.  Prints the card's name and power limit first, then one JSON line per DIR
in the order given; give a parent checkout (``git archive`` under
``build/``) first and last, so that the times of two commits are compared
within one call: parent, change, change, parent."""

from __future__ import annotations

import json
import os
import subprocess
import sys

RUN = """
import json, os, sys
sys.path.insert(0, os.getcwd())
import numpy as np
import chip_smoke as cs
from smcsmc_tpu_torch.kernels import _build
import torch
from smcsmc_tpu_torch.kernels.trip import segment_pass
from smcsmc_tpu_torch.kernels.tree import Trees, tree_summaries
from smcsmc_tpu_torch.segio import (define_chunks, slice_seg,
                                    split_long_segments, write_seg)
from smcsmc_tpu_torch.sweep_profile import (bench_data, genome_data,
                                            genome_model, twopop_data)

def mean_len(seg):
    return float(split_long_segments(seg, cs.MAX_SEG).lengths.mean())

import tempfile
with tempfile.TemporaryDirectory() as tmp:
    paths = [os.path.join(tmp, k) for k in ("a.seg", "b.seg")]
    for path, chrom in zip(paths, genome_data()):
        write_seg(path, chrom)
    _, gseg = genome_model(paths)
g_len = float(np.concatenate([
    split_long_segments(slice_seg(gseg, c.start, c.end), cs.MAX_SEG).lengths
    for c in define_chunks(gseg, 4)]).mean())
has_vb = hasattr(cs, "vb_tables")
filler = cs._filler()
out = {"dir": os.getcwd(), "build_flags": " ".join(_build.NVCC_FLAGS)}

def timed(name, fresh, run, tables):
    out[name] = cs._best_device_ms(lambda st: run(segment_pass, st),
                                   fresh, filler)
    if has_vb:
        out[name + "_vb"] = cs._best_device_ms(
            lambda st: run(segment_pass, st, tables), fresh, filler)

c, u = cs._timing_case(10000, 4, 9, mean_len(bench_data()[1]))
timed("plain", c.fresh_segment,
      lambda fn, st, vb=None: c.run_segment(fn, u, st, **(
          {"vb": vb} if vb is not None else {})),
      cs.vb_tables(c.demo, 5) if has_vb else None)
g, gu = cs._timing_case(10000, 8, 33, g_len)
timed("biased", g.fresh_biased,
      lambda fn, st, vb=None: g.run_biased(fn, gu, st, **(
          {"vb": vb} if vb is not None else {})),
      cs.vb_tables(g.demo, 5) if has_vb else None)
m = cs.MigCase(10000, 1, mean_len(twopop_data()[1]), 0.0, seed=99)
b = m.base
tl, _, _ = tree_summaries(Trees(b["parent"], b["time"], b["child0"],
                                b["child1"]), m.epochs, 1, m.has_data)
expo = torch.empty(10000, device="cuda").exponential_(1.0, generator=m.gen)
b["next_rec"] = (expo / (cs.RHO * tl)).contiguous()
mu = m.uniforms(64)
timed("migration", m.fresh,
      lambda fn, st, vb=None: m.run(fn, mu, st, *(
          (vb,) if vb is not None else ())),
      cs.vb_tables(m.demo, 5) if has_vb else None)
out["segment_lengths"] = {"plain": c.L, "biased": g.L, "migration": m.L}
print("VB_COST " + json.dumps(out), flush=True)
"""


def main(argv):
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rows = []
    for d in argv or [here]:
        proc = subprocess.run([sys.executable, "-c", RUN],
                              cwd=os.path.abspath(d), capture_output=True,
                              text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, flush=True)
            return proc.returncode
        line = next(ln for ln in proc.stdout.splitlines()
                    if ln.startswith("VB_COST "))
        rows.append(json.loads(line[len("VB_COST "):]))
        print(line, flush=True)
    keys = list(dict.fromkeys(k for r in rows for k in r
                              if isinstance(r[k], float)))
    for k in keys:
        print(f"{k}: " + ", ".join(
            f"{r['dir'].rsplit('/', 1)[-1]} {r[k] * 1e3:.2f} us"
            for r in rows if k in r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
