"""The biased path's LogL by iteration, in full, for one or more checkouts.

    python3 tools/biased_logl.py [DIR ...]

For each checkout DIR (default: this one), in a fresh process started
there, runs ``chip_smoke.py``'s biased path command (the genome data,
``-Np 10000 -EM 1 -seed 7 -bias_heights 0 0.05 -calibrate_lag 2``, on the
card) through that checkout's ``smcsmc_main`` and prints its LogL by
iteration in full and its kernel launches, so that two commits can be held
to one LogL in one call (for example the parent's ``git archive`` beside
this one).  It uses only what ``chip_smoke.py`` has had since the biased
path came in: ``_genome_argv``, ``BIASED_FLAGS`` and ``_run_cli``.  Prints
the card's name and power limit first."""

from __future__ import annotations

import os
import subprocess
import sys

RUN = """
import os, sys, tempfile
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
from smcsmc_tpu_torch.segio import write_seg
from smcsmc_tpu_torch.sweep_profile import genome_data
with tempfile.TemporaryDirectory() as tmp:
    paths = [os.path.join(tmp, k) for k in ("a.seg", "b.seg")]
    for path, chrom in zip(paths, genome_data()):
        write_seg(path, chrom)
    argv = cs._genome_argv(paths, os.path.join(tmp, "out"))
    i = argv.index("-ckpt")
    argv = argv[:i] + argv[i + 2:] + cs.BIASED_FLAGS
    launches, plain, steps, _, wall = cs._run_cli(argv)
print(f"biased path of {os.getcwd()}: LogL by iteration "
      f"{[r.args[4] for r in steps]!r}; launches {launches}; plain "
      f"versions {plain}; {wall:.2f} s wall", flush=True)
"""


def main(argv):
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for d in argv or [here]:
        rc = subprocess.run([sys.executable, "-c", RUN],
                            cwd=os.path.abspath(d)).returncode
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
