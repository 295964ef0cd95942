"""``smc2-torch``: the ``smc2`` command line for the torch port (counterpart
of ``smcsmc_tpu.cli.smcsmc_main``).

It accepts the main-path subset of the ``smc2`` flags plus ``-device``;
every other flag is refused with a message naming it.  The demography is
built by the shared ``smcsmc_tpu.cli.build_demography``.
"""

from __future__ import annotations

import logging
import os
import sys

import numpy as np

from .device import resolve_device
from .em import EMConfig, run_em
from .shared import build_demography, load_option_file, read_seg

logger = logging.getLogger("smcsmc_tpu_torch")

_NOT_PORTED = ("is not yet in the torch port (ROADMAP queue 1, item 18: CLI "
               "and API surface); run it with smc2 (smcsmc_tpu)")


def parse_args(argv: list[str]):
    """Returns (EMConfig, io dict) for the supported flags:
    -seg -o -Np -EM -ESS -P -N0 -mu -rho -length -nsam -lag -seed -log
    -device."""
    argv = load_option_file(argv)
    cfg = EMConfig()
    io = {
        "segs": [], "out": "smcsmc_out", "pattern": None, "p_pattern": None,
        "tmax": 2.0, "startpos": 1, "length": None, "mu": None, "rho": None,
        "N0": None, "nsam": None, "logfile": None,
    }
    i = 0
    while i < len(argv):
        o = argv[i]

        def take(k=1):
            nonlocal i
            vals = argv[i + 1:i + 1 + k]
            if len(vals) < k:
                raise SystemExit(f"smc2-torch: option {o!r} needs {k} value(s)")
            i += 1 + k
            return vals if k > 1 else vals[0]

        if o in ("-seg", "-segs"):
            i += 1
            while i < len(argv) and not argv[i].startswith("-"):
                io["segs"].append(argv[i])
                i += 1
        elif o == "-o":
            io["out"] = take()
        elif o == "-Np":
            cfg.num_particles = int(take())
        elif o == "-EM":
            cfg.em_iters = int(take())
        elif o == "-ESS":
            cfg.ess_threshold = float(take())
        elif o == "-P":
            io["pattern"] = take(3)
        elif o == "-N0":
            io["N0"] = float(take())
        elif o == "-mu":
            io["mu"] = float(take())
        elif o == "-rho":
            io["rho"] = float(take())
        elif o == "-length":
            io["length"] = float(take())
        elif o == "-nsam":
            io["nsam"] = int(take())
        elif o == "-lag":
            cfg.lag = float(take())
        elif o == "-seed":
            cfg.seed = int(take())
        elif o == "-log":
            if i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                io["logfile"] = take()
            else:
                i += 1
        elif o == "-device":
            cfg.device = take()
        else:
            raise SystemExit(f"smc2-torch: option {o!r} {_NOT_PORTED}")
    if len(io["segs"]) > 1:
        raise SystemExit(f"smc2-torch: more than one -seg file {_NOT_PORTED}")
    return cfg, io


def smcsmc_main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    cfg, io = parse_args(argv)
    resolve_device(cfg.device)  # fail before reading any data
    if not io["segs"]:
        raise SystemExit("smc2-torch: no -seg input given")

    os.makedirs(io["out"], exist_ok=True)
    logfile = io["logfile"] or os.path.join(io["out"], "result.log")
    logging.basicConfig(filename=logfile, level=logging.INFO)
    logger.info("smc2-torch %s", " ".join(argv))

    seg = read_seg(io["segs"][0])
    if np.any(seg.alleles == 2):
        raise SystemExit(f"smc2-torch: unphased alleles (code 2) {_NOT_PORTED}")
    demo = build_demography(cfg, [], io, seg=seg)
    if demo.num_populations != 1 or np.any(demo.mig_rates > 0):
        raise SystemExit(f"smc2-torch: structured populations / migration "
                         f"{_NOT_PORTED}")
    cfg.outdir = io["out"]
    if io["length"] is not None:
        cfg.length = float(io["length"])
    result = run_em(demo, seg, cfg)
    logger.info("final log-likelihoods: %s", result.log_likelihoods)
    print(f"Results written to {io['out']}/result.out")
    return 0


if __name__ == "__main__":
    sys.exit(smcsmc_main())
