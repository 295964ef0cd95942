"""``smc2-torch``: the ``smc2`` command line for the torch port (counterpart
of ``smcsmc_tpu.cli.smcsmc_main``).

It accepts the ``smc2`` flags of the ported paths (one population, or
structured populations with migration through ``-I -eN -en -em -eM -ema
-ej -migbuf``; several ``.seg`` files, chunks, resume and checkpoints;
unphased and missing data; the M-step's options and ``-vb``; height-biased
proposals with delayed importance weights and calibrated lags; the
auxiliary particle filter ``-apf``; the recombination guide ``-guide`` and
the guide loop ``-alpha``; ARG recording ``-arg``) plus ``-device``, each
parsed as ``smcsmc_tpu.cli`` parses it; every other flag is refused with
a message naming it.  The helpers that turn
flags into a ``Demography`` (``load_option_file``, ``_split_timed_opts``,
``_is_number``, ``resolve_n0``, ``build_demography``) are copied from
``smcsmc_tpu/cli.py`` at commit dfc2fad and kept letter for letter.
"""

from __future__ import annotations

import logging
import os
import sys

from .device import resolve_device
from .em import EMConfig, refuse_caps, run_em
from .segio import merge_segs, read_seg

logger = logging.getLogger("smcsmc_tpu_torch")

_NOT_PORTED = ("is not yet in the torch port (ROADMAP queue 1, item 18: CLI "
               "and API surface); run it with smc2 (smcsmc_tpu)")


# ---------------------------------------------------------------------------
# copied from smcsmc_tpu/cli.py (:20-36, :318-347, :350-371, :374-447)
# ---------------------------------------------------------------------------


def load_option_file(argv: list[str]) -> list[str]:
    """-@ file indirection (model.py:331-342): tokens from the file are
    spliced in at the option's position."""
    out = []
    i = 0
    while i < len(argv):
        if argv[i] == "-@":
            with open(argv[i + 1]) as fh:
                for line in fh:
                    line = line.split("#")[0].strip()
                    if line:
                        out += line.split()
            i += 2
        else:
            out.append(argv[i])
            i += 1
    return out


TIMED_FLAGS = ("-eI", "-ej", "-eM", "-ema", "-em", "-eN", "-en")


def _split_timed_opts(args: list[str]):
    """Partition flat scrm args into timed options [(time, [flag, t, ...])]
    and the remainder (reference set_pattern, model.py:483-491)."""
    timed, remain = [], []
    i = 0
    while i < len(args):
        o = args[i]
        grp = [o]
        i += 1
        while i < len(args) and not (
            args[i].startswith("-") and not _is_number(args[i])
        ):
            grp.append(args[i])
            i += 1
        if o in TIMED_FLAGS:
            timed.append((float(grp[1]), grp))
        else:
            remain += grp
    return timed, remain


def _is_number(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def resolve_n0(io, seg=None):
    """Default N0 = Watterson θ̂ / (4 μ) when -N0 is absent
    (reference model.py:705-711; θ̂ from model.py:567-621)."""
    if io["N0"] is not None:
        return io["N0"]
    if io["mu"] is not None and seg is not None:
        from .segio import watterson_estimate

        theta_w = watterson_estimate(
            seg, startpos=io.get("startpos"), length=io.get("length")
        )
        if theta_w > 0:
            n0 = theta_w / (4.0 * io["mu"])
            logger.info(
                "Setting N0 from mutation rate and Watterson's estimate "
                "of theta (%.4g): N0 = %.1f", theta_w, n0,
            )
            io["N0"] = n0
            return n0
    raise SystemExit(
        "smc2: N0 required -- use -N0, or (implicitly) -mu with seg data"
    )


def build_demography(cfg, demo_args, io, seg=None):
    """Assemble the Demography from flags (+ -P pattern rewriting of ALL
    timed options onto the log-spaced epoch grid, model.py:470-536;
    Watterson default N0, model.py:705-711)."""
    from .demography import parse_scrm_args
    from .pattern import smc2_pattern_times

    n0 = resolve_n0(io, seg)
    args = list(demo_args)
    # translate -mu/-rho/-length into -t / -r
    L = io["length"]
    if L is None and seg is not None:
        L = float(seg.end)
    if L is None:
        L = 2e7
    if io["mu"] is not None and "-t" not in args:
        args += ["-t", str(4 * n0 * io["mu"] * L)]
    if io["rho"] is not None and "-r" not in args:
        args += ["-r", str(4 * n0 * io["rho"] * L), str(L)]
    if io["nsam"] is not None and "-nsam" not in args:
        args += ["-nsam", str(io["nsam"])]
    elif seg is not None and "-nsam" not in args and "-I" not in args:
        args += ["-nsam", str(seg.num_samples)]

    if io["pattern"] is None and io.get("p_pattern"):
        # binary-style -p/-tmax epoch grid (pfparam.cpp:290-296): pattern
        # times are in 4N0 units already (pattern.cpp:139-149)
        from .pattern import epoch_times_from_pattern

        times_4n0 = epoch_times_from_pattern(io["p_pattern"], io["tmax"])
        for t in times_4n0:
            if t > 0:
                args += ["-eN", str(t), "1.0"]
        logger.info(
            "Epoch grid from -p %s -tmax %g: %s",
            io["p_pattern"], io["tmax"],
            " ".join(f"{t:.4g}" for t in times_4n0),
        )

    if io["pattern"] is not None:
        # -P start end pattern (model.py:470-536 set_pattern): generate the
        # log-spaced epoch grid, re-emit user -eN sizes carried forward onto
        # grid times, and snap every other timed option's time to the
        # largest grid time <= its own.  User -eN rows are consumed; -en
        # rows are left as-is (reference note: best not combined with -P).
        start, end, patt = io["pattern"]
        times = smc2_pattern_times(float(start), float(end), patt, n0=n0)
        timed, remain = _split_timed_opts(args)
        new_timed = []
        for t in times:
            # last user -eN with time <= t sets the size (default 1.0)
            size = "1.0"
            best = -1.0
            for ut, grp in timed:
                if grp[0] == "-eN" and ut <= t and ut >= best:
                    best, size = ut, grp[2]
            new_timed.append((t, ["-eN", str(t), size]))
        for ut, grp in timed:
            if grp[0] == "-eN":
                continue
            below = [t for t in times if t <= ut]
            newtime = below[-1] if below else times[0]
            new_timed.append((newtime, [grp[0], str(newtime)] + grp[2:]))
        new_timed.sort(key=lambda x: x[0])
        args = remain + [tok for _, grp in new_timed for tok in grp]
        logger.info(
            "Population structure options after -P: %s",
            " ".join(" ".join(grp) for _, grp in new_timed),
        )

    demo = parse_scrm_args(args, n0=n0)
    if L is not None:
        demo.sequence_length = L
    return demo


# ---------------------------------------------------------------------------
# the port's own parser and entry point
# ---------------------------------------------------------------------------


# the ms/scrm demography flags the port takes (-eI, sample times, is not)
DEMOGRAPHY_FLAGS = ("-I", "-ej", "-eM", "-ema", "-em", "-eN", "-en")


def parse_args(argv: list[str]):
    """Returns (EMConfig, io dict) for the supported flags:
    -seg/-segs -o -Np -EM -ESS -P -N0 -mu -rho -length -nsam -lag -seed -log
    -chunks -maxgap -minseg -startpos -ckpt -nothreads -dephase
    -ancestral_aware -cap -xc -xr -no_infer_recomb -no_m_step -record_ess
    -bias_heights -bias_strengths -delay -lag_fraction -calibrate_lag
    -delay_coal -delay_migr -vb -apf -alpha -guide -arg -device, the demography
    flags -I -eN -en -em -eM -ema -ej (kept with their values in
    ``io["demo_args"]``) and -migbuf."""
    argv = load_option_file(argv)
    cfg = EMConfig()
    io = {
        "segs": [], "out": "smcsmc_out", "pattern": None, "p_pattern": None,
        "tmax": 2.0, "maxgap": 200000, "minseg": 500000, "startpos": 1,
        "length": None, "mu": None, "rho": None, "N0": None, "nsam": None,
        "logfile": None, "bias_heights": None, "demo_args": [], "alpha": 0.0,
        "arg": False,
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
        elif o == "-calibrate_lag":
            cfg.calibrate_lag = True
            cfg.lag_fraction = float(take())
        elif o == "-lag_fraction":
            cfg.lag_fraction = float(take())
        elif o == "-delay":
            cfg.delay = float(take())
        elif o == "-delay_coal":
            # delay keyed off the first coalescence height (pfparam.cpp:140)
            cfg.delay_type = "coal"
            i += 1
        elif o == "-delay_migr":
            # delay keyed off the first coal-or-migration event
            # (pfparam.cpp:141-142 RESAMPLE_DELAY_COALMIGR)
            cfg.delay_type = "migr"
            i += 1
        elif o in ("-bias_heights", "-bias_strengths"):
            # heights in units of 4*N0 generations, the first typically 0
            # (converted once N0 is known); one strength per section
            i += 1
            vals = []
            while i < len(argv) and not argv[i].startswith("-"):
                vals.append(float(argv[i]))
                i += 1
            if o == "-bias_heights":
                io["bias_heights"] = vals
            else:
                cfg.bias_strengths = tuple(vals)
        elif o == "-seed":
            cfg.seed = int(take())
        elif o == "-cap":
            cfg.use_cap = True
            cfg.ne_cap = float(take())
        elif o == "-ancestral_aware":
            cfg.ancestral_aware = True
            i += 1
        elif o == "-dephase":
            cfg.dephase = True
            i += 1
        elif o in ("-xr", "-xc"):
            # epoch or 0-based closed epoch range, e.g. "0-10"
            # (pfparam.cpp:82-99 readRange + record_event_in_epoch masks)
            spec = take()
            lo, _, hi = spec.partition("-")
            epochs_rng = tuple(range(int(lo), int(hi or lo) + 1))
            if o == "-xr":
                cfg.xr_epochs = tuple(cfg.xr_epochs) + epochs_rng
            else:
                cfg.xc_epochs = tuple(cfg.xc_epochs) + epochs_rng
        elif o == "-apf":
            # auxiliary particle filter level 0-4 (pfparam.cpp:147-151)
            cfg.apf = int(take())
        elif o == "-vb":
            cfg.vb = True
            i += 1
        elif o == "-no_infer_recomb":
            # keep the recombination rate fixed across M-steps
            # (model.py:403-405)
            cfg.infer_recomb = False
            i += 1
        elif o == "-no_m_step":
            # run E-steps only; parameters stay at their initial values
            # (model.py:406-408, 1020-1022)
            cfg.do_m_step = False
            i += 1
        elif o == "-chunks":
            cfg.chunks = int(take())
        elif o == "-ckpt":
            # mid-sweep checkpoint interval in blocks of em.CHECK_EVERY
            # segments (0 = off)
            cfg.checkpoint_blocks = int(take())
        elif o == "-nothreads":
            # serialize chunk sweeps (model.py:1094-1100)
            cfg.chunk_workers = 1
            i += 1
        elif o == "-maxgap":
            io["maxgap"] = int(float(take()))
        elif o == "-minseg":
            io["minseg"] = int(float(take()))
        elif o == "-startpos":
            io["startpos"] = int(float(take()))
        elif o == "-record_ess":
            cfg.record_ess = True
            i += 1
        elif o == "-log":
            if i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                io["logfile"] = take()
            else:
                i += 1
        elif o == "-device":
            cfg.device = take()
        elif o == "-migbuf":
            # per-branch migration-event buffer capacity (0 = auto-sized
            # from the demography)
            cfg.mig_buffer = int(take())
        elif o == "-alpha":
            # fraction of posterior recombination mixed into the guide
            # (model.py:246-249); > 0 activates the record->smooth->guide
            # loop, < 0 disables recording
            io["alpha"] = float(take())
            cfg.alpha = io["alpha"]
        elif o == "-guide":
            # explicit recombination guide file (model.py:1060-1061)
            cfg.guide_file = take()
        elif o == "-arg":
            # write each chunk's sampled ARG as .trees.gz
            io["arg"] = True
            cfg.record_arg = True
            i += 1
        elif o in DEMOGRAPHY_FLAGS:
            # demography flags pass through with their arguments
            io["demo_args"].append(o)
            i += 1
            while i < len(argv) and not argv[i].startswith("-"):
                io["demo_args"].append(argv[i])
                i += 1
        else:
            raise SystemExit(f"smc2-torch: option {o!r} {_NOT_PORTED}")
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
    if cfg.calibrate_lag:
        logger.info("Calibrated lag = %s x survival", cfg.lag_fraction)

    if len(io["segs"]) > 1:
        seg, _ = merge_segs(io["segs"], gap=io["maxgap"])
    else:
        seg = read_seg(io["segs"][0])
    demo = build_demography(cfg, io["demo_args"], io, seg=seg)
    if io["bias_heights"]:
        # 4N0 units -> generations; a leading 0 is dropped
        cfg.bias_heights = tuple(h * 4 * io["N0"] for h in io["bias_heights"]
                                 if h > 0)
    try:
        refuse_caps(demo, cfg)
    except NotImplementedError as err:
        raise SystemExit(f"smc2-torch: {err}") from None
    cfg.outdir = io["out"]
    # chunk-window controls (model.py:563-662; pfparam.cpp -startpos)
    cfg.maxgap = io["maxgap"]
    cfg.minseg = io["minseg"]
    if io["startpos"] > 1:
        cfg.startpos = float(io["startpos"])
    if io["length"] is not None:
        cfg.length = float(io["length"])
    result = run_em(demo, seg, cfg)
    logger.info("final log-likelihoods: %s", result.log_likelihoods)
    print(f"Results written to {io['out']}/result.out")
    return 0


if __name__ == "__main__":
    sys.exit(smcsmc_main())
